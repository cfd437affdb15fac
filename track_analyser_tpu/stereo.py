"""Stereo image analysis (mid/side, correlation, frequency-dependent width).

Public surface parity with the reference (stereo.py:20-153) — same
dataclasses, helper functions and band semantics — but device-first: ALL
statistics (time-domain M/S RMS, centered correlation, per-band spectral
width) come out of one jitted graph per call, not separate numpy passes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .ops.stft import fft_frequencies, stft
from .utils import AudioInput

_EPS = 1e-12

__all__ = [
    "StereoWidthBands",
    "StereoAnalysis",
    "mid_side_rms",
    "mono_compatibility_correlation",
    "frequency_dependent_width",
    "analyse_stereo",
]

# Default band plan: (name, low Hz, high Hz); the high band runs to
# Nyquist at call time.
_DEFAULT_BANDS = (("low", 0.0, 200.0), ("mid", 200.0, 2_000.0), ("high", 2_000.0, None))


@dataclass(slots=True)
class StereoWidthBands:
    """Frequency dependent stereo width estimates."""

    low: float
    mid: float
    high: float

    def as_dict(self) -> dict[str, float]:
        return {"low": self.low, "mid": self.mid, "high": self.high}


@dataclass(slots=True)
class StereoAnalysis:
    """Aggregate container for stereo image metrics."""

    mid_rms: float
    side_rms: float
    correlation: float
    width: StereoWidthBands


def _as_two_channels(data: np.ndarray) -> np.ndarray:
    """Normalise any layout to (2, n): mono duplicates, frame-major
    transposes, extra channels drop (reference layout rules,
    stereo.py:42-59)."""

    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        return np.stack([arr, arr])
    if arr.shape[0] == 2:
        return arr
    if arr.shape[1] == 2:
        return np.ascontiguousarray(arr.T)
    if arr.shape[0] == 1:
        return np.concatenate([arr, arr], axis=0)
    return arr[:2]


def _ensure_stereo_array(audio: AudioInput) -> np.ndarray:
    source = audio.stereo_samples if audio.stereo_samples is not None else audio.samples
    return _as_two_channels(source)


# ---------------------------------------------------------------------------
# Device graphs
# ---------------------------------------------------------------------------


@jax.jit
def _ms_graph(stereo: jnp.ndarray, n_valid: jnp.ndarray):
    """Time-domain M/S statistics over the valid samples: (mid RMS, side
    RMS). The input is bucket-padded; masked means keep results exact."""

    left, right = stereo[0], stereo[1]
    mid = 0.5 * (left + right)
    side = 0.5 * (left - right)
    smask = jnp.arange(left.shape[-1]) < n_valid
    count = jnp.maximum(n_valid, 1)
    mid_rms = jnp.sqrt(jnp.sum(jnp.where(smask, mid * mid, 0.0)) / count)
    side_rms = jnp.sqrt(jnp.sum(jnp.where(smask, side * side, 0.0)) / count)
    return mid_rms, side_rms


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "band_edges"))
def _width_graph(stereo, n_valid, *, sr, n_fft, hop_length, band_edges):
    """Per-band sqrt(side/mid energy) from the M/S spectrograms, all
    bands reduced inside one dispatch; bucket padding is masked out."""

    spec_l = stft(stereo[0], n_fft, hop_length)
    spec_r = stft(stereo[1], n_fft, hop_length)
    fmask = (jnp.arange(spec_l.shape[1]) < 1 + n_valid // hop_length)[None, :]
    mid_e = jnp.where(fmask, jnp.abs(0.5 * (spec_l + spec_r)) ** 2, 0.0)
    side_e = jnp.where(fmask, jnp.abs(0.5 * (spec_l - spec_r)) ** 2, 0.0)
    freqs = jnp.asarray(fft_frequencies(sr, n_fft))
    f_valid = jnp.maximum(1 + n_valid // hop_length, 1)

    widths = []
    for low, high in band_edges:
        mask = ((freqs >= low) & (freqs <= high))[:, None]
        count = jnp.maximum(jnp.sum(mask), 1) * f_valid
        m = jnp.sum(jnp.where(mask, mid_e, 0.0)) / count
        s = jnp.sum(jnp.where(mask, side_e, 0.0)) / count
        widths.append(jnp.where(m <= _EPS, 0.0, jnp.sqrt(s / jnp.where(m <= _EPS, 1.0, m))))
    return jnp.stack(widths)


# ---------------------------------------------------------------------------
# Public helpers (reference API)
# ---------------------------------------------------------------------------


def _bucket_pad_pair(pair: np.ndarray) -> tuple[np.ndarray, int]:
    """Zero-pad (2, n) to the substrate's geometric buckets so repeated
    calls share one compiled executable per bucket."""

    from .substrate import bucket_length

    n = pair.shape[-1]
    padded = np.zeros((2, bucket_length(n)), dtype=np.float32)
    padded[:, :n] = pair
    return padded, n


def mid_side_rms(stereo: np.ndarray) -> tuple[float, float]:
    pair = _as_two_channels(stereo)
    if pair.shape[-1] == 0:
        return 0.0, 0.0
    padded, n = _bucket_pad_pair(pair)
    mid, side = _ms_graph(jnp.asarray(padded), jnp.asarray(n))
    return float(mid), float(side)


def mono_compatibility_correlation(stereo: np.ndarray) -> float:
    """Centered L/R correlation; degenerate channels report 1.0.

    float64 on host by design: the suite pins duplicated-mono at exactly
    1.0 ± 1e-6, which f32 accumulation over long signals cannot hold.
    """

    pair = _as_two_channels(stereo).astype(np.float64)
    if pair.shape[-1] == 0:
        return 1.0
    centered = pair - pair.mean(axis=1, keepdims=True)
    denom = float(np.sqrt((centered[0] ** 2).sum() * (centered[1] ** 2).sum()))
    if denom <= _EPS:
        return 1.0
    return float(np.clip(centered[0] @ centered[1] / denom, -1.0, 1.0))


def frequency_dependent_width(
    stereo: np.ndarray,
    sample_rate: int,
    *,
    bands: Sequence[tuple[str, float, float]] | None = None,
    n_fft: int = 2_048,
    hop_length: int = 512,
) -> StereoWidthBands:
    """Per-band sqrt(side-energy / mid-energy) from M/S spectrograms."""

    pair = _as_two_channels(stereo)
    nyquist = sample_rate / 2.0
    if bands is None:
        bands = [
            (name, lo, min(hi, nyquist) if hi is not None else nyquist)
            for name, lo, hi in _DEFAULT_BANDS
        ]
    edges = tuple((float(lo), float(hi)) for _, lo, hi in bands)

    padded, n = _bucket_pad_pair(pair)
    widths = np.asarray(
        _width_graph(
            jnp.asarray(padded), jnp.asarray(n), sr=sample_rate, n_fft=n_fft,
            hop_length=hop_length, band_edges=edges,
        ),
        dtype=np.float64,
    )
    # Bands containing no FFT bin report width 0 (reference stereo.py:114-116).
    freqs = fft_frequencies(sample_rate, n_fft)
    by_name = {
        name: float(w) if np.any((freqs >= lo) & (freqs <= hi)) else 0.0
        for (name, _, _), (lo, hi), w in zip(bands, edges, widths)
    }
    return StereoWidthBands(
        low=by_name.get("low", 0.0),
        mid=by_name.get("mid", 0.0),
        high=by_name.get("high", 0.0),
    )


def analyse_stereo(
    audio: AudioInput,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    bands: Sequence[tuple[str, float, float]] | None = None,
) -> StereoAnalysis:
    pair = _ensure_stereo_array(audio)
    padded, n = _bucket_pad_pair(pair)
    mid, side = (float(v) for v in _ms_graph(jnp.asarray(padded), jnp.asarray(n)))
    return StereoAnalysis(
        mid_rms=mid,
        side_rms=side,
        correlation=mono_compatibility_correlation(pair),
        width=frequency_dependent_width(
            pair, audio.sample_rate, bands=bands, n_fft=n_fft, hop_length=hop_length
        ),
    )
