"""Spectral summary features (LTAS, centroid, roll-off).

Public surface parity with the reference (features.py:18-149); all three
features share one jitted magnitude spectrogram instead of the reference's
three separate librosa STFTs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .ops.spectral import spectral_centroid, spectral_rolloff
from .ops.stft import fft_frequencies, magnitude
from .utils import AudioInput

__all__ = [
    "LongTermAverageSpectrum",
    "FeatureSeries",
    "FeatureAnalysis",
    "compute_ltas",
    "spectral_centroid_series",
    "spectral_rolloff_series",
    "analyse_features",
]


@dataclass(slots=True)
class LongTermAverageSpectrum:
    """Long-term average spectrum (LTAS) of a signal."""

    frequencies: np.ndarray
    magnitude: np.ndarray

    def as_dict(self) -> dict[str, Sequence[float]]:
        return {
            "frequencies": self.frequencies.tolist(),
            "magnitude": self.magnitude.tolist(),
        }


@dataclass(slots=True)
class FeatureSeries:
    """Container for frame-wise spectral features."""

    values: np.ndarray

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values.size else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self.values)) if self.values.size else 0.0

    @property
    def as_list(self) -> list[float]:
        return self.values.tolist()


@dataclass(slots=True)
class FeatureAnalysis:
    """Aggregates the spectral feature outputs."""

    ltas: LongTermAverageSpectrum
    spectral_centroid: FeatureSeries
    spectral_rolloff: FeatureSeries


def _to_mono(samples: np.ndarray) -> np.ndarray:
    mono = np.asarray(samples, dtype=np.float32)
    if mono.ndim > 1:
        mono = np.mean(mono, axis=0)
    return mono


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "roll_percent"))
def _features_graph(y, n_valid, *, sr, n_fft, hop_length, roll_percent):
    """Bucket-padded features: the LTAS mean is masked to the valid
    frames; centroid/rolloff are per-frame and trimmed on host."""

    mag = magnitude(y, n_fft, hop_length, power=1.0)
    freqs = fft_frequencies(sr, n_fft)
    fmask = jnp.arange(mag.shape[1]) < 1 + n_valid // hop_length
    ltas_masked = jnp.sum(jnp.where(fmask[None, :], mag, 0.0), axis=1) / jnp.maximum(
        jnp.sum(fmask), 1
    )
    return (
        ltas_masked,
        spectral_centroid(mag, freqs),
        spectral_rolloff(mag, freqs, roll_percent),
    )


def _run(samples, sr: int, n_fft: int, hop_length: int, roll_percent: float = 0.85):
    """One device pass -> (ltas, centroid, rolloff) as float64 numpy.

    The signal bucket-pads to the substrate's geometric lengths so
    repeated calls share one executable per bucket instead of compiling
    per distinct shape; per-frame curves trim back exactly.
    """

    from .substrate import bucket_length

    mono = _to_mono(samples)
    n = mono.size
    padded = np.zeros(bucket_length(n, hop=hop_length), dtype=np.float32)
    padded[:n] = mono
    ltas_mag, centroid, rolloff = _features_graph(
        jnp.asarray(padded), jnp.asarray(n),
        sr=sr, n_fft=n_fft, hop_length=hop_length, roll_percent=float(roll_percent),
    )
    f_valid = 1 + n // hop_length
    return (
        np.asarray(ltas_mag, dtype=np.float64),
        np.asarray(centroid, dtype=np.float64)[:f_valid],
        np.asarray(rolloff, dtype=np.float64)[:f_valid],
    )


def compute_ltas(
    samples: np.ndarray,
    sample_rate: int,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    window: str = "hann",
) -> LongTermAverageSpectrum:
    """Compute the long-term average spectrum for ``samples``."""

    del window  # hann is the only window; kept for signature parity
    ltas_mag, _, _ = _run(samples, sample_rate, n_fft, hop_length)
    return LongTermAverageSpectrum(
        frequencies=fft_frequencies(sample_rate, n_fft), magnitude=ltas_mag
    )


def spectral_centroid_series(
    samples: np.ndarray,
    sample_rate: int,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
) -> FeatureSeries:
    """Return the spectral centroid trajectory for ``samples``."""

    return FeatureSeries(values=_run(samples, sample_rate, n_fft, hop_length)[1])


def spectral_rolloff_series(
    samples: np.ndarray,
    sample_rate: int,
    *,
    roll_percent: float = 0.85,
    n_fft: int = 2_048,
    hop_length: int = 512,
) -> FeatureSeries:
    """Return the spectral roll-off trajectory for ``samples``."""

    return FeatureSeries(
        values=_run(samples, sample_rate, n_fft, hop_length, roll_percent)[2]
    )


def analyse_features(
    audio: AudioInput,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    roll_percent: float = 0.85,
) -> FeatureAnalysis:
    """Derive spectral summary features for ``audio`` in one device pass."""

    ltas_mag, centroid, rolloff = _run(
        audio.samples, audio.sample_rate, n_fft, hop_length, roll_percent
    )
    return FeatureAnalysis(
        ltas=LongTermAverageSpectrum(
            frequencies=fft_frequencies(audio.sample_rate, n_fft), magnitude=ltas_mag
        ),
        spectral_centroid=FeatureSeries(values=centroid),
        spectral_rolloff=FeatureSeries(values=rolloff),
    )
