"""Downbeat tracking model.

Replaces the reference's optional madmom RNN+DBN path (analysis/beats.py:
124-141) with a self-contained, deterministic accent-based tracker:

1. A jitted accent feature graph: per-frame LINEAR mel energy, low-band
   (kick-range) energy and spectral flux. Accent strength must live in the
   linear domain — dB flux is nearly amplitude-blind (a 2x louder
   downbeat is +6 dB out of an ~80 dB silence-to-onset jump).
2. A meter/phase decoder over {3, 4} beats-per-bar: every (meter, phase)
   hypothesis is scored by the z-scored accent contrast between putative
   downbeats and the remaining beats — the constant-tempo-grid analogue
   of the DBN's bar-position states.

Source tag: "accent" (the reference reports "madmom" or "heuristic").
A learned activation network (models/downbeat_net.py) can replace step 1
via a checkpoint without changing the decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
from ..ops.stft import magnitude

__all__ = [
    "available",
    "track_downbeats",
    "decode_from_accent",
    "DownbeatTrackingResult",
]

_HOP = 512
_N_FFT = 2048


@dataclass(slots=True)
class DownbeatTrackingResult:
    downbeat_times: List[float]
    beat_positions: List[int]
    source: str


def available() -> bool:
    return True


_CKPT_DIR = Path(__file__).parent / "checkpoints"
# Preference order: the newest time-parallel TCN (v2 is trained AND
# gated on the hardened rhythm distribution — ±2%/min tempo drift,
# swung off-beat hats, pickup phases — scoring held-out F1 1.00 on
# every style×rhythm cell where accent-only scores 0.22-0.26 on
# backbeats), then the original GRU (per-module path only).
_DEFAULT_CKPTS = (
    _CKPT_DIR / "downbeat_tcn_v2.npz",
    _CKPT_DIR / "downbeat_tcn_v1.npz",
    _CKPT_DIR / "downbeat_v1.npz",
)
_DEFAULT_CKPT = _DEFAULT_CKPTS[-1]  # back-compat alias
_CKPT_ENV = "TRACK_ANALYSER_TPU_DOWNBEAT_CKPT"
_net_params_cache: dict = {}


def _net_params():
    """Trained activation-net weights: env override, then the bundled
    checkpoints (TCN preferred), else None (accent features only)."""

    import os

    path = os.environ.get(_CKPT_ENV) or next(
        (str(p) for p in _DEFAULT_CKPTS if p.exists()), None
    )
    if path is None:
        return None
    if path not in _net_params_cache:
        try:
            from . import downbeat_net

            _net_params_cache[path] = downbeat_net.load_checkpoint(path)
        except Exception:
            _net_params_cache[path] = None
    return _net_params_cache[path]


@partial(jax.jit, static_argnames=("sr",))
def _accent_graph(y: jnp.ndarray, *, sr: int):
    """Per-frame accent curves: linear mel energy, low-band energy, flux."""

    power = magnitude(y, _N_FFT, _HOP, power=2.0)
    fb = mel_filterbank(sr, _N_FFT, 128)
    mel_power = melspectrogram_from_power(power, fb)

    energy = jnp.sqrt(jnp.sum(mel_power, axis=0) + 1e-12)
    n_low = max(2, int(150.0 * _N_FFT / sr))
    low = jnp.sqrt(jnp.sum(power[:n_low], axis=0) + 1e-12)

    mel_db = power_to_db(mel_power)
    flux = jnp.mean(jnp.maximum(0.0, mel_db[:, 1:] - mel_db[:, :-1]), axis=0)
    flux = jnp.pad(flux, (1, 0))
    return energy, low, flux


def track_downbeats(
    samples: np.ndarray,
    sample_rate: int,
    beat_times: "np.ndarray | List[float]",
    *,
    seed: int = 0,
) -> "DownbeatTrackingResult | None":
    """Pick the downbeat phase/meter that maximises accent contrast."""

    del seed  # deterministic model — kept for interface parity
    beat_times = np.asarray(beat_times, dtype=float)
    if beat_times.size < 4:
        return None

    # Bucket-pad so repeated calls share one executable per bucket; the
    # accent curves are per-frame and trim back exactly (the dB floor in
    # the flux is relative to the global max, which quiet padding cannot
    # raise).
    from ..substrate import bucket_length

    y = np.asarray(samples, dtype=np.float32)
    n = y.size
    padded = np.zeros(bucket_length(n, hop=_HOP), dtype=np.float32)
    padded[:n] = y
    f_valid = 1 + n // _HOP
    energy_j, low_j, flux_j = (
        o[:f_valid] for o in _accent_graph(jnp.asarray(padded), sr=sample_rate)
    )
    net_prob = None
    params = _net_params()
    if params is not None:
        try:
            from . import downbeat_net

            net_prob = downbeat_net.downbeat_activation(params, samples, sample_rate)
        except Exception:
            net_prob = None
    chroma = None
    try:
        from ..harmony import _compute_chromas

        chroma, _ = _compute_chromas(y, sample_rate)
    except Exception:
        chroma = None  # harmonic cue is additive evidence, never a blocker
    return decode_from_accent(
        np.asarray(energy_j, dtype=np.float64),
        np.asarray(low_j, dtype=np.float64),
        beat_times,
        sample_rate,
        flux=np.asarray(flux_j, dtype=np.float64),
        net_prob=net_prob,
        chroma=chroma,
    )


def _viterbi_positions(accent: np.ndarray, meter: int) -> tuple[float, np.ndarray]:
    """Bar-position Viterbi for one meter (the DBN decode); returns
    (score, 1-based positions).

    States are positions 0..meter-1 (0 = downbeat). Emissions: position 0
    scores +accent, others -accent/(meter-1) (zero-sum so string length
    doesn't bias the meter comparison). Transitions advance one position
    per beat; staying or double-advancing (a missed/inserted beat) costs
    a fixed penalty, which lets the decoder re-lock after grid slips —
    something the global phase vote cannot do.

    Host numpy on purpose: the trellis is beats x meter (~400 x 4 for a
    3-minute track) — microseconds of arithmetic. A device dispatch costs
    a host-device round trip *and* a recompile for every distinct beat
    count, so the device path is worse for this op.
    """

    # Several beats' worth of evidence: a slip must be sustained, not a
    # one-beat accent outlier.
    slip_penalty = 10.0
    n = accent.size
    accent = np.asarray(accent, dtype=np.float64)
    emissions = np.full((n, meter), -1.0 / (meter - 1)) * accent[:, None]
    emissions[:, 0] = accent

    delta = emissions[0].copy()
    choices = np.empty((n - 1, meter), dtype=np.int8)
    for i in range(1, n):
        adv = np.roll(delta, 1)  # from position p-1
        stay = delta - slip_penalty
        skip = np.roll(delta, 2) - slip_penalty
        stacked = np.stack([adv, stay, skip])
        choices[i - 1] = np.argmax(stacked, axis=0)
        delta = stacked.max(axis=0) + emissions[i]

    state = int(np.argmax(delta))
    score = float(delta[state]) / max(n, 1)
    positions = np.zeros(n, dtype=int)
    positions[-1] = state
    for i in range(n - 2, -1, -1):
        move = choices[i, state]
        if move == 0:
            state = (state - 1) % meter
        elif move == 2:
            state = (state - 2) % meter
        positions[i] = state
    return score, positions + 1


def _zscore(x: np.ndarray) -> np.ndarray:
    std = float(np.std(x))
    if std < 1e-12:
        return np.zeros_like(x)
    return (x - np.mean(x)) / std


def _harmonic_change_cue(
    chroma: np.ndarray, beat_frames: np.ndarray, n_frames: int
) -> np.ndarray:
    """Per-beat harmonic-change evidence: 1 - cosine similarity between
    the mean chroma of the spans before and after each beat. Bar starts
    in real music are where the harmony moves (bass root / chord
    changes) — the cue that disambiguates the half-bar phase flip a
    kick-every-beat + snare-backbeat pattern leaves open (both phases
    keep the snares on 2 and 4). Normalised with an ABSOLUTE floor so a
    harmonically static track contributes ~nothing instead of z-score-
    amplified noise."""

    cs = np.concatenate(
        [np.zeros((chroma.shape[0], 1)), np.cumsum(chroma, axis=1)], axis=1
    )
    # The caller's guard admits chroma a frame or two short of n_frames
    # (half-precision readback trims trailing frames); clip every span
    # bound to the cumsum's real width so a short chroma degrades to a
    # slightly-truncated final span instead of an IndexError.
    hi = min(n_frames, cs.shape[1] - 1)
    bounds = np.concatenate([[0], np.clip(beat_frames, 0, hi), [hi]])
    bounds = np.maximum.accumulate(bounds)
    sums = cs[:, bounds[1:]] - cs[:, bounds[:-1]]  # (12, n_beats+1) span sums
    norms = np.linalg.norm(sums, axis=0)
    safe = np.where(norms > 1e-12, norms, 1.0)
    unit = sums / safe
    # change at beat k = 1 - cos(span k-1->k, span k->k+1)
    change = 1.0 - np.sum(unit[:, :-1] * unit[:, 1:], axis=0)
    change = np.where((norms[:-1] > 1e-12) & (norms[1:] > 1e-12), change, 0.0)
    centred = change - np.mean(change)
    # Weight 3.0: where harmony clearly moves at bar rate this cue must
    # be able to OUT-VOTE the timbre net (weight 2.0) — harmonic rhythm
    # is the strongest downbeat determinant in real music, and the net
    # is the evidence source most exposed to out-of-family timbre
    # (measured on the independent-engine song: the net votes the
    # half-bar flip at +1.2 while harmony votes the true phase; 3.0
    # flips both the phase and the 3-vs-4 meter decision to correct,
    # F1 0.29 -> 0.90). Harmonically static material (every percussion
    # fixture) keeps |cue| ~ 0 through the absolute std floor.
    return 3.0 * centred / (np.std(centred) + 0.05)


def decode_from_accent(
    energy: np.ndarray,
    low: np.ndarray,
    beat_times: np.ndarray,
    sample_rate: int,
    *,
    flux: "np.ndarray | None" = None,
    net_prob: "np.ndarray | None" = None,
    chroma: "np.ndarray | None" = None,
) -> "DownbeatTrackingResult | None":
    """Host decoder over precomputed accent curves (shared with the fused
    substrate graph, substrate.py). When per-frame P(downbeat) activations
    from the trained net are supplied they join the accent evidence and
    the result is tagged source="rnn". ``chroma`` (12, n_frames) adds the
    harmonic-change cue (see _harmonic_change_cue)."""

    beat_times = np.asarray(beat_times, dtype=float)
    if beat_times.size < 4:
        return None
    n_frames = energy.size
    if n_frames == 0:
        return None

    beat_frames = np.clip(
        np.floor(beat_times * sample_rate / _HOP).astype(int), 0, n_frames - 1
    )
    # Per-beat features: max over frames [f, f+2] absorbs the frame
    # quantisation of the grid.
    idx = np.clip(beat_frames[:, None] + np.arange(3)[None, :], 0, n_frames - 1)
    accent = _zscore(energy[idx].max(axis=1)) + _zscore(low[idx].max(axis=1))
    if flux is not None and flux.size == n_frames:
        accent = accent + 0.5 * _zscore(flux[idx].max(axis=1))
    if chroma is not None and chroma.shape[-1] >= n_frames - 2:
        accent = accent + _harmonic_change_cue(
            np.asarray(chroma, dtype=np.float64)[:, :n_frames], beat_frames, n_frames
        )
    source = "accent"
    if net_prob is not None and net_prob.size >= n_frames - 2:
        np_idx = np.clip(idx, 0, net_prob.size - 1)
        accent = accent + 2.0 * _zscore(net_prob[np_idx].max(axis=1))
        source = "rnn"
    accent = np.clip(accent, -6.0, 6.0)  # bound single-beat outliers

    n = accent.size
    best = None
    for meter in (3, 4):
        if n < 2 * meter:
            continue
        score, positions = _viterbi_positions(accent, meter)
        # Prefer 4/4 on near-ties — the overwhelmingly common meter.
        score = score * (1.05 if meter == 4 and score > 0 else 1.0)
        if best is None or score > best[0]:
            best = (score, positions)

    if best is None:
        return None
    _, positions = best
    downbeat_times = beat_times[positions == 1]
    return DownbeatTrackingResult(
        downbeat_times=[float(t) for t in downbeat_times],
        beat_positions=[int(p) for p in positions],
        source=source,
    )
