"""Mel / MFCC primitives.

Filterbanks are precomputed on host (numpy, cached per (sr, n_fft)) and the
device work is one filterbank matmul per spectrogram. The mel scale is
Slaney-style (linear below 1 kHz, log above),
matching the convention the reference inherits from librosa
(structure.py:53-59, tempo.py:16-24 via onset_strength).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# Filterbank matmuls feed gated results: full float32, never TF32.
_PRECISION = jax.lax.Precision.HIGHEST

__all__ = [
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "dct_matrix",
    "power_to_db",
    "amplitude_to_db",
    "melspectrogram_from_power",
    "mfcc_from_log_mel",
]

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1_000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs
    )
    return freqs


@lru_cache(maxsize=32)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_mels, 1+n_fft/2)."""

    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalisation
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix of shape (n_out, n_in)."""

    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


def power_to_db(
    s: jnp.ndarray,
    *,
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> jnp.ndarray:
    """10*log10(S/ref) with floor clipping (librosa convention)."""

    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, s))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, jnp.asarray(ref)))
    if top_db is not None:
        log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - top_db)
    return log_spec


def amplitude_to_db(
    s: jnp.ndarray, *, ref: float = 1.0, amin: float = 1e-5, top_db: float | None = None
) -> jnp.ndarray:
    return power_to_db(s**2, ref=ref**2, amin=amin**2, top_db=top_db)


def melspectrogram_from_power(power_spec: jnp.ndarray, fb: np.ndarray) -> jnp.ndarray:
    """Project a power spectrogram (freq, time) through the mel filterbank."""

    return jnp.dot(jnp.asarray(fb), power_spec, preferred_element_type=jnp.float32, precision=_PRECISION)


def mfcc_from_log_mel(log_mel: jnp.ndarray, n_mfcc: int = 13) -> jnp.ndarray:
    """MFCCs via an orthonormal DCT-II matmul; input (n_mels, time)."""

    mat = jnp.asarray(dct_matrix(n_mfcc, log_mel.shape[0]))
    return jnp.dot(mat, log_mel, preferred_element_type=jnp.float32, precision=_PRECISION)
