"""Polyphase resampling.

Two tiers:

* ``resample_poly_host`` — host-side numpy/scipy polyphase resampler used at
  load time (decode + resample stay on CPU; reference: io.py:38-53).
* ``true_peak_oversample_matrix`` / ``oversampled_peak`` — the device-side
  x8 polyphase upsampler used for BS.1770 true-peak measurement
  (reference: analysis/loudness.py:81-97 uses scipy.signal.resample_poly).
  The polyphase filter is expressed as a single framed matmul instead of
  a scalar FIR loop.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _scipy_signal

__all__ = [
    "resample_poly_host",
    "polyphase_filter",
    "true_peak_oversample_matrix",
    "oversampled_peak",
    "decimate_fir",
]


@lru_cache(maxsize=8)
def _decimation_kernel(sr: int, decim: int, keep_hz: float) -> np.ndarray:
    """Blackman-windowed sinc lowpass for ``decim``-fold decimation.

    Only the band below ``keep_hz`` must survive uncorrupted (the
    multi-resolution chroma reads nothing above it), so the stopband
    starts where aliases would FOLD INTO that band — sr/decim - keep_hz —
    which keeps the transition wide and the kernel short."""

    pass_hz = keep_hz
    stop_hz = sr / decim - keep_hz
    if stop_hz <= pass_hz:
        raise ValueError(f"decimation keep_hz {keep_hz} too high for sr/decim {sr}/{decim}")
    taps = int(np.ceil(6.0 * sr / (stop_hz - pass_hz)))
    taps |= 1  # odd length -> integer group delay
    cutoff = 0.5 * (pass_hz + stop_hz) / (sr / 2.0)  # fraction of Nyquist
    n = np.arange(taps) - taps // 2
    h = cutoff * np.sinc(cutoff * n) * np.blackman(taps)
    h /= np.sum(h)
    return h.astype(np.float32)


@lru_cache(maxsize=8)
def _decimation_toeplitz(sr: int, decim: int, keep_hz: float, lanes: int) -> np.ndarray:
    """(3*lanes*decim, lanes) banded matrix computing ``lanes`` adjacent
    decimated outputs from one signal block (see decimate_fir)."""

    h = np.asarray(_decimation_kernel(sr, decim, keep_hz), dtype=np.float64)
    taps = h.size
    hop_block = lanes * decim
    if taps // 2 > hop_block:
        raise ValueError(f"decimation kernel ({taps} taps) exceeds the block span")
    mat = np.zeros((3 * hop_block, lanes), dtype=np.float64)
    for c in range(lanes):
        start = hop_block + c * decim - taps // 2
        mat[start : start + taps, c] = h
    return mat.astype(np.float32)


def decimate_fir(y: jnp.ndarray, decim: int, *, sr: int, keep_hz: float) -> jnp.ndarray:
    """Anti-aliased ``decim``-fold decimation (device, jittable).

    out[k] is centred on y[k*decim] (odd symmetric kernel, zero padding
    beyond both ends), so STFT frame grids of the decimated signal align
    with the full-rate grid.

    Computing 128 adjacent outputs per block against a banded Toeplitz
    matrix turns the whole decimation into ONE matmul,
    (B, 3*128*decim) @ (3*128*decim, 128) (~6 GFLOP for 8.4M samples),
    instead of a single-channel strided convolution or a matvec."""

    from .stft import frame_signal

    if decim == 1:
        # Identity grid: out[k] = y[k]. No decimation -> no aliasing, so
        # the anti-alias lowpass is unnecessary (callers only read bins
        # below keep_hz, which a 1-fold "decimation" leaves untouched) —
        # and the kernel design would be infeasible anyway once
        # sr <= 2*keep_hz (stopband below passband). One trailing zero
        # matches the 1 + n//decim output convention.
        return jnp.pad(y, (0, 1))

    lanes = 128
    hop_block = lanes * decim
    n = y.shape[-1]
    m_out = 1 + n // decim
    n_blocks = -(-m_out // lanes)
    mat = jnp.asarray(_decimation_toeplitz(sr, decim, keep_hz, lanes))
    length = 3 * hop_block
    # Block b reads ypad[b*hop_block : b*hop_block + 3*hop_block), where
    # ypad carries one leading block of zeros (kernel centre offset).
    pad_tail = (n_blocks - 1) * hop_block + length - hop_block - n
    ypad = jnp.pad(y, (hop_block, pad_tail))
    frames = frame_signal(ypad, length, hop_block, center=False)[:n_blocks]
    out = jnp.dot(frames, mat, precision=jax.lax.Precision.HIGHEST)
    return out.reshape(-1)[:m_out]


def resample_poly_host(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample along the last axis using a kaiser-windowed polyphase FIR."""

    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = _scipy_signal.resample_poly(
        np.asarray(x, dtype=np.float32), up, down, axis=-1
    )
    return np.asarray(out, dtype=np.float32)


def polyphase_filter(up: int, down: int = 1, *, beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed lowpass FIR for polyphase resampling.

    Matches the design scipy.signal.resample_poly uses by default
    (window=('kaiser', 5.0), half-length 10*max(up, down)) so the device
    true-peak path is numerically equivalent to the reference formula.
    """

    max_rate = max(up, down)
    half_len = 10 * max_rate
    n_taps = 2 * half_len + 1
    cutoff = 1.0 / max_rate  # fraction of Nyquist
    n = np.arange(n_taps) - half_len
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(n_taps, beta)
    h /= np.sum(h)  # unity DC gain
    return (h * up).astype(np.float64)


@lru_cache(maxsize=8)
def true_peak_oversample_matrix(up: int) -> np.ndarray:
    """Polyphase matrix H of shape (n_rows, up).

    With frames X[n, i] = x[n + half_len//up - i], the oversampled signal is
    Y = X @ H, where Y[n, p] = y[up*n + p] of the zero-stuff-and-filter
    upsampler. One matmul replaces the scalar FIR.
    """

    h = polyphase_filter(up, 1)
    n_taps = h.size  # 2*10*up + 1
    n_rows = int(np.ceil(n_taps / up))
    hpad = np.zeros(n_rows * up, dtype=np.float64)
    hpad[:n_taps] = h
    # H[i, p] = h[up*i + p]
    return hpad.reshape(n_rows, up).astype(np.float32)


def oversampled_peak(
    x: jnp.ndarray, up: int = 8, *, mask: "jnp.ndarray | None" = None
) -> jnp.ndarray:
    """Return max |polyphase-upsampled x| (device, jittable).

    Derivation: y[up*n + p] = sum_q x[n + half//up - q] * h[up*q + p].

    ``mask`` (optional, bool (n,)): restrict the max to OUTPUT rows whose
    leading input sample n is masked, while the interpolation still reads
    the true neighbouring samples. This is how a sequence-sharded caller
    claims only its own sample range without fabricating a zero step at
    shard boundaries — zeroing the *input* outside the range rings the
    interpolator (~1 dB overshoot on a plateau crossing the boundary).
    """

    hmat = jnp.asarray(true_peak_oversample_matrix(up))
    n_rows = hmat.shape[0]
    shift = (n_rows - 1) // 2  # = half_len // up = 10
    n = x.shape[-1]
    xp = jnp.pad(x, (n_rows - 1 - shift, shift))
    # Reversed windows X[n, q] = xp[n + (n_rows-1) - q], assembled from
    # n_rows contiguous shifted slices (no gather).
    frames = jnp.stack(
        [xp[(n_rows - 1 - q) : (n_rows - 1 - q) + n] for q in range(n_rows)],
        axis=-1,
    )
    y = jnp.abs(jnp.dot(frames, hmat, precision=jax.lax.Precision.HIGHEST))
    if mask is not None:
        y = jnp.where(mask[:, None], y, 0.0)
    return jnp.max(y)
