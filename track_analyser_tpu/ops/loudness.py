"""EBU R128 / ITU-R BS.1770 loudness, gated, fully on device.

The reference delegates to pyloudnorm (analysis/loudness.py:59-68), a
sample-serial IIR implementation. A serial IIR cannot use the device's
parallelism, so the K-weighting cascade (high-shelf + RLB high-pass
biquads, coefficients from the BS.1770 analog prototype pre-warped per
sample rate) is applied as an FFT convolution with the cascade's
truncated impulse response — numerically equivalent far below the +-0.3 LU test tolerance (tail < 1e-7 after 16k
samples) and bandwidth-bound instead of latency-bound.

Gating (400 ms blocks, 75% overlap, -70 LUFS absolute and -10 LU relative
gates) is expressed as masked reductions over a framed energy tensor —
static shapes, one XLA fusion.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .mel import amplitude_to_db
from .stft import frame_signal

__all__ = [
    "k_weighting_coeffs",
    "k_weighting_fir",
    "k_weighted",
    "integrated_lufs",
    "rms_db_curve",
    "ebu_loudness_range",
]


def _high_shelf(fs: float, gain_db: float, q: float, fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-1 pre-filter (head-effect high shelf)."""

    k = np.tan(np.pi * fc / fs)
    vh = 10.0 ** (gain_db / 20.0)
    vb = vh**0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b = np.array(
        [
            (vh + vb * k / q + k * k) / a0,
            2.0 * (k * k - vh) / a0,
            (vh - vb * k / q + k * k) / a0,
        ]
    )
    a = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return b, a


def _high_pass(fs: float, q: float, fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-2 RLB high pass."""

    k = np.tan(np.pi * fc / fs)
    denom = 1.0 + k / q + k * k
    a = np.array([1.0, 2.0 * (k * k - 1.0) / denom, (1.0 - k / q + k * k) / denom])
    b = np.array([1.0, -2.0, 1.0])
    return b, a


def k_weighting_coeffs(fs: float):
    """The two K-weighting biquads for sample rate ``fs``."""

    shelf = _high_shelf(fs, gain_db=3.999843853973347, q=0.7071752369554193, fc=1681.9744509555319)
    hp = _high_pass(fs, q=0.5003270373253953, fc=38.13547087613982)
    return shelf, hp


@lru_cache(maxsize=16)
def k_weighting_fir(fs: int, n_taps: int = 16_384) -> np.ndarray:
    """Truncated impulse response of the K-weighting cascade (host-designed)."""

    (b1, a1), (b2, a2) = k_weighting_coeffs(float(fs))
    x = np.zeros(n_taps)
    x[0] = 1.0
    from scipy.signal import lfilter

    h = lfilter(b2, a2, lfilter(b1, a1, x))
    return h.astype(np.float32)


def k_weighted(y: jnp.ndarray, fs: int) -> jnp.ndarray:
    """Apply K-weighting via FFT convolution (same length as input).

    Short signals take one whole-signal transform; long ones run
    overlap-save with power-of-two blocks, a batch of mid-size FFTs that
    computes the same linear convolution.
    """

    h_np = k_weighting_fir(fs)
    taps = int(h_np.shape[0])
    n = y.shape[-1]
    block = 32_768
    if n <= 4 * block:  # short signals: one transform is cheaper
        h = jnp.asarray(h_np)
        n_fft = int(2 ** np.ceil(np.log2(n + taps - 1)))
        spec = jnp.fft.rfft(y, n=n_fft) * jnp.fft.rfft(h, n=n_fft)
        return jnp.fft.irfft(spec, n=n_fft)[..., :n]

    n_fft = 1 << int(np.ceil(np.log2(block + taps - 1)))
    nb = -(-n // block)
    spec_h = jnp.asarray(np.fft.rfft(h_np, n=n_fft).astype(np.complex64))
    # Left-pad taps-1 (causal history), then pad the tail so block i is
    # exactly rows i..i+k-1 of the block-chunked signal (slice-stack
    # framing, no gather — same trick as ops/stft.frame_signal).
    k = n_fft // block
    total = (nb + k - 1) * block
    pad = [(0, 0)] * (y.ndim - 1) + [(taps - 1, total - (taps - 1) - n)]
    chunks = jnp.pad(y, pad).reshape(y.shape[:-1] + (nb + k - 1, block))
    frames = jnp.concatenate(
        [chunks[..., j : j + nb, :] for j in range(k)], axis=-1
    )  # (..., nb, n_fft)
    out = jnp.fft.irfft(jnp.fft.rfft(frames, axis=-1) * spec_h, n=n_fft, axis=-1)
    out = out[..., taps - 1 : taps - 1 + block]
    return out.reshape(y.shape[:-1] + (nb * block,))[..., :n]


def framed_energy(
    y: jnp.ndarray, frame_length: int, hop_length: int, *, center: bool
) -> jnp.ndarray:
    """Per-frame energy sum(y[frame]^2) without materialising the framed
    tensor.

    ``frame_signal`` + square + reduce materialises an
    (n_frames, frame_length) copy — for the loudness windows (0.4-3 s at
    44.1 kHz) that is ~10-30x the signal's bytes of pure HBM traffic,
    several times over (copy, square, reduce). When frame_length is a
    multiple of hop_length (every loudness framing here), frame t is
    exactly hop-chunks t..t+k-1 of the (pad-aligned) signal, so ONE pass
    computes per-chunk energy partials and each frame is a k-term sum of
    those. The k-term add (not a cumsum difference) keeps cancellation
    error at float-roundoff level. Falls back to the framed tensor for
    non-divisible layouts."""

    n = y.shape[-1]
    if frame_length % hop_length:
        frames = frame_signal(y, frame_length, hop_length, center=center)
        return jnp.sum(frames * frames, axis=-1)
    k = frame_length // hop_length
    pad = frame_length // 2 if center else 0
    if center and pad % hop_length:
        frames = frame_signal(y, frame_length, hop_length, center=center)
        return jnp.sum(frames * frames, axis=-1)
    total = 1 + n // hop_length if center else 1 + (n - frame_length) // hop_length
    need = total - 1 + k
    tail = need * hop_length - (pad + n)
    yp = jnp.pad(y, (pad, max(tail, 0)))[: need * hop_length]
    part = jnp.sum(
        jnp.square(yp.reshape(need, hop_length)), axis=-1
    )
    out = part[0:total]
    for j in range(1, k):
        out = out + part[j : j + total]
    return out


def integrated_lufs(
    y: jnp.ndarray,
    fs: int,
    *,
    block_seconds: float = 0.400,
    overlap: float = 0.75,
    absolute_gate: float = -70.0,
    relative_gate_lu: float = -10.0,
    n_valid: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Gated integrated loudness of a mono signal (BS.1770-4).

    ``n_valid`` marks the true sample count of a bucket-padded signal:
    blocks that extend past it are excluded, which reproduces the
    exact-shape result (ungated padding blocks would otherwise join the
    absolute-gate population).
    """

    yk = k_weighted(y, fs)
    frame_len = int(round(block_seconds * fs))
    hop = int(round(block_seconds * (1.0 - overlap) * fs))
    if yk.shape[-1] < frame_len:
        # Too short to gate: fall back to whole-signal energy.
        z = jnp.mean(yk * yk, axis=-1, keepdims=True)
        block_ok = jnp.ones(1, dtype=bool)
    else:
        z = framed_energy(yk, frame_len, hop, center=False) / frame_len
        if n_valid is not None:
            starts = jnp.arange(z.shape[0]) * hop
            block_ok = (starts + frame_len) <= n_valid
        else:
            block_ok = jnp.ones(z.shape[0], dtype=bool)

    eps = 1e-20
    loud = -0.691 + 10.0 * jnp.log10(z + eps)

    abs_mask = block_ok & (loud > absolute_gate)
    abs_count = jnp.maximum(jnp.sum(abs_mask), 1)
    z_abs = jnp.sum(jnp.where(abs_mask, z, 0.0)) / abs_count
    gamma_r = -0.691 + 10.0 * jnp.log10(z_abs + eps) + relative_gate_lu

    both_mask = abs_mask & (loud > gamma_r)
    count = jnp.maximum(jnp.sum(both_mask), 1)
    z_gated = jnp.sum(jnp.where(both_mask, z, 0.0)) / count
    return -0.691 + 10.0 * jnp.log10(z_gated + eps)


def rms_db_curve(y: jnp.ndarray, frame_length: int, hop_length: int) -> jnp.ndarray:
    """Sliding-window RMS in dB (reference: analysis/loudness.py:30-42 —
    centred frames, amplitude_to_db with its default 80 dB floor)."""

    rms = jnp.sqrt(framed_energy(y, frame_length, hop_length, center=True) / frame_length)
    return amplitude_to_db(rms + 1e-9, ref=1.0, top_db=80.0)


def ebu_loudness_range(y: jnp.ndarray, fs: int) -> jnp.ndarray:
    """EBU Tech 3342 loudness range: gated 3 s short-term distribution.

    (Extra capability beyond the reference's percentile fallback.)
    """

    yk = k_weighted(y, fs)
    frame_len = int(round(3.0 * fs))
    hop = int(round(1.0 * fs))
    if yk.shape[-1] < frame_len:
        return jnp.asarray(0.0)
    frames = frame_signal(yk, frame_len, hop, center=False)
    z = jnp.mean(frames * frames, axis=-1)
    eps = 1e-20
    loud = -0.691 + 10.0 * jnp.log10(z + eps)
    abs_mask = loud > -70.0
    n_abs = jnp.maximum(jnp.sum(abs_mask), 1)
    z_abs = jnp.sum(jnp.where(abs_mask, z, 0.0)) / n_abs
    rel_thresh = -0.691 + 10.0 * jnp.log10(z_abs + eps) - 20.0
    mask = abs_mask & (loud > rel_thresh)
    # Percentiles over the gated distribution via sorted masked values.
    big = 1e9
    vals = jnp.where(mask, loud, big)
    order = jnp.sort(vals)
    n_valid = jnp.sum(mask)
    lo_idx = jnp.clip((0.10 * (n_valid - 1)).astype(jnp.int32), 0, loud.shape[0] - 1)
    hi_idx = jnp.clip((0.95 * (n_valid - 1)).astype(jnp.int32), 0, loud.shape[0] - 1)
    lra = order[hi_idx] - order[lo_idx]
    return jnp.where(n_valid > 1, lra, 0.0)
