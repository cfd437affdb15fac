"""Smoothing / median filtering primitives (jittable).

``gaussian_filter1d`` reproduces the scipy.ndimage semantics the reference
leans on (structure.py:200, 216, 223): truncate=4.0, reflect boundary.

``median_filter_1d`` powers HPSS (structure.py:52). XLA has no sliding
median primitive, and a generic sort over a stacked window tensor is both
slow and memory-hungry; the median is instead selected by a pruned
bitonic min/max network over shifted slices, which fuses elementwise.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["gaussian_kernel", "gaussian_filter1d", "median_filter_1d", "softmask", "hpss"]


@lru_cache(maxsize=32)
def gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter1d(x: jnp.ndarray, sigma: float, axis: int = -1) -> jnp.ndarray:
    """Gaussian smoothing along ``axis`` with reflect boundaries.

    Narrow kernels correlate via shifted-slice FMAs; wide kernels (the
    0.5 s percussive-ratio smoother, K=345) go through one FFT
    convolution — neither needs a gather.
    """

    kernel_np = gaussian_kernel(float(sigma))
    ksize = kernel_np.shape[0]
    radius = ksize // 2
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(radius, radius)], mode="reflect")

    if ksize <= 48:
        kernel = jnp.asarray(kernel_np)
        y = jnp.zeros_like(x)
        for j in range(ksize):
            y = y + kernel[j] * xp[..., j : j + n]
    else:
        n_fft = int(2 ** np.ceil(np.log2(xp.shape[-1] + ksize)))
        spec = jnp.fft.rfft(xp, n=n_fft, axis=-1) * jnp.fft.rfft(
            jnp.asarray(kernel_np), n=n_fft
        )
        # FFT computes convolution; for the symmetric kernel correlation
        # equals convolution shifted by ksize-1 relative to the padded
        # input: y[t] = conv[t + ksize - 1].
        y = jnp.fft.irfft(spec, n=n_fft, axis=-1)[..., ksize - 1 : ksize - 1 + n]
    return jnp.moveaxis(y, -1, axis)


@lru_cache(maxsize=8)
def _bitonic_pairs(n: int) -> tuple:
    """Comparator schedule of Batcher's bitonic sorting network on ``n``
    (a power of two) inputs: ``(i, partner, ascending)`` triples."""

    pairs = []
    k = 2
    while k <= n:
        j = k // 2
        while j > 0:
            for i in range(n):
                partner = i ^ j
                if partner > i:
                    pairs.append((i, partner, (i & k) == 0))
            j //= 2
        k *= 2
    return tuple(pairs)


@lru_cache(maxsize=8)
def _selection_ops(n: int, target: int) -> tuple:
    """Bitonic network pruned to the single sorted output ``target``.

    Backward liveness over the comparator schedule: a comparator whose
    two outputs are both dead is dropped, and one with a single live
    output emits one min/max instead of two. For the median of 31 inside
    a 32-input network this cuts 480 min/max operations to 351.
    Each entry is ``(a, b, ascending, a_live, b_live)``.
    """

    live = {target}
    ops = []
    for a, b, ascending in reversed(_bitonic_pairs(n)):
        a_live, b_live = a in live, b in live
        if not (a_live or b_live):
            continue
        ops.append((a, b, ascending, a_live, b_live))
        live.add(a)
        live.add(b)
    ops.reverse()
    return tuple(ops)


def _select_rank(vals: list, rank: int) -> jnp.ndarray:
    """Element of sorted order ``rank`` across ``vals`` (equal-shape
    arrays), elementwise, by the pruned bitonic min/max network.

    Padding to a power of two with +inf keeps the pads above every real
    value, so they never reach a rank below ``len(vals)``. Comparisons
    are exact, so the result is bit-identical to a sort.
    """

    n = 1 << max(1, (len(vals) - 1).bit_length())
    vals = list(vals) + [jnp.full_like(vals[0], jnp.inf)] * (n - len(vals))
    for a, b, ascending, a_live, b_live in _selection_ops(n, rank):
        va, vb = vals[a], vals[b]
        lo, hi = (jnp.minimum, jnp.maximum) if ascending else (jnp.maximum, jnp.minimum)
        if a_live:
            vals[a] = lo(va, vb)
        if b_live:
            vals[b] = hi(va, vb)
    return vals[rank]


def median_filter_1d(x: jnp.ndarray, size: int, axis: int = -1) -> jnp.ndarray:
    """Sliding median along ``axis`` with reflect boundaries.

    The padding is ``jnp.pad(mode="reflect")`` (d c b | a b c d), which
    is scipy.ndimage's "mirror" mode: the result equals
    ``scipy.ndimage.median_filter(mode="mirror")`` with a window of
    ``size`` along ``axis``, origin at ``size // 2`` and, for even sizes,
    the upper median (sorted rank ``size // 2``). The window's
    ``size`` shifted slices feed an elementwise min/max selection
    network, which XLA fuses into one pass over the input; no window
    tensor is materialised and no sort runs.
    """

    axis = axis % x.ndim
    n = x.shape[axis]
    left = size // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (left, size - 1 - left)
    xp = jnp.pad(x, pad, mode="reflect")
    windows = [jax.lax.slice_in_dim(xp, j, j + n, axis=axis) for j in range(size)]
    return _select_rank(windows, size // 2)


def softmask(x: jnp.ndarray, x_ref: jnp.ndarray, *, power: float = 2.0, split_zeros: bool = True) -> jnp.ndarray:
    """librosa-style soft mask: (X/Z)^p / ((X/Z)^p + (Xref/Z)^p)."""

    z = jnp.maximum(jnp.maximum(x, x_ref), jnp.finfo(x.dtype).tiny)
    ref_p = (x_ref / z) ** power
    x_p = (x / z) ** power
    mask = x_p / (x_p + ref_p)
    bad = jnp.maximum(x, x_ref) < jnp.finfo(x.dtype).tiny
    fill = 0.5 if split_zeros else 0.0
    return jnp.where(bad, fill, mask)


def hpss(s: jnp.ndarray, *, kernel_size: int = 31, power: float = 2.0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Harmonic/percussive separation of a magnitude spectrogram (freq, time).

    Median-filter along time for the harmonic reference, along frequency for
    the percussive reference, then split via soft masks (reference semantics:
    structure.py:52 -> librosa.decompose.hpss defaults, margin=1).

    """

    harm_ref = median_filter_1d(s, kernel_size, axis=-1)
    perc_ref = median_filter_1d(s, kernel_size, axis=-2)
    mask_h = softmask(harm_ref, perc_ref, power=power, split_zeros=True)
    mask_p = softmask(perc_ref, harm_ref, power=power, split_zeros=True)
    return s * mask_h, s * mask_p
