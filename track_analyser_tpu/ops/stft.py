"""Framing and short-time Fourier transforms (jittable).

Semantics follow the conventions the reference inherits from librosa 0.10
(hann window, centred frames, zero pad): stft(y, n_fft, hop)[k, t] analyses
samples around t*hop. Everything here is shape-static and jit/vmap/pjit
friendly; framing assembles from contiguous shifted reshapes (no XLA
gather) and the transform is ``jnp.fft.rfft`` on every backend.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

__all__ = ["hann_window", "n_frames", "frame_signal", "stft", "magnitude", "fft_frequencies"]


@lru_cache(maxsize=32)
def hann_window(n: int) -> np.ndarray:
    """Periodic (DFT-even) hann window, the librosa/scipy default."""

    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def n_frames(n_samples: int, hop_length: int) -> int:
    """Frame count for a centred framing of ``n_samples``."""

    return 1 + n_samples // hop_length


def frame_signal(
    y: jnp.ndarray,
    frame_length: int,
    hop_length: int,
    *,
    center: bool = True,
) -> jnp.ndarray:
    """Return frames of shape (n_frames, frame_length) (time-major).

    With ``center=True`` the signal is zero-padded by frame_length//2 on
    both sides so frame t is centred at sample t*hop_length.

    When frame_length is a multiple of hop_length (every framing in this
    codebase) frames are assembled from k = frame_length // hop_length
    contiguous shifted reshapes — pure slices, no gather.
    """

    n = y.shape[-1]
    if center:
        pad = frame_length // 2
        total = 1 + n // hop_length
    else:
        pad = 0
        total = 1 + (n - frame_length) // hop_length

    if frame_length % hop_length == 0 and pad % hop_length == 0:
        k = frame_length // hop_length
        # Frame t covers padded samples [t*hop, t*hop + frame): exactly
        # chunk rows t .. t+k-1 of the hop-chunked padded signal.
        need_chunks = total - 1 + k
        tail = need_chunks * hop_length - (pad + n)
        yp = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, max(tail, 0))])
        chunks = yp[..., : need_chunks * hop_length].reshape(
            y.shape[:-1] + (need_chunks, hop_length)
        )
        parts = [chunks[..., j : j + total, :] for j in range(k)]
        return jnp.concatenate(parts, axis=-1)

    # General case (unused by the built-in configs): gather framing.
    starts = jnp.arange(total) * hop_length
    idx = starts[:, None] + jnp.arange(frame_length)[None, :]
    if center:
        y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)])
    return y[..., idx]


def stft(
    y: jnp.ndarray,
    n_fft: int,
    hop_length: int,
    *,
    window: np.ndarray | None = None,
    center: bool = True,
) -> jnp.ndarray:
    """Complex STFT of shape (..., 1 + n_fft // 2, n_frames)."""

    win = jnp.asarray(hann_window(n_fft) if window is None else window)
    frames = frame_signal(y, n_fft, hop_length, center=center) * win
    spec = jnp.fft.rfft(frames, n=n_fft, axis=-1)
    return jnp.swapaxes(spec, -1, -2)


def magnitude(y: jnp.ndarray, n_fft: int, hop_length: int, power: float = 1.0) -> jnp.ndarray:
    """|STFT|**power without materialising the complex intermediate twice."""

    s = jnp.abs(stft(y, n_fft, hop_length))
    if power == 1.0:
        return s
    if power == 2.0:
        return s * s
    return s**power


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)


def istft(
    spec: jnp.ndarray,
    n_fft: int,
    hop_length: int,
    n_samples: int,
    *,
    window: np.ndarray | None = None,
    f_valid: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Inverse STFT via windowed overlap-add with squared-window norm.

    Inverts :func:`stft` (centred, hann) back to ``n_samples`` samples.
    The scatter-add lowers to one XLA scatter.

    ``f_valid`` (optional, dynamic): number of valid frames. Frames at or
    beyond it are excluded from BOTH the overlap-add and the window-sum
    normalisation, so a bucket-padded spectrogram inverts to exactly the
    samples an exact-shape spectrogram would (the padding frames'
    windows would otherwise inflate the normaliser near the tail).
    """

    win = jnp.asarray(hann_window(n_fft) if window is None else window)
    frames = jnp.fft.irfft(jnp.swapaxes(spec, -1, -2), n=n_fft, axis=-1) * win
    total_frames = frames.shape[-2]
    pad = n_fft // 2
    out_len = total_frames * hop_length + n_fft

    wsq = jnp.broadcast_to(win * win, (total_frames, n_fft))
    if f_valid is not None:
        fmask = jnp.arange(total_frames) < f_valid
        frames = jnp.where(fmask[:, None], frames, 0.0)
        wsq = jnp.where(fmask[:, None], wsq, 0.0)

    starts = jnp.arange(total_frames) * hop_length
    idx = (starts[:, None] + jnp.arange(n_fft)[None, :]).reshape(-1)
    signal = jnp.zeros(out_len, dtype=frames.dtype).at[idx].add(frames.reshape(-1))
    wss = jnp.zeros(out_len, dtype=frames.dtype).at[idx].add(wsq.reshape(-1))
    signal = signal / jnp.maximum(wss, 1e-8)
    return signal[pad : pad + n_samples]
