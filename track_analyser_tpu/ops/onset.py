"""Onset-strength envelope and FFT autocorrelation (jittable).

Reproduces the spectral-flux convention the reference uses through
librosa.onset.onset_strength (tempo.py:16-24, structure.py:195): log-mel
spectrogram, positive first difference, mean over mel bands, and the
centre-compensation left-pad of lag + n_fft // (2 * hop) frames.
"""

from __future__ import annotations

import jax.numpy as jnp

from .mel import power_to_db

__all__ = ["onset_strength_from_mel", "autocorrelate"]


def onset_strength_from_mel(
    mel_power: jnp.ndarray,
    *,
    n_fft: int,
    hop_length: int,
    lag: int = 1,
    center: bool = True,
) -> jnp.ndarray:
    """Onset envelope from a mel POWER spectrogram (n_mels, n_frames)."""

    s_db = power_to_db(mel_power)
    flux = jnp.maximum(0.0, s_db[:, lag:] - s_db[:, :-lag])
    env = jnp.mean(flux, axis=0)
    pad_width = lag + (n_fft // (2 * hop_length) if center else 0)
    env = jnp.pad(env, (pad_width, 0))
    if center:
        env = env[: mel_power.shape[-1]]
    return env


def tempogram(env: jnp.ndarray, win_length: int = 384) -> jnp.ndarray:
    """Local autocorrelation tempogram of an onset envelope.

    Returns (win_length, n_frames); each column is the hann-windowed
    autocorrelation of the envelope around that frame, inf-normalised
    (used for the tempogram plot; reference: report.py:260-262).
    """

    pad = win_length // 2
    envp = jnp.pad(env, (pad, pad), mode="linear_ramp", end_values=0.0)
    return tempogram_prepadded(envp, win_length)


def tempogram_prepadded(envp: jnp.ndarray, win_length: int = 384) -> jnp.ndarray:
    """:func:`tempogram` on an envelope already padded by win_length//2 on
    each side — for callers that must construct the boundary ramps
    themselves (the bucket-padded report graph recreates the exact-shape
    linear ramp at f_valid, which may extend past the bucket's own end
    when the bucket adds fewer than win_length//2 frames)."""

    pad = win_length // 2
    n = envp.shape[-1] - 2 * pad
    # frames[t, k] = envp[t + k], assembled from win_length shifted slices
    # (slice-stack, no gather).
    frames = jnp.stack([envp[k : k + n] for k in range(win_length)], axis=-1)
    w = jnp.asarray(
        (0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(win_length) / win_length)),
        dtype=envp.dtype,
    )
    frames = frames * w
    n_pad = 1 << (2 * win_length - 2).bit_length()  # pow2 >= 2w-1
    spec = jnp.fft.rfft(frames, n=n_pad, axis=-1)
    ac = jnp.fft.irfft(spec * jnp.conj(spec), n=n_pad, axis=-1)[:, :win_length]
    scale = jnp.max(jnp.abs(ac), axis=-1, keepdims=True)
    ac = ac / jnp.where(scale > 0, scale, 1.0)
    return ac.T


def autocorrelate(y: jnp.ndarray) -> jnp.ndarray:
    """Full (non-normalised) autocorrelation via FFT, same length as input.

    The pad target is the next power of two at or above 2n-1 (the linear
    autocorrelation minimum): FFT libraries run sizes with large prime
    factors far slower than a power of two.
    """

    n = y.shape[-1]
    n_pad = 1 << (2 * n - 2).bit_length()  # pow2 >= 2n-1: linear, fast
    spec = jnp.fft.rfft(y, n=n_pad, axis=-1)
    ac = jnp.fft.irfft(spec * jnp.conj(spec), n=n_pad, axis=-1)
    return ac[..., :n]
