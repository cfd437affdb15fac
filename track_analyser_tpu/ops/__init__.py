"""Kernel/ops tier: jittable DSP primitives replacing the reference's
librosa/scipy/pyloudnorm substrate with XLA-friendly ops."""

from . import chroma, filters, loudness, mel, onset, peaks, resample, spectral, stft

__all__ = [
    "chroma",
    "filters",
    "loudness",
    "mel",
    "onset",
    "peaks",
    "resample",
    "spectral",
    "stft",
]
