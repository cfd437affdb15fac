"""Core types and deterministic seeding helpers.

Mirrors the reference's public surface (reference: src/track_analyser/
utils.py:24-146) — ``AudioInput``, ``coerce_audio``, ``deterministic_rng``,
``seed_everything`` — while representing audio as arrays that drop straight
onto the device (mono ``f32[n]`` plus optional channel-major stereo ``f32[2, n]``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

from .config import DEFAULT_SEED, DEFAULT_SR
from .io.loader import load_audio
from .ops.resample import resample_poly_host

__all__ = [
    "AudioInput",
    "coerce_audio",
    "deterministic_rng",
    "seed_everything",
    "DEFAULT_SR",
    "DEFAULT_SEED",
]


@dataclass(slots=True)
class AudioInput:
    """Audio payload: mono float32 samples plus optional stereo channels."""

    samples: np.ndarray
    sample_rate: int
    path: Optional[str] = None
    stereo_samples: Optional[np.ndarray] = None

    @property
    def duration(self) -> float:
        return float(len(self.samples)) / float(self.sample_rate)


CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_persistent_compilation_cache() -> None:
    """Keep compiled executables on disk so later runs skip XLA compiles.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already caches there
    and nothing is configured here. Otherwise the cache goes to the fixed
    directory ``CACHE_DIR`` inside the checkout (git-ignored), so every
    run from the same checkout finds the same entries.

    Also honours TRACK_ANALYSER_TPU_DEBUG_NANS=1 — the numerical-sanitizer
    mode (jax_debug_nans) for debugging device graphs.
    """

    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        except OSError:
            pass  # cache is an optimisation, never a requirement
    if os.environ.get("TRACK_ANALYSER_TPU_DEBUG_NANS") == "1":
        jax.config.update("jax_debug_nans", True)


def deterministic_rng(seed: int = DEFAULT_SEED) -> np.random.Generator:
    """Return a numpy Generator seeded deterministically."""

    return np.random.default_rng(seed)


def seed_everything(seed: int = DEFAULT_SEED) -> None:
    """Seed the global host RNGs for deterministic behaviour.

    On-device randomness in this framework is always threaded explicitly via
    ``jax.random.PRNGKey(seed)``; this helper only pins the host RNGs for
    parity with the reference seed contract (utils.py:48-52).
    """

    np.random.seed(seed)
    random.seed(seed)


def _resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return samples
    return resample_poly_host(samples, orig_sr, target_sr)


def _unpack_source(
    source, mono: bool
) -> tuple[np.ndarray, Optional[np.ndarray], Optional[int], Optional[str]]:
    """Normalise any accepted source into (mono, stereo|None, sr|None, path).

    ``sr=None`` means "already at the caller's nominal rate" (raw arrays
    carry no rate of their own — reference semantics, utils.py:117-141).
    """

    if isinstance(source, AudioInput):
        stereo = (
            np.asarray(source.stereo_samples, dtype=np.float32)
            if source.stereo_samples is not None
            else None
        )
        return (
            np.asarray(source.samples, dtype=np.float32),
            stereo,
            source.sample_rate,
            source.path,
        )

    if isinstance(source, (str, Path)):
        path = str(source)
        data, sr, _meta = load_audio(path, mono=False)
        data = np.asarray(data, dtype=np.float32)
        if data.ndim > 1:
            return data.mean(axis=0), data, sr, path
        return data, None, sr, path

    if isinstance(source, np.ndarray) or (isinstance(source, tuple) and len(source) == 2):
        if isinstance(source, tuple):
            data, sr = source
            arr = np.asarray(list(data), dtype=np.float32)
            rate: Optional[int] = int(sr)
        else:
            arr, rate = np.asarray(source, dtype=np.float32), None
        if arr.ndim > 1:
            # mono=False keeps the raw layout in .samples (reference
            # behaviour for array sources, utils.py:117-124)
            return (arr.mean(axis=0) if mono else arr, arr, rate, None)
        return arr, None, rate, None

    raise TypeError(f"Unsupported audio source type: {type(source)!r}")


def coerce_audio(
    source: "str | Path | Sequence[float] | np.ndarray | AudioInput | tuple[Iterable[float], int]",
    *,
    target_sr: int = DEFAULT_SR,
    mono: bool = True,
) -> AudioInput:
    """Normalise ``source`` into an :class:`AudioInput` at ``target_sr``.

    Accepts a path, a numpy array, an ``(iterable, sr)`` tuple, or an
    existing :class:`AudioInput` (reference behaviour: utils.py:73-146).
    """

    mono_samples, stereo, sr, path = _unpack_source(source, mono)
    if sr is not None and sr != target_sr:
        if stereo is not None:
            stereo = _resample(stereo, sr, target_sr)
            mono_samples = stereo.mean(axis=0) if mono else _resample(mono_samples, sr, target_sr)
        else:
            mono_samples = _resample(mono_samples, sr, target_sr)
    return AudioInput(
        samples=np.asarray(mono_samples, dtype=np.float32),
        sample_rate=target_sr,
        path=path,
        stereo_samples=stereo,
    )
