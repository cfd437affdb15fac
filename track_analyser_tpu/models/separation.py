"""Neural stem separation (checkpoint resolution for the band-split net).

Interface used by analysis/stems.py: ``available()`` reports whether a
trained checkpoint is present; ``separate(samples, sr, seed)`` returns a
dict of named stems. Without a checkpoint the DSP separator
(analysis/stems.py) is authoritative — the same graceful ladder the
reference applies to demucs (analysis/stems.py:26-61 in the reference).

The architecture (models/separation_net.py, pure-JAX parameter dicts) is
built from static shapes: STFT front-end, band-split linear encoders, mixing blocks
(depthwise time conv + band-mixing MLP), and per-stem complex mask
decoders — all static shapes. Training utilities live in
models/training.py.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

MODEL_NAME = "bandsplit-masknet-v5"
_CKPT_ENV = "TRACK_ANALYSER_TPU_SEPARATION_CKPT"
_CKPT_DIR = Path(__file__).parent / "checkpoints"
# Newest bundled checkpoint wins: v5 (dilated time-conv mixing blocks —
# receptive field grows 8x over v4's — trained from scratch on the E4
# hardened recipe: whisper-voice/resonant-noise co-occurrence draws,
# broadband whisper floors, 0.5-3.3 Hz syllable gates. First checkpoint
# whose PURE-NET output beats the input mixture on every stem x all four
# eval families — Δmix +1.7..+14.1 dB incl. the OOD3 drums cell that was
# -8.2 dB under v4; see RUNBOOK "Separation v5") over v4/v3/v2/v1.
_BUNDLED = (
    _CKPT_DIR / "separation_v5.npz",
    _CKPT_DIR / "separation_v4.npz",
    _CKPT_DIR / "separation_v3.npz",
    _CKPT_DIR / "separation_v2.npz",
    _CKPT_DIR / "separation_v1.npz",
)

__all__ = ["available", "separate", "MODEL_NAME"]


def _checkpoint_path() -> Optional[Path]:
    path = os.environ.get(_CKPT_ENV)
    if path and Path(path).exists():
        return Path(path)
    return next((p for p in _BUNDLED if p.exists()), None)


def available() -> bool:
    return _checkpoint_path() is not None


def model_name() -> str:
    """Name derived from the RESOLVED checkpoint (env overrides and older
    bundled files report their own version, not the newest's)."""

    path = _checkpoint_path()
    if path is None:
        return MODEL_NAME
    stem = path.stem  # e.g. "separation_v4"
    if stem.startswith("separation_"):
        return f"bandsplit-masknet-{stem.split('_', 1)[1]}"
    return f"bandsplit-masknet-{stem}"


def separate(
    samples: np.ndarray, sample_rate: int, *, seed: int = 0
) -> Optional[Dict[str, np.ndarray]]:
    """Run the neural separator if a checkpoint is available."""

    ckpt = _checkpoint_path()
    if ckpt is None:
        return None
    from . import separation_net

    return separation_net.run_from_checkpoint(ckpt, samples, sample_rate, seed=seed)
