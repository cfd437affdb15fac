"""track_analyser_tpu — an accelerator-native audio track analysis framework.

Capability superset of the reference track-analyser: the same public API
(``analyse_track``, ``TrackAnalysisResult``, per-module ``analyse_*``
functions and result dataclasses, CLI, report artefacts) re-designed for
JAX / XLA / pjit on an accelerator, plus batched multi-device library analysis
(parallel/batch.py).
"""

from __future__ import annotations

from importlib.metadata import PackageNotFoundError, version

from .pipeline import TrackAnalysisResult, analyse_track

__all__ = ["analyse_track", "TrackAnalysisResult", "get_version"]


def get_version() -> str:
    """Installed package version; "0.0.0" from a source checkout."""

    try:
        return version("track-analyser-tpu")
    except PackageNotFoundError:
        return "0.0.0"
