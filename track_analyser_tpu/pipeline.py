"""High level orchestration for audio track analysis.

API parity with the reference (pipeline.py:17-120): ``analyse_track`` with
the same signature, the same ``TrackAnalysisResult`` fields, and the same
progress-callback stage names (audio, beats, structure, loudness, harmonic,
features, stereo, stems, render).

Difference: the onset envelope / autocorrelation substrate is
computed ONCE and shared between BPM estimation and grid fitting (the
reference re-runs the mel STFT three times — pipeline.py:61-62 plus
tempo.py:140-141), and every module's heavy math is a jitted XLA graph.
For batched, multi-chip throughput over track libraries see
parallel/batch.py (``analyse_library``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import features, harmony, stereo, tempo
from .analysis import beats, loudness, stems, structure
from .config import DEFAULT_SEED
from .utils import AudioInput, coerce_audio

__all__ = ["TrackAnalysisResult", "analyse_track"]


@dataclass
class TrackAnalysisResult:
    """Container aggregating all per-module analysis artefacts."""

    audio: AudioInput
    beat: beats.BeatAnalysis
    downbeat: Optional[beats.DownbeatAnalysis]
    structure: structure.StructureAnalysis
    loudness: loudness.LoudnessAnalysis
    harmonic: harmony.HarmonyAnalysis
    features: features.FeatureAnalysis
    stereo: stereo.StereoAnalysis
    stems: Optional[stems.StemBundle] = None


def _beat_stage(audio: AudioInput) -> tuple[beats.BeatAnalysis, float]:
    """Compute the beat grid with a single envelope/autocorrelation pass."""

    y = np.asarray(audio.samples, dtype=np.float32)
    sr = audio.sample_rate
    hop = tempo.DEFAULT_HOP_LENGTH

    env, ac = tempo._envelope_and_autocorr(y, sr, hop)
    grid, bpm = tempo.grid_and_bpm_from_env(env, ac, len(y) / float(sr), sr, hop_length=hop)
    beat_result = beats.build_beat_analysis(
        bpm, grid["time"].to_numpy(), sr, hop_length=hop, grid=grid,
        tracked_times=beats.tracked_times_for(audio, env, bpm, hop_length=hop),
    )
    return beat_result, bpm


def analyse_track(
    source: "str | AudioInput",
    *,
    output_dir: "Optional[str | Path]" = None,
    use_stems: bool = False,
    seed: int = DEFAULT_SEED,
    progress_callback: Optional[Callable[[str], None]] = None,
    fused: bool = True,
    transport: str = "auto",
) -> TrackAnalysisResult:
    """Run the deterministic analysis pipeline on ``source``.

    Parameters mirror the reference exactly (pipeline.py:32-55): ``source``
    is a file path or preloaded :class:`AudioInput`; ``output_dir`` triggers
    artefact rendering; ``use_stems`` enables stem separation; ``seed``
    drives every deterministic component.

    ``fused=True`` (default) runs all device work as ONE XLA dispatch
    through the shared substrate (substrate.py); ``fused=False`` runs the
    per-module graphs (identical results, more dispatches).

    ``transport`` picks the fused path's host->device representation
    ("auto" = blockwise mid/side; "int16"/"int8"/"float32" for
    bit-critical work — see parallel/batch.analyse_track_fused).
    """

    audio = source if isinstance(source, AudioInput) else coerce_audio(source)
    if progress_callback:
        progress_callback("audio")

    if fused:
        return _analyse_track_fused_path(
            audio,
            output_dir=output_dir,
            use_stems=use_stems,
            seed=seed,
            progress_callback=progress_callback,
            transport=transport,
        )

    beat_result, _bpm = _beat_stage(audio)
    downbeat_result = beats.analyse_downbeats(audio, beat_result, seed=seed)
    if progress_callback:
        progress_callback("beats")

    structure_result = structure.analyse_structure(audio, beat_result, seed=seed)
    if progress_callback:
        progress_callback("structure")

    loudness_result = loudness.analyse_loudness(audio, seed=seed)
    if progress_callback:
        progress_callback("loudness")

    harmonic_result = harmony.analyse_harmony(
        audio, beat_result, downbeat_result, seed=seed
    )
    if progress_callback:
        progress_callback("harmonic")

    feature_result = features.analyse_features(audio)
    if progress_callback:
        progress_callback("features")

    stereo_result = stereo.analyse_stereo(audio)
    if progress_callback:
        progress_callback("stereo")

    stem_result: Optional[stems.StemBundle] = None
    if use_stems:
        stem_result = stems.separate_stems(audio.path, output_dir, seed=seed)
        if progress_callback:
            progress_callback("stems")

    result = TrackAnalysisResult(
        audio=audio,
        beat=beat_result,
        downbeat=downbeat_result,
        structure=structure_result,
        loudness=loudness_result,
        harmonic=harmonic_result,
        features=feature_result,
        stereo=stereo_result,
        stems=stem_result,
    )

    if output_dir is not None:
        from .rendering import outputs  # local import to avoid a circular dep

        outputs.render_all(result, Path(output_dir))
        if progress_callback:
            progress_callback("render")

    return result


def _analyse_track_fused_path(
    audio: AudioInput,
    *,
    output_dir: "Optional[str | Path]",
    use_stems: bool,
    seed: int,
    progress_callback: Optional[Callable[[str], None]],
    transport: str = "auto",
) -> TrackAnalysisResult:
    """Single-dispatch path: one fused graph, then host finishers.

    The stage callbacks fire in the reference's order (pipeline.py:57-99)
    after the corresponding host finisher completes.
    """

    from .parallel import batch  # local import to avoid a circular dep

    result = batch.analyse_track_fused(audio, seed=seed, transport=transport)
    if progress_callback:
        for stage in ("beats", "structure", "loudness", "harmonic", "features", "stereo"):
            progress_callback(stage)

    if use_stems:
        result.stems = stems.separate_stems(audio.path, output_dir, seed=seed)
        if progress_callback:
            progress_callback("stems")

    if output_dir is not None:
        from .rendering import outputs

        outputs.render_all(result, Path(output_dir))
        if progress_callback:
            progress_callback("render")

    return result
