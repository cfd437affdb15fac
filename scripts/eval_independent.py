"""Out-of-family validation on the INDEPENDENT rendering engine.

Everything this repo's models were trained and gated on flows from one
author's DSP vocabulary (tests/synth.py, models/downbeat_net.py,
models/training.py). This script measures the production pipeline on a
song rendered by ``scripts/independent_engine.py`` — wavetable
oscillators, linear ADSR envelopes, biquad-resonator drums, formant-
filtered pulse vocals, Schroeder reverb; zero shared code with the
training generators (tests/test_independent_eval.py asserts the import
graph) — and prints the RUNBOOK table:

  * downbeat F1 (±70 ms) against the known bar starts,
  * DP-tracked beat F1 (±70 ms) against the known beat times,
  * per-stem SI-SDR of the served separation, and its improvement over
    using the raw mixture as the estimate.

Run on the CPU or the GPU: ``python scripts/eval_independent.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from independent_engine import render_song  # noqa: E402


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    ref = ref - ref.mean()
    est = est - est.mean()
    denom = float(np.dot(ref, ref)) + 1e-12
    proj = (float(np.dot(est, ref)) / denom) * ref
    noise = est - proj
    return float(
        10.0 * np.log10((np.dot(proj, proj) + 1e-12) / (np.dot(noise, noise) + 1e-12))
    )


def f1_within(pred: np.ndarray, truth: np.ndarray, tol: float = 0.070) -> float:
    if pred.size == 0 or truth.size == 0:
        return 0.0
    hits_p = (np.abs(pred[:, None] - truth[None, :]).min(axis=1) <= tol).sum()
    hits_t = (np.abs(pred[:, None] - truth[None, :]).min(axis=0) <= tol).sum()
    precision = hits_p / pred.size
    recall = hits_t / truth.size
    return 0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall)


def main() -> None:
    sr = 22_050
    stems_true, mix, beat_times, bar_starts = render_song(sr=sr)

    from track_analyser_tpu.analysis.stems import separate_stems_arrays
    from track_analyser_tpu.parallel.batch import analyse_track_fused
    from track_analyser_tpu.utils import AudioInput

    result = analyse_track_fused(AudioInput(samples=mix, sample_rate=sr))

    db = np.asarray(result.downbeat.downbeat_times)
    tracked = np.asarray(result.beat.tracked_times or [])
    db_f1 = f1_within(db, bar_starts)
    beat_f1 = f1_within(tracked, beat_times)
    print(f"bpm={result.beat.bpm:.2f} key={result.harmonic.primary_key.key} "
          f"downbeat_source={result.downbeat.source}")
    print(f"downbeat F1 (±70 ms vs bar starts): {db_f1:.3f}  "
          f"({db.size} predicted / {bar_starts.size} true)")
    print(f"tracked-beat F1 (±70 ms vs beats):  {beat_f1:.3f}  "
          f"({tracked.size} predicted / {beat_times.size} true)")

    est = separate_stems_arrays(mix, sr)
    print("\nstem      SI-SDR(est)   SI-SDR(mix)   delta")
    for name in ("drums", "bass", "other", "vocals"):
        ref = stems_true[name]
        s_est = si_sdr(np.asarray(est[name], dtype=np.float64), ref.astype(np.float64))
        s_mix = si_sdr(mix.astype(np.float64), ref.astype(np.float64))
        print(f"{name:8s}  {s_est:10.2f}  {s_mix:11.2f}  {s_est - s_mix:+6.2f}")


if __name__ == "__main__":
    main()
