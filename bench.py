"""Benchmark: full analysis of a mixed-duration stereo track library on
one GPU.

Sweeps EIGHT tracks of five distinct durations (96-181 s; identical
copies would hide retrace and aliasing bugs) through ``analyse_library``
and normalises the best sweep to 180 s of audio per track. Also times
single-track latency. Fails unless JAX runs on a GPU. Prints the device
and the card's power limit on stderr, and ONE JSON line on stdout:
  {"metric": ..., "value": ms_per_180s_track, "unit": "ms", ...}
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))


def make_track(seconds: float, sr: int = 44_100, bpm: float = 126.0, seed: int = 7):
    """Synthesise a club-style stereo track: kick grid + bass + chords + hats."""

    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(seed)

    beat = 60.0 / bpm
    kick = np.zeros(n)
    hat = np.zeros(n)
    for i, b in enumerate(np.arange(0.0, seconds, beat)):
        s = int(b * sr)
        e = min(n, s + int(0.08 * sr))
        seg = np.arange(e - s) / sr
        kick[s:e] += np.sin(2 * np.pi * (60 + 40 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 30)
        hs = int((b + beat / 2) * sr)
        he = min(n, hs + int(0.02 * sr))
        if he > hs:
            hat[hs:he] += rng.normal(0, 0.15, he - hs) * np.exp(-np.arange(he - hs) / (0.004 * sr))
    bass = 0.2 * np.sin(2 * np.pi * 55.0 * t) * (np.sin(2 * np.pi * t / 8.0) > 0)
    chords = 0.1 * (
        np.sin(2 * np.pi * 220.0 * t) + np.sin(2 * np.pi * 277.18 * t) + np.sin(2 * np.pi * 329.63 * t)
    )
    left = 0.8 * kick + bass + chords + 0.6 * hat
    right = 0.8 * kick + bass + 0.9 * chords + 0.5 * hat
    peak = max(np.abs(left).max(), np.abs(right).max())
    left, right = left / peak * 0.9, right / peak * 0.9
    stereo = np.stack([left, right]).astype(np.float32)

    from track_analyser_tpu.utils import AudioInput

    return AudioInput(samples=stereo.mean(axis=0), sample_rate=sr, stereo_samples=stereo)


def _make_sparse_minor(seconds: float = 96.0, sr: int = 44_100, bpm: float = 96.0):
    """Second warmup-assert fixture: A-minor pads with SPARSE percussion
    (soft kick every other beat) — the near-tie class the round-3 key
    sawtooth hid in (bass-heavy minor content, weak onsets). Ground
    truth pinned on the gate-green CPU path."""

    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    beat = 60.0 / bpm

    def _triad(root_hz: float, third: float, fifth: float):
        return (
            np.sin(2 * np.pi * root_hz * t)
            + 0.8 * np.sin(2 * np.pi * root_hz * third * t)
            + 0.7 * np.sin(2 * np.pi * root_hz * fifth * t)
        )

    minor3, p5 = 2 ** (3 / 12), 2 ** (7 / 12)
    bar = 8 * beat
    phase = (t % (4 * bar)) / bar  # Am -> Dm -> Em -> Am, two bars each
    pads = np.where(
        phase < 1.0,
        _triad(110.0, minor3, p5),  # A minor
        np.where(
            phase < 2.0,
            _triad(146.83, minor3, p5),  # D minor
            np.where(phase < 3.0, _triad(164.81, minor3, p5), _triad(110.0, minor3, p5)),
        ),
    )
    kick = np.zeros(n)
    for i, b in enumerate(np.arange(0.0, seconds, beat)):
        if i % 2:
            continue
        s = int(b * sr)
        e = min(n, s + int(0.04 * sr))
        seg = np.arange(e - s) / sr
        kick[s:e] += 0.5 * np.sin(2 * np.pi * (55 + 45 * np.exp(-seg * 70)) * seg) * np.exp(-seg * 45)
    left = 0.35 * pads + kick
    right = 0.3 * pads + kick
    peak = max(np.abs(left).max(), np.abs(right).max())
    stereo = np.stack([left / peak * 0.9, right / peak * 0.9]).astype(np.float32)

    from track_analyser_tpu.utils import AudioInput

    return AudioInput(samples=stereo.mean(axis=0), sample_rate=sr, stereo_samples=stereo)


def _card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""

    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
            check=False,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "not reported"


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"[bench] needs a GPU; JAX found {dev.platform!r}")
    card = _card()
    print(
        f"[bench] device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; card: {card}",
        file=sys.stderr,
    )

    from track_analyser_tpu.parallel.batch import analyse_library, analyse_track_fused
    from track_analyser_tpu.utils import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()

    compile_log: list = []

    import jax.monitoring as _mon

    def _compile_listener(name: str, duration: float, **kw) -> None:
        if name == "/jax/core/compile/backend_compile_duration":
            compile_log.append(duration)

    _mon.register_event_duration_secs_listener(_compile_listener)

    # Build the native host kernels (codec fast paths, host quantisers)
    # once up front; the numpy fallbacks give identical results.
    try:
        from track_analyser_tpu.native.build import build as build_native

        build_native(verbose=False)
    except Exception:
        pass

    # Five distinct durations; 8 tracks fill two device_batch=4 groups of
    # one tier executable.
    durations = [181.0, 181.0, 136.0, 136.0, 96.0, 96.0, 166.0, 116.0]
    bpms = [118.0, 125.0, 111.0, 132.0, 96.0, 104.0, 122.0, 99.0]  # in-range tempos
    tracks = [
        make_track(secs, bpm=bpms[i], seed=i) for i, secs in enumerate(durations)
    ]
    total_audio_s = sum(durations)
    bench_transport = "ms5"
    bench_batch = 4

    # Warm-up: the sweep compiles the tier executable; the single-track
    # path shares it (device-side zero lanes, sliced off before readback).
    t0 = time.perf_counter()
    analyse_library(tracks, device_batch=bench_batch, transport=bench_transport)
    result = analyse_track_fused(tracks[0], transport=bench_transport, device_batch=bench_batch)
    warm = time.perf_counter() - t0
    print(
        f"[bench] warmup {warm:.3f} s ({len(compile_log)} compiles, "
        f"{sum(compile_log):.3f} s) — bpm={result.beat.bpm:.2f} "
        f"key={result.harmonic.primary_key.key} "
        f"lufs={result.loudness.integrated_lufs:.2f} "
        f"segments={len(result.structure.segments)}",
        file=sys.stderr,
    )

    # Accuracy gates on the warmup result — a device-side regression must
    # never ship under a green perf number (round-3 shipped a key flip
    # the bench printed but did not assert). Fixture ground truth:
    # 118 BPM kick grid, A-major triad chords over an A bass
    # (make_track), ~-19.3 LUFS measured on the gate-green CPU path.
    assert abs(result.beat.bpm - 118.0) <= 0.2, f"bpm={result.beat.bpm}"
    assert result.harmonic.primary_key.key == "A major", (
        f"key={result.harmonic.primary_key.key}"
    )
    assert abs(result.loudness.integrated_lufs - (-19.34)) <= 0.5, (
        f"lufs={result.loudness.integrated_lufs}"
    )
    # CPU ground truth for this 181 s fixture: 15 segments (8 s min
    # spacing bounds the count at ~22); a collapse to one segment or a
    # runaway pick would both trip this.
    assert 3 <= len(result.structure.segments) <= 22, (
        f"segments={len(result.structure.segments)}"
    )

    # Second asserted fixture (VERDICT r4 #8): A-minor pads with SPARSE
    # percussion — the near-tie class the round-3 filterbank sawtooth
    # hid in (bass-heavy minor content, weak onsets). A filterbank or
    # transport change that flips decisions this fixture class is
    # sensitive to must fail the bench even when the A-major fixture
    # happens to be robust. Shares the tier executable (96 s pads to the
    # same 4-chunk tier), so this costs one dispatch, zero compiles.
    result2 = analyse_track_fused(
        _make_sparse_minor(), transport=bench_transport, device_batch=bench_batch
    )
    print(
        f"[bench] minor-sparse fixture — bpm={result2.beat.bpm:.2f} "
        f"key={result2.harmonic.primary_key.key} "
        f"lufs={result2.loudness.integrated_lufs:.2f}",
        file=sys.stderr,
    )
    # CPU ground truth (float32 path): key "A minor", LUFS -13.61, and
    # bpm 97.50 — the true grid is 96.0 but sparse every-other-beat
    # percussion under pads sits outside the regression's envelope at
    # FLOAT too (+1.5 bias), so the pin is against the CPU path's own
    # estimate (the transport/graph must not move it), not truth.
    assert result2.harmonic.primary_key.key == "A minor", (
        f"key={result2.harmonic.primary_key.key}"
    )
    assert abs(result2.beat.bpm - 97.50) <= 0.3, f"bpm={result2.beat.bpm}"
    assert abs(result2.loudness.integrated_lufs - (-13.61)) <= 0.5, (
        f"lufs={result2.loudness.integrated_lufs}"
    )

    # Single-track latency (includes host quantise and upload).
    def _timed_single() -> float:
        t0 = time.perf_counter()
        analyse_track_fused(
            tracks[0], transport=bench_transport, device_batch=bench_batch
        )
        return time.perf_counter() - t0

    lat = [_timed_single() for _ in range(4)]
    print(
        f"[bench] single-track ({bench_transport}) latency ms: "
        f"{[round(x * 1e3, 3) for x in lat]} on {card}",
        file=sys.stderr,
    )

    # Headline: pipelined sweep over the mixed-duration library, best of
    # 5, normalised to 180 s per track.
    n_compiles = len(compile_log)
    sweeps = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = analyse_library(tracks, device_batch=bench_batch, transport=bench_transport)
        sweeps.append(time.perf_counter() - t0)
        assert len(out) == len(tracks)
        assert all(hasattr(r, "beat") for r in out), "sweep produced failures"
    elapsed = min(sweeps)
    ms = elapsed / (total_audio_s / 180.0) * 1e3
    print(
        f"[bench] library sweeps s: {[round(s, 3) for s in sweeps]} -> "
        f"{ms:.3f} ms per 180 s of audio pipelined on {card}",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "full_track_analysis_ms_per_180s_stereo_mixed_durations_pipelined",
                "value": round(ms, 3),
                "unit": "ms",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
                "transport": bench_transport,
                "device_batch": bench_batch,
                "warmup_s": round(warm, 3),
                "compile_count": n_compiles,
                "compile_s": round(sum(compile_log), 3),
                "compiles_in_timed_window": len(compile_log) - n_compiles,
                "single_track_ms_best": round(min(lat) * 1e3, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
