"""Smoke test of the analysis path on one NVIDIA GPU, at real size.

Runs the system through the entry points a user calls and checks what
comes out. The phases, each printing its own lines:

1. device   — the platform must be ``gpu``; prints the card, its power
               limit and which optional packages import.
2. main     — 8 synthetic stereo tracks of 96-181 s; one written to FLAC
               and one to WAV and analysed from the file with artefacts;
               ``analyse_library(device_batch=4)`` over all 8; one track
               with stems (the separation network).
3. agree    — the fused path against the plain per-module path
               (``fused=False``, float32 samples) on all 8 tracks and
               both files, with float32 and with the default transport.
               Gated: the measurements of the accuracy contract on both
               transports, and the beat grid on float32. Printed beside
               them: every decision difference (see ``phase_agree``).
4. kernels  — the HPSS median (exact against scipy), the STFT, the
               K-weighting, true-peak oversampling and the mel and chroma
               filterbanks against host float64 references at real width.
5. times    — per-phase wall time, compile time and the memory analysis
               of the batch-4 executable.

Any failed check ends the run with a non-zero exit. The last line of a
passing run is one JSON object naming the device.

``--multi`` runs only the paths that span devices (needs 4 GPUs):
``analyse_library`` over a 4-device mesh against a one-device mesh, and
``analyse_track_sharded`` of a 20 min track on a 4-device ``seq`` mesh
against the fused one-device result.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DURATIONS = (181.0, 181.0, 136.0, 136.0, 96.0, 96.0, 166.0, 116.0)
BPMS = (118.0, 125.0, 111.0, 132.0, 96.0, 104.0, 122.0, 99.0)
SR = 44_100
LONG_S = 1200.0  # the --multi sharded track

# The accuracy contract between the fused and the plain path.
TOL_BPM = 0.1
TOL_BEAT_S = 0.005
TOL_LUFS = 0.3
TOL_PEAK_DB = 0.2
TOL_BOUNDARY_S = 0.5
MIN_CHORD_RECALL = 0.7
CHORD_MATCH_S = 0.25


class PhaseFailed(SystemExit):
    def __init__(self, phase: str, failures: list) -> None:
        for msg in failures:
            print(f"[{phase}] FAIL {msg}")
        super().__init__(1)


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---- phase 1 -----------------------------------------------------------------


def phase_device(args) -> dict:
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"[device] FAIL platform is {platform!r}, not 'gpu'", file=sys.stderr)
        raise SystemExit(2)
    need = 4 if args.multi else 1
    if len(devs) < need:
        print(f"[device] FAIL {len(devs)} device(s), need {need}", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, str(ROOT))
    from bench import _card
    from track_analyser_tpu.utils import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    info = {
        "platform": platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": _card(),
    }
    _log("device", f"platform={platform} kind={info['kind']} count={info['count']} jax={jax.__version__}")
    _log("device", f"nvidia-smi: {info['card']}")
    for mod in ("pandas", "matplotlib", "click", "rich"):
        _log("device", f"import {mod}: {'yes' if importlib.util.find_spec(mod) else 'no'}")
    return info


# ---- shared helpers ------------------------------------------------------------


def _tracks():
    from bench import make_track

    return [make_track(d, bpm=b, seed=i) for i, (d, b) in enumerate(zip(DURATIONS, BPMS))]


def _agreement(fused, plain) -> tuple[list, list]:
    """Contract violations of ``fused`` against the plain result, as
    (measurements, decisions).

    Measurements: BPM, loudness, true peak, key, chord-change recall and
    the downbeat source. Decisions: the beat grid (same count, every
    beat within 5 ms), the section boundaries (same count, every one
    within 0.5 s) and the downbeats (same count, every one within the
    5 ms of the grid they are picked from).
    """

    bad = []
    if abs(fused.beat.bpm - plain.beat.bpm) > TOL_BPM:
        bad.append(f"bpm {fused.beat.bpm:.3f} vs {plain.beat.bpm:.3f}")
    if abs(fused.loudness.integrated_lufs - plain.loudness.integrated_lufs) > TOL_LUFS:
        bad.append(f"lufs {fused.loudness.integrated_lufs:.3f} vs {plain.loudness.integrated_lufs:.3f}")
    if abs(fused.loudness.true_peak_dbfs - plain.loudness.true_peak_dbfs) > TOL_PEAK_DB:
        bad.append(f"true peak {fused.loudness.true_peak_dbfs:.3f} vs {plain.loudness.true_peak_dbfs:.3f}")
    if fused.harmonic.primary_key.key != plain.harmonic.primary_key.key:
        bad.append(f"key {fused.harmonic.primary_key.key} vs {plain.harmonic.primary_key.key}")
    fc = np.array([p.time for p in fused.harmonic.chord_change_points])
    pc = np.array([p.time for p in plain.harmonic.chord_change_points])
    if pc.size:
        recall = 0.0 if not fc.size else float(np.mean(np.abs(pc[:, None] - fc[None, :]).min(axis=1) <= CHORD_MATCH_S))
        if recall < MIN_CHORD_RECALL:
            bad.append(f"chord-change recall {recall:.2f}")
    fd, pd_ = fused.downbeat, plain.downbeat
    if (fd is None) != (pd_ is None):
        bad.append("downbeat present on one path only")
    elif fd is not None and fd.source != pd_.source:
        bad.append(f"downbeat source {fd.source} vs {pd_.source}")

    moved = []
    for name, f, p, tol in (
        ("beat", fused.beat.beat_times, plain.beat.beat_times, TOL_BEAT_S),
        ("boundary", _boundaries(fused), _boundaries(plain), TOL_BOUNDARY_S),
        ("downbeat", _downbeats(fused), _downbeats(plain), TOL_BEAT_S),
    ):
        f, p = np.asarray(f), np.asarray(p)
        if f.shape != p.shape:
            moved.append(f"{name} count {f.size} vs {p.size}")
        elif f.size and np.max(np.abs(f - p)) > tol:
            over = int(np.sum(np.abs(f - p) > tol))
            moved.append(f"{name} max diff {np.max(np.abs(f - p)):.4f} s ({over} of {f.size} over {tol} s)")
    return bad, moved


def _gated(fused, ref) -> tuple[list, list]:
    """(gated failures, decision differences) for two float32 runs:
    the measurements and the beat grid are gated."""

    bad, moved = _agreement(fused, ref)
    return bad + [m for m in moved if m.startswith("beat ")], moved


def _boundaries(result) -> np.ndarray:
    return np.array([s.start for s in result.structure.segments[1:]])


def _downbeats(result) -> np.ndarray:
    return np.asarray(result.downbeat.downbeat_times if result.downbeat else [])


def _summary(r) -> str:
    return (
        f"bpm={r.beat.bpm:.3f} key={r.harmonic.primary_key.key} "
        f"lufs={r.loudness.integrated_lufs:.3f} tp={r.loudness.true_peak_dbfs:.3f} "
        f"segments={len(r.structure.segments)} downbeat={r.downbeat.source if r.downbeat else None}"
    )


# ---- phase 2 -----------------------------------------------------------------


ARTEFACTS = ("report.json", "beats.csv", "sections.csv", "report.html", "hook.mid", "bass.mid")


def phase_main(tracks, workdir: Path) -> dict:
    from track_analyser_tpu.io.codecs import write_wav
    from track_analyser_tpu.io.flac import encode_flac
    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.pipeline import TrackAnalysisResult, analyse_track

    failures = []
    files = {"flac": workdir / "track0.flac", "wav": workdir / "track2.wav"}
    encode_flac(files["flac"], tracks[0].stereo_samples, SR)
    write_wav(files["wav"], tracks[2].stereo_samples, SR)
    plots = importlib.util.find_spec("matplotlib") is not None

    file_results = {}
    for kind, path in files.items():
        out_dir = workdir / f"out_{kind}"
        t0 = time.perf_counter()
        res = analyse_track(str(path), output_dir=out_dir)
        _log("main", f"analyse_track({kind}) {time.perf_counter() - t0:.3f} s: {_summary(res)}")
        missing = [a for a in ARTEFACTS if not (out_dir / a).is_file()]
        pngs = sorted(p.name for p in out_dir.glob("*.png"))
        if missing:
            failures.append(f"{kind}: missing artefacts {missing}")
        if plots and not pngs:
            failures.append(f"{kind}: matplotlib installed but no plots written")
        _log("main", f"{kind} artefacts ok={not missing} plots={len(pngs)} (matplotlib {'present' if plots else 'absent'})")
        file_results[kind] = res

    t0 = time.perf_counter()
    lib = analyse_library(tracks, device_batch=4)
    wall = time.perf_counter() - t0
    _log("main", f"analyse_library(8 tracks, device_batch=4) first call {wall:.3f} s (includes compile)")
    t0 = time.perf_counter()
    lib = analyse_library(tracks, device_batch=4)
    wall = time.perf_counter() - t0
    audio_s = sum(len(t.samples) for t in tracks) / SR
    _log("main", f"analyse_library(8 tracks, device_batch=4) warm {wall:.3f} s for {audio_s:.1f} s of audio")
    for i, r in enumerate(lib):
        if not isinstance(r, TrackAnalysisResult):
            failures.append(f"library track {i}: {r}")
        else:
            _log("main", f"library track {i} ({DURATIONS[i]:.0f} s): {_summary(r)}")

    t0 = time.perf_counter()
    stem_res = analyse_track(str(files["flac"]), output_dir=workdir / "out_stems", use_stems=True)
    bundle = stem_res.stems
    _log("main", f"analyse_track(use_stems=True) {time.perf_counter() - t0:.3f} s: "
         f"model={bundle.model_name if bundle else None}")
    if bundle is None:
        failures.append("stems: no stem bundle")
    else:
        if bundle.model_name == "hpss-dsp-v1":
            failures.append("stems: the separation network did not run (DSP fallback)")
        absent = [n for n, p in bundle.stems.items() if not Path(p).is_file()]
        if len(bundle.stems) != 4 or absent:
            failures.append(f"stems: {sorted(bundle.stems)} missing files {absent}")
    if failures:
        raise PhaseFailed("main", failures)
    return {"files": files, "file_results": file_results, "library": lib}


# ---- phase 3 -----------------------------------------------------------------


def phase_agree(tracks, main: dict) -> None:
    """The fused path against the plain path on every track and file.

    Gated: the measurements of the accuracy contract with float32 and
    with the default transport, and the beat grid with float32. Section
    boundaries and downbeats, and the default transport's beat grid,
    are printed with every difference and counted, not gated: on this
    generator fused and plain place them differently on the CPU too and
    with every matmul at HIGHEST, and -120 dBFS of added noise moves the
    boundaries on either path (PERF.md, Findings).
    """

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.pipeline import analyse_track

    failures = []
    exact = analyse_library(tracks, device_batch=4, transport="float32")
    exact += [analyse_track(str(p), transport="float32") for p in main["files"].values()]
    default = list(main["library"]) + [main["file_results"][k] for k in main["files"]]
    sources = list(tracks) + [str(p) for p in main["files"].values()]
    labels = [f"track {i}" for i in range(len(tracks))] + [f"file {k}" for k in main["files"]]
    held = {"float32": 0, "default": 0}
    for label, source, fused_exact, fused_default in zip(labels, sources, exact, default):
        t0 = time.perf_counter()
        plain = analyse_track(source, fused=False)
        took = time.perf_counter() - t0
        for name, fused, check in (("float32", fused_exact, _gated), ("default", fused_default, _agreement)):
            bad, moved = check(fused, plain)
            held[name] += not moved
            _log("agree", f"{label} fused {name} vs plain: "
                 f"bpm diff {abs(fused.beat.bpm - plain.beat.bpm):.4f}, "
                 f"lufs diff {abs(fused.loudness.integrated_lufs - plain.loudness.integrated_lufs):.4f}, "
                 f"tp diff {abs(fused.loudness.true_peak_dbfs - plain.loudness.true_peak_dbfs):.4f} "
                 f"-> gated checks {'ok' if not bad else 'FAIL'}; "
                 f"decisions: {'; '.join(moved) or 'within the contract'}")
            failures += [f"{label} fused {name}: {b}" for b in bad]
        _log("agree", f"{label}: plain path {took:.3f} s")
    for name, n in held.items():
        _log("agree", f"fused {name}: every decision within the contract on {n} of {len(labels)} inputs")
    if failures:
        raise PhaseFailed("agree", failures)


# ---- phase 4 -----------------------------------------------------------------


def phase_kernels(tracks) -> None:
    import jax
    import jax.numpy as jnp
    from scipy import ndimage, signal

    from track_analyser_tpu.config import DEFAULT_CONFIG as cfg
    from track_analyser_tpu.ops.chroma import chroma_from_power, chroma_stft_filterbank
    from track_analyser_tpu.ops.filters import median_filter_1d
    from track_analyser_tpu.ops.loudness import k_weighted, k_weighting_fir
    from track_analyser_tpu.ops.mel import mel_filterbank, melspectrogram_from_power
    from track_analyser_tpu.ops.resample import oversampled_peak, polyphase_filter
    from track_analyser_tpu.ops.stft import hann_window, magnitude

    failures = []

    def report(name, err, tol, precision):
        ok = err <= tol
        _log("kernels", f"{name}: error {err:.3g} tolerance {tol:.3g} precision {precision} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}: error {err:.3g} > {tol:.3g}")

    n_min = min(len(t.samples) for t in tracks[:4])
    ys = jnp.asarray(np.stack([t.samples[:n_min] for t in tracks[:4]]))
    mags = jax.jit(jax.vmap(lambda y: magnitude(y, cfg.n_fft, cfg.hop_length)))(ys)
    _log("kernels", f"spectrogram batch {tuple(mags.shape)}")
    # jnp.pad "reflect" (d c b | a b c d) is scipy.ndimage's "mirror" mode.
    for axis in (-1, -2):
        med = jax.jit(jax.vmap(lambda s, a=axis: median_filter_1d(s, cfg.hpss_kernel, axis=a)))
        got = np.asarray(med(mags))
        size = [1, 1]
        size[axis] = cfg.hpss_kernel
        for lane in (0, 3):
            want = ndimage.median_filter(np.asarray(mags[lane]), size=tuple(size), mode="mirror")
            report(f"median axis={axis} batched lane {lane} vs scipy", float(np.max(np.abs(got[lane] - want))), 0.0, "exact")

    y = np.asarray(tracks[0].samples, dtype=np.float32)
    yd = jnp.asarray(y)
    # Host float64 reference: centred, zero-padded frames (first 4000).
    half = cfg.n_fft // 2
    padded = np.pad(y.astype(np.float64), (half, half))
    frames = np.lib.stride_tricks.sliding_window_view(padded, cfg.n_fft)[:: cfg.hop_length][:4_000]
    want = np.abs(np.fft.rfft(frames * hann_window(cfg.n_fft).astype(np.float64), axis=-1)).T
    got = np.asarray(jax.jit(lambda v: magnitude(v, cfg.n_fft, cfg.hop_length))(yd))[:, : want.shape[1]]
    report("stft |rfft| rel vs float64", float(np.max(np.abs(got - want)) / np.max(want)), 1e-5, "float32 FFT")

    h = k_weighting_fir(SR).astype(np.float64)
    want = signal.fftconvolve(y.astype(np.float64), h)[: y.size]
    got = np.asarray(jax.jit(lambda v: k_weighted(v, SR))(yd))
    report("k-weighting abs vs float64", float(np.max(np.abs(got - want))), 1e-5, "float32 FFT")

    up = cfg.true_peak_oversample
    taps = polyphase_filter(up, 1)
    half = (taps.size - 1) // 2
    full = signal.upfirdn(taps, y.astype(np.float64), up)
    want = float(np.max(np.abs(full[half : half + y.size * up])))
    got = float(jax.jit(lambda v: oversampled_peak(v, up))(yd))
    report("true peak dB vs float64", abs(20 * np.log10(got) - 20 * np.log10(want)), 1e-3, "HIGHEST")

    power = np.asarray(mags[0]) ** 2
    for name, fb, fn in (
        ("mel filterbank", mel_filterbank(SR, cfg.n_fft, cfg.n_mels), lambda p, f: melspectrogram_from_power(p, f)),
        ("chroma filterbank", chroma_stft_filterbank(SR, cfg.n_fft), None),
    ):
        if fn is None:
            got = np.asarray(jax.jit(lambda p: chroma_from_power(p, fb))(jnp.asarray(power)))
            raw = fb.astype(np.float64) @ power.astype(np.float64)
            want = raw / np.where(np.max(np.abs(raw), axis=0) > 0, np.max(np.abs(raw), axis=0), 1.0)
            err = float(np.max(np.abs(got - want)))
        else:
            got = np.asarray(jax.jit(lambda p: fn(p, fb))(jnp.asarray(power)))
            want = fb.astype(np.float64) @ power.astype(np.float64)
            err = float(np.max(np.abs(got - want)) / np.max(want))
        report(f"{name} rel vs float64", err, 1e-5, "HIGHEST")
    if failures:
        raise PhaseFailed("kernels", failures)


# ---- phase 5 -----------------------------------------------------------------


def phase_times(tracks, info: dict, times: dict, compiles: list) -> None:
    import jax

    from track_analyser_tpu.parallel import batch

    # The executable the sweep runs: every chunk at its full size (the
    # staged payload of one track ships its last chunk short).
    n_bucket = batch.ms_bucket_length(len(tracks[0].samples))
    parts, _host, _n = batch._stage_payload_ms(tracks[0], n_bucket)
    chunks = [batch._ms_payload_bytes(s, e, 8) for s, e in batch._ms_chunk_ranges(n_bucket)]
    spec = tuple(jax.ShapeDtypeStruct((4, end - start), p.dtype) for (start, end), p in zip(chunks, parts))
    spec += (jax.ShapeDtypeStruct((4,) + tuple(parts[-1].shape), parts[-1].dtype),)
    nv = jax.ShapeDtypeStruct((4,), np.int32)
    t0 = time.perf_counter()
    compiled = batch._batched_graph_ms.lower(spec, nv, sr=SR).compile()
    mem = compiled.memory_analysis()
    _log("times", f"batch-4 executable ({n_bucket} samples per lane) lower+compile {time.perf_counter() - t0:.3f} s")
    for field in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "generated_code_size_in_bytes"):
        _log("times", f"batch-4 memory_analysis {field} = {getattr(mem, field, 'n/a')}")
    card = f"{info['kind']} ({info['card']})"
    for phase, secs in times.items():
        _log("times", f"phase {phase}: {secs:.3f} s wall on {card}")
    _log("times", f"backend compiles: {len(compiles)}, {sum(compiles):.3f} s total on {card}")


# ---- --multi -----------------------------------------------------------------


def phase_multi(tracks) -> None:
    """The library over a 4-device mesh against a one-device mesh, and
    the sharded long track against the fused one-device result; gated
    as the float32 comparison of ``phase_agree``."""

    import jax

    from bench import make_track
    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.parallel.mesh import make_mesh
    from track_analyser_tpu.parallel.sharded import analyse_track_sharded
    from track_analyser_tpu.pipeline import TrackAnalysisResult, analyse_track

    failures = []
    devs = jax.devices()[:4]
    t0 = time.perf_counter()
    one = analyse_library(tracks, mesh=make_mesh(devices=devs[:1]), device_batch=4)
    _log("multi", f"analyse_library one-device mesh {time.perf_counter() - t0:.3f} s (includes compile)")
    t0 = time.perf_counter()
    four = analyse_library(tracks, mesh=make_mesh(devices=devs), device_batch=1)
    _log("multi", f"analyse_library 4-device mesh {time.perf_counter() - t0:.3f} s (includes compile)")
    for i, (a, b) in enumerate(zip(four, one)):
        if not (isinstance(a, TrackAnalysisResult) and isinstance(b, TrackAnalysisResult)):
            failures.append(f"library track {i}: {a} / {b}")
            continue
        bad, moved = _gated(a, b)
        _log("multi", f"library track {i}: bpm {a.beat.bpm:.3f}/{b.beat.bpm:.3f} key {a.harmonic.primary_key.key} "
             f"-> gated checks {'ok' if not bad else 'FAIL'}; decisions: {'; '.join(moved) or 'within the contract'}")
        failures += [f"library track {i}: {x}" for x in bad]

    long_track = make_track(LONG_S, bpm=124.0, seed=11)
    t0 = time.perf_counter()
    ref = analyse_track(long_track, transport="float32")
    _log("multi", f"fused one-device {LONG_S:.0f} s track {time.perf_counter() - t0:.3f} s: {_summary(ref)}")
    t0 = time.perf_counter()
    sharded = analyse_track_sharded(long_track, make_mesh((4,), ("seq",), devices=devs))
    _log("multi", f"analyse_track_sharded 4-device seq mesh {time.perf_counter() - t0:.3f} s: {_summary(sharded)}")
    bad, moved = _gated(sharded, ref)
    _log("multi", f"sharded vs fused -> gated checks {'ok' if not bad else 'FAIL'}; "
         f"decisions: {'; '.join(moved) or 'within the contract'}")
    failures += [f"sharded: {x}" for x in bad]
    if failures:
        raise PhaseFailed("multi", failures)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true", help="only the 4-device paths")
    args = parser.parse_args()

    t_start = time.perf_counter()
    info = phase_device(args)
    import jax.monitoring

    compiles: list = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **_: compiles.append(secs)
        if name == "/jax/core/compile/backend_compile_duration"
        else None
    )
    tracks = _tracks()
    times = {"device+synthesis": time.perf_counter() - t_start}

    def run(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        times[name] = time.perf_counter() - t0
        return out

    if args.multi:
        run("multi", phase_multi, tracks)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            main_out = run("main", phase_main, tracks, Path(tmp))
            run("agree", phase_agree, tracks, main_out)
        run("kernels", phase_kernels, tracks)
        phase_times(tracks, info, times, compiles)
    _log("times", f"total {time.perf_counter() - t_start:.3f} s")
    print(f"card: {info['card']}")
    print(json.dumps({"ok": True, "device": {k: info[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
