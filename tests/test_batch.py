"""Batched library analysis + batch CLI + stage-timer observability."""

from __future__ import annotations

import math
import pytest
import wave
from pathlib import Path

import numpy as np
from click.testing import CliRunner

from track_analyser_tpu.cli import cli


def _write_tone(path: Path, freq: float = 220.0, sr: int = 22_050, duration: float = 0.5) -> None:
    n = int(sr * duration)
    t = np.linspace(0.0, duration, n, endpoint=False)
    pcm = (0.25 * np.sin(2 * math.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(sr)
        handle.writeframes(pcm.tobytes())


def test_analyze_batch_cli(tmp_path) -> None:
    paths = []
    for i, f in enumerate((220.0, 440.0)):
        p = tmp_path / f"tone{i}.wav"
        _write_tone(p, f)
        paths.append(str(p))
    out = tmp_path / "lib"
    manifest = tmp_path / "manifest.jsonl"

    runner = CliRunner()
    result = runner.invoke(
        cli,
        ["analyze-batch", *paths, "--out", str(out), "--manifest", str(manifest)],
    )
    assert result.exit_code == 0, result.output
    for i in range(2):
        track_dir = out / f"tone{i}"
        assert (track_dir / "report.json").exists()
        assert (track_dir / "hook.mid").exists()
    assert len(manifest.read_text().splitlines()) == 2

    # Resume: nothing left to do, exits cleanly.
    result2 = runner.invoke(
        cli,
        ["analyze-batch", *paths, "--out", str(out), "--manifest", str(manifest)],
    )
    assert result2.exit_code == 0, result2.output
    assert len(manifest.read_text().splitlines()) == 2


def test_int8_transport_matches_int16_within_tolerances(tmp_path) -> None:
    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 44_100
    t = np.linspace(0, 3.0, 3 * sr, endpoint=False)
    y = 0.3 * np.sin(2 * math.pi * 220.0 * t)
    for b in np.arange(0, 3.0, 0.5):
        s = int(b * sr)
        e = min(y.size, s + 441)
        y[s:e] += np.exp(-np.linspace(0, 6, e - s))
    audio = AudioInput(samples=y.astype(np.float32), sample_rate=sr)

    r8 = analyse_library([audio], transport="int8")[0]
    r16 = analyse_library([audio], transport="int16")[0]

    # Tempo estimates on a 3 s snippet are fragile for BOTH transports;
    # the real +-0.1 BPM / 5 ms contract is asserted on the 128 s track in
    # test_tempo.py (and holds under int8 — see commit history). Here we
    # assert the energy/key metrics, which are transport-sensitive.
    assert r8.beat.bpm == pytest.approx(r16.beat.bpm, abs=1.5)
    # int8 distortion on a clean sine costs ~0.08 LU; the BS.1770 contract
    # is +-0.3 LU.
    assert r8.loudness.integrated_lufs == pytest.approx(
        r16.loudness.integrated_lufs, abs=0.15
    )
    assert r8.loudness.true_peak_dbfs == pytest.approx(
        r16.loudness.true_peak_dbfs, abs=0.1
    )
    assert r8.harmonic.primary_key.key == r16.harmonic.primary_key.key
    assert len(r8.structure.segments) == len(r16.structure.segments)


def test_library_mixed_durations_group_into_buckets(tmp_path) -> None:
    """Tracks of different lengths group into different padded buckets and
    all come back in input order."""

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 44_100
    tracks = []
    for seconds, freq in ((0.5, 220.0), (2.5, 330.0), (0.6, 440.0)):
        t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
        tracks.append(
            AudioInput(
                samples=(0.3 * np.sin(2 * math.pi * freq * t)).astype(np.float32),
                sample_rate=sr,
            )
        )
    results = analyse_library(tracks)
    assert len(results) == 3
    durations = [r.audio.duration for r in results]
    assert durations[0] == pytest.approx(0.5, abs=0.01)
    assert durations[1] == pytest.approx(2.5, abs=0.01)
    assert durations[2] == pytest.approx(0.6, abs=0.01)
    # LTAS peak tracks each tone
    for r, freq in zip(results, (220.0, 330.0, 440.0)):
        ltas = r.features.ltas
        peak = float(ltas.frequencies[np.argmax(ltas.magnitude)])
        assert peak == pytest.approx(freq, abs=22.0)


def test_int8_transport_holds_tempo_contract() -> None:
    """The +-0.1 BPM / 5 ms gates survive int8 transport quantisation."""

    import jax.numpy as jnp

    from synth import click_grid
    from track_analyser_tpu.parallel.batch import _I8_BLOCK, _dequantise_i8, _quantise_i8
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    sr = 48_000
    y, expected = click_grid(120.0, 32 * 4, sr, noise_db=-34.0, seed=1234)
    n_pad = -(-y.size // _I8_BLOCK) * _I8_BLOCK
    yp = np.zeros(n_pad, dtype=np.float32)
    yp[: y.size] = y
    vals, scales = _quantise_i8(np.stack([yp, yp]))
    yq = np.asarray(_dequantise_i8(jnp.asarray(vals), jnp.asarray(scales)))[0][: y.size]

    assert abs(estimate_bpm(yq, sr) - 120.0) <= 0.1
    grid = beat_grid(yq, sr)
    actual = grid["time"].to_numpy()[: expected.size]
    assert float(np.max(np.abs(actual - expected[: actual.size]))) <= 0.005


def test_library_mixes_mono_and_stereo_under_ms_transport() -> None:
    """Under the default "ms" transport every track ships a mid-only int8
    payload, so mono and stereo tracks share chunks and executables;
    order, per-track results and the host-exact stereo fields must
    survive the mix."""

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 44_100
    n = int(1.5 * sr)
    t = np.arange(n) / sr
    mono = AudioInput(
        samples=(0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32), sample_rate=sr
    )
    l = (0.4 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    r = (0.25 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    stereo = AudioInput(
        samples=0.5 * (l + r), sample_rate=sr, stereo_samples=np.stack([l, r])
    )

    results = analyse_library([mono, stereo, mono])
    assert len(results) == 3
    for k, freq in ((0, 220.0), (1, 330.0), (2, 220.0)):
        ltas = results[k].features.ltas
        peak = float(ltas.frequencies[np.argmax(ltas.magnitude)])
        assert peak == pytest.approx(freq, abs=22.0)
    # mono: perfect correlation, zero side; stereo: imbalanced but correlated
    assert results[0].stereo.correlation == pytest.approx(1.0, abs=1e-6)
    assert results[0].stereo.side_rms == pytest.approx(0.0, abs=1e-7)
    assert results[1].stereo.correlation == pytest.approx(1.0, abs=1e-3)
    assert results[1].harmonic.stereo_image.balance > 0.01


@pytest.mark.parametrize("transport", ["ms", "ms6", "ms5"])
def test_library_device_batch_matches_default(transport) -> None:
    """device_batch=2 packs 2*n_devices tracks per dispatch (zero-lane
    padding for the remainder); per-track results must match the
    batch-1 path — the batched graph is lane-invariant. Covers both the
    int8 default and the packed 6-bit transport (whose per-lane parts
    include the extra bases array and zero-lane padding must decode to
    silence in raw mode)."""

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 22_050
    n = int(1.4 * sr)
    t = np.arange(n) / sr
    tracks = []
    for i, freq in enumerate((220.0, 330.0, 262.0)):  # odd count: pads lanes
        l = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        r = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        tracks.append(
            AudioInput(samples=0.5 * (l + r), sample_rate=sr, stereo_samples=np.stack([l, r]))
        )

    base = analyse_library(tracks, transport=transport)
    batched = analyse_library(tracks, device_batch=2, transport=transport)
    assert len(batched) == len(base) == 3
    for b, a in zip(batched, base):
        assert b.beat.bpm == pytest.approx(a.beat.bpm, abs=1e-9)
        assert b.harmonic.primary_key.key == a.harmonic.primary_key.key
        assert b.loudness.integrated_lufs == pytest.approx(
            a.loudness.integrated_lufs, abs=1e-9
        )
        assert b.stereo.correlation == pytest.approx(a.stereo.correlation, abs=1e-9)
        np.testing.assert_allclose(
            np.asarray(b.structure.novelty_curve),
            np.asarray(a.structure.novelty_curve),
            atol=1e-6,
        )


def test_one_device_sweep_trims_trailing_zero_lanes() -> None:
    """On a ONE-device mesh a partial device_batch
    group's trailing all-zero lanes are trimmed before upload and grown
    on device (_grow_part): results must be identical to batch-1 and
    the counted upload bytes must be ~half of untrimmed (2 real lanes in
    a 4-lane group; the suite's default 8-device mesh takes the
    full-stack path, so this pins the single-device branch)."""

    import jax

    from track_analyser_tpu.parallel.batch import (
        analyse_library,
        reset_upload_bytes,
        upload_bytes,
    )
    from track_analyser_tpu.parallel.mesh import make_mesh
    from track_analyser_tpu.utils import AudioInput

    one_dev = make_mesh(devices=jax.devices()[:1])
    sr = 22_050
    n = int(1.4 * sr)
    t = np.arange(n) / sr
    tracks = []
    for freq in (220.0, 330.0):
        l = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        r = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        tracks.append(
            AudioInput(samples=0.5 * (l + r), sample_rate=sr, stereo_samples=np.stack([l, r]))
        )

    base = analyse_library(tracks, mesh=one_dev, device_batch=1, transport="ms5")
    reset_upload_bytes()
    batched = analyse_library(tracks, mesh=one_dev, device_batch=4, transport="ms5")
    trimmed_bytes = upload_bytes()
    for b, a in zip(batched, base):
        assert b.beat.bpm == pytest.approx(a.beat.bpm, abs=1e-9)
        assert b.loudness.integrated_lufs == pytest.approx(
            a.loudness.integrated_lufs, abs=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(b.structure.novelty_curve),
            np.asarray(a.structure.novelty_curve),
            atol=1e-6,
        )
    # 2 real lanes of a 4-lane group: the mid payload must ship ~2/4 of
    # the untrimmed stack (scales/bases/valids are per-group small); a
    # generous 0.7 bound still fails if zero lanes ship again.
    n_bucket = -(-n // 65_536) * 65_536
    untrimmed_payload = 4 * (5 * n_bucket // 8)
    assert trimmed_bytes < 0.7 * untrimmed_payload, (
        trimmed_bytes,
        untrimmed_payload,
    )


def test_library_prewarm_path_is_safe() -> None:
    """prewarm=True pushes a zero-payload chunk through the dispatch path
    per bucket (normally only on accelerator backends, where server-side
    compiles are slow and parallelise); results must be unaffected."""

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 44_100
    tracks = []
    for freq, secs in ((220.0, 0.7), (330.0, 2.2)):
        t = np.arange(int(secs * sr)) / sr
        tracks.append(
            AudioInput(
                samples=(0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32),
                sample_rate=sr,
            )
        )
    warm = analyse_library(tracks, prewarm=True)
    cold = analyse_library(tracks, prewarm=False)
    assert len(warm) == len(cold) == 2
    for w, c in zip(warm, cold):
        assert w.beat.bpm == pytest.approx(c.beat.bpm, abs=1e-9)
        assert w.loudness.integrated_lufs == pytest.approx(
            c.loudness.integrated_lufs, abs=1e-9
        )


def test_ms_transport_holds_tempo_contract() -> None:
    """The mid channel is the ONLY payload of the "ms" transport and the
    evidence for every gated mono analysis; the +-0.1 BPM / 5 ms gates
    must survive its blockwise int8 quantisation exactly as the device
    reconstructs it (_dequantise_mono_i8)."""

    import jax.numpy as jnp

    from synth import click_grid
    from track_analyser_tpu.parallel.batch import (
        _I8_BLOCK,
        _dequantise_mono_i8,
        _quantise_ms,
    )
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    sr = 48_000
    y, expected = click_grid(120.0, 32 * 4, sr, noise_db=-34.0, seed=1234)
    n_pad = -(-y.size // _I8_BLOCK) * _I8_BLOCK
    # a stereo spread around the mono click grid: mid == y exactly
    padded = np.zeros((2, n_pad), dtype=np.float32)
    padded[0, : y.size] = y * 1.3
    padded[1, : y.size] = y * 0.7
    mid_i8, mscales, _side, _sscales, _noise, _stats = _quantise_ms(padded, y.size)
    yq = np.asarray(_dequantise_mono_i8(jnp.asarray(mid_i8), jnp.asarray(mscales)))[
        : y.size
    ]

    assert abs(estimate_bpm(yq, sr) - 120.0) <= 0.1
    grid = beat_grid(yq, sr)
    actual = grid["time"].to_numpy()[: expected.size]
    assert float(np.max(np.abs(actual - expected[: actual.size]))) <= 0.005


def test_ms6_pack_roundtrip_and_native_parity() -> None:
    """The 6-bit transport's three layers must agree: the numpy encoder
    (_quantise_mid6_range), the native kernel (ta_quantise_mid6 — must
    match the numpy encoder BITWISE, including per-block raw/delta mode
    choices and carry threading) and the device unpack
    (_dequantise_mono_i6), whose output must reproduce the decode law
    the encoders tracked (exact up to XLA's fma contraction on the
    base + cumsum*step multiply-add)."""

    import jax.numpy as jnp

    from track_analyser_tpu.parallel.batch import (
        _I8_BLOCK,
        _dequantise_mono_i6,
        _quantise_mid6_range,
    )

    rng = np.random.default_rng(7)
    n_in = 150_000  # not a block multiple: exercises the padded tail
    n_bucket = 3 * _I8_BLOCK
    # smooth band-limited content so at least one block picks DELTA,
    # plus a click so at least one block picks RAW
    t = np.arange(n_in) / 44_100.0
    smooth = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 330.0 * t)
    click = np.zeros(n_in, np.float32)
    click[140_000:140_050] = rng.normal(0, 0.8, 50)
    base_sig = (smooth + click).astype(np.float32)
    channels = np.stack([base_sig * 1.2, base_sig * 0.8]).astype(np.float32)

    packed, scales, bases, stats, carry = _quantise_mid6_range(
        channels, n_in, 0, n_bucket
    )
    assert packed.dtype == np.uint8 and packed.size == 3 * n_bucket // 4
    assert float(stats[0]) == float(n_in)
    assert (scales < 0).any(), "no block picked delta on smooth content"
    assert (scales >= 0).any(), "no block picked raw"

    try:
        from track_analyser_tpu.native import binding

        native = binding.quantise_mid6(channels, n_bucket, _I8_BLOCK)
    except Exception:
        native = None
    if native is not None:
        p_nat, s_nat, b_nat, st_nat, c_nat = native
        np.testing.assert_array_equal(scales, s_nat)
        np.testing.assert_array_equal(bases, b_nat)
        np.testing.assert_array_equal(packed, p_nat)
        np.testing.assert_allclose(stats, st_nat, rtol=1e-12)
        assert carry == c_nat

    got = np.asarray(
        _dequantise_mono_i6(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(bases))
    )
    # reference decode law in numpy (int cumsum is exact; float ops f32)
    m = packed.reshape(-1, 3).astype(np.int32)
    c0 = m[:, 0] >> 2
    c1 = ((m[:, 0] & 3) << 4) | (m[:, 1] >> 4)
    c2 = ((m[:, 1] & 15) << 2) | (m[:, 2] >> 6)
    c3 = m[:, 2] & 63
    codes = np.stack([c0, c1, c2, c3], axis=-1).reshape(-1) - 32
    cb = codes.reshape(-1, _I8_BLOCK)
    step = (np.abs(scales) / np.float32(31.0)).astype(np.float32)
    raw = cb.astype(np.float32) * step[:, None]
    delta = bases[:, None] + np.cumsum(cb, axis=1).astype(np.float32) * step[:, None]
    want = np.where((scales < 0)[:, None], delta, raw).reshape(-1)
    np.testing.assert_allclose(got, want, atol=float(np.abs(scales).max()) * 1e-6)

    # decode error bound: raw blocks sit within half a raw step
    # (peak/62); delta blocks are only selected when strictly better
    # than half that — so peak/31 bounds every block
    mid = np.zeros(n_bucket, np.float32)
    mid[:n_in] = 0.5 * (channels[0] + channels[1])
    blocks = mid.reshape(-1, _I8_BLOCK)
    per_block_err = np.abs(got - mid).reshape(-1, _I8_BLOCK).max(axis=-1)
    bound = np.maximum(np.abs(blocks).max(axis=-1) / 31.0, 1e-6)
    assert np.all(per_block_err <= bound)


def test_ms6_transport_holds_tempo_contract() -> None:
    """+-0.1 BPM / 5 ms gates on the 6-bit mid exactly as the device
    reconstructs it — the sub-8-bit analogue of the ms contract test."""

    import jax.numpy as jnp

    from synth import click_grid
    from track_analyser_tpu.parallel.batch import (
        _I8_BLOCK,
        _dequantise_mono_i6,
        _quantise_mid6_range,
    )
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    sr = 48_000
    y, expected = click_grid(120.0, 32 * 4, sr, noise_db=-34.0, seed=1234)
    n_pad = -(-y.size // _I8_BLOCK) * _I8_BLOCK
    channels = np.zeros((2, y.size), dtype=np.float32)
    channels[0] = y * 1.3
    channels[1] = y * 0.7
    packed, scales, bases, _stats, _carry = _quantise_mid6_range(
        channels, y.size, 0, n_pad
    )
    yq = np.asarray(
        _dequantise_mono_i6(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(bases))
    )[: y.size]

    assert abs(estimate_bpm(yq, sr) - 120.0) <= 0.1
    grid = beat_grid(yq, sr)
    actual = grid["time"].to_numpy()[: expected.size]
    assert float(np.max(np.abs(actual - expected[: actual.size]))) <= 0.005


def test_library_ms6_matches_ms_decisions() -> None:
    """A small library under the packed 6-bit transport reaches the same
    decisions as the int8 "ms" default, with host-exact stereo scalars
    (both mid-only transports carry the identical f64 side stats)."""

    from synth import click_grid, progression
    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.utils import AudioInput

    sr = 44_100
    tracks = []
    # I-IV-V-I in C major / i-iv-v-i in A minor: a decisive key per
    # track (a bare click grid has no harmonic content, so its "key"
    # is noise-driven and legitimately flips under requantisation).
    chords = {
        1: [(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")],
        2: [(57, "min"), (62, "min"), (64, "min"), (57, "min")],
    }
    for bpm, seed in ((118.0, 1), (126.0, 2)):
        y, _ = click_grid(bpm, 48, sr, noise_db=-40.0, seed=seed)
        h = np.tile(progression(chords[seed], 2.0, sr), 1 + y.size // (8 * sr))
        y = (y + 0.4 * h[: y.size]).astype(np.float32)
        tracks.append(
            AudioInput(
                samples=y, sample_rate=sr, stereo_samples=np.stack([y, 0.8 * y])
            )
        )

    ms = analyse_library(tracks, transport="ms")
    ms6 = analyse_library(tracks, transport="ms6")
    for (a, b), true_bpm in zip(zip(ms, ms6), (118.0, 126.0)):
        # both transports hold the published +-0.1 BPM gate (ms6's
        # per-block raw/delta coding covers dense mixes like this one)
        assert abs(a.beat.bpm - true_bpm) <= 0.1
        assert abs(b.beat.bpm - true_bpm) <= 0.1
        assert a.harmonic.primary_key.key == b.harmonic.primary_key.key
        assert a.loudness.integrated_lufs == pytest.approx(
            b.loudness.integrated_lufs, abs=0.15
        )
        # identical host-exact f64 stereo stats ride both payloads
        assert a.stereo.correlation == pytest.approx(b.stereo.correlation, abs=1e-12)
        assert a.stereo.mid_rms == pytest.approx(b.stereo.mid_rms, abs=1e-12)


def test_host_stereo_widths_match_device_estimator() -> None:
    """The "ms" transport ships no side channel; the per-band widths are
    computed host-side in f64 over strided frames with the device graph's
    own band-energy formula. Pin the two estimators together on a rich
    stereo fixture (stationary AND nonstationary) well inside the 5%
    decision margin the old int4-side path was held to."""

    from functools import partial

    import jax
    import jax.numpy as jnp

    from track_analyser_tpu.parallel.batch import _host_stereo_widths
    from track_analyser_tpu.substrate import bucket_length, full_track_graph

    sr = 22_050
    n = int(12.5 * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(1)
    common = 0.3 * np.sin(2 * np.pi * 110 * t)
    for b in np.arange(0, 12.5, 0.5):
        s = int(b * sr)
        e = min(n, s + 1000)
        seg = np.arange(e - s) / sr
        common[s:e] += np.sin(2 * np.pi * 60 * seg) * np.exp(-seg * 30)
    side_tone = 0.2 * np.sin(2 * np.pi * 3000 * t)
    l = (common + side_tone + 0.05 * rng.standard_normal(n)).astype(np.float32)
    r = (common - side_tone + 0.05 * rng.standard_normal(n)).astype(np.float32)
    # nonstationary: the image collapses to near-mono halfway through
    l[n // 2 :] = common[n // 2 :].astype(np.float32)
    r[n // 2 :] = common[n // 2 :].astype(np.float32)
    stereo = np.stack([l, r])

    nb = bucket_length(n)
    buf = np.zeros((2, nb), np.float32)
    buf[:, :n] = stereo
    dev = np.asarray(
        jax.jit(partial(full_track_graph, sr=sr))(jnp.asarray(buf), jnp.asarray(n))[
            "stereo_widths"
        ]
    )
    host = _host_stereo_widths(stereo, sr)
    np.testing.assert_allclose(host, dev, rtol=0.04, atol=5e-3)


def test_host_stereo_widths_clipped_gather_matches_padded_reference() -> None:
    """The widths estimator gathers only the sampled frames via clipped
    indices + a validity mask (full-length pad+copy thrashed concurrent
    decode workers 17x). Pin it bit-exactly against an explicit
    zero-padded framing, including the edge frames whose centred windows
    hang off both ends of the signal."""

    from track_analyser_tpu.ops.stft import hann_window
    from track_analyser_tpu.parallel.batch import _host_stereo_widths

    sr = 8_000
    n_fft, hop, max_frames = 2048, 512, 192
    rng = np.random.default_rng(7)
    for n in (3 * sr, n_fft // 2 + 17):  # normal and shorter-than-a-window
        stereo = rng.standard_normal((2, n)).astype(np.float32) * 0.4

        l = stereo[0].astype(np.float64)
        r = stereo[1].astype(np.float64)
        total = 1 + n // hop
        stride = -(-total // max_frames)  # ceil, same as the estimator
        starts = np.arange(0, total, stride) * hop - n_fft // 2
        pad = n_fft // 2
        lp = np.pad(l, (pad, n_fft))
        rp = np.pad(r, (pad, n_fft))
        idx = (starts + pad)[:, None] + np.arange(n_fft)[None, :]
        win = hann_window(n_fft).astype(np.float64)
        fl, fr = lp[idx] * win, rp[idx] * win
        sm = np.fft.rfft(0.5 * (fl + fr), axis=-1)
        ss = np.fft.rfft(0.5 * (fl - fr), axis=-1)
        mid_e, side_e = np.abs(sm) ** 2, np.abs(ss) ** 2
        freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
        nyq = sr / 2.0
        want = np.zeros(3)
        for k, (lo_f, hi_f) in enumerate(
            ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq))
        ):
            band = (freqs >= lo_f) & (freqs <= hi_f)
            m = float(np.mean(mid_e[:, band]))
            s = float(np.mean(side_e[:, band]))
            want[k] = 0.0 if m <= 1e-12 else float(np.sqrt(s / m))

        got = _host_stereo_widths(stereo, sr)
        np.testing.assert_array_equal(got, want)


def test_stage_timer_wraps_progress_callback(tmp_path) -> None:
    from track_analyser_tpu.pipeline import analyse_track
    from track_analyser_tpu.profiling import StageTimer
    from track_analyser_tpu.utils import AudioInput

    sr = 22_050
    t = np.linspace(0, 1.0, sr, endpoint=False)
    audio = AudioInput(
        samples=(0.2 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sample_rate=sr
    )

    timer = StageTimer()
    seen = []
    analyse_track(audio, progress_callback=timer.callback(seen.append))
    assert seen[: 2] == ["audio", "beats"]
    assert set(timer.durations) >= {"audio", "beats", "structure", "loudness"}
    assert timer.total > 0
    assert "total" in timer.report()


def test_library_sweep_isolates_undecodable_tracks(tmp_path) -> None:
    """A corrupt file must not abort a library sweep: it is recorded in
    the manifest with an error (and retried on rerun), while every other
    track completes. on_error="raise" restores fail-fast behaviour."""

    import json

    from synth import sine, write_pcm16_wav
    from track_analyser_tpu.parallel.batch import (
        SkippedTrack,
        TrackFailure,
        analyse_library,
    )
    from track_analyser_tpu.pipeline import TrackAnalysisResult

    good1 = write_pcm16_wav(tmp_path / "good1.wav", 0.3 * sine(220.0, 1.0, 22_050), 22_050)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFnope")
    good2 = write_pcm16_wav(tmp_path / "good2.wav", 0.3 * sine(330.0, 1.0, 22_050), 22_050)

    manifest = tmp_path / "sweep.jsonl"
    results = analyse_library(
        [str(good1), str(bad), str(good2)], manifest_path=manifest
    )
    # outcomes are per-source and aligned: success, failure, success
    assert len(results) == 3
    assert isinstance(results[0], TrackAnalysisResult)
    assert isinstance(results[1], TrackFailure)
    assert results[1].source == str(bad) and results[1].error
    assert isinstance(results[2], TrackAnalysisResult)

    records = [json.loads(line) for line in manifest.read_text().splitlines()]
    errors = [r for r in records if "error" in r]
    assert len(errors) == 1 and errors[0]["source"] == str(bad)
    assert sum(1 for r in records if "error" not in r) == 2

    # rerun: completed tracks skip, the broken one retries (and fails again)
    results2 = analyse_library(
        [str(good1), str(bad), str(good2)], manifest_path=manifest
    )
    assert isinstance(results2[0], SkippedTrack)
    assert isinstance(results2[1], TrackFailure)
    assert isinstance(results2[2], SkippedTrack)

    with pytest.raises(RuntimeError):
        analyse_library([str(bad)], on_error="raise")


def test_library_device_batch_isolates_failures(tmp_path) -> None:
    """Failure isolation composes with per-device batching: a corrupt
    source inside a device_batch=2 sweep must not poison its chunk's
    lane packing — outcomes stay source-aligned and the good tracks
    match a clean batch-1 sweep."""

    from synth import sine, write_pcm16_wav
    from track_analyser_tpu.parallel.batch import TrackFailure, analyse_library
    from track_analyser_tpu.pipeline import TrackAnalysisResult

    sr = 22_050
    paths = []
    for i, freq in enumerate((220.0, 262.0, 330.0)):
        paths.append(
            str(write_pcm16_wav(tmp_path / f"t{i}.wav", 0.3 * sine(freq, 1.2, sr), sr))
        )
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFnope")
    sources = [paths[0], str(bad), paths[1], paths[2]]

    out = analyse_library(sources, device_batch=2)
    assert [type(o) for o in out] == [
        TrackAnalysisResult,
        TrackFailure,
        TrackAnalysisResult,
        TrackAnalysisResult,
    ]
    assert out[1].source == str(bad)

    clean = analyse_library([paths[0], paths[1], paths[2]])
    for got, want in zip((out[0], out[2], out[3]), clean):
        assert got.beat.bpm == pytest.approx(want.beat.bpm, abs=1e-9)
        assert got.loudness.integrated_lufs == pytest.approx(
            want.loudness.integrated_lufs, abs=1e-9
        )
        assert got.harmonic.primary_key.key == want.harmonic.primary_key.key


def test_library_shard_striping_covers_all_sources(tmp_path) -> None:
    """Multi-process sweeps stripe sources deterministically: shard i/n
    analyses sources[i::n] and marks the rest SkippedTrack(reason=
    "other-shard"). Two shards over the same manifest must cover every
    source exactly once, and a rerun skips everything via the manifest."""

    from synth import sine, write_pcm16_wav
    from track_analyser_tpu.parallel.batch import SkippedTrack, analyse_library
    from track_analyser_tpu.pipeline import TrackAnalysisResult

    sr = 22_050
    paths = [
        str(write_pcm16_wav(tmp_path / f"t{i}.wav", 0.3 * sine(f, 1.0, sr), sr))
        for i, f in enumerate((220.0, 262.0, 330.0))
    ]
    manifest = tmp_path / "sweep.jsonl"

    out0 = analyse_library(paths, shard=(0, 2), manifest_path=manifest)
    out1 = analyse_library(paths, shard=(1, 2), manifest_path=manifest)

    assert isinstance(out0[0], TrackAnalysisResult)
    assert isinstance(out0[1], SkippedTrack) and out0[1].reason == "other-shard"
    assert isinstance(out0[2], TrackAnalysisResult)
    assert isinstance(out1[0], SkippedTrack) and out1[0].reason == "other-shard"
    assert isinstance(out1[1], TrackAnalysisResult)
    assert isinstance(out1[2], SkippedTrack) and out1[2].reason == "other-shard"

    # the shared manifest now lists all three; a rerun analyses nothing
    rerun = analyse_library(paths, manifest_path=manifest)
    assert all(isinstance(r, SkippedTrack) and r.reason == "manifest" for r in rerun)

    with pytest.raises(ValueError):
        analyse_library(paths, shard=(2, 2))


def test_ms6_chunked_carry_matches_full_pass() -> None:
    """The single-track path quantises block-aligned chunks sequentially,
    threading the delta-coding reconstruction carry across calls; the
    concatenated chunk outputs must equal one full-bucket pass BITWISE
    (packed codes, scales, bases, final carry), for the numpy fallback
    and — when built — the native kernel, on content that engages delta
    mode across the chunk boundary."""

    from track_analyser_tpu.parallel.batch import _I8_BLOCK, _quantise_mid6_range

    sr = 44_100
    n = 3 * _I8_BLOCK + 17_000  # partial final block
    t = np.arange(n) / sr
    # smooth harmonic content -> delta mode everywhere
    y = (0.5 * np.sin(2 * np.pi * 110.0 * t) + 0.2 * np.sin(2 * np.pi * 220.0 * t)).astype(
        np.float32
    )
    channels = np.stack([y, 0.7 * y])
    n_bucket = 4 * _I8_BLOCK
    half = 2 * _I8_BLOCK

    p_full, s_full, b_full, st_full, c_full = _quantise_mid6_range(
        channels, n, 0, n_bucket
    )
    assert (s_full < 0).any(), "fixture failed to engage delta mode"

    p1, s1, b1, st1, c1 = _quantise_mid6_range(channels, n, 0, half)
    p2, s2, b2, st2, c2 = _quantise_mid6_range(channels, n, half, n_bucket, carry=c1)
    np.testing.assert_array_equal(np.concatenate([p1, p2]), p_full)
    np.testing.assert_array_equal(np.concatenate([s1, s2]), s_full)
    np.testing.assert_array_equal(np.concatenate([b1, b2]), b_full)
    assert c2 == c_full
    np.testing.assert_allclose(st1 + st2, st_full, rtol=1e-12)

    try:
        from track_analyser_tpu.native import binding

        nat_full = binding.quantise_mid6(channels, n_bucket, _I8_BLOCK)
    except Exception:
        nat_full = None
    if nat_full is not None:
        pn, sn, bn, stn, cn = nat_full
        np.testing.assert_array_equal(pn, p_full)
        np.testing.assert_array_equal(sn, s_full)
        np.testing.assert_array_equal(bn, b_full)
        assert cn == c_full
        # native chunked calls (what _dispatch_single_ms actually does)
        pn1, sn1, bn1, _st, cn1 = binding.quantise_mid6(
            np.ascontiguousarray(channels[:, :half]), half, _I8_BLOCK
        )
        pn2, sn2, bn2, _st, cn2 = binding.quantise_mid6(
            np.ascontiguousarray(channels[:, half:n]), n_bucket - half, _I8_BLOCK, cn1
        )
        np.testing.assert_array_equal(np.concatenate([pn1, pn2]), p_full)
        np.testing.assert_array_equal(np.concatenate([bn1, bn2]), b_full)
        assert cn2 == c_full


@pytest.mark.parametrize(
    "transport,seconds",
    [
        ("ms", 1.7),
        ("ms6", 1.7),
        ("int8", 1.7),
        # ~1.5 blocks (98 301 samples): a FULL first block plus a partial
        # tail block, exercising the per-block scale/masking path that a
        # sub-block length (37 485 < _I8_BLOCK) cannot reach (round-3
        # advisor finding).
        ("ms", 98_301 / 22_050),
        ("ms6", 98_301 / 22_050),
        ("ms5", 98_301 / 22_050),
    ],
)
def test_unbucketed_blockwise_transport_handles_any_length(transport, seconds) -> None:
    """analyse_track_fused(bucket=False) must not crash on lengths that
    are not a multiple of the int8 scaling block (_I8_BLOCK): blockwise
    transports round the payload up to a block multiple and mask the
    padding (round-2 advisor finding — the mono default used to leave a
    tail uncovered). Measurements must match the bucketed run."""

    from track_analyser_tpu.parallel.batch import _I8_BLOCK, analyse_track_fused
    from track_analyser_tpu.utils import AudioInput

    sr = 22_050
    n = int(sr * seconds)  # deliberately NOT a block multiple
    assert n % _I8_BLOCK != 0
    rng = np.random.default_rng(5)
    t = np.arange(n) / sr
    y = (0.3 * np.sin(2 * math.pi * 220.0 * t)).astype(np.float32)
    for b in np.arange(0.0, seconds, 0.5):
        s = int(b * sr)
        e = min(n, s + 300)
        y[s:e] += np.exp(-np.linspace(0.0, 6.0, e - s)).astype(np.float32)
    y += rng.normal(0, 0.003, n).astype(np.float32)
    audio = AudioInput(samples=y, sample_rate=sr)  # mono: the crashing case

    unbucketed = analyse_track_fused(audio, transport=transport, bucket=False)
    bucketed = analyse_track_fused(audio, transport=transport)

    assert unbucketed.loudness.integrated_lufs == pytest.approx(
        bucketed.loudness.integrated_lufs, abs=0.05
    )
    assert unbucketed.loudness.true_peak_dbfs == pytest.approx(
        bucketed.loudness.true_peak_dbfs, abs=0.05
    )
    assert unbucketed.beat.bpm == pytest.approx(bucketed.beat.bpm, abs=0.5)


def test_ms_bucket_length_tier_grid() -> None:
    """The ms/ms6 pad target: geometric buckets for short signals, the
    tier grid above ~47.5 s — every duration inside a tier shares one
    executable (the bench's 96/136/181 s tracks must all land in ONE
    tier)."""

    from track_analyser_tpu.parallel.batch import (
        _MS_CHUNK_SAMPLES,
        _MS_TIER_MIN_SAMPLES,
        ms_bucket_length,
    )
    from track_analyser_tpu.substrate import bucket_length

    sr = 44_100
    # short signals: unchanged geometric ladder
    for n in (1_000, 400_000, _MS_TIER_MIN_SAMPLES):
        assert ms_bucket_length(n) == bucket_length(n)
    # the bench durations share one tier
    tiers = {ms_bucket_length(int(s * sr)) for s in (96.0, 136.0, 181.0)}
    assert len(tiers) == 1
    (tier,) = tiers
    assert tier % _MS_CHUNK_SAMPLES == 0
    assert tier >= int(181.0 * sr)
    # monotone, always covers n, always chunk-aligned above the threshold
    prev = 0
    for n in range(_MS_TIER_MIN_SAMPLES + 1, 40_000_000, 2_500_000):
        b = ms_bucket_length(n)
        assert b >= n and b % _MS_CHUNK_SAMPLES == 0
        assert b >= prev
        prev = b


@pytest.mark.parametrize("transport", ["ms", "ms6"])
def test_tier_grid_results_match_geometric_bucket(transport, monkeypatch) -> None:
    """Tier-grid padding (with its _ZeroChunk zero-upload tail) must not
    change any measurement vs the geometric bucket — same padding-
    invariance contract the masked graph already guarantees, exercised
    here through the real dispatch path by shrinking the tier constants
    so a short fixture crosses the threshold."""

    from track_analyser_tpu.parallel import batch as batch_mod

    sr = 22_050
    n = 3 * 65_536 + 12_345  # ~9.4 s, crosses the shrunken threshold
    rng = np.random.default_rng(11)
    t = np.arange(n) / sr
    y = (0.3 * np.sin(2 * math.pi * 220.0 * t)).astype(np.float32)
    for b in np.arange(0.0, n / sr, 0.5):
        s = int(b * sr)
        e = min(n, s + 300)
        y[s:e] += np.exp(-np.linspace(0.0, 6.0, e - s)).astype(np.float32)
    y += rng.normal(0, 0.003, n).astype(np.float32)
    from track_analyser_tpu.utils import AudioInput

    audio = AudioInput(samples=y, sample_rate=sr)

    baseline = batch_mod.analyse_track_fused(audio, transport=transport)

    monkeypatch.setattr(batch_mod, "_MS_TIER_MIN_SAMPLES", 1 << 17)
    monkeypatch.setattr(batch_mod, "_MS_CHUNK_SAMPLES", 1 << 16)
    monkeypatch.setattr(batch_mod, "_MS_TIERS", (8, 16))
    assert batch_mod.ms_bucket_length(n) == 8 * (1 << 16)  # 4 valid + 4 zero chunks
    tiered = batch_mod.analyse_track_fused(audio, transport=transport)
    # the padding tail rode the cached zero buffer (chunk parts are
    # sliced in PACKED-PAYLOAD space, so ms6's zero chunks stage at
    # 3/4 of the sample chunk size)
    bits = {"ms6": 6, "ms5": 5}.get(transport, 8)
    zero_len = batch_mod._ms_payload_bytes(0, 1 << 16, bits)[1]
    assert any(key[1][-1] == zero_len for key in batch_mod._ZERO_PARTS)

    assert tiered.beat.bpm == pytest.approx(baseline.beat.bpm, abs=1e-6)
    assert tiered.loudness.integrated_lufs == pytest.approx(
        baseline.loudness.integrated_lufs, abs=1e-6
    )
    assert tiered.loudness.true_peak_dbfs == pytest.approx(
        baseline.loudness.true_peak_dbfs, abs=1e-6
    )
    assert tiered.harmonic.primary_key.key == baseline.harmonic.primary_key.key
    assert [s.start for s in tiered.structure.segments] == pytest.approx(
        [s.start for s in baseline.structure.segments], abs=1e-6
    )


@pytest.mark.parametrize("transport", ["ms6", "ms5"])
def test_tail_granule_trim_matches_untrimmed(transport, monkeypatch) -> None:
    """Tier-grid tracks ship their final chunk only through the last
    valid GRANULE (_MS_TAIL_GRANULE); the tail is zero-extended on
    device (_grow_part). Results must be identical to the geometric
    (untrimmed) bucket, upload bytes must actually shrink, and the
    sweep's ragged-lane stacking must handle two tracks whose straddle
    chunks trim differently. Constants are shrunk so a short CPU
    fixture crosses the tier threshold."""

    import jax

    from track_analyser_tpu.parallel import batch as batch_mod
    from track_analyser_tpu.parallel.mesh import make_mesh
    from track_analyser_tpu.utils import AudioInput

    sr = 22_050
    rng = np.random.default_rng(23)

    def _track(seconds, freq):
        n = int(seconds * sr)
        t = np.arange(n) / sr
        y = (0.3 * np.sin(2 * math.pi * freq * t)).astype(np.float32)
        for b in np.arange(0.0, seconds, 0.5):
            s = int(b * sr)
            e = min(n, s + 300)
            y[s:e] += np.exp(-np.linspace(0.0, 6.0, e - s)).astype(np.float32)
        y += rng.normal(0, 0.003, n).astype(np.float32)
        return AudioInput(samples=y, sample_rate=sr)

    # 6.8 s / 8.0 s: after the sweep's resample to 44.1 kHz these trim
    # to 5 and 6 granules of the 8-granule chunk (ragged lanes in one
    # group; the stack pads to the 6-granule max — still a byte win)
    tracks = [_track(6.8, 220.0), _track(8.0, 330.0)]

    # chunk 2^19 = 8 granules of 2^16 (the smallest multiple of every
    # transport's scale block), tier threshold 2^17: both fixtures land
    # in the 1-chunk tier with DIFFERENT trimmed tails. A granule equal
    # to the chunk disables trimming (the _ms_quantise_len guard), which
    # gives the untrimmed reference through the IDENTICAL pipeline.
    monkeypatch.setattr(batch_mod, "_MS_TIER_MIN_SAMPLES", 1 << 17)
    monkeypatch.setattr(batch_mod, "_MS_CHUNK_SAMPLES", 1 << 19)
    monkeypatch.setattr(batch_mod, "_MS_TIERS", (1, 2))
    monkeypatch.setattr(batch_mod, "_MS_TAIL_GRANULE", 1 << 19)

    one_dev = make_mesh(devices=jax.devices()[:1])
    batch_mod.reset_upload_bytes()
    base_single = batch_mod.analyse_track_fused(tracks[0], transport=transport)
    base_single_bytes = batch_mod.upload_bytes()
    batch_mod.reset_upload_bytes()
    base_swept = batch_mod.analyse_library(
        tracks, mesh=one_dev, device_batch=2, transport=transport
    )
    base_sweep_bytes = batch_mod.upload_bytes()

    monkeypatch.setattr(batch_mod, "_MS_TAIL_GRANULE", 1 << 16)
    n0 = len(tracks[0].samples)
    assert batch_mod.ms_bucket_length(n0) == 1 << 19
    q0 = batch_mod._ms_quantise_len(n0, 1 << 19)
    assert q0 < (1 << 19)  # the fixture really trims

    # single-track fused path (trim + device zero-extension)
    batch_mod.reset_upload_bytes()
    single = batch_mod.analyse_track_fused(tracks[0], transport=transport)
    single_bytes = batch_mod.upload_bytes()
    assert single.beat.bpm == pytest.approx(base_single.beat.bpm, abs=1e-12)
    assert single.loudness.integrated_lufs == pytest.approx(
        base_single.loudness.integrated_lufs, abs=1e-12
    )
    assert single.harmonic.primary_key.key == base_single.harmonic.primary_key.key
    assert single_bytes < 0.85 * base_single_bytes, (
        single_bytes,
        base_single_bytes,
    )

    # sweep path: ragged straddle lanes in ONE batch group
    batch_mod.reset_upload_bytes()
    swept = batch_mod.analyse_library(
        tracks, mesh=one_dev, device_batch=2, transport=transport
    )
    sweep_bytes = batch_mod.upload_bytes()
    assert sweep_bytes < 0.85 * base_sweep_bytes, (sweep_bytes, base_sweep_bytes)
    for got, want in zip(swept, base_swept):
        assert got.beat.bpm == pytest.approx(want.beat.bpm, abs=1e-12)
        assert got.loudness.integrated_lufs == pytest.approx(
            want.loudness.integrated_lufs, abs=1e-12
        )
        np.testing.assert_array_equal(
            np.asarray(got.structure.novelty_curve),
            np.asarray(want.structure.novelty_curve),
        )


def test_ms5_pack_roundtrip_and_native_parity() -> None:
    """The 5-bit transport's three layers must agree: the numpy encoder
    (_quantise_mid5_range), the native kernel (ta_quantise_mid5 — must
    match the numpy encoder BITWISE, including per-block raw/delta mode
    choices and carry threading across chunked calls) and the device
    unpack (_dequantise_mono_i5)."""

    import jax.numpy as jnp

    from track_analyser_tpu.native import binding
    from track_analyser_tpu.parallel.batch import (
        _MS5_BLOCK,
        _dequantise_mono_i5,
        _pack_i5,
        _quantise_mid5_range,
    )

    # 8-into-5-byte pack/unpack is its own exact inverse
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 32, 8 * 512).astype(np.uint8)
    packed = _pack_i5(codes)
    b = packed.reshape(-1, 5).astype(np.int32)
    got = np.stack(
        [
            b[:, 0] >> 3,
            ((b[:, 0] & 7) << 2) | (b[:, 1] >> 6),
            (b[:, 1] >> 1) & 31,
            ((b[:, 1] & 1) << 4) | (b[:, 2] >> 4),
            ((b[:, 2] & 15) << 1) | (b[:, 3] >> 7),
            (b[:, 3] >> 2) & 31,
            ((b[:, 3] & 3) << 3) | (b[:, 4] >> 5),
            b[:, 4] & 31,
        ],
        axis=-1,
    ).reshape(-1)
    np.testing.assert_array_equal(got, codes.astype(np.int32))

    sr = 44_100
    n = 13 * _MS5_BLOCK + 714  # non-block-multiple valid length
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * math.pi * 220 * t) + 0.2 * np.sin(2 * math.pi * 553 * t)).astype(
        np.float32
    )
    x[5000:5100] += 0.5  # transient: exercises the raw/delta mode choice
    channels = x[None, :]
    nb = 16 * _MS5_BLOCK

    pk_np, sc_np, ba_np, st_np, ca_np = _quantise_mid5_range(channels, n, 0, nb)
    nat = binding.quantise_mid5(channels, nb, _MS5_BLOCK)
    if nat is not None:  # native tier optional; numpy is authoritative
        pk_na, sc_na, ba_na, _st, ca_na = nat
        np.testing.assert_array_equal(pk_np, pk_na)
        np.testing.assert_array_equal(sc_np, sc_na)
        np.testing.assert_array_equal(ba_np, ba_na)
        assert ca_np == ca_na

        # chunked calls with carry threading == one full pass, bitwise
        half = 8 * _MS5_BLOCK
        p1, s1, b1, _s, c1 = binding.quantise_mid5(
            np.ascontiguousarray(channels[:, :half]), half, _MS5_BLOCK
        )
        p2, s2, b2, _s, c2 = binding.quantise_mid5(
            np.ascontiguousarray(channels[:, half:n]), nb - half, _MS5_BLOCK, c1
        )
        np.testing.assert_array_equal(np.concatenate([p1, p2]), pk_np)
        np.testing.assert_array_equal(np.concatenate([b1, b2]), ba_np)
        assert c2 == ca_np

    y = np.asarray(
        _dequantise_mono_i5(jnp.asarray(pk_np), jnp.asarray(sc_np), jnp.asarray(ba_np))
    )[:n]
    snr = 10 * np.log10(np.mean(x**2) / np.mean((y - x) ** 2))
    assert snr > 30.0, snr
