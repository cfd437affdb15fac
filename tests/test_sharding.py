"""Multi-device tests on the virtual 8-device CPU mesh: the JAX-native
equivalent of a distributed test rig (SURVEY.md section 4)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from track_analyser_tpu.parallel.mesh import make_mesh
from track_analyser_tpu.parallel.sharded import sharded_onset_envelope
from track_analyser_tpu.tempo import onset_envelope


@pytest.fixture(scope="module")
def click_signal():
    sr = 22_050
    n = sr * 8
    rng = np.random.default_rng(0)
    y = rng.normal(0, 0.01, n).astype(np.float32)
    for b in np.arange(0.0, 8.0, 0.5):
        s = int(b * sr)
        e = min(n, s + 220)
        y[s:e] += np.exp(-np.linspace(0, 6, e - s)).astype(np.float32)
    return y, sr


def test_virtual_mesh_has_eight_devices():
    assert len(jax.devices()) >= 8


def test_sharded_onset_envelope_matches_single_device(click_signal):
    y, sr = click_signal
    mesh = make_mesh((8,), ("seq",))

    env_sharded = sharded_onset_envelope(y, sr, mesh)
    env_ref = onset_envelope(y, sr)

    assert env_sharded.shape == env_ref.shape
    # Identical up to f32 reduction order.
    np.testing.assert_allclose(env_sharded, env_ref, atol=1e-4, rtol=1e-4)


def test_batched_analysis_sharded_over_data_axis(click_signal):
    """The analyse_library dispatch path: vmapped fused graph, dp-sharded."""

    from functools import partial

    from jax.sharding import NamedSharding, PartitionSpec as P

    from track_analyser_tpu.substrate import full_track_graph

    y, sr = click_signal
    n = 512 * 128
    batch = 8
    stereos = np.stack([np.stack([y[:n], y[:n]])] * batch)
    valids = np.full((batch,), n, dtype=np.int32)

    mesh = make_mesh((8,), ("data",))
    batched = jax.jit(
        jax.vmap(partial(full_track_graph, sr=sr)),
        in_shardings=(
            NamedSharding(mesh, P("data", None, None)),
            NamedSharding(mesh, P("data")),
        ),
    )
    with mesh:
        out = batched(stereos, valids)
        jax.block_until_ready(out)

    envs = np.asarray(out["onset_env"])
    assert envs.shape[0] == batch
    # All tracks identical -> all outputs identical across shards.
    np.testing.assert_allclose(envs, np.broadcast_to(envs[0], envs.shape), atol=1e-5)


def test_sharded_full_analysis_matches_fused():
    """The sequence-sharded substrate reproduces the fused single-device
    graph: framewise curves, scalars and the final analysis decisions."""

    from functools import partial

    import jax.numpy as jnp

    from track_analyser_tpu.parallel.sharded import analyse_track_sharded, sharded_track_outputs
    from track_analyser_tpu.substrate import full_track_graph
    from track_analyser_tpu.utils import AudioInput

    # 60 s — long enough that each of the 8 shards exceeds the halo. Ends
    # in a fade-out: the analysis tail inside the padded bucket depends on
    # the (arbitrary) bucket length in BOTH implementations, so the honest
    # parity domain is a track that is quiet at its boundary. The drums
    # MUTE during 24-36 s: decisive structural boundaries keep every
    # novelty peak far from the peak-pick threshold, so the discrete
    # segment decisions cannot flip on f32 reduction-order noise between
    # the two implementations (curve-level agreement is asserted at
    # 2e-3 separately below).
    sr = 22_050
    n = sr * 60
    rng = np.random.default_rng(0)
    y = rng.normal(0, 0.01, n).astype(np.float32)
    y += 0.2 * np.sin(2 * np.pi * 220.0 * np.arange(n) / sr).astype(np.float32)
    for b in np.arange(0.0, 57.0, 0.5):
        if 24.0 <= b < 36.0:
            continue
        s = int(b * sr)
        e = min(n, s + 220)
        y[s:e] += np.exp(-np.linspace(0, 6, e - s)).astype(np.float32)
    fade = np.ones(n, dtype=np.float32)
    fade[-3 * sr :] = np.linspace(1.0, 0.0, 3 * sr, dtype=np.float32)
    y *= fade
    stereo = np.stack([y, 0.5 * y])
    mesh = make_mesh((8,), ("seq",))

    out_sh = sharded_track_outputs(stereo, n, sr, mesh)

    # Reference: fused graph on the same padded length (exact shapes).
    padded = out_sh["onset_env"].shape[0] * 512
    buf = np.zeros((2, padded), dtype=np.float32)
    buf[:, :n] = stereo
    ref = jax.device_get(
        jax.jit(partial(full_track_graph, sr=sr))(jnp.asarray(buf), jnp.asarray(n))
    )

    f_valid = 1 + n // 512
    for key, tol in [
        ("onset_env", 1e-3),
        ("novelty", 2e-3),
        ("perc_col", 2e-2),
        ("harm_col", 2e-2),
        ("centroid", 1.0),
    ]:
        a = np.asarray(out_sh[key])[:f_valid]
        b = np.asarray(ref[key])[:f_valid]
        np.testing.assert_allclose(a, b, atol=tol, rtol=1e-3, err_msg=key)

    assert float(out_sh["integrated_lufs"]) == pytest.approx(
        float(ref["integrated_lufs"]), abs=0.01
    )
    assert float(out_sh["true_peak"]) == pytest.approx(float(ref["true_peak"]), rel=1e-3)
    # One-pass f32 covariance over 1.3M samples carries ~1e-3 noise in
    # both implementations (true value is exactly 1.0 here).
    assert float(out_sh["stereo_corr_centered"]) == pytest.approx(
        float(ref["stereo_corr_centered"]), abs=3e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_sh["key_scores"]), np.asarray(ref["key_scores"]), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_sh["stereo_widths"]), np.asarray(ref["stereo_widths"]), atol=1e-3
    )

    # End-to-end: the sharded result object agrees with the fused
    # pipeline on EVERY TrackAnalysisResult field (mirror of
    # tests/test_agreement.py for the fused/per-module pair).
    audio = AudioInput(samples=y, sample_rate=sr, stereo_samples=stereo)
    result = analyse_track_sharded(audio, mesh)
    from track_analyser_tpu.parallel.batch import analyse_track_fused

    ref_result = analyse_track_fused(audio, transport="float32")

    # beat
    assert result.beat.bpm == pytest.approx(ref_result.beat.bpm, abs=0.01)
    assert result.beat.confidence == pytest.approx(ref_result.beat.confidence, abs=1e-3)
    assert len(result.beat.beat_times) == len(ref_result.beat.beat_times)
    np.testing.assert_allclose(
        result.beat.beat_times, ref_result.beat.beat_times, atol=1e-3
    )

    # downbeats (same evidence incl. the TCN net when bundled)
    assert result.downbeat.source == ref_result.downbeat.source
    np.testing.assert_allclose(
        result.downbeat.downbeat_times, ref_result.downbeat.downbeat_times, atol=1e-3
    )
    # Positions ride the DP-tracked beat base (round 4), whose tail
    # decision is a float-level near-tie between the sharded and fused
    # envelopes (psum/halo arithmetic vs one-pass); a single trailing
    # slip after the last downbeat is legitimate noise — downbeat TIMES
    # are already asserted equal above. Require near-total agreement
    # instead of bitwise equality.
    pos_sh = np.asarray(result.downbeat.beat_positions)
    pos_ref = np.asarray(ref_result.downbeat.beat_positions)
    assert abs(pos_sh.size - pos_ref.size) <= 1
    m = min(pos_sh.size, pos_ref.size)
    assert float((pos_sh[:m] == pos_ref[:m]).mean()) >= 0.97

    # structure
    assert [s.label for s in result.structure.segments] == [
        s.label for s in ref_result.structure.segments
    ]
    assert [s.category for s in result.structure.segments] == [
        s.category for s in ref_result.structure.segments
    ]
    np.testing.assert_allclose(
        [s.start for s in result.structure.segments],
        [s.start for s in ref_result.structure.segments],
        atol=0.05,
    )
    np.testing.assert_allclose(
        [s.end for s in result.structure.segments],
        [s.end for s in ref_result.structure.segments],
        atol=0.05,
    )

    # loudness
    assert result.loudness.integrated_lufs == pytest.approx(
        ref_result.loudness.integrated_lufs, abs=0.02
    )
    assert result.loudness.true_peak_dbfs == pytest.approx(
        ref_result.loudness.true_peak_dbfs, abs=0.02
    )
    assert result.loudness.rms_dbfs == pytest.approx(
        ref_result.loudness.rms_dbfs, abs=0.02
    )
    # LRA curves are host-computed on the sharded path (documented
    # deviation); the derived range must still agree
    assert result.loudness.loudness_range == pytest.approx(
        ref_result.loudness.loudness_range, abs=0.1
    )

    # harmony
    assert result.harmonic.primary_key.key == ref_result.harmonic.primary_key.key
    assert result.harmonic.secondary_key.key == ref_result.harmonic.secondary_key.key
    assert [h.chord for h in result.harmonic.chord_hints] == [
        h.chord for h in ref_result.harmonic.chord_hints
    ]
    s_times = np.array([p.time for p in result.harmonic.chord_change_points])
    f_times = np.array([p.time for p in ref_result.harmonic.chord_change_points])
    assert s_times.size == f_times.size
    np.testing.assert_allclose(s_times, f_times, atol=1e-3)
    assert result.harmonic.spectral_balance.low_band == pytest.approx(
        ref_result.harmonic.spectral_balance.low_band, abs=1e-3
    )
    assert result.harmonic.stereo_image.correlation == pytest.approx(
        ref_result.harmonic.stereo_image.correlation, abs=3e-3
    )
    for attr in ("hook_suggestion", "bass_suggestion"):
        s_notes = getattr(result.harmonic, attr).notes
        f_notes = getattr(ref_result.harmonic, attr).notes
        assert s_notes["pitch"].tolist() == f_notes["pitch"].tolist()
        assert s_notes["velocity"].tolist() == f_notes["velocity"].tolist()

    # features
    np.testing.assert_allclose(
        result.features.ltas.magnitude,
        ref_result.features.ltas.magnitude,
        rtol=1e-2,
        atol=1e-3,
    )
    assert result.features.spectral_centroid.mean == pytest.approx(
        ref_result.features.spectral_centroid.mean, rel=1e-3
    )
    assert result.features.spectral_rolloff.mean == pytest.approx(
        ref_result.features.spectral_rolloff.mean, rel=1e-3
    )

    # stereo
    assert result.stereo.mid_rms == pytest.approx(ref_result.stereo.mid_rms, abs=1e-4)
    assert result.stereo.side_rms == pytest.approx(ref_result.stereo.side_rms, abs=1e-4)
    assert result.stereo.correlation == pytest.approx(
        ref_result.stereo.correlation, abs=3e-3
    )
    for band in ("low", "mid", "high"):
        assert getattr(result.stereo.width, band) == pytest.approx(
            getattr(ref_result.stereo.width, band), rel=0.02, abs=1e-3
        ), band


def test_sharded_rejects_too_short_tracks():
    from track_analyser_tpu.parallel.sharded import sharded_track_outputs

    mesh = make_mesh((8,), ("seq",))
    short = np.zeros((2, 22_050), dtype=np.float32)  # 1 s over 8 shards
    with pytest.raises(ValueError, match="too short"):
        sharded_track_outputs(short, 22_050, 22_050, mesh)


def test_dryrun_multichip_entrypoint():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as graft

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert "onset_env" in out

    graft.dryrun_multichip(8)


def test_sharded_true_peak_exact_across_shard_boundaries():
    """A smooth plateau crossing an internal shard boundary must not ring:
    zeroing the *input* outside a shard's own range fabricated a step
    the polyphase interpolator overshot by ~1 dB (vs the ±0.2 dB gate).
    The own-range claim is an output mask; the interpolation reads the
    true halo samples."""

    from track_analyser_tpu.ops.resample import oversampled_peak
    from track_analyser_tpu.parallel.sharded import sharded_track_outputs

    sr = 22_050
    n = sr * 30
    y = (0.02 * np.sin(2 * np.pi * 220.0 * np.arange(n) / sr)).astype(np.float32)
    ramp = 2000
    env = np.concatenate(
        [
            0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp),
            np.ones(2000),
            0.5 + 0.5 * np.cos(np.pi * np.arange(ramp) / ramp),
        ]
    )
    # place a smooth full-scale plateau across every eighth of the track —
    # one of them straddles an internal shard boundary for any own-range split
    for k in range(1, 8):
        pos = k * n // 8
        seg = slice(pos - len(env) // 2, pos - len(env) // 2 + len(env))
        y[seg] = (0.9 * env).astype(np.float32)

    mesh = make_mesh((8,), ("seq",))
    out = sharded_track_outputs(np.stack([y, y]), n, sr, mesh)
    ref = float(jnp.asarray(oversampled_peak(jnp.asarray(y), 8)))
    got = float(out["true_peak"])
    assert got == pytest.approx(ref, rel=1e-5)
