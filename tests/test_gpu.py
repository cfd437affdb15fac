"""Checks that need the card: the HPSS median and the fused path at real
size. Run on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Elsewhere the ``gpu`` fixture skips them.
"""

from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_median_network_exact_at_real_width(gpu) -> None:
    import jax
    import jax.numpy as jnp
    from scipy import ndimage

    from track_analyser_tpu.ops.filters import median_filter_1d

    rng = np.random.default_rng(0)
    spec = np.abs(rng.standard_normal((2, 1025, 16_385))).astype(np.float32)
    for axis in (-1, -2):
        got = np.asarray(jax.jit(jax.vmap(lambda s, a=axis: median_filter_1d(s, 31, axis=a)))(jnp.asarray(spec)))
        window = [1, 1]
        window[axis] = 31
        want = ndimage.median_filter(spec[1], size=tuple(window), mode="mirror")
        np.testing.assert_array_equal(got[1], want)


def test_fused_float32_agrees_with_plain_path(gpu) -> None:
    from bench import make_track
    from track_analyser_tpu.parallel.batch import analyse_track_fused
    from track_analyser_tpu.pipeline import analyse_track

    audio = make_track(96.0, bpm=104.0, seed=5)
    fused = analyse_track_fused(audio, transport="float32")
    plain = analyse_track(audio, fused=False)
    assert fused.beat.bpm == pytest.approx(plain.beat.bpm, abs=0.1)
    np.testing.assert_allclose(fused.beat.beat_times, plain.beat.beat_times, atol=0.005)
    assert fused.loudness.integrated_lufs == pytest.approx(plain.loudness.integrated_lufs, abs=0.3)
    assert fused.loudness.true_peak_dbfs == pytest.approx(plain.loudness.true_peak_dbfs, abs=0.2)
    assert fused.harmonic.primary_key.key == plain.harmonic.primary_key.key
