"""The HPSS sliding median: the min/max selection network in plain jnp.

Comparisons are exact, so the network must agree with scipy bit for bit.
``jnp.pad(mode="reflect")`` (d c b | a b c d) is scipy.ndimage's
"mirror" boundary mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from track_analyser_tpu.ops.filters import _selection_ops, hpss, median_filter_1d


def _scipy_median(x: np.ndarray, size: int, axis: int) -> np.ndarray:
    window = [1] * x.ndim
    window[axis] = size
    return ndimage.median_filter(x, size=tuple(window), mode="mirror")


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize(
    "shape",
    [(40, 700), (33, 513), (100, 512), (1025, 96)],
    ids=["tile", "remainders", "exact-tile", "1025-bins"],
)
def test_network_matches_scipy(shape, axis) -> None:
    rng = np.random.default_rng(sum(shape) + axis)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    got = np.asarray(median_filter_1d(jnp.asarray(x), 31, axis=axis))
    np.testing.assert_array_equal(got, _scipy_median(x, 31, axis))


def test_network_under_vmap_matches_each_lane() -> None:
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, 200)).astype(np.float32)
    for axis in (-1, -2):
        batched = np.asarray(
            jax.jit(jax.vmap(lambda s, a=axis: median_filter_1d(s, 31, axis=a)))(jnp.asarray(x))
        )
        for lane in range(x.shape[0]):
            np.testing.assert_array_equal(batched[lane], _scipy_median(x[lane], 31, axis))


def test_network_ties_constant_and_zero_input() -> None:
    rng = np.random.default_rng(4)
    ties = rng.integers(0, 3, size=(20, 120)).astype(np.float32)
    for x in (ties, np.full((20, 120), 0.25, np.float32), np.zeros((20, 120), np.float32)):
        for axis in (-1, -2):
            got = np.asarray(median_filter_1d(jnp.asarray(x), 31, axis=axis))
            np.testing.assert_array_equal(got, _scipy_median(x, 31, axis))
    # all-zero spectrogram: the soft masks split evenly, nothing is NaN
    harm, perc = hpss(jnp.zeros((20, 120)))
    assert np.all(np.asarray(harm) == 0.0) and np.all(np.asarray(perc) == 0.0)


@pytest.mark.parametrize("size", [4, 7])
def test_other_window_sizes_match_scipy(size) -> None:
    """Even sizes select the upper median (sorted rank size // 2), as
    scipy does."""

    rng = np.random.default_rng(size)
    x = rng.standard_normal((9, 70)).astype(np.float32)
    for axis in (-1, -2):
        got = np.asarray(median_filter_1d(jnp.asarray(x), size, axis=axis))
        np.testing.assert_array_equal(got, _scipy_median(x, size, axis))


def test_pruned_network_size() -> None:
    """Median of 31 inside a 32-input bitonic network: 351 min/max ops
    survive the backward liveness pruning (480 comparators x 2 before)."""

    ops = _selection_ops(32, 15)
    assert sum(a_live + b_live for *_, a_live, b_live in ops) == 351
