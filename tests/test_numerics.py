"""Sanitizer analogues (SURVEY §5): NaN-guarded execution and buffer-
donation safety — this build's equivalent of the race/UB sanitizers a
native framework would run."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from track_analyser_tpu.models import downbeat_net as net
from track_analyser_tpu.pipeline import analyse_track
from track_analyser_tpu.utils import AudioInput


@pytest.mark.parametrize(
    "make_signal",
    [
        lambda: np.zeros(22_050, dtype=np.float32),  # masked paths divide by counts
        lambda: 0.2 * np.random.default_rng(3).normal(size=22_050).astype(np.float32),
    ],
    ids=["silence", "noise"],
)
def test_full_analysis_is_nan_free_under_debug_nans(make_signal) -> None:
    """jax_debug_nans raises on ANY NaN produced inside jitted graphs —
    silence exercises every masked-mean/0-norm guard in the substrate."""

    jax.config.update("jax_debug_nans", True)
    try:
        result = analyse_track(AudioInput(samples=make_signal(), sample_rate=22_050))
        assert np.isfinite(result.beat.bpm)
    finally:
        jax.config.update("jax_debug_nans", False)


def test_train_step_donation_matches_undonated_reference() -> None:
    """train_step donates params/momentum buffers; donation must be an
    allocator optimisation, never a semantic change."""

    feats, labels = net.synthetic_batch(
        np.random.default_rng(0), batch=2, frames=32, n_mels=128
    )
    init = net.init_params(jax.random.PRNGKey(0), n_mels=128, hidden=32)

    donated_p = jax.tree.map(jnp.array, init)
    donated_m = jax.tree.map(jnp.zeros_like, init)
    ref_p = jax.tree.map(jnp.array, init)
    ref_m = jax.tree.map(jnp.zeros_like, init)

    undonated_step = jax.jit(net.train_step.__wrapped__)

    for _ in range(3):
        donated_p, donated_m, d_loss = net.train_step(
            donated_p, donated_m, feats, labels
        )
        ref_p, ref_m, r_loss = undonated_step(ref_p, ref_m, feats, labels)

    assert float(d_loss) == pytest.approx(float(r_loss), rel=1e-6)
    for k in ref_p:
        np.testing.assert_allclose(
            np.asarray(donated_p[k]), np.asarray(ref_p[k]), rtol=1e-6, atol=1e-7
        )


def test_donated_buffers_are_invalidated_not_aliased() -> None:
    """After donation the old param arrays must be dead (deleted), never
    silently aliased into the new values."""

    init = net.init_params(jax.random.PRNGKey(1), n_mels=128, hidden=32)
    params = jax.tree.map(jnp.array, init)
    momentum = jax.tree.map(jnp.zeros_like, init)
    feats, labels = net.synthetic_batch(
        np.random.default_rng(1), batch=2, frames=32, n_mels=128
    )
    old_ref = params["in_w"]
    params, momentum, _ = net.train_step(params, momentum, feats, labels)
    with pytest.raises(RuntimeError):
        _ = np.asarray(old_ref) + 0  # donated buffer: any use must fail loudly
