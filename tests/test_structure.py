"""Structure accuracy gate: when the drums mute at 12 s the segmenter must
place a boundary within ±0.5 s — the reference project's published
tolerance (/root/reference/tests/test_structure.py:41-43) — enforced
against the fused novelty graph (cumsum self-similarity + median-network HPSS)."""

from __future__ import annotations

import numpy as np

from synth import beat_analysis_for, drone_with_muted_drums
from track_analyser_tpu.analysis.structure import analyse_structure
from track_analyser_tpu.utils import AudioInput

SR = 22_050


def test_drum_mute_boundary_and_segment_invariants() -> None:
    duration = 32.0
    y = drone_with_muted_drums(duration, SR, mute_span=(12.0, 20.0))
    audio = AudioInput(samples=y, sample_rate=SR)
    beat = beat_analysis_for(120.0, np.arange(0.0, duration, 0.5), SR)

    analysis = analyse_structure(audio, beat, seed=123)
    segments = analysis.segments

    # The ±0.5 s gate on the 12 s mute point.
    internal_starts = np.array([s.start for s in segments[1:]])
    assert np.any(np.abs(internal_starts - 12.0) <= 0.5)

    # Invariants: alphabetic labels, contiguous cover, intro/outro book-ends,
    # confidences in range, novelty curve present.
    assert segments[0].label == "A"
    assert segments[0].category == "intro"
    assert segments[-1].category == "outro"
    ends = np.array([s.end for s in segments[:-1]])
    starts = np.array([s.start for s in segments[1:]])
    np.testing.assert_array_equal(ends, starts)
    assert all(0.0 <= s.confidence <= 1.0 for s in segments)
    assert len(analysis.novelty_curve) > 0


def test_bucket_padding_does_not_contaminate_novelty_tail() -> None:
    """The n_valid-masking contract: a bucket-padded dispatch must produce
    the same novelty/energy_novelty as an exact-shape dispatch. The
    0.5 s-sigma percussive-ratio smoother is the regression surface —
    zeros in the padding used to smear into the last ~2 s of valid
    frames and rescale the whole min-max-normalised curve."""

    import jax
    import jax.numpy as jnp

    from track_analyser_tpu.substrate import bucket_length, full_track_graph

    sr = 22_050
    n = int(9.7 * sr)  # deliberately not a bucket multiple
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    y = 0.2 * np.sin(2 * np.pi * 220.0 * t)
    for b in np.arange(0.25, 9.6, 0.25):  # percussive right up to the end
        s = int(b * sr)
        e = min(n, s + 300)
        y[s:e] += rng.normal(0, 0.4, e - s) * np.exp(-np.arange(e - s) / 60)
    y = y.astype(np.float32)

    nb = bucket_length(n)
    padded = np.zeros(nb, np.float32)
    padded[:n] = y
    g = jax.jit(lambda s, v: full_track_graph(s, v, sr=sr))
    exact = g(jnp.stack([jnp.asarray(y)] * 2), jnp.asarray(n))
    buck = g(jnp.stack([jnp.asarray(padded)] * 2), jnp.asarray(n))
    fv = int(exact["f_valid"])
    for key in ("novelty", "energy_novelty", "onset_env"):
        a = np.asarray(exact[key])[..., :fv]
        b = np.asarray(buck[key])[..., :fv]
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=key)
