"""Loudness accuracy gates: a −18 dBFS RMS sine must measure −18.0 ±0.3
LUFS integrated and its true peak must land within ±0.2 dB of theory —
the reference project's published tolerances
(/root/reference/tests/test_loudness.py:33-55) — enforced against the
first-party gated BS.1770 graph."""

from __future__ import annotations

import numpy as np
import pytest

from synth import sine_at_rms_db
from track_analyser_tpu.analysis.loudness import (
    analyse_loudness,
    measure_loudness,
    true_peak_dbtp,
)
from track_analyser_tpu.utils import AudioInput


@pytest.mark.parametrize("sr", [44_100, 48_000])
def test_integrated_lufs_of_calibrated_sine(sr: int) -> None:
    tone = sine_at_rms_db(-18.0, 1000.0, 1.0, sr)
    integrated, short_term, momentary, _lra = measure_loudness(tone, sr)
    assert integrated == pytest.approx(-18.0, abs=0.3)
    assert short_term and momentary  # the sliding curves exist


def test_true_peak_matches_theory_after_oversampling() -> None:
    sr = 44_100
    tone = sine_at_rms_db(-18.0, 1000.0, 1.0, sr)
    theoretical = 20.0 * np.log10(float(np.max(np.abs(tone))))
    assert true_peak_dbtp(tone, sr, oversample=8) == pytest.approx(
        theoretical, abs=0.2
    )


def test_analyse_loudness_agrees_with_its_helpers() -> None:
    sr = 48_000
    tone = sine_at_rms_db(-18.0, 1000.0, 1.0, sr)
    result = analyse_loudness(AudioInput(samples=tone, sample_rate=sr), seed=0)

    integrated, short_term, momentary, lra = measure_loudness(tone, sr)
    assert result.integrated_lufs == pytest.approx(integrated, abs=1e-6)
    assert result.short_term_lufs == short_term
    assert result.momentary_lufs == momentary
    assert result.loudness_range == pytest.approx(lra, abs=1e-6)
    assert result.true_peak_dbfs == pytest.approx(true_peak_dbtp(tone, sr), abs=1e-6)


def test_k_weighting_overlap_save_matches_direct_convolution() -> None:
    """k_weighted switches to overlap-save above 4 blocks (131 072
    samples); the blocked path must equal the direct FIR convolution to
    f32 rounding across block boundaries and the ragged tail."""

    import jax.numpy as jnp

    from track_analyser_tpu.ops.loudness import k_weighted, k_weighting_fir

    sr = 44_100
    rng = np.random.default_rng(7)
    n = 200_001  # > 4 * 32768, not a block multiple
    y = rng.normal(0.0, 0.25, n).astype(np.float32)
    blocked = np.asarray(k_weighted(jnp.asarray(y), sr))
    h = k_weighting_fir(sr).astype(np.float64)
    direct = np.convolve(y.astype(np.float64), h)[:n]
    np.testing.assert_allclose(blocked, direct, atol=2e-4)


def test_absolute_gate_ignores_appended_silence() -> None:
    """BS.1770 gating: trailing silence must not drag integrated LUFS down."""

    sr = 48_000
    tone = sine_at_rms_db(-18.0, 1000.0, 2.0, sr)
    padded = np.concatenate([tone, np.zeros(2 * sr, dtype=np.float32)])
    integrated, *_ = measure_loudness(padded, sr)
    assert integrated == pytest.approx(-18.0, abs=0.4)
