"""Numerical parity of the ops tier against independent formulas
(SURVEY.md section 4: each kernel gets a parity test vs the
librosa/scipy/pyloudnorm formula it replaces)."""

from __future__ import annotations

import numpy as np
import pytest
from scipy import ndimage, signal

import jax.numpy as jnp

from track_analyser_tpu.ops import filters, loudness, mel, onset, resample, stft


RNG = np.random.default_rng(42)


def test_stft_matches_direct_dft():
    y = RNG.normal(size=22_050).astype(np.float32)
    spec = np.asarray(stft.stft(jnp.asarray(y), 2048, 512))
    win = stft.hann_window(2048)
    ypad = np.pad(y, 1024)
    for t in (0, 7, 20, 43):
        ref = np.fft.rfft(ypad[t * 512 : t * 512 + 2048] * win)
        np.testing.assert_allclose(spec[:, t], ref, atol=2e-4)


def test_frame_counts():
    assert stft.n_frames(22_050, 512) == 44
    y = jnp.zeros(10_000)
    assert stft.frame_signal(y, 2048, 512).shape == (1 + 10_000 // 512, 2048)


def test_mel_filterbank_covers_band():
    fb = mel.mel_filterbank(22_050, 2048, 128)
    assert fb.shape == (128, 1025)
    # Every interior FFT bin between the first and last mel centre has
    # non-zero total weight; rows are non-negative.
    assert np.all(fb >= 0)
    coverage = fb.sum(axis=0)
    assert np.all(coverage[20:900] > 0)


def test_gaussian_matches_scipy_interior():
    x = RNG.normal(size=777).astype(np.float32)
    for sigma in (1.0, 1.5, 12.0, 43.0):
        mine = np.asarray(filters.gaussian_filter1d(jnp.asarray(x), sigma))
        ref = ndimage.gaussian_filter1d(x.astype(np.float64), sigma=sigma)
        r = int(4 * sigma + 0.5)
        np.testing.assert_allclose(mine[r:-r], ref[r:-r], atol=1e-5)


def test_median_filter_matches_scipy_interior():
    x = RNG.normal(size=(9, 700)).astype(np.float32)
    mine = np.asarray(filters.median_filter_1d(jnp.asarray(x), 31, axis=-1))
    ref = ndimage.median_filter(x, size=(1, 31), mode="reflect")
    np.testing.assert_allclose(mine[:, 15:-15], ref[:, 15:-15], atol=0.0)


def test_autocorrelate_matches_numpy():
    x = RNG.normal(size=1_000)
    mine = np.asarray(onset.autocorrelate(jnp.asarray(x, dtype=jnp.float32)))
    ref = np.correlate(x, x, mode="full")[x.size - 1 :]
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-2)


def test_k_weighting_fir_matches_scipy_lfilter():
    fs = 48_000
    (b1, a1), (b2, a2) = loudness.k_weighting_coeffs(fs)
    x = RNG.normal(size=fs // 2).astype(np.float64)
    ref = signal.lfilter(b2, a2, signal.lfilter(b1, a1, x))
    mine = np.asarray(loudness.k_weighted(jnp.asarray(x, dtype=jnp.float32), fs))
    np.testing.assert_allclose(mine, ref, atol=2e-4)


def test_k_weighting_gain_at_1khz():
    # The BS.1770 cascade reads +0.691 dB at 1 kHz — exactly the -0.691
    # constant in the LUFS formula (so a full-scale 1 kHz sine is
    # -3.01 LUFS).
    fs = 48_000
    t = np.arange(fs) / fs
    x = np.sin(2 * np.pi * 997.0 * t).astype(np.float32)
    y = np.asarray(loudness.k_weighted(jnp.asarray(x), fs))
    gain_db = 20 * np.log10(np.std(y[fs // 4 :]) / np.std(x[fs // 4 :]))
    assert gain_db == pytest.approx(0.691, abs=0.05)


def test_polyphase_matrix_matches_scipy_resample_poly():
    x = RNG.normal(size=4_096).astype(np.float32)
    mine = float(np.asarray(resample.oversampled_peak(jnp.asarray(x), 8)))
    ref = float(np.abs(signal.resample_poly(x, 8, 1)).max())
    assert mine == pytest.approx(ref, rel=1e-4)


def test_power_to_db_top_db_floor():
    s = jnp.asarray([1e-12, 1e-3, 1.0])
    out = np.asarray(mel.power_to_db(s))
    assert out[2] == pytest.approx(0.0)
    assert out[0] == pytest.approx(-80.0)  # floored at max - 80


def test_istft_roundtrip():
    y = RNG.normal(size=8_192).astype(np.float32)
    spec = stft.stft(jnp.asarray(y), 1024, 256)
    rec = np.asarray(stft.istft(spec, 1024, 256, y.size))
    np.testing.assert_allclose(rec, y, atol=1e-4)


def test_istft_f_valid_matches_exact_shape() -> None:
    """istft(f_valid=...) on a bucket-padded spectrogram must reproduce
    the exact-shape inversion bitwise over the valid samples — the
    contract the bucket-padded separation serving path relies on (the
    padding frames' windows must not inflate the overlap-add
    normaliser)."""

    rng = np.random.default_rng(9)
    n_fft, hop = 2048, 512
    n = 70_000  # not a bucket multiple
    y = rng.normal(0, 0.3, n).astype(np.float32)

    exact = np.asarray(stft.istft(stft.stft(jnp.asarray(y), n_fft, hop), n_fft, hop, n))

    nb = 131_072
    padded = np.zeros(nb, np.float32)
    padded[:n] = y
    f_valid = 1 + n // hop
    inv = np.asarray(
        stft.istft(
            stft.stft(jnp.asarray(padded), n_fft, hop),
            n_fft,
            hop,
            nb,
            f_valid=jnp.asarray(f_valid),
        )
    )[:n]
    np.testing.assert_array_equal(inv, exact)
