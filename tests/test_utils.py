"""coerce_audio normalisation ladder (reference: utils.py:73-146)."""

from __future__ import annotations

import numpy as np
import pytest

from track_analyser_tpu.io import write_wav
from track_analyser_tpu.utils import AudioInput, coerce_audio, deterministic_rng, seed_everything


def test_coerce_ndarray_mono():
    y = np.sin(np.linspace(0, 10, 1000)).astype(np.float32)
    audio = coerce_audio(y)
    assert audio.sample_rate == 44_100
    assert audio.stereo_samples is None
    np.testing.assert_array_equal(audio.samples, y)


def test_coerce_ndarray_stereo_downmixes():
    stereo = np.stack([np.ones(100), np.zeros(100)]).astype(np.float32)
    audio = coerce_audio(stereo)
    assert audio.stereo_samples is not None
    np.testing.assert_allclose(audio.samples, 0.5 * np.ones(100))


def test_coerce_tuple_resamples():
    sr_in = 22_050
    y = np.sin(2 * np.pi * 440 * np.linspace(0, 1, sr_in, endpoint=False)).astype(
        np.float32
    )
    audio = coerce_audio((y, sr_in))
    assert audio.sample_rate == 44_100
    assert abs(len(audio.samples) - 44_100) <= 2


def test_coerce_audio_input_resamples():
    src = AudioInput(
        samples=np.zeros(22_050, dtype=np.float32), sample_rate=22_050, path="x.wav"
    )
    audio = coerce_audio(src)
    assert audio.sample_rate == 44_100
    assert audio.path == "x.wav"
    assert abs(audio.duration - 1.0) < 0.01


def test_coerce_path(tmp_path):
    y = 0.5 * np.sin(2 * np.pi * 440 * np.linspace(0, 0.2, 8_820, endpoint=False))
    p = tmp_path / "t.wav"
    write_wav(p, y.astype(np.float32), 44_100, subtype="FLOAT")
    audio = coerce_audio(p)
    assert audio.path == str(p)
    assert audio.sample_rate == 44_100
    np.testing.assert_allclose(audio.samples, y, atol=1e-6)


def test_coerce_rejects_unknown_type():
    with pytest.raises(TypeError, match="Unsupported audio source"):
        coerce_audio({"not": "audio"})


def test_seeding_helpers():
    seed_everything(123)
    a = np.random.rand(3)
    seed_everything(123)
    b = np.random.rand(3)
    np.testing.assert_array_equal(a, b)

    r1 = deterministic_rng(7).normal(size=4)
    r2 = deterministic_rng(7).normal(size=4)
    np.testing.assert_array_equal(r1, r2)


def test_compile_cache_honours_environment_variable(monkeypatch, tmp_path) -> None:
    """With JAX_COMPILATION_CACHE_DIR set, the program configures no cache
    of its own: JAX's setting stands and no checkout directory appears."""

    import jax

    from track_analyser_tpu import utils

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    monkeypatch.setattr(utils, "CACHE_DIR", tmp_path / "checkout_cache")
    before = jax.config.jax_compilation_cache_dir
    utils.enable_persistent_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "checkout_cache").exists()


def test_compile_cache_defaults_to_fixed_path_inside_checkout(monkeypatch) -> None:
    from pathlib import Path

    import jax

    from track_analyser_tpu import utils

    root = Path(utils.__file__).resolve().parents[1]
    assert utils.CACHE_DIR == root / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        utils.enable_persistent_compilation_cache()
        first = jax.config.jax_compilation_cache_dir
        utils.enable_persistent_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == first == str(root / ".jax_cache")
        assert Path(first).is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
