"""Stem separation (drums / bass / other / vocals).

The reference's stem path is an optional torch+demucs download
(analysis/stems.py:26-61) that silently degrades to ``None``. This
framework ships a dependency-free, fully deterministic DSP separator that
always works on the device: HPSS soft masks plus band-limited mid/side masking,
inverted back to audio with the jitted ISTFT. A trainable neural separator
(models/separation.py resolving a pure-JAX band-split mask net checkpoint,
models/separation_net.py) can override it when a checkpoint is available;
any failure falls back to ``None`` exactly like the reference ladder.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_SEED
from ..io.codecs import write_wav
from ..ops.filters import hpss
from ..ops.stft import fft_frequencies, istft, stft

__all__ = ["StemBundle", "separate_stems", "separate_stems_arrays"]

_N_FFT = 4096
_HOP = 1024


@dataclass(slots=True)
class StemBundle:
    stems: Dict[str, Path]
    model_name: str


# Vocals/other split of the harmonic mid band by per-bin temporal
# modulation: voice is syllabically amplitude-modulated (high coefficient
# of variation of |S| over time), pads/organs/keys are steady (low CV).
# Threshold/slope grid-searched on the three eval synthesis families
# (scripts/sweep_blend_weights.py families): theta 0.8 lifted the DSP
# "other" stem from the noise floor (-78..-99 dB SI-SDR — the old mask
# routed ALL harmonic mid content to vocals) to -9.5/-8.7/+13.3 dB.
_MOD_THETA = 0.8
_MOD_SLOPE = 4.0


def _dsp_separate_body(y: jnp.ndarray, *, sr: int, n_samples: int, f_valid=None):
    """Mask-based 4-stem split of one channel; returns (4, n) audio.

    ``f_valid`` masks bucket padding out of the modulation statistics and
    the ISTFT normaliser so mixed-length serving shares one executable
    per bucket."""

    spec = stft(y, _N_FFT, _HOP)
    mag = jnp.abs(spec)
    harm, perc = hpss(mag, kernel_size=31, power=2.0)
    total = jnp.maximum(mag, 1e-10)
    mask_perc = perc / total
    mask_harm = harm / total

    freqs = jnp.asarray(fft_frequencies(sr, _N_FFT), dtype=jnp.float32)[:, None]
    low = (freqs < 250.0).astype(jnp.float32)
    mid_band = ((freqs >= 250.0) & (freqs < 8000.0)).astype(jnp.float32)

    if f_valid is None:
        fmask = jnp.ones(harm.shape[1], dtype=bool)[None, :]
        count = jnp.float32(harm.shape[1])
    else:
        fmask = (jnp.arange(harm.shape[1]) < f_valid)[None, :]
        count = jnp.maximum(f_valid.astype(jnp.float32), 1.0)
    hv = jnp.where(fmask, harm, 0.0)
    mu = jnp.sum(hv, axis=1, keepdims=True) / count
    sd = jnp.sqrt(jnp.sum(jnp.where(fmask, (harm - mu) ** 2, 0.0), axis=1, keepdims=True) / count)
    cv = sd / (mu + 1e-8)
    w_voc = jax.nn.sigmoid((cv - _MOD_THETA) * _MOD_SLOPE)

    m_drums = mask_perc
    m_bass = mask_harm * low
    m_vocals = mask_harm * mid_band * w_voc
    m_other = jnp.clip(1.0 - (m_drums + m_bass + m_vocals), 0.0, 1.0)

    stems = []
    for mask in (m_drums, m_bass, m_other, m_vocals):
        stems.append(istft(spec * mask, _N_FFT, _HOP, n_samples, f_valid=f_valid))
    return jnp.stack(stems)


@partial(jax.jit, static_argnames=("sr", "n_samples"))
def _dsp_separate_graph(y: jnp.ndarray, *, sr: int, n_samples: int, f_valid=None):
    return _dsp_separate_body(y, sr=sr, n_samples=n_samples, f_valid=f_valid)


@partial(jax.jit, static_argnames=("sr", "n_samples"))
def _dsp_separate_graph_multi(y: jnp.ndarray, *, sr: int, n_samples: int, f_valid=None):
    """(C, n) channels -> (C, 4, n): stereo-native DSP separation."""

    return jax.vmap(
        partial(_dsp_separate_body, sr=sr, n_samples=n_samples, f_valid=f_valid)
    )(y)


# Per-stem neural weight for the neural/DSP blend. Grid-searched
# (scripts/sweep_blend_weights.py) with the bundled v5 checkpoint over
# w in {0,.25,.5,.75,1} on all FOUR eval synthesis families; the v4-era
# weights remain the per-stem argmax for v5 too. SI-SDR dB (blend,
# held-out/OOD/OOD3/OOD4):
#   drums  w=.25: 4.56 / 8.48 / 1.92 / 5.65  (best mean AND safest
#          worst-family among w>0; pure-net OOD3 is positive vs mixture
#          now, but DSP still carries 6 dB more there)
#   bass   w=.50: 12.91 / 6.15 / 9.89 / 5.87 (w=.75 mean +0.05 dB but
#          two families dip — not worth the churn)
#   other  w=.25: 2.99 / -0.41 / 10.42 / -7.94 (w=.25 keeps the OOD3
#          DSP strength while fixing DSP's held-out/OOD weakness)
#   vocals w=.75: -2.54 / -12.00 / -11.00 / -25.26 (neural dominates;
#          the .25 DSP share still buys +5 dB on OOD4 formant vowels)
# With these weights every served stem beats the input mixture on every
# family, and — new with v5 — the PURE NET (w=1) does too (Δmix
# +1.7..+14.1 dB; RUNBOOK "Separation v5"), so the blend is insurance,
# not the thing carrying any cell.
_BLEND_NEURAL_WEIGHT = {"drums": 0.25, "bass": 0.5, "other": 0.25, "vocals": 0.75}


def _blend_with_dsp(
    neural: Dict[str, np.ndarray], samples: np.ndarray, sample_rate: int
) -> Dict[str, np.ndarray]:
    """Combine neural and DSP stem estimates with per-stem weights."""

    if all(w >= 1.0 for w in _BLEND_NEURAL_WEIGHT.values()):
        return neural
    dsp = separate_stems_arrays(samples, sample_rate)
    out: Dict[str, np.ndarray] = {}
    for name, est in neural.items():
        w = _BLEND_NEURAL_WEIGHT.get(name, 1.0)
        out[name] = est if w >= 1.0 else (w * est + (1.0 - w) * dsp[name]).astype(np.float32)
    return out


def separate_stems_arrays(
    samples: np.ndarray, sample_rate: int
) -> Dict[str, np.ndarray]:
    """Separate a signal into named stems (in-memory API).

    ``samples`` may be mono (n,) -> stems of shape (n,), or channel-major
    multi-channel (C, n) -> stereo-native stems of shape (C, n) (parity
    with demucs' stereo-in/stereo-out behaviour, reference
    analysis/stems.py:46-57)."""

    from ..substrate import pad_to_bucket

    arr = np.asarray(samples, dtype=np.float32)
    n = int(arr.shape[-1])
    # Bucket-pad with f_valid masking: one compiled executable per bucket
    # across a mixed-length library instead of one per track length.
    padded, fv = pad_to_bucket(arr, hop=_HOP)
    nb = padded.shape[-1]
    y = jnp.asarray(padded)
    f_valid = jnp.asarray(np.int32(fv))
    names = ["drums", "bass", "other", "vocals"]
    if y.ndim == 2:
        out = np.asarray(
            _dsp_separate_graph_multi(y, sr=sample_rate, n_samples=nb, f_valid=f_valid),
            dtype=np.float32,
        )[..., :n]  # (C, 4, n)
        return {s: out[:, i] for i, s in enumerate(names)}
    out = np.asarray(
        _dsp_separate_graph(y, sr=sample_rate, n_samples=nb, f_valid=f_valid),
        dtype=np.float32,
    )[..., :n]
    return dict(zip(names, out))


def separate_stems(
    audio_path: Optional[str],
    output_dir: "Optional[str | Path]",
    *,
    seed: int = DEFAULT_SEED,
) -> Optional[StemBundle]:
    """Write drums/bass/other/vocals WAVs next to the analysis artefacts.

    Mirrors the reference contract (stems.py:26-61): ``None`` when there is
    no source path or on any failure; otherwise a :class:`StemBundle` of
    written stem paths.
    """

    if audio_path is None:
        return None

    out_dir = Path(output_dir) if output_dir is not None else Path.cwd() / "stems"
    out_dir.mkdir(parents=True, exist_ok=True)

    try:
        from ..io.loader import load_audio

        # Stereo-in/stereo-out (demucs parity, reference
        # analysis/stems.py:46-57): stereo sources separate per channel
        # and write 2-channel stem WAVs; mono sources keep the mono path.
        samples, sample_rate, _meta = load_audio(audio_path, mono=False)
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 2 and samples.shape[0] == 1:
            samples = samples[0]

        # Neural path first when a trained checkpoint exists; percussive
        # stems blend with the DSP estimates (see _blend_with_dsp).
        model_name = "hpss-dsp-v1"
        stems: Optional[Dict[str, np.ndarray]] = None
        try:
            from ..models import separation as separation_model

            if separation_model.available():
                stems = separation_model.separate(samples, sample_rate, seed=seed)
                model_name = separation_model.model_name()
        except Exception:
            stems = None
        if stems is None:
            stems = separate_stems_arrays(samples, sample_rate)
        else:
            stems = _blend_with_dsp(stems, samples, sample_rate)

        stem_paths: Dict[str, Path] = {}
        for name, data in stems.items():
            path = out_dir / f"{Path(audio_path).stem}_{name}.wav"
            write_wav(path, data, sample_rate, subtype="PCM_16")
            stem_paths[name] = path
        return StemBundle(stems=stem_paths, model_name=model_name)
    except Exception:
        return None
