"""The fused analysis substrate: one XLA graph for a whole track.

The reference re-runs an STFT from raw samples for every analyser (>= 9
redundant STFTs per track — see SURVEY.md section 3.2). Here the ENTIRE
device-side analysis — every spectrogram family, HPSS, novelty, chroma,
key scores, loudness, true peak, LTAS/centroid/rolloff, stereo widths —
is a single jitted function, dispatched once per track (or once per batch
via vmap/pjit in parallel/batch.py). Host code afterwards only runs the
tiny greedy/label logic on kB-sized curves.

Padding contract: tracks are padded with zeros to a bucket length so jit
caches stay warm across a library sweep; ``n_valid`` masks every global
reduction (loudness gating, key chroma means, LTAS/centroid means, stereo
statistics) so padded results match exact-shape results. Framewise curves
are trimmed to the true frame count on host.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_CONFIG
from .ops.chroma import chroma_from_power, chroma_stft_filterbank, cq_chroma_tribank
from .ops.filters import gaussian_filter1d, hpss
from .ops.loudness import integrated_lufs, rms_db_curve
from .ops.mel import (
    mel_filterbank,
    melspectrogram_from_power,
    mfcc_from_log_mel,
    power_to_db,
)
from .ops.onset import autocorrelate, onset_strength_from_mel
from .ops.resample import oversampled_peak
from .ops.spectral import (
    balance_band_weights,
    spectral_centroid,
    spectral_rolloff,
)
from .ops.stft import fft_frequencies, magnitude, n_frames

__all__ = ["full_track_graph", "jitted_full_track_graph", "bucket_length"]


def bucket_length(n: int, *, hop: int = 512, min_bucket: int = 1 << 15) -> int:
    """Pad target: geometric buckets, 8 steps per octave (~9% max
    waste), rounded to hop*128 so frame counts are multiples of 128.

    A finer grid pads less but compiles more bucket executables for a
    length-diverse library; sweeps pre-warm buckets concurrently.
    """

    n = max(n, min_bucket)
    exp = int(np.ceil(8.0 * np.log2(n)))
    candidate = int(np.ceil(2.0 ** (exp / 8.0)))
    quantum = hop * 128
    return int(np.ceil(candidate / quantum)) * quantum


def pad_to_bucket(y: np.ndarray, *, hop: int = 512) -> "tuple[np.ndarray, int]":
    """Zero-pad the last axis to its bucket length (host helper).

    Returns ``(padded, f_valid)`` with ``f_valid = 1 + n // hop`` — the
    one place that formula lives, so per-module graphs, the report
    tempogram and the separation serving path cannot drift apart."""

    y = np.asarray(y, dtype=np.float32)
    n = y.shape[-1]
    padded = np.zeros(y.shape[:-1] + (bucket_length(n, hop=hop),), dtype=np.float32)
    padded[..., :n] = y
    return padded, 1 + n // hop


def _masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis=None) -> jnp.ndarray:
    num = jnp.sum(jnp.where(mask, x, 0.0), axis=axis)
    den = jnp.maximum(jnp.sum(mask, axis=axis), 1)
    return num / den


def _smooth_valid(curve: jnp.ndarray, f_valid, sigma: float) -> jnp.ndarray:
    """Gaussian-smooth a framewise curve as if it ended at ``f_valid``.

    Smoothing a masked curve whose padding is zero smears those zeros
    back into the last ~4*sigma valid frames — an exact-shape run (which
    the reference always is) reflects real values at its end instead.
    The curve is re-indexed so every position at or beyond ``f_valid``
    reads its mirror across the last valid frame, AND the array is
    extended by the kernel radius so the result over ``[0, f_valid)``
    equals the exact-shape reflect-boundary smoothing for ANY padding
    length (a padding shorter than the radius would otherwise let the
    smoother's own array-end reflection leak in). Values at padded
    positions of the returned array are meaningless — callers mask them.
    1-D take of a frame curve is tiny — not a frame-matrix gather."""

    from .ops.filters import gaussian_kernel

    radius = int(gaussian_kernel(float(sigma)).shape[0] // 2)
    total = curve.shape[-1]
    ext_idx = jnp.arange(total + radius)
    idx = jnp.where(
        ext_idx < f_valid,
        jnp.minimum(ext_idx, total - 1),
        jnp.clip(2 * f_valid - 2 - ext_idx, 0, total - 1),
    )
    ext = jnp.take(curve, idx, axis=-1)
    return gaussian_filter1d(ext, sigma=sigma)[..., :total]


def _minmax_normalise(curve: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(mask, curve, big))
    hi = jnp.max(jnp.where(mask, curve, -big))
    span = hi - lo
    out = jnp.where(span < 1e-9, jnp.zeros_like(curve), (curve - lo) / jnp.where(span < 1e-9, 1.0, span))
    return jnp.where(mask, out, 0.0)


def full_track_graph(
    stereo: jnp.ndarray,
    n_valid: jnp.ndarray,
    *,
    sr: int,
) -> Dict[str, jnp.ndarray]:
    """Complete device-side analysis of one (padded) track.

    Args:
      stereo: f32[2, n_padded] channel-major samples, zeros beyond
        n_valid (mono sources duplicate their channel — the host never
        uploads a separate mono buffer; the downmix happens on device.
        The default "ms" transport also ships only the mid channel and
        computes the side-derived width scalars host-side, so this graph
        sees side == 0 there).
      n_valid: true sample count (traced scalar).
      sr: sample rate (static).

    Returns a dict of compact device arrays; see the host finishers in
    pipeline.py / parallel/batch.py for how each is consumed.
    """

    y = 0.5 * (stereo[0] + stereo[1])  # mid == mono downmix
    side = 0.5 * (stereo[0] - stereo[1])
    cfg = DEFAULT_CONFIG
    hop = cfg.hop_length
    n_fft = cfg.n_fft
    total_frames = n_frames(y.shape[-1], hop)
    frame_idx = jnp.arange(total_frames)
    f_valid = 1 + n_valid // hop
    fmask = frame_idx < f_valid

    out: Dict[str, jnp.ndarray] = {"f_valid": f_valid}

    # ---- shared 2048 STFT family -------------------------------------
    # One batched STFT covers the mono family AND the stereo M/S spectra:
    # STFT is linear, so STFT(mid) == 0.5*(STFT(L)+STFT(R)) exactly — three
    # per-channel transforms collapse into a (2, bins, frames) pair.
    ms_mag = magnitude(jnp.stack([y, side]), n_fft, hop, power=1.0)
    mag = ms_mag[0]
    power = mag * mag
    mel_fb = mel_filterbank(sr, n_fft, cfg.n_mels)
    mel_power = melspectrogram_from_power(power, mel_fb)

    # Onset envelope + autocorrelation (tempo substrate). Masked so the
    # autocorrelation equals the exact-shape linear autocorrelation.
    env = onset_strength_from_mel(mel_power, n_fft=n_fft, hop_length=hop)
    env = jnp.where(fmask, env, 0.0)
    out["onset_env"] = env
    out["autocorr"] = autocorrelate(env)

    # Linear accent curves for the downbeat decoder (models/downbeat.py).
    n_low = max(2, int(150.0 * n_fft / sr))
    out["beat_energy"] = jnp.where(fmask, jnp.sqrt(jnp.sum(mel_power, axis=0) + 1e-12), 0.0)
    out["low_energy"] = jnp.where(fmask, jnp.sqrt(jnp.sum(power[:n_low], axis=0) + 1e-12), 0.0)

    # ---- structure: HPSS + combined novelty ---------------------------
    harmonic, percussive = hpss(mag, kernel_size=cfg.hpss_kernel, power=cfg.hpss_power)
    spectral_flux = env  # identical formula (structure.py:195 in reference)

    log_mel = power_to_db(mel_power + 1e-9)
    mfcc = mfcc_from_log_mel(log_mel, cfg.n_mfcc)
    # _smooth_valid, not a plain gaussian: the padding frames' MFCCs sit
    # at the -80 dB mel floor (c0 hundreds of units off), and a plain
    # smooth pulls them into the last ~4 valid frames — frames that
    # valid self-similarity windows DO read.
    mfcc = _smooth_valid(mfcc, f_valid, 1.0)
    context = max(2, int(round(cfg.novelty_context_seconds * sr / float(hop))))
    cs = jnp.concatenate([jnp.zeros((mfcc.shape[0], 1)), jnp.cumsum(mfcc, axis=1)], axis=1)
    lo = jnp.clip(frame_idx - context, 0, total_frames)
    hi = jnp.clip(frame_idx + context, 0, total_frames)
    left_mean = (cs[:, frame_idx] - cs[:, lo]) / jnp.maximum(frame_idx - lo, 1)
    right_mean = (cs[:, hi] - cs[:, frame_idx]) / jnp.maximum(hi - frame_idx, 1)
    ln = left_mean / (jnp.linalg.norm(left_mean, axis=0) + 1e-9)
    rn = right_mean / (jnp.linalg.norm(right_mean, axis=0) + 1e-9)
    sim = 1.0 - jnp.sum(ln * rn, axis=0)
    sim_valid = (frame_idx >= context) & (frame_idx < f_valid - context)
    self_similarity = jnp.where(sim_valid, sim, 0.0)

    perc_col = jnp.where(fmask, jnp.sum(percussive, axis=0), 0.0)
    harm_col = jnp.where(fmask, jnp.sum(harmonic, axis=0), 0.0)
    ratio_curve = perc_col / (perc_col + harm_col + 1e-9)
    # _smooth_valid: sigma here is ~43 frames, so zeros in the padding
    # would otherwise contaminate the last ~2 s of energy_novelty (and,
    # through min-max normalisation, rescale the whole curve) relative
    # to an exact-shape run — violating the n_valid-masking contract.
    ratio_sigma = max(1.0, 0.5 * sr / float(hop))
    ratio_smooth = _smooth_valid(ratio_curve, f_valid, ratio_sigma)
    energy_novelty = jnp.abs(jnp.diff(ratio_smooth, prepend=ratio_smooth[0:1]))

    w_flux, w_sim, w_energy = cfg.novelty_weights
    combined = (
        w_flux * _minmax_normalise(spectral_flux, fmask)
        + w_sim * _minmax_normalise(self_similarity, fmask)
        + w_energy * _minmax_normalise(energy_novelty, fmask)
    )
    out["novelty"] = jnp.where(
        fmask, _smooth_valid(combined, f_valid, cfg.novelty_smooth_sigma), 0.0
    )
    out["energy_novelty"] = _minmax_normalise(energy_novelty, fmask)
    out["perc_col"] = perc_col
    out["harm_col"] = harm_col

    # ---- features: LTAS / centroid / rolloff --------------------------
    freqs = fft_frequencies(sr, n_fft)
    out["ltas"] = _masked_mean(mag, fmask[None, :], axis=-1)
    out["centroid"] = jnp.where(fmask, spectral_centroid(mag, freqs), 0.0)
    out["rolloff"] = jnp.where(
        fmask, spectral_rolloff(mag, freqs, cfg.rolloff_percent), 0.0
    )

    # ---- harmony: chroma projections + key scores ---------------------
    chroma_st = chroma_from_power(power, chroma_stft_filterbank(sr, n_fft))
    chroma_cq = cq_chroma_tribank(
        y,
        mag,
        sr=sr,
        hop=cfg.cq_hop,
        family_n_fft=n_fft,
        family_hop=hop,
        low_n_fft=cfg.cq_low_n_fft,
        mid_n_fft=cfg.cq_mid_n_fft,
        decim=cfg.cq_decim,
        low_octaves=cfg.cq_low_octaves,
        family_octave=cfg.cq_family_octave,
        keep_hz=cfg.cq_keep_hz,
    )
    # Upsample the coarse-hop chroma to hop_length frame indexing. The
    # coarse grid is kept too: the packed transport ships IT (4x fewer
    # readback bytes) and the host repeats identically.
    out["chroma_cq_coarse"] = chroma_cq
    chroma_cq = jnp.repeat(chroma_cq, cfg.cq_hop // hop, axis=1)[:, :total_frames]
    out["chroma_cq"] = chroma_cq

    from .harmony import MAJOR_PROFILE, MINOR_PROFILE  # host constants

    major = MAJOR_PROFILE / np.linalg.norm(MAJOR_PROFILE)
    minor = MINOR_PROFILE / np.linalg.norm(MINOR_PROFILE)
    rot = np.stack(
        [np.roll(major, s) for s in range(12)] + [np.roll(minor, s) for s in range(12)]
    )  # (24, 12)
    scores = jnp.zeros(24)
    for chroma in (chroma_cq, chroma_st):
        cmean = _masked_mean(chroma, fmask[None, :], axis=-1)
        norm = jnp.linalg.norm(cmean)
        cnorm = cmean / jnp.where(norm > 0, norm, 1.0)
        scores = scores + jnp.where(
            norm > 0, jnp.dot(jnp.asarray(rot, dtype=jnp.float32), cnorm, precision=jax.lax.Precision.HIGHEST), 0.0
        )
    out["key_scores"] = scores

    # ---- spectral balance: folded into the shared 2048 family ---------
    # (was its own 4096/1024 STFT, ~8 ms of the fused graph's device
    # budget; fractional edge-bin weights recover the finer transform's
    # band splits — see ops.spectral.balance_band_weights)
    bal_w = jnp.asarray(balance_band_weights(sr, n_fft))
    bal_col = jnp.sum(jnp.where(fmask[None, :], mag, 0.0), axis=-1)  # (bins,)
    bal_sums = jnp.dot(bal_w, bal_col, precision=jax.lax.Precision.HIGHEST)
    out["balance_total"] = jnp.sum(bal_sums)
    out["balance_low"] = bal_sums[0]
    out["balance_mid"] = bal_sums[1]
    out["balance_high"] = bal_sums[2]

    # ---- loudness ------------------------------------------------------
    # ops.loudness.integrated_lufs is the single implementation of the
    # BS.1770 gate (its n_valid parameter exists for exactly this padded
    # dispatch) — keeping a second inline copy here invited silent drift.
    smask = jnp.arange(y.shape[-1]) < n_valid
    block = cfg.loudness_block_seconds
    out["integrated_lufs"] = integrated_lufs(
        y,
        sr,
        block_seconds=block,
        absolute_gate=cfg.gate_absolute_lufs,
        relative_gate_lu=cfg.gate_relative_lu,
        n_valid=n_valid,
    )

    def _rms_params(seconds: float) -> tuple[int, int]:
        fl = max(1024, int(round(sr * seconds)))
        if fl % 2:
            fl += 1
        return fl, max(1, fl // 2)

    st_len, st_hop = _rms_params(cfg.short_term_seconds)
    mo_len, mo_hop = _rms_params(block)
    out["short_term_db"] = rms_db_curve(y, st_len, st_hop)
    out["momentary_db"] = rms_db_curve(y, mo_len, mo_hop)
    out["true_peak"] = oversampled_peak(y, cfg.true_peak_oversample)
    out["rms"] = jnp.sqrt(_masked_mean(y * y, smask))

    # ---- stereo image ---------------------------------------------------
    left, right = stereo[0], stereo[1]
    n_ok = jnp.maximum(jnp.sum(smask), 1)
    lmean = jnp.sum(jnp.where(smask, left, 0.0)) / n_ok
    rmean = jnp.sum(jnp.where(smask, right, 0.0)) / n_ok
    lc = jnp.where(smask, left - lmean, 0.0)
    rc = jnp.where(smask, right - rmean, 0.0)
    denom = jnp.linalg.norm(lc) * jnp.linalg.norm(rc)
    out["stereo_corr_centered"] = jnp.where(
        denom > 1e-12, jnp.clip(jnp.dot(lc, rc, precision=jax.lax.Precision.HIGHEST) / jnp.where(denom > 1e-12, denom, 1.0), -1.0, 1.0), 1.0
    )
    out["stereo_balance"] = _masked_mean(jnp.abs(left), smask) - _masked_mean(
        jnp.abs(right), smask
    )
    # y IS the mid channel, so mid_rms == rms; alias rather than
    # recompute so a reader never wonders whether they may differ.
    out["mid_rms"] = out["rms"]
    out["side_rms"] = jnp.sqrt(_masked_mean(side * side, smask))

    mid_e = jnp.where(fmask[None, :], power, 0.0)
    side_e = jnp.where(fmask[None, :], ms_mag[1] * ms_mag[1], 0.0)
    freqs_j = jnp.asarray(freqs, dtype=jnp.float32)
    nyq = sr / 2.0
    widths = []
    for lo_f, hi_f in ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq)):
        bmask = (freqs_j >= lo_f) & (freqs_j <= hi_f)
        nb = jnp.maximum(jnp.sum(bmask), 1) * jnp.maximum(f_valid, 1)
        m = jnp.sum(jnp.where(bmask[:, None], mid_e, 0.0)) / nb
        s = jnp.sum(jnp.where(bmask[:, None], side_e, 0.0)) / nb
        widths.append(jnp.where(m <= 1e-12, 0.0, jnp.sqrt(s / jnp.where(m <= 1e-12, 1.0, m))))
    out["stereo_widths"] = jnp.stack(widths)

    return out


@partial(jax.jit, static_argnames=("sr",))
def jitted_full_track_graph(stereo, n_valid, *, sr):
    return full_track_graph(stereo, n_valid, sr=sr)


# ---------------------------------------------------------------------------
# Packed transport: every fetched buffer costs a device-to-host round trip,
# so the ~20 output arrays are packed into 4 on device and unpacked on host.
# ---------------------------------------------------------------------------

_CURVE_ROWS = (
    # Framewise rows that must stay f32 end to end. Two former rows were
    # readback dead weight (~7% of sweep readback each):
    # "autocorr" (the host finisher recomputes the autocorrelation in
    # f64 from onset_env for path-bit-identity —
    # tempo.grid_and_bpm_from_env(ac=None) — so the device row was never
    # read, and dropping it from the pack lets XLA DCE the in-graph
    # autocorrelation FFT), and "ltas" (1 + n_fft/2 valid bins padded to
    # the full frame width; it ships in ``vec``).
    #
    # onset_env feeds the BPM regression — f16 readback measurably
    # breaks the fused/per-module 1e-3 BPM agreement (round-3 finding).
    # The two dB loudness curves reach ~-120 dB on gated silence, where
    # f16's RELATIVE step is an ABSOLUTE ~0.06 dB — outside the 2e-2
    # curve agreement — so they stay f32 too. The two accent curves
    # drive sequential DECISION decoders (the downbeat Viterbi and the
    # DP beat tracker) where half-precision noise on the fused path
    # could flip near-tie states the per-module f32 path resolves the
    # other way; 66 KB/track buys exact cross-path agreement.
    "onset_env",
    "short_term_db",
    "momentary_db",
    "beat_energy",
    "low_energy",
)

# Decision-robust rows ship at half precision (these rows + the coarse
# chroma are ~60% of the readback bytes). Per row the narrowest SAFE format:
# f16 (rel ~5e-4) where values are bounded (normalised novelties; Hz
# curves capped at Nyquist 22 050 < f16 max 65 504), bf16 (f32 range,
# rel ~4e-3) for unbounded spectrogram-energy rows that can overflow
# f16. Both are 16-bit; they share one uint16 buffer via bitcast and
# the host reinterprets per row.
_CURVE_ROWS_HALF = (
    ("novelty", "f16"),
    ("energy_novelty", "f16"),
    ("centroid", "f16"),
    ("rolloff", "f16"),
    ("perc_col", "bf16"),
    ("harm_col", "bf16"),
)
_SCALARS = (
    "f_valid",
    "integrated_lufs",
    "true_peak",
    "rms",
    "balance_total",
    "balance_low",
    "balance_mid",
    "balance_high",
    "stereo_corr_centered",
    "stereo_balance",
    "mid_rms",
    "side_rms",
)


def pack_outputs(out: Dict[str, jnp.ndarray]) -> tuple:
    """(curves (3, W) f32, curves_half (8, W) uint16, chroma_coarse
    (12, F/4) f16, vec f32) — 4 buffers instead of ~20, with
    decision-robust rows at half precision (see _CURVE_ROWS_HALF). The
    chroma ships on its native cq_hop grid (the device-side repeat to
    hop resolution is pure redundancy — 4x the bytes for zero
    information); unpack_outputs repeats on host, bit-identically. The
    short LTAS vector (1 + n_fft/2 bins) rides in ``vec`` instead of a
    frame-width row that would be ~94% padding."""

    width = max(
        max(int(out[name].shape[-1]) for name in _CURVE_ROWS),
        max(int(out[name].shape[-1]) for name, _ in _CURVE_ROWS_HALF),
    )

    def _padded(name: str) -> jnp.ndarray:
        x = out[name].astype(jnp.float32)
        return jnp.pad(x, (0, width - x.shape[-1]))

    curves = jnp.stack([_padded(name) for name in _CURVE_ROWS])
    half_rows = []
    for name, kind in _CURVE_ROWS_HALF:
        h = _padded(name).astype(jnp.float16 if kind == "f16" else jnp.bfloat16)
        half_rows.append(jax.lax.bitcast_convert_type(h, jnp.uint16))
    curves_half = jnp.stack(half_rows)
    vec = jnp.concatenate(
        [
            jnp.stack([out[name].astype(jnp.float32) for name in _SCALARS]),
            out["stereo_widths"].astype(jnp.float32),
            out["key_scores"].astype(jnp.float32),
            out["ltas"].astype(jnp.float32),
        ]
    )
    # chroma is inf-normalised per frame (values in [0, 1]): f16-safe.
    # Key decisions do NOT ride this buffer — key_scores are computed on
    # device in f32 and ship in vec; the chroma feeds beat-synchronous
    # chord templates, whose margins dwarf 5e-4.
    return curves, curves_half, out["chroma_cq_coarse"].astype(jnp.float16), vec


def unpack_outputs(
    curves: np.ndarray,
    curves_half: np.ndarray,
    chroma_coarse: np.ndarray,
    vec: np.ndarray,
) -> Dict[str, np.ndarray]:
    import ml_dtypes

    out: Dict[str, np.ndarray] = {
        name: np.asarray(curves[i]) for i, name in enumerate(_CURVE_ROWS)
    }
    half = np.ascontiguousarray(curves_half)
    for i, (name, kind) in enumerate(_CURVE_ROWS_HALF):
        view = half[i].view(np.float16 if kind == "f16" else ml_dtypes.bfloat16)
        out[name] = view.astype(np.float32)
    rep = DEFAULT_CONFIG.cq_hop // DEFAULT_CONFIG.hop_length
    total_frames = curves.shape[-1]
    out["chroma_cq"] = np.repeat(
        np.asarray(chroma_coarse).astype(np.float32), rep, axis=1
    )[:, :total_frames]
    for i, name in enumerate(_SCALARS):
        out[name] = np.asarray(vec[i])
    out["stereo_widths"] = np.asarray(vec[len(_SCALARS) : len(_SCALARS) + 3])
    out["key_scores"] = np.asarray(vec[len(_SCALARS) + 3 : len(_SCALARS) + 27])
    out["ltas"] = np.asarray(vec[len(_SCALARS) + 27 :])
    return out
