"""Sequence parallelism: shard one long track's frame axis across chips.

The reference materialises whole tracks in RAM and runs every transform
serially (SURVEY.md section 5 "long-context: none"). Here a track's STFT
frame axis is sharded over the mesh's ``seq`` axis with ``shard_map``:

* per-frame ops (window, FFT, filterbank matmuls, flux) are local;
* the sample framing needs a one-hop halo of ``n_fft - hop`` samples from
  the right neighbour — exchanged with ``ppermute``;
* global reductions (min/max normalisation, gated loudness means) use
  ``psum``/``pmax``/``pmin``;
* Gaussian smoothing exchanges a radius-sized halo in both directions.

This module implements the sharded onset-envelope pipeline (the tempo
substrate) as the reference pattern; the same halo/psum recipe extends to
the other analysers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT_CONFIG
from ..ops.mel import mel_filterbank, power_to_db
from ..ops.stft import frame_signal, hann_window

__all__ = [
    "sharded_onset_envelope",
    "shard_halo_exchange",
    "sharded_track_outputs",
    "analyse_track_sharded",
]


def shard_halo_exchange(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Append the first ``halo`` elements of the right neighbour's shard.

    Last shard receives zeros (matches the zero padding at the track end).
    """

    n_shards = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    head = x[..., :halo]
    # send my head to my LEFT neighbour: perm maps source -> destination
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    from_right = jax.lax.ppermute(head, axis_name, perm)
    from_right = jnp.where(idx == n_shards - 1, jnp.zeros_like(from_right), from_right)
    return jnp.concatenate([x, from_right], axis=-1)


def _local_envelope(
    y_local: jnp.ndarray,
    *,
    sr: int,
    n_fft: int,
    hop: int,
    frames_per_shard: int,
    axis_name: str,
) -> jnp.ndarray:
    """Compute this shard's onset-envelope frames.

    Shard s owns frames [s*F, (s+1)*F). Frame t needs samples
    [t*hop - n_fft/2, t*hop + n_fft/2) of the (conceptually centred-padded)
    signal — i.e. a left overlap of n_fft/2 and right halo of n_fft/2 plus
    one extra frame (hop) for the flux difference.
    """

    shard_id = jax.lax.axis_index(axis_name)
    pad = n_fft // 2

    # Halo: pull enough samples from the right neighbour to complete the
    # last owned frame AND the lag-1 flux reference frame.
    halo = pad + hop
    y_ext = shard_halo_exchange(y_local, halo, axis_name)
    # Left context: first `pad` samples of shard 0 read zeros (centre pad);
    # other shards pull from the left neighbour.
    tail = y_local[..., -pad:]
    n_shards = jax.lax.psum(1, axis_name)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    from_left = jax.lax.ppermute(tail, axis_name, perm)
    from_left = jnp.where(shard_id == 0, jnp.zeros_like(from_left), from_left)
    y_full = jnp.concatenate([from_left, y_ext], axis=-1)

    # Local frames: +1 extra frame for the flux lag. Slice-stack framing
    # (frame_signal's gather-free fast path).
    win = jnp.asarray(hann_window(n_fft))
    frames = frame_signal(y_full, n_fft, hop, center=False)[: frames_per_shard + 1] * win
    spec = jnp.fft.rfft(frames, n=n_fft, axis=-1)
    power = jnp.abs(spec) ** 2
    fb = jnp.asarray(mel_filterbank(sr, n_fft, DEFAULT_CONFIG.n_mels))
    mel_power = jnp.dot(power, fb.T, precision=jax.lax.Precision.HIGHEST)  # (F+1, mels)

    # power_to_db with the GLOBAL max (top_db floor is a global property).
    amin = 1e-10
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, mel_power))
    global_max = jax.lax.pmax(jnp.max(log_spec), axis_name)
    log_spec = jnp.maximum(log_spec, global_max - 80.0)

    flux = jnp.maximum(0.0, log_spec[1:] - log_spec[:-1])  # frame t vs t-1? see below
    env_local = jnp.mean(flux, axis=-1)
    return env_local


def sharded_onset_envelope(
    y: np.ndarray,
    sr: int,
    mesh: Mesh,
    *,
    axis: str = "seq",
    hop: int = 512,
    n_fft: int = 2048,
) -> np.ndarray:
    """Onset envelope of one long track, frame-sharded over ``axis``.

    Pads the signal so each shard owns an equal frame count, runs the
    halo-exchanged local computation, and reassembles + aligns the result
    to match ops.onset.onset_strength_from_mel (same left shift).
    """

    n_shards = mesh.shape[axis]
    n = y.shape[-1]
    total_frames = 1 + n // hop
    frames_per_shard = -(-total_frames // n_shards)
    # Must split into equal per-shard sample chunks: exactly F*hop each.
    # The extra samples the final frame/flux needs come from the halo
    # exchange (zeros on the last shard — the track is zero beyond n).
    padded_samples = frames_per_shard * n_shards * hop
    yp = np.zeros(padded_samples, dtype=np.float32)
    yp[:n] = y

    fn = shard_map(
        partial(
            _local_envelope,
            sr=sr,
            n_fft=n_fft,
            hop=hop,
            frames_per_shard=frames_per_shard,
            axis_name=axis,
        ),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
    )
    # Each shard computes flux for frames [s*F+1, (s+1)*F+1) relative to
    # its own first frame; assembling shards yields flux at 1..total. The
    # envelope convention shifts right by lag + n_fft // (2*hop).
    env_flux = np.asarray(jax.jit(fn)(jnp.asarray(yp)))
    shift = 1 + n_fft // (2 * hop)
    env = np.zeros(total_frames, dtype=np.float64)
    src = env_flux[: max(0, total_frames - shift)]
    env[shift : shift + src.size] = src
    return env


# ---------------------------------------------------------------------------
# Full sequence-sharded track analysis
# ---------------------------------------------------------------------------
#
# One long track, its sample/frame axis split over the ``seq`` mesh axis.
# Each shard computes the substrate on an extended local block (own samples
# plus a +-HALO_FRAMES halo exchanged with ppermute); global
# properties (min/max normalisation scales, gated-loudness thresholds, key
# chroma means, stereo statistics) reduce with psum/pmax/pmin. Framewise
# outputs come back sharded; scalars come back replicated. Numerics match
# substrate.full_track_graph (see tests/test_sharding.py).

def _halo_frames(sr: int, hop: int = 512) -> int:
    """Frames of one-hop halo covering every temporal context in the
    substrate: centre padding (2), flux lag (1), HPSS median (15), MFCC
    context (2 s), ratio gaussian radius (4 sigma of 0.5 s), novelty
    smoothing (7), K-weighting FIR (16384 samples), true-peak taps.
    Rounded up to a multiple of 4 so the coarse chroma grid stays aligned."""

    ratio_radius = int(4.0 * max(1.0, 0.5 * sr / hop) + 0.5)
    context = max(2, int(round(2.0 * sr / hop)))
    kweight = -(-16_384 // hop)
    h = max(ratio_radius, context, kweight) + 48
    return -(-h // 4) * 4


def _exchange_sample_halos(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """[left halo | own | right halo] along the last axis; edges read zeros."""

    n_shards = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm_right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    perm_left = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    from_left = jax.lax.ppermute(x[..., -halo:], axis_name, perm_right)
    from_right = jax.lax.ppermute(x[..., :halo], axis_name, perm_left)
    from_left = jnp.where(idx == 0, jnp.zeros_like(from_left), from_left)
    from_right = jnp.where(idx == n_shards - 1, jnp.zeros_like(from_right), from_right)
    return jnp.concatenate([from_left, x, from_right], axis=-1)


def _masked_pmean(x, mask, axis_name):
    num = jax.lax.psum(jnp.sum(jnp.where(mask, x, 0.0)), axis_name)
    den = jax.lax.psum(jnp.sum(mask.astype(jnp.float32)), axis_name)
    return num / jnp.maximum(den, 1.0)


def _local_track_analysis(
    stereo_local: jnp.ndarray,
    n_valid: jnp.ndarray,
    *,
    sr: int,
    frames_per_shard: int,
    axis_name: str,
    net_params=None,
):
    """Shard-local substrate over the halo-extended block (see module doc).

    Mirrors substrate.full_track_graph stage by stage; every deviation is
    a halo slice or a collective in place of a local reduction. When
    ``net_params`` carries the TCN downbeat checkpoint, every shard runs
    the (tiny) net redundantly over the all-gathered mel features so the
    sharded path reports the same source="rnn" evidence as the fused and
    per-module paths.
    """

    from ..config import DEFAULT_CONFIG as cfg
    from ..ops.chroma import chroma_from_power, chroma_stft_filterbank, cq_chroma_tribank
    from ..ops.filters import gaussian_filter1d, hpss
    from ..ops.loudness import k_weighted
    from ..ops.mel import melspectrogram_from_power, mfcc_from_log_mel, power_to_db
    from ..ops.onset import autocorrelate, onset_strength_from_mel
    from ..ops.resample import oversampled_peak
    from ..ops.spectral import spectral_centroid, spectral_rolloff
    from ..ops.stft import fft_frequencies, magnitude, stft as stft_op

    hop = cfg.hop_length
    n_fft = cfg.n_fft
    hf = _halo_frames(sr, hop)
    fs_own = frames_per_shard
    shard = jax.lax.axis_index(axis_name)

    halo_samples = hf * hop
    stereo_ext = _exchange_sample_halos(stereo_local, halo_samples, axis_name)
    y_ext = jnp.mean(stereo_ext, axis=0)

    # Global frame bookkeeping: own frame j <-> global frame shard*fs + j
    # <-> extended-block frame hf + j.
    f_valid = 1 + n_valid // hop
    own_global = shard * fs_own + jnp.arange(fs_own)
    own_mask = own_global < f_valid  # (fs_own,)
    f_ext = 1 + y_ext.shape[-1] // hop
    ext_global = shard * fs_own - hf + jnp.arange(f_ext)
    ext_valid = (ext_global >= 0) & (ext_global < f_valid)
    own_sel = slice(hf, hf + fs_own)
    own_in_ext = (jnp.arange(f_ext) >= hf) & (jnp.arange(f_ext) < hf + fs_own)
    own_valid_ext = own_in_ext & ext_valid

    out = {}

    # ---- 2048 STFT family (extended block) ----------------------------
    mag = magnitude(y_ext, n_fft, hop, power=1.0)[:, :f_ext]
    power = mag * mag
    mel_fb = mel_filterbank(sr, n_fft, cfg.n_mels)
    mel_power = melspectrogram_from_power(power, mel_fb)

    # Onset envelope: the dB floor (top_db) is relative to the GLOBAL max.
    amin = 1e-10
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, mel_power))
    gmax = jax.lax.pmax(jnp.max(jnp.where(ext_valid[None, :], log_spec, -jnp.inf)), axis_name)
    s_db = jnp.maximum(log_spec, gmax - 80.0)
    flux = jnp.maximum(0.0, s_db[:, 1:] - s_db[:, :-1])
    env_ext = jnp.pad(jnp.mean(flux, axis=0), (1 + n_fft // (2 * hop), 0))[:f_ext]
    # The fused graph's left pad zeroes the first lag + n_fft//(2*hop)
    # frames; shard 0 would otherwise compute flux for pre-start windows.
    env_ext = jnp.where(ext_valid & (ext_global >= 1 + n_fft // (2 * hop)), env_ext, 0.0)
    env_own = jnp.where(own_mask, env_ext[own_sel], 0.0)
    out["onset_env"] = env_own

    # Autocorrelation needs the whole envelope: it is tiny (~4 B/frame),
    # so all-gather it and autocorrelate redundantly on every shard.
    env_full = jax.lax.all_gather(env_own, axis_name).reshape(-1)
    ac_full = autocorrelate(env_full)
    out["autocorr"] = ac_full.reshape(jax.lax.psum(1, axis_name), fs_own)[shard]

    # Accent curves for the downbeat decoder.
    out["beat_energy"] = jnp.where(
        own_mask, jnp.sqrt(jnp.sum(mel_power, axis=0) + 1e-12)[own_sel], 0.0
    )
    n_low = max(2, int(150.0 * n_fft / sr))
    out["low_energy"] = jnp.where(
        own_mask, jnp.sqrt(jnp.sum(power[:n_low], axis=0) + 1e-12)[own_sel], 0.0
    )

    # ---- TCN downbeat activations ---------------------------------------
    # The net is tiny and its dilated receptive field (~3 s) spans shard
    # boundaries, so — like the autocorrelation — gather the mel features
    # and run it redundantly on every shard (same recipe as the fused
    # graph's _net_downbeat_prob, parallel/batch.py).
    if net_params is not None:
        from ..models import downbeat_net

        mel_own = jnp.where(own_mask[None, :], mel_power[:, own_sel], 0.0)
        gathered = jax.lax.all_gather(mel_own, axis_name)  # (S, mels, fs)
        mel_full = jnp.moveaxis(gathered, 0, 1).reshape(mel_own.shape[0], -1)
        feats = power_to_db(mel_full).T  # (T_pad, mels)
        fmask_full = jnp.arange(feats.shape[0]) < f_valid
        count = jnp.maximum(jnp.sum(fmask_full), 1)
        mu = jnp.sum(jnp.where(fmask_full[:, None], feats, 0.0)) / (count * feats.shape[1])
        var = jnp.sum(jnp.where(fmask_full[:, None], (feats - mu) ** 2, 0.0)) / (
            count * feats.shape[1]
        )
        feats = (feats - mu) / (jnp.sqrt(var) + 1e-6)
        logits = downbeat_net.forward(net_params, feats)
        prob = jnp.where(fmask_full, jax.nn.softmax(logits, axis=-1)[:, 2], 0.0)
        out["net_prob"] = prob.reshape(jax.lax.psum(1, axis_name), fs_own)[shard]

    # ---- structure curves ----------------------------------------------
    # The fused graph's median/smoothing stages REFLECT the spectrogram at
    # the global start; shard 0's left halo is zeros (correct for the
    # STFT), so substitute the reflection for the HPSS/ratio chain.
    left_reflect = jnp.flip(mag[:, hf + 1 : 2 * hf + 1], axis=1)
    right_reflect = jnp.flip(mag[:, -(2 * hf + 1) : -(hf + 1)], axis=1)
    n_sh = jax.lax.psum(1, axis_name)
    mag_hpss = jnp.concatenate(
        [
            jnp.where(shard == 0, left_reflect, mag[:, :hf]),
            mag[:, hf:-hf],
            jnp.where(shard == n_sh - 1, right_reflect, mag[:, -hf:]),
        ],
        axis=1,
    )
    harmonic, percussive = hpss(mag_hpss, kernel_size=cfg.hpss_kernel, power=cfg.hpss_power)

    from ..substrate import _minmax_normalise, _smooth_valid

    log_mel = power_to_db(mel_power + 1e-9, top_db=None)
    gmax2 = jax.lax.pmax(jnp.max(jnp.where(ext_valid[None, :], log_mel, -jnp.inf)), axis_name)
    log_mel = jnp.maximum(log_mel, gmax2 - 80.0)
    mfcc_ext = mfcc_from_log_mel(log_mel, cfg.n_mfcc)
    # Self-similarity on the FULL gathered MFCC matrix (n_mfcc x frames,
    # ~50 B/frame — small next to the mel gather above): the substrate's
    # exact chain incl. the _smooth_valid padded-tail treatment, so the
    # two execution paths agree by construction.
    mfcc_own = jnp.where(own_mask[None, :], mfcc_ext[:, own_sel], 0.0)
    mfcc_full = jnp.moveaxis(jax.lax.all_gather(mfcc_own, axis_name), 0, 1).reshape(
        mfcc_own.shape[0], -1
    )
    mfcc_full = _smooth_valid(mfcc_full, f_valid, 1.0)
    t_full = mfcc_full.shape[1]
    context = max(2, int(round(cfg.novelty_context_seconds * sr / float(hop))))
    cs = jnp.concatenate(
        [jnp.zeros((mfcc_full.shape[0], 1)), jnp.cumsum(mfcc_full, axis=1)], axis=1
    )
    fidx = jnp.arange(t_full)
    lo_i = jnp.clip(fidx - context, 0, t_full)
    hi_i = jnp.clip(fidx + context, 0, t_full)
    left_mean = (cs[:, fidx] - cs[:, lo_i]) / jnp.maximum(fidx - lo_i, 1)
    right_mean = (cs[:, hi_i] - cs[:, fidx]) / jnp.maximum(hi_i - fidx, 1)
    ln = left_mean / (jnp.linalg.norm(left_mean, axis=0) + 1e-9)
    rn = right_mean / (jnp.linalg.norm(right_mean, axis=0) + 1e-9)
    sim = 1.0 - jnp.sum(ln * rn, axis=0)
    sim_valid_full = (fidx >= context) & (fidx < f_valid - context)
    sim_full = jnp.where(sim_valid_full, sim, 0.0)

    perc_raw = jnp.sum(percussive, axis=0)
    harm_raw = jnp.sum(harmonic, axis=0)
    perc_col_ext = jnp.where(ext_valid, perc_raw, 0.0)
    harm_col_ext = jnp.where(ext_valid, harm_raw, 0.0)

    # Novelty chain on FULL gathered curves. Each component is 1-D,
    # ~4 B/frame — tiny next to the mel gather above — so every shard
    # all-gathers the three curves and runs the substrate's EXACT code
    # on the exact full-length arrays (including the _smooth_valid
    # treatment of the padded tail). Semantics identical to the fused
    # path by construction, not by halo bookkeeping.
    n_sh_ = jax.lax.psum(1, axis_name)

    def _gather_full(own_curve: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.all_gather(own_curve, axis_name).reshape(-1)

    perc_full = _gather_full(jnp.where(own_mask, perc_raw[own_sel], 0.0))
    harm_full = _gather_full(jnp.where(own_mask, harm_raw[own_sel], 0.0))
    fmask_full = jnp.arange(perc_full.shape[0]) < f_valid

    ratio_full = perc_full / (perc_full + harm_full + 1e-9)
    ratio_sigma = max(1.0, 0.5 * sr / float(hop))
    ratio_smooth = _smooth_valid(ratio_full, f_valid, ratio_sigma)
    energy_novelty_full = jnp.abs(jnp.diff(ratio_smooth, prepend=ratio_smooth[0:1]))

    w_flux, w_sim, w_energy = cfg.novelty_weights
    combined_full = (
        w_flux * _minmax_normalise(env_full, fmask_full)
        + w_sim * _minmax_normalise(sim_full, fmask_full)
        + w_energy * _minmax_normalise(energy_novelty_full, fmask_full)
    )
    novelty_full = jnp.where(
        fmask_full, _smooth_valid(combined_full, f_valid, cfg.novelty_smooth_sigma), 0.0
    )
    out["novelty"] = novelty_full.reshape(n_sh_, fs_own)[shard]
    out["energy_novelty"] = _minmax_normalise(energy_novelty_full, fmask_full).reshape(
        n_sh_, fs_own
    )[shard]
    out["perc_col"] = perc_col_ext[own_sel]
    out["harm_col"] = harm_col_ext[own_sel]

    # ---- features --------------------------------------------------------
    freqs = fft_frequencies(sr, n_fft)
    lt_num = jax.lax.psum(jnp.sum(jnp.where(own_valid_ext[None, :], mag, 0.0), axis=-1), axis_name)
    lt_den = jax.lax.psum(jnp.sum(own_valid_ext.astype(jnp.float32)), axis_name)
    out["ltas"] = lt_num / jnp.maximum(lt_den, 1.0)
    out["centroid"] = jnp.where(own_mask, spectral_centroid(mag, freqs)[own_sel], 0.0)
    out["rolloff"] = jnp.where(
        own_mask, spectral_rolloff(mag, freqs, cfg.rolloff_percent)[own_sel], 0.0
    )

    # ---- harmony ----------------------------------------------------------
    chroma_st = chroma_from_power(power, chroma_stft_filterbank(sr, n_fft))
    # Three-bank CQ chroma over the halo-extended block: the decimation
    # FIR (~400 taps) and the 1.49 s low-bank window both sit far inside
    # the exchanged sample halo, and the extended block starts on a
    # cq_hop multiple (hf % 4 == 0), so the decimated frame grids AND
    # the ::4-sliced family projection stay aligned with the fused
    # graph's.
    chroma_cq_coarse = cq_chroma_tribank(
        y_ext,
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
    rep = cfg.cq_hop // hop
    chroma_cq_ext = jnp.repeat(chroma_cq_coarse, rep, axis=1)[:, :f_ext]
    out["chroma_cq"] = chroma_cq_ext[:, own_sel]

    from ..harmony import MAJOR_PROFILE, MINOR_PROFILE

    major = MAJOR_PROFILE / np.linalg.norm(MAJOR_PROFILE)
    minor = MINOR_PROFILE / np.linalg.norm(MINOR_PROFILE)
    rot = np.stack([np.roll(major, s) for s in range(12)] + [np.roll(minor, s) for s in range(12)])
    scores = jnp.zeros(24)
    for chroma in (chroma_cq_ext, chroma_st):
        csum = jax.lax.psum(
            jnp.sum(jnp.where(own_valid_ext[None, :], chroma, 0.0), axis=-1), axis_name
        )
        cmean = csum / jnp.maximum(lt_den, 1.0)
        norm = jnp.linalg.norm(cmean)
        cnorm = cmean / jnp.where(norm > 0, norm, 1.0)
        score = jnp.dot(jnp.asarray(rot, dtype=jnp.float32), cnorm, precision=jax.lax.Precision.HIGHEST)
        scores = scores + jnp.where(norm > 0, score, 0.0)
    out["key_scores"] = scores

    # ---- spectral balance: folded into the shared 2048 family ---------
    # (matches the fused graph — fractional edge-bin weights, no
    # dedicated balance STFT; the shard sums its own valid frames'
    # spectrum column and psums the three band totals)
    from ..ops.spectral import balance_band_weights

    bal_w = jnp.asarray(balance_band_weights(sr, n_fft))
    bal_col = jnp.sum(jnp.where(own_valid_ext[None, :], mag, 0.0), axis=-1)
    bal_sums = jax.lax.psum(
        jnp.dot(bal_w, bal_col, precision=jax.lax.Precision.HIGHEST), axis_name
    )
    out["balance_total"] = jnp.sum(bal_sums)
    out["balance_low"] = bal_sums[0]
    out["balance_mid"] = bal_sums[1]
    out["balance_high"] = bal_sums[2]

    # ---- loudness -------------------------------------------------------------
    yk_ext = k_weighted(y_ext, sr)
    block_len = int(round(cfg.loudness_block_seconds * sr))
    hop_g = int(round(cfg.loudness_block_seconds * 0.25 * sr))
    own_samples = fs_own * hop
    own_start = shard * own_samples
    # Blocks whose start falls in this shard's own sample range; capacity
    # covers the worst case (+1 for alignment).
    cap = own_samples // hop_g + 1
    block_ids = jnp.arange(cap)
    first_block = (own_start + hop_g - 1) // hop_g
    starts_global = (first_block + block_ids) * hop_g
    starts_local = starts_global - own_start + halo_samples
    block_ok = (
        (starts_global < jnp.minimum((shard + 1) * own_samples, n_valid - block_len + 1))
        & (starts_local + block_len <= yk_ext.shape[-1])
    )
    yk_sq = yk_ext * yk_ext
    cs_k = jnp.concatenate([jnp.zeros(1), jnp.cumsum(yk_sq)])
    z = (cs_k[jnp.clip(starts_local + block_len, 0, cs_k.shape[0] - 1)] - cs_k[jnp.clip(starts_local, 0, cs_k.shape[0] - 1)]) / block_len
    eps = 1e-20
    loud = -0.691 + 10.0 * jnp.log10(z + eps)
    abs_ok = block_ok & (loud > cfg.gate_absolute_lufs)
    z_abs = _masked_pmean(z, abs_ok, axis_name)
    gamma_r = -0.691 + 10.0 * jnp.log10(z_abs + eps) + cfg.gate_relative_lu
    both = abs_ok & (loud > gamma_r)
    out["integrated_lufs"] = -0.691 + 10.0 * jnp.log10(_masked_pmean(z, both, axis_name) + eps)

    # True peak / RMS
    smask_ext = (jnp.arange(y_ext.shape[-1]) >= halo_samples) & (
        jnp.arange(y_ext.shape[-1]) < halo_samples + own_samples
    )
    # Own-range claim via the OUTPUT mask: the interpolator reads the
    # true halo samples, so no zero step is fabricated at internal shard
    # boundaries (zeroing the input rang ~+1 dB on a plateau crossing a
    # boundary — past the ±0.2 dB gate). Own ranges partition the track,
    # so each intersample position is claimed exactly once; padding
    # beyond n_valid is genuinely zero, matching the fused path's
    # end-of-track behaviour.
    peak_local = oversampled_peak(y_ext, cfg.true_peak_oversample, mask=smask_ext)
    out["true_peak"] = jax.lax.pmax(peak_local, axis_name)
    glob_idx = jnp.arange(y_ext.shape[-1]) - halo_samples + own_start
    sval = smask_ext & (glob_idx < n_valid)
    out["rms"] = jnp.sqrt(_masked_pmean(y_ext * y_ext, sval, axis_name))

    # ---- stereo ------------------------------------------------------------
    left, right = stereo_ext[0], stereo_ext[1]
    n_ok = jax.lax.psum(jnp.sum(sval.astype(jnp.float32)), axis_name)
    s_l = jax.lax.psum(jnp.sum(jnp.where(sval, left, 0.0)), axis_name)
    s_r = jax.lax.psum(jnp.sum(jnp.where(sval, right, 0.0)), axis_name)
    s_ll = jax.lax.psum(jnp.sum(jnp.where(sval, left * left, 0.0)), axis_name)
    s_rr = jax.lax.psum(jnp.sum(jnp.where(sval, right * right, 0.0)), axis_name)
    s_lr = jax.lax.psum(jnp.sum(jnp.where(sval, left * right, 0.0)), axis_name)
    nn = jnp.maximum(n_ok, 1.0)
    cov = s_lr - s_l * s_r / nn
    var_l = jnp.maximum(s_ll - s_l * s_l / nn, 0.0)
    var_r = jnp.maximum(s_rr - s_r * s_r / nn, 0.0)
    denom = jnp.sqrt(var_l * var_r)
    out["stereo_corr_centered"] = jnp.where(
        denom > 1e-12, jnp.clip(cov / jnp.where(denom > 1e-12, denom, 1.0), -1.0, 1.0), 1.0
    )
    out["stereo_balance"] = (
        jax.lax.psum(jnp.sum(jnp.where(sval, jnp.abs(left), 0.0)), axis_name)
        - jax.lax.psum(jnp.sum(jnp.where(sval, jnp.abs(right), 0.0)), axis_name)
    ) / nn
    mid_t = 0.5 * (left + right)
    side_t = 0.5 * (left - right)
    out["mid_rms"] = jnp.sqrt(_masked_pmean(mid_t * mid_t, sval, axis_name))
    out["side_rms"] = jnp.sqrt(_masked_pmean(side_t * side_t, sval, axis_name))

    sl = stft_op(left, n_fft, hop)[:, :f_ext]
    sr_spec = stft_op(right, n_fft, hop)[:, :f_ext]
    mid_e = jnp.where(own_valid_ext[None, :], jnp.abs(0.5 * (sl + sr_spec)) ** 2, 0.0)
    side_e = jnp.where(own_valid_ext[None, :], jnp.abs(0.5 * (sl - sr_spec)) ** 2, 0.0)
    freqs_j = jnp.asarray(freqs, dtype=jnp.float32)
    nyq = sr / 2.0
    widths = []
    for lo_f, hi_f in ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq)):
        bmask = (freqs_j >= lo_f) & (freqs_j <= hi_f)
        nb = jnp.maximum(jnp.sum(bmask), 1) * jnp.maximum(lt_den, 1.0)
        m = jax.lax.psum(jnp.sum(jnp.where(bmask[:, None], mid_e, 0.0)), axis_name) / nb
        s = jax.lax.psum(jnp.sum(jnp.where(bmask[:, None], side_e, 0.0)), axis_name) / nb
        widths.append(jnp.where(m <= 1e-12, 0.0, jnp.sqrt(s / jnp.where(m <= 1e-12, 1.0, m))))
    out["stereo_widths"] = jnp.stack(widths)
    out["f_valid"] = f_valid.astype(jnp.float32)
    return out


def sharded_track_outputs(
    stereo: np.ndarray,
    n_valid: int,
    sr: int,
    mesh: Mesh,
    *,
    axis: str = "seq",
):
    """Run the sequence-sharded analysis; returns the substrate output dict
    with framewise arrays reassembled to full length (host side)."""

    hop = 512
    n_shards = mesh.shape[axis]
    total_frames = 1 + int(n_valid) // hop
    # frames per shard: multiple of cq_hop/hop (=4) so the coarse chroma
    # grid aligns with shard boundaries.
    fs = -(-total_frames // n_shards)
    fs = -(-fs // 4) * 4
    hf = _halo_frames(sr, hop)
    if fs < hf:
        raise ValueError(
            f"track too short for {n_shards} seq shards: {fs} frames/shard "
            f"< halo {hf}; use fewer shards or the fused single-device path"
        )
    padded = fs * n_shards * hop
    buf = np.zeros((2, padded), dtype=np.float32)
    buf[:, : stereo.shape[-1]] = stereo[:, :padded]

    from ..parallel.batch import _bundled_net_params

    net_params = _bundled_net_params()
    net_specs = {"net_prob": P(axis)} if net_params is not None else {}

    fn = shard_map(
        partial(
            _local_track_analysis,
            sr=sr,
            frames_per_shard=fs,
            axis_name=axis,
            net_params=net_params,
        ),
        mesh=mesh,
        in_specs=(P(None, axis), P()),
        out_specs={
            **net_specs,
            # framewise, sharded over the frame axis
            "onset_env": P(axis),
            "autocorr": P(axis),
            "beat_energy": P(axis),
            "low_energy": P(axis),
            "novelty": P(axis),
            "energy_novelty": P(axis),
            "perc_col": P(axis),
            "harm_col": P(axis),
            "centroid": P(axis),
            "rolloff": P(axis),
            "chroma_cq": P(None, axis),
            # replicated scalars / vectors
            "ltas": P(),
            "key_scores": P(),
            "balance_total": P(),
            "balance_low": P(),
            "balance_mid": P(),
            "balance_high": P(),
            "integrated_lufs": P(),
            "true_peak": P(),
            "rms": P(),
            "stereo_corr_centered": P(),
            "stereo_balance": P(),
            "mid_rms": P(),
            "side_rms": P(),
            "stereo_widths": P(),
            "f_valid": P(),
        },
        check_vma=False,
    )
    with mesh:
        out = jax.device_get(jax.jit(fn)(jnp.asarray(buf), jnp.asarray(np.int32(n_valid))))
    return out


def analyse_track_sharded(audio, mesh: Mesh, *, axis: str = "seq", seed: int = 13_370):
    """Full TrackAnalysisResult for ONE long track sharded across chips.

    The short-term/momentary RMS curves are the only pieces computed on
    host (simple cumsum framing; their hops do not align with shard
    boundaries and they are O(n) once per track).
    """

    from ..parallel.batch import result_from_graph_outputs

    stereo = (
        audio.stereo_samples
        if audio.stereo_samples is not None
        else np.stack([audio.samples, audio.samples])
    ).astype(np.float32)
    n = int(len(audio.samples))
    out = sharded_track_outputs(stereo, n, audio.sample_rate, mesh, axis=axis)

    # Host: sliding RMS-dB curves via one cumulative sum.
    y = np.asarray(audio.samples, dtype=np.float64)
    cs = np.concatenate([[0.0], np.cumsum(y * y)])

    def rms_db(seconds: float) -> np.ndarray:
        fl = max(1024, int(round(audio.sample_rate * seconds)))
        if fl % 2:
            fl += 1
        hp = max(1, fl // 2)
        pad = fl // 2
        total = 1 + n // hp
        starts = np.arange(total) * hp - pad
        lo = np.clip(starts, 0, n)
        hi = np.clip(starts + fl, 0, n)
        rms = np.sqrt((cs[hi] - cs[lo]) / fl)
        db = 20.0 * np.log10(np.maximum(rms + 1e-9, 1e-5))
        return np.maximum(db, db.max() - 80.0)

    out = dict(out)
    out["short_term_db"] = rms_db(3.0)
    out["momentary_db"] = rms_db(0.4)
    return result_from_graph_outputs(audio, out, seed=seed)
