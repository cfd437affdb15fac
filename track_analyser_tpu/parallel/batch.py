"""Batched, multi-chip library analysis — the throughput entry point.

The reference analyses one track per call on one CPU thread
(pipeline.py:32-120). This module adds the missing batch call stack
(SURVEY.md section 3.5): host decode workers -> padded device batch ->
ONE pjit'd analysis graph vmapped over tracks and sharded over the
``data`` mesh axis -> per-track host finishers / artefact writers.

Also exposes ``analyse_track_fused`` — single-track analysis through the
same fused graph (one device dispatch per track instead of ~10), used by
bench.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import features as features_mod
from .. import harmony as harmony_mod
from .. import stereo as stereo_mod
from .. import tempo as tempo_mod
from ..analysis import beats as beats_mod
from ..analysis import loudness as loudness_mod
from ..analysis import structure as structure_mod
from ..config import DEFAULT_CONFIG, DEFAULT_SEED
from ..models import downbeat as downbeat_model
from ..pipeline import TrackAnalysisResult
from ..substrate import bucket_length, full_track_graph, pack_outputs, unpack_outputs
from ..utils import AudioInput, coerce_audio, deterministic_rng
from .mesh import data_sharding, make_mesh

__all__ = [
    "analyse_track_fused",
    "analyse_library",
    "result_from_graph_outputs",
    "ms_bucket_length",
    "TrackFailure",
    "SkippedTrack",
]


from dataclasses import dataclass


@dataclass(slots=True)
class TrackFailure:
    """Per-source failure record returned by :func:`analyse_library`.

    The reference's pipeline raises on the single track it is given; a
    library sweep instead isolates the failure (SURVEY.md §5 failure
    handling) — but must still report it to the caller, not only to the
    manifest."""

    source: str
    error: str


@dataclass(slots=True)
class SkippedTrack:
    """Marker for a source this process did not analyse: the manifest
    already lists it as completed in an earlier (resumed) sweep
    (``reason="manifest"``), or a multi-process sweep assigned it to a
    different shard (``reason="other-shard"``)."""

    source: str
    reason: str = "manifest"

# Bucket executables already seeded by a prewarm dispatch this process
# (keys: transport, target_sr, mesh device ids, bucket length, payload
# arity). Compiled executables live in the jit cache for the process
# lifetime, so warming is once-per-process, not once-per-sweep.
_WARMED_EXECUTABLES: set = set()


def _rms_hop(sr: int, seconds: float) -> int:
    fl = max(1024, int(round(sr * seconds)))
    if fl % 2:
        fl += 1
    return max(1, fl // 2)


def result_from_graph_outputs(
    audio: AudioInput,
    out: Dict[str, np.ndarray],
    *,
    seed: int = DEFAULT_SEED,
) -> TrackAnalysisResult:
    """Assemble a TrackAnalysisResult from fused-graph outputs (host)."""

    sr = audio.sample_rate
    n = len(audio.samples)
    hop = DEFAULT_CONFIG.hop_length
    f_valid = 1 + n // hop
    duration = n / float(sr)
    rng = deterministic_rng(seed)

    env = np.asarray(out["onset_env"], dtype=np.float64)[:f_valid]

    # --- beats (ac=None -> shared f64 host autocorrelation) --------------
    grid, bpm = tempo_mod.grid_and_bpm_from_env(env, None, duration, sr, hop_length=hop)
    tracked_times = tempo_mod.track_beats(
        env,
        sr,
        hop_length=hop,
        bpm=bpm,
        low_energy=np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
    )
    beat_result = beats_mod.build_beat_analysis(
        bpm, grid["time"].to_numpy(), sr, hop_length=hop, grid=grid,
        tracked_times=tracked_times,
    )

    # --- downbeats (accent + optional net evidence over fused curves) ----
    net_prob = out.get("net_prob")
    if net_prob is not None:
        net_prob = np.asarray(net_prob, dtype=np.float64)[:f_valid]
    # The downbeat TIME BASE is the drift-following tracked beats when
    # the tracker produced a sane sequence (the reference's madmom path
    # emits DBN-tracked beats, analysis/beats.py:128-133, so its
    # downbeat times follow tempo changes too); the constant grid stays
    # the fallback and the gated beat_times surface either way.
    db_base = (
        tracked_times
        if tracked_times is not None and len(tracked_times) >= 8
        else np.asarray(beat_result.beat_times, dtype=float)
    )
    tracked = downbeat_model.decode_from_accent(
        np.asarray(out["beat_energy"], dtype=np.float64)[:f_valid],
        np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
        np.asarray(db_base, dtype=float),
        sr,
        flux=env,
        net_prob=net_prob,
        chroma=np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid],
    )
    if tracked is not None and tracked.downbeat_times:
        downbeat_result = beats_mod.DownbeatAnalysis(
            downbeat_times=tracked.downbeat_times,
            beat_positions=tracked.beat_positions,
            source=tracked.source,
        )
    else:
        downbeat_result = beats_mod._fallback_downbeats(beat_result)

    # --- structure --------------------------------------------------------
    structure_result = structure_mod.segments_from_curves(
        np.asarray(out["novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["energy_novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["perc_col"], dtype=np.float64)[:f_valid],
        np.asarray(out["harm_col"], dtype=np.float64)[:f_valid],
        beat_result,
        sample_rate=sr,
        hop_length=hop,
        duration=duration,
    )

    # --- loudness ----------------------------------------------------------
    st_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.short_term_seconds)
    mo_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.loudness_block_seconds)
    short_term = np.asarray(out["short_term_db"], dtype=float)[:st_n]
    momentary = np.asarray(out["momentary_db"], dtype=float)[:mo_n]
    lra = float(np.percentile(momentary, 95) - np.percentile(momentary, 5))
    loudness_result = loudness_mod.LoudnessAnalysis(
        integrated_lufs=float(out["integrated_lufs"]),
        short_term_lufs=short_term.tolist(),
        momentary_lufs=momentary.tolist(),
        loudness_range=lra,
        true_peak_dbfs=float(20.0 * np.log10(float(out["true_peak"]) + 1e-12)),
        rms_dbfs=float(20.0 * np.log10(float(out["rms"]) + 1e-12)),
    )

    # --- harmony -------------------------------------------------------------
    keys = [f"{p} major" for p in harmony_mod.PITCH_CLASS_NAMES]
    keys += [f"{p} minor" for p in harmony_mod.PITCH_CLASS_NAMES]
    key_result = harmony_mod._keys_from_scores(
        np.asarray(out["key_scores"], dtype=np.float64), keys
    )
    chroma_cq = np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid]
    chord_hints = harmony_mod._estimate_chords(chroma_cq, beat_result, rng)
    change_points = harmony_mod._detect_chord_changes(chroma_cq, beat_result, chord_hints)

    total = float(out["balance_total"])
    if total > 0:
        balance = harmony_mod.SpectralBalance(
            low_band=float(out["balance_low"]) / total,
            mid_band=float(out["balance_mid"]) / total,
            high_band=float(out["balance_high"]) / total,
        )
    else:
        balance = harmony_mod.SpectralBalance(0.0, 0.0, 0.0)

    if audio.stereo_samples is None:
        stereo_image = harmony_mod.StereoImage(correlation=1.0, balance=0.0)
    else:
        stereo_image = harmony_mod.StereoImage(
            correlation=float(out["stereo_corr_centered"]),
            balance=float(out["stereo_balance"]),
        )

    start_offset = (
        downbeat_result.downbeat_times[0]
        if downbeat_result and downbeat_result.downbeat_times
        else (beat_result.beat_times[0] if beat_result.beat_times else 0.0)
    )
    hook = harmony_mod._generate_midi(
        chroma_cq, beat_result, key_result.best, rng, name="hook", start_offset=start_offset
    )
    bass = harmony_mod._generate_midi(
        chroma_cq,
        beat_result,
        key_result.best,
        rng,
        name="bass",
        octave=-1,
        start_offset=start_offset,
    )
    harmonic_result = harmony_mod.HarmonyAnalysis(
        spectral_balance=balance,
        stereo_image=stereo_image,
        primary_key=key_result.best,
        secondary_key=key_result.second_best,
        chord_hints=chord_hints,
        chord_change_points=change_points,
        hook_suggestion=hook,
        bass_suggestion=bass,
    )

    # --- features ----------------------------------------------------------
    from ..ops.stft import fft_frequencies

    features_result = features_mod.FeatureAnalysis(
        ltas=features_mod.LongTermAverageSpectrum(
            frequencies=fft_frequencies(sr, DEFAULT_CONFIG.n_fft),
            # packed transport pads curve rows to a common width
            magnitude=np.asarray(out["ltas"], dtype=np.float64)[
                : 1 + DEFAULT_CONFIG.n_fft // 2
            ],
        ),
        spectral_centroid=features_mod.FeatureSeries(
            values=np.asarray(out["centroid"], dtype=np.float64)[:f_valid]
        ),
        spectral_rolloff=features_mod.FeatureSeries(
            values=np.asarray(out["rolloff"], dtype=np.float64)[:f_valid]
        ),
    )

    # --- stereo ----------------------------------------------------------
    widths = np.asarray(out["stereo_widths"], dtype=np.float64)
    stereo_result = stereo_mod.StereoAnalysis(
        mid_rms=float(out["mid_rms"]),
        side_rms=float(out["side_rms"]),
        correlation=float(out["stereo_corr_centered"]),
        width=stereo_mod.StereoWidthBands(
            low=float(widths[0]), mid=float(widths[1]), high=float(widths[2])
        ),
    )

    return TrackAnalysisResult(
        audio=audio,
        beat=beat_result,
        downbeat=downbeat_result,
        structure=structure_result,
        loudness=loudness_result,
        harmonic=harmonic_result,
        features=features_result,
        stereo=stereo_result,
    )


_scratch_local = threading.local()


def _scratch(key: str, shape: tuple, dtype) -> np.ndarray:
    """Per-thread reusable buffer. On this class of host (often a single
    vCPU) repeated large allocations pay real page-fault time per track;
    a warm scratch turns pad+quantise into pure copy passes."""

    store = getattr(_scratch_local, "store", None)
    if store is None:
        store = _scratch_local.store = {}
    buf = store.get(key)
    if buf is None or buf.shape != shape or buf.dtype != dtype:
        buf = store[key] = np.empty(shape, dtype=dtype)
    return buf


def _pad_track(audio: AudioInput, n_bucket: int) -> tuple[np.ndarray, int]:
    """Channel-major (2, n_bucket) payload in a per-thread scratch; mono
    tracks duplicate their channel on host only when no stereo exists
    (the device downmix mean(stereo) then reproduces the mono signal
    exactly). Callers must consume/copy the buffer before the same thread
    pads its next track."""

    n = len(audio.samples)
    stereo = _scratch("pad_f32", (2, n_bucket), np.float32)
    if audio.stereo_samples is not None and audio.stereo_samples.ndim == 2:
        stereo[:, :n] = audio.stereo_samples[:2, :n]
    else:
        stereo[0, :n] = audio.samples
        stereo[1, :n] = audio.samples
    stereo[:, n:] = 0.0
    return stereo, n


def _net_downbeat_prob(y: jnp.ndarray, n_valid, params, *, sr: int) -> jnp.ndarray:
    """Per-frame P(downbeat) from the bundled activation net, computed on
    device inside the fused dispatch (params are baked in as constants).
    Same body as the per-module path's jitted activation graph, so both
    execution paths produce identical net evidence."""

    from ..models import downbeat_net

    return downbeat_net._activation_graph.__wrapped__(params, y, n_valid, sr=sr)


def _bundled_net_params():
    """Downbeat activation-net weights baked into the fused graphs as
    compile-time constants (no per-call transfer). None disables the net.

    ON by default when the bundled checkpoint is a time-parallel TCN
    (milliseconds per track inside the fused dispatch); GRU checkpoints
    are refused here because their ~15k-step serial scan costs seconds of
    fused latency (they still serve the per-module analyse_downbeats
    path). TRACK_ANALYSER_TPU_NET_DOWNBEATS=0 disables; =1 forces even a
    GRU checkpoint in.
    """

    import os

    gate = os.environ.get("TRACK_ANALYSER_TPU_NET_DOWNBEATS")
    if gate == "0":
        return None

    from ..models.downbeat import _net_params

    params = _net_params()
    if params is None:
        return None
    if "tcn0_w" not in params and gate != "1":
        return None  # serial GRU: too slow for the fused latency path
    return params


def _core_graph(stereo, n_valid, *, sr):
    """Fused graph + packed outputs (+ net downbeat activations when the
    bundled checkpoint exists)."""

    packed = pack_outputs(full_track_graph(stereo, n_valid, sr=sr))
    params = _bundled_net_params()
    if params is not None:
        net = _net_downbeat_prob(jnp.mean(stereo, axis=0), n_valid, params, sr=sr)
        return packed + (net,)
    return packed


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_f32(parts, n_valid, *, sr):
    """Exact-samples transport, batched calling convention. Not a sweep
    transport; exists so single-track float32 dispatches share the one
    batched code path (batch of 1) with every other transport."""

    def one(p, nv):
        return _core_graph(p[0], nv, sr=sr)

    return jax.vmap(one)(parts, n_valid)


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_i16(parts, n_valid, *, sr):
    """Module-level jit so repeated analyse_library calls never retrace.
    ``parts`` = (stereo_i16,) — all batched graphs share the
    (parts_tuple, n_valid) calling convention."""

    def one(p, v):
        return _core_graph(p[0].astype(jnp.float32) / 32768.0, v, sr=sr)

    return jax.vmap(one)(parts, n_valid)


def _quantise_i16(x: np.ndarray) -> np.ndarray:
    # Truncating cast (np.round costs ~20x more than the whole conversion);
    # quantisation noise stays ~-90 dBFS either way. float32 scalars +
    # out= keep every pass in f32 — Python-float scalars upcast the whole
    # array to f64 and cost ~50x on this host's single core. The returned
    # int16 array is fresh (it outlives the call); only the f32
    # intermediate rides the per-thread scratch.
    buf = _scratch("q_f32", x.shape, np.float32)
    np.multiply(x, np.float32(32768.0), out=buf)
    np.clip(buf, np.float32(-32768.0), np.float32(32767.0), out=buf)
    return buf.astype(np.int16)


# Samples per int8 scaling block — equals the bucket quantum (hop*128) so
# every padded length divides evenly. Deliberately coarse (~1.5 s at
# 44.1 kHz): short blocks make the quantisation noise floor step at every
# block boundary, and the onset-flux detector reads those steps as
# micro-onsets — measured +0.24 BPM bias at 8192-sample blocks vs
# +0.02 at 65536 on a tonal+percussive fixture.
_I8_BLOCK = 65_536


def _source_channels(audio: AudioInput) -> np.ndarray:
    """(1|2, n) float32 view of the raw signal for the quantisers."""

    if audio.stereo_samples is not None and audio.stereo_samples.ndim == 2:
        return np.asarray(audio.stereo_samples[:2], dtype=np.float32)
    return np.asarray(audio.samples, dtype=np.float32)


def _stage_payload_i8(audio: AudioInput, n_bucket: int) -> tuple[tuple, int]:
    """(vals, scales) int8 payload + n_valid. Uses the native fused
    pad+quantise kernel when libta_native is built (one pass, GIL
    released — it overlaps the upload streams); numpy otherwise."""

    n = len(audio.samples)
    try:
        from ..native import binding as native_binding

        native = native_binding.quantise_i8(_source_channels(audio), n_bucket, _I8_BLOCK)
    except Exception:
        native = None
    if native is not None:
        return native, n
    st, nv = _pad_track(audio, n_bucket)
    return _quantise_i8(st), nv


def _stage_payload_i16(audio: AudioInput, n_bucket: int) -> tuple[np.ndarray, int]:
    """(2, n_bucket) int16 payload + n_valid (native fast path as above)."""

    n = len(audio.samples)
    try:
        from ..native import binding as native_binding

        native = native_binding.quantise_i16_stereo(_source_channels(audio), n_bucket)
    except Exception:
        native = None
    if native is not None:
        return native, n
    st, nv = _pad_track(audio, n_bucket)
    return _quantise_i16(st), nv


def _quantise_i8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Blockwise-scaled int8: (values (C, n) int8, scales (C, n/B) f32).

    ~45 dB SNR relative to the local block peak — another 2x off the
    host->device transfer. Far below every analysis tolerance (quantisation
    noise rides the signal, so quiet gated-out passages stay quiet).
    """

    c, n = x.shape
    blocks = x.reshape(c, n // _I8_BLOCK, _I8_BLOCK)
    scales = np.abs(blocks).max(axis=-1).astype(np.float32)
    inv = np.float32(127.0) / np.where(scales > 0, scales, np.float32(1.0))
    buf = _scratch("q_f32", x.shape, np.float32).reshape(blocks.shape)
    np.multiply(blocks, inv[:, :, None], out=buf)  # one f32 pass
    np.clip(buf, np.float32(-127.0), np.float32(127.0), out=buf)
    # round-to-nearest (not truncate): at 8 bits, truncation's toward-zero
    # bias shrinks signal energy by ~0.1-0.3 dB — outside the LUFS budget
    np.rint(buf, out=buf)
    return buf.astype(np.int8).reshape(c, n), scales


def _dequantise_i8(vals: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    c, n = vals.shape
    blocks = vals.astype(jnp.float32).reshape(c, n // _I8_BLOCK, _I8_BLOCK)
    out = blocks * (scales[:, :, None] / 127.0)
    return out.reshape(c, n)


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_i8(parts, n_valid, *, sr):
    def one(p, nv):
        return _core_graph(_dequantise_i8(p[0], p[1]), nv, sr=sr)

    return jax.vmap(one)(parts, n_valid)


# ---------------------------------------------------------------------------
# "ms" transport: ONLY the mid channel ships, as blockwise int8 — 1 byte
# per stereo sample pair (the proven precision floor for the gated mono
# analyses; it exists to cut host->device bytes — whether that still pays
# over PCIe is an open measurement, see ROADMAP). Every side-derived output is computed
# EXACTLY on host during the same decode/quantise stage:
#   - the four time-domain stereo scalars (correlation, balance,
#     mid/side RMS) from f64 running sums;
#   - the three per-band width ratios from an f64 strided-frame STFT with
#     the device graph's own band-energy formula (_host_stereo_widths).
# A 4-bit side payload (round 2) and a DPCM sub-8-bit mid (measured this
# round: closed-loop DPCM == quantising to step s, and percussive/
# broadband content gets no prediction gain — the 5 ms beat-grid gate
# fails at 4 bits, 18 ms on the click-in-noise fixture) were both
# rejected; shipping zero side bytes beats compressing them.
#
# Payloads are split into up to _MS_CHUNKS block-aligned time chunks.
# Chunking serves two masters: each chunk is a separate host->device
# buffer, so uploads spread across concurrent upload streams, and the
# single-track path quantises chunk k+1 while chunk k uploads. The chunk
# split is a pure function of the bucket length, so the single-track path
# (batch of 1 on a one-device mesh), mono tracks AND stereo tracks all
# share ONE compiled executable per bucket on single-chip hosts.
# ---------------------------------------------------------------------------

_MS_CHUNKS = 4

# Tiered chunk grid for the ms/ms6 transports. Tracks longer than
# _MS_TIER_MIN_SAMPLES pad to a TIER — a fixed count of fixed-size chunks
# — instead of a fine geometric bucket, so every track between ~48 s and
# 190 s (at 44.1 kHz) shares ONE compiled executable (per batch size):
# a mixed-duration library that would compile one executable per
# geometric bucket compiles one. The price is device FLOPs on the padded
# tail and tier-sized readback; upload stays proportional to the REAL
# track length because fully-padding chunks ride a cached all-zero device
# buffer (see _ZeroChunk). Chunk size balances the fixed cost of each
# device_put against the zero tail the LAST chunk of a track ships
# (bigger chunks = more padding bytes, worst one chunk's worth).
_MS_CHUNK_SAMPLES = 1 << 21  # 32 scale blocks; ~47.5 s at 44.1 kHz
_MS_TIER_MIN_SAMPLES = 1 << 21  # ≤ this (~47.5 s): geometric buckets
_MS_TIERS = (4, 6, 8, 12, 16, 24, 32)  # chunks per tier (190 s .. 25 min)
# On the tier grid the quantiser used to cover the track's final chunk
# WHOLE, shipping its encoded zero tail (~16% of the r5 bench payload —
# the stage trace's "tier chunks ship whole"). The tail is now trimmed
# to this granule (multiple of every transport's scale block: 4x the
# 65 536-sample ms/ms6 block, 256x the 1 024-sample ms5 block) and
# zero-extended ON DEVICE (_grow_part — zero scales/bases decode to
# silence in both codings, and the encoder's own pad blocks decode to
# exact zeros too, so results are bit-identical). Granule size bounds
# the tiny pad-executable count at 7 shipped lengths per transport.
_MS_TAIL_GRANULE = 1 << 18  # ~5.9 s at 44.1 kHz


def ms_bucket_length(n: int) -> int:
    """Pad target for the ms/ms6 transports: geometric buckets for short
    signals (tests, clips — compile cheaply everywhere), the tier grid
    beyond (one executable per ~octave of duration, shared by every
    length inside it)."""

    if n <= _MS_TIER_MIN_SAMPLES:
        return bucket_length(n)
    chunks = -(-n // _MS_CHUNK_SAMPLES)
    for t in _MS_TIERS:
        if chunks <= t:
            return t * _MS_CHUNK_SAMPLES
    # Past the tier table (>25 min) round to multiples of 8 chunks, not
    # 64: a ~26-min track must not pad to ~50 min of device compute and
    # 2x tier-sized readback (upload stays real-length via _ZeroChunk
    # either way; >25-min material is rare enough that a few more
    # executables beat doubling every long track's readback).
    return -(-chunks // 8) * 8 * _MS_CHUNK_SAMPLES


class _ZeroChunk:
    """Marker for an all-zero payload part: carries only shape/dtype.

    Staging maps it to a process-cached zero device buffer, so padding
    chunks (tier tails, zero batch lanes, prewarm payloads) cost no host
    memory, no quantise work and — when every lane of a part is zero —
    no upload bytes."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: tuple, dtype) -> None:
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def materialise(self) -> np.ndarray:
        return np.zeros(self.shape, self.dtype)


def _as_zero_marker(part) -> _ZeroChunk:
    if isinstance(part, _ZeroChunk):
        return part
    return _ZeroChunk(part.shape, part.dtype)


_ZERO_PARTS: Dict[tuple, object] = {}
_zero_parts_lock = threading.Lock()

# Process-wide host->device upload byte counter (bench attribution: the
# sweep is link-bound, so cross-run headline deltas are meaningless
# without the byte count next to the measured link bandwidth). Counts
# REAL bytes handed to device_put — cached zero buffers count once, at
# their first upload.
_UPLOAD_BYTES = [0]
_upload_bytes_lock = threading.Lock()


def _count_upload(nbytes: int) -> None:
    with _upload_bytes_lock:
        _UPLOAD_BYTES[0] += int(nbytes)


def reset_upload_bytes() -> None:
    with _upload_bytes_lock:
        _UPLOAD_BYTES[0] = 0


def upload_bytes() -> int:
    with _upload_bytes_lock:
        return _UPLOAD_BYTES[0]


def _zero_part(shape: tuple, dtype, mesh):
    """Process-cached all-zero device buffer with the sweep's sharding.
    One upload per distinct (mesh, shape, dtype) for the process
    lifetime; every later all-zero part reuses the same device memory."""

    key = (
        tuple(int(d.id) for d in mesh.devices.flat),
        tuple(shape),
        np.dtype(dtype).str,
    )
    buf = _ZERO_PARTS.get(key)
    if buf is None:
        with _zero_parts_lock:
            buf = _ZERO_PARTS.get(key)
            if buf is None:
                arr = np.zeros(shape, dtype)
                buf = jax.device_put(arr, data_sharding(mesh, rank=arr.ndim))
                _count_upload(arr.nbytes)
                _ZERO_PARTS[key] = buf
    return buf


def _ms_chunk_ranges(n_bucket: int) -> "list[tuple[int, int]]":
    """Block-aligned [start, end) chunk ranges covering ``n_bucket``."""

    if n_bucket > _MS_TIER_MIN_SAMPLES and n_bucket % _MS_CHUNK_SAMPLES == 0:
        # tier grid: fixed-size chunks so trailing all-zero chunks share
        # one cached device buffer across every track in the tier
        return [
            (s, s + _MS_CHUNK_SAMPLES)
            for s in range(0, n_bucket, _MS_CHUNK_SAMPLES)
        ]
    nb = n_bucket // _I8_BLOCK
    c = max(1, min(_MS_CHUNKS, nb))
    base, rem = divmod(nb, c)
    ranges = []
    pos = 0
    for i in range(c):
        size = (base + (1 if i < rem else 0)) * _I8_BLOCK
        ranges.append((pos, pos + size))
        pos += size
    return ranges


def _stereo_stats(l: np.ndarray, r: np.ndarray, n_valid: int) -> np.ndarray:
    """[n, sum_l, sum_r, sum_ll, sum_rr, sum_lr, sum_abs_l, sum_abs_r] in
    f64 over the valid samples (padded zeros contribute nothing)."""

    lv = l[:n_valid].astype(np.float64, copy=False)
    rv = r[:n_valid].astype(np.float64, copy=False)
    return np.array(
        [
            float(n_valid),
            float(lv.sum()),
            float(rv.sum()),
            float(np.dot(lv, lv)),
            float(np.dot(rv, rv)),
            float(np.dot(lv, rv)),
            float(np.abs(lv).sum()),
            float(np.abs(rv).sum()),
        ]
    )


def _quantise_ms(
    stereo_padded: np.ndarray, n_valid: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """numpy mid/side quantiser over a (2, n_bucket) padded f32 buffer.

    NOTE: production "ms" transport ships only the mid outputs (the int4
    side payload was retired in round 3 — host-exact widths replaced it);
    this full implementation remains the parity reference for the native
    ta_quantise_ms kernel, whose one fused pass still produces all of it.

    Returns (mid_i8 (n,), mid_scales (n/B,), side_u4 (n/2,) packed
    low-nibble-first, side_scales (n/B,), noise_power scalar f32,
    stats (8,) f64)."""

    l, r = stereo_padded[0], stereo_padded[1]
    stats = _stereo_stats(l, r, n_valid)
    mid = (0.5 * (l + r)).astype(np.float32)
    side = (0.5 * (l - r)).astype(np.float32)

    mid_i8, mid_scales = _quantise_i8(mid[None, :])
    mid_i8, mid_scales = mid_i8[0], mid_scales[0]

    n = side.shape[0]
    blocks = side.reshape(n // _I8_BLOCK, _I8_BLOCK)
    side_scales = np.abs(blocks).max(axis=-1).astype(np.float32)
    inv = np.float32(7.0) / np.where(side_scales > 0, side_scales, np.float32(1.0))
    q = np.rint(np.clip(blocks * inv[:, None], -7.0, 7.0)).astype(np.int8)
    codes = (q.reshape(n) + 8).astype(np.uint8)
    side_u4 = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)

    # Expected variance of the side quantisation error (uniform model,
    # step = scale/7), averaged over the valid region for the width debias.
    valid_blocks = max(1, -(-n_valid // _I8_BLOCK))
    step = side_scales[:valid_blocks].astype(np.float64) / 7.0
    noise_power = np.float32(np.mean(step * step) / 12.0)
    return mid_i8, mid_scales, side_u4, side_scales, noise_power, stats


def _host_stereo_widths(
    channels: np.ndarray,
    sr: int,
    *,
    n_fft: int = 2048,
    hop: int = 512,
    max_frames: int = 192,
) -> np.ndarray:
    """Per-band stereo widths sqrt(E_side/E_mid) computed on HOST in f64.

    Same estimator as the device graph (hann n_fft/hop STFT band-energy
    means over the 0-200 / 200-2000 / 2000-nyquist bands,
    substrate.full_track_graph) evaluated over an evenly strided subset
    of frames (<= max_frames), so the mid/side transport does not need to
    ship the side channel at all — three f64 scalars replace 0.5 bytes
    per sample of int4 side payload. Strided sampling error on the
    band-energy RATIO is far below the int4 quantisation noise it
    replaces (tests/test_batch.py pins it against the full-frame device
    estimator)."""

    from ..ops.stft import hann_window

    l = channels[0]
    r = channels[-1]
    n = l.shape[-1]
    if n == 0:
        return np.zeros(3)
    total = 1 + n // hop
    stride = -(-total // max_frames)  # ceil: honours the <= max_frames bound
    starts = np.arange(0, total, stride) * hop - n_fft // 2  # centred frames
    # Gather ONLY the sampled frames (<= max_frames x n_fft ~ 3 MB) from
    # the float32 signal — clipped indices + a validity mask reproduce
    # zero-padding bit-exactly without materialising full-length f64
    # copies (the pad+copy version thrashed the allocator so badly that
    # four concurrent decode workers ran 17x slower than serial).
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    valid = ((idx >= 0) & (idx < n)).astype(np.float64)
    idx_c = np.clip(idx, 0, n - 1)
    win = hann_window(n_fft).astype(np.float64) * valid
    fl = l[idx_c].astype(np.float64) * win
    fr = r[idx_c].astype(np.float64) * win
    sm = np.fft.rfft(0.5 * (fl + fr), axis=-1)
    ss = np.fft.rfft(0.5 * (fl - fr), axis=-1)
    mid_e = np.abs(sm) ** 2
    side_e = np.abs(ss) ** 2

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    nyq = sr / 2.0
    widths = np.zeros(3)
    for k, (lo_f, hi_f) in enumerate(
        ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq))
    ):
        band = (freqs >= lo_f) & (freqs <= hi_f)
        m = float(np.mean(mid_e[:, band])) if band.any() else 0.0
        s = float(np.mean(side_e[:, band])) if band.any() else 0.0
        widths[k] = 0.0 if m <= 1e-12 else float(np.sqrt(s / m))
    return widths


def _quantise_mid_range(
    channels: np.ndarray, n_in: int, start: int, end: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mid quantise + exact stereo sums for source samples [start, end)
    (block-aligned).

    Returns (mid_i8 (L,), mid_scales (L/B,), stats (8,) partial f64
    sums). Chunk outputs concatenate to exactly the full-track result
    (block boundaries align), so the single-track chunked pipeline and
    the sweep's full-track pass share numerics."""

    blocklen = end - start
    valid = int(max(0, min(n_in - start, blocklen)))
    l = channels[0, start : start + valid]
    r = channels[-1, start : start + valid]
    stats = _stereo_stats(l, r, valid)

    mid = np.zeros(blocklen, dtype=np.float32)
    np.multiply(np.add(l, r, dtype=np.float32), np.float32(0.5), out=mid[:valid])
    mid_i8, mid_scales = _quantise_i8(mid[None, :])
    return mid_i8[0], mid_scales[0], stats


def _pack_i6(codes: np.ndarray) -> np.ndarray:
    """Pack biased 6-bit codes (uint8 in [1, 63]) four-into-three bytes.
    Exact mirror of the native ta_quantise_mid6 packing and the device
    unpack in :func:`_dequantise_mono_i6`."""

    g = codes.reshape(-1, 4)
    out = np.empty((g.shape[0], 3), dtype=np.uint8)
    out[:, 0] = (g[:, 0] << 2) | (g[:, 1] >> 4)
    out[:, 1] = ((g[:, 1] & 15) << 4) | (g[:, 2] >> 2)
    out[:, 2] = ((g[:, 2] & 3) << 6) | g[:, 3]
    return out.reshape(-1)


def _pack_i5(codes: np.ndarray) -> np.ndarray:
    """Pack biased 5-bit codes (uint8 in [1, 31]) eight-into-five bytes.
    Exact mirror of the native ta_quantise_mid5 packing and the device
    unpack in :func:`_dequantise_mono_i5`."""

    g = codes.reshape(-1, 8).astype(np.uint16)
    out = np.empty((g.shape[0], 5), dtype=np.uint8)
    out[:, 0] = (g[:, 0] << 3) | (g[:, 1] >> 2)
    out[:, 1] = ((g[:, 1] & 3) << 6) | (g[:, 2] << 1) | (g[:, 3] >> 4)
    out[:, 2] = ((g[:, 3] & 15) << 4) | (g[:, 4] >> 1)
    out[:, 3] = ((g[:, 4] & 1) << 7) | (g[:, 5] << 2) | (g[:, 6] >> 3)
    out[:, 4] = ((g[:, 6] & 7) << 5) | g[:, 7]
    return out.reshape(-1)


def _quantise_mid_subbyte_range(
    channels: np.ndarray,
    n_in: int,
    start: int,
    end: int,
    carry: float,
    *,
    qmax: int,
    block: int,
    bias: int,
    shape: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Shared numpy fallback for the sub-byte mid transports (ms6/ms5):
    per block, the better of raw and delta-with-error-feedback
    [-qmax, qmax] codes (mode rides the scale's SIGN; ``bases`` carries
    the value entering each block so the device decode is
    block-parallel). Bit-identical to the native kernels over the same
    range. ``shape`` > 0 noise-shapes the delta candidate: the quantiser
    target is x[i] - shape*e[i-1], pushing reconstruction noise toward
    Nyquist and out of the mel-flux bands the BPM regression reads
    (encoder-only — decoder law and payload format unchanged; see the
    ta_quantise_mid5 kernel comment for the measurements).

    Each block's base is the TRUE (padded) mid sample preceding it —
    not the running reconstruction — so blocks encode INDEPENDENTLY:
    this loop runs the delta chains of every block in lock-step as
    (n_blocks,)-wide numpy ops (and the native kernel as SIMD lanes),
    which is what makes delta-heavy dense music quantise in tens of ms
    on a 1-vCPU host instead of a serial chain over every sample. The
    decoder law (y = base + int-cumsum(codes) * step, shipped bases)
    is unchanged; the exact base even removes the reconstruction
    error the old carry law injected at block entry. ``carry``
    threads that true-sample law across chunked calls. Returns
    (biased codes (L,) uint8 — pack separately, scales (L/B,),
    bases (L/B,), stats (8,), carry_out)."""

    blocklen = end - start
    valid = int(max(0, min(n_in - start, blocklen)))
    l = channels[0, start : start + valid]
    r = channels[-1, start : start + valid]
    stats = _stereo_stats(l, r, valid)

    mid = np.zeros(blocklen, dtype=np.float32)
    np.multiply(np.add(l, r, dtype=np.float32), np.float32(0.5), out=mid[:valid])
    blocks = mid.reshape(-1, block)
    nb = blocks.shape[0]
    fq = np.float32(float(qmax))

    # Base entering each block: the true padded-mid sample just before
    # it (carry_in for the first). Padding samples are exact zeros, so
    # a block following the signal's end gets base 0 — matching the
    # all-zero _ZeroChunk markers the sweep substitutes for it.
    prevs = np.empty(nb, np.float32)
    prevs[0] = np.float32(carry)
    if nb > 1:
        prevs[1:] = blocks[:-1, -1]

    peak = np.abs(blocks).max(axis=1).astype(np.float32)
    # Max |first difference| over the PADDED row with the base
    # prepended: inside the valid region this is the usual diff peak;
    # at the valid->pad step it contributes |x[last]| (the step down to
    # zero); all-pad blocks reduce to |base|. One expression covers the
    # three cases of the old per-block law.
    dpk = (
        np.abs(np.diff(blocks, axis=1, prepend=prevs[:, None].astype(np.float32)))
        .max(axis=1)
        .astype(np.float32)
    )

    # raw candidate (identical f32 ops to the kernel, all blocks at once)
    peak_safe = np.where(peak > 0, peak, np.float32(1.0))
    rstep = peak_safe / fq
    rinv = fq / peak_safe
    rcodes = np.rint(np.clip(blocks * rinv[:, None], -fq, fq)).astype(np.float32)
    rerr = np.abs(rcodes * rstep[:, None] - blocks).max(axis=1).astype(np.float32)

    # delta candidate: every block's error-feedback chain advances in
    # lock-step, one sample per iteration (true serial dependency is
    # only WITHIN a block). All ops stay f32 to mirror the kernel.
    run = dpk > 0
    dpk_safe = np.where(run, dpk, np.float32(1.0))
    dstep = dpk_safe / fq
    dinv = fq / dpk_safe
    fshape = np.float32(shape)
    dcodes = np.empty((nb, block), np.float32)
    acc = np.zeros(nb, np.int32)
    prev = prevs.copy()
    e_prev = np.zeros(nb, np.float32)
    derr = np.zeros(nb, np.float32)
    for i in range(block):
        x = blocks[:, i]
        tgt = x - fshape * e_prev
        v = (tgt - prev) * dinv
        c = np.rint(np.clip(v, -fq, fq))
        dcodes[:, i] = c
        acc += c.astype(np.int32)
        prev = prevs + acc.astype(np.float32) * dstep
        e_prev = prev - x
        np.maximum(derr, np.abs(e_prev), out=derr)
    take_delta = run & (derr < np.float32(0.5) * rerr)

    bases = prevs
    scales = np.where(take_delta, -dpk, peak).astype(np.float32)
    sel = np.where(take_delta[:, None], dcodes, rcodes)
    codes_all = (sel + np.float32(float(bias))).astype(np.uint8)
    carry_out = float(blocks[-1, -1]) if nb else float(carry)
    return codes_all.reshape(-1), scales, bases, stats, carry_out


def _quantise_mid6_range(
    channels: np.ndarray, n_in: int, start: int, end: int, carry: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """int6 analogue of :func:`_quantise_mid_range` (numpy fallback for
    ta_quantise_mid6): 4->3-byte packed best-of raw/delta codes, 0.75 B
    per stereo sample pair."""

    codes, scales, bases, stats, carry_out = _quantise_mid_subbyte_range(
        channels, n_in, start, end, carry, qmax=31, block=_I8_BLOCK, bias=32
    )
    return _pack_i6(codes), scales, bases, stats, carry_out


def _quantise_mid5_range(
    channels: np.ndarray, n_in: int, start: int, end: int, carry: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """int5 analogue (numpy fallback for ta_quantise_mid5): 8->5-byte
    packed best-of raw/delta codes on the finer _MS5_BLOCK scale grid,
    0.625 B per stereo sample pair."""

    codes, scales, bases, stats, carry_out = _quantise_mid_subbyte_range(
        channels, n_in, start, end, carry,
        qmax=15, block=_MS5_BLOCK, bias=16, shape=0.5,
    )
    return _pack_i5(codes), scales, bases, stats, carry_out


# ms5 quantises on a FINER scale grid than the 65 536-sample _I8_BLOCK,
# for two measured reasons: (a) at 5 bits a quiet click under a loud
# block peak's quantisation step breaks the beat-grid gate (7.9-13.3 ms
# worst grid error at 65 536/8 192-sample blocks vs 3.8 ms at 1 024);
# (b) per-block mode/scale switching modulates the quantisation noise
# floor at the BLOCK rate, and slow blocks alias into the tempo range —
# a pure-tone+clicks fixture read 108.5 BPM instead of 120 at
# 4 096-sample blocks (0.19 s modulation) and exactly 120.1 at 1 024
# (46 ms — far above any beat period). Scale/base overhead at 1 024 is
# 8 B per block = 0.78%.
_MS5_BLOCK = 1024


def _ms_block(bits: int) -> int:
    return _MS5_BLOCK if bits == 5 else _I8_BLOCK


def _ms_quantise_len(n: int, n_bucket: int) -> int:
    """How far the quantiser covers the bucket. On the tier grid:
    granule-rounded past the last valid sample (the final chunk's zero
    tail is trimmed from the upload and zero-extended on device —
    _MS_TAIL_GRANULE). Geometric buckets: through the chunk holding the
    last valid sample, exactly as before (small clips; trimming there
    would mint pad executables for little byte win)."""

    if n_bucket > _MS_TIER_MIN_SAMPLES and n_bucket % _MS_CHUNK_SAMPLES == 0:
        g = _MS_TAIL_GRANULE
        if g % _MS_CHUNK_SAMPLES == 0:  # shrunken-constant tests: granule
            return next(  # can't subdivide the chunk — keep chunk-rounding
                (e for _s, e in _ms_chunk_ranges(n_bucket) if e >= n), n_bucket
            )
        return min(-(-n // g) * g, n_bucket)
    return next((e for _s, e in _ms_chunk_ranges(n_bucket) if e >= n), n_bucket)


def _ms_payload_bytes(s: int, e: int, bits: int) -> "tuple[int, int]":
    """Byte range of the packed payload covering sample range [s, e)."""

    if bits == 6:
        return 3 * s // 4, 3 * e // 4
    if bits == 5:
        return 5 * s // 8, 5 * e // 8
    return s, e


def _chunk_ms_payload(
    mid_vals: np.ndarray,
    mid_scales: np.ndarray,
    n_bucket: int,
    bits: int = 8,
    bases: "np.ndarray | None" = None,
) -> tuple:
    """Assemble the chunked parts tuple the ms graph consumes:
    (mid chunks..., mid_scales) — identical for mono and stereo. For
    ``bits=6`` the chunk slices are in packed-byte space (3/4 of the
    sample range; block alignment guarantees divisibility) and the
    per-block ``bases`` ride as one extra part.

    ``mid_vals`` may cover only a PREFIX of the bucket (the quantiser
    stops at the chunk containing the last valid sample); chunks fully
    past it become :class:`_ZeroChunk` markers — staged as the cached
    zero device buffer, zero upload bytes. ``mid_scales``/``bases`` are
    zero-padded to the full bucket's block count here (zero scale
    decodes to silence in both codings)."""

    ranges = _ms_chunk_ranges(n_bucket)
    n_blocks = n_bucket // _ms_block(bits)
    if mid_scales.shape[0] < n_blocks:
        pad = n_blocks - mid_scales.shape[0]
        mid_scales = np.concatenate([mid_scales, np.zeros(pad, mid_scales.dtype)])
        if bases is not None:
            bases = np.concatenate([bases, np.zeros(pad, bases.dtype)])
    covered = len(mid_vals)
    parts = []
    for s, e in ranges:
        pb, pe = _ms_payload_bytes(s, e, bits)
        if pb >= covered:
            parts.append(_ZeroChunk((pe - pb,), mid_vals.dtype))
        else:
            parts.append(mid_vals[pb:pe])
    parts.append(mid_scales)
    if bits in (5, 6):
        parts.append(bases)
    return tuple(parts)


def _stage_payload_ms(
    audio: AudioInput, n_bucket: int, bits: int = 8
) -> tuple[tuple, tuple, int]:
    """(device_parts, host_exact, n_valid) for the "ms"/"ms6" transports.
    Uses the fused native kernel (one pass, GIL released) when built.

    ``host_exact`` is (stats (8,), widths (3,) | None): the f64 stereo
    sums plus, for stereo sources, the host-computed per-band widths —
    everything the device graph cannot derive from the mid-only payload."""

    n = len(audio.samples)
    channels = _source_channels(audio)
    if channels.ndim == 1:
        channels = channels[None, :]
    # Quantise only through the granule (tier grid) / chunk (geometric)
    # holding the last valid sample — trailing tier chunks become
    # _ZeroChunk markers in _chunk_ms_payload (no quantise work, no host
    # buffer, no upload) and a trimmed straddle chunk ships short, to be
    # zero-extended on device by the sweep's _grow_part.
    qlen = _ms_quantise_len(n, n_bucket)
    try:
        from ..native import binding as native_binding

        kernel = {
            6: native_binding.quantise_mid6,
            5: native_binding.quantise_mid5,
        }.get(bits, native_binding.quantise_mid)
        native = kernel(channels, qlen, _ms_block(bits))
    except Exception:
        native = None
    bases = None
    if native is not None:
        if bits in (5, 6):
            mid_vals, mid_scales, bases, stats, _carry = native
        else:
            mid_vals, mid_scales, stats = native
    else:
        # Mid-only numpy fallback: exactly the shipped payload (mid codes
        # + f64 stereo sums), just not fused into one pass.
        if bits == 6:
            mid_vals, mid_scales, bases, stats, _carry = _quantise_mid6_range(
                channels, n, 0, qlen
            )
        elif bits == 5:
            mid_vals, mid_scales, bases, stats, _carry = _quantise_mid5_range(
                channels, n, 0, qlen
            )
        else:
            mid_vals, mid_scales, stats = _quantise_mid_range(channels, n, 0, qlen)
    widths = None
    if audio.stereo_samples is not None:
        widths = _host_stereo_widths(channels, audio.sample_rate)
    payload = _chunk_ms_payload(mid_vals, mid_scales, n_bucket, bits, bases)
    return payload, (stats, widths), n


def _dequantise_mono_i8(vals, scales):
    n = vals.shape[-1]
    return (
        vals.astype(jnp.float32).reshape(n // _I8_BLOCK, _I8_BLOCK)
        * (scales[:, None] / 127.0)
    ).reshape(n)


def _dequantise_mono_i6(packed, scales, bases):
    """Unpack 4-in-3-byte biased 6-bit codes and dequantise — the exact
    inverse of _pack_i6 / ta_quantise_mid6. Per block, the scale's SIGN
    selects the coding: scale >= 0 is raw (y = code * step), scale < 0
    is delta with error feedback (y = base + int32-cumsum(code) * step,
    step = |scale|/31). Shipping the per-block entry value ``bases``
    keeps the decode block-parallel (reshape + one in-block cumsum) —
    no cross-block scan; the unpack shifts/masks and the mode select
    are cheap VPU passes XLA fuses."""

    m = packed.shape[-1] // 3
    b = packed.reshape(m, 3).astype(jnp.int32)
    c0 = b[:, 0] >> 2
    c1 = ((b[:, 0] & 3) << 4) | (b[:, 1] >> 4)
    c2 = ((b[:, 1] & 15) << 2) | (b[:, 2] >> 6)
    c3 = b[:, 2] & 63
    codes = jnp.stack([c0, c1, c2, c3], axis=-1).reshape(4 * m) - 32
    n = 4 * m
    cb = codes.reshape(n // _I8_BLOCK, _I8_BLOCK)
    step = jnp.abs(scales) / 31.0
    raw = cb.astype(jnp.float32) * step[:, None]
    delta = bases[:, None] + jnp.cumsum(cb, axis=1).astype(jnp.float32) * step[:, None]
    return jnp.where((scales < 0)[:, None], delta, raw).reshape(n)


def _dequantise_mono_i5(packed, scales, bases):
    """Unpack 8-in-5-byte biased 5-bit codes and dequantise — the exact
    inverse of _pack_i5 / ta_quantise_mid5, on the finer _MS5_BLOCK
    scale grid. Same mode convention as ms6: the scale's SIGN selects
    raw (y = code * step) vs delta with error feedback (y = base +
    int32-cumsum(code) * step, step = |scale|/15)."""

    m = packed.shape[-1] // 5
    b = packed.reshape(m, 5).astype(jnp.int32)
    c0 = b[:, 0] >> 3
    c1 = ((b[:, 0] & 7) << 2) | (b[:, 1] >> 6)
    c2 = (b[:, 1] >> 1) & 31
    c3 = ((b[:, 1] & 1) << 4) | (b[:, 2] >> 4)
    c4 = ((b[:, 2] & 15) << 1) | (b[:, 3] >> 7)
    c5 = (b[:, 3] >> 2) & 31
    c6 = ((b[:, 3] & 3) << 3) | (b[:, 4] >> 5)
    c7 = b[:, 4] & 31
    codes = jnp.stack([c0, c1, c2, c3, c4, c5, c6, c7], axis=-1).reshape(8 * m) - 16
    n = 8 * m
    cb = codes.reshape(n // _MS5_BLOCK, _MS5_BLOCK)
    step = jnp.abs(scales) / 15.0
    raw = cb.astype(jnp.float32) * step[:, None]
    delta = bases[:, None] + jnp.cumsum(cb, axis=1).astype(jnp.float32) * step[:, None]
    return jnp.where((scales < 0)[:, None], delta, raw).reshape(n)


def _dequantise_ms(mid_i8, mid_scales, side_u4, side_scales):
    n = mid_i8.shape[-1]
    mid = _dequantise_mono_i8(mid_i8, mid_scales)
    lo = jnp.bitwise_and(side_u4, jnp.uint8(0x0F)).astype(jnp.int32) - 8
    hi = jnp.right_shift(side_u4, jnp.uint8(4)).astype(jnp.int32) - 8
    codes = jnp.stack([lo, hi], axis=-1).reshape(n)
    side = (
        codes.astype(jnp.float32).reshape(n // _I8_BLOCK, _I8_BLOCK)
        * (side_scales[:, None] / 7.0)
    ).reshape(n)
    return jnp.stack([mid + side, mid - side])


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_ms(parts, n_valid, *, sr):
    """THE "ms" graph: mid-only int8 chunks, mono and stereo alike.
    ``parts`` is the chunked tuple (mid chunks..., mid_scales), each leaf
    batched. The chunk concat is one cheap device-memory pass; chunking
    exists so uploads ride multiple streams and overlap host quantisation.
    Side-derived outputs (widths, stereo scalars) are overwritten by the
    host-exact values carried alongside the payload."""

    def one(p, nv):
        c = len(p) - 1
        y = _dequantise_mono_i8(jnp.concatenate(p[:c], axis=-1), p[c])
        return _core_graph(jnp.stack([y, y]), nv, sr=sr)

    return jax.vmap(one)(parts, n_valid)


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_ms6(parts, n_valid, *, sr):
    """int6 variant of _batched_graph_ms: packed 6-bit mid chunks,
    0.75 B per stereo sample pair. Gate
    margins measured by scripts/sweep_transport_bits.py --robust:
    quantisation ADDS <=3.5 ms worst-case beat-grid error over the float
    analysis (vs int8's own 1.2-2.8 ms on the same adversarial
    fixtures), LUFS +-0.072, true peak +-0.018 dB, key exact; the
    per-block best-of {raw, delta-with-error-feedback} coding (see
    _dequantise_mono_i6) keeps dense-mix BPM at the float estimate, so
    the full +-0.1 gate holds."""

    def one(p, nv):
        c = len(p) - 2
        y = _dequantise_mono_i6(jnp.concatenate(p[:c], axis=-1), p[c], p[c + 1])
        return _core_graph(jnp.stack([y, y]), nv, sr=sr)

    return jax.vmap(one)(parts, n_valid)


@partial(jax.jit, static_argnames=("sr",))
def _batched_graph_ms5(parts, n_valid, *, sr):
    """int5 variant of _batched_graph_ms6: 8-into-5-byte packed 5-bit mid
    chunks on the finer _MS5_BLOCK scale grid — 0.63 B per stereo
    sample pair incl. scale overhead, the least-bytes transport.
    Measured margins: adversarial click grid worst BPM error 0.006 and
    added beat-grid error <=1.5 ms (vs ms6's accepted <=3.5 ms), LUFS/
    true-peak/key unchanged, and — with the round-5 noise-shaped delta
    encoder (ta_quantise_mid5: quantiser target x[i] - 0.5*e[i-1],
    error spectrum pushed toward Nyquist, out of the mel-flux bands the
    BPM regression reads) — the full +-0.1 dense-mix BPM bound holds
    (0.011 on the agreement fixture; best p90/max float-estimate
    perturbation of every candidate incl. ms6 over a 24-draw random
    dense ensemble, scripts/sweep_ms5_shaping.py). Every gate green at
    -16% bytes vs ms6 makes ms5 the bench transport."""

    def one(p, nv):
        c = len(p) - 2
        y = _dequantise_mono_i5(jnp.concatenate(p[:c], axis=-1), p[c], p[c + 1])
        return _core_graph(jnp.stack([y, y]), nv, sr=sr)

    return jax.vmap(one)(parts, n_valid)


def _apply_host_stereo_stats(
    out: Dict[str, np.ndarray],
    stats: np.ndarray,
    widths: "np.ndarray | None" = None,
) -> None:
    """Overwrite the four time-domain stereo scalars (and, for stereo
    sources, the three per-band widths) with the host-exact values
    carried alongside the mid-only payload."""

    if widths is not None:
        out["stereo_widths"] = np.asarray(widths, dtype=np.float64)
    n, sl, sr_, sll, srr, slr, sal, sar = [float(v) for v in stats]
    n = max(n, 1.0)
    lc2 = max(sll - sl * sl / n, 0.0)
    rc2 = max(srr - sr_ * sr_ / n, 0.0)
    dot = slr - sl * sr_ / n
    denom = np.sqrt(lc2) * np.sqrt(rc2)
    corr = 1.0 if denom <= 1e-12 else float(np.clip(dot / denom, -1.0, 1.0))
    out["stereo_corr_centered"] = np.float64(corr)
    out["stereo_balance"] = np.float64(sal / n - sar / n)
    out["mid_rms"] = np.float64(np.sqrt(max(sll + 2 * slr + srr, 0.0) / (4.0 * n)))
    out["side_rms"] = np.float64(np.sqrt(max(sll - 2 * slr + srr, 0.0) / (4.0 * n)))


_single_upload_pool: "ThreadPoolExecutor | None" = None
_single_upload_pool_lock = threading.Lock()


def _upload_pool() -> ThreadPoolExecutor:
    global _single_upload_pool
    if _single_upload_pool is None:
        with _single_upload_pool_lock:
            if _single_upload_pool is None:
                _single_upload_pool = ThreadPoolExecutor(max_workers=2)
    return _single_upload_pool


_single_mesh_cache: "dict | None" = None


def _single_mesh():
    """One-device ``data`` mesh for single-track dispatches. On a
    single-chip host this makes the single-track path and the library
    sweep share the SAME compiled executable per bucket (batch dim 1,
    identical shardings) — one compile instead of two."""

    global _single_mesh_cache
    if _single_mesh_cache is None:
        # Same check-then-set race as _upload_pool: both upload workers
        # hit this on the first ms dispatch.
        with _single_upload_pool_lock:
            if _single_mesh_cache is None:
                _single_mesh_cache = make_mesh(
                    (1,), ("data",), devices=[jax.devices()[0]]
                )
    return _single_mesh_cache


def _put_batched(arr: np.ndarray):
    """device_put one payload part with a leading batch-of-1 axis, laid
    out exactly as the library sweep stages its chunks."""

    batched = arr[None]
    _count_upload(batched.nbytes)
    return jax.device_put(batched, data_sharding(_single_mesh(), rank=batched.ndim))


@partial(jax.jit, static_argnames=("lanes",))
def _pad_lanes(parts: tuple, *, lanes: int) -> tuple:
    """Grow batch-of-1 payload parts to ``lanes`` with DEVICE-side zero
    lanes — no host bytes ship for the padding (zero scales decode to
    silence), so a single track can dispatch through an
    analyse_library(device_batch=N) sweep's executable without paying N
    uploads. A tiny graph that compiles in seconds, instead of a second
    full analysis executable."""

    return tuple(
        jnp.pad(p, [(0, lanes - 1)] + [(0, 0)] * (p.ndim - 1)) for p in parts
    )


@partial(jax.jit, static_argnames=("lanes", "target"))
def _grow_part(part, *, lanes: int, target: int):
    """Grow ONE payload part to ``lanes`` batch rows (device-side zero
    lanes — the per-part analogue of _pad_lanes, for sweep chunks whose
    trailing lanes are all-zero) and zero-extend its last axis to
    ``target`` bytes (the trimmed tail of a track's final tier chunk —
    zero scales/bases decode the extension to silence). A tiny pad
    graph: seconds to compile, instead of uploading zero bytes per
    lane-part."""

    pads = [(0, lanes - part.shape[0])] + [(0, 0)] * (part.ndim - 1)
    pads[-1] = (0, target - part.shape[-1])
    return jnp.pad(part, pads)


@jax.jit
def _lane0(out: tuple) -> tuple:
    """Slice lane 0 of every output buffer ON DEVICE, so a single-track
    dispatch through a multi-lane executable reads back one lane's bytes."""

    return tuple(x[:1] for x in out)


def _dispatch_single_ms(audio: AudioInput, n_bucket: int, bits: int = 8, lanes: int = 1):
    """Single-track "ms"/"ms6" dispatch through the BATCHED executable
    (``lanes`` tracks per dispatch on a one-device mesh; the padding
    lanes are created on device and sliced off before readback, so a
    single track shares an analyse_library(device_batch=lanes)
    executable at batch-1 upload/readback cost).

    The mid payload uploads as block-aligned chunks on the 2-stream
    pool; without the native kernel, chunk k+1 is quantised while chunk
    k uploads (the intra-track version of the sweep's pipelining), and
    the host width estimate overlaps the uploads either way. Returns
    (device output handle, (stats, widths))."""

    sr = audio.sample_rate
    n = len(audio.samples)
    ranges = _ms_chunk_ranges(n_bucket)
    pool = _upload_pool()
    channels = _source_channels(audio)
    if channels.ndim == 1:
        channels = channels[None, :]
    mono = audio.stereo_samples is None

    def _native_chunk(s: int, e: int, carry: float = 0.0):
        """Native quantise of block-aligned chunk [s, e) — bitwise the
        same mid/scales as one full-bucket pass (scales are per-block,
        chunk bounds are block-aligned, and for ms6 the reconstruction
        ``carry`` threads across chunk calls); stats are per-chunk f64
        partial sums. Returns None when the kernel is unavailable."""

        try:
            from ..native import binding as native_binding

            sl = np.ascontiguousarray(channels[:, s : min(e, n)])
            if bits == 6:
                res = native_binding.quantise_mid6(sl, e - s, _I8_BLOCK, carry)
            elif bits == 5:
                res = native_binding.quantise_mid5(sl, e - s, _MS5_BLOCK, carry)
            else:
                res = native_binding.quantise_mid(sl, e - s, _I8_BLOCK)
        except Exception:
            res = None
        return res

    # Chunked quantise (native per chunk, numpy fallback): chunk k's
    # upload is in flight while chunk k+1 quantises, so the first
    # device_put issues ~4x sooner than after a full-bucket pass.
    mid_futs = []
    msc = []
    mbase = []
    stats = np.zeros(8)
    carry = 0.0
    for s, e in ranges:
        if s >= n:  # pure padding: cached zero buffer — no quantise, no
            # upload bytes (zero scale decodes to silence in every mode)
            pb, pe = _ms_payload_bytes(s, e, bits)
            nb = (e - s) // _ms_block(bits)
            dtype = np.uint8 if bits in (5, 6) else np.int8
            mid_futs.append(_zero_part((1, pe - pb), dtype, _single_mesh()))
            msc.append(np.zeros(nb, np.float32))
            if bits in (5, 6):
                mbase.append(np.zeros(nb, np.float32))
            continue
        # Straddle chunk (s < n < e): quantise only through the last
        # valid granule — the trimmed tail is zero-extended on device
        # after upload (_grow_part below; zero scales decode to silence,
        # and the encoder's own pad blocks decoded to exact zeros, so
        # results are bit-identical to the untrimmed upload).
        qe = min(e, max(_ms_quantise_len(n, n_bucket), s + _ms_block(bits)))
        out = _native_chunk(s, qe, carry)
        if out is None:
            if bits == 6:
                out = _quantise_mid6_range(channels, n, s, qe, carry)
            elif bits == 5:
                out = _quantise_mid5_range(channels, n, s, qe, carry)
            else:
                out = _quantise_mid_range(channels, n, s, qe)
        nb_full = (e - s) // _ms_block(bits)
        if bits in (5, 6):
            mc, m_sc, m_b, st, carry = out
            if m_b.shape[0] < nb_full:
                m_b = np.concatenate(
                    [m_b, np.zeros(nb_full - m_b.shape[0], m_b.dtype)]
                )
            mbase.append(m_b)
        else:
            mc, m_sc, st = out
        if m_sc.shape[0] < nb_full:
            m_sc = np.concatenate(
                [m_sc, np.zeros(nb_full - m_sc.shape[0], m_sc.dtype)]
            )
        mid_futs.append(pool.submit(_put_batched, mc))
        msc.append(m_sc)
        stats = stats + st
    mscales = np.concatenate(msc)

    # Host widths overlap the uploads still in flight.
    widths = None if mono else _host_stereo_widths(channels, sr)

    chunk_parts = []
    for ci, f in enumerate(mid_futs):
        p = f.result() if hasattr(f, "result") else f
        pb, pe = _ms_payload_bytes(*ranges[ci], bits)
        if p.shape[-1] < pe - pb:  # trimmed straddle: zero-extend on device
            p = _grow_part(p, lanes=1, target=pe - pb)
        chunk_parts.append(p)
    parts = tuple(chunk_parts) + (_put_batched(np.asarray(mscales)),)
    if bits in (5, 6):
        parts = parts + (_put_batched(np.concatenate(mbase)),)
    valids = [n] + [n_bucket] * (lanes - 1)
    varr = np.asarray(valids)
    _count_upload(varr.nbytes)
    vb = jax.device_put(varr, data_sharding(_single_mesh()))
    if lanes > 1:
        parts = _pad_lanes(parts, lanes=lanes)

    graph = {6: _batched_graph_ms6, 5: _batched_graph_ms5}.get(bits, _batched_graph_ms)
    tag = {6: "ms6", 5: "ms5"}.get(bits, "ms")
    out = graph(parts, vb, sr=sr)
    if lanes > 1:
        out = _lane0(out)
    _record_single_warm(tag, sr, n_bucket, len(parts), lanes)
    return out, (stats, widths)


def _record_single_warm(
    tag: str, sr: int, n_bucket: int, arity: int, lanes: int = 1
) -> None:
    # On single-chip hosts the single-track executable IS the sweep's
    # bucket executable at the same lane count (device_batch == lanes);
    # record it so library prewarm skips a redundant compile.
    mesh_ids = tuple(int(d.id) for d in _single_mesh().devices.flat)
    _WARMED_EXECUTABLES.add((tag, sr, mesh_ids, lanes, n_bucket, arity))


def _dispatch_single_batched(tag: str, graph, parts_np, n_valid: int, sr: int, n_bucket: int):
    """Dispatch ONE track through a sweep-convention batched executable
    (batch of 1 on the one-device mesh): single-track calls and library
    sweeps share one compiled executable per (transport, bucket), so a
    user mixing analyse_track_fused with analyse_library never pays a
    second compile. Payload parts upload concurrently on the
    2-stream pool."""

    pool = _upload_pool()
    futs = [pool.submit(_put_batched, np.asarray(p)) for p in parts_np]
    varr = np.asarray([n_valid])
    _count_upload(varr.nbytes)
    vb = jax.device_put(varr, data_sharding(_single_mesh()))
    parts = tuple(f.result() for f in futs)
    out = graph(parts, vb, sr=sr)
    _record_single_warm(tag, sr, n_bucket, len(parts))
    return out


def analyse_track_fused(
    source: "str | AudioInput",
    *,
    seed: int = DEFAULT_SEED,
    bucket: bool = True,
    transport: str = "auto",
    device_batch: int = 1,
) -> TrackAnalysisResult:
    """Single-track analysis through the fused one-dispatch graph.

    ``transport`` picks the host->device representation:
      - "auto" (default): alias for "ms".
      - "ms": ONLY the mid channel ships, as blockwise int8 chunks —
        1 B per stereo sample pair (or per mono sample). Every
        side-derived output is host-exact: the time-domain stereo
        scalars from f64 sums, the per-band widths from an f64
        strided-frame STFT with the device's own band formula.
      - "ms6": as "ms" but 6-bit mid codes packed 4-into-3 bytes, each
        block raw- or delta-coded (best-of, with error feedback; see
        _dequantise_mono_i6) — 0.75 B per stereo sample pair, the
        least bytes. Measured contract (scripts/sweep_transport_bits.py
        --robust + the decision-margin tests): every accuracy gate
        holds — delta mode keeps dense-mix BPM at the float estimate
        (~46 dB SNR), raw mode keeps beat-grid quantisation within
        <=3.5 ms worst-case added error on adversarial clicks (int8
        itself adds 1.2-2.8 ms there); LUFS/true-peak/key/downbeat
        decisions unchanged, segment boundaries stable on decisive
        material (near-threshold novelty picks on structureless loops
        can shift — the float path itself flips there under -50 dB
        added noise).
      - "int16": -96 dBFS quantisation, lossless for PCM16 sources.
      - "int8": blockwise-scaled per-channel int8.
      - "float32": the exact samples.

    Every transport dispatches through the sweep's batched executable at
    batch 1, so single-track and library use share one compile per
    (transport, bucket).

    ``device_batch`` (ms/ms6 only): dispatch through the executable an
    ``analyse_library(device_batch=N)`` sweep compiles — the padding
    lanes are created on device and sliced off before readback, so the
    track still pays batch-1 upload/readback. Use it when mixing
    single-track calls with batched sweeps so the pair never compiles a
    second executable.
    """

    audio = source if isinstance(source, AudioInput) else coerce_audio(source)
    n = len(audio.samples)
    if transport == "auto":
        transport = "ms"
    if bucket:
        # ms transports pad to the tier grid (one executable per duration
        # tier; padding chunks are zero-cost) — see ms_bucket_length.
        n_bucket = (
            ms_bucket_length(n)
            if transport in ("ms", "ms6", "ms5")
            else bucket_length(n)
        )
    else:
        n_bucket = n
    if transport in ("ms", "ms6", "ms5", "int8") and n_bucket % _I8_BLOCK:
        # Blockwise transports reshape the payload into _I8_BLOCK blocks;
        # bucket lengths always divide (hop*128 == _I8_BLOCK) but
        # bucket=False lengths need rounding up (padding is masked out).
        n_bucket = -(-n_bucket // _I8_BLOCK) * _I8_BLOCK
    host_exact = None
    if transport in ("ms", "ms6", "ms5"):
        out, host_exact = _dispatch_single_ms(
            audio,
            n_bucket,
            bits={"ms6": 6, "ms5": 5}.get(transport, 8),
            lanes=max(1, int(device_batch)),
        )
    elif transport == "int8":
        (vals, scales), n_valid = _stage_payload_i8(audio, n_bucket)
        out = _dispatch_single_batched(
            "int8", _batched_graph_i8, (vals, scales), n_valid,
            audio.sample_rate, n_bucket,
        )
    elif transport == "int16":
        payload, n_valid = _stage_payload_i16(audio, n_bucket)
        out = _dispatch_single_batched(
            "int16", _batched_graph_i16, (payload,), n_valid,
            audio.sample_rate, n_bucket,
        )
    else:
        stereo, n_valid = _pad_track(audio, n_bucket)
        # copy: _pad_track hands out a reusable scratch, and on the CPU
        # backend device_put may alias the numpy buffer zero-copy
        out = _dispatch_single_batched(
            "float32", _batched_graph_f32, (stereo.copy(),), n_valid,
            audio.sample_rate, n_bucket,
        )
    fetched = jax.device_get(out)
    # every transport dispatches the batched executable: strip batch-of-1
    fetched = tuple(np.asarray(f)[0] for f in fetched)
    out_dict = unpack_outputs(*fetched[:4])
    if len(fetched) > 4:
        out_dict["net_prob"] = np.asarray(fetched[4])
    if host_exact is not None:
        _apply_host_stereo_stats(out_dict, *host_exact)
    return result_from_graph_outputs(audio, out_dict, seed=seed)


def analyse_library(
    sources: Sequence["str | AudioInput"],
    *,
    seed: int = DEFAULT_SEED,
    mesh=None,
    target_sr: int = DEFAULT_CONFIG.target_sr,
    decode_workers: Optional[int] = None,
    upload_streams: int = 2,
    prefetch_tracks: Optional[int] = None,
    output_dir: "Optional[str | Path]" = None,
    progress_callback: Optional[Callable[[str, int, int], None]] = None,
    manifest_path: "Optional[str | Path]" = None,
    transport: str = "ms",
    on_error: str = "skip",
    prewarm: Optional[bool] = None,
    device_batch: int = 1,
    shard: Optional[tuple] = None,
) -> "List[TrackAnalysisResult | TrackFailure | SkippedTrack]":
    """Analyse a library of tracks through a bounded streaming pipeline.

    Returns one outcome PER SOURCE, aligned with ``sources``: a
    :class:`TrackAnalysisResult` on success, a :class:`TrackFailure`
    (source + error text) when the track could not be decoded/coerced, or
    a :class:`SkippedTrack` when a manifest from an earlier sweep already
    lists it as done. Nothing is silently dropped — callers filter with
    ``isinstance(r, TrackAnalysisResult)``.

    Four overlapped stages, each bounded so memory stays O(prefetch), not
    O(library):

      decode pool   -> decode + resample + pad + quantise (CPU)
      upload pool   -> device_put of quantised payloads on
                       ``upload_streams`` concurrent streams
      dispatch      -> one vmapped pjit'd fused-graph call per chunk,
                       sharded over the mesh's ``data`` axis (async)
      finish thread -> readback + host result assembly + rendering,
                       strictly off the dispatch path

    Tracks group into shared padded buckets so each bucket size is one
    compiled executable. A JSONL manifest makes sweeps resumable:
    already-listed sources are skipped.

    ``transport``: "ms" (default — mid-only blockwise int8, 1 B per
    stereo sample pair; stereo scalars and per-band widths are
    host-exact, and mono/stereo tracks share chunks and executables),
    "ms6" (6-bit mid codes packed 4-into-3 bytes, per block raw- or
    delta-coded, 0.75 B per stereo sample pair; every accuracy gate
    holds, see RUNBOOK), "ms5" (5-bit noise-shaped delta codes packed
    8-into-5 bytes on 1 024-sample blocks, 0.63 B per pair — the least
    host->device bandwidth; every gate holds since the round-5
    noise-shaped encoder, so it is the bench transport), "int8"
    (per-channel blockwise int8, ~45 dB SNR) or "int16" (~96 dB SNR).

    ``on_error``: "skip" (default) isolates per-track decode/coerce
    failures — the sweep continues, the failure is recorded in the
    manifest with an "error" field (and NOT counted as done, so a rerun
    retries it) — or "raise" to abort on the first failure.

    ``prewarm``: compile each bucket's executable in a background thread
    (zero-payload chunk) the moment the bucket is first seen, so
    server-side compiles overlap decode/upload and each other. Default
    (None) enables it on accelerator backends only — local CPU compiles
    are fast enough that warming is pure overhead there.

    ``device_batch``: tracks analysed per device per dispatch (chunks
    are ``n_devices * device_batch`` lanes). >1 amortises per-dispatch
    overhead and batches the device matmuls (lanes bit-identical to
    batch 1) at the price of one extra executable per
    (bucket, batch) and zero-lane padding when a bucket's track count
    is not a multiple. Default 1 = one executable per bucket, shared
    with the single-track path.

    ``shard``: ``(index, count)`` for multi-process sweeps. Track-level
    data parallelism needs NO cross-slice communication (every track is
    independent), so the multi-slice story is deterministic source
    striping: process ``index`` of ``count`` analyses ``sources[i]``
    where ``i % count == index`` and returns ``SkippedTrack(reason=
    "other-shard")`` for the rest. Launch one process per slice/host
    with the same source list and distinct ``shard`` indices; give each
    its own manifest file (or share one on a POSIX filesystem — appends
    are line-atomic). Within each process the sweep still spreads its
    chunks over that process's ``mesh``; nothing ever crosses hosts,
    which is the right design, not a limitation.
    """

    if shard is not None:
        shard_index, shard_count = int(shard[0]), int(shard[1])
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard index {shard_index} not in [0, {shard_count})")
    mesh = mesh or make_mesh()
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n_lane = n_dev * max(1, int(device_batch))
    # ms transports pad to the tier grid (one executable per duration
    # tier, zero-cost padding chunks); other transports keep geometric
    # buckets (payload bytes there scale with the bucket).
    _bucket_for = (
        ms_bucket_length if transport in ("ms", "ms6", "ms5") else bucket_length
    )

    done: set[str] = set()
    manifest = Path(manifest_path) if manifest_path else None
    if manifest and manifest.exists():
        for line in manifest.read_text().splitlines():
            try:
                record = json.loads(line)
                if "error" not in record:  # failed tracks retry on rerun
                    done.add(record["source"])
            except (json.JSONDecodeError, KeyError):
                continue

    results: "List[Optional[TrackAnalysisResult | TrackFailure | SkippedTrack]]" = [
        None
    ] * len(sources)
    todo: List[tuple[int, "str | AudioInput"]] = []
    for i, s in enumerate(sources):
        if shard is not None and i % shard_count != shard_index:
            results[i] = SkippedTrack(source=str(s), reason="other-shard")
        elif isinstance(s, (str, Path)) and str(s) in done:
            results[i] = SkippedTrack(source=str(s))
        else:
            todo.append((i, s))

    # TA_SWEEP_DEBUG=1: stage-attributed stderr trace of the pipeline
    # (used to attribute sweep latency; zero cost when unset).
    if os.environ.get("TA_SWEEP_DEBUG", "") not in ("", "0"):
        _dbg_t0 = time.perf_counter()

        def _dbg(tag: str, idx) -> None:
            import sys as _sys

            print(
                f"[sweep {time.perf_counter() - _dbg_t0:7.2f}s] {tag} {idx}",
                file=_sys.stderr,
                flush=True,
            )

    else:

        def _dbg(tag: str, idx) -> None:
            pass

    def _load(item):
        idx, src = item
        _dbg("load.start", idx)
        try:
            # Always coerce: the batched graph is compiled with
            # sr=target_sr, so an AudioInput at any other rate must be
            # resampled here (near-free no-op when the rate matches).
            audio = coerce_audio(src, target_sr=target_sr)
            n_bucket = _bucket_for(len(audio.samples))
            stats = None  # ms: (stereo sums, widths | None) host-exact pair
            if transport in ("ms", "ms6", "ms5"):
                payload, stats, nv = _stage_payload_ms(
                    audio, n_bucket, bits={"ms6": 6, "ms5": 5}.get(transport, 8)
                )
            elif transport == "int8":
                payload, nv = _stage_payload_i8(audio, n_bucket)
            else:
                p16, nv = _stage_payload_i16(audio, n_bucket)
                payload = (p16,)
        except Exception as exc:
            if on_error == "raise":
                raise
            return idx, src, exc, None, None, None, None
        _dbg("load.done", idx)
        return idx, src, audio, n_bucket, payload, nv, stats

    def _stage(chunk):
        """Upload one chunk's payload parts (runs on the upload pool)."""

        _dbg("stage.start", [c[0] for c in chunk])
        n_bucket = _bucket_for(len(chunk[0][2].samples))
        payloads = [payload for _, _, _, payload, _, _ in chunk]
        valids = [nv for _, _, _, _, nv, _ in chunk]
        n_pad = n_lane - len(payloads)
        if n_pad > 0:  # pad batch to the device count (all-zero payloads
            # dequantise to silence for every transport: zero scales) —
            # markers, so zero lanes cost no host memory or upload bytes
            zero = tuple(_as_zero_marker(p) for p in payloads[0])
            payloads.extend([zero] * n_pad)
            valids.extend([n_bucket] * n_pad)
        # On a ONE-device mesh the lane axis is not a device axis, so
        # trailing all-zero lanes (padding lanes of a partial chunk,
        # zero tier chunks of the shorter tracks) need not ship: upload
        # the real-lane prefix and grow it on device (_grow_part — a
        # tiny jit, seconds to compile, instead of zero bytes per
        # trimmed lane per part). Multi-device meshes keep
        # the full stack: lanes map onto devices there (trimmed tails
        # are re-padded on host instead of on the sharded buffer).
        one_device = mesh.devices.size == 1
        # Chunk parts may be TRIMMED (each track's final tier chunk ships
        # only through its last valid granule — _ms_quantise_len), so
        # lanes can be ragged: pad lanes on host to the group's max
        # shipped length, upload that, and zero-extend to the full chunk
        # size on device (_grow_part). full_lens pins the decode
        # executable's canonical part shapes.
        full_lens = None
        if transport in ("ms", "ms6", "ms5"):
            bits = {"ms6": 6, "ms5": 5}.get(transport, 8)
            full_lens = [
                pe - pb
                for pb, pe in (
                    _ms_payload_bytes(s, e, bits)
                    for s, e in _ms_chunk_ranges(n_bucket)
                )
            ]
        staged = []
        for part in range(len(payloads[0])):
            vals = [p[part] for p in payloads]
            full = (
                full_lens[part]
                if full_lens is not None and part < len(full_lens)
                else max(v.shape[-1] for v in vals)
            )
            if all(isinstance(v, _ZeroChunk) for v in vals):
                z = vals[0]
                staged.append(
                    _zero_part((len(vals),) + z.shape[:-1] + (full,), z.dtype, mesh)
                )
                continue
            keep = len(vals)
            if one_device:
                last_real = max(
                    i for i, v in enumerate(vals) if not isinstance(v, _ZeroChunk)
                )
                keep = last_real + 1
            shipped = max(v.shape[-1] for v in vals[:keep]) if one_device else full
            rows = []
            for v in vals[:keep]:
                a = v.materialise() if isinstance(v, _ZeroChunk) else v
                if a.shape[-1] < shipped:
                    b = np.zeros(a.shape[:-1] + (shipped,), a.dtype)
                    b[..., : a.shape[-1]] = a
                    a = b
                rows.append(a)
            stacked = np.stack(rows)
            _count_upload(stacked.nbytes)
            buf = jax.device_put(stacked, data_sharding(mesh, rank=stacked.ndim))
            if keep < len(vals) or shipped < full:
                buf = _grow_part(buf, lanes=len(vals), target=full)
            staged.append(buf)
        varr = np.asarray(valids)
        _count_upload(varr.nbytes)
        vb = jax.device_put(varr, data_sharding(mesh))
        _dbg("stage.done", [c[0] for c in chunk])
        return tuple(staged), vb

    def _batched_for(chunk):
        """Executable for a chunk — one per transport ("ms" is mid-only,
        so mono and stereo tracks share chunks AND the executable)."""

        if transport == "ms":
            return partial(_batched_graph_ms, sr=target_sr)
        if transport == "ms6":
            return partial(_batched_graph_ms6, sr=target_sr)
        if transport == "ms5":
            return partial(_batched_graph_ms5, sr=target_sr)
        if transport == "int8":
            return partial(_batched_graph_i8, sr=target_sr)
        return partial(_batched_graph_i16, sr=target_sr)

    n_done = 0
    total = len(todo)
    # Two finisher workers overlap one chunk's readback with the
    # previous chunk's host assembly; this lock serialises the shared
    # bits (manifest append, done counter, progress callback).
    finish_lock = threading.Lock()
    # Rendering is NOT thread-safe (matplotlib pyplot mutates the global
    # figure registry and font cache), so artefact writing serialises on
    # its own lock — readback/assembly of other chunks still overlaps.
    render_lock = threading.Lock()

    def _finish(chunk, out_handle) -> None:
        nonlocal n_done
        _dbg("finish.start", [c[0] for c in chunk])
        fetched = jax.device_get(out_handle)
        _dbg("finish.fetched", [c[0] for c in chunk])
        curves, curves_half, chroma, vec = fetched[:4]
        net = fetched[4] if len(fetched) > 4 else None
        for k, (idx, src, audio, _payload, _nv, stats) in enumerate(chunk):
            track_out = unpack_outputs(curves[k], curves_half[k], chroma[k], vec[k])
            if net is not None:
                track_out["net_prob"] = np.asarray(net[k])
            if stats is not None:
                _apply_host_stereo_stats(track_out, *stats)
            result = result_from_graph_outputs(audio, track_out, seed=seed)
            results[idx] = result
            if output_dir is not None:
                from ..rendering import outputs as outputs_module

                name = (
                    Path(str(src)).stem
                    if isinstance(src, (str, Path))
                    else f"track_{idx:05d}"
                )
                with render_lock:
                    outputs_module.render_all(result, Path(output_dir) / name)
            with finish_lock:
                if manifest:
                    with manifest.open("a") as fh:
                        fh.write(
                            json.dumps(
                                {
                                    "source": str(src),
                                    "bpm": result.beat.bpm,
                                    "key": result.harmonic.primary_key.key,
                                }
                            )
                            + "\n"
                        )
                n_done += 1
                if progress_callback:
                    progress_callback(str(src), n_done, total)
        _dbg("finish.done", [c[0] for c in chunk])

    # Pipeline bounds: how many decoded tracks may exist at once (payload
    # + AudioInput each), and how many uploaded chunks may wait on device.
    prefetch = prefetch_tracks or max(2 * n_lane, 4)
    stage_depth = max(upload_streams, 2)

    if decode_workers is None:
        # Concurrency past the core count only time-slices CPU-bound
        # decode+quantise work, which DELAYS the first finished payload
        # (and so the first upload byte) without adding throughput: on a
        # 1-vCPU host, 4 round-robined workers held the link idle ~0.2 s
        # at sweep start vs ~0.06 s with serial decode (stage trace in
        # RUNBOOK). One core is reserved for the dispatch/upload threads.
        decode_workers = max(1, min(4, (os.cpu_count() or 4) - 1))
    decode_pool = ThreadPoolExecutor(max_workers=decode_workers)
    upload_pool = ThreadPoolExecutor(max_workers=upload_streams)
    # One worker per in-flight chunk (stage_depth) plus one: a finisher
    # must be free the moment a dispatch is issued so its device_get is
    # already pending when the chunk's compute completes —
    # with exactly stage_depth workers the LAST chunk's readback waited
    # for an earlier chunk's host assembly to release a worker.
    finish_pool = ThreadPoolExecutor(max_workers=stage_depth + 1)
    # Executable pre-warming: as soon as a bucket key first appears, a
    # zero-payload chunk is pushed through the normal
    # dispatch path on this pool, so compiles overlap decode/upload AND
    # each other instead of serialising on the first real dispatch per
    # bucket.
    warm_pool = ThreadPoolExecutor(max_workers=3)
    if prewarm is None:
        prewarm = jax.devices()[0].platform != "cpu"
    # Process-wide: an executable is warm for the lifetime of the jit
    # cache (the process), so repeated sweeps must not re-pay the
    # zero-payload upload + execution that seeds the compile.
    mesh_ids = tuple(int(d.id) for d in mesh.devices.flat)

    decode_q: deque = deque()  # futures of _load
    buckets: Dict[int, list] = {}  # (n_bucket, arity) -> items awaiting a chunk
    staged_q: deque = deque()  # (chunk, future of _stage)
    dispatched_q: deque = deque()  # futures of _finish
    src_iter = iter(todo)

    def _warm_executable(item) -> None:
        """Compile one bucket's executable via an all-zero clone of the
        first item seen for it (zero scales dequantise to silence)."""

        try:
            idx, src, audio, payload, _nv, _stats = item
            zero = tuple(_as_zero_marker(p) for p in payload)
            chunk = [(idx, src, audio, zero, len(audio.samples), None)]
            staged, vb = _stage(chunk)
            jax.block_until_ready(_batched_for(chunk)(staged, vb))
        except Exception:
            pass  # warming is best-effort; the real dispatch will compile

    def _pump_decodes() -> None:
        while len(decode_q) < prefetch:
            item = next(src_iter, None)
            if item is None:
                return
            decode_q.append(decode_pool.submit(_load, item))

    def _absorb(loaded) -> None:
        nonlocal n_done
        idx, src, audio, n_bucket, payload, nv, stats = loaded
        if isinstance(audio, Exception):
            # decode/coerce failure: isolate the track, keep the sweep,
            # and surface the outcome to the caller
            results[idx] = TrackFailure(source=str(src), error=str(audio))
            with finish_lock:
                if manifest:
                    with manifest.open("a") as fh:
                        fh.write(
                            json.dumps({"source": str(src), "error": str(audio)}) + "\n"
                        )
                n_done += 1
                if progress_callback:
                    progress_callback(str(src), n_done, total)
            return
        # payload arity is part of the bucket key (transports differ;
        # under "ms" mono and stereo share the mid-only arity, so they
        # mix freely within a chunk)
        key = (n_bucket, len(payload))
        item = (idx, src, audio, payload, nv, stats)
        # n_lane is part of the executable identity: a device_batch>1
        # sweep must not be deduplicated against the batch-1 executable
        # the single-track path records.
        warm_key = (transport, target_sr, mesh_ids, n_lane) + key
        if prewarm and warm_key not in _WARMED_EXECUTABLES:
            _WARMED_EXECUTABLES.add(warm_key)
            warm_pool.submit(_warm_executable, item)
        buckets.setdefault(key, []).append(item)

    def _form_chunks(flush: bool) -> None:
        for key in sorted(buckets):
            items = buckets[key]
            # Longest-first within a bucket: lanes in one chunk then have
            # similar valid lengths, so their all-zero tail chunks ALIGN
            # and stage as the shared zero buffer (no upload bytes). With
            # mixed lengths in one chunk, the short lane's zeros must
            # ship to fill the stacked part.
            items.sort(key=lambda it: -it[4])
            while len(items) >= n_lane or (flush and items):
                chunk, items = items[:n_lane], items[n_lane:]
                buckets[key] = items
                staged_q.append((chunk, upload_pool.submit(_stage, chunk)))

    try:
        with mesh:
            _pump_decodes()
            while True:
                # Absorb completed decodes without blocking, keep the
                # decode pool topped up, and form full chunks.
                while decode_q and decode_q[0].done():
                    _absorb(decode_q.popleft().result())
                    _pump_decodes()
                _form_chunks(flush=not decode_q)

                if not staged_q:
                    if decode_q:  # nothing uploadable yet: block on decode
                        _absorb(decode_q.popleft().result())
                        _pump_decodes()
                        continue
                    if any(buckets.values()):  # trailing partial chunks
                        _form_chunks(flush=True)
                        continue
                    break  # everything dispatched

                # Dispatch the oldest staged chunk; upload of later chunks
                # and host finishing of earlier ones continue in parallel.
                chunk, staged_future = staged_q.popleft()
                staged, vb = staged_future.result()
                _dbg("dispatch.start", [c[0] for c in chunk])
                out_handle = _batched_for(chunk)(staged, vb)  # async dispatch
                _dbg("dispatch.issued", [c[0] for c in chunk])
                dispatched_q.append(finish_pool.submit(_finish, chunk, out_handle))
                while len(dispatched_q) > stage_depth:
                    dispatched_q.popleft().result()
            while dispatched_q:
                dispatched_q.popleft().result()
    finally:
        decode_pool.shutdown(wait=True)
        upload_pool.shutdown(wait=True)
        finish_pool.shutdown(wait=True)
        warm_pool.shutdown(wait=True)

    return results
