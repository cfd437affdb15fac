"""Transport bit-depth gate sweep: measure, don't guess.

The library sweep ships 1.0 B per stereo sample pair (mid-only
blockwise int8). Every proposed byte reduction must clear the
reference's accuracy gates (BPM ±0.1, beat grid ≤5 ms, LUFS ±0.3, true
peak ±0.2 dB, key exact — SURVEY.md §6) on the SAME fixtures the test
suite enforces them on. This script quantises each gate fixture with
blockwise int-k for k ∈ {8, 6, 5, 4} (and two block lengths: the
production 65 536 and a short 8 192 that adapts faster to transients),
dequantises, and reports the gate deltas alongside the float baseline.

Round-3 history this extends (RUNBOOK.md):
- raw int4 (65 536 blocks): beat grid FAILS at ~145 ms (quiet clicks
  vanish under a loud block peak's 4-bit step); LUFS/true-peak fail.
- one-tap DPCM int4: still fails the beat grid gate (18.1 ms).
- SHIPPED from this data: "ms6" (0.75 B per stereo sample pair) — the
  per-block best-of raw/delta 6-bit codec measured by the dedicated
  row at the end of the --robust grid.

Usage: python scripts/sweep_transport_bits.py [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))


def quantise_blockwise(x: np.ndarray, bits: int, block: int) -> np.ndarray:
    """Round-trip blockwise int-k quantisation (same recipe as the
    production _quantise_i8: per-block peak scale, round-to-nearest)."""

    qmax = float(2 ** (bits - 1) - 1)
    n = x.size
    n_pad = -(-n // block) * block
    xp = np.zeros(n_pad, dtype=np.float32)
    xp[:n] = x
    blocks = xp.reshape(-1, block)
    scales = np.abs(blocks).max(axis=-1)
    inv = qmax / np.where(scales > 0, scales, 1.0)
    codes = np.rint(np.clip(blocks * inv[:, None], -qmax, qmax))
    out = codes * (scales[:, None] / qmax)
    return out.reshape(-1)[:n].astype(np.float32)


def roundtrip_ms6(x: np.ndarray) -> np.ndarray:
    """Round-trip through the SHIPPED ms6 codec (per-block best-of
    raw/delta-with-error-feedback 6-bit, parallel/batch.py) so the sweep
    measures the production transport, not a simulation."""

    import jax.numpy as jnp

    from track_analyser_tpu.parallel.batch import (
        _I8_BLOCK,
        _dequantise_mono_i6,
        _quantise_mid6_range,
    )

    x = np.asarray(x, dtype=np.float32)
    n_pad = -(-x.size // _I8_BLOCK) * _I8_BLOCK
    channels = np.stack([x, x])
    native = None
    try:
        from track_analyser_tpu.native import binding

        native = binding.quantise_mid6(channels, n_pad, _I8_BLOCK)
    except Exception:
        native = None
    if native is not None:
        packed, scales, bases, _stats, _carry = native
    else:  # numpy fallback is bit-identical, just slower (sequential EF)
        packed, scales, bases, _stats, _carry = _quantise_mid6_range(
            channels, x.size, 0, n_pad
        )
    y = _dequantise_mono_i6(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(bases))
    return np.asarray(y)[: x.size]


def robust(block_lengths: "tuple[int, ...]", bits_list: "tuple[int, ...]") -> None:
    """Robustness mode: worst-case gate deltas per (bits, block) over
    4 BPMs x 4 noise seeds of the noisy-click fixture (the configuration
    that rejected int6/int5 at 65 536 blocks in round 3), plus the
    LUFS / true-peak / key gates. A small block adapts the quantisation
    step to local signal level, so quiet clicks between loud blocks keep
    timing resolution — this measures whether that unlocks sub-8-bit."""

    from synth import click_grid, progression, sine_at_rms_db
    from track_analyser_tpu.analysis.loudness import measure_loudness, true_peak_dbtp
    from track_analyser_tpu.harmony import key_estimate
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    SR_T = 48_000
    bpms = (96.0, 120.0, 128.0, 132.0)
    seeds = (1234, 77, 2024, 5)
    fixtures = {
        (bpm, seed): click_grid(bpm, 256, SR_T, noise_db=-34.0, seed=seed)
        for bpm in bpms
        for seed in seeds
    }
    tone = sine_at_rms_db(-18.0, 1000.0, 1.0, SR_T)
    prog = progression([(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")], 1.0, 22_050)
    base_lufs = measure_loudness(tone, SR_T)[0]
    base_tp = true_peak_dbtp(tone, SR_T, oversample=8)

    def gate_errors(y: np.ndarray, bpm: float, truth: np.ndarray) -> "tuple[float, float]":
        bpm_err = abs(estimate_bpm(y, SR_T) - bpm)
        fitted = beat_grid(y, SR_T)["time"].to_numpy()[: truth.size]
        if fitted.size < truth.size:
            return bpm_err, float("inf")
        return bpm_err, float(np.max(np.abs(fitted - truth))) * 1e3

    # Float baseline FIRST: the noisy-click fixtures are adversarial and
    # a given (bpm, seed) may sit outside the analyser's own envelope
    # unquantised — transport verdicts must gate on the DELTA a bit
    # depth adds over the float analysis, not on absolute error alone.
    base_err = {
        key: gate_errors(click, key[0], truth)
        for key, (click, truth) in fixtures.items()
    }
    worst_base = max(g for (_b, g) in base_err.values())
    worst_key = max(base_err, key=lambda k: base_err[k][1])
    print(
        f"float baseline: worst_bpm {max(b for (b, _g) in base_err.values()):.3f}  "
        f"worst_grid_ms {worst_base:.1f}  (worst fixture bpm={worst_key[0]} "
        f"seed={worst_key[1]})"
    )

    header = (
        f"{'bits':>4} {'block':>6} | {'worst_bpm':>9} {'worst_grid_ms':>13} "
        f"{'worst_dgrid':>11} {'lufs_err':>8} {'tp_err':>7} {'key':>8} | verdict"
    )
    print(header)
    print("-" * len(header))
    for bits in bits_list:
        for block in block_lengths:
            worst_bpm = 0.0
            worst_grid = 0.0
            worst_dgrid = 0.0  # grid degradation ADDED by quantisation
            for key_f, (click, truth) in fixtures.items():
                bpm = key_f[0]
                qc = quantise_blockwise(click, bits, block)
                bpm_err, grid_err = gate_errors(qc, bpm, truth)
                worst_bpm = max(worst_bpm, bpm_err)
                worst_grid = max(worst_grid, grid_err)
                worst_dgrid = max(worst_dgrid, grid_err - base_err[key_f][1])
            qt = quantise_blockwise(tone, bits, block)
            lufs_err = abs(measure_loudness(qt, SR_T)[0] - base_lufs)
            tp_err = abs(true_peak_dbtp(qt, SR_T, oversample=8) - base_tp)
            key = key_estimate(quantise_blockwise(prog, bits, block), 22_050).best.key
            ok = (
                worst_bpm <= 0.1
                and (worst_grid <= 5.0 or worst_dgrid <= 3.5)
                and lufs_err <= 0.3
                and tp_err <= 0.2
                and key == "C major"
            )
            print(
                f"{bits:>4} {block:>6} | {worst_bpm:9.3f} {worst_grid:13.1f} "
                f"{worst_dgrid:11.1f} {lufs_err:8.3f} {tp_err:7.3f} {key:>8} | "
                f"{'PASS' if ok else 'FAIL'}",
                flush=True,
            )

    # The SHIPPED ms6 codec (best-of raw/delta per block) over the same
    # fixtures — this is the row the RUNBOOK's ms6 claims cite.
    worst_bpm = worst_grid = worst_dgrid = 0.0
    for key_f, (click, truth) in fixtures.items():
        bpm_err, grid_err = gate_errors(roundtrip_ms6(click), key_f[0], truth)
        worst_bpm = max(worst_bpm, bpm_err)
        worst_grid = max(worst_grid, grid_err)
        worst_dgrid = max(worst_dgrid, grid_err - base_err[key_f][1])
    lufs_err = abs(measure_loudness(roundtrip_ms6(tone), SR_T)[0] - base_lufs)
    tp_err = abs(true_peak_dbtp(roundtrip_ms6(tone), SR_T, oversample=8) - base_tp)
    key = key_estimate(roundtrip_ms6(prog), 22_050).best.key
    ok = (
        worst_bpm <= 0.1
        and (worst_grid <= 5.0 or worst_dgrid <= 3.5)
        and lufs_err <= 0.3
        and tp_err <= 0.2
        and key == "C major"
    )
    print(
        f" ms6  (shipped) | {worst_bpm:9.3f} {worst_grid:13.1f} "
        f"{worst_dgrid:11.1f} {lufs_err:8.3f} {tp_err:7.3f} {key:>8} | "
        f"{'PASS' if ok else 'FAIL'}",
        flush=True,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--robust",
        action="store_true",
        help="worst-case over 4 BPMs x 4 seeds, sub-8-bit x block-length grid",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.robust:
        robust(block_lengths=(65_536, 16_384, 8_192, 4_096), bits_list=(8, 6, 5))
        return

    from synth import click_grid, progression, sine_at_rms_db
    from track_analyser_tpu.analysis.loudness import measure_loudness, true_peak_dbtp
    from track_analyser_tpu.harmony import key_estimate
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    # --- fixtures: exactly the suites' gate signals -----------------------
    SR_T = 48_000
    click, truth = click_grid(120.0, 64 * 4, SR_T, noise_db=-34.0, seed=1234)
    tone = sine_at_rms_db(-18.0, 1000.0, 1.0, SR_T)
    prog = progression([(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")], 1.0, 22_050)

    # float baselines
    base_lufs = measure_loudness(tone, SR_T)[0]
    base_tp = true_peak_dbtp(tone, SR_T, oversample=8)

    print(
        f"float baseline: lufs={base_lufs:+.3f}  tp={base_tp:+.3f}  "
        f"(gates: bpm ±0.1, grid ≤5 ms, lufs ±0.3, tp ±0.2 dB, key exact)"
    )
    header = (
        f"{'bits':>4} {'block':>6} | {'bpm_err':>8} {'grid_ms':>8} "
        f"{'lufs_err':>8} {'tp_err':>7} {'key':>8} | verdict"
    )
    print(header)
    print("-" * len(header))

    for bits in (8, 6, 5, 4):
        for block in (65_536, 8_192):
            qc = quantise_blockwise(click, bits, block)
            bpm_err = abs(estimate_bpm(qc, SR_T) - 120.0)
            grid = beat_grid(qc, SR_T)
            fitted = grid["time"].to_numpy()[: truth.size]
            grid_ms = (
                float(np.max(np.abs(fitted - truth))) * 1e3
                if fitted.size >= truth.size
                else float("inf")
            )

            qt = quantise_blockwise(tone, bits, block)
            lufs_err = abs(measure_loudness(qt, SR_T)[0] - base_lufs)
            tp_err = abs(true_peak_dbtp(qt, SR_T, oversample=8) - base_tp)

            qp = quantise_blockwise(prog, bits, block)
            key = key_estimate(qp, 22_050).best.key

            ok = (
                bpm_err <= 0.1
                and grid_ms <= 5.0
                and lufs_err <= 0.3
                and tp_err <= 0.2
                and key == "C major"
            )
            print(
                f"{bits:>4} {block:>6} | {bpm_err:8.3f} {grid_ms:8.1f} "
                f"{lufs_err:8.3f} {tp_err:7.3f} {key:>8} | "
                f"{'PASS' if ok else 'FAIL'}",
                flush=True,
            )


if __name__ == "__main__":
    main()
