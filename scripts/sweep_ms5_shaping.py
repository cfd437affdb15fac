"""ms5 dense-mix BPM recovery: measure candidate sub-0.75 B/pair codings.

The only gate ms5 (0.63 B/pair) misses is the DENSE-mix ±0.1 BPM bound
(tests/test_agreement.py pins its envelope at ±0.3; ms6 holds ±0.1).
Root cause per RUNBOOK: 5-bit quantisation noise on the onset envelope.
This script measures, on the dense fixtures AND the adversarial click
grids, per-candidate BPM/grid error so a shipped coding is chosen on
data (the round-3/4 discipline for every transport change):

  c0  ms5 shipped        — per-block best-of {raw, delta-EF}, 15 levels
  c1  ms5 + noise shaping — delta mode error feedback filtered with a
      one-tap shaper (alpha sweep): e[n] = eps[n] + alpha*e[n-1] in
      reconstruction-noise terms. Encoder-only (decoder law unchanged).
  c2  ms5 + 2nd-order prediction mode — a third per-block coding whose
      residual is the SECOND difference (decoded as a double cumsum);
      big prediction gain on tonal (dense) content. Format change: one
      extra mode array (1 B per 1024-sample block, +0.001 B/pair).

Usage: python scripts/sweep_ms5_shaping.py [--quick]
Forces CPU (measurement is envelope/BPM math, not device perf).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

BLOCK = 1024
QMAX = 15.0


# ---------------------------------------------------------------------------
# Candidate encoders. All decode with y = base + cumsum(codes)*step (delta)
# or y = codes*step (raw) — c2 adds y = base + slope_ramp + cumsum(cumsum)*step.
# ---------------------------------------------------------------------------


def _encode_raw(row: np.ndarray) -> tuple[np.ndarray, float, float]:
    """(codes, scale, max_err) for the raw coding of one block."""

    peak = float(np.abs(row).max())
    s = peak if peak > 0 else 1.0
    step = s / QMAX
    codes = np.rint(np.clip(row / step, -QMAX, QMAX))
    err = float(np.abs(codes * step - row).max())
    return codes, peak, err


def _encode_delta(
    row: np.ndarray, carry: float, alpha: float = 0.0
) -> tuple[np.ndarray, float, float, float]:
    """(codes, dpk, max_err, carry_out) for delta-EF with optional noise
    shaping: the quantiser target includes -alpha * previous
    reconstruction error, shaping E(z) = eps(z)/(1 - alpha z^-1)
    (alpha>0 pushes reconstruction noise toward LOW frequencies,
    alpha<0 toward Nyquist). alpha=0 is the shipped coding."""

    dpk = float(np.abs(np.diff(row, prepend=carry)).max())
    if dpk <= 0:
        return np.zeros(row.size), 0.0, abs(carry), carry
    step = dpk / QMAX
    codes = np.empty(row.size)
    prev = carry
    e_prev = 0.0
    max_err = 0.0
    for i in range(row.size):
        target = row[i] + alpha * e_prev
        c = np.rint(min(max((target - prev) / step, -QMAX), QMAX))
        codes[i] = c
        prev = prev + c * step
        e_prev = prev - row[i]
        if abs(e_prev) > max_err:
            max_err = abs(e_prev)
    return codes, dpk, max_err, prev


def _encode_delta2(
    row: np.ndarray, carry: float, dcarry: float
) -> tuple[np.ndarray, float, float, float, float]:
    """Second-order predictive coding: predict x[n] ~ prev + dprev
    (linear extrapolation), quantise the correction. Decoder:
    d[n] = d[n-1] + c[n]*step; y[n] = y[n-1] + d[n] — a double cumsum,
    still block-parallel given (base, dbase). Scale = second-difference
    peak."""

    d2 = np.diff(row, n=1, prepend=carry)
    d2 = np.diff(d2, n=1, prepend=dcarry)
    pk = float(np.abs(d2).max())
    if pk <= 0:
        return np.zeros(row.size), 0.0, abs(carry), carry, dcarry
    step = pk / QMAX
    codes = np.empty(row.size)
    prev = carry
    dprev = dcarry
    max_err = 0.0
    for i in range(row.size):
        pred = prev + dprev
        c = np.rint(min(max((row[i] - pred) / step, -QMAX), QMAX))
        codes[i] = c
        dprev = dprev + c * step
        prev = prev + dprev
        e = abs(prev - row[i])
        if e > max_err:
            max_err = e
    return codes, pk, max_err, prev, dprev


def roundtrip(x: np.ndarray, *, alpha: float = 0.0, use_d2: bool = False) -> tuple[np.ndarray, dict]:
    """Best-of per block over {raw, delta(alpha)} (+ delta2 when
    use_d2). Returns (reconstruction, mode histogram)."""

    n = x.size
    n_pad = -(-n // BLOCK) * BLOCK
    xp = np.zeros(n_pad, dtype=np.float64)
    xp[:n] = x
    out = np.empty_like(xp)
    carry = 0.0
    dcarry = 0.0
    hist = {"raw": 0, "delta": 0, "delta2": 0}
    for b in range(n_pad // BLOCK):
        row = xp[b * BLOCK : (b + 1) * BLOCK]
        rcodes, rpeak, rerr = _encode_raw(row)
        dcodes, dpk, derr, dcarry_out = _encode_delta(row, carry, alpha)
        cands = [("raw", rerr), ("delta", derr)]
        if use_d2:
            c2, pk2, err2, cy2, dy2 = _encode_delta2(row, carry, dcarry)
            cands.append(("delta2", err2))
        # mirror the shipped selector: delta must HALVE raw's error
        best = "raw"
        if derr < 0.5 * rerr:
            best = "delta"
        if use_d2 and err2 < 0.5 * rerr and err2 < derr:
            best = "delta2"
        hist[best] += 1
        if best == "raw":
            step = (rpeak if rpeak > 0 else 1.0) / QMAX
            y = rcodes * step
            carry = float(y[-1])
            dcarry = float(y[-1] - y[-2]) if row.size > 1 else 0.0
        elif best == "delta":
            step = dpk / QMAX if dpk > 0 else 0.0
            y = carry + np.cumsum(dcodes) * step
            dcarry = float(y[-1] - y[-2]) if row.size > 1 else 0.0
            carry = float(y[-1])
        else:
            step = pk2 / QMAX if pk2 > 0 else 0.0
            d = dcarry + np.cumsum(c2) * step
            y = carry + np.cumsum(d)
            carry, dcarry = float(y[-1]), float(d[-1])
        out[b * BLOCK : (b + 1) * BLOCK] = y
    return out[:n].astype(np.float32), hist


# ---------------------------------------------------------------------------
# Fixtures + metrics
# ---------------------------------------------------------------------------


def dense_mix(seconds: float = 20.0, sr: int = 22_050, seed: int = 0) -> np.ndarray:
    """The agreement test's _rich_track mid channel (kick grid at 120 BPM
    + I-IV-V-I chords + a weak 3 kHz component)."""

    from synth import progression

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    chords = np.tile(
        progression([(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")], 2.5, sr), 2
    )[:n]
    kick = np.zeros(n, dtype=np.float64)
    for i, b in enumerate(np.arange(0.0, seconds, 0.5)):
        s = int(b * sr)
        e = min(n, s + int(0.05 * sr))
        seg = np.arange(e - s) / sr
        amp = 1.0 if i % 4 == 0 else 0.45
        kick[s:e] += amp * np.sin(2 * np.pi * (60 + 50 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 40)
    left = 0.5 * chords + 0.8 * kick
    right = 0.35 * chords + 0.8 * kick + 0.05 * np.sin(2 * np.pi * 3000.0 * t)
    mid = 0.5 * (left + right)
    mid = mid / np.abs(np.stack([left, right])).max() * 0.9
    _ = rng  # seed reserved for variants
    return mid.astype(np.float32)


def minor_sparse(seconds: float = 20.0, sr: int = 22_050, bpm: float = 96.0) -> np.ndarray:
    """Minor-key pads with SPARSE percussion (soft kick every other beat)
    — the near-tie class the bench's second warmup fixture targets: weak
    onsets under sustained tonal content, where envelope noise has the
    most leverage."""

    from synth import triad

    n = int(seconds * sr)
    beat = 60.0 / bpm
    pads = np.tile(
        np.concatenate(
            [
                triad(57, "min", 4 * beat, sr),  # A minor
                triad(62, "min", 4 * beat, sr),  # D minor
                triad(64, "min", 4 * beat, sr),  # E minor
                triad(57, "min", 4 * beat, sr),
            ]
        ),
        3,
    )[:n]
    kick = np.zeros(n)
    for i, b in enumerate(np.arange(0.0, seconds, beat)):
        if i % 2:
            continue  # every other beat only
        s = int(b * sr)
        e = min(n, s + int(0.04 * sr))
        seg = np.arange(e - s) / sr
        kick[s:e] += 0.35 * np.sin(2 * np.pi * (55 + 45 * np.exp(-seg * 70)) * seg) * np.exp(-seg * 45)
    mid = 0.6 * pads + kick
    return (mid / np.abs(mid).max() * 0.9).astype(np.float32)


def bench_mix(seconds: float = 30.0, sr: int = 44_100, bpm: float = 126.0, seed: int = 7) -> np.ndarray:
    """bench.py's make_track mid channel (club-style kick+bass+chords+hats)."""

    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(seed)
    beat = 60.0 / bpm
    kick = np.zeros(n)
    hat = np.zeros(n)
    for b in np.arange(0.0, seconds, beat):
        s = int(b * sr)
        e = min(n, s + int(0.08 * sr))
        seg = np.arange(e - s) / sr
        kick[s:e] += np.sin(2 * np.pi * (60 + 40 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 30)
        hs = int((b + beat / 2) * sr)
        he = min(n, hs + int(0.02 * sr))
        if he > hs:
            hat[hs:he] += rng.normal(0, 0.15, he - hs) * np.exp(-np.arange(he - hs) / (0.004 * sr))
    bass = 0.2 * np.sin(2 * np.pi * 55.0 * t) * (np.sin(2 * np.pi * t / 8.0) > 0)
    chords = 0.1 * (
        np.sin(2 * np.pi * 220.0 * t) + np.sin(2 * np.pi * 277.18 * t) + np.sin(2 * np.pi * 329.63 * t)
    )
    left = 0.8 * kick + bass + chords + 0.6 * hat
    right = 0.8 * kick + bass + 0.9 * chords + 0.5 * hat
    peak = max(np.abs(left).max(), np.abs(right).max())
    mid = 0.5 * (left / peak * 0.9 + right / peak * 0.9)
    return mid.astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    from synth import click_grid
    from track_analyser_tpu.tempo import beat_grid, estimate_bpm

    fixtures = {
        "dense22k@120": (dense_mix(), 22_050, 120.0),
        "minorsparse@96": (minor_sparse(), 22_050, 96.0),
        "bench44k@126": (bench_mix(), 44_100, 126.0),
        "bench44k@118": (bench_mix(bpm=118.0, seed=3), 44_100, 118.0),
    }
    clicks = {}
    if not args.quick:
        for bpm in (96.0, 120.0, 132.0):
            for seed in (1234, 77):
                clicks[(bpm, seed)] = click_grid(bpm, 128, 48_000, noise_db=-34.0, seed=seed)

    candidates = [
        ("float", None),
        ("ms5", dict(alpha=0.0)),
        ("ms5 a=-0.25", dict(alpha=-0.25)),
        ("ms5 a=-0.5", dict(alpha=-0.5)),
        ("ms5 a=-0.75", dict(alpha=-0.75)),
        ("ms5 +d2", dict(alpha=0.0, use_d2=True)),
        ("ms5 a=-.5+d2", dict(alpha=-0.5, use_d2=True)),
    ]

    print(f"{'candidate':>14} | " + " | ".join(f"{k:>16}" for k in fixtures) + " | snr_dense")
    for name, kw in candidates:
        cols = []
        snr = ""
        for fk, (x, sr, bpm) in fixtures.items():
            t0 = time.time()
            if kw is None:
                y = x
            else:
                y, hist = roundtrip(x, **kw)
            err = abs(estimate_bpm(y, sr) - bpm)
            cols.append(f"{err:7.3f} ({time.time()-t0:4.1f}s)")
            if fk == "dense22k@120" and kw is not None:
                e = y - x
                snr = f"{10*np.log10(np.dot(x,x)/max(np.dot(e,e),1e-20)):.1f} dB {hist}"
        print(f"{name:>14} | " + " | ".join(f"{c:>16}" for c in cols) + f" | {snr}", flush=True)

    if clicks:
        print("\nadversarial click grids (worst added grid error vs float, ms):")
        for name, kw in candidates:
            if kw is None:
                base = {}
                for key, (click, truth) in clicks.items():
                    fitted = beat_grid(click, 48_000)["time"].to_numpy()[: truth.size]
                    base[key] = (
                        float(np.max(np.abs(fitted - truth))) * 1e3
                        if fitted.size >= truth.size
                        else float("inf")
                    )
                continue
            worst_d = 0.0
            worst_bpm = 0.0
            for key, (click, truth) in clicks.items():
                y, _ = roundtrip(click, **kw)
                worst_bpm = max(worst_bpm, abs(estimate_bpm(y, 48_000) - key[0]))
                fitted = beat_grid(y, 48_000)["time"].to_numpy()[: truth.size]
                g = (
                    float(np.max(np.abs(fitted - truth))) * 1e3
                    if fitted.size >= truth.size
                    else float("inf")
                )
                worst_d = max(worst_d, g - base[key])
            print(f"{name:>14} | worst_bpm {worst_bpm:6.3f} | worst_added_grid {worst_d:5.1f} ms", flush=True)


if __name__ == "__main__":
    main()
