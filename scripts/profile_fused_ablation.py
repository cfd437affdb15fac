"""Leave-one-out device-time attribution of the fused graph.

Jits the REAL ``substrate.full_track_graph`` but returns only a subset
of its outputs — XLA dead-code-eliminates everything the subset does not
depend on, so (full − without-group) is the marginal device cost of a
group *under the production fusion decisions*, which separately-jitted
stage timings cannot see.

Each variant is timed with ``block_until_ready``, best of 4, on
device-resident inputs.

Run: python scripts/profile_fused_ablation.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# Output groups whose marginal cost we want. Dropping a group's keys
# must actually free its compute: keys listed here are the ONLY
# consumers of their subgraphs (e.g. dropping "novelty" kills HPSS +
# MFCC self-similarity; "key_scores" alone keeps chroma alive).
GROUPS = {
    "tempo (onset env + autocorr)": ["onset_env", "autocorr", "beat_energy", "low_energy"],
    "structure (HPSS + novelty)": ["novelty", "energy_novelty", "perc_col", "harm_col"],
    "features (ltas/centroid/rolloff)": ["ltas", "centroid", "rolloff"],
    "harmony (chroma + key)": ["chroma_cq", "key_scores"],
    "balance (4096 stft)": ["balance_total", "balance_low", "balance_mid", "balance_high"],
    "loudness gated": ["integrated_lufs"],
    "loudness curves": ["short_term_db", "momentary_db"],
    "true peak": ["true_peak"],
    "stereo scalars + widths": [
        "stereo_corr_centered",
        "stereo_balance",
        "mid_rms",
        "side_rms",
        "stereo_widths",
        "rms",
    ],
}


def main() -> None:
    from track_analyser_tpu.utils import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()

    import jax
    import jax.numpy as jnp

    from track_analyser_tpu.substrate import full_track_graph

    sr = 44_100
    n = 8_388_608  # 181 s bucket
    rng = np.random.default_rng(0)
    stereo_h = np.stack(
        [rng.normal(0, 0.1, n), rng.normal(0, 0.1, n)]
    ).astype(np.float32)
    dev = jax.devices()[0]
    stereo = jax.device_put(stereo_h, dev)
    nv = jax.device_put(np.int32(n - 12_345), dev)
    print(f"device: {dev}, n={n}")

    all_keys = list(
        jax.eval_shape(
            lambda s, v: full_track_graph(s, v, sr=sr),
            jax.ShapeDtypeStruct((2, 1 << 15), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.int32),
        )
    )

    def variant(keys):
        keys = [k for k in keys if k != "f_valid"]

        def fn(s, v):
            out = full_track_graph(s, v, sr=sr)
            return sum((jnp.sum(out[k]) for k in keys), s[0, 0] * 0.0)

        return jax.jit(fn)

    def timeit(label, keys):
        jitted = variant(keys)
        jax.block_until_ready(jitted(stereo, nv))  # compile
        best = 1e9
        for _ in range(4):
            t0 = time.perf_counter()
            jax.block_until_ready(jitted(stereo, nv))
            best = min(best, time.perf_counter() - t0)
        print(f"  {label}: {best * 1e3:.1f} ms", flush=True)
        return best

    full = timeit("FULL graph", all_keys)
    for name, keys in GROUPS.items():
        rest = [k for k in all_keys if k not in keys]
        t = timeit(f"without {name}", rest)
        print(f"    -> marginal {name}: {(full - t) * 1e3:+.1f} ms", flush=True)


if __name__ == "__main__":
    main()
