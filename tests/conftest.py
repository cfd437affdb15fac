"""Test harness: run everything on a virtual 8-device CPU mesh.

CI needs no accelerator: JAX's CPU backend executes the same XLA graphs,
and the forced 8-device host platform exercises the sharding/pjit paths
as eight cards would (minus the interconnect).
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import pytest

# The CPU unless JAX_PLATFORMS names another platform: the GPU-marked
# tests run with JAX_PLATFORMS=cuda on a machine with a card.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent XLA compile cache: the suite's cost is dominated by CPU
# compiles of the fused/batched graphs (~30-90 s each); keyed on the HLO
# hash, so stale entries are impossible and repeat runs skip straight to
# execution. Safe to delete the directory at any time. A cache directory
# given by JAX_COMPILATION_CACHE_DIR takes precedence.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        str(Path(__file__).resolve().parents[1] / ".jax_test_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Make the repo root (package) and tests dir (shared synth helpers)
# importable when running from a source checkout.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
