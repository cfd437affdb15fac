"""Device mesh helpers.

The framework's parallelism is expressed entirely through
``jax.sharding`` + XLA collectives (SURVEY.md section 2: the reference has
no distributed code, so this layer is a new first-class component):

* ``data`` axis — batch of tracks (library sweeps).
* ``seq`` axis — STFT frame axis of one long track (sequence parallelism,
  parallel/sharded.py).

Within one host the collectives run over the device interconnect
(NVLink between GPUs); across hosts ``jax.distributed.initialize``
applies unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "P"]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    Defaults to a 1-D ``data`` mesh over every addressable device; pass
    ``axis_sizes`` for multi-axis layouts, e.g. ``make_mesh((4, 2),
    ("data", "seq"))``.
    """

    devs = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devs),)
    total = int(np.prod(axis_sizes))
    if total > len(devs):
        raise ValueError(
            f"mesh of {axis_sizes} needs {total} devices, have {len(devs)}"
        )
    grid = np.asarray(devs[:total]).reshape(axis_sizes)
    return Mesh(grid, tuple(axis_names))


def data_sharding(mesh: Mesh, *, axis: str = "data", rank: int = 1) -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``; replicate the rest."""

    spec = P(axis, *([None] * (rank - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
