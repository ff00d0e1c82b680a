"""Device mesh construction.

The reference's parallel runtime is an atomic tile-queue over
hardware_concurrency() threads (reference: src/latest/rayweek1.cpp:785-842).
Here it is a `jax.sharding.Mesh`: the schedule is static SPMD — every device
knows its ray shard up front — and reductions are collectives instead of a
thread join (SURVEY.md §2.3). The mesh is 1-D: every GPU of a host reaches
every other at the same rate, so no device order is better than another.

Axis convention:
  "rays"    — data-parallel axis over primary rays (pixels x samples fused).
              This is the renderer's only *required* axis: the scene SoA is
              replicated (a few KB), so there is no tensor/model axis to
              shard. Pixel- and sample-parallelism are both expressible as
              ray-parallelism because ray_id enumerates (pixel, sample) pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rays",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first n_devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh2d(n_tiles: int, n_samples: int,
                axis_names: Sequence[str] = ("tiles", "samples"),
                devices: Optional[Sequence] = None) -> Mesh:
    """A (tiles, samples) 2-D mesh (SURVEY.md §7.2-6): the first axis shards
    pixel-tile slots, the second the sample dimension (requires
    n_samples | spp at render time). Factorizing the same devices differently
    cannot change the image — the stateless RNG keys on global ray ids."""
    if devices is None:
        devices = jax.devices()
    n = n_tiles * n_samples
    assert len(devices) >= n, (len(devices), n)
    grid = np.asarray(devices[:n]).reshape(n_tiles, n_samples)
    return Mesh(grid, tuple(axis_names))
