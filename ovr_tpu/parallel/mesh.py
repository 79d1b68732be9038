"""Device-mesh construction for multi-chip / multi-host rendering.

The reference is single-GPU by design (`ovr/devices/optix7/device_impl.cpp:
370-372` hardcodes device 0); scaling here is a 2D
`jax.sharding.Mesh` with a `tiles` axis (image-plane data parallelism — rays
are embarrassingly parallel in the forward pass) and an optional `bricks`
axis (the volume split along the ray direction; partial (color,
transmittance) pairs are composited with the associative over-operator around
a ring — see ovr_tpu.parallel.bricks).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"
BRICK_AXIS = "bricks"


def make_mesh(n_tiles: int | None = None, n_bricks: int = 1,
              devices=None) -> Mesh:
    """Create a (tiles, bricks) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_tiles is None:
        n_tiles = n // n_bricks
    assert n_tiles * n_bricks <= n, (
        f"need {n_tiles}x{n_bricks} devices, have {n}")
    grid = np.asarray(devices[: n_tiles * n_bricks]).reshape(
        n_tiles, n_bricks)
    return Mesh(grid, (TILE_AXIS, BRICK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (image-row) axis over tiles."""
    return NamedSharding(mesh, P(TILE_AXIS))
