"""Multi-host (multi-process) distribution scaffolding.

The reference is strictly single-process/single-GPU
(`ovr/devices/optix7/device_impl.cpp:370-372`); this is the SURVEY §5.8 /
BASELINE multi-host target: `jax.distributed.initialize` per process, one
global mesh spanning every process's devices, image tiles sharded over the
cross-host axis (the network between hosts — forward rendering needs no
communication) and volume bricks over the intra-host axis (the ring
compositor's ppermute hops stay on the host's device links, NVLink on GPU
hosts).

Usage (one process per host):

    from ovr_tpu.parallel import multihost
    multihost.initialize(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh(n_bricks=devices_per_host)
    frame = tiles.render_sharded(scene, cfg, mesh)      # tiles over DCN
    img = multihost.gather_frame(frame)                 # host numpy (all)

Tested with two coordinated CPU processes in tests/test_multihost.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh

from ovr_tpu.parallel.mesh import BRICK_AXIS, TILE_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kw) -> None:
    """`jax.distributed.initialize` wrapper (idempotent per process).

    Pass the coordinator address (`host:port`), the process count and this
    process's id; without them JAX needs a cluster environment it can
    detect.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id, **kw)


def global_mesh(n_bricks: int = 1) -> Mesh:
    """(tiles, bricks) mesh over every device of every process.

    Devices are ordered process-major, so the `bricks` axis (stride-1,
    n_bricks consecutive devices) stays within one host — its ppermute ring
    rides the host's device links — while `tiles` spans hosts. Requires each process's
    device count to be a multiple of n_bricks.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    counts = {}
    for d in devs:
        counts[d.process_index] = counts.get(d.process_index, 0) + 1
    for p, c in counts.items():
        if c % n_bricks:
            raise ValueError(
                f"process {p} has {c} devices, not divisible into "
                f"{n_bricks} bricks")
    grid = np.asarray(devs, dtype=object).reshape(-1, n_bricks)
    return Mesh(grid, (TILE_AXIS, BRICK_AXIS))


def gather_frame(frame) -> np.ndarray:
    """Assemble a (possibly cross-host) sharded framebuffer into host numpy
    on every process (the mapframe() of the distributed path)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(frame, tiled=True))
