"""Multi-resolution hash-grid encoding (instant-ngp style).

Realizes the reference's planned neural-volume path (`README.md:12` "support
more hardware platforms", the vestigial tiny-cuda-nn include in
`ovr/common/evaluation_kernel.h:10` and the not-compiled `vnr` sources under
`ovr/devices/optix7/render/`): a compact neural scalar field queried in place
of the 3D texture.

Feature lookups are XLA gathers; the per-level loop is unrolled (L is small
and static) so XLA fuses the hashing arithmetic; the follow-on MLP
(ovr_tpu.neural.field) carries the FLOPs as matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# instant-ngp spatial hashing primes
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    features_per_level: int = 2
    log2_table_size: int = 17
    base_resolution: int = 16
    max_resolution: int = 512

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level

    def level_resolutions(self) -> np.ndarray:
        if self.n_levels == 1:
            return np.array([self.base_resolution])
        growth = np.exp(
            (np.log(self.max_resolution) - np.log(self.base_resolution))
            / (self.n_levels - 1))
        return np.floor(
            self.base_resolution * growth ** np.arange(self.n_levels)
        ).astype(np.int64)


def init_hashgrid(key: jax.Array, cfg: HashGridConfig) -> jnp.ndarray:
    """Feature tables (L, T, F), uniform in [-1e-4, 1e-4] (ngp init)."""
    return jax.random.uniform(
        key, (cfg.n_levels, cfg.table_size, cfg.features_per_level),
        minval=-1e-4, maxval=1e-4, dtype=jnp.float32)


def _hash_corner(ix, iy, iz, table_size):
    p1 = jnp.uint32(_PRIMES[1])
    p2 = jnp.uint32(_PRIMES[2])
    h = ix ^ (iy * p1) ^ (iz * p2)
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


def encode(tables: jnp.ndarray, cfg: HashGridConfig,
           p: jnp.ndarray) -> jnp.ndarray:
    """Encode positions p (..., 3) in [0,1]^3 -> features (..., L*F)."""
    resolutions = cfg.level_resolutions()
    p = jnp.clip(p, 0.0, 1.0)
    feats = []
    for li in range(cfg.n_levels):
        r = int(resolutions[li])
        c = p * r  # corner lattice: r+1 corners per axis
        i0 = jnp.clip(jnp.floor(c), 0, r - 1).astype(jnp.uint32)
        f = c - i0.astype(p.dtype)
        i1 = i0 + 1
        table = tables[li]

        def corner(ix, iy, iz):
            idx = _hash_corner(ix, iy, iz, cfg.table_size)
            return table[idx]

        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
        fx = f[..., 0:1]
        fy = f[..., 1:2]
        fz = f[..., 2:3]
        c00 = corner(x0, y0, z0) * (1 - fx) + corner(x1, y0, z0) * fx
        c10 = corner(x0, y1, z0) * (1 - fx) + corner(x1, y1, z0) * fx
        c01 = corner(x0, y0, z1) * (1 - fx) + corner(x1, y0, z1) * fx
        c11 = corner(x0, y1, z1) * (1 - fx) + corner(x1, y1, z1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        feats.append(c0 * (1 - fz) + c1 * fz)
    return jnp.concatenate(feats, axis=-1)
