"""Macrocell spatial partition: per-cell value ranges + transfer-function
majorants, for empty-space skipping and delta tracking.

Re-expression of the reference's single-level macrocell structure
(`ovr/devices/optix7/accel/spatial_partition.h`, `accel/sp_singlemc.cu`):

- value ranges: one XLA `reduce_window` min/max over the voxel grid with an
  18-wide window at stride 16 (the reference's per-cell loop covers
  [cell*16-1, cell*16+16) plus clamp shift, `sp_singlemc.cu:35-43`; we use the
  slightly larger symmetric halo [cell*16-1, cell*16+17) which covers every
  voxel any trilinear fetch inside the cell can touch, so majorants remain
  strict upper bounds).
- majorants: max TF opacity over the cell's normalized value range, with the
  reference's index widening (floor(v*(N-1)+0.5) ∓ 1, `sp_singlemc.cu:79-90`),
  evaluated with a range-max sparse table (2 gathers per cell) instead of the
  shared-memory scan loop.

The `MacrocellGrid` pytree also provides the two queries the lockstep
integrator needs: `is_empty(p)` and `cell_exit_t(...)` — the vectorized
equivalent of per-ray DDA traversal (`accel/dda.h`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

MACROCELL_SIZE = 16  # spatial_partition.h: MACROCELL_SIZE = 1 << 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MacrocellGrid:
    """Per-macrocell (value_lo, value_hi, majorant) over a (Z, Y, X) grid."""

    value_lo: Any  # (MZ, MY, MX)
    value_hi: Any  # (MZ, MY, MX)
    majorant: Any  # (MZ, MY, MX)
    vol_dims: tuple[int, int, int]  # (X, Y, Z) voxel dims (static)

    @property
    def mc_dims(self) -> tuple[int, int, int]:
        """(MX, MY, MZ)."""
        mz, my, mx = self.value_lo.shape
        return (mx, my, mz)

    # ---- queries used by the integrator (object space p in [0,1]^3) ----

    def cell_index(self, p_obj: jnp.ndarray) -> jnp.ndarray:
        """Macrocell containing object-space point p (..., 3) -> (..., 3) int."""
        X, Y, Z = self.vol_dims
        dims = jnp.array([X, Y, Z], dtype=p_obj.dtype)
        mx, my, mz = self.mc_dims
        cell = jnp.floor(p_obj * dims / MACROCELL_SIZE).astype(jnp.int32)
        return jnp.clip(cell, 0, jnp.array([mx - 1, my - 1, mz - 1], jnp.int32))

    def majorant_at(self, p_obj: jnp.ndarray) -> jnp.ndarray:
        c = self.cell_index(p_obj)
        mx, my, _ = self.mc_dims
        flat = self.majorant.reshape(-1)
        idx = (c[..., 2] * self.majorant.shape[1] + c[..., 1]) * mx + c[..., 0]
        return flat[idx]

    def is_empty(self, p_obj: jnp.ndarray, eps: float = 1.19e-7) -> jnp.ndarray:
        return self.majorant_at(p_obj) <= eps

    def cell_exit_t(self, org, direction, t, world_lo, world_hi,
                    eps: float = 1e-5):
        """World-space t at which the ray leaves the macrocell containing
        org + t*dir, nudged past the boundary."""
        extent = world_hi - world_lo
        pos = org + t[..., None] * direction
        p_obj = (pos - world_lo) / extent
        c = self.cell_index(p_obj).astype(org.dtype)
        X, Y, Z = self.vol_dims
        dims = jnp.array([X, Y, Z], dtype=org.dtype)
        cell_w = MACROCELL_SIZE / dims  # object units per cell
        blo = world_lo + c * cell_w * extent
        bhi = world_lo + (c + 1.0) * cell_w * extent
        small = jnp.abs(direction) < 1e-12
        rcp = 1.0 / jnp.where(small, 1.0, direction)
        t_far = jnp.maximum((blo - org) * rcp, (bhi - org) * rcp)
        t_far = jnp.where(small, 3.4e38, t_far)
        return jnp.min(t_far, axis=-1) + eps


jax.tree_util.register_dataclass(
    MacrocellGrid, data_fields=["value_lo", "value_hi", "majorant"],
    meta_fields=["vol_dims"],
)


def compute_value_ranges(grid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-macrocell (lo, hi) over an 18-voxel window at stride 16.

    Semantics of `value_range_kernel` (`sp_singlemc.cu:10-54`) with the
    symmetric trilinear halo (see module docstring). Native-dtype (u8/u16)
    grids reduce in raw units — no f32 expansion of the volume — and the
    normalized-integer scale (`array.h:68-106`) is applied to the tiny
    per-cell results.
    """
    from ovr_tpu.core.sampling import storage_scale

    Zd, Yd, Xd = grid.shape
    mc = tuple(_cdiv(d, MACROCELL_SIZE) for d in (Zd, Yd, Xd))
    window = MACROCELL_SIZE + 2
    pads = tuple(
        (1, (m - 1) * MACROCELL_SIZE + window - 1 - d)
        for m, d in zip(mc, (Zd, Yd, Xd))
    )
    d = np.dtype(grid.dtype)
    if d.kind in ("u", "i"):
        init_hi = jnp.asarray(np.iinfo(d).min, grid.dtype)
        init_lo = jnp.asarray(np.iinfo(d).max, grid.dtype)
    else:
        init_hi = jnp.asarray(-jnp.inf, grid.dtype)
        init_lo = jnp.asarray(jnp.inf, grid.dtype)
    hi = jax.lax.reduce_window(
        grid, init_hi, jax.lax.max,
        window_dimensions=(window,) * 3,
        window_strides=(MACROCELL_SIZE,) * 3,
        padding=pads,
    )
    lo = jax.lax.reduce_window(
        grid, init_lo, jax.lax.min,
        window_dimensions=(window,) * 3,
        window_strides=(MACROCELL_SIZE,) * 3,
        padding=pads,
    )
    s = storage_scale(grid.dtype)
    return lo.astype(jnp.float32) * s, hi.astype(jnp.float32) * s


def _range_max_table(alpha: jnp.ndarray) -> list[jnp.ndarray]:
    """Sparse table for O(1) range-max queries over the alpha table."""
    n = alpha.shape[0]
    levels = [alpha]
    k = 1
    while 2 * k <= n:
        prev = levels[-1]
        m = prev.shape[0] - k
        levels.append(jnp.maximum(prev[:m], prev[k:k + m]))
        k *= 2
    return levels


def compute_majorants(value_lo, value_hi, alpha_table, tfn_value_range):
    """Max TF opacity over each cell's clamped, normalized value range.

    Reference: `majorant_kernel` (`sp_singlemc.cu:56-97`): normalized bounds
    -> widened node-index window [floor(lo*(N-1)+.5)-1, floor(hi*(N-1)+.5)+1]
    -> max of alpha over that inclusive index range.
    """
    n = alpha_table.shape[0]
    vr_lo = tfn_value_range[..., 0]
    vr_hi = tfn_value_range[..., 1]
    rcp = 1.0 / (vr_hi - vr_lo)
    lo = (jnp.clip(value_lo, vr_lo, vr_hi) - vr_lo) * rcp
    hi = (jnp.clip(value_hi, vr_lo, vr_hi) - vr_lo) * rcp
    i_lo = jnp.clip(jnp.floor(lo * (n - 1) + 0.5).astype(jnp.int32) - 1, 0, n - 1)
    i_hi = jnp.clip(jnp.floor(hi * (n - 1) + 0.5).astype(jnp.int32) + 1, 0, n - 1)

    levels = _range_max_table(alpha_table)
    length = i_hi - i_lo + 1  # >= 1
    # level k = floor(log2(length)); lengths are in [1, n]
    k = jnp.floor(jnp.log2(length.astype(jnp.float32))).astype(jnp.int32)
    k = jnp.clip(k, 0, len(levels) - 1)

    # Gather from the right level: stack levels padded to n for uniform gather.
    padded = jnp.stack(
        [jnp.pad(lv, (0, n - lv.shape[0]), constant_values=-jnp.inf)
         for lv in levels]
    )  # (L, n)
    pow2 = jnp.left_shift(jnp.int32(1), k)
    a = padded[k, i_lo]
    b = padded[k, i_hi - pow2 + 1]
    return jnp.maximum(a, b)


def build_macrocells(grid, alpha_table, tfn_value_range) -> MacrocellGrid:
    """Build the full partition for a (Z, Y, X) grid (host-callable, jittable)."""
    lo, hi = compute_value_ranges(grid)
    maj = compute_majorants(lo, hi, alpha_table, tfn_value_range)
    Zd, Yd, Xd = grid.shape
    return MacrocellGrid(
        value_lo=lo, value_hi=hi, majorant=maj, vol_dims=(Xd, Yd, Zd)
    )
