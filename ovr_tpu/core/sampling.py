"""Differentiable volume & transfer-function sampling (pure jnp).

These are the semantic core of the renderer and the autodiff-differentiable
reference path. They reproduce CUDA texture behavior used by the reference:

- `sample_volume`: tex3D trilinear fetch with normalized clamp-addressed
  coordinates (`ovr/devices/optix7/shaders_common.h:186-193`).
- `sample_tfn_*`: the nodal 1D lookup `array1d_nodal`
  (`shaders_common.h:311-319`): v in [0,1] linearly interpolates an N-entry
  table at position v * (N - 1).
- `classify`: data-range normalization + TF lookup
  (`shaders_common.h:356-367`).
- `volume_gradient`: forward-difference gradient with boundary flipping
  (`shaders_common.h:195-215`).

All functions broadcast over arbitrary leading batch dims of the position /
value arguments and are differentiable w.r.t. both the tables/grids and the
query points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _grid_dims_xyz(grid: jnp.ndarray) -> tuple[int, int, int]:
    z, y, x = grid.shape[-3:]
    return x, y, z


def sample_volume(grid: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Trilinear sample of a (Z, Y, X) grid at normalized coords p (..., 3).

    p is (x, y, z) in [0, 1]^3 (clamped). Texel centers sit at
    (i + 0.5) / dim; out-of-center coordinates clamp (CUDA
    `cudaAddressModeClamp` + `cudaFilterModeLinear`).
    """
    X, Y, Z = _grid_dims_xyz(grid)
    dims = jnp.array([X, Y, Z], dtype=p.dtype)
    p = jnp.clip(p, 0.0, 1.0)
    # voxel-space continuous coordinate of the sample
    c = p * dims - 0.5
    c = jnp.clip(c, 0.0, dims - 1.0)
    i0 = jnp.floor(c)
    f = c - i0
    i0 = i0.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, jnp.array([X - 1, Y - 1, Z - 1], dtype=jnp.int32))

    flat = grid.reshape(-1)  # (Z*Y*X,)

    def lin(ix, iy, iz):
        return (iz * Y + iy) * X + ix

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    # 8-corner gather
    c000 = flat[lin(x0, y0, z0)]
    c100 = flat[lin(x1, y0, z0)]
    c010 = flat[lin(x0, y1, z0)]
    c110 = flat[lin(x1, y1, z0)]
    c001 = flat[lin(x0, y0, z1)]
    c101 = flat[lin(x1, y0, z1)]
    c011 = flat[lin(x0, y1, z1)]
    c111 = flat[lin(x1, y1, z1)]

    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    out = c0 * (1 - fz) + c1 * fz
    return out * storage_scale(grid.dtype)


def storage_scale(dtype) -> float:
    """Normalized-integer storage scale: a u8/u16 grid samples as
    raw * 1/int_max, exactly the reference's normalized-integer texture
    read (`ovr/devices/optix7/array.h:68-106`). Floats scale by 1."""
    import numpy as np
    d = np.dtype(dtype)
    if d.kind in ("u", "i"):
        return 1.0 / float(np.iinfo(d).max)
    return 1.0


def sample_table_1d(table: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Nodal 1D table lookup: linear interpolation at v * (N - 1), v in [0,1].

    `table` is (N,) or (N, C); broadcasting over the shape of v. Matches
    `array1d_nodal` (`shaders_common.h:311-319`): tex1D linear filtering at
    coordinate fma(v, N-1, 0.5)/N, which reduces to interpolation between
    nodes floor(v*(N-1)) and ceil.
    """
    n = table.shape[0]
    v = jnp.clip(v, 0.0, 1.0)
    c = v * (n - 1)
    i0 = jnp.floor(c)
    f = c - i0
    i0 = i0.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    lo = table[i0]
    hi = table[i1]
    if table.ndim == 2:
        f = f[..., None]
    return lo * (1 - f) + hi * f


def normalize_value(sample: jnp.ndarray, value_range: jnp.ndarray) -> jnp.ndarray:
    """Map a raw sample into [0,1] TF coordinates via the value range."""
    lo = value_range[..., 0]
    hi = value_range[..., 1]
    scale = 1.0 / (hi - lo)
    return (jnp.clip(sample, lo, hi) - lo) * scale


def classify(color_table: jnp.ndarray, alpha_table: jnp.ndarray,
             value_range: jnp.ndarray, sample: jnp.ndarray
             ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transfer-function classification of a raw volume sample.

    Returns (rgb (...,3), alpha (...)). Reference: `sample_transfer_function`
    (`shaders_common.h:356-367`).
    """
    v = normalize_value(sample, value_range)
    rgb = sample_table_1d(color_table, v)
    alpha = sample_table_1d(alpha_table, v)
    return rgb, alpha


def opacity_correction(alpha: jnp.ndarray, base: jnp.ndarray,
                       step: jnp.ndarray) -> jnp.ndarray:
    """Opacity correction for march step length: 1 - (1-a)^(base*step).

    Reference: `shaders_raymarching.cu:117-122`. Clamped to [0,1]
    (`corrected_value`, `shaders_common.h:96-104`). The `1 - x` is computed in
    a gradient-safe way: d/da (1-a)^k is finite for a<1 and we clamp a away
    from exactly 1 to avoid a NaN pullback at the early-exit saturation point.
    """
    k = base * step
    a = jnp.clip(alpha, 0.0, 1.0 - 1e-7)
    corrected = jnp.clip(1.0 - jnp.power(1.0 - a, k), 0.0, 1.0)
    # skip when base*step ~= 1 (nearly_equal, shaders_raymarching.cu:75,120)
    return jnp.where(jnp.abs(k - 1.0) < 1e-7, jnp.clip(alpha, 0.0, 1.0),
                     corrected)


def gradient_of(sample_fn, p: jnp.ndarray, center_value: jnp.ndarray,
                rdim: jnp.ndarray, hi=1.0) -> jnp.ndarray:
    """Forward-difference gradient of any scalar field in [0,1]^3.

    Step `rdim` per axis; steps that would cross `hi` (the coordinate of the
    *volume's* upper boundary — 1.0 for a full grid, beyond 1 for an interior
    brick of a larger volume whose halo extends past the local cube) flip
    sign. Reference: `compute_volume_gradient_object_space`
    (`shaders_common.h:195-215`). Returns the *unnormalized* gradient
    (df/dp, per-axis divided by the step actually taken).
    """
    stp = jnp.where(p + rdim > hi, -rdim, rdim)

    def axis_sample(axis):
        offset = jnp.zeros_like(p).at[..., axis].set(stp[..., axis])
        return sample_fn(p + offset)

    gx = (axis_sample(0) - center_value) / stp[..., 0]
    gy = (axis_sample(1) - center_value) / stp[..., 1]
    gz = (axis_sample(2) - center_value) / stp[..., 2]
    return jnp.stack([gx, gy, gz], axis=-1)


def volume_gradient(grid: jnp.ndarray, p: jnp.ndarray,
                    center_value: jnp.ndarray) -> jnp.ndarray:
    """`gradient_of` for a dense grid with a one-voxel step per axis."""
    X, Y, Z = _grid_dims_xyz(grid)
    rdim = jnp.array([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=p.dtype)
    return gradient_of(lambda q: sample_volume(grid, q), p, center_value,
                       rdim)


def safe_normalize(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Normalize with a zero-safe (and grad-safe) guard."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps))


def intersect_box(org: jnp.ndarray, direction: jnp.ndarray,
                  lower: jnp.ndarray, upper: jnp.ndarray,
                  t0: jnp.ndarray, t1: jnp.ndarray
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ray/AABB slab test; returns clipped (t0, t1) (empty when t1 <= t0).

    Reference: `intersect_box` (`shaders_common.h:156-184`), including the
    degenerate-direction guard.
    """
    big = jnp.asarray(1e20, dtype=org.dtype)
    small = jnp.abs(direction) < 1e-12
    rcp = jnp.where(small, 1.0, 1.0 / jnp.where(small, 1.0, direction))
    t_lo = jnp.where(small, jnp.where(org >= lower, -big, big),
                     (lower - org) * rcp)
    t_hi = jnp.where(small, jnp.where(org <= upper, big, -big),
                     (upper - org) * rcp)
    tmin = jnp.minimum(t_lo, t_hi)
    tmax = jnp.maximum(t_lo, t_hi)
    t0 = jnp.maximum(t0, jnp.max(tmin, axis=-1))
    t1 = jnp.minimum(t1, jnp.min(tmax, axis=-1))
    return t0, t1
