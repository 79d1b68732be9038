"""Surface geometry rendering: triangle meshes and isosurfaces.

The reference supports OBJ-material triangle meshes and volume isosurfaces as
scene geometry (`ovr/scene.h:284-304`), rendered by the OSPRay backend
(`ovr/devices/ospray/device_impl.cpp:165-268`) and composited *behind* the
volume by the ray-marcher's two-trace scheme: trace non-volume geometry
first, then blend the volume over it (`shaders_raymarching.cu:283-311`,
`alpha_blend` `shaders_common.h:329-337`).

Design: no BVH/RT cores — triangle intersection is a dense,
batched Möller-Trumbore evaluated as (rays x triangle-chunk) blocks inside a
`lax.scan` (regular compute that XLA vectorizes well; meshes in scientific
scenes are small — clip boxes, annotation glyphs). Isosurfaces are found by
fixed-step root bracketing along the ray with one secant refinement, with
normals from the volume gradient — the marcher's machinery reused, no
divergence. Instances carry a (3,4) object-to-world affine; rays transform
world->object so t values stay in world units.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ovr_tpu.core.sampling import (
    gradient_of,
    intersect_box,
    normalize_value,
    safe_normalize,
)
from ovr_tpu.core.scene import (
    GeometryInstance,
    Isosurface,
    Light,
    Material,
    Scene,
    TriangleMesh,
)
from ovr_tpu.neural.field import sample_any_volume

BIG = 3.4e38


def xfm_apply(xfm: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a (3,4) affine [R | t] to points (..., 3)."""
    return jnp.einsum("ij,...j->...i", xfm[:, :3], p) + xfm[:, 3]


def xfm_inverse(xfm: jnp.ndarray) -> jnp.ndarray:
    """Invert a (3,4) affine: [R | t] -> [R^-1 | -R^-1 t]."""
    rinv = jnp.linalg.inv(xfm[:, :3])
    return jnp.concatenate([rinv, -(rinv @ xfm[:, 3])[:, None]], axis=1)


def _rays_to_object(xfm: jnp.ndarray, org: jnp.ndarray, direction: jnp.ndarray):
    """World rays -> object space (direction left unnormalized so t values
    keep world units)."""
    inv = xfm_inverse(xfm)
    org_o = xfm_apply(inv, org)
    dir_o = jnp.einsum("ij,...j->...i", inv[:, :3], direction)
    return org_o, dir_o, inv


def intersect_mesh(org: jnp.ndarray, direction: jnp.ndarray,
                   mesh: TriangleMesh, chunk: int = 256):
    """Batched Möller-Trumbore over all triangles, chunked by `chunk`.

    Returns (t (N,), normal (N,3) facing the ray origin, color (N,3)
    barycentric-interpolated vertex colors); t = BIG for misses.
    """
    n = org.shape[0]
    dt = org.dtype
    f = mesh.faces.shape[0]
    pad = (-f) % chunk
    faces = jnp.concatenate(
        [mesh.faces, jnp.zeros((pad, 3), jnp.int32)]) if pad else mesh.faces
    # degenerate padding triangles (v0=v0=v0) have det == 0 -> never hit
    tris = mesh.verts[faces]  # (F', 3, 3)
    cols = mesh.colors[faces]  # (F', 3, 3)
    m_uvs = (mesh.uvs if getattr(mesh, "uvs", None) is not None
             else jnp.zeros((mesh.verts.shape[0], 2), dt))
    uvs = m_uvs[faces]  # (F', 3, 2)
    tris = tris.reshape(-1, chunk, 3, 3)
    cols = cols.reshape(-1, chunk, 3, 3)
    uvs = uvs.reshape(-1, chunk, 3, 2)

    eps = jnp.asarray(1e-9, dt)
    t_eps = jnp.asarray(1e-5, dt)
    # barycentric tolerance: rays on a shared edge must hit at least one of
    # the adjacent triangles despite f32 rounding (seam watertightness)
    b_eps = jnp.asarray(1e-6, dt)

    def body(carry, xs):
        t_best, n_best, c_best, uv_best = carry
        tri, col, uvc = xs  # (C, 3, 3) / (C, 3, 2)
        v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        pvec = jnp.cross(direction[:, None, :], e2[None])  # (N, C, 3)
        det = jnp.sum(e1[None] * pvec, -1)  # (N, C)
        inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / jnp.where(
            jnp.abs(det) > eps, det, 1.0), 0.0)
        tvec = org[:, None, :] - v0[None]  # (N, C, 3)
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, e1[None])
        v = jnp.sum(direction[:, None, :] * qvec, -1) * inv_det
        t = jnp.sum(e2[None] * qvec, -1) * inv_det
        hit = ((jnp.abs(det) > eps) & (u >= -b_eps) & (v >= -b_eps)
               & (u + v <= 1 + b_eps) & (t > t_eps))
        t = jnp.where(hit, t, BIG)
        j = jnp.argmin(t, axis=1)  # (N,)
        ar = jnp.arange(n)
        t_c = t[ar, j]
        u_c, v_c = u[ar, j], v[ar, j]
        n_c = jnp.cross(e1[j], e2[j])
        c_c = (col[j, 0] * (1 - u_c - v_c)[:, None] + col[j, 1] * u_c[:, None]
               + col[j, 2] * v_c[:, None])
        uv_c = (uvc[j, 0] * (1 - u_c - v_c)[:, None]
                + uvc[j, 1] * u_c[:, None] + uvc[j, 2] * v_c[:, None])
        better = t_c < t_best
        t_best = jnp.where(better, t_c, t_best)
        n_best = jnp.where(better[:, None], n_c, n_best)
        c_best = jnp.where(better[:, None], c_c, c_best)
        uv_best = jnp.where(better[:, None], uv_c, uv_best)
        return (t_best, n_best, c_best, uv_best), None

    init = (jnp.full((n,), BIG, dt), jnp.zeros((n, 3), dt),
            jnp.ones((n, 3), dt), jnp.zeros((n, 2), dt))
    (t, nrm, col, uv), _ = jax.lax.scan(body, init, (tris, cols, uvs))
    nrm = safe_normalize(nrm)
    # face the origin side
    nrm = jnp.where(jnp.sum(nrm * direction, -1, keepdims=True) > 0,
                    -nrm, nrm)
    return t, nrm, col, uv


def sample_texture(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear (H, W, 3) texture fetch at uv (N, 2) in [0,1]^2, clamp
    addressing, v up (image row 0 = v 1) — OSPRay texture2d semantics
    (`ovr/devices/ospray/device_impl.cpp:274-295`)."""
    h, w, _ = tex.shape
    fx = jnp.clip(uv[:, 0], 0.0, 1.0) * (w - 1)
    fy = (1.0 - jnp.clip(uv[:, 1], 0.0, 1.0)) * (h - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, h - 2)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return ((t00 * (1 - ax) + t01 * ax) * (1 - ay)
            + (t10 * (1 - ax) + t11 * ax) * ay)


def intersect_isosurface(volume: Any, value_range: jnp.ndarray,
                         world_lo, world_hi, org, direction,
                         iso: Isosurface, steps: int):
    """First iso-crossing along each ray by fixed-step root bracketing + one
    secant refinement. Normals from the (negated) volume gradient.

    `iso.isovalues` are in normalized TF coordinates [0,1] (like the
    reference's isosurface geometry values after range mapping). Returns
    (t (N,), normal (N,3)); t = BIG for misses.
    """
    n = org.shape[0]
    dt = org.dtype
    t0 = jnp.zeros((n,), dt)
    t1 = jnp.full((n,), BIG, dt)
    t0, t1 = intersect_box(org, direction, world_lo, world_hi, t0, t1)
    t0 = jnp.maximum(t0, 0.0)
    t1 = jnp.maximum(t1, t0)
    step = (t1 - t0) / steps

    def field(t):
        p = org + t[:, None] * direction
        p_obj = (p - world_lo) / (world_hi - world_lo)
        s = sample_any_volume(volume, p_obj)
        return normalize_value(s, value_range), p_obj

    def body(carry, i):
        t_hit, s_prev = carry
        t_cur = t0 + (i + 1.0) * step
        s_cur, _ = field(t_cur)
        # crossing of any isovalue between s_prev and s_cur
        lo = jnp.minimum(s_prev, s_cur)[:, None]
        hi = jnp.maximum(s_prev, s_cur)[:, None]
        crossed = (iso.isovalues[None, :] >= lo) & (iso.isovalues[None, :] <= hi)
        any_cross = jnp.any(crossed, axis=1) & (step > 0)
        # nearest crossed isovalue (by |iso - s_prev|)
        d = jnp.where(crossed, jnp.abs(iso.isovalues[None, :] - s_prev[:, None]),
                      BIG)
        k = jnp.argmin(d, axis=1)
        iso_v = iso.isovalues[k]
        denom = s_cur - s_prev
        frac = jnp.where(jnp.abs(denom) > 1e-12,
                         (iso_v - s_prev) / jnp.where(
                             jnp.abs(denom) > 1e-12, denom, 1.0), 0.5)
        t_c = t_cur - step + jnp.clip(frac, 0.0, 1.0) * step
        new = any_cross & (t_hit >= BIG)
        t_hit = jnp.where(new, t_c, t_hit)
        return (t_hit, s_cur), None

    s0, _ = field(t0)
    (t_hit, _), _ = jax.lax.scan(
        body, (jnp.full((n,), BIG, dt), s0), jnp.arange(steps, dtype=dt))

    # normal at the hit from the volume gradient
    p = org + jnp.minimum(t_hit, 1e30)[:, None] * direction
    p_obj = jnp.clip((p - world_lo) / (world_hi - world_lo), 0.0, 1.0)
    s = sample_any_volume(volume, p_obj)
    if hasattr(volume, "grid_cfg"):
        r = float(volume.grid_cfg.max_resolution)
        rdim = jnp.array([1.0 / r] * 3, dt)
    else:
        z, y, x = volume.shape
        rdim = jnp.array([1.0 / x, 1.0 / y, 1.0 / z], dt)
    g = gradient_of(lambda q: sample_any_volume(volume, q), p_obj, s, rdim)
    extent = world_hi - world_lo
    nrm = safe_normalize(-g / extent)
    nrm = jnp.where(jnp.sum(nrm * direction, -1, keepdims=True) > 0,
                    -nrm, nrm)
    return t_hit, nrm


def shade_phong(material: Material, base_color, nrm, light: Light,
                light_dir, view_dir):
    """Blinn-Phong surface shade: kd*base*(ambient + cosNL*light) +
    ks*cosNH^ns (matches the OSPRay `obj` material semantics the reference
    maps to, `device_impl.cpp:301-326`)."""
    cos_nl = jnp.maximum(jnp.sum(nrm * light_dir, -1), 0.0)
    h = safe_normalize(light_dir + view_dir)
    cos_nh = jnp.maximum(jnp.sum(nrm * h, -1), 0.0)
    diffuse = material.kd * base_color * (
        light.ambient + cos_nl[:, None] * light.color)
    specular = material.ks * (cos_nh ** material.ns)[:, None] * light.color
    return diffuse + specular


def render_geometries(scene: Scene, org: jnp.ndarray, direction: jnp.ndarray,
                      iso_steps: int = 128, chunk: int = 256):
    """Render all geometry instances; nearest hit wins.

    Returns (rgb (N,3) premultiplied, alpha (N,), t_hit (N,) = BIG on miss) —
    the background layer the volume is composited over.
    """
    n = org.shape[0]
    dt = org.dtype
    t_best = jnp.full((n,), BIG, dt)
    rgb_best = jnp.zeros((n, 3), dt)
    a_best = jnp.zeros((n,), dt)
    light_dir = safe_normalize(scene.light.direction)
    view_dir = -safe_normalize(direction)

    for inst in scene.geometries:
        org_o, dir_o, inv = _rays_to_object(inst.xfm, org, direction)
        if inst.kind == "isosurface":
            vol = scene.volume.grid if hasattr(scene.volume, "grid") \
                else scene.volume
            t, nrm_o = intersect_isosurface(
                vol, scene.tfn.value_range, scene.volume.world_lo,
                scene.volume.world_hi, org_o, dir_o, inst.geometry, iso_steps)
            base = jnp.ones((n, 3), dt)
        else:
            t, nrm_o, base, uv = intersect_mesh(org_o, dir_o, inst.geometry,
                                                chunk)
            if getattr(inst.material, "map_kd", None) is not None:
                base = base * sample_texture(inst.material.map_kd, uv)
        # normals: object -> world via (R^-1)^T
        nrm = safe_normalize(jnp.einsum("ji,...j->...i", inv[:, :3], nrm_o))
        nrm = jnp.where(jnp.sum(nrm * direction, -1, keepdims=True) > 0,
                        -nrm, nrm)
        rgb = shade_phong(inst.material, base, nrm, scene.light, light_dir,
                          view_dir)
        hit = t < BIG
        a = jnp.where(hit, inst.material.d, 0.0)
        better = hit & (t < t_best)
        t_best = jnp.where(better, t, t_best)
        rgb_best = jnp.where(better[:, None], rgb * a[:, None], rgb_best)
        a_best = jnp.where(better, a, a_best)
    return rgb_best, a_best, t_best
