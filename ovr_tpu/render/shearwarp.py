"""Shear-warp volume rendering: the dense fast path.

The reference's hot loop marches rays independently, gathering 8 volume
texels per sample through the GPU's texture units
(`ovr/devices/optix7/shaders_raymarching.cu:87-171`). This module
re-factorizes the *same integral* into slice order, reading each voxel
plane once per frame:

1. Choose the volume axis most parallel to the view direction; iterate
   sample planes perpendicular to it, front to back.
2. Composite in an intermediate "ray fan" grid (P, Q) in which every sample
   plane is an *axis-aligned, uniformly scaled* image of the plane's voxel
   slice (the shear-warp factorization, Lacroute & Levoy '94).
   Perspective: (P, Q) = lateral direction components over the axial one
   (central projection); orthographic: (P, Q) = the ray's lateral offsets.
   The XLA slice loop resamples a plane with two small interpolation-matrix
   matmuls; on the GPU the fused kernel (ops.swslice) gathers the
   trilinear taps instead and keeps the compositing carry in registers.
3. Per intermediate pixel, the covered world interval of each plane comes
   from the exact ray/box intersection (dense elementwise), so the result
   is the box-clipped Riemann sum of the same emission-absorption integral
   the reference computes, with samples at plane centers instead of
   per-ray lattice points. Classification, opacity correction
   (`shaders_raymarching.cu:117-122`) and front-to-back over compositing
   (`:160-166`) are unchanged.
4. One final 2D warp (projective in general) maps the intermediate image to
   the screen, decomposed into two 1D passes (Catmull-Smith) whose inverse
   maps are closed-form rationals; each pass is a chunked batched
   interp-matmul.

Diffuse (gradient) shading computes the normal densely: the in-plane
derivative of the resampled plane plus the along-ray difference between
consecutive planes, solved for the axial derivative — the same
finite-difference normal as `compute_volume_gradient_object_space`
(`shaders_common.h:195-215`) up to stencil spacing.

Limits: perspective eyes may lie INSIDE the volume (fly-through) as long
as every ray still advances forward along the principal axis — planes
behind the eye clip to zero covered interval via the per-pixel slab test
(the dense analogue of the reference's interior-origin t0 clamp,
`shaders_common.h:156-184`), and the plane schedule is trimmed past the
eye plane. Only wide-FOV interior views whose border rays approach (or
cross) the perpendicular to the principal axis are ineligible (their
central projection diverges); `resolve_static` reports eligibility and
callers fall back to the march integrator.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ovr_tpu.core.sampling import (
    intersect_box,
    normalize_value,
    opacity_correction,
    safe_normalize,
    storage_scale,
)
from ovr_tpu.core.scene import ORTHOGRAPHIC
from ovr_tpu.platform import slice_kernel
from ovr_tpu.render.camera import camera_basis


# ---------------------------------------------------------------------------
# static (host-side) plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwStatic:
    """Hashable shear-warp plan (embedded in RenderConfig; jit-static)."""

    axis: int  # principal world axis 0/1/2 (x/y/z)
    sign: int  # +1: planes traversed in +axis order; -1: reversed
    n_slices: int  # sample planes across the slab
    inter_h: int  # intermediate (ray-fan) rows (Q)
    inter_w: int  # intermediate cols (P)
    swap: bool = False  # screen v (not u) pairs with P in the final warp
    # warp maps decouple (P depends on one screen axis only, Q on the
    # other): both passes become single shared-weight matmuls (fast path)
    separable: bool = False
    row_chunk: int = 16  # rows per batched-warp weight chunk
    bf16: bool = False  # bfloat16 matmul operands (f32 accumulate)
    # run the slice loop in the fused kernel (ops.swslice); the backward
    # still runs the XLA adjoint
    pallas: bool = False
    # run that kernel in the Pallas interpreter (CPU tests only)
    interpret: bool = False
    # early ray termination in the fused kernel (alpha >= 0.9999 + box
    # exit, `shaders_raymarching.cu:110`); forced off under differentiation
    term: bool = True
    # XLA loop's lateral shading-gradient stencil: central differences
    # over the fan (True; fewer matmuls on big planes) vs forward
    # differences over one voxel (False; the reference's own stencil,
    # shaders_common.h:195-215 — always used with the fused kernel, so
    # that its forward and the XLA adjoint's recompute agree)
    fd_grad: bool = True
    # interior-eye (fly-through) schedule trim: global plane indices
    # [0, slice0_static) lie behind the eye's axial plane and cover no
    # ray interval; the unbricked caller starts the schedule here
    slice0_static: int = 0


def _np_basis(camera, width, height):
    """Host-side numpy copy of `camera_basis`."""
    aspect = width / float(height)
    d = np.asarray(camera.at, np.float64) - np.asarray(camera.from_,
                                                       np.float64)
    d = d / max(np.linalg.norm(d), 1e-30)
    if camera.kind == ORTHOGRAPHIC:
        t = float(np.asarray(camera.height))
    else:
        t = 2.0 * np.tan(np.deg2rad(float(np.asarray(camera.fovy))) * 0.5)
    up = np.asarray(camera.up, np.float64)
    h = np.cross(d, up)
    h = t * aspect * h / max(np.linalg.norm(h), 1e-30)
    v = np.cross(h, d) / aspect
    return d, h, v


def resolve_static(scene, camera, cfg) -> Optional[SwStatic]:
    """Build the static plan, or None when shear-warp is ineligible.

    Host-side numpy on concrete scene/camera values (called from
    `RenderConfig.resolved`, never under jit).
    """
    vol = scene.volume
    if not hasattr(vol, "grid") or vol.grid.ndim != 3:
        return None  # neural fields march
    if vol.grid.shape[0] < 2 or vol.grid.shape[1] < 2 or vol.grid.shape[2] < 2:
        return None
    # geometries are eligible: surfaces intersect the FAN rays in closed
    # form (dense Möller-Trumbore / iso root-bracketing), clamp the
    # per-pixel interval, and composite behind the volume before the warp
    if getattr(scene, "instances", ()):
        return None  # api.resolved builds per-instance plans instead
    lights = getattr(scene, "lights", ())
    n_xdir = sum(1 for lt in lights
                 if lt.kind in ("directional", "sunsky"))
    n_xpt = sum(1 for lt in lights if lt.kind == "point")
    # extra directional lights are extra cos-terms in the dense shade;
    # point lights shade densely from the plane's world coordinates. The
    # fused kernel's scalar slots cover <= 4 extra directional lights and
    # no point lights; richer rigs run the XLA slice loop (still dense).
    kernel_lights_ok = (cfg.shading == "none"
                        or (n_xdir <= 4 and n_xpt == 0))
    if cfg.shading == "shadow" and not cfg.shadow_grid:
        return None  # per-sample shadow *march* stays on the march path
    try:
        d, h, v = _np_basis(camera, cfg.width, cfg.height)
    except Exception:
        return None
    axis = int(np.argmax(np.abs(d)))
    if abs(d[axis]) < 1e-6:
        return None
    sign = 1 if d[axis] >= 0 else -1
    lo = float(np.asarray(vol.world_lo)[axis])
    hi = float(np.asarray(vol.world_hi)[axis])
    # interior (fly-through) eye: the classic shear-warp rejection is NOT
    # needed as long as every ray still advances forward along the
    # principal axis — planes behind the eye then clip to zero covered
    # interval via the per-pixel slab test (the dense analogue of the
    # reference's interior-origin t0 clamp, `shaders_common.h:156-184`,
    # `shaders_raymarching.cu:304-311`). Only wide-FOV interior views
    # whose border rays approach (or cross) the perpendicular fall back
    # to the march path — their central projection diverges.
    inside = False
    if camera.kind != ORTHOGRAPHIC:
        e_a = float(np.asarray(camera.from_)[axis])
        inside = lo - 1e-6 <= e_a <= hi + 1e-6
    perp = [w for w in (0, 1, 2) if w != axis]
    w1 = perp[0]
    w2 = perp[1]
    # pair intermediate P (along w1) with whichever screen axis moves it most
    swap = bool(abs(h[w1]) < abs(v[w1]))
    # the warp pass inverts cp along the paired screen axis: require motion
    mot = abs(v[w1]) if swap else abs(h[w1])
    oth = abs(h[w2]) if swap else abs(v[w2])
    if mot < 1e-9 or oth < 1e-9:
        return None  # degenerate pairing (screen axis parallel to axis)
    # separable: P varies along exactly one screen axis and Q along the
    # other (and, for perspective, the denominator is screen-constant)
    eps = 1e-6 * (np.linalg.norm(h) + np.linalg.norm(v))
    cross = (abs(v[w1]), abs(h[w2])) if not swap else (abs(h[w1]),
                                                       abs(v[w2]))
    axial = (abs(h[axis]), abs(v[axis]))
    separable = bool(max(*cross, *axial) < eps)
    ext = np.asarray(vol.world_hi, np.float64) - np.asarray(
        vol.world_lo, np.float64)
    n_slices = max(4, int(round(float(ext[axis]) * cfg.sampling_rate)))
    align = max(1, int(getattr(cfg, "sw_slice_align", 1)))
    n_slices = -(-n_slices // align) * align
    zyx = vol.grid.shape
    dims_xyz = (zyx[2], zyx[1], zyx[0])
    cap = int(cfg.sw_inter_cap)
    rnd = lambda x: int(-(-x // 8) * 8)
    # fan resolution: 2 samples per voxel laterally (volume Nyquist), but
    # never beyond ~1.25x the paired screen axis — the warp output cannot
    # use more; the fan auto-zooms to the visible ray footprint, so
    # magnified views keep full detail at any cap
    scr_p = cfg.height if swap else cfg.width
    scr_q = cfg.width if swap else cfg.height
    wi = rnd(min(cap, max(64, min(2 * dims_xyz[perp[0]],
                                  int(1.25 * scr_p)))))
    hi_i = rnd(min(cap, max(64, min(2 * dims_xyz[perp[1]],
                                    int(1.25 * scr_q)))))

    eye = np.asarray(camera.from_, np.float64)
    if inside:
        # interior eye: every border ray must still advance along the
        # principal axis (sampled over the screen border, where the axial
        # component of the ray direction is extremal)
        us = np.linspace(-0.5, 0.5, 65)
        uu = np.concatenate([us, us, np.full(65, -0.5), np.full(65, 0.5)])
        vv = np.concatenate([np.full(65, -0.5), np.full(65, 0.5), us, us])
        den = (d[axis] + uu * h[axis] + vv * v[axis]) * sign
        if den.min() < 0.15 * abs(d[axis]):
            return None  # near-perpendicular border rays
    # interior eye: planes between the entry face and the eye's axial
    # plane cover no ray interval — trim them from the schedule, with the
    # start quantized to n_slices/8 steps so a fly-through compiles at
    # most 8 schedule variants instead of one per frame
    slice0_static = 0
    if inside:
        z_eye = (eye[axis] - lo) if sign > 0 else (hi - eye[axis])
        dz_s = float(ext[axis]) / n_slices
        s0 = int(max(0.0, z_eye / dz_s - 1.0))
        qstep = max(1, n_slices // 8)
        slice0_static = max(0, min((s0 // qstep) * qstep, n_slices - 4))
    pallas = (bool(cfg.sw_pallas) and slice_kernel() == "triton"
              and kernel_lights_ok)
    # the XLA loop's FD stencil pays off on big planes; the fused kernel
    # runs the voxel stencil, and so must the adjoint's recompute
    big = wi >= 1024 or dims_xyz[w1] >= 512
    return SwStatic(axis=axis, sign=sign, n_slices=n_slices,
                    inter_h=hi_i, inter_w=wi, swap=swap,
                    separable=separable, bf16=bool(cfg.sw_bf16),
                    pallas=pallas,
                    term=bool(getattr(cfg, "sw_term", True)),
                    fd_grad=bool(big) and not pallas,
                    slice0_static=slice0_static)


# ---------------------------------------------------------------------------
# dense building blocks
# ---------------------------------------------------------------------------

def _interp_matrix(src_pos: jnp.ndarray, n_in: int) -> jnp.ndarray:
    """(O, I) linear-interpolation weights: row o holds the two bilinear
    weights for continuous source index src_pos[o], clamp-addressed."""
    p = jnp.clip(src_pos, 0.0, n_in - 1.0)
    i = jnp.arange(n_in, dtype=src_pos.dtype)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(p[:, None] - i))


def _mm(a: jnp.ndarray, b: jnp.ndarray, bf16: bool) -> jnp.ndarray:
    """2D matmul with optional bfloat16 operands, f32 accumulation."""
    if bf16:
        a = a.astype(jnp.bfloat16)
        b = b.astype(jnp.bfloat16)
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


def warp_rows(img: jnp.ndarray, pos: jnp.ndarray, row_chunk: int = 16,
              bf16: bool = False) -> jnp.ndarray:
    """Resample each row r of img (R, I, C) at continuous column positions
    pos (R, O) -> (R, O, C). Batched interp-matmuls in row chunks so the
    (chunk, O, I) weight tensor stays small; no gathers."""
    r, n_in, ch = img.shape
    out_w = pos.shape[1]
    dt = img.dtype
    pad_r = (-r) % row_chunk
    if pad_r:
        img = jnp.pad(img, ((0, pad_r), (0, 0), (0, 0)))
        pos = jnp.pad(pos, ((0, pad_r), (0, 0)))
    k = img.shape[0] // row_chunk
    img_c = img.reshape(k, row_chunk, n_in, ch)
    pos_c = pos.reshape(k, row_chunk, out_w)
    i = jnp.arange(n_in, dtype=dt)

    def body(carry, xs):
        im, po = xs
        p = jnp.clip(po, 0.0, n_in - 1.0)
        w = jnp.maximum(0.0, 1.0 - jnp.abs(p[..., None] - i))  # (rc, O, I)
        if bf16:
            w = w.astype(jnp.bfloat16)
            im = im.astype(jnp.bfloat16)
        out = jnp.einsum("roi,ric->roc", w, im,
                         preferred_element_type=jnp.float32)
        return carry, out.astype(dt)

    _, outs = jax.lax.scan(body, None, (img_c, pos_c))
    return outs.reshape(k * row_chunk, out_w, ch)[:r]


def warp_separable(img: jnp.ndarray, row_pos: jnp.ndarray,
                   col_pos: jnp.ndarray, bf16: bool = False) -> jnp.ndarray:
    """out[v, u, c] = img[row_pos[v], col_pos[u], c] (bilinear): two single
    shared-weight matmuls — the fast path for separable warps."""
    hi_i, wi_i, ch = img.shape
    h, w = row_pos.shape[0], col_pos.shape[0]
    dt = img.dtype
    wq = _interp_matrix(row_pos.astype(dt), hi_i)  # (H, Hi)
    wp = _interp_matrix(col_pos.astype(dt), wi_i)  # (W, Wi)
    t = _mm(wq, img.reshape(hi_i, wi_i * ch), bf16).reshape(h, wi_i, ch)
    t2 = jnp.transpose(t, (0, 2, 1)).reshape(h * ch, wi_i)
    out = _mm(t2, wp.T, bf16).reshape(h, ch, w)
    return jnp.transpose(out, (0, 2, 1)).astype(dt)


def _perp_axes(axis: int) -> tuple[int, int]:
    p = [w for w in (0, 1, 2) if w != axis]
    return p[0], p[1]


def _volume_view(grid: jnp.ndarray, axis: int, sign: int) -> jnp.ndarray:
    """Permute (Z, Y, X) so dim0 = principal axis in traversal order,
    dim1 = rows = perp[1], dim2 = cols = perp[0]."""
    w1, w2 = _perp_axes(axis)
    g = jnp.transpose(grid, (2 - axis, 2 - w2, 2 - w1))
    if sign < 0:
        g = g[::-1]
    return g


def _safe_div(a, b, eps=1e-9):
    d = jnp.where(jnp.abs(b) < eps, jnp.where(b < 0, -eps, eps), b)
    return a / d


def _common_rgba_table(color_table, alpha_table):
    """Merge the TF's color (Nc, 3) and alpha (Na,) nodal tables onto one
    K = max(Nc, Na) grid as a (K, 4) table (exact for the denser table;
    piecewise-linear re-noding for the other). Lets classification be one
    lookup per sample: a dense interp-matmul in the XLA loop, a two-tap
    gather in the fused kernel."""
    nc = color_table.shape[0]
    na = alpha_table.shape[0]
    k = max(nc, na)
    dt = color_table.dtype
    xs = jnp.linspace(0.0, 1.0, k, dtype=dt)

    def renode(tab):
        n = tab.shape[0]
        if n == k:
            return tab if tab.ndim == 2 else tab[:, None]
        w = _interp_matrix(xs * (n - 1), n)  # (K, n)
        t2 = tab if tab.ndim == 2 else tab[:, None]
        return w @ t2

    return jnp.concatenate([renode(color_table), renode(alpha_table)],
                           axis=1)  # (K, 4)


def _classify_impl(smp, rgba_tab, value_range, bf16: bool):
    k = rgba_tab.shape[0]
    v = normalize_value(smp, value_range)
    c = jnp.clip(v * (k - 1), 0.0, k - 1.0)
    i = jnp.arange(k, dtype=smp.dtype)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(c[..., None] - i))  # (H, W, K)
    if bf16:
        w = w.astype(jnp.bfloat16)
        rgba_tab = rgba_tab.astype(jnp.bfloat16)
    rgba = jnp.einsum("hwk,kc->hwc", w, rgba_tab,
                      preferred_element_type=jnp.float32).astype(smp.dtype)
    return rgba[..., :3], rgba[..., 3]


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _classify_cv(bf16: bool, smp, rgba_tab, value_range):
    return _classify_impl(smp, rgba_tab, value_range, bf16)


def _classify_dense(smp, rgba_tab, value_range, bf16: bool = False):
    """TF classification as one interp-matmul: smp (..., H, W) ->
    (rgb (H, W, 3), alpha (H, W)). Same piecewise-linear nodal lookup as
    `core.sampling.classify` (`shaders_common.h:356-367`), evaluated as a
    matmul (weights row = the two bilinear weights of the sample's node
    coordinate).

    Custom VJP: the (H, W, K) hat-weight tensor (hundreds of MB at the
    1024 scale) is REBUILT in the backward instead of saved as a vjp
    residual — its per-step HBM round-trip was the dominant cost of the
    adjoint sweep at the metric scale."""
    return _classify_cv(bool(bf16), smp, rgba_tab, value_range)


def _classify_dense_fwd(bf16, smp, rgba_tab, value_range):
    return _classify_impl(smp, rgba_tab, value_range, bf16), (
        smp, rgba_tab, value_range)


def _classify_dense_bwd(bf16, res, cot):
    smp, rgba_tab, value_range = res
    k = rgba_tab.shape[0]
    dt = smp.dtype
    cot_rgb, cot_a = cot
    cot_rgba = jnp.concatenate([cot_rgb, cot_a[..., None]], axis=-1)
    # rebuild the normalized node coordinate and both hat tensors
    lo, hi = value_range[0], value_range[1]
    inv_rng = 1.0 / (hi - lo)
    v_raw = (smp - lo) * inv_rng
    v = jnp.clip(v_raw, 0.0, 1.0)
    c_raw = v * (k - 1)
    c = jnp.clip(c_raw, 0.0, k - 1.0)
    i = jnp.arange(k, dtype=dt)
    d = c[..., None] - i
    w = jnp.maximum(0.0, 1.0 - jnp.abs(d))  # (H, W, K)
    # d w / d c inside the unit support (same a.e. subgradient autodiff
    # of max/abs produces away from ties)
    dw = jnp.where((jnp.abs(d) < 1.0) & (d != 0.0), -jnp.sign(d), 0.0)
    d_tab = jnp.einsum("hwk,hwc->kc", w.astype(jnp.float32),
                       cot_rgba.astype(jnp.float32),
                       preferred_element_type=jnp.float32).astype(dt)
    dval_dc = jnp.einsum("hwk,kc->hwc", dw, rgba_tab,
                         preferred_element_type=jnp.float32)
    d_c = jnp.sum(cot_rgba * dval_dc, axis=-1)
    in_c = (c_raw > 0.0) & (c_raw < k - 1.0)
    in_v = (v_raw > 0.0) & (v_raw < 1.0)
    d_v = jnp.where(in_c, d_c, 0.0) * (k - 1)
    d_smp = jnp.where(in_v, d_v, 0.0) * inv_rng
    # value_range cotangent through v = (smp - lo) / (hi - lo)
    d_vmasked = jnp.where(in_v, d_v, 0.0)
    d_lo = jnp.sum(d_vmasked * (-inv_rng + (smp - lo) * inv_rng * inv_rng))
    d_hi = jnp.sum(d_vmasked * (-(smp - lo) * inv_rng * inv_rng))
    d_vr = jnp.stack([d_lo, d_hi]).astype(value_range.dtype)
    return d_smp, d_tab, d_vr


_classify_cv.defvjp(_classify_dense_fwd, _classify_dense_bwd)




def _kernel_scalars(dt, *, lo1, ex1, lo2, ex2, e1, e2, dw1, dw2, half, dz,
                    off, vr, base, lam0, n_a, dlam, exa,
                    ld=(0.0, 0.0, 0.0), k1o=0.0, k2o=0.0, inv_da=0.0,
                    dzdlam=1.0, wtcp=None, smp0=0.0, smpsc=None,
                    glo1=None, gex1=None, glo2=None, gex2=None,
                    extra_lights=None):
    """Assemble the ops.swslice scalar vector. The axial-sample
    (smp0/smpsc) and global-box (glo*/gex*) entries default to the global
    schedule / sample box — they differ only on the bricked path
    (parallel.bricks)."""
    from ovr_tpu.ops import swslice
    vals = dict(
        lo1=lo1, ex1=ex1, lo2=lo2, ex2=ex2, ew1=e1, ew2=e2, dw1=dw1,
        dw2=dw2, half=half, dz=dz, off=off, vlo=vr[0],
        vscale=1.0 / (vr[1] - vr[0]), base=base, lam0=lam0,
        dlam=dlam, exa=exa, ld1=ld[0], ld2=ld[1], lda=ld[2],
        k1o=k1o, k2o=k2o, invda=inv_da, dzdlam=dzdlam,
        smp0=smp0, smpsc=float(n_a) / exa if smpsc is None else smpsc,
        glo1=lo1 if glo1 is None else glo1,
        gex1=ex1 if gex1 is None else gex1,
        glo2=lo2 if glo2 is None else glo2,
        gex2=ex2 if gex2 is None else gex2)
    if wtcp is not None:
        for i in range(3):
            for j in range(3):
                vals[f"w{i}{j}"] = wtcp[i, j]
    if extra_lights is not None:
        eld, eli = extra_lights
        for i in range(eld.shape[0]):
            for c in range(3):
                vals[f"el{i}_{c}"] = eld[i, c]
            vals[f"el{i}_3"] = eli[i]
    return swslice.pack_scalars(dt, **vals)


def _run_fused(sw, ortho, params, n_s, mode, term):
    """Invoke the fused kernel with the plan's skip/termination settings."""
    from ovr_tpu.ops import swslice
    return swslice.slice_composite(
        params["grid"], params["tab"], params["sc"], params["pg"],
        params["qg"], params["lin"], params["lout"], params["speed"], n_s,
        mode=mode, ortho=ortho, sign=sw.sign, lgrid=params.get("lgrid"),
        n_extra=(params["eld"].shape[0] if "eld" in params else 0),
        majorant_v=params.get("maj"), term=(term and sw.term),
        interpret=sw.interpret)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _fused_none(f, n_s, st, params):
    """Unshaded slice loop: forward = the fused kernel (ops.swslice, mode
    0), backward = recompute through the bounded-memory over_scan adjoint
    on the same step function. `st` = (SwStatic, ortho). Returns
    (8, Hi, Wi)."""
    return _run_fused(*st, params, n_s, 0, True)


def _fused_none_fwd(f, n_s, st, params):
    # under differentiation the forward runs WITHOUT early termination:
    # the adjoint reconstructs T_k backwards from t_final by dividing out
    # (1 - a_k) for every recomputed step, so a truncated forward would
    # corrupt every reconstructed T (macrocell slice-skipping is exact —
    # skipped slices classify to zero alpha — and stays on)
    return _run_fused(*st, params, n_s, 0, False), params


def _fused_none_bwd(f, n_s, st, params, cot):
    from ovr_tpu.ops.adjoint import over_scan
    v_bar = jnp.concatenate(
        [jnp.moveaxis(cot[0:3], 0, -1), cot[6][..., None]], axis=-1)
    t_bar = -cot[7]  # alpha = 1 - T
    _, vjp = jax.vjp(lambda p: over_scan(f, n_s, p), params)
    (p_bar,) = vjp((v_bar, t_bar))
    return (p_bar,)


_fused_none.defvjp(_fused_none_fwd, _fused_none_bwd)


def _extra_lights_fan(scene, w1, w2, axis, dt):
    """Extra scene lights as fan-axis-ordered dense arrays: directional
    (incl. sunSky) -> (eld (K, 3) components in (w1, w2, axis) order,
    eli (K,) folded 2*intensity*mean(color)); point -> (pld (K, 3)
    positions in fan axes, pli (K,)). Mirrors api._extra_lights /
    `integrator._march_step`'s extra-light shading exactly."""
    from ovr_tpu.core.sampling import safe_normalize as _norm
    dirs, dir_i, pts, pt_i = [], [], [], []
    for lt in getattr(scene, "lights", ()):
        mean_c = jnp.mean(lt.color)
        if lt.kind in ("directional", "sunsky"):
            d = _norm(lt.direction)
            dirs.append(jnp.stack([d[w1], d[w2], d[axis]]))
            dir_i.append(2.0 * lt.intensity * mean_c)
        elif lt.kind == "point":
            p = lt.position
            pts.append(jnp.stack([p[w1], p[w2], p[axis]]))
            pt_i.append(2.0 * lt.intensity * mean_c)
    eld = jnp.stack(dirs).astype(dt) if dirs else None
    eli = jnp.stack(dir_i).astype(dt) if dirs else None
    pld = jnp.stack(pts).astype(dt) if pts else None
    pli = jnp.stack(pt_i).astype(dt) if pts else None
    return eld, eli, pld, pli


def _plane_fields(st, P, lam_j, k0_j, fz_j, want_grad=True):
    """Resample one slice plane of the shaded loop: returns
    (smp (Hi,Wi), g1, g2, x1 (Wi,), x2 (Hi,)); g1/g2 are the lateral
    derivatives of the resampled plane: central finite differences over
    the fan (sw.fd_grad; one halo row beyond each edge, one-sided at the
    fan's lateral borders) or forward differences over one voxel (the
    fused kernel's stencil)."""
    sw, ortho, mode = st
    grid = P["grid"]
    n_a, n_r, n_c = grid.shape
    dt = P["pg"].dtype
    sl = jax.lax.dynamic_slice(grid, (k0_j, 0, 0), (2, n_r, n_c))
    # normalized-integer storage scale (`array.h:68-106`)
    plane = (sl[0] * (1.0 - fz_j) + sl[1] * fz_j) * storage_scale(grid.dtype)
    fd = want_grad and getattr(sw, "fd_grad", True)
    qg = P["qg"]
    if fd:
        dq = qg[1] - qg[0]
        qg = jnp.concatenate([qg[0:1] - dq, qg, qg[-1:] + dq])
    if ortho:
        x1 = P["pg"] + P["dw1"] * lam_j
        x2e = qg + P["dw2"] * lam_j
    else:
        x1 = P["ew1"] + P["pg"] * lam_j
        x2e = P["ew2"] + qg * lam_j
    vc_raw = (x1 - P["lo1"]) / P["ex1"] * n_c - 0.5
    vr_raw = (x2e - P["lo2"]) / P["ex2"] * n_r - 0.5
    vc = jnp.clip(vc_raw, 0.0, n_c - 1.0)
    vr = jnp.clip(vr_raw, 0.0, n_r - 1.0)
    wc = _interp_matrix(vc, n_c)
    wr = _interp_matrix(vr, n_r)
    t1 = _mm(wr, plane, sw.bf16)
    smp_e = _mm(t1, wc.T, sw.bf16).astype(dt)  # (Hi[+2], Wi)
    if not want_grad:
        return smp_e, None, None, x1, x2e
    if not fd:
        # forward difference of the resampled field over one voxel per
        # lateral axis, backward at the upper face — the reference's
        # stencil (`shaders_common.h:195-215`, core.sampling.gradient_of)
        # and exactly the fused kernel's
        s1 = jnp.where(vc_raw > n_c - 1.5, -1.0, 1.0).astype(dt)
        s2 = jnp.where(vr_raw > n_r - 1.5, -1.0, 1.0).astype(dt)
        smp_c = _mm(t1, _interp_matrix(vc_raw + s1, n_c).T, sw.bf16)
        smp_r = _mm(_mm(_interp_matrix(vr_raw + s2, n_r), plane, sw.bf16),
                    wc.T, sw.bf16)
        g1 = (smp_c - smp_e) * s1[None, :] * (n_c / P["ex1"])
        g2 = (smp_r - smp_e) * s2[:, None] * (n_r / P["ex2"])
        return smp_e, g1.astype(dt), g2.astype(dt), x1, x2e
    smp = smp_e[1:-1]
    x2 = x2e[1:-1]
    lamf = 1.0 if ortho else lam_j
    dp = P["pg"][1] - P["pg"][0]
    fwd = jnp.roll(smp, -1, axis=1) - smp
    bwd = smp - jnp.roll(smp, 1, axis=1)
    cen = 0.5 * (fwd + bwd)
    wi = smp.shape[1]
    col = jnp.arange(wi)[None, :]
    g1 = jnp.where(col == 0, fwd,
                   jnp.where(col == wi - 1, bwd, cen)) / (dp * lamf)
    g2 = (smp_e[2:] - smp_e[:-2]) * (0.5 / ((qg[1] - qg[0]) * lamf))
    return smp, g1, g2, x1, x2


def _shade_fields(st, P, lam_j, j_pos, smp, g1, g2, prev_s, k0l_j, fzl_j,
                  x1, x2, zabs_j=None):
    """Classification, opacity correction and diffuse/shadow shading for
    one resampled plane: returns (rgb, ncam, a). `prev_s` is the previous
    plane's sample field (the axial FD term); ignored when j_pos == 0.
    `zabs_j` is the plane's axial world coordinate (point-light falloff)."""
    sw, ortho, mode = st
    dt = P["pg"].dtype
    seg_lo = jnp.maximum(lam_j - P["half"], P["lin"])
    seg_hi = jnp.minimum(lam_j + P["half"], P["lout"])
    dt_w = jnp.maximum(seg_hi - seg_lo, 0.0) * P["speed"]
    rgb, a = _classify_dense(smp, P["tab"], P["vr"], sw.bf16)
    a = jnp.where(dt_w > 0, opacity_correction(a, P["base"], dt_w), 0.0)
    a = jnp.minimum(a, 1.0 - 1e-6)

    ds = jnp.where(j_pos > 0, (smp - prev_s) / P["dzdlam"], 0.0)
    ga = (ds - g1 * P["k1"] - g2 * P["k2"]) * P["inv_da"]
    n1, n2, na = -g1, -g2, -ga
    inv = jax.lax.rsqrt(n1 * n1 + n2 * n2 + na * na + 1e-12)
    cos_nl = jnp.abs(P["ld1"] * n1 + P["ld2"] * n2 + P["lda"] * na) * inv
    if mode == 2:
        lgrid = P["lgrid"]
        l_a, l_r, l_c = lgrid.shape
        sll = jax.lax.dynamic_slice(lgrid, (k0l_j, 0, 0), (2, l_r, l_c))
        lplane = sll[0] * (1.0 - fzl_j) + sll[1] * fzl_j
        # the lattice spans the GLOBAL box (bricks sample a local box)
        lvc = jnp.clip((x1 - P["glo1"]) / P["gex1"] * l_c - 0.5, 0.0,
                       l_c - 1.0)
        lvr = jnp.clip((x2 - P["glo2"]) / P["gex2"] * l_r - 0.5, 0.0,
                       l_r - 1.0)
        sh = _mm(_mm(_interp_matrix(lvr, l_r), lplane, sw.bf16),
                 _interp_matrix(lvc, l_c).T, sw.bf16)
        shadow = jnp.clip(sh, 0.0, 1.0).astype(dt)
    else:
        shadow = 0.0
    # total = primary (intensity 2, x0.5 folded) + extra lights, matching
    # `integrator._march_step`'s shade = 0.5 + 0.5*total*(1-shadow)
    total = cos_nl
    if "eld" in P:
        for i in range(P["eld"].shape[0]):
            ce = jnp.abs(P["eld"][i, 0] * n1 + P["eld"][i, 1] * n2
                         + P["eld"][i, 2] * na) * inv
            total = total + 0.5 * ce * P["eli"][i]
    if "pld" in P:
        for i in range(P["pld"].shape[0]):
            d1p = P["pld"][i, 0] - x1[None, :]
            d2p = P["pld"][i, 1] - x2[:, None]
            dap = P["pld"][i, 2] - zabs_j
            r2 = d1p * d1p + d2p * d2p + dap * dap
            cos_p = (jnp.abs(d1p * n1 + d2p * n2 + dap * na) * inv
                     * jax.lax.rsqrt(jnp.maximum(r2, 1e-12)))
            total = total + 0.5 * (cos_p / jnp.maximum(r2, 1e-6)
                                   ) * P["pli"][i]
    shade = 0.5 + total * (1.0 - shadow)
    rgb = jnp.clip(rgb * shade[..., None], 0.0, 1.0)
    nu = jnp.stack([n1 * inv, n2 * inv, na * inv], -1)  # (Hi, Wi, 3)
    ncam = jnp.clip(jnp.einsum("ij,hwj->hwi", P["wtcp"], nu), 0.0, 1.0)
    return rgb, ncam, a


def _slices_xla_shaded(st, P):
    """Shaded (diffuse/shadow) slice loop in XLA — the semantic reference
    for the fused kernel's shaded modes. Returns premultiplied
    (color (Hi,Wi,3), grad_cam (Hi,Wi,3), depth, alpha). The previous
    plane's sample rides the scan carry (cheap forward); the adjoint
    recomputes it per step instead (`_shaded_step`)."""
    sw, ortho, mode = st
    dt = P["pg"].dtype
    hi_i = P["qg"].shape[0]
    wi_i = P["pg"].shape[0]

    def body(carry, xs):
        color, gradc, depth, trans, prev_s = carry
        j, lam_j, k0_j, fz_j, k0l_j, fzl_j, zabs_j = xs
        smp, g1, g2, x1, x2 = _plane_fields(st, P, lam_j, k0_j, fz_j)
        rgb, ncam, a = _shade_fields(st, P, lam_j, j, smp, g1, g2, prev_s,
                                     k0l_j, fzl_j, x1, x2, zabs_j)
        aw = (trans * a)[..., None]
        color = color + aw * rgb
        gradc = gradc + aw * ncam
        depth = depth + aw[..., 0] * (lam_j * P["speed"])
        trans = trans * (1.0 - a)
        return (color, gradc, depth, trans, smp), None

    z3 = jnp.zeros((hi_i, wi_i, 3), dt)
    z1 = jnp.zeros((hi_i, wi_i), dt)
    xs = (jnp.arange(P["lam"].shape[0], dtype=jnp.int32), P["lam"],
          P["k0f"].astype(jnp.int32), P["fz"],
          P["k0lf"].astype(jnp.int32), P["fzl"], P["zabs"])
    (color, gradc, depth, trans, _), _ = jax.lax.scan(
        body, (z3, z3, z1, jnp.ones((hi_i, wi_i), dt), z1), xs)
    return color, gradc, depth, 1.0 - trans


def _shaded_step(st, P, k):
    """Slice k of the shaded loop as a pure per-step (v, a) — the form
    `adjoint_sweep` needs. The previous plane's sample (the axial FD term)
    is recomputed from params instead of carried, keeping the backward's
    residual memory O(1) in the slice count. v = (rgb*3, ncam*3, depth)."""
    lam_j = P["lam"][k]
    k0_j = P["k0f"][k].astype(jnp.int32)
    fz_j = P["fz"][k]
    k0l_j = P["k0lf"][k].astype(jnp.int32)
    fzl_j = P["fzl"][k]
    smp, g1, g2, x1, x2 = _plane_fields(st, P, lam_j, k0_j, fz_j)
    km = jnp.maximum(k - 1, 0)
    prev_s, _, _, _, _ = _plane_fields(
        st, P, P["lam"][km], P["k0f"][km].astype(jnp.int32), P["fz"][km],
        want_grad=False)
    rgb, ncam, a = _shade_fields(st, P, lam_j, k, smp, g1, g2, prev_s,
                                 k0l_j, fzl_j, x1, x2, P["zabs"][k])
    v = jnp.concatenate([rgb, ncam, (lam_j * P["speed"])[..., None]], -1)
    return v, a


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _shaded_loop(st, P):
    """Shaded slice loop with a bounded-memory backward. Forward = the
    fused kernel (modes 1/2) when sw.pallas, else the XLA scan;
    backward = the analytic over-compositing adjoint with per-step
    recomputation (ops.adjoint.adjoint_sweep) — O(1)-in-slices residuals,
    making the reference's shaded render + "grad" channel differentiable
    at full resolution (`shaders_raymarching.cu:125-166`)."""
    sw, ortho, mode, n_s, hi_i, wi_i = st
    n_extra = P["eld"].shape[0] if "eld" in P else 0
    if sw.pallas and "pld" not in P and n_extra <= 4:
        out = _run_fused(sw, ortho, P, n_s, mode, True)
        return (jnp.moveaxis(out[0:3], 0, -1),
                jnp.moveaxis(out[3:6], 0, -1), out[6], out[7])
    return _slices_xla_shaded((sw, ortho, mode), P)


def _shaded_fwd_impl(st, P):
    """Shaded forward under differentiation: early termination off (the
    adjoint's reverse T reconstruction needs the untruncated t_final)."""
    sw, ortho, mode, n_s, hi_i, wi_i = st
    n_extra = P["eld"].shape[0] if "eld" in P else 0
    if sw.pallas and "pld" not in P and n_extra <= 4:
        out = _run_fused(sw, ortho, P, n_s, mode, False)
        return (jnp.moveaxis(out[0:3], 0, -1),
                jnp.moveaxis(out[3:6], 0, -1), out[6], out[7])
    return _slices_xla_shaded((sw, ortho, mode), P)


def _shaded_loop_fwd(st, P):
    out = _shaded_fwd_impl(st, P)
    return out, (P, 1.0 - out[3])  # params + final transmittance


def _shaded_loop_bwd(st, res, cot):
    from ovr_tpu.ops.adjoint import adjoint_sweep
    sw, ortho, mode, n_s, hi_i, wi_i = st
    P, t_final = res
    c_bar, g_bar, d_bar, a_bar = cot
    v_bar = jnp.concatenate([c_bar, g_bar, d_bar[..., None]], -1)
    p_bar = adjoint_sweep(partial(_shaded_step, (sw, ortho, mode)), n_s,
                          P, t_final, v_bar, -a_bar)
    return (p_bar,)


_shaded_loop.defvjp(_shaded_loop_fwd, _shaded_loop_bwd)


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def render_shearwarp(scene, cfg, camera, jitter=None, light_grid=None,
                     row0=None, n_rows=None, sample_box=None, clip_box=None,
                     slice0=None, n_slices_loc=None, fan_only=False,
                     pt_fields=None, macrocells=None):
    """Render one frame. Returns premultiplied (color (N,3), grad (N,3),
    depth (N,), alpha (N,)) flat screen buffers, matching the march
    integrators' contract (finalize with `integrator.finalize`).

    `jitter`: optional scalar in [0,1) shifting every sample plane by that
    fraction of the plane spacing (the dense analogue of per-ray t-jitter,
    `OVR_OPTIX7_JITTER_RAYS`); default 0.5 = plane centers.
    `light_grid`: shadow-alpha lattice over object space
    (api.build_light_grid) — required for cfg.shading == 'shadow'.
    `row0`/`n_rows`: render only screen rows [row0, row0 + n_rows) of the
    cfg.height frame — the multi-device tile split (parallel.tiles). The
    intermediate ray fan shrinks to the band's footprint, so per-shard
    compute scales with the band (pair with a reduced sw.inter_h).

    Bricked-volume hooks (parallel.bricks — the multi-device Z-slab
    decomposition; plane *schedule* always comes from scene.volume's world
    box, which the bricked caller sets to the GLOBAL box):
    `sample_box` (lo, hi): world box of scene.volume.grid's texels (the
    brick's halo'd sampling box); defaults to the volume box.
    `clip_box` (lo, hi): ray-interval clamp box (the brick's ownership
    partition); defaults to the volume box.
    `slice0`/`n_slices_loc`: run only plane indices
    [slice0, slice0 + n_slices_loc) of the global schedule (slice0 may be
    traced; n_slices_loc is static).
    `fan_only`: return (color, grad, depth, alpha, ascending, warp) in the
    intermediate fan instead of warping — `ascending` (Hi, Wi) is each
    fan ray's world +z orientation (the brick-composite order) and
    `warp(c, g, d, a)` performs the deferred screen warp.

    `pt_fields`: (sigma (D,H,W), J (D,H,W,3)) — the dense path tracer's
    camera gather (render.ptdense): composite the emission-absorption
    integral with per-plane opacity 1 - exp(-sigma dt) and emission J
    instead of TF classification. Forces the unshaded XLA slice loop.
    """
    sw: SwStatic = cfg.sw
    assert sw is not None, "cfg.sw unresolved; call cfg.resolved(scene)"
    dt = cfg.dtype
    vol = scene.volume
    axis, sign = sw.axis, sw.sign
    w1, w2 = _perp_axes(axis)
    ortho = camera.kind == ORTHOGRAPHIC

    # macrocell majorants (traversal order) drive per-(tile, slice)
    # empty-slice skipping inside the fused kernel; only valid for the
    # unbricked TF-classified path (bricks sample a local box; pt_fields
    # composite sigma, not TF alpha)
    maj_v = None
    if (macrocells is not None and sw.pallas and pt_fields is None
            and sample_box is None and clip_box is None and slice0 is None
            and getattr(cfg, "sw_skip", True)
            and hasattr(vol, "grid")
            and tuple(macrocells.vol_dims)
            == (vol.grid.shape[2], vol.grid.shape[1], vol.grid.shape[0])):
        maj_v = _volume_view(macrocells.majorant.astype(jnp.float32),
                             axis, sign)

    if pt_fields is not None:
        sig_lat, j_lat = pt_fields
        grid = _volume_view(sig_lat, axis, sign)  # (A, Nr, Nc)
        j_view = jnp.stack(
            [_volume_view(j_lat[..., c], axis, sign) for c in range(3)],
            axis=-1)  # (A, Nr, Nc, 3)
    else:
        grid = _volume_view(vol.grid, axis, sign)  # (A, Nr, Nc)
    n_a, n_r, n_c = grid.shape
    lo = vol.world_lo
    hi = vol.world_hi
    ext = hi - lo
    smp_lo, smp_hi = (lo, hi) if sample_box is None else sample_box
    clp_lo, clp_hi = (lo, hi) if clip_box is None else clip_box
    if slice0 is None:
        # interior-eye trim: start at the plan's first plane that can
        # cover any ray interval (bricked callers pass their own range)
        s0s = int(getattr(sw, "slice0_static", 0))
        slice0 = jnp.asarray(float(s0s), dt)
        if n_slices_loc is None and s0s:
            n_slices_loc = sw.n_slices - s0s
    n_loc = sw.n_slices if n_slices_loc is None else n_slices_loc
    e, direction, horizontal, vertical = camera_basis(
        camera, cfg.width, cfg.height)

    # ---- screen ray-fan coordinates --------------------------------------
    u = (jnp.arange(cfg.width, dtype=dt) + 0.5) / cfg.width - 0.5
    nr_loc = cfg.height if n_rows is None else n_rows
    base_row = jnp.asarray(0.0 if row0 is None else row0, dt)
    v = (jnp.arange(nr_loc, dtype=dt) + 0.5 + base_row) / cfg.height - 0.5
    uu, vv = jnp.meshgrid(u, v, indexing="xy")  # (H_band, W)

    if ortho:
        # lateral world offsets of each ray's origin (affine in u, v)
        p_scr = e[w1] + uu * horizontal[w1] + vv * vertical[w1]
        q_scr = e[w2] + uu * horizontal[w2] + vv * vertical[w2]
    else:
        dw = (direction[None, None, :] + uu[..., None] * horizontal
              + vv[..., None] * vertical)  # (H, W, 3) unnormalized
        da = dw[..., axis] * sign
        p_scr = _safe_div(dw[..., w1], da)
        q_scr = _safe_div(dw[..., w2], da)

    def _rng(x):
        m = 0.01 * (jnp.max(x) - jnp.min(x)) + 1e-6
        return jnp.min(x) - m, jnp.max(x) + m

    p_lo, p_hi = _rng(p_scr)
    q_lo, q_hi = _rng(q_scr)
    hi_i, wi_i = sw.inter_h, sw.inter_w
    dp = (p_hi - p_lo) / wi_i
    dq = (q_hi - q_lo) / hi_i
    pg = p_lo + (jnp.arange(wi_i, dtype=dt) + 0.5) * dp
    qg = q_lo + (jnp.arange(hi_i, dtype=dt) + 0.5) * dq
    pp = jnp.broadcast_to(pg[None, :], (hi_i, wi_i))
    qq = jnp.broadcast_to(qg[:, None], (hi_i, wi_i))

    # ---- per-pixel box interval (dense slab test) ------------------------
    if ortho:
        dvec = jnp.stack(
            [direction[0], direction[1], direction[2]]
        ) * jnp.ones((hi_i, wi_i, 1), dt)
        ovec = jnp.zeros((hi_i, wi_i, 3), dt)
        ovec = ovec.at[..., w1].set(pp)
        ovec = ovec.at[..., w2].set(qq)
        ovec = ovec.at[..., axis].set(e[axis])
        speed = jnp.ones((hi_i, wi_i), dt)  # ray parameter is arc length
        dlam = 1.0 / jnp.maximum(jnp.abs(direction[axis]), 1e-12)
        k1_map = jnp.full((hi_i, wi_i), direction[w1], dt)
        k2_map = jnp.full((hi_i, wi_i), direction[w2], dt)
        inv_da = 1.0 / jnp.where(jnp.abs(direction[axis]) < 1e-12, 1e-12,
                                 direction[axis])
    else:
        dvec = jnp.zeros((hi_i, wi_i, 3), dt)
        dvec = dvec.at[..., w1].set(pp)
        dvec = dvec.at[..., w2].set(qq)
        dvec = dvec.at[..., axis].set(jnp.asarray(float(sign), dt))
        ovec = jnp.broadcast_to(e, (hi_i, wi_i, 3))
        speed = jnp.sqrt(pp * pp + qq * qq + 1.0)  # |d| per unit lambda
        dlam = 1.0
        k1_map = pp
        k2_map = qq
        inv_da = jnp.asarray(float(sign), dt)

    zero = jnp.zeros((hi_i, wi_i), dt)
    big = jnp.full((hi_i, wi_i), 3.4e38, dt)
    l_in, l_out = intersect_box(ovec, dvec, clp_lo, clp_hi, zero, big)
    l_out = jnp.maximum(l_out, l_in)

    # non-volume geometry on the fan rays: closed-form surface hits clamp
    # the volume interval; the shaded surface composites behind the slice
    # loop's output before the warp (march equivalent: api.render's
    # t_cap + background blend, `shaders_raymarching.cu:283-311`)
    geometry = (getattr(scene, "geometries", ()) and pt_fields is None)
    if geometry:
        from ovr_tpu.render import geometry as geo
        bg_rgb, bg_a, t_bg = geo.render_geometries(
            scene, ovec.reshape(-1, 3), dvec.reshape(-1, 3),
            iso_steps=cfg.iso_steps, chunk=cfg.geometry_chunk)
        bg_rgb = bg_rgb.reshape(hi_i, wi_i, 3)
        bg_a = bg_a.reshape(hi_i, wi_i)
        t_bg = t_bg.reshape(hi_i, wi_i)
        l_out = jnp.minimum(l_out, jnp.where(bg_a > 0, t_bg, big))
        l_out = jnp.maximum(l_out, l_in)

    # ---- sample-plane schedule (always the GLOBAL box's lattice) ---------
    n_s = sw.n_slices
    dz = ext[axis] / n_s  # world spacing between planes
    off = jnp.asarray(0.5 if jitter is None else jitter, dt)
    jj = slice0 + jnp.arange(n_loc, dtype=dt)
    z_rel = (jj + off) * dz  # depth into the slab along traversal
    z_abs = jnp.where(sign > 0, lo[axis] + z_rel, hi[axis] - z_rel)
    if ortho:
        lam = (z_abs - e[axis]) / direction[axis]
    else:
        lam = (z_abs - e[axis]) * sign
    # axial texel mapping through the sample box, traversal coordinates
    smp0 = ((smp_lo[axis] - lo[axis]) if sign > 0
            else (hi[axis] - smp_hi[axis]))
    smp_ext = smp_hi[axis] - smp_lo[axis]
    c = jnp.clip((z_rel - smp0) / smp_ext * n_a - 0.5, 0.0, n_a - 1.0)
    k0 = jnp.clip(jnp.floor(c).astype(jnp.int32), 0, n_a - 2)
    fz = (c - k0.astype(dt)).astype(dt)

    lo1, lo2 = smp_lo[w1], smp_lo[w2]
    ex1 = smp_hi[w1] - smp_lo[w1]
    ex2 = smp_hi[w2] - smp_lo[w2]

    rgba_tab = _common_rgba_table(scene.tfn.color, scene.tfn.alpha)
    value_range = scene.tfn.value_range
    base = cfg.base_rate * jnp.ones((), dt)
    diffuse = cfg.shading != "none" and pt_fields is None
    half = 0.5 * dz * dlam  # half plane interval in ray-parameter units

    def _finish(color, grad, depth, alpha):
        if geometry:  # surface behind the volume (premultiplied over)
            tr = 1.0 - alpha
            color = color + (tr * bg_a)[..., None] * bg_rgb
            depth = depth + tr * bg_a * jnp.minimum(t_bg, 1e30) * speed
            alpha = alpha + tr * bg_a

        def warp(c_, g_, d_, a_):
            return _sw_warp_out(c_, g_, d_, a_, cfg, camera, sw,
                                p_scr, q_scr, p_lo, q_lo, dp, dq, pg, u, v,
                                e, direction, horizontal, vertical, axis,
                                w1, w2, sign, ortho, dt)

        if fan_only:
            asc = dvec[..., 2] >= 0  # brick traversal order per fan ray
            return color, grad, depth, alpha, asc, warp
        return warp(color, grad, depth, alpha)

    _box_scalars = dict(
        smp0=smp0, smpsc=n_a / smp_ext,
        glo1=lo[w1], gex1=ext[w1], glo2=lo[w2], gex2=ext[w2])

    if not diffuse:
        # Unshaded path: run the slice loop through the bounded-memory
        # over-compositing adjoint (ops.adjoint.over_scan), making
        # api.render with method='shearwarp' differentiable end to end —
        # the fast training path (dense backward, O(1)-in-slices
        # residual memory). Every traced value f needs is threaded through
        # `params` so cotangents flow to the scene and camera.
        from ovr_tpu.ops.adjoint import over_scan

        params = dict(
            grid=grid, tab=rgba_tab, vr=value_range, base=base,
            pg=pg, qg=qg, lin=l_in, lout=l_out, speed=speed,
            lam=lam, fz=fz, k0f=k0.astype(dt), half=half,
            ew1=e[w1], ew2=e[w2], dw1=direction[w1], dw2=direction[w2],
            lo1=lo1, lo2=lo2, ex1=ex1, ex2=ex2,
        )
        if pt_fields is not None:
            params["jlat"] = j_view

        def f(p, j):
            lam_j = p["lam"][j]
            fz_j = p["fz"][j]
            k0_j = p["k0f"][j].astype(jnp.int32)
            sl = jax.lax.dynamic_slice(p["grid"], (k0_j, 0, 0), (2, n_r, n_c))
            plane = ((sl[0] * (1.0 - fz_j) + sl[1] * fz_j)
                     * storage_scale(p["grid"].dtype))
            if ortho:
                x1 = p["pg"] + p["dw1"] * lam_j
                x2 = p["qg"] + p["dw2"] * lam_j
            else:
                x1 = p["ew1"] + p["pg"] * lam_j
                x2 = p["ew2"] + p["qg"] * lam_j
            vc = (x1 - p["lo1"]) / p["ex1"] * n_c - 0.5
            vr = (x2 - p["lo2"]) / p["ex2"] * n_r - 0.5
            wc = _interp_matrix(vc, n_c)
            wr = _interp_matrix(vr, n_r)
            smp = _mm(_mm(wr, plane, sw.bf16), wc.T, sw.bf16).astype(dt)
            seg_lo = jnp.maximum(lam_j - p["half"], p["lin"])
            seg_hi = jnp.minimum(lam_j + p["half"], p["lout"])
            dt_w = jnp.maximum(seg_hi - seg_lo, 0.0) * p["speed"]
            if pt_fields is not None:
                # dense path-tracer gather: opacity from the collision
                # rate, emission from the scatter solution J (radiance —
                # unclipped), render.ptdense
                jsl = jax.lax.dynamic_slice(
                    p["jlat"], (k0_j, 0, 0, 0), (2, n_r, n_c, 3))
                jplane = jsl[0] * (1.0 - fz_j) + jsl[1] * fz_j
                rgb = jnp.stack(
                    [_mm(_mm(wr, jplane[..., c], sw.bf16), wc.T, sw.bf16)
                     for c in range(3)], -1).astype(dt)
                a = 1.0 - jnp.exp(-jnp.maximum(smp, 0.0) * dt_w)
            else:
                rgb, a = _classify_dense(smp, p["tab"], p["vr"], sw.bf16)
                a = jnp.where(dt_w > 0,
                              opacity_correction(a, p["base"], dt_w), 0.0)
                rgb = jnp.clip(rgb, 0.0, 1.0)
            t_j = (lam_j * p["speed"])[..., None]
            v = jnp.concatenate([rgb, t_j], axis=-1)
            return v, a

        if sw.pallas and pt_fields is None:
            zdt = jnp.zeros((), dt)
            if maj_v is not None:
                params["maj"] = maj_v
            params["sc"] = _kernel_scalars(
                dt, lo1=lo1, ex1=ex1, lo2=lo2, ex2=ex2, e1=e[w1], e2=e[w2],
                dw1=direction[w1] if ortho else zdt,
                dw2=direction[w2] if ortho else zdt,
                half=half, dz=dz, off=off + slice0, vr=value_range,
                base=base, lam0=lam[0] - (off + slice0) * dz * dlam,
                n_a=n_a, dlam=dlam, exa=ext[axis], **_box_scalars)
            out8 = _fused_none(f, n_loc, (sw, ortho), params)
            color = jnp.moveaxis(out8[0:3], 0, -1)
            depth = out8[6]
            alpha = out8[7]
        else:
            big_v, trans = over_scan(f, n_loc, params)
            color = big_v[..., :3]
            depth = big_v[..., 3]
            alpha = 1.0 - trans
        grad = jnp.zeros((hi_i, wi_i, 3), dt)
        return _finish(color, grad, depth, alpha)
    # ---- shaded (diffuse/shadow) path -------------------------------------
    light_dir = safe_normalize(scene.light.direction)
    wtc = jnp.stack([safe_normalize(horizontal), safe_normalize(vertical),
                     -direction])  # world->camera rows
    shadowed = cfg.shading == "shadow" and light_grid is not None
    mode = 2 if shadowed else 1
    eld, eli, pld, pli = _extra_lights_fan(scene, w1, w2, axis, dt)
    P = dict(
        grid=grid, tab=rgba_tab, vr=value_range, base=base,
        pg=pg, qg=qg, lin=l_in, lout=l_out, speed=speed,
        lam=lam, fz=fz, k0f=k0.astype(dt), half=half,
        ew1=e[w1], ew2=e[w2], dw1=direction[w1], dw2=direction[w2],
        lo1=lo1, lo2=lo2, ex1=ex1, ex2=ex2,
        glo1=lo[w1], gex1=ext[w1], glo2=lo[w2], gex2=ext[w2],
        k1=k1_map, k2=k2_map, inv_da=jnp.asarray(inv_da, dt),
        dzdlam=jnp.asarray(dz * dlam, dt),
        ld1=light_dir[w1], ld2=light_dir[w2], lda=light_dir[axis],
        wtcp=wtc[:, (w1, w2, axis)], zabs=z_abs,
    )
    if eld is not None:
        P["eld"] = eld
        P["eli"] = eli
    if pld is not None:
        P["pld"] = pld
        P["pli"] = pli
    if shadowed:
        lgrid = _volume_view(light_grid, axis, sign)
        l_a = lgrid.shape[0]
        cl = jnp.clip(z_rel / ext[axis] * l_a - 0.5, 0.0, l_a - 1.0)
        k0l = jnp.clip(jnp.floor(cl).astype(jnp.int32), 0, max(l_a - 2, 0))
        P["lgrid"] = lgrid
        P["k0lf"] = k0l.astype(dt)
        P["fzl"] = cl - k0l.astype(dt)
    else:
        P["k0lf"] = jnp.zeros((n_loc,), dt)
        P["fzl"] = jnp.zeros((n_loc,), dt)
    if sw.pallas:
        zdt = jnp.zeros((), dt)
        if maj_v is not None:
            P["maj"] = maj_v
        P["sc"] = _kernel_scalars(
            dt, lo1=lo1, ex1=ex1, lo2=lo2, ex2=ex2, e1=e[w1], e2=e[w2],
            dw1=direction[w1] if ortho else zdt,
            dw2=direction[w2] if ortho else zdt,
            half=half, dz=dz, off=off + slice0, vr=value_range, base=base,
            lam0=lam[0] - (off + slice0) * dz * dlam, n_a=n_a, dlam=dlam,
            exa=ext[axis],
            ld=(light_dir[w1], light_dir[w2], light_dir[axis]),
            k1o=direction[w1] if ortho else zdt,
            k2o=direction[w2] if ortho else zdt,
            inv_da=jnp.asarray(inv_da, dt),
            dzdlam=jnp.asarray(dz * dlam, dt),
            wtcp=wtc[:, (w1, w2, axis)],
            extra_lights=((eld, eli) if eld is not None else None),
            **_box_scalars)
    color, grad, depth, alpha = _shaded_loop(
        (sw, ortho, mode, n_loc, hi_i, wi_i), P)
    return _finish(color, grad, depth, alpha)


def _sw_warp_out(color, grad, depth, alpha, cfg, camera, sw: SwStatic,
                 p_scr, q_scr, p_lo, q_lo, dp, dq, pg, u, v,
                 e, direction, horizontal, vertical, axis, w1, w2, sign,
                 ortho, dt):
    """Final warp: intermediate (Q, P) -> screen (v, u), then flatten.

    O[v, u] = stack[cq(u, v), cp(u, v)], exact two-pass decomposition:
      T[s, pi] = stack[cq(t*(pi, s), s), pi]   (t* inverts P along the
        screen axis paired with P: u normally, v when sw.swap)
      O[v, u] = T[row_of(v,u), cp(u, v)]
    Substituting pi = cp(t, s) gives t*(cp, s) = t, so the composition
    reproduces stack[cq, cp]. Both inverse maps are closed-form rationals
    of the camera basis — dense elementwise, no gathers anywhere.
    """
    stack = jnp.concatenate(
        [color, grad, depth[..., None], alpha[..., None]], axis=-1)
    cp = (p_scr - p_lo) / dp - 0.5  # (H, W) continuous col index
    q_to_row = lambda q: (q - q_lo) / dq - 0.5

    def q_at(us, vs):
        """Q value of the ray at screen params (us, vs), broadcastable."""
        if ortho:
            return e[w2] + us * horizontal[w2] + vs * vertical[w2]
        num = direction[w2] + us * horizontal[w2] + vs * vertical[w2]
        den = (direction[axis] + us * horizontal[axis]
               + vs * vertical[axis]) * sign
        return _safe_div(num, den)

    if sw.separable:
        # P varies only along one screen axis and Q only along the other:
        # both passes collapse to shared-weight matmuls
        cq = q_to_row(q_scr)
        if not sw.swap:
            out = warp_separable(stack, cq[:, 0], cp[0, :], bf16=sw.bf16)
        else:
            a = warp_separable(stack, cq[0, :], cp[:, 0], bf16=sw.bf16)
            out = jnp.transpose(a, (1, 0, 2))  # (W, H, C) -> (H, W, C)
    elif not sw.swap:
        # u*(pi, v): solve P(u, v) = pi for u, per screen row
        vs = v[:, None]  # (H, 1)
        pi = pg[None, :]  # (1, Wi)
        if ortho:
            us = _safe_div(pi - e[w1] - vs * vertical[w1], horizontal[w1])
        else:
            num = (pi * (direction[axis] + vs * vertical[axis]) * sign
                   - direction[w1] - vs * vertical[w1])
            den = horizontal[w1] - pi * horizontal[axis] * sign
            us = _safe_div(num, den)
        r1 = q_to_row(q_at(us, vs))  # (H, Wi) row index per (v, pi)
        # pass 1: per intermediate column, resample rows at r1
        t = warp_rows(jnp.transpose(stack, (1, 0, 2)), r1.T,
                      row_chunk=sw.row_chunk, bf16=sw.bf16)  # (Wi, H, C)
        t = jnp.transpose(t, (1, 0, 2))  # (H, Wi, C)
        out = warp_rows(t, cp, row_chunk=sw.row_chunk,
                        bf16=sw.bf16)  # (H, W, C)
    else:
        # v*(pi, u): solve P(u, v) = pi for v, per screen column
        us = u[None, :]  # (1, W)
        pi = pg[:, None]  # (Wi, 1)
        if ortho:
            vs = _safe_div(pi - e[w1] - us * horizontal[w1], vertical[w1])
        else:
            num = (pi * (direction[axis] + us * horizontal[axis]) * sign
                   - direction[w1] - us * horizontal[w1])
            den = vertical[w1] - pi * vertical[axis] * sign
            vs = _safe_div(num, den)
        r1 = q_to_row(q_at(us, vs))  # (Wi, W)
        t = warp_rows(jnp.transpose(stack, (1, 0, 2)), r1,
                      row_chunk=sw.row_chunk, bf16=sw.bf16)  # (Wi, W, C)
        t = jnp.transpose(t, (1, 0, 2))  # (W, Wi, C)
        out = warp_rows(t, cp.T, row_chunk=sw.row_chunk,
                        bf16=sw.bf16)  # (W, H, C)
        out = jnp.transpose(out, (1, 0, 2))  # (H, W, C)

    color = out[..., 0:3].reshape(-1, 3)
    grad = out[..., 3:6].reshape(-1, 3)
    depth = out[..., 6].reshape(-1)
    alpha = jnp.clip(out[..., 7], 0.0, 1.0).reshape(-1)
    return color, grad, depth, alpha
