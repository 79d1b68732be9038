"""Front-to-back emission-absorption ray-march integrator (pure jnp).

This is the correctness oracle of the framework (the reference has none) and
the differentiable path: a faithful re-expression of the reference's
ray-marching pipeline (`ovr/devices/optix7/shaders_raymarching.cu:87-171` and
`:260-321`) as vectorized `lax.scan` over march steps:

    t = (t0, min(t1, t0 + step))
    while t.y > t.x and alpha < 0.9999:
        s     = volume(org + 0.5*(t.x+t.y)*dir)
        rgba  = transfer_function(s);  rgba.a = 1-(1-a)^(base*(t.y-t.x))
        shade = gradient normal (+ shadow march at 'shadow' mode)
        C    += (1-alpha) * clamp(rgb) * a;  alpha += (1-alpha) * a
        t     = (t.y, min(t.y + step, t1))

Two drivers share the same step function:
- `march` — `lax.scan` over a static step count; reverse-mode differentiable
  (gradients flow to the grid, TF tables, camera rays and light).
- `march_while` — `lax.while_loop` that exits as soon as every ray in the
  batch is terminated; forward-only, used for interactive/benchmark rendering
  (the analogue of the early-exit divergence the reference gets for free from
  SIMT).

Empty-space skipping: given a `MacrocellGrid` (ovr_tpu.render.accel), steps in
macrocells whose majorant is zero jump straight to the cell exit — the
batched reformulation of the vnr adaptive-sampling iterator
(`ovr/devices/optix7/render/method_optix.cu:70-108`), lockstep across the ray
batch instead of per-thread DDA.

Shadow-step note: the reference's shadow pass effectively marches with step
`10 * step^2` due to double multiplication (`shaders_raymarching.cu:221-227`
feeding `sampling_scale * self.step` at `:64`); we use the intended
`shadow_scale * step` (shadow_scale = 10) — coarser shadows, same visuals.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ovr_tpu.core.sampling import (
    classify,
    gradient_of,
    intersect_box,
    opacity_correction,
    safe_normalize,
    sample_volume,
)
from ovr_tpu.neural.field import sample_any_volume


def _vol_rdim(vol, dtype):
    """Gradient step: one voxel for dense grids, one finest-level cell for
    neural fields."""
    if hasattr(vol, "grid_cfg"):
        r = float(vol.grid_cfg.max_resolution)
        return jnp.array([1.0 / r] * 3, dtype)
    z, y, x = vol.shape
    return jnp.array([1.0 / x, 1.0 / y, 1.0 / z], dtype)

SHADING_NONE = "none"
SHADING_DIFFUSE = "diffuse"  # gradient shading, no shadow rays
SHADING_SHADOW = "shadow"  # gradient shading + shadow march (reference default)
SHADING_SSH = "ssh"  # single-shade heuristic (vnr SINGLE_SHADE_HEURISTIC)

EARLY_EXIT_ALPHA = 0.9999  # shaders_raymarching.cu:110


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static integrator configuration (hashable; safe as a jit static arg)."""

    max_steps: int
    shading: str = SHADING_SHADOW
    shadow_scale: float = 10.0
    shadow_max_steps: int = 64
    light_intensity: float = 2.0  # light_rgb, shaders_raymarching.cu:138
    # adaptive (majorant-scaled) sampling: step *= clip(1/majorant, 1, scale)
    # within each macrocell — the vnr adaptive-sampling iterator
    # (render/method_optix.cu:70-108). 1.0 = fixed-step (exact parity).
    adaptive_scale: float = 1.0
    # SSH deferred-shade blend weight (vnr params.scivis_shading_scale,
    # render/method_optix.cu:168,238-244).
    shading_scale: float = 0.8


def _clamp01(x):
    return jnp.clip(x, 0.0, 1.0)


def _shadow_alpha(grid, color_table, alpha_table, value_range, base,
                  pos, light_dir, world_lo, world_hi, step, cfg: MarchConfig):
    """Alpha accumulated marching from `pos` toward the light (transmittance
    complement). Reference: `raymarching_shadow` (shaders_raymarching.cu:44-85)."""
    big = jnp.asarray(3.4e38, dtype=pos.dtype)
    n = pos.shape[0]
    t0 = jnp.zeros((n,), pos.dtype)
    t1 = jnp.full((n,), big, pos.dtype)
    t0, t1 = intersect_box(pos, light_dir, world_lo, world_hi, t0, t1)
    sstep = cfg.shadow_scale * step

    tx = t0
    ty = jnp.minimum(t1, t0 + sstep)
    alpha = jnp.zeros((n,), pos.dtype)

    def body(carry, _):
        tx, ty, alpha = carry
        active = (ty > tx) & (alpha < EARLY_EXIT_ALPHA)
        mid = 0.5 * (tx + ty)
        p = pos + mid[..., None] * light_dir
        s = sample_any_volume(grid, _to_object(p, world_lo, world_hi))
        _, a = classify(color_table, alpha_table, value_range, s)
        a = opacity_correction(a, base, ty - tx)
        alpha = jnp.where(active, alpha + (1.0 - alpha) * a, alpha)
        tx2 = ty
        ty2 = jnp.minimum(tx2 + sstep, t1)
        tx = jnp.where(active, tx2, tx)
        ty = jnp.where(active, ty2, ty)
        return (tx, ty, alpha), None

    (tx, ty, alpha), _ = jax.lax.scan(
        body, (tx, ty, alpha), None, length=cfg.shadow_max_steps
    )
    return alpha


def _to_object(p, world_lo, world_hi):
    """World position -> normalized [0,1]^3 texture coordinate."""
    return (p - world_lo) / (world_hi - world_lo)


@dataclasses.dataclass(frozen=True)
class ShadeContext:
    """Per-frame shading inputs (dynamic pytree)."""

    light_dir: Any  # (3,) normalized, toward the light
    wtc: Any  # (3,3) world->camera rotation rows
    world_lo: Any
    world_hi: Any
    # Local coordinate of the *global* volume's upper boundary per axis
    # (None = 1.0). Set by the bricked path so finite-difference gradients
    # flip direction only at the true volume edge, not at brick halos.
    grad_hi: Any = None
    # Precomputed shadow-alpha lattice over object space (render.lightgrid).
    # When present, 'shadow'/'ssh' shading does one trilinear fetch per
    # sample instead of a full shadow march.
    light_alpha: Any = None
    # Additional scene lights (ovr/scene.h:329-350): directional as (L, 3)
    # unit dirs + (L,) intensities; point as (L, 3) positions + (L,)
    # intensities with inverse-square falloff. None = primary light only.
    extra_dirs: Any = None
    extra_dir_intens: Any = None
    point_pos: Any = None
    point_intens: Any = None


jax.tree_util.register_dataclass(
    ShadeContext,
    data_fields=["light_dir", "wtc", "world_lo", "world_hi", "grad_hi",
                 "light_alpha", "extra_dirs", "extra_dir_intens",
                 "point_pos", "point_intens"],
    meta_fields=[],
)


def _march_step(carry, scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
                org, direction, step, t1, occupancy=None, t_own=None):
    """One front-to-back step for the whole ray batch. Returns new carry.

    `t_own`: optional per-ray (lo, hi) ownership window — intervals whose
    midpoint falls outside [lo, hi) contribute nothing. Used by the bricked
    multi-device path (ovr_tpu.parallel.bricks) to partition the global march
    lattice across volume bricks without changing sample positions.
    """
    (grid, color_table, alpha_table, value_range, base) = scene_leaves
    tx, ty, color, gradient, depth, alpha = carry

    active = (ty > tx) & (alpha < EARLY_EXIT_ALPHA)
    contrib = active
    if t_own is not None:
        own_lo, own_hi = t_own
        m = 0.5 * (tx + ty)
        contrib = active & (m >= own_lo) & (m < own_hi)
    mid = 0.5 * (tx + ty)
    pos = org + mid[..., None] * direction
    p_obj = _to_object(pos, ctx.world_lo, ctx.world_hi)

    s = sample_any_volume(grid, p_obj)
    rgb, a = classify(color_table, alpha_table, value_range, s)
    a = opacity_correction(a, base, ty - tx)

    if cfg.shading != SHADING_NONE:
        # Normal: flipped, normalized gradient (object == world axes up to the
        # box scale; xfmNormal with a diagonal matrix rescales then renormalizes,
        # so dividing by the box extent before normalizing is exact).
        g = gradient_of(lambda q: sample_any_volume(grid, q), p_obj, s,
                        _vol_rdim(grid, p_obj.dtype),
                        hi=1.0 if ctx.grad_hi is None else ctx.grad_hi)
        extent = ctx.world_hi - ctx.world_lo
        n_world = safe_normalize(-g / extent)
        n_cam = safe_normalize(
            jnp.einsum("ij,...j->...i", ctx.wtc, n_world))
        cos_nl = jnp.abs(jnp.sum(ctx.light_dir * n_world, axis=-1))
        if cfg.shading == SHADING_SHADOW:
            if ctx.light_alpha is not None:
                shadow = sample_volume(ctx.light_alpha, p_obj)
            else:
                shadow = _shadow_alpha(
                    grid, color_table, alpha_table, value_range, base,
                    pos, ctx.light_dir, ctx.world_lo, ctx.world_hi, step, cfg)
        else:
            shadow = 0.0
        total = cos_nl * cfg.light_intensity
        if ctx.extra_dirs is not None:
            # additional directional lights: |N . L_l| * I_l, summed
            cos_e = jnp.abs(n_world @ ctx.extra_dirs.T)  # (N, L)
            total = total + cos_e @ ctx.extra_dir_intens
        if ctx.point_pos is not None:
            # point lights with inverse-square falloff (scene.h:345-349)
            delta = ctx.point_pos[None, :, :] - pos[:, None, :]  # (N, L, 3)
            r2 = jnp.sum(delta * delta, axis=-1)
            ldir = delta * jax.lax.rsqrt(jnp.maximum(r2, 1e-12))[..., None]
            cos_p = jnp.abs(jnp.sum(n_world[:, None, :] * ldir, axis=-1))
            total = total + (cos_p / jnp.maximum(r2, 1e-6)
                             ) @ ctx.point_intens
        shade = 0.5 + 0.5 * total * (1.0 - shadow)
        rgb = rgb * shade[..., None]
    else:
        n_cam = jnp.zeros_like(pos)

    tr = (1.0 - alpha)
    aw = jnp.where(contrib, a, 0.0)
    color = color + (tr * aw)[..., None] * _clamp01(rgb)
    gradient = gradient + (tr * aw)[..., None] * _clamp01(n_cam)
    # premultiplied expected depth: enough to reconstruct the alpha-blended
    # sample position (org + depth*dir after finalize) and, because the
    # reference's screen projection is affine (`shaders_common.h:291-301`),
    # the exact alpha-blended optical flow (`compute_optical_flow`).
    depth = depth + tr * aw * mid
    alpha = alpha + tr * aw

    # Advance; with an occupancy grid, empty macrocells fast-forward to the
    # cell exit (contribution there is provably zero because the cell majorant
    # bounds TF opacity over the cell's value range).
    tx_next = ty
    ty_base = jnp.minimum(tx_next + step, t1)
    if occupancy is not None:
        maj = occupancy.majorant_at(p_obj)
        empty = maj <= 1.19e-7
        t_exit = occupancy.cell_exit_t(org, direction, mid,
                                       ctx.world_lo, ctx.world_hi)
        skip_to = jnp.maximum(t_exit, tx_next)
        tx_next = jnp.where(empty & active, jnp.minimum(skip_to, t1), tx_next)
        if cfg.adaptive_scale > 1.0:
            # vnr adaptive sampling (method_optix.cu:70-108): step size per
            # macrocell scaled by 1/majorant (opacity correction keeps the
            # integral consistent), capped at adaptive_scale. An interval may
            # overrun its cell by at most one base step (skip_to + step), so
            # a dense cell after a sparse one is sampled at base density
            # from its first interval.
            ss = step * jnp.clip(1.0 / jnp.maximum(maj, 1e-6), 1.0,
                                 cfg.adaptive_scale)
            ty_base = jnp.minimum(jnp.minimum(tx_next + ss, skip_to + step),
                                  t1)
        else:
            ty_base = jnp.minimum(tx_next + step, t1)
    tx = jnp.where(active, tx_next, tx)
    ty = jnp.where(active, ty_base, ty)
    return (tx, ty, color, gradient, depth, alpha)


def _init_carry(org, direction, scene_leaves, ctx, step, big=3.4e38):
    n = org.shape[0]
    dt = org.dtype
    t0 = jnp.zeros((n,), dt)
    t1 = jnp.full((n,), jnp.asarray(big, dt))
    t0, t1 = intersect_box(org, direction, ctx.world_lo, ctx.world_hi, t0, t1)
    t0 = jnp.maximum(t0, 0.0)
    t1 = jnp.maximum(t1, t0)  # empty intervals collapse to zero length
    tx = t0
    ty = jnp.minimum(t1, t0 + step)
    zero3 = jnp.zeros((n, 3), dt)
    zero = jnp.zeros((n,), dt)
    return (tx, ty, zero3, zero3, zero, zero), t1


def _apply_t_cap(carry, t1, t_cap):
    """Clip the march interval at per-ray cap `t_cap` (background geometry
    hits: the reference traces non-volume geometry first and the volume
    integral stops at the surface, `shaders_raymarching.cu:283-311`)."""
    if t_cap is None:
        return carry, t1
    tx, ty, c, g, d, a = carry
    t1 = jnp.minimum(t1, t_cap)
    tx = jnp.minimum(tx, t1)
    ty = jnp.minimum(ty, t1)
    return (tx, ty, c, g, d, a), t1


def _ssh_deferred_shade(color, alpha, pk_w, pk_t, org, direction,
                        scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
                        step):
    """Single-shade heuristic: one shadow evaluation at the ray's
    highest-contribution sample, blended over the unshaded composite
    (vnr `shadeVolume_radiance`, render/method_optix.cu:218-244)."""
    (grid, color_table, alpha_table, value_range, base) = scene_leaves
    pos = org + pk_t[..., None] * direction
    p_obj = _to_object(pos, ctx.world_lo, ctx.world_hi)
    s = sample_any_volume(grid, p_obj)
    rgb, _ = classify(color_table, alpha_table, value_range, s)
    if ctx.light_alpha is not None:
        sh_a = sample_volume(ctx.light_alpha, p_obj)
    else:
        sh_a = _shadow_alpha(grid, color_table, alpha_table, value_range,
                             base, pos, ctx.light_dir, ctx.world_lo,
                             ctx.world_hi, step, cfg)
    lit = _clamp01(rgb) * (alpha * (1.0 - sh_a))[..., None]
    w = cfg.shading_scale
    shaded = (1.0 - w) * color + w * lit
    return jnp.where((pk_w > 0)[..., None], shaded, color)


def march(org, direction, scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
          step, occupancy=None, jitter=None, t_cap=None):
    """Differentiable scan-based march. Returns (color, gradient, depth,
    alpha) premultiplied accumulators (see `finalize`).

    `org`/`direction`: (N, 3) world-space rays. `scene_leaves` =
    (grid, color_table, alpha_table, value_range, base). `step`: scalar world
    step (1 / sampling_rate). `jitter`: optional (N,) in [0,1) multiplied by
    step and added to t0 (OVR_OPTIX7_JITTER_RAYS behavior, shaders_raymarching
    .cu:194-197). `t_cap`: optional (N,) march stop (surface hits).
    """
    carry, t1 = _init_carry(org, direction, scene_leaves, ctx, step)
    carry, t1 = _apply_t_cap(carry, t1, t_cap)
    if jitter is not None:
        tx, ty, c, g, d, a = carry
        tx = tx + jitter * step
        ty = jnp.minimum(t1, tx + step)
        carry = (tx, ty, c, g, d, a)

    if cfg.shading == SHADING_SSH:
        cfg_inner = dataclasses.replace(cfg, shading=SHADING_NONE)
        n = org.shape[0]

        def body_ssh(state, _):
            carry, pk_w, pk_t = state
            tx, ty = carry[0], carry[1]
            alpha_old = carry[5]
            mid = 0.5 * (tx + ty)
            carry = _march_step(carry, scene_leaves, ctx, cfg_inner, org,
                                direction, step, t1, occupancy)
            w = carry[5] - alpha_old  # this step's contribution tr*a
            better = w > pk_w
            pk_w = jnp.where(better, w, pk_w)
            pk_t = jnp.where(better, mid, pk_t)
            return (carry, pk_w, pk_t), None

        zero = jnp.zeros((n,), org.dtype)
        (carry, pk_w, pk_t), _ = jax.lax.scan(
            body_ssh, (carry, zero, zero), None, length=cfg.max_steps)
        _, _, color, gradient, depth, alpha = carry
        color = _ssh_deferred_shade(color, alpha, pk_w, pk_t, org, direction,
                                    scene_leaves, ctx, cfg, step)
        return color, gradient, depth, alpha

    def body(carry, _):
        carry = _march_step(carry, scene_leaves, ctx, cfg, org, direction,
                            step, t1, occupancy)
        return carry, None

    carry, _ = jax.lax.scan(body, carry, None, length=cfg.max_steps)
    _, _, color, gradient, depth, alpha = carry
    return color, gradient, depth, alpha


def march_segment(org, direction, scene_leaves, ctx: ShadeContext,
                  cfg: MarchConfig, step, t0_lattice, t1_global,
                  t_enter, t_exit, segment_steps: int):
    """March only the intervals of the global lattice owned by [t_enter,
    t_exit) — the per-brick integrator of the multi-device bricked path.

    Sample positions stay on the global march lattice anchored at
    `t0_lattice` (the ray's entry into the *whole* volume): interval k is
    [t0 + k*step, min(t0 + (k+1)*step, t1_global)], and this segment
    integrates exactly the intervals whose midpoint lies in [t_enter, t_exit),
    so summing the premultiplied partials of a partition of [t0, t1] under the
    over-operator reproduces the unbricked march up to fp ordering.

    Returns premultiplied (color, gradient, alpha) — NOT finalized.
    """
    dt = org.dtype
    # Integer lattice index so every brick computes bit-identical interval
    # positions (an accumulated tx += step chain would diverge by ulps across
    # bricks and mis-partition boundary intervals).
    k_lo = jnp.maximum(jnp.ceil((t_enter - t0_lattice) / step - 0.5), 0.0)
    n = org.shape[0]
    zero3 = jnp.zeros((n, 3), dt)
    zero = jnp.zeros((n,), dt)

    def body(carry, s):
        k, color, gradient, depth, alpha = carry
        tx = t0_lattice + k * step
        ty = jnp.minimum(tx + step, t1_global)
        st = (tx, ty, color, gradient, depth, alpha)
        _, _, color, gradient, depth, alpha = _march_step(
            st, scene_leaves, ctx, cfg, org, direction, step, t1_global,
            t_own=(t_enter, t_exit))
        return (k + 1.0, color, gradient, depth, alpha), None

    carry, _ = jax.lax.scan(body, (k_lo, zero3, zero3, zero, zero), None,
                            length=segment_steps)
    _, color, gradient, depth, alpha = carry
    return color, gradient, depth, alpha


def march_while(org, direction, scene_leaves, ctx: ShadeContext,
                cfg: MarchConfig, step, occupancy=None, jitter=None,
                t_cap=None):
    """Forward-only march that exits once every ray terminates (fast path)."""
    carry, t1 = _init_carry(org, direction, scene_leaves, ctx, step)
    carry, t1 = _apply_t_cap(carry, t1, t_cap)
    if jitter is not None:
        tx, ty, c, g, d, a = carry
        tx = tx + jitter * step
        ty = jnp.minimum(t1, tx + step)
        carry = (tx, ty, c, g, d, a)

    ssh = cfg.shading == SHADING_SSH
    cfg_inner = dataclasses.replace(cfg, shading=SHADING_NONE) if ssh else cfg
    n = org.shape[0]
    zero = jnp.zeros((n,), org.dtype)

    def cond(state):
        i, (tx, ty, _, _, _, alpha), _, _ = state
        any_active = jnp.any((ty > tx) & (alpha < EARLY_EXIT_ALPHA))
        return jnp.logical_and(i < cfg.max_steps, any_active)

    def body(state):
        i, carry, pk_w, pk_t = state
        tx, ty = carry[0], carry[1]
        alpha_old = carry[5]
        mid = 0.5 * (tx + ty)
        carry = _march_step(carry, scene_leaves, ctx, cfg_inner, org,
                            direction, step, t1, occupancy)
        if ssh:
            w = carry[5] - alpha_old
            better = w > pk_w
            pk_w = jnp.where(better, w, pk_w)
            pk_t = jnp.where(better, mid, pk_t)
        return (i + 1, carry, pk_w, pk_t)

    _, carry, pk_w, pk_t = jax.lax.while_loop(
        cond, body, (jnp.int32(0), carry, zero, zero))
    _, _, color, gradient, depth, alpha = carry
    if ssh:
        color = _ssh_deferred_shade(color, alpha, pk_w, pk_t, org, direction,
                                    scene_leaves, ctx, cfg, step)
    return color, gradient, depth, alpha


def finalize(color, gradient, depth, alpha):
    """Convert premultiplied accumulators to the stored (straight) outputs.

    With no background geometry the reference divides by the final alpha
    (`alpha_blend` with zero background, shaders_raymarching.cu:314-320).
    `depth` becomes the alpha-blended expected hit distance (0 on empty rays).

    Gradient safety: the divisor is replaced by 1 where alpha ~ 0 (double-
    where pattern) so the division's VJP stays finite — resampled paths can
    carry subnormal-tiny alphas whose reciprocal squares overflow.
    """
    eps = 1e-12
    sel = alpha > eps
    safe = jnp.where(sel, alpha, 1.0)
    safe3 = safe[..., None]
    sel3 = sel[..., None]
    out_color = jnp.where(sel3, color / safe3, 0.0)
    out_grad = jnp.where(sel3, gradient / safe3, 0.0)
    out_depth = jnp.where(sel, depth / safe, 0.0)
    return out_color, out_grad, out_depth, alpha
