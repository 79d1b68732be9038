"""Delta-tracking (Woodcock) volumetric path tracer.

Batched re-expression of the reference's second pipeline
(`ovr/devices/optix7/shaders_pathtracing.cu`): per pixel, track to a
collision through the volume, scatter isotropically, repeat up to the scatter
budget, collect ambient light on escape after >= 1 scatter:

- collision sampling (`delta_tracking`, shaders_pathtracing.cu:269-475):
  * global-majorant free flight (use_dda == 0, `:447-470`):
      t += -log(1-u)/mu_max; accept when u2 < alpha(t)*density_scale/mu_max
  * macrocell DDA tracking (use_dda == 1, spatial_partition.h:56-96):
      consume optical depth tau = -log(1-u) against per-cell majorants,
      candidate collision where tau runs out, rejection-test against the true
      opacity.
- scattering (`pathtracing`, `:477-542`): isotropic uniform-sphere direction,
  albedo = TF color, Le = ambient on escape (scatter_index != 0),
  throughput *= albedo per collision. The reference increments scatter_index
  twice per level (once in `pathtracing`, once into the child payload,
  `:506-516`), so `max_num_scatters = 24` allows 12 collisions — reproduced.

Instead of recursive optixTrace, the whole ray batch advances in lockstep
through a bounded `lax.while_loop` (one state machine per ray: each iteration
handles one macrocell segment or one collision candidate), then a scan over
scatter levels. Stochastic but fully jittable; randomness via threefry
(the reference uses a TEA hash per pixel, `random/random.h:146-188` — a
counter-based PRNG like threefry, so the reformulation is faithful in
distribution).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ovr_tpu.core.sampling import classify, intersect_box
from ovr_tpu.render.accel import MacrocellGrid
from ovr_tpu.render.camera import generate_rays, pixel_screen_coords

BIG = 3.4e38


def uniform_sample_sphere(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction on the unit sphere from u (..., 2) in [0,1)^2
    (`uniform_sample_sphere`, shaders_common.h:347-354)."""
    phi = 2.0 * jnp.pi * u[..., 0]
    cos_t = 1.0 - 2.0 * u[..., 1]
    sin_t = 2.0 * jnp.sqrt(u[..., 1] * (1.0 - u[..., 1]))
    return jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1)


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_scatters: int = 24  # params.h:86 (reference counts 2 per level)
    max_track_steps: int = 512  # bound on tracking-loop iterations per level
    use_dda: bool = True


def _sample_alpha(leaves, world_lo, world_hi, pos):
    grid, color_table, alpha_table, value_range, density_scale = leaves
    p_obj = (pos - world_lo) / (world_hi - world_lo)
    from ovr_tpu.neural.field import sample_any_volume

    s = sample_any_volume(grid, p_obj)
    rgb, a = classify(color_table, alpha_table, value_range, s)
    return rgb, a


def delta_track_global(leaves, world_lo, world_hi, org, direction, t0, t1,
                       key, cfg: PTConfig):
    """Global-majorant free-flight tracking (shaders_pathtracing.cu:447-470).

    Returns (hit (N,), t (N,), albedo (N,3)). mu_max = density_scale * 1.
    """
    n = org.shape[0]
    density_scale = leaves[4]
    mu_max = density_scale  # * max_opacity(=1), shaders_pathtracing.cu:281-283

    def cond(state):
        i, done, *_ = state
        return jnp.logical_and(i < cfg.max_track_steps,
                               jnp.logical_not(jnp.all(done)))

    def body(state):
        i, done, hit, t, albedo = state
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(k, (n, 2))
        t_new = t + -jnp.log1p(-u[:, 0]) / mu_max
        escaped = t_new > t1
        pos = org + t_new[:, None] * direction
        rgb, a = _sample_alpha(leaves, world_lo, world_hi, pos)
        accept = jnp.logical_and(jnp.logical_not(escaped),
                                 u[:, 1] < a * density_scale / mu_max)
        upd = jnp.logical_not(done)
        hit = jnp.where(upd & accept, True, hit)
        albedo = jnp.where((upd & accept)[:, None], rgb, albedo)
        t = jnp.where(upd, t_new, t)
        done = done | (upd & (escaped | accept))
        return (i + 1, done, hit, t, albedo)

    done0 = t0 >= t1
    state = (jnp.int32(0), done0, jnp.zeros(n, bool), t0,
             jnp.zeros((n, 3), org.dtype))
    _, _, hit, t, albedo = jax.lax.while_loop(cond, body, state)
    return hit, t, albedo


def delta_track_dda(leaves, world_lo, world_hi, org, direction, t0, t1,
                    key, cfg: PTConfig, mc: MacrocellGrid):
    """Macrocell-majorant tracking: the reference's DeltaTrackingIter
    (spatial_partition.h:56-96) as a lockstep state machine. Each loop
    iteration either (a) consumes the current cell's optical-depth budget and
    advances to the cell exit, or (b) places a collision candidate and
    rejection-tests it."""
    n = org.shape[0]
    density_scale = leaves[4]
    extent = world_hi - world_lo
    eps = 1e-7

    u0 = jax.random.uniform(jax.random.fold_in(key, 0xFFFF), (n,))
    tau0 = -jnp.log1p(-u0)

    def cond(state):
        i, done, *_ = state
        return jnp.logical_and(i < cfg.max_track_steps,
                               jnp.logical_not(jnp.all(done)))

    def body(state):
        i, done, hit, t, tau, albedo = state
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(k, (n, 2))

        t_probe = t + eps
        pos = org + t_probe[:, None] * direction
        p_obj = (pos - world_lo) / extent
        maj = mc.majorant_at(p_obj) * density_scale
        t_exit = mc.cell_exit_t(org, direction, t_probe, world_lo, world_hi)
        seg_end = jnp.minimum(t_exit, t1)

        empty = maj <= 1.19e-7
        dtau_cap = (seg_end - t) * maj
        passes = empty | (tau > dtau_cap)  # tau survives the whole cell

        # (a) pass through the cell
        t_pass = seg_end
        tau_pass = jnp.where(empty, tau, tau - dtau_cap)
        done_pass = seg_end >= t1  # exits the volume: no collision

        # (b) collision candidate inside this cell
        t_cand = t + tau / jnp.maximum(maj, 1e-30)
        pos_c = org + t_cand[:, None] * direction
        rgb, a = _sample_alpha(leaves, world_lo, world_hi, pos_c)
        accept = u[:, 0] * maj < a * density_scale
        tau_new = -jnp.log1p(-u[:, 1])  # redraw on rejection

        upd = jnp.logical_not(done)
        new_t = jnp.where(passes, t_pass, t_cand)
        new_tau = jnp.where(passes, tau_pass, tau_new)
        new_hit = jnp.logical_not(passes) & accept
        new_done = jnp.where(passes, done_pass, accept)

        hit = jnp.where(upd & new_hit, True, hit)
        albedo = jnp.where((upd & new_hit)[:, None], rgb, albedo)
        t = jnp.where(upd, new_t, t)
        tau = jnp.where(upd, new_tau, tau)
        done = done | (upd & new_done)
        return (i + 1, done, hit, t, tau, albedo)

    done0 = t0 >= t1
    state = (jnp.int32(0), done0, jnp.zeros(n, bool), t0, tau0,
             jnp.zeros((n, 3), org.dtype))
    _, _, hit, t, _, albedo = jax.lax.while_loop(cond, body, state)
    return hit, t, albedo


def trace_paths(leaves, world_lo, world_hi, org, direction, key,
                ambient, cfg: PTConfig, mc: Optional[MacrocellGrid] = None):
    """Full multi-scatter transport for a ray batch.

    Returns (color (N,3), alpha (N,)). Iterative form of the recursion in
    `pathtracing` (shaders_pathtracing.cu:477-542).
    """
    n = org.shape[0]
    dt = org.dtype

    t0 = jnp.zeros(n, dt)
    t1 = jnp.full((n,), BIG, dt)
    t0, t1 = intersect_box(org, direction, world_lo, world_hi, t0, t1)
    t0 = jnp.maximum(t0, 0.0)
    box_hit = t1 > t0
    alpha = box_hit.astype(dt)  # CH sets payload.alpha = 1 (:541)

    # reference counts scatter_index by 2 per level (see module docstring)
    max_levels = cfg.max_scatters // 2 + 1

    def track(o, d, a, b, k):
        if mc is not None and cfg.use_dda:
            return delta_track_dda(leaves, world_lo, world_hi, o, d, a, b, k,
                                   cfg, mc)
        return delta_track_global(leaves, world_lo, world_hi, o, d, a, b, k,
                                  cfg)

    def level(carry, li):
        org, direction, t0, t1, throughput, radiance, si, active = carry
        k = jax.random.fold_in(key, li)
        hit, t_hit, albedo = track(org, direction, t0, t1,
                                   jax.random.fold_in(k, 1))

        escaped = active & jnp.logical_not(hit)
        # ambient on escape after >= 1 scatter (:495-497)
        radiance = radiance + jnp.where(
            (escaped & (si != 0))[:, None], throughput * ambient, 0.0)

        si_hit = si + 1
        cont = si_hit <= cfg.max_scatters  # :507
        active = active & hit & cont
        throughput = jnp.where(active[:, None], throughput * albedo,
                               throughput)

        new_org = org + t_hit[:, None] * direction
        u = jax.random.uniform(jax.random.fold_in(k, 2), (n, 2))
        new_dir = uniform_sample_sphere(u)
        nt0 = jnp.zeros(n, dt)
        nt1 = jnp.full((n,), BIG, dt)
        nt0, nt1 = intersect_box(new_org, new_dir, world_lo, world_hi,
                                 nt0, nt1)
        nt0 = jnp.maximum(nt0, 0.0)
        org = jnp.where(active[:, None], new_org, org)
        direction = jnp.where(active[:, None], new_dir, direction)
        t0 = jnp.where(active, nt0, t0)
        t1 = jnp.where(active, jnp.maximum(nt1, nt0), t1)
        si = jnp.where(hit, si_hit + 1, si)  # child payload gets si+1 (:516)
        return (org, direction, t0, t1, throughput, radiance, si, active), None

    carry = (org, direction, t0, t1,
             jnp.ones((n, 3), dt), jnp.zeros((n, 3), dt),
             jnp.zeros(n, jnp.int32), box_hit)
    carry, _ = jax.lax.scan(level, carry, jnp.arange(max_levels))
    radiance = carry[5]
    return radiance, alpha


def render_frame(scene, cfg, camera, key, macrocells=None):
    """Render a path-traced frame (called from api.render)."""
    from ovr_tpu.api import Frame

    screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype)
    screen = screen.reshape(-1, 2)
    n = screen.shape[0]
    from ovr_tpu.api import _vol_repr
    leaves = (_vol_repr(scene.volume), scene.tfn.color, scene.tfn.alpha,
              scene.tfn.value_range, scene.density_scale)
    lo = scene.volume.world_lo
    hi = scene.volume.world_hi
    diag_steps = cfg.max_steps  # reuse the resolved bound for tracking
    ptcfg = PTConfig(max_scatters=cfg.max_scatters,
                     max_track_steps=max(diag_steps * 2, 64),
                     use_dda=cfg.use_macrocells)
    ambient = scene.light.ambient

    def one_sample(s, acc):
        skey = jax.random.fold_in(key, s)
        if cfg.spp > 1:
            jit2 = jax.random.uniform(skey, (n, 2), cfg.dtype) - 0.5
            sc = screen + jit2 / jnp.array([cfg.width, cfg.height], cfg.dtype)
        else:
            sc = screen
        org, direction = generate_rays(camera, sc, cfg.width, cfg.height)

        def trace(o, d):
            return trace_paths(leaves, lo, hi, o, d,
                               jax.random.fold_in(skey, 3), ambient,
                               ptcfg, macrocells)

        c = cfg.ray_chunk
        if c and n > c:
            # chunk the launch: bounds the tracker's working set (big
            # dense launches fault the runtime) and localizes the
            # scatter while_loop's exit to a chunk
            k = -(-n // c)
            pad = k * c - n
            org_p = jnp.pad(org, ((0, pad), (0, 0)))
            dir_p = jnp.pad(direction, ((0, pad), (0, 0)),
                            constant_values=1.0)
            outs = jax.lax.map(lambda ar: trace(*ar),
                               (org_p.reshape(k, c, 3),
                                dir_p.reshape(k, c, 3)))
            color = outs[0].reshape(k * c, 3)[:n]
            alpha = outs[1].reshape(k * c)[:n]
        else:
            color, alpha = trace(org, direction)
        return (acc[0] + color, acc[1] + alpha)

    zero = (jnp.zeros((n, 3), cfg.dtype), jnp.zeros((n,), cfg.dtype))
    if cfg.spp == 1:
        acc = one_sample(0, zero)
    else:
        acc = jax.lax.fori_loop(0, cfg.spp, one_sample, zero)
    color, alpha = (a / cfg.spp for a in acc)
    rgba = jnp.concatenate([color, alpha[:, None]], -1)
    return Frame(
        rgba=rgba.reshape(cfg.height, cfg.width, 4),
        grad=jnp.zeros((cfg.height, cfg.width, 3), cfg.dtype),
    )
