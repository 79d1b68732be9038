"""Bricked-volume multi-device rendering with ring partial compositing.

The reference renderer is single-device (`ovr/devices/optix7/device_impl.cpp:
370-372` hardcodes device 0) and integrates each ray sequentially
(`shaders_raymarching.cu:87-171`). But the front-to-back compositing
recurrence

    C <- C + T * c * a ;  T <- T * (1 - a)

is associative in (C, T) pairs, so a ray can be split into segments that are
integrated independently and combined in ray order — the volume-rendering
analogue of blockwise/ring attention. This module exploits that seam to
render volumes too large for one device's memory:

- the grid is split into Z-slabs ("bricks"), one per device along the
  `bricks` mesh axis (each device holds ONLY its slab + a one-voxel halo);
- each device integrates its rays' sub-segment on the *global* march lattice
  (so sample positions match the unbricked renderer exactly) via
  `integrator.march_segment`;
- partial (color, gradient, transmittance) triples are combined with the
  over-operator in per-ray front-to-back order by a `ppermute` ring exchange
  over the device links (`ring_composite`; NCCL over NVLink on GPU hosts),
  or a single `all_gather` (`gather_composite`).

Brick geometry: for a (D, H, W) grid split into B slabs of S = D/B voxels,
brick b stores padded voxels [b*S-1, b*S+S] (edge-clamped halo) so trilinear
samples with the CUDA half-texel convention (core.sampling.sample_volume)
are bit-identical to sampling the full grid: the brick's sampling box is
chosen so local texel centers coincide with global ones (see brick_volume).
Ray-segment ownership partitions the world box at z = b/B planes.

Limitations: 'shadow' shading marches shadow rays only within the local
brick (an approximation — cross-brick shadows would need a second ring);
per-ray jitter is unsupported on the bricked path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ovr_tpu import api
from ovr_tpu.core.scene import Camera, Scene, StructuredVolume, _pytree_dataclass
from ovr_tpu.core.sampling import intersect_box, safe_normalize
from ovr_tpu.render import integrator as ig
from ovr_tpu.render.camera import camera_basis, generate_rays, pixel_screen_coords
from ovr_tpu.parallel.mesh import BRICK_AXIS, TILE_AXIS


@_pytree_dataclass
class BrickedVolume:
    """A Z-slab decomposition of a StructuredVolume.

    `bricks` is (B, S+4, H, W): slab b = padded grid voxels
    [b*S-2, b*S+S+1] (2-voxel halo: trilinear + gradient probe).
    `brick_lo`/`brick_hi` (B, 3) are each slab's *sampling* box (chosen so
    local texel centers coincide with the global grid's); `own_lo`/`own_hi`
    (B, 3) partition the world box into the z-ranges each brick integrates.
    Shard `bricks` and the bounds over the `bricks` mesh axis (leading dim).
    """

    bricks: jnp.ndarray
    brick_lo: jnp.ndarray
    brick_hi: jnp.ndarray
    own_lo: jnp.ndarray
    own_hi: jnp.ndarray

    @property
    def n_bricks(self) -> int:
        return self.bricks.shape[0]


def brick_volume(volume: StructuredVolume, n_bricks: int) -> BrickedVolume:
    """Host-side Z-slab decomposition (D % n_bricks == 0 required)."""
    grid = np.asarray(volume.grid)
    d = grid.shape[0]
    assert d % n_bricks == 0, f"depth {d} must divide into {n_bricks} bricks"
    s = d // n_bricks
    # 2-voxel halo: 1 voxel for trilinear interpolation at the ownership
    # boundary + 1 more for the finite-difference gradient probe one voxel
    # beyond it (shading samples grid at p + one voxel).
    padded = np.pad(grid, ((2, 2), (0, 0), (0, 0)), mode="edge")
    bricks = np.stack([padded[b * s: b * s + s + 4] for b in range(n_bricks)])

    wlo = np.asarray(volume.world_lo, np.float32)
    whi = np.asarray(volume.world_hi, np.float32)
    ez = whi[2] - wlo[2]
    blo = np.tile(wlo, (n_bricks, 1))
    bhi = np.tile(whi, (n_bricks, 1))
    olo = np.tile(wlo, (n_bricks, 1))
    ohi = np.tile(whi, (n_bricks, 1))
    for b in range(n_bricks):
        # sampling box: local texel center l+0.5 of the S+4 slab must map to
        # global texel center (b*S-2) + l + 0.5, which solves to:
        blo[b, 2] = wlo[2] + ez * (b * s - 2) / d
        bhi[b, 2] = wlo[2] + ez * (b * s + s + 2) / d
        # ownership partition at z = b/B planes of the world box
        olo[b, 2] = wlo[2] + ez * b / n_bricks
        ohi[b, 2] = wlo[2] + ez * (b + 1) / n_bricks
    return BrickedVolume(
        bricks=jnp.asarray(bricks), brick_lo=jnp.asarray(blo),
        brick_hi=jnp.asarray(bhi), own_lo=jnp.asarray(olo),
        own_hi=jnp.asarray(ohi))


def _over(front, back):
    """Over-compose two premultiplied (color, gradient, depth, transmittance)
    partials; `front` is nearer the camera. Identity: (0, 0, 0, 1)."""
    cf, gf, df, tf = front
    cb, gb, db, tb = back
    return (cf + tf[..., None] * cb, gf + tf[..., None] * gb,
            df + tf * db, tf * tb)


def _select(pred, a, b):
    """Elementwise tree-select; pred broadcasts over each leaf's batch dim."""
    return tuple(
        jnp.where(pred[..., None] if x.ndim > pred.ndim else pred, x, y)
        for x, y in zip(a, b))


def ring_composite(color, grad, depth, alpha, ascending, axis_name,
                   n_bricks: int):
    """Combine per-brick premultiplied partials over `axis_name` with a
    ppermute ring, in per-ray front-to-back order.

    `ascending` (N,) bool: True where the ray visits bricks in increasing
    index order (dir.z >= 0 for Z-slabs). Each of the B-1 ring steps shifts
    every brick's original partial one hop; arrivals with smaller index fold
    into a front-group accumulator, larger into a back-group, each with a
    prepend/append chosen per ray so group-internal order is front-to-back.

    Returns (color, grad, depth, alpha) of the full ray, identical on every
    brick.
    """
    i = jax.lax.axis_index(axis_name)
    ident = (jnp.zeros_like(color), jnp.zeros_like(grad),
             jnp.zeros_like(depth), jnp.ones_like(alpha))
    own = (color, grad, depth, 1.0 - alpha)
    acc_lt = ident  # bricks j < i, composed front-to-back
    acc_gt = ident  # bricks j > i
    trav = own
    perm = [(k, (k + 1) % n_bricks) for k in range(n_bricks)]
    for s in range(1, n_bricks):
        trav = jax.lax.ppermute(trav, axis_name, perm)
        j = (i - s) % n_bricks
        # arrivals come in decreasing j within each group; ascending rays
        # need them in increasing order -> prepend; descending -> append.
        pre_lt = _over(trav, acc_lt)
        app_lt = _over(acc_lt, trav)
        upd_lt = _select(ascending, pre_lt, app_lt)
        acc_lt = _select(jnp.broadcast_to(j < i, alpha.shape),
                         upd_lt, acc_lt)
        pre_gt = _over(trav, acc_gt)
        app_gt = _over(acc_gt, trav)
        upd_gt = _select(ascending, pre_gt, app_gt)
        acc_gt = _select(jnp.broadcast_to(j > i, alpha.shape),
                         upd_gt, acc_gt)
    asc_res = _over(acc_lt, _over(own, acc_gt))
    desc_res = _over(acc_gt, _over(own, acc_lt))
    c, g, d, t = _select(ascending, asc_res, desc_res)
    return c, g, d, 1.0 - t


def gather_composite(color, grad, depth, alpha, ascending, axis_name,
                     n_bricks: int):
    """all_gather-based composite (same result as ring_composite; one
    collective instead of B-1 pipelined hops)."""
    cs = jax.lax.all_gather(color, axis_name)  # (B, N, 3)
    gs = jax.lax.all_gather(grad, axis_name)
    ds = jax.lax.all_gather(depth, axis_name)  # (B, N)
    as_ = jax.lax.all_gather(alpha, axis_name)  # (B, N)
    ident = (jnp.zeros_like(color), jnp.zeros_like(grad),
             jnp.zeros_like(depth), jnp.ones_like(alpha))
    asc = desc = ident
    for b in range(n_bricks):
        asc = _over(asc, (cs[b], gs[b], ds[b], 1.0 - as_[b]))
        rb = n_bricks - 1 - b
        desc = _over(desc, (cs[rb], gs[rb], ds[rb], 1.0 - as_[rb]))
    c, g, d, t = _select(ascending, asc, desc)
    return c, g, d, 1.0 - t


def _strip_volume(scene: Scene) -> Scene:
    """Drop the dense grid so shard_map doesn't replicate it (world box and
    TF/light/camera leaves are all the bricked path needs from the scene)."""
    vol = dataclasses.replace(scene.volume,
                              grid=jnp.zeros((1, 1, 1), jnp.float32))
    return dataclasses.replace(scene, volume=vol)


def _render_brick_rows(scene: Scene, camera: Camera, cfg: api.RenderConfig,
                       bricked: BrickedVolume, screen_rows: jnp.ndarray,
                       segment_steps: int, composite=ring_composite,
                       n_bricks: int = 1) -> jnp.ndarray:
    """Per-device body: integrate my brick's segment of my rows' rays, then
    ring-composite over the brick axis. Returns (rows, W, 4)."""
    h, w = screen_rows.shape[:2]
    sc = screen_rows.reshape(-1, 2)
    org, direction = generate_rays(camera, sc, cfg.width, cfg.height)

    brick = bricked.bricks[0]
    blo, bhi = bricked.brick_lo[0], bricked.brick_hi[0]
    olo, ohi = bricked.own_lo[0], bricked.own_hi[0]

    dt = org.dtype
    n = org.shape[0]
    big = jnp.asarray(3.4e38, dt)
    t0 = jnp.zeros((n,), dt)
    t1 = jnp.full((n,), big, dt)
    t0g, t1g = intersect_box(org, direction, scene.volume.world_lo,
                             scene.volume.world_hi, t0, t1)
    t0g = jnp.maximum(t0g, 0.0)
    t1g = jnp.maximum(t1g, t0g)
    t_enter, t_exit = intersect_box(org, direction, olo, ohi, t0g, t1g)
    t_exit = jnp.maximum(t_exit, t_enter)

    _, cdir, chor, cver = camera_basis(camera, cfg.width, cfg.height)
    wtc = jnp.stack([safe_normalize(chor), safe_normalize(cver), -cdir])
    ctx = ig.ShadeContext(
        light_dir=safe_normalize(scene.light.direction), wtc=wtc,
        world_lo=blo, world_hi=bhi,
        grad_hi=(scene.volume.world_hi - blo) / (bhi - blo))
    leaves = (brick, scene.tfn.color, scene.tfn.alpha, scene.tfn.value_range,
              cfg.base_rate * jnp.ones((), dt))
    mcfg = ig.MarchConfig(
        max_steps=cfg.max_steps, shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1)
    step = jnp.asarray(1.0 / cfg.sampling_rate, dt)
    color, gradc, depth, alpha = ig.march_segment(
        org, direction, leaves, ctx, mcfg, step, t0g, t1g, t_enter, t_exit,
        segment_steps)

    ascending = direction[..., 2] >= 0
    color, gradc, depth, alpha = composite(color, gradc, depth, alpha,
                                           ascending, BRICK_AXIS, n_bricks)
    color, gradc, depth, alpha = ig.finalize(color, gradc, depth, alpha)
    rgba = jnp.concatenate([color, alpha[..., None]], -1)
    return rgba.reshape(h, w, 4)


def _render_brick_rows_sw(scene: Scene, camera: Camera,
                          cfg: api.RenderConfig, bricked: BrickedVolume,
                          light_grid, n_bricks: int, hb: int,
                          composite) -> jnp.ndarray:
    """Per-device body of the bricked shear-warp fast path: run the fused
    slice loop on my brick's slab over my screen band's ray fan, then
    ring-composite the fan-space partials over the brick axis and warp
    once. The shared plane schedule comes from the scene's (global) world
    box; my slab supplies `sample_box` (halo'd texels) and my ownership
    z-range supplies `clip_box`, so per-plane intervals are exactly the
    unbricked ones restricted to my segment.

    View along the brick axis (sw.axis == 2): the slice range partitions
    evenly over bricks (each device runs n_slices / B plane steps).
    Transverse views: every device runs the full schedule on its (1/B-row)
    slab planes — same total work, clipped laterally instead of axially.
    """
    from ovr_tpu.render import shearwarp as swr

    sw = cfg.sw
    dt = cfg.dtype
    vol = dataclasses.replace(scene.volume, grid=bricked.bricks[0])
    s = dataclasses.replace(scene, volume=vol)
    sample_box = (bricked.brick_lo[0], bricked.brick_hi[0])
    clip_box = (bricked.own_lo[0], bricked.own_hi[0])
    b = jax.lax.axis_index(BRICK_AXIS)
    if sw.axis == 2:
        n_loc = sw.n_slices // n_bricks
        order = b if sw.sign > 0 else (n_bricks - 1 - b)
        slice0 = (order * n_loc).astype(dt)
    else:
        n_loc = sw.n_slices
        slice0 = jnp.zeros((), dt)
    row0 = jax.lax.axis_index(TILE_AXIS) * hb
    color, grad, depth, alpha, asc, warp = swr.render_shearwarp(
        s, cfg, camera, light_grid=light_grid, row0=row0, n_rows=hb,
        sample_box=sample_box, clip_box=clip_box, slice0=slice0,
        n_slices_loc=n_loc, fan_only=True)
    hi_i, wi_i = alpha.shape
    c, g, d, a = composite(
        color.reshape(-1, 3), grad.reshape(-1, 3), depth.reshape(-1),
        alpha.reshape(-1), asc.reshape(-1), BRICK_AXIS, n_bricks)
    color, grad, depth, alpha = warp(
        c.reshape(hi_i, wi_i, 3), g.reshape(hi_i, wi_i, 3),
        d.reshape(hi_i, wi_i), a.reshape(hi_i, wi_i))
    color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
    rgba = jnp.concatenate([color, alpha[..., None]], -1)
    return rgba.reshape(hb, cfg.width, 4)


def make_train_step_bricked(cfg: api.RenderConfig, mesh: Mesh,
                            lr: float = 1e-2,
                            segment_steps: Optional[int] = None):
    """Distributed differentiable rendering with the volume SHARDED over
    bricks (never replicated — the 2048^3-scale training mode).

    Each device renders its brick's segment of its rows' rays (shear-warp
    when cfg.sw is set, else march), ring-composites, and computes the
    band loss. Gradients:
      - the local slab's gradient is `psum`'d over the TILE axis (every
        band integrates every brick),
      - halo-row gradients are exchanged ADDITIVELY with neighbor bricks
        by `ppermute` (a slab's 2-row halos are copies of the neighbors'
        edge rows; global-edge halos fold into the brick's own edge row,
        matching brick_volume's edge-clamp padding),
      - TF tables `psum` over the whole mesh.
    After the SGD update of the owned rows, halo VALUES are refreshed from
    the neighbors' new rows with a second ppermute, so every slab stays
    bit-consistent with an unbricked update.

    Returns step(bricked, tf_color, tf_alpha, scene, camera, target)
    -> (bricked', tf_color', tf_alpha', loss). `target` is (H, W, 4),
    row-sharded like the render.
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_bricks = mesh.shape[BRICK_AXIS]
    assert cfg.max_steps is not None, "call cfg.resolved(scene) first"
    assert cfg.height % n_tiles == 0
    hb = cfg.height // n_tiles
    seg = segment_steps or cfg.max_steps
    if cfg.sw is not None:
        rnd8 = lambda x: max(8, int(-(-x // 8) * 8))
        sw_band = dataclasses.replace(
            cfg.sw, inter_h=rnd8(max(64, cfg.sw.inter_h // n_tiles)))
        cfg_band = dataclasses.replace(cfg, sw=sw_band)

    def body(bricked, tfc, tfa, scene, camera, screen_rows, target_rows):
        def loss_fn(slab, c_, a_):
            bv = dataclasses.replace(bricked, bricks=slab[None])
            s = dataclasses.replace(
                scene, tfn=dataclasses.replace(scene.tfn, color=c_,
                                               alpha=a_))
            if cfg.sw is not None:
                rgba = _render_brick_rows_sw(
                    s, camera, cfg_band, bv, None, n_bricks, hb,
                    ring_composite)
            else:
                rgba = _render_brick_rows(
                    s, camera, cfg, bv, screen_rows, seg, ring_composite,
                    n_bricks)
            # every brick's device recomputes the SAME band loss (the
            # composited rgba is replicated over the brick axis), and the
            # transposed ppermute sums all of their cotangents — divide by
            # n_bricks so the assembled gradients equal the unbricked ones
            return jnp.sum((rgba - target_rows) ** 2) / (
                cfg.height * cfg.width * 4 * n_bricks)

        slab = bricked.bricks[0]
        (loss, grads) = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
            slab, tfc, tfa)
        g_slab, g_c, g_a = grads
        g_slab = jax.lax.psum(g_slab, TILE_AXIS)
        g_c = jax.lax.psum(g_c, (TILE_AXIS, BRICK_AXIS))
        g_a = jax.lax.psum(g_a, (TILE_AXIS, BRICK_AXIS))
        loss = jax.lax.psum(loss, (TILE_AXIS, BRICK_AXIS))

        s_own = slab.shape[0] - 4
        b = jax.lax.axis_index(BRICK_AXIS)
        is_first = b == 0
        is_last = b == n_bricks - 1
        g_pre = g_slab[0:2]        # belongs to the previous brick
        g_own = g_slab[2:s_own + 2]
        g_post = g_slab[s_own + 2:]  # belongs to the next brick
        perm_dn = [(k, (k - 1) % n_bricks) for k in range(n_bricks)]
        perm_up = [(k, (k + 1) % n_bricks) for k in range(n_bricks)]
        from_next = jax.lax.ppermute(g_pre, BRICK_AXIS, perm_dn)
        from_prev = jax.lax.ppermute(g_post, BRICK_AXIS, perm_up)
        # interior: add neighbor halo grads; global edges: the halo rows
        # were edge-clamp copies of my own edge row — fold them in
        g_own = g_own.at[0:2].add(jnp.where(is_first, 0.0, from_prev))
        g_own = g_own.at[0].add(jnp.where(is_first, g_pre.sum(0), 0.0))
        g_own = g_own.at[s_own - 2:].add(
            jnp.where(is_last, 0.0, from_next))
        g_own = g_own.at[s_own - 1].add(
            jnp.where(is_last, g_post.sum(0), 0.0))

        new_own = slab[2:s_own + 2] - lr * g_own
        new_tfc = jnp.clip(tfc - lr * g_c, 0.0, 1.0)
        new_tfa = jnp.clip(tfa - lr * g_a, 0.0, 1.0)

        # refresh halos from the neighbors' UPDATED rows
        top = jax.lax.ppermute(new_own[s_own - 2:], BRICK_AXIS, perm_up)
        bot = jax.lax.ppermute(new_own[0:2], BRICK_AXIS, perm_dn)
        edge_top = jnp.broadcast_to(new_own[0:1], top.shape)
        edge_bot = jnp.broadcast_to(new_own[-1:], bot.shape)
        top = jnp.where(is_first, edge_top, top)
        bot = jnp.where(is_last, edge_bot, bot)
        new_slab = jnp.concatenate([top, new_own, bot], axis=0)
        new_bricked = dataclasses.replace(bricked, bricks=new_slab[None])
        return new_bricked, new_tfc, new_tfa, loss

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(BRICK_AXIS), P(), P(), P(), P(), P(TILE_AXIS),
                  P(TILE_AXIS)),
        out_specs=(P(BRICK_AXIS), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(bricked: BrickedVolume, tfc, tfa, scene: Scene,
             camera: Camera, target):
        scene_s = _strip_volume(scene)
        screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype)
        return fn(bricked, tfc, tfa, scene_s, camera, screen, target)

    return step


def render_bricked(scene: Scene, bricked: BrickedVolume,
                   cfg: api.RenderConfig, mesh: Mesh,
                   camera: Optional[Camera] = None,
                   segment_steps: Optional[int] = None,
                   use_ring: bool = True,
                   light_grid=None) -> jnp.ndarray:
    """Render with image rows sharded over `tiles` and the volume bricked
    over `bricks`. Returns (H, W, 4), row-sharded, replicated over bricks.

    Routes to the shear-warp fast path when cfg carries a resolved plan
    (cfg.sw): per-brick fused slice loops + fan-space ring compositing.
    When the view's principal axis is the brick axis, resolve cfg with
    `sw_slice_align=n_bricks` so the slice range partitions evenly.

    `segment_steps` (march path only) bounds the per-brick march length;
    the default cfg.max_steps is always safe (a grazing ray can spend its
    whole path in one slab) — pass ~max_steps // n_bricks + margin when
    rays are known to cross slabs transversally.
    """
    if camera is None:
        camera = scene.camera
    assert cfg.max_steps is not None, "call cfg.resolved(scene) first"
    assert not cfg.jitter_rays, "jitter is unsupported on the bricked path"
    n_tiles = mesh.shape[TILE_AXIS]
    n_bricks = mesh.shape[BRICK_AXIS]
    assert bricked.n_bricks == n_bricks, (
        f"volume has {bricked.n_bricks} bricks, mesh axis is {n_bricks}")
    assert cfg.height % n_tiles == 0, "height must divide evenly over tiles"
    composite = ring_composite if use_ring else gather_composite
    scene_s = _strip_volume(scene)

    if cfg.sw is not None and not getattr(scene, "geometries", ()):
        sw = cfg.sw
        if sw.axis == 2 and sw.n_slices % n_bricks != 0:
            raise ValueError(
                f"n_slices={sw.n_slices} must divide over {n_bricks} "
                "bricks; resolve cfg with sw_slice_align=n_bricks")
        if light_grid is None and api._wants_light_grid(cfg):
            light_grid = api.build_light_grid(scene, cfg)
        hb = cfg.height // n_tiles
        rnd8 = lambda x: max(8, int(-(-x // 8) * 8))
        sw_band = dataclasses.replace(
            sw, inter_h=rnd8(max(64, sw.inter_h // n_tiles)))
        cfg_band = dataclasses.replace(cfg, sw=sw_band)
        lg = (light_grid if light_grid is not None
              else jnp.zeros((2, 2, 2), cfg.dtype))
        use_lg = light_grid is not None
        fn = shard_map(
            lambda s, c, bv, g: _render_brick_rows_sw(
                s, c, cfg_band, bv, g if use_lg else None, n_bricks, hb,
                composite),
            mesh=mesh,
            in_specs=(P(), P(), P(BRICK_AXIS), P()),
            out_specs=P(TILE_AXIS),
            check_vma=False,
        )
        return fn(scene_s, camera, bricked, lg)

    if segment_steps is None:
        segment_steps = cfg.max_steps
    screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype)

    fn = shard_map(
        lambda s, c, bv, rows: _render_brick_rows(
            s, c, cfg, bv, rows, segment_steps, composite, n_bricks),
        mesh=mesh,
        in_specs=(P(), P(), P(BRICK_AXIS), P(TILE_AXIS)),
        out_specs=P(TILE_AXIS),
        check_vma=False,
    )
    return fn(scene_s, camera, bricked, screen)
