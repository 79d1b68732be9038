"""Public rendering API.

The reference exposes an abstract `MainRenderer` with a mailbox-setter +
swap/commit/render/mapframe lifecycle (`ovr/renderer.h:82-288`) because its
GUI and CUDA device run on different threads. In JAX the render is a pure
function, so the core API is simply:

    frame = render(scene, cfg, camera=camera, frame_index=i, key=key)

`Renderer` wraps that in a stateful facade with the reference's setter
surface (set_camera / set_transfer_function / set_sample_per_pixel /
set_volume_sampling_rate / set_path_tracing / set_frame_accumulation / ...)
for drop-in-style interactive and batch apps; `commit()` re-jits only when a
static setting changed, `render()` runs a frame (handling accumulation
state), `mapframe()` returns host numpy arrays.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ovr_tpu.core.scene import Camera, Scene
from ovr_tpu.core.sampling import safe_normalize
from ovr_tpu.render import accel
from ovr_tpu.render import integrator as ig
from ovr_tpu.render.camera import (
    blended_flow,
    camera_basis,
    generate_rays,
    pixel_screen_coords,
)


# rays per lax.map chunk on the march / MC-tracker path (RenderConfig
# .ray_chunk's resolved default): bounds the working set on big frames;
# timed on the card within 10% of an unchunked 1080p frame (PERF.md)
MARCH_RAY_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; a jit static argument)."""

    width: int = 512
    height: int = 512
    spp: int = 1
    sampling_rate: float = 64.0  # samples per world unit; step = 1/rate
    base_rate: float = 1.0  # opacity-correction base (volume.h:128, default 1)
    # integration method: "march" = per-ray scan integrator (general,
    # differentiable); "shearwarp" = the dense slice-order fast path
    # (render.shearwarp; requires eligibility — raises otherwise);
    # "auto" = shearwarp when eligible, else march.
    method: str = "march"
    # shear-warp intermediate-fan resolution cap per axis; the effective
    # fan is min(2 x voxel dims, 1.25 x the paired screen axis, this cap)
    sw_inter_cap: int = 2048
    # round the shear-warp slice count up to a multiple (the bricked path
    # partitions the slice range evenly over n_bricks devices)
    sw_slice_align: int = 1
    sw_bf16: bool = False  # bfloat16 shear-warp matmuls (f32 accumulate)
    # run the slice loop in the fused kernel (ops.swslice; carry held in
    # registers) where the platform has one, else the XLA slice loop;
    # gradients route through the XLA adjoint either way
    sw_pallas: bool = True
    # early ray termination inside the fused kernel (alpha >= 0.9999 +
    # box-exit test, `shaders_raymarching.cu:110`); off under autodiff
    sw_term: bool = True
    # macrocell empty-slice skipping inside the fused kernel (pass
    # macrocells= to render(); `accel/dda.h` semantics)
    sw_skip: bool = True
    sw: Any = None  # resolved shear-warp plan (SwStatic; set by resolved())
    shading: str = ig.SHADING_SHADOW
    shadow_scale: float = 10.0
    max_steps: Optional[int] = None  # None: derived from the scene box
    shadow_max_steps: Optional[int] = None
    path_tracing: bool = False
    max_scatters: int = 24  # params.h:86
    # dense path tracing (render.ptdense): discrete-ordinates lattice
    # solve + shear-warp camera gather instead of per-ray delta tracking
    pt_dense: bool = False
    pt_lattice: int = 128  # scatter-lattice resolution cap per axis
    pt_dirs: int = 14  # quadrature directions (6 axial [+ 8 diagonal])
    use_macrocells: bool = False  # empty-space skip / majorant DDA
    # adaptive (majorant-scaled) step size within macrocells, vnr
    # method_optix.cu:70-108; > 1 enables, value = max step multiplier.
    adaptive_scale: float = 1.0
    jitter_rays: bool = False  # OVR_OPTIX7_JITTER_RAYS
    fast_math: bool = False  # while_loop early exit (forward-only)
    # shadow term from a precomputed light-transmittance lattice
    # (render.lightgrid) instead of a per-sample shadow march
    shadow_grid: bool = True
    # lattice resolution cap per axis; 0 = scale with the volume
    # (clamp(grid/4, 128, 512)) so 1024^3 grids get a 256-class lattice
    # instead of an 8x-per-axis-coarser one
    shadow_grid_res: int = 0
    shading_scale: float = 0.8  # 'ssh' deferred-shade blend weight
    # rays per lax.map chunk (None = whole frame at once); bounds working-set
    # memory and localizes the fast-math early exit to a chunk
    ray_chunk: Optional[int] = None
    iso_steps: int = 128  # isosurface root-bracketing steps
    geometry_chunk: int = 256  # triangles per Möller-Trumbore block
    # neural-field fast path: bake the field to a dense proxy grid and
    # render it through shear-warp (method='shearwarp'/'auto' only; the
    # march path samples the field exactly). The bake is differentiable,
    # so weight gradients flow render -> proxy -> field (the repo's north
    # star, BASELINE config #4; reference TODO `README.md:12`).
    neural_proxy: bool = True
    neural_proxy_res: int = 512  # proxy lattice resolution per axis
    dtype: Any = jnp.float32

    def resolved(self, scene: Scene, camera: Optional[Camera] = None
                 ) -> "RenderConfig":
        """Fill derived step counts from the scene's world box, and the
        shear-warp plan from the camera (host-side, not jittable)."""
        lo = np.asarray(scene.volume.world_lo)
        hi = np.asarray(scene.volume.world_hi)
        diag = float(np.linalg.norm(hi - lo))
        updates = {}
        if self.max_steps is None:
            updates["max_steps"] = int(np.ceil(diag * self.sampling_rate)) + 2
        if self.shadow_max_steps is None:
            n = int(np.ceil(diag * self.sampling_rate / self.shadow_scale)) + 2
            updates["shadow_max_steps"] = n
        if self.method in ("shearwarp", "auto"):
            from ovr_tpu.render import shearwarp
            pt_dense = self.path_tracing and self.pt_dense
            eligible = (pt_dense
                        or (not self.path_tracing
                            and self.shading in (ig.SHADING_NONE,
                                                 ig.SHADING_DIFFUSE,
                                                 ig.SHADING_SHADOW)))
            view = (dataclasses.replace(self, shading=ig.SHADING_NONE)
                    if pt_dense else self)  # pt gather is unshaded
            insts = getattr(scene, "instances", ())
            if (eligible and not insts and self.neural_proxy
                    and not hasattr(scene.volume, "grid")):
                # neural field: plan shear-warp over the baked proxy grid
                # (shape-only shim; the bake itself happens under jit)
                scene = dataclasses.replace(
                    scene, volume=_proxy_shim(scene.volume, self))
            if eligible and insts and not pt_dense:
                # multi-volume: one shear-warp plan per volume instance;
                # screen partials depth-sort + over-composite
                # (render.multivol's ordering). Lattice shadows would
                # need per-instance light grids — march instead.
                sw = None
                any_xfm = any(getattr(i, "xfm", None) is not None
                              for i in insts)
                if (not any_xfm
                        and self.shading in (ig.SHADING_NONE,
                                             ig.SHADING_DIFFUSE)):
                    plans = []
                    vols = [(scene.volume, scene.tfn)] + [
                        (i.volume, i.tfn) for i in insts]
                    for vol, tfn_ in vols:
                        sv = dataclasses.replace(
                            scene, volume=vol, tfn=tfn_, instances=())
                        p = shearwarp.resolve_static(
                            sv, camera or scene.camera, view)
                        if p is None:
                            plans = None
                            break
                        plans.append(p)
                    sw = tuple(plans) if plans else None
            elif eligible:
                sw = shearwarp.resolve_static(
                    scene, camera or scene.camera, view)
            else:
                sw = None
            if sw is None and self.method == "shearwarp":
                raise ValueError(
                    "shearwarp ineligible for this scene/camera/config "
                    "(needs a dense-grid volume, no geometries, shading in "
                    "{none, diffuse}, and a perspective eye outside the "
                    "principal slab); use method='auto' to fall back")
            updates["sw"] = sw
        elif self.sw is not None:
            updates["sw"] = None
        pt_mc = self.path_tracing and not self.pt_dense
        if (self.ray_chunk is None
                and (pt_mc or (not self.path_tracing
                               and updates.get("sw", self.sw) is None))):
            # march / MC-tracker path: chunk the frame so the while_loop
            # early exit terminates per chunk and the working set stays
            # bounded
            updates["ray_chunk"] = MARCH_RAY_CHUNK
        return dataclasses.replace(self, **updates) if updates else self


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frame:
    """Rendered frame: rgba (H, W, 4) straight-alpha, grad (H, W, 3)
    camera-space shaded-normal channel (the reference's second framebuffer,
    `ovr/renderer.h:89-97`), depth (H, W) alpha-blended expected hit
    distance, and flow (H, W, 2) screen-space optical flow vs last_camera
    (`shaders_common.h:303-309`; None unless last_camera was given)."""

    rgba: jnp.ndarray
    grad: jnp.ndarray
    depth: Any = None
    flow: Any = None


def _vol_repr(volume):
    """Dense volumes render from their grid; neural-field volumes are their
    own sampleable representation (neural.field.sample_any_volume)."""
    return volume.grid if hasattr(volume, "grid") else volume


@dataclasses.dataclass(frozen=True)
class _ShimVolume:
    """Shape-only stand-in for the neural proxy grid during host-side plan
    resolution (no allocation: a broadcast view of one zero)."""

    grid: Any
    world_lo: Any
    world_hi: Any


def _proxy_shim(field, cfg) -> _ShimVolume:
    r = int(cfg.neural_proxy_res)
    return _ShimVolume(
        grid=np.broadcast_to(np.zeros(1, np.float32), (r, r, r)),
        world_lo=np.asarray(field.world_lo), world_hi=np.asarray(field.world_hi))


def bake_proxy_scene(scene: Scene, cfg: RenderConfig, grid=None) -> Scene:
    """Replace a neural-field volume with its dense baked proxy — the
    shear-warp fast path for neural rendering (differentiable: gradients
    flow through the bake to the hash tables and MLP weights). Pass a
    precomputed `grid` (e.g. from `neural.train.bake_grid`) to amortize
    the bake across frames; `Renderer.commit` caches one."""
    from ovr_tpu.core.scene import StructuredVolume
    from ovr_tpu.neural.train import bake_grid

    vol = scene.volume
    if hasattr(vol, "grid"):
        return scene
    r = int(cfg.neural_proxy_res)
    if grid is None:
        grid = bake_grid(vol, (r, r, r))
    proxy = StructuredVolume(
        grid=grid, world_lo=jnp.asarray(vol.world_lo, cfg.dtype),
        world_hi=jnp.asarray(vol.world_hi, cfg.dtype),
        data_range=jnp.asarray(vol.data_range, cfg.dtype))
    return dataclasses.replace(scene, volume=proxy)


def _extra_lights(scene: Scene):
    """Stack scene.lights into the ShadeContext's dense light arrays.

    Directional/sunSky lights shade like the primary (|N.L| * I); point
    lights add inverse-square falloff. Intensity folds the light color's
    mean and the reference's implicit light_rgb = 2
    (`shaders_raymarching.cu:137-138`) so a unit extra light matches the
    primary's weight. Ambient entries only feed the path tracer.
    """
    dirs, dir_i, pts, pt_i = [], [], [], []
    for lt in scene.lights:
        mean_c = jnp.mean(lt.color)
        if lt.kind in ("directional", "sunsky"):
            dirs.append(safe_normalize(lt.direction))
            dir_i.append(2.0 * lt.intensity * mean_c)
        elif lt.kind == "point":
            pts.append(lt.position)
            pt_i.append(2.0 * lt.intensity * mean_c)
    out = {}
    if dirs:
        out["extra_dirs"] = jnp.stack(dirs)
        out["extra_dir_intens"] = jnp.stack(dir_i)
    if pts:
        out["point_pos"] = jnp.stack(pts)
        out["point_intens"] = jnp.stack(pt_i)
    return out


def _shade_ctx(scene: Scene, camera: Camera, cfg: RenderConfig,
               light_alpha=None) -> ig.ShadeContext:
    _, direction, horizontal, vertical = camera_basis(camera, cfg.width, cfg.height)
    x = safe_normalize(horizontal)
    y = safe_normalize(vertical)
    z = -direction
    wtc = jnp.stack([x, y, z])
    return ig.ShadeContext(
        light_dir=safe_normalize(scene.light.direction),
        wtc=wtc,
        world_lo=scene.volume.world_lo,
        world_hi=scene.volume.world_hi,
        light_alpha=light_alpha,
        **_extra_lights(scene),
    )


def _wants_light_grid(cfg: RenderConfig) -> bool:
    return cfg.shadow_grid and cfg.shading in (ig.SHADING_SHADOW,
                                               ig.SHADING_SSH)


def build_light_grid(scene: Scene, cfg: RenderConfig) -> jnp.ndarray:
    """Shadow-alpha lattice for `render(..., light_grid=...)`.

    Uses the dense light-axis sweep (no gathers; render.lightgrid.
    build_light_grid_swept) when the light direction is concrete — the
    sweep axis is a static choice — and the per-point shadow-march builder
    under a jit trace. Rebuild when the volume, TF, or light changes."""
    import jax.core

    from ovr_tpu.render import lightgrid

    mcfg = ig.MarchConfig(
        max_steps=cfg.max_steps or 1, shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1)
    leaves = (
        _vol_repr(scene.volume), scene.tfn.color, scene.tfn.alpha,
        scene.tfn.value_range, cfg.base_rate * jnp.ones((), cfg.dtype))
    vol = scene.volume
    shape = vol.grid.shape if hasattr(vol, "grid") else (128, 128, 128)
    cap = cfg.shadow_grid_res or min(512, max(128, max(shape) // 4))
    res = lightgrid.default_resolution(shape, cap=cap)
    direction = safe_normalize(scene.light.direction)
    if not isinstance(direction, jax.core.Tracer) and hasattr(vol, "grid"):
        return lightgrid.build_light_grid_swept(
            leaves, direction, vol.world_lo, vol.world_hi, mcfg, res)
    step = jnp.asarray(1.0 / cfg.sampling_rate, cfg.dtype)
    return lightgrid.build_light_grid(
        leaves, direction, vol.world_lo, vol.world_hi, step, mcfg, res)


@partial(jax.jit, static_argnames=("cfg",))
def render(scene: Scene, cfg: RenderConfig, camera: Optional[Camera] = None,
           frame_index: jnp.ndarray = 0, key: Optional[jax.Array] = None,
           macrocells: Optional[accel.MacrocellGrid] = None,
           last_camera: Optional[Camera] = None,
           light_grid: Optional[jnp.ndarray] = None,
           pt_fields=None, proxy_grid=None) -> Frame:
    """Render one frame. Pure, jitted, differentiable (when cfg.fast_math is
    False and cfg.path_tracing is False uses the scan integrator).

    `cfg.max_steps` must be resolved (`cfg.resolved(scene)`).
    `light_grid`: optional precomputed shadow lattice (`build_light_grid`);
    built inline when shadow-grid shading is enabled and none is given
    (prefer passing one — it is camera-independent and reusable).
    """
    assert cfg.max_steps is not None, "call cfg.resolved(scene) first"
    if camera is None:
        camera = scene.camera
    if key is None:
        key = jax.random.PRNGKey(0)
    key = jax.random.fold_in(key, frame_index)

    if cfg.path_tracing:
        if cfg.pt_dense and cfg.sw is not None:
            from ovr_tpu.render import ptdense
            return ptdense.render_frame_dense(scene, cfg, camera,
                                              pt_fields=pt_fields)
        from ovr_tpu.render import pathtracer
        return pathtracer.render_frame(scene, cfg, camera, key, macrocells)

    if cfg.sw is not None:
        if not hasattr(scene.volume, "grid"):
            # neural field -> baked dense proxy (differentiable bake)
            scene = bake_proxy_scene(scene, cfg, grid=proxy_grid)
        if light_grid is None and _wants_light_grid(cfg):
            light_grid = build_light_grid(scene, cfg)
        return _render_shearwarp_frame(scene, cfg, camera, key, last_camera,
                                       light_grid, macrocells)

    screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype)
    screen = screen.reshape(-1, 2)
    n = screen.shape[0]

    if light_grid is None and _wants_light_grid(cfg):
        light_grid = build_light_grid(scene, cfg)
    elif not _wants_light_grid(cfg):
        light_grid = None

    mcfg = ig.MarchConfig(
        max_steps=cfg.max_steps,
        shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1,
        adaptive_scale=cfg.adaptive_scale,
        shading_scale=cfg.shading_scale,
    )
    ctx = _shade_ctx(scene, camera, cfg, light_alpha=light_grid)
    leaves = (
        _vol_repr(scene.volume),
        scene.tfn.color,
        scene.tfn.alpha,
        scene.tfn.value_range,
        cfg.base_rate * jnp.ones((), cfg.dtype),
    )
    # The march step comes from the static config (the reference's
    # set_volume_sampling_rate -> step = 1/rate, volume.cpp:172-179); the
    # scene's volume_sampling_rate is only the scene-file default that
    # Renderer/apps copy into cfg. Using cfg keeps step consistent with
    # cfg.max_steps (both derive from cfg.sampling_rate).
    step = jnp.asarray(1.0 / cfg.sampling_rate, cfg.dtype)
    march_fn = ig.march_while if cfg.fast_math else ig.march

    def ray_batch(sc, tj):
        """Full per-ray pipeline for a batch of screen coords (C, 2)."""
        org, direction = generate_rays(camera, sc, cfg.width, cfg.height)
        # non-volume geometry first; the volume blends over it
        # (shaders_raymarching.cu:283-311)
        if scene.geometries:
            from ovr_tpu.render import geometry as geo
            bg_rgb, bg_a, t_bg = geo.render_geometries(
                scene, org, direction, iso_steps=cfg.iso_steps,
                chunk=cfg.geometry_chunk)
        else:
            t_bg = None
        if scene.instances:
            from ovr_tpu.render import multivol
            color, grad, depth, alpha = multivol.march_instances(
                scene, org, direction, ctx, cfg, mcfg, step)
        else:
            color, grad, depth, alpha = march_fn(
                org, direction, leaves, ctx, mcfg, step,
                occupancy=macrocells if cfg.use_macrocells else None,
                jitter=tj if cfg.jitter_rays else None, t_cap=t_bg)
        if scene.geometries:
            tr = (1.0 - alpha)
            color = color + tr[..., None] * bg_rgb
            depth = depth + tr * bg_a * jnp.minimum(t_bg, 1e30)
            alpha = alpha + tr * bg_a
        if last_camera is not None:
            flow = blended_flow(camera, last_camera, cfg.width, cfg.height,
                                org, direction, depth, alpha)
        else:
            flow = jnp.zeros((sc.shape[0], 2), cfg.dtype)
        color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
        return color, grad, depth, alpha, flow

    def one_sample(s, acc):
        skey = jax.random.fold_in(key, s)
        if cfg.spp > 1:
            jit2 = jax.random.uniform(skey, (n, 2), cfg.dtype) - 0.5
            sc = screen + jit2 / jnp.array(
                [cfg.width, cfg.height], cfg.dtype)
        else:
            sc = screen
        tj = (jax.random.uniform(jax.random.fold_in(skey, 7), (n,), cfg.dtype)
              if cfg.jitter_rays else jnp.zeros((n,), cfg.dtype))
        if cfg.ray_chunk and n > cfg.ray_chunk:
            # chunked march: bounds the working set and lets the fast-math
            # early exit terminate per chunk instead of per frame
            c = cfg.ray_chunk
            k = -(-n // c)
            pad = k * c - n
            sc_p = jnp.pad(sc, ((0, pad), (0, 0)), constant_values=0.5)
            tj_p = jnp.pad(tj, (0, pad))
            outs = jax.lax.map(
                lambda args: ray_batch(*args),
                (sc_p.reshape(k, c, 2), tj_p.reshape(k, c)))
            color, grad, depth, alpha, flow = (
                o.reshape((k * c,) + o.shape[2:])[:n] for o in outs)
        else:
            color, grad, depth, alpha, flow = ray_batch(sc, tj)
        return (acc[0] + color, acc[1] + grad, acc[2] + depth,
                acc[3] + alpha, acc[4] + flow)

    zero = (jnp.zeros((n, 3), cfg.dtype), jnp.zeros((n, 3), cfg.dtype),
            jnp.zeros((n,), cfg.dtype), jnp.zeros((n,), cfg.dtype),
            jnp.zeros((n, 2), cfg.dtype))
    if cfg.spp == 1:
        acc = one_sample(0, zero)
    else:
        acc = jax.lax.fori_loop(0, cfg.spp, one_sample, zero)
    rspp = 1.0 / cfg.spp
    color, grad, depth, alpha, flow = (a * rspp for a in acc)

    rgba = jnp.concatenate([color, alpha[..., None]], axis=-1)
    return Frame(
        rgba=rgba.reshape(cfg.height, cfg.width, 4),
        grad=grad.reshape(cfg.height, cfg.width, 3),
        depth=depth.reshape(cfg.height, cfg.width),
        flow=(flow.reshape(cfg.height, cfg.width, 2)
              if last_camera is not None else None),
    )


def _sw_instances(scene: Scene, cfg: RenderConfig, camera: Camera, off):
    """Per-instance shear-warp + depth-ordered screen compositing: each
    volume (primary + VolumeInstances) renders through its own plan
    (cfg.sw is the plan tuple), then the premultiplied screen partials
    composite in per-pixel order of box-entry distance — the same
    odd-even network as `multivol.march_instances`, at fast-path speed
    (reference surface: `ospray/device_impl.cpp:332-392`)."""
    from ovr_tpu.core.sampling import intersect_box
    from ovr_tpu.render import shearwarp
    from ovr_tpu.render.multivol import _compose, _swap_if

    screen = pixel_screen_coords(cfg.width, cfg.height,
                                 cfg.dtype).reshape(-1, 2)
    org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
    n = org.shape[0]
    vols = [(scene.volume, scene.tfn)] + [
        (i.volume, i.tfn) for i in scene.instances]
    parts = []
    for (vol, tfn_), plan in zip(vols, cfg.sw):
        sv = dataclasses.replace(scene, volume=vol, tfn=tfn_, instances=())
        ci = dataclasses.replace(cfg, sw=plan)
        c, g, d, a = shearwarp.render_shearwarp(sv, ci, camera, jitter=off)
        t0 = jnp.zeros((n,), cfg.dtype)
        t1 = jnp.full((n,), 3.4e38, cfg.dtype)
        t0, t1 = intersect_box(org, direction, vol.world_lo, vol.world_hi,
                               t0, t1)
        t_in = jnp.where(t1 > jnp.maximum(t0, 0.0),
                         jnp.maximum(t0, 0.0), jnp.inf)
        parts.append((c, g, d, a, t_in))
    k = len(parts)
    for p in range(k):
        for i in range(p % 2, k - 1, 2):
            parts[i], parts[i + 1] = _swap_if(parts[i], parts[i + 1])
    out = parts[0]
    for nxt in parts[1:]:
        out = _compose(out, nxt)
    return out[:4]


def _render_shearwarp_frame(scene: Scene, cfg: RenderConfig, camera: Camera,
                            key: jax.Array, last_camera,
                            light_grid=None, macrocells=None) -> Frame:
    """Shear-warp fast path: dense slice-order compositing
    (render.shearwarp). spp > 1 stratifies the sample-plane offset (the
    dense analogue of per-ray t-jitter); jitter_rays randomizes it."""
    from ovr_tpu.render import shearwarp

    def one(s, acc):
        if cfg.jitter_rays:
            off = jax.random.uniform(jax.random.fold_in(key, s), ())
        elif cfg.spp > 1:
            off = (s + 0.5) / cfg.spp  # stratified plane offsets
        else:
            off = None
        if isinstance(cfg.sw, tuple):
            color, grad, depth, alpha = _sw_instances(scene, cfg, camera,
                                                      off)
        else:
            color, grad, depth, alpha = shearwarp.render_shearwarp(
                scene, cfg, camera, jitter=off, light_grid=light_grid,
                macrocells=macrocells)
        return (acc[0] + color, acc[1] + grad, acc[2] + depth,
                acc[3] + alpha)

    n = cfg.width * cfg.height
    zero = (jnp.zeros((n, 3), cfg.dtype), jnp.zeros((n, 3), cfg.dtype),
            jnp.zeros((n,), cfg.dtype), jnp.zeros((n,), cfg.dtype))
    if cfg.spp == 1:
        acc = one(0, zero)
    else:
        acc = jax.lax.fori_loop(0, cfg.spp, one, zero)
    rspp = 1.0 / cfg.spp
    color, grad, depth, alpha = (a * rspp for a in acc)
    if last_camera is not None:
        screen = pixel_screen_coords(cfg.width, cfg.height,
                                     cfg.dtype).reshape(-1, 2)
        org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
        flow = blended_flow(camera, last_camera, cfg.width, cfg.height,
                            org, direction, depth, alpha)
    else:
        flow = None
    color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
    rgba = jnp.concatenate([color, alpha[..., None]], axis=-1)
    return Frame(
        rgba=rgba.reshape(cfg.height, cfg.width, 4),
        grad=grad.reshape(cfg.height, cfg.width, 3),
        depth=depth.reshape(cfg.height, cfg.width),
        flow=(flow.reshape(cfg.height, cfg.width, 2)
              if last_camera is not None else None),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AccumState:
    """Running accumulation sums (all Frame channels) + sum of squared rgba
    for the variance quality metric (the OSPRay accumulation variance,
    `ovr/devices/ospray/device_impl.cpp:795-810`)."""

    rgba: jnp.ndarray
    rgba_sq: jnp.ndarray
    grad: jnp.ndarray
    depth: Any = None
    flow: Any = None


def accumulate(frame: Frame, accum: Optional[AccumState], frame_index
               ) -> tuple[Frame, AccumState]:
    """Progressive accumulation (shaders_raymarching.cu:389-400) over every
    frame channel. `frame_index` is 1-based; returns (display, new_accum)."""
    if accum is None or frame_index <= 1:
        acc = AccumState(
            rgba=frame.rgba, rgba_sq=frame.rgba ** 2, grad=frame.grad,
            depth=frame.depth, flow=frame.flow)
        return frame, acc

    def _add(a, b):
        return None if (a is None or b is None) else a + b

    new = AccumState(
        rgba=accum.rgba + frame.rgba,
        rgba_sq=accum.rgba_sq + frame.rgba ** 2,
        grad=accum.grad + frame.grad,
        depth=_add(accum.depth, frame.depth),
        flow=_add(accum.flow, frame.flow))
    k = frame_index

    def _avg(a):
        return None if a is None else a / k

    disp = Frame(rgba=new.rgba / k, grad=new.grad / k,
                 depth=_avg(new.depth), flow=_avg(new.flow))
    return disp, new


def variance_of(accum: Optional[AccumState], frame_index) -> float:
    """Mean per-pixel unbiased sample variance of accumulated rgba — the
    reference's frame-quality metric (`ospray/device_impl.cpp:795-810`,
    `renderer.h:124-127`). inf until two frames accumulated."""
    k = int(frame_index)
    if accum is None or k < 2:
        return float("inf")
    mean = accum.rgba / k
    var = jnp.maximum(accum.rgba_sq / k - mean ** 2, 0.0) * (k / (k - 1))
    return float(jnp.mean(var))


class Renderer:
    """Stateful facade with the reference's `MainRenderer` surface
    (`ovr/renderer.h:82-288`): setters queue parameter changes, `commit()`
    applies them, `render()` draws a frame, `mapframe()` returns numpy."""

    def __init__(self, scene: Scene, cfg: RenderConfig = RenderConfig()):
        self.scene = scene
        self._cfg = cfg
        self._camera = scene.camera
        self._frame_index = 0
        self._accum: Optional[AccumState] = None
        self._frame: Optional[Frame] = None
        self._macrocells: Optional[accel.MacrocellGrid] = None
        self._light_grid: Optional[jnp.ndarray] = None
        self._pt_fields = None  # ptdense (sigma, J) cache
        self._proxy_grid = None  # baked neural-field proxy cache
        self._sparse = False
        self._focus = None
        self._accumulating = False
        self._dirty = True
        self.render_time = 0.0
        self.variance = float("inf")

    # -- thread-safe-style setters (renderer.h:134-248) --
    def set_fbsize(self, size) -> None:
        w, h = int(size[0]), int(size[1])
        self._cfg = dataclasses.replace(self._cfg, width=w, height=h)
        self._reset()

    def set_camera(self, from_=None, at=None, up=None, camera: Camera = None) -> None:
        if camera is None:
            c = self._camera
            camera = Camera.create(
                from_ if from_ is not None else c.from_,
                at if at is not None else c.at,
                up if up is not None else c.up,
                fovy=c.fovy, height=c.height, kind=c.kind)
        self._camera = camera
        # shear-warp plans depend on the camera (principal axis / slab test)
        self._reset(rejit=self._cfg.method != "march")

    def set_transfer_function(self, color, alpha, value_range) -> None:
        from ovr_tpu.core.scene import TransferFunction
        color = np.asarray(color, np.float32)
        if color.ndim == 1:
            color = color.reshape(-1, 3)
        alpha = np.asarray(alpha, np.float32)
        if alpha.ndim == 2:  # (N, 2) position/value pairs: take values
            alpha = alpha[:, 1]
        tfn = TransferFunction.create(color, alpha, value_range)
        self.scene = dataclasses.replace(self.scene, tfn=tfn)
        self._macrocells = None
        self._light_grid = None
        self._pt_fields = None
        self._reset(rejit=False)

    def set_sample_per_pixel(self, spp: int) -> None:
        self._cfg = dataclasses.replace(self._cfg, spp=int(spp))
        self._reset()

    def set_volume_sampling_rate(self, rate: float) -> None:
        self.scene = dataclasses.replace(
            self.scene, volume_sampling_rate=jnp.float32(rate))
        self._cfg = dataclasses.replace(
            self._cfg, sampling_rate=float(rate), max_steps=None,
            shadow_max_steps=None)
        self._light_grid = None
        self._reset()

    def set_volume_data(self, grid) -> None:
        """Swap the volume's voxel data in place (time-varying sequences,
        `CreateArray3DScalarFromFile` reloads). Same shape means no
        re-jit — the compiled render is reused and only the upload costs;
        issue `jax.device_put(next_grid)` before rendering the current
        frame to overlap the transfer with compute (apps/render_batch
        --sequence does). Macrocells and the shadow lattice rebuild
        lazily at the next commit."""
        vol = dataclasses.replace(self.scene.volume,
                                  grid=jnp.asarray(grid, jnp.float32))
        self.scene = dataclasses.replace(self.scene, volume=vol)
        self._macrocells = None
        self._light_grid = None
        self._pt_fields = None
        self._reset(rejit=False)

    def set_volume_density_scale(self, s: float) -> None:
        self.scene = dataclasses.replace(
            self.scene, density_scale=jnp.float32(s))
        self._pt_fields = None  # sigma scales with density
        self._reset(rejit=False)

    def set_path_tracing(self, enabled: bool) -> None:
        self._cfg = dataclasses.replace(self._cfg, path_tracing=bool(enabled))
        self._reset()

    def set_frame_accumulation(self, enabled: bool) -> None:
        self._accumulating = bool(enabled)
        self._reset(rejit=False)

    def set_shading(self, mode: str) -> None:
        self._cfg = dataclasses.replace(self._cfg, shading=mode)
        self._reset()

    def set_sparse_sampling(self, enabled: bool) -> None:
        self._sparse = bool(enabled)
        self._reset(rejit=False)

    def set_focus(self, center, scale, base_noise) -> None:
        from ovr_tpu.render.sparse import FocusParams
        self._focus = FocusParams.create(center, scale, base_noise)
        self._reset(rejit=False)

    # -- lifecycle --
    def _reset(self, rejit: bool = True) -> None:
        self._frame_index = 0
        self._accum = None
        if rejit:
            self._dirty = True

    def commit(self) -> None:
        if self._dirty:
            self._cfg = dataclasses.replace(
                self._cfg, max_steps=None, shadow_max_steps=None
            ).resolved(self.scene, self._camera)
            self._dirty = False
        if (self._cfg.use_macrocells or self._cfg.path_tracing) and \
                self._macrocells is None:
            vol = self.scene.volume
            if hasattr(vol, "grid"):
                grid = vol.grid
            else:  # neural field: bake a proxy lattice (the vnr macrocell bake)
                from ovr_tpu.neural.train import bake_grid
                r = min(vol.grid_cfg.max_resolution, 256)
                grid = bake_grid(vol, (r, r, r))
            self._macrocells = accel.build_macrocells(
                grid, self.scene.tfn.alpha, self.scene.tfn.value_range)
        if _wants_light_grid(self._cfg) and self._light_grid is None:
            self._light_grid = build_light_grid(self.scene, self._cfg)
        if (self._cfg.path_tracing and self._cfg.pt_dense
                and self._cfg.sw is not None and self._pt_fields is None):
            from ovr_tpu.render import ptdense
            self._pt_fields = ptdense.prepare(self.scene, self._cfg)
        if (self._cfg.sw is not None and self._proxy_grid is None
                and not hasattr(self.scene.volume, "grid")):
            # neural field: amortize the proxy bake across frames (rebaked
            # only when the volume changes, like the shadow lattice);
            # slab-wise host dispatches keep big bakes within runtime
            # execution limits
            from ovr_tpu.neural.train import bake_grid_host
            r = int(self._cfg.neural_proxy_res)
            self._proxy_grid = bake_grid_host(self.scene.volume, (r, r, r))

    def render(self) -> None:
        import time
        self.commit()
        self._frame_index += 1
        t0 = time.perf_counter()
        if self._sparse and not self._cfg.path_tracing:
            from ovr_tpu.render.sparse import render_sparse
            frame, _ = render_sparse(
                self.scene, self._cfg, camera=self._camera,
                focus=self._focus, frame_index=self._frame_index,
                key=jax.random.PRNGKey(self._frame_index),
                prev_frame=self._frame, macrocells=self._macrocells)
        else:
            frame = render(
                self.scene, self._cfg, camera=self._camera,
                frame_index=jnp.int32(self._frame_index),
                macrocells=self._macrocells, light_grid=self._light_grid,
                pt_fields=self._pt_fields, proxy_grid=self._proxy_grid)
        if self._accumulating:
            frame, self._accum = accumulate(frame, self._accum,
                                            self._frame_index)
            self.variance = variance_of(self._accum, self._frame_index)
        jax.block_until_ready(frame.rgba)
        self.render_time += time.perf_counter() - t0
        self._frame = frame

    def lowered(self):
        """The jitted `render` call that `render()` makes, lowered — for
        inspection (`.compile().memory_analysis()`)."""
        self.commit()
        return render.lower(
            self.scene, self._cfg, camera=self._camera,
            frame_index=jnp.int32(max(self._frame_index, 1)),
            macrocells=self._macrocells, light_grid=self._light_grid,
            pt_fields=self._pt_fields, proxy_grid=self._proxy_grid)

    def swap(self) -> None:
        """Double-buffering is a no-op in a functional renderer."""

    def mapframe(self) -> dict[str, np.ndarray]:
        assert self._frame is not None, "render() first"
        out = {
            "rgba": np.asarray(self._frame.rgba),
            "grad": np.asarray(self._frame.grad),
        }
        if self._frame.depth is not None:
            out["depth"] = np.asarray(self._frame.depth)
        if self._frame.flow is not None:
            out["flow"] = np.asarray(self._frame.flow)
        return out
