"""Foveated sparse sampling: probability mask + fixed-budget compaction.

The reference builds a per-pixel keep probability
    p = (1 - base) * exp(-0.5 * r^2 / sigma^2) + base
around a focus center (`ovr/common/generate_mask.cu:55-84`), draws a noise
value per pixel (spatio-temporal blue noise or uniform), keeps pixels with
noise < p, stream-compacts the (x, y) list with thrust, and launches exactly
that many OptiX threads (`device_impl.cpp:304-342`).

Reformulation with static shapes: rank pixels by noise/p and take
a fixed budget of the best-ranked — the same spatial distribution with a
deterministic launch size (XLA requires static shapes; a variable-length
compaction would recompile every frame). Rendered samples are scattered back
into the previous frame's buffer, which is what the reference's accumulation
loop does implicitly by only overwriting sampled pixels.

Blue noise: the reference tiles a 128x128x64 STBN volume by frame index
(`random/blue_noise.h`). We generate a true blue-noise threshold matrix with
void-and-cluster and derive the temporal dimension from R2 toroidal shifts
(render.bluenoise — no binary blobs in-repo); `noise="uniform"` matches the
reference's alternative path (`generate_mask.h:8-10`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

STBN_SIZE = 128
STBN_FRAMES = 64


@dataclasses.dataclass(frozen=True)
class FocusParams:
    """Dynamic sparse-sampling parameters (renderer.h set_focus)."""

    center: Any  # (2,) in [0,1]^2
    scale: Any  # () gaussian sigma
    base_noise: Any  # () background keep probability

    @staticmethod
    def create(center=(0.5, 0.5), scale=0.2, base_noise=0.1) -> "FocusParams":
        return FocusParams(
            center=jnp.asarray(center, jnp.float32),
            scale=jnp.asarray(scale, jnp.float32),
            base_noise=jnp.asarray(base_noise, jnp.float32))


jax.tree_util.register_dataclass(
    FocusParams, data_fields=["center", "scale", "base_noise"], meta_fields=[])


def keep_probability(width: int, height: int, focus: FocusParams
                     ) -> jnp.ndarray:
    """Per-pixel keep probability (generate_mask.cu:66-76), shape (H, W)."""
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    sx, sy = jnp.meshgrid(xs, ys, indexing="xy")
    r2 = (sx - focus.center[0]) ** 2 + (sy - focus.center[1]) ** 2
    sigma2 = focus.scale * focus.scale
    return ((1.0 - focus.base_noise)
            * jnp.exp(-0.5 * r2 / jnp.maximum(sigma2, 1e-12))
            + focus.base_noise)


_BN_BASE = None


def _blue_noise_base() -> jnp.ndarray:
    """Lazily built (and disk-cached) void-and-cluster threshold matrix."""
    global _BN_BASE
    if _BN_BASE is None:
        from ovr_tpu.render.bluenoise import void_and_cluster
        _BN_BASE = jnp.asarray(void_and_cluster(STBN_SIZE))
    return _BN_BASE


def _stbn_tile(frame_index) -> jnp.ndarray:
    """Frame slice of the spatio-temporal stack: the spatial blue-noise
    pattern toroidally shifted along the R2 low-discrepancy sequence
    (render.bluenoise). Traced-safe in frame_index."""
    from ovr_tpu.render.bluenoise import _R2
    base = _blue_noise_base()
    f = jnp.asarray(frame_index, jnp.float32) % STBN_FRAMES
    ox = jnp.floor((f * _R2[0]) % 1.0 * STBN_SIZE).astype(jnp.int32)
    oy = jnp.floor((f * _R2[1]) % 1.0 * STBN_SIZE).astype(jnp.int32)
    return jnp.roll(base, (oy, ox), axis=(0, 1))


def sample_noise(key: jax.Array, width: int, height: int, frame_index,
                 noise: str = "stbn") -> jnp.ndarray:
    """(H, W) noise in [0,1): tiled spatio-temporal blue noise, or per-pixel
    'uniform' (the reference's alternate path, generate_mask.h:8-10)."""
    if noise == "uniform":
        return jax.random.uniform(jax.random.fold_in(key, frame_index),
                                  (height, width), jnp.float32)
    tile = _stbn_tile(frame_index)
    ty = jnp.arange(height) % STBN_SIZE
    tx = jnp.arange(width) % STBN_SIZE
    return tile[ty[:, None], tx[None, :]]


def select_samples(key: jax.Array, width: int, height: int,
                   focus: FocusParams, frame_index, budget: int,
                   noise: str = "stbn") -> jnp.ndarray:
    """Pick `budget` pixel indices (flat, y*W+x) ranked by noise/p.

    Static output shape; the analogue of the thrust compaction that returns
    the (x, y) list (`generate_and_compact_coordinates`,
    generate_mask.cu:86-96).
    """
    p = keep_probability(width, height, focus)
    n = sample_noise(key, width, height, frame_index, noise)
    score = n / jnp.maximum(p, 1e-12)
    _, idx = jax.lax.top_k(-score.reshape(-1), budget)
    return idx


def scatter_to_frame(prev_rgba: jnp.ndarray, idx: jnp.ndarray,
                     rgba: jnp.ndarray) -> jnp.ndarray:
    """Write sparse results (B, 4) at flat indices into the previous frame
    (H, W, 4)."""
    h, w, c = prev_rgba.shape
    flat = prev_rgba.reshape(-1, c)
    return flat.at[idx].set(rgba).reshape(h, w, c)


def render_sparse(scene, cfg, camera=None, focus: Optional[FocusParams] = None,
                  frame_index=0, key=None, prev_frame=None, budget=None,
                  macrocells=None, noise: str = "stbn"):
    """Sparse-sampled ray-march frame: renders `budget` rays, scatters them
    into `prev_frame` (or black). Returns (Frame, flat sample indices)."""
    from ovr_tpu import api
    from ovr_tpu.render import integrator as ig
    from ovr_tpu.render.camera import generate_rays

    assert cfg.max_steps is not None, "call cfg.resolved(scene) first"
    if camera is None:
        camera = scene.camera
    if key is None:
        key = jax.random.PRNGKey(0)
    if focus is None:
        focus = FocusParams.create()
    if budget is None:
        budget = max(cfg.width * cfg.height // 8, 1)

    idx = select_samples(key, cfg.width, cfg.height, focus, frame_index,
                         budget, noise)
    ix = (idx % cfg.width).astype(cfg.dtype)
    iy = (idx // cfg.width).astype(cfg.dtype)
    screen = jnp.stack([(ix + 0.5) / cfg.width, (iy + 0.5) / cfg.height], -1)

    org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
    ctx = api._shade_ctx(scene, camera, cfg)
    leaves = (api._vol_repr(scene.volume), scene.tfn.color, scene.tfn.alpha,
              scene.tfn.value_range, cfg.base_rate * jnp.ones((), cfg.dtype))
    mcfg = ig.MarchConfig(
        max_steps=cfg.max_steps, shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1)
    step = jnp.asarray(1.0 / cfg.sampling_rate, cfg.dtype)
    march_fn = ig.march_while if cfg.fast_math else ig.march
    color, grad, depth, alpha = march_fn(
        org, direction, leaves, ctx, mcfg, step,
        occupancy=macrocells if cfg.use_macrocells else None)
    color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
    rgba = jnp.concatenate([color, alpha[:, None]], -1)

    if prev_frame is None:
        prev_rgba = jnp.zeros((cfg.height, cfg.width, 4), cfg.dtype)
        prev_grad = jnp.zeros((cfg.height, cfg.width, 3), cfg.dtype)
        prev_depth = jnp.zeros((cfg.height, cfg.width), cfg.dtype)
    else:
        prev_rgba, prev_grad = prev_frame.rgba, prev_frame.grad
        prev_depth = (prev_frame.depth if prev_frame.depth is not None
                      else jnp.zeros((cfg.height, cfg.width), cfg.dtype))
    out_rgba = scatter_to_frame(prev_rgba, idx, rgba)
    out_grad = scatter_to_frame(prev_grad, idx, grad)
    out_depth = scatter_to_frame(prev_depth[..., None], idx,
                                 depth[:, None])[..., 0]
    return api.Frame(rgba=out_rgba, grad=out_grad, depth=out_depth), idx
