"""Work-avoidance + native-dtype tests for the fused slice kernel.

Covers the reference's two defining optimizations as re-expressed in
`ops/swslice.py`: macrocell empty-slice skipping
(`ovr/devices/optix7/accel/spatial_partition.h:56-96`,
`accel/dda.h:30-148`), early ray termination
(`shaders_raymarching.cu:110`), and native normalized-integer volume
residency (`array.h:68-106`). The kernel runs in the Pallas interpreter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ovr_tpu import api
from ovr_tpu.core.scene import Camera, simple_scene
from ovr_tpu.render import accel


def _sparse_scene(n=48):
    """Volume with a small opaque blob in one octant — most slices empty."""
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = np.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2 + (z - 0.6) ** 2) * 120)
    g = g.astype(np.float32)
    scene = simple_scene(g)
    # TF: zero alpha below 0.3 -> empty space is exactly skippable
    alpha = np.concatenate([np.zeros(10, np.float32),
                            np.linspace(0, 0.9, 22, np.float32)])
    tfn = dataclasses.replace(scene.tfn, alpha=jnp.asarray(alpha))
    cam = Camera.create(from_=(0.5, 0.4, -1.5), at=(0.5, 0.5, 0.5),
                        fovy=40.0)
    return dataclasses.replace(scene, tfn=tfn, camera=cam)


def _opaque_scene(n=48):
    """Dense volume + opaque TF: rays saturate early."""
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = (0.5 + 0.4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z)
         ).astype(np.float32)
    scene = simple_scene(g)
    alpha = np.linspace(0.5, 1.0, 16).astype(np.float32)
    tfn = dataclasses.replace(scene.tfn, alpha=jnp.asarray(alpha))
    cam = Camera.create(from_=(0.5, 0.5, -1.4), at=(0.5, 0.5, 0.5),
                        fovy=45.0)
    return dataclasses.replace(scene, tfn=tfn, camera=cam)


def _cfg(scene, shading, **kw):
    cfg = api.RenderConfig(width=72, height=56, sampling_rate=48.0,
                           shading=shading, method="shearwarp",
                           **kw).resolved(scene)
    # force the fused kernel in the Pallas interpreter: resolve_static
    # enables it only on the GPU, and these are KERNEL tests
    if cfg.sw is not None and kw.get("sw_pallas", True):
        cfg = dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, pallas=True, interpret=True))
    return cfg


@pytest.mark.parametrize("camera", ["perspective", "orthographic"])
@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_macrocell_skip_parity(shading, camera):
    """Skipped kernel == unskipped kernel on a mostly-empty volume (the
    majorant bound makes skipping exact), for both fan parameterizations
    (central projection and lateral offsets)."""
    scene = _sparse_scene()
    if camera == "orthographic":
        scene = dataclasses.replace(scene, camera=Camera.create(
            from_=(0.5, 0.4, -1.5), at=(0.5, 0.5, 0.5), height=1.2,
            kind="orthographic"))
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    cfg = _cfg(scene, shading, sw_term=False)
    ref = api.render(scene, cfg)
    out = api.render(scene, cfg, macrocells=mc)
    np.testing.assert_allclose(np.asarray(out.rgba), np.asarray(ref.rgba),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out.grad), np.asarray(ref.grad),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth),
                               atol=2e-4)


def test_skip_actually_skips():
    """The per-block compacted schedules drop most slices of the sparse
    scene, and every block keeps its active slices in ascending order."""
    from ovr_tpu.ops import swslice

    scene = _sparse_scene()
    cfg = _cfg(scene, "none")
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    seen = {}
    real = swslice.compact_schedule

    def spy(active):
        jax.debug.callback(
            lambda a: seen.__setitem__("active", np.asarray(a)), active)
        return real(active)

    swslice.compact_schedule = spy
    try:
        render = jax.jit(api.render.__wrapped__, static_argnames=("cfg",))
        jax.block_until_ready(render(scene, cfg, macrocells=mc).rgba)
        jax.effects_barrier()
    finally:
        swslice.compact_schedule = real
    active = seen["active"]
    assert active.shape[1] == cfg.sw.n_slices
    assert active.mean() < 0.5  # most (block, slice) pairs are skipped
    assert active.any()
    jf, n_act = real(jnp.asarray(active))
    for row, n, act in zip(np.asarray(jf), np.asarray(n_act), active):
        np.testing.assert_array_equal(row[:n], np.flatnonzero(act))


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_early_termination_parity(shading):
    """Early termination changes saturated pixels by <= ~1e-4 (the
    reference's alpha >= 0.9999 exit, shaders_raymarching.cu:110)."""
    scene = _opaque_scene()
    ref = api.render(scene, _cfg(scene, shading, sw_term=False, base_rate=8.0))
    out = api.render(scene, _cfg(scene, shading, sw_term=True, base_rate=8.0))
    np.testing.assert_allclose(np.asarray(out.rgba), np.asarray(ref.rgba),
                               atol=5e-4)
    assert float(out.rgba[..., 3].max()) > 0.999  # scene does saturate


def test_early_termination_with_skip_and_grad_path():
    """term + skip together; and gradients still flow (the fwd rule runs
    without termination, so the adjoint reconstruction stays exact)."""
    scene = _opaque_scene(32)
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    cfg = _cfg(scene, "none", sw_term=True, base_rate=8.0)

    out = api.render(scene, cfg, macrocells=mc)
    ref = api.render(scene, _cfg(scene, "none", sw_term=False, base_rate=8.0))
    np.testing.assert_allclose(np.asarray(out.rgba), np.asarray(ref.rgba),
                               atol=5e-4)

    def loss(g):
        sc = dataclasses.replace(
            scene, volume=dataclasses.replace(scene.volume, grid=g))
        return jnp.mean(api.render(sc, cfg, macrocells=mc).rgba ** 2)

    g1 = jax.grad(loss)(scene.volume.grid)
    # reference gradient: no pallas at all
    cfg2 = _cfg(scene, "none", sw_pallas=False, base_rate=8.0)

    def loss2(g):
        sc = dataclasses.replace(
            scene, volume=dataclasses.replace(scene.volume, grid=g))
        return jnp.mean(api.render(sc, cfg2).rgba ** 2)

    g2 = jax.grad(loss2)(scene.volume.grid)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=2e-5)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "bfloat16"])
def test_native_dtype_residency(dtype):
    """u8/u16/bf16 volumes render through the fused kernel within
    quantization tolerance of the f32 render (`array.h:68-106`)."""
    scene = _opaque_scene(32)
    g32 = np.asarray(scene.volume.grid)
    if dtype == "uint8":
        raw = np.clip(np.round(g32 * 255), 0, 255).astype(np.uint8)
        tol = 1.5 / 255
    elif dtype == "uint16":
        raw = np.clip(np.round(g32 * 65535), 0, 65535).astype(np.uint16)
        tol = 2e-3
    else:
        raw = jnp.asarray(g32).astype(jnp.bfloat16)
        tol = 6e-3
    vol = dataclasses.replace(scene.volume, grid=jnp.asarray(raw))
    sc_n = dataclasses.replace(scene, volume=vol)
    cfg = _cfg(scene, "diffuse", sw_term=False)
    ref = api.render(scene, cfg)
    out = api.render(sc_n, _cfg(sc_n, "diffuse", sw_term=False))
    # color within quantization noise; alpha likewise
    err = np.abs(np.asarray(out.rgba) - np.asarray(ref.rgba)).mean()
    assert err < tol, err


def test_native_dtype_march_matches():
    """The march integrator normalizes native-int grids the same way."""
    scene = _opaque_scene(24)
    g32 = np.asarray(scene.volume.grid)
    raw = np.clip(np.round(g32 * 255), 0, 255).astype(np.uint8)
    vol = dataclasses.replace(scene.volume, grid=jnp.asarray(raw))
    sc_n = dataclasses.replace(scene, volume=vol)
    cfg = api.RenderConfig(width=24, height=20, sampling_rate=24.0,
                           shading="none", method="march").resolved(scene)
    ref = api.render(scene, cfg)
    out = api.render(sc_n, cfg)
    err = np.abs(np.asarray(out.rgba) - np.asarray(ref.rgba)).mean()
    assert err < 1.5 / 255, err


def test_shadow_lattice_cap_scales_with_grid():
    """shadow_grid_res=0 (auto) scales the lattice with the volume:
    clamp(grid/4, 128, 512) per axis (VERDICT r3 Weak #5)."""
    g = np.zeros((600, 8, 8), np.float32)
    scene = simple_scene(g)
    cfg = api.RenderConfig(width=8, height=8, sampling_rate=8.0,
                           shading="shadow", method="march").resolved(scene)
    lg = api.build_light_grid(scene, cfg)
    assert lg.shape[0] == 150  # 600 // 4
    # explicit cap still honored
    cfg2 = dataclasses.replace(cfg, shadow_grid_res=64)
    lg2 = api.build_light_grid(scene, cfg2)
    assert lg2.shape[0] == 64


@pytest.mark.slow
def test_shadow_lattice_vs_march_high_frequency():
    """Lattice-shadow error vs the per-sample shadow march on a
    high-frequency volume + sharp TF (the reference's exact shadow,
    shaders_raymarching.cu:44-85). Pins the quality dial documented in
    PERFORMANCE.md."""
    n = 96
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = (0.5 + 0.45 * np.sin(24 * x) * np.cos(20 * y) * np.sin(16 * z)
         ).astype(np.float32)
    scene = simple_scene(g)
    # sharp TF step: high-frequency opacity
    alpha = np.where(np.linspace(0, 1, 64) > 0.55, 0.8, 0.0
                     ).astype(np.float32)
    scene = dataclasses.replace(
        scene, tfn=dataclasses.replace(scene.tfn, alpha=jnp.asarray(alpha)),
        camera=Camera.create(from_=(0.5, 0.6, -1.6), at=(0.5, 0.5, 0.5),
                             fovy=40.0))
    kw = dict(width=64, height=48, sampling_rate=96.0, shading="shadow",
              method="march", shadow_scale=4.0)
    cfg_lat = api.RenderConfig(shadow_grid=True, **kw).resolved(scene)
    cfg_ref = api.RenderConfig(shadow_grid=False, **kw).resolved(scene)
    lat = api.render(scene, cfg_lat)
    ref = api.render(scene, cfg_ref)
    a = np.asarray(ref.rgba[..., 3])
    m = a > 0.05
    err = np.abs(np.asarray(lat.rgba[..., :3]) - np.asarray(ref.rgba[..., :3]))
    assert err.max(-1)[m].mean() < 0.06, err.max(-1)[m].mean()


@pytest.mark.parametrize("shading", ["diffuse", "shadow"])
def test_fd_gradient_stencil_parity(shading):
    """The fused kernel's voxel forward-difference gradient stencil (the
    reference's, shaders_common.h:195-215) == the XLA loop's, and the XLA
    loop's fan-FD stencil (its big-plane default) stays close."""
    scene = _opaque_scene(48)
    cfg = _cfg(scene, shading, sw_term=False)
    assert cfg.sw.fd_grad is False
    k = api.render(scene, cfg)
    x = api.render(scene, dataclasses.replace(
        cfg, sw=dataclasses.replace(cfg.sw, pallas=False)))
    np.testing.assert_allclose(np.asarray(k.rgba), np.asarray(x.rgba),
                               atol=4e-5)
    np.testing.assert_allclose(np.asarray(k.grad), np.asarray(x.grad),
                               atol=4e-5)
    fd = api.render(scene, dataclasses.replace(
        cfg, sw=dataclasses.replace(cfg.sw, pallas=False, fd_grad=True)))
    d = np.abs(np.asarray(k.rgba) - np.asarray(fd.rgba))
    assert d.mean() < 0.02, d.mean()


def test_fd_gradient_backward_consistent():
    """Shaded gradients through the kernel forward match those through
    the XLA forward (both run the same per-step-recompute adjoint, with
    the voxel stencil the kernel uses)."""
    import dataclasses as dc
    scene = _opaque_scene(32)
    cfg = _cfg(scene, "diffuse", sw_term=False)

    def loss(g, c):
        sc = dc.replace(scene,
                        volume=dc.replace(scene.volume, grid=g))
        return jnp.mean(api.render(sc, c).rgba ** 2)

    g_k = jax.grad(lambda g: loss(g, cfg))(scene.volume.grid)
    cfg_x = dc.replace(cfg, sw=dc.replace(cfg.sw, pallas=False))
    g_x = jax.grad(lambda g: loss(g, cfg_x))(scene.volume.grid)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x), rtol=1e-5,
                               atol=5e-3)
    assert float(np.abs(np.asarray(g_x)).max()) > 0.05  # scale sanity


def test_interior_eye_with_macrocells_parity():
    """Interior (fly-through) eye + macrocell slice-skipping: the trimmed
    plane schedule (slice0_static) and the compacted active-slice
    schedules must agree — skipped == unskipped on the sparse scene."""
    scene = _sparse_scene()
    cam = Camera.create(from_=(0.45, 0.4, 0.25), at=(0.7, 0.3, 0.9),
                        fovy=40.0)
    scene = dataclasses.replace(scene, camera=cam)
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    cfg = _cfg(scene, "diffuse", sw_term=False)
    assert cfg.sw is not None and cfg.sw.slice0_static > 0
    ref = api.render(scene, cfg)
    out = api.render(scene, cfg, macrocells=mc)
    np.testing.assert_allclose(np.asarray(out.rgba), np.asarray(ref.rgba),
                               atol=2e-5)


def test_native_int_shadow_lattice():
    """Shadow shading with a native u8 grid: the swept light-grid builder
    must apply the normalized-integer storage scale before classifying
    (ADVICE r4 high — raw 0..255 values classified against the [0,1]
    value_range produced a completely wrong lattice)."""
    scene = _opaque_scene(32)
    g32 = np.asarray(scene.volume.grid)
    raw = np.clip(np.round(g32 * 255), 0, 255).astype(np.uint8)
    sc8 = dataclasses.replace(
        scene, volume=dataclasses.replace(scene.volume,
                                          grid=jnp.asarray(raw)))
    cfg = _cfg(scene, "shadow", sw_term=False)
    lg_ref = api.build_light_grid(scene, cfg)
    lg_u8 = api.build_light_grid(sc8, _cfg(sc8, "shadow", sw_term=False))
    err_lat = np.abs(np.asarray(lg_u8) - np.asarray(lg_ref)).mean()
    assert err_lat < 2e-2, err_lat
    ref = api.render(scene, cfg, light_grid=lg_ref)
    out = api.render(sc8, _cfg(sc8, "shadow", sw_term=False),
                     light_grid=lg_u8)
    err = np.abs(np.asarray(out.rgba) - np.asarray(ref.rgba)).mean()
    assert err < 1.5 / 255, err
