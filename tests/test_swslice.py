"""Unit tests of the fused slice kernel's wrapper (ops.swslice): fan
padding, the per-block skip schedule, its lowering for the GPU, and the
rule that differentiation runs it without early termination. The kernel
itself runs in the Pallas interpreter here; `-m gpu` runs it compiled."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ovr_tpu import api
from ovr_tpu.core.scene import Camera, simple_scene
from ovr_tpu.ops import swslice
from ovr_tpu.render import accel


def _scene(n=40, ortho=False):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = (0.5 + 0.4 * np.sin(7 * x) * np.cos(6 * y) * np.sin(5 * z)
         ).astype(np.float32)
    scene = simple_scene(g)
    if ortho:
        cam = Camera.create(from_=(0.5, 0.45, -1.5), at=(0.5, 0.5, 0.5),
                            height=1.3, kind="orthographic")
    else:
        cam = Camera.create(from_=(0.6, 0.4, -1.6), at=(0.5, 0.5, 0.5),
                            fovy=40.0)
    return dataclasses.replace(scene, camera=cam)


def _cfg(scene, shading="none", kernel=True, **kw):
    cfg = api.RenderConfig(width=72, height=60, sampling_rate=40.0,
                           shading=shading, method="shearwarp",
                           **kw).resolved(scene)
    if kernel:
        cfg = dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, pallas=True, interpret=True))
    return cfg


@pytest.mark.parametrize("block", [(16, 32), (32, 64)])
def test_ragged_fan_padding_matches_xla(block, monkeypatch):
    """A fan that is not a multiple of the block pads by continuing the
    lattice; pad rays composite nothing and are sliced off."""
    scene = _scene()
    cfg = _cfg(scene, "diffuse", sw_term=False)
    hi, wi = cfg.sw.inter_h, cfg.sw.inter_w
    assert hi % block[0] or wi % block[1], (hi, wi)  # genuinely ragged
    monkeypatch.setattr(swslice, "BLOCK", block)
    # a fresh jit: api.render's cache would reuse another block's compile
    out = jax.jit(api.render.__wrapped__, static_argnames=("cfg",))(
        scene, cfg)
    ref = api.render(scene, _cfg(scene, "diffuse", kernel=False,
                                 sw_term=False))
    # the lateral gradient differences two samples, so sample rounding is
    # amplified by the voxels-per-unit scale (n = 40)
    np.testing.assert_allclose(np.asarray(out.rgba), np.asarray(ref.rgba),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(out.grad), np.asarray(ref.grad),
                               atol=5e-5)


def _brute_active(maj_v, sc, pg_p, qg_p, n_s, dims, block, ortho, sign):
    """Per-(block, slice) activity by enumerating every tap of every ray."""
    n_a, n_r, n_c = dims
    br, bc = block
    S = swslice.S
    sc = np.asarray(sc, np.float64)
    maj = np.asarray(maj_v) > 1.19e-7
    nrb, ncb = qg_p.shape[0] // br, pg_p.shape[0] // bc
    out = np.zeros((nrb * ncb, n_s), bool)
    ma = maj.shape[0]
    for j in range(n_s):
        z_rel = (j + sc[S["off"]]) * sc[S["dz"]]
        lam = z_rel * sc[S["dlam"]] + sc[S["lam0"]]
        c = np.clip((z_rel - sc[S["smp0"]]) * sc[S["smpsc"]] - 0.5, 0,
                    n_a - 1)
        k = int(np.clip(np.floor(c), 0, n_a - 2))
        ks = [k, k + 1]
        if sign < 0:
            ks = [n_a - 1 - kk for kk in ks]
        cells_a = sorted({kk // 16 for kk in ks})
        if sign < 0:
            cells_a = [ma - 1 - a for a in cells_a]
        for ib in range(nrb):
            q = np.asarray(qg_p[ib * br:(ib + 1) * br], np.float64)
            x2 = q + sc[S["dw2"]] * lam if ortho else sc[S["ew2"]] + q * lam
            vr = np.clip((x2 - sc[S["lo2"]]) / sc[S["ex2"]] * n_r - 0.5, 0,
                         n_r - 1)
            r0 = np.minimum(np.floor(vr), n_r - 2).astype(int)
            rows = sorted({r // 16 for r in np.concatenate([r0, r0 + 1])})
            for jb in range(ncb):
                p = np.asarray(pg_p[jb * bc:(jb + 1) * bc], np.float64)
                x1 = (p + sc[S["dw1"]] * lam if ortho
                      else sc[S["ew1"]] + p * lam)
                vc = np.clip((x1 - sc[S["lo1"]]) / sc[S["ex1"]] * n_c - 0.5,
                             0, n_c - 1)
                c0 = np.minimum(np.floor(vc), n_c - 2).astype(int)
                cols = sorted({cc // 16 for cc in np.concatenate([c0, c0 + 1])})
                hit = maj[np.ix_(cells_a, rows, cols)].any()
                out[ib * ncb + jb, j] = hit
    return out


@pytest.mark.parametrize("ortho", [False, True])
def test_active_blocks_cover_every_tap(ortho):
    """The summed-area-table activity is a superset of the brute-force
    per-tap activity, and tight: it only adds the rectangle fill of each
    block's monotone footprint."""
    n = 48
    rng = np.random.default_rng(3)
    ma = n // 16
    maj_v = jnp.asarray((rng.random((ma, ma, ma)) > 0.7).astype(np.float32))
    dims = (n, n, n)
    block = (8, 16)
    pg = jnp.linspace(-0.35, 0.4, 64, dtype=jnp.float32)
    qg = jnp.linspace(-0.3, 0.25, 40, dtype=jnp.float32)
    sc = swslice.pack_scalars(
        jnp.float32, lo1=0.0, ex1=1.0, lo2=0.0, ex2=1.0, ew1=0.55, ew2=0.45,
        dw1=0.05, dw2=-0.04, dz=1.0 / n, off=0.5, lam0=1.1, dlam=1.0,
        smp0=0.0, smpsc=float(n))
    for sign in (1, -1):
        act = np.asarray(swslice.active_blocks(
            maj_v, sc, pg, qg, n, dims, block, 0, ortho, sign))
        ref = _brute_active(maj_v, sc, pg, qg, n, dims, block, ortho, sign)
        assert act.shape == ref.shape
        assert not (ref & ~act).any()  # never skips a slice a tap reads
        assert act.sum() <= ref.sum() * 1.5 + 4


def test_compact_schedule_orders_and_counts():
    """Active indices first and ascending; the tail repeats the last."""
    rng = np.random.default_rng(0)
    active = rng.random((5, 17)) > 0.6
    active[2] = False
    jf, n_act = swslice.compact_schedule(jnp.asarray(active))
    jf, n_act = np.asarray(jf), np.asarray(n_act)
    for row, n, act in zip(jf, n_act, active):
        idx = np.flatnonzero(act)
        assert n == idx.size
        np.testing.assert_array_equal(row[:n], idx)
        if n:
            assert (row[n:] == idx[-1]).all()


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_kernel_lowers_for_cuda(shading):
    """The kernel as compiled for the card (no interpreter) lowers through
    the Pallas Triton route to a Triton custom call, for every mode, with
    skipping and termination on — checked by cross-lowering for CUDA."""
    from jax import export

    scene = _scene(36)
    sc8 = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, grid=jnp.asarray(scene.volume.grid).astype(
            jnp.bfloat16)))
    cfg = _cfg(sc8, shading)
    cfg = dataclasses.replace(
        cfg, sw=dataclasses.replace(cfg.sw, interpret=False))
    mc = accel.build_macrocells(sc8.volume.grid, sc8.tfn.alpha,
                                sc8.tfn.value_range)
    lg = api.build_light_grid(sc8, cfg) if shading == "shadow" else None
    fn = jax.jit(lambda s, m, lgr: api.render(
        s, cfg, macrocells=m, light_grid=lgr).rgba)
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(sc8, mc, lg)
    assert exp.mlir_module().count("__gpu$xla.gpu.triton") == 1


def test_termination_off_under_grad(monkeypatch):
    """Differentiation runs the kernel forward WITHOUT early termination
    (the adjoint rebuilds T_k by dividing out (1 - a_k) from the final
    transmittance), while a plain render runs it with termination."""
    scene = _scene(24)
    cfg = _cfg(scene, "none", sw_term=True)
    seen = []
    real = swslice.slice_composite

    def spy(*a, **kw):
        seen.append(kw["term"])
        return real(*a, **kw)

    monkeypatch.setattr(swslice, "slice_composite", spy)
    render = jax.jit(api.render.__wrapped__, static_argnames=("cfg",))
    render(scene, cfg)
    assert seen == [True]

    def loss(g):
        sc = dataclasses.replace(
            scene, volume=dataclasses.replace(scene.volume, grid=g))
        return jnp.mean(api.render.__wrapped__(sc, cfg).rgba ** 2)

    g = jax.grad(loss)(scene.volume.grid)
    assert seen[1:].count(False) == 1  # the custom-VJP forward rule
    assert np.isfinite(np.asarray(g)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_compiled_kernel_matches_xla_loop(shading):
    """On the card: the compiled kernel (skip + termination on) matches
    the XLA slice loop at full f32 matmul precision."""
    scene = _scene(64)
    cfg = api.RenderConfig(width=160, height=120, sampling_rate=64.0,
                           shading=shading,
                           method="shearwarp").resolved(scene)
    assert cfg.sw.pallas
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    out = api.render(scene, cfg, macrocells=mc)
    with jax.default_matmul_precision("highest"):
        ref = api.render(scene, dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, pallas=False)))
    pm = lambda f: np.asarray(f.rgba)[..., :3] * np.asarray(f.rgba)[..., 3:]
    assert np.abs(pm(out) - pm(ref)).max() < 1e-3
