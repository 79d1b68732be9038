"""Bring-up check of the renderer on NVIDIA GPUs, at the headline size.

    python chip_smoke.py [--seed N] [--out DIR]     # one card
    python chip_smoke.py --four                      # the four-card phase

One card: a 1024^3 volume generated from --seed (bfloat16 and uint8) is
rendered at 1920x1080 through the normal entry points — `apps.render_batch`
(from a VIDI3D raw + JSON scene written under --out) in the three shading
modes and `api.Renderer` over an orbit — plus an opaque scene (early
termination bites) and a sparse-TF scene (macrocell skipping bites); a few
`jax.grad` steps through `api.render`; the fused slice kernel checked
against the XLA slice loop and the f32 march oracle (both references at
"highest" matmul precision); and kernel vs XLA loop timed in turns.

--four: only the multi-card phase and what it is compared with — the 1024^3
volume rendered on a (1 tile x 4 bricks) and a (4 tiles x 1 brick) mesh
against the one-card frame, and one `parallel.tiles.make_train_step` step on
four cards against one card.

Every phase prints one line; any failure ends the run with a traceback and
a non-zero exit, and no `ok` line. The line before the last is the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the script exits non-zero at the device check.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np

N = 1024  # headline volume edge (BASELINE.json)
W, H = 1920, 1080  # headline screen


def phase(name: str, **info) -> None:
    print(f"phase {name}: " + json.dumps(info, default=_jsonable),
          flush=True)


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return str(x)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="smoke_out",
                   help="directory for the scene files and images")
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_volume(n: int, seed: int):
    """Multi-frequency synthetic volume (bench.build_scene's field with
    seeded frequencies and phases), built on the device: (bf16, u8)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    fr = np.array([12.0, 10.0, 8.0]) + rng.uniform(-2.0, 2.0, 3)
    ph = rng.uniform(0.0, 2.0 * np.pi, 3)
    ctr = 0.5 + rng.uniform(-0.1, 0.1, 3)

    @jax.jit
    def build():
        ax = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
        x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
        g = 0.5 + 0.35 * (jnp.sin(fr[0] * x + ph[0])
                          * jnp.cos(fr[1] * y + ph[1])
                          * jnp.sin(fr[2] * z + ph[2]))
        g = g + 0.15 * jnp.exp(-((x - ctr[0]) ** 2 + (y - ctr[1]) ** 2
                                 + (z - ctr[2]) ** 2) * 40.0)
        g = jnp.clip(g, 0.0, 1.0)
        u8 = jnp.round(g * 255.0).astype(jnp.uint8)
        return g.astype(jnp.bfloat16), u8

    return build()


def make_scene(grid, alpha=None):
    """Scene around `grid` with the bench camera (unit box)."""
    import jax.numpy as jnp

    from ovr_tpu.core.scene import Camera, simple_scene

    scene = simple_scene(np.zeros((2, 2, 2), np.float32), alpha=alpha,
                         value_range=np.array([0.0, 1.0], np.float32))
    vol = dataclasses.replace(
        scene.volume, grid=grid,
        data_range=jnp.asarray([0.0, 1.0], jnp.float32))
    cam = Camera.create(from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5),
                        fovy=45.0)
    return dataclasses.replace(scene, volume=vol, camera=cam)


def write_vidi3d(out_dir: str, grid_u8, n: int) -> str:
    """The u8 volume as a VIDI3D raw file + JSON scene; returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    raw = os.path.join(out_dir, "volume_u8.raw")
    np.asarray(grid_u8).tofile(raw)
    alpha = np.linspace(0.0, 1.0, 64).astype("<f4")
    js = {
        "version": "VIDI3D",
        "dataSource": [{
            "format": "REGULAR_GRID_RAW_BINARY",
            "fileName": "volume_u8.raw",
            "dimensions": {"x": n, "y": n, "z": n},
            "type": "UNSIGNED_BYTE", "offset": 0,
            "endian": "LITTLE_ENDIAN",
        }],
        "view": {
            "camera": {
                "eye": {"x": 0.5 * n, "y": 0.5 * n, "z": -1.6 * n},
                "center": {"x": 0.5 * n, "y": 0.5 * n, "z": 0.5 * n},
                "up": {"x": 0, "y": 1, "z": 0}, "fovy": 45,
            },
            "volume": {
                "sampleDistance": 1.0,
                "scalarMappingRange": {"minimum": 0.0, "maximum": 1.0},
                "transferFunction": {
                    "alphaArray": {
                        "encoding": "BASE64",
                        "data": base64.b64encode(alpha.tobytes()).decode(),
                    },
                    "colorControls": [
                        {"position": 0, "color": {"r": 0, "g": 0.3, "b": 1}},
                        {"position": 1, "color": {"r": 1, "g": 0.5, "b": 0}},
                    ],
                },
            },
            "lightSource": {
                "type": "DIRECTIONAL_LIGHT",
                "position": {"x": 1, "y": 2, "z": 3},
                "diffuse": {"r": 1, "g": 1, "b": 1},
            },
        },
    }
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(js, f)
    return path


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def peak_bytes() -> int:
    """The device's high-water mark of live array bytes so far."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def mem_of(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {"temp": ma.temp_size_in_bytes, "args": ma.argument_size_in_bytes,
            "out": ma.output_size_in_bytes}


def compile_render(scene, cfg, mc=None, lg=None):
    """(run, compiled, compile seconds) of the jitted rgba render."""
    import jax

    from ovr_tpu import api

    fn = jax.jit(lambda s, m, l: api.render(s, cfg, macrocells=m,
                                            light_grid=l).rgba)
    t0 = time.perf_counter()
    comp = fn.lower(scene, mc, lg).compile()
    return (lambda: comp(scene, mc, lg)), comp, time.perf_counter() - t0


def seconds(run, n=3) -> float:
    """Median wall time of `run()` to completion (after one warm call)."""
    import jax

    jax.block_until_ready(run())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def premult(rgba: np.ndarray) -> np.ndarray:
    """(rgb * a, a): what the compositing actually computed."""
    rgba = np.asarray(rgba, np.float64)
    return np.concatenate([rgba[..., :3] * rgba[..., 3:], rgba[..., 3:]], -1)


def psnr(a, b) -> float:
    mse = float(np.mean((premult(a)[..., :3] - premult(b)[..., :3]) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-30)))


def max_abs(a, b) -> float:
    return float(np.abs(premult(a) - premult(b)).max())


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_render_batch(args, grid_u8, smi):
    from apps import render_batch

    path = write_vidi3d(args.out, grid_u8, N)
    for shading in ("none", "diffuse", "shadow"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = render_batch.main([
                "--scene", path, "--fbsize", str(W), str(H),
                "--num-frames", "1", "--sampling-rate", "1",
                "--shading", shading, "--method", "shearwarp",
                "--use-macrocells", "--warmup", "2", "--timed", "3",
                "--exp", os.path.join(args.out, f"render_batch_{shading}_")])
        fps = float(buf.getvalue().split("fps = ")[1].split()[0])
        check(r._cfg.sw is not None and r._cfg.sw.pallas,
              f"render_batch {shading}: fused kernel not selected")
        rgba = r.mapframe()["rgba"]
        check(rgba.shape == (H, W, 4) and np.isfinite(rgba).all(),
              f"render_batch {shading}: bad frame")
        check(rgba[..., 3].max() > 0.1, f"render_batch {shading}: empty")
        phase(f"render_batch_{shading}", frame_ms=1e3 / fps,
              fan=(r._cfg.sw.inter_h, r._cfg.sw.inter_w),
              slices=r._cfg.sw.n_slices,
              memory=mem_of(r.lowered().compile()),
              peak_bytes_in_use=peak_bytes(), card=smi)
    os.remove(os.path.join(args.out, "volume_u8.raw"))


def phase_renderer_orbit(scene, smi):
    from apps.render_batch import orbit_camera
    from ovr_tpu import api

    cfg = api.RenderConfig(width=W, height=H, sampling_rate=float(N),
                           shading="diffuse", method="auto",
                           use_macrocells=True)
    r = api.Renderer(scene, cfg)
    times = []
    for t in (0.15, 0.55, 0.95):
        r.set_camera(camera=orbit_camera(scene.camera, t))
        r.render()  # compile + first frame
        t0 = time.perf_counter()
        r.render()
        times.append(time.perf_counter() - t0)
        rgba = r.mapframe()["rgba"]
        check(np.isfinite(rgba).all() and rgba[..., 3].max() > 0.1,
              f"Renderer pose t={t}: bad frame")
        check(r._cfg.sw is not None and r._cfg.sw.pallas,
              f"Renderer pose t={t}: fused kernel not selected")
    phase("renderer_orbit", frame_ms=[1e3 * x for x in times],
          memory=mem_of(r.lowered().compile()),
          peak_bytes_in_use=peak_bytes(), card=smi)


def phase_opaque_and_sparse(grid, smi):
    from ovr_tpu import api
    from ovr_tpu.render import accel

    # opaque: ~saturating alpha per plane (base rate scaled with the
    # sampling rate, like bench.py's BENCH_OPAQUE)
    opaque = make_scene(grid, alpha=np.linspace(0.6, 1.0, 16))
    # sparse: zero alpha below 3/4 of the value range
    sparse = make_scene(grid, alpha=np.concatenate(
        [np.zeros(12), np.linspace(0.0, 0.9, 4)]))
    for name, scene, knob, base in (("opaque", opaque, "sw_term", N / 4.0),
                                    ("sparse", sparse, "sw_skip", 1.0)):
        mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        outs, times = {}, {}
        for on in (True, False):
            cfg = api.RenderConfig(
                width=W, height=H, sampling_rate=float(N), base_rate=base,
                shading="diffuse", method="shearwarp",
                **{knob: on}).resolved(scene)
            check(cfg.sw.pallas, f"{name}: fused kernel not selected")
            run, comp, _ = compile_render(scene, cfg, mc)
            times[on] = seconds(run)
            outs[on] = np.asarray(run())
        err = max_abs(outs[True], outs[False])
        tol = 1e-3 if name == "opaque" else 1e-5
        check(err <= tol, f"{name}: {knob} changed the frame by {err}")
        check(np.isfinite(outs[True]).all(), f"{name}: non-finite frame")
        phase(name, **{f"frame_ms_{knob}_on": 1e3 * times[True],
                       f"frame_ms_{knob}_off": 1e3 * times[False]},
              max_abs_on_vs_off=err, tolerance=tol, memory=mem_of(comp),
              peak_bytes_in_use=peak_bytes(), card=smi)


def _grad_fn(scene, cfg):
    import jax
    import jax.numpy as jnp

    from ovr_tpu import api

    def loss(g, a):
        sc = dataclasses.replace(
            scene, volume=dataclasses.replace(scene.volume, grid=g),
            tfn=dataclasses.replace(scene.tfn, alpha=a))
        f = api.render(sc, cfg)
        return jnp.mean(f.rgba ** 2) + jnp.mean(f.grad ** 2)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def phase_backward(scene, smi):
    import jax
    import jax.numpy as jnp

    from ovr_tpu import api

    for shading in ("none", "diffuse"):
        cfg = api.RenderConfig(width=W, height=H, sampling_rate=float(N),
                               shading=shading,
                               method="shearwarp").resolved(scene)
        check(cfg.sw.pallas, f"backward {shading}: kernel not selected")
        fn = _grad_fn(scene, cfg)
        g, a = scene.volume.grid, scene.tfn.alpha
        comp = fn.lower(g, a).compile()
        losses, times = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, (dg, da) = jax.block_until_ready(comp(g, a))
            times.append(time.perf_counter() - t0)
            check(bool(jnp.isfinite(dg.astype(jnp.float32)).all())
                  and bool(jnp.isfinite(da).all())
                  and bool(jnp.isfinite(loss)),
                  f"backward {shading}: non-finite gradient")
            check(float(jnp.abs(da).max()) > 0.0,
                  f"backward {shading}: zero TF gradient")
            losses.append(float(loss))
            g = (g.astype(jnp.float32) - 10.0 * dg.astype(jnp.float32)
                 ).astype(g.dtype)
            a = jnp.clip(a - 10.0 * da, 0.0, 1.0)
        phase(f"backward_{shading}", step_ms=[1e3 * t for t in times],
              loss=losses, memory=mem_of(comp),
              peak_bytes_in_use=peak_bytes(), card=smi)


def phase_grad_parity(seed, smi):
    """Kernel-path gradients == XLA-path gradients at 256^3."""
    import jax
    import jax.numpy as jnp

    from ovr_tpu import api

    g_bf, _ = make_volume(256, seed)
    scene = make_scene(g_bf.astype(jnp.float32))
    out = {}
    for shading in ("none", "diffuse"):
        cfg = api.RenderConfig(width=W, height=H, sampling_rate=256.0,
                               shading=shading,
                               method="shearwarp").resolved(scene)
        cfg_x = dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, pallas=False))
        check(cfg.sw.pallas and cfg.sw.fd_grad == cfg_x.sw.fd_grad,
              "grad parity: plans differ in more than the kernel switch")
        with jax.default_matmul_precision("highest"):
            _, (gk, ak) = _grad_fn(scene, cfg)(scene.volume.grid,
                                               scene.tfn.alpha)
            _, (gx, ax) = _grad_fn(scene, cfg_x)(scene.volume.grid,
                                                 scene.tfn.alpha)
        rel_g = float(jnp.abs(gk - gx).max() / jnp.abs(gx).max())
        rel_a = float(jnp.abs(ak - ax).max() / jnp.abs(ax).max())
        check(rel_g <= 1e-3 and rel_a <= 1e-3,
              f"grad parity {shading}: grid {rel_g}, tf alpha {rel_a}")
        out[shading] = {"grid_rel_max_err": rel_g, "alpha_rel_max_err": rel_a}
    phase("grad_parity_256", tolerance=1e-3, **out, card=smi)


def phase_correctness(scene, mc, lg, smi):
    """Kernel vs the XLA slice loop and the f32 march oracle."""
    import jax

    from ovr_tpu import api

    for shading in ("none", "diffuse", "shadow"):
        kw = dict(width=W, height=H, sampling_rate=float(N),
                  shading=shading)
        cfg_k = api.RenderConfig(method="shearwarp", **kw).resolved(scene)
        cfg_x = api.RenderConfig(method="shearwarp", sw_pallas=False,
                                 **kw).resolved(scene)
        cfg_m = api.RenderConfig(method="march", **kw).resolved(scene)
        check(cfg_k.sw.pallas and not cfg_x.sw.pallas, "correctness plans")
        light = lg if shading == "shadow" else None
        with jax.default_matmul_precision("highest"):
            k = np.asarray(compile_render(scene, cfg_k, mc, light)[0]())
            x = np.asarray(compile_render(scene, cfg_x, None, light)[0]())
            m = np.asarray(compile_render(scene, cfg_m, None, light)[0]())
        info = dict(kernel_vs_xla_max_abs=max_abs(k, x),
                    kernel_vs_oracle_psnr=psnr(k, m),
                    xla_vs_oracle_psnr=psnr(x, m),
                    kernel_vs_oracle_max_abs=max_abs(k, m),
                    xla_vs_oracle_max_abs=max_abs(x, m),
                    xla_fd_grad=cfg_x.sw.fd_grad)
        if shading == "none":
            info["tolerance"] = "kernel_vs_xla_max_abs <= 1e-3"
            check(info["kernel_vs_xla_max_abs"] <= 1e-3,
                  f"correctness none: {info}")
        else:
            # "at least as close to the oracle", with 0.01 dB (0.23% of
            # the MSE) for f32 rounding when both run the same stencil
            info["tolerance"] = ("kernel_vs_oracle_psnr >= "
                                 "xla_vs_oracle_psnr - 0.01 dB")
            check(info["kernel_vs_oracle_psnr"]
                  >= info["xla_vs_oracle_psnr"] - 0.01,
                  f"correctness {shading}: {info}")
        phase(f"correctness_{shading}", **info, card=smi)


def phase_kernel_vs_xla(scene, mc, lg, smi):
    """End-to-end frame time, kernel and XLA loop in turns (k, x, x, k)."""
    from ovr_tpu import api

    tf256 = dataclasses.replace(scene, tfn=dataclasses.replace(
        scene.tfn,
        color=np.stack([np.linspace(0, 1, 256), 0.5 * np.ones(256),
                        np.linspace(1, 0, 256)], -1).astype(np.float32),
        alpha=np.linspace(0.0, 1.0, 256).astype(np.float32)))
    cases = (("none", scene), ("diffuse", scene), ("shadow", scene),
             ("diffuse_tf256", tf256))
    for name, sc in cases:
        shading = name.split("_")[0]
        kw = dict(width=W, height=H, sampling_rate=float(N),
                  shading=shading, method="shearwarp")
        light = lg if shading == "shadow" else None
        run_k, comp_k, _ = compile_render(
            sc, api.RenderConfig(**kw).resolved(sc), mc, light)
        run_x, comp_x, _ = compile_render(
            sc, api.RenderConfig(sw_pallas=False, **kw).resolved(sc), mc,
            light)
        t = [seconds(run_k), seconds(run_x), seconds(run_x), seconds(run_k)]
        phase(f"time_{name}", kernel_ms=[1e3 * t[0], 1e3 * t[3]],
              xla_loop_ms=[1e3 * t[1], 1e3 * t[2]],
              kernel_memory=mem_of(comp_k), xla_memory=mem_of(comp_x),
              card=smi)


def run_one(args, smi):
    import jax

    from ovr_tpu import api
    from ovr_tpu.render import accel

    t0 = time.perf_counter()
    grid, grid_u8 = make_volume(N, args.seed)
    jax.block_until_ready(grid)
    scene = make_scene(grid)
    mc = accel.build_macrocells(grid, scene.tfn.alpha, scene.tfn.value_range)
    cfg_s = api.RenderConfig(width=W, height=H, sampling_rate=float(N),
                             shading="shadow").resolved(scene)
    lg = jax.block_until_ready(api.build_light_grid(scene, cfg_s))
    phase("volume", shape=grid.shape, dtypes=[str(grid.dtype),
                                              str(grid_u8.dtype)],
          seed=args.seed, light_grid=lg.shape,
          setup_s=time.perf_counter() - t0, peak_bytes_in_use=peak_bytes())
    phase_render_batch(args, grid_u8, smi)
    del grid_u8
    phase_renderer_orbit(scene, smi)
    phase_opaque_and_sparse(grid, smi)
    phase_backward(scene, smi)
    phase_grad_parity(args.seed, smi)
    phase_correctness(scene, mc, lg, smi)
    phase_kernel_vs_xla(scene, mc, lg, smi)


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------

def run_four(args, smi):
    import jax
    import jax.numpy as jnp

    from ovr_tpu import api
    from ovr_tpu.parallel import bricks
    from ovr_tpu.parallel import mesh as pmesh
    from ovr_tpu.parallel import tiles

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, JAX found {len(devs)}")
    grid, _ = make_volume(N, args.seed)
    scene = make_scene(grid)
    cfg = api.RenderConfig(width=W, height=H, sampling_rate=float(N),
                           shading="diffuse", method="shearwarp",
                           sw_slice_align=4).resolved(scene)
    check(cfg.sw.pallas, "--four: fused kernel not selected")
    f_one = jax.jit(lambda s: api.render(s, cfg).rgba)
    one = np.asarray(f_one(scene))
    a = one[..., 3]
    ys, xs = np.nonzero(a > 0.01)
    inner = np.zeros_like(a, bool)
    inner[ys.min() + 2:ys.max() - 1, xs.min() + 2:xs.max() - 1] = True

    m_b = pmesh.make_mesh(n_tiles=1, n_bricks=4, devices=devs[:4])
    bv = bricks.brick_volume(scene.volume, 4)
    f_b = jax.jit(lambda s, v: bricks.render_bricked(s, v, cfg, m_b))
    t_b = seconds(lambda: f_b(scene, bv))
    got_b = np.asarray(f_b(scene, bv))
    err_b = max_abs(got_b, one)
    check(err_b <= 3e-2, f"bricks 1x4 vs one card: {err_b}")

    m_t = pmesh.make_mesh(n_tiles=4, n_bricks=1, devices=devs[:4])
    f_t = jax.jit(lambda s: tiles.render_sharded(s, cfg, m_t))
    t_t = seconds(lambda: f_t(scene))
    got_t = np.asarray(f_t(scene))
    q95_t = float(np.quantile(
        np.abs(premult(got_t) - premult(one))[..., :3].max(-1)[inner],
        0.95))
    check(q95_t < 0.06, f"tiles 4x1 vs one card: q95 {q95_t}")
    t_one = seconds(lambda: f_one(scene))
    phase("four_render", bricks_1x4_max_abs=err_b, bricks_tolerance=3e-2,
          tiles_4x1_q95_interior=q95_t, tiles_tolerance=0.06,
          frame_ms_one=1e3 * t_one, frame_ms_bricks=1e3 * t_b,
          frame_ms_tiles=1e3 * t_t, card=smi)

    # the train step updates an f32 grid (bf16 would round small steps
    # away); each card's band has its own ray fan, so 4 cards and 1 card
    # solve slightly different discretizations of the same frame
    scene32 = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, grid=scene.volume.grid.astype(jnp.float32)))
    cfg_n = api.RenderConfig(width=W, height=H, sampling_rate=float(N),
                             shading="none",
                             method="shearwarp").resolved(scene32)
    target = jnp.asarray(one * 0.5)
    scene = scene32
    res = {}
    for n in (1, 4):
        m = pmesh.make_mesh(n_tiles=n, n_bricks=1, devices=devs[:n])
        step = tiles.make_train_step(cfg_n, m, lr=1e-2)
        state = tiles.init_train_state(scene)
        new, loss = jax.block_until_ready(
            step(state, scene, scene.camera, target))
        t0 = time.perf_counter()
        jax.block_until_ready(step(state, scene, scene.camera, target))
        # zero momentum in: the new momentum is the psum'd grid gradient
        dg = np.asarray(new.m_grid, np.float64).ravel()
        res[n] = (float(loss), dg, np.asarray(new.tf_alpha),
                  time.perf_counter() - t0)
    l1, d1, a1, s1 = res[1]
    l4, d4, a4, s4 = res[4]
    rel_loss = abs(l4 - l1) / abs(l1)
    cos = float(np.dot(d1, d4) / (np.linalg.norm(d1) * np.linalg.norm(d4)
                                  + 1e-30))
    check(np.isfinite([l1, l4]).all() and rel_loss < 5e-2 and cos > 0.9,
          f"train step 4 vs 1 card: loss {l4} vs {l1}, cos {cos}")
    phase("four_train_step", loss_one=l1, loss_four=l4, rel_loss=rel_loss,
          grid_gradient_cosine=cos,
          tf_alpha_max_abs=float(np.abs(a4 - a1).max()),
          tolerance="rel_loss < 5e-2 and cosine > 0.9",
          step_ms_one=1e3 * s1, step_ms_four=1e3 * s4, card=smi)


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    from ovr_tpu import platform as plat

    dev = plat.require_gpu()
    plat.enable_compile_cache()
    smi = plat.nvidia_smi_line()
    phase("device", platform=dev.platform, kind=dev.device_kind,
          count=len(jax.devices()), nvidia_smi=smi)
    t0 = time.perf_counter()
    if args.four:
        run_four(args, smi)
    else:
        run_one(args, smi)
    phase("done", wall_s=time.perf_counter() - t0)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
