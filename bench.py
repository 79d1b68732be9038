"""Benchmark harness: forward rays/s on the flagship renderer.

Protocol mirrors the reference's fps benchmark (5 warmup + timed window,
`apps/main_batch.cpp:278-289`); the metric is rays/s =
width*height*spp*frames/time on one device, per BASELINE.md.

Runs on an NVIDIA GPU; without one it fails, unless JAX_PLATFORMS=cpu is
given explicitly (a small CPU run for checking the harness itself: set
BENCH_GRID etc. small; BENCH_MESH on the CPU needs
XLA_FLAGS=--xla_force_host_platform_device_count=N).

Prints ONE JSON line: {"metric", "value", "unit", "device"}, where
"device" names the platform, device_kind, device count and the card's
power limit (nvidia-smi), so no number stands without its machine.
"""

import dataclasses
import json
import os
import time

import numpy as np


def build_scene(n: int = 256):
    from ovr_tpu.core.scene import Camera, simple_scene

    # Synthetic multi-frequency volume (no data files ship with the repo).
    if n >= 512:
        # build on device: a host meshgrid at 1024^3 is 3 x 4 GB of RAM
        # plus a 4 GB host-to-device copy; on the device it is milliseconds
        import jax.numpy as jnp
        ax = jnp.linspace(0, 1, n, dtype=jnp.float32)
        x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
        g = 0.5 + 0.35 * jnp.sin(12 * x) * jnp.cos(10 * y) * jnp.sin(8 * z)
        g = g + 0.15 * jnp.exp(
            -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) * 40)
        g = g.astype(jnp.float32)
    else:
        z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                              indexing="ij")
        g = 0.5 + 0.35 * np.sin(12 * x) * np.cos(10 * y) * np.sin(8 * z)
        g += 0.15 * np.exp(
            -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) * 40)
        g = g.astype(np.float32)
    scene = simple_scene(g)
    cam = Camera.create(from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5), fovy=45.0)
    return dataclasses.replace(scene, camera=cam)


def main() -> None:
    import jax

    from ovr_tpu import platform as plat

    plat.measurement_device()
    plat.enable_compile_cache()

    from ovr_tpu import api

    # the headline metric is the BASELINE.json config: rays/s per device
    # at 1080p on a 1024^3 grid (diffuse). Grid data defaults to bfloat16
    # residency at the 1024 scale (the reference renders u8/u16 natively
    # as normalized-int textures, `array.h:68-106`).
    grid_n = int(os.environ.get("BENCH_GRID", 1024))
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    rate = float(os.environ.get("BENCH_RATE", grid_n))
    frames = int(os.environ.get("BENCH_FRAMES", 10 if grid_n >= 512 else 25))
    warmup = int(os.environ.get("BENCH_WARMUP", 3 if grid_n >= 512 else 5))
    shading = os.environ.get("BENCH_SHADING", "diffuse")
    method = os.environ.get("BENCH_METHOD", "auto")
    store = os.environ.get("BENCH_STORE",
                           "bf16" if grid_n >= 512 else "f32")

    scene = build_scene(grid_n)
    if os.environ.get("BENCH_EYE", "") == "inside":
        # fly-through: eye INSIDE the volume
        from ovr_tpu.core.scene import Camera
        cam = Camera.create(from_=(0.5, 0.45, 0.3), at=(0.55, 0.5, 1.6),
                            fovy=45.0)
        scene = dataclasses.replace(scene, camera=cam)
    if os.environ.get("BENCH_OPAQUE", "") == "1":
        # opaque material: rays saturate within a few samples — the
        # reference's early-exit showcase (shaders_raymarching.cu:110).
        # The alpha table alone is not enough: opacity correction at the
        # metric sampling rate (dt ~ 1/1024) turns table-alpha 0.75 into
        # ~0.001/plane, so the base rate must scale too (the table is
        # alpha per base-rate step; an opaque TF means ~saturating alpha
        # per SAMPLE, as in the reference's per-sample classification)
        import jax.numpy as jnp
        tfn = dataclasses.replace(
            scene.tfn, alpha=jnp.linspace(0.6, 1.0, 16))
        scene = dataclasses.replace(scene, tfn=tfn)
        base_rate_v = float(os.environ.get("BENCH_OPAQUE_BASE", rate / 4))
    else:
        base_rate_v = 1.0
    if store != "f32":
        import jax.numpy as jnp
        vol = scene.volume
        if store == "bf16":
            vol = dataclasses.replace(vol, grid=vol.grid.astype(jnp.bfloat16))
        elif store == "u8":
            raw = jnp.clip(jnp.round(vol.grid * 255), 0, 255
                           ).astype(jnp.uint8)
            vol = dataclasses.replace(vol, grid=raw)
        scene = dataclasses.replace(scene, volume=vol)
    n_lights = int(os.environ.get("BENCH_EXTRA_LIGHTS", 0))
    if n_lights:
        from ovr_tpu.core.scene import Light
        lights = tuple(
            Light.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                         intensity=0.5 + 0.1 * i)
            for i in range(n_lights))
        scene = dataclasses.replace(scene, lights=lights)
    # BENCH_NEURAL=fwd|train (BASELINE config #4): hash-grid MLP volume
    # rendered through the baked-proxy shear-warp fast path; "train" runs
    # the full image train step (render + bake + backward to weights)
    neural = os.environ.get("BENCH_NEURAL", "")
    if neural:
        import jax.numpy as jnp
        from ovr_tpu.neural.field import init_field
        field = init_field(jax.random.PRNGKey(0), hidden=64, n_hidden=2)
        scene = dataclasses.replace(scene, volume=field)
    scene = jax.device_put(scene)
    ray_chunk = os.environ.get("BENCH_RAY_CHUNK")
    adaptive = float(os.environ.get("BENCH_ADAPTIVE", 1.0))
    # BENCH_PT: "mc" = delta-tracking tracker (macrocell DDA),
    # "dense" = discrete-ordinates lattice solve + shear-warp gather
    pt = os.environ.get("BENCH_PT", "")
    bf16_mm = os.environ.get("BENCH_BF16", "") == "1"
    term = os.environ.get("BENCH_TERM", "1") == "1"
    skip = os.environ.get("BENCH_SKIP", "1") == "1"
    cfg = api.RenderConfig(
        width=width, height=height, spp=1, sampling_rate=rate,
        base_rate=base_rate_v,
        shading=shading, fast_math=True, use_macrocells=True, method=method,
        ray_chunk=int(ray_chunk) if ray_chunk else None,
        adaptive_scale=adaptive, sw_bf16=bf16_mm, sw_term=term,
        sw_skip=skip,
        path_tracing=bool(pt), pt_dense=(pt == "dense"),
    ).resolved(scene)

    from ovr_tpu.render import accel
    proxy = None
    if neural:
        from ovr_tpu.neural.train import bake_grid_host
        r = int(os.environ.get("BENCH_PROXY", cfg.neural_proxy_res))
        cfg = dataclasses.replace(cfg, neural_proxy_res=r).resolved(scene)
        if cfg.sw is not None:
            proxy = jax.block_until_ready(
                bake_grid_host(scene.volume, (r, r, r)))
        # no proxy baked (e.g. BENCH_METHOD=march): the neural field has
        # no dense grid to partition — render without macrocells
        mc_grid = proxy
    else:
        mc_grid = scene.volume.grid
    if mc_grid is not None:
        mc = accel.build_macrocells(mc_grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        mc = jax.device_put(mc)
    else:
        mc = None

    mesh_spec = os.environ.get("BENCH_MESH", "")  # "TxB", e.g. "4x2"
    backward = os.environ.get("BENCH_BACKWARD", "") == "1"
    if neural == "train":
        # full inverse-rendering step: render the field through the baked
        # proxy, backward to hash tables + MLP weights (BASELINE #4)
        import jax.numpy as jnp
        from ovr_tpu.neural.train import make_image_train_step
        target = jnp.zeros((height, width, 4), jnp.float32)
        step, state = make_image_train_step(scene, cfg, lr=1e-3)

        class Out:
            def __init__(self, x):
                self.rgba = x

        state_box = [state]

        def frame(i, chain):
            cam = dataclasses.replace(scene.camera,
                                      from_=scene.camera.from_ + chain)
            state_box[0], loss = step(state_box[0], cam, target)
            return Out(loss)
    elif mesh_spec:
        # multi-device rendering: image-row bands over `tiles`, Z-slab
        # bricks over `bricks` (ring compositing); runs on however many
        # devices the platform exposes (8 virtual CPU devices in CI)
        t_n, b_n = (int(v) for v in mesh_spec.lower().split("x"))
        from ovr_tpu.parallel import bricks as pbricks
        from ovr_tpu.parallel import mesh as pmesh
        from ovr_tpu.parallel import tiles as ptiles

        m = pmesh.make_mesh(n_tiles=t_n, n_bricks=b_n)
        cfg = dataclasses.replace(
            cfg, sw_slice_align=b_n, max_steps=None,
            shadow_max_steps=None, jitter_rays=False).resolved(scene)
        lgm = (jax.device_put(api.build_light_grid(scene, cfg))
               if api._wants_light_grid(cfg) else None)
        if b_n > 1:
            bv = pbricks.brick_volume(scene.volume, b_n)
            render_fn = jax.jit(lambda s, c: pbricks.render_bricked(
                s, bv, cfg, m, camera=c, light_grid=lgm))
        else:
            render_fn = jax.jit(lambda s, c: ptiles.render_sharded(
                s, cfg, m, camera=c, light_grid=lgm))

        class Out:
            def __init__(self, x):
                self.rgba = x

        def frame(i, chain):
            cam = dataclasses.replace(scene.camera,
                                      from_=scene.camera.from_ + chain)
            return Out(render_fn(scene, cam))
    elif backward:
        # backward rays/s (BASELINE config #4): gradient of a render loss
        # w.r.t. the volume grid + TF opacity through the bounded-memory
        # over-compositing adjoint. BENCH_SHADING selects the mode — the
        # shaded (diffuse/shadow) backward runs the per-step-recompute
        # adjoint too (shearwarp._shaded_loop), so it benches at full
        # resolution without O(n_slices) residuals.
        import dataclasses as _dc

        import jax.numpy as jnp

        lgb = (jax.device_put(api.build_light_grid(scene, cfg))
               if api._wants_light_grid(cfg) else None)

        @jax.jit
        def grad_step(grid, alpha):
            def loss(g, a):
                sc = _dc.replace(
                    scene, volume=_dc.replace(scene.volume, grid=g),
                    tfn=_dc.replace(scene.tfn, alpha=a))
                f = api.render(sc, cfg, light_grid=lgb)
                return jnp.mean(f.rgba ** 2) + jnp.mean(f.grad ** 2)

            return jax.grad(loss, argnums=(0, 1))(grid, alpha)

        def frame(i, chain):
            # keep the chain in the grid's storage dtype: f32 + bf16
            # would promote (and copy) the whole volume to f32
            g = scene.volume.grid + chain.astype(scene.volume.grid.dtype)
            g, a = grad_step(g, scene.tfn.alpha)
            return Out(g.mean() + a.mean())

        class Out:
            def __init__(self, x):
                self.rgba = x
    elif int(os.environ.get("BENCH_TIMEVAR", 0)):
        # time-varying streaming (BASELINE config #3): K host-resident
        # timesteps cycled through device_put; the upload of step t+1 is
        # issued before step t's render so the transfer rides DMA under
        # the compute. Chained through the camera (live operand).
        k_steps = int(os.environ["BENCH_TIMEVAR"])
        ax = np.linspace(0, 1, grid_n, dtype=np.float32)
        x, y, zz = ax[None, None, :], ax[None, :, None], ax[:, None, None]
        host_steps = []
        for k in range(k_steps):
            ph = 2 * np.pi * k / k_steps
            gk = (0.5 + 0.35 * np.sin(12 * x + ph) * np.cos(10 * y)
                  * np.sin(8 * zz - ph)).astype(np.float32)
            if store == "bf16":  # stream in storage dtype: half the
                import ml_dtypes  # host RAM, transfer and HBM residency
                gk = gk.astype(ml_dtypes.bfloat16)
            elif store == "u8":
                gk = np.clip(np.round(gk * 255), 0, 255).astype(np.uint8)
            host_steps.append(gk)
        pending = {0: jax.device_put(host_steps[0])}

        def frame(i, chain):
            # the warmup and timed loops both start at i = 0: fall back
            # to an on-demand upload when the prefetch slot is missing
            cur = pending.pop(i % k_steps, None)
            if cur is None:
                cur = jax.device_put(host_steps[i % k_steps])
            pending[(i + 1) % k_steps] = jax.device_put(
                host_steps[(i + 1) % k_steps])
            sc = dataclasses.replace(
                scene, volume=dataclasses.replace(scene.volume, grid=cur))
            cam = dataclasses.replace(scene.camera,
                                      from_=scene.camera.from_ + chain)
            return api.render(sc, cfg, camera=cam, frame_index=i,
                              macrocells=mc)
    else:
        # shadow lattice / PT scatter fields: camera-independent, built
        # once per commit (Renderer.commit does the same); frames reuse
        lg = (jax.device_put(api.build_light_grid(scene, cfg))
              if api._wants_light_grid(cfg) else None)
        ptf = None
        if cfg.path_tracing and cfg.pt_dense and cfg.sw is not None:
            from ovr_tpu.render import ptdense
            ptf = jax.block_until_ready(ptdense.prepare(scene, cfg))

        def frame(i, chain):
            # Chain each frame on the previous frame's output through a
            # live scene input, so every timed frame depends on the last
            # and no frame's work can be skipped or overlapped away.
            if lg is not None or ptf is not None or proxy is not None:
                cam = dataclasses.replace(
                    scene.camera, from_=scene.camera.from_ + chain)
                return api.render(scene, cfg, camera=cam, frame_index=i,
                                  macrocells=mc, light_grid=lg,
                                  pt_fields=ptf, proxy_grid=proxy)
            tfn = dataclasses.replace(scene.tfn,
                                      alpha=scene.tfn.alpha + chain)
            sc = dataclasses.replace(scene, tfn=tfn)
            return api.render(sc, cfg, frame_index=i, macrocells=mc)

    import jax.numpy as jnp
    chain = jnp.float32(0)
    for i in range(warmup):
        chain = jax.block_until_ready(
            frame(i, chain).rgba).mean().astype(jnp.float32) * 1e-9
    t0 = time.perf_counter()
    for i in range(frames):
        chain = frame(i, chain).rgba.mean().astype(jnp.float32) * 1e-9
    jax.block_until_ready(chain)
    dt = time.perf_counter() - t0

    rays = width * height * cfg.spp * frames
    rays_per_s = rays / dt

    shading = cfg.shading  # the metric names the mode actually rendered
    if neural:
        desc = (f"neural hash-grid MLP via baked {cfg.neural_proxy_res}^3 "
                f"proxy" + (", full train step" if neural == "train" else ""))
    elif pt == "dense":
        desc = "dense discrete-ordinates path tracer + shear-warp gather"
    elif pt:
        desc = "delta-tracking path tracer, macrocell DDA"
    else:
        desc = ("shear-warp compositing" if cfg.sw is not None
                else "march, macrocell skipping")
    kind = "backward" if backward else "forward"
    if backward:
        desc += ", grid+TF grads via bounded-memory adjoint"
    print(json.dumps({
        "metric": f"{kind} rays/s ({grid_n}^3 {store} grid, "
                  f"{width}x{height}, {shading} shading, {desc})",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": plat.device_record(),
    }))


if __name__ == "__main__":
    main()
