"""Offline batch renderer + fps benchmark.

CLI mirror of the reference's `renderbatch` (`apps/main_batch.cpp:44-111`):

    python -m apps.render_batch --scene scene.json [--num-frames N]
        [--fbsize W H] [--spp N] [--pt] [--sampling-rate R] [--exp NAME]
        [--camera fx fy fz ax ay az ux uy uz] [--camera-speed S]
        [--shading none|diffuse|shadow] [--use-macrocells]

Single-frame mode renders 5 warmup + 25 timed frames and prints `fps = ...`
(`main_batch.cpp:278-289`); multi-frame mode flies the same Lissajous orbit
around the point of interest and writes a PNG sequence
(`main_batch.cpp:296-313`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ovr_tpu import api
from ovr_tpu.core.scene import Camera
from ovr_tpu.io.image import save_image
from ovr_tpu.io.vidi3d import create_scene


def parse_args(argv=None):
    p = argparse.ArgumentParser("Batch Renderer")
    p.add_argument("--scene", required=True)
    p.add_argument("--num-frames", type=int, default=1)
    p.add_argument("--fbsize", type=int, nargs=2, default=[1920, 1080])
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--pt", action="store_true", help="path tracing")
    p.add_argument("--sampling-rate", type=float, default=None)
    p.add_argument("--exp", default="frame_", dest="expname")
    p.add_argument("--camera", type=float, nargs=9, default=None,
                   metavar=("FX", "FY", "FZ", "AX", "AY", "AZ", "UX", "UY", "UZ"))
    p.add_argument("--camera-speed", type=float, default=1.0)
    p.add_argument("--shading", default="shadow",
                   choices=["none", "diffuse", "shadow"])
    p.add_argument("--use-macrocells", action="store_true")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--timed", type=int, default=25)
    p.add_argument("--sequence", default=None,
                   help="time-varying volume sequence: %%-pattern "
                        "(vol_%%04d.raw) or glob; dims/shape from the "
                        "scene's volume")
    p.add_argument("--sequence-type", default="FLOAT")
    p.add_argument("--sequence-endian", default="LITTLE",
                   choices=["LITTLE", "BIG"])
    p.add_argument("--sequence-offset", type=int, default=0)
    p.add_argument("--no-save", action="store_true",
                   help="skip PNG writes (pure fps measurement)")
    p.add_argument("--ab", action="store_true",
                   help="A/B oracle harness: render march vs shear-warp "
                        "to EXRs and print PSNR (the reference's disabled "
                        "cross-backend comparison, main_batch.cpp:121-222)")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose output PNG already exists")
    p.add_argument("--method", default="auto",
                   choices=["auto", "march", "shearwarp"],
                   help="integration method (auto: dense shear-warp fast "
                        "path when eligible, else per-ray march)")
    return p.parse_args(argv)


def orbit_camera(camera: Camera, t: float) -> Camera:
    """Lissajous orbit around the poi (`main_batch.cpp:296-313`)."""
    from_ = np.asarray(camera.from_, np.float64)
    poi = np.asarray(camera.at, np.float64)
    up = np.asarray(camera.up, np.float64)
    R = np.linalg.norm(from_ - poi)
    z = (from_ - poi) / max(R, 1e-12)
    x = np.cross(up, z)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    theta = np.sin(13.0 * t) * np.pi
    phi = np.cos(5.0 * t) * np.pi
    r = R * (0.6 + 0.1 * np.sin(6.0 * t))
    local = np.array([
        r * np.cos(phi) * np.sin(theta),
        r * np.sin(phi) * np.sin(theta),
        r * np.cos(theta),
    ])
    c = local[0] * x + local[1] * y + local[2] * z
    return Camera.create(from_=c + poi, at=poi, up=up, fovy=camera.fovy,
                         height=camera.height, kind=camera.kind)


def main(argv=None) -> api.Renderer:
    """Run the CLI; returns the Renderer it drove."""
    import jax

    from ovr_tpu.platform import enable_compile_cache

    enable_compile_cache()
    args = parse_args(argv)
    scene = create_scene(args.scene)
    camera = scene.camera
    if args.camera is not None:
        c = args.camera
        camera = Camera.create(from_=c[0:3], at=c[3:6], up=c[6:9],
                               fovy=camera.fovy)

    rate = args.sampling_rate or float(np.asarray(scene.volume_sampling_rate))
    renderer = api.Renderer(scene, api.RenderConfig(
        width=args.fbsize[0], height=args.fbsize[1], spp=args.spp,
        sampling_rate=rate, shading=args.shading, path_tracing=args.pt,
        use_macrocells=args.use_macrocells or args.pt, fast_math=not args.pt,
        method=args.method,
    ))
    renderer.set_volume_sampling_rate(rate)
    renderer.set_frame_accumulation(True)
    renderer.set_camera(camera=camera)
    renderer.commit()

    if args.ab:
        # A/B comparison oracle: both integrators on the same scene +
        # camera, EXRs for offline inspection, PSNR printed — the working
        # version of the reference's #if 0 harness (OSPRay-vs-OptiX EXR
        # dumps, apps/main_batch.cpp:121-222)
        import dataclasses as _dc

        from ovr_tpu.io.image import save_exr

        outs = {}
        for meth in ("march", "shearwarp"):
            try:
                r2 = api.Renderer(scene, _dc.replace(
                    renderer._cfg, method=meth, sw=None,
                    max_steps=None, shadow_max_steps=None))
                r2.set_camera(camera=camera)
                r2.render()
                outs[meth] = r2.mapframe()["rgba"]
                save_exr(f"{args.expname}{meth}.exr", outs[meth])
            except ValueError as e:
                print(f"{meth}: ineligible ({e})")
        if len(outs) == 2:
            a, b = outs["march"], outs["shearwarp"]
            pm = lambda im: im[..., :3] * im[..., 3:4]
            mse = float(np.mean((pm(a) - pm(b)) ** 2))
            psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
            print(f"psnr = {psnr:.2f} dB  (mse = {mse:.3e})")
        return renderer

    if args.sequence:
        # Time-varying streaming (BASELINE config #3): disk IO of timestep
        # t+1 overlaps the render of t (prefetch thread), and its
        # device_put is issued before t's render dispatch so the HBM
        # upload rides DMA under the compute (double-buffered upload).
        from concurrent.futures import ThreadPoolExecutor

        from ovr_tpu.io.raw import load_raw_volume, sequence_paths

        paths = sequence_paths(args.sequence)
        z, y, x = scene.volume.grid.shape

        def load(p):
            g, _ = load_raw_volume(p, (x, y, z), args.sequence_type,
                                   args.sequence_offset,
                                   args.sequence_endian == "BIG")
            return g

        ex = ThreadPoolExecutor(1)
        dev = jax.device_put(load(paths[0]))
        fut = ex.submit(load, paths[1]) if len(paths) > 1 else None
        t_first = None
        n_done = 0
        for idx in range(len(paths)):
            renderer.set_volume_data(dev)
            if fut is not None:
                dev = jax.device_put(fut.result())
                fut = (ex.submit(load, paths[idx + 2])
                       if idx + 2 < len(paths) else None)
            renderer.render()
            if not args.no_save:
                save_image(f"{args.expname}t{idx:05d}.png",
                           renderer.mapframe()["rgba"])
            if idx == 0:
                t_first = time.perf_counter()  # exclude the jit frame
            else:
                n_done += 1
        if n_done:
            fps = n_done / (time.perf_counter() - t_first)
            print(f"streaming fps = {fps:f}  ({n_done} timesteps)")
        return renderer

    if args.num_frames == 1:
        for _ in range(args.warmup):
            renderer.render()
        t0 = time.perf_counter()
        for _ in range(args.timed):
            renderer.render()
        tot = time.perf_counter() - t0
        print(f"fps = {args.timed / tot:f}")
        rays = args.fbsize[0] * args.fbsize[1] * args.spp * args.timed
        print(f"rays/s = {rays / tot:.3e}")
        out = renderer.mapframe()
        save_image(f"{args.expname}{0:05d}.png", out["rgba"])
    else:
        from ovr_tpu.utils.checkpoint import FrameCheckpointer
        directory, prefix = os.path.split(args.expname)
        ck = FrameCheckpointer(directory, prefix)
        dt = (args.camera_speed * np.pi) / args.num_frames
        for idx in range(args.num_frames):
            t = idx * dt
            if args.resume and ck.done(idx):
                continue
            cam = orbit_camera(camera, t)
            p = np.asarray(cam.from_)
            print(f"camera pos ({p[0]:f},{p[1]:f},{p[2]:f})")
            renderer.set_camera(camera=cam)
            renderer.render()
            out = renderer.mapframe()
            save_image(ck.frame_path(idx), out["rgba"])
            ck.commit(idx, meta={"t": t, "camera": p.tolist()})
    return renderer


if __name__ == "__main__":
    main()
