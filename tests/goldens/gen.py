"""Regenerate the frozen golden fixtures (run from the repo root):

    JAX_PLATFORMS=cpu python tests/goldens/gen.py

Goldens pin the BASELINE.md config classes with synthetic data (no volume
files ship with the repo):

  #1 ortho_march:   orthographic, fixed-step march, none+diffuse shading
  #2 persp_march:   perspective, march, diffuse
  #3 persp_sw:      perspective, shear-warp fast path, diffuse
  #4 tf_grad:       analytic TF-alpha gradient of a masked-render loss,
                    verified against central finite differences at
                    generation time (the north-star gradient gate)

Images are stored as float16 rgba; gradients as float32.
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ovr_tpu import api  # noqa: E402
from ovr_tpu.core.scene import Camera, simple_scene  # noqa: E402

HERE = os.path.dirname(__file__)


def golden_scene(n: int = 48):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = 0.55 + 0.35 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z + 0.7)
    g += 0.1 * np.exp(-((x - 0.4) ** 2 + (y - 0.6) ** 2 + (z - 0.5) ** 2) * 30)
    return simple_scene(np.clip(g, 0.0, 1.0).astype(np.float32))


def cameras():
    ortho = Camera.create(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5),
                          height=1.3, kind="orthographic")
    persp = Camera.create(from_=(0.62, 0.55, -1.7), at=(0.5, 0.5, 0.5),
                          fovy=42.0)
    return ortho, persp


def render(scene, camera, shading, method):
    cfg = api.RenderConfig(width=96, height=80, spp=1, sampling_rate=64.0,
                           shading=shading, method=method).resolved(
        dataclasses.replace(scene, camera=camera), camera)
    f = api.render(scene, cfg, camera=camera)
    return np.asarray(f.rgba), np.asarray(f.depth)


def tf_grad_fixture(scene, camera):
    cfg = api.RenderConfig(width=24, height=24, spp=1, sampling_rate=32.0,
                           shading="none").resolved(scene, camera)

    def loss(alpha):
        sc = dataclasses.replace(
            scene, tfn=dataclasses.replace(scene.tfn, alpha=alpha))
        f = api.render(sc, cfg, camera=camera)
        return jnp.sum(f.rgba[..., :3] ** 2) + jnp.sum(f.rgba[..., 3])

    alpha0 = scene.tfn.alpha
    g = np.asarray(jax.grad(loss)(alpha0))
    # verify vs central finite differences before freezing
    eps = 1e-3
    fd = np.zeros_like(g)
    for i in range(alpha0.shape[0]):
        ap = alpha0.at[i].add(eps)
        am = alpha0.at[i].add(-eps)
        fd[i] = (float(loss(ap)) - float(loss(am))) / (2 * eps)
    scale = np.abs(fd).max() + 1e-9
    err = np.abs(g - fd).max() / scale
    assert err < 5e-3, f"analytic/FD mismatch {err}"
    return g, fd


def main():
    scene = golden_scene()
    ortho, persp = cameras()
    out = {}
    for shading in ("none", "diffuse"):
        rgba, depth = render(scene, ortho, shading, "march")
        out[f"ortho_march_{shading}_rgba"] = rgba.astype(np.float16)
        out[f"ortho_march_{shading}_depth"] = depth.astype(np.float16)
    rgba, depth = render(scene, persp, "diffuse", "march")
    out["persp_march_diffuse_rgba"] = rgba.astype(np.float16)
    rgba, depth = render(scene, persp, "diffuse", "shearwarp")
    out["persp_sw_diffuse_rgba"] = rgba.astype(np.float16)
    g, fd = tf_grad_fixture(scene, persp)
    out["tf_alpha_grad"] = g.astype(np.float32)
    out["tf_alpha_grad_fd"] = fd.astype(np.float32)
    path = os.path.join(HERE, "goldens.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: " + ", ".join(sorted(out)))


if __name__ == "__main__":
    main()
