"""ovr_tpu — a differentiable scientific volume renderer in JAX.

A brand-new JAX/XLA/Pallas framework with the capability surface of
VIDILabs/open-volume-renderer (structured-grid direct volume rendering through
1D transfer functions, via front-to-back emission-absorption ray marching and
delta-tracking volumetric path tracing), redesigned around JAX:

- scenes, volumes and transfer functions are JAX PyTrees (`ovr_tpu.core`),
- rendering is a pure function `render(scene, camera, cfg) -> Frame` that jits,
  shards and differentiates (`ovr_tpu.render`, `ovr_tpu.api`),
- the hot slice loop is a fused Pallas kernel (Triton route, NVIDIA GPUs)
  with a custom VJP through a bounded-memory XLA adjoint (`ovr_tpu.ops`),
- multi-chip/multi-host scaling uses `jax.sharding.Mesh` + `shard_map` with
  image-tile data parallelism and ring partial-compositing for bricked volumes
  (`ovr_tpu.parallel`),
- neural-field volumes (hash-grid MLP) realize the reference's planned
  neural path (`ovr_tpu.neural`).

Unlike the reference (forward-only CUDA/OptiX/OSPRay), every render path here
is differentiable end-to-end: pixel gradients flow to the density grid, the
transfer-function tables, the camera, and network weights.
"""

__version__ = "0.1.0"

from ovr_tpu.core.scene import (  # noqa: F401
    Camera,
    Light,
    Scene,
    StructuredVolume,
    TransferFunction,
)
from ovr_tpu.api import Renderer, RenderConfig, Frame  # noqa: F401
from ovr_tpu.api import render as render_frame  # noqa: F401

# NOTE: the api.render function is exported as `render_frame`, NOT `render` —
# binding it to `render` would shadow the ovr_tpu.render subpackage and break
# `import ovr_tpu.render.integrator` in fresh processes.
from ovr_tpu import render  # noqa: F401,E402  (rebind name to the subpackage)
