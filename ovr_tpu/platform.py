"""Every choice that depends on the machine the renderer runs on.

- `slice_kernel`: which implementation runs the shear-warp slice loop —
  the fused Pallas kernel on the Triton route on an NVIDIA GPU, the XLA
  slice loop on the CPU. Any other platform is an error: there is no
  default.
- `require_gpu` / `measurement_device`: the device checks of the on-card
  scripts (`bench.py` also accepts an explicit `JAX_PLATFORMS=cpu`);
  `nvidia_smi_line` / `device_record`: the card's name and power limit,
  printed beside every number those scripts report.
- `enable_compile_cache`: JAX's persistent compilation cache. When
  `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and nothing is set
  here; otherwise the cache lives in `.jax_cache/` at the root of the
  checkout (a fixed path, so later processes hit it).
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

_KERNELS = {"gpu": "triton", "cpu": "xla"}


def slice_kernel(platform: str | None = None) -> str:
    """'triton' (fused Pallas kernel) on 'gpu', 'xla' (slice loop) on
    'cpu'; raises ValueError for any other platform."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _KERNELS[platform]
    except KeyError:
        raise ValueError(
            f"no shear-warp slice loop for platform {platform!r} "
            f"(known: {sorted(_KERNELS)})") from None


def require_gpu():
    """The first device, which must be an NVIDIA GPU; raises otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def measurement_device():
    """The device a benchmark measures: the GPU, or the CPU when
    `JAX_PLATFORMS=cpu` was given explicitly (a harness check whose numbers
    say "cpu"); raises otherwise."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return jax.devices()[0]
    return require_gpu()


def nvidia_smi_line() -> str:
    """`name, power.limit` of the first card as nvidia-smi prints them,
    read by a child process that never imports JAX; "not available" when
    there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not available"


def device_record() -> dict:
    """The machine a measurement ran on, as JAX and nvidia-smi see it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": (nvidia_smi_line() if dev.platform == "gpu"
                           else "not available")}


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env  # JAX reads the variable itself
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
