"""Neural scalar-field volume: hash-grid encoding + MLP head.

The field maps object-space positions p in [0,1]^3 to a scalar sample in
[0,1] (sigmoid head), making it a drop-in replacement for the trilinear grid
sample in the renderer — exactly the architecture of the reference's
abandoned "instant vnr" direction (`ovr/devices/optix7/render/`,
`ovr/common/evaluation_kernel.h`). The same TF classification, opacity
correction and compositing then apply unchanged, and pixel gradients flow to
the hash tables and MLP weights through the standard render path.

MLP layers default to 64 wide; set `compute_dtype` to bfloat16 for
matmul throughput (params stay float32).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ovr_tpu.neural.hashgrid import HashGridConfig, encode, init_hashgrid


@dataclasses.dataclass(frozen=True)
class NeuralFieldVolume:
    """Pytree: hash tables + MLP params + world box (drop-in for
    StructuredVolume in the render fast path)."""

    tables: Any  # (L, T, F)
    weights: Any  # tuple of (W, b) pairs
    world_lo: Any
    world_hi: Any
    data_range: Any  # (2,) like StructuredVolume (sigmoid head -> [0,1])
    grid_cfg: HashGridConfig = HashGridConfig()
    compute_dtype: Any = jnp.float32


jax.tree_util.register_dataclass(
    NeuralFieldVolume,
    data_fields=["tables", "weights", "world_lo", "world_hi", "data_range"],
    meta_fields=["grid_cfg", "compute_dtype"],
)


def init_field(key: jax.Array, grid_cfg: HashGridConfig = HashGridConfig(),
               hidden: int = 64, n_hidden: int = 2,
               compute_dtype=jnp.float32) -> NeuralFieldVolume:
    k_grid, *k_w = jax.random.split(key, n_hidden + 2)
    tables = init_hashgrid(k_grid, grid_cfg)
    dims = [grid_cfg.out_dim] + [hidden] * n_hidden + [1]
    weights = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        scale = (2.0 / din) ** 0.5
        w = scale * jax.random.normal(k_w[i], (din, dout), jnp.float32)
        b = jnp.zeros((dout,), jnp.float32)
        weights.append((w, b))
    return NeuralFieldVolume(
        tables=tables, weights=tuple(weights),
        world_lo=jnp.zeros(3, jnp.float32), world_hi=jnp.ones(3, jnp.float32),
        data_range=jnp.asarray([0.0, 1.0], jnp.float32), grid_cfg=grid_cfg,
        compute_dtype=compute_dtype)


def field_sample(field: NeuralFieldVolume, p: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the field at p (..., 3) in [0,1]^3 -> scalar (...)."""
    h = encode(field.tables, field.grid_cfg, p).astype(field.compute_dtype)
    for i, (w, b) in enumerate(field.weights):
        h = jnp.dot(h, w.astype(field.compute_dtype),
                    preferred_element_type=jnp.float32) + b
        if i + 1 < len(field.weights):
            h = jax.nn.relu(h).astype(field.compute_dtype)
    return jax.nn.sigmoid(h[..., 0].astype(jnp.float32))


def sample_any_volume(volume_repr, p: jnp.ndarray) -> jnp.ndarray:
    """Sample either a dense (Z, Y, X) grid or a NeuralFieldVolume.

    The dispatch is on pytree structure, resolved at trace time — the jitted
    render specializes to the representation with zero runtime cost.
    """
    from ovr_tpu.core.sampling import sample_volume

    if isinstance(volume_repr, NeuralFieldVolume):
        return field_sample(volume_repr, p)
    return sample_volume(volume_repr, p)
