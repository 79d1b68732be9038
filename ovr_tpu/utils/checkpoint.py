"""Checkpoint / resume.

The reference has no persistence beyond scene/TF JSON and saved frames
(SURVEY §5.3-5.4); this framework adds two layers:

- `save_pytree` / `load_pytree` / `latest_step`: training-state snapshots
  via orbax when available, with a dependency-free .npz fallback (flat
  keypath -> array). Used for neural-field fits and distributed train
  states (any pytree of arrays + scalars).
- `FrameCheckpointer`: tile/frame-granular resume for long batch renders —
  a render loop skips work whose output already exists and can atomically
  record per-frame metadata (camera, accumulation index).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import jax
import numpy as np


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        flat[key] = np.asarray(leaf)
    return flat


def save_pytree(directory: str, step: int, tree: Any) -> str:
    """Snapshot `tree` at `step`. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    try:
        import orbax.checkpoint as ocp

        path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
        ckpt = ocp.StandardCheckpointer()
        ckpt.save(path, tree, force=True)
        ckpt.wait_until_finished()
        return path
    except Exception:
        # .npz fallback: flat keypath -> array, atomic rename
        path = os.path.join(directory, f"step_{step:08d}.npz")
        tmp = path + ".tmp.npz"
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
        return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"step_(\d+)(\.npz)?$", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_pytree(directory: str, step: int, like: Any) -> Any:
    """Restore the snapshot at `step` into the structure of `like`."""
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        ckpt = ocp.StandardCheckpointer()
        return ckpt.restore(path, like)
    npz = np.load(path + ".npz")
    leaves_p, treedef = jax.tree_util.tree_flatten_with_path(like)
    leaves = []
    for kp, leaf in leaves_p:
        arr = npz[jax.tree_util.keystr(kp)]
        leaves.append(
            arr.astype(np.asarray(leaf).dtype).reshape(np.shape(leaf)))
    return jax.tree_util.tree_unflatten(treedef, leaves)


class FrameCheckpointer:
    """Frame-granular resume for batch renders.

    >>> ck = FrameCheckpointer("out", "frame_")
    >>> for idx in range(n):
    ...     if ck.done(idx):
    ...         continue
    ...     ...render...
    ...     ck.commit(idx, meta={"t": t})
    """

    def __init__(self, directory: str, prefix: str, ext: str = "png"):
        self.directory = directory or "."
        self.prefix = prefix
        self.ext = ext
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory,
                                       f"{prefix}progress.json")
        self.meta: dict[str, Any] = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def frame_path(self, idx: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}{idx:05d}.{self.ext}")

    def done(self, idx: int) -> bool:
        return os.path.exists(self.frame_path(idx))

    def commit(self, idx: int, meta: Optional[dict] = None) -> None:
        """Record completion metadata (the frame file itself is the
        completion marker; callers write it before commit)."""
        self.meta[str(idx)] = meta or {}
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)
