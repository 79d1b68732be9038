"""Renderer plugin registry.

Replacement for the reference's dlopen plugin loader
(`ovr/common/dylink/Library.h:107-174`, `ObjectFactory.h:36-69`, used by
`create_renderer`, `ovr/renderer.cpp:42-61`): out-of-tree renderer backends
register a factory under a name, and `create_renderer(name)` resolves it —
falling back to importing `ovr_tpu_device_<name>` (the Python analogue of
loading the `device_<name>` shared library) and, when available, to
`importlib.metadata` entry points in the ``ovr_tpu.renderers`` group
(the `OVR_REGISTER_OBJECT` macro analogue, `ObjectFactory.h:77-86`).

A factory is any callable ``(scene, cfg=...) -> renderer`` returning an
object with the `api.Renderer` surface (setters / commit / render /
mapframe).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_renderer(name: str, factory: Callable | None = None):
    """Register a renderer factory; usable as a decorator.

    >>> @register_renderer("myrenderer")
    ... def make(scene, **kw): ...
    """
    if factory is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = factory
    return factory


def available_renderers() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def _ensure_builtins() -> None:
    if "raymarch" in _REGISTRY:
        return

    def _make(scene, cfg=None, **kw):
        from ovr_tpu import api
        c = cfg or api.RenderConfig(**kw)
        return api.Renderer(scene, c)

    def _make_pt(scene, cfg=None, **kw):
        import dataclasses

        from ovr_tpu import api
        c = cfg or api.RenderConfig(**kw)
        c = dataclasses.replace(c, path_tracing=True)
        return api.Renderer(scene, c)

    _REGISTRY.setdefault("raymarch", _make)
    _REGISTRY.setdefault("pathtracer", _make_pt)
    # reference device names map onto the native renderer
    # (renderer.cpp:42-61 accepts "optix7" / "ospray")
    _REGISTRY.setdefault("optix7", _make)
    _REGISTRY.setdefault("ospray", _make)


def create_renderer(name: str, scene, **kw):
    """Resolve `name` to a factory and build a renderer for `scene`.

    Resolution order mirrors `create_renderer` (`renderer.cpp:42-61`):
    built-ins, explicit registrations, the `ovr_tpu_device_<name>` module
    convention, then entry points.
    """
    _ensure_builtins()
    if name in _REGISTRY:
        return _REGISTRY[name](scene, **kw)
    # "load device_<name>" analogue: import a module that registers itself
    try:
        importlib.import_module(f"ovr_tpu_device_{name}")
    except ImportError:
        pass
    if name in _REGISTRY:
        return _REGISTRY[name](scene, **kw)
    try:  # packaged plugins
        from importlib.metadata import entry_points
        for ep in entry_points(group="ovr_tpu.renderers"):
            if ep.name == name:
                _REGISTRY[name] = ep.load()
                return _REGISTRY[name](scene, **kw)
    except Exception:
        pass
    raise KeyError(
        f"unknown renderer {name!r}; available: {available_renderers()}")
