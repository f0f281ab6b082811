"""Model and scheduler registries (port of `viditq_tpu/models/registry.py`):
a plain dict per kind and `build_module` for config-driven construction."""

from __future__ import annotations

from typing import Any, Callable, Dict

MODELS: Dict[str, Callable] = {}
SCHEDULERS: Dict[str, Callable] = {}


def register(registry: Dict[str, Callable], name: str):
    def deco(fn):
        registry[name] = fn
        return fn
    return deco


def build_module(cfg: Dict[str, Any], registry: Dict[str, Callable]):
    """cfg is a dict with 'type' plus keyword arguments."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in registry:
        raise KeyError(
            f"unknown module type {kind!r}; have {sorted(registry)}")
    return registry[kind](**cfg)
