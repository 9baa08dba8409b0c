"""Config-dict registry of the PyTorch port.

A copy of the ``Registry`` class of motioncraft_tpu/registry.py with the
port's own instances: the JAX package's registries hold its flax classes, and
the port imports nothing of that package.  Configs keep the reference schema
(``dict(type='STMoGenTransformer', ...)``), so the shared ``configs/`` tree
builds either package.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional


class Registry:
    """Name -> constructor map with mmcv-compatible ``build`` semantics."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self.name}, items={sorted(self._module_dict)})"

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Use as ``@REG.register_module()`` or ``REG.register_module(module=cls)``."""
        if module is not None:
            self._register(module, name)
            return module

        def _decorator(cls):
            self._register(cls, name)
            return cls

        return _decorator

    def _register(self, cls: Callable, name: Optional[str]):
        key = name or cls.__name__
        if key in self._module_dict and self._module_dict[key] is not cls:
            raise KeyError(f"{key} already registered in {self.name}")
        self._module_dict[key] = cls

    def build(self, cfg: Optional[dict], **default_kwargs) -> Any:
        """Instantiate from ``dict(type=..., **kwargs)``. None passes through."""
        if cfg is None:
            return None
        if not isinstance(cfg, Mapping):
            raise TypeError(f"cfg must be a mapping, got {type(cfg)}")
        cfg = dict(cfg)
        obj_type = cfg.pop("type")
        if isinstance(obj_type, str):
            if obj_type not in self._module_dict:
                raise KeyError(f"{obj_type} is not registered in {self.name}; "
                               f"known: {sorted(self._module_dict)}")
            obj_cls = self._module_dict[obj_type]
        elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
            obj_cls = obj_type
        else:
            raise TypeError(f"type must be str or class, got {obj_type}")
        for k, v in default_kwargs.items():
            cfg.setdefault(k, v)
        return obj_cls(**cfg)


# One shared registry aliased per role, as in the JAX package.
MODELS = Registry("models")
LOSSES = MODELS
ARCHITECTURES = MODELS
SUBMODULES = MODELS
ATTENTIONS = MODELS

DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
EVALUATORS = Registry("evaluators")


def build_architecture(cfg, **default_kwargs):
    import motioncraft_tpu_torch.models  # noqa: F401  (registers the classes)
    return ARCHITECTURES.build(cfg, **default_kwargs)


def build_submodule(cfg):
    return SUBMODULES.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_dataset(cfg):
    """A dataset from its config; a mixed train set (``base`` and its
    parts) through ``data.build_mixed_dataset``."""
    from motioncraft_tpu_torch.data import build_mixed_dataset  # registers the datasets

    return build_mixed_dataset(cfg) if "base" in cfg else DATASETS.build(cfg)
