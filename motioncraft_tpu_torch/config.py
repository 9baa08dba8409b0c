"""Python-file configs with ``_base_`` inheritance and CLI deep-merge.

Mirrors the behaviour of mmcv.Config used throughout the reference
(reference tools/test.py:66-68, configs/**): a config is a python file
whose module-level names become the config dict; ``_base_`` is a list of
relative paths merged (base-first) with dict deep-merge; ``--cfg-options``
key paths like ``model.model.num_layers=8`` override leaves.

A copy of motioncraft_tpu/config.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, List, Optional


class Config(dict):
    """A dict with attribute access and deep-merge construction."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        cfg_dict = _load_py_config(os.path.abspath(filename))
        return cls(Config._wrap(cfg_dict))

    @classmethod
    def fromdict(cls, d: dict) -> "Config":
        return cls(Config._wrap(copy.deepcopy(d)))

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge ``{'a.b.c': v}`` style overrides (mmcv DictAction semantics)."""
        for full_key, value in options.items():
            parts = full_key.split(".")
            node = self
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = Config._wrap(value)

    def dump(self) -> str:
        import json

        def _default(o):
            return repr(o)

        return json.dumps(self, indent=2, default=_default)


def _deep_merge(base: dict, new: dict) -> dict:
    """Merge ``new`` into ``base`` (new wins); dicts merge recursively."""
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict) and not v.pop("_delete_", False):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_py_config(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        src = f.read()
    module = types.ModuleType("_mc_cfg")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    cfg = {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, (types.ModuleType, types.FunctionType, type))
    }
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for rel in bases:
        base_cfg = _load_py_config(os.path.join(os.path.dirname(path), rel))
        merged = _deep_merge(merged, base_cfg)
    return _deep_merge(merged, cfg)


def parse_cfg_option(raw: str) -> Any:
    """Parse a CLI override value: literal if possible, else string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        if raw.lower() in ("true", "false"):
            return raw.lower() == "true"
        return raw


def cfg_options_from_args(pairs: Optional[List[str]]) -> Dict[str, Any]:
    """Turn ``['a.b=1', 'c=d']`` into an override dict."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        out[key.strip()] = parse_cfg_option(raw.strip())
    return out
