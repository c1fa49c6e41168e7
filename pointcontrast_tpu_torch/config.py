"""Config system: YAML trees + dotted CLI overrides (copy of
``pointcontrast_tpu/config.py``).

Configs are nested dicts loaded from YAML, accessed as attributes,
overridable with ``group.key=value`` CLI args, and snapshotted to the run
directory for resume (the reference saves config.yaml the same way,
lib/ddp_trainer.py:149).  Needs PyYAML.
"""
from __future__ import annotations

import ast
import os
from typing import Any

import yaml


class Config:
    """Attribute-access view over a nested dict."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str):
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any):
        self._data[name] = Config(value) if isinstance(value, dict) else value

    def __getitem__(self, name):
        return self._data[name]

    def __contains__(self, name):
        return name in self._data

    def get(self, name, default=None):
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self._data.items()
        }

    def override(self, dotted: str, value):
        node = self
        parts = dotted.split(".")
        for p in parts[:-1]:
            if p not in node._data or not isinstance(node._data[p], Config):
                node._data[p] = Config()
            node = node._data[p]
        node._data[parts[-1]] = value

    def __repr__(self):
        return f"Config({self.to_dict()!r})"


def _parse_value(text: str):
    """CLI value parsing: python literal if it parses, else string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        low = text.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none"):
            return None
        return text


def load_config(path: str, overrides: list[str] | None = None) -> Config:
    with open(path) as f:
        cfg = Config(yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        cfg.override(key.strip(), _parse_value(val.strip()))
    return cfg


def save_config(cfg: Config, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def maybe_resume_config(out_dir: str, cfg: Config) -> Config:
    """If ``out_dir/config.yaml`` exists, load it instead (the reference
    resumes the saved snapshot, ddp_train.py:44-51)."""
    snap = os.path.join(out_dir, "config.yaml")
    if os.path.exists(snap):
        return load_config(snap)
    return cfg


def net_dtype(cfg: Config):
    """``net.dtype`` as a torch dtype: float32 (the parity mode) or
    bfloat16 (the shipped YAMLs' mixed precision: bf16 activations, f32
    parameters, norm statistics, losses and, in VoteNet, heads)."""
    import torch

    name = str(cfg.net.get("dtype", "float32"))
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"net.dtype={name}: float32 or bfloat16")
    return getattr(torch, name)
