"""Weight bridge: JAX-package (flax) params and batch stats -> the port.

A rename only: conv kernels keep their [K, Cin, Cout] layout in the shared
``kernel_offsets`` order, linear kernels [Cin, Cout]; BN ``scale``/``bias``/
``mean``/``var`` map to ``weight``/``bias``/``running_mean``/``running_var``.
The trees are nested dicts of numpy arrays (``jax.device_get`` of the flax
variables); this module imports no JAX."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# flax auto-names inside a BasicBlock -> the port's submodule names
_MODULE_RENAME = {
    "SparseConv_0": "conv1",
    "MaskedBatchNorm_0": "norm1",
    "SparseConv_1": "conv2",
    "MaskedBatchNorm_1": "norm2",
}
_PARAM_RENAME = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def torch_name(flax_path: tuple) -> str:
    """('block1_0', 'SparseConv_0', 'kernel') -> 'block1_0.conv1.weight'."""
    *mods, leaf = flax_path
    return ".".join([_MODULE_RENAME.get(m, m) for m in mods] + [_PARAM_RENAME[leaf]])


def jax_state_dict(params: Mapping, batch_stats: Mapping) -> dict:
    return {
        torch_name(path): torch.from_numpy(np.array(leaf, dtype=np.float32))
        for tree in (params, batch_stats)
        for path, leaf in _flatten(tree)
    }


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping) -> torch.nn.Module:
    """Fill ``model`` from the flax trees (strict: every tensor on both sides
    must match by name and shape)."""
    model.load_state_dict(jax_state_dict(params, batch_stats), strict=True)
    return model
