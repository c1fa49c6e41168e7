"""Weight bridge: JAX-package (flax) params, batch stats and optax Adam
moments -> the port.

A rename only: conv kernels keep their [K, Cin, Cout] layout in the shared
``kernel_offsets`` order, linear kernels [Cin, Cout]; BN ``scale``/``bias``/
``mean``/``var`` map to ``weight``/``bias``/``running_mean``/``running_var``,
Dense kernels stay [Cin, Cout].  Whole trees load strictly: a VoteNet's
``backbone_net.net`` (the Res16UNet), ``vgen.conv1``/``bn1``,
``pnet.vote_aggregation.mlp.layer0``/``bn0``, ``pnet.conv3``, ...
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


def jax_state_dict(params: Mapping, batch_stats: Mapping,
                   dtype=np.float32) -> dict:
    return {
        torch_name(path): torch.from_numpy(np.array(leaf, dtype=dtype))
        for tree in (params, batch_stats)
        for path, leaf in _flatten(tree)
    }


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping, dtype=np.float32) -> torch.nn.Module:
    """Fill ``model`` from the flax trees (strict: every tensor on both sides
    must match by name and shape).  ``dtype=np.float64`` keeps float64 trees
    exact in a model already cast with ``.double()``."""
    model.load_state_dict(jax_state_dict(params, batch_stats, dtype), strict=True)
    return model


def load_optax_adam(opt: torch.optim.Adam, model: torch.nn.Module, mu: Mapping,
                    nu: Mapping, count, dtype=np.float32) -> torch.optim.Adam:
    """Set ``opt``'s per-parameter state from optax's ``ScaleByAdamState``
    (``mu``/``nu`` trees shaped like the params, ``count`` the update
    count), so a torch step and a JAX step start from the same state.
    Strict: every parameter needs both moments, of its shape."""
    params = dict(model.named_parameters())
    mus, nus = jax_state_dict(mu, {}, dtype), jax_state_dict(nu, {}, dtype)
    if set(mus) != set(params) or set(nus) != set(params):
        raise KeyError(f"Adam moments do not cover the parameters: "
                       f"{sorted(set(params) ^ set(mus))}")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    for name, p in params.items():
        if mus[name].shape != p.shape or nus[name].shape != p.shape:
            raise ValueError(f"{name}: moments {tuple(mus[name].shape)} for "
                             f"a parameter {tuple(p.shape)}")
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": mus[name].to(p.device).clone(),
            "exp_avg_sq": nus[name].to(p.device).clone(),
        }
    return opt
