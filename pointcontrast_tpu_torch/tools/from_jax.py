"""Weight bridge: JAX-package (flax) params, batch stats and optax Adam
moments -> the port.

A rename, and one transpose: conv kernels keep their [K, Cin, Cout] layout
in the shared ``kernel_offsets`` order, linear kernels [Cin, Cout]; BN and
instance-norm ``scale``/``bias``/``mean``/``var`` map to ``weight``/``bias``/
``running_mean``/``running_var``, Dense kernels and the CRF filter's
``kernel`` to ``weight``; a Dense kernel [in, out] that lands in a
``torch.nn.Linear`` (the SE layers' FCs) is transposed to its [out, in].
A flax auto-name inside a residual block (``SparseConv_0``,
``MaskedBatchNorm_1``, ``SparseLinear_0``, ...) is renamed by the
``FLAX_NAMES`` of the port's block class found at that path of the model:
``SparseConv_0`` is a BasicBlock's ``conv1`` but a Bottleneck's ``conv2``
(the SE blocks, the ResNets' ``_StridedBlock`` and the ResNet and
MinkUNetHyper top levels go the same way).  Whole trees load strictly: a
VoteNet's
``backbone_net.net`` (the Res16UNet), ``vgen.conv1``/``bn1``,
``pnet.vote_aggregation.mlp.layer0``/``bn0``, a CRF wrapper's ``net`` and
``filter``, the INBN norms' ``inorm``/``bnorm``, ...  The trees are nested
dicts of numpy arrays (``jax.device_get`` of the flax variables); this
module imports no JAX.  A model under ``DistributedDataParallel`` is
filled through its module, by the module's own names (no ``module.``)."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock
from pointcontrast_tpu_torch.parallel.mesh import unwrap

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


def torch_name(flax_path: tuple, model: torch.nn.Module | None = None) -> str:
    """('block1_0', 'SparseConv_0', 'kernel') -> 'block1_0.conv1.weight'.

    With ``model``, each flax module name is renamed by the ``FLAX_NAMES``
    of the port's module it sits in, walking down the model; a path the
    model does not have raises ``KeyError``.  Without one, every module is
    taken for a BasicBlock (the Res16UNet and VoteNet models)."""
    *mods, leaf = flax_path
    names, module = [], model
    for flax_mod in mods:
        table = (BasicBlock.FLAX_NAMES if model is None
                 else getattr(type(module), "FLAX_NAMES", {}))
        names.append(table.get(flax_mod, flax_mod))
        if model is not None:
            module = getattr(module, names[-1], None)
            if not isinstance(module, torch.nn.Module):
                raise KeyError(f"{'/'.join(flax_path)}: the model has no module "
                               f"{'.'.join(names)}")
    return ".".join(names + [_PARAM_RENAME[leaf]])


def _tensor(path: tuple, name: str, leaf, dtype, model) -> torch.Tensor:
    a = np.array(leaf, dtype=dtype)
    if (model is not None and path[-1] == "kernel" and a.ndim == 2
            and isinstance(model.get_submodule(name.rpartition(".")[0]),
                           torch.nn.Linear)):
        a = np.ascontiguousarray(a.T)
    return torch.from_numpy(a)


def jax_state_dict(params: Mapping, batch_stats: Mapping, dtype=np.float32,
                   model: torch.nn.Module | None = None) -> dict:
    model = None if model is None else unwrap(model)
    out = {}
    for tree in (params, batch_stats):
        for path, leaf in _flatten(tree):
            name = torch_name(path, model)
            out[name] = _tensor(path, name, leaf, dtype, model)
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping, dtype=np.float32) -> torch.nn.Module:
    """Fill ``model`` from the flax trees (strict: every tensor on both sides
    must match by name and shape; torch's ``RuntimeError`` names each
    parameter whose shape differs, as a 29-tap ST kernel's does in a
    Tesseract net).  ``dtype=np.float64`` keeps float64 trees exact in a
    model already cast with ``.double()``."""
    unwrap(model).load_state_dict(jax_state_dict(params, batch_stats, dtype, model),
                                  strict=True)
    return model


def load_optax_adam(opt: torch.optim.Adam, model: torch.nn.Module, mu: Mapping,
                    nu: Mapping, count, dtype=np.float32) -> torch.optim.Adam:
    """Set ``opt``'s per-parameter state from optax's ``ScaleByAdamState``
    (``mu``/``nu`` trees shaped like the params, ``count`` the update
    count), so a torch step and a JAX step start from the same state.
    Strict: every parameter needs both moments, of its shape."""
    model = unwrap(model)
    params = dict(model.named_parameters())
    mus = jax_state_dict(mu, {}, dtype, model)
    nus = jax_state_dict(nu, {}, dtype, model)
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
