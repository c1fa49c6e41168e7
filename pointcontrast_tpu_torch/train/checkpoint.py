"""Lenient transfer loading over state dicts (port of
``pointcontrast_tpu/train/checkpoint.py::lenient_filter``): keep only the
entries whose name AND shape match, as the reference does for pretrain ->
finetune transfer (``downstream/semseg/lib/utils.py:19-76``).  Checkpoints
hold a module's own names (the trainers save the module inside their DDP
wrapper); ``load_module_state_dict`` loads into a model or the module in
its DDP wrapper, and takes a state saved from a wrapper (names under
``module.``) as its module's, so a checkpoint moves between world sizes."""
from __future__ import annotations

from pointcontrast_tpu_torch.parallel.mesh import unwrap

_DDP_PREFIX = "module."


def strip_ddp_prefix(state: dict) -> dict:
    """``state`` with DDP's ``module.`` prefix taken off, when every name
    has it."""
    if state and all(k.startswith(_DDP_PREFIX) for k in state):
        return {k[len(_DDP_PREFIX):]: v for k, v in state.items()}
    return state


def load_module_state_dict(model, state: dict):
    """Load ``state`` (a module's, or a DDP wrapper's) strictly into
    ``model`` or the module in its DDP wrapper."""
    return unwrap(model).load_state_dict(strip_ddp_prefix(state))


def lenient_filter(target: dict, source: dict) -> tuple[dict, list, list]:
    """Copy ``source`` tensors into ``target`` where name and shape match.
    Returns (merged state dict, loaded names, skipped names), the two lists
    in ``target``'s order.  ``source`` may be a DDP wrapper's state."""
    source = strip_ddp_prefix(source)
    merged, loaded, skipped = dict(target), [], []
    for name, value in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            merged[name] = src
            loaded.append(name)
        else:
            skipped.append(name)
    return merged, loaded, skipped
