"""The data-parallel step (port of ``pointcontrast_tpu/parallel/mesh.py``).

JAX lifts a one-device step over a mesh with ``shard_map``; the port runs
the same step in every rank's process and lets ``DistributedDataParallel``
average the gradients in its backward hooks.  The JAX names map so:

- ``make_mesh(n)``, ``replicate``, ``shard_batch``: one process per device
  (``parallel/launch.py`` or ``torchrun``), DDP's broadcast of rank 0's
  parameters at construction, and each rank's own loader shard
  (``multihost.shard_info``);
- ``data_parallel_step(step_fn, mesh)``: ``data_parallel(model)``, the
  model under DDP with ``broadcast_buffers=False``, so that batch norm
  stays per replica (JAX ``mesh.py:8-13``, the reference's
  ``ddp_trainer.py:101``); a checkpoint holds rank 0's copy;
- ``pmean_if_parallel(metrics, axis)``: ``mean_over_ranks(metrics)``.

``is_main`` picks rank 0's work (checkpoints, logs, validation);
``any_rank`` and ``host_barrier`` run on the host-side gloo group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from pointcontrast_tpu_torch.parallel import multihost


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def data_parallel(model: torch.nn.Module, find_unused_parameters: bool = False):
    """``model`` under DDP when a process group exists (at any world size),
    else ``model`` itself.  The inputs are not moved: each rank's batches
    are on its device already."""
    if not dist.is_initialized():
        return model
    return DistributedDataParallel(model, broadcast_buffers=False,
                                   find_unused_parameters=find_unused_parameters)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (what a checkpoint holds)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def mean_over_ranks(metrics: dict) -> dict:
    """The mean of each scalar of ``metrics`` over the ranks, in one
    all-reduce on the device of its first tensor; ``metrics`` itself
    without a process group.  Every rank must call it at the same step."""
    if world_size() == 1:
        return metrics
    device = next((v.device for v in metrics.values() if torch.is_tensor(v)),
                  torch.device("cpu"))
    stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
                           for v in metrics.values()])
    dist.all_reduce(stacked)
    return dict(zip(metrics, (stacked / world_size()).unbind()))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank: a MAX over the host group, on
    the CPU (no device sync).  Every rank must call it at the same step."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=multihost.host_group())
    return bool(t.item())


def host_barrier() -> None:
    """Wait on the host group for every rank (a no-op on one)."""
    if world_size() > 1:
        dist.barrier(group=multihost.host_group())
