"""Process groups (port of ``pointcontrast_tpu/parallel/multihost.py``).

JAX runs one controller per host and wires the hosts with
``jax.distributed.initialize``; the port runs one process per device, as
the reference's DDP does (``pretrain/pointcontrast/lib/distributed.py``),
and each process reads its place from the launcher's environment:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` (``torchrun`` and ``parallel/launch.py`` set them), or
``COORDINATOR_ADDRESS`` (``host:port``) as JAX reads it.  Rank r is JAX's
shard r: its loader draws ``DistributedInfSampler`` shard r of
``WORLD_SIZE``.

Besides the device group (NCCL on the card, gloo on the CPU),
``initialize`` opens a gloo group on the host for control flags, so that
polling a Python flag across the ranks never waits on the device.
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_HOST_GROUP = None


def launched() -> bool:
    """Whether a launcher set this process's rank (``RANK`` and
    ``WORLD_SIZE`` in the environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _address() -> tuple[str, str]:
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator and "MASTER_ADDR" not in os.environ:
        host, _, port = coordinator.rpartition(":")
        return host, port
    return os.environ.get("MASTER_ADDR", "127.0.0.1"), os.environ["MASTER_PORT"]


def initialize(device="cuda", backend: str | None = None):
    """Join the process group that the environment describes.  ``device``:
    ``"cuda"`` binds the rank to ``cuda:LOCAL_RANK``; a device with an
    index (``cuda:0``) binds it there (ranks that share a card); ``"cpu"``
    runs on the host.  ``backend``: ``nccl`` on the card and ``gloo`` on the
    CPU unless named; a failure to initialise raises (no fall-back to
    another backend).  Returns (rank, world size, device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local if device.index is None else device.index)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    host, port = _address()
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank, world_size=world)
    global _HOST_GROUP
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    log.info("rank %d of %d on %s (%s)", rank, world, device, backend)
    return rank, world, device


def host_group():
    """The gloo group for control flags (None without a process group)."""
    return _HOST_GROUP if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def shard_info() -> tuple[int, int]:
    """(shard_id, num_shards) for the loaders: (rank, world size), or
    (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
