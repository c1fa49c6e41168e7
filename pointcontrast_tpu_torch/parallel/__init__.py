"""Data parallelism (port of ``pointcontrast_tpu/parallel``): one process
per device under ``torch.distributed``, ``DistributedDataParallel`` with
per-replica batch norm, NCCL on the card and gloo on the CPU.

- ``multihost``: the process group from the launcher's environment, and
  each rank's shard of the data;
- ``mesh``: the DDP wrapper, the mean of metrics over the ranks, rank 0's
  role, and control flags over a host-side gloo group;
- ``launch``: one process per device from a CLI that no launcher started.
"""
