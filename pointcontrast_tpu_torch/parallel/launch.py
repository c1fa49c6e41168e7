"""One process per device, for a CLI that no launcher started.

``python -m pointcontrast_tpu_torch.apps.pretrain distributed.num_devices=N``
(or ``0``: every visible card) spawns N ranks here, each with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (a free
port on this host) set as ``torchrun --nproc_per_node N`` sets them; under
``torchrun`` the CLIs take its environment and never come here.  On the
card the kernels are built once, here, before the ranks start, so that N
ranks do not each run ``nvcc``.  An exception in any rank ends the others
and fails the launch with that rank's traceback; ranks that all exit
requeueable (``utils.preemption.REQUEUE_EXIT_CODE``) exit so here too.
"""
from __future__ import annotations

import contextlib
import multiprocessing.connection
import os
import pickle
import shutil
import signal
import socket
import tempfile
import threading
import time
import traceback

import torch

from pointcontrast_tpu_torch.parallel import multihost
from pointcontrast_tpu_torch.utils.preemption import REQUEUE_EXIT_CODE

_FORWARDED = (signal.SIGTERM, signal.SIGUSR1)


def requested_devices(cfg) -> int:
    """``distributed.num_devices`` of a CLI config (0 when unset)."""
    return int(cfg.distributed.num_devices) if cfg.get("distributed") else 0


def resolve_world_size(requested: int, device) -> int:
    """``distributed.num_devices`` -> the number of ranks: 0 is every
    visible card (one on the CPU); on the card a count above
    ``torch.cuda.device_count()`` raises (JAX's ``make_mesh`` silently
    truncates; the port does not)."""
    requested = int(requested)
    if requested < 0:
        raise ValueError(f"distributed.num_devices={requested}: give a count, "
                         "or 0 for every visible device")
    if torch.device(device).type != "cuda":
        return requested or 1
    visible = torch.cuda.device_count()
    if requested > visible:
        raise ValueError(f"distributed.num_devices={requested} but {visible} CUDA "
                         f"device(s) visible")
    return requested or visible


@contextlib.contextmanager
def process_group(device):
    """For a CLI's run: under a launcher, this rank's process group for the
    block and its device; else ``device`` and no group."""
    if not multihost.launched():
        yield torch.device(device)
        return
    _, _, device = multihost.initialize(device)
    try:
        yield device
    finally:
        multihost.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, call, out_dir):
    fn, args = pickle.loads(call)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        result = fn(*args)
    except Exception:  # a SystemExit (the requeue) passes as its exit code
        with open(path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    with open(path, "wb") as f:
        pickle.dump({"result": result}, f)


def _report(out_dir, rank) -> dict:
    try:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return {}


def run(world_size: int, fn, args=(), device="cpu", timeout: float | None = None):
    """Run ``fn(*args)`` in ``world_size`` spawned ranks and return rank 0's
    result (``fn``, its arguments and its result are pickled by value: a
    rank's tensors never share memory with this process's or another
    rank's).  ``device`` ``cuda``: build the CUDA kernels first.  ``timeout``: seconds for the
    whole group, after which every rank is ended and ``TimeoutError``
    raised.  A rank that fails ends the others at once and its traceback is
    raised as ``RuntimeError``; if every rank exits with
    ``REQUEUE_EXIT_CODE``, so does this call (``SystemExit``).  A SIGTERM or
    SIGUSR1 to this process is passed on to every rank (the preemption
    signals: the ranks checkpoint and requeue together)."""
    if torch.device(device).type == "cuda":
        from pointcontrast_tpu_torch import cuda_build

        cuda_build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="pc_launch_")
    port = free_port()
    call = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(r, world_size, port, call, out_dir))
             for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    previous = {}
    if threading.current_thread() is threading.main_thread():
        def forward(sig, frame):
            for p in procs:
                if p.pid is not None and p.is_alive():
                    os.kill(p.pid, sig)

        previous = {sig: signal.signal(sig, forward) for sig in _FORWARDED}
    try:
        for p in procs:
            p.start()
        pending = dict(enumerate(procs))
        while pending:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready = multiprocessing.connection.wait(
                [p.sentinel for p in pending.values()], left)
            if not ready:
                raise TimeoutError(f"ranks {sorted(pending)} of {world_size} still "
                                   f"running after {timeout} s")
            for r, p in list(pending.items()):
                if p.sentinel not in ready:
                    continue
                p.join()
                del pending[r]
                if p.exitcode not in (0, REQUEUE_EXIT_CODE):
                    error = _report(out_dir, r).get("error", "(no traceback)")
                    raise RuntimeError(f"rank {r} of {world_size} failed with exit "
                                       f"code {p.exitcode}:\n{error}")
        codes = {p.exitcode for p in procs}
        if codes == {REQUEUE_EXIT_CODE}:
            raise SystemExit(REQUEUE_EXIT_CODE)
        if codes != {0}:
            raise RuntimeError(f"the ranks exited with {[p.exitcode for p in procs]}: "
                               "some requeueable, some finished")
        return _report(out_dir, 0)["result"]
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
