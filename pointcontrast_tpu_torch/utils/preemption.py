"""Preemption-safe training: checkpoint on signal, exit requeueable (copy of
``pointcontrast_tpu/utils/preemption.py``).

The reference runs under submitit's SLURM launcher, which delivers SIGUSR1
before preemption and requeues the job; its trainers then resume from the
latest checkpoint.  Here, scheduler-agnostic:

- ``PreemptionGuard`` installs handlers for SIGTERM/SIGUSR1 (the signals
  cloud preemption and SLURM send) that set a flag.
- Trainers poll ``guard.poll()`` once per step; when set they save a
  checkpoint and raise ``Preempted``.  Under data parallelism ``poll``
  ORs the flag over the ranks (a MAX over the host-side gloo group), so a
  signal that reaches one rank stops every rank at the same step; rank 0
  saves and every rank raises after it.
- Apps catch ``Preempted``, write ``<out_dir>/REQUEUE``, and exit with
  ``REQUEUE_EXIT_CODE`` so a wrapper loop or any scheduler restarts them;
  on restart the trainers' auto-resume picks up from the saved checkpoint.

Signal handlers only set a flag -- no device or IO work happens in the
handler (async-signal safety, and the step in flight finishes normally).
"""
from __future__ import annotations

import logging
import os
import signal
import threading

log = logging.getLogger(__name__)

REQUEUE_EXIT_CODE = 3
REQUEUE_MARKER = "REQUEUE"

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class Preempted(Exception):
    """Raised by a trainer after it has checkpointed in response to a
    preemption signal.  ``step`` is the iteration the checkpoint holds."""

    def __init__(self, step: int):
        super().__init__(f"preempted; checkpoint saved at iter {step}")
        self.step = step


class PreemptionGuard:
    """Flag-setting signal trap.  Install once near the top of a run.

    Thread-safe: the flag may be set from the signal handler (main thread)
    or via ``trigger()`` from any thread (tests, loader watchdogs).
    ``installed_signals`` lists what was actually hooked -- non-main threads
    can't install handlers, in which case the guard still works through
    ``trigger()``.
    """

    def __init__(self, signals=_DEFAULT_SIGNALS, install: bool = True):
        self._event = threading.Event()
        self.installed_signals: tuple = ()
        self._previous = {}
        if install:
            self.install(signals)

    def install(self, signals=_DEFAULT_SIGNALS) -> None:
        hooked = []
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
                hooked.append(sig)
            except (ValueError, OSError):  # non-main thread / exotic signal
                continue
        self.installed_signals = tuple(hooked)
        if hooked:
            log.info("preemption guard armed for %s",
                     ", ".join(signal.Signals(s).name for s in hooked))

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError):
                continue
        self._previous.clear()
        self.installed_signals = ()

    def _handler(self, sig_num, frame):
        # flag only; the trainer checkpoints at the next step boundary
        self._event.set()

    def trigger(self) -> None:
        """Programmatic preemption (tests, watchdogs)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def poll(self) -> bool:
        """Whether any rank's flag is set (this process's without a process
        group).  Every rank calls it once a step, at the same step."""
        from pointcontrast_tpu_torch.parallel.mesh import any_rank

        return any_rank(self.preempted)


def write_requeue_marker(out_dir: str, step: int) -> str:
    """Record that the run exited preempted-but-checkpointed."""
    path = os.path.join(out_dir, REQUEUE_MARKER)
    with open(path, "w") as f:
        f.write(f"{step}\n")
    return path


def clear_requeue_marker(out_dir: str) -> None:
    path = os.path.join(out_dir, REQUEUE_MARKER)
    if os.path.exists(path):
        os.remove(path)
