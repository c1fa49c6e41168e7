"""Run-time utilities (port): preemption-safe training."""
