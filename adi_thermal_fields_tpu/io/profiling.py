"""Profiling hooks: jax.profiler traces and per-step timing.

The reference's only instrumentation is wall-clock prints
(quick_compare_neumann_robin_backend.py:172-186); here a trace context
captures a full XLA profile viewable in TensorBoard/Perfetto, and
``StepTimer`` measures steady-state step time on the host clock around
work that ends in ``block_until_ready``.
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Measure steady-state per-step wall time of a jitted step function."""

    @staticmethod
    def sync(x):
        """Wait until everything ``x`` depends on has run on the device."""
        import jax

        return jax.block_until_ready(x)

    def time_steps(self, step_fn, x0, n_steps: int = 20, warmup: int = 1):
        """Returns (seconds_per_step, final_state) after ``warmup``
        untimed steps (compilation) and ``n_steps`` timed ones."""
        x = x0
        for _ in range(warmup):
            x = step_fn(x)
        self.sync(x)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            x = step_fn(x)
        self.sync(x)
        return (time.perf_counter() - t0) / n_steps, x
