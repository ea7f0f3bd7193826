"""First-class tracing/profiling (the reference has none; SURVEY.md section 5
calls for JAX profiler traces + per-stage timing as first-class)."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulating per-stage wall-clock timers with JSON summary, plus the
    run's named counters (written under "counters")."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: dict(seconds=round(self.totals[name], 4),
                       calls=self.counts[name])
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(dict(self.summary(), counters=self.counters), f,
                      indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX profiler trace (viewable in TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


GLOBAL_TIMER = StageTimer()
