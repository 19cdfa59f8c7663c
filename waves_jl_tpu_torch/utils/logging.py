"""Metrics logging, phase timing and profiling (counterpart of
`waves_jl_tpu/utils/logging.py`): a JSONL metrics log with the JAX
package's keys, a phase timer on the host clock, and `profile_trace`, a
`torch.profiler` scope that writes a Chrome trace. The JAX logger's
TensorBoard mirror is not ported."""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

import torch


class MetricsLogger:
    """Append-only JSONL metrics log that also keeps its records in memory."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.history: list[dict] = []
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def log(self, **kv):
        rec = {"time": time.time(), **kv}
        self.history.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()


class Timer:
    """Phase timer: `with timer("name"): ...` adds the seconds to
    `totals[name]`."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0


@contextmanager
def profile_trace(logdir: str | None):
    """`torch.profiler` scope over the CPU and, where there is a card, CUDA
    activities; on exit it writes a Chrome trace
    `trace_<pid>_<ms>.json` under `logdir` (made if missing). Yields the
    profiler, whose `key_averages()` sums the times by kernel, or None for
    `logdir` None, where it does nothing (JAX's `jax.profiler` scope)."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
