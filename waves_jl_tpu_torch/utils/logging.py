"""Metrics logging and phase timing (counterpart of
`waves_jl_tpu/utils/logging.py`): a JSONL metrics log with the JAX
package's keys, and a phase timer on the host clock. The JAX logger's
TensorBoard mirror and `profile_trace` are not ported."""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


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
