"""Tracing / profiling utilities.

The reference's only observability is wall-clock prints and tqdm bars
(SURVEY.md §5). Equivalents here:
- `trace(logdir)`: capture a jax.profiler trace (viewable in
  TensorBoard/Perfetto) around any block — e.g. one training epoch
- `StepTimer`: p50/p95 host-side step timing with warmup discard
- `device_memory_stats()`: live HBM usage per device
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: with trace("/tmp/trace"): run_steps()."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "total_s": float(a.sum()),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
            out[str(d)] = {
                "bytes_in_use_mb": s.get("bytes_in_use", 0) / 1e6,
                "peak_bytes_in_use_mb": s.get("peak_bytes_in_use", 0) / 1e6,
            }
        except Exception:  # noqa: BLE001 — backend may not support stats
            out[str(d)] = {}
    return out
