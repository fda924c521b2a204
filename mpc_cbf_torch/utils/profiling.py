"""Tracing and timing helpers (counterpart of
``mpc_cbf_tpu/utils/profiling.py``; the reference has none).

- ``trace(logdir)``: context manager around ``torch.profiler`` that writes a
  trace of everything inside to ``logdir`` (TensorBoard's or Perfetto's
  viewer reads it); CUDA activity is traced when a GPU is present.
- ``StepTimer``: wall-clock step latency accumulator with p50/p95/p99, for
  real-time-budget validation (the reference's implied budget is one replan
  per h = 100 ms).
- ``annotate(name)``: a named region in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host (and, with a GPU, device) trace into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock latencies; reports percentiles.

    Use around a step that ends in a wait for the device:
        with timer.measure():
            step(...); torch.cuda.synchronize()
    """

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = np.asarray(self.samples)
        return {
            "n": int(s.size),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
            "p99_ms": float(np.percentile(s, 99) * 1e3),
            "max_ms": float(s.max() * 1e3),
        }
