"""Tracing and timing helpers (counterpart of
``mpc_cbf_tpu/utils/profiling.py``; the reference has none).

- ``span(name)`` / ``step()``: the program's own spans, around the stages of
  a control step and the solvers' phases. Off by default: a span is then
  one shared no-op context (no clock read, no allocation, no profiler call,
  no device work). On, each span appends a ``Record`` (name, start_ns,
  end_ns, parent index, step id; ``time.perf_counter_ns``) to the records
  of the current ``recording()`` and opens
  ``torch.profiler.record_function("mpc::" + name)``, so that under any
  ``torch.profiler`` profile it is an event on the device timeline's clock
  and the kernels it launched can be put down to it. A span holds no
  tensor and reads no device value. Spans are one thread's contexts.
- ``recording()``: the one switch. Turns the spans on for its duration and
  yields the list their records go to.
- ``trace(logdir)``: context manager around ``torch.profiler`` that writes a
  trace of everything inside, the program's ``mpc::`` spans included, to
  ``logdir`` (TensorBoard's or Perfetto's viewer reads it); CUDA activity
  is traced when a GPU is present.
- ``StepTimer``: wall-clock step latency accumulator with p50/p95/p99, for
  real-time-budget validation (the reference's implied budget is one replan
  per h = 100 ms).
- ``annotate(name)``: the JAX package's name for a named region; ``span``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

#: prefix of the program's spans among a profiler trace's events
PREFIX = "mpc::"


class Record(NamedTuple):
    """One span. parent: index in the same records of the innermost span
    open at its start (-1: none); step: id of the ``step`` span it lies in
    (-1: none; ids count from 0 in each recording)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int


# the span of a program that is not tracing
_OFF = contextlib.nullcontext()
# the current recording's records, None while tracing is off; its open
# spans (indices into it) and its step ids
_records: Optional[List[Record]] = None
_open: List[int] = []
_step = -1
_steps = 0


class _Span:
    __slots__ = ("name", "new_step", "index", "start", "parent", "outer_step", "mark")

    def __init__(self, name: str, new_step: bool):
        self.name, self.new_step = name, new_step

    def __enter__(self):
        global _step, _steps
        self.mark = torch.profiler.record_function(PREFIX + self.name)
        self.mark.__enter__()
        self.outer_step = _step
        if self.new_step:
            _step, _steps = _steps, _steps + 1
        self.parent = _open[-1] if _open else -1
        self.index = len(_records)
        _records.append(None)               # its place, by start; filled at its end
        _open.append(self.index)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        global _step
        end = time.perf_counter_ns()
        _records[self.index] = Record(self.name, self.start, end, self.parent, _step)
        _open.pop()
        _step = self.outer_step
        self.mark.__exit__(*exc)
        return False


def span(name: str):
    """A named span of the program (a context manager)."""
    return _OFF if _records is None else _Span(name, False)


def step():
    """The span of one control step, named ``step``: every span opened
    inside it carries its step id."""
    return _OFF if _records is None else _Span("step", True)


annotate = span


@contextlib.contextmanager
def recording():
    """Turn the program's spans on; yields the list of their Records,
    complete once the context ends. Nested recordings keep their own."""
    global _records, _open, _step, _steps
    outer = (_records, _open, _step, _steps)
    _records, _open, _step, _steps = [], [], -1, 0
    try:
        yield _records
    finally:
        _records, _open, _step, _steps = outer


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host (and, with a GPU, device) trace into ``logdir``, the
    program's spans on; yields their Records."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording() as records, profile(activities=activities,
                                         on_trace_ready=tensorboard_trace_handler(logdir)):
        yield records


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
