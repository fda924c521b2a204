"""The benchmark's spans and the reduction of a ``torch.profiler`` trace.

Spans are the benchmark's own, around the program's calls: each is timed
on the host clock and marked in the profiler's trace as ``pb::<name>``, so
that device work and idle time can be told apart by what the host was
doing. In the window a span synchronises with the device at its start and
end, so that its host time holds the device work it launched; under the
profiler it does not, so that the traced steps overlap host and device as
the untraced ones do, and a kernel belongs to the span that launched it.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from portbench import stats

PREFIX = "pb::"
# the host side of a launch: cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...
RUNTIME = re.compile(r"cu(da)?[A-Z]")


class Spans:
    """Host-clock spans of the window's steps (only in traced runs)."""

    def __init__(self, sync: bool):
        self.sync = sync          # synchronise at each span's ends
        self.ms: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(PREFIX + name):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.ms[name] += (time.perf_counter() - t0) * 1e3

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of obj.attr as span ``name`` (shadows the method
        on this object only; frozen dataclasses included)."""
        fn = getattr(obj, attr)

        def timed(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        object.__setattr__(obj, attr, timed)


def _value(ev, *names):
    for n in names:
        f = getattr(ev, n, None)
        if f is not None:
            return f()
    return None


class Trace:
    """Device activity and host spans of one profiled stretch, in ns on the
    profiler's clock."""

    def __init__(self, prof):
        # (name, start, end, host time of its launch)
        self.kernels: List[Tuple[str, int, int, int]] = []
        self.busy: List[Tuple[int, int]] = []             # kernels, copies, sets
        self.host: List[Tuple[str, int, int]] = []        # pb:: spans
        launch = {}        # correlation id -> host start of the launching call
        op_start = {}      # the program's operator events by their own id
        device = []
        for ev in prof.profiler.kineto_results.events():
            start = _value(ev, "start_ns")
            if start is None:
                start = _value(ev, "start_us") * 1000
            dur = _value(ev, "duration_ns")
            if dur is None:
                dur = _value(ev, "duration_us") * 1000
            name = ev.name()
            kind = str(_value(ev, "activity_type") or "").lower()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # the benchmark's spans are mirrored onto the device's timeline
                if "annotation" in kind or name.startswith(PREFIX):
                    continue
                self.busy.append((start, start + dur))
                if "memcpy" not in kind and "memset" not in kind and \
                        not name.startswith(("Memcpy", "Memset")):
                    device.append((name, start, start + dur, ev.correlation_id(),
                                   ev.linked_correlation_id()))
            elif name.startswith(PREFIX):
                self.host.append((name[len(PREFIX):], start, start + dur))
            elif "runtime" in kind or "driver" in kind or RUNTIME.match(name):
                # a CUDA runtime or driver call shares its correlation id with
                # the work it queued (the operators' ids are another series)
                launch[ev.correlation_id()] = start
            else:
                op_start[ev.correlation_id()] = start
        # a kernel's launch is the runtime call of its correlation id, else
        # the operator it is linked to, else (not seen) its own start
        self.launched = 0
        for name, s, e, corr, linked in device:
            t = launch.get(corr)
            self.launched += t is not None
            if t is None:
                t = op_start.get(linked, s) if linked else s
            self.kernels.append((name, s, e, t))

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return sorted((s, e) for n, s, e in self.host if n == name)

    def window(self) -> Tuple[int, int]:
        (s, e), = self.spans("traced")
        return s, e

    def busy_ns(self, lo: int, hi: int) -> int:
        return stats.covered(stats.clip(self.busy, lo, hi))

    def kernels_in(self, intervals) -> List[Tuple[str, int, int, int]]:
        """Kernels launched inside one of the host intervals."""
        return [k for k in self.kernels if any(s <= k[3] < e for s, e in intervals)]

    def labels_at(self, times) -> List[str]:
        """The innermost benchmark span the host was in at each of the
        ascending times (the spans nest: they are one thread's contexts)."""
        spans = sorted(self.host, key=lambda h: (h[1], -h[2]))
        out, stack, i = [], [], 0
        for t in times:
            while i < len(spans) and spans[i][1] <= t:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            out.append(stack[-1][0] if stack else "outside the benchmark's spans")
        return out

    def breakdown(self, top: int = 10) -> dict:
        lo, hi = self.window()
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.kernels:
            if lo <= s < hi:
                by_name[name] += (e - s) * 1e-9
        idle: Dict[str, float] = defaultdict(float)
        gaps = stats.gaps(stats.union(stats.clip(self.busy, lo, hi)), lo, hi)
        for (s, e), label in zip(gaps, self.labels_at([(s + e) // 2 for s, e in gaps])):
            idle[label] += (e - s) * 1e-9
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(by_name), "idle_gaps": order(idle)}
