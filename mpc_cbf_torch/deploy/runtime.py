"""Deployment runtime: message bus + virtual-time scheduler (counterpart of
``mpc_cbf_tpu/deploy/runtime.py``; pure Python, carried over as it is).

Reference parity: the ROS1 layer of ``workspace/src`` — topics
(pub/sub between the estimator and controller processes,
``control_node.cpp:180-193``) and ``ros::Timer`` callbacks
(``control_node.cpp:195-197``). ROS is replaced by a transport-agnostic
in-process bus and a deterministic virtual-time scheduler: node callbacks
fire in timestamp order, so a whole multi-node deployment runs
reproducibly inside one process (and one test), while the per-node
compute runs on the nodes' device.

The scheduler is pure bookkeeping: a timer callback makes one controller
or filter call on the device. Real-robot transports (UDP/ROS2/mavlink
bridges) slot in by replacing Bus with a networked implementation of the
same two methods.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict
from typing import Any, Callable, Dict, List


class Bus:
    """Minimal topic pub/sub. Callbacks run synchronously on publish
    (ROS1 single-threaded-spinner semantics)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self.latched: Dict[str, Any] = {}

    def subscribe(self, topic: str, cb: Callable[[Any], None]) -> None:
        self._subs[topic].append(cb)
        if topic in self.latched:
            cb(self.latched[topic])

    def publish(self, topic: str, msg: Any, latch: bool = False) -> None:
        if latch:
            self.latched[topic] = msg
        for cb in self._subs[topic]:
            cb(msg)


@dataclasses.dataclass(order=True)
class _Event:
    t: float
    seq: int
    period: float = dataclasses.field(compare=False)
    cb: Callable[[], None] = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(compare=False, default=False)


class Scheduler:
    """Deterministic virtual-time timer wheel (replaces ros::Timer).

    Periodic timers fire in (time, registration-order); ``run_until``
    advances virtual time, never wall-clock.
    """

    def __init__(self):
        self._heap: List[_Event] = []
        self._count = itertools.count()
        self.now = 0.0

    def create_timer(self, period: float, cb: Callable[[], None],
                     offset: float | None = None) -> _Event:
        ev = _Event(t=self.now + (period if offset is None else offset),
                    seq=next(self._count), period=period, cb=cb)
        heapq.heappush(self._heap, ev)
        return ev

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0].t <= t_end + 1e-12:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.t
            ev.cb()
            # re-push the SAME event object (fresh seq for heap ordering):
            # the handle returned by create_timer stays valid, so cancel()
            # works after any number of firings (ros::Timer::stop parity)
            ev.t += ev.period
            ev.seq = next(self._count)
            heapq.heappush(self._heap, ev)
        self.now = max(self.now, t_end)


@dataclasses.dataclass
class Node:
    """Base class: a named participant wired to a bus and scheduler."""

    name: str
    bus: Bus
    sched: Scheduler

    def timer(self, period: float, cb: Callable[[], None], offset=None):
        return self.sched.create_timer(period, cb, offset)

    def pub(self, topic: str, msg: Any, latch: bool = False) -> None:
        self.bus.publish(topic, msg, latch=latch)

    def sub(self, topic: str, cb: Callable[[Any], None]) -> None:
        self.bus.subscribe(topic, cb)
