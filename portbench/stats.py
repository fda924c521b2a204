"""The benchmark's interval arithmetic: unions, clips and gaps of the
device's busy intervals, from which the idle share and the idle gaps of a
trace are read. It lives here, not in the program, so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge [start, end) intervals into disjoint ones, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union(intervals))


def gaps(merged: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no merged interval covers."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
