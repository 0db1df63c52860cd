"""Fence splitting and wall coverage: the two helpers of the reference's
``trace/attribution.py`` that the port's scheduler needs (its window
reports come with the rest of the trace tier).

:func:`split_fence_benches` converts per-cid completion timestamps,
measured by fencing each compute id's last launch in dispatch order
(stream order makes each such fence retire exactly when that cid's final
kernel retires), into MARGINAL per-cid times: each cid is charged the
time from the previous cid's completion to its own.  For batched windows
(all of cid A, then all of cid B) the marginals are exact per-cid device
costs; interleaved windows still charge a cid with any earlier-dispatched
work of later-completing ids, the stream-order bound on what host-side
fencing can attribute.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["split_fence_benches", "union_ms"]


def split_fence_benches(
    completions: Sequence[tuple[int, float]], t_open: float
) -> dict[int, float]:
    """Per-cid marginal milliseconds from ordered completion timestamps.

    ``completions`` is [(cid, perf_counter_at_completion), ...] in the
    order the fences retired (== dispatch order of each cid's last
    launch); ``t_open`` is when the dispatch window opened.  Returns
    {cid: marginal_ms}.  Marginals are clamped at 0 (clock jitter on a
    same-instant retirement must not produce a negative bench, which the
    balancer would treat as infinite speed)."""
    out: dict[int, float] = {}
    prev = t_open
    for cid, t in completions:
        out[cid] = max(t - prev, 0.0) * 1000.0
        prev = max(prev, t)
    return out


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) second-intervals, in ms."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cs, ce = intervals[0]
    for s, e in intervals[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return (total + (ce - cs)) * 1000.0
