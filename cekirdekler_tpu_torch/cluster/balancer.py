"""Cluster-grain load balancer.

A copy of the reference's ``cluster/balancer.py`` kept in the port (which
never imports the JAX package): pure arithmetic, whose splits equal the
reference's bit for bit on the same inputs (``tests/test_torch_cluster.py``).
The text below is the reference's.

Port of the reference's ``ClusterLoadBalancer`` (ClusterLoadBalancer.cs):
coarser than the per-chip balancer (core/balance.py) — shares move in
LCM-of-node-steps units so every node's share stays divisible by its own
step (node step = its device count × local range, ClusterAccelerator.cs
compute()).  ``equal_split`` hands out LCM chunks round-robin with the
remainder going to the mainframe (the local node), mirroring
``dengeleEsit`` (ClusterLoadBalancer.cs:143-231); ``rebalance`` applies
the damped move ``t += 0.3·(p − t)`` on normalized measured performance
and snaps to step multiples (``balanceOnPerformances``, :233-325).
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["ClusterLoadBalancer"]


def _lcm_all(values: Sequence[int]) -> int:
    out = 1
    for v in values:
        out = math.lcm(out, max(1, int(v)))
    return out


class ClusterLoadBalancer:
    """Per-compute-id cluster balancer (one instance per compute id,
    reference: ClusterAccelerator.cs:170-355)."""

    def __init__(self, steps: Sequence[int], damping: float = 0.3):
        self.steps = [max(1, int(s)) for s in steps]
        self.lcm = _lcm_all(self.steps)
        self.damping = damping
        self.targets: list[float] | None = None  # normalized shares

    @property
    def num_nodes(self) -> int:
        return len(self.steps)

    def equal_split(self, total: int) -> tuple[list[int], int]:
        """Equal distribution in LCM chunks; remainder returned for the
        mainframe (reference: dengeleEsit)."""
        n = self.num_nodes
        chunks = total // self.lcm
        per = (chunks // n) * self.lcm
        ranges = [per] * n
        left = total - per * n
        # distribute leftover LCM chunks round-robin
        i = 0
        while left >= self.lcm:
            ranges[i % n] += self.lcm
            left -= self.lcm
            i += 1
        self.targets = [r / total if total else 0.0 for r in ranges]
        return ranges, left

    def resplit_active(self, total: int,
                       active: Sequence[int]) -> tuple[list[int], int]:
        """Membership-change re-split: equal LCM-chunk
        distribution over the ACTIVE node indices only — a departed/
        preempted node's share is 0 — with the remainder returned for
        the mainframe (the first active node).  The balancer's targets
        reset to the new split: the old trajectory described a
        membership that no longer exists, and damping toward it would
        drip work onto dead nodes.  ``cluster/elastic.member_resplit``
        (the replay-verified decision output) is the all-active,
        remainder-folded wrapper over this — one re-split
        implementation, two call forms."""
        active = sorted({int(i) for i in active})
        if not active or any(i < 0 or i >= self.num_nodes for i in active):
            raise ValueError(
                f"active indices {active} invalid for {self.num_nodes} nodes")
        sub = ClusterLoadBalancer(
            [self.steps[i] for i in active], damping=self.damping)
        shares, left = sub.equal_split(total)
        out = [0] * self.num_nodes
        for j, i in enumerate(active):
            out[i] = shares[j]
        self.targets = [r / total if total else 0.0 for r in out]
        return out, left

    def rebalance(self, ranges: Sequence[int], times_ms: Sequence[float], total: int) -> tuple[list[int], int]:
        """Move shares toward measured performance p_i = range_i / time_i,
        damped, snapped to each node's step; remainder (sum shortfall) goes
        to the mainframe."""
        n = self.num_nodes
        if n == 0 or total <= 0:
            return list(ranges), total - sum(ranges)
        # a node that ran nothing has no measurement: inherit its current
        # target instead of scoring it 0 (which would decay it to permanent
        # starvation)
        tgt = self.targets or [r / total for r in ranges]
        perf = [
            (r / t if r > 0 and t > 0 else None)
            for r, t in zip(ranges, times_ms)
        ]
        measured = [p for p in perf if p is not None]
        s_measured = sum(measured) or 1.0
        meas_share = sum(t for t, p in zip(tgt, perf) if p is not None) or 1.0
        perf = [
            (p / s_measured * meas_share if p is not None else tgt[i])
            for i, p in enumerate(perf)
        ]
        s = sum(perf)
        if s <= 0:
            return list(ranges), total - sum(ranges)
        perf = [p / s for p in perf]
        if self.targets is None or len(self.targets) != n:
            self.targets = [r / total for r in ranges]
        self.targets = [
            t + self.damping * (p - t) for t, p in zip(self.targets, perf)
        ]
        out: list[int] = []
        for t, step in zip(self.targets, self.steps):
            raw = t * total
            snapped = int(raw / step + 0.5) * step
            # floor at one step: a zero share yields no timing next call, so
            # a starved node could never earn work back — keep a probe share
            # (divergence from the reference, which shares the same defect)
            out.append(max(step if total >= sum(self.steps) else 0, snapped))
        # trim overflow from the largest shares (reference: overflow trimmed
        # from largest, ClusterLoadBalancer.cs:233-325)
        while sum(out) > total:
            i = max(range(n), key=lambda k: out[k])
            out[i] = max(0, out[i] - self.steps[i])
        remainder = total - sum(out)
        return out, remainder
