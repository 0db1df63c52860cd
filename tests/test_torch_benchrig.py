"""``benchrig.compute_path_proof`` of the port against the JAX package's.

The proof drives the real ``compute()`` path over host lanes with each
lane's bench injected as the exact mandelbrot work in its slice, so its
range trajectory is a pure function of the balancer: at the same ``ndev``
and ``iters`` both packages must walk the same range tables, call by call
(read through ``Cores.ranges_of``), and end on the same split with the
same work accounting.  The elapsed time and the lane-concurrency fields
are timing and are recorded, not compared.
"""

from __future__ import annotations

import pytest

from cekirdekler_tpu import benchrig as ref_benchrig
from cekirdekler_tpu.core.cores import Cores as RefCores
from cekirdekler_tpu_torch import benchrig
from cekirdekler_tpu_torch.core.cores import Cores

#: the result's keys that depend only on the balancer and the image
PURE = ("ok", "n_devices", "compute_calls", "rebalances", "distinct_splits_seen",
        "convergence_iters", "ranges_first", "ranges_final", "per_chip_workitems_final",
        "per_chip_work_final", "work_imbalance_final", "work_imbalance_first",
        "image_exact_vs_single_chip", "host_boundary_bound")


def _traced(monkeypatch, cls) -> list:
    """Record every ``ranges_of(7200)`` the proof reads on ``cls``."""
    seen: list = []
    orig = cls.ranges_of

    def ranges_of(self, compute_id):
        out = orig(self, compute_id)
        if compute_id == 7200:
            seen.append(list(out))
        return out

    monkeypatch.setattr(cls, "ranges_of", ranges_of)
    return seen


@pytest.mark.parametrize("ndev,iters", [(2, 5), (3, 3)])
def test_compute_path_proof_walks_the_reference_s_trajectory(monkeypatch, ndev, iters):
    mine_traj = _traced(monkeypatch, Cores)
    ref_traj = _traced(monkeypatch, RefCores)
    mine = benchrig.compute_path_proof(ndev, iters)
    ref = ref_benchrig.compute_path_proof(ndev, iters)
    assert mine_traj[:iters] == ref_traj[:iters] and len(mine_traj) >= iters
    for key in PURE:
        assert mine[key] == ref[key], key
    assert mine["host_boundary_mismatch_frac"] == 0.0
    # recorded, not gated: the timing and capability fields exist
    assert mine["lanes_traced"] >= 1 and mine["elapsed_sec"] >= 0.0
    assert set(ref) - {"host_boundary_note"} <= set(mine)


def test_compute_path_proof_refuses_a_single_call():
    with pytest.raises(ValueError, match="iters"):
        benchrig.compute_path_proof(2, 1)
