"""The balancer's deterministic convergence simulation.

Counterpart of ``cekirdekler_tpu/benchrig.py``'s :func:`convergence_sim`:
the real ``core.balance.load_balance`` against the mandelbrot cost field,
each lane's bench the exact work in its contiguous slice (host escape
counts), so the result is the reference's key for key.  The live
multi-lane rig and ``compute_path_proof`` need lane tracing (ROADMAP Queue
A 5).
"""

from __future__ import annotations

import numpy as np

__all__ = ["convergence_sim"]


def convergence_sim(ndev: int = 8, step: int = 256) -> dict:
    """Convergence of ``load_balance`` over ``ndev`` lanes on the 512x512x128
    mandelbrot cost field (escape count + 2 per pixel): the production
    configuration (adaptive damping, smoothed and not) and the reference's
    fixed-damping parity mode (smoothed and not), 48 iterations each from
    the equal split.  Returns the convergence iteration of each, the
    imbalance (busiest lane's work over the mean) at the first and final
    splits, and those splits."""
    from .core.balance import BalanceHistory, BalanceState, equal_split, load_balance
    from .workloads import _converged_at, mandelbrot_host

    w = h = 512
    max_iter = 128
    img = mandelbrot_host(w, h, -2.0, -1.25, 2.5 / w, 2.5 / h, max_iter)
    cost = img.astype(np.float64) + 2.0  # per-pixel work ∝ escape iterations
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    n = w * h

    def run(smooth: bool, adaptive: bool = True, cid: int = 0):
        ranges = equal_split(n, ndev, step)
        hist = BalanceHistory(weighted=adaptive) if smooth else None
        state = BalanceState() if adaptive else None
        carry: list[float] | None = None if adaptive else []
        traj = [list(ranges)]
        for _ in range(48):
            offs = np.concatenate([[0], np.cumsum(ranges)]).astype(int)
            bench = [float(cum[offs[i + 1]] - cum[offs[i]]) for i in range(ndev)]
            ranges = load_balance(bench, ranges, n, step, hist, carry=carry, state=state,
                                  cid=cid)
            traj.append(list(ranges))
        return traj

    traj = run(smooth=True, cid=0)
    traj_ns = run(smooth=False, cid=1)
    traj_parity = run(smooth=True, adaptive=False, cid=2)
    traj_parity_ns = run(smooth=False, adaptive=False, cid=3)

    def imbalance(r):
        offs = np.concatenate([[0], np.cumsum(r)]).astype(int)
        work = [cum[offs[i + 1]] - cum[offs[i]] for i in range(ndev)]
        return float(max(work) / (sum(work) / ndev))

    return {
        "n_devices": ndev,
        "iterations_run": len(traj) - 1,
        "convergence_iters_smoothed": _converged_at(traj, step),
        "convergence_iters_unsmoothed": _converged_at(traj_ns, step),
        "convergence_iters_smoothed_reference_parity": _converged_at(traj_parity, step),
        "convergence_iters_unsmoothed_reference_parity": _converged_at(traj_parity_ns, step),
        "imbalance_first": round(imbalance(traj[0]), 3),
        "imbalance_final": round(imbalance(traj[-1]), 3),
        "imbalance_final_unsmoothed": round(imbalance(traj_ns[-1]), 3),
        "ranges_first": traj[0],
        "ranges_final": traj[-1],
    }
