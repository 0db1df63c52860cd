"""The balancer's deterministic demonstrations.

Counterparts of ``cekirdekler_tpu/benchrig.py``'s :func:`convergence_sim`
(the real ``core.balance.load_balance`` against the mandelbrot cost
field, each lane's bench the exact work in its contiguous slice) and
:func:`compute_path_proof` (the same injected benches through the real
``compute()`` path over host lanes, with lane tracing), so each range
trajectory is the reference's.  The reference's live rig driver
(``main``, a JSON line over its 8-device CPU rig) is not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_path_proof", "convergence_sim"]


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


def compute_path_proof(ndev: int = 8, iters: int = 49) -> dict:
    """The multi-lane ``Cores.compute()`` path driven for ``iters`` calls of
    mandelbrot 512x512x96 (local range 256) over ``ndev`` host lanes, with
    the four facts the "N devices as one device" claim rests on:

    1. converged ranges: the trajectory of the real per-call rebalance;
    2. per-lane work at the final split (max work / mean work);
    3. launcher-count invariance: the kernel launchers built (one per
       ladder chunk size) stop growing once the ladder is warm;
    4. dispatch concurrency: with lane tracing on, how many lanes' dispatch
       returned before the first lane joined.

    Bench injection: lanes that share host cores measure contention, not
    work, so each lane's bench is the exact work in its slice (escape
    counts + 2 per pixel), fed through the same ``Worker.benchmarks`` the
    wall-clock bench uses (lanes with zero range keep no bench).  The
    trajectory is then a pure function of the balancer.  The final image
    must equal a single-lane run bit for bit and the host reference within
    0.001 of its pixels."""
    import os
    import time

    from .arrays.clarray import ClArray
    from .core.cruncher import NumberCruncher
    from .hardware import all_devices
    from .workloads import MANDELBROT_SRC, _converged_at, mandelbrot_host

    w = h = 512
    max_iter = 96
    local = 256
    cid = 7200
    n = w * h
    if iters < 2:
        raise ValueError("compute_path_proof needs iters >= 2")
    devs = all_devices().cpus(ndev)
    img_ref = mandelbrot_host(w, h, -2.0, -1.25, 2.5 / w, 2.5 / h, max_iter)
    cost = img_ref.astype(np.float64) + 2.0
    cum = np.concatenate([[0.0], np.cumsum(cost)])

    def work_in(lo: int, hi: int) -> float:
        return float(cum[hi] - cum[lo])

    def inject(cores, ranges) -> None:
        offs = np.concatenate([[0], np.cumsum(ranges)]).astype(int)
        for i, wk in enumerate(cores.workers):
            if ranges[i] > 0:
                wk.benchmarks[cid] = work_in(offs[i], offs[i + 1])

    cr = NumberCruncher(devs, MANDELBROT_SRC)
    cores = cr.cores
    out = ClArray(n, np.float32, name="cp_out", read=False, write=True)
    vals = (-2.0, -1.25, 2.5 / w, 2.5 / h, w, max_iter)
    traj: list[list[int]] = []
    compile_at: dict[str, int] = {}
    warm_call = min(8, iters - 1)
    checkpoints = {1, warm_call, iters}
    t0 = time.perf_counter()
    try:
        for k in range(iters):
            if k == iters - 1:
                cores.trace_lanes = True
            out.compute(cr, cid, "mandelbrot", n, local, values=vals)
            ranges = cores.ranges_of(cid)
            traj.append(ranges)
            inject(cores, ranges)
            if k + 1 in checkpoints:
                compile_at[str(k + 1)] = cores.program.compiled_count
        elapsed = time.perf_counter() - t0
        multi = np.asarray(out).copy()
        cr1 = NumberCruncher(devs.subset(1), MANDELBROT_SRC)
        out1 = ClArray(n, np.float32, name="cp_out1", read=False, write=True)
        try:
            out1.compute(cr1, cid, "mandelbrot", n, local, values=vals)
            if not np.array_equal(multi, np.asarray(out1)):
                raise RuntimeError("the multi-lane image differs from the single-lane run")
        finally:
            cr1.dispose()
        boundary_mismatch = float(np.mean(multi != img_ref.astype(np.float32)))
        if boundary_mismatch >= 0.001:
            raise RuntimeError(f"host-reference mismatch {boundary_mismatch:.4f} exceeds 0.001")
        final = traj[-1]
        offs = np.concatenate([[0], np.cumsum(final)]).astype(int)
        works = [work_in(offs[i], offs[i + 1]) for i in range(ndev)]
        mean_w = sum(works) / ndev

        def lane_concurrency() -> tuple[list, int]:
            tr = cores.lane_trace.get(cid, [])
            first_join = min((t for (_, _, t) in tr), default=0.0)
            return tr, sum(1 for (_, d, _) in tr if d <= first_join)

        # a timing property: a host with fewer cores than lanes cannot
        # schedule every lane before the first one joins, so the traced call
        # is retried (the best attempt counts) and the capability reported
        try:
            host_cpus = len(os.sched_getaffinity(0))
        except AttributeError:
            host_cpus = os.cpu_count() or 1
        active_lanes = sum(1 for r in final if r > 0)
        trace, lanes_in_flight = lane_concurrency()
        attempts = 1
        while attempts < 3 and not (lanes_in_flight == len(trace) == active_lanes):
            out.compute(cr, cid, "mandelbrot", n, local, values=vals)
            inject(cores, cores.ranges_of(cid))
            attempts += 1
            tr, lif = lane_concurrency()
            if lif > lanes_in_flight:
                trace, lanes_in_flight = tr, lif
        return {
            "ok": True,
            "n_devices": ndev,
            "compute_calls": iters,
            "rebalances": iters - 1,
            "distinct_splits_seen": len({tuple(r) for r in traj}),
            "convergence_iters": _converged_at(traj, local),
            "ranges_first": traj[0],
            "ranges_final": final,
            "per_chip_workitems_final": final,
            "per_chip_work_final": [round(x, 0) for x in works],
            "work_imbalance_final": round(max(works) / mean_w, 3),
            "work_imbalance_first": round(
                max(work_in(i * (n // ndev), (i + 1) * (n // ndev)) for i in range(ndev))
                / (work_in(0, n) / ndev), 3),
            "compile_count_after_calls": compile_at,
            "compile_count_invariant": compile_at[str(iters)] == compile_at[str(warm_call)],
            "lanes_traced": len(trace),
            "lanes_dispatched_before_first_join": lanes_in_flight,
            "lane_trace_attempts": attempts,
            "lane_rig_capable": host_cpus >= active_lanes,
            "host_cpus": host_cpus,
            "all_lanes_in_flight_together": (lanes_in_flight == len(trace)
                                             and len(trace) == active_lanes),
            "image_exact_vs_single_chip": True,
            "host_boundary_mismatch_frac": boundary_mismatch,
            "host_boundary_bound": 0.001,
            "elapsed_sec": round(elapsed, 1),
        }
    finally:
        cores.trace_lanes = False
        cr.dispose()
