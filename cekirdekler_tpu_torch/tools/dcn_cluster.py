"""One ``compute()`` spanning N processes over gloo: the DCN tier's demo.

The port's counterpart of the reference's ``examples/dcn_cluster.py``:
:class:`~..cluster.dcn.DistributedAccelerator` runs the same ``compute()``
across the processes of a ``torch.distributed`` job, the LCM-step cluster
balancer splits the global range across processes, and the written ranges
are exchanged by gloo collectives on host bytes.  The workload is the main
path's mandelbrot (``workloads.MANDELBROT_SRC``, 2048x2048 at max_iter 256
by default), whose cost per pixel is uneven, so the equal first split is
wrong and the balancer moves work.

Self-launching: with no ``--worker`` it spawns ``--procs`` copies of itself,
joined through a rendezvous on ``127.0.0.1``, and waits for each one's
report line (every wait bounded by ``--timeout``; a worker is killed on
every exit path).  On several hosts, start one copy per host with
``--worker <pid> --procs <N> --coordinator <host:port>``: the worker path
is exactly that program.  Each rank runs on the card (``--lanes`` k > 1
takes k partition lanes of it), or on k host lanes with ``--cpu``.  From
the repository root::

    python -m cekirdekler_tpu_torch.tools.dcn_cluster                # 2 ranks on the card
    python -m cekirdekler_tpu_torch.tools.dcn_cluster --cpu --lanes 2,1 --width 256 --max-iter 64

A worker does, in order: :data:`WARMUP` + ``--calls`` balanced mandelbrot
calls (the shares, walls and image digest reported; none with ``--calls
0``); one all-gather of int64 values above 2^31 and float64 values and one
broadcast from rank 0, which must come back exact;
:func:`~..trace.aggregate.gather_cluster` over the run's spans (the clock
offsets, the merged trace's process blocks, the collectives' alignment
margin); then, with ``--windows W``, an elastic job of W windows,
each one mandelbrot frame (shifted by window) added into a host
accumulator that is checkpointed after every window
(:meth:`checkpoint_window`, then a barrier).  ``--phase first`` preempts
the job after ``--kill-after`` windows: every rank prints its report and
exits with :data:`EXIT_PREEMPTED` without any cleanup.  ``--phase rejoin``
resumes from the newest complete window (:meth:`resume_elastic`, with the
membership change recorded as decisions, which it replays) and finishes.
Each worker prints one line ``DCN_RESULT {json}`` (the exchange's bytes
and seconds by op, the emitted kernel's launches and the library builds
included); the parent prints the list of them as JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: a preempted worker's exit code (``--phase first``)
EXIT_PREEMPTED = 17
#: the report line's prefix
RESULT = "DCN_RESULT "
#: compute ids of the balanced calls and of the elastic windows
CID, WINDOW_CID = 9101, 9102
LOCAL_RANGE = 256
#: untimed balanced calls before the timed ones
WARMUP = 2


def window_values(window: int, width: int, max_iter: int) -> tuple:
    """Window ``window``'s mandelbrot frame (1-based): the main path's frame
    shifted right by 1/16 of its width a window."""
    dx = 2.5 / width
    return (-2.0 + 0.15625 * (window - 1), -1.25, dx, dx, width, max_iter)


def digest(a) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def undisturbed_windows(devices, width: int, max_iter: int, windows: int):
    """The elastic job's image computed by one process on ``devices``: the sum
    of the window frames, each one ``compute()`` over the whole range."""
    import numpy as np

    from .. import ClArray, NumberCruncher
    from ..workloads import MANDELBROT_SRC

    n = width * width
    acc = np.zeros(n, np.float32)
    out = ClArray(n, np.float32, read=False, write=True)
    with NumberCruncher(devices, MANDELBROT_SRC) as cr:
        for w in range(1, windows + 1):
            out.compute(cr, WINDOW_CID, "mandelbrot", n, LOCAL_RANGE,
                        values=window_values(w, width, max_iter))
            acc += out.host()
    return acc


# -- a worker --------------------------------------------------------------------


def _lanes(cpu: bool, k: int):
    from .. import all_devices, cpus

    if cpu:
        return cpus(k)
    if k == 1:
        return None  # DistributedAccelerator's default: the card
    return all_devices().require_nonempty("a CUDA device")[0].as_partitions(k)


def _exchange_report() -> dict:
    """Bytes, calls and seconds of the exchange by op: the registry's
    ``ck_dcn_exchange_bytes_total`` and ``ck_dcn_exchange_seconds``, and the
    exact median of the ``dcn-exchange`` spans' durations."""
    import numpy as np

    from ..metrics.registry import REGISTRY
    from ..trace.spans import TRACER

    out = {}
    for op in ("allgather", "broadcast0"):
        hist = REGISTRY.histogram("ck_dcn_exchange_seconds", op=op).value
        durs = [s.t1 - s.t0 for s in TRACER.snapshot()
                if s.kind == "dcn-exchange" and (s.tag or "").startswith(op)]
        out[op] = {
            "bytes": REGISTRY.counter("ck_dcn_exchange_bytes_total", op=op).value,
            "count": hist["count"], "sum_s": hist["sum"],
            "median_s": float(np.median(durs)) if durs else None,
        }
    return out


def _balanced_calls(acc, args, rep: dict) -> None:
    import numpy as np

    from .. import ClArray

    n = args.width * args.width
    out = ClArray(n, np.float32, read=False, write=True)
    vals = (-2.0, -1.25, 2.5 / args.width, 2.5 / args.width, args.width, args.max_iter)
    shares, walls = [], []
    for k in range(WARMUP + args.calls):
        t0 = time.perf_counter()
        acc.compute("mandelbrot", [out], CID, n, LOCAL_RANGE, values=vals)
        wall = (time.perf_counter() - t0) * 1e3
        shares.append(acc.ranges_of(CID))
        if k >= WARMUP:
            walls.append(wall)
    rep["shares"] = shares
    rep["walls_ms"] = walls
    rep["timings_ms"] = acc.compute_timing(CID)
    rep["mpixels_per_sec"] = n * len(walls) / (sum(walls) / 1e3) / 1e6 if walls else None
    rep["digest"] = digest(out.host())


def _exchange_check(acc, rep: dict) -> None:
    import numpy as np

    pid, nproc = acc.pid, acc.nproc
    ints = acc._allgather(np.asarray([2**40 + pid, -(2**62) + pid, 2**31 + 7], np.int64))
    floats = acc._allgather(np.asarray([np.pi * (pid + 1), 1e300 / (pid + 1), 2.0**-1070],
                                       np.float64))
    mine = np.arange(5, dtype=np.float64) + (100.0 + 1e-12 if pid == 0 else -7.0)
    owner = acc._broadcast0(mine)
    want_i = np.asarray([[2**40 + p, -(2**62) + p, 2**31 + 7] for p in range(nproc)], np.int64)
    want_f = np.asarray([[np.pi * (p + 1), 1e300 / (p + 1), 2.0**-1070] for p in range(nproc)],
                        np.float64)
    rep["exchange_exact"] = {
        "int64": bool(ints.dtype == np.int64 and np.array_equal(ints, want_i)),
        "float64": bool(floats.dtype == np.float64 and np.array_equal(floats, want_f)),
        "broadcast0": bool(owner.dtype == np.float64 and np.array_equal(
            owner, np.arange(5, dtype=np.float64) + 100.0 + 1e-12)),
    }


def _gather(acc, rep: dict) -> None:
    from ..obs.health import cluster_health_table
    from ..trace import aggregate
    from ..trace.spans import TRACER

    spans = TRACER.snapshot()
    snap = aggregate.gather_cluster(acc, spans=spans)
    merged = aggregate.merged_chrome_trace(snap)
    blocks = sorted({e["pid"] for e in merged["traceEvents"]})
    rep["gather"] = {
        "nproc": snap["nproc"], "offsets": snap["offsets"],
        "margin_s": aggregate.collective_consistency(snap),
        "trace_blocks": blocks,
        "spans_by_block": {str(p + 1): len(s) for p, s in enumerate(snap["spans"])},
        "events": len(merged["traceEvents"]),
        "health_processes": len(cluster_health_table(snap)["processes"]),
        "exchange_bytes_by_process": [
            sum(v for k, v in m["counters"].items()
                if k.startswith("ck_dcn_exchange_bytes_total")) for m in snap["metrics"]],
    }


def _elastic(acc, args, rep: dict) -> None:
    import numpy as np

    from .. import ClArray
    from ..obs.decisions import DECISIONS
    from ..obs.replay import verify_records

    n = args.width * args.width
    accum = np.zeros(n, np.float32)
    out = ClArray(n, np.float32, read=False, write=True)
    start = 0
    el: dict = {"phase": args.phase}
    if args.phase == "rejoin":
        state = acc.resume_elastic(args.ckpt_root, LOCAL_RANGE, total=n)
        if state is None:
            raise RuntimeError(f"rejoin found no checkpoint under {args.ckpt_root}")
        start = state["window"]
        accum[:] = state["arrays"]["acc"]
        m = state["membership"]
        el.update(resumed_from=start, member_steps_before=state["member_steps"],
                  epoch=m.epoch, members=m.snapshot()["members"])
    else:
        el["epoch"] = acc.establish_membership(LOCAL_RANGE).epoch
    el["member_steps"] = [c * LOCAL_RANGE for c in acc.proc_device_counts]
    for w in range(start + 1, args.windows + 1):
        acc.compute("mandelbrot", [out], WINDOW_CID, n, LOCAL_RANGE,
                    values=window_values(w, args.width, args.max_iter))
        accum += out.host()
        acc.checkpoint_window(args.ckpt_root, w, {"acc": accum}, LOCAL_RANGE)
        acc.barrier(f"ckpt_{w}")
        el.setdefault("shares", []).append(acc.ranges_of(WINDOW_CID))
        el["last_window"] = w
        if args.phase == "first" and w >= args.kill_after:
            rep["elastic"] = el
            _finish_report(rep)
            print(RESULT + json.dumps(rep, allow_nan=False), flush=True)
            os._exit(EXIT_PREEMPTED)  # the preemption: no cleanup whatsoever
    rows = [r.to_row() for r in DECISIONS.snapshot()]
    kinds = sorted({r["kind"] for r in rows})
    verdict = verify_records(rows)
    el.update(digest=digest(accum), decision_kinds=kinds,
              replay_ok=verdict["ok"], replayed=verdict["replayed"])
    rep["elastic"] = el


def _finish_report(rep: dict) -> None:
    from ..kernel import cuda_backend, registry
    from ..kernel.build import BUILDS

    rep["launches"] = dict(cuda_backend.LAUNCHES.by_key)
    rep["routes"] = dict(registry.launch_counts)
    rep["builds"] = dict(BUILDS.by_key)
    rep["exchange"] = _exchange_report()


def worker(args) -> dict:
    """One rank's whole run; returns its report."""
    import torch.distributed as dist

    from ..cluster.dcn import DistributedAccelerator, initialize
    from ..trace.spans import TRACER
    from ..workloads import MANDELBROT_SRC

    lanes = [int(c) for c in args.lanes.split(",")]
    initialize(args.coordinator, args.procs, args.worker, timeout_s=args.timeout)
    acc = DistributedAccelerator(local_devices=_lanes(args.cpu, lanes[args.worker]))
    rep: dict = {"pid": acc.pid, "nproc": acc.nproc,
                 "device": acc.local_devices[0].kind, "lanes": len(acc.local_devices)}
    try:
        TRACER.enable(clear=True)
        acc.setup_nodes(MANDELBROT_SRC)
        rep["proc_device_counts"] = acc.proc_device_counts
        if args.calls:
            _balanced_calls(acc, args, rep)
        _exchange_check(acc, rep)
        _gather(acc, rep)
        if args.windows:
            _elastic(acc, args, rep)
        _finish_report(rep)
    finally:
        acc.dispose()
    dist.destroy_process_group()
    return rep


# -- the parent --------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_args(args) -> list[str]:
    """The flags a worker gets from the parent's ``args``."""
    out = ["--procs", str(args.procs), "--lanes", args.lanes, "--width", str(args.width),
           "--max-iter", str(args.max_iter), "--calls", str(args.calls),
           "--windows", str(args.windows), "--kill-after", str(args.kill_after),
           "--phase", args.phase, "--timeout", str(args.timeout)]
    if args.cpu:
        out.append("--cpu")
    if args.ckpt_root:
        out += ["--ckpt-root", args.ckpt_root]
    return out


def parse(argv: list[str] | None) -> argparse.Namespace:
    args = parser().parse_args(argv)
    if args.lanes is None:
        args.lanes = ",".join(["1"] * args.procs)
    if len(args.lanes.split(",")) != args.procs:
        raise SystemExit(f"--lanes {args.lanes!r} does not give one count a rank")
    if args.windows and not args.ckpt_root:
        raise SystemExit("--windows needs --ckpt-root")
    return args


def run_job(argv: list[str], env: dict | None = None, timeout: float = 120.0) -> dict:
    """Launch the workers of one job (``argv`` as on this tool's command line,
    without ``--worker``/``--coordinator``) and wait for them, ``timeout``
    seconds in all.  Returns ``{"rcs", "reports", "outputs", "seconds"}``:
    each rank's exit code (None when it had to be killed), its report (None
    without a report line) and the tail of its output."""
    args = parse(argv)
    coordinator = f"127.0.0.1:{free_port()}"
    child_env = {**os.environ, **(env or {})}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cekirdekler_tpu_torch.tools.dcn_cluster",
             "--worker", str(pid), "--coordinator", coordinator, *worker_args(args)],
            cwd=ROOT, env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(args.procs)
    ]
    outs: list[str] = []
    rcs: list[int | None] = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=30)
                out += f"\n[killed after the job's {timeout} s]"
            outs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    reports = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        reports.append(json.loads(lines[-1][len(RESULT):]) if lines else None)
    return {"rcs": rcs, "reports": reports, "outputs": [o[-4000:] for o in outs],
            "seconds": time.perf_counter() - t0}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", type=int, default=None, help="this process's rank")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--coordinator", default=None, help="host:port of the rendezvous")
    ap.add_argument("--lanes", default=None,
                    help="lanes a rank, comma-separated (default 1 each)")
    ap.add_argument("--cpu", action="store_true", help="host lanes instead of the card")
    ap.add_argument("--width", type=int, default=2048, help="image width and height")
    ap.add_argument("--max-iter", type=int, default=256)
    ap.add_argument("--calls", type=int, default=8, help="timed balanced calls")
    ap.add_argument("--windows", type=int, default=0)
    ap.add_argument("--kill-after", type=int, default=0)
    ap.add_argument("--phase", choices=("first", "rejoin"), default="first")
    ap.add_argument("--ckpt-root", default=None)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the job (and for each collective)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    if args.worker is not None:
        if args.coordinator is None:
            raise SystemExit("a worker needs --coordinator host:port")
        rep = worker(args)
        print(RESULT + json.dumps(rep, allow_nan=False), flush=True)
        return 0
    job = run_job(worker_args(args), timeout=args.timeout + 60.0)
    print(json.dumps(job["reports"], indent=1))
    bad = [i for i, rc in enumerate(job["rcs"]) if rc != 0]
    for i in bad:
        print(f"rank {i} exited {job['rcs'][i]}:\n{job['outputs'][i]}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
