"""Where a pipelined call's time goes on one GPU lane, and the main path's
streamAdd rate, for two checkouts in turns.

``stream`` runs ``workloads.run_stream`` as ``chip_smoke.py``'s main path
runs it (2^24 page-locked floats, 3 reps, the best rep's GB/s) after one
untimed run, ``--repeat`` times, and prints the rates and which path the
checkout's ``run_stream`` takes.  ``--root DIR`` imports the package from
the checkout at DIR, so two checkouts compare on one card in one call, in
turns (A, B, B, A).

``mandelbrot`` takes the GPU lane alone at 2048x2048x256, by the emitted
escape form and by the hand kernel (``csrc/mandelbrot.cu``), and prints
for ``compute()`` plain and pipelined (8 blobs, the EVENT engine): the
host wall a call (median and least of ``--reps`` calls, in turns A B B
A), the kernel launches and graph captures and replays a call, the
port's host spans a call by kind (``launch``, ``download``,
``pipeline-stage``), and from a ``torch.profiler`` window of five calls:
the device's busy time a call (kernels and copies, overlaps counted
once), its idle share of the wall, the device activities a call, and
the host's CUDA runtime calls a call by name (kernel launches, event
records and waits, synchronizations) with their host µs; then a
``cProfile`` of ``--reps`` more calls: the package's functions with the
most cumulative host ms a call and the functions of any module with the
most self ms (the profiler's own cost included).  Needs a CUDA device.
From the repository root::

    python cekirdekler_tpu_torch/tools/pipeline_trace.py stream [--root DIR] [--repeat 5]
    python cekirdekler_tpu_torch/tools/pipeline_trace.py mandelbrot [--reps 20]
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

try:
    from . import trace_window
except ImportError:  # run as a script: this directory is on the path
    import trace_window

W = 2048
BLOBS = 8
TRACED_CALLS = 5
TOP = 12  # functions listed from a cProfile


def union_ms(intervals: list[tuple[str, float, float]]) -> float:
    """ms covered by the (name, start µs, end µs) intervals, overlaps once."""
    total, end = 0.0, None
    for _, s, e in sorted(intervals, key=lambda r: r[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def host_functions(call, reps: int, top: int) -> dict:
    """``cProfile`` of ``reps`` calls of ``call()``: the package's ``top``
    functions by cumulative host ms a call, and the ``top`` functions of
    any module by self host ms a call."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        call()
    prof.disable()
    rows = [{"function": f"{Path(fn).name}:{line}:{name}", "calls": nc / reps,
             "self_ms": tt / reps * 1e3, "cum_ms": ct / reps * 1e3, "ours": "cekirdekler" in fn}
            for (fn, line, name), (_, nc, tt, ct, _) in pstats.Stats(prof).stats.items()]
    return {"by_cum": sorted((r for r in rows if r["ours"]), key=lambda r: -r["cum_ms"])[:top],
            "by_self": sorted(rows, key=lambda r: -r["self_ms"])[:top]}


def stream(ck, wl, repeat: int) -> dict:
    lanes = ck.all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    pipelined = "blobs" in inspect.signature(wl.run_stream).parameters
    wl.run_stream(lanes, n=1 << 24, reps=3)
    rates = [wl.run_stream(lanes, n=1 << 24, reps=3)["gb_per_sec"] for _ in range(repeat)]
    return {"path": "pipelined, EVENT, 8 blobs" if pipelined else "plain",
            "gb_per_sec": rates, "median": statistics.median(rates)}


def mandelbrot(ck, wl, reps: int) -> list[dict]:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cekirdekler_tpu_torch.kernel import cuda_backend, graphs
    from cekirdekler_tpu_torch.ops import mandelbrot as mandel_op
    from cekirdekler_tpu_torch.trace.spans import TRACER

    lanes = ck.all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    n = W * W
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, 256)
    want = wl.mandelbrot_host(W, W, *vals[:4], 256)
    rows = []
    for route, hand in (("emitted", False), ("hand kernel", True)):
        src = wl.mandelbrot_cuda_kernel() if hand else wl.MANDELBROT_SRC
        with ck.NumberCruncher(lanes, src) as cr:
            out = ck.ClArray(n, np.float32, name="mandel_out", read=False, write=True,
                             fast=True)

            def call(pipe: bool) -> None:
                out.compute(cr, 7001, "mandelbrot", n, 256, pipeline=pipe,
                            pipeline_blobs=BLOBS, values=vals)

            for pipe in (False, True):
                for _ in range(3):
                    call(pipe)
                if not np.array_equal(out.host(), want):
                    raise AssertionError(f"mandelbrot ({route}, pipeline={pipe}) differs "
                                         f"from mandelbrot_host")
            walls: dict[bool, list[float]] = {False: [], True: []}
            for pipe in (False, True, True, False):
                for _ in range(reps):
                    t0 = time.perf_counter()
                    call(pipe)
                    walls[pipe].append((time.perf_counter() - t0) * 1e3)
            for pipe in (False, True):
                for counter in (cuda_backend.LAUNCHES, mandel_op.LAUNCHES, graphs.GRAPHS):
                    counter.reset()
                TRACER.enable()
                try:
                    for _ in range(reps):
                        call(pipe)
                    spans = TRACER.snapshot()
                finally:
                    TRACER.disable()
                    TRACER.clear()
                launches = sum(cuda_backend.LAUNCHES.by_key.values()) + mandel_op.LAUNCHES.count
                kinds: dict[str, list[float]] = {}
                for s in spans:
                    k = kinds.setdefault(s.kind, [0.0, 0])
                    k[0] += s.dur_ms / reps
                    k[1] += 1 / reps
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    trace_window.open_window()
                    t0 = time.perf_counter()
                    for _ in range(TRACED_CALLS):
                        call(pipe)
                    torch.cuda.synchronize()
                    traced_ms = (time.perf_counter() - t0) * 1e3
                busy = union_ms(trace_window.intervals(prof)) / TRACED_CALLS
                runtime = {e.key: {"calls": e.count / TRACED_CALLS,
                                   "host_us": e.cpu_time_total / TRACED_CALLS}
                           for e in prof.key_averages()
                           if e.key.startswith("cuda") and "_sleep" not in e.key}
                w = sorted(walls[pipe])
                rows.append({
                    "route": route, "pipeline": pipe,
                    "host_ms_median": statistics.median(w), "host_ms_best": w[0],
                    "mpixels_per_s_median": n / statistics.median(w) / 1e3,
                    "launches_a_call": launches / reps,
                    "graphs_a_call": {k: v / reps for k, v in graphs.GRAPHS.by_key.items()},
                    "host_spans_a_call": {k: {"ms": v[0], "count": v[1]}
                                          for k, v in sorted(kinds.items())},
                    "traced_ms_a_call": traced_ms / TRACED_CALLS,
                    "device_busy_ms_a_call": busy,
                    "device_idle_share": 1.0 - busy * TRACED_CALLS / traced_ms,
                    "device_a_call": [{"name": nm, "ms": ms / TRACED_CALLS,
                                       "records": c / TRACED_CALLS}
                                      for nm, ms, c in trace_window.by_name(prof)[:6]],
                    "runtime_a_call": dict(sorted(runtime.items(),
                                                  key=lambda kv: -kv[1]["host_us"])),
                })
                rows[-1]["host_functions_a_call"] = host_functions(
                    lambda: call(pipe), reps, TOP)
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("stream", "mandelbrot"))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.what == "stream":
        res = stream(ck, wl, args.repeat)
        print(json.dumps({"root": str(Path(args.root).resolve()), "card": card, **res}),
              flush=True)
    else:
        mandelbrot(ck, wl, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
