"""What the observability hooks and the stream engine's bookkeeping cost a
call's host time, on the first CUDA lane.

Four measurements on one cruncher each, A and B interleaved call by
call in the pattern A B B A (``--calls`` calls of each, after warm
calls), so a drift of the host's pace falls on both alike:

1. per-call mandelbrot 2048x2048x256 at local range 256 (the headline call,
   ``readback="every"``): A with the port's planes at their defaults (the
   metrics registry, flight recorder and decision log on, the tracer off,
   no fault plan), B with all of them off.  A call's host time is its wall
   less the time its lane waits in ``Worker.fence`` (the kernel and the
   image's D2H), timed by a wrapper the tool puts on the lane;
2. the deferred call: the ``@kernel`` saxpy at 2^24 floats in enqueue mode,
   calls 3 to ``--deferred`` + 2 of each window deferred into a fused
   window (a host wall each; no device wait), defaults against all off;
3. streamed against monolithic: the same mandelbrot call with
   ``streamed_transfers`` on (A; the tuner keeps the call whole, one
   chunk) and off (B), and on with the metrics registry, flight recorder
   and decision log off (C), in turns A B C C B A, with the tracer on in
   all three, splitting each call's host time
   into the lane's launch issue and download issue (their spans), the
   stream engine's decision (``Cores._run_streamed`` when it hands the
   call back) and its observation (``Cores._note_transfer``: the lane's
   transfer bench and the tuner's ``observe``), both timed by wrappers,
   the fence wait, and the rest;
4. the kernel verify gate: measurement 1's call with ``CK_KERNEL_VERIFY``
   as the environment leaves it (A; unset is ``advisory``, a verdict
   looked up a call) against ``off`` (B), the planes at their defaults.

Prints one line per measurement with medians in microseconds, and one
JSON line of everything.  Needs a CUDA device.  From the repository
root::

    python -m cekirdekler_tpu_torch.tools.profile_hooks [--calls 200] [--deferred 62]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

W = H = 2048
MAX_ITER = 256
CID = 7001


def _planes(on: bool) -> None:
    from ..metrics.registry import REGISTRY
    from ..obs.decisions import DECISIONS
    from ..obs.flight import FLIGHT

    REGISTRY.enabled = FLIGHT.enabled = DECISIONS.enabled = on


def _timed_fences(cr) -> list[float]:
    """Wrap each lane's ``fence`` to add its seconds to the returned list's
    last slot (the caller appends a slot per call)."""
    waits: list[float] = [0.0]
    for w in cr.cores.workers:
        inner = w.fence

        def fence(inner=inner) -> None:
            t0 = time.perf_counter()
            try:
                inner()
            finally:
                waits[-1] += time.perf_counter() - t0

        w.fence = fence
    return waits


def _med_us(xs: list[float]) -> float:
    return round(statistics.median(xs) * 1e6, 2)


def _pattern(calls: int, labels: str = "AB") -> str:
    """``calls`` of each label, in turns forward then back (A B B A)."""
    return (labels + labels[::-1]) * ((calls + 1) // 2)


def _blocks(samples: dict) -> list[dict]:
    """Per label, the median of each measured column (microseconds)."""
    return [{"block": label, **{k: _med_us(v) for k, v in cols.items()}}
            for label, cols in samples.items()]


def _verify_gate(mode: str | None) -> None:
    """Set ``CK_KERNEL_VERIFY`` (None: unset, the gate's default)."""
    if mode is None:
        os.environ.pop("CK_KERNEL_VERIFY", None)
    else:
        os.environ["CK_KERNEL_VERIFY"] = mode


def per_call(ck, wl, lanes, calls: int, switch=None) -> dict:
    """The headline call, A against B; ``switch(label)`` sets the label's
    state before each call (default: the planes on for A, off for B)."""
    import numpy as np

    switch = switch or (lambda label: _planes(label == "A"))
    out = ck.ClArray(W * H, np.float32, name="mandel_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, MAX_ITER)
    samples = {"A": {"host_us": [], "wall_us": []}, "B": {"host_us": [], "wall_us": []}}
    with ck.NumberCruncher(lanes, wl.MANDELBROT_SRC) as cr:
        waits = _timed_fences(cr)
        for _ in range(5):
            out.compute(cr, CID, "mandelbrot", W * H, 256, values=vals)
        for label in _pattern(calls):
            switch(label)
            waits.append(0.0)
            t0 = time.perf_counter()
            out.compute(cr, CID, "mandelbrot", W * H, 256, values=vals)
            dt = time.perf_counter() - t0
            samples[label]["wall_us"].append(dt)
            samples[label]["host_us"].append(dt - waits[-1])
    _planes(True)
    return {"blocks": _blocks(samples)}


def verify_gate(ck, wl, lanes, calls: int) -> dict:
    """The headline call with the kernel verify gate as the environment
    leaves it (A; advisory by default) against ``CK_KERNEL_VERIFY=off``
    (B), the planes at their defaults."""
    mode = os.environ.get("CK_KERNEL_VERIFY")
    try:
        res = per_call(ck, wl, lanes, calls,
                       switch=lambda label: _verify_gate(mode if label == "A" else "off"))
    finally:
        _verify_gate(mode)
    return {"verify": mode or "advisory", **res}


def deferred(ck, wl, lanes, calls: int, windows: int = 4) -> dict:
    import numpy as np

    n = 1 << 24
    x = ck.ClArray(np.ones(n, np.float32), name="x", read_only=True, fast=True)
    y = ck.ClArray(np.zeros(n, np.float32), name="y", fast=True)
    group = x.next_param(y)
    samples = {"A": {"host_us": []}, "B": {"host_us": []}}
    with ck.NumberCruncher(lanes, wl.saxpy_kernel()) as cr:
        cr.enqueue_mode = True
        for _ in range(windows):
            for k, label in enumerate("AB" + _pattern(calls)):
                _planes(label == "A")
                t0 = time.perf_counter()
                group.compute(cr, 1, "saxpy", n, 256, values=(0.5,))
                if k >= 2:
                    samples[label]["host_us"].append(time.perf_counter() - t0)
            cr.barrier()
        cr.enqueue_mode = False
        stats = dict(cr.fused_stats)
    _planes(True)
    return {"blocks": _blocks(samples), "fused_stats": stats}


def streamed_split(ck, wl, lanes, calls: int) -> dict:
    import numpy as np

    from ..trace.spans import TRACER

    out = ck.ClArray(W * H, np.float32, name="mandel_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, MAX_ITER)
    cols = ("wall_us", "fence_us", "launch_us", "download_us", "stream_decision_us",
            "stream_observe_us", "rest_us")
    samples = {label: {c: [] for c in cols} for label in "ABC"}
    with ck.NumberCruncher(lanes, wl.MANDELBROT_SRC) as cr:
        waits = _timed_fences(cr)
        decide: list[float] = [0.0]
        chunks = None
        inner = cr.cores._run_streamed

        def run_streamed(*a, **k):
            t0 = time.perf_counter()
            res = inner(*a, **k)
            if not res[0]:
                decide[-1] += time.perf_counter() - t0
            return res

        cr.cores._run_streamed = run_streamed
        observe: list[float] = [0.0]
        note = cr.cores._note_transfer

        def note_transfer(*a, **k):
            t0 = time.perf_counter()
            try:
                return note(*a, **k)
            finally:
                observe[-1] += time.perf_counter() - t0

        cr.cores._note_transfer = note_transfer
        for _ in range(5):
            out.compute(cr, CID, "mandelbrot", W * H, 256, values=vals)
        TRACER.enable(capacity=1 << 18)
        try:
            for label in _pattern(calls, "ABC"):
                cr.streamed_transfers = label != "B"
                _planes(label != "C")
                waits.append(0.0)
                decide.append(0.0)
                observe.append(0.0)
                t_lo = time.perf_counter()
                out.compute(cr, CID, "mandelbrot", W * H, 256, values=vals)
                t_hi = time.perf_counter()
                spans = TRACER.spans_between(t_lo, t_hi)
                launch = sum(s.t1 - s.t0 for s in spans if s.kind == "launch")
                down = sum(s.t1 - s.t0 for s in spans if s.kind in ("download", "download-chunk"))
                wall = t_hi - t_lo
                row = (wall, waits[-1], launch, down, decide[-1], observe[-1],
                       wall - waits[-1] - launch - down - decide[-1] - observe[-1])
                for c, v in zip(cols, row):
                    samples[label][c].append(v)
                TRACER.clear()
            chunks = cr.cores.last_stream_chunks.get(0)
        finally:
            TRACER.disable()
            TRACER.clear()
            cr.streamed_transfers = True
            _planes(True)
    return {"blocks": _blocks(samples), "streamed": "A, C (planes off)",
            "tuner_chunks": chunks}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200, help="calls a block")
    ap.add_argument("--deferred", type=int, default=62,
                    help="deferred calls a window (after its first two)")
    args = ap.parse_args(argv)

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("profile_hooks needs a CUDA device")
        return 2
    from .. import all_devices
    from .. import workloads as wl
    import cekirdekler_tpu_torch as ck

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    lanes = all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    res = {"card": card,
           "per_call": per_call(ck, wl, lanes, args.calls),
           "deferred": deferred(ck, wl, lanes, args.deferred),
           "streamed_split": streamed_split(ck, wl, lanes, args.calls),
           "verify_gate": verify_gate(ck, wl, lanes, args.calls)}
    for name in ("per_call", "deferred", "streamed_split", "verify_gate"):
        print(f"{name} ({card}): " + "; ".join(
            " ".join(f"{k}={v}" for k, v in b.items()) for b in res[name]["blocks"]))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
