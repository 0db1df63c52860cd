"""Whether a ``torch.profiler`` trace keeps a true record of every launch.

Traces ``--reps`` calls of one kernel at a time, with the CPU and CUDA
activities on, in windows of five kinds: bare (the profiler entered right
before the first call and left right after the synchronize that ends the
last); with ``--pad`` seconds of idle host time inside the window at both
ends; with a lead kernel (``torch.cuda._sleep``, launched and waited for
inside the window before the calls); with a trail kernel (launched
after the calls, before the synchronize); and as ``trace_window`` opens a
window and reads it, the lead kernels' records left out (``window``, with
CUDA activities only:
each record's device µs, ``window_ms``: ``trace_window.per_call_ms`` of
the kernel, or the error it raised, ``event_ms``: CUDA events over the
same number of calls right after).  Each kind runs ``--trials``
times, the kinds in turns.  The kernels: the ring's forward parts at one
full 1x2048x8x64 bf16 "highest" step, on the split tensor-core kernel and
on the FP32 one (launches read from ``PARTS_LAUNCHES``), and ``torch.add``
over two 2^24 f32 arrays (one PyTorch kernel a call).

Prints the card's name and power limit, then one JSON line: per kernel and
window kind, each trial's launches made, the runtime's launch records, the
kernel records kept, and each kept record's start (µs after the first
launch record) and device µs.  Needs a CUDA device.  From the repository
root::

    python -m cekirdekler_tpu_torch.tools.trace_records [--reps 10] [--trials 4] [--pad 0.05]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import trace_window


def _trace(fn, reps: int, kind: str, pad: float, name: str, counter=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = counter.count if counter is not None else 0
    if kind == "window":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_window.open_window()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = counter.count - before if counter is not None else reps
        try:
            ms = trace_window.per_call_ms(prof, reps, (name,))[name]
            durs = [us for key, us in trace_window.kernel_records(prof) if name in key]
        except trace_window.TraceDefect as exc:
            ms, durs = str(exc), []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"launched": launched, "kept": len(durs), "window_ms": ms,
                "event_ms": start.elapsed_time(end) / reps, "records_us": durs}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if kind == "pad":
            time.sleep(pad)
        elif kind == "lead_kernel":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        if kind == "trail_kernel":
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if kind == "pad":
            time.sleep(pad)
    launched = counter.count - before if counter is not None else reps
    kernels, launches = [], []
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            if name in evt.name:
                kernels.append((evt.time_range.start, evt.time_range.elapsed_us()))
        elif "LaunchKernel" in evt.name:
            launches.append(evt.time_range.start)
    launches.sort()
    kernels.sort()
    t0 = launches[0] if launches else 0.0
    return {"launched": launched, "launch_records": len(launches), "kept": len(kernels),
            "launch_at_us": [t - t0 for t in launches],
            "kernels_at_us": [[s - t0, d] for s, d in kernels]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--pad", type=float, default=0.05)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trace_records: no CUDA device", file=sys.stderr)
        return 2
    from ..ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    T = 2048
    g = torch.Generator().manual_seed(2026)
    q, k, v = (torch.randn(1, T, 8, 64, generator=g).to(torch.bfloat16).cuda()
               for _ in range(3))
    a, b = (torch.randn(1 << 24, generator=g).cuda() for _ in range(2))
    cases = {
        "parts_tc3": (lambda: fa._launch_parts(q, k, v, 5 * T, 2 * T, True, "highest", "tc3"),
                      "fa_fwd_parts", fa.PARTS_LAUNCHES),
        "parts_fp32": (lambda: fa._launch_parts(q, k, v, 5 * T, 2 * T, True, "highest", "fp32"),
                       "fa_fwd_parts", fa.PARTS_LAUNCHES),
        "torch_add": (lambda: torch.add(a, b), "CUDAFunctor_add", None),
    }
    kinds = ("bare", "pad", "lead_kernel", "trail_kernel", "window")
    res = {name: {kind: [] for kind in kinds} for name in cases}
    for _ in range(args.trials):
        for name, (fn, prefix, counter) in cases.items():
            for kind in kinds:
                res[name][kind].append(_trace(fn, args.reps, kind, args.pad, prefix, counter))
    print(card)
    print(json.dumps({"card": card, "reps": args.reps, "pad_s": args.pad,
                      "torch": torch.__version__, "cases": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
