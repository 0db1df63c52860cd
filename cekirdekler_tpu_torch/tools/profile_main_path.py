"""Where the main path's time goes on the card: a ``torch.profiler`` trace.

Runs the mandelbrot main path (``workloads.run_mandelbrot`` on the first
CUDA lane, 2048x2048, max_iter 256, local range 256) by the C-subset
route and by the hand kernel, each for a short traced window after an
untraced warm-up, and prints per route: the window's wall time, the
device time by activity (kernels, copies) summed over the trace, the
device's busy share of the wall (busy / wall; overlapping activities are
counted once each, so this is an upper bound on the share), and the top
device activities.  The busy share is the measure of the host work per
``compute()`` that leaves the card idle: a change to the dispatch path
is read against it.  ``--readback final`` traces the enqueue-mode view
(no readback per iteration, one barrier per iteration).  Needs a CUDA
device.  From the repository root::

    python -m cekirdekler_tpu_torch.tools.profile_main_path [--iters 5] [--readback final]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from .trace_window import by_name, open_window


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--readback", choices=("every", "final"), default="every")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import all_devices, workloads

    lanes = all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for route, hand in (("C-subset", False), ("hand kernel", True)):
        workloads.run_mandelbrot(lanes, iters=2, warmup=1, use_cuda_kernel=hand,
                                 readback=args.readback)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_window()
            t0 = time.perf_counter()
            res = workloads.run_mandelbrot(lanes, iters=args.iters, warmup=0,
                                           use_cuda_kernel=hand, readback=args.readback)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = by_name(prof)
        busy_ms = sum(r[1] for r in rows)
        print(json.dumps({
            "card": card, "route": route, "readback": args.readback, "iters": args.iters,
            "mpixels_per_sec": res.mpixels_per_sec, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:8]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
