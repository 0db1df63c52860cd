"""Where ring attention's time goes on the card: a ``torch.profiler`` trace.

Runs ``workloads.run_ring_attention`` once untraced at 1x1024 (warm-up),
then traces one forward + backward at ``--T`` (default 16384) x 8 heads x
64, bf16, causal, over an ``sp`` mesh of ``--sp`` virtual shards of
``cuda:0``.  Prints the traced wall time, the device time summed over the
trace's kernels and copies, the device's busy share of the wall (an upper
bound: overlapping activities count once each), and the top device
activities by time.  Needs a CUDA device.  From the repository root::

    python -m cekirdekler_tpu_torch.tools.profile_ring [--T 16384] [--sp 8] [--top 10]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from .trace_window import by_name, open_window


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=16384)
    ap.add_argument("--sp", type=int, default=8)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import parallel
    from ..workloads import run_ring_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    mesh = parallel.make_mesh([torch.device("cuda", 0)] * args.sp, sp=args.sp)
    run_ring_attention(mesh, 1, 1024, 8, 64, torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window()
        t0 = time.perf_counter()
        r = run_ring_attention(mesh, 1, args.T, 8, 64, torch.bfloat16, seed=5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = by_name(prof)
    busy_ms = sum(row[1] for row in rows)
    print(card)
    print(json.dumps({
        "ring": f"1x{args.T}x8x64 bf16 causal, sp={args.sp} virtual shards of cuda:0",
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "events_forward_ms": r["seconds"]["forward"] * 1e3,
        "events_forward_backward_ms": r["seconds"]["forward_backward"] * 1e3,
        "launches": r["launches"],
        "top": [{"name": k[:80], "ms": ms, "count": n} for k, ms, n in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
