"""What an enqueued call costs the host, per enqueue-window size K, per call
and with fused-iteration dispatch (``workloads.dispatch_floor_sweep``): the
port's counterpart of ``tools/dispatch_floor.py``.

Per row: the window's wall, the barrier's wall, ``per_dispatch_ms`` =
(window wall - barrier wall) / K, and the evidence of how the calls were
dispatched: kernel launches counted, CUDA-graph replays, fused windows.
Beside them, the lane's round trip (one tiny op and a 4-byte readback).
Needs a CUDA device (``--cpu`` runs it on a host lane instead).  From the
repository root::

    python -m cekirdekler_tpu_torch.tools.dispatch_floor [--ks 1,8,32,128] [--n 16384]
        [--reps 3] [--json]
"""

from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="1,8,32,128", help="comma-separated window sizes")
    ap.add_argument("--n", type=int, default=1 << 14, help="light-kernel array length")
    ap.add_argument("--reps", type=int, default=3, help="windows per row (best kept)")
    ap.add_argument("--local", type=int, default=256, help="local range")
    ap.add_argument("--cpu", action="store_true", help="run on a host lane")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON line")
    args = ap.parse_args(argv)

    from .. import all_devices
    from ..workloads import dispatch_floor_sweep

    ks = tuple(int(k) for k in args.ks.split(","))
    out = dispatch_floor_sweep(all_devices().cpus(1) if args.cpu else None, ks=ks, n=args.n,
                               local_range=args.local, reps=args.reps)
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"{out['device_name']}: n={out['n']}, best of {out['reps']} windows a row; "
          f"per-dispatch = (window wall - barrier wall) / K; round trip {out['rtt_ms']:.4f} ms")
    print(f"{'mode':>9} {'K':>5} {'wall ms':>10} {'barrier ms':>11} {'per-dispatch ms':>16} "
          f"{'launches':>9} {'replays':>8} {'windows':>8}")
    for r in out["rows"]:
        print(f"{'fused' if r['fused'] else 'per-call':>9} {r['K']:>5} {r['wall_ms']:>10.4f} "
              f"{r['barrier_ms']:>11.4f} {r['per_dispatch_ms']:>16.5f} {r['launches']:>9} "
              f"{r['graph_replays']:>8} {r['fused_windows']:>8}")
    if "floor_collapse_at_kmax" in out:
        print(f"per-call / fused per-dispatch at K={max(ks)}: {out['floor_collapse_at_kmax']:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
