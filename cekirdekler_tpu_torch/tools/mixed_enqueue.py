"""How often ``chip_smoke.py``'s GPU + host-lane enqueue phase (phase 4d)
sees a barrier move a range: the phase's two runs (mandelbrot
1024x1024x64, 24 calls, and the ``@kernel`` saxpy at 2^20, 32 calls, a
barrier every 4 calls) ``--reps`` times in one process, from the checkout
at ``--root`` (default: this one), printing each repeat's moves and how
many repeats moved nothing.  With ``--stall-ms`` the GPU lane's barrier
fence is stalled that long by the fault plane (``lane-stall``, as the
phase now does) and the tool also counts the repeats in which no barrier
moved range away from the stalled lane (the phase's gate fails on
those); a checkout without the fault plane runs with ``--stall-ms 0``.
Run it on two checkouts in turns, A B B A, to compare them.  Needs a
CUDA device.  From the repository root::

    python3 cekirdekler_tpu_torch/tools/mixed_enqueue.py [--root DIR] [--reps 8] [--stall-ms 20]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--root", default=here, help="checkout whose package and chip_smoke.py run")
    ap.add_argument("--reps", type=int, default=8, help="repeats of the phase")
    ap.add_argument("--stall-ms", type=float, default=0.0,
                    help="stall the GPU lane's barrier fence this long (0: no stall)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mixed_enqueue needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    lanes = ck.all_devices().gpus().subset(1) + ck.all_devices().cpus(1)
    faults = None
    if args.stall_ms > 0:
        from cekirdekler_tpu_torch.utils.faultinject import FAULTS as faults

        faults.arm(f"lane-stall@lane0:delay_ms={args.stall_ms}")
    moves, away = [], []
    try:
        for _ in range(args.reps):
            r = wl.run_mandelbrot(lanes, 1024, 1024, 64, iters=24, warmup=0, local_range=256,
                                  keep_image=True, readback="final", sync_every=4)
            run = chip_smoke.enqueue_saxpy(ck, wl, lanes, 1 << 20, 32, sync_every=4)
            moves.append((chip_smoke.gate_moves(r.ranges_per_iter, 4),
                          chip_smoke.gate_moves(run["ranges"], 4)))
            away.append(sum(sum(1 for a, b in zip(rg, rg[1:]) if b[0] < a[0])
                            for rg in (r.ranges_per_iter, run["ranges"])))
    finally:
        if faults is not None:
            faults.disarm()
    print(f"{root} (stall {args.stall_ms} ms): moves (mandelbrot, saxpy) per repeat {moves}; "
          f"repeats that moved nothing {sum(1 for a, b in moves if a + b == 0)} of "
          f"{args.reps}; moves away from lane 0 per repeat {away}; repeats with none "
          f"{sum(1 for x in away if x == 0)} of {args.reps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
