"""Where an enqueued ``compute()`` spends its host time: a ``cProfile`` of
the enqueue-mode saxpy path.

Runs ``workloads.saxpy_kernel`` (the ``@kernel`` over the elementwise
kernel) through ``ClArray.compute`` on the first CUDA lane in enqueue
mode, 2^24 floats at local range 256: one untraced call (uploads, first
launch), then ``--calls`` calls under ``cProfile``, then the barrier.
``--fused on`` (the default, as ``NumberCruncher``'s) lets the calls
after the second defer into a fused window, dispatched as CUDA-graph
replays; ``--fused off`` dispatches every call.  Prints the mean host wall
of a profiled call, the fused window counts, and the functions with the
most own time.  ``cProfile`` adds a cost to every Python call, so the
shares are read as candidates, the walls as upper bounds.  Needs a CUDA
device.  From the repository root::

    python -m cekirdekler_tpu_torch.tools.profile_enqueue [--calls 64] [--top 20] [--fused on|off]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=64)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--fused", choices=("on", "off"), default="on",
                    help="fused-iteration dispatch (default on)")
    args = ap.parse_args(argv)

    import numpy as np

    from .. import ClArray, NumberCruncher, all_devices, workloads

    lanes = all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    n = 1 << 24
    x = ClArray(np.ones(n, np.float32), name="x", read_only=True, fast=True)
    y = ClArray(np.zeros(n, np.float32), name="y", fast=True)
    group = x.next_param(y)
    with NumberCruncher(lanes, workloads.saxpy_kernel()) as cr:
        cr.fused_dispatch = args.fused == "on"
        cr.enqueue_mode = True
        group.compute(cr, 1, "saxpy", n, 256, values=(0.5,))
        cr.barrier()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(args.calls):
            group.compute(cr, 1, "saxpy", n, 256, values=(0.5,))
        prof.disable()
        wall_ms = (time.perf_counter() - t0) * 1e3
        cr.barrier()
        cr.enqueue_mode = False
        stats = dict(cr.fused_stats)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.top)
    print(f"{args.calls} enqueued calls under cProfile, fused {args.fused}: "
          f"{wall_ms / args.calls:.4f} ms a call; fused_stats {stats}")
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
