"""Streamed-transfer chunk sweep: chunk counts x array sizes through the
streamed path of ``compute()`` on one lane, the transfer tuner's own
choice printed against the sweep's best (``workloads.overlap_chunk_sweep``;
the port's counterpart of ``tools/overlap_sweep.py``).

Per size: the median wall of a streamed ``c = a + iters·b/4`` call at
each pinned chunk count (1 is the monolithic path), the measured best,
and the count the tuner chooses after the sweep taught it the lane
(``choice_vs_optimum`` 1.0 = the tuner found the measured best).  Needs a
CUDA device (``--cpu`` runs it on a host lane instead).  From the
repository root::

    python -m cekirdekler_tpu_torch.tools.overlap_sweep [--ns 1048576,4194304]
        [--chunks 1,2,4,8,16,32] [--reps 3] [--iters 400] [--local 256] [--json]
"""

from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", default="1048576,4194304", help="comma-separated f32 lengths")
    ap.add_argument("--chunks", default="1,2,4,8,16,32", help="comma-separated chunk counts")
    ap.add_argument("--reps", type=int, default=3, help="timed calls a point (median kept)")
    ap.add_argument("--iters", type=int, default=400,
                    help="heavy-kernel iterations an element (0: the plain add)")
    ap.add_argument("--local", type=int, default=256, help="local range")
    ap.add_argument("--cpu", action="store_true", help="run on a host lane")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON line")
    args = ap.parse_args(argv)

    from .. import all_devices
    from ..workloads import overlap_chunk_sweep

    try:
        out = overlap_chunk_sweep(all_devices().cpus(1) if args.cpu else None,
                                  ns=tuple(int(v) for v in args.ns.split(",")),
                                  chunk_counts=tuple(int(v) for v in args.chunks.split(",")),
                                  local_range=args.local, reps=args.reps,
                                  heavy_iters=args.iters)
    except ValueError as e:
        ap.error(str(e))
    if args.json:
        print(json.dumps(out))
        return 0
    print(out["note"])
    for size in out["sizes"]:
        rows = ", ".join(f"{r['chunks']}: {r['wall_ms']:.3f}" for r in size["rows"])
        print(f"n={size['n']} ({size['mib']} MiB moved): {rows} ms; best "
              f"{size['sweep_best_chunks']} chunks ({size['sweep_best_ms']:.3f} ms); tuner "
              f"{size['autotuner_chunks']} chunks ({size['autotuner_ms']:.3f} ms), "
              f"{size['choice_vs_optimum']:.3f}x the best")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
