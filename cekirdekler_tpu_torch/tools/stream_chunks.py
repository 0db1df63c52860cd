"""What a chunk of the stream engine costs on one GPU lane: streamed calls
of ``compute()`` at pinned chunk counts beside the monolithic call, with
each chunk dispatched on the caller's thread (the engine's way on a GPU
lane) and through a driver thread of the lane's own (the reference's
shape: a ``_DriverQueue`` thread that runs each chunk's commit, launch and
D2H issue), in turns A B B A.

Cases: the emitted mandelbrot at 2048x2048x256 (no upload; a 16 MiB image
read back) and streamAdd at 2^24 floats with page-locked (``fast``) and
pageable arrays (the engine stages pageable chunks through its
page-locked ring).  Per row the median and least host wall of ``--reps``
calls after three untimed ones, on a new cruncher a row.  Needs a CUDA
device.  From the repository root::

    python -m cekirdekler_tpu_torch.tools.stream_chunks [--reps 20] [--chunks 2,4,8]
        [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _threaded(w) -> None:
    """Route the lane's chunk closures through a driver thread of its own."""
    from ..core.worker import _DriverQueue

    q = _DriverQueue(f"ck-stream-thread-{w.index}")

    def submit(fn, depth=2, preflighted=False):
        def run():
            with w.on_stream():
                fn()

        q.submit(run, depth, preflighted=preflighted)

    w.stream_dispatch_async = submit
    w.drain_stream_dispatch = q.drain
    w._stream_thread = q


def _cases(ck, wl):
    import numpy as np

    vals = (-2.0, -1.25, 2.5 / 2048, 2.5 / 2048, 2048, 256)
    n = 1 << 24

    def image():
        return [ck.ClArray(2048 * 2048, np.float32, name="img", read=False, write=True,
                           fast=True)]

    def stream(fast: bool):
        def arrays():
            if fast:
                a, b = (ck.ClArray(n, np.float32, name=k, fast=True, partial_read=True,
                                   read_only=True) for k in "ab")
                a.host()[:] = 1.0
                b.host()[:] = 2.0
            else:
                a, b = (ck.ClArray(np.full(n, v, np.float32), name=k, partial_read=True,
                                   read_only=True) for k, v in (("a", 1.0), ("b", 2.0)))
            return [a, b, ck.ClArray(n, np.float32, name="c", fast=fast, write_only=True)]
        return arrays

    return [("mandelbrot 2048x2048x256", wl.MANDELBROT_SRC, "mandelbrot", vals, image,
             2048 * 2048),
            ("streamAdd 2^24, page-locked", wl.STREAM_SRC, "streamAdd", (), stream(True), n),
            ("streamAdd 2^24, pageable", wl.STREAM_SRC, "streamAdd", (), stream(False), n)]


def _row(ck, gpus, case, driver: str, chunks: int, reps: int) -> dict:
    import numpy as np

    label, src, kname, vals, arrays, n = case
    arrs = arrays()
    group = arrs[0].next_param(*arrs[1:]) if len(arrs) > 1 else arrs[0]
    with ck.NumberCruncher(gpus.subset(1), src) as cr:
        w = cr.cores.workers[0]
        if driver == "thread":
            _threaded(w)
        cr.streamed_transfers = driver != "monolithic"
        cr.stream_chunks = chunks
        for _ in range(3):
            group.compute(cr, 1, kname, n, 256, values=vals)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            group.compute(cr, 1, kname, n, 256, values=vals)
            walls.append((time.perf_counter() - t0) * 1e3)
        if driver == "thread":
            w._stream_thread.close()
    return {"case": label, "driver": driver, "chunks": chunks,
            "median_ms": float(np.median(walls)), "min_ms": min(walls)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls a row")
    ap.add_argument("--chunks", default="2,4,8", help="comma-separated chunk counts")
    ap.add_argument("--json", action="store_true", help="print the rows as one JSON line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stream_chunks needs a CUDA device", file=sys.stderr)
        return 2
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    gpus = ck.all_devices().gpus()
    counts = [int(c) for c in args.chunks.split(",")]
    rows = []
    for case in _cases(ck, wl):
        for driver in ("monolithic", "inline", "thread", "thread", "inline", "monolithic"):
            for chunks in ((0,) if driver == "monolithic" else counts):
                rows.append(_row(ck, gpus, case, driver, chunks, args.reps))
    if args.json:
        print(json.dumps(rows))
        return 0
    print(f"{torch.cuda.get_device_name(0)}: host ms of one compute() call, median (least) of "
          f"{args.reps}; A B B A by dispatch")
    for r in rows:
        what = "monolithic" if r["driver"] == "monolithic" else f"{r['chunks']} chunks, {r['driver']}"
        print(f"{r['case']:30s} {what:22s} {r['median_ms']:9.3f} ({r['min_ms']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
