"""What fused-iteration windows cost and save on the card.

Four measurements on the first CUDA lane, each printed with the card's
name:

- ``capture``: the emitted ``inc`` over 2^16 floats as a fused ladder of K
  iterations (``KernelProgram.fused_launcher``) through one lane's
  ``LaneGraphs``: the host ms of a key's first run (launch by launch),
  second run (capture, instantiation and replay) and third run (replay),
  and the device ms of a replay by CUDA events;
- ``steady``: the ``@kernel`` saxpy at 2^24 floats, 20 enqueue windows of
  64 calls and a barrier on one cruncher and the same arrays, per call and
  fused, beside 64 times the elementwise kernel's own time (CUDA events);
- ``fresh``: the same saxpy on a new cruncher a run, 63 calls after a warm
  call: the calls' host ms and the barrier's.  With ``--warmup`` only
  this measurement runs, per call and fused, each A B B A: a new cruncher
  as above, then one that ``Cores.warmup`` warmed for the saxpy shape
  first (its ms printed beside), twice, then one as above;
- ``sync12``: mandelbrot 2048x2048x256 by both routes,
  ``readback="final"`` with a barrier every 12 calls, on one cruncher a
  route, per call and fused, in turns.

``capture`` shows what a lane's rule saves, capturing a key at its
second run and not its first: a one-off window pays its first run's
launches and no capture.  ``sync12`` warms each cruncher with one untimed
run first.  Needs a CUDA device.  From the
repository root::

    python -m cekirdekler_tpu_torch.tools.fused_windows [--reps 2] [--warmup]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def capture_costs(dev) -> None:
    import torch

    from ..kernel.graphs import LaneGraphs, buffers_key
    from ..kernel.registry import KernelProgram

    n = 1 << 16
    prog = KernelProgram("__kernel void inc(__global float* a) { int i = get_global_id(0);"
                         " a[i] = a[i] + 1.0f; }")
    fn = prog.fused_launcher(("inc",), 256, n, 256, n, (), platform="cuda")
    stream = torch.cuda.Stream(dev)
    lane = LaneGraphs(dev)
    bufs = (torch.zeros(n, device=dev),)

    def capturable(out):
        return prog.capturable(("inc",), bufs, out)

    with torch.cuda.stream(stream):
        fn(0, n // 256, 1, bufs)  # the kernel's first launch
    stream.synchronize()
    for k in (1, 4, 16, 64):
        key = ("capture", k, buffers_key(bufs))
        host = []
        for _ in range(3):  # launch by launch; capture and replay; replay
            t0 = time.perf_counter()
            lane.run(key, lambda k=k: fn(0, n // 256, k, bufs), bufs, stream, capturable)
            host.append((time.perf_counter() - t0) * 1e3)
            stream.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(10):
            lane.run(key, lambda k=k: fn(0, n // 256, k, bufs), bufs, stream, capturable)
        end.record(stream)
        end.synchronize()
        print(f"capture K={k}: host ms first run (launch by launch) {host[0]:.4f}, second "
              f"(capture + instantiate + replay) {host[1]:.4f}, third (replay) {host[2]:.4f}; "
              f"device ms a replay {start.elapsed_time(end) / 10:.4f}", flush=True)


def _saxpy_arrays(n: int):
    import numpy as np

    from .. import ClArray

    rng = np.random.default_rng(3)
    x = ClArray(rng.standard_normal(n).astype(np.float32), name="x", read_only=True, fast=True)
    y = ClArray(rng.standard_normal(n).astype(np.float32), name="y", partial_read=True,
                fast=True)
    return x, y


def steady(gpus, dev, windows: int = 20) -> None:
    import torch

    from .. import NumberCruncher, workloads
    from ..ops import elementwise as ew

    n = 1 << 24
    a = torch.randn(n, device=dev)
    b = torch.randn(n, device=dev)
    for _ in range(3):
        ew.saxpy(1.5, a, b, out=b)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(64):
        ew.saxpy(1.5, a, b, out=b)
    end.record()
    end.synchronize()
    kernel64 = start.elapsed_time(end)
    for mode in ("per call", "fused"):
        x, y = _saxpy_arrays(n)
        with NumberCruncher(gpus, workloads.saxpy_kernel()) as cr:
            cr.fused_dispatch = mode == "fused"
            cr.enqueue_mode = True
            walls = []
            for _ in range(windows):
                t0 = time.perf_counter()
                for _ in range(64):
                    x.next_param(y).compute(cr, 1, "saxpy", n, 256, values=(1.5,))
                cr.barrier()
                walls.append((time.perf_counter() - t0) * 1e3)
            cr.enqueue_mode = False
        print(f"steady saxpy 2^24, windows of 64 calls + barrier, {mode}: ms "
              f"{[round(w, 3) for w in walls]}; median of windows 2-{windows} "
              f"{statistics.median(walls[1:]):.3f} = "
              f"{statistics.median(walls[1:]) / kernel64:.3f} x 64 kernels' "
              f"{kernel64:.3f} ms (CUDA events)", flush=True)


def fresh(gpus, reps: int, warmup: bool = False) -> None:
    from .. import NumberCruncher, workloads
    from ..core.compilecache import WarmupSpec

    n = 1 << 24
    out: dict = {}
    if warmup:
        order = [(mode, warm) for mode in ("per call", "fused")
                 for warm in (False, True, True, False)]
    else:
        order = [(mode, False) for mode in ("per call", "fused", "fused", "per call")]
    for mode, warm in order * reps:
        x, y = _saxpy_arrays(n)
        with NumberCruncher(gpus, workloads.saxpy_kernel()) as cr:
            cr.fused_dispatch = mode != "per call"
            label = mode
            if warm:
                t0 = time.perf_counter()
                cr.cores.warmup([WarmupSpec.from_job(["saxpy"], [x, y], 1, n, 256, 0, (1.5,))])
                label = f"{mode}, warmed"
                out.setdefault(f"{label}: warmup ms", []).append(
                    round((time.perf_counter() - t0) * 1e3, 3))
            cr.enqueue_mode = True
            x.next_param(y).compute(cr, 1, "saxpy", n, 256, values=(1.5,))
            cr.barrier()
            t0 = time.perf_counter()
            for _ in range(63):
                x.next_param(y).compute(cr, 1, "saxpy", n, 256, values=(1.5,))
            t1 = time.perf_counter()
            cr.barrier()
            t2 = time.perf_counter()
            cr.enqueue_mode = False
        out.setdefault(label, []).append((round((t1 - t0) * 1e3, 3), round((t2 - t1) * 1e3, 3)))
    print(f"fresh saxpy 2^24, a new cruncher a run, 63 calls after a warm call "
          f"(calls ms, barrier ms): {out}", flush=True)


def sync12(gpus, reps: int) -> None:
    from .. import NumberCruncher, workloads

    for label, src in (("C-subset", workloads.MANDELBROT_SRC),
                       ("hand kernel", workloads.mandelbrot_cuda_kernel())):
        res: dict = {}
        with NumberCruncher(gpus, src) as cr:
            workloads.run_mandelbrot(None, 2048, 2048, 256, local_range=256, readback="final",
                                     sync_every=12, cruncher=cr)
            for mode in ["per call", "fused", "fused", "per call"] * reps:
                cr.fused_dispatch = mode != "per call"
                r = workloads.run_mandelbrot(None, 2048, 2048, 256, local_range=256,
                                             readback="final", sync_every=12, cruncher=cr)
                res.setdefault(mode, []).append(round(r.mpixels_per_sec, 1))
        print(f"mandelbrot 2048x2048x256 ({label}), readback='final', sync_every=12, "
              f"Mpixels/s in turns: {res}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2, help="turns of fresh and sync12")
    ap.add_argument("--warmup", action="store_true",
                    help="only fresh, each mode A B B A against a cruncher warmed by Cores.warmup")
    args = ap.parse_args(argv)

    import torch

    from .. import all_devices

    gpus = all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    dev = gpus[0].torch_device
    print(f"{_card()}; {torch.cuda.get_device_name(dev)}", flush=True)
    if args.warmup:
        fresh(gpus, args.reps, warmup=True)
        return 0
    capture_costs(dev)
    steady(gpus, dev)
    fresh(gpus, args.reps)
    sync12(gpus, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
