"""Device time of the streaming kernels: the emitter's streamAdd and saxpy
and the elementwise kernel, beside the PyTorch call computing the same.

At 2^24 elements (beyond the 50 MB L2) and at 2^20 (held in L2, the size
of ``chip_smoke.py``'s mixed enqueue phase) it times

- the emitted streamAdd and saxpy in f32 (``kernel/cuda_backend.py``),
  beside ``torch.add(a, b, out=c)`` and ``y.add_(x, alpha=1.5)``;
- the elementwise kernel (``ops/elementwise.py``): ``saxpy`` in f32 and
  bf16 beside ``torch.add(y, x, alpha=1.5)``, ``map_blocks(torch.maximum)``
  beside ``torch.maximum`` and the three-op chain of ``chip_smoke.py``;

and the emitted mandelbrot and the hand kernel (``csrc/mandelbrot.cu``)
at 2048x2048, max_iter 256, and n-body (n = 8192) at their main-path
sizes, with ``workloads.run_mandelbrot``'s Mpixels/s for both mandelbrot
routes (12 iterations through ``compute()``, the image read back each)
and ``workloads.run_nbody``'s per-iteration ms and Gpairs/s (10
iterations at n = 8192).  Each kernel is timed three ways: the kernel's own device time from a ``torch.profiler`` trace (by
name prefix: ``ck_kernel`` for the emitter, ``mandelbrot_kernel`` for the
hand kernel, ``ew_`` for the elementwise kernel, all device time for a
PyTorch call), the CUDA-event mean of
back-to-back wrapper calls, and the host's time to issue one call.  Where
the event mean is above the kernel's device time, the difference is the
wrapper's host work; the SM clock (``nvidia-smi``) is read after each.
Prints the card's name and power limit, then one JSON line.  ``--root DIR`` imports the package from the checkout at DIR,
so two checkouts compare on one card in one call, in turns (A, B, B, A).
Needs a CUDA device.  From the repository root::

    python cekirdekler_tpu_torch/tools/time_stream.py [--root DIR] [--reps 50]
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

try:
    from . import trace_window
except ImportError:  # run as a script: this directory is on the path
    import trace_window

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ALPHA = 1.5
SAXPY_SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = a * x[i] + y[i];
}
"""


def chain(a, b):
    """``chip_smoke.chain``: compare, where, and arithmetic on each side."""
    import torch

    return torch.where(a > b, a * b - 1.5, torch.abs(b) * 0.5)


def profiled_ms(fn, prefix: str | None, reps: int) -> float:
    """Device ms per call of the kernels whose names hold ``prefix`` (every
    device activity when ``prefix`` is None), from a ``torch.profiler``
    trace of ``reps`` calls of ``fn`` after three untraced ones, read by
    ``trace_window``; raises when the trace holds none."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = trace_window.traced_ms(fn, reps, () if prefix is None else (prefix,))
    return ms["total" if prefix is None else prefix]


def _clock() -> str:
    """The card's SM clock and power draw, as ``nvidia-smi`` reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _time(fn, prefix: str | None, reps: int) -> dict:
    """Profiler device ms, CUDA-event ms and host issue ms of one call,
    and the SM clock after them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    return {"kernel_ms": profiled_ms(fn, prefix, reps), "event_ms": event_ms,
            "host_ms": host_ms, "clock": _clock()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(Path(args.root).resolve()))
    cb = importlib.import_module("cekirdekler_tpu_torch.kernel.cuda_backend")
    build = importlib.import_module("cekirdekler_tpu_torch.kernel.build")
    lang = importlib.import_module("cekirdekler_tpu_torch.kernel.lang")
    ew = importlib.import_module("cekirdekler_tpu_torch.ops.elementwise")
    hand = importlib.import_module("cekirdekler_tpu_torch.ops.mandelbrot")
    wl = importlib.import_module("cekirdekler_tpu_torch.workloads")
    if not torch.cuda.is_available():
        print("time_stream: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    kdefs = {k.name: k for src in (wl.STREAM_SRC, SAXPY_SRC, wl.MANDELBROT_SRC, wl.NBODY_SRC)
             for k in lang.parse_kernels(src)}
    f32, bf16 = torch.float32, torch.bfloat16
    ew_fns = {"saxpy_f32": (ew._saxpy_fn(ALPHA), f32), "saxpy_bf16": (ew._saxpy_fn(ALPHA), bf16),
              "maximum_f32": (torch.maximum, f32), "chain_f32": (chain, f32)}
    jobs = [(cb.emit_source(k), f"ck_{k.name}") for k in kdefs.values()]
    jobs += [(ew.kernel_source(fn, (dt, dt)), "elementwise") for fn, dt in ew_fns.values()]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(lambda j: build.build_library(*j), jobs))

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2026)
    res = {"root": str(Path(args.root).resolve()), "source": cb.__file__, "card": card,
           "reps": args.reps}
    for log2 in (24, 20):
        n = 1 << log2
        a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
        c = torch.empty(n, device=dev)
        a16, b16 = a.to(bf16), b.to(bf16)
        stream_add = cb.build_kernel_fn_cuda(kdefs["streamAdd"], n, 256, n)[0]
        saxpy = cb.build_kernel_fn_cuda(kdefs["saxpy"], n, 256, n)[0]
        y_k, y_l = b.clone(), b.clone()
        bound12 = 12.0 * n / HBM_BYTES_PER_S * 1e3
        cases = {  # name: (kernel call, prefix, library call, bound ms)
            "emitter_streamAdd": (lambda: stream_add(0, (a, b, c)), "ck_kernel",
                                  lambda: torch.add(a, b, out=c), bound12),
            "emitter_saxpy": (lambda: saxpy(0, (a, y_k), (ALPHA,)), "ck_kernel",
                              lambda: y_l.add_(a, alpha=ALPHA), bound12),
            "ew_saxpy_f32": (lambda: ew.saxpy(ALPHA, a, b), "ew_",
                             lambda: torch.add(b, a, alpha=ALPHA), bound12),
            "ew_saxpy_bf16": (lambda: ew.saxpy(ALPHA, a16, b16), "ew_",
                              lambda: torch.add(b16, a16, alpha=ALPHA), bound12 / 2),
            "ew_maximum_f32": (lambda: ew.map_blocks(torch.maximum, a, b), "ew_",
                               lambda: torch.maximum(a, b), bound12),
            "ew_chain_f32": (lambda: ew.map_blocks(chain, a, b), "ew_", None, bound12),
        }
        for name, (kern, prefix, library, bound) in cases.items():
            row = _time(kern, prefix, args.reps)
            row["bound_ms"] = bound
            if library is not None:
                lib = _time(library, None, args.reps)
                row.update(library_kernel_ms=lib["kernel_ms"], library_event_ms=lib["event_ms"],
                           library_host_ms=lib["host_ms"])
            res[f"{name}_2^{log2}"] = row
        del a, b, c, a16, b16, y_k, y_l

    npx = 2048 * 2048
    out = torch.zeros(npx, device=dev)
    mandel = cb.build_kernel_fn_cuda(kdefs["mandelbrot"], npx, 256, npx)[0]
    vals = (-2.0, -1.25, 2.5 / 2048, 2.5 / 2048, 2048, 256)
    res["emitter_mandelbrot_2048^2x256"] = _time(lambda: mandel(0, (out,), vals), "ck_kernel", 10)
    res["hand_mandelbrot_2048^2x256"] = _time(lambda: hand.mandelbrot(out, 0, npx, *vals),
                                              "mandelbrot_kernel", 10)
    for label, use_hand in (("c_subset", False), ("hand", True)):
        run = wl.run_mandelbrot(width=2048, height=2048, max_iter=256, use_cuda_kernel=use_hand)
        res[f"run_mandelbrot_{label}"] = {"mpixels_per_sec": run.mpixels_per_sec,
                                          "clock": _clock()}
    nb = 8192
    pos = [(torch.rand(nb, generator=g) - 0.5).to(dev) for _ in range(3)]
    vel = [torch.zeros(nb, device=dev) for _ in range(3)]
    nbody = cb.build_kernel_fn_cuda(kdefs["nBody"], nb, 256, nb)[0]
    res["emitter_nBody_8192"] = _time(lambda: nbody(0, (*pos, *vel), (nb, 0.0001)),
                                      "ck_kernel", 10)
    run = wl.run_nbody(n=nb, iters=10)
    res["run_nbody_8192"] = {"per_iter_ms": run["per_iter_ms"],
                             "gpairs_per_sec": run["gpairs_per_sec"],
                             "host_check_max_err": run["host_check_max_err"], "clock": _clock()}
    forms = getattr(cb, "FORMS", None)
    if forms is not None:
        res["forms"] = {f"{k[0]}:{k[1]}": v for k, v in forms.by_key.items()}
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
