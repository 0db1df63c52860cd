"""The streaming kernels' shape on the card: vectors a thread loads before
it computes, threads a CTA, and the grid rule.

Builds variants of the emitted streamAdd and saxpy (the streaming form of
``kernel/cuda_backend.py``) and of the elementwise kernel's saxpy in f32
and bf16 and ``torch.maximum`` (``csrc/elementwise.cu``) by editing their
sources' constants: ``CK_U`` (vectors of each array a thread loads before
it computes) in 1, 2 and 4, threads a CTA in 256 and 512, and the grid as
shipped (one step per thread) or capped at the CTAs resident on the card
(the SM count times the kernel's occupancy, walked grid-stride).  Each
variant is timed by a ``torch.profiler`` trace at 2^24 and 2^20 elements,
beside the PyTorch call computing the same, in ``--rounds`` passes over
all variants.  Prints a table per kernel and size, the card's name and
power limit, then one JSON line.  Needs a CUDA device.  From the
repository root::

    python cekirdekler_tpu_torch/tools/sweep_stream.py [--reps 50] [--rounds 2]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_EMIT_CAP = """  long long blocks = (work + CK_T - 1) / CK_T;
  {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ck_kernel_stream, CK_T, 0);
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  }
"""
_EW_CAP = """  long long grid = (steps + CK_THREADS - 1) / CK_THREADS;
  {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ew_vec_kernel, CK_THREADS, 0);
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  }
"""


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"sweep_stream: the source no longer holds {old!r}")
    return src.replace(old, new)


def emitter_variant(src: str, unroll: int, threads: int, resident: bool) -> str:
    """The emitted streaming-form source with another shape."""
    src = _edit(src, "#define CK_U 1\n", f"#define CK_U {unroll}\n")
    src = _edit(src, "#define CK_T 512\n", f"#define CK_T {threads}\n")
    if resident:
        src = _edit(src, "  const long long blocks = (work + CK_T - 1) / CK_T;\n", _EMIT_CAP)
    return src


def elementwise_variant(src: str, unroll: int, threads: int, resident: bool) -> str:
    """The spliced elementwise source with another shape."""
    src = _edit(src, "#define CK_U 1 ", f"#define CK_U {unroll} ")
    src = _edit(src, "#define CK_THREADS 512\n", f"#define CK_THREADS {threads}\n")
    if resident:
        src = _edit(src, "  const long long grid = (steps + CK_THREADS - 1) / CK_THREADS;\n",
                    _EW_CAP)
    return src


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import build, cuda_backend, lang
    from cekirdekler_tpu_torch.ops import elementwise as ew
    from cekirdekler_tpu_torch.tools.time_stream import ALPHA, SAXPY_SRC, profiled_ms

    if not torch.cuda.is_available():
        print("sweep_stream: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    f32, bf16 = torch.float32, torch.bfloat16
    kdefs = {k.name: k for src in (wl.STREAM_SRC, SAXPY_SRC) for k in lang.parse_kernels(src)}
    bases = {name: ("emit", cuda_backend.emit_source(kdefs[name])) for name in kdefs}
    for name, fn, dt in (("ew_saxpy_f32", ew._saxpy_fn(ALPHA), f32),
                         ("ew_saxpy_bf16", ew._saxpy_fn(ALPHA), bf16),
                         ("ew_maximum_f32", torch.maximum, f32)):
        bases[name] = ("ew", ew.kernel_source(fn, (dt, dt)))
    shapes = list(itertools.product((1, 2, 4), (256, 512), (False, True)))
    variants = []
    for name, (kind, base) in bases.items():
        edit = emitter_variant if kind == "emit" else elementwise_variant
        variants += [(name, kind, shape, edit(base, *shape)) for shape in shapes]
    with ThreadPoolExecutor(max_workers=8) as pool:
        libs = list(pool.map(lambda v: build.build_library(v[3], "sweep_stream"), variants))

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for log2 in (24, 20):
        n = 1 << log2
        g = torch.Generator().manual_seed(7)
        a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
        c = torch.zeros(n, device=dev)
        a16, b16 = a.to(bf16), b.to(bf16)
        library = {"streamAdd": lambda: torch.add(a, b, out=c),
                   "saxpy": lambda: c.add_(a, alpha=ALPHA),
                   "ew_saxpy_f32": lambda: torch.add(b, a, alpha=ALPHA),
                   "ew_saxpy_bf16": lambda: torch.add(b16, a16, alpha=ALPHA),
                   "ew_maximum_f32": lambda: torch.maximum(a, b)}
        calls = []
        for (name, kind, shape, _), lib in zip(variants, libs):
            if kind == "emit":
                fn = lib.ck_launch
                fn.restype = ctypes.c_int
                arrays = (a, b, c) if name == "streamAdd" else (a, c)
                vals = [] if name == "streamAdd" else [ctypes.c_float(ALPHA)]
                ptrs = [x for t in arrays for x in (ctypes.c_void_p(t.data_ptr()),
                                                    ctypes.c_longlong(n))]
                call = (lambda fn=fn, p=ptrs + vals:
                        fn(*p, 0, n, n, 256, ctypes.c_void_p(stream)))
                prefix = "ck_kernel"
            else:
                fn = lib.ew_launch
                fn.restype = ctypes.c_int
                x, y = (a16, b16) if name == "ew_saxpy_bf16" else (a, b)
                out = torch.empty(n, dtype=x.dtype, device=dev)
                ins = (ctypes.c_void_p * 2)(x.data_ptr(), y.data_ptr())
                call = (lambda fn=fn, ins=ins, out=out: fn(
                    ctypes.c_void_p(out.data_ptr()), ins, 2, ctypes.c_longlong(n), 1,
                    ctypes.c_void_p(stream)))
                prefix = "ew_"
            calls.append((name, shape, call, prefix))
        torch_ms = {name: profiled_ms(fn, None, args.reps) for name, fn in library.items()}
        for rnd in range(args.rounds):
            for name, shape, call, prefix in calls:
                rows.append(dict(log2=log2, round=rnd, name=name, unroll=shape[0],
                                 threads=shape[1], resident=shape[2],
                                 ms=profiled_ms(call, prefix, args.reps),
                                 torch_ms=torch_ms[name]))
        del a, b, c, a16, b16
    by = collections.defaultdict(list)
    for r in rows:
        by[(r["log2"], r["name"], r["unroll"], r["threads"], r["resident"])].append(r["ms"])
    for log2, name in sorted({(k[0], k[1]) for k in by}):
        lib = next(r["torch_ms"] for r in rows if (r["log2"], r["name"]) == (log2, name))
        print(f"{name} 2^{log2}: PyTorch call {lib:.5f} ms")
        for key, ms in sorted(((k, v) for k, v in by.items() if k[:2] == (log2, name)),
                              key=lambda kv: sum(kv[1])):
            grid = "resident" if key[4] else "one step a thread"
            print(f"  U={key[2]} threads={key[3]} grid={grid}: "
                  f"{' '.join(f'{m:.5f}' for m in ms)} ms")
    print(card)
    print(json.dumps({"card": card, "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
