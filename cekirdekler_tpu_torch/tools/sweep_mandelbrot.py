"""Both mandelbrot kernels at each group size of their escape loop: the
SASS of each loop, exactness on the card, and device time.

Builds the hand kernel (``csrc/mandelbrot.cu`` with ``MANDEL_GROUP`` set)
and the emitter's mandelbrot (``kernel/cuda_backend.py``: the escape form
with ``ESCAPE_GROUP`` set, and the item form) at each group size of
``--groups``, and with ``--parent DIR`` the hand kernel of the checkout
at DIR, then

- with ``--sass DIR``: compiles each source to a cubin with the port's nvcc
  flags and ``-Xptxas -v`` (registers and spills, printed), writes
  ``cuobjdump -sass`` of each to DIR, and prints, for each loop of the SASS
  (a backward branch and the instructions from its target to it), its
  instructions by class: FP32 pipe (FADD, FMUL, FFMA), float compare and
  select, integer and predicate, branch and other;
- checks every build on the card bit for bit against the plain version
  (``ops/mandelbrot.mandelbrot_plain``): at 2048x2048, max_iter 256, and at
  512x512 over a view whose outer pixels run on to inf and NaN at max_iter
  1, K - 1, K, K + 1 and 60;
- with ``--reps N`` above 0: times each at 2048x2048, max_iter 256, by the
  profiler (``trace_window``, N calls) with the SM clock read after each.

Prints the card's name and power limit, then one JSON line.  From the
repository root, on a machine with a card::

    python cekirdekler_tpu_torch/tools/sweep_mandelbrot.py [--sass DIR] [--reps 20] [--parent DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cekirdekler_tpu_torch.tools import trace_window  # noqa: E402

FP32 = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"}
FCMP = {"FSETP", "FSET", "FSEL", "FMNMX", "FCHK"}
BRANCH = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "BREAK",
          "WARPSYNC", "BMOV", "YIELD"}
INT = {"IADD3", "IMAD", "IMAD.MOV", "IMAD.IADD", "IMAD.SHL", "IMAD.HI", "IMAD.WIDE", "ISETP",
       "LOP3", "SEL", "SHF", "PLOP3", "MOV", "IABS", "LEA", "LEA.HI", "I2F", "F2I", "P2R",
       "R2P", "VOTE", "POPC", "FLO", "IMNMX", "ISCADD"}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in FP32:
        return "fp32"
    if base in FCMP:
        return "fcmp"
    if base in BRANCH:
        return "branch"
    if base in INT or op in INT:
        return "int"
    return "other"


def sass_loops(sass: str) -> list[dict]:
    """Each loop of one kernel's SASS: a branch to an earlier address and
    the instructions from there to the branch, counted by class."""
    instrs = []
    for m in _LINE.finditer(sass):
        text = m.group(2).strip()
        parts = text.split()
        if parts and parts[0].startswith("@"):
            parts = parts[1:]
        if parts:
            instrs.append((int(m.group(1), 16), parts[0], text))
    loops = []
    for addr, op, text in instrs:
        if op.split(".")[0] != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)", text)
        if target is None or int(target.group(1), 16) > addr:
            continue
        lo = int(target.group(1), 16)
        body = [o for a, o, _ in instrs if lo <= a <= addr]
        counts: dict[str, int] = {}
        for o in body:
            counts[classify(o)] = counts.get(classify(o), 0) + 1
        ops: dict[str, int] = {}
        for o in body:
            ops[o] = ops.get(o, 0) + 1
        loops.append({"from": hex(lo), "to": hex(addr), "instructions": len(body),
                      "by_class": counts, "by_opcode": ops})
    return loops


def sources(groups: list[int], parent: str | None = None) -> dict[str, tuple[str, str]]:
    """``{label: (source, library name)}`` of every build the sweep runs;
    ``parent`` is a checkout whose hand kernel is built beside them."""
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import cuda_backend as cb
    from cekirdekler_tpu_torch.kernel import lang
    from cekirdekler_tpu_torch.ops import mandelbrot as op

    kdef = lang.parse_kernels(wl.MANDELBROT_SRC)[0]
    hand = op.SOURCE.read_text()
    out = {"emitted_item": (cb.emit_source(kdef, escape=False), "ck_mandelbrot")}
    saved = cb.ESCAPE_GROUP
    try:
        for k in groups:
            out[f"hand_K{k}"] = (f"#define MANDEL_GROUP {k}\n" + hand, "mandelbrot")
            cb.ESCAPE_GROUP = k
            out[f"emitted_escape_K{k}"] = (cb.emit_source(kdef), "ck_mandelbrot")
    finally:
        cb.ESCAPE_GROUP = saved
    if parent is not None:
        path = Path(parent) / "cekirdekler_tpu_torch" / "csrc" / "mandelbrot.cu"
        out["hand_parent"] = (path.read_text(), "mandelbrot")
    return out


def dump_sass(label: str, src: str, out_dir: Path) -> dict:
    """Compile ``src`` to a cubin with the port's flags and ``-Xptxas -v``,
    write its SASS, and return ptxas's lines and the SASS's loops."""
    from cekirdekler_tpu_torch.kernel import build

    nvcc = build.nvcc_path()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cu, cubin = out_dir / f"{label}.cu", out_dir / f"{label}.cubin"
    cu.write_text(src)
    proc = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin), str(cu)],
                          capture_output=True, text=True, check=True)
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    (out_dir / f"{label}.sass").write_text(sass)
    ptxas = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    return {"ptxas": ptxas, "loops": sass_loops(sass)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default="2,4,8,16")
    ap.add_argument("--sass", default=None, help="directory for the SASS dumps")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default=None, help="a checkout whose hand kernel joins the sweep")
    args = ap.parse_args(argv)
    groups = [int(g) for g in args.groups.split(",")]

    import numpy as np
    import torch

    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import build, lang
    from cekirdekler_tpu_torch.kernel import cuda_backend as cb
    from cekirdekler_tpu_torch.ops import mandelbrot as op

    if not torch.cuda.is_available():
        print("sweep_mandelbrot: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    srcs = sources(groups, args.parent)
    res: dict = {"card": card, "groups": groups}
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        list(pool.map(lambda s: build.build_library(*s), srcs.values()))
        if args.sass:
            out_dir = Path(args.sass)
            out_dir.mkdir(parents=True, exist_ok=True)
            dumps = dict(zip(srcs, pool.map(lambda kv: dump_sass(kv[0], kv[1][0], out_dir),
                                            srcs.items())))
            res["sass"] = dumps
            for label, d in dumps.items():
                print(f"{label}: {d['ptxas']}")
                for lp in d["loops"]:
                    print(f"  loop {lp['from']}-{lp['to']}: {lp['instructions']} instructions "
                          f"{lp['by_class']}")

    dev = torch.device("cuda", 0)
    kdef = lang.parse_kernels(wl.MANDELBROT_SRC)[0]

    def launcher(label):
        """(run(out, width, vals), the kernel's name prefix) of one build."""
        stream = torch.cuda.current_stream().cuda_stream
        if label.startswith("hand"):
            fn = op.launcher(srcs[label][0])

            def run(out, w, vals):
                rc = fn(out.data_ptr(), out.numel(), 0, out.numel(),
                        *(float(np.float32(v)) for v in vals[:4]), w, vals[5], stream)
                assert rc == 0, rc
            return run, "mandelbrot_kernel"
        saved = cb.ESCAPE_GROUP
        try:
            cb.ESCAPE_GROUP = int(label.rsplit("K", 1)[1]) if "escape" in label else saved
            ck = cb._CudaKernel(kdef, escape="escape" in label)
            fn = ck.library(("float",))
        finally:
            cb.ESCAPE_GROUP = saved

        def run(out, w, vals):
            n = out.numel()
            assert fn(*ck.args((out,), vals, 0, n, n, 256), stream) == 0
        return run, "ck_kernel"

    cases = [(2048, (-2.0, -1.25, 2.5 / 2048, 2.5 / 2048, 2048, 256))]
    for it in sorted({1, 60} | {g + d for g in groups for d in (-1, 0, 1) if g + d > 0}):
        cases.append((512, (-40.0, -30.0, 1.0 / 8, 1.0 / 8, 512, it)))
    checked = {}
    for label in srcs:
        run, _ = launcher(label)
        for w, vals in cases:
            got = torch.zeros(w * w, device=dev)
            want = torch.zeros(w * w, device=dev)
            run(got, w, vals)
            op.mandelbrot_plain(want, 0, w * w, *vals)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{label} at {w}^2 max_iter {vals[5]}: {bad} pixels differ")
        checked[label] = len(cases)
    res["checked_bit_exact"] = checked
    print(f"every build bit-exact against the plain version: {checked}")

    if args.reps > 0:
        npx = 2048 * 2048
        out = torch.zeros(npx, device=dev)
        vals = cases[0][1]
        times = {}
        for label in srcs:
            run, prefix = launcher(label)
            for _ in range(3):
                run(out, 2048, vals)
            torch.cuda.synchronize()
            ms = trace_window.traced_ms(lambda: run(out, 2048, vals), args.reps, (prefix,))
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader"], capture_output=True, text=True,
                                   check=True).stdout.strip()
            times[label] = {"ms": ms[prefix], "clock": clock}
            print(f"{label}: {ms[prefix]:.4f} ms at {clock}")
        res["ms_2048x2048x256"] = times
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
