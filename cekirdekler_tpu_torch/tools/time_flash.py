"""Device time of the flash kernels: the single-card ones at the model's
train shapes, or with ``--parts`` the ring's three parts kernels.

Default mode: the forward kernel (``_flash_forward``) and the backward's dq
and dk/dv kernels (``_flash_backward``) at 4x2048x8x64, causal, bf16 at
"default" (the flagship transformer's train step), and the forward also
non-causal, by CUDA events over ``--reps`` calls after two untimed ones,
and each kernel from a ``torch.profiler`` trace of as many calls (by the
name prefixes ``fa_fwd``, ``fa_bwd_dq`` and ``fa_bwd_dkv``, which the FP32
and the tensor-core kernels share).

``--parts``: ``flash_attention_parts`` and ``flash_attention_bwd_parts`` at
one step of the sp=8 ring over 1x16384x8x64 bf16 causal, at the ring's
default "highest": 1x2048 queries against 1x2048 keys, H=8, D=64, at the
diagonal step (``q_pos0 = k_pos0 = 3*2048``) and a full one (``5*2048``
against ``2*2048``), as ``chip_smoke.check_ring_parts`` lays them out.
Each call is timed by CUDA events, and each kernel from a profiler trace
by its name prefix (``fa_fwd_parts``, ``fa_bwd_dq``, ``fa_bwd_dkv``: the
FP32 kernels and the tensor-core ones share them).  Where the checkout
routes the parts by ``_parts_route``, the full step's max abs errors
against the plain versions are printed too, for the route the wrappers
take and for the FP32 kernels.

Every callable first runs for half a second of wall time, so the card
is at its working clocks when it is timed (a burst of a few milliseconds
after an idle spell runs slower); the SM clock and the power draw read by
``nvidia-smi`` in the middle of that warm-up are recorded beside each
case.  Prints the card's name and power limit, then one JSON line.  ``--root
DIR`` imports the package from the checkout at DIR, so two checkouts
compare on one card in one call, in turns (A, B, B, A).  Needs a CUDA
device.  From the repository root::

    python cekirdekler_tpu_torch/tools/time_flash.py [--parts] [--root DIR] [--reps 20]
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

try:
    from . import trace_window
except ImportError:  # run as a script: this directory is on the path
    import trace_window

WARM_S = 0.5


def _warm(fn) -> str:
    """Run ``fn()`` for ``WARM_S`` seconds of wall time and return the SM
    clock and power draw that ``nvidia-smi`` reads meanwhile."""
    import torch

    probe = subprocess.Popen(
        ["bash", "-c", f"sleep {WARM_S / 2}; nvidia-smi --query-gpu=clocks.sm,power.draw "
                       "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < WARM_S:
        fn()
        n += 1
        if n % 16 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return probe.communicate()[0].strip()


def _event_ms(fn, reps: int) -> float:
    """CUDA-event mean ms of ``fn()`` over ``reps`` calls after two untimed."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _traced_ms(fn, prefixes: tuple[str, ...], reps: int) -> dict[str, float]:
    """Device ms per ``fn()`` of each kernel prefix, from one profiler trace
    read by ``trace_window`` (``fa_bwd_dq`` matches the FP32
    ``fa_bwd_dq_kernel`` and the tensor-core ``fa_bwd_dq_tc_kernel``, so a
    parent checkout and the change both read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_window.open_window()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = trace_window.per_call_ms(prof, reps, prefixes)
    return {p: ms[p] for p in prefixes}


def _single_card(fa, torch, reps: int) -> dict:
    g = torch.Generator().manual_seed(2025)
    q, k, v, do = (torch.randn(4, 2048, 8, 64, generator=g).to(torch.bfloat16).cuda()
                   for _ in range(4))
    out, lse, (qs, ks, vs) = fa._flash_forward(q, k, v, True, 512, 512, "default",
                                               with_lse=True)

    def fwd():
        return fa._flash_forward(q, k, v, True, 512, 512, "default")

    def fwd_full():
        return fa._flash_forward(q, k, v, False, 512, 512, "default")

    def bwd():
        return fa._flash_backward(qs, ks, vs, out, lse, do, True, 512, 512, "default",
                                  (torch.bfloat16,) * 3)

    res = {}
    for name, fn in (("forward_ms", fwd), ("forward_full_ms", fwd_full), ("backward_ms", bwd)):
        res[name.replace("_ms", "_clocks")] = _warm(fn)
        res[name] = _event_ms(fn, reps)
    _warm(fwd)
    res["fwd_kernel_ms"] = _traced_ms(fwd, ("fa_fwd",), reps)["fa_fwd"]
    _warm(bwd)
    res.update(zip(("dq_ms", "dkv_ms"),
                   _traced_ms(bwd, ("fa_bwd_dq", "fa_bwd_dkv"), reps).values()))
    return res


def _parts_errors(fa, torch, q, k, v, do, lse, delta, q_pos0: int, k_pos0: int) -> dict:
    """Max abs errors of the parts kernels against their plain versions at
    one step, per route: the wrappers' own and the FP32 kernels'; with each
    plain output's largest magnitude, the gates' scale."""
    kb = fa.KERNEL_BLOCK
    want_f = fa.flash_attention_parts_plain(q, k, v, q_pos0, k_pos0, True, kb, "highest")
    want_b = fa.flash_attention_bwd_parts_plain(q, k, v, do, lse, delta, q_pos0, k_pos0, True,
                                                kb, kb, "highest")
    res = {"top": {n: float(w.abs().max()) for n, w in zip(("acc", "m", "l", "dq", "dk", "dv"),
                                                           (*want_f, *want_b))}}
    for route in (fa._parts_route("fwd", q.dtype, "highest"), "fp32"):
        got = fa._launch_parts(q, k, v, q_pos0, k_pos0, True, "highest", route=route)
        res[f"fwd:{route}"] = {n: float((a - w).abs().max())
                               for n, a, w in zip(("acc", "m", "l"), got, want_f)}
    for route in (fa._parts_route("dkv", q.dtype, "highest"), "fp32"):
        got = fa._launch_bwd(q, k, v, do, fa._row_column(lse), fa._row_column(delta), True,
                             "highest", (torch.float32,) * 3, q_pos0, k_pos0, parts=True,
                             routes=("fp32", route))
        res[f"dkv:{route}"] = {n: float((a - w).abs().max())
                               for n, a, w in zip(("dk", "dv"), got[1:], want_b[1:])}
    return res


def _parts(fa, torch, reps: int) -> dict:
    T, H, D = 2048, 8, 64
    g = torch.Generator().manual_seed(2026)
    q, k, v, do = (torch.randn(1, T, H, D, generator=g).to(torch.bfloat16).cuda()
                   for _ in range(4))
    acc, m, l = fa.flash_attention_parts_plain(q, k, v, 3 * T, 3 * T, True, fa.KERNEL_BLOCK,
                                               "highest")
    lse = m + torch.log(l)
    delta = (do.float() * (acc / l[..., None]).to(torch.bfloat16).float()).sum(dim=-1)
    res = {}
    for step, (q_pos0, k_pos0) in (("diagonal", (3 * T, 3 * T)), ("full", (5 * T, 2 * T))):
        def fwd():
            return fa.flash_attention_parts(q, k, v, q_pos0, k_pos0, True, 512, 512)

        def bwd():
            return fa.flash_attention_bwd_parts(q, k, v, do, lse, delta, q_pos0, k_pos0, True,
                                                512, 512)

        r = {"fwd_clocks": _warm(fwd)}
        r["fwd_event_ms"] = _event_ms(fwd, reps)
        r["fwd_ms"] = _traced_ms(fwd, ("fa_fwd_parts",), reps)["fa_fwd_parts"]
        r["bwd_clocks"] = _warm(bwd)
        r["bwd_event_ms"] = _event_ms(bwd, reps)
        r["dq_ms"], r["dkv_ms"] = _traced_ms(bwd, ("fa_bwd_dq", "fa_bwd_dkv"), reps).values()
        if step == "full" and hasattr(fa, "_parts_route"):
            r["errors"] = _parts_errors(fa, torch, q, k, v, do, lse, delta, q_pos0, k_pos0)
        res[step] = r
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", action="store_true",
                    help="time the ring's parts kernels at one ring step instead")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(Path(args.root).resolve()))
    fa = importlib.import_module("cekirdekler_tpu_torch.ops.flash_attention")
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    res = {"root": str(Path(args.root).resolve()), "source": fa.__file__, "card": card}
    res.update({"parts": _parts(fa, torch, args.reps)} if args.parts
               else _single_card(fa, torch, args.reps))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
