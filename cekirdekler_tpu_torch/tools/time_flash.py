"""Device time of the single-card flash kernels at the model's train shapes.

Times the forward kernel (``_flash_forward``) and the backward's dq and
dk/dv kernels (``_flash_backward``) at 4x2048x8x64, causal, bf16 at
"default" (the flagship transformer's train step), and the forward also
non-causal, by CUDA events over ``--reps`` calls after two untimed ones,
and each kernel from a ``torch.profiler`` trace of as many calls (by the
name prefixes ``fa_fwd``, ``fa_bwd_dq`` and ``fa_bwd_dkv``, which the FP32
and the tensor-core kernels share).  Prints the card's name and power limit, then one JSON line.
``--root DIR`` imports the package from the checkout at DIR, so two
checkouts compare on one card in one call, in turns (A, B, B, A).  Needs a CUDA device.  From the repository root::

    python cekirdekler_tpu_torch/tools/time_flash.py [--root DIR] [--reps 20]
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path


def _device_ms(prof, prefix: str, reps: int) -> float:
    """Mean device ms per call of the kernels whose names hold ``prefix``
    (``fa_bwd_dq`` matches the FP32 ``fa_bwd_dq_kernel`` and the tensor-core
    ``fa_bwd_dq_tc_kernel``, ``fa_fwd`` the FP32 ``fa_fwd_kernel`` and the
    tensor-core ``fa_fwd_tc_kernel``, so a parent checkout and the change
    both read); raises when the trace holds none."""
    total = 0.0
    for evt in prof.key_averages():
        if prefix in evt.key:
            for attr in ("self_device_time_total", "self_cuda_time_total"):
                if hasattr(evt, attr):
                    total += float(getattr(evt, attr))
                    break
    if total <= 0.0:
        raise RuntimeError(f"time_flash: the trace shows no device time for {prefix}*")
    return total / 1e3 / reps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(args.root).resolve()))
    fa = importlib.import_module("cekirdekler_tpu_torch.ops.flash_attention")
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
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

    res = {"root": str(Path(args.root).resolve()), "source": fa.__file__, "card": card}
    for name, fn in (("forward_ms", fwd), ("forward_full_ms", fwd_full), ("backward_ms", bwd)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        res[name] = start.elapsed_time(end) / args.reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            fwd()
        torch.cuda.synchronize()
    res["fwd_kernel_ms"] = _device_ms(prof, "fa_fwd", args.reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            bwd()
        torch.cuda.synchronize()
    res["dq_ms"] = _device_ms(prof, "fa_bwd_dq", args.reps)
    res["dkv_ms"] = _device_ms(prof, "fa_bwd_dkv", args.reps)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
