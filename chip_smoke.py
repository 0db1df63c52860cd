"""Drive the PyTorch/CUDA port (cekirdekler_tpu_torch) end to end on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and nvcc's version;
2. build: every kernel of the main path built from the sources in the
   checkout, one nvcc per source, all started together;
3. kernels: each kernel's wrapper on the card at the main path's shapes,
   held against its plain PyTorch version on the same inputs (stated
   tolerances), timed beside the plain version and, where one exists, the
   one PyTorch call computing the same function;
4. main path: with every launch count set to 0, the BASELINE workloads
   through ``ClArray.compute`` on the GPU lane — mandelbrot 2048x2048x256
   by the C-subset route and by the hand kernel (images equal
   ``mandelbrot_host`` exactly), n-body at n = 8192 (the ±0.01 host check),
   streamAdd and saxpy — then the counts are read: every kernel of the path
   must have launched, and the torch lowering must not have run;
5. balancer: mandelbrot 1024x1024x64 over one GPU lane plus one host lane,
   ten runs of 80 calls at each local range 1024, 512 and the main path's
   256: every first split is the rate-table prior split, every image is
   exact, every run must settle (``convergence_iters`` not None), and at
   least 8 of the 10 runs at each local range must move at most once, by
   one step, in their last 20 calls.  The host lane's
   eager plain version costs about 1 ms a call whatever its share, so the
   balancer drains it from the prior split to one or two steps, where
   the quantization freeze holds it; at 256 that takes 15-25 calls (see
   ``check_balancer`` for why one late step is allowed);
6. transformer: the flagship transformer's forward at the default width
   (vocab 32000, d_model 512, 4 layers, 8 heads of 64, d_ff 2048, bf16,
   ``attention="flash"``, seeded random weights) on ``cuda:0``.  With every
   count set to 0 it answers four request batches (4x2048, 8x1024, 16x256
   and 4x96, which takes the dense fallback); then the counts are read:
   the flash kernel launched once per layer for each of the three tiled
   batches, the dense fallback ran only for the T=96 batch, and the plain
   flash version never ran.  One 1x2048 batch's logits are held against
   the same weights on the CPU (plain versions), and an f32 model's at
   1x1024;
7. the kernels line, then the last line ``{"ok": true, "device": ...}``.

Exits non-zero without printing a result when no CUDA device is present,
or when the package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM data sheet, bf16 dense tensor cores
MANDEL_OPS_PER_ITER = 10   # csrc/mandelbrot.cu: the FP32 work of one escape iteration
NBODY_OPS_PER_PAIR = 20    # 3 sub, 6 mul + 3 add for r2, sqrt, mul, div, 3 mul + 3 add
BALANCE_REPS = 10
BALANCE_ITERS = 80
BALANCE_HOLD = 20
BALANCE_MIN_STILL = 8
BALANCE_STEPS = (1024, 512, 256)
EMITTER_SOURCE = "cekirdekler_tpu_torch/kernel/cuda_backend.py"
EMITTER_REPLACES = "cekirdekler_tpu/kernel/pallas_backend.py:404"

SAXPY_SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = a * x[i] + y[i];
}
"""


def phase(name: str) -> None:
    print(f"== phase: {name}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` from CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound(B: int, Tq: int, Tk: int, H: int, D: int, causal: bool,
                dtype) -> tuple[float, str]:
    """Least time (ms) of one flash forward and what binds it: its
    operations (q.k and p.v, 2 each per live (query, key) pair and head
    column) at the type's peak, against its bytes (q, k, v read once, o
    written once) at the memory rate."""
    import torch

    pairs = B * H * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)
    ops = 4.0 * D * pairs
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = float(size * B * H * D * (2 * Tq + 2 * Tk))
    by_ops, by_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def bf16_ulps(t, n: float = 2.0) -> float:
    """``n`` bf16 ulps at the largest magnitude of ``t``."""
    return n * 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 7)


def check_flash(fa, dev) -> dict:
    """The flash kernel against its plain version (key blocks at the
    kernel's tile width) on the card at the transformer's shapes (H=8,
    D=64).  f32 at "highest" within 1e-5, bf16 at "default" within 2 bf16
    ulps of the output's largest magnitude, the lse within 1e-5.  Each case
    is timed beside the plain version and ``scaled_dot_product_attention``;
    returns the kernels-line row of the first (the 4x2048 causal bf16
    forward of the model's tiled batch)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(2024)
    H, D = 8, 64
    cases = (  # label, B, T, causal, dtype, precision, with_lse
        ("4x2048 causal bf16 default", 4, 2048, True, torch.bfloat16, "default", False),
        ("4x2048 causal bf16 default + lse", 4, 2048, True, torch.bfloat16, "default", True),
        ("4x1024 causal f32 highest", 4, 1024, True, torch.float32, "highest", False),
        ("4x2048 full bf16 default", 4, 2048, False, torch.bfloat16, "default", False),
    )
    row = None
    for label, B, T, causal, dtype, prec, with_lse in cases:
        q, k, v = (torch.randn(B, T, H, D, generator=g).to(dtype).to(dev) for _ in range(3))
        res = fa._flash_forward(q, k, v, causal, 512, 512, prec, with_lse=with_lse)
        out = res[0] if with_lse else res
        want, want_lse = fa.flash_attention_plain(q, k, v, causal, fa.KERNEL_BLOCK, prec, dtype)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = 1e-5 if dtype == torch.float32 else bf16_ulps(want)
        if not bool(torch.isfinite(out).all()) or err > tol:
            raise AssertionError(f"flash kernel vs plain ({label}): max abs err {err} > {tol}")
        lse_err = None
        if with_lse:
            lse_err = float((res[1] - want_lse).abs().max())
            if lse_err > 1e-5:
                raise AssertionError(f"flash kernel lse vs plain ({label}): {lse_err} > 1e-5")
        ms = cuda_ms(lambda: fa._flash_forward(q, k, v, causal, 512, 512, prec,
                                               with_lse=with_lse), 10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal, fa.KERNEL_BLOCK,
                                                            prec, dtype), 3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                   is_causal=causal), 10)
        bound_ms, bound_by = flash_bound(B, T, T, H, D, causal, dtype)
        print(f"flash {label}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
              f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  max_abs_err {err} "
              f"(tol {tol})" + ("" if lse_err is None else f"  lse err {lse_err}"))
        if row is None:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, qt, kt, vt, res, out, want, want_lse
    return row


def check_transformer(wl, fa, card: str) -> int:
    """The transformer phase; returns the flash kernel's launch count."""
    import torch

    from cekirdekler_tpu_torch.models import Transformer, TransformerConfig

    cfg = TransformerConfig(attention="flash")
    model = Transformer(cfg, seed=0)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, cfg.vocab, (b, t)).astype(np.int32) for b, t in wl.REQUEST_BATCHES]
    # every batch once outside the counted run (cuBLAS handles and plans,
    # the allocator, kernels loaded at first use)
    wl.run_transformer_forward(model, batches, keep="argmax")
    for counter in (fa.LAUNCHES, fa.PLAIN_RUNS, fa.ROUTES):
        counter.reset()
    tr = wl.run_transformer_forward(model, batches, keep="argmax")
    launches = tr["launches"]
    print(f"transformer launch counts: {launches}; flash LAUNCHES {fa.LAUNCHES.count}, "
          f"plain runs {dict(fa.PLAIN_RUNS.by_key)}")
    tiled = sum(fa.default_blocks(t) is not None for _, t in wl.REQUEST_BATCHES)
    want = cfg.n_layers * tiled
    if fa.LAUNCHES.count != want or launches["flash_attention"] != want:
        raise AssertionError(f"flash kernel launched {fa.LAUNCHES.count} times on the "
                             f"transformer path, want {want}")
    if launches["routes"] != {"tiled": want, "dense": cfg.n_layers}:
        raise AssertionError(f"attention routes {launches['routes']}: want {want} tiled and "
                             f"the dense fallback once per layer for the T=96 batch only")
    if fa.PLAIN_RUNS.count != 0:
        raise AssertionError(f"plain flash ran on the transformer path: {fa.PLAIN_RUNS.by_key}")
    for (b, t), ids, tps, sec in zip(wl.REQUEST_BATCHES, tr["outputs"], tr["tokens_per_s"],
                                     tr["seconds"]):
        if tuple(ids.shape) != (b, t) or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab:
            raise AssertionError(f"batch {b}x{t}: bad argmax tokens {tuple(ids.shape)}")
        print(f"transformer batch {b}x{t}: {tps:.1f} tokens/s ({sec * 1e3:.3f} ms, CUDA "
              f"events) on {card}")
    del tr

    # the same weights on the CPU, through the plain versions
    one = batches[0][:1]
    on_card = model(one)
    if not bool(torch.isfinite(on_card).all()):
        raise AssertionError("non-finite logits on the card")
    on_cpu = Transformer(cfg, device="cpu", seed=0)(one)
    err = (on_card.cpu() - on_cpu).abs()
    agree = float((on_card.argmax(-1).cpu() == on_cpu.argmax(-1)).float().mean())
    print(f"bf16 1x2048 logits, card vs CPU: max abs {float(err.max())}, mean abs "
          f"{float(err.mean())}, argmax agreement {agree} (limits 5e-2, 5e-3, 0.95)")
    if float(err.max()) > 5e-2 or float(err.mean()) > 5e-3 or agree < 0.95:
        raise AssertionError("bf16 transformer logits on the card differ from the CPU's")
    del model, on_card
    cfg32 = TransformerConfig(attention="flash", dtype=torch.float32)
    one = batches[1][:1]
    err32 = float((Transformer(cfg32, seed=0)(one).cpu()
                   - Transformer(cfg32, device="cpu", seed=0)(one)).abs().max())
    print(f"f32 1x1024 logits, card vs CPU: max abs {err32} (limit 1e-3)")
    if err32 > 1e-3:
        raise AssertionError("f32 transformer logits on the card differ from the CPU's")
    return want


def tail_moves(ranges: list[list[int]], calls: int) -> tuple[int, int, int]:
    """Over the last ``calls`` calls of a run: how many times the split
    changed, the span (largest less smallest) of the host lane's range,
    and the calls at the end whose split equals the last one."""
    tail = ranges[-calls:]
    moves = sum(a != b for a, b in zip(tail, tail[1:]))
    host = [r[1] for r in tail]
    held = 0
    for r in reversed(ranges):
        if r != ranges[-1]:
            break
        held += 1
    return moves, max(host) - min(host), held


def check_balancer(ck, wl, lanes, priors: list[float]) -> None:
    """Mandelbrot 1024x1024x64 over one GPU lane and one host lane,
    ``BALANCE_REPS`` runs of ``BALANCE_ITERS`` calls at each local range.

    Every run starts at the rate-table prior split and gives the exact
    image.  The host lane costs about the same whatever its share, so the
    balancer drains it until the quantization freeze holds it at one or
    two steps.  At one step the freeze holds whatever the walls; at two it
    holds only while the GPU lane's wall exceeds 0.4 of the host lane's, so
    one noisy pair of walls may move a settled split down one step at any
    call.  So every run must settle (``convergence_iters`` not None), and
    at each local range at least ``BALANCE_MIN_STILL`` runs must, in their
    last ``BALANCE_HOLD`` calls, move at most once and by one step: a
    drain still under way or a cycle moves more than that in every run.
    The lane walls are host wall times, and on a host whose cores are
    shared a lane thread descheduled for several milliseconds can move a
    run further (one GPU-lane call of 11 ms against a usual 3-4 moved one
    run by three steps); the odd run is printed with its walls."""
    from cekirdekler_tpu_torch.core.balance import prior_split

    mixed_ref = wl.mandelbrot_host(1024, 1024, -2.0, -1.25, 2.5 / 1024, 2.5 / 1024, 64)
    failed = []
    for step in BALANCE_STEPS:
        want_first = prior_split(1024 * 1024, step, priors)
        its, held, late = [], [], []
        for rep in range(BALANCE_REPS):
            r = wl.run_mandelbrot(lanes, 1024, 1024, 64, iters=BALANCE_ITERS, warmup=0,
                                  local_range=step, keep_image=True)
            if r.ranges_per_iter[0] != want_first:
                raise AssertionError(f"local range {step}: first split "
                                     f"{r.ranges_per_iter[0]} != prior split {want_first}")
            if not np.array_equal(r.image.ravel(), mixed_ref):
                raise AssertionError(f"local range {step}: GPU + host mandelbrot image "
                                     "differs from mandelbrot_host")
            if rep == 0:
                print(f"local range {step}, host-lane range per call: "
                      f"{[lane[1] for lane in r.ranges_per_iter]}")
                print(f"local range {step}, lane walls per call (GPU ms / host ms): "
                      f"{[(round(b[0], 4), round(b[1], 4)) for b in r.benches_per_iter]}")
            moves, span, still = tail_moves(r.ranges_per_iter, BALANCE_HOLD)
            its.append(r.convergence_iters)
            held.append(still)
            late.append((moves, span // step))
            if moves:
                print(f"local range {step}, run {rep} moved late; last 25 calls' host-lane "
                      f"ranges {[lane[1] for lane in r.ranges_per_iter[-25:]]}, walls "
                      f"{[(round(b[0], 4), round(b[1], 4)) for b in r.benches_per_iter[-25:]]}")
        n_ok = sum(c is not None for c in its)
        n_still = sum(m <= 1 and s <= 1 for m, s in late)
        print(f"local range {step}: settled within {BALANCE_ITERS} calls in {n_ok} of "
              f"{BALANCE_REPS} runs, at {its}; calls at the final split: {held}; "
              f"(moves, steps spanned) in the last {BALANCE_HOLD} calls: {late}; "
              f"{n_still} of {BALANCE_REPS} runs moved at most once, by one step")
        if n_ok < BALANCE_REPS or n_still < BALANCE_MIN_STILL:
            failed.append(f"local range {step}: settled at {its}, (moves, steps spanned) in "
                          f"the last {BALANCE_HOLD} calls {late}")
    if failed:
        raise AssertionError(f"GPU + host balancer: not every run settled within "
                             f"{BALANCE_ITERS} calls, or fewer than {BALANCE_MIN_STILL} of "
                             f"{BALANCE_REPS} moved at most once, by one step, in their last "
                             f"{BALANCE_HOLD}: " + "; ".join(failed))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # f32 products in true f32 (PyTorch's defaults, pinned)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.hardware import rate_prior
    from cekirdekler_tpu_torch.kernel import build, cuda_backend, lang, registry
    from cekirdekler_tpu_torch.kernel.codegen import build_kernel_fn
    from cekirdekler_tpu_torch.ops import flash_attention as fa_op
    from cekirdekler_tpu_torch.ops import mandelbrot as mandel_op

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    phase("device")
    card = gpu_line()
    print(card)
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    phase("build")
    programs = {
        "mandelbrot": lang.parse_kernels(wl.MANDELBROT_SRC)[0],
        "nBody": lang.parse_kernels(wl.NBODY_SRC)[0],
        "streamAdd": lang.parse_kernels(wl.STREAM_SRC)[0],
        "saxpy": lang.parse_kernels(SAXPY_SRC)[0],
    }
    jobs = {"mandelbrot.cu": (mandel_op.SOURCE.read_text(), "mandelbrot"),
            "flash_attention.cu": (fa_op.SOURCE.read_text(), "flash_attention")}
    for name, kdef in programs.items():
        reason = cuda_backend.unsupported_reason(kdef)
        if reason is not None:
            raise RuntimeError(f"{name} is outside the emitter subset: {reason}")
        jobs[f"emit:{name}"] = (cuda_backend.emit_source(kdef), f"ck_{name}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = {k: pool.submit(build.build_library, src, nm) for k, (src, nm) in jobs.items()}
        for k, f in futs.items():
            f.result()
    print(f"built {len(jobs)} sources in parallel in {time.perf_counter() - t0:.1f} s: "
          f"{sorted(jobs)}")

    phase("kernels vs plain versions")
    rows: dict[str, dict] = {}
    g = torch.Generator(device="cpu").manual_seed(1234)

    def emitted(kname, n, local=256):
        """(kernel fn, plain fn) for one geometry of an emitted kernel."""
        kdef = programs[kname]
        kfn, _ = cuda_backend.build_kernel_fn_cuda(kdef, n, local, n)
        pfn, _ = build_kernel_fn(kdef, n, local, n)
        return kfn, pfn

    # streamAdd and saxpy: 2^24 floats (3 x 64 MiB, beyond the 50 MB L2)
    n = 1 << 24
    a = torch.rand(n, generator=g).to(dev)
    b = torch.rand(n, generator=g).to(dev)
    kfn, pfn = emitted("streamAdd", n)
    c_k, c_p = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    kfn(0, (a, b, c_k))
    pfn(0, (a, b, c_p))
    err = float((c_k - c_p).abs().max())
    if err != 0.0:
        raise AssertionError(f"streamAdd kernel vs plain: max abs err {err}")
    rows["emitter:streamAdd"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: kfn(0, (a, b, c_k)), 20),
        plain_ms=cuda_ms(lambda: pfn(0, (a, b, c_p)), 5),
        library_ms=cuda_ms(lambda: torch.add(a, b, out=c_p), 20),
        bound_ms=12.0 * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes", n=n)

    alpha = 1.5
    kfn, pfn = emitted("saxpy", n)
    y_k, y_p = b.clone(), b.clone()
    kfn(0, (a, y_k), (alpha,))
    pfn(0, (a, y_p), (alpha,))
    err = float((y_k - y_p).abs().max())
    if err != 0.0:
        raise AssertionError(f"saxpy kernel vs plain: max abs err {err}")
    y_l = b.clone()
    rows["emitter:saxpy"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: kfn(0, (a, y_k), (alpha,)), 20),
        plain_ms=cuda_ms(lambda: pfn(0, (a, y_p), (alpha,)), 5),
        library_ms=cuda_ms(lambda: torch.add(y_l, a, alpha=alpha), 20),
        bound_ms=12.0 * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes", n=n)
    del a, b, c_k, c_p, y_k, y_p, y_l

    # mandelbrot 2048 x 2048, max_iter 256 (C-subset kernel and hand kernel)
    W = H = 2048
    iters = 256
    npx = W * H
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, iters)
    kfn, pfn = emitted("mandelbrot", npx)
    o_k, o_p = torch.zeros(npx, device=dev), torch.zeros(npx, device=dev)
    kfn(0, (o_k,), vals)
    pfn(0, (o_p,), vals)
    err = float((o_k - o_p).abs().max())
    if err != 0.0:
        raise AssertionError(f"mandelbrot C-subset kernel vs plain: max abs err {err}")
    escapes = float(o_p.double().sum())
    mandel_bound = max(escapes * MANDEL_OPS_PER_ITER / FP32_OPS_PER_S,
                       4.0 * npx / HBM_BYTES_PER_S) * 1e3
    rows["emitter:mandelbrot"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: kfn(0, (o_k,), vals), 5),
        plain_ms=cuda_ms(lambda: pfn(0, (o_p,), vals), 1, warmup=0),
        library_ms=None, bound_ms=mandel_bound, bound_by="operations",
        escape_sum=escapes)

    # the hand kernel at offsets {0, 128 k} and chunk sizes from the ladder
    worst = 0.0
    for off, cnt in ((0, npx), (128 * 3, 1 << 20), (128 * 1001, 1 << 16),
                     (npx - (1 << 14), 1 << 14), (128 * 77, 256)):
        h_k, h_p = torch.zeros(npx, device=dev), torch.zeros(npx, device=dev)
        mandel_op.mandelbrot(h_k, off, cnt, *vals)
        mandel_op.mandelbrot_plain(h_p, off, cnt, *vals)
        worst = max(worst, float((h_k - h_p).abs().max()))
    if worst != 0.0:
        raise AssertionError(f"mandelbrot hand kernel vs plain: max abs err {worst}")
    rows["mandelbrot"] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: mandel_op.mandelbrot(h_k, 0, npx, *vals), 5),
        plain_ms=cuda_ms(lambda: mandel_op.mandelbrot_plain(h_p, 0, npx, *vals), 1,
                         warmup=0),
        library_ms=None, bound_ms=mandel_bound, bound_by="operations")
    # the main path's readback: one image, card -> page-locked host memory
    pinned = torch.empty(npx, pin_memory=True)
    d2h_ms = cuda_ms(lambda: pinned.copy_(h_k, non_blocking=True), 20)
    print(f"D2H of one {W}x{H} f32 image ({4 * npx} B) into pinned memory: {d2h_ms:.4f} ms "
          f"({4 * npx / d2h_ms / 1e6:.1f} GB/s)")
    del o_k, o_p, h_k, h_p, pinned

    # n-body at n = 8192 (rtol 1e-5: the plain version's sums run in the
    # same order, but transcendental/sqrt paths may differ by an ulp)
    nb = 8192
    rng = np.random.default_rng(42)
    pos = [torch.from_numpy(((rng.random(nb, dtype=np.float32) - 0.5) * 2.0)).to(dev)
           for _ in range(3)]
    kfn, pfn = emitted("nBody", nb)
    v_k = [torch.zeros(nb, device=dev) for _ in range(3)]
    v_p = [torch.zeros(nb, device=dev) for _ in range(3)]
    kfn(0, (*pos, *v_k), (nb, 0.0001))
    t0 = time.perf_counter()
    pfn(0, (*pos, *v_p), (nb, 0.0001))
    torch.cuda.synchronize()
    nbody_plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((k - p).abs().max()) for k, p in zip(v_k, v_p))
    for k, p in zip(v_k, v_p):
        torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-6)
    rows["emitter:nBody"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: kfn(0, (*pos, *v_k), (nb, 0.0001)), 10),
        plain_ms=nbody_plain_ms, library_ms=None,
        bound_ms=max(nb * nb * NBODY_OPS_PER_PAIR / FP32_OPS_PER_S,
                     (6 + 3) * 4.0 * nb / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations")
    del pos, v_k, v_p
    rows["flash_attention"] = check_flash(fa_op, dev)
    for name, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name:20s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"max_abs_err {r['max_abs_err']}")

    phase("main path (GPU lane)")
    gpus = ck.all_devices().gpus()
    ref_img = wl.mandelbrot_host(W, H, -2.0, -1.25, 2.5 / W, 2.5 / H, iters)
    cuda_backend.LAUNCHES.reset()
    mandel_op.LAUNCHES.reset()
    registry.reset_launch_counts()
    res = {}
    for label, hand in (("C-subset", False), ("hand kernel", True)):
        r = wl.run_mandelbrot(gpus, W, H, iters, local_range=256, keep_image=True,
                              use_cuda_kernel=hand)
        if not np.array_equal(r.image.ravel(), ref_img):
            bad = int((r.image.ravel() != ref_img).sum())
            raise AssertionError(f"mandelbrot ({label}) differs from mandelbrot_host "
                                 f"at {bad} pixels")
        res[label] = r.mpixels_per_sec
        print(f"mandelbrot 2048x2048x256 ({label}): {r.mpixels_per_sec:.1f} Mpixels/s "
              f"on {card}")
    nbr = wl.run_nbody(gpus, n=nb, iters=10)
    print(f"nbody n={nb}: host check max err {nbr['host_check_max_err']:.3g} "
          f"(tolerance 0.01), {nbr['gpairs_per_sec']:.2f} Gpairs/s")
    st = wl.run_stream(gpus, n=1 << 24, reps=3)
    print(f"streamAdd n=2^24: {st['gb_per_sec']:.1f} GB/s end to end (with H2D/D2H)")
    x = ck.ClArray(np.arange(1 << 24, dtype=np.float32) % 7, name="x", read_only=True,
                   fast=True)
    y = ck.ClArray(np.ones(1 << 24, dtype=np.float32), name="y", fast=True)
    with ck.NumberCruncher(gpus, SAXPY_SRC) as cr:
        x.next_param(y).compute(cr, 7004, "saxpy", 1 << 24, 256, values=(alpha,))
    if not np.array_equal(y.host(), np.float32(alpha) * x.host() + np.float32(1.0)):
        raise AssertionError("saxpy through compute() mismatch")
    counts = dict(cuda_backend.LAUNCHES.by_key)
    counts["mandelbrot.cu"] = mandel_op.LAUNCHES.count
    routes = dict(registry.launch_counts)
    print(f"launch counts on the main path: {counts}; routes {routes}")
    for name in ("mandelbrot", "nBody", "streamAdd", "saxpy", "mandelbrot.cu"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if routes["torch"] != 0 or routes["cuda"] <= 0:
        raise AssertionError(f"main path left the CUDA route: {routes}")
    rows["emitter:mandelbrot"]["launches"] = counts["mandelbrot"]
    rows["emitter:nBody"]["launches"] = counts["nBody"]
    rows["emitter:streamAdd"]["launches"] = counts["streamAdd"]
    rows["emitter:saxpy"]["launches"] = counts["saxpy"]
    rows["mandelbrot"]["launches"] = counts["mandelbrot.cu"]

    phase("balancer (GPU + host lane)")
    check_balancer(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1),
                   [rate_prior(kind), rate_prior("cpu")])

    phase("transformer forward")
    rows["flash_attention"]["launches"] = check_transformer(wl, fa_op, card)

    phase("summary")
    meta = {
        "emitter:streamAdd": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:saxpy": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:mandelbrot": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:nBody": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "mandelbrot": ("cuda", "cekirdekler_tpu_torch/csrc/mandelbrot.cu",
                       "cekirdekler_tpu/ops/mandelbrot.py:81"),
        "flash_attention": ("cuda", "cekirdekler_tpu_torch/csrc/flash_attention.cu",
                            "cekirdekler_tpu/ops/flash_attention.py:351"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        rr = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": rr["launches"], "max_abs_err": rr["max_abs_err"],
            "ms": rr["ms"], "plain_ms": rr["plain_ms"], "bound_ms": rr["bound_ms"],
            "bound_by": rr["bound_by"], "library_ms": rr["library_ms"],
        })
    print(f"mpixels_per_sec: {json.dumps(res)}; total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
