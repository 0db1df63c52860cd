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
   one PyTorch call computing the same function; the flash forward at
   4x2048x8x64 causal bf16 (with and without the lse) and 4x2048
   non-causal bf16 at "default" (the tensor-core kernel of
   ``csrc/flash_attention_tc.cu``, two calls equal bit for bit, the FP32
   kernel timed beside it on the same inputs) and 4x1024 causal f32 at
   "highest" (the FP32 kernel), each on its asserted route; the flash
   backward's two kernels at 4x2048x8x64 causal bf16 and 4x2048
   non-causal bf16 (both at "default": the tensor-core kernels of
   ``csrc/flash_attention_bwd_tc.cu``)
   and 4x1024 causal f32 (the FP32 kernels), each kernel timed from a
   ``torch.profiler`` trace under its own name, and two calls of each case
   equal bit for bit;
   the emitted streamAdd and saxpy at 2^24 and 2^20 floats, bit-exact and
   on the emitter's streaming form, the emitted mandelbrot on its escape
   form and the hand kernel (``csrc/mandelbrot.cu``) at 2048x2048x256,
   bit-exact, the hand kernel also at offsets, at max_iter values off its
   group of passes and over a view whose pixels run on to inf and NaN, both
   timed by the profiler beside their bound (FP32-pipe instructions,
   ``mandel_bound``), and the
   emitted n-body at n = 8192 on the loop form, bit-exact, timed beside its
   bound (FP32-pipe and MUFU instructions, ``nbody_bound``) and beside
   ``ops/nbody.nbody_accels`` (several PyTorch calls);
   the elementwise kernel (``ops/elementwise.py``) over 2^24 and 2^20
   elements: ``saxpy`` in f32 and bf16, ``map_blocks(torch.maximum)`` and
   a three-op chain, each bit-exact against its plain version, and one
   ``block_rows`` other than 256 giving the same result.  The emitted and
   elementwise kernels are timed by the profiler (their own device time,
   the kernels line's ``ms``) beside the CUDA-event mean of the wrapper's
   calls, and the PyTorch call by the profiler;
4. main path: with every launch count set to 0, the BASELINE workloads
   through ``ClArray.compute`` on the GPU lane — mandelbrot 2048x2048x256
   by the C-subset route and by the hand kernel (images equal
   ``mandelbrot_host`` exactly), n-body at n = 8192 (the ±0.01 host check),
   streamAdd and saxpy — then the counts are read: every kernel of the path
   must have launched, streamAdd and saxpy only on the emitter's streaming
   form, mandelbrot only on its escape form and n-body only on its loop form
   (``cuda_backend.FORMS``), and the torch lowering must not have run;
   enqueue mode, each path with the counts set to 0 just before it and read
   just after: (b) a ``@kernel`` saxpy over the elementwise kernel
   (``workloads.saxpy_kernel``) at 2^24 floats, 64 calls, ``barrier()``,
   ``flush()`` — ``y`` equals 64 plain iterations bit for bit, the kernel
   launched once per ladder chunk per call, ``x`` and ``y`` uploaded once
   and ``y`` read back once, at the flush; (c) ``run_mandelbrot`` with
   ``readback="final"`` at 2048x2048x256 by both routes, beside
   ``readback="every"`` on the same cruncher: images exact and one image
   D2H per enqueue run, then ``sync_every=12`` per call and fused in turns
   after a warm run; the fused phase: emitted and hand mandelbrot, the
   ``@kernel`` saxpy, emitted streamAdd and n-body at the main path's
   shapes, each per call and fused in enqueue mode on a new cruncher:
   outputs equal bit for bit, every launch count equal, CUDA-graph replays
   (``kernel/graphs.GRAPHS``), no plain version on the card; and
   ``repeat_count=64`` saxpy, @kernel and emitted, 4 calls through
   ``compute()``: one ladder, then one graph replay a call, every repeat
   counted, ``y`` exact (fused windows are on by default, so (b) defers
   calls 3-64); (d) one GPU lane plus one host lane in enqueue
   mode, mandelbrot 1024x1024x64 with a barrier every 4 calls and the
   saxpy kernel at 2^20: ranges move only on the first call after a
   barrier, at least once, and the image and ``y`` stay exact;
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
5b. device selection: every selector of the reference on one GPU lane
   plus one host lane (the card first by the n-body microbenchmark, free
   memory as ``torch.cuda.mem_get_info`` reads it), the platform counts,
   and two partition lanes of the card through ``compute()`` on the
   emitted mandelbrot: image exact, both lanes on the CUDA route, two
   streams;
5c. streamed transfers (GPU lane): emitted and hand mandelbrot
   2048x2048x256 (``readback="every"``), emitted streamAdd and saxpy at
   2^24, each monolithic, at 4 chunks pinned and at the tuner's choice,
   6 calls each on a new cruncher: outputs equal the monolithic run's
   bit for bit, the pinned run launches 4 chunks a call and copies 4
   chunks a call per array, the emitted kernels stay on their forms, no
   kernel source is built anew; a ``torch.profiler`` trace of a 4-chunk
   mandelbrot call (read through ``tools/trace_window.py``) at max_iter
   256 (printed) and 2048, where a chunk's D2H must run beside a later
   chunk's kernel; then, printed: streamed against monolithic Mpixels/s
   and streamAdd GB/s A B B A on one cruncher, the tuner's chunk
   counts, ``measure_stream_overlap(streamed=True, duplex_probe=True)``
   and ``duplex_ceiling()``.  The main path above runs with streamed
   transfers on (the default) and prints its streamed phases;
5d. n-body end to end: ``workloads.nbody_e2e`` at n = 8192, 150
   iterations in enqueue windows of 50, fused, over two partition lanes
   of the card: the host check within 0.01, every launch on the loop
   form;
5e. ``no_compute_mode`` on the GPU lane, per call and enqueued: the
   arrays move (transfers counted), no kernel launches, the host array
   keeps its values, and the fused refusal ``no-compute`` is counted;
5f. pipelines, with the counts set to 0 before each run and read after
   it: (a) ``compute(pipeline=True, pipeline_blobs=8)`` of streamAdd at
   2^24 floats on the GPU lane, page-locked and pageable, by the EVENT
   engine at lookahead 1, 2 and 4 and by the DRIVER engine, in turns with
   the monolithic and the streamed (tuner's choice) path: every call's
   ``c`` equals the monolithic run's bit for bit, every pipelined call's 8
   blobs launch on the emitter's streaming form and none on the torch
   route; the host walls printed, and
   ``measure_stream_overlap(streamed=False)`` of both engines at
   ``heavy_iters="auto"``, compute factors 1 and 3, with the duplex
   probe; (b) mandelbrot 2048x2048x256 by the escape form and the
   hand kernel on a GPU + host lane and on the GPU lane alone, pipelined
   (8 blobs) A B B A against the plain path: images exact, each pipelined
   blob launch of the GPU lane on its hand-written kernel (counted from
   the calls' range tables), Mpixels/s printed; (c) three stages (addOne, timesTwo, addHidden) at
   2^22 fed 16 generations of seeded integers by ``DevicePipeline.feed``
   and ``feed_async`` on the card and ``ClPipeline.push`` over the card, a
   host lane and the card: every generation (x + 1) * 2 + 3 bit for bit,
   each stage's kernel once a generation on the card's CUDA route,
   generations/s printed; (d) ``ClDevicePool`` over the GPU lane and two
   host lanes, 64 mandelbrot tiles with a ``device_select`` span, a
   ``global_synchronization`` and a ``broadcast``: the image exact, the
   tasks done summing to the tasks run, tasks/s and shares printed.  Both
   engines must have run on the GPU lane
   (``ck_pipeline_stages_total{engine, device="cuda"}``).  The main
   path's ``run_stream`` runs the EVENT engine too;
5g. health, drain and device trace: (a) mandelbrot 2048x2048x256 on two
   partition lanes of the card in enqueue mode, a call, a barrier and a
   flush a window, with lane 1's barrier fence stalled ``HEALTH_MS`` by
   ``lane-stall`` for ``HEALTH_STALLS`` barriers after ``HEALTH_BASE``
   clean ones, under the default ``HealthMonitor`` and ``DrainController``:
   lane 1 read degraded within the monitor's bound, its range 0 from the
   call after the drain, one step at the probe, then readmitted, one drain
   and one readmit counted, the image exact after every window, and the
   run's decision log verified by the port's ``ckreplay verify`` with every
   ``health-verdict``, ``drain-apply`` and ``readmit`` row replayed;
   (b) ``trace.device.capture_device`` around 12 calls of the main path's
   mandelbrot on the GPU lane with ``trace_lanes`` on: every launch mark
   after the records the trace dropped matched to a kernel record of its
   kernel (``gate_trace_marks``: a drop may take the window's first marks
   only once it took every lead kernel, and at most half the window), and
   the unified host + device trace split back losslessly; the kernel's device ms by the trace goes
   on the kernels line beside its CUDA-event ms; (c) ``nbody_e2e`` with
   ``attribution`` and ``device_timeline_dir``: its factors and the kernel
   profile's busy share.  Every phase's drains and readmits (what
   ``ck_drain_total`` and ``ck_drain_readmit_total`` count) are printed
   with their decision rows;
5h. the verify gate, checkpoints and the debug server: (a) under
   ``CK_KERNEL_VERIFY=strict``, the main path's launch shapes
   (``verify_shapes``: the emitted and the hand mandelbrot at
   2048x2048x256, streamAdd and saxpy at 2^24, n-body at 8192) each print
   their verdict; exactly the shapes ``VERIFY_CLEAN`` names (the ones the
   reference finds clean, ``tests/test_torch_verify.py``) run, with every
   image or buffer exact; then a planted 3-point stencil (``STENCIL_SRC``)
   at 2^22 items on two partition lanes of the card: with ``x`` under
   ``partial_read`` the verdict names ``partial-read-halo``, the advisory
   split run differs from the whole-card run exactly at the partition
   boundary, and the strict call raises ``KernelVerifyError`` with no launch
   and no transfer; with a full read of ``x`` the verdict is clean and the
   split run equals the whole-card run bit for bit; one ``kernel-verify``
   flight event for the unsafe shape, not one per call; (b) the transformer
   phase's model with bf16 parameters, trained 4 steps at 4x2049,
   ``save_pytree`` of the model's and AdamW's state dicts, ``load_pytree``
   into a fresh model and optimizer on the card, every leaf equal bit for
   bit (bf16 leaves and the AdamW moments included), then 4 more steps on
   both with losses within 1e-3 relative, every flash launch on ``tc``;
   (c) ``serve_debug(0)`` on a cruncher over two partition lanes of the
   card while 12 mandelbrot calls run, one ``capture_device`` window among
   them: every endpoint answers 200 and parses (``/metrics`` names the
   lanes' ``ck_*`` series, ``/statusz`` the lanes and their shares,
   ``/profilez`` the emitted mandelbrot's row of the capture,
   ``/decisionz`` the calls' decision rows), ``/servez`` answers 501, and
   after ``close`` the port no longer answers;
5i. the compile cache: (a) on a fresh cruncher on the GPU lane,
   ``Cores.warmup`` of the emitted mandelbrot at 2048x2048x256 and then its
   first enqueue-mode windows (``run_mandelbrot``, ``readback="final"``,
   ``sync_every=12``), and the same for ``mandelbrot_cuda_kernel``: the
   windows build no launcher (``compiled_count``, ``fused_compiled_count``),
   run no compiler and load no library (``kernel/build.BUILDS``), the image
   is exact against phase 3's reference image, and with the counts set to
   0 before it the path launched its kernel; the emit-and-hash host ms of a
   chunk's first launcher beside it; (b) ``tools/coldstart``'s three child
   processes (cold, populate, warm) on n-body at n = 8192, local range 256,
   over a temporary cache root: their velocities equal bit for bit, the
   warm child's first batch builds no launcher and runs no compiler,
   populate left an entry and a library under ``<root>/lib``, each child's
   n-body launched on the card; the three first batches' and the steady
   batches' ms printed with the card's name and power limit;
5j. queue markers and user events: (a) ``fine_grained_queue_control`` on
   a cruncher over the GPU lane and a host lane, mandelbrot 2048x2048x256
   (the emitter's escape form) with the launch counts set to 0 before it:
   the image exact, after each lane's ``drain`` no marker remaining and
   reached equal to added, and each lane kind's launch markers equal to
   its route's launches (``registry.launch_counts``: ``cuda`` for the GPU
   lane); (b) an enqueued mandelbrot call on the GPU lane whose kernel
   runs at least ``RETIRE_MS``: right after ``compute()`` returns a marker
   remains, the caller's thread keeps running while the marker thread
   waits for the device (``RETIRE_POLLS`` polls at least), and after
   ``barrier()`` and ``drain`` none remains; (c) a ``dispatch_gate``
   (``utils.events.UserEvent``) on streamAdd at 2^20 (the streaming form)
   over the GPU lane and a host lane, called from a thread: held
   ``GATE_HOLD_S`` untriggered the call has not returned, no launch count
   moved and the output is untouched, after ``trigger()`` it is exact and
   the markers drain to 0, and in enqueue mode a gated repeat counts
   ``fused_stats["disengaged"]["dispatch-gate"]``; (d) phase 5f (d)'s pool
   with ``csrc/mandelbrot.cu`` and ``fine_grained_queue_control=True,
   queue_limit=POOL_QUEUE_LIMIT``: the image exact, every lane's markers
   drained, and ``max_inflight_depth()`` at most the limit plus the
   largest number of markers one task added; (e) ``workloads.marker_overhead()``
   printed with the card's name and power limit;
5k. the cluster tier across processes, mandelbrot 2048x2048x256 (the main
   path's kernel, the emitter's escape form), each image held bit for bit
   against one single-process ``compute()`` on the GPU lane: (a) a
   ``CruncherServer()`` in a child interpreter on the card (``devices=None``)
   and a ``ClusterAccelerator`` whose mainframe is this process's GPU lane,
   ``tools/dcn_cluster.WARMUP`` + ``CLUSTER_ITERS`` iterations, each iteration's
   shares, wall and bytes each way over the socket printed with the
   Mpixels/s: every image exact, the balancer off the equal split and
   inside the range, the emitted kernel launched in both processes and
   none on the torch route; (b), run first while the server child starts
   (the TCP iterations wait for its end): two ranks of
   ``tools/dcn_cluster.py`` on the card's GPU lane over gloo
   (``GLOO_SOCKET_IFNAME=lo``): the balanced
   calls exact, one exchange of int64 values above 2^31 and float64 values
   exact, the shares, ``ck_dcn_exchange_bytes_total``, the median
   ``ck_dcn_exchange_seconds`` by op and ``gather_cluster``'s clock offsets
   printed, ``merged_chrome_trace`` holding both ranks' spans; (c) the same
   job's elastic windows (each one shifted frame added into a checkpointed
   accumulator) preempted after window ``CLUSTER_KILL_AFTER`` of
   ``CLUSTER_WINDOWS`` (every rank exits 17), a torn newest checkpoint
   planted, and the job rejoined with rank 1 on two partition lanes of the
   card through ``resume_elastic``: the image equal to the undisturbed
   single-process sum, the membership change recorded and replayed.  A
   member that cannot see the card fails the phase.  One card shows
   correctness and the exchange's cost, not scaling across cards: the
   processes share it;
6. transformer: the flagship transformer's forward at the default width
   (vocab 32000, d_model 512, 4 layers, 8 heads of 64, d_ff 2048, bf16,
   ``attention="flash"``, seeded random weights) on ``cuda:0``.  With every
   count set to 0 it answers four request batches (4x2048, 8x1024, 16x256
   and 4x96, which takes the dense fallback); then the counts are read:
   the flash kernel launched once per layer for each of the three tiled
   batches, every launch on the tensor-core route, the dense fallback ran
   only for the T=96 batch, and the plain flash version never ran.  One 1x2048 batch's logits are held against
   the same weights on the CPU (plain versions), and an f32 model's at
   1x1024;
7. transformer train: the same model trained with ``adamw(model, 1e-3)``
   (``__graft_entry__``'s dry-run optimizer) for 8 steps on one seeded
   4x2049 batch (T = 2048): the loss is finite at every step and lower at
   the last than at the first, and with every count set to 0 before them
   each step launched the forward, dq and dk/dv kernels once per layer,
   every launch on the tensor-core route (``LAUNCHES`` and ``BWD_ROUTES``
   by key), and no plain flash ran; one step with ``remat=True`` launches
   the forward twice per layer, on the same route; one step on a 2x97
   batch takes the dense route and launches no flash kernel.  One step's loss and gradients on the card
   are held against the CPU's (plain versions) from the same weights: f32
   at 1x1024, bf16 at 1x2048 beside the CPU's own bf16-vs-f32 gap; and
   the gradients with remat against those without it;
8. ring attention (sp mesh of virtual shards): (a) the ring's three parts
   kernels (``flash_attention_parts``, and the dq and dk/dv kernels of
   ``flash_attention_bwd_parts``) against their plain versions at one ring
   step of the full-width run, 1x2048 queries against 1x2048 keys, H=8,
   D=64, bf16 at "highest", at a diagonal, a below-diagonal and a dead
   offset: all three on the split tensor-core kernels of
   ``csrc/flash_attention_parts_tc.cu`` (route ``tc3``), as
   ``_parts_route`` says, two calls equal bit for bit; each
   timed at the diagonal and the full step beside the FP32 kernel on the
   same operands, its bound on its route and its FP32 bound; (b) ``workloads.run_ring_attention`` at B=1, T=16384, H=8, D=64
   (the heads and head dim of ``TransformerConfig()``, 2048 positions a
   shard, the model's ``max_seq``), bf16 and causal, over sp=8 on
   ``[cuda:0] * 8``: the output and the gradients of ``sum(out**2)``
   against the single-card flash kernels on the whole sequence within 2
   bf16 ulps of each one's largest magnitude, and the same in f32 at
   1x8192 over sp=4 (output within 1e-5, gradients within 5e-4); (c) with
   every count set to 0 before the sp=8 run, each parts kernel launched 64
   times, 28 of them on dead blocks, every launch on ``tc3``, and no
   plain version on the card; the f32 run only on
   the FP32 kernels; (d)
   Ulysses at the same width against the same oracle, and the einsum
   ring's forward against the flash ring's; (e) the ring's forward and
   forward + backward ms and tokens/s beside the single-card kernels'.  A
   virtual mesh's time is the sum of its shards' work on one card, not the
   time of an sp mesh of eight cards;
9. the kernels line, then the last line ``{"ok": true, "device": ...}``.

Exits non-zero without printing a result when no CUDA device is present,
or when the package is not beside this script.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM data sheet, bf16 dense tensor cores
# mandelbrot's work: each pass of the escape loop is 8 FP32-pipe instructions under
# -fmad=false (zx*zx, zy*zy, their sum for the test, zx2 - zy2, + cx, 2*zx, * zy,
# + cy: FADD and FMUL in the SASS of both kernels, tools/sweep_mandelbrot.py), and
# an escaped pixel's failing test 3 more (two squares and their sum); the compare
# (FSETP), the count and the branch are not FP32 arithmetic and are not counted
MANDEL_FP32_PER_PASS = 8
MANDEL_FP32_PER_EXIT = 3
# n-body's work a pair: 18 operations in the source (3 sub; 3 mul + 3 add for r2;
# sqrt; 1 mul; 1 division; 3 mul + 3 add), 16 of them mul/add/sub.  Built with
# -fmad=false and IEEE sqrt and division, as its bits require, the sqrt and the
# division (a reciprocal: 1.0f / x) each take one MUFU op and 4 and 2 instructions
# on the FP32 pipe (their fast paths in the SASS of the emitted loop form).  An
# unfused FP32 instruction issues once a lane a clock: 132 SMs x 128 lanes x
# 1.98 GHz; the MUFU pipe takes 16 a clock an SM.
NBODY_OPS_PER_PAIR = 18
NBODY_FP32_PER_PAIR = NBODY_OPS_PER_PAIR - 2 + 4 + 2
NBODY_MUFU_PER_PAIR = 2
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
BALANCE_REPS = 10
BALANCE_ITERS = 80
BALANCE_HOLD = 20
BALANCE_MIN_STILL = 8
BALANCE_STEPS = (1024, 512, 256)
ALPHA = 1.5                # saxpy's constant, folded into the elementwise kernel
SAXPY_ID = 7005
ENQUEUE_CALLS = 64
# phase 4d's skew: the GPU lane's barrier fence sleeps this long (the fault
# plane's lane-stall), a few times a window's own fence time
STALL_LANE = 0
STALL_MS = 20.0
HOOK_CALLS = 20
EMITTER_SOURCE = "cekirdekler_tpu_torch/kernel/cuda_backend.py"
EMITTER_REPLACES = "cekirdekler_tpu/kernel/pallas_backend.py:404"

SAXPY_SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = a * x[i] + y[i];
}
"""

# phase 5h's planted kernel: a 3-point stencil, guarded at the ends.  Under
# partial_read on x each lane receives only its own slice, so the reads one
# past either end of a lane's range see zeros: the verifier's
# partial-read-halo, which the split run shows at the partition boundary
STENCIL_SRC = """
__kernel void stencil3(__global float* x, __global float* out, int n) {
    int i = get_global_id(0);
    float l = 0.0f;
    float r = 0.0f;
    if (i > 0) { l = x[i - 1]; }
    if (i < n - 1) { r = x[i + 1]; }
    out[i] = l + x[i] + r;
}
"""
VERIFY_ID = 7401
# the main path's launch shapes the reference's verifier finds clean (no
# error finding; tests/test_torch_verify.py holds this set against it)
VERIFY_CLEAN = frozenset({"mandelbrot", "mandelbrot.cu", "streamAdd", "saxpy", "nBody"})
DEBUG_CALLS = 12
# phase 5j: (b)'s kernel runs at least this long, so a marker reached at
# issue cannot pass for one reached when the device retired it; the caller
# polls the in-flight depth every 0.5 ms meanwhile, at least this often
# unless the marker thread holds the interpreter lock while it waits
RETIRE_MS = 50.0
RETIRE_POLLS = 10
# (c) holds the gate this long untriggered; (d)'s pool throttles at this depth
GATE_HOLD_S = 0.2
POOL_QUEUE_LIMIT = 4
MARKERS_ID = 7601
DEBUG_ID = 7402
CKPT_STEPS = 4


def chain(a, b):
    """A three-op chain for the elementwise kernel: compare, where, and an
    arithmetic branch on each side."""
    import torch

    return torch.where(a > b, a * b - 1.5, torch.abs(b) * 0.5)


_T0 = time.perf_counter()
#: (phase name, start time) in the order the phases ran
_PHASES: list[tuple[str, float]] = []


def phase(name: str) -> None:
    now = time.perf_counter()
    _PHASES.append((name, now))
    print(f"== phase: {name} (at {now - _T0:.1f} s)", flush=True)


def phase_seconds() -> dict[str, float]:
    """Each phase's seconds, from its start to the next one's (the last
    to now)."""
    ends = [t for _n, t in _PHASES[1:]] + [time.perf_counter()]
    return {name: round(end - t, 1) for (name, t), end in zip(_PHASES, ends)}


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


def flash_bwd_bound(B: int, T: int, H: int, D: int, causal: bool, dtype, ops_per_d: int = 10,
                    tensors: int = 8) -> tuple[float, str]:
    """Least time (ms) of a flash backward with Tq == Tk == T, and what
    binds it: ``ops_per_d * D`` operations per live (query, key) pair and
    head at the type's peak, against the bytes of ``tensors`` [B, T, H, D]
    tensors each read or written once plus the f32 lse and delta.  The
    whole backward is FlashAttention-2's count, 10 (s recomputed, dp, dq,
    dk, dv: 2 each) over q, k, v, o, dO, dq, dk, dv; the dq kernel's own
    function is 6 (s, dp, dq) over q, k, v, dO, dq, and the dk/dv kernel's
    8 (s, dp, dk, dv) over q, k, v, dO, dk, dv."""
    import torch

    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    ops = float(ops_per_d) * D * pairs
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = float(size * tensors * B * T * H * D + 2 * 4 * B * H * T)
    by_ops, by_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def profiled_ms(fn, reps: int, names: tuple[str, ...] = ()) -> dict[str, float]:
    """Mean device time (ms) per ``fn()`` call of each kernel whose name
    holds one of ``names``, and of all device activity (``"total"``),
    from a ``torch.profiler`` trace of ``reps`` calls, read as
    ``tools/trace_window.py`` reads every trace (a window opened by lead
    kernels; a named kernel's records a whole number a call, up to half a
    call's lost, each lost one read at the mean of the rest); raises
    when the trace shows no device time for one of them.  Unlike CUDA
    events around the calls, this leaves out the host's gaps between
    launches."""
    from cekirdekler_tpu_torch.tools.trace_window import traced_ms

    return traced_ms(fn, reps, names)


def kernel_ms(fn, prefix: str, reps: int) -> tuple[float, float]:
    """(device ms of one ``fn()``'s kernels whose names hold ``prefix``,
    from a profiler trace; the CUDA-event mean ms of back-to-back calls,
    which also holds the host's gaps between launches)."""
    return profiled_ms(fn, reps, (prefix,))[prefix], cuda_ms(fn, reps)


EMITTER_FORMS = ("item", "stream", "loop", "escape")


def gate_forms(forms: dict, want: dict[str, str]) -> None:
    """Each named emitted kernel launched on the form ``want`` names, and
    never on another (``cuda_backend.FORMS``, keyed (name, form))."""
    for name, form in want.items():
        others = [f for f in EMITTER_FORMS if f != form]
        if forms.get((name, form), 0) <= 0 or any(forms.get((name, f), 0) for f in others):
            raise AssertionError(f"emitted {name} should launch on the {form} form only: "
                                 f"{forms}")


def mandel_bound(counts: np.ndarray, max_iter: int) -> tuple[float, str]:
    """Least time (ms) of one mandelbrot launch over an image whose escape
    counts are ``counts``, and what binds it: its passes' and escaped
    pixels' FP32-pipe instructions at the unfused issue rate, against its
    bytes (the f32 image written once)."""
    counts = np.asarray(counts, dtype=np.float64)
    instr = MANDEL_FP32_PER_PASS * counts.sum() + MANDEL_FP32_PER_EXIT * (counts < max_iter).sum()
    by_ops = float(instr) / FP32_INSTR_PER_S * 1e3
    by_bytes = 4.0 * counts.size / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def nbody_bound(n: int) -> tuple[float, str]:
    """Least time (ms) of one n-body launch over n bodies and what binds
    it: its n² pairs' FP32-pipe instructions at the unfused issue rate
    and their MUFU ops at the MUFU rate (the two pipes run side by side),
    against its bytes (x, y, z and three velocities read, three written)."""
    pairs = float(n) * n
    by_ops = max(pairs * NBODY_FP32_PER_PAIR / FP32_INSTR_PER_S,
                 pairs * NBODY_MUFU_PER_PAIR / MUFU_PER_S) * 1e3
    by_bytes = (6 + 3) * 4.0 * n / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def check_emitter_stream(cuda_backend, emitted, dev, n: int) -> dict[str, dict]:
    """The emitted streamAdd and saxpy at ``n`` floats against the torch
    lowering on the card, bit for bit, on the streaming form; each timed by
    the profiler (its kernel) and by CUDA events (the wrapper's calls),
    beside the one PyTorch call computing it (the profiler's device time).
    Returns their kernels-line rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1234 + n)
    a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
    alpha = 1.5
    cases = (  # name, arrays for the kernel, for the plain version, values, library call
        ("streamAdd", (a, b, torch.zeros(n, device=dev)), (a, b, torch.zeros(n, device=dev)),
         (), lambda out: torch.add(a, b, out=out)),
        ("saxpy", (a, b.clone()), (a, b.clone()), (alpha,),
         lambda out: out.add_(a, alpha=alpha)),
    )
    rows = {}
    for name, on_k, on_p, values, library in cases:
        kfn, pfn = emitted(name, n)
        cuda_backend.FORMS.reset()
        kfn(0, on_k, values)
        pfn(0, on_p, values)
        torch.cuda.synchronize()
        gate_forms(dict(cuda_backend.FORMS.by_key), {name: "stream"})
        if not torch.equal(on_k[-1], on_p[-1]):
            err = float((on_k[-1] - on_p[-1]).abs().max())
            raise AssertionError(f"emitted {name} at {n} vs plain: max abs err {err}")
        ms, event_ms = kernel_ms(lambda: kfn(0, on_k, values), "ck_kernel", 20)
        scratch = on_p[-1].clone()
        rows[f"emitter:{name}"] = r = dict(
            max_abs_err=0.0, ms=ms, event_ms=event_ms,
            plain_ms=cuda_ms(lambda: pfn(0, on_p, values), 5),
            library_ms=profiled_ms(lambda: library(scratch), 20)["total"],
            library_event_ms=cuda_ms(lambda: library(scratch), 20),
            bound_ms=12.0 * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes", n=n)
        print(f"emitted {name} n={n} (streaming form): kernel {ms:.4f} ms (CUDA events "
              f"{event_ms:.4f} ms), library {r['library_ms']:.4f} ms (CUDA events "
              f"{r['library_event_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms (bytes), bit-exact")
    return rows


PARTS_OPS_PER_D = {"fwd": 4, "dq": 6, "dkv": 8}
# the split kernels' tensor-core work per live pair, head and column: q.k
# once and p.v three times (forward); s, dp once and ds.K three times (dq);
# sT, dpT once and pT.dO, dsT.Q three times each (dk/dv); 2 operations a
# product
SPLIT_OPS_PER_D = {"fwd": 8, "dq": 10, "dkv": 16}


def live_pairs(Tq: int, Tk: int, q_pos0: int, k_pos0: int, causal: bool) -> int:
    """(query, key) pairs of one block that the mask leaves visible: key
    ``j`` is visible to query ``i`` where ``k_pos0 + j <= q_pos0 + i``."""
    if not causal:
        return Tq * Tk
    return int(np.clip(q_pos0 - k_pos0 + 1 + np.arange(Tq), 0, Tk).sum())


def parts_bound(kind: str, B: int, Tq: int, Tk: int, H: int, D: int, q_pos0: int, k_pos0: int,
                causal: bool, in_size: int, route: str = "fp32") -> tuple[float, str]:
    """Least time (ms) of one ring step's parts kernel on ``route`` and what
    binds it.  Operations per live pair and head: on ``"fp32"``,
    ``PARTS_OPS_PER_D[kind] * D`` (4 for the forward's q.k and p.v; 6 for
    dq's s, dp and dq; 8 for dk/dv's s, dp, dk and dv, as
    :func:`flash_bwd_bound` counts them) at the FP32 peak, the ring's
    "highest" as f32 arithmetic; on ``"tc3"``, the split kernels' tensor-core
    work ``SPLIT_OPS_PER_D[kind] * D`` at the bf16 peak.  Bytes: the inputs
    read once (q, k, v, and for the backward dO, of ``in_size`` bytes an
    element, and its f32 lse and delta rows) and the f32 outputs written
    once (acc, m and l; dq; dk and dv)."""
    pairs = B * H * live_pairs(Tq, Tk, q_pos0, k_pos0, causal)
    if route == "tc3":
        ops, rate = float(SPLIT_OPS_PER_D[kind]) * D * pairs, BF16_OPS_PER_S
    else:
        ops, rate = float(PARTS_OPS_PER_D[kind]) * D * pairs, FP32_OPS_PER_S
    rows, q_el, k_el = B * Tq * H, B * Tq * H * D, B * Tk * H * D
    if kind == "fwd":
        nbytes = in_size * (q_el + 2 * k_el) + 4 * (q_el + 2 * rows)
    else:
        out_el = q_el if kind == "dq" else 2 * k_el
        nbytes = in_size * (2 * q_el + 2 * k_el) + 4 * (2 * rows + out_el)
    by_ops, by_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def gate_ring_launches(launches: dict, n: int, causal: bool) -> dict[str, int]:
    """The launch counts of one ring forward + backward over ``n``
    positions (``workloads.run_ring_attention``'s ``launches``): each
    parts kernel ``n * n`` times, ``n (n - 1) / 2`` of them on dead blocks
    when causal, and no plain version on the card.  Returns the launches
    by kernel."""
    kinds = ("fwd", "dq", "dkv")
    want = dict.fromkeys(kinds, n * n)
    want_dead = dict.fromkeys(kinds, n * (n - 1) // 2) if causal else {}
    plain = (launches["plain_flash"].get("cuda", 0), launches["plain_flash_bwd"].get("cuda", 0))
    if launches["parts"] != want or launches["dead"] != want_dead or plain != (0, 0):
        raise AssertionError(f"ring launch counts {launches}: want parts {want}, dead "
                             f"{want_dead} and no plain run on the card")
    return dict(launches["parts"])


def bf16_ulps(t, n: float = 2.0) -> float:
    """``n`` bf16 ulps at the largest magnitude of ``t``."""
    return n * 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 7)


def check_flash(fa, dev) -> dict:
    """The flash forward kernel against its plain version (key blocks at
    the kernel's tile width) on the card at the transformer's shapes (H=8,
    D=64).  f32 at "highest" within 1e-5, bf16 at "default" within 2 bf16
    ulps of the output's largest magnitude, the lse within 1e-5.  Each case
    runs on the route ``_route`` names (the tensor-core kernel of
    ``csrc/flash_attention_tc.cu`` for bf16 at "default", the FP32 kernel
    of ``csrc/flash_attention.cu`` for f32 at "highest"), and a tc case's
    second call gives the same bits.  Each case is timed beside the plain
    version and ``scaled_dot_product_attention``, and the first also by the
    FP32 kernel on the same bf16 inputs; returns the kernels-line row of
    the first (the 4x2048 causal bf16 forward of the model's tiled batch)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(2024)
    H, D = 8, 64
    cases = (  # label, B, T, causal, dtype, precision, with_lse, route
        ("4x2048 causal bf16 default", 4, 2048, True, torch.bfloat16, "default", False, "tc"),
        ("4x2048 causal bf16 default + lse", 4, 2048, True, torch.bfloat16, "default", True,
         "tc"),
        ("4x1024 causal f32 highest", 4, 1024, True, torch.float32, "highest", False, "fp32"),
        ("4x2048 full bf16 default", 4, 2048, False, torch.bfloat16, "default", False, "tc"),
    )
    row = None
    for label, B, T, causal, dtype, prec, with_lse, route in cases:
        q, k, v = (torch.randn(B, T, H, D, generator=g).to(dtype).to(dev) for _ in range(3))
        before = dict(fa.LAUNCHES.by_key)
        res = fa._flash_forward(q, k, v, causal, 512, 512, prec, with_lse=with_lse)
        out = res[0] if with_lse else res
        want, want_lse = fa.flash_attention_plain(q, k, v, causal, fa.KERNEL_BLOCK, prec, dtype)
        torch.cuda.synchronize()
        launched = {key: n - before.get(key, 0) for key, n in fa.LAUNCHES.by_key.items()
                    if n != before.get(key, 0)}
        if launched != {route: 1}:
            raise AssertionError(f"flash forward ({label}) launched {launched}, want one on "
                                 f"the {route} route")
        if route == "tc":
            again = fa._flash_forward(q, k, v, causal, 512, 512, prec, with_lse=with_lse)
            pairs = ((res[0], again[0]), (res[1], again[1])) if with_lse else ((res, again),)
            for a, b in pairs:
                bits = torch.int16 if a.element_size() == 2 else torch.int32
                if not torch.equal(a.view(bits), b.view(bits)):
                    raise AssertionError(f"flash forward ({label}): two calls differ")
            del again
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
        fp32 = ""
        if row is None:
            # the FP32 kernel on the same bf16 inputs, as the route was before
            old, _ = fa._launch(q, k, v, causal, prec, dtype, False, route="fp32")
            old_ms = cuda_ms(lambda: fa._launch(q, k, v, causal, prec, dtype, False,
                                                route="fp32"), 10)
            fp32 = (f"  FP32 kernel {old_ms:.4f} ms (max_abs_err "
                    f"{float((old.float() - want.float()).abs().max())})")
            del old
        print(f"flash {label} ({route} route"
              + (", two calls equal bit for bit" if route == "tc" else "")
              + f"): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by})  max_abs_err {err} (tol {tol})"
              + ("" if lse_err is None else f"  lse err {lse_err}") + fp32)
        if row is None:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, qt, kt, vt, res, out, want, want_lse
    return row


def check_flash_bwd(fa, dev) -> tuple[dict, dict]:
    """The flash backward's dq and dk/dv kernels against the plain backward
    (blocks at the kernels' tile width) on the card, from the forward
    kernel's output and lse, at the transformer's shapes (H=8, D=64).  f32
    at "highest" within 1e-5 of each gradient's largest magnitude (the FP32
    kernels), bf16 at "default" within 2 bf16 ulps there (the tensor-core
    kernels, whose f32 sums run in another order).  Each case runs on the
    route ``_route`` names, and a second call gives the same bits.
    Each kernel is timed from a profiler trace under its own name, the
    pair and the plain backward by CUDA events, and
    the library as the device time of ``torch.autograd.grad`` through one
    ``scaled_dot_product_attention`` output (its backward alone, from a
    profiler trace: timed by CUDA events it is bound by the host).
    Returns the
    kernels-line rows of the two kernels from the first case (the 4x2048
    causal bf16 backward of the model's train step): each row's bound is
    its own kernel's function; plain and library times are the whole
    backward's, in both rows."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(2025)
    H, D = 8, 64
    cases = (  # label, B, T, causal, dtype, precision
        ("4x2048 causal bf16 default", 4, 2048, True, torch.bfloat16, "default"),
        ("4x1024 causal f32 highest", 4, 1024, True, torch.float32, "highest"),
        ("4x2048 full bf16 default", 4, 2048, False, torch.bfloat16, "default"),
    )
    rows = None
    for label, B, T, causal, dtype, prec in cases:
        q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dtype).to(dev) for _ in range(4))
        out, lse, (qs, ks, vs) = fa._flash_forward(q, k, v, causal, 512, 512, prec, with_lse=True)

        def bwd():
            return fa._flash_backward(qs, ks, vs, out, lse, do, causal, 512, 512, prec,
                                      (dtype,) * 3)

        def plain():
            kb = fa.KERNEL_BLOCK
            return fa.flash_attention_bwd_plain(*fa._stream_cast(prec, qs, ks, vs, do), lse,
                                                fa._delta(out, do), causal, kb, kb, prec,
                                                (dtype,) * 3)

        route = fa._route(qs.dtype, prec)
        names = (("fa_bwd_dq_tc_kernel", "fa_bwd_dkv_tc_kernel") if route == "tc"
                 else ("fa_bwd_dq_kernel", "fa_bwd_dkv_kernel"))
        routes = fa.BWD_ROUTES.by_key.get(route, 0)
        got, again, want = bwd(), bwd(), plain()
        torch.cuda.synchronize()
        if fa.BWD_ROUTES.by_key.get(route, 0) - routes != 4:
            raise AssertionError(f"flash backward ({label}) left the {route} route: "
                                 f"{dict(fa.BWD_ROUTES.by_key)}")
        for name, a, b in zip(("dq", "dk", "dv"), got, again):
            bits = torch.int16 if a.element_size() == 2 else torch.int32
            if not torch.equal(a.view(bits), b.view(bits)):
                raise AssertionError(f"flash backward {name} ({label}): two calls differ")
        errs = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = float((a.float() - w.float()).abs().max())
            tol = 1e-5 * float(w.abs().max()) if dtype == torch.float32 else bf16_ulps(w)
            if not bool(torch.isfinite(a).all()) or err > tol:
                raise AssertionError(f"flash backward {name} kernel vs plain ({label}): max abs "
                                     f"err {err} > {tol}")
            errs[name] = (err, tol)
        pair_ms = cuda_ms(bwd, 10)
        each = profiled_ms(bwd, 10, names)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        library_ms = profiled_ms(lambda: torch.autograd.grad(
            sdpa, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)["total"]
        whole, _ = flash_bwd_bound(B, T, H, D, causal, dtype)
        bound_dq = flash_bwd_bound(B, T, H, D, causal, dtype, ops_per_d=6, tensors=5)
        bound_dkv = flash_bwd_bound(B, T, H, D, causal, dtype, ops_per_d=8, tensors=6)
        print(f"flash backward {label} ({route} route, two calls equal bit for bit): "
              f"{names[0]} {each[names[0]]:.4f} ms (bound "
              f"{bound_dq[0]:.4f}), {names[1]} {each[names[1]]:.4f} ms (bound "
              f"{bound_dkv[0]:.4f}); backward by CUDA events {pair_ms:.4f} ms against its bound "
              f"{whole:.4f} ms; the two kernels and delta by the profiler {each['total']:.4f} ms; "
              f"plain {plain_ms:.4f} ms; SDPA backward {library_ms:.4f} ms; max abs err "
              + ", ".join(f"{n} {e} (tol {t})" for n, (e, t) in errs.items()))
        if rows is None:
            common = dict(plain_ms=plain_ms, library_ms=library_ms)
            rows = (dict(max_abs_err=errs["dq"][0], ms=each[names[0]],
                         bound_ms=bound_dq[0], bound_by=bound_dq[1], **common),
                    dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                         ms=each[names[1]], bound_ms=bound_dkv[0],
                         bound_by=bound_dkv[1], **common))
        del q, k, v, do, out, lse, qs, ks, vs, got, again, want, qt, kt, vt, sdpa
    return rows


def _within(got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises above ``tol``."""
    import torch

    got = got.detach()
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol:
        raise AssertionError(f"max abs err {err} > {tol}")
    return err


def _same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def check_ring_parts(fa, dev, T: int = 2048) -> dict[str, dict]:
    """Phase 8 (a): the three parts kernels against their plain versions
    (key blocks at the kernels' tile width) at one ring step of the
    full-width run: 1x2048 queries against 1x2048 keys, H=8, D=64, bf16 at
    "highest", at a diagonal (q_pos0 = k_pos0 = 3*2048), a below-diagonal
    (5*2048 against 2*2048) and a dead offset (2048 against 3*2048).  All
    three run on the split tensor-core kernels
    (``csrc/flash_attention_parts_tc.cu``, route ``"tc3"``), as
    ``_parts_route`` says; each step's launches are held to that route,
    and two calls give the same bits.  Tolerances: acc, m
    and l within 1e-5 of each one's largest magnitude on the rows that see
    a key (f32 accuracy on both sides; the sums differ only in order), the
    empty rows' state exactly; the gradients within 1e-5 of each one's
    largest magnitude, from the lse and delta of the plain diagonal step
    (every row sees a key, as the ring's global ones do).  Each kernel is
    timed at the diagonal and the full step from a profiler trace, beside
    the FP32 kernel on the same operands (a route override), its plain
    version, its bound on its route and its FP32 bound.  Returns the
    kernels-line rows, from the full step: 28 of the ring's 36 live steps
    are full ones."""
    import torch

    H, D = 8, 64
    g = torch.Generator().manual_seed(2026)
    q, k, v, do = (torch.randn(1, T, H, D, generator=g).to(torch.bfloat16).to(dev)
                   for _ in range(4))
    kb = fa.KERNEL_BLOCK
    acc, m, l = fa.flash_attention_parts_plain(q, k, v, 3 * T, 3 * T, True, kb, "highest")
    lse = m + torch.log(l)
    delta = (do.float() * (acc / l[..., None]).to(torch.bfloat16).float()).sum(dim=-1)
    routes = {kind: fa._parts_route(kind, q.dtype, "highest") for kind in ("fwd", "dq", "dkv")}
    if routes != dict.fromkeys(("fwd", "dq", "dkv"), "tc3"):
        raise AssertionError(f"the ring's bf16 parts at \"highest\" route {routes}")
    steps = {"diagonal": (3 * T, 3 * T), "full": (5 * T, 2 * T), "dead": (T, 3 * T)}
    rows = {}
    for step, (q_pos0, k_pos0) in steps.items():
        before = (dict(fa.PARTS_FWD_ROUTES.by_key), dict(fa.BWD_ROUTES.by_key))
        got = fa.flash_attention_parts(q, k, v, q_pos0, k_pos0, True, 512, 512)
        bwd = fa.flash_attention_bwd_parts(q, k, v, do, lse, delta, q_pos0, k_pos0, True, 512,
                                           512)
        torch.cuda.synchronize()
        took = tuple({key: n - was.get(key, 0) for key, n in c.by_key.items()
                      if n != was.get(key, 0)}
                     for c, was in zip((fa.PARTS_FWD_ROUTES, fa.BWD_ROUTES), before))
        if took != ({"tc3": 1}, {"tc3": 2}):
            raise AssertionError(f"ring step ({step}) took routes {took}: want the forward, dq "
                                 "and dk/dv on tc3")
        again = fa.flash_attention_parts(q, k, v, q_pos0, k_pos0, True, 512, 512)
        again_b = fa.flash_attention_bwd_parts(q, k, v, do, lse, delta, q_pos0, k_pos0, True,
                                               512, 512)
        torch.cuda.synchronize()
        if not (_same_bits(got, again) and _same_bits(bwd, again_b)):
            raise AssertionError(f"parts kernels ({step}): two calls differ")
        del again, again_b
        want = fa.flash_attention_parts_plain(q, k, v, q_pos0, k_pos0, True, kb, "highest")
        torch.cuda.synchronize()
        live = want[1] > -1e29
        errs = {}
        for name, a, w in zip(("acc", "m", "l"), got, want):
            sel = live[..., None].expand_as(a) if name == "acc" else live
            if not torch.equal(a[~sel], w[~sel]):
                raise AssertionError(f"parts kernel ({step}): {name} of the rows that see no "
                                     "key is not the empty state")
            if bool(sel.any()):
                try:
                    errs[name] = _within(a[sel], w[sel], 1e-5 * float(w[sel].abs().max()))
                except AssertionError as exc:
                    raise AssertionError(f"parts kernel vs plain ({step}) {name}: {exc}") from None
        want_b = fa.flash_attention_bwd_parts_plain(q, k, v, do, lse, delta, q_pos0, k_pos0,
                                                    True, kb, kb, "highest")
        torch.cuda.synchronize()
        for name, a, w in zip(("dq", "dk", "dv"), bwd, want_b):
            try:
                errs[name] = _within(a, w, 1e-5 * float(w.abs().max()))
            except AssertionError as exc:
                raise AssertionError(f"backward parts kernels vs plain ({step}) {name}: "
                                     f"{exc}") from None
        print(f"ring step 1x{T}x{H}x{D} bf16 highest, {step} (q_pos0 {q_pos0}, k_pos0 {k_pos0}; "
              f"routes {routes}, two calls equal bit for bit): max abs err {json.dumps(errs)}")
        if step == "dead":
            continue

        def fwd(route=None):
            return fa._launch_parts(q, k, v, q_pos0, k_pos0, True, "highest", route=route)

        def bwd_call(bwd_routes=None):
            return fa._launch_bwd(q, k, v, do, fa._row_column(lse), fa._row_column(delta), True,
                                  "highest", (torch.float32,) * 3, q_pos0, k_pos0, parts=True,
                                  routes=bwd_routes)

        fwd_ms = profiled_ms(fwd, 10, ("fa_fwd_parts",))["fa_fwd_parts"]
        fwd_fp32 = profiled_ms(lambda: fwd("fp32"), 10, ("fa_fwd_parts",))["fa_fwd_parts"]
        each = profiled_ms(bwd_call, 10, ("fa_bwd_dq", "fa_bwd_dkv"))
        each_fp32 = profiled_ms(lambda: bwd_call(("fp32", "fp32")), 10,
                                ("fa_bwd_dq", "fa_bwd_dkv"))
        plain_fwd = cuda_ms(lambda: fa.flash_attention_parts_plain(
            q, k, v, q_pos0, k_pos0, True, kb, "highest"), 2, warmup=1)
        plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_parts_plain(
            q, k, v, do, lse, delta, q_pos0, k_pos0, True, kb, kb, "highest"), 1, warmup=1)
        bounds = {kind: parts_bound(kind, 1, T, T, H, D, q_pos0, k_pos0, True, 2, routes[kind])
                  for kind in ("fwd", "dq", "dkv")}
        fp32_bounds = {kind: parts_bound(kind, 1, T, T, H, D, q_pos0, k_pos0, True, 2)[0]
                       for kind in ("fwd", "dq", "dkv")}
        print(f"ring step {step}: forward parts kernel (tc3) {fwd_ms:.4f} ms, FP32 kernel on the "
              f"same operands {fwd_fp32:.4f} ms (bound {bounds['fwd'][0]:.4f} ms, "
              f"{bounds['fwd'][1]}, bf16 peak; FP32 bound {fp32_bounds['fwd']:.4f}); dq kernel "
              f"(tc3) {each['fa_bwd_dq']:.4f} ms, FP32 kernel {each_fp32['fa_bwd_dq']:.4f} ms "
              f"(bound {bounds['dq'][0]:.4f}, bf16 peak; FP32 bound {fp32_bounds['dq']:.4f}); "
              f"dk/dv kernel (tc3) {each['fa_bwd_dkv']:.4f} ms, FP32 kernel "
              f"{each_fp32['fa_bwd_dkv']:.4f} ms (bound "
              f"{bounds['dkv'][0]:.4f}, bf16 peak; FP32 bound {fp32_bounds['dkv']:.4f}); plain "
              f"forward {plain_fwd:.4f} ms, plain backward {plain_bwd:.4f} ms; library: none "
              "(no PyTorch call gives the unnormalized parts or the ring-global partial "
              "gradients)")
        if step == "full":
            rows = {
                "flash_attention_parts": dict(
                    max_abs_err=max(errs["acc"], errs["m"], errs["l"]), ms=fwd_ms,
                    plain_ms=plain_fwd, bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1],
                    library_ms=None, kernel_route="tc3", fp32_ms=fwd_fp32,
                    fp32_bound_ms=fp32_bounds["fwd"]),
                "flash_attention_bwd_parts_dq": dict(
                    max_abs_err=errs["dq"], ms=each["fa_bwd_dq"], plain_ms=plain_bwd,
                    bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1], library_ms=None,
                    kernel_route="tc3", fp32_ms=each_fp32["fa_bwd_dq"],
                    fp32_bound_ms=fp32_bounds["dq"]),
                "flash_attention_bwd_parts_dkv": dict(
                    max_abs_err=max(errs["dk"], errs["dv"]), ms=each["fa_bwd_dkv"],
                    plain_ms=plain_bwd, bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1],
                    library_ms=None, kernel_route="tc3", fp32_ms=each_fp32["fa_bwd_dkv"],
                    fp32_bound_ms=fp32_bounds["dkv"]),
            }
    return rows


def _single_card(fa, q, k, v) -> tuple:
    """The oracle: the single-card flash kernels on the whole sequence,
    forward and the gradients of ``sum(out**2)``, timed by CUDA events
    (forward, forward + backward)."""
    import torch

    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    out = fa.flash_attention(*qkv, True, 512, 512, "highest")
    marks[1].record()
    grads = torch.autograd.grad(out.float().pow(2).sum(), qkv)
    marks[2].record()
    marks[2].synchronize()
    return out.detach(), grads, marks[0].elapsed_time(marks[1]), marks[0].elapsed_time(marks[2])


def _ring_counters(fa) -> tuple:
    return (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.PARTS_LAUNCHES, fa.PARTS_DEAD, fa.PLAIN_RUNS,
            fa.PLAIN_BWD_RUNS, fa.ROUTES, fa.BWD_ROUTES, fa.PARTS_FWD_ROUTES)


def check_ring(wl, fa, par, dev, card: str, T: int = 16384) -> dict[str, int]:
    """Phase 8 (b)-(e); returns the parts kernels' launches on the sp=8
    run, by kernel.  The f32 case runs at ``T // 2`` over sp=4."""
    import torch

    B, H, D, n = 1, 8, 64, 8
    mesh = par.make_mesh([dev] * n, sp=n)
    wl.run_ring_attention(mesh, 1, T // 16, H, D, torch.bfloat16, seed=1)  # warm-up, not counted
    for counter in _ring_counters(fa):
        counter.reset()
    r = wl.run_ring_attention(mesh, B, T, H, D, torch.bfloat16, causal=True, flash=True,
                              grad=True, seed=5)
    seen = {c: dict(getattr(fa, c).by_key) for c in ("PARTS_LAUNCHES", "PARTS_DEAD",
                                                   "PLAIN_RUNS", "PLAIN_BWD_RUNS",
                                                   "PARTS_FWD_ROUTES", "BWD_ROUTES")}
    print(f"ring {B}x{T}x{H}x{D} bf16 causal over sp={n} on [{dev}] * {n}: launch counts "
          f"{r['launches']}; counters after the run {seen}")
    launches = gate_ring_launches(r["launches"], n, True)
    if fa.LAUNCHES.count or fa.BWD_LAUNCHES.count or seen["PARTS_LAUNCHES"] != launches:
        raise AssertionError("the ring ran other kernels than its parts kernels, or its "
                             f"counts disagree: {seen}")
    if seen["PARTS_FWD_ROUTES"] != {"tc3": launches["fwd"]} or \
            seen["BWD_ROUTES"] != {"tc3": launches["dq"] + launches["dkv"]}:
        raise AssertionError("the bf16 ring at \"highest\" should run every parts kernel on "
                             "the split tensor-core kernels (tc3): forward "
                             f"{seen['PARTS_FWD_ROUTES']}, backward {seen['BWD_ROUTES']}")
    out_s, grads_s, fwd_s, both_s = _single_card(fa, r["q"], r["k"], r["v"])
    worst = {}
    for name, a, w in zip(("out", "dq", "dk", "dv"), (r["out"], *r["grads"]),
                          (out_s, *grads_s)):
        tol = bf16_ulps(w.float())
        try:
            worst[name] = _within(a, w, tol) / (tol / 2.0)
        except AssertionError as exc:
            raise AssertionError(f"ring sp={n} vs single-card flash, {name}: {exc}") from None
    sec = r["seconds"]
    print(f"ring sp={n} vs single-card flash: worst error in bf16 ulps of the largest "
          f"magnitude {json.dumps(worst)} (limit 2)")
    print(f"ring sp={n} {B}x{T}x{H}x{D} bf16 causal (virtual shards, one card; the sum of "
          f"the shards' work, not an 8-card time): forward {sec['forward'] * 1e3:.3f} ms "
          f"({r['tokens_per_s']['forward']:.1f} tokens/s), forward + backward "
          f"{sec['forward_backward'] * 1e3:.3f} ms "
          f"({r['tokens_per_s']['forward_backward']:.1f} tokens/s); single-card flash "
          f"forward {fwd_s:.3f} ms ({B * T / fwd_s * 1e3:.1f} tokens/s), forward + backward "
          f"{both_s:.3f} ms ({B * T / both_s * 1e3:.1f} tokens/s); CUDA events, on {card}")

    # (d) Ulysses at the same width, and the einsum ring's forward
    for counter in _ring_counters(fa):
        counter.reset()
    qkv = [t.detach().requires_grad_(True) for t in (r["q"], r["k"], r["v"])]
    out_u = par.ulysses_attention_sharded(mesh, *qkv, causal=True, flash=True)
    grads_u = torch.autograd.grad(out_u.float().pow(2).sum(), qkv)
    torch.cuda.synchronize()
    counts = (fa.LAUNCHES.count, dict(fa.BWD_LAUNCHES.by_key), fa.PARTS_LAUNCHES.count,
              fa.PLAIN_RUNS.by_key.get("cuda", 0), fa.PLAIN_BWD_RUNS.by_key.get("cuda", 0))
    if counts != (n, {"dq": n, "dkv": n}, 0, 0, 0):
        raise AssertionError(f"Ulysses launch counts (forward, backward, parts, plain, plain "
                             f"backward) {counts}: want one forward and one backward per "
                             "position and nothing else")
    worst_u = {}
    for name, a, w in zip(("out", "dq", "dk", "dv"), (out_u, *grads_u), (out_s, *grads_s)):
        tol = bf16_ulps(w.float())
        try:
            worst_u[name] = _within(a, w, tol) / (tol / 2.0)
        except AssertionError as exc:
            raise AssertionError(f"Ulysses sp={n} vs single-card flash, {name}: {exc}") from None
    with torch.no_grad():
        out_e = par.ring_attention_sharded(mesh, r["q"], r["k"], r["v"], causal=True,
                                           flash=False)
    tol = bf16_ulps(r["out"].float())
    try:
        err_e = _within(out_e, r["out"], tol) / (tol / 2.0)
    except AssertionError as exc:
        raise AssertionError(f"einsum ring vs flash ring forward: {exc}") from None
    print(f"Ulysses sp={n} vs single-card flash: worst error in bf16 ulps {json.dumps(worst_u)} "
          f"(limit 2), launch counts {counts}; einsum ring forward vs flash ring: {err_e} "
          "bf16 ulps (limit 2)")
    del r, out_s, grads_s, out_u, grads_u, out_e, qkv

    # f32 at 1x8192 over sp=4, on the FP32 parts kernels
    mesh4 = par.make_mesh([dev] * 4, sp=4)
    for counter in _ring_counters(fa):
        counter.reset()
    r = wl.run_ring_attention(mesh4, 1, T // 2, H, D, torch.float32, causal=True, flash=True,
                              grad=True, seed=6)
    took = (dict(fa.PARTS_FWD_ROUTES.by_key), dict(fa.BWD_ROUTES.by_key))
    if took != ({"fp32": 16}, {"fp32": 32}):
        raise AssertionError(f"the f32 ring left the FP32 parts kernels: {took}")
    out_s, grads_s, _, _ = _single_card(fa, r["q"], r["k"], r["v"])
    errs = {}
    for name, a, w in zip(("out", "dq", "dk", "dv"), (r["out"], *r["grads"]),
                          (out_s, *grads_s)):
        try:
            errs[name] = _within(a, w, 1e-5 if name == "out" else 5e-4)
        except AssertionError as exc:
            raise AssertionError(f"f32 ring sp=4 vs single-card flash, {name}: {exc}") from None
    print(f"ring sp=4 1x{T // 2}x{H}x{D} f32 causal vs single-card flash: max abs err "
          f"{json.dumps(errs)} (limits 1e-5 output, 5e-4 gradients); forward "
          f"{r['seconds']['forward'] * 1e3:.3f} ms, forward + backward "
          f"{r['seconds']['forward_backward'] * 1e3:.3f} ms")
    return launches


def _loss_and_grads(model, batch) -> tuple[float, dict]:
    loss = model.loss_fn(batch)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def check_training(wl, fa, card: str) -> tuple[int, int]:
    """The train phase; returns the dq and dk/dv kernels' launch counts
    over its 8 steps."""
    import dataclasses

    import torch

    from cekirdekler_tpu_torch.models import Transformer, TransformerConfig, adamw

    cfg = TransformerConfig(attention="flash")
    n = cfg.n_layers
    model = Transformer(cfg, seed=0)
    opt = adamw(model, 1e-3)
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2049))).cuda()}
    counters = (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.PLAIN_RUNS, fa.PLAIN_BWD_RUNS, fa.ROUTES,
                fa.BWD_ROUTES)

    def run(steps, b, remat=None):
        for counter in counters:
            counter.reset()
        tr = wl.run_transformer_train(model, opt, b, steps, remat=remat)
        seen = (dict(fa.LAUNCHES.by_key), dict(fa.BWD_LAUNCHES.by_key), fa.PLAIN_RUNS.count,
                fa.PLAIN_BWD_RUNS.count, dict(fa.ROUTES.by_key))
        return tr, seen

    tr, seen = run(8, batch)
    steps = len(tr["losses"])
    print(f"train steps 4x2048: losses {tr['losses']}; launch counts {tr['launches']}")
    for i, (tps, sec) in enumerate(zip(tr["tokens_per_s"], tr["seconds"])):
        print(f"train step {i}: {tps:.1f} tokens/s ({sec * 1e3:.3f} ms, CUDA events) on {card}")
    if not all(np.isfinite(tr["losses"])) or not tr["losses"][-1] < tr["losses"][0]:
        raise AssertionError(f"train losses not finite or not falling: {tr['losses']}")
    want = ({"tc": steps * n}, {"dq": steps * n, "dkv": steps * n}, 0, 0, {"tiled": steps * n})
    if seen != want or tr["launches"]["flash_attention"] != steps * n:
        raise AssertionError(f"train launch counts (forward by route, backward, plain forward, "
                             f"plain backward, routes) {seen}, want {want}")
    launches = (seen[1]["dq"], seen[1]["dkv"])
    routes = dict(fa.BWD_ROUTES.by_key)
    print(f"train steps 4x2048: forward launches by route {seen[0]} (want all {steps * n} on "
          f"tc), backward launches by route {routes} (want all {2 * steps * n} on tc)")
    if routes != {"tc": 2 * steps * n}:
        raise AssertionError(f"train backward routes {routes}: want every dq and dk/dv launch "
                             "on the tensor-core kernels")

    tr, seen = run(1, batch, remat=True)
    print(f"one remat step: loss {tr['losses'][0]}, {tr['tokens_per_s'][0]:.1f} tokens/s; "
          f"launch counts {tr['launches']}; forward launches by route {seen[0]}")
    want = ({"tc": 2 * n}, {"dq": n, "dkv": n}, 0, 0, {"tiled": 2 * n})
    if seen != want:
        raise AssertionError(f"remat step launch counts {seen}, want {want}")
    short = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 97))).cuda()}
    tr, seen = run(1, short)
    print(f"one 2x96 step (dense route): loss {tr['losses'][0]}; launch counts {tr['launches']}")
    if seen != ({}, {}, 0, 0, {"dense": n}) or not np.isfinite(tr["losses"][0]):
        raise AssertionError(f"2x96 step: launch counts {seen}, want the dense route only")

    # remat recomputes each block from the same inputs: the same gradients
    del model, opt
    one = {"tokens": batch["tokens"][:1]}
    model = Transformer(cfg, seed=0)
    loss_a, grads_a = _loss_and_grads(model, one)
    model.config = dataclasses.replace(cfg, remat=True)
    loss_b, grads_b = _loss_and_grads(model, one)
    diff = {k: float((g - grads_b[k]).abs().max()) for k, g in grads_a.items()}
    print(f"bf16 1x2048 gradients, remat vs not: loss {loss_a} / {loss_b}; max abs diff "
          f"{max(diff.values())} (embed {diff['embed']} at |g| <= "
          f"{float(grads_a['embed'].abs().max())})")
    if loss_a != loss_b or any(v != 0.0 for k, v in diff.items() if k != "embed") or \
            diff["embed"] > 1e-6 * float(grads_a["embed"].abs().max()):
        raise AssertionError("gradients with remat differ from those without it")
    del model, grads_b

    # one step's loss and gradients on the card against the CPU's
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    b32 = {"tokens": batch["tokens"][:1, :1025].cpu()}
    l_card, g_card = _loss_and_grads(Transformer(cfg32, seed=0), b32)
    l_cpu, g_cpu = _loss_and_grads(Transformer(cfg32, device="cpu", seed=0), b32)
    worst = max((float((g_card[k] - g).abs().max()) / float(g.abs().max()), k)
                for k, g in g_cpu.items())
    print(f"f32 1x1024 train step, card vs CPU: loss {l_card} / {l_cpu} (diff "
          f"{abs(l_card - l_cpu)}, limit 1e-4); worst gradient max abs err / largest "
          f"magnitude {worst[0]} ({worst[1]}, limit 1e-4)")
    if abs(l_card - l_cpu) > 1e-4 or worst[0] > 1e-4:
        raise AssertionError("f32 train step on the card differs from the CPU's")
    one = {"tokens": one["tokens"].cpu()}
    l_cpu16, g_cpu16 = _loss_and_grads(Transformer(cfg, device="cpu", seed=0), one)
    l_cpu32, g_cpu32 = _loss_and_grads(Transformer(cfg32, device="cpu", seed=0), one)
    rel_card = {k: _rel(g, g_cpu16[k]) for k, g in grads_a.items()}
    rel_gap = {k: _rel(g_cpu16[k], g) for k, g in g_cpu32.items()}
    print(f"bf16 1x2048 train step, card vs CPU: loss {loss_a} / {l_cpu16} (diff "
          f"{abs(loss_a - l_cpu16)}, limit 1e-2); gradient relative norm errors "
          f"{json.dumps(rel_card)} (limit 5e-2); on the CPU alone, bf16 vs f32: loss "
          f"{l_cpu16} / {l_cpu32}, {json.dumps(rel_gap)}")
    if abs(loss_a - l_cpu16) > 1e-2 or max(rel_card.values()) > 5e-2:
        raise AssertionError("bf16 train step on the card differs from the CPU's")
    return launches


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
    print(f"transformer launch counts: {launches}; flash LAUNCHES {fa.LAUNCHES.count} by route "
          f"{dict(fa.LAUNCHES.by_key)}, plain runs {dict(fa.PLAIN_RUNS.by_key)}")
    tiled = sum(fa.default_blocks(t) is not None for _, t in wl.REQUEST_BATCHES)
    want = cfg.n_layers * tiled
    if fa.LAUNCHES.count != want or launches["flash_attention"] != want:
        raise AssertionError(f"flash kernel launched {fa.LAUNCHES.count} times on the "
                             f"transformer path, want {want}")
    if launches["routes"] != {"tiled": want, "dense": cfg.n_layers}:
        raise AssertionError(f"attention routes {launches['routes']}: want {want} tiled and "
                             f"the dense fallback once per layer for the T=96 batch only")
    if dict(fa.LAUNCHES.by_key) != {"tc": want}:
        raise AssertionError(f"flash forward routes {dict(fa.LAUNCHES.by_key)}: want all {want} "
                             "on the tensor-core kernel")
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
    with torch.no_grad():
        on_card = model(one)
        on_cpu = Transformer(cfg, device="cpu", seed=0)(one)
    if not bool(torch.isfinite(on_card).all()):
        raise AssertionError("non-finite logits on the card")
    err = (on_card.cpu() - on_cpu).abs()
    agree = float((on_card.argmax(-1).cpu() == on_cpu.argmax(-1)).float().mean())
    print(f"bf16 1x2048 logits, card vs CPU: max abs {float(err.max())}, mean abs "
          f"{float(err.mean())}, argmax agreement {agree} (limits 5e-2, 5e-3, 0.95)")
    if float(err.max()) > 5e-2 or float(err.mean()) > 5e-3 or agree < 0.95:
        raise AssertionError("bf16 transformer logits on the card differ from the CPU's")
    del model, on_card
    cfg32 = TransformerConfig(attention="flash", dtype=torch.float32)
    one = batches[1][:1]
    with torch.no_grad():
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
    The host lane's bench is its wall; the GPU lane issues its call before
    the host lane starts, and its bench is its stream's device span, which
    holds no wait for the interpreter lock after its fence.  A lane thread
    descheduled for several milliseconds on a shared host can still move a
    run further; the odd run is printed with its benches."""
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
                print(f"local range {step}, lane benches per call (GPU ms / host ms): "
                      f"{[(round(b[0], 4), round(b[1], 4)) for b in r.benches_per_iter]}")
            moves, span, still = tail_moves(r.ranges_per_iter, BALANCE_HOLD)
            its.append(r.convergence_iters)
            held.append(still)
            late.append((moves, span // step))
            if moves:
                print(f"local range {step}, run {rep} moved late; last 25 calls' host-lane "
                      f"ranges {[lane[1] for lane in r.ranges_per_iter[-25:]]}, benches "
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


def check_elementwise(ew) -> dict:
    """The elementwise kernel against its plain version on the card over
    2^24 elements (4 x 64 MiB in f32, beyond the 50 MB L2) and 2^20 (held
    in L2): saxpy in f32 and bf16, ``torch.maximum`` and the three-op
    ``chain``, bit-exact, and saxpy with ``block_rows=64`` equal to the
    default's.  Each is timed by the profiler (the ``ew_`` kernel) and by
    CUDA events (the wrapper's calls), beside its plain version and the one
    PyTorch call computing it (the profiler's device time), against the
    bytes bound (every input read once, the output written once).  Returns
    the kernels-line row of saxpy in f32 at 2^24, the main path's."""
    import torch

    row = None
    for log2 in (24, 20):
        n = 1 << log2
        g = torch.Generator().manual_seed(4321 + log2)
        x, y = (torch.randn(n, generator=g).cuda() for _ in range(2))
        x16, y16 = x.to(torch.bfloat16), y.to(torch.bfloat16)

        def saxpy_plain(a, b):
            return ew.map_blocks_plain(lambda xb, yb: yb + ALPHA * xb, a, b)

        cases = (  # label, kernel, plain, library, bytes per element
            ("saxpy f32", lambda: ew.saxpy(ALPHA, x, y), lambda: saxpy_plain(x, y),
             lambda: torch.add(y, x, alpha=ALPHA), 12),
            ("saxpy bf16", lambda: ew.saxpy(ALPHA, x16, y16), lambda: saxpy_plain(x16, y16),
             lambda: torch.add(y16, x16, alpha=ALPHA), 6),
            ("maximum f32", lambda: ew.map_blocks(torch.maximum, x, y),
             lambda: ew.map_blocks_plain(torch.maximum, x, y), lambda: torch.maximum(x, y), 12),
            ("chain f32", lambda: ew.map_blocks(chain, x, y),
             lambda: ew.map_blocks_plain(chain, x, y), None, 12),
        )
        for label, kern, plain, library, per_elem in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"elementwise kernel vs plain ({label}, 2^{log2}): "
                                     f"max abs err {err}")
            ms, event_ms = kernel_ms(kern, "ew_", 20)
            r = dict(max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=cuda_ms(plain, 5),
                     library_ms=None if library is None else profiled_ms(library, 20)["total"],
                     library_event_ms=None if library is None else cuda_ms(library, 20),
                     bound_ms=float(per_elem) * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
            lib = ("-" if library is None else
                   f"{r['library_ms']:.4f} ms (CUDA events {r['library_event_ms']:.4f} ms)")
            print(f"elementwise {label} 2^{log2}: kernel {ms:.4f} ms (CUDA events "
                  f"{event_ms:.4f} ms)  plain {r['plain_ms']:.4f} ms  library {lib}  bound "
                  f"{r['bound_ms']:.4f} ms (bytes)  max_abs_err {err}")
            row = row or r
        tall = ew.saxpy(ALPHA, x, y, block_rows=64)
        if not torch.equal(tall, ew.saxpy(ALPHA, x, y)):
            raise AssertionError("elementwise saxpy with block_rows=64 differs from block_rows=256")
    return row


def saxpy_reference(y0: np.ndarray, x: np.ndarray, calls: int) -> np.ndarray:
    """``calls`` plain iterations of ``y = y + ALPHA * x`` (the plain
    version of ``ops.elementwise.saxpy`` on CPU tensors)."""
    import torch

    from cekirdekler_tpu_torch.ops import elementwise as ew

    xt, yt = torch.from_numpy(x), torch.from_numpy(y0.copy())
    for _ in range(calls):
        yt = ew.map_blocks_plain(lambda xb, yb: yb + ALPHA * xb, xt, yt)
    return yt.numpy()


def enqueue_saxpy(ck, wl, lanes, n: int, calls: int, sync_every: int = 0,
                  seed: int = 5) -> dict:
    """``calls`` enqueue-mode calls of the ``@kernel`` saxpy over the
    elementwise kernel through ``ClArray.compute`` on ``lanes`` (local
    range 256; ``y`` partial-read), a barrier every ``sync_every`` calls
    and at the end, then the flush.  Returns the host ``y``, its plain
    reference, the ranges per call, each lane's transfer counts before
    and after the flush, whether the host ``y`` was untouched before the
    flush, each call's host wall (ms) and the last barrier's (ms)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal(n).astype(np.float32)
    y0 = rng.standard_normal(n).astype(np.float32)
    x = ck.ClArray(xh.copy(), name="x", read_only=True, fast=True)
    y = ck.ClArray(y0.copy(), name="y", partial_read=True, fast=True)
    group = x.next_param(y)
    ranges, call_ms = [], []
    with ck.NumberCruncher(lanes, wl.saxpy_kernel()) as cr:
        cr.enqueue_mode = True
        for k in range(calls):
            t0 = time.perf_counter()
            group.compute(cr, SAXPY_ID, "saxpy", n, 256, values=(ALPHA,))
            call_ms.append((time.perf_counter() - t0) * 1e3)
            ranges.append(cr.ranges_of(SAXPY_ID))
            if sync_every and (k + 1) % sync_every == 0 and k + 1 < calls:
                cr.barrier()
        t0 = time.perf_counter()
        cr.barrier()
        barrier_ms = (time.perf_counter() - t0) * 1e3
        before = [dict(w.transfers) for w in cr.cores.workers]
        untouched = bool(np.array_equal(y.host(), y0))
        cr.enqueue_mode = False  # the flush
        after = [dict(w.transfers) for w in cr.cores.workers]
    return dict(y=y.host().copy(), want=saxpy_reference(y0, xh, calls), ranges=ranges,
                before=before, after=after, untouched=untouched, call_ms=call_ms,
                barrier_ms=barrier_ms)


def gate_single_lane_transfers(run: dict) -> None:
    """On one lane, enqueue mode uploads ``x`` and ``y`` once and reads
    ``y`` back once, at the flush: a D2H before it, or a repeated upload,
    fails."""
    once = {("h2d", "x"): 1, ("h2d", "y"): 1}
    if run["before"] != [once] or not run["untouched"]:
        raise AssertionError(f"enqueue saxpy: transfers before the flush {run['before']}, want "
                             f"{[once]} and the host y untouched ({run['untouched']})")
    if run["after"] != [{**once, ("d2h", "y"): 1}]:
        raise AssertionError(f"enqueue saxpy: transfers after the flush {run['after']}, want "
                             "one D2H of y")


def gate_exact(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: differs from its reference at {bad} elements")


def gate_moves(ranges: list[list[int]], sync_every: int) -> int:
    """Ranges may move only on the first call after a barrier (calls
    ``sync_every``, ``2 * sync_every``, ...); returns the number of moves."""
    moves = [k for k in range(1, len(ranges)) if ranges[k] != ranges[k - 1]]
    early = [k for k in moves if k % sync_every != 0]
    if early:
        raise AssertionError(f"ranges moved between barriers at calls {early}: {ranges}")
    return len(moves)


def check_enqueue_saxpy(ck, wl, ew, gpus, reg, graphs, kernel_ms: float) -> int:
    """Phase (b): returns the elementwise kernel's launches on that path.
    ``kernel_ms`` is the elementwise kernel's own time at this size (the
    kernels line), which the 64 calls and the barrier are read against."""
    n = 1 << 24
    ew.LAUNCHES.reset()
    ew.PLAIN_RUNS.reset()
    graphs.GRAPHS.reset()
    reg.reset_launch_counts()
    run = enqueue_saxpy(ck, wl, gpus.subset(1), n, ENQUEUE_CALLS)
    launches, routes = ew.LAUNCHES.count, dict(reg.launch_counts)
    plain = ew.PLAIN_RUNS.by_key.get("cuda", 0)  # the reference's runs are on the CPU
    ms = run["call_ms"]
    total = sum(ms) + run["barrier_ms"]
    print(f"enqueue saxpy 2^24 x {ENQUEUE_CALLS} calls (host clock): first call {ms[0]:.3f} ms, "
          f"calls 2-{ENQUEUE_CALLS} mean {np.mean(ms[1:]):.4f} ms, median "
          f"{np.median(ms[1:]):.4f} ms (calls 3-{ENQUEUE_CALLS}, the deferred ones, median "
          f"{np.median(ms[2:]):.4f} ms), then the barrier {run['barrier_ms']:.3f} ms; "
          f"calls + barrier {total:.3f} ms = {total / (ENQUEUE_CALLS * kernel_ms):.3f} x "
          f"{ENQUEUE_CALLS} x the kernel's {kernel_ms:.4f} ms; "
          f"elementwise launches {launches}, plain runs on the card {plain}; routes {routes}; "
          f"graphs {dict(graphs.GRAPHS.by_key)}; transfers {run['after']}")
    gate_single_lane_transfers(run)
    gate_exact(run["y"], run["want"], f"enqueue saxpy y after {ENQUEUE_CALLS} calls")
    from cekirdekler_tpu_torch.core.worker import _ladder

    want = len(_ladder(n, 256)) * ENQUEUE_CALLS
    if launches != want or plain != 0 or routes["python"] != ENQUEUE_CALLS:
        raise AssertionError(f"enqueue saxpy launched the elementwise kernel {launches} times "
                             f"(want {want}), plain runs on the card {plain}, routes {routes}")
    return launches


def check_enqueue_mandelbrot(ck, wl, gpus, card: str, ref_img: np.ndarray) -> dict:
    """Phase (c): ``readback="final"`` beside ``"every"`` by both routes on
    one cruncher each, against ``ref_img`` (``mandelbrot_host`` at
    2048x2048x256); returns Mpixels/s by run."""
    W = H = 2048
    out = {}
    for label, source in (("C-subset", wl.MANDELBROT_SRC),
                          ("hand kernel", wl.mandelbrot_cuda_kernel())):
        with ck.NumberCruncher(gpus.subset(1), source) as cr:
            w = cr.cores.workers[0]
            for readback in ("final", "every"):
                d2h = w.transfers["d2h", "mandel_out"]
                r = wl.run_mandelbrot(None, W, H, 256, local_range=256, keep_image=True,
                                      readback=readback, cruncher=cr)
                d2h = w.transfers["d2h", "mandel_out"] - d2h
                gate_exact(r.image.ravel(), ref_img, f"mandelbrot ({label}, {readback})")
                if readback == "final" and d2h != 1:
                    raise AssertionError(f"mandelbrot ({label}) readback='final' read the image "
                                         f"back {d2h} times, want 1")
                out[f"{label} {readback}"] = r.mpixels_per_sec
                print(f"mandelbrot 2048x2048x256 ({label}, readback={readback!r}): "
                      f"{r.mpixels_per_sec:.1f} Mpixels/s, image D2H {d2h} on {card}")
    return out


def moves_away(ranges: list[list[int]], lane: int) -> int:
    """How many calls took range from ``lane`` (its range fell from the
    call before)."""
    return sum(1 for a, b in zip(ranges, ranges[1:]) if b[lane] < a[lane])


def check_enqueue_mixed(ck, wl, lanes) -> None:
    """Phase (d): one GPU lane plus one host lane in enqueue mode, with the
    GPU lane's barrier fence stalled ``STALL_MS`` by the fault plane
    (``lane-stall``): a real skew, so a barrier must move range away from
    the stalled lane."""
    from cekirdekler_tpu_torch.utils.faultinject import FAULTS

    ref_img = wl.mandelbrot_host(1024, 1024, -2.0, -1.25, 2.5 / 1024, 2.5 / 1024, 64)
    FAULTS.arm(f"lane-stall@lane{STALL_LANE}:delay_ms={STALL_MS}")
    try:
        r = wl.run_mandelbrot(lanes, 1024, 1024, 64, iters=24, warmup=0, local_range=256,
                              keep_image=True, readback="final", sync_every=4)
        run = enqueue_saxpy(ck, wl, lanes, 1 << 20, 32, sync_every=4)
        stalls = FAULTS.snapshot()["clauses"][0]["fired"]
    finally:
        FAULTS.disarm()
    gate_exact(r.image.ravel(), ref_img, "GPU + host enqueue mandelbrot")
    moves = gate_moves(r.ranges_per_iter, 4)
    away = moves_away(r.ranges_per_iter, STALL_LANE)
    print(f"GPU + host enqueue mandelbrot 1024x1024x64, barrier every 4, lane {STALL_LANE} "
          f"stalled {STALL_MS} ms a barrier: host-lane range per call "
          f"{[x[1] for x in r.ranges_per_iter]} ({moves} moves, {away} away from lane "
          f"{STALL_LANE})")
    gate_exact(run["y"], run["want"], "GPU + host enqueue saxpy y")
    saxpy_moves = gate_moves(run["ranges"], 4)
    saxpy_away = moves_away(run["ranges"], STALL_LANE)
    print(f"GPU + host enqueue saxpy 2^20 x 32, barrier every 4: host-lane range per call "
          f"{[x[1] for x in run['ranges']]} ({saxpy_moves} moves, {saxpy_away} away); "
          f"transfers {run['after']}; stalls fired {stalls}")
    if away + saxpy_away == 0:
        raise AssertionError(f"GPU + host enqueue mode: no barrier moved range away from the "
                             f"stalled lane {STALL_LANE}")


TWO_SRC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
__kernel void inc2(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 2.0f;
}
"""


def expected_d2h(ranges: list[list[int]], enqueue: bool) -> list[int]:
    """Bytes each lane reads back of a 4-byte output written by every call,
    counted from the ranges per call: every call's range on the plain
    path; in enqueue mode one record per lane for each run of calls with
    one split (a re-split lands the records it replaces, the flush the
    last ones)."""
    lanes = len(ranges[0])
    out = [0] * lanes
    if not enqueue:
        for r in ranges:
            for i in range(lanes):
                out[i] += 4 * r[i]
        return out
    last = None
    for r in ranges + [None]:
        if last is not None and r != last:
            for i in range(lanes):
                out[i] += 4 * last[i]
        last = r
    return out


def lane_spans(spans, lane: int, t0: float, t1: float) -> list[str]:
    return [s.kind for s in spans if s.lane == lane and t0 <= s.t0 and s.t1 <= t1]


def check_hooks(ck, wl, lanes, W: int, H: int, iters: int, ref_img: np.ndarray) -> None:
    """The hooks on the card: the headline call (mandelbrot WxHxiters,
    local 256) on the GPU lane plus one host lane, ``HOOK_CALLS`` calls per
    call then as many enqueued with a barrier every 4, with the port's
    decision log, tracer and flight recorder on throughout.  The log
    replays with no divergence and no row of an unported kind; every call
    has its lane spans, every barrier its ``fence`` span and flight event;
    the byte counters equal the bytes the calls moved; a ``driver-submit``
    fault armed on the GPU lane raises from a streamed call, and the next
    call is exact; a mixed window of two compute ids with ``fence_split``
    probes each on both lanes."""
    from cekirdekler_tpu_torch.errors import InjectedFaultError
    from cekirdekler_tpu_torch.metrics.registry import REGISTRY
    from cekirdekler_tpu_torch.obs.decisions import DECISIONS
    from cekirdekler_tpu_torch.obs.flight import FLIGHT
    from cekirdekler_tpu_torch.obs.replay import verify_records
    from cekirdekler_tpu_torch.trace.spans import TRACER
    from cekirdekler_tpu_torch.utils.faultinject import FAULTS

    n = W * H
    saved = (DECISIONS.enabled, FLIGHT.enabled, TRACER.enabled)
    DECISIONS.clear()
    FLIGHT.clear()
    DECISIONS.enabled = FLIGHT.enabled = True
    TRACER.enable(capacity=1 << 18)
    cr = ck.NumberCruncher(lanes, wl.MANDELBROT_SRC)
    try:
        report = {}
        for part, readback in (("per call", "every"), ("enqueued", "final")):
            REGISTRY.reset()
            t_part = time.perf_counter()
            r = wl.run_mandelbrot(lanes, W, H, iters, iters=HOOK_CALLS, warmup=0,
                                  local_range=256, keep_image=True, readback=readback,
                                  sync_every=4, cruncher=cr)
            gate_exact(r.image.ravel(), ref_img, f"hooks mandelbrot ({part})")
            spans = [s for s in TRACER.snapshot() if s.t0 >= t_part]
            calls = [s for s in spans if s.kind == "enqueue" and s.cid == 7001]
            if len(calls) != HOOK_CALLS:
                raise AssertionError(f"hooks ({part}): {len(calls)} enqueue spans, not "
                                     f"{HOOK_CALLS}")
            for lane in range(len(lanes)):
                active = sum(1 for rg in r.ranges_per_iter if rg[lane] > 0)
                if readback == "every":
                    bare = [c for c in calls
                            if not {"launch"} <= set(lane_spans(spans, lane, c.t0, c.t1))]
                    missing = len(bare) - (HOOK_CALLS - active)
                else:
                    launched = 0
                    for s in spans:
                        if s.kind == "launch" and s.lane == lane and s.cid == 7001:
                            launched += (int(s.tag.rsplit("x", 1)[1])
                                         if s.tag.startswith("fused:") else 1)
                    missing = active - launched
                if missing:
                    raise AssertionError(f"hooks ({part}): lane {lane} lacks the launch spans "
                                         f"of {missing} call(s)")
            fences = [s for s in spans if s.kind == "fence" and s.tag == "barrier"]
            barriers = HOOK_CALLS // 4 if readback == "final" else 0
            flight_barriers = [e for e in FLIGHT.snapshot()
                               if e.kind == "barrier" and e.t >= time.time()
                               - (time.perf_counter() - t_part)]
            if len(fences) != barriers or len(flight_barriers) != barriers:
                raise AssertionError(f"hooks ({part}): {len(fences)} fence spans and "
                                     f"{len(flight_barriers)} flight barrier events for "
                                     f"{barriers} barriers")
            want = expected_d2h(r.ranges_per_iter, readback == "final")
            got = [REGISTRY.counter("ck_download_bytes_total", lane=i).value
                   for i in range(len(lanes))]
            up = [REGISTRY.counter("ck_upload_bytes_total", lane=i).value
                  for i in range(len(lanes))]
            if got != want or any(up):
                raise AssertionError(f"hooks ({part}): D2H bytes {got} against {want} from "
                                     f"the ranges, H2D bytes {up} against none")
            report[part] = dict(mpix=round(r.mpixels_per_sec, 1), d2h_bytes=got,
                                host_range=[x[1] for x in r.ranges_per_iter][-1],
                                fused=dict(cr.fused_stats))
        rows = [rec.to_row() for rec in DECISIONS.snapshot()]
        verdict = verify_records(rows)
        if verdict["divergent"] or verdict["not_ported"] or not verdict["ok"]:
            raise AssertionError(f"hooks: decision log verify {verdict['first_divergence']}, "
                                 f"not ported {verdict['not_ported']}")
        # a driver-submit fault on the GPU lane, raised from a streamed call
        out = ck.ClArray(n, np.float32, name="mandel_out", read=False, write=True, fast=True)
        vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, iters)
        cr.stream_chunks = 4
        FAULTS.arm("driver-submit@lane0:times=1")
        try:
            out.compute(cr, 7001, "mandelbrot", n, 256, values=vals)
        except InjectedFaultError as e:
            fault = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("hooks: an armed driver-submit fault did not raise")
        finally:
            FAULTS.disarm()
        cr.reset_errors()
        cr.stream_chunks = 0
        out.compute(cr, 7001, "mandelbrot", n, 256, values=vals)
        gate_exact(out.host(), ref_img, "hooks mandelbrot after the fault")
        # fence_split over a mixed window of two compute ids on both lanes
        m = 1 << 20
        with ck.NumberCruncher(lanes, TWO_SRC) as cr2:
            cr2.fence_split = True
            a = ck.ClArray(np.zeros(m, np.float32), name="a", fast=True)
            b = ck.ClArray(np.zeros(m, np.float32), name="b", fast=True)
            cr2.enqueue_mode = True
            t_mix = time.perf_counter()
            for _ in range(2):
                a.compute(cr2, 1, "inc", m, 256)
            for _ in range(2):
                b.compute(cr2, 2, "inc2", m, 256)
            cr2.barrier()
            probes = sorted({(s.lane, s.cid) for s in TRACER.snapshot() if s.t0 >= t_mix
                             and s.kind == "fence" and s.tag == "cid-split"})
            cr2.enqueue_mode = False
        gate_exact(a.host(), np.full(m, 2.0, np.float32), "fence-split a")
        gate_exact(b.host(), np.full(m, 4.0, np.float32), "fence-split b")
        if probes != [(0, 1), (0, 2), (1, 1), (1, 2)]:
            raise AssertionError(f"hooks: fence_split probes {probes}")
        print(f"hooks: {json.dumps(report)}; decision log {verdict['records']} records, "
              f"{verdict['replayed']} replayed, per kind {verdict['per_kind']}; fault "
              f"{fault}; fence_split probes (lane, cid) {probes}; spans recorded "
              f"{TRACER.total_recorded}")
    finally:
        cr.dispose()
        TRACER.disable()
        TRACER.clear()
        DECISIONS.enabled, FLIGHT.enabled = saved[0], saved[1]


def launch_counts(reg, cuda_backend, mandel_op, ew_op) -> dict:
    """Every launch count a ``compute()`` path on the GPU lane moves."""
    return {"emitted": dict(cuda_backend.LAUNCHES.by_key), "forms": dict(cuda_backend.FORMS.by_key),
            "mandelbrot.cu": mandel_op.LAUNCHES.count, "elementwise": ew_op.LAUNCHES.count,
            "elementwise plain": dict(ew_op.PLAIN_RUNS.by_key), "routes": dict(reg.launch_counts)}


def reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op) -> None:
    for counter in (cuda_backend.LAUNCHES, cuda_backend.FORMS, mandel_op.LAUNCHES,
                    ew_op.LAUNCHES, ew_op.PLAIN_RUNS, graphs.GRAPHS):
        counter.reset()
    reg.reset_launch_counts()


def fused_cases(ck, wl, n_pix: int) -> list[tuple]:
    """(label, source, kernel, calls, fused batch, values, arrays, range) of
    the fused phase: the main path's kernels at its shapes, each case's
    arrays made anew from a seed by ``arrays()``.  Each batch size divides
    the deferred calls at least twice, so a lane runs its key once launch by
    launch and then captures and replays it."""
    vals = (-2.0, -1.25, 2.5 / 2048, 2.5 / 2048, 2048, 256)
    big, nb = 1 << 24, 8192

    def image():
        return [ck.ClArray(n_pix, np.float32, name="img", read=False, write=True, fast=True)]

    def saxpy():
        rng = np.random.default_rng(11)
        return [ck.ClArray(rng.standard_normal(big).astype(np.float32), name="x",
                           read_only=True, fast=True),
                ck.ClArray(rng.standard_normal(big).astype(np.float32), name="y",
                           partial_read=True, fast=True)]

    def stream():
        rng = np.random.default_rng(12)
        return [ck.ClArray(rng.standard_normal(big).astype(np.float32), name=k,
                           read_only=True, fast=True) for k in "ab"] + [
            ck.ClArray(big, np.float32, name="c", write_only=True, fast=True)]

    def nbody():
        rng = np.random.default_rng(42)
        pos = (rng.random((3, nb), dtype=np.float32) - 0.5) * 2.0
        return [ck.ClArray(pos[k].copy(), name="xyz"[k], read_only=True) for k in range(3)] + [
            ck.ClArray(nb, np.float32, name=f"v{c}", partial_read=True) for c in "xyz"]

    return [("emitted mandelbrot", wl.MANDELBROT_SRC, "mandelbrot", 12, 4, vals, image, n_pix),
            ("hand mandelbrot", wl.mandelbrot_cuda_kernel(), "mandelbrot", 12, 4, vals, image,
             n_pix),
            ("saxpy", wl.saxpy_kernel(), "saxpy", ENQUEUE_CALLS, 16, (ALPHA,), saxpy, big),
            ("emitted streamAdd", wl.STREAM_SRC, "streamAdd", 16, 4, (), stream, big),
            ("emitted n-body", wl.NBODY_SRC, "nBody", 8, 2, (nb, 1e-4), nbody, nb)]


def check_fused(ck, wl, gpus, mods, ref_img: np.ndarray) -> dict:
    """The fused-dispatch phase: each case's calls in enqueue mode on the GPU
    lane, per call and fused, with every count set to 0 before each run.
    Fused must give the per-call outputs bit for bit and the same launch
    counts, through CUDA graphs (replays > 0; a key's first run goes launch
    by launch); neither run may take a plain version on the card.  Returns
    the fused runs' graph counts by case."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    out = {}
    for label, source, kname, calls, batch, vals, arrays, n in fused_cases(ck, wl, ref_img.size):
        runs = {}
        for fused in (False, True):
            arrs = arrays()
            group = arrs[0].next_param(*arrs[1:]) if len(arrs) > 1 else arrs[0]
            with ck.NumberCruncher(gpus.subset(1), source) as cr:
                cr.fused_dispatch = fused
                cr.fused_batch = batch
                reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
                cr.enqueue_mode = True
                t0 = time.perf_counter()
                for _ in range(calls):
                    group.compute(cr, 7100, kname, n, 256, values=vals)
                cr.barrier()
                wall = (time.perf_counter() - t0) * 1e3
                cr.enqueue_mode = False
                runs[fused] = dict(outputs=[a.host().copy() for a in arrs],
                                   counts=launch_counts(reg, cuda_backend, mandel_op, ew_op),
                                   graphs=dict(graphs.GRAPHS.by_key),
                                   stats=json.loads(json.dumps(cr.fused_stats)), wall_ms=wall)
        per_call, fused = runs[False], runs[True]
        for k, (a, b) in enumerate(zip(per_call["outputs"], fused["outputs"])):
            gate_exact(b, a, f"fused {label}: output {k} against the per-call run")
        if "mandelbrot" in label:
            gate_exact(fused["outputs"][0], ref_img, f"fused {label}: image")
        print(f"fused {label}, {calls} enqueued calls + barrier: per call {per_call['wall_ms']:.3f} "
              f"ms, fused {fused['wall_ms']:.3f} ms; fused_stats {fused['stats']}; graphs "
              f"{fused['graphs']}; launch counts {fused['counts']}")
        if fused["counts"] != per_call["counts"]:
            raise AssertionError(f"fused {label}: launch counts {fused['counts']} differ from "
                                 f"the per-call run's {per_call['counts']}")
        for run in (per_call, fused):
            if run["counts"]["routes"]["torch"] or "cuda" in run["counts"]["elementwise plain"]:
                raise AssertionError(f"fused {label}: a plain version ran on the card: "
                                     f"{run['counts']}")
        if fused["graphs"].get("replay", 0) <= 0 or per_call["graphs"]:
            raise AssertionError(f"fused {label}: graphs {fused['graphs']} (per call "
                                 f"{per_call['graphs']}): want replays")
        if fused["stats"]["fused_iters"] != calls - 2:
            raise AssertionError(f"fused {label}: {fused['stats']}, want {calls - 2} fused")
        out[label] = fused["graphs"]
    return out


def check_repeat(ck, wl, gpus, mods, n: int = 1 << 24, repeats: int = 64, calls: int = 4) -> None:
    """``repeat_count`` through ``compute()`` on the GPU lane: the @kernel
    saxpy and the emitted saxpy, ``repeats`` repeats a call.  A lane's first
    call runs the repeats launch by launch and records that they wrote
    their buffers in place; every later call is one graph replay.  The
    counts must hold every repeat, and ``y`` must equal the plain version's
    ``repeats * calls`` iterations bit for bit."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    from cekirdekler_tpu_torch.core.worker import _ladder

    rng = np.random.default_rng(13)
    xh = rng.standard_normal(n).astype(np.float32)
    y0 = rng.standard_normal(n).astype(np.float32)
    want = saxpy_reference(y0, xh, repeats * calls)
    chunks = len(_ladder(n, 256)) * repeats * calls
    for label, source, count in (
            ("@kernel saxpy", wl.saxpy_kernel(), lambda: ew_op.LAUNCHES.count),
            ("emitted saxpy", SAXPY_SRC, lambda: cuda_backend.LAUNCHES.by_key.get("saxpy", 0))):
        x = ck.ClArray(xh.copy(), name="x", read_only=True, fast=True)
        y = ck.ClArray(y0.copy(), name="y", fast=True)
        with ck.NumberCruncher(gpus.subset(1), source) as cr:
            cr.repeat_count = repeats
            reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
            walls = []
            for _ in range(calls):
                t0 = time.perf_counter()
                x.next_param(y).compute(cr, 7101, "saxpy", n, 256, values=(ALPHA,))
                walls.append((time.perf_counter() - t0) * 1e3)
        got = dict(graphs.GRAPHS.by_key)
        # the emitted saxpy rounds y + a*x as the plain version does, without a contraction
        gate_exact(y.host(), want, f"repeat_count={repeats} {label} y")
        print(f"repeat_count={repeats} {label} {n} floats x {calls} calls through compute(): walls "
              f"{[round(w, 3) for w in walls]} ms (with H2D and D2H); launches {count()}, "
              f"graphs {got}")
        if count() != chunks or got != {"ladder": 1, "capture": 1, "replay": calls - 1}:
            raise AssertionError(f"repeat {label}: {count()} launches (want {chunks}), graphs "
                                 f"{got} (want one ladder, then one replay a call)")


def check_mandelbrot_sync12(ck, wl, gpus, card: str, ref_img: np.ndarray) -> dict:
    """``readback="final"`` with a barrier every 12 calls, fused and per call
    on one cruncher a route: one run to warm the cruncher, then per call,
    fused, fused, per call; returns Mpixels/s by run."""
    out = {}
    for label, source in (("C-subset", wl.MANDELBROT_SRC),
                          ("hand kernel", wl.mandelbrot_cuda_kernel())):
        with ck.NumberCruncher(gpus.subset(1), source) as cr:
            wl.run_mandelbrot(None, 2048, 2048, 256, local_range=256, readback="final",
                              sync_every=12, cruncher=cr)
            for k, fused in enumerate((False, True, True, False)):
                cr.fused_dispatch = fused
                r = wl.run_mandelbrot(None, 2048, 2048, 256, local_range=256, keep_image=True,
                                      readback="final", sync_every=12, cruncher=cr)
                gate_exact(r.image.ravel(), ref_img, f"mandelbrot ({label}, sync_every=12)")
                key = f"{label} final sync12 {'fused' if fused else 'per-call'} {k}"
                out[key] = r.mpixels_per_sec
                print(f"mandelbrot 2048x2048x256 ({label}, readback='final', sync_every=12, "
                      f"fused_dispatch={fused}): {r.mpixels_per_sec:.1f} Mpixels/s on {card}; "
                      f"fused_stats {cr.fused_stats}")
    return out


def check_devices(ck, wl, gpus, mods) -> None:
    """Device selection on one GPU lane plus one host lane: every selector
    the reference has, the card ranked first by the n-body microbenchmark,
    free memory as ``torch.cuda.mem_get_info`` reads it, and two partition
    lanes of the card through ``compute()`` on the emitted mandelbrot
    (image exact, both lanes on the CUDA route, two streams)."""
    import torch

    from cekirdekler_tpu_torch.hardware import Platform, Platforms

    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    card = gpus[0]
    host = ck.all_devices().cpus(1)
    mixed = gpus.subset(1) + host
    want = {"accelerators": [card], "with_dedicated_memory": [card],
            "with_host_memory_sharing": [host[0]], "with_most_compute_units": [card],
            "with_highest_memory_available": [card, host[0]],
            "with_highest_nbody_performance": [card, host[0]]}
    got = {name: list(getattr(mixed, name)()) for name in want}
    print(f"selectors on {[d.name for d in mixed]}: "
          f"{ {k: [d.name for d in v] for k, v in got.items()} }")
    if got != want:
        raise AssertionError(f"device selectors: {got}, want {want}")
    free0 = torch.cuda.mem_get_info(card.torch_device)[0]
    avail = card.memory_available_bytes
    free1 = torch.cuda.mem_get_info(card.torch_device)[0]
    print(f"{card.name}: memory_available_bytes {avail}, mem_get_info {free0} / {free1}")
    if not min(free0, free1) <= avail <= max(free0, free1) or host[0].memory_available_bytes:
        raise AssertionError(f"memory_available_bytes {avail} against mem_get_info "
                             f"{free0} / {free1}; host lane {host[0].memory_available_bytes}")
    plats = Platforms([Platform("cuda", tuple(gpus)), Platform("cpu", tuple(ck.all_devices()
                                                                           .cpus(2)))])
    counts = ([p.num_accelerators() for p in plats], [p.num_cpus() for p in plats],
              [p.name for p in plats.with_most_devices()], len(plats.accelerators()),
              len(plats.cpus()))
    print(f"platforms (accelerators, cpus, with_most_devices, all accelerators, all cpus): "
          f"{counts}")
    if counts[:2] != ([len(gpus), 0], [0, 2]) or counts[3:] != (len(gpus), 2):
        raise AssertionError(f"platform counts {counts}")
    parts = card.as_partitions(2)
    W = H = 1024
    ref = wl.mandelbrot_host(W, H, -2.0, -1.25, 2.5 / W, 2.5 / H, 64)
    reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
    with ck.NumberCruncher(parts, wl.MANDELBROT_SRC) as cr:
        r = wl.run_mandelbrot(None, W, H, 64, iters=4, warmup=1, local_range=256,
                              keep_image=True, cruncher=cr)
        streams = [w.stream for w in cr.cores.workers]
        names = cr.cores.device_names()
    routes = dict(reg.launch_counts)
    gate_exact(r.image.ravel(), ref, "mandelbrot over two partition lanes")
    print(f"partition lanes {names}: ranges per call {r.ranges_per_iter}, routes {routes}, "
          f"streams {[s.cuda_stream for s in streams]}")
    if (len({s.cuda_stream for s in streams}) != 2 or routes["torch"] or routes["cuda"] <= 0
            or min(min(x) for x in r.ranges_per_iter) <= 0):
        raise AssertionError(f"partition lanes: streams {streams}, routes {routes}, ranges "
                             f"{r.ranges_per_iter}")


def stream_cases(ck, wl):
    """(label, source, kernel, values, arrays(), range, output index) of the
    streamed phase: the main path's kernels at its shapes, the arrays made
    anew from a seed for each run."""
    vals = (-2.0, -1.25, 2.5 / 2048, 2.5 / 2048, 2048, 256)
    big = 1 << 24

    def image():
        return [ck.ClArray(2048 * 2048, np.float32, name="img", read=False, write=True,
                           fast=True)]

    def stream():  # page-locked arrays, as run_stream's: copied directly
        rng = np.random.default_rng(21)
        arrs = [ck.ClArray(big, np.float32, name=k, partial_read=True, read_only=True,
                           fast=True) for k in "ab"]
        for arr in arrs:
            arr.host()[:] = rng.standard_normal(big).astype(np.float32)
        return arrs + [ck.ClArray(big, np.float32, name="c", write_only=True, fast=True)]

    def saxpy():  # pageable arrays, as the main path's saxpy: through the staging ring
        rng = np.random.default_rng(22)
        return [ck.ClArray(rng.standard_normal(big).astype(np.float32), name="x",
                           partial_read=True, read_only=True),
                ck.ClArray(rng.standard_normal(big).astype(np.float32), name="y",
                           partial_read=True)]

    return [("emitted mandelbrot", wl.MANDELBROT_SRC, "mandelbrot", vals, image, 2048 * 2048),
            ("hand mandelbrot", wl.mandelbrot_cuda_kernel(), "mandelbrot", vals, image,
             2048 * 2048),
            ("emitted streamAdd", wl.STREAM_SRC, "streamAdd", (), stream, big),
            ("emitted saxpy", SAXPY_SRC, "saxpy", (ALPHA,), saxpy, big)]


STREAM_CALLS = 6


def streamed_run(ck, gpus, mods, case, chunks: int | None, calls: int = STREAM_CALLS) -> dict:
    """``calls`` plain-path calls of one streamed case on a new GPU-lane
    cruncher: ``chunks`` None is the monolithic path
    (``streamed_transfers = False``), 0 the tuner's choice, n pinned.
    Returns the outputs, the launch counts, the chunk copies, the chunk
    counts per call and each call's host wall."""
    from cekirdekler_tpu_torch.core import cores as cores_mod
    from cekirdekler_tpu_torch.kernel import build

    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    label, source, kname, vals, arrays, n = case
    arrs = arrays()
    group = arrs[0].next_param(*arrs[1:]) if len(arrs) > 1 else arrs[0]
    built = len(build._loaded)
    with ck.NumberCruncher(gpus.subset(1), source) as cr:
        cr.streamed_transfers = chunks is not None
        cr.stream_chunks = chunks or 0
        reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
        cores_mod.STREAMED.reset()
        walls, per_call, compiled = [], [], []
        for _ in range(calls):
            t0 = time.perf_counter()
            group.compute(cr, 7200, kname, n, 256, values=vals)
            walls.append((time.perf_counter() - t0) * 1e3)
            per_call.append(cr.cores.last_stream_chunks.get(0, 1))
            compiled.append(cr.program.compiled_count)
        w = cr.cores.workers[0]
        return dict(outputs=[a.host().copy() for a in arrs],
                    counts=launch_counts(reg, cuda_backend, mandel_op, ew_op),
                    chunk_copies=dict(w.chunk_transfers), transfers=dict(w.transfers),
                    streamed=cores_mod.STREAMED.count, chunks=per_call, walls=walls,
                    compiled=compiled, built=len(build._loaded) - built)


def gate_streamed_case(ck, gpus, mods, case, ref_img: np.ndarray | None,
                       calls: int = STREAM_CALLS) -> None:
    """One streamed case monolithic, at 4 chunks pinned and at the tuner's
    choice, ``calls`` calls each: outputs bit for bit the monolithic run's
    (and the image ``ref_img``), the pinned run's launches 4 a call and its
    chunk copies 4 a call per array moved, no plain version on the card,
    the emitted kernels on their forms, no kernel built anew."""
    from cekirdekler_tpu_torch.core.worker import _ladder

    forms_of = {"mandelbrot": "escape", "streamAdd": "stream", "saxpy": "stream"}
    label, _src, kname, _vals, _arrays, n = case
    on_card = gpus[0].is_gpu
    mono = streamed_run(ck, gpus, mods, case, None, calls)
    runs = {4: streamed_run(ck, gpus, mods, case, 4, calls),
            0: streamed_run(ck, gpus, mods, case, 0, calls)}
    for chunks, run in runs.items():
        for k, (a, b) in enumerate(zip(run["outputs"], mono["outputs"])):
            gate_exact(a, b, f"streamed {label} ({chunks or 'tuner'} chunks): output {k} "
                             "against the monolithic run")
        if ref_img is not None:
            gate_exact(run["outputs"][0], ref_img, f"streamed {label}: image")
        print(f"streamed {label}, {calls} calls, stream_chunks={chunks}: chunks per "
              f"call {run['chunks']}, streamed phases {run['streamed']}, walls "
              f"{[round(x, 3) for x in run['walls']]} ms (monolithic "
              f"{[round(x, 3) for x in mono['walls']]}); launches {run['counts']}; chunk "
              f"copies {run['chunk_copies']}; transfers {run['transfers']}; launchers "
              f"{run['compiled']}; new builds {run['built']}")
        counts = run["counts"]
        if on_card and (counts["routes"]["torch"] or "cuda" in counts["elementwise plain"]):
            raise AssertionError(f"streamed {label}: a plain version ran on the card: {counts}")
        if on_card and "hand" not in label:
            gate_forms(counts["forms"], {kname: forms_of[kname]})
        # a chunk launches the lane's built kernel: no source is built
        # anew, and at a pinned count no call adds a launcher after the
        # first (the tuner's counts may add one per new chunk size)
        if run["built"] or (chunks and len(set(run["compiled"])) > 1):
            raise AssertionError(f"streamed {label}: built {run['built']} kernels anew, "
                                 f"launchers per call {run['compiled']}")
    pinned = runs[4]
    launches = sum(pinned["counts"]["routes"].values())
    want_launches = 4 * calls
    copies = sum(pinned["chunk_copies"].values())
    arrays_moved = len(pinned["transfers"])
    if (pinned["chunks"] != [4] * calls or pinned["streamed"] != calls
            or launches != want_launches or copies != 4 * calls * arrays_moved):
        raise AssertionError(f"streamed {label} at 4 chunks: chunks {pinned['chunks']}, "
                             f"streamed phases {pinned['streamed']}, launches {launches} "
                             f"(want {want_launches}; monolithic "
                             f"{len(_ladder(n, 256)) * calls}), chunk copies "
                             f"{pinned['chunk_copies']}")


def check_streamed(ck, wl, gpus, mods, ref_img: np.ndarray) -> dict:
    """Streamed partition transfers on the GPU lane: each case of
    :func:`stream_cases` through :func:`gate_streamed_case`; then a
    profiler trace of a pinned mandelbrot call at the main path's max_iter
    (printed) and at 2048, which must show a chunk's D2H beside a later
    chunk's kernel; then the streamed against monolithic rates A B B A on
    one cruncher, and the overlap and duplex measurements (printed, not
    gated).  Returns the rates."""
    for case in stream_cases(ck, wl):
        gate_streamed_case(ck, gpus, mods, case, ref_img if "mandelbrot" in case[0] else None)
    # the mechanism itself: a chunk's D2H runs beside a later chunk's kernel.  Where
    # a chunk's kernel is shorter than the host's issue of a chunk (about 0.1-0.2
    # ms), the card idles between chunks and the copies may not meet a kernel;
    # at max_iter 2048 a chunk's kernel outlasts the issue, so they must
    for max_iter in (256, 2048):
        pairs = traced_overlap(ck, wl, gpus, max_iter)
        if max_iter == 2048 and not pairs:
            raise AssertionError("the trace of a streamed call shows no chunk D2H running beside "
                                 "a later chunk's kernel: the engine runs serially")
    return stream_rates(ck, wl, gpus)


def traced_overlap(ck, wl, gpus, max_iter: int) -> list:
    """One 4-chunk streamed mandelbrot call at 2048x2048 and ``max_iter``
    under ``torch.profiler`` (after an untraced one), its image exact;
    prints the trace's kernels and copies and returns the pairs of a chunk
    D2H and a kernel that ran at the same time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cekirdekler_tpu_torch.tools import trace_window

    W = 2048
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    out = ck.ClArray(W * W, np.float32, name="img", read=False, write=True, fast=True)
    with ck.NumberCruncher(gpus.subset(1), wl.MANDELBROT_SRC) as cr:
        cr.streamed_transfers = False
        out.compute(cr, 7201, "mandelbrot", W * W, 256, values=vals)
        want = out.host().copy()
        cr.streamed_transfers = True
        cr.stream_chunks = 4
        out.compute(cr, 7201, "mandelbrot", W * W, 256, values=vals)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_window.open_window()
            out.compute(cr, 7201, "mandelbrot", W * W, 256, values=vals)
            torch.cuda.synchronize()
    pairs = trace_window.overlapping(prof, "Memcpy DtoH", "ck_kernel")
    recs = [(nm[:24], round(a, 1), round(b, 1)) for nm, a, b in trace_window.intervals(prof)]
    print(f"trace of one 4-chunk mandelbrot call at max_iter {max_iter} (name, start µs, end "
          f"µs): {recs}; a chunk D2H beside a kernel: {len(pairs)} pairs")
    gate_exact(out.host(), want, f"traced streamed mandelbrot at max_iter {max_iter} against "
                                 "the monolithic run")
    return pairs


def stream_rates(ck, wl, gpus) -> dict:
    """Streamed (the tuner's choice) against monolithic, A B B A on one
    cruncher a case: mandelbrot Mpixels/s by both routes
    (``readback="every"``) and streamAdd GB/s; then
    ``measure_stream_overlap(streamed=True, duplex_probe=True)`` and
    ``duplex_ceiling()``.  Printed with the tuner's chunk counts."""
    out = {}
    for label, source in (("C-subset", wl.MANDELBROT_SRC),
                          ("hand kernel", wl.mandelbrot_cuda_kernel())):
        with ck.NumberCruncher(gpus.subset(1), source) as cr:
            wl.run_mandelbrot(None, 2048, 2048, 256, local_range=256, cruncher=cr)
            row = []
            for streamed in (True, False, False, True):
                cr.streamed_transfers = streamed
                r = wl.run_mandelbrot(None, 2048, 2048, 256, local_range=256, cruncher=cr)
                row.append(round(r.mpixels_per_sec, 1))
            out[f"mandelbrot {label}"] = row
            print(f"mandelbrot 2048x2048x256 ({label}, readback='every') Mpixels/s, streamed / "
                  f"monolithic / monolithic / streamed: {row}; tuner's chunks "
                  f"{dict(cr.cores.last_stream_chunks)}")
    n = 1 << 24  # page-locked arrays, as run_stream's
    a = ck.ClArray(n, np.float32, name="a", fast=True, partial_read=True, read_only=True)
    b = ck.ClArray(n, np.float32, name="b", fast=True, partial_read=True, read_only=True)
    c = ck.ClArray(n, np.float32, name="c", fast=True, write_only=True)
    a.host()[:] = np.arange(n, dtype=np.float32) % 97
    b.host()[:] = np.arange(n, dtype=np.float32) % 89
    with ck.NumberCruncher(gpus.subset(1), wl.STREAM_SRC) as cr:
        row, chunks = [], []
        for streamed in (True, True, False, False, True, True):
            cr.streamed_transfers = streamed
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                a.next_param(b, c).compute(cr, 7202, "streamAdd", n, 256)
                best = min(best, time.perf_counter() - t0)
            row.append(round(12 * n / best / 1e9, 2))
            chunks.append(cr.cores.last_stream_chunks.get(0, 1) if streamed else 1)
        gate_exact(c.host(), a.host() + b.host(), "streamAdd A B B A")
    # the first block warms the tuner (its measuring run and first chunked runs)
    out["streamAdd"] = row[1:5]
    print(f"streamAdd 2^24 GB/s (12 bytes an item over the best of 5 calls), streamed / "
          f"monolithic / monolithic / streamed: {row[1:5]} (warm block {row[0]}, last {row[5]}); "
          f"chunks {chunks}")
    ov = wl.measure_stream_overlap(gpus, n=1 << 22, streamed=True, duplex_probe=True, reps=5)
    print(f"measure_stream_overlap(streamed=True, duplex_probe=True): {json.dumps(ov)}")
    dc = wl.duplex_ceiling()
    print(f"duplex_ceiling(): {json.dumps(dc)}")
    out["overlap"] = {k: ov.get(k) for k in ("overlap_fraction", "stream_chunks",
                                             "overlap_ceiling", "achieved_vs_ceiling")}
    out["duplex_ceiling"] = dc["ceiling"]
    return out


def check_nbody_e2e(wl, gpus, mods) -> dict:
    """``nbody_e2e`` at n = 8192: 150 iterations in enqueue windows of 50,
    fused, over two partition lanes of the card; the host check within
    0.01 and every n-body launch on the loop form."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
    r = wl.nbody_e2e(gpus.subset(1), n=8192, iters=150, window=50)
    forms = dict(cuda_backend.FORMS.by_key)
    routes = dict(reg.launch_counts)
    print(f"nbody_e2e n=8192, 150 iterations, windows of 50: {json.dumps(r)}; forms {forms}; "
          f"routes {routes}; graphs {dict(graphs.GRAPHS.by_key)}")
    gate_forms(forms, {"nBody": "loop"})
    if r["host_check_max_err"] > 0.01 or routes["torch"] or r["lanes"] != 2:
        raise AssertionError(f"nbody_e2e: {r}, routes {routes}")
    return r


def check_no_compute(ck, wl, gpus, mods) -> None:
    """``no_compute_mode`` on the GPU lane: per call and in enqueue mode the
    arrays move (H2D and D2H counted) and no kernel launches, the host
    output keeps what it held, and an enqueue repeat counts the fused
    refusal ``no-compute``."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    n = 1 << 20
    y0 = np.arange(n, dtype=np.float32) % 13
    x = ck.ClArray(np.ones(n, np.float32), name="x", read_only=True, fast=True)
    y = ck.ClArray(y0.copy(), name="y", partial_read=True, fast=True)
    with ck.NumberCruncher(gpus.subset(1), SAXPY_SRC) as cr:
        cr.no_compute_mode = True
        reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
        x.next_param(y).compute(cr, 7300, "saxpy", n, 256, values=(ALPHA,))
        cr.enqueue_mode = True
        for _ in range(3):
            x.next_param(y).compute(cr, 7301, "saxpy", n, 256, values=(ALPHA,))
        cr.enqueue_mode = False
        counts = launch_counts(reg, cuda_backend, mandel_op, ew_op)
        transfers = dict(cr.cores.workers[0].transfers)
        stats = json.loads(json.dumps(cr.fused_stats))
    print(f"no_compute_mode: launches {counts}, transfers {transfers}, fused_stats {stats}")
    gate_exact(y.host(), y0, "no_compute_mode y")
    # the per-call call uploads x and y and reads y back; the enqueued calls
    # find both resident and read y back once, at the flush
    want = {("h2d", "x"): 1, ("h2d", "y"): 1, ("d2h", "y"): 2}
    if (sum(counts["routes"].values()) or counts["emitted"] or transfers != want
            or stats["disengaged"].get("no-compute", 0) != 2):
        raise AssertionError(f"no_compute_mode: launches {counts}, transfers {transfers}, "
                             f"fused_stats {stats}")


# -- the pipelines phase: the pipelined engines, device pipelines, the pool ----

PIPE_BLOBS = 8
PIPE_CALLS = 4
#: the device pipelines' three stages: addOne -> timesTwo -> addHidden (h = 3)
STAGE_SRCS = (
    ("addOne", """
__kernel void addOne(__global float* a, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] + 1.0f;
}
"""),
    ("timesTwo", """
__kernel void timesTwo(__global float* a, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] * 2.0f;
}
"""),
    ("addHidden", """
__kernel void addHidden(__global float* a, __global float* h, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] + h[i];
}
__kernel void initHidden(__global float* a, __global float* h, __global float* b) {
    int i = get_global_id(0);
    h[i] = 3.0f;
}
"""),
)


def blob_launches(ranges: list[list[int]], blobs: int, step: int) -> list[int]:
    """The launches each lane makes in pipelined calls with these range
    tables: every blob of a lane's range runs its ladder of ``step * 2^k``
    chunks."""
    from cekirdekler_tpu_torch.core.worker import _ladder

    out = [0] * (len(ranges[0]) if ranges else 0)
    for r in ranges:
        for i, size in enumerate(r):
            if size:
                out[i] += blobs * len(_ladder(size // blobs, step))
    return out


def gate_blob_launches(label: str, counts: dict, gpu: int, host: int, kernel: str,
                       hand: bool) -> None:
    """The GPU lane's ``gpu`` blob launches all ran the hand-written kernel
    (the emitter's CUDA route, or ``csrc/mandelbrot.cu``), the host lanes'
    ``host`` launches their plain version, and no launch of the GPU lane
    took the torch route."""
    routes = counts["routes"]
    if hand:
        ok = (counts["mandelbrot.cu"] == gpu and routes.get("python", 0) == gpu + host
              and not routes.get("torch", 0))
    else:
        ok = (counts["emitted"].get(kernel, 0) == gpu and routes.get("cuda", 0) == gpu
              and routes.get("torch", 0) == host)
    if not ok:
        raise AssertionError(f"pipelined {label}: want the GPU lane's {gpu} blob launches on "
                             f"the hand-written kernel and the host lanes' {host} on the plain "
                             f"version; counts {counts}")


def pipelined_stream_runs(ck, wl, gpus, mods, fast: bool, n: int, calls: int) -> dict:
    """streamAdd over ``n`` floats (page-locked or pageable) on one GPU-lane
    cruncher: monolithic, streamed (the tuner's choice) and pipelined by the
    EVENT engine at lookahead 1, 2 and 4 and by the DRIVER engine,
    ``calls`` calls each, in turns and again in reverse.  Every call's
    ``c`` is held against the first monolithic call's, bit for bit, as it
    lands.  Returns that first output, and each run's last output, host
    walls, launch counts and count of differing elements a call."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    configs = (("monolithic", None, 2), ("streamed", None, 2),
               ("EVENT L=1", ck.PIPELINE_EVENT, 1), ("EVENT L=2", ck.PIPELINE_EVENT, 2),
               ("EVENT L=4", ck.PIPELINE_EVENT, 4), ("DRIVER", ck.PIPELINE_DRIVER, 2))
    rng = np.random.default_rng(31)
    # made by size: ``fast`` gives an array made from data no page-locked memory
    a, b = (ck.ClArray(n, np.float32, name=k, partial_read=True, read_only=True, fast=fast)
            for k in "ab")
    for arr in (a, b):
        arr.host()[:] = rng.standard_normal(n).astype(np.float32)
    c = ck.ClArray(n, np.float32, name="c", write_only=True, fast=fast)
    runs = {label: {"walls": [], "launches": [], "diffs": []} for label, _, _ in configs}
    first = None
    with ck.NumberCruncher(gpus.subset(1), wl.STREAM_SRC) as cr:
        for order in (configs, configs[::-1]):
            for label, ptype, look in order:
                cr.streamed_transfers = label == "streamed"
                cr.pipeline_lookahead = look
                for _ in range(calls):
                    c.host()[:] = 0.0
                    reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
                    t0 = time.perf_counter()
                    a.next_param(b, c).compute(cr, 7400, "streamAdd", n, 256,
                                               pipeline=ptype is not None,
                                               pipeline_blobs=PIPE_BLOBS,
                                               pipeline_type=ptype or ck.PIPELINE_EVENT)
                    runs[label]["walls"].append((time.perf_counter() - t0) * 1e3)
                    runs[label]["launches"].append(launch_counts(reg, cuda_backend, mandel_op,
                                                                 ew_op))
                    if first is None:
                        first = c.host().copy()
                    runs[label]["diffs"].append(int(np.count_nonzero(
                        c.host().view(np.uint32) != first.view(np.uint32))))
                runs[label]["out"] = c.host().copy()
    runs["want"] = a.host() + b.host()
    runs["first"] = first
    return runs


def gate_pipelined_stream(runs: dict, label: str, n: int, on_card: bool) -> dict:
    """The gates of :func:`pipelined_stream_runs`' runs: the monolithic
    output is ``a + b``, every call's output the monolithic one bit for bit,
    and on the card every pipelined call's blobs launched on the emitter's
    CUDA route (streaming form).  Returns each run's best and median host
    ms."""
    runs = dict(runs)
    want, first = runs.pop("want"), runs.pop("first")
    gate_exact(first, want, f"{label}, monolithic")
    gate_exact(runs["monolithic"]["out"], want, f"{label}, monolithic")
    blob = blob_launches([[n]], PIPE_BLOBS, 256)[0]
    row = {}
    for name, run in runs.items():
        for k, diff in enumerate(run["diffs"]):
            if diff:
                raise AssertionError(f"{label}, {name}, against the monolithic run: call "
                                     f"{k + 1} of {len(run['diffs'])} differs at {diff} of "
                                     f"{n} elements")
        gate_exact(run["out"], runs["monolithic"]["out"],
                   f"{label}, {name}, against the monolithic run")
        walls = sorted(run["walls"])
        row[name] = {"best_ms": round(walls[0], 3), "median_ms": round(walls[len(walls) // 2], 3)}
        if on_card and name.startswith(("EVENT", "DRIVER")):
            for counts in run["launches"]:
                gate_blob_launches(f"{label}, {name}", counts, blob, 0, "streamAdd", hand=False)
                gate_forms(counts["forms"], {"streamAdd": "stream"})
    return row


def check_pipelined_stream(ck, wl, gpus, mods, n: int = 1 << 24,
                           calls: int = PIPE_CALLS) -> dict:
    """Phase (a): streamAdd 2^24 through ``compute(pipeline=True)`` on the GPU
    lane, page-locked and pageable: every call's ``c`` equals the monolithic
    run's bit for bit, every pipelined call launches 8 blobs on the
    emitter's CUDA route (streaming form), none on the torch route; walls
    printed.  Then ``measure_stream_overlap(streamed=False)`` of both
    engines at ``heavy_iters="auto"``, compute factors 1 and 3, with the
    duplex probe (printed).  Returns the walls and the pipelined calls'
    launches of the kernel."""
    out = {"launches": 0}
    for fast in (True, False):
        memory = "page-locked" if fast else "pageable"
        runs = pipelined_stream_runs(ck, wl, gpus, mods, fast, n, calls)
        row = gate_pipelined_stream(runs, f"streamAdd 2^24 ({memory})", n, on_card=True)
        out["launches"] += sum(counts["emitted"].get("streamAdd", 0)
                               for name, run in runs.items() if name.startswith(("EVENT", "D"))
                               for counts in run["launches"])
        print(f"pipelined streamAdd 2^24 ({memory}), {2 * calls} calls a run, host ms a "
              f"call: {json.dumps(row)}")
        out[memory] = row
    for ptype, name in ((ck.PIPELINE_EVENT, "EVENT"), (ck.PIPELINE_DRIVER, "DRIVER")):
        for factor in (1.0, 3.0):
            ov = wl.measure_stream_overlap(gpus, pipeline_type=ptype, heavy_iters="auto",
                                           compute_factor=factor, duplex_probe=True)
            print(f"measure_stream_overlap(streamed=False, {name}, heavy_iters='auto', "
                  f"compute_factor={factor:g}, duplex_probe=True): {json.dumps(ov)}")
            out[f"overlap {name} x{factor:g}"] = {
                k: ov.get(k) for k in ("overlap_fraction", "heavy_iters", "t_pipelined_ms",
                                       "t_serial_ms", "achieved_vs_ceiling")}
    return out


def check_pipelined_mandelbrot(ck, wl, fleets: dict, mods, ref_img: np.ndarray,
                               iters: int = 6) -> dict:
    """Phase (b): mandelbrot over the square image ``ref_img`` at max_iter
    256 (2048x2048 on the card) by the emitted escape form and by the hand
    kernel through ``compute(pipeline=True, pipeline_blobs=8)`` on each
    fleet (a GPU lane and a host lane; the GPU lane alone), A B B A against
    ``pipeline=False``: every image exact and, where lane 0 is a GPU lane,
    its every pipelined blob launch on its hand-written kernel (counted
    from the calls' range tables).  Returns Mpixels/s and the GPU lane's
    pipelined launches by route."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    W = int(round(ref_img.size ** 0.5))
    out = {"launches": {"emitted": 0, "hand kernel": 0}}
    for (label, hand), (fleet, lanes) in itertools.product(
            (("emitted", False), ("hand kernel", True)), fleets.items()):
        row = []
        for pipeline in (True, False, False, True):
            reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
            r = wl.run_mandelbrot(lanes, W, W, 256, iters=iters, warmup=1,
                                  pipeline=pipeline, pipeline_blobs=PIPE_BLOBS, local_range=256,
                                  keep_image=True, use_cuda_kernel=hand)
            gate_exact(r.image.ravel(), ref_img, f"pipelined={pipeline} mandelbrot ({label})")
            if pipeline and lanes[0].is_gpu:
                per_lane = blob_launches(r.ranges_per_iter, PIPE_BLOBS, 256)
                counts = launch_counts(reg, cuda_backend, mandel_op, ew_op)
                gate_blob_launches(f"mandelbrot ({label}, {fleet})", counts, per_lane[0],
                                   sum(per_lane[1:]), "mandelbrot", hand)
                out["launches"][label] += per_lane[0]
                if not hand:
                    gate_forms(counts["forms"], {"mandelbrot": "escape"})
            row.append(round(r.mpixels_per_sec, 1))
        print(f"mandelbrot {W}x{W}x256 ({label}) on {fleet}, Mpixels/s, pipelined "
              f"(8 blobs) / plain / plain / pipelined: {row}; last ranges "
              f"{r.ranges_per_iter[-1]}")
        out[f"{label}, {fleet}"] = row
    return out


def pipeline_stages(n: int):
    """The three stages at ``n`` elements, local range 256."""
    from cekirdekler_tpu_torch import ClArray
    from cekirdekler_tpu_torch.pipeline import PipelineStage

    stages = []
    for kname, src in STAGE_SRCS:
        st = PipelineStage(src, kname, global_range=n, local_range=256,
                           init_kernels="initHidden" if kname == "addHidden" else ())
        st.add_input(ClArray(n, np.float32))
        if kname == "addHidden":
            st.add_hidden(ClArray(n, np.float32))
        st.add_output(ClArray(n, np.float32))
        stages.append(st)
    return stages


def generation_data(n: int, gens: int) -> list[np.ndarray]:
    """Seeded integer-valued data, one array a generation: (x + 1) * 2 + 3 is
    exact in f32."""
    rng = np.random.default_rng(41)
    return [rng.integers(-1000, 1000, n).astype(np.float32) for _ in range(gens)]


def run_generations(pipe, feed: str, datas: list[np.ndarray]) -> tuple[list, float]:
    """Feed every generation by ``pipe.<feed>``, dispose the pipeline;
    returns the valid results and the seconds of generations 1 on (the
    first launches' generation 0 outside the clock)."""
    try:
        result = np.zeros(datas[0].size, np.float32)
        outs = []
        t0 = time.perf_counter()
        for g, data in enumerate(datas):
            if g == 1:
                t0 = time.perf_counter()
            if getattr(pipe, feed)(data, result):
                outs.append(result.copy())
        return outs, time.perf_counter() - t0
    finally:
        pipe.dispose()


def gate_generations(label: str, outs: list, datas: list[np.ndarray]) -> None:
    """Every valid generation of the three stages equals (x + 1) * 2 + 3
    computed on the host, bit for bit."""
    if len(outs) != len(datas) - len(STAGE_SRCS) + 1:
        raise AssertionError(f"{label}: {len(outs)} valid generations of {len(datas)}")
    for j, got in enumerate(outs):
        gate_exact(got, (datas[j] + np.float32(1.0)) * np.float32(2.0) + np.float32(3.0),
                   f"{label}: generation {j}")


def check_device_pipelines(ck, gpus, host, mods, n: int = 1 << 22, gens: int = 16) -> dict:
    """Phase (c): the three stages fed ``gens`` generations of seeded
    integer data, by ``DevicePipeline.feed`` and ``feed_async`` on the card
    and by ``ClPipeline.push`` over the card, a host lane and the card:
    each valid generation equals (x + 1) * 2 + 3 computed on the host, bit
    for bit (a handoff that lets a producer overwrite what its consumer
    reads breaks it), and each stage's kernel launched once a generation,
    on the emitter's CUDA route on the card.  Generation 0 (the kernels'
    first launches) is outside the clock.  Returns generations/s."""
    from cekirdekler_tpu_torch.pipeline import ClPipeline, DevicePipeline

    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    datas = generation_data(n, gens)
    out = {}
    for label, make, feed in (
            ("DevicePipeline.feed", lambda: DevicePipeline.make(pipeline_stages(n), gpus[0]),
             "feed"),
            ("DevicePipeline.feed_async",
             lambda: DevicePipeline.make(pipeline_stages(n), gpus[0]), "feed_async"),
            ("ClPipeline.push (card, host lane, card)",
             lambda: ClPipeline.make(pipeline_stages(n), [gpus[0], host, gpus[0]]), "push")):
        reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
        outs, secs = run_generations(make(), feed, datas)
        gate_generations(label, outs, datas)
        counts = launch_counts(reg, cuda_backend, mandel_op, ew_op)
        host_stage = "host lane" in label
        want = {"addOne": gens, "timesTwo": 0 if host_stage else gens, "addHidden": gens,
                "initHidden": 1}
        got = {k: counts["emitted"].get(k, 0) for k in want}
        if got != want or counts["routes"].get("torch", 0) != (gens if host_stage else 0):
            raise AssertionError(f"{label}: stage launches {counts}, want on the card {want}")
        out[label] = round((gens - 1) / secs, 2)
        print(f"{label}: 3 stages at 2^22, {gens} generations exact, {out[label]} "
              f"generations/s (generations 1-{gens - 1}); launches {counts['emitted']}, "
              f"routes {counts['routes']}")
    return out


def check_device_pool(ck, wl, lanes, mods, ref_img: np.ndarray, tiles: int = 64,
                      hand: bool = False, **pool_kw) -> dict:
    """Phase (d): ``ClDevicePool`` over the GPU lane and two host lanes,
    ``tiles`` mandelbrot tiles of the square image ``ref_img`` at max_iter
    256 (2048x2048 on the card): tiles 0-7 pinned to lane 0
    (``device_select``), a ``global_synchronization``, the rest greedy, the
    last tile a ``broadcast``.  The image must equal ``mandelbrot_host``,
    the tasks done must sum to the tasks run (the broadcast once a lane),
    the pinned tiles on lane 0, and a GPU lane 0's launches on the escape
    form of the emitter's CUDA route (with ``hand``, of
    ``csrc/mandelbrot.cu``).  ``pool_kw`` goes to the pool; with
    ``fine_grained_queue_control`` each task's markers are counted, and
    after ``finish`` every lane's markers are drained (phase 5j (d)).
    Returns tasks/s and each lane's share, and with markers the pool's
    ``max_inflight_depth()``, the most markers one task added and the
    markers each lane had remaining."""
    from cekirdekler_tpu_torch.pipeline import ClDevicePool, ClTask, ClTaskPool

    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    W = H = int(round(ref_img.size ** 0.5))
    tile = W * H // tiles
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, 256)
    img = ck.ClArray(W * H, np.float32, name="img", read=False, write=True)
    markers = bool(pool_kw.get("fine_grained_queue_control"))
    bursts: list[int] = []  # markers each task added on its lane

    def task(k: int) -> ClTask:
        t = ClTask(params=[img], kernel_names=["mandelbrot"], compute_id=7500 + k,
                   global_range=tile, local_range=256, global_offset=k * tile, values=vals)
        if markers:
            run = t.compute

            def counted(cruncher, run=run) -> None:
                workers = cruncher.cores.workers
                added = sum(w.markers.added for w in workers)
                run(cruncher)
                bursts.append(sum(w.markers.added for w in workers) - added)

            t.compute = counted
        return t

    pool = ClTaskPool([ClTask.device_select_begin(0)])
    for k in range(8):
        pool.add(task(k))
    pool.add(ClTask.device_select_end()).add(ClTask.global_synchronization())
    for k in range(8, tiles - 1):
        pool.add(task(k))
    pool.add(task(tiles - 1).as_broadcast())
    reset_counts(reg, graphs, cuda_backend, mandel_op, ew_op)
    out: dict = {}
    source = wl.mandelbrot_cuda_kernel() if hand else wl.MANDELBROT_SRC
    with ClDevicePool(lanes, source, **pool_kw) as dp:
        t0 = time.perf_counter()
        dp.enqueue_task_pool(pool)
        dp.finish()
        secs = time.perf_counter() - t0
        done = dp.tasks_done_per_device()
        if markers:
            out["max_inflight_depth"] = dp.max_inflight_depth()
            out["burst"] = max(bursts)
            out["remaining"] = [lane["remaining"] for c in dp._consumers
                                for lane in lane_markers(c.cruncher)]
    gate_exact(img.host(), ref_img, "device pool image")
    counts = launch_counts(reg, cuda_backend, mandel_op, ew_op)
    gpu_launches = counts["mandelbrot.cu"] if hand else counts["emitted"].get("mandelbrot", 0)
    if sum(done) != tiles - 1 + len(lanes) or done[0] < 8:
        raise AssertionError(f"device pool: tasks done {done}")
    if lanes[0].is_gpu and (gpu_launches < done[0] or (not hand and (
            counts["routes"].get("cuda", 0) != gpu_launches
            or counts["routes"].get("torch", 0) < sum(done[1:])))):
        raise AssertionError(f"device pool: tasks done {done}, launches {counts}")
    if lanes[0].is_gpu and not hand:
        gate_forms(counts["forms"], {"mandelbrot": "escape"})
    share = [round(d / sum(done), 3) for d in done]
    print(f"device pool, {tiles} mandelbrot tiles of {W}x{H // tiles}x256 over "
          f"{[d.name for d in lanes]}{' (csrc/mandelbrot.cu)' if hand else ''}"
          f"{f' with {pool_kw}' if pool_kw else ''}: {sum(done) / secs:.1f} tasks/s "
          f"({secs * 1e3:.1f} ms), tasks done {done}, shares {share}; launches "
          f"{counts['emitted']}, mandelbrot.cu {counts['mandelbrot.cu']}, routes "
          f"{counts['routes']}")
    out.update(tasks_per_s=round(sum(done) / secs, 1), done=done, gpu_launches=gpu_launches)
    return out


def check_pipelines(ck, wl, gpus, mods, ref_img: np.ndarray, card: str) -> dict:
    """The pipelines phase, (a)-(d), with its own counts: both engines must
    have run on the GPU lane."""
    from cekirdekler_tpu_torch.metrics.registry import REGISTRY

    print(f"pipelines phase on {card}")
    phases = {engine: REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                                       engine=engine, device="cuda")
              for engine in ("EVENT", "DRIVER")}
    before = {engine: c.value for engine, c in phases.items()}
    host = ck.all_devices().cpus(2)
    res = {"stream": check_pipelined_stream(ck, wl, gpus, mods),
           "mandelbrot": check_pipelined_mandelbrot(
               ck, wl, {"a GPU + host lane": gpus.subset(1) + host.subset(1),
                        "the GPU lane": gpus.subset(1)}, mods, ref_img),
           "device pipelines": check_device_pipelines(ck, gpus, host[0], mods),
           "pool": check_device_pool(ck, wl, gpus.subset(1) + host, mods, ref_img)}
    engines = {engine: c.value - before[engine] for engine, c in phases.items()}
    print(f"pipelined lane phases on the GPU lane by engine: {engines}")
    if engines["EVENT"] <= 0 or engines["DRIVER"] <= 0:
        raise AssertionError(f"both engines must run on the GPU lane: {engines}")
    return res


#: barriers of the health phase's stall-free baseline (five monitor windows
#: of the default 8 samples) and of its stall: the default monitor confirms
#: a degradation in 3 windows (24 barriers), and the drain holds a
#: quarantined lane 2 barriers before it probes it
HEALTH_BASE = 40
HEALTH_STALLS = 26
HEALTH_MS = 20.0
HEALTH_CALLS = 100
HEALTH_ID = 7300
#: the drains and readmits each phase's controllers made (what
#: ``ck_drain_total`` and ``ck_drain_readmit_total`` count), by phase
DRAINS: dict[str, list[int]] = {}
#: the decision rows of every drain and readmit, with their phase
DRAIN_ROWS: list[dict] = []


def watch_drains() -> None:
    """Tally every drain and readmit by the phase it happened in, with its
    decision row (a registry reset in a phase cannot hide one)."""
    from cekirdekler_tpu_torch.obs import drain
    from cekirdekler_tpu_torch.obs.decisions import DECISIONS

    orig = drain.DrainController.evaluate

    def evaluate(self):
        res = orig(self)
        if res and (res["drained"] or res["readmitted"]):
            name = _PHASES[-1][0] if _PHASES else "?"
            tally = DRAINS.setdefault(name, [0, 0])
            tally[0] += len(res["drained"])
            tally[1] += len(res["readmitted"])
            kinds = ("drain-apply", "readmit")
            rows = [r.to_row() for r in DECISIONS.snapshot()[-4:] if r.kind in kinds]
            DRAIN_ROWS.append({"phase": name, "rows": rows})
        return res

    drain.DrainController.evaluate = evaluate


def check_health_drain(ck, wl, lanes, ref_img: np.ndarray, W: int = 2048,
                       max_iter: int = 256) -> dict:
    """Phase 5g (a): two partition lanes of the card, mandelbrot 2048x2048x256
    in enqueue mode, a call, a barrier and a flush a window, with lane 1's
    barrier fence stalled ``HEALTH_MS`` for ``HEALTH_STALLS`` barriers after
    ``HEALTH_BASE`` clean ones.  Gates: lane 1 read degraded within the
    default monitor's bound (``confirm + 1`` windows of the stall's onset),
    its range 0 from the call after the drain until the probe, one step
    (256) at the probe, then readmitted; the image exact after every
    window; one drain and one readmit (``ck_drain_total``,
    ``ck_drain_readmit_total``); the run's decision log verified by the
    port's ``ckreplay verify`` with no divergence and no row of the three
    kinds unreplayed."""
    import tempfile

    from cekirdekler_tpu_torch.metrics.registry import REGISTRY
    from cekirdekler_tpu_torch.obs.decisions import DECISIONS
    from cekirdekler_tpu_torch.obs.replay import verify_records
    from cekirdekler_tpu_torch.tools import ckreplay
    from cekirdekler_tpu_torch.utils.faultinject import FAULTS

    n = W * W
    counters = [REGISTRY.counter(name) for name in ("ck_drain_total", "ck_drain_readmit_total")]
    before = [c.value for c in counters]
    DECISIONS.clear()
    FAULTS.arm(f"lane-stall@lane1:delay_ms={HEALTH_MS},after={HEALTH_BASE},"
               f"times={HEALTH_STALLS}")
    cr = ck.NumberCruncher(lanes, wl.MANDELBROT_SRC)
    mon = cr.cores.health
    out = ck.ClArray(n, np.float32, name="health_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    ranges, states, verdicts = [], [], []
    try:
        cr.enqueue_mode = True
        for k in range(HEALTH_CALLS):
            out.compute(cr, HEALTH_ID, "mandelbrot", n, 256, values=vals)
            ranges.append(cr.ranges_of(HEALTH_ID))
            cr.barrier()
            states.append(cr.cores.drain.lane_state(1))
            verdicts.append(mon.verdict(1))
            cr.flush()
            if not np.array_equal(out.host(), ref_img):
                bad = int((out.host() != ref_img).sum())
                raise AssertionError(f"health phase: the image differs at {bad} pixels after "
                                     f"window {k}")
        cr.enqueue_mode = False
        report = cr.health_report()
    finally:
        FAULTS.disarm()
        cr.dispose()
    drains = [c.value - b for c, b in zip(counters, before)]
    log_rows = [r.to_row() for r in DECISIONS.snapshot()]
    first_bad = next((k for k, v in enumerate(verdicts) if v == "degraded"), None)
    drained = next((k for k, s in enumerate(states) if s == "quarantined"), None)
    probe = next((k for k, s in enumerate(states) if s == "probation"), None)
    readmit = next((k for k in range(probe or 0, len(states)) if states[k] == "active"
                    and probe is not None), None)
    bound = (mon.confirm + 1) * mon.window
    print(f"health/drain on two partition lanes: lane 1 stalled {HEALTH_MS} ms at barriers "
          f"{HEALTH_BASE + 1}-{HEALTH_BASE + HEALTH_STALLS}; degraded at window {first_bad} "
          f"(bound {HEALTH_BASE + bound}), quarantined {drained}, probation {probe}, readmitted "
          f"{readmit}; lane-1 range per call {[r[1] for r in ranges]}; drains / readmits "
          f"{drains}; verdicts {report.get(1, {}).get('verdict')} / "
          f"{report.get(0, {}).get('verdict')}; evidence {json.dumps(report.get(1))}")
    if first_bad is None or first_bad >= HEALTH_BASE + bound or first_bad < HEALTH_BASE:
        raise AssertionError(f"health phase: lane 1 degraded at window {first_bad}, not within "
                             f"{bound} barriers of the stall at {HEALTH_BASE}")
    if drained is None or probe is None or readmit is None:
        raise AssertionError(f"health phase: states {states}")
    if any(r[1] != 0 for r in ranges[drained + 1: probe + 1]) or ranges[probe + 1][1] != 256:
        raise AssertionError(f"health phase: lane-1 ranges {[r[1] for r in ranges]} (drained "
                             f"{drained}, probe {probe})")
    if drains != [1, 1]:
        raise AssertionError(f"health phase: ck_drain_total / ck_drain_readmit_total moved by "
                             f"{drains}, not [1, 1]")
    verdict = verify_records(log_rows)
    kinds = {k: verdict["per_kind"].get(k, 0) for k in ("health-verdict", "drain-apply",
                                                        "readmit")}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "health.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in log_rows)
        rc = ckreplay.main(["verify", path])
    print(f"health phase decision log: {len(log_rows)} rows, replayed by kind {kinds}, "
          f"not ported {verdict['not_ported']}, divergent {verdict['divergent']}; ckreplay "
          f"verify exit {rc}")
    if (not verdict["ok"] or rc != 0 or kinds["drain-apply"] != 1 or kinds["readmit"] != 1
            or any(k in verdict["not_ported"] for k in kinds)):
        raise AssertionError(f"health phase: the log does not verify: {verdict}")
    return {"degraded_at": first_bad, "drained_at": drained, "probe_at": probe,
            "readmitted_at": readmit}


def gate_trace_marks(marks, lost: list[int], leads: dict, calls: int) -> int:
    """The device-trace gate on a window's launch marks: every mark matched
    to a kernel record of its kernel, except where the trace dropped the
    window's first records past all of its lead kernels (a trace on the card
    drops the first records of a window, ``tools/trace_window.py``): then the
    marks lost must be the window's first ones in launch order, at most half
    of ``calls``.  Returns how many marks the drop took; raises otherwise."""
    order = [m.seq for m in sorted(marks, key=lambda m: m.seq)]
    if not lost:
        return 0
    if (leads.get("launched", 0) > 0 and leads.get("records") == 0
            and lost == order[:len(lost)] and len(lost) <= calls // 2):
        return len(lost)
    raise AssertionError(f"device trace: marks {lost} matched no kernel record of their "
                         f"kernel (leads {leads}; the window's marks {order})")


def check_device_trace(ck, wl, lanes, ref_img: np.ndarray, W: int = 2048,
                       max_iter: int = 256) -> dict:
    """Phase 5g (b): ``trace.device.capture_device`` around 12 calls of the
    main path's mandelbrot 2048x2048x256 on the GPU lane with
    ``trace_lanes`` on (each call per call, one kernel a call).  Gates: the
    launch marks by :func:`gate_trace_marks` (every mark after the records
    the trace dropped matched, in the explicit tier, to a kernel record of
    the emitted kernel, ``ck_kernel``), the image exact, and the unified
    host + device trace split back into the same spans and ops.  Returns
    the kernel's device ms a launch by the trace, the link counts and the
    marks the drop took."""
    import tempfile

    from cekirdekler_tpu_torch.trace import device as dv
    from cekirdekler_tpu_torch.trace.spans import TRACER

    n = W * W
    calls = 12
    cr = ck.NumberCruncher(lanes, wl.MANDELBROT_SRC)
    out = ck.ClArray(n, np.float32, name="trace_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    try:
        cr.cores.trace_lanes = True
        for _ in range(2):
            out.compute(cr, 7301, "mandelbrot", n, 256, values=vals)
        with tempfile.TemporaryDirectory() as tmp:
            TRACER.enable(clear=True)
            try:
                with dv.capture_device(tmp) as cap:
                    for _ in range(calls):
                        out.compute(cr, 7301, "mandelbrot", n, 256, values=vals)
                spans = TRACER.spans_between(cap._t0, cap._t0 + cap.report.wall_ms / 1e3)
            finally:
                TRACER.disable()
        gate_exact(out.host(), ref_img, "traced mandelbrot")
        trace = cr.cores.lane_trace.get(7301, [])
    finally:
        cr.dispose()
    rep = cap.report
    marks = [m for m in dv.MARKS.snapshot() if m.t1 >= cap._t0 and m.kernel == "mandelbrot"]
    matched = {o.seq for o in rep.ops if o.matched_by == "explicit" and "ck_kernel" in o.name}
    lost = [m.seq for m in sorted(marks, key=lambda m: m.seq) if m.seq not in matched]
    print(f"device trace of {calls} mandelbrot calls: {rep.table()}")
    print(f"device trace: marks {len(marks)}, kernel records {rep.n_ops}, links {rep.links}, "
          f"matched by {rep.matched_by}, anchor {rep.anchor}, leads {rep.leads}, marks whose "
          f"record the trace dropped {lost}, lane trace {trace}")
    if rep.absent is not None or len(marks) != calls:
        raise AssertionError(f"device trace: {rep.absent}, {len(marks)} marks")
    dropped = gate_trace_marks(marks, lost, rep.leads, calls)
    doc = dv.unified_chrome_trace(spans, rep, ops=rep.ops, marks=marks)
    json.dumps(doc, allow_nan=False)
    back_spans, back_ops = dv.split_unified_trace(doc)
    key = lambda o: (o.name, o.dur, o.kernel, o.seq, o.cid, o.lane, o.matched_by)
    skey = lambda s: (s.kind, s.cid, s.lane, s.tag, round(s.t1 - s.t0, 9))
    if (sorted(map(skey, back_spans)) != sorted(map(skey, spans))
            or sorted(map(key, back_ops)) != sorted(map(key, rep.ops))):
        raise AssertionError(f"device trace: the unified trace lost data ({len(spans)} spans, "
                             f"{len(rep.ops)} ops -> {len(back_spans)}, {len(back_ops)})")
    prof = rep.kernel("mandelbrot")
    return {"trace_ms": prof.device_ms / max(1, prof.launches), "links": rep.links,
            "matched_by": rep.matched_by, "leads": rep.leads, "marks_dropped": dropped}


def check_nbody_attribution(wl, gpus) -> dict:
    """Phase 5g (c): ``nbody_e2e`` with ``attribution`` and
    ``device_timeline_dir`` on two partition lanes (n = 8192, 60
    iterations in windows of 30): the host check, the attribution's
    factors, and a kernel profile of the n-body launches from the device
    trace with its busy share of the probe window's wall."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        r = wl.nbody_e2e(gpus.subset(1), n=8192, iters=60, window=30, attribution=True,
                         device_timeline_dir=tmp)
    att = r["attribution"]
    prof = att["kernel_profile"]
    print(f"nbody_e2e attribution: busy share of the profiled window (the two lanes' "
          f"streams summed) {att['device_busy_frac_of_wall']}, device busy {att['device_busy_ms']} ms, "
          f"{att['device_events']} kernel records; factors {json.dumps(att['factors'])}; "
          f"lane interference {json.dumps(att['lane_interference'])}; kernel profile "
          f"{json.dumps({k: prof.get(k) for k in ('coverage_frac', 'matched_by', 'links', 'leads', 'roofline', 'absent')})}")
    if (r["host_check_max_err"] > 0.01 or prof.get("absent") is not None
            or "roofline" not in prof or prof["kernels"][0]["kernel"] != "nBody"):
        raise AssertionError(f"nbody_e2e attribution: {json.dumps(att)[:2000]}")
    return {"busy_frac": att["device_busy_frac_of_wall"]}


def verify_shapes(wl) -> list[dict]:
    """The main path's launch shapes as ``compute()`` makes them: kernel
    source (None for the hand kernel, a Python kernel), kernel names and
    each parameter's transfer flags (``workloads.run_mandelbrot``,
    ``run_stream``, ``run_nbody`` and phase 4's saxpy)."""
    return [
        {"label": "mandelbrot", "source": wl.MANDELBROT_SRC, "names": ["mandelbrot"],
         "flags": [dict(read=False, write=True)]},
        {"label": "mandelbrot.cu", "source": None, "names": ["mandelbrot"],
         "flags": [dict(read=False, write=True)]},
        {"label": "streamAdd", "source": wl.STREAM_SRC, "names": ["streamAdd"],
         "flags": [dict(partial_read=True, read_only=True)] * 2 + [dict(write_only=True)]},
        {"label": "saxpy", "source": SAXPY_SRC, "names": ["saxpy"],
         "flags": [dict(read_only=True), dict()]},
        {"label": "nBody", "source": wl.NBODY_SRC, "names": ["nBody"],
         "flags": [dict(read_only=True)] * 3 + [dict(partial_read=True)] * 3},
    ]


def stencil_flags(full: bool) -> list[dict]:
    """The planted stencil's flags: ``x`` read whole, or under
    ``partial_read`` (the unsafe shape); ``out`` written only."""
    return [dict(read_only=True) if full else dict(partial_read=True, read_only=True),
            dict(write_only=True)]


def stencil_host(x: np.ndarray) -> np.ndarray:
    """The stencil in f32 on the host, in the kernel's order of additions."""
    left = np.concatenate([[np.float32(0)], x[:-1]]).astype(np.float32)
    right = np.concatenate([x[1:], [np.float32(0)]]).astype(np.float32)
    return (left + x) + right


def shape_verdicts(ck, wl) -> dict[str, dict]:
    """Each main-path shape's verdict from the port's verifier, by label:
    its error and advisory findings as rows."""
    from cekirdekler_tpu_torch import analysis
    from cekirdekler_tpu_torch.arrays.clarray import TransferFlags
    from cekirdekler_tpu_torch.kernel.registry import KernelProgram

    out = {}
    for shape in verify_shapes(wl):
        prog = KernelProgram(shape["source"] if shape["source"] is not None
                             else wl.mandelbrot_cuda_kernel())
        v = prog.verify(tuple(shape["names"]),
                        tuple(analysis.flag_row(TransferFlags(**f)) for f in shape["flags"]))
        out[shape["label"]] = {"errors": [f.render() for f in v.errors],
                               "advisories": [f.kind for f in v.advisories]}
    return out


def run_stencil(ck, lanes, x: np.ndarray, full: bool) -> tuple[np.ndarray, list[int], object]:
    """One stencil call through ``compute()`` on ``lanes`` (the split pinned
    equal): the output, the range table, and the call's verdict from the
    cruncher's program."""
    from cekirdekler_tpu_torch import analysis

    n = x.size
    flags = stencil_flags(full)
    xa = ck.ClArray(x.copy(), name="stencil_x", **flags[0])
    out = ck.ClArray(np.zeros(n, np.float32), name="stencil_out", **flags[1])
    with ck.NumberCruncher(lanes, STENCIL_SRC) as cr:
        cr.normalized_compute_powers_of_devices = [1.0 / len(lanes)] * len(lanes)
        xa.next_param(out).compute(cr, VERIFY_ID, "stencil3", n, 256, values=(n,))
        verdict = cr.cores.program.verify(
            ("stencil3",), tuple(analysis.flag_row(a.flags) for a in (xa, out)))
        ranges = cr.ranges_of(VERIFY_ID)
    return out.host().copy(), ranges, verdict


def check_planted(ck, split, whole, n: int, counters=()) -> dict:
    """Phase 5h (a), the planted stencil at ``n`` items on the ``split``
    lanes against the ``whole`` lane, in advisory mode, then strict.
    ``counters`` are launch counters (``.by_key`` or dicts) that must not
    move at the strict refusal.  Returns what the gates read."""
    from cekirdekler_tpu_torch.errors import KernelVerifyError
    from cekirdekler_tpu_torch.kernel import registry
    from cekirdekler_tpu_torch.obs.flight import FLIGHT

    rng = np.random.default_rng(21)
    x = rng.standard_normal(n).astype(np.float32)
    want = stencil_host(x)
    os.environ.pop("CK_KERNEL_VERIFY", None)
    t_start = time.time()
    whole_out, _, _ = run_stencil(ck, whole, x, full=True)
    gate_exact(whole_out, want, "stencil on the whole lane")
    full_out, full_ranges, full_v = run_stencil(ck, split, x, full=True)
    if full_v.errors or not np.array_equal(full_out.view(np.int32), whole_out.view(np.int32)):
        raise AssertionError(f"verify gate: the full-read stencil's verdict "
                             f"{[f.render() for f in full_v.errors]} or its split run differs "
                             f"from the whole run")
    # the unsafe shape: three advisory calls on one cruncher, one event
    flags = stencil_flags(False)
    xa = ck.ClArray(x.copy(), name="stencil_x", **flags[0])
    out = ck.ClArray(np.zeros(n, np.float32), name="stencil_out", **flags[1])
    with ck.NumberCruncher(split, STENCIL_SRC) as cr:
        # pinned, so no rebalance leaves a lane's earlier slice in its buffer
        cr.normalized_compute_powers_of_devices = [1.0 / len(split)] * len(split)
        for _ in range(3):
            xa.next_param(out).compute(cr, VERIFY_ID, "stencil3", n, 256, values=(n,))
        halo_ranges = cr.ranges_of(VERIFY_ID)
        halo_out = out.host().copy()
        events = [e for e in FLIGHT.snapshot() if e.kind == "kernel-verify" and e.t >= t_start]
        os.environ["CK_KERNEL_VERIFY"] = "strict"
        try:
            seen = (dict(registry.launch_counts), [dict(getattr(c, "by_key", c)) for c in counters],
                    [dict(w.transfers) for w in cr.cores.workers])
            try:
                xa.next_param(out).compute(cr, VERIFY_ID, "stencil3", n, 256, values=(n,))
                raise AssertionError("verify gate: strict mode ran the halo stencil")
            except KernelVerifyError as e:
                refused = e.finding
            after = (dict(registry.launch_counts), [dict(getattr(c, "by_key", c)) for c in counters],
                     [dict(w.transfers) for w in cr.cores.workers])
        finally:
            os.environ.pop("CK_KERNEL_VERIFY", None)
    bounds = np.cumsum(halo_ranges)[:-1].tolist()
    bad = np.flatnonzero(halo_out.view(np.int32) != whole_out.view(np.int32)).tolist()
    boundary = sorted({i for b in bounds for i in (b - 1, b)})
    res = {"split": halo_ranges, "full_split": full_ranges, "differs_at": bad[:8],
           "boundary": boundary, "refused": refused.kind, "refused_param": refused.param,
           "kernel_verify_events": [e.fields for e in events]}
    print(f"verify gate, planted stencil at {n} items: {json.dumps(res)}")
    if bad != boundary or not bounds:
        raise AssertionError(f"verify gate: the halo stencil's split run differs at {bad[:16]}, "
                             f"not exactly at the partition boundary {boundary}")
    if refused.kind != "partial-read-halo" or refused.param != "x":
        raise AssertionError(f"verify gate: strict refused with {refused.kind} on "
                             f"{refused.param}")
    if after != seen:
        raise AssertionError(f"verify gate: the strict refusal launched or transferred: "
                             f"{seen} -> {after}")
    if [(e.fields["finding"], e.fields["param"]) for e in events] != [("partial-read-halo", "x")]:
        raise AssertionError(f"verify gate: kernel-verify events {[e.fields for e in events]}, "
                             "want one for the halo shape")
    return res


def check_verify_gate(ck, wl, gpus, mods, ref_img: np.ndarray, W: int = 2048,
                      max_iter: int = 256) -> dict:
    """Phase 5h (a) on the card: the main path's shapes under strict, then
    the planted stencil on two partition lanes."""
    registry, _graphs, cuda_backend, mandel_op, _ew = mods
    verdicts = shape_verdicts(ck, wl)
    for label, v in verdicts.items():
        print(f"verify gate, main path shape {label}: errors {v['errors']}, "
              f"advisories {v['advisories']}")
    clean = {k for k, v in verdicts.items() if not v["errors"]}
    if clean != VERIFY_CLEAN:
        raise AssertionError(f"verify gate: clean shapes {sorted(clean)}, want "
                             f"{sorted(VERIFY_CLEAN)}")
    os.environ["CK_KERNEL_VERIFY"] = "strict"
    try:
        for hand in (False, True):
            r = wl.run_mandelbrot(gpus, W, W, max_iter, local_range=256, keep_image=True,
                                  use_cuda_kernel=hand, iters=2)
            gate_exact(r.image.ravel(), ref_img, f"strict mandelbrot (hand={hand})")
        st = wl.run_stream(gpus, n=1 << 24, reps=1)
        nbr = wl.run_nbody(gpus, n=8192, iters=2)
        if nbr["host_check_max_err"] > 0.01:
            raise AssertionError(f"strict n-body host check {nbr['host_check_max_err']}")
        n = 1 << 24
        x = ck.ClArray(np.arange(n, dtype=np.float32) % 7, name="x", read_only=True, fast=True)
        y = ck.ClArray(np.ones(n, dtype=np.float32), name="y", fast=True)
        with ck.NumberCruncher(gpus, SAXPY_SRC) as cr:
            x.next_param(y).compute(cr, 7004, "saxpy", n, 256, values=(ALPHA,))
        gate_exact(y.host(), np.float32(ALPHA) * x.host() + np.float32(1.0), "strict saxpy")
    finally:
        os.environ.pop("CK_KERNEL_VERIFY", None)
    print(f"verify gate: the main path ran under CK_KERNEL_VERIFY=strict (streamAdd "
          f"{st['gb_per_sec']:.1f} GB/s, n-body host check {nbr['host_check_max_err']:.3g})")
    res = check_planted(ck, gpus[0].as_partitions(2), gpus.subset(1), 1 << 22,
                        counters=(cuda_backend.LAUNCHES, mandel_op.LAUNCHES))
    res["clean"] = sorted(clean)
    return res


def checkpoint_resume(wl, cfg, tokens, steps: int, device=None) -> dict:
    """Train ``steps`` steps, checkpoint the model's and AdamW's state
    dicts with ``utils.checkpoint.save_pytree``, load them into a fresh
    model and optimizer with ``load_pytree``, and train ``steps`` more on
    both.  Returns the leaf counts, the leaves that differ after the load,
    and both runs' losses."""
    import tempfile

    import torch

    from cekirdekler_tpu_torch.models import Transformer, adamw
    from cekirdekler_tpu_torch.utils import checkpoint

    kw = {} if device is None else {"device": device}
    model = Transformer(cfg, seed=0, **kw)
    opt = adamw(model, 1e-3)
    batch = {"tokens": tokens}
    first = wl.run_transformer_train(model, opt, batch, steps)["losses"]
    saved = {"model": model.state_dict(), "opt": opt.state_dict()}
    fresh = Transformer(cfg, seed=1, **kw)
    fresh_opt = adamw(fresh, 1e-3)
    # a fresh AdamW holds no moments until its first step: one step on
    # zero gradients gives its state the saved one's structure, devices
    # and dtypes, and the load below overwrites model and optimizer alike
    for p in fresh.parameters():
        p.grad = torch.zeros_like(p)
    fresh_opt.step()
    fresh_opt.zero_grad()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_pytree(tmp, steps, saved)
        like = {"model": fresh.state_dict(), "opt": fresh_opt.state_dict()}
        got = checkpoint.load_pytree(tmp, like)
    fresh.load_state_dict(got["model"])
    fresh_opt.load_state_dict(got["opt"])
    mine, _ = checkpoint._flatten({"model": model.state_dict(), "opt": opt.state_dict()})
    back, _ = checkpoint._flatten({"model": fresh.state_dict(), "opt": fresh_opt.state_dict()})
    differ = []
    for i, (a, b) in enumerate(zip(mine, back)):
        if torch.is_tensor(a):
            same = (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                    and a.device == b.device and torch.equal(a, b))
        else:
            same = type(a) is type(b) and a == b
        if not same:
            differ.append(i)
    bf16 = sum(1 for a in mine if torch.is_tensor(a) and a.dtype == torch.bfloat16)
    moments = sum(1 for k in ("exp_avg", "exp_avg_sq") for st in opt.state.values() if k in st)
    a = wl.run_transformer_train(model, opt, batch, steps)["losses"]
    b = wl.run_transformer_train(fresh, fresh_opt, batch, steps)["losses"]
    return {"leaves": len(mine), "loaded": len(back), "differ": differ, "bf16_leaves": bf16,
            "moments": moments, "first": first, "losses": a, "resumed": b}


def check_checkpoint(wl, fa, card: str) -> dict:
    """Phase 5h (b) on the card: the transformer phase's widths with bf16
    parameters, ``attention="flash"``, 4x2049."""
    import torch

    from cekirdekler_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(attention="flash", param_dtype=torch.bfloat16)
    rng = np.random.default_rng(17)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2049))).cuda()
    counters = (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.PLAIN_RUNS, fa.PLAIN_BWD_RUNS, fa.BWD_ROUTES)
    for c in counters:
        c.reset()
    res = checkpoint_resume(wl, cfg, tokens, CKPT_STEPS)
    seen = {"LAUNCHES": dict(fa.LAUNCHES.by_key), "BWD_LAUNCHES": dict(fa.BWD_LAUNCHES.by_key),
            "BWD_ROUTES": dict(fa.BWD_ROUTES.by_key), "plain": fa.PLAIN_RUNS.count,
            "plain_bwd": fa.PLAIN_BWD_RUNS.count}
    rel = [abs(a - b) / abs(a) for a, b in zip(res["losses"], res["resumed"])]
    print(f"checkpoint of {res['leaves']} leaves ({res['bf16_leaves']} bf16, {res['moments']} "
          f"AdamW moments) after {CKPT_STEPS} steps at 4x2048: leaves that differ after the load "
          f"{res['differ']}; losses {res['first']} then {res['losses']} against the resumed "
          f"{res['resumed']} (relative {max(rel):.3g}, limit 1e-3); launch counts {seen} on {card}")
    n = cfg.n_layers * 3 * CKPT_STEPS
    want = {"LAUNCHES": {"tc": n}, "BWD_LAUNCHES": {"dq": n, "dkv": n},
            "BWD_ROUTES": {"tc": 2 * n}, "plain": 0, "plain_bwd": 0}
    if res["differ"] or res["leaves"] != res["loaded"] or not res["bf16_leaves"] \
            or not res["moments"]:
        raise AssertionError(f"checkpoint: leaves {res['leaves']} / {res['loaded']}, differ at "
                             f"{res['differ']}")
    if max(rel) > 1e-3 or not all(np.isfinite(res["losses"] + res["resumed"])):
        raise AssertionError(f"checkpoint: resumed losses {res['resumed']} against "
                             f"{res['losses']}")
    if seen != want:
        raise AssertionError(f"checkpoint: launch counts {seen}, want {want}")
    res["max_rel"] = max(rel)
    return res


def fetch(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    """GET ``url``: (status, body), an HTTP error's status and body too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


DEBUG_ENDPOINTS = ("/", "/metrics", "/statusz", "/tracez", "/healthz", "/flightz",
                   "/profilez", "/decisionz", "/reqz", "/servez")


def debug_server_run(ck, wl, lanes, ref_img: np.ndarray, W: int, max_iter: int,
                     calls: int = DEBUG_CALLS) -> dict:
    """``serve_debug(0)`` on a cruncher over ``lanes`` while ``calls``
    mandelbrot calls run (calls 4-7 inside one ``capture_device``
    window), a thread fetching every endpoint in turn meanwhile; then each
    endpoint once more, the server closed, and the port tried again.
    Returns each endpoint's statuses and last body."""
    import contextlib
    import tempfile
    import threading
    import urllib.error

    from cekirdekler_tpu_torch.trace import device as dv

    n = W * W
    out = ck.ClArray(n, np.float32, name="debug_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    seen: dict[str, list[int]] = {ep: [] for ep in DEBUG_ENDPOINTS}
    bodies: dict[str, bytes] = {}
    done = threading.Event()
    with ck.NumberCruncher(lanes, wl.MANDELBROT_SRC) as cr:
        srv = cr.serve_debug(0)
        if cr.serve_debug(0) is not srv or srv.host != "127.0.0.1":
            raise AssertionError("debug server: serve_debug is not idempotent on 127.0.0.1")

        def scrape() -> None:
            while not done.is_set():
                for ep in DEBUG_ENDPOINTS:
                    code, body = fetch(srv.url + ep)
                    seen[ep].append(code)

        t = threading.Thread(target=scrape, name="debug-scrape", daemon=True)
        t.start()
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as window:
            for k in range(calls):
                if k == 4:
                    cap = window.enter_context(dv.capture_device(tmp))
                out.compute(cr, DEBUG_ID, "mandelbrot", n, 256, values=vals)
                if k == 7:
                    window.close()
        done.set()
        t.join(timeout=60)
        gate_exact(out.host(), ref_img, "mandelbrot under the debug server")
        for ep in DEBUG_ENDPOINTS:
            code, body = fetch(srv.url + ep)
            seen[ep].append(code)
            bodies[ep] = body
        url = srv.url
    try:
        fetch(url + "/", timeout=5.0)
        answered = True
    except (urllib.error.URLError, ConnectionError, OSError):
        answered = False
    return {"statuses": seen, "bodies": bodies, "answered_after_close": answered,
            "report": cap.report, "url": url}


def gate_debug_server(run: dict, lanes: int, on_card: bool) -> dict:
    """The debug-server gates on one :func:`debug_server_run`."""
    st, bodies = run["statuses"], run["bodies"]
    for ep, codes in st.items():
        want = 501 if ep == "/servez" else 200
        if not codes or any(c != want for c in codes):
            raise AssertionError(f"debug server: {ep} answered {sorted(set(codes))}, want {want}")
    docs = {ep: json.loads(b) for ep, b in bodies.items() if ep != "/metrics"}
    metrics = bodies["/metrics"].decode()
    lane_series = sorted({line.split("{")[0] for line in metrics.splitlines()
                          if line.startswith("ck_") and f'lane="{lanes - 1}"' in line})
    status = docs["/statusz"]
    shares = status.get("shares", {}).get(str(DEBUG_ID))
    prof = docs["/profilez"]["last_capture"] or {}
    rows = [k for k in prof.get("kernels", []) if k["kernel"] == "mandelbrot"]
    dec = docs["/decisionz"]
    mine = [r for r in dec["recent"] if (r.get("inputs") or {}).get("cid") == DEBUG_ID]
    res = {"calls_scraped": {ep: len(c) for ep, c in st.items()}, "lane_series": lane_series,
           "lanes": [ln["device"] for ln in status.get("lanes", [])], "shares": shares,
           "profilez_rows": rows, "profilez_absent": prof.get("absent"),
           "decision_rows": len(mine), "decision_kinds": sorted({r["kind"] for r in mine}),
           "servez": docs["/servez"], "answered_after_close": run["answered_after_close"]}
    if not lane_series:
        raise AssertionError(f"debug server: /metrics names no ck_* series of lane {lanes - 1}")
    if len(status.get("lanes", [])) != lanes or not shares or sum(shares) == 0:
        raise AssertionError(f"debug server: /statusz lanes {res['lanes']}, shares {shares}")
    if on_card and (not rows or rows[0]["launches"] <= 0):
        raise AssertionError(f"debug server: /profilez holds no mandelbrot row: {prof}")
    if not on_card and not (rows or prof.get("absent")):
        raise AssertionError(f"debug server: /profilez holds neither a row nor an absence: {prof}")
    if not mine:
        raise AssertionError("debug server: /decisionz holds none of the calls' decision rows")
    if "A 8" not in docs["/servez"].get("error", ""):
        raise AssertionError(f"debug server: /servez body {docs['/servez']}")
    if docs["/healthz"].get("healthy") is not True:
        raise AssertionError(f"debug server: /healthz {docs['/healthz']}")
    if run["answered_after_close"]:
        raise AssertionError("debug server: the port still answers after close")
    return res


def check_debug_server(ck, wl, gpus, ref_img: np.ndarray, W: int = 2048,
                       max_iter: int = 256) -> dict:
    """Phase 5h (c) on the card: two partition lanes, the main path's
    mandelbrot 2048x2048x256."""
    run = debug_server_run(ck, wl, gpus[0].as_partitions(2), ref_img, W, max_iter)
    res = gate_debug_server(run, 2, on_card=True)
    print(f"debug server at {run['url']}: {json.dumps(res)}")
    return res


# -- phase 5i: the compile cache ------------------------------------------------


def warm_first_window(ck, wl, lanes, source, ref_img: np.ndarray, W: int = 2048,
                      max_iter: int = 256) -> dict:
    """Phase 5i (a) for one mandelbrot source: a fresh cruncher on ``lanes``,
    ``Cores.warmup`` of the W x W x ``max_iter`` shape, then its first
    enqueue-mode windows.  Returns the counts before and after the windows
    (launchers, fused ladders, ``BUILDS``), the launches the path made, the
    warmup's result and whether the image is exact."""
    from types import SimpleNamespace

    from cekirdekler_tpu_torch.core.compilecache import WarmupSpec
    from cekirdekler_tpu_torch.kernel import build, cuda_backend
    from cekirdekler_tpu_torch.ops import mandelbrot as mandel_op

    n = W * W
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    for counter in (cuda_backend.LAUNCHES, mandel_op.LAUNCHES):
        counter.reset()
    with ck.NumberCruncher(lanes, source) as cr:
        prog = cr.cores.program

        def counts() -> tuple:
            return (prog.compiled_count, prog.fused_compiled_count, dict(build.BUILDS.by_key),
                    prog.compiled_counts_by_platform())

        at_start = counts()
        t0 = time.perf_counter()
        out = SimpleNamespace(size=n, dtype="float32")
        warmed = cr.cores.warmup([WarmupSpec.from_job(["mandelbrot"], [out], 7001, n, 256, 0,
                                                      vals)])
        warm_s = time.perf_counter() - t0
        before = counts()
        t0 = time.perf_counter()
        r = wl.run_mandelbrot(None, W, W, max_iter, local_range=256, keep_image=True,
                              readback="final", sync_every=12, cruncher=cr)
        window_s = time.perf_counter() - t0
        after = counts()
    return {"warmup": warmed, "warm_s": warm_s, "window_s": window_s,
            "at_start": at_start, "before": before, "after": after,
            "exact": bool(np.array_equal(r.image.ravel(), ref_img)),
            "launches": {"emitted": cuda_backend.LAUNCHES.by_key.get("mandelbrot", 0),
                         "mandelbrot.cu": mandel_op.LAUNCHES.count}}


def gate_warm_window(label: str, run: dict, kernel: str | None) -> None:
    """Phase 5i (a)'s gates: warmup warmed the spec, the windows after it
    built, compiled and loaded nothing, the image is exact, and ``kernel``
    (a key of ``run["launches"]``; None on host lanes) launched."""
    if run["warmup"]["warmed"] != 1:
        raise AssertionError(f"compile cache ({label}): warmup warmed {run['warmup']}")
    if run["before"] != run["after"]:
        raise AssertionError(f"compile cache ({label}): the first windows after warmup built "
                             f"or loaded something: (launchers, fused ladders, builds, by "
                             f"platform) {run['before']} -> {run['after']}")
    if not run["exact"]:
        raise AssertionError(f"compile cache ({label}): the image differs from the reference")
    if kernel is not None and run["launches"][kernel] <= 0:
        raise AssertionError(f"compile cache ({label}): {kernel} never launched: "
                             f"{run['launches']}")


def gate_coldstart(trio: dict, on_card: bool) -> None:
    """Phase 5i (b)'s gates over ``tools/coldstart.trio``'s result: no child
    failed, the three velocity hashes agree, the warm child's warmup hit
    and its first batch built no launcher and ran no compiler, populate left
    an entry, and on the card a library under ``<root>/lib`` and n-body
    launches in every child."""
    for mode in ("cold", "populate", "warm"):
        if "error" in trio[mode]:
            raise AssertionError(f"coldstart: the {mode} child failed: {trio[mode]['error']}")
    if not trio["exact"]:
        raise AssertionError("coldstart: the three children's velocities differ: "
                             f"{[trio[m].get('digest') for m in ('cold', 'populate', 'warm')]}")
    warm = trio["warm"]
    first = warm["first_batch"]
    if first.get("compile", 0) or first.get("launchers", 0):
        raise AssertionError(f"coldstart: the warm child's first batch compiled: {first}")
    if warm["warm"]["hits"] < 1 or warm["warm"]["misses"]:
        raise AssertionError(f"coldstart: the warm child's warmup missed: {warm['warm']}")
    if trio["entries"] < 1:
        raise AssertionError("coldstart: populate wrote no entry")
    if on_card:
        if trio["libraries"] < 1:
            raise AssertionError("coldstart: populate left no library under <root>/lib")
        for mode in ("cold", "populate", "warm"):
            if trio[mode].get("launches", {}).get("nBody", 0) <= 0:
                raise AssertionError(f"coldstart: n-body never launched on the card in the "
                                     f"{mode} child: {trio[mode].get('launches')}")


def emit_hash_ms(cuda_backend, kdef, dev, reps: int = 20) -> float:
    """Median host ms of a new ``_CudaKernel``'s ``entry`` for an already
    loaded library: the emit, the hash and the lookup that every launch
    geometry's first launch pays (``build_kernel_fn_cuda`` makes one a
    geometry)."""
    import torch

    probe = cuda_backend._CudaKernel(kdef)
    storage = probe.storage_of([torch.zeros(1, device=dev)] * len(probe.arrays))
    probe.entry(storage)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cuda_backend._CudaKernel(kdef).entry(storage)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def check_compile_cache(ck, wl, gpus, programs: dict, ref_img: np.ndarray, card: str) -> dict:
    """Phase 5i on the card: (a) and (b) of the docstring."""
    import shutil
    import tempfile

    import torch

    from cekirdekler_tpu_torch.kernel import cuda_backend
    from cekirdekler_tpu_torch.tools import coldstart

    out: dict = {}
    for label, source, kernel in (("C-subset", wl.MANDELBROT_SRC, "emitted"),
                                  ("hand kernel", wl.mandelbrot_cuda_kernel(), "mandelbrot.cu")):
        run = warm_first_window(ck, wl, gpus.subset(1), source, ref_img)
        gate_warm_window(label, run, kernel)
        print(f"compile cache ({label}): warmup {run['warmup']} in {run['warm_s']:.3f} s, then "
              f"the first windows in {run['window_s']:.3f} s built nothing: (launchers, fused "
              f"ladders, builds, by platform) at the start {run['at_start']}, after warmup "
              f"{run['before']}, after the windows {run['after']}; launches {run['launches']}; "
              f"image exact")
        out[label] = {"warm_s": run["warm_s"], "window_s": run["window_s"],
                      "launches": run["launches"]}
    dev = gpus[0].torch_device
    out["emit_hash_ms"] = {name: emit_hash_ms(cuda_backend, programs[name], dev)
                           for name in ("mandelbrot", "nBody")}
    print(f"emit and hash of a new launch geometry's kernel, the library loaded (median of "
          f"20, host ms): {out['emit_hash_ms']} on {card}")
    root = tempfile.mkdtemp(prefix="ck_coldstart_")
    try:
        trio = coldstart.trio(root, n=8192, local_range=256, iters=4, timeout=180.0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for mode in ("cold", "populate", "warm"):
        print(f"coldstart {mode}: {json.dumps(trio[mode])}")
    gate_coldstart(trio, on_card=True)
    out["coldstart"] = {m: {"first_batch_ms": trio[m]["first_batch_ms"],
                            "steady_batch_ms": trio[m]["steady_batch_ms"],
                            "first_batch": trio[m]["first_batch"]}
                        for m in ("cold", "populate", "warm")}
    out["coldstart"]["warmup_ms"] = trio["warm"]["warmup_ms"]
    print(f"coldstart n-body 8192 (local 256, 4 iterations a batch), first batch ms cold "
          f"{trio['cold']['first_batch_ms']:.3f}, populate {trio['populate']['first_batch_ms']:.3f}, "
          f"warm {trio['warm']['first_batch_ms']:.3f} (after warm_from_disk "
          f"{trio['warm']['warmup_ms']:.3f}); steady ms {trio['cold']['steady_batch_ms']:.3f} / "
          f"{trio['populate']['steady_batch_ms']:.3f} / {trio['warm']['steady_batch_ms']:.3f}; "
          f"populate left {trio['entries']} entries, {trio['libraries']} libraries; exact; "
          f"{torch.cuda.get_device_name(0)}; {card}")
    return out


# -- phase 5j: queue markers and user events -----------------------------------


def lane_markers(cr) -> list[dict]:
    """Each lane's markers of the cruncher ``cr`` after the lane's ``drain``
    (at most 10 s): added, reached, remaining and the adds by site
    (``Worker.markers_by_site``)."""
    out = []
    for w in cr.cores.workers:
        m = w.markers
        m.drain(timeout=10.0)
        out.append({"lane": w.index, "gpu": w.stream is not None, "added": m.added,
                    "reached": m.reached, "remaining": m.remaining(),
                    "sites": dict(w.markers_by_site)})
    return out


def markers_main_path(ck, wl, lanes, ref_img: np.ndarray, reg) -> dict:
    """Phase 5j (a)'s run: ``run_mandelbrot`` of the square image ``ref_img``
    (max_iter 256, a warm call and two timed) over ``lanes`` with
    ``fine_grained_queue_control`` on,
    the launch counts by route set to 0 just before it and read just
    after; then each lane's markers after its drain."""
    W = int(round(ref_img.size ** 0.5))
    with ck.NumberCruncher(lanes, wl.MANDELBROT_SRC) as cr:
        cr.fine_grained_queue_control = True
        reg.reset_launch_counts()
        r = wl.run_mandelbrot(lanes, W, W, 256, iters=2, warmup=1, keep_image=True,
                              cruncher=cr)
        routes = dict(reg.launch_counts)
        lanes_out = lane_markers(cr)
        return {"exact": bool(np.array_equal(r.image.ravel(), ref_img)), "routes": routes,
                "lanes": lanes_out, "remaining": cr.count_markers_remaining(),
                "reached": cr.count_markers_reached(), "reach_speed": cr.marker_reach_speed(),
                "mpixels_per_sec": r.mpixels_per_sec, "ranges": r.ranges_per_iter[-1]}


def gate_markers_main_path(run: dict) -> None:
    """Phase 5j (a)'s gates: the image exact, some marker on every GPU lane,
    none remaining after the drain and reached equal to added on every
    lane, and each lane kind's launch markers equal to its route's
    launches (``cuda`` for GPU lanes, the torch lowering's ``torch`` for
    host lanes)."""
    if not run["exact"]:
        raise AssertionError("markers (a): the image differs from mandelbrot_host")
    if sum(lane["added"] for lane in run["lanes"]) <= 0 or any(
            lane["gpu"] and lane["added"] <= 0 for lane in run["lanes"]):
        raise AssertionError(f"markers (a): a lane added no marker: {run['lanes']}")
    for lane in run["lanes"]:
        if lane["remaining"] != 0 or lane["reached"] != lane["added"]:
            raise AssertionError(f"markers (a): lane {lane['lane']} has markers remaining "
                                 f"after its drain: {lane}")
    for gpu, route in ((True, "cuda"), (False, "torch")):
        kind = [lane for lane in run["lanes"] if lane["gpu"] == gpu]
        marked = sum(lane["sites"].get("launch", 0) for lane in kind)
        if kind and marked != run["routes"].get(route, 0):
            raise AssertionError(f"markers (a): the {route} route launched "
                                 f"{run['routes'].get(route, 0)} times, its lanes marked "
                                 f"{marked} launches: {run['lanes']}")


def retirement_run(cr, issue) -> dict:
    """Phase 5j (b)'s measure: ``issue()`` enqueues work on ``cr``; the
    markers remaining right after it returns, the caller's polls (one each
    0.5 ms, for at most 30 s) until none remains, and the ms from the issue
    to then."""
    t0 = time.perf_counter()
    issue()
    after_issue = cr.count_markers_remaining()
    polls = 0
    deadline = time.perf_counter() + 30.0
    while cr.count_markers_remaining() > 0 and time.perf_counter() < deadline:
        polls += 1
        time.sleep(0.0005)
    return {"after_issue": after_issue, "polls": polls,
            "retired_ms": (time.perf_counter() - t0) * 1e3}


def gate_real_retirement(run: dict) -> None:
    """Phase 5j (b)'s gates: a marker remained right after the issue, it
    reached no sooner than ``RETIRE_MS`` later, the caller polled at least
    ``RETIRE_POLLS`` times meanwhile, and none remained after the barrier
    and the drain."""
    if run["after_issue"] <= 0:
        raise AssertionError(f"markers (b): no marker remained right after compute() "
                             f"returned: markers reached at issue ({run})")
    if run["retired_ms"] < RETIRE_MS:
        raise AssertionError(f"markers (b): the markers reached {run['retired_ms']:.3f} ms "
                             f"after the issue, before the work could retire ({run})")
    if run["polls"] < RETIRE_POLLS:
        raise AssertionError(f"markers (b): the caller polled {run['polls']} times while the "
                             f"marker thread waited: it held the interpreter lock ({run})")
    if run["after_drain"] != 0:
        raise AssertionError(f"markers (b): markers remaining after barrier() and drain ({run})")


def check_real_retirement(ck, wl, gpus) -> dict:
    """Phase 5j (b) on the GPU lane at 1024x1024: after a call that builds
    the launchers, an enqueued mandelbrot call at max_iter 65536 times the
    lane (to its barrier); the measured call's max_iter is scaled so that
    its kernel runs about three times ``RETIRE_MS``.  Its counts must lie
    between 1 and max_iter."""
    W = 1024
    n = W * W
    img = ck.ClArray(n, np.float32, name="retire_img", read=False, write=True, fast=True)
    max_iter = 1 << 16
    with ck.NumberCruncher(gpus.subset(1), wl.MANDELBROT_SRC) as cr:
        cr.fine_grained_queue_control = True
        cr.enqueue_mode = True

        def call(mi: int) -> None:
            img.compute(cr, MARKERS_ID, "mandelbrot", n, 256,
                        values=(-2.0, -1.25, 2.5 / W, 2.5 / W, W, mi))

        call(64)  # builds the launchers
        cr.barrier()
        t0 = time.perf_counter()
        call(max_iter)
        cr.barrier()
        calibration_ms = (time.perf_counter() - t0) * 1e3
        max_iter = int(max_iter * max(1.0, 3.0 * RETIRE_MS / max(calibration_ms, 1e-3)))
        run = retirement_run(cr, lambda: call(max_iter))
        cr.barrier()
        lane_markers(cr)
        run.update(after_drain=cr.count_markers_remaining(), max_iter=max_iter,
                   calibration_ms=calibration_ms)
        cr.enqueue_mode = False
    counts = img.host()
    if not (counts.min() >= 1.0 and counts.max() == float(max_iter)):
        raise AssertionError(f"markers (b): escape counts outside [1, {max_iter}]: "
                             f"{counts.min()} .. {counts.max()}")
    return run


def gated_compute(ck, wl, lanes, reg, n: int = 1 << 20) -> dict:
    """Phase 5j (c)'s run: streamAdd over ``lanes`` with markers on and a
    ``dispatch_gate``, called from a thread; after ``GATE_HOLD_S`` untriggered,
    whether the call still runs, the launches since it started and
    whether the output moved; after ``trigger()``, the output against
    ``a + b``, the launches and each lane's markers; then three enqueued
    calls under the fired gate, flushed, and the fused disengages."""
    from cekirdekler_tpu_torch.utils.events import UserEvent

    a = ck.ClArray((np.arange(n) % 13).astype(np.float32), name="gate_a", partial_read=True,
                   read_only=True, fast=True)
    b = ck.ClArray(np.full(n, 0.5, np.float32), name="gate_b", partial_read=True,
                   read_only=True, fast=True)
    c = ck.ClArray(np.zeros(n, np.float32), name="gate_c", read=False, write=True, fast=True)
    want = a.host() + b.host()
    gate = UserEvent()
    errors: list[BaseException] = []
    out: dict = {}
    try:
        with ck.NumberCruncher(lanes, wl.STREAM_SRC) as cr:
            cr.fine_grained_queue_control = True
            cr.dispatch_gate = gate
            reg.reset_launch_counts()

            def run() -> None:
                try:
                    a.next_param(b, c).compute(cr, MARKERS_ID + 1, "streamAdd", n, 256)
                except BaseException as e:  # noqa: BLE001 - raised by the caller
                    errors.append(e)

            t = threading.Thread(target=run, name="gated-compute", daemon=True)
            t0 = time.perf_counter()
            t.start()
            t.join(timeout=GATE_HOLD_S)
            out["held_s"] = time.perf_counter() - t0
            out["held"] = t.is_alive()
            out["moved"] = sum(reg.launch_counts.values())
            out["touched"] = bool(np.any(c.host() != 0.0))
            gate.trigger()
            t.join(timeout=60.0)
            if t.is_alive():
                raise AssertionError("dispatch gate (c): the call did not return after trigger()")
            if errors:
                raise errors[0]
            out["exact"] = bool(np.array_equal(c.host(), want))
            out["launches"] = sum(reg.launch_counts.values())
            out["lanes"] = lane_markers(cr)
            c.host()[:] = 0.0
            cr.enqueue_mode = True
            for _ in range(3):
                a.next_param(b, c).compute(cr, MARKERS_ID + 2, "streamAdd", n, 256)
            cr.enqueue_mode = False
            out["exact_enqueue"] = bool(np.array_equal(c.host(), want))
            out["disengaged"] = dict(cr.fused_stats["disengaged"])
            out["remaining"] = sum(lane["remaining"] for lane in lane_markers(cr))
            cr.dispatch_gate = None
    finally:
        gate.close()
    return out


def gate_gated_compute(run: dict) -> None:
    """Phase 5j (c)'s gates: held untriggered the call had not returned,
    launched nothing and left the output alone; then it was exact, it
    launched, every lane's markers drained, and the gated enqueue calls
    were exact and refused a fused window as ``dispatch-gate``."""
    if not run["held"] or run["moved"] or run["touched"]:
        raise AssertionError(f"dispatch gate (c): the gate did not hold: after "
                             f"{run['held_s']:.3f} s untriggered the call had returned "
                             f"{not run['held']}, launched {run['moved']} times, touched the "
                             f"output {run['touched']}")
    if not (run["exact"] and run["exact_enqueue"]) or run["launches"] <= 0:
        raise AssertionError(f"dispatch gate (c): after trigger() exact {run['exact']}, "
                             f"enqueued exact {run['exact_enqueue']}, launches {run['launches']}")
    if run["remaining"] or any(lane["remaining"] for lane in run["lanes"]):
        raise AssertionError(f"dispatch gate (c): markers remaining after drain: {run}")
    if run["disengaged"].get("dispatch-gate", 0) < 1:
        raise AssertionError(f"dispatch gate (c): the gated repeat did not count "
                             f"dispatch-gate: {run['disengaged']}")


def gate_pool_depth(res: dict, limit: int) -> None:
    """Phase 5j (d)'s gates: every lane's markers drained, and
    ``max_inflight_depth()`` at most ``limit`` plus the most markers one
    task added."""
    if any(res["remaining"]):
        raise AssertionError(f"pool throttle (d): markers remaining after drain: "
                             f"{res['remaining']}")
    if res["max_inflight_depth"] > limit + res["burst"]:
        raise AssertionError(f"pool throttle (d): in-flight depth {res['max_inflight_depth']} "
                             f"over queue_limit {limit} plus one task's {res['burst']} markers")


def check_markers(ck, wl, gpus, mods, ref_img: np.ndarray, card: str) -> dict:
    """Phase 5j, (a)-(e) of the docstring; returns what it printed."""
    reg, graphs, cuda_backend, mandel_op, ew_op = mods
    t0 = time.perf_counter()
    out: dict = {}
    reset_counts(*mods)
    main = markers_main_path(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1), ref_img, reg)
    gate_markers_main_path(main)
    gate_forms(dict(cuda_backend.FORMS.by_key), {"mandelbrot": "escape"})
    gpu_lane = main["lanes"][0]
    out["main_path"] = {"launch_markers": gpu_lane["sites"].get("launch", 0),
                        "routes": main["routes"], "lanes": main["lanes"],
                        "reach_speed": main["reach_speed"]}
    print(f"markers (a): mandelbrot 2048x2048x256 on the GPU lane and a host lane, ranges "
          f"{main['ranges']}: image exact; launches by route {main['routes']}; markers by lane "
          f"{json.dumps(main['lanes'])}; reach speed {main['reach_speed']:.1f} ops/s")
    ret = check_real_retirement(ck, wl, gpus)
    gate_real_retirement(ret)
    out["retirement"] = ret
    print(f"markers (b): an enqueued mandelbrot 1024x1024 at max_iter {ret['max_iter']} on the "
          f"GPU lane: {ret['after_issue']} marker(s) remaining right after compute() returned, "
          f"none {ret['retired_ms']:.3f} ms after the issue, {ret['polls']} polls by the caller "
          f"meanwhile, {ret['after_drain']} after barrier() and drain")
    reset_counts(*mods)
    gated = gated_compute(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1), reg)
    gate_gated_compute(gated)
    gate_forms(dict(cuda_backend.FORMS.by_key), {"streamAdd": "stream"})
    out["gate"] = {k: gated[k] for k in ("held_s", "launches", "disengaged")}
    out["gate"]["launch_markers"] = gated["lanes"][0]["sites"].get("launch", 0)
    print(f"dispatch gate (c): streamAdd 2^20 on the GPU lane and a host lane held "
          f"{gated['held_s']:.3f} s with 0 launches and the output untouched, exact after "
          f"trigger() with {gated['launches']} launches ({cuda_backend.FORMS.by_key}); markers "
          f"{json.dumps(gated['lanes'])}; enqueued under the gate: disengaged "
          f"{gated['disengaged']}")
    pool = check_device_pool(ck, wl, gpus.subset(1) + ck.all_devices().cpus(2), mods, ref_img,
                             hand=True, fine_grained_queue_control=True,
                             queue_limit=POOL_QUEUE_LIMIT)
    gate_pool_depth(pool, POOL_QUEUE_LIMIT)
    out["pool"] = pool
    print(f"pool throttle (d): queue_limit {POOL_QUEUE_LIMIT}, max_inflight_depth() "
          f"{pool['max_inflight_depth']}, the most markers one task added {pool['burst']}, "
          f"{pool['tasks_per_s']} tasks/s")
    out["overhead"] = wl.marker_overhead()
    print(f"marker_overhead(): {json.dumps(out['overhead'])} on {card}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 5j: {out['seconds']:.1f} s")
    return out


# -- phase 5k: the cluster tier across processes on the card ----------------------

#: phase 5k (a) and (b): the timed iterations after the warm-ups
#: (``tools/dcn_cluster.WARMUP``); (c): the elastic job's windows and the window
#: after which the job is preempted
CLUSTER_ITERS = 8
CLUSTER_WINDOWS, CLUSTER_KILL_AFTER = 6, 3
CLUSTER_CID = 7500
#: every wait on a child of phase 5k, in seconds
CLUSTER_CHILD_S = 120.0
#: the server child of phase 5k (a): a CruncherServer on the card
#: (devices=None), its port on a tagged line, served until its stdin closes,
#: then its launch and build counts on a second tagged line
SERVER_CHILD = r"""
import json, sys
from cekirdekler_tpu_torch.cluster import CruncherServer
from cekirdekler_tpu_torch.kernel import cuda_backend, registry
from cekirdekler_tpu_torch.kernel.build import BUILDS
server = CruncherServer()
print("CK_SERVER " + json.dumps({"port": server.port, "device": server.devices[0].kind,
                                  "lanes": len(server.devices)}), flush=True)
sys.stdin.read()
server.stop()
print("CK_SERVER_DONE " + json.dumps({"launches": dict(cuda_backend.LAUNCHES.by_key),
                                       "routes": dict(registry.launch_counts),
                                       "builds": dict(BUILDS.by_key)}), flush=True)
"""


def wire_bytes(msg) -> int:
    """The bytes ``netbuffer.send_message`` puts on the wire for ``msg``
    (its 9-byte header and the payload), counted without encoding it."""
    n = 9 + 4 * 4  # the header; the four section counts
    n += sum(2 + len(k.encode()) + 8 for k in msg.meta)
    n += sum(4 + len(s.encode()) for s in msg.strings)
    n += 9 * len(msg.values)
    return n + sum(30 + np.ascontiguousarray(r.data).nbytes for r in msg.arrays)


class WireCount:
    """While installed, counts the bytes the cluster client sends and
    receives (``client_mod`` is ``cekirdekler_tpu_torch.cluster.client``)."""

    def __init__(self, client_mod):
        self.mod = client_mod
        self.sent = self.received = 0

    def __enter__(self) -> "WireCount":
        self._send, self._recv = self.mod.send_message, self.mod.recv_message

        def send(sock, msg):
            self._send(sock, msg)
            self.sent += wire_bytes(msg)

        def recv(sock):
            msg = self._recv(sock)
            self.received += wire_bytes(msg)
            return msg

        self.mod.send_message, self.mod.recv_message = send, recv
        return self

    def __exit__(self, *exc) -> None:
        self.mod.send_message, self.mod.recv_message = self._send, self._recv


def cluster_env() -> dict:
    """The environment of phase 5k's children: this one's, without the
    planes a parent's phase may have armed, and gloo bound to loopback (the
    jobs are all on this host)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CK_COMPILE_CACHE", "CK_DECISION_LOG", "CK_FAULTS", "CK_KERNEL_VERIFY")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


def tagged_line(lines: "queue.Queue", tag: str, seen: list, timeout: float) -> dict:
    """The JSON after ``tag`` on the next line of a child that has it; the
    other lines go to ``seen``.  Raises when the child ends first or the wait
    passes ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.01, deadline - time.monotonic()))
        except queue.Empty:
            raise AssertionError(f"no {tag.strip()} line within {timeout} s: "
                                 f"{''.join(seen)[-2000:]}") from None
        if line is None:
            raise AssertionError(f"the child ended before its {tag.strip()} line: "
                                 f"{''.join(seen)[-2000:]}")
        if line.startswith(tag):
            return json.loads(line[len(tag):])
        seen.append(line)


def start_child(args: list[str], env: dict) -> tuple:
    """A child interpreter from the repository root with its output pumped
    into a queue by a daemon thread (every read of it can then be bounded)."""
    proc = subprocess.Popen([sys.executable, *args], cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)


def tcp_run(ck, wl, gpus, ref: np.ndarray, W: int, max_iter: int, server: dict, mods) -> dict:
    """Phase 5k (a)'s iterations: a ClusterAccelerator of the server child and
    the GPU lane as mainframe, each iteration's image held against ``ref``."""
    from cekirdekler_tpu_torch.cluster import ClusterAccelerator
    from cekirdekler_tpu_torch.cluster import client as client_mod
    from cekirdekler_tpu_torch.tools import dcn_cluster as tool

    cuda_backend = mods[2]
    n = W * W
    out = ck.ClArray(n, np.float32, name="cluster_out", read=False, write=True)
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter)
    run: dict = {"shares": [], "walls_ms": [], "bad": [], "sent": [], "received": [], "n": n}
    cluster = ClusterAccelerator([("127.0.0.1", server["port"])], local_devices=gpus.subset(1))
    try:
        cluster.setup_nodes(wl.MANDELBROT_SRC)
        reset_counts(*mods)
        with WireCount(client_mod) as wc:
            for k in range(tool.WARMUP + CLUSTER_ITERS):
                out.host()[:] = -1.0  # a pixel no node wrote cannot pass
                sent, received = wc.sent, wc.received
                t0 = time.perf_counter()
                cluster.compute("mandelbrot", [out], CLUSTER_CID, n, 256, values=vals)
                run["walls_ms"].append((time.perf_counter() - t0) * 1e3)
                run["shares"].append(cluster.ranges_of(CLUSTER_CID))
                run["bad"].append(int((out.host() != ref).sum()))
                run["sent"].append(wc.sent - sent)
                run["received"].append(wc.received - received)
        run["nodes"] = len(cluster.clients) + 1
        run["mainframe_launches"] = cuda_backend.LAUNCHES.by_key.get("mandelbrot", 0)
        run["mainframe_routes"] = dict(mods[0].launch_counts)
    finally:
        cluster.dispose()
    timed = run["walls_ms"][tool.WARMUP:]
    run["mpixels_per_sec"] = n * len(timed) / (sum(timed) / 1e3) / 1e6
    return run


def gate_tcp_tier(run: dict, server_done: dict, on_card: bool = True) -> None:
    """Phase 5k (a)'s gates: every iteration's image exact, no node lost, the
    shares inside the range and moved off the equal first split, and on the
    card the emitted kernel launched on both members, none on the torch
    route."""
    if any(run["bad"]):
        raise AssertionError(f"TCP tier: pixels differ from the single-process image by "
                             f"iteration: {run['bad']}")
    if run["nodes"] != 2:
        raise AssertionError(f"TCP tier: the server node was dropped ({run['nodes']} nodes left)")
    n = run["n"]
    for shares in run["shares"]:
        if len(shares) != 2 or sum(shares) != n or min(shares) < 0:
            raise AssertionError(f"TCP tier: shares {shares} outside the range of {n}")
    if all(s == run["shares"][0] for s in run["shares"]):
        raise AssertionError(f"TCP tier: the balancer never left the equal split "
                             f"{run['shares'][0]}")
    if not on_card:
        return
    if run["mainframe_launches"] <= 0 or run["mainframe_routes"].get("torch", 0):
        raise AssertionError(f"TCP tier: the mainframe's launches {run['mainframe_launches']}, "
                             f"routes {run['mainframe_routes']}")
    if server_done["launches"].get("mandelbrot", 0) <= 0 or \
            server_done["routes"].get("torch", 0):
        raise AssertionError(f"TCP tier: the server child's launches {server_done['launches']}, "
                             f"routes {server_done['routes']}")


def gate_dcn_job(job: dict, n: int, digest: str, on_card: bool = True) -> None:
    """Phase 5k (b)'s gates over the first job's reports (the job ends
    preempted, every rank with ``EXIT_PREEMPTED``): each rank's image equal
    to the single-process one, 64-bit values exact, the merged trace
    holding both ranks' spans, the share tables agreeing, and on the card
    each rank on the card with the emitted kernel launched and no launch on
    the torch route."""
    from cekirdekler_tpu_torch.tools.dcn_cluster import EXIT_PREEMPTED

    if job["rcs"] != [EXIT_PREEMPTED] * len(job["rcs"]) or None in job["reports"]:
        raise AssertionError(f"DCN job: exit codes {job['rcs']} (want {EXIT_PREEMPTED} each "
                             f"after window {CLUSTER_KILL_AFTER}): {job['outputs']}")
    for rep in job["reports"]:
        pid = rep["pid"]
        if on_card and rep["device"] == "cpu":
            raise AssertionError(f"DCN rank {pid} ran on a host lane")
        if rep["digest"] != digest:
            raise AssertionError(f"DCN rank {pid}: image digest {rep['digest']}, the single "
                                 f"process's {digest}")
        if not all(rep["exchange_exact"].values()):
            raise AssertionError(f"DCN rank {pid}: 64-bit exchange {rep['exchange_exact']}")
        g = rep["gather"]
        if g["trace_blocks"] != list(range(1, len(job["rcs"]) + 1)) or \
                min(g["spans_by_block"].values()) <= 0:
            raise AssertionError(f"DCN rank {pid}: the merged trace's blocks {g['trace_blocks']}, "
                                 f"spans by block {g['spans_by_block']}")
        if any(sum(s) != n for s in rep["shares"]):
            raise AssertionError(f"DCN rank {pid}: shares {rep['shares']} outside {n}")
        if on_card and (rep["launches"].get("mandelbrot", 0) <= 0 or
                        rep["routes"].get("torch", 0)):
            raise AssertionError(f"DCN rank {pid}: launches {rep['launches']}, routes "
                                 f"{rep['routes']}")
        if rep["elastic"]["last_window"] != CLUSTER_KILL_AFTER:
            raise AssertionError(f"DCN rank {pid}: preempted after window "
                                 f"{rep['elastic']['last_window']}")
    if job["reports"][0]["shares"] != job["reports"][1]["shares"]:
        raise AssertionError("DCN job: the ranks' share tables differ")


def gate_rejoin(job: dict, lanes: list[int], digest: str, on_card: bool = True) -> None:
    """Phase 5k (c)'s gates over the rejoined job's reports: it resumed from
    the last window before the preemption with the changed membership
    recorded and replayed, its image equals the undisturbed one, and on the
    card every rank ran there with the emitted kernel."""
    if job["rcs"] != [0] * len(job["rcs"]) or None in job["reports"]:
        raise AssertionError(f"rejoin: exit codes {job['rcs']}: {job['outputs']}")
    for rep in job["reports"]:
        el, pid = rep["elastic"], rep["pid"]
        if (on_card and rep["device"] == "cpu") or rep["proc_device_counts"] != lanes:
            raise AssertionError(f"rejoin rank {pid}: device {rep['device']}, lanes "
                                 f"{rep['proc_device_counts']} (want {lanes})")
        if el["resumed_from"] != CLUSTER_KILL_AFTER or el["last_window"] != CLUSTER_WINDOWS:
            raise AssertionError(f"rejoin rank {pid}: resumed from {el['resumed_from']}, ended "
                                 f"at {el['last_window']}")
        if el["digest"] != digest:
            raise AssertionError(f"rejoin rank {pid}: image digest {el['digest']}, the "
                                 f"undisturbed run's {digest}")
        if not el["replay_ok"] or not {"member-leave", "member-join", "checkpoint-restore"} \
                <= set(el["decision_kinds"]):
            raise AssertionError(f"rejoin rank {pid}: decisions {el['decision_kinds']}, replay "
                                 f"ok {el['replay_ok']}")
        if on_card and (rep["launches"].get("mandelbrot", 0) <= 0 or
                        rep["routes"].get("torch", 0)):
            raise AssertionError(f"rejoin rank {pid}: launches {rep['launches']}, routes "
                                 f"{rep['routes']}")


def dcn_args(root: str, W: int, max_iter: int, cpu: bool) -> list[str]:
    """The flags phase 5k's two DCN jobs share (``cpu``: host lanes)."""
    args = ["--procs", "2", "--width", str(W), "--max-iter", str(max_iter),
            "--windows", str(CLUSTER_WINDOWS), "--kill-after", str(CLUSTER_KILL_AFTER),
            "--ckpt-root", root, "--timeout", str(CLUSTER_CHILD_S / 2)]
    return args + ["--cpu"] if cpu else args


def dcn_first(root: str, W: int, max_iter: int, env: dict, cpu: bool = False) -> dict:
    """Phase 5k (b): two ranks on the card run the balanced calls, the 64-bit
    exchange, the gather and the first elastic windows, and are preempted."""
    from cekirdekler_tpu_torch.tools import dcn_cluster as tool

    return tool.run_job(dcn_args(root, W, max_iter, cpu) +
                        ["--calls", str(CLUSTER_ITERS), "--phase", "first"],
                        env=env, timeout=CLUSTER_CHILD_S)


def dcn_rejoin(root: str, W: int, max_iter: int, env: dict, cpu: bool = False) -> dict:
    """Phase 5k (c): past a torn newest checkpoint, the preempted job rejoins
    with rank 1 on two partition lanes of the card and finishes the windows."""
    from cekirdekler_tpu_torch.tools import dcn_cluster as tool

    torn = os.path.join(root, f"step_{CLUSTER_KILL_AFTER + 1:012d}")
    os.makedirs(torn, exist_ok=True)
    with open(os.path.join(torn, "arrays.npz"), "wb") as f:
        f.write(b"a torn checkpoint")
    return tool.run_job(dcn_args(root, W, max_iter, cpu) +
                        ["--lanes", "1,2", "--calls", "0", "--phase", "rejoin"],
                        env=env, timeout=CLUSTER_CHILD_S)


def check_cluster(ck, wl, gpus, mods, ref_img: np.ndarray, card: str, W: int = 2048,
                  max_iter: int = 256) -> dict:
    """Phase 5k, (a)-(c) of the docstring; returns what it printed."""
    import shutil
    import tempfile

    from cekirdekler_tpu_torch.kernel.build import BUILDS
    from cekirdekler_tpu_torch.tools import dcn_cluster as tool

    t0 = time.perf_counter()
    env = cluster_env()
    seen: list = []
    out: dict = {}
    root = tempfile.mkdtemp(prefix="ck_5k_")
    ckpt = os.path.join(root, "ckpt")
    proc, lines = start_child(["-c", SERVER_CHILD], env)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            # the server child and the DCN ranks start together; the TCP
            # iterations wait for the DCN job's end, so no two tiers share
            # the card while one is measured
            first_job = pool.submit(dcn_first, ckpt, W, max_iter, env)
            single = ck.ClArray(W * W, np.float32, read=False, write=True)
            with ck.NumberCruncher(gpus.subset(1), wl.MANDELBROT_SRC) as cr:
                single.compute(cr, CLUSTER_CID, "mandelbrot", W * W, 256,
                               values=(-2.0, -1.25, 2.5 / W, 2.5 / W, W, max_iter))
            gate_exact(single.host(), ref_img, "phase 5k's single-process compute()")
            undisturbed = tool.undisturbed_windows(gpus.subset(1), W, max_iter, CLUSTER_WINDOWS)
            first = first_job.result()
        server = tagged_line(lines, "CK_SERVER ", seen, CLUSTER_CHILD_S)
        if server["device"] == "cpu":
            raise AssertionError(f"the server child took a host lane: {server}")
        run = tcp_run(ck, wl, gpus, single.host(), W, max_iter, server, mods)
        proc.stdin.close()
        done = tagged_line(lines, "CK_SERVER_DONE ", seen, CLUSTER_CHILD_S)
        if proc.wait(timeout=CLUSTER_CHILD_S) != 0:
            raise AssertionError(f"the server child exited {proc.returncode}")
        rejoin = dcn_rejoin(ckpt, W, max_iter, env)
    finally:
        stop_child(proc)
        shutil.rmtree(root, ignore_errors=True)
    gate_tcp_tier(run, done)
    for k, (s, w) in enumerate(zip(run["shares"], run["walls_ms"])):
        print(f"cluster (a) TCP iteration {k}{' (warm-up)' if k < tool.WARMUP else ''}: "
              f"shares [server, mainframe] {s}, wall {w:.3f} ms, {run['sent'][k]} B sent, "
              f"{run['received'][k]} B received, image exact")
    print(f"cluster (a) TCP tier, mandelbrot {W}x{W}x{max_iter}, a server child on {server['device']}"
          f" and the GPU lane as mainframe: {run['mpixels_per_sec']:.1f} Mpixels/s over "
          f"{CLUSTER_ITERS} iterations; launches mainframe {run['mainframe_launches']}, server "
          f"{done['launches'].get('mandelbrot', 0)}; builds parent {dict(BUILDS.by_key)}, "
          f"server {done['builds']}; on {card}")
    out["tcp"] = {k: run[k] for k in ("shares", "walls_ms", "sent", "received",
                                      "mpixels_per_sec", "mainframe_launches")}
    out["tcp"]["server_launches"] = done["launches"].get("mandelbrot", 0)
    gate_dcn_job(first, W * W, tool.digest(single.host()))
    gate_rejoin(rejoin, [1, 2], tool.digest(undisturbed))
    for rep in first["reports"]:
        ex = rep["exchange"]
        print(f"cluster (b) DCN rank {rep['pid']} on {rep['device']}: shares by call "
              f"{rep['shares']}, walls {[round(w, 3) for w in rep['walls_ms']]} ms, "
              f"{rep['mpixels_per_sec']:.1f} Mpixels/s; ck_dcn_exchange_bytes_total "
              f"{ {op: v['bytes'] for op, v in ex.items()} }, median ck_dcn_exchange_seconds "
              f"{ {op: v['median_s'] for op, v in ex.items()} } over "
              f"{ {op: v['count'] for op, v in ex.items()} } calls; gather_cluster offsets "
              f"{rep['gather']['offsets']}, alignment margin {rep['gather']['margin_s']:.6f} s, "
              f"merged trace blocks {rep['gather']['trace_blocks']} with spans "
              f"{rep['gather']['spans_by_block']}; 64-bit exchange {rep['exchange_exact']}; "
              f"launches {rep['launches'].get('mandelbrot', 0)}, builds {rep['builds']}")
    for rep in rejoin["reports"]:
        el = rep["elastic"]
        print(f"cluster (c) rejoin rank {rep['pid']} with {rep['lanes']} lane(s): resumed from "
              f"window {el['resumed_from']} (member steps {el['member_steps_before']} -> "
              f"{el['member_steps']}, epoch {el['epoch']}), windows' shares {el['shares']}, "
              f"image equal to the undisturbed run's, decisions {el['decision_kinds']} replayed "
              f"ok; launches {rep['launches'].get('mandelbrot', 0)}, builds {rep['builds']}")
    print(f"cluster (b)/(c) job seconds: first {first['seconds']:.1f}, rejoin "
          f"{rejoin['seconds']:.1f}")
    out["dcn"] = [{k: rep[k] for k in ("pid", "shares", "walls_ms", "mpixels_per_sec",
                                        "exchange", "launches")} | {
        "offsets": rep["gather"]["offsets"], "margin_s": rep["gather"]["margin_s"]}
        for rep in first["reports"]]
    out["rejoin"] = [{"pid": rep["pid"], "lanes": rep["lanes"], "shares": rep["elastic"]["shares"],
                      "launches": rep["launches"]} for rep in rejoin["reports"]]
    out["launches"] = {"tcp_mainframe": run["mainframe_launches"],
                       "tcp_server": out["tcp"]["server_launches"],
                       **{f"dcn_rank{r['pid']}": r["launches"].get("mandelbrot", 0)
                          for r in first["reports"]},
                       **{f"rejoin_rank{r['pid']}": r["launches"].get("mandelbrot", 0)
                          for r in rejoin["reports"]}}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 5k: {out['seconds']:.1f} s")
    return out


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
    from cekirdekler_tpu_torch import parallel as par
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.hardware import rate_prior
    from cekirdekler_tpu_torch.kernel import build, cuda_backend, graphs, lang, registry
    from cekirdekler_tpu_torch.kernel.codegen import build_kernel_fn
    from cekirdekler_tpu_torch.ops import elementwise as ew_op
    from cekirdekler_tpu_torch.ops import flash_attention as fa_op
    from cekirdekler_tpu_torch.ops import mandelbrot as mandel_op
    from cekirdekler_tpu_torch.ops import nbody as nbody_op
    from cekirdekler_tpu_torch.tools import trace_window

    watch_drains()
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
    try:
        ck.BFloat16Arr(1)
        print("ml_dtypes is installed: BFloat16Arr has numpy's bf16 dtype")
    except ImportError as e:
        print(f"ml_dtypes is missing: BFloat16Arr refuses ({e})")

    phase("build")
    programs = {
        "mandelbrot": lang.parse_kernels(wl.MANDELBROT_SRC)[0],
        "nBody": lang.parse_kernels(wl.NBODY_SRC)[0],
        "streamAdd": lang.parse_kernels(wl.STREAM_SRC)[0],
        "saxpy": lang.parse_kernels(SAXPY_SRC)[0],
    }
    jobs = {"mandelbrot.cu": (mandel_op.SOURCE.read_text(), "mandelbrot"),
            "flash_attention.cu": (fa_op.SOURCE.read_text(), "flash_attention"),
            "flash_attention_tc.cu": (fa_op.SOURCE_TC.read_text(), "flash_attention_tc"),
            "flash_attention_bwd.cu": (fa_op.SOURCE_BWD.read_text(), "flash_attention_bwd"),
            "flash_attention_bwd_tc.cu": (fa_op.SOURCE_BWD_TC.read_text(),
                                          "flash_attention_bwd_tc"),
            "flash_attention_parts_tc.cu": (fa_op.SOURCE_PARTS_TC.read_text(),
                                            "flash_attention_parts_tc")}
    # the pipelines phase's kernels: its stages' and the overlap's heavy kernel
    for src in [wl.STREAM_HEAVY_SRC] + [src for _, src in STAGE_SRCS]:
        for kdef in lang.parse_kernels(src):
            programs.setdefault(kdef.name, kdef)
    for name, kdef in programs.items():
        reason = cuda_backend.unsupported_reason(kdef)
        if reason is not None:
            raise RuntimeError(f"{name} is outside the emitter subset: {reason}")
        jobs[f"emit:{name}"] = (cuda_backend.emit_source(kdef), f"ck_{name}")
    f32, bf16 = torch.float32, torch.bfloat16
    for label, fn, dt in (("saxpy f32", lambda x, y: y + ALPHA * x, f32),
                          ("saxpy bf16", lambda x, y: y + ALPHA * x, bf16),
                          ("maximum f32", torch.maximum, f32), ("chain f32", chain, f32)):
        jobs[f"elementwise:{label}"] = (ew_op.kernel_source(fn, (dt, dt)), "elementwise")
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

    # streamAdd and saxpy: 2^24 floats (3 x 64 MiB, beyond the 50 MB L2), the
    # rows of the kernels line, and 2^20 (held in L2); both on the streaming form
    for log2 in (24, 20):
        got = check_emitter_stream(cuda_backend, emitted, dev, 1 << log2)
        if log2 == 24:
            rows.update(got)

    # mandelbrot 2048 x 2048, max_iter 256 (C-subset kernel and hand kernel)
    W = H = 2048
    iters = 256
    npx = W * H
    vals = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, iters)
    kfn, pfn = emitted("mandelbrot", npx)
    o_k, o_p = torch.zeros(npx, device=dev), torch.zeros(npx, device=dev)
    cuda_backend.FORMS.reset()
    kfn(0, (o_k,), vals)
    pfn(0, (o_p,), vals)
    torch.cuda.synchronize()
    gate_forms(dict(cuda_backend.FORMS.by_key), {"mandelbrot": "escape"})
    err = float((o_k - o_p).abs().max())
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"mandelbrot C-subset kernel vs plain: max abs err {err}")
    counts = o_p.cpu().numpy()
    escapes = float(counts.astype(np.float64).sum())
    bound, bound_by = mandel_bound(counts, iters)
    ms, event_ms = kernel_ms(lambda: kfn(0, (o_k,), vals), "ck_kernel", 10)
    rows["emitter:mandelbrot"] = dict(
        max_abs_err=err, ms=ms, event_ms=event_ms,
        plain_ms=cuda_ms(lambda: pfn(0, (o_p,), vals), 1, warmup=0),
        library_ms=None, bound_ms=bound, bound_by=bound_by,
        escape_sum=escapes, escaped=int((counts < iters).sum()))

    # the hand kernel at offsets {0, 128 k} and chunk sizes from the ladder, at
    # max_iter values off its group of passes (mandel_op.GROUP), and over a view
    # whose outer pixels escape at once and run on to inf and NaN
    worst = 0.0
    grp = mandel_op.GROUP
    cases = [(npx, vals, off, cnt) for off, cnt in (
        (0, npx), (128 * 3, 1 << 20), (128 * 1001, 1 << 16), (npx - (1 << 14), 1 << 14),
        (128 * 77, 256))]
    cases += [(512 * 512, (-2.0, -1.25, 2.5 / 512, 2.5 / 512, 512, it), 0, 512 * 512)
              for it in (1, grp - 1, grp + 1, 61)]
    cases += [(512 * 512, (-40.0, -30.0, 0.125, 0.125, 512, it), 640, 4096)
              for it in (grp - 1, grp + 1, 61)]
    for size, hv, off, cnt in cases:
        h_k, h_p = torch.zeros(size, device=dev), torch.zeros(size, device=dev)
        mandel_op.mandelbrot(h_k, off, cnt, *hv)
        mandel_op.mandelbrot_plain(h_p, off, cnt, *hv)
        torch.cuda.synchronize()
        worst = max(worst, float((h_k - h_p).abs().max()))
        if not torch.equal(h_k, h_p):
            raise AssertionError(f"mandelbrot hand kernel vs plain at {hv}, {cnt}@{off}: "
                                 f"max abs err {worst}")
    h_k, h_p = torch.zeros(npx, device=dev), o_p
    ms, event_ms = kernel_ms(lambda: mandel_op.mandelbrot(h_k, 0, npx, *vals),
                             "mandelbrot_kernel", 10)
    if not torch.equal(h_k, o_p):
        raise AssertionError("mandelbrot hand kernel's timed image differs from the plain one")
    rows["mandelbrot"] = dict(
        max_abs_err=worst, ms=ms, event_ms=event_ms,
        plain_ms=cuda_ms(lambda: mandel_op.mandelbrot_plain(h_p, 0, npx, *vals), 1,
                         warmup=0),
        library_ms=None, bound_ms=bound, bound_by=bound_by)
    print(f"mandelbrot 2048x2048x256: escape sum {escapes:.0f}, "
          f"{rows['emitter:mandelbrot']['escaped']} pixels escaped; bound {bound:.4f} ms "
          f"({bound_by}); emitted (escape form) {rows['emitter:mandelbrot']['ms']:.4f} ms, "
          f"hand kernel (groups of {grp}) {ms:.4f} ms by the profiler, bit-exact")
    # the main path's readback: one image, card -> page-locked host memory
    pinned = torch.empty(npx, pin_memory=True)
    d2h_ms = cuda_ms(lambda: pinned.copy_(h_k, non_blocking=True), 20)
    print(f"D2H of one {W}x{H} f32 image ({4 * npx} B) into pinned memory: {d2h_ms:.4f} ms "
          f"({4 * npx / d2h_ms / 1e6:.1f} GB/s)")
    del o_k, o_p, h_k, h_p, pinned

    # n-body at n = 8192, on the emitter's loop form, bit for bit: the plain
    # version sums in the same j order and both round sqrt and / as IEEE does
    nb = 8192
    rng = np.random.default_rng(42)
    pos = [torch.from_numpy(((rng.random(nb, dtype=np.float32) - 0.5) * 2.0)).to(dev)
           for _ in range(3)]
    kfn, pfn = emitted("nBody", nb)
    v_k = [torch.zeros(nb, device=dev) for _ in range(3)]
    v_p = [torch.zeros(nb, device=dev) for _ in range(3)]
    cuda_backend.FORMS.reset()
    kfn(0, (*pos, *v_k), (nb, 0.0001))
    t0 = time.perf_counter()
    pfn(0, (*pos, *v_p), (nb, 0.0001))
    torch.cuda.synchronize()
    nbody_plain_ms = (time.perf_counter() - t0) * 1e3
    gate_forms(dict(cuda_backend.FORMS.by_key), {"nBody": "loop"})
    err = max(float((k - p).abs().max()) for k, p in zip(v_k, v_p))
    if not all(torch.equal(k, p) for k, p in zip(v_k, v_p)):
        raise AssertionError(f"emitted nBody at {nb} vs plain: not bit-exact, max abs err {err}")
    ms, event_ms = kernel_ms(lambda: kfn(0, (*pos, *v_k), (nb, 0.0001)), "ck_kernel", 10)
    torch_ops_ms = cuda_ms(lambda: nbody_op.nbody_accels(*pos, *pos), 5)
    bound, bound_by = nbody_bound(nb)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows["emitter:nBody"] = dict(
        max_abs_err=err, ms=ms, event_ms=event_ms,
        plain_ms=nbody_plain_ms, library_ms=None, torch_ops_ms=torch_ops_ms,
        bound_ms=bound, bound_by=bound_by)
    print(f"emitted nBody n={nb} (loop form, {cuda_backend.loop_threads(nb, sms)}-thread CTAs "
          f"on {sms} SMs): kernel {ms:.4f} ms (CUDA events {event_ms:.4f} ms), bound "
          f"{bound:.4f} ms ({bound_by}), ops.nbody.nbody_accels (several PyTorch calls) "
          f"{torch_ops_ms:.4f} ms, plain {nbody_plain_ms:.4f} ms, bit-exact")
    del pos, v_k, v_p
    rows["elementwise"] = check_elementwise(ew_op)
    rows["flash_attention"] = check_flash(fa_op, dev)
    rows["flash_attention_bwd_dq"], rows["flash_attention_bwd_dkv"] = check_flash_bwd(fa_op, dev)
    for name, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        ev = f" (CUDA events {r['event_ms']:.4f} ms)" if "event_ms" in r else ""
        print(f"{name:20s} kernel {r['ms']:.4f} ms{ev}  plain {r['plain_ms']:.4f} ms  "
              f"library {lib} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"max_abs_err {r['max_abs_err']}")

    phase("main path (GPU lane)")
    from cekirdekler_tpu_torch.core import cores as cores_mod

    gpus = ck.all_devices().gpus()
    ref_img = wl.mandelbrot_host(W, H, -2.0, -1.25, 2.5 / W, 2.5 / H, iters)
    cuda_backend.LAUNCHES.reset()
    cuda_backend.FORMS.reset()
    mandel_op.LAUNCHES.reset()
    registry.reset_launch_counts()
    cores_mod.STREAMED.reset()
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
        x.next_param(y).compute(cr, 7004, "saxpy", 1 << 24, 256, values=(ALPHA,))
    if not np.array_equal(y.host(), np.float32(ALPHA) * x.host() + np.float32(1.0)):
        raise AssertionError("saxpy through compute() mismatch")
    counts = dict(cuda_backend.LAUNCHES.by_key)
    counts["mandelbrot.cu"] = mandel_op.LAUNCHES.count
    routes = dict(registry.launch_counts)
    forms = dict(cuda_backend.FORMS.by_key)
    print(f"launch counts on the main path: {counts}; routes {routes}; emitter forms {forms}; "
          f"streamed lane phases {dict(cores_mod.STREAMED.by_key)}")
    for name in ("mandelbrot", "nBody", "streamAdd", "saxpy", "mandelbrot.cu"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    gate_forms(forms, {"streamAdd": "stream", "saxpy": "stream", "mandelbrot": "escape",
                       "nBody": "loop"})
    if routes["torch"] != 0 or routes["cuda"] <= 0:
        raise AssertionError(f"main path left the CUDA route: {routes}")
    rows["emitter:mandelbrot"]["launches"] = counts["mandelbrot"]
    rows["emitter:nBody"]["launches"] = counts["nBody"]
    rows["emitter:streamAdd"]["launches"] = counts["streamAdd"]
    rows["emitter:saxpy"]["launches"] = counts["saxpy"]
    rows["mandelbrot"]["launches"] = counts["mandelbrot.cu"]

    phase("enqueue saxpy through compute() (GPU lane)")
    rows["elementwise"]["launches"] = check_enqueue_saxpy(ck, wl, ew_op, gpus, registry, graphs,
                                                          rows["elementwise"]["ms"])

    phase("enqueue mandelbrot, readback='final' (GPU lane)")
    for counter in (cuda_backend.LAUNCHES, mandel_op.LAUNCHES):
        counter.reset()
    registry.reset_launch_counts()
    res.update(check_enqueue_mandelbrot(ck, wl, gpus, card, ref_img))
    seen = (cuda_backend.LAUNCHES.by_key.get("mandelbrot", 0), mandel_op.LAUNCHES.count,
            dict(registry.launch_counts))
    print(f"launch counts (emitted mandelbrot, mandelbrot.cu, routes): {seen}")
    if not (seen[0] > 0 and seen[1] > 0 and seen[2]["torch"] == 0):
        raise AssertionError(f"enqueue mandelbrot left the kernels: {seen}")
    res.update(check_mandelbrot_sync12(ck, wl, gpus, card, ref_img))

    phase("fused dispatch (GPU lane)")
    mods = (registry, graphs, cuda_backend, mandel_op, ew_op)
    check_fused(ck, wl, gpus, mods, ref_img)
    check_repeat(ck, wl, gpus, mods)

    phase("enqueue mode on a GPU + host lane")
    cuda_backend.LAUNCHES.reset()
    ew_op.LAUNCHES.reset()
    ew_op.PLAIN_RUNS.reset()
    check_enqueue_mixed(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1))
    seen = (cuda_backend.LAUNCHES.by_key.get("mandelbrot", 0), ew_op.LAUNCHES.count,
            dict(ew_op.PLAIN_RUNS.by_key))
    print(f"launch counts (emitted mandelbrot, elementwise, elementwise plain runs): {seen}")
    if not (seen[0] > 0 and seen[1] > 0 and "cuda" not in seen[2]):
        raise AssertionError(f"GPU + host enqueue mode left the kernels on the GPU lane: {seen}")

    phase("hooks on the card (GPU + host lane)")
    cuda_backend.LAUNCHES.reset()
    check_hooks(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1), W, H, iters, ref_img)
    if cuda_backend.LAUNCHES.by_key.get("mandelbrot", 0) <= 0:
        raise AssertionError("hooks phase: the emitted mandelbrot never launched")

    phase("balancer (GPU + host lane)")
    check_balancer(ck, wl, gpus.subset(1) + ck.all_devices().cpus(1),
                   [rate_prior(kind), rate_prior("cpu")])

    phase("device selection")
    check_devices(ck, wl, gpus, mods)

    phase("streamed transfers (GPU lane)")
    stream_res = check_streamed(ck, wl, gpus, mods, ref_img)

    phase("n-body end to end (two partition lanes)")
    check_nbody_e2e(wl, gpus, mods)

    phase("no_compute_mode (GPU lane)")
    check_no_compute(ck, wl, gpus, mods)

    phase("pipelines (GPU lane, host lanes)")
    pipe_res = check_pipelines(ck, wl, gpus, mods, ref_img, card)
    rows["emitter:streamAdd"]["pipeline_launches"] = pipe_res["stream"]["launches"]
    rows["emitter:mandelbrot"]["pipeline_launches"] = pipe_res["mandelbrot"]["launches"]["emitted"]
    rows["mandelbrot"]["pipeline_launches"] = pipe_res["mandelbrot"]["launches"]["hand kernel"]

    phase("health, drain and device trace")
    health_res = check_health_drain(ck, wl, gpus[0].as_partitions(2), ref_img)
    trace_res = check_device_trace(ck, wl, gpus.subset(1), ref_img)
    rows["emitter:mandelbrot"]["trace_ms"] = trace_res["trace_ms"]
    health_res.update(trace_res, **check_nbody_attribution(wl, gpus))
    print(f"emitted mandelbrot 2048x2048x256: device ms a launch by the capture's trace "
          f"{trace_res['trace_ms']:.4f}, by CUDA events {rows['emitter:mandelbrot']['event_ms']:.4f}, "
          f"by the profiler (kernels phase) {rows['emitter:mandelbrot']['ms']:.4f}")

    phase("verify gate, checkpoint, debug server")
    verify_res = check_verify_gate(ck, wl, gpus, mods, ref_img)
    debug_res = check_debug_server(ck, wl, gpus, ref_img)
    ckpt_res = check_checkpoint(wl, fa_op, card)

    phase("5i compile cache")
    cache_res = check_compile_cache(ck, wl, gpus, programs, ref_img, card)

    phase("5j markers and user events")
    markers_res = check_markers(ck, wl, gpus, mods, ref_img, card)
    rows["emitter:mandelbrot"]["marker_launches"] = markers_res["main_path"]["launch_markers"]
    rows["emitter:streamAdd"]["marker_launches"] = markers_res["gate"]["launch_markers"]
    rows["mandelbrot"]["marker_launches"] = markers_res["pool"]["gpu_launches"]

    phase("5k cluster tier across processes")
    cluster_res = check_cluster(ck, wl, gpus, mods, ref_img, card)
    rows["emitter:mandelbrot"]["cluster_launches"] = cluster_res["launches"]

    phase("transformer forward")
    rows["flash_attention"]["launches"] = check_transformer(wl, fa_op, card)

    phase("transformer train")
    (rows["flash_attention_bwd_dq"]["launches"],
     rows["flash_attention_bwd_dkv"]["launches"]) = check_training(wl, fa_op, card)

    phase("ring attention (sp mesh of virtual shards)")
    rows.update(check_ring_parts(fa_op, dev))
    ring_launches = check_ring(wl, fa_op, par, dev, card)
    rows["flash_attention_parts"]["launches"] = ring_launches["fwd"]
    rows["flash_attention_bwd_parts_dq"]["launches"] = ring_launches["dq"]
    rows["flash_attention_bwd_parts_dkv"]["launches"] = ring_launches["dkv"]

    phase("summary")
    meta = {
        "emitter:streamAdd": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:saxpy": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:mandelbrot": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "emitter:nBody": ("cuda", EMITTER_SOURCE, EMITTER_REPLACES),
        "mandelbrot": ("cuda", "cekirdekler_tpu_torch/csrc/mandelbrot.cu",
                       "cekirdekler_tpu/ops/mandelbrot.py:81"),
        "elementwise": ("cuda", "cekirdekler_tpu_torch/csrc/elementwise.cu",
                        "cekirdekler_tpu/ops/elementwise.py:27"),
        "flash_attention": ("cuda", "cekirdekler_tpu_torch/csrc/flash_attention_tc.cu",
                            "cekirdekler_tpu/ops/flash_attention.py:351"),
        "flash_attention_bwd_dq": ("cuda",
                                   "cekirdekler_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                   "cekirdekler_tpu/ops/flash_attention.py:661"),
        "flash_attention_bwd_dkv": ("cuda",
                                    "cekirdekler_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                    "cekirdekler_tpu/ops/flash_attention.py:661"),
        "flash_attention_parts": (
            "cuda", "cekirdekler_tpu_torch/csrc/flash_attention_parts_tc.cu",
            "cekirdekler_tpu/ops/flash_attention.py:420"),
        "flash_attention_bwd_parts_dq": (
            "cuda", "cekirdekler_tpu_torch/csrc/flash_attention_parts_tc.cu",
            "cekirdekler_tpu/ops/flash_attention.py:745"),
        "flash_attention_bwd_parts_dkv": (
            "cuda", "cekirdekler_tpu_torch/csrc/flash_attention_parts_tc.cu",
            "cekirdekler_tpu/ops/flash_attention.py:745"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        rr = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": rr["launches"], "max_abs_err": rr["max_abs_err"],
            "ms": rr["ms"], "plain_ms": rr["plain_ms"], "bound_ms": rr["bound_ms"],
            "bound_by": rr["bound_by"], "library_ms": rr["library_ms"],
            **{key: rr[key] for key in ("kernel_route", "fp32_ms", "fp32_bound_ms", "torch_ops_ms",
                                        "pipeline_launches", "event_ms", "trace_ms",
                                        "marker_launches", "cluster_launches")
               if key in rr},
        })
    print(f"mpixels_per_sec: {json.dumps(res)}; streamed against monolithic: "
          f"{json.dumps(stream_res)}; pipelines: {json.dumps(pipe_res)}; total "
          f"{time.perf_counter() - t_all:.1f} s")
    print(f"profiler records found lost and read at their kernel's mean: {trace_window.lost}; "
          f"traces taken again for a garbled record or more lost: {len(trace_window.defects)}")
    for defect in trace_window.defects:
        print(f"  taken again: {defect}")
    from cekirdekler_tpu_torch.metrics.registry import REGISTRY

    print(f"health, drain and device trace: {json.dumps(health_res)}")
    print(f"drains and readmits by phase (what ck_drain_total and ck_drain_readmit_total "
          f"count): {json.dumps(DRAINS)}; ck_drain_total now "
          f"{REGISTRY.counter('ck_drain_total').value}")
    for row in DRAIN_ROWS:
        print(f"  drain decision rows: {json.dumps(row)}")
    print(f"verify gate, checkpoint, debug server: {json.dumps({'verify': verify_res, 'checkpoint': {k: ckpt_res[k] for k in ('leaves', 'bf16_leaves', 'moments', 'max_rel')}, 'debug': {k: debug_res[k] for k in ('lane_series', 'decision_kinds', 'profilez_rows')}})}")
    print(f"compile cache: {json.dumps(cache_res)}")
    print(f"markers and user events: {json.dumps({k: markers_res[k] for k in ('gate', 'pool', 'overhead', 'seconds')})}")
    print(f"cluster tier: {json.dumps(cluster_res)}")
    print(f"phase seconds: {json.dumps(phase_seconds())}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
