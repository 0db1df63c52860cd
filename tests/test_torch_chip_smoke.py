"""The balancer gate, the flash bounds and the enqueue gates of
``chip_smoke.py`` on the CPU.

``chip_smoke.check_balancer`` needs the card; what it decides from a run's
range trajectory does not.  ``tail_moves`` is held against hand-made
trajectories, and the gate against the modelled mixed fleet of
``tests/test_torch_balance.py``: the port's balancer passes it, and the
same balancer with its drain slowed (damping pinned at 0.02, no undamped
jump) fails it, although ``workloads._converged_at`` calls both settled.
The enqueue phases' gates run their phases on host lanes at a small size:
they pass the port, and fail a modelled premature D2H (a barrier that
reads back) and a modelled lost update (a move without the flush).
Phase 5h's gates run on host lanes too: the planted stencil (and its gate
failing once the halo is gone), a checkpoint resume at a small width, and
the debug server scraped during a workload (and its gate failing on a
/servez that answers or a port that still answers after close).
Phase 5i's gates: warmup then the first windows on a host lane (and the
gate failing once warmup builds nothing), and the coldstart trio's gate
over hand-made trios (refusing a warm child that compiled, an inexact
trio, a missing library and the rest).
Phase 5j's gates: the markers on the main path, the gated compute and the
throttled pool pass on host lanes; each fails on a planted fault (a lost
reach leaving markers after the drain, markers reached at issue, a gate
whose wait returns at once, a depth over the pool's bound), and phase
(b)'s measure runs over a marker that a future retires later.
Phase 5k's gates: the TCP tier's run on host lanes (a server in this
process, the mainframe a host lane) and the two DCN jobs on host lanes
pass; hand-made runs fail them (a pixel no node wrote, a dropped node, a
balancer that never moved, a lost rank, a merged trace without a rank's
spans, a 64-bit value that did not cross, a rejoined image off the
undisturbed one), the server child refuses to start without a card, and
``wire_bytes`` counts what ``send_message`` frames.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from cekirdekler_tpu_torch.core import balance
from cekirdekler_tpu_torch.core.worker import _ladder
from cekirdekler_tpu_torch.workloads import _converged_at

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _split(host_steps: list[int], step: int = 1024, total: int = 1 << 20) -> list[list[int]]:
    return [[total - h * step, h * step] for h in host_steps]


@pytest.mark.parametrize("host_steps, want", [
    ([15, 4, 2] + [2] * 77, (0, 0, 78)),                 # settled early, held
    ([15, 2] + [2] * 59 + [1] * 19, (1, 1, 19)),          # one late step down
    ([15, 2] + [2] * 76 + [1, 2], (2, 1, 1)),             # down and back up
    ([15] + [6] * 60 + [5, 4, 4, 3, 3, 2] + [2] * 13, (4, 4, 14)),  # still draining
    ([2] * 60 + [3, 2] * 10, (19, 1, 1)),                 # a cycle of one step
])
def test_tail_moves(host_steps, want):
    """Moves, steps spanned by the host lane and calls held over the last 20."""
    moves, span, held = chip_smoke.tail_moves(_split(host_steps), 20)
    assert (moves, span // 1024, held) == want


def _modelled_run(step: int, seed: int, jump_start: bool) -> list[list[int]]:
    """80 calls of the modelled GPU + host-lane fleet (the lane-wall shape
    measured on the card) through the port's balancer."""
    rng = np.random.default_rng(9000 + seed)
    total = 1024 * 1024
    ranges = balance.prior_split(total, step, [67.0, 1.0])
    hist, state = balance.BalanceHistory(weighted=True), balance.BalanceState()
    trajectory = [ranges]
    for _ in range(chip_smoke.BALANCE_ITERS - 1):
        host = ranges[1]
        bench = [1.0 * float(rng.uniform(0.9, 1.1)),
                 (0.5 + 1.0 * len(_ladder(host, step)) + 4e-5 * host)
                 * float(rng.uniform(0.9, 1.1))]
        ranges = balance.load_balance(bench, ranges, total, step, hist, state=state,
                                      jump_start=jump_start)
        trajectory.append(ranges)
    return trajectory


def _still(trajectory: list[list[int]], step: int) -> bool:
    moves, span, _ = chip_smoke.tail_moves(trajectory, chip_smoke.BALANCE_HOLD)
    return moves <= 1 and span <= step


@pytest.mark.parametrize("step", chip_smoke.BALANCE_STEPS)
def test_gate_passes_the_modelled_fleet(step):
    """Every one of ``BALANCE_REPS`` modelled runs settles and is still."""
    runs = [_modelled_run(step, seed, jump_start=True) for seed in range(chip_smoke.BALANCE_REPS)]
    assert all(_converged_at(t, step) is not None for t in runs)
    assert sum(_still(t, step) for t in runs) >= chip_smoke.BALANCE_MIN_STILL


@pytest.mark.parametrize("step", chip_smoke.BALANCE_STEPS)
def test_gate_fails_a_slowed_drain(step, monkeypatch):
    """Damping pinned at 0.02 and no undamped jump: the host lane is still
    draining one step at a time at call 80.  ``_converged_at`` calls every
    run settled; the count of still runs fails the gate."""
    for name in ("DAMP_MIN", "DAMP_MAX", "DAMP_MAX_SMOOTHED"):
        monkeypatch.setattr(balance, name, 0.02)
    runs = [_modelled_run(step, seed, jump_start=False)
            for seed in range(chip_smoke.BALANCE_REPS)]
    assert all(_converged_at(t, step) is not None for t in runs)
    assert sum(_still(t, step) for t in runs) < chip_smoke.BALANCE_MIN_STILL


@pytest.mark.parametrize("causal, ops_per_d, tensors, want_gflop, want_mb", [
    (True, 10, 8, 42.97, 67.63),    # the whole backward: q, k, v, o, dO, dq, dk, dv
    (True, 6, 5, 25.78, 42.47),     # the dq kernel's function
    (True, 8, 6, 34.38, 50.86),     # the dk/dv kernel's function
    (False, 10, 8, 85.90, 67.63),
])
def test_flash_bwd_bound_counts(causal, ops_per_d, tensors, want_gflop, want_mb):
    """At the model's shapes (4x2048x8x64, bf16) the backward is bound by
    its operations: ``ops_per_d * D`` per live (query, key) pair and head
    at 989 TFLOP/s, against the bytes of ``tensors`` bf16 tensors plus the
    f32 lse and delta at 3.35 TB/s."""
    import torch

    ms, by = chip_smoke.flash_bwd_bound(4, 2048, 8, 64, causal, torch.bfloat16, ops_per_d,
                                        tensors)
    assert by == "operations"
    assert ms == pytest.approx(want_gflop * 1e9 / chip_smoke.BF16_OPS_PER_S * 1e3, rel=1e-3)
    by_bytes = want_mb * 1e6 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert ms > by_bytes
    f32_ms, f32_by = chip_smoke.flash_bwd_bound(4, 2048, 8, 64, causal, torch.float32,
                                                ops_per_d, tensors)
    assert f32_by == "operations"
    assert f32_ms == pytest.approx(ms * chip_smoke.BF16_OPS_PER_S / chip_smoke.FP32_OPS_PER_S)


def test_flash_bwd_bound_of_a_short_sequence_is_bytes():
    """At T=16 a pair costs too few operations: the bytes bind."""
    import torch

    ms, by = chip_smoke.flash_bwd_bound(4, 16, 8, 64, True, torch.bfloat16)
    assert by == "bytes"
    nbytes = 2 * 8 * 4 * 16 * 8 * 64 + 2 * 4 * 4 * 8 * 16
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


# -- the enqueue phases' gates, on host lanes ------------------------------

def _lanes(n: int):
    import cekirdekler_tpu_torch as ck

    return ck.all_devices().cpus(n)


def test_enqueue_saxpy_passes_its_gates_on_one_lane():
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    run = chip_smoke.enqueue_saxpy(ck, wl, _lanes(1), 1 << 12, 16)
    chip_smoke.gate_single_lane_transfers(run)
    chip_smoke.gate_exact(run["y"], run["want"], "y")


def test_the_transfer_gate_fails_on_a_premature_d2h(monkeypatch):
    """A barrier that reads ``y`` back early (a modelled premature D2H)."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.cores import Cores

    barrier = Cores.barrier

    def reading_barrier(self):
        self.flush()
        barrier(self)

    monkeypatch.setattr(Cores, "barrier", reading_barrier)
    run = chip_smoke.enqueue_saxpy(ck, wl, _lanes(1), 1 << 12, 16)
    chip_smoke.gate_exact(run["y"], run["want"], "y")
    with pytest.raises(AssertionError, match="before the flush"):
        chip_smoke.gate_single_lane_transfers(run)


def _moving_run(monkeypatch):
    """The saxpy phase on two host lanes whose lane 0 retires late at every
    barrier, so ranges move."""
    import time

    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.worker import Worker

    fence = Worker.fence

    def late(self):
        fence(self)
        if self.index == 0:
            time.sleep(0.03)

    monkeypatch.setattr(Worker, "fence", late)
    return chip_smoke.enqueue_saxpy(ck, wl, _lanes(2), 1 << 14, 16, sync_every=4)


def test_the_mixed_fleet_gates_pass_a_moving_run(monkeypatch):
    run = _moving_run(monkeypatch)
    assert chip_smoke.gate_moves(run["ranges"], 4) >= 1
    chip_smoke.gate_exact(run["y"], run["want"], "y")


def test_the_exactness_gate_fails_on_a_modelled_lost_update(monkeypatch):
    """A move that resets upload coverage without landing the deferred
    readbacks first: the lane that takes over a region re-uploads a stale
    host copy, and ``y`` loses those updates."""
    from cekirdekler_tpu_torch.core.cores import Cores

    def reset_only(self):
        for w in self.workers:
            w.reset_coverage()

    monkeypatch.setattr(Cores, "_flush_and_reset_coverage", reset_only)
    run = _moving_run(monkeypatch)
    assert chip_smoke.gate_moves(run["ranges"], 4) >= 1
    with pytest.raises(AssertionError, match="differs from its reference"):
        chip_smoke.gate_exact(run["y"], run["want"], "y")


@pytest.mark.parametrize("ranges, moves", [
    ([[8, 8]] * 4 + [[6, 10]] * 4 + [[4, 12]] * 4, 2),
    ([[8, 8]] * 12, 0),
])
def test_gate_moves_counts_moves_after_barriers(ranges, moves):
    assert chip_smoke.gate_moves(ranges, 4) == moves


def test_gate_moves_fails_a_move_between_barriers():
    with pytest.raises(AssertionError, match="between barriers at calls \\[5\\]"):
        chip_smoke.gate_moves([[8, 8]] * 5 + [[6, 10]] * 3, 4)


# -- the ring phase's bounds and launch gate ---------------------------------

@pytest.mark.parametrize("q_pos0, k_pos0, causal, want", [
    (6144, 6144, True, 2048 * 2049 // 2),   # the diagonal step
    (10240, 4096, True, 2048 * 2048),       # a step fully below it
    (2048, 6144, True, 0),                  # a dead step
    (8, 40, True, sum(max(0, min(2048, i - 31)) for i in range(2048))),  # off the tiles
    (2048, 6144, False, 2048 * 2048),       # no mask, no dead step
])
def test_live_pairs(q_pos0, k_pos0, causal, want):
    assert chip_smoke.live_pairs(2048, 2048, q_pos0, k_pos0, causal) == want


@pytest.mark.parametrize("kind, ops_per_d, in_tensors, out_f32", [
    ("fwd", 4, 3, "acc, m, l"),
    ("dq", 6, 4, "dq"),
    ("dkv", 8, 4, "dk, dv"),
])
def test_parts_bound_counts(kind, ops_per_d, in_tensors, out_f32):
    """A full ring step of the full-width run (1x2048 against 1x2048,
    H=8, D=64, bf16 in, "highest") is bound by its operations at the FP32
    peak: ``ops_per_d * D`` per pair and head, 33.55 M pairs; a dead step,
    which has no pair, by its bytes."""
    ms, by = chip_smoke.parts_bound(kind, 1, 2048, 2048, 8, 64, 10240, 4096, True, 2)
    assert by == "operations"
    ops = ops_per_d * 64 * 8 * 2048 * 2048
    assert ms == pytest.approx(ops / chip_smoke.FP32_OPS_PER_S * 1e3)
    el, rows = 2048 * 8 * 64, 2048 * 8
    outs = {"fwd": el + 2 * rows, "dq": el, "dkv": 2 * el}[kind]
    lse_delta = 0 if kind == "fwd" else 2 * rows
    nbytes = 2 * in_tensors * el + 4 * (outs + lse_delta)
    dead_ms, dead_by = chip_smoke.parts_bound(kind, 1, 2048, 2048, 8, 64, 2048, 6144, True, 2)
    assert dead_by == "bytes"
    assert dead_ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    diag, _ = chip_smoke.parts_bound(kind, 1, 2048, 2048, 8, 64, 6144, 6144, True, 2)
    assert diag == pytest.approx(ms * 2049 / 4096)


@pytest.mark.parametrize("kind, ops_per_d, want_ms",
                         [("fwd", 8, 0.0174), ("dq", 10, 0.0217), ("dkv", 16, 0.0347)])
def test_parts_bound_of_the_split_kernels(kind, ops_per_d, want_ms):
    """On the split tensor-core route (``tc3``) a full ring step counts the
    split's tensor-core work, ``ops_per_d * D`` per pair and head (q.k once
    and p.v three times; s and dp once and ds.K three times; sT and dpT
    once, pT.dO and dsT.Q three times each), at the bf16 peak: 0.0174 ms
    forward, 0.0217 ms dq and 0.0347 ms dk/dv, against the FP32 bounds of
    0.128, 0.192 and 0.256 ms."""
    ms, by = chip_smoke.parts_bound(kind, 1, 2048, 2048, 8, 64, 10240, 4096, True, 2, "tc3")
    assert by == "operations"
    ops = ops_per_d * 64 * 8 * 2048 * 2048
    assert ms == pytest.approx(ops / chip_smoke.BF16_OPS_PER_S * 1e3)
    assert ms == pytest.approx(want_ms, abs=5e-5)
    fp32, _ = chip_smoke.parts_bound(kind, 1, 2048, 2048, 8, 64, 10240, 4096, True, 2)
    assert fp32 == pytest.approx({"fwd": 0.1282, "dq": 0.1923, "dkv": 0.2564}[kind], abs=5e-5)


def _ring_launches(n=8, parts=64, dead=28, plain=0, plain_bwd=0):
    kinds = ("fwd", "dq", "dkv")
    return {"parts": dict.fromkeys(kinds, parts), "dead": dict.fromkeys(kinds, dead),
            "plain_flash": {"cuda": plain} if plain else {"cpu": 3},
            "plain_flash_bwd": {"cuda": plain_bwd} if plain_bwd else {}}


def test_gate_ring_launches_passes_the_ring():
    assert chip_smoke.gate_ring_launches(_ring_launches(), 8, True) == \
        {"fwd": 64, "dq": 64, "dkv": 64}
    full = _ring_launches(n=4, parts=16)
    full["dead"] = {}
    assert chip_smoke.gate_ring_launches(full, 4, False)["fwd"] == 16


@pytest.mark.parametrize("bad", [
    dict(parts=63),             # a step that did not launch
    dict(dead=27),              # a dead step counted live
    dict(plain=1),              # the plain version ran on the card
    dict(plain_bwd=8),          # the plain backward ran on the card
])
def test_gate_ring_launches_fails(bad):
    with pytest.raises(AssertionError, match="ring launch counts"):
        chip_smoke.gate_ring_launches(_ring_launches(**bad), 8, True)


def test_gate_forms_passes_the_main_path():
    forms = {("streamAdd", "stream"): 3, ("saxpy", "stream"): 1, ("mandelbrot", "escape"): 14,
             ("nBody", "loop"): 10}
    chip_smoke.gate_forms(forms, {"streamAdd": "stream", "saxpy": "stream",
                                  "mandelbrot": "escape", "nBody": "loop"})


@pytest.mark.parametrize("forms", [
    {("mandelbrot", "escape"): 13, ("mandelbrot", "item"): 1},   # one launch on the item form
    {("mandelbrot", "item"): 14},                                # never on the escape form
    {},
], ids=["one-item", "item-only", "none"])
def test_gate_forms_holds_mandelbrot_to_the_escape_form(forms):
    with pytest.raises(AssertionError, match="escape form only"):
        chip_smoke.gate_forms(forms, {"mandelbrot": "escape"})


def test_mandel_bound_counts_fp32_pipe_instructions_a_pass_and_an_exit():
    """8 FP32-pipe instructions a pass and 3 for each escaped pixel's
    failing test, at 132 x 128 lanes x 1.98 GHz; at the main path's
    2048x2048x256 (escape sum 282,894,696 with 24.4% of the pixels at 256)
    that is about 0.068 ms, where the old count (10 operations a pass at
    67 TFLOP/s) gave 0.0422."""
    counts = np.array([0, 3, 256, 256, 17], dtype=np.float32)
    ms, by = chip_smoke.mandel_bound(counts, 256)
    assert by == "operations"
    assert ms == pytest.approx((8 * 532 + 3 * 3) / (132 * 128 * 1.98e9) * 1e3)
    full = 8 * 282_894_696 / (132 * 128 * 1.98e9) * 1e3
    assert 0.0676 < full < 0.0677
    ms, by = chip_smoke.mandel_bound(np.zeros(1 << 22, np.float32), 256)
    assert by == "bytes" and ms == pytest.approx(4.0 * (1 << 22) / 3.35e12 * 1e3)


@pytest.mark.parametrize("forms", [
    {("streamAdd", "stream"): 3, ("streamAdd", "item"): 1},  # one launch on the item form
    {("streamAdd", "item"): 3},                              # never on the streaming form
    {},                                                      # never launched
], ids=["mixed", "item-only", "none"])
def test_gate_forms_fails(forms):
    with pytest.raises(AssertionError, match="streaming|stream form"):
        chip_smoke.gate_forms(forms, {"streamAdd": "stream"})


@pytest.mark.parametrize("forms", [
    {("nBody", "loop"): 9, ("nBody", "item"): 1},   # one launch on the item form
    {("nBody", "item"): 10},                        # never on the loop form
    {("nBody", "loop"): 9, ("nBody", "stream"): 1},
], ids=["one-item", "item-only", "one-stream"])
def test_gate_forms_holds_nbody_to_the_loop_form(forms):
    with pytest.raises(AssertionError, match="loop form only"):
        chip_smoke.gate_forms(forms, {"nBody": "loop"})


def test_nbody_bound_counts_fp32_pipe_and_mufu_instructions():
    """n = 8192: 22 FP32-pipe instructions a pair at 132 x 128 lanes x
    1.98 GHz (0.0441 ms) bind it before its 2 MUFU ops at 16 a clock an
    SM (0.0321 ms) or its bytes."""
    ms, by = chip_smoke.nbody_bound(8192)
    assert by == "operations"
    assert ms == pytest.approx(8192 * 8192 * 22 / (132 * 128 * 1.98e9) * 1e3)
    assert 0.0441 < ms < 0.0442
    assert 8192 * 8192 * 2 / (132 * 16 * 1.98e9) * 1e3 < ms


# -- the streamed-transfer and no_compute_mode gates, on a host lane ----------------

def _mods():
    from cekirdekler_tpu_torch.kernel import cuda_backend, graphs, registry
    from cekirdekler_tpu_torch.ops import elementwise, mandelbrot

    return registry, graphs, cuda_backend, mandelbrot, elementwise


def _small_cases():
    """The streamed phase's cases at a host lane's size: a 64x64 image and
    4096-float streamAdd and saxpy, each with its arrays from a seed."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    w, n = 64, 4096
    vals = (-2.0, -1.25, 2.5 / w, 2.5 / w, w, 32)

    def image():
        return [ck.ClArray(w * w, np.float32, name="img", read=False, write=True)]

    def stream():
        rng = np.random.default_rng(3)
        return [ck.ClArray(rng.standard_normal(n).astype(np.float32), name=k,
                           partial_read=True, read_only=True) for k in "ab"] + [
            ck.ClArray(n, np.float32, name="c", write_only=True)]

    def saxpy():
        rng = np.random.default_rng(4)
        return [ck.ClArray(rng.standard_normal(n).astype(np.float32), name="x",
                           partial_read=True, read_only=True),
                ck.ClArray(rng.standard_normal(n).astype(np.float32), name="y",
                           partial_read=True)]

    img = wl.mandelbrot_host(w, w, *vals[:4], 32)
    return [(("emitted mandelbrot", wl.MANDELBROT_SRC, "mandelbrot", vals, image, w * w), img),
            (("emitted streamAdd", wl.STREAM_SRC, "streamAdd", (), stream, n), None),
            (("emitted saxpy", chip_smoke.SAXPY_SRC, "saxpy", (chip_smoke.ALPHA,), saxpy, n),
             None)]


@pytest.mark.parametrize("k", [0, 1, 2], ids=["mandelbrot", "streamAdd", "saxpy"])
def test_the_streamed_gate_passes_the_port_on_a_host_lane(k):
    import cekirdekler_tpu_torch as ck

    case, img = _small_cases()[k]
    chip_smoke.gate_streamed_case(ck, _lanes(1), _mods(), case, img, calls=3)


def test_the_streamed_gate_fails_on_a_lost_chunk(monkeypatch):
    """A D2H that skips each call's last chunk (a modelled race that lets
    a chunk's copy miss its data)."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch.core.worker import Worker

    copy = Worker.download_chunk_async

    def lossy(self, arr, off, n):
        if off + n == arr.size:
            return None
        return copy(self, arr, off, n)

    monkeypatch.setattr(Worker, "download_chunk_async", lossy)
    case, img = _small_cases()[1]
    with pytest.raises(AssertionError, match="against the monolithic run"):
        chip_smoke.gate_streamed_case(ck, _lanes(1), _mods(), case, img, calls=3)


def test_the_no_compute_gate_passes_the_port_and_fails_a_launch(monkeypatch):
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.cores import Cores

    chip_smoke.check_no_compute(ck, wl, _lanes(1), _mods())
    # a cruncher that forgets the mode launches, and the gate says so
    monkeypatch.setattr(Cores, "no_compute_mode", property(lambda self: False,
                                                           lambda self, v: None),
                        raising=False)
    with pytest.raises(AssertionError, match="no_compute_mode"):
        chip_smoke.check_no_compute(ck, wl, _lanes(1), _mods())


# -- the pipelines phase's gates, on host lanes -------------------------------

def test_the_pipelined_stream_gate_passes_the_port_on_a_host_lane():
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    for fast in (True, False):
        runs = chip_smoke.pipelined_stream_runs(ck, wl, _lanes(1), _mods(), fast, 1 << 13, 1)
        row = chip_smoke.gate_pipelined_stream(runs, "streamAdd", 1 << 13, on_card=False)
        assert set(row) == {"monolithic", "streamed", "EVENT L=1", "EVENT L=2", "EVENT L=4",
                            "DRIVER"}


def test_the_pipelined_stream_gate_fails_on_a_lost_blob(monkeypatch):
    """A write stage that skips each call's last blob (a modelled race that
    lets a blob's readback miss its data): ``c`` keeps the zeros the run
    started from there, and the gate against the monolithic run fails."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.worker import Worker

    copy = Worker.download_async

    def lossy(self, arr, off, n, full, **kw):
        if not full and off + n == arr.size:
            return None
        return copy(self, arr, off, n, full, **kw)

    monkeypatch.setattr(Worker, "download_async", lossy)
    runs = chip_smoke.pipelined_stream_runs(ck, wl, _lanes(1), _mods(), False, 1 << 13, 1)
    with pytest.raises(AssertionError, match="EVENT L=1, against the monolithic run"):
        chip_smoke.gate_pipelined_stream(runs, "streamAdd", 1 << 13, on_card=False)


def test_the_pipelined_stream_gate_fails_on_a_blob_lost_in_one_call_only(monkeypatch):
    """The race the gate looks for is intermittent: a write stage that
    skips the last blob's readback in the first pipelined call alone, so
    the run's last call is right again.  The gate holds every call to the
    monolithic run and fails on the first."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.worker import Worker

    copy = Worker.download_async
    lost = []

    def lossy_once(self, arr, off, n, full, **kw):
        if not full and off + n == arr.size and not lost:
            lost.append(off)
            return None
        return copy(self, arr, off, n, full, **kw)

    monkeypatch.setattr(Worker, "download_async", lossy_once)
    runs = chip_smoke.pipelined_stream_runs(ck, wl, _lanes(1), _mods(), False, 1 << 13, 2)
    assert lost
    np.testing.assert_array_equal(runs["EVENT L=1"]["out"], runs["want"])
    with pytest.raises(AssertionError, match="EVENT L=1, against the monolithic run: call 1 of 4"):
        chip_smoke.gate_pipelined_stream(runs, "streamAdd", 1 << 13, on_card=False)


@pytest.mark.parametrize("ranges, want", [
    ([[1 << 20]], [8]),                          # 8 blobs of one 2^17 chunk
    ([[3 << 11, 1 << 11]] * 2, [32, 16]),       # 768 = 512 + 256 a blob; 256
    ([[0, 1 << 12], [1 << 12, 0]], [8, 8]),      # a lane idle in a call
])
def test_blob_launches_count_each_blob_s_ladder(ranges, want):
    assert chip_smoke.blob_launches(ranges, 8, 256) == want


def _counts(emitted=0, hand=0, cuda=0, torch=0, python=0) -> dict:
    return {"emitted": {"mandelbrot": emitted} if emitted else {}, "mandelbrot.cu": hand,
            "routes": {"cuda": cuda, "torch": torch, "python": python}, "forms": {}}


@pytest.mark.parametrize("hand", [False, True], ids=["emitted", "hand kernel"])
def test_the_blob_launch_gate_fails_when_a_blob_counts_on_the_torch_route(hand):
    """24 blob launches on the GPU lane and 8 on a host lane pass; one GPU
    blob counted on the torch route fails, as does one that launched
    nothing."""
    gate = chip_smoke.gate_blob_launches
    if hand:
        good = _counts(hand=24, python=32)
        bad = [_counts(hand=23, python=32, torch=1), _counts(hand=23, python=31)]
    else:
        good = _counts(emitted=24, cuda=24, torch=8)
        bad = [_counts(emitted=23, cuda=23, torch=9), _counts(emitted=23, cuda=23, torch=8)]
    gate("mandelbrot", good, 24, 8, "mandelbrot", hand)
    for counts in bad:
        with pytest.raises(AssertionError, match="hand-written kernel"):
            gate("mandelbrot", counts, 24, 8, "mandelbrot", hand)


@pytest.mark.parametrize("handoff", ["snapshot", "bare-alias"])
def test_the_generations_gate_fails_on_a_clobbered_handoff(handoff, monkeypatch):
    """The three stages by ``feed_async`` on a host lane: the port's
    handoff passes; a bare alias of the producer's tensor (the reference's
    value move on the port's in-place launcher) hands a stage the next
    generation, and the gate fails."""
    from cekirdekler_tpu_torch.pipeline import DevicePipeline
    from cekirdekler_tpu_torch.pipeline import device_pipeline

    if handoff == "bare-alias":
        monkeypatch.setattr(device_pipeline, "_handoff",
                            lambda src, v, dst, slot: setattr(slot, "value", v))
    n = 1 << 10
    datas = chip_smoke.generation_data(n, 6)
    outs, _ = chip_smoke.run_generations(
        DevicePipeline.make(chip_smoke.pipeline_stages(n), _lanes(1)[0]), "feed_async", datas)
    if handoff == "snapshot":
        chip_smoke.gate_generations("feed_async", outs, datas)
    else:
        with pytest.raises(AssertionError, match="generation 0"):
            chip_smoke.gate_generations("feed_async", outs, datas)


def test_the_device_pool_phase_passes_on_host_lanes():
    """The pool phase at 128x128 in 16 tiles over three host lanes: the image
    exact, the pinned tiles on lane 0, the broadcast once a lane."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    w = 128
    ref = wl.mandelbrot_host(w, w, -2.0, -1.25, 2.5 / w, 2.5 / w, 256)
    res = chip_smoke.check_device_pool(ck, wl, _lanes(3), _mods(), ref, tiles=16)
    assert sum(res["done"]) == 15 + 3 and res["done"][0] >= 8


def test_the_pipelined_mandelbrot_phase_runs_on_host_fleets():
    """Phase (b) at 64x64 on a two-lane and a one-lane host fleet: every
    image exact, both routes, both fleets."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    w = 64
    ref = wl.mandelbrot_host(w, w, -2.0, -1.25, 2.5 / w, 2.5 / w, 256)
    res = chip_smoke.check_pipelined_mandelbrot(
        ck, wl, {"two host lanes": _lanes(2), "one host lane": _lanes(1)}, _mods(), ref,
        iters=1)
    assert len([k for k in res if k != "launches"]) == 4


@pytest.mark.parametrize("label", ["lane benches per call", "lane walls per call"])
def test_balancer_gate_reads_each_local_range_s_first_run(label):
    """``tools/balancer_gate.py`` reads, per local range, the median lane
    benches past the first five calls and the host lane's last range from
    the lines ``check_balancer`` prints of its first run (the label of a
    checkout from before the GPU lane's bench was its device span too)."""
    from cekirdekler_tpu_torch.tools.balancer_gate import first_runs

    benches = [(9.0, 9.0)] * 5 + [(0.5, 2.0), (0.7, 2.5), (0.6, 3.0)]
    lines = [f"local range 512, host-lane range per call: {[2048, 1024, 512]}",
             f"local range 512, {label} (GPU ms / host ms): {benches}",
             "local range 512: settled within 80 calls in 10 of 10 runs, at [3]",
             "local range 256, run 0 moved late; last 25 calls' host-lane ranges [256]"]
    assert first_runs(lines) == {"512": {"last_host_range": 512, "median_ms": [0.6, 2.5]}}


def _health_fleet(monkeypatch, clock_lags=(0.002, 0.002)):
    """``chip_smoke``'s ``ck`` for the health phase on two host lanes under
    a modelled clock (``tests/test_torch_drain.StallClock``): each lane's
    fence reads its lag, plus the stall the fault plane asked for."""
    import types

    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch.core import cores as port_cores
    from tests.test_torch_drain import StallClock

    clock = StallClock()
    clock.lags = dict(enumerate(clock_lags))
    monkeypatch.setattr(port_cores, "time", clock)

    def cruncher(*args, **kw):
        cr = ck.NumberCruncher(*args, **kw)
        clock.attach(cr)
        return cr

    return types.SimpleNamespace(NumberCruncher=cruncher, ClArray=ck.ClArray), ck


def _health_run(monkeypatch):
    from cekirdekler_tpu_torch import workloads as wl
    from tests.test_torch_metrics import restore_planes, save_planes

    fake, ck = _health_fleet(monkeypatch)
    ref = wl.mandelbrot_host(32, 32, -2.0, -1.25, 2.5 / 32, 2.5 / 32, 8)
    saved = save_planes()
    try:
        return chip_smoke.check_health_drain(fake, wl, ck.all_devices().cpus(2), ref, W=32,
                                             max_iter=8)
    finally:
        restore_planes(saved)


def test_the_health_phase_passes_on_host_lanes(monkeypatch):
    """Phase 5g (a) on two host lanes: the stalled lane is degraded at the
    64th barrier, drained there, probed two barriers later and readmitted
    once a window of its probe samples reads its baseline again."""
    res = _health_run(monkeypatch)
    assert res == {"degraded_at": 63, "drained_at": 63, "probe_at": 65, "readmitted_at": 74}


def test_the_health_phase_fails_when_the_drain_does_not_act(monkeypatch):
    from cekirdekler_tpu_torch.obs import drain

    monkeypatch.setattr(drain.DrainController, "evaluate", lambda self: None)
    with pytest.raises(AssertionError, match="health phase"):
        _health_run(monkeypatch)


def test_the_device_trace_phase_refuses_a_trace_without_kernel_records():
    """Phase 5g (b) on a host lane: the capture records every mark, but a
    trace without kernel records is a named absence, and the gate fails."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    ref = wl.mandelbrot_host(32, 32, -2.0, -1.25, 2.5 / 32, 2.5 / 32, 8)
    with pytest.raises(AssertionError, match="no device op"):
        chip_smoke.check_device_trace(ck, wl, ck.all_devices().cpus(1), ref, W=32, max_iter=8)


def _marks(n=12):
    from cekirdekler_tpu_torch.trace import device as dv

    return [dv.Mark(100 + i, "mandelbrot", 7301, 0, float(i), float(i) + 0.5) for i in range(n)]


@pytest.mark.parametrize("lost, leads, dropped", [
    ([], {"launched": 4, "records": 4}, 0),
    ([], {"launched": 4, "records": 0}, 0),
    ([100, 101], {"launched": 4, "records": 0}, 2),   # the drop ran past every lead
    ([100], {"launched": 4, "records": 0}, 1),
])
def test_the_device_trace_gate_passes_a_drop_that_ran_past_the_leads(lost, leads, dropped):
    assert chip_smoke.gate_trace_marks(_marks(), lost, leads, 12) == dropped


@pytest.mark.parametrize("lost, leads", [
    ([100], {"launched": 4, "records": 4}),       # the leads kept: no mark may go
    ([100], {"launched": 4, "records": 1}),       # the drop ended inside the leads
    ([101], {"launched": 4, "records": 0}),       # not the window's first mark
    ([100, 102], {"launched": 4, "records": 0}),  # not a prefix
    (list(range(100, 107)), {"launched": 4, "records": 0}),  # more than half the window
    ([100], {}),                                  # no lead kernels (a host lane)
])
def test_the_device_trace_gate_fails_a_mark_lost_otherwise(lost, leads):
    with pytest.raises(AssertionError, match="matched no kernel record"):
        chip_smoke.gate_trace_marks(_marks(), lost, leads, 12)


# -- phase 5h: the verify gate, checkpoints and the debug server, on host lanes


@pytest.fixture
def _clean_planes(monkeypatch):
    from tests.test_torch_metrics import restore_planes, save_planes

    monkeypatch.delenv("CK_KERNEL_VERIFY", raising=False)
    saved = save_planes()
    yield
    restore_planes(saved)


def test_phase_5h_planted_stencil_gates_pass_on_host_lanes(_clean_planes):
    import cekirdekler_tpu_torch as ck

    res = chip_smoke.check_planted(ck, ck.all_devices().cpus(2), ck.all_devices().cpus(1),
                                   4096)
    assert res["split"] == [2048, 2048] and res["differs_at"] == res["boundary"] == [2047, 2048]
    assert res["refused"] == "partial-read-halo" and len(res["kernel_verify_events"]) == 1


def test_phase_5h_planted_stencil_gate_fails_without_the_halo(_clean_planes, monkeypatch):
    """With the unsafe shape's flags made safe, the split run no longer
    differs at the boundary and strict no longer refuses: the gate raises."""
    import cekirdekler_tpu_torch as ck

    monkeypatch.setattr(chip_smoke, "stencil_flags",
                        lambda full: [dict(read_only=True), dict(write_only=True)])
    with pytest.raises(AssertionError, match="strict mode ran|not exactly"):
        chip_smoke.check_planted(ck, ck.all_devices().cpus(2), ck.all_devices().cpus(1), 4096)


def test_phase_5h_stencil_host_is_the_kernel_s():
    x = np.random.default_rng(0).standard_normal(257).astype(np.float32)
    want = np.array([(x[i - 1] if i else np.float32(0)) + x[i]
                     + (x[i + 1] if i < 256 else np.float32(0)) for i in range(257)],
                    np.float32)
    assert chip_smoke.stencil_host(x).tobytes() == want.tobytes()


def test_phase_5h_checkpoint_resume_on_the_cpu(_clean_planes):
    import torch

    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=64,
                            param_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 33)))
    res = chip_smoke.checkpoint_resume(wl, cfg, tokens, 2, device="cpu")
    assert res["differ"] == [] and res["leaves"] == res["loaded"]
    assert res["bf16_leaves"] > 0 and res["moments"] == 2 * (2 + 6 * cfg.n_layers)
    assert all(abs(a - b) <= 1e-3 * abs(a) for a, b in zip(res["losses"], res["resumed"]))


def test_phase_5h_debug_server_gates_pass_on_host_lanes(_clean_planes):
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    W, it = 64, 32
    ref_img = wl.mandelbrot_host(W, W, -2.0, -1.25, 2.5 / W, 2.5 / W, it)
    run = chip_smoke.debug_server_run(ck, wl, ck.all_devices().cpus(2), ref_img, W, it,
                                      calls=10)
    res = chip_smoke.gate_debug_server(run, 2, on_card=False)
    assert res["decision_rows"] > 0 and "load-balance" in res["decision_kinds"]
    assert run["answered_after_close"] is False
    broken = dict(run, statuses=dict(run["statuses"], **{"/servez": [200]}))
    with pytest.raises(AssertionError, match="/servez"):
        chip_smoke.gate_debug_server(broken, 2, on_card=False)
    with pytest.raises(AssertionError, match="after close"):
        chip_smoke.gate_debug_server(dict(run, answered_after_close=True), 2, on_card=False)


# -- phase 5i: the compile cache, on host lanes and over hand-made trios


@pytest.mark.parametrize("hand", [False, True], ids=["C-subset", "hand kernel"])
def test_phase_5i_warm_window_gate_passes_on_host_lanes(hand):
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    W, it = 64, 32
    ref_img = wl.mandelbrot_host(W, W, -2.0, -1.25, 2.5 / W, 2.5 / W, it)
    source = wl.mandelbrot_cuda_kernel() if hand else wl.MANDELBROT_SRC
    run = chip_smoke.warm_first_window(ck, wl, ck.all_devices().cpus(1), source, ref_img, W, it)
    chip_smoke.gate_warm_window("host", run, None)
    assert run["before"][0] > 0 and run["before"] == run["after"]


def test_phase_5i_warm_window_gate_fails_when_warmup_builds_nothing(monkeypatch):
    """With warmup a stub that builds nothing, the first windows build the
    launchers: the gate refuses."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core.cores import Cores

    monkeypatch.setattr(Cores, "warmup", lambda self, plan: {"warmed": 1})
    W, it = 64, 32
    ref_img = wl.mandelbrot_host(W, W, -2.0, -1.25, 2.5 / W, 2.5 / W, it)
    run = chip_smoke.warm_first_window(ck, wl, ck.all_devices().cpus(1), wl.MANDELBROT_SRC,
                                       ref_img, W, it)
    with pytest.raises(AssertionError, match="built or loaded"):
        chip_smoke.gate_warm_window("host", run, None)


def _trio() -> dict:
    """A trio as ``tools/coldstart.trio`` gives it on the card."""
    child = {"digest": "8cd5d45651024215", "first_batch_ms": 100.0, "steady_batch_ms": 3.0,
             "first_batch": {"launchers": 7, "compile": 0, "load": 1}, "launches": {"nBody": 8}}
    warm = dict(child, first_batch={"launchers": 0, "compile": 0, "load": 0},
                warm={"warmed": 1, "hits": 1, "misses": 0}, warmup_ms=70.0)
    return {"cold": dict(child), "populate": dict(child), "warm": warm, "ok": True,
            "exact": True, "entries": 1, "libraries": 1}


def test_phase_5i_coldstart_gate_passes_a_sound_trio():
    chip_smoke.gate_coldstart(_trio(), on_card=True)


@pytest.mark.parametrize("fault, match", [
    ("warm child compiled", "first batch compiled"),
    ("warm child built a launcher", "first batch compiled"),
    ("inexact", "differ"),
    ("no library", "no library"),
    ("no entry", "no entry"),
    ("child failed", "failed"),
    ("warmup missed", "warmup missed"),
    ("no launch on the card", "never launched"),
])
def test_phase_5i_coldstart_gate_refuses(fault, match):
    trio = _trio()
    if fault == "warm child compiled":
        trio["warm"]["first_batch"] = {"launchers": 0, "compile": 1, "load": 1}
    elif fault == "warm child built a launcher":
        trio["warm"]["first_batch"] = {"launchers": 1, "compile": 0, "load": 0}
    elif fault == "inexact":
        trio["exact"] = False
        trio["warm"]["digest"] = "0" * 16
    elif fault == "no library":
        trio["libraries"] = 0
    elif fault == "no entry":
        trio["entries"] = 0
    elif fault == "child failed":
        trio["populate"] = {"mode": "populate", "error": "timeout after 180.0 s"}
    elif fault == "warmup missed":
        trio["warm"]["warm"] = {"warmed": 1, "hits": 0, "misses": 1}
    else:
        trio["cold"]["launches"] = {}
    with pytest.raises(AssertionError, match=match):
        chip_smoke.gate_coldstart(trio, on_card=True)


def test_phase_5i_coldstart_gate_on_host_lanes_needs_no_library():
    trio = _trio()
    trio["libraries"] = 0
    for mode in ("cold", "populate", "warm"):
        trio[mode]["launches"] = {}
    chip_smoke.gate_coldstart(trio, on_card=False)


# -- phase 5j: queue markers and user events, on host lanes and planted faults


def _mandel_ref(w: int = 64):
    from cekirdekler_tpu_torch import workloads as wl

    return wl.mandelbrot_host(w, w, -2.0, -1.25, 2.5 / w, 2.5 / w, 256)


def test_phase_5j_markers_gate_passes_on_host_lanes():
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import registry

    run = chip_smoke.markers_main_path(ck, wl, _lanes(2), _mandel_ref(), registry)
    chip_smoke.gate_markers_main_path(run)
    assert run["routes"]["torch"] == sum(lane["sites"]["launch"] for lane in run["lanes"]) > 0


def test_phase_5j_markers_gate_fails_when_markers_stay_after_the_drain(monkeypatch):
    """A lost reach leaves markers remaining after the drain: the gate refuses."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import registry
    from cekirdekler_tpu_torch.utils.markers import MarkerCounter

    monkeypatch.setattr(MarkerCounter, "reach", lambda self, n=1: None)
    monkeypatch.setattr(MarkerCounter, "drain", lambda self, timeout=30.0: None)
    run = chip_smoke.markers_main_path(ck, wl, _lanes(2), _mandel_ref(), registry)
    with pytest.raises(AssertionError, match="remaining after its drain"):
        chip_smoke.gate_markers_main_path(run)


def _retirement(hold_s: float) -> dict:
    """Phase 5j (b)'s measure on a host lane, over an issue that adds one
    marker retired by a future ``hold_s`` later (the long kernel's stand-in)."""
    import threading
    from concurrent.futures import Future

    import cekirdekler_tpu_torch as ck

    with ck.NumberCruncher(_lanes(1), chip_smoke.SAXPY_SRC) as cr:
        cr.fine_grained_queue_control = True
        m = cr.cores.workers[0].markers
        fut = Future()

        def issue():
            m.add()
            m.reach_when_ready(fut)
            threading.Timer(hold_s, fut.set_result, args=(None,)).start()

        run = chip_smoke.retirement_run(cr, issue)
        m.drain(timeout=10.0)
        run["after_drain"] = cr.count_markers_remaining()
    return run


def test_phase_5j_retirement_gate_passes_a_marker_its_work_retires():
    run = _retirement(0.2)
    chip_smoke.gate_real_retirement(run)
    assert run["after_issue"] == 1 and run["after_drain"] == 0


def test_phase_5j_retirement_gate_fails_on_markers_reached_at_issue(monkeypatch):
    from cekirdekler_tpu_torch.utils.markers import MarkerCounter

    monkeypatch.setattr(MarkerCounter, "reach_when_ready",
                        lambda self, handle, n=1: self.reach(n))
    run = _retirement(0.2)
    with pytest.raises(AssertionError, match="reached at issue"):
        chip_smoke.gate_real_retirement(run)


def test_phase_5j_retirement_gate_fails_when_markers_stay_after_the_drain():
    run = dict(_retirement(0.2), after_drain=1)
    with pytest.raises(AssertionError, match="after barrier"):
        chip_smoke.gate_real_retirement(run)


def test_phase_5j_gate_phase_passes_on_host_lanes():
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import registry

    run = chip_smoke.gated_compute(ck, wl, _lanes(2), registry, n=1 << 12)
    chip_smoke.gate_gated_compute(run)
    assert run["held"] and run["moved"] == 0 and run["disengaged"] == {"dispatch-gate": 2}


def test_phase_5j_gate_phase_fails_when_the_gate_does_not_hold(monkeypatch):
    """A gate whose wait returns at once lets the call run untriggered."""
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.kernel import registry
    from cekirdekler_tpu_torch.utils.events import UserEvent

    monkeypatch.setattr(UserEvent, "wait", lambda self, timeout=None: True)
    run = chip_smoke.gated_compute(ck, wl, _lanes(2), registry, n=1 << 12)
    with pytest.raises(AssertionError, match="did not hold"):
        chip_smoke.gate_gated_compute(run)


def test_phase_5j_pool_gate_passes_on_host_lanes():
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl

    res = chip_smoke.check_device_pool(ck, wl, _lanes(3), _mods(), _mandel_ref(), tiles=16,
                                       hand=True, fine_grained_queue_control=True,
                                       queue_limit=chip_smoke.POOL_QUEUE_LIMIT)
    chip_smoke.gate_pool_depth(res, chip_smoke.POOL_QUEUE_LIMIT)
    assert res["remaining"] == [0, 0, 0] and res["burst"] >= 2


@pytest.mark.parametrize("fault, match", [
    ({"max_inflight_depth": 4 + 3 + 1}, "over queue_limit"),
    ({"remaining": [0, 2, 0]}, "remaining after drain"),
])
def test_phase_5j_pool_gate_refuses(fault, match):
    res = dict({"max_inflight_depth": 3, "burst": 3, "remaining": [0, 0, 0]}, **fault)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.gate_pool_depth(res, 4)


# -- phase 5k: the cluster tier, on host lanes and over hand-made runs ---------------

def test_phase_5k_wire_bytes_counts_the_frame():
    from cekirdekler_tpu_torch.cluster.netbuffer import ArrayRecord, Command, Message

    for msg in (Message(Command.CONTROL),
                Message(Command.COMPUTE, meta={"compute_id": 3, "size_1": 9}, strings=["ü", "k"],
                        values=[1, 2.5], arrays=[ArrayRecord(1, np.arange(7, dtype=np.int64)),
                                                 ArrayRecord(2, np.zeros(0, np.float32))])):
        assert chip_smoke.wire_bytes(msg) == 9 + len(msg.encode())


@pytest.fixture(scope="module")
def tcp_run_on_host_lanes():
    """Phase 5k (a)'s run at 128x128x16, the server in this process; its node
    is made slower by a modelled 40 ms a request (the frame's halves cost the
    same, so only the node's overhead can move the balancer, and on host
    lanes that is noise)."""
    import time

    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.cluster import CruncherServer
    from cekirdekler_tpu_torch.cluster import server as server_mod

    W, it = 128, 16
    ref = wl.mandelbrot_host(W, W, -2.0, -1.25, 2.5 / W, 2.5 / W, it)
    real = server_mod._ClientSession._compute
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(server_mod._ClientSession, "_compute",
                   lambda self, msg: (time.sleep(0.04), real(self, msg))[1])
        server = CruncherServer(devices=ck.cpus(1))
        try:
            return chip_smoke.tcp_run(ck, wl, ck.cpus(1), ref, W, it, {"port": server.port},
                                      _mods())
        finally:
            server.stop()


def test_phase_5k_tcp_gate_passes_on_host_lanes(tcp_run_on_host_lanes):
    run = tcp_run_on_host_lanes
    chip_smoke.gate_tcp_tier(run, {"launches": {}, "routes": {}}, on_card=False)
    from cekirdekler_tpu_torch.tools.dcn_cluster import WARMUP

    assert len(run["shares"]) == WARMUP + chip_smoke.CLUSTER_ITERS
    # the server's slice comes back, 4 bytes a pixel, inside one reply
    assert all(4 * sh[0] < r < 4 * sh[0] + 200
               for r, sh in zip(run["received"], run["shares"]))
    assert all(0 < s < 400 for s in run["sent"])  # a write-only image: no payload goes out


@pytest.mark.parametrize("fault, match", [
    ({"bad": [0, 3] + [0] * 8}, "pixels differ"),
    ({"nodes": 1}, "dropped"),
    ({"shares": [[8192, 8192]] * 10}, "never left the equal split"),
    ({"shares": [[8192, 8192], [16384, 1]] + [[8192, 8192]] * 8}, "outside the range"),
])
def test_phase_5k_tcp_gate_refuses(tcp_run_on_host_lanes, fault, match):
    run = dict(tcp_run_on_host_lanes, **fault)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.gate_tcp_tier(run, {"launches": {}, "routes": {}}, on_card=False)


def test_phase_5k_tcp_gate_refuses_the_torch_route_on_the_card(tcp_run_on_host_lanes):
    with pytest.raises(AssertionError, match="mainframe's launches"):
        chip_smoke.gate_tcp_tier(tcp_run_on_host_lanes, {"launches": {}, "routes": {}})


@pytest.fixture(scope="module")
def dcn_jobs_on_host_lanes(tmp_path_factory):
    from cekirdekler_tpu_torch import cpus
    from cekirdekler_tpu_torch.tools import dcn_cluster as tool
    from cekirdekler_tpu_torch.workloads import mandelbrot_host

    W, it = 64, 32
    root = str(tmp_path_factory.mktemp("ck_5k") / "ckpt")
    env = chip_smoke.cluster_env()
    first = chip_smoke.dcn_first(root, W, it, env, cpu=True)
    rejoin = chip_smoke.dcn_rejoin(root, W, it, env, cpu=True)
    single = tool.digest(mandelbrot_host(W, W, -2.0, -1.25, 2.5 / W, 2.5 / W, it))
    undisturbed = tool.digest(tool.undisturbed_windows(cpus(1), W, it, chip_smoke.CLUSTER_WINDOWS))
    return first, rejoin, single, undisturbed, W * W


def test_phase_5k_dcn_gates_pass_on_host_lanes(dcn_jobs_on_host_lanes):
    first, rejoin, single, undisturbed, n = dcn_jobs_on_host_lanes
    chip_smoke.gate_dcn_job(first, n, single, on_card=False)
    chip_smoke.gate_rejoin(rejoin, [1, 2], undisturbed, on_card=False)
    assert [r["elastic"]["resumed_from"] for r in rejoin["reports"]] == [3, 3]


def _broken(job: dict, rank: int, **fields) -> dict:
    reports = [dict(r) for r in job["reports"]]
    for key, value in fields.items():
        if key in ("gather", "elastic"):
            reports[rank][key] = dict(reports[rank][key], **value)
        else:
            reports[rank][key] = value
    return dict(job, reports=reports)


@pytest.mark.parametrize("fault, match", [
    (lambda j: dict(j, rcs=[17, None], reports=[j["reports"][0], None]), "exit codes"),
    (lambda j: _broken(j, 1, digest="0" * 16), "image digest"),
    (lambda j: _broken(j, 0, exchange_exact={"int64": False, "float64": True,
                                             "broadcast0": True}), "64-bit"),
    (lambda j: _broken(j, 1, gather={"trace_blocks": [1]}), "merged trace"),
    (lambda j: _broken(j, 0, gather={"spans_by_block": {"1": 4, "2": 0}}), "merged trace"),
    (lambda j: _broken(j, 1, shares=[[1, 2]]), "outside"),
    (lambda j: _broken(j, 0, device="cpu"), "host lane"),
])
def test_phase_5k_dcn_gate_refuses(dcn_jobs_on_host_lanes, fault, match):
    first, _, single, _, n = dcn_jobs_on_host_lanes
    on_card = match == "host lane"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.gate_dcn_job(fault(first), n, single, on_card=on_card)


@pytest.mark.parametrize("fault, match", [
    (lambda j: dict(j, rcs=[0, 1]), "exit codes"),
    (lambda j: _broken(j, 1, elastic={"digest": "0" * 16}), "undisturbed"),
    (lambda j: _broken(j, 0, elastic={"resumed_from": 4}), "resumed from"),
    (lambda j: _broken(j, 0, elastic={"decision_kinds": ["checkpoint-restore"]}), "decisions"),
    (lambda j: _broken(j, 1, proc_device_counts=[1, 1]), "lanes"),
])
def test_phase_5k_rejoin_gate_refuses(dcn_jobs_on_host_lanes, fault, match):
    _, rejoin, _, undisturbed, _ = dcn_jobs_on_host_lanes
    with pytest.raises(AssertionError, match=match):
        chip_smoke.gate_rejoin(fault(rejoin), [1, 2], undisturbed, on_card=False)


def test_phase_5k_server_child_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    proc, lines = chip_smoke.start_child(["-c", chip_smoke.SERVER_CHILD], chip_smoke.cluster_env())
    seen: list = []
    try:
        with pytest.raises(AssertionError, match="ended before"):
            chip_smoke.tagged_line(lines, "CK_SERVER ", seen, 120)
        assert "DeviceSelectionError" in "".join(seen)
    finally:
        chip_smoke.stop_child(proc)
    assert proc.returncode != 0
