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
