"""The balancer gate of ``chip_smoke.py`` on the CPU.

``chip_smoke.check_balancer`` needs the card; what it decides from a run's
range trajectory does not.  ``tail_moves`` is held against hand-made
trajectories, and the gate against the modelled mixed fleet of
``tests/test_torch_balance.py``: the port's balancer passes it, and the
same balancer with its drain slowed (damping pinned at 0.02, no undamped
jump) fails it, although ``workloads._converged_at`` calls both settled.
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
