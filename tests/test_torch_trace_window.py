"""How ``tools/trace_window.py`` reads a ``torch.profiler`` trace, on the
CPU, against hand-made traces; and the card's tools refusing to run
without a card.

A trace on the card's machine drops the record of the window's first
kernel, at times more than one, and has been seen to garble a record's
time, so a window opens with lead kernels whose records the readers leave
out.  The per-call reader must give each named kernel's time a call, with
up to half a call's records lost, and raise where more are lost or one
record is far from the others.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cekirdekler_tpu_torch.tools import trace_window

ROOT = Path(__file__).resolve().parents[1]
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
LEAD = f"void at::cuda::{trace_window.LEAD_KERNEL}(long)"


def _evt(name, us, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(elapsed_us=lambda us=us: us))


def _trace(calls, per_call=(("fa_fwd_parts_tc_kernel", 120.0),), leads=4, lost=0,
           garbled=None, at=0):
    """A window of ``calls`` calls, each launching ``per_call`` in order,
    after ``leads`` lead records, with ``lost`` records of the calls from
    index ``at`` on dropped and the record at index ``garbled`` given 30 ms."""
    kernels = [_evt(name, us) for _ in range(calls) for name, us in per_call]
    del kernels[at:at + lost]
    if garbled is not None:
        kernels[garbled] = _evt(kernels[garbled].name, 30000.0)
    events = [_evt("cudaLaunchKernel", 5.0, CPU)] + [_evt(LEAD, 1.0)] * leads + kernels
    return SimpleNamespace(events=lambda: events)


@pytest.mark.parametrize("case, want", [
    (dict(calls=10), {"fa_fwd_parts": 0.12, "total": 0.12}),
    (dict(calls=10, leads=1), {"fa_fwd_parts": 0.12, "total": 0.12}),
    (dict(calls=10, leads=0), {"fa_fwd_parts": 0.12, "total": 0.12}),
    (dict(calls=5, per_call=(("fa_bwd_dq_kernel", 900.0),
                             ("fa_bwd_dkv_parts_tc_kernel", 160.0))),
     {"fa_bwd_dq": 0.9, "fa_bwd_dkv": 0.16, "total": 1.06}),
    (dict(calls=4, per_call=(("ew_saxpy", 10.0), ("ew_saxpy", 10.0), ("memcpy", 3.0))),
     {"ew_": 0.02, "total": 0.023}),
    (dict(calls=10, lost=1), {"fa_fwd_parts": 0.12, "total": 0.12}),
    (dict(calls=10, lost=5, at=3), {"fa_fwd_parts": 0.12, "total": 0.12}),
    (dict(calls=4, per_call=(("ew_saxpy", 10.0), ("ew_saxpy", 10.0), ("memcpy", 3.0)), lost=2),
     {"ew_": 0.02, "total": 0.023}),
    (dict(calls=5, per_call=(("fa_bwd_dq_kernel", 900.0), ("fa_bwd_dkv_kernel", 160.0)),
          lost=1, at=9), {"fa_bwd_dq": 0.9, "fa_bwd_dkv": 0.16, "total": 1.06}),
])
def test_per_call_ms_reads_each_named_kernel_a_call(case, want):
    """Each named kernel's time a call and the total: the leads stay out, a
    kernel launched twice a call counts twice, activity no name matches
    counts in the total, and records lost at a window's start or inside it,
    up to half a call's, count at their kernel's mean."""
    names = tuple(k for k in want if k != "total")
    got = trace_window.per_call_ms(_trace(**case), case["calls"], names)
    assert got == pytest.approx(want)


def test_per_call_ms_counts_the_records_it_found_lost():
    before = trace_window.lost
    trace_window.per_call_ms(_trace(calls=10, lost=3), 10, ("fa_fwd_parts",))
    trace_window.per_call_ms(_trace(calls=10), 10, ("fa_fwd_parts",))
    assert trace_window.lost - before == 3


def test_per_call_ms_sums_an_activity_not_launched_every_call():
    """A copy made once in a window of ten calls is a tenth of a copy a
    call, not one a call."""
    prof = _trace(calls=10)
    events = prof.events() + [_evt("Memcpy HtoD", 50.0)]
    got = trace_window.per_call_ms(SimpleNamespace(events=lambda: events), 10,
                                   ("fa_fwd_parts",))
    assert got == pytest.approx({"fa_fwd_parts": 0.12, "total": 0.125})


@pytest.mark.parametrize("case, names", [
    (dict(calls=10, lost=6), ("fa_fwd_parts",)),
    (dict(calls=4, per_call=(("ew_saxpy", 10.0), ("ew_saxpy", 10.0)), lost=3), ("ew_",)),
    (dict(calls=10, garbled=0), ("fa_fwd_parts",)),
    (dict(calls=5, per_call=(("fa_bwd_dq_kernel", 900.0), ("fa_bwd_dkv_kernel", 160.0)),
          garbled=3), ("fa_bwd_dq", "fa_bwd_dkv")),
    (dict(calls=10), ("fa_bwd_dq",)),
])
def test_per_call_ms_refuses_a_record_lost_garbled_or_missing(case, names):
    """A named kernel whose records fall short of a whole number a call by
    more than half a call (lost), one of whose records is far from its
    median (garbled), or that left none raises instead of reading low or
    high."""
    with pytest.raises(trace_window.TraceDefect):
        trace_window.per_call_ms(_trace(**case), case["calls"], names)


def test_by_name_sums_each_activity_but_the_leads():
    prof = _trace(calls=3, per_call=(("a_kernel", 100.0), ("b_kernel", 300.0)))
    assert trace_window.by_name(prof) == [("b_kernel", pytest.approx(0.9), 3),
                                          ("a_kernel", pytest.approx(0.3), 3)]


@pytest.mark.parametrize("cmd, message", [
    (["-m", "cekirdekler_tpu_torch.tools.profile_main_path"], "a CUDA device"),
    (["-m", "cekirdekler_tpu_torch.tools.trace_records"], "no CUDA device"),
    (["cekirdekler_tpu_torch/tools/time_flash.py", "--parts"], "no CUDA device"),
    (["cekirdekler_tpu_torch/tools/sweep_mandelbrot.py", "--sass", "chiprun_out/sass"],
     "no CUDA device"),
])
def test_card_tools_refuse_without_a_card(cmd, message):
    """The tracing tools exit non-zero and print no result where no CUDA
    device is visible."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert message in proc.stderr
