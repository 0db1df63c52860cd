"""The port's DCN tier (``cluster/dcn.py``) on ``torch.distributed`` over
gloo: real processes on host lanes, one balanced global range, written
ranges exchanged as raw bytes.

- 2 processes x 2 host lanes, and 3 processes x (2, 1, 1), under a
  ``timing_hook`` of modelled times: every process's share trajectory
  equals the reference ``ClusterLoadBalancer``'s on those times, the result
  equals the reference's single-process ``compute()``, 64-bit values cross
  exactly, and ``gather_cluster`` merges every rank (in
  ``tests/_torch_dcn_worker.py``).
- Kill and rejoin: a 2 x 2 job preempted after window 3 of 6 resumes as a
  2 x (2, 1) job past a torn newest checkpoint and ends bit-identical to
  the undisturbed run; its decision logs replay green in both packages
  (``tests/_torch_dcn_elastic_worker.py``).
- No fallback: ``DistributedAccelerator()`` raises ``DeviceSelectionError``
  where there is no card.

This file owns the processes: each job is bounded at 120 s in all, and a
worker is killed and waited for on every exit path.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cekirdekler_tpu.cluster.balancer import ClusterLoadBalancer as RefBalancer
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs.decisions import load_decision_log as ref_load_log
from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records
from cekirdekler_tpu_torch.errors import DeviceSelectionError
from cekirdekler_tpu_torch.obs.decisions import load_decision_log
from cekirdekler_tpu_torch.obs.replay import verify_records

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JOB_TIMEOUT_S = 120.0
#: tests/_torch_dcn_elastic_worker.py's exit code for the preemption
EXIT_PREEMPTED = 17

SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = y[i] + a * x[i];
}
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(worker: str, nproc: int, args, env_extra: dict | None = None) -> list:
    """Start ``nproc`` workers and wait for all of them, 120 s in all; returns
    (exit code, output) a worker."""
    port = _free_port()
    env = {**os.environ, "CK_FAULTS": ""}
    env.pop("CK_DECISION_LOG", None)
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / worker), str(pid), str(nproc), str(port), *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        deadline = time.monotonic() + JOB_TIMEOUT_S
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=30)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _reference_trajectory(counts: list[int], n: int, lr: int, calls: int) -> list:
    """The reference balancer's share tables under the workers' modelled
    times (process 1 takes 3x the time a work item), with the remainder on
    process 0, as ``DistributedAccelerator.compute`` applies them."""
    bal = RefBalancer([c * lr for c in counts])
    shares, rem = bal.equal_split(n)
    out = []
    for k in range(calls):
        if k:
            times = [s * (3.0 if j == 1 else 1.0) for j, s in enumerate(out[-1])]
            shares, rem = bal.rebalance(out[-1], times, n)
        shares = list(shares)
        shares[0] += rem
        out.append(shares)
    return out


def _reference_compute(n: int, calls: int) -> np.ndarray:
    import cekirdekler_tpu

    x = cekirdekler_tpu.ClArray(np.arange(n, dtype=np.float32), partial_read=True,
                                read_only=True)
    y = cekirdekler_tpu.ClArray(np.ones(n, np.float32), partial_read=True)
    cr = RefCruncher(ref_platforms().cpus().subset(1), SRC)
    try:
        for _ in range(calls):
            x.next_param(y).compute(cr, 1, "saxpy", n, 64, values=(2.0,))
    finally:
        cr.dispose()
    return np.asarray(y.host()).copy()


@pytest.mark.parametrize("counts", [[2, 2], [2, 1, 1]], ids=["2x2", "3x(2,1,1)"])
def test_a_distributed_job_follows_the_reference(counts, tmp_path):
    outs = _run("_torch_dcn_worker.py", len(counts), [",".join(map(str, counts)), tmp_path])
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0 and f"DCN_OK pid={pid}" in out, f"worker {pid} rc={rc}:\n{out[-3000:]}"
    reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("DCN_RESULT "))
                          [len("DCN_RESULT "):]) for _, out in outs]
    want = _reference_trajectory(counts, 4096, 64, 6)
    for rep in reports:
        assert rep["trajectory"] == want
        assert rep["timings"] == [float(s) * (3.0 if j == 1 else 1.0)
                                  for j, s in enumerate(want[-1])]
    ref_y = _reference_compute(4096, 6)
    for pid in range(len(counts)):
        np.testing.assert_array_equal(np.load(tmp_path / f"y_{pid}.npy"), ref_y)


def test_kill_and_rejoin_converges_bit_identical(tmp_path):
    ckpt = tmp_path / "ckpt"
    decisions = tmp_path / "decisions"
    decisions.mkdir()
    windows, kill_after = 6, 3
    first = _run("_torch_dcn_elastic_worker.py", 2,
                 ["2,2", ckpt, "first", windows, kill_after])
    for pid, (rc, out) in enumerate(first):
        assert rc == EXIT_PREEMPTED, f"worker {pid} rc={rc}:\n{out[-3000:]}"
    steps = sorted(os.listdir(ckpt))
    assert f"step_{kill_after:012d}" in steps and f"step_{kill_after + 1:012d}" not in steps
    torn = ckpt / f"step_{kill_after + 1:012d}"  # the resume must fall back past it
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"definitely not a zip file")
    rejoin = _run("_torch_dcn_elastic_worker.py", 2,
                  ["2,1", ckpt, "rejoin", windows, kill_after],
                  {"CK_DECISION_LOG": str(decisions) + os.sep})
    for pid, (rc, out) in enumerate(rejoin):
        assert rc == 0 and f"DCN_ELASTIC_OK pid={pid}" in out, \
            f"worker {pid} rc={rc}:\n{out[-3000:]}"
        assert f"DCN_ELASTIC_REPLAY pid={pid} ok=True" in out
    logs = sorted(decisions.iterdir())
    assert len(logs) == 2
    for log in logs:
        mine, ref = verify_records(load_decision_log(str(log))), \
            ref_verify_records(ref_load_log(str(log)))
        assert mine["ok"] and ref["ok"] and mine["replayed"] == ref["replayed"] > 0
        kinds = {r.kind for r in load_decision_log(str(log))}
        assert {"member-leave", "member-join", "checkpoint-restore"} <= kinds


def test_no_member_takes_host_lanes_unasked():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    from cekirdekler_tpu_torch.cluster.dcn import DistributedAccelerator

    with pytest.raises(DeviceSelectionError):
        DistributedAccelerator()
