"""One process of the kill-and-rejoin DCN job over the port's
``DistributedAccelerator`` (``tests/test_torch_dcn.py``; the port's
counterpart of the reference's ``tests/_dcn_elastic_worker.py``).  Run as

    python tests/_torch_dcn_elastic_worker.py <pid> <nproc> <port> <counts> \
        <ckpt_root> <phase> <windows> <kill_after>

``counts`` is the comma-separated table of host lanes a process.  The job
adds ``2·x`` into ``y`` once a window through the DCN tier and checkpoints
every completed window (process 0 writes, everyone barriers; tmp+rename, so
a kill never leaves a half window).

- ``first`` runs windows 1..kill_after, then every process dies by
  ``os._exit(EXIT_PREEMPTED)``: a preemption, with no cleanup, no flush and
  no dispose.
- ``rejoin`` is a new job (another port, possibly other lane counts, so a
  membership change): it resumes from the last COMPLETE window
  (``resume_elastic``, past a torn newest step the parent planted),
  reconciles membership (recorded ``member-leave``/``member-join`` with
  the new re-split), runs the remaining windows and checks that the image
  is bit-identical to the undisturbed run's.  The decision log it spills
  under ``CK_DECISION_LOG`` must replay green.

Every collective gives up after 60 s.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SRC = """
__kernel void accum(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = y[i] + a * x[i];
}
"""

LOCAL_RANGE = 64
N = 4096
A = 2.0
EXIT_PREEMPTED = 17


def reference_image(windows: int) -> np.ndarray:
    """The undisturbed run's image: the same f32 operations an element, a
    window at a time, whatever the partition."""
    x = np.arange(N, dtype=np.float32) * np.float32(0.37)
    y = np.ones(N, np.float32)
    for _ in range(windows):
        y = (y + np.float32(A) * x).astype(np.float32)
    return y


def main(pid: int, nproc: int, port: int, counts: list[int], ckpt_root: str,
         phase: str, windows: int, kill_after: int) -> None:
    import torch.distributed as dist

    from cekirdekler_tpu_torch import ClArray, cpus
    from cekirdekler_tpu_torch.cluster.dcn import DistributedAccelerator, initialize

    initialize(f"127.0.0.1:{port}", nproc, pid, timeout_s=60.0)
    acc = DistributedAccelerator(local_devices=cpus(counts[pid]))
    acc.setup_nodes(SRC)
    assert acc.proc_device_counts == counts, acc.proc_device_counts
    x = ClArray(np.arange(N, dtype=np.float32) * np.float32(0.37), partial_read=True,
                read_only=True)
    y = ClArray(np.ones(N, np.float32), partial_read=True)
    start_window = 0
    if phase == "rejoin":
        state = acc.resume_elastic(ckpt_root, LOCAL_RANGE, total=N)
        assert state is not None, "rejoin found no checkpoint"
        assert state["window"] == kill_after, state["window"]  # fell back past the torn step
        start_window = state["window"]
        y.host()[:] = state["arrays"]["y"]
        m = state["membership"]
        if state["member_steps"] != [c * LOCAL_RANGE for c in counts]:
            assert m.epoch > 1, m.snapshot()  # the roster changed: transitions recorded
    else:
        acc.establish_membership(LOCAL_RANGE)

    for w in range(start_window + 1, windows + 1):
        acc.compute(["accum"], [x, y], compute_id=1, global_range=N,
                    local_range=LOCAL_RANGE, values=(A,))
        acc.checkpoint_window(ckpt_root, w, {"y": y.host()}, LOCAL_RANGE)
        acc.barrier(f"ckpt_{w}")
        if phase == "first" and w >= kill_after:
            sys.stdout.flush()
            os._exit(EXIT_PREEMPTED)  # the preemption: no cleanup whatsoever

    np.testing.assert_array_equal(y.host(), reference_image(windows))
    from cekirdekler_tpu_torch.obs.decisions import DECISIONS, load_decision_log
    from cekirdekler_tpu_torch.obs.replay import verify_records

    spill = DECISIONS.maybe_spill(force=True)
    assert spill, "CK_DECISION_LOG is not armed"
    rows = load_decision_log(spill)
    verdict = verify_records(rows)
    assert verdict["ok"], verdict
    kinds = {r.kind for r in rows}
    assert "checkpoint-restore" in kinds, kinds
    if counts != [2, 2]:
        assert {"member-leave", "member-join"} <= kinds, kinds
    print(f"DCN_ELASTIC_REPLAY pid={pid} ok={verdict['ok']} replayed={verdict['replayed']} "
          f"log={spill}", flush=True)
    print(f"DCN_ELASTIC_OK pid={pid} phase={phase} windows={windows}", flush=True)
    acc.dispose()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         [int(c) for c in sys.argv[4].split(",")], sys.argv[5], sys.argv[6],
         int(sys.argv[7]), int(sys.argv[8]))
