"""One process of an N-process DCN job over the port's
``DistributedAccelerator`` (gloo on loopback), for ``tests/test_torch_dcn.py``
(the port's counterpart of the reference's ``tests/_dcn_worker.py``).  Run as

    python tests/_torch_dcn_worker.py <pid> <nproc> <port> <counts> <outdir>

``counts`` is the comma-separated table of host lanes a process.  The
worker runs six balanced ``saxpy`` calls under a ``timing_hook`` of
modelled times (process 1 reports 3x the time a work item, so the balancer
must move work away from it), and checks from inside the job: the result,
the agreed lane-count table, the LCM-step table and share snapping, the
share tables agreeing across processes, 64-bit values crossing exactly, a
degraded lane on process 1 reaching the merged cluster health table, and
``gather_cluster`` under a deliberate clock skew a process (pid x 7.5 s)
giving a collective-consistent merged trace.  It writes ``y_<pid>.npy`` to
``outdir`` and prints ``DCN_RESULT {json}`` with its share trajectory and
its timings, which the parent holds against the reference's balancer, and
``DCN_OK pid=<pid>``.  Every collective gives up after 60 s.
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = y[i] + a * x[i];
}
"""

LOCAL_RANGE = 64
N = 4096
CALLS = 6


def main(pid: int, nproc: int, port: int, counts: list[int], outdir: str) -> None:
    import torch.distributed as dist

    from cekirdekler_tpu_torch import ClArray, cpus
    from cekirdekler_tpu_torch.cluster.dcn import DistributedAccelerator, initialize
    from cekirdekler_tpu_torch.trace.spans import TRACER

    initialize(f"127.0.0.1:{port}", nproc, pid, timeout_s=60.0)
    hook = lambda cid, share, wall: float(share) * (3.0 if pid == 1 else 1.0)
    acc = DistributedAccelerator(local_devices=cpus(counts[pid]), timing_hook=hook)
    try:
        TRACER.enable(clear=True)
        acc.setup_nodes(SRC)
        assert acc.pid == pid and acc.nproc == nproc
        assert acc.proc_device_counts == counts, acc.proc_device_counts
        x = ClArray(np.arange(N, dtype=np.float32), partial_read=True, read_only=True)
        y = ClArray(np.ones(N, np.float32), partial_read=True)
        trajectory = []
        for _ in range(CALLS):
            acc.compute(["saxpy"], [x, y], compute_id=1, global_range=N,
                        local_range=LOCAL_RANGE, values=(2.0,))
            trajectory.append(acc.ranges_of(1))
            assert sum(trajectory[-1]) == N, trajectory[-1]
        np.testing.assert_array_equal(
            y.host(), 1.0 + CALLS * 2.0 * np.arange(N, dtype=np.float32))
        steps = [c * LOCAL_RANGE for c in counts]
        bal = acc.balancers[1]
        assert bal.steps == steps and bal.lcm == math.lcm(*steps), (bal.steps, steps)
        final = acc.ranges_of(1)
        for j in range(1, nproc):
            assert final[j] % steps[j] == 0, (final, steps)
        agreed = acc._allgather(np.asarray(final, np.int64))
        assert (agreed == np.asarray(final)[None, :]).all(), agreed
        assert final[0] > final[1], f"balancer did not move: {final}"
        timings = acc.compute_timing(1)
        assert len(timings) == nproc, timings

        # 64-bit payloads cross as raw bytes
        big = acc._allgather(np.asarray([2**40 + pid, -(2**62) - pid], np.int64))
        assert big.dtype == np.int64 and big.tolist() == [
            [2**40 + p, -(2**62) - p] for p in range(nproc)], big
        f64 = acc._allgather(np.asarray([np.pi / (pid + 1), 1e300 * (pid + 1)], np.float64))
        assert f64.dtype == np.float64 and f64.tolist() == [
            [np.pi / (p + 1), 1e300 * (p + 1)] for p in range(nproc)], f64
        mine = np.arange(5, dtype=np.float64) + (100.0 + 2**-40 if pid == 0 else -7.0)
        got = acc._broadcast0(mine)
        assert got.dtype == np.float64 and got.tolist() == (
            np.arange(5, dtype=np.float64) + 100.0 + 2**-40).tolist(), got

        # lane health: a 5x fence degradation on process 1's lane 0 only
        hm = acc.cruncher.cores.health
        n_lanes = len(acc.cruncher.cores.workers)
        for wnd in range(hm.min_history + hm.confirm + 1):
            for _ in range(hm.window):
                for lane in range(n_lanes):
                    v = 0.010 * (1.0 + 0.1 * lane)
                    if pid == 1 and lane == 0 and wnd >= hm.min_history:
                        v *= 5.0
                    hm.observe(lane, "fence", v)
        local = acc.health_report()
        if pid == 1:
            assert local[0]["verdict"] == "degraded", local
        else:
            assert all(r["verdict"] == "ok" for r in local.values()), local

        # one merged timeline, under a deliberate clock skew a process
        from cekirdekler_tpu_torch.obs.health import cluster_health_table
        from cekirdekler_tpu_torch.trace import aggregate

        spans = TRACER.snapshot()
        TRACER.disable()
        assert any(s.kind == "dcn-exchange" for s in spans)
        snap = aggregate.gather_cluster(acc, spans=spans, skew_s=pid * 7.5)
        assert snap["nproc"] == nproc and abs(snap["offsets"][0]) < 1e-9, snap["offsets"]
        for p in range(nproc):
            assert abs(snap["offsets"][p] - 7.5 * p) < 0.25, snap["offsets"]
            counters = snap["metrics"][p]["counters"]
            assert sum(v for k, v in counters.items()
                       if k.startswith("ck_dcn_exchange_bytes_total")) > 0, (p, counters)
        margin = aggregate.collective_consistency(snap)
        assert margin > -0.25, f"merged trace inconsistent: {margin}"
        table = cluster_health_table(snap)
        assert len(table["processes"]) == nproc, table
        assert {(d["process"], str(d["lane"])) for d in table["degraded"]} == {(1, "0")}, table
        merged = aggregate.merged_chrome_trace(snap)
        blocks = {e["pid"] for e in merged["traceEvents"]}
        assert blocks == set(range(1, nproc + 1)), blocks
        np.save(os.path.join(outdir, f"y_{pid}.npy"), y.host())
        print("DCN_RESULT " + json.dumps({
            "pid": pid, "trajectory": trajectory, "timings": timings,
            "offsets": snap["offsets"], "margin": margin,
            "events": len(merged["traceEvents"])}), flush=True)
        print(f"DCN_OK pid={pid}", flush=True)
    finally:
        acc.dispose()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         [int(c) for c in sys.argv[4].split(",")], sys.argv[5])
