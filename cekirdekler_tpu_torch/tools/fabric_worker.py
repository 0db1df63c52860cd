"""Worker process for the serving fabric: ONE shard of a multi-process
fabric — a ``ServeFrontend`` over its own ``NumberCruncher`` in its own
interpreter.

The port's counterpart of the reference's ``tests/_fabric_worker.py``, with
its protocol; it lives in the package so that the load generator
(:func:`.loadgen.run_fabric_mp`) and the tests start the same program.  A
parent starts N of these (fresh interpreters: a child forked from a process
with CUDA up cannot use the card), each prints a READY line, then obeys a
JSON-lines command protocol on stdin/stdout.  Run from the repository root
as::

    python -m cekirdekler_tpu_torch.tools.fabric_worker <member> <n> <local_range> \\
        [max_queue_depth] [gather_window_ms] [--cpu]

The shard takes the card, or two host lanes with ``--cpu``.  The optional
queue bound makes the shard run the same per-process admission
configuration a single-process run does; the gather window is per-shard
config (a shard seeing 1/N of the clients gathers ~N× longer to fill the
same fused batch).

Protocol (one JSON object per line; every command gets one reply):

- ``{"op": "warm", "sigs": [si, ...]}`` — precompile the ladder set
  for those signatures via ``ServeFrontend.warmup`` →
  ``{"op": "warmed", "warmed": k, "device": kind}``
- ``{"op": "serve", "assignments": [[tenant, si, clients, requests],
  ...]}`` — closed-loop client threads against the local frontend →
  ``{"op": "done", "completed", "per_sig", "latencies_ms", "wall_s",
  "hangs", "failed", "unnamed_failures", "failure_causes", "rejected",
  "checked"}``
- ``{"op": "run", "rid": i, "tenant": t, "sig": si, "iters": k}`` —
  k sequential blocking requests (the kill-test unit of work; the
  reply IS the ack — a killed worker never acks, so the parent
  re-routes exactly the unacked rids) → ``{"op": "done", "rid", "sig",
  "count"}``.  Optional ``"trace_rid": "r..."`` propagates the
  parent's request-lifecycle id onto every submit, so one rid's chain
  (``obs/reqtrace.py``) survives a shard hop.
- ``{"op": "value", "sig": si}`` — the signature array's value (every
  element must equal the applied count) → ``{"op": "value", "sig",
  "value", "uniform": bool}``
- ``{"op": "stats"}`` — part of the frontend's ``stats()`` doc →
  ``{"op": "stats", "stats": {...}}``
- ``{"op": "reqtrace"}`` — this shard's request-lifecycle ring as
  plain rows → ``{"op": "reqtrace", "events": [[t, rid, kind,
  fields], ...]}`` (wall-clock stamps)
- ``{"op": "exit"}`` → ``{"op": "bye"}`` and a clean close.

The workload kernel is the load generator's ``lg_inc`` (+1.0f per
request): lost or double-applied requests are integer-visible.
"""

from __future__ import annotations

import json
import sys
import threading
import time


def main(member: str, n: int, local_range: int, max_queue_depth: int = 0,
         gather_window_ms: float = 4.0, cpu: bool = False) -> None:
    import numpy as np

    from .. import ClArray, NumberCruncher, all_devices
    from ..errors import CekirdeklerError
    from ..serve import AdmissionController, ServeFrontend, ServeJob, ServeRejected
    from .loadgen import LOADGEN_SRC

    devs = all_devices().cpus(2) if cpu else \
        all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    cr = NumberCruncher(devs, LOADGEN_SRC)
    admission = None
    if max_queue_depth > 0:
        admission = AdmissionController(
            max_queue_depth=max_queue_depth,
            health=cr.cores.drain.healthy_with_drains)
    fe = ServeFrontend(cr, admission=admission, max_batch=512,
                       gather_window_s=gather_window_ms / 1000.0,
                       name=f"fabric-{member}")
    arrays: dict = {}
    jobs: dict = {}

    def job_for(si: int):
        if si not in jobs:
            a = ClArray(np.zeros(n, np.float32), name=f"w{member}_{si}")
            a.partial_read = True
            arrays[si] = a
            jobs[si] = ServeJob(
                params=[a], kernels=["lg_inc"], compute_id=9100 + si,
                global_range=n, local_range=local_range)
        return jobs[si]

    def op_serve(cmd: dict) -> dict:
        completed: dict = {}
        latencies: list = []
        rejected = [0]
        failed = [0]
        hangs = [0]
        unnamed = [0]
        causes: dict = {}
        mu = threading.Lock()
        # build jobs up front: array construction must not ride the
        # timed section
        for _tenant, si, _n_clients, _requests in cmd["assignments"]:
            job_for(int(si))

        def client(tenant: str, si: int, requests: int):
            job = jobs[si]
            for _ in range(int(requests)):
                fut = None
                for _attempt in range(50):
                    try:
                        fut = fe.submit(tenant, job)
                        break
                    except ServeRejected as e:
                        with mu:
                            rejected[0] += 1
                        time.sleep(min(e.retry_after_s, 0.25))
                if fut is None:
                    continue
                try:
                    r = fut.result(timeout=60.0)
                except Exception as e:  # noqa: BLE001 - counted below
                    with mu:
                        if type(e).__name__ == "TimeoutError":
                            hangs[0] += 1
                        else:
                            failed[0] += 1
                            cause = type(e).__name__
                            causes[cause] = causes.get(cause, 0) + 1
                            if not isinstance(e, CekirdeklerError):
                                unnamed[0] += 1
                    continue
                with mu:
                    latencies.append(r["latency_s"])
                    completed[si] = completed.get(si, 0) + 1

        threads = []
        for tenant, si, n_clients, requests in cmd["assignments"]:
            for _ in range(int(n_clients)):
                threads.append(threading.Thread(
                    target=client, args=(str(tenant), int(si), int(requests)),
                    daemon=True))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        wall = time.perf_counter() - t0
        stuck = sum(t.is_alive() for t in threads)
        checked = stuck == 0 and all(
            bool(np.all(np.asarray(arrays[si]) == float(cnt)))
            for si, cnt in completed.items())
        return {
            "op": "done", "member": member,
            "completed": sum(completed.values()),
            "per_sig": {str(k): v for k, v in sorted(completed.items())},
            "latencies_ms": [v * 1000.0 for v in latencies],
            "wall_s": wall,
            "hangs": hangs[0] + stuck, "failed": failed[0],
            "unnamed_failures": unnamed[0],
            "failure_causes": dict(sorted(causes.items())),
            "rejected": rejected[0],
            "checked": checked,
        }

    def op_run(cmd: dict) -> dict:
        si = int(cmd["sig"])
        job = job_for(si)
        tenant = str(cmd.get("tenant", "t0"))
        trace_rid = cmd.get("trace_rid")
        done = 0
        for _ in range(int(cmd.get("iters", 1))):
            fe.call(tenant, job, timeout=60.0, rid=trace_rid)
            done += 1
        return {"op": "done", "rid": cmd.get("rid"), "sig": si, "count": done}

    def op_reqtrace(cmd: dict) -> dict:
        from ..obs.reqtrace import REQTRACE

        return {"op": "reqtrace", "events": [
            [e.t, e.rid, e.kind, e.fields] for e in REQTRACE.snapshot()]}

    def op_value(cmd: dict) -> dict:
        si = int(cmd["sig"])
        a = np.asarray(arrays[si]) if si in arrays else np.zeros(1)
        return {"op": "value", "sig": si, "value": float(a[0]),
                "uniform": bool(np.all(a == a[0]))}

    print(f"FABRIC_READY member={member} device={devs[0].kind}", flush=True)
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            cmd = json.loads(line)
            op = cmd.get("op")
            if op == "warm":
                # scratch params: warmup is read for shapes only, the real
                # jobs then find their ladders built
                scratch = []
                for si in cmd["sigs"]:
                    a = ClArray(np.zeros(n, np.float32), name=f"scratch{si}")
                    a.partial_read = True
                    scratch.append(ServeJob(
                        params=[a], kernels=["lg_inc"],
                        compute_id=9100 + int(si), global_range=n,
                        local_range=local_range))
                got = fe.warmup(scratch)
                reply = {"op": "warmed", "warmed": got["warmed"],
                         "device": devs[0].kind}
            elif op == "serve":
                reply = op_serve(cmd)
            elif op == "run":
                reply = op_run(cmd)
            elif op == "value":
                reply = op_value(cmd)
            elif op == "reqtrace":
                reply = op_reqtrace(cmd)
            elif op == "stats":
                reply = {"op": "stats", "stats": {
                    k: v for k, v in fe.stats().items()
                    if k in ("queue_depth", "dispatcher_alive",
                             "requests_done", "batches")}}
            elif op == "exit":
                print(json.dumps({"op": "bye"}), flush=True)
                break
            else:
                reply = {"op": "error", "error": f"bad op {op!r}"}
            print(json.dumps(reply), flush=True)
    finally:
        fe.close(drain=False)
        cr.dispose()


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    main(
        argv[0] if len(argv) > 0 else "m0",
        int(argv[1]) if len(argv) > 1 else 1 << 13,
        int(argv[2]) if len(argv) > 2 else 64,
        int(argv[3]) if len(argv) > 3 else 0,
        float(argv[4]) if len(argv) > 4 else 4.0,
        cpu="--cpu" in sys.argv[1:],
    )
