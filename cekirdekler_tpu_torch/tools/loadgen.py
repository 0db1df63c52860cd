"""Serving-tier load generator: N concurrent clients against one
``ServeFrontend``, open- or closed-loop, or against a ``ServeFabric`` of
shards.

The port's counterpart of the reference's ``tools/loadgen.py``, over the
port's serving tier (``serve/``).  Its clients, workload, counters and
result keys are the reference's; the lanes are the card's unless the
caller gives host lanes (``devices=`` in Python, ``--cpu`` on the command
line).  The reference's bench sections (``loadgen_section``,
``fabric_section``) are not here: the port has no benchmark yet.  From the
repository root::

    python -m cekirdekler_tpu_torch.tools.loadgen                 # closed loop on the card
    python -m cekirdekler_tpu_torch.tools.loadgen --mode open --rate 6400
    python -m cekirdekler_tpu_torch.tools.loadgen --mode chaos
    python -m cekirdekler_tpu_torch.tools.loadgen --fabric 2 --mode chaos
    python -m cekirdekler_tpu_torch.tools.loadgen --cpu --n 4096 --json

- **closed loop**: every client submits its next request only after the
  previous one resolved — the latency-under-concurrency measurement
  (``p50_ms`` / ``p99_ms``).
- **open loop**: clients submit at a fixed per-client rate without
  waiting (rejections count, retries honor ``retry_after_s``) — the
  goodput measurement (``goodput_rps``: completed requests per second
  of wall).

Either way the run reports the **coalescing evidence**: requests against
the ladder dispatches actually paid (fused windows + per-call
iterations, read as ``ck_fused_*`` counter deltas) as
``coalesce_ratio``, and checks the workload bit for bit: every
signature's array must equal its completed-request count, since the
``lg_inc`` kernel adds exactly 1.0f a request and so makes a lost or
duplicated request visible as an integer.

``--fabric N`` shards the front-end: the same closed-loop workload runs
against N shards (:func:`run_fabric_mp`, one worker process a shard,
:mod:`.fabric_worker`) and, for ``--mode chaos``, against an in-process
:class:`~..serve.ServeFabric` with a seeded mid-run member kill whose
queued requests must re-route onto the survivors bit for bit
(:func:`run_fabric_chaos`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: The workload kernel: +1.0f per request — small-integer f32 math is
#: exact, so the post-run check can demand bit equality between each
#: array and its signature's completed-request count.
LOADGEN_SRC = """
__kernel void lg_inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""

#: The reference's default seeded chaos plan (``--mode chaos``):
#: bounded driver-submit failures (blast-radius containment + retry
#: budgets), one lane stalling at barriers, and one slow link.  The lane
#: clauses select lane 1, so on one lane only the driver-submit clause
#: can fire.
CHAOS_PLAN = ("seed=42;driver-submit:after=2,times=3;"
              "lane-stall@lane1:delay_ms=25,times=3;"
              "slow-link@lane1:factor=3,times=10")

#: The serving layer's own chaos plan: seeded serve-dispatch faults,
#: which fire before anything of a dispatch part reaches a lane, on any
#: number of lanes.
SERVE_CHAOS_PLAN = "seed=7;serve-dispatch:p=0.3,times=24"


def _lanes(devices):
    """The lanes a run takes: the caller's (at most two, as the
    reference's tool takes), else the card."""
    from ..hardware import all_devices

    devs = devices if devices is not None else \
        all_devices().gpus().require_nonempty("a CUDA device")
    return devs.subset(min(2, len(devs)) or 1)


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ASCENDING list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def _run_anatomy(t_wall0: float) -> dict:
    """Fold this run's request-lifecycle events (obs/reqtrace.py) into
    the tail-anatomy block every run result carries: the p50/p95/p99
    per-phase decomposition plus the p99 queue/device fractions.  The
    recorder ring is process-global, so the fold is wall-clock-bounded
    to ``t_wall0``: earlier runs' events must not blend in."""
    from ..obs.reqtrace import REQTRACE, fold_phases, phase_fracs, tail_anatomy

    events = [e for e in REQTRACE.snapshot() if e.t >= t_wall0]
    records = [r for r in fold_phases(events) if r["outcome"] == "resolved"]
    anatomy = tail_anatomy(records)
    fr: dict = {}
    p99 = anatomy["pcts"].get("p99")
    if p99 is not None:
        by_rid = {r["rid"]: r for r in records}
        fr = phase_fracs(by_rid[p99["rid"]])
    return {
        "anatomy": anatomy,
        "p99_queue_frac": fr.get("queue_frac"),
        "p99_device_frac": fr.get("device_frac"),
    }


def _print_anatomy(out: dict, label: str = "") -> None:
    """Render a run result's tail-anatomy table."""
    anatomy = out.get("anatomy")
    if not isinstance(anatomy, dict) or not anatomy.get("count"):
        return
    from ..obs.reqtrace import anatomy_table

    suffix = f" ({label})" if label else ""
    print(f"  -- tail anatomy{suffix} --")
    for line in anatomy_table(anatomy).splitlines():
        print(f"  {line}")


def run_loadgen(
    devices=None,
    clients: int = 32,
    tenants: int = 4,
    signatures: int = 4,
    requests_per_client: int = 8,
    mode: str = "closed",
    rate_rps: float = 200.0,
    n: int = 1 << 14,
    local_range: int = 64,
    gather_window_s: float = 0.004,
    max_batch: int = 512,
    quota: int = 0,
    max_queue_depth: int = 0,
    max_retries: int = 50,
    resilience=None,
    pin_sig: bool = False,
) -> dict:
    """One load-generator run (see module docstring).  Returns the
    result dict with p50/p99 latency, goodput, the coalescing evidence,
    and the exactness check.  Under an armed fault plan the result also
    carries the chaos evidence: ``hangs`` (futures that never resolved
    — must be 0), ``unnamed_failures`` (failures without a framework-
    named cause — must be 0), and ``failure_causes``; every rejection's
    reason is counted in ``reject_reasons``.  The frontend is named
    ``loadgen-<mode>`` (its ``/servez`` row)."""
    import numpy as np

    from .. import ClArray, NumberCruncher
    from ..errors import CekirdeklerError
    from ..metrics.registry import REGISTRY
    from ..serve import AdmissionController, ServeFrontend, ServeJob, ServeRejected

    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be closed|open, got {mode!r}")
    devs = _lanes(devices)
    clients = max(1, int(clients))
    tenants = max(1, int(tenants))
    signatures = max(1, int(signatures))
    total_target = clients * max(1, int(requests_per_client))

    cr = NumberCruncher(devs, LOADGEN_SRC)
    arrays = []
    jobs = []
    for s in range(signatures):
        a = ClArray(np.zeros(n, np.float32), name=f"lg{s}")
        a.partial_read = True
        arrays.append(a)
        jobs.append(ServeJob(
            params=[a], kernels=["lg_inc"], compute_id=9100 + s,
            global_range=n, local_range=local_range,
        ))
    admission = AdmissionController(
        max_queue_depth=(int(max_queue_depth) if max_queue_depth
                         else max(64, 4 * total_target)),
        default_quota=(int(quota) if quota else max(8, total_target)),
        health=cr.cores.health.healthy,
    )
    fe = ServeFrontend(
        cr, admission=admission, max_batch=max_batch,
        gather_window_s=gather_window_s, name=f"loadgen-{mode}",
        resilience=resilience,
    )

    m_windows = REGISTRY.counter(
        "ck_fused_windows_total", "fused ladder dispatch batches")
    m_iters = REGISTRY.counter(
        "ck_fused_iters_total", "iterations dispatched via fused ladders")
    w0, i0 = m_windows.value, m_iters.value

    latencies: list[float] = []
    completed_per_sig = [0] * signatures
    rejected = [0]
    reject_reasons: dict = {}
    retries_exhausted = [0]
    failed = [0]
    hangs = [0]
    unnamed = [0]
    failure_causes: dict = {}
    mu = threading.Lock()

    def submit_with_retry(tenant: str, job: ServeJob):
        """Submit honoring retry-after (the admission contract's client
        half); returns the future or None when retries ran out."""
        for _ in range(max(1, int(max_retries))):
            try:
                return fe.submit(tenant, job)
            except ServeRejected as e:
                with mu:
                    rejected[0] += 1
                    reject_reasons[e.reason] = reject_reasons.get(e.reason, 0) + 1
                time.sleep(min(e.retry_after_s, 0.25))
        with mu:
            retries_exhausted[0] += 1
        return None

    from concurrent.futures import TimeoutError as _FutTimeout

    def note_done(fut, sig_idx: int):
        try:
            r = fut.result(timeout=60.0)
        except (TimeoutError, _FutTimeout):
            # the one outcome chaos must NEVER produce: a future that
            # does not resolve (counted separately from failures)
            with mu:
                hangs[0] += 1
            return
        except Exception as e:  # noqa: BLE001 - counted, checked below
            with mu:
                failed[0] += 1
                cause = type(e).__name__
                failure_causes[cause] = failure_causes.get(cause, 0) + 1
                if not isinstance(e, CekirdeklerError):
                    unnamed[0] += 1
            return
        with mu:
            latencies.append(r["latency_s"])
            completed_per_sig[sig_idx] += 1

    def client_closed(ci: int):
        tenant = f"t{ci % tenants}"
        for k in range(int(requests_per_client)):
            # pin_sig: one (tenant, signature) pair per client — the
            # fabric comparison's workload shape
            sig_idx = ((ci // tenants) % signatures if pin_sig
                       else (ci + k) % signatures)
            fut = submit_with_retry(tenant, jobs[sig_idx])
            if fut is not None:
                note_done(fut, sig_idx)

    def client_open(ci: int):
        tenant = f"t{ci % tenants}"
        period = 1.0 / max(rate_rps / clients, 1e-3)
        pending = []
        for k in range(int(requests_per_client)):
            sig_idx = (ci + k) % signatures
            fut = submit_with_retry(tenant, jobs[sig_idx])
            if fut is not None:
                pending.append((fut, sig_idx))
            time.sleep(period)
        for fut, sig_idx in pending:
            note_done(fut, sig_idx)

    body = client_closed if mode == "closed" else client_open
    threads = [
        threading.Thread(target=body, args=(ci,), daemon=True,
                         name=f"lg-client-{ci}")
        for ci in range(clients)
    ]
    t_wall0 = time.time()  # reqtrace fold bound (see _run_anatomy)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    wall_s = time.perf_counter() - t0
    stuck = sum(t.is_alive() for t in threads)

    try:
        fe.close()
        # exactness: every signature's array must equal its completed
        # count exactly (each completed request applied +1 once)
        checked = stuck == 0 and all(
            bool(np.all(np.asarray(arrays[s]) == float(completed_per_sig[s])))
            for s in range(signatures)
        )
    finally:
        cr.dispose()

    completed = sum(completed_per_sig)
    windows = int(m_windows.value - w0)
    fused_iters = int(m_iters.value - i0)
    per_call = max(0, completed - fused_iters)
    launches = windows + per_call
    lat_ms = sorted(v * 1000.0 for v in latencies)
    return {
        "mode": mode,
        "lanes": [d.kind for d in devs],
        "clients": clients,
        "tenants": tenants,
        "signatures": signatures,
        "n": int(n),
        "requests_target": total_target,
        "completed": completed,
        "failed": failed[0],
        "hangs": hangs[0] + stuck,
        "unnamed_failures": unnamed[0],
        "failure_causes": dict(sorted(failure_causes.items())),
        "rejected": rejected[0],
        "reject_reasons": dict(sorted(reject_reasons.items())),
        "retries_exhausted": retries_exhausted[0],
        "wall_s": wall_s,
        "p50_ms": _percentile(lat_ms, 0.50),
        "p99_ms": _percentile(lat_ms, 0.99),
        "goodput_rps": completed / wall_s if wall_s > 0 else None,
        # the coalescing evidence: ladder dispatches actually paid vs
        # requests served (windows = fused ladder batches, per_call =
        # iterations that rode the per-call path)
        "fused_windows": windows,
        "fused_iters": fused_iters,
        "per_call_iters": per_call,
        "ladder_launches": launches,
        "coalesce_ratio": completed / launches if launches > 0 else None,
        "coalesced": launches < completed,
        "checked": checked,
        **_run_anatomy(t_wall0),
    }


def run_chaos(devices=None, clients: int = 32, tenants: int = 4,
              signatures: int = 4, requests_per_client: int = 4,
              plan: str = CHAOS_PLAN, n: int = 1 << 13,
              goodput_floor: float = 0.5, local_range: int = 64) -> dict:
    """The chaos drill: run the closed-loop workload fault-free (the
    control), then again under the seeded ``plan``, and check the four
    chaos contracts:

    - **no hangs** — every submitted future resolves;
    - **bit-exact** — every signature's array equals its successful
      count exactly (containment: a faulted request's iterations never
      half-apply);
    - **named failures** — every failure carries a framework-named
      cause (never a bare exception from the middle of a batch);
    - **goodput retained** — chaos goodput / control goodput clears
      ``goodput_floor``.

    ``checked`` is the conjunction."""
    from ..utils.faultinject import FAULTS

    # untimed warmup: the builds are process-global, so without this
    # the control run pays them and the chaos run does not
    run_loadgen(devices, clients=4, tenants=tenants,
                signatures=signatures, requests_per_client=1,
                mode="closed", n=n, local_range=local_range)
    control = run_loadgen(
        devices, clients=clients, tenants=tenants,
        signatures=signatures, requests_per_client=requests_per_client,
        mode="closed", n=n, local_range=local_range)
    FAULTS.arm(plan)
    try:
        chaos = run_loadgen(
            devices, clients=clients, tenants=tenants,
            signatures=signatures,
            requests_per_client=requests_per_client, mode="closed", n=n,
            local_range=local_range)
        fired = sum(c["fired"] for c in FAULTS.snapshot()["clauses"])
    finally:
        FAULTS.disarm()
    frac = None
    if control.get("goodput_rps") and chaos.get("goodput_rps"):
        frac = chaos["goodput_rps"] / control["goodput_rps"]
    checked = bool(
        control["checked"] and chaos["checked"]
        and chaos["hangs"] == 0 and chaos["unnamed_failures"] == 0
        and frac is not None and frac >= float(goodput_floor))
    return {
        "plan": plan,
        "fired": fired,
        "goodput_frac": frac,
        "goodput_floor": goodput_floor,
        "chaos_p99_ms": chaos["p99_ms"],
        "hangs": chaos["hangs"],
        "failed": chaos["failed"],
        "unnamed_failures": chaos["unnamed_failures"],
        "failure_causes": chaos["failure_causes"],
        "checked": checked,
        "control": control,
        "chaos": chaos,
    }


def run_fabric(
    devices=None,
    fabric: int = 3,
    clients: int = 128,
    tenants: int = 8,
    signatures: int = 4,
    requests_per_client: int = 4,
    n: int = 1 << 13,
    local_range: int = 64,
    gather_window_s: float = 0.004,
    max_batch: int = 512,
    max_retries: int = 50,
    kill: bool = False,
    kill_after_frac: float = 0.25,
    seed: int = 2017,
    cycle_log: list | None = None,
) -> dict:
    """One closed-loop run against an in-process ``ServeFabric`` of
    ``fabric`` member shards, each its own ``NumberCruncher`` over
    ``devices`` (the card by default: every shard's ``Cores`` then has
    its own lanes, streams and graphs on the one card).  Every (tenant,
    signature) pair owns its OWN array — the router places each such
    job on exactly one shard, so no array is ever written by two
    dispatchers and the exactness check stays bit-level.

    With ``kill``, a seeded victim member is removed (no drain) once
    ``kill_after_frac`` of the target requests completed and the victim
    holds queued work (waited for up to 2 s) — the mid-run preemption
    drill.  Its queued requests fail with named
    clean-shutdown errors and the fabric re-routes them onto ring
    survivors; the contracts (zero hangs, named failures only,
    bit-exact arrays) are reported alongside the latency/goodput
    numbers.  ``cycle_log``, when given, receives one ``(member, t0,
    t1)`` row (``perf_counter`` seconds) per dispatch cycle that
    dispatched something: the evidence that shards' windows ran at the
    same time."""
    import random as _random

    import numpy as np

    from .. import ClArray, NumberCruncher
    from ..errors import CekirdeklerError
    from ..metrics.registry import REGISTRY
    from ..serve import ServeFabric, ServeJob, ServeRejected

    devs = _lanes(devices)
    fabric = max(1, int(fabric))
    clients = max(1, int(clients))
    tenants = max(1, int(tenants))
    signatures = max(1, int(signatures))
    total_target = clients * max(1, int(requests_per_client))
    members = [f"m{i}" for i in range(fabric)]

    crunchers = {m: NumberCruncher(devs, LOADGEN_SRC) for m in members}
    fab = ServeFabric(
        crunchers, max_batch=max_batch, gather_window_s=gather_window_s,
        name="lg-fabric")
    if cycle_log is not None:
        for m, fe in fab.shards.items():
            fe.step = _logged_step(fe.step, m, cycle_log)
    arrays: dict = {}
    jobs: dict = {}
    for ti in range(tenants):
        for si in range(signatures):
            a = ClArray(np.zeros(n, np.float32), name=f"lgf{ti}_{si}")
            a.partial_read = True
            arrays[(ti, si)] = a
            jobs[(ti, si)] = ServeJob(
                params=[a], kernels=["lg_inc"],
                compute_id=9200 + ti * signatures + si,
                global_range=n, local_range=local_range,
            )

    m_windows = REGISTRY.counter(
        "ck_fused_windows_total", "fused ladder dispatch batches")
    m_reroutes = REGISTRY.counter(
        "ck_serve_fabric_reroutes_total",
        "in-flight requests re-routed onto ring survivors after a "
        "member preemption (budget-gated, clean failures only)")
    m_diverted = REGISTRY.counter(
        "ck_serve_fabric_diversions_total",
        "fabric routes diverted off their ring owner by the "
        "shard-health view")
    w0 = m_windows.value
    r0, d0 = m_reroutes.value, m_diverted.value

    latencies: list[float] = []
    completed: dict = {k: 0 for k in jobs}
    rejected = [0]
    retries_exhausted = [0]
    failed = [0]
    hangs = [0]
    unnamed = [0]
    failure_causes: dict = {}
    mu = threading.Lock()
    kill_trigger = threading.Event()
    kill_threshold = max(1, int(total_target * float(kill_after_frac)))
    victim = _random.Random(seed).choice(members) if kill else None
    killed_at = [None]

    def submit_with_retry(tenant: str, job):
        for _ in range(max(1, int(max_retries))):
            try:
                return fab.submit(tenant, job)
            except ServeRejected as e:
                with mu:
                    rejected[0] += 1
                time.sleep(min(e.retry_after_s, 0.25))
            except CekirdeklerError as e:
                # a shard dying between route and submit surfaces here
                # when re-route budgets are spent — named, retried
                with mu:
                    rejected[0] += 1
                    cause = type(e).__name__
                    failure_causes[cause] = failure_causes.get(cause, 0) + 1
                time.sleep(0.01)
        with mu:
            retries_exhausted[0] += 1
        return None

    from concurrent.futures import TimeoutError as _FutTimeout

    def note_done(fut, key):
        try:
            r = fut.result(timeout=60.0)
        except (TimeoutError, _FutTimeout):
            with mu:
                hangs[0] += 1
            return
        except Exception as e:  # noqa: BLE001 - counted, checked below
            with mu:
                failed[0] += 1
                cause = type(e).__name__
                failure_causes[cause] = failure_causes.get(cause, 0) + 1
                if not isinstance(e, CekirdeklerError):
                    unnamed[0] += 1
            return
        with mu:
            latencies.append(r["latency_s"])
            completed[key] += 1
            if sum(completed.values()) >= kill_threshold:
                kill_trigger.set()

    def client_closed(ci: int):
        ti = ci % tenants
        tenant = f"t{ti}"
        for k in range(int(requests_per_client)):
            key = (ti, (ci + k) % signatures)
            fut = submit_with_retry(tenant, jobs[key])
            if fut is not None:
                note_done(fut, key)

    def killer():
        kill_trigger.wait(timeout=120.0)
        # the kill lands while the victim holds queued work (up to 2 s):
        # a kill between a cycle's pop and the clients' next submits
        # would find nothing to re-route
        fe = fab.shards.get(victim)
        t_end = time.perf_counter() + 2.0
        while fe is not None and fe.stats()["queue_depth"] == 0 \
                and time.perf_counter() < t_end:
            time.sleep(0.0005)
        killed_at[0] = sum(completed.values())
        fab.remove_member(victim, drain=False)

    threads = [
        threading.Thread(target=client_closed, args=(ci,), daemon=True,
                         name=f"lgf-client-{ci}")
        for ci in range(clients)
    ]
    if victim is not None:
        threads.append(threading.Thread(
            target=killer, daemon=True, name="lgf-killer"))
    t_wall0 = time.time()  # reqtrace fold bound (see _run_anatomy)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    wall_s = time.perf_counter() - t0
    stuck = sum(t.is_alive() for t in threads)

    try:
        fab.close()
        checked = stuck == 0 and all(
            bool(np.all(np.asarray(arrays[k]) == float(completed[k])))
            for k in jobs
        )
    finally:
        for cr in crunchers.values():
            cr.dispose()

    done = sum(completed.values())
    lat_ms = sorted(v * 1000.0 for v in latencies)
    return {
        "fabric": fabric,
        "members": members,
        "lanes": [d.kind for d in devs],
        "killed": victim,
        "killed_at_completed": killed_at[0],
        "clients": clients,
        "tenants": tenants,
        "signatures": signatures,
        "n": int(n),
        "requests_target": total_target,
        "completed": done,
        "failed": failed[0],
        "hangs": hangs[0] + stuck,
        "unnamed_failures": unnamed[0],
        "failure_causes": dict(sorted(failure_causes.items())),
        "rejected": rejected[0],
        "retries_exhausted": retries_exhausted[0],
        "reroutes": int(m_reroutes.value - r0),
        "diversions": int(m_diverted.value - d0),
        "wall_s": wall_s,
        "p50_ms": _percentile(lat_ms, 0.50),
        "p99_ms": _percentile(lat_ms, 0.99),
        "goodput_rps": done / wall_s if wall_s > 0 else None,
        "fused_windows": int(m_windows.value - w0),
        "checked": checked,
        **_run_anatomy(t_wall0),
    }


def _logged_step(step, member: str, log: list):
    """A shard's ``step`` that appends ``(member, t0, t1)`` for every
    cycle that dispatched a batch (list appends are atomic)."""
    def logged():
        t0 = time.perf_counter()
        out = step()
        if out.get("batches"):
            log.append((member, t0, time.perf_counter()))
        return out
    return logged


def overlapping_cycles(log: list) -> int:
    """How many pairs of dispatch cycles of different members overlap in
    time, over a :func:`run_fabric` ``cycle_log``."""
    rows = sorted(log, key=lambda r: r[1])
    n = 0
    for i, (m, a0, a1) in enumerate(rows):
        for m2, b0, _b1 in rows[i + 1:]:
            if b0 >= a1:
                break
            if m2 != m:
                n += 1
    return n


def _spawn_fabric_worker(member: str, n: int, local_range: int,
                        max_queue_depth: int = 0,
                        gather_window_ms: float = 4.0, cpu: bool = False,
                        ready_timeout_s: float = 120.0):
    """Start one :mod:`.fabric_worker` shard process (a fresh
    interpreter, never a fork of a process with CUDA up) and block until
    its READY line; killed on a failed start."""
    cmd = [sys.executable, "-m", "cekirdekler_tpu_torch.tools.fabric_worker",
           str(member), str(int(n)), str(int(local_range)),
           str(int(max_queue_depth)), str(float(gather_window_ms))]
    if cpu:
        cmd.append("--cpu")
    proc = subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT))
    deadline = time.monotonic() + ready_timeout_s
    ready: list = []

    def read_ready():
        for line in proc.stdout:
            if line.startswith("FABRIC_READY"):
                ready.append(line)
                return

    t = threading.Thread(target=read_ready, daemon=True)
    t.start()
    t.join(timeout=max(0.0, deadline - time.monotonic()))
    if not ready:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(
            f"fabric worker {member} never came up (rc={proc.poll()})")
    return proc


def _worker_rpc(proc, cmd: dict, timeout_s: float = 300.0) -> dict:
    """One JSON command → one JSON reply on a worker's pipes, the wait
    bounded by ``timeout_s`` (the worker is killed past it)."""
    proc.stdin.write(json.dumps(cmd, allow_nan=False) + "\n")
    proc.stdin.flush()
    box: list = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if not box:
        proc.kill()
        raise RuntimeError(
            f"fabric worker gave no reply to {cmd.get('op')!r} within "
            f"{timeout_s} s")
    if not box[0]:
        raise RuntimeError(
            f"fabric worker died mid-command {cmd.get('op')!r} "
            f"(rc={proc.poll()})")
    return json.loads(box[0])


def run_fabric_mp(
    devices=None,
    fabric: int = 3,
    clients: int = 128,
    tenants: int = 8,
    signatures: int = 4,
    requests_per_client: int = 4,
    n: int = 1 << 13,
    local_range: int = 64,
    max_queue_depth: int = 0,
    gather_window_ms: float | None = None,
) -> dict:
    """The multi-process fabric run: N shard worker processes
    (:mod:`.fabric_worker`, each its own interpreter, dispatcher and
    lanes), the parent placing every (tenant, signature) pair on its
    owning member via the SAME pure ``route_decision`` the in-process
    fabric uses, then all shards serving their closed-loop clients
    concurrently.  The workers take the card unless ``devices`` are host
    lanes; on one card the N workers share it."""
    from ..serve import route_decision

    cpu = devices is not None and all(d.is_cpu for d in devices)
    fabric = max(1, int(fabric))
    clients = max(1, int(clients))
    tenants = max(1, int(tenants))
    signatures = max(1, int(signatures))
    requests = max(1, int(requests_per_client))
    members = [f"m{i}" for i in range(fabric)]

    # the pinned-signature client population: client ci → tenant
    # ci % tenants, signature (ci // tenants) % signatures — each
    # (tenant, signature) pair lands whole on one shard
    combo_clients: dict = {}
    for ci in range(clients):
        key = (ci % tenants, (ci // tenants) % signatures)
        combo_clients[key] = combo_clients.get(key, 0) + 1
    placements: dict = {}
    assignments: dict = {m: [] for m in members}
    for (ti, si), n_clients in sorted(combo_clients.items()):
        sig_key = (f"cid{9100 + si}|lg_inc|{int(n)}x{int(local_range)}+0")
        out = route_decision(f"t{ti}", sig_key, members)
        placements[f"t{ti}/s{si}"] = out["shard"]
        assignments[out["shard"]].append(
            [f"t{ti}", si, n_clients, requests])

    # equal-batch-size normalization: a shard sees ~1/N of the client
    # population, so it gathers ~N× longer to fill the same batch
    if gather_window_ms is None:
        gather_window_ms = 4.0 * fabric
    procs: dict = {}
    merged: dict = {
        "fabric": fabric,
        "members": members,
        "clients": clients,
        "tenants": tenants,
        "signatures": signatures,
        "requests_target": clients * requests,
        "completed": 0, "failed": 0, "hangs": 0,
        "unnamed_failures": 0, "failure_causes": {}, "rejected": 0,
        "checked": True,
        "placements": placements,
        "devices": {},
    }
    lat_ms: list = []
    wall_s = 0.0
    try:
        for m in members:
            procs[m] = _spawn_fabric_worker(m, n, local_range,
                                           max_queue_depth=max_queue_depth,
                                           gather_window_ms=gather_window_ms,
                                           cpu=cpu)
        # warm every shard's owned ladder set before the timed section
        for m in members:
            sigs = sorted({si for _, si, _, _ in assignments[m]})
            if sigs:
                got = _worker_rpc(procs[m], {"op": "warm", "sigs": sigs})
                merged["devices"][m] = got.get("device")
        replies: dict = {}
        errs: list = []

        def drive(m: str):
            try:
                replies[m] = _worker_rpc(
                    procs[m], {"op": "serve", "assignments": assignments[m]})
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(f"{m}: {e}")

        threads = [threading.Thread(target=drive, args=(m,), daemon=True)
                   for m in members if assignments[m]]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        wall_s = time.perf_counter() - t0
        if errs:
            raise RuntimeError("fabric workers failed: " + "; ".join(errs))
        for m, r in replies.items():
            merged["completed"] += r["completed"]
            merged["failed"] += r["failed"]
            merged["hangs"] += r["hangs"]
            merged["unnamed_failures"] += r["unnamed_failures"]
            merged["rejected"] += r["rejected"]
            merged["checked"] = bool(merged["checked"] and r["checked"])
            for k, v in r["failure_causes"].items():
                merged["failure_causes"][k] = \
                    merged["failure_causes"].get(k, 0) + v
            lat_ms.extend(r["latencies_ms"])
    finally:
        for m, p in procs.items():
            try:
                _worker_rpc(p, {"op": "exit"}, timeout_s=10.0)
            except Exception:  # noqa: BLE001 - teardown must proceed
                pass
            try:
                p.wait(timeout=10.0)
            except Exception:  # noqa: BLE001 - teardown must proceed
                p.kill()
                p.wait(timeout=30.0)
    lat_ms.sort()
    merged["wall_s"] = wall_s
    merged["p50_ms"] = _percentile(lat_ms, 0.50)
    merged["p99_ms"] = _percentile(lat_ms, 0.99)
    merged["goodput_rps"] = (merged["completed"] / wall_s
                             if wall_s > 0 else None)
    merged["failure_causes"] = dict(sorted(merged["failure_causes"].items()))
    return merged


def run_fabric_chaos(devices=None, fabric: int = 3, clients: int = 64,
                     tenants: int = 8, signatures: int = 4,
                     requests_per_client: int = 4, n: int = 1 << 13,
                     goodput_floor: float = 0.4, seed: int = 2017,
                     local_range: int = 64) -> dict:
    """The cluster chaos drill: the fabric workload runs kill-free (the
    control), then again with a seeded mid-run member kill, and the four
    fabric chaos contracts are checked:

    - **no hangs** — every outer future resolves (a preempted shard's
      requests re-route, they never strand);
    - **bit-exact** — every (tenant, signature) array equals its
      completed count exactly (only never-dispatched work re-routes,
      so nothing double-applies);
    - **named failures** — every failure is a framework-named error
      (clean shutdown / typed rejection), never a bare exception;
    - **goodput retained** — killed-run goodput / control goodput
      clears ``goodput_floor``.

    ``checked`` is the conjunction."""
    kw = dict(fabric=fabric, tenants=tenants, signatures=signatures, n=n,
              local_range=local_range)
    # untimed warmup: the builds are process-global; without it the
    # control run pays them and the killed run does not
    run_fabric(devices, clients=4, requests_per_client=1, **kw)
    control = run_fabric(devices, clients=clients,
                         requests_per_client=requests_per_client, **kw)
    killed = run_fabric(devices, clients=clients,
                        requests_per_client=requests_per_client, kill=True,
                        seed=seed, **kw)
    frac = None
    if control.get("goodput_rps") and killed.get("goodput_rps"):
        frac = killed["goodput_rps"] / control["goodput_rps"]
    checked = bool(
        control["checked"] and killed["checked"]
        and control["hangs"] == 0 and killed["hangs"] == 0
        and killed["unnamed_failures"] == 0
        and frac is not None and frac >= float(goodput_floor))
    return {
        "fabric": fabric,
        "killed_member": killed["killed"],
        "goodput_frac": frac,
        "goodput_floor": goodput_floor,
        "killed_p99_ms": killed["p99_ms"],
        "hangs": killed["hangs"],
        "failed": killed["failed"],
        "unnamed_failures": killed["unnamed_failures"],
        "failure_causes": killed["failure_causes"],
        "reroutes": killed["reroutes"],
        "checked": checked,
        "control": control,
        "killed": killed,
    }


def main(argv=None) -> int:
    from .. import all_devices
    from ..utils.jsonsafe import json_safe

    ap = argparse.ArgumentParser(
        prog="python -m cekirdekler_tpu_torch.tools.loadgen",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--signatures", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client")
    ap.add_argument("--mode", choices=("closed", "open", "chaos"),
                    default="closed")
    ap.add_argument("--plan", default=CHAOS_PLAN,
                    help="chaos mode: the seeded CK_FAULTS plan string (the "
                         "reference's by default; on one lane its lane "
                         f"clauses never fire, {SERVE_CHAOS_PLAN!r} does)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="open-loop aggregate submit rate (rps)")
    ap.add_argument("--n", type=int, default=1 << 14,
                    help="work items per job")
    ap.add_argument("--local-range", type=int, default=64)
    ap.add_argument("--quota", type=int, default=0,
                    help="per-tenant in-flight quota (0 = generous)")
    ap.add_argument("--fabric", type=int, default=0,
                    help="shard the front-end across N fabric members "
                         "(0 = single frontend); --mode chaos runs the "
                         "seeded in-process kill-and-reroute drill, "
                         "otherwise one worker process a shard")
    ap.add_argument("--cpu", action="store_true",
                    help="two host lanes instead of the card")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    devices = all_devices().cpus(2) if args.cpu else None
    if args.fabric > 0:
        if args.mode == "chaos":
            out = run_fabric_chaos(
                devices, fabric=args.fabric, clients=args.clients,
                tenants=args.tenants, signatures=args.signatures,
                requests_per_client=args.requests, n=args.n,
                local_range=args.local_range)
        else:
            out = run_fabric_mp(
                devices, fabric=args.fabric, clients=args.clients,
                tenants=args.tenants, signatures=args.signatures,
                requests_per_client=args.requests, n=args.n,
                local_range=args.local_range)
    elif args.mode == "chaos":
        out = run_chaos(
            devices, clients=args.clients, tenants=args.tenants,
            signatures=args.signatures, requests_per_client=args.requests,
            plan=args.plan, n=args.n, local_range=args.local_range)
    else:
        out = run_loadgen(
            devices, clients=args.clients, tenants=args.tenants,
            signatures=args.signatures, requests_per_client=args.requests,
            mode=args.mode, rate_rps=args.rate, n=args.n,
            local_range=args.local_range, quota=args.quota)
    if args.json:
        print(json.dumps(json_safe(out), allow_nan=False))
        return 0 if out.get("checked", True) else 1
    nested = ("control", "chaos", "killed")
    rows = {k: v for k, v in out.items()
            if not (k in nested and isinstance(v, dict)) and k != "anatomy"}
    for k, v in rows.items():
        print(f"  {k:>20}: {v}")
    if "anatomy" in out:
        _print_anatomy(out)
    else:
        for name in nested:
            sub = out.get(name)
            if isinstance(sub, dict) and "anatomy" in sub:
                _print_anatomy(sub, label=name)
    if not out.get("checked", True):
        print("  EXACTNESS CHECK FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
