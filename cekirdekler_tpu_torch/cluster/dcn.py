"""Multi-process DCN tier over ``torch.distributed``.

The port's counterpart of the reference's ``cluster/dcn.py``: the same
``compute()`` surface as :class:`ClusterAccelerator`, but spanning the N
*processes* of a ``torch.distributed`` process group.  Each process
computes its balanced share on its own lanes through a local
:class:`NumberCruncher`, and the written ranges are exchanged with
**gloo collectives on host bytes** instead of the TCP tier's hand-framed
sockets.  The TCP tier (``accelerator.py``/``server.py``) stays the
fallback for hosts outside a process group.

Reference analogue: ``ClusterAccelerator.compute()``
(ClusterAccelerator.cs:170-355) driving remote ``Cores`` over
``NetworkBuffer`` marshaling (ClCruncherServerThread.cs:147-250).  The
reference's design rules hold unchanged:

- **SPMD, not master/worker**: every process runs the same program and the
  same balancer arithmetic on identically all-gathered timings, so the
  per-compute-id splits agree everywhere without a control channel.
- **Step-quantized shares**: per-process step = local lane count x
  local_range; the LCM-step :class:`ClusterLoadBalancer` is reused as-is.
  The remainder share goes to process 0 (the reference's "mainframe").
- **write_all single-owner rule**: process 0 owns write_all arrays
  (:meth:`DistributedAccelerator._broadcast0`), as remote TCP nodes never
  return write_all payloads (server.py).
- **Restart-shaped elasticity**: a process group cannot lose or add
  processes mid-run, so elasticity is preemption-shaped
  (``cluster/elastic.py``): the job checkpoints each window's partition
  state, a preempted job restarts (possibly with another lane count),
  resumes from the last complete window (:meth:`resume_elastic`) and
  records the membership change as replayable ``member-leave`` /
  ``member-join`` decisions.  A kill-and-rejoin run converges to the
  bit-identical image of an undisturbed one
  (tests/_torch_dcn_elastic_worker.py).

Where the port differs from the reference:

- **The transport.**  :func:`initialize` joins a ``gloo`` process group
  (``init_process_group("gloo", init_method="tcp://host:port")``) with a
  finite timeout, in place of ``jax.distributed``.  ``_allgather`` is
  ``dist.all_gather`` and ``_broadcast0`` ``dist.broadcast(src=0)``, both
  on the payload's raw bytes as a ``uint8`` CPU tensor, so int64 and
  float64 cross exactly, as the reference's raw-byte exchange does.
  Gloo, not NCCL: NCCL refuses two ranks on one card, and the arrays
  exchanged are host arrays.  NCCL across cards is ROADMAP work.
- **The lanes.**  ``local_devices=None`` means :func:`all_devices`, the
  CUDA cards; without one it raises
  :class:`~..errors.DeviceSelectionError` and never takes host lanes
  unasked (pass ``cpus(n)`` for those).

Testable without a card: 2 processes x 2 host lanes, and 3 processes x
(2, 1, 1), on gloo over loopback (tests/test_torch_dcn.py).
"""

from __future__ import annotations

import datetime
import time
import zlib
from typing import Sequence

import numpy as np

from ..arrays.clarray import ClArray, ParameterGroup
from ..core.cruncher import NumberCruncher
from ..errors import CekirdeklerError, ComputeValidationError
from ..hardware import Devices, all_devices
from ..metrics.registry import REGISTRY
from ..trace.spans import TRACER
from .accelerator import IComputeNode
from .balancer import ClusterLoadBalancer

__all__ = ["initialize", "DistributedAccelerator"]


def _dist():
    """``torch.distributed``, with the process group up."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise CekirdeklerError(
            "no torch.distributed process group: call "
            "cluster.dcn.initialize() in every process first")
    return dist


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    timeout_s: float = 120.0,
) -> None:
    """Join the job's ``gloo`` process group (idempotent).

    ``coordinator_address`` is ``host:port`` of the rendezvous (process 0
    listens there); every collective of the group, and the rendezvous
    itself, gives up after ``timeout_s``, so a peer that died or never
    came ends in an error and not a hang."""
    import torch.distributed as dist

    if dist.is_initialized():
        return  # already joined
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)),
    )


def _as_tensor(raw: np.ndarray):
    import torch

    return torch.from_numpy(raw if raw.flags.writeable else raw.copy())


class DistributedAccelerator(IComputeNode):
    """N host processes behaving as ONE device over gloo.

    Construct AFTER :func:`initialize` in every process of the job, then
    use exactly like a :class:`NumberCruncher`-backed node:
    ``setup_nodes(src)`` once, ``compute(...)`` per step.  Every process
    must make the same calls in the same order (SPMD) — the collectives
    inside are global.

    ``timing_hook(compute_id, share, wall_ms) -> float`` optionally
    replaces the measured local wall time fed to the balancer — the same
    deterministic-bench-injection seam ``benchrig.compute_path_proof``
    uses, because on shared cores wall time measures scheduler
    contention, not work.
    """

    def __init__(self, local_devices: Devices | None = None,
                 timing_hook=None):
        if local_devices is None:
            local_devices = all_devices()
        local_devices.require_nonempty(
            "DistributedAccelerator local_devices (the card unless given)")
        dist = _dist()
        self.pid = dist.get_rank()
        self.nproc = dist.get_world_size()
        self.local_devices = local_devices
        self.timing_hook = timing_hook
        self.cruncher: NumberCruncher | None = None
        self.kernel_source: str | None = None
        self.proc_device_counts: list[int] = []
        self.balancers: dict[int, ClusterLoadBalancer] = {}
        self.ranges: dict[int, list[int]] = {}
        self.timings: dict[int, list[float]] = {}

    # -- collective helpers --------------------------------------------------
    @staticmethod
    def _allgather(value: np.ndarray) -> np.ndarray:
        """Per-process all-gather -> ``[nproc, *value.shape]``: one
        ``dist.all_gather`` of the payload's raw bytes (every process must
        pass the same shape and dtype — the callers rectangularize).

        Payloads cross as raw bytes, so 64-bit host arrays (int64 above
        2^31, float64) arrive exactly, as the reference's do and as the TCP
        tier ships them."""
        import torch

        dist = _dist()
        _tt = TRACER.t0()
        _t0 = time.perf_counter()
        value = np.ascontiguousarray(value)
        raw = value.view(np.uint8)
        nproc = dist.get_world_size()
        out = torch.empty((nproc,) + raw.shape, dtype=torch.uint8)
        dist.all_gather(list(out.unbind(0)), _as_tensor(raw))
        gathered = out.numpy()
        REGISTRY.counter(
            "ck_dcn_exchange_bytes_total", "bytes moved over DCN collectives",
            op="allgather",
        ).inc(raw.nbytes * nproc)
        REGISTRY.histogram(
            "ck_dcn_exchange_seconds", "per-collective wall latency",
            op="allgather",
        ).observe(time.perf_counter() - _t0)
        TRACER.record(
            "dcn-exchange", _tt, tag=f"allgather {raw.nbytes}B x{nproc}"
        )
        return gathered.view(value.dtype).reshape((nproc,) + value.shape)

    @staticmethod
    def _broadcast0(value: np.ndarray) -> np.ndarray:
        """Process 0's copy, everywhere (write_all single-owner rule): one
        ``dist.broadcast(src=0)`` of the raw bytes."""
        dist = _dist()
        _tt = TRACER.t0()
        _t0 = time.perf_counter()
        value = np.ascontiguousarray(value)
        raw = value.view(np.uint8).copy()  # non-owners receive into it
        t = _as_tensor(raw)
        dist.broadcast(t, src=0)
        REGISTRY.counter(
            "ck_dcn_exchange_bytes_total", "bytes moved over DCN collectives",
            op="broadcast0",
        ).inc(raw.nbytes)
        REGISTRY.histogram(
            "ck_dcn_exchange_seconds", "per-collective wall latency",
            op="broadcast0",
        ).observe(time.perf_counter() - _t0)
        TRACER.record(
            "dcn-exchange", _tt, tag=f"broadcast0 {raw.nbytes}B"
        )
        return t.numpy().view(value.dtype).reshape(value.shape)

    def barrier(self, tag: str = "ck_dcn_barrier") -> None:
        """Cross-process sync point riding :meth:`_allgather`; the gathered
        tag hash doubles as the name-mismatch assertion."""
        h = np.asarray([zlib.crc32(tag.encode())], np.uint32)
        gathered = self._allgather(h)
        if not (gathered == h[0]).all():
            raise CekirdeklerError(
                f"barrier tag mismatch across processes ({tag!r}): "
                f"{gathered.reshape(-1).tolist()}")

    # -- IComputeNode --------------------------------------------------------
    def setup_nodes(self, kernel_source: str) -> None:
        """Build the kernel locally and agree on the per-process step
        table (reference: setupNodes, ClusterAccelerator.cs:364-443 —
        minus the socket handshake the rendezvous already did)."""
        self.kernel_source = kernel_source
        self.cruncher = NumberCruncher(self.local_devices, kernel_source)
        counts = self._allgather(
            np.asarray([len(self.local_devices)], np.int64)
        )
        self.proc_device_counts = [int(c) for c in counts.reshape(-1)]

    @property
    def num_nodes(self) -> int:
        return self.nproc

    def compute(
        self,
        kernel_names: str | Sequence[str],
        params: Sequence[ClArray],
        compute_id: int,
        global_range: int,
        local_range: int = 256,
        values=(),
    ) -> None:
        if self.cruncher is None:
            raise CekirdeklerError("setup_nodes() must run before compute()")
        names = (
            kernel_names.split()
            if isinstance(kernel_names, str)
            else list(kernel_names)
        )
        if global_range % local_range != 0:
            raise ComputeValidationError(
                f"global_range ({global_range}) must be divisible by "
                f"local_range ({local_range})"
            )
        params = list(params)

        # identical balancer state on every process: inputs are the
        # all-gathered timings of the previous call and the shared range
        # table, so the arithmetic below agrees without coordination
        bal = self.balancers.get(compute_id)
        if bal is None:
            steps = [c * local_range for c in self.proc_device_counts]
            bal = ClusterLoadBalancer(steps)
            self.balancers[compute_id] = bal
            shares, remainder = bal.equal_split(global_range)
        else:
            prev = self.ranges[compute_id]
            times = self.timings.get(compute_id, [1.0] * self.nproc)
            shares, remainder = bal.rebalance(prev, times, global_range)
        shares = list(shares)
        shares[0] += remainder  # process 0 is the mainframe
        refs = np.concatenate([[0], np.cumsum(shares)]).astype(int)
        self.ranges[compute_id] = shares

        my_share = shares[self.pid]
        my_off = int(refs[self.pid])
        _tt = TRACER.t0()
        t0 = time.perf_counter()
        if my_share > 0:
            group = ParameterGroup(params)
            group.compute(
                self.cruncher, compute_id, names, my_share, local_range,
                global_offset=my_off, values=values,
            )
        wall_ms = (time.perf_counter() - t0) * 1000.0
        if self.timing_hook is not None:
            wall_ms = float(self.timing_hook(compute_id, my_share, wall_ms))

        # result exchange: every process contributes its written range,
        # padded to the max share so the all-gather is rectangular; the
        # collective sequence below is identical on every process (it
        # depends only on the shared share table and array flags)
        max_elems = int(max(shares))
        for p in params:
            if not (p.flags.write and not p.flags.read_only):
                continue
            host = p.host()
            if p.flags.write_all:
                # single-owner rule (server.py): process 0's copy wins
                np.copyto(host, self._broadcast0(host))
                continue
            epw = p.flags.elements_per_work_item
            pad = np.zeros(max_elems * epw, host.dtype)
            if my_share > 0:
                lo = my_off * epw
                n = my_share * epw
                pad[:n] = host[lo:lo + n]
            gathered = self._allgather(pad)
            for j in range(self.nproc):
                if j == self.pid or shares[j] <= 0:
                    continue
                lo = int(refs[j]) * epw
                n = shares[j] * epw
                host[lo:lo + n] = gathered[j, :n]

        times = self._allgather(np.asarray([wall_ms], np.float64))
        self.timings[compute_id] = [float(t) for t in times.reshape(-1)]
        TRACER.record(
            "enqueue", _tt, cid=compute_id,
            tag=f"dcn p{self.pid}/{self.nproc} share{my_share}",
        )

    # -- elastic membership & window checkpoints (cluster/elastic.py) --------
    def member_table(self, local_range: int) -> dict:
        """This job's elastic-membership roster: ``{"p<i>": step}`` with
        step = process i's lane count x ``local_range`` (the LCM-step
        table's row).  Requires :meth:`setup_nodes` (the agreed lane-count
        table is the input)."""
        if not self.proc_device_counts:
            raise CekirdeklerError(
                "setup_nodes() must run before member_table()")
        return {
            f"p{i}": c * local_range
            for i, c in enumerate(self.proc_device_counts)
        }

    def establish_membership(self, local_range: int,
                             prev_steps: Sequence[int] | None = None,
                             total: int | None = None):
        """Epoch-numbered membership for this job (elastic.Membership).

        ``prev_steps`` is a previous incarnation's member-step table
        (from a window checkpoint): when it differs from the current
        roster, the leave/join transitions are recorded as replayable
        decisions carrying the new LCM-step re-split over ``total``.
        Every process runs the same reconciliation on the same inputs
        (SPMD), so the recorded sequences agree."""
        from .elastic import Membership

        m = Membership()
        if prev_steps:
            m.establish({
                f"p{i}": int(s) for i, s in enumerate(prev_steps)})
            m.sync(self.member_table(local_range), total)
        else:
            m.establish(self.member_table(local_range))
        return m

    def checkpoint_window(self, root: str, window: int, arrays: dict,
                          local_range: int) -> str | None:
        """Persist one completed window's partition state (process 0
        only — post-exchange every process holds identical host arrays).
        Callers barrier AFTER this so no process runs ahead of a
        checkpoint that may need to be resumed."""
        if self.pid != 0:
            return None
        from .elastic import save_window

        steps = [c * local_range for c in self.proc_device_counts]
        return save_window(root, window, arrays, member_steps=steps)

    def resume_elastic(self, root: str, local_range: int,
                       total: int | None = None) -> dict | None:
        """Resume a preempted job: load the newest COMPLETE window
        checkpoint (torn newest falls back — utils/checkpoint.py),
        reconcile membership against the checkpointed roster (recorded
        leave/join re-splits), warm the local cruncher from the compile
        cache when ``CK_COMPILE_CACHE`` is armed (core/compilecache.py),
        and return ``{"window", "arrays", "member_steps", "membership"}``
        — or None on a fresh start."""
        from .elastic import resume_window

        state = resume_window(root)
        membership = self.establish_membership(
            local_range,
            prev_steps=(state or {}).get("member_steps"),
            total=total)
        if self.cruncher is not None:
            from ..core.compilecache import CACHE, warm_from_disk

            if CACHE.enabled:
                warm = warm_from_disk(self.cruncher.cores)
                if state is not None:
                    state["cache_warm"] = warm
        if state is None:
            return None
        state["membership"] = membership
        return state

    # -- introspection (obs/) ------------------------------------------------
    def health_report(self) -> dict:
        """This process's lane-health verdicts (``Cores.health_report``
        of the local cruncher; ``{}`` before ``setup_nodes``).
        ``trace.gather_cluster(acc)`` ships this, so the job's lane
        verdicts merge on one table (``obs.health.cluster_health_table``)."""
        if self.cruncher is None:
            return {}
        return self.cruncher.cores.health_report()

    def serve_debug(self, port: int = 0, host: str = "127.0.0.1"):
        """Start this process's live debug endpoints over the local
        cruncher's scheduler (obs/debugserver.py) — one plane per
        process; the job-wide view is the aggregated snapshot."""
        if self.cruncher is None:
            raise CekirdeklerError("setup_nodes() must run before serve_debug()")
        return self.cruncher.cores.serve_debug(port=port, host=host)

    def compute_timing(self, compute_id: int) -> list[float]:
        return list(self.timings.get(compute_id, []))

    def ranges_of(self, compute_id: int) -> list[int]:
        return list(self.ranges.get(compute_id, []))

    def dispose(self) -> None:
        if self.cruncher is not None:
            self.cruncher.dispose()
            self.cruncher = None
