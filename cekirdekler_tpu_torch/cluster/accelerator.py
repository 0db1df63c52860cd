"""Multi-node cluster orchestrator.

A copy of the reference's ``cluster/accelerator.py`` over the port's
:class:`NumberCruncher` (it never imports the JAX package).  One
difference: ``local_devices=None`` means :func:`all_devices`, the CUDA
cards, and with none it raises :class:`~..errors.DeviceSelectionError`; the
mainframe never takes host lanes unasked.  The text below is the
reference's.

Analogue of ``ClusterAccelerator`` (ClusterAccelerator.cs):
drives N remote :class:`CruncherClient` nodes plus one local
:class:`NumberCruncher` "mainframe" that absorbs the remainder share
(:364-443).  Each compute id gets its own :class:`ClusterLoadBalancer`;
the first call splits equally in LCM-step units, later calls rebalance on
measured per-node wall times (:170-355).

The reference discovers servers by probing 255 LAN IPs over TCP
(:77-155); here discovery takes an explicit endpoint list (the TPU-pod
equivalent is the JAX distributed coordinator address list) — probing a
/24 is a LAN-party artifact, but :meth:`probe` covers the capability for
explicit candidates.

Implements :class:`IComputeNode` (IHesapNode.cs:33-59) so clusters nest.
"""

from __future__ import annotations

import abc
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from ..arrays.clarray import ClArray, ParameterGroup
from ..core.cruncher import NumberCruncher
from ..errors import CekirdeklerError, ComputeValidationError
from ..hardware import Devices, all_devices
from .balancer import ClusterLoadBalancer
from .client import CruncherClient

__all__ = ["IComputeNode", "ClusterAccelerator"]


class IComputeNode(abc.ABC):
    """Node abstraction (reference: IHesapNode.cs:33-59) — lets clusters
    nest 'tree-like' (ClusterAccelerator.cs:29-31)."""

    @abc.abstractmethod
    def setup_nodes(self, kernel_source: str) -> None: ...

    @abc.abstractmethod
    def compute(
        self, kernel_names, params, compute_id: int,
        global_range: int, local_range: int,
    ) -> None: ...

    @abc.abstractmethod
    def compute_timing(self, compute_id: int) -> list[float]: ...

    @abc.abstractmethod
    def dispose(self) -> None: ...


class ClusterAccelerator(IComputeNode):
    """N remote nodes + a local mainframe behaving as ONE device."""

    def __init__(
        self,
        endpoints: Sequence[tuple[str, int]] = (),
        local_devices: Devices | None = None,
    ):
        # the mainframe's lanes first: a missing card raises before any
        # node connection is opened
        self.local_devices = local_devices if local_devices is not None else \
            all_devices().require_nonempty("ClusterAccelerator(local_devices=None)")
        self.clients: list[CruncherClient] = [
            CruncherClient(h, p) for h, p in endpoints
        ]
        self.mainframe: NumberCruncher | None = None
        self.kernel_source: str | None = None
        self.balancers: dict[int, ClusterLoadBalancer] = {}
        self.ranges: dict[int, list[int]] = {}     # per node (clients..., mainframe)
        self.timings: dict[int, list[float]] = {}
        self._shadows: dict[int, ClArray] = {}     # mainframe read-array shadows
        self._pool = ThreadPoolExecutor(max_workers=max(2, len(self.clients) + 1))

    @staticmethod
    def probe(candidates: Sequence[tuple[str, int]], timeout: float = 0.5) -> list[tuple[str, int]]:
        """Find live servers among candidate endpoints (reference:
        findServer's parallel TCP probe, ClusterAccelerator.cs:77-155)."""
        import socket

        def try_one(ep):
            try:
                with socket.create_connection(ep, timeout=timeout):
                    return ep
            except OSError:
                return None

        with ThreadPoolExecutor(max_workers=min(64, max(1, len(candidates)))) as pool:
            return [ep for ep in pool.map(try_one, candidates) if ep is not None]

    @classmethod
    def discover(
        cls, port: int, subnet: str | None = None, timeout: float = 0.5,
    ) -> list[tuple[str, int]]:
        """LAN discovery parity (reference: findServer probes all 255 host
        addresses of the local /24 in parallel and keeps responders,
        ClusterAccelerator.cs:77-155).  ``subnet`` like ``"192.168.1"``;
        None derives it from this host's primary address.  Coordinator
        address lists are the TPU-pod idiom — this exists for the ad-hoc
        LAN fleets the TCP tier serves.

        **A /24 netmask is ASSUMED** when ``subnet`` is None:
        the derived prefix is the primary address minus its last octet
        (``rsplit('.', 1)``), exactly the reference's behavior — no
        interface netmask is consulted.  On a WIDER subnet (/23, /16…)
        the 255-host candidate list misses peers outside this /24 slice;
        on a NARROWER one (/25…) it probes addresses beyond the broadcast
        domain (harmless: they just time out).  Fleets on non-/24
        networks should pass ``subnet`` explicitly — one probe call per
        /24 slice — or full endpoint lists to :meth:`probe`."""
        import socket

        if subnet is None:
            # the UDP "connect" assigns the outbound interface without
            # sending a packet — the portable local-address trick
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                try:
                    s.connect(("10.255.255.255", 1))
                    local_ip = s.getsockname()[0]
                except OSError:
                    local_ip = "127.0.0.1"
            subnet = local_ip.rsplit(".", 1)[0]
        candidates = [(f"{subnet}.{h}", port) for h in range(1, 256)]
        return cls.probe(candidates, timeout=timeout)

    # -- IComputeNode --------------------------------------------------------
    def setup_nodes(self, kernel_source: str) -> None:
        """Ship the kernel source to every node and build the local
        mainframe (reference: setupNodes, ClusterAccelerator.cs:364-443)."""
        self.kernel_source = kernel_source
        for c in self.clients:
            c.setup(kernel_source)
        self.mainframe = NumberCruncher(self.local_devices, kernel_source)

    @property
    def num_nodes(self) -> int:
        return len(self.clients) + 1  # + mainframe

    def _steps(self, local_range: int) -> list[int]:
        steps = [
            max(1, c.remote_devices) * local_range for c in self.clients
        ]
        steps.append(max(1, self.mainframe.num_devices) * local_range)
        return steps

    def compute(
        self,
        kernel_names: str | Sequence[str],
        params: Sequence[ClArray],
        compute_id: int,
        global_range: int,
        local_range: int = 256,
        values=(),
    ) -> None:
        if self.mainframe is None or self.kernel_source is None:
            raise CekirdeklerError("setup_nodes() must run before compute()")
        names = (
            kernel_names.split() if isinstance(kernel_names, str) else list(kernel_names)
        )
        if global_range % local_range != 0:
            raise ComputeValidationError(
                f"global_range ({global_range}) must be divisible by local_range ({local_range})"
            )
        params = list(params)
        bal = self.balancers.get(compute_id)
        if bal is None:
            bal = ClusterLoadBalancer(self._steps(local_range))
            self.balancers[compute_id] = bal
            node_ranges, remainder = bal.equal_split(global_range)
        else:
            prev = self.ranges[compute_id]
            times = self.timings.get(compute_id, [1.0] * len(prev))
            node_ranges, remainder = bal.rebalance(prev, times, global_range)
        # mainframe takes its balanced share + the remainder
        shares = list(node_ranges)
        shares[-1] += remainder
        refs = []
        acc = 0
        for r in shares:
            refs.append(acc)
            acc += r
        self.ranges[compute_id] = shares

        # consistent input snapshot, taken on this thread BEFORE any node
        # starts writing results back — concurrent writebacks must not tear
        # the view another node's payload is marshaled from
        import numpy as np

        def eff_read(p: ClArray) -> bool:
            return p.flags.read and not p.flags.write_only

        snapshot = {id(p): p.host().copy() for p in params if eff_read(p)}

        def run_client(i: int):
            if shares[i] <= 0:
                return 0.0
            t0 = time.perf_counter()
            self.clients[i].compute(
                names, params, compute_id, refs[i], shares[i], local_range,
                values, snapshot=snapshot,
            )
            return (time.perf_counter() - t0) * 1000.0

        def mainframe_share(goff: int, grange: int) -> float:
            """Run [goff, goff+grange) on the mainframe against shadow
            arrays (its own copies of the snapshot), then copy the written
            ranges back — reading live host arrays would race client
            writebacks."""
            t0 = time.perf_counter()
            shadows: list[ClArray] = []
            for p in params:
                if eff_read(p):
                    # reuse one shadow per user array: the mainframe worker
                    # caches device buffers by array identity
                    sh = self._shadows.get(id(p))
                    if sh is None or sh.size != p.size or sh.dtype != p.dtype:
                        sh = ClArray(snapshot[id(p)].copy(), name=p.name)
                        self._shadows[id(p)] = sh
                    else:
                        np.copyto(sh.host(), snapshot[id(p)])
                    sh.flags = p.flags
                    shadows.append(sh)
                else:
                    shadows.append(p)
            group = ParameterGroup(shadows)
            group.compute(
                self.mainframe, compute_id, names, grange, local_range,
                global_offset=goff, values=values,
            )
            for p, sh in zip(params, shadows):
                if sh is p or not (p.flags.write and not p.flags.read_only):
                    continue
                if p.flags.write_all:
                    np.copyto(p.host(), sh.host())
                else:
                    epw = p.flags.elements_per_work_item
                    lo, hi = goff * epw, (goff + grange) * epw
                    p.host()[lo:hi] = sh.host()[lo:hi]
            return (time.perf_counter() - t0) * 1000.0

        def run_mainframe():
            i = len(self.clients)
            if shares[i] <= 0:
                return 0.0
            return mainframe_share(refs[i], shares[i])

        futures = [self._pool.submit(run_client, i) for i in range(len(self.clients))]
        futures.append(self._pool.submit(run_mainframe))
        timings: list[float] = []
        failed: list[int] = []
        for i, f in enumerate(futures):
            try:
                timings.append(f.result())
            except Exception:
                # node loss mid-compute (reference leaves this unhandled,
                # SURVEY.md §5.3): remember the node, recover its share
                timings.append(0.0)
                failed.append(i)
        if failed:
            # failover: the mainframe recomputes every lost share (serially,
            # AFTER all surviving writebacks — shares are disjoint)
            for i in failed:
                if shares[i] > 0:
                    timings[-1] += mainframe_share(refs[i], shares[i])
            # drop dead nodes and reset balancer state (step lists changed)
            dead = {id(self.clients[i]) for i in failed}
            for i in failed:
                try:
                    self.clients[i].close()
                except Exception:
                    pass
            self.clients = [c for c in self.clients if id(c) not in dead]
            self.balancers.clear()
            self.ranges.clear()
            self.timings.clear()
            return
        self.timings[compute_id] = timings

    def compute_timing(self, compute_id: int) -> list[float]:
        return list(self.timings.get(compute_id, []))

    def ranges_of(self, compute_id: int) -> list[int]:
        return list(self.ranges.get(compute_id, []))

    def dispose(self) -> None:
        for c in self.clients:
            c.dispose_remote()
            c.close()
        if self.mainframe is not None:
            self.mainframe.dispose()
            self.mainframe = None
        self._pool.shutdown(wait=False)
