"""Cluster compute client: drives one remote server node.

A copy of the reference's ``cluster/client.py`` kept in the port (which
never imports the JAX package).  One difference: a serving-tier rejection
reply (``meta["reject"]``) raises :class:`~..errors.ClusterError` naming its
reason, tenant and retry-after hint, since the typed ``ServeRejected`` comes
with the serving tier (ROADMAP Queue A 8).  The text below is the
reference's.

Analogue of ``ClCruncherClient`` (ClCruncherClient.cs):
``setup`` ships the kernel source (:121-155); ``compute`` marshals the
node's share of ranges + the needed array regions, blocks on the reply,
and writes returned slices back into the caller's host arrays (:156-259);
``control``/``num_devices``/``stop`` mirror the management surface
(:260-325).

Resilience contract (the reference's TCP tier only fails
over at connect time):

- **Per-operation read timeouts.**  Every round trip runs under
  ``op_timeout`` (``socket.settimeout`` on the connection) — a server
  dying mid-``recv_message`` surfaces as a timeout instead of hanging
  the client forever (the seed behavior: only the CONNECT had one).
- **Bounded reconnect with exponential backoff + jitter.**  A failed
  round trip (connection reset, injected socket drop, timeout)
  reconnects and retries up to ``max_retries`` times, sleeping
  ``backoff_s·2^k + jitter`` (capped at ``backoff_max_s``; jitter from
  a seeded RNG so tests are deterministic).  Exhaustion raises the
  NAMED :class:`~..errors.ClusterRetryExhausted` — a
  dead node is a typed error, never a hang.
- **Idempotent retries via a request sequence number.**  Each logical
  operation gets one ``seq`` (``meta["seq"]``) assigned at first
  attempt; every retry RESENDS the same seq, so a server (or a
  dedup-aware proxy) can recognize a replay.  The retried payload is
  identical — the client's host arrays are unchanged until a reply
  lands, so re-execution produces the same result.
- **Session replay.**  The server's session state (cruncher + array
  cache) is per-connection; after a reconnect the cached ``setup``
  is replayed before the retried operation, so a mid-job failover is
  invisible to the caller beyond latency.

Application errors (``ANSWER_ERROR``) are never retried — they are
deterministic replies, not transport failures.
"""

from __future__ import annotations

import random
import socket
import threading
import time

import numpy as np

from ..arrays.clarray import ClArray
from ..errors import CekirdeklerError, ClusterError, ClusterRetryExhausted
from .netbuffer import (
    FLAG_PARTIAL,
    FLAG_READ,
    FLAG_WRITE,
    FLAG_WRITE_ALL,
    ArrayRecord,
    Command,
    Message,
    recv_message,
    send_message,
)

__all__ = ["CruncherClient"]

_COMMAND_NAMES = {
    v: k for k, v in vars(Command).items() if isinstance(v, int)
}


def _flags_of(arr: ClArray) -> int:
    fl = arr.flags
    out = 0
    if fl.read and not fl.write_only:
        out |= FLAG_READ
    if fl.partial_read:
        out |= FLAG_PARTIAL
    if fl.write and not fl.read_only:
        out |= FLAG_WRITE
    if fl.write_all:
        out |= FLAG_WRITE_ALL
    return out


class CruncherClient:
    """Synchronous request/reply client of one compute node (see the
    module docstring for the retry/timeout contract)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 op_timeout: float = 30.0, max_retries: int = 4,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 retry_seed: int = 0):
        self.host = host
        self.port = port
        self.timeout = float(timeout)
        self.op_timeout = float(op_timeout)
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._rng = random.Random(retry_seed)
        self._lock = threading.Lock()
        self._seq = 0
        self._setup_args: tuple[str, int] | None = None
        self.reconnects = 0  # observability: transport failovers survived
        self.remote_devices = 0
        self.sock = self._connect()

    # -- transport ------------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # per-OPERATION read timeout: a peer dying mid-recv_message
        # surfaces as socket.timeout (an OSError) instead of a hang
        sock.settimeout(self.op_timeout)
        return sock

    def _reconnect_locked(self) -> None:
        """Close, reconnect, and replay the cached SETUP (the server's
        session state is per-connection).  Caller holds the lock."""
        try:
            self.sock.close()
        except OSError:
            pass
        self.sock = self._connect()
        self.reconnects += 1
        if self._setup_args is not None:
            source, max_devices = self._setup_args
            send_message(self.sock, Message(
                Command.SETUP, meta={"max_devices": max_devices},
                strings=[source],
            ))
            reply = recv_message(self.sock)
            if reply.command == Command.ANSWER_ERROR:
                raise CekirdeklerError(
                    "remote error replaying setup: "
                    f"{reply.strings and reply.strings[0]}")
            self.remote_devices = reply.meta.get("n", 0)

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        return base * (0.5 + self._rng.random())  # jitter in [0.5, 1.5)·base

    def _roundtrip(self, msg: Message) -> Message:
        """One logical operation: send + receive, with bounded
        reconnect-and-retry on transport failure.  The operation's
        ``seq`` is assigned ONCE — retries resend the identical
        message (idempotency marker, see module docstring)."""
        with self._lock:
            if "seq" not in msg.meta:
                self._seq += 1
                msg.meta["seq"] = self._seq
            last_exc: BaseException | None = None
            for attempt in range(self.max_retries + 1):
                if attempt > 0:
                    time.sleep(self._backoff(attempt - 1))
                    try:
                        self._reconnect_locked()
                    except (ConnectionError, OSError) as e:
                        last_exc = e
                        continue  # node still down — next backoff step
                try:
                    send_message(self.sock, msg)
                    reply = recv_message(self.sock)
                    break
                except (ConnectionError, OSError) as e:
                    last_exc = e
            else:
                op = _COMMAND_NAMES.get(msg.command, str(msg.command))
                raise ClusterRetryExhausted(
                    op, self.max_retries + 1, last_exc) from last_exc
        if reply.command == Command.ANSWER_ERROR:
            if reply.meta.get("reject") and len(reply.strings) >= 3:
                # a serving-tier rejection (circuit-open / brownout /
                # shard-unavailable / ...): named reason, tenant and
                # retry-after hint intact (never retried here — an
                # application reply is deterministic, not transport)
                raise ClusterError(
                    f"remote rejection {reply.strings[1]!r} for tenant "
                    f"{reply.strings[2]!r} (retry after "
                    f"{reply.meta.get('retry_after_us', 0) / 1e6} s): "
                    f"{reply.strings[0]}")
            raise CekirdeklerError(
                f"remote error: {reply.strings and reply.strings[0]}")
        return reply

    # -- operations -----------------------------------------------------------
    def setup(self, kernel_source: str, max_devices: int = 0) -> int:
        self._setup_args = (kernel_source, int(max_devices))
        reply = self._roundtrip(
            Message(
                Command.SETUP,
                meta={"max_devices": max_devices},
                strings=[kernel_source],
            )
        )
        self.remote_devices = reply.meta.get("n", 0)
        return self.remote_devices

    def compute(
        self,
        kernel_names: list[str],
        params: list[ClArray],
        compute_id: int,
        global_offset: int,
        global_range: int,
        local_range: int,
        values=(),
        snapshot: dict | None = None,
    ) -> None:
        """Run this node's share [global_offset, global_offset+global_range)
        remotely; blocks and writes results back into ``params``.

        ``snapshot`` maps ``id(param) -> numpy copy``: when given, read
        payloads marshal from the snapshot so concurrent writebacks from
        other nodes can't tear the input view."""
        msg = Message(
            Command.COMPUTE,
            meta={
                "compute_id": compute_id,
                "global_offset": global_offset,
                "global_range": global_range,
                "local_range": local_range,
            },
            strings=list(kernel_names),
            values=list(values),
        )
        for p in params:
            flags = _flags_of(p)
            aid = id(p)
            msg.meta[f"size_{aid}"] = p.size
            host = p.host()
            if snapshot is not None and aid in snapshot:
                host = snapshot[aid]
            if flags & FLAG_READ:
                if flags & FLAG_PARTIAL:
                    epw = p.flags.elements_per_work_item
                    lo, hi = global_offset * epw, (global_offset + global_range) * epw
                    data, off = host[lo:hi], lo
                else:
                    data, off = host, 0
            else:
                data, off = host[:0], 0
            msg.arrays.append(
                ArrayRecord(aid, data, flags, p.flags.elements_per_work_item, off)
            )
        reply = self._roundtrip(msg)
        by_id = {id(p): p for p in params}
        for rec in reply.arrays:
            arr = by_id.get(rec.array_id)
            if arr is None:
                continue
            arr.host()[rec.offset : rec.offset + rec.data.size] = rec.data

    def control(self) -> bool:
        """Liveness ping (reference: control, ClCruncherClient.cs:275).
        Retries like every op; a node dead through every attempt
        answers False (ClusterRetryExhausted is a CekirdeklerError)."""
        try:
            return self._roundtrip(Message(Command.CONTROL)).command == Command.ANSWER_CONTROL
        except (CekirdeklerError, OSError, ConnectionError):
            return False

    def num_devices(self) -> int:
        return self._roundtrip(Message(Command.NUM_DEVICES)).meta.get("n", 0)

    def dispose_remote(self) -> None:
        try:
            send_message(self.sock, Message(Command.DISPOSE))
        except OSError:
            pass

    def stop_server(self) -> None:
        try:
            send_message(self.sock, Message(Command.SERVER_STOP))
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
