"""Cluster compute server: one TCP listener, one thread per client.

A copy of the reference's ``cluster/server.py`` over the port's
:class:`NumberCruncher` (it never imports the JAX package).  Two
differences: ``devices=None`` means :func:`all_devices`, the CUDA cards, and
with none it raises :class:`~..errors.DeviceSelectionError`; it never takes
host lanes unasked (pass ``cpus(n)`` for those).  And the accept loop admits
a connection, and ``stop`` takes its snapshot of the sessions, under one
lock, and ``stop`` shuts each session's socket down before closing it: in
the reference a ``stop`` between a session's registration and its start
joins a thread that never started (``RuntimeError``), one just after the
accept loop's running check leaves a session serving a stopped server, and
a close alone does not wake a session blocked in ``recv``.  The text below
is the reference's.

Analogue of ``ClCruncherServer(+Thread)`` (ClCruncherServer.cs,
ClCruncherServerThread.cs): SETUP builds a local :class:`NumberCruncher`
from the kernel source (ClCruncherServerThread.cs:113-146); COMPUTE
unmarshals kernel names / ranges / arrays, runs the local multi-chip
scheduler over the node's share of the global range, and returns the
written slices (:147-250); CONTROL answers pings; NUM_DEVICES reports the
node's chip count; DISPOSE tears the cruncher down; SERVER_STOP ends the
server.  Array identity across calls rides client-side ids cached per
connection (:175-185) so repeated computes reuse device buffers.
"""

from __future__ import annotations

import socket
import threading

import numpy as np

from ..arrays.clarray import ClArray, ParameterGroup
from ..core.cruncher import NumberCruncher
from ..hardware import all_devices
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

__all__ = ["CruncherServer"]


def _error_reply(e: Exception) -> Message:
    """The ANSWER_ERROR for one failed operation.  A serving-tier
    rejection (``serve/admission.ServeRejected`` — including the
    fabric's ``shard-unavailable``) carries its NAMED reason, tenant,
    and retry-after hint in ``meta`` so the remote client re-raises
    the same typed error a local caller gets (detected structurally —
    by the reason/tenant/retry attributes — so this module never
    imports the serve package and no import cycle forms).  The wire
    meta dict is int-valued by format, so the reason and tenant ride
    the strings list behind the message text and the retry hint rides
    as integer microseconds."""
    reason = getattr(e, "reason", None)
    tenant = getattr(e, "tenant", None)
    retry_after = getattr(e, "retry_after_s", None)
    if isinstance(reason, str) and tenant is not None \
            and retry_after is not None:
        return Message(
            Command.ANSWER_ERROR,
            meta={"reject": 1,
                  "retry_after_us": int(float(retry_after) * 1e6)},
            strings=[str(e), reason, str(tenant)])
    return Message(Command.ANSWER_ERROR, strings=[str(e)])


class _ClientSession(threading.Thread):
    """Per-connection state + dispatch loop (reference:
    ClCruncherServerThread)."""

    def __init__(self, server: "CruncherServer", conn: socket.socket, addr):
        super().__init__(daemon=True, name=f"cruncher-client-{addr}")
        self.server = server
        self.conn = conn
        self.cruncher: NumberCruncher | None = None
        self.arrays: dict[int, ClArray] = {}  # client array id → local array

    def run(self) -> None:  # pragma: no cover - driven by tests via sockets
        try:
            while True:
                msg = recv_message(self.conn)
                if msg.command == Command.SETUP:
                    self._setup(msg)
                elif msg.command == Command.COMPUTE:
                    self._compute(msg)
                elif msg.command == Command.CONTROL:
                    send_message(self.conn, Message(Command.ANSWER_CONTROL))
                elif msg.command == Command.NUM_DEVICES:
                    n = self.cruncher.num_devices if self.cruncher else len(
                        self.server.devices
                    )
                    send_message(
                        self.conn,
                        Message(Command.ANSWER_NUM_DEVICES, meta={"n": n}),
                    )
                elif msg.command == Command.DISPOSE:
                    self._dispose()
                elif msg.command == Command.SERVER_STOP:
                    self.server.stop()
                    break
                else:
                    send_message(
                        self.conn,
                        Message(Command.ANSWER_ERROR, strings=[f"bad command {msg.command}"]),
                    )
        except (ConnectionError, OSError):
            pass
        finally:
            self._dispose()
            try:
                self.conn.close()
            except OSError:
                pass

    def _setup(self, msg: Message) -> None:
        try:
            source = msg.strings[0]
            max_devices = msg.meta.get("max_devices", 0)
            devices = self.server.devices
            if max_devices > 0:
                devices = devices.subset(max_devices)
            self._dispose()
            self.cruncher = NumberCruncher(devices, source)
            send_message(
                self.conn,
                Message(Command.ANSWER_SETUP, meta={"n": self.cruncher.num_devices}),
            )
        except Exception as e:
            send_message(self.conn, _error_reply(e))

    def _compute(self, msg: Message) -> None:
        try:
            if self.cruncher is None:
                raise RuntimeError("COMPUTE before SETUP")
            kernels = msg.strings
            cid = msg.meta["compute_id"]
            goff = msg.meta["global_offset"]
            grange = msg.meta["global_range"]
            lrange = msg.meta["local_range"]
            params: list[ClArray] = []
            for rec in msg.arrays:
                arr = self.arrays.get(rec.array_id)
                total = msg.meta[f"size_{rec.array_id}"]
                if arr is None or arr.size != total or arr.dtype != rec.data.dtype:
                    arr = ClArray(np.zeros(total, rec.data.dtype))
                    self.arrays[rec.array_id] = arr
                if rec.flags & FLAG_READ and rec.data.size:
                    arr.host()[rec.offset : rec.offset + rec.data.size] = rec.data
                arr.flags.read = bool(rec.flags & FLAG_READ)
                arr.flags.partial_read = bool(rec.flags & FLAG_PARTIAL)
                arr.flags.write = bool(rec.flags & FLAG_WRITE)
                arr.flags.write_all = bool(rec.flags & FLAG_WRITE_ALL)
                arr.flags.elements_per_work_item = rec.epw
                params.append(arr)
            group = ParameterGroup(params)
            group.compute(
                self.cruncher, cid, kernels, grange, lrange,
                global_offset=goff, values=tuple(msg.values),
            )
            # return written slices: this node's [goff, goff+grange) × epw
            reply = Message(Command.ANSWER_COMPUTE, meta={"compute_id": cid})
            for rec, arr in zip(msg.arrays, params):
                if not (rec.flags & FLAG_WRITE):
                    continue
                if rec.flags & FLAG_WRITE_ALL:
                    # cluster-level single-owner rule: remote nodes never
                    # return write_all arrays (the mainframe owns them) —
                    # else N nodes race full-array writebacks on the client
                    continue
                else:
                    epw = rec.epw
                    lo, hi = goff * epw, (goff + grange) * epw
                reply.arrays.append(
                    ArrayRecord(
                        rec.array_id, arr.host()[lo:hi], rec.flags, rec.epw, lo
                    )
                )
            send_message(self.conn, reply)
        except Exception as e:
            send_message(self.conn, _error_reply(e))

    def _dispose(self) -> None:
        if self.cruncher is not None:
            self.cruncher.dispose()
            self.cruncher = None
        self.arrays.clear()


class CruncherServer:
    """TCP compute node (reference: ClCruncherServer.cs:56-133).

    Concurrent-client contract: each accepted connection runs its OWN
    session thread with its own cruncher and array cache — a second
    client's SETUP/COMPUTE proceeds while the first session is
    mid-compute (nothing serializes sessions against each other;
    pinned by ``tests/test_cluster.py``).  ``max_sessions`` bounds the
    concurrency: a connection beyond it is REJECTED with a named
    ``ANSWER_ERROR`` and closed — the client's next round trip raises
    instead of hanging on a connection the server will never serve."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, devices=None,
                 max_sessions: int = 32):
        self.devices = devices if devices is not None else \
            all_devices().require_nonempty("CruncherServer(devices=None)")
        self.max_sessions = max(1, int(max_sessions))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._running = True
        self._sessions: list[_ClientSession] = []
        self._mu = threading.Lock()  # _running and _sessions, against stop()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="cruncher-server"
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:  # pragma: no cover - exercised via tests
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                break
            with self._mu:
                if not self._admit_locked(conn, addr):
                    break

    def _admit_locked(self, conn: socket.socket, addr) -> bool:
        """Start a session for one accepted connection, or reject it;
        False once the server is stopped.  Caller holds ``_mu``."""
        if not self._running:
            # stop() raced the blocked accept: on Linux, close()
            # alone does NOT wake a thread blocked in accept() (the
            # syscall pins the kernel socket, which keeps LISTENING)
            # — one post-stop connection could land here and be
            # served by a "stopped" server.  Found by the reconnect
            # client retrying a stopped node.
            try:
                conn.close()
            except OSError:
                pass
            return False
        self._sessions = [s for s in self._sessions if s.is_alive()]
        if len(self._sessions) >= self.max_sessions:
            # reject-with-a-name, never a silent hang: the client's
            # first round trip reads this error instead of waiting
            # on a session thread that will never exist (the
            # serving tier's admission contract, applied here).  A
            # tiny daemon reads the client's first command BEFORE
            # replying — an unsolicited error followed by close can
            # be RST-discarded when the client's request lands on
            # the already-closed socket
            threading.Thread(
                target=self._reject_session, args=(conn,),
                daemon=True, name="cruncher-reject",
            ).start()
            return True
        session = _ClientSession(self, conn, addr)
        session.start()
        self._sessions.append(session)
        return True

    def _reject_session(self, conn: socket.socket) -> None:
        """Answer one over-capacity connection's first command with a
        named error, then close (request → error reply ordering, so
        the rejection survives the TCP teardown)."""
        try:
            conn.settimeout(5.0)
            recv_message(conn)
            send_message(conn, Message(
                Command.ANSWER_ERROR,
                strings=[
                    f"server at capacity ({self.max_sessions} "
                    "concurrent sessions); retry later"],
            ))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        with self._mu:
            self._running = False
            sessions, self._sessions = self._sessions, []
        try:
            # shutdown BEFORE close: close() does not wake a thread
            # blocked in accept() on Linux (the syscall holds a kernel
            # reference, so the socket keeps listening and accepts one
            # more connection); shutdown() forces the blocked accept to
            # return, so a stopped server genuinely stops accepting
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # platform may refuse shutdown on a listening socket
        try:
            self._sock.close()
        except OSError:
            pass
        # close live sessions: shutdown unblocks their recv loops (a close
        # alone does not wake a recv blocked in another thread), whose
        # finally blocks dispose crunchers (device buffers) and close sockets
        for session in sessions:
            for end in (lambda: session.conn.shutdown(socket.SHUT_RDWR),
                        session.conn.close):
                try:
                    end()
                except OSError:
                    pass
        me = threading.current_thread()
        for session in sessions:
            if session is not me:  # SERVER_STOP arrives on a session thread
                session.join(timeout=2.0)

    def __enter__(self) -> "CruncherServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
