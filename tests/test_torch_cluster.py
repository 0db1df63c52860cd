"""The port's TCP cluster tier (``cluster/netbuffer``, ``balancer``,
``server``, ``client``, ``accelerator``) against the reference's.

- The wire format: ``Message.encode`` of the port equals the reference's
  byte for byte for every command, dtype and flag, and each package decodes
  the other's bytes, also over a socket.
- ``ClusterLoadBalancer``: ``equal_split``, ``resplit_active`` and
  ``rebalance`` give the reference's splits over seeded timing sequences.
- Across packages: a port ``ClusterAccelerator`` against a reference
  ``CruncherServer`` and the other way round, in-thread on host lanes.
  Integer kernels match bit for bit; float kernels within rtol 1e-5 of the
  reference (ROADMAP Queue C, reference state 4) and bit for bit, where the
  port computed them, against ``tests/kernel_oracle.py``.
- The reference's ``tests/test_cluster.py`` cases on the port, the
  ``socket-drop`` fault ending in a reconnect or in
  ``ClusterRetryExhausted`` within a bounded time, and the refusal to take
  host lanes unasked: ``CruncherServer()`` and ``ClusterAccelerator()``
  raise ``DeviceSelectionError`` where there is no card.

Every server made here is stopped at teardown, and every wait on a socket
or a child process is bounded (at most 60 s).
"""

from __future__ import annotations

import itertools
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cekirdekler_tpu
from cekirdekler_tpu.cluster import balancer as ref_balancer
from cekirdekler_tpu.cluster import netbuffer as ref_net
from cekirdekler_tpu.cluster.accelerator import ClusterAccelerator as RefClusterAccelerator
from cekirdekler_tpu.cluster.server import CruncherServer as RefCruncherServer
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.kernel import lang as ref_lang
from cekirdekler_tpu_torch import ClArray, cpus
from cekirdekler_tpu_torch.cluster import (
    ClusterAccelerator,
    ClusterLoadBalancer,
    Command,
    CruncherClient,
    CruncherServer,
    Message,
)
from cekirdekler_tpu_torch.cluster import netbuffer as net
from cekirdekler_tpu_torch.cluster.netbuffer import ArrayRecord
from cekirdekler_tpu_torch.errors import (
    CekirdeklerError,
    ClusterRetryExhausted,
    DeviceSelectionError,
)
from cekirdekler_tpu_torch.utils.faultinject import FAULTS
from tests.kernel_oracle import Oracle
from tests.test_torch_metrics import restore_planes, save_planes

ROOT = Path(__file__).resolve().parents[1]

SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = y[i] + a * x[i];
}
"""

ISRC = """
__kernel void imix(__global int* a, __global int* b, int k) {
    int i = get_global_id(0);
    b[i] = (a[i] * 7 + k) % 1000 - (a[i] >> 2) + i;
}
"""

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def _ref_cpus(n):
    return ref_platforms().cpus().subset(n)


# -- the wire format -------------------------------------------------------------

COMMANDS = [v for k, v in vars(Command).items() if isinstance(v, int)]
FLAGS = range(16)


def _messages(command: int, seed: int):
    """Messages of ``command`` over every dtype and flag, from a numpy seed;
    each is built twice, once of each package's classes."""
    rng = np.random.default_rng(seed)
    for dt, flags in itertools.product(net._DTYPES, FLAGS):
        n = int(rng.integers(0, 9))
        if dt.kind == "f":
            data = rng.standard_normal(n).astype(dt)
        else:
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
        meta = {"compute_id": int(rng.integers(0, 1 << 40)), "global_offset": -3,
                f"size_{flags}": int(rng.integers(0, 1 << 62))}
        strings = ["saxpy", "ü kernel", ""][: int(rng.integers(0, 4))]
        values = [int(rng.integers(-(1 << 62), 1 << 62)), float(rng.standard_normal()),
                  np.int32(7), np.float32(0.1)][: int(rng.integers(0, 5))]
        aid, epw, off = int(rng.integers(0, 1 << 63)), int(rng.integers(1, 5)), int(
            rng.integers(0, 1 << 40))
        yield tuple(
            M(command, meta=dict(meta), strings=list(strings), values=list(values),
              arrays=[R(aid, data, flags, epw, off), R(aid + 1, data[: n // 2], flags, 1, 0)])
            for M, R in ((Message, ArrayRecord), (ref_net.Message, ref_net.ArrayRecord)))


@pytest.mark.parametrize("command", COMMANDS)
def test_the_wire_format_is_the_reference_s_byte_for_byte(command):
    assert net.Command.__dict__.items() >= {
        k: v for k, v in vars(ref_net.Command).items() if isinstance(v, int)}.items()
    assert net._DTYPES == ref_net._DTYPES
    assert (net.FLAG_READ, net.FLAG_PARTIAL, net.FLAG_WRITE, net.FLAG_WRITE_ALL) == (
        ref_net.FLAG_READ, ref_net.FLAG_PARTIAL, ref_net.FLAG_WRITE, ref_net.FLAG_WRITE_ALL)
    for mine, ref in _messages(command, seed=command):
        raw = mine.encode()
        assert raw == ref.encode()
        for decoded in (net.Message.decode(command, raw), ref_net.Message.decode(command, raw)):
            assert decoded.meta == mine.meta and decoded.strings == mine.strings
            assert decoded.values == [v if isinstance(v, (int, np.integer)) else float(v)
                                      for v in mine.values]
            assert [type(v) for v in decoded.values] == [
                int if isinstance(v, (int, np.integer)) else float for v in mine.values]
            for got, want in zip(decoded.arrays, mine.arrays, strict=True):
                assert (got.array_id, got.flags, got.epw, got.offset) == (
                    want.array_id, want.flags, want.epw, want.offset)
                assert got.data.dtype == want.data.dtype
                np.testing.assert_array_equal(got.data, want.data)


def test_each_package_reads_the_other_s_frames_over_a_socket():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        big = np.arange(300_000, dtype=np.int64) * (1 << 33)
        sender = threading.Thread(target=net.send_message, args=(a, Message(
            Command.COMPUTE, meta={"k": 1}, arrays=[ArrayRecord(5, big, 15, 2, 9)])))
        sender.start()  # the frame outgrows the socket's buffer: read it meanwhile
        got = ref_net.recv_message(b)
        sender.join(timeout=10)
        assert got.command == Command.COMPUTE and got.meta == {"k": 1}
        np.testing.assert_array_equal(got.arrays[0].data, big)
        ref_net.send_message(b, ref_net.Message(ref_net.Command.ANSWER_ERROR, strings=["x"]))
        back = net.recv_message(a)
        assert back.command == Command.ANSWER_ERROR and back.strings == ["x"]
    finally:
        a.close()
        b.close()


def test_message_roundtrip():
    data = np.arange(10, dtype=np.float32)
    msg = Message(
        Command.COMPUTE,
        meta={"compute_id": 7, "global_range": 1024},
        strings=["saxpy", "k2"],
        values=[3, 2.5],
        arrays=[ArrayRecord(42, data, flags=5, epw=2, offset=4)],
    )
    decoded = Message.decode(msg.command, msg.encode())
    assert decoded.meta == msg.meta
    assert decoded.strings == ["saxpy", "k2"]
    assert decoded.values == [3, 2.5]
    rec = decoded.arrays[0]
    assert (rec.array_id, rec.flags, rec.epw, rec.offset) == (42, 5, 2, 4)
    np.testing.assert_array_equal(rec.data, data)


# -- the cluster balancer ----------------------------------------------------------

@pytest.mark.parametrize("steps, total", [([256, 512], 4096), ([64, 64], 2048),
                                          ([64, 128, 192], 6400), ([128], 1024),
                                          ([256, 64, 64, 320], 20480)])
def test_balancer_splits_equal_the_reference_s_over_seeded_timings(steps, total):
    rng = np.random.default_rng(sum(steps) + total)
    mine, ref = ClusterLoadBalancer(steps), ref_balancer.ClusterLoadBalancer(steps)
    assert mine.lcm == ref.lcm
    split = mine.equal_split(total)
    assert split == ref.equal_split(total)
    ranges = list(split[0])
    speeds = rng.uniform(0.2, 5.0, size=len(steps))
    for k in range(40):
        if k == 20:
            speeds = rng.uniform(0.2, 5.0, size=len(steps))  # the fleet changes
        times = [r / s * (1 + 0.05 * rng.standard_normal()) for r, s in zip(ranges, speeds)]
        if k % 9 == 4:
            times[int(rng.integers(len(steps)))] = 0.0  # a node that measured nothing
        got = mine.rebalance(ranges, times, total)
        assert got == ref.rebalance(ranges, times, total)
        assert mine.targets == ref.targets
        ranges = list(got[0])
        assert sum(got[0]) + got[1] == total
    for active in ([0], list(range(len(steps)))[::-1], [len(steps) - 1]):
        assert mine.resplit_active(total, active) == ref.resplit_active(total, active)
        assert mine.targets == ref.targets
    for bad in ([], [len(steps)]):
        with pytest.raises(ValueError):
            mine.resplit_active(total, bad)


def test_cluster_balancer_equal_split_lcm_units():
    bal = ClusterLoadBalancer(steps=[256, 512])
    ranges, rem = bal.equal_split(4096)
    assert sum(ranges) + rem == 4096
    assert all(r % 512 == 0 for r in ranges)


def test_cluster_balancer_rebalance_moves_toward_fast_node():
    bal = ClusterLoadBalancer(steps=[64, 64])
    ranges, rem = bal.equal_split(2048)
    start = list(ranges)
    for _ in range(8):
        ranges, rem = bal.rebalance(ranges, [10.0, 40.0], 2048)
    assert ranges[0] > start[0]
    assert ranges[0] % 64 == 0 and ranges[1] % 64 == 0
    assert sum(ranges) + rem == 2048


def test_cluster_balancer_starved_node_recovers():
    bal = ClusterLoadBalancer(steps=[64, 64])
    ranges, rem = bal.equal_split(2048)
    for _ in range(12):
        ranges, rem = bal.rebalance(ranges, [1.0, 1000.0], 2048)
    assert ranges[1] >= 64  # probe share survives
    for _ in range(12):
        ranges, rem = bal.rebalance(ranges, [1000.0, 1.0], 2048)
    assert ranges[1] > 512  # starved node earned its work back


# -- a live localhost cluster on host lanes ------------------------------------------

@pytest.fixture()
def two_servers():
    s1 = CruncherServer(devices=cpus(2))
    s2 = CruncherServer(devices=cpus(2))
    yield s1, s2
    s1.stop()
    s2.stop()


def test_client_setup_control_numdevices(two_servers):
    s1, _ = two_servers
    c = CruncherClient(s1.host, s1.port)
    try:
        assert c.setup(SRC) == 2
        assert c.control()
        assert c.num_devices() == 2
    finally:
        c.close()


def _oracle(src: str, arrays: dict, values: dict, n: int) -> None:
    """One call of ``src``'s kernel over ``n`` items, item by item, in place."""
    Oracle(ref_lang.parse_kernels(src)[0]).run(arrays, values, n)


def _spans(shares):
    refs = np.concatenate([[0], np.cumsum(shares)]).astype(int)
    return [(int(refs[i]), int(refs[i + 1])) for i in range(len(shares))]


def test_cluster_compute_matches_the_oracle(two_servers):
    s1, s2 = two_servers
    n = 4096
    x = ClArray(np.arange(n, dtype=np.float32) * np.float32(0.37), partial_read=True,
                read_only=True)
    y = ClArray(np.ones(n, np.float32), partial_read=True)
    want = {"x": x.host().copy(), "y": y.host().copy()}
    cluster = ClusterAccelerator([(s1.host, s1.port), (s2.host, s2.port)],
                                 local_devices=cpus(2))
    try:
        cluster.setup_nodes(SRC)
        for _ in range(3):
            cluster.compute("saxpy", [x, y], 900, n, 64, values=(2.1,))
            _oracle(SRC, want, {"a": 2.1}, n)
            np.testing.assert_array_equal(y.host(), want["y"])
        shares = cluster.ranges_of(900)
        assert sum(shares) == n and len(shares) == 3
        assert len(cluster.compute_timing(900)) == 3
    finally:
        cluster.dispose()


def test_cluster_write_all_owned_by_mainframe(two_servers):
    s1, s2 = two_servers
    n = 1024
    out = ClArray(np.zeros(n, np.float32), read=False, write=True, write_all=True)
    cluster = ClusterAccelerator([(s1.host, s1.port), (s2.host, s2.port)],
                                 local_devices=cpus(2))
    try:
        cluster.setup_nodes(
            "__kernel void fill(__global float* o, int n)"
            "{ for (int j = 0; j < n; j++) { o[j] = 5.0f; } }"
        )
        cluster.compute("fill", [out], 901, n, 64, values=(n,))
        np.testing.assert_array_equal(out.host(), np.full(n, 5.0, np.float32))
    finally:
        cluster.dispose()


def test_node_failure_mid_run_fails_over_to_mainframe(two_servers):
    s1, s2 = two_servers
    n = 4096
    x = ClArray(np.arange(n, dtype=np.float32), partial_read=True, read_only=True)
    y = ClArray(np.zeros(n, np.float32), partial_read=True)
    cluster = ClusterAccelerator([(s1.host, s1.port), (s2.host, s2.port)],
                                 local_devices=cpus(2))
    for c in cluster.clients:  # a dead node gives up fast
        c.max_retries, c.backoff_s, c.backoff_max_s = 1, 0.01, 0.02
    try:
        cluster.setup_nodes(SRC)
        cluster.compute("saxpy", [x, y], 910, n, 64, values=(1.0,))
        np.testing.assert_array_equal(y.host(), x.host())
        s2.stop()  # node dies between iterations
        cluster.compute("saxpy", [x, y], 910, n, 64, values=(1.0,))
        np.testing.assert_array_equal(y.host(), 2.0 * x.host())
        assert len(cluster.clients) == 1  # dead node dropped
        cluster.compute("saxpy", [x, y], 910, n, 64, values=(1.0,))
        np.testing.assert_array_equal(y.host(), 3.0 * x.host())
    finally:
        cluster.dispose()


def test_concurrent_sessions_do_not_serialize(two_servers):
    s1, _ = two_servers
    n = 4096
    a = CruncherClient(s1.host, s1.port)
    b = CruncherClient(s1.host, s1.port)
    try:
        assert a.setup(SRC) == 2
        xa = ClArray(np.arange(n, dtype=np.float32), partial_read=True, read_only=True)
        ya = ClArray(np.ones(n, np.float32), partial_read=True)
        errs: list = []

        def drive_a():
            try:
                for _ in range(6):
                    a.compute(["saxpy"], [xa, ya], 20, 0, n, 64, values=(1.0,))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        ta = threading.Thread(target=drive_a)
        ta.start()
        assert b.setup(SRC) == 2  # B's whole lifecycle runs while A's session computes
        xb = ClArray(np.arange(n, dtype=np.float32), partial_read=True, read_only=True)
        yb = ClArray(np.zeros(n, np.float32), partial_read=True)
        b.compute(["saxpy"], [xb, yb], 21, 0, n, 64, values=(3.0,))
        np.testing.assert_array_equal(yb.host(), np.float32(3.0) * xb.host())
        ta.join(timeout=60)
        assert not ta.is_alive() and not errs, errs
        want = np.ones(n, np.float32)
        for _ in range(6):
            want = want + xa.host()
        np.testing.assert_array_equal(ya.host(), want)
    finally:
        a.close()
        b.close()


def test_session_capacity_rejected_with_named_error():
    server = CruncherServer(devices=cpus(2), max_sessions=1)
    try:
        a = CruncherClient(server.host, server.port)
        assert a.setup(SRC) == 2  # occupies the one session slot
        b = CruncherClient(server.host, server.port)
        with pytest.raises(CekirdeklerError, match="capacity"):
            b.setup(SRC)
        b.close()
        a.close()
        deadline = time.monotonic() + 10.0
        while True:  # the freed slot admits a new session
            c = CruncherClient(server.host, server.port)
            try:
                assert c.setup(SRC) == 2
                break
            except CekirdeklerError:
                c.close()
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        c.close()
    finally:
        server.stop()


def test_probe_and_discover_find_live_servers(two_servers):
    s1, s2 = two_servers
    live = ClusterAccelerator.probe(
        [(s1.host, s1.port), ("127.0.0.1", 1), (s2.host, s2.port)], timeout=2.0)
    assert (s1.host, s1.port) in live and (s2.host, s2.port) in live
    assert ("127.0.0.1", 1) not in live
    assert ("127.0.0.1", s1.port) in ClusterAccelerator.discover(
        s1.port, subnet="127.0.0", timeout=2.0)


def test_stop_during_an_admission_ends_the_admitted_session(monkeypatch):
    """A ``stop()`` that lands while the accept loop admits a connection
    waits for the admission, then closes and joins that session too (the
    reference's loop registers a session before starting it, and a stop in
    between joins a thread that never started)."""
    from cekirdekler_tpu_torch.cluster import server as server_mod

    admitting = threading.Event()
    real_start = server_mod._ClientSession.start

    def slow_start(self):
        admitting.set()
        time.sleep(0.3)
        real_start(self)

    monkeypatch.setattr(server_mod._ClientSession, "start", slow_start)
    server = CruncherServer(devices=cpus(1))
    sock = socket.create_connection((server.host, server.port), timeout=10)
    try:
        assert admitting.wait(10)
        server.stop()  # inside the admission
        assert sock.recv(1) == b""  # the admitted session's end was closed
        name = f"cruncher-client-{sock.getsockname()}"
        assert not [t for t in threading.enumerate() if t.name == name and t.is_alive()]
    finally:
        sock.close()
        server.stop()


# -- the socket-drop fault -------------------------------------------------------

def _pair(max_retries: int = 3):
    server = CruncherServer(devices=cpus(1))
    client = CruncherClient(server.host, server.port, op_timeout=10.0,
                            max_retries=max_retries, backoff_s=0.01, backoff_max_s=0.05)
    return server, client


@pytest.mark.parametrize("site", ["send", "recv"])
def test_a_socket_drop_is_survived_by_a_reconnect(site):
    server, client = _pair()
    try:
        client.setup(INC)
        x = ClArray(np.zeros(256, np.float32), partial_read=True)
        FAULTS.arm(f"socket-drop@{site}:times=1")
        t0 = time.perf_counter()
        client.compute(["inc"], [x], 5, 0, 256, 64)
        assert time.perf_counter() - t0 < 10.0
        FAULTS.disarm()
        assert client.reconnects == 1
        np.testing.assert_array_equal(x.host(), 1.0)
        client.compute(["inc"], [x], 5, 0, 256, 64)
        np.testing.assert_array_equal(x.host(), 2.0)
        msg = Message(Command.CONTROL)
        FAULTS.arm("socket-drop@send:times=1")
        assert client._roundtrip(msg).command == Command.ANSWER_CONTROL
        assert msg.meta["seq"] == client._seq  # the retry resent the same seq
    finally:
        FAULTS.disarm()
        client.close()
        server.stop()


def test_a_socket_that_keeps_dropping_ends_in_retry_exhausted():
    server, client = _pair(max_retries=2)
    try:
        client.setup(INC)
        FAULTS.arm("socket-drop@send")
        t0 = time.perf_counter()
        with pytest.raises(ClusterRetryExhausted) as ei:
            client.num_devices()
        assert ei.value.attempts == 3 and time.perf_counter() - t0 < 10.0
        FAULTS.disarm()
        server.stop()
        with pytest.raises(ClusterRetryExhausted):  # a dead node, not a hang
            client.num_devices()
        assert not client.control()
    finally:
        FAULTS.disarm()
        client.close()
        server.stop()


# -- across packages ---------------------------------------------------------------

def _arrays(pkg, n: int, kind: str):
    rng = np.random.default_rng(7)
    CA = ClArray if pkg == "port" else cekirdekler_tpu.ClArray
    if kind == "float":
        x = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        return [CA(x, partial_read=True, read_only=True), CA(y, partial_read=True)]
    a = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    return [CA(a, partial_read=True, read_only=True),
            CA(np.zeros(n, np.int32), read=False, write=True)]


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_the_two_packages_interoperate(client_pkg, kind):
    """A port mainframe with a reference server node, and a reference
    mainframe with a port server node, against the oracle."""
    n, lr, cid, calls = 2048, 64, 930, 3
    src, name, values = (SRC, "saxpy", (1.7,)) if kind == "float" else (ISRC, "imix", (11,))
    if client_pkg == "port":
        server = RefCruncherServer(devices=_ref_cpus(2))
        make = lambda: ClusterAccelerator([(server.host, server.port)], local_devices=cpus(2))
    else:
        server = CruncherServer(devices=cpus(2))
        make = lambda: RefClusterAccelerator([(server.host, server.port)],
                                             local_devices=_ref_cpus(2))
    params = _arrays(client_pkg, n, kind)
    want = {k: p.host().copy() for k, p in zip(("x", "y") if kind == "float" else ("a", "b"),
                                                  params)}
    vals = dict(zip(("a",) if kind == "float" else ("k",), values))
    cluster = make()
    try:
        cluster.setup_nodes(src)
        for _ in range(calls):
            cluster.compute(name, params, cid, n, lr, values=values)
            _oracle(src, want, vals, n)
            got, exp = params[1].host(), want["y" if kind == "float" else "b"]
            if kind == "int":
                np.testing.assert_array_equal(got, exp)
                continue
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
            remote, mainframe = _spans(cluster.ranges_of(cid))
            port_part = slice(*(mainframe if client_pkg == "port" else remote))
            np.testing.assert_array_equal(got[port_part], exp[port_part])
            want["y"] = got.copy()  # the next call starts from what the cluster holds
    finally:
        cluster.dispose()
        server.stop()


# -- a server in another process, and no fallback -----------------------------------

def _lines(proc) -> queue.Queue:
    q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return q


def test_cluster_across_real_processes():
    """A port server in a separate interpreter (the reference's deployment
    shape): every read of its output and its end are bounded."""
    proc = subprocess.Popen(
        [sys.executable, "-c", (
            "import sys\n"
            "from cekirdekler_tpu_torch import cpus\n"
            "from cekirdekler_tpu_torch.cluster import CruncherServer\n"
            "s = CruncherServer(devices=cpus(2))\n"
            "print(s.port, flush=True)\n"
            "sys.stdin.read()\n"
            "s.stop()\n"
        )],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "CK_FAULTS": ""},
    )
    try:
        line = _lines(proc).get(timeout=60)
        assert line, "the server child ended before giving its port"
        n = 2048
        x = ClArray(np.arange(n, dtype=np.float32), partial_read=True, read_only=True)
        y = ClArray(np.ones(n, np.float32), partial_read=True)
        cluster = ClusterAccelerator([("127.0.0.1", int(line))], local_devices=cpus(2))
        try:
            cluster.setup_nodes(SRC)
            for _ in range(2):
                cluster.compute(["saxpy"], [x, y], 1, n, 64, values=(2.0,))
            np.testing.assert_array_equal(
                y.host(), np.float32(1.0) + np.float32(4.0) * np.arange(n, dtype=np.float32))
            assert len(cluster.clients) == 1
        finally:
            cluster.dispose()
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_no_member_takes_host_lanes_unasked():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(DeviceSelectionError):
        CruncherServer()
    with pytest.raises(DeviceSelectionError):
        ClusterAccelerator([("127.0.0.1", 1)])
