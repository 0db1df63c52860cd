"""The port's compile cache (``cekirdekler_tpu_torch/core/compilecache.py``)
on the CPU, held against the JAX package's.

- **Function by function**: ``WarmupSpec``'s payloads, ``launch_ladder``
  and ``program_fingerprint`` equal the reference's for the same jobs.
- **Warmup equals the live key**: after ``Cores.warmup`` on a host lane
  the first live ``compute_fused_batch`` builds no launcher, armed or not,
  and its result equals the reference's bit for bit (the reference's
  ``inc``/``dbl`` kernels, N 1024, local range 64).  A warmed key off the
  live one (platform ``"gpu"``, values as a dict against a tuple) warms
  nothing; a baked ``np.float32`` survives the JSON round trip.
- **Across processes**: a child fills the cache through the engage-time
  recorder; a second child warms from disk and its first batch builds
  nothing (``tests/_torch_cache_worker.py``).
- **The library layer** (``kernel/build.py``, built with ``g++``): a
  second process loads the library from ``<root>/lib`` and runs no
  compiler; a truncated library is the named miss ``lib-unloadable`` and
  is built again; unarmed, libraries stay in ``_build/``.
- **Degraded state**: a torn manifest row and a corrupt payload are named
  misses, concurrent writers converge, ``prune`` evicts to the cap oldest
  first, libraries included.
- **The reference reads the port's root**: ``CompileCache(root).stats()``
  and ``.verify()`` of the JAX package report the port's entries, none
  corrupt.
- **The tools**: ``ckcache`` and a ``coldstart`` trio on host lanes.
- **The serving tier's warmups**: ``ServeFrontend.warmup`` warms the live
  key and leaves the job's arrays alone; a member joining a
  ``ServeFabric`` warms from the cache's kept mix with no fresh compile,
  and its first live batch builds nothing.

No test asserts a time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import types
import uuid

import numpy as np
import pytest

import cekirdekler_tpu_torch as ck
from cekirdekler_tpu_torch.core import compilecache as cc
from cekirdekler_tpu_torch.core.compilecache import (
    CACHE,
    CACHE_ENV,
    CompileCache,
    WarmupSpec,
    program_fingerprint,
    warm_from_disk,
)
from cekirdekler_tpu_torch.core.worker import launch_ladder
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.kernel import build
from cekirdekler_tpu_torch.kernel.registry import KernelProgram
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.tools import ckcache, coldstart

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SRC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
__kernel void dbl(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] * 1.001f;
}
"""

SCL = """
__kernel void scl(__global float* a, float s) {
    int i = get_global_id(0);
    a[i] = a[i] + s;
}
"""

N, LR = 1024, 64


def _reset_cache() -> None:
    CACHE._seen.clear()
    CACHE.miss_reasons.clear()
    CACHE._armed_dir = None


@pytest.fixture()
def cache_root(tmp_path, monkeypatch):
    """Arm the process's CACHE at a fresh root; the environment and the
    singleton's state are restored after the test, so later tests never
    build into a deleted root."""
    root = str(tmp_path / "cache")
    monkeypatch.setenv(CACHE_ENV, root)
    _reset_cache()
    yield root
    _reset_cache()


@pytest.fixture()
def unarmed(monkeypatch):
    monkeypatch.delenv(CACHE_ENV, raising=False)
    _reset_cache()
    yield
    _reset_cache()


def _spec(kernels=("inc",), n=N, lr=LR, values=()):
    return WarmupSpec(kernels=tuple(kernels), params=((n, "float32"),), global_range=n,
                      local_range=lr, values=values)


def _seed() -> np.ndarray:
    return np.random.default_rng(7).standard_normal(N).astype(np.float32)


def _fused_batch(cr, arr, cid, iters, kernel="inc", value_args=()):
    cr.enqueue_mode = True
    out = cr.cores.compute_fused_batch([kernel], [arr], cid, arr.size, LR, iters,
                                       value_args=value_args)
    cr.cores.barrier()
    cr.cores.flush()
    cr.enqueue_mode = False
    return out


def _counts(prog) -> tuple:
    return (prog.fused_compiled_count, prog.compiled_count, prog.compiled_counts_by_platform())


def _reference_batch(kernel: str, iters: int) -> np.ndarray:
    """The JAX package's fused batch over the same seeded input, with its
    cache unarmed."""
    from cekirdekler_tpu import ClArray as RefArray
    from cekirdekler_tpu.core import NumberCruncher as RefCruncher
    from cekirdekler_tpu.hardware import platforms

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(CACHE_ENV, raising=False)
        cr = RefCruncher(platforms().cpus().subset(1), SRC)
        try:
            x = RefArray(_seed(), name="ref")
            x.partial_read = True
            _fused_batch(cr, x, 7300, iters, kernel)
            return np.asarray(x).copy()
        finally:
            cr.dispose()


# -- the serving tier's warmups: the frontend's and the fabric's on join --------------


def _serve_job(name: str, cid: int):
    from cekirdekler_tpu_torch.serve import ServeJob

    a = ck.ClArray(np.zeros(N, np.float32), name=name)
    a.partial_read = True
    return a, ServeJob(params=[a], kernels=["inc"], compute_id=cid, global_range=N,
                       local_range=LR)


def test_frontend_warmup_matches_live_key_and_never_mutates(unarmed):
    from cekirdekler_tpu_torch.serve import ServeFrontend

    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    fe = ServeFrontend(cr, autostart=False, name="warmkeys")
    try:
        a, job = _serve_job("wk", 7302)
        out = fe.warmup([job])
        assert out["warmed"] == 1 and out["kinds"] == {"cpu": 1}
        assert np.all(np.asarray(a) == 0.0)  # scratch buffers only
        prog = cr.cores.program
        before = _counts(prog)
        futs = [fe.submit("t0", job) for _ in range(8)]
        fe.step()
        for f in futs:
            assert f.result(timeout=30)["fused"] is True
        np.testing.assert_array_equal(np.asarray(a), 8.0)
        assert _counts(prog) == before
    finally:
        fe.close()
        cr.dispose()


def test_fabric_add_member_zero_fresh_compiles_when_cache_holds_mix(cache_root):
    """Live traffic keeps the fleet's signature mix (the engage-time
    recorder), so a joining member's warmup is all disk hits and its first
    live batch builds nothing."""
    from cekirdekler_tpu_torch.serve import ServeFabric

    crunchers = {m: ck.NumberCruncher(ck.all_devices().cpus(1), SRC) for m in ("m0", "m1")}
    fab = ServeFabric(crunchers, autostart=False, gather_window_s=0.0, max_batch=64)
    a, job = _serve_job("fz", 9300)
    try:
        futs = [fab.submit("t0", job) for _ in range(6)]
        for _ in range(40):
            fab.step()
            if all(f.done() for f in futs):
                break
        assert np.all(np.asarray(a) == 6.0)
        cache = CompileCache(root=cache_root)
        assert cache.stats()["write"] >= 1
        before = cache.stats()
        fab.add_member("m2", ck.NumberCruncher(ck.all_devices().cpus(1), SRC), step=1)
        after = cache.stats()
        assert after["miss"] == before["miss"]  # no fresh compile
        assert after["hit"] > before["hit"]
        fe2 = fab.shards["m2"]
        prog2 = fe2.cores.program
        warmed = _counts(prog2)
        b = ck.ClArray(np.zeros(N, np.float32), name="fz2", partial_read=True)
        res = _fused_batch(fe2.cruncher, b, 9300, 4)
        np.testing.assert_array_equal(np.asarray(b), 4.0)
        assert res["fused"] and _counts(prog2) == warmed
    finally:
        joined = fab.shards.get("m2")
        fab.close()
        for cr in list(crunchers.values()) + ([joined.cruncher] if joined else []):
            cr.dispose()


# -- function by function, against the reference ---------------------------------


def _jobs():
    p = types.SimpleNamespace(size=N, dtype="float32")
    q = types.SimpleNamespace(size=3 * N, dtype=np.dtype("int32"))
    return {
        "no values": (["inc"], [p], ()),
        "tuple": (["nBody"], [p, p, q], (8192, 0.0001)),
        "dict": (["scl", "inc"], [p], {"scl": (0.25,), "inc": ()}),
        "float32": (["scl"], [p], {"scl": (np.float32(0.1),)}),
        "float32 tuple": (["scl"], [q, p], (np.float32(1.5), 3)),
    }


@pytest.mark.parametrize("job", list(_jobs()))
def test_warmup_spec_payloads_match_the_reference(job):
    from cekirdekler_tpu.core.compilecache import WarmupSpec as RefSpec

    kernels, params, values = _jobs()[job]
    mine = WarmupSpec.from_job(kernels, params, 7, N, LR, 0, values)
    ref = RefSpec.from_job(kernels, params, 7, N, LR, 0, values)
    assert mine.to_payload() == ref.to_payload()
    assert mine.values == ref.values and mine.params == ref.params
    back = WarmupSpec.from_payload(json.loads(json.dumps(mine.to_payload())))
    ref_back = RefSpec.from_payload(json.loads(json.dumps(ref.to_payload())))
    assert back == mine and back.to_payload() == ref_back.to_payload()
    assert back.value_args() == ref_back.value_args()
    hash(back)
    assert mine.ladder() == ref.ladder()


@pytest.mark.parametrize("size, step", [(1024, 64), (8192, 256), (4194304, 256), (64 * 7, 64),
                                        (64 * 45, 64), (0, 64), (256, 256)])
def test_launch_ladder_matches_the_reference(size, step):
    from cekirdekler_tpu.core.worker import launch_ladder as ref_ladder

    assert launch_ladder(size, step) == ref_ladder(size, step)


@pytest.mark.parametrize("src", [SRC, SCL, SRC + "\n"], ids=["incdbl", "scl", "incdbl-nl"])
def test_program_fingerprint_matches_the_reference(src):
    from cekirdekler_tpu.core.compilecache import program_fingerprint as ref_fp
    from cekirdekler_tpu.kernel.registry import KernelProgram as RefProgram

    assert program_fingerprint(KernelProgram(src)) == ref_fp(RefProgram(src))
    py = types.SimpleNamespace(source=src, _py_kernels={"b": 1, "a": 2})
    assert program_fingerprint(py) == ref_fp(py)


def test_program_fingerprint_splits_on_a_source_change():
    assert program_fingerprint(KernelProgram(SRC)) != program_fingerprint(KernelProgram(SRC + "\n"))


# -- warmup equals the live key ------------------------------------------------------


@pytest.mark.parametrize("kernel", ["inc", "dbl"])
@pytest.mark.parametrize("armed", [True, False], ids=["armed", "unarmed"])
def test_warmup_then_the_first_live_batch_builds_nothing(kernel, armed, tmp_path, monkeypatch):
    want = _reference_batch(kernel, 5)
    if armed:
        monkeypatch.setenv(CACHE_ENV, str(tmp_path / "cache"))
    else:
        monkeypatch.delenv(CACHE_ENV, raising=False)
    _reset_cache()
    try:
        cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
        try:
            out = cr.cores.warmup([_spec((kernel,))])
            assert out["warmed"] == 1 and out["skipped"] == 0 and out["kinds"] == {"cpu": 1}
            assert (out["hits"], out["misses"]) == ((0, 1) if armed else (0, 0))
            prog = cr.cores.program
            before = _counts(prog)
            assert before[0] == 1 and before[2] == {"cpu": before[1]}
            x = ck.ClArray(_seed(), name="cw", partial_read=True)
            res = _fused_batch(cr, x, 7300, 5, kernel)
            assert res["fused"]
            assert _counts(prog) == before
            assert x.host().tobytes() == want.tobytes()
            assert ("cache_hits" in res) is armed
        finally:
            cr.dispose()
        if armed:
            cache = CompileCache(root=str(tmp_path / "cache"))
            assert len(cache.load_specs()) == 1 and cache.stats()["write"] == 1
    finally:
        _reset_cache()


def test_warmup_records_one_flight_event_and_one_context_decision(cache_root):
    FLIGHT.clear()
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    try:
        with DECISIONS.capture() as ring:
            out = cr.cores.warmup([_spec(), _spec(), _spec(("dbl",)), _spec(("nope",))])
    finally:
        cr.dispose()
    assert (out["warmed"], out["skipped"], out["misses"]) == (2, 1, 2)
    events = [e for e in FLIGHT.snapshot() if e.kind == "cache-warmup"]
    assert len(events) == 1 and events[0].fields["warmed"] == 2
    rows = [r for r in ring if r.kind == "cache-warmup"]
    assert len(rows) == 1 and rows[0].inputs["cache_enabled"] is True
    FLIGHT.clear()


@pytest.mark.parametrize("off", ["platform gpu", "values as a dict"])
def test_a_warmed_key_off_the_live_one_warms_nothing(off, unarmed):
    """Trouble the live path would not show: the live launch reads its
    platform from ``device.type`` (``"cpu"``, ``"cuda"``), and the live key
    holds the values as the caller gave them."""
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    try:
        prog = cr.cores.program
        if off == "platform gpu":
            prog.fused_launcher(("inc",), LR, N, LR, N, (), platform="gpu")
        else:
            prog.fused_launcher(("inc",), LR, N, LR, N, {"inc": ()}, platform="cpu")
        before = prog.fused_compiled_count
        x = ck.ClArray(np.zeros(N, np.float32), name="off", partial_read=True)
        _fused_batch(cr, x, 7302, 4)
        assert prog.fused_compiled_count == before + 1
        assert np.all(x.host() == 4.0)
    finally:
        cr.dispose()


def test_a_baked_float32_value_survives_the_json_round_trip(cache_root):
    """Warmed from a spec that went through disk, a live batch with an
    ``np.float32`` value builds nothing."""
    vals = {"scl": (np.float32(0.1),)}
    arr = types.SimpleNamespace(size=N, dtype="float32")
    spec = WarmupSpec.from_payload(json.loads(json.dumps(
        WarmupSpec.from_job(["scl"], [arr], 1, N, LR, 0, vals).to_payload())))
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SCL)
    try:
        assert cr.cores.warmup([spec])["warmed"] == 1
        before = _counts(cr.cores.program)
        x = ck.ClArray(np.zeros(N, np.float32), name="f32", partial_read=True)
        _fused_batch(cr, x, 7303, 4, "scl", vals)
        assert _counts(cr.cores.program) == before
        want = np.zeros(N, np.float32)
        for _ in range(4):
            want = want + np.float32(0.1)
        assert x.host().tobytes() == want.tobytes()
    finally:
        cr.dispose()


def test_compiled_counts_by_platform_keeps_each_kind_apart():
    """A host lane's launchers grow only the ``"cpu"`` count beside a GPU
    lane's (built here without a card: the emitted route builds nothing
    before its first launch on a card)."""
    prog = KernelProgram(SRC)
    prog.fused_launcher(("inc",), LR, N, LR, N, (), platform="cuda")
    cuda = prog.compiled_counts_by_platform()
    assert cuda == {"cuda": prog.compiled_count}
    prog.fused_launcher(("inc",), LR, N, LR, N, (), platform="cpu")
    prog.launcher("dbl", LR, LR, N, platform="cpu")
    both = prog.compiled_counts_by_platform()
    assert both["cuda"] == cuda["cuda"] and both["cpu"] == cuda["cuda"] + 1
    assert sum(both.values()) == prog.compiled_count


# -- across processes ----------------------------------------------------------------


def _worker(env):
    return subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_cache_worker.py")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _rpc(proc, obj):
    proc.stdin.write(json.dumps(obj) + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    assert line, f"worker died: {proc.stderr.read()[-800:]}"
    return json.loads(line)


def _run_worker(env, steps: list[dict], timeout: float = 120.0) -> list[dict]:
    """One worker: its ready line and the replies to ``steps``; killed at
    ``timeout`` seconds."""
    proc = _worker(env)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        out = [json.loads(proc.stdout.readline())]
        out += [_rpc(proc, s) for s in steps]
        _rpc(proc, {"op": "exit"})
        return out
    finally:
        timer.cancel()
        proc.kill()
        proc.wait()


def test_across_processes_a_filled_cache_warms_a_cold_process(cache_root):
    env = os.environ.copy()
    env[CACHE_ENV] = cache_root
    batch = {"op": "batch", "n": N, "lr": LR, "iters": 4, "scale": 0.1}
    ready, done, stats = _run_worker(env, [batch, {"op": "stats"}])
    assert ready["op"] == "ready" and ready["cache"] is True
    assert done["fused_compiles"] >= 1  # A was cold
    assert done["uniform"]
    assert stats["stats"]["write"] >= 1 and stats["stats"]["entries"] >= 1
    ready, warmed, done_b = _run_worker(env, [{"op": "warm_disk"}, batch])
    assert warmed["warmed"] >= 1 and warmed["hits"] >= 1 and warmed["misses"] == 0
    assert done_b["fused_compiles"] == 0 and done_b["call_compiles"] == 0
    assert done_b["uniform"] and done_b["value"] == done["value"]


# -- the library layer -----------------------------------------------------------------


def _probe_source() -> tuple[str, str]:
    tag = uuid.uuid4().hex[:8]
    return (f'extern "C" int ck_probe() {{ return 40 + 2; }} // {tag}\n', f"libprobe_{tag}")


def _build_in_child(env, src: str, name: str) -> dict:
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        from cekirdekler_tpu_torch.core.compilecache import CACHE
        from cekirdekler_tpu_torch.kernel import build
        lib = build.build_library({src!r}, {name!r}, compiler="g++")
        print(json.dumps({{"value": lib.ck_probe(), "builds": build.BUILDS.by_key,
                          "misses": CACHE.miss_reasons, "dir": str(build.lib_dir())}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_lib_layer_serves_a_second_process_without_a_compiler(cache_root):
    env = os.environ.copy()
    env[CACHE_ENV] = cache_root
    src, name = _probe_source()
    first = _build_in_child(env, src, name)
    assert first["value"] == 42 and first["builds"] == {"compile": 1, "load": 1}
    assert first["dir"] == os.path.join(cache_root, "lib")
    libs = [n for n in os.listdir(first["dir"]) if n.startswith(f"lib{name}-")]
    assert len(libs) == 1 and libs[0].endswith(".so")
    second = _build_in_child(env, src, name)
    assert second["value"] == 42 and second["builds"] == {"load": 1}
    # a truncated library: the named miss, then a rebuild from the source
    so = os.path.join(first["dir"], libs[0])
    with open(so, "r+b") as f:
        f.truncate(64)
    third = _build_in_child(env, src, name)
    assert third["value"] == 42 and third["builds"] == {"compile": 1, "load": 1}
    assert third["misses"] == {"lib-unloadable": 1}
    rows = CompileCache(root=cache_root).manifest_rows()
    assert [r["reason"] for r in rows if r.get("op") == "miss"] == ["lib-unloadable"]
    assert _build_in_child(env, src, name)["builds"] == {"load": 1}


def test_processes_building_one_library_into_one_root_converge(cache_root):
    """Three children build the same source into one ``lib/`` at once (as
    test workers sharing a root do): each loads a working library and one
    file stays."""
    env = os.environ.copy()
    env[CACHE_ENV] = cache_root
    src, name = _probe_source()
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from cekirdekler_tpu_torch.kernel import build
        print(build.build_library({src!r}, {name!r}, compiler="g++").ck_probe())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e[-800:] for _o, e in outs]
    assert [o.strip() for o, _e in outs] == ["42"] * 3
    lib = os.path.join(cache_root, "lib")
    assert len([n for n in os.listdir(lib) if n.startswith(f"lib{name}-")]) == 1
    assert not [n for n in os.listdir(lib) if n.endswith(".tmp")]


def test_unarmed_libraries_stay_in_the_build_dir(unarmed):
    assert build.lib_dir() == build.BUILD_DIR
    src, name = _probe_source()
    before = dict(build.BUILDS.by_key)
    lib = build.build_library(src, name, compiler="g++")
    assert lib.ck_probe() == 42
    assert any(n.startswith(f"lib{name}-") for n in os.listdir(build.BUILD_DIR))
    assert build.BUILDS.by_key["compile"] == before.get("compile", 0) + 1
    assert build.build_library(src, name, compiler="g++") is lib
    assert build.BUILDS.by_key["load"] == before.get("load", 0) + 1


def test_a_failed_build_in_the_lib_layer_raises(cache_root):
    with pytest.raises(KernelCompileError, match="failed to build"):
        build.build_library('extern "C" int f() { return }\n// ' + uuid.uuid4().hex,
                            "badprobe", compiler="g++")
    lib = os.path.join(cache_root, "lib")
    assert not [n for n in os.listdir(lib) if n.startswith("libbadprobe")]


# -- degraded state ------------------------------------------------------------------


def _fake_program(src=SRC):
    return types.SimpleNamespace(source=src, _py_kernels={})


def _record_n(cache, count):
    prog = _fake_program()
    keys = []
    for i in range(count):
        spec = _spec(n=N * (i + 1))
        key = cache.ladder_key(prog, spec, "cpu", "cpu")
        cache.record(key, spec, "cpu", "cpu")
        keys.append(key)
    return keys


def test_a_torn_manifest_row_and_a_corrupt_entry_are_named_misses(cache_root):
    cache = CompileCache(root=cache_root)
    keys = _record_n(cache, 2)
    assert len(cache.manifest_rows()) == 2
    with open(cache._manifest(), "a") as f:
        f.write('{"op": "write", "key": "tor')
    assert len(cache.manifest_rows()) == 2
    assert cache.miss_reasons.get("torn-manifest-row", 0) >= 1
    assert cache.stats()["entries"] == 2
    bad = os.path.join(cache._entries_dir(), keys[0] + ".json")
    with open(bad, "w") as f:
        f.write("{this is not json")
    assert cache.lookup(keys[0]) is False
    assert cache.miss_reasons.get("corrupt-entry", 0) >= 1
    assert cache.lookup(keys[1]) is True
    assert [k for k, _s in cache.load_specs()] == [keys[1]]
    v = cache.verify()
    assert keys[0] in v["corrupt"] and keys[1] in v["ok"]
    assert cache.lookup("0" * 32) is False
    assert cache.miss_reasons.get("absent", 0) >= 1


def test_concurrent_writers_converge(cache_root):
    cache = CompileCache(root=cache_root)
    prog = _fake_program()
    specs = [_spec(n=N * (i + 1)) for i in range(4)]
    keys = [cache.ladder_key(prog, s, "cpu", "cpu") for s in specs]
    errors = []

    def writer():
        try:
            for _ in range(10):
                for key, spec in zip(keys, specs):
                    cache.record(key, spec, "cpu", "cpu")
        except Exception as exc:  # noqa: BLE001 - the failure under test
            errors.append(exc)

    threads = [threading.Thread(target=writer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert sorted(k for k, _s in cache.load_specs()) == sorted(keys)
    assert cache.verify()["corrupt"] == []
    assert len(cache.manifest_rows()) >= 6 * 10 * len(keys)


def test_prune_evicts_the_oldest_to_the_cap_libraries_included(cache_root):
    cache = CompileCache(root=cache_root)
    keys = _record_n(cache, 4)
    lib = cache._lib_dir()
    os.makedirs(lib, exist_ok=True)
    libfile = os.path.join(lib, "libck_old-0123456789abcdef.so")
    with open(libfile, "wb") as f:
        f.write(b"\0" * 4096)
    tmpfile = os.path.join(lib, "libck_old-0123456789abcdef.123.456.tmp")
    with open(tmpfile, "wb") as f:  # a build in progress: never evicted
        f.write(b"\0" * 4096)
    os.utime(libfile, (500, 500))
    edir = cache._entries_dir()
    for i, key in enumerate(keys):
        os.utime(os.path.join(edir, key + ".json"), (1000 + i, 1000 + i))
    total = cache.total_bytes()
    assert total >= 4096 and cache.stats()["libraries"] == 1
    evicted = cache.prune(max_bytes=total - 4096 - 1)
    assert evicted >= 2 and cache.total_bytes() <= total - 4096 - 1
    assert not os.path.exists(libfile) and os.path.exists(tmpfile)
    left = {k for k, _s in cache.load_specs()}
    assert keys[-1] in left and keys[0] not in left
    assert cache.stats()["evict"] == evicted
    assert os.path.exists(cache._manifest())


def test_the_key_moves_with_each_of_its_parts(cache_root):
    cache = CompileCache(root=cache_root)
    prog = _fake_program()
    spec = _spec()
    k = cache.ladder_key(prog, spec, "cpu", "cpu")
    assert cache.ladder_key(prog, WarmupSpec.from_payload(json.loads(json.dumps(
        spec.to_payload()))), "cpu", "cpu") == k
    assert cache.ladder_key(prog, _spec(), "cpu", "cpu") == k
    others = [cache.ladder_key(prog, spec, "cuda", "cpu"),
              cache.ladder_key(prog, spec, "cpu", "NVIDIA H100 80GB HBM3"),
              cache.ladder_key(_fake_program(SRC + " "), spec, "cpu", "cpu"),
              cache.ladder_key(prog, _spec(values=(1.0,)), "cpu", "cpu"),
              cache.ladder_key(prog, _spec(lr=2 * LR), "cpu", "cpu")]
    assert len({k, *others}) == 6
    # compute_id and global_offset are run-time arguments, never key parts
    moved = WarmupSpec(kernels=("inc",), params=((N, "float32"),), global_range=N,
                       local_range=LR, global_offset=64, compute_id=99)
    assert cache.ladder_key(prog, moved, "cpu", "cpu") == k


def test_cache_hits_and_misses_come_with_an_armed_batch(cache_root):
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    try:
        x = ck.ClArray(np.zeros(N, np.float32), name="probe", partial_read=True)
        res = _fused_batch(cr, x, 7304, 4)
        assert res["fused"] and res["cache_hits"] == 0 and res["cache_misses"] == 0
        assert CompileCache(root=cache_root).stats()["write"] == 1  # the engage recorder
    finally:
        cr.dispose()


def test_warm_from_disk_unarmed_or_empty_warms_nothing(unarmed, tmp_path):
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    try:
        assert warm_from_disk(cr.cores)["warmed"] == 0
        assert warm_from_disk(cr.cores, CompileCache(root=str(tmp_path)))["warmed"] == 0
        assert cr.cores.program.compiled_count == 0
    finally:
        cr.dispose()


# -- the reference reads the port's root ----------------------------------------------


def test_the_reference_reads_a_root_the_port_wrote(cache_root):
    from cekirdekler_tpu.core.compilecache import CompileCache as RefCache

    cr = ck.NumberCruncher(ck.all_devices().cpus(1), SRC)
    try:
        cr.cores.warmup([_spec(), _spec(("dbl",)), _spec(n=2 * N)])
        x = ck.ClArray(np.zeros(N, np.float32), name="rr", partial_read=True)
        _fused_batch(cr, x, 7305, 4, "dbl")
    finally:
        cr.dispose()
    mine, ref = CompileCache(root=cache_root), RefCache(root=cache_root)
    assert ref.stats()["entries"] == mine.stats()["entries"] == 3
    assert {k for k, _s in ref.load_specs()} == {k for k, _s in mine.load_specs()}
    got = ref.verify()
    assert got["corrupt"] == [] and sorted(got["ok"]) == sorted(mine.verify()["ok"])
    assert ref.stats()["write"] == 3 and ref.stats()["miss_reasons"] == {}


# -- the tools -----------------------------------------------------------------------


def test_ckcache_ls_stats_prune_verify(cache_root, capsys):
    cache = CompileCache(root=cache_root)
    keys = _record_n(cache, 3)
    assert ckcache.main(["ls", "--root", cache_root]) == 0
    assert "3 entries" in capsys.readouterr().out
    assert ckcache.main(["stats", "--root", cache_root, "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["entries"] == 3 and stats["write"] == 3
    assert ckcache.main(["--verify", "--root", cache_root]) == 0
    capsys.readouterr()
    with open(os.path.join(cache._entries_dir(), keys[0] + ".json"), "w") as f:
        f.write("garbage")
    assert ckcache.main(["--verify", "--root", cache_root]) == 1
    assert keys[0] in capsys.readouterr().out
    assert ckcache.main(["prune", "--root", cache_root, "--max-mb", "0"]) == 0
    capsys.readouterr()
    assert ckcache.main(["stats", "--json"]) == 0  # the root from CK_COMPILE_CACHE
    assert json.loads(capsys.readouterr().out)["entries"] == 0


def test_ckcache_without_a_root_exits_2(unarmed, capsys):
    assert ckcache.main(["stats"]) == 2
    assert "no cache root" in capsys.readouterr().err


def test_coldstart_trio_on_host_lanes(tmp_path):
    out = coldstart.trio(str(tmp_path), n=512, local_range=64, iters=2, cpu=True,
                         timeout=180.0)
    for mode in coldstart.MODES:
        assert "error" not in out[mode], out[mode]
    assert out["ok"] and out["exact"] is True
    assert out["entries"] >= 1 and out["libraries"] == 0  # host lanes build no library
    warm = out["warm"]
    assert warm["warm"]["hits"] >= 1 and warm["warm"]["misses"] == 0
    assert warm["first_batch"] == {"launchers": 0, "compile": 0, "load": 0}
    assert out["cold"]["first_batch"]["launchers"] > 0


def test_coldstart_fails_on_a_child_that_fails():
    res = coldstart.spawn("cold", "", 512, 64, 2, cpu=True, timeout=0.01)
    assert "timeout" in res["error"]
    doc = coldstart.spawn("cold", "", 500, 64, 2, cpu=True)  # 500 is no multiple of 64
    assert "error" in doc and "digest" not in doc


def test_the_module_keeps_the_reference_names():
    from cekirdekler_tpu.core import compilecache as ref

    for name in ("CACHE_ENV", "CACHE_MAX_MB_ENV", "SCHEMA", "DEFAULT_MAX_MB"):
        assert getattr(cc, name) == getattr(ref, name)
    assert set(ref.__all__) <= set(cc.__all__)
    assert cc.probe_counts() == (int(cc._M_HIT.value), int(cc._M_MISS.value))
