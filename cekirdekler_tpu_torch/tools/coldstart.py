"""A cold process's first batch against one warmed from the compile cache.

Three child interpreters, one after another (a cold process is a property
of a process: it cannot be measured inside one):

- **cold**: no ``CK_COMPILE_CACHE``.  Its libraries come from the
  package's ``_build/``, which may already hold them: a restart on the
  same host.
- **populate**: the cache armed at an empty root.  It runs the compiler
  for every library (a fresh host), and the live engage-time recorder
  (``Cores._cache_record_engaged``) writes the window's entry while the
  library layer writes ``<root>/lib``.
- **warm**: the cache armed at the populated root.  ``warm_from_disk``
  builds and runs the kept ladders before the same first batch.

The workload is n-body through ``Cores.compute_fused_batch`` (the
enqueue-mode batch entry; ``workloads.NBODY_SRC``, the emitter's loop form
on the card) at n = 8192, local range 256, on the first CUDA device, or on
a host lane with ``--cpu``.  Each child times its first batch and a steady
one (each ends at a barrier), counts the compiler runs, library loads and
launcher builds of its first batch and the emitted kernel's launches, and
hashes its velocities: ``exact`` is false unless all three hashes agree,
as the cache must change no bit.  Each child has its own timeout; a child
that fails or times out fails the tool, and gives no number.  From the
repository root::

    python -m cekirdekler_tpu_torch.tools.coldstart [--n 8192] [--iters 4] [--cpu] [--json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CACHE_ENV = "CK_COMPILE_CACHE"  # core/compilecache's, set before the child imports the package

ROOT = Path(__file__).resolve().parents[2]
CHILD_TIMEOUT_S = 240.0
MODES = ("cold", "populate", "warm")
_CID = 9001  # one compute id in every child


# -- a child -------------------------------------------------------------------


def _digest(*arrays) -> str:
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _child_nbody(args, out: dict) -> dict:
    import numpy as np

    from .. import ClArray, NumberCruncher, all_devices
    from ..core.compilecache import warm_from_disk
    from ..kernel import cuda_backend
    from ..kernel.build import BUILDS
    from ..workloads import NBODY_SRC

    n, lr, dt = args.n, args.local_range, 0.0001
    rng = np.random.default_rng(42)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    x, y, z = (ClArray(pos[i].copy(), name=c, read_only=True) for i, c in enumerate("xyz"))
    vel = [ClArray(n, np.float32, name=f"v{c}", partial_read=True) for c in "xyz"]
    devs = all_devices()
    devs = devs.cpus(1) if args.cpu else devs.gpus().require_nonempty("a CUDA device").subset(1)
    out["device"] = devs[0].kind
    cr = NumberCruncher(devs, NBODY_SRC)
    prog = cr.cores.program
    params = [x, y, z, *vel]
    vals = {"nBody": (n, dt)}
    try:
        if args.child == "warm":
            t0 = time.perf_counter()
            out["warm"] = warm_from_disk(cr.cores)
            out["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        cr.enqueue_mode = True

        def batch() -> dict:
            builds = dict(BUILDS.by_key)
            launchers = prog.compiled_count
            t0 = time.perf_counter()
            cr.cores.compute_fused_batch(["nBody"], params, _CID, n, lr, args.iters,
                                         value_args=vals)
            cr.barrier()
            ms = (time.perf_counter() - t0) * 1e3
            return {"ms": ms, "launchers": prog.compiled_count - launchers,
                    **{k: BUILDS.by_key.get(k, 0) - builds.get(k, 0)
                       for k in ("compile", "load")}}

        first = batch()
        steady = batch()
        cr.enqueue_mode = False  # the flush: the velocities come back
        out["first_batch_ms"] = first.pop("ms")
        out["steady_batch_ms"] = steady.pop("ms")
        out["first_batch"] = first
        out["builds"] = dict(BUILDS.by_key)
        out["launches"] = dict(cuda_backend.LAUNCHES.by_key)  # the card's kernel launches
        out["digest"] = _digest(*(v.host() for v in vel))
    finally:
        cr.dispose()
    return out


def _child(args) -> int:
    """Run one child; print exactly one JSON line."""
    if args.cache:
        os.environ[CACHE_ENV] = args.cache
    else:
        os.environ.pop(CACHE_ENV, None)
    out: dict = {"mode": args.child, "cache": bool(args.cache), "pid": os.getpid()}
    try:
        out = _child_nbody(args, out)
    except Exception as exc:  # a child's failure is reported, never a number
        out["error"] = f"{type(exc).__name__}: {exc}"
        print(json.dumps(out, allow_nan=False))
        return 1
    print(json.dumps(out, allow_nan=False))
    return 0


# -- the parent ----------------------------------------------------------------


def spawn(mode: str, cache: str, n: int, local_range: int, iters: int, cpu: bool,
          timeout: float = CHILD_TIMEOUT_S) -> dict:
    """One child, with its own timeout; its JSON line, or ``{"error"}``."""
    env = os.environ.copy()
    env.pop(CACHE_ENV, None)  # the child's --cache alone decides
    cmd = [sys.executable, "-m", "cekirdekler_tpu_torch.tools.coldstart", "--child", mode,
           "--cache", cache, "--n", str(n), "--local-range", str(local_range),
           "--iters", str(iters)] + (["--cpu"] if cpu else [])
    try:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"mode": mode, "error": f"timeout after {timeout} s"}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if proc.returncode != 0 and "error" not in doc:
            doc["error"] = f"exit code {proc.returncode}"
        return doc
    return {"mode": mode, "error": f"no JSON from the child (exit code {proc.returncode}): "
                                   f"{proc.stderr.strip()[-400:]}"}


def trio(root: str, n: int = 8192, local_range: int = 256, iters: int = 4, cpu: bool = False,
         timeout: float = CHILD_TIMEOUT_S) -> dict:
    """cold, populate and warm over one cache root under ``root``; the
    three children's lines, ``exact``, ``ok`` (no child failed) and what
    populate left on disk (``entries``, ``libraries``)."""
    from ..core.compilecache import CompileCache

    cache = os.path.join(root, "nbody")
    os.makedirs(cache, exist_ok=True)
    kw = dict(n=n, local_range=local_range, iters=iters, cpu=cpu, timeout=timeout)
    out: dict = {"cold": spawn("cold", "", **kw)}
    out["populate"] = spawn("populate", cache, **kw)
    stats = CompileCache(root=cache).stats()
    out["entries"], out["libraries"] = stats["entries"], stats["libraries"]
    out["warm"] = spawn("warm", cache, **kw)
    digests = [out[m].get("digest") for m in MODES]
    out["ok"] = not any("error" in out[m] for m in MODES)
    out["exact"] = out["ok"] and None not in digests and len(set(digests)) == 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cekirdekler_tpu_torch.tools.coldstart",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", default=None, choices=MODES, help=argparse.SUPPRESS)
    ap.add_argument("--cache", default="", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--local-range", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="a host lane instead of the card")
    ap.add_argument("--timeout", type=float, default=CHILD_TIMEOUT_S, help="seconds a child")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    root = tempfile.mkdtemp(prefix="ck_coldstart_")
    try:
        out = trio(root, args.n, args.local_range, args.iters, args.cpu, args.timeout)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True, allow_nan=False))
    else:
        for m in MODES:
            c = out[m]
            if "error" in c:
                print(f"{m:9s} FAILED: {c['error']}")
                continue
            warm = (f", warm_from_disk {c['warmup_ms']:.1f} ms {c['warm']}"
                    if "warm" in c else "")
            print(f"{m:9s} first batch {c['first_batch_ms']:.3f} ms {c['first_batch']}, "
                  f"steady {c['steady_batch_ms']:.3f} ms, builds {c['builds']}{warm}")
        print(f"populate left {out['entries']} entries, {out['libraries']} libraries; "
              f"exact {out['exact']}")
    return 0 if out["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
