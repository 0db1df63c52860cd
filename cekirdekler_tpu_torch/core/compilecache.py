"""The compile cache across processes, and what warms a cold process.

Counterpart of ``cekirdekler_tpu/core/compilecache.py``.  The in-process
launcher cache (``kernel/registry.KernelProgram._cache``) builds each
launch geometry once, but it dies with the process: a new process builds
every launcher again, runs ``nvcc`` on every emitted source its ``_build/``
lacks, and pays each kernel's module load at its first live launch.  This
module is the half that crosses processes:

- **Libraries** ride the library layer of ``kernel/build.py``: with
  ``CK_COMPILE_CACHE=<dir>`` set, ``build_library`` keeps its
  ``lib<name>-<hash>.so`` files in ``<dir>/lib`` (the reference points
  JAX's persistent compilation cache at ``<dir>/xla``), so a process that
  builds a source another process built loads the library from disk and
  runs no compiler.
- **Ladder-level manifest**: the library layer cannot tell a cold process
  *what to build*.  ``<dir>/entries/<key>.json`` keeps one
  :class:`WarmupSpec` per distinct ladder key (kernel signature, ladder
  geometry through ``core/stream.plan_signature``, operand shapes, baked
  values, platform, device kind, torch and CUDA versions, compiler flags),
  so :func:`warm_from_disk` builds and runs a fleet's whole signature mix
  in a cold process (``Cores.warmup``).  ``<dir>/manifest.jsonl`` is the
  append-only index (write/hit/miss/evict rows; one ``O_APPEND`` line a
  row).

Durability, as the reference's: entry payloads are written to a temporary
file and renamed (a killed writer never leaves half an entry; two
processes racing one key both rename the same content), manifest rows are
single-line appends, and every read tolerates torn or corrupt state: a
truncated manifest row, an unparsable payload or a library that does not
load is a *named miss* (``miss_reasons``), never an exception.  An unset
``CK_COMPILE_CACHE`` disables the disk layer entirely: warmup still builds
and runs every launcher in the process, and results are the same bit for
bit either way.

The LRU size cap (``CK_COMPILE_CACHE_MAX_MB``, default 512) bounds the
bytes of ``entries/`` and ``lib/``; :meth:`CompileCache.prune` evicts the
oldest files first (a hit refreshes an entry's mtime) and appends an
``evict`` row for each.  ``tools/ckcache.py`` is the operator's CLI
(``ls`` / ``stats`` / ``prune`` / ``--verify``).

Cache I/O happens only on cold paths (warmup, a window's engagement, the
CLI, a library build), never on the deferral path; the metric handles are
made at import.  The files keep the reference's layout, so the reference's
``CompileCache(root)`` reads a root this module wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass

import torch

from ..kernel import build
from ..metrics.registry import REGISTRY
from .stream import plan_signature
from .worker import launch_ladder

__all__ = [
    "CACHE_ENV",
    "CACHE_MAX_MB_ENV",
    "SCHEMA",
    "WarmupSpec",
    "CompileCache",
    "CACHE",
    "program_fingerprint",
    "warm_from_disk",
    "probe_counts",
]

CACHE_ENV = build.CACHE_ENV
CACHE_MAX_MB_ENV = "CK_COMPILE_CACHE_MAX_MB"

#: Default LRU byte cap over ``entries/`` + ``lib/``.
DEFAULT_MAX_MB = 512

#: Manifest format tag (the reference's: its reader reads these files).
SCHEMA = "ck-compile-cache-v1"

_M_HIT = REGISTRY.counter(
    "ck_compile_cache_hit_total",
    "persistent-cache lookups that found a manifest entry")
_M_MISS = REGISTRY.counter(
    "ck_compile_cache_miss_total",
    "persistent-cache lookups that missed (incl. named corrupt-entry misses)")
_M_WRITE = REGISTRY.counter(
    "ck_compile_cache_write_total",
    "ladder-spec entries written to the persistent cache")
_M_EVICT = REGISTRY.counter(
    "ck_compile_cache_evict_total",
    "files evicted by the persistent cache's LRU size cap")


def probe_counts() -> tuple[int, int]:
    """The (hit, miss) probe totals so far: ``Cores.compute_fused_batch``
    reads them before and after a batch, so a caller sees whether the
    batch's window paid a miss."""
    return (int(_M_HIT.value), int(_M_MISS.value))


def _canon_values(value_args) -> list:
    """JSON-stable form of a launch's value arguments (a dict becomes
    sorted ``[name, [vals...]]`` pairs; a sequence one list)."""
    if isinstance(value_args, dict):
        return [[str(k), [_scalar(v) for v in vals]]
                for k, vals in sorted(value_args.items())]
    return [_scalar(v) for v in value_args]


def _scalar(v):
    """A native Python scalar (``np.float32`` is not JSON, and its repr
    could split one key into two across processes)."""
    try:
        if isinstance(v, (bool, int, float, str)):
            return v
        return float(v)
    except Exception:  # noqa: BLE001 - an exotic value is keyed by its repr
        return repr(v)


def _freeze(values) -> tuple:
    """Deep tuple of a canonical value list: :attr:`WarmupSpec.values` sits
    in sets and dataclass hashes, and JSON gives back nested lists."""
    return tuple(_freeze(v) if isinstance(v, (list, tuple)) else v for v in values)


def _restore_values(values):
    """Inverse of :func:`_canon_values` for the dict form (pairs back to
    ``{name: tuple}``; a flat list stays a tuple)."""
    if values and all(
        isinstance(p, (list, tuple)) and len(p) == 2
        and isinstance(p[0], str) and isinstance(p[1], (list, tuple))
        for p in values
    ):
        return {k: tuple(v) for k, v in values}
    return tuple(values)


@dataclass(frozen=True)
class WarmupSpec:
    """One warmable launch shape: what warmup needs to build and run a
    job's whole predicated ladder without the job's arrays — operand sizes
    and dtypes, not identities.

    ``values`` holds the canonical form (:func:`_canon_values`), so a spec
    that went through JSON builds the same ``fused_launcher`` key as one
    taken from a live job."""

    kernels: tuple
    params: tuple            # ((size, dtype_str), ...)
    global_range: int
    local_range: int
    global_offset: int = 0
    compute_id: int = 0
    values: tuple = ()

    @staticmethod
    def from_job(kernel_names, params, compute_id, global_range, local_range,
                 global_offset=0, value_args=()) -> "WarmupSpec":
        """A live call's shape: reads ``size`` and ``dtype`` of the params,
        never their data."""
        shapes = tuple((int(p.size), str(getattr(p, "dtype", "float32"))) for p in params)
        return WarmupSpec(
            kernels=tuple(str(k) for k in kernel_names), params=shapes,
            global_range=int(global_range), local_range=int(local_range),
            global_offset=int(global_offset), compute_id=int(compute_id),
            values=_freeze(json.loads(json.dumps(_canon_values(value_args),
                                                 allow_nan=False))),
        )

    def value_args(self):
        """The live key's form of :attr:`values` (a dict or a tuple)."""
        return _restore_values(self.values)

    def ladder(self) -> list[int]:
        """This spec's binary launch ladder (the worker's own
        decomposition)."""
        return launch_ladder(self.global_range, self.local_range)

    def to_payload(self) -> dict:
        return {
            "kernels": list(self.kernels),
            "params": [[s, d] for s, d in self.params],
            "global_range": self.global_range,
            "local_range": self.local_range,
            "global_offset": self.global_offset,
            "compute_id": self.compute_id,
            "values": _canon_values(self.value_args()),
        }

    @staticmethod
    def from_payload(doc: dict) -> "WarmupSpec":
        return WarmupSpec(
            kernels=tuple(str(k) for k in doc["kernels"]),
            params=tuple((int(s), str(d)) for s, d in doc["params"]),
            global_range=int(doc["global_range"]),
            local_range=int(doc["local_range"]),
            global_offset=int(doc.get("global_offset", 0)),
            compute_id=int(doc.get("compute_id", 0)),
            values=_freeze(json.loads(json.dumps(doc.get("values", []), allow_nan=False))),
        )


def program_fingerprint(program) -> str:
    """The kernel-signature part of the key: the C source text and the
    Python kernels' names, so two programs with equal names and other
    bodies never share an entry."""
    h = hashlib.sha256()
    h.update(getattr(program, "source", "").encode())
    for name in sorted(getattr(program, "_py_kernels", {}) or ()):
        h.update(b"|py:" + name.encode())
    return h.hexdigest()[:16]


def _flags_hash() -> str:
    """The compilers' flags, a part of the key: other flags build other
    libraries."""
    blob = "\0".join((" ".join(build.NVCC_FLAGS), " ".join(build.HOST_FLAGS)))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class CompileCache:
    """The on-disk cache across processes (module docstring).

    ``root=None`` (the singleton) reads ``CK_COMPILE_CACHE`` at every
    operation, so arming and disarming through the environment needs no
    new object; an explicit root pins it (tests, the CLI)."""

    def __init__(self, root: str | None = None):
        self._root = root
        self._armed_dir: str | None = None
        #: keys looked up or recorded in this process: the engage-time
        #: recorder probes the disk at most once a key
        self._seen: set[str] = set()
        #: named reasons of degraded reads (torn row, bad payload, ...)
        self.miss_reasons: dict[str, int] = {}

    # -- environment ---------------------------------------------------------
    @property
    def root(self) -> str | None:
        if self._root is not None:
            return self._root
        r = os.environ.get(CACHE_ENV, "").strip()
        return r or None

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def max_bytes(self) -> int:
        try:
            mb = float(os.environ.get(CACHE_MAX_MB_ENV, DEFAULT_MAX_MB))
        except ValueError:
            mb = DEFAULT_MAX_MB
        return int(mb * (1 << 20))

    def _entries_dir(self) -> str:
        return os.path.join(self.root, "entries")

    def _lib_dir(self) -> str:
        return os.path.join(self.root, "lib")

    def _manifest(self) -> str:
        return os.path.join(self.root, "manifest.jsonl")

    # -- arming --------------------------------------------------------------
    def arm(self) -> bool:
        """Make ``<root>/entries`` and ``<root>/lib`` (idempotent).  The
        library layer needs nothing more: ``kernel/build.lib_dir`` reads
        the root at every build.  Returns True when a root is set."""
        root = self.root
        if root is None:
            return False
        if self._armed_dir != root:
            os.makedirs(self._entries_dir(), exist_ok=True)
            os.makedirs(self._lib_dir(), exist_ok=True)
            self._armed_dir = root
        return True

    # -- keys ----------------------------------------------------------------
    def ladder_key(self, program, spec: WarmupSpec, platform: str | None,
                   device_kind: str) -> str:
        """The key across processes: sha256 over the canonical JSON of
        everything a ladder's launchers and libraries depend on — kernel
        signature, ladder geometry (``plan_signature`` over the worker's
        own decomposition), operand shapes, baked values, launch geometry,
        platform (the lane's ``device.type``, as the live key has it),
        device kind, torch and CUDA versions and the compilers' flags.
        ``compute_id`` and ``global_offset`` are absent: both are run-time
        arguments of a launcher."""
        doc = {
            "program": program_fingerprint(program),
            "kernels": list(spec.kernels),
            "blocks": plan_signature(spec.ladder()),
            "params": [[s, d] for s, d in spec.params],
            "global_range": spec.global_range,
            "local_range": spec.local_range,
            "values": _canon_values(spec.value_args()),
            "platform": platform or "",
            "device_kind": device_kind,
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "",
            "flags": _flags_hash(),
        }
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"), allow_nan=False)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    # -- degraded-read bookkeeping -------------------------------------------
    def _named_miss(self, reason: str) -> None:
        self.miss_reasons[reason] = self.miss_reasons.get(reason, 0) + 1
        _M_MISS.inc()

    def note_miss(self, reason: str, key: str) -> None:
        """A named miss of another layer (``kernel/build``'s
        ``lib-unloadable``), counted and written to the manifest."""
        self._named_miss(reason)
        if self.enabled:
            self._append_row({"op": "miss", "key": key, "reason": reason})

    # -- reads ---------------------------------------------------------------
    def lookup(self, key: str, count: bool = True) -> bool:
        """True iff a well-formed entry for ``key`` exists.  A missing,
        torn or unparsable entry is a named miss, never an exception.  A
        hit refreshes the entry's mtime (the LRU clock) and appends a
        ``hit`` row."""
        if not self.enabled:
            return False
        path = os.path.join(self._entries_dir(), key + ".json")
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            WarmupSpec.from_payload(doc["spec"])
        except FileNotFoundError:
            if count:
                self.note_miss("absent", key)
            return False
        except Exception:  # noqa: BLE001 - a torn or corrupt payload is a miss
            if count:
                self.note_miss("corrupt-entry", key)
            return False
        if count:
            _M_HIT.inc()
            try:
                os.utime(path, None)
            except OSError:
                pass
            self._append_row({"op": "hit", "key": key})
        self._seen.add(key)
        return True

    def load_specs(self) -> list[tuple[str, WarmupSpec]]:
        """Every well-formed ``(key, spec)`` on disk: the fleet's signature
        mix.  A corrupt entry is skipped as a named miss."""
        if not self.enabled:
            return []
        out: list[tuple[str, WarmupSpec]] = []
        edir = self._entries_dir()
        try:
            names = sorted(os.listdir(edir))
        except OSError:
            return []
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(edir, name), "rb") as f:
                    doc = json.loads(f.read().decode())
                out.append((doc["key"], WarmupSpec.from_payload(doc["spec"])))
            except Exception:  # noqa: BLE001 - a corrupt entry is a named miss
                self._named_miss("corrupt-entry")
        return out

    def manifest_rows(self) -> list[dict]:
        """The manifest's parsed rows; a torn line is skipped as a named
        miss (a crashed writer's partial last line is expected state)."""
        rows: list[dict] = []
        if not self.enabled:
            return rows
        try:
            with open(self._manifest(), "rb") as f:
                data = f.read().decode(errors="replace")
        except OSError:
            return rows
        for line in data.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except Exception:  # noqa: BLE001 - a torn row is a named skip
                doc = None
            if isinstance(doc, dict):
                rows.append(doc)
            else:
                self._named_miss("torn-manifest-row")
        return rows

    # -- writes --------------------------------------------------------------
    def _append_row(self, doc: dict) -> None:
        """One manifest line in one ``O_APPEND`` write (writers interleave
        by whole lines; a torn tail is skipped by readers).  Best effort: a
        full disk must not fail a launch."""
        doc = dict(doc)
        doc["t"] = time.time()
        line = (json.dumps(doc, sort_keys=True, allow_nan=False) + "\n").encode()
        try:
            fd = os.open(self._manifest(), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError:
            pass

    def record(self, key: str, spec: WarmupSpec, platform: str | None,
               device_kind: str) -> bool:
        """Keep one ladder entry: the payload is written to a temporary
        file and renamed (two racing writers rename the same content), then
        one ``write`` row carries the payload's sha256 (what
        ``ckcache --verify`` hashes again).  ``donate`` stays in the
        payload, always false: the port donates no buffer."""
        if not self.enabled:
            return False
        self.arm()
        payload = json.dumps({
            "schema": SCHEMA,
            "key": key,
            "spec": spec.to_payload(),
            "platform": platform or "",
            "donate": False,
            "device_kind": device_kind,
        }, sort_keys=True, indent=0, allow_nan=False).encode()
        edir = self._entries_dir()
        path = os.path.join(edir, key + ".json")
        try:
            os.makedirs(edir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=edir, prefix=".tmp-" + key)
            try:
                os.write(fd, payload)
            finally:
                os.close(fd)
            os.replace(tmp, path)
        except OSError:
            return False
        self._seen.add(key)
        _M_WRITE.inc()
        self._append_row({"op": "write", "key": key,
                          "sha": hashlib.sha256(payload).hexdigest(), "bytes": len(payload)})
        self.prune()
        return True

    # -- size cap ------------------------------------------------------------
    def _lru_files(self) -> list[tuple[float, int, str]]:
        """``(mtime, bytes, path)`` of every file under the cap: entry
        payloads and finished libraries with their sources (a build's
        temporaries are not, and the manifest never is)."""
        out = []
        for d in (self._entries_dir(), self._lib_dir()):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if d == self._lib_dir() and not build.LIB_FILE.search(name):
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                if os.path.isfile(p):
                    out.append((st.st_mtime, st.st_size, p))
        return sorted(out)

    def total_bytes(self) -> int:
        return sum(b for _t, b, _p in self._lru_files())

    def prune(self, max_bytes: int | None = None) -> int:
        """Evict the oldest files until the cap holds.  Returns how many
        went; each removal appends an ``evict`` row."""
        if not self.enabled:
            return 0
        cap = self.max_bytes() if max_bytes is None else int(max_bytes)
        files = self._lru_files()
        total = sum(b for _t, b, _p in files)
        evicted = 0
        for _t, b, p in files:
            if total <= cap:
                break
            try:
                os.remove(p)
            except OSError:
                continue
            total -= b
            evicted += 1
            _M_EVICT.inc()
            self._append_row({"op": "evict", "key": os.path.basename(p), "bytes": b})
        return evicted

    # -- operator views ------------------------------------------------------
    def stats(self) -> dict:
        """Entries, libraries and bytes on disk, and the hit/miss/write/
        evict totals of the manifest (across processes: the metric
        counters see only this interpreter)."""
        rows = self.manifest_rows()
        ops = {"hit": 0, "miss": 0, "write": 0, "evict": 0}
        for r in rows:
            op = r.get("op")
            if op in ops:
                ops[op] += 1

        def names(d: str) -> list[str]:
            try:
                return os.listdir(d)
            except OSError:
                return []

        return {
            "root": self.root,
            "entries": sum(1 for n in names(self._entries_dir()) if n.endswith(".json")),
            "libraries": sum(1 for n in names(self._lib_dir())
                             if n.endswith(".so") and build.LIB_FILE.search(n)),
            "bytes": self.total_bytes(),
            "max_bytes": self.max_bytes(),
            **ops,
            "miss_reasons": dict(self.miss_reasons),
        }

    def verify(self) -> dict:
        """Hash every entry again against its newest ``write`` row.
        Returns ``{"ok": [...], "corrupt": [...], "unindexed": [...]}``;
        ``unindexed`` (an entry whose write row was torn away) is legal
        degraded state, reported so an operator can warm again."""
        want: dict[str, str] = {}
        for r in self.manifest_rows():
            if r.get("op") == "write" and "sha" in r:
                want[str(r.get("key"))] = str(r["sha"])
        ok: list[str] = []
        corrupt: list[str] = []
        unindexed: list[str] = []
        edir = self._entries_dir()
        try:
            names = sorted(os.listdir(edir))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            key = name[:-len(".json")]
            try:
                with open(os.path.join(edir, name), "rb") as f:
                    payload = f.read()
                json.loads(payload.decode())
            except Exception:  # noqa: BLE001 - unreadable is corrupt
                corrupt.append(key)
                continue
            sha = hashlib.sha256(payload).hexdigest()
            if key not in want:
                unindexed.append(key)
            elif want[key] == sha:
                ok.append(key)
            else:
                corrupt.append(key)
        return {"ok": ok, "corrupt": corrupt, "unindexed": unindexed}


#: The process's cache: its root is read from ``CK_COMPILE_CACHE`` at every
#: operation, so tests and operators arm and disarm it through the environment.
CACHE = CompileCache()


def warm_from_disk(cores, cache: CompileCache | None = None) -> dict:
    """Warm a :class:`~.cores.Cores` from the fleet's kept signature mix:
    every well-formed spec whose kernels the cores' program holds goes
    through ``Cores.warmup``, whose library builds are then loads from
    ``<root>/lib``.  A disabled cache, an empty one and corrupt entries
    all give ``{"warmed": 0, ...}``, never an exception."""
    cache = CACHE if cache is None else cache
    if not cache.enabled:
        return {"warmed": 0, "hits": 0, "misses": 0, "skipped": 0, "wall_s": 0.0,
                "kinds": {}}
    cache.arm()
    specs = []
    skipped = 0
    for _key, spec in cache.load_specs():
        if all(name in cores.program for name in spec.kernels):
            specs.append(spec)
        else:
            skipped += 1
    out = cores.warmup(specs)
    out["skipped"] += skipped
    return out
