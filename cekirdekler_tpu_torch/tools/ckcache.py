"""The compile cache's operator CLI (``core/compilecache.py``).

Subcommands over a cache root (``--root`` or ``CK_COMPILE_CACHE``):

- ``ls``: one line a ladder entry: key, kernels, ladder geometry
  (``plan_signature`` blocks), operand bytes, platform and device kind,
  the entry's mtime; then the libraries under ``<root>/lib``.
- ``stats``: entries, libraries and bytes on disk, and the hit/miss/write/
  evict totals read back from ``manifest.jsonl`` (the in-process
  ``ck_compile_cache_*`` counters see one interpreter; the manifest sees
  every process that used the root).
- ``prune``: evict files of ``entries/`` and ``lib/`` to the size cap
  (``--max-mb`` or ``CK_COMPILE_CACHE_MAX_MB``), oldest first (a hit
  refreshes an entry's mtime), one ``evict`` row a removal.
- ``--verify`` (on any subcommand, or alone): hash every entry payload
  again against its newest ``write`` row; a ``corrupt`` entry fails the
  exit code, an ``unindexed`` one (its write row torn away) is legal
  degraded state and only reported.

A torn manifest row or an unparsable payload is skipped with a named
reason, never raised.  Exit code 2 when there is no root.  From the
repository root, on the CPU or on a machine with the card alike::

    python -m cekirdekler_tpu_torch.tools.ckcache ls [--root DIR]
    python -m cekirdekler_tpu_torch.tools.ckcache stats [--root DIR] [--json]
    python -m cekirdekler_tpu_torch.tools.ckcache prune [--root DIR] [--max-mb N]
    python -m cekirdekler_tpu_torch.tools.ckcache --verify [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..core.compilecache import CACHE_ENV, CompileCache
from ..core.stream import plan_signature
from ..kernel.build import LIB_FILE


def _cache(args) -> CompileCache | None:
    root = args.root or os.environ.get(CACHE_ENV, "").strip()
    if not root:
        print("no cache root: pass --root or set " + CACHE_ENV, file=sys.stderr)
        return None
    return CompileCache(root=root)


def _stamp(path: str) -> tuple[int, str]:
    try:
        st = os.stat(path)
        size, mtime = st.st_size, st.st_mtime
    except OSError:
        size, mtime = 0, 0.0
    return size, time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(mtime))


def cmd_ls(cache: CompileCache) -> int:
    rows = cache.load_specs()
    edir = os.path.join(cache.root, "entries")
    for key, spec in rows:
        size, age = _stamp(os.path.join(edir, key + ".json"))
        blocks = plan_signature(spec.ladder())
        obytes = sum(n * 4 for n, _d in spec.params)  # order of magnitude
        print(f"{key}  {'+'.join(spec.kernels):<24} blocks={blocks:<24} "
              f"operands~{obytes}B entry={size}B  {age}")
    degraded = cache.miss_reasons.get("corrupt-entry", 0)
    print(f"{len(rows)} entries" + (f"  ({degraded} corrupt skipped)" if degraded else ""))
    ldir = os.path.join(cache.root, "lib")
    try:
        libs = sorted(n for n in os.listdir(ldir) if n.endswith(".so") and LIB_FILE.search(n))
    except OSError:
        libs = []
    for name in libs:
        size, age = _stamp(os.path.join(ldir, name))
        print(f"lib/{name}  {size}B  {age}")
    print(f"{len(libs)} libraries")
    return 0


def cmd_stats(cache: CompileCache, as_json: bool) -> int:
    s = cache.stats()
    if as_json:
        print(json.dumps(s, sort_keys=True, allow_nan=False))
        return 0
    print(f"root      {s['root']}")
    print(f"entries   {s['entries']}")
    print(f"libraries {s['libraries']}")
    print(f"bytes     {s['bytes']} / cap {s['max_bytes']}")
    print(f"hits      {s['hit']}")
    print(f"misses    {s['miss']}")
    print(f"writes    {s['write']}")
    print(f"evicts    {s['evict']}")
    if s["miss_reasons"]:
        print(f"degraded  {s['miss_reasons']}")
    return 0


def cmd_prune(cache: CompileCache, max_mb: float | None) -> int:
    cap = None if max_mb is None else int(max_mb * (1 << 20))
    before = cache.total_bytes()
    evicted = cache.prune(cap)
    print(f"evicted {evicted} files ({before} -> {cache.total_bytes()} bytes)")
    return 0


def cmd_verify(cache: CompileCache) -> int:
    v = cache.verify()
    print(f"ok {len(v['ok'])}  corrupt {len(v['corrupt'])}  unindexed {len(v['unindexed'])}")
    for key in v["corrupt"]:
        print(f"CORRUPT  {key}")
    for key in v["unindexed"]:
        print(f"unindexed {key}")
    return 1 if v["corrupt"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ckcache", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cmd", nargs="?", default="stats", choices=("ls", "stats", "prune"))
    ap.add_argument("--root", default=None, help=f"cache root (default ${CACHE_ENV})")
    ap.add_argument("--json", action="store_true", help="stats as one JSON line")
    ap.add_argument("--max-mb", type=float, default=None,
                    help="prune cap (default $CK_COMPILE_CACHE_MAX_MB)")
    ap.add_argument("--verify", action="store_true",
                    help="hash entries against the manifest; a corrupt entry fails the exit code")
    args = ap.parse_args(argv)
    cache = _cache(args)
    if cache is None:
        return 2
    rc = 0
    if args.cmd == "ls":
        rc = cmd_ls(cache)
    elif args.cmd == "prune":
        rc = cmd_prune(cache, args.max_mb)
    elif not args.verify or args.cmd == "stats":
        rc = cmd_stats(cache, args.json)
    if args.verify:
        rc = max(rc, cmd_verify(cache))
    return rc


if __name__ == "__main__":
    sys.exit(main())
