"""A cold interpreter over the port's ``NumberCruncher`` for the compile
cache's tests across processes (the protocol of the reference's
``tests/_cache_worker.py``: the parent spawns it, reads a ready line, then
sends one JSON object a line on stdin and reads one reply a line).  Used by
``tests/test_torch_compilecache.py``: process A fills the cache through the
live engage-time recorder; process B starts cold, runs ``warm_from_disk``
and shows that its first live batch builds nothing.

``CK_COMPILE_CACHE`` comes from the parent's environment.

Commands, each answered once:

- ``{"op": "warm_disk"}`` -> ``{"op": "warmed", "warmed", "hits", "misses",
  "skipped", ...}``
- ``{"op": "batch", "n", "lr", "iters", "scale"}``: one live
  ``compute_fused_batch`` of ``scl`` (a baked float value, so the JSON
  round trip of values is on the key's path) -> ``{"op": "done",
  "fused_compiles", "call_compiles", "value", "uniform"}``, the launcher
  counts this batch added
- ``{"op": "stats"}`` -> ``{"op": "stats", "stats": {...}}`` (empty when
  unarmed)
- ``{"op": "exit"}`` -> ``{"op": "bye"}`` and a clean close.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC = """
__kernel void scl(__global float* a, float s) {
    int i = get_global_id(0);
    a[i] = a[i] + s;
}
"""

CID = 7100


def main() -> None:
    import numpy as np

    from cekirdekler_tpu_torch import ClArray, NumberCruncher, all_devices
    from cekirdekler_tpu_torch.core.compilecache import CACHE, warm_from_disk

    cr = NumberCruncher(all_devices().cpus(1), SRC)
    cores = cr.cores
    arrays: dict = {}
    print(json.dumps({"op": "ready", "cache": CACHE.enabled, "pid": os.getpid()}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = json.loads(line)
        op = cmd.get("op")
        if op == "exit":
            print(json.dumps({"op": "bye"}), flush=True)
            break
        if op == "warm_disk":
            out = warm_from_disk(cores)
            print(json.dumps({"op": "warmed", **out}), flush=True)
        elif op == "batch":
            n, lr = int(cmd["n"]), int(cmd["lr"])
            iters = int(cmd.get("iters", 3))
            scale = float(cmd.get("scale", 1.0))
            if n not in arrays:
                arrays[n] = ClArray(np.zeros(n, np.float32), name=f"a{n}", partial_read=True)
            a = arrays[n]
            before = (cores.program.fused_compiled_count, cores.program.compiled_count)
            cr.enqueue_mode = True
            cores.compute_fused_batch(["scl"], [a], CID, n, lr, iters,
                                      value_args={"scl": (scale,)})
            cr.barrier()
            cr.enqueue_mode = False  # the flush
            img = a.host()
            print(json.dumps({
                "op": "done",
                "fused_compiles": cores.program.fused_compiled_count - before[0],
                "call_compiles": cores.program.compiled_count - before[1],
                "value": float(img[0]),
                "uniform": bool(np.all(img == img[0])),
            }), flush=True)
        elif op == "stats":
            print(json.dumps({"op": "stats", "stats": CACHE.stats() if CACHE.enabled else {}}),
                  flush=True)
        else:
            print(json.dumps({"op": "error", "error": f"bad op {op!r}"}), flush=True)
    cr.dispose()


if __name__ == "__main__":
    main()
