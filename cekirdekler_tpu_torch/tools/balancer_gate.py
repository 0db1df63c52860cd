"""``chip_smoke.py``'s balancer phase alone, for comparing two checkouts.

Runs ``chip_smoke.check_balancer`` (mandelbrot 1024x1024x64 over the first
GPU lane and one host lane, 10 runs of 80 calls at each local range
1024, 512 and 256, its gate unchanged) ``--repeat`` times on the
checkout at ``--root`` (its own ``chip_smoke.py`` and package), and
prints one JSON line: the card, the root, and per repeat whether the
gate passed, with the line ``check_balancer`` printed for each local
range and, from its first run there, the median lane benches (GPU ms,
host ms) past the first five calls and the host lane's last range.  Two checkouts compare on one card in one call, in turns (A, B,
B, A).  Needs a CUDA device.  From the repository root::

    python cekirdekler_tpu_torch/tools/balancer_gate.py [--root DIR] [--repeat 2]
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import statistics
import subprocess
import sys
from pathlib import Path


def first_runs(lines: list[str]) -> dict:
    """Per local range, from the lines ``check_balancer`` prints of its
    first run: the median GPU and host lane benches (ms) past the first
    five calls, and the host lane's range at the last call."""
    res: dict = {}
    for ln in lines:
        head, _, tail = ln.partition(": ")
        if not head.startswith("local range ") or not tail.startswith("["):
            continue
        step = head.split(",")[0].removeprefix("local range ")
        if "lane benches per call" in head or "lane walls per call" in head:
            walls = ast.literal_eval(tail)[5:]
            res.setdefault(step, {})["median_ms"] = [
                statistics.median(w[k] for w in walls) for k in (0, 1)]
        elif "host-lane range per call" in head:
            res.setdefault(step, {})["last_host_range"] = ast.literal_eval(tail)[-1]
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.hardware import rate_prior

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    gpus = ck.all_devices().gpus().require_nonempty("a CUDA device")
    lanes = gpus.subset(1) + ck.all_devices().cpus(1)
    priors = [rate_prior(torch.cuda.get_device_name(0)), rate_prior("cpu")]
    runs = []
    for _ in range(args.repeat):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                chip_smoke.check_balancer(ck, wl, lanes, priors)
                passed = True
            except AssertionError:
                passed = False
        lines = out.getvalue().splitlines()
        runs.append({"passed": passed,
                     "settled": [ln for ln in lines if ": settled within" in ln],
                     "first_run": first_runs(lines)})
    print(json.dumps({"card": card, "root": root, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
