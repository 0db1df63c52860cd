"""Where a GPU lane's time goes in a plain-path call, alone and beside a host lane.

Mandelbrot 1024x1024x64 through ``compute()`` (local range 256) on the
first GPU lane alone, then on it and one host lane at a fixed split (1024
work items on the host lane), in turns.  For the GPU lane's phase it
times, on the host clock, the issue (the bench's start to the phase's
first fence), the fence, and the phase's wall, and on the device the span
from a CUDA event recorded at the bench's start to one recorded at that
fence; beside them the lane's bench as the balancer reads it, the host
lane's bench and the call's wall.  It prints one JSON line per case with
the medians past each run's first five calls.  ``--root`` runs another
checkout's package (a parent unpacked under ``_archive/``), so two
checkouts compare on one card in one call.  Needs a CUDA device.  From
the repository root::

    python cekirdekler_tpu_torch/tools/lane_issue.py [--root DIR] [--runs 4]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

N = 1024 * 1024
VALS = (-2.0, -1.25, 2.5 / 1024, 2.5 / 1024, 1024, 64)
HOST_ITEMS = 1024


def instrument(wk, torch) -> list[dict]:
    """Wrap the GPU lanes' ``start_bench``, ``fence`` and ``end_bench``;
    returns the list each GPU-lane phase appends its record to."""
    records: list[dict] = []
    local = threading.local()
    start, fence, end = wk.Worker.start_bench, wk.Worker.fence, wk.Worker.end_bench

    def start_bench(self, cid):
        if self.stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            local.phase = {"t0": time.perf_counter(), "ev0": ev}
        start(self, cid)

    def timed_fence(self):
        ph = getattr(local, "phase", None) if self.stream is not None else None
        if ph is None or "ti" in ph:
            return fence(self)
        ph["ti"] = time.perf_counter()
        ph["ev1"] = torch.cuda.Event(enable_timing=True)
        ph["ev1"].record(self.stream)
        fence(self)
        ph["tf"] = time.perf_counter()

    def end_bench(self, cid):
        end(self, cid)
        ph = getattr(local, "phase", None) if self.stream is not None else None
        local.phase = None
        if ph is None or "tf" not in ph:
            return
        ph["ev1"].synchronize()
        records.append({"issue": (ph["ti"] - ph["t0"]) * 1e3,
                        "fence": (ph["tf"] - ph["ti"]) * 1e3,
                        "wall": (time.perf_counter() - ph["t0"]) * 1e3,
                        "span": ph["ev0"].elapsed_time(ph["ev1"]),
                        "bench": self.benchmarks[cid]})

    wk.Worker.start_bench, wk.Worker.fence, wk.Worker.end_bench = (
        start_bench, timed_fence, end_bench)
    return records


def median(xs: list[float]) -> float | None:
    return round(statistics.median(xs), 4) if xs else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--calls", type=int, default=80)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import cekirdekler_tpu_torch as ck
    from cekirdekler_tpu_torch import workloads as wl
    from cekirdekler_tpu_torch.core import worker as wk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    records = instrument(wk, torch)
    gpu = ck.all_devices().gpus().require_nonempty("a CUDA device").subset(1)
    mixed = gpu + ck.all_devices().cpus(1)
    split = [1 - HOST_ITEMS / N, HOST_ITEMS / N]

    def run(lanes, powers) -> tuple[list[float], list[float]]:
        cr = ck.NumberCruncher(lanes, wl.MANDELBROT_SRC)
        if powers:
            cr.normalized_compute_powers_of_devices = powers
        out = ck.ClArray(N, np.float32, name="img", read=False, write=True, fast=True)
        walls, host = [], []
        try:
            for _ in range(args.calls):
                t0 = time.perf_counter()
                out.compute(cr, 7001, "mandelbrot", N, 256, values=VALS)
                walls.append((time.perf_counter() - t0) * 1e3)
                host.append(cr.benchmarks_of(7001)[-1])
        finally:
            cr.dispose()
        del records[-args.calls:-args.calls + 5]
        return walls[5:], host[5:]

    run(mixed, split)  # builds the kernel and the launchers
    cases = (("GPU lane alone", gpu, None), ("GPU lane + host lane", mixed, split))
    for turn in range(2):
        for name, lanes, powers in (cases if turn == 0 else cases[::-1]):
            records.clear()
            walls, host = [], []
            for _ in range(args.runs):
                w, h = run(lanes, powers)
                walls += w
                host += h
            print(json.dumps({
                "card": card, "root": root, "case": name, "turn": turn,
                "call_wall_ms": median(walls),
                "host_bench_ms": median(host) if powers else None,
                **{f"gpu_{k}_ms": median([r[k] for r in records])
                   for k in ("issue", "fence", "wall", "span", "bench")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
