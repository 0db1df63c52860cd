"""Where the transformer forward's time goes on the card: a ``torch.profiler`` trace.

Builds the default-width flagship transformer (``attention="flash"``, bf16,
seeded random weights) on ``cuda:0``, answers each of
``workloads.REQUEST_BATCHES`` once untraced, then traces one more
forward per batch and prints per batch: the wall time, the device time
summed over the trace's kernels and copies, the device's busy share of the
wall (an upper bound: overlapping activities count once each), and the top
device activities by time.  Needs a CUDA device.  From the repository root::

    python -m cekirdekler_tpu_torch.tools.profile_transformer [--top 8]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from .profile_main_path import _device_us


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models import Transformer, TransformerConfig
    from ..workloads import REQUEST_BATCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = TransformerConfig(attention="flash")
    model = Transformer(cfg, seed=0)
    rng = np.random.default_rng(7)
    for b, t in REQUEST_BATCHES:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)).cuda()
        model(tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
                rows.append((evt.key, us / 1e3, evt.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        print(json.dumps({
            "card": card, "batch": [b, t], "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:args.top]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
