"""Where the transformer's time goes on the card: ``torch.profiler`` traces.

Builds the default-width flagship transformer (``attention="flash"``, bf16,
seeded random weights) on ``cuda:0``, answers each of
``workloads.REQUEST_BATCHES`` once untraced, then traces one more
forward per batch (under ``inference_mode``, as serving runs it); then
takes two untraced train steps (``adamw(model, 1e-3)``) on a seeded 4x2049
batch and traces a third.  For each traced window it prints the wall time,
the device time summed over the trace's kernels and copies, the device's
busy share of the wall (an upper bound: overlapping activities count once
each), and the top device activities by time.  Needs a CUDA device.  From
the repository root::

    python -m cekirdekler_tpu_torch.tools.profile_transformer [--top 8]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from .trace_window import by_name, open_window


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models import Transformer, TransformerConfig, adamw
    from ..workloads import REQUEST_BATCHES

    def traced(label, fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_window()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = by_name(prof)
        busy_ms = sum(r[1] for r in rows)
        print(json.dumps({
            "card": card, label[0]: label[1], "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:args.top]],
        }), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = TransformerConfig(attention="flash")
    model = Transformer(cfg, seed=0)
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        for b, t in REQUEST_BATCHES:
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)).cuda()
            traced(("batch", [b, t]), lambda: model(tokens))
    step = model.make_train_step(adamw(model, 1e-3))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2049))).cuda()}
    step(batch)
    traced(("train_batch", [4, 2048]), lambda: step(batch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
