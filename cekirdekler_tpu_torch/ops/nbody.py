"""Direct O(n²) n-body accelerations in PyTorch.

Counterpart of ``cekirdekler_tpu/ops/nbody.py`` (``nbody_accels`` and its
``@kernel`` program ``nbody_jnp_kernel``): the pairwise interaction sum as
broadcast tensor operations, a (chunk, n) distance tile per call, beside
the kernel-language version (``workloads.NBODY_SRC``, which the emitter
runs on its loop form).  It is several PyTorch calls, not a kernel: the
reference's version is one XLA program for the TPU, and on the card the
emitted kernel is the fast path.  ``chip_smoke.py`` times it beside the
emitted kernel.  :func:`microbenchmark` times one step of it on one
device, the ranking behind ``Devices.with_highest_nbody_performance``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..kernel.registry import kernel

__all__ = ["SOFTENING", "nbody_accels", "nbody_kernel", "microbenchmark"]

SOFTENING = 1e-4  # workloads.NBODY_SRC's +0.0001f


def nbody_accels(xi: torch.Tensor, yi: torch.Tensor, zi: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Accelerations on bodies (xi, yi, zi) from all bodies (x, y, z), in
    f32 over a (chunk, n) tile; ``rsqrt(r2) / r2`` as in the reference
    (``1 / (r2 * sqrt(r2))`` in the kernel language)."""
    dx = x[None, :] - xi[:, None]
    dy = y[None, :] - yi[:, None]
    dz = z[None, :] - zi[:, None]
    r2 = dx * dx + dy * dy + dz * dz + SOFTENING
    inv = torch.rsqrt(r2) / r2
    return (dx * inv).sum(dim=1), (dy * inv).sum(dim=1), (dz * inv).sum(dim=1)


def nbody_kernel():
    """The n-body velocity update as a ``@kernel`` Python program with the
    signature of ``workloads.NBODY_SRC``'s ``nBody``, for the
    load-balanced ``compute()`` path; it updates the launch chunk's
    velocities in place."""

    @kernel(name="nBody")
    def nBody(gid, x, y, z, vx, vy, vz, n=0, dt=0.0):
        s = slice(gid.start, gid.stop)
        ax, ay, az = nbody_accels(x[s], y[s], z[s], x, y, z)
        for v, a in ((vx, ax), (vy, ay), (vz, az)):
            v[s] += a * dt
        return x, y, z, vx, vy, vz

    return nBody


def microbenchmark(device, n: int = 2048, iters: int = 3) -> float:
    """Seconds per full n-body step (:func:`nbody_accels` of every body on
    every body) on ``device``, lower is faster: the reference's ranking
    metric (``Tester.nBody`` per device).  Positions are seeded; on a CUDA
    device every clock read follows ``torch.cuda.synchronize(device)``."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    pos = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
           for _ in range(3)]

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    nbody_accels(*pos, *pos)  # warm
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        nbody_accels(*pos, *pos)
    fence()
    return (time.perf_counter() - t0) / max(iters, 1)
