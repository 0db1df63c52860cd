"""Direct O(n²) n-body accelerations in PyTorch.

Counterpart of ``cekirdekler_tpu/ops/nbody.py`` (``nbody_accels`` and its
``@kernel`` program ``nbody_jnp_kernel``): the pairwise interaction sum as
broadcast tensor operations, a (chunk, n) distance tile per call, beside
the kernel-language version (``workloads.NBODY_SRC``, which the emitter
runs on its loop form).  It is several PyTorch calls, not a kernel: the
reference's version is one XLA program for the TPU, and on the card the
emitted kernel is the fast path.  ``chip_smoke.py`` times it beside the
emitted kernel.  The reference's ``microbenchmark`` (device ranking) is not
ported here: it waits for the port's device selection.
"""

from __future__ import annotations

import torch

from ..kernel.registry import kernel

__all__ = ["SOFTENING", "nbody_accels", "nbody_kernel"]

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
