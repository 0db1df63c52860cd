"""The port's n-body op (``cekirdekler_tpu_torch/ops/nbody.py``) against the
JAX package's (``cekirdekler_tpu/ops/nbody.py``) on the CPU.

Both sides get the same positions, made from a numpy seed.  Both compute
``rsqrt(r2) / r2`` a pair in f32 and sum each row, but XLA and PyTorch
sum in their own orders and their rsqrt may differ by an ulp, so each
row is held within ``TOL`` of the sum of its terms' magnitudes (computed
in float64): an f32 sum of n terms is within about n·2^-24 of that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cekirdekler_tpu.ops import nbody as ref_nbody
from cekirdekler_tpu_torch import workloads
from cekirdekler_tpu_torch.kernel import codegen, lang
from cekirdekler_tpu_torch.kernel.registry import KernelProgram, launch_counts
from cekirdekler_tpu_torch.ops import nbody

TOL = 4e-5  # n = 300 terms: n·2^-24 = 1.8e-5, and an ulp of rsqrt per term


def _positions(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [((rng.random(n) - 0.5) * 2.0).astype(np.float32) for _ in range(3)]


def _magnitude(xi, yi, zi, x, y, z) -> list[np.ndarray]:
    """Per row and axis, the sum of |d·inv| over all bodies, in float64."""
    d = [a[None, :].astype(np.float64) - b[:, None].astype(np.float64)
         for a, b in ((x, xi), (y, yi), (z, zi))]
    r2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2 + nbody.SOFTENING
    inv = 1.0 / (r2 * np.sqrt(r2))
    return [np.abs(c * inv).sum(axis=1) for c in d]


@pytest.mark.parametrize("n,lo,hi", [(300, 0, 300), (300, 64, 160), (257, 250, 257)])
def test_accels_match_the_reference(n, lo, hi):
    x, y, z = _positions(n, n + lo)
    sub = [a[lo:hi] for a in (x, y, z)]
    want = ref_nbody.nbody_accels(*(jnp.asarray(a) for a in sub), jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(z))
    got = nbody.nbody_accels(*(torch.from_numpy(a) for a in sub), torch.from_numpy(x),
                             torch.from_numpy(y), torch.from_numpy(z))
    for g, w, m in zip(got, want, _magnitude(*sub, x, y, z)):
        assert g.dtype == torch.float32 and g.shape == (hi - lo,)
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= TOL * m)


@pytest.mark.parametrize("offset,chunk", [(0, 300), (96, 64)])
def test_kernel_program_matches_the_reference_program(offset, chunk):
    """The ``@kernel`` program through the registry on a host lane against
    the reference's ``nbody_jnp_kernel`` on the same chunk: the chunk's
    velocities move by a·dt, the others keep theirs."""
    n, dt = 300, 0.01
    pos = _positions(n, 5)
    vel = [np.random.default_rng(6 + k).random(n).astype(np.float32) for k in range(3)]
    ref = ref_nbody.nbody_jnp_kernel()
    want = ref.fn(jnp.arange(offset, offset + chunk, dtype=jnp.int32),
                  *(jnp.asarray(a) for a in pos + vel), n=n, dt=dt)
    prog = KernelProgram(nbody.nbody_kernel())
    assert prog.route("nBody") == "python"
    fn, _ = prog.launcher("nBody", chunk, 16, n, platform="cpu")
    arrays = tuple(torch.from_numpy(a.copy()) for a in pos + vel)
    before = launch_counts["python"]
    got = fn(offset, arrays, (n, dt))
    assert launch_counts["python"] == before + 1
    mags = _magnitude(*(a[offset:offset + chunk] for a in pos), *pos)
    for k in range(3):
        g, w = got[3 + k].numpy(), np.asarray(want[3 + k])
        np.testing.assert_array_equal(g[:offset], vel[k][:offset])
        np.testing.assert_array_equal(g[offset + chunk:], vel[k][offset + chunk:])
        s = slice(offset, offset + chunk)
        assert np.all(np.abs(g[s] - w[s]) <= TOL * mags[k] * dt + 2 * np.spacing(vel[k][s]))


def test_kernel_program_matches_the_kernel_language_version():
    """The op's sums against ``workloads.NBODY_SRC`` through the torch
    lowering (the emitter's plain version, which sums in j order)."""
    n, dt = 300, 0.01
    pos = _positions(n, 9)
    zeros = [np.zeros(n, np.float32) for _ in range(3)]
    fn, _ = KernelProgram(nbody.nbody_kernel()).launcher("nBody", n, 16, n, platform="cpu")
    got = fn(0, tuple(torch.from_numpy(a.copy()) for a in pos + zeros), (n, dt))
    kdef = lang.parse_kernels(workloads.NBODY_SRC)[0]
    plain = tuple(torch.from_numpy(a.copy()) for a in pos + zeros)
    codegen.build_kernel_fn(kdef, n, 16, n)[0](0, plain, (n, dt))
    for g, p, m in zip(got[3:], plain[3:], _magnitude(*pos, *pos)):
        assert np.all(np.abs(g.numpy() - p.numpy()) <= TOL * m * dt)
