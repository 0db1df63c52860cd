"""The port's parallel tier against the JAX package, on the CPU: meshes,
collectives, ring attention (einsum and flash, forward and gradient) and
Ulysses attention.

The JAX side runs on the test rig's virtual CPU devices
(``jax.devices("cpu")[:n]``, ``tests/conftest.py``) under ``shard_map``,
its flash kernels in Pallas interpret mode; the port runs over
``make_mesh([torch.device("cpu")] * n, sp=n)``, a mesh of virtual host
shards whose wrappers run the plain versions.  The same numpy-seeded
inputs go through both.

Tolerances, as ``tests/test_parallel.py`` states them: ring outputs within
2e-5, gradients of ``sum(out**2)`` within 5e-4, Ulysses within 1e-5; the
bf16 ring's gradients within rel 5e-4 of the single-card flash
gradients on the same bf16 inputs (a ring that rounds its per-step
partials fails it: ``test_the_bf16_ring_test_fails_per_step_rounding``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from cekirdekler_tpu import parallel as jpar  # noqa: E402
from cekirdekler_tpu.parallel.mesh import shard_map  # noqa: E402
from cekirdekler_tpu_torch import parallel as par  # noqa: E402
from cekirdekler_tpu_torch import workloads  # noqa: E402
from cekirdekler_tpu_torch.errors import DeviceSelectionError  # noqa: E402
from cekirdekler_tpu_torch.ops import flash_attention as fa  # noqa: E402

CPU = torch.device("cpu")


def _jax_mesh(n: int, **axes):
    return jpar.make_mesh(jax.devices("cpu")[:n], **axes)


def _port_mesh(n: int, **axes):
    return par.make_mesh([CPU] * n, **axes)


def _qkv(shape, seed: int):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# -- mesh --------------------------------------------------------------------

def test_make_mesh_axis_order_and_sizes():
    mesh = _port_mesh(8, dp=2, tp=2, sp=2)
    want = _jax_mesh(8, dp=2, tp=2, sp=2)
    assert mesh.axis_names == par.AXIS_NAMES == tuple(want.axis_names)
    assert mesh.shape == dict(want.shape)
    assert mesh.shape["pp"] == 1 and mesh.size == 8


def test_make_mesh_rejects_bad_product():
    with pytest.raises(ValueError, match="multiply to 3"):
        _port_mesh(8, dp=3)


def test_auto_mesh_fills_dp():
    mesh = par.auto_mesh([CPU] * 8, tp=4)
    want = jpar.auto_mesh(jax.devices("cpu")[:8], tp=4)
    assert mesh.shape == dict(want.shape)
    assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 4
    with pytest.raises(ValueError, match="not divisible"):
        par.auto_mesh([CPU] * 6, tp=4)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """``devices=None`` means every CUDA device; with none it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceSelectionError, match="no CUDA device"):
        par.make_mesh(sp=1)
    with pytest.raises(DeviceSelectionError, match="no CUDA device"):
        par.auto_mesh()


def test_axis_devices_repeat_a_virtual_device():
    """A device named several times gives virtual shards; the positions of
    one axis are taken with every other axis at 0."""
    mesh = par.make_mesh(["cpu", "meta", "cpu", "meta"], dp=2, sp=2)
    assert mesh.axis_devices("sp") == [CPU, torch.device("meta")]
    assert mesh.axis_devices("dp") == [CPU, CPU]
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_devices("xy")


# -- collectives --------------------------------------------------------------

def _shards(x: np.ndarray, n: int) -> list[torch.Tensor]:
    return list(torch.from_numpy(x.copy()).chunk(n))


def _jax_shard_map(fn, n: int, x: np.ndarray, out_spec=P("sp")):
    mesh = _jax_mesh(n, sp=n)
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=P("sp"), out_specs=out_spec)(
        jnp.asarray(x)))


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ring_permute_matches_shard_map(shift):
    x = np.arange(8.0, dtype=np.float32)
    want = _jax_shard_map(lambda s: jpar.ppermute_ring(s, "sp", shift), 4, x)
    xs = _shards(x, 4)
    got = par.ppermute_ring(xs, shift)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert got[(0 + shift) % 4] is xs[0]  # same device: moved without a copy
    np.testing.assert_array_equal(torch.cat(par.ring_next(xs)).numpy(),
                                  _jax_shard_map(lambda s: jpar.ring_next(s, "sp"), 4, x))
    np.testing.assert_array_equal(torch.cat(par.ring_prev(xs)).numpy(),
                                  _jax_shard_map(lambda s: jpar.ring_prev(s, "sp"), 4, x))


@pytest.mark.parametrize("name", ["psum", "pmean", "pmax"])
def test_reductions_match_shard_map(name):
    x = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    want = _jax_shard_map(lambda s: getattr(jpar, name)(s, "sp"), 4, x)
    got = getattr(par, name)(_shards(x, 4))
    assert len(got) == 4 and par.axis_size(got) == 4
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather_matches_shard_map(tiled):
    x = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    want = _jax_shard_map(lambda s: jpar.all_gather(s, "sp", gather_axis=1, tiled=tiled), 4,
                          x, out_spec=P("sp"))
    got = par.all_gather(_shards(x, 4), gather_axis=1, tiled=tiled)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("tiled", [True, False])
def test_reduce_scatter_matches_shard_map(tiled):
    x = np.arange(64.0, dtype=np.float32).reshape(16, 4)
    want = _jax_shard_map(lambda s: jpar.reduce_scatter(s, "sp", scatter_axis=1, tiled=tiled),
                          4, x)
    got = par.reduce_scatter(_shards(x, 4), scatter_axis=1, tiled=tiled)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("tiled", [True, False])
def test_all_to_all_matches_shard_map(tiled):
    """The Ulysses exchange (split heads, concatenate sequence), tiled, and
    the untiled form over a dimension of the axis' size."""
    x = np.random.default_rng(4).standard_normal((1, 16, 4, 3)).astype(np.float32)
    mesh = _jax_mesh(4, sp=4)
    spec = P(None, "sp")
    want = np.asarray(shard_map(
        lambda s: jpar.all_to_all(s, "sp", split_axis=2, concat_axis=1 if tiled else 0,
                                  tiled=tiled),
        mesh=mesh, in_specs=spec, out_specs=spec)(jnp.asarray(x)))
    xs = list(torch.from_numpy(x).chunk(4, dim=1))
    got = par.all_to_all(xs, split_axis=2, concat_axis=1 if tiled else 0, tiled=tiled)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)


# -- ring attention -----------------------------------------------------------

RING = (1, 64, 2, 8)  # B, T, H, D: 16 positions per shard at sp=4


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_forward_matches_reference(causal, flash):
    (qj, kj, vj), (qt, kt, vt) = _qkv(RING, seed=11)
    want = jpar.ring_attention_sharded(_jax_mesh(4, sp=4), qj, kj, vj, causal=causal,
                                       flash=flash)
    before = fa.PLAIN_RUNS.by_key.get("cpu", 0)
    got = par.ring_attention_sharded(_port_mesh(4, sp=4), qt, kt, vt, causal=causal,
                                     flash=flash)
    assert fa.PLAIN_RUNS.by_key.get("cpu", 0) - before == (16 if flash else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == RING
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_gradients_match_reference(causal, flash):
    """Gradients of ``sum(out**2)``: the flash ring's through
    ``_RingFlashAttention`` (the backward parts per step) against
    ``jax.grad`` of the reference's flash ring (its custom_vjp); the einsum
    ring's through plain autograd against ``jax.grad`` of the reference's
    dense attention (``jax.grad`` through its einsum ring's loop takes
    seconds of tracing per case)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(RING, seed=13)
    jmesh, pmesh = _jax_mesh(4, sp=4), _port_mesh(4, sp=4)

    def loss(q, k, v):
        if not flash:
            return (jpar.attention_reference(q, k, v, causal=causal) ** 2).sum()
        return (jpar.ring_attention_sharded(jmesh, q, k, v, causal=causal,
                                            flash=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    qkv = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    before = fa.PLAIN_BWD_RUNS.by_key.get("cpu", 0)
    out = par.ring_attention_sharded(pmesh, *qkv, causal=causal, flash=flash)
    got = torch.autograd.grad(out.pow(2).sum(), qkv)
    assert fa.PLAIN_BWD_RUNS.by_key.get("cpu", 0) - before == (16 if flash else 0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4,
                                   err_msg=f"d{name}")


def _bf16_ring_rel(monkeypatch=None) -> dict[str, float]:
    """sp=8 (16 rows per shard), causal, bf16: each gradient of the ring's
    ``sum(out**2)`` against the single-card flash gradients on the same
    bf16 inputs, as a max abs error over the largest magnitude."""
    rng = np.random.default_rng(17)
    host = [torch.from_numpy(rng.standard_normal((1, 128, 2, 8)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]
    grads = {}
    for route in ("ring", "single"):
        qkv = [t.clone().requires_grad_(True) for t in host]
        if route == "ring":
            out = par.ring_attention_sharded(_port_mesh(8, sp=8), *qkv, causal=True, flash=True)
        else:
            out = fa.flash_attention(*qkv, True, 16, 16)
        grads[route] = torch.autograd.grad(out.float().pow(2).sum(), qkv)
    rel = {}
    for name, a, b in zip("qkv", grads["ring"], grads["single"]):
        assert a.dtype == b.dtype == torch.bfloat16
        rel[name] = float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-9))
    return rel


def test_bf16_ring_gradients_match_the_single_card():
    """The ring sums f32 partials and rounds once, as the single-card
    backward rounds once: within rel 5e-4."""
    rel = _bf16_ring_rel()
    assert max(rel.values()) < 5e-4, rel


def test_the_bf16_ring_test_fails_per_step_rounding(monkeypatch):
    """A ring whose per-step backward partials are rounded to bf16 stacks
    eight roundings, and the bound of the test above catches it."""
    bwd = fa.flash_attention_bwd_parts

    def rounded(*args, **kw):
        return tuple(g.to(torch.bfloat16).float() for g in bwd(*args, **kw))

    monkeypatch.setattr(fa, "flash_attention_bwd_parts", rounded)
    rel = _bf16_ring_rel()
    assert max(rel.values()) > 5e-4, rel


def test_flash_ring_falls_back_to_the_einsum_ring():
    """Shards of 4 positions admit no ``auto_block`` tile (floor 8): the
    flash ring runs the einsum ring, as the reference does."""
    (qj, kj, vj), (qt, kt, vt) = _qkv((1, 16, 2, 8), seed=19)
    assert fa.auto_block(4) is None
    before = fa.PLAIN_RUNS.by_key.get("cpu", 0)
    got = par.ring_attention_sharded(_port_mesh(4, sp=4), qt, kt, vt, causal=True, flash=True)
    assert fa.PLAIN_RUNS.by_key.get("cpu", 0) == before
    want = jpar.ring_attention_sharded(_jax_mesh(4, sp=4), qj, kj, vj, causal=True, flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_ring_refuses_a_sequence_that_does_not_split():
    q = torch.zeros(1, 30, 2, 8)
    with pytest.raises(ValueError, match="does not split"):
        par.ring_attention_sharded(_port_mesh(4, sp=4), q, q, q)


def test_run_ring_attention_on_host_shards():
    """The workload on a mesh of host shards: the output and gradients
    against the dense reference, the plain versions' runs counted (n*n
    forward parts and n*n backward parts), no kernel launched."""
    mesh = _port_mesh(4, sp=4)
    r = workloads.run_ring_attention(mesh, 1, 128, 2, 16, torch.float32, causal=True,
                                     flash=True, grad=True, seed=3)
    assert r["device"] == "cpu"
    assert r["launches"] == {"parts": {}, "dead": {}, "plain_flash": {"cpu": 16},
                             "plain_flash_bwd": {"cpu": 16}}
    assert r["tokens_per_s"]["forward"] > 0 and r["tokens_per_s"]["forward_backward"] > 0
    qkv = [r[k].clone().requires_grad_(True) for k in "qkv"]
    want = par.attention_reference(*qkv, causal=True)
    np.testing.assert_allclose(r["out"].numpy(), want.detach().numpy(), rtol=0, atol=2e-5)
    for g, w in zip(r["grads"], torch.autograd.grad(want.pow(2).sum(), qkv)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-4)


# -- Ulysses ------------------------------------------------------------------

ULYSSES = (1, 32, 4, 8)  # H divisible by sp=4


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_matches_reference(causal):
    (qj, kj, vj), (qt, kt, vt) = _qkv(ULYSSES, seed=1)
    want = jpar.ulysses_attention_sharded(_jax_mesh(4, sp=4), qj, kj, vj, causal=causal)
    got = par.ulysses_attention_sharded(_port_mesh(4, sp=4), qt, kt, vt, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_flash_matches_dense_forward_and_gradient(causal):
    """``flash=True`` against the reference's ``flash=False`` (its own
    flash Ulysses test is red on this jax, ROADMAP Queue C 2) and against
    the port's dense path, forward and the gradients of ``sum(out**2)``."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(ULYSSES, seed=7)
    jmesh, pmesh = _jax_mesh(4, sp=4), _port_mesh(4, sp=4)

    def jloss(q, k, v):
        return (jpar.ulysses_attention_sharded(jmesh, q, k, v, causal=causal) ** 2).sum()

    want_out = jpar.ulysses_attention_sharded(jmesh, qj, kj, vj, causal=causal)
    want = jax.grad(jloss, argnums=(0, 1, 2))(qj, kj, vj)
    results = {}
    for flash in (True, False):
        qkv = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
        before = fa.PLAIN_RUNS.by_key.get("cpu", 0)
        out = par.ulysses_attention_sharded(pmesh, *qkv, causal=causal, flash=flash)
        assert fa.PLAIN_RUNS.by_key.get("cpu", 0) - before == (4 if flash else 0)
        results[flash] = (out, torch.autograd.grad(out.pow(2).sum(), qkv))
    for flash, (out, grads) in results.items():
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0,
                                   atol=1e-5)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4)
    for g, w in zip(results[True][1], results[False][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-4)


def test_ulysses_refuses_heads_that_do_not_split():
    q = torch.zeros(1, 32, 2, 8)
    with pytest.raises(ValueError, match="does not split"):
        par.ulysses_attention_sharded(_port_mesh(4, sp=4), q, q, q)
