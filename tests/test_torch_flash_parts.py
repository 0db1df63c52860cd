"""The port's ring-attention kernels' plain versions, ``flash_attention_parts``
and ``flash_attention_bwd_parts``, against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX functions (Pallas in
interpret mode, as ``tests/test_flash_attention.py`` runs them) and through
the port, whose wrappers run the plain versions on CPU tensors, with the
reference's blocks.  The offsets cover the ring's cases: the diagonal
block (``q_pos0 == k_pos0``), a block fully below it, a dead block (no
query sees a key) and offsets off any tile boundary.

Tolerances, as ``tests/test_torch_flash_attention.py`` states them: the
forward's f32 outputs within 1e-5 abs for f32 inputs, and within 1e-5 of
each output's largest magnitude for bf16 inputs (f32 arithmetic at
"highest"); the backward's f32 gradients within 5e-4, the reference's
gradient tolerance.  Raw forward parts are compared only on rows that see
at least one key: where a row sees none in a live block, the reference
leaves a tiling-dependent state and the port the empty one
(:func:`test_rows_that_see_no_key_keep_the_empty_state`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from cekirdekler_tpu.ops import flash_attention as ref  # noqa: E402
from cekirdekler_tpu_torch.ops import flash_attention as port  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
T, H, D, BLOCK = 64, 2, 16, 32
# (q_pos0, k_pos0)
OFFSETS = {"diagonal": (64, 64), "below": (128, 0), "dead": (0, 64), "unaligned": (8, 40)}


def _inputs(dtype: str, n: int, seed: int, Tq: int = T, Tk: int = T):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, t, H, D)).astype(np.float32)
              for t in (Tq, Tk, Tk, Tq)[:n]]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays])


def _visible(q_pos0: int, k_pos0: int, causal: bool, Tq: int = T) -> np.ndarray:
    """[Tq] bool: the query rows that see at least one key."""
    if not causal:
        return np.ones(Tq, bool)
    return q_pos0 + np.arange(Tq) >= k_pos0


@pytest.mark.parametrize("offsets", sorted(OFFSETS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_parts_forward_matches_reference(causal, dtype, offsets):
    (qj, kj, vj), (qt, kt, vt) = _inputs(dtype, 3, seed=1)
    q_pos0, k_pos0 = OFFSETS[offsets]
    want = ref.flash_attention_parts(qj, kj, vj, q_pos0, k_pos0, causal, BLOCK, BLOCK)
    before = port.PLAIN_RUNS.by_key.get("cpu", 0)
    got = port.flash_attention_parts(qt, kt, vt, q_pos0, k_pos0, causal, BLOCK, BLOCK)
    assert port.PLAIN_RUNS.by_key["cpu"] == before + 1
    rows = _visible(q_pos0, k_pos0, causal)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
        g, w = g.numpy()[:, rows], np.asarray(w)[:, rows]
        if g.size == 0:
            continue
        tol = 1e-5 if dtype == "f32" else 1e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    if not rows.any():  # the dead block: both give the initial state
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rows_that_see_no_key_keep_the_empty_state():
    """``flash_attention_parts(q, k, v, 0, 8, True, 16, 16)``: rows 0-7 of
    the live first block see no key.  The reference leaves them m = -1e30
    with l = 16 (``p = exp(0) = 1`` for each masked key of the block) and
    acc = the block's V sum; the port leaves m = -1e30, l = 0, acc = 0
    (ROADMAP Queue C, reference state 9).  Merged with a step whose rows
    all see a key, as the ring merges, both give the same output."""
    (qj, kj, vj), (qt, kt, vt) = _inputs("f32", 3, seed=2, Tq=16, Tk=16)
    acc_r, m_r, l_r = (np.asarray(a) for a in
                       ref.flash_attention_parts(qj, kj, vj, 0, 8, True, 16, 16))
    acc_p, m_p, l_p = (a.numpy() for a in
                       port.flash_attention_parts(qt, kt, vt, 0, 8, True, 16, 16))
    assert (m_r[:, :8] == np.float32(-1e30)).all() and (m_p[:, :8] == np.float32(-1e30)).all()
    np.testing.assert_array_equal(l_r[:, :8], 16.0)
    np.testing.assert_array_equal(l_p[:, :8], 0.0)
    np.testing.assert_allclose(acc_r[:, :8], np.broadcast_to(
        np.asarray(vj).sum(axis=1, keepdims=True), acc_r[:, :8].shape), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(acc_p[:, :8], 0.0)
    np.testing.assert_allclose(acc_p[:, 8:], acc_r[:, 8:], rtol=0, atol=1e-5)

    # the ring's merge of a diagonal step (every row sees a key) with each
    diag = [a.numpy() for a in port.flash_attention_parts(qt, kt, vt, 0, 0, True, 16, 16)]

    def merge(second):
        acc0, m0, l0 = diag
        acc1, m1, l1 = second
        m_new = np.maximum(m0, m1)
        a1, a2 = np.exp(m0 - m_new), np.exp(m1 - m_new)
        o = acc0 * a1[..., None] + acc1 * a2[..., None]
        return o / np.maximum(l0 * a1 + l1 * a2, 1e-30)[..., None]

    np.testing.assert_array_equal(merge((acc_p, m_p, l_p))[:, :8],
                                  merge((acc_r, m_r, l_r))[:, :8])


@pytest.mark.parametrize("offsets", sorted(OFFSETS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_parts_backward_matches_reference(causal, dtype, offsets):
    """lse and delta from a reference forward of q against its diagonal
    block (every row sees a key), as the ring's global ones are."""
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _inputs(dtype, 4, seed=3)
    acc, m, l = ref.flash_attention_parts(qj, kj, vj, 0, 0, causal, BLOCK, BLOCK)
    lse = m + jnp.log(l)
    out = (acc / l[..., None]).astype(qj.dtype)
    delta = jnp.einsum("bqhd,bqhd->bqh", doj.astype(jnp.float32), out.astype(jnp.float32))
    q_pos0, k_pos0 = OFFSETS[offsets]
    want = ref.flash_attention_bwd_parts(qj, kj, vj, doj, lse, delta, q_pos0, k_pos0, causal,
                                         BLOCK, BLOCK)
    lse_t, delta_t = (torch.from_numpy(np.array(a)) for a in (lse, delta))
    before = port.PLAIN_BWD_RUNS.by_key.get("cpu", 0)
    got = port.flash_attention_bwd_parts(qt, kt, vt, dot, lse_t, delta_t, q_pos0, k_pos0,
                                         causal, BLOCK, BLOCK)
    assert port.PLAIN_BWD_RUNS.by_key["cpu"] == before + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4, err_msg=name)
    if causal and offsets == "dead":
        assert not any(bool(g.any()) for g in got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parts_default_precision_rounds_p_only_for_bf16(dtype):
    """Under ``"default"`` the reference casts p (and, backward, ds) to the
    operands' type: bf16 operands round them, f32 operands do not."""
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _inputs(dtype, 4, seed=4)
    want = ref.flash_attention_parts(qj, kj, vj, 8, 40, True, BLOCK, BLOCK,
                                     precision="default")
    got = port.flash_attention_parts(qt, kt, vt, 8, 40, True, BLOCK, BLOCK,
                                     precision="default")
    rows = _visible(8, 40, True)
    for g, w in zip(got, want):
        w = np.asarray(w)[:, rows]
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy()[:, rows], w, rtol=0, atol=tol)
    lse = jnp.zeros((1, T, H), jnp.float32) + 3.0
    delta = jnp.ones((1, T, H), jnp.float32)
    want = ref.flash_attention_bwd_parts(qj, kj, vj, doj, lse, delta, 64, 64, True, BLOCK,
                                         BLOCK, precision="default")
    got = port.flash_attention_bwd_parts(qt, kt, vt, dot, torch.from_numpy(np.array(lse)),
                                         torch.from_numpy(np.array(delta)), 64, 64, True,
                                         BLOCK, BLOCK, precision="default")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4)


@pytest.mark.parametrize("fn", ["forward", "backward"])
def test_parts_refuse_blocks_that_do_not_divide(fn):
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _inputs("f32", 4, seed=5, Tq=48, Tk=48)
    row = torch.zeros(1, 48, H)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        if fn == "forward":
            port.flash_attention_parts(qt, kt, vt, 0, 0, True, 32, 32)
        else:
            port.flash_attention_bwd_parts(qt, kt, vt, dot, row, row, 0, 0, True, 32, 32)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        if fn == "forward":
            ref.flash_attention_parts(qj, kj, vj, 0, 0, True, 32, 32)
        else:
            ref.flash_attention_bwd_parts(qj, kj, vj, doj, jnp.zeros((1, 48, H)),
                                          jnp.zeros((1, 48, H)), 0, 0, True, 32, 32)


def test_a_dead_block_counts_dead_only_where_a_kernel_launches():
    """On the CPU no kernel launches: the plain versions count their runs,
    and the parts kernel counters stay where they were."""
    (_, (qt, kt, vt)) = _inputs("f32", 3, seed=6)
    before = (dict(port.PARTS_LAUNCHES.by_key), dict(port.PARTS_DEAD.by_key))
    acc, m, l = port.flash_attention_parts(qt, kt, vt, 0, 64, True, BLOCK, BLOCK)
    assert (dict(port.PARTS_LAUNCHES.by_key), dict(port.PARTS_DEAD.by_key)) == before
    assert not bool(acc.any()) and not bool(l.any())
    assert bool((m == -1e30).all())
    assert port._dead(T, 0, 64, True) and not port._dead(T, 0, 63, True)
    assert not port._dead(T, 0, 64, False)
