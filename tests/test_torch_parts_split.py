"""The arithmetic of the ring's tensor-core parts kernels, on the CPU.

``csrc/flash_attention_parts_tc.cu`` runs the ring's forward parts and the
dk/dv half of its backward parts for bf16 q/k/v/dO at "highest" on bf16
tensor cores: q.k and dO.v have bf16 operands on both sides (exact
products), and the f32 operand of p.V, pT.dO and dsT.Q enters its product
as three bf16 terms, each product exact, summed in f32 per 64-wide tile and
then added to the running f32 sum.  The kernels run only on the card
(``tests/test_torch_card.py``); here a plain model of that arithmetic is
held against the port's plain versions at "highest" (within 1e-6 of each
output's largest magnitude: the split loses nothing but the order of the
f32 sums) and against the JAX package's ``flash_attention_parts`` /
``flash_attention_bwd_parts`` in Pallas interpret mode, within the
tolerances of ``tests/test_torch_flash_parts.py`` (forward 1e-5 of each
output's largest magnitude for bf16 inputs, gradients 5e-4).  The route
rule ``_parts_route`` and the CPU path's counters are checked too.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jnp = pytest.importorskip("jax.numpy")

from cekirdekler_tpu.ops import flash_attention as ref  # noqa: E402
from cekirdekler_tpu_torch.ops import flash_attention as port  # noqa: E402

NEG = -1e30
TILE = 64  # the kernels' tile: 64 queries by 64 keys
GEOMETRIES = {  # (Tq, Tk, H, D); 200 and 136 leave ragged tiles, as on the card
    "256x256x2x64": (256, 256, 2, 64),
    "256x136x2x64": (256, 136, 2, 64),
    "200x200x3x128": (200, 200, 3, 128),
}
OFFSETS = ("diagonal", "below", "dead", "unaligned")


def _offsets(name: str, Tq: int) -> tuple[int, int]:
    return {"diagonal": (Tq, Tq), "below": (2 * Tq, 0), "dead": (0, Tq),
            "unaligned": (8, 40)}[name]


def split3(x: torch.Tensor) -> list[torch.Tensor]:
    """The kernels' split of an f32 tensor into three bf16 terms, as f32:
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    subtraction exact in f32."""
    terms = []
    for _ in range(3):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def split_product(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ b`` for f32 ``x`` and bf16-valued ``b`` as the kernels take it:
    each of x's three terms times b (exact products, f32 sums), lo first."""
    hi, mid, lo = split3(x)
    return (lo @ b + mid @ b) + hi @ b


def parts_forward_model(q, k, v, q_pos0: int, k_pos0: int, causal: bool):
    """The tensor-core forward parts, plainly: per 64-key tile the online
    softmax in f32 (p = 0 while a row's max is NEG), and
    ``acc = acc * alpha + split_product(p, V)``.  A tile wholly masked for
    a row leaves it unchanged (p = 0, alpha = 1), so every row may walk
    every tile up to the block's last visible key."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    q3, k3, v3 = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    m = torch.full((B, H, Tq), NEG)
    l = torch.zeros((B, H, Tq))
    acc = torch.zeros((B, H, Tq, D))
    qpos = q_pos0 + torch.arange(Tq)
    n_end = max(0, min(Tk, q_pos0 + Tq - k_pos0)) if causal else Tk
    for n0 in range(0, n_end, TILE):
        kb, vb = k3[:, :, n0:n0 + TILE], v3[:, :, n0:n0 + TILE]
        s = (q3 @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = k_pos0 + torch.arange(n0, n0 + kb.shape[2])
            s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where((m_new == NEG)[..., None], 0.0, torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + split_product(p, vb)
        m = m_new
    return acc.permute(0, 2, 1, 3), m.permute(0, 2, 1), l.permute(0, 2, 1)


def parts_dkv_model(q, k, v, do, lse, delta, q_pos0: int, k_pos0: int, causal: bool):
    """The tensor-core dk/dv parts, plainly: per 64-query tile
    ``pT = exp(sT - lse)``, ``dsT = pT (dpT - delta) scale`` in f32, then
    ``dv += split_product(pT, dO)`` and ``dk += split_product(dsT, Q)``,
    each tile's product added to the running f32 sum.  Query rows that see
    no key add exact zeros (p = exp(NEG - lse) = 0)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    q3, k3, v3, do3 = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, do))
    lse3, dlt3 = (t.permute(0, 2, 1)[..., None].float() for t in (lse, delta))
    dk = torch.zeros((B, H, Tk, D))
    dv = torch.zeros((B, H, Tk, D))
    kpos = k_pos0 + torch.arange(Tk)
    for m0 in range(0, Tq, TILE):
        qb, dob = q3[:, :, m0:m0 + TILE], do3[:, :, m0:m0 + TILE]
        s = (qb @ k3.transpose(-1, -2)) * scale
        if causal:
            qpos = q_pos0 + torch.arange(m0, m0 + qb.shape[2])
            s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG)
        p = torch.exp(s - lse3[:, :, m0:m0 + TILE])
        dp = dob @ v3.transpose(-1, -2)
        ds = p * (dp - dlt3[:, :, m0:m0 + TILE]) * scale
        dv = dv + split_product(p.transpose(-1, -2), dob)
        dk = dk + split_product(ds.transpose(-1, -2), qb)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _inputs(geom: str, n: int, seed: int):
    Tq, Tk, H, D = GEOMETRIES[geom]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, t, H, D)).astype(np.float32)
              for t in (Tq, Tk, Tk, Tq)[:n]]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _exact_sum(terms: list[torch.Tensor]) -> torch.Tensor:
    return sum(t.double() for t in terms)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(
    st.just(0.0),
    st.floats(min_value=2.0 ** -100, max_value=2.0 ** 30, width=32),
    st.floats(min_value=-(2.0 ** 30), max_value=-(2.0 ** -100), width=32)),
    min_size=1, max_size=64))
def test_three_terms_reproduce_every_f32(xs):
    """Both signs, zero and magnitudes 2^-100 .. 2^30: hi + mid + lo, summed
    in f64, is the f32 input exactly, and every term is a bf16 value."""
    x = torch.tensor(xs, dtype=torch.float32)
    terms = split3(x)
    assert torch.equal(_exact_sum(terms), x.double())
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(min_value=-69.0, max_value=0.0, width=32), min_size=1, max_size=64))
def test_three_terms_reproduce_softmax_weights(ss):
    """p = exp(s - m) in (0, 1], the forward's and dk/dv's f32 operand,
    down to exp(-69), about 2^-99.5 (below 2^-100 the third term may fall
    under f32's normal range and lose bits, where p adds nothing at the
    gates' scale)."""
    p = torch.exp(torch.tensor(ss, dtype=torch.float32))
    assert bool((p > 0).all()) and bool((p <= 1).all())
    assert torch.equal(_exact_sum(split3(p)), p.double())


def test_two_terms_do_not():
    """hi + mid alone leaves up to 2^-17 of the input: too close to the card
    gate's 1e-5, which is why the kernels take a third term."""
    x = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 1.0, 4096).astype(np.float32))
    hi, mid, _ = split3(x)
    rel = ((hi.double() + mid.double()) - x.double()).abs() / x.double()
    assert bool((rel > 0).any())
    assert 2.0 ** -19 < float(rel.max()) <= 2.0 ** -16


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_split_forward_model_matches_plain_and_reference(geom, offsets):
    """The model against ``flash_attention_parts_plain`` at "highest"
    (64-key blocks, the kernels' tiles) within 1e-6 of each output's
    largest magnitude on rows that see a key, the empty state bit for bit
    on the rest; and against the JAX package (interpret mode) within 1e-5
    of each output's largest magnitude on rows that see a key."""
    (qj, kj, vj), (q, k, v) = _inputs(geom, 3, seed=11)
    Tq = q.shape[1]
    q_pos0, k_pos0 = _offsets(offsets, Tq)
    got = parts_forward_model(q, k, v, q_pos0, k_pos0, True)
    plain = port.flash_attention_parts_plain(q, k, v, q_pos0, k_pos0, True, TILE, "highest")
    live = plain[1] > -1e29
    for name, a, w in zip(("acc", "m", "l"), got, plain):
        sel = live[..., None].expand_as(a) if name == "acc" else live
        assert torch.equal(a[~sel], w[~sel]), name
        if bool(sel.any()):
            tol = 1e-6 * float(w[sel].abs().max())
            assert float((a[sel] - w[sel]).abs().max()) <= tol, name
    want = ref.flash_attention_parts(qj, kj, vj, q_pos0, k_pos0, True, 256, 256)
    rows = (q_pos0 + np.arange(Tq)) >= k_pos0
    for name, a, w in zip(("acc", "m", "l"), got, want):
        a, w = a.numpy()[:, rows], np.asarray(w)[:, rows]
        if a.size:
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=name)


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_split_dkv_model_matches_plain_and_reference(geom, offsets):
    """dk and dv of the model against ``flash_attention_bwd_parts_plain`` at
    "highest" within 1e-6 of each one's largest magnitude, and against the
    JAX package (interpret mode) within 5e-4, from the lse and delta of q
    against its diagonal block (every row sees a key, as the ring's global
    ones do).  A dead block gives exact zeros."""
    (qj, kj, vj, doj), (q, k, v, do) = _inputs(geom, 4, seed=12)
    Tq = q.shape[1]
    acc, m, l = port.flash_attention_parts_plain(q, k, v, 0, 0, True, TILE, "highest")
    lse = m + torch.log(l)
    delta = (do.float() * (acc / l[..., None]).to(torch.bfloat16).float()).sum(dim=-1)
    q_pos0, k_pos0 = _offsets(offsets, Tq)
    got = parts_dkv_model(q, k, v, do, lse, delta, q_pos0, k_pos0, True)
    plain = port.flash_attention_bwd_parts_plain(q, k, v, do, lse, delta, q_pos0, k_pos0, True,
                                                 TILE, TILE, "highest")[1:]
    for name, a, w in zip(("dk", "dv"), got, plain):
        if offsets == "dead":
            assert not bool(a.any()) and not bool(w.any()), name
        else:
            assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()), name
    want = ref.flash_attention_bwd_parts(qj, kj, vj, doj, jnp.asarray(lse.numpy()),
                                         jnp.asarray(delta.numpy()), q_pos0, k_pos0, True,
                                         256, 256)[1:]
    for name, a, w in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_parts_route(kind, dtype, precision):
    """bf16 at "highest" (the ring's precision): the forward and dk/dv on
    the split tensor-core kernels, dq on the FP32 kernel.  bf16 at
    "default": the forward keeps the FP32 kernel with its bf16 p', the
    backward the tensor-core kernels that round p and ds.  f32: the FP32
    kernels everywhere."""
    want = {
        (torch.bfloat16, "highest"): {"fwd": "tc3", "dq": "fp32", "dkv": "tc3"},
        (torch.bfloat16, "default"): {"fwd": "fp32", "dq": "tc", "dkv": "tc"},
        (torch.float32, "highest"): dict.fromkeys(("fwd", "dq", "dkv"), "fp32"),
        (torch.float32, "default"): dict.fromkeys(("fwd", "dq", "dkv"), "fp32"),
    }[(dtype, precision)][kind]
    assert port._parts_route(kind, dtype, precision) == want


def test_parts_route_refuses_unknown_names():
    with pytest.raises(ValueError, match="kind"):
        port._parts_route("dk", torch.bfloat16, "highest")
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="precision"):
            port._parts_route("fwd", dtype, "high")


def test_the_cpu_path_counts_no_route():
    """On CPU tensors both parts wrappers run their plain versions: no
    kernel launch, no route counted."""
    _, (q, k, v, do) = _inputs("256x136x2x64", 4, seed=13)
    counters = (port.PARTS_FWD_ROUTES, port.BWD_ROUTES, port.PARTS_LAUNCHES)
    before = [dict(c.by_key) for c in counters]
    runs = (port.PLAIN_RUNS.by_key.get("cpu", 0), port.PLAIN_BWD_RUNS.by_key.get("cpu", 0))
    acc, m, l = port.flash_attention_parts(q, k, v, 256, 0, True, 128, 136)
    row = torch.zeros(1, 256, 2)
    port.flash_attention_bwd_parts(q, k, v, do, row, row, 256, 0, True, 128, 136)
    assert [dict(c.by_key) for c in counters] == before
    assert (port.PLAIN_RUNS.by_key["cpu"], port.PLAIN_BWD_RUNS.by_key["cpu"]) == \
        (runs[0] + 1, runs[1] + 1)
