"""The port's experts layer, its experts transformer and ``fused_qkv``
against the JAX package, on the CPU.

The same numpy-seeded inputs (B 2-4, T 16, d 32, f 64, E 4) go through
``cekirdekler_tpu.models.moe`` and ``cekirdekler_tpu_torch.models.moe``;
the sharded forms run over the test rig's virtual CPU devices on the JAX
side and a mesh of virtual host shards on the port's.  The experts
transformer loads the reference's ``init`` through ``params_from_jax``;
at T=128 flash runs tiled (the reference in Pallas interpret mode, the
port's plain versions), at T=16 it falls back to dense attention.

Tolerances:

- routing and the kept-token masks are integer results and must be
  equal, the masks read from the port's ``RoutingLog`` and from the rows
  the reference left exactly zero;
- f32 outputs within 1e-5 of the largest magnitude (measured worst
  3.1e-7, sharded and single alike); bf16 outputs within 2e-2 of it
  (measured worst 1.0e-2, about one bf16 step at the output's scale:
  each framework rounds its bf16 products in its own order);
- f32 gradients of x, router, w1 and w2 within 1e-5 of each gradient's
  largest magnitude (measured worst 4.6e-7);
- the experts transformer: f32 logits within 1e-4 abs (measured worst
  3.1e-7), the loss within 1e-5 (measured 4.8e-7) and every gradient
  within 1e-4 of its largest magnitude (measured worst 1.5e-6); bf16
  logits within 5e-2 abs and 2e-3 mean, ``tests/test_torch_transformer.py``'s
  bounds (measured worst 4.1e-3 and 4.9e-4);
- ``fused_qkv`` within 1e-5 of the reference's three products (measured
  2.6e-7) and bit-equal to the port's own three products, and
  ``fused_qkv_attention`` within 2e-5 of its attention
  (``tests/test_blocktuner.py``'s bound).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cekirdekler_tpu import parallel as jpar  # noqa: E402
from cekirdekler_tpu.models import Transformer as RefTransformer  # noqa: E402
from cekirdekler_tpu.models import TransformerConfig as RefConfig  # noqa: E402
from cekirdekler_tpu.models import moe as ref_moe  # noqa: E402
from cekirdekler_tpu.ops import flash_attention as ref_fa  # noqa: E402
from cekirdekler_tpu_torch import parallel as par  # noqa: E402
from cekirdekler_tpu_torch import workloads  # noqa: E402
from cekirdekler_tpu_torch.models import (  # noqa: E402
    Transformer,
    TransformerConfig,
    adamw,
    params_from_jax,
)
from cekirdekler_tpu_torch.models import moe  # noqa: E402
from cekirdekler_tpu_torch.ops import flash_attention as fa  # noqa: E402

B, T, D, F_, E = 2, 16, 32, 64, 4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}
SMALL = dict(vocab=128, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=128, n_experts=E)


def _operands(seed: int, dtype: str = "f32", b: int = B, router_scale: float = 0.1):
    """x, router, w1, w2 as numpy f32, in the reference's and the port's form."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, T, D)),
              rng.standard_normal((D, E)) * router_scale,
              rng.standard_normal((E, D, F_)) * 0.1,
              rng.standard_normal((E, F_, D)) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    jd, td = DTYPES[dtype]
    ref = [jnp.asarray(arrays[0], jd)] + [jnp.asarray(a) for a in arrays[1:]]
    port = [torch.from_numpy(arrays[0]).to(td)] + [torch.from_numpy(a) for a in arrays[1:]]
    return ref, port


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol: float) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _kept_rows(y) -> np.ndarray:
    """Tokens with a non-zero output: the kept ones (a dropped token's row
    is exactly zero)."""
    return (_np(y) != 0).any(axis=-1).reshape(-1)


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_matches_reference(dtype):
    (jx, jr, _, _), (tx, tr, _, _) = _operands(1, dtype)
    jg, jidx = ref_moe._route(jx, jr)
    tg, tidx = moe._route(tx, tr)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tg, jg, 1e-6)


def test_tied_logits_go_to_the_first_expert():
    """A zero router ties every logit: argmax picks expert 0 in both."""
    (jx, _, _, _), (tx, _, _, _) = _operands(2)
    _, jidx = ref_moe._route(jx, jnp.zeros((D, E)))
    g, tidx = moe._route(tx, torch.zeros(D, E))
    assert int(tidx.max()) == 0 and np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert torch.all(g == 1.0 / E)


@pytest.mark.parametrize("n, e, cf", [
    (32, 4, 2.0), (32, 4, 0.25), (8, 2, 0.25), (10, 3, 1.1), (7, 3, 0.7), (4096, 8, 1.25),
    (100, 7, 0.3), (2, 4, 0.1), (8192, 4, 4.0), (33, 5, 1.0 / 3.0)])
def test_capacity_is_the_reference_s_expression(n, e, cf):
    assert moe.capacity(n, e, cf) == int(max(1, -(-n * cf // e)))


# -- the two forms -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_ffn_matches_reference(dtype):
    jargs, targs = _operands(3, dtype)
    want = ref_moe.moe_ffn(*jargs)
    with moe.record_routing() as log:
        got = moe.moe_ffn(*targs)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, TOL[dtype])
    (call,) = log.counts()
    assert call["capacity"] is None and call["kept"] == call["routed"]
    assert sum(call["routed"]) == B * T


@pytest.mark.parametrize("cf", [2.0, 1.0, 0.25])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_ffn_capacity_matches_reference(dtype, cf):
    """Outputs within the tolerance, and the kept tokens exactly the
    reference's: at 0.25 (C = 2 of 32 tokens) most tokens overflow."""
    jargs, targs = _operands(4, dtype)
    want = ref_moe.moe_ffn_capacity(*jargs, capacity_factor=cf)
    with moe.record_routing() as log:
        got = moe.moe_ffn_capacity(*targs, capacity_factor=cf)
    _close(got, want, TOL[dtype])
    idx, keep, n_experts, cap = log.calls[0]
    assert (n_experts, cap) == (E, moe.capacity(B * T, E, cf))
    assert np.array_equal(keep.numpy(), _kept_rows(want))
    assert np.array_equal(_kept_rows(got), _kept_rows(want))
    counts = log.counts()[0]
    assert counts["kept"] == [min(r, cap) for r in counts["routed"]]
    if cf == 0.25:
        assert sum(counts["routed"]) - sum(counts["kept"]) > B * T // 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_capacity_of_at_least_e_equals_the_dense_form(dtype):
    jargs, targs = _operands(5, dtype)
    dense = moe.moe_ffn(*targs)
    got = moe.moe_ffn_capacity(*targs, capacity_factor=float(E))
    if dtype == "f32":
        _close(got, dense, 1e-6)
    else:
        _close(got, dense, TOL[dtype])
    _close(got, ref_moe.moe_ffn(*jargs), TOL[dtype])


def test_zero_router_keeps_the_first_token_of_expert_0():
    """``tests/test_models.py``'s overflow case: every token ties to expert
    0, C = 1 at capacity 0.25 (N 8, E 2), so only the first keeps an output."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 8, 16)).astype(np.float32)
    w1 = (rng.standard_normal((2, 16, 32)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((2, 32, 16)) * 0.1).astype(np.float32)
    with moe.record_routing() as log:
        y = moe.moe_ffn_capacity(torch.from_numpy(x), torch.zeros(16, 2), torch.from_numpy(w1),
                                 torch.from_numpy(w2), capacity_factor=0.25)
    want = ref_moe.moe_ffn_capacity(jnp.asarray(x), jnp.zeros((16, 2)), jnp.asarray(w1),
                                    jnp.asarray(w2), capacity_factor=0.25)
    assert float(y[0, 0].abs().max()) > 0 and float(y[0, 1:].abs().max()) == 0
    assert log.counts() == [{"routed": [8, 0], "kept": [1, 0], "capacity": 1}]
    _close(y, want, 1e-5)


@pytest.mark.parametrize("cf", [0.0, 2.0, 0.5])
def test_gradients_match_jax_grad(cf):
    """Gradients of sum(y**2) by x, router, w1 and w2 (the router's through
    the gate only) against ``jax.grad`` of the reference."""
    jargs, targs = _operands(9)

    def ref_fn(*a):
        y = (ref_moe.moe_ffn_capacity(*a, capacity_factor=cf) if cf
             else ref_moe.moe_ffn(*a))
        return (y ** 2).sum()

    want = jax.grad(ref_fn, argnums=(0, 1, 2, 3))(*jargs)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    y = (moe.moe_ffn_capacity(*leaves, capacity_factor=cf) if cf else moe.moe_ffn(*leaves))
    got = torch.autograd.grad((y ** 2).sum(), leaves)
    for name, g, w in zip(("x", "router", "w1", "w2"), got, want):
        assert float(g.abs().max()) > 0, name
        _close(g, w, 1e-5)


# -- over an ep mesh -------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.0, 2.0, 0.5])
@pytest.mark.parametrize("n", [2, 4])
def test_moe_ffn_sharded_matches_reference(n, cf):
    jargs, targs = _operands(10, b=4)
    jmesh = jpar.make_mesh(jax.devices("cpu")[:n], ep=n)
    want = jax.jit(lambda *a: ref_moe.moe_ffn_sharded(jmesh, *a, capacity_factor=cf))(*jargs)
    mesh = par.make_mesh([torch.device("cpu")] * n, ep=n)
    with moe.record_routing() as log:
        got = moe.moe_ffn_sharded(mesh, *targs, capacity_factor=cf)
    _close(got, want, 1e-5)
    single = (moe.moe_ffn_capacity(*targs, capacity_factor=cf) if cf else moe.moe_ffn(*targs))
    _close(got, single, 1e-6)
    assert len(log.calls) == 1
    assert np.array_equal(log.calls[0][1].numpy(), _kept_rows(want))


def test_moe_ffn_sharded_refuses_an_uneven_split():
    _, targs = _operands(11)
    with pytest.raises(ValueError, match="do not split"):
        moe.moe_ffn_sharded(par.make_mesh([torch.device("cpu")] * 3, ep=3), *targs)


# -- the experts transformer -----------------------------------------------------

_PARAMS: dict = {}


def _jax_params(moe_every: int) -> dict:
    if moe_every not in _PARAMS:
        cfg = RefConfig(**SMALL, moe_every=moe_every)
        params = RefTransformer(cfg).init(jax.random.PRNGKey(moe_every))
        _PARAMS[moe_every] = jax.tree_util.tree_map(np.asarray, params)
    return _PARAMS[moe_every]


def _models(moe_every: int, cf: float, attention: str = "flash", dtype: str = "f32", **kw):
    jd, td = DTYPES[dtype]
    common = dict(SMALL, moe_every=moe_every, moe_capacity_factor=cf, attention=attention)
    ref = RefTransformer(RefConfig(**common, dtype=jd, **kw))
    port = params_from_jax(
        Transformer(TransformerConfig(**common, dtype=td, **kw), device="cpu"),
        _jax_params(moe_every))
    return ref, port


def _tokens(b: int, t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("moe_every", [1, 2])
def test_is_moe_block_is_the_reference_s(moe_every):
    ref, port = RefConfig(**SMALL, moe_every=moe_every), TransformerConfig(**SMALL,
                                                                           moe_every=moe_every)
    assert [port.is_moe_block(i) for i in range(5)] == [ref.is_moe_block(i) for i in range(5)]
    blocks = Transformer(port, device="cpu").blocks
    assert [b.router is not None for b in blocks] == [ref.is_moe_block(i) for i in range(2)]
    assert not TransformerConfig(**{**SMALL, "n_experts": 0}).is_moe_block(0)


@pytest.mark.parametrize("T_", [128, 16])
@pytest.mark.parametrize("cf", [0.0, 2.0, 0.25])
@pytest.mark.parametrize("moe_every", [1, 2])
def test_experts_transformer_logits_match_reference(moe_every, cf, T_):
    ref, port = _models(moe_every, cf)
    tokens = _tokens(2, T_, seed=12)
    want = np.asarray(ref.apply(_jax_params(moe_every), jnp.asarray(tokens)))
    before = dict(fa.ROUTES.by_key)
    with moe.record_routing() as log:
        got = port(torch.from_numpy(tokens)).detach()
    routes = {k: v - before.get(k, 0) for k, v in fa.ROUTES.by_key.items()}
    assert {k: v for k, v in routes.items() if v} == {"tiled" if T_ == 128 else "dense": 2}
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert len(log.calls) == 2 // moe_every
    assert all(c["capacity"] == (moe.capacity(2 * T_, E, cf) if cf else None)
               for c in log.counts())


@pytest.mark.parametrize("cf", [0.0, 2.0])
def test_bf16_experts_transformer_logits_match_reference(cf):
    ref, port = _models(1, cf, dtype="bf16")
    tokens = _tokens(2, 128, seed=13)
    want = np.asarray(ref.apply(_jax_params(1), jnp.asarray(tokens)))
    err = np.abs(port(torch.from_numpy(tokens)).detach().numpy() - want)
    assert err.max() <= 5e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


def _port_grads(port, tokens):
    loss = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("cf", [0.0, 2.0, 0.25])
@pytest.mark.parametrize("moe_every", [1, 2])
def test_experts_transformer_gradients_match_jax_grad(moe_every, cf):
    """The first loss and every gradient against ``jax.value_and_grad`` of
    the reference's ``loss_fn``; remat gives the same loss and gradients."""
    ref, port = _models(moe_every, cf)
    tokens = _tokens(2, 129, seed=14)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(moe_every))
    loss_ref, g_ref = jax.jit(jax.value_and_grad(ref.loss_fn))(
        params, {"tokens": jnp.asarray(tokens)})
    loss, grads = _port_grads(port, tokens)
    assert abs(loss - float(loss_ref)) <= 1e-5
    want = {"embed": g_ref["embed"], "final_norm": g_ref["final_norm"]}
    for i, blk in enumerate(g_ref["blocks"]):
        want.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name], 1e-4)
    port.config = dataclasses.replace(port.config, remat=True)
    loss_r, grads_r = _port_grads(port, tokens)
    assert loss_r == loss
    for name, g in grads.items():
        assert torch.allclose(grads_r[name], g, rtol=0, atol=1e-7 * float(g.abs().max())), name


def test_experts_tree_shapes_and_names():
    port = Transformer(TransformerConfig(**SMALL, moe_every=2), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    ref = _jax_params(2)
    for i, blk in enumerate(ref["blocks"]):
        for name, a in blk.items():
            assert shapes[f"blocks.{i}.{name}"] == a.shape, name
    assert len(shapes) == 2 + 6 + 7
    assert abs(float(port.state_dict()["blocks.1.router"].std()) - 0.02) < 5e-3


def test_run_transformer_train_on_cpu_counts_experts():
    """Three AdamW steps of the experts transformer at capacity 0.5 through
    the train runner: the loss falls, each step's routing is counted once
    (remat too), and the dropped tokens are what the counts imply."""
    _, port = _models(1, 0.5, attention="dense")
    batch = {"tokens": torch.from_numpy(_tokens(2, 17, seed=15))}
    opt = adamw(port, 1e-2)
    tr = workloads.run_transformer_train(port, opt, batch, 3)
    assert tr["losses"][-1] < tr["losses"][0]
    assert len(tr["experts"]) == 3
    for step in tr["experts"]:
        assert step["calls"] == 2 and sum(step["tokens_per_expert"]) == 2 * 32
        cap = moe.capacity(32, E, 0.5)
        assert step["dropped_tokens"] == sum(max(0, r - cap) for layer in step["layers"]
                                             for r in layer["routed"])
    rm = workloads.run_transformer_train(port, opt, batch, 1, remat=True)
    assert rm["experts"][0]["calls"] == 2


def test_run_transformer_forward_on_cpu_counts_experts():
    _, port = _models(2, 2.0)
    batches = [_tokens(2, 128, seed=16), _tokens(4, 16, seed=17)]
    res = workloads.run_transformer_forward(port, batches, keep="argmax")
    assert [e["calls"] for e in res["experts"]] == [1, 1]
    assert [sum(e["tokens_per_expert"]) for e in res["experts"]] == [256, 64]
    assert all(e["layers"][0]["capacity"] == moe.capacity(n, E, 2.0)
               for e, n in zip(res["experts"], (256, 64)))
    dense = workloads.run_transformer_forward(
        Transformer(TransformerConfig(**{**SMALL, "n_experts": 0}), device="cpu"), batches[:1])
    assert "experts" not in dense


# -- fused_qkv -------------------------------------------------------------------

def test_fused_qkv_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, f)).astype(np.float32) for f in (48, 16, 16)]
    want = ref_fa.fused_qkv(jnp.asarray(x), *map(jnp.asarray, ws))
    got = fa.fused_qkv(torch.from_numpy(x), *map(torch.from_numpy, ws))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert got[0].data_ptr() == got[0].untyped_storage().data_ptr()
    assert got[1].untyped_storage().data_ptr() == got[0].untyped_storage().data_ptr()
    # bit-equal to the port's own three products, as the reference's is to its
    for g, w in zip(got, ws):
        assert torch.equal(g, torch.from_numpy(x) @ torch.from_numpy(w))


@pytest.mark.parametrize("causal", [True, False])
def test_fused_qkv_attention_matches_reference(causal):
    rng = np.random.default_rng(8)
    Bq, Tq, Eq, H, Dh = 1, 256, 32, 2, 16
    x = (rng.standard_normal((Bq, Tq, Eq)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal((Eq, H * Dh)) * 0.3).astype(np.float32) for _ in range(3)]
    want = ref_fa.fused_qkv_attention(jnp.asarray(x), *map(jnp.asarray, ws), H, causal=causal,
                                      interpret=True)
    before = dict(fa.ROUTES.by_key)
    got = fa.fused_qkv_attention(torch.from_numpy(x), *map(torch.from_numpy, ws), H,
                                 causal=causal)
    assert fa.ROUTES.by_key.get("tiled", 0) - before.get("tiled", 0) == 1
    assert tuple(got.shape) == (Bq, Tq, H, Dh)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5
