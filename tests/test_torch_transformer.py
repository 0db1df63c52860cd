"""The port's transformer forward against the JAX package, on the CPU.

The JAX ``Transformer(cfg).init(PRNGKey(0))`` weights go through
``params_from_jax`` into the port's ``Transformer``; the same numpy-seeded
tokens go through the reference's ``apply`` (flash in Pallas interpret
mode) and the port's ``forward`` (the plain versions), and the logits are
compared.  T=256 runs flash tiled (blocks 256/256); T=32 admits only
32-wide tiles, so a flash config falls back to dense attention there, and
the test checks which route ran.

Tolerances on the logits: f32 within 1e-4 abs (measured worst 4.8e-7);
bf16 within 5e-2 abs (measured worst 4.7e-3) with a mean abs error under
2e-3 (measured worst 7.8e-4): the activations round to bf16 after every
product and norm, and each framework sums its bf16 products in its own
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cekirdekler_tpu.models import Transformer as RefTransformer  # noqa: E402
from cekirdekler_tpu.models import TransformerConfig as RefConfig  # noqa: E402
from cekirdekler_tpu.models.transformer import cross_entropy_loss as ref_xent  # noqa: E402
from cekirdekler_tpu_torch import workloads  # noqa: E402
from cekirdekler_tpu_torch.errors import DeviceSelectionError, NotPortedError  # noqa: E402
from cekirdekler_tpu_torch.models import (  # noqa: E402
    Transformer,
    TransformerConfig,
    cross_entropy_loss,
    params_from_jax,
)
from cekirdekler_tpu_torch.ops import flash_attention as fa  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=256)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    """The reference's init, as numpy arrays (the init does not depend on
    the activation dtype or the attention kind)."""
    params = RefTransformer(RefConfig(**SMALL)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(jax_params, attention: str, dtype: str):
    jd, td = DTYPES[dtype]
    ref = RefTransformer(RefConfig(**SMALL, attention=attention, dtype=jd))
    port = params_from_jax(
        Transformer(TransformerConfig(**SMALL, attention=attention, dtype=td), device="cpu"),
        jax_params)
    return ref, port


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (B, T)).astype(np.int32)


@pytest.mark.parametrize("T", [256, 32])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_reference(attention, dtype, T, jax_params):
    ref, port = _pair(jax_params, attention, dtype)
    tokens = _tokens(2, T)
    want = np.asarray(ref.apply(jax_params, jnp.asarray(tokens)))
    before = (dict(fa.ROUTES.by_key), fa.PLAIN_RUNS.count)
    got = port(torch.from_numpy(tokens))
    routes = {k: v - before[0].get(k, 0) for k, v in fa.ROUTES.by_key.items()}
    n = SMALL["n_layers"]
    # the dense config never enters flash; a flash config tiles T=256 and
    # falls back to dense attention at T=32
    expect = {} if attention == "dense" else {"tiled" if T == 256 else "dense": n}
    assert {k: v for k, v in routes.items() if v} == expect
    assert fa.PLAIN_RUNS.count - before[1] == (n if expect.get("tiled") else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.detach().numpy() - want)
    if dtype == "f32":
        assert err.max() <= 1e-4, err.max()
    else:
        assert err.max() <= 5e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_fn_matches_reference(attention, jax_params):
    ref, port = _pair(jax_params, attention, "f32")
    tokens = _tokens(2, 257, seed=1)
    want = float(ref.loss_fn(jax_params, {"tokens": jnp.asarray(tokens)}))
    got = port.loss_fn({"tokens": torch.from_numpy(tokens)}).detach()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-5, (float(got), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_entropy_loss_matches_reference(dtype):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 17, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    jd, td = DTYPES[dtype]
    want = float(ref_xent(jnp.asarray(logits, jd), jnp.asarray(labels)))
    got = float(cross_entropy_loss(torch.from_numpy(logits).to(td), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-5, (got, want)


def test_parameters_keep_reference_names_and_layouts(jax_params):
    port = Transformer(TransformerConfig(**SMALL), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes["embed"] == jax_params["embed"].shape
    for i, blk in enumerate(jax_params["blocks"]):
        for name, a in blk.items():
            assert shapes[f"blocks.{i}.{name}"] == a.shape, name
    assert all(v.dtype == torch.float32 for v in port.state_dict().values())
    assert len(shapes) == 2 + 6 * SMALL["n_layers"]


def test_seeded_init_is_reproducible():
    a = Transformer(TransformerConfig(**SMALL), device="cpu", seed=3).state_dict()
    b = Transformer(TransformerConfig(**SMALL), device="cpu", seed=3).state_dict()
    c = Transformer(TransformerConfig(**SMALL), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    # the reference's scales: embed 0.02, wqkv d^-0.5
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(a["blocks.0.wqkv"].std()) - SMALL["d_model"] ** -0.5) < 0.02


def test_params_from_jax_refuses_misshapen_and_moe_trees(jax_params):
    """A dense model refuses a misshapen array and an experts tree; an
    experts model loads the reference's experts tree and refuses it with a
    misshapen expert array or a block of the wrong kind."""
    port = Transformer(TransformerConfig(**SMALL), device="cpu")
    bad = dict(jax_params, embed=jax_params["embed"][:, :32])
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(port, bad)
    moe_cfg = dict(SMALL, n_experts=4, moe_every=2)
    moe = jax.tree_util.tree_map(
        np.asarray, RefTransformer(RefConfig(**moe_cfg)).init(jax.random.PRNGKey(1)))
    with pytest.raises(ValueError, match="router"):
        params_from_jax(port, moe)
    experts = params_from_jax(Transformer(TransformerConfig(**moe_cfg), device="cpu"), moe)
    assert torch.equal(experts.blocks[1].router, torch.tensor(moe["blocks"][1]["router"]))
    assert tuple(experts.blocks[1].w1.shape) == (4, SMALL["d_model"], SMALL["d_ff"])
    assert experts.blocks[0].router is None
    misshapen = dict(moe, blocks=[moe["blocks"][0],
                                  dict(moe["blocks"][1], w2=moe["blocks"][1]["w2"][:3])])
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(Transformer(TransformerConfig(**moe_cfg), device="cpu"), misshapen)
    with pytest.raises(ValueError, match="router"):
        params_from_jax(Transformer(TransformerConfig(**moe_cfg), device="cpu"),
                        dict(moe, blocks=[moe["blocks"][1], moe["blocks"][1]]))


@pytest.mark.parametrize("kw,match", [
    (dict(pp_stages=2), "pipeline"),
    (dict(attention="ring"), "Queue A 9"),
    (dict(attention="ulysses"), "Queue A 9"),
], ids=["pp", "ring", "ulysses"])
def test_uncovered_configs_are_refused(kw, match):
    with pytest.raises(NotPortedError, match=match):
        Transformer(TransformerConfig(**{**SMALL, **kw}), device="cpu")


@pytest.mark.parametrize("cf", [0.0, 2.0])
def test_an_experts_config_builds_and_its_mesh_paths_stay_refused(cf):
    cfg = TransformerConfig(**SMALL, n_experts=4, moe_every=1, moe_capacity_factor=cf)
    port = Transformer(cfg, device="cpu")
    assert all(b.router is not None for b in port.blocks)
    tokens = torch.from_numpy(_tokens(1, 8))
    assert tuple(port(tokens).shape) == (1, 8, SMALL["vocab"])
    with pytest.raises(NotPortedError, match="mesh"):
        port(tokens, mesh=object())
    for kw in (dict(pp_stages=2), dict(attention="ring")):
        with pytest.raises(NotPortedError):
            Transformer(dataclasses.replace(cfg, **kw), device="cpu")


def test_a_mesh_is_refused():
    port = Transformer(TransformerConfig(**SMALL), device="cpu")
    with pytest.raises(NotPortedError, match="mesh"):
        port(torch.from_numpy(_tokens(1, 8)), mesh=object())


def test_default_device_is_the_card(monkeypatch):
    """No ``device`` means ``cuda:0``; without a card that is refused, never
    a quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceSelectionError, match="no CUDA device"):
        Transformer(TransformerConfig(**SMALL))


@pytest.mark.parametrize("keep", ["argmax", "logits"])
def test_run_transformer_forward_on_cpu(keep, jax_params):
    _, port = _pair(jax_params, "flash", "f32")
    batches = [_tokens(2, 256, seed=3), _tokens(1, 32, seed=4)]
    res = workloads.run_transformer_forward(port, batches, keep=keep)
    assert res["device"] == "cpu"
    tail = () if keep == "argmax" else (SMALL["vocab"],)
    assert [tuple(o.shape) for o in res["outputs"]] == [(2, 256, *tail), (1, 32, *tail)]
    assert all(t > 0 for t in res["tokens_per_s"]) and len(res["seconds"]) == 2
    assert res["launches"] == {
        "flash_attention": 0, "plain_flash": {"cpu": SMALL["n_layers"]},
        "routes": {"tiled": SMALL["n_layers"], "dense": SMALL["n_layers"]}}
    # serving keeps no activations: the forwards ran under inference_mode
    assert all(o.is_inference() and not o.requires_grad for o in res["outputs"])
    want = port(torch.from_numpy(batches[0])).detach()
    assert torch.equal(res["outputs"][0], want.argmax(dim=-1) if keep == "argmax" else want)
    assert fa.LAUNCHES.count == 0
    with pytest.raises(ValueError, match="keep"):
        workloads.run_transformer_forward(port, batches, keep="probs")
