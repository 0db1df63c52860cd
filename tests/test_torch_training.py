"""The port's training path against the JAX package, on the CPU.

The JAX ``Transformer(cfg).init(PRNGKey(0))`` weights go through
``params_from_jax`` into the port's ``Transformer``; the same numpy-seeded
batch goes through ``jax.value_and_grad`` of the reference's ``loss_fn``
(flash in Pallas interpret mode) and through the port's ``loss_fn`` and
``backward`` (the plain versions).  T=256 runs flash tiled, so the
gradients of the attention come from the plain flash backward.

Tolerances, loss and every gradient: f32 within 1e-5 on the loss
(measured 4.8e-7) and 1e-4 of each gradient's largest magnitude (measured
worst 1.3e-6); bf16 within 1e-3 on the loss (measured 1.2e-5) and a
relative norm error under 5e-2 per gradient (measured worst 1.1e-2, on
the norm gains: activations round to bf16 after every product and norm,
in each framework at its own places).  Five AdamW steps against
``optax.adamw(1e-3)``: the losses within 1e-4, the reference's own bound
between its sharded and unsharded train steps (``tests/test_models.py``;
measured 9.5e-7).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cekirdekler_tpu.models import Transformer as RefTransformer  # noqa: E402
from cekirdekler_tpu.models import TransformerConfig as RefConfig  # noqa: E402
from cekirdekler_tpu_torch import workloads  # noqa: E402
from cekirdekler_tpu_torch.errors import NotPortedError  # noqa: E402
from cekirdekler_tpu_torch.models import (  # noqa: E402
    Transformer,
    TransformerConfig,
    adamw,
    params_from_jax,
)
from cekirdekler_tpu_torch.ops import flash_attention as fa  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=256)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_params():
    params = RefTransformer(RefConfig(**SMALL)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(jax_params, attention: str, dtype: str, **kw):
    jd, td = DTYPES[dtype]
    ref = RefTransformer(RefConfig(**SMALL, attention=attention, dtype=jd, **kw))
    port = params_from_jax(
        Transformer(TransformerConfig(**SMALL, attention=attention, dtype=td, **kw),
                    device="cpu"),
        jax_params)
    return ref, port


def _batch(B=2, T=256, seed=1, vocab=SMALL["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, (B, T + 1)).astype(np.int32)


def _flat(tree) -> dict:
    """The reference's params pytree under the port's parameter names."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i, blk in enumerate(tree["blocks"]):
        for name, a in blk.items():
            out[f"blocks.{i}.{name}"] = a
    return out


def _port_grads(port, tokens) -> tuple[float, dict]:
    loss = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in port.named_parameters()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_and_grads_match_reference(attention, dtype, jax_params):
    ref, port = _pair(jax_params, attention, dtype)
    tokens = _batch()
    want_loss, want = jax.value_and_grad(
        lambda p: ref.loss_fn(p, {"tokens": jnp.asarray(tokens)}))(jax_params)
    before = (fa.PLAIN_BWD_RUNS.count, dict(fa.ROUTES.by_key))
    loss, grads = _port_grads(port, tokens)
    n = SMALL["n_layers"]
    assert fa.PLAIN_BWD_RUNS.count - before[0] == (n if attention == "flash" else 0)
    assert fa.ROUTES.by_key.get("tiled", 0) - before[1].get("tiled", 0) == (
        n if attention == "flash" else 0)
    want = _flat(want)
    assert set(grads) == set(want)
    if dtype == "f32":
        assert abs(loss - float(want_loss)) <= 1e-5, (loss, float(want_loss))
    else:
        assert abs(loss - float(want_loss)) <= 1e-3, (loss, float(want_loss))
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        if dtype == "f32":
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), (name, err)
        else:
            rel = float(np.linalg.norm(g.numpy() - w) / np.linalg.norm(w))
            assert rel <= 5e-2, (name, rel)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_adamw_steps_match_optax(attention, jax_params):
    """Five steps of ``make_train_step`` with :func:`adamw` against the
    reference's ``make_train_step`` with ``optax.adamw(1e-3)``."""
    ref, port = _pair(jax_params, attention, "f32")
    batch = {"tokens": _batch(seed=2)}
    opt = optax.adamw(1e-3)
    step = jax.jit(ref.make_train_step(opt))
    params, state, want = jax_params, opt.init(jax_params), []
    for _ in range(5):
        params, state, loss = step(params, state, {"tokens": jnp.asarray(batch["tokens"])})
        want.append(float(loss))
    port_step = port.make_train_step(adamw(port, 1e-3))
    got = [float(port_step({"tokens": torch.from_numpy(batch["tokens"])})) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0]
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(_flat(params)[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
        assert p.grad is None, name  # the step leaves no gradients behind


def test_adamw_has_optax_defaults():
    port = Transformer(TransformerConfig(**SMALL), device="cpu")
    opt = adamw(port, 1e-3)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(list(port.parameters()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_gives_identical_grads(attention, dtype, jax_params):
    """``remat=True`` recomputes each block in the backward: the loss and
    every gradient but the embedding's equal the stored-activation run's
    bit for bit, and a flash block runs its forward twice per step.  The
    embedding's gradient sums repeated tokens in a scatter-add whose order
    varies from run to run even on the CPU (two runs without remat differ
    by 3.7e-9 at a largest magnitude of 0.034): within 1e-6 of its largest
    magnitude."""
    _, plain = _pair(jax_params, attention, dtype)
    _, remat = _pair(jax_params, attention, dtype, remat=True)
    tokens = _batch(seed=3)
    before = fa.PLAIN_RUNS.count
    loss_a, grads_a = _port_grads(plain, tokens)
    mid = fa.PLAIN_RUNS.count
    loss_b, grads_b = _port_grads(remat, tokens)
    n = SMALL["n_layers"] if attention == "flash" else 0
    assert (mid - before, fa.PLAIN_RUNS.count - mid) == (n, 2 * n)
    assert loss_a == loss_b
    for name, g in grads_a.items():
        if name == "embed":
            err = float((g - grads_b[name]).abs().max())
            assert err <= 1e-6 * float(g.abs().max()), err
        else:
            assert torch.equal(g, grads_b[name]), name


def test_training_reduces_loss():
    """The counterpart of ``tests/test_models.py::test_training_reduces_loss``:
    the reference's tiny config, one fixed batch, ten AdamW steps at 1e-2."""
    cfg = TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=64,
                            dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=0)
    step = model.make_train_step(adamw(model, 1e-2))
    batch = {"tokens": torch.from_numpy(_batch(4, 16, seed=0, vocab=cfg.vocab))}
    losses = [float(step(batch)) for _ in range(10)]
    assert losses[-1] < losses[0] * 0.8, losses


def test_train_step_refuses_a_mesh():
    model = Transformer(TransformerConfig(**SMALL), device="cpu")
    with pytest.raises(NotPortedError, match="mesh"):
        model.make_train_step(adamw(model, 1e-3), mesh=object())


def test_forward_is_differentiable():
    model = Transformer(TransformerConfig(**SMALL, attention="flash"), device="cpu")
    logits = model(torch.from_numpy(_batch(1, 128)[:, :-1]))
    assert logits.requires_grad
    with torch.inference_mode():
        assert not model(torch.from_numpy(_batch(1, 128)[:, :-1])).requires_grad


@pytest.mark.parametrize("remat", [False, True])
def test_run_transformer_train_on_cpu(remat, jax_params):
    """The train runner: losses, times and the launch counts of its steps
    (T=256 tiled, no kernel on the CPU), and a remat override that doubles
    the forward runs and leaves the model's config as it was."""
    _, port = _pair(jax_params, "flash", "f32")
    res = workloads.run_transformer_train(port, adamw(port, 1e-3), {"tokens": _batch(seed=4)},
                                          steps=2, remat=remat)
    n = SMALL["n_layers"]
    assert res["device"] == "cpu" and len(res["losses"]) == len(res["seconds"]) == 2
    assert all(np.isfinite(res["losses"])) and res["losses"][1] < res["losses"][0]
    assert res["tokens_per_s"] == [2 * 256 / s for s in res["seconds"]]
    assert res["launches"] == {
        "flash_attention": 0, "flash_attention_bwd": {},
        "plain_flash": {"cpu": 2 * n * (2 if remat else 1)},
        "plain_flash_bwd": {"cpu": 2 * n}, "routes": {"tiled": 2 * n * (2 if remat else 1)}}
    assert port.config.remat is False


def test_run_transformer_train_dense_route_on_cpu(jax_params):
    """T=96 admits no 128-wide tile: the step takes the dense route and no
    flash backward runs."""
    _, port = _pair(jax_params, "flash", "f32")
    res = workloads.run_transformer_train(port, adamw(port, 1e-3),
                                          {"tokens": _batch(2, 96, seed=5)}, steps=1)
    assert res["launches"] == {
        "flash_attention": 0, "flash_attention_bwd": {}, "plain_flash": {},
        "plain_flash_bwd": {}, "routes": {"dense": SMALL["n_layers"]}}
