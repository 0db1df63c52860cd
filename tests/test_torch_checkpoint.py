"""The port's checkpoints (``utils/checkpoint.py``) against the reference's.

A directory written by either package loads in the other bit for bit:
``save_arrays`` over f32/i32/f64, and ``save_pytree`` of nested trees
(leaves numbered in ``jax.tree_util``'s order), the JAX ``Transformer``'s
params included, which load into the port's model through
``params_from_jax``.  bfloat16 leaves round-trip in the port without
ml_dtypes, as the same ``'<V2'`` words the reference writes (which the
reference itself reads back as raw ``V2``; ROADMAP Queue C, reference
state).  The torn-newest fallback, the explicit-step and leaf-mismatch
raises and the stale-tmp sweep behave as the reference's.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cekirdekler_tpu.models import Transformer as RefTransformer  # noqa: E402
from cekirdekler_tpu.models import TransformerConfig as RefConfig  # noqa: E402
from cekirdekler_tpu.utils import checkpoint as ref  # noqa: E402
from cekirdekler_tpu_torch.models import (  # noqa: E402
    Transformer,
    TransformerConfig,
    params_from_jax,
)
from cekirdekler_tpu_torch.obs.flight import FLIGHT  # noqa: E402
from cekirdekler_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from tests.test_torch_metrics import restore_planes, save_planes  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=256)
DTYPES = (np.float32, np.int32, np.float64)


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"a{k}_{np.dtype(dt).name}": (rng.standard_normal(17 + k) * 1e3).astype(dt)
            for k, dt in enumerate(DTYPES)}


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _tree(seed: int) -> dict:
    """A nested tree of the shapes optimizer state takes: dicts with int
    and str keys out of order, lists, tuples and None nodes."""
    rng = np.random.default_rng(seed)
    a = _arrays(seed)
    return {"state": {3: {"m": a["a0_float32"], "v": a["a1_int32"]},
                      1: {"m": a["a2_float64"], "v": rng.standard_normal(3)}},
            "groups": [{"lr": np.float64(1e-3), "betas": (np.float32(0.9), np.float32(0.999)),
                        "fused": None}],
            "b": [np.arange(4, dtype=np.int32), None, np.float32(2.5)]}


@pytest.mark.parametrize("seed", range(4))
def test_reference_arrays_load_in_the_port_and_back(tmp_path, seed):
    want = _arrays(seed)
    ref.save_arrays(str(tmp_path / "r"), seed, want)
    got = ckpt.load_arrays(str(tmp_path / "r"))
    assert sorted(got) == sorted(want) and all(_same(got[k], want[k]) for k in want)
    ckpt.save_arrays(str(tmp_path / "p"), seed, want)
    back = ref.load_arrays(str(tmp_path / "p"), step=seed)
    assert all(_same(back[k], want[k]) for k in want)
    assert ckpt.latest_step(str(tmp_path / "p")) == ref.latest_step(str(tmp_path / "p")) == seed


@pytest.mark.parametrize("seed", range(4))
def test_pytrees_cross_packages_in_jax_leaf_order(tmp_path, seed):
    tree = _tree(seed)
    ref.save_pytree(str(tmp_path / "r"), 2, tree)
    got = ckpt.load_pytree(str(tmp_path / "r"), tree)
    r_leaves = jax.tree_util.tree_leaves(tree)
    p_leaves, _ = ckpt._flatten(got)
    assert len(p_leaves) == len(r_leaves)
    assert all(_same(a, b) for a, b in zip(p_leaves, r_leaves))
    ckpt.save_pytree(str(tmp_path / "p"), 2, tree)
    back = ref.load_pytree(str(tmp_path / "p"), tree)
    assert all(_same(a, b) for a, b in zip(jax.tree_util.tree_leaves(back), r_leaves))
    # the same files, leaf by leaf
    for i in range(len(r_leaves)):
        name = f"step_{2:012d}/leaf_{i:05d}.npy"
        assert (tmp_path / "r" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()


def test_ordered_dicts_keep_insertion_order_as_jax_does():
    tree = OrderedDict([("z", np.zeros(1)), ("a", np.ones(1)), ("m", {"y": 2.0, "b": 3.0})])
    leaves, _ = ckpt._flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [np.asarray(x).tolist() for x in leaves] == [np.asarray(x).tolist() for x in want]


@pytest.fixture(scope="module")
def jax_params():
    params = RefTransformer(RefConfig(**SMALL)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_reference_transformer_params_load_into_the_port(tmp_path, jax_params):
    """JAX params saved by the reference load in the port (``like`` the
    numpy tree) and reach the port's model through ``params_from_jax``
    bit for bit."""
    ref.save_pytree(str(tmp_path), 5, jax.tree_util.tree_map(jnp.asarray, jax_params))
    like = jax.tree_util.tree_map(np.zeros_like, jax_params)
    loaded = ckpt.load_pytree(str(tmp_path), like)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    direct = params_from_jax(Transformer(cfg, device="cpu"), jax_params)
    via = params_from_jax(Transformer(cfg, device="cpu"), loaded)
    for (k, a), (k2, b) in zip(direct.state_dict().items(), via.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k


def test_port_state_dicts_round_trip_bf16_and_adamw(tmp_path):
    """A bf16 model's and its AdamW's state dicts come back bit for bit,
    into a fresh model and optimizer, with dtypes and Python scalars kept."""
    torch.manual_seed(0)
    cfg = TransformerConfig(**SMALL, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = Transformer(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 33)))
    from cekirdekler_tpu_torch.models.transformer import cross_entropy_loss

    for _ in range(2):
        opt.zero_grad()
        logits = model(tokens[:, :-1])
        cross_entropy_loss(logits, tokens[:, 1:]).backward()
        opt.step()
    tree = {"model": model.state_dict(), "opt": opt.state_dict()}
    ckpt.save_pytree(str(tmp_path), 2, tree)
    model2 = Transformer(cfg, device="cpu")
    opt2 = torch.optim.AdamW(model2.parameters(), lr=5e-2)
    # a fresh optimizer holds no moments until its first step, so its
    # state dict alone cannot shape the load
    with pytest.raises(ValueError, match="leaves, 'like' tree has"):
        ckpt.load_pytree(str(tmp_path), {"model": model2.state_dict(),
                                         "opt": opt2.state_dict()})
    for p in model2.parameters():
        p.grad = torch.zeros_like(p)
    opt2.step()
    opt2.zero_grad()
    like = {"model": model2.state_dict(), "opt": opt2.state_dict()}
    got = ckpt.load_pytree(str(tmp_path), like)
    mine, _ = ckpt._flatten(tree)
    back, _ = ckpt._flatten(got)
    assert len(mine) == len(back)
    for a, b in zip(mine, back):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    assert any(torch.is_tensor(a) and a.dtype == torch.bfloat16 for a in mine)
    model2.load_state_dict(got["model"])
    opt2.load_state_dict(got["opt"])
    assert opt2.param_groups[0]["lr"] == 1e-3
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, q)


def test_bf16_leaves_are_the_reference_s_words(tmp_path):
    """The port writes a bf16 leaf as the reference does ('<V2' words);
    the reference's own files load in the port as bf16, where the
    reference gives raw V2 back."""
    vals = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    ref.save_pytree(str(tmp_path / "r"), 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    ckpt.save_pytree(str(tmp_path / "p"), 1,
                     {"w": torch.from_numpy(vals).to(torch.bfloat16)})
    name = f"step_{1:012d}/leaf_00000.npy"
    assert (tmp_path / "r" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()
    assert np.load(tmp_path / "r" / name).dtype == np.dtype("V2")
    got = ckpt.load_pytree(str(tmp_path / "r"), {"w": torch.zeros(5, 7, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.from_numpy(vals).to(torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.load_pytree(str(tmp_path / "r"), {"w": torch.zeros(5, 7)}, step=1)


def test_like_places_leaves_on_its_device_and_scalar_types(tmp_path):
    ckpt.save_pytree(str(tmp_path), 1, {"a": np.arange(6, dtype=np.float64), "s": 3})
    got = ckpt.load_pytree(str(tmp_path), {"a": torch.zeros(6, dtype=torch.float64), "s": 0})
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float64))
    assert got["s"] == 3 and type(got["s"]) is int
    got = ckpt.load_pytree(str(tmp_path), {"a": np.zeros(6), "s": 0})
    assert isinstance(got["a"], np.ndarray) and _same(got["a"], np.arange(6, dtype=np.float64))


@pytest.mark.parametrize("saved, like", [
    (np.arange(6, dtype=np.float64), torch.float32),
    (np.arange(6, dtype=np.float32), torch.bfloat16),
    (np.arange(6, dtype=np.float32), torch.int32),
    (torch.arange(6, dtype=torch.bfloat16), torch.float32),
])
def test_a_leaf_dtype_other_than_like_s_raises_and_never_falls_back(tmp_path, saved, like):
    """A resume casts nothing: a tensor leaf whose file holds another
    dtype than ``like``'s raises, and an older step is not tried."""
    root = str(tmp_path)
    ckpt.save_pytree(root, 1, {"a": torch.zeros(6, dtype=like)})
    ckpt.save_pytree(root, 2, {"a": saved})
    FLIGHT.clear()
    with pytest.raises(ValueError, match="leaf cannot load into"):
        ckpt.load_pytree(root, {"a": torch.zeros(6, dtype=like)})
    assert not [e for e in FLIGHT.snapshot() if e.kind == "checkpoint-fallback"]


def _corrupt(root, step: int, name: str) -> None:
    d = os.path.join(root, f"step_{step:012d}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "wb") as f:
        f.write(b"this is not a valid file")


@pytest.mark.parametrize("surface", ["arrays", "pytree"])
def test_torn_newest_falls_back_with_a_flight_event(tmp_path, surface):
    root = str(tmp_path)
    tree = {"w": np.arange(4, dtype=np.float32)}
    for mod, r in ((ckpt, root + "/p"), (ref, root + "/r")):
        if surface == "arrays":
            mod.save_arrays(r, 1, tree)
        else:
            mod.save_pytree(r, 1, tree)
        _corrupt(r, 2, "arrays.npz" if surface == "arrays" else "manifest.json")
    FLIGHT.clear()
    for r in (root + "/p", root + "/r"):
        got = (ckpt.load_arrays(r) if surface == "arrays" else ckpt.load_pytree(r, tree))
        assert _same(got["w"], tree["w"])
    events = [e for e in FLIGHT.snapshot() if e.kind == "checkpoint-fallback"]
    assert [(e.fields["bad_step"], e.fields["fell_back_to"]) for e in events] == [(2, 1), (2, 1)]
    with pytest.raises(Exception):
        if surface == "arrays":
            ckpt.load_arrays(root + "/p", step=2)
        else:
            ckpt.load_pytree(root + "/p", tree, step=2)


def test_a_leaf_count_mismatch_raises_and_never_falls_back(tmp_path):
    root = str(tmp_path)
    ref.save_pytree(root, 1, {"w": np.zeros(2)})
    ref.save_pytree(root, 2, {"w": np.zeros(2), "b": np.ones(1)})
    FLIGHT.clear()
    with pytest.raises(ValueError, match="2 leaves, 'like' tree has 1"):
        ckpt.load_pytree(root, {"w": torch.zeros(2)})
    assert not [e for e in FLIGHT.snapshot() if e.kind == "checkpoint-fallback"]


def test_stale_tmp_dirs_are_swept_and_live_ones_kept(tmp_path):
    root = str(tmp_path)
    os.makedirs(root + "/.ckpt_tmp_old")
    os.makedirs(root + "/.ckpt_tmp_live")
    old = time.time() - ckpt.TMP_SWEEP_AGE_S - 5
    os.utime(root + "/.ckpt_tmp_old", (old, old))
    FLIGHT.clear()
    ckpt.save_arrays(root, 1, {"x": np.zeros(1)})
    names = sorted(os.listdir(root))
    assert names == [".ckpt_tmp_live", f"step_{1:012d}"]
    assert [e.fields["swept"] for e in FLIGHT.snapshot() if e.kind == "checkpoint-sweep"] == [1]
    assert ckpt.TMP_SWEEP_AGE_S == ref.TMP_SWEEP_AGE_S


def test_a_failed_write_leaves_no_step(tmp_path):
    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        ckpt.save_pytree(str(tmp_path), 1, {"x": Boom()})
    assert ckpt.latest_step(str(tmp_path)) is None
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".ckpt_tmp_")]
