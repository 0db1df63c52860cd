"""The flagship decoder-only transformer: forward pass and train step.

Counterpart of ``cekirdekler_tpu/models/transformer.py`` on one device with
no mesh: ``Transformer.forward(tokens)`` is the reference's
``Transformer.apply(params, tokens, mesh=None)``, ``loss_fn`` its
``loss_fn`` and ``make_train_step`` its ``make_train_step``, with
:func:`adamw` as the counterpart of ``optax.adamw``.  Parameters keep the
reference's names and ``[in, out]`` layouts (``embed``, ``final_norm``,
``blocks.{i}.{ln1, wqkv, wo, ln2, w1, w2}``), stay in ``param_dtype`` and are
cast to the activation dtype at each use; the projections are plain
products, so ``params_from_jax`` loads the reference's arrays as they are.

With ``attention="flash"`` each block calls ``ops.flash_attention`` with
default blocks: it runs the CUDA kernel on the card when
``default_blocks(T)`` gives a tiling of T, and the dense
``attention_reference`` otherwise (``flash_attention.ROUTES`` counts
which), the decision the reference's model makes with the same policy.
Precision follows the activation dtype: ``"default"`` below 32 bits,
``"highest"`` at f32; the gradients of the tiled route come from the
flash backward kernels.  ``remat=True`` recomputes each block's
activations in the backward (``torch.utils.checkpoint``, the counterpart
of ``jax.checkpoint``).  f32 products assume TF32 off on the card,
PyTorch's default.

Not covered yet, each refused with :class:`NotPortedError`: experts
(``n_experts > 0``), pipeline stages (``pp_stages > 1``), ring and Ulysses
attention, and a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..errors import DeviceSelectionError, NotPortedError
from ..ops.flash_attention import flash_attention
from ..parallel.attention import attention_reference

__all__ = ["TransformerConfig", "Transformer", "cross_entropy_loss", "params_from_jax", "adamw"]

_BLOCK_PARAMS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    attention: str = "dense"                   # "dense" | "flash" | "ring" | "ulysses"
    # flash precision; None follows dtype (sub-f32 -> "default", f32 -> "highest")
    attention_precision: str | None = None
    # recompute each block's activations in the backward (no effect without grad)
    remat: bool = False
    sp_axis: str = "sp"
    n_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 0.0
    pp_stages: int = 1
    n_microbatches: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotPortedError(
            "a mesh: sharded execution is not ported yet (ROADMAP Queue A, attention "
            "stack: parallel/ on torch.distributed)")


def _check_supported(c: TransformerConfig) -> None:
    if c.n_experts > 0:
        raise NotPortedError(
            "n_experts > 0: the MoE layer (models/moe) is not ported yet "
            "(ROADMAP Queue A, attention stack: models)")
    if c.pp_stages > 1:
        raise NotPortedError(
            "pp_stages > 1: pipeline parallelism is not ported yet (ROADMAP Queue A, "
            "attention stack: parallel/pipeline_parallel, needs more than one card)")
    if c.attention in ("ring", "ulysses"):
        raise NotPortedError(
            f"attention={c.attention!r}: ring and Ulysses attention are not ported yet "
            "(ROADMAP Queue B 6-7, need more than one card)")
    if c.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention {c.attention!r}")


class Block(nn.Module):
    """One pre-norm block's parameters, in the reference's layouts."""

    def __init__(self, c: TransformerConfig, gen: torch.Generator):
        super().__init__()
        d, h, f = c.d_model, c.n_heads * c.head_dim, c.d_ff
        self.ln1 = nn.Parameter(torch.ones(d, dtype=c.param_dtype))
        self.wqkv = nn.Parameter(_init(gen, (d, 3 * h), d ** -0.5, c.param_dtype))
        self.wo = nn.Parameter(_init(gen, (h, d), h ** -0.5, c.param_dtype))
        self.ln2 = nn.Parameter(torch.ones(d, dtype=c.param_dtype))
        self.w1 = nn.Parameter(_init(gen, (d, f), d ** -0.5, c.param_dtype))
        self.w2 = nn.Parameter(_init(gen, (f, d), f ** -0.5, c.param_dtype))


def _init(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


class Transformer(nn.Module):
    """Decoder-only transformer.  Weights are random normal
    draws from a CPU ``torch.Generator`` seeded with ``seed`` (the
    reference's scales, not its values: JAX's generator gives other
    numbers), then moved to ``device``, ``cuda:0`` by default."""

    def __init__(self, config: TransformerConfig = TransformerConfig(),
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        _check_supported(config)
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise DeviceSelectionError(
                f"Transformer on {dev}: no CUDA device; pass device='cpu' for the "
                "plain versions on the host")
        self.config = config
        c = config
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.embed = nn.Parameter(_init(gen, (c.vocab, c.d_model), 0.02, c.param_dtype))
        self.final_norm = nn.Parameter(torch.ones(c.d_model, dtype=c.param_dtype))
        self.blocks = nn.ModuleList(Block(c, gen) for _ in range(c.n_layers))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        c = self.config
        if c.attention == "flash":
            prec = c.attention_precision or ("default" if c.dtype.itemsize < 4 else "highest")
            return flash_attention(q, k, v, True, precision=prec)
        return attention_reference(q, k, v, causal=True)

    def _block(self, p: Block, x: torch.Tensor) -> torch.Tensor:
        """Pre-norm block: x + Attn(LN(x)); x + FFN(LN(x))."""
        c = self.config
        B, T, _ = x.shape
        h = _rms_norm(x, p.ln1)
        qkv = h @ p.wqkv.to(c.dtype)
        q, k, v = qkv.chunk(3, dim=-1)  # q | k | v over the last axis, views
        shp = (B, T, c.n_heads, c.head_dim)
        o = self._attention(q.reshape(shp), k.reshape(shp), v.reshape(shp))
        o = o.reshape(B, T, -1) @ p.wo.to(c.dtype)
        x = x + o
        h = _rms_norm(x, p.ln2)
        h = F.gelu(h @ p.w1.to(c.dtype), approximate="tanh")  # jax.nn.gelu's default
        h = h @ p.w2.to(c.dtype)
        return x + h

    def forward(self, tokens, mesh=None) -> torch.Tensor:
        """tokens [B, T] int -> logits [B, T, vocab] f32, differentiable with
        respect to the parameters; serving calls it under
        ``torch.inference_mode()``."""
        _refuse_mesh(mesh)
        c = self.config
        tokens = torch.as_tensor(tokens, device=self.device)
        # embed.astype(dtype)[tokens]: the cast commutes with the gather
        x = self.embed[tokens].to(c.dtype)
        remat = c.remat and torch.is_grad_enabled()
        for p in self.blocks:
            if remat:
                x = checkpoint(self._block, p, x, use_reentrant=False)
            else:
                x = self._block(p, x)
        x = _rms_norm(x, self.final_norm)
        return x.float() @ self.embed.float().T

    def loss_fn(self, batch: dict, mesh=None) -> torch.Tensor:
        """Next-token cross entropy; batch = {"tokens": [B, T+1]}."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        logits = self.forward(tokens[:, :-1], mesh)
        return cross_entropy_loss(logits, tokens[:, 1:])

    def make_train_step(self, optimizer: torch.optim.Optimizer, mesh=None):
        """The train step: loss, gradients, optimizer update.

        Returns ``step(batch) -> loss`` (a 0-d f32 tensor on the model's
        device), which runs ``loss_fn`` -> ``backward`` -> ``optimizer.step()``
        -> ``optimizer.zero_grad()``.  The parameters and the optimizer's
        state are updated in place, the PyTorch idiom; the reference's step
        is pure and returns ``(params, opt_state, loss)`` instead."""
        _refuse_mesh(mesh)

        def step(batch: dict) -> torch.Tensor:
            loss = self.loss_fn(batch)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return loss.detach()

        return step


def adamw(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over every parameter with ``optax.adamw``'s
    defaults: betas (0.9, 0.999), eps 1e-8 (added outside the square root)
    and decoupled weight decay 1e-4 on every parameter.  PyTorch's own
    default weight decay is 1e-2."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _rms_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * gain.float()).to(dt)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (f32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def params_from_jax(model: Transformer, tree: dict) -> Transformer:
    """Load the reference's params pytree, given as numpy arrays
    (``{"embed", "final_norm", "blocks": [{"ln1", "wqkv", "wo", "ln2", "w1",
    "w2"}]}``), into ``model`` as they are: both keep ``[in, out]`` layouts,
    so nothing is transposed, and ``wqkv`` ``[d, 3h]`` splits as q | k | v
    over its last axis in both.  Raises on a missing, extra or misshapen
    array."""
    arrays = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if len(tree["blocks"]) != len(model.blocks):
        raise ValueError(f"{len(tree['blocks'])} blocks for a model of {len(model.blocks)}")
    for i, blk in enumerate(tree["blocks"]):
        extra = set(blk) - set(_BLOCK_PARAMS)
        if extra:
            raise NotPortedError(f"block {i} holds {sorted(extra)}: MoE blocks are not "
                                 "ported yet (ROADMAP Queue A, attention stack: models)")
        for name in _BLOCK_PARAMS:
            arrays[f"blocks.{i}.{name}"] = blk[name]
    dt = model.config.param_dtype
    model.load_state_dict({k: torch.from_numpy(np.array(a)).to(dt) for k, a in arrays.items()},
                          strict=True)
    return model
