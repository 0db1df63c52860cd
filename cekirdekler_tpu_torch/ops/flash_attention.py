"""Flash-attention forward: the hand-written CUDA kernel, its plain PyTorch
version, and the reference's block policies.

Counterpart of the forward half of ``cekirdekler_tpu/ops/flash_attention.py``:
``_flash_forward`` (the Pallas kernel ``_fa_kernel`` with ``parts=False``)
and a forward-only ``flash_attention``.  The kernel
(``csrc/flash_attention.cu``) takes its own tile sizes; ``block_q`` and
``block_k`` keep the reference's contract (:func:`_blocks_for` degrades them
by gcd and raises on degenerate tiles) and size the plain version's key
blocks, so on the CPU the plain version runs the reference's own blocking.

Numerics kept from the reference:

- the causal mask is the finite ``_NEG = -1e30``, the final divide uses
  ``max(l, 1e-30)``, and ``lse = m + log(max(l, 1e-30))`` comes out as a
  ``[B*H, Tq, 1]`` f32 column;
- ``precision="default"`` casts f32 q/k/v to bf16 once (:func:`_stream_cast`),
  sums scores in f32, keeps ``p`` in f32 for the denominator and rounds to
  bf16 only the copy of ``p`` that multiplies V; ``"highest"`` is true f32;
- the output has q's dtype before the cast.

The backward (``_flash_backward``), the ring forms (``flash_attention_parts``,
``flash_attention_bwd_parts``) and the BlockTuner are not ported yet
(ROADMAP Queue B 5-7, Queue A).  A default-argument call takes
:func:`default_blocks`, which is the pair the reference's tuner gives cold,
and both gate on the same >= 128 divisor, so flash against dense is decided
as in the reference.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..errors import KernelCompileError, NotPortedError
from ..kernel.build import LaunchCounter, build_library
from ..parallel.attention import attention_reference

__all__ = ["flash_attention", "flash_attention_plain", "auto_block", "default_blocks",
           "LAUNCHES", "PLAIN_RUNS", "ROUTES", "SOURCE", "KERNEL_BLOCK", "MAX_HEAD_DIM"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"

_NEG = -1e30  # finite "-inf": exp(_NEG - m) == 0 without nan hazards

# Smallest tile the reference lets a default-argument call run flash with;
# below it the call falls back to dense attention.
_DENSE_FLOOR = 128

#: query rows and keys of one tile of the CUDA kernel
KERNEL_BLOCK = 64
#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 128

#: kernel launches (the wrapper adds one per launch on the card)
LAUNCHES = LaunchCounter()
#: runs of the plain version, keyed by device type
PLAIN_RUNS = LaunchCounter()
#: :func:`flash_attention` calls, keyed "tiled" or "dense" (the fallback)
ROUTES = LaunchCounter()

_lib_fn = None


def auto_block(T: int, target: int = 512, floor: int = 8) -> int | None:
    """Largest power-of-two block <= ``target`` dividing ``T``, or None when
    only tiles below ``floor`` divide it."""
    blk = math.gcd(T, target)
    return blk if blk >= floor else None


def default_blocks(Tq: int, Tk: int | None = None,
                   target: int = 512) -> tuple[int, int] | None:
    """Blocks for default-argument calls: the 512 target degraded by gcd,
    or None ("run dense attention") when only sub-128 tiles divide a
    sequence length (T=96 -> 32, T=4104 -> 8)."""
    Tk = Tq if Tk is None else Tk
    bq = math.gcd(Tq, target)
    bk = math.gcd(Tk, target)
    if min(bq, bk) < _DENSE_FLOOR:
        return None
    return bq, bk


def _blocks_for(Tq: int, Tk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """Effective (bq, bk) for explicitly requested blocks: the gcd with the
    sequence lengths, raising when that is below a quarter of the smaller
    request (floor 8, cap 32)."""
    bq = math.gcd(Tq, block_q)
    bk = math.gcd(Tk, block_k)
    floor = min(32, max(8, min(block_q, block_k) // 4))
    if bq < floor or bk < floor:
        raise ValueError(
            f"sequence lengths (Tq={Tq}, Tk={Tk}) admit only degenerate "
            f"tiles ({bq}, {bk}) for requested blocks ({block_q}, "
            f"{block_k}); use auto_block()/default args (dense fallback) "
            f"or pad the sequence"
        )
    return bq, bk


def _precision_str(precision) -> str:
    """``"highest"`` or ``"default"``; anything else raises."""
    if precision in ("highest", "default"):
        return precision
    raise ValueError(
        f"flash_attention precision must be 'highest' or 'default', got {precision!r}"
    )


def _stream_cast(precision: str, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Under ``"default"``, f32 operands are cast to bf16 once; sub-f32
    inputs and ``"highest"`` pass through untouched."""
    if precision == "default":
        return tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                     for t in tensors)
    return tensors


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                          block_k: int, precision: str, out_dtype: torch.dtype
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference kernel's running softmax over key
    blocks of ``block_k`` (the last one may be shorter), on q's device.

    ``q``/``k``/``v`` are already stream-cast.  Returns ``(out, lse)``:
    out [B, Tq, H, D] in ``out_dtype`` and lse
    [B*H, Tq, 1] f32.  A key block wholly masked for a row leaves that
    row's state unchanged (``p = 0``, ``alpha = 1``), which is the
    reference's skip of dead blocks."""
    PLAIN_RUNS.add(q.device.type)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    q3 = q.permute(0, 2, 1, 3).float()  # [B, H, Tq, D]
    k3 = k.permute(0, 2, 1, 3).float()
    v3 = v.permute(0, 2, 1, 3).float()
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Tq, device=q.device)
    for n0 in range(0, Tk, block_k):
        kb = k3[:, :, n0:n0 + block_k]
        vb = v3[:, :, n0:n0 + block_k]
        s = (q3 @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(n0, n0 + kb.shape[2], device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p2 = p.to(torch.bfloat16).float() if precision == "default" else p
        alpha = torch.exp(m - m_new)
        acc = acc * alpha[..., None] + p2 @ vb
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    lc = torch.clamp_min(l, 1e-30)
    out = (acc / lc[..., None]).permute(0, 2, 1, 3).to(out_dtype)
    lse = (m + torch.log(lc)).reshape(B * H, Tq, 1)
    return out, lse


def _launcher():
    global _lib_fn
    if _lib_fn is None:
        lib = build_library(SOURCE.read_text(), "flash_attention")
        fn = lib.flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _lib_fn = fn
    return _lib_fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, precision: str,
            out_dtype: torch.dtype, with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch ``csrc/flash_attention.cu`` on q's device and current stream."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kinds = (torch.float32, torch.bfloat16)
    if q.dtype not in kinds or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelCompileError(
            f"flash_attention kernel: q/k/v must share one of {kinds}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if out_dtype not in kinds:
        raise KernelCompileError(f"flash_attention kernel: unsupported output {out_dtype}")
    if D > MAX_HEAD_DIM:
        raise KernelCompileError(
            f"flash_attention kernel: head dim {D} exceeds {MAX_HEAD_DIM}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.shape != (B, Tk, H, D):
            raise KernelCompileError(
                f"flash_attention kernel: {name} {tuple(t.shape)} on {t.device} does not "
                f"match q {tuple(q.shape)} on {q.device}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise KernelCompileError("flash_attention kernel: the head dim must have stride 1")
    out = torch.empty((B, Tq, H, D), dtype=out_dtype, device=q.device)
    lse = (torch.empty((B * H, Tq, 1), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _launcher()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D),
                int(causal), int(q.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), int(precision == "default"),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise KernelCompileError(f"flash_attention: CUDA launch failed with error {rc}")
    LAUNCHES.add()
    return out, lse


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   block_q: int, block_k: int, precision: str, with_lse: bool = False):
    """Forward pass, q [B, Tq, H, D] and k/v [B, Tk, H, D] -> [B, Tq, H, D]
    in q's dtype.  ``with_lse=True`` returns ``(out, lse, (q, k, v))``: the
    [B*H, Tq, 1] f32 logsumexp and the stream-cast operands, as the
    reference does.  On a CUDA tensor this launches the kernel or raises;
    on a CPU tensor it runs the plain version."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _, bk = _blocks_for(Tq, Tk, block_q, block_k)
    if causal and Tq != Tk:
        raise ValueError("causal flash attention requires Tq == Tk")
    precision = _precision_str(precision)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotPortedError(
            "flash_attention has no backward in the port yet: the flash backward and "
            "the train step are the training slice (ROADMAP Queue B 5); call it under "
            "torch.no_grad()")
    out_dtype = q.dtype
    q, k, v = _stream_cast(precision, q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal, bk, precision, out_dtype)
    elif q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, precision, out_dtype, with_lse)
    else:
        raise KernelCompileError(f"flash_attention: unsupported device {q.device}")
    if with_lse:
        return out, lse, (q, k, v)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    block_q: int | None = None, block_k: int | None = None,
                    precision: str = "highest") -> torch.Tensor:
    """Tiled flash attention, forward only: q [B, Tq, H, D], k/v
    [B, Tk, H, D] -> [B, Tq, H, D].  Default-argument blocks come from
    :func:`default_blocks`; where it gives None the call runs
    :func:`attention_reference` at the same precision (counted ``dense``
    in :data:`ROUTES`).  Explicit blocks keep :func:`_blocks_for`'s
    contract.  The reference's ``interpret`` argument has no counterpart:
    a CUDA tensor runs the kernel, a CPU tensor the plain version."""
    precision = _precision_str(precision)
    if block_q is None and block_k is None:
        blocks = default_blocks(q.shape[1], k.shape[1])
        if blocks is None:
            ROUTES.add("dense")
            return attention_reference(q, k, v, causal=causal, precision=precision)
        block_q, block_k = blocks
    elif block_q is None or block_k is None:
        block_q = block_q or block_k
        block_k = block_k or block_q
    ROUTES.add("tiled")
    return _flash_forward(q, k, v, causal, block_q, block_k, precision)
