"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the reference's block policies.

Counterpart of ``cekirdekler_tpu/ops/flash_attention.py``:
``_flash_forward`` (the Pallas kernel ``_fa_kernel`` with ``parts=False``),
``_flash_backward`` (``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel``), the
``_flash_attention_tiled`` custom_vjp (here :class:`_FlashAttention`, a
``torch.autograd.Function``), ``flash_attention``, and the ring-attention
forms ``flash_attention_parts`` and ``flash_attention_bwd_parts`` (the
same kernels with ``parts=True``).  The single-card forward and every
backward take the route :func:`_route` names from the operands' dtype
after the stream cast and the precision: bf16 at ``"default"`` runs the
tensor-core kernels (``csrc/flash_attention_tc.cu`` forward,
``csrc/flash_attention_bwd_tc.cu`` backward), every other case the FP32
ones (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).  The
ring's parts kernels take the route :func:`_parts_route` names per kernel:
for bf16 at the ring's ``"highest"`` the forward and dk/dv run the
tensor-core kernels of ``csrc/flash_attention_parts_tc.cu``, whose f32
operand (p, pT, dsT) enters the products as three bf16 terms (``"tc3"``),
and dq the FP32 kernel.  The kernels
take their own tile sizes; ``block_q`` and ``block_k`` keep the
reference's contract
(:func:`_blocks_for` degrades them by gcd and raises on degenerate tiles;
the parts forms take ``min(block, T)`` and raise where it does not divide
T) and size the plain versions' blocks, so on the CPU the plain versions
run the reference's own blocking.

Numerics kept from the reference:

- the causal mask is the finite ``_NEG = -1e30``, the final divide uses
  ``max(l, 1e-30)``, and ``lse = m + log(max(l, 1e-30))`` comes out as a
  ``[B*H, Tq, 1]`` f32 column;
- ``precision="default"`` casts f32 q/k/v (and dO) to bf16 once
  (:func:`_stream_cast`), sums every product in f32, keeps ``p`` in f32 for
  the denominator and rounds to bf16 only the copies that enter a second
  product: ``p`` before ``p.v`` and ``pT.dO``, ``ds`` before ``ds.k`` and
  ``dsT.q``; ``"highest"`` is true f32;
- the backward's ``delta = rowsum(dO * O)`` is taken in f32 from dO and
  the stored output before the stream cast;
- the output has q's dtype before the cast, and the gradients the
  dtypes of their primals.

The parts forms take the global positions of the first query and key
(``q_pos0``, ``k_pos0``) for the causal mask, return f32 whatever the input
type, and do not stream-cast.  Where the reference leaves a tiling-dependent
state in a row that sees no key of a live block (running max ``_NEG``,
``p = exp(0) = 1`` for every masked key), the port keeps the empty state
(max ``_NEG``, denominator 0, accumulator 0); every row that sees a key
gets the reference's values, and the ring weights such a row out either
way (ROADMAP Queue C, reference state 9).

The BlockTuner is not ported (ROADMAP Queue A).  A default-argument call
takes :func:`default_blocks`, which is the pair the reference's tuner
gives cold, and both gate on the same >= 128 divisor, so flash against
dense is decided as in the reference.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..errors import KernelCompileError
from ..kernel.build import LaunchCounter, build_library
from ..parallel.attention import attention_reference

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd_plain",
           "flash_attention_parts", "flash_attention_parts_plain",
           "flash_attention_bwd_parts", "flash_attention_bwd_parts_plain",
           "auto_block", "default_blocks", "LAUNCHES", "BWD_LAUNCHES", "PARTS_LAUNCHES",
           "PARTS_DEAD", "PARTS_FWD_ROUTES", "PLAIN_RUNS", "PLAIN_BWD_RUNS", "ROUTES",
           "BWD_ROUTES", "SOURCE", "SOURCE_TC", "SOURCE_BWD", "SOURCE_BWD_TC",
           "SOURCE_PARTS_TC", "KERNEL_BLOCK", "MAX_HEAD_DIM"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
SOURCE_TC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_tc.cu"
SOURCE_BWD = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd.cu"
SOURCE_BWD_TC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd_tc.cu"
SOURCE_PARTS_TC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_parts_tc.cu"

_NEG = -1e30  # finite "-inf": exp(_NEG - m) == 0 without nan hazards

# Smallest tile the reference lets a default-argument call run flash with;
# below it the call falls back to dense attention.
_DENSE_FLOOR = 128

#: query rows and keys of one tile of the CUDA kernel
KERNEL_BLOCK = 64
#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 128

#: forward kernel launches (the wrapper adds one per launch on the card),
#: keyed by :func:`_route`
LAUNCHES = LaunchCounter()
#: backward kernel launches, keyed "dq" and "dkv"
BWD_LAUNCHES = LaunchCounter()
#: parts kernel launches, keyed "fwd", "dq" and "dkv"
PARTS_LAUNCHES = LaunchCounter()
#: of those, the launches whose block is wholly masked (same keys)
PARTS_DEAD = LaunchCounter()
#: runs of the plain forward and forward parts, keyed by device type
PLAIN_RUNS = LaunchCounter()
#: runs of the plain backward and backward parts, keyed by device type
PLAIN_BWD_RUNS = LaunchCounter()
#: :func:`flash_attention` calls, keyed "tiled" or "dense" (the fallback)
ROUTES = LaunchCounter()
#: backward kernel launches (single-card and parts), keyed by the route each
#: kernel took (:func:`_route`, or :func:`_parts_route` for the parts)
BWD_ROUTES = LaunchCounter()
#: parts forward launches, keyed by :func:`_parts_route`
PARTS_FWD_ROUTES = LaunchCounter()

_fwd_fns = None
_fwd_tc_fn = None
_bwd_fns = None
_bwd_tc_fns = None
_parts_tc_fns = None


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


def _softmax_state_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos0: int,
                         k_pos0: int, causal: bool, block_k: int, round_p: bool
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference kernel's running softmax of q against k/v over key
    blocks of ``block_k`` (the last one may be shorter), on q's device,
    with key ``j`` visible to query ``i`` where ``k_pos0 + j <= q_pos0 + i``.
    Returns the f32 ``(acc [B, H, Tq, D], m [B, H, Tq], l [B, H, Tq])``.

    A key block wholly masked for a row leaves that row's state unchanged
    (``p = 0``, ``alpha = 1``), which is the reference's skip of dead
    blocks; a row that has seen no key keeps the empty state (``p = 0``
    while its max is ``_NEG``).  ``round_p`` rounds the copy of p that
    multiplies V to bf16."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    q3 = q.permute(0, 2, 1, 3).float()  # [B, H, Tq, D]
    k3 = k.permute(0, 2, 1, 3).float()
    v3 = v.permute(0, 2, 1, 3).float()
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    qpos = q_pos0 + torch.arange(Tq, device=q.device)
    for n0 in range(0, Tk, block_k):
        kb = k3[:, :, n0:n0 + block_k]
        vb = v3[:, :, n0:n0 + block_k]
        s = (q3 @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = k_pos0 + torch.arange(n0, n0 + kb.shape[2], device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new == _NEG)[..., None], 0.0, p)
        p2 = p.to(torch.bfloat16).float() if round_p else p
        alpha = torch.exp(m - m_new)
        acc = acc * alpha[..., None] + p2 @ vb
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    return acc, m, l


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                          block_k: int, precision: str, out_dtype: torch.dtype
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference kernel's running softmax over key
    blocks of ``block_k`` (the last one may be shorter), on q's device.

    ``q``/``k``/``v`` are already stream-cast.  Returns ``(out, lse)``:
    out [B, Tq, H, D] in ``out_dtype`` and lse [B*H, Tq, 1] f32."""
    PLAIN_RUNS.add(q.device.type)
    B, Tq, H, D = q.shape
    acc, m, l = _softmax_state_plain(q, k, v, 0, 0, causal, block_k, precision == "default")
    lc = torch.clamp_min(l, 1e-30)
    out = (acc / lc[..., None]).permute(0, 2, 1, 3).to(out_dtype)
    lse = (m + torch.log(lc)).reshape(B * H, Tq, 1)
    return out, lse


def _fwd_launchers():
    global _fwd_fns
    if _fwd_fns is None:
        lib = build_library(SOURCE.read_text(), "flash_attention")
        fn, parts_fn = lib.flash_attention_fwd, lib.flash_attention_fwd_parts
        fn.restype = parts_fn.restype = ctypes.c_int
        head = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_float]
        fn.argtypes = [ctypes.c_void_p] * 5 + head + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        parts_fn.argtypes = [ctypes.c_void_p] * 6 + head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _fwd_fns = (fn, parts_fn)
    return _fwd_fns


def _fwd_tc_launcher():
    global _fwd_tc_fn
    if _fwd_tc_fn is None:
        fn = build_library(SOURCE_TC.read_text(), "flash_attention_tc").flash_attention_fwd_tc
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _fwd_tc_fn = fn
    return _fwd_tc_fn


def _check_fwd_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise :class:`KernelCompileError` on q/k/v the forward kernel does not take."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kinds = (torch.float32, torch.bfloat16)
    if q.dtype not in kinds or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelCompileError(
            f"flash_attention kernel: q/k/v must share one of {kinds}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, precision: str,
            out_dtype: torch.dtype, with_lse: bool, route: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the forward kernel on q's device and current stream:
    ``csrc/flash_attention_tc.cu`` or ``csrc/flash_attention.cu`` as
    :func:`_route` says (``route`` overrides it, for timing the FP32 kernel
    on bf16 operands), counted in :data:`LAUNCHES` under the route."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_fwd_operands(q, k, v)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise KernelCompileError(f"flash_attention kernel: unsupported output {out_dtype}")
    route = route or _route(q.dtype, precision)
    if route == "tc":
        if q.dtype != torch.bfloat16:
            raise KernelCompileError(
                f"flash_attention tc kernel: q/k/v must be bf16, got {q.dtype}")
        fn = _fwd_tc_launcher()
        # p' always rounds there; the last flag picks 16-byte copies
        flags = (int(causal), int(out_dtype == torch.bfloat16),
                 int(_vector_loads((q, k, v), D)))
    else:
        fn, _ = _fwd_launchers()
        flags = (int(causal), int(q.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                 int(precision == "default"))
    out = torch.empty((B, Tq, H, D), dtype=out_dtype, device=q.device)
    lse = (torch.empty((B * H, Tq, 1), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D),
                *flags, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise KernelCompileError(f"flash_attention: CUDA launch failed with error {rc}")
    LAUNCHES.add(route)
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


def _parts_blocks(Tq: int, Tk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The parts forms' blocks: ``min(block, T)``, which must divide T."""
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if Tq % bq or Tk % bk:
        raise ValueError(
            f"sequence lengths (Tq={Tq}, Tk={Tk}) must be multiples of the "
            f"blocks (bq={bq}, bk={bk})")
    return bq, bk


def _dead(Tq: int, q_pos0: int, k_pos0: int, causal: bool) -> bool:
    """Whether no query of the block sees any key: the ring's dead step."""
    return causal and k_pos0 > q_pos0 + Tq - 1


def flash_attention_parts_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                q_pos0: int, k_pos0: int, causal: bool, block_k: int,
                                precision: str
                                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain parts forward on q's device: ``(acc [B, Tq, H, D], m
    [B, Tq, H], l [B, Tq, H])``, all f32, over key blocks of ``block_k``.
    Under ``"default"`` p rounds to bf16 before p.V where v is bf16, as the
    reference casts p to v's type; nothing is stream-cast."""
    PLAIN_RUNS.add(q.device.type)
    round_p = precision == "default" and v.dtype == torch.bfloat16
    acc, m, l = _softmax_state_plain(q, k, v, q_pos0, k_pos0, causal, block_k, round_p)
    return acc.permute(0, 2, 1, 3), m.permute(0, 2, 1), l.permute(0, 2, 1)


def _launch_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos0: int,
                  k_pos0: int, causal: bool, precision: str, route: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the parts forward on q's device and current stream: the
    kernel of ``csrc/flash_attention_parts_tc.cu`` or the FP32 one of
    ``csrc/flash_attention.cu``, as :func:`_parts_route` says (``route``
    overrides it, for timing the FP32 kernel on the same operands), counted
    in :data:`PARTS_FWD_ROUTES` under the route."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_fwd_operands(q, k, v)
    route = route or _parts_route("fwd", q.dtype, precision)
    is_bf16 = q.dtype == torch.bfloat16
    if route == "tc3":
        if not is_bf16:
            raise KernelCompileError(
                f"flash_attention_parts {route} kernel: q/k/v must be bf16, got {q.dtype}")
        fn, _ = _parts_tc_launchers()
        flags = (int(causal), int(_vector_loads((q, k, v), D)))
    elif route == "fp32":
        _, fn = _fwd_launchers()
        flags = (int(causal), int(is_bf16), int(precision == "default" and is_bf16))
    else:
        raise KernelCompileError(f"flash_attention_parts: no {route} kernel")
    acc = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m, l = (torch.empty((B, Tq, H), dtype=torch.float32, device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), B, H, Tq, Tk, D, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(D), *flags, int(q_pos0), int(k_pos0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise KernelCompileError(f"flash_attention_parts: CUDA launch failed with error {rc}")
    PARTS_LAUNCHES.add("fwd")
    PARTS_FWD_ROUTES.add(route)
    if _dead(Tq, q_pos0, k_pos0, causal):
        PARTS_DEAD.add("fwd")
    return acc, m, l


def flash_attention_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos0: int = 0,
                          k_pos0: int = 0, causal: bool = False, block_q: int = 128,
                          block_k: int = 128, precision: str = "highest"
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-attention inner forward: the UNNORMALIZED flash accumulation of
    q [B, Tq, H, D] against one K/V block [B, Tk, H, D], with key ``j``
    visible to query ``i`` under ``causal`` where
    ``k_pos0 + j <= q_pos0 + i``.  Returns ``(acc, m, l)``: acc f32
    [B, Tq, H, D], the running max and denominator f32 [B, Tq, H], which
    ring steps merge with the stable-softmax combine
    (``parallel/attention.py``).  Forward only, as the reference's.  On a
    CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the plain version."""
    _, bk = _parts_blocks(q.shape[1], k.shape[1], block_q, block_k)
    precision = _precision_str(precision)
    if q.device.type == "cpu":
        return flash_attention_parts_plain(q, k, v, q_pos0, k_pos0, causal, bk, precision)
    if q.device.type == "cuda":
        return _launch_parts(q, k, v, q_pos0, k_pos0, causal, precision)
    raise KernelCompileError(f"flash_attention_parts: unsupported device {q.device}")


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                              causal: bool, block_q: int, block_k: int, precision: str,
                              grad_dtypes: tuple[torch.dtype, torch.dtype, torch.dtype],
                              q_pos0: int = 0, k_pos0: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: the reference kernels' FlashAttention-2
    arithmetic over query blocks of ``block_q`` and key blocks of
    ``block_k`` (the last of each may be shorter), on q's device, with key
    ``j`` visible to query ``i`` under ``causal`` where
    ``k_pos0 + j <= q_pos0 + i`` (0 and 0 on one card).

    ``q``/``k``/``v``/``do`` are already stream-cast; ``lse`` and ``delta``
    hold one f32 per (b*h, query) row.  For every live (query block, key
    block) pair: ``p = exp(s - lse)``, ``dp = dO.V^T``,
    ``ds = p (dp - delta) scale``, then ``dq += ds.K``, ``dv += p^T.dO`` and
    ``dk += ds^T.q``, each block's product summed on its own and added to
    the f32 sum, dq over key blocks and dk/dv over query blocks in order.
    Under ``"default"`` ``p`` and ``ds`` round to bf16 before those three
    products.  Returns ``(dq, dk, dv)`` in ``grad_dtypes``."""
    PLAIN_BWD_RUNS.add(q.device.type)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    rnd = precision == "default"
    q3, k3, v3, do3 = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, do))
    lse3 = lse.reshape(B, H, Tq, 1).float()
    dlt3 = delta.reshape(B, H, Tq, 1).float()
    dq = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, H, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, H, Tk, D), dtype=torch.float32, device=q.device)
    for m0 in range(0, Tq, block_q):
        m1 = min(m0 + block_q, Tq)
        qb, dob = q3[:, :, m0:m1], do3[:, :, m0:m1]
        lb, db = lse3[:, :, m0:m1], dlt3[:, :, m0:m1]
        qpos = q_pos0 + torch.arange(m0, m1, device=q.device)
        for n0 in range(0, Tk, block_k):
            if causal and k_pos0 + n0 > q_pos0 + m1 - 1:
                break  # the reference's dead block: no key here is visible
            n1 = min(n0 + block_k, Tk)
            kb, vb = k3[:, :, n0:n1], v3[:, :, n0:n1]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                kpos = k_pos0 + torch.arange(n0, n1, device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
            p = torch.exp(s - lb)
            dp = dob @ vb.transpose(-1, -2)
            ds = p * (dp - db) * scale
            p2, ds2 = (_round_bf16(p), _round_bf16(ds)) if rnd else (p, ds)
            dq[:, :, m0:m1] += ds2 @ kb
            dv[:, :, n0:n1] += p2.transpose(-1, -2) @ dob
            dk[:, :, n0:n1] += ds2.transpose(-1, -2) @ qb
    return tuple(g.permute(0, 2, 1, 3).to(dt) for g, dt in zip((dq, dk, dv), grad_dtypes))


def _bwd_launchers():
    global _bwd_fns
    if _bwd_fns is None:
        lib = build_library(SOURCE_BWD.read_text(), "flash_attention_bwd")
        dq_fn, dkv_fn = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
        head = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_float]
        dq_fn.restype = dkv_fn.restype = ctypes.c_int
        dq_fn.argtypes = [ctypes.c_void_p] * 7 + head + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        dkv_fn.argtypes = [ctypes.c_void_p] * 8 + head + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        _bwd_fns = (dq_fn, dkv_fn)
    return _bwd_fns


def _bwd_tc_launchers():
    global _bwd_tc_fns
    if _bwd_tc_fns is None:
        lib = build_library(SOURCE_BWD_TC.read_text(), "flash_attention_bwd_tc")
        dq_fn, dkv_fn = lib.flash_attention_bwd_dq_tc, lib.flash_attention_bwd_dkv_tc
        head = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_float]
        dq_fn.restype = dkv_fn.restype = ctypes.c_int
        dq_fn.argtypes = [ctypes.c_void_p] * 7 + head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        dkv_fn.argtypes = [ctypes.c_void_p] * 8 + head + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        _bwd_tc_fns = (dq_fn, dkv_fn)
    return _bwd_tc_fns


def _route(dtype: torch.dtype, precision: str) -> str:
    """Which kernels take operands of ``dtype`` (as the kernels see them,
    after the stream cast) at ``precision``, forward and backward alike:
    ``"tc"``, the tensor-core kernels (``csrc/flash_attention_tc.cu``,
    ``csrc/flash_attention_bwd_tc.cu``), for bf16 at ``"default"``, where
    every operand of every product is bf16; else ``"fp32"``, the FP32
    kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)."""
    return "tc" if dtype == torch.bfloat16 and precision == "default" else "fp32"


def _parts_route(kind: str, dtype: torch.dtype, precision: str) -> str:
    """Which kernel takes the ring's parts kernel ``kind`` (``"fwd"``,
    ``"dq"`` or ``"dkv"``) for operands of ``dtype`` at ``precision`` (the
    backward's after :func:`_parts_bwd_precision`):

    - ``"tc3"``, ``csrc/flash_attention_parts_tc.cu``: the forward and dk/dv
      for bf16 at ``"highest"``, the ring's precision; q.k and dO.v are
      exact bf16 products, and p, pT and dsT enter their products as three
      bf16 terms, so the tensor cores keep f32 accuracy;
    - ``"tc"``, ``csrc/flash_attention_bwd_tc.cu``: dq and dk/dv for bf16
      at ``"default"``, where p and ds round to bf16 as the reference
      rounds them;
    - ``"fp32"``, the FP32 kernels: dq at ``"highest"``, the forward at
      ``"default"`` (its bf16 p' on the CUDA cores), and f32 operands
      everywhere (a split of f32 q and k would take six products)."""
    if kind not in ("fwd", "dq", "dkv"):
        raise ValueError(f"parts kernel kind must be 'fwd', 'dq' or 'dkv', got {kind!r}")
    precision = _precision_str(precision)
    if dtype != torch.bfloat16:
        return "fp32"
    if precision == "highest":
        return "fp32" if kind == "dq" else "tc3"
    return "fp32" if kind == "fwd" else "tc"


def _parts_tc_launchers():
    global _parts_tc_fns
    if _parts_tc_fns is None:
        lib = build_library(SOURCE_PARTS_TC.read_text(), "flash_attention_parts_tc")
        fwd_fn, dkv_fn = lib.flash_attention_fwd_parts_tc, lib.flash_attention_bwd_dkv_parts_tc
        fwd_fn.restype = dkv_fn.restype = ctypes.c_int
        fwd_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                           + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        dkv_fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                           + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _parts_tc_fns = (fwd_fn, dkv_fn)
    return _parts_tc_fns


def _vector_loads(tensors: tuple[torch.Tensor, ...], D: int) -> bool:
    """Whether the tensor-core kernels may copy rows of ``tensors`` 16 bytes
    at a time: D and every (batch, time, head) stride a multiple of 8
    elements and every pointer 16-byte aligned (bf16)."""
    return D % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]) for t in tensors)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                lse: torch.Tensor, delta: torch.Tensor, causal: bool, precision: str,
                grad_dtypes: tuple[torch.dtype, torch.dtype, torch.dtype],
                q_pos0: int = 0, k_pos0: int = 0, parts: bool = False,
                routes: tuple[str, str] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the two backward kernels on q's device and current stream: dq,
    then dk and dv, each on its own route: :func:`_route` for both on one
    card, :func:`_parts_route` per kernel for the ring's ``parts`` form
    (``routes``, a (dq, dk/dv) pair, overrides them, for timing the FP32
    kernels on the same operands).  ``parts`` counts the launches in
    :data:`PARTS_LAUNCHES` (the ring's form) instead of
    :data:`BWD_LAUNCHES`; every launch also counts in :data:`BWD_ROUTES`
    under its route."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kinds = (torch.float32, torch.bfloat16)
    if q.dtype not in kinds or any(t.dtype != q.dtype for t in (k, v, do)):
        raise KernelCompileError(
            f"flash_attention backward kernels: q/k/v/dO must share one of {kinds}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    if any(dt not in kinds for dt in grad_dtypes):
        raise KernelCompileError(
            f"flash_attention backward kernels: unsupported gradient dtypes {grad_dtypes}")
    if D > MAX_HEAD_DIM:
        raise KernelCompileError(
            f"flash_attention backward kernels: head dim {D} exceeds {MAX_HEAD_DIM}")
    for name, t, T in (("k", k, Tk), ("v", v, Tk), ("dO", do, Tq)):
        if t.device != q.device or t.shape != (B, T, H, D):
            raise KernelCompileError(
                f"flash_attention backward kernels: {name} {tuple(t.shape)} on {t.device} "
                f"does not match q {tuple(q.shape)} on {q.device}")
    if any(t.stride(3) != 1 for t in (q, k, v, do)):
        raise KernelCompileError(
            "flash_attention backward kernels: the head dim must have stride 1")
    lse = lse.reshape(B * H, Tq).contiguous()
    delta = delta.reshape(B * H, Tq).contiguous()
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 or \
            lse.device != q.device or delta.device != q.device:
        raise KernelCompileError(
            "flash_attention backward kernels: lse and delta must be f32 on q's device")
    if routes is None:
        routes = ((_parts_route("dq", q.dtype, precision), _parts_route("dkv", q.dtype, precision))
                  if parts else (_route(q.dtype, precision),) * 2)
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=dt, device=q.device)
                  for T, dt in zip((Tq, Tk, Tk), grad_dtypes))
    is_bf16 = [int(dt == torch.bfloat16) for dt in grad_dtypes]
    vec = int(_vector_loads((q, k, v, do), D))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    shape = (B, H, Tq, Tk, D)
    offs = (int(q_pos0), int(k_pos0))
    counter = PARTS_LAUNCHES if parts else BWD_LAUNCHES
    dead = parts and _dead(Tq, q_pos0, k_pos0, causal)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for kind, route, outs, out_bf16 in (("dq", routes[0], (dq,), is_bf16[:1]),
                                            ("dkv", routes[1], (dk, dv), is_bf16[1:])):
            which = int(kind == "dkv")
            if route == "tc" and q.dtype == torch.bfloat16:
                # p' and ds' always round there
                fn = _bwd_tc_launchers()[which]
                flags = (int(causal), *out_bf16, vec)
            elif route == "fp32":
                fn = _bwd_launchers()[which]
                flags = (int(causal), int(q.dtype == torch.bfloat16), *out_bf16,
                         int(precision == "default"))
            elif route == "tc3" and kind == "dkv" and q.dtype == torch.bfloat16 \
                    and not any(out_bf16):
                fn = _parts_tc_launchers()[1]
                flags = (int(causal), vec)
            else:
                raise KernelCompileError(
                    f"flash_attention_bwd_{kind}: no {route} kernel for {q.dtype} operands "
                    f"and {grad_dtypes} gradients")
            rc = fn(*ptrs, *(t.data_ptr() for t in outs), *shape, *strides, 1.0 / math.sqrt(D),
                    *flags, *offs, stream)
            if rc != 0:
                raise KernelCompileError(
                    f"flash_attention_bwd_{kind}: CUDA launch failed with error {rc}")
            counter.add(kind)
            BWD_ROUTES.add(route)
            if dead:
                PARTS_DEAD.add(kind)
    return dq, dk, dv


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32 as a ``[B*H, Tq]`` column, from the output
    and its cotangent as they are (before any stream cast)."""
    B, Tq, H, _ = out.shape
    return (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1).reshape(B * H, Tq)


def _flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, causal: bool, block_q: int,
                    block_k: int, precision: str,
                    grad_dtypes: tuple[torch.dtype, torch.dtype, torch.dtype] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward pass: ``(dq, dk, dv)`` from the forward's operands, output
    and ``[B*H, Tq, 1]`` logsumexp and the output's cotangent ``do``.

    ``delta = rowsum(dO * O)`` is taken in f32 before the stream cast, as
    the reference takes it outside its kernels.  Gradients come out in
    ``grad_dtypes`` (the primals' dtypes), by default ``do``'s.  On a CUDA
    tensor this launches the two kernels or raises; on a CPU tensor it runs
    the plain version."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bq, bk = _blocks_for(Tq, Tk, block_q, block_k)
    precision = _precision_str(precision)
    delta = _delta(out, do)
    grad_dtypes = grad_dtypes or (do.dtype,) * 3
    q, k, v, do = _stream_cast(precision, q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal, bq, bk, precision,
                                         grad_dtypes)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, do, lse, delta, causal, precision, grad_dtypes)
    raise KernelCompileError(f"flash_attention backward: unsupported device {q.device}")


def flash_attention_bwd_parts_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                                    q_pos0: int, k_pos0: int, causal: bool, block_q: int,
                                    block_k: int, precision: str
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward parts on q's device: ``lse`` and ``delta`` are
    [B, Tq, H] f32; the gradients come out f32."""
    return flash_attention_bwd_plain(q, k, v, do, _row_column(lse), _row_column(delta), causal,
                                     block_q, block_k, precision, (torch.float32,) * 3,
                                     q_pos0, k_pos0)


def _row_column(t: torch.Tensor) -> torch.Tensor:
    """[B, Tq, H] -> the kernels' compact [B*H, Tq] f32 column."""
    B, Tq, H = t.shape
    return t.float().permute(0, 2, 1).reshape(B * H, Tq)


def _parts_bwd_precision(dtype: torch.dtype, precision: str) -> str:
    """The backward parts' precision for operands of ``dtype``: "default"
    rounds p and ds to the operands' type, as the reference casts them, so
    f32 operands are not rounded and run at "highest"."""
    if _precision_str(precision) == "default" and dtype != torch.bfloat16:
        return "highest"
    return precision


def flash_attention_bwd_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                              q_pos0: int = 0, k_pos0: int = 0, causal: bool = False,
                              block_q: int = 128, block_k: int = 128,
                              precision: str = "highest"
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-attention inner backward: the gradients of q [B, Tq, H, D]
    against one K/V block [B, Tk, H, D] from the ring-global logsumexp
    ``lse`` and ``delta = rowsum(dO * O)`` (both [B, Tq, H] f32), with the
    causal mask shifted by ``q_pos0``/``k_pos0`` as in
    :func:`flash_attention_parts`.  Returns ``(dq_partial, dk_block,
    dv_block)`` in f32 whatever the input type: the caller sums the
    partials over ring steps and rounds once.  On a CUDA tensor this
    launches the dq and dk/dv kernels or raises; on a CPU tensor it runs
    the plain version."""
    bq, bk = _parts_blocks(q.shape[1], k.shape[1], block_q, block_k)
    precision = _parts_bwd_precision(q.dtype, precision)
    if q.device.type == "cpu":
        return flash_attention_bwd_parts_plain(q, k, v, do, lse, delta, q_pos0, k_pos0, causal,
                                               bq, bk, precision)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, do, _row_column(lse), _row_column(delta), causal, precision,
                           (torch.float32,) * 3, q_pos0, k_pos0, parts=True)
    raise KernelCompileError(f"flash_attention_bwd_parts: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Tiled flash attention with its backward: the reference's
    ``_flash_attention_tiled`` custom_vjp.  The forward saves the
    stream-cast q/k/v (bf16 under ``"default"``), the output and the
    compact logsumexp; the backward gives dq in dO's dtype and dk/dv in
    k's and v's primal dtypes.  dO comes from autograd in whatever layout
    the loss gives it (a ``sum`` gives a broadcast with zero strides), so
    it is made contiguous for the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, precision):
        out, lse, (qs, ks, vs) = _flash_forward(q, k, v, causal, block_q, block_k, precision,
                                                with_lse=True)
        ctx.save_for_backward(qs, ks, vs, out, lse)
        ctx.args = (causal, block_q, block_k, precision, k.dtype, v.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, out, lse = ctx.saved_tensors
        causal, block_q, block_k, precision, k_dtype, v_dtype = ctx.args
        dq, dk, dv = _flash_backward(qs, ks, vs, out, lse, do.contiguous(), causal, block_q,
                                     block_k, precision, (do.dtype, k_dtype, v_dtype))
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    block_q: int | None = None, block_k: int | None = None,
                    precision: str = "highest") -> torch.Tensor:
    """Tiled flash attention: q [B, Tq, H, D], k/v [B, Tk, H, D] ->
    [B, Tq, H, D], differentiable.  Default-argument blocks come from
    :func:`default_blocks`; where it gives None the call runs
    :func:`attention_reference` at the same precision (counted ``dense``
    in :data:`ROUTES`), whose gradient is plain autograd, as the
    reference's ``_dense_attention`` is.  Explicit blocks keep
    :func:`_blocks_for`'s contract.  With grad enabled and an input that
    requires grad, the call goes through :class:`_FlashAttention`, which
    keeps the logsumexp for the backward kernels.  The reference's
    ``interpret`` argument has no counterpart: a CUDA tensor runs the
    kernels, a CPU tensor the plain versions."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k, precision)
    return _flash_forward(q, k, v, causal, block_q, block_k, precision)
