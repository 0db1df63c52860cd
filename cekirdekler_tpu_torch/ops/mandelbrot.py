"""Mandelbrot escape counts: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``cekirdekler_tpu/ops/mandelbrot.py::mandelbrot_pallas``.
The kernel (``csrc/mandelbrot.cu``) runs one thread per pixel, its escape
loop in branch-free groups of passes, and writes f32 counts straight into ``out[offset : offset+n]`` of the whole output
buffer, in place — the port's counterpart of the reference's update pass
(``workloads.mandelbrot_pallas_kernel``), without its extra copy.

To match the reference exactly: the coefficients are rounded to f32 here
in the wrapper, ``px = idx % width`` and ``py = idx / width`` are int32,
the iteration order is the TPU kernel's, and the build turns FMA
contraction off.  An escaped orbit freezes its count in every version, so
a per-thread exit gives the counts of the TPU's per-block loop.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import torch

from ..errors import KernelCompileError
from ..kernel.build import LaunchCounter, build_library

__all__ = ["mandelbrot", "mandelbrot_plain", "launcher", "LAUNCHES", "SOURCE", "GROUP"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mandelbrot.cu"
#: the passes a group of the kernel's escape loop runs (``MANDEL_GROUP``)
GROUP = int(re.search(r"#define MANDEL_GROUP (\d+)", SOURCE.read_text()).group(1))

#: kernel launches (the wrapper adds one per launch on the card)
LAUNCHES = LaunchCounter()

_launchers: dict[tuple[str | None, str], object] = {}


def launcher(source: str | None = None, compiler: str = "nvcc"):
    """``mandelbrot_launch`` of ``source`` (default: :data:`SOURCE`'s text),
    built once: ``compiler`` is ``"nvcc"`` for the card or ``"g++"`` for
    the host build, whose pixels run one after another."""
    key = (source, compiler)  # the default is keyed by None: no file read a launch
    fn = _launchers.get(key)
    if fn is None:
        text = SOURCE.read_text() if source is None else source
        lib = build_library(text, "mandelbrot", compiler=compiler)
        fn = lib.mandelbrot_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _launchers[key] = fn
    return fn


def _f32(v: float) -> float:
    return float(np.float32(v))


def mandelbrot_plain(out: torch.Tensor, offset: int, n: int, x0: float, y0: float,
                     dx: float, dy: float, width: int, max_iter: int) -> torch.Tensor:
    """The plain version: the vectorized loop of the reference's
    ``workloads.mandelbrot_host``, in torch, on ``out``'s device."""
    dev = out.device
    idx = torch.arange(offset, offset + n, dtype=torch.int32, device=dev)
    cx = _f32(x0) + _f32(dx) * (idx % width).to(torch.float32)
    cy = _f32(y0) + _f32(dy) * torch.div(idx, width, rounding_mode="trunc").to(torch.float32)
    zx = torch.zeros_like(cx)
    zy = torch.zeros_like(cy)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        zx2 = zx * zx
        zy2 = zy * zy
        active = active & (zx2 + zy2 < 4.0)
        if not bool(active.any()):
            break
        t = zx2 - zy2 + cx
        zy = torch.where(active, 2.0 * zx * zy + cy, zy)
        zx = torch.where(active, t, zx)
        count += active.to(torch.int32)
    out[offset:offset + n] = count.to(out.dtype)
    return out


def mandelbrot(out: torch.Tensor, offset: int, n: int, x0: float, y0: float,
               dx: float, dy: float, width: int, max_iter: int) -> torch.Tensor:
    """Escape counts for flat pixels ``[offset, offset+n)`` written into
    ``out`` (a contiguous f32 tensor holding the whole image).  On a CUDA
    tensor this launches the kernel on the current stream or raises; on a
    CPU tensor it runs the plain version."""
    if out.dtype != torch.float32 or out.dim() != 1 or not out.is_contiguous():
        raise KernelCompileError("mandelbrot: out must be a contiguous 1-D f32 tensor")
    if offset < 0 or n < 0 or offset + n > out.numel():
        raise KernelCompileError(
            f"mandelbrot: pixels [{offset}, {offset + n}) outside out[{out.numel()}]")
    if out.device.type == "cpu":
        return mandelbrot_plain(out, offset, n, x0, y0, dx, dy, width, max_iter)
    if out.device.type != "cuda":
        raise KernelCompileError(f"mandelbrot: unsupported device {out.device}")
    fn = launcher()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(out.data_ptr(), out.numel(), int(offset), int(n), _f32(x0), _f32(y0),
            _f32(dx), _f32(dy), int(width), int(max_iter), stream)
    if rc != 0:
        raise KernelCompileError(f"mandelbrot: CUDA launch failed with error {rc}")
    LAUNCHES.add()
    return out
