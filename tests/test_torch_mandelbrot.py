"""The mandelbrot kernel's plain version against the JAX package.

``cekirdekler_tpu_torch/ops/mandelbrot.py`` holds the hand-written CUDA
kernel's wrapper and its plain PyTorch version; on a CPU tensor the
wrapper runs the plain version.  Escape counts are compared bit for bit
with ``workloads.mandelbrot_host`` and with ``mandelbrot_pallas`` (the TPU
kernel, in Pallas interpret mode), at several offsets and chunk sizes, and
through ``compute()`` on host lanes.  The kernel's own source
(``csrc/mandelbrot.cu``), built by g++ for the host, is held bit for bit
against the plain version and ``mandelbrot_host`` at max_iter values
around its group of passes and on a view whose outer pixels run on to inf
and NaN.

XLA:CPU contracts three multiply-adds of the interpreted Pallas kernel
into FMAs (``cx``/``cy``, the new ``zy`` and ``zx*zx - zy2``), which moves
a few boundary pixels.  The port rounds every product, as
``mandelbrot_host`` does and as the CUDA kernel does under ``-fmad=false``.
So the Pallas result is held, bit for bit, against
:func:`mandelbrot_host_contracted` — the host loop with those three
contractions — and the port against ``mandelbrot_host``.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from cekirdekler_tpu import workloads as ref_workloads
from cekirdekler_tpu.ops.mandelbrot import mandelbrot_pallas
from cekirdekler_tpu_torch import all_devices, workloads
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.ops import mandelbrot as op

W, H, ITERS = 64, 48, 60
VALS = (-2.0, -1.25, 2.5 / W, 2.5 / H, W, ITERS)


def mandelbrot_host_contracted(width, height, x0, y0, dx, dy, max_iter):
    """``mandelbrot_host`` with XLA:CPU's three FMA contractions: each
    ``a*b + c`` is rounded once (exact f32 products, summed in f64)."""
    f32, f64 = np.float32, np.float64
    px = np.arange(width * height, dtype=np.int64)
    cx = (f64(f32(dx)) * (px % width).astype(f32) + f64(f32(x0))).astype(f32)
    cy = (f64(f32(dy)) * (px // width).astype(f32) + f64(f32(y0))).astype(f32)
    zx, zy = np.zeros_like(cx), np.zeros_like(cy)
    it = np.zeros(width * height, dtype=np.int32)
    active = np.ones(width * height, dtype=bool)
    for _ in range(max_iter):
        zx2, zy2 = zx * zx, zy * zy
        active = active & (zx2 + zy2 < 4.0)
        t = (zx.astype(f64) * zx - zy2).astype(f32) + cx
        new_zy = ((f32(2.0) * zx).astype(f64) * zy + cy).astype(f32)
        zy = np.where(active, new_zy, zy)
        zx = np.where(active, t, zx)
        it = it + active.astype(np.int32)
    return it.astype(f32)


@pytest.fixture(scope="module")
def image():
    return ref_workloads.mandelbrot_host(W, H, *VALS[:4], ITERS)


@pytest.fixture(scope="module")
def contracted():
    return mandelbrot_host_contracted(W, H, *VALS[:4], ITERS)


@pytest.mark.parametrize("offset,n", [(0, W * H), (128, 256), (128 * 7, 1024),
                                      (W * H - 384, 384), (128 * 3, 128)])
def test_plain_matches_pallas_and_host(offset, n, image, contracted):
    out = torch.full((W * H,), -1.0)
    op.mandelbrot_plain(out, offset, n, *VALS)
    got = out.numpy()
    np.testing.assert_array_equal(got[offset:offset + n], image[offset:offset + n])
    ref = np.asarray(mandelbrot_pallas(n, *VALS, offset=offset, interpret=True))
    np.testing.assert_array_equal(ref, contracted[offset:offset + n])
    # pixels outside the chunk are untouched: the kernel writes in place
    assert (got[:offset] == -1.0).all() and (got[offset + n:] == -1.0).all()


def test_host_reference_is_the_jax_packages():
    np.testing.assert_array_equal(
        workloads.mandelbrot_host(W, H, *VALS[:4], ITERS),
        ref_workloads.mandelbrot_host(W, H, *VALS[:4], ITERS))


def test_wrapper_takes_the_plain_version_only_on_the_cpu(image):
    before = op.LAUNCHES.count
    out = torch.zeros(W * H)
    assert op.mandelbrot(out, 256, 512, *VALS) is out
    np.testing.assert_array_equal(out.numpy()[256:768], image[256:768])
    assert op.LAUNCHES.count == before
    with pytest.raises(KernelCompileError, match="unsupported device"):
        op.mandelbrot(torch.empty(W * H, device="meta"), 0, 128, *VALS)


@pytest.mark.parametrize("bad", [
    dict(out=torch.zeros(W * H, dtype=torch.float64)),
    dict(out=torch.zeros(H, W)),
    dict(out=torch.zeros(W * H), offset=W * H - 64, n=128),
    dict(out=torch.zeros(W * H), offset=-128, n=128),
], ids=["f64", "2-d", "past-the-end", "negative-offset"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = dict(offset=0, n=128) | bad
    with pytest.raises(KernelCompileError):
        op.mandelbrot(args["out"], args["offset"], args["n"], *VALS)


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_hand_kernel_through_compute_on_host_lanes(lanes, image):
    """``mandelbrot_cuda_kernel()`` plugs the kernel into ``compute()`` the
    way the reference's ``mandelbrot_pallas_kernel`` does."""
    res = workloads.run_mandelbrot(all_devices().cpus(lanes), W, H, ITERS, iters=3,
                                   warmup=1, local_range=128, keep_image=True,
                                   use_cuda_kernel=True)
    np.testing.assert_array_equal(res.image.ravel(), image)
    for ranges in res.ranges_per_iter:
        assert sum(ranges) == W * H and all(r % 128 == 0 for r in ranges)


def test_hand_kernel_matches_the_reference_pallas_path(image, contracted):
    from cekirdekler_tpu.hardware import all_devices as ref_devices

    ref = ref_workloads.run_mandelbrot(ref_devices().subset(2), W, H, ITERS, iters=1,
                                       warmup=0, local_range=128, keep_image=True,
                                       use_pallas=True)
    port = workloads.run_mandelbrot(all_devices().cpus(2), W, H, ITERS, iters=1,
                                    warmup=0, local_range=128, keep_image=True,
                                    use_cuda_kernel=True)
    np.testing.assert_array_equal(ref.image.ravel(), contracted)
    np.testing.assert_array_equal(port.image.ravel(), image)


# -- the kernel's source, built by g++ for the host -------------------------

GROUP = op.GROUP
HOST_VIEWS = {"set": VALS[:4], "run-on": (-40.0, -30.0, 1.0, 1.0)}


@pytest.fixture(scope="module")
def host_launch():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the kernel's source cannot be compiled on the host")
    return op.launcher(compiler="g++")


@pytest.mark.parametrize("view", sorted(HOST_VIEWS))
@pytest.mark.parametrize("max_iter", [1, GROUP - 1, GROUP, GROUP + 1, 60, 256])
def test_host_build_of_the_kernel_equals_plain(host_launch, max_iter, view):
    """The grouped escape loop gives the plain loop's counts, exactly, at
    offsets and chunk sizes, and leaves the pixels outside the chunk."""
    vals = (*HOST_VIEWS[view], W, max_iter)
    host = workloads.mandelbrot_host(W, H, *vals[:4], max_iter)
    for offset, n in ((0, W * H), (128, 256), (128 * 7, 1024), (W * H - 384, 384),
                      (1000, 777)):
        got = torch.full((W * H,), -1.0)
        want = torch.full((W * H,), -1.0)
        rc = host_launch(got.data_ptr(), got.numel(), offset, n,
                         *(float(np.float32(v)) for v in vals[:4]), W, max_iter, None)
        assert rc == 0
        op.mandelbrot_plain(want, offset, n, *vals)
        assert torch.equal(got, want), f"{n}@{offset}"
        np.testing.assert_array_equal(got.numpy()[offset:offset + n], host[offset:offset + n])
