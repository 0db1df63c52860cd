"""Hand-written CUDA kernels with their plain PyTorch versions.

They plug into the compute API as ``@kernel`` Python kernels
(``workloads.saxpy_kernel``, ``workloads.mandelbrot_cuda_kernel``) or are
called directly.
"""

from .elementwise import map_blocks, saxpy

__all__ = ["map_blocks", "saxpy"]
