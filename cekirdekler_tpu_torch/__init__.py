"""cekirdekler_tpu_torch — the PyTorch/CUDA port of cekirdekler_tpu.

The same user API as the JAX package — ``NumberCruncher``, ``ClArray`` /
``ParameterGroup``, the OpenCL-C-subset kernel language and ``@kernel``
Python kernels, the per-compute-id load balancer over lanes — running on
CUDA devices (and host-CPU lanes selected explicitly), with the kernels
the JAX package wrote in Pallas written by hand in CUDA C++ for Hopper
(``csrc/``, ``kernel/cuda_backend.py``), and the reference's observability
hooks (``metrics``, ``trace``, ``obs``: the metrics registry, spans, the
decision log with its replay, the flight recorder; ``utils.faultinject``,
the fault plane).  This package never imports JAX or the JAX package.
"""

from .arrays.clarray import ClArray, ParameterGroup, TransferFlags, wrap
from .arrays.fastarr import (
    BFloat16Arr,
    ByteArr,
    DoubleArr,
    FastArr,
    FloatArr,
    HalfArr,
    IntArr,
    LongArr,
    UIntArr,
    type_code_for_dtype,
)
from .core.cruncher import NumberCruncher
from .errors import (
    CekirdeklerError,
    ComputeValidationError,
    DeviceSelectionError,
    KernelCompileError,
    KernelLanguageError,
)
from .hardware import (
    AcceleratorType,
    Device,
    Devices,
    Platform,
    Platforms,
    all_devices,
    cpus,
    devices_for_type,
    platforms,
)
from .kernel.registry import KernelProgram, PythonKernel, kernel
from . import metrics  # the always-on metrics registry
from . import obs  # decision log, replay, flight recorder
from . import trace  # spans and the fence split

__version__ = "0.1.0"

__all__ = [
    "AcceleratorType", "BFloat16Arr", "ByteArr", "CekirdeklerError", "ClArray",
    "ComputeValidationError", "Device", "DeviceSelectionError", "Devices", "DoubleArr",
    "FastArr", "FloatArr", "HalfArr", "IntArr", "KernelCompileError",
    "KernelLanguageError", "KernelProgram", "LongArr", "NumberCruncher", "ParameterGroup",
    "Platform", "Platforms", "PythonKernel", "TransferFlags", "UIntArr", "all_devices",
    "cpus", "devices_for_type", "kernel", "metrics", "obs", "platforms", "trace",
    "type_code_for_dtype", "wrap",
]
