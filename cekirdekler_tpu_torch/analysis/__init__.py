"""ckprove — kernel partition-safety & flag-soundness verification.

A copy of the reference's ``analysis/`` package (``interp.py``,
``verdict.py``) over the port's ``kernel/lang.py`` and
``TransferFlags``: a pure-AST abstract interpreter over the kernel
language's parse tree that tracks index provenance from
``get_global_id(0)`` to every array read and write, summarizes each
array's access pattern (gid-affine interval with halo width / uniform /
gather / read-before-write), and proves or refutes split-safety and flag
soundness against the declared :class:`TransferFlags`.  No torch, no
numpy.

Consumers in the port:

- :class:`~cekirdekler_tpu_torch.kernel.registry.KernelProgram`
  summarizes once per source and caches launch verdicts
  (``summaries``, ``verify``);
- ``Cores.compute`` gates on the verdict (advisory by default: one
  ``kernel-verify`` flight event per unsafe shape;
  ``CK_KERNEL_VERIFY=strict`` raises
  :class:`~cekirdekler_tpu_torch.errors.KernelVerifyError` with the named
  finding and source line before any transfer or launch; ``off`` skips
  it);
- ``python -m cekirdekler_tpu_torch.tools.ckprove`` scans the port's
  sources (ratcheted baseline, ``--json``, ``--explain``,
  ``// ckprove: ok`` source suppressions).

The reference's serve admission is the third consumer; it comes with the
serving tier (ROADMAP Queue A 8).  :mod:`.model` (the bounded model
checker of the drain and balance machines) is deliberately NOT imported
here: it imports the live controllers it drives.
"""

from .interp import AV, Access, KernelSummary, summarize_kernel
from .verdict import (
    ADVISORY_KINDS,
    ERROR_KINDS,
    VERDICT_KINDS,
    Finding,
    LaunchVerdict,
    classify,
    flag_row,
    structural_findings,
    suppressed_lines,
    verify_launch,
)

__all__ = [
    "AV",
    "Access",
    "ADVISORY_KINDS",
    "ERROR_KINDS",
    "Finding",
    "KernelSummary",
    "LaunchVerdict",
    "VERDICT_KINDS",
    "classify",
    "flag_row",
    "structural_findings",
    "summarize_kernel",
    "suppressed_lines",
    "verify_launch",
]
