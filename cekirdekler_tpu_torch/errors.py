"""Error surface for the framework.

The reference collects per-worker compile errors into an aggregated message and
refuses further compute once any error happened (Cores.cs:264-272,
ClArray.cs:1610-1623 ``numberOfErrorsHappened``).  We raise typed exceptions
instead, but keep an error counter on the cruncher for API parity.
"""

from __future__ import annotations


class CekirdeklerError(Exception):
    """Base class for all framework errors."""


class KernelCompileError(CekirdeklerError):
    """Kernel-string compilation failed (reference: ClProgram build error,
    ClProgram.cs:62-73)."""

    def __init__(self, message: str, source: str | None = None, line: int | None = None):
        self.source = source
        self.line = line
        if line is not None:
            message = f"line {line}: {message}"
        super().__init__(message)


class KernelLanguageError(KernelCompileError):
    """Kernel uses a construct outside the supported TPU kernel contract."""


class ComputeValidationError(CekirdeklerError):
    """Invalid compute() arguments (reference: ClArray.cs:1625-1679 /
    ClParameterGroup validation, ClArray.cs:543-645)."""


class KernelVerifyError(ComputeValidationError):
    """The kernel partition-safety/flag-soundness verifier
    (``analysis/``) refuted this launch and ``CK_KERNEL_VERIFY=strict``
    is set.  Carries the first named :class:`~.analysis.Finding` as
    ``finding`` (kind, kernel, param, source line)."""

    def __init__(self, finding):
        self.finding = finding
        super().__init__(
            f"kernel verifier [{finding.kind}] at kernel source line "
            f"{finding.line}: {finding.message} (CK_KERNEL_VERIFY=strict; "
            "fix the kernel/flags or suppress the line with "
            "`// ckprove: ok <why>`)"
        )


class DeviceSelectionError(CekirdeklerError):
    """No devices matched the query (reference: Cores error strings when no
    devices are found, Cores.cs:186-246)."""


class NotPortedError(CekirdeklerError, NotImplementedError):
    """The JAX package supports this configuration or call, the port does
    not yet; the message names the ROADMAP item that brings it."""


class ClusterError(CekirdeklerError):
    """Cluster tier failure (connection, protocol, or remote compute error)."""


class PoolError(CekirdeklerError):
    """Task/device pool misuse or scheduling failure."""


class ClusterRetryExhausted(ClusterError):
    """A cluster client operation failed through every reconnect
    attempt (``cluster/client.py``'s bounded exponential-backoff
    retry loop).  Carries the attempt count and the final cause —
    the named, non-hanging end state of a dead or unreachable node."""

    def __init__(self, op: str, attempts: int, cause: BaseException):
        self.op = op
        self.attempts = attempts
        self.cause = cause
        super().__init__(
            f"cluster op {op!r} failed after {attempts} attempt(s); "
            f"last error: {type(cause).__name__}: {cause}"
        )


class FusedBatchError(CekirdeklerError):
    """An externally-assembled fused batch
    (``Cores.compute_fused_batch``) failed mid-window — the serving
    tier's containment input.  Instead of one opaque sync-point
    exception, this carries everything blast-radius containment
    (``serve/resilience.py``) needs to decide what is recoverable:

    - ``cause`` — the NAMED failure cause (``injected:driver-submit``
      for chaos-plane faults, else the original exception's type name);
    - ``applied_iters`` — iterations of this batch that COMPLETED
      dispatch before the failure (the per-call seed/engage iterations
      plus any earlier flushed residue);
    - ``requested_iters`` — the batch size asked for;
    - ``clean`` — True when the failed residue was NOT partially
      dispatched across lanes (the failure fired in the dispatch
      preflight, before any lane's closure was queued), so re-dispatching
      the residue is bit-exact.  ``clean=False`` means device state may
      have diverged per lane — containment must fail the residue with a
      named error rather than risk double-applying iterations;
    - ``original`` — the underlying exception (``.lane`` is surfaced
      when the cause names one, so per-lane breakers can attribute it).
    """

    def __init__(self, cause: str, applied_iters: int,
                 requested_iters: int, clean: bool,
                 original: BaseException):
        self.cause = cause
        self.applied_iters = int(applied_iters)
        self.requested_iters = int(requested_iters)
        self.clean = bool(clean)
        self.original = original
        self.lane = getattr(original, "lane", None)
        super().__init__(
            f"fused batch failed ({cause}) after "
            f"{applied_iters}/{requested_iters} iteration(s) applied; "
            f"{'clean' if clean else 'NOT clean'} residue: {original}"
        )


class InjectedFaultError(CekirdeklerError):
    """A DELIBERATELY injected fault fired (``utils/faultinject.py``,
    armed by ``CK_FAULTS``) — named so chaos tests and postmortems can
    tell an injected failure from a real one."""

    def __init__(self, point: str, lane=None, where=None):
        self.point = point
        self.lane = lane
        self.where = where
        at = f" lane={lane}" if lane is not None else ""
        at += f" where={where}" if where is not None else ""
        super().__init__(f"injected fault at point {point!r}{at} (CK_FAULTS)")
