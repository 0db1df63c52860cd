"""Elastic membership for the cluster tier: epoch-numbered member sets,
heartbeat/timeout liveness, LCM-step re-splits on join/leave, and
per-window partition checkpoints — preemption-safe execution.

A copy of the reference's ``cluster/elastic.py`` kept in the port (which
never imports the JAX package), over the port's ``utils/checkpoint.py``: a
window one package saves, the other resumes, and the decision rows of the
same transitions are equal (``tests/test_torch_elastic.py``).  In the port
the DCN tier's job is a ``torch.distributed`` process group, as static as a
``jax.distributed`` job.  The text below is the reference's.

``jax.distributed`` jobs cannot lose or add processes mid-run (the
static-membership note in ``dcn.py``), so elasticity at the DCN tier is
RESTART-shaped: production TPU slices get preempted whole, the job
comes back (possibly with a different process count), and the work must
resume exactly where it left off.  Three primitives make that safe:

- :class:`Membership` — an epoch-numbered member table (member id →
  LCM step).  Every ``leave``/``join`` bumps the epoch and records a
  replayable ``member-leave``/``member-join`` decision whose outputs
  are the POST-change equal re-split from the new LCM-step table
  (:func:`member_resplit` — the pure function ``ckreplay verify``
  re-executes).  A kill-and-rejoin job's membership transitions are
  therefore event-sourced like every other controller decision.
- :class:`Heartbeat` / :func:`alive_members` — file-mtime heartbeats
  in a shared directory: a member whose beat goes stale past
  ``timeout_s`` is detected as departed (the detection half of
  preemption — the TCP tier and tests drive :meth:`Membership.sync`
  from it).
- :func:`save_window` / :func:`resume_window` — lightweight per-window
  checkpoints of the partition state through
  ``utils/checkpoint.py``'s atomic tmp+rename path, carrying the
  window index and the member-step table as metadata.  A restarted
  job resumes from the last COMPLETE window (torn newest steps fall
  back — ``utils/checkpoint.load_arrays``), re-splits for its new
  membership, and continues: windows are applied exactly once, so a
  kill-and-rejoin run converges to the bit-identical image of an
  undisturbed one (tests/_torch_dcn_elastic_worker.py is the harness).

The restore is recorded as a ``checkpoint-restore`` decision (context
record — it reads the filesystem, so it is provenance, not an oracle).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..metrics.registry import REGISTRY
from ..obs.decisions import DECISIONS
from ..obs.flight import FLIGHT
from ..utils import checkpoint as ckpt
from .balancer import ClusterLoadBalancer

__all__ = [
    "Membership",
    "member_resplit",
    "MODEL_INVARIANTS",
    "Heartbeat",
    "alive_members",
    "save_window",
    "resume_window",
    "META_PREFIX",
]

#: Checkpoint-metadata key prefix inside the arrays payload (the
#: window index and member-step table ride the same atomic .npz as the
#: partition arrays — one rename, one unit of consistency).
META_PREFIX = "_ck_meta_"

#: Machine-checked temporal invariants of the elastic-membership
#: machine (the ``MODEL_INVARIANTS`` contract — see ``obs/drain.py``):
#: ``analysis/model.py`` drives a REAL :class:`Membership` through
#: every leave/join/timeout interleaving over a small roster alphabet
#: (ids chosen to exercise the length-then-lex order) and checks each
#: captured ``member-leave``/``member-join`` record against these.
MODEL_INVARIANTS = (
    ("epoch-monotone", "safety",
     "every membership transition bumps the epoch by exactly one — "
     "epochs are strictly monotone across any interleaving"),
    ("resplit-conservation", "safety",
     "member_resplit ranges sum exactly to the total: a membership "
     "change never loses or invents work (remainder folded, not "
     "dropped)"),
    ("resplit-quantized", "safety",
     "every member's re-split share is a non-negative LCM-chunk "
     "multiple; only member 0 (the mainframe rule) may carry the "
     "sub-LCM remainder"),
    ("sync-converges", "liveness",
     "Membership.sync reconciles to exactly the observed roster in "
     "one call — departures recorded before arrivals, a step change "
     "recorded as leave+join, nothing left behind"),
    ("deterministic-order", "safety",
     "the same (roster, observation) diff always records the same "
     "transition sequence — length-then-lex member order, so a "
     "10-member roster cannot reorder the decision log"),
)


def member_resplit(steps: list, total: int) -> dict:
    """The PURE post-change re-split: equal LCM-chunk distribution over
    the (new) member-step table, remainder folded into member 0 (the
    mainframe rule ``dcn.py`` uses).  ONE re-split implementation on
    purpose — this delegates to
    :meth:`~.balancer.ClusterLoadBalancer.resplit_active` (the general
    active-subset form the TCP tier uses in place), so the two can
    never drift and break the replay-verify bit-identity contract.
    ``member-leave``/``member-join`` decision outputs store exactly
    this dict."""
    steps = [int(s) for s in steps]
    bal = ClusterLoadBalancer(steps)
    shares, rem = bal.resplit_active(int(total), range(len(steps)))
    if shares:
        shares[0] += rem
    return {"ranges": shares, "lcm": bal.lcm}


def _member_order(member: str):
    """Length-then-lexicographic member ordering (the obs/drain lane
    key): ``"p2" < "p10"`` — plain ``sorted`` would interleave 10+
    members out of process order and the positional ``steps_after`` /
    ``ranges`` in the decision record would attribute shares to the
    wrong member."""
    return (len(member), member)


class Membership:
    """Epoch-numbered member table (see module docstring).  Member ids
    are strings (``"p0"``, a hostname, …); the value is the member's
    LCM step (device count × local range)."""

    def __init__(self):
        self.epoch = 0
        self.members: dict[str, int] = {}
        self._mu = threading.Lock()
        self._g_epoch = REGISTRY.gauge(
            "ck_member_epoch", "cluster membership epoch")
        self._g_count = REGISTRY.gauge(
            "ck_member_count", "live cluster members")

    def establish(self, members: dict) -> int:
        """Initial member set — epoch 1, no per-member decisions (the
        starting roster is configuration, not a transition)."""
        with self._mu:
            self.members = {str(k): int(v) for k, v in members.items()}
            self.epoch = 1
            self._export_locked()
            return self.epoch

    def _export_locked(self) -> None:
        self._g_epoch.set(float(self.epoch))
        self._g_count.set(float(len(self.members)))

    def _transition(self, kind: str, member: str, step: int | None,
                    total: int | None) -> dict:
        """One leave/join: bump the epoch, record the decision with the
        post-change re-split (when a total is known)."""
        with self._mu:
            before = dict(self.members)
            epoch_before = self.epoch
            if kind == "member-leave":
                self.members.pop(member, None)
            else:
                self.members[str(member)] = int(step or 0)
            self.epoch += 1
            after = dict(self.members)
            epoch_after = self.epoch
            self._export_locked()
        REGISTRY.counter(
            "ck_member_changes_total", "membership transitions",
            kind="leave" if kind == "member-leave" else "join",
        ).inc()
        steps = [after[m] for m in sorted(after, key=_member_order)]
        outputs: dict = {"epoch_after": epoch_after,
                         "members_after": after}
        if total is not None and steps:
            outputs.update(member_resplit(steps, total))
        FLIGHT.event(kind, member=member, epoch=epoch_after,
                     members=len(after))
        if DECISIONS.enabled:
            DECISIONS.record(kind, {
                "member": str(member),
                "step": None if step is None else int(step),
                "epoch_before": epoch_before,
                "members_before": before,
                "steps_after": steps,
                "total": total,
            }, outputs)
        return outputs

    def leave(self, member: str, total: int | None = None) -> dict:
        """A member departed (preemption, timeout): epoch bump +
        recorded ``member-leave`` with the survivors' re-split."""
        return self._transition("member-leave", str(member), None, total)

    def join(self, member: str, step: int, total: int | None = None) -> dict:
        """A member arrived (rejoin, scale-up): epoch bump + recorded
        ``member-join`` with the new roster's re-split."""
        return self._transition("member-join", str(member), step, total)

    def sync(self, present: dict, total: int | None = None) -> list[dict]:
        """Reconcile against an observed member set (e.g. from
        :func:`alive_members` or a restarted job's new roster): one
        recorded transition per departure, then per arrival, in sorted
        member order — deterministic decision sequence for a given
        diff.  Returns the transition outputs in order."""
        present = {str(k): int(v) for k, v in present.items()}
        with self._mu:
            current = dict(self.members)
        out = []
        # a member whose STEP changed (device count moved under the
        # same id) is a rejoin: leave then join, both recorded — the
        # LCM-step table is the re-split's input, so a silent step
        # change would leave the decision log claiming an old geometry
        resized = sorted(
            (m for m in present
             if m in current and present[m] != current[m]),
            key=_member_order)
        for m in sorted(set(current) - set(present),
                        key=_member_order) + resized:
            out.append(self.leave(m, total))
        for m in sorted(set(present) - set(current),
                        key=_member_order) + resized:
            out.append(self.join(m, present[m], total))
        return out

    def snapshot(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "members": dict(self.members)}


# -- heartbeats ---------------------------------------------------------------

def _hb_path(root: str, member: str) -> str:
    return os.path.join(root, f"hb_{member}")


class Heartbeat:
    """File-mtime heartbeat: a daemon thread touches
    ``<root>/hb_<member>`` every ``interval_s`` until :meth:`close`.
    Liveness is mtime recency (:func:`alive_members`) — a SIGKILLed
    process simply stops beating, which is exactly the failure mode
    preemption presents."""

    def __init__(self, root: str, member: str, interval_s: float = 0.5,
                 start: bool = True):
        self.root = root
        self.member = str(member)
        self.interval_s = float(interval_s)
        os.makedirs(root, exist_ok=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.beat()
        if start:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"ck-heartbeat-{member}")
            self._thread.start()

    def beat(self) -> None:
        path = _hb_path(self.root, self.member)
        with open(path, "w") as f:
            f.write(f"{time.time()}\n")

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError:
                pass  # a full disk must not kill the member itself

    def close(self, remove: bool = False) -> None:
        """Stop beating; ``remove=True`` also retracts the file (a
        CLEAN leave — a crash leaves the file to go stale instead)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if remove:
            try:
                os.remove(_hb_path(self.root, self.member))
            except OSError:
                pass


def alive_members(root: str, timeout_s: float,
                  now: float | None = None) -> list[str]:
    """Members whose heartbeat file's mtime is within ``timeout_s`` of
    ``now`` — sorted; an empty/missing root is an empty roster."""
    if not os.path.isdir(root):
        return []
    t = time.time() if now is None else now
    out = []
    for name in os.listdir(root):
        if not name.startswith("hb_"):
            continue
        try:
            mtime = os.path.getmtime(os.path.join(root, name))
        except OSError:
            continue  # retracted between listdir and stat
        if t - mtime <= timeout_s:
            out.append(name[3:])
    return sorted(out)


# -- per-window partition checkpoints -----------------------------------------

def save_window(root: str, window: int, arrays: dict,
                member_steps: list | None = None) -> str:
    """Checkpoint one completed window's partition state: the arrays
    plus the window index and (optionally) the member-step table, all
    in ONE atomic ``utils/checkpoint.py`` step dir — a killed writer
    never leaves a half-window (tmp+rename), and a reader always gets
    a consistent (window, arrays, membership) triple."""
    payload = dict(arrays)
    payload[META_PREFIX + "window"] = np.asarray([int(window)], np.int64)
    if member_steps is not None:
        payload[META_PREFIX + "members"] = np.asarray(
            [int(s) for s in member_steps], np.int64)
    return ckpt.save_arrays(root, int(window), payload)


def resume_window(root: str) -> dict | None:
    """Load the newest COMPLETE window checkpoint (torn/corrupt newest
    steps fall back — ``utils/checkpoint.load_arrays``'s contract).
    Returns ``{"window", "arrays", "member_steps"}`` or None when no
    checkpoint exists.  The restore lands as a ``checkpoint-restore``
    decision (context record) and a flight event, so a resumed run's
    provenance names exactly which window it continued from."""
    step = ckpt.latest_step(root)
    if step is None:
        return None
    loaded = ckpt.load_arrays(root)
    window = int(loaded.pop(META_PREFIX + "window")[0]) \
        if META_PREFIX + "window" in loaded else step
    members = loaded.pop(META_PREFIX + "members", None)
    member_steps = None if members is None else [int(s) for s in members]
    FLIGHT.event("checkpoint-restore", root=root, window=window,
                 arrays=len(loaded))
    if DECISIONS.enabled:
        DECISIONS.record("checkpoint-restore", {
            "root": root, "latest_step": step,
        }, {
            "window": window,
            "arrays": sorted(loaded),
            "member_steps": member_steps,
        })
    REGISTRY.counter(
        "ck_checkpoint_restores_total",
        "window-checkpoint restores (elastic resume)").inc()
    return {"window": window, "arrays": loaded,
            "member_steps": member_steps}
