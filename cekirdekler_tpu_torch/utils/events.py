"""Host-controlled events: the ClEvent / ClUserEvent analogue.

Counterpart of ``cekirdekler_tpu/utils/events.py`` (reference
ClUserEvent.cs:29-121): a host-triggered event with a pending counter,
which fires on :meth:`UserEvent.trigger` or when the counter decrements to
zero.  ``NumberCruncher.dispatch_gate`` holds every lane of a compute call
at the top of its phase until the event fires, so triggering starts all
lanes together (the reference's synchronized queue start,
Worker.cs:487-557).

One ``threading.Condition`` guards the fired flag and the counter, so a
decrement that fires and a waiter that checks see one state; a wait
releases the interpreter lock while it blocks.  :meth:`UserEvent.close`
releases every waiter, as the reference's native tier does when its event
is deleted.
"""

from __future__ import annotations

import threading

__all__ = ["UserEvent"]


class UserEvent:
    """Host-triggered gate with a pending counter (fires at zero).

    ``increment`` / ``decrement`` are the reference's counter semantics
    (ClUserEvent.cs:49-117): hold the gate for N contributors and fire when
    the last one decrements, or fire at once with :meth:`trigger`.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._fired = False
        self._pending = 0

    def trigger(self) -> None:
        with self._cond:
            self._fired = True
            self._cond.notify_all()

    def fired(self) -> bool:
        with self._cond:
            return self._fired

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the event fires (or is closed); False on a timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._fired, timeout)

    def increment(self) -> None:
        with self._cond:
            self._pending += 1

    def decrement(self) -> None:
        """Decrement the pending counter; fires the event at zero."""
        with self._cond:
            self._pending -= 1
            if self._pending <= 0 and not self._fired:
                self._fired = True
                self._cond.notify_all()

    def pending(self) -> int:
        with self._cond:
            return self._pending

    def close(self) -> None:
        """Release every waiter (the event fires); idempotent."""
        self.trigger()

    def __del__(self):  # best-effort; an explicit close is preferred
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
