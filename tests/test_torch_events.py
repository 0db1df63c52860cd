"""The port's ``utils.events.UserEvent`` against the JAX package's.

The reference's scenarios (``tests/test_utils.py::test_user_event_counter_semantics``
and ``tests/test_events_timeline.py``) run step by step through both
packages' events, and every answer (``fired``, ``pending``, ``wait``) must
be equal at every step.  The reference's event runs on its native tier
where the library loads, else on its Python fallback; the port's is one
``threading.Condition``.  Waits are bounded.
"""

from __future__ import annotations

import threading
import time

import pytest

from cekirdekler_tpu.utils.events import UserEvent as RefEvent
from cekirdekler_tpu_torch.utils.events import UserEvent

#: (operation, argument) steps; each returns what the event answers
SCENARIOS = {
    "trigger and fired": [("fired", None), ("wait", 0.05), ("trigger", None), ("fired", None),
                          ("wait", 0.05)],
    "counter fires at zero": [("increment", None), ("increment", None), ("pending", None),
                              ("decrement", None), ("fired", None), ("pending", None),
                              ("decrement", None), ("fired", None), ("pending", None)],
    "counter then wait": [("fired", None), ("increment", None), ("increment", None),
                          ("pending", None), ("decrement", None), ("fired", None),
                          ("decrement", None), ("fired", None), ("wait", 1.0)],
    "untriggered wait times out": [("wait", 0.05), ("trigger", None), ("wait", 1.0)],
    "decrement below zero fires": [("decrement", None), ("pending", None), ("fired", None),
                                   ("wait", 0.05)],
    "increment after firing": [("trigger", None), ("increment", None), ("pending", None),
                               ("fired", None), ("decrement", None), ("fired", None)],
}


def _play(ev, steps) -> list:
    out = []
    for op, arg in steps:
        fn = getattr(ev, op)
        out.append(fn(arg) if arg is not None else fn())
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_step_answers_as_the_reference(name):
    port, ref = UserEvent(), RefEvent()
    try:
        got, want = _play(port, SCENARIOS[name]), _play(ref, SCENARIOS[name])
    finally:
        port.close()
        ref.close()
    assert got == want, (got, want)
    assert all(isinstance(v, (bool, int, type(None))) for v in got)


@pytest.mark.parametrize("cls", [UserEvent, RefEvent], ids=["port", "ref"])
@pytest.mark.parametrize("release", ["trigger", "decrement", "close"])
def test_a_blocked_waiter_is_released(cls, release):
    """A waiter blocks until the event fires: by ``trigger``, by the last
    ``decrement``, or by ``close`` (the reference's native tier releases
    its waiters when the event is deleted); its wait answers True."""
    ev = cls()
    if release == "decrement":
        ev.increment()
    answers: list = []
    entered = threading.Event()

    def waiter():
        entered.set()
        answers.append(ev.wait(timeout=10.0))

    t = threading.Thread(target=waiter)
    t.start()
    try:
        entered.wait(5.0)
        time.sleep(0.05)
        assert answers == []  # genuinely blocked
        getattr(ev, release)()
        t.join(timeout=10.0)
        assert not t.is_alive() and answers == [True]
    finally:
        t.join(timeout=1.0)
        ev.close()


@pytest.mark.parametrize("cls", [UserEvent, RefEvent], ids=["port", "ref"])
def test_close_is_idempotent(cls):
    ev = cls()
    ev.close()
    ev.close()  # the __del__ path after an explicit close


def test_many_contributors_fire_once():
    """Eight threads decrement an event held for eight contributors; it
    fires at the last one, and every waiter is released."""
    ev = UserEvent()
    for _ in range(8):
        ev.increment()
    released: list = []
    waiters = [threading.Thread(target=lambda: released.append(ev.wait(timeout=10.0)))
               for _ in range(4)]
    for t in waiters:
        t.start()
    decs = [threading.Thread(target=ev.decrement) for _ in range(8)]
    for t in decs:
        t.start()
    for t in decs + waiters:
        t.join(timeout=10.0)
    assert ev.pending() == 0 and ev.fired() and released == [True] * 4
    ev.close()
