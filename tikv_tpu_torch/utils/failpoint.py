"""Failpoints: named fault-injection sites steered from tests.

A trimmed copy of the JAX package's ``utils/failpoint.py`` (the ``fail``
crate's grammar): ``cfg(name, actions)`` arms a site, ``fail_point(name)``
is the site, ``teardown()`` disarms every site.  Actions, chained with
``->``, each ``[cnt*]task[(arg)]``; tasks ``off`` and ``return``.  The
port's sites: ``device::join_dispatch`` (the probe dispatch of a device
join), ``copr::plan_route`` (every fragment of a plan to the host),
``device::before_dispatch`` and ``device::before_fetch`` (a device fault
at a DAG request's dispatch or at its fetch), ``copr::coalesce_dispatch``
(a coalesced group's launch fails: its members retry solo) and
``copr::coalesce_window`` (a group closes as its member arrives).

A site costs one global read while nothing is armed.
"""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_registry: Optional[dict] = None          # None: nothing armed
_TASKS = ("off", "return")


class _Action:
    __slots__ = ("cnt", "task", "arg", "fired")

    def __init__(self, cnt, task, arg):
        self.cnt = cnt          # most firings; None: unlimited
        self.task = task
        self.arg = arg
        self.fired = 0


class _Return:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _parse_one(spec: str) -> _Action:
    spec = spec.strip()
    cnt = None
    head = spec.split("*")[0]
    if "*" in spec and head.replace(".", "").isdigit():
        spec = spec.split("*", 1)[1]
        cnt = int(float(head))
    arg = None
    task = spec
    if "(" in spec:
        task, rest = spec.split("(", 1)
        arg = rest.rsplit(")", 1)[0]
    return _Action(cnt, task.strip(), arg)


def cfg(name: str, actions: str) -> None:
    """Arm ``name``: ``cfg("device::join_dispatch", "1*return->off")``.
    A bad action string is refused here."""
    global _registry
    chain = [_parse_one(s) for s in actions.split("->") if s.strip()]
    if not chain:
        raise ValueError(f"empty failpoint actions {actions!r}")
    for a in chain:
        if a.task not in _TASKS:
            raise ValueError(f"unknown failpoint task {a.task!r}")
    with _lock:
        if _registry is None:
            _registry = {}
        _registry[name] = chain


def teardown() -> None:
    """Disarm every site (a test fixture's cleanup)."""
    global _registry
    with _lock:
        _registry = None


def fail_point(name: str):
    """The injection site: None normally; a ``_Return`` carrying its
    argument when a ``return`` action fires."""
    reg = _registry
    if reg is None:
        return None
    chain = reg.get(name)
    if chain is None:
        return None
    with _lock:
        for action in chain:
            if action.cnt is not None and action.fired >= action.cnt:
                continue
            action.fired += 1
            if action.task == "off":
                return None
            return _Return(action.arg)
    return None
