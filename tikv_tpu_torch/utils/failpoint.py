"""Failpoints: named fault-injection sites steered from tests.

A trimmed copy of the JAX package's ``utils/failpoint.py`` (the ``fail``
crate's grammar): ``cfg(name, actions)`` arms a site, ``fail_point(name)``
is the site, ``teardown()`` disarms every site.  Actions, chained with
``->``, each ``[pct%][cnt*]task[(arg)]``; tasks ``off``, ``return`` and
``sleep(ms)`` (the site waits, then goes on as if unarmed; ``pct%``: the
action fires on that share of hits, at random).  The
port's sites: ``device::join_dispatch`` (the probe dispatch of a device
join), ``copr::plan_route`` (every fragment of a plan to the host),
``device::before_dispatch`` and ``device::before_fetch`` (a device fault
at a DAG request's dispatch or at its fetch), ``device::shard_launch`` (a
shard's launches fail on a mesh: ``return`` at the first shard,
``return(i)`` at shard i; the request is answered by the host pipeline), ``copr::coalesce_dispatch``
(a coalesced group's launch fails: its members retry solo) and
``copr::coalesce_window`` (a group closes as its member arrives), and
on a placement mesh ``device::slice_dead`` (``return`` every slice,
``return(i j)`` slices i and j fail their dispatches, fetches and
canaries; ``50%return(i)`` a flapping slice), ``device::feed_migrate`` (a
migrated feed's plane flips one bit on arrival) and
``device::mesh_rebuild`` (the degraded submesh cannot be built); on the
cold path ``apply::before_ingest`` (an SST ingest fails before its blob is
read) and ``device::mvcc_resolve`` (the device rung of a cold build
declines: the native rung serves); on the network
``transport::grpc_drop`` (a raft message is dropped before it queues),
``transport::before_batch_send`` (a raft batch's send fails: the
connection backs off), ``client::before_retry`` and
``backoff::before_sleep``; on the read legs ``copr::fastpath`` (the fast
path: ``return(miss)`` and ``return(full)`` take the full decode,
``return(corrupt)`` flips a byte of a learned template first),
``device::replica_stale`` (a follower refuses a stale read with
``DataIsNotReady``) and ``read::before_leader_read`` (``sleep(ms)``: a
slowed leader).  ``list_cfg()`` reads what is armed (the
status server's ``GET /fail_point``).

A site costs one global read while nothing is armed.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

_lock = threading.Lock()
_registry: Optional[dict] = None          # None: nothing armed
_TASKS = ("off", "return", "sleep")


class _Action:
    __slots__ = ("pct", "cnt", "task", "arg", "fired")

    def __init__(self, pct, cnt, task, arg):
        self.pct = pct          # percent of hits that fire; None: all
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
    pct = cnt = None
    if "%" in spec.split("*")[0].split("(")[0]:
        head, spec = spec.split("%", 1)
        pct = float(head)
    head = spec.split("*")[0]
    if "*" in spec and head.replace(".", "").isdigit():
        spec = spec.split("*", 1)[1]
        cnt = int(float(head))
    arg = None
    task = spec
    if "(" in spec:
        task, rest = spec.split("(", 1)
        arg = rest.rsplit(")", 1)[0]
    return _Action(pct, cnt, task.strip(), arg)


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


def remove(name: str) -> None:
    """Disarm ``name`` alone."""
    with _lock:
        if _registry is not None:
            _registry.pop(name, None)


def list_cfg() -> dict:
    """{armed site: [its actions' tasks]}."""
    with _lock:
        if not _registry:
            return {}
        return {name: [a.task for a in chain]
                for name, chain in _registry.items()}


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
    fired = None
    with _lock:
        for action in chain:
            if action.cnt is not None and action.fired >= action.cnt:
                continue
            if action.pct is not None and \
                    random.random() * 100.0 >= action.pct:
                continue
            action.fired += 1
            fired = action
            break
    if fired is None or fired.task == "off":
        return None
    if fired.task == "sleep":
        # outside the registry's lock: a sleeping site holds up no other
        time.sleep(float(fired.arg or 0) / 1e3)
        return None
    return _Return(fired.arg)
