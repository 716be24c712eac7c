"""Deferred device results: the half of a request after its kernels launch.

Counterparts of the JAX package's ``device/runner.py:282-622``.  A device
request dispatches under the runner's lock and comes back as a
``_Pending``: the device buffers its answer needs, already being copied
into page-locked host memory on the launch stream (``PinnedStager``), and
the host finalize that turns the fetched arrays into a ``SelectResult``.
``DeferredResult`` is the caller's handle: ``result()`` waits for the copy,
runs the finalize, and memoizes, from any thread.

A coalesced group's stacked dispatch (``DeviceRunner.handle_batched``)
comes back as one ``_GroupPending`` (one shared fetch) behind a
``_BatchedSelectionGroup``, whose ``member_result(i)`` gives member i its
own answer from that fetch.

The degrade contract holds at fetch: a device fault inside a deferred
fetch (``device::before_fetch``, or any of ``DEVICE_FAULTS``) serves that
request from the host pipeline and marks the handle ``degraded``.  A
group's shared fetch has no fallback of its own: its fault reaches every
member, and each member degrades on its own through the endpoint.  The
reference's arena pins and slice rescue are not here: the port has no
feed arena yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import DEVICE_FAULTS


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class PinnedStager:
    """A pool of page-locked host buffers for device→host readbacks.

    ``stage(tensors)`` copies each device tensor into a pooled host buffer
    of its bytes class (the next power of two, at least ``MIN_CLASS``) with
    ``copy_(non_blocking=True)`` on the stream that launched it, then
    records one ``torch.cuda.Event``; ``Staged.fetch()`` waits on that
    event, copies the bytes out into numpy arrays and gives the buffers
    back.  Pinned allocation (``cudaHostAlloc``) is slow, so buffers are
    reused: at most ``MAX_FREE`` idle buffers a class, at most
    ``MAX_CLASSES`` (bytes class, device) pairs pooled; past that a buffer
    is pinned but not pooled.  A pinned allocation that fails raises: a
    readback never becomes a pageable copy unannounced.  CPU tensors are
    copied plainly into unpinned buffers of the same pool (the reference's
    "unpinned_host" test mode)."""

    MIN_CLASS = 1 << 12
    MAX_CLASSES = 256
    MAX_FREE = 8

    def __init__(self):
        self._mu = threading.Lock()
        self._free: dict = {}           # (bytes class, device) -> [buffer]
        self.staged = 0                 # tensors staged
        self.staged_bytes = 0
        self.classes = 0
        self.allocated = 0              # host buffers allocated

    def _take(self, nbytes: int, device: torch.device) -> tuple:
        size = max(self.MIN_CLASS, 1 << max(0, (nbytes - 1).bit_length()))
        key = (size, str(device))
        with self._mu:
            free = self._free.get(key)
            if free:
                return free.pop(), key
            if free is None:
                if len(self._free) >= self.MAX_CLASSES:
                    key = None
                else:
                    self._free[key] = []
                    self.classes += 1
            self.allocated += 1
        buf = torch.empty(size, dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        return buf, key

    def _give(self, buf: torch.Tensor, key) -> None:
        if key is None:
            return
        with self._mu:
            free = self._free[key]
            if len(free) < self.MAX_FREE:
                free.append(buf)

    def stage(self, tensors: Sequence[torch.Tensor]) -> "Staged":
        """Start the copies of ``tensors`` (on one device) to the host.
        Every launch and copy of the port runs on the device's current
        stream, so a result tensor dropped once its copy is enqueued cannot
        be reused by the caching allocator before the copy has run."""
        device = tensors[0].device
        cuda = device.type == "cuda"
        slots, total = [], 0
        for t in tensors:
            src = t.detach().contiguous().reshape(-1)
            nbytes = src.numel() * src.element_size()
            buf, key = self._take(nbytes, device)
            if nbytes:
                buf[:nbytes].copy_(src.view(torch.uint8), non_blocking=cuda)
            slots.append((buf, key, nbytes, t.dtype, tuple(t.shape)))
            total += nbytes
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        with self._mu:
            self.staged += len(slots)
            self.staged_bytes += total
        return Staged(self, slots, event)

    def stats(self) -> dict:
        with self._mu:
            return {"staged": self.staged, "staged_bytes": self.staged_bytes,
                    "classes": self.classes, "allocated": self.allocated,
                    "pooled": sum(len(f) for f in self._free.values())}


class Staged:
    """Copies in flight to pooled host buffers (``PinnedStager.stage``)."""

    __slots__ = ("_stager", "_slots", "_event")

    def __init__(self, stager, slots, event):
        self._stager = stager
        self._slots = slots
        self._event = event

    def fetch(self) -> list:
        """Wait for the copies (``Event.synchronize``, which waits with the
        interpreter lock released), then → numpy arrays of the tensors'
        dtypes and shapes; the buffers go back to the pool.  Call once."""
        if self._event is not None:
            self._event.synchronize()
        out = []
        for buf, key, nbytes, dtype, shape in self._slots:
            host = buf[:nbytes].numpy().copy()
            out.append(host.view(_np_dtype(dtype)).reshape(shape))
            self._stager._give(buf, key)
        self._slots = ()
        return out


# process-wide: page-locked host memory is a per-process resource, shared
# by every runner
HOST_STAGER = PinnedStager()


class _Pending:
    """A dispatched request: ``staged``, the copies of its result buffers
    to the host, started at construction (under the dispatch lock, right
    after the launches); ``finalize(fetched numpy arrays)`` → its answer.
    ``small``: aggregate states (KBs), which a completion pool serves
    before bulk row readbacks."""

    __slots__ = ("staged", "finalize", "small")

    def __init__(self, tensors: Sequence[torch.Tensor], finalize: Callable,
                 small: bool):
        self.staged = HOST_STAGER.stage(tensors)
        self.finalize = finalize
        self.small = small


class DeferredResult:
    """Handle of a device request whose fetch and host finalize have not
    run yet (``DeviceRunner.handle_request(..., deferred=True)``).

    ``result()`` waits for the copy, runs the finalize and memoizes; it is
    safe to call from any thread, and runs the fetch once.  A device fault
    inside the fetch answers this request on the host pipeline instead
    (``degraded`` is then "fetch"); any other exception propagates."""

    __slots__ = ("_runner", "_pending", "_dag", "_storage", "_mu", "_memo",
                 "small", "degraded")

    def __init__(self, runner, pending: _Pending, dag, storage):
        self._runner = runner
        self._pending = pending
        self._dag = dag                 # the request, for the host fallback
        self._storage = storage
        self._mu = threading.Lock()
        self._memo = None
        self.small = pending.small
        self.degraded: Optional[str] = None

    def result(self):
        with self._mu:
            if self._memo is None:
                try:
                    self._memo = ("ok", self._resolve())
                except BaseException as e:      # noqa: BLE001 — memoized
                    self._memo = ("err", e)
            kind, val = self._memo
        if kind == "err":
            raise val
        return val

    def _resolve(self):
        try:
            r = self._runner._finish(self._pending)
        except DEVICE_FAULTS:
            from ..executors.runner import BatchExecutorsRunner
            self.degraded = "fetch"
            return BatchExecutorsRunner(self._dag,
                                        self._storage).handle_request()
        return self._runner._apply_output_offsets(self._dag, r)


class _BatchUnavailable(Exception):
    """A group that cannot be served as one stacked launch (members whose
    programs differ beyond their constants, a route without a stacked
    form, a device fault mid-dispatch).  The coalescer retries every
    member as a solo dispatch: a failed group never fails its members."""


class _GroupPending:
    """The shared fetch of one stacked group dispatch: ``fetch()`` waits
    for the group's one copy once, runs its finalize and memoizes.  No
    host fallback here: a member-level fault degrades that member (the
    endpoint's contract), never substitutes one member's answer for
    another's."""

    __slots__ = ("_runner", "_pending", "_mu", "_memo")

    def __init__(self, runner, pending: _Pending):
        self._runner = runner
        self._pending = pending
        self._mu = threading.Lock()
        self._memo = None

    def fetch(self):
        with self._mu:
            if self._memo is None:
                try:
                    self._memo = ("ok", self._runner._finish(self._pending))
                except BaseException as e:  # noqa: BLE001 — memoized
                    self._memo = ("err", e)
            kind, val = self._memo
        if kind == "err":
            raise val
        return val


class _BatchedSelectionGroup:
    """N per-request resolutions over one stacked selection dispatch.

    ``member_result(i)`` joins the shared fetch (one copy for the whole
    group), takes lane i's count and packed mask, seeds that member's
    selectivity EWMA and runs the member's own host gather, so the
    members' gathers run on their own completion workers while the device
    round trip is paid once."""

    __slots__ = ("_runner", "_gp", "_members")

    def __init__(self, runner, gp: _GroupPending, members):
        self._runner = runner
        self._gp = gp
        self._members = members

    def member_result(self, i: int):
        counts, packed, n, plans = self._gp.fetch()
        dag, storage = self._members[i]
        return self._runner._stacked_member(dag, plans[i], storage,
                                            int(counts[i]), packed[i], n)
