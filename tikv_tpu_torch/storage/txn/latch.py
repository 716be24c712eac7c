"""Key latches — per-key FIFO serialization of conflicting commands.

A copy of the JAX package's ``storage/txn/latch.py``.

Reference: src/storage/txn/latch.rs — keys hash to slots; a command
acquires all its slots or queues behind the current holders; release
wakes the next waiter in FIFO order.  Lock-free in the reference; here a
condition variable guards the slot table (the scheduler pool is small).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterable


class Latches:
    def __init__(self, size: int = 256):
        assert size and (size & (size - 1)) == 0, "size must be a power of 2"
        self._mask = size - 1
        self._slots: list[deque] = [deque() for _ in range(size)]
        self._cv = threading.Condition()
        self._next_cid = 0

    def gen_cid(self) -> int:
        with self._cv:
            self._next_cid += 1
            return self._next_cid

    def _slot_ids(self, keys: Iterable[bytes]) -> list[int]:
        return sorted({hash(k) & self._mask for k in keys})

    def acquire(self, cid: int, keys: Iterable[bytes]) -> list[int]:
        """Block until ``cid`` holds every slot for ``keys`` (FIFO per
        slot).  Returns the slot list for release()."""
        slots = self._slot_ids(keys)
        with self._cv:
            for s in slots:
                self._slots[s].append(cid)
            while not all(self._slots[s][0] == cid for s in slots):
                self._cv.wait()
        return slots

    def release(self, cid: int, slots: list[int]) -> None:
        with self._cv:
            for s in slots:
                assert self._slots[s][0] == cid, "released out of order"
                self._slots[s].popleft()
            self._cv.notify_all()
