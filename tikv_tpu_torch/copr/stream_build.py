"""The streaming cold build: SST ingest → version-plane parse → the card,
overlapped with the bulk load.

A copy of the JAX package's ``copr/stream_build.py``.  A
:class:`ColdStreamBuilder` registered on the raftstore's
``CoprocessorHost`` observes every applied ingest entry and hands its blobs
to one worker thread, which for each chunk

- takes the CF_WRITE group of the v2 container (the apply thread's decode
  of the same blob, through the ingest-parse memo, or a fresh one): the
  exact slice ``snap.range_cf`` returns at query time;
- parses it into version planes in discovery mode (the native
  ``mvcc_parse_planes`` with no schema, the GIL released in its core
  loop), and
- on a CUDA runner appends the planes to the card
  (``device.mvcc.DeviceVersionPlanes.append``), so chunk k's copy overlaps
  chunk k+1's parse and chunk k+2's ingest.

At the first cold query the device rung of the build ladder
(``copr.region_cache._build_device``) calls :meth:`ColdStreamBuilder.take`:
when the stream still mirrors the snapshot (the same ``data_index``,
version count, and first and last raw key — every streamed key is in the
snapshot and nothing changed since, so the sets are equal), the parse and
the planes' upload are done, and the build is the host mirror and one
``mvcc_resolve`` at the mint.

The stream is an exact replica of the ingested CF_WRITE range or it is not
used: a write that is not an ingest, a snapshot apply, an epoch change or
a destroyed peer drops the region's stream, and ``take`` is one-shot and
checks the live snapshot.  A stream that does not match is a miss, and the
build parses.  A failure of the worker (a device append or copy, the
native module) is not a miss: ``take`` raises it to the cold build.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..engine.traits import CF_WRITE
from ..raftstore.observer import Observer


class _Stream:
    __slots__ = ("index", "chunks", "dev", "n_ver", "n_keys", "table_id",
                 "first_raw", "last_raw", "nbytes")

    def __init__(self):
        self.index = None           # the last ingest entry's raft index
        self.chunks: list = []      # WritePlanes per chunk (host)
        self.dev = None             # DeviceVersionPlanes or None
        self.n_ver = 0
        self.n_keys = 0
        self.table_id = None
        self.first_raw = None       # the first and last raw CF_WRITE keys
        self.last_raw = None        # (the coverage fence)
        self.nbytes = 0             # host plane bytes


class ColdStreamBuilder(Observer):
    """The background ingest-chunk parser and device-plane uploader.

    ``resolver``: the runner's ``DeviceMvccResolver``, or None for a
    host-only deployment (the stream still parses; it skips the device
    leg, as it does off a CUDA card: ``resolver.h2d_profitable()``).
    ``max_bytes`` bounds the host plane bytes kept a region (the device
    leg is shed first, at half of it; 0: unbounded); at most
    ``max_regions`` regions stream at once; a worker more than ``max_lag``
    chunks behind a region's ingest drops its stream."""

    def __init__(self, resolver=None, max_bytes: int = 1 << 30,
                 max_regions: int = 4, max_lag: int = 6):
        from ..sst_importer import enable_ingest_parse_memo
        enable_ingest_parse_memo(True)
        self._resolver = resolver
        self._max_bytes = max_bytes
        self._max_regions = max_regions
        self._max_lag = max_lag
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._states: dict = {}
        self._queue: deque = deque()
        self._inflight: dict = {}       # region -> queued items
        # the worker's seconds a chunk (EWMA): take()'s wait budget is what
        # draining the backlog should cost
        self._chunk_s = 0.05
        # regions whose stream a take() popped while chunks were queued:
        # the worker abandons their blobs
        self._doomed: set = set()
        # region -> the exception a worker pass raised, for its next take
        self._errors: dict = {}
        self._worker: Optional[threading.Thread] = None
        self._busy = False          # the worker holds an item
        self._stopped = False
        self.chunks_parsed = 0
        self.chunks_rejected = 0
        self.regions_dropped = 0
        self.takes = 0
        self.take_misses = 0
        self.h2d_bytes = 0
        self.failures = 0

    # -- observer events (the apply path: enqueue only, never block) --

    def on_apply_write(self, region_id: int, index: int, ops) -> None:
        from ..sst_importer import pop_ingest_parse
        blobs = []
        for op in ops:
            if getattr(op, "op", None) == "ingest":
                blobs.append(op.value)
            else:
                blobs = None
                break
        with self._mu:
            if self._stopped:
                return
            if blobs:
                if region_id not in self._states and \
                        len(self._states) >= self._max_regions and \
                        self._inflight.get(region_id, 0) == 0:
                    return      # at capacity: no new stream
                if self._inflight.get(region_id, 0) >= self._max_lag:
                    # the worker could not be ready for the first query
                    self._enqueue_locked(("drop", region_id, None, None))
                    return
                # the apply thread's own decode of each blob travels with
                # the entry: the worker never re-unpacks it
                self._enqueue_locked(
                    ("ingest", region_id, index,
                     tuple((b, pop_ingest_parse(b)) for b in blobs)))
                self._inflight[region_id] = \
                    self._inflight.get(region_id, 0) + 1
            elif region_id in self._states or \
                    self._inflight.get(region_id, 0):
                # a plain data write: the stream no longer mirrors the
                # region
                self._enqueue_locked(("drop", region_id, index, None))

    def on_data_replaced(self, region_id: int, index: int) -> None:
        self._drop(region_id)

    def on_region_changed(self, region) -> None:
        self._drop(region.id)

    def on_peer_destroyed(self, region_id: int) -> None:
        self._drop(region_id)

    def _drop(self, region_id: int) -> None:
        with self._mu:
            if region_id in self._states or \
                    self._inflight.get(region_id, 0):
                self._enqueue_locked(("drop", region_id, None, None))

    def _enqueue_locked(self, item) -> None:
        self._queue.append(item)
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._loop, daemon=True,
                                            name="cold-stream")
            self._worker.start()
        self._cv.notify_all()

    # -- the worker -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._mu:
                while not self._queue and not self._stopped:
                    self._cv.wait(timeout=1.0)
                if self._stopped and not self._queue:
                    return
                kind, region_id, index, blobs = self._queue.popleft()
                self._busy = True
            try:
                if kind == "ingest":
                    self._ingest(region_id, index, blobs)
                else:
                    self._drop_now(region_id)
            except Exception as e:      # noqa: BLE001 — raised at take
                self.failures += 1
                self._drop_now(region_id)
                with self._mu:
                    self._errors[region_id] = e
            finally:
                with self._mu:
                    if kind == "ingest":
                        left = self._inflight.get(region_id, 1) - 1
                        if left <= 0:
                            self._inflight.pop(region_id, None)
                            self._doomed.discard(region_id)
                        else:
                            self._inflight[region_id] = left
                    self._busy = False
                    self._cv.notify_all()

    def _drop_now(self, region_id: int) -> None:
        with self._mu:
            st = self._states.pop(region_id, None)
        if st is not None:
            self.regions_dropped += 1

    def _reject(self, region_id: int) -> None:
        self.chunks_rejected += 1
        self._drop_now(region_id)

    def _ingest(self, region_id: int, index: int, blobs) -> None:
        from ..device.mvcc import DeviceVersionPlanes, parse_write_planes
        from ..sst_importer import read_sst_cf
        for blob, groups in blobs:
            with self._mu:
                if region_id in self._doomed:
                    return      # the consumer already gave up on it
            t0 = time.monotonic()
            if groups is None:
                # a memo miss: the apply path admitted this exact blob, so
                # its order needs no second check
                groups = read_sst_cf(blob, validate=False)
            got = groups.get(CF_WRITE)
            if got is None or not got[0]:
                continue        # a CF_DEFAULT- or CF_LOCK-only blob
            keys, vals = got
            with self._mu:
                st = self._states.get(region_id)
            if st is None:
                st = _Stream()
            elif st.last_raw is not None and (
                    keys[0] <= st.last_raw or
                    bytes(keys[0])[:-8] == st.last_raw[:-8]):
                # an out-of-order or overlapping run, or versions of one
                # user key straddling the chunk boundary (raw keys embed
                # the inverted commit_ts, so an older version of the last
                # key still sorts after it, and concatenating would make
                # it a second segment): coverage is broken
                self._reject(region_id)
                return
            planes = parse_write_planes(keys, vals, 0, None,
                                        release_gil=True)
            if planes is None or (st.table_id is not None and
                                  planes.table_id != st.table_id):
                self._reject(region_id)
                return
            if st.dev is None and st.n_ver == 0 and \
                    self._resolver is not None and \
                    self._resolver.available() and \
                    self._resolver.h2d_profitable():
                st.dev = DeviceVersionPlanes(self._resolver.device)
            if st.dev is not None:
                st.dev.append(planes)       # a failure raises at take
                self.h2d_bytes += planes.nbytes()
            st.chunks.append(planes)
            st.n_ver += planes.n_ver
            st.n_keys += planes.n_keys
            st.nbytes += planes.nbytes()
            st.table_id = planes.table_id
            if st.first_raw is None:
                st.first_raw = bytes(keys[0])
            st.last_raw = bytes(keys[-1])
            st.index = index
            self.chunks_parsed += 1
            self._chunk_s += 0.3 * ((time.monotonic() - t0) - self._chunk_s)
            if self._max_bytes:
                if st.dev is not None and st.dev.nbytes > self._max_bytes // 2:
                    st.dev = None       # shed the device leg first
                if st.nbytes > self._max_bytes:
                    self._drop_now(region_id)
                    return
            with self._mu:
                if region_id in self._doomed:
                    return      # take() popped the stream mid-entry
                self._states[region_id] = st

    # -- the consumer (the cold build) ----------------------------------

    def take(self, region_id: int, table_id: int, data_index: int,
             n_ver: int, first_key: bytes, last_key: bytes):
        """Pop the region's planes iff they exactly mirror the snapshot
        being built → (WritePlanes, DeviceVersionPlanes or None), or None.

        Waits for queued chunks for what draining them should cost (the
        backlog × the worker's seconds a chunk × 1.5, at most 3 s, checked
        against the clock at every wake-up); past it, a miss beats
        stalling.  Raises what a worker pass over the region raised."""
        from ..device.mvcc import concat_planes
        t0 = time.monotonic()
        hard_end = t0 + 3.0
        with self._mu:
            if region_id not in self._states and \
                    region_id not in self._errors and \
                    not self._inflight.get(region_id, 0):
                return None     # never streamed: cold, not a miss
            backlog = self._inflight.get(region_id, 0)
            end = min(hard_end, t0 + 0.1 + backlog * self._chunk_s * 1.5)
            while self._inflight.get(region_id, 0) and not self._stopped:
                left = end - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=min(0.25, left))
            err = self._errors.pop(region_id, None)
            st = self._states.pop(region_id, None)
            if self._inflight.get(region_id, 0):
                # chunks still queued: the worker abandons them
                self._doomed.add(region_id)
        if err is not None:
            raise RuntimeError(f"the cold stream of region {region_id} "
                               f"failed") from err
        if st is None or st.table_id != table_id or \
                st.index != data_index or st.n_ver != n_ver or \
                st.first_raw != first_key or st.last_raw != last_key:
            self.take_misses += 1
            return None
        self.takes += 1
        return concat_planes(st.chunks), st.dev

    def wait_idle(self, timeout: float) -> bool:
        """Wait until the worker has nothing queued or in hand (→ True), or
        ``timeout`` s."""
        end = time.monotonic() + timeout
        with self._mu:
            while (self._queue or self._busy) and not self._stopped:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(0.25, left))
        return True

    # -- lifecycle and observability ------------------------------------

    def stop(self) -> None:
        from ..sst_importer import enable_ingest_parse_memo
        with self._mu:
            if self._stopped:
                return
            enable_ingest_parse_memo(False)
            self._stopped = True
            self._queue.clear()
            self._inflight.clear()
            self._states.clear()
            self._cv.notify_all()
        w = self._worker
        if w is not None:
            w.join(timeout=5)

    def stats(self) -> dict:
        with self._mu:
            regions = {rid: {"n_ver": st.n_ver, "n_keys": st.n_keys,
                             "chunks": len(st.chunks),
                             "device": st.dev is not None,
                             "host_mb": round(st.nbytes / (1 << 20), 2)}
                       for rid, st in self._states.items()}
        return {"chunks_parsed": self.chunks_parsed,
                "chunks_rejected": self.chunks_rejected,
                "regions_dropped": self.regions_dropped,
                "takes": self.takes, "take_misses": self.take_misses,
                "h2d_bytes": self.h2d_bytes, "failures": self.failures,
                "regions": regions}
