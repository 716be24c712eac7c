"""Storage — the transactional KV facade.

A copy of the JAX package's ``storage/__init__.py``.

Reference: src/storage/mod.rs:188 ``Storage<E, L, F>``: transactional
reads (get :597 / batch_get :1166 / scan :1360), txn command scheduling
(sched_txn_command :1702), and the raw KV API (:1860-2915).  Reads take
an engine snapshot and resolve Percolator state through MvccReader; writes
go through the latch-serialized TxnScheduler.

API versions (components/api_version/src/lib.rs ApiV1/ApiV1Ttl/ApiV2):
- v1: raw keys are plain (``r`` prefix), last-write-wins, no TTL.
- v2: raw keys are memcomparable-encoded with a causal-ts version suffix
  (same ``append_ts`` layout as txn MVCC keys) so raw writes are
  MVCC-versioned — the property CDC-for-RawKV depends on — and values
  carry a flags byte with optional TTL expiry and tombstones
  (api_version/src/api_v2.rs RawValue encoding).  Write timestamps come
  from a ``causal_ts`` provider (tikv_tpu/causal_ts.py).
"""

from __future__ import annotations

import struct
import time
from typing import Optional, Sequence

from ..kv.engine import Engine, LocalEngine, SnapContext, WriteData
from .mvcc.reader import MvccReader
from .txn.commands import Command
from .txn.scheduler import TxnScheduler
from ..engine.traits import CF_DEFAULT

RAW_PREFIX = b"r"       # raw and txn keyspaces must not overlap (ApiV2
                        # keyspace prefixes, api_version/src/keyspace.rs)

# ApiV2 raw value flags byte
_V2_TOMBSTONE = 0x01
_V2_HAS_TTL = 0x02


class _CounterTs:
    """Process-local fallback causal-ts source (tests / single node).
    Seeded above any ts already persisted in the raw keyspace, so a
    restart over a durable engine cannot hand out timestamps below
    existing versions (which !ts ordering would hide forever)."""

    def __init__(self, start: int = 0):
        self._t = start

    def get_ts(self) -> int:
        self._t += 1
        return self._t

    def flush(self) -> None:
        pass


class Storage:
    def __init__(self, engine: Optional[Engine] = None,
                 lock_manager=None, api_version: int = 1,
                 causal_ts=None):
        from .concurrency_manager import ConcurrencyManager
        import threading
        assert api_version in (1, 2), api_version
        self._engine = engine if engine is not None else LocalEngine()
        self.api_version = api_version
        if causal_ts is not None:
            self.causal_ts = causal_ts
        else:
            seed = self._max_raw_ts() if api_version == 2 else 0
            self.causal_ts = _CounterTs(seed)
        # serializes raw_compare_and_swap (reference runs atomic raw
        # commands through scheduler latches, commands/atomic_store.rs;
        # one mutex is the single-node equivalent)
        self._raw_cas_lock = threading.Lock()
        self.concurrency_manager = ConcurrencyManager()
        self._sched = TxnScheduler(
            self._engine, concurrency_manager=self.concurrency_manager,
            lock_manager=lock_manager)

    def _max_raw_ts(self) -> int:
        """Largest version ts persisted in the raw keyspace (one startup
        scan; 0 when empty)."""
        from .txn_types import split_ts
        snap = self._engine.snapshot(SnapContext())
        it = snap.iterator_cf(CF_DEFAULT, RAW_PREFIX,
                              bytes([RAW_PREFIX[0] + 1]))
        best = 0
        ok = it.seek_to_first()
        while ok:
            key = it.key()
            if len(key) > 8:
                _, ts = split_ts(key)
                best = max(best, ts)
            ok = it.next()
        return best

    @property
    def engine(self) -> Engine:
        return self._engine

    @property
    def lock_manager(self):
        return self._sched.lock_manager

    # -- transactional reads (mod.rs:597,1166,1360) --
    #
    # every read bumps the concurrency manager's max_ts BEFORE checking
    # locks, then checks the in-memory table — the two halves of the
    # async-commit read protocol (mod.rs:626 + concurrency_manager)

    def get(self, key: bytes, read_ts: int,
            bypass_locks=(), replica_read: bool = False,
            stale_read: bool = False) -> Optional[bytes]:
        from .txn_types import encode_key
        cm = self.concurrency_manager
        cm.update_max_ts(read_ts)
        cm.read_key_check(key, read_ts, bypass_locks)
        reader = MvccReader(self._engine.snapshot(
            SnapContext(read_ts=read_ts, key_hint=encode_key(key),
                        replica_read=replica_read,
                        stale_read=stale_read)))
        return reader.get(key, read_ts, bypass_locks)

    def batch_get(self, keys: Sequence[bytes], read_ts: int,
                  bypass_locks=()) -> list:
        from .txn_types import encode_key
        cm = self.concurrency_manager
        cm.update_max_ts(read_ts)
        out = []
        for k in keys:
            cm.read_key_check(k, read_ts, bypass_locks)
            reader = MvccReader(self._engine.snapshot(
                SnapContext(read_ts=read_ts, key_hint=encode_key(k))))
            out.append((k, reader.get(k, read_ts, bypass_locks)))
        return out

    def scan(self, start: Optional[bytes], end: Optional[bytes], limit: int,
             read_ts: int, desc: bool = False, bypass_locks=()) -> list:
        from .txn_types import encode_key
        cm = self.concurrency_manager
        cm.update_max_ts(read_ts)
        cm.read_range_check(start, end, read_ts, bypass_locks)
        hint = encode_key(start) if start else b""
        reader = MvccReader(self._engine.snapshot(
            SnapContext(read_ts=read_ts, key_hint=hint)))
        return reader.scan(start, end, limit, read_ts, desc, bypass_locks)

    # -- txn writes (mod.rs:1702) --

    def sched_txn_command(self, cmd: Command):
        return self._sched.run(cmd)

    # -- raw KV (mod.rs:1860-2915; raw/ module) --

    def _raw_key(self, key: bytes) -> bytes:
        if self.api_version == 2:
            from ..codec.number import encode_bytes_memcomparable
            return RAW_PREFIX + encode_bytes_memcomparable(key)
        return RAW_PREFIX + key

    @staticmethod
    def _v2_value(value: bytes, ttl: Optional[int]) -> bytes:
        if ttl is None:
            return bytes([0]) + value
        expire = int(time.time()) + ttl
        return bytes([_V2_HAS_TTL]) + struct.pack(">Q", expire) + value

    @staticmethod
    def _v2_decode(raw: bytes):
        """→ (value | None, expire_ts | None); None value = dead
        (tombstone or expired)."""
        flags = raw[0]
        if flags & _V2_TOMBSTONE:
            return None, None
        if flags & _V2_HAS_TTL:
            (expire,) = struct.unpack_from(">Q", raw, 1)
            if expire <= int(time.time()):
                return None, expire
            return raw[9:], expire
        return raw[1:], None

    def raw_put(self, key: bytes, value: bytes,
                ttl: Optional[int] = None) -> None:
        self.raw_batch_put([(key, value)], ttl=ttl)

    def raw_batch_put(self, pairs: Sequence[tuple],
                      ttl: Optional[int] = None) -> None:
        if ttl is not None and self.api_version != 2:
            # reference: ApiV1 returns TtlNotEnabled rather than
            # silently storing a key that will never expire
            raise ValueError("TTL requires api_version=2")
        if self.api_version == 2:
            from .txn_types import append_ts
            mods = []
            for k, v in pairs:
                ts = self.causal_ts.get_ts()
                mods.append(("put", CF_DEFAULT,
                             append_ts(self._raw_key(k), ts),
                             self._v2_value(v, ttl)))
        else:
            mods = [("put", CF_DEFAULT, self._raw_key(k), v)
                    for k, v in pairs]
        self._engine.write(SnapContext(), WriteData(mods))

    def _v2_newest(self, snap, enc: bytes):
        """Newest (value, expire) of one ENCODED key, or (None, None);
        smallest ts suffix sorts first — txn_types.append_ts layout."""
        it = snap.iterator_cf(CF_DEFAULT, enc, enc + b"\xff" * 9)
        if not it.seek_to_first():
            return None, None
        return self._v2_decode(it.value())

    def _v2_latest(self, snap, key: bytes):
        return self._v2_newest(snap, self._raw_key(key))[0]

    def raw_get(self, key: bytes) -> Optional[bytes]:
        snap = self._engine.snapshot(SnapContext())
        if self.api_version == 2:
            return self._v2_latest(snap, key)
        return snap.get_value_cf(CF_DEFAULT, self._raw_key(key))

    def raw_get_key_ttl(self, key: bytes) -> Optional[int]:
        """Remaining TTL seconds: None = key absent; 0 = no TTL set
        (raw_get_key_ttl in mod.rs — ApiV1Ttl/ApiV2 only)."""
        if self.api_version != 2:
            raise ValueError("TTL requires api_version=2")
        snap = self._engine.snapshot(SnapContext())
        value, expire = self._v2_newest(snap, self._raw_key(key))
        if value is None:
            return None
        if expire is None:
            return 0
        return max(0, expire - int(time.time()))

    def raw_compare_and_swap(self, key: bytes, previous: Optional[bytes],
                             value: bytes,
                             ttl: Optional[int] = None) -> tuple:
        """→ (succeeded, actual_previous).  Reference:
        RawCompareAndSwap command (storage/txn/commands/atomic_store.rs)
        serialized through scheduler latches; here one mutex serializes
        all CAS ops (single node — contention is per-facade)."""
        with self._raw_cas_lock:
            cur = self.raw_get(key)
            if cur != previous:
                return False, cur
            self.raw_put(key, value, ttl=ttl)
            return True, cur

    def raw_batch_get(self, keys: Sequence[bytes]) -> list:
        snap = self._engine.snapshot(SnapContext())
        if self.api_version == 2:
            return [(k, self._v2_latest(snap, k)) for k in keys]
        return [(k, snap.get_value_cf(CF_DEFAULT, self._raw_key(k)))
                for k in keys]

    def raw_delete(self, key: bytes) -> None:
        if self.api_version == 2:
            # tombstone version — deletes must be MVCC events too (CDC
            # for RawKV observes them like any other write)
            from .txn_types import append_ts
            ts = self.causal_ts.get_ts()
            self._engine.write(SnapContext(), WriteData(
                [("put", CF_DEFAULT, append_ts(self._raw_key(key), ts),
                  bytes([_V2_TOMBSTONE]))]))
            return
        self._engine.write(SnapContext(), WriteData(
            [("del", CF_DEFAULT, self._raw_key(key), None)]))

    def raw_delete_range(self, start: bytes, end: bytes) -> None:
        """Physically removes every version in range (unsafe destroy
        semantics — mod.rs raw_delete_range)."""
        snap = self._engine.snapshot(SnapContext())
        it = snap.iterator_cf(CF_DEFAULT, self._raw_key(start),
                              self._raw_key(end))
        mods = []
        ok = it.seek_to_first()
        while ok:
            mods.append(("del", CF_DEFAULT, it.key(), None))
            ok = it.next()
        if mods:
            self._engine.write(SnapContext(), WriteData(mods))

    def raw_scan(self, start: bytes, end: Optional[bytes], limit: int,
                 desc: bool = False) -> list:
        snap = self._engine.snapshot(SnapContext())
        # end=None → everything in the raw keyspace: bound by the next
        # one-byte prefix (raw keys all start with RAW_PREFIX)
        upper = self._raw_key(end) if end is not None else \
            bytes([RAW_PREFIX[0] + 1])
        it = snap.iterator_cf(CF_DEFAULT, self._raw_key(start), upper)
        if self.api_version != 2:
            out = []
            ok = it.seek_to_last() if desc else it.seek_to_first()
            while ok and len(out) < limit:
                out.append((it.key()[len(RAW_PREFIX):], it.value()))
                ok = it.prev() if desc else it.next()
            return out
        # v2: newest live version per user key.  Ascending, the first
        # version seen for a key is the newest (ts suffix sorts newest
        # first); descending, the LAST version seen is — so collect and
        # resolve per key, bounded by ``limit`` live keys.
        from ..codec.number import decode_bytes_memcomparable
        from .txn_types import split_ts
        out = []
        if not desc:
            # ascending: the FIRST version seen for each key is its
            # newest (ts suffix sorts newest first)
            prev_enc = None
            ok = it.seek_to_first()
            while ok and len(out) < limit:
                enc, _ts = split_ts(it.key())
                if enc != prev_enc:
                    prev_enc = enc
                    value = self._v2_decode(it.value())[0]
                    if value is not None:
                        user, _ = decode_bytes_memcomparable(
                            enc, len(RAW_PREFIX))
                        out.append((user, value))
                ok = it.next()
            return out
        # descending: versions arrive oldest→newest within each key, so
        # the LAST version seen before the key changes is the newest —
        # emit at each key boundary from the one ongoing iterator (no
        # per-key point seeks)
        cur_enc = None
        cur_raw = None

        def emit():
            if cur_enc is None:
                return
            value = self._v2_decode(cur_raw)[0]
            if value is not None:
                user, _ = decode_bytes_memcomparable(cur_enc,
                                                     len(RAW_PREFIX))
                out.append((user, value))

        ok = it.seek_to_last()
        while ok and len(out) < limit:
            enc, _ts = split_ts(it.key())
            if enc != cur_enc:
                emit()
                if len(out) >= limit:
                    break
                cur_enc = enc
            cur_raw = it.value()
            ok = it.prev()
        if len(out) < limit:
            emit()
        return out

