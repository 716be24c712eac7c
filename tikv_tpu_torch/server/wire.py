"""Wire serialization for the RPC surface.

A trimmed copy of the JAX package's ``server/wire.py``: the msgpack body
codec (``pack``, ``unpack``, ``pack_response``), the region and peer
encoders, ``enc_error`` with the reference's error kinds and stable codes,
and ``enc_rows``.  The DAG and plan codecs are the port's
``copr/wire.py``, re-exported here.  The raft message codec rides the
store-to-store transport, which a single in-process store has no use for.

Reference: the kvproto/tipb protobufs; the schema mirrors kvproto field
for field, with msgpack-encoded message bodies.
"""

from __future__ import annotations

from typing import Any

import msgpack

from ..copr.wire import (  # noqa: F401 — the DAG and plan codecs
    dec_dag,
    dec_expr,
    dec_field_type,
    dec_plan,
    enc_dag,
    enc_expr,
    enc_field_type,
    enc_plan,
)
from ..raftstore.metapb import Peer, Region

# the ExtType code of a DECIMAL datum (its ``format(d, "f")`` text), the
# row codec's scheme
_EXT_DECIMAL = 1


def _default(obj):
    import decimal
    if isinstance(obj, decimal.Decimal):
        return msgpack.ExtType(_EXT_DECIMAL, format(obj, "f").encode())
    raise TypeError(f"unencodable datum: {type(obj)}")


def _ext_hook(code, data):
    if code == _EXT_DECIMAL:
        from ..datatype.mydecimal import CTX
        return CTX.create_decimal(data.decode())
    return msgpack.ExtType(code, data)


def pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True, default=_default)


def unpack(raw: bytes) -> Any:
    return msgpack.unpackb(raw, raw=False, ext_hook=_ext_hook)


def pack_response(obj: Any) -> bytes:
    """Response serializer for handlers that may return PRE-PACKED
    bytes — bytes pass through, dicts take the normal ``pack``."""
    if type(obj) is bytes:
        return obj
    return pack(obj)


# -- metapb --

def enc_peer(p: Peer) -> dict:
    return {"id": p.id, "store_id": p.store_id, "learner": p.is_learner}


def enc_region(r: Region) -> dict:
    return {"id": r.id, "start": r.start_key, "end": r.end_key,
            "conf_ver": r.epoch.conf_ver, "version": r.epoch.version,
            "peers": [enc_peer(p) for p in r.peers]}


# -- errors (kvrpcpb errorpb analog: stable identities over the wire) --

def enc_error(e: Exception) -> dict:
    d = _enc_error_body(e)
    from ..utils.error_code import code_of
    d.setdefault("code", code_of(e))    # stable KV:Subsystem:Name code
    return d


def _enc_error_body(e: Exception) -> dict:
    from ..raftstore.metapb import EpochNotMatch, NotLeaderError
    from ..storage.mvcc.errors import (
        AlreadyExist, Committed, KeyIsLocked, TxnLockNotFound, WriteConflict,
    )
    if isinstance(e, KeyIsLocked):
        lk = e.lock
        return {"kind": "key_is_locked", "key": e.key,
                "lock": {"primary": lk.primary, "start_ts": lk.start_ts,
                         "ttl": lk.ttl,
                         "min_commit_ts": lk.min_commit_ts}}
    if isinstance(e, WriteConflict):
        return {"kind": "write_conflict", "key": e.key,
                "start_ts": e.start_ts,
                "conflict_start_ts": e.conflict_start_ts,
                "conflict_commit_ts": e.conflict_commit_ts,
                "reason": e.reason}
    if isinstance(e, TxnLockNotFound):
        return {"kind": "txn_lock_not_found", "key": e.key,
                "start_ts": e.start_ts}
    if isinstance(e, Committed):
        return {"kind": "committed", "key": e.key,
                "start_ts": e.start_ts, "commit_ts": e.commit_ts}
    if isinstance(e, AlreadyExist):
        return {"kind": "already_exist", "key": e.key}
    if isinstance(e, NotLeaderError):
        return {"kind": "not_leader", "region_id": e.region_id,
                "leader": enc_peer(e.leader) if e.leader else None}
    if isinstance(e, EpochNotMatch):
        return {"kind": "epoch_not_match",
                "current": enc_region(e.current)}
    from ..raftstore.metapb import RegionMerging, RegionNotFound
    if isinstance(e, RegionMerging):
        return {"kind": "region_merging", "region_id": e.region_id}
    if isinstance(e, RegionNotFound):
        # a balanced-away or merged region: the client must re-route
        return {"kind": "region_not_found", "region_id": e.region_id}
    from .read_pool import ServerIsBusy
    if isinstance(e, ServerIsBusy):
        out = {"kind": "server_is_busy", "reason": e.reason}
        if getattr(e, "retry_after_ms", 0):
            # queue-depth-derived backoff hint: clients sleep THIS
            # long instead of blind exponential jitter
            out["retry_after_ms"] = e.retry_after_ms
        return out
    from ..utils.deadline import DeadlineExceeded
    if isinstance(e, DeadlineExceeded):
        return {"kind": "deadline_exceeded", "stage": e.stage,
                "overrun_ms": round(e.overrun_ms, 3)}
    from ..raftstore.metapb import DataIsNotReady
    if isinstance(e, DataIsNotReady):
        return {"kind": "data_is_not_ready", "region_id": e.region_id,
                "safe_ts": e.safe_ts, "read_ts": e.read_ts}
    return {"kind": "other", "message": str(e)}


def enc_rows(rows) -> list:
    """Result rows → wire (floats/ints/bytes/None pass through msgpack)."""
    return [list(r) for r in rows]
