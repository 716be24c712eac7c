"""Wire serialization for the RPC surface.

A trimmed copy of the JAX package's ``server/wire.py``: the msgpack body
codec (``pack``, ``unpack``, ``pack_response``), the region and peer
codecs, the raft message codec the store-to-store transport carries
(``enc_raft_msg``/``dec_raft_msg``: entries in the raftstore's own binary
form), ``enc_error`` with the reference's error kinds and stable codes,
``RemoteError`` (a wire error dict surfaced at the client) and
``enc_rows``.  The DAG and plan codecs are the port's ``copr/wire.py``,
re-exported here.

Reference: the kvproto/tipb protobufs; the schema mirrors kvproto field
for field, with msgpack-encoded message bodies.
"""

from __future__ import annotations

from typing import Any, Optional

import msgpack

from ..raft.messages import Message, MsgType, Snapshot, SnapshotMetadata
from ..raftstore.metapb import Peer, Region, RegionEpoch
from ..raftstore.peer_storage import decode_entry, encode_entry

# the DAG and plan codecs, loaded at their first use: a client that sends
# no plan (``ctl``, the raft transport) never imports the expression layer
_COPR_CODECS = ("dec_dag", "dec_expr", "dec_field_type", "dec_plan",
                "enc_dag", "enc_expr", "enc_field_type", "enc_plan")


def __getattr__(name: str):
    if name in _COPR_CODECS:
        from ..copr import wire as copr_wire
        return getattr(copr_wire, name)
    raise AttributeError(name)


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


def dec_peer(d: Optional[dict]) -> Optional[Peer]:
    if d is None:
        return None
    return Peer(d["id"], d["store_id"], d.get("learner", False))


def enc_region(r: Region) -> dict:
    return {"id": r.id, "start": r.start_key, "end": r.end_key,
            "conf_ver": r.epoch.conf_ver, "version": r.epoch.version,
            "peers": [enc_peer(p) for p in r.peers]}


def dec_region(d: dict) -> Region:
    return Region(d["id"], d["start"], d["end"],
                  RegionEpoch(d["conf_ver"], d["version"]),
                  tuple(dec_peer(p) for p in d["peers"]))


# -- raft messages (eraftpb analog) --

def enc_raft_msg(m: Message) -> dict:
    out = {"t": m.msg_type.value, "to": m.to, "frm": m.frm,
           "term": m.term, "lt": m.log_term, "i": m.index,
           "c": m.commit, "rej": m.reject, "hint": m.reject_hint,
           "ctx": m.ctx, "e": [encode_entry(e) for e in m.entries]}
    if m.snapshot is not None:
        meta = m.snapshot.metadata
        out["snap"] = {"i": meta.index, "t": meta.term,
                       "v": list(meta.voters), "l": list(meta.learners),
                       "vo": list(meta.voters_outgoing),
                       "d": m.snapshot.data}
    return out


def dec_raft_msg(d: dict) -> Message:
    snap = None
    if "snap" in d:
        s = d["snap"]
        snap = Snapshot(SnapshotMetadata(s["i"], s["t"], tuple(s["v"]),
                                         tuple(s["l"]),
                                         tuple(s.get("vo", ()))), s["d"])
    return Message(MsgType(d["t"]), to=d["to"], frm=d["frm"],
                   term=d["term"], log_term=d["lt"], index=d["i"],
                   entries=tuple(decode_entry(e) for e in d["e"]),
                   commit=d["c"], reject=d["rej"], reject_hint=d["hint"],
                   ctx=d.get("ctx"), snapshot=snap)


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


class RemoteError(Exception):
    """Client-side surfacing of a wire error dict."""

    def __init__(self, err: dict):
        super().__init__(f"{err.get('kind')}: {err}")
        self.err = err

    @property
    def kind(self) -> str:
        return self.err.get("kind", "other")


def enc_rows(rows) -> list:
    """Result rows → wire (floats/ints/bytes/None pass through msgpack)."""
    return [list(r) for r in rows]
