"""Raft command payloads — what gets proposed into the raft log — and the
data mutation of a raft command, as the apply path hands it to observers.

A trimmed copy of the JAX package's ``raftstore/cmd.py`` (reference: the
kvproto ``raft_cmdpb`` Put/Delete/DeleteRange/IngestSst requests and the
AdminCmdType requests): ``WriteOp``, ``AdminCmd`` and ``RaftCmd`` in the
same tagged binary form, and the change-peer-v2 payload codec
(``encode_change_peer_v2``).  ``exec_write_ops`` applies an
entry's ops to an engine write batch, as the apply path's data arm does
(the JAX package's ``raftstore/peer.py`` ``_exec_write``); ``write_ops``
turns a write batch back into the ops of the applied entry, the way the
apply path hands them to ``CoprocessorHost.notify_apply_write``: user-level
keys, without the engine's data prefix.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

from ..codec.keys import DATA_PREFIX, data_key
from .metapb import Peer, RegionEpoch


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def _unpack_bytes(buf: bytes, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from(">I", buf, off)
    off += 4
    return buf[off:off + n], off + n


@dataclass(frozen=True)
class WriteOp:
    """One KV mutation (CmdType::Put/Delete/DeleteRange), or an SST ingest
    (op ``ingest``, the v2 SST blob as its value)."""

    op: str         # put | delete | delete_range | ingest
    cf: str
    key: bytes
    value: bytes = b""

    def to_bytes(self) -> bytes:
        return (_pack_bytes(self.op.encode()) + _pack_bytes(self.cf.encode())
                + _pack_bytes(self.key) + _pack_bytes(self.value))

    @staticmethod
    def from_bytes(buf: bytes, off: int) -> tuple["WriteOp", int]:
        op, off = _unpack_bytes(buf, off)
        cf, off = _unpack_bytes(buf, off)
        key, off = _unpack_bytes(buf, off)
        value, off = _unpack_bytes(buf, off)
        return WriteOp(op.decode(), cf.decode(), key, value), off


@dataclass(frozen=True)
class AdminCmd:
    """Admin command.  kind: split | change_peer | change_peer_v2 |
    compact_log | prepare_merge | commit_merge | rollback_merge |
    compute_hash | verify_hash.

    split: split_key + new_region_id + new_peer_ids
    change_peer: change_type(add|remove|add_learner) + peer
    compact_log: compact_index
    prepare_merge: target region id rides new_region_id
    commit_merge: extra = encoded source Region, merge_index = the
        source's prepare-merge apply index (fsm/apply.rs merge cmds)
    rollback_merge: merge_index = the prepare index being rolled back
    change_peer_v2: extra = ``encode_change_peer_v2`` payload
    compute_hash: extra = >Q the leader's GC safe point
    verify_hash: extra = >QI the compute index and the leader's digest
    """

    kind: str
    split_key: bytes = b""
    new_region_id: int = 0
    new_peer_ids: tuple = ()
    change_type: str = ""
    peer: Optional[Peer] = None
    compact_index: int = 0
    merge_index: int = 0
    extra: bytes = b""          # commit_merge: encoded source region

    def to_bytes(self) -> bytes:
        parts = [_pack_bytes(self.kind.encode()), _pack_bytes(self.split_key),
                 struct.pack(">QQ", self.new_region_id, self.compact_index),
                 struct.pack(">I", len(self.new_peer_ids))]
        parts += [struct.pack(">Q", p) for p in self.new_peer_ids]
        parts.append(_pack_bytes(self.change_type.encode()))
        if self.peer is not None:
            parts.append(struct.pack(">BQQB", 1, self.peer.id,
                                     self.peer.store_id,
                                     int(self.peer.is_learner)))
        else:
            parts.append(struct.pack(">B", 0))
        # trailing fields: absent in pre-merge logs, decoder tolerates
        parts.append(struct.pack(">Q", self.merge_index))
        parts.append(_pack_bytes(self.extra))
        return b"".join(parts)

    @staticmethod
    def from_bytes(buf: bytes, off: int) -> tuple["AdminCmd", int]:
        kind, off = _unpack_bytes(buf, off)
        split_key, off = _unpack_bytes(buf, off)
        new_region_id, compact_index = struct.unpack_from(">QQ", buf, off)
        off += 16
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        ids = []
        for _ in range(n):
            (pid,) = struct.unpack_from(">Q", buf, off)
            ids.append(pid)
            off += 8
        change_type, off = _unpack_bytes(buf, off)
        (has_peer,) = struct.unpack_from(">B", buf, off)
        off += 1
        peer = None
        if has_peer:
            pid, sid, learner = struct.unpack_from(">QQB", buf, off)
            off += 17
            peer = Peer(pid, sid, bool(learner))
        merge_index = 0
        extra = b""
        if off + 8 <= len(buf):     # logs from before the merge fields
            (merge_index,) = struct.unpack_from(">Q", buf, off)
            off += 8
            extra, off = _unpack_bytes(buf, off)
        return AdminCmd(kind.decode(), split_key, new_region_id, tuple(ids),
                        change_type.decode(), peer, compact_index,
                        merge_index, extra), off


def encode_change_peer_v2(changes=(), leave: bool = False,
                          target=None) -> bytes:
    """The ONE encoder for change_peer_v2 admin payloads: ``changes`` =
    [(type_str, Peer)], ``target`` = final peer list for LEAVE."""
    import msgpack
    return msgpack.packb({
        "changes": [{"t": t, "peer": {"id": p.id, "store_id": p.store_id,
                                      "learner": p.is_learner}}
                    for t, p in changes],
        "leave": leave,
        "target": [{"id": p.id, "store_id": p.store_id,
                    "learner": p.is_learner} for p in (target or ())],
    }, use_bin_type=True)


def decode_change_peer_v2(extra: bytes) -> dict:
    import msgpack
    return msgpack.unpackb(extra, raw=False)


@dataclass(frozen=True)
class RaftCmd:
    """One proposed command: header (routing + epoch check) + payload."""

    region_id: int
    epoch: RegionEpoch
    ops: tuple = ()                    # tuple[WriteOp]
    admin: Optional[AdminCmd] = None

    def to_bytes(self) -> bytes:
        head = struct.pack(">QII", self.region_id, self.epoch.conf_ver,
                           self.epoch.version)
        if self.admin is not None:
            return head + b"A" + self.admin.to_bytes()
        # join, never body += op_bytes: quadratic concat turns a 20k-op
        # batch proposal into seconds of memcpy
        parts = [head, b"W", struct.pack(">I", len(self.ops))]
        parts.extend(op.to_bytes() for op in self.ops)
        return b"".join(parts)

    @staticmethod
    def peek_admin_kind(buf: bytes):
        """Cheap wire peek: the admin kind string, or None for write
        commands — without decoding the payload.  Owns the layout
        knowledge (16-byte header + b"A" tag + length-prefixed kind) so
        callers never hardcode offsets."""
        if buf[16:17] != b"A":
            return None
        kind, _ = _unpack_bytes(buf, 17)
        return kind.decode()

    @staticmethod
    def from_bytes(buf: bytes) -> "RaftCmd":
        region_id, conf_ver, version = struct.unpack_from(">QII", buf, 0)
        off = 16
        tag = buf[off:off + 1]
        off += 1
        epoch = RegionEpoch(conf_ver, version)
        if tag == b"A":
            admin, _ = AdminCmd.from_bytes(buf, off)
            return RaftCmd(region_id, epoch, (), admin)
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        ops = []
        for _ in range(n):
            op, off = WriteOp.from_bytes(buf, off)
            ops.append(op)
        return RaftCmd(region_id, epoch, tuple(ops))


def exec_write_ops(wb, ops) -> None:
    """Apply an entry's data ops to the engine write batch ``wb``: user
    keys gain the data prefix, and an ``ingest`` op bulk-merges each CF
    group of its v2 SST blob as one sorted run (fsm/apply.rs IngestSst),
    its decode kept for the streaming cold build's read of the same blob
    (``memo=True``); a fired ``apply::before_ingest`` failpoint raises
    before the blob is read."""
    for op in ops:
        if op.op == "put":
            wb.put_cf(op.cf, data_key(op.key), op.value)
        elif op.op == "delete":
            wb.delete_cf(op.cf, data_key(op.key))
        elif op.op == "delete_range":
            wb.delete_range_cf(op.cf, data_key(op.key), data_key(op.value))
        elif op.op == "ingest":
            from ..sst_importer import read_sst_cf
            from ..utils.failpoint import fail_point
            if fail_point("apply::before_ingest") is not None:
                raise OSError("the ingest failed before its blob was read "
                              "(apply::before_ingest)")
            for cf, (keys, vals) in read_sst_cf(op.value,
                                                memo=True).items():
                wb.ingest_cf(cf, [data_key(k) for k in keys], vals)
        else:
            raise ValueError(f"write op {op.op!r}")


def _user_key(key: bytes) -> bytes:
    return key[len(DATA_PREFIX):] if key.startswith(DATA_PREFIX) else key


def write_ops(batch) -> list:
    """The ``WriteOp``s of a ``MemoryWriteBatch``'s tuples, in order: a put
    and a delete keep their key without the data prefix, a range delete
    carries its end key as its value, and an ingest becomes one ``ingest``
    op (its rows bypass the observers, as the reference's SST ingest
    does)."""
    out = []
    for t in batch._ops:
        kind, cf = t[0], t[1]
        if kind == "put":
            out.append(WriteOp("put", cf, _user_key(t[2]), t[3]))
        elif kind == "del":
            out.append(WriteOp("delete", cf, _user_key(t[2])))
        elif kind == "delr":
            out.append(WriteOp("delete_range", cf, _user_key(t[2]),
                               _user_key(t[3])))
        elif kind == "ingest":
            out.append(WriteOp("ingest", cf, b""))
        else:
            raise ValueError(f"write batch op {kind!r}")
    return out
