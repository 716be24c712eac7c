"""The data mutation of a raft command, as the apply path hands it to
observers.

A trimmed copy of the JAX package's ``raftstore/cmd.py`` (reference: the
kvproto ``raft_cmdpb`` Put/Delete/DeleteRange/IngestSst requests): only
``WriteOp`` and its tagged binary form.  ``exec_write_ops`` applies an
entry's ops to an engine write batch, as the apply path's data arm does
(the JAX package's ``raftstore/peer.py`` ``_exec_write``); ``write_ops``
turns a write batch back into the ops of the applied entry, the way the
apply path hands them to ``CoprocessorHost.notify_apply_write``: user-level
keys, without the engine's data prefix.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..codec.keys import DATA_PREFIX, data_key


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
