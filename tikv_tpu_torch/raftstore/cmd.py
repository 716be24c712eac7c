"""The data mutation of a raft command, as the apply path hands it to
observers.

A trimmed copy of the JAX package's ``raftstore/cmd.py`` (reference: the
kvproto ``raft_cmdpb`` Put/Delete/DeleteRange requests): only ``WriteOp``
and its tagged binary form.  ``write_ops`` turns an engine write batch back
into the ops of the applied entry, the way the reference's apply path
hands an entry's ops to ``CoprocessorHost.notify_apply_write``
(``raftstore/peer.py:652-664``): user-level keys, without the engine's data
prefix.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..codec.keys import DATA_PREFIX


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def _unpack_bytes(buf: bytes, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from(">I", buf, off)
    off += 4
    return buf[off:off + n], off + n


@dataclass(frozen=True)
class WriteOp:
    """One KV mutation (CmdType::Put/Delete/DeleteRange)."""

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
