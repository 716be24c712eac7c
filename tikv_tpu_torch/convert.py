"""Carry a snapshot and a request into the port from plain data.

For this system the state a request runs against is a table snapshot
(handles + columns) and the request itself; both cross from any producer
— the JAX package, a loader, a client — as numpy arrays and wire dicts:

- ``table_from_wire(table_id, [(name, col_id, ft_dict, is_pk)])``
- ``snapshot_from_arrays(table, handles, {name: (eval_type_name, values,
  validity)}, alive=None)``: INT and DURATION int64, REAL float64,
  DATETIME (the packed core), ENUM (the 1-based ordinal) and SET (the
  bitmask) uint64, BYTES ``bytes``, DECIMAL ``decimal.Decimal`` and JSON
  (parsed documents, ``datatype/myjson.py``) object arrays or sequences;
  a string column's collation and an
  enum's or set's names ride its field type (``table_from_wire``)
- ``dag_from_wire(d)``: a request encoded by ``enc_dag`` in either package;
- ``plan_from_wire(d)``: a plan-IR request encoded by ``enc_plan`` in
  either package (the JAX package's ``server/wire.py``);
- ``write_planes_from_arrays(...)``: the version planes of one CF_WRITE
  range (the fields of the JAX package's ``device.mvcc.WritePlanes``), the
  input of the cold build (``copr.region_cache``);
- ``engine_from_triples(triples)``: a ``MemoryEngine`` holding the
  ``(cf, key, value)`` byte triples of any producer's engine (MVCC records
  encoded by either package's ``txn_types``), which the columnar cache
  builds its lines from;
- ``mesh_from_shape(shape, devices)``: the port's mesh of a mesh shape
  (R, T), such as a JAX mesh's ``devices.shape``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .copr.dag import DAGRequest
from .copr.wire import dec_dag, dec_field_type, dec_plan
from .datatype import Column, EvalType
from .device.mvcc import WritePlanes
from .engine.memory import MemoryEngine
from .executors.columnar import ColumnarTable
from .parallel.mesh import Mesh, make_mesh
from .testing.fixture import Table, TableColumn


def table_from_wire(table_id: int, columns: Sequence[tuple]) -> Table:
    """``columns``: (name, col_id, field-type dict, is_pk_handle) each."""
    return Table(table_id, tuple(
        TableColumn(name, col_id, dec_field_type(ft), bool(is_pk))
        for name, col_id, ft, is_pk in columns))


def snapshot_from_arrays(table: Table, handles, columns: dict,
                         alive=None) -> ColumnarTable:
    """``columns``: {name: (eval type name, values, validity or None)};
    ``alive``: the rows that exist (delete tombstones), or None."""
    named = {}
    for name, (et, values, validity) in columns.items():
        et = EvalType(et)
        if et.np_dtype == np.dtype(object):
            # element by element: a JSON array document must stay one value
            # (np.asarray would make it a dimension)
            items = values
            values = np.empty(len(items), dtype=object)
            for i, x in enumerate(items):
                values[i] = x
        else:
            values = np.asarray(values)
        valid: Optional[np.ndarray] = None if validity is None \
            else np.asarray(validity, dtype=np.bool_)
        named[name] = Column.from_values(et, values, valid)
    return ColumnarTable.from_arrays(table, np.asarray(handles, np.int64),
                                     named, alive)


def dag_from_wire(d: dict) -> DAGRequest:
    return dec_dag(d)


def plan_from_wire(d: dict):
    return dec_plan(d)


def write_planes_from_arrays(n_ver: int, n_keys: int, table_id: int,
                             safe_ts: int, commit_ts, start_ts, wtype,
                             has_payload, seg_id, handles, seg_start,
                             cols: dict, need_default=(),
                             col_ids: Sequence[int] = ()) -> WritePlanes:
    """The version planes as numpy arrays of the parse's dtypes; ``cols``:
    {col_id: (plane kind, values, validity)} (kind 0 int64, 1 float64,
    3 uint64)."""
    kinds = {0: np.int64, 1: np.float64, 3: np.uint64}
    planes = {cid: (int(kind), np.asarray(v, kinds[int(kind)]),
                    np.asarray(ok, np.bool_))
              for cid, (kind, v, ok) in cols.items()}
    return WritePlanes(
        int(n_ver), int(n_keys), int(table_id), int(safe_ts),
        np.asarray(commit_ts, np.uint64), np.asarray(start_ts, np.uint64),
        np.asarray(wtype, np.uint8), np.asarray(has_payload, np.uint8),
        np.asarray(seg_id, np.int32), np.asarray(handles, np.int64),
        np.asarray(seg_start, np.int64), planes,
        [(int(r), int(s), bytes(k)) for r, s, k in need_default],
        tuple(int(c) for c in (col_ids or planes)))


def engine_from_triples(triples, engine: Optional[MemoryEngine] = None
                        ) -> MemoryEngine:
    """Write ``(cf, key, value)`` byte triples (engine keys, data prefix
    included) into ``engine`` (a new ``MemoryEngine`` by default) in one
    batch → the engine."""
    engine = MemoryEngine() if engine is None else engine
    wb = engine.write_batch()
    for cf, key, value in triples:
        wb.put_cf(cf, bytes(key), bytes(value))
    engine.write(wb)
    return engine


def mesh_from_shape(shape, devices: Sequence) -> Mesh:
    """The port's ("range", "tile") mesh of ``shape`` (R, T) — a JAX
    mesh's ``devices.shape`` — over the first R·T of ``devices`` (a device
    may repeat: ``["cuda:0"] * 4`` is four shards of one card, ``["cpu"] *
    n`` the plain versions)."""
    r, t = int(shape[0]), int(shape[1])
    return make_mesh(list(devices)[:r * t], shape=(r, t))
