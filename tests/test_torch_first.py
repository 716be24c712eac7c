"""FIRST with a leading NULL (fault 8): the port answers as the host
pipeline does on every route.

Three rows, ``v`` INT = NULL, 5, 6 and ``r`` REAL = NULL, 1.5, 2.5, under
``SELECT FIRST(x), COUNT(*)`` with no selection, a selection that keeps
the NULL row and one that drops it.  FIRST is the first *selected* row's
value, NULL when that row is NULL (TiKV's ``AggrFnFirst``), so the port's
device route (``DeviceRunner(device="cpu")`` through the endpoint at a row
threshold of 1: ``agg_fold``'s plain version), the port's host pipeline
and the JAX package's host pipeline all answer ``(None, 3)`` while the NULL
row is selected.  The JAX package's device route skips the NULL row and
answers ``(5, 3)`` / ``(1.5, 3)``: that wrong answer is pinned here.
``agg_fold`` on the same tensors is checked on its own.  Everything is
compared exactly.
"""

import numpy as np
import pytest

import jax
import torch

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import agg_fold as af
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.ops import agg

V = (np.array([0, 5, 6], np.int64), np.array([False, True, True]))
R = (np.array([0.0, 1.5, 2.5]), np.array([False, True, True]))
# selection → (selected rows, the id predicate's bound: id > bound)
SELECTIONS = {"none": ([0, 1, 2], None), "keeps_null": ([0, 1, 2], 0),
              "drops_null": ([1, 2], 1)}


def table() -> Table:
    return Table(9811, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("v", 2, FieldType.long()),
        TableColumn("r", 3, FieldType.double())))


@pytest.fixture(scope="module")
def snaps():
    t = table()
    cols = {"v": Column(EvalType.INT, *V), "r": Column(EvalType.REAL, *R)}
    rsnap = ColumnarTable.from_arrays(t, np.arange(1, 4), cols)
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    psnap = convert.snapshot_from_arrays(ptable, np.arange(1, 4), {
        name: (c.eval_type.value, c.values, c.validity)
        for name, c in cols.items()})
    return rsnap, psnap


def dag_of(col: str, sel: str):
    q = DagSelect.from_table(table(), ["id", "v", "r"])
    bound = SELECTIONS[sel][1]
    if bound is not None:
        q = q.where(q.col("id") > bound)
    return q.aggregate([], [("first", q.col(col)),
                            ("count_star", None)]).build()


def host_answer(col: str, sel: str) -> list:
    values, ok = V if col == "v" else R
    rows = SELECTIONS[sel][0]
    first = values[rows[0]].item() if ok[rows[0]] else None
    return [(first, len(rows))]


@pytest.mark.parametrize("sel", sorted(SELECTIONS))
@pytest.mark.parametrize("col", ["v", "r"])
def test_first_is_the_first_selected_row_on_every_route(snaps, col, sel):
    dag = dag_of(col, sel)
    want = host_answer(col, sel)
    ref_host = RefEndpoint(lambda req: snaps[0]).handle(
        RefRequest(103, dag, force_backend="host"))
    assert ref_host.rows() == want
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    ep = Endpoint(lambda req: snaps[1],
                  device_runner=DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    dev = ep.handle(CopRequest(REQ_TYPE_DAG, pdag))
    assert dev.backend == "device" and dev.rows() == want
    host = ep.handle(CopRequest(REQ_TYPE_DAG, pdag, force_backend="host"))
    assert host.backend == "host" and host.rows() == want
    assert not ep.degrades


@pytest.mark.parametrize("sel", ["none", "keeps_null"])
@pytest.mark.parametrize("col", ["v", "r"])
def test_reference_device_skips_a_leading_null(snaps, col, sel):
    """Pinned: the JAX package's device FIRST takes the first valid row
    (``tikv_tpu/ops/agg.py:188-196``), so it answers the second row."""
    ep = RefEndpoint(lambda req: snaps[0], device_runner=RefRunner(
        mesh=make_mesh(jax.devices()[:1])), device_row_threshold=1)
    got = ep.handle(RefRequest(103, dag_of(col, sel),
                               force_backend="device"))
    assert got.rows() == [(5 if col == "v" else 1.5, 3)]
    assert host_answer(col, sel) == [(None, 3)]


@pytest.mark.parametrize("sel", sorted(SELECTIONS))
@pytest.mark.parametrize("col", ["v", "r"])
def test_agg_fold_first_state(col, sel):
    """``agg_fold``'s plain version (what the CUDA kernel is held
    against): the position of the first selected row, the value there and
    its validity."""
    values, ok = V if col == "v" else R
    rows = SELECTIONS[sel][0]
    mask = None if sel == "none" else \
        torch.from_numpy(np.isin(np.arange(3), rows))
    et = EvalType.INT if col == "v" else EvalType.REAL
    specs = [agg.AggSpec("first", 0, et), agg.AggSpec("count_star", 1)]
    vt = torch.from_numpy(values.astype(np.int32 if col == "v"
                                        else np.float32))
    _present, _overflow, states = af.agg_fold(
        specs, [(vt, torch.from_numpy(ok)), None], 3, "simple",
        mask=mask).host()
    first = {k: x[0] for k, x in states[0].items()}
    assert int(first["pos"]) == rows[0]
    assert int(first["ok"]) == int(ok[rows[0]])
    states = [first, {k: x[0] for k, x in states[1].items()}]
    assert [tuple(agg.finalize_simple(specs, states))] == \
        host_answer(col, sel)
