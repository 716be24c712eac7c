"""The port's coprocessor endpoint (``tikv_tpu_torch/copr/endpoint.py``)
against the JAX package's ``Endpoint`` on the same snapshot.

``Endpoint.handle`` picks the backend of each DAG request: the device
runner (``DeviceRunner(device="cpu")``, the plain versions of the
kernels) when it supports the plan and the snapshot reaches the row
threshold, else the host pipeline, whose answers must equal the
reference endpoint's host answers exactly.  A device fault degrades the
request to the host pipeline and is counted in ``Endpoint.degrades``,
unless the request forced the device: then it raises.  Rows are compared
exactly (tolerance 0).
"""

import numpy as np
import pytest

import jax

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import DeviceUnavailable
from tikv_tpu_torch.device.runner import DeviceRunner

N = 5000


def table() -> Table:
    return Table(9800, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
        TableColumn("r", 4, FieldType.double())))


@pytest.fixture(scope="module")
def snaps():
    rng = np.random.default_rng(98)
    t = table()
    cols = {"k": Column(EvalType.INT, rng.integers(0, 40, N),
                        rng.random(N) > 0.1),
            "v": Column(EvalType.INT, rng.integers(-500, 500, N),
                        rng.random(N) > 0.1),
            "r": Column(EvalType.REAL, rng.normal(0, 5, N).round(2),
                        rng.random(N) > 0.1)}
    for c in cols.values():
        c.values[~c.validity] = 0
    rsnap = ColumnarTable.from_arrays(t, np.arange(N), cols)
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    psnap = convert.snapshot_from_arrays(ptable, np.arange(N), {
        name: (c.eval_type.value, c.values, c.validity)
        for name, c in cols.items()})
    return rsnap, psnap


@pytest.fixture(scope="module")
def ref_ep(snaps):
    return RefEndpoint(lambda req: snaps[0], device_runner=RefRunner(
        mesh=make_mesh(jax.devices()[:1])), device_row_threshold=1)


def port_ep(snaps, runner="cpu", threshold=1):
    if runner == "cpu":
        runner = DeviceRunner(device="cpu")
    return Endpoint(lambda req: snaps[1], device_runner=runner,
                    device_row_threshold=threshold)


def q():
    return DagSelect.from_table(table(), ["id", "k", "v", "r"])


def _dags() -> dict:
    out = {"bare_scan": q().build(), "limit": q().limit(11).build()}
    s = q()
    out["projection"] = s.project(s.col("v") - s.col("k"),
                                  s.col("r")).build()
    s = q()
    out["bit_and"] = s.aggregate([], [("bit_and", s.col("v"))]).build()
    s = q()
    out["first_grouped"] = s.aggregate([s.col("k")],
                                       [("first", s.col("r"))]).build()
    s = q()
    out["two_keys"] = s.aggregate([s.col("k"), s.col("v")],
                                  [("count_star", None)]).build()
    s = q()
    out["topn_limit_big"] = s.order_by(s.col("v"), True, 20000).build()
    return out


HOST_DAGS = _dags()


def port_dag(dag):
    return convert.dag_from_wire(wire.enc_dag(dag))


@pytest.mark.parametrize("name", sorted(HOST_DAGS))
def test_unsupported_dags_serve_on_the_host(snaps, ref_ep, name):
    dag = HOST_DAGS[name]
    want = ref_ep.handle(RefRequest(103, dag, force_backend="host"))
    ep = port_ep(snaps)
    got = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
    assert got.backend == "host"
    assert got.rows() == want.rows()
    assert not ep.degrades


def _device_dag():
    s = q()
    return s.where(s.col("v") > Expr.const(0, EvalType.INT)).aggregate(
        [s.col("k")], [("count_star", None), ("sum", s.col("v"))]).build()


@pytest.mark.parametrize("force,threshold,backend", [
    (None, 1, "device"), (None, N + 1, "host"), ("host", 1, "host"),
    ("device", N + 1, "device")])
def test_routes(snaps, ref_ep, force, threshold, backend):
    """The device when the runner supports the plan and the snapshot
    reaches the threshold (or when forced); else the host; both answers
    equal the reference's."""
    dag = _device_dag()
    want = ref_ep.handle(RefRequest(103, dag, force_backend="host")).rows()
    ep = port_ep(snaps, threshold=threshold)
    got = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag), force))
    assert got.backend == backend
    assert sorted(got.rows()) == sorted(want)


def test_refusals(snaps):
    dag = port_dag(HOST_DAGS["bare_scan"])
    with pytest.raises(RuntimeError, match="not supported"):
        port_ep(snaps).handle(CopRequest(REQ_TYPE_DAG, dag, "device"))
    with pytest.raises(RuntimeError, match="no device runner"):
        port_ep(snaps, runner=None).handle(
            CopRequest(REQ_TYPE_DAG, dag, "device"))
    assert port_ep(snaps, runner=None).handle(
        CopRequest(REQ_TYPE_DAG, dag)).backend == "host"
    with pytest.raises(NotImplementedError):
        port_ep(snaps).handle(CopRequest(104, dag))


class _Faulty(DeviceRunner):
    """A runner whose device dispatch faults."""

    def handle_request(self, dag, storage):
        raise DeviceUnavailable("injected device fault")


def test_device_fault_degrades_unless_forced(snaps, ref_ep):
    dag = _device_dag()
    want = sorted(ref_ep.handle(RefRequest(103, dag,
                                           force_backend="host")).rows())
    ep = port_ep(snaps, runner=_Faulty(device="cpu"))
    got = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
    assert got.backend == "host" and sorted(got.rows()) == want
    assert ep.degrades == {"dispatch": 1}
    with pytest.raises(DeviceUnavailable, match="injected"):
        ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag), "device"))
    assert ep.degrades == {"dispatch": 1}


class _Broken(DeviceRunner):
    """A runner whose kernel fails to launch."""

    def handle_request(self, dag, storage):
        raise RuntimeError("sel_pred: launch failed")


def test_kernel_failure_is_not_degraded(snaps):
    """A kernel that fails to build or launch is no device fault: the
    request raises instead of being answered on the host."""
    ep = port_ep(snaps, runner=_Broken(device="cpu"))
    with pytest.raises(RuntimeError, match="launch failed"):
        ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(_device_dag())))
    assert not ep.degrades


def test_device_answers_equal_the_reference_device(snaps, ref_ep):
    dag = _device_dag()
    want = ref_ep.handle(RefRequest(103, dag, force_backend="device"))
    got = port_ep(snaps).handle(CopRequest(REQ_TYPE_DAG, port_dag(dag),
                                           "device"))
    assert got.backend == "device" and got.rows() == want.rows()
