"""Paged coprocessor requests in the port against the JAX package.

The same seeded table is a columnar snapshot in each package (``convert``
carries it into the port), and the same wire-encoded DAGs are served page
by page through each package's ``Endpoint`` with ``paging_size`` set,
each page's request carrying the last page's ``resume_token``, until
``is_drained``.  Every page must equal the reference's: its rows, its
token and ``is_drained``.  Covered: selections, projections and top-N; an
aggregation, one final page; a scan that cannot resume (an index scan, a
descending scan, a KV feed), served whole in one page; and writes landing
between two pages, after which the token still resumes right after the
last handle served, over the new snapshot.  The port's endpoint has a
device runner and a row threshold of 1: a paged request is served on the
host all the same.
"""

import dataclasses

import numpy as np
import pytest

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column as RefColumn
from tikv_tpu.datatype import EvalType as RefET
from tikv_tpu.executors.columnar import ColumnarTable as RefColumnar
from tikv_tpu.executors.runner import BatchExecutorsRunner as RefRunner
from tikv_tpu.server import wire
from tikv_tpu.testing import init_with_data as ref_init_with_data
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import int_table

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.executors.storage import FixtureStorage

TID = 8731
N = 2500


def _data(seed: int, n: int = N, lo: int = 0):
    rng = np.random.default_rng(seed)
    hs = np.sort(rng.choice(np.arange(lo, lo + 4 * n), n, replace=False))
    c0 = rng.integers(0, 13, n)
    c1 = rng.integers(-500, 1000, n)
    ok1 = rng.random(n) > 0.08
    return hs.astype(np.int64), c0.astype(np.int64), \
        np.where(ok1, c1, 0).astype(np.int64), ok1


def _snaps(table, hs, c0, c1, ok1):
    ref = RefColumnar.from_arrays(table, hs, {
        "c0": RefColumn.from_values(RefET.INT, c0),
        "c1": RefColumn(RefET.INT, c1, ok1)})
    pt = convert.table_from_wire(TID, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    port = convert.snapshot_from_arrays(pt, hs, {
        "c0": ("int", c0, None), "c1": ("int", c1, ok1)})
    return ref, port


@pytest.fixture(scope="module")
def table():
    return int_table(2, table_id=TID)


def _plan(table, name: str):
    s = DagSelect.from_table(table)
    if name == "selection":
        return s.where(s.col("c1") > 600).build()
    if name == "projection":
        return s.project(s.col("c1") + s.col("c0"), s.col("id")).build()
    if name == "sel_project":
        return s.where(s.col("c0") < 4).project(s.col("c1")).build()
    if name == "topn":
        return s.where(s.col("c0") > 2).order_by(s.col("c1"), limit=100) \
            .build()
    if name == "aggregation":
        return s.aggregate([s.col("c0")], [("count_star", None),
                                           ("sum", s.col("c1"))]).build()
    if name == "limit":
        return s.where(s.col("c1") > 0).limit(700).build()
    if name == "index":
        return DagSelect.from_index(table, "c0").build()
    if name == "descending":
        dag = s.build()
        scan = dataclasses.replace(dag.executors[0], desc=True)
        return dataclasses.replace(dag, executors=(scan,))
    raise AssertionError(name)


class Pair:
    """Both endpoints over a snapshot each package can swap."""

    def __init__(self, ref_snap, port_snap):
        self.ref_snap, self.port_snap = ref_snap, port_snap
        self.rep = RefEndpoint(lambda req: self.ref_snap)
        self.runner = DeviceRunner(device="cpu")
        self.pep = Endpoint(lambda req: self.port_snap, self.runner,
                            device_row_threshold=1)

    def page(self, rdag, size: int, token):
        """One page through each endpoint → (rows, token, drained), equal
        in both packages."""
        pdag = convert.dag_from_wire(wire.enc_dag(rdag))
        r = self.rep.handle(RefRequest(103, rdag, paging_size=size,
                                       resume_token=token))
        p = self.pep.handle(CopRequest(REQ_TYPE_DAG, pdag, paging_size=size,
                                       resume_token=token))
        assert p.backend == "host"
        want = (r.rows(), r.resume_token, r.is_drained)
        got = (p.rows(), p.resume_token, p.is_drained)
        assert got == want
        return got


def _follow(pair, rdag, size: int, limit: int = 1000) -> list:
    pages, token = [], None
    for _ in range(limit):
        rows, token, drained = pair.page(rdag, size, token)
        pages.append((rows, token, drained))
        if drained:
            return pages
    raise AssertionError("never drained")


@pytest.mark.parametrize("plan,size", [
    ("selection", 64), ("selection", 200), ("projection", 333),
    ("sel_project", 100), ("topn", 30), ("limit", 128)])
def test_pages_match_the_reference(table, plan, size):
    pair = Pair(*_snaps(table, *_data(1)))
    rdag = _plan(table, plan)
    pages = _follow(pair, rdag, size)
    whole = RefRunner(rdag, pair.ref_snap).handle_request().rows()
    if plan == "limit":
        # each page's pipeline applies the LIMIT afresh (the reference's
        # contract: the client stops reading at its limit)
        assert pages[0][0] == whole[:len(pages[0][0])]
    else:
        assert [r for rows, _t, _d in pages for r in rows] == whole
    if plan in ("selection", "projection", "sel_project", "limit"):
        assert len(pages) > 1
        for rows, _t, drained in pages[:-1]:
            assert len(rows) >= size and not drained
    # the device runner served none of them
    assert pair.runner.feed_routes == {}


def test_aggregation_is_one_final_page(table):
    pair = Pair(*_snaps(table, *_data(2)))
    rdag = _plan(table, "aggregation")
    pages = _follow(pair, rdag, 4)
    assert len(pages) == 1 and pages[0][2]
    assert len(pages[0][0]) == 13


@pytest.mark.parametrize("plan", ["index", "descending", "kv"])
def test_a_scan_that_cannot_resume_is_served_whole(table, plan):
    data = _data(3)
    pair = Pair(*_snaps(table, *data))
    if plan == "kv":
        hs, c0, c1, ok1 = data
        rows = [(int(h), {"c0": int(a), "c1": int(b) if ok else None})
                for h, a, b, ok in zip(hs, c0, c1, ok1)]
        ref_kv = ref_init_with_data(table, rows)
        pair.ref_snap = ref_kv
        pair.port_snap = FixtureStorage(zip(ref_kv._keys, ref_kv._vals))
        rdag = _plan(table, "selection")
    else:
        rdag = _plan(table, plan)
    pages = _follow(pair, rdag, 50)
    assert len(pages) == 1 and pages[0][1] is None and pages[0][2]
    assert len(pages[0][0]) > 50
    with pytest.raises(ValueError):
        BatchExecutorsRunner(convert.dag_from_wire(wire.enc_dag(rdag)),
                             pair.port_snap, resume_token=7)
    with pytest.raises(ValueError):
        RefRunner(rdag, pair.ref_snap, resume_token=7)


@pytest.mark.parametrize("plan", ["selection", "projection"])
def test_a_write_between_two_pages(table, plan):
    """After page 2 the snapshot changes: rows inserted before and after
    the token, rows deleted, values updated.  Page 3 resumes after the
    last handle served, over the new snapshot; no row is served twice."""
    hs, c0, c1, ok1 = _data(4)
    pair = Pair(*_snaps(table, hs, c0, c1, ok1))
    rdag = _plan(table, plan)
    pages = [pair.page(rdag, 200, None)]
    pages.append(pair.page(rdag, 200, pages[-1][1]))
    token = pages[-1][1]
    assert token is not None and not pages[-1][2]
    rng = np.random.default_rng(5)
    new_h = np.setdiff1d(rng.integers(0, 5 * N, 300), hs)
    keep = rng.random(len(hs)) > 0.05
    hs2 = np.concatenate([hs[keep], new_h])
    order = np.argsort(hs2, kind="stable")
    c0b = np.concatenate([c0[keep], rng.integers(0, 13, len(new_h))])[order]
    c1b = np.concatenate([c1[keep], rng.integers(-500, 1000, len(new_h))])
    ok1b = np.concatenate([ok1[keep], np.ones(len(new_h), bool)])[order]
    c1b = np.where(ok1b, c1b[order] + 1, 0)
    pair.ref_snap, pair.port_snap = _snaps(table, hs2[order], c0b, c1b,
                                           ok1b)
    while True:
        rows, token, drained = pair.page(rdag, 200, token)
        pages.append((rows, token, drained))
        if drained:
            break
    # the pages after the write are the new snapshot's rows past the token
    after = [r for rows, _t, _d in pages[2:] for r in rows]
    whole = RefRunner(rdag, pair.ref_snap).handle_request().rows()
    first = pages[1][1]
    if plan == "selection":
        assert after == [r for r in whole if r[0] > first]
        served = [r[0] for rows, _t, _d in pages for r in rows]
        assert len(served) == len(set(served))
    else:
        assert len(after) == int((hs2 > first).sum())
