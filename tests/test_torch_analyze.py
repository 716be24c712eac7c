"""ANALYZE in the port against the JAX package on the same seeded inputs.

- Kernel level: ``device/analyze.py`` ``analyze_column_plain`` (the plain
  version of ``csrc/analyze.cu``) against the reference's
  ``_AnalyzeKernels._build`` jitted on the CPU, for int32, int64, uint32
  and uint64 (DATETIME), int64 (DURATION) and float64 columns over NULLs,
  NaN, negative NaN, ±0.0, ±inf, a valid value equal to the dtype's max,
  all NULL, one valid row, fewer valid rows than buckets, one bucket and
  one row.  The rule of the comparison (``packed_max_diff``): every rank
  word, n_valid and the distinct count bit for bit; the bound of each
  bucket the reference's unpacking keeps by value (-0.0 equals +0.0, NaN
  equals NaN); tolerance 0.
- Endpoint level: ``Endpoint.handle_analyze`` with
  ``DeviceRunner(device="cpu")`` against the reference endpoint's device
  route (a single-device mesh) and its host half, over full and partial
  key ranges, a BYTES column (the host half), DATETIME, DURATION and REAL
  columns, an empty range, a cold-minted snapshot, and an injected
  ``DeviceUnavailable`` that degrades and is counted.
"""

import ctypes
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tikv_tpu.copr.analyze import AnalyzeReq as RefAnalyzeReq
from tikv_tpu.copr.analyze import analyze_columns as ref_analyze_columns
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column as RefColumn
from tikv_tpu.datatype import EvalType as RefET
from tikv_tpu.datatype import FieldType as RefFT
from tikv_tpu.datatype.eval_type import FieldTypeTp as RefTp
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.runner import _AnalyzeKernels
from tikv_tpu.executors.columnar import ColumnarTable as RefTable
from tikv_tpu.executors.ranges import KeyRange as RefKeyRange
from tikv_tpu.codec import table_record_key as ref_record_key
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.analyze import (AnalyzeReq, ColumnStats,
                                         analyze_columns,
                                         histogram_from_sorted)
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_ANALYZE, Endpoint
from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                              build_region_columnar_device)
from tikv_tpu_torch.datatype.tile import _device_dtype
from tikv_tpu_torch.device import DeviceUnavailable
from tikv_tpu_torch.device import analyze as an
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import configs as cf
from tikv_tpu_torch.testing import mvcc as tm

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref_runner():
    # a single-device mesh: the reference declines ANALYZE on the 8-device
    # CPU mesh of the conftest (runner._single); it also enables x64
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


# ------------------------------------------------------------ kernel level

DTYPES = cf.ANALYZE_KINDS
CASES = cf.ANALYZE_EDGE_CASES
kernel_case = cf.analyze_edge_case


def ref_packed(vals, ok, n, b) -> np.ndarray:
    kern = _AnalyzeKernels._build(np.dtype(vals.dtype), b)
    return np.asarray(kern(jnp.asarray(vals), jnp.asarray(ok),
                           jnp.asarray(n, jnp.int64)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", list(DTYPES))
def test_plain_matches_reference_kernel(ref_runner, kind, case):
    vals, ok, n, b = kernel_case(kind, case)
    want = ref_packed(vals, ok, n, b)
    got = an.analyze_column_plain(torch.from_numpy(vals),
                                  torch.from_numpy(ok), n, b)
    real = kind == "float64"
    assert got.dtype == torch.int64 and got.shape == (2 * b + 2,)
    assert an.packed_max_diff(got, want, b, real) == 0
    # the integer words are bit-equal everywhere the reference's
    # sentinel does not show
    assert np.array_equal(got.numpy()[b:], want[b:])
    # and the unpacked statistics are the host half's (where the device
    # route serves the column: the runner sends a uint64 column holding a
    # value at or past 2^63 to the host half)
    sv = np.sort(vals[:n][ok[:n]])
    if vals.dtype == np.uint64 and len(sv) and int(sv[-1]) >= 1 << 63:
        return
    n_valid, distinct, buckets = an.unpack(got.numpy(), b, real)
    hb, hd = histogram_from_sorted(sv, b)
    assert (n_valid, distinct) == (len(sv), hd)
    assert len(buckets) == len(hb)
    for (g, gc), (w, wc) in zip(buckets, hb):
        assert gc == wc and (g == w or (math.isnan(g) and math.isnan(w)))


def test_wrapper_takes_the_plain_version_on_cpu():
    vals, ok, n, b = kernel_case("int32", "random")
    before = an.analyze_launches
    got = an.analyze_column(torch.from_numpy(vals), torch.from_numpy(ok),
                            n, b)
    want = an.analyze_column_plain(torch.from_numpy(vals),
                                   torch.from_numpy(ok), n, b)
    assert torch.equal(got, want)
    assert an.analyze_launches == before      # no kernel launched


@pytest.mark.parametrize("bad", ("dtype", "rows", "buckets", "device",
                                 "validity"))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    v = torch.zeros(8, dtype=torch.int32)
    ok = torch.ones(8, dtype=torch.bool)
    args = {"dtype": (v.to(torch.int16), ok, 8, 4),
            "rows": (v, ok, 9, 4), "buckets": (v, ok, 8, 0),
            "device": (v.to("meta"), ok.to("meta"), 8, 4),
            "validity": (v, ok.to(torch.uint8), 8, 4)}[bad]
    with pytest.raises(ValueError):
        an.analyze_column(*args)


def test_params_mirror_the_kernel_struct():
    """``_AnalyzeParams`` names the fields of csrc/analyze.cu's ``struct
    AnalyzeParams`` in order (the library checks the size at load)."""
    src = (Path(an.__file__).parent.parent / "csrc" /
           "analyze.cu").read_text()
    body = re.search(r"struct AnalyzeParams \{(.*?)\n\};", src, re.S)[1]
    names = re.findall(r"(\w+)(?:\[\d+\])?;", re.sub(r"//.*", "", body))
    assert names == [f[0] for f in an._AnalyzeParams._fields_]
    assert ctypes.sizeof(an._AnalyzeParams) == 120
    assert callable(an._kernel_lib)


def test_packed_diff_reads_only_what_the_unpacking_reads():
    b = 4
    want = np.array([7, 7, 7, 9, 1, 1, 1, 2, 2, 2], np.int64)
    got = want.copy()
    got[1] = 123            # a degenerate bucket's bound: not read
    got[2] = -5
    assert an.packed_max_diff(got, want, b, False) == 0
    got[0] = 8              # the first kept bucket's bound
    assert an.packed_max_diff(got, want, b, False) == 1
    got = want.copy()
    got[-1] = 3             # the distinct count
    assert an.packed_max_diff(got, want, b, False) == 1
    nan = np.array([np.nan, -0.0], np.float64).view(np.int64)
    canon = np.array([np.float64(np.nan), 0.0]).view(np.int64)
    want = np.concatenate([nan, [1, 2, 2, 2]])
    got = np.concatenate([canon, [1, 2, 2, 2]])
    assert an.packed_max_diff(got, want, 2, True) == 0


def test_key_plan_of_the_cells():
    """The key widths (and so the passes) of config 4's columns: k 11 bits
    with the NULL class (2 passes), id 27 (4), 4s's k 62 (8), 4r's REAL
    64 (8); a full-span int64 column keeps its NULL key at all ones."""
    n = 1 << 14
    _t, snap = cf.build_table(n)
    k = snap.columns[2].values.copy()
    k[:2] = (0, cf.GROUPS - 1)
    ids = np.arange(n)
    ids[1] = 104_857_599                    # config 4's last handle
    for vals, bits in ((k, 11), (ids, 27)):
        plan = an.key_plan(torch.from_numpy(vals.astype(np.int32)),
                           torch.ones(n, dtype=torch.bool), n)
        assert plan[3] == bits and plan[4] == -(-bits // 8)
    _t, s4s = cf.build_sparse_table(n)
    plan = an.key_plan(torch.from_numpy(s4s.columns[2].values),
                       torch.ones(n, dtype=torch.bool), n)
    assert plan[4] == 8 and 57 <= plan[3] <= 62
    _t, s4r = cf.build_table(n, real_v=True)
    plan = an.key_plan(torch.from_numpy(s4r.columns[3].values),
                       torch.ones(n, dtype=torch.bool), n)
    assert plan[3] == 64 and plan[4] == 8
    full = torch.tensor([I64.min, I64.max, 5], dtype=torch.int64)
    plan = an.key_plan(full, torch.tensor([True, True, False]), 3)
    assert plan[:2] == (2, 0) and plan[3] == 64
    assert an.null_key(0, (1 << 64) - 1) == (1 << 64) - 1
    assert an.null_key(10, 20) == 11
    assert an.sort_words(10_000, 11) == 2 * (3 * 256 + 257)
    assert an.sort_words(10_000, 0) == 0


# ---------------------------------------------------------- endpoint level

N = 3000


def ref_table() -> Table:
    dt = RefFT(tp=RefTp.DATETIME)
    return Table(8960, (
        TableColumn("id", 1, RefFT.long(not_null=True), is_pk_handle=True),
        TableColumn("k", 2, RefFT.long()),
        TableColumn("w", 3, RefFT.long()),
        TableColumn("r", 4, RefFT.double()),
        TableColumn("d", 5, dt),
        TableColumn("t", 6, RefFT(tp=RefTp.DURATION)),
        TableColumn("s", 7, RefFT.var_char()),
        TableColumn("big", 8, dt),
    ))


def ref_columns() -> dict:
    rng = np.random.default_rng(104)
    r = rng.normal(0, 50, N).round(1)
    r[::97] = np.nan
    r[5::89] = np.copysign(np.nan, -1)
    r[7::61] = -0.0
    r[9::53] = np.inf
    d = rng.integers(0, 1 << 32, N, dtype=np.uint64)
    big = rng.integers(0, 1 << 62, N, dtype=np.uint64)
    big[::11] |= np.uint64(1 << 63)           # beyond int64: the host half
    cols = {
        "k": (RefET.INT, rng.integers(0, 50, N), (np.arange(N) % 11) != 4),
        "w": (RefET.INT, rng.integers(-(1 << 40), 1 << 40, N),
              rng.random(N) > 0.05),
        "r": (RefET.REAL, r, (np.arange(N) % 13) != 2),
        "d": (RefET.DATETIME, d, rng.random(N) > 0.1),
        "t": (RefET.DURATION, rng.integers(-10**12, 10**12, N),
              rng.random(N) > 0.1),
        "s": (RefET.BYTES, np.array([b"s%03d" % (i % 71) for i in range(N)],
                                    object), rng.random(N) > 0.1),
        "big": (RefET.DATETIME, big, np.ones(N, np.bool_)),
    }
    out = {}
    for name, (et, v, ok) in cols.items():
        if et is not RefET.BYTES and et is not RefET.REAL:
            v = np.where(ok, v, 0).astype(v.dtype)
        out[name] = (et, v, ok)
    return out


@pytest.fixture(scope="module")
def snaps():
    t = ref_table()
    cols = ref_columns()
    rsnap = RefTable.from_arrays(t, np.arange(N), {
        name: RefColumn(et, v, ok) for name, (et, v, ok) in cols.items()})
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    psnap = convert.snapshot_from_arrays(ptable, np.arange(N), {
        name: (et.value, v, ok) for name, (et, v, ok) in cols.items()})
    return t, rsnap, psnap


def _ranges(t, case: str) -> tuple:
    if case == "full":
        return DagSelect.from_table(t).build().ranges
    if case == "partial":
        bounds = ((500, 1500), (2000, 2250))
    elif case == "three_rows":
        bounds = ((100, 103),)
    else:                                     # no row
        bounds = ((N + 10, N + 20),)
    return tuple(RefKeyRange(ref_record_key(t.table_id, lo),
                             ref_record_key(t.table_id, hi))
                 for lo, hi in bounds)


def requests(t, case: str, buckets: int):
    """The same ANALYZE request for both packages (the port's through the
    DAG wire form)."""
    dag = dataclasses.replace(DagSelect.from_table(t).build(),
                              ranges=_ranges(t, case))
    rreq = RefAnalyzeReq(dag.executors[0], dag.ranges, buckets=buckets)
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    return rreq, AnalyzeReq(pdag.executors[0], pdag.ranges, buckets=buckets)


def same_stats(got, want) -> bool:
    """Column by column: ids, totals, NULL and distinct counts exactly;
    each bucket's count exactly and its bound by value (NaN equals NaN)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if (g.col_id, g.total, g.null_count, g.distinct) != \
                (w.col_id, w.total, w.null_count, w.distinct) or \
                len(g.buckets) != len(w.buckets):
            return False
        for (gb, gc), (wb, wc) in zip(g.buckets, w.buckets):
            if gc != wc:
                return False
            if isinstance(wb, float) and math.isnan(wb):
                if not (isinstance(gb, float) and math.isnan(gb)):
                    return False
            elif gb != wb or type(gb) is not type(wb):
                return False
    return True


class _Spy:
    """Counts the runner's kernel calls (on the CPU the wrapper runs the
    plain version and counts no launch)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = an.analyze_column

        def call(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(an, "analyze_column", call)


@pytest.mark.parametrize("buckets", (1, 7, 256))
@pytest.mark.parametrize("case", ("full", "partial", "three_rows"))
def test_endpoint_matches_reference_device_and_host(ref_runner, snaps,
                                                    monkeypatch, case,
                                                    buckets):
    t, rsnap, psnap = snaps
    rreq, preq = requests(t, case, buckets)
    ref_dev = RefEndpoint(lambda req: rsnap, device_runner=ref_runner,
                          device_row_threshold=1).handle_analyze(rreq)
    ref_host = RefEndpoint(lambda req: rsnap).handle_analyze(rreq)
    spy = _Spy(monkeypatch)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    got = ep.handle_analyze(preq)["columns"]
    assert all(isinstance(s, ColumnStats) for s in got)
    assert same_stats(got, ref_dev["columns"])
    assert same_stats(got, ref_host["columns"])
    # id, k, w, r, d, t on the card; s (BYTES) on the host half, and big
    # too where its range holds a value at or past 2^63 (every 11th row)
    assert spy.calls == (7 if case == "three_rows" else 6)
    assert not ep.degrades
    phases = ep._device_runner.analyze_phases_ms
    assert {"scan", "pad_h2d", "d2h", "unpack"} <= set(phases)


def test_column_dtypes_on_the_card(snaps):
    """DATETIME goes up as uint32 (its values fit), DURATION and INT as
    int32 or int64, REAL as float64."""
    _t, _rsnap, psnap = snaps
    cols = psnap.columns
    assert _device_dtype(cols[5].eval_type, cols[5].values) == np.uint32
    assert _device_dtype(cols[6].eval_type, cols[6].values) == np.int64
    assert _device_dtype(cols[8].eval_type, cols[8].values) == np.uint64
    seen = []
    real = an.analyze_column

    def spy(values, *a, **k):
        seen.append(values.dtype)
        return real(values, *a, **k)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    _r, preq = requests(ref_table(), "full", 8)
    an.analyze_column, saved = spy, an.analyze_column
    try:
        ep.handle_analyze(preq)
    finally:
        an.analyze_column = saved
    assert seen == [torch.int32, torch.int32, torch.int64, torch.float64,
                    torch.uint32, torch.int64]


def test_empty_range_takes_the_host_half(ref_runner, snaps, monkeypatch):
    t, rsnap, psnap = snaps
    rreq, preq = requests(t, "none", 16)
    spy = _Spy(monkeypatch)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    got = ep.handle_analyze(preq)["columns"]
    want = RefEndpoint(lambda req: rsnap, device_runner=ref_runner,
                       device_row_threshold=1).handle_analyze(rreq)
    assert same_stats(got, want["columns"])
    assert all(s.total == 0 and s.buckets == [] for s in got)
    assert spy.calls == 0


def test_below_the_row_threshold_is_the_host_half(snaps, monkeypatch):
    t, rsnap, psnap = snaps
    rreq, preq = requests(t, "full", 32)
    spy = _Spy(monkeypatch)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=N + 1)
    got = ep.handle_analyze(preq)["columns"]
    assert spy.calls == 0
    assert same_stats(got, RefEndpoint(lambda req: rsnap)
                      .handle_analyze(rreq)["columns"])
    # and with no runner at all
    got = Endpoint(lambda req: psnap).handle_analyze(preq)["columns"]
    assert same_stats(got, RefEndpoint(lambda req: rsnap)
                      .handle_analyze(rreq)["columns"])


def test_a_device_fault_degrades_to_the_host_half(snaps, monkeypatch):
    t, rsnap, psnap = snaps
    rreq, preq = requests(t, "partial", 16)

    def fault(*a, **k):
        raise DeviceUnavailable("injected")
    monkeypatch.setattr(an, "analyze_column", fault)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    got = ep.handle_analyze(preq)["columns"]
    assert ep.degrades == {"analyze": 1}
    assert same_stats(got, RefEndpoint(lambda req: rsnap)
                      .handle_analyze(rreq)["columns"])


def test_a_kernel_failure_is_not_a_degrade(snaps, monkeypatch):
    t, _rsnap, psnap = snaps
    _rreq, preq = requests(t, "full", 16)

    def broken(*a, **k):
        raise RuntimeError("analyze_sort_launch failed: invalid argument")
    monkeypatch.setattr(an, "analyze_column", broken)
    ep = Endpoint(lambda req: psnap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    with pytest.raises(RuntimeError, match="analyze_sort_launch"):
        ep.handle_analyze(preq)
    assert not ep.degrades


def test_the_provider_gets_an_analyze_request(snaps):
    t, _rsnap, psnap = snaps
    _rreq, preq = requests(t, "full", 4)
    seen = []

    def provider(req):
        seen.append(req.tp)
        return psnap
    Endpoint(provider, DeviceRunner(device="cpu"),
             device_row_threshold=1).handle_analyze(preq)
    assert seen == [REQ_TYPE_ANALYZE]


def test_cold_snapshot_matches_reference_and_truth(ref_runner):
    """ANALYZE over a cold-minted ``MvccColumnarSnapshot`` (config 6c's
    history at 20,000 keys) equals the reference's device route and host
    half over the generator's visible rows, and the numpy truth."""
    table, planes, th, truth, read_ts = tm.history_6c(20_000)
    runner = DeviceRunner(device="cpu")
    preq = cf.analyze_request(table, 64)
    tbl, safe, bundle = build_region_columnar_device(
        planes, table, preq.scan.columns, read_ts, runner.mvcc_resolver())
    snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=1)
    got = ep.handle_analyze(preq)["columns"]
    tt = tm.truth_table(table, th, truth, tm.ETS_INT)
    assert same_stats(got, cf.analyze_truth(preq, tt))
    rt = Table(table.table_id, tuple(
        TableColumn(c.name, c.col_id, RefFT.long(not_null=c.is_pk_handle),
                    is_pk_handle=c.is_pk_handle) for c in table.columns))
    rsnap = RefTable(rt, th, {cid: RefColumn(RefET.INT, v, ok)
                              for cid, (v, ok) in truth.items()})
    rdag = DagSelect.from_table(rt).build()
    rreq = RefAnalyzeReq(rdag.executors[0], rdag.ranges, buckets=64)
    for ep_ref in (RefEndpoint(lambda req: rsnap, device_runner=ref_runner,
                               device_row_threshold=1),
                   RefEndpoint(lambda req: rsnap)):
        assert same_stats(got, ep_ref.handle_analyze(rreq)["columns"])


@pytest.mark.parametrize("cell", list(cf.ANALYZE_CELLS))
def test_cells_match_their_truth(ref_runner, cell):
    """The chip smoke's cells at 2^15 rows: the port's answer equals the
    numpy truth (``configs.analyze_truth``) and the reference host half."""
    table, snap = cf.ANALYZE_CELLS[cell](1 << 15)
    areq = cf.analyze_request(table)
    ep = Endpoint(lambda req: snap, DeviceRunner(device="cpu"),
                  device_row_threshold=1)
    got = ep.handle_analyze(areq)["columns"]
    assert same_stats(got, cf.analyze_truth(areq, snap))
    batch = snap.scan_columns(areq.scan, ())
    assert same_stats(got, analyze_columns(batch, areq.scan.columns,
                                           cf.ANALYZE_BUCKETS))
    rbatch_cols = [RefColumn(RefET(c.eval_type.value), c.values, c.validity)
                   for c in batch.columns]
    from tikv_tpu.datatype import ColumnBatch as RefBatch
    rdag = DagSelect.from_table(_ref_of(table)).build()
    want = ref_analyze_columns(
        RefBatch([RefFT.long()] * len(rbatch_cols), rbatch_cols),
        rdag.executors[0].columns, cf.ANALYZE_BUCKETS)
    assert same_stats(got, want)


def _ref_of(table) -> Table:
    return Table(table.table_id, tuple(
        TableColumn(c.name, c.col_id,
                    RefFT.double() if c.field_type.eval_type.value == "real"
                    else RefFT.long(not_null=c.is_pk_handle),
                    is_pk_handle=c.is_pk_handle) for c in table.columns))
