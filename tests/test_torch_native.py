"""The port's native module (``tikv_tpu_torch/native/fastbuild.cpp``) against
the JAX package's (``tikv_tpu/native/fastbuild.cpp``): the four entries on
the same inputs give byte-identical outputs.

The engines are the cases of ``tests/test_native_build.py``, committed
through the reference's ``Storage``: versions, deletes and a rollback;
NULLs; unsigned values above 2^63; REAL; a wide row (17 columns, a map16
row header); rows spilled to CF_DEFAULT past the short-value limit; a
DECIMAL datum, which both refuse with the same error; and the flat-plane
parse in both schema and discovery mode.  The port's native rung
(``copr.region_cache._build_native``) is also held against the
reference's and against the port's interpreted rung on each engine.
"""

import numpy as np
import pytest

import tikv_tpu.copr.region_cache as rrc
import tikv_tpu.native as rnv
from tikv_tpu.datatype import FieldType as RefFieldType
from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.engine.traits import ALL_CFS, CF_WRITE
from tikv_tpu.kv.engine import LocalEngine
from tikv_tpu.server import wire
from tikv_tpu.sst_importer import fast_mvcc_table_sst as ref_fast_sst
from tikv_tpu.sst_importer import read_sst_cf as ref_read_sst_cf
from tikv_tpu.storage import Storage
from tikv_tpu.storage.txn import commands as cmds
from tikv_tpu.storage.txn.actions import Mutation
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import Table as RefTable
from tikv_tpu.testing.fixture import TableColumn as RefColumn
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch import convert
from tikv_tpu_torch import native as pnv
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.analyze import checksum_kv_pairs_plain

BIG = 10 ** 9


def ref_native():
    mod = rnv._mod
    if mod is None:
        pytest.skip("the reference's native module is not built")
    return mod


def commit(storage, ts, muts):
    storage.sched_txn_command(cmds.Prewrite(muts, muts[0].key, ts))
    storage.sched_txn_command(
        cmds.Commit([m.key for m in muts], ts, ts + 1))
    return ts + 10


def port_engine(ref, prefix: bytes = b""):
    """The port's ``MemoryEngine`` holding every record of ``ref``, each key
    behind ``prefix`` (``b"z"``: the data prefix a region snapshot reads
    under)."""
    snap = ref.snapshot()
    triples = []
    for cf in ALL_CFS:
        keys, vals, _skip = snap.range_cf(cf, b"", b"\xff" * 64)
        triples += [(cf, prefix + k, v) for k, v in zip(keys, vals)]
    return convert.engine_from_triples(triples)


def infos_of(table, port_side: bool):
    dag = RefDagSelect.from_table(table, [c.name for c in table.columns]) \
        .build()
    if port_side:
        dag = convert.dag_from_wire(wire.enc_dag(dag))
    return dag.executors[0].columns


def schema_of(table) -> tuple:
    """(col ids, native kinds) of the non-handle columns."""
    ids, kinds = [], []
    for c in table.columns:
        if c.is_pk_handle:
            continue
        et = c.field_type.eval_type.name
        kind = {"INT": 0, "REAL": 1, "BYTES": 2}[et]
        if kind == 0 and c.field_type.is_unsigned:
            kind = 3
        ids.append(c.col_id)
        kinds.append(kind)
    return tuple(ids), tuple(kinds)


def _pk():
    return RefColumn("id", 1, RefFieldType.long(not_null=True),
                     is_pk_handle=True)


def case_versions():
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = int_table(2, table_id=501)
    ts = commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h % 5, "c1": h})) for h in range(200)])
    ts = commit(storage, ts, [Mutation("put", *encode_table_row(
        table, h, {"c0": -h, "c1": None})) for h in range(0, 200, 3)])
    ts = commit(storage, ts, [Mutation(
        "delete", encode_table_row(table, h, {})[0], None)
        for h in range(0, 200, 7)])
    storage.sched_txn_command(cmds.Rollback(
        [encode_table_row(table, 1, {})[0]], ts))
    return eng, table


def case_spills():
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(502, (_pk(), RefColumn("c0", 2, RefFieldType.long()),
                           RefColumn("blob", 3, RefFieldType.var_char())))
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h, "blob": b"B" * 400 if h % 2 else b"s"}))
        for h in range(50)])
    return eng, table


def case_unsigned():
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(505, (_pk(), RefColumn("u", 2, RefFieldType.long(
        unsigned=True))))
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"u": (1 << 63) + h})) for h in range(20)])
    return eng, table


def case_real():
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(506, (_pk(), RefColumn("r", 2, RefFieldType.double()),
                           RefColumn("c", 3, RefFieldType.long())))
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"r": h * 0.25 - 3.0 if h % 4 else None, "c": -h}))
        for h in range(64)])
    return eng, table


def case_wide():
    """17 columns: the native SST builder's map16 row header, ingested."""
    n, ncols = 50, 17
    hs = np.arange(n, dtype=np.int64)
    blob = ref_fast_sst(4242, hs, [(2 + i, hs * (i + 1), None)
                                   for i in range(ncols)], commit_ts=100)
    eng = RefEngine()
    wb = eng.write_batch()
    for cf, (keys, vals) in ref_read_sst_cf(blob).items():
        wb.ingest_cf(cf, keys, vals)
    eng.write(wb)
    table = RefTable(4242, (_pk(),) + tuple(
        RefColumn(f"c{i}", 2 + i, RefFieldType.long())
        for i in range(ncols)))
    return eng, table


CASES = {"versions": case_versions, "spills": case_spills,
         "unsigned": case_unsigned, "real": case_real, "wide": case_wide}


def write_range(eng, table_id):
    from tikv_tpu.codec.keys import table_record_range
    from tikv_tpu.storage.txn_types import encode_key
    lo, hi = table_record_range(table_id)
    return eng.snapshot().range_cf(CF_WRITE, encode_key(lo), encode_key(hi))


def same_call(fn_name: str, *args):
    """Both modules' ``fn_name`` on ``args`` → the one output (raises
    unless they are equal, or both raise the same ValueError)."""
    ref = getattr(ref_native(), fn_name)
    port = getattr(pnv, fn_name)
    try:
        want = ref(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port(*args)
        assert str(got.value) == str(e)
        return None
    got = port(*args)
    assert got == want
    return got


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("read_ts", (15, 25, BIG))
def test_build_columnar_is_byte_identical(case, read_ts):
    eng, table = CASES[case]()
    keys, vals, skip = write_range(eng, table.table_id)
    ids, kinds = schema_of(table)
    out = same_call("mvcc_build_columnar", keys, vals, read_ts, skip, ids,
                    kinds)
    assert out is not None and out["safe_ts"] > 0
    if case == "spills" and read_ts == BIG:
        assert out["need_default"]
    # through a prefix the region snapshot adds (the data key's 'z')
    pkeys = [b"z" + k for k in keys]
    same_call("mvcc_build_columnar", pkeys, vals, read_ts, 1, ids, kinds)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ("schema", "discovery"))
def test_parse_planes_is_byte_identical(case, mode):
    eng, table = CASES[case]()
    keys, vals, skip = write_range(eng, table.table_id)
    ids, kinds = schema_of(table)
    if mode == "discovery":
        ids, kinds = (), ()
    elif 2 in kinds:
        # the plane parse takes numeric kinds only
        same_call("mvcc_parse_planes", keys, vals, skip, ids, kinds, False)
        keep = [i for i, k in enumerate(kinds) if k != 2]
        ids = tuple(ids[i] for i in keep)
        kinds = tuple(kinds[i] for i in keep)
    for release in (False, True):
        out = same_call("mvcc_parse_planes", keys, vals, skip, ids, kinds,
                        release)
        if case == "spills" and mode == "discovery":
            # a discovered BYTES datum has no plane: refused alike
            assert out is None
            continue
        assert out is not None and out["n_ver"] == len(keys)
        if case == "spills":
            assert out["need_default"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_checksum_pairs_is_byte_identical(case):
    eng, table = CASES[case]()
    keys, vals, _skip = write_range(eng, table.table_id)
    got = same_call("checksum_pairs", keys, vals)
    plain = checksum_kv_pairs_plain(keys, vals)
    assert got == (plain["checksum"], plain["total_bytes"])
    assert same_call("checksum_pairs", [], []) == (0, 0)


@pytest.mark.parametrize("shape", ("ints", "nulls", "floats", "wide",
                                   "empty"))
def test_build_mvcc_sst_is_byte_identical(shape):
    rng = np.random.default_rng(31)
    n = 0 if shape == "empty" else 300
    hs = np.sort(rng.choice(1 << 40, n, replace=False)).astype(np.int64)
    if shape == "wide":
        cols = [(2 + i, hs * (i + 1), None) for i in range(16)]
    elif shape == "floats":
        cols = [(2, rng.normal(size=n), None),
                (3, rng.integers(-5, 5, n), rng.random(n) < 0.5)]
    else:
        cols = [(2, rng.integers(-(1 << 62), 1 << 62, n),
                 rng.random(n) < 0.8 if shape == "nulls" else None),
                (3, hs % 1000, None)]
    ids = tuple(c for c, _v, _m in cols)
    kinds = tuple(1 if np.asarray(v).dtype.kind == "f" else 0
                  for _c, v, _m in cols)
    bufs = tuple(np.ascontiguousarray(
        v, dtype=np.float64 if k else np.int64).tobytes()
        for (_c, v, _m), k in zip(cols, kinds))
    valids = tuple(None if m is None else
                   np.ascontiguousarray(m, np.uint8).tobytes()
                   for _c, _v, m in cols)
    blob = same_call("build_mvcc_sst", 9, hs.tobytes(), ids, kinds, bufs,
                     valids, 500, 499)
    assert blob.startswith(b"TKVSST2\n")


def test_decimal_datum_is_refused_alike():
    """A DECIMAL datum (msgpack ExtType) is outside both modules' envelope:
    both raise the same ValueError, and the port's native rung declines a
    DECIMAL schema (the interpreted rung's work)."""
    from tikv_tpu.codec.row import encode_row as ref_encode_row
    from tikv_tpu.datatype.mydecimal import from_string
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(503, (_pk(), RefColumn("d", 2,
                                            RefFieldType.new_decimal())))
    key, _v = encode_table_row(table, 1, {})
    commit(storage, 10, [Mutation("put", key, ref_encode_row(
        {2: from_string("1.5")}))])
    keys, vals, skip = write_range(eng, 503)
    assert same_call("mvcc_build_columnar", keys, vals, BIG, skip, (2,),
                     (0,)) is None
    assert same_call("mvcc_parse_planes", keys, vals, skip, (2,), (0,),
                     False) is None
    infos = infos_of(table, True)
    assert prc._build_native(port_engine(eng).snapshot(), 503, infos,
                             BIG) is None
    assert rrc._build_native(eng.snapshot(), 503, infos_of(table, False),
                             BIG) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_rung_matches_reference_and_interpreted(case, monkeypatch):
    eng, table = CASES[case]()
    pe = port_engine(eng)
    pinfos, rinfos = infos_of(table, True), infos_of(table, False)
    for read_ts in (15, BIG):
        got = prc._build_native(pe.snapshot(), table.table_id, pinfos,
                                read_ts)
        want = rrc._build_native(eng.snapshot(), table.table_id, rinfos,
                                 read_ts)
        assert got is not None and want is not None
        assert got[1] == want[1]
        assert np.array_equal(got[0].handles, want[0].handles)
        for cid, col in want[0].columns.items():
            mine = got[0].columns[cid]
            assert np.array_equal(mine.validity, col.validity), cid
            assert list(mine.values[mine.validity]) == \
                list(col.values[col.validity]), cid
        # the interpreted rung (the native entry refusing) agrees
        monkeypatch.setattr(pnv, "mvcc_build_columnar", _refuse)
        tbl, safe, _locks = prc.build_region_columnar(
            pe.snapshot(), table.table_id, pinfos, read_ts)
        monkeypatch.undo()
        assert safe == got[1]
        assert np.array_equal(tbl.handles, got[0].handles)
        for cid, col in got[0].columns.items():
            mine = tbl.columns[cid]
            assert np.array_equal(mine.validity, col.validity), cid
            assert list(mine.values[mine.validity]) == \
                list(col.values[col.validity]), cid


def _refuse(*_args):
    raise ValueError("outside the envelope")


def test_build_is_keyed_by_source_and_command():
    """The library's name carries a digest of the source and the compile
    command; the command names the port's own source and nothing of the
    JAX package."""
    path = pnv.lib_path()
    assert path.parent == pnv.BUILD_DIR and path.suffix == ".so"
    cmd = pnv.compile_command("out.so")
    assert str(pnv.SRC) in cmd
    assert not any("tikv_tpu/" in part for part in cmd)
    assert pnv.module().checksum_pairs([b"a"], [b"b"]) == \
        pnv.checksum_pairs([b"a"], [b"b"])
