"""The port's compiled request fast path (``tikv_tpu_torch.server.fastpath``
and the fast leg of ``KvService.handle_raw``) against the JAX package's.

The codec first: ``_pack_int`` and ``_pack_scalar`` at every msgpack width
are byte-equal to ``tikv_tpu.server.fastpath``'s and to
``msgpack.packb(use_bin_type=True)``, ``_parse_scalar`` round-trips them,
and templates learned from the same request dicts — DAG, IndexScan and
plan bodies — have equal segments and slots in both packages; a structural
mismatch misses in both.

Then a pair of nodes in process, as ``test_torch_server.py`` runs them
(the reference's ``Node`` on JAX's CPU, the port's with a
``DeviceRunner(device="cpu")``, ``device_row_threshold=128``, each with
its fast path on), takes the same packed bytes through ``handle_raw``
with the same timestamps: rotating constants over a NULL-heavy table,
invalidation by a delta write, a split, an online config change and each
``copr::fastpath`` arm, deadline admission on the fast leg, and the
decode and plan tiers.  Every answer carries the reference's rows, and
after every case the port cache's ``stats()`` counts equal the
reference's (its ``config_gen`` counted from where each started: the
reference's node bumps it twice while it starts); over the hits' and the
invalidations' cases they moved as the reference's metrics counter did.
"""

import msgpack
import numpy as np
import pytest

from tikv_tpu.config import TikvConfig as RefConfig
from tikv_tpu.pd import MockPd as RefPd
from tikv_tpu.server import fastpath as ref_fp
from tikv_tpu.server import wire as ref_wire
from tikv_tpu.server.node import Node as RefNode
from tikv_tpu.server.service import KvService as RefService
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import (encode_table_row, index_entries,
                                      int_table, table_record_key)
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.config import TikvConfig
from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.pd.client import MockPd
from tikv_tpu_torch.server import fastpath as fp
from tikv_tpu_torch.server.node import Node
from tikv_tpu_torch.server.service import KvService
from tikv_tpu_torch.utils import failpoint

# ------------------------------------------------------------------ codec

INTS = [0, 1, 31, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2**31, -2**31 - 1, -2**63]
SCALARS = INTS + [0.0, 1.5, -0.25, float("inf"), 1e300, "", "x", "y" * 31,
                  "z" * 32, "w" * 255, "v" * 256, "u" * 65536, "é" * 20,
                  b"", b"b", b"c" * 255, b"d" * 256, b"e" * 65536, None,
                  True, False]


def _ids(vals):
    return [f"{type(v).__name__}{len(v) if isinstance(v, (str, bytes)) else v}"
            for v in vals]


@pytest.mark.parametrize("v", INTS, ids=_ids(INTS))
def test_pack_int_every_width(v):
    port, ref = bytearray(), bytearray()
    fp._pack_int(v, port)
    ref_fp._pack_int(v, ref)
    assert bytes(port) == bytes(ref) == msgpack.packb(v, use_bin_type=True)


@pytest.mark.parametrize("v", SCALARS, ids=_ids(SCALARS))
def test_pack_scalar_and_parse_round_trip(v):
    port, ref = bytearray(), bytearray()
    fp._pack_scalar(v, port)
    ref_fp._pack_scalar(v, ref)
    assert bytes(port) == bytes(ref) == msgpack.packb(v, use_bin_type=True)
    raw = bytes(port) + b"\x01"
    got = fp._parse_scalar(raw, 0)
    assert got == ref_fp._parse_scalar(raw, 0)
    assert got == (v, len(port)) and type(got[0]) is type(v)


def test_parse_scalar_refuses_containers_and_truncation():
    for v in ([1], {"k": 1}, [], {}):
        raw = msgpack.packb(v, use_bin_type=True)
        assert fp._parse_scalar(raw, 0) == ref_fp._parse_scalar(raw, 0)
        assert raw[0] < 0x80 or fp._parse_scalar(raw, 0) is None
    for v in (2**40, -2**40, 1.5, "x" * 40, b"y" * 300):
        raw = msgpack.packb(v, use_bin_type=True)
        for cut in range(1, len(raw)):
            assert fp._parse_scalar(raw[:cut], 0) is None
            assert ref_fp._parse_scalar(raw[:cut], 0) is None
    assert fp._parse_scalar(b"", 0) is None
    assert fp._parse_scalar(b"\xc1", 0) is None    # reserved


def test_pack_scalar_refuses_other_types():
    with pytest.raises(fp._Ineligible):
        fp._pack_scalar(np.int64(3), bytearray())
    with pytest.raises(ref_fp._Ineligible):
        ref_fp._pack_scalar(np.int64(3), bytearray())


TABLE = int_table(2, table_id=9801)
INDEXED = int_table(1, table_id=9802)


def _sel(table, thr, ts=7, cols=None):
    s = DagSelect.from_table(table, cols or [c.name for c in table.columns])
    return s.where(s.col("c1" if cols is None else cols[-1]) > thr) \
        .build(start_ts=ts)


def _agg(table, thr, ts=7):
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    return s.where(s.col("c1") > thr).aggregate(
        [s.col("c0")], [("count_star", None), ("sum", s.col("c1"))]) \
        .build(start_ts=ts)


def _topn(table, thr, ts=7):
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    return s.where(s.col("c1") > thr).order_by(s.col("c0"), desc=True) \
        .limit(5).build(start_ts=ts)


def _index(table, thr, ts=7):
    s = DagSelect.from_index(table, "c0", with_handle=True)
    return s.where(s.col("c0") > thr).build(start_ts=ts)


def _plan(table, thr, ts=7):
    from tikv_tpu.codec.keys import table_record_range
    from tikv_tpu.copr import plan_ir as pir
    from tikv_tpu.copr.dag import TableScanDesc
    from tikv_tpu.datatype import EvalType
    from tikv_tpu.executors.ranges import KeyRange
    from tikv_tpu.expr import Expr
    start, end = table_record_range(table.table_id)
    scan = pir.ScanNode(
        TableScanDesc(table.table_id, tuple(table.column_info(c.name)
                                            for c in table.columns)),
        (KeyRange(start, end),))
    return pir.PlanRequest(pir.SelectNode(scan, (
        Expr.column(2, EvalType.INT) > Expr.const(thr, EvalType.INT),)),
        start_ts=ts)


def _req(dag=None, plan=None, deadline_ms=None, trace_id=None, **extra):
    req = {"tp": 103, "force_backend": None, "paging_size": 0,
           "resume_token": None, "resource_group": "default",
           "request_source": "", **extra}
    if plan is not None:
        req["plan"] = ref_wire.enc_plan(plan)
    else:
        req["dag"] = ref_wire.enc_dag(dag)
    if deadline_ms is not None:
        req["deadline_ms"] = deadline_ms
    if trace_id is not None:
        req["trace_id"] = trace_id
    return req


def _template(mod, raw: bytes, body: str):
    req = msgpack.unpackb(raw, raw=False)
    marked, n = (mod._mark_slots if body == "dag"
                 else mod._mark_slots_plan)(req)
    segments, slots = mod._encode_segments(marked)
    tpl = mod.WireTemplate(segments, slots)
    assert tpl.render(mod._slot_originals(slots, req, body)) == raw
    return tpl, n


BODIES = {
    "selection": lambda thr, ts: _req(_sel(TABLE, thr, ts),
                                      deadline_ms=60_000, trace_id="t-1"),
    "groupby": lambda thr, ts: _req(_agg(TABLE, thr, ts)),
    "topn": lambda thr, ts: _req(_topn(TABLE, thr, ts), deadline_ms=10),
    "indexscan": lambda thr, ts: _req(_index(INDEXED, thr, ts)),
    "plan": lambda thr, ts: _req(plan=_plan(TABLE, thr, ts),
                                 deadline_ms=5000),
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_templates_equal_in_both_packages(body):
    """One request dict learns equal segments and slots in both packages,
    and a repeat at other constants, timestamps and deadlines matches
    both alike."""
    kind = "plan" if body == "plan" else "dag"
    raw = ref_wire.pack(BODIES[body](981, 12345))
    port, pn = _template(fp, raw, kind)
    ref, rn = _template(ref_fp, raw, kind)
    assert pn == rn
    assert port.segments == ref.segments
    assert [(s.kind, s.index, s.vtype, s.dtype) for s in port.slots] == \
        [(s.kind, s.index, s.vtype, s.dtype) for s in ref.slots]
    assert port.size_floor == ref.size_floor
    for thr, ts in ((5, 1), (127, 128), (-2**31, 2**40), (2**31 - 1,
                                                          2**63 - 1)):
        rep = ref_wire.pack(BODIES[body](thr, ts))
        assert port.match(rep) == ref.match(rep)
        if kind == "dag":
            assert port.match(rep) is not None, (thr, ts)


def test_structural_mismatches_miss():
    """Anything but a same-shape repeat misses, in both packages alike:
    another column, an extra condition, another table, another resource
    group, a dtype-bucket crossing, a missing deadline, a float for an
    int, a truncated body."""
    raw = ref_wire.pack(_req(_sel(TABLE, 50), deadline_ms=1000))
    port, _ = _template(fp, raw, "dag")
    ref, _ = _template(ref_fp, raw, "dag")
    s = DagSelect.from_table(TABLE, ["id", "c0", "c1"])
    other_col = s.where(s.col("c0") > 50).build(start_ts=7)
    s2 = DagSelect.from_table(TABLE, ["id", "c0", "c1"])
    two_conds = s2.where(s2.col("c1") > 50, s2.col("c0") > 1).build(7)
    sf = DagSelect.from_table(TABLE, ["id", "c0", "c1"])
    as_float = sf.where(sf.col("c1") > 50.5).build(start_ts=7)
    cases = [_req(other_col, deadline_ms=1000),
             _req(two_conds, deadline_ms=1000),
             _req(_sel(int_table(2, table_id=9803), 50), deadline_ms=1000),
             _req(_sel(TABLE, 50), deadline_ms=1000,
                  resource_group="other"),
             _req(_sel(TABLE, 2**40), deadline_ms=1000),
             _req(_sel(TABLE, 50)),
             _req(as_float, deadline_ms=1000)]
    for c in cases:
        b = ref_wire.pack(c)
        assert port.match(b) is None and ref.match(b) is None
    assert port.match(raw[:-3]) is None and ref.match(raw[:-3]) is None
    assert port.match(raw) == ref.match(raw) is not None


def test_dag_constructor_rebuilds_the_decoded_dag():
    """The precompiled constructor rebuilds what the full decode gives,
    for every rotating constant of a GROUP BY with a predicate."""
    learned = dag_from_wire(ref_wire.enc_dag(_agg(TABLE, 981, 5)))
    make = fp._dag_const_substituter(learned)
    for thr, ts in ((3, 9), (-70000, 2**50), (2**31 - 1, 1)):
        want = dag_from_wire(ref_wire.enc_dag(_agg(TABLE, thr, ts)))
        assert make([thr], ts) == want


def test_key_template_restamps_consts():
    d1 = dag_from_wire(ref_wire.enc_dag(_sel(TABLE, 10, 1)))
    d2 = dag_from_wire(ref_wire.enc_dag(_sel(TABLE, 77, 1)))
    key = ("share", 123, d1.plan_key(), d1.ranges)
    fill, n = fp._key_template(key)
    rfill, rn = ref_fp._key_template(key)
    assert n == rn == 1
    assert fill([77]) == rfill([77]) == ("share", 123, d2.plan_key(),
                                         d2.ranges)
    assert fill([10]) == key


@pytest.mark.parametrize("extra", [{"mystery": 1}, {"paging_size": 10},
                                   {"force_backend": "device"},
                                   {"resume_token": 3}, {"tp": 104},
                                   {"stale_read": True}],
                         ids=lambda e: next(iter(e)))
def test_learn_rejects_unknown_fields_and_options(extra):
    req = msgpack.unpackb(ref_wire.pack(_req(_sel(TABLE, 5))), raw=False)
    req.update(extra)
    with pytest.raises(fp._Ineligible):
        fp._mark_slots(req)
    with pytest.raises(ref_fp._Ineligible):
        ref_fp._mark_slots(req)


# ------------------------------------------------------- the node pair


def _ref_config():
    cfg = RefConfig()
    cfg.raftstore.region_split_size_mb = 10240
    cfg.raftstore.region_max_size_mb = 15360
    return cfg


def _port_config():
    cfg = TikvConfig()
    cfg.raftstore.region_split_size_mb = 10240
    cfg.raftstore.region_max_size_mb = 15360
    return cfg


@pytest.fixture(scope="module")
def pair():
    import jax

    from tikv_tpu.device.runner import DeviceRunner as RefRunner
    from tikv_tpu.parallel import make_mesh
    ref_pd = RefPd()
    ref = RefNode("ref:0", ref_pd, config=_ref_config(),
                  device_row_threshold=128,
                  device_runner=RefRunner(mesh=make_mesh(
                      jax.devices()[:1])))
    port = Node("port:0", MockPd(), config=_port_config(),
                device_row_threshold=128,
                device_runner=DeviceRunner(device="cpu"))
    ref.start()
    port.start()
    gen0 = (ref.fastpath.config_gen, port.fastpath.config_gen)
    try:
        yield {"ref": RefService(ref), "port": KvService(port),
               "tso": ref_pd.tso, "ref_node": ref, "port_node": port,
               "gen0": gen0}
    finally:
        port.stop()
        ref.stop()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


def _unpack(out):
    return msgpack.unpackb(out, raw=False) if isinstance(out, bytes) \
        else out


def ask(pair, req: dict):
    """The same packed request to both services' ``handle_raw`` →
    (reference's response, port's); rows or error kinds equal."""
    raw = ref_wire.pack(req)
    r = _unpack(pair["ref"].handle_raw("Coprocessor", raw))
    p = _unpack(pair["port"].handle_raw("Coprocessor", raw))
    if r.get("error") or p.get("error"):
        assert (p.get("error") or {}).get("kind") == \
            (r.get("error") or {}).get("kind"), (r, p)
    else:
        assert p["rows"] == r["rows"], req
        assert p["backend"] == r["backend"]
    return r, p


def same_stats(pair) -> dict:
    """The two caches' counts, equal but for where config_gen started."""
    r = pair["ref_node"].fastpath.stats()
    p = pair["port_node"].fastpath.stats()
    gr, gp = pair["gen0"]
    assert r["config_gen"] - gr == p["config_gen"] - gp, (r, p)
    assert {k: v for k, v in p.items() if k != "config_gen"} == \
        {k: v for k, v in r.items() if k != "config_gen"}, (r, p)
    return p


def ref_counter() -> dict:
    """The reference's metrics counter of fast-path outcomes →
    {(outcome, reason): count}."""
    from tikv_tpu.utils.metrics import COPR_FASTPATH_COUNTER
    return {k: c.value for k, c in
            list(COPR_FASTPATH_COUNTER._children.items())}


def counter_matches(before: dict, st0: dict, st: dict) -> None:
    """The reference's counter moved by what the port's ``stats()`` did:
    each "outcome:reason" count, and ``learned`` as its ("learn", "ok")."""
    after = ref_counter()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    want = {tuple(k.split(":", 1)): v - st0["reasons"].get(k, 0)
            for k, v in st["reasons"].items()
            if v != st0["reasons"].get(k, 0)}
    if st["learned"] != st0["learned"]:
        want[("learn", "ok")] = st["learned"] - st0["learned"]
    assert moved == want, (moved, want)


def load(pair, table, rows, extra=()):
    start = pair["tso"]()
    muts = [{"op": "put", "key": k, "value": v}
            for k, v in (encode_table_row(table, h, row) for h, row in rows)]
    muts += [{"op": o, "key": k, "value": v} for o, k, v in extra]
    for svc in ("ref", "port"):
        r = pair[svc].handle("KvPrewrite", {
            "mutations": muts, "primary": muts[0]["key"],
            "start_version": start})
        assert not r.get("error"), r
    commit = pair["tso"]()
    for svc in ("ref", "port"):
        r = pair[svc].handle("KvCommit", {
            "keys": [m["key"] for m in muts], "start_version": start,
            "commit_version": commit})
        assert not r.get("error"), r


def both_arm(name: str, actions: str) -> None:
    failpoint.cfg(name, actions)
    ref_failpoint.cfg(name, actions)


def test_hits_answer_with_reference_rows(pair):
    """Rotating constants over a NULL-heavy table: the first request of
    each shape learns, the repeats hit, and every hit answers with the
    reference's rows — held also against the port's own full decode
    (the failpoint's miss arm) of the same request."""
    table = int_table(2, table_id=9811)
    rng = np.random.default_rng(0)
    rows = []
    for h in range(1500):
        row = {}
        if rng.random() > 0.5:
            row["c0"] = int(rng.integers(-50, 50))
        if rng.random() > 0.2:
            row["c1"] = int(rng.integers(-1000, 1000))
        rows.append((h, row))
    load(pair, table, rows)
    counter0, learn0 = ref_counter(), same_stats(pair)
    ask(pair, _req(_sel(table, 0, pair["tso"]()), deadline_ms=60_000))
    ask(pair, _req(_agg(table, 0, pair["tso"]())))
    st0 = same_stats(pair)
    for thr in rng.integers(-900, 900, 6).tolist():
        _, fast = ask(pair, _req(_sel(table, thr, pair["tso"]()),
                                 deadline_ms=60_000))
        assert fast["time_detail"]["labels"].get("fastpath") == "hit"
        assert fast["backend"] == "device"
        both_arm("copr::fastpath", "1*return(miss)")
        _, slow = ask(pair, _req(_sel(table, thr, pair["tso"]()),
                                 deadline_ms=60_000))
        assert "fastpath" not in slow["time_detail"]["labels"]
        assert slow["rows"] == fast["rows"]
        _, agg = ask(pair, _req(_agg(table, thr, pair["tso"]())))
        assert agg["time_detail"]["labels"].get("fastpath") == "hit"
    st = same_stats(pair)
    assert st["hit"] - st0["hit"] == 12 and st["tiers"]["dispatch"] >= 2
    counter_matches(counter0, learn0, st)


def test_invalidation_never_serves_stale(pair):
    """Each staleness source invalidates the learned class — a delta
    write, an online config change, a region split (epoch) — and every
    answer after it reflects the current data, as the reference's."""
    table = int_table(2, table_id=9812)
    load(pair, table, [(h, {"c0": h % 7, "c1": h % 100})
                       for h in range(1200)])

    def q():
        return _req(_sel(table, 50, pair["tso"]()), deadline_ms=60_000)

    counter0, st0 = ref_counter(), same_stats(pair)
    ask(pair, q())
    _, r0 = ask(pair, q())
    assert r0["time_detail"]["labels"]["fastpath"] == "hit"
    # a delta write: the very next answer holds it
    load(pair, table, [(50_000, {"c0": 1, "c1": 99})])
    _, r1 = ask(pair, q())
    assert len(r1["rows"]) == len(r0["rows"]) + 1
    st = same_stats(pair)
    assert st["reasons"].get("invalidate:generation", 0) >= 1, st
    ask(pair, q())      # re-learn
    _, r2 = ask(pair, q())
    assert r2["time_detail"]["labels"]["fastpath"] == "hit"
    # an online config change retires every class
    for node in ("ref_node", "port_node"):
        pair[node].config_controller.update(
            {"coprocessor.device_row_threshold": 128})
    _, r3 = ask(pair, q())
    assert "fastpath" not in r3["time_detail"]["labels"]
    st = same_stats(pair)
    assert st["reasons"].get("invalidate:config", 0) >= 1, st
    ask(pair, q())
    # a split: the epoch in the learned key moves
    split_key = table_record_key(table.table_id, 600)
    for svc in ("ref", "port"):
        r = pair[svc].handle("SplitRegion", {"split_key": split_key})
        assert not r.get("error"), r
    # the request routes by its first key: the left region's rows only,
    # never the pre-split line's
    _, r4 = ask(pair, q())
    assert r4["rows"] == [r for r in r2["rows"] if r[0] < 600]
    ask(pair, q())
    _, r5 = ask(pair, q())
    assert r5["time_detail"]["labels"]["fastpath"] == "hit"
    assert r5["rows"] == r4["rows"]
    counter_matches(counter0, st0, same_stats(pair))


@pytest.mark.parametrize("arm", ["miss", "full", "corrupt"])
def test_failpoint_arms_never_wrong(pair, arm):
    """Each ``copr::fastpath`` arm takes the full decode with the same
    answer; the corrupt arm flips a byte of the hottest template, which
    can then only miss and re-learn."""
    table = int_table(2, table_id=9813 + ["miss", "full",
                                          "corrupt"].index(arm))
    load(pair, table, [(h, {"c0": h % 3, "c1": h % 40})
                       for h in range(600)])

    def q():
        return _req(_sel(table, 7, pair["tso"]()))

    ask(pair, q())
    _, control = ask(pair, q())
    both_arm("copr::fastpath", f"1*return({arm})")
    _, got = ask(pair, q())
    assert got["rows"] == control["rows"]
    assert "fastpath" not in got["time_detail"]["labels"]
    _, healed = ask(pair, q())
    assert healed["rows"] == control["rows"]
    st = same_stats(pair)
    assert st["reasons"].get(f"bypass:failpoint_{arm}", 0) >= 1


def test_deadline_admission_on_the_fast_leg(pair):
    """A hit whose budget is spent sheds at admission with the typed
    error, on the fast leg (it counts no hit), in both packages."""
    table = int_table(2, table_id=9817)
    load(pair, table, [(h, {"c0": 1, "c1": h % 10}) for h in range(400)])
    ask(pair, _req(_sel(table, 1, pair["tso"]()), deadline_ms=30_000))
    hit0 = same_stats(pair)["hit"]
    r, p = ask(pair, _req(_sel(table, 2, pair["tso"]()), deadline_ms=0))
    assert p["error"]["kind"] == "deadline_exceeded"
    assert p["time_detail"]["labels"]["fastpath"] == "hit"
    _, ok = ask(pair, _req(_sel(table, 3, pair["tso"]()),
                           deadline_ms=30_000))
    assert same_stats(pair)["hit"] == hit0 + 1


def test_decode_tier_indexscan(pair):
    """An IndexScan class is served on the host: it learns a DECODE-tier
    template, whose hits replay the full serving ceremony (a write is
    visible with no invalidation)."""
    table = int_table(1, table_id=9818)
    extra = []
    rows = []
    for h in range(500):
        row = {"c0": (h * 7) % 300 - 150}
        rows.append((h, row))
        extra += [("put", k, v) for k, v in index_entries(table, h, row)]
    load(pair, table, rows, extra)
    ask(pair, _req(_index(table, 0, pair["tso"]())))
    assert same_stats(pair)["tiers"].get("decode") == 1
    for thr in (-100, 57, 120):
        _, p = ask(pair, _req(_index(table, thr, pair["tso"]())))
        assert p["time_detail"]["labels"]["fastpath"] == "decode"
        assert p["rows"]
    row = {"c0": 149}
    k, v = encode_table_row(table, 900, row)
    load(pair, table, [], [("put", k, v)] + [
        ("put", ik, iv) for ik, iv in index_entries(table, 900, row)])
    _, p = ask(pair, _req(_index(table, 148, pair["tso"]())))
    assert p["time_detail"]["labels"]["fastpath"] == "decode"
    assert [900] in [list(r)[-1:] for r in p["rows"]]
    same_stats(pair)


def test_plan_tier(pair):
    """A plan-IR class learns a PLAN-tier template (constants are class
    identity, only the TSO rotates): repeats hit; another constant is a
    sibling class."""
    table = int_table(2, table_id=9819)
    load(pair, table, [(h, {"c0": h % 97, "c1": (h * 31) % 500 - 250})
                       for h in range(1200)])
    ask(pair, _req(plan=_plan(table, 40, pair["tso"]()), deadline_ms=30_000))
    for _ in range(3):
        _, p = ask(pair, _req(plan=_plan(table, 40, pair["tso"]()),
                              deadline_ms=30_000))
        assert p["time_detail"]["labels"]["fastpath"] == "plan"
        assert p["rows"]
    _, other = ask(pair, _req(plan=_plan(table, -10, pair["tso"]()),
                              deadline_ms=30_000))
    assert len(other["rows"]) > len(p["rows"])
    st = same_stats(pair)
    assert st["tiers"].get("plan") == 2


def test_health_carries_the_fastpath_block(pair):
    from tikv_tpu_torch.server.status_server import health
    body = health(pair["port_node"])
    assert body["fastpath"]["learned"] >= 1
    assert set(body["fastpath"]["pinned_readback"]) >= {"staged",
                                                        "pooled"}
    assert body["replica_serving"]["replica_reads"] == 0


def test_fastpath_classes_online(pair):
    """``coprocessor.fastpath_classes`` is online: 0 turns the fast path
    off (every request takes the full decode and learns nothing), and a
    capacity back on re-learns."""
    node = pair["port_node"]
    table = int_table(2, table_id=9820)
    load(pair, table, [(h, {"c0": h % 5, "c1": h % 50}) for h in range(300)])
    for n in ("ref_node", "port_node"):
        pair[n].config_controller.update({"coprocessor.fastpath_classes": 0})
    ask(pair, _req(_sel(table, 5, pair["tso"]())))
    _, p = ask(pair, _req(_sel(table, 6, pair["tso"]())))
    assert "fastpath" not in p["time_detail"]["labels"]
    assert node.fastpath.stats()["classes"] == 0
    for n in ("ref_node", "port_node"):
        pair[n].config_controller.update({"coprocessor.fastpath_classes": 64})
    ask(pair, _req(_sel(table, 5, pair["tso"]())))
    _, p = ask(pair, _req(_sel(table, 6, pair["tso"]())))
    assert p["time_detail"]["labels"]["fastpath"] == "hit"
    same_stats(pair)
