"""The request memo carried across writes: the port's ``_refresh_meta``
against the reference's, field by field.

Both packages' runners serve the same plans over the same delta-maintained
cache lines (the rig of ``tests/test_torch_write_churn.py``) while one
history of writes lands: in-range UPDATEs, an UPDATE past the int32 range
of a narrowed plane, a GROUP BY key past the hash bounds, INSERTs past the
greatest handle, a DELETE.  After each write the first request of each plan
rolls its memo forward; the reference's ``_refresh_meta`` is wrapped to
record which of its derived constants survived (``dtypes``,
``hash_bounds`` — which carries the hash plan's byte-plane widths — and
``simple_arg_nbytes``), and the port's ``last_refresh`` must say the same
of ``dtypes``, ``hash_bounds`` and ``arg_nbytes``.  Every answer equals the
numpy model of the rows (the reference's answers are held to it too, but
where its fault 3 truncates an int64 sum).  A read below the memo's
version takes a memo of its own and leaves the shared one untouched.
"""

from __future__ import annotations

import pytest

import jax

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import int_table as ref_int_table

from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
from tikv_tpu_torch.testing.dag import DagSelect

from tests.test_torch_region_cache import TID, port_table
from tests.test_torch_write_churn import Churn, base

FIELDS = ("dtypes", "hash_bounds", "arg_nbytes")
PLANS = ("agg", "simple", "sel")


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:1]))


def plans(plan: str, ts: int):
    """(port dag, reference dag): "agg" GROUP BY c0: COUNT(*), SUM(c1);
    "simple" COUNT(*), SUM(c1); "sel" c1 > 990; "arith" GROUP BY c0:
    SUM(c1 * 3) (INT arithmetic the port narrows to int32 by the columns'
    bounds)."""
    out = []
    for table, Sel in ((port_table(), DagSelect),
                       (ref_int_table(2, table_id=TID), RefDagSelect)):
        s = Sel.from_table(table, ["id", "c0", "c1"])
        if plan == "sel":
            dag = s.where(s.col("c1") > 990)
        elif plan == "arith":
            dag = s.aggregate([s.col("c0")], [("sum", s.col("c1") * 3)])
        else:
            dag = s.aggregate([s.col("c0")] if plan == "agg" else [],
                              [("count_star", None), ("sum", s.col("c1"))])
        out.append(dag.build(ts))
    return out


def truth(rig: Churn, plan: str) -> list:
    if plan == "arith":
        agg: dict = {}
        for a, b in rig.model.values():
            agg.setdefault(a, None)
            if b is not None:
                agg[a] = (agg[a] or 0) + 3 * b
        return [(v, g) for g, v in agg.items()]
    if plan != "simple":
        return rig.truth(plan)
    vals = [b for _a, b in rig.model.values() if b is not None]
    return [(len(rig.model), sum(vals) if vals else None)]


class Memo(Churn):
    """``Churn`` with the reference's ``_refresh_meta`` recorded."""

    def __init__(self, ref_runner):
        super().__init__(ref_runner)
        self.ref_refreshes: list = []
        orig = RefRunner._refresh_meta

        def recorded(meta, lineage, plan, from_v, to_v):
            before = {k for k in ("dtypes", "hash_bounds",
                                  "simple_arg_nbytes") if k in meta}
            orig(ref_runner, meta, lineage, plan, from_v, to_v)
            self.ref_refreshes.append({
                k: "absent" if k not in before else
                "kept" if k in meta else "dropped" for k in
                ("dtypes", "hash_bounds", "simple_arg_nbytes")})
        ref_runner._refresh_meta = recorded

    def ask(self, plan: str, ts=None, ref_exact: bool = True) -> dict:
        """One request of ``plan`` through each endpoint → the port's
        refresh record (None: no roll-forward) and the reference's; the
        port's rows equal the model (at the newest ts)."""
        pd, rd = plans(plan, self.ts + 5 if ts is None else ts)
        self.prunner.last_refresh = None
        self.ref_refreshes.clear()
        presp = self.pep.handle(CopRequest(REQ_TYPE_DAG, pd))
        assert presp.backend == "device"
        rresp = self.rep.handle(RefRequest(REQ_TYPE_DAG, rd))
        prow = sorted(map(tuple, presp.rows()), key=repr)
        if ts is None:
            want = sorted(truth(self, plan), key=repr)
            assert prow == want, plan
            if ref_exact:
                assert sorted(map(tuple, rresp.rows()), key=repr) == want
        return {"port": self.prunner.last_refresh,
                "ref": self.ref_refreshes[-1] if self.ref_refreshes
                else None, "labels": dict(presp.tracker.labels)}


def same_decision(plan: str, got: dict) -> None:
    """The port's record of ``dtypes``, ``hash_bounds`` and ``arg_nbytes``
    equals the reference's ``dtypes``, ``hash_bounds`` and byte-plane
    widths (in ``hash_bounds`` for a hash plan, ``simple_arg_nbytes`` for a
    simple one)."""
    p, r = got["port"], got["ref"]
    assert p is not None and r is not None, plan
    widths = r["hash_bounds"] if plan == "agg" else r["simple_arg_nbytes"]
    assert (p["dtypes"], p["hash_bounds"], p["arg_nbytes"]) == \
        (r["dtypes"], r["hash_bounds"], widths), (plan, p, r)


# (write, the fields the port keeps after it a plan: None = every field
# present survives, "dropped" = every one drops)
HISTORY = [
    ("update in range", lambda rig: rig.put_rows({7: (3, 995)}),
     {"agg": None, "simple": None, "sel": None}),
    ("update past int32", lambda rig: rig.put_rows({8: (2, 1 << 40)}),
     {"agg": "dropped", "simple": "dropped", "sel": "dropped"}),
    ("key past the hash bounds", lambda rig: rig.put_rows({9: (77, 5)}),
     {"agg": "dropped", "simple": None, "sel": None}),
    ("inserts past the greatest handle", lambda rig: rig.put_rows(
        {h: (h % 5, 991) for h in range(3000, 3040)}),
     {"agg": None, "simple": None, "sel": None}),
    ("delete", lambda rig: rig.delete_rows([11]),
     {"agg": "dropped", "simple": "dropped", "sel": "dropped"}),
]


def test_memo_decisions_match_the_reference(ref_runner):
    rig = Memo(ref_runner)
    base(rig)
    for plan in PLANS:
        got = rig.ask(plan)
        assert got["port"] is None
    fault3 = False
    for name, write, expect in HISTORY:
        write(rig)
        fault3 = fault3 or name == "update past int32"
        for plan in PLANS:
            got = rig.ask(plan, ref_exact=not (fault3 and plan != "sel"))
            same_decision(plan, got)
            rec = got["port"]
            present = [k for k in FIELDS if rec[k] != "absent"]
            assert present, (name, plan)
            want = "dropped" if expect[plan] == "dropped" else "kept"
            assert {rec[k] for k in present} == {want}, (name, plan, rec)
            assert rec["kept"] is (want == "kept")
            assert got["labels"]["memo"] == want
            # the derived constants the port adds follow the same verdict
            for k in ("plan", "fold_bound", "order_bounds"):
                assert rec[k] in ("absent", want), (name, plan, k, rec)
        if name == "update past int32":
            # the violated int32 plane was not kept: the 2^40 value is in
            # the model the answers were held to
            assert rig.model[8] == (2, 1 << 40)
    assert rig.prunner.memo_routes == {"kept": 8, "dropped": 7}


def test_a_kept_int32_plane_never_takes_a_wider_value(ref_runner):
    """Were the int32 dtype kept past a value beyond it, the patch would
    write a wrapped value: the memo drops it, and the answer is exact."""
    rig = Memo(ref_runner)
    base(rig)
    rig.ask("simple")
    rig.put_rows({5: (0, (1 << 31) + 7)})
    got = rig.ask("simple", ref_exact=False)
    assert got["port"]["dtypes"] == "dropped"
    assert got["labels"]["device_feed"] == "upload"
    pent, _rent, _ = rig.get()
    keys = list(rig.prunner.resident_feeds(pent))
    assert any(k[1] == (3,) and k[2] == ("int64",) for k in keys), keys


def test_history_read_leaves_the_shared_memo(ref_runner):
    """A read below the memo's version is served from the line's history
    with a memo of its own: the shared memo keeps its version and fields,
    and the next current read rolls nothing."""
    rig = Memo(ref_runner)
    base(rig)
    old_ts = rig.ts + 5
    rig.put_rows({7: (3, 995)})
    rig.ask("agg")
    pent, rent, _ = rig.get()
    pd, rd = plans("agg", rig.ts + 5)
    key = ("meta", pd.plan_key(), pd.ranges)
    st = rig.prunner._bucket(pent)
    shared = dict(st[key])
    rmeta = ref_runner._arena.bucket(rent.feed_lineage)[
        ("meta", (rd.plan_key(), rd.ranges))]
    rshared = dict(rmeta)
    got = rig.ask("agg", ts=old_ts)
    assert got["port"] is None and got["ref"] is None
    assert st[key] == shared and st[key]["lineage_v"] == shared["lineage_v"]
    assert rmeta["lineage_v"] == rshared["lineage_v"]
    got = rig.ask("agg")
    assert got["port"] is None
    assert got["labels"]["device_feed"] == "hit"


def test_the_narrowing_follows_its_own_proof(ref_runner):
    """SUM(c1 * 3) is narrowed to int32 by c1's bounds [0, 999]: an update
    inside them keeps the narrowed plan; one past them (still an int32
    value, so the reference's fields all survive) drops it and the width of
    its computed argument, and the answer stays exact."""
    rig = Memo(ref_runner)
    base(rig)
    rig.ask("arith")
    st = rig.prunner._bucket(rig.get()[0])
    assert any(isinstance(k, tuple) and k[0] == "meta" and
               v.get("narrow_bounds") for k, v in st.items())
    rig.put_rows({7: (3, 995)})
    rec = rig.ask("arith")["port"]
    assert (rec["dtypes"], rec["hash_bounds"], rec["plan"],
            rec["arg_nbytes"]) == ("kept",) * 4
    rig.put_rows({8: (2, (1 << 30) + 5)})
    got = rig.ask("arith", ref_exact=False)
    rec = got["port"]
    assert (rec["dtypes"], rec["hash_bounds"]) == ("kept", "kept")
    assert (rec["plan"], rec["arg_nbytes"]) == ("dropped", "dropped")
    assert got["ref"]["dtypes"] == got["ref"]["hash_bounds"] == "kept"
