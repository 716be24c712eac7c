"""``sel_pred``: the selection evaluated inside one kernel pass, against the
JAX package's fused predicate pass and the port's torch route.

The same seeded predicates, built as expression trees in both packages,
go through the reference's ``build_mask_kernel`` (jax.numpy on the CPU,
its constants hoisted by its ``split_params``) and through the port's
encoder (``encode_predicate``), whose program ``sel_pred_plain`` runs op by
op in torch; and through the port's torch route (``eval_rpn``, then
``sel_mask_plain``).  The count and the packed mask must be equal bit for
bit.  Tables hold int32, int64 and float32 columns with NULLs, the int32
table also its extremes; REAL values are quarter steps, so float32
arithmetic is exact on every side.  Where an INT arithmetic call over
int32 operands could leave int32 the reference wraps (ROADMAP.md queue 3,
fault 5): those programs are held against the torch route only, and the
same RPNs narrowed by the columns' bounds (``narrow_int32``) exercise the
kernel's int32 arithmetic.

Beside them: each covered signature on its own, the encoder's constant
fusion and limits, the route a plan takes (chosen at analysis, counted in
``pred_routes``), configs 1, 2, 2s and 5t through the runner, fault 5's
inputs, and the wrapper's CPU-only plain version.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.datatype import EvalType as RefEvalType
from tikv_tpu.device import selection as ref_sm
from tikv_tpu.expr import Expr as RefExpr
from tikv_tpu.expr import build_rpn as ref_build_rpn

import torch

from tikv_tpu_torch.datatype import EvalType
from tikv_tpu_torch.device import selection as sm
from tikv_tpu_torch.device.runner import PRED_KERNEL, PRED_TORCH, \
    DeviceRunner
from tikv_tpu_torch.expr import Expr, build_rpn, eval_rpn
from tikv_tpu_torch.expr.eval import narrow_int32
from tikv_tpu_torch.testing import configs

from tests.test_torch_selection import (make_mixed, port_dag, port_snapshot,
                                        routes_of, run_three)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
# columns: a int32, b int64, r float32 (REAL)
COLS = (("a", "I"), ("b", "I"), ("r", "R"))
CMPS = ("Gt", "Ge", "Lt", "Le", "Eq", "Ne", "NullEq")


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def table(n: int, seed: int, extremes: bool):
    """Three NULL-bearing columns (NULL slots hold 0, as the feed's do)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, n).astype(np.int32)
    if extremes and n >= 4:
        a[rng.choice(n, min(n, 8), replace=False)] = rng.choice(
            [I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1], min(n, 8))
    b = rng.integers(-(1 << 33), 1 << 33, n).astype(np.int64)
    b[: n // 3] = rng.integers(-100, 100, n // 3)    # overlaps a's range
    r = (rng.integers(-400, 400, n) / 4.0).astype(np.float32)
    out = []
    for v in (a, b, r):
        ok = rng.random(n) > 0.15
        out.append((np.where(ok, v, 0).astype(v.dtype), ok))
    return out


# ------------------------------------------------ predicates as trees


def int_spec(rng, depth):
    roll = rng.random()
    if depth <= 0 or roll < 0.35:
        pick = rng.random()
        if pick < 0.55:
            return ("col", int(rng.integers(0, 2)))
        if pick < 0.95:
            return ("int", int(rng.integers(-120, 120)))
        return ("null", "I")
    if roll < 0.85:
        return (str(rng.choice(["Plus", "Minus", "Multiply"])) + "Int",
                int_spec(rng, depth - 1), int_spec(rng, depth - 1))
    return ("UnaryMinusInt", int_spec(rng, depth - 1))


def real_spec(rng, depth):
    roll = rng.random()
    if depth <= 0 or roll < 0.4:
        pick = rng.random()
        if pick < 0.55:
            return ("col", 2)
        if pick < 0.95:
            return ("real", float(rng.integers(-400, 400)) / 4.0)
        return ("null", "R")
    if roll < 0.85:
        return (str(rng.choice(["Plus", "Minus", "Multiply"])) + "Real",
                real_spec(rng, depth - 1), real_spec(rng, depth - 1))
    return ("UnaryMinusReal", real_spec(rng, depth - 1))


def bool_spec(rng, depth):
    roll = rng.random()
    real = rng.random() < 0.35
    sub = real_spec if real else int_spec
    t = "Real" if real else "Int"
    if depth <= 1 or roll < 0.45:
        return (str(rng.choice(CMPS)) + t, sub(rng, depth - 1),
                sub(rng, max(depth - 2, 0)))
    if roll < 0.7:
        return (str(rng.choice(["LogicalAnd", "LogicalOr", "LogicalXor"])),
                bool_spec(rng, depth - 1), bool_spec(rng, depth - 1))
    if roll < 0.85:
        fn = str(rng.choice(["UnaryNot", "IsNull"]))
        return (fn + t, sub(rng, depth - 1))
    if roll < 0.93:
        fn = str(rng.choice(["IsTrue", "IsFalse"]))
        return (t + fn, sub(rng, depth - 1))
    items = [("real", float(rng.integers(-400, 400)) / 4.0) if real else
             ("int", int(rng.integers(-100, 100)))
             for _ in range(int(rng.integers(1, 6)))]
    if rng.random() < 0.2:
        items.append(("null", "R" if real else "I"))
    return ("In" + t, sub(rng, 1), *items)


def build(spec, E, ET):
    """The spec as an expression tree of ``E`` (either package's Expr)."""
    kind = spec[0]
    if kind == "col":
        return E.column(spec[1], ET.REAL if COLS[spec[1]][1] == "R"
                        else ET.INT)
    if kind == "int":
        return E.const(spec[1], ET.INT)
    if kind == "real":
        return E.const(spec[1], ET.REAL)
    if kind == "null":
        return E.null(ET.REAL if spec[1] == "R" else ET.INT)
    return E.call(kind, *[build(c, E, ET) for c in spec[1:]])


def has_int_arith(spec) -> bool:
    return spec[0] in ("PlusInt", "MinusInt", "MultiplyInt",
                       "UnaryMinusInt") or any(
        isinstance(c, tuple) and has_int_arith(c) for c in spec[1:])


# ------------------------------------------------------ the three sides


def reference_mask(specs, cols, n):
    """(count, packed bytes) of the reference's fused predicate pass."""
    rpns = [ref_build_rpn(build(s, RefExpr, RefEvalType)) for s in specs]
    prpns, vals, dts = ref_sm.split_params(rpns, len(cols))
    n_pad = max(8, -(-n // 8) * 8)
    flat, flags = [], []
    for v, ok in cols:
        pad = np.zeros(n_pad, v.dtype)
        pad[:n] = v
        flat.append(jnp.asarray(pad))
        flags.append(True)
        okp = np.zeros(n_pad, bool)
        okp[:n] = ok
        flat.append(jnp.asarray(okp))
    kern = ref_sm.build_mask_kernel(prpns, tuple(flags), n_pad, len(flat),
                                    len(vals))
    params = [jnp.asarray(v, dtype=dt) for v, dt in zip(vals, dts)]
    count, packed, _mask = kern(jnp.asarray(n, jnp.int64), *params, *flat)
    return int(count), np.asarray(packed)[: -(-n // 8)]


def port_planes(cols):
    return [(torch.from_numpy(v), torch.from_numpy(ok)) for v, ok in cols]


def torch_route_mask(rpns, planes, n):
    """The runner's torch route: eval_rpn per RPN, valid & (v != 0)."""
    mask = torch.ones(n, dtype=torch.bool)
    for rpn in rpns:
        v, ok = eval_rpn(rpn, [(v[:n], ok[:n]) for v, ok in planes], n,
                         torch, "cpu")
        mask &= ok & (v != 0)
    return sm.sel_mask_plain(mask, n).host()


def kernel_mask(rpns, planes, n):
    prog = sm.encode_predicate(rpns, [v.dtype for v, _ok in planes])
    out, bools = sm.sel_pred(prog, planes, n, bools=True)
    count, packed = out.host()
    np.testing.assert_array_equal(np.packbits(bools.numpy()), packed)
    return count, packed


def bounds_of(cols):
    return [None if v.dtype.kind == "f" else
            (int(v.min()), int(v.max())) if v.size else (0, 0)
            for v, _ok in cols]


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 4095, 5000])
@pytest.mark.parametrize("extremes", [False, True])
def test_random_predicates_match_reference_and_torch_route(n, extremes):
    """Seeded predicates nested two or three deep, one or two selection
    RPNs each: the encoded program equals the reference's fused pass and
    the port's torch route in count and packed mask, bit for bit; so do
    the same RPNs narrowed by the columns' bounds."""
    rng = np.random.default_rng(n * 2 + int(extremes))
    cols = table(n, n + 11 * int(extremes), extremes)
    planes = port_planes(cols)
    covered = 0
    for _ in range(6):
        specs = [bool_spec(rng, int(rng.integers(2, 4)))
                 for _ in range(int(rng.integers(1, 3)))]
        rpns = [build_rpn(build(s, Expr, EvalType)) for s in specs]
        if sm.pred_covered(rpns):
            continue                  # past the program's limits
        covered += 1
        got = kernel_mask(rpns, planes, n)
        want = torch_route_mask(rpns, planes, n)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        narrowed = [narrow_int32(r, bounds_of(cols)) for r in rpns]
        got_n = kernel_mask(narrowed, planes, n)
        want_n = torch_route_mask(narrowed, planes, n)
        assert got_n[0] == want_n[0]
        np.testing.assert_array_equal(got_n[1], want_n[1])
        if extremes and any(has_int_arith(s) for s in specs):
            continue                  # the reference wraps (fault 5)
        ref = reference_mask(specs, cols, n)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
    assert covered >= 4


SIG_CASES = (
    [(c + t, ("col", 2 if t == "Real" else 0),
      ("real", 12.25) if t == "Real" else ("int", 7))
     for c in CMPS for t in ("Int", "Real")] +
    [(op + t, ("col", 2 if t == "Real" else 1),
      ("real", -3.5) if t == "Real" else ("col", 0))
     for op in ("Plus", "Minus", "Multiply") for t in ("Int", "Real")] +
    [("UnaryMinusInt", ("col", 0)), ("UnaryMinusReal", ("col", 2)),
     ("LogicalAnd", ("GtInt", ("col", 0), ("int", 0)), ("col", 1)),
     ("LogicalOr", ("LtReal", ("col", 2), ("real", 0.0)), ("col", 0)),
     ("LogicalXor", ("col", 0), ("col", 1)),
     ("UnaryNotInt", ("col", 0)), ("UnaryNotReal", ("col", 2)),
     ("IsNullInt", ("col", 1)), ("IsNullReal", ("col", 2)),
     ("IntIsTrue", ("col", 0)), ("RealIsTrue", ("col", 2)),
     ("IntIsFalse", ("col", 1)), ("RealIsFalse", ("col", 2)),
     ("InInt", ("col", 0), ("int", 3), ("int", -5), ("int", 0)),
     ("InInt", ("col", 1), ("int", 3), ("null", "I")),
     ("InReal", ("col", 2), ("real", 0.25), ("real", -99.75)),
     ("InReal", ("col", 2), ("null", "R"))])


@pytest.mark.parametrize("spec", SIG_CASES,
                         ids=[f"{c[0]}_{i}" for i, c in enumerate(SIG_CASES)])
def test_every_covered_signature(spec):
    """Each covered signature on its own (an arithmetic one under a
    comparison, a non-boolean one as the predicate itself), over a
    NULL-bearing table with the int32 extremes: covered, and equal to the
    torch route and (without int32 arithmetic) to the reference."""
    n = 3000
    cols = table(n, 5, True)
    if spec[0].startswith(("Plus", "Minus", "Multiply", "UnaryMinus")):
        spec = ("NeReal" if spec[0].endswith("Real") else "NeInt", spec,
                ("real", 0.5) if spec[0].endswith("Real") else ("int", 3))
    rpns = [build_rpn(build(spec, Expr, EvalType))]
    assert sm.pred_covered(rpns) == ""
    got = kernel_mask(rpns, port_planes(cols), n)
    want = torch_route_mask(rpns, port_planes(cols), n)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    if not has_int_arith(spec):
        ref = reference_mask([spec], cols, n)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])


# ----------------------------------------------------------- the encoder


def test_constants_ride_in_the_ops():
    """``v > 800``: the column, one compare with its constant, the keep;
    a constant on the left is pushed; int32 and int64 columns give int32
    and int64 arithmetic, narrowed calls int32."""
    rpn = build_rpn(Expr.column(0) > Expr.const(800, EvalType.INT))
    prog = sm.encode_predicate([rpn], [torch.int32])
    assert prog.ops == ((sm.OP_COL, 0, 0), (25, 0, 1), (sm.OP_KEEP["I"], 0,
                                                       0))
    assert prog.consts == ((800, False, False),) and prog.depth == 1
    assert not prog.wide and sm.encode_predicate([rpn], [torch.int64]).wide
    rpn = build_rpn(Expr.const(800, EvalType.INT) < Expr.column(0))
    prog = sm.encode_predicate([rpn], [torch.int32])
    assert [o for o, _a, _x in prog.ops] == [sm.OP_CONST, sm.OP_COL, 27, 48]
    assert prog.depth == 2
    plus = build_rpn((Expr.column(0) + Expr.column(1)) >
                     Expr.const(5, EvalType.INT))
    for dts, narrow, op in (([torch.int32] * 2, False, 17),
                            ([torch.int32] * 2, True, 16),
                            ([torch.int32, torch.int64], True, 17)):
        r = narrow_int32(plus, [(0, 9), (0, 9)]) if narrow else plus
        assert sm.encode_predicate([r], dts).ops[2] == (op, 0, 0)
    real = build_rpn(Expr.column(0, EvalType.REAL) >
                     Expr.const(0.1, EvalType.REAL))
    prog = sm.encode_predicate([real], [torch.float32])
    assert np.array([prog.consts[0][0]]).view(np.float64)[0] == \
        float(np.float32(0.1))


@pytest.mark.parametrize("case", ["function", "int_divide", "in_column",
                                  "long_in", "deep", "float64_plane",
                                  "mixed_types"])
def test_uncovered_programs(case):
    """Outside the covered set or past the limits: ``pred_covered`` says
    why and ``encode_predicate`` raises ``Uncovered``."""
    c0, c1 = Expr.column(0), Expr.column(1)
    dts = None
    if case == "function":
        e = Expr.call("Sqrt", Expr.column(0, EvalType.REAL)) > \
            Expr.const(1.0, EvalType.REAL)
    elif case == "int_divide":
        e = Expr.call("IntDivideInt", c0, c1) > Expr.const(1, EvalType.INT)
    elif case == "in_column":
        e = Expr.call("InInt", c0, c1, Expr.const(1, EvalType.INT))
    elif case == "long_in":
        e = Expr.call("InInt", c0, *[Expr.const(i, EvalType.INT)
                                     for i in range(sm.PRED_MAX_IN + 1)])
    elif case == "deep":
        # a right-leaning tree keeps every left operand on the stack
        e = c0
        for _ in range(4):
            e = c1 + (c0 * e)
        e = e > c0
    elif case == "float64_plane":
        e = Expr.column(0, EvalType.REAL) > Expr.const(1.0, EvalType.REAL)
        dts = [torch.float64]
    else:
        e = Expr.call("GtReal", c0, Expr.const(1.0, EvalType.REAL))
    rpns = [build_rpn(e)]
    if dts is None:
        assert sm.pred_covered(rpns) != ""
    with pytest.raises(sm.Uncovered):
        sm.encode_predicate(rpns, dts)


# ------------------------------------------------------------ the runner


def _sel_dag(table_, cond):
    from tikv_tpu.testing.dag import DagSelect
    s = DagSelect.from_table(table_, [c.name for c in table_.columns])
    return s.where(cond(s)).build()


def test_uncovered_signature_takes_the_torch_route():
    """A plan whose selection calls IntDivideInt keeps the torch route
    (eval_rpn, then sel_mask), chosen at analysis and counted; its answer
    equals the reference's and the host's, as does a covered plan's
    through sel_pred."""
    from tikv_tpu.device.runner import DeviceRunner as RefRunner
    from tikv_tpu.expr import Expr as RExpr
    from tikv_tpu.parallel import make_mesh
    ref = RefRunner(mesh=make_mesh(jax.devices()[:1]))
    port = DeviceRunner(device="cpu")
    tbl, snap = make_mixed(n=20_000, seed=41)
    psnap = port_snapshot(tbl, snap)
    cases = (
        (lambda s: RExpr.call("GtInt", RExpr.call(
            "IntDivideInt", s.col("a"), RExpr.const(7, RefEvalType.INT)),
            RExpr.const(9000, RefEvalType.INT)), PRED_TORCH),
        (lambda s: s.col("a") > 90_000, PRED_KERNEL))
    for cond, route in cases:
        dag = _sel_dag(tbl, cond)
        assert port._analyze(port_dag(dag))[0].sel_route == route
        before = dict(port.pred_routes)
        want, got, host = run_three(ref, port, dag, snap, psnap, reps=2)
        assert got == want == host and len(got) > 100
        assert {k: v - before.get(k, 0) for k, v in port.pred_routes.items()
                if v != before.get(k, 0)} == {route: 2}


@pytest.mark.parametrize("name", ["1", "2", "5t"])
def test_configs_serve_their_selection_through_sel_pred(name):
    """Configs 1, 2 and 5t at reduced size: every request's selection is
    evaluated by sel_pred, and every answer equals the numpy truth."""
    port = DeviceRunner(device="cpu")
    build_fn, make = configs.ROW_CONFIGS[name]
    tbl, snap = build_fn(40_000)
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    dag = dag_from_wire(enc_dag(make(tbl)))
    want = configs.row_truth_columns(name, snap)
    for _ in range(3):
        assert configs.columns_agree(port.handle_request(dag, snap).batch,
                                     want)
    assert port.pred_routes == {PRED_KERNEL: 3}


def test_sweep_serves_every_route_through_sel_pred():
    """Config 2s at 2^18 rows: its four selectivities answer as the truth
    once warm (at this size 0.1% and 1% take the compact route, 10% and
    50% the mask route), each request's selection evaluated by
    sel_pred."""
    port = DeviceRunner(device="cpu")
    n = 1 << 18
    _t, psnap = configs.build_table(n)
    routes = set()
    for frac in configs.SWEEP.values():
        thr = configs.sweep_threshold(psnap, frac)
        pdag = configs.dag_selection(configs.bench_table(), thr)
        truth = configs.row_truth("2s", psnap, thr)
        for _ in range(4):
            got, taken = routes_of(port, lambda: port.handle_request(
                pdag, psnap).rows())
            assert got == truth
        routes |= set(taken)
    assert routes == {"compact", "mask"}
    assert port.pred_routes == {PRED_KERNEL: 16}


def test_fault5_inputs_keep_the_host_answers():
    """ROADMAP.md queue 3, fault 5 (``test_reference_device_wraps_int_
    selection``'s inputs): ``k + 100 > 0`` over k = 2^31 - 10 keeps all
    1000 rows through sel_pred, whose int64 addition does not wrap."""
    from tikv_tpu.datatype import FieldType
    from tikv_tpu.executors.columnar import ColumnarTable
    from tikv_tpu.executors.runner import BatchExecutorsRunner
    from tikv_tpu.testing.dag import DagSelect
    from tikv_tpu.testing.fixture import Table, TableColumn
    n = 1000
    tbl = Table(9101, (TableColumn("id", 1, FieldType.long(not_null=True),
                                   is_pk_handle=True),
                       TableColumn("k", 2, FieldType.long()),
                       TableColumn("v", 3, FieldType.long())))
    snap = ColumnarTable.from_arrays(
        tbl, np.arange(n, dtype=np.int64),
        {"k": np.full(n, 2**31 - 10, np.int64),
         "v": np.arange(n, dtype=np.int64) % 7})
    s = DagSelect.from_table(tbl, ["id", "k", "v"])
    dag = s.where((s.col("k") + 100) > 0).build()
    port = DeviceRunner(device="cpu")
    pdag = port_dag(dag)
    assert port._analyze(pdag)[0].sel_route == PRED_KERNEL
    got = port.handle_request(pdag, port_snapshot(tbl, snap)).rows()
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert len(host) == n and got == host
    assert port.pred_routes == {PRED_KERNEL: 1}


# ------------------------------------------------------------ the wrapper


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    before = sm.pred_launches
    rpn = build_rpn(Expr.column(0) > Expr.const(0, EvalType.INT))
    prog = sm.encode_predicate([rpn], [torch.int32])
    v = torch.arange(-5, 5, dtype=torch.int32)
    out, bools = sm.sel_pred(prog, [(v, None)], 10, bools=True)
    assert out.host()[0] == 4 and bools.tolist() == [False] * 6 + [True] * 4
    assert sm.sel_pred(prog, [(v, None)], 10)[1] is None
    assert sm.pred_launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        sm.sel_pred(prog, [(v.to("meta"), None)], 10)
    with pytest.raises(ValueError, match="rows"):
        sm.sel_pred(prog, [(v, None)], 11)
    with pytest.raises(ValueError, match="expected one of"):
        sm.sel_pred(prog, [(v.to(torch.float64), None)], 10)
