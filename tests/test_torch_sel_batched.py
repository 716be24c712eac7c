"""``sel_pred_batched``: a coalesced group's selections in one pass, against
the JAX package's stacked predicate pass.

The same seeded predicates, one per lane with the lane's own constants,
are built as expression trees in both packages.  The reference hoists
each lane's constants (``split_params``) and runs
``build_batched_mask_kernel`` (jax.numpy on the CPU, the constants as a
leading lane axis of its parameters); the port encodes each lane's
program (``encode_predicate``) and runs ``sel_pred_batched``, whose plain
version loops ``sel_pred_plain`` over the lanes.  Counts and packed masks
must be equal bit for bit (tolerance 0), for G of 1, 3, 16 and 17 lanes
and at the lane limit, over NULL-heavy planes, int32 extremes, int64 and
REAL constants, and n ending mid-word.  The terms route's arithmetic
(``selection.terms_model``: each lane and term an interval on order
images) equals the plain version, float specials included.  Beside them:
lanes that differ in more than their constants are refused
(``LanesDiffer``, and the runner's ``_BatchUnavailable``), and the wrapper
takes its plain version only on the CPU.
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
from tikv_tpu_torch.device.deferred import _BatchUnavailable
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.expr import Expr, build_rpn
from tikv_tpu_torch.testing import configs

from tests.test_torch_sel_pred import build

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def table(n: int, seed: int, null_share: float, extremes: bool):
    """a int32, b int64, r float32 (quarter steps: float32 exact); NULL
    slots hold 0, as the feed's do."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    if extremes:
        a[rng.choice(n, min(n, 16), replace=False)] = rng.choice(
            [I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1], min(n, 16))
    b = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    r = (rng.integers(-4000, 4000, n) / 4.0).astype(np.float32)
    out = []
    for v in (a, b, r):
        ok = rng.random(n) >= null_share
        out.append((np.where(ok, v, 0).astype(v.dtype), ok))
    return out


def shapes(rng, shape: str):
    """One lane's predicate of ``shape``: its specs, with fresh constants
    (each shape's constants keep one device dtype over every lane)."""
    def i32():
        return ("int", int(rng.integers(-1100, 1100)))

    if shape == "gt":
        return [("GtInt", ("col", 0), i32())]
    if shape == "extremes":
        c = int(rng.choice([I32_MIN, I32_MIN + 1, -1, 0, I32_MAX - 1,
                            I32_MAX]))
        return [("GeInt", ("col", 0), ("int", c))]
    if shape == "wide":
        lo = int(rng.integers(-(1 << 40), 1 << 39))
        return [("LogicalAnd",
                 ("GeInt", ("col", 1), ("int", lo)),
                 ("LtInt", ("col", 1), ("int", lo + (1 << 39))))]
    if shape == "real":
        return [("GtReal", ("col", 2),
                 ("real", float(rng.integers(-4000, 4000)) / 4.0))]
    if shape == "mixed":
        return [("LtInt", ("col", 0), i32()),
                ("LogicalOr", ("GtReal", ("col", 2),
                               ("real", float(rng.integers(-400, 400)) / 4)),
                 ("IsNullInt", ("col", 1)))]
    if shape == "in":
        return [("InInt", ("col", 0), i32(), i32(), i32())]
    if shape == "range":
        lo = int(rng.integers(-1100, 1000))
        return [("GeInt", ("col", 0), ("int", lo)),
                ("LtInt", ("col", 0), ("int", lo + 150))]
    if shape == "wide_terms":
        lo = int(rng.integers(-(1 << 40), 1 << 39))
        return [("GeInt", ("col", 1), ("int", lo)),
                ("LeInt", ("col", 1), ("int", lo + (1 << 39)))]
    if shape == "real_ne":
        return [("NeReal", ("col", 2),
                 ("real", float(rng.integers(-40, 40)) / 4.0)),
                ("LeReal", ("col", 2), ("real", 500.0))]
    raise ValueError(shape)


def reference_batched(lane_specs, cols, n):
    """(counts [G], packed [G, ceil(n/8)]) of build_batched_mask_kernel."""
    G = len(lane_specs)
    per_lane = []
    for specs in lane_specs:
        rpns = [ref_build_rpn(build(s, RefExpr, RefEvalType))
                for s in specs]
        per_lane.append(ref_sm.split_params(rpns, len(cols)))
    prpns, _vals, dts = per_lane[0]
    n_pad = max(8, -(-n // 8) * 8)
    flat, flags = [], []
    for v, ok in cols:
        pad = np.zeros(n_pad, v.dtype)
        pad[:n] = v
        okp = np.zeros(n_pad, bool)
        okp[:n] = ok
        flat += [jnp.asarray(pad), jnp.asarray(okp)]
        flags.append(True)
    kern = ref_sm.build_batched_mask_kernel(prpns, tuple(flags), n_pad,
                                            len(flat), len(dts), G)
    lanes = [jnp.asarray(np.asarray([p[1][pi] for p in per_lane],
                                    dtype=np.dtype(dt)))
             for pi, dt in enumerate(dts)]
    counts, packed = kern(jnp.asarray(n, jnp.int64), *lanes, *flat)
    return np.asarray(counts), np.asarray(packed)[:, :-(-n // 8)]


def port_programs(lane_specs, planes):
    dtypes = [v.dtype for v, _ok in planes]
    return [sm.encode_predicate([build_rpn(build(s, Expr, EvalType))
                                 for s in specs], dtypes)
            for specs in lane_specs]


def port_planes(cols):
    return [(torch.from_numpy(v), torch.from_numpy(ok)) for v, ok in cols]


def lanes_of(shape, G, seed):
    """G lanes of ``shape``; lanes 1 and 2 repeat lane 0's constants (equal
    lanes beside differing ones)."""
    rng = np.random.default_rng(seed)
    out = [shapes(rng, shape) for _ in range(G)]
    for g in (1, 2):
        if g < G - 1:
            out[g] = out[0]
    return out


@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("shape", ["gt", "extremes", "wide", "real",
                                   "mixed", "in"])
@pytest.mark.parametrize("n", [1, 13, 4096, 5003])
def test_lanes_match_the_reference_stacked_pass(G, shape, n):
    cols = table(n, 100 + n, 0.1, shape == "extremes")
    planes = port_planes(cols)
    lane_specs = lanes_of(shape, G, seed=n * 7 + G)
    progs = port_programs(lane_specs, planes)
    # "wide" and "mixed" read the int64 column: 64-bit payloads
    assert all(q.wide == (shape in ("wide", "mixed")) for q in progs)
    out = sm.sel_pred_batched(progs, planes, n)
    assert out.buf.numel() == 8 * G + G * out.lane_bytes
    counts, packed = sm.batched_host(out.buf.numpy(), G, n)
    want_c, want_p = reference_batched(lane_specs, cols, n)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(packed, want_p)
    # each lane is the solo kernel of its own program
    for g, q in enumerate(progs):
        solo_c, solo_p = sm.sel_pred(q, planes, n)[0].host()
        assert solo_c == counts[g]
        np.testing.assert_array_equal(solo_p, packed[g])
        # the lane's bytes past the n rows are 0
        assert int(out.packed(g)[-(-n // 8):].sum()) == 0


@pytest.mark.parametrize("null_share", [0.5, 0.9, 1.0])
def test_null_heavy_planes(null_share):
    n = 3001
    cols = table(n, 7, null_share, False)
    planes = port_planes(cols)
    lane_specs = lanes_of("mixed", 5, seed=11)
    progs = port_programs(lane_specs, planes)
    counts, packed = sm.batched_host(
        sm.sel_pred_batched(progs, planes, n).buf.numpy(), 5, n)
    want_c, want_p = reference_batched(lane_specs, cols, n)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(packed, want_p)


def test_lane_limit():
    n = 700
    cols = table(n, 3, 0.1, True)
    planes = port_planes(cols)
    lane_specs = lanes_of("gt", sm.BATCH_MAX_LANES, seed=5)
    progs = port_programs(lane_specs, planes)
    counts, packed = sm.batched_host(
        sm.sel_pred_batched(progs, planes, n).buf.numpy(), len(progs), n)
    want_c, want_p = reference_batched(lane_specs, cols, n)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(packed, want_p)
    with pytest.raises(sm.LanesDiffer, match="lanes"):
        sm.sel_pred_batched(progs + progs[:1], planes, n)


@pytest.mark.parametrize("other", ["structure", "width", "column"])
def test_lanes_that_differ_beyond_their_constants_are_refused(other):
    cols = table(64, 1, 0.1, False)
    planes = port_planes(cols)
    lead = [("GtInt", ("col", 0), ("int", 5))]
    second = {
        "structure": [("GeInt", ("col", 0), ("int", 5))],
        "width": [("GtInt", ("col", 0), ("int", 1 << 40))],
        "column": [("GtInt", ("col", 1), ("int", 5))]}[other]
    progs = port_programs([lead, second], planes)
    with pytest.raises(sm.LanesDiffer):
        sm.check_lanes(progs)
    with pytest.raises(sm.LanesDiffer):
        sm.sel_pred_batched(progs, planes, 64)


def test_runner_refuses_a_group_whose_programs_differ():
    """handle_batched encodes every member against the feed and raises
    _BatchUnavailable (the coalescer then retries each member solo) when
    one member's program differs beyond its constants."""
    table_, snap = configs.build_table(3000, 64)
    runner = DeviceRunner(device="cpu")
    a = configs.dag_selection(table_, 100)
    s = configs.DagSelect.from_table(table_, ["id", "k", "v"])
    b = s.where(s.col("v") < 100).build()
    with pytest.raises(_BatchUnavailable):
        runner.handle_batched([(a, snap), (b, snap)])
    # the same structure with other constants is one group
    c = configs.dag_selection(table_, 300)
    group = runner.handle_batched([(a, snap), (c, snap)])
    v = snap.columns[3].values
    for i, thr in enumerate((100, 300)):
        got = group.member_result(i)
        assert len(got.rows()) == int((v > thr).sum())


@pytest.mark.parametrize("shape,simple", [
    ("gt", True), ("extremes", True), ("real", True), ("wide", False),
    ("mixed", False), ("in", False), ("range", True), ("two_columns", False),
    ("null_const", True)])
def test_simple_terms(shape, simple):
    """The programs the kernel evaluates from registers: terms ``column
    <cmp> constant`` over one column; every other program takes the
    interpreter (the plain version is the same for both)."""
    cols = table(64, 4, 0.1, False)
    planes = port_planes(cols)
    rng = np.random.default_rng(3)
    specs = {
        "range": [("GeInt", ("col", 0), ("int", -5)),
                  ("LtInt", ("col", 0), ("int", 5))],
        "two_columns": [("GtInt", ("col", 0), ("int", 1)),
                        ("GtReal", ("col", 2), ("real", 1.5))],
        "null_const": [("GtInt", ("col", 0), ("null", "I"))],
    }.get(shape) or shapes(rng, shape)
    prog, = port_programs([specs], planes)
    assert sm.simple_terms(prog) == simple


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    cols = table(100, 2, 0.1, False)
    planes = [(torch.from_numpy(v).to("meta"), None) for v, _ok in cols]
    progs = port_programs(lanes_of("gt", 2, 1),
                          port_planes(cols))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sm.sel_pred_batched(progs, planes, 100)


# the terms route (csrc/sel_batched.cu): 32 rows a thread, one interval
# test a row, term and lane; n = 33 and 4127 end mid-word

@pytest.mark.parametrize("G", [1, 17, 64])
@pytest.mark.parametrize("shape", ["gt", "real", "range"])
@pytest.mark.parametrize("n", [33, 4127])
def test_plain_matches_the_reference_at_wide_groups(G, shape, n):
    cols = table(n, 300 + n, 0.1, False)
    planes = port_planes(cols)
    lane_specs = lanes_of(shape, G, seed=n + G)
    progs = port_programs(lane_specs, planes)
    counts, packed = sm.batched_host(
        sm.sel_pred_batched(progs, planes, n).buf.numpy(), G, n)
    want_c, want_p = reference_batched(lane_specs, cols, n)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(packed, want_p)


@pytest.mark.parametrize("G", [1, 17, 64])
@pytest.mark.parametrize("shape", ["gt", "extremes", "real", "range",
                                   "wide_terms", "real_ne"])
@pytest.mark.parametrize("n", [1, 33, 4127])
def test_terms_model_matches_the_plain_version(G, shape, n):
    """The terms kernel's arithmetic (``term_table``'s intervals over
    ``row_images``) gives the plain version's counts and masks bit for
    bit."""
    cols = table(n, 500 + n, 0.1, shape == "extremes")
    planes = port_planes(cols)
    progs = port_programs(lanes_of(shape, G, seed=n * 3 + G), planes)
    assert sm.terms_route(progs[0], planes)
    assert progs[0].wide == (shape == "wide_terms")
    want_c, want_p = sm.batched_host(
        sm.sel_pred_batched_plain(progs, planes, n).buf.numpy(), G, n)
    got_c, got_p = sm.terms_model(progs, planes, n)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("cmp", ["Gt", "Ge", "Lt", "Le", "Eq", "Ne"])
def test_terms_model_at_float_specials(cmp):
    """NaN, ±0.0, ±inf and the float32 extremes as rows and as constants,
    a NULL constant beside them: the interval of each comparison selects
    what the comparison selects (NaN only under Ne, -0.0 equal to
    +0.0)."""
    f32 = np.finfo(np.float32)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf,
                         f32.max, -f32.max, f32.tiny, -f32.tiny, 1.5,
                         -2.25], np.float32)
    n = 97
    rng = np.random.default_rng(17)
    r = specials[rng.integers(0, specials.size, n)]
    ok = rng.random(n) > 0.1
    cols = [(np.zeros(n, np.int32), ok), (np.zeros(n, np.int64), ok),
            (np.where(ok, r, np.float32(0)), ok)]
    planes = port_planes(cols)
    consts = [("real", float(c)) for c in specials] + [("null", "R")]
    lane_specs = [[(f"{cmp}Real", ("col", 2), c)] for c in consts]
    progs = port_programs(lane_specs, planes)
    assert sm.terms_route(progs[0], planes)
    G = len(progs)
    want_c, want_p = sm.batched_host(
        sm.sel_pred_batched_plain(progs, planes, n).buf.numpy(), G, n)
    got_c, got_p = sm.terms_model(progs, planes, n)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_p, want_p)


def test_terms_route_and_intervals():
    """Which programs take the terms kernel, and the intervals of the
    edges: a comparison no value passes selects nothing, Ne inverts."""
    cols = table(64, 4, 0.1, False)
    planes = port_planes(cols)
    rng = np.random.default_rng(9)
    for shape, want in (("gt", True), ("range", True), ("real", True),
                        ("wide_terms", True), ("wide", False),
                        ("mixed", False), ("in", False)):
        prog, = port_programs([shapes(rng, shape)], planes)
        assert sm.terms_route(prog, planes) == want, shape
    gt, lt, ne = (sm._CMP_OPS[k] for k in ("Gt", "Lt", "Ne"))
    assert sm.term_interval(gt, I32_MAX, False, False, False) == (0, 0, 0)
    assert sm.term_interval(lt, I32_MIN, False, False, False) == (0, 0, 0)
    assert sm.term_interval(gt, 5, True, False, False) == (0, 0, 0)
    lo, span, fl = sm.term_interval(ne, -1, False, False, True)
    assert (lo, span) == ((1 << 63) - 1, 0)
    assert fl == sm.TERM_IN | sm.TERM_INVERT


def test_params_mirror_the_kernel_structs():
    """``_TermsParams`` and ``_BatchParams`` name the fields of
    csrc/sel_batched.cu's ``struct TermsParams`` and csrc/selection.cu's
    ``struct BatchParams`` in order (the libraries check the sizes at
    load)."""
    import re
    from pathlib import Path
    csrc = Path(sm.__file__).parent.parent / "csrc"
    for src, struct, mirror in (("sel_batched.cu", "TermsParams",
                                 sm._TermsParams),
                                ("selection.cu", "BatchParams",
                                 sm._BatchParams)):
        body = re.search(rf"struct {struct} \{{(.*?)\n\}};",
                         (csrc / src).read_text(), re.S)[1]
        names = re.findall(r"(\w+)(?:\[\w+\])?;",
                           re.sub(r"//.*", "", body))
        assert names == [f[0] for f in mirror._fields_], struct
    assert "sel_batched" in __import__(
        "tikv_tpu_torch.device.build", fromlist=["SOURCES"]).SOURCES

