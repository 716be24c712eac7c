"""The port's device window (``device/window.py``, the plain version of
``csrc/window.cu``, behind ``DeviceJoiner.window``) against the JAX
package's ``DeviceJoiner.window`` on one CPU device.

The same seeded batch goes to both, with the six functions of
``tests/test_plan_ir.py:432-437`` (row_number, count, sum, avg, lag 2,
lead 1), with and without partitions, NULL-bearing INT and REAL
arguments, float partition keys with NaN and -0.0, and a REAL running
sum, which both return as None (it stays on the host).  Rows are compared
exactly (tolerance 0): integers, AVG as the same float64 division.
"""

import numpy as np
import pytest

import jax
import torch

from tikv_tpu.copr import plan_ir as rpir
from tikv_tpu.datatype import Column, ColumnBatch, EvalType, FieldType
from tikv_tpu.device.join import DeviceJoiner as RefJoiner
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire

from tikv_tpu_torch.copr import plan_ir as ppir
from tikv_tpu_torch.copr.wire import dec_expr
from tikv_tpu_torch.datatype import Column as PCol
from tikv_tpu_torch.datatype import ColumnBatch as PBatch
from tikv_tpu_torch.datatype import EvalType as PET
from tikv_tpu_torch.datatype import FieldType as PFT
from tikv_tpu_torch.device import sort as srt
from tikv_tpu_torch.device import window as win
from tikv_tpu_torch.device.runner import DeviceRunner


@pytest.fixture(scope="module")
def ref():
    return RefJoiner(RefRunner(mesh=make_mesh(jax.devices()[:1])))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu").joiner()


def batches(seed: int, n: int):
    """(reference batch, port batch): g INT, v INT, r REAL, f REAL keys."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, max(1, n // 30), n).astype(np.int64)
    v = rng.integers(-50, 50, n).astype(np.int64)
    r = rng.normal(0, 10, n)
    f = rng.integers(-3, 3, n) * 0.5
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.1] = -0.0
    cols = [(g, rng.random(n) > 0.1), (v, rng.random(n) > 0.2),
            (r, rng.random(n) > 0.2), (f, rng.random(n) > 0.1)]
    ets = ["int", "int", "real", "real"]
    rb = ColumnBatch([FieldType.long(), FieldType.long(), FieldType.double(),
                      FieldType.double()],
                     [Column(EvalType(e), x, ok)
                      for e, (x, ok) in zip(ets, cols)])
    pb = PBatch([PFT.long(), PFT.long(), PFT.double(), PFT.double()],
                [PCol(PET(e), x.copy(), ok.copy())
                 for e, (x, ok) in zip(ets, cols)])
    return rb, pb


def same_batch(got, want) -> bool:
    """Equal column by column: eval types, validity, and the values where
    valid (a NaN equals a NaN: the float key column carries them)."""
    if len(got.columns) != len(want.columns):
        return False
    for g, w in zip(got.columns, want.columns):
        if g.eval_type.value != w.eval_type.value or \
                not np.array_equal(g.validity, w.validity):
            return False
        m = w.validity
        if not np.array_equal(g.values[m], w.values[m],
                              equal_nan=g.values.dtype.kind == "f"):
            return False
    return True


def col(i, real=False):
    return Expr.column(i, EvalType.REAL if real else EvalType.INT)


SIX = (("row_number", None, 1), ("count", 1, 1), ("sum", 1, 1),
       ("avg", 1, 1), ("lag", 1, 2), ("lead", 1, 1))


def node_pair(parts, orders, funcs):
    """(reference WindowNode, the port's) over the scan of ``batches``."""
    def mk(pir, conv):
        return pir.WindowNode(
            None, tuple(conv(col(i, i >= 2)) for i in parts),
            tuple((conv(col(i, i >= 2)), d) for i, d in orders),
            tuple(pir.WindowFuncDesc(
                k, None if a is None else conv(col(a, a >= 2)), off)
                for k, a, off in funcs))
    return mk(rpir, lambda e: e), \
        mk(ppir, lambda e: dec_expr(wire.enc_expr(e)))


WINDOWS = {
    "part_g": ((0,), ((1, False),), SIX),
    "part_g_desc": ((0,), ((1, True), (2, False)), SIX),
    "no_part": ((), ((1, True),), SIX),
    "part_f": ((3,), ((1, False),), SIX),
    "part_gf": ((0, 3), ((2, True),), SIX),
    "keyless": ((), (), (("row_number", None, 1), ("sum", 1, 1))),
    "real_args": ((0,), ((1, False),), (("count", 2, 1), ("lag", 2, 1),
                                         ("lead", 2, 3))),
    "offsets": ((0,), ((1, False),), (("lag", 1, 5), ("lead", 1, 7),
                                      ("lag", 1, 40))),
    # past the kernel's halo (window.CAP rows): its second pass
    "far_offsets": ((0,), ((1, False),), (("lag", 1, 100), ("lead", 1, 65),
                                          ("lead", 2, 500), ("lag", 1, 1))),
}


@pytest.mark.parametrize("n", [0, 1, 1000, 1025])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_matches_reference(ref, port, name, n):
    rb, pb = batches(n + len(name), n)
    rnode, pnode = node_pair(*WINDOWS[name])
    want = ref.window(rb, rnode)
    got = port.window(pb, pnode)
    assert want is not None and got is not None
    assert same_batch(got, want)


def test_real_running_sum_stays_on_host(ref, port):
    rb, pb = batches(3, 200)
    for kind in ("sum", "avg"):
        rnode, pnode = node_pair((0,), ((1, False),), ((kind, 2, 1),))
        assert ref.window(rb, rnode) is None
        assert port.window(pb, pnode) is None


def test_window_scan_plain_edges():
    """The plain version on hand-checked rows: heads at key changes,
    segmented counts and sums, LAG / LEAD inside the segment only."""
    perm = torch.tensor([3, 0, 2, 1, 4], dtype=torch.int32)
    key = torch.tensor([1, 2, 1, 1, 2], dtype=torch.int64)   # view 1,1,1,2,2
    v = torch.tensor([10, 20, 30, 40, 50], dtype=torch.int64)
    ok = torch.tensor([True, True, False, True, True])
    rn, ch, sh = win.window_scan(perm, [key], True,
                                 [("count", None, ok), ("sum", v, ok)],
                                 [(-1, v, ok), (1, v, ok)])
    assert rn.tolist() == [1, 2, 3, 1, 2]
    assert ch[0].tolist() == [1, 2, 2, 1, 2]          # view v: 40,10,-,20,50
    assert ch[1].tolist() == [40, 50, 50, 20, 70]
    assert sh[0][0].tolist() == [0, 40, 10, 0, 20]
    assert sh[0][1].tolist() == [False, True, True, False, True]
    assert sh[1][0].tolist() == [10, 0, 0, 50, 0]
    assert sh[1][1].tolist() == [True, False, False, True, False]
    assert srt.sort_perm([key], 5).tolist() == [0, 2, 3, 1, 4]


def test_window_scan_checks_its_inputs():
    perm = torch.zeros(3, dtype=torch.int32)
    ok = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="kind"):
        win.window_scan(perm, [], False, [("max", None, ok)], [])
    with pytest.raises(ValueError, match="offset"):
        win.window_scan(perm, [], False, [],
                        [(0, torch.zeros(3, dtype=torch.int64), ok)])
    with pytest.raises(ValueError, match="int32"):
        win.window_scan(perm.to(torch.int64), [], False, [], [])


def test_plan_args_gathers_each_argument_once():
    """A COUNT rides with the sum or shift over its validity; a shift
    within CAP sets the halo on its side, one past CAP is served by the
    second pass over its argument's view-order copy."""
    v = torch.zeros(4, dtype=torch.int64)
    f = torch.zeros(4, dtype=torch.float64)
    ok, ok2 = torch.ones(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool)
    plan = win.plan_args(
        [("count", None, ok), ("sum", v, ok), ("count", None, ok2)],
        [(-2, v, ok), (1, v, ok), (win.CAP + 1, f, ok), (-win.CAP, f, ok)])
    assert [(a is None or a.data_ptr(), b.data_ptr())
            for a, b in plan["args"]] == [
        (v.data_ptr(), ok.data_ptr()), (f.data_ptr(), ok.data_ptr()),
        (True, ok2.data_ptr())]
    assert plan["ch_arg"] == [0, 0, 2] and plan["sh_arg"] == [0, 0, 1, 1]
    assert (plan["lag_halo"], plan["lead_halo"]) == (win.CAP, 1)
    assert plan["far"] == [1]
    bare = win.plan_args([("count", None, ok)], [])
    assert bare["ch_arg"] == [0] and bare["args"][0][0] is None
    assert (bare["lag_halo"], bare["lead_halo"], bare["far"]) == (0, 0, [])
