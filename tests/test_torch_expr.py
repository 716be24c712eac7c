"""Every function of the port's registry against the reference's.

Each signature runs over the same seeded NULL-bearing columns through the
reference evaluator (jax.numpy with x64, the device path; numpy, the host
path) and through the port's (torch on the CPU; numpy).  Values must be
equal where valid, validity and dtypes identical — exactly, since the
inputs are small integers and quarter-step floats whose float32 results
are exact on both sides.  ``wide_const`` puts an int64 constant beside an
int32 column, where torch's weak 0-d scalars would otherwise wrap it.

Two exceptions: the float32 transcendental functions of the math family
(``LIBM``) come from two libm implementations (XLA's and torch's), which
round some results differently; on the device path they must agree within
4 ulp.  The float64 host path stays exact.  And the INT arithmetic
signatures (``RpnFnMeta.int64``) evaluate int32 columns in int64 on the
port's device path, where the reference's wraps at int32 (ROADMAP.md
queue 3, fault 5): their values must be equal (these inputs do not wrap),
their dtype int64; ``test_int_arithmetic_does_not_wrap`` pins the inputs
that wrap.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.datatype import EvalType
from tikv_tpu.expr import Expr as RefExpr
from tikv_tpu.expr import FUNCTIONS as REF_FUNCTIONS
from tikv_tpu.expr import build_rpn as ref_build_rpn
from tikv_tpu.expr import eval_rpn as ref_eval_rpn

import torch

from tikv_tpu_torch.expr import FUNCTIONS, Expr, build_rpn, eval_rpn
from tikv_tpu_torch.datatype import EvalType as PortEvalType

N = 257
WIDE = 2**40 + 3
LIBM = {"Exp", "Ln", "Log2", "Log10", "Sin", "Cos", "Tan", "Cot", "Asin",
        "Acos", "Atan1Arg", "Atan2Args", "Pow"}


def _variants():
    out = []
    for name in sorted(FUNCTIONS):
        meta = FUNCTIONS[name]
        out.append((name, "device"))
        out.append((name, "host"))
        if meta.arity == 2 and [a.value for a in meta.args] == ["int", "int"]:
            out.append((name, "wide_const"))
    return out


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def _columns(arg_types, seed, host):
    rng = np.random.default_rng(seed)
    cols = []
    for et in arg_types:
        if et == "int":
            v = rng.integers(-20, 21, N)
            v = v.astype(np.int64 if host else np.int32)
        else:
            v = (rng.integers(-24, 25, N) / 4.0)
            v = v.astype(np.float64 if host else np.float32)
        ok = rng.random(N) > 0.15
        cols.append((np.where(ok, v, 0).astype(v.dtype), ok))
    return cols


@pytest.mark.parametrize("sig,variant", _variants())
def test_function_matches_reference(sig, variant):
    meta = FUNCTIONS[sig]
    ref_meta = REF_FUNCTIONS[sig]
    assert ref_meta.device_safe
    assert [a.value for a in meta.args] == [a.value for a in ref_meta.args]
    assert meta.ret.value == ref_meta.ret.value
    arity = meta.arity if meta.arity is not None else 3
    types = [meta.args[min(i, len(meta.args) - 1)].value
             for i in range(arity)]
    n_cols = arity - (1 if variant == "wide_const" else 0)
    cols = _columns(types[:n_cols], hash(sig) % 2**32, variant == "host")

    def tree(ExprCls, et_of):
        children = [ExprCls.column(i, et_of(types[i])) for i in range(n_cols)]
        if variant == "wide_const":
            children.append(ExprCls.const(WIDE, et_of("int")))
        return ExprCls.call(sig, *children)

    ref_rpn = ref_build_rpn(tree(RefExpr, EvalType))
    port_rpn = build_rpn(tree(Expr, PortEvalType))
    if variant == "host":
        want = ref_eval_rpn(ref_rpn, cols, N, np)
        got = eval_rpn(port_rpn, cols, N, np)
        got = tuple(np.asarray(x) for x in got)
    else:
        want = ref_eval_rpn(ref_rpn, [(jnp.asarray(v), jnp.asarray(m))
                                      for v, m in cols], N, jnp)
        got = eval_rpn(port_rpn, [(torch.from_numpy(v), torch.from_numpy(m))
                                  for v, m in cols], N, torch, "cpu")
        got = tuple(x.numpy() for x in got)
    want = tuple(np.asarray(x) for x in want)
    if meta.int64 and variant == "device":
        assert got[0].dtype == np.int64
        want = (want[0].astype(np.int64), want[1])
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[1], want[1])
    valid = want[1]
    if sig in LIBM and variant == "device":
        np.testing.assert_array_max_ulp(got[0][valid], want[0][valid], 4)
    else:
        np.testing.assert_array_equal(got[0][valid], want[0][valid])


@pytest.mark.parametrize("sig", ["PlusInt", "MinusInt", "MultiplyInt",
                                 "UnaryMinusInt"])
def test_int_arithmetic_does_not_wrap(sig):
    """ROADMAP.md queue 3, fault 5: over an int32 column of 2^31 - 10 the
    reference's device path wraps at int32; the port's gives the int64
    answer of the host (numpy over int64), and keeps int32 only where the
    column bounds prove it exact (``narrow_int32``)."""
    from tikv_tpu_torch.expr.eval import narrow_int32
    big = np.full(N, 2**31 - 10, dtype=np.int32)
    ok = np.ones(N, dtype=bool)
    arity = FUNCTIONS[sig].arity
    const = {"PlusInt": 100, "MinusInt": -100, "MultiplyInt": 3}.get(sig)

    def tree(ExprCls, et):
        return ExprCls.call(sig, *[ExprCls.column(0, et)] + (
            [ExprCls.const(const, et)] if arity == 2 else []))

    ref_rpn = ref_build_rpn(tree(RefExpr, EvalType.INT))
    port_rpn = build_rpn(tree(Expr, PortEvalType.INT))
    host = ref_eval_rpn(ref_rpn, [(big.astype(np.int64), ok)], N, np)[0]
    ref_dev = np.asarray(ref_eval_rpn(ref_rpn, [(jnp.asarray(big),
                                                 jnp.asarray(ok))], N,
                                      jnp)[0])
    got = eval_rpn(port_rpn, [(torch.from_numpy(big), torch.from_numpy(ok))],
                   N, torch, "cpu")[0].numpy()
    if sig != "UnaryMinusInt":      # -(2^31 - 10) fits: nothing wraps
        assert not np.array_equal(ref_dev.astype(np.int64), host)
    np.testing.assert_array_equal(got, host)
    assert got.dtype == np.int64
    # bounds that fit int32 keep the call in int32, exactly
    small = np.full(N, 1000, dtype=np.int32)
    narrow = narrow_int32(port_rpn, [(1000, 1000)])
    got = eval_rpn(narrow, [(torch.from_numpy(small), torch.from_numpy(ok))],
                   N, torch, "cpu")[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_eval_rpn(
        ref_rpn, [(small.astype(np.int64), ok)], N, np)[0])
    assert narrow_int32(port_rpn, [(-2**31, 2**31 - 10)]) == port_rpn
