"""RPN stack-machine evaluation over numpy arrays or torch tensors.

Reference: tidb_query_expr/src/types/expr_eval.rs:161.  Given column
(values, validity) pairs the evaluator applies pure array ops, so one body
serves two namespaces: numpy on the host (key bounds, sparse recodes) and
torch on the device (selection masks and computed aggregate inputs).

Device typing follows the reference's device policy: constants are int32
when they fit, else int64, and float32 for REAL (``real=torch.float64``
makes REAL constants float64, for an expression over float64 planes).
torch treats a 0-d tensor as a weak scalar, so ``int32_column <
int64_constant`` would stay int32 and wrap the constant; the torch path
therefore widens integer operands to the widest integer dtype among a
call's arguments before the call — the promotion the reference's array
namespace applies.  INT arithmetic (``RpnFnMeta.int64``) casts int32
operands to int64 first in both namespaces, unlike the reference, whose
device path wraps at int32; ``narrow_int32`` marks the calls that column
bounds prove exact in int32, which then stay int32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..datatype import EvalType, device_const_dtype
from .rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall

_TORCH_DTYPES = {"int32": torch.int32, "int64": torch.int64,
                 "float32": torch.float32, "float64": torch.float64}
_INT32 = (-(1 << 31), (1 << 31) - 1)


def _const_pair(xp, node: RpnConst, device, real=torch.float32):
    if xp is np:
        if node.value is None:
            dt = "float64" if node.eval_type is EvalType.REAL else "int64"
            return np.zeros((), dtype=dt), np.zeros((), dtype=bool)
        dt = "float64" if isinstance(node.value, float) else "int64"
        return np.asarray(node.value, dtype=dt), np.ones((), dtype=bool)
    if node.value is None:
        dt = real if node.eval_type is EvalType.REAL else torch.int32
        return (torch.zeros((), dtype=dt, device=device),
                torch.zeros((), dtype=torch.bool, device=device))
    dt = _TORCH_DTYPES[device_const_dtype(node.value)]
    if dt.is_floating_point:
        dt = real
    return (torch.tensor(node.value, dtype=dt, device=device),
            torch.ones((), dtype=torch.bool, device=device))


def _widen(args: list) -> list:
    """Cast every integer operand to the widest integer dtype present."""
    ints = [v.dtype for v, _ in args
            if not v.dtype.is_floating_point and v.dtype != torch.bool]
    if len(set(ints)) < 2:
        return args
    wide = max(ints, key=lambda d: torch.iinfo(d).bits)
    return [(v.to(wide) if v.dtype in ints and v.dtype != wide else v, m)
            for v, m in args]


def _int64(xp, args: list) -> list:
    if xp is np:
        return [(v.astype(np.int64) if v.dtype == np.int32 else v, m)
                for v, m in args]
    return [(v.to(torch.int64) if v.dtype == torch.int32 else v, m)
            for v, m in args]


def eval_rpn(rpn: RpnExpression, columns: Sequence[tuple], n_rows: int,
             xp=np, device=None, real=torch.float32):
    """Evaluate ``rpn`` over ``columns`` (list of (values, validity) pairs).

    Returns a (values, validity) pair of length ``n_rows`` (scalars are
    broadcast).  ``xp`` is ``numpy`` or ``torch``; with torch, constants
    are made on ``device``, REAL ones in ``real``.
    """
    stack: list[tuple] = []
    for node in rpn.nodes:
        if isinstance(node, RpnConst):
            stack.append(_const_pair(xp, node, device, real))
        elif isinstance(node, RpnColumnRef):
            stack.append(columns[node.col_idx])
        elif isinstance(node, RpnFnCall):
            if node.n_args:
                args = stack[-node.n_args:]
                del stack[-node.n_args:]
            else:
                args = []
            if node.meta.int64:
                args = _int64(xp, args)
            elif xp is not np and node.meta.widen:
                args = _widen(args)
            stack.append(node.meta.fn(xp, *args))
        else:  # pragma: no cover
            raise AssertionError(node)
    assert len(stack) == 1, f"malformed RPN: stack depth {len(stack)}"
    values, validity = stack[0]
    if xp is not np and device is not None:
        # a constant-only expression (``Pi()``) is made on the host
        values, validity = values.to(device), validity.to(device)
    if values.ndim == 0:
        values = xp.broadcast_to(values, (n_rows,))
    if validity.ndim == 0:
        validity = xp.broadcast_to(validity, (n_rows,))
    return values, validity


def narrow_int32(rpn: RpnExpression,
                 bounds: Sequence[Optional[tuple]]) -> RpnExpression:
    """``rpn`` with each INT arithmetic call (``RpnFnMeta.int64``) whose
    operands and result provably lie in int32 kept in int32.

    ``bounds[i]``: (lo, hi) over every value of column i (NULL slots
    included: they hold 0), or None where unknown.  Interval arithmetic
    over the RPN; a call whose interval is unknown or leaves int32 keeps
    its int64 evaluation."""
    def fits(iv):
        return iv is not None and _INT32[0] <= iv[0] and iv[1] <= _INT32[1]

    stack: list = []
    nodes = []
    for node in rpn.nodes:
        if isinstance(node, RpnConst):
            v = node.value
            stack.append((0, 0) if v is None else (v, v) if isinstance(
                v, int) and not isinstance(v, bool) else None)
        elif isinstance(node, RpnColumnRef):
            stack.append(bounds[node.col_idx])
        else:
            args = stack[len(stack) - node.n_args:]
            del stack[len(stack) - node.n_args:]
            iv = None
            if node.meta.int64 and all(fits(a) for a in args):
                name = node.meta.name
                if name == "UnaryMinusInt":
                    iv = (-args[0][1], -args[0][0])
                elif name == "PlusInt":
                    iv = (args[0][0] + args[1][0], args[0][1] + args[1][1])
                elif name == "MinusInt":
                    iv = (args[0][0] - args[1][1], args[0][1] - args[1][0])
                else:
                    ends = [a * b for a in args[0] for b in args[1]]
                    iv = (min(ends), max(ends))
                if fits(iv):
                    node = dataclasses.replace(
                        node, meta=dataclasses.replace(node.meta,
                                                       int64=False))
                else:
                    iv = None
            stack.append(iv)
        nodes.append(node)
    return RpnExpression(tuple(nodes))
