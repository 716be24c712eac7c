"""RPN stack-machine evaluation over numpy arrays or torch tensors.

Reference: tidb_query_expr/src/types/expr_eval.rs:161.  Given column
(values, validity) pairs the evaluator applies pure array ops, so one body
serves two namespaces: numpy on the host (key bounds, sparse recodes) and
torch on the device (selection masks and computed aggregate inputs).

Device typing follows the reference's device policy: constants are int32
when they fit, else int64, and float32 for REAL.  torch treats a 0-d
tensor as a weak scalar, so ``int32_column < int64_constant`` would stay
int32 and wrap the constant; the torch path therefore widens integer
operands to the widest integer dtype among a call's arguments before the
call — the promotion the reference's array namespace applies.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..datatype import EvalType, device_const_dtype
from .rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall

_TORCH_DTYPES = {"int32": torch.int32, "int64": torch.int64,
                 "float32": torch.float32}


def _const_pair(xp, node: RpnConst, device):
    if xp is np:
        if node.value is None:
            dt = "float64" if node.eval_type is EvalType.REAL else "int64"
            return np.zeros((), dtype=dt), np.zeros((), dtype=bool)
        dt = "float64" if isinstance(node.value, float) else "int64"
        return np.asarray(node.value, dtype=dt), np.ones((), dtype=bool)
    if node.value is None:
        dt = torch.float32 if node.eval_type is EvalType.REAL else torch.int32
        return (torch.zeros((), dtype=dt, device=device),
                torch.zeros((), dtype=torch.bool, device=device))
    dt = _TORCH_DTYPES[device_const_dtype(node.value)]
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


def eval_rpn(rpn: RpnExpression, columns: Sequence[tuple], n_rows: int,
             xp=np, device=None):
    """Evaluate ``rpn`` over ``columns`` (list of (values, validity) pairs).

    Returns a (values, validity) pair of length ``n_rows`` (scalars are
    broadcast).  ``xp`` is ``numpy`` or ``torch``; with torch, constants
    are made on ``device``.
    """
    stack: list[tuple] = []
    for node in rpn.nodes:
        if isinstance(node, RpnConst):
            stack.append(_const_pair(xp, node, device))
        elif isinstance(node, RpnColumnRef):
            stack.append(columns[node.col_idx])
        elif isinstance(node, RpnFnCall):
            if node.n_args:
                args = stack[-node.n_args:]
                del stack[-node.n_args:]
            else:
                args = []
            if xp is not np and node.meta.widen:
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
