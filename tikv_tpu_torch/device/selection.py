"""Late-materialized selection: the route policy, and the wrappers and
plain PyTorch versions of the CUDA kernels ``csrc/selection.cu``,
``csrc/sel_batched.cu`` and ``csrc/sel_mask.cu``.

Counterpart of the JAX package's ``device/selection.py``.  A selection
(scan → Selection, no terminal) evaluates its predicates over the resident
feed into one bool mask, which stays on the device; ``sel_mask`` packs it
(``np.unpackbits``-compatible bytes, MSB first) and counts it in one pass.
Then one of three routes ships the cheapest selection vector:

  ``mask``     n/8 bytes: the packed mask;
  ``index``    4·K bytes: ascending row indices into a pow2 capacity K,
               ``-1`` fill (``sel_compact``); an overflow falls back to the
               packed mask, which is still on the device — never a
               truncated answer;
  ``compact``  K rows of every scan column, gathered on the device at the
               same indices (``sel_compact`` with planes), so the host
               gathers nothing; only when every scan column round-trips its
               device dtype losslessly, and for k ≤ ``COMPACT_MAX_ROWS``.

The routing helpers (``choose_route``, ``index_capacity``,
``index_bytes``, ``shape_key``, ``split_params``) are the reference's
(selection.py:106-194, :380-386), kept here because that module imports
JAX.  The reference's host route above ``HOST_SELECTIVITY_CUTOFF`` (its
runner's selectivity gate, which sends such a plan back to the endpoint's
host pipeline) is not ported (ROADMAP.md queue 1 item 5): the port's
endpoint has the host pipeline, but its runner serves every selectivity
on the device.

A coalesced group of selections that differ only in their constants runs
as one ``sel_pred_batched`` launch (``build_batched_mask_kernel``,
selection.py:273): one program, one constant table per lane, one read of
the feed, every lane's count and packed mask in one buffer.

Each kernel wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises.  ``sel_mask`` is one
launch and no memset: the last of its CTAs to finish writes the count,
through a tally the wrapper zeroes once a (device, stream) and the kernel
resets (``_mask_scratch``).  ``pred_launches``,
``batched_launches``, ``mask_launches`` and ``compact_launches`` count
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..datatype import EvalType, device_const_dtype
from ..expr.rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall

ROUTE_MASK = "mask"
ROUTE_INDEX = "index"
ROUTE_COMPACT = "compact"

# largest k the compact route materializes on the device (selection.py:98)
COMPACT_MAX_ROWS = 1 << 14

# rows per block of the mask layout (sel_pred, sel_mask, sel_compact): one
# sel_mask CTA of 512 threads × 64 rows
ROWS_PER_BLOCK = 1 << 15
# planes sel_compact gathers in one launch (csrc/selection.cu MAX_PLANES)
MAX_PLANES = 128
# bytes before the packed mask / the indices in an output buffer: the
# int64 count (and, for sel_compact, the int64 overflow flag)
HEADER = 16

# lanes of one sel_pred_batched launch (csrc/selection.cu BATCH_MAX_LANES)
BATCH_MAX_LANES = 64

# kernel launches since import (the chip smoke resets them around a run)
pred_launches = 0
batched_launches = 0
mask_launches = 0
compact_launches = 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


# ---------------------------------------------------------------------------
# routing (the reference's selection.py)
# ---------------------------------------------------------------------------

def split_params(sel_rpns, n_cols: int):
    """Hoist numeric predicate constants into parameter columns.

    → ``(param_rpns, values, dtypes)``: every int/float RpnConst becomes an
    RpnColumnRef to position ``n_cols + i``, whose pair the runner feeds as
    a cached 0-d device tensor (value, True) of the constant's device
    dtype — the pair ``eval._const_pair`` would make, without a host→device
    copy on every request."""
    vals: list = []
    dts: list = []
    out = []
    for rpn in sel_rpns:
        nodes = []
        for nd in rpn.nodes:
            if isinstance(nd, RpnConst) and nd.value is not None and \
                    isinstance(nd.value, (int, float)):
                nodes.append(RpnColumnRef(n_cols + len(vals), nd.eval_type))
                vals.append(nd.value)
                dts.append(device_const_dtype(nd.value))
            else:
                nodes.append(nd)
        out.append(RpnExpression(tuple(nodes)))
    return out, tuple(vals), tuple(dts)


def shape_key(plan) -> tuple:
    """Const-blind identity of a selection's predicate structure: plans
    differing only in numeric constant values (same device dtype) share it,
    so a workload rotating constants warms one selectivity statistic."""
    def nk(nd):
        if isinstance(nd, RpnConst):
            if nd.value is None:
                return ("cN", nd.eval_type.value)
            if isinstance(nd.value, (int, float)):
                return ("c", device_const_dtype(nd.value))
            return ("c", repr(nd.value))
        if isinstance(nd, RpnColumnRef):
            return ("col", nd.col_idx, nd.eval_type.value)
        return ("f", nd.meta.name, nd.n_args)

    return (type(plan.scan).__name__, bool(getattr(plan.scan, "desc", False)),
            tuple(tuple(nk(nd) for nd in r.nodes) for r in plan.sel_rpns))


def index_bytes(k: float, n_shards: int = 1) -> int:
    """D2H bytes of the index route for an expected k: the pow2 capacity
    bucket with the runner's 1.5× headroom, not 4·k."""
    cap = _next_pow2(max(64, int(math.ceil(k * 1.5)) + 64))
    return 4 * cap * n_shards


def choose_route(n: int, k: float, compact_ok: bool,
                 idx_bytes: Optional[int] = None) -> str:
    """The cheapest route for ~k selected of n scanned rows, by D2H bytes:
    compact for small k where every scan column can be gathered on the
    device, index while its real transfer undercuts the n/8-byte mask,
    else mask."""
    if compact_ok and k <= COMPACT_MAX_ROWS:
        return ROUTE_COMPACT
    if idx_bytes is None:
        idx_bytes = index_bytes(k)
    if idx_bytes < n / 8:
        return ROUTE_INDEX
    return ROUTE_MASK


def modeled_d2h_bytes(route: str, n: int, k: int, row_bytes: int = 12) -> int:
    """Bytes the chosen route moves device→host (the cost router's model,
    selection.py:183): the packed mask, the index route's pow2 capacity,
    or the compact route's projected rows."""
    if route == ROUTE_MASK:
        return -(-n // 8)
    if route == ROUTE_INDEX:
        return index_bytes(k)
    if route == ROUTE_COMPACT:
        return row_bytes * _next_pow2(max(64, k))
    return 0


def index_capacity(k_hint: float, n_local: int) -> int:
    """Pow2 index/compact capacity for an expected k (≥ 64), clamped to
    the row count's pow2."""
    need = max(64, int(math.ceil(k_hint)))
    return min(_next_pow2(need), max(64, _next_pow2(n_local)))


# ---------------------------------------------------------------------------
# the predicate program of sel_pred
# ---------------------------------------------------------------------------

# opcodes of csrc/selection.cu (enum OP_*).  A binary op with aux 1 takes
# constant `arg` as its right operand; an IN op the constants [arg, arg +
# aux).
OP_COL, OP_CONST, OP_BINARY = 0, 1, 16
OP_NEG = {"int32": 2, "int64": 3, "float32": 4}
_UNARY_OPS = {"UnaryNotInt": 5, "UnaryNotReal": 6, "IsNullInt": 7,
              "IsNullReal": 7, "IntIsTrue": 8, "RealIsTrue": 9,
              "IntIsFalse": 10, "RealIsFalse": 11}
OP_IN = {"I": 12, "R": 13}
_ARITH_OPS = {"Plus": 16, "Minus": 19, "Multiply": 22}
_ARITH_DT = {"int32": 0, "int64": 1, "float32": 2}
_CMP_OPS = {"Gt": 25, "Ge": 26, "Lt": 27, "Le": 28, "Eq": 29, "Ne": 30}
OP_NULLEQ = {"I": 37, "R": 38}
_LOGIC_OPS = {"LogicalAnd": 39, "LogicalOr": 40, "LogicalXor": 41}
OP_KEEP = {"I": 48, "R": 49}

# the program's limits (csrc/selection.cu PRED_MAX_*, and the stack depth
# of its largest instance)
PRED_MAX_COLS = 16
PRED_MAX_OPS = 32
PRED_MAX_CONSTS = 32
PRED_MAX_DEPTH = 4
PRED_MAX_IN = 16

# the signatures sel_pred evaluates: every other one keeps the torch route.
# DATETIME and DURATION values are integer planes (the runner's int64 bits
# of a core, a duration as INT is), so their comparisons take the integer
# comparison ops
_TIME_SUFFIXES = ("Time", "Duration")
PRED_SIGS = frozenset(
    [s + t for s in ("Plus", "Minus", "Multiply", "UnaryMinus", "Gt", "Ge",
                     "Lt", "Le", "Eq", "Ne", "NullEq", "In")
     for t in ("Int", "Real")] + list(_UNARY_OPS) + list(_LOGIC_OPS) +
    [s + t for s in _CMP_OPS for t in _TIME_SUFFIXES])

_CAT = {EvalType.INT: "I", EvalType.REAL: "R", EvalType.DATETIME: "I",
        EvalType.DURATION: "I"}
_PLANE_CAT = {"int32": "I", "int64": "I", "float32": "R"}


class Uncovered(ValueError):
    """A selection sel_pred does not evaluate (the torch route's)."""


@dataclass(frozen=True)
class PredProgram:
    """An encoded selection: ``ops`` (opcode, arg, aux) over the stack;
    ``consts`` (int64 payload — the value, or a float's float64 bits —,
    NULL flag, REAL flag); ``cols`` the feed plane of each column the ops
    name; ``depth`` the deepest stack it reaches; ``wide`` whether it holds
    an int64 value (the kernel's 64-bit payloads; else 32-bit)."""

    ops: tuple
    consts: tuple
    cols: tuple
    depth: int
    wide: bool


@dataclass
class _Entry:
    cat: str                 # "I" | "R"
    dt: str                  # int32 | int64 | float32
    const: int = -1          # its constant's index while it is one
    at: int = -1             # index of its OP_CONST in the ops


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _const(node: RpnConst) -> tuple:
    """(category, dtype, payload, NULL) of a constant as the torch route
    makes it (``eval._const_pair``): int32 unless it needs int64, float32
    for a float, a NULL as 0 of its eval type's dtype."""
    v = node.value
    if v is None:
        if node.eval_type not in _CAT:
            raise Uncovered(f"NULL of {node.eval_type}")
        real = node.eval_type is EvalType.REAL
        return ("R" if real else "I", "float32" if real else "int32", 0,
                True)
    if isinstance(v, float):
        bits = int(np.array([np.float32(v)], np.float64).view(np.int64)[0])
        return "R", "float32", bits, False
    if isinstance(v, int) and -(1 << 63) <= int(v) < 1 << 63:
        return "I", device_const_dtype(int(v)), int(v), False
    raise Uncovered(f"constant {v!r}")


def encode_predicate(sel_rpns: Sequence[RpnExpression],
                     dtypes: Optional[Sequence] = None) -> PredProgram:
    """Compile the selection RPNs (over the feed's planes) into one
    ``sel_pred`` program: a row is kept when ``valid & (v != 0)`` holds for
    every RPN.  ``dtypes``: each feed plane's dtype (int32, int64 or
    float32); None types every INT column int32 — the structure alone,
    which decides coverage once per plan.

    Types follow the torch route (``eval_rpn``): INT arithmetic is int64
    where ``RpnFnMeta.int64`` (``narrow_int32`` clears it), else the
    widest integer operand's dtype; REAL is float32.  A constant that is
    a call's right operand rides in the op (``aux`` 1); IN takes constant
    lists only.  Raises ``Uncovered`` for a signature outside
    ``PRED_SIGS``, an operand of the wrong type, a non-constant IN list, a
    program that reads no column or one past the limits."""
    ops: list = []
    consts: list = []
    cols: list = []
    wide = False
    for rpn in sel_rpns:
        stack: list = []
        for node in rpn.nodes:
            if isinstance(node, RpnConst):
                cat, dt, payload, null = _const(node)
                wide |= dt == "int64"
                consts.append((payload, null, cat == "R"))
                ops.append((OP_CONST, len(consts) - 1, 0))
                stack.append(_Entry(cat, dt, len(consts) - 1, len(ops) - 1))
                continue
            if isinstance(node, RpnColumnRef):
                ci = node.col_idx
                dt = _dtype_name(dtypes[ci]) if dtypes is not None else \
                    "float32" if node.eval_type is EvalType.REAL else "int32"
                if dt not in _PLANE_CAT:
                    raise Uncovered(f"a {dt} plane")
                wide |= dt == "int64"
                if ci not in cols:
                    cols.append(ci)
                ops.append((OP_COL, cols.index(ci), 0))
                stack.append(_Entry(_PLANE_CAT[dt], dt))
                continue
            if not isinstance(node, RpnFnCall):     # pragma: no cover
                raise Uncovered(repr(node))
            meta, k = node.meta, node.n_args
            if meta.name not in PRED_SIGS:
                raise Uncovered(f"function {meta.name}")
            args = stack[len(stack) - k:]
            del stack[len(stack) - k:]
            want = [meta.args[0]] * k if meta.arity is None else \
                list(meta.args)
            if [a.cat for a in args] != [_CAT.get(t) for t in want]:
                raise Uncovered(f"{meta.name} over "
                                f"{[a.dt for a in args]}")
            stack.append(_call(meta, args, ops, consts))
            wide |= stack[-1].dt == "int64"
        if len(stack) != 1:                          # pragma: no cover
            raise Uncovered(f"malformed RPN: stack depth {len(stack)}")
        ops.append((OP_KEEP[stack[0].cat], 0, 0))
    depth = most = 0
    for op, _arg, aux in ops:
        if op in (OP_COL, OP_CONST):
            depth += 1
        elif op in OP_KEEP.values() or (op >= OP_BINARY and not aux):
            depth -= 1
        most = max(most, depth)
    if not cols:
        raise Uncovered("a predicate over constants only")
    if len(ops) > PRED_MAX_OPS or len(consts) > PRED_MAX_CONSTS or \
            len(cols) > PRED_MAX_COLS or most > PRED_MAX_DEPTH:
        raise Uncovered(f"{len(ops)} ops, {len(consts)} constants, "
                        f"{len(cols)} columns, depth {most}")
    return PredProgram(tuple(ops), tuple(consts), tuple(cols), most, wide)


def _call(meta, args, ops, consts) -> _Entry:
    """Emit one call's op; → the entry it leaves on the stack."""
    name = meta.name
    stem = next((name[:-len(t)] for t in ("Real", "Int") + _TIME_SUFFIXES
                 if name.endswith(t)), name)
    if name in _UNARY_OPS:
        ops.append((_UNARY_OPS[name], 0, 0))
        return _Entry("I", "int32")
    if stem == "UnaryMinus":
        a = args[0]
        dt = "float32" if a.cat == "R" else "int64" if meta.int64 else a.dt
        ops.append((OP_NEG[dt], 0, 0))
        return _Entry(a.cat, dt)
    if stem == "In":
        items = args[1:]
        ats = [e.at for e in items]
        if any(e.const < 0 for e in items) or \
                ats != list(range(len(ops) - len(items), len(ops))):
            raise Uncovered("IN over a non-constant list")
        if len(items) > PRED_MAX_IN:
            raise Uncovered(f"IN over {len(items)} values")
        del ops[len(ops) - len(items):]
        ops.append((OP_IN[args[0].cat], items[0].const if items else 0,
                    len(items)))
        return _Entry("I", "int32")
    a, b = args
    if stem in _ARITH_OPS:
        if a.cat == "R":
            dt = "float32"
        elif meta.int64:
            dt = "int64"
        else:
            dt = "int64" if "int64" in (a.dt, b.dt) else "int32"
        op, out = _ARITH_OPS[stem] + _ARITH_DT[dt], _Entry(a.cat, dt)
    elif stem in _CMP_OPS:
        op, out = _CMP_OPS[stem] + (6 if a.cat == "R" else 0), \
            _Entry("I", "int32")
    elif stem == "NullEq":
        op, out = OP_NULLEQ[a.cat], _Entry("I", "int32")
    else:
        op, out = _LOGIC_OPS[name], _Entry("I", "int32")
    if b.const >= 0 and b.at == len(ops) - 1:
        ops.pop()                    # the constant rides in the op
        ops.append((op, b.const, 1))
    else:
        ops.append((op, 0, 0))
    return out


def pred_covered(sel_rpns: Sequence[RpnExpression]) -> str:
    """"" when ``sel_pred`` evaluates these selection RPNs, else why not
    (decided on the structure: every plane dtype the port makes for the
    columns is covered)."""
    try:
        encode_predicate(sel_rpns)
    except Uncovered as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# output layouts (the same for the kernels and their plain versions)
# ---------------------------------------------------------------------------

def n_blocks(n: int) -> int:
    return -(-n // ROWS_PER_BLOCK)


@dataclass
class MaskOut:
    """``sel_mask``'s outputs.  ``buf``: uint8, the int64 count at byte 0,
    then from byte ``HEADER`` the packed mask of ``n_blocks(n)`` blocks
    (bits past n are 0); ``block_counts``: int32 popcount per block."""

    buf: torch.Tensor
    block_counts: torch.Tensor
    n: int

    @property
    def count(self) -> torch.Tensor:
        return self.buf[:8].view(torch.int64)[0]

    @property
    def packed(self) -> torch.Tensor:
        """The whole-block packed region (n_blocks · 4096 bytes)."""
        return self.buf[HEADER:]

    def host(self):
        """(count, packed bytes of the n rows) after one device→host copy."""
        return mask_host(self.buf[:HEADER + -(-self.n // 8)].cpu().numpy())


def mask_host(h: np.ndarray) -> tuple:
    """(count, packed bytes) of a ``MaskOut`` buffer's first
    ``HEADER + ceil(n/8)`` bytes, fetched."""
    return int(h[:8].view("int64")[0]), h[HEADER:]


def _aligned(x: int) -> int:
    return -(-x // 16) * 16


def compact_layout(k_cap: int, esizes: Sequence[int]) -> tuple:
    """(plane byte offsets, total bytes) of a ``sel_compact`` buffer: the
    header (int64 count, int64 overflow flag), ``k_cap`` int32 indices at
    byte ``HEADER``, then each plane's ``k_cap`` elements, 16-byte
    aligned."""
    at = _aligned(HEADER + 4 * k_cap)
    offsets = []
    for es in esizes:
        offsets.append(at)
        at = _aligned(at + es * k_cap)
    return offsets, at


def _compact_views(buf, k_cap, dtypes, offsets) -> tuple:
    head = buf[:HEADER].view(torch.int64)
    idx = buf[HEADER:HEADER + 4 * k_cap].view(torch.int32)
    outs = [buf[o:o + k_cap * _esize(dt)].view(dt)
            for o, dt in zip(offsets, dtypes)]
    return head[0], head[1], idx, outs


@dataclass
class CompactOut:
    """``sel_compact``'s outputs, all views of one uint8 buffer ``buf``:
    ``count`` (int64, every selected row), ``overflow`` (int64, count >
    k_cap), ``idx`` (int32 [k_cap], ascending, -1 fill) and ``outs`` (per
    plane, [k_cap] in its dtype, 0 past the count)."""

    buf: torch.Tensor
    k_cap: int
    dtypes: tuple
    offsets: list

    def __post_init__(self):
        self.count, self.overflow, self.idx, self.outs = _compact_views(
            self.buf, self.k_cap, self.dtypes, self.offsets)

    def host(self):
        """(count, overflow, idx, outs) as numpy after one device→host
        copy."""
        return self.from_host(self.buf.cpu().numpy())

    def from_host(self, h: np.ndarray) -> tuple:
        """(count, overflow, idx, outs) as numpy from ``buf`` fetched."""
        c, o, idx, outs = _compact_views(torch.from_numpy(h), self.k_cap,
                                         self.dtypes, self.offsets)
        return int(c), int(o), idx.numpy(), [x.numpy() for x in outs]


def _esize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sel_mask_plain(pred: torch.Tensor, n: int) -> MaskOut:
    """Pack ``pred[:n]`` by weights and a sum, count it, one popcount per
    block."""
    dev = pred.device
    nb = n_blocks(n)
    bits = torch.zeros(nb * ROWS_PER_BLOCK, dtype=torch.uint8, device=dev)
    bits[:n] = pred[:n]
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=dev)
    packed = (bits.view(-1, 8) * weights).sum(1).to(torch.uint8)
    block_counts = bits.view(nb, -1).sum(1, dtype=torch.int32)
    buf = torch.zeros(HEADER + packed.numel(), dtype=torch.uint8, device=dev)
    buf[:8].view(torch.int64)[0] = block_counts.sum(dtype=torch.int64)
    buf[HEADER:] = packed
    return MaskOut(buf, block_counts, n)


def _as_d(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float64)


def _of_d(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64).view(torch.int64)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, sign-extended back."""
    return x.to(torch.int32).to(torch.int64)


def _f32(fn):
    return lambda a, b: _of_d(fn(_as_d(a).to(torch.float32),
                                 _as_d(b).to(torch.float32)))


# binary ops of the program over int64 payloads (floats by their bits)
_BINARY = {
    16: lambda a, b: _i32(a + b), 17: lambda a, b: a + b,
    18: _f32(torch.add), 19: lambda a, b: _i32(a - b),
    20: lambda a, b: a - b, 21: _f32(torch.sub),
    22: lambda a, b: _i32(a * b), 23: lambda a, b: a * b,
    24: _f32(torch.mul),
    25: lambda a, b: a > b, 26: lambda a, b: a >= b, 27: lambda a, b: a < b,
    28: lambda a, b: a <= b, 29: lambda a, b: a == b, 30: lambda a, b: a != b,
    31: lambda a, b: _as_d(a) > _as_d(b),
    32: lambda a, b: _as_d(a) >= _as_d(b),
    33: lambda a, b: _as_d(a) < _as_d(b),
    34: lambda a, b: _as_d(a) <= _as_d(b),
    35: lambda a, b: _as_d(a) == _as_d(b),
    36: lambda a, b: _as_d(a) != _as_d(b),
}


def _nonzero(op_real: bool, x: torch.Tensor) -> torch.Tensor:
    return _as_d(x) != 0 if op_real else x != 0


def sel_pred_plain(prog: PredProgram, planes: Sequence, n: int,
                   bools: bool = False) -> tuple:
    """``prog`` run op by op over whole columns in torch, as the kernel
    runs it over 16 rows: int64 payloads (a float by its float64 bits),
    int32 arithmetic wrapped at 32 bits, float32 arithmetic in float32 →
    (``sel_mask_plain`` of the kept rows, the bool mask of rows [0, n) or
    None)."""
    dev = planes[prog.cols[0]][0].device if prog.cols else \
        torch.device("cpu")
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    keep = ones.clone()
    stack: list = []

    def const(c):
        payload, null, _real = prog.consts[c]
        return (torch.full((n,), payload, dtype=torch.int64, device=dev),
                ~ones if null else ones)

    for op, arg, aux in prog.ops:
        if op == OP_COL:
            v, ok = planes[prog.cols[arg]]
            v = _of_d(v[:n]) if v.dtype.is_floating_point else \
                v[:n].to(torch.int64)
            stack.append((v, ones if ok is None else ok[:n]))
        elif op == OP_CONST:
            stack.append(const(arg))
        elif op in (OP_KEEP["I"], OP_KEEP["R"]):
            v, m = stack.pop()
            keep &= m & _nonzero(op == OP_KEEP["R"], v)
        elif op >= OP_BINARY:
            b, bm = const(arg) if aux else stack.pop()
            a, am = stack.pop()
            if op in _BINARY:
                out = _BINARY[op](a, b)
                stack.append((out.to(torch.int64), am & bm))
                continue
            if op in OP_NULLEQ.values():
                eq = _BINARY[29 if op == OP_NULLEQ["I"] else 35](a, b)
                stack.append((((~am & ~bm) | (am & bm & eq))
                              .to(torch.int64), ones))
            elif op == _LOGIC_OPS["LogicalAnd"]:
                af, bf = am & (a == 0), bm & (b == 0)
                stack.append(((~(af | bf)).to(torch.int64),
                              (am & bm) | af | bf))
            elif op == _LOGIC_OPS["LogicalOr"]:
                at, bt = am & (a != 0), bm & (b != 0)
                stack.append(((at | bt).to(torch.int64),
                              (am & bm) | at | bt))
            else:
                stack.append((((a != 0) ^ (b != 0)).to(torch.int64),
                              am & bm))
        elif op in OP_IN.values():
            v, m = stack.pop()
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            list_null = False
            for c in range(arg, arg + aux):
                payload, null, _real = prog.consts[c]
                if null:
                    list_null = True
                elif op == OP_IN["I"]:
                    hit |= v == payload
                else:
                    hit |= _as_d(v) == float(np.array(
                        [payload], np.int64).view(np.float64)[0])
            hit &= m
            any_null = ones if list_null else ~m
            stack.append((hit.to(torch.int64), hit | ~any_null))
        else:
            v, m = stack.pop()
            if op == OP_NEG["int32"]:
                v = _i32(-v)
            elif op == OP_NEG["int64"]:
                v = -v
            elif op == OP_NEG["float32"]:
                v = _of_d(-_as_d(v))
            elif op in (5, 6):                       # NOT
                v = (~_nonzero(op == 6, v)).to(torch.int64)
            elif op == 7:                            # IS NULL
                v, m = (~m).to(torch.int64), ones
            else:                                    # IS TRUE / IS FALSE
                truth = _nonzero(op in (9, 11), v)
                v = (m & (truth if op in (8, 9) else ~truth)).to(torch.int64)
                m = ones
            stack.append((v, m))
    return sel_mask_plain(keep, n), keep if bools else None

class LanesDiffer(ValueError):
    """Programs that one ``sel_pred_batched`` launch cannot run as lanes:
    they differ in more than their constants."""


def check_lanes(progs: Sequence[PredProgram]) -> None:
    """Raise ``LanesDiffer`` unless ``progs`` (1 to ``BATCH_MAX_LANES``)
    share their ops, columns, depth and width: lanes differ in their
    constants' values only."""
    if not 1 <= len(progs) <= BATCH_MAX_LANES:
        raise LanesDiffer(f"{len(progs)} lanes (1 to {BATCH_MAX_LANES})")
    lead = progs[0]
    for g, q in enumerate(progs[1:], 1):
        if (q.ops, q.cols, q.depth, q.wide) != \
                (lead.ops, lead.cols, lead.depth, lead.wide) or \
                len(q.consts) != len(lead.consts):
            raise LanesDiffer(f"lane {g}'s program differs from lane 0's "
                              f"beyond its constants")


@dataclass
class BatchedOut:
    """``sel_pred_batched``'s outputs in one uint8 buffer ``buf``: the
    lanes' int64 counts, then each lane's packed mask of ``n_blocks(n)``
    blocks (``lane_bytes`` each; bits past n are 0)."""

    buf: torch.Tensor
    lanes: int
    n: int

    @property
    def lane_bytes(self) -> int:
        return n_blocks(self.n) * ROWS_PER_BLOCK // 8

    @property
    def counts(self) -> torch.Tensor:
        return self.buf[:8 * self.lanes].view(torch.int64)

    def packed(self, g: int) -> torch.Tensor:
        at = 8 * self.lanes + g * self.lane_bytes
        return self.buf[at:at + self.lane_bytes]


def batched_host(buf: np.ndarray, lanes: int, n: int) -> tuple:
    """(int64 counts [lanes], uint8 packed masks [lanes, ceil(n/8)]) from
    a ``BatchedOut`` buffer brought to the host."""
    lane_bytes = n_blocks(n) * ROWS_PER_BLOCK // 8
    counts = buf[:8 * lanes].view(np.int64)
    packed = buf[8 * lanes:8 * lanes + lanes * lane_bytes].reshape(
        lanes, lane_bytes)[:, :-(-n // 8)]
    return counts, packed


def sel_pred_batched_plain(progs: Sequence[PredProgram], planes: Sequence,
                           n: int) -> BatchedOut:
    """``sel_pred_plain`` once per lane, laid out as the kernel writes."""
    dev = planes[progs[0].cols[0]][0].device
    outs = [sel_pred_plain(q, planes, n)[0] for q in progs]
    buf = torch.cat([torch.stack([o.count for o in outs]).view(torch.uint8)]
                    + [o.packed for o in outs]).to(dev)
    return BatchedOut(buf, len(progs), n)


def unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The bool mask of rows [0, n) from packed bytes (MSB first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:n].bool()


def sel_compact_plain(mask: MaskOut, k_cap: int,
                      planes: Sequence[torch.Tensor] = ()) -> CompactOut:
    """``nonzero`` of the unpacked mask, the first ``k_cap`` with ``-1``
    fill, and each plane gathered there (0 fill)."""
    dev = mask.buf.device
    dtypes = tuple(p.dtype for p in planes)
    offsets, total = compact_layout(k_cap, [_esize(d) for d in dtypes])
    buf = torch.zeros(total, dtype=torch.uint8, device=dev)
    out = CompactOut(buf, k_cap, dtypes, offsets)
    sel = torch.nonzero(unpack(mask.packed, mask.n)).reshape(-1)
    out.count.fill_(sel.numel())
    out.overflow.fill_(int(sel.numel() > k_cap))
    take = sel[:k_cap]
    out.idx.fill_(-1)
    out.idx[:take.numel()] = take.to(torch.int32)
    for src, dst in zip(planes, out.outs):
        dst[:take.numel()] = src[take]
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

class _PredParams(ctypes.Structure):
    """``struct PredParams`` of csrc/selection.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _fields_ = [("values", _p * PRED_MAX_COLS), ("valid", _p * PRED_MAX_COLS),
                ("dtype", _i * PRED_MAX_COLS), ("n", ctypes.c_longlong),
                ("packed", _p), ("block_counts", _p), ("count", _p),
                ("bools", _p), ("vec", _i), ("n_ops", _i),
                ("op", _i * PRED_MAX_OPS), ("arg", _i * PRED_MAX_OPS),
                ("aux", _i * PRED_MAX_OPS),
                ("cval", ctypes.c_longlong * PRED_MAX_CONSTS),
                ("cnull", _i * PRED_MAX_CONSTS)]


class _BatchParams(ctypes.Structure):
    """``struct BatchParams`` of csrc/selection.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _fields_ = [("lanes", _i), ("n_consts", _i), ("n_cols", _i),
                ("simple", _i), ("tile_offset", _i), ("cval", _p),
                ("cnull", _p),
                ("counts", _p), ("packed", _p),
                ("lane_bytes", ctypes.c_longlong),
                ("n_tiles", ctypes.c_longlong)]


class _CompactParams(ctypes.Structure):
    """``struct CompactParams`` of csrc/selection.cu."""
    _fields_ = [("packed", ctypes.c_void_p),
                ("block_counts", ctypes.c_void_p),
                ("n_blocks", ctypes.c_longlong),
                ("k_cap", ctypes.c_longlong),
                ("idx", ctypes.c_void_p),
                ("header", ctypes.c_void_p),
                ("out_bytes", ctypes.c_longlong),
                ("n_planes", ctypes.c_int),
                ("esize", ctypes.c_int * MAX_PLANES),
                ("src", ctypes.c_void_p * MAX_PLANES),
                ("dst", ctypes.c_void_p * MAX_PLANES)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("selection")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.sel_compact_launch.argtypes = [i, ctypes.POINTER(_CompactParams),
                                           p]
        lib.sel_compact_launch.restype = i
        lib.sel_pred_launch.argtypes = [i, ctypes.POINTER(_PredParams), i,
                                        i, ll, p]
        lib.sel_pred_launch.restype = i
        lib.sel_pred_params_bytes.restype = i
        lib.sel_pred_batched_launch.argtypes = [
            i, ctypes.POINTER(_PredParams), ctypes.POINTER(_BatchParams), i,
            i, ll, p]
        lib.sel_pred_batched_launch.restype = i
        lib.sel_batch_params_bytes.restype = i
        lib.sel_batch_max_lanes.restype = i
        lib.sel_params_bytes.restype = i
        lib.sel_max_planes.restype = i
        lib.sel_error_string.argtypes = [i]
        lib.sel_error_string.restype = ctypes.c_char_p
        if lib.sel_params_bytes() != ctypes.sizeof(_CompactParams) or \
                lib.sel_pred_params_bytes() != ctypes.sizeof(_PredParams) \
                or lib.sel_max_planes() != MAX_PLANES or \
                lib.sel_batch_params_bytes() != ctypes.sizeof(_BatchParams) \
                or lib.sel_batch_max_lanes() != BATCH_MAX_LANES:
            raise RuntimeError("selection: the kernel's parameter layout "
                               "differs from the wrapper's")
        _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"selection {what} failed: "
                           + lib.sel_error_string(err).decode())


def _dev_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _check_plane(t, name, n, device, dtypes=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f">= {n} rows, got {tuple(t.shape)}")


_PRED_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


def _payload32(payload: int, real: bool) -> int:
    """A constant's 32-bit payload: the int32 value, or a REAL constant's
    float32 bits (its float64 payload holds a float32 value exactly)."""
    if not real:
        return payload
    return int(np.array([payload], np.int64).view(np.float64)
               .astype(np.float32).view(np.int32)[0])


def _pred_params(prog, planes, n) -> _PredParams:
    """The program and its planes as ``PredParams`` (no outputs)."""
    p = _PredParams(n=n, n_ops=len(prog.ops))
    used = [planes[ci] for ci in prog.cols]
    p.values[:len(used)] = [v.data_ptr() for v, _ok in used]
    p.valid[:len(used)] = [None if ok is None else ok.data_ptr()
                           for _v, ok in used]
    p.dtype[:len(used)] = [_PRED_DTYPES[v.dtype] for v, _ok in used]
    p.vec = int(all(t.data_ptr() % 16 == 0 for pair in used for t in pair
                    if t is not None))
    p.op[:len(prog.ops)] = [o for o, _a, _x in prog.ops]
    p.arg[:len(prog.ops)] = [a for _o, a, _x in prog.ops]
    p.aux[:len(prog.ops)] = [x for _o, _a, x in prog.ops]
    return p


def _payloads(prog) -> list:
    """The program's constants as the kernel reads them."""
    return [_payload32(c, real) if not prog.wide else c
            for c, _null, real in prog.consts]


def _sel_pred_cuda(prog, planes, n, bools) -> tuple:
    global pred_launches
    lib = _kernel_lib()
    dev = planes[prog.cols[0]][0].device
    nb = n_blocks(n)
    buf = torch.empty(HEADER + nb * ROWS_PER_BLOCK // 8, dtype=torch.uint8,
                      device=dev)
    block_counts = torch.empty(nb, dtype=torch.int32, device=dev)
    out = torch.empty(nb * ROWS_PER_BLOCK, dtype=torch.bool, device=dev) \
        if bools else None
    p = _pred_params(prog, planes, n)
    p.packed = buf.data_ptr() + HEADER
    p.block_counts = block_counts.data_ptr()
    p.count = buf.data_ptr()
    p.bools = None if out is None else out.data_ptr()
    p.cval[:len(prog.consts)] = _payloads(prog)
    p.cnull[:len(prog.consts)] = [int(null) for _c, null, _r in prog.consts]
    _raise_on(lib, lib.sel_pred_launch(
        _dev_index(dev), ctypes.byref(p), prog.depth, int(prog.wide), nb,
        torch.cuda.current_stream(dev).cuda_stream), "sel_pred launch")
    pred_launches += 1
    return MaskOut(buf, block_counts, n), None if out is None else out[:n]


def sel_pred(prog: PredProgram, planes: Sequence, n: int,
             bools: bool = False) -> tuple:
    """Evaluate ``prog`` (``encode_predicate``) over rows [0, n) of the
    feed ``planes`` (per column (values, validity | None); the program
    reads ``prog.cols``) in one pass → (``MaskOut``: the count, the packed
    mask and the block counts; the bool mask of rows [0, n) when ``bools``,
    else None).  Rows past ``n`` read as false."""
    if n <= 0 or n >= 1 << 31:
        raise ValueError(f"sel_pred serves 0 < n < 2^31 rows, got {n}")
    if not prog.cols:
        raise ValueError("sel_pred: a program that reads no column")
    dev = planes[prog.cols[0]][0].device
    for ci in prog.cols:
        v, ok = planes[ci]
        _check_plane(v, f"column {ci}", n, dev, tuple(_PRED_DTYPES))
        if ok is not None:
            _check_plane(ok, f"column {ci} validity", n, dev, (torch.bool,))
    if dev.type == "cpu":
        return sel_pred_plain(prog, planes, n, bools)
    if dev.type != "cuda":
        raise ValueError(f"sel_pred runs on cuda or cpu, not {dev}")
    return _sel_pred_cuda(prog, planes, n, bools)


_CMP_CODES = frozenset(range(_CMP_OPS["Gt"], _CMP_OPS["Ne"] + 7))


def simple_terms(prog: PredProgram) -> bool:
    """Whether ``prog`` is terms ``column 0 <cmp> constant`` kept as they
    are (one column, every comparison integer or every one real;
    ``sel_pred_batched`` then takes its terms kernel, one interval test a
    row, term and lane)."""
    ops = prog.ops
    return len(prog.cols) == 1 and len(ops) % 3 == 0 and all(
        ops[k] == (OP_COL, 0, 0) and ops[k + 1][0] in _CMP_CODES and
        ops[k + 1][2] == 1 and ops[k + 2] == (OP_KEEP["I"], 0, 0)
        for k in range(0, len(ops), 3)) and \
        len({ops[k + 1][0] >= _CMP_OPS["Gt"] + 6
             for k in range(0, len(ops), 3)}) == 1


# the terms kernel's comparisons: each one a test of the value's order
# image against an interval [lo, lo + span], kept (bit 0 of a term's flags)
# or not, then inverted (bit 1: Ne); rows are 32-bit images unless the
# program is wide
_CMP_NAMES = ("gt", "ge", "lt", "le", "eq", "ne")
TERM_IN, TERM_INVERT = 1, 2


def _image_of_bits(bits: int, real: bool, w: int) -> int:
    """The order image of a w-bit payload: an int with its sign bit
    flipped; a float's bits with a negative's bits all flipped and a
    positive's sign bit set (NaN lands past ±inf, -0.0 just below
    +0.0)."""
    sign = 1 << (w - 1)
    if not real:
        return bits ^ sign
    return (~bits & ((1 << w) - 1)) if bits & sign else bits | sign


def term_interval(op: int, payload: int, null: bool, real: bool,
                  wide: bool) -> tuple:
    """(lo, span, flags) of one comparison ``value <op> constant`` over
    the order images of ``wide`` (64-bit) or 32-bit payloads: a row is
    selected where ``((image - lo) mod 2^w <= span) & flags.in ^
    flags.invert``, equal to the comparison (NaN compares false, and true
    under Ne; -0.0 equals +0.0); a NULL constant selects nothing."""
    w = 64 if wide else 32
    mask = (1 << w) - 1
    name = _CMP_NAMES[(op - _CMP_OPS["Gt"]) % 6]
    if null:
        return 0, 0, 0
    if real:
        bits = payload & mask if wide else _payload32(payload, True) & mask
        exp = (bits >> (52 if wide else 23)) & ((1 << (11 if wide else 8)) - 1)
        frac = bits & ((1 << (52 if wide else 23)) - 1)
        if exp == (1 << (11 if wide else 8)) - 1 and frac:      # NaN
            return 0, 0, TERM_INVERT if name == "ne" else 0
        zero = bits & (mask >> 1) == 0
        a = _image_of_bits(1 << (w - 1), True, w) if zero else \
            _image_of_bits(bits, True, w)
        b = _image_of_bits(0, True, w) if zero else a
        inf = (((1 << (11 if wide else 8)) - 1) << (52 if wide else 23))
        least = _image_of_bits(inf | (1 << (w - 1)), True, w)
        most = _image_of_bits(inf, True, w)
    else:
        a = b = _image_of_bits(payload & mask, False, w)
        least, most = 0, mask
    lo, hi = {"gt": (b + 1, most), "ge": (a, most), "lt": (least, a - 1),
              "le": (least, b), "eq": (a, b), "ne": (a, b)}[name]
    if lo > hi:                                  # nothing compares so
        return 0, 0, 0
    return lo, hi - lo, TERM_IN | (TERM_INVERT if name == "ne" else 0)


def term_table(progs: Sequence[PredProgram]) -> tuple:
    """The terms kernel's table of G ``simple_terms`` programs that differ
    in their constants: (uint64 [G, K, 2] of (lo, span), uint32 [G, K]
    flags), K the terms a program."""
    lead = progs[0]
    terms = [lead.ops[k + 1] for k in range(0, len(lead.ops), 3)]
    real = terms[0][0] >= _CMP_OPS["Gt"] + 6
    bounds = np.zeros((len(progs), len(terms), 2), np.uint64)
    flags = np.zeros((len(progs), len(terms)), np.uint32)
    for g, q in enumerate(progs):
        for k, (op, c, _aux) in enumerate(terms):
            payload, null, _real = q.consts[c]
            lo, span, fl = term_interval(op, payload, null, real, lead.wide)
            bounds[g, k] = (lo, span)
            flags[g, k] = fl
    return bounds, flags


def row_images(values: np.ndarray, real: bool, wide: bool) -> np.ndarray:
    """The order images of column 0's values as the terms kernel makes
    them (uint32, or uint64 when ``wide``: int32 sign-extended, a float32
    widened to float64)."""
    if wide:
        bits = (values.astype(np.float64) if real
                else values.astype(np.int64)).view(np.uint64)
        sign = np.uint64(1 << 63)
    else:
        bits = values.view(np.uint32)
        sign = np.uint32(1 << 31)
    if not real:
        return bits ^ sign
    return np.where(bits & sign, ~bits, bits | sign)


def terms_model(progs: Sequence[PredProgram], planes: Sequence,
                n: int) -> tuple:
    """The terms kernel's arithmetic in numpy: (int64 counts [G], uint8
    packed masks [G, ceil(n/8)]) from ``term_table`` and ``row_images``,
    to compare with ``batched_host`` of the plain version."""
    lead = progs[0]
    v, ok = planes[lead.cols[0]]
    v = v[:n].numpy()
    keep0 = np.ones(n, bool) if ok is None else ok[:n].numpy().copy()
    real = lead.ops[1][0] >= _CMP_OPS["Gt"] + 6
    img = row_images(v, real, lead.wide)
    dt = img.dtype.type
    bounds, flags = term_table(progs)
    masks = []
    for g in range(len(progs)):
        keep = keep0.copy()
        for k in range(flags.shape[1]):
            inside = (img - dt(bounds[g, k, 0])) <= dt(bounds[g, k, 1])
            res = inside & bool(flags[g, k] & TERM_IN)
            keep &= res ^ bool(flags[g, k] & TERM_INVERT)
        masks.append(keep)
    masks = np.array(masks, bool).reshape(len(progs), n)
    return masks.sum(axis=1).astype(np.int64), np.packbits(masks, axis=1)


class _TermsParams(ctypes.Structure):
    """``struct TermsParams`` of csrc/sel_batched.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _fields_ = [("values", _p), ("valid", _p), ("dtype", _i), ("wide", _i),
                ("real", _i), ("lanes", _i), ("terms", _i), ("vec", _i),
                ("n", ctypes.c_longlong), ("bounds", _p), ("flags", _p),
                ("counts", _p), ("packed", _p),
                ("lane_bytes", ctypes.c_longlong)]


_terms_lib = None


def _terms_kernel_lib():
    global _terms_lib
    if _terms_lib is None:
        from .build import load_checked
        lib = load_checked("sel_batched", {
            "sel_terms_params_bytes": ctypes.sizeof(_TermsParams),
            "sel_terms_max_lanes": BATCH_MAX_LANES},
            "sel_terms_error_string")
        lib.sel_terms_launch.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(_TermsParams),
                                         ctypes.c_void_p]
        lib.sel_terms_launch.restype = ctypes.c_int
        _terms_lib = lib
    return _terms_lib


def terms_route(prog: PredProgram, planes: Sequence) -> bool:
    """Whether a group of ``prog`` takes the terms kernel: ``simple_terms``
    over a column whose dtype the comparisons read (a float32 column under
    real comparisons, an int one under integer ones; int64 only wide)."""
    if not simple_terms(prog):
        return False
    dt = planes[prog.cols[0]][0].dtype
    real = prog.ops[1][0] >= _CMP_OPS["Gt"] + 6
    return (dt == torch.float32) == real and \
        (dt != torch.int64 or prog.wide)


def _sel_terms_cuda(progs, planes, n, out) -> BatchedOut:
    lead = progs[0]
    v, ok = planes[lead.cols[0]]
    bounds, flags = term_table(progs)
    host = np.zeros(_aligned(bounds.nbytes + flags.nbytes), np.uint8)
    host[:bounds.nbytes] = bounds.reshape(-1).view(np.uint8)
    host[bounds.nbytes:bounds.nbytes + flags.nbytes] = \
        flags.reshape(-1).view(np.uint8)
    table = torch.from_numpy(host).pin_memory().to(v.device,
                                                   non_blocking=True)
    p = _TermsParams(
        values=v.data_ptr(), valid=None if ok is None else ok.data_ptr(),
        dtype=_PRED_DTYPES[v.dtype], wide=int(lead.wide),
        real=int(v.dtype == torch.float32), lanes=len(progs),
        terms=flags.shape[1],
        vec=int(all(t.data_ptr() % 16 == 0 for t in (v, ok)
                    if t is not None)),
        n=n, bounds=table.data_ptr(),
        flags=table.data_ptr() + bounds.nbytes, counts=out.buf.data_ptr(),
        packed=out.buf.data_ptr() + 8 * len(progs),
        lane_bytes=out.lane_bytes)
    lib = _terms_kernel_lib()
    _raise_on_terms(lib, lib.sel_terms_launch(
        _dev_index(v.device), ctypes.byref(p),
        torch.cuda.current_stream(v.device).cuda_stream))
    return out


def _raise_on_terms(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError("sel_pred_batched terms launch failed: "
                           + lib.sel_terms_error_string(err).decode())


def _sel_pred_batched_cuda(progs, planes, n) -> BatchedOut:
    global batched_launches
    lead = progs[0]
    dev = planes[lead.cols[0]][0].device
    G, nc = len(progs), len(lead.consts)
    nb = n_blocks(n)
    out = BatchedOut(torch.empty(8 * G + G * nb * ROWS_PER_BLOCK // 8,
                                 dtype=torch.uint8, device=dev), G, n)
    if terms_route(lead, planes):
        _sel_terms_cuda(progs, planes, n, out)
        batched_launches += 1
        return out
    lib = _kernel_lib()
    # the lanes' constants: [G][nc] int64 payloads, then [G][nc] int32
    # NULL flags, one pinned block copied on the launch stream
    cval = np.array([_payloads(q) for q in progs], np.int64).reshape(-1)
    cnull = np.array([[int(null) for _c, null, _r in q.consts]
                      for q in progs], np.int32).reshape(-1)
    host = np.zeros(_aligned(8 * cval.size + 4 * cnull.size) or 16,
                    np.uint8)
    host[:8 * cval.size] = cval.view(np.uint8)
    host[8 * cval.size:8 * cval.size + 4 * cnull.size] = cnull.view(np.uint8)
    consts = torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)
    p = _pred_params(lead, planes, n)
    b = _BatchParams(lanes=G, n_consts=nc, n_cols=len(lead.cols),
                     simple=int(simple_terms(lead)),
                     tile_offset=_aligned(12 * G * nc),
                     cval=consts.data_ptr(),
                     cnull=consts.data_ptr() + 8 * cval.size,
                     counts=out.buf.data_ptr(),
                     packed=out.buf.data_ptr() + 8 * G,
                     lane_bytes=out.lane_bytes)
    _raise_on(lib, lib.sel_pred_batched_launch(
        _dev_index(dev), ctypes.byref(p), ctypes.byref(b), lead.depth,
        int(lead.wide), nb, torch.cuda.current_stream(dev).cuda_stream),
        "sel_pred_batched launch")
    batched_launches += 1
    return out


def sel_pred_batched(progs: Sequence[PredProgram], planes: Sequence,
                     n: int) -> BatchedOut:
    """Evaluate G programs (``encode_predicate``; ``check_lanes``: they
    differ in their constants only) over rows [0, n) of the feed
    ``planes`` in one pass → ``BatchedOut``: each lane's count and packed
    mask, equal to ``sel_pred`` of that lane's program."""
    if n <= 0 or n >= 1 << 31:
        raise ValueError(f"sel_pred_batched serves 0 < n < 2^31 rows, "
                         f"got {n}")
    check_lanes(progs)
    lead = progs[0]
    if not lead.cols:
        raise ValueError("sel_pred_batched: a program that reads no column")
    dev = planes[lead.cols[0]][0].device
    for ci in lead.cols:
        v, ok = planes[ci]
        _check_plane(v, f"column {ci}", n, dev, tuple(_PRED_DTYPES))
        if ok is not None:
            _check_plane(ok, f"column {ci} validity", n, dev, (torch.bool,))
    if dev.type == "cpu":
        return sel_pred_batched_plain(progs, planes, n)
    if dev.type != "cuda":
        raise ValueError(f"sel_pred_batched runs on cuda or cpu, not {dev}")
    return _sel_pred_batched_cuda(progs, planes, n)


_mask_lib = None
# (device index, stream) → the sel_mask kernel's tally (CTAs done << 32 |
# rows selected): zeroed once here, reset by the kernel's last CTA at the
# end of every call
_MASK_SCRATCH: dict = {}
_MASK_SCRATCH_BYTES = 8


def _sel_mask_lib():
    global _mask_lib
    if _mask_lib is None:
        from .build import load_checked
        lib = load_checked("sel_mask", {
            "sel_mask_rows_per_block": ROWS_PER_BLOCK,
            "sel_mask_scratch_bytes": _MASK_SCRATCH_BYTES},
            "sel_mask_error_string")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.sel_mask_launch.argtypes = [i, p, ll, i, p, p, p, p, p]
        lib.sel_mask_launch.restype = i
        _mask_lib = lib
    return _mask_lib


def _mask_scratch(dev: torch.device, stream: int) -> torch.Tensor:
    """The tally of ``sel_mask`` launches on ``stream`` of ``dev``
    (allocated zeroed on its first call: one memset a stream, ever)."""
    key = (_dev_index(dev), stream)
    t = _MASK_SCRATCH.get(key)
    if t is None:
        t = _MASK_SCRATCH[key] = torch.zeros(
            _MASK_SCRATCH_BYTES // 8, dtype=torch.int64, device=dev)
    return t


def _sel_mask_cuda(pred, n) -> MaskOut:
    global mask_launches
    from .build import raise_on
    lib = _sel_mask_lib()
    dev = pred.device
    nb = n_blocks(n)
    buf = torch.empty(HEADER + nb * ROWS_PER_BLOCK // 8, dtype=torch.uint8,
                      device=dev)
    block_counts = torch.empty(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(lib, "sel_mask_error_string", lib.sel_mask_launch(
        _dev_index(dev), pred.data_ptr(), n, int(pred.data_ptr() % 16 == 0),
        buf.data_ptr() + HEADER, block_counts.data_ptr(), buf.data_ptr(),
        _mask_scratch(dev, stream).data_ptr(), stream), "sel_mask launch")
    mask_launches += 1
    return MaskOut(buf, block_counts, n)


def sel_mask(pred: torch.Tensor, n: int) -> MaskOut:
    """Count and pack the bool mask ``pred`` over rows [0, n) (rows past
    ``n`` read as false) in one pass → ``MaskOut``."""
    if n <= 0 or n >= 1 << 31:
        raise ValueError(f"sel_mask serves 0 < n < 2^31 rows, got {n}")
    _check_plane(pred, "pred", n, pred.device, (torch.bool,))
    if pred.device.type == "cpu":
        return sel_mask_plain(pred, n)
    if pred.device.type != "cuda":
        raise ValueError(f"sel_mask runs on cuda or cpu, not {pred.device}")
    return _sel_mask_cuda(pred, n)


_PLANE_DTYPES = (torch.bool, torch.int32, torch.int64, torch.float64)


def _sel_compact_cuda(mask: MaskOut, k_cap, planes) -> CompactOut:
    global compact_launches
    lib = _kernel_lib()
    dev = mask.buf.device
    dtypes = tuple(p.dtype for p in planes)
    esizes = [_esize(d) for d in dtypes]
    offsets, total = compact_layout(k_cap, esizes)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    p = _CompactParams(packed=mask.buf.data_ptr() + HEADER,
                       block_counts=mask.block_counts.data_ptr(),
                       n_blocks=n_blocks(mask.n), k_cap=k_cap,
                       idx=base + HEADER, header=base, out_bytes=total,
                       n_planes=len(planes))
    p.esize[:len(planes)] = esizes
    p.src[:len(planes)] = [t.data_ptr() for t in planes]
    p.dst[:len(planes)] = [base + o for o in offsets]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.sel_compact_launch(
        _dev_index(dev), ctypes.byref(p), stream), "sel_compact launch")
    compact_launches += 1
    return CompactOut(buf, k_cap, dtypes, offsets)


def sel_compact(mask: MaskOut, k_cap: int,
                planes: Sequence[torch.Tensor] = ()) -> CompactOut:
    """The first ``k_cap`` selected rows of ``mask`` (a ``sel_mask``
    output) as ascending int32 indices with ``-1`` fill, the count and an
    overflow flag, and each of ``planes`` (1-D, ≥ n rows) gathered at
    those indices (the compact route) → ``CompactOut``.  On the card one
    launch writes every byte of ``buf`` (the alignment gaps are 0), as
    ``sel_compact_plain`` does."""
    if k_cap <= 0 or len(planes) > MAX_PLANES:
        raise ValueError(f"sel_compact: k_cap={k_cap}, {len(planes)} "
                         f"planes (at most {MAX_PLANES})")
    dev = mask.buf.device
    for j, t in enumerate(planes):
        _check_plane(t, f"plane {j}", mask.n, dev, _PLANE_DTYPES)
    if dev.type == "cpu":
        return sel_compact_plain(mask, k_cap, planes)
    if dev.type != "cuda":
        raise ValueError(f"sel_compact runs on cuda or cpu, not {dev}")
    return _sel_compact_cuda(mask, k_cap, planes)
