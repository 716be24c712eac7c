"""Late-materialized selection: the route policy, and the wrappers and
plain PyTorch versions of the CUDA kernels ``csrc/selection.cu``.

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
JAX.  The reference's host route above ``HOST_SELECTIVITY_CUTOFF`` belongs
to the endpoint, which the port does not have yet: every selectivity is
served on the device.

Each kernel wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises.  ``mask_launches`` and
``compact_launches`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..datatype import device_const_dtype
from ..expr.rpn import RpnColumnRef, RpnConst, RpnExpression

ROUTE_MASK = "mask"
ROUTE_INDEX = "index"
ROUTE_COMPACT = "compact"

# largest k the compact route materializes on the device (selection.py:98)
COMPACT_MAX_ROWS = 1 << 14

# rows per CUDA block of both kernels: 256 threads × 128 rows
ROWS_PER_BLOCK = 1 << 15
# planes sel_compact gathers in one launch (csrc/selection.cu MAX_PLANES)
MAX_PLANES = 128
# bytes before the packed mask / the indices in an output buffer: the
# int64 count (and, for sel_compact, the int64 overflow flag)
HEADER = 16

# kernel launches since import (the chip smoke resets them around a run)
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


def index_capacity(k_hint: float, n_local: int) -> int:
    """Pow2 index/compact capacity for an expected k (≥ 64), clamped to
    the row count's pow2."""
    need = max(64, int(math.ceil(k_hint)))
    return min(_next_pow2(need), max(64, _next_pow2(n_local)))


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
        h = self.buf[:HEADER + -(-self.n // 8)].cpu().numpy()
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
        c, o, idx, outs = _compact_views(self.buf.cpu(), self.k_cap,
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

class _CompactParams(ctypes.Structure):
    _fields_ = [("packed", ctypes.c_void_p),
                ("block_counts", ctypes.c_void_p),
                ("n_blocks", ctypes.c_longlong),
                ("k_cap", ctypes.c_longlong),
                ("idx", ctypes.c_void_p),
                ("header", ctypes.c_void_p),
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
        lib.sel_mask_launch.argtypes = [i, p, ll, i, p, p, p, p]
        lib.sel_mask_launch.restype = i
        lib.sel_compact_launch.argtypes = [i, ctypes.POINTER(_CompactParams),
                                           p, ll, p]
        lib.sel_compact_launch.restype = i
        lib.sel_params_bytes.restype = i
        lib.sel_max_planes.restype = i
        lib.sel_error_string.argtypes = [i]
        lib.sel_error_string.restype = ctypes.c_char_p
        if lib.sel_params_bytes() != ctypes.sizeof(_CompactParams) or \
                lib.sel_max_planes() != MAX_PLANES:
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


def _sel_mask_cuda(pred, n) -> MaskOut:
    global mask_launches
    lib = _kernel_lib()
    dev = pred.device
    nb = n_blocks(n)
    buf = torch.empty(HEADER + nb * ROWS_PER_BLOCK // 8, dtype=torch.uint8,
                      device=dev)
    block_counts = torch.empty(nb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.sel_mask_launch(
        _dev_index(dev), pred.data_ptr(), n, int(pred.data_ptr() % 16 == 0),
        buf.data_ptr() + HEADER, block_counts.data_ptr(), buf.data_ptr(),
        stream), "sel_mask launch")
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
                       idx=base + HEADER, header=base, n_planes=len(planes))
    p.esize[:len(planes)] = esizes
    p.src[:len(planes)] = [t.data_ptr() for t in planes]
    p.dst[:len(planes)] = [base + o for o in offsets]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.sel_compact_launch(
        _dev_index(dev), ctypes.byref(p), base, total, stream),
        "sel_compact launch")
    compact_launches += 1
    return CompactOut(buf, k_cap, dtypes, offsets)


def sel_compact(mask: MaskOut, k_cap: int,
                planes: Sequence[torch.Tensor] = ()) -> CompactOut:
    """The first ``k_cap`` selected rows of ``mask`` (a ``sel_mask``
    output) as ascending int32 indices with ``-1`` fill, the count and an
    overflow flag, and each of ``planes`` (1-D, ≥ n rows) gathered at
    those indices (the compact route) → ``CompactOut``."""
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
