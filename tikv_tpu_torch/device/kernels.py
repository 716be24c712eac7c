"""Two-level GROUP BY helpers: plane layouts, byte-split planes, slot ids.

Counterpart of the JAX package's ``device/kernels.py`` (``int_planes_needed``
through ``slot_index``).  The two-level route aggregates COUNT/SUM/AVG
states as one contraction over stacked planes:

- plane 0 is the row mask (→ present and COUNT(*));
- each aggregate adds a validity plane (unless its validity provably is
  the row mask) and, for an integer SUM/AVG, ``nb`` int8 planes of its
  biased value bytes: v = Σ_k (c_k + 128)·2^(8k) − 2^(8nb−1);
- a REAL SUM/AVG adds one float32 plane instead.

The contraction itself is ``device/twolevel.py`` (the CUDA kernel
``csrc/twolevel.cu``, which builds the slots and planes in registers, and
its plain version); ``states_from_matmul`` turns its unpacked sums back
into the ops/agg.py state dicts on the host.

``make_planes`` and ``slot_index`` run on torch tensors (the plain
version's composition); the layout and finalize helpers on plain Python
and numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

_INT64_MIN = -(1 << 63)


def int_planes_needed(vmin: int, vmax: int) -> int:
    """Bytes needed to represent [vmin, vmax] biased to unsigned."""
    for nb in (1, 2, 3, 4):
        lo, hi = -(1 << (8 * nb - 1)), (1 << (8 * nb - 1)) - 1
        if lo <= vmin and vmax <= hi:
            return nb
    return 8


def bias_offset(nb: int) -> int:
    """sum(v) correction: v = Σ(c_k+128)·2^(8k) − 2^(8nb−1)."""
    return 128 * sum(1 << (8 * k) for k in range(nb)) - (1 << (8 * nb - 1))


@dataclass(frozen=True)
class PlaneLayout:
    """One aggregate's planes in the stacked matrices.

    ``ok_plane``: index of its validity int8 plane (0 = the row mask).
    ``byte_planes``: int8 plane indices of the value bytes (LSB first).
    ``f32_plane``: index into the float32 planes for a REAL sum.
    ``nb``: byte count of the integer value split.
    """

    kind: str
    ok_plane: Optional[int] = None
    byte_planes: tuple = ()
    f32_plane: Optional[int] = None
    nb: int = 0


def build_layouts(specs, arg_is_real: Sequence[bool],
                  arg_nbytes: Sequence[int],
                  arg_ok_is_mask: Optional[Sequence[bool]] = None):
    """→ (layouts, n_int8_planes, n_f32_planes).  Plane 0 = row mask.

    ``arg_ok_is_mask[i]``: the argument's validity provably equals the row
    mask (a bare NOT NULL column), so its validity aliases plane 0.
    """
    if arg_ok_is_mask is None:
        arg_ok_is_mask = [False] * len(specs)
    layouts = []
    p8, pf = 1, 0
    for spec, is_real, nb, ok_is_mask in zip(specs, arg_is_real, arg_nbytes,
                                             arg_ok_is_mask):
        if spec.kind == "count_star":
            layouts.append(PlaneLayout("count_star"))
            continue
        if ok_is_mask:
            okp = 0
        else:
            okp = p8
            p8 += 1
        if spec.kind == "count":
            layouts.append(PlaneLayout("count", ok_plane=okp))
        elif spec.kind in ("sum", "avg"):
            if is_real:
                layouts.append(PlaneLayout(spec.kind, ok_plane=okp,
                                           f32_plane=pf))
                pf += 1
            else:
                bp = tuple(range(p8, p8 + nb))
                layouts.append(PlaneLayout(spec.kind, ok_plane=okp,
                                           byte_planes=bp, nb=nb))
                p8 += nb
        else:
            raise ValueError(f"the two-level route cannot hold {spec.kind}")
    return layouts, p8, pf


def matmul_supported(specs) -> bool:
    return all(s.kind in ("count", "count_star", "sum", "avg") for s in specs)


def value_bytes(values: torch.Tensor, nb: int) -> list:
    """The ``nb`` biased bytes of ``values``, LSB first, each as an int32
    tensor in [-128, 127].

    The bias 2^(8nb−1) is added in int64: for nb < 8 it cannot overflow
    there, and for nb = 8 adding 2^63 modulo 2^64 is flipping the sign
    bit.  An arithmetic right shift then gives the same low bytes as the
    reference's unsigned shift of the wrapped uint32/uint64 sum.
    """
    v64 = values.to(torch.int64)
    biased = v64 ^ _INT64_MIN if nb == 8 else v64 + (1 << (8 * nb - 1))
    return [((biased >> (8 * k)) & 0xFF).to(torch.int32) - 128
            for k in range(nb)]


def make_planes(layouts, cols, mask: torch.Tensor):
    """Stacked planes for the rows of ``mask``.

    ``cols[i]``: (values, validity) of spec i (ignored for COUNT(*)).
    Returns (L8: (p8, n) int8, Lf: (pf, n) float32 | None).
    """
    int8_planes = [mask.to(torch.int8)]
    f32_planes = []
    for lay, col in zip(layouts, cols):
        if lay.kind == "count_star":
            continue
        values, validity = col
        if lay.ok_plane == 0:
            ok = mask
        else:
            ok = mask & validity
            int8_planes.append(ok.to(torch.int8))
        if lay.f32_plane is not None:
            f32_planes.append(torch.where(ok, values, torch.zeros_like(values))
                              .to(torch.float32))
        elif lay.byte_planes:
            for byte in value_bytes(values, lay.nb):
                int8_planes.append(torch.where(ok, byte,
                                               torch.zeros_like(byte))
                                   .to(torch.int8))
    L8 = torch.stack(int8_planes)
    Lf = torch.stack(f32_planes) if f32_planes else None
    return L8, Lf


def twolevel_lo(p8: int, pf: int) -> Optional[int]:
    """The low-radix width LO of the factorized slot id, or None.

    The reference packs every plane's LO lanes side by side into one
    128-lane matmul operand, so max(p8, pf)·LO ≤ 128; the port keeps the
    same LO so its partials have the reference carry's layout.
    """
    width = max(p8, max(pf, 1))
    lo = 128
    while lo > 4 and width * lo > 128:
        lo //= 2
    return lo if width * lo <= 128 else None


def twolevel_dims(slots: int, p8: int, pf: int) -> tuple:
    """→ (LO, HI): slot = hi·LO + lo, HI rounded up to a multiple of 8."""
    lo = twolevel_lo(p8, pf)
    assert lo is not None, (p8, pf)
    hi = -(-slots // lo)
    return lo, ((hi + 7) // 8) * 8


def twolevel_unpack(S2, n_planes: int, LO: int, slots: int):
    """(HI, P·LO) packed partials → (P, slots) plane matrix (numpy)."""
    HI = S2.shape[0]
    S = np.transpose(S2.reshape(HI, n_planes, LO), (1, 0, 2)) \
        .reshape(n_planes, HI * LO)
    return S[:, :slots]


def states_from_matmul(layouts, specs, S8, Sf):
    """(present, per-spec state dicts in the ops/agg.py layout) from the
    unpacked plane sums (numpy int64 ``S8``, float64 ``Sf``)."""
    mask_count = S8[0]
    states = []
    for lay in layouts:
        if lay.kind == "count_star":
            states.append({"count": mask_count})
            continue
        okc = S8[lay.ok_plane]
        if lay.kind == "count":
            states.append({"count": okc})
            continue
        if lay.f32_plane is not None:
            total = Sf[lay.f32_plane]
        else:
            # int64 arithmetic wraps modulo 2^64, so the total is exact
            # whenever the true sum fits int64
            total = np.zeros_like(okc)
            for k, p in enumerate(lay.byte_planes):
                total = total + (S8[p] << (8 * k))
            total = total + okc * bias_offset(lay.nb)
        states.append({"sum": total, "nonnull": okc} if lay.kind == "sum"
                      else {"sum": total, "count": okc})
    return mask_count > 0, states


def slot_index(key_pair, capacity: int, base: int, row_mask: torch.Tensor):
    """Row → slot id (group / NULL slot ``capacity`` / scrap ``capacity+1``).

    Returns (idx int32, overflow: 0-d bool tensor).  An int32 key shifts
    in int32 against the int32 wraparound of ``base``, as the reference
    does; a live key that leaves [0, capacity) raises ``overflow`` instead
    of landing in a wrong group.
    """
    kv, km = key_pair
    if kv.dtype == torch.int32:
        b32 = ((int(base) + (1 << 31)) % (1 << 32)) - (1 << 31)
        shifted = kv - b32      # a Python int keeps int32, wrapping
    else:
        shifted = kv.to(torch.int64) - int(base)
    in_range = (shifted >= 0) & (shifted < capacity)
    idx = torch.where(km & in_range, shifted, torch.zeros_like(shifted)) \
        .to(torch.int32)
    scrap = torch.full_like(idx, capacity + 1)
    idx = torch.where(km, torch.where(in_range, idx, scrap),
                      torch.full_like(idx, capacity))
    idx = torch.where(row_mask, idx, scrap)
    overflow = (row_mask & km & ~in_range).any()
    return idx, overflow
