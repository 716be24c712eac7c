"""Compiled per-class request fast path — raw wire bytes → coalescer.

A copy of the JAX package's ``server/fastpath.py``.  A dashboard fleet
sends thousands of requests of one shape that differ only in their
constants and timestamps; each paid the msgpack body decode, the DAG
decode and the plan analysis again.  The repeated thing is the WIRE SHAPE
of the request, so the decode is hoisted to the first request of a class
and every repeat pays a byte-level template match plus the extraction of
its constants.

Mechanism
---------

On the full-decode path the service learns a :class:`WireTemplate` per
class: the raw request bytes are re-encoded (by a msgpack encoder
byte-compatible with ``msgpack.packb(use_bin_type=True)`` for the scalars
and containers requests use) into FIXED SEGMENTS — the structural bytes —
interleaved with SLOTS: the encodings of the per-request scalars
(predicate and aggregate constants, ``start_ts``, ``deadline_ms``,
``trace_id``).  A template is admitted only if re-rendering it with the
original slot values reproduces the original bytes exactly, so a template
can be wrong only by never matching, never by mis-extracting.

A repeat matches by walking its raw bytes: each fixed segment must compare
equal at its position and each slot must parse as one msgpack scalar of
the learned type (and, for a constant, of the learned device dtype
bucket).  A full match means the full decode would produce exactly the
learned structure with the extracted values substituted, so the fast path
skips ``wire.unpack``, the DAG decode and the plan analysis and goes to
the coalescer with the hoisted constants.  ANY mismatch falls back to the
full decode: parity, never staleness.

Invalidation (fall back to the full decode, re-learn):

==========================  =============================================
event                       mechanism
==========================  =============================================
wire shape change           fixed-segment byte mismatch
const dtype bucket change   the slot's ``device_const_dtype`` guard
region epoch bump / split   the learned ``base_key`` embeds the epoch —
                            ``get_fast`` misses
delta patch / rebuild       generation guard: the snapshot served must be
                            the learned one (``is_current``; a move
                            mid-flight serves the CURRENT generation
                            through the full ceremony and drops the entry)
online config change        the node bumps ``config_gen`` on every applied
                            online diff; entries pin the gen they learned
``copr::fastpath`` arms     ``return(miss)`` / ``return(full)`` /
                            ``return(corrupt)`` (flips a template byte)
==========================  =============================================

Three tiers (``_ClassEntry.tier``) scale how much a hit skips:
``dispatch`` (a device-routed TableScan: decode AND snapshot and routing
hoisted), ``decode`` (a host-routed IndexScan: only the wire decode
hoisted, the full serving ceremony re-runs) and ``plan`` (plan IR: decode
and plan analysis hoisted onto one cached PlanRequest with the TSO
re-stamped; its constants are class identity).

The reference's metrics counter is the cache's own counts here
(``stats()``: outcome totals and ``reasons`` by "outcome:reason"); the
port has no metrics registry.  Nor does it meter resource units: an entry
pre-binds no resource tag.
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from typing import Callable, Optional

from ..datatype import device_const_dtype
from ..utils.failpoint import fail_point

# slot kinds
K_CONST = "const"            # int/float predicate/aggregate constant
K_START_TS = "start_ts"      # dag.start_ts (per-request TSO)
K_DEADLINE = "deadline_ms"   # top-level remaining-budget field
K_TRACE_ID = "trace_id"      # client-propagated trace id


class _Slot:
    """Marker substituted into the wire structure where a per-request
    scalar lives; carries the match-time guard."""

    __slots__ = ("kind", "index", "vtype", "dtype")

    def __init__(self, kind: str, index: int = -1, vtype=None,
                 dtype: Optional[str] = None):
        self.kind = kind
        self.index = index          # const ordinal (DFS order)
        self.vtype = vtype          # exact python type required
        self.dtype = dtype          # device dtype bucket (consts)

    def guard(self, v) -> bool:
        # bool is an int subclass: an exact-type check keeps a flipped
        # True from masquerading as the learned integer constant
        if self.vtype is not None and type(v) is not self.vtype:
            return False
        if self.dtype is not None and device_const_dtype(v) != self.dtype:
            return False
        return True


# ---------------------------------------------------------------- codec
#
# A msgpack encoder byte-compatible with msgpack.packb(use_bin_type=True)
# for the subset request bodies use (None/bool/int/float64/str/bytes/
# list/tuple/dict), emitting FIXED SEGMENTS split at _Slot markers.  Byte
# compatibility is VERIFIED per template (render == original raw): a
# divergence makes the class ineligible, never wrong.

def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + v.to_bytes(1, "big")
        elif v <= 0xFFFF:
            out += b"\xcd" + v.to_bytes(2, "big")
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + v.to_bytes(4, "big")
        else:
            out += b"\xcf" + v.to_bytes(8, "big")
    else:
        if v >= -32:
            out.append(0x100 + v)
        elif v >= -0x80:
            out += b"\xd0" + v.to_bytes(1, "big", signed=True)
        elif v >= -0x8000:
            out += b"\xd1" + v.to_bytes(2, "big", signed=True)
        elif v >= -0x80000000:
            out += b"\xd2" + v.to_bytes(4, "big", signed=True)
        else:
            out += b"\xd3" + v.to_bytes(8, "big", signed=True)


def _pack_scalar(v, out: bytearray) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif type(v) is int:
        _pack_int(v, out)
    elif type(v) is float:
        out += b"\xcb" + struct.pack(">d", v)
    elif type(v) is str:
        b = v.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += b"\xd9" + n.to_bytes(1, "big")
        elif n <= 0xFFFF:
            out += b"\xda" + n.to_bytes(2, "big")
        else:
            out += b"\xdb" + n.to_bytes(4, "big")
        out += b
    elif type(v) is bytes:
        n = len(v)
        if n <= 0xFF:
            out += b"\xc4" + n.to_bytes(1, "big")
        elif n <= 0xFFFF:
            out += b"\xc5" + n.to_bytes(2, "big")
        else:
            out += b"\xc6" + n.to_bytes(4, "big")
        out += v
    else:
        raise _Ineligible(f"unsupported wire scalar {type(v).__name__}")


class _Ineligible(Exception):
    """This request's wire shape cannot be templated (non-canonical
    encoding, unsupported type): the class stays on the full decode."""


def _encode_segments(obj) -> tuple:
    """→ (segments, slots): fixed byte chunks interleaved with the _Slot
    markers found in ``obj`` (segments[i] precedes slots[i];
    len(segments) == len(slots) + 1)."""
    segments: list = []
    slots: list = []
    cur = bytearray()

    def walk(o):
        nonlocal cur
        if isinstance(o, _Slot):
            segments.append(bytes(cur))
            cur = bytearray()
            slots.append(o)
            return
        if isinstance(o, (list, tuple)):
            n = len(o)
            if n < 16:
                cur.append(0x90 | n)
            elif n <= 0xFFFF:
                cur += b"\xdc" + n.to_bytes(2, "big")
            else:
                cur += b"\xdd" + n.to_bytes(4, "big")
            for x in o:
                walk(x)
        elif isinstance(o, dict):
            n = len(o)
            if n < 16:
                cur.append(0x80 | n)
            elif n <= 0xFFFF:
                cur += b"\xde" + n.to_bytes(2, "big")
            else:
                cur += b"\xdf" + n.to_bytes(4, "big")
            for k, v in o.items():
                walk(k)
                walk(v)
        else:
            _pack_scalar(o, cur)

    walk(obj)
    segments.append(bytes(cur))
    return segments, slots


def _parse_scalar(buf: bytes, off: int):
    """Parse ONE msgpack scalar at ``off`` → (value, next_off), or None
    when the bytes are not a scalar (container/ext) or truncated."""
    try:
        b = buf[off]
    except IndexError:
        return None
    if b < 0x80:                        # positive fixint
        return b, off + 1
    if b >= 0xE0:                       # negative fixint
        return b - 0x100, off + 1
    if 0xA0 <= b <= 0xBF:               # fixstr
        end = off + 1 + (b & 0x1F)
        if end > len(buf):
            return None
        return buf[off + 1:end].decode("utf-8"), end
    if b == 0xC0:
        return None, off + 1
    if b == 0xC2:
        return False, off + 1
    if b == 0xC3:
        return True, off + 1
    if b == 0xCB:                       # float64
        end = off + 9
        if end > len(buf):
            return None
        return struct.unpack(">d", buf[off + 1:end])[0], end
    if 0xCC <= b <= 0xCF:               # uint8..64
        end = off + 1 + (1 << (b - 0xCC))
        if end > len(buf):
            return None
        return int.from_bytes(buf[off + 1:end], "big"), end
    if 0xD0 <= b <= 0xD3:               # int8..64
        end = off + 1 + (1 << (b - 0xD0))
        if end > len(buf):
            return None
        return int.from_bytes(buf[off + 1:end], "big", signed=True), end
    if 0xD9 <= b <= 0xDB or 0xC4 <= b <= 0xC6:     # str8..32, bin8..32
        is_str = b >= 0xD9
        hend = off + 1 + (1 << (b - (0xD9 if is_str else 0xC4)))
        if hend > len(buf):
            return None
        end = hend + int.from_bytes(buf[off + 1:hend], "big")
        if end > len(buf):
            return None
        raw = buf[hend:end]
        return (raw.decode("utf-8") if is_str else raw), end
    return None                         # container / ext / reserved


class WireTemplate:
    """Learned byte structure of one request class."""

    __slots__ = ("segments", "slots", "size_floor")

    def __init__(self, segments, slots):
        self.segments = segments
        self.slots = slots
        self.size_floor = sum(len(s) for s in segments) + len(slots)

    def render(self, values) -> bytes:
        out = bytearray()
        for i, seg in enumerate(self.segments):
            if i:
                _pack_scalar(values[i - 1], out)
            out += seg
        return bytes(out)

    def match(self, raw: bytes):
        """→ slot values list, or None on any structural mismatch."""
        if len(raw) < self.size_floor:
            return None
        segs = self.segments
        off = len(segs[0])
        if raw[:off] != segs[0]:
            return None
        values = []
        for i, slot in enumerate(self.slots):
            got = _parse_scalar(raw, off)
            if got is None:
                return None
            v, off = got
            if not slot.guard(v):
                return None
            values.append(v)
            seg = segs[i + 1]
            end = off + len(seg)
            if raw[off:end] != seg:
                return None
            off = end
        if off != len(raw):
            return None
        return values


# --------------------------------------------------------- wire walking

# request keys the fast path understands end to end; anything else in the
# body carries semantics the template cannot replay — ineligible
# (stale_read deliberately absent: the dispatch tier's snapshot has no
# resolved-ts gate, so follower stale reads always take the full path)
_ALLOWED_REQ_KEYS = frozenset((
    "tp", "dag", "force_backend", "paging_size", "resume_token",
    "resource_group", "request_source", "deadline_ms", "trace_id"))

# plan-IR request envelope: same eligibility rules, "plan" body
_ALLOWED_PLAN_KEYS = frozenset((
    "tp", "plan", "force_backend", "paging_size", "resume_token",
    "resource_group", "request_source", "deadline_ms", "trace_id"))


def _check_envelope(req, allowed) -> None:
    if not isinstance(req, dict):
        raise _Ineligible("non-dict request")
    if set(req) - allowed:
        raise _Ineligible("unknown request fields")
    if req.get("tp", 103) != 103 or req.get("force_backend") is not None \
            or req.get("paging_size", 0) or \
            req.get("resume_token") is not None:
        raise _Ineligible("non-fast request options")


def _mark_envelope(marked: dict) -> None:
    """The rotating envelope scalars → slots, in place."""
    if "deadline_ms" in marked:
        if type(marked["deadline_ms"]) is not int:
            raise _Ineligible("non-int deadline")
        marked["deadline_ms"] = _Slot(K_DEADLINE, vtype=int)
    if "trace_id" in marked:
        if type(marked["trace_id"]) is not str:
            raise _Ineligible("non-str trace id")
        marked["trace_id"] = _Slot(K_TRACE_ID, vtype=str)


def _mark_slots(req: dict):
    """Deep-copy ``req`` with per-request scalars replaced by _Slot
    markers → (marked, n_consts).  Raises _Ineligible when the shape
    cannot be fast-pathed."""
    _check_envelope(req, _ALLOWED_REQ_KEYS)
    dag = req.get("dag")
    if not isinstance(dag, dict):
        raise _Ineligible("no dag body")
    n_const = 0

    def mark_expr(e):
        nonlocal n_const
        if not isinstance(e, dict) or "k" not in e:
            raise _Ineligible("malformed expr")
        if e["k"] == "c":
            v = e.get("v")
            out = dict(e)
            # only int/float constants rotate within a class (class_key
            # buckets them by device dtype); str/bytes/None constants are
            # class identity: fixed bytes, and changing one misses
            if type(v) in (int, float):
                out["v"] = _Slot(K_CONST, n_const, type(v),
                                 device_const_dtype(v))
                n_const += 1
            return out
        if e["k"] == "f":
            out = dict(e)
            out["ch"] = [mark_expr(c) for c in e.get("ch", ())]
            return out
        return e

    def mark_exec(ex):
        if not isinstance(ex, dict):
            raise _Ineligible("malformed exec")
        out = dict(ex)
        for key in ("conds", "exprs", "group_by", "partition_by"):
            if key in out:
                out[key] = [mark_expr(e) for e in out[key]]
        if "aggs" in out:
            out["aggs"] = [
                {**a, "arg": mark_expr(a["arg"])
                 if a.get("arg") is not None else None}
                for a in out["aggs"]]
        if "order_by" in out:
            out["order_by"] = [{**o, "e": mark_expr(o["e"])}
                               for o in out["order_by"]]
        return out

    marked = dict(req)
    mdag = dict(dag)
    if "execs" in mdag:
        mdag["execs"] = [mark_exec(ex) for ex in mdag["execs"]]
    if "start_ts" not in mdag or type(mdag["start_ts"]) is not int:
        raise _Ineligible("no start_ts")
    mdag["start_ts"] = _Slot(K_START_TS, vtype=int)
    marked["dag"] = mdag
    _mark_envelope(marked)
    return marked, n_const


def _mark_slots_plan(req: dict):
    """Plan-IR variant of ``_mark_slots``: only the envelope scalars
    rotate (``start_ts``, ``deadline_ms``, ``trace_id``) — every plan
    constant stays FIXED BYTES (a changed constant learns a sibling
    class), so a hit reuses ONE decoded PlanRequest with the TSO
    re-stamped instead of re-walking the node tree."""
    _check_envelope(req, _ALLOWED_PLAN_KEYS)
    plan = req.get("plan")
    if not isinstance(plan, dict):
        raise _Ineligible("no plan body")
    if "start_ts" not in plan or type(plan["start_ts"]) is not int:
        raise _Ineligible("no start_ts")
    marked = dict(req)
    mplan = dict(plan)
    mplan["start_ts"] = _Slot(K_START_TS, vtype=int)
    marked["plan"] = mplan
    _mark_envelope(marked)
    return marked, 0


def _slot_originals(slots, req: dict, body: str) -> list:
    """The learned request's own slot values, in template order — the
    input of the byte-exact render round trip."""
    orig = []
    for s in slots:
        if s.kind == K_CONST:
            orig.append(_const_at(req["dag"], s.index))
        elif s.kind == K_START_TS:
            orig.append(req[body]["start_ts"])
        elif s.kind == K_DEADLINE:
            orig.append(req["deadline_ms"])
        else:
            orig.append(req["trace_id"])
    return orig


def _dag_const_substituter(dag) -> Callable:
    """Precompiled per-class DAG constructor: → make_dag(consts, start_ts)
    rebuilding only the executor subtrees that hold rotating constants
    (columns, ranges, offsets are shared with the learned object).

    The substitution order is the DFS the wire walk uses (executors in
    order; conditions, exprs, aggs and order keys in ``enc_dag``'s field
    order), and ``learn()`` verifies it by equality against the decoded
    DAG."""
    import dataclasses

    from ..copr.dag import (
        AggExprDesc, AggregationDesc, DAGRequest, PartitionTopNDesc,
        ProjectionDesc, SelectionDesc, TopNDesc,
    )
    from ..expr import Expr

    def has_const(e) -> bool:
        if e.kind == "const":
            return type(e.value) in (int, float)
        return any(has_const(c) for c in e.children)

    def sub_expr(e, it):
        if e.kind == "const":
            if type(e.value) in (int, float):
                return Expr(kind="const", value=next(it),
                            eval_type=e.eval_type)
            return e
        if e.kind == "column" or not has_const(e):
            return e
        return dataclasses.replace(
            e, children=tuple(sub_expr(c, it) for c in e.children))

    builders = []
    for ex in dag.executors:
        if isinstance(ex, SelectionDesc) and \
                any(has_const(c) for c in ex.conditions):
            builders.append(lambda it, ex=ex: SelectionDesc(
                tuple(sub_expr(c, it) for c in ex.conditions)))
        elif isinstance(ex, ProjectionDesc) and \
                any(has_const(e) for e in ex.exprs):
            builders.append(lambda it, ex=ex: ProjectionDesc(
                tuple(sub_expr(e, it) for e in ex.exprs)))
        elif isinstance(ex, AggregationDesc) and (
                any(has_const(e) for e in ex.group_by) or
                any(a.arg is not None and has_const(a.arg)
                    for a in ex.aggs)):
            builders.append(lambda it, ex=ex: AggregationDesc(
                tuple(sub_expr(e, it) for e in ex.group_by),
                tuple(AggExprDesc(a.kind, sub_expr(a.arg, it)
                                  if a.arg is not None else None)
                      for a in ex.aggs), ex.streamed))
        elif isinstance(ex, TopNDesc) and \
                any(has_const(e) for e, _ in ex.order_by):
            builders.append(lambda it, ex=ex: TopNDesc(
                tuple((sub_expr(e, it), d) for e, d in ex.order_by),
                ex.limit))
        elif isinstance(ex, PartitionTopNDesc) and (
                any(has_const(e) for e in ex.partition_by) or
                any(has_const(e) for e, _ in ex.order_by)):
            builders.append(lambda it, ex=ex: PartitionTopNDesc(
                tuple(sub_expr(e, it) for e in ex.partition_by),
                tuple((sub_expr(e, it), d) for e, d in ex.order_by),
                ex.limit))
        else:
            builders.append(ex)     # shared verbatim

    ranges, offsets, enc = dag.ranges, dag.output_offsets, dag.encode_type

    def make(consts, start_ts: int) -> DAGRequest:
        it = iter(consts)
        return DAGRequest(
            executors=tuple(b if not callable(b) else b(it)
                            for b in builders),
            ranges=ranges, start_ts=start_ts,
            output_offsets=offsets, encode_type=enc)

    return make


def _key_template(key: tuple):
    """Compile a plan_key / share-batch-key tuple into a substituter that
    re-stamps the const VALUE leaves — ``("c", value, et)`` triples — in
    DFS order, the wire slot order.  → (fill(consts) → tuple, n_consts)."""
    count = 0

    def compile_node(t):
        nonlocal count
        if isinstance(t, tuple):
            if len(t) == 3 and t[0] == "c" and type(t[1]) in (int, float):
                count += 1
                et = t[2]
                return lambda it, et=et: ("c", next(it), et)
            subs = [compile_node(x) for x in t]
            if all(not callable(s) for s in subs):
                return t
            return lambda it, subs=tuple(subs): tuple(
                s if not callable(s) else s(it) for s in subs)
        return t

    node = compile_node(key)

    def fill(consts):
        if not callable(node):
            return key
        return node(iter(consts))

    return fill, count


# ----------------------------------------------------------- the cache

class _ClassEntry:
    """One learned request class: template + everything a hit needs
    pre-bound.

    ``tier`` names how much of the ceremony a hit skips:

    - ``dispatch`` — a device-cached TableScan: skip the decode AND the
      snapshot and routing, go to the coalescer against the learned
      snapshot generation;
    - ``decode`` — a host-routed IndexScan: skip ``wire.unpack`` and the
      DAG decode, then run the FULL serving ceremony (snapshot, routing,
      freshness) with the pre-built DAG;
    - ``plan`` — plan-IR classes: skip ``wire.unpack``, the plan decode
      and analysis, re-stamp the TSO on one decoded PlanRequest, then
      ``handle_plan`` runs its normal ceremony.
    """

    __slots__ = (
        "template", "make_dag", "make_plan", "tier", "class_key",
        "key_hint", "ranges", "base_key", "storage_ref", "config_gen",
        "bkey", "share_fill", "n_est", "d2h_bytes", "hits", "invalidated")

    def __init__(self, tier: str, template, class_key, config_gen: int):
        self.tier = tier
        self.template = template
        self.class_key = class_key
        self.config_gen = config_gen
        self.hits = 0
        self.invalidated = None     # reason str once dead
        self.make_dag = None
        self.make_plan = None
        # the dispatch tier's pre-derived snapshot ceremony
        self.key_hint = None
        self.ranges = None
        self.base_key = None
        self.storage_ref = None
        self.bkey = None
        self.share_fill = None
        self.n_est = None
        self.d2h_bytes = 0.0

    def storage(self):
        ref = self.storage_ref
        return ref() if ref is not None else None


class FastPathCache:
    """Bounded per-class template cache (one per node).

    ``find(raw)`` → (entry, values) on a byte-level hit; ``learn()``
    admits a class from a full-decode execution.  Entries live in ONE
    move-to-front list: every TableScan request shares its first wire
    bytes (map header, "tp", "dag", "execs", "tscan"), so no fixed prefix
    discriminates classes; a linear walk with a fail-fast first-segment
    comparison costs a few µs at the capacity bound, and move-to-front
    keeps the hottest class first."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(0, int(capacity))
        self._mu = threading.Lock()
        self._entries: list = []        # front = most recently hit
        # negative cache: classes whose learn attempt was rejected — else
        # every request of such a class would repay the whole template
        # construction, more than the decode this cache removes
        self._learn_rejects: "OrderedDict" = OrderedDict()
        self.config_gen = 0
        # counts (under _mu): outcome -> count
        self.hit = 0
        self.miss = 0
        self.bypass = 0
        self.invalidate = 0
        self.fallback = 0
        self.learned = 0
        self.reasons: dict = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def _note(self, outcome: str, reason: str) -> None:
        with self._mu:
            setattr(self, outcome, getattr(self, outcome) + 1)
            k = f"{outcome}:{reason}"
            self.reasons[k] = self.reasons.get(k, 0) + 1

    # ------------------------------------------------------------ lookup

    def find(self, raw: bytes):
        """→ (entry, slot values) or (None, reason)."""
        fp = fail_point("copr::fastpath")
        if fp is not None:
            # the miss and full-decode arms take the full decode outright;
            # the corrupt arm flips a byte of a learned template FIRST —
            # the match must then miss (never mis-extract) and re-learn
            arm = fp.value or "miss"
            if arm == "corrupt":
                self._corrupt_one()
            self._note("bypass", f"failpoint_{arm}")
            return None, "failpoint"
        if not self.enabled:
            return None, "disabled"
        with self._mu:
            cands = list(self._entries)
            gen = self.config_gen
        for ent in cands:
            if ent.invalidated is not None:
                continue
            if ent.config_gen != gen:
                self.drop(ent, "config")
                continue
            values = ent.template.match(raw)
            if values is not None:
                with self._mu:
                    # move-to-front: the hottest class matches first, and
                    # the capacity bound evicts the coldest
                    try:
                        self._entries.remove(ent)
                        self._entries.insert(0, ent)
                    except ValueError:      # raced an evict — fine
                        pass
                return ent, values
        self._note("miss", "no_template" if not cands else "mismatch")
        return None, "mismatch"

    def _corrupt_one(self) -> None:
        with self._mu:
            ent = self._entries[0] if self._entries else None
        if ent is None:
            return
        segs = ent.template.segments
        for i, s in enumerate(segs):
            if s:
                segs[i] = bytes([s[0] ^ 0xFF]) + s[1:]
                break

    # ------------------------------------------------------------- learn

    def _build(self, raw: bytes, req: dict, body: str, reject_key):
        """Template construction and the byte-exact render round trip
        (the template's encoder agrees with the client's msgpack for THIS
        shape) → (template, slots, original slot values, n_const), or
        None after noting the rejection."""
        try:
            marked, n_const = (_mark_slots if body == "dag"
                               else _mark_slots_plan)(req)
            segments, slots = _encode_segments(marked)
            template = WireTemplate(segments, slots)
            orig = _slot_originals(slots, req, body)
            if template.render(orig) != raw:
                raise _Ineligible("render mismatch")
            return template, slots, orig, n_const
        except Exception as e:   # noqa: BLE001 — ineligible, never fatal
            self._ineligible(e, reject_key)
            return None

    def _ineligible(self, e: Exception, reject_key) -> None:
        reason = e.args[0] if isinstance(e, _Ineligible) and e.args \
            else "learn_error"
        self._note("bypass", str(reason)[:40])
        self._reject(reject_key)

    def _dag_constructor(self, dag, slots, orig, reject_key):
        """The precompiled DAG constructor, verified to rebuild the decoded
        DAG exactly from the wire-extracted values; None if it does not."""
        try:
            make_dag = _dag_const_substituter(dag)
            consts = [v for s, v in zip(slots, orig) if s.kind == K_CONST]
            if make_dag(consts, dag.start_ts) != dag:
                raise _Ineligible("constructor mismatch")
            return make_dag
        except Exception as e:   # noqa: BLE001 — ineligible, never fatal
            self._ineligible(e, reject_key)
            return None

    def learn(self, raw: bytes, req: dict, info: dict) -> bool:
        """Admit one class from a completed full-decode execution.

        ``req`` is a FRESH unpack of ``raw`` (the executed dict was
        mutated by the handlers); ``info`` carries what the execution
        learned: dag or plan, class_key, storage, backend, decision,
        batch key, region.  → True when a template was admitted."""
        if not self.enabled:
            return False
        dag = info.get("dag")
        storage = info.get("storage")
        reject_key = info.get("class_key")
        with self._mu:
            if reject_key is not None and \
                    self._learn_rejects.get(reject_key) == self.config_gen:
                # an ineligible class at this config gen: skip the
                # construction entirely
                return False
        if info.get("plan") is not None:
            return self._learn_plan(raw, req, info, reject_key)
        if dag is None:
            self._note("bypass", "no_learn_info")
            return False
        if storage is None or info.get("backend") != "device" or \
                info.get("decision") not in ("device_batched",
                                             "device_solo"):
            # no device-cached storage to pin a dispatch entry to — but an
            # IndexScan class still repays hoisting the decode
            from ..copr.dag import IndexScanDesc
            if dag.executors and isinstance(dag.executors[0],
                                            IndexScanDesc):
                return self._learn_decode(raw, req, info, reject_key)
            self._note("bypass", f"route_{info.get('decision') or 'host'}")
            return False
        if getattr(storage, "feed_lineage", None) is None or \
                not hasattr(storage, "scan_columns"):
            self._note("bypass", "uncached_storage")
            self._reject(reject_key)
            return False
        built = self._build(raw, req, "dag", reject_key)
        if built is None:
            return False
        template, slots, orig, n_const = built
        make_dag = self._dag_constructor(dag, slots, orig, reject_key)
        if make_dag is None:
            return False
        region = info.get("region")
        epoch_ver = info.get("epoch_version")
        if region is None or epoch_ver is None:
            self._note("bypass", "no_region")
            return False
        import weakref

        from .node import encode_first
        ent = _ClassEntry("dispatch", template, info.get("class_key") or
                          ("copr", dag.class_key()), self.config_gen)
        ent.make_dag = make_dag
        ent.key_hint = encode_first(dag.ranges[0].start
                                    if dag.ranges else b"")
        ent.ranges = dag.ranges
        scan = dag.executors[0]
        ent.base_key = (region, epoch_ver, scan.table_id,
                        tuple((c.col_id, c.is_pk_handle, c.field_type.tp)
                              for c in scan.columns))
        ent.storage_ref = weakref.ref(storage)
        bkey = info.get("bkey")
        ent.bkey = bkey
        head = bkey[0] if bkey else None
        nested = bkey[2] if head == "slice" and len(bkey) > 2 else None
        if "share" in (head, nested):
            # ("share", ...) and slice-share keys embed the const-SENSITIVE
            # plan_key — pre-compile the const re-stamping so a hit never
            # walks the expression tree to rebuild it
            fill, n = _key_template(bkey)
            if n != n_const:
                # const order or coverage disagreement — never guess
                self._note("bypass", "share_key_shape")
                self._reject(reject_key)
                return False
            ent.share_fill = fill
        elif bkey is not None and "stack" not in (head, nested):
            # an unknown key shape: reusing it verbatim could group
            # mismatched kernels — stay on the full decode
            self._note("bypass", "batch_key_shape")
            self._reject(reject_key)
            return False
        ent.n_est = info.get("n_est")
        ent.d2h_bytes = info.get("d2h_bytes", 0.0)
        self._admit(ent)
        return True

    def _admit(self, ent: _ClassEntry) -> None:
        with self._mu:
            # retire dead entries and any template this one SUPERSEDES —
            # the same fixed segments and slot kinds match exactly the
            # same bytes, so only the new one (the current generation) can
            # win.  Not class_key: one const-blind class over two regions
            # is two templates that must coexist
            kinds = [s.kind for s in ent.template.slots]
            self._entries[:] = [
                e for e in self._entries
                if e.invalidated is None and not (
                    e.template.segments == ent.template.segments and
                    [s.kind for s in e.template.slots] == kinds)]
            self._entries.insert(0, ent)
            del self._entries[self.capacity:]
            self.learned += 1

    def _learn_decode(self, raw: bytes, req: dict, info: dict,
                      reject_key) -> bool:
        """Admit a DECODE-tier class (host-routed IndexScan): the same two
        self-validations as the dispatch tier, but nothing snapshot-bound
        is captured — a hit replays the full serving ceremony with only
        the wire decode hoisted."""
        dag = info["dag"]
        built = self._build(raw, req, "dag", reject_key)
        if built is None:
            return False
        template, slots, orig, _ = built
        make_dag = self._dag_constructor(dag, slots, orig, reject_key)
        if make_dag is None:
            return False
        ent = _ClassEntry("decode", template, info.get("class_key") or
                          ("copr", dag.class_key()), self.config_gen)
        ent.make_dag = make_dag
        self._admit(ent)
        return True

    def _learn_plan(self, raw: bytes, req: dict, info: dict,
                    reject_key) -> bool:
        """Admit a PLAN-tier class: one decoded PlanRequest a wire shape
        (constants are class identity, only the TSO envelope rotates), so
        a repeat skips ``wire.unpack`` and the plan decode and goes to
        ``handle_plan``, which runs its per-leaf snapshot and fragment
        routing as always."""
        import dataclasses
        preq = info["plan"]
        built = self._build(raw, req, "plan", reject_key)
        if built is None:
            return False

        def make_plan(start_ts: int, preq=preq):
            return dataclasses.replace(preq, start_ts=start_ts)

        # re-stamping the learned TSO reproduces the decoded request
        if make_plan(preq.start_ts) != preq:
            self._ineligible(_Ineligible("constructor mismatch"),
                             reject_key)
            return False
        ent = _ClassEntry("plan", built[0], info.get("class_key") or
                          ("copr_plan", preq.class_key()), self.config_gen)
        ent.make_plan = make_plan
        self._admit(ent)
        return True

    # ------------------------------------------------------ invalidation

    def _reject(self, key) -> None:
        """Negative-cache one class's learn rejection for the CURRENT
        config generation (a config change retries it once)."""
        if key is None:
            return
        with self._mu:
            self._learn_rejects[key] = self.config_gen
            while len(self._learn_rejects) > 256:
                self._learn_rejects.popitem(last=False)

    def drop(self, ent: _ClassEntry, reason: str) -> None:
        if ent.invalidated is None:
            ent.invalidated = reason
            self._note("invalidate", reason)

    def bump_config_gen(self) -> None:
        """Any applied online-config diff retires every learned entry: a
        changed threshold, window or knob may change routing or keying,
        and re-learning one full-decode request a class is cheap."""
        with self._mu:
            self.config_gen += 1

    def note_fallback(self, reason: str) -> None:
        self._note("fallback", reason)

    def note_hit(self, ent: _ClassEntry) -> None:
        ent.hits += 1
        self._note("hit", "ok")

    def configure(self, capacity: Optional[int] = None) -> None:
        with self._mu:
            if capacity is not None:
                self.capacity = max(0, int(capacity))
                del self._entries[self.capacity:]

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._mu:
            total = self.hit + self.miss + self.bypass + self.fallback
            tiers: dict = {}
            for e in self._entries:
                tiers[e.tier] = tiers.get(e.tier, 0) + 1
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "classes": len(self._entries),
                "tiers": tiers,
                "learned": self.learned,
                "hit": self.hit, "miss": self.miss,
                "bypass": self.bypass, "fallback": self.fallback,
                "invalidate": self.invalidate,
                "hit_rate": round(self.hit / total, 4) if total else 0.0,
                "config_gen": self.config_gen,
                "reasons": dict(self.reasons),
            }


# ------------------------------------------------- response encoding

_PACKER_LOCAL = threading.local()


def encode_response(env: dict, result) -> bytes:
    """A hit's response → wire bytes through ONE thread-local
    ``msgpack.Packer`` whose buffer is reused across requests
    (``autoreset=False``), the rows taken column-wise
    (``ColumnBatch.rows``).  Byte-equal to the full-decode leg's
    ``wire.pack`` of ``{"rows": ..., **envelope}``: msgpack packs a row
    tuple as the array ``enc_rows`` makes of it."""
    import msgpack

    from .wire import _default
    p = getattr(_PACKER_LOCAL, "p", None)
    if p is None:
        p = _PACKER_LOCAL.p = msgpack.Packer(
            use_bin_type=True, default=_default, autoreset=False)
    rows = result.batch.rows() if result.batch.num_rows else []
    try:
        p.pack({"rows": rows, **env})
        return p.bytes()
    finally:
        p.reset()


def _const_at(dag_dict: dict, index: int):
    """The ``index``-th rotating (int/float) constant of the wire dag, in
    the DFS order ``_mark_slots`` assigns."""
    found = []

    def walk_expr(e):
        if e.get("k") == "c":
            if type(e.get("v")) in (int, float):
                found.append(e["v"])
        elif e.get("k") == "f":
            for c in e.get("ch", ()):
                walk_expr(c)

    for ex in dag_dict.get("execs", ()):
        for key in ("conds", "exprs", "group_by", "partition_by"):
            for e in ex.get(key, ()):
                walk_expr(e)
        for a in ex.get("aggs", ()):
            if a.get("arg") is not None:
                walk_expr(a["arg"])
        for o in ex.get("order_by", ()):
            walk_expr(o["e"])
    return found[index]
