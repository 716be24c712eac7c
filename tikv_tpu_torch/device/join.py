"""Device join, sort and window fragments of the plan IR.

Counterpart of the JAX package's ``device/join.py`` ``DeviceJoiner``, on
one CUDA device:

- JOIN (an inner equi-join of two table scans): the build side's key
  column uploads once per (snapshot, version) and ``sort.join_build``
  sorts it into a dictionary on the card — sorted keys, permutation and
  valid-prefix sums, NULL keys sentineled to int64.max and valid rows
  first within equal keys, so duplicate and sentinel-colliding keys join
  exactly — with the direct index of its keys where they are dense
  (``join_probe.join_index``), cached beside it.  The probe side's key
  and predicate planes upload once too; its selection predicates
  evaluate into a bool mask (``selection.sel_pred``, or eval_rpn in
  torch for a signature it does not cover), and
  ``join_probe.join_probe`` emits (probe, build) row pairs into a
  power-of-two capacity sized by a multiplicity EWMA.  An overflow is
  detected by the exact total and run again at the exact power of two,
  never truncated.  Only the pairs cross to the host (8 B a pair); the
  host gathers the columns from the snapshots (late materialization).
- SORT: the transformed keys upload, ``sort.sort_perm`` gives the
  permutation, 4 B a row cross to the host.
- WINDOW: the partition and order keys and the arguments upload,
  ``sort.sort_perm`` orders the rows, ``window.window_scan`` computes
  row_number, the running counts and int64 sums and LAG / LEAD; a REAL
  running sum or AVG stays on the host (``window`` returns None).

Cached dictionaries and probe planes live per snapshot (the anchor: the
snapshot, or its ``feed_lineage``) in a weak-keyed map, so they die with
it, keyed by its ``feed_version`` so a new version re-sorts.  The
``device::join_dispatch`` failpoint faults the probe dispatch.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from ..copr.dag import TableScanDesc
from ..datatype import Column, ColumnBatch, EvalType, FieldType
from ..expr import FUNCTIONS, build_rpn, eval_rpn
from ..utils.failpoint import fail_point
from . import DeviceUnavailable
from . import join_probe as jp
from . import selection as sm
from . import sort as srt
from . import window as win


class JoinDeviceUnavailable(DeviceUnavailable):
    """The device join cannot serve this fragment (the failpoint, or a
    capacity that did not settle): the plan executor degrades the
    fragment to the host join."""


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def join_supported(probe_scan, probe_conds, left_key: int,
                   build_scan, right_key: int) -> bool:
    """The device join's envelope: ascending table scans, signed INT (or
    handle) keys, probe predicates of device-safe signatures over signed
    INT / REAL columns."""
    from .runner import _expr_sigs, _rpn_col_indices, _rpn_device_safe
    for scan, key in ((probe_scan, left_key), (build_scan, right_key)):
        if not isinstance(scan, TableScanDesc) or scan.desc or \
                key >= len(scan.columns):
            return False
        ft = scan.columns[key].field_type
        if not scan.columns[key].is_pk_handle and (
                ft.eval_type is not EvalType.INT or ft.is_unsigned):
            return False
    scan_ets = [c.field_type.eval_type for c in probe_scan.columns]
    for cond in probe_conds:
        if _expr_sigs(cond) - set(FUNCTIONS):
            return False
        rpn = build_rpn(cond)
        if not _rpn_device_safe(rpn, scan_ets) or any(
                probe_scan.columns[i].field_type.is_unsigned or
                scan_ets[i] not in (EvalType.INT, EvalType.REAL)
                for i in _rpn_col_indices(rpn)):
            return False
    return True


def _anchor_version(storage):
    lineage = getattr(storage, "feed_lineage", None)
    anchor = storage if lineage is None else lineage
    v = getattr(storage, "feed_version", None)
    if lineage is not None and v is None:
        v = getattr(lineage, "version", None)
    return anchor, v


class DeviceJoiner:
    """Join / sort / window fragments on one runner's device."""

    MULT_ALPHA = 0.3

    def __init__(self, runner):
        self.device = runner.device
        self._mu = threading.Lock()
        # anchor → {cache key: entry}; entries die with their snapshot
        self._cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        # observed pairs per probe row, per (probe table, build table)
        self._mult: dict = {}
        self.device_joins = 0
        # joins by probe route: "dense" (the build's direct index) or
        # "sparse" (a search of its sorted keys)
        self.probe_routes: dict = {}
        self.overflow_redispatches = 0
        self.build_cache_hits = 0
        self.build_cache_builds = 0
        self.sorts = 0
        self.windows = 0
        # host-clock ms of the last join / sort / window, by phase
        self.phases_ms: dict = {}

    # ------------------------------------------------------------ helpers

    def _phase(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phases_ms[name] = self.phases_ms.get(name, 0.0) + \
            (t1 - t0) * 1e3
        return t1

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(arr)
        if not a.flags.writeable:   # a snapshot's shared all-true buffer
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _entries(self, anchor) -> dict:
        with self._mu:
            ent = self._cache.get(anchor)
            if ent is None:
                ent = self._cache[anchor] = {}
            return ent

    @staticmethod
    def _column(scan, ranges, storage, offset: int):
        """One scan column → (values, validity) at scan-output positions."""
        sub = TableScanDesc(scan.table_id, (scan.columns[offset],))
        col = storage.scan_columns(sub, ranges).columns[0]
        return col.values, np.asarray(col.validity, dtype=np.bool_)

    # --------------------------------------------------------------- join

    def join(self, probe_scan, probe_ranges, probe_storage, probe_conds,
             left_key: int, build_scan, build_ranges, build_storage,
             right_key: int) -> Optional[tuple]:
        """→ (probe rows, build rows) as int64 numpy arrays of scan-output
        positions, probe-major; None outside the envelope.  Raises
        ``JoinDeviceUnavailable`` on a device fault: the plan executor owns
        the degrade."""
        if not join_supported(probe_scan, probe_conds, left_key,
                              build_scan, right_key):
            return None
        self.phases_ms = {}
        t0 = time.perf_counter()
        banchor, bver = _anchor_version(build_storage)
        bents = self._entries(banchor)
        bkey = ("build", bver, build_scan.columns[right_key].col_id,
                tuple(build_ranges))
        ent = bents.get(bkey)
        if ent is None:
            vals, valid = self._column(build_scan, build_ranges,
                                       build_storage, right_key)
            kv = self._upload(vals.astype(np.int64, copy=False))
            km = self._upload(valid)
            t0 = self._phase("upload", t0)
            sk, perm, prefix, keys = srt.join_build(kv, km, len(vals))
            # the direct index of dense keys: its route and span come from
            # the build's one wait, so it queues behind the build
            index = jp.join_index(sk, prefix, keys)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ent = bents[bkey] = {"sk": sk, "perm": perm, "prefix": prefix,
                                 "index": index}
            t0 = self._phase("join_build", t0)
            with self._mu:
                self.build_cache_builds += 1
        else:
            with self._mu:
                self.build_cache_hits += 1

        rpns = [build_rpn(c) for c in probe_conds]
        from .runner import _remap_rpn, _rpn_col_indices
        used = sorted(set().union(*map(_rpn_col_indices, rpns))) \
            if rpns else []
        panchor, pver = _anchor_version(probe_storage)
        pents = self._entries(panchor)
        pkey = ("probe", pver, probe_scan.columns[left_key].col_id,
                tuple(probe_scan.columns[i].col_id for i in used),
                tuple(probe_ranges))
        pent = pents.get(pkey)
        if pent is None:
            kvals, kvalid = self._column(probe_scan, probe_ranges,
                                         probe_storage, left_key)
            planes = []
            for i in used:
                v, ok = self._column(probe_scan, probe_ranges,
                                     probe_storage, i)
                planes.append((self._upload(v),
                               None if ok.all() else self._upload(ok)))
            pent = pents[pkey] = {
                "keys": self._upload(kvals.astype(np.int64, copy=False)),
                "valid": None if kvalid.all() else self._upload(kvalid),
                "planes": planes, "n": len(kvals)}
            t0 = self._phase("upload", t0)
        n = pent["n"]
        mask = None
        if rpns and n:
            remapped = [_remap_rpn(r, {old: new for new, old
                                       in enumerate(used)}) for r in rpns]
            mask = self._probe_mask(remapped, pent, n)
            t0 = self._phase("predicate", t0)
        if fail_point("device::join_dispatch") is not None:
            raise JoinDeviceUnavailable("device::join_dispatch")
        tkey = (probe_scan.table_id, build_scan.table_id)
        with self._mu:
            mult = self._mult.get(tkey, 1.0)
        k_cap = _next_pow2(int(max(64, min(n * max(1.0, mult) * 1.5 + 64,
                                           1 << 27))))
        for _attempt in range(3):
            pairs, tot = jp.join_probe(ent["sk"], ent["perm"],
                                       ent["prefix"], pent["keys"],
                                       pent["valid"], mask, k_cap,
                                       ent["index"])
            total = int(tot)
            t0 = self._phase("join_probe", t0)
            if total <= k_cap:
                host = pairs[:total].cpu().numpy()
                t0 = self._phase("d2h", t0)
                break
            # the total is exact: run again at its power of two
            k_cap = _next_pow2(max(64, total))
            with self._mu:
                self.overflow_redispatches += 1
        else:
            raise JoinDeviceUnavailable("pair capacity did not settle")
        with self._mu:
            self.device_joins += 1
            route = "sparse" if ent["index"] is None else "dense"
            self.probe_routes[route] = self.probe_routes.get(route, 0) + 1
            obs = total / max(1, n)
            old = self._mult.get(tkey)
            self._mult[tkey] = obs if old is None else \
                self.MULT_ALPHA * obs + (1 - self.MULT_ALPHA) * old
            while len(self._mult) > 128:
                self._mult.pop(next(iter(self._mult)))
        return host[:, 0].astype(np.int64), host[:, 1].astype(np.int64)

    def _probe_mask(self, rpns, pent, n: int) -> torch.Tensor:
        """The probe predicate's bool mask over the n probe rows:
        ``sel_pred`` over the probe planes, or eval_rpn in torch (the
        constants hoisted as the reference's parameters) for a signature
        it does not cover."""
        planes = pent["planes"]
        # encoded per request: the program carries the predicate's ops and
        # constants, which the probe entry's key does not name
        try:
            prog = sm.encode_predicate(rpns, tuple(v.dtype
                                                   for v, _ok in planes))
        except sm.Uncovered:
            prog = None
        if prog is not None:
            return sm.sel_pred(prog, planes, n, True)[1]
        true = torch.ones((), dtype=torch.bool, device=self.device)
        pairs = [(v[:n], true if ok is None else ok[:n]) for v, ok in planes]
        param_rpns, values, dts = sm.split_params(rpns, len(pairs))
        from ..expr.eval import _TORCH_DTYPES
        cols = pairs + [(torch.tensor(v, dtype=_TORCH_DTYPES[dt],
                                      device=self.device), true)
                        for v, dt in zip(values, dts)]
        mask = torch.ones(n, dtype=torch.bool, device=self.device)
        for rpn in param_rpns:
            v, ok = eval_rpn(rpn, cols, n, torch, self.device)
            mask &= ok & (v != 0)
        return mask.contiguous()

    # --------------------------------------------------------------- sort

    def sort_perm(self, keys: Sequence[np.ndarray],
                  n: int) -> Optional[np.ndarray]:
        """The stable permutation of n rows by the transformed ``keys``
        (int64 / float64 numpy arrays, ``plan_ir.eval_order_keys``), on
        the device → int64 numpy; None past ``sort.MAX_KEYS`` keys."""
        if len(keys) > srt.MAX_KEYS:
            return None
        self.phases_ms = {}
        t0 = time.perf_counter()
        dev = [self._upload(k) for k in keys]
        t0 = self._phase("upload", t0)
        perm = srt.sort_perm(dev, n)
        out = perm.cpu().numpy().astype(np.int64)
        self._phase("sort_perm", t0)
        with self._mu:
            self.sorts += 1
        return out

    # ------------------------------------------------------------- window

    def window(self, batch: ColumnBatch, node) -> Optional[ColumnBatch]:
        """The window fragment over a host batch → the rows sorted by
        (partition, order) with the window columns appended, or None when
        a function is outside the envelope (a REAL running sum or AVG) or
        the window has more keys, channels or shifts than the kernels
        take."""
        from ..copr.plan_ir import eval_order_keys
        n = batch.num_rows
        cols = [(c.values, c.validity) for c in batch.columns]
        funcs = []
        for f in node.funcs:
            if f.kind == "row_number":
                funcs.append((f.kind, None, None, 0))
                continue
            if f.kind not in ("count", "sum", "avg", "lag", "lead"):
                return None
            rpn = build_rpn(f.arg)
            if rpn.ret_type is not EvalType.INT and \
                    not (f.kind in ("lag", "lead", "count") and
                         rpn.ret_type is EvalType.REAL):
                return None
            v, ok = eval_rpn(rpn, cols, n, np)
            dt = np.int64 if rpn.ret_type is EvalType.INT else np.float64
            v = np.ascontiguousarray(np.broadcast_to(v, (n,)), dtype=dt)
            ok = np.ascontiguousarray(np.broadcast_to(ok, (n,)),
                                      dtype=np.bool_)
            funcs.append((f.kind, v, ok, max(1, int(f.offset))))
        if len(node.partition_by) > win.MAX_PART or \
                len(node.partition_by) + len(node.order_by) > srt.MAX_KEYS \
                or len(funcs) > min(win.MAX_CH // 2, win.MAX_SH):
            return None
        self.phases_ms = {}
        t0 = time.perf_counter()
        part_keys = eval_order_keys(
            batch, tuple((e, False) for e in node.partition_by))
        order_keys = eval_order_keys(batch, node.order_by)
        t0 = self._phase("keys", t0)
        # one upload per distinct host array: the functions over one
        # argument share its values and validity
        uploaded: dict = {}

        def up(a):
            if a is None:
                return None
            key = (a.__array_interface__["data"][0], a.dtype.str, a.shape)
            if key not in uploaded:
                uploaded[key] = self._upload(a)
            return uploaded[key]

        dpart = [up(k) for k in part_keys]
        dorder = [up(k) for k in order_keys]
        dfun = [(kind, up(v), up(ok), off) for kind, v, ok, off in funcs]
        t0 = self._phase("upload", t0)
        if dpart or dorder:
            perm = srt.sort_perm(dpart + dorder, n)
        else:
            perm = torch.arange(n, dtype=torch.int32, device=self.device)
        # one channel per distinct (kind, argument): SUM and AVG of one
        # argument share its running sum and count, COUNT the count
        channels, shifts, chan_of = [], [], {}

        def chan(kind, v, ok) -> int:
            key = (kind, id(v), id(ok))
            if key not in chan_of:
                chan_of[key] = len(channels)
                channels.append((kind, v, ok))
            return chan_of[key]

        slots = []
        for kind, v, ok, off in dfun:
            if kind == "count":
                slots.append((chan("count", None, ok),))
            elif kind in ("sum", "avg"):
                slots.append((chan("sum", v, ok), chan("count", None, ok)))
            elif kind in ("lag", "lead"):
                slots.append((len(shifts),))
                shifts.append((-off if kind == "lag" else off, v, ok))
            else:
                slots.append(())
        rn, ch, sh = win.window_scan(
            perm, dpart, any(k == "row_number" for k, *_ in funcs),
            channels, shifts)
        host = [t.cpu().numpy() for t in
                [perm] + ([rn] if rn is not None else []) + ch +
                [t for pair in sh for t in pair]]
        t0 = self._phase("window_scan", t0)
        perm_h, at = host[0].astype(np.int64), 1
        rn_h = None
        if rn is not None:
            rn_h, at = host[at], at + 1
        ch_h = host[at:at + len(ch)]
        sh_h = host[at + len(ch):]
        sorted_batch = batch.take(perm_h)
        out_cols, out_schema = list(sorted_batch.columns), \
            list(sorted_batch.schema)
        ones = np.ones(n, np.bool_)
        for (kind, _v, _ok, _off), slot in zip(funcs, slots):
            if kind == "row_number":
                out_cols.append(Column(EvalType.INT, rn_h.copy(),
                                       ones.copy()))
                out_schema.append(FieldType.long())
            elif kind == "count":
                out_cols.append(Column(EvalType.INT, ch_h[slot[0]],
                                       ones.copy()))
                out_schema.append(FieldType.long())
            elif kind in ("sum", "avg"):
                csum, ccnt = ch_h[slot[0]], ch_h[slot[1]]
                if kind == "sum":
                    out_cols.append(Column(EvalType.INT, csum, ccnt > 0))
                    out_schema.append(FieldType.long())
                else:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        avg = csum.astype(np.float64) / ccnt
                    out_cols.append(Column(EvalType.REAL,
                                           np.where(ccnt > 0, avg, 0.0),
                                           ccnt > 0))
                    out_schema.append(FieldType.double())
            else:
                vals, valid = sh_h[2 * slot[0]], sh_h[2 * slot[0] + 1]
                et = EvalType.INT if vals.dtype.kind in "iu" \
                    else EvalType.REAL
                out_cols.append(Column(et, vals, valid.astype(np.bool_)))
                out_schema.append(FieldType.long() if et is EvalType.INT
                                  else FieldType.double())
        self._phase("gather", t0)
        with self._mu:
            self.windows += 1
        return ColumnBatch(out_schema, out_cols)

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._mu:
            return {"device_joins": self.device_joins,
                    "probe_routes": dict(self.probe_routes),
                    "build_cache_hits": self.build_cache_hits,
                    "build_cache_builds": self.build_cache_builds,
                    "overflow_redispatches": self.overflow_redispatches,
                    "sorts": self.sorts, "windows": self.windows}
