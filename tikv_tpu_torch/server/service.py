"""The Tikv service handlers.

A trimmed copy of the JAX package's ``server/service.py``: ``KvService``
with ``handle`` (dict requests, reference :84), ``handle_raw`` (packed
requests, :123-300: the compiled fast path first — a template hit skips
``wire.unpack``, the DAG decode and the plan analysis and returns a
pre-packed response; a miss takes the full decode, which learns the
class for its next repeat), ``_dispatch_rpc`` with deadline admission
and the read pool (:337), the transactional methods (``KvGet`` with its
resolved-ts gate for a stale read … ``KvTxnHeartBeat``, :541-655), the
raw methods, ``Coprocessor`` (:716-782: DAG, plan IR, ANALYZE tp 104,
CHECKSUM tp 105, paging, ``force_backend`` and ``stale_read``), the
server-streamed coprocessor pages (``copr_stream``, :864-906: one
snapshot a stream) and the ``batch_commands`` mux (:908-975), raft
ingress (``SnapshotChunk``, ``Raft``, ``BatchRaft``, :977-1024), the
region admin RPCs (``SplitRegion``, ``ChangePeer``, ``ChangePeerV2``,
``TransferLeader``, ``RegionApplied``, ``MergeRegion``,
``RollbackMerge``, ``Status``, :1026-1059), ``CheckLeader`` (the
follower's half of the resolved-ts fan-out, :1061-1084), and the
bulk-load import surface (``ImportUpload``, ``ImportIngest``,
``ImportSwitchMode``, :1094-1138).  ``paused`` is the service-event
channel's PAUSE_GRPC.

Refused by name (``_REFUSED``: an ``unimplemented`` error naming what
the method waits for): ``KvGC``, ``Detect`` and the debug service's
methods; the ``Cdc`` and ``Backup`` streams likewise
(``refused_stream``).  Not here either: causal tracing (a read response,
a fast-path hit's too, carries the port tracker's phases and labels as
its ``time_detail``; the label ``fastpath`` names the fast leg a hit
took), RU metering and resource groups.

Reference: src/server/service/kv.rs — the ``Tikv`` service's unary KV
RPCs (:251-410), ``coprocessor`` (:493), ``coprocessor_stream`` (:632),
raft ingress (:684, :737) and ``batch_commands`` (:921).  Handlers are
transport-agnostic callables dict → dict; ``server.py`` binds them to
gRPC methods.
"""

from __future__ import annotations

import threading
from typing import Callable

from ..copr.endpoint import CopRequest, CopResponse, Endpoint, REQ_TYPE_DAG
from ..storage import Storage
from ..storage.txn import commands as cmds
from ..storage.txn.actions import Mutation
from ..utils import tracker
from . import wire


# read RPCs dispatched through the read pool (src/read_pool.rs: both
# Storage reads and coprocessor share the unified pool); point reads get
# high priority so scans can't starve them
_READ_METHODS = {
    "KvGet": "high", "KvBatchGet": "high", "KvScan": "normal",
    "RawGet": "high", "RawBatchGet": "high", "RawScan": "normal",
    "Coprocessor": "normal",
}

# methods of the reference's service the port refuses, by name → what
# each waits for
_REFUSED = {
    "KvGC": "GC (storage/txn/gc.py)",
    "Detect": "the lock manager's deadlock detector",
    "Cdc": "CDC (cdc/)",
    "Backup": "backup (backup.py)",
    **{m: "the debug service (server/debug.py)" for m in (
        "DebugGet", "DebugRegionInfo", "DebugRegionSize",
        "DebugScanMvcc", "DebugRaftLog", "DebugRecoverRegion",
        "DebugCompact")},
}


def refused(method: str) -> dict:
    return {"kind": "unimplemented", "method": method,
            "waits_for": _REFUSED[method]}


class KvService:
    """All RPC handlers over one node's Storage + raftstore."""

    def __init__(self, node):
        self.node = node
        self.storage: Storage = node.storage
        self.endpoint: Endpoint = node.endpoint
        self.read_pool = node.read_pool
        # partially-received chunked snapshots: key -> {seq: bytes};
        # assembled payloads: key -> bytes (src/server/snap.rs recv task)
        self._snap_parts: dict = {}
        self._snap_ready: dict = {}
        self._snap_lock = threading.Lock()
        # raft ingress counts: BatchRaft calls and SnapshotChunk calls
        # taken, raft messages stepped, snapshots dropped incomplete
        self.raft_batches = 0
        self.snap_chunks = 0
        self.raft_msgs = 0
        self.snap_incomplete = 0
        # staged bulk-load SSTs by uuid (src/import/sst_service.rs)
        self._import_lock = threading.Lock()
        self._import_parts: dict = {}
        self._import_staged: dict = {}
        # ServiceEvent PAUSE_GRPC state (components/service)
        self.paused = False

    # ---------------------------------------------------------- helpers

    def _guard(self, fn: Callable[[dict], dict], req: dict) -> dict:
        try:
            return fn(req)
        except Exception as e:      # noqa: BLE001 — errors ride the wire
            return {"error": wire.enc_error(e)}

    @staticmethod
    def _time_detail(tr) -> dict:
        return {"phases_ms": {k: v / 1e6 for k, v in tr.phases.items()},
                "labels": dict(tr.labels)}

    def handle(self, method: str, req: dict) -> dict:
        if self.paused:
            # ServiceEvent.PAUSE_GRPC (components/service): reject
            # instead of queueing — clients back off and retry
            return {"error": {"kind": "server_is_busy",
                              "reason": "service paused"}}
        if method in _REFUSED:
            return {"error": refused(method)}
        fn = getattr(self, method, None)
        if fn is None or method.startswith("_") or \
                not method[:1].isupper():
            return {"error": {"kind": "unimplemented", "method": method}}
        prio = _READ_METHODS.get(method)
        if prio is None:
            return self._dispatch_rpc(method, fn, req, None)
        # one tracker per read, installed BEFORE admission/decode so even
        # a shed or deadline-exceeded response carries its time_detail
        tr, tok = tracker.install()
        try:
            resp = self._dispatch_rpc(method, fn, req, prio)
        finally:
            tracker.uninstall(tok)
        if isinstance(resp, dict):
            resp.setdefault("time_detail", self._time_detail(tr))
        return resp

    def handle_raw(self, method: str, raw: bytes):
        """RAW-bytes entry for packed requests (the server binds the raw
        ``Coprocessor`` method here): the compiled fast path
        (``server/fastpath.py``) template-matches the bytes first — a hit
        skips ``wire.unpack``, the DAG decode and the plan analysis and
        returns a PRE-PACKED response body; any miss takes the full
        decode, which doubles as the learner of the shape's next repeat."""
        fp = self.node.fastpath
        if self.paused or method != "Coprocessor" or not fp.enabled:
            return self.handle(method, wire.unpack(raw))
        out = self._fastpath_serve(fp, raw)
        if out is not None:
            return out
        req = wire.unpack(raw)
        learnable = isinstance(req, dict) and \
            ("dag" in req or "plan" in req) and \
            req.get("force_backend") is None and \
            not req.get("paging_size") and \
            req.get("resume_token") is None and \
            not req.get("stale_read") and \
            req.get("tp", REQ_TYPE_DAG) == REQ_TYPE_DAG
        if learnable:
            # the learning channel: the endpoint and the node fill in what
            # the execution decides (storage, backend, route, region)
            req["__fp_learn"] = {}
        resp = self.handle(method, req)
        learn = req.pop("__fp_learn", None) if isinstance(req, dict) \
            else None
        if learn and ("dag" in learn or "plan" in learn) and \
                isinstance(resp, dict) and not resp.get("error"):
            # from a FRESH unpack: the executed dict was mutated by the
            # handlers (stashes popped, keys added)
            try:
                fp.learn(raw, wire.unpack(raw), learn)
            except Exception:   # noqa: BLE001 — learning is optional
                import logging
                logging.getLogger(__name__).warning(
                    "fastpath learn failed", exc_info=True)
        return resp

    def _fastpath_serve(self, fp, raw: bytes):
        """One fast-path attempt → packed response bytes (a hit), an error
        dict (a hit that failed: the server packs it), or None (no
        template, or the learned generation moved: take the full decode)."""
        ent, values = fp.find(raw)
        if ent is None:
            return None
        storage = None
        if ent.tier == "dispatch":
            # the generation guard: the learned snapshot must still be its
            # line's NEWEST generation — a delta patch, a rebuild, an
            # epoch sweep or an eviction since the learn retires the entry
            # and this request re-learns.  The decode and plan tiers replay
            # the full ceremony, which decides freshness itself
            storage = ent.storage()
            if storage is None or not self.node.copr_cache.is_current(
                    ent.base_key, storage):
                fp.drop(ent, "generation")
                return None
        consts = []
        start_ts = 0
        deadline_ms = None
        for slot, v in zip(ent.template.slots, values):
            if slot.kind == "const":
                consts.append(v)
            elif slot.kind == "start_ts":
                start_ts = v
            elif slot.kind == "deadline_ms":
                deadline_ms = v
        tr, tok = tracker.install()
        try:
            env, result = self._fastpath_dispatch(
                fp, ent, storage, consts, start_ts, deadline_ms)
        finally:
            tracker.uninstall(tok)
        env["time_detail"] = self._time_detail(tr)
        if result is None:
            return env      # an error: a dict, the server packs it
        from .fastpath import encode_response
        return encode_response(env, result)

    def _fastpath_dispatch(self, fp, ent, storage, consts,
                           start_ts: int, deadline_ms):
        """The fast leg of ``_dispatch_rpc``: deadline admission → a
        read-pool slot → the validated snapshot → the coalescer or a solo
        dispatch → the await outside the slot.  → (response envelope,
        SelectResult, or None with an error envelope)."""
        from ..utils import deadline as dl_mod
        from ..utils.deadline import Deadline, DeadlineExceeded
        tracker.label("fastpath",
                      "hit" if ent.tier == "dispatch" else ent.tier)
        dl = None
        if deadline_ms is not None:
            dl = Deadline.after_ms(deadline_ms)
            try:
                dl.check("admission")
            except DeadlineExceeded as e:
                return {"error": wire.enc_error(e)}, None
        if ent.tier == "plan":
            preq = ent.make_plan(start_ts)
        else:
            dag = ent.make_dag(consts, start_ts)

        def dispatch():
            if ent.tier == "plan":
                # the wire decode and the plan analysis are hoisted;
                # handle_plan runs its per-leaf snapshot and fragment
                # routing as always
                fp.note_hit(ent)
                return self.endpoint.handle_plan(preq)
            creq = CopRequest(REQ_TYPE_DAG, dag)
            if ent.tier == "decode":
                # only the wire decode is skipped: the full ceremony
                # (snapshot, routing, freshness) runs again
                fp.note_hit(ent)
                return self.endpoint.handle_async(creq)
            got = self.node.fastpath_snapshot(ent, start_ts)
            if got is None or got is not storage:
                # the generation moved between the guard and the slot (a
                # racing write or split): serve the CURRENT data through
                # the full ceremony, the decoded DAG in hand, and retire
                # the entry for a re-learn
                fp.drop(ent, "generation")
                fp.note_fallback("generation")
                tracker.label("fastpath", "fallback")
                return self.endpoint.handle_async(creq)
            fp.note_hit(ent)
            return self.endpoint.handle_async_fast(creq, got, ent, consts)

        dl_tok = dl_mod.install(dl) if dl is not None else None
        try:
            d = self.read_pool.run(dispatch, "normal", deadline=dl,
                                   class_key=ent.class_key)
            with tracker.phase("await_deferred"):
                # the plan tier answers at once (handle_plan is
                # synchronous); the DAG tiers park on the device fetch
                resp = d.wait() if hasattr(d, "wait") else d
        except Exception as e:  # noqa: BLE001 — errors ride the wire
            return {"error": wire.enc_error(e)}, None
        finally:
            if dl is not None:
                dl_mod.uninstall(dl_tok)
        if dl is not None and dl.expired():
            # an acknowledged response never comes from work whose
            # deadline passed mid-flight
            return {"error": wire.enc_error(DeadlineExceeded(
                "completion", overrun_ms=-dl.remaining() * 1e3))}, None
        return self._cop_envelope(resp), resp.result

    def _dispatch_rpc(self, method: str, fn, req: dict, prio) -> dict:
        from ..utils import deadline as dl_mod
        from ..utils.deadline import Deadline, DeadlineExceeded
        # deadline admission (overload defense): the request carries its
        # REMAINING budget at send time; work that is dead on arrival is
        # shed before touching the read pool
        dl = None
        budget = req.get("deadline_ms") if isinstance(req, dict) else None
        if budget is not None:
            dl = Deadline.after_ms(budget)
            try:
                dl.check("admission")
            except DeadlineExceeded as e:
                return {"error": wire.enc_error(e)}
        # read-pool compile-class key: the pool's service-time EWMA is
        # keyed by the request's COST SHAPE — for coprocessor requests
        # the const-blind plan class, the RPC method otherwise.  The
        # decode is reused by the Coprocessor handler (stashed on the
        # request), so the classing costs no second parse.
        class_key = method if prio is not None else None
        if method == "Coprocessor" and isinstance(req, dict) and \
                "dag" in req:
            try:
                with tracker.phase("plan_decode"):
                    dag_obj = wire.dec_dag(req["dag"])
                req["__dag"] = dag_obj
                class_key = ("copr", dag_obj.class_key())
                req["__trace_class"] = class_key
            except Exception:   # noqa: BLE001 — handler reports it
                pass
        elif method == "Coprocessor" and isinstance(req, dict) and \
                "plan" in req:
            try:
                with tracker.phase("plan_decode"):
                    plan_obj = wire.dec_plan(req["plan"])
                req["__plan"] = plan_obj
                class_key = ("copr_plan", plan_obj.class_key())
                req["__trace_class"] = class_key
            except Exception:   # noqa: BLE001 — handler reports it
                pass
        # the deadline rides a thread-local so the executor pipeline and
        # the device dispatch path can shed without a parameter
        dl_tok = dl_mod.install(dl) if dl is not None else None
        try:
            if prio is not None:
                resp = self._guard(
                    lambda r: self.read_pool.run(
                        lambda: fn(r), prio, deadline=dl,
                        class_key=class_key), req)
                d = resp.pop("__deferred", None) \
                    if isinstance(resp, dict) else None
                if d is not None:
                    # async copr: the read-pool slot covered only the
                    # dispatch; the D2H fetch resolves on the endpoint's
                    # completion pool while THIS thread parks here
                    def _await(_r):
                        with tracker.phase("await_deferred"):
                            got = d.wait()
                        return self._enc_cop_resp(got)
                    resp = self._guard(_await, req)
            else:
                resp = self._guard(fn, req)
        finally:
            if dl is not None:
                dl_mod.uninstall(dl_tok)
        if dl is not None and dl.expired() and \
                isinstance(resp, dict) and not resp.get("error"):
            # an acknowledged response must NEVER come from work whose
            # deadline passed mid-flight
            resp = {"error": wire.enc_error(DeadlineExceeded(
                "completion", overrun_ms=-dl.remaining() * 1e3))}
        return resp

    # ---------------------------------------------------------- txn KV

    def KvGet(self, req: dict) -> dict:
        stale = req.get("stale_read", False)
        if stale:
            # the stale-read rule: a follower serves locally ONLY when
            # read_ts ≤ its resolved-ts watermark — below it no new commit
            # can appear, so applied state answers the MVCC read exactly;
            # above it DataIsNotReady sends the client to the leader or a
            # ReadIndex read
            from ..raftstore.metapb import DataIsNotReady
            from ..storage.txn_types import encode_key
            peer = self.node.raft_store.peer_by_key(encode_key(req["key"]))
            rts = self.node.resolved_ts.resolver(
                peer.region.id).resolved_ts
            if req["version"] > rts:
                raise DataIsNotReady(peer.region.id, rts, req["version"])
        with tracker.phase("kv_read"):
            v = self.storage.get(req["key"], req["version"],
                                 tuple(req.get("bypass_locks", ())),
                                 replica_read=req.get("replica_read",
                                                      False),
                                 stale_read=stale)
        return {"value": v, "not_found": v is None}

    def KvBatchGet(self, req: dict) -> dict:
        with tracker.phase("kv_read"):
            pairs = self.storage.batch_get(req["keys"], req["version"])
        return {"pairs": [{"key": k, "value": v} for k, v in pairs]}

    def KvScan(self, req: dict) -> dict:
        with tracker.phase("kv_read"):
            pairs = self.storage.scan(req["start_key"],
                                      req.get("end_key") or None,
                                      req["limit"], req["version"],
                                      req.get("reverse", False))
        return {"pairs": [{"key": k, "value": v} for k, v in pairs]}

    def KvPrewrite(self, req: dict) -> dict:
        muts = [Mutation(m["op"], m["key"], m.get("value"))
                for m in req["mutations"]]
        return self.storage.sched_txn_command(cmds.Prewrite(
            muts, req["primary"], req["start_version"],
            lock_ttl=req.get("lock_ttl", 3000),
            txn_size=req.get("txn_size", 0),
            min_commit_ts=req.get("min_commit_ts", 0),
            is_pessimistic_lock=req.get("is_pessimistic_lock", ()),
            use_async_commit=req.get("use_async_commit", False),
            secondaries=req.get("secondaries", ()),
            try_one_pc=req.get("try_one_pc", False)))

    def KvCheckSecondaryLocks(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.CheckSecondaryLocks(
            req["keys"], req["start_version"]))

    def KvCommit(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.Commit(
            req["keys"], req["start_version"], req["commit_version"]))

    def KvBatchRollback(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.Rollback(
            req["keys"], req["start_version"]))

    def KvCleanup(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.Cleanup(
            req["key"], req["start_version"], req["current_ts"]))

    def KvCheckTxnStatus(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.CheckTxnStatus(
            req["primary_key"], req["lock_ts"], req["caller_start_ts"],
            req["current_ts"]))

    def KvResolveLock(self, req: dict) -> dict:
        if req.get("keys"):
            return self.storage.sched_txn_command(cmds.ResolveLockLite(
                req["start_version"], req.get("commit_version", 0),
                req["keys"]))
        return self.storage.sched_txn_command(cmds.ResolveLock(
            req["start_version"], req.get("commit_version", 0)))

    def KvPessimisticLock(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.AcquirePessimisticLock(
            req["keys"], req["primary"], req["start_version"],
            req["for_update_ts"], req.get("lock_ttl", 3000),
            req.get("return_values", False),
            wait_timeout_s=req.get("wait_timeout_s", 0.0)))

    def KvPessimisticRollback(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.PessimisticRollback(
            req["keys"], req["start_version"], req["for_update_ts"]))

    def KvTxnHeartBeat(self, req: dict) -> dict:
        return self.storage.sched_txn_command(cmds.TxnHeartBeat(
            req["primary_key"], req["start_version"], req["advise_ttl"]))

    # ---------------------------------------------------------- raw KV

    def RawGet(self, req: dict) -> dict:
        v = self.storage.raw_get(req["key"])
        return {"value": v, "not_found": v is None}

    def RawBatchGet(self, req: dict) -> dict:
        return {"pairs": [{"key": k, "value": v} for k, v in
                          self.storage.raw_batch_get(req["keys"])]}

    def RawPut(self, req: dict) -> dict:
        self.storage.raw_put(req["key"], req["value"])
        return {}

    def RawBatchPut(self, req: dict) -> dict:
        self.storage.raw_batch_put(
            [(p["key"], p["value"]) for p in req["pairs"]])
        return {}

    def RawDelete(self, req: dict) -> dict:
        self.storage.raw_delete(req["key"])
        return {}

    def RawDeleteRange(self, req: dict) -> dict:
        self.storage.raw_delete_range(req["start_key"], req["end_key"])
        return {}

    def RawScan(self, req: dict) -> dict:
        pairs = self.storage.raw_scan(req["start_key"],
                                      req.get("end_key") or None,
                                      req["limit"],
                                      req.get("reverse", False))
        return {"kvs": [{"key": k, "value": v} for k, v in pairs]}

    # ---------------------------------------------------------- copr

    @staticmethod
    def _cop_envelope(resp) -> dict:
        """The non-rows response fields."""
        return {"backend": resp.backend,
                "elapsed_ns": resp.elapsed_ns,
                "is_drained": resp.is_drained,
                "resume_token": resp.resume_token,
                "exec_summaries": [
                    {"rows": s.num_produced_rows,
                     "iters": s.num_iterations,
                     "time_ns": s.time_processed_ns}
                    for s in resp.result.exec_summaries]}

    def _enc_cop_resp(self, resp) -> dict:
        with tracker.phase("resp_serialize"):
            rows = wire.enc_rows(resp.rows())
        return {"rows": rows, **self._cop_envelope(resp)}

    def Coprocessor(self, req: dict) -> dict:
        with tracker.phase("copr_handler"):
            return self._coprocessor(req)

    def _coprocessor(self, req: dict) -> dict:
        tp = req.get("tp", REQ_TYPE_DAG)
        # handle() stashed its class-keying decode; fall back to a fresh
        # parse for direct callers
        predec = req.pop("__dag", None)
        if "plan" in req:
            # plan-IR request: the operator superset (join/sort/window +
            # mixed per-fragment routing, copr/plan_ir.py)
            preq = req.pop("__plan", None) or wire.dec_plan(req["plan"])
            learn = req.get("__fp_learn")
            if learn is not None:
                # the plan tier learns from the decoded request and its
                # class key alone (a hit replays the full ceremony)
                learn["plan"] = preq
                learn["class_key"] = req.get("__trace_class")
            resp = self.endpoint.handle_plan(
                preq, force_backend=req.get("force_backend"))
            return self._enc_cop_resp(resp)
        if tp == 104:       # ANALYZE (endpoint.rs:275-312)
            from ..copr.analyze import AnalyzeReq
            dag = predec or wire.dec_dag(req["dag"])
            stats = self.endpoint.handle_analyze(AnalyzeReq(
                dag.executors[0], dag.ranges,
                req.get("buckets", 64), dag.start_ts))
            return {"columns": [
                {"col_id": s.col_id, "total": s.total,
                 "null_count": s.null_count, "distinct": s.distinct,
                 "buckets": [[b, c] for b, c in s.buckets]}
                for s in stats["columns"]]}
        if tp == 105:       # CHECKSUM (checksum.rs)
            from ..copr.analyze import ChecksumReq
            dag = predec or wire.dec_dag(req["dag"])
            return self.endpoint.handle_checksum(ChecksumReq(
                dag.executors[0], dag.ranges, dag.start_ts))
        if tp != REQ_TYPE_DAG:
            raise ValueError(f"coprocessor request type {tp}")
        dag = predec or wire.dec_dag(req["dag"])
        learn = req.get("__fp_learn")
        if learn is not None:
            # the fast path's learning: the decoded DAG and its class key;
            # the endpoint and the node fill in storage, route and region
            learn["dag"] = dag
            learn["class_key"] = req.get("__trace_class")
        creq = CopRequest(
            REQ_TYPE_DAG, dag, req.get("force_backend"),
            paging_size=req.get("paging_size", 0),
            resume_token=req.get("resume_token"),
            stale_read=req.get("stale_read", False), fp_learn=learn)
        # dispatch under the read-pool slot, await outside it: handle()
        # resolves the "__deferred" marker after the slot is released
        d = self.endpoint.handle_async(creq)
        if d.resolved:
            return self._enc_cop_resp(d.wait())
        return {"__deferred": d}

    def copr_stream_rpc(self, req: dict, ctx=None):
        yield from self.copr_stream(req)

    def copr_stream(self, req: dict):
        """Server-streamed coprocessor pages (service/kv.rs:632
        coprocessor_stream).  One runner instance spans the stream, so
        every page reads the SAME pinned snapshot — unlike offset-based
        unary paging, concurrent writes cannot shift page boundaries.
        The pages are the host pipeline's (``max_rows``)."""
        import time as _time

        from ..executors.runner import BatchExecutorsRunner
        try:
            dag = wire.dec_dag(req["dag"])
            page = req.get("paging_size", 0) or \
                self.node.config.coprocessor.response_page_rows
            creq = CopRequest(REQ_TYPE_DAG, dag)
            storage = self.endpoint.snapshot_for(creq)
            runner = BatchExecutorsRunner(dag, storage)
            while True:
                t0 = _time.perf_counter_ns()
                result = runner.handle_request(max_rows=page)
                yield self._enc_cop_resp(CopResponse(
                    result, _time.perf_counter_ns() - t0, "host"))
                if result.is_drained:
                    return
        except Exception as e:      # noqa: BLE001 — errors ride the wire
            yield {"error": wire.enc_error(e)}

    def refused_stream(self, method: str):
        """A stream of the reference's service the port refuses: one
        message carrying the error."""
        def stream(req: dict, ctx=None):
            yield {"error": refused(method)}
        return stream

    def batch_commands(self, request_iterator):
        """Bidirectional mux (service/kv.rs:921): inbound messages carry
        (request_id, method, req) triples.  Each command dispatches on a
        thread of its own and responses stream back AS THEY COMPLETE — a
        parked command (pessimistic-lock wait) must not head-of-line
        block the very commit that would release it."""
        import queue as _q

        done: "_q.Queue" = _q.Queue()
        sentinel = object()
        outstanding = [0]
        drained = threading.Event()
        mu = threading.Lock()

        def run_one(ent):
            try:
                resp = self.handle(ent["method"], ent.get("req") or {})
                done.put({"request_id": ent["request_id"],
                          "response": resp})
            finally:
                with mu:
                    outstanding[0] -= 1
                    last = outstanding[0] == 0 and drained.is_set()
                if last:
                    done.put(sentinel)

        def feeder():
            # one thread per in-flight command, NOT a bounded pool: N
            # parked pessimistic-lock waits must never occupy every
            # worker and queue the releasing commit behind themselves
            try:
                for batch in request_iterator:
                    for ent in batch.get("requests", ()):
                        with mu:
                            outstanding[0] += 1
                        threading.Thread(target=run_one, args=(ent,),
                                         daemon=True,
                                         name="mux-command").start()
            except Exception:   # noqa: BLE001 — the client went away
                pass
            finally:
                with mu:
                    drained.set()
                    idle = outstanding[0] == 0
                if idle:
                    done.put(sentinel)

        threading.Thread(target=feeder, daemon=True,
                         name="mux-feeder").start()
        while True:
            item = done.get()
            if item is sentinel:
                return
            out = [item]
            while True:     # opportunistic batching of ready responses
                try:
                    nxt = done.get_nowait()
                except _q.Empty:
                    break
                if nxt is sentinel:
                    yield {"responses": out}
                    return
                out.append(nxt)
            yield {"responses": out}

    # ---------------------------------------------------------- raft

    # bound on buffered in-flight snapshots: an unclaimed payload (the
    # raft batch carrying its claim failed; the leader re-sends at a
    # NEW index/key) must not leak for the process lifetime
    _SNAP_BUF_MAX = 8

    def SnapshotChunk(self, req: dict) -> dict:
        """One chunk of a large region snapshot (src/server/snap.rs —
        the dedicated snapshot stream; here ordered unary chunks).
        The final chunk assembles the payload, which the matching raft
        message (carrying only meta + the key) then claims."""
        key = req["key"]
        with self._snap_lock:
            self.snap_chunks += 1
            parts = self._snap_parts.setdefault(key, {})
            parts[req["seq"]] = req["data"]
            if len(parts) == req["total"]:
                self._snap_ready[key] = b"".join(
                    parts[i] for i in range(req["total"]))
                del self._snap_parts[key]
            # evict oldest unclaimed buffers (dict = insertion order)
            for store in (self._snap_parts, self._snap_ready):
                while len(store) > self._SNAP_BUF_MAX:
                    store.pop(next(iter(store)))
        return {}

    def Raft(self, req: dict) -> dict:
        msg = req["msg"]
        snap = msg.get("snap")
        if snap is not None and "ext_key" in snap:
            with self._snap_lock:
                data = self._snap_ready.pop(snap["ext_key"], None)
                if data is None:
                    # chunks lost/incomplete: drop — raft re-sends the
                    # snapshot (snap.rs treats a broken stream the same)
                    self.snap_incomplete += 1
                    return {}
            snap = dict(snap)
            snap.pop("ext_key")
            snap["d"] = data
            msg = dict(msg)
            msg["snap"] = snap
        self.node.on_raft_message(
            req["region_id"], wire.dec_peer(req["to_peer"]),
            wire.dec_peer(req["from_peer"]),
            wire.dec_raft_msg(msg))
        self.raft_msgs += 1
        return {}

    def BatchRaft(self, req: dict) -> dict:
        self.raft_batches += 1
        for m in req["msgs"]:
            self.Raft(m)
        return {}

    # ---------------------------------------------------------- admin

    def SplitRegion(self, req: dict) -> dict:
        right = self.node.split_region(req.get("region_id", 0),
                                       req["split_key"])
        return {"right": wire.enc_region(right)}

    def ChangePeer(self, req: dict) -> dict:
        self.node.change_peer(req["region_id"], req["change_type"],
                              wire.dec_peer(req["peer"]))
        return {}

    def ChangePeerV2(self, req: dict) -> dict:
        changes = [(c["type"], wire.dec_peer(c["peer"]))
                   for c in req["changes"]]
        self.node.change_peer_v2(req["region_id"], changes)
        return {}

    def TransferLeader(self, req: dict) -> dict:
        self.node.transfer_leader(req["region_id"], req["to_peer_id"])
        return {}

    def Status(self, req: dict) -> dict:
        return self.node.status()

    def CheckLeader(self, req: dict) -> dict:
        """Leader→follower resolved-ts propagation (resolved_ts/advance.rs
        check-leader): the leader pushes its watermark and the apply index
        it was computed at; this store advances a region's resolver only
        once its OWN apply has reached that index, never past its own
        pending locks — a lagging replica never over-promises."""
        return {"advanced": self.node.check_leader(req.get("regions", ()))}

    def RegionApplied(self, req: dict) -> dict:
        return {"applied": self.node.region_applied(req["region_id"])}

    def MergeRegion(self, req: dict) -> dict:
        merged = self.node.merge_region(req["source_id"],
                                        req["target_id"])
        return {"region": wire.enc_region(merged)}

    def RollbackMerge(self, req: dict) -> dict:
        self.node.rollback_merge(req["region_id"])
        return {}

    # ---------------------------------------------------------- import
    #
    # Bulk load (src/import/sst_service.rs): ImportUpload stages an SST
    # in parts by uuid, ImportIngest lands it through one raft command,
    # switch_mode pauses housekeeping during the bulk load.

    _IMPORT_STAGE_MAX = 16

    def ImportUpload(self, req: dict) -> dict:
        uuid = req["uuid"]
        with self._import_lock:
            if uuid not in self._import_parts and \
                    uuid not in self._import_staged and \
                    (len(self._import_parts) +
                     len(self._import_staged)) >= self._IMPORT_STAGE_MAX:
                # refuse NEW uploads instead of silently evicting a
                # fully-staged blob someone is about to ingest
                return {"error": {"kind": "server_is_busy",
                                  "reason": "import staging full"}}
            parts = self._import_parts.setdefault(uuid, {})
            parts[req["seq"]] = req["data"]
            done = len(parts) == req["total"]
            if done:
                self._import_staged[uuid] = b"".join(
                    parts[i] for i in range(req["total"]))
                del self._import_parts[uuid]
        return {"staged": done}

    def ImportIngest(self, req: dict) -> dict:
        from ..sst_importer import is_sst_v2, read_sst
        uuid = req["uuid"]
        with self._import_lock:
            blob = self._import_staged.get(uuid)
        if blob is None:
            return {"error": {"kind": "other",
                              "message": f"no staged sst {uuid!r}"}}
        # the staged blob survives a FAILED ingest so the client can
        # retry without re-uploading (sst_service keeps the file the same
        # way)
        if is_sst_v2(blob):
            # v2 column-group container: ONE raft op carries the file,
            # apply bulk-merges sorted runs — no per-row replay
            n = self.node.ingest_sst_blob(req["region_id"], blob)
        else:
            pairs = read_sst(blob)  # ValueError on corruption → guard
            n = self.node.ingest_sst(req["region_id"], pairs)
        with self._import_lock:
            self._import_staged.pop(uuid, None)
        return {"ingested": n}

    def ImportSwitchMode(self, req: dict) -> dict:
        self.node.import_mode = bool(req["import"])
        return {"import_mode": self.node.import_mode}

