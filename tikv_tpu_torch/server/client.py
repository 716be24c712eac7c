"""Clients: per-store RPC stub + the PD-routed transactional client.

A trimmed copy of the JAX package's ``server/client.py``: ``StoreClient``,
``BatchCommandsClient`` (the mux's client side) and ``TxnClient`` — region
lookup with backoff and per-store circuit breakers, the leader retry,
Percolator 2PC ``txn_write`` with lock resolution, ``get``/``scan``/
``put``/``delete``, raw, ``coprocessor``, ``coprocessor_plan``,
``coprocessor_paged``, ``coprocessor_stream``, ``analyze``, ``checksum``,
``split``, ``add_peer``, ``remove_peer``, ``change_peers_joint``,
``merge``, ``status``, ``ingest_sst`` and ``import_switch_mode``; the
tail-tolerant reads: ``hedge_reads`` (a point get or a coprocessor read
re-issued to a follower after an adaptive P95 delay: a resolved-ts stale
read first, a ReadIndex replica read as a get's fallback), ``replica_get``
and ``coprocessor_replica`` (a follower's own answer).  Not here: the CDC
stream, backup and restore, and the debug service.

Reference: the store stub mirrors what TiDB holds per TiKV
(src/server/service/kv.rs surface); ``TxnClient`` plays the client-go
role — PD region routing, 2-phase commit (primary first), lock
resolution on conflict — which the reference repo itself leaves to its
callers but its tests exercise via test fixtures.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from ..raftstore.metapb import Peer, Region
from . import wire
from .pd_server import RemotePdClient


class StoreClient:
    """Raw method stub against one tikv-server."""

    def __init__(self, addr: str):
        self.addr = addr
        from .security import make_channel
        self._chan = make_channel(addr)

    def call(self, method: str, req: dict, timeout: float = 10) -> dict:
        fn = self._chan.unary_unary(
            "/tikv.Tikv/" + method, request_serializer=wire.pack,
            response_deserializer=wire.unpack)
        resp = fn(req, timeout=timeout)
        if resp.get("error"):
            raise wire.RemoteError(resp["error"])
        return resp

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda req=None, **kw: self.call(name, req or kw)

    def close(self) -> None:
        self._chan.close()


class BatchCommandsClient:
    """Client side of the batch_commands mux (service/kv.rs:921 +
    service/batch.rs): ONE bidirectional stream carries every RPC,
    demultiplexed by request id — concurrent callers share the stream
    instead of a connection/HTTP2-stream each."""

    def __init__(self, addr: str):
        import queue

        self.addr = addr
        from .security import make_channel
        self._chan = make_channel(addr)
        self._q: "queue.Queue" = queue.Queue()
        self._pending: dict = {}
        self._mu = threading.Lock()
        self._next_id = 0
        self._closed = False
        fn = self._chan.stream_stream(
            "/tikv.Tikv/BatchCommands", request_serializer=wire.pack,
            response_deserializer=wire.unpack)
        self._responses = fn(self._outbound())
        self._recv = threading.Thread(target=self._recv_loop, daemon=True)
        self._recv.start()

    def _outbound(self):
        import queue
        while not self._closed:
            try:
                first = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if first is None:
                return
            batch = [first]
            # drain whatever else queued: one message, many commands
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            yield {"requests": batch}

    def _recv_loop(self):
        try:
            for msg in self._responses:
                for ent in msg.get("responses", ()):
                    with self._mu:
                        box = self._pending.pop(ent["request_id"], None)
                    if box is not None:
                        box["resp"] = ent["response"]
                        box["ev"].set()
        except Exception:
            pass
        with self._mu:
            # stream died: later call()s must fail fast, not park for
            # their full timeout against a reader that will never run
            self._closed = True
            pending, self._pending = self._pending, {}
        for box in pending.values():
            box["ev"].set()     # wake waiters with no resp

    def call(self, method: str, req: dict, timeout: float = 10) -> dict:
        with self._mu:
            if self._closed:
                raise RuntimeError("mux closed")
            self._next_id += 1
            rid = self._next_id
            box = {"ev": threading.Event()}
            self._pending[rid] = box
        self._q.put({"request_id": rid, "method": method, "req": req})
        if not box["ev"].wait(timeout):
            with self._mu:
                self._pending.pop(rid, None)
            raise TimeoutError(f"mux call {method} timed out")
        resp = box.get("resp")
        if resp is None:
            raise RuntimeError("mux stream closed")
        if resp.get("error"):
            raise wire.RemoteError(resp["error"])
        return resp

    def close(self):
        """End the stream and wait for its reader (the channel's sockets
        close with it)."""
        self._closed = True
        self._q.put(None)
        self._recv.join(timeout=5)
        self._chan.close()


class TxnError(Exception):
    pass


def _stale_route(e: "wire.RemoteError") -> bool:
    """The error of a request a stale route sent to the wrong region or
    store: re-resolve and retry.  ``KeyNotInRegion`` is a split (the size
    checker's, or another client's) that landed after the bounds were
    cached; ``region_not_found`` a store that no longer holds the region
    (PD's leader stale after a peer's removal).  The reference's 2PC and
    its by-region calls retry fewer: a transaction over a region split
    behind its cache fails, and so does an admin call routed to a removed
    peer."""
    return e.kind in ("not_leader", "epoch_not_match", "region_not_found",
                      "region_merging") or "KeyNotInRegion" in str(e)


class TxnClient:
    """Transactional client: PD routing + Percolator 2PC.

    Reads/writes route to the region leader by key; on KeyIsLocked the
    client resolves via CheckTxnStatus + ResolveLock (the reference's
    client-side lock resolution protocol).  Tail tolerance (client-go
    shape):

    - every store's transport rides a per-store circuit breaker:
      consecutive transport failures trip it open, a half-open probe
      re-tests after the cooldown, and an open breaker fails sends fast
      instead of feeding a dead or hung store its full RPC timeout;
    - with ``hedge_reads=True``, idempotent point gets and coprocessor
      reads re-issue to a follower replica after an adaptive P95-based
      delay (a resolved-ts stale read first; a get falls back to a
      ReadIndex replica read when the watermark lags); the first usable
      answer wins, the loser is abandoned.  ``hedges`` counts the
      outcomes by name (the reference's HEDGE_COUNTER labels).
    """

    # hedge delay bounds: never hedge inside normal jitter (floor), never
    # wait out most of a deadline before hedging (ceiling)
    HEDGE_DELAY_MIN = 0.002
    HEDGE_DELAY_MAX = 0.5
    HEDGE_LAT_WINDOW = 128

    def __init__(self, pd_addr: str, hedge_reads: bool = False,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0):
        self.pd = RemotePdClient(pd_addr)
        self._stores: dict[int, StoreClient] = {}
        # client-go RegionCache analog: region routing resolved from PD
        # once and reused until a NotLeader/EpochNotMatch invalidates it
        # — without it every mutation in a batch pays a PD RPC
        self._region_cache: dict[int, tuple[Region, Peer]] = {}
        self._breaker_cfg = (breaker_threshold, breaker_cooldown_s)
        self._breakers: dict = {}
        self.hedge_reads = hedge_reads
        self._hedge_pool = None
        self._hedge_mu = threading.Lock()
        # recent point-read latencies (seconds) → the adaptive P95 delay
        self._read_lat: list = []
        self.hedges_fired = 0
        self.hedges_won = 0
        self.hedges: dict = {}

    # -- routing --

    def _store_client(self, store_id: int) -> StoreClient:
        c = self._stores.get(store_id)
        if c is None:
            c = StoreClient(self.pd.get_store(store_id).address)
            self._stores[store_id] = c
        return c

    # -- per-store circuit breaker (tail tolerance) --

    def _breaker(self, store_id: int):
        from ..utils.health import CircuitBreaker
        br = self._breakers.get(store_id)
        if br is None:
            thresh, cool = self._breaker_cfg
            br = self._breakers[store_id] = CircuitBreaker(
                threshold=thresh, cooldown_s=cool)
        return br

    def breaker_states(self) -> dict:
        return {sid: br.stats() for sid, br in self._breakers.items()}

    def _store_call(self, store_id: int, method: str, req: dict,
                    timeout: float = 10) -> dict:
        """One RPC to one store through its circuit breaker.

        Only TRANSPORT failures (timeouts, channel errors) count
        against the breaker — a logical RemoteError proves the store
        answered and resets it."""
        from ..utils.health import CircuitOpen
        br = self._breaker(store_id)
        if not br.allow():
            raise CircuitOpen(f"store {store_id}")
        try:
            r = self._store_client(store_id).call(method, req,
                                                  timeout=timeout)
        except wire.RemoteError:
            br.record_success()
            raise
        except Exception:
            br.record_failure()
            raise
        br.record_success()
        return r

    def _lookup_region(self, key: bytes) -> tuple[Region, Peer]:
        # region bounds live in the ENCODED keyspace (txn_types
        # encode_key) — comparing raw user keys against them routes to
        # the wrong region as soon as a split boundary sorts between
        # the raw and encoded forms
        from ..storage.txn_types import encode_key
        ek = encode_key(key)
        for region, leader in self._region_cache.values():
            if region.contains(ek):
                return region, leader
        # a split in flight leaves PD with a transient gap between the
        # shrunk parent's heartbeat and the new sibling's first one —
        # "no region" there is retryable, not fatal (client-go backs
        # off on region_not_found the same way)
        from ..utils.backoff import Backoff
        bo = Backoff(base=0.02, cap=0.2, deadline_s=3.0)
        while True:
            try:
                region, leader = self.pd.get_region_with_leader(ek)
                break
            except wire.RemoteError as e:
                if "no region" not in str(e) or not bo.sleep():
                    raise
        if leader is None:
            leader = region.peers[0]
        self._region_cache[region.id] = (region, leader)
        return region, leader

    def _invalidate_region(self, key: bytes) -> None:
        from ..storage.txn_types import encode_key
        ek = encode_key(key)
        for rid, (region, _leader) in list(self._region_cache.items()):
            if region.contains(ek):
                del self._region_cache[rid]

    def _leader_client(self, key: bytes) -> tuple[StoreClient, Region]:
        region, leader = self._lookup_region(key)
        return self._store_client(leader.store_id), region

    def _call_leader(self, key: bytes, method: str, req: dict,
                     retries: int = 8, timeout: float = 10,
                     deadline: Optional[float] = None) -> dict:
        """Retry NotLeader/EpochNotMatch with fresh routing (client-go
        region cache invalidation).

        Retries back off exponentially with jitter and the whole
        operation is budgeted by ``deadline`` (default: ``timeout``) —
        each RPC's timeout is clamped to the remaining budget, so a
        caller's patience propagates through every hop instead of
        multiplying by the attempt count."""
        from ..utils.backoff import Backoff
        from ..utils.failpoint import fail_point
        from ..utils.health import CircuitOpen
        bo = Backoff(base=0.02, cap=0.5,
                     deadline_s=deadline if deadline is not None
                     else timeout)
        last: Optional[Exception] = None
        for _ in range(retries):
            if last is not None and bo.remaining() < 0.05:
                # deadline (nearly) exhausted: surface the meaningful
                # routing error instead of firing a sliver-timeout RPC
                # whose bare TimeoutError would mask it
                break
            region, leader = self._lookup_region(key)
            try:
                return self._store_call(leader.store_id, method, req,
                                        timeout=bo.rpc_timeout(timeout))
            except CircuitOpen as e:
                # this store's breaker is open: back off and re-resolve
                # — leadership may have moved off the dead store
                last = e
                self._invalidate_region(key)
                if not bo.sleep():
                    break
                continue
            except wire.RemoteError as e:
                if e.kind == "server_is_busy":
                    # overloaded, not misrouted: honor the server's
                    # queue-depth-derived retry_after_ms over blind
                    # exponential jitter
                    last = e
                    hint = e.err.get("retry_after_ms")
                    fail_point("client::before_retry")
                    if not bo.sleep(hint_s=hint / 1000.0
                                    if hint else None):
                        break
                    continue
                if _stale_route(e):
                    last = e
                    self._invalidate_region(key)
                    fail_point("client::before_retry")
                    if not bo.sleep():
                        break       # deadline exhausted
                    continue
                raise
        raise last if last else TxnError("routing failed")

    # -- timestamps --

    def tso(self) -> int:
        return self.pd.tso()

    # -- simple point API --

    def get(self, key: bytes, version: Optional[int] = None,
            resolve: bool = True,
            deadline_ms: Optional[int] = None) -> Optional[bytes]:
        """Point read.  ``deadline_ms`` budgets the WHOLE operation:
        it rides the wire so the server sheds expired work, and the
        client's RPC timeout is clamped to it."""
        from ..utils.deadline import Deadline
        ts = version if version is not None else self.tso()
        req = {"key": key, "version": ts}
        dl = Deadline.after_ms(deadline_ms) \
            if deadline_ms is not None else None
        timeout = 10.0
        for _ in range(4):
            if dl is not None:
                # the budget covers the WHOLE get, lock-resolution
                # retries included — each attempt carries only what
                # remains, and an exhausted budget sheds client-side
                dl.check("client_retry")
                req["deadline_ms"] = dl.to_wire_ms()
                timeout = max(0.001, dl.remaining())
            try:
                t0 = time.monotonic()
                if self.hedge_reads:
                    r = self._hedged_get(key, dict(req), timeout, dl)
                else:
                    r = self._call_leader(key, "KvGet", req,
                                          timeout=timeout)
                self._note_read_latency(time.monotonic() - t0)
                return r.get("value")
            except wire.RemoteError as e:
                if resolve and e.kind == "key_is_locked":
                    self._resolve_lock(key, e.err["lock"], ts)
                    continue
                raise
        raise TxnError(f"unresolved lock on {key!r}")

    # -- hedged and replica reads (tail tolerance) --

    def _hedge(self, outcome: str) -> None:
        with self._hedge_mu:
            self.hedges[outcome] = self.hedges.get(outcome, 0) + 1

    def _note_read_latency(self, dt: float) -> None:
        lat = self._read_lat
        lat.append(dt)
        if len(lat) > self.HEDGE_LAT_WINDOW:
            del lat[:len(lat) - self.HEDGE_LAT_WINDOW]

    def hedge_delay(self) -> float:
        """The adaptive hedge trigger: the P95 of recent point reads — a
        read slower than 95% of its peers is likely stuck on a slow store,
        so a duplicate is cheap insurance."""
        lat = sorted(self._read_lat)
        if not lat:
            return 0.05
        p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
        return min(self.HEDGE_DELAY_MAX, max(self.HEDGE_DELAY_MIN, p95))

    def _followers(self, region: Region, leader: Optional[Peer]) -> list:
        return [p for p in region.peers
                if (leader is None or p.store_id != leader.store_id)
                and not p.is_learner]

    def _race(self, f_leader, f_follow, timeout: float, tag: str):
        """The first usable answer of the two legs.  An error from the
        early finisher falls through to (and waits on) the other leg; both
        failing surfaces the leader's error (the follower's is usually
        the less meaningful DataIsNotReady)."""
        import concurrent.futures as cf
        done, _ = cf.wait({f_leader, f_follow}, timeout=timeout + 1,
                          return_when=cf.FIRST_COMPLETED)
        order = sorted([f_leader, f_follow],
                       key=lambda f: (f not in done, f is f_follow))
        for fut in order:
            try:
                r = fut.result(timeout=timeout + 1)
            except wire.RemoteError as e:
                if fut is f_follow and e.kind == "data_is_not_ready":
                    # a lagging replica refused: the leader's leg is the
                    # consistent fallback
                    self._hedge(tag + "stale_refused")
                continue
            except Exception:   # noqa: BLE001 — try the other leg
                continue
            if fut is f_follow:
                self.hedges_won += 1
                self._hedge(tag + "follower_won")
            else:
                self._hedge(tag + "leader_won")
            return r
        return f_leader.result(timeout=timeout + 1)

    def _hedged_get(self, key: bytes, req: dict, timeout: float,
                    dl=None) -> dict:
        """A leader read, hedged to a follower after the adaptive delay;
        the first usable answer wins (a gRPC unary call cannot be recalled:
        the loser's reply is discarded).  Safe because a get at a FIXED
        version is idempotent and the follower's leg stays linearizable:
        its stale read serves only at or below its watermark, and its
        fallback is a ReadIndex replica read."""
        import concurrent.futures as cf
        region, leader = self._lookup_region(key)
        pool = self._hedge_executor()
        f_leader = pool.submit(self._call_leader, key, "KvGet", req, 8,
                               timeout)
        try:
            r = f_leader.result(timeout=self.hedge_delay())
            self._hedge("leader_fast")
            return r
        except cf.TimeoutError:
            pass
        except wire.RemoteError as e:
            if e.kind == "key_is_locked":
                raise   # the follower would see the same lock
            # the leader failed FAST (busy, deadline, breaker): the
            # follower's leg below is the recovery, not a duplicate
        followers = self._followers(region, leader)
        if not followers:
            return f_leader.result(timeout=timeout + 1)
        self.hedges_fired += 1
        self._hedge("fired")
        target = followers[self.hedges_fired % len(followers)]
        freq = dict(req)
        if dl is not None:
            # the follower's leg carries the REMAINING budget
            freq["deadline_ms"] = dl.to_wire_ms()
        f_follow = pool.submit(self._follower_get, target.store_id, freq,
                               timeout)
        return self._race(f_leader, f_follow, timeout, "")

    def _follower_get(self, store_id: int, req: dict,
                      timeout: float) -> dict:
        """The hedge's follower leg: a resolved-ts stale read first (no
        leader involved at all), a ReadIndex replica read when the
        follower's watermark has not reached read_ts yet."""
        stale = dict(req)
        stale["stale_read"] = True
        try:
            return self._store_call(store_id, "KvGet", stale,
                                    timeout=timeout)
        except wire.RemoteError as e:
            if e.kind != "data_is_not_ready":
                raise
        replica = dict(req)
        replica["replica_read"] = True
        return self._store_call(store_id, "KvGet", replica,
                                timeout=timeout)

    def _hedge_executor(self):
        import concurrent.futures as cf
        with self._hedge_mu:
            if self._hedge_pool is None:
                self._hedge_pool = cf.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="hedge")
            return self._hedge_pool

    def replica_get(self, key: bytes, version: Optional[int] = None,
                    stale: bool = False) -> Optional[bytes]:
        """Read from a FOLLOWER replica — consistent at the leader's commit
        point by ReadIndex (``replica_read``) or, with ``stale=True``,
        served locally under the resolved-ts watermark (raises
        ``data_is_not_ready`` when the watermark lags read_ts)."""
        ts = version if version is not None else self.tso()
        region, leader = self._lookup_region(key)
        followers = [p for p in region.peers
                     if leader is None or p.store_id != leader.store_id]
        target = followers[0] if followers else leader
        req = {"key": key, "version": ts}
        req["stale_read" if stale else "replica_read"] = True
        return self._store_call(target.store_id, "KvGet", req).get("value")

    def put(self, key: bytes, value: bytes) -> None:
        self.txn_write([("put", key, value)])

    def delete(self, key: bytes) -> None:
        self.txn_write([("delete", key, None)])

    def scan(self, start: bytes, end: Optional[bytes], limit: int,
             version: Optional[int] = None) -> list:
        ts = version if version is not None else self.tso()
        r = self._call_leader(start, "KvScan", {
            "start_key": start, "end_key": end, "limit": limit,
            "version": ts})
        return [(p["key"], p["value"]) for p in r["pairs"]]

    # -- 2PC --

    def txn_write(self, mutations: Sequence[tuple]) -> int:
        """mutations: [(op, key, value|None)].  Full 2PC: prewrite all
        keys (primary first group), then commit primary, then commit
        secondaries.  Returns commit_ts."""
        assert mutations
        from ..utils.backoff import Backoff
        start_ts = self.tso()
        primary = mutations[0][1]
        # prewrite, grouped one RPC per region leader; a stale cached
        # route (split/leader change mid-flight) re-groups and retries
        # under a jittered backoff with a whole-2PC deadline —
        # re-prewriting an already-locked key with the same start_ts is
        # idempotent (mvcc/actions prewrite lock-match rule)
        bo = Backoff(base=0.02, cap=0.5, deadline_s=20.0)
        for attempt in range(8):
            groups: dict[tuple, list] = {}
            for op, key, value in mutations:
                client, region = self._leader_client(key)
                groups.setdefault((client.addr, region.id), []).append(
                    (client, op, key, value))
            try:
                for muts in groups.values():
                    self._retryable_prewrite(muts[0][0], muts, primary,
                                             start_ts)
                break
            except wire.RemoteError as e:
                if _stale_route(e) and attempt < 7:
                    for _op, key, _v in mutations:
                        self._invalidate_region(key)
                    if not bo.sleep():
                        raise
                    continue
                raise
        # commit primary first — the txn's durability point
        commit_ts = self.tso()
        self._call_leader(primary, "KvCommit", {
            "keys": [primary], "start_version": start_ts,
            "commit_version": commit_ts})
        # then secondaries (safe to retry/resolve after the primary
        # commit), batched one KvCommit per region leader — the
        # reference's client-go commits per-region, not per-key
        by_leader: dict[tuple, tuple] = {}
        for op, key, _v in mutations:
            if key == primary:
                continue
            client, region = self._leader_client(key)
            by_leader.setdefault((client.addr, region.id),
                                 (client, []))[1].append(key)
        for client, keys in by_leader.values():
            try:
                client.call("KvCommit", {
                    "keys": keys, "start_version": start_ts,
                    "commit_version": commit_ts})
            except wire.RemoteError as e:
                if not _stale_route(e):
                    raise
                # stale group route: fall back to per-key re-routing
                for key in keys:
                    self._invalidate_region(key)
                    self._call_leader(key, "KvCommit", {
                        "keys": [key], "start_version": start_ts,
                        "commit_version": commit_ts})
        return commit_ts

    def _retryable_prewrite(self, client, muts, primary, start_ts,
                            retries: int = 4) -> None:
        req = {"mutations": [{"op": op, "key": k, "value": v}
                             for _c, op, k, v in muts],
               "primary": primary, "start_version": start_ts}
        for _ in range(retries):
            try:
                client.call("KvPrewrite", req)
                return
            except wire.RemoteError as e:
                if e.kind == "key_is_locked":
                    self._resolve_lock(e.err["key"], e.err["lock"],
                                       start_ts)
                    continue
                raise
        raise TxnError("prewrite kept hitting locks")

    # -- lock resolution (client-go resolver protocol) --

    def _resolve_lock(self, key: bytes, lock: dict, caller_ts: int) -> None:
        primary = lock["primary"]
        status = self._call_leader(primary, "KvCheckTxnStatus", {
            "primary_key": primary, "lock_ts": lock["start_ts"],
            "caller_start_ts": caller_ts, "current_ts": self.tso()})
        st = status["status"]
        if st == "committed":
            self._call_leader(key, "KvResolveLock", {
                "start_version": lock["start_ts"],
                "commit_version": status["ts"]})
        elif st in ("rolled_back", "ttl_expired"):
            self._call_leader(key, "KvResolveLock", {
                "start_version": lock["start_ts"], "commit_version": 0})
        # "locked": still alive — caller retries / backs off

    # -- coprocessor --

    def coprocessor(self, dag, key_hint: Optional[bytes] = None,
                    force_backend: Optional[str] = None,
                    paging_size: int = 0, resume_token=None,
                    timeout: float = 10,
                    deadline_ms: Optional[int] = None) -> dict:
        key = key_hint if key_hint is not None else \
            (dag.ranges[0].start if dag.ranges else b"")
        req = {
            "tp": 103, "dag": wire.enc_dag(dag),
            "force_backend": force_backend,
            "paging_size": paging_size, "resume_token": resume_token}
        if deadline_ms is not None:
            # the endpoint checks this budget at admission, between
            # executor batches, and before the device dispatch
            req["deadline_ms"] = deadline_ms
            timeout = min(timeout, deadline_ms / 1000.0)
        if self.hedge_reads and not paging_size and resume_token is None:
            # a snapshot read at a fixed start_ts is idempotent, so the
            # adaptive-P95 hedge applies; its second leg is a follower
            # answering from its own device feed (paged requests carry
            # resume state and stay on the leader)
            return self._hedged_coprocessor(key, req, timeout)
        return self._call_leader(key, "Coprocessor", req,
                                 timeout=timeout)

    def _hedged_coprocessor(self, key: bytes, req: dict,
                            timeout: float) -> dict:
        """A leader coprocessor read, hedged to a follower's replica feed
        after the adaptive delay: a ``stale_read`` call the follower
        answers from its own delta-patched line.  A follower whose
        watermark lags start_ts refuses with DataIsNotReady and the leader's
        leg answers; the per-store breakers gate both legs."""
        import concurrent.futures as cf
        region, leader = self._lookup_region(key)
        pool = self._hedge_executor()
        f_leader = pool.submit(self._call_leader, key, "Coprocessor", req,
                               8, timeout)
        try:
            r = f_leader.result(timeout=self.hedge_delay())
            self._hedge("copr_leader_fast")
            return r
        except cf.TimeoutError:
            pass
        except wire.RemoteError as e:
            if e.kind == "key_is_locked":
                raise   # resolution, not hedging, unblocks this read
        followers = self._followers(region, leader)
        if not followers:
            return f_leader.result(timeout=timeout + 1)
        self.hedges_fired += 1
        self._hedge("copr_fired")
        target = followers[self.hedges_fired % len(followers)]
        stale = dict(req)
        stale["stale_read"] = True
        f_follow = pool.submit(self._store_call, target.store_id,
                               "Coprocessor", stale, timeout)
        return self._race(f_leader, f_follow, timeout, "copr_")

    def coprocessor_replica(self, dag, key_hint: Optional[bytes] = None,
                            timeout: float = 10,
                            store_id: Optional[int] = None) -> dict:
        """A follower's device read (a ``stale_read`` coprocessor call):
        served from the follower's own columnar line under its resolved-ts
        watermark, by ``store_id`` or the region's first follower.  Raises
        ``data_is_not_ready`` when the watermark lags the snapshot ts —
        a caller wanting the fallback hedges (``hedge_reads=True``)."""
        key = key_hint if key_hint is not None else \
            (dag.ranges[0].start if dag.ranges else b"")
        if store_id is None:
            region, leader = self._lookup_region(key)
            followers = self._followers(region, leader)
            store_id = (followers[0] if followers else leader).store_id
        req = {"tp": 103, "dag": wire.enc_dag(dag),
               "force_backend": None, "paging_size": 0,
               "resume_token": None, "stale_read": True}
        return self._store_call(store_id, "Coprocessor", req,
                                timeout=timeout)

    def coprocessor_plan(self, preq, key_hint: Optional[bytes] = None,
                         force_backend: Optional[str] = None,
                         timeout: float = 30,
                         deadline_ms: Optional[int] = None) -> dict:
        """Plan-IR coprocessor request (copr/plan_ir.py): the operator
        superset — join/sort/window fragments with per-operator
        host/device routing.  Routes by the FIRST scan leaf's first
        range; a join's two regions are expected co-located on one
        node (the SlicePlacer co-location loop), which the single-node
        and placement deployments guarantee."""
        leaves = preq.scan_leaves()
        key = key_hint if key_hint is not None else \
            (leaves[0].ranges[0].start
             if leaves and leaves[0].ranges else b"")
        req = {"tp": 103, "plan": wire.enc_plan(preq),
               "force_backend": force_backend}
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
            timeout = min(timeout, deadline_ms / 1000.0)
        return self._call_leader(key, "Coprocessor", req,
                                 timeout=timeout)

    def coprocessor_paged(self, dag, paging_size: int,
                          key_hint: Optional[bytes] = None):
        """Iterate the unary paged protocol: yields one response dict
        per page until the server reports is_drained."""
        token = None
        while True:
            r = self.coprocessor(dag, key_hint=key_hint,
                                 paging_size=paging_size,
                                 resume_token=token)
            yield r
            if r.get("is_drained", True):
                return
            token = r["resume_token"]

    def analyze(self, dag, buckets: int = 64,
                key_hint: Optional[bytes] = None) -> dict:
        """ANALYZE (tp=104): per-column histogram/distinct/null stats."""
        key = key_hint if key_hint is not None else \
            (dag.ranges[0].start if dag.ranges else b"")
        return self._call_leader(key, "Coprocessor", {
            "tp": 104, "dag": wire.enc_dag(dag), "buckets": buckets})

    def checksum(self, dag, key_hint: Optional[bytes] = None) -> dict:
        """CHECKSUM (tp=105): crc64 over the range's logical rows."""
        key = key_hint if key_hint is not None else \
            (dag.ranges[0].start if dag.ranges else b"")
        return self._call_leader(key, "Coprocessor", {
            "tp": 105, "dag": wire.enc_dag(dag)})

    def coprocessor_stream(self, dag, paging_size: int = 0,
                           key_hint: Optional[bytes] = None,
                           timeout: float = 60):
        """Server-streamed pages over ONE snapshot (coprocessor_stream).
        Yields response dicts."""
        key = key_hint if key_hint is not None else \
            (dag.ranges[0].start if dag.ranges else b"")
        client, _region = self._leader_client(key)
        fn = client._chan.unary_stream(
            "/tikv.Tikv/CoprocessorStream", request_serializer=wire.pack,
            response_deserializer=wire.unpack)
        for msg in fn({"tp": 103, "dag": wire.enc_dag(dag),
                       "paging_size": paging_size}, timeout=timeout):
            if msg.get("error"):
                raise wire.RemoteError(msg["error"])
            yield msg

    # -- raw --

    def raw_put(self, key: bytes, value: bytes) -> None:
        self._call_leader(key, "RawPut", {"key": key, "value": value})

    def raw_get(self, key: bytes) -> Optional[bytes]:
        return self._call_leader(key, "RawGet", {"key": key}).get("value")

    # -- admin (ctl surface) --

    def split(self, split_key: bytes) -> Region:
        r = self._call_leader(split_key, "SplitRegion",
                              {"split_key": split_key})
        # the parent region's cached bounds are stale the moment the
        # split lands — drop them so the next lookup re-resolves
        self._invalidate_region(split_key)
        return wire.dec_region(r["right"])

    def add_peer(self, region_id: int, store_id: int) -> Peer:
        region = self.pd.get_region_by_id(region_id)
        peer = Peer(self.pd.alloc_id(), store_id)
        self._call_leader_by_region(region, "ChangePeer", {
            "region_id": region_id, "change_type": "add",
            "peer": wire.enc_peer(peer)})
        return peer

    def remove_peer(self, region_id: int, peer: Peer) -> None:
        region = self.pd.get_region_by_id(region_id)
        self._call_leader_by_region(region, "ChangePeer", {
            "region_id": region_id, "change_type": "remove",
            "peer": wire.enc_peer(peer)})

    def change_peers_joint(self, region_id: int, changes) -> None:
        """Atomic multi-peer change (joint consensus): ``changes`` =
        [("add"|"add_learner"|"remove", Peer)]."""
        region = self.pd.get_region_by_id(region_id)
        self._call_leader_by_region(region, "ChangePeerV2", {
            "region_id": region_id,
            "changes": [{"type": t, "peer": wire.enc_peer(p)}
                        for t, p in changes]})
        self._region_cache.clear()

    def merge(self, source_id: int, target_id: int) -> Region:
        """Merge the source region into its adjacent target."""
        region = self.pd.get_region_by_id(source_id)
        self._region_cache.clear()      # boundaries are about to change
        r = self._call_leader_by_region(region, "MergeRegion", {
            "source_id": source_id, "target_id": target_id})
        return wire.dec_region(r["region"])

    def _call_leader_by_region(self, region: Region, method: str,
                               req: dict, retries: int = 8,
                               deadline: float = 30.0) -> dict:
        from ..utils.backoff import Backoff
        bo = Backoff(base=0.02, cap=0.5, deadline_s=deadline)
        last = None
        for _ in range(retries):
            if last is not None and bo.remaining() < 0.05:
                break       # surface `last` over a sliver-timeout RPC
            _r = self.pd.get_region_by_id(region.id) or region
            reg, leader = self.pd.get_region_with_leader(_r.start_key)
            if reg.id != region.id or leader is None:
                leader = _r.peers[0]
            client = self._store_client(leader.store_id)
            try:
                return client.call(method, req,
                                   timeout=bo.rpc_timeout(10))
            except wire.RemoteError as e:
                if _stale_route(e):
                    last = e
                    if not bo.sleep():
                        break
                    continue
                raise
        raise last if last else TxnError("routing failed")

    def status(self, store_id: int) -> dict:
        return self._store_client(store_id).call("Status", {})

    def close(self) -> None:
        """Close every channel this client opened, and join the hedge
        executor's threads: an abandoned leg ends within its RPC timeout
        (the reference leaves them running past ``close``)."""
        with self._hedge_mu:
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        for c in self._stores.values():
            c.close()
        self._stores.clear()
        self.pd.close()

    def ingest_sst(self, sst_blob: bytes, region_key: bytes,
                   chunk: int = 256 * 1024,
                   timeout: float = 120,
                   timings: Optional[dict] = None) -> int:
        """Bulk load one built SST onto the region owning ``region_key``
        (upload chunks → ingest; src/import/sst_service.rs flow).
        ``timeout`` covers the ingest RPC — the raft propose + apply of
        a multi-million-row file takes seconds, not the default 10 —
        and doubles as the whole operation's retry deadline.
        ``timings``: a dict the seconds spent in the uploads
        (``upload_s``) and the ingest (``ingest_s``) are added to."""
        import uuid as _uuid
        from ..utils.backoff import Backoff
        # the ingest RPC keeps its FULL caller-sized timeout on every
        # attempt (uploads must not eat its budget); the backoff
        # deadline only bounds the whole retry loop
        bo = Backoff(base=0.05, cap=1.0, deadline_s=timeout * 4)
        last = None
        for _attempt in range(4):
            region, leader = self._lookup_region(region_key)
            uuid = _uuid.uuid4().hex
            total = max(1, -(-len(sst_blob) // chunk))
            sc = self._store_client(leader.store_id)
            try:
                t0 = time.perf_counter()
                for seq in range(total):
                    sc.call("ImportUpload", {
                        "uuid": uuid, "seq": seq, "total": total,
                        "data": sst_blob[seq * chunk:(seq + 1) * chunk]})
                t1 = time.perf_counter()
                r = sc.call("ImportIngest",
                            {"uuid": uuid, "region_id": region.id},
                            timeout=timeout)
                if timings is not None:
                    timings["upload_s"] = timings.get("upload_s", 0.0) + \
                        t1 - t0
                    timings["ingest_s"] = timings.get("ingest_s", 0.0) + \
                        time.perf_counter() - t1
                return r["ingested"]
            except wire.RemoteError as e:
                if e.kind in ("not_leader", "epoch_not_match",
                              "region_merging", "server_is_busy") or \
                        "KeyNotInRegion" in str(e):
                    # stale routing / transient: refresh and retry
                    # (KeyNotInRegion = cached bounds predate a split).
                    # A busy server names its own drain time
                    # (retry_after_ms from read-pool queue depth) —
                    # honor it over blind exponential jitter
                    self._invalidate_region(region_key)
                    last = e
                    hint = e.err.get("retry_after_ms") \
                        if e.kind == "server_is_busy" else None
                    if not bo.sleep(hint_s=hint / 1000.0
                                    if hint else None):
                        break
                    continue
                raise
        raise last

    def import_switch_mode(self, store_id: int,
                           import_mode: bool) -> bool:
        r = self._store_client(store_id).call(
            "ImportSwitchMode", {"import": import_mode})
        return r["import_mode"]
