"""Node — one tikv-server's store: store lifecycle + drive loop + the
raft transport between stores + the coprocessor's path to the card.

A trimmed copy of the JAX package's ``server/node.py`` on the in-memory
engine: ``Node.__init__`` (reference :323-598) wires the raftstore over
the gRPC raft transport (``GrpcTransport``, :51-254: per-store queues
batched into ``BatchRaft`` calls, reconnect backoff with PD address
rediscovery, the breaker view, ``SnapshotChunk`` extraction for snapshots
over 256 KiB), RaftKv, the transactional ``Storage``, the read pool, the
online-config controller, and the device serving stack whole — the delta
sink, the region columnar cache, the request coalescer, the feed arena's
budget, the ``DeviceStateSupervisor`` on the coprocessor host, the
``RemintGovernor``, the device rung of the cold build and the
``ColdStreamBuilder``; the compiled request fast path's class cache
(``fastpath``, sized by ``coprocessor.fastpath_classes``, its
``config_gen`` bumped by every applied online diff) and the resolved-ts
observer (``resolved_ts``).  The runner defaults to ``DeviceRunner()`` on
``cuda:0`` (it raises without CUDA); a caller that wants the CPU passes
``DeviceRunner(device="cpu")``.  ``bootstrap_or_join``/``start``/``stop``
(:756-812), the drive loop (:821-906, the transport flushed outside the
node lock), ``_wait_driver`` (:985), ``on_raft_message`` (:1005),
``_copr_snapshot`` (:1016-1070: its stale leg and the fast path's learn
fields), ``fastpath_snapshot`` (:1133-1155), the resolved-ts advance at
the drive loop's PD beat and its ``CheckLeader`` fan-out to the followers
(:893-957, both on the fan-out's thread), ``_check_replica_freshness``
(:1073-1093, with the ``device::replica_stale`` failpoint),
``_note_replica_read`` and
``replica_serving_stats`` (:1094-1131), ``ingest_sst``/``ingest_sst_blob``
(:1212-1274), ``change_peer``/``change_peer_v2``/``transfer_leader``
(:1276-1308), ``split_region`` (:1158), ``region_applied`` (:1335),
``merge_region`` in its network form (:1340-1416: every source peer's
apply index polled over ``RegionApplied``), ``rollback_merge`` and
``status`` (:1446) follow the reference; the drive loop runs the split
checker every ``region_split_check_ticks`` ticks, suspended in import
mode (:829-845).

Not here: the disk engine and encryption, CDC, PD's replica hints
(``_apply_replica_hints``), the health controller, load split, the
feature gate, PD's operators, tracing and the flight recorder, RU
metering and resource control, the proxy to the cluster's deadlock
detector (the lock manager detects with this store's own graph) and GC.

Threading: one background drive thread owns raft progress (tick + ready
+ the transport's flush); request threads propose under the node lock
and block on completion events the drive thread fires.  No call into the
device runner happens under the node lock from a request thread: the
columnar cache is read
after ``raft_kv.snapshot`` has returned.  Raft apply does enter the runner
under the node lock, as the reference's does: a split slices the
parent's resident feeds (``split_planes``) and a leader gain re-verifies
them (``plane_digest``) inside apply, under the runner's dispatch lock.
The order is always node lock, then dispatch lock: no thread holding the
dispatch lock (a request's dispatch, the coalescer's, the scrubber's)
ever waits on the node lock, so the two cannot invert.  A raft message
from another store (``on_raft_message``, the ``Raft``/``BatchRaft``
handlers) steps under the node lock and never enters the runner, and so
does a ``CheckLeader``.  The fast leg reads the cache (``get_fast``) after
``raft_kv.snapshot`` has returned, outside the node lock, as
``_copr_snapshot`` does.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from typing import Optional

from ..copr.dag import TableScanDesc
from ..copr.endpoint import Endpoint
from ..copr.region_cache import RegionColumnarCache
from ..copr.storage_impl import MvccScanStorage
from ..engine.memory import MemoryEngine
from ..engine.traits import CF_RAFT
from ..kv.engine import SnapContext
from ..pd.client import PdClient
from ..raftstore import (
    AdminCmd,
    NotLeaderError,
    Peer,
    RaftCmd,
    RaftKv,
    RaftStore,
    Region,
    RegionEpoch,
    Transport,
)
from ..raftstore.metapb import Store as StoreMeta
from ..storage import Storage
from ..storage.mvcc.reader import MvccReader
from ..storage.txn_types import encode_key
from . import wire


class _StoreConn:
    """Per-peer-store connection state: bounded message queue, channel,
    exponential backoff, address rediscovery.

    Reference: src/server/raft_client.rs — ``Queue`` with overflow
    (:198-226), reconnect backoff, and re-resolving the store address
    through PD after failures (resolve.rs)."""

    MAX_QUEUE = 4096
    MAX_BATCH = 512
    BACKOFF_BASE = 0.1
    BACKOFF_MAX = 3.0
    # a raft message queued longer than this is stale — its term/index
    # have been superseded by retries; shipping it after a long backoff
    # only wastes the reconnected channel's first batches
    MSG_TTL = 10.0

    def __init__(self, store_id: int):
        from ..utils.backoff import Backoff
        self.store_id = store_id
        self.queue: deque = deque()     # (enqueue_monotonic, msg, bytes)
        self.lock = threading.Lock()
        self.channel = None
        self.addr = None
        self.fail_count = 0
        self.next_attempt = 0.0     # monotonic deadline while backing off
        # the tight (0.8, 1.0) jitter band keeps retries decorrelated
        # across stores while still guaranteeing exponential growth
        self._backoff = Backoff(base=self.BACKOFF_BASE,
                                cap=self.BACKOFF_MAX, jitter=(0.8, 1.0))

    def push(self, msg: dict, nbytes: int) -> bool:
        """→ False when the queue is full (message dropped — raft
        retries; the reference drops on a full Queue the same way)."""
        with self.lock:
            if len(self.queue) >= self.MAX_QUEUE:
                return False
            self.queue.append((time.monotonic(), msg, nbytes))
            return True

    def pop_batch(self, now: float, max_bytes: int) -> tuple[list, int]:
        """→ (batch, n_expired): drop queued messages past their send
        deadline, then take up to MAX_BATCH of what is still fresh and no
        more than ``max_bytes`` of payload (the first message always)."""
        with self.lock:
            expired = 0
            while self.queue and now - self.queue[0][0] > self.MSG_TTL:
                self.queue.popleft()
                expired += 1
            out, size = [], 0
            while self.queue and len(out) < self.MAX_BATCH:
                nb = self.queue[0][2]
                if out and size + nb > max_bytes:
                    break
                out.append(self.queue.popleft()[1])
                size += nb
            return out, expired

    def on_failure(self, now: float) -> None:
        self.fail_count += 1
        self._backoff.attempt = self.fail_count - 1
        self.next_attempt = now + self._backoff.next_delay()
        # force address rediscovery: the store may have moved.  Close
        # the channel (native sockets) rather than waiting for GC.
        self.close()

    def on_success(self) -> None:
        self.fail_count = 0
        self.next_attempt = 0.0

    def close(self) -> None:
        if self.channel is not None:
            try:
                self.channel.close()
            except Exception:   # noqa: BLE001 — already broken
                pass
        self.channel = None
        self.addr = None

    def breaker_state(self) -> str:
        """The conn's backoff state read as a circuit breaker: closed
        (healthy), open (cooling off after failures), half_open (past
        the cooldown — the next flush is the probe)."""
        if self.fail_count == 0:
            return "closed"
        if time.monotonic() < self.next_attempt:
            return "open"
        return "half_open"


class GrpcTransport(Transport):
    """Store-to-store raft transport over gRPC.

    Reference: src/server/raft_client.rs — per-store connections with
    BatchRaftMessage buffering + overflow, exponential backoff with PD
    address rediscovery on failure.  ``drops`` counts the messages lost by
    reason (``failpoint``, ``full``, ``expired``, ``send_fail``);
    ``batch_calls`` and ``snap_chunk_calls`` the ``BatchRaft`` and
    ``SnapshotChunk`` RPCs sent."""

    # per-batch RPC deadline: a hung peer must not pin the flush loop
    # (and with it every region's outbound raft traffic) beyond this
    SEND_DEADLINE = 5.0
    # a batch's payload beyond this goes in the next call: one message
    # alone may be larger (a raft entry carrying a bulk-loaded SST blob)
    BATCH_BYTES = 64 << 20
    # a snapshot payload beyond this rides the chunk stream instead of
    # the raft message (src/server/snap.rs SNAP_CHUNK_LEN; the raft
    # batch then stays small regardless of region size)
    SNAP_CHUNK = 256 * 1024

    def __init__(self, pd: PdClient):
        self._pd = pd
        self._conns: dict[int, _StoreConn] = {}
        self._lock = threading.Lock()
        self.drops: dict = {}
        self.batch_calls = 0
        self.snap_chunk_calls = 0

    def _conn(self, store_id: int) -> _StoreConn:
        with self._lock:
            conn = self._conns.get(store_id)
            if conn is None:
                conn = self._conns[store_id] = _StoreConn(store_id)
            return conn

    def _drop(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.drops[reason] = self.drops.get(reason, 0) + n

    def breaker_states(self) -> dict:
        """Per-peer-store transport breaker view (/health route)."""
        with self._lock:
            conns = list(self._conns.values())
        return {c.store_id: {"state": c.breaker_state(),
                             "consecutive_failures": c.fail_count,
                             "queued": len(c.queue)}
                for c in conns}

    def send(self, to_store, region_id, to_peer, from_peer, msg) -> None:
        from ..utils.failpoint import fail_point
        if fail_point("transport::grpc_drop") is not None:
            self._drop("failpoint")
            return
        m = wire.enc_raft_msg(msg)
        nbytes = sum(len(e) for e in m["e"]) + \
            len(m.get("snap", {}).get("d", b""))
        ok = self._conn(to_store).push({
            "region_id": region_id,
            "to_peer": wire.enc_peer(to_peer),
            "from_peer": wire.enc_peer(from_peer),
            "msg": m}, nbytes)
        if not ok:
            self._drop("full")

    def flush(self) -> None:
        """Ship every connection's queued messages (the drive loop calls
        this outside the node lock)."""
        from ..utils.failpoint import fail_point
        now = time.monotonic()
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            while conn.queue and now >= conn.next_attempt:
                msgs, expired = conn.pop_batch(now, self.BATCH_BYTES)
                if expired:
                    self._drop("expired", expired)
                if not msgs:
                    break
                try:
                    if fail_point("transport::before_batch_send") \
                            is not None:
                        raise ConnectionError("failpoint")
                    chan = self._channel(conn)
                    self._extract_snapshots(chan, msgs)
                    call = chan.unary_unary(
                        "/tikv.Tikv/BatchRaft",
                        request_serializer=wire.pack,
                        response_deserializer=wire.unpack)
                    call({"msgs": msgs}, timeout=self.SEND_DEADLINE)
                    self.batch_calls += 1
                    conn.on_success()
                except Exception:   # noqa: BLE001 — raft retries
                    # raft tolerates the lost batch (protocol retries);
                    # the conn backs off (with jitter) and re-resolves
                    # its address
                    conn.on_failure(time.monotonic())
                    self._drop("send_fail", len(msgs))
                    break

    def _extract_snapshots(self, chan, msgs: list) -> None:
        """Large snapshots: ship data as ordered SnapshotChunk RPCs,
        leave only meta + the claim key on the raft message."""
        for m in msgs:
            snap = m["msg"].get("snap")
            if snap is None or len(snap.get("d", b"")) <= self.SNAP_CHUNK:
                continue
            data = snap["d"]
            key = (f"{m['region_id']}/{m['to_peer']['id']}/"
                   f"{snap['i']}/{snap['t']}")
            call = chan.unary_unary(
                "/tikv.Tikv/SnapshotChunk",
                request_serializer=wire.pack,
                response_deserializer=wire.unpack)
            total = -(-len(data) // self.SNAP_CHUNK)
            for seq in range(total):
                chunk = data[seq * self.SNAP_CHUNK:
                             (seq + 1) * self.SNAP_CHUNK]
                call({"key": key, "seq": seq, "total": total,
                      "data": chunk}, timeout=10)
                self.snap_chunk_calls += 1
            snap["d"] = b""
            snap["ext_key"] = key

    def _channel(self, conn: _StoreConn):
        if conn.channel is None:
            conn.addr = self._pd.get_store(conn.store_id).address
            from .security import make_channel
            conn.channel = make_channel(conn.addr)
        return conn.channel

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c.close()

# Reference: components/keys STORE_IDENT_KEY (0x01 0x01) — the store's
# durable identity, read before talking to PD so a restarted store keeps
# its id (src/server/node.rs check_store / bootstrap_store).
STORE_IDENT_KEY = b"\x01ident"


class Node:
    def __init__(self, addr: str, pd: PdClient,
                 engine: Optional[MemoryEngine] = None,
                 store_id: Optional[int] = None,
                 data_dir: Optional[str] = None,
                 device_runner=None,
                 device_row_threshold: Optional[int] = None,
                 tick_interval: float = 0.01, config=None):
        from ..config import ConfigController, TikvConfig
        if config is None:
            config = TikvConfig()
            config.storage.data_dir = data_dir or ""
        if device_row_threshold is not None:
            # an explicit argument wins over the config file value
            config.coprocessor.device_row_threshold = device_row_threshold
        else:
            device_row_threshold = config.coprocessor.device_row_threshold
        if config.storage.data_dir or data_dir:
            raise ValueError("the port's node runs on the in-memory engine "
                             "only: storage.data_dir must be empty")
        if config.raftstore.store_pool_size > 0:
            raise ValueError("the port's raftstore has no batch-system "
                             "pool: raftstore.store_pool_size must be 0")
        if not config.coprocessor.scrub_digests:
            raise ValueError("the port's runner records the digests of "
                             "every feed: coprocessor.scrub_digests cannot "
                             "be switched off")
        if device_runner is None:
            # the card (raises without CUDA); a CPU runner only when the
            # caller passes one
            from ..device import DeviceRunner
            device_runner = DeviceRunner()
        self.config = config
        self.config_controller = ConfigController(config)
        self.addr = addr
        self.pd = pd
        self.engine = engine if engine is not None else MemoryEngine()
        self.lock = threading.RLock()
        self._tick_interval = tick_interval
        self._wake = threading.Condition(self.lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        ident = self.engine.get_value_cf(CF_RAFT, STORE_IDENT_KEY)
        if ident is not None:
            persisted = struct.unpack(">Q", ident)[0]
            if store_id is not None and store_id != persisted:
                # reference: src/server/node.rs check_store — a store id
                # clashing with the durable ident is a config error
                raise ValueError(
                    f"store_id {store_id} != persisted ident {persisted}")
            store_id = persisted
        self.store_id = store_id if store_id is not None else pd.alloc_id()
        if ident is None:
            self.engine.put_cf(CF_RAFT, STORE_IDENT_KEY,
                               struct.pack(">Q", self.store_id))
        pd.put_store(StoreMeta(self.store_id, addr))
        self.transport = GrpcTransport(pd)
        self.raft_store = RaftStore(
            self.store_id, self.engine, self.transport,
            election_tick=config.raftstore.raft_election_timeout_ticks,
            heartbeat_tick=config.raftstore.raft_heartbeat_ticks,
            tick_interval=tick_interval)
        # the store reads its split thresholds live (the split checker),
        # so online raftstore changes take effect without a restart
        self.raft_store.config = config.raftstore
        self.raft_store.observers = [self._report_region]
        # bulk-load import mode (sst_importer import_mode.rs)
        self.import_mode = False
        self.raft_kv = RaftKv(self.raft_store, driver=self._wait_driver,
                              lock=self.lock)
        # pessimistic-lock waiters park until the holder releases; the
        # deadlock detector is this store's own (the proxy to the
        # cluster's detector leader waits for the Detect RPC)
        from ..storage.lock_manager import LockManager
        self.storage = Storage(engine=self.raft_kv,
                               lock_manager=LockManager())
        # resolved-ts: registered before the delta sink, in the
        # reference's order (its CDC observer, then this, then the sink):
        # an applied lock reaches the watermark's lock set before any
        # consumer of the same apply acts on it
        from ..cdc import ResolvedTsObserver
        self.resolved_ts = ResolvedTsObserver()
        self.raft_store.coprocessor_host.register(self.resolved_ts)
        # the CheckLeader fan-out: at most one in flight, its clients
        # reused across beats
        self._rts_fanout_busy = threading.Lock()
        self._rts_thread: Optional[threading.Thread] = None
        self._rts_clients: dict = {}
        # replica device serving (stale reads at the coprocessor):
        # follower reads served from this store's own lines, the regions
        # they covered, and the resolved-ts refusals
        self._replica_mu = threading.Lock()
        self._replica_reads = 0
        self._replica_refused = 0
        self._replica_regions: set = set()
        from .read_pool import ReadPool
        self.read_pool = ReadPool(
            max_concurrency=config.readpool.concurrency)
        # incremental columnar cache maintenance: the apply path feeds
        # committed-write deltas into the sink; the cache patches lines
        # forward across data_index gaps instead of rebuilding
        from ..copr.delta import DeltaSink
        self.copr_delta_sink = DeltaSink(
            max_entries=config.coprocessor.delta_log_entries,
            max_rows=config.coprocessor.delta_log_rows)
        self.raft_store.coprocessor_host.register(self.copr_delta_sink)
        self.copr_cache = RegionColumnarCache(
            capacity=config.coprocessor.region_cache_capacity,
            delta_source=self.copr_delta_sink,
            compact_ratio=config.coprocessor.tombstone_compact_ratio,
            max_delta_rows=config.coprocessor.delta_log_rows)
        self.device_runner = device_runner
        # cross-request device batching: the coalescing dispatcher +
        # cost-based admission router in front of the device backend
        # (server/coalescer.py); window 0 disables it
        coalescer = None
        if config.coprocessor.coalesce_window_ms > 0:
            from .coalescer import RequestCoalescer
            coalescer = RequestCoalescer(
                device_runner,
                window_ms=config.coprocessor.coalesce_window_ms,
                max_group=config.coprocessor.coalesce_max_group)
        self.endpoint = Endpoint(self._copr_snapshot,
                                 device_runner=device_runner,
                                 device_row_threshold=device_row_threshold,
                                 coalescer=coalescer)
        # device-state supervisor: lifecycle events eagerly tear down the
        # matching columnar cache lines and device feeds, the feed arena
        # enforces the configured budget, and a background scrubber
        # audits resident planes against their digests
        from ..device.supervisor import DeviceStateSupervisor
        if config.coprocessor.device_hbm_budget_mb > 0:
            device_runner.set_hbm_budget(
                config.coprocessor.device_hbm_budget_mb << 20)
        self.device_supervisor = DeviceStateSupervisor(
            runner=device_runner, copr_cache=self.copr_cache,
            delta_sink=self.copr_delta_sink,
            scrub_interval=config.coprocessor.scrub_interval_s)
        self.copr_cache.on_line_retired = \
            self.device_supervisor.on_line_retired
        self.raft_store.coprocessor_host.register(self.device_supervisor)
        self.device_supervisor.start()
        # re-mint storm control: bound concurrent cold columnar_build
        # re-mints behind a hot-first priority queue (0 = unthrottled)
        if config.coprocessor.remint_concurrency > 0:
            from ..device.supervisor import RemintGovernor
            gov = RemintGovernor(
                max_concurrent=config.coprocessor.remint_concurrency,
                max_queue=config.coprocessor.remint_queue,
                retry_after_ms=config.coprocessor.remint_retry_after_ms)
            self.copr_cache.remint_gate = gov
            self.device_supervisor.remint_governor = gov
        # the device rung of the cold build, plus the streaming
        # ingest→parse→H2D pipeline that runs it during bulk loads
        self.cold_stream = None
        resolver = None
        if config.coprocessor.device_cold_build:
            resolver = device_runner.mvcc_resolver()
            self.copr_cache.device_resolver = resolver
        stream_on = config.coprocessor.cold_stream
        if stream_on is None:
            # AUTO: the stream's overlap premise is a spare core for the
            # parse worker; on a single-CPU box it only steals cycles
            # from the ingest it shadows
            from ..utils import spare_cores
            stream_on = spare_cores() > 1
        if resolver is not None and stream_on:
            from ..copr.stream_build import ColdStreamBuilder
            self.cold_stream = ColdStreamBuilder(
                resolver,
                max_bytes=config.coprocessor.cold_stream_max_mb << 20)
            self.raft_store.coprocessor_host.register(self.cold_stream)
            self.copr_cache.stream_source = self.cold_stream
        # the compiled request fast path: per-class wire templates learned
        # from full-decode requests; a repeat skips the msgpack and DAG
        # decode and goes to the coalescer (capacity 0 disables it)
        from .fastpath import FastPathCache
        self.fastpath = FastPathCache(
            capacity=config.coprocessor.fastpath_classes)
        # online reconfig (online_config ConfigManager registrations)
        self.config_controller.register("coprocessor", self._copr_cfg)
        self.config_controller.register("readpool", self._readpool_cfg)
        # the split checker reads its knobs live; the fast path's
        # templates still retire on the change
        self.config_controller.register(
            "raftstore", lambda diff: self._fastpath_config_changed())

    def _fastpath_config_changed(self) -> None:
        """Any applied online-config diff retires every learned fast-path
        template (thresholds, windows and knobs feed decisions a template
        pre-bound); one full-decode request a class re-learns it."""
        self.fastpath.bump_config_gen()

    def _readpool_cfg(self, diff: dict) -> None:
        if "concurrency" in diff:
            self.read_pool.set_concurrency(int(diff["concurrency"]))
        self._fastpath_config_changed()

    def _copr_cfg(self, diff: dict) -> None:
        """The coprocessor's online fields (reference :631-700, trimmed to
        what the port has; ``response_page_rows`` is read live by the
        stream)."""
        if "fastpath_classes" in diff:
            self.fastpath.configure(capacity=int(diff["fastpath_classes"]))
        if "device_row_threshold" in diff:
            self.endpoint._device_row_threshold = \
                diff["device_row_threshold"]
        if "region_cache_capacity" in diff:
            self.copr_cache._capacity = diff["region_cache_capacity"]
        if "remint_concurrency" in diff:
            n = int(diff["remint_concurrency"])
            if n <= 0:
                self.copr_cache.remint_gate = None
                self.device_supervisor.remint_governor = None
            else:
                gov = self.copr_cache.remint_gate
                if gov is None:
                    from ..device.supervisor import RemintGovernor
                    gov = RemintGovernor(
                        max_concurrent=n,
                        max_queue=self.config.coprocessor.remint_queue,
                        retry_after_ms=self.config.coprocessor
                        .remint_retry_after_ms)
                    self.copr_cache.remint_gate = gov
                    self.device_supervisor.remint_governor = gov
                else:
                    gov.max_concurrent = n
        if "tombstone_compact_ratio" in diff:
            self.copr_cache._compact_ratio = \
                diff["tombstone_compact_ratio"]
        if "device_hbm_budget_mb" in diff:
            self.device_runner.set_hbm_budget(
                int(diff["device_hbm_budget_mb"]) << 20)
        if "device_cold_build" in diff:
            if not diff["device_cold_build"]:
                self.copr_cache.device_resolver = None
                # the stream exists only to feed the device rung: left
                # running it would keep parsing every ingested chunk and
                # retain host planes nothing can take — torn down with it
                if self.cold_stream is not None:
                    self.copr_cache.stream_source = None
                    self.raft_store.coprocessor_host.unregister(
                        self.cold_stream)
                    self.cold_stream.stop()
                    self.cold_stream = None
            else:
                resolver = self.device_runner.mvcc_resolver()
                self.copr_cache.device_resolver = resolver
                # re-enable restores the whole rung, under the gate the
                # constructor used
                if self.cold_stream is None:
                    stream_on = self.config.coprocessor.cold_stream
                    if stream_on is None:
                        from ..utils import spare_cores
                        stream_on = spare_cores() > 1
                    if stream_on:
                        from ..copr.stream_build import ColdStreamBuilder
                        self.cold_stream = ColdStreamBuilder(
                            resolver,
                            max_bytes=self.config.coprocessor
                            .cold_stream_max_mb << 20)
                        self.raft_store.coprocessor_host.register(
                            self.cold_stream)
                        self.copr_cache.stream_source = self.cold_stream
        coal = self.endpoint.coalescer
        if coal is None and diff.get("coalesce_window_ms", 0):
            # started with coalescing disabled (window 0: no coalescer):
            # an online 0→N enable builds and wires it now
            from .coalescer import RequestCoalescer
            coal = RequestCoalescer(
                self.device_runner,
                window_ms=float(diff["coalesce_window_ms"]),
                max_group=diff.get(
                    "coalesce_max_group",
                    self.config.coprocessor.coalesce_max_group))
            coal.bind(self.endpoint)
            self.endpoint.coalescer = coal
        elif coal is not None and ("coalesce_window_ms" in diff or
                                   "coalesce_max_group" in diff):
            coal.configure(
                window_ms=diff.get("coalesce_window_ms"),
                max_group=diff.get("coalesce_max_group"))
        self._fastpath_config_changed()

    # ---------------------------------------------------------- lifecycle

    def bootstrap_or_join(self) -> None:
        """The first store bootstraps region 1 (src/server/node.rs
        bootstrap); a restart recovers its peers from the engine."""
        self.raft_store.load_peers()
        if self.raft_store.peers:
            return      # restart: state recovered from the engine
        if not self.pd.is_bootstrapped():
            region_id = 1
            peer = Peer(self.pd.alloc_id(), self.store_id)
            region = Region(region_id, b"", b"", RegionEpoch(1, 1), (peer,))
            self.raft_store.bootstrap_region(region)
            self.pd.bootstrap_cluster(StoreMeta(self.store_id, self.addr),
                                      region)
            self.raft_store.region_peer(region_id).node.campaign(force=True)

    def start(self) -> None:
        self.bootstrap_or_join()
        self._thread = threading.Thread(target=self._drive_loop,
                                        daemon=True, name="raft-drive")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # the last CheckLeader fan-out (each call's timeout is 1 s)
        t = self._rts_thread
        if t is not None:
            t.join(timeout=10)
        for c in self._rts_clients.values():
            c.close()
        self._rts_clients.clear()
        self.device_supervisor.stop()
        if self.cold_stream is not None:
            self.cold_stream.stop()
        # idle-drain the read pool, then retire (and JOIN) the endpoint's
        # coalescer and completion-pool workers.  Order matters for the
        # device runner: the endpoint close flushes the coalescer's
        # parked members and drains the completion pool, so every
        # in-flight deferred has resolved (and released its arena pin)
        # before the runner teardown below asserts a pin-free arena.
        self.read_pool.shutdown()
        self.endpoint.close()
        self.device_runner.close()
        # the transport's channels hold real sockets
        self.transport.close()

    def _drive_loop(self) -> None:
        last_tick = time.monotonic()
        last_hb = 0.0
        ticks = 0
        while not self._stop.is_set():
            did = 0
            with self.lock:
                now = time.monotonic()
                if now - last_tick >= self._tick_interval:
                    last_tick = now
                    self.raft_store.tick()
                    ticks += 1
                    every = self.config.raftstore.region_split_check_ticks
                    if every > 0 and ticks % every == 0 and \
                            not self.import_mode:
                        # import mode suspends split checks so a bulk
                        # load isn't fighting auto-splits mid-ingest
                        # (sst_importer import_mode.rs relaxes the
                        # engine the same way)
                        try:
                            self.raft_store.split_check(self.pd)
                        except Exception:   # noqa: BLE001 — PD outage:
                            pass            # retry next interval
                did = self.raft_store.drive()
                self._wake.notify_all()
                # periodic PD reporting (worker/pd.rs heartbeat loop)
                if now - last_hb >= self._tick_interval * 10:
                    last_hb = now
                    leaders = [(p.region, Peer(p.meta.id, self.store_id))
                               for p in self.raft_store.peers.values()
                               if p.is_leader()]
                else:
                    leaders = None
            self.transport.flush()
            if leaders is not None:
                try:
                    for region, leader in leaders:
                        self.pd.region_heartbeat(region, leader)
                    hb = {"region_count": len(leaders)}
                    # per-store HBM figures ride the heartbeat
                    st = self.device_runner.hbm_stats()
                    hb["device_hbm"] = {
                        "budget_bytes": st.get("budget_bytes", 0),
                        "resident_bytes": st.get("resident_bytes", 0)}
                    self.pd.store_heartbeat(self.store_id, hb)
                except Exception:   # noqa: BLE001 — PD outages must not
                    pass            # stall raft
                # the resolved-ts advance rides the same cadence
                self._advance_resolved_ts(leaders)
            if did == 0:
                time.sleep(self._tick_interval / 4)

    def _advance_resolved_ts(self, leaders) -> None:
        """The resolved-ts advance worker's beat (reference :893-902) and
        its push to the follower stores (``CheckLeader``,
        ``_fanout_resolved_ts`` :908-957), so they can serve stale reads.
        On a thread of its own, at most one in flight: the reference takes
        the TSO on its drive thread, where a round trip to PD on a loaded
        host delays the ticks of a 100 ms election timeout; here the drive
        loop only hands the beat's leaders over, and a dead peer store
        stalls nothing."""
        if not leaders or not self._rts_fanout_busy.acquire(
                blocking=False):
            return      # no leader here, or the last beat still runs

        def run():
            try:
                self._fanout_resolved_ts(leaders)
            except Exception:   # noqa: BLE001 — a PD outage: next beat
                pass
            finally:
                self._rts_fanout_busy.release()

        self._rts_thread = threading.Thread(target=run, daemon=True,
                                            name="rts-fanout")
        self._rts_thread.start()

    def _fanout_resolved_ts(self, leaders) -> None:
        from .client import StoreClient
        # a fresh TSO into the concurrency manager FIRST, so a later async
        # commit or 1PC finalizes above the watermark, then the advance
        ts = self.pd.tso()
        self.storage.concurrency_manager.update_max_ts(ts)
        advanced = self.resolved_ts.advance_all(
            ts, [r.id for r, _l in leaders])
        per_store: dict = {}
        for region, _leader in leaders:
            rts = advanced.get(region.id, 0)
            peer = self.raft_store.peers.get(region.id)
            if rts <= 0 or peer is None:
                continue
            # the apply index read NOW, after the advance: a commit
            # applied between the beat's snapshot and the watermark has
            # commit_ts < rts, and pairing rts with an older index would
            # let a follower lacking that commit serve without it.  A
            # fresher index only raises the bar
            applied = peer.applied_engine
            for p in region.peers:
                if p.store_id != self.store_id:
                    per_store.setdefault(p.store_id, []).append(
                        {"region_id": region.id, "resolved_ts": rts,
                         "applied_index": applied})
        for sid, regions in per_store.items():
            try:
                addr = self.pd.get_store(sid).address
                c = self._rts_clients.get(addr)
                if c is None:
                    c = self._rts_clients[addr] = StoreClient(addr)
                c.call("CheckLeader", {"regions": regions}, timeout=1)
            except Exception:   # noqa: BLE001 — the next beat
                pass

    def check_leader(self, regions) -> dict:
        """The follower's half of ``CheckLeader``: a region's resolver
        advances to the leader's watermark only once this store's own
        apply has reached the leader's applied index (every commit the
        watermark covers is then in its applied state), and never past
        its own pending locks → {str(region id): resolved_ts}, string
        keys because msgpack's strict map keys refuse int keys."""
        out = {}
        with self.lock:
            for ent in regions:
                rid = ent["region_id"]
                peer = self.raft_store.peers.get(rid)
                if peer is None or \
                        peer.applied_engine < ent.get("applied_index", 0):
                    continue
                out[str(rid)] = self.resolved_ts.resolver(rid).advance(
                    ent["resolved_ts"])
        return out

    def _wait_driver(self, done) -> None:
        """RaftKv blocks here while the drive thread makes progress."""
        deadline = time.monotonic() + 10.0
        with self.lock:
            self.raft_store.drive()
            while not done():
                if time.monotonic() > deadline:
                    raise TimeoutError("raft command stalled")
                self._wake.wait(timeout=0.05)
                self.raft_store.drive()

    # ---------------------------------------------------------- hooks

    def on_raft_message(self, region_id, to_peer, from_peer, msg) -> None:
        with self.lock:
            self.raft_store.on_raft_message(region_id, to_peer, from_peer,
                                            msg)
            self._wake.notify_all()

    def _report_region(self, store_id: int, region: Region) -> None:
        peer = self.raft_store.peers.get(region.id)
        if peer is not None and peer.is_leader():
            self.pd.region_heartbeat(region, Peer(peer.meta.id, store_id))

    def _copr_snapshot(self, req):
        """Coprocessor feed: MVCC over a region snapshot routed by the
        request's first key range (endpoint.rs snapshot acquisition).

        TableScan plans go through the per-region columnar cache so both
        the host vectorized path and the device backend see dense tiles
        with stable identity across requests (copr/region_cache.py);
        everything else falls back to the row-at-a-time MVCC adapter.

        ``req.stale_read`` is the follower device-serving path: this
        replica mints and patches its OWN columnar line from applied state
        (the delta sink sees a follower's applies too) and serves it with
        no consensus round trip, gated on ``start_ts ≤ resolved_ts``
        (``DataIsNotReady`` above it: the client falls through to the
        leader).
        """
        start = req.dag.ranges[0].start if req.dag.ranges else b""
        key_hint = encode_first(start)
        # async-commit read protocol: bump max_ts, then check the
        # in-memory lock table scoped to the REQUEST's key ranges
        from ..utils import tracker
        cm = self.storage.concurrency_manager
        cm.update_max_ts(req.dag.start_ts)
        if req.dag.ranges:
            cm.read_ranges_check(req.dag.ranges, req.dag.start_ts)
        else:
            cm.read_range_check(None, None, req.dag.start_ts)
        stale = req.stale_read
        if stale:
            self._check_replica_freshness(key_hint, req.dag.start_ts)
        with tracker.phase("snapshot"):
            snap = self.raft_kv.snapshot(
                SnapContext(key_hint=key_hint, stale_read=stale))
        execs = req.dag.executors
        if execs and isinstance(execs[0], TableScanDesc):
            # outside the node lock: a cold build mints on the card.  The
            # replica leg names its cache access replica_patch, keeping a
            # follower feed's latency apart from the leader's
            with tracker.phase("replica_patch" if stale
                               else "columnar_cache"):
                ent = self.copr_cache.get(snap, req.dag)
            if ent is not None:
                if stale:
                    self._note_replica_read(snap.region.id)
                learn = req.fp_learn
                if learn is not None:
                    # the snapshot's region identity anchors the learned
                    # class's cache key: an epoch bump or a split changes
                    # it and the class misses
                    learn["region"] = snap.region.id
                    learn["epoch_version"] = snap.region.epoch.version
                return ent
        return MvccScanStorage(MvccReader(snap), req.dag.start_ts)

    def _check_replica_freshness(self, key_hint: bytes,
                                 read_ts: int) -> int:
        """The resolved-ts gate of a follower read: closed timestamps
        guarantee that no commit at ts ≤ resolved_ts can newly appear, so
        applied state is exact for a read at or below the watermark.
        Above it the replica refuses (``DataIsNotReady``) rather than
        serve a possibly incomplete answer.  The ``device::replica_stale``
        failpoint forces the refusal."""
        from ..raftstore.metapb import DataIsNotReady
        from ..utils.failpoint import fail_point
        peer = self.raft_store.peer_by_key(key_hint)
        rts = self.resolved_ts.resolver(peer.region.id).resolved_ts
        if fail_point("device::replica_stale") is not None:
            rts = 0
        if read_ts > rts:
            with self._replica_mu:
                self._replica_refused += 1
            raise DataIsNotReady(peer.region.id, rts, read_ts)
        return peer.region.id

    def _note_replica_read(self, region_id: int) -> None:
        """A follower device read served: its region's line is now a live
        replica feed, kept patched by the delta stream — a leader gain
        promotes it by digest."""
        with self._replica_mu:
            self._replica_reads += 1
            first = region_id not in self._replica_regions
            self._replica_regions.add(region_id)
        if first:
            self.device_supervisor.note_replica_feed(region_id)

    def replica_serving_stats(self) -> dict:
        """``/health``'s ``replica_serving`` rollup."""
        sup = self.device_supervisor
        with self._replica_mu:
            return {"replica_reads": self._replica_reads,
                    "refused": self._replica_refused,
                    "replica_regions": sorted(self._replica_regions),
                    "promotions": sup.promotions,
                    "demotions": sup.demotions,
                    "promotion_rebuilds": sup.promotion_rebuilds}

    def fastpath_snapshot(self, ent, start_ts: int):
        """The slim snapshot of a fast-path hit (``server/fastpath.py``):
        the safety steps ``_copr_snapshot`` runs — the max_ts bump, the
        in-memory lock check, the raft lease read — with the key hint,
        ranges and cache key pre-derived on the class entry.  → the
        current warm columnar snapshot, or None (a cold line, a moved
        epoch): the caller then takes the full ceremony with the DAG in
        hand.  The cache is read after ``raft_kv.snapshot`` returns,
        outside the node lock."""
        from ..utils import tracker
        cm = self.storage.concurrency_manager
        cm.update_max_ts(start_ts)
        if ent.ranges:
            cm.read_ranges_check(ent.ranges, start_ts)
        else:
            cm.read_range_check(None, None, start_ts)
        with tracker.phase("snapshot"):
            snap = self.raft_kv.snapshot(SnapContext(key_hint=ent.key_hint))
        with tracker.phase("columnar_cache"):
            return self.copr_cache.get_fast(snap, ent.base_key, ent.ranges,
                                            start_ts)

    # ---------------------------------------------------------- admin ops

    def _propose_and_wait(self, peer, cmd: RaftCmd):
        """Propose ``cmd`` on ``peer`` (the caller holds the node lock) →
        the box its result lands in, which ``_wait_result`` awaits."""
        box: dict = {}
        peer.propose(cmd, lambda r: box.__setitem__("result", r))
        return box

    def _wait_result(self, box: dict):
        self._wait_driver(lambda: "result" in box)
        if isinstance(box["result"], Exception):
            raise box["result"]
        return box["result"]

    def split_region(self, region_id: int, split_key: bytes) -> Region:
        """Split the region at the user key ``split_key`` (encoded first;
        ``region_id`` 0 picks the region holding it) → the new right
        region."""
        enc_split = encode_key(split_key)
        with self.lock:
            if not region_id:
                peer = self.raft_store.peer_by_key(enc_split)
            else:
                peer = self.raft_store.region_peer(region_id)
            new_id, new_peer_ids = self.pd.ask_split(peer.region)
            cmd = RaftCmd(peer.region.id, peer.region.epoch,
                          admin=AdminCmd("split", split_key=enc_split,
                                         new_region_id=new_id,
                                         new_peer_ids=tuple(new_peer_ids)))
            box = self._propose_and_wait(peer, cmd)
        return self._wait_result(box)["right"]

    def region_applied(self, region_id: int) -> int:
        """Local peer's apply index (merge coordination probe)."""
        with self.lock:
            return self.raft_store.region_peer(region_id).node.applied

    def merge_region(self, source_id: int, target_id: int) -> Region:
        """Coordinated region merge over the network (this node must
        lead BOTH regions): PrepareMerge on the source, poll every
        source-peer store's apply index over gRPC (``RegionApplied``)
        until the prepare is everywhere, then CommitMerge on the target
        — the PD-scheduler protocol of ``testing.cluster.Cluster
        .merge_region`` lifted onto real RPC.  A failure after the
        prepare rolls the source back."""
        from ..raftstore.peer_storage import encode_region
        from .client import StoreClient
        with self.lock:
            src = self.raft_store.region_peer(source_id)
            tgt = self.raft_store.region_peer(target_id)
            if not tgt.is_leader():
                # check BEFORE proposing PrepareMerge: discovering this
                # after the prepare would leave the source write-dead
                # until a rollback
                raise NotLeaderError(target_id, tgt.leader_peer())
            sr, tr = src.region, tgt.region
            if sorted(p.store_id for p in sr.peers) != \
                    sorted(p.store_id for p in tr.peers):
                raise ValueError("merge requires colocated replicas")
            if not ((sr.end_key and sr.end_key == tr.start_key) or
                    (tr.end_key and tr.end_key == sr.start_key)):
                raise ValueError("merge requires adjacent regions")
            box = self._propose_and_wait(src, RaftCmd(
                source_id, sr.epoch, admin=AdminCmd(
                    "prepare_merge", new_region_id=target_id)))
        res = self._wait_result(box)
        prepare_index = res["prepare_index"]
        source_region = res["region"]
        try:
            deadline = time.monotonic() + 10.0
            pending = {p.store_id for p in source_region.peers
                       if p.store_id != self.store_id}
            clients: dict = {}
            try:
                while pending:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"merge: stores {pending} lag the prepare")
                    for sid in list(pending):
                        try:
                            c = clients.get(sid)
                            if c is None:
                                c = clients[sid] = StoreClient(
                                    self.pd.get_store(sid).address)
                            r = c.call("RegionApplied",
                                       {"region_id": source_id})
                            if r["applied"] >= prepare_index:
                                pending.discard(sid)
                        except Exception:   # noqa: BLE001 — poll again
                            pass
                    if pending:
                        time.sleep(0.02)
            finally:
                for c in clients.values():
                    c.close()
            with self.lock:
                box = self._propose_and_wait(tgt, RaftCmd(
                    target_id, tgt.region.epoch, admin=AdminCmd(
                        "commit_merge", merge_index=prepare_index,
                        extra=encode_region(source_region))))
            return self._wait_result(box)["region"]
        except Exception:
            # the merge cannot proceed: roll the source back so it is
            # not left permanently write-dead (fsm RollbackMerge)
            try:
                self.rollback_merge(source_id)
            except Exception:   # noqa: BLE001 — the original error wins
                pass
            raise

    def rollback_merge(self, region_id: int) -> None:
        """Abort an in-flight PrepareMerge (exec_rollback_merge)."""
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            box = self._propose_and_wait(peer, RaftCmd(
                region_id, peer.region.epoch, admin=AdminCmd(
                    "rollback_merge", merge_index=peer.merging or 0)))
        self._wait_result(box)

    def change_peer(self, region_id: int, change_type: str,
                    peer_meta: Peer) -> None:
        """Add (``add``, ``add_learner``) or remove (``remove``) one peer
        of the region this node leads."""
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            box = self._propose_and_wait(peer, RaftCmd(
                region_id, peer.region.epoch,
                admin=AdminCmd("change_peer", change_type=change_type,
                               peer=peer_meta)))
        self._wait_result(box)

    def change_peer_v2(self, region_id: int, changes) -> None:
        """Atomic multi-peer change via joint consensus; ``changes`` =
        [(type, Peer)] (raftstore ChangePeerV2)."""
        from ..raftstore.cmd import encode_change_peer_v2
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            box = self._propose_and_wait(peer, RaftCmd(
                region_id, peer.region.epoch, admin=AdminCmd(
                    "change_peer_v2",
                    extra=encode_change_peer_v2(changes))))
        self._wait_result(box)

    def transfer_leader(self, region_id: int, to_peer_id: int) -> None:
        """Ask the region's leader here to hand leadership to the peer
        ``to_peer_id`` (returns at once; the caller polls the leader)."""
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            peer.node.transfer_leader(to_peer_id)

    def status(self) -> dict:
        with self.lock:
            return {
                "store_id": self.store_id,
                "addr": self.addr,
                "regions": [
                    {"region": wire.enc_region(p.region),
                     "leader": p.is_leader(),
                     "term": p.node.term,
                     "applied": p.node.applied,
                     "resolved_ts": self.resolved_ts.resolver(
                         p.region.id).resolved_ts}
                    for p in self.raft_store.peers.values()],
            }

    # ---------------------------------------------------------- ingest

    def ingest_sst(self, region_id: int, pairs) -> int:
        """Atomically land pre-built SST pairs in one raft command on
        the target region (sst_importer ingest; fsm/apply.rs IngestSst).
        Keys must be engine-encoded and inside the region's range —
        range violations are refused before proposing."""
        from ..raftstore.cmd import WriteOp
        from ..raftstore.metapb import KeyNotInRegion
        from ..storage.txn_types import split_ts
        from ..utils.failpoint import fail_point
        fail_point("ingest::before_check")
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            region = peer.region
            for _cf, key, _v in pairs:
                bare = split_ts(key)[0] if len(key) > 8 else key
                if not region.contains(bare):
                    raise KeyNotInRegion(key, region)
            ops = tuple(WriteOp("put", cf, key, value)
                        for cf, key, value in pairs)
            cmd = RaftCmd(region_id, region.epoch, ops=ops)
            fail_point("ingest::before_propose")
            box = self._propose_and_wait(peer, cmd)
        self._wait_result(box)
        return len(ops)

    def ingest_sst_blob(self, region_id: int, blob: bytes) -> int:
        """Atomically land one v2 SST container with a single raft op
        (fsm/apply.rs IngestSst): the file rides the log as one blob and
        apply bulk-merges its sorted runs.  The range check touches only
        each run's first/last key (runs are sorted)."""
        from ..raftstore.cmd import WriteOp
        from ..raftstore.metapb import KeyNotInRegion
        from ..sst_importer import read_sst_cf
        from ..storage.txn_types import split_ts
        from ..utils.failpoint import fail_point
        fail_point("ingest::before_blob_check")
        cf_map = read_sst_cf(blob)      # validates checksum + key order
        n_total = 0
        with self.lock:
            peer = self.raft_store.region_peer(region_id)
            region = peer.region
            for _cf, (keys, _vals) in cf_map.items():
                if not keys:
                    continue
                n_total += len(keys)
                for key in (keys[0], keys[-1]):
                    bare = split_ts(key)[0] if len(key) > 8 else key
                    if not region.contains(bare):
                        raise KeyNotInRegion(key, region)
            cmd = RaftCmd(region_id, region.epoch,
                          ops=(WriteOp("ingest", "", b"", blob),))
            fail_point("ingest::before_blob_propose")
            box = self._propose_and_wait(peer, cmd)
        self._wait_result(box)
        return n_total


def encode_first(start: bytes) -> bytes:
    return encode_key(start) if start else b""
