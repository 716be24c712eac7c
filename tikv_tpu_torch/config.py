"""Configuration tree + online reconfiguration.

A trimmed copy of the JAX package's ``config.py``: the fields the port
reads, in the sections ``server``, ``storage``, ``raftstore``,
``coprocessor`` (with the mesh and slice knobs the CLI builds a mesh
runner from, and the stream's page size), ``readpool`` and ``security``,
with their defaults, and ``TikvConfig`` (from a TOML file or a dict,
validated; a region's split size must not exceed its max size).  Every
other setting of a reference config file (tracing, RU metering, resource
control, ...) loads and is ignored: the port has no
code that reads it.  ``ConfigController`` routes a live change (the
status server's ``POST /config``) to the manager a subsystem registered
for its section; ``_ONLINE_FIELDS`` names the fields whose managers the
port's ``Node`` applies.  ``Node`` refuses a value the port cannot
honor (a data directory, a batch-system pool, digests switched off).

Reference: src/config/mod.rs (``TikvConfig`` — one serde-TOML tree
embedding every subsystem's config), components/online_config
(``OnlineConfig`` derive + ``ConfigManager`` trait, lib.rs:137) and the
``ConfigController`` that routes live changes to registered managers.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from dataclasses import dataclass, field, fields
from typing import Callable, Optional


@dataclass
class ServerConfig:
    addr: str = "127.0.0.1:20160"
    status_addr: str = ""               # "" = status server disabled
    grpc_concurrency: int = 8


@dataclass
class StorageConfig:
    data_dir: str = ""                  # only "" (the in-memory engine)


@dataclass
class RaftstoreConfig:
    raft_heartbeat_ticks: int = 2
    raft_election_timeout_ticks: int = 10
    # TiKV's classic raft-kv defaults (region-split-size 96 MiB,
    # region-max-size 144 MiB): the split checker's threshold, run every
    # region_split_check_ticks drive-loop ticks
    region_split_size_mb: int = 96
    region_max_size_mb: int = 144
    region_split_check_ticks: int = 10
    # sub-region bucket bounds the split checker's scan records
    region_bucket_size_mb: float = 32.0
    # batch-system pollers: only 0 (the synchronous drive loop)
    store_pool_size: int = 0


@dataclass
class CoprocessorConfig:
    # device routing crossover — rationale at
    # copr/endpoint.py Endpoint.DEFAULT_DEVICE_ROW_THRESHOLD; raise to
    # ~2^22 for tunneled (high-RTT) device transports
    device_row_threshold: int = 131072
    region_cache_capacity: int = 8
    # a CoprocessorStream page's rows when the request names none
    response_page_rows: int = 1 << 20
    # incremental columnar cache maintenance (copr/region_cache.py):
    # per-region committed-write delta log bounds — a data-version gap
    # wider than the retained log rebuilds instead of patching
    delta_log_entries: int = 1024
    delta_log_rows: int = 1 << 16
    # compact a delta-maintained line when pending delete tombstones
    # exceed this fraction of its rows
    tombstone_compact_ratio: float = 0.25
    # device-state integrity (device/supervisor.py): HBM budget for the
    # runner's feed arena in MiB (0 = unlimited — accounting only) and
    # the background scrub cadence in seconds (0 = scrub on demand).
    # scrub_digests records per-plane content digests at feed build and
    # patch time — the audit the scrubber compares against; the port's
    # runner always records them, so only True is accepted
    device_hbm_budget_mb: int = 0
    scrub_interval_s: float = 0.0
    scrub_digests: bool = True
    # cross-request device batching (server/coalescer.py): concurrent
    # requests sharing a compile class + resident feed coalesce into
    # one stacked dispatch under a bounded, deadline-aware collection
    # window.  coalesce_window_ms = 0 disables the subsystem entirely
    # (every device request dispatches solo); coalesce_max_group caps
    # group size (also the stacked kernel's largest lane bucket)
    coalesce_window_ms: float = 2.0
    coalesce_max_group: int = 16
    # the compiled request fast path (server/fastpath.py): the learned
    # wire-template classes kept (0 disables it: every request takes the
    # full decode)
    fastpath_classes: int = 64
    # cold-path kill (device/mvcc.py + copr/stream_build.py):
    # device_cold_build enables the device rung of the columnar build
    # ladder (flat-plane parse + on-device MVCC version resolution, the
    # feed born resident); cold_stream additionally parses + uploads
    # CF_WRITE planes of bulk-ingested SST chunks WHILE the load runs,
    # so the first query's build degenerates to one resolve dispatch.
    # cold_stream=None (the default) is AUTO: on iff the process has a
    # spare core to run the parse worker on — the overlap premise is a
    # second core, and on a single-CPU box the worker only steals
    # cycles from the very ingest it shadows.  True/False force it.
    # cold_stream_max_mb bounds the retained host planes per region
    # (device planes shed first at half the cap); 0 = unlimited
    device_cold_build: bool = True
    cold_stream: Optional[bool] = None
    cold_stream_max_mb: int = 1024
    # re-mint storm control (device/supervisor.py RemintGovernor):
    # remint_concurrency bounds concurrent cold columnar_build
    # re-mints after a mass invalidation (0 = unthrottled — the
    # pre-storm-control behavior); excess builds park in a priority
    # queue (hot regions first, RU-debt tenants last) of at most
    # remint_queue, past which the worst-priority waiter is shed with
    # a ServerIsBusy carrying remint_retry_after_ms
    remint_concurrency: int = 0
    remint_queue: int = 32
    remint_retry_after_ms: int = 50
    # the mesh runner the CLI builds (parallel/mesh.py,
    # device/placement.py): mesh_shape pins the ("range", "tile") mesh
    # factorization ("2x4"; None lets the mesh pick the squarest split),
    # device_placement turns on hot-region → slice routing, feeds of
    # placement_rows rows or more shard over the whole mesh
    mesh_shape: Optional[str] = None
    device_placement: bool = False
    placement_rows: int = 1 << 22
    # the slices' failure domain (device/supervisor.py SliceHealth):
    # strikes to quarantine a slice, the half-open probe's cooldown after
    # a trip, and the fetch latency that strikes 0.25 (0: no latency
    # strikes)
    slice_trip_strikes: float = 3.0
    slice_probe_cooldown_s: float = 0.25
    slice_latency_outlier_s: float = 0.0


@dataclass
class ReadPoolConfig:
    concurrency: int = 8


@dataclass
class SecurityConfig:
    """[security]: TLS for every gRPC channel (components/security);
    ``server/security.py`` builds its manager from it."""

    ca_path: str = ""
    cert_path: str = ""
    key_path: str = ""

    @property
    def enabled(self) -> bool:
        return bool(self.ca_path or self.cert_path)


@dataclass
class TikvConfig:
    """The config tree (config/mod.rs TikvConfig analog), trimmed to the
    fields the port's node reads."""

    server: ServerConfig = field(default_factory=ServerConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    raftstore: RaftstoreConfig = field(default_factory=RaftstoreConfig)
    coprocessor: CoprocessorConfig = field(
        default_factory=CoprocessorConfig)
    readpool: ReadPoolConfig = field(default_factory=ReadPoolConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)

    @staticmethod
    def from_file(path: str) -> "TikvConfig":
        import tomllib
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return TikvConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "TikvConfig":
        cfg = TikvConfig()
        for f in fields(cfg):
            sub = raw.get(f.name.replace("_", "-"), raw.get(f.name))
            if sub is None:
                continue
            target = getattr(cfg, f.name)
            for sf in fields(target):
                key = sf.name.replace("_", "-")
                if key in sub or sf.name in sub:
                    setattr(target, sf.name, sub.get(key, sub.get(sf.name)))
        cfg.validate()
        return cfg

    def validate(self) -> None:
        r = self.raftstore
        if r.raft_heartbeat_ticks >= r.raft_election_timeout_ticks:
            raise ValueError("heartbeat ticks must be < election ticks")
        if r.region_split_size_mb > r.region_max_size_mb:
            raise ValueError("region-split-size must be <= region-max-size")
        if self.readpool.concurrency < 1:
            raise ValueError("readpool concurrency must be >= 1")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# fields changeable at runtime ("section.field" — OnlineConfig markers):
# the raftstore's split knobs (read live by the split checker), the
# coprocessor fields the node's manager applies or the stream reads live,
# and the read pool's concurrency
_ONLINE_FIELDS = {
    "raftstore.region_split_size_mb",
    "raftstore.region_max_size_mb",
    "raftstore.region_split_check_ticks",
    "coprocessor.device_row_threshold",
    "coprocessor.region_cache_capacity",
    "coprocessor.response_page_rows",
    "coprocessor.tombstone_compact_ratio",
    "coprocessor.device_hbm_budget_mb",
    "coprocessor.coalesce_window_ms",
    "coprocessor.coalesce_max_group",
    "coprocessor.fastpath_classes",
    "coprocessor.device_cold_build",
    "coprocessor.remint_concurrency",
    "readpool.concurrency",
}


class ConfigController:
    """Live-change router (online_config ConfigController analog).

    Subsystems register a manager callback per section; ``update``
    validates the diff against _ONLINE_FIELDS, applies it to the config
    tree, and dispatches {changed field: value} to the section manager.
    """

    def __init__(self, cfg: TikvConfig):
        self.cfg = cfg
        self._managers: dict[str, Callable[[dict], None]] = {}
        self._lock = threading.Lock()

    def register(self, section: str,
                 manager: Callable[[dict], None]) -> None:
        self._managers[section] = manager

    def update(self, changes: dict) -> dict:
        """changes: {"raftstore.region-split-size-mb": 64, ...} →
        {applied field: value}.  Raises ValueError on unknown or
        non-online fields (nothing is applied)."""
        with self._lock:
            parsed = []
            for dotted, value in changes.items():
                section, _, name = dotted.replace("-", "_").partition(".")
                if not name:
                    raise ValueError(f"bad config key {dotted!r}")
                if f"{section}.{name}" not in _ONLINE_FIELDS:
                    raise ValueError(
                        f"{dotted!r} is not an online-config field")
                target = getattr(self.cfg, section, None)
                if target is None or not hasattr(target, name):
                    raise ValueError(f"unknown config field {dotted!r}")
                cur = getattr(target, name)
                if cur is not None and value is not None and \
                        not isinstance(value, type(cur)):
                    if isinstance(cur, bool) or not (
                            isinstance(cur, (int, float)) and
                            isinstance(value, (int, float))):
                        raise ValueError(
                            f"{dotted!r}: want {type(cur).__name__}")
                parsed.append((section, name, value))
            # validate the tree with changes applied before committing
            # (deep copy: replace() would share the nested sections)
            trial = copy.deepcopy(self.cfg)
            for section, name, value in parsed:
                setattr(getattr(trial, section), name, value)
            trial.validate()
            applied: dict = {}
            by_section: dict[str, dict] = {}
            for section, name, value in parsed:
                setattr(getattr(self.cfg, section), name, value)
                applied[f"{section}.{name}"] = value
                by_section.setdefault(section, {})[name] = value
        for section, diff in by_section.items():
            mgr = self._managers.get(section)
            if mgr is not None:
                mgr(diff)
        return applied
