"""Command-line entrypoints.

A trimmed copy of the JAX package's ``server/cli.py``: ``pd``, ``tikv``
and ``ctl`` with ``put``, ``get``, ``scan``, ``region``, ``split``,
``add-peer``, ``merge``, ``rollback-merge``, ``store-status``,
``stores`` and ``tso``.  ``tikv`` serves from the card: ``DeviceRunner()``
on ``cuda:0`` (it raises without CUDA), or with ``--config`` a mesh
runner from the file's ``mesh-shape`` and slice knobs; ``--device cpu``
gives the CPU runner.  The reference's ``--with-device`` is accepted
(the card is the default).  ``--data-dir`` is refused by the node (the
port runs the in-memory engine).  ``ctl``'s ``gc`` and debug
subcommands are refused by name.  Usage:

    python -m tikv_tpu_torch.server pd --addr 127.0.0.1:2379
    python -m tikv_tpu_torch.server tikv --addr 127.0.0.1:20160 \\
        --pd 127.0.0.1:2379 [--device cpu] [--status-addr 127.0.0.1:20180]
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 put k v
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 get k
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 region --key k
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 split k
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 add-peer 1 2
    python -m tikv_tpu_torch.server ctl --pd 127.0.0.1:2379 store-status 1

Reference: cmd/tikv-server/src/main.rs (server binary: config + flags →
run_tikv) and cmd/tikv-ctl (ops CLI: region inspect, split, peer ops,
KV ops).
"""

from __future__ import annotations

import argparse
import json
import sys

# ctl subcommands of the reference the port refuses → what each waits for
_REFUSED_CTL = {
    "gc": "GC (storage/txn/gc.py)",
    **{op: "the debug service (server/debug.py)" for op in (
        "debug-get", "region-info", "region-size", "mvcc", "raft-log",
        "tombstone", "compact")},
}


def device_runner(args, config):
    """The runner ``tikv`` serves from: the card unless ``--device cpu``."""
    from ..device import DeviceRunner
    if args.device == "cpu":
        return DeviceRunner(device="cpu")
    if config is None:
        return DeviceRunner()
    # the mesh from the config file's factorization and placement knobs
    from ..parallel import make_mesh, parse_mesh_shape
    cc = config.coprocessor
    return DeviceRunner(
        mesh=make_mesh(shape=parse_mesh_shape(cc.mesh_shape)),
        placement=cc.device_placement,
        placement_rows=cc.placement_rows,
        slice_trip_strikes=cc.slice_trip_strikes,
        slice_probe_cooldown_s=cc.slice_probe_cooldown_s,
        slice_latency_outlier_s=cc.slice_latency_outlier_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tikv_tpu_torch.server")
    sub = p.add_subparsers(dest="cmd", required=True)

    pd_p = sub.add_parser("pd", help="run the placement driver")
    pd_p.add_argument("--addr", default="127.0.0.1:2379")

    kv_p = sub.add_parser("tikv", help="run a tikv store server")
    kv_p.add_argument("--addr", default="127.0.0.1:20160")
    kv_p.add_argument("--pd", required=True)
    kv_p.add_argument("--data-dir", default=None,
                      help="refused: the port's store is in memory")
    kv_p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="where the coprocessor's runner serves "
                           "(default: the card)")
    kv_p.add_argument("--with-device", action="store_true",
                      help="accepted for the reference's command lines: "
                           "the card is the default")
    kv_p.add_argument("--config", default=None,
                      help="TOML config file (config-template.toml shape)")
    kv_p.add_argument("--status-addr", default=None,
                      help="HTTP status server bind (/status /health "
                           "/config /region /fail_point)")

    ctl = sub.add_parser("ctl", help="ops CLI (tikv-ctl analog)")
    ctl.add_argument("--pd", required=True)
    ctl_sub = ctl.add_subparsers(dest="op", required=True)
    sp = ctl_sub.add_parser("put")
    sp.add_argument("key")
    sp.add_argument("value")
    gp = ctl_sub.add_parser("get")
    gp.add_argument("key")
    scn = ctl_sub.add_parser("scan")
    scn.add_argument("start")
    scn.add_argument("--limit", type=int, default=16)
    rg = ctl_sub.add_parser("region")
    rg.add_argument("--key", required=True)
    spl = ctl_sub.add_parser("split")
    spl.add_argument("key")
    ap = ctl_sub.add_parser("add-peer")
    ap.add_argument("region_id", type=int)
    ap.add_argument("store_id", type=int)
    mg = ctl_sub.add_parser("merge")
    mg.add_argument("source_id", type=int)
    mg.add_argument("target_id", type=int)
    rb = ctl_sub.add_parser("rollback-merge")
    rb.add_argument("region_id", type=int)
    st = ctl_sub.add_parser("store-status")
    st.add_argument("store_id", type=int)
    ctl_sub.add_parser("stores")
    ctl_sub.add_parser("tso")
    for op in _REFUSED_CTL:
        ctl_sub.add_parser(op)

    # a refused subcommand takes its reference arguments unread
    args, extra = p.parse_known_args(argv)
    if extra and not (args.cmd == "ctl" and args.op in _REFUSED_CTL):
        p.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.cmd == "pd":
        from .pd_server import PdServer
        server = PdServer(args.addr)
        server.start()
        print(f"pd listening on {args.addr}", flush=True)
        server.wait()
        return 0

    if args.cmd == "tikv":
        from .node import Node
        from .pd_server import RemotePdClient
        from .server import TikvServer
        config = None
        if args.config:
            from ..config import TikvConfig
            config = TikvConfig.from_file(args.config)
            if config.security.enabled:
                from .security import set_default
                set_default(config.security)
        runner = device_runner(args, config)
        if args.status_addr and config is not None:
            config.server.status_addr = args.status_addr
        node = Node(args.addr, RemotePdClient(args.pd),
                    data_dir=args.data_dir, device_runner=runner,
                    config=config)
        server = TikvServer(node, status_addr=args.status_addr)
        server.start()
        # graceful shutdown on SIGTERM/SIGINT through the service-event
        # channel (cmd/tikv-server main.rs signal handler)
        import signal

        from ..service_event import (
            ServiceEvent,
            ServiceEventChannel,
            attach,
        )
        events = ServiceEventChannel()
        dispatcher = attach(events, server)

        def _on_signal(signum, _frame):
            print(f"received signal {signum}; shutting down", flush=True)
            events.post(ServiceEvent.EXIT)

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        if server.status_server is not None:
            print(f"status server on port {server.status_server.port}",
                  flush=True)
        print(f"tikv store {node.store_id} listening on {args.addr}",
              flush=True)
        server.wait()
        # the dispatcher's stop() runs the node's teardown: let it finish
        dispatcher.join(timeout=30)
        return 0

    if args.op in _REFUSED_CTL:
        print(f"ctl {args.op}: not in the port (waits for "
              f"{_REFUSED_CTL[args.op]})", file=sys.stderr)
        return 2

    from .client import TxnClient
    c = TxnClient(args.pd)
    enc = lambda s: s.encode()          # noqa: E731

    if args.op == "put":
        c.put(enc(args.key), enc(args.value))
        print("OK")
    elif args.op == "get":
        v = c.get(enc(args.key))
        print(v.decode(errors="replace") if v is not None else "(nil)")
    elif args.op == "scan":
        for k, v in c.scan(enc(args.start), None, args.limit):
            print(k, v)
    elif args.op == "region":
        # region bounds are encoded keys: the user key is encoded to
        # route, and the bounds decoded to print (the reference routes
        # the raw key, so every key below "x" lands in the first region)
        from ..storage.txn_types import decode_key, encode_key

        def user(k: bytes) -> str:
            return decode_key(k).decode(errors="replace") if k else ""
        region, leader = c.pd.get_region_with_leader(
            encode_key(enc(args.key)))
        print(json.dumps({
            "id": region.id,
            "start": user(region.start_key),
            "end": user(region.end_key),
            "epoch": [region.epoch.conf_ver, region.epoch.version],
            "peers": [[pr.id, pr.store_id] for pr in region.peers],
            "leader": leader.id if leader else None}))
    elif args.op == "split":
        right = c.split(enc(args.key))
        print(f"new region {right.id} at {args.key!r}")
    elif args.op == "add-peer":
        peer = c.add_peer(args.region_id, args.store_id)
        print(f"added peer {peer.id} on store {peer.store_id}")
    elif args.op == "merge":
        merged = c.merge(args.source_id, args.target_id)
        print(f"merged region {args.source_id} into {merged.id}")
    elif args.op == "rollback-merge":
        region = c.pd.get_region_by_id(args.region_id)
        c._call_leader_by_region(region, "RollbackMerge",
                                 {"region_id": args.region_id})
        print(f"rolled back merge on region {args.region_id}")
    elif args.op == "store-status":
        print(json.dumps(c.status(args.store_id), default=repr, indent=2))
    elif args.op == "stores":
        for s in c.pd.stores():
            print(s.id, s.address)
    elif args.op == "tso":
        print(c.tso())
    c.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
