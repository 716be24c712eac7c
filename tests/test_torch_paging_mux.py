"""Coprocessor paging and streaming, and the ``BatchCommands`` mux,
through the port's gRPC server against the JAX package's.

``tests/test_paging_mux.py``'s cases on one store of each package (PD
and one ``TikvServer`` on loopback; the port's node on a
``DeviceRunner(device="cpu")``), the same 500 rows written to both: the
unary paged protocol (``TxnClient.coprocessor_paged``: every page within
its budget, every row once, the pages alike in both packages), a paged
selection, an aggregation answered as one final page, the
``CoprocessorStream`` pinned to one snapshot (a write mid-stream not
seen by its later pages), and ``BatchCommandsClient``: KV and coprocessor
commands on one stream, an error failing only its own call, 32
concurrent callers, and a parked pessimistic-lock wait that does not
block the commit (sent on the same stream) that releases it.
"""

from __future__ import annotations

import threading
import time

import pytest

from tikv_tpu.server import wire as ref_wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch.convert import dag_from_wire

TABLE = int_table(2, table_id=801)


def _start(pkg: str) -> dict:
    if pkg == "ref":
        from tikv_tpu import server
        from tikv_tpu.raftstore.metapb import Store
        from tikv_tpu.server.client import BatchCommandsClient
        runner = None
    else:
        from tikv_tpu_torch import server
        from tikv_tpu_torch.device.runner import DeviceRunner
        from tikv_tpu_torch.raftstore.metapb import Store
        from tikv_tpu_torch.server.client import BatchCommandsClient
        runner = DeviceRunner(device="cpu")
    pd_server = server.PdServer("127.0.0.1:0")
    pd_server.start()
    pd_addr = f"127.0.0.1:{pd_server.port}"
    node = server.Node("127.0.0.1:0", server.RemotePdClient(pd_addr),
                       device_runner=runner)
    srv = server.TikvServer(node)
    node.addr = f"127.0.0.1:{srv.port}"
    node.pd.put_store(Store(node.store_id, node.addr))
    srv.start()
    c = server.TxnClient(pd_addr)
    c.txn_write([("put",) + encode_table_row(TABLE, h,
                                             {"c0": h % 10, "c1": h})
                 for h in range(500)])
    return {"pkg": pkg, "pd": pd_server, "srv": srv, "client": c,
            "mux": BatchCommandsClient, "wire": server.wire}


@pytest.fixture(scope="module")
def pair():
    sides = {pkg: _start(pkg) for pkg in ("ref", "port")}
    try:
        yield sides
    finally:
        for side in sides.values():
            close = getattr(side["client"], "close", None)
            if callable(close):
                close()
            side["srv"].stop()
            side["pd"].stop()


def both(pair, fn):
    return fn(pair["ref"]), fn(pair["port"])


def as_side(side, dag):
    return dag if side["pkg"] == "ref" else \
        dag_from_wire(ref_wire.enc_dag(dag))


def _scan_dag(ts):
    return DagSelect.from_table(TABLE, ["id", "c0", "c1"]).build(start_ts=ts)


def test_unary_paging_covers_all_rows_in_bounded_pages(pair):
    def run(side):
        c = side["client"]
        pages = list(c.coprocessor_paged(as_side(side, _scan_dag(c.tso())),
                                         paging_size=120))
        return [(len(p["rows"]), p["is_drained"]) for p in pages], \
            sorted(r[0] for p in pages for r in p["rows"])
    ref, port = both(pair, run)
    assert port == ref
    shape, ids = ref
    assert len(shape) >= 3 and ids == list(range(500))
    assert all(n <= 120 + 1024 and not drained
               for n, drained in shape[:-1]) and shape[-1][1]


def test_paging_with_selection_bounds_result_size(pair):
    def run(side):
        c = side["client"]
        sel = DagSelect.from_table(TABLE, ["id", "c0", "c1"])
        dag = sel.where(sel.col("c0").eq(3)).build(start_ts=c.tso())
        pages = list(c.coprocessor_paged(as_side(side, dag),
                                         paging_size=20))
        return len(pages), [r for p in pages for r in p["rows"]]
    ref, port = both(pair, run)
    assert port == ref
    assert ref[0] >= 2 and len(ref[1]) == 50 and \
        all(r[1] == 3 for r in ref[1])


def test_agg_plan_pages_as_single_final_page(pair):
    def run(side):
        c = side["client"]
        sel = DagSelect.from_table(TABLE, ["id", "c0", "c1"])
        dag = sel.aggregate([sel.col("c0")],
                            [("count_star", None)]).build(start_ts=c.tso())
        pages = list(c.coprocessor_paged(as_side(side, dag), paging_size=5))
        return sorted(r for p in pages for r in p["rows"]), \
            pages[-1]["is_drained"]
    ref, port = both(pair, run)
    assert port == ref
    assert sum(r[0] for r in ref[0]) == 500 and ref[1]


def test_coprocessor_stream_single_snapshot(pair):
    """The stream pins one snapshot: a row written mid-stream is not in
    its later pages."""
    def run(side):
        c = side["client"]
        it = c.coprocessor_stream(as_side(side, _scan_dag(c.tso())),
                                  paging_size=150)
        first = next(it)
        c.txn_write([("put",) + encode_table_row(TABLE, 9000,
                                                 {"c0": 1, "c1": 1})])
        rest = list(it)
        rows = first["rows"] + [r for p in rest for r in p["rows"]]
        return first["is_drained"], len(rest) >= 1, \
            sorted(r[0] for r in rows)
    ref, port = both(pair, run)
    assert port == ref == (False, True, list(range(500)))


def test_batch_commands_mux_serves_kv_and_copr(pair):
    def run(side):
        c = side["client"]
        mux = side["mux"](side["srv"].node.addr)
        try:
            k0, _ = encode_table_row(TABLE, 0, {})
            got = mux.call("KvGet", {"key": k0, "version": c.tso()})
            copr = mux.call("Coprocessor", {
                "tp": 103, "dag": ref_wire.enc_dag(_scan_dag(c.tso()))})
            # error demux: a bad request fails ITS call only
            try:
                mux.call("KvCommit", {"keys": [b"nope"],
                                      "start_version": 1,
                                      "commit_version": 2})
                err = None
            except side["wire"].RemoteError as e:
                err = e.kind
            again = mux.call("KvGet", {"key": k0, "version": c.tso()})
            return got.get("not_found"), len(copr["rows"]) >= 500, err, \
                again.get("not_found")
        finally:
            mux.close()
    ref, port = both(pair, run)
    assert port == ref
    assert ref[0] is False and ref[1] is True and ref[2] is not None and \
        ref[3] is False


def test_batch_commands_mux_concurrent_callers(pair):
    def run(side):
        c = side["client"]
        mux = side["mux"](side["srv"].node.addr)
        try:
            ts = c.tso()
            out = {}

            def worker(i):
                k, _ = encode_table_row(TABLE, i, {})
                out[i] = mux.call("KvGet", {"key": k, "version": ts})

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            return sorted((i, r["value"]) for i, r in out.items())
        finally:
            mux.close()
    ref, port = both(pair, run)
    assert port == ref
    assert len(ref) == 32 and all(v for _i, v in ref)


def test_mux_parked_lock_does_not_block_releasing_commit(pair):
    """A pessimistic-lock wait parked on the mux does not head-of-line
    block the commit, sent on the same mux, that releases it."""
    def run(side):
        c = side["client"]
        mux = side["mux"](side["srv"].node.addr)
        try:
            ts1, ts2 = c.tso(), c.tso()
            mux.call("KvPessimisticLock", {
                "keys": [b"muxlock"], "primary": b"muxlock",
                "start_version": ts1, "for_update_ts": ts1})
            got = {}

            def waiter():
                try:
                    got["r"] = "locked" if mux.call("KvPessimisticLock", {
                        "keys": [b"muxlock"], "primary": b"muxlock",
                        "start_version": ts2, "for_update_ts": ts2,
                        "wait_timeout_s": 8.0}, timeout=15) else None
                except side["wire"].RemoteError as e:
                    # woken by the commit, then the conflict check saw
                    # the newer commit: either way not starved
                    got["r"] = e.kind

            t = threading.Thread(target=waiter)
            t.start()
            time.sleep(0.2)             # the waiter parks server-side
            mux.call("KvPrewrite", {
                "mutations": [{"op": "put", "key": b"muxlock",
                               "value": b"v"}],
                "primary": b"muxlock", "start_version": ts1,
                "is_pessimistic_lock": [True]})
            mux.call("KvCommit", {"keys": [b"muxlock"],
                                  "start_version": ts1,
                                  "commit_version": c.tso()})
            t.join(12)
            return t.is_alive(), got.get("r")
        finally:
            mux.close()
    ref, port = both(pair, run)
    assert port == ref
    assert ref[0] is False and ref[1] in ("locked", "write_conflict")
