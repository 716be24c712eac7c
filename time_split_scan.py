"""Time the split checker's pass over one region on the host, in the
checkout this runs from: ``RaftStore._scan_region`` (one bulk read of the
region's data CFs, the bytes counted, the split-key candidates ordered),
then ``find_split_key`` and ``_bucket_bounds`` over the same scan.

The region is cell srv's: 6c's table (``c0 = h % 1024``, ``c1 = h %
1000``) at ``--keys`` keys (10·2^20 by default), built as SST v2 blobs of
2^20 keys by ``fast_mvcc_table_sst`` and ingested into a ``MemoryEngine``.
It needs no card.  To compare two checkouts, run it from the root of
each in one command, alternating (A, B, B, A), so both see the same host:

    python3 time_split_scan.py [--keys N] [--repeat R]

It prints one line, ``SCAN {json}``: the region's bytes and candidates,
the split key and bucket count (equal across checkouts), the seconds of
each repeat of the scan and of the key and bounds, and the host RSS.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) << 10 for line in f
                    if line.startswith("VmRSS:"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=10 << 20)
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()

    from tikv_tpu_torch.codec.keys import data_key
    from tikv_tpu_torch.engine.memory import MemoryEngine
    from tikv_tpu_torch.raftstore import Region
    from tikv_tpu_torch.raftstore.store import RaftStore
    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst, read_sst_cf
    from tikv_tpu_torch.testing import mvcc as tm

    tid = tm.table_6c().table_id
    engine = MemoryEngine()
    t0 = time.perf_counter()
    for lo in range(0, args.keys, args.chunk):
        h = np.arange(lo, min(lo + args.chunk, args.keys), dtype=np.int64)
        blob = fast_mvcc_table_sst(tid, h, [(2, h % 1024, None),
                                            (3, h % 1000, None)], 100)
        wb = engine.write_batch()
        for cf, (keys, vals) in read_sst_cf(blob).items():
            wb.ingest_cf(cf, [data_key(k) for k in keys], vals)
        engine.write(wb)
        del blob, wb
    load_s = time.perf_counter() - t0

    store = RaftStore(1, engine, None)
    peer = types.SimpleNamespace(region=Region(1))
    scan_s, split_s = [], []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        size, entries = store._scan_region(peer)
        t1 = time.perf_counter()
        key = store.find_split_key(peer, entries)
        bounds = store._bucket_bounds(entries)
        split_s.append(time.perf_counter() - t1)
        scan_s.append(t1 - t0)
        rss = rss_bytes()
        del entries
    print("SCAN " + json.dumps({
        "keys": args.keys, "load_s": load_s, "region_bytes": size,
        "split_key": key.hex(), "buckets": len(bounds),
        "scan_s": scan_s, "split_key_and_bounds_s": split_s,
        "host_rss_bytes": rss}), flush=True)


if __name__ == "__main__":
    main()
