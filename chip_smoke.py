#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tikv_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernel from ``tikv_tpu_torch/csrc`` (timed);
3. every kernel against its plain PyTorch version on the card, exactly
   (integer states), over the edge cases of the CPU tests and at 2^24 rows;
4. the aggregation path through ``DeviceRunner().handle_request`` for
   configs 3 (50·2^20 rows), 4 (100·2^20 rows) and 4s (2^24 rows: its
   extra cost over config 4 is the host ``np.unique`` recode), each request
   wire-encoded first, each answer held exactly against a numpy truth:
   one cold and five warm requests, with the kernel launch count read
   around the run (it must be > 0);
5. the kernel against its plain version at each config's main-path
   shape (exactly) and timed there with CUDA events, beside one library
   call that computes the same sums (a yardstick the port never calls);
6. one JSON line listing every ported kernel: launches on the main path,
   largest difference from the plain version, kernel / plain / library
   times at config 4's shape, and the least time the card could take;
7. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit peak


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(dev, big: int):
    """(name, hash_agg keyword arguments) pairs on the card."""
    from tikv_tpu_torch.device.hash_agg import Lane
    g = torch.Generator(device="cpu").manual_seed(11)
    B = 1 << 18

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)

    def bools(p, n):
        return (torch.rand(n, generator=g) < p).to(dev)

    k, v = ints(0, 1000, B), ints(-1000, 1000, B)
    dense = dict(mode="dense", n=B, slots=1026, n_slots=1024, key=k,
                 base=0, capacity=1024)
    yield "dense", dict(dense, lanes=[Lane(values=v)])
    yield "dense_expr_key", dict(
        dense, n_slots=1025, key=ints(-3, 1003, B), key_ok=bools(0.9, B),
        base=-3, mask=bools(0.7, B),
        lanes=[Lane(values=v, ok=bools(0.8, B)), Lane(ok=bools(0.5, B))])
    yield "sparse", dict(mode="sparse", n=B, slots=1026, n_slots=1025,
                         key=ints(0, 1026, B), capacity=1024,
                         lanes=[Lane(values=v)])
    yield "simple", dict(mode="simple", n=B, slots=1, n_slots=1,
                         lanes=[Lane(values=v), Lane(values=v,
                                                     ok=bools(0.5, B)),
                                Lane(ok=bools(0.3, B))])
    yield "selection_keeps_nothing", dict(
        dense, mask=torch.zeros(B, dtype=torch.bool, device=dev),
        lanes=[Lane(values=v)])
    yield "ragged_n", dict(dense, n=B - 12345, lanes=[Lane(values=v)])
    edge = torch.tensor([2**31 - 1, -(2**31 - 1)], dtype=torch.int32,
                        device=dev)
    yield "int32_extremes", dict(
        dense, lanes=[Lane(values=edge[ints(0, 2, B).long()])])
    yield "count_sum_avg", dict(
        dense, mask=bools(0.5, B),
        lanes=[Lane(ok=bools(0.6, B)), Lane(values=v, ok=bools(0.6, B)),
               Lane(values=ints(-5, 5, B))])
    yield "4096_slots_split_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096,
        lanes=[Lane(values=ints(-100, 100, B), ok=bools(0.5, B))
               for _ in range(6)])
    kb, vb = ints(0, 1024, big), ints(-1000, 1000, big)
    yield f"dense_{big}_rows", dict(mode="dense", n=big, slots=1026,
                                    n_slots=1024, key=kb, base=0,
                                    capacity=1024, lanes=[Lane(values=vb)])


def max_abs_diff(got, want) -> int:
    (c1, o1), (c2, o2) = got, want
    worst = int((c1 - c2).abs().max())
    for a, b in zip(o1, o2):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                worst = max(worst, int((x - y).abs().max()))
    return worst


def check_kernels(dev, big: int) -> int:
    from tikv_tpu_torch.device import hash_agg as ha
    worst = 0
    for name, kw in kernel_cases(dev, big):
        got = ha.hash_agg(device=dev, **kw)
        torch.cuda.synchronize()
        want = ha.hash_agg_plain(device=dev, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        print(f"kernel hash_agg {name}: max_abs_err={err}", flush=True)
        assert err == 0, f"hash_agg {name} disagrees with its plain version"
        worst = max(worst, err)
    return worst


def truth_rows(config: str, snap) -> list:
    """The exact answer, from numpy alone."""
    k = snap.columns[2].values
    v = snap.columns[3].values
    if config == "3":
        s = int(v.sum())
        return [(s, len(v), float(s) / len(v))]
    keys, inv = np.unique(k, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(keys))
    sums = np.bincount(inv, weights=v, minlength=len(keys))
    assert np.abs(sums).max() < 2**53      # float64 sums are exact here
    return [(int(c), int(s), int(key))
            for c, s, key in zip(cnt, sums.astype(np.int64), keys)]


def run_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.testing import configs as cf

    build = cf.build_sparse_table if config == "4s" else cf.build_table
    table, snap = build(n)
    make = cf.dag_simple_agg if config == "3" else cf.dag_hash_agg
    dag = dag_from_wire(enc_dag(make(table)))
    want = truth_rows(config, snap)

    ha.launches = 0
    t0 = time.perf_counter()
    rows = runner.handle_request(dag, snap).rows()
    cold = time.perf_counter() - t0
    assert rows == want, f"config {config}: wrong answer on the cold request"
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        rows = runner.handle_request(dag, snap).rows()
        warm.append(time.perf_counter() - t0)
        assert rows == want, f"config {config}: wrong answer when warm"
    launches = ha.launches
    assert launches > 0, f"config {config} never launched hash_agg"
    p50 = float(np.percentile(warm, 50))
    out = {"config": config, "rows": n, "cold_ms": cold * 1e3,
           "warm_p50_ms": p50 * 1e3, "rows_per_s": n / p50,
           "launches": launches, "groups": len(want)}
    note = " (4s at 2^24 rows: its extra cost is the host np.unique " \
        "recode)" if config == "4s" else ""
    print(f"config {config}: " + " ".join(f"{k}={v}" for k, v in out.items()
                                          if k != "config") + note,
          flush=True)
    profile_request(config, runner, dag, snap)
    del snap
    gc.collect()
    return out


def profile_request(config: str, runner, dag, snap) -> None:
    """One warm request under torch.profiler: device time by kernel and
    the device's idle share of the (profiled) request wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.handle_request(dag, snap)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile config {config}: wall_ms={wall_ms} device_ms={dev_ms} "
          f"idle_share={1 - dev_ms / wall_ms} top=" + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3}ms"
              for e in top), flush=True)


def main_path_inputs(config: str, n: int, dev) -> dict:
    """hash_agg's arguments exactly as the runner builds them for one
    config: the int32 feed planes, the slot layout and one lane per
    SUM/AVG (config 3's SUM(v) and AVG(v) are two lanes over one plane)."""
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.testing import configs as cf
    build = cf.build_sparse_table if config == "4s" else cf.build_table
    _table, snap = build(n)
    v = torch.from_numpy(snap.columns[3].values.astype(np.int32)).to(dev)
    kw = dict(n=n, device=dev)
    if config == "3":
        kw.update(mode="simple", slots=1, n_slots=1,
                  lanes=[ha.Lane(values=v), ha.Lane(values=v)])
    elif config == "4":
        k = torch.from_numpy(snap.columns[2].values.astype(np.int32))
        kw.update(mode="dense", slots=1026, n_slots=1024, key=k.to(dev),
                  base=0, capacity=1024, lanes=[ha.Lane(values=v)])
    else:
        _uniq, inv = np.unique(snap.columns[2].values, return_inverse=True)
        kw.update(mode="sparse", slots=1026, n_slots=1025, capacity=1024,
                  key=torch.from_numpy(inv.astype(np.int32)).to(dev),
                  lanes=[ha.Lane(values=v)])
    return kw


def kernel_at_main_shapes(dev, sizes: dict) -> tuple:
    """The kernel against its plain version (exact) and timed, at each
    config's main-path shape; → (largest difference, config 4 timing)."""
    from tikv_tpu_torch.device import hash_agg as ha
    worst, timing = 0, None
    for config in ("3", "4", "4s"):
        n = sizes[config]
        kw = main_path_inputs(config, n, dev)
        saved = ha.launches
        err = max_abs_diff(ha.hash_agg(**kw), ha.hash_agg_plain(**kw))
        assert err == 0, f"hash_agg disagrees with its plain version " \
            f"at config {config}'s shape"
        worst = max(worst, err)
        ms = cuda_ms(lambda: ha.hash_agg(**kw), 20)
        ha.launches = saved             # measurement launches do not count
        plain_ms = cuda_ms(lambda: ha.hash_agg_plain(**kw), 3)
        # inputs read once (config 3's two lanes share one plane), states
        # written once; ops: slot, count add, one add per lane
        planes = 1 if config == "3" else 2
        lanes = len(kw["lanes"])
        bytes_moved = 4 * n * planes + 8 * kw["slots"] * (1 + lanes)
        ops = n * (2 + lanes)
        b_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        b_ops = ops / SCALAR_OPS_PER_S * 1e3
        out = {"ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(b_bytes, b_ops),
               "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        # yardstick only (the port never calls it): one library call over
        # the same values: an int64 sum (config 3; its COUNT is n), or a
        # scatter-add into the 1026 int64 slots by key or slot id
        v = kw["lanes"][0].values
        if config == "3":
            out["library_ms"] = cuda_ms(
                lambda: torch.sum(v, dtype=torch.int64), 20)
        else:
            slots64, v64 = kw["key"].to(torch.int64), v.to(torch.int64)
            out["library_ms"] = cuda_ms(lambda: torch.zeros(
                1026, dtype=torch.int64, device=dev).index_add_(
                    0, slots64, v64), 10)
            del slots64, v64
        if config == "4":
            timing = out
        print(f"kernel hash_agg at config {config} shape ({n} rows): "
              f"max_abs_err={err} tolerance=0 (integer states) " +
              " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
        del kw, v
        gc.collect()
    return worst, timing


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tikv_tpu_torch.device import DeviceRunner, build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    log = build.build("hash_agg")
    print(f"build: hash_agg in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"ptxas hash_agg: {line.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    sizes = {"3": 50 << 20, "4": 100 << 20, "4s": 1 << 24}
    worst = check_kernels(dev, 1 << 24)

    runner = DeviceRunner()
    runs = [run_config(c, sizes[c], runner) for c in ("3", "4", "4s")]
    launches = sum(r["launches"] for r in runs)
    err, timing = kernel_at_main_shapes(dev, sizes)
    worst = max(worst, err)

    kernels = [{"name": "hash_agg", "route": "cuda",
                "source": "tikv_tpu_torch/csrc/hash_agg.cu",
                "replaces": "tikv_tpu/device/pallas_hash.py:199",
                "launches": launches, "max_abs_err": worst, **timing}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
