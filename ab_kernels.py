"""Time the merges, the selection kernels and the row patch at their main
path's shapes in the checkout this runs from, for an A/B comparison of two
checkouts on one card.

Build both checkouts first, in parallel (``--build`` compiles the sources
the timings launch, one ``nvcc`` each, all started together), then run it
from the root of each checkout in one call on the card, alternating
(A, B, B, A), so both see the same card and host:

    python3 ab_kernels.py --build          # in each checkout, together
    python3 ab_kernels.py A [SECTION ...]  # in checkout A
    python3 ab_kernels.py B [SECTION ...]  # in checkout B

SECTION is any of ``merges``, ``selection`` and ``patches`` (all three
when none is named).  It prints one line, ``AB {json}``, of CUDA-event
means, queued behind a device sleep (``chip_smoke.queued_ms``; at most 50
calls a timing where a call makes several device operations, so the
queue behind the sleep stays short) unless a key says "issued":

- merges: ``shard_psum`` at m4's shape (4 × 2,052 int64 words) and m4n's
  (4 × 9,217), ``shard_bucket_merge`` at m4x's (4 × a MIN and a MAX row of
  1,026 words); m4x's whole merge as the checkout's runner makes it (one
  ``shard_merge`` of the summed words and both rows where the checkout
  has it, else ``shard_psum`` then ``shard_bucket_merge``); the chains:
  four elementwise kernels over a quarter of config 4's rows each (the
  per-shard kernels' stand-in), then ``shard_psum`` at m4's shape, or
  m4x's whole merge, and the four alone: each merge's marginal time;
- selection: ``sel_mask`` at config 2's shape (10,485,760 bools, 20%
  true), as the route calls it after ``torch.gt`` and alone, and
  ``sel_pred`` of ``v > 800`` at config 2's shape (the neighbour that
  shares the mask layout);
- patches: the patch of one int32 plane, 2 rows with digests; of three
  planes (int32, int64, bool), 2 rows with digests; of 65,536 rows with
  and without digests: where the checkout has ``patch_feed_rows`` its
  public calls (positions on the host, values on the card), else its
  ``_patch_rows_cuda`` with positions and values on the card (memset and
  launch: what its public call queues after its own uploads);
  ``DeviceRunner._patch_plane`` of 2 rows as issued (both checkouts) and
  queued (where it does not wait for the host); ``patch_rows`` of 65,536
  rows with digests as issued (each checkout's uploads of positions from
  the host included); a spill-shaped patch (9,177 rows of three planes
  from host values): one ``patch_feed_rows`` call, and three
  ``patch_rows`` calls, host clock to the card's end, median of 20; the
  mint's ``patch`` phase (host clock) in ``check_spill``'s spill case,
  three mints.

Needs one CUDA card.
"""

import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from tikv_tpu_torch.device import DeviceRunner  # noqa: E402
from tikv_tpu_torch.device import build  # noqa: E402
from tikv_tpu_torch.device import digest as dg  # noqa: E402
from tikv_tpu_torch.device import shard as sh  # noqa: E402


def merges(dev, out: dict) -> None:
    g = torch.Generator(device=dev).manual_seed(5)

    def words(S, W):
        return [torch.randint(-1 << 40, 1 << 40, (W,), generator=g,
                              device=dev) for _ in range(S)]

    for cell, W in (("m4", 2052), ("m4n", 9217)):
        parts = words(4, W)
        res = parts[0].clone()
        out[f"shard_psum {cell} ms"] = cs.queued_ms(
            lambda: sh.shard_psum(parts, None, out=res), 200)
    # m4x's fold buffer: the flag, COUNT(*) and SUM(v) rows summed, then
    # the MIN and MAX rows
    parts = words(4, 1 + 4 * 1026)
    sums = [(0, 1 + 2 * 1026, "sum_i64")]
    segs = [(1 + 2 * 1026, 1026, "min_i64"), (1 + 3 * 1026, 1026, "max_i64")]
    res = parts[0].clone()
    out["shard_bucket_merge m4x ms"] = cs.queued_ms(
        lambda: sh.shard_bucket_merge(parts, segs, out=res), 200)
    one = hasattr(sh, "shard_merge")

    def m4x_merge():
        if one:
            sh.shard_merge(parts, sums + segs, out=res)
        else:
            sh.shard_psum(parts, sums, out=res)
            sh.shard_bucket_merge(parts, segs, out=res)

    out["m4x merge launches"] = 1 if one else 2
    out["m4x merge ms"] = cs.queued_ms(m4x_merge, 200)
    out["m4x psum alone ms"] = cs.queued_ms(
        lambda: sh.shard_psum(parts, sums, out=res), 200)
    # the chains: four kernels of a quarter of config 4's rows each
    rows = torch.randint(0, 1000, (4, 26_214_400), dtype=torch.int32,
                         device=dev)
    sink = torch.empty_like(rows)
    psum_parts = words(4, 2052)
    psum_res = psum_parts[0].clone()

    def shards():
        for i in range(4):
            torch.add(rows[i], 1, out=sink[i])

    def chain():
        shards()
        sh.shard_psum(psum_parts, None, out=psum_res)

    def chain_m4x():
        shards()
        m4x_merge()

    def chain_m4x_psum():
        shards()
        sh.shard_psum(parts, sums, out=res)

    got = {"shards": [], "chain": [], "m4x": [], "m4x psum": []}
    for _ in range(3):
        got["shards"].append(cs.queued_ms(shards, 50))
        got["chain"].append(cs.queued_ms(chain, 50))
        got["m4x"].append(cs.queued_ms(chain_m4x, 50))
        got["m4x psum"].append(cs.queued_ms(chain_m4x_psum, 50))
    med = {k: float(np.median(v)) for k, v in got.items()}
    out["chain shards ms"] = med["shards"]
    out["chain ms"] = med["chain"]
    out["chain psum marginal ms"] = med["chain"] - med["shards"]
    out["chain m4x merge marginal ms"] = med["m4x"] - med["shards"]
    out["chain m4x psum alone marginal ms"] = \
        med["m4x psum"] - med["shards"]


def selection(dev, out: dict) -> None:
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    n = 10 << 20
    g = torch.Generator(device=dev).manual_seed(7)
    v = torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32,
                      device=dev)
    pred = v > 800
    got = sm.sel_mask(pred, n)
    assert cs.mask_equal(got, sm.sel_mask_plain(pred, n))
    out["sel_mask config 2 ms"] = cs.queued_ms(lambda: sm.sel_mask(pred, n),
                                               200)
    out["gt then sel_mask config 2 ms"] = cs.queued_ms(
        lambda: sm.sel_mask(v > 800, n), 200)
    out["gt alone config 2 ms"] = cs.queued_ms(lambda: v > 800, 200)
    prog = sm.encode_predicate(
        [build_rpn(Expr.column(0) > Expr.const(800, EvalType.INT))],
        [torch.int32])
    out["sel_pred config 2 ms"] = cs.queued_ms(
        lambda: sm.sel_pred(prog, [(v, None)], n, False), 100)


def patches(dev, out: dict) -> None:
    new = hasattr(dg, "patch_feed_rows")
    n = 1 << 24
    plane = torch.randint(-1 << 30, 1 << 30, (n,), dtype=torch.int32,
                          device=dev)
    three = [plane, torch.zeros(n, dtype=torch.int64, device=dev),
             torch.zeros(n, dtype=torch.bool, device=dev)]
    pos = np.array([0, n - 1], np.int64)
    pos_d = torch.from_numpy(pos).to(dev)

    def one(a, p, p_d, v, digest):
        if new:
            return dg.patch_rows(a, p, v, digest=digest)
        return dg._patch_rows_cuda(a, p_d, v, digest)

    v2 = [a[:2].clone() for a in three]
    out["patch 1 plane 2 rows digests ms"] = cs.queued_ms(
        lambda: one(plane, pos, pos_d, v2[0], True), 50)
    if new:
        out["patch 3 planes 2 rows digests ms"] = cs.queued_ms(
            lambda: dg.patch_feed_rows(three, pos, v2, [0, 0, 0]), 50)
    out["patch 3 planes as 3 calls ms"] = cs.queued_ms(
        lambda: [one(a, pos, pos_d, v, True) for a, v in zip(three, v2)],
        50)
    big_d = torch.randperm(n, device=dev)[:1 << 16].sort().values
    big = big_d.cpu().numpy()
    vb = plane[big_d].clone()
    for digest in (True, False):
        out[f"patch 65536 rows{' digests' if digest else ''} ms"] = \
            cs.queued_ms(lambda: one(plane, big, big_d, vb, digest), 50)
    # the public call as issued: positions from the host, each checkout's
    # own uploads included
    out["patch_rows 65536 rows digests issued ms"] = cs.cuda_ms(
        lambda: dg.patch_rows(plane, big, vb, digest=True), 20)
    # a spill-shaped patch of three planes from host values (9,177 rows,
    # the check_spill case): host clock a call, synchronized, median of 20
    rows = np.sort(np.random.default_rng(3).choice(n, 9177, replace=False))
    cells = [np.random.default_rng(4).integers(0, 1000, 9177).astype(
        np.int32), np.ones(9177, np.int32), np.ones(9177, np.bool_)]
    spill = [plane, plane.clone(), three[2]]

    def host_ms(fn):
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    if new:
        out["spill patch 3 planes host ms"] = host_ms(
            lambda: dg.patch_feed_rows(spill, rows, cells))
    out["spill patch as 3 calls host ms"] = host_ms(lambda: [
        dg.patch_rows(a, rows, torch.from_numpy(c))
        for a, c in zip(spill, cells)])
    runner = DeviceRunner()
    feed = {"flat": (plane,), "digests": (12345,)}
    ends = plane[[0, n - 1]].clone()
    if hasattr(dg, "patch_feed_spans"):   # the span form: two 1-row spans
        def patch_plane():
            runner._patch_plane(feed, [(0, 1), (n - 1, n)], [ends])
    else:
        def patch_plane():
            runner._patch_plane(feed, 0, [0, n - 1], ends)
    out["_patch_plane issued ms"] = cs.cuda_ms(patch_plane, 50)
    if new:
        out["_patch_plane ms"] = cs.queued_ms(patch_plane, 50)
    phases = []
    for _ in range(3):
        cs.check_spill(runner, dev)
        phases.append(runner.mvcc_resolver().phases_ms["patch"])
    out["mint patch phase host ms"] = phases


SECTIONS = {"merges": merges, "selection": selection, "patches": patches}
# the sources each section launches (a checkout lacking one, such as
# sel_mask before it had its own, builds what it has)
SOURCES = {"merges": ("shard_merge",),
           "selection": ("selection", "sel_mask"),
           "patches": ("digest", "mvcc")}


def build_all() -> None:
    from concurrent.futures import ThreadPoolExecutor
    names = [n for src in SOURCES.values() for n in src
             if n in build.SOURCES]
    with ThreadPoolExecutor(len(names)) as pool:
        for name, _log in zip(names, pool.map(build.build, names)):
            print(f"built {name}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--build"]:
        build_all()
        return 0
    label = sys.argv[1] if len(sys.argv) > 1 else "."
    wanted = sys.argv[2:] or list(SECTIONS)
    for name in wanted:
        for src in SOURCES[name]:
            if src in build.SOURCES:
                build.build(src)
    dev = torch.device("cuda", 0)
    out = {"checkout": label}
    for name in wanted:
        SECTIONS[name](dev, out)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
