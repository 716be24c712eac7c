#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tikv_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``tikv_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together; timed, with the ptxas report and the shared
   atomics in ``hash_agg``'s and ``agg_fold``'s SASS — none a float64
   compare-and-swap loop in ``agg_fold``'s integer shared route);
3. every kernel against its plain PyTorch version on the card over the
   edge cases of the CPU tests: ``hash_agg`` exactly (integer states) in
   both cell formats, at 2^24 rows, on one hot slot over 2^24 rows at the
   int32 (packed cells) and int16 (split cells) extremes, with repeated
   lanes and validity planes, planes 1-3 rows off a 16-byte boundary (at
   one phase or at several), ``n`` not a multiple of 4, and 4096 slots over
   several launches; ``twolevel`` exactly for its int8 planes and within
   1e-9·Σ|v| per cell for its float planes (float64 sums in another
   order) through both entries: the fused entry over raw columns (int32,
   int64 and sparse keys, NULL keys, no / partial / all-false selection,
   1-4 and 8 byte planes with their extremes, REAL lanes, aliased
   validity, 4n's repeated planes, the overflow flag) at slot counts that
   take each of its routes (1026: shared, 65,538: cluster, 2^20 + 2:
   global; the route is printed, and each must be taken), with a hot slot
   past the per-table row cap; and the planes entry, also at the shapes of
   the Pallas prototypes it replaces, with each prototype's own check
   (count by ``bincount``, sum rebuilt with the prototype's bias formula,
   against numpy);
4. the aggregation path through ``DeviceRunner().handle_request`` for
   eight configurations (``tikv_tpu_torch.testing.configs``): 3
   (50·2^20 rows), 4, 4n and 4w (100·2^20 rows), and 4s, 4r, 4m and 3n
   (2^24 rows), each request wire-encoded first, each answer held against
   a numpy truth (exactly for integer and MIN/MAX results, within 1e-9 of
   the error scale of ``configs.truth`` for REAL sums and variances): one
   cold and five warm requests, the kernels' launch counts read around
   the run (each config must launch the kernels of its route and no
   other), the peak device memory of one more warm request beyond what
   was resident before it, and one profiled warm request (traced again
   until the trace holds the route's kernels); for 3, 4 and 4s
   one line of host-clock phases of a warm request (analyze, inputs,
   launch, D2H wait, finalize);
5. each kernel against its plain version at the main path's shapes, and
   timed there with CUDA events beside its bound and one library call
   that computes the same function (a yardstick the port never calls):
   ``hash_agg`` at configs 3, 4 and 4s (4 and 4s also with packed cells);
   ``twolevel``'s fused entry at 4n, 4w and 4r on the runner's own
   arguments, also beside the planes path it replaced (``slot_index`` +
   ``make_planes`` + the planes kernel, on the same inputs), with the
   peak device memory of each, and on every route its table can take;
6. the selection and top-k kernels against their plain versions on the
   card, exactly (every output is an integer or a copied element):
   ``sel_pred`` (random predicates nested two or three deep over
   NULL-bearing int32 — with its extremes —, int64 and float32 planes,
   narrowed by the columns' bounds and not, at ragged sizes, on and off a
   16-byte boundary, with and without the bool mask; and the predicates of
   configs 1, 2, 2s and 5t at 10·2^20 rows), ``sel_mask`` (n not a multiple of 8, one and many blocks, all-false and
   all-true masks, a mask off a 16-byte boundary, config 2's 10·2^20
   rows), ``sel_compact`` in index mode (capacity above and below the
   count: the overflow flag) and in planes mode (int32, int64, float64 and
   bool planes), ``topn_select`` (DESC and ASC, int32, int64 and float64
   keys, NULLs first and last, a selection inside, a limit beyond the live
   rows, 10·2^20 tied keys and 10·2^20 NULL keys, the int64 extremes, -0.0
   beside 0.0, n not a multiple of the segment, config 5's 100·2^20 rows,
   a crossing bin of exactly the candidate buffer's rows and one row more,
   narrow int32 keys with and without their bounds, misaligned planes; the
   route each case takes equals ``topn.plan_route``'s, and both the common
   and the overflow route are taken), and ``agg_fold`` (every state kind
   over int32, int64, float32 and float64 values with NULLs, no / partial /
   all-false selections, dense keys with NULL keys, sparse slot ids and
   the simple mode with FIRST, at 1026, 65,538 and 2^20 + 2 slots, lanes
   sharing a values plane, an int64 key, the overflow flag, hot slots over
   2^24 rows at the int32 extremes, value bounds that shrink the shared
   cells (|v| <= 300 and 1000, and 2^31), n not a multiple of 4, planes 1-3
   elements off a 16-byte boundary; integer, MIN/MAX and FIRST states
   exactly, float64 sums within 1e-9·Σ|v| per cell, FIRST also where the
   first selected row is NULL and whole warps' selected rows are NULL; the
   route of each case is printed and every route, shared, global and
   registers, is taken);
7. the selection, top-k and index-scan routes through
   ``DeviceRunner().handle_request`` (``configs.ROW_CONFIGS``): configs 1
   (its probe over 2^20 rows), 2 (10·2^20), 5 (an IndexScan, 100·2^20) and
   5t (100·2^20), and config 2s (10·2^20 rows at 0.1%, 1%, 10% and 50%
   selected, which must take the compact, index, mask and mask routes),
   each request's selection through ``sel_pred`` (its predicate route
   counted per request), and config 2's table under a predicate outside
   ``sel_pred``'s signatures (``v DIV 3 > 266``: the torch route, then
   ``sel_mask``), each answer held exactly against a numpy truth, with the
   same cold / warm / peak / profile / launch-count lines as step 4 and a
   line of host-clock phases of a warm request (``row_phases``);
8. each of those kernels timed at the main path's shapes beside its
   bound, its plain version and a library yardstick the port never calls:
   ``sel_pred`` at config 2 (``v > 800``, packed mask) and 5t (``k <
   512`` over 100·2^20 rows, the bool mask too) beside the torch
   comparison alone, ``sel_mask`` at config 2 (``torch.count_nonzero``),
   ``sel_compact`` at
   config 2s's 1% (index mode) and 0.1% (planes mode) (``torch.nonzero``),
   ``topn_select`` at configs 5 and 5t (``torch.topk`` on the (segments,
   segment length) view), with its route and its reads of the order plane
   per row (and at config 5 the overflow route's time on the same
   inputs); ``agg_fold`` at configs 4m and 3n on the runner's own
   arguments, with its route and peak bytes (no single PyTorch call
   computes the fold: one ``scatter_reduce_`` (amax) over the same keys
   and values is the yardstick);
9. the cold MVCC path: ``plane_digest`` and ``patch_rows`` against their
   plain versions over every feed dtype (and int8, int16), the digest
   over full and partial ranges of planes 0-7 elements off a 16-byte
   boundary up to 2^24 + 3 rows, the patch at 1, 1000 and 65,536 rows
   with and without digests; ``mvcc_resolve`` against its plain version
   over the CPU tests' histories (deletes, rollbacks, locks, versions
   above read_ts, NULLs, INT, REAL and unsigned columns, every key
   deleted, an empty result, two versions of a key at one commit_ts, a
   key of 50,000 versions among short keys, a run of keys of 300 versions
   each, tiles at the kernel's shared budget of versions and one past
   it), a schema of 100 output planes, 2^20 keys, and the same planes
   resident in padded ``DeviceVersionPlanes`` buffers — all bit for bit; a mint
   with CF_DEFAULT spill rows (``patch_rows`` in the mint) against the
   upload of its host mirror; then configs 6c (10·2^20 keys, one PUT a
   key) and 4h (100·2^20 keys, a chosen version mix at about 1.15
   versions a key; ``tikv_tpu_torch/testing/mvcc.py``) through
   ``build_region_columnar_device`` and ``DeviceRunner().handle_request``:
   cold + 5 warm requests from a feed minted by ``mvcc_resolve``
   (``feed_routes`` {device_resolve: 1}), each answer against the
   generator's truth, then the scrub — clean, kept clean by a
   ``_patch_plane`` and its undo, and naming the plane
   ``corrupt_resident_plane`` flipped — with the kernels' launch counts
   read around that main path (``mvcc_resolve``, ``plane_digest`` and
   ``patch_rows`` must each launch); then two rounds of the device,
   upload and resident routes (the planes in ``DeviceVersionPlanes``,
   filled in chunks of 2^20 keys), the second in reverse order, each
   route a fresh snapshot by ``build_region_columnar_device``, every feed
   bit-equal to the main path's and that one to the plain version; cold
   ms by phase for each route in each round; and the three kernels timed
   at this shape beside their bounds, plain versions and yardsticks;
10. the plan IR: ``sort_perm`` and ``join_build`` (``csrc/sort.cu``),
   ``join_probe`` (``csrc/join.cu``) and ``window_scan``
   (``csrc/window.cu``) against their plain versions, bit for bit: one to
   eight keys over the int64 extremes, ties, float64 with ±0.0, ±inf and
   NaN, byte and constant keys, keys that pack into 31, 32, 33, 64 and 65
   bits (one or two packed images), n = 1, 2, 2049, 4095-4097, 12,289
   (a last tile of one row), 100,003 and 10·2^20; the build dictionary
   with NULL keys, duplicates, keys equal to
   the int64.max sentinel and rows past n_live; the probe on both routes
   (``join_index``'s direct index of dense build keys, held against its
   plain version, and the search of sparse ones) with NULL keys on both
   sides, with and without a mask, at a capacity above and below the total
   (the exact total beside the pairs that fit), over dense keys with gaps,
   duplicates, one hot build key, a negative least key, keys at int64.min
   and int64.max − 1, a valid int64.max build key and a span one past the
   threshold (both the sparse route) and a span at it; the window over
   int64 and float64 partition keys (NaN, -0.0), none, one partition over
   every row, a partition on each row, counts, int64 sums, LAG / LEAD of
   int64 and float64 within the kernel's halo and past it (±100, ±5000),
   n around its tile (1279-1281) and at 10·2^20; then config 7 (a 10·2^20-row
   probe table against 2^20 build rows, ``bench.py:243-312``, seed 11:
   ``WHERE v > 0``, inner join on ``k = bk``, ``GROUP BY w``) and its
   cells 7s (``ORDER BY k DESC, v ASC``) and 7w (``PARTITION BY k ORDER
   BY v``: row_number, count, sum, avg, lag 2, lead 1) through
   ``Endpoint.handle_plan(force_backend="device")``, each plan
   wire-encoded first: cold + 5 warm, each answer against a numpy truth,
   the device join counted in ``join_backends``, no degrade, the kernels
   of each cell launched and no other (config 7: ``join_build`` and
   ``join_index`` once, then the cache; ``join_probe`` (the dense route)
   and ``sel_pred`` six times), with the host-clock phases of the cold and
   the median warm request; and the five kernels timed at those shapes
   beside their bounds, plain versions and, for the sorts, composed
   ``torch.argsort(stable=True)`` (and for ``sort_perm`` one
   ``torch.argsort(stable=True)`` over the packed int64 image, packed
   outside the timing), for ``join_index`` one ``torch.searchsorted`` of
   the span's keys, for ``join_probe`` two (left and right) of the probe
   keys, which compute the runs but not the pairs; ``join_probe`` on both
   routes (config 7's dense build, and its keys spread by 2^20), its bound
   counting the -1 fill up to k_cap, printed beside the count without
   it;
11. ANALYZE and CHECKSUM: ``analyze_column`` (``csrc/analyze.cu``, whose
   radix pass is ``csrc/onesweep.cuh``'s, shared with ``sort_perm`` and
   ``join_build``: step 10 holds both to their plain versions) against its
   plain version on the card over the CPU tests' edge cases of every
   device dtype (int32, int64, uint32, uint64, float64: NULLs, NaN, −NaN,
   ±0.0, ±inf, the dtype's max, all NULL, one valid row, fewer valid rows
   than buckets, one bucket, one row, ties, padding rows marked valid), n
   around the pass tiles, float64 specials, a full-span int64 column, keys
   of 32 and 33 bits, one value, uint64 past 2^63, 2^20 and 2^22 rows:
   rank words, n_valid and distinct counts bit for bit, the bounds the
   unpacking keeps by value; then the cells an4 and an4n (config 4's and
   4n's tables, 100·2^20 rows), an4s and an4r (2^24 rows) and an6c
   (config 6c's cold-minted snapshot after its rounds, 10·2^20 keys), each
   every column at 256 buckets through ``Endpoint.handle_analyze``: cold +
   5 warm, each answer equal to the numpy truth, ``analyze`` launched once
   per column and request and no other kernel, no degrade, the host-clock
   phases of the cold and the median warm request; CHECKSUM over 2^16
   rows (the crc64-xz check value, the fold in another order, two
   replicas, a partial range); and ``analyze`` timed at an4's id, k and v,
   an4s's k and an4r's v as issued and its kernels alone, beside its
   bound, plain version and one ``torch.sort`` of the sentinelled column;
12. the serving path: ``sel_pred_batched`` (``csrc/selection.cu``)
   against its plain version (the whole buffer, bit for bit) and against G
   solo ``sel_pred`` launches (each lane's count and packed mask), over G
   of 1, 2, 3, 16 and the lane limit, random programs, int32 extremes,
   int64 and REAL constants, range and NULL-constant terms, NULL-bearing
   planes, n not a multiple of 8, planes off a 16-byte boundary, one block
   and many; both of its evaluations (simple terms from registers, the
   interpreter) must be taken; then 32 deferred requests over configs 2, 3
   and 4's tables (2^22 rows each) dispatched before any wait, each equal
   to its serial answer, with the pinned stager's stats, a
   ``device::before_fetch`` inside one fetch (that request degrades, the
   next does not) and whether an event wait releases the interpreter lock;
   then cell 6b-ep (``bench.py:1130-1300``'s config 6b at the endpoint:
   three tables of 10·2^20 rows, 64 client threads × 6 requests of the
   seeded schedule, 60 s deadlines) through ``Endpoint.handle_async(...)
   .wait()``, once with the coalescer unwired and once bound (window 150
   ms, groups ≤ 16): every answer against numpy, no late ack, no degrade,
   no solo retry, ``sel_pred_batched`` launched in the coalesced phase
   only, mean occupancy above 1.5; p50, p99, requests/s, groups,
   occupancy, router decisions, launches and per-request phases printed;
   and ``sel_pred_batched`` timed at 6b-ep's shape beside its bound, its
   plain version, its interpreter on the same masks, 16 solo ``sel_pred``
   launches and one broadcast ``torch.gt``;
13. one JSON line listing every ported kernel: launches on the main path,
   largest difference from the plain version, kernel / plain / library
   times at its main shape (config 4 for ``hash_agg``, with configs 3, 4
   and 4s under ``configs``; config 4n for ``twolevel``'s fused entry, with
   its route at each config; config 2 for ``sel_pred``, with 5t under
   ``configs``; config 2 for ``sel_mask``; config 2s's 1% for
   ``sel_compact``; config 5 for ``topn_select``; config 4m for
   ``agg_fold``, with 3n under ``configs``; config 4h for
   ``mvcc_resolve``, ``plane_digest`` and ``patch_rows``, with 6c under
   ``configs``; configs 7, 7s and 7w for ``join_build`` / ``join_index``
   / ``join_probe``, ``sort_perm`` and ``window_scan``; an4's id for
   ``analyze``, with the other timed columns under ``configs``; 6b-ep's
   shape for ``sel_pred_batched``), and the least time the card could
   take;
14. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit peak
SF_TOL = 1e-9                   # float cells: × Σ|v| of the cell
HEADER_BYTES = 16               # sel_compact's count and overflow flag
CLOCK_HZ = 1.98e9               # H100 SXM boost clock (sleep cycles)

KERNELS = ("hash_agg", "twolevel", "sel_pred", "sel_pred_batched",
           "sel_mask", "sel_compact",
           "topn_select", "agg_fold", "mvcc_resolve", "plane_digest",
           "patch_rows", "join_build", "join_index", "join_probe",
           "sort_perm", "window_scan", "analyze")
# config → rows on the card; the route's kernel counts must be > 0
SIZES = {"3": 50 << 20, "4": 100 << 20, "4s": 1 << 24, "4n": 100 << 20,
         "4w": 100 << 20, "4r": 1 << 24, "4m": 1 << 24, "3n": 1 << 24}
ROUTE = {"3": "hash_agg", "4": "hash_agg", "4s": "hash_agg",
         "4n": "twolevel", "4w": "twolevel", "4r": "twolevel",
         "4m": "agg_fold", "3n": "agg_fold"}
# the configs that return rows: rows on the card, the kernels they launch
ROW_SIZES = {"1": 1 << 20, "2": 10 << 20, "5": 100 << 20, "5t": 100 << 20}
ROW_ROUTE = {"1": {"sel_pred"}, "2": {"sel_pred"}, "5": {"topn_select"},
             "5t": {"topn_select", "sel_pred"}}
SWEEP_ROWS = 10 << 20
# config 2s: the route each selectivity must take once its EWMA is warm
SWEEP_ROUTE = {"0.1%": "compact", "1%": "index", "10%": "mask",
               "50%": "mask"}


def cuda_ms(fn, iters: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    ``queued``: ``fn`` never waits for the device, and its calls are
    queued behind a device sleep three times as long as the host takes to
    issue them, so the device runs them back to back and the host's
    Python does not show (fails if the sleep ended first).  Otherwise the
    calls run as issued (for the plain versions and library calls, whose
    device time dwarfs their host time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    if queued:
        t0 = time.perf_counter()
        fn()                            # the host's issue time
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(max(1 << 24, 3 * iters * issue_s * CLOCK_HZ)))
        slept.record()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    assert not (queued and slept.query()), \
        "the host issued the calls too slowly to time"
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float) -> dict:
    b_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    b_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def counts() -> dict:
    from tikv_tpu_torch.device import (agg_fold, analyze, digest, hash_agg,
                                       join_probe, mvcc, selection, sort,
                                       topn, twolevel, window)
    return {"hash_agg": hash_agg.launches, "twolevel": twolevel.launches,
            "sel_pred": selection.pred_launches,
            "sel_pred_batched": selection.batched_launches,
            "sel_mask": selection.mask_launches,
            "sel_compact": selection.compact_launches,
            "topn_select": topn.launches, "agg_fold": agg_fold.launches,
            "mvcc_resolve": mvcc.resolve_launches,
            "plane_digest": digest.digest_launches,
            "patch_rows": digest.patch_launches,
            "join_build": sort.build_launches,
            "join_index": join_probe.index_launches,
            "join_probe": join_probe.launches,
            "sort_perm": sort.sort_launches,
            "window_scan": window.launches,
            "analyze": analyze.analyze_launches}


def set_counts(values: dict) -> None:
    from tikv_tpu_torch.device import (agg_fold, analyze, digest, hash_agg,
                                       join_probe, mvcc, selection, sort,
                                       topn, twolevel, window)
    hash_agg.launches = values["hash_agg"]
    twolevel.launches = values["twolevel"]
    selection.pred_launches = values["sel_pred"]
    selection.batched_launches = values["sel_pred_batched"]
    selection.mask_launches = values["sel_mask"]
    selection.compact_launches = values["sel_compact"]
    topn.launches = values["topn_select"]
    agg_fold.launches = values["agg_fold"]
    mvcc.resolve_launches = values["mvcc_resolve"]
    digest.digest_launches = values["plane_digest"]
    digest.patch_launches = values["patch_rows"]
    sort.build_launches = values["join_build"]
    join_probe.index_launches = values["join_index"]
    join_probe.launches = values["join_probe"]
    sort.sort_launches = values["sort_perm"]
    window.launches = values["window_scan"]
    analyze.analyze_launches = values["analyze"]


def build_kernels() -> None:
    from tikv_tpu_torch.device import build

    def one(name):
        t0 = time.perf_counter()
        log = build.build(name)
        return name, time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        for name, secs, log in pool.map(one, build.SOURCES):
            print(f"build: {name} in {secs:.3f} s", flush=True)
            print(f"ptxas {name}: {ptxas_summary(log)}", flush=True)
    shared_atomics("hash_agg")
    fold = shared_atomics("agg_fold")
    # the shared route of an all-integer launch (4m's) keeps no float64
    # shared add (a compare-and-swap loop, ATOMS.CAS / ATOMS.CAST)
    ints_only = {k: v for f, kinds in fold.items()
                 if "fold_shared" in f and "Lb0E" in f
                 for k, v in kinds.items()}
    assert ints_only and not any("CAS" in k for k in ints_only), \
        f"agg_fold's integer shared route: {ints_only}"
    print(f"sass agg_fold integer shared route: shared atomics " + " ".join(
        f"{k}x{v}" for k, v in sorted(ints_only.items())) +
        " (no float64 compare-and-swap loop)", flush=True)


def ptxas_summary(log: str) -> str:
    """One line from ``-Xptxas -v``'s report: kernels, the most registers
    any uses, and the largest stack frame and spills."""
    regs, frames, spills, kernels = [0], [0], [0], 0
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            kernels += 1
        for i, w in enumerate(words[1:], 1):
            if w == "registers" and words[i - 1].isdigit():
                regs.append(int(words[i - 1]))
            if w == "bytes" and words[i - 1].isdigit() and i + 1 < len(words):
                if words[i + 1] == "stack":
                    frames.append(int(words[i - 1]))
                elif words[i + 1] == "spill":
                    spills.append(int(words[i - 1]))
    return (f"{kernels} kernels, at most {max(regs)} registers, largest "
            f"stack frame {max(frames)} B, largest spill {max(spills)} B")


def shared_atomics(name: str) -> dict:
    """Print the shared-memory atomic instructions of a built library's
    SASS by kind (``cuobjdump -sass``), e.g. whether a 64-bit add is one
    ATOMS.ADD.64 or a compare-and-swap loop; → per device function (its
    mangled name) its kinds and counts."""
    from tikv_tpu_torch.device import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True).stdout
    kinds: dict = {}
    per_fn: dict = {}
    fn = ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            per_fn.setdefault(fn, {})
        for word in line.replace(";", " ").split():
            if word.startswith("ATOMS"):
                kinds[word] = kinds.get(word, 0) + 1
                per_fn.setdefault(fn, {})
                per_fn[fn][word] = per_fn[fn].get(word, 0) + 1
    print(f"sass {name}: shared atomics " + (" ".join(
        f"{k}x{v}" for k, v in sorted(kinds.items())) or "none"), flush=True)
    return per_fn


# ---------------------------------------------------------------------------
# hash_agg against its plain version
# ---------------------------------------------------------------------------

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
    # the redesign's edges: one hot slot over 2^24 rows at the int32
    # extremes (the packed cells fold every 2^15 rows), in each mode
    hot = 1 << 24
    ext = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                       device=dev)[ints(0, 2, hot).long()]
    ext[: hot // 2] = 2**31 - 1                 # a sum far past int32
    for mode, key in (("dense", torch.full((hot,), 1000, dtype=torch.int32,
                                           device=dev)),
                      ("sparse", torch.full((hot,), 7, dtype=torch.int32,
                                            device=dev))):
        yield f"hot_slot_{mode}_int32_extremes_{hot}_rows", dict(
            mode=mode, n=hot, slots=1026, n_slots=1024, key=key, base=0,
            capacity=1024, lanes=[Lane(values=ext), Lane(values=ext),
                                  Lane(ok=bools(0.5, hot))])
    yield f"hot_slot_simple_int32_extremes_{hot}_rows", dict(
        mode="simple", n=hot, slots=1, n_slots=1,
        lanes=[Lane(values=ext), Lane(values=ext, ok=bools(0.5, hot))])
    yield f"hot_slot_narrow_values_{hot}_rows", dict(
        mode="dense", n=hot, slots=1026, n_slots=1024, value_bytes=1,
        key=torch.full((hot,), 3, dtype=torch.int32, device=dev), base=0,
        capacity=1024, lanes=[Lane(values=torch.full(
            (hot,), -128, dtype=torch.int32, device=dev))])
    del ext
    # values of 2 bytes: 32-bit split cells, folded every 2^16 rows
    e16 = torch.tensor([2**15 - 1, -2**15], dtype=torch.int32,
                       device=dev)[ints(0, 2, hot).long()]
    for mode, key in (("dense", torch.full((hot,), 1023, dtype=torch.int32,
                                           device=dev)),
                      ("sparse", torch.zeros(hot, dtype=torch.int32,
                                             device=dev))):
        yield f"hot_slot_{mode}_int16_extremes_{hot}_rows_split", dict(
            mode=mode, n=hot, slots=1026, n_slots=1024, key=key, base=0,
            capacity=1024, value_bytes=2,
            lanes=[Lane(values=e16), Lane(values=e16, ok=bools(0.5, hot)),
                   Lane(ok=bools(0.5, hot))])
    del e16
    yield "dense_split", dict(dense, value_bytes=2, lanes=[Lane(values=v)])
    yield "sparse_split", dict(mode="sparse", n=B, slots=1026, n_slots=1025,
                               key=ints(0, 1026, B), capacity=1024,
                               value_bytes=2, lanes=[Lane(values=v)])
    yield "dense_expr_key_split", dict(
        dense, n_slots=1025, key=ints(-3, 1003, B), key_ok=bools(0.9, B),
        base=-3, mask=bools(0.7, B), value_bytes=2,
        lanes=[Lane(values=v, ok=bools(0.8, B)), Lane(ok=bools(0.5, B))])
    yield "4096_slots_split_cells_3_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096, value_bytes=1,
        lanes=[Lane(values=ints(-128, 128, B)) for _ in range(3)])
    # repeated lanes: one values plane under two validity planes, a lane
    # repeated, and a COUNT lane sharing a validity plane
    a, b = bools(0.6, B), bools(0.3, B)
    for vb in (2, 4):
        yield f"repeated_lanes_two_validities_{vb}_byte_values", dict(
            dense, mask=bools(0.8, B), value_bytes=vb,
            lanes=[Lane(values=v, ok=a), Lane(values=v, ok=b),
                   Lane(values=v, ok=a), Lane(ok=b), Lane(values=v)])
    yield "config_3_lanes_one_plane", dict(
        mode="simple", n=B, slots=1, n_slots=1, value_bytes=2,
        lanes=[Lane(values=v), Lane(values=v)])
    # planes 1-3 elements off a 16-byte boundary: all at one phase (a
    # scalar head, then 16-byte loads), or at different phases (scalar)
    K, V = ints(0, 1024, B + 8), ints(-1000, 1000, B + 8)
    M, O = bools(0.7, B + 8), bools(0.6, B + 8)
    for off in (1, 2, 3):
        for mode, vb in (("dense", 4), ("dense", 2), ("simple", 4)):
            yield f"{mode}_{vb}_byte_planes_off_by_{off}", dict(
                dense, mode=mode, n=B - 5, key=K[off:], mask=M[off:],
                slots=1026 if mode == "dense" else 1,
                n_slots=1024 if mode == "dense" else 1, value_bytes=vb,
                lanes=[Lane(values=V[off:], ok=O[off:])])
            yield f"{mode}_{vb}_byte_planes_off_by_{off}_phases_differ", dict(
                dense, mode=mode, n=B - 5, key=K[off:], mask=M[4 - off:],
                slots=1026 if mode == "dense" else 1,
                n_slots=1024 if mode == "dense" else 1, value_bytes=vb,
                lanes=[Lane(values=V[(off + 1) % 4:])])
    for n in (1, 3, 4097, B - 1):
        for vb in (2, 4):
            yield f"n_{n}_not_a_multiple_of_4_{vb}_byte_values", dict(
                dense, n=n, mask=M, value_bytes=vb, lanes=[Lane(values=v)])
    yield "4096_slots_8_lanes", dict(
        mode="dense", n=B, slots=4098, n_slots=4096, key=ints(0, 4096, B),
        base=0, capacity=4096,
        lanes=[Lane(values=ints(-(1 << 30), 1 << 30, B), ok=bools(0.5, B))
               for _ in range(8)])


def plain_args(kw: dict) -> dict:
    """hash_agg's arguments without the kernel's value width."""
    return {k: v for k, v in kw.items() if k != "value_bytes"}


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
        want = ha.hash_agg_plain(device=dev, **plain_args(kw))
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        print(f"kernel hash_agg {name}: max_abs_err={err}", flush=True)
        assert err == 0, f"hash_agg {name} disagrees with its plain version"
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# twolevel against its plain version
# ---------------------------------------------------------------------------

def twolevel_err(idx, L8, Lf, LO, HI) -> float:
    """Kernel against plain version: S8 exactly; Sf within SF_TOL·Σ|v| per
    cell.  Returns the largest absolute difference."""
    from tikv_tpu_torch.device import twolevel as tl
    got8, gotf = tl.twolevel(idx, L8, Lf, LO, HI)
    torch.cuda.synchronize()
    want8, wantf = tl.twolevel_plain(idx, L8, Lf, LO, HI)
    assert torch.equal(got8, want8), "twolevel int8 planes disagree"
    if Lf is None:
        assert gotf is None
        return 0.0
    _w, mag = tl.twolevel_plain(idx, L8[:1], Lf.abs(), LO, HI)
    diff = (gotf - wantf).abs()
    assert bool((diff <= SF_TOL * mag).all()), \
        "twolevel float planes beyond tolerance"
    return float(diff.max())


def twolevel_cases(dev):
    """(name, idx, L8, Lf, LO, HI) on the card: the CPU tests' edge cases
    (plane counts, both routes, NULL/scrap/out-of-range slots, padding
    rows, int8 extremes, a hot slot past the per-block row cap)."""
    from tikv_tpu_torch.device import kernels as kn
    g = torch.Generator(device="cpu").manual_seed(12)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def floats(shape):
        return (torch.randn(shape, generator=g) * 1000).to(dev)

    n = 1 << 18
    for p8, pf in ((1, 0), (3, 1), (8, 2), (32, 0)):
        for slots in (1026, 65538, (1 << 20) + 2):
            LO, HI = kn.twolevel_dims(slots, p8, pf)
            idx = ints(-2, HI * LO + 3, (n,))           # beyond both ends
            L8 = ints(-128, 128, (p8, n), torch.int8)
            Lf = floats((pf, n)) if pf else None
            yield f"p8={p8}_pf={pf}_slots={slots}", idx, L8, Lf, LO, HI
    LO, HI = 16, 72
    idx = torch.full((n,), 1025, dtype=torch.int32, device=dev)  # scrap
    idx[: n // 2] = 1024                                         # NULL slot
    yield "null_and_scrap_slots", idx, ints(-128, 128, (8, n), torch.int8), \
        None, LO, HI
    yield "ragged_n", ints(0, 1026, (n - 12345,)), \
        ints(-128, 128, (8, n - 12345), torch.int8), None, LO, HI
    yield "one_row", ints(0, 1026, (1,)), ints(-128, 128, (3, 1), torch.int8), \
        floats((1, 1)), 32, 40
    hot = (1 << 24) + 777
    extremes = torch.tensor([-128, 127], dtype=torch.int8,
                            device=dev)[ints(0, 2, (hot,)).long()]
    yield "hot_slot_int8_extremes", \
        torch.zeros(hot, dtype=torch.int32, device=dev), \
        torch.stack([torch.full((hot,), -128, dtype=torch.int8, device=dev),
                     extremes]), None, 32, 40


# the Pallas prototypes' shapes: rows, HI, LO, numpy seed of their data
PROTOTYPES = {"prof_pallas": (1 << 23, 32, 32, 0),
              "prof_pl": (100 << 20, 40, 32, 7)}


def prototype_inputs(name: str, dev):
    """A Pallas prototype's own shape and data, as (idx, L8, LO, HI, k, v):
    ``prof/prof_pallas.py`` (planes [mask, mask, b0, b1]) or
    ``prof/prof_pl.py`` (planes [mask, b0, b1]; idx = k), with k uniform
    over 1024 slots and v over [-1000, 1000)."""
    N, HI, LO, seed = PROTOTYPES[name]
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1024, N).astype(np.int32)
    v = rng.integers(-1000, 1000, N).astype(np.int32)
    kt = torch.from_numpy(k).to(dev)
    biased = torch.from_numpy(v).to(dev) + (1 << 15)
    mask = torch.ones(N, dtype=torch.int8, device=dev)
    b0 = ((biased & 0xFF) - 128).to(torch.int8)
    b1 = (((biased >> 8) & 0xFF) - 128).to(torch.int8)
    planes = [mask, mask, b0, b1] if name == "prof_pallas" \
        else [mask, b0, b1]
    return kt, torch.stack(planes), LO, HI, k, v


def prototype_check(name: str, S8, LO: int, HI: int, k, v) -> None:
    """The prototype's own check: count by bincount and the sum rebuilt
    with its bias formula equal numpy's."""
    P = S8.shape[1] // LO
    S = S8.cpu().numpy().reshape(HI, P, LO).transpose(1, 0, 2) \
        .reshape(P, HI * LO)[:, :1024]
    want_cnt = np.bincount(k, minlength=1024)
    want_sum = np.bincount(k, weights=v, minlength=1024).astype(np.int64)
    if name == "prof_pallas":
        ok = S[1]
        cnt = S[0]
        got_sum = (S[2] + 128 * ok) + 256 * (S[3] + 128 * ok) - (1 << 15) * ok
    else:
        cnt = S[0]
        got_sum = S[1] + (S[2] << 8) + S[0] * (128 + (128 << 8) - (1 << 15))
    assert np.array_equal(cnt, want_cnt), f"{name}: count differs"
    assert np.array_equal(got_sum, want_sum), f"{name}: sum differs"
    print(f"prototype {name}: count exact, sum exact", flush=True)


def check_twolevel(dev) -> float:
    worst = 0.0
    for name, idx, L8, Lf, LO, HI in twolevel_cases(dev):
        err = twolevel_err(idx, L8, Lf, LO, HI)
        print(f"kernel twolevel {name}: max_abs_err={err} (int8 planes "
              f"exact, float planes within {SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
    for name in PROTOTYPES:
        idx, L8, LO, HI, k, v = prototype_inputs(name, dev)
        err = twolevel_err(idx, L8, None, LO, HI)
        from tikv_tpu_torch.device import twolevel as tl
        prototype_check(name, tl.twolevel(idx, L8, None, LO, HI)[0],
                        LO, HI, k, v)
        print(f"kernel twolevel {name} shape ({idx.shape[0]} rows): "
              f"max_abs_err={err}", flush=True)
        del idx, L8
        gc.collect()
    return worst


# ---------------------------------------------------------------------------
# twolevel's fused entry against its plain version
# ---------------------------------------------------------------------------

def fused_route(n, layouts, cols, LO, HI, kw, dev) -> str:
    """The route the fused kernel takes for these arguments."""
    from tikv_tpu_torch.device import twolevel as tl
    _lanes, src8, srcf = tl.plan_lanes(layouts, cols)
    source = "sparse" if kw.get("slot_ids") is not None else \
        "dense32" if kw["key"].dtype == torch.int32 else "dense64"
    name, cs = tl.route(max(src8) + 1, max(srcf, default=-1) + 1, LO, HI,
                        source, dev)
    return name if name != "cluster" else f"cluster{cs}"


def fused_err(n, layouts, cols, LO, HI, kw) -> float:
    """Fused kernel against its plain version: S8 exactly, the overflow
    flag, Sf within SF_TOL·Σ|v| per cell.  Returns the largest absolute
    difference."""
    from tikv_tpu_torch.device import twolevel as tl
    got8, gotf, got_ovf = tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)
    torch.cuda.synchronize()
    want8, wantf, want_ovf = tl.twolevel_fused_plain(n, layouts, cols, LO,
                                                     HI, **kw)
    assert torch.equal(got8, want8), "twolevel_fused int8 planes disagree"
    assert (got_ovf is None) == (want_ovf is None)
    assert got_ovf is None or bool(got_ovf) == bool(want_ovf), \
        "twolevel_fused overflow flag disagrees"
    if wantf is None:
        assert gotf is None
        return 0.0
    mags = [col if col is None or not col[0].is_floating_point()
            else (col[0].abs(), col[1]) for col in cols]
    mag = tl.twolevel_fused_plain(n, layouts, mags, LO, HI, **kw)[1]
    diff = (gotf - wantf).abs()
    assert bool((diff <= SF_TOL * mag).all()), \
        "twolevel_fused float planes beyond tolerance"
    return float(diff.max())


def fused_cases(dev):
    """(name, n, layouts, cols, LO, HI, keyword arguments) on the card: the
    CPU tests' cases at slot counts that take each route, a hot slot past
    the per-table row cap, and a live key out of range."""
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.ops.agg import AggSpec
    g = torch.Generator(device="cpu").manual_seed(13)
    n = 1 << 18

    def ints(lo, hi, count, dtype=torch.int32):
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def column(nb, dtype, nullable, count=n):
        lo, hi = -(1 << (8 * nb - 1)), (1 << (8 * nb - 1)) - 1
        v = torch.randint(lo, hi, (count,), generator=g, dtype=torch.int64)
        v[:4] = torch.tensor([lo, hi, 0, -1])
        ok = bools(0.85, count) if nullable else \
            torch.ones(count, dtype=torch.bool, device=dev)
        return v.to(dtype).to(dev), ok, nb

    def case(aggs, columns, slots, key_kind="int32", mask_kind="partial",
             count=n):
        specs = [AggSpec(kind, i) for i, (kind, _c) in enumerate(aggs)]
        real = [c is not None and columns[c][0].is_floating_point()
                for _k, c in aggs]
        nbytes = [0 if c is None or r or k == "count" else columns[c][2]
                  for (k, c), r in zip(aggs, real)]
        aliased = [c is not None and bool(columns[c][1].all())
                   for _k, c in aggs]
        layouts, p8, pf = kn.build_layouts(specs, real, nbytes, aliased)
        LO, HI = kn.twolevel_dims(slots, p8, pf)
        capacity = slots - 2
        pairs = {c: (v, ok) for c, (v, ok, _nb) in columns.items()}
        cols = [None if c is None else pairs[c] for _k, c in aggs]
        kw = {"capacity": capacity, "mask": {
            "none": None, "partial": bools(0.7, count),
            "all_false": torch.zeros(count, dtype=torch.bool, device=dev),
        }[mask_kind]}
        if key_kind == "sparse":
            kw["slot_ids"] = ints(0, capacity + 2, count)
        else:
            base = -300 if key_kind == "int32" else (1 << 40) - 300
            dtype = torch.int32 if key_kind == "int32" else torch.int64
            kw.update(base=base, key=(base + ints(0, capacity, count,
                                                  torch.int64)).to(dtype),
                      key_ok=bools(0.92, count))
        return count, layouts, cols, LO, HI, kw

    four_w = [("count_star", None), ("sum", "a")]
    four_n = [("count_star", None), ("count", "v"), ("sum", "v"),
              ("avg", "v")]
    for slots in (1026, 65538, (1 << 20) + 2):
        cols = {"a": column(2, torch.int32, False),
                "v": column(2, torch.int32, True)}
        for key_kind in ("int32", "int64", "sparse"):
            for mask_kind in ("none", "partial", "all_false"):
                yield (f"4w_aggs_slots={slots}_{key_kind}_key_{mask_kind}",
                       *case(four_w, cols, slots, key_kind, mask_kind))
        yield f"4n_aggs_slots={slots}", *case(four_n, cols, slots)
        r = (torch.randn(n, generator=g) * 1000).to(dev)
        r_ok = bools(0.8, n)
        yield f"real_lanes_slots={slots}", *case(
            [("sum", "r"), ("avg", "r"), ("count", "r"), ("sum", "q")],
            {"r": (torch.where(r_ok, r, 0.0), r_ok, 0),
             "q": (r, torch.ones(n, dtype=torch.bool, device=dev), 0)},
            slots)
        if slots > 65538:
            continue
        for nb, dtype in ((1, torch.int32), (2, torch.int32),
                          (3, torch.int32), (4, torch.int32),
                          (3, torch.int64), (8, torch.int64)):
            yield f"bytes_nb={nb}_{dtype}_slots={slots}", *case(
                [("sum", "w"), ("count", "w"), ("avg", "a")],
                {"w": column(nb, dtype, True), "a": column(nb, dtype, False)},
                slots, "int64" if dtype == torch.int64 else "int32")
    # a live key outside [base, base + capacity): the overflow flag
    count, layouts, cols, LO, HI, kw = case(four_w, {
        "a": column(2, torch.int32, False)}, 1026)
    kw["key"][kw["mask"].nonzero()[:3, 0]] = -300 + 5000
    kw["key_ok"][kw["mask"].nonzero()[:3, 0]] = True
    yield "overflow", count, layouts, cols, LO, HI, kw
    # one hot slot, every byte -128, past the per-table row cap (2^23)
    hot = (1 << 24) + 777
    low = torch.full((hot,), -(1 << 15), dtype=torch.int32, device=dev)
    for slots in (1026, 65538):
        count, layouts, cols, LO, HI, kw = case(
            four_w, {"a": (low, torch.ones(hot, dtype=torch.bool,
                                           device=dev), 2)},
            slots, "int32", "none", hot)
        kw.update(key=torch.full((hot,), 777, dtype=torch.int32, device=dev),
                  key_ok=None, base=0)
        yield f"hot_slot_slots={slots}", count, layouts, cols, LO, HI, kw


def check_fused(dev) -> float:
    worst, routes = 0.0, set()
    for name, n, layouts, cols, LO, HI, kw in fused_cases(dev):
        err = fused_err(n, layouts, cols, LO, HI, kw)
        route = fused_route(n, layouts, cols, LO, HI, kw, dev)
        routes.add(route.rstrip("2468"))
        print(f"kernel twolevel_fused {name}: route={route} "
              f"max_abs_err={err} (int8 planes exact, float planes within "
              f"{SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
        del cols, kw
    assert routes == {"shared", "cluster", "global"}, routes
    gc.collect()
    return worst


# ---------------------------------------------------------------------------
# the aggregation path
# ---------------------------------------------------------------------------

def serve(label: str, n: int, runner, dag, snap, answer, agrees,
          expect: set, **extra) -> dict:
    """One cold and five warm requests of ``dag``, each ``answer(result)``
    (inside the timed window) held against the truth by ``agrees``; the
    kernels of ``expect`` must launch and no other (``sel_compact`` may
    beside ``sel_mask``: the route decides); the route of each request
    (``runner.sel_routes``), peak bytes of one more and one profile."""
    set_counts({k: 0 for k in KERNELS})
    routes0 = dict(runner.sel_routes)
    preds0 = dict(runner.pred_routes)
    t0 = time.perf_counter()
    got = answer(runner.handle_request(dag, snap))
    cold = time.perf_counter() - t0
    assert agrees(got), f"config {label}: wrong answer on the cold request"
    warm, last = [], {}
    for _ in range(5):
        before = dict(runner.sel_routes)
        t0 = time.perf_counter()
        got = answer(runner.handle_request(dag, snap))
        warm.append(time.perf_counter() - t0)
        assert agrees(got), f"config {label}: wrong answer when warm"
        last = {k: v - before.get(k, 0) for k, v in runner.sel_routes.items()
                if v != before.get(k, 0)}
    launches = counts()
    selection = bool(expect & {"sel_pred", "sel_mask"})
    for name in KERNELS:
        if name in expect:
            assert launches[name] > 0, f"config {label} never launched {name}"
        elif name != "sel_compact" or not selection:
            assert launches[name] == 0, f"config {label} launched {name}"
    p50 = float(np.percentile(warm, 50))
    out = {"config": label, "rows": n, **extra, "cold_ms": cold * 1e3,
           "warm_p50_ms": p50 * 1e3, "rows_per_s": n / p50,
           "launches": launches}
    if selection and "topn_select" not in expect:
        out["routes"] = {k: v - routes0.get(k, 0)
                         for k, v in runner.sel_routes.items()
                         if v != routes0.get(k, 0)}
        out["last_route"] = last
    # each request's predicate route (sel_pred, or torch then sel_mask)
    out["pred_routes"] = {k: v - preds0.get(k, 0)
                          for k, v in runner.pred_routes.items()
                          if v != preds0.get(k, 0)}
    if selection:
        want = "torch" if "sel_mask" in expect else "sel_pred"
        assert out["pred_routes"] == {want: 6}, \
            f"config {label}: predicate routes {out['pred_routes']}"
    out["peak_request_bytes"] = peak_request_bytes(runner, dag, snap)
    print(f"config {label}: " + " ".join(f"{k}={v}" for k, v in out.items()
                                         if k != "config"), flush=True)
    profile_request(label, runner, dag, snap,
                    {k for k in expect if k != "sel_compact"})
    return out


def run_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf

    build, make = cf.CONFIGS[config]
    table, snap = build(n)
    dag = dag_from_wire(enc_dag(make(table)))
    want, scales = cf.truth(config, snap)
    built = {}
    build_flat = runner._build_flat

    def record(host_cols, n_rows):
        built.update(host_cols=host_cols, n=n_rows)
        return build_flat(host_cols, n_rows)

    runner._build_flat = record
    try:
        out = serve(config, n, runner, dag, snap, lambda r: r.rows(),
                    lambda rows: cf.rows_agree(rows, want, scales, SF_TOL),
                    {ROUTE[config]} - {None}, groups=len(want))
    finally:
        del runner._build_flat
    if ROUTE[config] == "hash_agg":
        out["host_phases_ms"] = host_phases(runner, dag, snap)
    if config == "4":
        out["feed_build_ms"] = feed_build_cost(runner, **built)
        print(f"feed build config {config} (ms, host clock): "
              + json.dumps(out["feed_build_ms"]), flush=True)
    del snap, built
    gc.collect()
    return out


def feed_build_cost(runner, host_cols, n: int, repeats: int = 3) -> dict:
    """The cold request's feed build on the host clock (ms, the median of
    ``repeats`` rounds): the planes' uploads alone, ``_build_flat`` (the
    same uploads while a thread pool hashes the planes' digests) and the
    digests hashed one plane after another on one thread."""
    from tikv_tpu_torch.device.supervisor import host_plane_digest
    hosts = [a for v, ok in host_cols
             for a in ((v, ok) if not ok.all() else (v,))]
    n_pad = runner._pad_rows(n)
    runs = []
    for _ in range(repeats):
        ms = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes = [runner._upload(a, n_pad) for a in hosts]
        torch.cuda.synchronize()
        ms["uploads"] = (time.perf_counter() - t0) * 1e3
        del planes
        t0 = time.perf_counter()
        feed = runner._build_flat(host_cols, n)
        torch.cuda.synchronize()
        ms["build_flat"] = (time.perf_counter() - t0) * 1e3
        del feed
        t0 = time.perf_counter()
        for a in hosts:
            host_plane_digest(a, n)
        ms["serial_digests"] = (time.perf_counter() - t0) * 1e3
        runs.append(ms)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def host_phases(runner, dag, snap, repeats: int = 5) -> dict:
    """Host-clock phases (ms, the median of ``repeats`` warm requests) of a
    request on the hash_agg route: analyze (``_analyze``), inputs
    (``_inputs``: the feed's planes and the selection), launch
    (``hash_agg``: lane plan and kernel launch), stage (the rest of
    ``_aggregate_launch`` — the lane list and the stack of the outputs —
    and the start of the copy to pinned memory), d2h_wait (``_readback``:
    the wait for the copy, which waits for the kernel), finalize
    (``states_from_lanes`` and the result columns) and other (the rest of
    ``handle_request``: the dispatch lock, feed and meta lookups)."""
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.device.deferred import HOST_STAGER
    saved = counts()
    names = ("_analyze", "_inputs", "_aggregate_launch", "_readback",
             "_simple_result", "_hash_result")
    runs = []
    for _ in range(repeats):
        spent = dict.fromkeys(names + ("stage", "hash_agg",
                                       "states_from_lanes"), 0.0)

        def timed(name, fn):
            def wrap(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[name] += time.perf_counter() - t0
            return wrap

        originals = {n: getattr(ha, n) for n in ("hash_agg",
                                                 "states_from_lanes")}
        for n in names:
            setattr(runner, n, timed(n, getattr(runner, n)))
        HOST_STAGER.stage = timed("stage", HOST_STAGER.stage)
        for n, fn in originals.items():
            setattr(ha, n, timed(n, fn))
        try:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            total = time.perf_counter() - t0
        finally:
            for n in names:
                delattr(runner, n)
            del HOST_STAGER.stage
            for n, fn in originals.items():
                setattr(ha, n, fn)
        ms = {k: v * 1e3 for k, v in spent.items()}
        result = ms["_simple_result"] + ms["_hash_result"]
        runs.append({
            "analyze": ms["_analyze"], "inputs": ms["_inputs"],
            "launch": ms["hash_agg"],
            "stage": ms["_aggregate_launch"] - ms["_inputs"]
            - ms["hash_agg"] + ms["stage"],
            "d2h_wait": ms["_readback"],
            "finalize": ms["states_from_lanes"] + result,
            "other": total * 1e3 - ms["_analyze"] - ms["_aggregate_launch"]
            - ms["stage"] - ms["_readback"] - ms["states_from_lanes"]
            - result,
            "total": total * 1e3})
    set_counts(saved)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def peak_bytes(fn) -> int:
    """Peak device memory of one call of ``fn`` beyond what was resident
    before it; its launches do not count."""
    saved = counts()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    set_counts(saved)
    return torch.cuda.max_memory_allocated() - resident


def peak_request_bytes(runner, dag, snap) -> int:
    """Peak device memory of one warm request beyond the resident feed."""
    return peak_bytes(lambda: runner.handle_request(dag, snap))


# kernel → substrings of its device functions' names in a trace
SYMBOLS = {"hash_agg": ("table_kernel", "simple_kernel"),
           "twolevel": ("twolevel_kernel",),
           "sel_pred": ("sel_pred_kernel",),
           "sel_mask": ("sel_mask_kernel",),
           "sel_compact": ("sel_compact_kernel",),
           "topn_select": ("topn_hist",),
           "agg_fold": ("fold_shared", "fold_global", "fold_simple"),
           "join_probe": ("probe_kernel",), "sort_perm": ("onesweep_kernel",),
           "window_scan": ("window_kernel",)}


def profile_request(config: str, runner, dag, snap, expect=(),
                    call=None) -> dict:
    """One warm request (``runner.handle_request(dag, snap)``, or
    ``call()``) under torch.profiler: device time by kernel and the
    device's idle share of the (profiled) request wall.  The trace must
    hold a device function of every kernel in ``expect``: the tracer now
    and then misses them, so the request is traced again (up to three
    times with CPU and CUDA activity, then up to three times with CUDA
    activity alone); the line says whether it ever held them."""
    from torch.profiler import ProfilerActivity, profile
    saved = counts()
    attempts = [[ProfilerActivity.CPU, ProfilerActivity.CUDA]] * 3 + \
        [[ProfilerActivity.CUDA]] * 3
    for tried, activities in enumerate(attempts, 1):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            if call is None:
                runner.handle_request(dag, snap)
            else:
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        names = [e.key for e in events]
        seen = all(any(sym in k for k in names for sym in SYMBOLS[name])
                   for name in expect)
        if seen and any(not k.startswith(("Memcpy", "Memset"))
                        for k in names):
            break
    set_counts(saved)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile config {config}: wall_ms={wall_ms} device_ms={dev_ms} "
          f"idle_share={1 - dev_ms / wall_ms} traces={tried} "
          f"route_kernels_traced={seen} top=" + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3}ms"
              for e in top), flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "traced": seen}


# ---------------------------------------------------------------------------
# kernels at the main path's shapes
# ---------------------------------------------------------------------------

def main_path_inputs(config: str, n: int, dev) -> dict:
    """hash_agg's arguments exactly as the runner builds them for one
    config: the int32 feed planes, the slot layout, one lane per SUM/AVG
    (config 3's SUM(v) and AVG(v) are two lanes over one plane) and the
    value width of ``_arg_nbytes`` (v's range)."""
    from tikv_tpu_torch.device import hash_agg as ha
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.testing import configs as cf
    _table, snap = cf.CONFIGS[config][0](n)
    vn = snap.columns[3].values
    v = torch.from_numpy(vn.astype(np.int32)).to(dev)
    kw = dict(n=n, device=dev, value_bytes=kn.int_planes_needed(
        int(vn.min()), int(vn.max())))
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


def kernel_at_main_shapes(dev) -> tuple:
    """hash_agg against its plain version (exact) and timed, at each of
    configs 3, 4 and 4s's main-path shapes; → (largest difference,
    config → timing)."""
    from tikv_tpu_torch.device import hash_agg as ha
    worst, timings = 0, {}
    for config in ("3", "4", "4s"):
        n = SIZES[config]
        kw = main_path_inputs(config, n, dev)
        saved = counts()
        err = max_abs_diff(ha.hash_agg(**kw),
                           ha.hash_agg_plain(**plain_args(kw)))
        assert err == 0, f"hash_agg disagrees with its plain version " \
            f"at config {config}'s shape"
        worst = max(worst, err)
        plan = ha.plan_lanes(kw["lanes"])
        ms = cuda_ms(lambda: ha.hash_agg(**kw), 20, queued=True)
        fmt = "registers" if kw["mode"] == "simple" else ha.plan_launches(
            kw["mode"], kw["n_slots"], plan.lanes,
            ha._smem_limit(ha._kernel_lib(), dev.index or 0),
            kw["value_bytes"])[0].fmt
        other = {}
        if config != "3":               # packed cells on the same inputs
            chosen = ha.cell_format
            ha.cell_format = lambda *_a: ha.FMT_PACKED
            try:
                assert max_abs_diff(ha.hash_agg(**kw), ha.hash_agg_plain(
                    **plain_args(kw))) == 0
                other["packed_ms"] = cuda_ms(lambda: ha.hash_agg(**kw), 20,
                                             queued=True)
            finally:
                ha.cell_format = chosen
        set_counts(saved)               # measurement launches do not count
        plain_ms = cuda_ms(lambda: ha.hash_agg_plain(**plain_args(kw)), 3)
        # inputs read once (config 3's two lanes share one plane), states
        # written once; ops: slot, count add, one add per lane
        planes = 1 if config == "3" else 2
        lanes = len(kw["lanes"])
        out = {"ms": ms, "plain_ms": plain_ms,
               **bound_ms(4 * n * planes + 8 * kw["slots"] * (1 + lanes),
                          n * (2 + lanes)),
               "distinct_lanes": len(plan.lanes),
               "value_bytes": kw["value_bytes"], "cell_format": fmt,
               **other}
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
        out["rows"] = n
        timings[config] = out
        print(f"kernel hash_agg at config {config} shape ({n} rows): "
              f"max_abs_err={err} tolerance=0 (integer states) " +
              " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
        del kw, v
        gc.collect()
    return worst, timings


def captured_inputs(config: str, runner, name: str) -> tuple:
    """(args, kwargs) of the runner's call of ``name`` (``twolevel_fused``
    or ``agg_fold``, as ``device/runner.py`` imports them) on one request
    of ``config`` (recorded around the call; not counted)."""
    import tikv_tpu_torch.device.runner as rmod
    from tikv_tpu_torch.testing import configs as cf
    build, make = cf.CONFIGS[config]
    table, snap = build(SIZES[config])
    seen = []
    real = getattr(rmod, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    saved = counts()
    setattr(rmod, name, record)
    try:
        runner.handle_request(make(table), snap)
    finally:
        setattr(rmod, name, real)
        set_counts(saved)
    return seen[0]


def fused_bytes(n, layouts, cols, LO, HI, kw) -> int:
    """Bytes the fused entry must move: each distinct raw column read once
    (rows [0, n)), the int64 / float64 states written once."""
    from tikv_tpu_torch.device import twolevel as tl
    lanes, _src8, _srcf = tl.plan_lanes(layouts, cols)
    inputs = [kw.get("key"), kw.get("key_ok"), kw.get("slot_ids"),
              kw.get("mask")] + [t for ln in lanes for t in (ln.values,
                                                              ln.ok)]
    seen, total = set(), 0
    for t in inputs:
        if t is not None and t.stride(0) != 0 and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += n * t.element_size()
    p8, pf = tl.plane_counts(layouts)
    return total + 8 * HI * LO * (p8 + pf)


def planes_path(n, layouts, cols, LO, HI, kw, dev):
    """The planes path on the same inputs: slot ids and planes built by
    torch ops (``slot_index``, ``make_planes``), then the planes kernel —
    the runner's path before the fused entry."""
    from tikv_tpu_torch.device import kernels as kn
    from tikv_tpu_torch.device import twolevel as tl
    mask = kw["mask"] if kw["mask"] is not None else \
        torch.ones(n, dtype=torch.bool, device=dev)
    if kw.get("slot_ids") is not None:
        idx = torch.where(mask, kw["slot_ids"][:n],
                          torch.full((), kw["capacity"] + 1,
                                     dtype=torch.int32, device=dev))
    else:
        km = kw["key_ok"] if kw["key_ok"] is not None else \
            torch.ones((), dtype=torch.bool, device=dev)
        idx, _ovf = kn.slot_index((kw["key"], km), kw["capacity"],
                                  kw["base"], mask)
    L8, Lf = kn.make_planes(layouts, cols, mask)
    return idx.contiguous(), L8, Lf, tl.twolevel(idx.contiguous(), L8, Lf,
                                                 LO, HI)


def time_fused(config: str, args, kwargs, dev) -> dict:
    """The fused entry against its plain version and timed at one config's
    shape, beside the planes path it replaced, its bound and a library
    yardstick."""
    from tikv_tpu_torch.device import twolevel as tl
    n, layouts, cols, LO, HI, capacity = args
    kw = dict(kwargs, capacity=capacity)
    saved = counts()
    err = fused_err(n, layouts, cols, LO, HI, kw)
    route = fused_route(n, layouts, cols, LO, HI, kw, dev)
    ms = cuda_ms(lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw),
                 10, queued=True)
    planes_ms = cuda_ms(
        lambda: planes_path(n, layouts, cols, LO, HI, kw, dev), 5,
        queued=True)
    set_counts(saved)
    peaks = {"fused_peak_bytes": peak_bytes(
        lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)),
             "planes_peak_bytes": peak_bytes(
        lambda: planes_path(n, layouts, cols, LO, HI, kw, dev))}
    plain_ms = cuda_ms(lambda: tl.twolevel_fused_plain(
        n, layouts, cols, LO, HI, **kw), 2)
    p8, pf = tl.plane_counts(layouts)
    lanes, src8, srcf = tl.plan_lanes(layouts, cols)
    d8, df = max(src8) + 1, max(srcf, default=-1) + 1
    # bytes: the raw columns read once and the states written once; ops:
    # one add per distinct plane and row
    out = {"ms": ms, "plain_ms": plain_ms, "planes_ms": planes_ms,
           **bound_ms(fused_bytes(n, layouts, cols, LO, HI, kw),
                      n * (d8 + df))}
    # yardstick only (the port never calls it): one index_add_ of the
    # stacked int64 planes into (p8, slots) along dim 1, the planes built
    # beforehand
    idx, L8, _Lf, _S = planes_path(n, layouts, cols, LO, HI, kw, dev)
    set_counts(saved)
    idx64, L64 = idx.to(torch.int64), L8.to(torch.int64)
    del L8, _Lf, _S
    out["library_ms"] = cuda_ms(lambda: torch.zeros(
        p8, HI * LO, dtype=torch.int64, device=dev).index_add_(
            1, idx64, L64), 5)
    del idx, idx64, L64
    route_sweep(config, args, kw, dev)
    out["max_abs_err"] = err
    out["table_route"] = route
    print(f"kernel twolevel_fused at config {config} shape ({n} rows, "
          f"p8={p8} pf={pf} distinct={d8}+{df} LO={LO} HI={HI}): " +
          " ".join(f"{k}={v}" for k, v in {**out, **peaks}.items()),
          flush=True)
    return out


def route_sweep(config: str, args, kw, dev) -> dict:
    """The fused kernel at one config's shape on every route its table can
    take (the launcher's choice replaced; a route the card refuses is
    skipped), each held against the plain version: route → ms."""
    from tikv_tpu_torch.device import twolevel as tl
    n, layouts, cols, LO, HI, _capacity = args
    chosen, out = tl.route, {}
    want = tl.twolevel_fused_plain(n, layouts, cols, LO, HI, **kw)[0]
    saved = counts()
    try:
        for name, cs in (("shared", 1), ("cluster", 2), ("cluster", 4),
                         ("cluster", 8), ("global", 0)):
            tl.route = lambda *_a, _r=(name, cs), **_k: _r
            try:
                got = tl.twolevel_fused(n, layouts, cols, LO, HI, **kw)[0]
                torch.cuda.synchronize()
            except RuntimeError:        # refused: the table does not fit
                continue
            assert torch.equal(got, want), f"{config} {name}{cs} disagrees"
            out[f"{name}{cs if name == 'cluster' else ''}"] = cuda_ms(
                lambda: tl.twolevel_fused(n, layouts, cols, LO, HI, **kw),
                10, queued=True)
    finally:
        tl.route = chosen
        set_counts(saved)
    print(f"kernel twolevel_fused at config {config} shape, every route "
          f"(ms): " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    return out


def time_twolevel(label: str, idx, L8, Lf, LO, HI, dev) -> dict:
    """The planes entry against its plain version and timed at one
    shape."""
    from tikv_tpu_torch.device import twolevel as tl
    saved = counts()
    err = twolevel_err(idx, L8, Lf, LO, HI)
    ms = cuda_ms(lambda: tl.twolevel(idx, L8, Lf, LO, HI), 10, queued=True)
    set_counts(saved)
    plain_ms = cuda_ms(lambda: tl.twolevel_plain(idx, L8, Lf, LO, HI), 2)
    n, p8 = idx.shape[0], L8.shape[0]
    pf = 0 if Lf is None else Lf.shape[0]
    # bytes: slot id, p8 int8 and pf float32 values per row read once, the
    # int64/float64 states written once; ops: one add per plane and row
    out = {"ms": ms, "plain_ms": plain_ms,
           **bound_ms(n * (4 + p8 + 4 * pf) + 8 * HI * LO * (p8 + pf),
                      n * (p8 + pf))}
    # yardstick only (the port never calls it): one index_add_ of the
    # stacked int64 planes into (p8, slots) along dim 1
    idx64, L64 = idx.to(torch.int64), L8.to(torch.int64)
    out["library_ms"] = cuda_ms(lambda: torch.zeros(
        p8, HI * LO, dtype=torch.int64, device=dev).index_add_(
            1, idx64, L64), 5)
    del idx64, L64
    out["max_abs_err"] = err
    name, cs = tl.route(p8, pf, LO, HI, "planes", dev)
    print(f"kernel twolevel at {label} ({n} rows, p8={p8} pf={pf} LO={LO} "
          f"HI={HI}, route={name}{cs if cs > 1 else ''}): " +
          " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    return out


def twolevel_at_main_shapes(runner, dev) -> tuple:
    """→ (largest difference, config 4n timing with the route per
    config)."""
    worst, timing, routes = 0.0, None, {}
    for config in ("4n", "4w", "4r"):
        args, kwargs = captured_inputs(config, runner, "twolevel_fused")
        out = time_fused(config, args, kwargs, dev)
        worst = max(worst, out.pop("max_abs_err"))
        routes[config] = out.pop("table_route")
        if config == "4n":
            timing = out
        del args, kwargs
        gc.collect()
    for name in PROTOTYPES:
        idx, L8, LO, HI, _k, _v = prototype_inputs(name, dev)
        out = time_twolevel(f"{name} shape", idx, L8, None, LO, HI, dev)
        worst = max(worst, out["max_abs_err"])
        del idx, L8
        gc.collect()
    timing["table_routes"] = routes
    return worst, timing


def fold_bytes(kw: dict) -> int:
    """Bytes the fold must move: the key (or slot ids), the selection and
    each distinct lane's values and validity read once over rows [0, n),
    the state buffer written once."""
    from tikv_tpu_torch.device import agg_fold as af
    plan = af.plan_fold(kw["specs"], kw["cols"], kw["mode"])
    n = kw["n"]
    planes = [kw.get("key"), kw.get("key_ok"), kw.get("slot_ids"),
              kw.get("mask")] + [t for ln in plan.lanes
                                 for t in (ln.values, ln.ok)]
    slots = 1 if kw["mode"] == "simple" else kw["capacity"] + 2
    return sum(n * t.element_size() for t in planes if t is not None) + \
        8 * (1 + len(plan.rows) * slots)


def fold_at_main_shapes(runner, dev) -> tuple:
    """agg_fold at configs 4m and 3n on the runner's own arguments, against
    its plain version and timed beside its bound, its plain version and a
    yardstick; → (largest difference, config 4m's timing with 3n's under
    ``configs``)."""
    from tikv_tpu_torch.device import agg_fold as af
    worst, timings = 0.0, {}
    for config in ("4m", "3n"):
        (specs, cols, n, mode), kw = captured_inputs(config, runner,
                                                     "agg_fold")
        kw = dict(specs=specs, cols=cols, n=n, mode=mode,
                  **{k: v for k, v in kw.items() if k != "device"})
        saved = counts()
        err = fold_err(kw, dev)
        slots = 1 if kw["mode"] == "simple" else kw["capacity"] + 2
        route = af.route(kw["specs"], kw["cols"], kw["mode"], slots, dev,
                         kw.get("value_bound"))
        ms = cuda_ms(lambda: af.agg_fold(**kw, device=dev), 20, queued=True)
        peak = peak_bytes(lambda: af.agg_fold(**kw, device=dev))
        set_counts(saved)
        plain_ms = cuda_ms(lambda: af.agg_fold_plain(**kw, device=dev), 3)
        plan = af.plan_fold(kw["specs"], kw["cols"], kw["mode"])
        n = kw["n"]
        # ops: a slot and one update per state row and row
        out = {"ms": ms, "plain_ms": plain_ms,
               **bound_ms(fold_bytes(kw), n * len(plan.rows)),
               "rows": n, "slots": slots, "state_rows": len(plan.rows),
               "lanes": len(plan.lanes), "fold_route": route,
               "peak_bytes": peak}
        # yardstick only (the port never calls it, and no one PyTorch call
        # computes the fold): one scatter_reduce_ (amax) of the same values
        # over the same keys (slot 0 for 3n's single group)
        v = plan.lanes[0].values[:n]
        index = torch.zeros(n, dtype=torch.int64, device=dev) \
            if kw["mode"] == "simple" else \
            (kw["key"][:n].to(torch.int64) - kw.get("base", 0))
        out["library_ms"] = cuda_ms(lambda: torch.full(
            (slots,), -(1 << 31), dtype=v.dtype, device=dev).scatter_reduce_(
                0, index, v, reduce="amax"), 10)
        out["library_call"] = "scatter_reduce_ amax (yardstick)"
        out["max_abs_err"] = err
        worst = max(worst, err)
        timings[config] = out
        print(f"kernel agg_fold at config {config} shape ({n} rows): " +
              " ".join(f"{k}={x}" for k, x in out.items()), flush=True)
        del kw, v, index
        gc.collect()
    timing = {k: x for k, x in timings["4m"].items()
              if k not in ("max_abs_err",)}
    timing["configs"] = timings
    return worst, timing


# ---------------------------------------------------------------------------
# selection and top-k kernels against their plain versions
# ---------------------------------------------------------------------------

def mask_equal(got, want) -> bool:
    """sel_mask outputs: the count, the packed region and the per-block
    counts (the header's pad bytes are not outputs)."""
    return bool(got.count == want.count) and \
        torch.equal(got.packed, want.packed) and \
        torch.equal(got.block_counts, want.block_counts)


def selection_cases(dev):
    """(name, pred, n, [(k_cap, planes), ...]) on the card: the CPU
    tests' edge cases and config 2's size."""
    g = torch.Generator(device="cpu").manual_seed(14)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def plane(dtype, count):
        if dtype == torch.bool:
            return bools(0.5, count)
        if dtype == torch.float64:
            return torch.randn(count, generator=g, dtype=dtype).to(dev)
        return torch.randint(-(1 << 30), 1 << 30, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    for n in (1, 7, 8, 9, 4095, 32767, 32768, 32769, (1 << 20) + 3):
        pred = bools(0.3, n)
        planes = [plane(d, n) for d in (torch.int32, torch.int64,
                                         torch.float64, torch.bool)]
        yield f"n={n}", pred, n, [(64, ()), (1 << 21, ()), (64, planes),
                                  (1 << 21, planes)]
    n = 100_003
    yield "all_false", torch.zeros(n, dtype=torch.bool, device=dev), n, \
        [(64, ()), (64, [plane(torch.int32, n)])]
    yield "all_true", torch.ones(n, dtype=torch.bool, device=dev), n, \
        [(64, ()), (1 << 17, ()), (1 << 17, [plane(torch.int64, n)])]
    base = bools(0.5, n + 16)
    yield "pred_off_16_bytes", base[3:], n, [(1 << 16, ())]
    big = SWEEP_ROWS
    pred = bools(0.1, big)
    yield f"config_2_size_{big}", pred, big, [
        (1 << 17, ()), (1 << 21, ()), (1 << 14, [plane(torch.int32, big)])]


PRED_CMPS = ("Gt", "Ge", "Lt", "Le", "Eq", "Ne", "NullEq")


def pred_spec(rng, depth: int, kind: str = "bool"):
    """A random predicate over columns a (int32), b (int64), r (float32),
    nested up to ``depth``, as a nested tuple (see ``pred_tree``)."""
    if kind == "int" or kind == "real":
        real = kind == "real"
        if depth <= 0 or rng.random() < 0.4:
            roll = rng.random()
            if roll < 0.55:
                return ("col", 2 if real else int(rng.integers(0, 2)))
            if roll < 0.95:
                return ("const", float(rng.integers(-400, 400)) / 4.0
                        if real else int(rng.integers(-120, 120)))
            return ("null", kind)
        t = "Real" if real else "Int"
        if rng.random() < 0.8:
            return (str(rng.choice(["Plus", "Minus", "Multiply"])) + t,
                    pred_spec(rng, depth - 1, kind),
                    pred_spec(rng, depth - 1, kind))
        return ("UnaryMinus" + t, pred_spec(rng, depth - 1, kind))
    sub = "real" if rng.random() < 0.35 else "int"
    t = "Real" if sub == "real" else "Int"
    roll = rng.random()
    if depth <= 1 or roll < 0.45:
        return (str(rng.choice(PRED_CMPS)) + t,
                pred_spec(rng, depth - 1, sub),
                pred_spec(rng, max(depth - 2, 0), sub))
    if roll < 0.7:
        return (str(rng.choice(["LogicalAnd", "LogicalOr", "LogicalXor"])),
                pred_spec(rng, depth - 1), pred_spec(rng, depth - 1))
    if roll < 0.85:
        return (str(rng.choice(["UnaryNot", "IsNull"])) + t,
                pred_spec(rng, depth - 1, sub))
    if roll < 0.93:
        return (t + str(rng.choice(["IsTrue", "IsFalse"])),
                pred_spec(rng, depth - 1, sub))
    items = [("const", float(rng.integers(-400, 400)) / 4.0 if sub == "real"
              else int(rng.integers(-100, 100)))
             for _ in range(int(rng.integers(1, 6)))]
    if rng.random() < 0.2:
        items.append(("null", sub))
    return ("In" + t, pred_spec(rng, 1, sub), *items)


def pred_tree(spec):
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.expr import Expr
    kind = spec[0]
    if kind == "col":
        return Expr.column(spec[1], EvalType.REAL if spec[1] == 2
                           else EvalType.INT)
    if kind == "const":
        return Expr.const(spec[1], EvalType.REAL if isinstance(
            spec[1], float) else EvalType.INT)
    if kind == "null":
        return Expr.null(EvalType.REAL if spec[1] == "real" else EvalType.INT)
    return Expr.call(kind, *[pred_tree(c) for c in spec[1:]])


def pred_cases(dev):
    """(name, program, planes, n, bools) on the card: random predicates
    nested two or three deep (every covered signature among them) over
    NULL-bearing int32 (with its extremes), int64 and float32 planes, at
    ragged sizes, on and off a 16-byte boundary, and the predicates of
    configs 1, 2, 2s and 5t at config 2's 10·2^20 rows."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.expr.eval import narrow_int32
    rng = np.random.default_rng(21)
    for n in (1, 17, 4095, 32769, (1 << 20) + 3):
        a = rng.integers(-100, 100, n + 4).astype(np.int32)
        a[rng.choice(n + 4, min(n + 4, 8), replace=False)] = rng.choice(
            [-(1 << 31), 1 - (1 << 31), (1 << 31) - 1], min(n + 4, 8))
        b = rng.integers(-(1 << 33), 1 << 33, n + 4)
        b[: (n + 4) // 3] = rng.integers(-100, 100, (n + 4) // 3)
        r = (rng.integers(-400, 400, n + 4) / 4.0).astype(np.float32)
        cols = []
        for v in (a, b, r):
            ok = rng.random(n + 4) > 0.15
            cols.append((torch.from_numpy(np.where(ok, v, 0).astype(
                v.dtype)).to(dev), torch.from_numpy(ok).to(dev)))
        bounds = [(int(a.min()), int(a.max())), (int(b.min()), int(b.max())),
                  None]
        for off in (0, 1):
            planes = [(v[off:], ok[off:]) for v, ok in cols]
            dts = [v.dtype for v, _ok in planes]
            made = 0
            while made < 8:
                specs = [pred_spec(rng, int(rng.integers(2, 4)))
                         for _ in range(int(rng.integers(1, 3)))]
                rpns = [build_rpn(pred_tree(sp)) for sp in specs]
                if sm.pred_covered(rpns):
                    continue
                if made % 2:
                    rpns = [narrow_int32(rp, bounds) for rp in rpns]
                made += 1
                yield (f"random_n={n}_off={off}_{made}",
                       sm.encode_predicate(rpns, dts), planes, n,
                       bool(made % 3))
    n = SWEEP_ROWS
    v = torch.randint(-1000, 1000, (n,), generator=torch.Generator()
                      .manual_seed(3), dtype=torch.int32).to(dev)
    for name, e, bools in (
            ("config_1", Expr.column(0) > Expr.const(-10 ** 9, EvalType.INT),
             False),
            ("config_2", Expr.column(0) > Expr.const(800, EvalType.INT),
             False),
            ("config_2s_0.1%", Expr.column(0) > Expr.const(997,
                                                           EvalType.INT),
             False),
            ("config_5t", Expr.column(0) < Expr.const(512, EvalType.INT),
             True)):
        yield name, sm.encode_predicate([build_rpn(e)], [torch.int32]), \
            [(v, None)], n, bools


def check_pred(dev) -> int:
    """sel_pred against its plain version (the same program run op by op in
    torch on the card): count, packed mask, block counts and bool mask
    equal bit for bit.  → 0 or raises."""
    from tikv_tpu_torch.device import selection as sm
    cases = 0
    for name, prog, planes, n, bools in pred_cases(dev):
        got, got_b = sm.sel_pred(prog, planes, n, bools)
        torch.cuda.synchronize()
        want, want_b = sm.sel_pred_plain(prog, planes, n, bools)
        assert mask_equal(got, want), f"sel_pred {name} disagrees"
        assert (got_b is None) == (not bools)
        if bools:
            assert torch.equal(got_b, want_b), f"sel_pred {name} bools"
        cases += 1
        if name.startswith("config") or cases % 16 == 0:
            print(f"kernel sel_pred {name}: ops={len(prog.ops)} "
                  f"depth={prog.depth} count={int(got.count)} "
                  f"bools={bools} max_abs_err=0", flush=True)
    print(f"kernel sel_pred: {cases} cases equal to the plain version",
          flush=True)
    gc.collect()
    return 0


def relane(spec, rng, wide: bool = False):
    """``spec`` with every constant redrawn (one lane of a stacked group:
    the same program, other constants of the same device dtype)."""
    if spec[0] == "const":
        v = spec[1]
        if isinstance(v, float):
            return ("const", float(rng.integers(-400, 400)) / 4.0)
        if wide:
            return ("const", int(rng.integers(-(1 << 40), 1 << 40)))
        if abs(v) >= 1 << 30:
            return ("const", int(rng.choice([-(1 << 31), 1 - (1 << 31), -1,
                                             0, (1 << 31) - 2,
                                             (1 << 31) - 1])))
        return ("const", int(rng.integers(-120, 120)))
    if spec[0] in ("col", "null"):
        return spec
    return (spec[0], *[relane(c, rng, wide) for c in spec[1:]])


def lane_programs(specs, G: int, rng, dts, wide: bool = False) -> list:
    """G programs of ``specs``: lanes 0 and 1 equal, the rest redrawn."""
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import build_rpn
    out = []
    for g in range(G):
        lane = specs if g < 2 else [relane(sp, rng, wide) for sp in specs]
        out.append(sm.encode_predicate(
            [build_rpn(pred_tree(sp)) for sp in lane], dts))
    return out


def batched_cases(dev):
    """(name, programs, planes, n) on the card: G of 1, 2, 3, 16 and the
    lane limit over NULL-bearing int32 (with its extremes), int64 and
    float32 planes; random programs, an int32-extremes comparison, a wide
    (int64 constants) range and a REAL comparison; equal and different
    lanes; n not a multiple of 8, planes off a 16-byte boundary, one block
    and many."""
    from tikv_tpu_torch.device import selection as sm
    rng = np.random.default_rng(41)
    fixed = {"extremes": [("GeInt", ("col", 0), ("const", (1 << 31) - 1))],
             "wide": [("LogicalAnd",
                       ("GeInt", ("col", 1), ("const", -(1 << 40))),
                       ("LtInt", ("col", 1), ("const", 1 << 39)))],
             "real": [("GtReal", ("col", 2), ("const", 12.25))],
             "range": [("GeInt", ("col", 0), ("const", -50)),
                       ("LtInt", ("col", 0), ("const", 50))],
             "null_const": [("NeInt", ("col", 0), ("null", "int"))]}
    for n in (1, 13, 4099, 32768, 32769, (1 << 20) + 3, SWEEP_ROWS):
        a = rng.integers(-100, 100, n + 4).astype(np.int32)
        a[rng.choice(n + 4, min(n + 4, 8), replace=False)] = rng.choice(
            [-(1 << 31), 1 - (1 << 31), (1 << 31) - 1], min(n + 4, 8))
        b = rng.integers(-(1 << 41), 1 << 41, n + 4)
        r = (rng.integers(-400, 400, n + 4) / 4.0).astype(np.float32)
        cols = []
        for v in (a, b, r):
            ok = rng.random(n + 4) > 0.15
            cols.append((torch.from_numpy(np.where(ok, v, 0).astype(
                v.dtype)).to(dev), torch.from_numpy(ok).to(dev)))
        big = n >= 1 << 20
        for off in ((0,) if big else (0, 1)):
            planes = [(v[off:], ok[off:]) for v, ok in cols]
            if off == 0 and n == 4099:
                planes[0] = (planes[0][0], None)     # a plane without NULLs
            dts = [v.dtype for v, _ok in planes]
            for G in ((1, 16, sm.BATCH_MAX_LANES) if big else
                      (1, 2, 3, 16, sm.BATCH_MAX_LANES)):
                for kind, specs in fixed.items():
                    yield (f"{kind}_n={n}_off={off}_G={G}",
                           lane_programs(specs, G, rng, dts,
                                         wide=kind == "wide"), planes, n)
                made = 0
                while made < (1 if big else 3):
                    specs = [pred_spec(rng, int(rng.integers(2, 4)))
                             for _ in range(int(rng.integers(1, 3)))]
                    try:
                        progs = lane_programs(specs, G, rng, dts)
                        sm.check_lanes(progs)
                    except (sm.Uncovered, sm.LanesDiffer):
                        continue     # past the limits, or a width changed
                    made += 1
                    yield f"random_n={n}_off={off}_G={G}_{made}", progs, \
                        planes, n


def check_batched(dev) -> int:
    """sel_pred_batched against its plain version (the whole output
    buffer, bit for bit) and against G solo sel_pred launches (each lane's
    count and packed mask).  → 0 or raises."""
    from tikv_tpu_torch.device import selection as sm
    cases = 0
    simple = 0
    for name, progs, planes, n in batched_cases(dev):
        simple += sm.simple_terms(progs[0])
        got = sm.sel_pred_batched(progs, planes, n)
        torch.cuda.synchronize()
        want = sm.sel_pred_batched_plain(progs, planes, n)
        assert torch.equal(got.buf, want.buf), \
            f"sel_pred_batched {name} disagrees with its plain version"
        for g, q in enumerate(progs):
            solo = sm.sel_pred(q, planes, n)[0]
            assert bool(got.counts[g] == solo.count) and torch.equal(
                got.packed(g), solo.packed), \
                f"sel_pred_batched {name} lane {g} disagrees with sel_pred"
        cases += 1
        if cases % 12 == 0 or n >= 1 << 20:
            print(f"kernel sel_pred_batched {name}: ops={len(progs[0].ops)} "
                  f"wide={progs[0].wide} "
                  f"simple={sm.simple_terms(progs[0])} counts="
                  f"{got.counts[:4].tolist()} max_abs_err=0", flush=True)
    print(f"kernel sel_pred_batched: {cases} cases ({simple} of simple "
          f"terms) equal to the plain version and to solo sel_pred",
          flush=True)
    assert 0 < simple < cases, "both evaluations must be taken"
    gc.collect()
    return 0


def batched_at_main_shape(dev) -> dict:
    """sel_pred_batched at cell 6b-ep's shape (10·2^20 int32 rows of c1,
    G = 16 thresholds of its palette), exact against its plain version and
    timed beside its bound (the plane read once, G packed masks and G
    counts written once), its plain version, the 16 solo sel_pred launches
    it replaces, and one broadcast torch.gt of the plane against the (G, 1)
    thresholds (a yardstick the port never calls); and the same masks from
    programs that take its interpreter (``NOT (c1 <= thr)``)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    n, G = SWEEP_ROWS, 16
    h = np.arange(n, dtype=np.int64) * 2654435761 % (1 << 32)
    c1 = torch.from_numpy((h % 1000).astype(np.int32)).to(dev)
    thrs = [980 + (g % 16) for g in range(G)]
    progs = [sm.encode_predicate(
        [build_rpn(Expr.column(0) > Expr.const(t, EvalType.INT))],
        [torch.int32]) for t in thrs]
    # the same masks through the interpreter: NOT (c1 <= thr) is no
    # simple term
    interp = [sm.encode_predicate([build_rpn(Expr.call(
        "UnaryNotInt", Expr.column(0) <= Expr.const(t, EvalType.INT)))],
        [torch.int32]) for t in thrs]
    assert all(sm.simple_terms(q) for q in progs) and \
        not any(sm.simple_terms(q) for q in interp)
    planes = [(c1, None)]
    saved = counts()
    got = sm.sel_pred_batched(progs, planes, n)
    assert torch.equal(got.buf, sm.sel_pred_batched_plain(
        progs, planes, n).buf), "sel_pred_batched disagrees at 6b-ep"
    assert torch.equal(got.buf, sm.sel_pred_batched(interp, planes, n).buf)
    thr_t = torch.tensor(thrs, dtype=torch.int32, device=dev)[:, None]
    t = {"ms": cuda_ms(lambda: sm.sel_pred_batched(progs, planes, n), 50,
                       queued=True),
         "interpreter_ms": cuda_ms(lambda: sm.sel_pred_batched(
             interp, planes, n), 50, queued=True),
         "plain_ms": cuda_ms(lambda: sm.sel_pred_batched_plain(
             progs, planes, n), 3),
         "solo_ms": cuda_ms(lambda: [sm.sel_pred(q, planes, n)
                                     for q in progs], 20, queued=True),
         "library_ms": cuda_ms(lambda: torch.gt(c1, thr_t), 50),
         "library_call": "torch.gt of the plane against the (G, 1) "
                         "thresholds (yardstick)",
         **bound_ms(4 * n + G * -(-n // 8) + 8 * G, G * n),
         "rows": n, "lanes": G,
         "selected": got.counts.tolist(),
         "peak_bytes": peak_bytes(lambda: sm.sel_pred_batched(
             progs, planes, n))}
    set_counts(saved)
    print(f"kernel sel_pred_batched at 6b-ep shape ({n} rows, G={G}): "
          f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
          flush=True)
    return t


def check_selection(dev) -> tuple:
    """→ (largest difference of sel_mask, of sel_compact): 0 or raises."""
    from tikv_tpu_torch.device import selection as sm
    for name, pred, n, compacts in selection_cases(dev):
        got = sm.sel_mask(pred, n)
        torch.cuda.synchronize()
        want = sm.sel_mask_plain(pred, n)
        assert mask_equal(got, want), f"sel_mask {name} disagrees"
        for k_cap, planes in compacts:
            c_got = sm.sel_compact(got, k_cap, planes)
            torch.cuda.synchronize()
            c_want = sm.sel_compact_plain(want, k_cap, planes)
            assert torch.equal(c_got.buf, c_want.buf), \
                f"sel_compact {name} k_cap={k_cap} disagrees"
            print(f"kernel sel_compact {name} k_cap={k_cap} planes="
                  f"{[str(t.dtype) for t in planes]}: count="
                  f"{int(c_got.count)} overflow={int(c_got.overflow)} "
                  f"max_abs_err=0", flush=True)
        print(f"kernel sel_mask {name}: count={int(got.count)} "
              f"max_abs_err=0", flush=True)
    gc.collect()
    return 0, 0


def topn_cases(dev):
    """(name, keyword arguments of topn_select) on the card."""
    from tikv_tpu_torch.device import topn as tn
    g = torch.Generator(device="cpu").manual_seed(15)

    def bools(p, count):
        return (torch.rand(count, generator=g) < p).to(dev)

    def values(dtype, count, lo=-1000, hi=1000):
        if dtype == torch.float64:
            return (torch.randn(count, generator=g, dtype=dtype) * 1000
                    ).to(dev)
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def case(vals, n, k, desc=True, ok=None, mask=None, n_pad=None,
             bounds="data"):
        """``bounds``: "data" (the valid values' least and greatest, as the
        runner passes a bare column's), a pair, or None (the default
        placement)."""
        n_used, seglen = tn.segments(n, n_pad or -(-n // (1 << 18)) * (1 << 18))
        if bounds == "data":
            live = vals[:n] if ok is None else vals[:n][ok[:n]]
            bounds = (live.min().item(), live.max().item()) \
                if live.numel() else None
        return dict(values=vals, ok=ok, mask=mask, desc=desc, n=n,
                    n_used=n_used, seglen=seglen, k=k,
                    placement=tn.digit_placement(vals.dtype, desc, bounds))

    n = 5 * (1 << 17) + 777
    for dtype in (torch.int32, torch.int64, torch.float64):
        for desc in (True, False):
            d = "desc" if desc else "asc"
            v = values(dtype, n)
            yield f"{dtype}_{d}", case(v, n, 1000, desc)
            yield f"{dtype}_{d}_nulls_selection", case(
                v, n, 1000, desc, ok=bools(0.9, n), mask=bools(0.5, n))
    yield "small_n", case(values(torch.float64, 1000), 1000, 10)
    yield "limit_past_live_rows", case(values(torch.int32, n), n, 1000,
                                       mask=bools(1e-4, n))
    yield "limit_16384", case(values(torch.float64, n), n, 1 << 14, False,
                              ok=bools(0.7, n))
    ext = torch.tensor([-(1 << 63), -(1 << 63) + 1, -(1 << 63) + 2,
                        (1 << 63) - 1, (1 << 63) - 2, 0, -1], dtype=torch.int64,
                       device=dev)
    idx = torch.randint(0, 7, (n,), generator=g).to(dev)
    for desc in (True, False):
        yield f"int64_extremes_{'desc' if desc else 'asc'}", case(
            ext[idx], n, 1000, desc, ok=bools(0.95, n))
    zeros = torch.tensor([0.0, -0.0, 1.0, -1.0], dtype=torch.float64,
                         device=dev)[torch.randint(0, 4, (n,),
                                                   generator=g).to(dev)]
    yield "minus_zero_ties_zero", case(zeros, n, 1 << 14)
    big = 10 << 20
    tied = torch.full((big,), 1.5, dtype=torch.float64, device=dev)
    for desc in (True, False):
        d = "desc" if desc else "asc"
        yield f"10M_tied_keys_{d}", case(tied, big, 1000, desc)
        yield f"10M_null_keys_{d}", case(
            tied, big, 1000, desc,
            ok=torch.zeros(big, dtype=torch.bool, device=dev))
    # the common route's buffer: a crossing bin of exactly its rows, and
    # one row more (one value per bin: bounds (0, 1000))
    cap = tn.cand_capacity(1000)
    n = 3 << 20
    for extra, label in ((0, "at"), (1, "one_past")):
        v = torch.zeros(n, dtype=torch.int32, device=dev)
        v[torch.randperm(n, generator=g)[:cap + extra].to(dev)] = 1000
        yield f"crossing_bin_{label}_the_buffer", case(v, n, 1000)
    # narrow int32 keys: with their bounds one value per bin (common); with
    # the default placement a few bins hold every row (overflow)
    n = 1 << 22
    v = values(torch.int32, n, -100, 100)
    for desc in (True, False):
        d = "desc" if desc else "asc"
        yield f"narrow_int32_{d}_with_bounds", case(v, n, 1000, desc)
        yield f"narrow_int32_{d}_default_placement", case(v, n, 1000, desc,
                                                          bounds=None)
    yield "misaligned_planes", case(
        values(torch.float64, n + 3)[3:], n, 1000,
        ok=bools(0.9, n + 1)[1:], mask=bools(0.7, n + 2)[2:])


def check_topn(dev) -> int:
    """Every case equal to the plain version, the route the kernel took
    equal to ``plan_route``'s, and both routes taken."""
    from tikv_tpu_torch.device import topn as tn
    routes = set()
    for name, kw in topn_cases(dev):
        passes = torch.zeros(2, dtype=torch.int64, device=dev)
        got = tn.topn_select(**kw, passes=passes)
        torch.cuda.synchronize()
        want = tn.topn_plain(kw["values"], kw["ok"], kw["mask"], kw["desc"],
                             kw["n"], kw["n_used"], kw["k"])
        assert torch.equal(got, want), f"topn_select {name} disagrees"
        route, _bin, cands = tn.plan_route(
            kw["values"], kw["ok"], kw["mask"], kw["desc"], kw["n"],
            kw["n_used"], kw["k"], kw["placement"])
        took = (tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW)[int(passes[1])]
        assert took == route, f"topn_select {name} took {took}, not {route}"
        routes.add(took)
        print(f"kernel topn_select {name}: n={kw['n']} k={kw['k']} "
              f"live={int((got[1] & 1).sum())} route={took} "
              f"candidates={cands} reads_per_row={int(passes[0]) / kw['n']} "
              f"max_abs_err=0", flush=True)
    assert routes == {tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW}, routes
    gc.collect()
    return 0


# ---------------------------------------------------------------------------
# agg_fold against its plain version
# ---------------------------------------------------------------------------

FOLD_KINDS = ("count", "count_star", "sum", "avg", "min", "max", "var_pop",
              "var_samp", "stddev_pop", "stddev_samp")


def fold_mag(kw: dict, dev):
    """The plain fold over |v| (each distinct values tensor replaced by one
    tensor of its magnitudes, so the lanes stay the same): per float64
    cell the Σ|v| its tolerance scales with."""
    from tikv_tpu_torch.device import agg_fold as af
    absolute: dict = {}

    def mag(t):
        if t.data_ptr() not in absolute:
            absolute[t.data_ptr()] = t.abs()
        return absolute[t.data_ptr()]

    cols = [None if c is None else (mag(c[0]), c[1]) for c in kw["cols"]]
    return af.agg_fold_plain(**dict(kw, cols=cols), device=dev)


def fold_err(kw: dict, dev) -> float:
    """agg_fold against its plain version: every integer, MIN/MAX, FIRST
    and count row bit-equal (MIN/MAX images fold -0.0 into +0.0 on both
    sides), the float64 sums within SF_TOL·Σ|v| of their cell.  Returns
    the largest difference."""
    from tikv_tpu_torch.device import agg_fold as af
    got = af.agg_fold(**kw, device=dev)
    torch.cuda.synchronize()
    want = af.agg_fold_plain(**kw, device=dev)
    assert got.plan.rows == want.plan.rows
    S = got.n_slots
    g, w = got.buf[1:].view(-1, S), want.buf[1:].view(-1, S)
    assert int(got.buf[0]) == int(want.buf[0]), "agg_fold overflow flag"
    floats = [r for r, (state, _j) in enumerate(got.plan.rows)
              if state in ("fsum", "sumsq")]
    ints = [r for r in range(len(got.plan.rows)) if r not in floats]
    assert torch.equal(g[ints], w[ints]), "agg_fold integer states disagree"
    if not floats:
        return 0.0
    m = fold_mag(kw, dev).buf[1:].view(-1, S)[floats].view(torch.float64)
    diff = (g[floats].view(torch.float64) - w[floats].view(torch.float64)
            ).abs()
    assert bool((diff <= SF_TOL * m).all()), \
        "agg_fold float64 sums beyond tolerance"
    print(f"  float64 sums: largest difference over its cell's Σ|v| "
          f"{float((diff / m.clamp(min=1e-300)).max())}", flush=True)
    return float(diff.max())


def agg_fold_cases(dev):
    """(name, agg_fold keyword arguments) on the card: every state kind
    and value dtype, NULLs, selections, dense / sparse / simple slots at
    1026, 65,538 and 2^20 + 2 slots, the overflow flag, hot slots over
    2^24 rows, int32 extremes, ragged n and misaligned planes."""
    from tikv_tpu_torch.ops.agg import AggSpec
    g = torch.Generator(device="cpu").manual_seed(16)
    n = 1 << 18

    def bools(p, count=n):
        return (torch.rand(count, generator=g) < p).to(dev)

    def col(dtype, count=n, lo=-1000, hi=1000):
        if dtype.is_floating_point:
            return (torch.randn(count, generator=g, dtype=torch.float64)
                    * 1000).to(dtype).to(dev)
        return torch.randint(lo, hi, (count,), generator=g,
                             dtype=torch.int64).to(dtype).to(dev)

    def spec_cols(kinds, v, ok, real):
        from tikv_tpu_torch.datatype import EvalType
        et = EvalType.REAL if real else EvalType.INT
        specs = [AggSpec(k, i, et) for i, k in enumerate(kinds)]
        return specs, [None if k == "count_star" else (v, ok) for k in kinds]

    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        v, ok = col(dtype), bools(0.85)
        specs, cols = spec_cols(FOLD_KINDS, v, ok, dtype.is_floating_point)
        for slots in (1026, 65538, (1 << 20) + 2):
            cap = slots - 2
            for mask_kind in ("none", "partial", "all_false"):
                mask = {"none": None, "partial": bools(0.7),
                        "all_false": torch.zeros(n, dtype=torch.bool,
                                                 device=dev)}[mask_kind]
                key = (-300 + torch.randint(0, cap, (n,), generator=g)
                       ).to(dev)
                yield (f"{dtype}_dense_slots={slots}_{mask_kind}", dict(
                    specs=specs, cols=cols, n=n, mode="dense",
                    key=key.to(torch.int32), key_ok=bools(0.95), base=-300,
                    capacity=cap, mask=mask))
            yield f"{dtype}_sparse_slots={slots}", dict(
                specs=specs, cols=cols, n=n, mode="sparse",
                slot_ids=torch.randint(0, slots, (n,), generator=g).to(
                    torch.int32).to(dev), capacity=cap, mask=bools(0.6))
        fspecs, fcols = spec_cols(FOLD_KINDS + ("first",), v, ok,
                                  dtype.is_floating_point)
        yield f"{dtype}_simple", dict(specs=fspecs, cols=fcols, n=n,
                                      mode="simple", mask=bools(0.5))
        yield f"{dtype}_simple_no_validity", dict(
            specs=fspecs, cols=[None if c is None else (v, None)
                                for c in fcols], n=n, mode="simple")
    # FIRST where the first selected row is NULL, and the first tiles'
    # selected rows all NULL (the answer is NULL, not a later row's value)
    for dtype in (torch.int32, torch.float64):
        v, ok, mask = col(dtype), bools(0.85), bools(0.5)
        ok[:8192] = False
        mask[:3] = False
        fspecs, fcols = spec_cols(("first", "count", "count_star"), v, ok,
                                  dtype.is_floating_point)
        yield f"{dtype}_simple_first_null", dict(
            specs=fspecs, cols=fcols, n=n, mode="simple", mask=mask)
    # two lanes sharing a values plane, an int64 key, and the overflow flag
    v, a, b = col(torch.int32), bools(0.6), bools(0.3)
    specs = [AggSpec("min", 0), AggSpec("sum", 1), AggSpec("var_pop", 2),
             AggSpec("max", 3), AggSpec("count_star", 4)]
    cols = [(v, a), (v, b), (v, a), (v, None), None]
    key = (torch.randint(0, 1024, (n,), generator=g) + (1 << 40)).to(dev)
    key[:5] = (1 << 40) + 5000                  # live keys out of range
    yield "shared_values_int64_key_overflow", dict(
        specs=specs, cols=cols, n=n, mode="dense", key=key, base=1 << 40,
        capacity=1024)
    # hot slots over 2^24 rows at the int32 extremes
    hot = 1 << 24
    ext = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                       device=dev)[torch.randint(0, 2, (hot,), generator=g)
                                   .to(dev)]
    ext[: hot // 2] = 2**31 - 1
    specs, cols = spec_cols(("sum", "min", "max", "var_pop", "count"), ext,
                            bools(0.5, hot), False)
    for slots in (1026, 65538):
        yield f"hot_slot_int32_extremes_{hot}_rows_slots={slots}", dict(
            specs=specs, cols=cols, n=hot, mode="dense",
            key=torch.full((hot,), 7, dtype=torch.int32, device=dev),
            base=0, capacity=slots - 2)
    # the same rows spread over 1024 slots, the bound given (2^31)
    yield f"int32_extremes_{hot}_rows_bound=2^31", dict(
        specs=specs, cols=cols, n=hot, mode="dense",
        key=torch.randint(0, 1024, (hot,), generator=g).to(
            torch.int32).to(dev), capacity=1024, value_bound=1 << 31)
    sspecs, scols = spec_cols(("sum", "min", "max", "first", "avg"), ext,
                              bools(0.5, hot), False)
    yield f"simple_int32_extremes_{hot}_rows", dict(
        specs=sspecs, cols=scols, n=hot, mode="simple")
    del ext
    # value bounds that shrink the shared route's cells: one signed sum
    # cell and one v² cell (|v| <= 300), one sum cell and two limbs (|v| <=
    # 1000, 4m's), the split sum and four limbs (the int32 extremes)
    for lo, bound in ((-300, 300), (-1000, 1000)):
        vb = col(torch.int32, lo=lo, hi=bound + 1)
        vb[:2] = torch.tensor([lo, bound], dtype=torch.int32)
        specs, cols = spec_cols(FOLD_KINDS, vb, bools(0.9), False)
        for slots in (1026, 4098):
            yield f"int32_bound={bound}_slots={slots}", dict(
                specs=specs, cols=cols, n=n, mode="dense",
                key=torch.randint(0, slots - 2, (n,), generator=g).to(
                    torch.int32).to(dev), capacity=slots - 2,
                mask=bools(0.8), value_bound=bound)
        yield f"int32_bound={bound}_hot_slot", dict(
            specs=specs, cols=cols, n=n, mode="dense",
            key=torch.full((n,), 3, dtype=torch.int32, device=dev),
            capacity=1024, value_bound=bound)
        yield f"int32_bound={bound}_simple", dict(
            specs=specs, cols=cols, n=n, mode="simple", value_bound=bound)
    # ragged n and planes 1-3 elements off a 16-byte boundary
    big = col(torch.float32, n + 8)
    ks = torch.randint(0, 1024, (n + 8,), generator=g).to(torch.int32).to(dev)
    okb, mb = bools(0.8, n + 8), bools(0.7, n + 8)
    for off in (1, 2, 3):
        specs, cols = spec_cols(FOLD_KINDS, big[off:], okb[4 - off:], True)
        for count in (n - 5, 4097, 3, 1):
            yield f"off_by_{off}_n={count}", dict(
                specs=specs, cols=cols, n=count, mode="dense",
                key=ks[off:], base=0, capacity=1024, mask=mb[off:])


def check_agg_fold(dev) -> float:
    from tikv_tpu_torch.device import agg_fold as af
    worst, routes = 0.0, set()
    for name, kw in agg_fold_cases(dev):
        err = fold_err(kw, dev)
        route = af.route(kw["specs"], kw["cols"], kw["mode"],
                         1 if kw["mode"] == "simple" else kw["capacity"] + 2,
                         dev, kw.get("value_bound"))
        routes.add(route)
        print(f"kernel agg_fold {name}: route={route} max_abs_err={err} "
              f"(integer, MIN/MAX, FIRST states exact; float64 sums within "
              f"{SF_TOL}·Σ|v|)", flush=True)
        worst = max(worst, err)
    assert routes == {af.ROUTE_SHARED, af.ROUTE_GLOBAL,
                      af.ROUTE_REGISTERS}, routes
    gc.collect()
    return worst


# ---------------------------------------------------------------------------
# the selection, top-k and index-scan routes
# ---------------------------------------------------------------------------

def row_phases(runner, dag, snap, repeats: int = 5) -> dict:
    """Host-clock phases (ms, the median of ``repeats`` warm requests) of a
    request on the selection or top-k route: analyze (``_analyze``),
    inputs (``_inputs``: the feed's planes, and a top-k's selection
    outside its wrapper), launch (the ``sel_pred``/``sel_mask``/
    ``sel_compact``/``topn_select`` wrappers), kernel_wait (a synchronize
    right after each wrapper: the device work queued so far), d2h (the
    selection's one copy of its result buffer; a top-k's copy is in
    "other"), rows (the host gather or take of the result rows, and for a
    top-k the scan's views) and other (the rest: EWMA, unpacking, the
    top-k refine).  A phase inside another counts only in the inner one.
    The copies to the host start at dispatch (pinned staging, in
    "other"); d2h is the wait for them (``_readback``), and the packed
    mask's copy where an index capacity overflowed."""
    from tikv_tpu_torch.datatype import ColumnBatch
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    saved = counts()
    runs = []
    for _ in range(repeats):
        spent = dict.fromkeys(("analyze", "inputs", "launch", "kernel_wait",
                               "d2h", "rows"), 0.0)
        patched = []
        inner = [0.0]           # time of the phases inside the open one

        def timed(owner, name, phase, wait=False):
            fn = getattr(owner, name)

            def wrap(*a, **k):
                outer, inner[0] = inner[0], 0.0
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    took = time.perf_counter() - t0
                    spent[phase] += took - inner[0]
                    if wait:
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        spent["kernel_wait"] += time.perf_counter() - t1
                        took += time.perf_counter() - t1
                    inner[0] = outer + took
            patched.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, wrap)

        timed(runner, "_analyze", "analyze")
        timed(runner, "_inputs", "inputs")
        for owner, name in ((sm, "sel_pred"), (sm, "sel_mask"),
                            (sm, "sel_compact"), (tn, "topn_select")):
            timed(owner, name, "launch", wait=True)
        timed(runner, "_readback", "d2h")
        timed(sm.MaskOut, "host", "d2h")
        for name in ("gather_rows", "scan_columns"):
            timed(snap, name, "rows")
        for name in ("take", "filter"):
            timed(ColumnBatch, name, "rows")
        try:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            total = time.perf_counter() - t0
        finally:     # a module's or class's own attribute comes back;
            # an instance's shadow of its class's method goes
            for owner, name, own in reversed(patched):
                if own is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, own)
        ms = {k: v * 1e3 for k, v in spent.items()}
        ms["other"] = total * 1e3 - sum(ms.values())
        ms["total"] = total * 1e3
        runs.append(ms)
    set_counts(saved)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def run_row_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    build, make = cf.ROW_CONFIGS[config]
    t0 = time.perf_counter()
    table, snap = build(n)
    dag = dag_from_wire(enc_dag(make(table)))
    want = cf.row_truth_columns(config, snap)
    print(f"config {config}: table and truth in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = serve(config, n, runner, dag, snap, lambda r: r.batch,
                lambda batch: cf.columns_agree(batch, want),
                ROW_ROUTE[config], selected=len(want[0][0]))
    out["host_phases_ms"] = row_phases(runner, dag, snap)
    del snap
    gc.collect()
    return out


def run_sweep(runner) -> list:
    """Config 2s: config 2's table at each selectivity of the sweep; the
    last warm request must take the route of ``SWEEP_ROUTE``."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    table, snap = cf.build_table(SWEEP_ROWS)
    runs = []
    for point, frac in cf.SWEEP.items():
        thr = cf.sweep_threshold(snap, frac)
        dag = dag_from_wire(enc_dag(cf.dag_selection(table, thr)))
        want = cf.row_truth_columns("2s", snap, thr)
        out = serve(f"2s@{point}", SWEEP_ROWS, runner, dag, snap,
                    lambda r: r.batch,
                    lambda batch: cf.columns_agree(batch, want),
                    {"sel_pred"}, selected=len(want[0][0]))
        assert set(out["last_route"]) == {SWEEP_ROUTE[point]}, \
            f"config 2s@{point} took {out['last_route']}"
        out["host_phases_ms"] = row_phases(runner, dag, snap)
        runs.append(out)
    del snap
    gc.collect()
    return runs


def run_uncovered(runner) -> dict:
    """Config 2's table with a predicate outside sel_pred's signatures
    (``v DIV 3 > 266``, IntDivideInt): the torch route, then sel_mask;
    each answer held exactly against numpy."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.expr import Expr
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    table, snap = cf.build_table(SWEEP_ROWS)
    s = DagSelect.from_table(table, [c.name for c in table.columns])
    dag = dag_from_wire(enc_dag(s.where(Expr.call(
        "GtInt", Expr.call("IntDivideInt", s.col("v"),
                           Expr.const(3, EvalType.INT)),
        Expr.const(266, EvalType.INT))).build()))
    v = snap.columns[3].values.astype(np.int64)
    div = np.where(v >= 0, v // 3, -(-v // 3))          # toward zero
    keep = np.flatnonzero(snap.columns[3].validity & (div > 266))
    want = [(snap.handles[keep], np.ones(len(keep), np.bool_))] + [
        (snap.columns[c].values[keep], snap.columns[c].validity[keep])
        for c in (2, 3)]
    out = serve("2 (IntDivideInt)", SWEEP_ROWS, runner, dag, snap,
                lambda r: r.batch,
                lambda batch: cf.columns_agree(batch, want),
                {"sel_mask"}, selected=len(keep))
    del snap
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# selection and top-k kernels at the main path's shapes
# ---------------------------------------------------------------------------

def time_pred(config: str, prog, planes, n: int, bools: bool, library,
              dev) -> dict:
    """sel_pred at one config's shape: against its plain version (exact)
    and timed beside its bound (the planes the program reads, read once;
    the packed mask, block counts and count — and the bool mask — written
    once; one operation per op and row), its plain version and one
    library call (``library``: the predicate's torch comparison, which
    writes the bool mask and neither counts nor packs it; a yardstick the
    port never calls)."""
    from tikv_tpu_torch.device import selection as sm
    saved = counts()
    got, got_b = sm.sel_pred(prog, planes, n, bools)
    want, want_b = sm.sel_pred_plain(prog, planes, n, bools)
    assert mask_equal(got, want) and (not bools or torch.equal(
        got_b, want_b)), f"sel_pred disagrees at config {config}'s shape"
    nb = sm.n_blocks(n)
    read = sum(n * t.element_size() for ci in prog.cols
               for t in planes[ci] if t is not None)
    t = {"ms": cuda_ms(lambda: sm.sel_pred(prog, planes, n, bools), 50,
                       queued=True),
         "plain_ms": cuda_ms(lambda: sm.sel_pred_plain(prog, planes, n,
                                                       bools), 5),
         "library_ms": cuda_ms(library, 50),
         "library_call": "the torch comparison (yardstick)",
         **bound_ms(read + -(-n // 8) + 4 * nb + 8 + (n if bools else 0),
                    n * len(prog.ops)),
         "rows": n, "selected": int(got.count), "bools": bools,
         "ops": len(prog.ops),
         "peak_bytes": peak_bytes(lambda: sm.sel_pred(prog, planes, n,
                                                      bools))}
    set_counts(saved)
    print(f"kernel sel_pred at config {config} shape ({n} rows): "
          f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
          flush=True)
    return t


def selection_at_main_shapes(dev) -> tuple:
    """sel_pred and sel_mask at config 2 and sel_compact at config 2s's 1%
    (index mode) and 0.1% (planes mode), exact against their plain versions
    and timed; → (sel_pred timing, sel_mask timing, sel_compact
    timing)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.testing import configs as cf
    _table, snap = cf.build_table(SWEEP_ROWS)
    n = SWEEP_ROWS
    planes = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        snap.handles, snap.columns[2].values, snap.columns[3].values)]
    v = planes[2]
    saved = counts()
    pred_t = time_pred("2", sm.encode_predicate(
        [build_rpn(Expr.column(0) > Expr.const(800, EvalType.INT))],
        [torch.int32]), [(v, None)], n, False, lambda: torch.gt(v, 800),
        dev)
    pred = v > 800
    got = sm.sel_mask(pred, n)
    assert mask_equal(got, sm.sel_mask_plain(pred, n)), \
        "sel_mask disagrees at config 2's shape"
    nb = sm.n_blocks(n)
    mask_t = {"ms": cuda_ms(lambda: sm.sel_mask(pred, n), 50, queued=True),
              "plain_ms": cuda_ms(lambda: sm.sel_mask_plain(pred, n), 5),
              "library_ms": cuda_ms(lambda: torch.count_nonzero(pred), 50),
              # the bools read once, the packed bytes, counts and count
              # written once; one pack step per row
              **bound_ms(n + -(-n // 8) + 4 * nb + 8, n),
              "rows": n, "selected": int(got.count)}
    print(f"kernel sel_mask at config 2 shape ({n} rows): max_abs_err=0 " +
          " ".join(f"{k}={x}" for k, x in mask_t.items()), flush=True)
    modes = {}
    for point, planes_here in (("1%", []), ("0.1%", planes)):
        pred = v > cf.sweep_threshold(snap, cf.SWEEP[point])
        mout = sm.sel_mask(pred, n)
        k = int(mout.count)
        cap = sm.index_capacity(k * 1.5 + 64, n)
        c_got = sm.sel_compact(mout, cap, planes_here)
        assert torch.equal(c_got.buf, sm.sel_compact_plain(
            sm.sel_mask_plain(pred, n), cap, planes_here).buf), \
            f"sel_compact disagrees at config 2s {point}"
        esize = sum(t.element_size() for t in planes_here)
        t = {"ms": cuda_ms(lambda: sm.sel_compact(mout, cap, planes_here),
                           50, queued=True),
             "plain_ms": cuda_ms(lambda: sm.sel_compact_plain(
                 mout, cap, planes_here), 5),
             "library_ms": cuda_ms(lambda: torch.nonzero(pred), 20),
             # the packed mask and block counts read once, each selected
             # row's plane elements gathered once; the header, indices and
             # gathered planes written once; a scan step per row
             **bound_ms(-(-n // 8) + 4 * nb + min(k, cap) * esize
                        + HEADER_BYTES + cap * (4 + esize), n),
             "rows": n, "selected": k, "k_cap": cap,
             "planes": len(planes_here)}
        modes["index" if not planes_here else "planes"] = t
        print(f"kernel sel_compact at config 2s {point} shape ({n} rows, "
              f"{len(planes_here)} planes): max_abs_err=0 " +
              " ".join(f"{k}={x}" for k, x in t.items()), flush=True)
    set_counts(saved)
    compact_t = {k: x for k, x in modes["index"].items()}
    compact_t["modes"] = modes
    del snap, planes, v, pred
    gc.collect()
    return pred_t, mask_t, compact_t


def topn_at_main_shapes(runner, dev) -> tuple:
    """topn_select at configs 5 and 5t on the runner's own feed planes,
    exact against its plain version and timed, and sel_pred at 5t's
    predicate (``k < 512``, the bool mask written); → (config 5's timing
    with 5t's under ``configs``, sel_pred's timing at 5t)."""
    from tikv_tpu_torch.datatype import EvalType
    from tikv_tpu_torch.device import selection as sm
    from tikv_tpu_torch.device import topn as tn
    from tikv_tpu_torch.expr import Expr, build_rpn
    from tikv_tpu_torch.testing import configs as cf
    timings = {}
    for config in ("5", "5t"):
        n = ROW_SIZES[config]
        _table, snap = cf.ROW_CONFIGS[config][0](n)
        vcol, kcol = snap.columns[3], snap.columns[2]
        n_pad = runner._pad_rows(n)
        values = torch.zeros(n_pad, dtype=torch.float64, device=dev)
        values[:n] = torch.from_numpy(vcol.values).to(dev)
        ok = mask = None
        if config == "5t":
            ok = torch.from_numpy(vcol.validity).to(dev)
            k32 = torch.from_numpy(kcol.values.astype(np.int32)).to(dev)
            pred_5t = time_pred("5t", sm.encode_predicate(
                [build_rpn(Expr.column(0) < Expr.const(512, EvalType.INT))],
                [torch.int32]), [(k32, None)], n, True,
                lambda: torch.lt(k32, 512), dev)
            mask = torch.from_numpy(kcol.values < 512).to(dev)
            del k32
        n_used, seglen = tn.segments(n, n_pad)
        k = cf.TOPN_LIMIT
        # the runner's placement: the valid values' bounds
        live = vcol.values[vcol.validity]
        kw = dict(values=values, ok=ok, mask=mask, desc=True, n=n,
                  n_used=n_used, seglen=seglen, k=k,
                  placement=tn.digit_placement(
                      torch.float64, True,
                      (float(live.min()), float(live.max()))))
        saved = counts()
        passes = torch.zeros(2, dtype=torch.int64, device=dev)
        got = tn.topn_select(**kw, passes=passes)
        want = tn.topn_plain(values, ok, mask, True, n, n_used, k)
        assert torch.equal(got, want), \
            f"topn_select disagrees at config {config}'s shape"
        nseg = n_used // seglen
        ms = cuda_ms(lambda: tn.topn_select(**kw), 10, queued=True)
        plain_ms = cuda_ms(lambda: tn.topn_plain(values, ok, mask, True, n,
                                                 n_used, k), 2)
        view = values[:n_used].view(nseg, seglen)
        library_ms = cuda_ms(lambda: torch.topk(view, min(k, seglen), dim=1),
                             5)
        extra = n * ((ok is not None) + (mask is not None))
        t = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             # the order plane (and validity and selection) read once, the
             # result written once; one key and compare per row
             **bound_ms(8 * n + extra + 16 * min(k, n_used), n),
             "rows": n, "k": k,
             "topn_route": (tn.ROUTE_COMMON, tn.ROUTE_OVERFLOW)[
                 int(passes[1])],
             "reads_per_row": int(passes[0]) / n}
        if config == "5":
            # the overflow route alone on the same inputs (a placement that
            # puts every row in one bin), beside the common route
            flat = dict(kw, placement=(0, 63))
            assert torch.equal(tn.topn_select(**flat), want)
            t["overflow_route_ms"] = cuda_ms(lambda: tn.topn_select(**flat),
                                             5, queued=True)
        set_counts(saved)
        timings[config] = t
        print(f"kernel topn_select at config {config} shape ({n} rows): "
              f"max_abs_err=0 " + " ".join(f"{k}={x}" for k, x in t.items()),
              flush=True)
        del values, ok, mask, view, snap, want, got
        gc.collect()
    out = dict(timings["5"])
    out["configs"] = timings
    return out, pred_5t


# ---------------------------------------------------------------------------
# the cold MVCC path: mvcc_resolve, plane_digest, patch_rows
# ---------------------------------------------------------------------------

# config → keys on the card (bench.py's 6c default, 4h's 100·2^20)
COLD_SIZES = {"6c": 10 << 20, "4h": 100 << 20}
# DeviceVersionPlanes' chunks: at most 2^20 keys each, at least 4
CHUNK_KEYS = 1 << 20
FEED_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
               torch.int64, torch.float32, torch.float64)
U64 = 1 << 64


def digest_err(got, want) -> int:
    """0 for two equal digests, else their distance mod 2^64."""
    from tikv_tpu_torch.device.digest import as_u64
    d = (as_u64(got) - as_u64(want)) % U64
    return min(d, U64 - d)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equals its own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool or a.element_size() == 1:
        return torch.equal(a, b)
    iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(iv), b.view(iv))


def random_plane(dtype, n: int, gen, dev) -> torch.Tensor:
    if dtype == torch.bool:
        t = torch.rand(n, generator=gen) < 0.5
    elif dtype.is_floating_point:
        t = (torch.randn(n, generator=gen, dtype=torch.float64) * 1e6) \
            .to(dtype)
    else:
        info = torch.iinfo(dtype)
        t = torch.randint(max(info.min, -(1 << 62)), min(info.max, 1 << 62),
                          (n,), generator=gen, dtype=torch.int64).to(dtype)
        t[:2] = torch.tensor([info.min, info.max]).to(dtype)[:n]
    return t.to(dev)


def check_digest(dev) -> tuple:
    """plane_digest and patch_rows against their plain versions on the
    card, on every feed dtype (and int8, int16): the digest over full and
    partial ranges of planes 0-7 elements off a 16-byte boundary, ragged
    and 2^24 + 3 rows long; patch_rows with and without digests at 1, 1000
    and 65,536 positions → (worst digest distance, worst patch: elements
    that differ or a digest distance)."""
    from tikv_tpu_torch.device import digest as dg
    gen = torch.Generator().manual_seed(17)
    worst_d = worst_p = 0
    for dt in FEED_DTYPES:
        for n in (1, 15, 4097, (1 << 24) + 3):
            base = random_plane(dt, n + 8, gen, dev)
            for off in (0, 1, 3, 7):
                a = base[off:off + n]
                for lo, hi in ((0, n), (1, max(1, n - 1)),
                               (n // 3, n // 2), (n, n)):
                    worst_d = max(worst_d, digest_err(
                        dg.plane_digest(a, lo, hi),
                        dg.plane_digest_plain(a, lo, hi)))
        plane = random_plane(dt, 1 << 20, gen, dev)
        for m in (1, 1000, 1 << 16):
            pos = torch.randperm(1 << 20, generator=gen)[:m]
            vals = random_plane(dt, m, gen, dev)
            for digest in (True, False):
                a, b = plane.clone(), plane.clone()
                got = dg.patch_rows(a, pos, vals, digest=digest)
                want = dg.patch_rows_plain(b, pos.to(dev), vals, digest)
                bad = 0 if same_bits(a, b) else 1
                if digest:
                    bad = max(bad, digest_err(got[0], want[0]),
                              digest_err(got[1], want[1]))
                else:
                    bad = max(bad, int(got is not None))
                worst_p = max(worst_p, bad)
    torch.cuda.synchronize()
    print(f"check plane_digest: {len(FEED_DTYPES)} dtypes, 4 lengths, 4 "
          f"offsets, 4 ranges: worst digest distance {worst_d}", flush=True)
    print(f"check patch_rows: {len(FEED_DTYPES)} dtypes, m 1 / 1000 / "
          f"65536, with and without digests: worst {worst_p}", flush=True)
    assert worst_d == 0 and worst_p == 0, "digest kernels disagree"
    return worst_d, worst_p


def full_spec(planes, dev) -> tuple:
    """Every column's value plane in each feed dtype its kind takes and
    its validity plane, and the handle → (sources, kinds, spec)."""
    from tikv_tpu_torch.device import mvcc as pm
    sources, kinds, spec = [], [], [("h", torch.int64), ("h", torch.int32)]
    for cid in planes.col_ids:
        kind, vals, valid = planes.cols[cid]
        sources += [pm._to_device(vals, dev), pm._to_device(valid, dev)]
        kinds += [kind, pm._SRC_BOOL]
        vi = len(sources) - 2
        spec += [("v", vi, dt) for dt in (
            (torch.float32, torch.float64) if kind == 1
            else (torch.int32, torch.int64))] + [("m", vi + 1)]
    return sources, kinds, spec


def check_mvcc(dev) -> int:
    """mvcc_resolve against its plain version on the card, exactly: seeded
    histories of deletes, rollbacks and locks, versions above read_ts,
    NULLs, INT, REAL and unsigned columns, every key deleted, an empty
    result, two versions of a key at one commit_ts, long segments (a key
    of 50,000 versions, a run of keys of 300, tiles at the shared budget
    and one version past it), a schema of 100 output planes (two
    launches), 2^20 keys, and the same planes resident in padded
    ``DeviceVersionPlanes`` buffers → the number of differing outputs
    (0)."""
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import mvcc as tm
    rng = np.random.default_rng(23)
    kinds3 = {2: 0, 3: 1, 4: 3}
    cases = []
    for label, n_keys, shares, read_ts in (
            ("mixed", 700, None, 1000), ("deletes", 700, {1: 1.0}, 1000),
            ("rollbacks_locks", 700, {2: 0.5, 3: 0.5}, 1000),
            ("above_read_ts", 700, None, 45), ("empty", 700, None, 5),
            ("2^20 keys", 1 << 20, None, 45)):
        ev = tm.random_history(rng, n_keys, kinds3, 6, shares=shares)
        cases.append((label, tm.version_history(
            np.arange(n_keys) * 3 + 7, ev, kinds3, read_ts)[0], read_ts))
    keys = np.arange(500)
    cases.append(("every_key_deleted", tm.version_history(keys, [
        tm.Event(10, 0, keys, {2: (keys, np.ones(500, np.bool_))}),
        tm.Event(20, 1, keys)], {2: 0}, 100)[0], 100))
    cases.append(("equal_commit_ts", tm.equal_ts_planes(), 60))
    # long segments: a hot key of 50,000 versions, a run of keys of 300
    # each (tiles past the kernel's shared budget), and one key each of
    # 1025 and 1026 versions among keys of one (its tile at exactly the
    # budget, 2048 versions, and one past it)
    for label in ("hot_key", "long_run"):
        cases.append((label, *tm.long_segment_planes(label, kinds3)))
    lengths = np.ones(5000, np.int64)
    lengths[2500], lengths[4000] = 1025, 1026
    cases.append(("budget edge", tm.segment_history(rng, lengths, kinds3),
                  6000))
    wide = {c: 0 for c in range(2, 35)}
    cases.append(("100 outputs", tm.version_history(keys, tm.random_history(
        rng, 500, wide, 3), wide, 1000)[0], 1000))
    bad = 0
    for label, planes, read_ts in cases:
        sources, kinds, spec = full_spec(planes, dev)
        fixed = [pm._to_device(a, dev) for a in (
            planes.commit_ts, planes.wtype, planes.seg_start,
            planes.handles)]
        n_pad = max(1024, planes.n_keys + 5)
        got, count = pm.mvcc_resolve(*fixed, sources, kinds, spec, read_ts,
                                     planes.n_keys, n_pad)
        want, wcount = pm.mvcc_resolve_plain(*fixed, sources, kinds, spec,
                                             read_ts, planes.n_keys, n_pad)
        n = len(pm.resolve_host(planes, read_ts))
        diff = sum(not same_bits(g, w) for g, w in zip(got, want))
        diff += int(int(count) != n) + int(int(wcount) != n)
        if label == "2^20 keys":
            # the same planes resident, in 4 chunks, padded buffers
            dvp = pm.DeviceVersionPlanes(dev)
            for part in tm.split_planes(planes, -(-planes.n_keys // 4)):
                dvp.append(part)
            res = [dvp.bufs[k] for k in ("commit_ts", "wtype", "seg_start",
                                         "handles")]
            names = [n_ for c in planes.col_ids for n_ in (f"v{c}",
                                                          f"m{c}")]
            got2, count2 = pm.mvcc_resolve(
                *res, [dvp.bufs[nm] for nm in names], kinds, spec, read_ts,
                planes.n_keys, n_pad)
            diff += sum(not same_bits(g, w) for g, w in zip(got2, want))
            diff += int(int(count2) != n)
        print(f"check mvcc_resolve {label}: {planes.n_ver} versions, "
              f"{planes.n_keys} keys, {n} visible, {len(spec)} outputs: "
              f"{diff} differ", flush=True)
        bad += diff
    assert bad == 0, "mvcc_resolve disagrees with its plain version"
    return bad


def check_spill(runner, dev) -> int:
    """A mint with CF_DEFAULT spill rows on the card (every 7th visible
    row's cells supplied as ``defaults``): equal to the upload of its host
    mirror, bit for bit → the planes that differ (0)."""
    from tikv_tpu_torch.copr.region_cache import build_region_columnar_device
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    table, planes, _h, _t, read_ts = tm.history_4h(1 << 16)
    spilled, defaults = tm.spill(planes, pm.resolve_host(planes,
                                                         read_ts)[::7])
    infos = DagSelect.from_table(table, ["id", "k", "v"]).build() \
        .executors[0].columns
    saved = counts()
    tbl, _safe, bundle = build_region_columnar_device(
        spilled, table, infos, read_ts, runner.mvcc_resolver(),
        defaults=defaults)
    n = len(tbl)
    dtypes = ["int64", "int32", "int32"]
    launched = dg.patch_launches
    feed = bundle.mint(runner, infos, dtypes, n, runner._pad_rows(n))
    patches = dg.patch_launches - launched
    host = [(np.ascontiguousarray(
        (tbl.handles if i.is_pk_handle else tbl.columns[i.col_id].values)
        .astype(d)), np.ones(n, np.bool_) if i.is_pk_handle
        else tbl.columns[i.col_id].validity) for i, d in zip(infos, dtypes)]
    up = runner._build_flat(host, n)
    set_counts(saved)
    diff = sum(not same_bits(a, b) for a, b in zip(feed["flat"], up["flat"]))
    diff += int(feed["digests"] != up["digests"])
    print(f"check spill mint: {n} rows, {len(bundle.spill_patches)} spilled,"
          f" {patches} patch_rows launches: {diff} planes differ",
          flush=True)
    assert diff == 0 and patches > 0, "the spill mint disagrees"
    return diff


def cold_dag(config: str, table):
    """6c: GROUP BY c0: COUNT(*), SUM(c1) (bench.py:537-545); 4h: config
    4's GROUP BY k: COUNT(*), SUM(v)."""
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing.dag import DagSelect
    if config == "4h":
        return cf.dag_hash_agg(table)
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    return s.aggregate([s.col("c0")], [("count_star", None),
                                       ("sum", s.col("c1"))]).build()


def only_feed(runner, snap) -> tuple:
    feeds = runner._snaps[snap]["feeds"]
    assert len(feeds) == 1, f"{len(feeds)} feeds"
    return next(iter(feeds.items()))


def feed_diff(a: dict, b: dict) -> int:
    """The planes (and the digest record) in which two feeds differ."""
    diff = sum(not same_bits(x, y) for x, y in zip(a["flat"], b["flat"]))
    diff += abs(len(a["flat"]) - len(b["flat"]))
    return diff + int([digest_err(x, 0) for x in a["digests"]] !=
                      [digest_err(x, 0) for x in b["digests"]])


def serve_cold(label, runner, dag, snap, agrees, expect_route) -> tuple:
    """A cold and five warm requests → (cold ms, warm ms list, the mint's
    phases); the feed must be built once, by ``expect_route``."""
    routes0 = dict(runner.feed_routes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = runner.handle_request(dag, snap).rows()
    cold = (time.perf_counter() - t0) * 1e3
    phases = dict(runner.mvcc_resolver().phases_ms)
    assert agrees(got), f"{label}: wrong answer on the cold request"
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = runner.handle_request(dag, snap).rows()
        warm.append((time.perf_counter() - t0) * 1e3)
        assert agrees(got), f"{label}: wrong answer when warm"
    routes = {k: v - routes0.get(k, 0) for k, v in runner.feed_routes.items()
              if v != routes0.get(k, 0)}
    assert routes == {expect_route: 1}, f"{label}: feed routes {routes}"
    return cold, warm, phases


# the routes of a cold request, in the order of each round: the second
# round reverses the first, so each route is timed at both ends
COLD_ROUNDS = (("device", "upload", "resident"),
               ("resident", "upload", "device"))


def run_cold(config: str, n_keys: int, runner) -> dict:
    """One cold-path configuration: its version history on the host, then
    two rounds of three routes, each route a fresh snapshot by
    ``build_region_columnar_device`` (its host mirror timed) serving cold
    + 5 warm requests: the device route (a feed minted by
    ``mvcc_resolve`` from planes uploaded at the mint), the upload route
    (``_build_flat`` of the mirror) and the resident route (the mint from
    ``DeviceVersionPlanes``).  Round 1's device route is the main path,
    counted, and its feed is scrubbed (clean, a patch and its undo kept
    by the digest rule, a corruption it must name); every other feed and
    the plain version must equal it bit for bit.  Then the kernels timed
    at this shape."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                                  build_region_columnar_device)
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device import mvcc as pm
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.testing import mvcc as tm
    dev = runner.device
    t0 = time.perf_counter()
    make = tm.history_6c if config == "6c" else tm.history_4h
    table, planes, th, truth, read_ts = make(n_keys)
    gen_s = time.perf_counter() - t0
    want, scales = cf.truth("4", tm.truth_table(table, th, truth,
                                                tm.ETS_INT))
    del th, truth
    dag = dag_from_wire(enc_dag(cold_dag(config, table)))
    infos = dag.executors[0].columns
    resolver = runner.mvcc_resolver()
    resident = {}

    def agrees(rows):
        return cf.rows_agree(rows, want, scales, SF_TOL)

    def serve(route: str) -> tuple:
        """A fresh snapshot for ``route`` and its cold + 5 warm requests
        → (snapshot, its feed, timings)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbl, safe, bundle = build_region_columnar_device(
            planes, table, infos, read_ts, resolver,
            device_planes=resident.get("dvp") if route == "resident"
            else None)
        mirror_ms = (time.perf_counter() - t0) * 1e3
        if route == "upload":
            bundle.release()
            bundle = None
        snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
        cold, warm, phases = serve_cold(
            f"{config} {route}", runner, dag, snap, agrees,
            "upload" if route == "upload" else "device_resolve")
        row = {"host_mirror_ms": mirror_ms, "request_ms": cold,
               "cold_ms": mirror_ms + cold,
               "warm_p50_ms": float(np.percentile(warm, 50))}
        if route != "upload":
            assert (phases["h2d"] == 0.0) == (route == "resident"), \
                f"{config} {route}: planes H2D {phases['h2d']} ms"
            row.update(planes_h2d_ms=phases["h2d"],
                       resolve_ms=phases["resolve"],
                       patch_ms=phases["patch"],
                       digests_wait_ms=phases["digests"],
                       rest_ms=cold - sum(phases.values()))
        return snap, only_feed(runner, snap), row

    # the main path: counts from 0, read after the scrub
    set_counts({k: 0 for k in KERNELS})
    snap, (feed_key, feed), first = serve("device")
    n = feed["n_live"]
    assert runner.scrub_feed(feed) == [], f"{config}: scrub not clean"
    plane0 = feed["flat"][0]
    old = plane0[[0, n - 1]].clone()
    runner._patch_plane(feed, 0, [0, n - 1], old + 1)
    assert runner.scrub_feed(feed) == [], f"{config}: patch broke a digest"
    runner._patch_plane(feed, 0, [0, n - 1], old)
    victim = len(feed["flat"]) - 1
    runner.corrupt_resident_plane(feed, victim)
    named = runner.scrub_feed(feed)
    assert named == [victim], f"{config}: the scrub named {named}"
    runner.corrupt_resident_plane(feed, victim)      # flipped back
    assert runner.scrub_feed(feed) == [], f"{config}: not restored"
    launches = counts()
    for name in ("mvcc_resolve", "plane_digest", "patch_rows"):
        assert launches[name] > 0, f"{config} never launched {name}"
    saved = counts()

    # the plain version on the same inputs
    col_ids, dtypes = feed_key[1], feed_key[2]
    used = [next(i for i in infos if i.col_id == c) for c in col_ids]
    has_nulls = {c: not bool(col.validity.all())
                 for c, col in snap._tbl.columns.items()}
    del snap
    args, _flags, _res = pm.resolve_inputs(planes, None, used, dtypes,
                                           has_nulls, dev)
    plain, pcount = pm.mvcc_resolve_plain(*args, read_ts, planes.n_keys,
                                          feed["n_pad"])
    diff = sum(not same_bits(a, b) for a, b in zip(plain, feed["flat"]))
    diff += int(int(pcount) != n)
    del plain, args

    rounds = []
    for order in COLD_ROUNDS:
        rows = {}
        for route in order:
            if route == "device" and not rounds:
                rows[route] = first
                continue
            if route == "resident" and "dvp" not in resident:
                # the planes resident before the query: chunks of ≤ 2^20
                # keys
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dvp = pm.DeviceVersionPlanes(dev)
                parts = tm.split_planes(planes, min(
                    CHUNK_KEYS, -(-planes.n_keys // 4)))
                for part in parts:
                    dvp.append(part)
                torch.cuda.synchronize()
                resident.update(dvp=dvp, chunks=len(parts), fill_ms=(
                    time.perf_counter() - t0) * 1e3)
                del dvp, parts
            other, (_k, other_feed), rows[route] = serve(route)
            diff += feed_diff(other_feed, feed)
            last = other                # ANALYZE reads the last one
            del other, other_feed
        rounds.append(rows)
    set_counts(saved)
    assert diff == 0, f"{config}: the minted feed differs ({diff})"
    timing = time_cold_kernels(config, planes, resident["dvp"], used, dtypes,
                               has_nulls, read_ts, n, feed, dev)
    routes = {}
    for route in COLD_ROUNDS[0]:
        runs = [r[route] for r in rounds]
        req = [r["request_ms"] for r in runs]
        routes[route] = {"runs": runs, "request_ms_spread":
                         max(req) - min(req)}
    routes["resident"].update(planes_fill_ms=resident["fill_ms"],
                              chunks=resident["chunks"])
    out = {"config": config, "keys": planes.n_keys, "versions": planes.n_ver,
           "rows": n, "generate_s": gen_s, "planes_bytes":
           tm.planes_nbytes(planes), "rounds": [list(o) for o in COLD_ROUNDS],
           "routes": routes, "launches": launches, "scrub_named": named,
           "timing": timing}
    print(f"cold config {config}: " + json.dumps(
        {k: v for k, v in out.items() if k != "timing"}), flush=True)
    if config == "6c":
        out["snapshot"] = last          # the cell an6c analyzes it
    del feed, resident, planes, last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_cold_kernels(config, planes, dvp, used, dtypes, has_nulls,
                      read_ts, n, feed, dev) -> dict:
    """mvcc_resolve on the resident planes of this shape, plane_digest on
    the feed's first plane and patch_rows on a copy of it (the two rows
    ``_patch_plane`` writes with digests, and 65,536 rows): CUDA events,
    queued behind a device sleep, beside each bound, plain version and
    yardstick."""
    from tikv_tpu_torch.device import digest as dg
    from tikv_tpu_torch.device import mvcc as pm
    saved = counts()
    args, _flags, resident = pm.resolve_inputs(planes, dvp, used, dtypes,
                                               has_nulls, dev)
    assert resident
    n_pad, K = feed["n_pad"], planes.n_keys
    spec = args[6]
    src_bytes = sum(args[4][s[1]].element_size() for s in spec
                    if s[0] != "h") + sum(8 for s in spec if s[0] == "h")
    out_bytes = sum(t.element_size() for t in feed["flat"])
    resolve_bytes = planes.n_ver * 9 + (K + 1) * 8 + n * src_bytes + \
        n_pad * out_bytes
    t = {"mvcc_resolve": {
        "ms": cuda_ms(lambda: pm.mvcc_resolve(*args, read_ts, K, n_pad), 10,
                      queued=True),
        "plain_ms": cuda_ms(lambda: pm.mvcc_resolve_plain(
            *args, read_ts, K, n_pad), 3),
        "library_ms": None, **bound_ms(resolve_bytes, 0),
        "versions": planes.n_ver, "keys": K, "rows": n, "n_pad": n_pad,
        "outputs": len(spec), "bytes": resolve_bytes,
        "peak_bytes": peak_bytes(lambda: pm.mvcc_resolve(*args, read_ts, K,
                                                         n_pad))}}
    del args
    p0 = feed["flat"][0]
    bits = dg._bits(p0[:n])
    w = 2 * torch.arange(n, dtype=torch.int64, device=dev) + 1
    t["plane_digest"] = {
        "ms": cuda_ms(lambda: dg.plane_digest(p0, 0, n), 50, queued=True),
        "plain_ms": cuda_ms(lambda: dg.plane_digest_plain(p0, 0, n), 5),
        "library_ms": None,
        "yardstick_ms": cuda_ms(lambda: (bits * w).sum(), 20),
        "yardstick": "(bits * (2i+1)).sum() in int64 on pre-widened bits",
        **bound_ms(n * p0.element_size(), 0), "rows": n,
        "dtype": str(p0.dtype)}
    del bits, w
    plane = p0.clone()
    pt = {}
    for m, digest in ((2, True), (1 << 16, True), (1 << 16, False)):
        pos = torch.randperm(n, device=dev)[:m].sort().values
        vals = plane[pos].clone()
        es = plane.element_size()
        case = {"ms": cuda_ms(lambda: dg._patch_rows_cuda(plane, pos, vals,
                                                          digest), 50,
                              queued=True),
                "plain_ms": cuda_ms(lambda: dg.patch_rows_plain(
                    plane, pos, vals, digest), 20),
                "library_ms": cuda_ms(lambda: plane.index_put_((pos,),
                                                               vals), 50),
                "library_call": "index_put_ (writes, no digests)",
                **bound_ms(m * (8 + 2 * es + (es if digest else 0)), 0),
                "rows": m, "digest": digest}
        pt[f"{m} rows{' with digests' if digest else ''}"] = case
    t["patch_rows"] = dict(pt["2 rows with digests"], configs=pt)
    set_counts(saved)
    print(f"kernels at cold config {config} shape: " + json.dumps(t),
          flush=True)
    return t


# ---------------------------------------------------------------------------
# the plan IR: sort_perm, join_build, join_probe, window_scan
# ---------------------------------------------------------------------------

PLAN_ROWS = {"probe": 10 << 20, "build": 1 << 20}
# cell → the kernels its requests launch (and no other)
PLAN_ROUTE = {"7": {"join_build", "join_index", "join_probe", "sel_pred"},
              "7s": {"sort_perm"}, "7w": {"sort_perm", "window_scan"}}
I64 = np.iinfo(np.int64)


def diff_count(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ bit for bit (a float compares by its bits, so
    NaN equals NaN); a shape mismatch counts every element."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return int((a != b).sum())


def of_width(rng, n: int, bits: int, lo: int) -> np.ndarray:
    """int64 keys whose images span exactly ``bits`` bits from ``lo``."""
    span = (1 << bits) - 1
    k = lo + (rng.integers(0, 1 << 62, n) % (span + 1)).astype(np.int64)
    k[0], k[1 % n] = lo, lo + span
    return k


def sort_key_cases(rng, n: int, dev) -> dict:
    """Named key tensors of n rows on the card: int64 over the whole range
    with its extremes, int64 ties, float64 with ±0.0, ±inf and NaN, a byte
    key, a constant key, and int64 keys of exact widths ("w20": 20 bits),
    which pack into images of 31 to 65 bits."""
    wide = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    wide[rng.random(n) < 0.05] = I64.min
    wide[rng.random(n) < 0.05] = I64.max
    wide[rng.random(n) < 0.02] = I64.min + 2
    f = rng.normal(0, 1e3, n)
    for val, share in ((0.0, 0.05), (-0.0, 0.05), (np.inf, 0.02),
                       (-np.inf, 0.02), (np.nan, 0.03), (-np.nan, 0.02)):
        f[rng.random(n) < share] = val
    keys = {"i64_wide": wide, "i64_ties": rng.integers(-3, 3, n),
            "f64": f, "const": np.full(n, 7, np.int64)}
    for bits in (11, 20, 21, 22, 32, 33):
        keys[f"w{bits}"] = of_width(rng, n, bits, -(1 << (bits - 1)))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in keys.items()}
    out["byte"] = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    return out


def check_sort(dev) -> int:
    """sort_perm and join_build against their plain versions on the card,
    bit for bit: 1-8 keys over int64 extremes, ties, ±0.0 / ±inf / NaN,
    byte and constant keys, keys packing into 31, 32, 33, 64 and 65 bits,
    n = 1, 2, 2049, 4095-4097, 12,289 (last tiles of one row: the dynamic
    tile counter's last tile), 100,003 and 10·2^20 (7s's two int64 keys);
    join_build with NULL keys, duplicates, valid keys equal to the
    int64.max sentinel and rows past n_live."""
    from tikv_tpu_torch.device import sort as srt
    rng = np.random.default_rng(71)
    saved = counts()
    worst = 0
    combos = (("i64_wide",), ("f64",), ("byte",), ("const",),
              ("i64_ties", "f64"), ("byte", "i64_wide", "i64_ties"),
              ("f64", "i64_ties", "byte"), ("w20", "w11"), ("w21", "w11"),
              ("w22", "w11"), ("w32", "w32"), ("w33", "w32"),
              ("byte", "w20", "const", "i64_ties", "f64", "w11", "w33",
               "i64_wide"))
    sizes = (1, 2, srt.TILE64 + 1, srt.TILE32 - 1, srt.TILE32,
             srt.TILE32 + 1, 3 * srt.TILE32 + 1, 100_003)
    for n in sizes:
        keys = sort_key_cases(rng, n, dev)
        for combo in combos:
            ks = [keys[c] for c in combo]
            err = diff_count(srt.sort_perm(ks, n),
                             srt.sort_perm_plain(ks, n))
            torch.cuda.synchronize()
            assert err == 0, f"sort_perm {combo} n={n}: {err} rows differ"
    bits = {"+".join(c): [g[2] for g in srt.pack_groups(
        [srt.key_width(int(i.min()), int(i.max())) for i in
         (srt.order_image(keys[k]) for k in c)])] for c in combos}
    print(f"kernel sort_perm: {len(combos)} key combinations x n in "
          f"{sizes}: max_abs_err=0 tolerance=0 (permutations); packed "
          f"images' bits at n={sizes[-1]}: {json.dumps(bits)}", flush=True)
    n = PLAN_ROWS["probe"]
    ks = [torch.from_numpy(-rng.integers(0, PLAN_ROWS["build"], n)).to(dev),
          torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev)]
    err = diff_count(srt.sort_perm(ks, n), srt.sort_perm_plain(ks, n))
    assert err == 0, f"sort_perm at 7s's shape: {err} rows differ"
    print(f"kernel sort_perm at 7s's shape ({n} rows, two int64 keys): "
          f"max_abs_err={err}", flush=True)
    del ks
    for n, live, dup in ((1, 1, 1), (5, 3, 2), (4097, 4000, 7),
                         (100_003, 100_003, 1000), (1 << 20, 1 << 20, 0)):
        keys = np.arange(n, dtype=np.int64) if dup == 0 else \
            rng.integers(-dup, dup, n)
        valid = np.ones(n, np.bool_) if dup == 0 else rng.random(n) > 0.2
        if dup:
            keys[rng.random(n) < 0.1] = I64.max     # sentinel collisions
            keys[rng.random(n) < 0.05] = I64.min
        kt = torch.from_numpy(keys).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        got = srt.join_build(kt, vt, live)
        want = srt.join_build_plain(kt, vt, live)
        torch.cuda.synchronize()
        err = sum(diff_count(a, b) for a, b in zip(got, want))
        assert err == 0, f"join_build n={n} live={live}: {err} differ"
        worst = max(worst, err)
        print(f"kernel join_build n={n} n_live={live}: max_abs_err={err} "
              f"tolerance=0 (sk, perm, prefix)", flush=True)
    set_counts(saved)
    return worst


def join_index_cases(rng) -> list:
    """The direct index's edge cases → (label, build keys, build validity,
    probe keys, capacities, whether the build takes the index)."""
    def span_keys(nv, span):
        inner = rng.choice(np.arange(1, span - 1), nv - 2, replace=False)
        return rng.permutation(np.concatenate([[0, span - 1], inner]))

    npr = 100_003
    out = []
    for label, bk, pk, caps, dense in (
            ("dense", rng.permutation(50_000),
             rng.integers(-100, 50_100, npr), (1 << 17, 12_345), True),
            ("dense with gaps", rng.permutation(
                rng.choice(75_000, 50_000, replace=False)),
             rng.integers(-100, 75_100, npr), (1 << 17, 20_001), True),
            ("duplicates", rng.integers(0, 10_000, 50_000),
             rng.integers(0, 10_500, npr), (1 << 20, 99_999), True),
            ("negative least key", rng.permutation(50_000) - 25_000,
             rng.integers(-25_100, 25_100, npr), (1 << 17,), True),
            ("int64.min", I64.min + rng.permutation(5000),
             np.concatenate([[I64.max, I64.max - 1, 0, -1, I64.min],
                             I64.min + rng.integers(0, 6000, npr - 5)]),
             (1 << 17,), True),
            ("int64.max - 1", I64.max - 1 - rng.permutation(5000),
             np.concatenate([[I64.min, I64.min + 1, 0, -1, I64.max],
                             I64.max - rng.integers(0, 6000, npr - 5)]),
             (1 << 17,), True),
            ("a valid int64.max build key",
             np.concatenate([[I64.max] * 3, rng.permutation(5000)]),
             np.concatenate([[I64.max] * 40, rng.integers(0, 5100,
                                                          npr - 40)]),
             (1 << 17,), False),
            ("span at the threshold", span_keys(1000, 2 * 1000 + 1024),
             rng.integers(-5, 3030, npr), (1 << 17,), True),
            ("span one past it", span_keys(1000, 2 * 1000 + 1025),
             rng.integers(-5, 3030, npr), (1 << 17,), False),
            ("one hot build key", np.concatenate(
                [np.full(5000, 7), rng.permutation(100)]),
             rng.integers(0, 120, npr), (1 << 22, 777_777), True),
            ("one row", np.asarray([3]), np.asarray([3]), (1, 64), True)):
        bk = np.asarray(bk, np.int64)
        bvalid = rng.random(len(bk)) > 0.1
        bvalid[:1] = True
        if label.startswith("span") or label == "one row":
            bvalid[:] = True        # the span counts valid keys only
        out.append((label, bk, bvalid, np.asarray(pk, np.int64), caps,
                    dense))
    return out


def check_join(dev) -> int:
    """join_probe against its plain version on the card, bit for bit
    (pairs and total), on both routes: duplicate build keys, NULL keys on
    both sides, the sentinel key, with and without a mask, a capacity
    above the total and one below it (the exact total beside the pairs
    that fit, the cut inside a tile); the direct index (``join_index``)
    against its plain version and the dense route over its edge cases
    (``join_index_cases``: gaps, duplicates, a negative least key, keys at
    int64.min and int64.max − 1, a valid int64.max key and a span one past
    the threshold, which must take the sparse route, a span at it, one
    hot build key); then the joiner's re-dispatch on an overflow
    (``check_join_redispatch``)."""
    from tikv_tpu_torch.device import join_probe as jp
    from tikv_tpu_torch.device import sort as srt
    rng = np.random.default_rng(72)
    saved = counts()
    cases = []
    for npr, nb, dom, caps in ((1, 1, 1, (64,)), (5000, 300, 50, (1, 64)),
                               (100_003, 4097, 2000, (1 << 17, 1 << 12)),
                               (1 << 20, 1 << 16, 1 << 16, (1 << 21,))):
        bk = rng.integers(0, dom, nb)
        bk[rng.random(nb) < 0.05] = I64.max
        pk = rng.integers(0, dom, npr)
        pk[rng.random(npr) < 0.01] = I64.max
        cases.append((f"{npr}x{nb}", bk, rng.random(nb) > 0.1, pk, caps,
                      None))
    cases += join_index_cases(rng)
    for label, bk, bvalid, pk, caps, dense in cases:
        npr, nb = len(pk), len(bk)
        pvalid = torch.from_numpy(rng.random(npr) > 0.1).to(dev)
        mask = torch.from_numpy(rng.random(npr) > 0.5).to(dev)
        built = srt.join_build(torch.from_numpy(bk).to(dev),
                               torch.from_numpy(bvalid).to(dev), nb)
        index = jp.join_index(built[0], built[2])
        want_index = jp.join_index_plain(built[0], built[2])
        err = int((index is None) != (want_index is None))
        if index is not None and want_index is not None:
            err += int(index[1:] != want_index[1:]) + \
                diff_count(index.off, want_index.off)
        assert err == 0, f"join_index {label}: {err}"
        route = "sparse" if index is None else "dense"
        assert dense is None or dense == (index is not None), \
            f"join_index {label}: the {route} route"
        pkt = torch.from_numpy(pk).to(dev)
        for cap in caps:
            for pv, m in ((pvalid, mask), (None, None)):
                want = jp.join_probe_plain(*built, pkt, pv, m, cap)
                for idx in ((index, None) if index is not None
                            else (None,)):
                    got = jp.join_probe(*built, pkt, pv, m, cap, idx)
                    torch.cuda.synchronize()
                    err = diff_count(got[0], want[0]) + \
                        diff_count(got[1], want[1])
                    assert err == 0, f"join_probe {label} cap={cap}: {err}"
                print(f"kernel join_probe {label} ({npr}x{nb}) k_cap={cap} "
                      f"total={int(want[1])} mask={m is not None} "
                      f"routes={'dense+sparse' if index is not None else route}"
                      f": max_abs_err=0 tolerance=0", flush=True)
    worst = check_join_redispatch(dev)
    set_counts(saved)
    return worst


def check_join_redispatch(dev) -> int:
    """``DeviceJoiner.join`` on the card over four keys on both sides:
    20,000 probe rows × 16 build rows a key overflow the first capacity
    (next_pow2(20,000·1.5 + 64) = 32,768 slots for 320,000-odd pairs); the
    exact total re-dispatches once, and the pairs equal a numpy truth."""
    from tikv_tpu_torch.device.runner import DeviceRunner
    from tikv_tpu_torch.testing import configs as cf
    rng = np.random.default_rng(74)
    pt, psnap, bt, bsnap = cf.build_join_pair(20_000, 64)
    k = rng.integers(0, 4, 20_000)
    bk = np.repeat(np.arange(4), 16)
    rng.shuffle(bk)
    psnap.columns[2].values[:] = k
    bsnap.columns[2].values[:] = bk
    joiner = DeviceRunner(device=dev).joiner()
    probe, build = cf.scan_node(pt), cf.scan_node(bt)
    got = joiner.join(probe.scan, probe.ranges, psnap, (), 1, build.scan,
                      build.ranges, bsnap, 1)
    # truth: probe rows in order, each with its key's build rows in order
    by_key = [np.flatnonzero(bk == key) for key in range(4)]
    want_p = np.repeat(np.arange(20_000), [len(by_key[x]) for x in k])
    want_b = np.concatenate([by_key[x] for x in k])
    assert joiner.overflow_redispatches == 1, joiner.stats()
    err = int((got[0] != want_p).sum() + (got[1] != want_b).sum()) \
        if got[0].shape == want_p.shape else len(want_p)
    assert err == 0, f"DeviceJoiner.join re-dispatch: {err} pairs differ"
    print(f"kernel join_probe through DeviceJoiner.join: {len(want_p)} "
          f"pairs past k_cap=32768, overflow_redispatches="
          f"{joiner.overflow_redispatches}: max_abs_err={err} tolerance=0",
          flush=True)
    return err


def check_window(dev) -> int:
    """window_scan against its plain version on the card, bit for bit:
    int64 and float64 (NaN, ±0.0) partition keys, none, one partition over
    every row (the longest look-back chain), a partition on each row,
    counts, int64 sums with NULLs, LAG / LEAD of int64 and float64 over
    offsets 1, 2 and 5 (the kernel's halo) and ±100 and ±5000 (past
    ``window.CAP``: its second pass), n = 1, the tile's rows -1, 0 and +1,
    1023-1025, 100,003 and 10·2^20."""
    from tikv_tpu_torch.device import sort as srt
    from tikv_tpu_torch.device import window as win
    rng = np.random.default_rng(73)
    saved = counts()
    sizes = (1, 1023, 1024, 1025, win.TILE - 1, win.TILE, win.TILE + 1,
             100_003, PLAN_ROWS["probe"])
    for n in sizes:
        k = torch.from_numpy(rng.integers(0, max(1, n // 20), n)).to(dev)
        f = rng.normal(0, 1, n).round(1)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.05] = -0.0
        fk = torch.from_numpy(f).to(dev)
        one = torch.zeros(n, dtype=torch.int64, device=dev)
        each = torch.from_numpy(rng.permutation(n)).to(dev)
        v = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev)
        ok = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        fv = torch.from_numpy(rng.normal(0, 1, n)).to(dev)
        for parts in ([k], [k, fk], [fk], [], [one], [each]):
            perm = srt.sort_perm(parts + [v], n)
            chans = [("count", None, ok), ("sum", v, ok),
                     ("count", None, ok)]
            shifts = [(-2, v, ok), (1, v, ok), (-1, fv, ok), (5, fv, ok),
                      (-100, v, ok), (100, fv, ok), (-5000, fv, ok),
                      (5000, v, ok)]
            got = win.window_scan(perm, parts, True, chans, shifts)
            want = win.window_scan_plain(perm, parts, True, chans, shifts)
            torch.cuda.synchronize()
            err = diff_count(got[0], want[0]) + sum(
                diff_count(a, b) for a, b in zip(got[1], want[1])) + sum(
                diff_count(a, b) + diff_count(c, d)
                for (a, c), (b, d) in zip(got[2], want[2]))
            assert err == 0, f"window_scan n={n} parts={len(parts)}: {err}"
        print(f"kernel window_scan n={n}: 6 partitionings (one over every "
              f"row, one a row), 3 channels, 8 shifts (4 past the halo): "
              f"max_abs_err=0 tolerance=0", flush=True)
        del k, fk, one, each, v, ok, fv
    set_counts(saved)
    return 0


def plan_endpoint(runner):
    """An endpoint over config 7's snapshots (full size), and them."""
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.testing import configs as cf
    pair = cf.build_join_pair(PLAN_ROWS["probe"], PLAN_ROWS["build"])
    by = {pair[0].table_id: pair[1], pair[2].table_id: pair[3]}
    ep = Endpoint(lambda req: by[req.dag.executors[0].table_id], runner)
    return ep, pair


def run_plan(cell: str, ep, pair) -> dict:
    """Cell ``cell`` through ``Endpoint.handle_plan(force_backend=
    "device")``, its request wire-encoded first: one cold and five warm
    requests, each answer against the numpy truth; the kernels of its
    route must launch and no other; no degrade; config 7 must join on the
    device and build its dictionary once."""
    from tikv_tpu_torch.convert import plan_from_wire
    from tikv_tpu_torch.copr.wire import enc_plan
    from tikv_tpu_torch.testing import configs as cf
    probe_t, probe, build_t, build = pair
    preq = plan_from_wire(enc_plan(cf.PLAN_CELLS[cell](probe_t, build_t)))
    t0 = time.perf_counter()
    want = cf.plan_truth(cell, probe, build)
    truth_s = time.perf_counter() - t0
    ex = ep.plan_executor
    joiner = ep._device_runner.joiner()
    jb0 = dict(ex.join_backends)
    hits0 = joiner.build_cache_hits
    routes0 = joiner.probe_routes.get("dense", 0)
    set_counts({k: 0 for k in KERNELS})
    times, phases = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        got = ep.handle_plan(preq, force_backend="device").result.batch
        times.append(time.perf_counter() - t0)
        assert cf.columns_agree(got, want), \
            f"cell {cell}: wrong answer (request {len(times)})"
        phases.append({**{f"plan.{k}": v for k, v in ex.phases_ms.items()},
                       **{f"device.{k}": v
                          for k, v in joiner.phases_ms.items()}})
    launches = counts()
    for name in KERNELS:
        if name in PLAN_ROUTE[cell]:
            assert launches[name] > 0, f"cell {cell} never launched {name}"
        else:
            assert launches[name] == 0, f"cell {cell} launched {name}"
    assert not ep.degrades, f"cell {cell}: degrades {ep.degrades}"
    if cell == "7":
        jb = {k: v - jb0.get(k, 0) for k, v in ex.join_backends.items()}
        assert jb.get("device", 0) >= 1 and set(jb) == {"device"}, jb
        assert launches["join_build"] == 1 and \
            launches["join_index"] == 1 and \
            launches["join_probe"] == 6, launches
        assert joiner.build_cache_hits - hits0 == 5
        # config 7's build keys are 0..2^20 - 1: the direct index serves
        assert joiner.probe_routes.get("dense", 0) - routes0 == 6, \
            joiner.probe_routes
    else:
        assert launches["sort_perm"] == 6, launches
    out = {"config": cell, "rows": PLAN_ROWS["probe"],
           "build_rows": PLAN_ROWS["build"] if cell == "7" else 0,
           "out_rows": got.num_rows, "cold_ms": times[0] * 1e3,
           "warm_p50_ms": float(np.percentile(times[1:], 50)) * 1e3,
           "launches": launches, "truth_s": truth_s,
           "cold_phases_ms": phases[0],
           "warm_phases_ms": {k: float(np.median([p.get(k, 0.0)
                                                  for p in phases[1:]]))
                              for k in phases[-1]},
           "degrades": dict(ep.degrades)}
    # a warm request under the profiler (join_build is cached by then)
    out["profile"] = profile_request(
        cell, None, None, None, PLAN_ROUTE[cell] & set(SYMBOLS),
        call=lambda: ep.handle_plan(preq, force_backend="device"))
    print(f"cell {cell}: " + " ".join(
        f"{k}={json.dumps(v) if isinstance(v, dict) else v}"
        for k, v in out.items() if k != "config"), flush=True)
    return out


def index_launch(jp, index, sk, n_valid: int) -> None:
    """The index kernel alone over the dictionary ``sk`` (``n_valid``
    valid keys) into ``index.off`` (what ``join_index`` launches after its
    readback)."""
    lib = jp._kernel_lib()
    p = jp._IndexParams(sk=sk.data_ptr(), n_valid=n_valid,
                        key_lo=index.lo, span=index.span,
                        off=index.off.data_ptr())
    at = jp._where(sk.device)
    assert lib.join_index_launch(at[0], ctypes.byref(p), at[1]) == 0


def plan_kernels_at_main_shapes(pair, dev) -> tuple:
    """The five kernels at config 7's / 7s's / 7w's shapes: checked
    against their plain versions there (bit for bit) and timed with CUDA
    events (the probe and the window queued behind a device sleep; the
    sorts and ``join_index`` as issued, since they read back from the
    card), beside each bound (inputs read once, outputs written once at
    3.35 TB/s), plain version and library yardstick (composed
    torch.argsort(stable=True) for the sorts; torch.searchsorted for the
    index and, left and right, for the probe's runs; none computes the
    window).  ``join_probe`` on both routes: the dense build (its direct
    index) and the same keys spread by 2^20 (sparse)."""
    from tikv_tpu_torch.device import join_probe as jp
    from tikv_tpu_torch.device import sort as srt
    from tikv_tpu_torch.device import window as win
    probe_t, probe, build_t, build = pair
    saved = counts()
    n, nb = len(probe), len(build)
    k = torch.from_numpy(probe.columns[2].values).to(dev)
    v = torch.from_numpy(probe.columns[3].values).to(dev)
    bk = torch.from_numpy(build.columns[2].values).to(dev)
    bvalid = torch.ones(nb, dtype=torch.bool, device=dev)
    t, errs = {}, {}

    def argsorts(keys):
        p = torch.arange(keys[0].shape[0], device=dev)
        for key in reversed(keys):
            p = p[torch.argsort(key[p], stable=True)]
        return p

    built = srt.join_build(bk, bvalid, nb)
    errs["join_build"] = sum(diff_count(a, b) for a, b in zip(
        built, srt.join_build_plain(bk, bvalid, nb)))
    nsv = torch.zeros(nb, dtype=torch.int64, device=dev)
    t["join_build"] = {
        "ms": cuda_ms(lambda: srt.join_build(bk, bvalid, nb), 20),
        "plain_ms": cuda_ms(lambda: srt.join_build_plain(bk, bvalid, nb), 5),
        "library_ms": cuda_ms(lambda: argsorts([bk, nsv]), 5),
        "library_call": "torch.argsort(stable=True) composed over (key, "
                        "not valid)",
        **bound_ms(nb * (8 + 1 + 8 + 4 + 8) + 8, 0), "rows": nb}
    mask = v > 0
    k_cap = 1 << (int(n * 1.5 + 64) - 1).bit_length()
    sk, perm, prefix = built
    index = jp.join_index(sk, prefix)
    want_index = jp.join_index_plain(sk, prefix)
    assert index is not None, "config 7's build must take the direct index"
    errs["join_index"] = diff_count(index.off, want_index.off) + int(
        index[1:] != want_index[1:])
    t["join_index"] = {
        "ms": cuda_ms(lambda: jp.join_index(sk, prefix), 20),
        "kernel_ms": cuda_ms(lambda: index_launch(jp, index, sk, nb), 50,
                             queued=True),
        "plain_ms": cuda_ms(lambda: jp.join_index_plain(sk, prefix), 5),
        "library_ms": cuda_ms(lambda: torch.searchsorted(
            sk, torch.arange(index.span + 1, device=dev) + index.lo), 5),
        "library_call": "torch.searchsorted of every key of the span",
        # sk read once, 4 B an entry written
        **bound_ms(nb * 8 + (index.span + 1) * 4, 0),
        "rows": nb, "span": index.span,
        "timed": "ms: the wrapper as issued (it reads three numbers back); "
                 "kernel_ms: the kernel alone, queued"}
    del want_index
    want = jp.join_probe_plain(*built, k, None, mask, k_cap)
    total = int(want[1])
    # the function's bytes: probe keys and mask read once, the dictionary
    # once, each pair slot up to k_cap written once (the pairs, then the
    # -1 fill), the total; the count without the fill is printed beside
    old_bytes = n * (8 + 1) + nb * (8 + 4 + 8) + 8 + 8 * total + 8
    new_bytes = old_bytes + 8 * (k_cap - total)
    routes, errs["join_probe"] = {}, 0
    for route, keys_of in (("dense", lambda x: x), ("sparse",
                                                    lambda x: x << 20)):
        kr, bkr = keys_of(k), keys_of(bk)
        built_r = built if route == "dense" else \
            srt.join_build(bkr, bvalid, nb)
        idx = jp.join_index(built_r[0], built_r[2])
        assert (idx is not None) == (route == "dense"), route
        got = jp.join_probe(*built_r, kr, None, mask, k_cap, idx)
        errs["join_probe"] += diff_count(got[0], want[0]) + \
            diff_count(got[1], want[1])
        del got
        routes[route] = {
            "ms": cuda_ms(lambda: jp.join_probe(*built_r, kr, None, mask,
                                                k_cap, idx), 10,
                          queued=True),
            "build_keys": "0..2^20-1" if route == "dense"
            else "(0..2^20-1) << 20, probe keys likewise"}
        print(f"join_probe at config 7: route {route}, "
              f"{routes[route]['ms']} ms", flush=True)
        del built_r, kr, bkr
    del want
    t["join_probe"] = {
        "ms": routes["dense"]["ms"],
        "plain_ms": cuda_ms(lambda: jp.join_probe_plain(
            *built, k, None, mask, k_cap), 3),
        "library_ms": cuda_ms(lambda: (
            torch.searchsorted(sk, k, right=False),
            torch.searchsorted(sk, k, right=True)), 5),
        "library_call": "torch.searchsorted left and right of the probe "
                        "keys into sk: a yardstick that computes the runs, "
                        "not the pairs",
        **bound_ms(new_bytes, 0),
        "bound_ms_without_fill": bound_ms(old_bytes, 0)["bound_ms"],
        "routes": routes, "rows": n, "build_rows": nb, "pairs": total,
        "k_cap": k_cap}
    print(f"join_probe bound at config 7: {t['join_probe']['bound_ms']} ms "
          f"with the -1 fill up to k_cap ({new_bytes} B), "
          f"{t['join_probe']['bound_ms_without_fill']} ms without it "
          f"({old_bytes} B)", flush=True)
    del built, mask
    keys = [-k, v]
    errs["sort_perm"] = diff_count(srt.sort_perm(keys, n),
                                   srt.sort_perm_plain(keys, n))
    # the kernel's one packed image, built outside the timing
    images = [srt.order_image(key) for key in keys]
    los = [int(i.min()) for i in images]
    groups = srt.pack_groups([srt.key_width(lo, int(i.max()))
                              for lo, i in zip(los, images)])
    assert len(groups) == 1, groups
    packed = srt.packed_image(images, los, groups[0])
    del images
    errs["sort_perm"] += diff_count(
        torch.argsort(packed, stable=True).to(torch.int32),
        srt.sort_perm_plain(keys, n))
    t["sort_perm"] = {
        "ms": cuda_ms(lambda: srt.sort_perm(keys, n), 10),
        "plain_ms": cuda_ms(lambda: srt.sort_perm_plain(keys, n), 3),
        "library_ms": cuda_ms(lambda: argsorts(keys), 3),
        "library_call": "torch.argsort(stable=True) composed over the keys",
        "packed_argsort_ms": cuda_ms(
            lambda: torch.argsort(packed, stable=True), 3),
        "packed_bits": groups[0][2],
        **bound_ms(n * (8 + 8 + 4), 0), "rows": n, "keys": 2}
    del packed
    perm = srt.sort_perm([k, v], n)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    # 7w's launch: count(v), sum(v) and avg(v) share two channels
    chans = [("count", None, ok), ("sum", v, ok)]
    shifts = [(-2, v, ok), (1, v, ok)]
    got = win.window_scan(perm, [k], True, chans, shifts)
    want = win.window_scan_plain(perm, [k], True, chans, shifts)
    errs["window_scan"] = diff_count(got[0], want[0]) + sum(
        diff_count(a, b) for a, b in zip(got[1], want[1])) + sum(
        diff_count(a, b) + diff_count(c, d)
        for (a, c), (b, d) in zip(got[2], want[2]))
    del got, want
    t["window_scan"] = {
        "ms": cuda_ms(lambda: win.window_scan(perm, [k], True, chans,
                                              shifts), 10, queued=True),
        "plain_ms": cuda_ms(lambda: win.window_scan_plain(
            perm, [k], True, chans, shifts), 3),
        "library_ms": None,
        # reads: perm, k, v, ok once; writes: rn, 2 channels, 2 shifts
        **bound_ms(n * (4 + 8 + 8 + 1) + n * (8 + 2 * 8 + 2 * 9), 0),
        "rows": n, "channels": len(chans), "shifts": len(shifts)}
    set_counts(saved)
    for name, e in errs.items():
        assert e == 0, f"{name} disagrees with its plain version at its " \
            f"main shape: {e}"
    print("plan kernels at main shapes: " + json.dumps(t), flush=True)
    return errs, t


# ---------------------------------------------------------------------------
# ANALYZE and CHECKSUM: analyze_column, the cells an4, an4n, an4s, an4r, an6c
# ---------------------------------------------------------------------------

# cell → rows of its table (an6c: config 6c's cold snapshot, COLD_SIZES)
ANALYZE_ROWS = {"an4": 100 << 20, "an4n": 100 << 20, "an4s": 1 << 24,
                "an4r": 1 << 24}
# n around the pass tiles (2048 rows of 64-bit keys, 4096 of 32-bit ones)
ANALYZE_SIZES = (1, 2, 2047, 2048, 2049, 4095, 4096, 4097, 12_289, 100_003,
                 1 << 20)
CHECKSUM_ROWS = 1 << 16


def analyze_cases(dev):
    """(label, values, validity, n, buckets) on the card: each device dtype
    over the CPU tests' edge cases (NULLs, NaN, −NaN, ±0.0, ±inf, the
    dtype's max, all NULL, one valid row, five, one bucket, one row, ties,
    padding marked valid); each dtype at n around the pass tiles (random
    values, NULLs on 20%); then over 2^20 rows: float64 with NaN, −NaN,
    ±0.0 and ±inf on 5% each, int64 over its whole range with NULLs (the
    NULL key all ones), int64 keys of exactly 32 and 33 bits, one value on
    every row, uint64 at and past 2^63, and 2^22 rows with 256 buckets."""
    from tikv_tpu_torch.testing import configs as cf

    def up(v, ok, n, b):
        return (torch.from_numpy(np.ascontiguousarray(v)).to(dev),
                torch.from_numpy(np.ascontiguousarray(ok)).to(dev), n, b)

    for kind in cf.ANALYZE_KINDS:
        for case in cf.ANALYZE_EDGE_CASES:
            yield (f"{kind}/{case}",
                   *up(*cf.analyze_edge_case(kind, case)))
        for rows in ANALYZE_SIZES:
            v, ok, _n, b = cf.analyze_edge_case(kind, "random", rows)
            yield f"{kind}/n={rows}", *up(v, ok, rows, b)
    rng = np.random.default_rng(104)
    m = 1 << 20
    f = rng.normal(0, 1e3, m)
    for val in (np.nan, np.copysign(np.nan, -1), 0.0, -0.0, np.inf,
                -np.inf):
        f[rng.random(m) < 0.05] = val
    yield "float64/specials/2^20", *up(f, rng.random(m) > 0.1, m, 256)
    wide = rng.integers(I64.min, I64.max, m, dtype=np.int64, endpoint=True)
    wide[:2] = (I64.min, I64.max)
    ok = rng.random(m) > 0.1
    ok[:2] = True
    yield "int64/full span/2^20", *up(wide, ok, m, 256)
    for bits, span in ((32, (1 << 32) - 2), (33, (1 << 32) - 1)):
        k = -77 + rng.integers(0, span + 1, m)
        k[:2] = (-77, -77 + span)
        yield f"int64/{bits}-bit keys/2^20", *up(k, np.ones(m, np.bool_),
                                                 m, 256)
    yield "int32/one value/2^20", *up(np.full(m, 5, np.int32),
                                      np.ones(m, np.bool_), m, 256)
    u = rng.integers(0, 1 << 63, m, dtype=np.uint64)
    u[rng.random(m) < 0.5] |= np.uint64(1 << 63)
    yield "uint64/past 2^63/2^20", *up(u, rng.random(m) > 0.1, m, 256)
    m = 1 << 22
    yield "int32/2^22", *up(rng.integers(-(1 << 31), 1 << 31, m,
                                         dtype=np.int32),
                            rng.random(m) > 0.1, m - 5, 256)


def check_analyze(dev) -> float:
    """analyze_column against its plain version on the card over
    ``analyze_cases``: every rank word, n_valid and the distinct count bit
    for bit, the bound of every bucket the unpacking keeps by value
    (``analyze.packed_max_diff``; tolerance 0)."""
    from tikv_tpu_torch.device import analyze as an
    saved = counts()
    worst, n_cases, bits = 0.0, 0, {}
    for label, v, ok, n, b in analyze_cases(dev):
        got = an.analyze_column(v, ok, n, b)
        want = an.analyze_column_plain(v, ok, n, b)
        torch.cuda.synchronize()
        err = an.packed_max_diff(got, want, b, v.dtype == torch.float64)
        assert err == 0, f"analyze {label}: differs by {err}"
        worst = max(worst, err)
        n_cases += 1
        if "2^2" in label:
            bits[label] = an.key_plan(v, ok, n)[3]
        del got, want
    set_counts(saved)
    print(f"kernel analyze: {n_cases} cases (edge cases of every dtype, "
          f"n in {ANALYZE_SIZES}, 2^20 and 2^22 rows): max_abs_err={worst} "
          f"tolerance=0 (ranks, counts bit for bit; kept bounds by value); "
          f"key bits {json.dumps(bits)}", flush=True)
    return worst


def stats_equal(got, want) -> bool:
    """ColumnStats lists equal: ids, totals, NULL and distinct counts, and
    every bucket's bound and count (by value; no cell holds a NaN)."""
    return len(got) == len(want) and all(
        (g.col_id, g.total, g.null_count, g.distinct, g.buckets) ==
        (w.col_id, w.total, w.null_count, w.distinct, w.buckets)
        for g, w in zip(got, want))


def run_analyze(cell: str, runner, table=None, snap=None) -> dict:
    """ANALYZE cell ``cell`` (every column, 256 buckets) through
    ``Endpoint.handle_analyze`` at a row threshold of the snapshot's rows:
    one cold and five warm requests, each answer against the numpy truth
    (``configs.analyze_truth``); ``analyze`` must launch once per column
    and request and no other kernel; no degrade; the host-clock phases of
    the cold and the median warm request."""
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.testing import configs as cf
    t0 = time.perf_counter()
    if snap is None:
        table, snap = cf.ANALYZE_CELLS[cell](ANALYZE_ROWS[cell])
    build_s = time.perf_counter() - t0
    areq = cf.analyze_request(table)
    t0 = time.perf_counter()
    want = cf.analyze_truth(areq, snap)
    truth_s = time.perf_counter() - t0
    rows = snap.estimated_rows()
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=rows)
    set_counts({k: 0 for k in KERNELS})
    times, phases = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ep.handle_analyze(areq)["columns"]
        times.append((time.perf_counter() - t0) * 1e3)
        assert stats_equal(got, want), \
            f"cell {cell}: wrong answer (request {len(times)})"
        phases.append(dict(runner.analyze_phases_ms))
    launches = counts()
    cols = len(areq.scan.columns)
    assert launches["analyze"] == 6 * cols, launches
    assert all(v == 0 for k, v in launches.items() if k != "analyze"), \
        f"cell {cell} launched {launches}"
    assert not ep.degrades, f"cell {cell}: degrades {ep.degrades}"
    out = {"config": cell, "rows": rows, "columns": cols,
           "buckets": areq.buckets, "cold_ms": times[0],
           "warm_p50_ms": float(np.percentile(times[1:], 50)),
           "launches": launches, "build_s": build_s, "truth_s": truth_s,
           "distinct": [s.distinct for s in got],
           "null_count": [s.null_count for s in got],
           "cold_phases_ms": phases[0],
           "warm_phases_ms": {k: float(np.median([p.get(k, 0.0)
                                                  for p in phases[1:]]))
                              for k in phases[-1]},
           "degrades": dict(ep.degrades)}
    print(f"cell {cell}: " + " ".join(
        f"{k}={json.dumps(v) if isinstance(v, (dict, list)) else v}"
        for k, v in out.items() if k != "config"), flush=True)
    return out


def run_checksum() -> dict:
    """CHECKSUM over config 4's table at 2^16 rows: the crc64-xz check
    value, the fold of the pairs in another order, two replicas of the
    same rows (built apart from one seed) and a partial range against the
    fold of its pairs; on the host, as in the reference."""
    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.copr.analyze import (ChecksumReq, checksum_kv_pairs,
                                             crc64)
    from tikv_tpu_torch.copr.endpoint import Endpoint
    from tikv_tpu_torch.executors.ranges import KeyRange
    from tikv_tpu_torch.testing import configs as cf
    assert crc64(b"123456789") == 0x995DC9BBDF1939FA
    table, snap = cf.build_table(CHECKSUM_ROWS)
    _t, replica = cf.build_table(CHECKSUM_ROWS)
    areq = cf.analyze_request(table)
    req = ChecksumReq(areq.scan, areq.ranges)
    t0 = time.perf_counter()
    one = Endpoint(lambda r: snap).handle_checksum(req)
    wall_ms = (time.perf_counter() - t0) * 1e3
    two = Endpoint(lambda r: replica).handle_checksum(req)
    assert one == two and one["total_kvs"] == CHECKSUM_ROWS, (one, two)
    pairs = snap.to_kv_pairs()[::-1]
    assert checksum_kv_pairs([k for k, _ in pairs],
                             [v for _, v in pairs]) == one
    part = (KeyRange(table_record_key(table.table_id, 100),
                     table_record_key(table.table_id, 5000)),)
    sub = Endpoint(lambda r: snap).handle_checksum(
        ChecksumReq(areq.scan, part))
    pairs = snap.to_kv_pairs(part)
    assert sub["total_kvs"] == 4900 and sub == checksum_kv_pairs(
        [k for k, _ in pairs], [v for _, v in pairs])
    out = {"rows": CHECKSUM_ROWS, "checksum": one["checksum"],
           "total_bytes": one["total_bytes"], "wall_ms": wall_ms,
           "replicas_agree": True}
    print("checksum: " + json.dumps(out), flush=True)
    return out


DEFERRED_ROWS = 1 << 22
EP_ROWS = 10 << 20
EP_CLIENTS, EP_REQS = 64, 6
EP_WINDOW_MS, EP_GROUP = 150.0, 16
EP_DEADLINE_MS = 60_000


def gil_released_by_event_wait() -> float:
    """The share of a Python loop's free-running rate that the main thread
    keeps while another thread waits in ``torch.cuda.Event.synchronize``
    on 0.2 s of device sleep (near 1: the wait releases the interpreter
    lock, so completion workers overlap their waits)."""
    import threading
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        n += 1
    rate = n / (time.perf_counter() - t0)
    torch.cuda._sleep(int(0.2 * CLOCK_HZ))
    ev = torch.cuda.Event()
    ev.record()
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (ev.synchronize(), done.set()))
    t0 = time.perf_counter()
    waiter.start()
    n = 0
    while not done.is_set():
        n += 1
    spent = time.perf_counter() - t0
    waiter.join(timeout=10)
    return n / (rate * spent)


def run_deferred(runner) -> dict:
    """Thirty-two deferred requests over configs 2, 3 and 4's tables
    (``DEFERRED_ROWS`` rows each), every one dispatched before any wait,
    each equal to its serial answer; the pinned stager's stats; a
    ``device::before_fetch`` inside one deferred fetch degrades that
    request only; and whether a completion worker's event wait releases
    the interpreter lock."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.device.deferred import HOST_STAGER, DeferredResult
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.utils import failpoint
    n = DEFERRED_ROWS
    t2, s2 = cf.ROW_CONFIGS["2"][0](n)
    t3, s3 = cf.CONFIGS["3"][0](n)
    t4, s4 = cf.CONFIGS["4"][0](n)
    plans = [(cf.dag_selection(t2, thr), s2)
             for thr in (800, 900, 990, 998, 500)]
    plans += [(cf.CONFIGS["3"][1](t3), s3), (cf.CONFIGS["4"][1](t4), s4)]
    plans = [(dag_from_wire(enc_dag(d)), snap) for d, snap in plans]
    def columns(result) -> list:
        return [(c.values, c.validity) for c in result.batch.columns]

    def same(result, want) -> bool:
        got = columns(result)
        return len(got) == len(want) and all(
            np.array_equal(v, wv, equal_nan=v.dtype.kind == "f") and
            np.array_equal(m, wm) for (v, m), (wv, wm) in zip(got, want))

    serial = []
    for dag, snap in plans:
        for _ in range(3):              # warm: feeds and selectivities
            r = runner.handle_request(dag, snap)
        serial.append(columns(r))
    st0 = HOST_STAGER.stats()
    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    pending = [runner.handle_request(*plans[i % len(plans)], deferred=True)
               for i in range(32)]
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    assert all(isinstance(d, DeferredResult) for d in pending)
    for i, d in reversed(list(enumerate(pending))):
        assert same(d.result(), serial[i % len(plans)]), \
            f"deferred request {i} differs from its serial answer"
        assert d.degraded is None
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    st1 = HOST_STAGER.stats()
    # a fault inside one deferred fetch degrades that request only
    a = runner.handle_request(*plans[0], deferred=True)
    b = runner.handle_request(*plans[5], deferred=True)
    failpoint.cfg("device::before_fetch", "1*return->off")
    try:
        got_a, got_b = a.result(), b.result()
    finally:
        failpoint.teardown()
    assert a.degraded == "fetch" and b.degraded is None
    assert same(got_a, serial[0]) and same(got_b, serial[5])
    share = gil_released_by_event_wait()
    assert share > 0.3, f"an event wait holds the interpreter lock ({share})"
    out = {"config": "deferred", "rows": n, "requests": 32,
           "dispatch_ms": dispatch_ms, "wall_ms": wall_ms,
           "launches": launches,
           "stager": {k: st1[k] - st0.get(k, 0) if k in ("staged",
                                                         "staged_bytes")
                      else st1[k] for k in st1},
           "loop_share_during_event_wait": share}
    print("deferred: " + " ".join(f"{k}={v}" for k, v in out.items()
                                  if k != "config"), flush=True)
    del s2, s3, s4, plans, pending
    gc.collect()
    return out


def serve_phase(ep, tables, schedule, check) -> dict:
    """One run of the 6b schedule through ``Endpoint.handle_async(...)
    .wait()``: EP_CLIENTS threads of EP_REQS requests each, started
    together, each request under a deadline of EP_DEADLINE_MS; answers are
    kept and held against their truths after the run (``check``)."""
    import threading
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf
    from tikv_tpu_torch.utils import deadline as dl_mod
    dags = {}
    for ti, pi, is_sel in schedule:
        key = (ti, pi if is_sel else None)
        if key not in dags:
            dags[key] = dag_from_wire(enc_dag(cf.dag_serving(
                tables[ti][0], cf.SERVE_PALETTE[pi] if is_sel else None)))
    lat, late, errors, answers, phases = [], [0], {}, {}, {}
    mu = threading.Lock()
    start = threading.Barrier(EP_CLIENTS)

    def worker(ci):
        start.wait(timeout=60)
        for r in range(EP_REQS):
            i = ci * EP_REQS + r
            ti, pi, is_sel = schedule[i]
            dag = dags[(ti, pi if is_sel else None)]
            dl = dl_mod.Deadline.after_ms(EP_DEADLINE_MS)
            tok = dl_mod.install(dl)
            t0 = time.perf_counter()
            try:
                resp = ep.handle_async(CopRequest(REQ_TYPE_DAG, dag)).wait()
            except Exception as e:      # noqa: BLE001 — counted, fails below
                with mu:
                    errors[type(e).__name__] = \
                        errors.get(type(e).__name__, 0) + 1
                continue
            finally:
                dl_mod.uninstall(tok)
            dt = time.perf_counter() - t0
            with mu:
                lat.append(dt)
                late[0] += int(dl.expired())
                answers[i] = resp
                for k, v in resp.tracker.phases.items():
                    phases[k] = phases.get(k, 0) + v

    ts = [threading.Thread(target=worker, args=(ci,))
          for ci in range(EP_CLIENTS)]
    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = counts()
    assert not any(t.is_alive() for t in ts), "a 6b-ep client never ended"
    assert not errors, f"6b-ep errors: {errors}"
    a = np.asarray(lat)
    bad = [i for i, resp in answers.items() if not check(schedule[i], resp)]
    assert not bad, f"6b-ep: {len(bad)} wrong answers, first {bad[:4]}"
    served = len(answers)
    return {"requests": len(schedule), "served": served,
            "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3,
            "wall_s": wall, "req_per_s": served / wall,
            "late_acks": late[0], "launches": launches,
            "backends": {b: sum(r.backend == b for r in answers.values())
                         for b in ("device", "host")},
            "phase_mean_ms": {k: v / served / 1e6
                              for k, v in sorted(phases.items())}}


def run_6b_ep(runner) -> list:
    """Cell 6b-ep: config 6b (bench.py:1130-1300) at the endpoint, three
    tables of 10·2^20 rows, the seeded schedule run twice — the coalescer
    unwired (every device request solo, deferred), then bound (window 150
    ms, groups of at most 16).  Every answer equals its numpy truth; no
    late ack, no degrade, no solo retry; sel_pred_batched launches in the
    coalesced phase only, and its mean occupancy is above 1.5."""
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, \
        Endpoint
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.server.coalescer import RequestCoalescer
    from tikv_tpu_torch.testing import configs as cf
    t0 = time.perf_counter()
    tables = [cf.serving_table(EP_ROWS, tid) for tid in cf.SERVE_TABLE_IDS]
    by_id = {t.table_id: snap for t, snap in tables}
    truths = {thr: cf.serving_truth(EP_ROWS, thr)
              for thr in cf.SERVE_PALETTE + (None,)}
    schedule = cf.serving_schedule(EP_CLIENTS * EP_REQS)
    print(f"6b-ep: tables and truths in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def check(item, resp) -> bool:
        _ti, pi, is_sel = item
        if is_sel:
            return cf.columns_agree(resp.result.batch,
                                    truths[cf.SERVE_PALETTE[pi]])
        return sorted(resp.rows()) == truths[None]

    coal = RequestCoalescer(runner, window_ms=EP_WINDOW_MS,
                            max_group=EP_GROUP)
    ep = Endpoint(lambda req: by_id[req.dag.executors[0].table_id], runner,
                  coalescer=coal)
    out = []
    try:
        ep.coalescer = None
        for ti, (table, _snap) in enumerate(tables):     # warm every table
            for thr in (cf.SERVE_PALETTE[0], None):
                dag = dag_from_wire(enc_dag(cf.dag_serving(table, thr)))
                resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
                assert resp.backend == "device"
                assert check((ti, 0, thr is not None), resp)
        for phase in ("solo", "coalesced"):
            ep.coalescer = coal if phase == "coalesced" else None
            st0 = coal.stats()
            deg0 = dict(ep.degrades)
            got = serve_phase(ep, tables, schedule, check)
            st = coal.stats()
            groups = st["groups_dispatched"] - st0["groups_dispatched"]
            members = st["requests_coalesced"] - st0["requests_coalesced"]
            got.update(config=f"6b-ep {phase}", rows=EP_ROWS,
                       groups=groups,
                       mean_occupancy=members / groups if groups else 0.0,
                       max_occupancy=st["max_occupancy"],
                       solo_retries=st["solo_degrade"] -
                       st0["solo_degrade"],
                       router=st["router"]["decisions"],
                       closes=st["closes"],
                       degrades={k: v - deg0.get(k, 0)
                                 for k, v in ep.degrades.items()
                                 if v != deg0.get(k, 0)})
            print(f"cell 6b-ep {phase}: " + " ".join(
                f"{k}={v}" for k, v in got.items() if k != "config"),
                flush=True)
            assert got["late_acks"] == 0 and not got["degrades"] and \
                got["solo_retries"] == 0, f"6b-ep {phase}: {got}"
            assert got["backends"]["host"] == 0, f"6b-ep {phase}: {got}"
            assert got["launches"]["hash_agg"] > 0, \
                f"6b-ep {phase} never launched hash_agg"
            if phase == "solo":
                assert got["launches"]["sel_pred"] > 0, \
                    "6b-ep solo never launched sel_pred"
                assert got["launches"]["sel_pred_batched"] == 0 and \
                    groups == 0, f"6b-ep solo: {got}"
            else:
                assert got["launches"]["sel_pred_batched"] > 0, \
                    "6b-ep coalesced never launched sel_pred_batched"
                assert got["mean_occupancy"] > 1.5, \
                    f"6b-ep mean occupancy {got['mean_occupancy']}"
            out.append(got)
    finally:
        ep.close()
    del tables, by_id, truths
    gc.collect()
    return out


def analyze_at_main_shapes(runner, dev) -> dict:
    """analyze_column at an4's id, k and v (104,857,600 int32 rows), an4s's
    k (2^24 int64) and an4r's v (2^24 float64), the columns padded as the
    runner uploads them: checked against the plain version there, and
    timed with CUDA events: as issued (``ms``: the wrapper waits once, for
    the range read) and its kernels alone, queued behind a device sleep
    (``kernel_ms``: the range launch plus the sort launch), beside the bound
    (each value and validity byte read once, the packed vector written
    once, at 3.35 TB/s), the plain version and one ``torch.sort`` of the
    same sentinelled column (a yardstick the port never calls)."""
    from tikv_tpu_torch.datatype.tile import _device_dtype
    from tikv_tpu_torch.device import analyze as an
    from tikv_tpu_torch.testing import configs as cf
    saved = counts()
    b = cf.ANALYZE_BUCKETS
    out, errs = {}, {}
    shapes = (("an4", ("id", "k", "v")), ("an4s", ("k",)),
              ("an4r", ("v",)))
    for cell, names in shapes:
        table, snap = cf.ANALYZE_CELLS[cell](ANALYZE_ROWS[cell])
        batch = snap.scan_columns(cf.analyze_request(table).scan, ())
        n = batch.num_rows
        n_pad = runner._pad_rows(n)
        for name in names:
            col = batch.columns[[c.name for c in table.columns].index(name)]
            # the runner's choice: REAL as float64, else the feed dtype
            dt = np.float64 if col.eval_type.value == "real" else \
                _device_dtype(col.eval_type, col.values)
            v = runner._upload(col.values.astype(dt, copy=False), n_pad)
            ok = runner._upload(col.validity, n_pad)
            real = v.dtype == torch.float64
            label = f"{cell} {name}"
            errs[label] = an.packed_max_diff(
                an.analyze_column(v, ok, n, b),
                an.analyze_column_plain(v, ok, n, b), b, real)
            launch = an.ColumnLaunch(v, ok, n, b)
            launch.range()
            n_valid, _lo, _hi, bits = launch.read_range()
            range_ms = cuda_ms(launch.range, 20, queued=True)
            sort_ms = cuda_ms(launch.sort, 10, queued=True)
            mask = (torch.arange(n_pad, device=dev) < n) & ok
            sent = math.nan if real else torch.iinfo(v.dtype).max
            key = torch.where(mask, v, torch.full_like(v, sent))
            out[label] = {
                "ms": cuda_ms(lambda: an.analyze_column(v, ok, n, b), 10),
                "kernel_ms": range_ms + sort_ms, "range_ms": range_ms,
                "sort_ms": sort_ms,
                "plain_ms": cuda_ms(
                    lambda: an.analyze_column_plain(v, ok, n, b), 3),
                "library_ms": cuda_ms(lambda: torch.sort(key), 5),
                "library_call": "torch.sort of the sentinelled column",
                **bound_ms(n * (v.element_size() + 1) + (2 * b + 2) * 8, 0),
                "rows": n, "dtype": str(v.dtype).replace("torch.", ""),
                "key_bits": bits, "passes": -(-bits // 8),
                "n_valid": n_valid,
                "timed": "ms: the wrapper as issued (it waits once, for the "
                         "range read); kernel_ms: range + sort launches "
                         "queued"}
            print(f"analyze at {label}: {json.dumps(out[label])}",
                  flush=True)
            del v, ok, key, mask, launch
        del table, snap, batch
        gc.collect()
        torch.cuda.empty_cache()
    set_counts(saved)
    for label, e in errs.items():
        assert e == 0, f"analyze disagrees with its plain version at " \
            f"{label}: {e}"
    return out, max(errs.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tikv_tpu_torch.device import DeviceRunner

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    build_kernels()

    dev = torch.device("cuda", 0)
    worst = {"hash_agg": check_kernels(dev, 1 << 24),
             "twolevel": max(check_fused(dev), check_twolevel(dev))}
    worst["sel_pred"] = check_pred(dev)
    worst["sel_pred_batched"] = check_batched(dev)
    worst["sel_mask"], worst["sel_compact"] = check_selection(dev)
    worst["topn_select"] = check_topn(dev)
    worst["agg_fold"] = check_agg_fold(dev)
    worst["plane_digest"], worst["patch_rows"] = check_digest(dev)
    worst["mvcc_resolve"] = check_mvcc(dev)
    worst["sort_perm"] = worst["join_build"] = check_sort(dev)
    worst["join_probe"] = worst["join_index"] = check_join(dev)
    worst["window_scan"] = check_window(dev)

    runner = DeviceRunner()
    runs = [run_config(c, SIZES[c], runner) for c in SIZES]
    runs += [run_row_config(c, ROW_SIZES[c], runner) for c in ROW_SIZES]
    runs += run_sweep(runner)
    runs.append(run_uncovered(runner))
    worst["patch_rows"] = max(worst["patch_rows"], check_spill(runner, dev))
    cold = {c: run_cold(c, COLD_SIZES[c], runner) for c in COLD_SIZES}
    snap6c = cold["6c"].pop("snapshot")
    runs += cold.values()
    ep, pair = plan_endpoint(runner)
    runs += [run_plan(c, ep, pair) for c in PLAN_ROUTE]
    worst["analyze"] = check_analyze(dev)
    runs += [run_analyze(c, runner) for c in ANALYZE_ROWS]
    runs.append(run_analyze("an6c", runner, snap6c._tbl.table, snap6c))
    del snap6c
    run_checksum()
    runs.append(run_deferred(runner))
    runs += run_6b_ep(runner)
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}
    print("host phases of one warm request (ms, host clock, median of 5): "
          + "; ".join(f"config {r['config']}: " + " ".join(
              f"{k}={v}" for k, v in r["host_phases_ms"].items())
                      for r in runs if "host_phases_ms" in r), flush=True)
    err, hash_timings = kernel_at_main_shapes(dev)
    worst["hash_agg"] = max(worst["hash_agg"], err)
    hash_timing = {k: v for k, v in hash_timings["4"].items()
                   if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}
    hash_timing["configs"] = hash_timings
    err, two_timing = twolevel_at_main_shapes(runner, dev)
    worst["twolevel"] = max(worst["twolevel"], err)
    pred_timing, mask_timing, compact_timing = selection_at_main_shapes(dev)
    batched_timing = batched_at_main_shape(dev)
    topn_timing, pred_timing_5t = topn_at_main_shapes(runner, dev)
    pred_timing = dict(pred_timing, configs={"2": dict(pred_timing),
                                             "5t": pred_timing_5t})
    err, fold_timing = fold_at_main_shapes(runner, dev)
    worst["agg_fold"] = max(worst["agg_fold"], err)

    kernels = [
        {"name": "hash_agg", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/hash_agg.cu",
         "replaces": "tikv_tpu/device/pallas_hash.py:199",
         "launches": launches["hash_agg"], "max_abs_err": worst["hash_agg"],
         **hash_timing},
        {"name": "twolevel", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/twolevel.cu",
         "replaces": "prof/prof_pl.py:44, prof/prof_pl2.py:43, "
                     "prof/prof_pallas.py:92 and :147",
         "launches": launches["twolevel"], "max_abs_err": worst["twolevel"],
         **two_timing},
        {"name": "sel_pred", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:227",
         "launches": launches["sel_pred"], "max_abs_err": worst["sel_pred"],
         **pred_timing},
        {"name": "sel_pred_batched", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:273",
         "launches": launches["sel_pred_batched"],
         "max_abs_err": worst["sel_pred_batched"], **batched_timing},
        {"name": "sel_mask", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:227",
         "launches": launches["sel_mask"], "max_abs_err": worst["sel_mask"],
         **mask_timing},
        {"name": "sel_compact", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/selection.cu",
         "replaces": "tikv_tpu/device/selection.py:323 and :357",
         "launches": launches["sel_compact"],
         "max_abs_err": worst["sel_compact"], **compact_timing},
        {"name": "topn_select", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/topn.cu",
         "replaces": "tikv_tpu/device/runner.py:2825",
         "launches": launches["topn_select"],
         "max_abs_err": worst["topn_select"], **topn_timing},
        {"name": "agg_fold", "route": "cuda",
         "source": "tikv_tpu_torch/csrc/agg_fold.cu",
         "replaces": "tikv_tpu/device/runner.py:2701 and :2668",
         "launches": launches["agg_fold"], "max_abs_err": worst["agg_fold"],
         **fold_timing}]
    for name, source, replaces in (
            ("mvcc_resolve", "mvcc.cu", "tikv_tpu/device/mvcc.py:531"),
            ("plane_digest", "digest.cu", "tikv_tpu/device/runner.py:1981"),
            ("patch_rows", "digest.cu",
             "tikv_tpu/device/runner.py:1816 and :2023, "
             "tikv_tpu/device/mvcc.py:514")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tikv_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            **cold["4h"]["timing"][name],
            "configs": {c: r["timing"][name] for c, r in cold.items()}})
    errs, plan_timing = plan_kernels_at_main_shapes(pair, dev)
    del ep, pair
    for name, source, replaces in (
            ("join_build", "sort.cu", "tikv_tpu/device/join.py:257"),
            ("join_index", "join.cu",
             "tikv_tpu/device/join.py:276 (the searchsorted of "
             "_probe_kernel, once per build)"),
            ("join_probe", "join.cu", "tikv_tpu/device/join.py:276"),
            ("sort_perm", "sort.cu", "tikv_tpu/device/join.py:479"),
            ("window_scan", "window.cu", "tikv_tpu/device/join.py:508")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tikv_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(worst[name], errs[name]),
            **plan_timing[name]})
    analyze_timing, err = analyze_at_main_shapes(runner, dev)
    worst["analyze"] = max(worst["analyze"], err)
    kernels.append({
        "name": "analyze", "route": "cuda",
        "source": "tikv_tpu_torch/csrc/analyze.cu",
        "replaces": "tikv_tpu/device/runner.py:4478",
        "launches": launches["analyze"], "max_abs_err": worst["analyze"],
        **{k: v for k, v in analyze_timing["an4 id"].items()
           if k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_call", "rows", "dtype",
                    "passes")},
        "configs": analyze_timing})
    assert all(k["route"] == "cuda" for k in kernels), "a timing key clash"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
