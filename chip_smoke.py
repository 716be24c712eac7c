#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``tikv_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``tikv_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together; timed, with the ptxas report and the shared
   atomics in ``hash_agg``'s SASS);
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
   was resident before it, and one profiled warm request; for 3, 4 and 4s
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
6. one JSON line listing every ported kernel: launches on the main path,
   largest difference from the plain version, kernel / plain / library
   times at its main shape (config 4 for ``hash_agg``, with configs 3, 4
   and 4s under ``configs``; config 4n for ``twolevel``'s fused entry, with
   its route at each config), and the least time the card could take;
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit peak
SF_TOL = 1e-9                   # float cells: × Σ|v| of the cell
CLOCK_HZ = 1.98e9               # H100 SXM boost clock (sleep cycles)

KERNELS = ("hash_agg", "twolevel")
# config → rows on the card; the route's kernel counts must be > 0
SIZES = {"3": 50 << 20, "4": 100 << 20, "4s": 1 << 24, "4n": 100 << 20,
         "4w": 100 << 20, "4r": 1 << 24, "4m": 1 << 24, "3n": 1 << 24}
ROUTE = {"3": "hash_agg", "4": "hash_agg", "4s": "hash_agg",
         "4n": "twolevel", "4w": "twolevel", "4r": "twolevel",
         "4m": None, "3n": None}


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
    from tikv_tpu_torch.device import hash_agg, twolevel
    return {"hash_agg": hash_agg.launches, "twolevel": twolevel.launches}


def set_counts(values: dict) -> None:
    from tikv_tpu_torch.device import hash_agg, twolevel
    hash_agg.launches = values["hash_agg"]
    twolevel.launches = values["twolevel"]


def build_kernels() -> None:
    from tikv_tpu_torch.device import build

    def one(name):
        t0 = time.perf_counter()
        log = build.build(name)
        return name, time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, secs, log in pool.map(one, KERNELS):
            print(f"build: {name} in {secs:.3f} s", flush=True)
            print(f"ptxas {name}: {ptxas_summary(log)}", flush=True)
    shared_atomics("hash_agg")


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


def shared_atomics(name: str) -> None:
    """Print the shared-memory atomic instructions of a built library's
    SASS by kind (``cuobjdump -sass``), e.g. whether a 64-bit add is one
    ATOMS.ADD.64 or a compare-and-swap loop."""
    from tikv_tpu_torch.device import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True).stdout
    kinds: dict = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith("ATOMS"):
                kinds[word] = kinds.get(word, 0) + 1
    print(f"sass {name}: shared atomics " + (" ".join(
        f"{k}x{v}" for k, v in sorted(kinds.items())) or "none"), flush=True)


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

def run_config(config: str, n: int, runner) -> dict:
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing import configs as cf

    build, make = cf.CONFIGS[config]
    table, snap = build(n)
    dag = dag_from_wire(enc_dag(make(table)))
    want, scales = cf.truth(config, snap)

    def agrees(rows) -> bool:
        return cf.rows_agree(rows, want, scales, SF_TOL)

    set_counts({k: 0 for k in KERNELS})
    t0 = time.perf_counter()
    rows = runner.handle_request(dag, snap).rows()
    cold = time.perf_counter() - t0
    assert agrees(rows), f"config {config}: wrong answer on the cold request"
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        rows = runner.handle_request(dag, snap).rows()
        warm.append(time.perf_counter() - t0)
        assert agrees(rows), f"config {config}: wrong answer when warm"
    launches = counts()
    for name in KERNELS:
        if name == ROUTE[config]:
            assert launches[name] > 0, f"config {config} never launched {name}"
        else:
            assert launches[name] == 0, f"config {config} launched {name}"
    p50 = float(np.percentile(warm, 50))
    out = {"config": config, "rows": n, "cold_ms": cold * 1e3,
           "warm_p50_ms": p50 * 1e3, "rows_per_s": n / p50,
           "launches": launches, "groups": len(want),
           "peak_request_bytes": peak_request_bytes(runner, dag, snap)}
    print(f"config {config}: " + " ".join(f"{k}={v}" for k, v in out.items()
                                          if k != "config"), flush=True)
    profile_request(config, runner, dag, snap)
    if ROUTE[config] == "hash_agg":
        out["host_phases_ms"] = host_phases(runner, dag, snap)
    del snap
    gc.collect()
    return out


def host_phases(runner, dag, snap, repeats: int = 5) -> dict:
    """Host-clock phases (ms, the median of ``repeats`` warm requests) of a
    request on the hash_agg route: analyze (``_analyze``), inputs
    (``_inputs``: the feed's planes and the selection), launch
    (``hash_agg``: lane plan and kernel launch), d2h_wait (the rest of
    ``_aggregate``: the lane list, then the one D2H copy, which waits for
    the kernel), finalize (``states_from_lanes`` and the result columns)
    and other (the rest of ``handle_request``: feed and meta lookups)."""
    from tikv_tpu_torch.device import hash_agg as ha
    saved = counts()
    names = ("_analyze", "_inputs", "_aggregate", "_simple_result",
             "_hash_result", "hash_agg", "states_from_lanes")
    runs = []
    for _ in range(repeats):
        spent = dict.fromkeys(names, 0.0)

        def timed(name, fn):
            def wrap(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[name] += time.perf_counter() - t0
            return wrap

        originals = {n: getattr(ha, n) for n in names[5:]}
        for n in names[:5]:
            setattr(runner, n, timed(n, getattr(runner, n)))
        for n, fn in originals.items():
            setattr(ha, n, timed(n, fn))
        try:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            total = time.perf_counter() - t0
        finally:
            for n in names[:5]:
                delattr(runner, n)
            for n, fn in originals.items():
                setattr(ha, n, fn)
        ms = {k: v * 1e3 for k, v in spent.items()}
        result = ms["_simple_result"] + ms["_hash_result"]
        runs.append({
            "analyze": ms["_analyze"], "inputs": ms["_inputs"],
            "launch": ms["hash_agg"],
            "d2h_wait": ms["_aggregate"] - ms["_inputs"] - ms["hash_agg"]
            - ms["states_from_lanes"],
            "finalize": ms["states_from_lanes"] + result,
            "other": total * 1e3 - ms["_analyze"] - ms["_aggregate"] - result,
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


def profile_request(config: str, runner, dag, snap) -> None:
    """One warm request under torch.profiler: device time by kernel and
    the device's idle share of the (profiled) request wall."""
    from torch.profiler import ProfilerActivity, profile
    saved = counts()
    for _attempt in range(3):           # the tracer now and then sees none
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.handle_request(dag, snap)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    set_counts(saved)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile config {config}: wall_ms={wall_ms} device_ms={dev_ms} "
          f"idle_share={1 - dev_ms / wall_ms} top=" + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3}ms"
              for e in top), flush=True)


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


def captured_twolevel_inputs(config: str, runner) -> tuple:
    """twolevel_fused's arguments exactly as the runner passes them on one
    request of ``config`` (recorded around the call; not counted)."""
    import tikv_tpu_torch.device.runner as rmod
    from tikv_tpu_torch.testing import configs as cf
    build, make = cf.CONFIGS[config]
    table, snap = build(SIZES[config])
    seen = []
    real = rmod.twolevel_fused

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    saved = counts()
    rmod.twolevel_fused = record
    try:
        runner.handle_request(make(table), snap)
    finally:
        rmod.twolevel_fused = real
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
        args, kwargs = captured_twolevel_inputs(config, runner)
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

    runner = DeviceRunner()
    runs = [run_config(c, SIZES[c], runner) for c in SIZES]
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
         **two_timing}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
