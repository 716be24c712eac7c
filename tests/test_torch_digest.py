"""Plane digests and row patches: the port's plain versions of
``csrc/digest.cu`` against the JAX package.

``plane_digest_plain`` against the reference's ``host_plane_digest``
(device/supervisor.py:79) and its runner's jitted ``_range_digest_kernel``
/ ``device_digest`` (runner.py:1981, :2014) on the same planes, full and
over [lo, hi); ``patch_rows_plain`` against a sequence of the reference's
``_dus`` (runner.py:1816), and the incremental digest rule against a full
recompute; the duplicate-position refusal; ``corrupt_resident_plane`` and
``scrub_feed`` on the port's runner.  Every comparison is exact: digests
are integers mod 2^64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.supervisor import host_plane_digest as ref_digest
from tikv_tpu.parallel import make_mesh

from tikv_tpu_torch.device import digest as dg
from tikv_tpu_torch.device import supervisor as sv
from tikv_tpu_torch.device.runner import DeviceRunner

N = 5003
DTYPES = ("bool", "int8", "int16", "int32", "int64", "float32", "float64")


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def plane(dtype: str, n: int = N, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        return rng.normal(0.0, 1e6, n).astype(dtype)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True) \
        .astype(dtype)
    a[:2] = (info.min, info.max)
    return a


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_digest_matches_reference(ref, dtype):
    a = plane(dtype)
    for n in (0, 1, 17, N):
        want = ref_digest(a, n)
        assert sv.host_plane_digest(a, n) == want
        assert dg.as_u64(dg.plane_digest(torch.from_numpy(a), 0, n)) == want
        assert int(np.asarray(ref.device_digest(jnp.asarray(a), n))) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_range_digest_matches_reference_kernel(ref, dtype):
    a = plane(dtype, seed=6)
    rng_fn = ref._range_digest_kernel(a.dtype, N)
    t = torch.from_numpy(a)
    for lo, hi in ((0, N), (1, 2), (3, 4000), (4097, N), (N, N), (7, 7),
                   (0, 16), (15, 33)):
        want = int(np.asarray(rng_fn(jnp.asarray(a), jnp.asarray(lo),
                                     jnp.asarray(hi))))
        assert dg.as_u64(dg.plane_digest_plain(t, lo, hi)) == want, (lo, hi)
        assert dg.as_u64(dg.plane_digest(t, lo, hi)) == want, (lo, hi)


def test_host_digest_steps_agree():
    """The port's host digest steps through the plane in slices of
    ``_STEP`` rows; every slice boundary keeps the reference's value."""
    a = plane("int64", 3 * sv._STEP + 5)
    for n in (sv._STEP - 1, sv._STEP, sv._STEP + 1, 3 * sv._STEP + 5):
        assert sv.host_plane_digest(a, n) == ref_digest(a, n)


@pytest.mark.parametrize("span", (1, 7, 1000, N, 2 * N))
def test_pooled_digests_match_reference(span):
    """``start_plane_digests`` hashes in jobs of ``span`` rows on a pool;
    every split keeps the reference's value, a plane cast to a feed dtype
    included (the mint hashes int64 mirror values as int32)."""
    from concurrent.futures import ThreadPoolExecutor
    planes = [plane(dt) for dt in DTYPES]
    wide = plane("int64", seed=6)
    with ThreadPoolExecutor(3) as pool:
        got = sv.start_plane_digests(
            pool, [(a, None) for a in planes] + [(wide, np.dtype("int32"))],
            N - 3, span)()
    assert got == tuple(ref_digest(a, N - 3) for a in planes) + (
        ref_digest(wide.astype(np.int32), N - 3),)


@pytest.mark.parametrize("dtype", DTYPES)
def test_patch_rows_matches_reference_dus(ref, dtype):
    a = plane(dtype, seed=7)
    new = plane(dtype, 64, seed=8)
    pos = np.random.default_rng(9).choice(N, 64, replace=False)
    want = jnp.asarray(a)
    for p, v in zip(pos, new):
        want = ref._dus(want, jnp.asarray(np.asarray([v], a.dtype)), int(p))
    got = torch.from_numpy(a.copy())
    sums = dg.patch_rows(got, pos, torch.from_numpy(new), digest=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    def h(x):
        """Σ bits·(2p+1) mod 2^64 over the patched positions."""
        return sum(b * (2 * int(p) + 1)
                   for b, p in zip(_bits(x), pos)) % 2 ** 64

    assert dg.as_u64(sums[0]) == h(a[pos])
    assert dg.as_u64(sums[1]) == h(new)
    # the incremental rule over the patched rows equals a full recompute
    rule = (ref_digest(a, N) - dg.as_u64(sums[0]) + dg.as_u64(sums[1])) \
        % 2 ** 64
    assert rule == ref_digest(np.asarray(want), N)
    assert dg.patch_rows(got, pos[:3], torch.from_numpy(new[:3])) is None


def _bits(x: np.ndarray) -> list:
    if x.dtype == np.bool_:
        return [int(b) for b in x]
    return [int(b) for b in x.view(f"u{x.dtype.itemsize}")]


def test_patch_rows_refuses_duplicates_and_strays():
    t = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="duplicate"):
        dg.patch_rows(t, [3, 4, 3], torch.tensor([1, 2, 3],
                                                 dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        dg.patch_rows(t, [10], torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="positions"):
        dg.patch_rows(t, [1, 2], torch.tensor([1], dtype=torch.int32))
    assert not t.any()
    with pytest.raises(ValueError, match="outside"):
        dg.plane_digest(t, 3, 11)


def _feed(port, dtypes, n=3000):
    cols = [(plane(d, n, seed=11 + i), np.random.default_rng(i).random(n)
             >= 0.1) for i, d in enumerate(dtypes)]
    return port._build_flat(cols, n), cols


@pytest.mark.parametrize("dtype", DTYPES[1:])
def test_corrupt_flips_one_bit_and_the_scrub_names_the_plane(port, dtype):
    feed, _cols = _feed(port, ("int32", dtype))
    assert feed["null_flags"] == (True, True)
    assert port.scrub_feed(feed) == []
    before = [t.clone() for t in feed["flat"]]
    for fi in (2, 1):
        port.corrupt_resident_plane(feed, fi)
        a, b = before[fi].numpy(), feed["flat"][fi].numpy()
        if a.dtype == np.bool_:
            diff = int((a != b).sum())
        else:
            u = f"u{a.dtype.itemsize}"
            diff = sum(bin(int(x)).count("1")
                       for x in (a.view(u) ^ b.view(u)))
        assert diff == 1
        assert port.scrub_feed(feed) == sorted({fi, 2})


def test_patch_plane_keeps_the_digest_and_never_launders(port):
    feed, cols = _feed(port, ("int64", "float32"))
    port._patch_plane(feed, [(5, 6), (2999, 3000)], [torch.tensor([-1, 7])],
                      [0])
    assert port.scrub_feed(feed) == []
    assert int(feed["flat"][0][2999]) == 7
    # a corruption before a patch survives it, beside the patched rows or
    # under them: the rule never re-hashes the device plane
    port.corrupt_resident_plane(feed, 2)
    port._patch_plane(feed, [(9, 10)], [torch.tensor([2.5])], [2])
    assert port.scrub_feed(feed) == [2]
    port._patch_plane(feed, [(0, 1)], [torch.tensor([1.5])], [2])
    assert port.scrub_feed(feed) == [2]
    assert dg.as_u64(feed["digests"][0]) == sv.host_plane_digest(
        feed["flat"][0].numpy(), 3000)
