"""The packing rule of the port's sort (``device/sort.py`` ``pack_groups``,
what ``csrc/sort.cu`` sorts) against the JAX package's
``DeviceJoiner.sort_perm`` and ``_build_kernel`` on one CPU device.

``sort_perm_packed_plain`` sorts as the kernels group the keys: each key's
width is the bit length of its range of order images, consecutive keys
from the least significant pack into one unsigned image while the widths
sum to at most 64, and each packed image takes one stable argsort, the
least significant group first.  The same seeded numpy keys go to the
reference: total widths of 31, 32, 33, 64 and 65 bits, int64 extremes,
float64 with NaN, ±0.0 and ±inf, byte and constant keys, one to eight
keys, n = 0, 1 and 4095-4097.  ``join_build``'s plain version is held
against the packed sort of its (sentineled key, not valid) keys, with and
without NULLs.  Everything compared is a permutation or an integer:
equal exactly (tolerance 0).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tikv_tpu.device.join import DeviceJoiner as RefJoiner
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.parallel import make_mesh

from tikv_tpu_torch.device import sort as srt

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref():
    return RefJoiner(RefRunner(mesh=make_mesh(jax.devices()[:1])))


def of_width(rng, n: int, bits: int, lo: int) -> np.ndarray:
    """int64 keys spanning exactly ``bits`` bits of images from ``lo``."""
    span = (1 << bits) - 1
    k = lo + (rng.integers(0, 1 << 62, n) % (span + 1)).astype(np.int64)
    k[0], k[1 % n] = lo, lo + span
    return k


def special_floats(rng, n: int) -> np.ndarray:
    f = rng.normal(0, 100, n)
    for val, share in ((0.0, 0.1), (-0.0, 0.1), (np.inf, 0.05),
                       (-np.inf, 0.05), (np.nan, 0.05), (-np.nan, 0.03)):
        f[rng.random(n) < share] = val
    return f


def extremes(rng, n: int) -> np.ndarray:
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    k[rng.random(n) < 0.1] = I64.min
    k[rng.random(n) < 0.1] = I64.max
    return k


def keys_for(case: str, rng, n: int) -> list:
    if case.startswith("w"):                   # "w20+11": two widths
        hi, lo = (int(x) for x in case[1:].split("+"))
        return [of_width(rng, n, hi, -(1 << (hi - 1))),
                of_width(rng, n, lo, 7)]
    if case == "extremes":
        return [extremes(rng, n), rng.integers(-2, 3, n)]
    if case == "floats":
        return [special_floats(rng, n), rng.integers(0, 3, n) * 0.5]
    if case == "byte_const":
        return [rng.random(n) < 0.5, np.full(n, -5, np.int64),
                rng.integers(0, 4, n)]
    if case.startswith("k"):                   # "k8": eight mixed keys
        makers = (lambda: rng.integers(-3, 3, n),
                  lambda: rng.random(n) < 0.3,
                  lambda: rng.integers(0, 5, n) * 0.25,
                  lambda: np.full(n, 9, np.int64),
                  lambda: of_width(rng, n, 30, 0),
                  lambda: special_floats(rng, n),
                  lambda: extremes(rng, n),
                  lambda: rng.integers(0, 2, n))
        return [makers[j]() for j in range(int(case[1:]))]
    raise ValueError(case)


# total widths and the groups they pack into (widths computed from the keys)
WIDTHS = {"w20+11": [31], "w21+11": [32], "w22+11": [33], "w32+32": [64],
          "w33+32": [32, 33]}
CASES = [(c, 4097) for c in WIDTHS] + [
    ("extremes", 4096), ("extremes", 1), ("floats", 4095), ("floats", 0),
    ("byte_const", 4097), ("byte_const", 1)] + [
    (f"k{j}", n) for j in range(1, 9) for n in (4095, 4097)]


@pytest.mark.parametrize("case,n", CASES,
                         ids=[f"{c}-{n}" for c, n in CASES])
def test_packed_sort_matches_reference(ref, case, n):
    rng = np.random.default_rng(sum(map(ord, case)) + n)
    keys = keys_for(case, rng, n)
    want = ref.sort_perm([k.astype(np.int64) if k.dtype == np.bool_ else k
                          for k in keys], n)
    got = srt.sort_perm_packed_plain([torch.from_numpy(k) for k in keys], n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        srt.sort_perm_plain([torch.from_numpy(k) for k in keys], n).numpy(),
        got.numpy())
    if case in WIDTHS:
        images = [srt.order_image(torch.from_numpy(k)) for k in keys]
        widths = [srt.key_width(int(i.min()), int(i.max())) for i in images]
        assert [bits for _k, _o, bits in srt.pack_groups(widths)] == \
            WIDTHS[case]


@pytest.mark.parametrize("widths,want", [
    ([20, 11], [([1, 0], [0, 11], 31)]),
    ([32, 32], [([1, 0], [0, 32], 64)]),
    ([33, 32], [([1], [0], 32), ([0], [0], 33)]),
    ([64, 1], [([1], [0], 1), ([0], [0], 64)]),
    ([0, 5, 0], [([1], [0], 5)]),
    ([0, 0], []),
    ([8] * 8, [(list(range(7, -1, -1)), [8 * j for j in range(8)], 64)]),
    ([64] * 3, [([2], [0], 64), ([1], [0], 64), ([0], [0], 64)]),
])
def test_pack_groups_rule(widths, want):
    """From the least significant key, consecutive keys share an image
    while their widths sum to at most 64; a constant key drops out."""
    assert srt.pack_groups(widths) == want


def test_key_width_and_work():
    assert srt.key_width(5, 5) == 0 and srt.key_width(0, 1) == 1
    assert srt.key_width(-(1 << 63), (1 << 63) - 1) == 64
    assert srt.key_width(0, (1 << 64) - 1) == 64
    # 31 bits: four passes over 4096-row tiles; 33: five over 2048-row ones
    n = 10 << 20
    assert srt.work_words(n, [([0], [0], 31)]) == \
        4 * (2560 * 256 + 256 + 1)
    assert srt.work_words(n, [([0], [0], 33)]) == \
        5 * (5120 * 256 + 256 + 1)


@pytest.mark.parametrize("n,null_p,sent_p", [
    (4097, 0.0, 0.0), (4096, 0.2, 0.05), (1, 0.0, 0.0), (1, 1.0, 0.0),
    (4095, 0.5, 0.0), (0, 0.0, 0.0)])
def test_join_build_is_the_packed_sort_of_its_keys(ref, n, null_p, sent_p):
    """The build dictionary's permutation is the packed sort of (skey,
    not valid), with and without NULLs, and both equal the reference's."""
    rng = np.random.default_rng(n + int(10 * null_p))
    keys = rng.permutation(n).astype(np.int64) if null_p == 0 else \
        rng.integers(-50, 50, n).astype(np.int64)
    keys[rng.random(n) < sent_p] = I64.max
    valid = rng.random(n) >= null_p
    kt, vt = torch.from_numpy(keys), torch.from_numpy(valid)
    skey = torch.where(vt, kt, torch.full_like(kt, I64.max))
    nsv = ~vt
    packed = srt.sort_perm_packed_plain([skey, nsv], n)
    sk, perm, prefix, _keys = srt.join_build_plain(kt, vt, n)
    np.testing.assert_array_equal(perm.numpy(), packed.numpy())
    if n:
        want = ref._build_kernel(n)(jnp.asarray(n, jnp.int64),
                                    jnp.asarray(keys), jnp.asarray(valid))
        for g, w in zip((sk, perm, prefix), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        images = [srt.order_image(t) for t in (skey, nsv)]
        widths = [srt.key_width(int(i.min()), int(i.max())) for i in images]
        groups = srt.pack_groups(widths)
        # no NULL: one group of the keys alone (config 7's shape); NULLs
        # widen the key to the sentinel and split the groups
        assert len(groups) == (2 if 0 < null_p < 1 else 1 if n > 1 else 0)
