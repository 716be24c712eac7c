"""The port's stable argsort and join build dictionary (``device/sort.py``,
the plain versions of ``csrc/sort.cu``) against the JAX package's
``DeviceJoiner.sort_perm`` and ``_build_kernel`` on one CPU device.

The same seeded numpy keys go to both: int64 extremes and the NULL
sentinels, float64 with ±0.0, ±inf and NaN, ties, one to three keys, n =
0, 1 and sizes off the reference's pad.  Everything compared is an
integer or a permutation: equal exactly (tolerance 0).
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


def key_of(kind: str, rng, n: int) -> np.ndarray:
    if kind == "i64":          # the whole range, its extremes, sentinels
        k = rng.integers(I64.min, I64.max, n, dtype=np.int64,
                         endpoint=True)
        for val, share in ((I64.min, 0.05), (I64.max, 0.05),
                           (I64.min + 2, 0.03), (I64.max - 1, 0.03)):
            k[rng.random(n) < share] = val
        return k
    if kind == "ties":
        return rng.integers(-2, 3, n).astype(np.int64)
    if kind == "f64":
        f = rng.normal(0, 100, n)
        for val, share in ((0.0, 0.1), (-0.0, 0.1), (np.inf, 0.05),
                           (-np.inf, 0.05), (np.nan, 0.05),
                           (-np.nan, 0.03)):
            f[rng.random(n) < share] = val
        return f
    if kind == "f64_ties":
        return rng.integers(-2, 3, n).astype(np.float64) * 0.5
    raise ValueError(kind)


SORT_CASES = [
    (("i64",), 1000), (("ties",), 777), (("f64",), 1000),
    (("f64_ties",), 513), (("ties", "i64"), 1000), (("ties", "f64"), 999),
    (("f64_ties", "ties", "i64"), 1500), (("ties", "ties", "ties"), 4097),
    (("i64",), 1), (("f64",), 1), (("ties", "f64"), 0), (("i64",), 0),
    (("ties",), 4096), (("f64", "ties"), 1025),
]


@pytest.mark.parametrize("kinds,n", SORT_CASES,
                         ids=[f"{'-'.join(k)}-{n}" for k, n in SORT_CASES])
def test_sort_perm_matches_reference(ref, kinds, n):
    rng = np.random.default_rng(n * 7 + len(kinds))
    keys = [key_of(k, rng, n) for k in kinds]
    want = ref.sort_perm(keys, n)
    got = srt.sort_perm([torch.from_numpy(k) for k in keys], n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("kind", ["i64", "f64", "ties", "f64_ties"])
def test_order_image_sorts_as_numpy(kind):
    """A key's order image sorts as np.argsort(kind="stable") sorts the
    key (NaN last, -0.0 equal to +0.0)."""
    rng = np.random.default_rng(5)
    k = key_of(kind, rng, 3000)
    img = srt.order_image(torch.from_numpy(k))
    assert img.dtype == torch.int64
    np.testing.assert_array_equal(
        torch.argsort(img, stable=True).numpy(),
        np.argsort(k, kind="stable"))


def test_byte_key_and_identity():
    rng = np.random.default_rng(6)
    b = rng.random(500) < 0.5
    got = srt.sort_perm([torch.from_numpy(b)], 500)
    np.testing.assert_array_equal(got.numpy(), np.argsort(b, kind="stable"))
    np.testing.assert_array_equal(srt.sort_perm([], 4).numpy(),
                                  np.arange(4))


BUILD_CASES = [
    # (n live rows, pad rows, key domain, NULL share, sentinel share)
    (1000, 0, 50, 0.1, 0.0), (1000, 24, 50, 0.1, 0.05),
    (1, 0, 1, 0.0, 0.0), (1, 7, 1, 0.0, 1.0), (500, 12, 3, 0.5, 0.1),
    (4097, 100, 10 ** 6, 0.0, 0.0), (300, 0, 300, 0.0, 0.0),
    (64, 64, 5, 1.0, 0.0),
]


@pytest.mark.parametrize("n,pad,dom,null_p,sent_p", BUILD_CASES)
def test_join_build_matches_reference(ref, n, pad, dom, null_p, sent_p):
    """sk, perm and prefix equal the reference's _build_kernel over the
    same padded planes: valid rows first within equal keys, a valid key
    equal to the int64.max sentinel before the invalid rows."""
    rng = np.random.default_rng(n + pad)
    n_pad = n + pad
    keys = rng.integers(-dom, dom, n_pad).astype(np.int64)
    keys[rng.random(n_pad) < sent_p] = I64.max
    valid = rng.random(n_pad) >= null_p
    want = ref._build_kernel(n_pad)(jnp.asarray(n, jnp.int64),
                                    jnp.asarray(keys), jnp.asarray(valid))
    got = srt.join_build(torch.from_numpy(keys), torch.from_numpy(valid), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32 and got[2].shape == (n_pad + 1,)


def test_wrappers_check_their_inputs():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="rows"):
        srt.sort_perm([k], 5)
    with pytest.raises(ValueError, match="expected one of"):
        srt.sort_perm([k.to(torch.int32)], 4)
    with pytest.raises(ValueError, match="2\\^31"):
        srt.sort_perm([k], 1 << 31)
    with pytest.raises(ValueError, match="at most"):
        srt.sort_perm([k] * (srt.MAX_KEYS + 1), 4)
    with pytest.raises(ValueError, match="bool"):
        srt.join_build(k, k, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        srt.sort_perm([k.to("meta")], 4)
