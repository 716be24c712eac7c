"""The direct index of a dense build dictionary (``join_probe.join_index``
and the probe's dense route, the plain versions of ``csrc/join.cu``'s
``index_kernel`` and ``probe_kernel<true>``) against the JAX package's
``_probe_kernel`` on the same seeded inputs, run on the CPU.

Each case builds the dictionary with the reference's own build kernel and
with ``sort.join_build``, probes it through the reference and through the
port with the index (where the route takes one) and without it; pairs and
totals are integers and must be equal exactly (tolerance 0).  Cases: dense
keys, dense keys with gaps, duplicates, NULLs on both sides, a negative
least key, keys at int64.min and int64.max − 1, a valid int64.max build
key (the sparse route), spans at the threshold and one past it, a k_cap
below the total and no valid build key.  ``join_index`` takes the host
``BuildKeys`` that ``join_build`` hands on (the valid count, the least and
the greatest valid key, read on the card in the build's one wait): on
every case they equal the numbers of the reference's own dictionary, and
the index built from them equals one searched in that dictionary.  Then
the route's choice.  ``DeviceJoiner`` on each route is held against the
reference's join in ``test_torch_join.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.parallel import make_mesh

from tikv_tpu_torch.device import join_probe as jp
from tikv_tpu_torch.device import sort as srt

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


def _span_keys(rng, nv: int, span: int) -> np.ndarray:
    """nv distinct keys from 0 to span − 1, both ends included."""
    inner = rng.choice(np.arange(1, span - 1), nv - 2, replace=False)
    return rng.permutation(np.concatenate([[0, span - 1], inner]))


def _case(name: str) -> tuple:
    """→ (build keys, build validity, probe keys, probe validity, mask,
    k_cap, whether the build takes the direct index)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    npr, k_cap, dense = 3000, 1 << 15, True
    bvalid_p = pvalid_p = 1.0
    if name == "dense":
        bk = rng.permutation(1000)
        pk = rng.integers(-10, 1010, npr)
    elif name == "dense_gaps":
        bk = rng.permutation(rng.choice(1500, 1000, replace=False))
        pk = rng.integers(-10, 1510, npr)
    elif name == "duplicates":
        bk = rng.integers(0, 200, 1000)
        pk = rng.integers(0, 220, npr)
    elif name == "nulls":
        bk = rng.integers(0, 200, 1000)
        pk = rng.integers(0, 220, npr)
        bvalid_p = pvalid_p = 0.8
    elif name == "negative_min":
        bk = rng.permutation(2000) - 1000
        pk = rng.integers(-1100, 1100, npr)
    elif name == "int64_min":
        bk = I64.min + rng.permutation(500)
        pk = I64.min + rng.integers(0, 600, npr)
        pk[:6] = [I64.max, I64.max - 1, 0, -1, I64.min, I64.min + 499]
    elif name == "int64_max_less_1":
        bk = I64.max - 1 - rng.permutation(500)
        pk = I64.max - rng.integers(0, 600, npr)
        pk[:6] = [I64.min, I64.min + 1, 0, -1, I64.max, I64.max - 1]
    elif name == "valid_int64_max":
        bk = rng.permutation(500)
        bk[0] = I64.max
        pk = rng.integers(0, 520, npr)
        pk[:20] = I64.max
        dense = False
    elif name == "span_at_threshold":
        bk = _span_keys(rng, 100, 2 * 100 + jp.INDEX_SLACK)
        pk = rng.integers(-5, 1230, npr)
    elif name == "span_past_threshold":
        bk = _span_keys(rng, 100, 2 * 100 + jp.INDEX_SLACK + 1)
        pk = rng.integers(-5, 1230, npr)
        dense = False
    elif name == "k_cap_below_total":
        bk = rng.permutation(1000)
        pk = rng.integers(0, 1000, npr)
        k_cap = 1000
    elif name == "no_valid_key":
        bk = rng.permutation(1000)
        pk = rng.integers(-10, 1010, npr)
        bvalid_p = 0.0
        dense = False
    else:
        raise ValueError(name)
    nb = len(bk)
    bk = np.asarray(bk, np.int64)
    bvalid = rng.random(nb) < bvalid_p
    if name == "nulls":
        bk[~bvalid] = rng.integers(0, 200, int((~bvalid).sum()))
    return (bk, bvalid, np.asarray(pk, np.int64), rng.random(npr) < pvalid_p,
            rng.random(npr) < 0.7, k_cap, dense)


INDEX_CASES = ("dense", "dense_gaps", "duplicates", "nulls", "negative_min",
               "int64_min", "int64_max_less_1", "valid_int64_max",
               "span_at_threshold", "span_past_threshold",
               "k_cap_below_total", "no_valid_key")


def _ref_dictionary(ref, bk, bvalid):
    """The reference's build kernel over (bk, bvalid) → (sk, perm,
    prefix) as jax arrays."""
    from tikv_tpu.device.join import DeviceJoiner as RefJoiner
    nb = len(bk)
    return RefJoiner(ref)._build_kernel(nb)(
        jnp.asarray(nb, jnp.int64), jnp.asarray(bk), jnp.asarray(bvalid))


def _ref_keys(sk, prefix) -> tuple:
    """(valid count, least, greatest valid key) of a reference dictionary:
    its valid rows come first; (0, int64.max, int64.min) when none is."""
    sk, nv = np.asarray(sk), int(np.asarray(prefix)[-1])
    if nv == 0:
        return 0, int(I64.max), int(I64.min)
    return nv, int(sk[0]), int(sk[nv - 1])


@pytest.mark.parametrize("name", INDEX_CASES)
def test_indexed_probe_matches_reference_kernel(ref, name):
    """join_index + join_probe (the dense route where the build takes the
    index, else the sparse one) and join_probe without the index equal the
    reference _probe_kernel on the reference's own dictionary: pairs, -1
    past them, the exact total."""
    from tikv_tpu.device.join import DeviceJoiner as RefJoiner
    bk, bvalid, pk, pvalid, mask, k_cap, dense = _case(name)
    nb, npr = len(bk), len(pk)
    rj = RefJoiner(ref)
    sk, perm, prefix = rj._build_kernel(nb)(
        jnp.asarray(nb, jnp.int64), jnp.asarray(bk), jnp.asarray(bvalid))
    fn = rj._probe_kernel(npr, nb, k_cap, [], ((), ()), 0)
    pi, bi, tot = fn(jnp.asarray(npr, jnp.int64), sk, perm, prefix,
                     jnp.asarray(pk), jnp.asarray(pvalid & mask))
    built = srt.join_build(torch.from_numpy(bk), torch.from_numpy(bvalid),
                           nb)
    index = jp.join_index(built.sk, built.prefix, built.keys)
    assert (index is not None) == dense
    if dense:
        assert index.off.dtype == torch.int32
        assert index.off.shape == (index.span + 1,)
    args = (torch.from_numpy(pk), torch.from_numpy(pvalid),
            torch.from_numpy(mask), k_cap)
    for idx in (index, None):
        pairs, total = jp.join_probe(*built[:3], *args, index=idx)
        assert int(total) == int(tot)
        np.testing.assert_array_equal(pairs[:, 0].numpy(), np.asarray(pi))
        np.testing.assert_array_equal(pairs[:, 1].numpy(), np.asarray(bi))
    if name == "k_cap_below_total":
        assert int(tot) > k_cap


@pytest.mark.parametrize("name", INDEX_CASES)
def test_build_keys_match_reference_dictionary(ref, name):
    """The three numbers ``join_build`` hands on (reduced from the rows,
    as its prep kernel does) equal those of the reference's dictionary,
    and so do the ones ``build_keys_plain`` reads from the port's own."""
    bk, bvalid, *_rest = _case(name)
    sk, _perm, prefix = _ref_dictionary(ref, bk, bvalid)
    want = _ref_keys(sk, prefix)
    built = srt.join_build(torch.from_numpy(bk), torch.from_numpy(bvalid),
                           len(bk))
    assert tuple(built.keys) == want
    assert tuple(srt.build_keys_plain(built.sk, built.prefix)) == want
    if name == "no_valid_key":
        assert want[0] == 0


@pytest.mark.parametrize("name", INDEX_CASES)
def test_join_index_fed_build_keys(ref, name):
    """``join_index`` fed the build's numbers takes the route it took
    when it read them back (``join_index_plain``, which derives them),
    and its index equals the reference dictionary's keys searched with
    numpy: off[x] the first sorted row whose key is ≥ lo + x (tolerance
    0)."""
    bk, bvalid, _pk, _pv, _m, _k, dense = _case(name)
    sk, _perm, prefix = _ref_dictionary(ref, bk, bvalid)
    built = srt.join_build(torch.from_numpy(bk), torch.from_numpy(bvalid),
                           len(bk))
    index = jp.join_index(built.sk, built.prefix, built.keys)
    derived = jp.join_index_plain(built.sk, built.prefix)
    assert (index is None) == (derived is None) == (not dense)
    if index is None:
        return
    nv, lo, hi = _ref_keys(sk, prefix)
    assert (index.lo, index.span) == (derived.lo, derived.span) == \
        (lo, hi - lo + 1)
    want = np.searchsorted(np.asarray(sk)[:nv],
                           lo + np.arange(index.span + 1), side="left")
    np.testing.assert_array_equal(index.off.numpy(), want)
    np.testing.assert_array_equal(derived.off.numpy(), want)


@pytest.mark.parametrize("n_valid,lo,hi,span", [
    (0, 0, 0, None),                                # no valid key
    (1, 5, 5, 1),                                   # one key
    (1000, 0, 999, 1000),                           # dense
    (1000, -1000, 999, 2000),                       # a negative least key
    (100, 0, 2 * 100 + 1023, 2 * 100 + 1024),       # at the threshold
    (100, 0, 2 * 100 + 1024, None),                 # one past it
    (10, 0, int(I64.max), None),                    # a valid int64.max key
    (10, int(I64.max) - 10, int(I64.max) - 1, 10),  # just below it
    (10, int(I64.min), int(I64.min) + 9, 10),       # at int64.min
    (2 ** 31, 0, 2 ** 31 - 2, 2 ** 31 - 1),         # the largest span
    (2 ** 31, 0, 2 ** 31 - 1, None),                # a span of 2^31
])
def test_index_route_choice(n_valid, lo, hi, span):
    assert jp.index_span(n_valid, lo, hi) == span


def test_join_index_checks_its_inputs():
    sk, perm, prefix, keys = srt.join_build(
        torch.arange(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool),
        4)
    assert tuple(keys) == (4, 0, 3)
    index = jp.join_index(sk, prefix, keys)
    assert index.lo == 0 and index.span == 4
    assert index.off.tolist() == [0, 1, 2, 3, 4]
    k = torch.zeros(3, dtype=torch.int64)
    bad = jp.JoinIndex(index.off[:-1], index.lo, index.span)
    with pytest.raises(ValueError, match="index"):
        jp.join_probe(sk, perm, prefix, k, None, None, 64, bad)
    with pytest.raises(ValueError, match="prefix"):
        jp.join_index(sk, prefix[:-1], keys)
    with pytest.raises(ValueError, match="valid keys"):
        jp.join_index(sk, prefix, srt.BuildKeys(5, 0, 4))
    empty = srt.join_build(torch.zeros(0, dtype=torch.int64),
                           torch.zeros(0, dtype=torch.bool), 0)
    assert tuple(empty.keys) == (0, int(I64.max), int(I64.min))
    assert jp.join_index(empty.sk, empty.prefix, empty.keys) is None
