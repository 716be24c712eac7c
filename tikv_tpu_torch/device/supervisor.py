"""Device-state supervision: the host half of the feed digests.

Counterpart of the JAX package's ``device/supervisor.py`` (its digest
contract, :68-89), trimmed to ``host_plane_digest``.  A feed plane's
digest over its live prefix is

    digest(plane, n) = Σ_{i<n} bits(plane[i])·(2i+1)  mod 2^64.

Odd weights make every single-position change detectable: a change d at
position i moves the digest by d·(2i+1) mod 2^64, which is zero only when
d is.  The runner records it from the host truth when a feed is built and
re-hashes the resident plane on the device (``digest.plane_digest``) when
it scrubs.  ``start_plane_digests`` hashes a feed's planes on a thread
pool in spans, so that the hash runs while the planes upload.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

# rows per step: the weights and products of one step stay in cache
_STEP = 1 << 20
# rows per job on a hashing pool: a plane of 10^8 rows is 6 jobs
_SPAN = 1 << 24
_MASK = (1 << 64) - 1


def _span_digest(arr: np.ndarray, lo: int, hi: int,
                 dtype: Optional[np.dtype] = None) -> int:
    """Σ_{lo≤i<hi} bits(arr[i], read as ``dtype``)·(2i+1) mod 2^64."""
    a = arr[lo:hi]
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        u = a.view(np.uint8)
    else:
        u = a.view(np.dtype(f"u{a.dtype.itemsize}"))
    m_all = hi - lo
    step = min(m_all, _STEP)
    odd = 2 * np.arange(step, dtype=np.uint64) + np.uint64(1)
    w = np.empty(step, np.uint64)
    total = 0
    with np.errstate(over="ignore"):
        for at in range(0, m_all, _STEP):
            m = min(_STEP, m_all - at)
            np.add(odd[:m], np.uint64(2 * (lo + at)), out=w[:m])
            np.multiply(w[:m], u[at:at + m], out=w[:m])
            total += int(w[:m].sum(dtype=np.uint64))
    return total & _MASK


def host_plane_digest(arr: np.ndarray, n: int,
                      dtype: Optional[np.dtype] = None) -> int:
    """Host reference digest over the live prefix of one feed plane
    (its values cast to ``dtype`` first, when given)."""
    return _span_digest(arr, 0, n, dtype)


def hash_workers() -> int:
    """Threads for a hashing pool: the host's cores, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def start_plane_digests(pool, planes: Sequence[tuple], n: int,
                        span: int = _SPAN) -> Callable[[], tuple]:
    """Queue the digests of ``planes`` — (array, dtype or None) pairs,
    each hashed over its first ``n`` rows — on the executor ``pool`` in
    jobs of ``span`` rows → a function that waits for them and returns
    the digests in order.  numpy releases the GIL inside each job, so the
    caller's uploads run while the pool hashes."""
    jobs = [[pool.submit(_span_digest, arr, lo, min(n, lo + span), dtype)
             for lo in range(0, n, span)] for arr, dtype in planes]

    def wait() -> tuple:
        return tuple(sum(f.result() for f in js) & _MASK for js in jobs)
    return wait
