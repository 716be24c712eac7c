"""Device (CUDA) execution backend of the coprocessor: aggregation,
selection and top-k over a snapshot held on the card, the cold path that
mints that snapshot's feed from its MVCC versions, the plan IR's join,
sort and window fragments (``join.DeviceJoiner``), and the column
statistics of ANALYZE (``DeviceRunner.handle_analyze``).

The kernels (``build.SOURCES``): ``hash_agg``, ``twolevel`` and
``agg_fold`` (aggregation), ``selection`` (``sel_pred``,
``sel_pred_batched``'s interpreter, ``sel_compact``), ``sel_mask``,
``sel_batched`` (``sel_pred_batched``'s terms route), ``topn``
(``topn_select``), ``digest``
(``plane_digest``, ``feed_verify``, ``patch_feed_rows`` and its one-plane
case ``patch_rows``, ``patch_feed_spans``), ``mvcc``
(``mvcc_resolve``), ``split`` (``split_planes``), ``shard_merge``
(``shard_psum``, ``shard_bucket_merge``, ``shard_merge``, wrapped by
``shard.py``), each
wrapped by the module of its name, and ``sort`` (``sort_perm``,
``join_build``), ``join`` (``join_probe``, wrapped by ``join_probe.py``),
``window`` (``window_scan``) and ``analyze`` (``analyze_column``).

A mesh runner with ``placement=True`` places regions on single-device
slices (``placement.SlicePlacer``) and scores each slice's health
(``supervisor.SliceHealthBoard``).

A request dispatched with ``deferred=True`` comes back as a
``DeferredResult`` (``deferred.py``): its fetch and host finalize run when
``result()`` is called, on any thread.

Lazy exports (PEP 562): importing a sibling such as ``device.hash_agg``
does not build the runner module.  Entry points run on ``cuda:0`` unless
the caller asks for the CPU, and never fall back to it on their own.
"""

import torch

__all__ = ["DEVICE_FAULTS", "DeferredResult", "DeviceRunner",
           "DeviceUnavailable", "FeedQuarantined", "resolve_device"]


class DeviceUnavailable(Exception):
    """The device cannot serve this request or fragment now (an injected
    fault, a capacity that did not settle): the caller may answer it on
    the host.  A kernel that fails to build or launch is not one of these:
    it raises its own error, which no caller degrades."""


class FeedQuarantined(DeviceUnavailable):
    """A scrub found the request's resident feed diverged from its record:
    its feeds are dropped, this request is answered on the host, and the
    next one uploads the feed again from host truth.  ``reason`` names the
    degrade the endpoint counts."""

    reason = "quarantined"


# the faults a caller degrades to the host on (unless it forced the
# device); every other exception propagates
DEVICE_FAULTS = (DeviceUnavailable, torch.cuda.OutOfMemoryError)


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; raises when CUDA is not available.  The CPU
    is used only when asked for by name (the tests' plain-version path)."""
    if device is None:
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the device runner "
                               "needs a GPU (pass device='cpu' for the "
                               "plain PyTorch version)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def __getattr__(name):
    if name == "DeviceRunner":
        from .runner import DeviceRunner
        return DeviceRunner
    if name == "DeferredResult":
        from .deferred import DeferredResult
        return DeferredResult
    raise AttributeError(name)
