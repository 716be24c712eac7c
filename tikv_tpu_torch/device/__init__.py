"""Device (CUDA) execution backend of the coprocessor: aggregation,
selection and top-k over a snapshot held on the card, the cold path that
mints that snapshot's feed from its MVCC versions, the plan IR's join,
sort and window fragments (``join.DeviceJoiner``), and the column
statistics of ANALYZE (``DeviceRunner.handle_analyze``).

The kernels (``build.SOURCES``): ``hash_agg``, ``twolevel`` and
``agg_fold`` (aggregation), ``selection`` (``sel_pred``,
``sel_pred_batched``, ``sel_mask``, ``sel_compact``), ``topn``
(``topn_select``), ``digest``
(``plane_digest``, ``patch_rows``), ``mvcc`` (``mvcc_resolve``), each
wrapped by the module of its name, and ``sort`` (``sort_perm``,
``join_build``), ``join`` (``join_probe``, wrapped by ``join_probe.py``),
``window`` (``window_scan``) and ``analyze`` (``analyze_column``).

A request dispatched with ``deferred=True`` comes back as a
``DeferredResult`` (``deferred.py``): its fetch and host finalize run when
``result()`` is called, on any thread.

Lazy exports (PEP 562): importing a sibling such as ``device.hash_agg``
does not build the runner module.  Entry points run on ``cuda:0`` unless
the caller asks for the CPU, and never fall back to it on their own.
"""

import torch

__all__ = ["DEVICE_FAULTS", "DeferredResult", "DeviceRunner",
           "DeviceUnavailable", "resolve_device"]


class DeviceUnavailable(Exception):
    """The device cannot serve this request or fragment now (an injected
    fault, a capacity that did not settle): the caller may answer it on
    the host.  A kernel that fails to build or launch is not one of these:
    it raises its own error, which no caller degrades."""


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
