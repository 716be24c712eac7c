"""Device (CUDA) execution backend of the coprocessor: aggregation,
selection and top-k over a snapshot held on the card, and the cold path
that mints that snapshot's feed from its MVCC versions.

The kernels (``build.SOURCES``): ``hash_agg``, ``twolevel`` and
``agg_fold`` (aggregation), ``selection`` (``sel_pred``, ``sel_mask``,
``sel_compact``), ``topn`` (``topn_select``), ``digest``
(``plane_digest``, ``patch_rows``) and ``mvcc`` (``mvcc_resolve``), each
wrapped by the module of its name.

Lazy exports (PEP 562): importing a sibling such as ``device.hash_agg``
does not build the runner module.  Entry points run on ``cuda:0`` unless
the caller asks for the CPU, and never fall back to it on their own.
"""

import torch

__all__ = ["DeviceRunner", "resolve_device"]


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
    raise AttributeError(name)
