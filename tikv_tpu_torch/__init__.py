"""tikv_tpu_torch — the coprocessor of the KV framework in PyTorch and CUDA.

The port of the JAX package ``tikv_tpu`` to one NVIDIA H100, slice by
slice, with the JAX package kept as the reference.  It serves the
coprocessor's device plans — aggregation, selection and top-k over a table
or single-column index scan — over a columnar snapshot held on the card,
through hand-written CUDA kernels (``csrc/``).

The package imports torch and numpy only; it keeps its own copies of the
host helpers it needs.  Exports are lazy (PEP 562).
"""

__version__ = "0.1.0"

__all__ = ["DeviceRunner", "resolve_device"]


def __getattr__(name):
    if name in __all__:
        from . import device
        return getattr(device, name)
    raise AttributeError(name)
