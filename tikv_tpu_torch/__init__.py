"""tikv_tpu_torch — the coprocessor of the KV framework in PyTorch and CUDA.

The port of the JAX package ``tikv_tpu`` to one NVIDIA H100, slice by
slice, with the JAX package kept as the reference.  This slice serves the
aggregation path (COUNT/SUM/AVG with and without one integer GROUP BY key)
over a columnar snapshot held on the card, through the hand-written CUDA
kernel ``csrc/hash_agg.cu``.

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
