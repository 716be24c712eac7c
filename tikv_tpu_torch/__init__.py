"""tikv_tpu_torch — the coprocessor of the KV framework in PyTorch and CUDA.

The port of the JAX package ``tikv_tpu`` to one NVIDIA H100, slice by
slice, with the JAX package kept as the reference.  Its endpoint
(``copr/endpoint.py``) serves the coprocessor's DAG requests — aggregation,
selection and top-k over a columnar snapshot held on the card, through
hand-written CUDA kernels (``csrc/``), and every other plan on the host
pipeline (``executors/``) —, plan-IR requests, whose join, sort and
window fragments run on the card (``copr/plan_ir.py``, ``device/join.py``),
ANALYZE requests, whose column sorts run on the card
(``device/analyze.py``), and CHECKSUM requests (``copr/analyze.py``).

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
