"""Device dtype policy for feed columns.

- INT and DURATION → int32 when the column's values fit, else int64;
  aggregation accumulators are always int64.
- REAL → float32 on the device.
- DATETIME, ENUM and SET → uint32 when the values fit, else uint64.

Kept identical to the reference's policy so feed shapes and dtypes agree.
INT arithmetic over an int32 column evaluates in int64 unless its bounds
prove int32 exact (``expr/eval.py``), where the reference's wraps.  A REAL
column that a TopN orders by also gets a float64 plane (the runner), and
ANALYZE uploads REAL as float64.  The DAG runner serves INT and REAL
columns only (its ``_DEVICE_ETS``); ANALYZE also DATETIME and DURATION.
"""

from __future__ import annotations

import numpy as np

from .eval_type import EvalType


def _device_dtype(eval_type: EvalType, values: np.ndarray) -> np.dtype:
    if eval_type in (EvalType.INT, EvalType.DURATION):
        if values.size and (values.min() < -(2**31) or values.max() >= 2**31):
            return np.dtype(np.int64)
        return np.dtype(np.int32)
    if eval_type is EvalType.REAL:
        return np.dtype(np.float32)
    if eval_type in (EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
        return np.dtype(np.uint32) if not values.size or \
            values.max() < 2**32 else np.dtype(np.uint64)
    raise ValueError(f"{eval_type} has no device representation in the port")
