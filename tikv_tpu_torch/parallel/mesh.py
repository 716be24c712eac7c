"""The device mesh: an R×T grid of ``torch.device`` over the axes
("range", "tile").

Counterpart of the JAX package's ``parallel/mesh.py``.  TiKV's
parallelism axes (SURVEY.md §2.8) map onto the grid: ``range`` pins a
region (a contiguous key range) the way TiKV pins a region to a store,
``tile`` splits a region into buckets.  A feed that is row-sharded over the
mesh cuts every plane into ``num_shards`` contiguous slices, slice ``s`` on
``mesh.devices.flat[s]`` (``device/runner.py``); the per-shard partial
states merge across the flattened ("range", "tile") product.

A mesh is a list of devices, and one device may appear in it more than
once (``make_mesh(["cuda:0"] * 4)``): one card then holds several shards,
each with its own slice and launches, and only the copies between cards
are missing.  The default shape comes from ``_factor2`` (as square as
possible; a prime count degenerates to ``(1, n)``).  ``healthy_submesh``
gives the largest power-of-two survivor set (8 → 4 → 2 → 1) of a mesh with
dead slices, as the reference's failure-domain ladder uses it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

RANGE_AXIS = "range"
TILE_AXIS = "tile"
ROW_AXES = (RANGE_AXIS, TILE_AXIS)


class Mesh:
    """``devices``: an (R, T) numpy object array of ``torch.device``;
    ``shape``: {"range": R, "tile": T} (the JAX mesh's ``shape``)."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices: np.ndarray,
                 axis_names: tuple = ROW_AXES):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b), a*b == n, as square as possible, a <= b: ``a``
    is the largest divisor of ``n`` not above ``isqrt(n)``, so a prime
    ``n`` gives ``(1, n)``."""
    a = int(math.isqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def parse_mesh_shape(shape: Union[str, Sequence[int], None]
                     ) -> Optional[tuple[int, int]]:
    """An explicit mesh shape: ``"RxT"`` / ``"R,T"`` / ``"R*T"`` strings or
    a 2-sequence of ints; ``None`` or an empty string means none
    (``_factor2`` decides).  Raises ``ValueError`` on malformed input."""
    if shape is None:
        return None
    if isinstance(shape, str):
        s = shape.strip().lower()
        if not s:
            return None
        for sep in ("x", ",", "*"):
            if sep in s:
                parts = s.split(sep)
                break
        else:
            raise ValueError(f"mesh_shape {shape!r}: expected 'RxT'")
        if len(parts) != 2:
            raise ValueError(f"mesh_shape {shape!r}: expected 2 factors")
        try:
            r, t = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(f"mesh_shape {shape!r}: non-integer factor")
    else:
        if len(shape) != 2:
            raise ValueError(f"mesh_shape {shape!r}: expected 2 factors")
        r, t = int(shape[0]), int(shape[1])
    if r < 1 or t < 1:
        raise ValueError(f"mesh_shape {shape!r}: factors must be >= 1")
    return r, t


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: name the mesh's devices "
                           "(make_mesh(['cpu'] * n) for the plain PyTorch "
                           "version)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple[int, int]] = None) -> Mesh:
    """The ("range", "tile") mesh over ``devices`` (names or
    ``torch.device``; default every visible CUDA device).  ``shape`` must
    multiply out to the device count exactly."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _visible_devices()
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = _factor2(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


def mesh_slices(mesh: Mesh) -> list:
    """Per-device slices in flattened ("range", "tile") order: slice ``i``
    is shard ``i`` of the mesh's row sharding."""
    return [[d] for d in mesh.devices.flat]


def healthy_submesh(mesh: Mesh, dead_slices) -> Optional[list]:
    """Devices of the largest healthy power-of-two submesh (survivors in
    flat order), or None when every slice is dead."""
    dead = set(dead_slices)
    devs = [d for i, d in enumerate(mesh.devices.flat) if i not in dead]
    if not devs:
        return None
    k = 1 << (len(devs).bit_length() - 1)
    return devs[:k]


def num_shards(mesh: Mesh) -> int:
    return mesh.devices.size


def pad_rows_for(mesh: Mesh, n_rows: int, multiple: int = 8) -> int:
    """Smallest row count >= n_rows divisible by n_shards * multiple."""
    unit = num_shards(mesh) * multiple
    return max(unit, ((n_rows + unit - 1) // unit) * unit)
