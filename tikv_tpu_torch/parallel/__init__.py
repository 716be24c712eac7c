"""Mesh layer — TiKV's range + bucket sharding as a grid of devices."""

from .mesh import (
    RANGE_AXIS,
    ROW_AXES,
    TILE_AXIS,
    Mesh,
    healthy_submesh,
    make_mesh,
    mesh_slices,
    num_shards,
    pad_rows_for,
    parse_mesh_shape,
)

__all__ = [
    "Mesh",
    "RANGE_AXIS",
    "ROW_AXES",
    "TILE_AXIS",
    "healthy_submesh",
    "make_mesh",
    "mesh_slices",
    "num_shards",
    "pad_rows_for",
    "parse_mesh_shape",
]
