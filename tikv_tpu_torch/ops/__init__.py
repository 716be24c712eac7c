"""Aggregate specs and host finalize."""

from .agg import AggSpec, finalize_hash, finalize_simple

__all__ = ["AggSpec", "finalize_hash", "finalize_simple"]
