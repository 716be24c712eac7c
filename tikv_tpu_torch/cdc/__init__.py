"""Resolved-ts tracking: the per-region watermark stale reads are gated on.

The port's copy of the JAX package's ``cdc`` package, trimmed to its
resolved-ts half (``resolved_ts.py``: ``Resolver``, ``ResolvedTsObserver``).
The change-data-capture stream itself (``delegate.py``) is not here
(ROADMAP.md queue 1 item 11).
"""

from .resolved_ts import ResolvedTsObserver, Resolver

__all__ = ["Resolver", "ResolvedTsObserver"]
