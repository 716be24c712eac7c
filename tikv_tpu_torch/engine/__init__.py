"""The storage engine seam: column-family names, the snapshot protocol and
the in-memory engine (``traits``, ``memory``)."""
