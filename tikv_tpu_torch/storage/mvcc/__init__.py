"""MVCC reads over one snapshot (``reader``) and their errors
(``errors``)."""
