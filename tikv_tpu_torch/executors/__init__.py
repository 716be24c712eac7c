"""Scan feed (columnar snapshots, key ranges) and response containers."""
