"""PD's placement policy one level down: the pure functions that place
region feeds on a node's mesh slices (``scheduler.py``)."""
