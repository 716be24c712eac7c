"""PD one level up and one level down: the PD client trait and the
in-memory PD the stores of one cluster run against (``client.py``), and the pure
functions that place region feeds on a node's mesh slices
(``scheduler.py``)."""
