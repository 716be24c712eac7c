"""Process utilities: fault injection (``failpoint``), request deadlines
(``deadline``) and per-request cost attribution (``tracker``)."""
