"""Process utilities: fault injection (``failpoint``)."""
