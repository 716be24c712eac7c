"""Process utilities: fault injection (``failpoint``), request deadlines
(``deadline``) and per-request cost attribution (``tracker``);
``spare_cores``."""


def spare_cores() -> int:
    """The CPUs this process may run on (affinity-aware): the overlap
    machinery (the cold stream's parse worker, the build-time parse's GIL
    release) pays only with a core to spare."""
    import os
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1
