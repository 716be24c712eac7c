"""The serving layer above the coprocessor endpoint: the completion pool
and the busy signal (``read_pool``), and cross-request device batching
(``coalescer``: the cost router and the request coalescer)."""
