"""The serving layer, in process: the node that runs one store
(``node``), its RPC handlers (``service``) and their wire codec
(``wire``), the read pool with the completion pool and the busy signal
(``read_pool``), and cross-request device batching (``coalescer``: the
cost router and the request coalescer).  The gRPC binding is not
here."""
