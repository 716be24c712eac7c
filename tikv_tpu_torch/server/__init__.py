"""Networked server layer: gRPC services, node lifecycle, clients, CLI.

The node that runs one store with the raft transport between stores
(``node``), its RPC handlers (``service``) and their wire codec
(``wire``), the gRPC binding (``server``), PD as a service and its client
(``pd_server``), the store and transactional clients (``client``), TLS
(``security``), the HTTP status server (``status_server``), the CLI
(``cli``: ``python -m tikv_tpu_torch.server pd|tikv|ctl``), the read pool
with the completion pool and the busy signal (``read_pool``), and
cross-request device batching (``coalescer``: the cost router and the
request coalescer).

Reference: src/server (gRPC service assembly), components/server
(run_tikv lifecycle), cmd/tikv-server + cmd/tikv-ctl.
"""

__all__ = ["StoreClient", "TxnClient", "Node", "PdServer",
           "RemotePdClient", "TikvServer", "RemoteError"]

# each export → its module, imported at first use: the CLI's ``ctl`` and a
# client process load the client's modules alone, not the node's device
# stack (seconds of imports a process)
_EXPORTS = {"StoreClient": "client", "TxnClient": "client", "Node": "node",
            "PdServer": "pd_server", "RemotePdClient": "pd_server",
            "TikvServer": "server", "RemoteError": "wire"}


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(name)
