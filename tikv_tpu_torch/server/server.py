"""gRPC server assembly.

A copy of the JAX package's ``server/server.py``: ``_GenericHandler``
routes ``/tikv.Tikv/<Method>`` (msgpack bodies, ``wire.py``) to the
service — unary by default, ``Coprocessor`` from its raw bytes
(``KvService.handle_raw``), the server-streamed ``CoprocessorStream``
and the ``BatchCommands`` mux; the ``Cdc`` and ``Backup`` streams
answer with the refusal naming what they wait for.  ``TikvServer``
binds one node, with the status server beside it when an address is
given, and ``stop`` joins its handler pool.

Reference: src/server/server.rs (grpcio Server build_and_bind :288) and
components/server/src/server.rs service registration (:1122-1296).
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from . import wire
from .node import Node
from .service import KvService


class _GenericHandler(grpc.GenericRpcHandler):
    """Routes /tikv.Tikv/* to the service: unary by default, plus the
    two streaming surfaces of the reference — coprocessor_stream
    (service/kv.rs:632, server-streamed result pages) and
    batch_commands (service/kv.rs:921, the bidirectional mux)."""

    def __init__(self, prefix: str, dispatch, stream_dispatch=None,
                 batch_dispatch=None, raw_dispatch=None):
        self._prefix = prefix
        self._dispatch = dispatch
        self._stream_dispatch = stream_dispatch
        self._batch_dispatch = batch_dispatch
        # methods served from RAW wire bytes (no eager unpack); responses
        # may come back pre-packed (wire.pack_response passes bytes)
        self._raw_dispatch = raw_dispatch or {}

    def service(self, handler_call_details):
        name = handler_call_details.method
        if not name.startswith(self._prefix):
            return None
        method = name[len(self._prefix):]

        if self._stream_dispatch is not None and \
                method in self._stream_dispatch:
            fn = self._stream_dispatch[method]

            def stream(req: dict, ctx, fn=fn):
                yield from fn(req, ctx)
            return grpc.unary_stream_rpc_method_handler(
                stream, request_deserializer=wire.unpack,
                response_serializer=wire.pack)

        if method == "BatchCommands" and self._batch_dispatch is not None:
            def batch(request_iterator, ctx):
                yield from self._batch_dispatch(request_iterator)
            return grpc.stream_stream_rpc_method_handler(
                batch, request_deserializer=wire.unpack,
                response_serializer=wire.pack)

        if method in self._raw_dispatch:
            fn = self._raw_dispatch[method]

            def raw_unary(raw: bytes, ctx, fn=fn):
                return fn(method, raw)
            return grpc.unary_unary_rpc_method_handler(
                raw_unary, request_deserializer=lambda b: b,
                response_serializer=wire.pack_response)

        def unary(req: dict, ctx) -> dict:
            return self._dispatch(method, req)

        return grpc.unary_unary_rpc_method_handler(
            unary, request_deserializer=wire.unpack,
            response_serializer=wire.pack)


class TikvServer:
    """One listening tikv-server process."""

    def __init__(self, node: Node, max_workers: int = 8,
                 status_addr: Optional[str] = None):
        self.node = node
        self._stopped = False
        self.service = KvService(node)
        # keep the handler pool so stop() can JOIN its workers — grpc's
        # stop() alone leaves them parked on the work queue until the
        # executor is garbage collected, which leaks a thread per
        # in-process server cycle
        self._pool = futures.ThreadPoolExecutor(max_workers=max_workers)
        from .security import bind_port, make_server
        self._server = make_server(self._pool)
        self._server.add_generic_rpc_handlers((
            _GenericHandler(
                "/tikv.Tikv/", self.service.handle,
                stream_dispatch={
                    "CoprocessorStream": self.service.copr_stream_rpc,
                    "Cdc": self.service.refused_stream("Cdc"),
                    "Backup": self.service.refused_stream("Backup"),
                },
                batch_dispatch=self.service.batch_commands,
                raw_dispatch={
                    "Coprocessor": self.service.handle_raw,
                }),))
        self.port = bind_port(self._server, node.addr)
        assert self.port, f"cannot bind {node.addr}"
        # HTTP status server (/status, /health, /config, /region,
        # /fail_point — status_server/mod.rs), bound from config or the
        # explicit arg
        self.status_server = None
        saddr = status_addr or node.config.server.status_addr
        if saddr:
            from .status_server import StatusServer
            self.status_server = StatusServer(
                saddr, node=node,
                config_controller=node.config_controller)

    def start(self) -> None:
        self._stopped = False
        self.node.start()
        self._server.start()
        if self.status_server is not None:
            self.status_server.start()

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self._stopped = True    # service_event dispatcher exits on this
        if self.status_server is not None:
            self.status_server.stop()
        # wait out the grace so in-flight handlers finish before the
        # node (and its pools) tear down under them, then join the
        # handler workers — stop-under-load must leave no threads
        self._server.stop(grace).wait()
        self.node.stop()
        self._pool.shutdown(wait=True)

    def wait(self) -> None:
        self._server.wait_for_termination()
