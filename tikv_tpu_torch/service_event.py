"""Service lifecycle event channel.

A copy of the JAX package's ``service_event.py``.  The CLI's ``tikv``
posts EXIT here from its SIGTERM/SIGINT handler, so a signal stops the
server gracefully (in-flight RPCs finish, the node and its pools join).

Reference: components/service/src/service_event.rs — an embedding
process (or the status server) posts PAUSE_GRPC / CONTINUE_GRPC / EXIT
onto a channel; the server loop reacts without the poster knowing the
server's internals.
"""

from __future__ import annotations

import enum
import queue
import threading


class ServiceEvent(enum.Enum):
    PAUSE_GRPC = "pause"
    CONTINUE_GRPC = "continue"
    EXIT = "exit"


class ServiceEventChannel:
    def __init__(self):
        self._q: "queue.Queue[ServiceEvent]" = queue.Queue()

    def post(self, event: ServiceEvent) -> None:
        self._q.put(event)

    def get(self, timeout=None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


def attach(channel: ServiceEventChannel, server) -> threading.Thread:
    """Drive a TikvServer from the channel: pause rejects new RPCs with
    server_is_busy, continue resumes, exit stops the server.  Returns
    the (daemon) dispatcher thread."""

    def run():
        while True:
            ev = channel.get(timeout=0.2)
            if ev is None:
                if getattr(server, "_stopped", False):
                    return
                continue
            if ev is ServiceEvent.PAUSE_GRPC:
                server.service.paused = True
            elif ev is ServiceEvent.CONTINUE_GRPC:
                server.service.paused = False
            elif ev is ServiceEvent.EXIT:
                server.stop()
                return

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
