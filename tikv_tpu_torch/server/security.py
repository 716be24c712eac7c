"""TLS for every gRPC channel (components/security analog).

A copy of the JAX package's ``server/security.py``.  Every channel and
bind of the port (the store client, the PD client, the raft transport,
the mux) is made by ``make_channel`` and ``bind_port``, each with the
message-size options of ``GRPC_OPTIONS``.

Reference: components/security/src/lib.rs — one SecurityManager built
from {ca, cert, key} paths wraps both server binds and client channels;
mTLS when a CA is configured (peers must present certs signed by it).

Process shape: ``set_default(SecurityConfig)`` installs the manager
used by every channel constructor (store client, PD client, raft
transport, mux) — the reference threads its SecurityManager the same
way through server assembly.
"""

from __future__ import annotations

from typing import Optional

import grpc

from ..config import SecurityConfig

# the largest message a channel sends or a server receives.  gRPC's own
# receive limit is 4 MiB; a raft entry carrying a bulk-loaded SST blob
# (one raft op a file, ``Node.ingest_sst_blob``) is tens of MB, and a
# follower's server must take the BatchRaft call that carries it, or the
# transport counts it a failed send and retries it without end.  2 GiB
# - 1 is gRPC's most
MAX_MESSAGE_BYTES = (1 << 31) - 1
GRPC_OPTIONS = (("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES))


class SecurityManager:
    def __init__(self, cfg: SecurityConfig):
        self.cfg = cfg

        def rd(path):
            with open(path, "rb") as f:
                return f.read()
        self._ca = rd(cfg.ca_path) if cfg.ca_path else None
        self._cert = rd(cfg.cert_path) if cfg.cert_path else None
        self._key = rd(cfg.key_path) if cfg.key_path else None

    def server_credentials(self):
        return grpc.ssl_server_credentials(
            [(self._key, self._cert)], root_certificates=self._ca,
            require_client_auth=self._ca is not None)

    def channel_credentials(self):
        return grpc.ssl_channel_credentials(
            root_certificates=self._ca, private_key=self._key,
            certificate_chain=self._cert)

    def channel(self, addr: str):
        # self-signed test certs carry CN=localhost; connecting by
        # 127.0.0.1 needs the target-name override, exactly like
        # tikv's --ssl-target-name-override flag
        return grpc.secure_channel(addr, self.channel_credentials(),
                                   options=GRPC_OPTIONS + (
                                       ("grpc.ssl_target_name_override",
                                        "localhost"),))

    def bind(self, server, addr: str) -> int:
        return server.add_secure_port(addr, self.server_credentials())


_default: Optional[SecurityManager] = None


def set_default(cfg: Optional[SecurityConfig]) -> None:
    """Install the process-wide security manager (None = plaintext)."""
    global _default
    _default = SecurityManager(cfg) if cfg and cfg.enabled else None


def default() -> Optional[SecurityManager]:
    return _default


def make_channel(addr: str):
    """The one channel constructor every client uses: TLS when the
    process security manager is installed, plaintext otherwise."""
    mgr = _default
    if mgr is not None:
        return mgr.channel(addr)
    return grpc.insecure_channel(addr, options=GRPC_OPTIONS)


def make_server(pool):
    """A gRPC server on ``pool`` that takes messages up to
    ``MAX_MESSAGE_BYTES``."""
    return grpc.server(pool, options=GRPC_OPTIONS)


def bind_port(server, addr: str) -> int:
    mgr = _default
    if mgr is not None:
        return mgr.bind(server, addr)
    return server.add_insecure_port(addr)
