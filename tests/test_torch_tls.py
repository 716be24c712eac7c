"""mTLS over every gRPC surface of the port (``server/security.py``)
against the JAX package's, as ``tests/test_tls.py`` runs it.

A self-signed CA and one certificate signed by it (CN=localhost) are made
with the ``openssl`` CLI; each package's process-wide security manager is
installed from them, one PD and one store of that package serve a put, a
get and a coprocessor read over TLS (the raft transport, the PD client
and the store client all dial through ``make_channel``), and a plaintext
channel is refused by the TLS server.  Both packages give the same
answers.
"""

from __future__ import annotations

import subprocess

import grpc
import pytest

from tikv_tpu.server import wire as ref_wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch.convert import dag_from_wire


def make_certs(tmp_path):
    """CA + one cert (CN=localhost) signed by it."""
    ca_key, ca_crt = tmp_path / "ca.key", tmp_path / "ca.crt"
    key, csr, crt = tmp_path / "tls.key", tmp_path / "tls.csr", \
        tmp_path / "tls.crt"

    def run(*a):
        subprocess.run(a, check=True, capture_output=True)
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(ca_key), "-out", str(ca_crt), "-days", "1",
        "-subj", "/CN=tikv-test-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(key), "-out", str(csr), "-subj", "/CN=localhost",
        "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1")
    run("openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
        "-CAkey", str(ca_key), "-CAcreateserial", "-days", "1",
        "-copy_extensions", "copyall", "-out", str(crt))
    return str(ca_crt), str(crt), str(key)


@pytest.fixture
def certs(tmp_path):
    try:
        return make_certs(tmp_path)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"openssl unavailable: {e}")


def _tls_cluster(pkg: str, certs) -> tuple:
    if pkg == "ref":
        from tikv_tpu import server
        from tikv_tpu.config import SecurityConfig
        from tikv_tpu.raftstore.metapb import Store
        from tikv_tpu.server import security
        runner = None
    else:
        from tikv_tpu_torch import server
        from tikv_tpu_torch.config import SecurityConfig
        from tikv_tpu_torch.device.runner import DeviceRunner
        from tikv_tpu_torch.raftstore.metapb import Store
        from tikv_tpu_torch.server import security
        runner = DeviceRunner(device="cpu")
    security.set_default(SecurityConfig(*certs))
    pd_server = server.PdServer("127.0.0.1:0")
    pd_server.start()
    pd_addr = f"127.0.0.1:{pd_server.port}"
    node = server.Node("127.0.0.1:0", server.RemotePdClient(pd_addr),
                       device_runner=runner)
    srv = server.TikvServer(node)
    node.addr = f"127.0.0.1:{srv.port}"
    node.pd.put_store(Store(node.store_id, node.addr))
    srv.start()
    c = server.TxnClient(pd_addr)
    try:
        c.put(b"tls-k", b"tls-v")
        got = c.get(b"tls-k")
        table = int_table(1, table_id=951)
        c.put(*encode_table_row(table, 1, {"c0": 7}))
        dag = DagSelect.from_table(table, ["id", "c0"]).build(
            start_ts=c.tso())
        if pkg == "port":
            dag = dag_from_wire(ref_wire.enc_dag(dag))
        rows = c.coprocessor(dag)["rows"]
        # a PLAINTEXT channel is refused by the TLS server
        chan = grpc.insecure_channel(node.addr)
        fn = chan.unary_unary("/tikv.Tikv/Status",
                              request_serializer=server.wire.pack,
                              response_deserializer=server.wire.unpack)
        try:
            fn({}, timeout=3)
            refused = False
        except grpc.RpcError:
            refused = True
        chan.close()
        return got, rows, refused
    finally:
        close = getattr(c, "close", None)
        if callable(close):
            close()
        srv.stop()
        pd_server.stop()
        security.set_default(None)


def test_tls_cluster_end_to_end_and_plaintext_rejected(certs):
    ref = _tls_cluster("ref", certs)
    port = _tls_cluster("port", certs)
    assert port == ref == (b"tls-v", [[1, 7]], True)


def test_security_manager_is_the_default_channel_maker(certs):
    """With the manager installed every channel of the port is a TLS
    channel with the message-size options; without it, plaintext."""
    from tikv_tpu_torch.config import SecurityConfig
    from tikv_tpu_torch.server import security
    assert security.default() is None
    security.set_default(SecurityConfig(*certs))
    try:
        mgr = security.default()
        assert mgr is not None and mgr.cfg.ca_path == certs[0]
        chan = security.make_channel("127.0.0.1:1")
        assert isinstance(chan, grpc.Channel)
        chan.close()
    finally:
        security.set_default(None)
    assert security.default() is None
    assert SecurityConfig().enabled is False
    assert dict(security.GRPC_OPTIONS)[
        "grpc.max_receive_message_length"] == security.MAX_MESSAGE_BYTES
