"""The port's gRPC transport (``minbft_tpu_torch.sample.conn.grpc``) held
to the reference's ``tests/test_grpc_conn.py`` cases: loopback echo
streams of both chat kinds, port against port and across the packages (a
port server with a reference connector and the other way round), then an
n = 3 cluster committing requests over real gRPC sockets, once all port
and once mixed (two port replicas, one reference replica, a reference
client), with equal ledgers."""

import asyncio

import pytest

from minbft_tpu.client import new_client as ref_new_client
from minbft_tpu.core import new_replica as ref_new_replica
from minbft_tpu.sample.config import SimpleConfiger as RefConfiger
from minbft_tpu.sample.conn import grpc as ref_grpc
from minbft_tpu.sample.requestconsumer import SimpleLedger as RefLedger
from minbft_tpu_torch import api
from minbft_tpu_torch.client import new_client
from minbft_tpu_torch.core import new_replica
from minbft_tpu_torch.sample.authentication import authenticators_from_keys
from minbft_tpu_torch.sample.authentication.authenticator import make_test_keys
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.sample.conn import grpc as port_grpc
from minbft_tpu_torch.sample.requestconsumer import SimpleLedger
from test_torch_slice import _reference_authenticators, _SeededRng

PACKAGES = {"port": port_grpc, "ref": ref_grpc}


class _EchoHandler(api.MessageStreamHandler):
    def __init__(self, tag: bytes):
        self._tag = tag

    async def handle_message_stream(self, in_stream):
        async for data in in_stream:
            yield self._tag + data


class _EchoConnHandler(api.ConnectionHandler):
    def peer_message_stream_handler(self):
        return _EchoHandler(b"peer:")

    def client_message_stream_handler(self):
        return _EchoHandler(b"client:")


@pytest.mark.parametrize("pair", [("port", "port"), ("ref", "port"), ("port", "ref")],
                         ids="-".join)
def test_loopback_streams(pair):
    """Both chat kinds round-trip messages over a real socket; ``pair`` is
    (the connector's package, the server's package)."""
    conn_pkg, server_pkg = (PACKAGES[p] for p in pair)

    async def run():
        server = server_pkg.ReplicaServer(_EchoConnHandler())
        addr = await server.start("127.0.0.1:0")
        try:
            for kind, tag in (("peer", b"peer:"), ("client", b"client:")):
                conn = conn_pkg.GrpcReplicaConnector(kind)
                conn.connect_replica(0, addr)
                handler = conn.replica_message_stream_handler(0)
                assert handler is not None
                assert conn.replica_message_stream_handler(9) is None

                async def outgoing():
                    for i in range(5):
                        yield b"msg-%d" % i

                got = []
                async for resp in handler.handle_message_stream(outgoing()):
                    got.append(resp)
                    if len(got) == 5:
                        break
                assert got == [tag + b"msg-%d" % i for i in range(5)]
                await conn.close()
        finally:
            await server.stop()

    asyncio.run(run())


def test_service_names_match_the_reference():
    from minbft_tpu.sample.conn.grpc import channel as ref_channel
    from minbft_tpu_torch.sample.conn.grpc import channel

    assert (channel.SERVICE, channel.CLIENT_CHAT, channel.PEER_CHAT) == (
        ref_channel.SERVICE, ref_channel.CLIENT_CHAT, ref_channel.PEER_CHAT)


@pytest.mark.parametrize("ref_ids", [(), (2,)], ids=["port", "mixed"])
def test_cluster_over_sockets(ref_ids):
    """n = 3, f = 1 over real gRPC sockets: three requests commit, every
    ledger holds them with one state digest.  ``ref_ids`` are the
    replicas taken from the reference (then the client is the
    reference's too)."""
    keys = make_test_keys(3, 1, "hmac", rng=_SeededRng(81))
    port_r, port_c = authenticators_from_keys(keys)
    ref_r, ref_c = _reference_authenticators(keys)[:2]

    async def run():
        n, f = 3, 1
        ledgers, replicas, servers, peer_conns, addrs = [], [], [], [], {}
        for i in range(n):
            ref = i in ref_ids
            pkg = ref_grpc if ref else port_grpc
            cfg = (RefConfiger if ref else SimpleConfiger)(
                n=n, f=f, timeout_request=60.0, timeout_prepare=30.0)
            ledger = (RefLedger if ref else SimpleLedger)()
            conn = pkg.GrpcReplicaConnector("peer")
            r = (ref_new_replica if ref else new_replica)(
                i, cfg, (ref_r if ref else port_r)[i], conn, ledger)
            server = pkg.ReplicaServer(r)
            addrs[i] = await server.start("127.0.0.1:0")
            ledgers.append(ledger)
            replicas.append(r)
            servers.append(server)
            peer_conns.append(conn)
        for i, conn in enumerate(peer_conns):
            for j, addr in addrs.items():
                if j != i:
                    conn.connect_replica(j, addr)
        for r in replicas:
            await r.start()
        if ref_ids:
            client_conn = ref_grpc.connect_many_replicas(addrs, kind="client")
            client = ref_new_client(0, n, f, ref_c[0], client_conn, seq_start=0)
        else:
            client_conn = port_grpc.connect_many_replicas(addrs, kind="client")
            client = new_client(0, n, f, port_c[0], client_conn, seq_start=0)
        await client.start()
        results = [await asyncio.wait_for(client.request(b"sock-%d" % k), 30)
                   for k in range(3)]
        for _ in range(200):
            if all(lg.length >= 3 for lg in ledgers):
                break
            await asyncio.sleep(0.05)
        await client.stop()
        await client_conn.close()
        for r in replicas:
            await r.stop()
        for conn in peer_conns:
            await conn.close()
        for s in servers:
            await s.stop()
        return results, ledgers

    results, ledgers = asyncio.run(run())
    assert all(lg.length == 3 for lg in ledgers)
    assert {lg.state_digest() for lg in ledgers} == {results[-1]}
