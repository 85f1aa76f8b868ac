"""The port's native TCP transport (``minbft_tpu_torch.sample.conn.tcp``)
held to the reference's ``tests/test_tcp_conn.py`` cases: frame round
trips, chat-kind routing, the frame-length cap, the late-binding dial
retry, server stop with live connections and its grace window.  Each case
runs port against port, and the wire cases also across the packages (a
port server with a reference connector, a reference server with a port
connector): the two speak the same bytes."""

import asyncio
import struct

import pytest

from minbft_tpu.sample.conn import tcp as ref_tcp
from minbft_tpu_torch import api
from minbft_tpu_torch.sample.conn import tcp as port_tcp
from minbft_tpu_torch.utils.netports import free_base_port

PACKAGES = {"port": port_tcp, "ref": ref_tcp}
# (connector's package, server's package)
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]


class _EchoHandler(api.MessageStreamHandler):
    def __init__(self, tag: bytes):
        self._tag = tag

    async def handle_message_stream(self, in_stream):
        async for data in in_stream:
            yield self._tag + data


class _EchoConn(api.ConnectionHandler):
    def peer_message_stream_handler(self):
        return _EchoHandler(b"P:")

    def client_message_stream_handler(self):
        return _EchoHandler(b"C:")


async def _drive(handler, frames, n_expect):
    async def outgoing():
        for fr in frames:
            yield fr
        await asyncio.sleep(30)  # keep the stream open

    out = handler.handle_message_stream(outgoing())
    got = []
    try:
        while len(got) < n_expect:
            got.append(await asyncio.wait_for(out.__anext__(), 10))
    finally:
        await out.aclose()
    return got


async def _forever(first: bytes):
    yield first
    await asyncio.sleep(30)


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_round_trip_and_kind_routing(pair):
    conn_pkg, server_pkg = (PACKAGES[p] for p in pair)

    async def scenario():
        server = server_pkg.TcpReplicaServer(_EchoConn())
        addr = await server.start("127.0.0.1:0")
        try:
            for kind, tag in (("peer", b"P:"), ("client", b"C:")):
                conn = conn_pkg.TcpReplicaConnector(kind)
                conn.connect_replica(0, addr)
                h = conn.replica_message_stream_handler(0)
                frames = [b"alpha", b"x" * 70_000, b""]
                got = await _drive(h, frames, len(frames))
                assert got == [tag + f for f in frames]
        finally:
            await server.stop()

    asyncio.run(scenario())


def test_wire_constants_match_the_reference():
    assert (port_tcp.PEER_KIND, port_tcp.CLIENT_KIND, port_tcp.MAX_FRAME) == (
        ref_tcp.PEER_KIND, ref_tcp.CLIENT_KIND, ref_tcp.MAX_FRAME)


def test_oversized_frame_closes_connection_only():
    """A length prefix past MAX_FRAME is a hostile/corrupt stream: that
    connection dies; the server keeps serving others."""

    async def scenario():
        server = port_tcp.TcpReplicaServer(_EchoConn())
        addr = await server.start("127.0.0.1:0")
        host, port = addr.rsplit(":", 1)
        try:
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(port_tcp.CLIENT_KIND + struct.pack(">I", port_tcp.MAX_FRAME + 1))
            await writer.drain()
            assert await asyncio.wait_for(reader.read(), 10) == b""
            writer.close()
            conn = port_tcp.TcpReplicaConnector("client")
            conn.connect_replica(0, addr)
            got = await _drive(conn.replica_message_stream_handler(0), [b"ok"], 1)
            assert got == [b"C:ok"]
        finally:
            await server.stop()

    asyncio.run(scenario())


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_dial_retries_until_server_binds(pair):
    """wait_for_ready semantics: the dialer retries while the server is
    still coming up (clusters start in any order)."""
    conn_pkg, server_pkg = (PACKAGES[p] for p in pair)

    async def scenario():
        port = free_base_port(1)
        conn = conn_pkg.TcpReplicaConnector("peer", dial_timeout=30.0)
        conn.connect_replica(0, f"127.0.0.1:{port}")
        h = conn.replica_message_stream_handler(0)

        async def late_server():
            await asyncio.sleep(0.5)
            server = server_pkg.TcpReplicaServer(_EchoConn())
            await server.start(f"127.0.0.1:{port}")
            return server

        server_task = asyncio.ensure_future(late_server())
        got = await _drive(h, [b"late"], 1)
        assert got == [b"P:late"]
        await (await server_task).stop()

    asyncio.run(scenario())


def test_server_stop_with_live_connections_returns():
    """stop() cancels live connection handlers (3.12's wait_closed waits
    for them) and the dropped connection ends the dialer's stream."""

    async def scenario():
        server = port_tcp.TcpReplicaServer(_EchoConn())
        addr = await server.start("127.0.0.1:0")
        conn = port_tcp.TcpReplicaConnector("peer")
        conn.connect_replica(0, addr)
        h = conn.replica_message_stream_handler(0)
        assert await _drive(h, [b"live"], 1) == [b"P:live"]
        open_stream = h.handle_message_stream(_forever(b"first"))
        assert await asyncio.wait_for(open_stream.__anext__(), 10) == b"P:first"
        await asyncio.wait_for(server.stop(), 10)  # must not hang
        with pytest.raises(StopAsyncIteration):
            await asyncio.wait_for(open_stream.__anext__(), 10)

    asyncio.run(scenario())


def test_server_stop_honors_grace_window():
    """stop(grace) gives live handlers the grace window before it
    cancels them, and with no live connection it does not wait."""

    async def scenario():
        server = port_tcp.TcpReplicaServer(_EchoConn())
        addr = await server.start("127.0.0.1:0")
        conn = port_tcp.TcpReplicaConnector("peer")
        conn.connect_replica(0, addr)
        open_stream = conn.replica_message_stream_handler(0).handle_message_stream(
            _forever(b"one"))
        assert await asyncio.wait_for(open_stream.__anext__(), 10) == b"P:one"
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.wait_for(server.stop(grace=0.3), 10)
        assert 0.25 <= loop.time() - t0 < 5.0
        with pytest.raises(StopAsyncIteration):
            await asyncio.wait_for(open_stream.__anext__(), 10)
        server2 = port_tcp.TcpReplicaServer(_EchoConn())
        await server2.start("127.0.0.1:0")
        t0 = loop.time()
        await asyncio.wait_for(server2.stop(grace=5.0), 10)
        assert loop.time() - t0 < 1.0

    asyncio.run(scenario())


def test_idle_timeout_ends_a_silent_stream():
    """``idle_timeout``: a stream that delivers no frame for that long
    ends, so the redial loop above can recover a half-open link."""

    class _Silent(api.MessageStreamHandler):
        async def handle_message_stream(self, in_stream):
            async for _ in in_stream:
                if False:
                    yield b""

    class _SilentConn(_EchoConn):
        def peer_message_stream_handler(self):
            return _Silent()

    async def scenario():
        server = port_tcp.TcpReplicaServer(_SilentConn())
        addr = await server.start("127.0.0.1:0")
        try:
            conn = port_tcp.connect_many_replicas_tcp({0: addr}, idle_timeout=0.3)
            stream = conn.replica_message_stream_handler(0).handle_message_stream(
                _forever(b"x"))
            with pytest.raises(StopAsyncIteration):
                await asyncio.wait_for(stream.__anext__(), 10)
        finally:
            await server.stop()

    asyncio.run(scenario())
