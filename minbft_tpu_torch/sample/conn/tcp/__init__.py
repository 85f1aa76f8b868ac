"""Native TCP transport: length-prefixed frames over asyncio streams.

Port of :mod:`minbft_tpu.sample.conn.tcp`: the same wire bytes, so port
and reference replicas and clients dial each other.

A drop-in alternative to the gRPC connector/server pair (same
``api.ReplicaConnector`` / ``api.MessageStreamHandler`` contract — the
reference's connector abstraction, sample/conn/grpc/connector/connector.go:27-53,
exists exactly so transports can swap).  Purpose: the protocol's
throughput on small hosts is bounded by per-frame transport cost, and
gRPC's HTTP/2 machinery charges a large constant per message; this
transport is a u32-length-prefixed byte stream over raw asyncio TCP —
the cheapest per-frame path Python offers — and composes with the
codec-level frame coalescing (``messages.codec.drain_multi``) the same
way gRPC does.

Wire format, per connection:
  1 byte   chat kind (0x01 peer, 0x02 client)
  then     frames both directions: u32 BE length || payload

Trust model is unchanged from the gRPC transport: transports carry
opaque frames; every protocol message authenticates itself (signatures /
USIG certificates), and the HELLO handshake is verified above this layer.
"""

from __future__ import annotations

import asyncio
import struct
from typing import AsyncIterator, Dict, Optional

from .... import api

PEER_KIND = b"\x01"
CLIENT_KIND = b"\x02"

_LEN = struct.Struct(">I")
# Generous per-frame cap: coalesced frames are bounded at 256 KiB by the
# pumps; anything near 64 MiB is a corrupt or hostile length prefix.
MAX_FRAME = 64 * 1024 * 1024


async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ConnectionError(f"tcp frame length {n} exceeds cap")
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None


def _write_frame(writer: asyncio.StreamWriter, data: bytes) -> None:
    writer.write(_LEN.pack(len(data)) + data)


async def _close_writer(writer: asyncio.StreamWriter) -> None:
    """Best-effort orderly close: close() only schedules the transport
    teardown — wait_closed() lets the kernel flush/FIN before we drop the
    last reference (bounded: shutdown must never hang on a dead peer)."""
    try:
        writer.close()
        await asyncio.wait_for(writer.wait_closed(), 1.0)
    except (Exception, asyncio.CancelledError):
        pass


class _TcpStreamHandler(api.MessageStreamHandler):
    """Dial side of one chat stream (one TCP connection per stream —
    mirrors gRPC's one-RPC-per-handle_message_stream shape)."""

    def __init__(
        self,
        host: str,
        port: int,
        kind: bytes,
        dial_timeout: float,
        idle_timeout: float = 0.0,
    ):
        self._host = host
        self._port = port
        self._kind = kind
        self._dial_timeout = dial_timeout
        self._idle_timeout = idle_timeout

    async def _connect(self):
        # wait_for_ready semantics (reference grpc.WaitForReady(true)):
        # a cluster starts in any order, so dial retries until the peer
        # binds or the budget runs out.
        deadline = asyncio.get_running_loop().time() + self._dial_timeout
        delay = 0.05
        while True:
            try:
                return await asyncio.open_connection(self._host, self._port)
            except OSError:
                if asyncio.get_running_loop().time() >= deadline:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        reader, writer = await self._connect()
        writer.write(self._kind)

        async def pump_out() -> None:
            try:
                async for data in in_stream:
                    _write_frame(writer, data)
                    await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass

        pump = asyncio.get_running_loop().create_task(pump_out())
        try:
            while True:
                if self._idle_timeout > 0:
                    # Read-idle detection for HALF-OPEN peers: a stalled
                    # link (peer process wedged, or a middlebox silently
                    # dropping the flow) keeps the TCP connection "up"
                    # while frames stop — without a deadline this read
                    # parks forever and the ReconnectBackoff redial loop
                    # above never gets its turn.  Ending the stream here
                    # IS the recovery: the caller tears down and redials,
                    # and the peer's HELLO replay restores the log.  The
                    # broadcast-log stream is never legitimately idle for
                    # long (checkpoints and retransmissions keep flowing),
                    # so operators size this in seconds, well above any
                    # healthy gap; 0 (default) disables.
                    try:
                        frame = await asyncio.wait_for(
                            _read_frame(reader), self._idle_timeout
                        )
                    except asyncio.TimeoutError:
                        return
                else:
                    frame = await _read_frame(reader)
                if frame is None:
                    return
                yield frame
        finally:
            # Cancel-and-await so a pump_out() failure surfaces here
            # instead of rotting as an unretrieved task exception.
            pump.cancel()
            try:
                await pump
            except asyncio.CancelledError:
                pass
            await _close_writer(writer)


class TcpReplicaConnector(api.ReplicaConnector):
    """Dial-side connector over raw TCP (gRPC-connector contract)."""

    def __init__(
        self,
        kind: str = "peer",
        dial_timeout: float = 120.0,
        idle_timeout: float = 0.0,
    ):
        if kind not in ("peer", "client"):
            raise ValueError(f"unknown chat kind {kind!r}")
        self._kind = PEER_KIND if kind == "peer" else CLIENT_KIND
        self._dial_timeout = dial_timeout
        # Per-stream read-idle deadline (seconds; 0 = off): tears down a
        # half-open connection so the redial loop can recover it — see
        # _TcpStreamHandler.handle_message_stream.
        self._idle_timeout = idle_timeout
        self._targets: Dict[int, tuple] = {}

    def connect_replica(self, replica_id: int, target: str) -> None:
        host, port = target.rsplit(":", 1)
        self._targets[replica_id] = (host, int(port))

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        t = self._targets.get(replica_id)
        if t is None:
            return None
        return _TcpStreamHandler(
            t[0], t[1], self._kind, self._dial_timeout, self._idle_timeout
        )

    async def close(self) -> None:
        # Connections are per-stream and owned by their handlers; nothing
        # pooled to tear down here.
        self._targets.clear()


def connect_many_replicas_tcp(
    targets: Dict[int, str], kind: str = "peer", idle_timeout: float = 0.0
) -> TcpReplicaConnector:
    conn = TcpReplicaConnector(kind, idle_timeout=idle_timeout)
    for rid, target in targets.items():
        conn.connect_replica(rid, target)
    return conn


class TcpReplicaServer:
    """Serve a replica's connection handler over raw TCP (the
    ReplicaServer contract of sample/conn/grpc/server.py)."""

    def __init__(self, conn_handler: api.ConnectionHandler):
        self._conn = conn_handler
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        # Live connection tasks: stop() must cancel them — in 3.12+
        # Server.wait_closed() waits for connection handlers to FINISH,
        # and ours run until their stream ends.
        self._tasks: set = set()

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            await self._serve_connection_inner(reader, writer)
        finally:
            self._tasks.discard(task)

    async def _serve_connection_inner(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            kind = await reader.readexactly(1)
        except (asyncio.IncompleteReadError, ConnectionError):
            await _close_writer(writer)
            return
        if kind == PEER_KIND:
            handler = self._conn.peer_message_stream_handler()
        elif kind == CLIENT_KIND:
            handler = self._conn.client_message_stream_handler()
        else:
            await _close_writer(writer)
            return

        async def incoming() -> AsyncIterator[bytes]:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    return
                yield frame

        try:
            async for out in handler.handle_message_stream(incoming()):
                _write_frame(writer, out)
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            # A protocol-level rejection (e.g. an unauthenticated HELLO)
            # closes this connection only.
            pass
        finally:
            await _close_writer(writer)

    async def start(self, address: str = "127.0.0.1:0") -> str:
        host, port = address.rsplit(":", 1)
        self._server = await asyncio.start_server(
            self._serve_connection, host, int(port)
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return f"{host}:{self.port}"

    async def stop(self, grace: float = 0.1) -> None:
        """Stop listening, give live connection handlers ``grace`` seconds
        to drain their streams (the gRPC server-contract semantics — a
        handler mid-reply finishes instead of losing the frame), then
        cancel whatever remains and wait for the sockets to close."""
        if self._server is not None:
            self._server.close()  # no NEW connections during the grace
            live = [t for t in self._tasks if not t.done()]
            if live and grace > 0:
                await asyncio.wait(live, timeout=grace)
            for t in list(self._tasks):
                t.cancel()
            if self._tasks:
                await asyncio.gather(*self._tasks, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None
