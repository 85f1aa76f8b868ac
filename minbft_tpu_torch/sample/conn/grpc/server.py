"""gRPC server side: bridge incoming streams to a ConnectionHandler.

Reference sample/conn/grpc/server/server.go:88-143: each incoming
``ClientChat``/``PeerChat`` RPC is bridged to the replica's
``MessageStreamHandler`` with a goroutine pair (errgroup); here the bridge
is a single async generator — the RPC's request iterator feeds the handler
and the handler's replies stream back as responses.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

import grpc
import grpc.aio

from .... import api
from .channel import CLIENT_CHAT, PEER_CHAT, SERVICE, identity


def _stream_bridge(get_handler):
    """One stream-stream RPC bound to one MessageStreamHandler factory.

    Must be a plain async-generator *function* (not a callable object):
    grpc.aio introspects the behavior with ``inspect.isasyncgenfunction``
    and would otherwise fall back to its sync-generator thread shim."""

    async def bridge(
        request_iterator: AsyncIterator[bytes], context
    ) -> AsyncIterator[bytes]:
        handler: api.MessageStreamHandler = get_handler()
        async for out in handler.handle_message_stream(request_iterator):
            yield out

    return bridge


class ReplicaServer:
    """Serves a replica's connection handler over gRPC
    (reference server.ReplicaServer, sample/conn/grpc/server/server.go:43-86).

    ``conn_handler`` provides the two stream handlers (an ``api.Replica``
    satisfies the interface)."""

    def __init__(self, conn_handler: api.ConnectionHandler):
        self._conn = conn_handler
        self._server: Optional[grpc.aio.Server] = None
        self.port: Optional[int] = None

    async def start(self, address: str = "127.0.0.1:0") -> str:
        """Bind and start serving; returns the bound address (with the real
        port when ``address`` asked for an ephemeral one)."""
        server = grpc.aio.server()
        rpcs = {
            CLIENT_CHAT.rsplit("/", 1)[1]: grpc.stream_stream_rpc_method_handler(
                _stream_bridge(self._conn.client_message_stream_handler),
                request_deserializer=identity,
                response_serializer=identity,
            ),
            PEER_CHAT.rsplit("/", 1)[1]: grpc.stream_stream_rpc_method_handler(
                _stream_bridge(self._conn.peer_message_stream_handler),
                request_deserializer=identity,
                response_serializer=identity,
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, rpcs),)
        )
        self.port = server.add_insecure_port(address)
        self._server = server
        await server.start()
        host = address.rsplit(":", 1)[0]
        return f"{host}:{self.port}"

    async def stop(self, grace: float = 0.1) -> None:
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None
