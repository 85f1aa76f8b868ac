"""gRPC connector: the dialing side of replica connections.

Reference sample/conn/grpc/connector/: ``ConnectReplica(id, target)`` dials
a replica and exposes a ``MessageStreamHandler`` per chat kind; each
``handle_message_stream`` call opens one bidi-streaming RPC whose request
stream is pumped from the caller's outgoing iterator and whose responses
are yielded back (reference connector/replica.go:49-122 runs a goroutine
pair per stream; grpc.aio drives both directions from the one generator).
``wait_for_ready`` mirrors the reference's ``grpc.WaitForReady(true)`` dial
behavior so a cluster can start in any order.
"""

from __future__ import annotations

from typing import AsyncIterator, Dict, Optional

import grpc
import grpc.aio

from .... import api
from .channel import CLIENT_CHAT, PEER_CHAT, identity


class _GrpcStreamHandler(api.MessageStreamHandler):
    def __init__(self, channel: grpc.aio.Channel, method: str):
        self._rpc = channel.stream_stream(
            method, request_serializer=identity, response_deserializer=identity
        )

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        call = self._rpc(in_stream, wait_for_ready=True)
        try:
            async for resp in call:
                yield resp
        finally:
            call.cancel()


class GrpcReplicaConnector(api.ReplicaConnector):
    """Dial-side connector (reference connector.ReplicaConnector,
    sample/conn/grpc/connector/connector.go:27-53).

    ``kind`` selects which chat the resolved handlers speak:
    ``"peer"`` for replica-to-replica, ``"client"`` for client-to-replica.
    """

    def __init__(self, kind: str = "peer"):
        if kind not in ("peer", "client"):
            raise ValueError(f"unknown chat kind {kind!r}")
        self._method = PEER_CHAT if kind == "peer" else CLIENT_CHAT
        self._channels: Dict[int, grpc.aio.Channel] = {}

    def connect_replica(self, replica_id: int, target: str) -> None:
        """Associate ``replica_id`` with a dialed channel
        (reference connector.go:35-43)."""
        self._channels[replica_id] = grpc.aio.insecure_channel(target)

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        ch = self._channels.get(replica_id)
        if ch is None:
            return None
        return _GrpcStreamHandler(ch, self._method)

    async def close(self) -> None:
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()


def connect_many_replicas(
    targets: Dict[int, str], kind: str = "peer"
) -> GrpcReplicaConnector:
    """Dial every replica in ``targets`` (reference ConnectManyReplicas,
    sample/conn/grpc/connector/connector.go:45-53)."""
    conn = GrpcReplicaConnector(kind)
    for rid, target in targets.items():
        conn.connect_replica(rid, target)
    return conn
