"""The wire-level service definition shared by connector and server.

Reference sample/conn/grpc/channel.proto:15-29 defines::

    service Channel {
      rpc ClientChat(stream Message) returns (stream Message);
      rpc PeerChat(stream Message) returns (stream Message);
    }
    message Message { bytes payload = 1; }

Rather than running a schema compiler, both ends register the two
stream-stream methods with **identity serializers**: each gRPC message body
*is* the opaque protocol-message payload (the codec's canonical bytes).
"""

SERVICE = "minbft.Channel"
CLIENT_CHAT = f"/{SERVICE}/ClientChat"
PEER_CHAT = f"/{SERVICE}/PeerChat"


def identity(b: bytes) -> bytes:
    return b
