"""gRPC communication backend (reference sample/conn/grpc/; port of
:mod:`minbft_tpu.sample.conn.grpc`, the same service and message bodies).

Bidirectional ``ClientChat``/``PeerChat`` streams carrying opaque serialized
protocol messages, exactly the reference's wire design
(reference sample/conn/grpc/channel.proto:22-29 — a single ``bytes payload``
field; here the payload rides as the raw request/response body via identity
(de)serializers, so no schema compiler is needed).
"""

from .connector import GrpcReplicaConnector, connect_many_replicas
from .server import ReplicaServer

__all__ = ["GrpcReplicaConnector", "ReplicaServer", "connect_many_replicas"]
