"""In-process connectivity: replica stubs and the dummy connector.

Reference sample/conn/common/replicastub (late-binding ConnectionHandler
that buffers stream requests until the replica is assigned — this is what
lets an in-process test network wire circular topologies) and
sample/conn/dummy/connector (same-process connector over the stubs).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, Optional

from ... import api

# Strong refs to scheduled aclose() tasks (TL601): the loop keeps only
# a weak reference to a running task, so without this set a deferred
# close is GC-able before the inner generator finalizes.
_close_tasks: set = set()


class ReplicaStub(api.ConnectionHandler):
    """Late-binding connection handler (reference
    sample/conn/common/replicastub/replica-stub.go:26-105)."""

    def __init__(self):
        self._replica: Optional[api.Replica] = None
        self._ready = asyncio.Event()
        self._crashed = asyncio.Event()

    def assign_replica(self, replica: api.Replica) -> None:
        self._replica = replica
        self._ready.set()

    def crash(self) -> None:
        """Simulate a process crash: every live stream through this stub
        ends and new ones never start (the in-process analogue of killing
        a replica process, reference README.md:411-458) — used by the
        view-change tests to take the primary down for real."""
        self._crashed.set()

    def revive(self) -> None:
        """Undo :meth:`crash` for NEW streams: the restart half of
        crash/restart fault injection (testing/faultnet.py).  Streams
        opened before the crash stay dead (they raced the old event);
        fresh dials reach whatever replica is (re-)assigned — callers
        restart a replica by ``assign_replica``-ing a new instance (or an
        adversarial stand-in) and then reviving."""
        self._crashed = asyncio.Event()

    def peer_message_stream_handler(self) -> api.MessageStreamHandler:
        return _DeferredHandler(self, "peer")

    def client_message_stream_handler(self) -> api.MessageStreamHandler:
        return _DeferredHandler(self, "client")


class _DeferredHandler(api.MessageStreamHandler):
    def __init__(self, stub: ReplicaStub, kind: str):
        self._stub = stub
        self._kind = kind

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        await self._stub._ready.wait()
        if self._stub._crashed.is_set():
            return
        replica = self._stub._replica
        handler = (
            replica.peer_message_stream_handler()
            if self._kind == "peer"
            else replica.client_message_stream_handler()
        )
        agen = handler.handle_message_stream(in_stream)
        crashed = asyncio.ensure_future(self._stub._crashed.wait())
        nxt = None
        try:
            while True:
                nxt = asyncio.ensure_future(agen.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, crashed}, return_when=asyncio.FIRST_COMPLETED
                )
                if crashed in done:
                    break
                try:
                    out = nxt.result()
                except StopAsyncIteration:
                    break
                nxt = None
                yield out
        finally:
            # May run under GeneratorExit (caller closed us), where
            # awaiting is not allowed: cancel the in-flight step (which
            # unwinds the inner generator at its suspend point) and
            # schedule the close instead of awaiting it.
            crashed.cancel()
            if nxt is not None and not nxt.done():
                nxt.cancel()

            async def _close() -> None:
                try:
                    await agen.aclose()
                except BaseException:
                    pass

            t = asyncio.get_running_loop().create_task(_close())
            _close_tasks.add(t)
            t.add_done_callback(_close_tasks.discard)


class InProcessPeerConnector(api.ReplicaConnector):
    """Replica-side connector (reference sample/conn/common/connector.go:62-78
    resolving PeerMessageStreamHandler)."""

    def __init__(self, stubs: Dict[int, ReplicaStub]):
        self._stubs = stubs

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        stub = self._stubs.get(replica_id)
        return stub.peer_message_stream_handler() if stub else None


class InProcessClientConnector(api.ReplicaConnector):
    """Client-side connector resolving ClientMessageStreamHandler."""

    def __init__(self, stubs: Dict[int, ReplicaStub]):
        self._stubs = stubs

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        stub = self._stubs.get(replica_id)
        return stub.client_message_stream_handler() if stub else None


def make_testnet_stubs(n: int) -> Dict[int, ReplicaStub]:
    """Stub per replica, for wiring a circular in-process topology
    (reference core/integration_test.go:166-197)."""
    return {i: ReplicaStub() for i in range(n)}
