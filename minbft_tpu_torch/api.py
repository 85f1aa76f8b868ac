"""External-module API contracts.

Mirrors the reference ``api`` package (reference api/api.go:26-159): the core
protocol engine sees *only* these interfaces; concrete crypto, transport,
config, and state-machine implementations are plugged in from outside
(reference README.md:460-478 design stance).  The asyncio re-design changes
two things relative to the Go contracts:

- Message streams are ``AsyncIterator[bytes]`` instead of Go channels
  (reference api/api.go:80-91 ``MessageStreamHandler.HandleMessageStream``).
- ``Authenticator.verify_message_authen_tag`` is a **coroutine**: the TPU
  authenticator accumulates concurrent verifications into one batched XLA
  kernel dispatch, so verification must be awaitable (the reference verifies
  serially and synchronously, sample/authentication/crypto.go:79-89 — this
  is the north-star restructuring).
"""

from __future__ import annotations

import abc
import enum
from typing import AsyncIterator, Awaitable, Optional


class AuthenticationRole(enum.Enum):
    """Which key family authenticates a message
    (reference api/authentication.go roles; api/api.go:99-120)."""

    REPLICA = "replica"  # replica signatures (REPLY, REQ-VIEW-CHANGE)
    CLIENT = "client"  # client signatures (REQUEST)
    USIG = "usig"  # USIG UI certificates (PREPARE, COMMIT)


class AuthenticationError(Exception):
    """Tag failed to verify."""


class ReadOnlyQueryError(Exception):
    """A read-only request failed cluster-side: a reply-quorum of
    replicas signed error replies (consumer lacks query() support, or
    query() raised on the operation).  Distinguished from a timeout —
    the cluster is healthy and answered; the READ is what failed."""


class EmbeddedRequestAuthError(AuthenticationError):
    """A UI-certified proposal (PREPARE/COMMIT) embeds a REQUEST whose
    client authentication fails locally while the proposal's own UI is
    valid.  Under signature schemes every correct replica agrees on the
    check, but under per-pair MAC authentication a faulty client can
    craft a MAC vector that verifies at the primary and fails at a
    backup — the backup then cannot capture the primary's UI counter and
    every later message from that primary parks behind the gap.  Raised
    distinctly so message handling can demand a view change (depose the
    wedged primary) instead of stalling silently."""


class Authenticator(abc.ABC):
    """Message authentication provider (reference api/api.go:93-132).

    ``generate`` is synchronous (local signing, serial per-key by nature —
    the USIG counter must increment atomically).  ``verify`` is awaitable so
    implementations can batch many in-flight verifications into one TPU
    kernel dispatch (see minbft_tpu/parallel/engine.py).

    ``generate_message_authen_tag_async`` is the batch-aware sign surface:
    implementations that can co-batch many in-flight signatures (the
    engine's sign queue over the fixed-base comb kernels) override it for
    the CLIENT/REPLICA roles; the default delegates to the synchronous
    path.  The USIG role must stay on the synchronous path in every
    implementation — the UI counter is incremented only after the
    certificate exists (reference usig/sgx/enclave/usig.c:66-69), an
    inherently serial per-key discipline that batching would break.
    """

    @abc.abstractmethod
    def generate_message_authen_tag(
        self, role: AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        """Sign/certify ``msg`` under own key for ``role`` -> tag bytes.

        ``audience``: the recipient principal id when the tag is
        recipient-specific (a MAC-scheme REPLY is keyed to one client);
        -1 = everyone (signatures, MAC vectors over all replicas).
        Signature-scheme implementations ignore it."""

    async def generate_message_authen_tag_async(
        self, role: AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        """Awaitable tag generation for callers already running on the
        event loop (client REQUEST signing, replica REPLY emission).
        Default: the synchronous path, unchanged semantics."""
        return self.generate_message_authen_tag(role, msg, audience)

    @abc.abstractmethod
    async def verify_message_authen_tag(
        self, role: AuthenticationRole, peer_id: int, msg: bytes, tag: bytes
    ) -> None:
        """Verify ``tag`` over ``msg`` against ``peer_id``'s key for
        ``role``; raises :class:`AuthenticationError` on failure."""

    @property
    def supports_batch_verify(self) -> bool:
        """True when :meth:`verify_message_authen_tags` lands a bundle on
        a shared batching engine whose in-flight coalescing makes a
        fire-and-forget SEED call free for the per-message verifications
        that follow (the bundle-ingest runtime's preverify).  False — the
        default — means batch verification is just a serial loop, and
        seeding it would verify everything twice."""
        return False

    async def verify_message_authen_tags(
        self, role: AuthenticationRole, items
    ) -> list:
        """Batch verification surface for the bundle-ingest runtime:
        ``items = [(peer_id, msg, tag), ...]`` -> one entry per item,
        ``None`` on success or the :class:`AuthenticationError` VALUE on
        failure (errors are item-wise — one bad tag must never poison a
        bundle).  The default verifies serially through
        :meth:`verify_message_authen_tag`; implementations with a batch
        engine (the sample authenticator) override it to land the whole
        bundle in one engine call."""
        out = []
        for peer_id, msg, tag in items:
            try:
                await self.verify_message_authen_tag(role, peer_id, msg, tag)
                out.append(None)
            except AuthenticationError as e:
                out.append(e)
        return out


class Configer(abc.ABC):
    """Protocol configuration provider (reference api/api.go:34-53)."""

    @property
    @abc.abstractmethod
    def n(self) -> int:
        """Total number of replicas."""

    @property
    @abc.abstractmethod
    def f(self) -> int:
        """Maximum tolerated faulty replicas (n >= 2f+1)."""

    @property
    def checkpoint_period(self) -> int:
        """Reserved (reference roadmap README.md:492-493)."""
        return 0

    @property
    def logsize(self) -> int:
        """Reserved (reference roadmap README.md:492-493)."""
        return 0

    @property
    def timeout_request(self) -> float:
        """Seconds before a pending request triggers view-change demand."""
        return 2.0

    @property
    def timeout_prepare(self) -> float:
        """Seconds a backup waits for its request to be prepared before
        forwarding it to the primary."""
        return 1.0


class MessageStreamHandler(abc.ABC):
    """Bidirectional stream of serialized messages
    (reference api/api.go:80-91): consume an async stream of request bytes,
    yield reply bytes.  Eventual delivery / ordering caveats as documented
    at reference api/api.go:69-78."""

    @abc.abstractmethod
    def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        ...


class ConnectionHandler(abc.ABC):
    """Server side of a connection: resolves per-kind stream handlers
    (reference api/api.go:55-67)."""

    @abc.abstractmethod
    def peer_message_stream_handler(self) -> MessageStreamHandler:
        ...

    @abc.abstractmethod
    def client_message_stream_handler(self) -> MessageStreamHandler:
        ...


class ReplicaConnector(abc.ABC):
    """Client side of connections to replicas (reference api/api.go:64-78)."""

    @abc.abstractmethod
    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[MessageStreamHandler]:
        """Handler speaking to ``replica_id``; None if unknown."""


class RequestConsumer(abc.ABC):
    """The replicated state machine (reference api/api.go:134-153)."""

    @abc.abstractmethod
    def deliver(self, operation: bytes) -> "Awaitable[bytes]":
        """Execute an ordered operation; awaitable resolves to the result
        bytes (reference: Deliver returns a result channel,
        sample/requestconsumer/simpleledger.go:146-151)."""

    @abc.abstractmethod
    def state_digest(self) -> bytes:
        """Digest of the current application state
        (reference api/api.go:148-152)."""

    def snapshot(self) -> bytes:
        """Serialized application state for checkpoint state transfer.
        Must round-trip: ``install_snapshot(snapshot())`` on a fresh
        instance yields the same ``state_digest()``.  Optional — but
        without it the replica keeps its full message log (checkpoints
        still stabilize; log truncation is disabled, because dropped
        history could strand a lagging replica that then has no snapshot
        to catch up from)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support state snapshots"
        )

    def query(self, operation: bytes) -> "Awaitable[bytes]":
        """Answer a READ-ONLY operation from current committed state,
        without ordering it (the reference lists read-only requests as a
        roadmap item, README.md:503-504).  Must be deterministic in the
        state: replicas at the same committed prefix return the same
        bytes, because the client accepts a fast read only when ALL n
        replies match (the n=2f+1 read-quorum bound: any smaller quorum
        cannot guarantee intersection with a write quorum in a correct
        replica).  Optional — replicas whose consumer lacks it drop
        read-only requests, and the client falls back to an ordered
        request.

        Capability probing: the core uses :func:`consumer_supports_query`
        — a consumer that DELEGATES query to a wrapped consumer (metrics
        shims, access-control decorators) should set the
        ``supports_query`` attribute explicitly, since the structural
        did-you-override-it fallback cannot see through delegation."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support read-only queries"
        )

    def install_snapshot(self, data: bytes) -> None:
        """Atomically replace the application state with a snapshot.
        Implementations must validate internal integrity and leave the
        prior state untouched on failure — the caller verifies
        ``snapshot_digest`` against an f+1-certified checkpoint digest
        before installing."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support state snapshots"
        )

    def snapshot_digest(self, data: bytes) -> bytes:
        """The ``state_digest()`` the snapshot would produce once
        installed, computed WITHOUT mutating local state — lets a receiver
        check a transferred snapshot against a certified checkpoint digest
        before committing to it.  Raises ``ValueError`` on a malformed
        snapshot."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support state snapshots"
        )


def consumer_supports_query(consumer: "RequestConsumer") -> bool:
    """Feature-probe a consumer's fast-read capability.

    A ``supports_query`` attribute wins outright — that is how a
    delegating wrapper (whose ``query`` override forwards to a wrapped
    consumer) keeps the fast-read path, and how a consumer can
    explicitly opt out.  Absent that, fall back to the structural probe:
    did the class override :meth:`RequestConsumer.query` at all."""
    flag = getattr(consumer, "supports_query", None)
    if flag is not None:
        return bool(flag)
    meth = getattr(type(consumer), "query", None)
    if meth is None:
        # Duck-typed consumer (e.g. a __getattr__ delegator that never
        # subclassed RequestConsumer): probe the instance.
        return callable(getattr(consumer, "query", None))
    return meth is not RequestConsumer.query


class Replica(abc.ABC):
    """A running replica instance (reference api/api.go:155-159)."""

    @abc.abstractmethod
    def peer_message_stream_handler(self) -> MessageStreamHandler:
        ...

    @abc.abstractmethod
    def client_message_stream_handler(self) -> MessageStreamHandler:
        ...

    @abc.abstractmethod
    async def start(self) -> None:
        """Connect to peers and start processing."""

    @abc.abstractmethod
    async def stop(self) -> None:
        """Stop background tasks."""


class NotPortedError(SystemExit):
    """An option of the reference whose module the port does not have yet
    (exits non-zero, naming the ROADMAP.md item that will bring it)."""

    def __init__(self, what: str, item: str):
        super().__init__(
            f"peer: {what} is not supported by the port yet "
            f"(ROADMAP.md queue 1 item {item})"
        )
