"""Typed protocol messages.

Mirrors the abstract message hierarchy of the reference
(reference messages/api.go:35-118): Message → {ClientMessage, ReplicaMessage,
PeerMessage, CertifiedMessage, SignedMessage} → six concrete kinds.

Embedding structure is preserved exactly: a COMMIT embeds the full PREPARE it
commits to, and a PREPARE embeds the full REQUEST it orders
(reference messages/api.go:88-101).  That embedding is what lets a backup
re-validate everything it acts on without extra round trips.

Unlike the reference's protobuf implementation, serialization here is a flat,
deterministic, hand-rolled binary codec (:mod:`minbft_tpu.messages.codec`) —
there is no schema compiler in the loop and byte layouts are canonical, which
matters because signatures and USIG certificates are computed over
:func:`minbft_tpu.messages.authen.authen_bytes` of these exact bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class UI:
    """Unique Identifier produced by a USIG.

    Mirrors reference usig/usig.go:44-51: a monotonic counter value plus a
    certificate binding (message digest, epoch, counter) under the replica's
    trusted key.  Marshalled big-endian (reference usig/usig.go:84-102).
    """

    counter: int
    cert: bytes = b""

    def to_bytes(self) -> bytes:
        return self.counter.to_bytes(8, "big") + self.cert

    @classmethod
    def from_bytes(cls, data: bytes) -> "UI":
        if len(data) < 8:
            raise ValueError("UI too short")
        return cls(counter=int.from_bytes(data[:8], "big"), cert=data[8:])


class Message:
    """Base for all protocol messages."""

    KIND: str = "?"

    def to_bytes(self) -> bytes:
        from . import codec

        return codec.marshal(self)


@dataclasses.dataclass
class Hello(Message):
    """Peer handshake announcing the sender's replica ID.

    Sent once when a replica opens a peer connection; the receiver responds by
    streaming its broadcast + unicast-to-that-peer message logs
    (reference core/message-handling.go:269-290, 316-350).

    **Signed** (beyond the reference, which binds the unicast replay to an
    unauthenticated id — reference core/message-handling.go:316-350): the
    receiver verifies the replica signature over the claimed id before
    attaching the sender's unicast log, so an id-spoofing peer cannot
    subscribe to another replica's unicast stream.  A *replayed* signed
    HELLO still subscribes the replayer — harmless, but only because of
    the unicast-log CONTENT invariant pinned at
    ``UNICAST_LOG_MESSAGES`` below: read that note before adding any
    kind to a unicast log.

    ``resume_counter`` makes the replay RESUMABLE: the dialer stamps the
    next UI counter it expects from this peer (everything below it is
    already captured), and the publisher skips certified log entries
    with lower counters.  Through a lossy link this is the difference
    between healing a gap and a redial storm — a full replay must
    traverse the whole retained log intact to reach the gap counter
    (success probability ``(1-p)^N``), a resumed one only the missed
    tail.  Signed along with the id, so an in-path attacker cannot
    inflate it to starve the subscriber of entries it still needs.  A
    replayed old HELLO carries a STALE (lower) resume point — more
    replay, still harmless; ``0`` (the default) means replay everything.
    The wire format is NOT backward compatible (the u64 sits between
    replica_id and the signature, and both codec and authen-bytes
    include it) — all peers of a cluster run the same build, as
    everywhere else in this codec.
    """

    KIND = "HELLO"
    replica_id: int
    signature: bytes = b""
    resume_counter: int = 0


@dataclasses.dataclass
class Request(Message):
    """Client request: (client, seq, operation), signed by the client
    (reference messages/api.go:47-56)."""

    KIND = "REQUEST"
    client_id: int
    seq: int
    operation: bytes
    signature: bytes = b""
    # Read-only support (reference roadmap README.md:503-504), covered by
    # the client's signature (authen.py) so it cannot be flipped in
    # flight: 0 = ordered write; 1 = FAST read (answered from committed
    # state without ordering — never valid inside a PREPARE); 2 = ORDERED
    # read (rides consensus for linearization but executes via
    # consumer.query, mutating nothing — the fast read's fallback).
    read_mode: int = 0

    @property
    def is_read(self) -> bool:
        return self.read_mode != 0

    @property
    def is_fast_read(self) -> bool:
        return self.read_mode == 1


@dataclasses.dataclass
class Reply(Message):
    """Replica's signed reply to a client (reference messages/api.go:75-86)."""

    KIND = "REPLY"
    replica_id: int
    client_id: int
    seq: int
    result: bytes
    signature: bytes = b""
    # Marks a read-only fast-path answer; covered by the replica's
    # signature so an ordered reply cannot be replayed as a read.
    read_only: bool = False
    # Signed failure signal for read-only requests (query unsupported or
    # raised): a quorum of these resolves the client's request with a
    # typed error instead of a fabricated result — and instead of NO
    # reply, which would park the replica-side reply waiters forever.
    error: bool = False


@dataclasses.dataclass
class Busy(Message):
    """Replica's signed admission-shed signal to a client.

    Emitted instead of silence when the replica sheds an inbound REQUEST
    at the admission boundary (rx queue saturated / stream processor out
    of permits).  Signed like a Reply so a network adversary cannot forge
    backoff and starve a client; ``retry_after_ms`` is a hint scaled by
    the observed rx saturation, honored by the client's RetransmitBackoff
    (retransmits are suppressed until the hold expires, the pending
    request itself stays live).
    """

    KIND = "BUSY"
    replica_id: int
    client_id: int
    seq: int
    retry_after_ms: int
    signature: bytes = b""


@dataclasses.dataclass(init=False)
class Prepare(Message):
    """Primary's ordering proposal for a **batch** of requests, certified by
    the primary's USIG (reference messages/api.go:58-65).

    The reference orders one request per PREPARE; request batching is an
    explicitly unimplemented roadmap item there (reference README.md:505).
    Here a PREPARE carries an ordered tuple of requests assigned to one
    USIG counter value: the batch commits atomically and executes in list
    order, amortizing the PREPARE/COMMIT round (and its UI verifications)
    over the whole batch.  A single-request PREPARE (``request=`` keyword)
    is the degenerate batch, keeping reference-shaped call sites working.
    """

    KIND = "PREPARE"
    replica_id: int
    view: int
    requests: Tuple[Request, ...]
    ui: Optional[UI] = None
    # Canonical digest of the (possibly stubbed-away) request batch: a
    # **stub** PREPARE carries ``requests=()`` with this digest filled, and
    # has the *same* authen bytes as the full original — so the primary's
    # UI certificate (which also binds view and counter) still verifies on
    # it.  Stubs appear only inside checkpoint-truncated VIEW-CHANGE logs
    # and log replays, proving a counter slot's occupant without carrying
    # the batch content; live processing captures them but never applies
    # or executes them (a stub reaching execution would let a Byzantine
    # primary equivocate full-vs-stub under one UI).
    requests_digest: bytes = b""

    def __init__(
        self,
        replica_id: int,
        view: int,
        request: Optional[Request] = None,
        ui: Optional[UI] = None,
        requests: Optional[Sequence[Request]] = None,
        requests_digest: bytes = b"",
    ):
        if request is not None and requests is not None:
            raise ValueError("pass at most one of request= / requests=")
        self.replica_id = replica_id
        self.view = view
        self.requests = (
            (request,) if request is not None else tuple(requests or ())
        )
        if not self.requests and not requests_digest:
            raise ValueError(
                "PREPARE must order at least one request (or be a stub "
                "carrying the batch digest)"
            )
        self.ui = ui
        self.requests_digest = requests_digest

    @property
    def request(self) -> Request:
        """The first (often only) request of the batch."""
        return self.requests[0]

    @property
    def is_stub(self) -> bool:
        """True for a checkpoint-covered stub (digest kept, batch dropped)."""
        return not self.requests


@dataclasses.dataclass
class Commit(Message):
    """Backup's commitment to a PREPARE; embeds the full PREPARE and is
    certified by the backup's USIG (reference messages/api.go:67-73)."""

    KIND = "COMMIT"
    replica_id: int
    prepare: Prepare
    ui: Optional[UI] = None


@dataclasses.dataclass
class ReqViewChange(Message):
    """Signed request to move to a new view
    (reference messages/api.go:103-110)."""

    KIND = "REQ-VIEW-CHANGE"
    replica_id: int
    new_view: int
    signature: bytes = b""


@dataclasses.dataclass
class ViewChange(Message):
    """A replica's vote to enter ``new_view``, certified by its USIG and
    carrying its complete certified-message log since the genesis
    checkpoint (**beyond the reference**, whose view change stops at the
    REQ-VIEW-CHANGE demand — reference core/message-handling.go:419 "Not
    implemented"; protocol per the MinBFT paper §IV-B).

    The log is what makes n = 2f+1 view changes safe: a quorum member
    cannot *omit* a message it sent — every certified message consumes one
    USIG counter value, so receivers check the log's counters are exactly
    1..k with the VIEW-CHANGE itself at k+1, and any omission is a visible
    gap.  Whoever of the commit quorum lands in the view-change quorum
    therefore exposes the commitment evidence, faulty or not.

    Prior VIEW-CHANGE/NEW-VIEW messages appear in the log **trimmed**:
    their own payload emptied and ``log_digest`` carrying the canonical
    digest of what they covered.  A trimmed copy has the *same* authen
    bytes as the original (the digest substitutes for the recomputation),
    so the original UI certificate still verifies — the counter slot stays
    provably occupied without nesting the prior log, which would otherwise
    double the message per view change (exponential growth).  Log size is
    thus linear in certified PREPAREs/COMMITs — the same unboundedness as
    the reference's in-memory message log; checkpointing/GC is a roadmap
    item in both builds.
    """

    KIND = "VIEW-CHANGE"
    replica_id: int
    new_view: int
    log: Tuple[Message, ...]
    ui: Optional[UI] = None
    # Canonical digest of the (possibly trimmed-away) log contents; filled
    # on the wire so trimmed copies keep the original's authen bytes.
    log_digest: bytes = b""
    # Checkpoint truncation (phase 2 — core/checkpoint.py): the log may
    # omit the sender's certified messages with counters <= log_base,
    # provided checkpoint_cert carries f+1 matching CHECKPOINTs whose
    # per-peer coverage bounds for this sender are >= log_base — at least
    # one attester is correct, so the dropped prefix provably holds no
    # commit evidence beyond the certified checkpoint.  log_base == 0 is
    # the untruncated (genesis) form.
    log_base: int = 0
    checkpoint_cert: Tuple["Checkpoint", ...] = ()


@dataclasses.dataclass
class NewView(Message):
    """The new primary's certified announcement of ``new_view``: carries
    f+1 VIEW-CHANGEs (its quorum, own included) from which every replica
    deterministically derives the re-proposal set (see
    :func:`minbft_tpu.core.viewchange.compute_new_view_set`).  The
    NEW-VIEW's own UI counter is the base the new primary's PREPARE
    counters continue from."""

    KIND = "NEW-VIEW"
    replica_id: int
    new_view: int
    view_changes: Tuple["ViewChange", ...]
    ui: Optional[UI] = None
    # Same trimming mechanism as ViewChange.log_digest.
    vcs_digest: bytes = b""


@dataclasses.dataclass
class Checkpoint(Message):
    """A replica's **signed** snapshot claim: after executing ``count``
    requests — through batch ``(view, cv)``, which every correct replica
    reaches with the same deterministic execution history — its composite
    state digest is ``digest``.  f+1 matching claims on
    (count, view, cv, digest) make the checkpoint *stable* (beyond the
    reference, whose checkpointing is a reserved config knob —
    README.md:492-493; see :mod:`minbft_tpu.core.checkpoint`).

    Signed, not USIG-certified: a checkpoint consumes no USIG counter, so
    the primary emits them too without splitting its prepare-CV sequence
    (closing the liveness margin where f crashed backups left only f
    claims), and checkpoint claims never
    occupy slots in the certified log the view change reasons about.

    ``bounds`` is the sender's per-peer coverage attestation: for each
    peer p it has processed, the highest own-USIG-counter b such that
    every certified message of p with counter <= b is *covered* by this
    checkpoint (its batch executed within (view, cv), or its view-change
    transition concluded at a view <= view).  f+1 checkpoints each with
    bounds[p] >= β license p to truncate its log prefix 1..β — the
    validator-checkable completeness that makes GC safe at n = 2f+1,
    where quorum intersections can be entirely Byzantine and hiding
    evidence must be structurally impossible.
    """

    KIND = "CHECKPOINT"
    replica_id: int
    count: int
    digest: bytes
    view: int = 0
    cv: int = 0
    bounds: Tuple[Tuple[int, int], ...] = ()  # sorted (peer_id, bound)
    signature: bytes = b""

    def bound_for(self, peer_id: int) -> int:
        for p, b in self.bounds:
            if p == peer_id:
                return b
        return 0


@dataclasses.dataclass
class LogBase(Message):
    """Log-truncation announcement, streamed first when a replica's
    broadcast log no longer starts at USIG counter 1: counters 1..base are
    gone, and ``cert`` (f+1 matching CHECKPOINTs, each with a coverage
    bound for this sender >= base) proves the dropped prefix held no
    evidence beyond the certified checkpoint.  Carries no signature of its
    own — the embedded certificate is the entire claim, and understating
    ``base`` only withholds the sender's own messages (self-harm).

    A receiver fast-forwards its per-peer counter capture to base+1; if
    its own execution count is behind the certificate's, it must fetch the
    certified state first (:class:`SnapshotReq`)."""

    KIND = "LOG-BASE"
    replica_id: int
    base: int
    cert: Tuple[Checkpoint, ...] = ()


@dataclasses.dataclass
class SnapshotReq(Message):
    """Signed request for the state snapshot at stable checkpoint
    ``count`` (state transfer, phase 2 of checkpointing).  A responder
    that no longer retains that exact snapshot may answer with a NEWER
    certified one, attaching its certificate (see SnapshotResp.cert)."""

    KIND = "SNAPSHOT-REQ"
    replica_id: int
    count: int = 0
    signature: bytes = b""


@dataclasses.dataclass
class SnapshotResp(Message):
    """Signed state-transfer payload: the application snapshot plus the
    deterministic protocol watermarks at checkpoint ``count``.  The
    receiver verifies the composite checkpoint digest recomputed from this
    payload against an f+1-certified stable digest before installing —
    the sender's signature authenticates the unicast, the certificate
    authenticates the *content*.  ``cert`` is attached when the response
    is for a newer checkpoint than requested (the exact one aged out of
    the retention window); the receiver validates it independently and
    upgrades its target."""

    KIND = "SNAPSHOT-RESP"
    replica_id: int
    count: int
    view: int
    cv: int
    app_state: bytes
    # Sorted (client, seq) pairs; per client: retire floor first, then
    # the individually retired seqs above it (clientstate.retire_watermarks).
    watermarks: Tuple[Tuple[int, int], ...] = ()
    cert: Tuple[Checkpoint, ...] = ()
    signature: bytes = b""


@dataclasses.dataclass
class StateReq(Message):
    """Signed request for a **chunked** state stream starting at byte
    ``offset`` of the snapshot at stable checkpoint ``count`` (the
    ``Hello.resume_counter`` pattern generalized to state).
    ``count == 0`` asks for the responder's latest stable snapshot;
    ``offset > 0`` resumes a transfer severed mid-stream: the requester
    stamps how many bytes it has already verified against the chunk
    digest chain, and the responder serves only the missing tail.  The
    offset is signed with the id, so an in-path attacker can neither
    rewind the stream (waste) nor fast-forward it (starve the requester
    of bytes it still needs)."""

    KIND = "STATE-REQ"
    replica_id: int
    count: int = 0
    offset: int = 0
    signature: bytes = b""


@dataclasses.dataclass
class StateChunk(Message):
    """One signed slice of a snapshot stream: ``data`` is the snapshot
    bytes at ``offset`` of the ``total``-byte snapshot certified at
    stable checkpoint ``count``.  ``chain`` is the running digest
    ``chain_k = sha256(chain_{k-1} || data_k)`` (empty-string seed),
    recomputed by the responder from byte 0 regardless of the resume
    offset — chunking is deterministic (fixed chunk size), so any two
    honest responders produce byte-identical chunks and a resumed fetch
    can switch peers mid-stream.  The receiver extends its own chain
    and drops the transfer on the FIRST mismatching chunk (early
    Byzantine detection), but final authority stays with the f+1
    checkpoint certificate the assembled snapshot is verified against
    before install — the chain alone proves nothing."""

    KIND = "STATE-CHUNK"
    replica_id: int
    count: int
    offset: int
    total: int
    data: bytes
    chain: bytes = b""
    signature: bytes = b""


@dataclasses.dataclass
class StateDone(Message):
    """Signed terminal frame of a chunked state stream: the protocol
    position (view, cv) and deterministic watermarks at checkpoint
    ``count``, with ``total`` pinning the stream length.  ``cert`` is
    attached when the stream served a NEWER stable checkpoint than the
    requested one (the exact snapshot aged out of the retention
    window); the receiver validates it independently — exactly the
    SnapshotResp upgrade rule — before accepting the new target."""

    KIND = "STATE-DONE"
    replica_id: int
    count: int
    view: int
    cv: int
    total: int
    # Same layout as SnapshotResp.watermarks.
    watermarks: Tuple[Tuple[int, int], ...] = ()
    cert: Tuple[Checkpoint, ...] = ()
    signature: bytes = b""


# ---------------------------------------------------------------------------
# Classification helpers (reference messages/api.go interface hierarchy).

CLIENT_MESSAGES = (Request,)
REPLICA_MESSAGES = (
    Reply, Busy, Prepare, Commit, ReqViewChange, ViewChange, NewView,
    Checkpoint, LogBase, SnapshotReq, SnapshotResp, StateReq, StateChunk,
    StateDone,
)
PEER_MESSAGES = (
    Prepare, Commit, ReqViewChange, ViewChange, NewView, Checkpoint,
    LogBase, SnapshotReq, SnapshotResp, StateReq, StateChunk, StateDone,
)
CERTIFIED_MESSAGES = (Prepare, Commit, ViewChange, NewView)  # carry a USIG UI
SIGNED_MESSAGES = (
    Request, Reply, Busy, ReqViewChange, Checkpoint, SnapshotReq,
    SnapshotResp, StateReq, StateChunk, StateDone,
)  # carry a plain signature

# The kinds that may enter a per-peer UNICAST log (forwarded starved
# REQUESTs and the state-transfer pair) — enforced at the core's append
# sites (message_handling._unicast_append).
#
# Replay-harmlessness invariant (the reason a REPLAYED signed HELLO is
# safe to serve — see Hello): every kind listed here is public protocol
# content, individually signed or certificate-backed, with NO
# confidentiality claim — so an extra unicast subscriber obtained by
# replaying a peer's HELLO learns nothing and steals nothing (log streams
# are replay-then-follow; the genuine peer keeps receiving).  This note
# lives NEXT TO the content definition on purpose: if a unicast log ever
# gains a kind carrying non-public content (a secret-bearing state
# transfer, an unencrypted key share), the HELLO handshake must gain
# replay protection (a challenge nonce) IN THE SAME CHANGE, or a replayed
# HELLO becomes an exfiltration channel.
# The chunked state-transfer trio satisfies the invariant the
# same way the monolithic pair does: chunks carry slices of a snapshot
# whose WHOLE content is certificate-backed public protocol state.
UNICAST_LOG_MESSAGES = (
    Request, SnapshotReq, SnapshotResp, StateReq, StateChunk, StateDone,
)


def is_peer_message(m: Message) -> bool:
    return isinstance(m, PEER_MESSAGES)


def is_client_message(m: Message) -> bool:
    return isinstance(m, CLIENT_MESSAGES)
