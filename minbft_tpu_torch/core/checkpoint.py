"""Checkpointing — certificates, log truncation, and the coverage-bound
audit that makes truncation safe at n = 2f+1.

Phase 1 (certificates) + phase 2 (GC/state transfer) of the reference's
top roadmap item (reference README.md:492-493 lists checkpointing/GC as
unimplemented; its ``checkpointPeriod``/``logsize`` config knobs are
reserved, reference api/api.go:40-43).

Protocol
--------

Execution is deterministic across correct replicas (the commitment
collector releases strictly in primary-CV order, batches execute in
batch order, and views advance monotonically), so the triple
``(count, view, cv)`` at a batch boundary — total requests delivered,
through which batch — is a deterministic global position.  Whenever
``count`` crosses a multiple of ``checkpoint_period`` at a batch end,
every replica (primary included) broadcasts a **signed** CHECKPOINT
claiming ``(count, view, cv, digest)`` where ``digest`` is the composite
:func:`checkpoint_digest` over the application state digest and the
per-client retire watermarks.  f+1 matching claims (own included — any
f+1 distinct replicas contain a correct one) make the checkpoint
**stable**: durable, transferable evidence of the state at that
position.

Checkpoints are signed rather than USIG-certified deliberately: they
consume no USIG counter, so the primary's prepare-CV sequence stays
contiguous (it can emit freely — closing the liveness margin where f
crashed backups left only f claims), and checkpoint claims never occupy
slots in the certified log that the view-change completeness argument
counts.

Truncation and the coverage-bound audit
---------------------------------------

The VIEW-CHANGE safety argument at n = 2f+1 needs *forced completeness*:
a quorum member — even a Byzantine one — must be unable to hide commit
evidence from its log, which the counters 1..k contiguity check
enforces.  Truncation must therefore be **validator-checkable**: a
replica may only drop a log prefix that provably holds no evidence
beyond a stable checkpoint.

Each CHECKPOINT therefore carries ``bounds``: for every peer p, the
highest own-counter b such that *all* of p's certified messages with
counters <= b that the emitter processed are **covered** by this
checkpoint — a PREPARE/COMMIT is covered iff its batch (view, cv) is <=
the checkpoint's (lexicographically; execution order is lexicographic in
(view, cv)), a VIEW-CHANGE/NEW-VIEW iff its transition concluded at a
view <= the checkpoint's.  Every replica already processes every peer's
log in strict counter order (peerstate capture), so these attestations
cost nothing extra.

Replica p may truncate its log prefix ``1..β`` once f+1 checkpoints
matching on (count, view, cv, digest) each attest ``bounds[p] >= β``:
at least one attester is correct, so the dropped prefix really is
covered.  The certificate travels with the truncated VIEW-CHANGE (and
with the LOG-BASE announcement on log replay), and validators check the
bounds — a Byzantine replica can *understate* its base (keeping more
history) but never overstate it to hide evidence.

Covered entries that cannot be dropped yet (the prefix rule: only a
contiguous prefix may go, or retained counters would gap) are **stubbed**
instead: the batch payload is replaced by its digest (same authen bytes,
so the UI certificate still verifies and the (view, cv) coverage claim is
itself USIG-authenticated — see ``messages.Prepare.requests_digest``).

Off by default: ``checkpoint_period = 0`` emits nothing and changes no
behavior.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..messages import Checkpoint, Commit, NewView, Prepare, ViewChange

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")

# A checkpoint position: (count, view, cv).
Position = Tuple[int, int, int]


def checkpoint_digest(
    app_digest: bytes,
    count: int,
    view: int,
    cv: int,
    watermarks: Sequence[Tuple[int, int]],
) -> bytes:
    """Composite digest a CHECKPOINT claims: application state plus the
    deterministic protocol watermarks (per-client retired seqs).  Covering
    the watermarks makes state transfer self-verifying — a snapshot
    provider cannot hand a rejoining replica understated watermarks (which
    would double-execute re-proposed requests) without breaking the f+1
    certified digest."""
    h = hashlib.sha256()
    h.update(b"CPDIGEST")
    h.update(_U64.pack(count))
    h.update(_U64.pack(view))
    h.update(_U64.pack(cv))
    h.update(app_digest)
    for client, seq in watermarks:
        h.update(_U32.pack(client) + _U64.pack(seq))
    return h.digest()


def entry_coverage(entry) -> Optional[Tuple[str, Tuple[int, int]]]:
    """Classify a certified-log entry for coverage accounting.

    Returns ``("batch", (view, cv))`` for PREPARE/COMMIT (covered once the
    checkpoint position passes that batch), ``("view", (new_view, 0))``
    for VIEW-CHANGE/NEW-VIEW (covered once checkpoints run in a view >=
    new_view, i.e. the transition concluded), or None for entries that
    never block coverage."""
    if isinstance(entry, Prepare):
        if entry.ui is None:
            return None
        return ("batch", (entry.view, entry.ui.counter))
    if isinstance(entry, Commit):
        p = entry.prepare
        if p.ui is None:
            return None
        return ("batch", (p.view, p.ui.counter))
    if isinstance(entry, (ViewChange, NewView)):
        return ("view", (entry.new_view, 0))
    return None


def is_covered(coverage, view: int, cv: int) -> bool:
    """Is a classified entry covered by checkpoint position (view, cv)?"""
    if coverage is None:
        return True
    kind, key = coverage
    if kind == "batch":
        return key <= (view, cv)
    return key[0] <= view  # a concluded transition


def _bounds_dominate(new: Checkpoint, prev: Checkpoint) -> bool:
    """True iff ``new``'s coverage bounds are >= ``prev``'s for every peer
    prev attests, and strictly better somewhere (or attest new peers)."""
    prev_b = dict(prev.bounds)
    new_b = dict(new.bounds)
    # An absent peer must never dominate a present bound — even a present
    # 0 (bounds are attacker-chosen; absence == -1 keeps two claims that
    # differ only in a 0-bound entry from alternately replacing each
    # other and churning cert_version).
    if any(new_b.get(p, -1) < b for p, b in prev_b.items()):
        return False
    return new_b != prev_b


class CheckpointCollector:
    """Tracks signed checkpoint claims, the stable watermark, and the
    growing stable certificate the truncation audit draws bounds from.

    Memory is O(n): one outstanding claim per replica plus the stable
    certificate (at most one claim per replica).  Claims for the *stable*
    position keep accumulating after stabilization — late matching claims
    raise the per-peer truncation bounds the certificate can prove."""

    def __init__(self, f: int, logger=None):
        self.f = f
        self.log = logger
        self._claims: Dict[int, Checkpoint] = {}  # replica -> newest claim
        self.stable_count = 0
        self.stable_view = 0
        self.stable_cv = 0
        self.stable_digest: bytes = b""
        self._stable_cert: Dict[int, Checkpoint] = {}  # replica -> claim
        # Bumped whenever the stable certificate changes — lets callers
        # re-attempt truncation only when a claim actually changed it.
        self.cert_version = 0

    @property
    def stable_position(self) -> Position:
        return (self.stable_count, self.stable_view, self.stable_cv)

    @property
    def stable_certificate(self) -> List[Checkpoint]:
        """All collected claims proving the stable watermark (>= f+1)."""
        return list(self._stable_cert.values())

    def certificate_for_bound(
        self, replica_id: int, quorum: int
    ) -> Tuple[int, List[Checkpoint]]:
        """The best truncation base the stable certificate can prove for
        ``replica_id``, with the ``quorum`` claims proving it: β is the
        quorum-th largest of the attested bounds (every claim in the
        returned certificate attests >= β)."""
        claims = sorted(
            self._stable_cert.values(),
            key=lambda c: c.bound_for(replica_id),
            reverse=True,
        )[:quorum]
        if len(claims) < quorum:
            return 0, []
        beta = claims[-1].bound_for(replica_id)
        return beta, claims

    def record(self, cp: Checkpoint) -> bool:
        """Account one signature-verified CHECKPOINT; True if it (now)
        makes its position stable.  Divergence — different digests
        certified for one position — is logged loudly: it means a
        diverged state machine or a lying replica, and an operator must
        look."""
        if cp.count < self.stable_count:
            return False
        if cp.count == self.stable_count:
            # A late claim for the already-stable position: grow the
            # certificate (its bounds raise what truncation can prove).
            if cp.digest == self.stable_digest and (
                cp.view,
                cp.cv,
            ) == (self.stable_view, self.stable_cv):
                prev = self._stable_cert.get(cp.replica_id)
                # Replace only when the new claim's bounds DOMINATE the
                # stored one's: signed claims are replayable, and an
                # older replayed claim must neither shrink the provable
                # truncation base nor churn cert_version (a Byzantine
                # peer alternating two replays would otherwise force a
                # full log scan per message).
                if prev is None or _bounds_dominate(cp, prev):
                    self._stable_cert[cp.replica_id] = cp
                    self.cert_version += 1
            elif self.log is not None:
                # A conflicting claim at an f+1-certified position is
                # hard evidence of a diverged state machine or a lying
                # replica — surface it as loudly as pre-stability
                # divergence.
                # Each side's view and cv: a view change re-certifies
                # one state under another digest (the digest covers the
                # view), while a conflict inside one view is a fork.
                self.log.error(
                    "checkpoint divergence at stable count %d: replica %d "
                    "certified %s in view %d cv %d vs stable %s in view %d cv %d",
                    cp.count,
                    cp.replica_id,
                    cp.digest.hex()[:16],
                    cp.view,
                    cp.cv,
                    self.stable_digest.hex()[:16],
                    self.stable_view,
                    self.stable_cv,
                )
            return False
        prev = self._claims.get(cp.replica_id)
        if prev is not None and prev.count >= cp.count:
            return False  # older (or duplicate) claim from this replica
        self._claims[cp.replica_id] = cp
        key = (cp.count, cp.view, cp.cv, cp.digest)
        matching = [
            c
            for c in self._claims.values()
            if (c.count, c.view, c.cv, c.digest) == key
        ]
        divergent = sorted(
            (c.replica_id, c.view, c.cv)
            for c in self._claims.values()
            if c.count == cp.count
            and (c.view, c.cv, c.digest) != (cp.view, cp.cv, cp.digest)
        )
        if divergent and self.log is not None:
            self.log.error(
                "checkpoint divergence at count %d: %s in view %d cv %d "
                "vs replicas %s",
                cp.count,
                cp.digest.hex()[:16],
                cp.view,
                cp.cv,
                ", ".join(f"{r} in view {v} cv {c}" for r, v, c in divergent),
            )
        if len(matching) < self.f + 1:
            return False
        self._stabilize(matching)
        return True

    def _stabilize(self, matching: List[Checkpoint]) -> None:
        """Adopt ``matching`` (>= f+1 verified claims on one position) as
        the stable certificate — shared by local stabilization and
        external adoption so the two can never diverge."""
        cp = matching[0]
        self.stable_count = cp.count
        self.stable_view = cp.view
        self.stable_cv = cp.cv
        self.stable_digest = cp.digest
        self._stable_cert = {c.replica_id: c for c in matching}
        self.cert_version += 1
        for rid in [
            r for r, c in self._claims.items() if c.count <= cp.count
        ]:
            del self._claims[rid]

    def install(self, cert: Iterable[Checkpoint]) -> None:
        """Adopt an externally received stable certificate (from a
        LOG-BASE or NEW-VIEW) if it is ahead of the local watermark.  The
        caller has already validated it (f+1 distinct matching verified
        claims)."""
        cert = list(cert)
        if not cert or cert[0].count <= self.stable_count:
            return
        self._stabilize(cert)


class CoverageTracker:
    """Per-peer coverage bookkeeping feeding a checkpoint's ``bounds``.

    For each peer: the highest captured counter, and the still-uncovered
    entries (counter -> coverage key).  Everything is O(messages since the
    last stable checkpoint) — covered entries are popped whenever bounds
    are computed."""

    def __init__(self):
        self._hi: Dict[int, int] = {}
        self._open: Dict[int, Dict[int, tuple]] = {}

    def track(self, peer_id: int, counter: int, entry) -> None:
        """Record a captured certified message (called post-capture, so
        exactly once per (peer, counter))."""
        if counter > self._hi.get(peer_id, 0):
            self._hi[peer_id] = counter
        cov = entry_coverage(entry)
        if cov is not None:
            self._open.setdefault(peer_id, {})[counter] = cov

    def bounds_at(self, view: int, cv: int) -> Tuple[Tuple[int, int], ...]:
        """Per-peer coverage bounds for a checkpoint at (view, cv); also
        prunes entries that position covers."""
        out = []
        for peer, hi in sorted(self._hi.items()):
            open_ = self._open.get(peer)
            if open_:
                for c in [
                    c for c, cov in open_.items() if is_covered(cov, view, cv)
                ]:
                    del open_[c]
            if open_:
                bound = min(open_) - 1
            else:
                bound = hi
            out.append((peer, bound))
        return tuple(out)


def make_cert_validator(f: int, verify_signature):
    """Validator for a checkpoint certificate (carried by truncated
    VIEW-CHANGEs and LOG-BASE announcements): at least f+1 claims from
    distinct replicas, all matching on (count, view, cv, digest), each
    signature-verified.  Returns the representative claim.  Any f+1
    distinct replicas include a correct one, so a valid certificate's
    position and digest — and each member's signed coverage bounds — are
    trustworthy evidence."""

    import asyncio as _asyncio

    from .. import api

    async def validate_cert(cert: Sequence[Checkpoint]) -> Checkpoint:
        if len(cert) < f + 1:
            raise api.AuthenticationError(
                "checkpoint certificate needs f+1 claims"
            )
        senders = {c.replica_id for c in cert}
        if len(senders) != len(cert):
            raise api.AuthenticationError(
                "checkpoint certificate has duplicate claimants"
            )
        key = (cert[0].count, cert[0].view, cert[0].cv, cert[0].digest)
        for c in cert[1:]:
            if (c.count, c.view, c.cv, c.digest) != key:
                raise api.AuthenticationError(
                    "checkpoint certificate claims do not match"
                )
        results = await _asyncio.gather(
            *[verify_signature(c) for c in cert], return_exceptions=True
        )
        for res in results:
            if isinstance(res, BaseException):
                raise res
        return cert[0]

    return validate_cert


class CheckpointEmitter:
    """Drives checkpoint emission at executed **batch boundaries** (never
    mid-batch, so (count, view, cv) is a deterministic global position):
    whenever the delivered-request count has crossed a multiple of
    ``period`` at a batch end, sign and broadcast a CHECKPOINT of the
    composite state digest.  ``period <= 0`` disables emission entirely.

    Also retains the application snapshot + watermarks captured at the
    last emissions (``snapshot_for``) so this replica can serve state
    transfer for its certified claims — the snapshot must be taken at the
    checkpoint's exact position, not at request time (execution moves
    on).  Consumers without snapshot support degrade gracefully (no
    retained snapshots; truncation still works)."""

    RETAIN_SNAPSHOTS = 2

    def __init__(
        self, replica_id: int, period: int, consumer, watermarks, bounds_at,
        emit_signed,
    ):
        self.replica_id = replica_id
        self.period = period
        self._consumer = consumer
        self._watermarks = watermarks
        self._bounds_at = bounds_at
        self._emit_signed = emit_signed
        self.count = 0  # requests actually delivered (never re-drains)
        self._last_emit = 0
        self._snapshots: Dict[int, tuple] = {}  # count -> (view, cv, app, marks)

    def on_delivered(self) -> None:
        self.count += 1

    async def on_batch_end(self, view: int, cv: int) -> None:
        if self.period <= 0:
            return
        count = self.count
        if count // self.period <= self._last_emit // self.period:
            return
        self._last_emit = count
        marks = self._watermarks()
        try:
            app = self._consumer.snapshot()
        except NotImplementedError:
            app = None
        if app is not None:
            self._snapshots[count] = (view, cv, app, marks)
            for c in sorted(self._snapshots)[: -self.RETAIN_SNAPSHOTS]:
                del self._snapshots[c]
        await self._emit_signed(
            Checkpoint(
                replica_id=self.replica_id,
                count=count,
                view=view,
                cv=cv,
                digest=checkpoint_digest(
                    self._consumer.state_digest(), count, view, cv, marks
                ),
                bounds=self._bounds_at(view, cv),
            )
        )

    def snapshot_for(self, count: int):
        """(view, cv, app_state, watermarks) captured at emission, or
        None."""
        return self._snapshots.get(count)

    def install(self, count: int) -> None:
        """State transfer: adopt the certified position's count."""
        self.count = count
        self._last_emit = count
