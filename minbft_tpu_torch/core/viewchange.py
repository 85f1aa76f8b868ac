"""View-change protocol — **beyond the reference**, which stops at emitting
REQ-VIEW-CHANGE and refuses to process it ("Not implemented",
reference core/message-handling.go:419; roadmap README.md:490-497).

The protocol follows the MinBFT paper (§IV-B of "Efficient Byzantine
Fault-Tolerance", Veronese et al. 2013), adapted to this build's asyncio
closure graph and USIG machinery:

1. A replica suspecting the primary broadcasts a *signed*
   REQ-VIEW-CHANGE(v+1) (reference-parity part, core/timeout.py).
2. On f+1 distinct demands for view v' > current, a replica enters the
   transition: it stops applying view-v messages (the read-lease check in
   ``message_handling``) and broadcasts a *certified* VIEW-CHANGE carrying
   its complete certified-message log.  Log completeness is enforced by
   USIG itself: the entries' counters must be exactly 1..k with the
   VIEW-CHANGE at k+1 — omitting a sent message leaves a visible gap, so
   even a faulty quorum member exposes the commit evidence it holds.
3. The new primary (v' mod n) collects n-f VIEW-CHANGEs (f+1 exactly
   when n = 2f+1 — see :attr:`ViewChangeState.vc_quorum`) and broadcasts
   a certified NEW-VIEW embedding them.  Every replica derives the same
   re-proposal set S from those f+1 logs (:func:`compute_new_view_set`),
   enters v', and expects the new primary's first PREPAREs to re-propose
   exactly S in order — a deviation is refused and answered with a demand
   for v'+1.  The NEW-VIEW's own UI counter is the base from which the
   new primary's PREPARE counters continue
   (:meth:`minbft_tpu_torch.core.commit.CommitmentCollector.set_view_base`).
4. Re-proposed requests that were already executed are absorbed by the
   per-client retire watermark (execute-once), so state machines converge
   without double execution.

Safety sketch: a request executed anywhere needed f+1 commitments; any
n-f VIEW-CHANGE quorum intersects that commitment quorum in at least one
replica ((n-f) + (f+1) = n+1 > n), whose log — complete by the
counter-gap argument — contains its PREPARE/COMMIT for the request, so S
re-proposes it before any new request, in the original (view, counter)
order.

Checkpoint scoping (phase 2 — see :mod:`minbft_tpu_torch.core.checkpoint`):
a VIEW-CHANGE may truncate its log to counters ``log_base+1..k``,
carrying an f+1 checkpoint certificate whose per-peer coverage bounds
prove the dropped prefix held no commit evidence beyond the certified
checkpoint; retained covered entries may be stubbed (payload replaced by
its digest under the same UI).  The re-proposal set is then **anchored**:
batches at or below the quorum's best certified position are covered by
certified state (a lagging replica fetches it — state transfer) and are
not re-proposed, so view-change work is O(window since the last stable
checkpoint), not O(history).
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .. import api
from ..messages import Checkpoint, Commit, NewView, Prepare, ViewChange
from . import utils

# A batch key: the (client, seq) identity of each request a PREPARE orders.
BatchKey = Tuple[Tuple[int, int], ...]


def batch_key(prepare: Prepare) -> BatchKey:
    return tuple((r.client_id, r.seq) for r in prepare.requests)


def quorum_anchor(view_changes) -> Tuple[int, int, int, Tuple[Checkpoint, ...]]:
    """The best certified checkpoint position among a VIEW-CHANGE quorum:
    ``(count, view, cv, certificate)``.  Batches at or below it are
    covered by certified state; everything above must be re-proposed."""
    best = (0, 0, 0)
    cert: Tuple[Checkpoint, ...] = ()
    for vc in view_changes:
        if vc.checkpoint_cert:
            cp = vc.checkpoint_cert[0]
            if (cp.count, cp.view, cp.cv) > best:
                best = (cp.count, cp.view, cp.cv)
                cert = vc.checkpoint_cert
    return (*best, cert)


def compute_new_view_set(
    view_changes, new_view: int
) -> List[Prepare]:
    """Derive the deterministic re-proposal set S from a NEW-VIEW's n-f
    VIEW-CHANGEs: every full PREPARE of a view < new_view appearing in
    any log (directly, or embedded in a COMMIT) whose batch lies **above
    the quorum anchor**, ordered by (view, primary CV) and deduplicated —
    USIG uniqueness guarantees one PREPARE per (primary, counter), so the
    map cannot collide on conflicting proposals.

    Anchored batches are excluded: any request executed at or below the
    anchor is part of the f+1-certified state every replica entering the
    view holds (state transfer if behind), and execution order is
    lexicographic in (view, cv), so a request executed anywhere *above*
    the anchor has f+1 commitments at a batch above it — evidence the
    coverage-bound audit guarantees survives in the quorum logs.  Stubs
    are skipped for the same reason: a stub is validated as covered by
    its sender's certificate, which the anchor dominates.

    A batch appearing at several slots — its original PREPARE plus its
    re-proposals from intermediate failed views — is kept ONCE.  Without
    dedup, every unconcluded view change doubles S (the view-v originals
    plus the view-v' re-proposals of the same batches), so under
    sustained faults each transition carries exponentially more work
    than the last and the cluster livelocks in view-change thrash (the
    chaos soak found this at "768 re-proposals" of 6 requests).

    The surviving slot is the batch's LATEST (view, counter) appearance.
    Within any view, re-proposals are certified before fresh proposals
    IN S ORDER (enforced by check_reproposal at every backup), so the
    newest view's slots embed the full previously-committed order — the
    latest slot is always consistent with the execution order of every
    correct replica.  The earliest slot is NOT: a deposed primary that
    was stalled through its own view change (half-open link, partition)
    keeps certifying fresh PREPAREs for client retransmissions at its
    OLD view, and those uncommittable slots — present only in its own
    log, sorted before every later view — would steer S into an order
    that contradicts what the live quorum already executed (the chaos
    soak hit this as a real ledger fork: the healed ex-primary executed
    phase-D requests before the phase-C requests the cluster committed
    first).  A stale primary's late certifications always carry an old
    VIEW, so latest-slot ordering is immune to them by construction."""
    _, av, acv, _ = quorum_anchor(view_changes)
    prepares: Dict[Tuple[int, int], Prepare] = {}
    for vc in view_changes:
        for entry in vc.log:
            cand: Optional[Prepare] = None
            if isinstance(entry, Prepare):
                cand = entry
            elif isinstance(entry, Commit):
                cand = entry.prepare
            if cand is None or cand.ui is None or cand.view >= new_view:
                continue
            if cand.is_stub or (cand.view, cand.ui.counter) <= (av, acv):
                continue
            prepares[(cand.view, cand.ui.counter)] = cand
    # Latest slot per batch: ascending slot iteration, later overwrites.
    best: Dict[BatchKey, Tuple[Tuple[int, int], Prepare]] = {}
    for slot in sorted(prepares):
        best[batch_key(prepares[slot])] = (slot, prepares[slot])
    return [p for _, p in sorted(best.values(), key=lambda sp: sp[0])]


class ViewChangeState:
    """Per-replica bookkeeping for the view-change rounds.

    Memory is bounded: demands/collections are only accepted within
    ``MAX_VIEWS_AHEAD`` of the current view (honest escalation advances
    one view per timeout, so the window is generous), and concluded
    views' bookkeeping is pruned on view entry — a faulty replica cannot
    grow state by demanding views 10^9 apart."""

    MAX_VIEWS_AHEAD = 64

    def __init__(self, n: int, f: int, replica_id: int):
        self.n = n
        self.f = f
        self.replica_id = replica_id
        # REQ-VIEW-CHANGE demand votes: new_view -> demanding replica ids
        self.req_votes: Dict[int, Set[int]] = {}
        # collected VIEW-CHANGEs: new_view -> replica -> message
        self.view_changes: Dict[int, Dict[int, ViewChange]] = {}
        self.sent_view_change: Set[int] = set()  # new_views we voted for
        self.sent_new_view: Set[int] = set()
        # re-proposal enforcement, keyed per view: entering a view, the
        # new primary's first PREPAREs must match these batches in order.
        # Per-view (not a single slot): concurrent NEW-VIEW applications
        # during escalation must not overwrite the winning view's regime.
        self.reproposals: Dict[int, deque] = {}

    def in_window(self, new_view: int, current: int) -> bool:
        return current < new_view <= current + self.MAX_VIEWS_AHEAD

    def in_transition(self, current: int) -> bool:
        """True while this replica has VOTED (sent a VIEW-CHANGE) for a
        view beyond ``current`` — the window during which current-view
        messages are not applied.  Keyed on the actual vote, not on the
        expected-view watermark: a solo spurious demand advances the
        watermark without a quorum, and gating on it would wedge the
        replica until f+1 peers happened to demand too."""
        return any(v > current for v in self.sent_view_change)

    # -- demand votes -------------------------------------------------------

    def record_demand(self, replica_id: int, new_view: int) -> bool:
        """Record one REQ-VIEW-CHANGE; True when the f+1 quorum for
        ``new_view`` is (now) complete."""
        votes = self.req_votes.setdefault(new_view, set())
        votes.add(replica_id)
        return len(votes) >= self.f + 1

    # -- view-change collection --------------------------------------------

    @property
    def vc_quorum(self) -> int:
        """VIEW-CHANGE quorum size: **n - f**, not f+1.  The safety
        argument needs every view-change quorum to intersect every f+1
        commitment quorum: (n-f) + (f+1) = n+1 > n guarantees it for ALL
        n >= 2f+1, while f+1 only suffices at exactly n = 2f+1 (at n=4,
        f=1 two disjoint pairs could commit and recover separately,
        forking the ledger).  At n = 2f+1 this reduces to the paper's
        f+1.  Liveness holds: with <= f crashed, n-f replicas remain."""
        return self.n - self.f

    def record_view_change(self, vc: ViewChange) -> bool:
        """Record one validated VIEW-CHANGE; True when a quorum (n-f
        distinct replicas) for ``vc.new_view`` is available.  Only the
        first VIEW-CHANGE per (replica, view) counts — USIG counter order
        means every correct replica sees the same first one."""
        per_view = self.view_changes.setdefault(vc.new_view, {})
        per_view.setdefault(vc.replica_id, vc)
        return len(per_view) >= self.vc_quorum

    def quorum_for(self, new_view: int) -> List[ViewChange]:
        """The deterministic quorum subset used to build NEW-VIEW: lowest
        replica ids first."""
        per_view = self.view_changes.get(new_view, {})
        picked = sorted(per_view)[: self.vc_quorum]
        return [per_view[r] for r in picked]

    def prune_through(self, view: int) -> None:
        """Drop bookkeeping for concluded views (memory stays O(pending
        transitions), not O(views ever demanded))."""
        for d in (self.req_votes, self.view_changes):
            for v in [v for v in d if v <= view]:
                del d[v]
        self.sent_view_change = {v for v in self.sent_view_change if v > view}
        self.sent_new_view = {v for v in self.sent_new_view if v > view}
        for v in [v for v in self.reproposals if v < view]:
            del self.reproposals[v]

    # -- re-proposal enforcement -------------------------------------------

    def arm_reproposals(self, new_view: int, batches: List[BatchKey]) -> None:
        self.reproposals.setdefault(new_view, deque(batches))

    def check_reproposal(self, prepare: Prepare) -> bool:
        """True if ``prepare`` is acceptable under the re-proposal regime:
        either no regime is active for its view, or it matches the next
        expected batch (which it consumes)."""
        expected = self.reproposals.get(prepare.view)
        if not expected:
            return True  # no active regime for this prepare's view
        if batch_key(prepare) != expected[0]:
            return False
        expected.popleft()
        if not expected:
            del self.reproposals[prepare.view]
        return True


def trim_log_entry(entry):
    """The wire form of a prior VIEW-CHANGE/NEW-VIEW inside a log: payload
    emptied, its canonical digest carried instead — same authen bytes, so
    the original UI certificate verifies on the trimmed copy, and logs stay
    linear instead of nesting every earlier log (exponential growth)."""
    from ..messages.authen import collection_digest

    if isinstance(entry, ViewChange) and (entry.log or entry.checkpoint_cert):
        return ViewChange(
            replica_id=entry.replica_id,
            new_view=entry.new_view,
            log=(),
            ui=entry.ui,
            log_digest=collection_digest(entry.log, entry.log_digest),
            # log_base is part of the authen bytes (it scopes the claimed
            # history) and must survive trimming; the checkpoint cert is
            # transferable evidence outside the authen bytes and is
            # dropped with the log it vouched for.
            log_base=entry.log_base,
            checkpoint_cert=(),
        )
    if isinstance(entry, NewView) and entry.view_changes:
        return NewView(
            replica_id=entry.replica_id,
            new_view=entry.new_view,
            view_changes=(),
            ui=entry.ui,
            vcs_digest=collection_digest(entry.view_changes, entry.vcs_digest),
        )
    return entry


def make_view_change_validator(verify_ui, validate_cert=None):
    """Validate a VIEW-CHANGE: its own UI plus the USIG log-completeness
    invariant — entries are the sender's certified messages with counters
    exactly log_base+1..k and the VIEW-CHANGE itself at k+1.  Embedded
    foreign PREPAREs (inside the sender's COMMITs) are verified too, since
    the re-proposal set derives (view, counter) slots from them.

    Checkpoint scoping: a non-zero ``log_base`` requires an f+1
    checkpoint certificate whose coverage bounds for the sender reach the
    base (``validate_cert``, see core/checkpoint.py — at least one
    attester is correct, so the dropped prefix provably holds no evidence
    beyond the certificate).  Stubbed entries must be covered by the
    certificate's position — their (view, cv) claims are themselves
    USIG-authenticated (the digest substitution preserves authen bytes),
    so a sender cannot stub away live evidence."""

    from . import checkpoint as checkpoint_mod

    async def validate_view_change(vc: ViewChange) -> None:
        cp = None
        if vc.checkpoint_cert:
            if validate_cert is None:
                raise api.AuthenticationError(
                    "VIEW-CHANGE carries a checkpoint certificate but "
                    "this validator cannot check one"
                )
            cp = await validate_cert(vc.checkpoint_cert)
        if vc.log_base > 0:
            if cp is None:
                raise api.AuthenticationError(
                    "truncated VIEW-CHANGE without a checkpoint certificate"
                )
            bounds = [c.bound_for(vc.replica_id) for c in vc.checkpoint_cert]
            if min(bounds) < vc.log_base:
                raise api.AuthenticationError(
                    "VIEW-CHANGE log_base exceeds the certified coverage "
                    "bounds: the dropped prefix is not provably covered"
                )
        to_verify = []
        base = vc.log_base
        for i, entry in enumerate(vc.log):
            if entry.replica_id != vc.replica_id:
                raise api.AuthenticationError(
                    "VIEW-CHANGE log entry from another replica"
                )
            if entry.ui is None or entry.ui.counter != base + i + 1:
                raise api.AuthenticationError(
                    "VIEW-CHANGE log has a counter gap: omitted messages"
                )
            if isinstance(entry, ViewChange) and entry.log:
                # nested logs must arrive trimmed (see trim_log_entry) —
                # otherwise one message re-nests the whole history
                raise api.AuthenticationError(
                    "VIEW-CHANGE log entry must be trimmed"
                )
            if isinstance(entry, NewView) and entry.view_changes:
                raise api.AuthenticationError(
                    "NEW-VIEW log entry must be trimmed"
                )
            stub = (
                entry if isinstance(entry, Prepare) else entry.prepare
            ) if isinstance(entry, (Prepare, Commit)) else None
            if stub is not None and stub.is_stub:
                cov = checkpoint_mod.entry_coverage(entry)
                if cp is None or not checkpoint_mod.is_covered(
                    cov, cp.view, cp.cv
                ):
                    raise api.AuthenticationError(
                        "VIEW-CHANGE stubs an entry the certificate does "
                        "not cover"
                    )
            to_verify.append(entry)
            if isinstance(entry, Commit):
                to_verify.append(entry.prepare)
        # Entry checks are stateless: gather them so they co-batch on the
        # verification engine (the log grows with the checkpoint window —
        # one serial engine round-trip per entry would stall recovery; the
        # gather collapses them to ~one batch, prepare.py's house pattern).
        # Coroutines are created HERE, not in the loop: a raise mid-loop
        # would leak the already-created, never-awaited calls.
        results = await asyncio.gather(
            *(verify_ui(e) for e in to_verify), return_exceptions=True
        )
        for res in results:
            if isinstance(res, BaseException):
                raise res
        ui = await verify_ui(vc)
        if ui.counter != base + len(vc.log) + 1:
            raise api.AuthenticationError(
                "VIEW-CHANGE counter does not extend its log"
            )

    return validate_view_change


def make_new_view_validator(n: int, f: int, verify_ui, validate_view_change):
    """Validate a NEW-VIEW: sent by the view's primary, carrying n-f
    distinct valid VIEW-CHANGEs for the same view (see
    :attr:`ViewChangeState.vc_quorum` for why n-f, not f+1)."""

    quorum = n - f

    async def validate_new_view(nv: NewView) -> None:
        if not utils.is_primary(nv.new_view, nv.replica_id, n):
            raise api.AuthenticationError(
                "NEW-VIEW from a replica that is not the view's primary"
            )
        senders = {vc.replica_id for vc in nv.view_changes}
        if len(nv.view_changes) != quorum or len(senders) != quorum:
            raise api.AuthenticationError(
                "NEW-VIEW must carry n-f distinct VIEW-CHANGEs"
            )
        for vc in nv.view_changes:
            if vc.new_view != nv.new_view:
                raise api.AuthenticationError(
                    "NEW-VIEW embeds a VIEW-CHANGE for another view"
                )
        # The per-VC validations are stateless — gather them so the whole
        # quorum's UI checks co-batch on the verification engine instead
        # of paying n-f serial engine round-trips during recovery.
        results = await asyncio.gather(
            *[validate_view_change(vc) for vc in nv.view_changes],
            return_exceptions=True,
        )
        for res in results:
            if isinstance(res, BaseException):
                raise res
        await verify_ui(nv)

    return validate_new_view
