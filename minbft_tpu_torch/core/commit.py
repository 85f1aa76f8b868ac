"""Commit pipeline and quorum counting (reference core/commit.go).

A COMMIT must come from a backup (never the view's primary, reference
commit.go:78-80) and embeds the full PREPARE it commits to; validation
re-validates the embedded PREPARE *and* the backup's own UI — up to three
signature checks that the GPU authenticator folds into one batch.

The commitment collector is the quorum core (reference commit.go:108-201):

- the **acceptor** enforces that each replica's commitments arrive with
  sequential primary-CVs (no gaps, no replays) per view;
- the **counter** counts distinct committers per (view, primary-CV) and
  signals "done" at f+1 (the primary's own PREPARE counts itself);
- completed quorums release the executor strictly in primary-CV order.

In the reference all of this is mutex-serialized per message
(commit.go:128-129); here the await points sit *after* batched validation,
so quorum accounting is pure in-memory bookkeeping on the event loop.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict, Tuple

from .. import api
from ..messages import Commit, Prepare
from . import utils


def make_commit_validator(
    n: int,
    validate_prepare,
    verify_ui,
) -> Callable[[Commit], Awaitable[None]]:
    """Reference makeCommitValidator (core/commit.go:74-92)."""

    async def validate_commit(commit: Commit) -> None:
        prepare = commit.prepare
        if utils.is_primary(prepare.view, commit.replica_id, n):
            raise api.AuthenticationError(
                "COMMIT must not come from the view's primary"
            )
        # Sequential, not gathered: the embedded PREPARE was almost always
        # validated when it arrived directly (verified-check memo), so the
        # first await usually resolves without suspending and gather's task
        # bookkeeping would be pure overhead on the hot path.
        await validate_prepare(prepare)
        await verify_ui(commit)

    return validate_commit


def make_commit_applier(
    collect_commitment,
) -> Callable[[Commit], Awaitable[None]]:
    """Reference makeCommitApplier (core/commit.go:96-104)."""

    async def apply_commit(commit: Commit) -> None:
        await collect_commitment(commit.replica_id, commit.prepare)

    return apply_commit


class CommitmentCollector:
    """Acceptor + counter + in-order executor release
    (reference makeCommitmentCollector/Acceptor/Counter,
    core/commit.go:108-201).

    Memory is bounded the way the reference bounds it: the acceptor keeps
    one (view, last-CV) pair per replica (commit.go:145-175) and the
    counter keeps only the **f highest primary-CVs** of the current view
    (commit.go:177-201) — a commitment is "done" exactly when f other
    replicas have already committed an equal-or-higher CV, which (because
    each replica's CVs are sequential) implies f+1 distinct replicas
    committed this CV.  Nothing grows with the number of requests served."""

    def __init__(self, f: int, execute_request, on_batch_end=None,
                 trace_quorum=None):
        self._f = f
        self._execute = execute_request
        # Flight-recorder COMMIT-QUORUM capture point (obs/trace.py):
        # noted per request when its batch's quorum releases in order,
        # immediately before execution.  None when tracing is off.
        self._trace_quorum = trace_quorum
        # Fired after each batch finishes executing, with (view, cv) — a
        # deterministic global position, which is what lets checkpoints
        # (core/checkpoint.py) claim a comparable (count, view, cv) on
        # every correct replica.  Never fired mid-batch.
        self._on_batch_end = on_batch_end
        self._lock = asyncio.Lock()
        self._exec_lock = asyncio.Lock()  # serializes state-machine execution
        # acceptor state: per replica, (view, last accepted primary-CV)
        self._accepted: Dict[int, Tuple[int, int]] = {}
        # counter state (reference commit.go:177-201): current view + the
        # f highest primary-CVs committed in it
        self._counter_view = 0
        self._highest = [0] * f
        # executor-release state: next primary CV to execute per view,
        # plus quorum-complete prepares awaiting in-order release
        self._next_exec_cv: Dict[int, int] = {}
        self._ready: Dict[Tuple[int, int], Prepare] = {}
        # per-view primary-CV base: view v's PREPARE counters continue from
        # the primary's USIG counter, which for v > 0 is wherever its
        # NEW-VIEW left it (the view-change protocol registers it); view 0
        # starts at 0 (counters begin at 1).
        self._view_base: Dict[int, int] = {0: 0}
        # stable checkpoint position (view, cv): a per-replica commitment
        # sequence may JUMP over batches at or below it — the skipped
        # commits were checkpoint-covered and pruned from the peer's
        # replayed log, and counting the jumper toward those batches is
        # sound because the certificate already proves they executed with
        # real f+1 quorums.  Uncovered gaps remain protocol violations.
        self._stable_view = 0
        self._stable_cv = 0

    def set_view_base(self, view: int, base_cv: int) -> None:
        """Register the primary-CV base for ``view`` (the NEW-VIEW's own
        counter): the view's first PREPARE must carry base_cv + 1.  Called
        by the view-change applier before the view activates.  Never
        trimmed here — a size-based eviction could drop the *current*
        view's base while its lease-holders are still applying (contested
        escalations register several candidate views before one wins);
        :meth:`prune_view_bases` retires concluded views instead."""
        self._view_base[view] = base_cv

    def prune_view_bases(self, active_view: int) -> None:
        """Drop bases of views below ``active_view`` — their messages are
        refused by the view check anyway.  Called after a view activates."""
        for v in [v for v in self._view_base if v < active_view]:
            del self._view_base[v]

    def note_stable(self, view: int, cv: int) -> None:
        """Record the stable checkpoint position (enables covered-gap
        acceptance — see the constructor comment)."""
        if (view, cv) > (self._stable_view, self._stable_cv):
            self._stable_view = view
            self._stable_cv = cv

    def install_checkpoint(self, view: int, cv: int) -> None:
        """State transfer: resume execution from certified position
        (view, cv).  Uses the view-base machinery — execution restarts at
        cv+1 in that view; commitments at or below the position are
        treated as replays.  Per-peer acceptance state is kept (peers'
        live commit sequences continued regardless of our jump; covered
        gaps are tolerated via note_stable)."""
        self.note_stable(view, cv)
        if view > self._counter_view:
            self._counter_view = view
            self._highest = [0] * self._f
        self._view_base.setdefault(view, 0)
        if view in self._next_exec_cv:
            self._next_exec_cv[view] = max(self._next_exec_cv[view], cv + 1)
        else:
            self._next_exec_cv[view] = cv + 1
        self._ready = {
            k: p for k, p in self._ready.items() if k > (view, cv)
        }

    def _count(self, view: int, primary_cv: int) -> bool:
        """Reference makeCommitmentCounter (commit.go:177-201): True when
        f commitments with CV ≥ primary_cv were already counted in this
        view (so with the current one the quorum is f+1)."""
        if view < self._counter_view:
            return False
        if view > self._counter_view:
            self._counter_view = view
            self._highest = [0] * self._f
        for i, cv in enumerate(self._highest):
            if primary_cv > cv:
                self._highest[i] = primary_cv
                return False
        return True

    async def collect(self, replica_id: int, prepare: Prepare) -> None:
        """Account one commitment by ``replica_id`` to ``prepare``; executes
        request(s) whose quorum completes.  Raises AuthenticationError for
        protocol violations (non-sequential CVs — reference
        commit.go:162-166)."""
        view = prepare.view
        primary_cv = prepare.ui.counter
        if getattr(prepare, "is_stub", False):
            # Defensive: stubs (checkpoint-covered digests) are captured
            # but never applied, so this cannot be reached through message
            # handling — executing one would let full-vs-stub encodings of
            # one UI diverge replicas.
            raise api.AuthenticationError("stub PREPARE cannot be committed")
        async with self._lock:
            base = self._view_base.get(view, 0)
            cur_view, last = self._accepted.get(replica_id, (view, base))
            if view < cur_view:
                return  # commitment from an abandoned view
            if view > cur_view:
                last = base  # new view: CV numbering restarts from its base
            if primary_cv <= last:
                return  # replayed commitment — already accounted
            if primary_cv != last + 1 and (view, primary_cv - 1) > (
                self._stable_view,
                self._stable_cv,
            ):
                raise api.AuthenticationError(
                    f"replica {replica_id} commitment skips CV "
                    f"{last + 1} -> {primary_cv} beyond the stable "
                    f"checkpoint"
                )
            self._accepted[replica_id] = (view, primary_cv)

            if not self._count(view, primary_cv):
                return
            ckey = (view, primary_cv)
            # The counter may report done again for stragglers of an
            # already-released quorum (it has no per-CV memory); the
            # in-order release watermark is the dedup.
            if (
                primary_cv < self._next_exec_cv.get(view, base + 1)
                or ckey in self._ready
            ):
                return
            self._ready[ckey] = prepare
        await self._drain(view)

    async def _drain(self, view: int) -> None:
        """Execute completed quorums strictly in primary-CV order.

        ``_exec_lock`` is held across ``deliver`` so a suspended execution
        (an actually-awaiting consumer) cannot be overtaken by a later CV
        whose quorum completes meanwhile — batched validation makes such
        reordering a real possibility, and hash-chained state machines
        diverge if two replicas execute in different orders."""
        async with self._exec_lock:
            while True:
                async with self._lock:
                    nxt = self._next_exec_cv.setdefault(
                        view, self._view_base.get(view, 0) + 1
                    )
                    prepare = self._ready.pop((view, nxt), None)
                    if prepare is not None:
                        self._next_exec_cv[view] = nxt + 1
                if prepare is None:
                    return
                # A batched prepare commits atomically: its requests execute
                # back-to-back in batch order on every replica.
                if self._trace_quorum is not None:
                    for req in prepare.requests:
                        self._trace_quorum(req)
                for req in prepare.requests:
                    await self._execute(req)
                if self._on_batch_end is not None:
                    await self._on_batch_end(view, prepare.ui.counter)


def make_commitment_collector(
    f: int, execute_request
) -> Callable[[int, Prepare], Awaitable[None]]:
    collector = CommitmentCollector(f, execute_request)

    async def collect_commitment(replica_id: int, prepare: Prepare) -> None:
        await collector.collect(replica_id, prepare)

    return collect_commitment
