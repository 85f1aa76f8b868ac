"""Prepare pipeline (reference core/prepare.go).

Only the primary of the PREPARE's view may have produced it (reference
prepare.go:51-53); validation re-checks the embedded REQUEST's client
signature and the primary's UI — with the GPU authenticator, both checks
join the same verification batch via ``asyncio.gather``.  Applying a
PREPARE on a backup marks the request prepared, collects the primary's
commitment, and responds with an own COMMIT (reference prepare.go:69-94).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from .. import api
from ..messages import Commit, Prepare
from . import utils


def make_prepare_validator(
    n: int,
    validate_request,
    verify_ui,
) -> Callable[[Prepare], Awaitable[None]]:
    """Reference makePrepareValidator (core/prepare.go:46-65)."""

    async def validate_prepare(prepare: Prepare) -> None:
        if not utils.is_primary(prepare.view, prepare.replica_id, n):
            raise api.AuthenticationError(
                f"PREPARE from non-primary replica {prepare.replica_id} "
                f"in view {prepare.view}"
            )
        for r in prepare.requests:
            if r.is_fast_read:
                # The client signed this as UNORDERED: a primary batching
                # it would spend the client's seq on an ordering the
                # client never authorized.  (Ordered reads, read_mode=2,
                # batch fine — they execute via query at their slot.)
                raise api.AuthenticationError(
                    "PREPARE embeds a fast-read request"
                )
        # Client signatures on every embedded request + the primary's UI,
        # batched into one engine round (the reference does these serially,
        # prepare.go:55-61).
        results = await asyncio.gather(
            *[validate_request(r) for r in prepare.requests],
            verify_ui(prepare),
            return_exceptions=True,
        )
        ui_exc = results[-1]
        if isinstance(ui_exc, BaseException):
            raise ui_exc
        for exc in results[:-1]:
            if isinstance(exc, api.AuthenticationError):
                # UI valid, embedded request not: see
                # api.EmbeddedRequestAuthError — the handler demands a
                # view change rather than wedging on the counter gap.
                raise api.EmbeddedRequestAuthError(str(exc)) from exc
            if isinstance(exc, BaseException):
                raise exc

    return validate_prepare


def make_prepare_applier(
    replica_id: int,
    prepare_seq,
    collect_commitment,
    handle_generated,
    stop_prepare_timer,
    trace_prepare=None,
) -> Callable[[Prepare], Awaitable[None]]:
    """Reference makePrepareApplier (core/prepare.go:69-94).

    ``trace_prepare`` is the flight recorder's PREPARE capture point
    (obs/trace.py): noted when the batch is applied — on every replica,
    the primary included (its own PREPARE rides the own-message loop) —
    so the span is uniform cluster-wide.  None when tracing is off."""

    async def apply_prepare(prepare: Prepare) -> None:
        for req in prepare.requests:
            prepare_seq(req)
            stop_prepare_timer(req)
            if trace_prepare is not None:
                trace_prepare(req)
        await collect_commitment(prepare.replica_id, prepare)
        if prepare.replica_id != replica_id:
            # A backup commits to the accepted proposal
            # (reference prepare.go:90 NewCommit).
            await handle_generated(Commit(replica_id=replica_id, prepare=prepare))

    return apply_prepare
