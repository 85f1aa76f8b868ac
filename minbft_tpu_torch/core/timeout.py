"""Failure detection: request-timeout → REQ-VIEW-CHANGE emission.

Reference core/timeout.go:32-72 and core/request.go:280-340: when a pending
request's timer expires, the replica demands view v+1 and broadcasts a
signed REQ-VIEW-CHANGE.  The reference stops there (processing is "Not
implemented", core/message-handling.go:419); this build goes beyond it —
f+1 demands start the full view-change protocol (core/viewchange.py).  The
prepare-timer fallback forwards the starved REQUEST to the primary via its
unicast log (reference core/request.go:315-324).
"""

from __future__ import annotations

from typing import Awaitable, Callable

from ..messages import ReqViewChange


def make_view_change_requestor(
    replica_id: int,
    view_state,
    sign_message,
    broadcast,
) -> Callable[[int], Awaitable[None]]:
    """Demand a view change (reference makeViewChangeRequestor,
    core/timeout.go:45-72): dedup via expectedView, emit signed
    REQ-VIEW-CHANGE."""

    async def request_view_change(new_view: int) -> None:
        if not await view_state.advance_expected_view(new_view):
            return  # already demanded (reference timeout.go:56-63)
        msg = ReqViewChange(replica_id=replica_id, new_view=new_view)
        sign_message(msg)
        broadcast(msg)

    return request_view_change


def make_request_timeout_handler(
    request_view_change,
) -> Callable[[int], Awaitable[None]]:
    """Reference makeRequestTimeoutHandler (core/timeout.go:32-40)."""

    async def handle_request_timeout(view: int) -> None:
        await request_view_change(view + 1)

    return handle_request_timeout
