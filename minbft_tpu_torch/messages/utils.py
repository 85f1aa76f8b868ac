"""Diagnostic message rendering (reference messages/utils.go:25-63)."""

from __future__ import annotations

from .message import (
    Checkpoint,
    Commit,
    Hello,
    LogBase,
    Message,
    NewView,
    Prepare,
    ReqViewChange,
    Reply,
    Request,
    SnapshotReq,
    SnapshotResp,
    StateChunk,
    StateDone,
    StateReq,
    ViewChange,
)


def stringify(m: Message) -> str:
    if isinstance(m, Hello):
        return f"<HELLO replica={m.replica_id}>"
    if isinstance(m, Request):
        return f"<REQUEST client={m.client_id} seq={m.seq} op={len(m.operation)}B>"
    if isinstance(m, Reply):
        return (
            f"<REPLY replica={m.replica_id} client={m.client_id} "
            f"seq={m.seq} result={len(m.result)}B>"
        )
    if isinstance(m, Prepare):
        cv = m.ui.counter if m.ui else None
        if m.is_stub:
            return (
                f"<PREPARE-STUB cv={cv} replica={m.replica_id} "
                f"view={m.view} digest={m.requests_digest.hex()[:12]}>"
            )
        reqs = ", ".join(stringify(r) for r in m.requests)
        return (
            f"<PREPARE cv={cv} replica={m.replica_id} view={m.view} "
            f"requests=[{reqs}]>"
        )
    if isinstance(m, Commit):
        cv = m.ui.counter if m.ui else None
        return (
            f"<COMMIT cv={cv} replica={m.replica_id} "
            f"prepare={stringify(m.prepare)}>"
        )
    if isinstance(m, ReqViewChange):
        return f"<REQ-VIEW-CHANGE replica={m.replica_id} new_view={m.new_view}>"
    if isinstance(m, ViewChange):
        cv = m.ui.counter if m.ui else None
        return (
            f"<VIEW-CHANGE cv={cv} replica={m.replica_id} "
            f"new_view={m.new_view} log={len(m.log)}>"
        )
    if isinstance(m, NewView):
        cv = m.ui.counter if m.ui else None
        return (
            f"<NEW-VIEW cv={cv} replica={m.replica_id} "
            f"new_view={m.new_view} vcs={len(m.view_changes)}>"
        )
    if isinstance(m, Checkpoint):
        return (
            f"<CHECKPOINT replica={m.replica_id} count={m.count} "
            f"view={m.view} cv={m.cv} digest={m.digest.hex()[:12]}>"
        )
    if isinstance(m, LogBase):
        return (
            f"<LOG-BASE replica={m.replica_id} base={m.base} "
            f"cert={len(m.cert)}>"
        )
    if isinstance(m, SnapshotReq):
        return f"<SNAPSHOT-REQ replica={m.replica_id} count={m.count}>"
    if isinstance(m, SnapshotResp):
        return (
            f"<SNAPSHOT-RESP replica={m.replica_id} count={m.count} "
            f"view={m.view} cv={m.cv} state={len(m.app_state)}B>"
        )
    if isinstance(m, StateReq):
        return (
            f"<STATE-REQ replica={m.replica_id} count={m.count} "
            f"offset={m.offset}>"
        )
    if isinstance(m, StateChunk):
        return (
            f"<STATE-CHUNK replica={m.replica_id} count={m.count} "
            f"offset={m.offset}/{m.total} data={len(m.data)}B>"
        )
    if isinstance(m, StateDone):
        return (
            f"<STATE-DONE replica={m.replica_id} count={m.count} "
            f"view={m.view} cv={m.cv} total={m.total} cert={len(m.cert)}>"
        )
    return f"<{type(m).__name__}>"
