"""Core helpers (reference core/utils.go:43-97)."""

from __future__ import annotations

import logging

from .. import api
from ..messages import (
    Busy,
    Checkpoint,
    Commit,
    Hello,
    Message,
    Prepare,
    ReqViewChange,
    Reply,
    Request,
    SnapshotReq,
    SnapshotResp,
    StateChunk,
    StateDone,
    StateReq,
)


def is_primary(view: int, replica_id: int, n: int) -> bool:
    """The primary for view v is replica v mod n (reference core/utils.go:80-82)."""
    return replica_id == view % n


def signing_role(msg: Message) -> api.AuthenticationRole:
    """Map a signed message kind to the key family that signs it
    (reference core/utils.go:43-72 message-type → role mapping)."""
    if isinstance(msg, Request):
        return api.AuthenticationRole.CLIENT
    if isinstance(
        msg,
        (
            Reply, Busy, ReqViewChange, Checkpoint, SnapshotReq,
            SnapshotResp, StateReq, StateChunk, StateDone, Hello,
        ),
    ):
        return api.AuthenticationRole.REPLICA
    raise TypeError(f"{type(msg).__name__} is not a signed message")


def certifying_role(msg: Message) -> api.AuthenticationRole:
    if isinstance(msg, (Prepare, Commit)):
        return api.AuthenticationRole.USIG
    raise TypeError(f"{type(msg).__name__} is not a certified message")


def make_logger(replica_id: int, level: int = logging.INFO) -> logging.Logger:
    """Per-replica logger (reference core/utils.go:84-97, options.go:25-58)."""
    logger = logging.getLogger(f"minbft.replica{replica_id}")
    logger.setLevel(level)
    return logger
