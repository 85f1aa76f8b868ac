"""Canonical authentication bytes.

Mirrors reference messages/authen.go:27-82: for each signable/certifiable
message kind, a canonical byte string over which its signature or USIG UI is
computed — a tag string, big-endian fixed-width fields, and SHA-256 digests of
variable-length payloads.

Key structural properties preserved from the reference:

- A PREPARE's authen bytes cover the embedded REQUEST (including the client's
  signature), so a UI on a PREPARE transitively authenticates the exact
  request bytes being ordered.
- A COMMIT's authen bytes include the **primary's UI counter**
  (reference messages/authen.go:70), binding the commitment to the exact slot
  the primary assigned.
- A message's own signature/UI is never part of its own authen bytes.

The 32-byte :func:`authen_digest` of these bytes is the unit of work shipped
to the TPU batch verifiers: every scheme in :mod:`minbft_tpu.ops` operates on
fixed-width digests so batch shapes stay static under ``jit``.
"""

from __future__ import annotations

import hashlib
import struct

from . import codec
from .message import (
    Busy,
    Checkpoint,
    Commit,
    Hello,
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

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def authen_bytes(m: Message) -> bytes:
    """Canonical bytes a signature / UI certificate for ``m`` covers
    (reference messages/authen.go:27-82).

    Memoized per message object: every field covered is final by the time
    the first caller needs these bytes (signatures/UIs are excluded from
    their own message's authen bytes; a COMMIT's embedded prepare already
    carries its UI when the COMMIT is constructed), and the same message is
    re-authenticated at several pipeline stages."""
    cached = m.__dict__.get("_authen_bytes")
    if cached is not None:
        return cached
    ab = _authen_bytes(m)
    m.__dict__["_authen_bytes"] = ab
    return ab


def _authen_bytes(m: Message) -> bytes:
    if isinstance(m, Request):
        # read_mode is covered: flipping it in flight would bypass
        # ordering (write→fast read), mutate state with a read
        # (read→write), or silently weaken a fast read's all-n quorum
        # (fast→ordered).
        return (
            b"REQUEST"
            + _U32.pack(m.client_id)
            + _U64.pack(m.seq)
            + bytes([m.read_mode])
            + _sha256(m.operation)
        )
    if isinstance(m, Reply):
        return (
            b"REPLY"
            + _U32.pack(m.replica_id)
            + _U32.pack(m.client_id)
            + _U64.pack(m.seq)
            + bytes([1 if m.read_only else 0])
            + bytes([1 if m.error else 0])
            + _sha256(m.result)
        )
    if isinstance(m, Busy):
        # retry_after_ms is covered: an adversary rewriting the hint could
        # inflate a client's backoff into starvation.
        return (
            b"BUSY"
            + _U32.pack(m.replica_id)
            + _U32.pack(m.client_id)
            + _U64.pack(m.seq)
            + _U32.pack(m.retry_after_ms)
        )
    if isinstance(m, Prepare):
        # Covers every embedded request *with* its client signature (in
        # batch order), so the primary's UI authenticates the exact bytes —
        # and the exact order — it proposed.  A checkpoint-covered *stub*
        # (requests dropped, digest carried) authenticates identically —
        # and since view sits here in the clear and the counter inside the
        # UI certificate, a stub's (view, cv) coverage claim is itself
        # USIG-authenticated.
        return (
            b"PREPARE"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.view)
            + collection_digest(m.requests, m.requests_digest)
        )
    if isinstance(m, Commit):
        if m.prepare.ui is None:
            raise ValueError("COMMIT authen bytes require the primary's UI")
        # Binds the commitment to the prepare's content AND the primary's
        # USIG counter value (reference messages/authen.go:70).
        return (
            b"COMMIT"
            + _U32.pack(m.replica_id)
            + _sha256(authen_bytes(m.prepare))
            + _U64.pack(m.prepare.ui.counter)
        )
    if isinstance(m, ReqViewChange):
        return b"REQ-VIEW-CHANGE" + _U32.pack(m.replica_id) + _U64.pack(m.new_view)
    if isinstance(m, ViewChange):
        # Covers every log entry *with* its UI (in counter order) plus the
        # truncation base: the sender's USIG certifies exactly this claimed
        # history starting at log_base+1.  The checkpoint certificate is
        # deliberately NOT covered — it is transferable third-party
        # evidence the validator checks independently (any f+1 matching
        # attestation with bounds >= log_base serves), so trimmed copies
        # may drop it.  A trimmed copy (empty log, digest carried)
        # authenticates identically, so the original certificate verifies
        # on it (see ViewChange doc).
        return (
            b"VIEW-CHANGE"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.new_view)
            + _U64.pack(m.log_base)
            + collection_digest(m.log, m.log_digest)
        )
    if isinstance(m, NewView):
        # Covers the f+1 embedded VIEW-CHANGEs with their UIs — the quorum
        # that deterministically defines the re-proposal set.
        return (
            b"NEW-VIEW"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.new_view)
            + collection_digest(m.view_changes, m.vcs_digest)
        )
    if isinstance(m, Checkpoint):
        h = hashlib.sha256()
        for p, b in m.bounds:
            h.update(_U32.pack(p) + _U64.pack(b))
        return (
            b"CHECKPOINT"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.count)
            + _U64.pack(m.view)
            + _U64.pack(m.cv)
            + _sha256(m.digest)
            + h.digest()
        )
    if isinstance(m, Hello):
        return b"HELLO" + _U32.pack(m.replica_id) + _U64.pack(m.resume_counter)
    if isinstance(m, SnapshotReq):
        return b"SNAPSHOT-REQ" + _U32.pack(m.replica_id) + _U64.pack(m.count)
    if isinstance(m, SnapshotResp):
        h = hashlib.sha256()
        for c, s in m.watermarks:
            h.update(_U32.pack(c) + _U64.pack(s))
        return (
            b"SNAPSHOT-RESP"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.count)
            + _U64.pack(m.view)
            + _U64.pack(m.cv)
            + _sha256(m.app_state)
            + h.digest()
        )
    if isinstance(m, StateReq):
        # The resume offset is covered (see StateReq doc): rewinding or
        # fast-forwarding it in flight must fail verification.
        return (
            b"STATE-REQ"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.count)
            + _U64.pack(m.offset)
        )
    if isinstance(m, StateChunk):
        # Covers the slice position, the stream length, the data, and the
        # running chain digest — a Byzantine responder cannot splice a
        # validly-signed chunk of one stream into another position.
        return (
            b"STATE-CHUNK"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.count)
            + _U64.pack(m.offset)
            + _U64.pack(m.total)
            + _sha256(m.data)
            + _sha256(m.chain)
        )
    if isinstance(m, StateDone):
        # The checkpoint certificate is deliberately NOT covered — like a
        # VIEW-CHANGE's, it is transferable third-party evidence the
        # receiver validates independently (any f+1 matching attestation
        # serves).
        h = hashlib.sha256()
        for c, s in m.watermarks:
            h.update(_U32.pack(c) + _U64.pack(s))
        return (
            b"STATE-DONE"
            + _U32.pack(m.replica_id)
            + _U64.pack(m.count)
            + _U64.pack(m.view)
            + _U64.pack(m.cv)
            + _U64.pack(m.total)
            + h.digest()
        )
    raise TypeError(f"{type(m).__name__} has no authen bytes")


def collection_digest(entries, carried: bytes) -> bytes:
    """Digest of a message collection, or the carried digest for a trimmed
    copy.  Non-empty collections are always recomputed — a mismatched
    carried digest on a full message simply fails certificate verification
    (both sides apply the same rule)."""
    if not entries:
        return carried if carried else _sha256(b"")
    h = hashlib.sha256()
    for entry in entries:
        h.update(codec.marshal(entry))
    return h.digest()


def authen_digest(m: Message) -> bytes:
    """SHA-256 of :func:`authen_bytes` — the fixed-width unit shipped to the
    TPU batch verifiers."""
    return _sha256(authen_bytes(m))
