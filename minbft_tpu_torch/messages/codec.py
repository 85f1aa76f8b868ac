"""Deterministic flat binary codec for protocol messages.

Replaces the reference's protobuf wire format (reference
messages/protobuf/pb/messages.proto:24-33, one ``Message`` wrapper with a
``oneof typed``) with a canonical hand-rolled layout:

    byte 0          kind tag
    then fields     big-endian fixed-width ints; bytes fields length-prefixed
                    with u32; embedded messages as length-prefixed marshalled
                    bytes.

Determinism is load-bearing: USIG certificates and signatures cover digests
of these exact bytes (see :mod:`minbft_tpu.messages.authen`), and protobuf
does not guarantee canonical serialization.  A flat codec is also much
cheaper to encode/decode on the host, which keeps the Python side of the
pipeline off the critical path while the TPU does the crypto.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

from .message import (
    CERTIFIED_MESSAGES,
    UI,
    Busy,
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

# Kind tags (wire stable).
_TAG_HELLO = 0x01
_TAG_REQUEST = 0x02
_TAG_REPLY = 0x03
_TAG_PREPARE = 0x04
_TAG_COMMIT = 0x05
_TAG_REQ_VIEW_CHANGE = 0x06
_TAG_VIEW_CHANGE = 0x07
_TAG_NEW_VIEW = 0x08
_TAG_CHECKPOINT = 0x09
_TAG_LOG_BASE = 0x0A
_TAG_SNAPSHOT_REQ = 0x0B
_TAG_SNAPSHOT_RESP = 0x0C
_TAG_BUSY = 0x0D
_TAG_STATE_REQ = 0x0E
_TAG_STATE_CHUNK = 0x0F
_TAG_STATE_DONE = 0x10
# Transport-level container: several messages coalesced into ONE stream
# frame (amortizes the per-frame gRPC/asyncio cost, which dominates the
# multi-process deployment's throughput on small hosts).  Deliberately far
# from the message tags — a multi frame is framing, not a message, and
# never nests.
_TAG_MULTI = 0xF0
# Transport-level group envelope (the multi-group runtime's demux tag,
# minbft_tpu/groups): [0xF1][u16 group id][inner frame].  Framing, not a
# message — it wraps exactly one message frame (or one multi container on
# the mux's physical hop), is stripped before decode, and NEVER nests.
# An untagged frame is group 0 by definition, so a single-group runtime's
# wire format is byte-identical to the ungrouped one.
_TAG_GROUP = 0xF1
_U16 = struct.Struct(">H")
GROUP_MAX = 0xFFFF

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


class CodecError(ValueError):
    pass


def _pack_u32(v: int) -> bytes:
    if not 0 <= v < 2**32:
        raise CodecError(f"u32 field out of range: {v}")
    return _U32.pack(v)


def _pack_u64(v: int) -> bytes:
    if not 0 <= v < 2**64:
        raise CodecError(f"u64 field out of range: {v}")
    return _U64.pack(v)


def _pack_bytes(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def _read_bytes(data: bytes, off: int) -> Tuple[bytes, int]:
    if off + 4 > len(data):
        raise CodecError("truncated length prefix")
    (n,) = _U32.unpack_from(data, off)
    off += 4
    if off + n > len(data):
        raise CodecError("truncated bytes field")
    return data[off : off + n], off + n


def _read_bounded_byte(
    data: bytes, off: int, bound: int, what: str
) -> Tuple[int, int]:
    """One strict bounded byte: values above ``bound`` are rejected so a
    message has exactly ONE encoding (determinism is load-bearing for
    signatures over marshaled bytes).  bound=1 decodes booleans; bound=2
    the Request read_mode (0 write / 1 fast read / 2 ordered read)."""
    if off + 1 > len(data):
        raise CodecError(f"truncated {what}")
    b = data[off]
    if b > bound:
        raise CodecError(f"invalid {what} byte")
    return b, off + 1


def _read_u32(data: bytes, off: int) -> Tuple[int, int]:
    if off + 4 > len(data):
        raise CodecError("truncated u32")
    return _U32.unpack_from(data, off)[0], off + 4


def _read_u64(data: bytes, off: int) -> Tuple[int, int]:
    if off + 8 > len(data):
        raise CodecError("truncated u64")
    return _U64.unpack_from(data, off)[0], off + 8


def _pack_ui(ui) -> bytes:
    if ui is None:
        return _pack_bytes(b"")
    try:
        return _pack_bytes(ui.to_bytes())
    except OverflowError as e:
        raise CodecError(f"UI counter out of range: {e}") from e


def _parse_ui(uib: bytes):
    if not uib:
        return None
    try:
        return UI.from_bytes(uib)
    except ValueError as e:
        raise CodecError(f"malformed UI: {e}") from e


def marshal(m: Message) -> bytes:
    """Serialize a message to canonical bytes
    (reference messages/protobuf/impl.go:87-107 equivalent)."""
    if isinstance(m, Hello):
        return (
            bytes([_TAG_HELLO])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.resume_counter)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, Request):
        return (
            bytes([_TAG_REQUEST])
            + _pack_u32(m.client_id)
            + _pack_u64(m.seq)
            + bytes([m.read_mode])
            + _pack_bytes(m.operation)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, Reply):
        return (
            bytes([_TAG_REPLY])
            + _pack_u32(m.replica_id)
            + _pack_u32(m.client_id)
            + _pack_u64(m.seq)
            + bytes([1 if m.read_only else 0])
            + bytes([1 if m.error else 0])
            + _pack_bytes(m.result)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, Busy):
        return (
            bytes([_TAG_BUSY])
            + _pack_u32(m.replica_id)
            + _pack_u32(m.client_id)
            + _pack_u64(m.seq)
            + _pack_u32(m.retry_after_ms)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, Prepare):
        return (
            bytes([_TAG_PREPARE])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.view)
            + _pack_u32(len(m.requests))
            + b"".join(_pack_bytes(marshal(r)) for r in m.requests)
            + _pack_bytes(m.requests_digest)
            + _pack_ui(m.ui)
        )
    if isinstance(m, Commit):
        return (
            bytes([_TAG_COMMIT])
            + _pack_u32(m.replica_id)
            + _pack_bytes(marshal(m.prepare))
            + _pack_ui(m.ui)
        )
    if isinstance(m, ReqViewChange):
        return (
            bytes([_TAG_REQ_VIEW_CHANGE])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.new_view)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, ViewChange):
        return (
            bytes([_TAG_VIEW_CHANGE])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.new_view)
            + _pack_u32(len(m.log))
            + b"".join(_pack_bytes(marshal(e)) for e in m.log)
            + _pack_bytes(m.log_digest)
            + _pack_u64(m.log_base)
            + _pack_u32(len(m.checkpoint_cert))
            + b"".join(_pack_bytes(marshal(c)) for c in m.checkpoint_cert)
            + _pack_ui(m.ui)
        )
    if isinstance(m, NewView):
        return (
            bytes([_TAG_NEW_VIEW])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.new_view)
            + _pack_u32(len(m.view_changes))
            + b"".join(_pack_bytes(marshal(vc)) for vc in m.view_changes)
            + _pack_bytes(m.vcs_digest)
            + _pack_ui(m.ui)
        )
    if isinstance(m, Checkpoint):
        return (
            bytes([_TAG_CHECKPOINT])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_bytes(m.digest)
            + _pack_u64(m.view)
            + _pack_u64(m.cv)
            + _pack_u32(len(m.bounds))
            + b"".join(_pack_u32(p) + _pack_u64(b) for p, b in m.bounds)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, LogBase):
        return (
            bytes([_TAG_LOG_BASE])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.base)
            + _pack_u32(len(m.cert))
            + b"".join(_pack_bytes(marshal(c)) for c in m.cert)
        )
    if isinstance(m, SnapshotReq):
        return (
            bytes([_TAG_SNAPSHOT_REQ])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, SnapshotResp):
        return (
            bytes([_TAG_SNAPSHOT_RESP])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_u64(m.view)
            + _pack_u64(m.cv)
            + _pack_bytes(m.app_state)
            + _pack_u32(len(m.watermarks))
            + b"".join(_pack_u32(c) + _pack_u64(s) for c, s in m.watermarks)
            + _pack_u32(len(m.cert))
            + b"".join(_pack_bytes(marshal(c)) for c in m.cert)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, StateReq):
        return (
            bytes([_TAG_STATE_REQ])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_u64(m.offset)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, StateChunk):
        return (
            bytes([_TAG_STATE_CHUNK])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_u64(m.offset)
            + _pack_u64(m.total)
            + _pack_bytes(m.data)
            + _pack_bytes(m.chain)
            + _pack_bytes(m.signature)
        )
    if isinstance(m, StateDone):
        return (
            bytes([_TAG_STATE_DONE])
            + _pack_u32(m.replica_id)
            + _pack_u64(m.count)
            + _pack_u64(m.view)
            + _pack_u64(m.cv)
            + _pack_u64(m.total)
            + _pack_u32(len(m.watermarks))
            + b"".join(_pack_u32(c) + _pack_u64(s) for c, s in m.watermarks)
            + _pack_u32(len(m.cert))
            + b"".join(_pack_bytes(marshal(c)) for c in m.cert)
            + _pack_bytes(m.signature)
        )
    raise CodecError(f"unknown message type {type(m)!r}")


# Decode interning: the same REQUEST bytes arrive once from the client and
# again embedded in the PREPARE and in every COMMIT (which embeds the full
# PREPARE) — on a receiving replica that's ~n parses of identical bytes per
# message.  Interning by exact wire bytes collapses them to one parse, and
# the shared object also shares its authen-bytes/marshal memos.  Safe
# because received messages' protocol *fields* are never mutated
# (signatures/UIs are assigned only to own generated messages,
# pre-serialization); the only writes to a shared object are idempotent
# memo attributes (_authen_bytes, _wire_bytes, and the token-keyed
# _validated_by set from core/message_handling.py).  LRU bounded by
# *accumulated key bytes*, not entry count: a batched PREPARE's wire bytes
# are O(batch * request size), so an entry-count cap could retain hundreds
# of MB.
#
# Two documented assumptions (deliberate trade-offs, not invariants):
# - The cache is populated with PRE-authentication bytes, so a peer or
#   client flooding distinct REQUEST/PREPARE wire bytes fills the LRU with
#   junk and evicts the hot legitimate entries.  That degrades the
#   parse/dedup amortization (perf only — correctness never depends on an
#   intern hit); interning post-validation would shrink the attack surface
#   at the cost of the first-parse dedup that the n-replica fan-in relies
#   on.
# - Access is assumed single-threaded on one asyncio event loop (true for
#   grpc.aio and the in-process connector); the OrderedDict is not locked.
_INTERN_MAX_BYTES = 32 * 1024 * 1024
_intern: "OrderedDict[bytes, Message]" = OrderedDict()
_intern_bytes = 0
_INTERNABLE = (_TAG_REQUEST, _TAG_PREPARE)


# Deepest legitimate embedding: NEW-VIEW → VIEW-CHANGE → COMMIT → PREPARE
# → REQUEST = 5 levels; the cap rejects crafted self-nesting (a ~15KB
# message of VIEW-CHANGE-in-VIEW-CHANGE would otherwise blow the Python
# recursion limit before any authentication, and RecursionError is not a
# CodecError — peers would misclassify it as a local internal bug).
_MAX_NESTING = 8


def unmarshal(data: bytes, _depth: int = 0) -> Message:
    """Parse canonical bytes back into a typed message
    (reference messages.MessageImpl.NewFromBinary, messages/api.go:26)."""
    global _intern_bytes
    if _depth > _MAX_NESTING:
        raise CodecError("message nesting too deep")
    if data and data[0] in _INTERNABLE:
        m = _intern.get(data)
        if m is not None:
            _intern.move_to_end(data)
            return m
    m, off = _unmarshal_at(data, 0, _depth)
    if off != len(data):
        raise CodecError("trailing bytes after message")
    if data[0] in _INTERNABLE and len(data) < _INTERN_MAX_BYTES // 4:
        _intern[data] = m
        _intern_bytes += len(data)
        while _intern_bytes > _INTERN_MAX_BYTES:
            evicted, _ = _intern.popitem(last=False)
            _intern_bytes -= len(evicted)
    return m


def _unmarshal_at(data: bytes, off: int, depth: int = 0) -> Tuple[Message, int]:
    if off >= len(data):
        raise CodecError("empty message")
    tag = data[off]
    off += 1
    if tag == _TAG_HELLO:
        rid, off = _read_u32(data, off)
        resume, off = _read_u64(data, off)
        sig, off = _read_bytes(data, off)
        return Hello(replica_id=rid, signature=sig, resume_counter=resume), off
    if tag == _TAG_REQUEST:
        cid, off = _read_u32(data, off)
        seq, off = _read_u64(data, off)
        mode, off = _read_bounded_byte(data, off, 2, "read_mode")
        op, off = _read_bytes(data, off)
        sig, off = _read_bytes(data, off)
        return (
            Request(
                client_id=cid, seq=seq, operation=op, signature=sig, read_mode=mode
            ),
            off,
        )
    if tag == _TAG_REPLY:
        rid, off = _read_u32(data, off)
        cid, off = _read_u32(data, off)
        seq, off = _read_u64(data, off)
        rb, off = _read_bounded_byte(data, off, 1, "read_only flag")
        eb, off = _read_bounded_byte(data, off, 1, "error flag")
        result, off = _read_bytes(data, off)
        sig, off = _read_bytes(data, off)
        return (
            Reply(
                replica_id=rid,
                client_id=cid,
                seq=seq,
                result=result,
                signature=sig,
                read_only=bool(rb),
                error=bool(eb),
            ),
            off,
        )
    if tag == _TAG_BUSY:
        rid, off = _read_u32(data, off)
        cid, off = _read_u32(data, off)
        seq, off = _read_u64(data, off)
        retry, off = _read_u32(data, off)
        sig, off = _read_bytes(data, off)
        return (
            Busy(
                replica_id=rid,
                client_id=cid,
                seq=seq,
                retry_after_ms=retry,
                signature=sig,
            ),
            off,
        )
    if tag == _TAG_PREPARE:
        rid, off = _read_u32(data, off)
        view, off = _read_u64(data, off)
        count, off = _read_u32(data, off)
        reqs = []
        for _ in range(count):
            reqb, off = _read_bytes(data, off)
            req = unmarshal(reqb, depth + 1)
            if not isinstance(req, Request):
                raise CodecError("PREPARE must embed REQUESTs")
            reqs.append(req)
        rdig, off = _read_bytes(data, off)
        if count == 0 and not rdig:
            raise CodecError(
                "PREPARE must embed at least one REQUEST or a stub digest"
            )
        uib, off = _read_bytes(data, off)
        ui = _parse_ui(uib)
        return (
            Prepare(
                replica_id=rid, view=view, requests=reqs, ui=ui,
                requests_digest=rdig,
            ),
            off,
        )
    if tag == _TAG_COMMIT:
        rid, off = _read_u32(data, off)
        prepb, off = _read_bytes(data, off)
        uib, off = _read_bytes(data, off)
        prep = unmarshal(prepb, depth + 1)
        if not isinstance(prep, Prepare):
            raise CodecError("COMMIT must embed a PREPARE")
        ui = _parse_ui(uib)
        return Commit(replica_id=rid, prepare=prep, ui=ui), off
    if tag == _TAG_REQ_VIEW_CHANGE:
        rid, off = _read_u32(data, off)
        nv, off = _read_u64(data, off)
        sig, off = _read_bytes(data, off)
        return ReqViewChange(replica_id=rid, new_view=nv, signature=sig), off
    if tag == _TAG_VIEW_CHANGE:
        rid, off = _read_u32(data, off)
        nv, off = _read_u64(data, off)
        count, off = _read_u32(data, off)
        entries = []
        for _ in range(count):
            eb, off = _read_bytes(data, off)
            entry = unmarshal(eb, depth + 1)
            if not isinstance(entry, CERTIFIED_MESSAGES):
                raise CodecError("VIEW-CHANGE log entries must be certified")
            entries.append(entry)
        digest, off = _read_bytes(data, off)
        base, off = _read_u64(data, off)
        ccount, off = _read_u32(data, off)
        cert = []
        for _ in range(ccount):
            cb, off = _read_bytes(data, off)
            cp = unmarshal(cb, depth + 1)
            if not isinstance(cp, Checkpoint):
                raise CodecError("VIEW-CHANGE cert entries must be CHECKPOINTs")
            cert.append(cp)
        uib, off = _read_bytes(data, off)
        return (
            ViewChange(
                replica_id=rid, new_view=nv, log=tuple(entries),
                ui=_parse_ui(uib), log_digest=digest,
                log_base=base, checkpoint_cert=tuple(cert),
            ),
            off,
        )
    if tag == _TAG_NEW_VIEW:
        rid, off = _read_u32(data, off)
        nv, off = _read_u64(data, off)
        count, off = _read_u32(data, off)
        vcs = []
        for _ in range(count):
            vcb, off = _read_bytes(data, off)
            vc = unmarshal(vcb, depth + 1)
            if not isinstance(vc, ViewChange):
                raise CodecError("NEW-VIEW must embed VIEW-CHANGEs")
            vcs.append(vc)
        digest, off = _read_bytes(data, off)
        uib, off = _read_bytes(data, off)
        return (
            NewView(
                replica_id=rid, new_view=nv, view_changes=tuple(vcs),
                ui=_parse_ui(uib), vcs_digest=digest,
            ),
            off,
        )
    if tag == _TAG_CHECKPOINT:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        digest, off = _read_bytes(data, off)
        view, off = _read_u64(data, off)
        cv, off = _read_u64(data, off)
        bcount, off = _read_u32(data, off)
        bounds = []
        for _ in range(bcount):
            p, off = _read_u32(data, off)
            b, off = _read_u64(data, off)
            bounds.append((p, b))
        sig, off = _read_bytes(data, off)
        return (
            Checkpoint(
                replica_id=rid, count=count, digest=digest, view=view,
                cv=cv, bounds=tuple(bounds), signature=sig,
            ),
            off,
        )
    if tag == _TAG_LOG_BASE:
        rid, off = _read_u32(data, off)
        base, off = _read_u64(data, off)
        ccount, off = _read_u32(data, off)
        cert = []
        for _ in range(ccount):
            cb, off = _read_bytes(data, off)
            cp = unmarshal(cb, depth + 1)
            if not isinstance(cp, Checkpoint):
                raise CodecError("LOG-BASE cert entries must be CHECKPOINTs")
            cert.append(cp)
        return LogBase(replica_id=rid, base=base, cert=tuple(cert)), off
    if tag == _TAG_SNAPSHOT_REQ:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        sig, off = _read_bytes(data, off)
        return SnapshotReq(replica_id=rid, count=count, signature=sig), off
    if tag == _TAG_SNAPSHOT_RESP:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        view, off = _read_u64(data, off)
        cv, off = _read_u64(data, off)
        app, off = _read_bytes(data, off)
        wcount, off = _read_u32(data, off)
        marks = []
        for _ in range(wcount):
            c, off = _read_u32(data, off)
            s, off = _read_u64(data, off)
            marks.append((c, s))
        ccount, off = _read_u32(data, off)
        cert = []
        for _ in range(ccount):
            cb, off = _read_bytes(data, off)
            cp = unmarshal(cb, depth + 1)
            if not isinstance(cp, Checkpoint):
                raise CodecError("SNAPSHOT-RESP cert entries must be CHECKPOINTs")
            cert.append(cp)
        sig, off = _read_bytes(data, off)
        return (
            SnapshotResp(
                replica_id=rid, count=count, view=view, cv=cv,
                app_state=app, watermarks=tuple(marks), cert=tuple(cert),
                signature=sig,
            ),
            off,
        )
    if tag == _TAG_STATE_REQ:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        soff, off = _read_u64(data, off)
        sig, off = _read_bytes(data, off)
        return (
            StateReq(replica_id=rid, count=count, offset=soff, signature=sig),
            off,
        )
    if tag == _TAG_STATE_CHUNK:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        soff, off = _read_u64(data, off)
        total, off = _read_u64(data, off)
        chunk, off = _read_bytes(data, off)
        chain, off = _read_bytes(data, off)
        sig, off = _read_bytes(data, off)
        return (
            StateChunk(
                replica_id=rid, count=count, offset=soff, total=total,
                data=chunk, chain=chain, signature=sig,
            ),
            off,
        )
    if tag == _TAG_STATE_DONE:
        rid, off = _read_u32(data, off)
        count, off = _read_u64(data, off)
        view, off = _read_u64(data, off)
        cv, off = _read_u64(data, off)
        total, off = _read_u64(data, off)
        wcount, off = _read_u32(data, off)
        marks = []
        for _ in range(wcount):
            c, off = _read_u32(data, off)
            s, off = _read_u64(data, off)
            marks.append((c, s))
        ccount, off = _read_u32(data, off)
        cert = []
        for _ in range(ccount):
            cb, off = _read_bytes(data, off)
            cp = unmarshal(cb, depth + 1)
            if not isinstance(cp, Checkpoint):
                raise CodecError("STATE-DONE cert entries must be CHECKPOINTs")
            cert.append(cp)
        sig, off = _read_bytes(data, off)
        return (
            StateDone(
                replica_id=rid, count=count, view=view, cv=cv, total=total,
                watermarks=tuple(marks), cert=tuple(cert), signature=sig,
            ),
            off,
        )
    raise CodecError(f"unknown message tag {tag:#x}")


# ---------------------------------------------------------------------------
# Vectorized bundle decode (the batch-ingest runtime's codec stage).


def _intern_put(data: bytes, m: Message) -> None:
    """Insert one decoded message into the intern LRU with the same
    accumulated-bytes accounting as :func:`unmarshal`."""
    global _intern_bytes
    if len(data) >= _INTERN_MAX_BYTES // 4:
        return
    _intern[data] = m
    _intern_bytes += len(data)
    while _intern_bytes > _INTERN_MAX_BYTES:
        evicted, _ = _intern.popitem(last=False)
        _intern_bytes -= len(evicted)


def _decode_one(data: bytes):
    """Item-wise decode: a malformed frame becomes its CodecError VALUE
    (never raised), so one corrupt frame cannot poison a bundle."""
    try:
        return unmarshal(data)
    except CodecError as e:
        return e


# Below this many frames the numpy set-up costs more than it saves
# (measured on the dev container: 0.94x at 32 frames, 1.6x at 128); the
# scalar loop is the same item-wise contract either way.
_BATCH_MIN = 48
# Fixed REQUEST header: tag(1) + client u32 + seq u64 + mode(1) + oplen
# u32 + siglen u32 — the minimum well-formed REQUEST frame (empty op and
# empty signature).
_REQ_FIXED = 22


def _gather_be(arr: np.ndarray, offs: np.ndarray, width: int) -> np.ndarray:
    """Big-endian integer fields at per-frame offsets: ``width`` byte
    gathers composed into one uint64 column (the flat codec's fixed-width
    fields ARE contiguous bytes, so a field across the whole bundle is
    ``width`` fancy-indexed loads)."""
    v = np.zeros(len(offs), dtype=np.uint64)
    for k in range(width):
        v = (v << np.uint64(8)) | arr[offs + k].astype(np.uint64)
    return v


def unmarshal_batch(frames) -> List[object]:
    """Decode a bundle of flat wire frames, item-wise.

    Returns one entry per frame: the decoded :class:`Message`, or the
    :class:`CodecError` that frame produced (errors are VALUES here —
    a corrupt frame fails alone, never the bundle).

    The hot kind is vectorized: frames are classified by tag with one
    numpy gather over the concatenated bundle, and REQUEST frames — the
    client-stream hot path — have their fixed-width fields (client id,
    seq, read mode, length prefixes) extracted as whole-bundle array
    operations; only the final per-object construction is Python.  Any
    frame the vector checks cannot fully validate falls back to the
    scalar :func:`unmarshal`, so the two paths can never disagree on
    accept/reject (tests/test_batch_ingest.py pins this differentially).
    Interning semantics match :func:`unmarshal` exactly.
    """
    n = len(frames)
    if n < _BATCH_MIN:
        return [_decode_one(fr) for fr in frames]
    out: List[object] = [None] * n
    # Intern hits first (the n-replica fan-in makes these common), and
    # collect the rest for classification.  Duplicate internable frames
    # WITHIN the bundle collapse to one decode too — the scalar loop gets
    # that for free (frame k populates the intern frame k+1 hits), so the
    # batch path must match it or retransmit-heavy bundles decode twice.
    todo: List[int] = []
    first_seen: dict = {}
    dups: List[Tuple[int, int]] = []
    for i, fr in enumerate(frames):
        if fr and fr[0] in _INTERNABLE:
            m = _intern.get(fr)
            if m is not None:
                _intern.move_to_end(fr)
                out[i] = m
                continue
            j = first_seen.get(fr)
            if j is not None:
                dups.append((i, j))
                continue
            first_seen[fr] = i
        todo.append(i)
    if not todo:
        return out
    lens = np.fromiter((len(frames[i]) for i in todo), dtype=np.int64, count=len(todo))
    # Pad the tail so fixed-header gathers on a truncated LAST frame stay
    # in-bounds (their rows are discarded by the validity mask anyway).
    buf = b"".join([frames[i] for i in todo] + [b"\x00" * (_REQ_FIXED + 4)])
    arr = np.frombuffer(buf, dtype=np.uint8)
    offs = np.zeros(len(todo), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    ends = offs + lens
    tags = np.where(lens > 0, arr[offs], -1)
    req_rows = np.nonzero((tags == _TAG_REQUEST) & (lens >= _REQ_FIXED))[0]
    vectored = np.zeros(len(todo), dtype=bool)
    if len(req_rows):
        base = offs[req_rows]
        end = ends[req_rows]
        cid = _gather_be(arr, base + 1, 4)
        seq = _gather_be(arr, base + 5, 8)
        mode = arr[base + 13].astype(np.int64)
        oplen = _gather_be(arr, base + 14, 4).astype(np.int64)
        op_end = base + 18 + oplen
        fits = (op_end + 4 <= end) & (mode <= 2)
        # Clamp the variable-offset gather to a row's own base when the
        # operation length already overruns — the row is discarded, the
        # gather just has to stay in-bounds.
        sig_at = np.where(fits, op_end, base)
        siglen = _gather_be(arr, sig_at, 4).astype(np.int64)
        ok = fits & (op_end + 4 + siglen == end)
        ok_rows = req_rows[ok]
        vectored[ok_rows] = True
        cid_l = cid[ok].tolist()
        seq_l = seq[ok].tolist()
        mode_l = mode[ok].tolist()
        op0_l = (base[ok] + 18).tolist()
        ope_l = op_end[ok].tolist()
        end_l = end[ok].tolist()
        for j, row in enumerate(ok_rows.tolist()):
            i = todo[row]
            ope = ope_l[j]
            m = Request(
                client_id=cid_l[j],
                seq=seq_l[j],
                operation=buf[op0_l[j] : ope],
                signature=buf[ope + 4 : end_l[j]],
                read_mode=mode_l[j],
            )
            out[i] = m
            _intern_put(frames[i], m)
    # Everything the vector path did not fully validate — other kinds,
    # short/overrun/trailing-byte REQUESTs — takes the scalar decoder so
    # malformed frames produce their exact per-item CodecError.
    for row in np.nonzero(~vectored)[0].tolist():
        i = todo[row]
        out[i] = _decode_one(frames[i])
    for i, j in dups:
        out[i] = out[j]
    return out


def pack_multi(frames) -> bytes:
    """Coalesce several wire frames into one transport frame (len==1 stays
    bare — the container only exists to amortize per-frame stream costs)."""
    if len(frames) == 1:
        return frames[0]
    out = [bytes([_TAG_MULTI]), _pack_u32(len(frames))]
    for fr in frames:
        out.append(_pack_u32(len(fr)))
        out.append(fr)
    return b"".join(out)


def split_multi(data: bytes):
    """Inverse of :func:`pack_multi`: a bare frame comes back as [data];
    a container is split into its messages (malformed containers raise
    CodecError like any bad wire bytes)."""
    if not data or data[0] != _TAG_MULTI:
        return [data]
    n, off = _read_u32(data, 1)
    if n > 65536:
        raise CodecError(f"multi frame claims {n} messages")
    frames = []
    for _ in range(n):
        ln, off = _read_u32(data, off)
        if off + ln > len(data):
            raise CodecError("truncated multi frame")
        frames.append(data[off : off + ln])
        off += ln
    if off != len(data):
        raise CodecError("trailing bytes in multi frame")
    return frames


def pack_group(gid: int, frame: bytes) -> bytes:
    """Wrap one wire frame in the group envelope.  Group 0 stays BARE —
    the untagged encoding IS group 0 (single-group wire compatibility),
    and keeping one canonical encoding per (gid, frame) means the demux
    never has to dedup tagged-vs-untagged spellings of the same frame."""
    if gid == 0:
        return frame
    if not 0 < gid <= GROUP_MAX:
        raise CodecError(f"group id out of range: {gid}")
    return bytes([_TAG_GROUP]) + _U16.pack(gid) + frame


def split_group(frame: bytes):
    """Inverse of :func:`pack_group`: ``(gid, inner frame)``.  Untagged
    frames are group 0; a truncated envelope raises like any bad wire
    bytes."""
    if not frame or frame[0] != _TAG_GROUP:
        return 0, frame
    if len(frame) < 3:
        raise CodecError("truncated group envelope")
    return _U16.unpack_from(frame, 1)[0], frame[3:]


def split_group_batch(frames):
    """Whole-bundle group demux: ``[(gid, inner), ...]`` — the grouped
    ingest tick's classification stage.  Large bundles classify the
    envelope tag with one numpy gather over the concatenated frames
    (the same trick :func:`unmarshal_batch` uses for message tags);
    malformed envelopes become item-wise ``CodecError`` VALUES in the
    gid slot (``(err, frame)``) so one bad frame cannot poison the
    bundle."""
    n = len(frames)
    out = []
    if n < _BATCH_MIN:
        for fr in frames:
            try:
                out.append(split_group(fr))
            except CodecError as e:
                out.append((e, fr))
        return out
    lens = np.fromiter((len(fr) for fr in frames), dtype=np.int64, count=n)
    buf = b"".join(frames) + b"\x00" * 3
    arr = np.frombuffer(buf, dtype=np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    tags = np.where(lens > 0, arr[offs], -1)
    grouped = tags == _TAG_GROUP
    gids = np.where(
        grouped & (lens >= 3), _gather_be(arr, offs + 1, 2), 0
    ).astype(np.int64)
    grouped_l = grouped.tolist()
    gids_l = gids.tolist()
    lens_l = lens.tolist()
    for i, fr in enumerate(frames):
        if not grouped_l[i]:
            out.append((0, fr))
        elif lens_l[i] < 3:
            out.append((CodecError("truncated group envelope"), fr))
        else:
            out.append((gids_l[i], fr[3:]))
    return out


# Coalescing bounds shared by every stream pump: one frame can neither
# starve its stream (message count) nor trip gRPC's 4MB default (bytes).
MULTI_MAX_MSGS = 128
MULTI_MAX_BYTES = 256 * 1024


def drain_multi(first: bytes, queue, encode=None, stop=None):
    """Coalesce ``first`` plus whatever is ALREADY queued into one packed
    frame -> (frame, saw_stop).  ``encode`` maps queue items to wire bytes
    (identity by default); ``stop`` is an optional sentinel that ends the
    drain and is reported instead of being packed.  Never blocks — only
    items reachable via ``get_nowait`` ride along."""
    frames = [first]
    total = len(first)
    saw_stop = False
    while (
        len(frames) < MULTI_MAX_MSGS
        and total < MULTI_MAX_BYTES
        and not queue.empty()
    ):
        item = queue.get_nowait()
        if stop is not None and item is stop:
            saw_stop = True
            break
        fr = encode(item) if encode is not None else item
        frames.append(fr)
        total += len(fr)
    return pack_multi(frames), saw_stop
