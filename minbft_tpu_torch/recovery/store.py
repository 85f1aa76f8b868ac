"""Durable stable-checkpoint store: atomic persistence, paranoid load.

One small binary file per replica (per group under group mode) holds the
latest *stable* position: the f+1 checkpoint certificate, the application
snapshot it certifies, the client retire watermarks, and the replica's own
USIG counter watermark at that point.  Two failure modes get opposite
treatment on load:

- **Torn write** (crash mid-save): impossible for the committed file by
  construction — saves go through write-to-temp + fsync + ``os.replace`` +
  directory fsync, so the committed path always holds either the previous
  complete file or the new complete file.  A leftover ``*.tmp`` is the torn
  artifact; it is discarded unread, never trusted.
- **Corrupted committed file** (digest trailer mismatch, bad magic, wrong
  owner, garbage fields): :class:`CorruptStoreError`.  This is a *hard
  startup failure* — a committed file never legitimately fails its digest,
  so silently starting fresh would mask disk corruption or tampering and
  forfeit the durability the operator asked for with ``--state-dir``.

The store is a cache of *certified* state, not an authority: the loader
re-validates the embedded certificate and recomputes the composite
checkpoint digest against the snapshot before anything is installed
(core/message_handling.py ``restore_from_store``), exactly as if the bytes
had arrived from an untrusted peer.

Saves never regress: :meth:`DurableStore.save` refuses a state whose count
is below what the file already holds, so the persisted stable bound — and
with it the USIG watermark — is monotonic across crashes by construction
(checked end-to-end by ``testing/invariants.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import threading
from typing import Optional, Tuple

from ..messages import Checkpoint, CodecError, marshal, unmarshal

MAGIC = b"MBFTSTR1"
STATE_DIR_ENV = "MINBFT_STATE_DIR"

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_DIGEST_LEN = 32


class CorruptStoreError(Exception):
    """The committed store file failed validation.  Deliberately fatal at
    startup: rc != 0 with a clear message, never a silent fresh start."""


def state_dir_from_env(default: str = "") -> str:
    """Resolve the durable state directory: explicit value wins, else
    ``MINBFT_STATE_DIR``, else ``default`` (empty = durability off)."""
    return os.environ.get(STATE_DIR_ENV, "") or default


def store_path(state_dir: str, replica_id: int, group: Optional[int] = None) -> str:
    """Store file path for one replica: ``<dir>/replica<i>.state``, with a
    ``group<g>/`` subdirectory under group mode so per-group cores sharing a
    process never collide."""
    if group is not None:
        state_dir = os.path.join(state_dir, f"group{group}")
    return os.path.join(state_dir, f"replica{replica_id}.state")


@dataclasses.dataclass
class StableState:
    """One durable stable position — everything a restart needs to resume
    from the last checkpoint instead of counter zero."""

    count: int
    view: int
    cv: int
    usig_counter: int
    app_state: bytes
    watermarks: Tuple[Tuple[int, int], ...]
    cert: Tuple[Checkpoint, ...]


def _encode(replica_id: int, state: StableState) -> bytes:
    parts = [
        MAGIC,
        _U32.pack(replica_id),
        _U64.pack(state.count),
        _U64.pack(state.view),
        _U64.pack(state.cv),
        _U64.pack(state.usig_counter),
        _U64.pack(len(state.app_state)),
        state.app_state,
        _U32.pack(len(state.watermarks)),
    ]
    for client, seq in state.watermarks:
        parts.append(_U32.pack(client) + _U64.pack(seq))
    parts.append(_U32.pack(len(state.cert)))
    for cp in state.cert:
        raw = marshal(cp)
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    payload = b"".join(parts)
    return payload + hashlib.sha256(payload).digest()


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CorruptStoreError("durable store file is truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]


def _decode(replica_id: int, raw: bytes, path: str) -> StableState:
    if len(raw) < len(MAGIC) + _DIGEST_LEN:
        raise CorruptStoreError(f"durable store {path} is too short to be valid")
    payload, digest = raw[:-_DIGEST_LEN], raw[-_DIGEST_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        raise CorruptStoreError(
            f"durable store {path} failed its integrity digest "
            "(disk corruption or tampering — refusing to start fresh)"
        )
    r = _Reader(payload)
    if r.take(len(MAGIC)) != MAGIC:
        raise CorruptStoreError(f"durable store {path} has wrong magic")
    owner = r.u32()
    if owner != replica_id:
        raise CorruptStoreError(
            f"durable store {path} belongs to replica {owner}, not {replica_id}"
        )
    count, view, cv, usig = r.u64(), r.u64(), r.u64(), r.u64()
    app_state = bytes(r.take(r.u64()))
    watermarks = tuple((r.u32(), r.u64()) for _ in range(r.u32()))
    cert = []
    for _ in range(r.u32()):
        try:
            msg = unmarshal(bytes(r.take(r.u32())))
        except CodecError as exc:
            raise CorruptStoreError(
                f"durable store {path} holds an undecodable certificate entry: {exc}"
            ) from exc
        if not isinstance(msg, Checkpoint):
            raise CorruptStoreError(
                f"durable store {path} certificate entry is not a CHECKPOINT"
            )
        cert.append(msg)
    if r.pos != len(payload):
        raise CorruptStoreError(f"durable store {path} has trailing garbage")
    return StableState(
        count=count,
        view=view,
        cv=cv,
        usig_counter=usig,
        app_state=app_state,
        watermarks=watermarks,
        cert=tuple(cert),
    )


class DurableStore:
    """Atomic, digest-sealed persistence for one replica's stable state.

    ``save``/``load`` do blocking file IO by design — callers on the event
    loop wrap them in ``asyncio.to_thread`` (saves are off-path at
    checkpoint cadence; the single startup load happens before serving).
    Saves hold a lock: stable checkpoints that come faster than a save
    runs put several saves on worker threads at once, and unserialised
    they shared the one temp file (the later ``os.replace`` found it gone)
    and could each pass the count check, so a lower count could land
    last.  The reference's store has no lock.
    """

    def __init__(self, path: str, replica_id: int) -> None:
        self.path = path
        self.replica_id = replica_id
        self._last_count: Optional[int] = None
        self._save_lock = threading.Lock()

    def save(self, state: StableState) -> bool:
        """Persist ``state`` atomically.  Returns False (no write) when the
        file already holds an equal-or-newer stable count — the durable
        bound never regresses."""
        with self._save_lock:
            return self._save(state)

    def _save(self, state: StableState) -> bool:
        if self._last_count is None and os.path.exists(self.path):
            # First save of this process over an existing file: learn the
            # incumbent bound so a restarted replica that briefly lags its
            # own previous stable position cannot clobber it.
            try:
                incumbent = self.load()
                self._last_count = incumbent.count if incumbent else -1
            except CorruptStoreError:
                # Startup already vetted the file; mid-run corruption means
                # the disk is lying — overwriting with fresh certified
                # state is the best available move.
                self._last_count = -1
        if self._last_count is not None and state.count <= self._last_count:
            return False
        blob = _encode(self.replica_id, state)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, blob)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._last_count = state.count
        return True

    def load(self) -> Optional[StableState]:
        """Load the committed stable state.  Returns None when no committed
        file exists (fresh start); discards a leftover torn temp file;
        raises :class:`CorruptStoreError` when the committed file fails any
        validation."""
        tmp = self.path + ".tmp"
        if os.path.exists(tmp):
            # Torn write from a crash mid-save: the committed file (if any)
            # is the authoritative previous state.
            os.unlink(tmp)
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return None
        state = _decode(self.replica_id, raw, self.path)
        self._last_count = state.count
        return state
