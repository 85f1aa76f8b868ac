"""Deterministic chunking and digest chaining for resumable state transfer.

The wire protocol (``STATE_REQ``/``STATE_CHUNK``/``STATE_DONE`` in
:mod:`minbft_tpu_torch.messages.message`) moves a stable application snapshot as a
sequence of fixed-size slices.  Two properties make the stream *resumable*
and *peer-switchable*:

- **Deterministic chunking.**  Every honest responder slices the same
  snapshot bytes into byte-identical chunks (fixed chunk size, offsets at
  multiples of it), so a requester that verified bytes ``[0, offset)`` from
  one peer can ask any other peer to continue from ``offset``.
- **Digest chaining.**  ``chain_k = sha256(chain_{k-1} || data_k)`` with an
  empty seed.  The responder recomputes the chain from byte zero even when
  serving a resume, so the carried chain commits to the *whole prefix*, not
  just the slice — a spliced or corrupted chunk is detected at the first
  bad slice instead of after the full download.  The chain is an early
  tripwire only; final authority is always the f+1 checkpoint certificate
  verified over the assembled snapshot before install.

The chunk size is a cluster-wide deployment constant (``chunk_bytes()``,
``MINBFT_RECOVERY_CHUNK_BYTES``): resume offsets are chunk-aligned by
construction, so mixing chunk sizes across peers degrades resume into
restart-from-zero via the normal failover path — safe, just wasteful.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Tuple

# Default 64 KiB: small enough that several chunks fit one 0xF0 multi-frame
# (MULTI_MAX_BYTES = 256 KiB) alongside its header, large enough that a
# megabyte-scale snapshot moves in tens of frames.
DEFAULT_CHUNK_BYTES = 64 * 1024
# Hard cap below MULTI_MAX_BYTES so one signed chunk always fits a frame.
MAX_CHUNK_BYTES = 128 * 1024
CHUNK_BYTES_ENV = "MINBFT_RECOVERY_CHUNK_BYTES"


def chunk_bytes() -> int:
    """State-transfer chunk size in bytes (``MINBFT_RECOVERY_CHUNK_BYTES``,
    default 64 KiB, clamped to [1, 128 KiB])."""
    raw = os.environ.get(CHUNK_BYTES_ENV, "")
    try:
        n = int(raw) if raw else DEFAULT_CHUNK_BYTES
    except ValueError:
        n = DEFAULT_CHUNK_BYTES
    return max(1, min(n, MAX_CHUNK_BYTES))


def chain_extend(chain: bytes, data: bytes) -> bytes:
    """One chain step: ``sha256(chain || data)``."""
    return hashlib.sha256(chain + data).digest()


def iter_chunks(data: bytes, size: int) -> Iterator[Tuple[int, bytes]]:
    """Yield ``(offset, slice)`` pairs covering ``data`` in ``size``-byte
    steps.  Empty data yields nothing (the stream is just its DONE frame)."""
    for off in range(0, len(data), size):
        yield off, data[off : off + size]


class ChainMismatch(Exception):
    """A chunk's carried chain digest does not extend the verified prefix —
    cross-stream splice, mid-stream tamper, or a responder whose snapshot
    diverges from the one the stream started with."""


class ChunkAssembler:
    """Reassembles one chunk stream, tolerating replayed prefixes.

    Reconnects replay unicast logs from their retained base (only
    *certified* entries honor ``Hello.resume_counter``), so after a
    connection reset the requester re-receives chunks it already verified.
    ``add`` ignores any chunk below the current offset (idempotent) and
    refuses gaps above it, so delivery order plus the chain digest force the
    buffer to grow monotonically and correctly.
    """

    def __init__(self, count: int) -> None:
        self.count = count
        self.total: int | None = None
        self.chain = b""
        self._buf = bytearray()

    @property
    def offset(self) -> int:
        """Verified byte count — the resume point for the next STATE-REQ."""
        return len(self._buf)

    @property
    def complete(self) -> bool:
        return self.total is not None and len(self._buf) == self.total

    def add(self, offset: int, total: int, data: bytes, chain: bytes) -> bool:
        """Append one chunk.  Returns True if it advanced the buffer, False
        for a stale replay (offset below the verified prefix) or a gap
        (offset ahead of it — wait for the in-order copy).  Raises
        :class:`ChainMismatch` when the carried chain does not extend the
        verified prefix, or when the claimed stream length shifts."""
        if self.total is None:
            self.total = total
        elif total != self.total:
            raise ChainMismatch(
                f"stream length changed mid-transfer: {self.total} -> {total}"
            )
        if offset != len(self._buf):
            return False
        expected = chain_extend(self.chain, data)
        if chain != expected:
            raise ChainMismatch(f"chain digest mismatch at offset {offset}")
        if len(self._buf) + len(data) > total:
            raise ChainMismatch(f"chunk at offset {offset} overruns total {total}")
        self._buf.extend(data)
        self.chain = expected
        return True

    def bytes(self) -> bytes:
        return bytes(self._buf)
