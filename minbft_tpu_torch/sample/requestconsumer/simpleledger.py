"""SimpleLedger: a hash-chained block ledger as the sample state machine.

Reference sample/requestconsumer/simpleledger.go: one block per delivered
request, each block carrying the previous block's hash; ``state_digest`` is
the hash of the last block.  The reference runs a serial executor goroutine
over a queue (113-134); here delivery happens on the event loop, which is
already serial — the protocol's commitment collector releases executions in
order (minbft_tpu/core/commit.py).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional

from ... import api


class Block:
    def __init__(self, height: int, prev_hash: bytes, payload: bytes):
        self.height = height
        self.prev_hash = prev_hash
        self.payload = payload

    def digest(self) -> bytes:
        return hashlib.sha256(
            struct.pack(">Q", self.height) + self.prev_hash + self.payload
        ).digest()


class SimpleLedger(api.RequestConsumer):
    def __init__(self):
        genesis = Block(0, b"\x00" * 32, b"genesis")
        self._blocks: List[Block] = [genesis]

    async def deliver(self, operation: bytes) -> bytes:
        """Append one block per operation (reference simpleledger.go:168-187);
        the result returned to the client is the new block's digest."""
        prev = self._blocks[-1]
        block = Block(prev.height + 1, prev.digest(), operation)
        self._blocks.append(block)
        return block.digest()

    def state_digest(self) -> bytes:
        return self._blocks[-1].digest()

    async def query(self, operation: bytes) -> bytes:
        """Read-only operations (api.RequestConsumer.query contract:
        deterministic in committed state, since the client needs all n
        replies to match).  Supported ops:

        - ``b"head"`` (or anything unrecognized): chain height + head
          digest — "what is the current state?"
        - ``b"block:<height>"``: that block's digest, or empty bytes if
          out of range.
        """
        if operation.startswith(b"block:"):
            try:
                blk = self.block(int(operation[6:]))
            except ValueError:
                blk = None
            return blk.digest() if blk is not None else b""
        head = self._blocks[-1]
        return struct.pack(">Q", head.height) + head.digest()

    @property
    def length(self) -> int:
        """Number of blocks excluding genesis (reference ledger length
        assertions in core/integration_test.go:199-210)."""
        return len(self._blocks) - 1

    def block(self, height: int) -> Optional[Block]:
        return self._blocks[height] if 0 <= height < len(self._blocks) else None

    # -- checkpoint state transfer ------------------------------------------

    def snapshot(self) -> bytes:
        """Serialize the whole chain (sample-grade; a production state
        machine would snapshot compactly).  Round-trips through
        :meth:`install_snapshot` to an identical ``state_digest``."""
        out = [struct.pack(">I", len(self._blocks))]
        for b in self._blocks:
            out.append(
                struct.pack(">Q", b.height)
                + b.prev_hash
                + struct.pack(">I", len(b.payload))
                + b.payload
            )
        return b"".join(out)

    def snapshot_digest(self, data: bytes) -> bytes:
        """Digest the snapshot would produce once installed — parse and
        chain-verify without touching local state (api.RequestConsumer
        contract: lets state transfer check against a certified
        checkpoint digest before committing)."""
        return self._parse_and_verify(data)[-1].digest()

    def install_snapshot(self, data: bytes) -> None:
        """Parse and hash-chain-verify a snapshot, then swap atomically —
        the prior state survives any malformed/inconsistent payload."""
        self._blocks = self._parse_and_verify(data)

    def _parse_and_verify(self, data: bytes) -> List[Block]:
        try:
            (count,) = struct.unpack_from(">I", data, 0)
            off = 4
            blocks: List[Block] = []
            for _ in range(count):
                (height,) = struct.unpack_from(">Q", data, off)
                off += 8
                prev_hash = data[off : off + 32]
                if len(prev_hash) != 32:
                    raise ValueError("truncated prev_hash")
                off += 32
                (plen,) = struct.unpack_from(">I", data, off)
                off += 4
                payload = data[off : off + plen]
                if len(payload) != plen:
                    raise ValueError("truncated payload")
                off += plen
                blocks.append(Block(height, prev_hash, payload))
            if off != len(data):
                raise ValueError("trailing bytes")
        except struct.error as e:
            raise ValueError(f"malformed ledger snapshot: {e}") from e
        if not blocks:
            raise ValueError("empty ledger snapshot")
        for i, b in enumerate(blocks):
            if b.height != i:
                raise ValueError("non-sequential block heights")
            if i and b.prev_hash != blocks[i - 1].digest():
                raise ValueError("broken hash chain in snapshot")
        if blocks[0].prev_hash != b"\x00" * 32 or blocks[0].payload != b"genesis":
            raise ValueError("snapshot genesis mismatch")
        return blocks
