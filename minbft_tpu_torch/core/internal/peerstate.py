"""Per-peer UI-counter capture: the protocol's sequencing backbone.

Reference core/internal/peerstate/peerstate.go:63-109: each peer's certified
messages must be processed **exactly once, in counter order**.  ``capture_ui``
returns False for an already-captured (replayed) counter value; if the
counter is ahead of the next expected value, it *waits* until the gap closes
(the reference blocks on a condvar).  ``release_ui`` is not needed —
capture itself advances the sequence exactly as the reference's
combined capture does when processing is strictly ordered; we keep the
two-phase capture/release shape anyway so a failed processing attempt can
retreat (reference returns a release closure).

Batching interplay: *verification* of a UI happens **before** capture
(stateless, batched on the GPU); capture/processing stays sequential per peer.
This is the ordering-vs-batching resolution from SURVEY.md §7.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional


class PeerState:
    def __init__(self):
        self._next_cv = 1  # USIG counters start at 1
        self._cond = asyncio.Condition()
        # cv -> monotonic time its capture started gap-parking.  A
        # parked capture means a LOWER counter never arrived — on a
        # faithful transport that only happens around a connection drop
        # (healed by the redial's HELLO replay), but a lossy/partitioned
        # link can drop a certified frame while the stream stays up, and
        # the gap then wedges every later message from this peer FOREVER
        # (the chaos soak's view-change livelock).  The dial loop
        # (message_handling.run_peer_connection) watches gap_stalled_for
        # and forces a redial when a gap persists with no progress.
        self._parked: Dict[int, float] = {}
        # Monotonic time the capture sequence last ADVANCED (a capture
        # applied or a LOG-BASE fast-forward landed).  gap_stalled_for
        # measures parked time from here, not from when the oldest
        # capture first parked: a redial's log replay heals a gap by
        # capturing hundreds of counters in order, and judging the new
        # stream by the OLD park timestamp would tear it down mid-replay
        # — before the replay reaches the gap — forever (a redial storm
        # the chaos soak hit live).
        self._last_advance = time.monotonic()

    async def capture_ui(self, cv: int) -> bool:
        """True once ``cv`` is ours to process (in order); False if ``cv``
        was already captured (duplicate/replayed message)."""
        async with self._cond:
            if cv > self._next_cv:
                self._parked.setdefault(cv, time.monotonic())
                try:
                    while cv > self._next_cv:
                        await self._cond.wait()
                finally:
                    self._parked.pop(cv, None)
            if cv < self._next_cv:
                return False
            self._next_cv += 1
            self._last_advance = time.monotonic()
            self._cond.notify_all()
            return True

    def next_expected(self) -> int:
        """The next UI counter this peer state will capture — everything
        below it is already captured and applied.  Stamped into the
        dialer's HELLO as ``resume_counter`` so a redial's log replay
        skips the captured prefix (plain read: all protocol code runs on
        one loop, and a stale-low read only costs extra replay)."""
        return self._next_cv

    def gap_stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds a capture gap has been parked with NO capture progress
        at all — 0.0 while nothing is parked OR while captures keep
        applying (a replay is actively healing the gap).  The redial
        watchdog keys on this, not on raw parked time (see
        ``_last_advance``)."""
        if not self._parked:
            return 0.0
        if now is None:
            now = time.monotonic()
        return max(0.0, now - max(min(self._parked.values()), self._last_advance))

    async def retreat_ui(self, cv: int) -> None:
        """Undo a capture after failed processing (rare; keeps the
        exactly-once promise intact for a retry)."""
        async with self._cond:
            if cv == self._next_cv - 1:
                self._next_cv = cv
            self._cond.notify_all()

    async def fast_forward(self, next_cv: int) -> None:
        """Jump the capture sequence ahead to ``next_cv`` (never back):
        the peer announced a checkpoint-certified LOG-BASE, so counters
        below it are intentionally absent from its log — waiting for them
        would wedge forever.  Wakes gap-parked captures (their counters
        become replays or ready, per the new base)."""
        async with self._cond:
            if next_cv > self._next_cv:
                self._next_cv = next_cv
                self._last_advance = time.monotonic()
            self._cond.notify_all()


class PeerStates:
    """Lazily-populated per-peer map (reference peerstate.go Provider)."""

    def __init__(self):
        self._peers: Dict[int, PeerState] = {}

    def peer(self, replica_id: int) -> PeerState:
        st = self._peers.get(replica_id)
        if st is None:
            st = PeerState()
            self._peers[replica_id] = st
        return st
