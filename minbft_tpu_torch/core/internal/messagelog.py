"""Append-only message log with multi-subscriber replay streams and
checkpoint truncation.

Reference core/internal/messagelog/messagelog.go:40-109: ``append`` never
blocks; each ``stream()`` first replays everything logged so far, then
follows new appends until the ``done`` event is set (or the consuming task
is cancelled).  Used for the broadcast log (every certified own-message)
and the per-peer unicast logs; the HELLO handshake streams these logs to a
connecting peer (reference core/message-handling.go:316-350).

Beyond the reference (whose log grows forever — GC is its top roadmap
item, README.md:492-493), the log supports **checkpoint truncation**:

- :meth:`truncate` drops a prefix and installs a head entry (the LOG-BASE
  announcement carrying the checkpoint certificate) in its place.
  Positions are absolute, so live subscribers past the cut are
  unaffected; a subscriber still inside the dropped prefix resumes at the
  head entry — it sees the LOG-BASE *before* the retained suffix and can
  fast-forward its per-peer capture instead of wedging on the counter
  gap.
- :meth:`replace` swaps a retained entry for its checkpoint-covered stub
  (same authen bytes, payload dropped — messages.Prepare.requests_digest)
  so retained history costs O(1) per counter instead of O(batch).

Wake-ups are synchronous event sets on append (all protocol code runs on
one loop — the asyncio analogue of the reference's per-replica goroutine
ownership); idle streams park on an Event instead of polling.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, List, Optional


class MessageLog:
    def __init__(self):
        self._entries: List[object] = []
        self._seq0 = 0  # absolute position of _entries[0]
        self._waiters: List[asyncio.Event] = []

    def append(self, msg) -> None:
        """Non-blocking append (reference messagelog.go:60-72)."""
        self._entries.append(msg)
        waiters, self._waiters = self._waiters, []
        for ev in waiters:
            ev.set()

    def snapshot(self) -> List[object]:
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def truncate(self, n_drop: int, head: Optional[object] = None) -> None:
        """Drop the first ``n_drop`` entries; if ``head`` is given, place
        it where the dropped prefix was.  A subscriber whose position lies
        inside the dropped range resumes at ``head`` (then the suffix);
        one already past the range sees nothing."""
        if n_drop <= 0 and head is None:
            return
        n_drop = min(max(n_drop, 0), len(self._entries))
        suffix = self._entries[n_drop:]
        self._seq0 += n_drop
        if head is not None:
            # The head occupies the last dropped slot, so lagging
            # subscribers (position <= _seq0) receive it first while
            # up-to-date ones skip it.
            self._seq0 -= 1
            self._entries = [head] + suffix
        else:
            self._entries = suffix

    def replace(self, index: int, entry: object) -> None:
        """Swap the entry at list position ``index`` (into the current
        ``snapshot()``) for ``entry`` — used to stub checkpoint-covered
        history.  Subscribers already past it saw the original; later
        replays see the stub."""
        self._entries[index] = entry

    async def stream(
        self, done: Optional[asyncio.Event] = None
    ) -> AsyncIterator[object]:
        """Replay all entries, then follow new ones (reference
        messagelog.go:74-109).  Terminates when ``done`` is set."""
        idx = self._seq0
        while True:
            while True:
                # Re-check the base every iteration: a yield suspends the
                # stream, and a truncate may land before it resumes.
                if idx < self._seq0:
                    idx = self._seq0  # truncated past us: resume at head
                if idx - self._seq0 >= len(self._entries):
                    break
                yield self._entries[idx - self._seq0]
                idx += 1
            if done is not None and done.is_set():
                return
            ev = asyncio.Event()
            # Atomic loop-side registration; the re-check below (and the
            # drain-either-way continue) absorbs an append/truncate racing
            # this suspension point.
            self._waiters.append(ev)  # noqa: LD001
            if idx - self._seq0 < len(self._entries) or idx < self._seq0:
                # An append/truncate raced our registration; the event may
                # stay set or unset — loop and drain either way.
                continue
            if done is None:
                await ev.wait()
            else:
                ev_task = asyncio.ensure_future(ev.wait())
                done_task = asyncio.ensure_future(done.wait())
                try:
                    await asyncio.wait(
                        [ev_task, done_task],
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                finally:
                    ev_task.cancel()
                    done_task.cancel()
