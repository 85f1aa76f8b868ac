"""View number state (reference core/internal/viewstate/view-state.go:50-105).

Tracks the current and expected view under an async RW discipline:
``hold_view_lease`` is the read-lease held across view-sensitive
processing (the reference takes a read lock and returns a release
closure, view-state.go:50-74) — message processing that suspends between
the view check and apply cannot be overtaken by a view advancement;
``advance_current_view`` takes the write side and waits out active
leases.  The reference never advances the current view (its view-change
processing is a stub, core/message-handling.go:419); here the full
view-change protocol (core/viewchange.py) drives every edge, including
``wait_current_at_least`` for messages from views still being entered.
"""

from __future__ import annotations

import asyncio
from typing import Tuple


class _Lease:
    """Shared read-lease handle (``async with view_state.hold_view_lease()``).

    The hot path — no view change draining — takes and releases the lease
    with plain counter arithmetic, no locks and no context-manager
    machinery: on the single-threaded event loop nothing can interleave
    between the writer-gate check and the counter increment.  Only while a
    writer is draining does entry await the gate (writer priority: new
    leases queue behind a pending advance)."""

    __slots__ = ("_vs",)

    def __init__(self, vs: "ViewState"):
        self._vs = vs

    async def __aenter__(self) -> Tuple[int, int]:
        vs = self._vs
        while vs._writer_waiting:
            await vs._write_gate.wait()
        vs._readers += 1
        return vs._current, vs._expected

    async def __aexit__(self, *exc) -> bool:
        vs = self._vs
        vs._readers -= 1
        if vs._readers == 0 and vs._writer_waiting:
            vs._no_readers.set()
        return False


class ViewState:
    def __init__(self):
        self._current = 0
        self._expected = 0
        self._write_lock = asyncio.Lock()  # serializes writers only
        self._readers = 0
        self._writer_waiting = False
        self._no_readers = asyncio.Event()
        self._write_gate = asyncio.Event()
        self._write_gate.set()
        self._advanced = asyncio.Event()  # swapped on every current-advance

    async def wait_current_at_least(self, view: int) -> None:
        """Park until the current view reaches ``view`` — how processing of
        a message from a *future* view waits for the local view transition
        to catch up instead of dropping it (the reference errors such
        messages out, core/message-handling.go "unexpected view")."""
        while True:
            ev = self._advanced  # capture BEFORE the check: an advance
            if self._current >= view:  # between check and wait() sets the
                return  # captured event, so the wakeup cannot be missed
            await ev.wait()

    @property
    def current(self) -> int:
        """Synchronous current-view read (for non-suspending call sites
        like the checkpoint emitter's primary check)."""
        return self._current

    async def hold_view(self) -> Tuple[int, int]:
        """-> (current_view, expected_view) snapshot (no lease).  For
        view-sensitive *processing*, use :meth:`hold_view_lease` — a
        snapshot can go stale across an await."""
        return self._current, self._expected

    def hold_view_lease(self) -> _Lease:
        """Read-lease: yields (current, expected); the current view cannot
        advance until every active lease is released (reference HoldView's
        RLock, view-state.go:50-74).  Leases are shared — concurrent
        message processing proceeds in parallel."""
        return _Lease(self)

    async def advance_expected_view(self, view: int) -> bool:
        """Demand a view change to ``view``; False if not ahead
        (reference view-state.go:74-88)."""
        if view <= self._expected:
            return False
        self._expected = view
        return True

    async def advance_current_view(self, view: int) -> bool:
        """Enter ``view`` (completes a view change; reference
        view-state.go:90-105).  Waits for in-flight read leases, so a
        message mid-apply in the old view finishes before the view moves;
        new leases queue behind the drain on the write gate."""
        async with self._write_lock:
            self._writer_waiting = True
            self._write_gate.clear()
            try:
                while self._readers:
                    self._no_readers.clear()
                    await self._no_readers.wait()
                if view <= self._current or view > self._expected:
                    return False
                self._current = view
                ev, self._advanced = self._advanced, asyncio.Event()
                ev.set()
                return True
            finally:
                self._writer_waiting = False
                self._write_gate.set()
