"""Per-replica recovery telemetry: phase machine, counters, and the
restart-to-first-executed-request clock.

The manager is deliberately passive — pure bookkeeping mutated from the
recovery paths in core/message_handling.py and core/replica.py, scraped by
``obs/prom.collect_recovery`` into the ``minbft_recovery_*`` families and
rendered as the RECOV column in ``peer top``.  It owns the
:class:`~minbft_tpu_torch.recovery.store.DurableStore` handle so one object
threads through construction.

``recovery_time_ms`` is the SLO the chaos soak gates (benchgate key
``chaos_recovery_time_ms``): armed when a durable state is loaded at
startup, stopped at the first request *executed* after restart — i.e. the
full restart → restore → (re)transfer → catch-up → serving pipeline, not
just the file read.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .store import DurableStore

PHASE_IDLE = 0
PHASE_LOADING = 1
PHASE_FETCHING = 2
PHASE_INSTALLING = 3
PHASE_CATCHUP = 4
PHASE_DONE = 5

PHASE_NAMES = ("idle", "load", "fetch", "install", "catchup", "done")


class RecoveryManager:
    def __init__(
        self,
        store: Optional[DurableStore] = None,
        group: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.store = store
        self.group = group
        self._clock = clock
        self.phase = PHASE_IDLE
        # Chunked state transfer (either side).
        self.chunks_rx = 0
        self.bytes_rx = 0
        self.chunks_tx = 0
        self.bytes_tx = 0
        self.resumes = 0
        self.failovers = 0
        # Durable store.
        self.saves = 0
        self.save_errors = 0
        self.restored_count: Optional[int] = None
        # Recovery clock.
        self._armed_at: Optional[float] = None
        self.recovery_time_ms: Optional[float] = None

    # -- phase / clock ----------------------------------------------------

    def set_phase(self, phase: int) -> None:
        self.phase = phase

    def arm(self) -> None:
        """Start the recovery clock (startup restore found durable state)."""
        if self._armed_at is None:
            self._armed_at = self._clock()

    def disarm(self) -> None:
        self._armed_at = None

    @property
    def armed(self) -> bool:
        return self._armed_at is not None and self.recovery_time_ms is None

    def note_executed(self) -> None:
        """First executed request after an armed restart stops the clock and
        completes the phase machine.  Cheap no-op on every later call."""
        if self._armed_at is not None and self.recovery_time_ms is None:
            self.recovery_time_ms = (self._clock() - self._armed_at) * 1000.0
            self.phase = PHASE_DONE

    # -- counters ---------------------------------------------------------

    def note_chunk_rx(self, nbytes: int) -> None:
        self.chunks_rx += 1
        self.bytes_rx += nbytes

    def note_chunk_tx(self, nbytes: int) -> None:
        self.chunks_tx += 1
        self.bytes_tx += nbytes

    def note_resume(self) -> None:
        self.resumes += 1

    def note_failover(self) -> None:
        self.failovers += 1

    def note_saved(self, count: int) -> None:
        self.saves += 1

    def note_save_error(self) -> None:
        self.save_errors += 1

    def snapshot(self) -> dict:
        """Point-in-time view for /metrics and ``peer top``."""
        return {
            "phase": self.phase,
            "phase_name": PHASE_NAMES[self.phase],
            "chunks_rx": self.chunks_rx,
            "bytes_rx": self.bytes_rx,
            "chunks_tx": self.chunks_tx,
            "bytes_tx": self.bytes_tx,
            "resumes": self.resumes,
            "failovers": self.failovers,
            "saves": self.saves,
            "save_errors": self.save_errors,
            "restored_count": self.restored_count,
            "recovery_time_ms": self.recovery_time_ms,
        }
