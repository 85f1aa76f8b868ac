"""Per-client state: request-seq lifecycle, reply buffer, timers.

Reference core/internal/clientstate/: three sub-machines per client —

- request-seq lifecycle captured→released→prepared→retired with a blocking
  capture (reference request-seq.go:47-112): this is the per-client
  pipelining/dedup gate — one request in flight per client, strictly
  increasing sequence numbers, parallel across clients;
- reply buffer with per-seq subscription (reference reply.go:41-90);
- restartable single-slot request/prepare timers (reference timeout.go:40-71),
  injectable for tests (reference timer mock).
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from typing import Callable, Dict, Optional

from .timer import TimerProvider, StandardTimerProvider


class ClientState:
    """All containers here are O(1) per client — a long-lived replica's
    memory must not grow with the number of requests served (the
    reference keeps a single last-reply slot, reply.go:25-60, and scalar
    seq watermarks, request-seq.go:28-45)."""

    # Out-of-order tolerance window: completed-but-unretired seqs above
    # the retire floor are remembered individually so a LOWER seq
    # arriving late is not mistaken for a duplicate.  Bounded at roughly
    # any sane client pipeline depth; beyond it, oldest entries fall out
    # (dedup degrades to the floor for ancient seqs — the reply
    # window's philosophy).
    _DONE_WINDOW = 1024

    # Executed-seq dedup window (see retire_request_seq): retirement is
    # EXACT per seq, bounded by this window; evicted seqs raise the
    # retire floor (conservative refusal, like the done-floor).
    _RETIRE_WINDOW = 1024

    def __init__(self, timer_provider: TimerProvider):
        self._timers = timer_provider
        # Request-seq state machine.  The reference keeps scalar
        # captured/released watermarks (request-seq.go:28-45) — sound
        # there because its client is strictly serial (requestbuffer's
        # single slot), so seqs ARRIVE in order.  This build's clients
        # pipeline many requests, and concurrent per-message tasks mean a
        # higher seq can reach capture first; a scalar watermark would
        # then silently DROP the lower seq as a "duplicate" — never
        # proposed, and later retired past by the watermark jump (a
        # liveness hole observed live at ~1 in 10 flagship bench runs).
        # Capture instead tracks the single ACTIVE seq plus a bounded set
        # of completed seqs above the retire watermark.
        self._last_captured = 0  # max captured (diagnostic watermark)
        self._active = 0  # captured, not yet released (0 = none)
        self._done: set = set()  # released seqs > _retired
        # Everything at or below this floor is treated as a duplicate:
        # when the done-set overflows, evicted seqs RAISE the floor
        # instead of silently losing their dedup (a dropped dedup would
        # let a retransmit re-execute an already-processed request —
        # safety; a floor refusing a very late lower seq costs only
        # liveness, and only beyond a 1024-deep reorder).
        self._done_floor = 0
        self._last_prepared = 0
        # Executed-seq state: the reference retires by WATERMARK JUMP
        # (executing seq k marks every lower seq of the client retired,
        # request-seq.go:108-112) — sound for its strictly serial
        # clients, where a lower seq after a higher one can only be a
        # stale retry.  This build's clients pipeline: under network
        # reordering a higher seq can commit FIRST, and a jump would
        # silently supersede the still-live lower request — never
        # executed, never replied, the client wedged until timeout (the
        # chaos soak caught this live).  Retirement is therefore exact:
        # a bounded set of executed seqs over a floor raised by eviction.
        self._retire_floor = 0
        self._retired_set: set = set()
        self._cond = asyncio.Condition()
        # Reply buffer: a bounded WINDOW of recent replies.  The reference
        # keeps exactly one last-reply slot (reply.go:25-38) — sound there
        # because its clients are strictly serial (requestbuffer's
        # single-capacity slot).  This build's clients pipeline up to
        # max_inflight requests, so replies k and k+1 can both land before
        # the waiter for k wakes; a single slot would skip k and strand
        # the client.  The window (insertion = execution = seq order)
        # bounds memory at O(_REPLY_WINDOW) per client while covering any
        # sane pipeline depth; the event is swapped on each add so waiters
        # from any earlier add are woken exactly once.
        self._reply_floor = 0  # highest seq pruned out of the window
        self._replies: "OrderedDict[int, object]" = OrderedDict()
        self._reply_event = asyncio.Event()
        # Timers (reference timeout.go) — PER-SEQ, not the reference's
        # single slot per client: pipelined clients keep many requests
        # in flight, and a shared slot means every newly-applied request
        # DISARMS the watchdog guarding the previous one (and executing
        # any request disarms them all) — under faults the unguarded
        # requests then starve with no view-change demand ever fired
        # (the chaos soak wedged on this).  Bounded by requests in
        # flight: entries leave on expiry, stop, or execution.
        self._request_timers: Dict[int, object] = {}
        self._prepare_timers: Dict[int, object] = {}

    # -- request sequence lifecycle -----------------------------------------

    def _is_retired(self, seq: int) -> bool:
        return seq <= self._retire_floor or seq in self._retired_set

    def _is_dup(self, seq: int) -> bool:
        return (
            self._is_retired(seq)
            or seq <= self._done_floor
            or seq == self._active
            or seq in self._done
        )

    async def capture_request_seq(self, seq: int) -> bool:
        """Capture ``seq`` for processing.

        Returns False if ``seq`` was already captured/retired (duplicate).
        Blocks while a DIFFERENT capture is unreleased (the per-client
        serialization of reference request-seq.go:47-82).  Out-of-order
        arrivals are fine: a lower seq arriving after a higher one still
        captures (see the constructor note)."""
        # Duplicate fast path: on the single-threaded event loop nothing
        # changes between this check and the return — the condvar is only
        # needed to *capture*.  (Duplicates dominate: every peer message
        # re-offers its embedded requests.)
        if self._is_dup(seq):
            return False
        async with self._cond:
            while True:
                if self._is_dup(seq):
                    return False
                if self._active == 0:
                    self._active = seq
                    if seq > self._last_captured:
                        self._last_captured = seq
                    return True
                await self._cond.wait()

    async def release_request_seq(self, seq: int) -> None:
        """Finish processing a captured seq (reference request-seq.go:84-97)."""
        async with self._cond:
            if seq != self._active:
                raise ValueError("release of non-captured request seq")
            self._active = 0
            if not self._is_retired(seq):
                self._done.add(seq)
                if len(self._done) > self._DONE_WINDOW:
                    evicted = min(self._done)
                    self._done.discard(evicted)
                    if evicted > self._done_floor:
                        self._done_floor = evicted
            self._cond.notify_all()

    def prepare_request_seq(self, seq: int) -> None:
        """Mark ``seq`` prepared (reference request-seq.go:99-106).
        NOTE: with the out-of-order capture model, MANY seqs can sit
        between prepared and retired, so this scalar watermark cannot
        enumerate prepared-but-unexecuted requests — anything built on it
        (e.g. a view-change retransmission of prepared requests) must use
        the pending request list, not this field.  Nothing reads it yet;
        kept for reference parity."""
        if seq > self._last_prepared:
            self._last_prepared = seq

    @property
    def last_prepared_seq(self) -> int:
        return self._last_prepared

    def retire_request_seq(self, seq: int) -> bool:
        """Mark ``seq`` executed; returns False if already retired
        (reference request-seq.go:108-112).

        EXACT per-seq retirement, NOT the reference's watermark jump: the
        collector executes in a deterministic global (view, cv) order,
        and with pipelined clients plus a reordering network a higher seq
        legitimately commits before a lower one — jumping would silently
        drop the lower request (never executed, never replied; the chaos
        soak wedged on exactly this).  The set is a pure function of the
        executed history — identical on every correct replica, so the
        checkpoint watermark digest stays aligned — and bounded: evicted
        seqs raise the floor (an ancient retransmit below the floor is
        refused as a duplicate, a liveness-only loss beyond a
        _RETIRE_WINDOW-deep reorder)."""
        if self._is_retired(seq):
            return False
        self._retired_set.add(seq)
        self._fold_retire_floor()
        while len(self._retired_set) > self._RETIRE_WINDOW:
            evicted = min(self._retired_set)
            self._retired_set.discard(evicted)
            if evicted > self._retire_floor:
                self._retire_floor = evicted
            self._fold_retire_floor()
        self._done.discard(seq)
        return True

    def _fold_retire_floor(self) -> None:
        """Collapse the contiguous executed prefix into the floor: floor
        semantics ("everything at or below is retired") are EXACT for a
        contiguous run, so keeping those seqs individually would only
        bloat every checkpoint digest and snapshot with up to
        _RETIRE_WINDOW (client, seq) pairs per client.  Clients allocate
        seqs serially from seq_start, so once an eviction (or in-order
        execution from a floor-adjacent start) lands the floor inside
        the run, the set stays near-empty.  Deterministic — a pure
        function of the set — so replicas' watermark digests stay
        aligned."""
        while self._retire_floor + 1 in self._retired_set:
            self._retire_floor += 1
            self._retired_set.discard(self._retire_floor)

    @property
    def last_captured_seq(self) -> int:
        return self._last_captured

    @property
    def retired_seq(self) -> int:
        """Highest executed seq (diagnostic)."""
        return max(self._retired_set, default=self._retire_floor)

    @property
    def retire_state(self):
        """(floor, sorted retired seqs above it) — the exact executed-seq
        state carried by checkpoints and state transfer."""
        return self._retire_floor, tuple(sorted(self._retired_set))

    def install_retired(self, floor: int, seqs) -> None:
        """State transfer: adopt a certified retire state.  Union with
        local facts (an executed seq stays executed), then advance the
        other lifecycle watermarks so a re-offered old request dedups
        instead of re-capturing."""
        if floor > self._retire_floor:
            self._retire_floor = floor
        self._retired_set.update(seqs)
        self._retired_set = {
            s for s in self._retired_set if s > self._retire_floor
        }
        self._fold_retire_floor()
        top = max(self._retired_set, default=self._retire_floor)
        if self._done:
            self._done = {s for s in self._done if not self._is_retired(s)}
        if self._last_captured < top:
            self._last_captured = top
        if self._last_prepared < top:
            self._last_prepared = top
        # The cluster executed these seqs (the certificate vouches for the
        # state that retires them), so their watchdogs are done: left
        # running, a replica that caught up by state transfer times out
        # on requests already served and demands a view change (the
        # recovery soak's lagging primary did, one request timeout after
        # its install).  The reference's install leaves them running.
        for timers in (self._request_timers, self._prepare_timers):
            for seq in [s for s in timers if self._is_retired(s)]:
                self._stop_timer(timers, seq)

    # -- reply buffer --------------------------------------------------------

    _REPLY_WINDOW = 128  # >= any client pipeline depth; O(1) per client

    def add_reply(self, seq: int, reply) -> None:
        """Store the reply in the bounded window and wake subscribers
        (reference reply.go:41-60, generalized for pipelined clients —
        see the constructor comment).  Out-of-order seqs are accepted:
        with exact retirement a lower seq legitimately EXECUTES after a
        higher one (reordered commits), so its first reply arriving
        "late" is fresh, not a stale retry — only seqs already replied or
        pruned below the window floor are dropped."""
        if seq in self._replies or seq <= self._reply_floor:
            return  # duplicate / pruned (reference "old request ID")
        self._replies[seq] = reply
        while len(self._replies) > self._REPLY_WINDOW:
            old, _ = self._replies.popitem(last=False)
            if old > self._reply_floor:
                self._reply_floor = old
        ev, self._reply_event = self._reply_event, asyncio.Event()
        ev.set()

    async def reply_for(self, seq: int) -> Optional[object]:
        """Await the reply for ``seq`` (reference reply.go:62-80
        ReplyChannel): waits until the reply lands in the window; returns
        None if ``seq`` was pruned out of it (a stale retry far behind
        the pipeline — the reference closes the channel without
        sending)."""
        while True:
            reply = self._replies.get(seq)
            if reply is not None:
                return reply
            if seq <= self._reply_floor:
                return None
            await self._reply_event.wait()

    # -- timers --------------------------------------------------------------

    def _start_timer(
        self,
        timers: Dict[int, object],
        seq: int,
        timeout: float,
        on_expiry: Callable[[], None],
    ) -> None:
        self._stop_timer(timers, seq)
        if timeout > 0:

            def fire() -> None:
                timers.pop(seq, None)
                on_expiry()

            timers[seq] = self._timers.after(timeout, fire)

    @staticmethod
    def _stop_timer(timers: Dict[int, object], seq: int) -> None:
        t = timers.pop(seq, None)
        if t is not None:
            t.cancel()

    def start_request_timer(
        self, seq: int, timeout: float, on_expiry: Callable[[], None]
    ) -> None:
        """(Re)start the request timer for ``seq`` (reference
        timeout.go:40-56, per-seq — see the constructor note)."""
        self._start_timer(self._request_timers, seq, timeout, on_expiry)

    def stop_request_timer(self, seq: int) -> None:
        self._stop_timer(self._request_timers, seq)

    def start_prepare_timer(
        self, seq: int, timeout: float, on_expiry: Callable[[], None]
    ) -> None:
        self._start_timer(self._prepare_timers, seq, timeout, on_expiry)

    def stop_prepare_timer(self, seq: int) -> None:
        self._stop_timer(self._prepare_timers, seq)


class ClientStates:
    """Lazily-populated per-client provider (reference client-state.go:36-55)."""

    def __init__(self, timer_provider: Optional[TimerProvider] = None):
        self._timers = timer_provider or StandardTimerProvider()
        self._clients: Dict[int, ClientState] = {}

    @property
    def timers(self) -> TimerProvider:
        """The injected timer provider (shared with replica-level timers
        like the view-change timer, so fake-timer tests control both)."""
        return self._timers

    def client(self, client_id: int) -> ClientState:
        st = self._clients.get(client_id)
        if st is None:
            st = ClientState(self._timers)
            self._clients[client_id] = st
        return st

    def all(self):
        return self._clients.items()

    def retire_watermarks(self):
        """Deterministic snapshot of the per-client retire state — part
        of the composite checkpoint digest: the retired set is a pure
        function of the executed history, so correct replicas agree on it
        at every batch boundary.

        Encoding: flat sorted (client_id, seq) pairs — the wire/digest
        shape predating exact retirement — where each client's FIRST pair
        carries its retire floor and the following pairs its individually
        retired seqs above the floor, ascending (all > floor, so the pair
        stream stays sorted).  Clients with no executed history are
        omitted.  Exactness matters: encoding only a max watermark would
        make a state-transferred replica refuse a still-live lower seq
        that up-to-date replicas later execute — a ledger fork."""
        out = []
        for cid, st in sorted(self._clients.items()):
            floor, seqs = st.retire_state
            if floor == 0 and not seqs:
                continue
            out.append((cid, floor))
            out.extend((cid, s) for s in seqs)
        return tuple(out)

    def install_retire_watermarks(self, marks) -> None:
        """State transfer: adopt a certified retire state (the
        :meth:`retire_watermarks` encoding — per client, floor first,
        then the retired seqs above it)."""
        by_client: Dict[int, list] = {}
        for cid, seq in marks:
            by_client.setdefault(cid, []).append(seq)
        for cid, seqs in by_client.items():
            self.client(cid).install_retired(seqs[0], seqs[1:])
