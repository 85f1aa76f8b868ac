"""Client implementation.

Reference structure (client/):

- request pipeline: construct -> sign(ClientAuthen over AuthenBytes) ->
  broadcast to n sender tasks (reference client/request.go:186-204,
  requestbuffer.go:59-88);
- per-replica connection task pair: outgoing pumps the request stream,
  incoming authenticates REPLYs (ReplicaAuthen + client-ID check,
  reference client/message-handling.go:161-170) and feeds the collector;
- collector: f+1 matching replies by SHA256(result), dedup'd by replica ID
  (reference client/request.go:83-97, requestbuffer.go:219-236).

Pipelining re-design: the reference gates one request in flight per client
(requestbuffer.go:59-88 AddRequest blocks until the prior request is
removed) because its replicas process a client's requests one sequence at a
time anyway.  Here requests are tracked in a per-seq pending map, so a
client may pipeline many requests; the replicas' clientstate still captures
each client's sequences in order, but the network/verification latency of
request k no longer serializes request k+1 — this is what lets the batch
verification engine actually fill batches (an early bench ran one
request at a time and starved it).  ``max_inflight`` bounds the pipeline;
an asyncio semaphore replaces the reference's single-slot buffer when set
to 1.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from typing import AsyncIterator, Dict, Optional

from .. import api
from ..obs import trace as obs_trace
from ..utils.backoff import ReconnectBackoff, RetransmitBackoff
from ..messages import (
    Busy,
    CodecError,
    Reply,
    Request,
    authen_bytes,
    drain_multi,
    marshal,
    split_multi,
    unmarshal,
)

# Consecutive reply-handling failures on one stream before it is torn down
# for a backoff redial (see _run_connection's poison-frame guard).
_MAX_CONSECUTIVE_REPLY_ERRORS = 10


class _PendingRequest:
    __slots__ = (
        "seq",
        "threshold",
        "read_only",
        "replies_by_replica",
        "count_by_digest",
        "result",
        "data",
        "busy_until",
    )

    def __init__(
        self,
        seq: int,
        threshold: int,
        loop: asyncio.AbstractEventLoop,
        read_only: bool = False,
    ):
        self.seq = seq
        # f+1 matching replies for ordered requests; ALL n for read-only
        # fast reads (the n=2f+1 read-quorum bound — see Client.request).
        self.threshold = threshold
        self.read_only = read_only
        self.replies_by_replica: Dict[int, bytes] = {}
        self.count_by_digest: Dict[bytes, int] = {}
        self.result: asyncio.Future = loop.create_future()
        # Pre-retrieve any exception outcome: an error quorum landing just
        # after the awaiter timed out (and the pending was popped) must
        # not log "Future exception was never retrieved" on GC.
        self.result.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None
        )
        # Marshaled REQUEST bytes, kept so a reconnecting replica stream can
        # re-send everything still unresolved (see _run_connection).
        self.data: Optional[bytes] = None
        # Monotonic deadline before which retransmission is suppressed —
        # set by a verified BUSY shed signal (replica admission control).
        # The request itself stays live: a reply still resolves it.
        self.busy_until: float = 0.0

    def add_reply(self, reply: Reply) -> None:
        if reply.read_only != self.read_only:
            return  # an ordered reply cannot complete a read, nor vice versa
        if reply.replica_id in self.replies_by_replica:
            return  # one vote per replica (reference requestbuffer.go:219-236)
        self.replies_by_replica[reply.replica_id] = reply.result
        # The error flag is part of the vote: a signed error reply must
        # never merge with a real empty result.
        digest = hashlib.sha256(
            (b"\x01" if reply.error else b"\x00") + reply.result
        ).digest()
        cnt = self.count_by_digest.get(digest, 0) + 1
        self.count_by_digest[digest] = cnt
        if cnt >= self.threshold and not self.result.done():
            if reply.error:
                self.result.set_exception(
                    api.ReadOnlyQueryError(
                        "replica quorum signed error replies: query "
                        "unsupported or raised on this operation"
                    )
                )
            else:
                self.result.set_result(reply.result)


class Client:
    def __init__(
        self,
        client_id: int,
        n: int,
        f: int,
        authenticator: api.Authenticator,
        connector: api.ReplicaConnector,
        seq_start: Optional[int] = None,
        max_inflight: Optional[int] = None,
        retransmit_interval: Optional[float] = None,
        trace: bool = False,
        group: Optional[int] = None,
    ):
        if n < 2 * f + 1:
            raise ValueError(f"n must be at least 2f+1 (n={n}, f={f})")
        self.client_id = client_id
        self.n = n
        self.f = f
        # Consensus-group id when this is one of a MultiGroupClient's
        # per-group inner clients (minbft_tpu/groups): labels the flight
        # recorder so grouped dumps stay separable; None = ungrouped.
        self.group = group
        self._auth = authenticator
        self._connector = connector
        # Sequence numbers seeded from wall clock so a restarted client
        # doesn't reuse sequences (reference client/request.go:209-217).
        self._seq = seq_start if seq_start is not None else time.time_ns()
        self._pending: Dict[int, _PendingRequest] = {}
        self._inflight: Optional[asyncio.Semaphore] = (
            asyncio.Semaphore(max_inflight) if max_inflight else None
        )
        self._retransmit_interval = retransmit_interval
        self._queues: Dict[int, asyncio.Queue] = {}
        self._tasks: list = []
        self._started = False
        # Broadcast-order gate: ordered REQUESTs must hit the wire in seq
        # order (see request()) even when their batch-signed signatures
        # resolve out of order.  Holds the previous ordered request's
        # "broadcast done" future.
        self._send_gate: Optional[asyncio.Future] = None
        # Flight recorder for the client-side spans (sign → broadcast →
        # first-reply → f+1-quorum); one predicated check per hook when
        # off (obs/trace.py).
        self._trace = (
            obs_trace.FlightRecorder.for_client(client_id, group=group)
            if (trace or obs_trace.tracing_enabled())
            else None
        )
        # Verified BUSY shed signals received (observable by load harnesses).
        self.busy_signals = 0
        self._log = logging.getLogger(f"minbft_tpu_torch.client.{client_id}")

    # -- connections --------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        for rid in range(self.n):
            handler = self._connector.replica_message_stream_handler(rid)
            if handler is None:
                raise ValueError(f"no connection for replica {rid}")
            q: asyncio.Queue = asyncio.Queue()
            self._queues[rid] = q
            task = loop.create_task(self._run_connection(rid, handler, q))
            # A connection task dying with an exception (a bug — the loop
            # is designed to swallow transport errors and redial) must
            # not lose the trace: dump on the fatal error, not only on a
            # clean stop() (the crashed-soak blind spot).
            task.add_done_callback(self._on_task_done)
            self._tasks.append(task)
        self._started = True

    def _on_task_done(self, task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        self._log.error(
            "client %d task %s died: %r", self.client_id, task.get_name(), exc
        )
        if self._trace is not None:
            try:
                obs_trace.dump_recorder(self._trace)
            except OSError:
                pass

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        self._started = False
        # Fail in-flight requests instead of leaving their callers parked
        # on futures nothing will ever resolve.
        for pending in list(self._pending.values()):
            if not pending.result.done():
                pending.result.set_exception(
                    ConnectionError("client stopped with the request in flight")
                )
        if self._trace is not None:
            # No-op unless MINBFT_TRACE_DUMP is set (live-scrape-only
            # recorders have nothing to flush).
            obs_trace.dump_recorder(self._trace)

    async def _outgoing(self, q: asyncio.Queue) -> AsyncIterator[bytes]:
        # Coalesce a pipelined burst of requests into one transport
        # frame — per-frame gRPC/asyncio cost dominates on small hosts
        # (see core.message_handling's pump coalescing).
        while True:
            data, _ = drain_multi(await q.get(), q)
            yield data

    async def _run_connection(
        self, replica_id: int, handler: api.MessageStreamHandler, q: asyncio.Queue
    ) -> None:
        """One replica's stream, redialed with backoff when it drops.

        Mirrors core.message_handling.run_peer_connection: both connectors
        dial a fresh connection per handle_message_stream call, so a network
        blip or replica restart must not permanently cost the client a
        reply vote — with only f+1 matching replies required, losing >f
        streams forever would wedge every future request even though every
        replica is healthy again.  Each redial swaps in a FRESH queue (the
        dead attempt's outgoing pump may still hold q.get() and would steal
        frames) and re-sends every still-pending request: frames drained
        into the dying connection are otherwise lost, and replica-side
        clientstate dedups the re-send (same reply re-served from cache)."""
        backoff = ReconnectBackoff()
        while True:
            attempt_start = time.monotonic()
            poisoned = False
            # Per-STREAM counter (the constant's contract): carrying it
            # across redials would tear every later stream down on its
            # first failure.
            consecutive_errors = 0
            try:
                async for data in handler.handle_message_stream(self._outgoing(q)):
                    try:
                        frames = split_multi(data)
                    except CodecError:
                        continue
                    for fr in frames:
                        # A poison frame (reply handling raising — only
                        # local bugs or transient verifier/backend errors
                        # reach here; auth and codec failures are swallowed
                        # inside _handle_reply) costs the FRAME, not the
                        # connection.  A run of them tears the stream down
                        # for a BACKOFF redial — never permanently: a
                        # transient verifier outage must not sever >f
                        # streams forever (the wedge this loop exists to
                        # prevent), while a deterministic bug self-throttles
                        # at the ladder cap.
                        try:
                            await self._handle_reply(replica_id, fr)
                            consecutive_errors = 0
                        except asyncio.CancelledError:
                            raise
                        except Exception:
                            consecutive_errors += 1
                            self._log.exception(
                                "client %d replica %d: reply handling failed "
                                "(%d consecutive)",
                                self.client_id,
                                replica_id,
                                consecutive_errors,
                            )
                            if consecutive_errors >= _MAX_CONSECUTIVE_REPLY_ERRORS:
                                poisoned = True
                                break
                    if poisoned:
                        break
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # A faulty replica connection must not break the client: f+1
                # matching replies from the others still complete requests.
                # But an operator debugging missing reply votes needs the
                # cause (auth failure vs refused vs codec bug) on record.
                self._log.warning(
                    "client %d replica %d stream failed: %s",
                    self.client_id,
                    replica_id,
                    e,
                )
            delay = backoff.next_delay(time.monotonic() - attempt_start)
            q = asyncio.Queue()
            self._queues[replica_id] = q
            resent = 0
            for pending in self._pending.values():
                if (
                    pending.data is not None
                    and not pending.result.done()
                    # this replica already voted: its clientstate would only
                    # re-serve a reply add_reply discards as a duplicate
                    and replica_id not in pending.replies_by_replica
                ):
                    q.put_nowait(pending.data)
                    resent += 1
            self._log.debug(
                "client %d replica %d stream ended: redialing in %.1fs "
                "(%d pending re-sent)",
                self.client_id,
                replica_id,
                delay,
                resent,
            )
            await asyncio.sleep(delay)

    async def _handle_reply(self, replica_id: int, data: bytes) -> None:
        try:
            msg = unmarshal(data)
        except Exception:
            return
        if isinstance(msg, Busy):
            await self._handle_busy(replica_id, msg)
            return
        if not isinstance(msg, Reply):
            return
        # Authenticate and attribute (reference client/message-handling.go:161-170).
        if msg.replica_id != replica_id or msg.client_id != self.client_id:
            return
        pending = self._pending.get(msg.seq)
        if pending is None or pending.result.done():
            return
        try:
            await self._auth.verify_message_authen_tag(
                api.AuthenticationRole.REPLICA,
                msg.replica_id,
                authen_bytes(msg),
                msg.signature,
            )
        except api.AuthenticationError:
            return
        # Re-fetch: the request may have resolved/retired during the await.
        pending = self._pending.get(msg.seq)
        if pending is not None:
            tr = self._trace
            if tr is None:
                pending.add_reply(msg)
                return
            first = not pending.replies_by_replica
            was_done = pending.result.done()
            pending.add_reply(msg)
            if first and pending.replies_by_replica:
                tr.note(obs_trace.C_FIRST_REPLY, self.client_id, msg.seq)
            if not was_done and pending.result.done():
                tr.note(obs_trace.C_QUORUM, self.client_id, msg.seq)

    async def _handle_busy(self, replica_id: int, msg: Busy) -> None:
        """A replica shed our REQUEST at its admission boundary: verify the
        signal (a forged BUSY must not be able to starve this client) and
        suppress retransmission of that request for ``retry_after_ms``.
        The pending request stays live — replies from less-loaded replicas
        (or this one, post-recovery) still resolve it; only the re-send
        pressure backs off."""
        if msg.replica_id != replica_id or msg.client_id != self.client_id:
            return
        pending = self._pending.get(msg.seq)
        if pending is None or pending.result.done():
            return
        try:
            await self._auth.verify_message_authen_tag(
                api.AuthenticationRole.REPLICA,
                msg.replica_id,
                authen_bytes(msg),
                msg.signature,
            )
        except api.AuthenticationError:
            return
        # Re-fetch: the request may have resolved during the await.
        pending = self._pending.get(msg.seq)
        if pending is None:
            return
        hold = min(max(msg.retry_after_ms, 0), 60_000) / 1000.0
        pending.busy_until = max(pending.busy_until, time.monotonic() + hold)
        self.busy_signals += 1

    # -- requests -----------------------------------------------------------

    async def request(
        self,
        operation: bytes,
        timeout: Optional[float] = None,
        read_only: bool = False,
        read_timeout: float = 1.0,
        read_fallback: bool = True,
    ) -> bytes:
        """Submit an operation; resolves once f+1 replicas agree on the
        result (reference client/client.go:66-71 Request).  Many requests
        may be pipelined concurrently (bounded by ``max_inflight``).

        ``read_only=True`` takes the fast path (reference roadmap
        README.md:503-504): replicas answer from committed state without
        ordering, and the read is accepted only when ALL n replies match —
        with n=2f+1 a read quorum below n cannot be guaranteed to
        intersect a write quorum in a correct replica, so any smaller
        threshold could return stale data.  If the cluster disagrees (a
        write is in flight, a replica lags or is down), the fast read
        times out after ``read_timeout`` and, with ``read_fallback``,
        the operation is resubmitted as an ordered request — the same
        degradation PBFT's read-only optimization uses."""
        if not self._started:
            raise RuntimeError("client not started")
        mode = 0
        if read_only:
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            ro_wait = (
                read_timeout if timeout is None else min(read_timeout, timeout)
            )
            # Fast reads respect max_inflight too: the pipelining bound is
            # an operator cap on replica load, and query work is load.
            if self._inflight is not None:
                await self._inflight.acquire()
            try:
                if not self._started:
                    # stopped while parked on the semaphore: the sweep in
                    # stop() already ran, so registering now would hang
                    raise ConnectionError("client stopped")
                return await self._request_read_only(operation, ro_wait)
            except (asyncio.TimeoutError, api.ReadOnlyQueryError):
                # ReadOnlyQueryError: the fast quorum ANSWERED — with
                # signed errors.  The ordered fallback usually fails the
                # same way (it raises the typed error to the caller),
                # but falling back is honest and costs one attempt.
                if not read_fallback:
                    raise
            finally:
                if self._inflight is not None:
                    self._inflight.release()
            if deadline is not None and deadline - time.monotonic() <= 0.005:
                # The fast attempt consumed the caller's whole budget:
                # signing + broadcasting a fallback that times out in
                # microseconds only wastes consensus work.
                raise asyncio.TimeoutError()
            # Fall through to the ordered pipeline as an ORDERED read
            # (read_mode=2): consensus linearizes it, execution answers
            # via consumer.query — no state mutation, f+1 reply quorum.
            mode = 2
            timeout = (
                None if deadline is None else deadline - time.monotonic()
            )
        if self._inflight is not None:
            await self._inflight.acquire()
        try:
            if not self._started:
                # stopped while parked on the semaphore (see stop())
                raise ConnectionError("client stopped")
            self._seq += 1
            seq = self._seq
            # Broadcast-order gate: replica-side retirement has
            # watermark-jump semantics (executing seq k supersedes every
            # lower seq of this client), so ordered REQUESTs must reach
            # the wire in seq order.  Batch signing suspends between seq
            # allocation and broadcast — without the gate, seq k+1's
            # signature resolving first would broadcast it ahead of seq
            # k and k could be superseded unexecuted.  Signing itself
            # still co-batches: every pipelined request submits to the
            # sign queue immediately; only the SEND waits for its
            # predecessor's send.
            prev_gate = self._send_gate
            gate: asyncio.Future = asyncio.get_running_loop().create_future()
            self._send_gate = gate
            tr = self._trace
            try:
                req = Request(
                    client_id=self.client_id,
                    seq=seq,
                    operation=operation,
                    read_mode=mode,
                )
                if tr is not None:
                    tr.note(obs_trace.C_START, self.client_id, seq)
                # Awaitable batch-aware signing: concurrent pipelined
                # requests co-batch their signatures on the engine's sign
                # queue (plain synchronous signing for engine-less
                # authenticators).
                req.signature = await self._auth.generate_message_authen_tag_async(
                    api.AuthenticationRole.CLIENT, authen_bytes(req)
                )
                if tr is not None:
                    tr.note(obs_trace.C_SIGN, self.client_id, seq)
                if prev_gate is not None and not prev_gate.done():
                    await prev_gate
                pending = _PendingRequest(
                    seq,
                    self.f + 1,
                    asyncio.get_running_loop(),
                    read_only=bool(mode),
                )
                self._pending[seq] = pending
                data = marshal(req)
                pending.data = data
                self._broadcast(data)
                if tr is not None:
                    tr.note(obs_trace.C_BROADCAST, self.client_id, seq)
            finally:
                # Always open the gate — a failed/cancelled sign must not
                # wedge every later request (its seq simply goes unused;
                # client seqs need not be dense).
                if not gate.done():
                    gate.set_result(None)
            try:
                if self._retransmit_interval is not None:
                    return await self._await_with_retransmit(pending, data, timeout)
                if timeout is not None:
                    return await asyncio.wait_for(pending.result, timeout)
                return await pending.result
            finally:
                self._pending.pop(seq, None)
        finally:
            if self._inflight is not None:
                self._inflight.release()

    async def _request_read_only(self, operation: bytes, wait: float) -> bytes:
        """One fast-read attempt: broadcast, require ALL n matching."""
        self._seq += 1
        seq = self._seq
        req = Request(
            client_id=self.client_id,
            seq=seq,
            operation=operation,
            read_mode=1,
        )
        tr = self._trace
        if tr is not None:
            tr.note(obs_trace.C_START, self.client_id, seq)
        req.signature = await self._auth.generate_message_authen_tag_async(
            api.AuthenticationRole.CLIENT, authen_bytes(req)
        )
        if tr is not None:
            tr.note(obs_trace.C_SIGN, self.client_id, seq)
        pending = _PendingRequest(
            seq, self.n, asyncio.get_running_loop(), read_only=True
        )
        self._pending[seq] = pending
        data = marshal(req)
        pending.data = data
        self._broadcast(data)
        if tr is not None:
            tr.note(obs_trace.C_BROADCAST, self.client_id, seq)
        try:
            return await asyncio.wait_for(pending.result, wait)
        finally:
            self._pending.pop(seq, None)

    def _broadcast(self, data: bytes) -> None:
        for q in self._queues.values():
            q.put_nowait(data)

    async def _await_with_retransmit(
        self, pending: _PendingRequest, data: bytes, timeout: Optional[float]
    ) -> bytes:
        """Re-send the request until resolved — the network may drop
        messages (the reference relies on its stream replay design,
        core/message-handling.go:316-350 HELLO log replay, for the peer side;
        clients get retransmission here).  Intervals climb a capped
        exponential ladder with jitter (utils.backoff.RetransmitBackoff):
        a fixed interval re-broadcast every unresolved pipelined request
        in the same tick, which under loss or partition turned the
        recovery path itself into a synchronized load spike."""
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = RetransmitBackoff(self._retransmit_interval)
        while True:
            interval = backoff.next_delay()
            if deadline is not None:
                interval = min(interval, max(deadline - time.monotonic(), 0.001))
            try:
                return await asyncio.wait_for(
                    asyncio.shield(pending.result), interval
                )
            except asyncio.TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                if time.monotonic() < pending.busy_until:
                    # A verified BUSY hold is active: retransmitting into a
                    # saturated replica set only deepens the overload (and
                    # earns another shed).  Skip this tick; the ladder keeps
                    # climbing, and the overall deadline still applies.
                    continue
                self._broadcast(data)


def new_client(
    client_id: int,
    n: int,
    f: int,
    authenticator: api.Authenticator,
    connector: api.ReplicaConnector,
    **kw,
) -> Client:
    """Create a client (reference client.New, client/client.go:51-64)."""
    return Client(client_id, n, f, authenticator, connector, **kw)
