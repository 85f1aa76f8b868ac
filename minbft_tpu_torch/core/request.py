"""Request pipeline: validate → process → apply → execute → reply.

Reference core/request.go: the client's REQUEST is signature-checked, its
sequence number captured per-client (dedup + one-in-flight pipelining gate),
tracked in the pending list; the primary then emits a PREPARE while backups
start a prepare timer; on quorum the request is executed against the
consumer and a signed REPLY is produced.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict

from .. import api
from ..messages import Reply, Request
from . import utils


def make_request_validator(
    verify_message_signature,
) -> Callable[[Request], Awaitable[None]]:
    """Stateless REQUEST validation (reference makeRequestValidator,
    core/request.go:146-150): just the client signature."""

    async def validate_request(request: Request) -> None:
        await verify_message_signature(request)

    return validate_request


def make_request_processor(
    capture_seq,
    pending_requests,
    view_state,
    apply_request,
) -> Callable[[Request], Awaitable[bool]]:
    """Stateful REQUEST processing (reference makeRequestProcessor,
    core/request.go:155-178): capture seq (False = duplicate), track
    pending, snapshot the view, apply."""

    async def process_request(request: Request) -> bool:
        if request.is_fast_read:
            # FAST reads are answered by the client-stream path and must
            # never be ordered: a peer forwarding one (or a faulty client
            # broadcasting it into the ordering path) would otherwise
            # spend the seq on a request the client signed as unordered.
            # Ordered reads (read_mode=2) proceed normally.
            return False
        new = await capture_seq(request)
        if not new:
            return False
        pending_requests.add(request)
        # Apply under the view read-lease (the reference holds the view
        # across applyRequest, request.go:166-175).
        async with view_state.hold_view_lease() as (view, _):
            await apply_request(request, view)
        return True

    return process_request


def make_request_applier(
    replica_id: int,
    n: int,
    propose,
    start_prepare_timer,
    start_request_timer,
) -> Callable[[Request, int], Awaitable[None]]:
    """Apply a captured REQUEST in a view (reference makeRequestApplier,
    core/request.go:180-198): the primary proposes the request for a
    (batched) PREPARE; a backup starts the prepare timer
    (forward-to-primary fallback) — both start the request (view-change)
    timer."""

    async def apply_request(request: Request, view: int) -> None:
        start_request_timer(request, view)
        if utils.is_primary(view, replica_id, n):
            await propose(request, view)
        else:
            start_prepare_timer(request, view)

    return apply_request


def make_request_executor(
    replica_id: int,
    retire_seq,
    pending_requests,
    stop_timers,
    consumer: api.RequestConsumer,
    sign_message_async,
    add_reply,
    log=None,
    metrics=None,
    trace_execute=None,
    trace_reply_sign=None,
) -> Callable[[Request], Awaitable[None]]:
    """Execute a committed REQUEST exactly once (reference
    makeRequestExecutor, core/request.go:211-231): retire the seq (dedup),
    clear timers and pending state, deliver to the state machine, sign and
    buffer the REPLY.

    ``sign_message_async`` is the AWAITABLE signer, and the REPLY is
    signed OFF the execution chain: executions are strictly ordered
    (commit.py ``_drain`` holds its exec lock across ``deliver``), so
    awaiting a sign-queue round trip inline would serialize signature
    latency into the chain and pin the sign batches at size 1.  Instead
    each execution spawns its sign-and-buffer as a task and moves on —
    consecutive executions co-batch their REPLY signatures on the
    engine's sign queue (the DSig-style off-critical-path
    restructuring).

    BUFFERING stays in execution order even though SIGNING is concurrent:
    each spawned task waits for its PER-CLIENT predecessor before
    ``add_reply``.  ClientState.add_reply accepts out-of-order seqs (a
    reordering network legitimately executes a higher seq first under
    exact retirement), but its reply WINDOW is bounded: if sign batches
    resolved out of order and more than a window's worth of later
    replies buffered first, the window floor would pass the earlier seq
    and its reply would be dropped as pruned — permanently, since a
    retransmitted REQUEST dedups at retire_seq and can only re-serve a
    buffered reply.  Ordered buffering closes that window-overflow loss
    entirely.  The chain is keyed by client_id — the window is a
    per-client structure, and a global chain would let one hung sign
    batch (90s dispatch timeout) delay every OTHER client's
    already-signed replies.  It costs nothing in batching — every sign
    is already submitted to the queue before any completion is awaited.

    A REPLY whose batched signature fails (a kernel error or a dispatch
    timeout on the engine) is logged at ERROR and lost on this replica;
    it is never re-signed on the host, which would turn the card's work
    into host work.  The other replicas' f+1 REPLYs carry the client (a
    retransmitted REQUEST dedups at retire_seq and can only re-serve a
    buffered reply).

    Returns True iff the request was actually delivered this call.  A
    re-proposed request re-drained after a view change early-returns False
    — callers counting executions (metrics, the checkpoint period, which
    must stay a deterministic global sequence number across replicas) must
    only count on True, or replicas that executed pre-transition would
    count a request twice while others count once.

    ``trace_execute`` / ``trace_reply_sign`` are the flight recorder's
    stage callbacks (obs/trace.py) — None when tracing is off, so the
    hot path pays one predicated check each."""
    # Strong refs for the in-flight sign-and-buffer tasks (discarded by
    # their done-callback) — a GC'd task would silently drop a REPLY.
    sign_tasks: set = set()
    # Per-client buffering-chain tails (see the docstring): execution
    # order in, add_reply order out.  O(known clients) — same growth as
    # the client_states map itself.
    chain_tails: Dict[int, object] = {}

    async def execute_request(request: Request) -> bool:
        if not retire_seq(request):
            return False  # already executed (reference request.go:214-218)
        pending_requests.remove(request)
        stop_timers(request)
        error = False
        if request.is_read:
            # An ORDERED read (read_mode=2, the fast read's fallback):
            # consensus fixes its place in the order — that is the
            # linearization point — but execution must not mutate state.
            # Deterministic across replicas: same slot -> same committed
            # state -> same query result (also under log replay).
            try:
                result = await consumer.query(request.operation)
            except Exception as e:
                # A SIGNED error reply on any query failure
                # (NotImplementedError = the deployment cannot serve
                # reads; anything else = a consumer bug on
                # CLIENT-CONTROLLED operation bytes, which must not
                # detonate in the execution chain behind committed
                # writes).  NO reply would park every replica-side
                # reply_for waiter on this seq forever — retransmissions
                # then pile parked tasks onto the stream's bounded
                # concurrency slots until the client's stream wedges.  A
                # fabricated plain b"" would be indistinguishable from a
                # real empty result; the error flag keeps it honest (the
                # client raises ReadOnlyQueryError on an error quorum).
                # State is untouched; checkpoint digests stay aligned
                # even if the failure is replica-local.
                error = True
                result = b""
                if log is not None:
                    log.warning(
                        "ordered read failed: %r (op %r...)",
                        e,
                        request.operation[:32],
                    )
                if metrics is not None:
                    metrics.inc("readonly_query_errors")
        else:
            result = await consumer.deliver(request.operation)
        if trace_execute is not None:
            trace_execute(request)
        reply = Reply(
            replica_id=replica_id,
            client_id=request.client_id,
            seq=request.seq,
            result=result,
            read_only=request.is_read,
            error=error,
        )

        prev = chain_tails.get(request.client_id)

        async def sign_and_buffer() -> None:
            signed = False
            try:
                await sign_message_async(reply)
                signed = True
                if trace_reply_sign is not None:
                    trace_reply_sign(reply)
            except Exception:
                # Only this reply is lost (see the docstring), never the
                # execution chain behind it.
                if log is not None:
                    log.exception(
                        "batched REPLY signing failed for client %d seq %d"
                        "; this replica's REPLY is lost",
                        reply.client_id,
                        reply.seq,
                    )
            if prev is not None:
                # Buffer in execution order (see the factory docstring);
                # a predecessor's failure or teardown-cancellation must
                # not unbuffer THIS reply.
                try:
                    await prev
                except (Exception, asyncio.CancelledError):
                    pass
            if signed:
                add_reply(reply)

        task = asyncio.get_running_loop().create_task(sign_and_buffer())
        chain_tails[request.client_id] = task
        sign_tasks.add(task)
        task.add_done_callback(sign_tasks.discard)
        return True

    return execute_request


def make_request_replier(
    client_states,
) -> Callable[[Request], Awaitable[Reply]]:
    """Await the REPLY for a REQUEST (reference makeRequestReplier,
    core/request.go:202-207 → clientstate reply subscription)."""

    async def reply_request(request: Request) -> Reply:
        return await client_states.client(request.client_id).reply_for(request.seq)

    return reply_request


def make_seq_capturer(client_states) -> Callable[[Request], Awaitable[bool]]:
    """Per-client seq capture (reference captureSeq, core/request.go:235-246)."""

    async def capture_seq(request: Request) -> bool:
        return await client_states.client(request.client_id).capture_request_seq(
            request.seq
        )

    return capture_seq


def make_seq_releaser(client_states) -> Callable[[Request], Awaitable[None]]:
    async def release_seq(request: Request) -> None:
        await client_states.client(request.client_id).release_request_seq(request.seq)

    return release_seq


def make_seq_preparer(client_states) -> Callable[[Request], None]:
    """Mark a request prepared (reference prepareSeq, core/request.go:248-259)."""

    def prepare_seq(request: Request) -> None:
        client_states.client(request.client_id).prepare_request_seq(request.seq)

    return prepare_seq


def make_seq_retirer(client_states) -> Callable[[Request], bool]:
    """Retire an executed request's seq (reference retireSeq,
    core/request.go:261-276)."""

    def retire_seq(request: Request) -> bool:
        return client_states.client(request.client_id).retire_request_seq(request.seq)

    return retire_seq
