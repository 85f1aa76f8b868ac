"""Message handling: the processing graph and stream pumps.

Reference core/message-handling.go — ``defaultMessageHandlers`` builds a
~30-closure processing graph; here :func:`build_handlers` wires the same
pipeline stages (validate → process → apply, with the generated-message
path assigning UIs under a lock and fanning out through the message log).

Asyncio re-design notes:

- Each connection is a pair of async streams instead of goroutine pairs
  (reference makeMessageStreamHandler, startPeerConnection).
- **Validation awaits batched GPU verification** (the reference's serial
  validate-then-process at message-handling.go:363-377 becomes
  submit-batch-then-resolve): concurrent validations of different messages
  coalesce in the :class:`minbft_tpu_torch.parallel.BatchVerifier`.
- Stateful processing (UI capture, seq capture, quorum accounting) stays
  sequential per peer/client exactly as the reference's condvar-guarded
  state packages require — batching never reorders *effects*.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import OrderedDict
from typing import AsyncIterator, Dict, Optional

from .. import api
from ..messages import (
    CERTIFIED_MESSAGES,
    Busy,
    Checkpoint,
    Commit,
    Hello,
    LogBase,
    Message,
    NewView,
    Prepare,
    ReqViewChange,
    Reply,
    Request,
    SnapshotReq,
    SnapshotResp,
    StateChunk,
    StateDone,
    StateReq,
    UNICAST_LOG_MESSAGES,
    ViewChange,
    authen_bytes,
    drain_multi,
    marshal,
    split_multi,
    stringify,
    unmarshal,
    unmarshal_batch,
)
from ..messages.codec import CodecError
from ..messages.authen import collection_digest as authen_collection_digest
from . import admission as admission_mod
from . import commit as commit_mod
from . import prepare as prepare_mod
from . import request as request_mod
from . import timeout as timeout_mod
from . import checkpoint as checkpoint_mod
from . import usig_ui, utils
from . import viewchange as viewchange_mod
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..recovery import manager as recovery_mod
from ..recovery import store as recovery_store
from ..recovery import transfer as recovery_transfer
from ..utils.backoff import ReconnectBackoff
from ..utils.metrics import ReplicaMetrics
from .internal.clientstate import ClientStates
from .internal.messagelog import MessageLog
from .internal.peerstate import PeerStates
from .internal.requestlist import RequestList
from .internal.viewstate import ViewState


class _PrepareBatcher:
    """Groups the primary's captured requests into batched PREPAREs.

    Request batching is an unimplemented roadmap item in the reference
    (reference README.md:505, one request per PREPARE); here the primary
    coalesces requests that arrive within the same event-loop turn (up to
    ``max_batch``) into one PREPARE — one USIG counter value, one
    PREPARE/COMMIT round, and one set of UI verifications for the whole
    batch.  Ship-when-idle: a lone request flushes on the next loop turn,
    so low-load latency is unchanged."""

    def __init__(
        self, replica_id: int, handle_generated, spawn, max_batch: int = 64
    ):
        self.replica_id = replica_id
        self.max_batch = max(1, max_batch)
        self._handle_generated = handle_generated
        # Task factory honoring the _bg_tasks retention contract
        # (Handlers._spawn_bg): a flush task nobody holds is GC-able
        # mid-PREPARE and its failure vanishes.
        self._spawn = spawn
        self._buffers: Dict[int, list] = {}  # view -> pending requests
        self._suspended = 0

    async def propose(self, request: Request, view: int) -> None:
        buf = self._buffers.setdefault(view, [])
        buf.append(request)
        if self._suspended:
            return  # resume() flushes
        if len(buf) >= self.max_batch:
            self._flush(view)
        elif len(buf) == 1:
            asyncio.get_running_loop().call_soon(self._flush, view)

    def suspend(self) -> None:
        """Hold flushes — the view-change applier suspends proposals so the
        new view's re-proposals (S) are certified *before* any fresh
        request, then resumes.  Counted: concurrent transitions nest."""
        self._suspended += 1

    def resume(self, active_view: int) -> None:
        self._suspended -= 1
        if self._suspended:
            return
        for view in list(self._buffers):
            if view < active_view:
                # Abandoned-view proposals must not waste USIG counters
                # (a stale flush when this replica is primary again in
                # view v+n would even split its new view's CV sequence);
                # the buffered requests stay in the pending list, which
                # the view-change applier re-applies in the new view.
                del self._buffers[view]
            else:
                self._flush(view)

    def _flush(self, view: int) -> None:
        if self._suspended:
            return
        buf = self._buffers.get(view)
        if not buf:
            return
        self._buffers[view] = []
        prepare = Prepare(
            replica_id=self.replica_id, view=view, requests=tuple(buf)
        )
        # UI assignment order = task creation order (handle_generated's UI
        # lock wakes waiters FIFO), so batches hit the log in flush order.
        self._spawn(self._handle_generated(prepare))


class Handlers:
    """The wired processing graph (what ``defaultMessageHandlers`` returns,
    reference core/message-handling.go:128-200)."""

    def __init__(
        self,
        replica_id: int,
        n: int,
        f: int,
        configer: api.Configer,
        authenticator: api.Authenticator,
        consumer: api.RequestConsumer,
        message_log: MessageLog,
        unicast_logs: Dict[int, MessageLog],
        client_states: ClientStates,
        logger: Optional[logging.Logger] = None,
        group: Optional[int] = None,
        recovery: Optional["recovery_mod.RecoveryManager"] = None,
    ):
        self.replica_id = replica_id
        self.n = n
        self.f = f
        # Consensus-group id when this core is one of a GroupRuntime's G
        # instances (minbft_tpu/groups): pure observability — it labels
        # the metrics and the flight recorder so per-group cost tables
        # and Prometheus series stay separable on shared transport.
        self.group = group
        self.configer = configer
        self.authenticator = authenticator
        self.consumer = consumer
        self.log = logger or utils.make_logger(replica_id)
        self.message_log = message_log
        self.unicast_logs = unicast_logs
        self.client_states = client_states
        self.peer_states = PeerStates()
        self.view_state = ViewState()
        self.pending = RequestList()
        # Per-peer view-change bar: highest new_view of a VIEW-CHANGE (or
        # NEW-VIEW) processed from each peer.  A peer that voted for view
        # v' froze its log evidence in that VIEW-CHANGE; anything it
        # certifies *afterwards* for a view < v' is outside every
        # NEW-VIEW quorum log, so counting it toward a commit quorum
        # could execute a request the re-proposal set S omits (ledger
        # fork, reachable at f >= 2 with adversarial delivery).  This is
        # the receive-side analogue of "stop sending after voting"
        # (in_transition gates our own sends).  O(n) ints, never pruned.
        self._peer_vc_bar: Dict[int, int] = {}
        self._ui_lock = asyncio.Lock()
        self.metrics = ReplicaMetrics(group=group)
        # Flight recorder (obs/trace.py): per-request stage spans into a
        # preallocated ring + per-stage histograms.  None unless the
        # operator opted in (configer.trace, or the MINBFT_TRACE /
        # MINBFT_TRACE_DUMP env knobs) — every hook below is then ONE
        # predicated attribute check (`if tr is not None`), the
        # disabled-cost contract.
        self.trace = (
            obs_trace.FlightRecorder.for_replica(replica_id, group=group)
            if (getattr(configer, "trace", False) or obs_trace.tracing_enabled())
            else None
        )
        # Latency-SLO budget ledger (obs/slo.py): recv-origin
        # good/breached classification at commit-quorum time against the
        # per-group finality budget.  None unless the operator opted in
        # (configer slo fields from consensus.yaml, or the MINBFT_SLO_*
        # env knobs) — every hook below is then ONE predicated attribute
        # check (`if sl is not None`), the flight recorder's
        # disabled-cost contract.
        self.slo = (
            obs_slo.BudgetLedger(
                obs_slo.SLOPolicy.from_env(group=group, configer=configer),
                group=group,
            )
            if obs_slo.slo_enabled(configer)
            else None
        )

        # Verified-check memo: a COMMIT re-validates its embedded PREPARE
        # (which re-validates the embedded REQUEST), so the same
        # (authen-bytes, tag) pair is verified up to n times per request.
        # Verification is a pure function of those bytes — a passed check is
        # cached (LRU), turning O(n²) verifies per request into O(n).
        # Failures are never cached.  (The reference re-verifies every time,
        # core/commit.go:74-92; this memo preserves its exact semantics.)
        self._verified: "OrderedDict[tuple, None]" = OrderedDict()
        self._verified_cap = 4 * 4096
        # dedup_verify=False (measurement mode, set via the configer)
        # disables this memo so every embedded re-validation actually
        # reaches the authenticator/engine — the reference's O(n²)
        # re-verification behavior, used by the bench's no-dedup phase to
        # report honest protocol-driven device verification rates.
        self._dedup_verify = getattr(configer, "dedup_verify", True)

        def _verified_hit(key: tuple) -> bool:
            if not self._dedup_verify:
                return False
            cache = self._verified
            if key in cache:
                cache.move_to_end(key)
                return True
            return False

        def _verified_put(key: tuple) -> None:
            if not self._dedup_verify:
                return
            cache = self._verified
            cache[key] = None
            if len(cache) > self._verified_cap:
                cache.popitem(last=False)

        # --- signing / verification primitives
        def sign_message(msg) -> None:
            # A REPLY (or BUSY shed signal) is addressed to one client:
            # recipient-specific schemes (MAC) key the tag to it;
            # signature schemes ignore it.
            audience = msg.client_id if isinstance(msg, (Reply, Busy)) else -1
            msg.signature = authenticator.generate_message_authen_tag(
                utils.signing_role(msg), authen_bytes(msg), audience
            )

        async def sign_message_async(msg) -> None:
            # The awaitable sibling for hot-path emission (REPLY signing):
            # concurrent executors co-batch their signatures on the
            # engine's sign queue instead of each paying a serial host
            # sign inline.  Control-plane messages (checkpoints,
            # view-change votes, HELLO) keep the synchronous path — their
            # rate never justifies a batch lane.  USIG certification is
            # untouched either way: the authenticator routes the USIG
            # role serially by design (counter-after-sign).
            audience = msg.client_id if isinstance(msg, (Reply, Busy)) else -1
            msg.signature = await authenticator.generate_message_authen_tag_async(
                utils.signing_role(msg), authen_bytes(msg), audience
            )

        async def verify_signature(msg) -> None:
            peer = msg.client_id if isinstance(msg, Request) else msg.replica_id
            role = utils.signing_role(msg)
            ab = authen_bytes(msg)
            key = (role, peer, ab, msg.signature)
            if _verified_hit(key):
                return
            await authenticator.verify_message_authen_tag(
                role, peer, ab, msg.signature
            )
            _verified_put(key)

        base_verify_ui = usig_ui.make_ui_verifier(authenticator)

        async def verify_ui(msg):
            ui = msg.ui
            if ui is None:
                raise api.AuthenticationError("missing UI")
            key = ("ui", msg.replica_id, authen_bytes(msg), ui.counter, ui.cert)
            if _verified_hit(key):
                return ui
            ui = await base_verify_ui(msg)
            _verified_put(key)
            return ui

        self.sign_message = sign_message
        self.sign_message_async = sign_message_async
        self.verify_signature = verify_signature
        self.verify_ui = verify_ui
        # Exposed for the bundle-ingest seed path (preverify_requests):
        # the seed must HIT the same verified-check memo as the
        # per-message path (already-verified requests are skipped from
        # the seed); feeding the memo stays the per-message path's job.
        self._verified_hit = _verified_hit
        self.assign_ui = usig_ui.make_ui_assigner(authenticator)
        self.capture_ui = usig_ui.make_ui_capturer(self.peer_states)

        # --- timers & view change
        self.request_view_change = timeout_mod.make_view_change_requestor(
            replica_id, self.view_state, sign_message, self._broadcast_signed
        )
        self.handle_request_timeout = timeout_mod.make_request_timeout_handler(
            self.request_view_change
        )

        # --- view-change protocol (beyond reference; core/viewchange.py)
        self.view_change_state = viewchange_mod.ViewChangeState(n, f, replica_id)
        self._viewchange_timeout = getattr(configer, "timeout_viewchange", 8.0)
        self._viewchange_timer = None
        self._viewchange_timer_view = 0  # the view the armed timer escalates
        self._timer_provider = client_states.timers

        def start_request_timer(req: Request, view: int) -> None:
            timeout = configer.timeout_request

            def on_expiry() -> None:
                self.metrics.inc("timeouts_request")
                self.log.warning(
                    "request timeout for client %d seq %d", req.client_id, req.seq
                )
                self._spawn_bg(self.handle_request_timeout(view))

            self.client_states.client(req.client_id).start_request_timer(
                req.seq, timeout, on_expiry
            )

        def start_prepare_timer(req: Request, view: int) -> None:
            timeout = configer.timeout_prepare

            def on_expiry() -> None:
                self.metrics.inc("timeouts_prepare")
                # Forward the starved request to the primary
                # (reference core/request.go:315-324).
                primary = view % n
                self.log.info(
                    "prepare timeout: forwarding request to primary %d", primary
                )
                self._unicast_append(primary, req)

            self.client_states.client(req.client_id).start_prepare_timer(
                req.seq, timeout, on_expiry
            )

        def stop_timers(req: Request) -> None:
            st = self.client_states.client(req.client_id)
            st.stop_request_timer(req.seq)
            st.stop_prepare_timer(req.seq)

        def stop_prepare_timer(req: Request) -> None:
            self.client_states.client(req.client_id).stop_prepare_timer(req.seq)

        # --- request pipeline
        raw_validate_request = request_mod.make_request_validator(verify_signature)

        if self.trace is not None:
            _vtr = self.trace

            async def base_validate_request(req: Request) -> None:
                # Flight-recorder capture point: the REQUEST is about to
                # be submitted for signature verification (recv→here =
                # dispatch and bookkeeping; here→verify_done = the
                # engine round trip including queue wait).
                _vtr.note(obs_trace.R_VERIFY_ENQUEUE, req.client_id, req.seq)
                await raw_validate_request(req)

        else:
            # Tracing off: the raw validator IS the validator — wrapping
            # unconditionally would put an extra coroutine frame on
            # every REQUEST's hot path just to test a None.
            base_validate_request = raw_validate_request

        # Object-level validation marker: the interned message objects (see
        # messages/codec.py) arrive repeatedly — a REQUEST via the client
        # stream, again inside the PREPARE, again inside every COMMIT; the
        # PREPARE again inside every COMMIT.  A *successful* validation is a
        # pure function of the message content AND this replica's trusted
        # keys/config, so the mark is keyed by a token unique to this
        # Handlers instance — never by replica id, which a restarted or
        # co-resident cluster would reuse with different keys (the interned
        # objects are process-global and outlive any one replica).
        # Failures are never recorded.
        vtoken = self._validation_token = object()

        # One marking idiom for every per-Handlers memo on interned message
        # objects (validation below, embedded processing in
        # _process_peer_message): the attribute holds a set of Handlers
        # tokens, never replica ids — see the keying rationale above.
        def _marked(msg, attr: str) -> bool:
            done = msg.__dict__.get(attr)
            return done is not None and vtoken in done

        def _set_mark(msg, attr: str) -> None:
            msg.__dict__.setdefault(attr, set()).add(vtoken)

        self._marked = _marked
        self._set_mark = _set_mark

        def _mark(msg) -> bool:
            """True if this Handlers already validated ``msg``."""
            return _marked(msg, "_validated_by")

        def _record(msg) -> None:
            _set_mark(msg, "_validated_by")

        def _cached_validator(base):
            async def validate_cached(msg) -> None:
                if _mark(msg):
                    return
                await base(msg)
                _record(msg)

            return validate_cached

        self.validate_request = _cached_validator(base_validate_request)
        capture_seq = request_mod.make_seq_capturer(self.client_states)
        self.release_seq = request_mod.make_seq_releaser(self.client_states)
        prepare_seq = request_mod.make_seq_preparer(self.client_states)
        retire_seq = request_mod.make_seq_retirer(self.client_states)

        def add_reply(reply: Reply) -> None:
            self.client_states.client(reply.client_id).add_reply(reply.seq, reply)

        # Flight-recorder stage callbacks for the pipeline factories:
        # plain callables (None when tracing is off) so the factories
        # stay recorder-agnostic and their hot paths pay one predicated
        # check each.
        if self.trace is not None:
            _tr = self.trace

            def trace_prepare(req: Request) -> None:
                _tr.note(obs_trace.R_PREPARE, req.client_id, req.seq)

            def trace_quorum(req: Request) -> None:
                _tr.note(obs_trace.R_COMMIT_QUORUM, req.client_id, req.seq)

            def trace_execute(req: Request) -> None:
                _tr.note(obs_trace.R_EXECUTE, req.client_id, req.seq)

            def trace_reply_sign(reply: Reply) -> None:
                _tr.note(obs_trace.R_REPLY_SIGN, reply.client_id, reply.seq)

        else:
            trace_prepare = trace_quorum = None
            trace_execute = trace_reply_sign = None

        if self.slo is not None:
            # Chain the budget classifier onto the commit-quorum capture
            # point: the pipeline factories still see ONE callable (and
            # pay one predicated check when both recorder and SLO are
            # off — the callable stays None).
            _sl = self.slo
            _tq = trace_quorum

            def trace_quorum(req: Request) -> None:  # noqa: F811
                if _tq is not None:
                    _tq(req)
                _sl.commit(req.client_id, req.seq)

        base_execute = request_mod.make_request_executor(
            replica_id,
            retire_seq,
            self.pending,
            stop_timers,
            consumer,
            sign_message_async,
            add_reply,
            log=self.log,
            metrics=self.metrics,
            trace_execute=trace_execute,
            trace_reply_sign=trace_reply_sign,
        )

        # Checkpointing (phase 1 + 2 — core/checkpoint.py): every
        # checkpoint_period delivered requests, at a batch boundary, sign
        # and broadcast a CHECKPOINT of the composite state digest with
        # per-peer coverage bounds; f+1 matching claims make it stable,
        # stability licenses log truncation, and the retained snapshot
        # serves state transfer.  All replicas emit — checkpoints are
        # signed, not USIG-certified, so the primary's prepare-CV sequence
        # is untouched.
        self.checkpoint_collector = checkpoint_mod.CheckpointCollector(
            f, logger=self.log
        )
        self.coverage = checkpoint_mod.CoverageTracker()
        self.validate_checkpoint_cert = checkpoint_mod.make_cert_validator(
            f, verify_signature
        )
        # Own-log truncation state: counters 1..base are dropped from the
        # broadcast log, vouched by cert (f+1 claims with our coverage
        # bound >= base).  Mirrored into every VIEW-CHANGE we emit.
        self._own_log_base: tuple = (0, ())
        # Execution position (view, cv) at the last batch boundary, and
        # the pending state-transfer bookkeeping.
        self._exec_pos = (0, 0)
        self._snapshot_expect: Optional[Checkpoint] = None
        self._snapshot_sources: list = []  # claimants left to try
        self._snapshot_timer = None
        # Chunked resumable state transfer (recovery subsystem): the
        # assembler for the in-flight STATE-CHUNK stream, the peer it was
        # requested from, and the verified offset at the last retry-timer
        # fire (progress since then means resume-from-offset on the SAME
        # source; no progress means fail over to the next one).
        self._state_asm: Optional[recovery_transfer.ChunkAssembler] = None
        self._state_source: Optional[int] = None
        self._state_progress = 0
        # Recovery telemetry + durable store handle (None = durability and
        # recovery SLOs off; every hook below is one predicated check).
        self.recovery = recovery
        self._pending_new_view: Optional[NewView] = None
        # Strong refs to fire-and-forget background tasks (the deferred
        # NEW-VIEW re-check): discarded by their done-callback.
        self._bg_tasks: set = set()
        self._logsize = getattr(configer, "logsize", 0)
        # Truncation requires state transfer to exist: dropping/stubbing
        # covered history strands any replica that later needs it unless
        # a certified snapshot can replace it.  Consumers without
        # snapshot support still checkpoint (stability, covered-gap
        # acceptance) but never GC.
        self._can_snapshot = (
            type(consumer).snapshot is not api.RequestConsumer.snapshot
        )
        # Swapped + fired whenever the local stable checkpoint advances
        # (stabilization, LOG-BASE / NEW-VIEW certificate adoption) —
        # lets stub acceptance wait out the tiny race where a stub task
        # overtakes the LOG-BASE task on the same stream.
        self._stable_event = asyncio.Event()

        async def emit_signed_checkpoint(cp: Checkpoint) -> None:
            sign_message(cp)
            self.metrics.inc("checkpoints_sent")
            # Record our own claim directly (it also rides the broadcast
            # log to peers; the own-message loop dedups via the
            # collector's newest-claim rule).
            if self.checkpoint_collector.record(cp):
                self._on_checkpoint_stable()
            self.message_log.append(cp)

        self.checkpoint_emitter = checkpoint_mod.CheckpointEmitter(
            replica_id,
            getattr(configer, "checkpoint_period", 0),
            consumer,
            client_states.retire_watermarks,
            self.coverage.bounds_at,
            emit_signed_checkpoint,
        )

        async def execute_counted(req: Request) -> None:
            t0 = time.monotonic()
            delivered = await base_execute(req)
            if not delivered:
                # Already retired (a re-proposed request re-drained after a
                # view change): counting it would diverge the execution
                # count — and so the checkpoint sequence — across replicas
                # that did/didn't execute it pre-transition.
                self.log.info(
                    "skipping already-retired request client %d seq %d",
                    req.client_id,
                    req.seq,
                )
                return
            self.metrics.observe_execute(time.monotonic() - t0)
            self.metrics.inc("requests_executed")
            if self.recovery is not None:
                # Stops the restart-to-first-executed-request clock; cheap
                # no-op on every execution after the first.
                self.recovery.note_executed()
            self.checkpoint_emitter.on_delivered()

        self.execute_request = execute_counted

        async def on_batch_end(view: int, cv: int) -> None:
            self._exec_pos = (view, cv)
            await self.checkpoint_emitter.on_batch_end(view, cv)
            if self._pending_new_view is not None:
                # Ordinary log replay can carry the checkpoint count past
                # a deferred NEW-VIEW's anchor without any snapshot ever
                # installing.  Applying advances the view, which drains
                # the read lease this execution path runs under — so the
                # re-check must run as its own task, outside the lease.
                # The event loop holds only a WEAK reference to running
                # tasks: keep a strong one until done, and
                # route the deliberately re-raised apply failure to the
                # log instead of the unretrieved-exception void.
                task = asyncio.get_running_loop().create_task(
                    self._maybe_apply_pending_new_view()
                )
                self._bg_tasks.add(task)
                task.add_done_callback(self._on_bg_task_done)

        self._prepare_batcher = _PrepareBatcher(
            replica_id,
            self.handle_generated,
            self._spawn_bg,
            max_batch=getattr(configer, "batchsize_prepare", 64),
        )

        self.apply_request = request_mod.make_request_applier(
            replica_id,
            n,
            self._prepare_batcher.propose,
            start_prepare_timer,
            start_request_timer,
        )

        async def _process_request_apply(req: Request, view: int) -> None:
            try:
                await self.apply_request(req, view)
            finally:
                await self.release_seq(req)

        self.process_request = request_mod.make_request_processor(
            capture_seq, self.pending, self.view_state, _process_request_apply
        )

        # --- commit pipeline / quorum (instance kept visible so tests can
        # assert its containers stay bounded)
        self.commitment_collector = commit_mod.CommitmentCollector(
            f, self.execute_request, on_batch_end=on_batch_end,
            trace_quorum=trace_quorum,
        )

        async def collect_counted(peer_id: int, prepare: Prepare) -> None:
            self.metrics.inc("commitments_counted")
            await self.commitment_collector.collect(peer_id, prepare)

        self.collect_commitment = collect_counted
        self.apply_commit = commit_mod.make_commit_applier(self.collect_commitment)

        # --- prepare pipeline
        base_apply_prepare = prepare_mod.make_prepare_applier(
            replica_id,
            prepare_seq,
            self.collect_commitment,
            self.handle_generated,
            stop_prepare_timer,
            trace_prepare=trace_prepare,
        )

        async def apply_prepare_counted(prepare: Prepare) -> None:
            await base_apply_prepare(prepare)
            self.metrics.inc("prepares_accepted")

        self.apply_prepare = apply_prepare_counted
        self.validate_prepare = _cached_validator(
            prepare_mod.make_prepare_validator(
                n, self.validate_request, self.verify_ui
            )
        )
        self.validate_commit = commit_mod.make_commit_validator(
            n, self.validate_prepare, self.verify_ui
        )
        self.validate_view_change = _cached_validator(
            viewchange_mod.make_view_change_validator(
                verify_ui, self.validate_checkpoint_cert
            )
        )
        self.validate_new_view = _cached_validator(
            viewchange_mod.make_new_view_validator(
                n, f, verify_ui, self.validate_view_change
            )
        )

        self.reply_request = request_mod.make_request_replier(self.client_states)

    # ------------------------------------------------------------------
    # Generated own messages (reference makeGeneratedMessageHandler /
    # makeGeneratedMessageConsumer, core/message-handling.go:552-587).

    async def handle_generated(self, msg: Message) -> None:
        """Assign a UI under the global UI lock (serialized — USIG counters
        must match log order) and append to the broadcast log."""
        async with self._ui_lock:
            if isinstance(msg, CERTIFIED_MESSAGES):
                if msg.ui is None:  # emit_view_change/emit_checkpoint
                    self.assign_ui(msg)  # pre-assign under this same lock
                if isinstance(msg, (Prepare, Commit)):
                    self.metrics.inc(
                        "prepares_sent"
                        if isinstance(msg, Prepare)
                        else "commits_sent"
                    )
            self.message_log.append(msg)

    def _broadcast_signed(self, msg: Message) -> None:
        """Broadcast a signed (non-certified) own message."""
        self.message_log.append(msg)

    # ------------------------------------------------------------------
    # Validation dispatch (reference validateMessage,
    # core/message-handling.go:409-424).

    async def validate_message(self, msg: Message) -> None:
        if isinstance(msg, Request):
            await self.validate_request(msg)
        elif isinstance(msg, Prepare):
            await self.validate_prepare(msg)
        elif isinstance(msg, Commit):
            await self.validate_commit(msg)
        elif isinstance(msg, ReqViewChange):
            await self.verify_signature(msg)
        elif isinstance(msg, ViewChange):
            await self.validate_view_change(msg)
        elif isinstance(msg, NewView):
            await self.validate_new_view(msg)
        elif isinstance(
            msg,
            (Checkpoint, SnapshotReq, SnapshotResp, StateReq, StateChunk, StateDone),
        ):
            await self.verify_signature(msg)
        elif isinstance(msg, LogBase):
            await self._validate_log_base(msg)
        else:
            raise api.AuthenticationError(f"unexpected message {stringify(msg)}")

    def preverify_requests(self, msgs) -> int:
        """Seed the engine verify queue with a decoded ingest bundle's
        outstanding client-signature checks in ONE batch call; returns
        the number of checks seeded.

        This is deliberately fire-and-forget, NOT a barrier: the caller
        fans the bundle out immediately, and each message's ordinary
        ``validate_request`` submits the same engine item moments later —
        which COALESCES onto the in-flight lane the seed opened
        (``_SchemeQueue._inflight_futs``), so the whole bundle dispatches
        as one engine batch while per-message validation keeps its exact
        semantics (failures raise item-wise on the per-message path, the
        verified-check memo is fed there, nothing double-verifies).
        Awaiting the batch here instead was measured to CHOP the
        pipeline's natural processing waves: ingest ticks serialized on
        engine round trips, requests reached the primary's proposer in
        bundle-sized groups, and PREPAREs shrank — more USIG signing
        (serial by design) and thinner UI-verify batches.

        Skipped entirely (returns 0) in the no-dedup measurement mode:
        with the engine's in-flight coalescing off, every seeded check
        would occupy a SECOND device lane and the reported device rate
        would no longer equal protocol demand.
        """
        if not self._dedup_verify:
            return 0
        if not getattr(self.authenticator, "supports_batch_verify", False):
            # No engine behind the batch surface: a seed would verify
            # everything twice on the serial loop for no coalescing win.
            return 0
        verify_many = self.authenticator.verify_message_authen_tags
        # No trace notes and no validation marks here: the per-message
        # path still walks its full recv -> verify_enqueue -> verify_done
        # span sequence AND its own memo checks (a memo-hit request is
        # merely skipped from the seed — marking it validated here would
        # short-circuit the per-message verify_enqueue note and skew the
        # stage table on exactly the path this runtime exists to measure).
        role = None
        items: list = []
        for m in msgs:
            if not isinstance(m, Request):
                continue
            if self._marked(m, "_validated_by"):
                continue
            ab = authen_bytes(m)
            role = utils.signing_role(m)
            if self._verified_hit((role, m.client_id, ab, m.signature)):
                continue
            items.append((m.client_id, ab, m.signature))
        if not items:
            return 0

        async def seed() -> None:
            # Verdicts are consumed by the per-message validations that
            # coalesced onto these lanes; engine errors surface THERE
            # with full per-message handling, so the seed itself only
            # has to avoid dying loudly.
            try:
                await verify_many(role, items)
            except Exception:  # pragma: no cover - engine failure path
                pass

        task = asyncio.get_running_loop().create_task(seed())
        self._bg_tasks.add(task)
        task.add_done_callback(self._on_bg_task_done)
        return len(items)

    async def _validate_log_base(self, lb: LogBase) -> None:
        """A LOG-BASE claim is exactly its certificate: f+1 matching
        signed checkpoints, each attesting a coverage bound for the
        sender at or above the announced base.  base == 0 is a pure
        certificate announcement (nothing dropped yet, but the stream
        carries stubs the certificate covers)."""
        await self.validate_checkpoint_cert(lb.cert)
        if lb.base > 0 and min(
            c.bound_for(lb.replica_id) for c in lb.cert
        ) < lb.base:
            raise api.AuthenticationError(
                "LOG-BASE base exceeds the certified coverage bounds"
            )

    # ------------------------------------------------------------------
    # Processing dispatch (reference processMessage / processPeerMessage /
    # processViewMessage, core/message-handling.go:426-533).

    async def process_message(self, msg: Message) -> bool:
        if isinstance(msg, Request):
            return await self.process_request(msg)
        if isinstance(msg, CERTIFIED_MESSAGES):
            return await self._process_peer_message(msg)
        if isinstance(msg, ReqViewChange):
            # Beyond the reference (which refuses here, "Not implemented",
            # core/message-handling.go:419): demands are tallied and f+1
            # of them start the view-change transition.
            return await self._process_req_view_change(msg)
        if isinstance(msg, Checkpoint):
            return self._process_checkpoint(msg)
        if isinstance(msg, LogBase):
            return await self._process_log_base(msg)
        if isinstance(msg, SnapshotReq):
            return await self._process_snapshot_req(msg)
        if isinstance(msg, SnapshotResp):
            return await self._process_snapshot_resp(msg)
        if isinstance(msg, StateReq):
            return await self._process_state_req(msg)
        if isinstance(msg, StateChunk):
            return await self._process_state_chunk(msg)
        if isinstance(msg, StateDone):
            return await self._process_state_done(msg)
        raise ValueError(f"unexpected message {stringify(msg)}")

    async def _process_peer_message(self, msg) -> bool:
        if isinstance(msg, (ViewChange, NewView)):
            # Certified view-change messages ride the same per-peer
            # counter-ordered capture, but apply outside the view lease:
            # NEW-VIEW application *advances* the view, which drains the
            # lease it would otherwise hold.
            if not await self.capture_ui(msg):
                return False
            if self.checkpoint_emitter.period > 0:
                self.coverage.track(msg.replica_id, msg.ui.counter, msg)
            # Raise the sender's bar unconditionally (even for votes
            # outside the demand window): per-peer capture order means
            # every later message from this peer was certified after
            # this vote.
            if msg.new_view > self._peer_vc_bar.get(msg.replica_id, 0):
                self._peer_vc_bar[msg.replica_id] = msg.new_view
            if isinstance(msg, ViewChange):
                return await self._apply_view_change(msg)
            return await self._apply_new_view(msg)

        msg_view = msg.view if isinstance(msg, Prepare) else msg.prepare.view

        p = msg if isinstance(msg, Prepare) else msg.prepare
        if p.is_stub:
            # Checkpoint-covered stub from a truncated log replay: its
            # counter slot must be captured (gap-free per-peer
            # sequencing), but it is NEVER applied — executing a stub
            # would let full-vs-stub encodings of one UI (they share
            # authen bytes by construction) diverge replicas, and an
            # up-to-date replica needs nothing from covered history.
            #
            # Capture is gated on the LOCAL stable checkpoint actually
            # covering the stub's batch: an honest sender's stream
            # carries its LOG-BASE certificate ahead of its stubs (the
            # short wait absorbs task-ordering races), while a Byzantine
            # peer stubbing LIVE batches — trying to blind this replica
            # to a batch by consuming its capture slot with the stub
            # encoding — is refused without capture, wedging only the
            # liar's own stream (its un-applied proposals then time out
            # into a view change).
            if not await self._wait_covered(p.view, p.ui.counter):
                raise api.AuthenticationError(
                    f"stub for uncovered batch (view {p.view} cv "
                    f"{p.ui.counter}) refused"
                )
            if isinstance(msg, Commit):
                await self._process_peer_message(msg.prepare)
            if not await self.capture_ui(msg):
                return False
            if self.checkpoint_emitter.period > 0:
                self.coverage.track(msg.replica_id, msg.ui.counter, msg)
            return False

        cur, _ = await self.view_state.hold_view()
        if msg_view > cur:
            # A message from a view this replica hasn't entered yet (its
            # NEW-VIEW is still in flight): park until the transition
            # catches up instead of consuming the peer's counter and
            # losing the message.  Bounded: a claimed view that never
            # materializes drops out after the view-change timeout —
            # EXCEPT while a state transfer is pending, which will
            # advance the view (or keep retrying claimants): letting the
            # park expire mid-transfer would capture-and-refuse commits
            # for batches just above the incoming checkpoint, and the
            # acceptor would then see an uncovered per-peer CV gap for
            # the rest of the view.
            while True:
                try:
                    await asyncio.wait_for(
                        self.view_state.wait_current_at_least(msg_view),
                        max(self._viewchange_timeout, 1.0) * 2,
                    )
                    break
                except asyncio.TimeoutError:
                    if self._snapshot_expect is not None:
                        continue  # transfer in flight: keep parking
                    # The claimed view never materialized: fall through
                    # to the normal capture-then-refuse path rather than
                    # returning here — dropping WITHOUT capturing would
                    # leave a counter gap that wedges every later
                    # message from this peer.
                    self.metrics.inc("messages_dropped_future_view")
                    break

        # Process embedded messages first (reference processEmbedded,
        # core/message-handling.go:454-473).  A batched PREPARE embeds up
        # to batchsize requests and is itself embedded in every COMMIT —
        # naively that re-processes each request ~n+1 times per replica
        # (measured 8 process_request calls per request at n=7).  The
        # re-runs are pure no-ops (seq capture dedups), so the first
        # completed pass is recorded per Handlers (token-keyed like the
        # validation marker — interned objects are process-global) and
        # later carriers of the same PREPARE skip straight to UI capture.
        if isinstance(msg, Prepare):
            if not self._marked(msg, "_embedded_processed"):
                for req in msg.requests:
                    await self.process_request(req)
                self._set_mark(msg, "_embedded_processed")
        elif isinstance(msg, Commit):
            await self._process_peer_message(msg.prepare)

        if not await self.capture_ui(msg):
            return False  # already processed (replay)
        if self.checkpoint_emitter.period > 0:
            # Coverage bookkeeping feeds checkpoint bounds; with
            # checkpointing disabled nothing ever prunes it, so don't
            # let it grow with history.
            self.coverage.track(msg.replica_id, msg.ui.counter, msg)

        # View check + apply under one read lease (reference
        # processViewMessage holds the view, core/message-handling.go:
        # 492-533): apply suspends at awaits, and without the lease a view
        # advancement could interleave — a message checked in view v must
        # not apply in view v+1.
        async with self.view_state.hold_view_lease() as (view, _):
            if msg_view != view or self.view_change_state.in_transition(view):
                # stale view, or this replica voted for a view change (the
                # reference's !active state): captured but not applied —
                # the transition's VIEW-CHANGE logs carry the evidence.
                return False
            if msg_view < self._peer_vc_bar.get(msg.replica_id, 0):
                # The sender already voted for a higher view: this message
                # was certified after its VIEW-CHANGE, so no NEW-VIEW
                # quorum log can contain it — applying it here could
                # commit a request the re-proposal set S omits.
                return False

            if isinstance(msg, Prepare):
                if not self.view_change_state.check_reproposal(msg):
                    # The new primary deviated from the agreed re-proposal
                    # set S — refuse and demand its removal.
                    self.log.warning(
                        "new-view primary deviated from S: %s", stringify(msg)
                    )
                    await self.request_view_change(view + 1)
                    return False
                await self.apply_prepare(msg)
            else:
                await self.apply_commit(msg)
            return True

    # ------------------------------------------------------------------
    # Checkpointing: claim accounting, log truncation, state transfer
    # (phase 2 — core/checkpoint.py).

    def _process_checkpoint(self, cp: Checkpoint) -> bool:
        coll = self.checkpoint_collector
        before = coll.cert_version
        if coll.record(cp):
            self._on_checkpoint_stable()
        elif coll.cert_version != before:
            # A late claim genuinely grew the stable certificate — its
            # bounds may license a deeper truncation.  (No-op replays and
            # divergent claims change nothing and cost nothing.)
            self._maybe_truncate()
        return True

    def _on_checkpoint_stable(self) -> None:
        coll = self.checkpoint_collector
        self.metrics.inc("checkpoints_stable")
        self._note_stable_locally()
        self.log.info(
            "stable checkpoint at %d executions (view %d cv %d, digest %s)",
            coll.stable_count,
            coll.stable_view,
            coll.stable_cv,
            coll.stable_digest.hex()[:12],
        )
        self._maybe_truncate()
        self._spawn_durable_save()

    def _note_stable_locally(self) -> None:
        """Propagate a stable-watermark change: the commitment collector
        learns the covered-gap position and coverage waiters wake."""
        coll = self.checkpoint_collector
        self.commitment_collector.note_stable(
            coll.stable_view, coll.stable_cv
        )
        ev, self._stable_event = self._stable_event, asyncio.Event()
        ev.set()

    def _adopt_cert(self, cert) -> None:
        """Adopt an externally received (validated) stable certificate."""
        coll = self.checkpoint_collector
        before = coll.stable_count
        coll.install(cert)
        if coll.stable_count != before:
            self._note_stable_locally()

    async def _wait_covered(self, view: int, cv: int) -> bool:
        """True once the local stable checkpoint covers batch (view, cv);
        bounded wait — the honest case resolves as soon as the sender's
        LOG-BASE certificate (earlier on the same stream) is adopted, but
        certificate adoption can itself be slow (a cold verification
        engine's first kernel compile takes tens of seconds), so the
        bound matches the future-view park (2x the view-change timeout)
        rather than being aggressively short — a refused honest stub
        wedges its sender's whole capture stream.  Byzantine uncovered
        stubs pin at most the bounded per-stream concurrency slots for
        this long.  Honors a 0 view-change timeout (no wait, tests)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 2.0 * max(self._viewchange_timeout, 0.0)
        while True:
            coll = self.checkpoint_collector
            if (view, cv) <= (coll.stable_view, coll.stable_cv):
                return True
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False
            ev = self._stable_event
            try:
                # No shield: on timeout the inner wait() task must be
                # cancelled so its waiter leaves the long-lived Event
                # (a stub flood would otherwise accumulate one leaked
                # waiter per refusal).
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return False

    def _maybe_truncate(self) -> None:
        """Garbage-collect the broadcast log against the stable
        checkpoint: drop the provably-covered prefix (up to the coverage
        bound β the stable certificate attests for us), stub covered
        retained entries down to their digests, and install a LOG-BASE
        head so lagging subscribers fast-forward instead of wedging.
        Synchronous — atomic with respect to the event loop, so it can
        never interleave with the UI-locked log snapshot in
        emit_view_change."""
        coll = self.checkpoint_collector
        if coll.stable_count == 0 or not self._can_snapshot:
            # Without snapshot support there is no state transfer, and
            # truncated/stubbed history could strand a lagging replica
            # forever — keep the full log (see api.RequestConsumer).
            return
        beta, cert = coll.certificate_for_bound(self.replica_id, self.f + 1)
        if not cert:
            return
        v, cv = coll.stable_view, coll.stable_cv
        old_base, old_cert = self._own_log_base
        if beta < old_base:
            # The fresh certificate's bounds for us lag the base we have
            # ALREADY committed to (e.g. a new position stabilized first
            # through replicas that trail our stream): pairing the old
            # base with a cert that cannot prove it would get our honest
            # VIEW-CHANGE and LOG-BASE rejected everywhere.  Keep the old
            # certificate — and cap stubbing at ITS position, since the
            # head cert must cover every stub a fresh subscriber meets.
            cert = list(old_cert)
            beta = old_base
            v, cv = old_cert[0].view, old_cert[0].cv
        entries = self.message_log.snapshot()
        if self._logsize > 0 and len(entries) <= self._logsize:
            return  # operator asked to retain at least this much history
        # The droppable prefix: certified entries up to counter β that are
        # genuinely covered (belt and braces — β is already provably
        # covered by an honest attester), plus concluded signed messages.
        n_drop = 0
        base = self._own_log_base[0]
        for m in entries:
            if isinstance(m, CERTIFIED_MESSAGES) and m.ui is not None:
                cov = checkpoint_mod.entry_coverage(m)
                if m.ui.counter <= beta and checkpoint_mod.is_covered(
                    cov, v, cv
                ):
                    base = m.ui.counter
                    n_drop += 1
                    continue
                break
            if isinstance(m, LogBase):
                n_drop += 1
                continue
            if isinstance(m, Checkpoint) and m.count < coll.stable_count:
                n_drop += 1
                continue
            if isinstance(m, ReqViewChange) and m.new_view <= v:
                n_drop += 1
                continue
            break
        # Stub covered certified entries in the retained suffix (payload
        # -> digest under the same UI; O(1) per counter slot).
        stubbed = 0
        for i, m in enumerate(entries[n_drop:], start=n_drop):
            if not (isinstance(m, (Prepare, Commit)) and m.ui is not None):
                continue
            p = m if isinstance(m, Prepare) else m.prepare
            if p.is_stub:
                continue
            if not checkpoint_mod.is_covered(
                checkpoint_mod.entry_coverage(m), v, cv
            ):
                continue
            stub_p = Prepare(
                replica_id=p.replica_id,
                view=p.view,
                requests=(),
                ui=p.ui,
                requests_digest=authen_collection_digest(p.requests, p.requests_digest),
            )
            stub = (
                stub_p
                if isinstance(m, Prepare)
                else Commit(replica_id=m.replica_id, prepare=stub_p, ui=m.ui)
            )
            self.message_log.replace(i, stub)
            stubbed += 1
        # Always store the freshest certificate THAT PROVES THE BASE
        # alongside it: our next VIEW-CHANGE must carry a certificate at
        # the position the retained stubs were covered against, with
        # coverage bounds for us >= the base (both enforced by every
        # receiver).  The bound-maximizing cert proves any base <= beta.
        base = max(base, old_base)
        self._own_log_base = (base, tuple(cert))
        head = LogBase(replica_id=self.replica_id, base=base, cert=tuple(cert))
        if base > old_base:
            self.metrics.inc("log_truncations")
            self.message_log.truncate(n_drop, head=head)
            self.log.info(
                "log truncated to counter base %d (%d entries dropped, "
                "%d stubbed) at stable count %d",
                base,
                n_drop,
                stubbed,
                coll.stable_count,
            )
            return
        # No prefix advance, but the log carries (or just gained) stubs:
        # the replayed stream's head certificate must cover every stub a
        # fresh subscriber will meet, or — with f other replicas crashed —
        # it could never assemble f+1 claims for the stubs' position and
        # would wedge on the refused stub.  Refresh (or install) the head
        # in place.
        cert_pos = cert[0].count if cert else 0
        old_pos = old_cert[0].count if old_cert else -1
        # entries still mirrors the live log here (nothing was dropped on
        # this path, and stubbing never swaps in a LogBase).
        head_exists = bool(entries) and isinstance(entries[0], LogBase)
        if stubbed or (head_exists and cert_pos > old_pos):
            if head_exists:
                self.message_log.replace(0, head)
            elif base > 0 or stubbed:
                self.message_log.truncate(0, head=head)

    async def _process_log_base(self, lb: LogBase) -> bool:
        """A peer announced its log now starts above ``lb.base``
        (validated: f+1 certificate with coverage bounds >= base).  Adopt
        the certificate if it is ahead, fetch certified state if *we* are
        behind it, and fast-forward the peer's capture sequence so its
        retained suffix doesn't park on the intentional gap."""
        if lb.replica_id == self.replica_id:
            return True  # own announcement replayed by the own-message loop
        cp = lb.cert[0]
        self._adopt_cert(lb.cert)
        if self.checkpoint_emitter.count < cp.count:
            await self._request_state(lb.cert, first_source=lb.replica_id)
        # State-transfer TOFU: a late joiner never sees this peer's
        # counter-1 UI (the certificate proves that history is covered
        # and it was truncated) — permit first-contact epoch capture from
        # the first valid UI above the certified base, or the joiner
        # installs the snapshot and then rejects every live message.
        # Only while actually BEHIND the certificate: a caught-up replica
        # saw the history (or holds captured epochs), and a standing
        # floor would widen the stale-epoch re-pin window the counter-1
        # rule narrows (see reset_usig_epoch).
        if self.checkpoint_emitter.count < cp.count:
            allow = getattr(
                self.authenticator, "allow_epoch_capture_from", None
            )
            if allow is not None:
                allow(lb.replica_id, lb.base + 1)
        await self.peer_states.peer(lb.replica_id).fast_forward(lb.base + 1)
        return True

    async def _request_state(self, cert, first_source: Optional[int] = None) -> None:
        """Fetch the snapshot at the certificate's checkpoint.  One
        outstanding target at a time (a newer certificate re-targets);
        requests rotate on a retry timer through the certificate's
        claimants FIRST (they provably attested the state) and then every
        other peer — the certificate guarantees a correct attester, not a
        live one, and any replica at or past the checkpoint can serve the
        snapshot (a snapshot-less peer simply doesn't answer and the
        rotation moves on).  So no set of claimant crashes wedges the
        transfer."""
        cp = cert[0]
        prev = self._snapshot_expect
        if prev is not None and prev.count >= cp.count:
            return
        self._snapshot_expect = cp
        sources = [] if first_source in (None, self.replica_id) else [first_source]
        for c in cert:
            if c.replica_id != self.replica_id and c.replica_id not in sources:
                sources.append(c.replica_id)
        for p in self.unicast_logs:
            if p != self.replica_id and p not in sources:
                sources.append(p)
        self._snapshot_sources = sources
        # Re-targeting to a newer certificate abandons any partial stream
        # for the old one (the chunks verified so far belong to a snapshot
        # nobody needs anymore).
        self._state_asm = None
        self._state_source = None
        self._state_progress = 0
        if self.recovery is not None:
            self.recovery.set_phase(recovery_mod.PHASE_FETCHING)
        self._send_state_req()

    def _unicast_append(self, peer_id: int, msg) -> None:
        """THE unicast-log append point.  Only kinds in
        messages.UNICAST_LOG_MESSAGES may ride a unicast log — the
        signed-HELLO replay-harmlessness invariant is defined next to
        that tuple and holds only while every unicast kind is public,
        individually authenticated content.  Route new unicast traffic
        through here so the contract trips loudly, not silently."""
        if not isinstance(msg, UNICAST_LOG_MESSAGES):
            raise TypeError(
                f"{type(msg).__name__} is not a unicast-log kind — see "
                "messages.UNICAST_LOG_MESSAGES (HELLO replay invariant)"
            )
        ulog = self.unicast_logs.get(peer_id)
        if ulog is not None:
            ulog.append(msg)

    def _send_state_req(self, resume: bool = False) -> None:
        """Issue (or re-issue) the chunked STATE-REQ for the pending
        target.  ``resume=True`` keeps the CURRENT source and asks it to
        continue from the verified offset — the mid-transfer-reset path:
        every chunk already assembled was chain-verified, so nothing needs
        re-downloading.  ``resume=False`` rotates to the next source and
        restarts from offset 0 (fresh fetch, or failover after a stalled /
        corrupt stream)."""
        expect = self._snapshot_expect
        if expect is None or not self._snapshot_sources:
            return
        asm = self._state_asm
        if resume and self._state_source is not None and asm is not None:
            via = self._state_source
            # Resume the stream the assembler verified so far — which may
            # be an upgraded (newer) snapshot than the original target.
            count, offset = asm.count, asm.offset
            self.metrics.inc("state_transfer_resumes")
            if self.recovery is not None:
                self.recovery.note_resume()
        else:
            via = self._snapshot_sources.pop(0)
            self._snapshot_sources.append(via)  # retries cycle the claimants
            if self._state_source is not None and via != self._state_source:
                self.metrics.inc("state_transfer_failovers")
                if self.recovery is not None:
                    self.recovery.note_failover()
            self._state_asm = None
            count, offset = expect.count, 0
        self._state_source = via
        self._state_progress = offset
        self.metrics.inc("state_transfer_requests")
        req = StateReq(replica_id=self.replica_id, count=count, offset=offset)
        self.sign_message(req)
        self._unicast_append(via, req)

        def on_expiry() -> None:
            if self._snapshot_expect is None:
                return
            self.metrics.inc("state_transfer_retries")
            cur = self._state_asm
            progressed = cur is not None and cur.offset > self._state_progress
            self._send_state_req(resume=progressed)

        if self._snapshot_timer is not None:
            self._snapshot_timer.cancel()
        self._snapshot_timer = self._timer_provider.after(
            max(self._viewchange_timeout, 1.0), on_expiry
        )

    async def _process_snapshot_req(self, req: SnapshotReq) -> bool:
        snap = self.checkpoint_emitter.snapshot_for(req.count)
        count, cert = req.count, ()
        if snap is None:
            # The exact snapshot aged out of the retention window: offer
            # our newest certified one instead, certificate attached so
            # the requester can verify and upgrade its target.
            coll = self.checkpoint_collector
            if coll.stable_count > req.count:
                snap = self.checkpoint_emitter.snapshot_for(coll.stable_count)
                count = coll.stable_count
                cert = tuple(coll.stable_certificate[: self.f + 1])
        if snap is None:
            self.log.info(
                "no retained snapshot at count %d for replica %d",
                req.count,
                req.replica_id,
            )
            return False
        view, cv, app, marks = snap
        resp = SnapshotResp(
            replica_id=self.replica_id,
            count=count,
            view=view,
            cv=cv,
            app_state=app,
            watermarks=tuple(marks),
            cert=cert,
        )
        self.sign_message(resp)
        self._unicast_append(req.replica_id, resp)
        return True

    def _prune_state_unicast(self, peer_id: int) -> None:
        """Drop the prefix of ``peer_id``'s unicast log consisting of
        state-transfer payload frames — a fresh STATE-REQ supersedes every
        stream we queued for this peer before (its signed offset tells us
        exactly what it still needs, and the new stream re-sends that), so
        retaining them only bloats the log and the reconnect replay.
        Prefix-only: anything behind a non-state frame (e.g. a forwarded
        REQUEST or our own outgoing STATE-REQ) is left alone."""
        ulog = self.unicast_logs.get(peer_id)
        if ulog is None:
            return
        n_drop = 0
        for m in ulog.snapshot():
            if isinstance(m, (SnapshotResp, StateChunk, StateDone)):
                n_drop += 1
            else:
                break
        if n_drop:
            ulog.truncate(n_drop)

    async def _process_state_req(self, req: StateReq) -> bool:
        """Serve a chunked snapshot stream (the resumable counterpart of
        ``_process_snapshot_req``): deterministic fixed-size chunks, each
        signed and carrying the running chain digest recomputed from byte
        zero — so a requester resuming at ``req.offset`` receives chunks
        whose chain commits to the entire prefix it already verified."""
        snap = self.checkpoint_emitter.snapshot_for(req.count)
        count, cert = req.count, ()
        if snap is None:
            # The exact snapshot aged out of the retention window: offer
            # our newest certified one instead (certificate attached on
            # the DONE frame so the requester can verify and upgrade).
            coll = self.checkpoint_collector
            if coll.stable_count > req.count:
                snap = self.checkpoint_emitter.snapshot_for(coll.stable_count)
                count = coll.stable_count
                cert = tuple(coll.stable_certificate[: self.f + 1])
        if snap is None:
            self.log.info(
                "no retained snapshot at count %d for replica %d",
                req.count,
                req.replica_id,
            )
            return False
        view, cv, app, marks = snap
        self._prune_state_unicast(req.replica_id)
        total = len(app)
        # A resume offset only applies to the stream it measured; an
        # upgraded (newer) snapshot restarts from zero.  Offsets are
        # chunk-aligned by construction — a stale/misaligned one degrades
        # into the requester's failover path, never into bad bytes.
        offset = min(req.offset, total) if count == req.count else 0
        rec = self.recovery
        chain = b""
        for off, piece in recovery_transfer.iter_chunks(
            app, recovery_transfer.chunk_bytes()
        ):
            chain = recovery_transfer.chain_extend(chain, piece)
            if off < offset:
                continue  # the requester already verified this prefix
            ck = StateChunk(
                replica_id=self.replica_id,
                count=count,
                offset=off,
                total=total,
                data=piece,
                chain=chain,
            )
            self.sign_message(ck)
            self._unicast_append(req.replica_id, ck)
            self.metrics.inc("state_chunks_sent")
            if rec is not None:
                rec.note_chunk_tx(len(piece))
        done = StateDone(
            replica_id=self.replica_id,
            count=count,
            view=view,
            cv=cv,
            total=total,
            watermarks=tuple(marks),
            cert=cert,
        )
        self.sign_message(done)
        self._unicast_append(req.replica_id, done)
        return True

    async def _process_state_chunk(self, ck: StateChunk) -> bool:
        """Assemble one verified chunk of the in-flight stream.  Chunks
        from peers we did not ask, for streams we are not assembling, or
        below the verified offset (reconnect replays) are ignored
        idempotently; a chain mismatch is Byzantine evidence and fails the
        fetch over to the next source immediately."""
        if self._snapshot_expect is None or ck.replica_id != self._state_source:
            return False
        asm = self._state_asm
        if asm is None:
            # First chunk of a fresh stream: must start at zero, and may
            # carry a NEWER count than requested (the responder upgraded;
            # certified at the DONE frame before anything installs).
            if ck.offset != 0 or ck.count < self._snapshot_expect.count:
                return False
            asm = self._state_asm = recovery_transfer.ChunkAssembler(ck.count)
        if ck.count != asm.count:
            return False  # stale replay from a superseded stream
        try:
            fresh = asm.add(ck.offset, ck.total, ck.data, ck.chain)
        except recovery_transfer.ChainMismatch as e:
            self.log.warning(
                "corrupt state chunk from replica %d at offset %d: %s — "
                "failing over",
                ck.replica_id,
                ck.offset,
                e,
            )
            self.metrics.inc("state_transfer_corrupt")
            self._state_asm = None
            self._send_state_req()
            return False
        if fresh:
            self.metrics.inc("state_chunks_received")
            if self.recovery is not None:
                self.recovery.note_chunk_rx(len(ck.data))
        return fresh

    async def _process_state_done(self, done: StateDone) -> bool:
        """Terminal frame of a chunk stream: resolve the certified target
        (expected or upgraded), check the assembled length, and install
        through the same verified sequence as a monolithic SNAPSHOT-RESP.
        A stream that assembled cleanly but fails the f+1-certified
        composite digest is Byzantine (self-consistent garbage) — fail
        over to the next source."""
        if self._snapshot_expect is None or done.replica_id != self._state_source:
            return False
        asm = self._state_asm
        if asm is not None:
            if done.count != asm.count:
                return False
            if asm.offset != done.total:
                # Incomplete (a DONE replayed ahead of its chunks after a
                # reset): the retry timer resumes from the verified
                # offset; nothing to do now.
                return False
            app = asm.bytes()
        else:
            # Empty-snapshot stream: no chunks at all, just the DONE.
            if done.total != 0 or done.count < self._snapshot_expect.count:
                return False
            app = b""
        target = await self._resolve_transfer_target(
            done.count, done.view, done.cv, done.cert
        )
        if target is None:
            ok = False
        else:
            ok = await self._finish_state_transfer(
                target,
                done.count,
                done.view,
                done.cv,
                app,
                tuple(done.watermarks),
                done.replica_id,
            )
        if not ok and self._snapshot_expect is not None:
            self.metrics.inc("state_transfer_corrupt")
            self._state_asm = None
            self._send_state_req()
        return ok

    async def _resolve_transfer_target(self, count, view, cv, cert):
        """Map a transfer payload's claimed position to the certified
        target checkpoint: the expected one, or — when the responder's
        retention window moved past it — a NEWER one vouched by the
        attached certificate (verified independently, then adopted).
        Returns None when the payload matches neither."""
        expect = self._snapshot_expect
        if count == expect.count:
            return expect
        if count > expect.count and cert:
            try:
                target = await self.validate_checkpoint_cert(cert)
            except api.AuthenticationError as e:
                self.log.warning("bad snapshot-upgrade cert: %s", e)
                return None
            if (target.count, target.view, target.cv) != (count, view, cv):
                return None
            self._adopt_cert(cert)
            return target
        return None

    def _clear_state_transfer(self) -> None:
        self._snapshot_expect = None
        self._snapshot_sources = []
        self._state_asm = None
        self._state_source = None
        self._state_progress = 0
        if self._snapshot_timer is not None:
            self._snapshot_timer.cancel()
            self._snapshot_timer = None

    async def _finish_state_transfer(
        self, target, count, view, cv, app, watermarks, source
    ) -> bool:
        """Verify a fully-transferred snapshot against the f+1-certified
        composite digest and install it — the shared tail of the
        monolithic (SNAPSHOT-RESP) and chunked (STATE-DONE) paths."""
        if self.checkpoint_emitter.count >= count:
            # We caught up past the snapshot while it was in flight (e.g.
            # replaying full history from an untruncated peer): installing
            # now would REWIND the application state below the retire
            # watermarks and diverge this replica forever.
            self._clear_state_transfer()
            # A NEW-VIEW deferred behind this transfer must not die with
            # it: the catch-up that made the snapshot stale may equally
            # have carried us past the NEW-VIEW's anchor (and if it did
            # not, the re-check restarts the transfer) — otherwise the
            # replica stays wedged in the old view, silently consuming
            # the fault budget.
            await self._maybe_apply_pending_new_view()
            return False
        try:
            app_digest = self.consumer.snapshot_digest(app)
        except (ValueError, NotImplementedError) as e:
            self.log.warning("rejected snapshot at %d: %r", count, e)
            return False
        composite = checkpoint_mod.checkpoint_digest(
            app_digest, count, view, cv, watermarks
        )
        if composite != target.digest or (view, cv) != (target.view, target.cv):
            self.log.warning(
                "snapshot at %d does not match the certified digest "
                "(from replica %d)",
                count,
                source,
            )
            return False
        rec = self.recovery
        if rec is not None:
            rec.set_phase(recovery_mod.PHASE_INSTALLING)
        self.consumer.install_snapshot(app)
        self.client_states.install_retire_watermarks(watermarks)
        self.commitment_collector.install_checkpoint(view, cv)
        self.checkpoint_emitter.install(count)
        self._exec_pos = (view, cv)
        self._clear_state_transfer()
        self.metrics.inc("state_transfers")
        self.log.info(
            "state transfer complete: installed certified state at "
            "count %d (view %d cv %d) from replica %d",
            count,
            view,
            cv,
            source,
        )
        if rec is not None:
            # The broadcast-log replay delta-catches-up the tail from here.
            rec.set_phase(recovery_mod.PHASE_CATCHUP)
        cur, _ = await self.view_state.hold_view()
        if view > cur:
            await self.view_state.advance_expected_view(view)
            await self.view_state.advance_current_view(view)
        await self._maybe_apply_pending_new_view()
        return True

    async def _process_snapshot_resp(self, resp: SnapshotResp) -> bool:
        """Install a transferred snapshot once it checks out against the
        f+1-certified composite digest — then jump execution, watermarks,
        and the view to the certified position and retry any view entry
        that was waiting on the state."""
        if self._snapshot_expect is None:
            return False
        target = await self._resolve_transfer_target(
            resp.count, resp.view, resp.cv, resp.cert
        )
        if target is None:
            return False
        return await self._finish_state_transfer(
            target,
            resp.count,
            resp.view,
            resp.cv,
            resp.app_state,
            tuple(resp.watermarks),
            resp.replica_id,
        )

    # ------------------------------------------------------------------
    # Durable checkpoint store (recovery subsystem): persist every new
    # stable position, restore it crash-consistently at startup.

    def _own_ui_counter(self) -> int:
        """Highest own USIG counter this replica has certified — the
        watermark persisted alongside the stable state.  The broadcast log
        holds every certified entry above the truncation base, so the
        newest one (scanned from the tail) plus the base bounds it."""
        hi = self._own_log_base[0]
        for m in reversed(self.message_log.snapshot()):
            ui = getattr(m, "ui", None)
            if ui is not None:
                return max(hi, ui.counter)
        return hi

    def _spawn_durable_save(self) -> None:
        """Persist the freshly-stabilized position off-loop.  Never
        persists unverified bytes: the snapshot is recomputed against the
        stable composite digest first, so the store only ever holds state
        the f+1 certificate actually vouches for."""
        rec = self.recovery
        if rec is None or rec.store is None:
            return
        coll = self.checkpoint_collector
        count = coll.stable_count
        snap = self.checkpoint_emitter.snapshot_for(count)
        if snap is None:
            return  # no retained snapshot at the stable position
        view, cv, app, marks = snap
        try:
            app_digest = self.consumer.snapshot_digest(app)
        except (ValueError, NotImplementedError):
            return
        if (
            checkpoint_mod.checkpoint_digest(app_digest, count, view, cv, marks)
            != coll.stable_digest
        ):
            # The digest covers the view and cv, so a count executed here
            # in one view and certified in another never matches; whether
            # the state itself matches tells a view change's
            # re-certification from a diverged state machine.
            same = (
                checkpoint_mod.checkpoint_digest(
                    app_digest, count, coll.stable_view, coll.stable_cv, marks
                )
                == coll.stable_digest
            )
            self.log.error(
                "local snapshot at %d diverges from the stable digest — "
                "not persisting (executed in view %d cv %d, certified in "
                "view %d cv %d: %s state)",
                count,
                view,
                cv,
                coll.stable_view,
                coll.stable_cv,
                "the same" if same else "another",
            )
            return
        state = recovery_store.StableState(
            count=count,
            view=view,
            cv=cv,
            usig_counter=self._own_ui_counter(),
            app_state=app,
            watermarks=tuple(marks),
            cert=tuple(coll.stable_certificate[: self.f + 1]),
        )
        self._spawn_bg(self._durable_save(state))

    async def _durable_save(self, state) -> None:
        rec = self.recovery
        try:
            wrote = await asyncio.to_thread(rec.store.save, state)
        except OSError as e:
            rec.note_save_error()
            self.metrics.inc("recovery_save_errors")
            self.log.error("durable checkpoint save failed: %r", e)
            return
        if wrote:
            rec.note_saved(state.count)
            self.metrics.inc("recovery_saves")

    async def restore_from_store(self) -> None:
        """Crash-consistent startup restore (called by ``_Replica.start``
        BEFORE any peer connection): load the durable stable state,
        re-validate its f+1 certificate and recompute the composite digest
        — the file is a cache of certified state, never an authority —
        then install exactly like a completed state transfer.  The normal
        broadcast-log replay delta-catches-up the tail from here, and a
        LOG-BASE above our restored count triggers an ordinary chunked
        fetch.  A corrupted committed file raises
        :class:`minbft_tpu_torch.recovery.store.CorruptStoreError` — deliberately
        fatal (``peer run`` exits non-zero) rather than a silent fresh
        start."""
        rec = self.recovery
        if rec is None or rec.store is None:
            return
        rec.set_phase(recovery_mod.PHASE_LOADING)
        state = await asyncio.to_thread(rec.store.load)
        if state is None:
            rec.set_phase(recovery_mod.PHASE_IDLE)
            return
        rec.arm()
        try:
            target = await self.validate_checkpoint_cert(state.cert)
        except api.AuthenticationError as e:
            raise recovery_store.CorruptStoreError(
                f"durable store certificate invalid: {e}"
            )
        if (target.count, target.view, target.cv) != (
            state.count,
            state.view,
            state.cv,
        ):
            raise recovery_store.CorruptStoreError(
                "durable store position does not match its certificate"
            )
        try:
            app_digest = self.consumer.snapshot_digest(state.app_state)
        except (ValueError, NotImplementedError) as e:
            raise recovery_store.CorruptStoreError(
                f"durable store snapshot rejected by the consumer: {e!r}"
            )
        composite = checkpoint_mod.checkpoint_digest(
            app_digest, state.count, state.view, state.cv, state.watermarks
        )
        if composite != target.digest:
            raise recovery_store.CorruptStoreError(
                "durable store snapshot does not match its f+1 certificate"
            )
        self._adopt_cert(state.cert)
        self.consumer.install_snapshot(state.app_state)
        self.client_states.install_retire_watermarks(state.watermarks)
        self.commitment_collector.install_checkpoint(state.view, state.cv)
        self.checkpoint_emitter.install(state.count)
        self._exec_pos = (state.view, state.cv)
        rec.restored_count = state.count
        rec.set_phase(recovery_mod.PHASE_CATCHUP)
        self.metrics.inc("recovery_restores")
        self.log.info(
            "recovered durable state at count %d (view %d cv %d, usig "
            "watermark %d)",
            state.count,
            state.view,
            state.cv,
            state.usig_counter,
        )
        cur, _ = await self.view_state.hold_view()
        if state.view > cur:
            await self.view_state.advance_expected_view(state.view)
            await self.view_state.advance_current_view(state.view)

    def _spawn_bg(self, coro) -> "asyncio.Task":
        """``create_task`` under the ``_bg_tasks`` retention contract
        (TL601): the loop holds only a weak reference to running tasks,
        so the set keeps the strong one and the done-callback routes any
        failure to the replica log instead of the unretrieved void."""
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._on_bg_task_done)
        return task

    def _on_bg_task_done(self, task) -> None:
        """Done-callback for fire-and-forget background tasks: drop the
        strong reference and surface any failure in the replica log (the
        task has no awaiter — without this its exception only appears as
        an unretrieved-task warning at interpreter teardown, if ever)."""
        self._bg_tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            self.log.error("background task failed: %r", exc)

    async def _maybe_apply_pending_new_view(self) -> None:
        """Retry a NEW-VIEW that was deferred behind a state transfer.

        Re-applies once the local checkpoint count reaches the NEW-VIEW's
        quorum anchor, OR when no transfer is in flight anymore (the
        deferred entry's transfer was dropped): in the latter case
        ``_apply_new_view`` re-defers and re-requests the anchor state
        itself, so calling it is always safe.  Must be invoked outside the
        view read lease — applying advances the view, which drains leases.
        """
        nv = self._pending_new_view
        if nv is None:
            return
        anchor_count = viewchange_mod.quorum_anchor(nv.view_changes)[0]
        if (
            self.checkpoint_emitter.count < anchor_count
            and self._snapshot_expect is not None
        ):
            return  # still legitimately waiting on the in-flight transfer
        self._pending_new_view = None
        try:
            await self._apply_new_view(nv)
        except Exception:
            # An apply failure must not lose the NEW-VIEW forever (it was
            # already captured, so it is never redelivered) — especially on
            # the batch-end path, where this runs in a fire-and-forget task
            # and the exception would otherwise vanish.  _apply_new_view
            # may itself have re-deferred (set a fresh pending) before
            # raising; only restore if it didn't.
            if self._pending_new_view is None:
                self._pending_new_view = nv
            raise

    # ------------------------------------------------------------------
    # View-change protocol steps (beyond reference — core/viewchange.py).

    async def _process_req_view_change(self, msg: ReqViewChange) -> bool:
        cur, _ = await self.view_state.hold_view()
        if not self.view_change_state.in_window(msg.new_view, cur):
            return False  # stale, or absurdly far ahead (memory bound)
        if self.view_change_state.record_demand(msg.replica_id, msg.new_view):
            await self._start_transition(msg.new_view)
        return True

    async def _start_transition(self, new_view: int) -> None:
        """f+1 demands reached: stop applying current-view messages and
        broadcast this replica's certified VIEW-CHANGE."""
        vcs = self.view_change_state
        if new_view in vcs.sent_view_change:
            return
        vcs.sent_view_change.add(new_view)
        await self.view_state.advance_expected_view(new_view)
        self.metrics.inc("view_changes_started")

        # If the new primary is faulty too, its NEW-VIEW never arrives:
        # demand the next view after the view-change timeout.
        def on_expiry() -> None:
            async def escalate() -> None:
                cur, _ = await self.view_state.hold_view()
                if cur < new_view:
                    self.metrics.inc("timeouts_viewchange")
                    await self.request_view_change(new_view + 1)

            self._spawn_bg(escalate())

        # Re-arm only forward: demand quorums can complete out of order,
        # and a late lower-view transition must not silence the timer
        # guarding a higher pending one (mirrors the NEW-VIEW cancel
        # guard in _apply_new_view).
        if self._viewchange_timeout > 0 and new_view >= self._viewchange_timer_view:
            if self._viewchange_timer is not None:
                self._viewchange_timer.cancel()
            self._viewchange_timer = self._timer_provider.after(
                self._viewchange_timeout, on_expiry
            )
            self._viewchange_timer_view = new_view

        await self.emit_view_change(new_view)

    async def emit_view_change(self, new_view: int) -> None:
        """Build and broadcast this replica's VIEW-CHANGE.  The log
        snapshot and the UI assignment happen under one UI lock hold, so
        the claimed log is exactly counters log_base+1..k and the
        VIEW-CHANGE gets k+1 — the contiguity every receiver checks.
        Checkpoint truncation scopes the log: counters at or below the
        base are vouched by the attached f+1 certificate (coverage bounds
        >= base), so view-change work is O(checkpoint window), not
        O(history)."""
        async with self._ui_lock:
            base, cert = self._own_log_base
            log = tuple(
                viewchange_mod.trim_log_entry(m)
                for m in self.message_log.snapshot()
                if isinstance(m, CERTIFIED_MESSAGES) and m.ui is not None
            )
            vc = ViewChange(
                replica_id=self.replica_id,
                new_view=new_view,
                log=log,
                log_base=base,
                checkpoint_cert=cert,
            )
            self.assign_ui(vc)
            self.metrics.inc("view_changes_sent")
            self.message_log.append(vc)

    async def _apply_view_change(self, vc: ViewChange) -> bool:
        cur, _ = await self.view_state.hold_view()
        if not self.view_change_state.in_window(vc.new_view, cur):
            return False  # concluded view, or beyond the demand window
        vcs = self.view_change_state
        quorum = vcs.record_view_change(vc)
        # A VIEW-CHANGE is implicitly a demand: a replica that missed the
        # REQ-VIEW-CHANGE quorum still joins the transition once enough
        # peers have moved (prevents stragglers from stalling in the old
        # view while the quorum awaits their VIEW-CHANGE).
        if vcs.record_demand(vc.replica_id, vc.new_view):
            await self._start_transition(vc.new_view)
        if (
            quorum
            and utils.is_primary(vc.new_view, self.replica_id, self.n)
            and vc.new_view not in vcs.sent_new_view
        ):
            vcs.sent_new_view.add(vc.new_view)
            nv = NewView(
                replica_id=self.replica_id,
                new_view=vc.new_view,
                view_changes=tuple(vcs.quorum_for(vc.new_view)),
            )
            await self.handle_generated(nv)
        return True

    async def _apply_new_view(self, nv: NewView) -> bool:
        """Enter ``nv.new_view``: derive the re-proposal set S, arm its
        enforcement, register the new primary's counter base, advance the
        view, and (as the new primary) certify S before any fresh
        proposal."""
        cur, _ = await self.view_state.hold_view()
        if nv.new_view <= cur:
            return False
        anchor_count, av, acv, anchor_cert = viewchange_mod.quorum_anchor(
            nv.view_changes
        )
        if anchor_cert:
            # The quorum's best certified checkpoint: batches at or below
            # it are NOT re-proposed — every replica entering the view
            # must hold that state.  If we are behind it, fetch it first
            # and re-enter once installed (the NEW-VIEW is already
            # captured, so it won't be redelivered).
            self._adopt_cert(anchor_cert)
            if self.checkpoint_emitter.count < anchor_count:
                self._pending_new_view = nv
                self.log.info(
                    "NEW-VIEW %d anchored at count %d ahead of local %d: "
                    "state transfer before entering",
                    nv.new_view,
                    anchor_count,
                    self.checkpoint_emitter.count,
                )
                await self._request_state(anchor_cert)
                return False
        s_prepares = viewchange_mod.compute_new_view_set(
            nv.view_changes, nv.new_view
        )
        batches = [viewchange_mod.batch_key(p) for p in s_prepares]
        self.view_change_state.arm_reproposals(nv.new_view, list(batches))
        self.commitment_collector.set_view_base(nv.new_view, nv.ui.counter)

        self._prepare_batcher.suspend()
        try:
            await self.view_state.advance_expected_view(nv.new_view)
            if not await self.view_state.advance_current_view(nv.new_view):
                return False
            if (
                self._viewchange_timer is not None
                and self._viewchange_timer_view <= nv.new_view
            ):
                # Only disarm an escalation this NEW-VIEW satisfies — a
                # late NEW-VIEW for an older view must not silence the
                # timer still guarding a higher pending transition.
                self._viewchange_timer.cancel()
                self._viewchange_timer = None
            self.view_change_state.prune_through(nv.new_view)
            self.commitment_collector.prune_view_bases(nv.new_view)
            self.metrics.inc("view_changes_completed")
            # Health surface: the scrape-side minbft_health_view
            # gauge reads this stamp instead of suspending on view_state.
            self.metrics.note_view(nv.new_view)
            reproposal_ids = [
                [seq for _, seq in viewchange_mod.batch_key(p)]
                for p in s_prepares
            ]
            self.log.info(
                "entered view %d (%d re-proposals: %s)",
                nv.new_view,
                len(s_prepares),
                reproposal_ids,
            )
            if utils.is_primary(nv.new_view, self.replica_id, self.n):
                for p in s_prepares:
                    await self.handle_generated(
                        Prepare(
                            replica_id=self.replica_id,
                            view=nv.new_view,
                            requests=p.requests,
                        )
                    )
        finally:
            cur_after, _ = await self.view_state.hold_view()
            self._prepare_batcher.resume(cur_after)

        # Re-apply pending requests in the new view (the primary proposes
        # them; backups restart prepare timers) — skipping those S already
        # re-proposed.
        reproposed = {key for b in batches for key in b}
        for req in self.pending.all():
            if (req.client_id, req.seq) in reproposed:
                continue
            async with self.view_state.hold_view_lease() as (view, _):
                if view == nv.new_view:
                    await self.apply_request(req, view)
        return True

    # ------------------------------------------------------------------
    # Top-level handlers (reference handleClientMessage / handlePeerMessage /
    # handleOwnMessage, core/message-handling.go:352-403).

    async def handle_client_message(
        self, msg: Message, turn=None
    ) -> Optional[Reply]:
        if not isinstance(msg, Request):
            raise api.AuthenticationError("client stream accepts only REQUEST")
        self.metrics.inc("messages_handled")
        self.metrics.inc("requests_received")
        tr = self.trace
        if tr is not None:
            tr.note(obs_trace.R_RECV, msg.client_id, msg.seq)
        sl = self.slo
        if sl is not None:
            sl.arrive(msg.client_id, msg.seq)
        await self.validate_message(msg)
        if tr is not None:
            tr.note(obs_trace.R_VERIFY_DONE, msg.client_id, msg.seq)
        if msg.is_fast_read:
            # Fast path: answered from committed state, no ordering, no
            # seq capture, no USIG — the caller's finally releases the
            # arrival-order ticket (never waited on here).  Ordered reads
            # (read_mode=2, the fallback) ride the normal pipeline below
            # and execute via consumer.query at their slot.
            return await self._reply_read_only(msg)
        if turn is not None:
            # Concurrent validations may complete out of order; capture
            # must happen in arrival order (see _TurnSequencer).  The turn
            # is released the moment processing ends — holding it across
            # the reply quorum wait below would serialize the pipeline to
            # one request per client.
            sequencer, t = turn
            await sequencer.wait_turn(t)
            try:
                await self.process_message(msg)
            finally:
                sequencer.finish(t)
            return await self.reply_request(msg)
        await self.process_message(msg)
        # Reply once executed (even to a duplicate request — the client may
        # be retrying a lost reply, reference message-handling.go:396-403).
        # None for a stale retry of a superseded seq: only the client's
        # LAST reply is buffered (reference reply.go:25-60), so there is
        # nothing to send (the reference closes the reply channel without
        # sending, reply.go:74-79).
        return await self.reply_request(msg)

    async def _reply_read_only(self, req: Request) -> Optional[Reply]:
        """Answer a read-only REQUEST from committed state without
        ordering it (the reference lists read-only requests as roadmap,
        README.md:503-504).  Correctness: the client accepts the fast
        read only when ALL n replies match — with n=2f+1, any smaller
        read quorum cannot be guaranteed to intersect a write quorum in
        a correct replica — and otherwise falls back to an ordered
        request.  A consumer without query() support drops the request
        into the same fallback."""
        # Feature probe, not an identity check on the method object: a
        # delegating wrapper consumer advertises ``supports_query`` and
        # keeps the fast-read path (api.consumer_supports_query).
        if not api.consumer_supports_query(self.consumer):
            self.metrics.inc("readonly_unsupported")
            return None
        error = False
        try:
            result = await self.consumer.query(req.operation)
        except NotImplementedError:
            # A consumer that overrides query but refuses at runtime:
            # answer a signed error (like the ordered path) so the client
            # fails fast with the typed error instead of burning its
            # read_timeout on an all-n quorum that can never form.
            self.metrics.inc("readonly_unsupported")
            error = True
            result = b""
        except Exception as e:
            # The operation bytes are CLIENT-CONTROLLED: a consumer bug
            # on crafted input must cost this read, not detonate in the
            # stream processor as an internal error.  Answer a SIGNED
            # error reply (one WARNING line, not a traceback — the log
            # rate is attacker-chosen): an all-n error quorum raises
            # ReadOnlyQueryError at the client without burning its
            # read_timeout.
            self.log.warning(
                "read-only query failed: %r (op %r...)", e, req.operation[:32]
            )
            self.metrics.inc("readonly_query_errors")
            error = True
            result = b""
        reply = Reply(
            replica_id=self.replica_id,
            client_id=req.client_id,
            seq=req.seq,
            result=result,
            read_only=True,
            error=error,
        )
        # Fast reads arrive many-at-once under load: co-batch their REPLY
        # signatures on the sign queue like the ordered executor does.
        await self.sign_message_async(reply)
        tr = self.trace
        if tr is not None:
            tr.note(obs_trace.R_REPLY_SIGN, reply.client_id, reply.seq)
        if not error:
            self.metrics.inc("readonly_served")
        return reply

    async def handle_peer_message(self, msg: Message) -> None:
        if isinstance(
            msg,
            (
                *CERTIFIED_MESSAGES,
                ReqViewChange,
                Request,
                Checkpoint,
                LogBase,
                SnapshotReq,
                SnapshotResp,
                StateReq,
                StateChunk,
                StateDone,
            ),
        ):
            self.metrics.inc("messages_handled")
            try:
                await self.validate_message(msg)
            except api.EmbeddedRequestAuthError:
                # A UI-certified proposal embeds a request this replica
                # cannot authenticate (MAC asymmetry / faulty client or
                # primary).  The primary's counter has moved past a
                # message we will never accept, so every later message
                # from it would park on the gap — demand a view change
                # instead of wedging; with f+1 peers demanding, the full
                # view-change protocol (core/viewchange.py) deposes the
                # primary.
                view = (
                    msg.view
                    if isinstance(msg, Prepare)
                    else msg.prepare.view if isinstance(msg, Commit) else None
                )
                if view is not None:
                    await self.request_view_change(view + 1)
                raise
            await self.process_message(msg)
        else:
            raise api.AuthenticationError(
                f"unexpected peer message {stringify(msg)}"
            )

    async def handle_own_message(self, msg: Message) -> None:
        """Own messages replayed from the log are trusted — no validation
        (reference handleOwnMessage, core/message-handling.go:352-361).
        Own REQ-VIEW-CHANGE/VIEW-CHANGE/NEW-VIEW count toward our own
        quorums the same way peers' do.  Own CHECKPOINTs were already
        recorded at emission (the collector's newest-claim rule dedups
        the replay); own LOG-BASE heads are for peers."""
        if isinstance(msg, CERTIFIED_MESSAGES):
            await self._process_peer_message(msg)
        elif isinstance(msg, ReqViewChange):
            await self._process_req_view_change(msg)
        elif isinstance(msg, Checkpoint):
            self._process_checkpoint(msg)


# ---------------------------------------------------------------------------
# Stream pumps.


def _wire_bytes(msg: Message) -> bytes:
    """Marshal with per-object memo.  Only used for messages already in a
    message log (final — UIs/signatures assigned), which are re-marshalled
    once per subscribed peer stream."""
    cached = msg.__dict__.get("_wire_bytes")
    if cached is None:
        cached = marshal(msg)
        msg.__dict__["_wire_bytes"] = cached
    return cached


# Upper bound on concurrently-processed messages per incoming stream: enough
# that per-peer in-order UI capture (which may briefly park a task) never
# stalls the pipeline, small enough to bound memory under a message flood.
_STREAM_CONCURRENCY = 1024

# A run of this many consecutive NON-authentication processing failures on
# one peer stream closes the connection (see run_peer_connection).
_MAX_CONSECUTIVE_INTERNAL_ERRORS = 32


class _ConcurrentStreamProcessor:
    """Handle each incoming message in its own task.

    The reference dedicates one goroutine per stream and processes messages
    serially (core/message-handling.go:204-246).  Serial processing defeats
    batched verification: message k+1's (stateless) validation cannot start
    until message k's full validate+process finishes, so verification
    batches never fill.  Here validation runs concurrently across messages
    — per-peer processing *order* is still enforced downstream by the
    in-order UI capture (peerstate) and per-client seq capture
    (clientstate), exactly the batching-vs-ordering split of SURVEY.md §7.
    """

    def __init__(self, handle, on_error, on_success=None):
        self._handle = handle
        self._on_error = on_error
        self._on_success = on_success
        self._sem = asyncio.Semaphore(_STREAM_CONCURRENCY)
        self._tasks: set = set()

    async def submit(self, data: bytes) -> None:
        await self._sem.acquire()
        task = asyncio.get_running_loop().create_task(self._run(data, None))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def submit_msg(self, msg: Message) -> None:
        await self._sem.acquire()
        task = asyncio.get_running_loop().create_task(self._run(None, msg))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def try_submit_msg(self, msg: Message) -> bool:
        """Non-blocking :meth:`submit_msg`: False when the concurrency
        bound is exhausted instead of awaiting a slot.  The grouped
        client drain (minbft_tpu/groups) uses this so ONE saturated
        group's processor sheds ITS OWN messages — client retransmission
        heals the loss — rather than head-of-line blocking every other
        group's traffic on the shared stream (the same drop-on-full
        isolation contract as the transport's per-group rx queues).
        The locked() probe and the acquire are loop-atomic: with a free
        slot, Semaphore.acquire returns without suspending."""
        if self._sem.locked():
            return False
        await self._sem.acquire()
        task = asyncio.get_running_loop().create_task(self._run(None, msg))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return True

    async def try_submit(self, data: bytes) -> bool:
        """Non-blocking :meth:`submit` (the grouped per-frame fallback
        path's variant of :meth:`try_submit_msg`)."""
        if self._sem.locked():
            return False
        await self._sem.acquire()
        task = asyncio.get_running_loop().create_task(self._run(data, None))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return True

    async def _run(self, data: Optional[bytes], msg: Optional[Message]) -> None:
        try:
            if msg is None:
                msg = unmarshal(data)
            await self._handle(msg)
            if self._on_success is not None:
                self._on_success()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._on_error(e)
        finally:
            self._sem.release()

    async def drain(self) -> None:
        """Wait for every in-flight message task to finish."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
            # Awaiting already-done tasks does NOT suspend, but the
            # done-callbacks that prune _tasks ride call_soon — yield one
            # loop turn so they run, or this spins forever (and a spinning
            # coroutine starves the event loop, so no wait_for timeout can
            # ever rescue the caller).
            await asyncio.sleep(0)

    def cancel(self) -> None:
        # Snapshot: cancelling a task that is already FINISHING can run
        # its done-callback synchronously and mutate the set mid-iteration.
        for t in list(self._tasks):
            t.cancel()


# Bundle-ingest knobs.  MINBFT_BUNDLE_INGEST=0 reverts every stream pump
# to the per-frame-task path (the A/B lever perf/BATCH_RUNTIME.md uses);
# MINBFT_INGEST_MAX bounds the flat frames drained into one tick's bundle
# (the bench's ingest-batch-size sweep axis).  Read per stream setup, so
# tests and the bench sweep can toggle without reimporting.
_BUNDLE_ENV = "MINBFT_BUNDLE_INGEST"
_INGEST_MAX_ENV = "MINBFT_INGEST_MAX"
# Transport frames buffered between the stream pump and the tick loop:
# when full, the pump's put() blocks and the transport sees backpressure
# (the same role the submit semaphore plays for in-flight tasks).
_INGEST_RX_BOUND = 256
_INGEST_EOF = object()


def bundle_ingest_enabled() -> bool:
    return os.environ.get(_BUNDLE_ENV, "").lower() not in ("0", "false", "no")


def _ingest_max_frames() -> int:
    try:
        return max(1, int(os.environ.get(_INGEST_MAX_ENV, "1024")))
    except ValueError:
        return 1024


class _BundleIngestor:
    """Tick-driven bundle ingest for one incoming stream.

    Replaces per-frame task spawning on the stream's decode/validate hot
    path: a pump task moves transport frames into a bounded queue, and
    the tick loop drains EVERYTHING buffered per iteration into one flat
    frame bundle — the ``drain_multi`` write-side pattern mirrored on
    read.  The bundle is decoded in one vectorized call
    (``messages.codec.unmarshal_batch``, item-wise errors), its
    signature checks are SEEDED to the engine verify queue in one call
    (client streams; see :meth:`Handlers.preverify_requests` — the
    per-message validations coalesce onto the seeded lanes), and the
    messages fan out to the ordered processing pipeline — per-peer UI
    capture and per-client seq capture stay the ordering boundary,
    exactly the batching-vs-ordering split documented on
    :class:`_ConcurrentStreamProcessor`.

    Concurrency: every attribute is confined to the owning event loop
    (the pump and tick tasks of ONE stream; LD-spec'd in
    tools/analyze/project.py).  ``_eof_pending`` is the pump's non-edge
    EOF signal: the sentinel put can be dropped by a full queue, the
    flag cannot — the tick loop checks it whenever the queue runs dry.
    """

    def __init__(
        self,
        handlers: Handlers,
        on_error,
        submit,
        preverify=None,
        max_frames: Optional[int] = None,
    ):
        self._handlers = handlers
        self._on_error = on_error
        self._submit = submit  # async callable(Message)
        self._preverify = preverify  # sync callable(list[Message]) -> int
        self._max_frames = max_frames or _ingest_max_frames()
        self._rx: asyncio.Queue = asyncio.Queue(maxsize=_INGEST_RX_BOUND)
        self._eof_pending = False

    async def run(self, in_stream: AsyncIterator[bytes]) -> None:
        """Pump + tick until the stream ends (returns) or the caller
        cancels (propagates)."""
        pump = asyncio.get_running_loop().create_task(self._pump(in_stream))
        try:
            await self._ticks()
        finally:
            pump.cancel()
            pump.add_done_callback(lambda t: t.cancelled() or t.exception())

    async def _pump(self, in_stream: AsyncIterator[bytes]) -> None:
        rx = self._rx
        try:
            async for data in in_stream:
                await rx.put(data)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # An abnormal stream end (transport reset, protocol error in
            # the generator) must stay visible: the tick loop treats the
            # latched EOF as a clean end either way — the caller's redial
            # machinery handles recovery — but the CAUSE belongs in the
            # log, not the unretrieved-exception void.
            self._handlers.metrics.inc("ingest_stream_errors")
            self._handlers.log.warning("ingest stream failed: %r", e)
        finally:
            # One-way latch, loop-atomic store: the only write anywhere,
            # and the tick loop only reads it between awaits — no
            # read-modify-write spans a suspension.
            self._eof_pending = True  # noqa: LD001
            try:
                rx.put_nowait(_INGEST_EOF)
            except asyncio.QueueFull:
                # The tick loop cannot be parked in get() while the queue
                # is full — it will drain, see the flag, and stop.
                pass

    def _split_into(self, data: bytes, flat: list) -> None:
        try:
            flat.extend(split_multi(data))
        except CodecError as e:
            self._on_error(e)

    async def _ticks(self) -> None:
        rx = self._rx
        metrics = self._handlers.metrics
        while True:
            if self._eof_pending and rx.empty():
                return
            data = await rx.get()
            if data is _INGEST_EOF:
                return
            # Admission gauge: rx occupancy as this tick wakes (+1 for
            # the frame just popped) — the saturation signal the BUSY
            # retry-after hint scales by, and the high-water mark the
            # overload tests assert bounded (metrics.note_admission_rx).
            metrics.note_admission_rx(rx.qsize() + 1, rx.maxsize)
            flat: list = []
            self._split_into(data, flat)
            saw_eof = False
            while len(flat) < self._max_frames and not rx.empty():
                nxt = rx.get_nowait()
                if nxt is _INGEST_EOF:
                    saw_eof = True
                    break
                self._split_into(nxt, flat)
            await self._ingest(flat)
            if saw_eof:
                return

    async def _ingest(self, frames: list) -> None:
        if not frames:
            return
        h = self._handlers
        h.metrics.observe_ingest(len(frames))
        decoded = []
        for m in unmarshal_batch(frames):
            if isinstance(m, CodecError):
                self._on_error(m)
            else:
                decoded.append(m)
        if not decoded:
            return
        if self._preverify is not None:
            tr = h.trace
            if tr is not None:
                for m in decoded:
                    if isinstance(m, Request):
                        tr.note(obs_trace.R_INGEST, m.client_id, m.seq)
            sl = h.slo
            if sl is not None:
                for m in decoded:
                    if isinstance(m, Request):
                        sl.arrive(m.client_id, m.seq)
            self._preverify(decoded)
        for m in decoded:
            await self._submit(m)


class _TurnSequencer:
    """Restores ARRIVAL order between concurrent per-message tasks.

    Client-stream messages are validated concurrently (so verification
    co-batches on the engine), but per-client seq capture assumes seqs
    arrive in order — the client enqueues them in seq order and the
    stream is FIFO, yet validation completes out of order, and a higher
    seq reaching capture first makes the retire watermark jump past the
    lower one (silently wedging it; observed at ~1 in 10 flagship bench
    runs).  Each message takes a ticket at arrival; after validating, it
    waits its turn before the stateful processing step and releases the
    turn right after (never across the reply quorum wait, which would
    serialize the pipeline).  A ticket is released on EVERY exit —
    including validation failure — so a rejected message never wedges
    the queue behind it."""

    def __init__(self):
        self._issue = 0
        self._next = 0
        self._completed: set = set()
        self._events: Dict[int, asyncio.Event] = {}

    def ticket(self) -> int:
        t = self._issue
        self._issue += 1
        return t

    async def wait_turn(self, t: int) -> None:
        if self._next == t:
            return
        ev = self._events.setdefault(t, asyncio.Event())
        await ev.wait()

    def finish(self, t: int) -> None:
        """Idempotent: the happy path finishes right after processing
        (before the reply wait) and the error path finishes again from
        its finally."""
        if t < self._next or t in self._completed:
            return
        self._completed.add(t)
        while self._next in self._completed:
            self._completed.discard(self._next)
            self._events.pop(self._next, None)
            self._next += 1
        ev = self._events.get(self._next)
        if ev is not None:
            ev.set()


class PeerStreamHandler(api.MessageStreamHandler):
    """Server side of a peer connection: expect HELLO, then stream the
    broadcast log + the hello sender's unicast log
    (reference makeHelloHandler, core/message-handling.go:316-350).

    The HELLO's replica signature is verified BEFORE the claimed id is
    bound to a unicast-log subscription — the reference trusts the id
    unauthenticated (a known weakness of the handshake).  Replays of a captured
    signed HELLO are accepted by design: see the harmlessness argument on
    :class:`minbft_tpu_torch.messages.Hello`."""

    def __init__(self, handlers: Handlers):
        self.handlers = handlers

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        first = await _anext(in_stream)
        if first is None:
            return
        hello = unmarshal(first)
        if not isinstance(hello, Hello):
            raise api.AuthenticationError("peer stream must start with HELLO")
        h = self.handlers
        if not (0 <= hello.replica_id < h.n) or hello.replica_id == h.replica_id:
            raise api.AuthenticationError(
                f"HELLO claims invalid replica id {hello.replica_id}"
            )
        await h.verify_signature(hello)  # raises on an id-spoofing peer
        peer_id = hello.replica_id

        queue: asyncio.Queue = asyncio.Queue()
        done = asyncio.Event()

        async def pump(log: MessageLog, resume: int = 0) -> None:
            async for msg in log.stream(done):
                if resume:
                    # Resumable replay: the subscriber has already
                    # captured every certified counter below ``resume``
                    # — skip those entries instead of shipping them
                    # through a possibly-lossy link just to be dedup'd
                    # at capture.  Non-certified kinds (CHECKPOINT,
                    # REQ-VIEW-CHANGE, LOG-BASE heads) always replay:
                    # they are few (the log truncates at checkpoints)
                    # and dedup receiver-side.
                    ui = getattr(msg, "ui", None)
                    if ui is not None and ui.counter < resume:
                        continue
                await queue.put(msg)

        loop = asyncio.get_running_loop()
        tasks = [loop.create_task(pump(h.message_log, hello.resume_counter))]
        ulog = h.unicast_logs.get(peer_id)
        if ulog is not None:
            tasks.append(loop.create_task(pump(ulog)))

        # Also consume (and process) any further messages the peer sends on
        # this stream (the reference's separate incoming direction) — each
        # in its own task so their validations co-batch.
        def _drop_peer(e: Exception) -> None:
            h.metrics.inc("messages_dropped")
            h.log.warning("dropping peer message: %s", e)

        proc = _ConcurrentStreamProcessor(h.handle_peer_message, _drop_peer)

        async def consume_incoming() -> None:
            if bundle_ingest_enabled():
                # Peer bundles batch the DECODE (vectorized, item-wise
                # errors) and the per-tick drain; validation stays
                # per-message — PREPARE/COMMIT checks are UI-certificate
                # work that already co-batches across the concurrent
                # handler tasks.
                await _BundleIngestor(h, _drop_peer, proc.submit_msg).run(
                    in_stream
                )
                return
            async for data in in_stream:
                try:
                    frames = split_multi(data)
                except CodecError as e:
                    _drop_peer(e)
                    continue
                for fr in frames:
                    await proc.submit(fr)

        tasks.append(loop.create_task(consume_incoming()))

        try:
            while True:
                msg = await queue.get()
                # Coalesce whatever else is already queued into ONE stream
                # frame: under load the per-frame transport cost (gRPC +
                # asyncio plumbing) dominates the multi-process cluster's
                # throughput, and bursts (a PREPARE plus the COMMIT wave it
                # triggers) are common.
                data, _ = drain_multi(_wire_bytes(msg), queue, encode=_wire_bytes)
                yield data
        finally:
            done.set()
            proc.cancel()
            for t in tasks:
                t.cancel()


class ClientStreamHandler(api.MessageStreamHandler):
    """Server side of a client connection: REQUESTs in, REPLYs out
    (reference ClientMessageStreamHandler, core/replica.go:97-104)."""

    def __init__(self, handlers: Handlers):
        self.handlers = handlers

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        h = self.handlers
        out_queue: asyncio.Queue = asyncio.Queue()
        FIN = object()
        turns = _TurnSequencer()

        async def handle_one(msg: Message) -> None:
            t = turns.ticket()
            try:
                reply = await h.handle_client_message(msg, turn=(turns, t))
            finally:
                # Every exit — validation failure included — releases the
                # turn, or every later message on this stream would wedge
                # behind it.
                turns.finish(t)
            if reply is None:
                # Stale retry of a superseded seq: the last-reply buffer
                # skipped past it (reference ReplyChannel closes without
                # sending, reply.go:74-79).
                return
            data = marshal(reply)
            tr = h.trace
            if tr is not None:
                # reply_sent = the REPLY is marshaled and queued on the
                # stream (the last point this replica controls).
                tr.note(obs_trace.R_REPLY_SENT, reply.client_id, reply.seq)
            await out_queue.put(data)

        # Requests are handled concurrently (replies may take a quorum
        # round-trip each, and a pipelined client sends many requests per
        # stream), bounded + pruned by the stream processor so a request
        # flood cannot grow replica memory without bound.
        def _drop_client(e: Exception) -> None:
            h.metrics.inc("messages_dropped")
            h.log.warning("dropping client message: %s", e)

        proc = _ConcurrentStreamProcessor(handle_one, _drop_client)
        # Admission boundary: when the processor's concurrency
        # bound is exhausted, shed with a signed BUSY on out_queue instead
        # of blocking the ingest tick (open-loop offered load would wedge
        # the rx queue at its bound while the generator keeps pushing).
        # MINBFT_ADMISSION=0 reverts to the blocking backpressure path.
        if admission_mod.admission_enabled():
            adm = admission_mod.AdmissionController(h, proc, out_queue)
            submit_msg, submit_frame = adm.submit_msg, adm.submit
        else:
            submit_msg, submit_frame = proc.submit_msg, proc.submit

        async def consume() -> None:
            if bundle_ingest_enabled():
                # Bundle-ingest hot path: drain everything buffered per
                # tick, decode it as ONE vectorized batch, seed the
                # engine with the bundle's signature checks in one call,
                # then fan out in arrival order (the _TurnSequencer
                # tickets are issued in fan-out order, so the ordering
                # boundary is unchanged).
                await _BundleIngestor(
                    h,
                    _drop_client,
                    submit_msg,
                    preverify=h.preverify_requests,
                ).run(in_stream)
            else:
                async for data in in_stream:
                    try:
                        frames = split_multi(data)
                    except CodecError as e:
                        _drop_client(e)
                        continue
                    for fr in frames:
                        await submit_frame(fr)
            await proc.drain()
            await out_queue.put(FIN)

        consumer_task = asyncio.get_running_loop().create_task(consume())
        try:
            while True:
                item = await out_queue.get()
                if item is FIN:
                    break
                # Coalesce ready replies into one frame (see the peer pump).
                data, fin = drain_multi(item, out_queue, stop=FIN)
                yield data
                if fin:
                    break
        finally:
            # Cancel-and-await: a consume() failure (not just
            # cancellation) re-raises here instead of rotting as an
            # unretrieved task exception.
            consumer_task.cancel()
            try:
                await consumer_task
            except asyncio.CancelledError:
                pass


async def _anext(ait: AsyncIterator[bytes]) -> Optional[bytes]:
    try:
        return await ait.__anext__()
    except StopAsyncIteration:
        return None


async def run_own_message_loop(handlers: Handlers, done: asyncio.Event) -> None:
    """Self-delivery of own generated messages (reference
    handleOwnPeerMessages, core/message-handling.go:294-302): this is how
    the primary counts its own PREPARE and a backup its own COMMIT.

    Each own message is processed in its own task: an own COMMIT embeds the
    *primary's* PREPARE, whose in-order capture may need to wait for an
    earlier primary message still in flight — that wait must not
    head-of-line-block self-delivery of subsequent own messages (own-CV
    order is still enforced by peerstate capture on our own UIs)."""

    async def handle(msg: Message) -> None:
        await handlers.handle_own_message(msg)

    proc = _ConcurrentStreamProcessor(
        handle,
        lambda e: handlers.log.error("own-message processing failed: %r", e),
    )
    try:
        async for msg in handlers.message_log.stream(done):
            await proc.submit_msg(msg)
    finally:
        proc.cancel()


async def run_peer_connection(
    handlers: Handlers,
    peer_id: int,
    stream_handler: api.MessageStreamHandler,
    done: asyncio.Event,
) -> None:
    """Client side of a peer connection: send HELLO, process the peer's
    reply stream (reference startPeerConnection,
    core/message-handling.go:269-290).

    Messages are handled concurrently (one bounded task each), like the
    server-side pumps: this stream carries the peer's whole broadcast log —
    the primary's PREPAREs and every peer's COMMITs — and serial handling
    here would head-of-line-block on each quorum round-trip, starving the
    verification batches.  Per-peer processing *order* is still enforced
    downstream by in-order UI capture.

    The dial loop RECONNECTS with backoff when the stream ends or fails
    (network blip, peer crash/restart): without it a survivor would
    permanently stop receiving this peer's broadcast log — peer A's
    messages reach B only over B's dial to A, so a single dropped
    connection silently halves the link forever.  Reconnection is safe by
    design: the peer's HELLO replay re-streams its retained log, already-
    captured messages dedup at capture, and the validated-check memo makes
    re-validation cheap.  A run of consecutive INTERNAL errors still tears
    the connection down permanently (a local bug would loop forever)."""

    async def outgoing() -> AsyncIterator[bytes]:
        # Resumable replay: everything below next_expected() is already
        # captured, so tell the publisher to skip it.  Stamped at dial
        # time (the generator body runs on first iteration), so every
        # redial resumes from the CURRENT capture frontier — through a
        # lossy link this heals a counter gap with one short tail replay
        # instead of re-traversing the whole log (which re-gaps with
        # probability 1-(1-p)^N, the chaos soak's redial storm).
        hello = Hello(
            replica_id=handlers.replica_id,
            resume_counter=peer_state.next_expected(),
        )
        handlers.sign_message(hello)
        yield marshal(hello)
        # Keep the stream open until shutdown.
        await done.wait()

    # Expected per-message failures (bad tag, malformed bytes) are drops;
    # anything else is an internal error.  A persistent internal bug must
    # not degrade into an endless silently-dropping stream — after a run of
    # consecutive internal errors the connection is torn down loudly (the
    # pre-concurrency behavior, where one such exception killed the
    # stream).
    internal = {"consecutive": 0}

    def _drop(e: Exception) -> None:
        handlers.metrics.inc("messages_dropped")
        if isinstance(e, (api.AuthenticationError, CodecError)):
            internal["consecutive"] = 0
            handlers.log.warning("peer %d message rejected: %s", peer_id, e)
        else:
            internal["consecutive"] += 1
            handlers.log.error("peer %d message failed: %r", peer_id, e)

    def _ok() -> None:
        # Successful handling breaks an error run — only genuinely
        # CONSECUTIVE internal failures (a wedged handler) tear the
        # connection down; sporadic transients never accumulate.
        internal["consecutive"] = 0

    # Capture-gap watchdog: a certified message lost on a LIVE stream (a
    # lossy or partitioned link — a faithful transport only loses frames
    # by dropping the connection) leaves this peer's counter sequence
    # gapped, parking every later message forever; only a redial's HELLO
    # replay can redeliver the missing counter.  When a gap sits parked
    # with NO capture progress (gap_stalled_for — progress resets the
    # clock, so a long replay actively healing the gap is never torn
    # down) past the bound, AND the current stream has had a full bound
    # of its own to deliver (a fresh redial inherits parked captures
    # from the last stream's drain — judging it by their age would kill
    # every replay mid-flight, a redial storm), the dialer tears its own
    # stream down and lets the normal redial loop heal the gap.  The
    # bound rides the view-change timeout (the gap's worst casualty is
    # the VIEW-CHANGE quorum the transition is waiting on) with a floor
    # well above any healthy capture reorder.
    vc_t = getattr(handlers, "_viewchange_timeout", 8.0)
    gap_redial_s = max(1.0, min(vc_t if vc_t > 0 else 8.0, 8.0))
    # Idle-refresh watchdog: a lossy link can drop the TAIL of a burst —
    # a NEW-VIEW with no follow-on traffic leaves no counter gap to park
    # on, no frame to time out, nothing: the subscriber just sits in the
    # old view forever (the chaos soak's silent-wedge signature).  The
    # only cure is asking the publisher again, so a stream that has
    # delivered NOTHING for a full idle window is torn down and redialed
    # immediately (no redial-ladder backoff — a refresh, not a failure).
    # Resumable HELLO replay makes the refresh nearly free: an
    # up-to-date subscriber replays an empty tail.  The WINDOW itself
    # backs off, though: on a genuinely quiescent cluster every refresh
    # finds nothing (the stream only ever delivered the dial-time replay
    # burst), and a fixed window would churn teardown+HELLO handshakes
    # forever — consecutive find-nothing refreshes double the window up
    # to 8x, and a stream that keeps delivering past its replay burst
    # (real traffic) resets it, so the next silent-tail loss under load
    # still heals within the base window.
    idle_redial_base_s = max(2.0 * gap_redial_s, 3.0)
    idle_redial_s = idle_redial_base_s
    peer_state = handlers.peer_states.peer(peer_id)

    backoff = ReconnectBackoff()
    ingest = bundle_ingest_enabled()
    while not done.is_set():
        proc = _ConcurrentStreamProcessor(handlers.handle_peer_message, _drop, _ok)
        attempt_start = time.monotonic()
        last_rx = attempt_start
        idle_refresh = False
        cancelled = False
        # Per-STREAM counter (see _MAX_CONSECUTIVE_INTERNAL_ERRORS): errors
        # accumulated across redials must not add up to a permanent
        # teardown — that would rebuild the silent link-halving wedge
        # reconnection exists to prevent.
        internal["consecutive"] = 0
        stream = stream_handler.handle_message_stream(outgoing())
        ait = stream.__aiter__()
        nxt: Optional[asyncio.Future] = None

        def _gap_wedged() -> bool:
            return (
                time.monotonic() - attempt_start > gap_redial_s
                and peer_state.gap_stalled_for() > gap_redial_s
            )

        try:
            while True:
                # Race the next frame against the gap watchdog so a
                # quiet-but-gapped stream still redials.
                nxt = asyncio.ensure_future(ait.__anext__())
                gap_redial = False
                while not nxt.done():
                    await asyncio.wait({nxt}, timeout=min(gap_redial_s / 2, 1.0))
                    if nxt.done():
                        break
                    if _gap_wedged():
                        gap_redial = True
                        break
                    if time.monotonic() - last_rx > idle_redial_s:
                        idle_refresh = True
                        break
                if idle_refresh:
                    handlers.metrics.inc("idle_redials")
                    handlers.log.info(
                        "peer %d stream idle > %.1fs: refreshing (resumable "
                        "replay)",
                        peer_id,
                        idle_redial_s,
                    )
                    # Replay-burst frames land within ~a gap bound of the
                    # dial; deliveries past that mark real traffic.
                    if last_rx - attempt_start > gap_redial_s:
                        idle_redial_s = idle_redial_base_s
                    else:
                        idle_redial_s = min(
                            idle_redial_s * 2.0, 8.0 * idle_redial_base_s
                        )
                    break
                if gap_redial:
                    handlers.metrics.inc("gap_redials")
                    handlers.log.warning(
                        "peer %d capture gap stalled > %.1fs: redialing for "
                        "log replay",
                        peer_id,
                        gap_redial_s,
                    )
                    break
                try:
                    data = nxt.result()
                except StopAsyncIteration:
                    break
                nxt = None
                last_rx = time.monotonic()
                if done.is_set():
                    break
                if internal["consecutive"] >= _MAX_CONSECUTIVE_INTERNAL_ERRORS:
                    handlers.log.error(
                        "peer %d connection closed: %d consecutive internal "
                        "processing errors",
                        peer_id,
                        internal["consecutive"],
                    )
                    return
                try:
                    frames = split_multi(data)
                except CodecError as e:
                    _drop(e)
                    continue
                if ingest:
                    # The publisher's drain_multi already coalesced this
                    # frame into a bundle — decode it as one vectorized
                    # batch (item-wise errors) and fan the typed messages
                    # out, instead of spawning a decode task per frame.
                    # (The dial loop keeps its own watchdog-raced read
                    # structure, so the rx-queue tick loop is not used
                    # here.)
                    handlers.metrics.observe_ingest(len(frames))
                    for m in unmarshal_batch(frames):
                        if isinstance(m, CodecError):
                            _drop(m)
                        else:
                            await proc.submit_msg(m)
                else:
                    for fr in frames:
                        await proc.submit(fr)
                if _gap_wedged():
                    handlers.metrics.inc("gap_redials")
                    handlers.log.warning(
                        "peer %d capture gap stalled > %.1fs: redialing for "
                        "log replay",
                        peer_id,
                        gap_redial_s,
                    )
                    break
        except asyncio.CancelledError:
            cancelled = True
            raise
        except Exception:
            handlers.log.exception("peer %d connection failed", peer_id)
        finally:
            if nxt is not None:
                if nxt.done():
                    try:
                        nxt.exception()  # retrieve, or asyncio logs it
                    except asyncio.CancelledError:
                        pass
                else:
                    # cancel() can lose the race against the asend
                    # completing (StopAsyncIteration on a stream that
                    # just ended) — retrieve whatever lands so asyncio
                    # never logs "exception was never retrieved".
                    nxt.cancel()
                    nxt.add_done_callback(
                        lambda t: t.cancelled() or t.exception()
                    )
            # Close the manually-iterated stream so the handler's own
            # finally (pump teardown) runs now, not at GC.  Transport
            # teardown errors are noise here, but a CANCELLATION landing
            # while suspended in aclose must propagate — swallowing it
            # would return this supposedly-cancelled task to the redial
            # loop and stall the stop() awaiting it.
            aclose_cancel = False
            try:
                await ait.aclose()
            except asyncio.CancelledError:
                # Finish the teardown first (proc.cancel below rides the
                # `cancelled` flag), then re-raise at the end of this
                # finally so the cancellation wins.
                cancelled = True
                aclose_cancel = True
            except Exception:
                pass
            # Lived time is the STREAM's lifetime: measured before the
            # drain, which can add up to 30s a crash-looping peer never
            # earned toward the ladder's lived-connection reset.
            lived = time.monotonic() - attempt_start
            # A dropped stream must not cancel handlers mid-flight: a task
            # cancelled between UI capture and apply loses that message
            # FOREVER (the reconnect replay dedups at capture), so let
            # in-flight work finish first — bounded, because a handler
            # parked on a pathological wait must not stall the redial.
            # Skipped entirely on shutdown/cancellation: replay-loss no
            # longer matters and stop() must not stall 30s behind a
            # handler parked on a wait its dying peers can never resolve.
            if cancelled or done.is_set():
                proc.cancel()
            else:
                # The drain bound tracks the view-change timeout instead
                # of a flat 30s: chaos soaks (tests/test_chaos.py) showed
                # that after a lossy stream dies, the tasks still in
                # flight are mostly parked PRE-capture on a counter gap a
                # dropped certified message left — work that can only
                # complete once the redial's HELLO replay redelivers the
                # gap, so a long drain delays the very recovery it is
                # waiting for.  Genuine mid-apply work still gets a
                # multiple of the cluster's own patience knob.
                vc = getattr(handlers, "_viewchange_timeout", 8.0)
                drain_s = min(30.0, max(1.0, 2.0 * vc)) if vc > 0 else 1.0
                try:
                    await asyncio.wait_for(asyncio.shield(proc.drain()), drain_s)
                except asyncio.TimeoutError:
                    pass
                except asyncio.CancelledError:
                    # Cancelled mid-drain by a cancel-only caller: the
                    # cancellation must win, not be eaten into a redial.
                    proc.cancel()
                    raise
                proc.cancel()
            if aclose_cancel:
                raise asyncio.CancelledError()
        if done.is_set():
            return
        if idle_refresh:
            # A refresh is not a failure: redial immediately and leave
            # the ladder alone (its pace is bounded by idle_redial_s, so
            # skipping the backoff cannot storm).
            continue
        delay = backoff.next_delay(lived)
        handlers.metrics.inc("peer_reconnects")
        handlers.log.warning(
            "peer %d stream ended: reconnecting in %.1fs", peer_id, delay
        )
        try:
            await asyncio.wait_for(done.wait(), delay)
            return  # shutdown during the backoff
        except asyncio.TimeoutError:
            pass
