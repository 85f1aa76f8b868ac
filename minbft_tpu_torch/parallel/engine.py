"""Asyncio batching engine for GPU crypto verification and signing.

Port of :mod:`minbft_tpu.parallel.engine` for one CUDA device (default
``cuda:0``; ``device="cpu"`` runs the plain PyTorch versions of the
kernels) or a batch split over several (``mesh=``, :mod:`.mesh`).  The
queue machinery is the reference's, unchanged:

1. each protocol task awaits ``BatchVerifier.verify_*`` / ``sign_*`` and
   its item joins the scheme's pending queue,
2. the queue flushes by the **ship-when-idle** policy: with no dispatch
   in flight it flushes on the next event-loop turn; while one is in
   flight items accumulate and ship the moment it completes,
3. a batch is padded to a fixed bucket size (the bucket ladder), and
4. a worker thread (``asyncio.to_thread``, at most ``max_inflight`` per
   scheme) packs it into a recycled pinned staging tensor, copies it to
   the device and launches the kernel on PyTorch's current stream (K2
   for ECDSA verification, K6 for HMAC-SHA256 verification, K7 for
   Ed25519 verification, K3 and K8 for ECDSA and Ed25519 signing), then
   resolves every awaiting future with its lane's result.

The flush policy, the bucket ladder, the dedup memo and the stats are
the reference's.  Nothing here moves the card's work to the host: a
kernel error, and a dispatch that outlives ``dispatch_timeout``, reach
the awaiting futures as exceptions.  (The reference re-runs a hung batch
on the host and writes the device off; the port keeps only the timeout,
so a hung card fails loudly instead of turning into host throughput.)

The queues: ECDSA-P256 verify and sign, HMAC-SHA256 verify, Ed25519
verify and sign.  The reference's Ed25519 host queue
(``verify_ed25519_host``) is left out, as its ECDSA host queue was: it
moved the card's work to the host.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.hist import Log2Histogram
from ..ops import backend
from . import mesh as mesh_mod


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _Resolved:
    """Pre-resolved awaitable — a memo hit costs no Future machinery."""

    __slots__ = ("v",)

    def __init__(self, v: bool):
        self.v = v

    def __await__(self):
        if False:  # pragma: no cover — makes this a generator function
            yield
        return self.v


@dataclasses.dataclass
class VerifyStats:
    """Engine counters (the observability the reference lacks, SURVEY.md §5)."""

    items: int = 0
    batches: int = 0
    max_batch_seen: int = 0
    padded_lanes: int = 0
    device_time_s: float = 0.0
    # Host share of the dispatch: time the worker thread spent preparing
    # and packing the batch (limb conversion, batch inversion, staging
    # writes) BEFORE the kernel call — device_time_s covers the whole
    # dispatch await, so host_prep_time_s / device_time_s is the prep
    # share of the pipeline (bench.py reports it as *_prep_share).
    host_prep_time_s: float = 0.0
    memo_hits: int = 0
    dispatch_timeouts: int = 0  # hung dispatches, failed with TimeoutError
    # Flight-recorder gauges (event-loop-side updates only): why each
    # batch shipped ("full" / "idle" / "timer" / "completion" — the
    # ship-when-idle policy made observable), and pre-padding batch
    # occupancy bucketed by log2 size (key = (len(batch)-1).bit_length(),
    # so bucket k holds batches of 2^(k-1) < size <= 2^k items — prom.py
    # labels it with the 2^k upper edge).  Both sum to ``batches``.
    flush_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    occupancy: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Queue-wait attribution: per-item enqueue→dispatch wait
    # and dispatch→complete service as mergeable log2 histograms, both
    # recorded in _run's loop-side accounting block (so for successful
    # batches count == items; a failed dispatch records neither).
    # Scraped as minbft_{verify,sign}_queue_{wait,service}_seconds and
    # dumped for the critical-path merge (obs/critpath.py).
    queue_wait: Log2Histogram = dataclasses.field(default_factory=Log2Histogram)
    queue_service: Log2Histogram = dataclasses.field(
        default_factory=Log2Histogram
    )

    @property
    def mean_batch(self) -> float:
        return self.items / self.batches if self.batches else 0.0


@dataclasses.dataclass
class SignStats:
    """Sign-queue counters — the sign-side sibling of :class:`VerifyStats`.

    ``host_prep_time_s`` covers BOTH host halves of a dispatch (nonce
    derivation + limb packing before the kernel, batch inversion + scalar
    finish after it); ``device_time_s`` is the whole dispatch await, so
    the difference is the kernel + transfer share.
    ``host_fallback_items`` counts items signed by the serial host signer
    instead of k*G — only a CPU engine with ``sign_on_device`` off does
    that — so a measurement can never pass host signing off as device
    throughput."""

    items: int = 0
    batches: int = 0
    max_batch_seen: int = 0
    padded_lanes: int = 0
    device_time_s: float = 0.0
    host_prep_time_s: float = 0.0
    dispatch_timeouts: int = 0
    host_fallback_items: int = 0
    # See VerifyStats: flush-reason and log2 batch-occupancy gauges,
    # loop-side updates only — and the queue-wait/service span
    # histograms (same recording point and invariants).
    flush_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    occupancy: Dict[int, int] = dataclasses.field(default_factory=dict)
    queue_wait: Log2Histogram = dataclasses.field(default_factory=Log2Histogram)
    queue_service: Log2Histogram = dataclasses.field(
        default_factory=Log2Histogram
    )

    @property
    def mean_batch(self) -> float:
        return self.items / self.batches if self.batches else 0.0


class _StagingPool:
    """Recycled host staging tensors for the packed dispatch uploads —
    page-locked when the engine's device is CUDA, so the upload is one
    asynchronous copy on the dispatch's stream.

    Dispatchers run on worker threads — up to ``max_inflight`` of them
    concurrently per scheme — so buffers are checked out under a lock and
    returned only after the device results are materialized (``.cpu()``
    waits for the stream, upload included): a buffer is never shared by
    two in-flight dispatches, and at steady state a dispatch allocates
    no staging memory.
    """

    def __init__(self, cap: int = 8, pin: bool = False):
        # ``cap`` bounds free buffers kept per (shape, dtype) — the engine
        # passes its max_inflight.
        self._cap = max(2, cap)
        self._pin = pin
        self._lock = threading.Lock()
        self._free: Dict[tuple, list] = {}

    def acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            stack = self._free.get(key)
            buf = stack.pop() if stack else None
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self._pin)
        return buf

    def release(self, buf: torch.Tensor) -> None:
        key = (tuple(buf.shape), buf.dtype)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self._cap:
                stack.append(buf)


class _DispatchQueue:
    """Shared machinery of the verify and sign queues: ship-when-idle
    flush scheduling, ``max_inflight`` worker dispatch, and the
    hung-dispatch timeout.  Subclasses own the pending/resolution policy:
    :class:`_SchemeQueue` dedups (verification is a pure function),
    :class:`_SignQueue` is memo-free by design.
    """

    def __init__(self, engine: "BatchVerifier", name: str, dispatch):
        self.engine = engine
        self.name = name
        self.dispatch = dispatch  # List[item] -> per-lane results
        # (item, future, enqueue_monotonic_ns): the timestamp feeds the
        # per-item queue-wait histogram at dispatch time.
        self.pending: List[Tuple[object, asyncio.Future, int]] = []
        self._flush_handle: Optional[asyncio.Handle] = None
        self.inflight = 0
        # Dispatches timed out since the last one that completed (the
        # engine pool's chip_up reads it; loop-side updates only).
        self._consecutive_timeouts = 0
        # High-water mark of len(pending) since the last peak snapshot:
        # the point-in-time depth gauge misses every burst between
        # samples.  Updated loop-side in _schedule_flush (every growth
        # path runs through it); read and rearmed by queue_depth_peaks.
        self.peak_depth = 0
        # Strong refs to in-flight _run tasks: the loop keeps
        # only a weak reference to a running task, so without this set a
        # dispatch task is GC-able mid-flight.
        self._bg_tasks: set = set()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return task

    # -- subclass hooks -----------------------------------------------------

    def _host(self):
        """Serial host dispatcher that replaces the kernel for every batch
        of this queue (None: the kernel runs).  Only a CPU engine's sign
        queue has one."""
        return None

    def _resolve(self, batch, results, on_host: bool) -> None:
        """Resolve a completed batch's futures (subclass policy)."""
        raise NotImplementedError

    def _resolve_error(self, batch, e: BaseException) -> None:
        """Resolve a failed batch's futures with the failure."""
        raise NotImplementedError

    async def _run(self, batch, reason: str) -> None:
        """One dispatch: timed-out execution, shared accounting,
        then the subclass's resolution policy.  The finally re-flush is
        what implements flush-on-completion (accumulated items ship the
        moment a dispatch slot frees up)."""
        items = [it for it, _f, _t in batch]
        t0_ns = time.monotonic_ns()
        try:
            results, on_host = await self._dispatch_timed(items)
        except Exception as e:
            self._resolve_error(batch, e)
            return
        finally:
            # Loop-atomic: each _run task decrements exactly once, and
            # inflight is only ever read/written between awaits on the
            # event loop — no read-modify-write spans a suspension.
            self.inflight -= 1
            if self.pending:
                self._flush_now("completion")
        dt_ns = time.monotonic_ns() - t0_ns
        dt = dt_ns * 1e-9
        st = self.stats
        st.items += len(batch)
        st.batches += 1
        st.max_batch_seen = max(st.max_batch_seen, len(batch))
        st.device_time_s += dt
        # Flush-reason and occupancy gauges, counted HERE with batches —
        # not at flush time — so both always sum to ``batches`` (a batch
        # whose dispatch raises is counted in neither, keeping the
        # exported invariant true on error paths too).
        st.flush_reasons[reason] = st.flush_reasons.get(reason, 0) + 1
        # Pre-padding occupancy, log2-bucketed (loop-side — _run's
        # accounting block runs on the event loop like the rest of st).
        # (n-1).bit_length() puts bucket k at 2^(k-1) < size <= 2^k — the
        # documented upper-edge convention, so a full power-of-two batch
        # (the common case under load) lands in ITS bucket, not one up.
        occ = (len(batch) - 1).bit_length()
        st.occupancy[occ] = st.occupancy.get(occ, 0) + 1
        # Queue-wait attribution: per-item enqueue→dispatch wait, and the
        # shared dispatch→complete service span fanned to every lane in
        # one O(1) bulk observe.  Recorded HERE, with the other success
        # accounting, so wait.count == service.count == items for every
        # successful batch (the exported invariant).
        wait_h = st.queue_wait
        for _it, _f, t_enq in batch:
            wait_h.observe_ns(t0_ns - t_enq)
        st.queue_service.observe_ns(dt_ns, len(batch))
        self._resolve(batch, results, on_host)

    # -- flush scheduling ---------------------------------------------------

    def _schedule_flush(self, fut: asyncio.Future) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        # Peak BEFORE any flush decision: every submit lands here with its
        # items already appended, before _flush_now pops them.
        if len(self.pending) > self.peak_depth:
            self.peak_depth = len(self.pending)
        if len(self.pending) >= self.engine.max_batch:
            self._flush_now("full")
        elif self.inflight == 0 and self._flush_handle is None:
            # Device idle: flush on the next loop turn (after every
            # already-runnable coroutine has had the chance to co-submit),
            # optionally stretched by max_delay to coalesce more.
            if self.engine.max_delay > 0:
                self._flush_handle = loop.call_later(
                    self.engine.max_delay, self._flush_now, "timer"
                )
            else:
                self._flush_handle = loop.call_soon(self._flush_now, "idle")
        # else: a dispatch is in flight — accumulate; its completion flushes.
        return fut

    def _flush_now(self, reason: str = "direct") -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        max_batch = self.engine.max_batch
        while self.pending and self.inflight < self.engine.max_inflight:
            batch = self.pending[:max_batch]
            del self.pending[:max_batch]
            self.inflight += 1
            # The reason rides with the batch and is counted in _run's
            # success accounting alongside ``batches``.
            self._spawn(self._run(batch, reason))

    # -- dispatch with the timeout -----------------------------------------

    async def _dispatch_timed(self, items):
        """Run the dispatcher on a worker thread.  A dispatch that
        outlives ``dispatch_timeout`` is abandoned (its thread runs on
        unobserved) and the batch fails with :class:`TimeoutError`, so a
        hung kernel cannot wedge every protocol task awaiting it.  The
        batch is NOT re-run on the host: on a CUDA engine that would turn
        the card's work into host work behind the caller's back.

        Returns ``(results, on_host)`` — the flag rides WITH the results
        so callers account items and host work atomically at resolution
        time."""
        host = self._host()
        if host is not None:
            return await asyncio.to_thread(host, items), True
        timeout = self.engine.dispatch_timeout
        if timeout <= 0:
            results = await asyncio.to_thread(self.dispatch, items)
            self._consecutive_timeouts = 0
            return results, False
        task = asyncio.ensure_future(asyncio.to_thread(self.dispatch, items))
        try:
            results = await asyncio.wait_for(asyncio.shield(task), timeout)
            self._consecutive_timeouts = 0
            return results, False
        except asyncio.TimeoutError:
            # Swallow whatever the abandoned thread eventually raises (an
            # unretrieved task exception would otherwise be logged).
            task.add_done_callback(
                lambda t: t.exception() if not t.cancelled() else None
            )
            self.stats.dispatch_timeouts += 1
            self._consecutive_timeouts += 1
            raise TimeoutError(
                f"{self.name} dispatch of {len(items)} items on "
                f"{self.engine.mesh} hung > {timeout}s"
            ) from None


class _SchemeQueue(_DispatchQueue):
    """Pending verifications for one scheme, with ship-when-idle flush.

    Verification is a pure function of the item, and one engine typically
    serves a whole cluster (BASELINE.json: one chip verifies for all n
    replicas), so identical items are deduplicated: a memo LRU returns
    known verdicts instantly, and an in-flight map lets concurrent
    duplicates await the same lane instead of occupying n lanes.  (The n
    replicas of a cluster all verify the same client signature and the
    same primary UI — dedup turns those n device verifies into one.)
    """

    _MEMO_CAP = 16384
    # Failed verdicts live in their own, much smaller LRU: a flood of
    # distinct garbage signatures must not evict known-GOOD verdicts and
    # re-drive device traffic for them.  Small
    # because negative hits only matter for byzantine *retransmissions* of
    # the same bad item — there is no protocol reason to remember many.
    _NEG_MEMO_CAP = 512

    def __init__(self, engine: "BatchVerifier", name: str, dispatch):
        super().__init__(engine, name, dispatch)
        self.stats = VerifyStats()
        self._memo: "OrderedDict[object, bool]" = OrderedDict()
        self._neg_memo: "OrderedDict[object, bool]" = OrderedDict()
        self._inflight_futs: Dict[object, asyncio.Future] = {}

    def submit(self, item) -> "asyncio.Future | _Resolved":
        out = self._enqueue(item)
        if self.pending:
            self._schedule_flush(None)
        return out

    def submit_many(self, items) -> list:
        """Batch entry point (the ingest runtime's one-call feed): enqueue
        every item, then schedule ONE flush — the whole bundle lands in
        ``pending`` before any dispatch decision, so a decoded ingest
        bundle becomes at most ceil(len/max_batch) device batches instead
        of racing item-by-item against the idle flush.  Returns one
        awaitable per item (memo hits resolve instantly, duplicates share
        lanes — exactly :meth:`submit`'s semantics, item-wise)."""
        outs = [self._enqueue(it) for it in items]
        if self.pending:
            self._schedule_flush(None)
        return outs

    def _enqueue(self, item) -> "asyncio.Future | _Resolved":
        if not self.engine.dedup:
            # Measurement mode: every submission occupies its own device
            # lane (no memo, no in-flight coalescing), so device traffic
            # equals the protocol's logical verification demand.  Equal
            # items in one batch resolve together on the first lane's pop
            # (the same pure-function verdict).
            fut = asyncio.get_running_loop().create_future()
            self._inflight_futs.setdefault(item, []).append(fut)
            self.pending.append((item, fut, time.monotonic_ns()))
            return fut
        verdict = self._memo.get(item)
        if verdict is None:
            verdict = self._neg_memo.get(item)
            memo = self._neg_memo
        else:
            memo = self._memo
        if verdict is not None:
            memo.move_to_end(item)
            self.stats.memo_hits += 1
            return _Resolved(verdict)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        waiters = self._inflight_futs.get(item)
        if waiters is not None:
            # Every duplicate awaiter gets its OWN future (resolved
            # together): sharing one future would let any awaiter's task
            # cancellation cancel it for all of them.
            self.stats.memo_hits += 1
            waiters.append(fut)
            return fut
        self._inflight_futs[item] = [fut]
        self.pending.append((item, fut, time.monotonic_ns()))
        return fut

    def _resolve_error(self, batch, e: BaseException) -> None:
        for it, _f, _t in batch:
            for fut in self._inflight_futs.pop(it, ()):
                if not fut.done():
                    fut.set_exception(e)

    def _resolve(self, batch, results, on_host: bool) -> None:
        dedup = self.engine.dedup
        for (it, _f, _t), ok in zip(batch, results):
            ok = bool(ok)
            if dedup:
                # Pure function: verdicts (both ways) are stable — but they
                # age out of segregated LRUs so garbage cannot evict good.
                memo = self._memo if ok else self._neg_memo
                memo[it] = ok
            for fut in self._inflight_futs.pop(it, ()):
                if not fut.done():
                    fut.set_result(ok)
        # Loop-confined trims: each popitem is atomic on the event loop
        # and the while re-checks after every one, so interleaving with a
        # concurrent resolve only trims more — no cross-await invariant.
        while len(self._memo) > self._MEMO_CAP:
            self._memo.popitem(last=False)
        while len(self._neg_memo) > self._NEG_MEMO_CAP:
            self._neg_memo.popitem(last=False)


class _SignQueue(_DispatchQueue):
    """Pending signatures for one scheme — the sign-side mirror of
    :class:`_SchemeQueue` (same ship-when-idle flush, bucket padding,
    recycled staging, ``max_inflight`` workers, hung-dispatch timeout)
    with the dedup shortcuts deliberately ABSENT: no memo, no in-flight
    coalescing.  Every submission occupies its own lane — a sign is a
    distinct protocol event under the caller's own key (two replicas
    signing byte-identical REPLY content must each produce and account
    for their own signature), so nothing here may short-circuit on item
    equality.  Contrast the USIG, which must not batch at all: its
    counter is incremented only after each certificate exists
    (ref usig.c:66-69), an inherently serial per-key discipline — USIG
    signing never reaches this queue.
    """

    def __init__(self, engine: "BatchVerifier", name: str, dispatch):
        super().__init__(engine, name, dispatch)
        self.stats = SignStats()

    def _host(self):
        if self.engine.sign_on_device:
            return None
        return self.engine._host_signer_for(self.name)

    def submit(self, item) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self.pending.append((item, fut, time.monotonic_ns()))
        return self._schedule_flush(fut)

    def _resolve_error(self, batch, e: BaseException) -> None:
        for _it, fut, _t in batch:
            if not fut.done():
                fut.set_exception(e)

    def _resolve(self, batch, results, on_host: bool) -> None:
        if on_host:
            # Accounted HERE, with items, so the two counters can never
            # skew apart (e.g. across a bench warmup stats reset).
            self.stats.host_fallback_items += len(batch)
        for (_it, fut, _t), sig in zip(batch, results):
            if not fut.done():
                fut.set_result(sig)


class BatchVerifier:
    """The GPU-backed batch verification and signing engine.

    Schemes: ``ecdsa_p256`` (verify items: ((qx, qy), digest32, (r, s));
    sign items: (d, digest32)), ``hmac_sha256`` (verify items: (key32,
    msg32, mac32)) and ``ed25519`` (verify items: (pub32, msg, sig64);
    sign items: (seed32, msg)).

    ``device``: ``None`` is ``cuda:0``; ``"cpu"`` runs the plain PyTorch
    versions of the kernels; CUDA asked for and absent raises
    ``RuntimeError``.  ``max_batch`` bounds the device batch (and the
    largest bucket); ``max_delay`` optionally stretches the idle-device
    flush to coalesce more items (0 = flush on the next event-loop turn);
    ``max_inflight`` bounds concurrent dispatches per scheme (2 keeps the
    device fed while the next batch accumulates).  ``dispatch_timeout``
    fails a batch whose dispatch runs longer (0 disables).  ``dedup=False``
    is a measurement mode: every submitted verification takes its own
    device lane (no memo, no in-flight coalescing), so the device's
    verifies equal the protocol's demand; deployments keep it on.
    ``sign_on_device`` matters only on the CPU: there ``None``/False signs
    with the serial host signer and True with the plain k*G / r*B; a
    CUDA engine always signs with K3 and K8 (False raises
    ``ValueError``).

    Every dispatch runs through :func:`.mesh.sharded_verifier` over the
    engine's ``mesh``: ``Mesh((device,))`` unless a mesh
    (:func:`.mesh.make_mesh`) is passed, which splits every batch over its
    devices.  The buckets round up to multiples of the mesh size, and
    ``dispatch_timeout`` covers every chunk of a dispatch.  ``device=``
    with a mesh of more than one device raises ``ValueError``.
    """

    def __init__(
        self,
        max_batch: int = 512,
        max_delay: float = 0.0,
        buckets: Optional[Sequence[int]] = None,
        max_inflight: int = 2,
        mesh=None,
        dispatch_timeout: float = 90.0,
        dedup: bool = True,
        sign_on_device: Optional[bool] = None,
        device=None,
    ):
        if mesh is not None and mesh.size > 1 and device is not None:
            raise ValueError("pass either device= (home chip) or mesh=, not both")
        if mesh is not None and device is None:
            device = mesh.devices[0]
        # ``device`` is the mesh's first device (all are of one type); a
        # dispatch runs on every device of the mesh.
        self.device = backend.resolve_device(device)
        if mesh is None or mesh.size == 1:
            mesh = mesh_mod.Mesh((self.device,))
        self.mesh = mesh
        if self.device.type == "cuda" and sign_on_device is False:
            raise ValueError(
                "a CUDA engine signs with the k*G kernel: sign_on_device=False "
                "is for device='cpu' only"
            )
        self.sign_on_device = self.device.type == "cuda" or bool(sign_on_device)
        if self.device.type == "cuda":
            # Build the kernels (once per process, under the extension's
            # lock) and upload the comb tables now, so no dispatch pays
            # for them inside its timeout.
            backend.EXTENSION.build_all()
            from ..ops import ed25519, p256

            for d in self.mesh.devices:
                p256.comb_table_words(str(d))
                ed25519.comb_table_words(str(d))
        # A dispatch that exceeds this many seconds is abandoned and its
        # batch fails; see _DispatchQueue._dispatch_timed.  0 disables.
        self.dispatch_timeout = dispatch_timeout
        self.dedup = dedup
        # Stats fields are owned per-field: the event loop owns the counts
        # _run updates; padded_lanes and host_prep_time_s are updated by
        # the DISPATCHER on a worker thread, under this lock (_note_prep).
        self._stats_lock = threading.Lock()
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.max_inflight = max_inflight
        # Default: a small geometric ladder of padded shapes (8, 32, 128,
        # ..., max_batch) — bounds pad waste at 4x with a logarithmic
        # number of shapes.
        if buckets:
            self.buckets = tuple(buckets)
        else:
            ladder = []
            b = 8
            while b < max_batch:
                ladder.append(b)
                b *= 4
            ladder.append(max_batch)
            self.buckets = tuple(ladder)
        if self.buckets[-1] < max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch {max_batch}"
            )
        # Every chunk of a padded batch gets the same length.
        self.buckets = tuple(
            sorted({mesh_mod.round_up_to_mesh(self.mesh, b) for b in self.buckets})
        )
        self._queues: Dict[str, _SchemeQueue] = {}
        self._sign_queues: Dict[str, _SignQueue] = {}
        self._staging = _StagingPool(
            cap=max_inflight, pin=self.device.type == "cuda"
        )
        # Flight-recorder hookup: dispatcher-side span events pushed by
        # the WORKER threads into a multi-producer ring (None until an
        # operator enables it).
        self._obs_ring = None
        self._obs_queue_ids: Dict[str, int] = {}

    # -- flight-recorder surface -------------------------------------------

    def enable_obs_ring(self, capacity: int = 4096) -> None:
        """Start recording per-dispatch span events (see _note_prep)."""
        from ..obs.trace import MTStageRing

        if self._obs_ring is None:
            self._obs_ring = MTStageRing(capacity)

    def _obs_queue_id(self, name: str) -> int:
        qid = self._obs_queue_ids.get(name)  # GIL-atomic fast path
        if qid is None:
            with self._stats_lock:
                qid = self._obs_queue_ids.get(name)
                if qid is None:
                    qid = len(self._obs_queue_ids)
                    self._obs_queue_ids[name] = qid
        return qid

    def drain_obs_events(self) -> list:
        """Decoded dispatcher span events, oldest→newest:
        (queue_name, padded_lanes, host_prep_ns, t_monotonic_ns)."""
        ring = self._obs_ring
        if ring is None:
            return []
        names = {v: k for k, v in dict(self._obs_queue_ids).items()}
        return [
            (names.get(qid, f"queue{qid}"), pad, prep_ns, t_ns)
            for qid, pad, prep_ns, t_ns in ring.snapshot()
        ]

    # -- queues -------------------------------------------------------------

    def _queue(self, name: str, dispatch) -> _SchemeQueue:
        q = self._queues.get(name)
        if q is None:
            q = _SchemeQueue(self, name, dispatch)
            self._queues[name] = q
        return q

    def _sign_queue(self, name: str, dispatch) -> _SignQueue:
        q = self._sign_queues.get(name)
        if q is None:
            q = _SignQueue(self, name, dispatch)
            self._sign_queues[name] = q
        return q

    def _host_signer_for(self, name: str):
        """Serial host signing for a CPU engine's sign queue (see
        ``sign_on_device``)."""
        from ..utils import hostcrypto as hc

        return {
            "ecdsa_p256": lambda items: [
                hc.ecdsa_sign(d, digest) for d, digest in items
            ],
            "ed25519": lambda items: [
                hc.ed25519_sign(seed, msg) for seed, msg in items
            ],
        }[name]

    @property
    def stats(self) -> Dict[str, VerifyStats]:
        return {name: q.stats for name, q in dict(self._queues).items()}

    @property
    def sign_stats(self) -> Dict[str, SignStats]:
        return {name: q.stats for name, q in dict(self._sign_queues).items()}

    def queue_depths(self) -> Dict[str, int]:
        """Items pending per verify queue right now (a gauge).  dict()
        snapshots the queue map first: a sampler thread may iterate while
        the loop inserts a new queue."""
        return {name: len(q.pending) for name, q in dict(self._queues).items()}

    def sign_queue_depths(self) -> Dict[str, int]:
        return {name: len(q.pending) for name, q in dict(self._sign_queues).items()}

    @staticmethod
    def _depth_peaks(queues, reset: bool) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, q in dict(queues).items():
            out[name] = max(q.peak_depth, len(q.pending))
            if reset:
                q.peak_depth = len(q.pending)
        return out

    def queue_depth_peaks(self, reset: bool = True) -> Dict[str, int]:
        """High-water mark of each verify queue's depth since the last
        snapshot; ``reset`` rearms the mark at the current depth.  The
        read and the rearm are each GIL-atomic, so a burst landing
        between them shows in the next snapshot."""
        return self._depth_peaks(self._queues, reset)

    def sign_queue_depth_peaks(self, reset: bool = True) -> Dict[str, int]:
        """:meth:`queue_depth_peaks` of the sign queues."""
        return self._depth_peaks(self._sign_queues, reset)

    # -- public API ---------------------------------------------------------

    async def verify_ecdsa_p256(
        self, pubkey: Tuple[int, int], digest: bytes, sig: Tuple[int, int]
    ) -> bool:
        q = self._queue("ecdsa_p256", self._dispatch_ecdsa)
        return await q.submit((pubkey, digest, sig))

    async def verify_hmac_sha256(self, key: bytes, msg32: bytes, mac: bytes) -> bool:
        """HMAC-SHA256(key32, msg32) == mac32, one lane of K6."""
        q = self._queue("hmac_sha256", self._dispatch_hmac)
        return await q.submit((key, msg32, mac))

    async def _verify_many(self, name: str, dispatch, items) -> list:
        """Whole-bundle verification feed: every item lands in the queue
        before ONE flush decision.  Returns per-item verdicts in input
        order."""
        q = self._queue(name, dispatch)
        outs = q.submit_many(items)
        # Gather with return_exceptions so EVERY lane's outcome is
        # consumed even when the batch errors.
        results = await asyncio.gather(*outs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    async def verify_ecdsa_p256_many(self, items) -> list:
        """Batch sibling of :meth:`verify_ecdsa_p256`:
        ``items = [((qx, qy), digest32, (r, s)), ...]`` -> [bool, ...]."""
        return await self._verify_many("ecdsa_p256", self._dispatch_ecdsa, items)

    async def verify_ed25519(self, pub: bytes, msg: bytes, sig: bytes) -> bool:
        """Strict Ed25519 verification of ``sig`` over ``msg`` under
        ``pub``, one lane of K7."""
        q = self._queue("ed25519", self._dispatch_ed25519)
        return await q.submit((pub, msg, sig))

    async def verify_ed25519_many(self, items) -> list:
        """Batch sibling of :meth:`verify_ed25519`:
        ``items = [(pub32, msg, sig64), ...]`` -> [bool, ...]."""
        return await self._verify_many("ed25519", self._dispatch_ed25519, items)

    # -- signing ------------------------------------------------------------
    #
    # USIG UI signing must NEVER route here: its counter is incremented
    # only after the certificate exists, a serial per-key discipline.

    async def sign_ecdsa_p256(self, d: int, digest: bytes) -> Tuple[int, int]:
        """Batch-sign ``digest`` under private scalar ``d`` -> (r, s).
        RFC 6979 deterministic — byte-identical to
        ``hostcrypto.ecdsa_sign_py`` on the device path."""
        q = self._sign_queue("ecdsa_p256", self._dispatch_sign_ecdsa)
        return await q.submit((d, digest))

    async def sign_ed25519(self, seed: bytes, msg: bytes) -> bytes:
        """Batch-sign ``msg`` under the 32-byte ``seed`` -> signature64.
        RFC 8032 deterministic — byte-identical to
        ``hostcrypto.ed25519_sign`` on the device path."""
        q = self._sign_queue("ed25519", self._dispatch_sign_ed25519)
        return await q.submit((seed, msg))

    # -- dispatchers (worker thread; the device work happens here) ----------
    #
    # Shape: acquire a recycled staging tensor, prep/pack the batch into
    # it (timed separately as host_prep_time_s), then _launch: copy each
    # chunk to its mesh device, launch the kernel there, materialize the
    # results with .cpu() (which waits for the stream); release the
    # buffer.  The release MUST stay behind the materialization: the
    # asynchronous upload reads the pinned buffer until the stream
    # reaches it, and _launch returns only after every chunk is read back.

    def _launch(self, kernel, staging: torch.Tensor) -> torch.Tensor:
        """``kernel`` over the staged batch, split over the engine's mesh
        (one chunk, one launch, per mesh device); every lane on the host."""
        return mesh_mod.sharded_verifier(kernel, self.mesh)(staging)

    def _note_prep(self, name: str, pad: int, prep_s: float) -> None:
        """Cross-thread stats update for a dispatcher (worker thread):
        padded-lane and host-prep accounting under the stats lock."""
        with self._stats_lock:
            st = self._queues[name].stats
            st.padded_lanes += pad
            st.host_prep_time_s += prep_s
        ring = self._obs_ring
        if ring is not None:
            ring.push(
                self._obs_queue_id(name), pad, int(prep_s * 1e9),
                time.monotonic_ns(),
            )

    def _note_sign_prep(self, name: str, pad: int, prep_s: float) -> None:
        """Sign-queue sibling of :meth:`_note_prep` (worker thread)."""
        with self._stats_lock:
            st = self._sign_queues[name].stats
            st.padded_lanes += pad
            st.host_prep_time_s += prep_s
        ring = self._obs_ring
        if ring is not None:
            ring.push(
                self._obs_queue_id("sign_" + name), pad, int(prep_s * 1e9),
                time.monotonic_ns(),
            )

    def _dispatch_ecdsa(self, items) -> np.ndarray:
        from ..ops import p256

        n = len(items)
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        staging = self._staging.acquire((b, p256.PACKED_COLS), torch.uint16)
        try:
            p256.prepare_packed(items, b, out=staging.numpy())
            self._note_prep("ecdsa_p256", b - n, time.perf_counter() - t0)
            out = self._launch(p256.ecdsa_verify_kernel_packed, staging)
            return out[:n].numpy()
        finally:
            self._staging.release(staging)

    def _dispatch_hmac(self, items) -> np.ndarray:
        from ..ops.hmac_sha256 import PACKED_COLS, hmac_verify_kernel_packed

        n = len(items)
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        # int32 staging carries the u32 words' bits (torch has no uint32
        # arithmetic and the kernel takes a raw pointer); the numpy uint32
        # view is written in place.
        staging = self._staging.acquire((b, PACKED_COLS), torch.int32)
        try:
            words = staging.numpy().view(np.uint32)
            # One bulk big-endian word view of the concatenated batch;
            # padding lanes are all zero.
            words[:n] = np.frombuffer(
                b"".join([key + msg + mac for key, msg, mac in items]),
                dtype=">u4",
            ).reshape(n, PACKED_COLS)
            words[n:] = 0
            self._note_prep("hmac_sha256", b - n, time.perf_counter() - t0)
            out = self._launch(hmac_verify_kernel_packed, staging)
            return out[:n].numpy()
        finally:
            self._staging.release(staging)

    def _dispatch_ed25519(self, items) -> np.ndarray:
        from ..ops import ed25519 as ed

        n = len(items)
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        staging = self._staging.acquire((b, ed.PACKED_COLS), torch.uint16)
        try:
            ed.prepare_packed(items, b, out=staging.numpy())
            self._note_prep("ed25519", b - n, time.perf_counter() - t0)
            out = self._launch(ed.ed25519_verify_kernel_packed, staging)
            return out[:n].numpy()
        finally:
            self._staging.release(staging)

    def _dispatch_sign_ecdsa(self, items) -> list:
        from ..ops import p256

        n = len(items)
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        staging = self._staging.acquire((b, p256.SIGN_COLS), torch.uint16)
        try:
            _k, meta = p256.sign_prepare(items, b, out=staging.numpy())
            prep = time.perf_counter() - t0
            xz = self._launch(p256.ecdsa_kg_kernel, staging).numpy()
            t1 = time.perf_counter()
            sigs = p256.sign_finish(items, meta, xz)
            prep += time.perf_counter() - t1
            self._note_sign_prep("ecdsa_p256", b - n, prep)
            return sigs
        finally:
            self._staging.release(staging)

    def _dispatch_sign_ed25519(self, items) -> list:
        from ..ops import ed25519 as ed

        n = len(items)
        b = _bucket_for(n, self.buckets)
        t0 = time.perf_counter()
        staging = self._staging.acquire((b, ed.SIGN_COLS), torch.uint16)
        try:
            _r, meta = ed.sign_prepare(items, b, out=staging.numpy())
            prep = time.perf_counter() - t0
            xyz = self._launch(ed.ed25519_rb_kernel, staging).numpy()
            t1 = time.perf_counter()
            sigs = ed.sign_finish(meta, xyz)
            prep += time.perf_counter() - t1
            self._note_sign_prep("ed25519", b - n, prep)
            return sigs
        finally:
            self._staging.release(staging)
