"""Open-loop traffic generator (counterpart of
:mod:`minbft_tpu.loadgen.harness`).

:class:`OpenLoopGenerator` drives a seeded :class:`~.arrivals.Schedule`
against a replica cluster: thousands of lightweight client identities
(own keys, own sequence spaces) multiplexed over a BOUNDED pool of real
connections, fired at their scheduled times regardless of how slow the
cluster answers — the open-loop discipline.  Latency is measured from
the SCHEDULED arrival time, so coordinated omission cannot flatter the
curve: a straggling reply is charged the full wait its user would have
experienced, not the (late) moment the generator got around to sending.
The send-origin latency is tracked alongside as the explicit
counter-factual — the regression test pins that the two diverge under an
injected stall and that the REPORTED percentiles come from the
scheduled-origin series.

Design notes:

- Requests are pre-signed before the run starts (the schedule is known
  upfront), so per-request signing cost cannot blunt the offered rate —
  the firing loop only stamps, enqueues, and sleeps until the next
  arrival.
- One pool slot = one connection per replica (``n`` real connections);
  identities map to slots round-robin.  The replica side multiplexes any
  number of client ids over one stream, so 1,000+ identities ride a
  handful of sockets.
- Replicas' BUSY shed signals are honored exactly like the product
  client: a verified-or-counted hold suppresses that request's
  retransmission until ``retry_after_ms`` passes (the request stays
  live).  Reply signature verification is OFF by default — the generator
  must stay cheap enough to saturate the cluster from one process — and
  can be enabled for end-to-end auth runs.
- The live fired-census must equal ``arrivals.replay_census(spec)``
  (checked in :meth:`OpenLoopGenerator.report`): the generator proves it
  was faithful to the seed, the faultnet ``replay_counts`` contract.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

from .. import api
from ..messages import (
    Busy,
    CodecError,
    Reply,
    Request,
    authen_bytes,
    drain_multi,
    marshal,
    pack_group,
    split_group,
    split_multi,
    unmarshal,
)
from ..utils.backoff import RetransmitBackoff
from .arrivals import LoadSpec, Schedule, build_schedule

_log = logging.getLogger("minbft_tpu_torch.loadgen")

# How long past the last scheduled arrival the run waits for stragglers
# before counting them as timeouts.
_DEFAULT_DRAIN_S = 5.0
# BUSY retry-after holds are capped like the product client's.
_MAX_BUSY_HOLD_S = 60.0


class _Identity:
    __slots__ = ("client_id", "auth", "seq")

    def __init__(self, client_id: int, auth: api.Authenticator):
        self.client_id = client_id
        self.auth = auth
        self.seq = 0


class _Pending:
    __slots__ = (
        "key", "slot", "group", "read", "threshold", "sched_s", "send_mono",
        "resolve_mono", "frame", "votes", "count_by_digest", "busy_until",
        "backoff", "next_resend",
    )

    def __init__(
        self, key, slot, group, read, threshold, sched_s, frame, backoff
    ):
        self.key = key  # (client_id, seq)
        self.slot = slot
        self.group = group
        self.read = read
        self.threshold = threshold
        self.sched_s = sched_s  # offset from run start
        self.send_mono = 0.0
        self.resolve_mono = 0.0
        self.frame = frame
        self.votes: Dict[int, None] = {}
        self.count_by_digest: Dict[bytes, int] = {}
        self.busy_until = 0.0
        self.backoff = backoff
        self.next_resend = 0.0

    @property
    def resolved(self) -> bool:
        return self.resolve_mono > 0.0


class _Slot:
    """One pool slot: per-replica outgoing queues + inbound pump tasks
    over ONE stream per replica."""

    __slots__ = ("queues", "tasks")

    def __init__(self):
        self.queues: Dict[int, asyncio.Queue] = {}
        self.tasks: list = []


class OpenLoopGenerator:
    """Drive one schedule against a cluster and report the curve point.

    ``connectors`` is the bounded connection pool: one
    :class:`api.ReplicaConnector` per slot (each slot dials one stream
    per replica).  ``authenticators`` holds one client authenticator per
    identity, parallel to ``client_ids``.
    """

    def __init__(
        self,
        spec: LoadSpec,
        n: int,
        f: int,
        client_ids: Sequence[int],
        authenticators: Sequence[api.Authenticator],
        connectors: Sequence[api.ReplicaConnector],
        retransmit_interval: Optional[float] = 0.5,
        drain_s: float = _DEFAULT_DRAIN_S,
        verify_replies: bool = False,
        schedule: Optional[Schedule] = None,
        slo_target_ms: Optional[float] = None,
    ):
        if len(client_ids) < spec.n_clients:
            raise ValueError(
                f"{len(client_ids)} identities for n_clients="
                f"{spec.n_clients}"
            )
        if len(authenticators) != len(client_ids):
            raise ValueError("client_ids and authenticators must be parallel")
        if not connectors:
            raise ValueError("need at least one pool connector")
        self.spec = spec
        self.n = n
        self.f = f
        self.schedule = schedule or build_schedule(spec)
        self._idents = [
            _Identity(cid, auth)
            for cid, auth in zip(client_ids, authenticators)
        ]
        self._by_client_id = {
            ident.client_id: ident for ident in self._idents
        }
        self._connectors = list(connectors)
        self._retransmit_interval = retransmit_interval
        self._drain_s = drain_s
        self._verify = verify_replies
        self._slots: List[_Slot] = []
        self._pending: Dict[Tuple[int, int], _Pending] = {}
        self._resolved: List[_Pending] = []
        # Fixed keys start at zero to mirror Schedule.census() exactly
        # (a zero count must compare equal, not be a missing key).
        self._fired_census: Dict[str, int] = {
            "arrivals": 0, "reads": 0, "writes": 0, "large": 0, "small": 0,
        }
        self._busy_received = 0
        self._busy_rejected = 0
        self._start_mono = 0.0
        self._fired = 0
        self._late_fire_max_s = 0.0
        # Finality budget for the report's SLO keys: explicit target, or
        # the env/config-resolved policy default (so the bench emits the
        # keys at every curve point without new plumbing).
        if slo_target_ms is None:
            from ..obs.slo import SLOPolicy

            slo_target_ms = SLOPolicy.from_env().target_ms
        self._slo_target_ms = float(slo_target_ms)

    # -- wire plumbing ------------------------------------------------------

    async def _outgoing(self, q: asyncio.Queue) -> AsyncIterator[bytes]:
        while True:
            data, _ = drain_multi(await q.get(), q)
            yield data

    async def _pump_in(self, rid: int, handler, q: asyncio.Queue) -> None:
        try:
            async for data in handler.handle_message_stream(self._outgoing(q)):
                try:
                    frames = split_multi(data)
                except CodecError:
                    continue
                for fr in frames:
                    if self.spec.n_groups > 1:
                        try:
                            _gid, fr = split_group(fr)
                        except CodecError:
                            continue
                    await self._handle_frame(rid, fr)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # Open loop: a dead stream costs that slot's votes from this
            # replica; the run keeps firing (that IS the measurement).
            _log.warning("loadgen stream to replica %d failed: %r", rid, e)

    async def _handle_frame(self, rid: int, fr: bytes) -> None:
        try:
            msg = unmarshal(fr)
        except Exception:
            return
        if isinstance(msg, Busy):
            await self._handle_busy(rid, msg)
            return
        if not isinstance(msg, Reply):
            return
        if msg.replica_id != rid:
            return
        pending = self._pending.get((msg.client_id, msg.seq))
        if pending is None or pending.resolved:
            return
        if msg.replica_id in pending.votes:
            return
        if self._verify:
            ident = self._by_client_id.get(msg.client_id)
            if ident is None:
                return
            try:
                await ident.auth.verify_message_authen_tag(
                    api.AuthenticationRole.REPLICA,
                    msg.replica_id,
                    authen_bytes(msg),
                    msg.signature,
                )
            except api.AuthenticationError:
                return
        pending.votes[msg.replica_id] = None
        digest = hashlib.sha256(
            (b"\x01" if msg.error else b"\x00") + msg.result
        ).digest()
        cnt = pending.count_by_digest.get(digest, 0) + 1
        pending.count_by_digest[digest] = cnt
        if cnt >= pending.threshold:
            pending.resolve_mono = time.monotonic()
            self._resolved.append(pending)
            self._pending.pop(pending.key, None)

    async def _handle_busy(self, rid: int, msg: Busy) -> None:
        pending = self._pending.get((msg.client_id, msg.seq))
        if pending is None or pending.resolved:
            return
        if msg.replica_id != rid:
            return
        if self._verify:
            ident = self._by_client_id.get(msg.client_id)
            if ident is None:
                return
            try:
                await ident.auth.verify_message_authen_tag(
                    api.AuthenticationRole.REPLICA,
                    msg.replica_id,
                    authen_bytes(msg),
                    msg.signature,
                )
            except api.AuthenticationError:
                self._busy_rejected += 1
                return
        self._busy_received += 1
        hold = min(max(msg.retry_after_ms, 0) / 1000.0, _MAX_BUSY_HOLD_S)
        pending.busy_until = max(
            pending.busy_until, time.monotonic() + hold
        )

    # -- run ----------------------------------------------------------------

    async def _prepare(self) -> List[Tuple[object, _Pending]]:
        """Pre-sign every scheduled request; returns (arrival, pending)
        in schedule order.  Signing happens before the clock starts, so
        host sign cost cannot throttle the offered rate."""
        prepared = []
        n_slots = len(self._connectors)
        for i, arr in enumerate(self.schedule.arrivals):
            ident = self._idents[arr.client_idx]
            ident.seq += 1
            # Payload: arrival-stamped then padded to the scheduled size.
            op = (b"load-%d-%d" % (i, arr.payload_len)).ljust(
                arr.payload_len, b"."
            )
            req = Request(
                client_id=ident.client_id,
                seq=ident.seq,
                operation=op,
                read_mode=1 if arr.read else 0,
            )
            req.signature = (
                await ident.auth.generate_message_authen_tag_async(
                    api.AuthenticationRole.CLIENT, authen_bytes(req)
                )
            )
            frame = marshal(req)
            if self.spec.n_groups > 1:
                frame = pack_group(arr.group, frame)
            pending = _Pending(
                key=(ident.client_id, req.seq),
                slot=arr.client_idx % n_slots,
                group=arr.group,
                read=arr.read,
                # fast reads need ALL n matching; writes f+1
                threshold=self.n if arr.read else self.f + 1,
                sched_s=arr.t_ns / 1e9,
                frame=frame,
                backoff=(
                    RetransmitBackoff(self._retransmit_interval)
                    if self._retransmit_interval
                    else None
                ),
            )
            prepared.append((arr, pending))
        return prepared

    async def _open_slots(self) -> None:
        loop = asyncio.get_running_loop()
        for conn in self._connectors:
            slot = _Slot()
            for rid in range(self.n):
                handler = conn.replica_message_stream_handler(rid)
                if handler is None:
                    raise ValueError(f"pool connector missing replica {rid}")
                q: asyncio.Queue = asyncio.Queue()
                slot.queues[rid] = q
                slot.tasks.append(
                    loop.create_task(self._pump_in(rid, handler, q))
                )
            self._slots.append(slot)

    def _broadcast(self, pending: _Pending) -> None:
        for q in self._slots[pending.slot].queues.values():
            q.put_nowait(pending.frame)

    def _fire(self, arr, pending: _Pending) -> None:
        now = time.monotonic()
        pending.send_mono = now
        late = now - (self._start_mono + pending.sched_s)
        if late > self._late_fire_max_s:
            self._late_fire_max_s = late
        if pending.backoff is not None:
            pending.next_resend = now + pending.backoff.next_delay()
        self._pending[pending.key] = pending
        self._broadcast(pending)
        self._fired += 1
        c = self._fired_census
        c["arrivals"] = c.get("arrivals", 0) + 1
        c["reads" if arr.read else "writes"] = (
            c.get("reads" if arr.read else "writes", 0) + 1
        )
        big = arr.payload_len >= self.spec.large_payload
        c["large" if big else "small"] = (
            c.get("large" if big else "small", 0) + 1
        )
        gk = f"group_{arr.group}"
        c[gk] = c.get(gk, 0) + 1

    async def _retransmit_sweep(self) -> None:
        """Product-client retransmission semantics at pool scale: each
        unresolved request re-broadcasts on its own capped-exponential
        ladder, EXCEPT while a BUSY hold is active (the admission
        contract — retransmitting into saturation deepens it)."""
        if self._retransmit_interval is None:
            return
        while True:
            await asyncio.sleep(min(self._retransmit_interval / 2, 0.25))
            now = time.monotonic()
            for pending in list(self._pending.values()):
                if pending.resolved or pending.backoff is None:
                    continue
                if now < pending.next_resend:
                    continue
                pending.next_resend = now + pending.backoff.next_delay()
                if now < pending.busy_until:
                    continue  # honored hold: skip this tick, ladder climbs
                if pending.read:
                    # A fast read needs ALL n replies to MATCH; votes
                    # sampled across concurrent write commits can mix
                    # states and would never converge — each retry is a
                    # fresh all-n sample.
                    pending.votes.clear()
                    pending.count_by_digest.clear()
                self._broadcast(pending)

    async def run(self) -> dict:
        """Execute the schedule; returns :meth:`report`."""
        prepared = await self._prepare()
        await self._open_slots()
        sweeper = asyncio.get_running_loop().create_task(
            self._retransmit_sweep()
        )
        try:
            self._start_mono = time.monotonic()
            for arr, pending in prepared:
                target = self._start_mono + pending.sched_s
                delay = target - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                # NO wait on stragglers: fire at (or as close as the
                # event loop allows to) the scheduled instant.
                self._fire(arr, pending)
            deadline = time.monotonic() + self._drain_s
            while self._pending and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
        finally:
            sweeper.cancel()
            try:
                await sweeper
            except asyncio.CancelledError:
                pass
            for slot in self._slots:
                for t in slot.tasks:
                    t.cancel()
            for slot in self._slots:
                await asyncio.gather(*slot.tasks, return_exceptions=True)
            for conn in self._connectors:
                close = getattr(conn, "close", None)
                if close is not None:
                    try:
                        await close()
                    except Exception:
                        pass
        return self.report()

    # -- reporting ----------------------------------------------------------

    def _percentiles(self, series: List[float]) -> Tuple[float, float]:
        if not series:
            return 0.0, 0.0
        s = sorted(series)

        def pct(q: float) -> float:
            idx = min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))
            return s[idx]

        return pct(0.50), pct(0.99)

    def report(self) -> dict:
        """The curve point: offered rate in, goodput + latency + shed
        visibility out.  ``census_ok`` is the faultnet-style replay
        check: live fired-census == seed-recomputed census."""
        sched_lat = []
        send_lat = []
        for p in self._resolved:
            sched_lat.append(
                p.resolve_mono - (self._start_mono + p.sched_s)
            )
            send_lat.append(p.resolve_mono - p.send_mono)
        p50, p99 = self._percentiles(sched_lat)
        send_p50, send_p99 = self._percentiles(send_lat)
        # Finality series (obs/slo.py semantics): every FIRED request is
        # charged from its SCHEDULED arrival; still-unresolved requests
        # contribute their age-so-far — a finite, honest lower bound that
        # diverges from p99_ms exactly under overload, where dropping
        # timeouts would flatter the tail (coordinated omission again,
        # one level up).
        now = time.monotonic()
        finality = list(sched_lat)
        for p in self._pending.values():
            finality.append(now - (self._start_mono + p.sched_s))
        _, finality_p99 = self._percentiles(finality)
        target_s = self._slo_target_ms / 1e3
        good = sum(1 for lat in sched_lat if lat <= target_s)
        resolved = len(self._resolved)
        expected = self.schedule.census()
        # Wall-clock-honest committed rate: resolved over the span to the
        # LAST resolve.  Under overload the schedule window ends before
        # the backlog drains, so resolved/duration_s would exceed the
        # cluster's real capacity — this is the curve's goodput axis.
        last = max(
            (p.resolve_mono for p in self._resolved),
            default=self._start_mono,
        )
        wall_s = max(last - self._start_mono, self.spec.duration_s)
        return {
            "process": self.spec.process,
            "offered_per_sec": round(self.spec.rate, 3),
            "duration_s": self.spec.duration_s,
            "n_clients": self.spec.n_clients,
            "n_groups": self.spec.n_groups,
            "pool_connections": len(self._connectors) * self.n,
            "arrivals": len(self.schedule.arrivals),
            "fired": self._fired,
            "resolved": resolved,
            "timeouts": self._fired - resolved,
            "goodput_per_sec": round(resolved / self.spec.duration_s, 3),
            "wall_s": round(wall_s, 3),
            "sustained_per_sec": round(resolved / wall_s, 3),
            "p50_ms": round(p50 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            # SLO surface (perf/SLO.md): unresolved requests count as
            # breached, so good_fraction is over FIRED, not resolved.
            "slo_target_ms": round(self._slo_target_ms, 3),
            "finality_p99_ms": round(finality_p99 * 1e3, 3),
            "slo_good_fraction": round(good / max(self._fired, 1), 6),
            # Send-origin counterfactual (coordinated-omission witness):
            # the REPORTED p50/p99 above are scheduled-origin.
            "send_p50_ms": round(send_p50 * 1e3, 3),
            "send_p99_ms": round(send_p99 * 1e3, 3),
            "late_fire_max_ms": round(self._late_fire_max_s * 1e3, 3),
            "busy_received": self._busy_received,
            "busy_rejected": self._busy_rejected,
            "census": dict(self._fired_census),
            "census_ok": self._fired_census == expected,
            "schedule_digest": self.schedule.digest,
            "seed": self.spec.seed,
        }

    def sched_doc(self) -> dict:
        """Scheduled-origin metadata doc for :func:`obs.slo.breach_report`:
        per-request finality from the SCHEDULED arrival, keyed
        ``"cid:seq"``.  Feeding this alongside replica trace dumps
        upgrades breach classification from recv-origin to
        scheduled-origin (the coordinated-omission rule of perf/LOAD.md
        applied to the forensics path, not just the percentile path)."""
        sched_lat_ns = {}
        for p in self._resolved:
            cid, seq = p.key  # (client_id, seq) — a public identity pair
            sched_lat_ns[f"{cid}:{seq}"] = int(
                (p.resolve_mono - (self._start_mono + p.sched_s)) * 1e9
            )
        return {
            "kind": "loadgen",
            "slo_target_ms": self._slo_target_ms,
            "schedule_digest": self.schedule.digest,
            "sched_lat_ns": sched_lat_ns,
        }

    def slo_ring(self, interval_s: float = 1.0):
        """Replay the run's good/breached classifications into a
        :class:`~minbft_tpu_torch.obs.timeseries.TimeSeries` ring, so
        :func:`obs.slo.burn_rates` reads post-hoc burn exactly as a
        live sampler would have.  Ring slots are wall-clock (the
        TimeSeries convention), so monotonic resolve stamps are shifted
        by the current mono->wall offset; still-unresolved fired
        requests land as breached in the current (newest) slot."""
        from ..obs.timeseries import TimeSeries

        span = time.monotonic() - self._start_mono if self._start_mono else 0
        ts = TimeSeries(
            interval_s=interval_s,
            capacity=max(512, int(span / interval_s) + 64),
        )
        wall_off = time.time() - time.monotonic()
        target_s = self._slo_target_ms / 1e3
        for p in self._resolved:
            lat = p.resolve_mono - (self._start_mono + p.sched_s)
            ts.record(
                "slo_good" if lat <= target_s else "slo_breached",
                1,
                "rate",
                t=p.resolve_mono + wall_off,
            )
        for p in self._pending.values():
            ts.record("slo_breached", 1, "rate")
        return ts
