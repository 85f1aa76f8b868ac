"""Multi-group replica runtime: G consensus cores, one transport, one engine
(counterpart of :mod:`minbft_tpu.groups.runtime`).

Layout (the DSig cross-flow amortization argument):

- :class:`GroupRuntime` hosts G independent :class:`~minbft_tpu_torch.core.
  replica._Replica` cores behind ONE listener and ONE set of peer
  connections.  Each core owns its group's full protocol state — view,
  sequence spaces, USIG counter space (a per-group authenticator
  instance), message log, checkpoints — exactly as if it ran alone.
- The wire carries a transport-level group envelope
  (:func:`minbft_tpu_torch.messages.codec.pack_group`; group 0 stays bare, so
  a G=1 runtime is wire-identical to the ungrouped one).  The envelope
  is framing, never signed: :class:`GroupAuthenticator` domain-separates
  the SIGNATURES per group instead, so a frame re-tagged to another
  group can never verify there.
- **Shared engine coalescing is by construction, not by scheduling**:
  every core's authenticator lands verify/sign traffic in the SAME
  ``parallel/engine`` queue instances (kernels K2, K3 and K6 on the card),
  and the grouped client stream
  runs ONE bundle-ingest drain — a tick's decoded bundle spans groups,
  and each group's ``preverify_requests`` seed fires in the same loop
  turn, so the engine's batch fill rises with G at fixed per-group load
  (pinned by the grouped engine test of the port's test suite).

Concurrency: every mux/demux structure below is confined to the owning
event loop.  Per-group queues
are BOUNDED and drop-on-full — one wedged group may lose frames (its
gap/idle watchdogs heal via redial replay) but can never head-of-line
block another group's traffic on the shared channel (the group-isolation
contract, also pinned by tests).
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Dict, List, Optional, Set, Tuple

from .. import api
from ..core.admission import AdmissionController, admission_enabled
from ..core.message_handling import (
    _BundleIngestor,
    _ConcurrentStreamProcessor,
    _TurnSequencer,
    bundle_ingest_enabled,
)
from ..core.replica import _Replica
from ..messages import (
    GROUP_MAX,
    CodecError,
    Request,
    drain_multi,
    marshal,
    pack_group,
    split_group,
    split_group_batch,
    split_multi,
    unmarshal_batch,
)
from ..messages.codec import _TAG_HELLO, _TAG_MULTI
from ..obs import trace as obs_trace

# codec._TAG_MULTI: the grouped client drain must split one more
# container level — the client's own coalescing rides inside the group
# envelope.  Imported (not re-declared) so a tag renumbering in the
# codec, which owns the tag space, can never silently desync the demux.
_MULTI_TAG = _TAG_MULTI

# Frames buffered per group between the shared channel and one group's
# consumer.  Bounded + drop-on-full: a full queue means that group's
# pipeline is wedged or saturated, and blocking the SHARED demux on it
# would stall every other group (the isolation contract).  Dropped
# certified traffic heals through the per-group gap/idle redial
# watchdogs, dropped requests through client retransmission.
_GROUP_RX_BOUND = 1024

_EOF = object()


class GroupAuthenticator(api.Authenticator):
    """Per-group signature domain separation over one base authenticator.

    The group envelope is transport framing — unsigned by design (it
    must be strippable before decode).  Without domain separation, a
    REQUEST/REPLY/HELLO signed for group g would verify verbatim in
    group g' whenever the two groups share key material (the keystore
    deployment: one key per replica, one per client), and per-group
    sequence spaces would then execute the replay in the wrong shard.
    Prefixing every signed byte string with the group id closes that:
    both sides wrap symmetrically, so in-group verification is
    unchanged and cross-group replays fail as bad signatures.

    Group 0 keeps the EMPTY prefix: its signatures — like its wire
    frames — are byte-identical to the ungrouped runtime's, so a plain
    client can talk to group 0 of a grouped cluster.

    The USIG role passes through with the same prefix; counter state
    lives in the BASE authenticator, which is why the runtime requires
    one base instance per group (shared counters would break per-group
    UI contiguity).  Unknown attributes (``reset_usig_epoch``,
    ``allow_epoch_capture_from``, ``supports_query`` probes) delegate to
    the base."""

    def __init__(self, base: api.Authenticator, group: int):
        self._base = base
        self.group = int(group)
        self._prefix = b"" if group == 0 else b"minbft-group:%d|" % group

    def _msg(self, msg: bytes) -> bytes:
        p = self._prefix
        return msg if not p else p + msg

    def generate_message_authen_tag(
        self, role: api.AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        return self._base.generate_message_authen_tag(
            role, self._msg(msg), audience
        )

    async def generate_message_authen_tag_async(
        self, role: api.AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        return await self._base.generate_message_authen_tag_async(
            role, self._msg(msg), audience
        )

    async def verify_message_authen_tag(
        self, role: api.AuthenticationRole, peer_id: int, msg: bytes, tag: bytes
    ) -> None:
        await self._base.verify_message_authen_tag(
            role, peer_id, self._msg(msg), tag
        )

    @property
    def supports_batch_verify(self) -> bool:
        return self._base.supports_batch_verify

    async def verify_message_authen_tags(
        self, role: api.AuthenticationRole, items
    ) -> list:
        return await self._base.verify_message_authen_tags(
            role, [(p, self._msg(m), t) for p, m, t in items]
        )

    def __getattr__(self, name):
        return getattr(self._base, name)


# ---------------------------------------------------------------------------
# Shared-channel mux: one physical stream per destination, G logical
# per-group streams over it.


class _SharedChannel:
    """ONE physical stream to one destination, carrying every group's
    logical stream as group-tagged frames.

    Dial side of the shared transport: the first logical attach opens
    the physical stream (a driver task that demuxes incoming frames
    into bounded per-group queues and pumps a shared tx queue out,
    ``drain_multi``-coalescing across groups); later attaches ride it.
    When the physical stream dies, every logical consumer sees EOF and
    its own redial loop re-attaches — the first re-attach redials the
    physical stream.

    A group-level teardown (the gap or idle watchdog closing its
    logical stream) leaves the physical stream ALONE — one chaotic
    group redialing in a storm must never churn the channel every other
    group shares (the isolation contract; an early design that reset
    the physical stream on detach measurably starved healthy groups
    under the chaos soak).  The re-attach's fresh HELLO restarts the
    group's server-side subscription instead — see
    :class:`_GroupedPeerStreamHandler`'s HELLO-restart rule."""

    def __init__(
        self,
        handler: api.MessageStreamHandler,
        log: logging.Logger,
    ):
        self._handler = handler
        self._log = log
        self._tx: Optional[asyncio.Queue] = None
        self._rx: Dict[int, asyncio.Queue] = {}
        self._driver: Optional[asyncio.Task] = None
        self._closed = False

    def _ensure_driver(self) -> None:
        if self._driver is None or self._driver.done():
            tx: asyncio.Queue = asyncio.Queue()
            self._tx = tx
            self._driver = asyncio.get_running_loop().create_task(
                self._drive(tx)
            )

    async def _drive(self, tx: asyncio.Queue) -> None:
        async def phys_out() -> AsyncIterator[bytes]:
            while True:
                data, _ = drain_multi(await tx.get(), tx)
                yield data

        try:
            async for data in self._handler.handle_message_stream(phys_out()):
                try:
                    frames = split_multi(data)
                except CodecError as e:
                    self._log.warning("shared channel: bad frame: %s", e)
                    continue
                for fr in frames:
                    try:
                        gid, inner = split_group(fr)
                    except CodecError as e:
                        self._log.warning("shared channel: bad envelope: %s", e)
                        continue
                    q = self._rx.get(gid)
                    if q is None:
                        continue  # group not attached (or unknown): drop
                    try:
                        q.put_nowait(inner)
                    except asyncio.QueueFull:
                        # Group isolation: a wedged group loses ITS
                        # frames, never the channel (redial replay /
                        # retransmission heal the loss).
                        self._log.warning(
                            "shared channel: group %d rx full, dropping", gid
                        )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # transport failure: logical redials recover
            self._log.warning("shared channel failed: %r", e)
        finally:
            for q in self._rx.values():
                try:
                    q.put_nowait(_EOF)
                except asyncio.QueueFull:
                    # The consumer is parked mid-drain, not in get(): it
                    # re-checks the driver on its next get and exits.
                    pass

    async def _pump_out(
        self, gid: int, outgoing: AsyncIterator[bytes], tx: asyncio.Queue
    ) -> None:
        try:
            async for fr in outgoing:
                await tx.put(pack_group(gid, fr))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._log.warning("group %d outgoing pump failed: %r", gid, e)

    def _attach(self, gid: int) -> asyncio.Queue:
        """Register group ``gid``'s rx queue (sync — loop-atomic with the
        driver's demux by construction)."""
        q: asyncio.Queue = asyncio.Queue(maxsize=_GROUP_RX_BOUND)
        self._rx[gid] = q
        return q

    def _detach(self, gid: int, q: asyncio.Queue) -> None:
        """Drop ``gid``'s registration iff it is still ``q`` — a redial
        may have re-attached a fresh queue under the same gid."""
        if self._rx.get(gid) is q:
            del self._rx[gid]

    async def logical(
        self, gid: int, outgoing: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        """Group ``gid``'s logical stream over this channel (the body of
        its :class:`_GroupStreamHandler`)."""
        if self._closed:
            return
        self._ensure_driver()
        driver = self._driver
        q = self._attach(gid)
        pump = asyncio.get_running_loop().create_task(
            self._pump_out(gid, outgoing, self._tx)
        )
        try:
            while True:
                if q.empty() and driver.done():
                    return  # EOF sentinel was dropped by a full queue
                fr = await q.get()
                if fr is _EOF:
                    return
                yield fr
        finally:
            pump.cancel()
            pump.add_done_callback(lambda t: t.cancelled() or t.exception())
            self._detach(gid, q)

    def _shutdown(self) -> Optional[asyncio.Task]:
        """Sync half of :meth:`close`: latch closed, cancel and hand back
        the driver (loop-atomic — no attach can interleave)."""
        self._closed = True
        driver, self._driver = self._driver, None
        if driver is not None:
            driver.cancel()
        return driver

    async def close(self) -> None:
        driver = self._shutdown()
        if driver is not None:
            try:
                await driver
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass


class _GroupStreamHandler(api.MessageStreamHandler):
    def __init__(self, channel: _SharedChannel, gid: int):
        self._channel = channel
        self._gid = gid

    def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        return self._channel.logical(self._gid, in_stream)


class _GroupConnector(api.ReplicaConnector):
    """One group's view of the shared mux: an ordinary ReplicaConnector
    whose streams are logical sub-streams of the per-destination shared
    channels — the group cores (and inner clients) use it unchanged."""

    def __init__(self, mux: "SharedChannelMux", gid: int):
        self._mux = mux
        self._gid = gid

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        ch = self._mux.channel(replica_id)
        if ch is None:
            return None
        return _GroupStreamHandler(ch, self._gid)


class SharedChannelMux:
    """Per-destination :class:`_SharedChannel` registry over one real
    connector — the dial side of the shared transport (peer dials in
    :class:`GroupRuntime`, replica dials in
    :class:`~minbft_tpu_torch.groups.router.MultiGroupClient`)."""

    def __init__(
        self,
        connector: api.ReplicaConnector,
        log: Optional[logging.Logger] = None,
    ):
        self._connector = connector
        self._log = log or logging.getLogger("minbft.groups.mux")
        self._channels: Dict[int, _SharedChannel] = {}

    def group_connector(self, gid: int) -> api.ReplicaConnector:
        return _GroupConnector(self, gid)

    def channel(self, dest_id: int) -> Optional[_SharedChannel]:
        ch = self._channels.get(dest_id)
        if ch is None:
            handler = self._connector.replica_message_stream_handler(dest_id)
            if handler is None:
                return None
            ch = _SharedChannel(handler, self._log)
            self._channels[dest_id] = ch
        return ch

    def seal(self) -> None:
        """Refuse new logical attaches/driver starts — called before a
        multi-core teardown so one core's stream closure (which resets
        live shared channels by design) cannot race the next core's
        redial loop into opening fresh physical streams mid-shutdown."""
        for ch in self._channels.values():
            ch._closed = True

    def _drain_channels(self) -> List[_SharedChannel]:
        """Sync half of :meth:`close`: empty the registry loop-atomically
        so no task can dial a drained entry mid-teardown."""
        chans = list(self._channels.values())
        self._channels.clear()
        return chans

    async def close(self) -> None:
        for ch in self._drain_channels():
            await ch.close()


# ---------------------------------------------------------------------------
# Server side: demux one incoming stream to per-group cores.


# HELLO's wire tag (codec._TAG_HELLO, imported above): the grouped peer
# demux peeks ONE byte to spot a logical redial — see the restart rule
# below.
_HELLO_TAG = _TAG_HELLO


class _GroupedPeerStreamHandler(api.MessageStreamHandler):
    """Server side of a shared peer connection: demux group-tagged
    frames to each group core's real
    :class:`~minbft_tpu_torch.core.message_handling.PeerStreamHandler` (HELLO
    handshake, broadcast-log subscription and all), and merge their
    output streams back with group tags — one physical stream carries G
    broadcast logs.

    **HELLO-restart rule**: a fresh HELLO for a group that already has a
    live sub-stream means the dialer's LOGICAL stream redialed (gap/idle
    watchdog) while the shared physical stream stayed up — the old
    subscription cannot serve the replay the watchdog redialed for, so
    the sub-stream is torn down and restarted from the new HELLO (its
    ``resume_counter`` scopes the replay).  The dialer's peer-stream
    direction carries nothing but HELLOs, so the one-byte peek cannot
    misfire on protocol traffic; a Byzantine peer spamming HELLOs only
    churns its own sub-stream (HELLO replay is harmless by the
    messages.Hello invariant)."""

    def __init__(self, runtime: "GroupRuntime"):
        self._rt = runtime

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        rt = self._rt
        out: asyncio.Queue = asyncio.Queue()
        subs: Dict[int, asyncio.Queue] = {}
        gtasks: Dict[int, asyncio.Task] = {}
        loop = asyncio.get_running_loop()

        def start_group(gid: int) -> Optional[asyncio.Queue]:
            core = rt.core_or_none(gid)
            if core is None:
                rt.log.warning("peer stream for unknown group %d dropped", gid)
                return None
            in_q: asyncio.Queue = asyncio.Queue(maxsize=_GROUP_RX_BOUND)
            subs[gid] = in_q

            async def gen() -> AsyncIterator[bytes]:
                while True:
                    fr = await in_q.get()
                    if fr is _EOF:
                        return
                    yield fr

            handler = core.peer_message_stream_handler()

            async def run() -> None:
                try:
                    async for data in handler.handle_message_stream(gen()):
                        await out.put(pack_group(gid, data))
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # One group's handler failing (bad HELLO, auth
                    # error) costs that group's sub-stream only.
                    rt.log.warning("group %d peer sub-stream failed: %r", gid, e)

            gtasks[gid] = loop.create_task(run())
            return in_q

        def restart_group(gid: int) -> Optional[asyncio.Queue]:
            task = gtasks.pop(gid, None)
            if task is not None:
                task.cancel()
            subs.pop(gid, None)
            return start_group(gid)

        async def demux() -> None:
            async for data in in_stream:
                try:
                    frames = split_multi(data)
                except CodecError as e:
                    rt.log.warning("grouped peer stream: bad frame: %s", e)
                    continue
                for fr in frames:
                    try:
                        gid, inner = split_group(fr)
                    except CodecError as e:
                        rt.log.warning("grouped peer stream: bad envelope: %s", e)
                        continue
                    q = subs.get(gid)
                    if q is None:
                        q = start_group(gid)
                        if q is None:
                            continue
                    elif inner and inner[0] == _HELLO_TAG:
                        # logical redial: restart from this HELLO
                        q = restart_group(gid)
                        if q is None:
                            continue
                    elif gtasks[gid].done():
                        # dead sub-stream, non-HELLO frame: the dialer's
                        # watchdogs will redial with a HELLO — drop.
                        continue
                    try:
                        q.put_nowait(inner)
                    except asyncio.QueueFull:
                        # isolation: drop this group's frame, never block
                        core = rt.core_or_none(gid)
                        if core is not None:
                            core.handlers.metrics.inc("messages_dropped")

        demux_task = loop.create_task(demux())
        try:
            while True:
                fr = await out.get()
                data, _ = drain_multi(fr, out)
                yield data
        finally:
            # Cancel-and-await: a demux() failure (not just cancellation)
            # re-raises here instead of rotting as an unretrieved task
            # exception.
            demux_task.cancel()
            for t in gtasks.values():
                t.cancel()
            try:
                await demux_task
            except asyncio.CancelledError:
                pass


class _GroupBundleIngestor(_BundleIngestor):
    """The grouped client stream's SHARED rx drain: one pump + one tick
    loop for the whole stream, so a tick's bundle spans groups.

    A tick strips the group envelopes with one vectorized classify
    (``split_group_batch``), decodes EVERY group's frames in ONE
    ``unmarshal_batch`` call, then per group seeds the engine verify
    queue (``preverify_requests``) and fans out — all G seeds fire in
    the same loop turn, before any per-message validation awaits, so
    the whole cross-group bundle lands in the shared ``_SchemeQueue``
    pending set ahead of one flush decision.  THIS is where verify
    batch fill rises with G by construction."""

    def __init__(self, runtime: "GroupRuntime", state, on_error):
        # The anchor (group 0) handlers only receive the base class's
        # stream-level accounting (pump errors); per-group metrics ride
        # the per-group handlers below.
        super().__init__(runtime.anchor_handlers, on_error, submit=None)
        self._rt = runtime
        self._state = state  # gid -> per-group stream state (or None)

    async def _ingest(self, frames: list) -> None:
        if not frames:
            return
        gids: List[int] = []
        inners: List[bytes] = []
        for gid, inner in split_group_batch(frames):
            if isinstance(gid, CodecError):
                self._on_error(gid)
                continue
            # The envelope wraps a LOGICAL transport frame: the client's
            # own drain_multi coalescing rides INSIDE it (the mux's
            # physical coalescing was already split by the base tick
            # loop), so one more container level can appear here.
            if inner and inner[0] == _MULTI_TAG:
                try:
                    sub = split_multi(inner)
                except CodecError as e:
                    self._on_error(e)
                    continue
                gids.extend([gid] * len(sub))
                inners.extend(sub)
            else:
                gids.append(gid)
                inners.append(inner)
        if not inners:
            return
        per: Dict[int, list] = {}
        for gid, m in zip(gids, unmarshal_batch(inners)):
            if isinstance(m, CodecError):
                self._on_error(m)
            else:
                per.setdefault(gid, []).append(m)
        # Seed EVERY group's engine checks first (same loop turn — the
        # cross-group coalescing point), then fan out per group.
        states = []
        for gid, msgs in per.items():
            st = self._state(gid)
            if st is None:
                self._rt.log.warning(
                    "client bundle for unknown group %d dropped (%d frames)",
                    gid,
                    len(msgs),
                )
                continue
            h = st.h
            h.metrics.observe_ingest(len(msgs))
            tr = h.trace
            if tr is not None:
                for m in msgs:
                    if isinstance(m, Request):
                        tr.note(obs_trace.R_INGEST, m.client_id, m.seq)
            sl = h.slo
            if sl is not None:
                for m in msgs:
                    if isinstance(m, Request):
                        sl.arrive(m.client_id, m.seq)
            h.preverify_requests(msgs)
            states.append((st, msgs))
        for st, msgs in states:
            for m in msgs:
                # Drop-on-saturation, never block: a wedged group's full
                # processor sheds its own messages (client retransmission
                # heals), the shared tick loop keeps draining the other
                # groups — the isolation contract, at the handler layer.
                # With admission control on, the shed is signaled (signed
                # group-tagged BUSY) instead of silent.
                if st.adm is not None:
                    await st.adm.submit_msg(m)
                elif not await st.proc.try_submit_msg(m):
                    st.h.metrics.inc("messages_dropped")
                    st.h.log.warning(
                        "group processor saturated, dropping client message"
                    )


class _GroupClientState:
    """Per-group slice of one grouped client stream: the group's
    handlers, its arrival-order sequencer, and its bounded concurrent
    processor (exactly the trio the ungrouped ClientStreamHandler keeps
    per stream)."""

    __slots__ = ("h", "turns", "proc", "adm")


class _GroupedClientStreamHandler(api.MessageStreamHandler):
    """Server side of a shared client connection: REQUESTs of every
    group in, group-tagged REPLYs out.

    Unlike the peer side (which demuxes to per-group sub-streams so the
    HELLO/log-replay machinery stays untouched), the client side runs
    ONE bundle ingest drain across groups — see
    :class:`_GroupBundleIngestor`.  Per-group ordering is preserved:
    arrival-order tickets are issued per group in fan-out order, and
    fan-out order is bundle order is arrival order."""

    def __init__(self, runtime: "GroupRuntime"):
        self._rt = runtime

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        rt = self._rt
        out_queue: asyncio.Queue = asyncio.Queue()
        FIN = object()
        states: Dict[int, Optional[_GroupClientState]] = {}

        def state(gid: int) -> Optional[_GroupClientState]:
            st = states.get(gid)
            if st is None and gid not in states:
                core = rt.core_or_none(gid)
                if core is None:
                    states[gid] = None  # cache the unknown-group verdict
                    return None
                st = _GroupClientState()
                st.h = core.handlers
                st.turns = _TurnSequencer()

                async def handle_one(
                    msg, _h=st.h, _turns=st.turns, _gid=gid
                ) -> None:
                    t = _turns.ticket()
                    try:
                        reply = await _h.handle_client_message(
                            msg, turn=(_turns, t)
                        )
                    finally:
                        _turns.finish(t)
                    if reply is None:
                        return
                    data = pack_group(_gid, marshal(reply))
                    tr = _h.trace
                    if tr is not None:
                        tr.note(
                            obs_trace.R_REPLY_SENT, reply.client_id, reply.seq
                        )
                    await out_queue.put(data)

                def _drop(e: Exception, _h=st.h) -> None:
                    _h.metrics.inc("messages_dropped")
                    _h.log.warning("dropping client message: %s", e)

                st.proc = _ConcurrentStreamProcessor(handle_one, _drop)
                st.adm = (
                    AdmissionController(
                        st.h,
                        st.proc,
                        out_queue,
                        wrap=lambda b, _gid=gid: pack_group(_gid, b),
                    )
                    if admission_enabled()
                    else None
                )
                states[gid] = st
            return st

        def _drop_stream(e: Exception) -> None:
            # Envelope/codec errors at the shared drain are not
            # attributable to a group: account them on the anchor.
            rt.anchor_handlers.metrics.inc("messages_dropped")
            rt.log.warning("dropping client frame: %s", e)

        async def consume() -> None:
            if bundle_ingest_enabled():
                await _GroupBundleIngestor(rt, state, _drop_stream).run(
                    in_stream
                )
            else:
                async for data in in_stream:
                    try:
                        frames = split_multi(data)
                    except CodecError as e:
                        _drop_stream(e)
                        continue
                    for fr in frames:
                        try:
                            gid, inner = split_group(fr)
                            sub = split_multi(inner)
                        except CodecError as e:
                            _drop_stream(e)
                            continue
                        st = state(gid)
                        if st is not None:
                            for one in sub:
                                # same drop-on-saturation isolation
                                # contract as the bundle path above
                                if st.adm is not None:
                                    await st.adm.submit(one)
                                elif not await st.proc.try_submit(one):
                                    st.h.metrics.inc("messages_dropped")
            for st in states.values():
                if st is not None:
                    await st.proc.drain()
            await out_queue.put(FIN)

        consumer_task = asyncio.get_running_loop().create_task(consume())
        try:
            while True:
                item = await out_queue.get()
                if item is FIN:
                    break
                data, fin = drain_multi(item, out_queue, stop=FIN)
                yield data
                if fin:
                    break
        finally:
            consumer_task.cancel()
            try:
                await consumer_task
            except asyncio.CancelledError:
                pass


# ---------------------------------------------------------------------------
# The runtime.


class GroupRuntime(api.Replica):
    """G independent MinBFT group cores in one replica process, over one
    connector and one engine.

    ``authenticators`` must be one PER-GROUP base instance each (own
    USIG counter state — shared counters would break per-group UI
    contiguity); the runtime wraps each in :class:`GroupAuthenticator`
    for signature domain separation unless ``domain_separation=False``.
    ``consumers`` is one state machine per group (one key-space shard
    each).  ``wrap_group_connector(gid, connector)`` lets tests inject
    group-scoped faults between a core and the shared mux (the
    multi-group chaos soak partitions ONE group this way)."""

    def __init__(
        self,
        replica_id: int,
        configer: api.Configer,
        authenticators: List[api.Authenticator],
        connector: api.ReplicaConnector,
        consumers: List[api.RequestConsumer],
        timer_provider=None,
        logger: Optional[logging.Logger] = None,
        domain_separation: bool = True,
        wrap_group_connector=None,
        engine_pool=None,
        state_dir: Optional[str] = None,
    ):
        if not authenticators:
            raise ValueError("need at least one group authenticator")
        if len(authenticators) > GROUP_MAX + 1:
            # fail at construction, not as a CodecError deep in the
            # first send pump (the envelope's gid field is a u16)
            raise ValueError(
                f"{len(authenticators)} groups exceed the wire envelope's "
                f"maximum of {GROUP_MAX + 1}"
            )
        if len(consumers) != len(authenticators):
            raise ValueError(
                f"{len(consumers)} consumers for {len(authenticators)} groups"
            )
        self.id = replica_id
        self.n_groups = len(authenticators)
        self.log = logger or logging.getLogger(
            f"minbft.replica{replica_id}.groups"
        )
        self._mux = SharedChannelMux(connector, log=self.log)
        # The multi-device engine pool (parallel/pool.py) is not ported:
        # every group core here shares the one engine its authenticators
        # were built with.
        if engine_pool is not None:
            from ..api import NotPortedError

            raise NotPortedError("GroupRuntime(engine_pool=...) (parallel/pool.py)", "7")
        self.engine_pool = None
        self.cores: List[_Replica] = []
        for g, (auth, consumer) in enumerate(zip(authenticators, consumers)):
            if domain_separation:
                auth = GroupAuthenticator(auth, g)
            conn_g = self._mux.group_connector(g)
            if wrap_group_connector is not None:
                conn_g = wrap_group_connector(g, conn_g)
            core = _Replica(
                replica_id,
                configer,
                auth,
                conn_g,
                consumer,
                timer_provider,
                logging.getLogger(f"minbft.replica{replica_id}.g{g}"),
                group=g,
                # store_path gives each group core its own group<g>/
                # subdirectory under the shared state dir.
                state_dir=state_dir,
            )
            self.cores.append(core)
        # Stale-group detector state: per-group
        # (requests_executed count, monotonic stamp of last change),
        # lazily refreshed by stale_groups() — no watcher task.
        self._progress: Dict[int, Tuple[int, float]] = {}

    # -- api.Replica ---------------------------------------------------

    def peer_message_stream_handler(self) -> api.MessageStreamHandler:
        return _GroupedPeerStreamHandler(self)

    def client_message_stream_handler(self) -> api.MessageStreamHandler:
        return _GroupedClientStreamHandler(self)

    async def start(self) -> None:
        for core in self.cores:
            await core.start()

    async def stop(self) -> None:
        self._mux.seal()
        for core in self.cores:
            await core.stop()
        await self._mux.close()

    # -- accessors ------------------------------------------------------

    def group(self, gid: int) -> _Replica:
        return self.cores[gid]

    def core_or_none(self, gid: int) -> Optional[_Replica]:
        if 0 <= gid < len(self.cores):
            return self.cores[gid]
        return None

    @property
    def anchor_handlers(self):
        """Group 0's handlers: the accounting anchor for shared-stream
        events no single group owns (pump errors, bad envelopes)."""
        return self.cores[0].handlers

    @property
    def metrics(self):
        """Group 0's metrics, for ungrouped callers; per-group metrics
        live on each core (``runtime.group(g).metrics``), and
        :meth:`metrics_aggregate` folds them."""
        return self.cores[0].metrics

    def metrics_aggregate(self) -> dict:
        from ..utils.metrics import aggregate

        return aggregate(core.metrics.snapshot() for core in self.cores)

    def stale_groups(self, threshold_s: float = 30.0) -> Set[int]:
        """Groups whose commit counter has not moved for ``threshold_s``
        while at least one sibling group progressed within that window.

        The sibling clause keeps an idle cluster healthy: staleness is
        *relative* starvation (one group wedged while others commit),
        not absence of load.  State is refreshed lazily on each call —
        callers (the Prometheus scrape, ``peer top``) poll anyway, so a
        watcher task would add nothing but a thread.
        """
        import time as _time

        now = _time.monotonic()
        freshest = None
        for core in self.cores:
            count = core.metrics.counters.get("requests_executed", 0)
            prev = self._progress.get(core.group)
            if prev is None or prev[0] != count:
                self._progress[core.group] = (count, now)
                changed = now
            else:
                changed = prev[1]
            if freshest is None or changed > freshest:
                freshest = changed
        if freshest is None or now - freshest > threshold_s:
            # Everyone is quiet (or there are no cores): idle, not stale.
            return set()
        return {
            g
            for g, (_, changed) in self._progress.items()
            if now - changed > threshold_s
        }

    def dump_trace(self, base=None) -> List[str]:
        """Dump every group core's flight recorder (one file per core —
        the group rides the filename AND the doc)."""
        paths = []
        for core in self.cores:
            p = core.dump_trace(base=base)
            if p is not None:
                paths.append(p)
        return paths


def new_group_runtime(
    replica_id: int,
    configer: api.Configer,
    authenticators: List[api.Authenticator],
    connector: api.ReplicaConnector,
    consumers: List[api.RequestConsumer],
    **kw,
) -> GroupRuntime:
    """Create a multi-group replica runtime (the ``new_replica`` sibling
    for ``peer run --groups G``)."""
    return GroupRuntime(
        replica_id, configer, authenticators, connector, consumers, **kw
    )
