"""Deterministic, seeded fault injection for any ReplicaConnector (the
port's copy of :mod:`minbft_tpu.testing.faultnet`; the same seed gives
the same decisions in both packages, frame by frame).

The protocol's tolerance claims are about NETWORK misbehavior — drops,
delays, duplication, reordering, corruption, half-open stalls, and
partitions — yet transports deliver faithfully in tests.  This module
wraps any :class:`minbft_tpu_torch.api.ReplicaConnector` (in-process, TCP, and
gRPC all flow through the same ``handle_message_stream`` interface) in a
:class:`FaultyConnector` that applies a per-directed-link
:class:`FaultPlan` to every transport frame.

Determinism contract: the fault decision for the k-th frame on a
directed link is a pure function of ``(seed, src, dst, k)`` — each link
owns a :class:`random.Random` seeded from a string of the three (string
seeding is hash-randomization-free), and every frame consumes a FIXED
number of draws regardless of which faults fire.  Replaying the same
frame sequence through the same seed therefore reproduces the identical
fault schedule byte-for-byte (``tests/test_torch_faultnet.py`` holds it against the reference's), and
:meth:`FaultNet.replay_counts` recomputes a live run's per-kind census
from its recorded per-link frame counts alone.

Operator-driven faults — stall, partition/heal, stream reset, crash —
are test-scripted rather than drawn (their timing is wall-clock by
nature); they are censused under their own kinds so a chaos run's full
fault census is scrapeable from the Prometheus endpoint
(:func:`minbft_tpu_torch.obs.prom.collect_faultnet`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
from typing import AsyncIterator, Dict, Optional, Tuple

from .. import api

CHAOS_SEED_ENV = "MINBFT_CHAOS_SEED"

# Strong refs to scheduled aclose() tasks (TL601): the loop keeps only
# a weak reference to a running task, so without this set a deferred
# close is GC-able before the inner generator finalizes.
_close_tasks: set = set()

# The seeded (schedule-driven) fault kinds, in the order their draws are
# consumed per frame — replay_counts depends on this order staying fixed.
SEEDED_KINDS = ("drop", "delay", "duplicate", "reorder", "corrupt", "reset")
# Operator-driven kinds (scripted by the test/CLI, not drawn) — censused
# separately from the seeded schedule so replay_counts stays exact.
SCRIPTED_KINDS = ("stall", "partition", "crash", "restart", "reset_all")


def chaos_seed(default: Optional[int] = None) -> int:
    """Resolve the chaos seed: ``MINBFT_CHAOS_SEED`` wins (replay), then
    ``default``, then a fresh random seed (exploration — the caller must
    print it on failure so the run can be replayed)."""
    env = os.environ.get(CHAOS_SEED_ENV)
    if env:
        return int(env, 0)
    if default is not None:
        return default
    return int.from_bytes(os.urandom(4), "big")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-directed-link fault probabilities (all per frame, independent).

    - ``drop``: frame vanishes;
    - ``delay``: frame is held ``uniform(*delay_s)`` seconds (later frames
      on the link queue behind it — link-FIFO is preserved, like a real
      congested path);
    - ``duplicate``: frame is delivered twice back-to-back;
    - ``reorder``: frame is held and delivered AFTER the next frame
      (adjacent swap — the building block of arbitrary reorderings);
    - ``corrupt``: one byte is flipped (the codec/authenticator must
      reject the frame — corruption must never become acceptance);
    - ``reset``: the stream ENDS (connection drop) — this is what
      exercises the redial + HELLO-replay recovery path, and what heals
      capture gaps left by dropped certified messages.
    """

    drop: float = 0.0
    delay: float = 0.0
    delay_s: Tuple[float, float] = (0.001, 0.02)
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    reset: float = 0.0


#: Named chaos profiles for the CLI (``peer selftest --chaos-profile``)
#: and quick test wiring.  Probabilities are deliberately modest: chaos
#: soaks assert 100% commit, so the network must be hostile, not severed.
PROFILES: Dict[str, FaultPlan] = {
    "lossy": FaultPlan(drop=0.03, delay=0.15, duplicate=0.03, reorder=0.05),
    "flaky": FaultPlan(
        drop=0.03,
        delay=0.12,
        duplicate=0.03,
        reorder=0.05,
        corrupt=0.01,
        reset=0.005,
    ),
    "slow": FaultPlan(delay=0.6, delay_s=(0.005, 0.05)),
}

#: ``peer run`` chaos-plan override (with ``MINBFT_CHAOS_SEED`` set):
#: a profile name from PROFILES or inline ``kind=prob`` pairs.
CHAOS_PLAN_ENV = "MINBFT_CHAOS_PLAN"


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse a chaos-plan spec: a PROFILES name (``"lossy"``) or inline
    comma-separated probabilities (``"drop=0.02,reset=0.01"``).  The
    inline form accepts exactly the seeded FaultPlan fields — an unknown
    kind or a non-numeric value fails loudly (a typo silently yielding
    the all-zero plan would make a chaos soak vacuous)."""
    spec = (spec or "").strip()
    if not spec:
        return PROFILES["lossy"]
    if spec in PROFILES:
        return PROFILES[spec]
    if "=" not in spec:
        raise ValueError(
            f"unknown chaos plan {spec!r}: not a profile "
            f"({', '.join(sorted(PROFILES))}) and not kind=prob pairs"
        )
    kw: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, val = part.partition("=")
        kind = kind.strip()
        if kind not in SEEDED_KINDS:
            raise ValueError(
                f"unknown chaos fault kind {kind!r} in plan {spec!r} "
                f"(choose from {', '.join(SEEDED_KINDS)})"
            )
        try:
            kw[kind] = float(val)
        except ValueError:
            raise ValueError(
                f"bad probability for {kind!r} in chaos plan {spec!r}: "
                f"{val!r}"
            ) from None
    return FaultPlan(**kw)


class FaultCensus:
    """Counters of injected faults, shaped for the Prometheus exposition
    (obs/prom.collect_faultnet): per-kind totals, per-(link, kind)
    breakdown, and per-link frame counts (the replay input).  All
    mutation happens on the event loop; scrapes read GIL-atomic ints
    (the standard obs consistency model, see obs/prom.py)."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.links: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.frames: Dict[Tuple[str, str], int] = {}

    def inc(self, kind: str, link: Optional[Tuple[str, str]] = None) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + 1
        if link is not None:
            per = self.links.setdefault(link, {})
            per[kind] = per.get(kind, 0) + 1

    def note_frame(self, link: Tuple[str, str]) -> None:
        self.frames[link] = self.frames.get(link, 0) + 1

    def seeded_counts(self) -> Dict[str, int]:
        return {k: self.counters.get(k, 0) for k in SEEDED_KINDS}

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "frames_total": sum(self.frames.values()),
            "links": {
                f"{s}>{d}": dict(kinds) for (s, d), kinds in self.links.items()
            },
        }


class _LinkState:
    """Per-directed-link schedule state: the seeded RNG and the cumulative
    frame index.  ``next_decision`` consumes a FIXED number of draws per
    frame (the determinism contract in the module docstring)."""

    def __init__(self, chaos_seed: int, src: str, dst: str):
        self.src = src
        self.dst = dst
        self.rng = random.Random(f"faultnet:{chaos_seed}:{src}>{dst}")
        self.frame_idx = 0

    def next_decision(self, plan: FaultPlan) -> dict:
        self.frame_idx += 1
        r = self.rng
        draws = [r.random() for _ in range(7)]
        lo, hi = plan.delay_s
        return {
            "drop": draws[0] < plan.drop,
            "delay": draws[1] < plan.delay,
            "delay_s": lo + draws[2] * (hi - lo),
            "duplicate": draws[3] < plan.duplicate,
            "reorder": draws[4] < plan.reorder,
            "corrupt": draws[5] < plan.corrupt,
            "reset": draws[6] < plan.reset,
        }


def _corrupt(frame: bytes, rng_byte: int) -> bytes:
    """Flip one byte, position keyed to the frame so replay of the same
    bytes corrupts identically."""
    if not frame:
        return frame
    pos = (rng_byte + len(frame)) % len(frame)
    mut = bytearray(frame)
    mut[pos] ^= 0xA5
    return bytes(mut)


class FaultNet:
    """The shared fault fabric: one instance per simulated network,
    wrapped around every endpoint's connector so scripted faults (stall,
    partition) apply consistently across all links.

    Endpoints are strings: ``"r<id>"`` for replicas, ``"c<id>"`` for
    clients.  A directed link is ``(src, dst)``.
    """

    def __init__(
        self,
        seed: Optional[int] = None,
        default_plan: Optional[FaultPlan] = None,
        census: Optional[FaultCensus] = None,
    ):
        # Public by design: the replay token printed on failure (NOT key
        # material — the name carries "chaos" for the secret-hygiene pass).
        self.chaos_seed = chaos_seed() if seed is None else seed
        self.census = census or FaultCensus()
        self._default_plan = default_plan or FaultPlan()
        # (src|None, dst|None) -> plan; exact match wins, then src-only,
        # then dst-only, then the default.
        self._plans: Dict[Tuple[Optional[str], Optional[str]], FaultPlan] = {}
        self._links: Dict[Tuple[str, str], _LinkState] = {}
        # Scripted state: stall patterns, partition groups, reset epoch.
        self._stalled: set = set()  # of (src|None, dst|None)
        self._partition: Tuple[frozenset, ...] = ()
        self._reset_epoch = 0
        # Swapped+fired on every scripted-state change so parked pipes
        # (stall waits, idle streams pending a reset) re-evaluate.
        self._state_event = asyncio.Event()

    # -- wiring --------------------------------------------------------

    def wrap(self, connector: api.ReplicaConnector, src: str) -> "FaultyConnector":
        """Wrap ``connector`` as endpoint ``src`` ("r2", "c0", ...)."""
        return FaultyConnector(connector, self, src)

    def _link(self, src: str, dst: str) -> _LinkState:
        st = self._links.get((src, dst))
        if st is None:
            st = _LinkState(self.chaos_seed, src, dst)
            self._links[(src, dst)] = st
        return st

    # -- plans ---------------------------------------------------------

    def set_plan(
        self,
        plan: Optional[FaultPlan],
        src: Optional[str] = None,
        dst: Optional[str] = None,
    ) -> None:
        """Install ``plan`` for links matching (src, dst); ``None``
        endpoint = wildcard; ``src=dst=None`` replaces the default plan;
        ``plan=None`` removes the override."""
        if src is None and dst is None:
            self._default_plan = plan or FaultPlan()
            return
        if plan is None:
            self._plans.pop((src, dst), None)
        else:
            self._plans[(src, dst)] = plan

    def heal(self) -> None:
        """Back to a faithful network: clears every plan override, the
        default plan, all stalls, and any partition.  Live streams keep
        flowing (use :meth:`reset_all` to force clean redials too)."""
        self._plans.clear()
        self._default_plan = FaultPlan()
        self._stalled.clear()
        self._partition = ()
        self._kick()

    def plan_for(self, src: str, dst: str) -> FaultPlan:
        for key in ((src, dst), (src, None), (None, dst)):
            p = self._plans.get(key)
            if p is not None:
                return p
        return self._default_plan

    # -- scripted faults ----------------------------------------------

    def _kick(self) -> None:
        ev, self._state_event = self._state_event, asyncio.Event()
        ev.set()

    def stall(self, src: Optional[str] = None, dst: Optional[str] = None) -> None:
        """Half-open stall for links matching (src, dst): connections
        stay up, frames stop flowing until :meth:`unstall`."""
        self._stalled.add((src, dst))
        self._kick()

    def unstall(self, src: Optional[str] = None, dst: Optional[str] = None) -> None:
        self._stalled.discard((src, dst))
        self._kick()

    def stall_replica(self, replica_id: int) -> None:
        """Stall EVERY link touching a replica — the wedged-process /
        dead-NIC-but-open-socket scenario the request-timeout path must
        detect (a closed connection is the easy case)."""
        ep = f"r{replica_id}"
        self.stall(src=ep)
        self.stall(dst=ep)

    def unstall_replica(self, replica_id: int) -> None:
        ep = f"r{replica_id}"
        self.unstall(src=ep)
        self.unstall(dst=ep)

    def is_stalled(self, src: str, dst: str) -> bool:
        s = self._stalled
        return bool(s) and (
            (src, dst) in s or (src, None) in s or (None, dst) in s
        )

    def partition(self, *groups) -> None:
        """Split the listed endpoint groups: frames between different
        groups are dropped (censused as "partition") until :meth:`heal`
        or :meth:`heal_partition`.  Endpoints in NO group (typically
        clients) keep talking to everyone."""
        self._partition = tuple(frozenset(g) for g in groups)
        self._kick()

    def heal_partition(self) -> None:
        self._partition = ()
        self._kick()

    def is_partitioned(self, src: str, dst: str) -> bool:
        gs = self._partition
        if not gs:
            return False
        a = next((i for i, g in enumerate(gs) if src in g), None)
        b = next((i for i, g in enumerate(gs) if dst in g), None)
        return a is not None and b is not None and a != b

    def reset_all(self) -> None:
        """End every live stream flowing through this net (each counted
        as a "reset"): the callers' redial loops reconnect and the HELLO
        replay re-streams full logs — the convergence step after a chaos
        phase, and the recovery that heals any capture gap a dropped
        certified message left behind."""
        self._reset_epoch += 1
        self._kick()

    def crash(self, target, endpoint: str) -> None:
        """Crash a whole replica via its stub/handle (anything with a
        ``crash()`` — e.g. ``sample.conn.inprocess.ReplicaStub``),
        censused under "crash"."""
        target.crash()
        self.census.inc("crash", (endpoint, "*"))

    def restart(self, target, endpoint: str) -> None:
        """Revive a crashed stub (``revive()``), censused under
        "restart"; the caller re-assigns/starts the replica instance."""
        target.revive()
        self.census.inc("restart", (endpoint, "*"))

    # -- the frame pipe ------------------------------------------------

    async def pipe(
        self, src: str, dst: str, frames: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        """Apply the (src → dst) fault schedule to a frame stream.

        Ends (StopAsyncIteration to the consumer) on a drawn "reset" or a
        scripted :meth:`reset_all` — the transport above interprets that
        as a dropped connection and redials."""
        link = self._link(src, dst)
        census = self.census
        epoch = self._reset_epoch
        held: Optional[bytes] = None
        ait = frames.__aiter__()
        nxt: Optional[asyncio.Future] = None
        try:
            while True:
                nxt = asyncio.ensure_future(ait.__anext__())
                # Race the next frame against scripted-state changes so
                # an idle stream still honors reset_all promptly.
                while not nxt.done():
                    kick = asyncio.ensure_future(self._state_event.wait())
                    await asyncio.wait(
                        {nxt, kick}, return_when=asyncio.FIRST_COMPLETED
                    )
                    kick.cancel()
                    if self._reset_epoch != epoch:
                        census.inc("reset_all", (src, dst))
                        return
                try:
                    frame = nxt.result()
                except StopAsyncIteration:
                    break
                nxt = None

                census.note_frame((src, dst))
                d = link.next_decision(self.plan_for(src, dst))

                # Census the DRAWN schedule first — a pure function of
                # (seed, link, frame index), with reset > drop > rest
                # precedence, so replay_counts can recompute it from the
                # per-link frame counts alone.  A drawn fault can still
                # be a no-op in effect (a duplicate of a frame the
                # reorder is holding, a drop of a frame a partition
                # already discards): the census records the schedule,
                # scripted kinds record the effects.
                if d["reset"]:
                    census.inc("reset", (src, dst))
                elif d["drop"]:
                    census.inc("drop", (src, dst))
                else:
                    for kind in ("corrupt", "delay", "reorder", "duplicate"):
                        if d[kind]:
                            census.inc(kind, (src, dst))

                if d["reset"]:
                    return
                # Scripted stall: hold delivery, connection stays open.
                if self.is_stalled(src, dst):
                    census.inc("stall", (src, dst))
                    while self.is_stalled(src, dst):
                        await self._state_event.wait()
                        if self._reset_epoch != epoch:
                            census.inc("reset_all", (src, dst))
                            return
                if self.is_partitioned(src, dst):
                    census.inc("partition", (src, dst))
                    continue
                if d["drop"]:
                    continue
                if d["corrupt"]:
                    frame = _corrupt(frame, link.frame_idx)
                if d["delay"]:
                    await asyncio.sleep(d["delay_s"])
                if d["reorder"] and held is None:
                    held = frame
                    continue
                yield frame
                if held is not None:
                    out, held = held, None
                    yield out
                if d["duplicate"]:
                    yield frame
            if held is not None:
                yield held
        finally:
            if nxt is not None:
                if nxt.done():
                    # Retrieve the result/StopAsyncIteration a scripted
                    # reset abandoned, or asyncio logs "exception was
                    # never retrieved" at teardown.
                    try:
                        nxt.exception()
                    except asyncio.CancelledError:
                        pass
                else:
                    # cancel() can lose the race: the underlying asend
                    # may complete (e.g. with StopAsyncIteration when the
                    # source just ended) before the cancellation lands,
                    # and that exception would then be "never retrieved".
                    nxt.cancel()
                    nxt.add_done_callback(
                        lambda t: t.cancelled() or t.exception()
                    )

            # May run under GeneratorExit (consumer closed us), where
            # awaiting is not allowed: schedule the inner close instead
            # (the inprocess _DeferredHandler pattern).
            async def _close() -> None:
                try:
                    await ait.aclose()
                except BaseException:
                    pass

            if hasattr(ait, "aclose"):
                t = asyncio.get_running_loop().create_task(_close())
                _close_tasks.add(t)
                t.add_done_callback(_close_tasks.discard)

    # -- replay --------------------------------------------------------

    def replay_counts(
        self,
        frame_counts: Optional[Dict[Tuple[str, str], int]] = None,
        plan: Optional[FaultPlan] = None,
    ) -> Dict[str, int]:
        """Recompute the seeded per-kind injection counts for the given
        per-link frame counts (default: this net's recorded census) from
        the seed alone — fresh RNGs, no live state.  A live run's census
        matching this proves its injections followed the deterministic
        schedule; the same seed + the same frame counts always reproduce
        the same totals.  ``plan`` pins the plan the run used (pass it
        when replaying a snapshot taken before a heal — plan_for would
        otherwise see the healed, fault-free plan)."""
        frame_counts = (
            dict(self.census.frames) if frame_counts is None else frame_counts
        )
        totals = {k: 0 for k in SEEDED_KINDS}
        for (src, dst), count in frame_counts.items():
            link = _LinkState(self.chaos_seed, src, dst)
            link_plan = plan if plan is not None else self.plan_for(src, dst)
            for _ in range(count):
                d = link.next_decision(link_plan)
                if d["reset"]:
                    totals["reset"] += 1
                    continue
                if d["drop"]:
                    totals["drop"] += 1
                    continue
                for k in ("corrupt", "delay", "reorder", "duplicate"):
                    if d[k]:
                        totals[k] += 1
        return totals


class _FaultyStreamHandler(api.MessageStreamHandler):
    """One wrapped stream: outgoing frames ride the (src → dst) schedule,
    the peer's responses ride (dst → src)."""

    def __init__(
        self,
        inner: api.MessageStreamHandler,
        net: FaultNet,
        src: str,
        dst: str,
    ):
        self._inner = inner
        self._net = net
        self._src = src
        self._dst = dst

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        net, src, dst = self._net, self._src, self._dst
        out = self._inner.handle_message_stream(net.pipe(src, dst, in_stream))
        async for frame in net.pipe(dst, src, out):
            yield frame


class FaultyConnector(api.ReplicaConnector):
    """Wrap any ReplicaConnector so every stream it opens flows through
    the FaultNet's per-directed-link schedules.  Unknown attributes
    (``connect_replica``, ``close``, ...) delegate to the inner
    connector, so transport-specific wiring keeps working."""

    def __init__(self, inner: api.ReplicaConnector, net: FaultNet, src: str):
        self._inner = inner
        self._net = net
        self._src = src

    def replica_message_stream_handler(
        self, replica_id: int
    ) -> Optional[api.MessageStreamHandler]:
        handler = self._inner.replica_message_stream_handler(replica_id)
        if handler is None:
            return None
        return _FaultyStreamHandler(
            handler, self._net, self._src, f"r{replica_id}"
        )

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyConnectionHandler(api.ConnectionHandler):
    """Server-side sibling of :class:`FaultyConnector`: wraps an
    ``api.ConnectionHandler`` so ACCEPTED streams flow through the net —
    how a real transport server (TcpReplicaServer, gRPC) is put behind
    the fault fabric.  Dialer identities are unknown at accept time, so
    the far end is labeled generically ("peer"/"client")."""

    def __init__(self, inner: api.ConnectionHandler, net: FaultNet, endpoint: str):
        self._inner = inner
        self._net = net
        self._endpoint = endpoint

    def peer_message_stream_handler(self) -> api.MessageStreamHandler:
        return _FaultyStreamHandler(
            self._inner.peer_message_stream_handler(),
            self._net,
            "peer",
            self._endpoint,
        )

    def client_message_stream_handler(self) -> api.MessageStreamHandler:
        return _FaultyStreamHandler(
            self._inner.client_message_stream_handler(),
            self._net,
            "client",
            self._endpoint,
        )


class ProcessChaos:
    """SIGKILL + restart chaos for real-OS-process clusters.

    The in-process :class:`FaultNet` injects NETWORK faults; this is its
    PROCESS sibling for deployments made of real ``peer run`` processes
    (tests/test_process_cluster.py, the recovery soak): registered
    targets are killed with SIGKILL — no graceful close on any stream,
    no atexit, exactly a machine reset — and restarted through the same
    spawn factory.  Kills and restarts are censused under the scripted
    kinds ("crash"/"restart"), so a soak's fault history reads out of
    the same :class:`FaultCensus` surface as the network faults.

    Not seeded: kill timing is wall-clock by nature (the operator or
    the soak script decides WHEN); determinism in a recovery soak comes
    from the load schedule's seed and the durable store's contents, not
    from the kill instant.
    """

    def __init__(self, census: Optional[FaultCensus] = None):
        self.census = census or FaultCensus()
        self._procs: Dict[str, object] = {}
        self._spawn: Dict[str, object] = {}

    def manage(self, name: str, spawn, proc=None):
        """Register a target: ``spawn()`` must return a started
        ``subprocess.Popen``-alike (``kill``/``wait``/``poll``).  Pass
        ``proc`` when the first incarnation is already running;
        otherwise the factory is invoked once, immediately."""
        self._spawn[name] = spawn
        self._procs[name] = proc if proc is not None else spawn()
        return self._procs[name]

    def proc(self, name: str):
        return self._procs[name]

    def alive(self, name: str) -> bool:
        p = self._procs.get(name)
        return p is not None and p.poll() is None

    def kill(self, name: str, wait: float = 10.0):
        """SIGKILL the target and reap it.  Idempotent on an already-
        dead process (the census records the intent either way — a soak
        script's kill is a fault even if the target beat it to dying)."""
        p = self._procs[name]
        p.kill()
        p.wait(timeout=wait)
        self.census.inc("crash", link=(name, name))
        return p

    def restart(self, name: str):
        """Respawn a killed target through its registered factory."""
        self._procs[name] = self._spawn[name]()
        self.census.inc("restart", link=(name, name))
        return self._procs[name]

    def kill_restart(self, name: str, wait: float = 10.0):
        """The canonical crash-recovery event: SIGKILL, reap, respawn."""
        self.kill(name, wait=wait)
        return self.restart(name)

    def terminate_all(self, wait: float = 10.0) -> None:
        """Teardown helper: TERM every live target, escalate to KILL on
        a hung wait.  Never censused — shutdown is not a fault."""
        for p in self._procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self._procs.values():
            try:
                p.wait(timeout=wait)
            except Exception:  # noqa: BLE001 - teardown must reach kill
                p.kill()
