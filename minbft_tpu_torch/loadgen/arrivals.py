"""Seeded open-loop arrival schedules (counterpart of
:mod:`minbft_tpu.loadgen.arrivals`: the same spec gives the reference's
schedule, digest and census byte for byte).

A schedule is a pure function of its :class:`LoadSpec` — same spec,
byte-identical schedule (:attr:`Schedule.digest`), across processes and
platforms.  Every random draw comes from ONE ``random.Random(seed)``
instance in a FIXED order per arrival (inter-arrival gap, then client,
then read flag, then payload class), mirroring the faultnet determinism
contract (``testing.faultnet`` SEEDED_KINDS draw order): adding a draw
or reordering draws is a breaking change to seed compatibility and must
bump the process name.

Two arrival processes:

- ``poisson``: memoryless gaps at the offered rate — the millions-of-
  independent-users regime.
- ``onoff``: bursty on/off periods whose ON rate is scaled so the
  time-averaged offered rate matches the spec — the synchronized-burst
  regime (thundering herds, retry storms).

The census (:meth:`Schedule.census`) is the replayable summary the
harness's LIVE fired-census is checked against
(:func:`replay_census` == what actually got fired), exactly the
``FaultNet.replay_counts`` contract: a divergence means the generator
dropped or invented traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import struct
from typing import Dict, Tuple

from ..groups.router import ShardRouter

_PROCESSES = ("poisson", "onoff")
_ARRIVAL_PACK = struct.Struct(">QIBIH")


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One open-loop run's full parameterization.  Frozen: the spec IS
    the schedule's identity (hash it, log it, replay it)."""

    seed: int
    rate: float  # offered arrivals/sec (time-averaged for onoff)
    duration_s: float
    n_clients: int = 1000
    process: str = "poisson"
    # Workload mix: fraction of fast-read arrivals (read_mode=1) and of
    # large payloads among the writes/reads.
    read_fraction: float = 0.0
    large_fraction: float = 0.0
    small_payload: int = 16
    large_payload: int = 1024
    # onoff process shape: ON window / OFF window seconds.  The ON rate
    # is rate * (on_s + off_s) / on_s so the offered average holds.
    on_s: float = 0.25
    off_s: float = 0.25
    # Consensus groups: arrivals are routed by the existing ShardRouter
    # over a per-client shard key (client affinity — one client's seqs
    # stay in one group's sequence space).
    n_groups: int = 1

    def validate(self) -> None:
        if self.process not in _PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.rate <= 0 or self.duration_s <= 0 or self.n_clients <= 0:
            raise ValueError("rate, duration_s and n_clients must be > 0")
        if not (0.0 <= self.read_fraction <= 1.0):
            raise ValueError("read_fraction must be in [0, 1]")
        if not (0.0 <= self.large_fraction <= 1.0):
            raise ValueError("large_fraction must be in [0, 1]")
        if self.process == "onoff" and (self.on_s <= 0 or self.off_s < 0):
            raise ValueError("onoff needs on_s > 0 and off_s >= 0")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: WHEN (ns offset from run start — ints so
    the digest has no float-representation hazard), WHO (client index),
    WHAT (read flag + payload bytes), and WHERE (consensus group)."""

    t_ns: int
    client_idx: int
    read: bool
    payload_len: int
    group: int


class Schedule:
    """An immutable arrival sequence plus its identity digest."""

    def __init__(self, spec: LoadSpec, arrivals: Tuple[Arrival, ...]):
        self.spec = spec
        self.arrivals = arrivals

    @property
    def digest(self) -> str:
        """SHA-256 over the packed arrival tuple — byte-identical
        schedules have equal digests (the determinism test's witness)."""
        h = hashlib.sha256()
        for a in self.arrivals:
            h.update(
                _ARRIVAL_PACK.pack(
                    a.t_ns, a.client_idx, 1 if a.read else 0,
                    a.payload_len, a.group,
                )
            )
        return h.hexdigest()

    def census(self) -> Dict[str, int]:
        """Replayable traffic summary (the faultnet ``replay_counts``
        mirror): what a faithful generator MUST have fired."""
        c = {
            "arrivals": len(self.arrivals),
            "reads": 0,
            "writes": 0,
            "large": 0,
            "small": 0,
        }
        for a in self.arrivals:
            c["reads" if a.read else "writes"] += 1
            big = a.payload_len >= self.spec.large_payload
            c["large" if big else "small"] += 1
            gk = f"group_{a.group}"
            c[gk] = c.get(gk, 0) + 1
        return c


def build_schedule(spec: LoadSpec) -> Schedule:
    """Materialize the spec's schedule.  Pure: no clock, no I/O."""
    spec.validate()
    rng = random.Random(spec.seed)
    router = ShardRouter(spec.n_groups)
    # Client shard keys are deterministic strings; the router's SHA-256
    # hash spreads them across groups regardless of index distribution.
    groups = [
        router.group_for(b"loadgen-client-%d" % i)
        for i in range(spec.n_clients)
    ]
    horizon_ns = int(spec.duration_s * 1e9)
    if spec.process == "onoff":
        on_rate = spec.rate * (spec.on_s + spec.off_s) / spec.on_s
        cycle_s = spec.on_s + spec.off_s
    arrivals = []
    on_time = 0.0  # poisson: wall clock; onoff: accumulated ON time
    while True:
        # Draw-order contract (see module docstring): gap, client, read,
        # payload class — one draw each, every arrival, even when a
        # fraction is 0 or 1.
        if spec.process == "poisson":
            on_time += rng.expovariate(spec.rate)
            wall_s = on_time
        else:
            on_time += rng.expovariate(on_rate)
            # Map accumulated ON time onto the wall clock by inserting
            # the OFF gap after every completed ON window.
            cycles = int(on_time // spec.on_s)
            wall_s = cycles * cycle_s + (on_time - cycles * spec.on_s)
        t_ns = int(wall_s * 1e9)
        if t_ns >= horizon_ns:
            break
        cidx = rng.randrange(spec.n_clients)
        read = rng.random() < spec.read_fraction
        big = rng.random() < spec.large_fraction
        arrivals.append(
            Arrival(
                t_ns=t_ns,
                client_idx=cidx,
                read=read,
                payload_len=(
                    spec.large_payload if big else spec.small_payload
                ),
                group=groups[cidx],
            )
        )
    return Schedule(spec, tuple(arrivals))


def replay_census(spec: LoadSpec) -> Dict[str, int]:
    """Recompute the census from the spec alone (the seed-replay side of
    the faultnet contract).  The harness's live fired-census must equal
    this, or the generator was not faithful to the schedule."""
    return build_schedule(spec).census()
