"""Multi-device engine pool: one batching engine per home chip.

Port of :mod:`minbft_tpu.parallel.pool`, over CUDA devices.  G consensus
groups sharing one :class:`~minbft_tpu_torch.parallel.engine.BatchVerifier`
raise batch fill with G, because every group's authenticator lands its
checks in the same queues; :class:`EnginePool` keeps that per chip:

- one :class:`BatchVerifier` per home chip, with its own queues, staging
  tensors and dedup memo, on its device (``BatchVerifier(device=...)``);
- a **placement policy** mapping each consensus group to exactly one home
  chip (``group % chips`` on first touch), so all groups homed on a chip
  coalesce into that chip's queues and no batch is split across chips;
- a **rebalance hook** fed by the per-chip ``busy × fill`` score of the
  utilization ledger: :meth:`rebalance` moves one group off the hottest
  chip, but never a group with calls in flight (its outstanding futures
  resolve on the engine that owns its memo and staging state);
- a **striping path** for oversized explicit batches: a
  ``verify_*_many`` call larger than ``stripe_threshold`` goes through a
  mesh engine (:mod:`.mesh`), which splits the batch over every chip.

``chips=1`` builds exactly ONE engine with the pool's keywords, and every
facade call forwards to it: results, stats and launch counts are the bare
engine's.

The facades mirror the port's engine surface, which has no host queues
(the reference's ``*_host`` methods and ``verify_nist_host`` have no
counterpart).  The placement map, the per-group in-flight counters and the
facade cache are confined to the event loop; scrape threads only read
them (GIL-atomic), as they read the engine stats.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..ops import backend
from . import mesh as mesh_mod
from .engine import BatchVerifier


class _GroupEngine:
    """One group's BatchVerifier-compatible facade over the pool.

    Forwards the engine's verify and sign surface to the group's CURRENT
    home-chip engine (placement is read per call, so a rebalance takes
    effect on the next submission), counting in-flight calls per group
    for :meth:`EnginePool.rebalance`.  Attribute reads (``stats``,
    ``queue_depths``, ...) fall through to the home engine.
    """

    __slots__ = ("_pool", "group")

    def __init__(self, pool: "EnginePool", group: int):
        self._pool = pool
        self.group = int(group)

    @property
    def home(self) -> BatchVerifier:
        return self._pool._engines[self._pool.home_chip(self.group)]

    async def _call(self, name: str, *args):
        pool = self._pool
        g = self.group
        eng = pool._engines[pool.home_chip(g)]
        # Loop-atomic bump (before the await, decrement after): rebalance
        # reads it between awaits on the same loop, so a group moves only
        # with no future outstanding.
        pool._inflight[g] = pool._inflight.get(g, 0) + 1
        try:
            return await getattr(eng, name)(*args)
        finally:
            pool._inflight[g] -= 1

    async def _call_many(self, name: str, items):
        pool = self._pool
        g = self.group
        eng = pool._route_many(g, len(items))
        pool._inflight[g] = pool._inflight.get(g, 0) + 1
        try:
            return await getattr(eng, name)(items)
        finally:
            pool._inflight[g] -= 1

    # -- verify surface (the engine's) ---------------------------------------

    def verify_ecdsa_p256(self, pubkey, digest, sig):
        return self._call("verify_ecdsa_p256", pubkey, digest, sig)

    def verify_hmac_sha256(self, key, msg32, mac):
        return self._call("verify_hmac_sha256", key, msg32, mac)

    def verify_ed25519(self, pub, msg, sig):
        return self._call("verify_ed25519", pub, msg, sig)

    # The _many entry points may stripe: a batch above stripe_threshold
    # already fills several chips' buckets, so it gains nothing from its
    # home chip.

    def verify_ecdsa_p256_many(self, items):
        return self._call_many("verify_ecdsa_p256_many", items)

    def verify_ed25519_many(self, items):
        return self._call_many("verify_ed25519_many", items)

    # -- sign surface ---------------------------------------------------------

    def sign_ecdsa_p256(self, d, digest):
        return self._call("sign_ecdsa_p256", d, digest)

    def sign_ed25519(self, seed, msg):
        return self._call("sign_ed25519", seed, msg)

    def __getattr__(self, name):
        # stats / queue_depths / dedup / buckets / device / ... — read-side
        # passthrough to the current home engine.
        return getattr(self._pool._engines[self._pool.home_chip(self.group)], name)


class EnginePool:
    """One :class:`BatchVerifier` per home chip, with group placement.

    ``devices`` lists torch device specs, one a chip; ``None`` is every
    visible CUDA device.  ``chips`` requests the pool width and clamps to
    the length of that list (``requested_chips`` keeps the ask); a list
    may repeat a device.  With one chip the pool owns exactly one engine,
    built with the pool's keywords (on ``devices[0]`` when a list is
    given, else on the engine's default device).

    ``stripe_threshold`` (default: the engines' ``max_batch``) sets the
    explicit-batch size above which ``verify_*_many`` goes through the
    mesh engine over the pool's chips instead of the home chip; a 1-chip
    pool never stripes.  All remaining keyword arguments construct each
    per-chip :class:`BatchVerifier` identically.
    """

    def __init__(
        self,
        chips: int = 1,
        *,
        devices: Optional[list] = None,
        stripe_threshold: Optional[int] = None,
        **engine_kwargs,
    ):
        if chips < 1:
            raise ValueError(f"chips must be >= 1, got {chips}")
        if "mesh" in engine_kwargs or "device" in engine_kwargs:
            raise ValueError(
                "the pool owns device/mesh placement; pass chips=/devices="
            )
        self.requested_chips = int(chips)
        if chips > 1 and devices is None:
            devices = mesh_mod.devices_from()
        if devices is not None and chips > len(devices):
            # Fewer devices than asked: a narrower pool, never an
            # oversubscribed one.
            chips = max(len(devices), 1)
        self.chips = int(chips)
        if chips == 1:
            if devices:
                engine_kwargs["device"] = devices[0]
            engines = [BatchVerifier(**engine_kwargs)]
        else:
            engines = [
                BatchVerifier(device=devices[c], **engine_kwargs)
                for c in range(chips)
            ]
        self._engines: Tuple[BatchVerifier, ...] = tuple(engines)
        self._devices = [e.device for e in engines]
        # Mesh engine over the pool's chips for oversized explicit
        # batches, built only for a real multi-chip pool.
        self._striped: Optional[BatchVerifier] = None
        self.stripe_threshold: Optional[int] = None
        if self.chips > 1:
            self._striped = BatchVerifier(
                mesh=mesh_mod.make_mesh(self._devices), **engine_kwargs
            )
            self.stripe_threshold = (
                int(stripe_threshold)
                if stripe_threshold is not None
                else int(self._engines[0].max_batch)
            )
        # group -> home chip; facade cache; per-group in-flight counters.
        # All loop-confined (see module docstring).
        self._placement: Dict[int, int] = {}
        self._facades: Dict[int, _GroupEngine] = {}
        self._inflight: Dict[int, int] = {}
        # Rolling per-chip utilization windows (chip_utilization):
        # DeviceLedger baselines captured at the previous call.
        self._util_ledgers: Optional[list] = None
        # Ceilings re-applied to every rolling window (set_ceiling).
        self._ceilings: Dict[str, Tuple[float, str]] = {}

    @classmethod
    def over(cls, device, chips: int, max_batch: int) -> "EnginePool":
        """A replica's pool over the devices of ``device``: the one CPU
        device for ``"cpu"``, else every visible CUDA device from
        ``device`` on; ``chips`` 0 means all of them, and a larger ask
        clamps to them.  One bucket of ``max_batch`` lanes, as a
        replica's shared engine; on the CPU the sign queues run the plain
        k*G / r*B."""
        dev = backend.resolve_device(device)
        devices = mesh_mod.devices_from(dev)
        return cls(
            chips=chips if chips > 0 else len(devices),
            devices=devices,
            max_batch=max_batch,
            buckets=(max_batch,),
            sign_on_device=True if dev.type == "cpu" else None,
        )

    # -- placement -----------------------------------------------------------

    @property
    def engines(self) -> Tuple[BatchVerifier, ...]:
        return self._engines

    @property
    def striped_engine(self) -> Optional[BatchVerifier]:
        return self._striped

    @property
    def device(self) -> torch.device:
        """Chip 0's device (every chip's device is of one type)."""
        return self._devices[0]

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    def home_chip(self, group: int) -> int:
        """The group's home chip, assigned ``group % chips`` on first
        touch; every group maps to exactly one chip."""
        chip = self._placement.get(group)
        if chip is None:
            chip = group % self.chips
            self._placement[group] = chip
        return chip

    def engine_for(self, group: int) -> _GroupEngine:
        """The group's engine facade (cached: one identity per group)."""
        fac = self._facades.get(group)
        if fac is None:
            self.home_chip(group)  # place eagerly
            fac = _GroupEngine(self, group)
            self._facades[group] = fac
        return fac

    def placement(self) -> Dict[int, int]:
        return dict(self._placement)

    def groups_on(self, chip: int) -> List[int]:
        return sorted(g for g, c in self._placement.items() if c == chip)

    def group_inflight(self, group: int) -> int:
        return self._inflight.get(group, 0)

    def _route_many(self, group: int, n_items: int) -> BatchVerifier:
        if (
            self._striped is not None
            and self.stripe_threshold is not None
            and n_items > self.stripe_threshold
        ):
            return self._striped
        return self._engines[self.home_chip(group)]

    def rebalance(
        self,
        scores: Optional[List[float]] = None,
        min_gap: float = 0.25,
    ) -> Dict[int, Tuple[int, int]]:
        """Move one group off the hottest chip when the per-chip
        ``busy × fill`` scores diverge.

        ``scores[c]`` is chip ``c``'s load score (higher = busier);
        defaults to :meth:`chip_scores`.  When the hottest chip exceeds
        the coolest by more than ``min_gap``, the highest-numbered group
        homed on the hottest chip with no call in flight moves to the
        coolest.  Returns ``{group: (old_chip, new_chip)}`` (empty when
        balanced or nothing may move).
        """
        if self.chips < 2:
            return {}
        if scores is None:
            scores = self.chip_scores()
        if len(scores) != self.chips:
            raise ValueError(f"{len(scores)} scores for a {self.chips}-chip pool")
        hot = max(range(self.chips), key=lambda c: scores[c])
        cool = min(range(self.chips), key=lambda c: scores[c])
        if hot == cool or scores[hot] - scores[cool] <= min_gap:
            return {}
        movable = [g for g in self.groups_on(hot) if self._inflight.get(g, 0) == 0]
        if not movable:
            return {}
        # Later groups are the round-robin overflow that made the chip hot.
        g = movable[-1]
        self._placement[g] = cool
        return {g: (hot, cool)}

    # -- utilization (the busy × fill feed) ----------------------------------

    def set_ceiling(self, queue: str, lanes_per_sec: float, source: str) -> None:
        """Calibrated per-chip full-batch lane rate for ``queue`` with
        provenance, applied to every rolling utilization window."""
        if lanes_per_sec <= 0:
            raise ValueError("ceiling must be positive")
        self._ceilings[queue] = (float(lanes_per_sec), source)

    def _fresh_ledgers(self, now=None) -> list:
        from ..obs.ledger import DeviceLedger

        leds = [DeviceLedger(e, now=now) for e in self._engines]
        for led in leds:
            for q, (rate, source) in self._ceilings.items():
                led.set_ceiling(q, rate, source)
        return leds

    def chip_utilization(self, now=None) -> List[dict]:
        """Per-chip rows over the window since the previous call: busy
        fraction, fill efficiency (lane-weighted across the chip's active
        queues; 1.0 under a self ceiling), the ``busy × fill`` score, the
        current total queue depth and the groups homed there.  The first
        call sets the baselines and reads all-idle rows."""
        prev = self._util_ledgers
        self._util_ledgers = self._fresh_ledgers(now=now)
        rows: List[dict] = []
        for c, eng in enumerate(self._engines):
            busy = 0.0
            fill = 1.0
            if prev is not None:
                wins = prev[c].snapshot(now=now)
                if wins:
                    wall = max(w.wall_s for w in wins.values())
                    busy = min(
                        sum(w.busy_s for w in wins.values()) / max(wall, 1e-9), 1.0
                    )
                    lanes = sum(w.dispatched_lanes for w in wins.values())
                    if lanes > 0:
                        fill = sum(
                            prev[c].decompose(w).fill_efficiency * w.dispatched_lanes
                            for w in wins.values()
                        ) / lanes
            depth = sum(eng.queue_depths().values()) + sum(
                eng.sign_queue_depths().values()
            )
            rows.append(
                {
                    "chip": c,
                    "device": str(self._devices[c]),
                    "busy": round(busy, 4),
                    "fill": round(fill, 4),
                    "score": round(busy * fill, 4),
                    "depth": depth,
                    "groups": self.groups_on(c),
                }
            )
        return rows

    def chip_up(self, chip: int) -> bool:
        """False when EVERY instantiated queue on the chip's engine timed
        out on its last dispatch (a timeout since its last success): the
        ``peer top`` DOWN row.  The port has no device write-off, so this
        is its reading of the reference's "every queue written off".  A
        chip with no queues yet is up."""
        eng = self._engines[chip]
        qs = list(dict(eng._queues).values()) + list(dict(eng._sign_queues).values())
        if not qs:
            return True
        return any(q._consecutive_timeouts == 0 for q in qs)

    def chip_scores(self, now=None) -> List[float]:
        """The per-chip ``busy × fill`` placement scores over the window
        since the last :meth:`chip_utilization` call."""
        return [row["score"] for row in self.chip_utilization(now=now)]

    # -- merged read-side surfaces (prom / timeseries compatibility) ---------
    #
    # Shaped like one BatchVerifier's maps, so engine consumers
    # (register_engine_series, the prom engine families) take a pool
    # unchanged.  A 1-chip pool uses the bare queue names; a multi-chip
    # pool prefixes "c{chip}:", with the striped engine's traffic under
    # "stripe:".

    def _merged(self, getter) -> Dict[str, object]:
        if self.chips == 1 and self._striped is None:
            return getter(self._engines[0])
        out: Dict[str, object] = {}
        for c, eng in enumerate(self._engines):
            for name, v in getter(eng).items():
                out[f"c{c}:{name}"] = v
        if self._striped is not None:
            for name, v in getter(self._striped).items():
                out[f"stripe:{name}"] = v
        return out

    @property
    def stats(self) -> Dict[str, object]:
        return self._merged(lambda e: e.stats)

    @property
    def sign_stats(self) -> Dict[str, object]:
        return self._merged(lambda e: e.sign_stats)

    def queue_depths(self) -> Dict[str, int]:
        return self._merged(lambda e: e.queue_depths())

    def sign_queue_depths(self) -> Dict[str, int]:
        return self._merged(lambda e: e.sign_queue_depths())

    def queue_depth_peaks(self, reset: bool = True) -> Dict[str, int]:
        return self._merged(lambda e: e.queue_depth_peaks(reset=reset))

    def sign_queue_depth_peaks(self, reset: bool = True) -> Dict[str, int]:
        return self._merged(lambda e: e.sign_queue_depth_peaks(reset=reset))
