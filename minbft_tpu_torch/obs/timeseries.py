"""Time-resolved telemetry rings: fixed-capacity per-interval series.

Everything the repo measured before this module is an end-of-run
aggregate — a committed req/s MEAN, a cumulative histogram, a one-shot
scrape.  The >100x underutilization headline (ROADMAP) is invisible in
aggregates: a run that saturates for 5 seconds and stalls for 25 shows
the same mean as a run that plods evenly.  These rings keep the SHAPE:
one slot per wall-clock interval (default 1s), a bounded window of them
(default 600 = 10 minutes), written concurrently by samplers and read
by scrapes, dumps, and the bench artifact's saturation timeline.

Design rules, inherited from :class:`~minbft_tpu.obs.hist.Log2Histogram`:

- **Exact merge.**  Every slot stores ``(sum, n)`` keyed by the ABSOLUTE
  interval index ``floor(epoch_seconds / interval)``, so merging two
  rings is slot-wise pair addition — associative and commutative, no
  re-binning, no argument order sensitivity.  ``rate`` series read as
  the sum (cluster totals add); ``gauge`` series read as ``sum/n``
  (the cross-process mean of sampled depths/lags) — both derived from
  the same merged pairs, so the merge itself never has to know which
  reading a consumer wants.
- **Bounded memory.**  Writing an interval prunes anything older than
  ``capacity`` intervals behind it; a ring can run for a week and hold
  ten minutes.
- **Counter-delta discipline.**  Rate series record per-interval DELTAS
  of cumulative counters (the sampler below keeps the baselines).  A
  counter that goes backwards (the bench's warm-up stats reset swaps in
  a fresh ``VerifyStats``) re-baselines and records nothing — a reset
  must read as "no data", never as a negative rate.

Cross-node alignment uses the wall clock (the indices are epoch-based).
That is deliberate: NTP-grade skew (well under the 1s interval) moves a
sample by at most one slot, and the alternative — per-process monotonic
origins — would make merge meaningless.  Incarnation honesty is handled
one level up: dumps carry ``run_id`` (obs/runinfo.py) and
:func:`merge_timeseries_docs` REFUSES to splice two incarnations of the
same replica id into one timeline.

Port of :mod:`minbft_tpu.obs.timeseries` (a copy).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import runinfo

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 600

_KINDS = ("rate", "gauge")


class IncarnationMismatch(ValueError):
    """Two dumps claim the same replica id but different ``run_id``s —
    splicing them would chimera a restarted replica's fresh counters
    onto its predecessor's timeline, so the merge refuses."""


class TimeSeries:
    """A bundle of named per-interval series sharing one clock grid.

    Thread-safe: samplers on worker threads and the asyncio loop may
    ``record`` concurrently while a scrape thread reads — all state
    mutates under ``_lock`` (the MTStageRing discipline;
    tools/analyze/project.py pins it).
    """

    __slots__ = ("interval_s", "capacity", "_series", "_kinds", "_lock")

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        # name -> {abs_interval_index: [sum, n]}
        self._series: Dict[str, Dict[int, List[float]]] = {}
        self._kinds: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- writing ---------------------------------------------------------

    def index_for(self, t: Optional[float] = None) -> int:
        return int((time.time() if t is None else t) // self.interval_s)

    def record(self, name: str, value: float, kind: str = "rate",
               t: Optional[float] = None) -> None:
        """Add ``value`` into the slot covering wall-clock time ``t``
        (now by default).  ``kind`` is fixed at a series' first record;
        a later mismatch raises — silently reinterpreting a rate as a
        gauge would corrupt every merged reading downstream."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        idx = self.index_for(t)
        with self._lock:
            have = self._kinds.get(name)
            if have is None:
                self._kinds[name] = kind
                self._series[name] = {}
            elif have != kind:
                raise ValueError(
                    f"series {name!r} is {have!r}, cannot record {kind!r}"
                )
            slots = self._series[name]
            slot = slots.get(idx)
            if slot is None:
                slots[idx] = [float(value), 1]
                # Prune: fixed capacity, measured from the newest index
                # EVER written to this series (late stragglers from a
                # skewed clock cannot resurrect evicted history).
                floor = max(slots) - self.capacity
                if len(slots) > self.capacity:
                    for old in [i for i in slots if i <= floor]:
                        del slots[old]
            else:
                slot[0] += value
                slot[1] += 1

    # -- reading ---------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def _read(self, name: str, idx: int) -> Optional[Tuple[float, int]]:
        slot = self._series.get(name, {}).get(idx)
        return None if slot is None else (slot[0], slot[1])

    def value(self, name: str, idx: int) -> float:
        """One slot's reading: rate -> summed delta in that interval,
        gauge -> mean of the samples in it.  Empty slot reads 0.0."""
        with self._lock:
            slot = self._series.get(name, {}).get(idx)
            if slot is None:
                return 0.0
            if self._kinds[name] == "gauge":
                return slot[0] / slot[1] if slot[1] else 0.0
            return slot[0]

    def window(self, seconds: float, now: Optional[float] = None) -> Dict[str, float]:
        """Recent-window reading per series, for the ``minbft_window_*``
        gauges: rate -> per-SECOND rate over the window, gauge -> mean
        of the window's samples.  The newest (still-filling) interval is
        excluded — a half-elapsed slot would read as a half rate."""
        end = self.index_for(now)  # exclusive
        n_slots = max(1, int(seconds // self.interval_s))
        out: Dict[str, float] = {}
        with self._lock:
            for name, slots in self._series.items():
                total = 0.0
                count = 0
                for idx in range(end - n_slots, end):
                    slot = slots.get(idx)
                    if slot is not None:
                        total += slot[0]
                        count += slot[1]
                if self._kinds[name] == "gauge":
                    out[name] = total / count if count else 0.0
                else:
                    out[name] = total / (n_slots * self.interval_s)
        return out

    def timeline(self, name: str, last: Optional[int] = None
                 ) -> Tuple[int, List[float]]:
        """Dense per-interval readings ``(start_index, values)`` for the
        bench artifact's saturation timeline.  Gaps read 0.0 (an idle
        second IS a zero rate; an unsampled gauge second has no better
        honest value and 0 is visibly a gap next to real depths)."""
        with self._lock:
            slots = self._series.get(name)
            if not slots:
                return (0, [])
            kind = self._kinds[name]
            lo, hi = min(slots), max(slots)
            if last is not None:
                lo = max(lo, hi - last + 1)
            vals: List[float] = []
            for idx in range(lo, hi + 1):
                slot = slots.get(idx)
                if slot is None:
                    vals.append(0.0)
                elif kind == "gauge":
                    vals.append(slot[0] / slot[1] if slot[1] else 0.0)
                else:
                    vals.append(slot[0])
            return (lo, vals)

    # -- merge / serialization (the Log2Histogram contract) --------------

    def merge(self, other: "TimeSeries") -> "TimeSeries":
        """Slot-wise pair addition into ``self``.  Exact and associative
        (the property test in tests/test_timeseries.py pins it).  Grids
        must match — re-binning across interval widths would not be."""
        if other.interval_s != self.interval_s:
            raise ValueError(
                f"interval mismatch: {self.interval_s} vs {other.interval_s}"
            )
        with other._lock:
            theirs = {
                name: (other._kinds[name],
                       {i: list(s) for i, s in slots.items()})
                for name, slots in other._series.items()
            }
        with self._lock:
            self.capacity = max(self.capacity, other.capacity)
            for name, (kind, slots) in theirs.items():
                have = self._kinds.get(name)
                if have is None:
                    self._kinds[name] = kind
                    self._series[name] = {}
                elif have != kind:
                    raise ValueError(
                        f"series {name!r} kind mismatch: {have} vs {kind}"
                    )
                mine = self._series[name]
                for idx, (s, n) in slots.items():
                    slot = mine.get(idx)
                    if slot is None:
                        mine[idx] = [s, n]
                    else:
                        slot[0] += s
                        slot[1] += n
                if len(mine) > self.capacity:
                    floor = max(mine) - self.capacity
                    for old in [i for i in mine if i <= floor]:
                        del mine[old]
        return self

    @staticmethod
    def merged(series: Iterable["TimeSeries"]) -> "TimeSeries":
        out: Optional[TimeSeries] = None
        for ts in series:
            if out is None:
                out = TimeSeries(ts.interval_s, ts.capacity)
            out.merge(ts)
        return out if out is not None else TimeSeries()

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "series": {
                    name: {
                        "kind": self._kinds[name],
                        "points": {
                            str(i): [s, n] for i, (s, n) in sorted(
                                (i, (slot[0], slot[1]))
                                for i, slot in slots.items()
                            )
                        },
                    }
                    for name, slots in self._series.items()
                },
            }

    @staticmethod
    def from_dict(d: dict) -> "TimeSeries":
        ts = TimeSeries(
            float(d.get("interval_s", DEFAULT_INTERVAL_S)),
            int(d.get("capacity", DEFAULT_CAPACITY)),
        )
        for name, ser in (d.get("series") or {}).items():
            kind = ser.get("kind", "rate")
            ts._kinds[name] = kind
            ts._series[name] = {
                int(i): [float(p[0]), int(p[1])]
                for i, p in (ser.get("points") or {}).items()
            }
        return ts


class CounterSampler:
    """Samples cumulative counters into a :class:`TimeSeries` on a fixed
    tick, keeping the per-source baselines the counter-delta discipline
    needs.  All reads are GIL-atomic snapshots of ints/floats (the same
    contract the Prometheus scrape relies on), so a tick never blocks
    the event loop on protocol locks.

    Three source shapes:

    - ``add_rate(name, fn)`` — ``fn`` returns a cumulative count; each
      tick records the delta.  A backwards step (stats reset) only
      re-baselines.
    - ``add_gauge(name, fn)`` — ``fn`` returns the instantaneous value.
    - ``add_ratio(name, num_fn, den_fn)`` — per-interval
      ``Δnum / Δden`` recorded as a gauge (batch fill, frames/tick);
      nothing is recorded when the denominator did not move, so idle
      intervals stay gaps instead of fabricated zeros.
    """

    def __init__(self, ts: TimeSeries):
        self.ts = ts
        self._rates: List[Tuple[str, Callable[[], float]]] = []
        self._gauges: List[Tuple[str, Callable[[], float]]] = []
        self._ratios: List[
            Tuple[str, Callable[[], float], Callable[[], float]]
        ] = []
        self._last: Dict[str, float] = {}

    def add_rate(self, name: str, fn: Callable[[], float]) -> None:
        self._rates.append((name, fn))

    def add_gauge(self, name: str, fn: Callable[[], float]) -> None:
        self._gauges.append((name, fn))

    def add_ratio(self, name: str, num_fn: Callable[[], float],
                  den_fn: Callable[[], float]) -> None:
        self._ratios.append((name, num_fn, den_fn))

    def tick(self, t: Optional[float] = None) -> None:
        for name, fn in self._rates:
            cur = float(fn())
            last = self._last.get(name)
            self._last[name] = cur
            if last is not None and cur >= last:
                self.ts.record(name, cur - last, kind="rate", t=t)
        for name, num_fn, den_fn in self._ratios:
            num, den = float(num_fn()), float(den_fn())
            lnum = self._last.get(name + "#num")
            lden = self._last.get(name + "#den")
            self._last[name + "#num"] = num
            self._last[name + "#den"] = den
            if lnum is None or num < lnum or den < lden:
                continue  # first tick or reset: re-baseline only
            if den - lden > 0:
                self.ts.record(
                    name, (num - lnum) / (den - lden), kind="gauge", t=t
                )
        for name, fn in self._gauges:
            self.ts.record(name, float(fn()), kind="gauge", t=t)

    async def run(self) -> None:
        """Tick forever at the ring's interval; cancel the task to stop.
        The first tick only establishes baselines (no deltas recorded),
        so starting the sampler mid-run never fabricates a burst."""
        try:
            while True:
                await asyncio.sleep(self.ts.interval_s)
                self.tick()
        except asyncio.CancelledError:
            self.tick()  # flush the final partial interval's deltas
            raise


def register_replica_series(sampler: CounterSampler, metrics,
                            group: Optional[int] = None) -> None:
    """The standard per-replica series (per-group suffixed when the
    grouped runtime passes its core's group id): committed req/s, loop
    lag, and ingest fill — everything a ``peer top`` row needs that the
    engine does not know."""
    sfx = f"_g{group}" if group is not None else ""
    counters = metrics.counters
    sampler.add_rate(
        f"committed{sfx}",
        lambda: counters.get("requests_executed", 0),
    )
    sampler.add_gauge(
        f"loop_lag_p50_ms{sfx}",
        lambda: metrics.loop_lag.percentile(50) * 1e3,
    )
    sampler.add_ratio(
        f"ingest_frames_per_tick{sfx}",
        lambda: counters.get("ingest_frames", 0),
        lambda: counters.get("ingest_ticks", 0),
    )


def register_engine_series(sampler: CounterSampler, engine) -> None:
    """The shared-engine series: verify/sign item rates, per-interval
    batch fill, and total queue backlog.  Registered ONCE per engine —
    the grouped runtime's cores share one engine, and double-counting
    its items would inflate every merged reading."""

    def _verify_items() -> float:
        return sum(st.items for st in engine.stats.values())

    def _verify_batches() -> float:
        return sum(st.batches for st in engine.stats.values())

    def _sign_items() -> float:
        return sum(st.items for st in engine.sign_stats.values())

    def _depth() -> float:
        return float(
            sum(engine.queue_depths().values())
            + sum(engine.sign_queue_depths().values())
        )

    sampler.add_rate("verify_items", _verify_items)
    sampler.add_rate("sign_items", _sign_items)
    sampler.add_ratio("verify_fill", _verify_items, _verify_batches)
    sampler.add_gauge("queue_depth", _depth)

    def _wait_p50_ms() -> float:
        hists = [st.queue_wait for st in engine.stats.values()]
        if not hists:
            return 0.0
        from .hist import Log2Histogram

        return Log2Histogram.merged(hists).percentile(50) * 1e3

    sampler.add_gauge("queue_wait_p50_ms", _wait_p50_ms)


# -- dump / merge (the {base}.ts.json surface) ---------------------------


def dump_timeseries(ts: TimeSeries, base: str,
                    extra: Optional[dict] = None) -> str:
    """Write the ring next to the flight-recorder dumps as
    ``{base}.ts.json``.  The doc carries ``kind: "timeseries"`` (the
    trace loaders filter on kind, so sharing the glob is safe) plus the
    run_id/build attribution block every dump now carries."""
    import json

    doc = {
        "kind": "timeseries",
        "run_id": runinfo.RUN_ID,
        "build": runinfo.build_info(),
        "ts": ts.to_dict(),
    }
    if extra:
        doc.update(extra)
    path = f"{base}.ts.json"
    # noqa: AH102 - one-shot shutdown dump; no executor dependency at teardown
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def merge_timeseries_docs(docs: Iterable[dict]) -> TimeSeries:
    """Merge ``kind == "timeseries"`` dump docs into one cluster ring.

    Incarnation honesty: two docs claiming the
    same replica ``id`` with different ``run_id``s are two PROCESSES —
    a restart.  Splicing them would stack the restarted replica's
    counters onto its predecessor's slots as if one process produced
    both, so the merge raises :class:`IncarnationMismatch` instead;
    the caller decides which incarnation to keep.
    """
    ts_docs = [d for d in docs if d.get("kind") == "timeseries"]
    seen: Dict[object, str] = {}
    for d in ts_docs:
        ident = d.get("id")
        run = d.get("run_id")
        if ident is None or run is None:
            continue
        prev = seen.setdefault(ident, run)
        if prev != run:
            raise IncarnationMismatch(
                f"timeseries dumps for id {ident!r} span two incarnations "
                f"({prev} vs {run}): refusing to splice a restarted "
                "process onto its predecessor's timeline"
            )
    return TimeSeries.merged(
        TimeSeries.from_dict(d.get("ts") or {}) for d in ts_docs
    )
