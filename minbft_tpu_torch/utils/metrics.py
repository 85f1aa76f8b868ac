"""Protocol-level metrics (the observability the reference lacks — SURVEY.md
§5 notes its only instrumentation is leveled logging, while this build's
north star is a throughput number, so counters are first-class here).

Design: plain counters + a fixed-size latency reservoir, updated inline from
the asyncio pipelines (single event loop — no locks needed), snapshot-read
by benchmarks/operators.  The batch engine keeps its own
:class:`minbft_tpu_torch.parallel.engine.VerifyStats`; this module covers the
protocol layer above it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict


@dataclasses.dataclass
class LatencyReservoir:
    """Bounded sample of durations (seconds) with streaming count/sum."""

    capacity: int = 2048
    count: int = 0
    total_s: float = 0.0

    def __post_init__(self):
        import random

        self._samples: list = []
        # Sorted view of _samples, built lazily on the first percentile
        # call and reused until the next observe invalidates it: metric
        # snapshots ask for several percentiles back-to-back, and
        # re-sorting the full 2048-sample reservoir for each one made
        # every snapshot O(k · n log n) for no reason.
        self._sorted: "list | None" = None
        # Fixed seed: percentiles are statistics, but reproducible runs
        # help debugging.
        self._rng = random.Random(0x9E3779B97F4A7C15)

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self._sorted = None  # invalidate the cached sorted view
        if len(self._samples) < self.capacity:
            self._samples.append(seconds)
        else:
            # Algorithm R reservoir sampling: every observation ends up in
            # the sample with equal probability capacity/count, so a
            # long-run p99 reflects the whole run (a round-robin overwrite
            # would be recent-biased — the last `capacity` events only).
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._samples[j] = seconds

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        s = self._sorted
        if s is None:
            s = self._sorted = sorted(self._samples)
        # nearest-rank: smallest value with at least q% of samples <= it.
        # Round away binary-float fuzz first (q=55, n=100 would otherwise
        # compute ceil(55.000000000000014) = 56).
        idx = max(0, math.ceil(round(q / 100.0 * len(s), 9)) - 1)
        return s[min(idx, len(s) - 1)]


class ReplicaMetrics:
    """Counters for one replica's protocol activity.

    Counter names (stable API for benchmarks/operators):

    - ``requests_received`` / ``requests_executed``
    - ``prepares_sent`` / ``prepares_accepted``
    - ``commits_sent`` / ``commitments_counted``
    - ``messages_handled`` / ``messages_dropped``
    - ``timeouts_request`` / ``timeouts_prepare``
    """

    def __init__(self, group=None):
        from ..obs.hist import Log2CountHistogram, Log2Histogram

        # Consensus-group id (multi-group runtime, minbft_tpu/groups):
        # None for an ungrouped replica.  Pure labeling — the Prometheus
        # exposition adds a ``group`` label and aggregate() callers can
        # keep per-group snapshots separable.
        self.group = group
        self.counters: Dict[str, int] = {}
        self.execute_latency = LatencyReservoir()
        # Streaming log2 histogram next to the reservoir (obs/hist.py):
        # mergeable across replicas and scrape-safe, it feeds the
        # Prometheus exposition; the reservoir keeps exact samples for
        # the snapshot()/bench percentiles.
        self.execute_hist = Log2Histogram()
        # Bundle-ingest fill distribution: one observation per ingest
        # tick, value = decoded frames in that tick's bundle (log2
        # buckets, mergeable, scraped as minbft_ingest_bundle_frames).
        # The companion counters (ingest_ticks / ingest_frames) ride the
        # ordinary counter map so snapshot()/aggregate() carry them.
        self.ingest_hist = Log2CountHistogram()
        # Event-loop scheduling lag (obs/looplag.py samples into this
        # from the replica's loop): GIL/loop saturation, scraped as
        # minbft_eventloop_lag_seconds and carried in trace dumps for
        # the critical-path loop_lag segment.
        self.loop_lag = Log2Histogram()
        self._started = time.monotonic()
        # Health-monitor state: monotonic stamps of the last
        # executed request and the last handled message, plus the
        # replica's current view.  A commit stall is "messages keep
        # arriving but nothing has executed for > T" — computable from
        # these two stamps by any stateless scrape, no detector thread.
        self.last_executed_mono = 0.0
        self.last_message_mono = 0.0
        self.current_view = 0
        # Admission-control state: the bundle ingestor's rx
        # queue depth/bound stamped per tick plus the high-water mark —
        # the "is the replica's inbound path saturating" gauges that back
        # the minbft_admission_* exposition and the BUSY retry-after
        # scaling.  The companion counters (admission_shed /
        # admission_busy_sent / admission_busy_suppressed) ride inc().
        self.admission_rx_depth = 0
        self.admission_rx_bound = 0
        self.admission_rx_peak = 0

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by
        # Stall-detector stamps inline with the two counters that define
        # progress (one string compare each on the hot path; the obs
        # overhead A/B test bounds the cost).
        if name == "requests_executed":
            self.last_executed_mono = time.monotonic()
        elif name == "messages_handled":
            self.last_message_mono = time.monotonic()

    def note_view(self, view: int) -> None:
        """Record the view this replica currently operates in (called
        from the new-view apply path; scraped as minbft_health_view)."""
        self.current_view = view

    def stalled(self, after_s: float = 30.0) -> bool:
        """Commit-stall detector: True when messages arrived more
        recently than the last execution AND nothing has executed for
        ``after_s`` — traffic without progress.  An idle replica (no
        traffic either) is healthy, not stalled."""
        if self.last_message_mono <= self.last_executed_mono:
            return False
        ref = self.last_executed_mono or self._started
        return time.monotonic() - ref > after_s

    def observe_execute(self, seconds: float) -> None:
        self.execute_latency.observe(seconds)
        self.execute_hist.observe(seconds)

    def note_admission_rx(self, depth: int, bound: int) -> None:
        """Stamp the ingest rx queue's occupancy (called once per ingest
        tick; the peak is the high-water mark the overload
        acceptance test asserts bounded)."""
        self.admission_rx_depth = depth
        self.admission_rx_bound = bound
        if depth > self.admission_rx_peak:
            self.admission_rx_peak = depth

    def admission_rx_saturation(self) -> float:
        """Last-stamped rx fill fraction in [0, 1]."""
        if self.admission_rx_bound <= 0:
            return 0.0
        return min(1.0, self.admission_rx_depth / self.admission_rx_bound)

    def observe_ingest(self, n_frames: int) -> None:
        """One bundle-ingest tick that decoded ``n_frames`` flat frames."""
        self.counters["ingest_ticks"] = self.counters.get("ingest_ticks", 0) + 1
        self.counters["ingest_frames"] = (
            self.counters.get("ingest_frames", 0) + n_frames
        )
        self.ingest_hist.observe_count(n_frames)

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._started

    def executed_per_sec(self) -> float:
        up = self.uptime_s
        return self.counters.get("requests_executed", 0) / up if up > 0 else 0.0

    def snapshot(self) -> dict:
        """Point-in-time view for logs / bench extras."""
        return {
            **self.counters,
            "uptime_s": round(self.uptime_s, 3),
            "execute_latency_mean_ms": round(self.execute_latency.mean_s * 1e3, 3),
            "execute_latency_p50_ms": round(
                self.execute_latency.percentile(50) * 1e3, 3
            ),
            "execute_latency_p99_ms": round(
                self.execute_latency.percentile(99) * 1e3, 3
            ),
        }


def aggregate(snapshots) -> dict:
    """Sum counter snapshots across replicas (latency fields are averaged)."""
    out: dict = {}
    n = 0
    for snap in snapshots:
        n += 1
        for k, v in snap.items():
            out[k] = out.get(k, 0) + v
    if n:
        for k in list(out):
            if k.startswith("execute_latency") or k == "uptime_s":
                out[k] = round(out[k] / n, 3)
    return out
