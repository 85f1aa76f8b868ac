"""Fixed-bucket log2 latency histograms.

The protocol's hot paths need percentiles that are cheap to record
(one array increment), mergeable across replicas/engines (bucket-wise
addition — a reservoir cannot be merged without re-weighting), and
bounded in memory regardless of run length.  The
:class:`minbft_tpu.utils.metrics.LatencyReservoir` keeps exact samples
for offline analysis; this histogram is the streaming counterpart the
flight recorder and the Prometheus exposition use.

Buckets are powers of two in MICROSECONDS: bucket ``i`` holds durations
``d`` with ``2**(i-1) < d_us <= 2**i`` (bucket 0 is ``<= 1us``).  64
buckets cover 1us..~585000 years, so nothing ever clips.  Relative
resolution is a factor of 2 — exactly the precision a "where does the
time go" attribution needs, and the reason merge is exact (identical
bucket edges everywhere, no re-binning).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

_N_BUCKETS = 64
_US = 1_000_000.0


class Log2Histogram:
    """Mergeable log2-bucket histogram of durations in seconds.

    Negative durations (clock weirdness: a monotonic source going
    backwards can only mean a broken pairing or a cross-clock subtraction
    that should have gone through :mod:`~minbft_tpu.obs.clockalign`) are
    COUNTED in ``negatives`` instead of silently clamped into bucket 0 —
    the count rides the dump/merge/Prometheus surfaces so the critpath
    merge can use it as a clock-sanity signal, and the percentile buckets
    stay unpolluted.
    """

    __slots__ = ("buckets", "count", "total_s", "negatives")

    def __init__(self, buckets: Optional[List[int]] = None,
                 count: int = 0, total_s: float = 0.0, negatives: int = 0):
        if buckets is None:
            buckets = [0] * _N_BUCKETS
        elif len(buckets) != _N_BUCKETS:
            raise ValueError(f"expected {_N_BUCKETS} buckets, got {len(buckets)}")
        self.buckets = buckets
        self.count = count
        self.total_s = total_s
        self.negatives = negatives

    def observe(self, seconds: float) -> None:
        if seconds < 0:
            self.negatives += 1
            return
        # Round UP to whole microseconds so a bucket's upper edge always
        # bounds its samples (1.2us must land above the <=1us bucket —
        # flooring would report percentiles BELOW the true value).
        us = -int(-seconds * _US // 1)
        # int.bit_length is the log2: bucket 0 <= 1us, bucket i covers
        # (2**(i-1), 2**i] us.
        idx = (us - 1).bit_length() if us > 1 else 0
        self.buckets[min(idx, _N_BUCKETS - 1)] += 1
        self.count += 1
        self.total_s += seconds

    def observe_ns(self, ns: int, n: int = 1) -> None:
        """Integer fast path for ring drains (timestamps in nanoseconds).
        ``n`` records the same duration n times at O(1) cost — the
        engine's per-batch service spans apply to every lane at once."""
        if ns < 0:
            self.negatives += n
            return
        us = -(-ns // 1000)  # ceil-divide: see observe()
        idx = (us - 1).bit_length() if us > 1 else 0
        self.buckets[min(idx, _N_BUCKETS - 1)] += n
        self.count += n
        self.total_s += ns * 1e-9 * n

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile in SECONDS, resolved to its bucket's
        upper edge (consistent with Prometheus's ``le`` semantics: the
        smallest bound at least q% of observations fall under)."""
        if not self.count:
            return 0.0
        rank = max(1, -(-int(q * self.count) // 100))  # ceil(q/100 * count)
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= rank:
                return (1 << i) / _US
        return (1 << (_N_BUCKETS - 1)) / _US

    def merge(self, other: "Log2Histogram") -> "Log2Histogram":
        """Bucket-wise sum — exact, because every histogram shares the
        same fixed edges (the property reservoirs lack)."""
        self.count += other.count
        self.total_s += other.total_s
        self.negatives += other.negatives
        b, ob = self.buckets, other.buckets
        for i in range(_N_BUCKETS):
            b[i] += ob[i]
        return self

    @staticmethod
    def merged(hists: Iterable["Log2Histogram"]) -> "Log2Histogram":
        out = Log2Histogram()
        for h in hists:
            out.merge(h)
        return out

    # -- (de)serialization for the JSON trace dump -----------------------

    def to_dict(self) -> dict:
        # Sparse encoding: {bucket_index: count} — most of the 64 buckets
        # are empty for any one stage.  ``negatives`` only when nonzero
        # (dump compatibility both ways: old dumps simply lack the key).
        out = {
            "buckets": {str(i): c for i, c in enumerate(self.buckets) if c},
            "count": self.count,
            "total_s": self.total_s,
        }
        if self.negatives:
            out["negatives"] = self.negatives
        return out

    @staticmethod
    def from_dict(d: dict) -> "Log2Histogram":
        buckets = [0] * _N_BUCKETS
        for i, c in (d.get("buckets") or {}).items():
            buckets[int(i)] = int(c)
        return Log2Histogram(
            buckets, int(d.get("count", 0)), float(d.get("total_s", 0.0)),
            int(d.get("negatives", 0)),
        )

    def bucket_upper_bounds_s(self) -> List[float]:
        """Upper edge of each bucket in seconds (for Prometheus ``le``)."""
        return [(1 << i) / _US for i in range(_N_BUCKETS)]


class Log2CountHistogram(Log2Histogram):
    """Log2 histogram over a dimensionless COUNT axis (ingest bundle
    sizes) with the same storage, merge, and serialization as the
    duration base class.

    The ``_s``-suffixed members keep their names so the Prometheus
    renderer (obs/prom.py) works unchanged, but the axis is plain
    counts: ``observe_count(n)`` buckets by ceil-log2(n) (bucket i covers
    ``(2**(i-1), 2**i]`` items, same upper-edge convention as the base),
    ``total_s`` accumulates the raw counts (so ``_sum`` is total items
    and ``mean_s`` the mean bundle size), and the exposed ``le`` bounds
    are ``2**i`` items."""

    __slots__ = ()

    def observe_count(self, n: int) -> None:
        if n < 0:
            self.negatives += 1
            return
        idx = (n - 1).bit_length() if n > 1 else 0
        self.buckets[min(idx, _N_BUCKETS - 1)] += 1
        self.count += 1
        self.total_s += n

    @property
    def mean(self) -> float:
        """Mean bundle size (alias of the misleadingly-named mean_s)."""
        return self.mean_s

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile in ITEMS (bucket upper edge)."""
        if not self.count:
            return 0.0
        rank = max(1, -(-int(q * self.count) // 100))
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= rank:
                return float(1 << i)
        return float(1 << (_N_BUCKETS - 1))

    def bucket_upper_bounds_s(self) -> List[float]:
        """Upper edge of each bucket in ITEMS (for Prometheus ``le``)."""
        return [float(1 << i) for i in range(_N_BUCKETS)]
