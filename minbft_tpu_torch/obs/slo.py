"""Latency-SLO engine: per-request finality budgets, multi-window
burn-rate telemetry, and breach-triggered forensic auto-dump.

The flight recorder (obs/trace.py), the critical path (obs/critpath.py),
and the telemetry rings (obs/timeseries.py) record *where time goes*;
this module is the first layer that says whether a request *met its
deadline*.  Four pieces, each riding an existing surface:

- :class:`SLOPolicy` — the budget: target finality milliseconds plus an
  objective fraction (the classic "99% of writes commit inside 1s").
  Configured per group via consensus.yaml (``protocol.slo_target`` /
  ``protocol.slo_objective``) or the ``MINBFT_SLO_*`` env knobs; the
  env value accepts a comma list so a grouped runtime can give group 0
  a tighter budget than its batch-tolerant siblings.
- :class:`BudgetLedger` — the per-request classifier.  ``arrive`` stamps
  a request's first entry into the replica (recv-origin — the honest
  default when no load-generator metadata exists); ``commit`` pops the
  stamp at commit-quorum time and classes the request good/breached
  against the budget.  Single-writer (the replica's event loop), two int
  increments on the hot path, and — exactly like the flight recorder —
  a *disabled* SLO engine costs the pipeline one predicated attribute
  check per hook (``if sl is not None``), nothing else.
- **Burn-rate telemetry** — ``register_slo_series`` feeds the good /
  breached counters into the PR-9 :class:`~.timeseries.TimeSeries`
  rings as rate series, so :func:`burn_rates` can read a fast (~5s) and
  a slow (~60s) window and report each as a multiple of the sustainable
  error-budget spend rate (burn 1.0 = exactly exhausting the budget;
  the alerting convention from the SRE workbook).  Because the rings
  merge slot-wise exactly, cluster-level burn is computable from
  per-process dumps with no approximation.
- **Breach forensics** — :class:`BreachSpool` writes ONE bounded
  snapshot bundle (flight-recorder docs + timeseries ring + util block
  + the breach attribution below + build stamp) when the fast-window
  burn crosses ``policy.burn_threshold``, behind a token bucket
  (default: one bundle, refilled every ``MINBFT_SLO_DUMP_REFILL_S``)
  and a spool-size bound, so a sustained breach can never fill a disk.

Breach attribution (:func:`breach_report`): every breached request's
budget spend is split across the PR-7 critpath segments — so a breach
names its thief (queue_wait vs commit vs reply_sign).  When client
trace dumps exist the full client-origin :func:`~.critpath.cluster_paths`
merge is used; a replica-only dump set (the loadgen harness keeps no
client recorders) falls back to recv-origin paths built from the
replica stages alone.  When a load-generator metadata doc is present
(``kind: "loadgen"``, written by the open-loop harness), classification
switches to SCHEDULED-origin latencies — the coordinated-omission rule
from perf/LOAD.md — and the pre-entry wait is attributed to an explicit
``sched_wait`` segment, so per-request segments still sum exactly to
the classified spend (the invariant tests/test_slo.py pins).
"""

from __future__ import annotations

import asyncio
import dataclasses
import glob
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import clockalign, runinfo
from .critpath import RequestPath, cluster_paths
from .trace import filter_group

# Environment knobs (tools/analyze/ENV_VARS.md registers every one).
SLO_ENV = "MINBFT_SLO"
TARGET_ENV = "MINBFT_SLO_TARGET_MS"
OBJECTIVE_ENV = "MINBFT_SLO_OBJECTIVE"
FAST_WINDOW_ENV = "MINBFT_SLO_FAST_WINDOW_S"
SLOW_WINDOW_ENV = "MINBFT_SLO_SLOW_WINDOW_S"
BURN_THRESHOLD_ENV = "MINBFT_SLO_BURN_THRESHOLD"
DUMP_ENV = "MINBFT_SLO_DUMP"
DUMP_MAX_ENV = "MINBFT_SLO_DUMP_MAX"
DUMP_REFILL_ENV = "MINBFT_SLO_DUMP_REFILL_S"

# In-flight origin stamps are bounded exactly like the flight recorder's
# pairing map: a request that never commits (shed, timed out client)
# would leak its stamp, so past this many keys the map resets wholesale.
_MAX_INFLIGHT_KEYS = 1 << 16

# The replica-origin attribution segments (a strict subset of
# critpath.SEGMENTS, in the same causal order) plus the two extras this
# module owns: ``sched_wait`` (scheduled arrival -> replica entry, only
# when loadgen metadata supplies scheduled origins) and the telescoping
# ``unattributed`` residual.
REPLICA_SEGMENTS: Tuple[str, ...] = (
    "preverify",
    "verify",
    "prepare_wait",
    "commit",
    "execute",
    "reply_sign",
    "reply_send",
    "unattributed",
)
SCHED_WAIT_SEGMENT = "sched_wait"


def _flag_truthy(value: str) -> bool:
    return value.lower() not in ("", "0", "false", "no")


def slo_enabled(configer=None) -> bool:
    """True when the operator asked for SLO accounting: ``MINBFT_SLO``
    set truthy (``MINBFT_SLO=0`` disables, the repo's env-flag
    convention), a ``MINBFT_SLO_DUMP`` spool path, an explicit
    ``MINBFT_SLO_TARGET_MS``, or a configer carrying ``slo_target_ms``
    (consensus.yaml ``protocol.slo_target``)."""
    if _flag_truthy(os.environ.get(SLO_ENV, "")):
        return True
    if os.environ.get(DUMP_ENV) or os.environ.get(TARGET_ENV):
        return True
    return getattr(configer, "slo_target_ms", None) is not None


def _group_entry(raw: str, group: Optional[int], default: float) -> float:
    """Parse a scalar-or-comma-list env value per group: ``"1000"``
    applies everywhere, ``"1000,500"`` gives group 0 the first entry,
    group 1 (and every later group) the last — a short list extends its
    final entry rather than erroring, so adding a group never silently
    drops SLO coverage."""
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    if not parts:
        return default
    idx = 0 if group is None else min(group, len(parts) - 1)
    try:
        return float(parts[idx])
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """One group's finality budget and its alerting windows."""

    target_ms: float = 1000.0
    objective: float = 0.99  # fraction of requests that must meet target
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    # Fast-window burn multiple that trips forensics / the `peer top`
    # BREACH flag.  8x mirrors the short-window page threshold from the
    # multiwindow burn-rate alerting recipe: fast enough to catch a
    # wedge in seconds, high enough that a single straggler cannot.
    burn_threshold: float = 8.0

    @property
    def budget_ns(self) -> float:
        return self.target_ms * 1e6

    @property
    def error_budget(self) -> float:
        """Allowed breach fraction (0.01 for a 99% objective); floored
        so a 100% objective cannot divide burn by zero."""
        return max(1.0 - self.objective, 1e-9)

    @staticmethod
    def from_env(group: Optional[int] = None,
                 configer=None) -> "SLOPolicy":
        """Resolve the policy for one group: configer fields (parsed
        from consensus.yaml) first, ``MINBFT_SLO_*`` env on top — the
        same layering every other protocol knob uses."""
        target = getattr(configer, "slo_target_ms", None)
        objective = getattr(configer, "slo_objective", None)
        target = float(target) if target is not None else 1000.0
        objective = float(objective) if objective is not None else 0.99
        raw = os.environ.get(TARGET_ENV, "")
        if raw:
            target = _group_entry(raw, group, target)
        raw = os.environ.get(OBJECTIVE_ENV, "")
        if raw:
            objective = _group_entry(raw, group, objective)
        return SLOPolicy(
            target_ms=target,
            objective=objective,
            fast_window_s=float(
                os.environ.get(FAST_WINDOW_ENV, "") or 5.0
            ),
            slow_window_s=float(
                os.environ.get(SLOW_WINDOW_ENV, "") or 60.0
            ),
            burn_threshold=float(
                os.environ.get(BURN_THRESHOLD_ENV, "") or 8.0
            ),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BudgetLedger:
    """Per-replica-core good/breached accounting (recv-origin).

    Single-writer: only the owning event loop calls :meth:`arrive` /
    :meth:`commit` (the StageRing discipline; tools/analyze pins it).
    Scrape threads read the int counters GIL-atomically, the same
    slightly-stale-never-torn contract every other metric keeps.
    """

    __slots__ = (
        "policy", "group", "good", "breached", "breached_budget_ns",
        "_origin",
    )

    def __init__(self, policy: SLOPolicy, group: Optional[int] = None):
        self.policy = policy
        self.group = group
        self.good = 0
        self.breached = 0
        # Summed recv-origin latency of every breached request — the
        # "budget spend" the breach attribution must account for.
        self.breached_budget_ns = 0
        self._origin: Dict[Tuple[int, int], int] = {}

    def arrive(self, cid: int, seq: int) -> None:
        """Stamp a request's FIRST entry (recv/ingest).  Retransmissions
        keep the original stamp — the client has been waiting since the
        first arrival, and resetting the clock would be coordinated
        omission at the replica."""
        origin = self._origin
        if (cid, seq) not in origin:
            if len(origin) >= _MAX_INFLIGHT_KEYS:
                origin.clear()
            origin[(cid, seq)] = time.monotonic_ns()

    def commit(self, cid: int, seq: int) -> Optional[bool]:
        """Classify at commit-quorum time; returns True (good) / False
        (breached) / None (origin unknown: stamp evicted, or the commit
        arrived via state transfer without a client arrival)."""
        t0 = self._origin.pop((cid, seq), None)
        if t0 is None:
            return None
        lat_ns = time.monotonic_ns() - t0
        if lat_ns <= self.policy.budget_ns:
            self.good += 1
            return True
        self.breached += 1
        self.breached_budget_ns += lat_ns
        return False

    @property
    def total(self) -> int:
        return self.good + self.breached

    def good_fraction(self) -> float:
        t = self.total
        return self.good / t if t else 1.0

    def budget_remaining(self) -> float:
        """Remaining error-budget fraction over this ledger's lifetime:
        1.0 = untouched, 0.0 = exactly spent, negative = overspent (the
        overshoot is informative, so it is not clamped)."""
        t = self.total
        if t == 0:
            return 1.0
        return 1.0 - (self.breached / t) / self.policy.error_budget


def series_name(base: str, group: Optional[int]) -> str:
    """Ring-series name for one group's SLO counter (the
    ``register_replica_series`` suffix convention)."""
    return base if group is None else f"{base}_g{group}"


def register_slo_series(sampler, ledger: BudgetLedger) -> None:
    """Feed one ledger's cumulative counters into the sampler's ring as
    rate series (``slo_good`` / ``slo_breached``, per-group suffixed).
    Counter deltas into slot-exact rings: cluster burn rates merge
    across processes with zero approximation."""
    sampler.add_rate(
        series_name("slo_good", ledger.group), lambda: ledger.good
    )
    sampler.add_rate(
        series_name("slo_breached", ledger.group), lambda: ledger.breached
    )


def _series_sum(window: Dict[str, float], base: str,
                group: Optional[int]) -> float:
    if group is not None:
        return window.get(f"{base}_g{group}", 0.0)
    return sum(
        v for name, v in window.items()
        if name == base or name.startswith(base + "_g")
    )


def burn_rates(ts, policy: SLOPolicy, now: Optional[float] = None,
               group: Optional[int] = None) -> dict:
    """Multi-window burn rates from a (possibly merged) ring.

    Burn = (breached fraction in the window) / (allowed breach
    fraction): 1.0 spends the error budget exactly as fast as the
    objective allows, ``policy.burn_threshold`` (default 8x) trips
    forensics.  An idle window burns 0 — no traffic spends no budget —
    but a window where EVERY request breached burns ``1/error_budget``
    regardless of rate, so a stalled-but-trickling group still pages.
    ``group=None`` aggregates every group's series (cluster burn)."""
    out = {
        "fast_window_s": policy.fast_window_s,
        "slow_window_s": policy.slow_window_s,
        "burn_threshold": policy.burn_threshold,
    }
    for tag, seconds in (
        ("fast", policy.fast_window_s), ("slow", policy.slow_window_s)
    ):
        win = ts.window(seconds, now=now)
        good = _series_sum(win, "slo_good", group)
        breached = _series_sum(win, "slo_breached", group)
        total = good + breached
        frac = breached / total if total > 0 else 0.0
        out[f"{tag}_good_per_sec"] = round(good, 3)
        out[f"{tag}_breached_per_sec"] = round(breached, 3)
        out[f"{tag}_burn"] = round(frac / policy.error_budget, 3)
    return out


# ---------------------------------------------------------------------------
# Breach attribution: where did the breached requests' budget go?


def _replica_paths(docs: List[dict],
                   quorum: Optional[int] = None) -> List[RequestPath]:
    """Recv-origin request paths from replica dumps alone (no client
    recorders — the loadgen shape).  Origin is the PRIMARY's entry note;
    the tail stages are rank-(f+1) across every replica that observed
    them (the critpath rank coupling); segments telescope so they sum to
    the total by construction."""
    replica_docs = [d for d in docs if d.get("kind") == "replica"]
    if not replica_docs:
        return []
    if quorum is None:
        fs = [d["f"] for d in replica_docs if isinstance(d.get("f"), int)]
        if fs:
            quorum = max(fs) + 1
        else:
            quorum = (max(len(replica_docs) - 1, 0)) // 2 + 1
    alignment = clockalign.align(replica_docs)
    events: Dict[int, Dict[Tuple[int, int], Dict[str, float]]] = {}
    err: Dict[int, float] = {}
    for d in replica_docs:
        al = alignment.get(("replica", d["id"]))
        if al is None:
            continue
        err[d["id"]] = al.err_ns
        events[d["id"]] = {
            key: {s: t + al.offset_ns for s, t in stages.items()}
            for key, stages in clockalign.event_times(d).items()
        }
    keys = sorted({k for ev in events.values() for k in ev})
    head = ("verify_enqueue", "verify_done", "prepare")
    tail_stages = ("commit_quorum", "execute", "reply_sign", "reply_sent")
    paths: List[RequestPath] = []
    for cid, seq in keys:
        primary = None
        pstages = None
        best_prep = None
        involved_err = 0.0
        for rid, ev in events.items():
            stages = ev.get((cid, seq))
            if not stages:
                continue
            prep = stages.get("prepare")
            if prep is None:
                continue
            if best_prep is None or prep < best_prep:
                best_prep = prep
                primary = rid
                pstages = stages
        if pstages is None:
            continue
        entry = clockalign.entry_time(pstages)
        if entry is None or any(s not in pstages for s in head):
            continue
        involved_err = max(involved_err, err.get(primary, 0.0))
        tail: Dict[str, float] = {}
        ok = True
        for stage in tail_stages:
            vals = []
            for rid, ev in events.items():
                t = ev.get((cid, seq), {}).get(stage)
                if t is not None:
                    vals.append(t)
                    involved_err = max(involved_err, err.get(rid, 0.0))
            if len(vals) < quorum:
                ok = False
                break
            tail[stage] = sorted(vals)[quorum - 1]
        if not ok:
            continue

        def span(a: float, b: float) -> float:
            return max(b - a, 0.0)

        segments = {
            "preverify": span(entry, pstages["verify_enqueue"]),
            "verify": span(pstages["verify_enqueue"],
                           pstages["verify_done"]),
            "prepare_wait": span(pstages["verify_done"],
                                 pstages["prepare"]),
            "commit": span(pstages["prepare"], tail["commit_quorum"]),
            "execute": span(tail["commit_quorum"], tail["execute"]),
            "reply_sign": span(tail["execute"], tail["reply_sign"]),
            "reply_send": span(tail["reply_sign"], tail["reply_sent"]),
        }
        total = span(entry, tail["reply_sent"])
        if total <= 0:
            continue
        segments["unattributed"] = max(total - sum(segments.values()), 0.0)
        paths.append(RequestPath(
            cid=cid, seq=seq, total_ns=total, segments=segments,
            err_ns=2 * involved_err, primary=primary,
        ))
    return paths


def _sched_lat_map(docs: Iterable[dict]) -> Dict[Tuple[int, int], float]:
    """Scheduled-origin latencies from loadgen metadata docs
    (``kind: "loadgen"``, ``sched_lat_ns: {"cid:seq": ns}``)."""
    out: Dict[Tuple[int, int], float] = {}
    for d in docs:
        if d.get("kind") != "loadgen":
            continue
        for key, ns in (d.get("sched_lat_ns") or {}).items():
            try:
                cid_s, seq_s = key.split(":", 1)
                out[(int(cid_s), int(seq_s))] = float(ns)
            except (ValueError, TypeError):
                continue
    return out


def breach_report(docs: Iterable[dict], policy: SLOPolicy,
                  quorum: Optional[int] = None,
                  group: Optional[int] = None) -> dict:
    """Classify every fully-observed request in a dump set against the
    budget and attribute each BREACHED request's spend across critpath
    segments.  The attribution invariant: ``attribution_ms`` sums to
    ``breached_spend_ms`` exactly (per-request segments telescope to
    the per-request total by construction).

    Classification origin, most honest available first: scheduled
    (loadgen metadata doc present — the coordinated-omission rule),
    else client (client recorders dumped), else replica recv."""
    docs = list(filter_group(list(docs), group))
    res = cluster_paths(docs, quorum=quorum)
    paths = res.paths
    origin = "client"
    if not paths:
        paths = _replica_paths(docs, quorum=quorum)
        origin = "replica"
    sched = _sched_lat_map(docs)
    if sched and paths:
        origin = "scheduled"
        adjusted = []
        for p in paths:
            sched_ns = sched.get((p.cid, p.seq))
            if sched_ns is None or sched_ns <= p.total_ns:
                segments = dict(p.segments)
                segments.setdefault(SCHED_WAIT_SEGMENT, 0.0)
                total = p.total_ns
            else:
                segments = dict(p.segments)
                segments[SCHED_WAIT_SEGMENT] = sched_ns - p.total_ns
                total = sched_ns
            adjusted.append(RequestPath(
                cid=p.cid, seq=p.seq, total_ns=total, segments=segments,
                err_ns=p.err_ns, primary=p.primary,
            ))
        paths = adjusted
    breached = [p for p in paths if p.total_ns > policy.budget_ns]
    spend_ns = sum(p.total_ns for p in breached)
    seg_names: List[str] = []
    for p in breached:
        for s in p.segments:
            if s not in seg_names:
                seg_names.append(s)
    attribution = {
        s: round(
            sum(p.segments.get(s, 0.0) for p in breached) / 1e6, 3
        )
        for s in seg_names
    }
    return {
        "origin": origin,
        "target_ms": policy.target_ms,
        "objective": policy.objective,
        "requests": len(paths),
        "good": len(paths) - len(breached),
        "breached": len(breached),
        "good_fraction": round(
            (len(paths) - len(breached)) / len(paths), 4
        ) if paths else 1.0,
        "breached_spend_ms": round(spend_ns / 1e6, 3),
        "attribution_ms": attribution,
    }


# ---------------------------------------------------------------------------
# Breach forensics: the flight recorder that dumps itself.


class TokenBucket:
    """Classic token bucket on the monotonic clock; tests inject
    ``now``.  Starts FULL (the first breach of a run deserves its
    bundle; it is the second that must wait for a refill)."""

    __slots__ = ("capacity", "refill_s", "_tokens", "_t")

    def __init__(self, capacity: float = 1.0, refill_s: float = 300.0,
                 now: Optional[float] = None):
        self.capacity = max(capacity, 1.0)
        self.refill_s = max(refill_s, 1e-9)
        self._tokens = self.capacity
        self._t = time.monotonic() if now is None else now

    def take(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._tokens = min(
            self.capacity, self._tokens + (now - self._t) / self.refill_s
        )
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class BreachSpool:
    """Bounded, rate-limited on-disk spool of breach bundles.

    Two independent defenses against a sustained breach filling the
    disk: the token bucket (one bundle per ``refill_s``) and the spool
    bound (at most ``max_bundles`` ``slo_breach.*.json`` files in the
    directory — counting files, not this process's writes, so restarts
    share the bound).  ``suppressed`` counts the dumps either defense
    refused; it is a signal (sustained breach), not an error."""

    def __init__(self, directory: str, max_bundles: int = 4,
                 refill_s: float = 300.0):
        self.directory = directory
        self.max_bundles = max(int(max_bundles), 1)
        self.bucket = TokenBucket(1.0, refill_s)
        self.written = 0
        self.suppressed = 0

    @staticmethod
    def from_env() -> Optional["BreachSpool"]:
        directory = os.environ.get(DUMP_ENV, "")
        if not directory:
            return None
        return BreachSpool(
            directory,
            max_bundles=int(os.environ.get(DUMP_MAX_ENV, "") or 4),
            refill_s=float(os.environ.get(DUMP_REFILL_ENV, "") or 300.0),
        )

    def bundle_count(self) -> int:
        return len(glob.glob(
            os.path.join(self.directory, "slo_breach.*.json")
        ))

    def maybe_dump(self, bundle, now: Optional[float] = None
                   ) -> Optional[str]:
        """Write one bundle if both defenses allow; ``bundle`` may be a
        dict or a zero-arg callable (built only when the write is
        actually going to happen).  Returns the path or None."""
        if self.bundle_count() >= self.max_bundles:
            self.suppressed += 1
            return None
        if not self.bucket.take(now):
            self.suppressed += 1
            return None
        doc = bundle() if callable(bundle) else bundle
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory,
            f"slo_breach.{runinfo.RUN_ID}.{self.written}.json",
        )
        # noqa: AH102 - one-shot forensic dump; executors may be gone
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        self.written += 1
        return path


def build_bundle(
    policy: SLOPolicy,
    burn: dict,
    ledgers: Iterable[BudgetLedger],
    recorders: Iterable = (),
    timeseries=None,
    util: Optional[dict] = None,
    quorum: Optional[int] = None,
    extra_docs: Iterable[dict] = (),
) -> dict:
    """Compose one forensic snapshot: the flight-recorder docs (with the
    breach attribution computed over them), the telemetry ring, the
    utilization block, the per-group ledger counters, the burn rates at
    trigger time, and the build stamp — everything a postmortem needs
    in ONE file."""
    # Serialize the FULL configured ring, not to_dict()'s 4096-event
    # default: the operator sized the ring (MINBFT_TRACE_RING) to cover
    # the window they care about, and a truncated dump loses exactly the
    # head stages (verify/prepare) that breach attribution needs.
    docs = []
    for r in recorders:
        if r is None:
            continue
        ring = getattr(r, "ring", None)
        docs.append(
            r.to_dict(max_events=ring.capacity)
            if ring is not None
            else r.to_dict()
        )
    docs.extend(d for d in extra_docs if d)
    bundle = {
        "kind": "slo_breach",
        "run_id": runinfo.RUN_ID,
        "build": runinfo.build_info(),
        "policy": policy.to_dict(),
        "burn": burn,
        "ledgers": [
            {
                "group": lg.group,
                "good": lg.good,
                "breached": lg.breached,
                "breached_budget_ms": round(
                    lg.breached_budget_ns / 1e6, 3
                ),
                "budget_remaining": round(lg.budget_remaining(), 4),
            }
            for lg in ledgers
        ],
        "breach": breach_report(docs, policy, quorum=quorum)
        if docs else {},
        "trace": docs,
    }
    if timeseries is not None:
        bundle["timeseries"] = timeseries.to_dict()
    if util is not None:
        bundle["util"] = util
    return bundle


async def watch(
    ts,
    policy: SLOPolicy,
    spool: BreachSpool,
    bundle_fn: Callable[[dict], dict],
    group: Optional[int] = None,
    interval_s: float = 1.0,
) -> None:
    """The auto-dump trigger loop (``peer run`` owns the task): read the
    fast-window burn every interval, and when it crosses the threshold
    hand the spool a lazy bundle (built only if the token bucket and
    spool bound both allow).  Cancel the task to stop."""
    while True:
        await asyncio.sleep(interval_s)
        b = burn_rates(ts, policy, group=group)
        if b["fast_burn"] >= policy.burn_threshold:
            spool.maybe_dump(lambda: bundle_fn(b))
