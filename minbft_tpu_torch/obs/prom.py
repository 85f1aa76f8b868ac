"""Prometheus text exposition of the port (copy of
:mod:`minbft_tpu.obs.prom`; format 0.0.4) over the stdlib — no
aiohttp, no client library: the endpoint is a daemon-thread
``http.server`` serving a render callback, and the render walks plain
counters/histograms.

Consistency model: the scrape thread reads ints the event loop (and the
engine's worker threads) are mutating.  Every exposed value is either a
GIL-atomic int/float store or a monotonic counter, so a scrape sees a
slightly stale but never torn value — the standard Prometheus contract
(scrapes are samples, not transactions).  Nothing here takes the event
loop's locks, so a slow scraper can never stall the protocol; the one
lock a scrape takes is the engine's stats lock, which the dispatcher
threads hold only for a few counter updates.

Left out here: ``collect_engine_pool`` (the multi-GPU engine pool,
``parallel/pool.py``) comes with that module; until then
:func:`collect_group_runtime` has no ``engine_pool`` branch.
"""

from __future__ import annotations

import contextlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .hist import Log2Histogram

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# family = (name, type, help, [(labels, value)]) for counter/gauge;
# histogram families carry (labels, Log2Histogram) samples instead.
Family = Tuple[str, str, str, List[Tuple[Dict[str, str], object]]]


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def render_families(families: Iterable[Family]) -> str:
    """Render metric families to Prometheus text format.

    Histogram samples with a nonzero ``negatives`` counter (clock
    weirdness — obs/hist.py) additionally emit a sibling
    ``{name}_negatives_total`` counter family: the count is part of the
    exposition, never silently dropped."""
    lines: List[str] = []
    for name, mtype, help_text, samples in families:
        if not samples:
            continue
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        if mtype == "histogram":
            neg_samples: List[Tuple[Dict[str, str], int]] = []
            for labels, hist in samples:
                assert isinstance(hist, Log2Histogram)
                bounds = hist.bucket_upper_bounds_s()
                # ONE snapshot of the bucket array, with count/+Inf
                # derived from it: reading live buckets and hist.count
                # separately could interleave with an observe() between
                # its two increments and emit a finite bucket above
                # +Inf — invalid per the histogram contract (le-series
                # must be monotone up to +Inf).
                buckets = list(hist.buckets)
                total = sum(buckets)
                cum = 0
                last_nonzero = -1
                for i, c in enumerate(buckets):
                    if c:
                        last_nonzero = i
                for i in range(last_nonzero + 1):
                    c = buckets[i]
                    cum += c
                    if c == 0 and i != last_nonzero:
                        continue  # empty buckets add no information
                    lb = dict(labels)
                    lb["le"] = repr(bounds[i])
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lb)} {cum}"
                    )
                lb = dict(labels)
                lb["le"] = "+Inf"
                lines.append(f"{name}_bucket{_fmt_labels(lb)} {total}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {_fmt_value(hist.total_s)}"
                )
                lines.append(f"{name}_count{_fmt_labels(labels)} {total}")
                neg = getattr(hist, "negatives", 0)
                if neg:
                    neg_samples.append((labels, neg))
            if neg_samples:
                lines.append(
                    f"# HELP {name}_negatives_total negative-duration "
                    "observations dropped from the histogram (clock sanity)"
                )
                lines.append(f"# TYPE {name}_negatives_total counter")
                for labels, neg in neg_samples:
                    lines.append(
                        f"{name}_negatives_total{_fmt_labels(labels)} {neg}"
                    )
        else:
            for labels, value in samples:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}"
                )
    return "\n".join(lines) + "\n"


def collect_replica(
    metrics=None,
    recorder=None,
    engine=None,
    replica_id: Optional[int] = None,
    group: Optional[int] = None,
    timeseries=None,
    groups: Optional[int] = None,
    stall_after_s: float = 30.0,
    slo=None,
    slo_spool=None,
    recovery=None,
) -> List[Family]:
    """Build the metric families for one replica process.

    ``metrics`` is a :class:`minbft_tpu_torch.utils.metrics.ReplicaMetrics`,
    ``recorder`` a :class:`minbft_tpu_torch.obs.trace.FlightRecorder` (or
    None when tracing is off — the stage families simply vanish), and
    ``engine`` a :class:`minbft_tpu_torch.parallel.BatchVerifier` (or None
    for ``--no-batch`` replicas).

    ``group`` labels every family with the consensus-group id (the
    multi-group runtime calls this once per group core; metrics that
    carry their own ``ReplicaMetrics.group`` stamp win when the caller
    passes none).  Merged scrapes stay group-separable: ``peer
    metrics``' cluster aggregate strips only the per-process ``replica``
    label, so the same group's series fold across replicas while
    distinct groups never merge.
    """
    if group is None and metrics is not None:
        group = getattr(metrics, "group", None)
    base = {} if replica_id is None else {"replica": str(replica_id)}
    if group is not None:
        base["group"] = str(group)
    fams: List[Family] = []
    if metrics is not None:
        # Incarnation attribution: which PROCESS produced
        # every series in this exposition.  Value is the constant 1 —
        # the information is the labels (the kube_state_metrics idiom),
        # so merged multi-target scrapes stay attributable per pid/rev.
        from . import runinfo

        info = runinfo.build_info(
            replica_id=replica_id, group=group, groups=groups
        )
        fams.append(
            (
                "minbft_build_info",
                "gauge",
                "process incarnation attribution (pid, run_id, backend, "
                "git rev); value is always 1",
                [({**base, **info}, 1)],
            )
        )
        # dict(...) snapshots the counter map once: the loop may insert
        # new counters mid-walk.
        for cname, v in sorted(dict(metrics.counters).items()):
            fams.append(
                (
                    f"minbft_{cname}_total",
                    "counter",
                    f"protocol counter {cname}",
                    [(base, v)],
                )
            )
        fams.append(
            (
                "minbft_uptime_seconds",
                "gauge",
                "seconds since the replica's metrics started",
                [(base, round(metrics.uptime_s, 3))],
            )
        )
        exec_hist = getattr(metrics, "execute_hist", None)
        if exec_hist is not None and exec_hist.count:
            fams.append(
                (
                    "minbft_execute_latency_seconds",
                    "histogram",
                    "request execution latency (deliver to the consumer)",
                    [(base, exec_hist)],
                )
            )
        ingest_hist = getattr(metrics, "ingest_hist", None)
        if ingest_hist is not None and ingest_hist.count:
            fams.append(
                (
                    "minbft_ingest_bundle_frames",
                    "histogram",
                    "frames decoded per ingest tick (le = bundle size in "
                    "frames, log2 buckets — the bundle-fill distribution)",
                    [(base, ingest_hist)],
                )
            )
        lag_hist = getattr(metrics, "loop_lag", None)
        if lag_hist is not None and (lag_hist.count or lag_hist.negatives):
            fams.append(
                (
                    "minbft_eventloop_lag_seconds",
                    "histogram",
                    "event-loop scheduling lag (scheduled-vs-actual wakeup "
                    "delta sampled by obs/looplag.py — GIL/loop saturation)",
                    [(base, lag_hist)],
                )
            )
        # Admission-control state: the ingest rx queue's
        # last-stamped occupancy, bound, high-water mark, and the derived
        # saturation fraction.  The companion shed counters
        # (minbft_admission_shed_total / minbft_admission_busy_sent_total
        # / minbft_admission_busy_suppressed_total) ride the counter loop
        # above.  Families appear once the ingestor has stamped at least
        # one tick (bound > 0) — an idle replica stays quiet.
        if getattr(metrics, "admission_rx_bound", 0):
            fams.append(
                (
                    "minbft_admission_rx_depth",
                    "gauge",
                    "ingest rx queue occupancy at the last ingest tick",
                    [(base, int(metrics.admission_rx_depth))],
                )
            )
            fams.append(
                (
                    "minbft_admission_rx_bound",
                    "gauge",
                    "ingest rx queue capacity (frames)",
                    [(base, int(metrics.admission_rx_bound))],
                )
            )
            fams.append(
                (
                    "minbft_admission_rx_peak",
                    "gauge",
                    "ingest rx queue high-water mark (bounded-queue-growth "
                    "witness for the overload tests)",
                    [(base, int(metrics.admission_rx_peak))],
                )
            )
            fams.append(
                (
                    "minbft_admission_rx_saturation",
                    "gauge",
                    "rx fill fraction in [0,1] — scales the BUSY "
                    "retry-after hint",
                    [(base, round(metrics.admission_rx_saturation(), 4))],
                )
            )
        # Health monitors: evaluated AT SCRAPE TIME from the
        # metrics' stamps — no detector thread to die silently.
        if hasattr(metrics, "current_view"):
            fams.append(
                (
                    "minbft_health_view",
                    "gauge",
                    "view this replica currently operates in",
                    [(base, int(metrics.current_view))],
                )
            )
        if hasattr(metrics, "stalled"):
            fams.append(
                (
                    "minbft_health_commit_stall",
                    "gauge",
                    "1 when messages keep arriving but nothing has "
                    f"executed for >{stall_after_s:g}s (commit stall); "
                    "an idle replica reads 0",
                    [(base, 1 if metrics.stalled(stall_after_s) else 0)],
                )
            )
    if timeseries is not None:
        # Recent-window readings from the telemetry rings
        # (obs/timeseries.py): rate series as per-second rates over the
        # last 10 completed intervals, gauge series as window means —
        # the live numbers `peer top --once` renders without needing two
        # scrapes to diff.
        win = timeseries.window(10 * timeseries.interval_s)
        for sname in sorted(win):
            fams.append(
                (
                    f"minbft_window_{sname}",
                    "gauge",
                    f"recent-window reading of the {sname} telemetry "
                    "ring (last 10 intervals)",
                    [(base, round(win[sname], 3))],
                )
            )
    if recorder is not None:
        samples = []
        for name, h in recorder.stage_hists().items():
            lb = dict(base)
            lb["stage"] = name
            samples.append((lb, h))
        fams.append(
            (
                "minbft_stage_latency_seconds",
                "histogram",
                "flight-recorder span: time from the previous capture "
                "point to this stage",
                samples,
            )
        )
    if engine is not None:
        fams.extend(_collect_engine(engine, base))
    if slo is not None:
        # ``slo`` is the replica's obs.slo.BudgetLedger; burn rates read
        # the same rings the minbft_window_* gauges render.
        fams.extend(
            collect_slo(
                [slo], timeseries=timeseries, spool=slo_spool, base=base
            )
        )
    if recovery is not None:
        fams.extend(collect_recovery([recovery], base=base))
    return fams


def collect_recovery(
    managers, base: Optional[Dict[str, str]] = None
) -> List[Family]:
    """Families for the crash-recovery subsystem
    (:class:`minbft_tpu_torch.recovery.RecoveryManager`, one per replica core):
    the phase gauge, chunk/byte transfer counters split by direction,
    resume/failover counts, durable-store save counters, and — once a
    restarted replica executes its first request — the
    ``minbft_recovery_time_ms`` SLO gauge the chaos soak gates
    (benchgate key ``chaos_recovery_time_ms``)."""
    base = dict(base or {})
    fams: List[Family] = []

    def lb(m, **extra):
        out = dict(base)
        if m.group is not None:
            out["group"] = str(m.group)
        out.update(extra)
        return out

    fams.append(
        (
            "minbft_recovery_phase",
            "gauge",
            "recovery phase (0=idle 1=load 2=fetch 3=install 4=catchup "
            "5=done)",
            [(lb(m), m.phase) for m in managers],
        )
    )
    fams.append(
        (
            "minbft_recovery_chunks_total",
            "counter",
            "state-transfer chunks moved, by direction (rx=fetched and "
            "verified, tx=served)",
            [
                s
                for m in managers
                for s in (
                    (lb(m, dir="rx"), m.chunks_rx),
                    (lb(m, dir="tx"), m.chunks_tx),
                )
            ],
        )
    )
    fams.append(
        (
            "minbft_recovery_bytes_total",
            "counter",
            "state-transfer payload bytes moved, by direction",
            [
                s
                for m in managers
                for s in (
                    (lb(m, dir="rx"), m.bytes_rx),
                    (lb(m, dir="tx"), m.bytes_tx),
                )
            ],
        )
    )
    fams.append(
        (
            "minbft_recovery_resume_total",
            "counter",
            "chunked transfers resumed from a verified offset after an "
            "interruption (same source, no bytes re-downloaded)",
            [(lb(m), m.resumes) for m in managers],
        )
    )
    fams.append(
        (
            "minbft_recovery_failover_total",
            "counter",
            "chunked transfers failed over to another source (stalled or "
            "Byzantine-corrupt stream)",
            [(lb(m), m.failovers) for m in managers],
        )
    )
    fams.append(
        (
            "minbft_recovery_saves_total",
            "counter",
            "durable checkpoint saves committed (atomic write-rename)",
            [(lb(m), m.saves) for m in managers],
        )
    )
    restored = [
        (lb(m), m.restored_count)
        for m in managers
        if m.restored_count is not None
    ]
    if restored:
        fams.append(
            (
                "minbft_recovery_restored_count",
                "gauge",
                "stable execution count restored from the durable store "
                "at startup",
                restored,
            )
        )
    times = [
        (lb(m), round(m.recovery_time_ms, 3))
        for m in managers
        if m.recovery_time_ms is not None
    ]
    if times:
        fams.append(
            (
                "minbft_recovery_time_ms",
                "gauge",
                "restart-to-first-executed-request time (the recovery SLO "
                "the chaos soak gates as chaos_recovery_time_ms)",
                times,
            )
        )
    return fams


def collect_slo(ledgers, timeseries=None, spool=None,
                base: Optional[Dict[str, str]] = None,
                now: Optional[float] = None) -> List[Family]:
    """Families for the latency-SLO engine (obs/slo.py): per-group
    good/breached counters, the policy knobs, remaining error-budget
    fraction, the fast/slow burn rates (read from the telemetry rings —
    omitted when no ring is attached), and the breach-dump spool
    counters.  A stale group stops committing, its good counter stops
    moving, and its windowed breach fraction reads budget burn — the
    per-group labels are what make that legible."""
    from . import slo as obs_slo

    base = dict(base or {})
    ledgers = [lg for lg in ledgers if lg is not None]
    if not ledgers:
        return []

    def lb(lg) -> Dict[str, str]:
        if lg.group is None or "group" in base:
            return base
        return {**base, "group": str(lg.group)}

    fams: List[Family] = [
        ("minbft_slo_good_total", "counter",
         "requests that committed inside the finality budget "
         "(recv-origin, classified at commit quorum)",
         [(lb(lg), lg.good) for lg in ledgers]),
        ("minbft_slo_breached_total", "counter",
         "requests that committed past the finality budget",
         [(lb(lg), lg.breached) for lg in ledgers]),
        ("minbft_slo_target_ms", "gauge",
         "finality budget per request (SLOPolicy.target_ms)",
         [(lb(lg), lg.policy.target_ms) for lg in ledgers]),
        ("minbft_slo_objective", "gauge",
         "fraction of requests that must meet the budget",
         [(lb(lg), lg.policy.objective) for lg in ledgers]),
        ("minbft_slo_budget_remaining", "gauge",
         "remaining error-budget fraction this incarnation (1 = "
         "untouched, negative = overspent — not clamped)",
         [(lb(lg), round(lg.budget_remaining(), 4)) for lg in ledgers]),
        ("minbft_slo_burn_threshold", "gauge",
         "fast-window burn multiple that trips breach forensics and "
         "the `peer top` BREACH flag",
         [(lb(lg), lg.policy.burn_threshold) for lg in ledgers]),
    ]
    if timeseries is not None:
        burn_samples = []
        for lg in ledgers:
            b = obs_slo.burn_rates(
                timeseries, lg.policy, now=now, group=lg.group
            )
            for window in ("fast", "slow"):
                burn_samples.append(
                    ({**lb(lg), "window": window}, b[f"{window}_burn"])
                )
        fams.append(
            ("minbft_slo_burn_rate", "gauge",
             "error-budget burn multiple over the window (1.0 spends "
             "the budget exactly as fast as the objective allows)",
             burn_samples)
        )
    if spool is not None:
        fams.append(
            ("minbft_slo_breach_dumps_total", "counter",
             "breach forensic bundles written to the spool",
             [(base, spool.written)])
        )
        fams.append(
            ("minbft_slo_breach_dumps_suppressed_total", "counter",
             "breach dumps refused by the token bucket or the spool "
             "bound (a signal of sustained breach, not an error)",
             [(base, spool.suppressed)])
        )
    return fams


def merge_family_lists(lists: Iterable[List[Family]]) -> List[Family]:
    """Fold several family lists into one exposition-valid list: a
    family name may appear only once per exposition, so per-group
    ``collect_replica`` outputs (multi-group runtime — same families,
    distinct ``group`` labels) concatenate their SAMPLES under one
    family block instead of repeating the block."""
    merged: Dict[str, list] = {}
    order: List[str] = []
    for fams in lists:
        for name, mtype, help_text, samples in fams:
            ent = merged.get(name)
            if ent is None:
                merged[name] = [mtype, help_text, list(samples)]
                order.append(name)
            else:
                ent[2].extend(samples)
    return [
        (name, merged[name][0], merged[name][1], merged[name][2])
        for name in order
    ]


def collect_group_runtime(runtime, engine=None, replica_id=None,
                          timeseries=None, slo_spool=None) -> List[Family]:
    """Families for a :class:`minbft_tpu_torch.groups.GroupRuntime`: one
    ``collect_replica`` per group core (every series carries its
    ``group`` label), the shared engine's families once (its queues
    really are shared — splitting them per group would double-count).
    The time-series rings and the stale-group health gauge are
    process-level and likewise emitted once.  The reference's
    ``engine_pool`` branch (the ``minbft_engine_pool_*`` per-chip
    families) waits for the port's engine pool."""
    n_groups = len(runtime.cores)
    lists = [
        collect_replica(
            metrics=core.metrics,
            recorder=core.handlers.trace,
            replica_id=replica_id,
            group=core.group,
            groups=n_groups,
        )
        for core in runtime.cores
    ]
    if engine is not None:
        lists.append(collect_replica(engine=engine, replica_id=replica_id))
    if timeseries is not None:
        lists.append(
            collect_replica(timeseries=timeseries, replica_id=replica_id)
        )
    # One collect_slo across every core's ledger: the per-group burn
    # rates all read the ONE process-level ring (series are per-group
    # suffixed), and the spool counters are process-level.
    slo_ledgers = [
        core.handlers.slo for core in runtime.cores
        if getattr(core.handlers, "slo", None) is not None
    ]
    if slo_ledgers:
        base = {} if replica_id is None else {"replica": str(replica_id)}
        lists.append(
            collect_slo(
                slo_ledgers, timeseries=timeseries, spool=slo_spool,
                base=base,
            )
        )
    # One collect_recovery across every core's manager: each carries its
    # own group label (like the SLO ledgers).
    recovery_managers = [
        core.recovery for core in runtime.cores
        if getattr(core, "recovery", None) is not None
    ]
    if recovery_managers:
        base = {} if replica_id is None else {"replica": str(replica_id)}
        lists.append(collect_recovery(recovery_managers, base=base))
    fams = merge_family_lists(lists)
    stale_fn = getattr(runtime, "stale_groups", None)
    if stale_fn is not None:
        base = {} if replica_id is None else {"replica": str(replica_id)}
        stale = stale_fn()
        fams.append(
            (
                "minbft_health_stale_group",
                "gauge",
                "1 when this group core has made no progress while a "
                "sibling group on the same process has (stale-group "
                "detector, groups/runtime.py)",
                [
                    ({**base, "group": str(core.group)},
                     1 if core.group in stale else 0)
                    for core in runtime.cores
                ],
            )
        )
    return fams


def collect_faultnet(census, base: Optional[Dict[str, str]] = None) -> List[Family]:
    """Metric families for a fault-injection census
    (:class:`minbft_tpu_torch.testing.faultnet.FaultCensus`, duck-typed:
    ``counters`` per-kind totals, ``links`` per-(src,dst) kind maps,
    ``frames`` per-link frame counts).  Lets a chaos run's fault census
    ride the same Prometheus endpoint as the protocol counters — the
    injected-fault ground truth next to the recovery metrics it caused.
    """
    base = dict(base or {})
    fams: List[Family] = []
    totals = [
        ({**base, "kind": kind}, v)
        for kind, v in sorted(dict(census.counters).items())
    ]
    fams.append(
        (
            "minbft_faultnet_injected_total",
            "counter",
            "faults injected by kind (faultnet census)",
            totals,
        )
    )
    per_link = []
    for (src, dst), kinds in sorted(dict(census.links).items()):
        for kind, v in sorted(dict(kinds).items()):
            per_link.append(
                ({**base, "link": f"{src}>{dst}", "kind": kind}, v)
            )
    fams.append(
        (
            "minbft_faultnet_link_injected_total",
            "counter",
            "faults injected per directed link and kind",
            per_link,
        )
    )
    fams.append(
        (
            "minbft_faultnet_frames_total",
            "counter",
            "frames that traversed each directed link (replay input)",
            [
                ({**base, "link": f"{src}>{dst}"}, v)
                for (src, dst), v in sorted(dict(census.frames).items())
            ],
        )
    )
    return fams


def _collect_engine(engine, base: Dict[str, str]) -> List[Family]:
    fams: List[Family] = []
    peak_fn = getattr(engine, "queue_depth_peaks", None)
    sign_peak_fn = getattr(engine, "sign_queue_depth_peaks", None)
    stats_lock = getattr(engine, "_stats_lock", None) or contextlib.nullcontext()
    for side, stats_map, depths, peaks in (
        ("verify", engine.stats, engine.queue_depths(),
         peak_fn() if peak_fn else {}),
        ("sign", engine.sign_stats, engine.sign_queue_depths(),
         sign_peak_fn() if sign_peak_fn else {}),
    ):
        counters: Dict[str, List] = {
            "items": [],
            "batches": [],
            "padded_lanes": [],
            "dispatch_timeouts": [],
        }
        seconds: Dict[str, List] = {"device": [], "host_prep": []}
        flushes: List = []
        occupancy: List = []
        depth_samples: List = []
        wait_samples: List = []
        service_samples: List = []
        # The dispatcher threads update padded_lanes and host_prep_time_s
        # under the engine's stats lock (BatchVerifier._note_prep): read
        # every queue's counters under it too, so one scrape sees one
        # consistent set per queue.
        with stats_lock:
            for qname, st in sorted(stats_map.items()):
                lb = dict(base)
                lb["queue"] = qname
                for k in counters:
                    counters[k].append((lb, getattr(st, k, 0)))
                seconds["device"].append((lb, st.device_time_s))
                seconds["host_prep"].append((lb, st.host_prep_time_s))
                qw = getattr(st, "queue_wait", None)
                if qw is not None and (qw.count or qw.negatives):
                    wait_samples.append((lb, qw))
                qs = getattr(st, "queue_service", None)
                if qs is not None and (qs.count or qs.negatives):
                    service_samples.append((lb, qs))
                # dict(...) snapshots before iterating: the event loop
                # inserts new reasons/buckets while this thread walks.
                for reason, cnt in sorted(
                    dict(getattr(st, "flush_reasons", {})).items()
                ):
                    lbr = dict(lb)
                    lbr["reason"] = reason
                    flushes.append((lbr, cnt))
                for log2_size, cnt in sorted(
                    dict(getattr(st, "occupancy", {})).items()
                ):
                    lbo = dict(lb)
                    # upper bound of the log2 occupancy bucket, in items
                    lbo["le_items"] = str(1 << int(log2_size))
                    occupancy.append((lbo, cnt))
        peak_samples: List = []
        for qname, depth in sorted(depths.items()):
            lb = dict(base)
            lb["queue"] = qname
            depth_samples.append((lb, depth))
            peak_samples.append((lb, peaks.get(qname, depth)))
        p = f"minbft_{side}_queue"
        fams.append((f"{p}_items_total", "counter",
                     f"{side} items dispatched", counters["items"]))
        fams.append((f"{p}_batches_total", "counter",
                     f"{side} batches dispatched", counters["batches"]))
        fams.append((f"{p}_padded_lanes_total", "counter",
                     "bucket-padding lanes wasted", counters["padded_lanes"]))
        fams.append((f"{p}_dispatch_timeouts_total", "counter",
                     "hung dispatches, failed with TimeoutError",
                     counters["dispatch_timeouts"]))
        fams.append((f"{p}_device_seconds_total", "counter",
                     "seconds awaiting dispatches", seconds["device"]))
        fams.append((f"{p}_host_prep_seconds_total", "counter",
                     "host share of dispatch time (prep/pack/finish)",
                     seconds["host_prep"]))
        fams.append((f"{p}_flushes_total", "counter",
                     "queue flushes by reason (full/idle/timer/completion)",
                     flushes))
        fams.append((f"{p}_batch_occupancy_total", "counter",
                     "batches by log2 occupancy bucket (pre-padding)",
                     occupancy))
        fams.append((f"{p}_wait_seconds", "histogram",
                     "per-item wait from enqueue to dispatch (the "
                     "batch-formation / queue-wait attribution)",
                     wait_samples))
        fams.append((f"{p}_service_seconds", "histogram",
                     "dispatch to completion (kernel + transfer + host "
                     "prep, shared by every lane of the batch)",
                     service_samples))
        fams.append((f"{p}_depth", "gauge",
                     "items pending in the queue right now", depth_samples))
        fams.append((f"{p}_depth_peak", "gauge",
                     "high-water mark of the queue depth since the last "
                     "scrape (peak backlog the point-in-time gauge misses)",
                     peak_samples))
    return fams


class MetricsServer:
    """``/metrics`` on a daemon thread (stdlib ThreadingHTTPServer).

    ``render`` is called per scrape on a SERVER thread — it must only
    read (see the module docstring's consistency model).  ``start``
    returns the bound port (pass 0 to pick a free one).  Binds loopback
    by default: the endpoint is unauthenticated, so exposing it beyond
    the host is an explicit operator decision (``--metrics-host``)."""

    def __init__(self, render: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 0):
        self._render = render
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        render = self._render

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API name
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = render().encode()
                except Exception as e:  # noqa: BLE001 - a scrape bug
                    # must report, not kill the handler thread silently
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="minbft-metrics",
            daemon=True,
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def scrape(url: str, timeout: float = 5.0) -> str:
    """One-shot metrics fetch (the ``peer metrics`` subcommand).
    ``url`` may be a bare ``host:port`` — ``/metrics`` is implied."""
    from urllib.request import urlopen

    if "://" not in url:
        url = "http://" + url
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


# ---------------------------------------------------------------------------
# Cluster aggregation: parse expositions back and merge them.
#
# The log2 histograms are exactly mergeable BY DESIGN (identical fixed
# bucket edges everywhere — obs/hist.py), so N replicas' scrapes fold
# into one cluster exposition with no re-binning: per-``le`` bucket
# counts add, ``_sum``/``_count`` add, counters add.  Gauges
# (depths, uptime) are point-in-time per process and are summed too —
# a cluster-total reading (document accordingly; a mean would be wrong
# for depths and a max wrong for uptime, total is at least well-defined).

_SAMPLE_RE = None  # compiled lazily (parsing is a cold operator path)


def _parse_labels(inner: str) -> Dict[str, str]:
    import re

    return {
        m.group(1): m.group(2).replace('\\"', '"').replace("\\\\", "\\")
        for m in re.finditer(r'(\w+)="((?:[^"\\]|\\.)*)"', inner or "")
    }


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse Prometheus text (format 0.0.4) into
    ``{family: {"type", "help", "samples"}}``.

    Histogram families collapse their ``_bucket``/``_sum``/``_count``
    series back into per-sample ``{"buckets": {le: cumulative}, "sum",
    "count"}`` keyed by the non-``le`` labels; counter/gauge samples map
    labels→value.  Built for OUR exposition (render_families output) —
    a general scraper it is not."""
    import re

    global _SAMPLE_RE
    if _SAMPLE_RE is None:
        _SAMPLE_RE = re.compile(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
        )
    fams: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, mtype = rest.partition(" ")
            types[name] = mtype
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            helps[name] = help_text
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        sname, inner, raw = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(inner)
        value = float("inf") if raw == "+Inf" else float(raw)
        # Histogram series fold back under their family name.
        fam_name, part = sname, "value"
        for suffix in ("_bucket", "_sum", "_count"):
            base = sname[: -len(suffix)]
            if sname.endswith(suffix) and types.get(base) == "histogram":
                fam_name, part = base, suffix[1:]
                break
        mtype = types.get(fam_name, "untyped")
        fam = fams.setdefault(
            fam_name,
            {"type": mtype, "help": helps.get(fam_name, ""), "samples": {}},
        )
        if mtype == "histogram":
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            sample = fam["samples"].setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0}
            )
            if part == "bucket" and le is not None:
                sample["buckets"][
                    float("inf") if le == "+Inf" else float(le)
                ] = int(value)
            elif part == "sum":
                sample["sum"] = value
            elif part == "count":
                sample["count"] = int(value)
        else:
            key = tuple(sorted(labels.items()))
            fam["samples"][key] = value
    return fams


def merge_expositions(texts: Iterable[str],
                      drop_labels: Tuple[str, ...] = ("replica",)) -> str:
    """Merge several scraped expositions into ONE cluster aggregate.

    ``drop_labels`` (default: the per-process ``replica`` id) are
    stripped before merging so the same logical series from different
    replicas folds together.  Histograms merge exactly (cumulative
    counts are diffed to per-bucket, summed per ``le``, re-accumulated
    over the union grid); counters and gauges sum."""
    merged: Dict[str, dict] = {}
    for text in texts:
        for name, fam in parse_exposition(text).items():
            out = merged.setdefault(
                name, {"type": fam["type"], "help": fam["help"], "samples": {}}
            )
            for key, value in fam["samples"].items():
                key = tuple(
                    (k, v) for k, v in key if k not in drop_labels
                )
                if fam["type"] == "histogram":
                    agg = out["samples"].setdefault(
                        key, {"buckets": {}, "sum": 0.0, "count": 0}
                    )
                    # cumulative -> per-bucket before summing: targets
                    # skip empty buckets, so their ``le`` grids differ.
                    prev = 0
                    for le in sorted(value["buckets"]):
                        c = value["buckets"][le]
                        agg["buckets"][le] = (
                            agg["buckets"].get(le, 0) + (c - prev)
                        )
                        prev = c
                    agg["sum"] += value["sum"]
                    agg["count"] += value["count"]
                else:
                    out["samples"][key] = out["samples"].get(key, 0) + value
    # Render back to exposition text.
    lines: List[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if not fam["samples"]:
            continue
        lines.append(f"# HELP {name} {fam['help']}".rstrip())
        lines.append(f"# TYPE {name} {fam['type']}")
        for key in sorted(fam["samples"]):
            labels = dict(key)
            value = fam["samples"][key]
            if fam["type"] == "histogram":
                cum = 0
                for le in sorted(value["buckets"]):
                    cum += value["buckets"][le]
                    lb = dict(labels)
                    lb["le"] = "+Inf" if le == float("inf") else repr(le)
                    lines.append(f"{name}_bucket{_fmt_labels(lb)} {cum}")
                if float("inf") not in value["buckets"]:
                    lb = dict(labels)
                    lb["le"] = "+Inf"
                    lines.append(f"{name}_bucket{_fmt_labels(lb)} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(value['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {value['count']}"
                )
            else:
                v = value
                if fam["type"] == "counter" and float(v).is_integer():
                    v = int(v)
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"
