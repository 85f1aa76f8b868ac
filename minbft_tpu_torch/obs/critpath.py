"""Cluster-wide causal critical path of committed requests.

The flight recorder (obs/trace.py) attributes a request's time WITHIN
one process; the >100x host/device gap lives BETWEEN processes —
network hops, rx-queue waits, engine batch-formation waits, quorum
stalls.  This module merges the per-process trace dumps
(``load_dumps`` ingests ``{base}.r{id}.json`` / ``.c{id}.json`` /
``.engine{id}.json``) into ONE causal timeline per request, keyed on
the ``(client_id, seq)`` pair every REQUEST/PREPARE/COMMIT/REPLY
already carries — no wire change — and computes the per-request
critical path:

    client send → primary ingest → verify wait → PREPARE batch wait →
    backup commit quorum → execute → reply sign → f+1 reply → client
    accept

Cross-process timestamps go through :mod:`~minbft_tpu_torch.obs.clockalign`
first; the pairwise uncertainty bound rides into every cross-node
segment (``RequestPath.err_ns``), so a cross-node segment is never
trusted tighter than the offset error.

Segment semantics (``SEGMENTS`` order; raw spans telescope from the
client's ``start`` to its ``quorum`` note, so shares sum to 1.0 with
the residual reported honestly as ``unattributed``):

- ``client_sign`` — start → signature resolved (client sign-queue wait
  included); ``client_gate`` — sign → broadcast (the seq-order send
  gate).
- ``ingress`` — client broadcast → the PRIMARY's first entry note
  (``ingest``/``recv``): network + transport rx queue + bundle-tick
  wait, minus the ``loop_lag`` carve below.
- ``loop_lag`` — the event-loop saturation share of ingress: the mean
  sampled scheduled-vs-actual loop delta (obs/looplag.py, carried in
  replica dumps), counted for the ONE guaranteed loop crossing at
  ingest and clamped to the observed ingress span — a deliberate
  lower-bound attribution (every later hop crosses the loop again, but
  those crossings are already inside other segments' spans).
- ``preverify`` — entry → verify_enqueue (decode + handler dispatch).
- ``queue_wait`` — the engine-queue wait share of the verify and
  reply-sign engine round trips, split by the measured
  enqueue→dispatch vs dispatch→complete ratio from the engine
  queue-wait histograms (``engine_queue_doc``); ``verify`` and
  ``reply_sign`` keep the complementary service share.  The ratio is
  aggregated per side (verify/sign) across schemes — a documented
  approximation, exact when one scheme dominates a side (the usual
  bench shape).
- ``prepare_wait`` — verify_done → PREPARE applied on the primary (the
  batch-formation wait: how long the request sat waiting for a PREPARE
  batch to ship).
- ``commit`` — primary PREPARE → the (f+1)-th replica's commit quorum:
  PREPARE broadcast, backup processing, COMMIT wave, quorum formation.
  Rank-based: per-replica stage times are order-statistics-coupled
  (stage_k(i) >= stage_{k-1}(i) per replica i, so the (f+1)-th
  smallest of a later stage is >= the (f+1)-th of an earlier one —
  rank differences are non-negative under one clock by construction).
- ``execute`` / ``reply_sign`` / ``reply_send`` — rank-(f+1)
  differences through the executor, the sign queue, and the reply
  marshal.
- ``reply_net`` — (f+1)-th reply_sent → the client's quorum note.
- ``unattributed`` — the telescoping residual: missing stages, clamped
  negative cross-node spans, anything the capture points cannot see.

``critpath_table`` mirrors ``stage_table``: one flat dict of
``{prefix}_critpath_{segment}_share`` keys (always the full segment
set, so the key set is stable), plus request/total/err metadata.  The
merged histograms' ``negatives`` counters (obs/hist.py) feed a
clock-sanity key: negative spans inside any single process mean the
pairing itself is suspect, not just the cross-clock math.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from . import clockalign
from .hist import Log2Histogram

# Segment names, in causal order.  ``unattributed`` is always last.
SEGMENTS: Tuple[str, ...] = (
    "client_sign",
    "client_gate",
    "ingress",
    "loop_lag",
    "preverify",
    "queue_wait",
    "verify",
    "prepare_wait",
    "commit",
    "execute",
    "reply_sign",
    "reply_send",
    "reply_net",
    "unattributed",
)


@dataclasses.dataclass
class RequestPath:
    """One committed request's merged causal timeline."""

    cid: int
    seq: int
    total_ns: float
    segments: Dict[str, float]  # segment -> ns (>= 0, sums to total_ns)
    err_ns: float  # clock-offset uncertainty bound on cross-node segments
    primary: int  # replica id the head of the path ran through


@dataclasses.dataclass
class ClusterPaths:
    paths: List[RequestPath]
    skipped: int  # requests seen but not fully observable
    quorum: int  # f+1 used for the rank-based tail
    clock_err_ns: float  # max pairwise alignment uncertainty
    negative_spans: int  # clock-sanity: negatives across merged hists
    # Incarnation honesty: dump docs dropped because the same
    # (kind, id, group) appeared under two run_ids — a restarted process
    # reuses its replica id AND its (client_id, seq) keyspace, so
    # splicing both incarnations would manufacture chimera paths.
    refused_docs: int = 0


def _drop_conflicting_incarnations(docs: List[dict]) -> Tuple[List[dict], int]:
    """Drop every doc of any identity that appears under two different
    ``run_id``s (docs without the stamp — older dumps — are
    trusted as single-incarnation; mixing a stamped and an unstamped doc
    of one identity is indistinguishable from a restart, so it refuses
    too once any stamped doc exists for that identity)."""
    runs: Dict[Tuple, set] = {}
    for d in docs:
        if d.get("kind") in ("replica", "client") and d.get("id") is not None:
            key = (d.get("kind"), d.get("id"), d.get("group"))
            runs.setdefault(key, set()).add(d.get("run_id"))
    conflicted = {k for k, v in runs.items() if len(v) > 1}
    if not conflicted:
        return docs, 0
    kept = [
        d for d in docs
        if (d.get("kind"), d.get("id"), d.get("group")) not in conflicted
    ]
    return kept, len(docs) - len(kept)


def engine_queue_doc(engine, ident: int = 0) -> dict:
    """Dump-doc for one engine's queue-wait/service histograms
    (engine.VerifyStats/SignStats ``queue_wait``/``queue_service``) —
    written as ``{base}.engine{ident}.json`` next to the recorder dumps
    so ``load_dumps`` carries it into the merge."""

    def hists(stats_map: dict, attr: str) -> dict:
        out = {}
        for name, st in stats_map.items():
            h = getattr(st, attr, None)
            if h is not None and (h.count or h.negatives):
                out[name] = h.to_dict()
        return out

    return {
        "kind": "engine",
        "id": ident,
        "verify_queue_wait": hists(engine.stats, "queue_wait"),
        "verify_queue_service": hists(engine.stats, "queue_service"),
        "sign_queue_wait": hists(engine.sign_stats, "queue_wait"),
        "sign_queue_service": hists(engine.sign_stats, "queue_service"),
    }


def _merged_hist(dicts: Iterable[dict]) -> Log2Histogram:
    h = Log2Histogram()
    for d in dicts:
        h.merge(Log2Histogram.from_dict(d))
    return h


def _wait_ratio(docs: List[dict], side: str) -> Optional[float]:
    """enqueue→dispatch share of the engine round trip for one queue
    side ('verify' | 'sign'), aggregated across schemes and engines.
    None when no engine doc carries that side's histograms."""
    wait = _merged_hist(
        h for d in docs for h in (d.get(f"{side}_queue_wait") or {}).values()
    )
    service = _merged_hist(
        h for d in docs for h in (d.get(f"{side}_queue_service") or {}).values()
    )
    denom = wait.total_s + service.total_s
    if wait.count + service.count == 0 or denom <= 0:
        return None
    return wait.total_s / denom


def _doc_negatives(doc: dict) -> int:
    n = 0
    for hd in (doc.get("hists") or {}).values():
        n += int(hd.get("negatives", 0))
    ll = doc.get("loop_lag")
    if ll:
        n += int(ll.get("negatives", 0))
    for key in ("verify_queue_wait", "verify_queue_service",
                "sign_queue_wait", "sign_queue_service"):
        for hd in (doc.get(key) or {}).values():
            n += int(hd.get("negatives", 0))
    return n


def _rank(values: List[float], k: int) -> Optional[float]:
    """k-th smallest (1-based), None when fewer than k values."""
    if len(values) < k:
        return None
    return sorted(values)[k - 1]


def cluster_paths(docs: Iterable[dict], quorum: Optional[int] = None) -> ClusterPaths:
    """Merge dump docs into per-request critical paths.

    ``quorum`` is f+1 for the rank-based tail; defaults to the ``f``
    the replica dumps carry (``dump extra``), falling back to the BFT
    bound for the dumped replica count.
    """
    docs = list(docs)
    # Incarnation refusal BEFORE any stitching: two run_ids under one
    # replica/client identity are two processes whose (client_id, seq)
    # keys overlap — their events must never meet in one path.
    docs, refused = _drop_conflicting_incarnations(docs)
    groups = {d["group"] for d in docs if d.get("group") is not None}
    if len(groups) > 1:
        # Multi-group dump set (a GroupRuntime process dumps every core,
        # a MultiGroupClient every inner client): (client_id, seq) is
        # only unique WITHIN a group — the G inner clients share one
        # client id with wall-clock-seeded seq spaces that can overlap —
        # so stitch each group's docs separately (unstamped docs like
        # the shared engine's stay in every partition, exactly the
        # filter_group contract) and fold the results.
        from .trace import filter_group

        merged: Optional[ClusterPaths] = None
        for g in sorted(groups):
            res = cluster_paths(filter_group(docs, g), quorum=quorum)
            if merged is None:
                merged = res
            else:
                merged.paths.extend(res.paths)
                merged.skipped += res.skipped
                merged.clock_err_ns = max(
                    merged.clock_err_ns, res.clock_err_ns
                )
        assert merged is not None
        # Unstamped docs rode every partition: recount their
        # negative-span tallies exactly once over the full set.
        merged.negative_spans = sum(_doc_negatives(d) for d in docs)
        merged.refused_docs = refused
        return merged
    replica_docs = [d for d in docs if d.get("kind") == "replica"]
    client_docs = [d for d in docs if d.get("kind") == "client"]
    engine_docs = [d for d in docs if d.get("kind") == "engine"]
    negative_spans = sum(_doc_negatives(d) for d in docs)
    if quorum is None:
        fs = [d["f"] for d in replica_docs if isinstance(d.get("f"), int)]
        if fs:
            quorum = max(fs) + 1
        else:
            # Old dumps without the n/f extra: MinBFT's bound is n=2f+1
            # (NOT PBFT's 3f+1), so f = (n-1)//2 for a full dump set.
            quorum = (max(len(replica_docs) - 1, 0)) // 2 + 1
    result = ClusterPaths(
        paths=[], skipped=0, quorum=quorum, clock_err_ns=0.0,
        negative_spans=negative_spans, refused_docs=refused,
    )
    if not replica_docs or not client_docs:
        return result

    alignment = clockalign.align(docs)
    result.clock_err_ns = max(
        (a.err_ns for a in alignment.values()), default=0.0
    )

    # Mean event-loop lag per crossing (the loop_lag carve), merged
    # across the replica dumps that sampled it.
    lag_hist = _merged_hist(
        d["loop_lag"] for d in replica_docs if d.get("loop_lag")
    )
    mean_lag_ns = (lag_hist.total_s / lag_hist.count * 1e9) if lag_hist.count else 0.0

    verify_ratio = _wait_ratio(engine_docs, "verify")
    sign_ratio = _wait_ratio(engine_docs, "sign")

    # Aligned per-replica event maps.
    replica_events: Dict[int, Dict[Tuple[int, int], Dict[str, float]]] = {}
    replica_err: Dict[int, float] = {}
    for d in replica_docs:
        al = alignment.get(("replica", d["id"]))
        if al is None:
            continue
        replica_err[d["id"]] = al.err_ns
        replica_events[d["id"]] = {
            key: {s: t + al.offset_ns for s, t in stages.items()}
            for key, stages in clockalign.event_times(d).items()
        }

    for cdoc in client_docs:
        al = alignment.get(("client", cdoc["id"]))
        if al is None:
            continue
        for key, cstages in clockalign.event_times(cdoc).items():
            cid, seq = key
            if cid != cdoc["id"]:
                continue
            c = {s: t + al.offset_ns for s, t in cstages.items()}
            path = _one_path(
                cid, seq, c, replica_events, replica_err, al.err_ns,
                quorum, mean_lag_ns, verify_ratio, sign_ratio,
            )
            if path is None:
                result.skipped += 1
            else:
                result.paths.append(path)
    return result


_HEAD_STAGES = ("verify_enqueue", "verify_done", "prepare")
_TAIL_STAGES = ("commit_quorum", "execute", "reply_sign", "reply_sent")


def _one_path(
    cid: int,
    seq: int,
    c: Dict[str, float],
    replica_events: Dict[int, Dict[Tuple[int, int], Dict[str, float]]],
    replica_err: Dict[int, float],
    client_err: float,
    quorum: int,
    mean_lag_ns: float,
    verify_ratio: Optional[float],
    sign_ratio: Optional[float],
) -> Optional[RequestPath]:
    t0 = c.get("start")
    t_sign = c.get("sign")
    t_bcast = c.get("broadcast")
    t_accept = c.get("quorum")
    if None in (t0, t_sign, t_bcast, t_accept):
        return None

    # Primary = the replica whose PREPARE applied first (its own PREPARE
    # rides its own-message loop, so its note IS the broadcast instant
    # up to loop latency); it must carry the whole head chain.
    primary = None
    primary_stages = None
    best_prep = None
    err = client_err
    involved_err = 0.0
    for rid, events in replica_events.items():
        stages = events.get((cid, seq))
        if not stages:
            continue
        prep = stages.get("prepare")
        if prep is None:
            continue
        if best_prep is None or prep < best_prep:
            best_prep = prep
            primary = rid
            primary_stages = stages
    if primary_stages is None:
        return None
    entry = clockalign.entry_time(primary_stages)
    if entry is None or any(s not in primary_stages for s in _HEAD_STAGES):
        return None
    involved_err = max(involved_err, replica_err.get(primary, 0.0))

    # Rank-(f+1) tail times across every replica that observed the stage.
    tail: Dict[str, float] = {}
    for stage in _TAIL_STAGES:
        vals = []
        for rid, events in replica_events.items():
            t = events.get((cid, seq), {}).get(stage)
            if t is not None:
                vals.append(t)
                involved_err = max(involved_err, replica_err.get(rid, 0.0))
        ranked = _rank(vals, quorum)
        if ranked is None:
            return None
        tail[stage] = ranked
    err += 2 * involved_err  # both directions of every cross-node hop

    def span(a: float, b: float) -> float:
        return max(b - a, 0.0)

    ingress_raw = span(t_bcast, entry)
    loop_lag = min(mean_lag_ns, ingress_raw)
    verify_span = span(primary_stages["verify_enqueue"],
                       primary_stages["verify_done"])
    sign_span = span(tail["execute"], tail["reply_sign"])
    vr = verify_ratio or 0.0
    sr = sign_ratio or 0.0
    segments = {
        "client_sign": span(t0, t_sign),
        "client_gate": span(t_sign, t_bcast),
        "ingress": ingress_raw - loop_lag,
        "loop_lag": loop_lag,
        "preverify": span(entry, primary_stages["verify_enqueue"]),
        "queue_wait": verify_span * vr + sign_span * sr,
        "verify": verify_span * (1.0 - vr),
        "prepare_wait": span(primary_stages["verify_done"],
                             primary_stages["prepare"]),
        "commit": span(primary_stages["prepare"], tail["commit_quorum"]),
        "execute": span(tail["commit_quorum"], tail["execute"]),
        "reply_sign": sign_span * (1.0 - sr),
        "reply_send": span(tail["reply_sign"], tail["reply_sent"]),
        "reply_net": span(tail["reply_sent"], t_accept),
    }
    total = span(t0, t_accept)
    if total <= 0:
        return None
    segments["unattributed"] = max(
        total - sum(segments.values()), 0.0
    )
    return RequestPath(
        cid=cid, seq=seq, total_ns=total, segments=segments,
        err_ns=err, primary=primary,
    )


def critpath_table(
    docs: Iterable[dict],
    prefix: str,
    quorum: Optional[int] = None,
    group: Optional[int] = None,
) -> dict:
    """The bench's cluster critical-path keys (the ``stage_table``
    sibling): ``{prefix}_critpath_{segment}_share`` for EVERY segment in
    :data:`SEGMENTS` (stable key set; 0.0 when a segment never fired),
    shares of the summed client-observed request time, summing to 1.0;
    plus request count, total p50, the clock-uncertainty bound, and —
    only when nonzero — the negative-span clock-sanity counter.

    ``group`` restricts the merge to one consensus group's recorders
    (multi-group runtime dumps; :func:`minbft_tpu_torch.obs.trace.filter_group`
    semantics — unstamped docs like the shared engine's stay in).

    Returns {} when the dumps yield no complete request, so a
    tracing-disabled bench emits byte-identical keys to a tracing-absent
    one (the stage_table contract)."""
    from .trace import filter_group

    res = cluster_paths(filter_group(docs, group), quorum=quorum)
    if not res.paths:
        return {}
    grand = sum(p.total_ns for p in res.paths)
    if grand <= 0:
        return {}
    out: dict = {}
    for seg in SEGMENTS:
        seg_total = sum(p.segments.get(seg, 0.0) for p in res.paths)
        out[f"{prefix}_critpath_{seg}_share"] = round(seg_total / grand, 4)
    totals = sorted(p.total_ns for p in res.paths)
    out[f"{prefix}_critpath_requests"] = len(res.paths)
    out[f"{prefix}_critpath_skipped"] = res.skipped
    out[f"{prefix}_critpath_total_p50_ms"] = round(
        totals[(len(totals) - 1) // 2] / 1e6, 3
    )
    out[f"{prefix}_critpath_clock_err_ms"] = round(res.clock_err_ns / 1e6, 3)
    if res.negative_spans:
        out[f"{prefix}_critpath_negative_spans"] = res.negative_spans
    if res.refused_docs:
        # Incarnation sanity (only-when-nonzero, like negative_spans): a
        # nonzero count means the dump set mixed restarts of one id.
        out[f"{prefix}_critpath_refused_docs"] = res.refused_docs
    return out
