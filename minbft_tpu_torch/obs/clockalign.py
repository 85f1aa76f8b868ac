"""NTP-free pairwise clock-offset estimation from trace dumps.

Every flight-recorder dump timestamps with its OWN process's
``time.monotonic_ns()`` — two processes' clocks share neither epoch nor
offset, so merging dumps into one causal timeline (obs/critpath.py)
needs the pairwise offsets first.  The protocol itself provides the
probe traffic: every request is a client→replica message (``broadcast``
noted on the client, ``ingest``/``recv`` on the replica) and every reply
a replica→client message (``reply_sent`` on the replica, ``quorum`` on
the client), all keyed by the same ``(client_id, seq)`` pair — matched
send/recv span pairs with no wire change and no extra traffic.

Estimation is Cristian-style over the matched pairs.  Writing ``o`` for
the replica clock minus the client clock (so ``t_replica = t_client +
o`` for a simultaneous instant):

- a client→replica pair gives ``d1 = t_recv - t_send = o + delay >= o``
  — every forward pair UPPER-bounds the offset, and the minimum over
  many pairs (min-RTT filtering: queueing inflates d1, never deflates
  it) is the tightest bound ``U = min d1``;
- a replica→client pair gives ``d2 = t_recv - t_send = -o + delay``
  — a LOWER bound ``L = -min d2``.

The estimate is the interval midpoint ``(U + L) / 2`` with uncertainty
``(U - L) / 2`` — half the best observed round-trip residual, the
classical Cristian bound.  The uncertainty is carried into the merged
timeline: a cross-node segment can never honestly be reported tighter
than it.

Caveats (documented, deliberate):

- The client's ``quorum`` note fires when the f+1-th MATCHING reply
  arrives; for a replica whose reply arrived after the quorum formed,
  ``d2`` under-measures and can violate the bound.  ``min d2`` can
  therefore be contaminated by up to ``n - (f+1)`` late repliers; when
  the bounds cross (``L > U``) the estimate keeps the midpoint and
  reports ``|U - L| / 2`` as the uncertainty — inconsistent bounds are
  a confidence signal, not a crash.
- Clock DRIFT over a long run widens the residual; the estimator is a
  single static offset per pair, which is the right model for the
  minutes-long traced bench passes it serves.

Replica↔replica offsets are derived through a client hub: replicas only
exchange PREPARE/COMMIT traffic whose capture points (prepare, commit
quorum) are aggregate events, not matched unicast pairs — the client's
REQUEST/REPLY pairs are the clean probes.  ``align`` picks the hub with
the smallest combined uncertainty per replica.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

# Dump-doc stage names (obs/trace.py REPLICA_STAGES / CLIENT_STAGES).
_ENTRY_STAGES = ("ingest", "recv")


@dataclasses.dataclass(frozen=True)
class PairEstimate:
    """Offset of a replica clock RELATIVE to a client clock:
    ``t_replica ≈ t_client + offset_ns ± err_ns``."""

    offset_ns: float
    err_ns: float
    forward_pairs: int
    backward_pairs: int
    min_rtt_ns: float  # best observed round-trip residual (U - L)
    consistent: bool  # False when the bounds crossed (see module doc)


@dataclasses.dataclass(frozen=True)
class ClockAlignment:
    """Mapping of one recorder's clock onto the reference timeline:
    ``t_ref ≈ t_local + offset_ns ± err_ns``."""

    offset_ns: float
    err_ns: float


def event_times(doc: dict) -> Dict[Tuple[int, int], Dict[str, int]]:
    """``(client_id, seq) -> {stage_name: first_noted_t_ns}`` for one
    dump doc.  FIRST occurrence wins: retransmissions re-note entry
    stages, and the causal timeline wants the original arrival."""
    stages = doc.get("stages") or ()
    out: Dict[Tuple[int, int], Dict[str, int]] = {}
    for row in doc.get("events") or ():
        try:
            cid, seq, stage_idx, t_ns = row
            name = stages[stage_idx]
        except (ValueError, IndexError, TypeError):
            continue
        per_req = out.setdefault((int(cid), int(seq)), {})
        if name not in per_req:
            per_req[name] = int(t_ns)
    return out


def entry_time(stages: Dict[str, int]) -> Optional[int]:
    ts = [stages[s] for s in _ENTRY_STAGES if s in stages]
    return min(ts) if ts else None


def estimate_pair(client_doc: dict, replica_doc: dict) -> Optional[PairEstimate]:
    """Cristian-style offset of ``replica_doc``'s clock relative to
    ``client_doc``'s, from their matched (client_id, seq) span pairs.
    None when either direction has no matched pair."""
    ce = event_times(client_doc)
    re_ = event_times(replica_doc)
    d1s: List[int] = []
    d2s: List[int] = []
    for key, cstages in ce.items():
        rstages = re_.get(key)
        if not rstages:
            continue
        send = cstages.get("broadcast")
        entry = entry_time(rstages)
        if send is not None and entry is not None:
            d1s.append(entry - send)
        rsent = rstages.get("reply_sent")
        crecv = cstages.get("quorum")
        if rsent is not None and crecv is not None:
            d2s.append(crecv - rsent)
    if not d1s or not d2s:
        return None
    upper = min(d1s)
    lower = -min(d2s)
    offset = (upper + lower) / 2.0
    err = (upper - lower) / 2.0
    return PairEstimate(
        offset_ns=offset,
        err_ns=abs(err),
        forward_pairs=len(d1s),
        backward_pairs=len(d2s),
        min_rtt_ns=float(upper - lower),
        consistent=upper >= lower,
    )


def align(docs: Iterable[dict]) -> Dict[Tuple[str, int], ClockAlignment]:
    """Map every replica/client dump onto ONE reference timeline.

    Reference clock: the lowest-id replica dump (falling back to the
    lowest-id client when no replica dumped).

    Dumps stamped with the SAME ``clock_domain`` (obs/trace.py: the
    host, because ``time.monotonic`` is the system-wide boot-relative
    CLOCK_MONOTONIC) literally share a clock — they align with offset 0
    and uncertainty 0, EXACTLY.  Estimation is reserved for genuinely
    cross-domain dumps: Cristian's asymmetric-delay bias (a loaded
    ingress path makes the forward bound loose) would otherwise smear
    co-resident recorders apart by hundreds of milliseconds of honest
    but needless uncertainty.

    Cross-domain clients align to the reference directly through their
    own pair estimate; cross-domain replicas align through the client
    hub whose combined uncertainty is smallest (a hub sharing the
    replica's domain contributes zero extra error; estimation errors
    add through the hub — carried, never dropped).

    Returns ``{(kind, id): ClockAlignment}`` — only for docs that could
    be aligned (the reference itself maps with offset 0, err 0).
    Unalignable docs are simply absent; callers skip them.
    """
    docs = list(docs)
    replicas = {d["id"]: d for d in docs if d.get("kind") == "replica"}
    clients = {d["id"]: d for d in docs if d.get("kind") == "client"}
    out: Dict[Tuple[str, int], ClockAlignment] = {}
    if not replicas:
        # Replica-less dumps (client-only traces): nothing to cross-align
        # — every client keeps its own clock as a local reference.
        for cid in clients:
            out[("client", cid)] = ClockAlignment(0.0, 0.0)
        return out
    ref_id = min(replicas)
    ref_doc = replicas[ref_id]
    ref_dom = ref_doc.get("clock_domain")
    out[("replica", ref_id)] = ClockAlignment(0.0, 0.0)

    def shares_ref_domain(doc: dict) -> bool:
        d = doc.get("clock_domain")
        return d is not None and d == ref_dom

    # Clients: t_ref = t_client + o(ref, client).
    client_align: Dict[int, ClockAlignment] = {}
    for cid, cdoc in clients.items():
        if shares_ref_domain(cdoc):
            al = ClockAlignment(0.0, 0.0)
        else:
            est = estimate_pair(cdoc, ref_doc)
            if est is None:
                continue
            al = ClockAlignment(est.offset_ns, est.err_ns)
        client_align[cid] = al
        out[("client", cid)] = al
    # Other replicas, through the best client hub:
    # t_ref = t_r - o(r, hub) + o(ref, hub).
    for rid, rdoc in replicas.items():
        if rid == ref_id:
            continue
        if shares_ref_domain(rdoc):
            out[("replica", rid)] = ClockAlignment(0.0, 0.0)
            continue
        rdom = rdoc.get("clock_domain")
        best: Optional[ClockAlignment] = None
        for cid, cal in client_align.items():
            cdom = clients[cid].get("clock_domain")
            if cdom is not None and cdom == rdom:
                # Hub and replica share a clock: o(r, hub) == 0 exactly.
                cand = cal
            else:
                est = estimate_pair(clients[cid], rdoc)
                if est is None:
                    continue
                cand = ClockAlignment(
                    offset_ns=cal.offset_ns - est.offset_ns,
                    err_ns=cal.err_ns + est.err_ns,
                )
            if best is None or cand.err_ns < best.err_ns:
                best = cand
        if best is not None:
            out[("replica", rid)] = best
    return out
