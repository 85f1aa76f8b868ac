"""Local-cluster load runs (counterpart of :mod:`minbft_tpu.loadgen.runner`):
one entry point shared by ``peer load``, the port bench's ``load``
section, ``chip_smoke.py`` and the tests.

Stands up an in-process n-replica cluster whose CLIENT traffic rides
REAL loopback TCP (``TcpReplicaServer`` in front of each replica;
replica-to-replica stays in-process — the measurement target is the
client-facing ingest/admission path, not peer gossip), builds the
identity fleet, drives an :class:`~.harness.OpenLoopGenerator`, and
returns the merged report: generator-side curve point plus cluster-side
commit/shed/queue-high-water accounting.

The device seam: the reference's default run keeps every MAC and USIG
certificate on the host.  Here the n replicas share one
:class:`~minbft_tpu_torch.parallel.BatchVerifier` on ``device``
(``cuda:0`` unless the caller passes another, or ``None`` for the
reference's host crypto), so every request MAC and HMAC USIG certificate
a replica checks is one lane of K6 and, under ``scheme="ecdsa-p256"``,
every request signature one lane of K2 (REPLY signatures: K3).  The
generator's identities sign their requests on the host before the clock
starts, as in the reference.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .arrivals import LoadSpec
from .harness import OpenLoopGenerator

_USIG_SPEC = "HMAC_SHA256"  # cheapest USIG: the load path is the target


def _replica_auth(store, rid: int, engine=None):
    if store.mac_keys:
        return store.mac_replica_authenticator(rid, engine=engine)
    return store.replica_authenticator(rid, engine=engine)


def _client_auth(store, cid: int):
    if store.mac_keys:
        return store.mac_client_authenticator(cid)
    return store.client_authenticator(cid)


async def _warmup(spec: LoadSpec, n: int, f: int, store, addrs) -> None:
    """One committed write per group through a throwaway closed-loop
    client, over the same TCP path the generator will use."""
    from ..client import new_client
    from ..sample.conn.tcp import connect_many_replicas_tcp

    warm_cid = spec.n_clients  # the extra identity past the fleet
    conn = connect_many_replicas_tcp(addrs, kind="client")
    warm_auth = _client_auth(store, warm_cid)
    if spec.n_groups > 1:
        from ..groups import MultiGroupClient

        client = MultiGroupClient(
            warm_cid, n, f, spec.n_groups, warm_auth, conn
        )
        await client.start()
        try:
            for g in range(spec.n_groups):
                await asyncio.wait_for(
                    client.request(b"loadgen-warmup", group=g), 120
                )
        finally:
            await client.stop()
    else:
        client = new_client(warm_cid, n, f, warm_auth, conn)
        await client.start()
        try:
            await asyncio.wait_for(client.request(b"loadgen-warmup"), 120)
        finally:
            await client.stop()
            await conn.close()


async def run_local_load(
    spec: LoadSpec,
    n: int = 4,
    f: int = 1,
    pool_slots: int = 4,
    retransmit_interval: Optional[float] = 0.5,
    drain_s: float = 5.0,
    verify_replies: bool = False,
    batchsize_prepare: int = 64,
    expect_goodput: float = 0.0,
    scheme: str = "mac",
    chips: Optional[int] = None,
    slo_target_ms: Optional[float] = None,
    slo_objective: Optional[float] = None,
    device: Optional[str] = "cuda:0",
) -> dict:
    """Run ``spec`` against a fresh local cluster; returns the report.

    ``pool_slots`` bounds the client-side connection pool: slots × n real
    TCP connections total, however many thousand identities ride them.
    ``expect_goodput`` (req/s) stamps ``goodput_ok`` into the report —
    the ``peer load`` / CI rc contract.  ``scheme`` defaults to pairwise
    MACs: the harness measures the ingest/admission/consensus path, and
    on an OpenSSL-less container pure-Python ECDSA (~10ms/verify) would
    turn every run into a host-crypto benchmark; pass ``ecdsa-p256`` to
    include public-key request auth in the measurement.

    ``device`` places the one engine the n replicas share (module
    docstring), with one bucket of 512 lanes: ``cuda:0`` by
    default, ``"cpu"`` for the kernels' plain PyTorch versions, ``None``
    for host crypto (only when the caller asks for it).  CUDA asked for
    and absent raises ``RuntimeError``.  The report's ``engine`` holds
    the engine's device, per-queue items, batches and dispatch timeouts,
    and the kernel launches of the process.  ``chips`` (the reference's
    multi-device engine pool) is not ported: any value but ``None``
    raises :class:`~minbft_tpu_torch.api.NotPortedError`.

    ``slo_target_ms`` stamps ``slo_ok`` (good_fraction >= objective)
    into the report — the optional third leg of the ``peer load`` rc
    contract; ``slo_objective`` defaults to the env/config-resolved
    :class:`~minbft_tpu_torch.obs.slo.SLOPolicy` objective (0.99).  When
    ``MINBFT_SLO_DUMP`` names a spool directory, a run that breached
    its objective hands ONE rate-limited forensic bundle (replica
    flight-recorder docs, scheduled-origin loadgen metadata, burn
    rates replayed from the run) to the breach spool.
    """
    from ..core import new_replica
    from ..groups import GroupAuthenticator, new_group_runtime
    from ..sample.authentication import generate_testnet_keys
    from ..sample.config import SimpleConfiger
    from ..sample.conn.inprocess import (
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from ..sample.conn.tcp import TcpReplicaServer, connect_many_replicas_tcp
    from ..sample.requestconsumer import SimpleLedger

    spec.validate()
    if chips is not None:
        from ..api import NotPortedError

        raise NotPortedError(f"run_local_load(chips={chips}) (parallel/pool.py)", "7")
    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)
    if scheme not in ("mac", "ecdsa-p256"):
        raise ValueError(f"unknown auth scheme {scheme!r}")
    # +1 identity: the warmup client needs its own sequence space (the
    # generator pre-assigns seqs for ids 0..n_clients-1).
    store = generate_testnet_keys(
        n,
        n_clients=spec.n_clients + 1,
        usig_spec=_USIG_SPEC,
        with_macs=scheme == "mac",
    )
    cfg = SimpleConfiger(
        n=n,
        f=f,
        # Steady-state measurement: an overloaded-but-shedding replica
        # must not detonate a view-change cascade mid-run (the bench
        # convention; see bench.py _bench_cluster).
        timeout_request=900.0,
        timeout_prepare=450.0,
        batchsize_prepare=batchsize_prepare,
        groups=spec.n_groups,
    )
    engine = None
    if device is not None:
        from ..parallel import BatchVerifier

        # One engine for the n replicas, one bucket (the bench's
        # in-process layout); on the CPU its sign queue runs the plain
        # k*G too.
        engine = BatchVerifier(
            max_batch=512,
            buckets=(512,),
            device=device,
            sign_on_device=True if str(device) == "cpu" else None,
        )
    stubs = make_testnet_stubs(n)
    grouped = spec.n_groups > 1
    ledgers: list = []
    replicas = []
    servers = []
    for i in range(n):
        if grouped:
            group_ledgers = [SimpleLedger() for _ in range(spec.n_groups)]
            ledgers.append(group_ledgers)
            r = new_group_runtime(
                i,
                cfg,
                [_replica_auth(store, i, engine) for _ in range(spec.n_groups)],
                InProcessPeerConnector(stubs),
                group_ledgers,
            )
        else:
            ledger = SimpleLedger()
            ledgers.append(ledger)
            r = new_replica(
                i,
                cfg,
                _replica_auth(store, i, engine),
                InProcessPeerConnector(stubs),
                ledger,
            )
        stubs[i].assign_replica(r)
        replicas.append(r)
    gen = None
    connectors = []
    try:
        for r in replicas:
            await r.start()
        addrs = {}
        for i, r in enumerate(replicas):
            srv = TcpReplicaServer(r)
            servers.append(srv)
            addrs[i] = await srv.start("127.0.0.1:0")

        # Warmup OFF the clock (the bench convention): first-use costs —
        # USIG/crypto warm paths, the first PREPARE/COMMIT round, stream
        # setup — otherwise land as a multi-second stall INSIDE the
        # schedule and starve the firing loop (everything shares one
        # event loop here).
        await _warmup(spec, n, f, store, addrs)

        client_ids = list(range(spec.n_clients))
        schedule = None
        if grouped:
            # Client affinity: each identity signs in ITS group's domain
            # (GroupAuthenticator — matches the group core that will
            # verify it); the schedule knows each client's group.
            from .arrivals import build_schedule

            schedule = build_schedule(spec)
            group_of = {}
            for a in schedule.arrivals:
                group_of.setdefault(a.client_idx, a.group)
            authenticators = [
                GroupAuthenticator(
                    _client_auth(store, cid), group_of.get(cid, 0)
                )
                for cid in client_ids
            ]
        else:
            authenticators = [
                _client_auth(store, cid) for cid in client_ids
            ]
        connectors = [
            connect_many_replicas_tcp(addrs, kind="client")
            for _ in range(max(pool_slots, 1))
        ]
        gen = OpenLoopGenerator(
            spec,
            n,
            f,
            client_ids,
            authenticators,
            connectors,
            retransmit_interval=retransmit_interval,
            drain_s=drain_s,
            verify_replies=verify_replies,
            schedule=schedule,
            slo_target_ms=slo_target_ms,
        )
        report = await gen.run()
        # Breach forensics BEFORE teardown: the bundle reads the live
        # replicas' flight recorders and SLO ledgers.
        _slo_forensics(report, gen, replicas, grouped, f, slo_objective)
    finally:
        for srv in servers:
            try:
                await srv.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        for r in replicas:
            try:
                await r.stop()
            except Exception:  # noqa: BLE001
                pass

    # Cluster-side accounting: committed entries, admission visibility,
    # queue high-water marks (the bounded-growth witness).
    committed = 0
    shed = busy_sent = suppressed = 0
    rx_peak = 0
    rx_bound = 0
    for i in range(n):
        if grouped:
            metrics_list = [core.metrics for core in replicas[i].cores]
            committed += max(lg.length for lg in ledgers[i])
        else:
            metrics_list = [replicas[i].metrics]
            committed += ledgers[i].length
        for m in metrics_list:
            shed += m.counters.get("admission_shed", 0)
            busy_sent += m.counters.get("admission_busy_sent", 0)
            suppressed += m.counters.get("admission_busy_suppressed", 0)
            rx_peak = max(rx_peak, getattr(m, "admission_rx_peak", 0))
            rx_bound = max(rx_bound, getattr(m, "admission_rx_bound", 0))
    arrivals = max(report.get("arrivals", 0), 1)
    report["cluster"] = {
        "n": n,
        "f": f,
        # One engine (no pool in the port yet).
        "chips": 1,
        "committed_entries_all_replicas": committed,
        "admission_shed": shed,
        "admission_busy_sent": busy_sent,
        "admission_busy_suppressed": suppressed,
        "admission_rx_peak": rx_peak,
        "admission_rx_bound": rx_bound,
        # Shed rate against offered arrivals (sheds can exceed arrivals
        # under retransmission, so this is a rate, not a fraction of 1).
        "shed_per_arrival": round(shed / arrivals, 3),
    }
    if engine is not None:
        from ..sample.peer.cli import engine_report

        report["engine"] = engine_report(engine)
    if expect_goodput > 0:
        report["expect_goodput_per_sec"] = expect_goodput
        report["goodput_ok"] = report["goodput_per_sec"] >= expect_goodput
    if slo_target_ms is not None:
        from ..obs.slo import SLOPolicy

        if slo_objective is None:
            slo_objective = SLOPolicy.from_env().objective
        report["slo_objective"] = slo_objective
        report["slo_ok"] = report["slo_good_fraction"] >= slo_objective
    return report


def _slo_forensics(
    report: dict,
    gen: OpenLoopGenerator,
    replicas,
    grouped: bool,
    f: int,
    slo_objective: Optional[float] = None,
) -> None:
    """Hand the breach spool one bundle when the run breached and
    ``MINBFT_SLO_DUMP`` asked for forensics.  The burn rates come from
    replaying the run's scheduled-origin classifications into a ring
    (:meth:`OpenLoopGenerator.slo_ring`); the trace docs come from the
    live replicas' flight recorders (empty unless ``MINBFT_TRACE`` was
    also on); the scheduled-origin loadgen metadata doc rides along so
    :func:`~minbft_tpu_torch.obs.slo.breach_report` classifies at the
    coordinated-omission-honest origin.  The policy is the RUN's: the
    generator's effective target (a ``slo_target_ms`` argument beats the
    env) and the caller's objective when given — the bundle must explain
    the breach that was actually declared, not the env default's."""
    import dataclasses

    from ..obs import slo as obs_slo

    spool = obs_slo.BreachSpool.from_env()
    if spool is None:
        return
    policy = obs_slo.SLOPolicy.from_env()
    policy = dataclasses.replace(
        policy,
        target_ms=gen._slo_target_ms,
        objective=(
            slo_objective if slo_objective is not None else policy.objective
        ),
    )
    if report["slo_good_fraction"] >= policy.objective:
        return
    ts = gen.slo_ring()
    burn = obs_slo.burn_rates(ts, policy)
    recorders = []
    ledgers = []
    for r in replicas:
        cores = r.cores if grouped else [r]
        for core in cores:
            h = core.handlers
            if getattr(h, "trace", None) is not None:
                recorders.append(h.trace)
            if getattr(h, "slo", None) is not None:
                ledgers.append(h.slo)
    bundle = obs_slo.build_bundle(
        policy,
        burn,
        ledgers,
        recorders=recorders,
        timeseries=ts,
        quorum=f + 1,
        extra_docs=[gen.sched_doc()],
    )
    path = spool.maybe_dump(bundle)
    report["slo_breach_bundle"] = path
    report["slo_breach_suppressed"] = spool.suppressed
