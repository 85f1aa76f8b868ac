"""The port's open-loop load harness (minbft_tpu_torch/loadgen) against
the reference's (minbft_tpu/loadgen), on the CPU.

1. Byte-equality on pinned seeds: the same ``LoadSpec`` gives the same
   arrivals, ``Schedule.digest`` and census in both packages, and
   ``replay_census`` equals the reference's, for Poisson, on/off,
   grouped and mixed read/large specs; ``LoadSpec.validate`` refuses what
   the reference refuses, with the same exception type.
2. The reference's scenarios (tests/test_loadgen.py) on the port: the
   schedule's determinism and burstiness, the grouped shard routing, the
   generator's BUSY hold, latency charged from the scheduled arrival
   under an injected stall, the open-loop run over loopback TCP (census
   faithful, every request resolved), the grouped run, overload shedding,
   the thundering herd after a partition heals, and the SLO contract and
   its breach forensics.  The local cluster runs the reference's host
   crypto (``device=None``) except in the engine test, where its replicas
   share one CPU engine: every request MAC and HMAC USIG certificate is
   then one lane of the plain K6 (``report["engine"]``).
3. ``run_local_load(chips=...)`` refuses, naming ROADMAP queue 1 item 7."""

import asyncio
import dataclasses
import json
import sys
import time

import pytest

from minbft_tpu.loadgen import LoadSpec as RefLoadSpec
from minbft_tpu.loadgen import build_schedule as ref_build_schedule
from minbft_tpu.loadgen import replay_census as ref_replay_census
from minbft_tpu_torch import api
from minbft_tpu_torch.groups.router import ShardRouter
from minbft_tpu_torch.loadgen import LoadSpec, OpenLoopGenerator, build_schedule, replay_census
from minbft_tpu_torch.loadgen.harness import _Pending
from minbft_tpu_torch.loadgen.runner import run_local_load
from minbft_tpu_torch.messages import Busy, Reply, Request, marshal, split_multi, unmarshal

TIME_SCALE = 5.0 if sys.flags.dev_mode else 1.0


def _t(seconds: float) -> float:
    return seconds * TIME_SCALE


# ---------------------------------------------------------------------------
# 1. byte-equality with the reference.

SPECS = {
    "poisson": dict(seed=0xD15C, rate=500.0, duration_s=2.0, n_clients=200),
    "poisson-mix": dict(seed=0xE2E, rate=150.0, duration_s=1.0, n_clients=100,
                        read_fraction=0.1, large_fraction=0.05),
    "onoff": dict(seed=7, rate=400.0, duration_s=2.0, n_clients=50, process="onoff",
                  on_s=0.2, off_s=0.3),
    "grouped": dict(seed=3, rate=300.0, duration_s=1.0, n_clients=64, n_groups=4),
    "grouped-onoff": dict(seed=0x6B0, rate=1000.0, duration_s=1.5, n_clients=1000,
                          n_groups=16, process="onoff", read_fraction=0.5),
    "bench-probe": dict(seed=0x10AD, rate=3000.0, duration_s=1.0, n_clients=1000),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_schedule_digest_and_census_equal_the_reference(name):
    spec, ref = LoadSpec(**SPECS[name]), RefLoadSpec(**SPECS[name])
    got, want = build_schedule(spec), ref_build_schedule(ref)
    assert [dataclasses.astuple(a) for a in got.arrivals] == \
        [dataclasses.astuple(a) for a in want.arrivals]
    assert got.digest == want.digest
    assert got.census() == want.census()
    assert replay_census(spec) == ref_replay_census(ref) == got.census()


BAD_SPECS = [
    dict(seed=1, rate=0.0, duration_s=1.0),
    dict(seed=1, rate=10.0, duration_s=0.0),
    dict(seed=1, rate=10.0, duration_s=1.0, n_clients=0),
    dict(seed=1, rate=10.0, duration_s=1.0, process="lockstep"),
    dict(seed=1, rate=10.0, duration_s=1.0, read_fraction=1.5),
    dict(seed=1, rate=10.0, duration_s=1.0, large_fraction=-0.1),
    dict(seed=1, rate=10.0, duration_s=1.0, process="onoff", on_s=0.0),
    dict(seed=1, rate=10.0, duration_s=1.0, process="onoff", off_s=-1.0),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items() if k != "seed"))
def test_spec_validation_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as port:
        LoadSpec(**kw).validate()
    with pytest.raises(ValueError) as ref:
        RefLoadSpec(**kw).validate()
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError):
        build_schedule(LoadSpec(**kw))


# ---------------------------------------------------------------------------
# 2. the reference's scenarios on the port.


def test_same_seed_same_schedule():
    spec = LoadSpec(seed=0xD15C, rate=500.0, duration_s=2.0, n_clients=200,
                    read_fraction=0.2, large_fraction=0.1)
    a, b = build_schedule(spec), build_schedule(spec)
    assert a.digest == b.digest and a.arrivals == b.arrivals
    assert a.census() == b.census() == replay_census(spec)
    other = build_schedule(dataclasses.replace(spec, seed=0xD15D))
    assert other.digest != a.digest
    c = a.census()
    assert c["arrivals"] == len(a.arrivals) > 0
    assert c["reads"] + c["writes"] == c["arrivals"] == c["large"] + c["small"]


def test_onoff_schedule_is_bursty_and_grouped_schedule_routes_by_shard_router():
    spec = LoadSpec(seed=7, rate=400.0, duration_s=2.0, n_clients=50, process="onoff",
                    on_s=0.2, off_s=0.3)
    ts = [a.t_ns for a in build_schedule(spec).arrivals]
    assert ts == sorted(ts)
    cycle_ns, on_ns = int(0.5e9), int(0.2e9)
    assert all(t % cycle_ns <= on_ns for t in ts)
    assert 0.5 * 400 * 2.0 < len(ts) < 1.5 * 400 * 2.0
    spec = LoadSpec(seed=3, rate=300.0, duration_s=1.0, n_clients=64, n_groups=4)
    sched = build_schedule(spec)
    router = ShardRouter(4)
    for a in sched.arrivals:
        assert a.group == router.group_for(b"loadgen-client-%d" % a.client_idx)
    c = sched.census()
    assert sum(c.get(f"group_{g}", 0) for g in range(4)) == c["arrivals"]


def _mac_fleet(n, n_clients):
    from minbft_tpu_torch.sample.authentication import generate_testnet_keys

    store = generate_testnet_keys(n, n_clients=n_clients, usig_spec="HMAC_SHA256",
                                  with_macs=True)
    return store, [store.mac_client_authenticator(c) for c in range(n_clients)]


def test_generator_honors_busy_hold():
    async def run():
        spec = LoadSpec(seed=5, rate=10.0, duration_s=0.5, n_clients=2)
        _store, auths = _mac_fleet(1, 2)

        class _Dead:
            def replica_message_stream_handler(self, rid):
                return None

        gen = OpenLoopGenerator(spec, 1, 0, [0, 1], auths, [_Dead()], retransmit_interval=0.2)
        p = _Pending(key=(0, 1), slot=0, group=0, read=False, threshold=1, sched_s=0.0,
                     frame=b"fr", backoff=None)
        gen._pending[p.key] = p
        await gen._handle_busy(0, Busy(replica_id=0, client_id=0, seq=1, retry_after_ms=400))
        now = time.monotonic()
        assert gen._busy_received == 1
        assert now + 0.2 < p.busy_until <= now + 0.5
        held = p.busy_until
        await gen._handle_busy(0, Busy(replica_id=0, client_id=0, seq=1, retry_after_ms=1))
        assert p.busy_until == held
        await gen._handle_busy(0, Busy(replica_id=0, client_id=0, seq=1,
                                       retry_after_ms=10**9))
        assert p.busy_until <= time.monotonic() + 60.5
        await gen._handle_busy(1, Busy(replica_id=0, client_id=0, seq=1, retry_after_ms=400))
        assert gen._busy_received == 3
        return True

    assert asyncio.run(run())


class _InstantEcho:
    """A fake replica stream: every REQUEST gets an immediate matching
    (unsigned) Reply."""

    def __init__(self, rid):
        self.rid = rid

    def handle_message_stream(self, in_stream):
        return self._gen(in_stream)

    async def _gen(self, in_stream):
        async for data in in_stream:
            for fr in split_multi(data):
                try:
                    msg = unmarshal(fr)
                except Exception:
                    continue
                if isinstance(msg, Request):
                    yield marshal(Reply(replica_id=self.rid, client_id=msg.client_id,
                                        seq=msg.seq, result=b"ok"))


class _InstantEchoConn:
    def replica_message_stream_handler(self, rid):
        return _InstantEcho(rid)


def test_latency_measured_from_scheduled_arrival_under_stall():
    async def run():
        spec = LoadSpec(seed=0x57A1, rate=150.0, duration_s=1.2, n_clients=30)
        _store, auths = _mac_fleet(1, 30)
        gen = OpenLoopGenerator(spec, 1, 0, list(range(30)), auths, [_InstantEchoConn()],
                                retransmit_interval=None, drain_s=_t(10))
        asyncio.get_running_loop().call_later(0.3, time.sleep, 0.5)  # the stall
        return await gen.run()

    rep = asyncio.run(run())
    assert rep["census_ok"], rep["census"]
    assert rep["timeouts"] == 0
    assert rep["p99_ms"] >= 300.0 and rep["late_fire_max_ms"] >= 300.0, rep
    assert rep["send_p99_ms"] < rep["p99_ms"] * 0.5, rep


def test_open_loop_end_to_end_census_faithful():
    spec = LoadSpec(seed=0xE2E, rate=150.0, duration_s=1.0, n_clients=100,
                    read_fraction=0.1, large_fraction=0.05)
    rep = asyncio.run(run_local_load(spec, drain_s=_t(15), expect_goodput=20.0, device=None))
    assert rep["census_ok"], (rep["census"], replay_census(spec))
    assert rep["timeouts"] == 0
    assert rep["resolved"] == rep["fired"] == rep["arrivals"]
    assert rep["goodput_ok"], rep["goodput_per_sec"]
    assert rep["pool_connections"] == 16
    assert rep["cluster"]["committed_entries_all_replicas"] > 0
    assert rep["p50_ms"] > 0 and rep["p99_ms"] >= rep["p50_ms"]
    assert "engine" not in rep  # host crypto, as asked
    assert rep["schedule_digest"] == ref_build_schedule(RefLoadSpec(
        **dataclasses.asdict(spec))).digest


def test_open_loop_grouped_cluster():
    spec = LoadSpec(seed=0x6B0, rate=100.0, duration_s=1.0, n_clients=60, n_groups=2)
    rep = asyncio.run(run_local_load(spec, drain_s=_t(15), device=None))
    assert rep["census_ok"] and rep["timeouts"] == 0
    assert rep["census"].get("group_0", 0) > 0 and rep["census"].get("group_1", 0) > 0


def test_open_loop_run_on_a_cpu_engine_checks_every_mac_in_k6():
    """The device seam: the replicas share one engine (here on the CPU,
    the plain K6), which checks every request MAC and HMAC USIG
    certificate; the census is the seed's and nothing timed out."""
    spec = LoadSpec(seed=0xC0DE, rate=40.0, duration_s=0.5, n_clients=30, n_groups=2)
    rep = asyncio.run(run_local_load(spec, drain_s=_t(30), device="cpu"))
    assert rep["census_ok"] and rep["timeouts"] == 0, rep
    eng = rep["engine"]
    assert eng["device"] == "cpu" and set(eng["verify"]) == {"hmac_sha256"}
    q = eng["verify"]["hmac_sha256"]
    # each write: 4 REQUEST MAC slots and the PREPARE/COMMIT UIs, per replica
    assert q["items"] >= 4 * rep["census"]["writes"] and q["dispatch_timeouts"] == 0
    assert q["items"] / q["batches"] > 1  # checks coalesce across replicas and groups


def test_overload_sheds_and_keeps_committing():
    spec = LoadSpec(seed=0x0BAD, rate=4000.0, duration_s=0.5, n_clients=400)
    rep = asyncio.run(run_local_load(spec, pool_slots=1, drain_s=_t(45), device=None))
    cl = rep["cluster"]
    assert rep["census_ok"]
    assert rep["timeouts"] == 0, rep
    assert cl["admission_shed"] > 0 and cl["admission_busy_sent"] > 0
    assert rep["busy_received"] > 0
    assert cl["committed_entries_all_replicas"] > 0
    assert 0 < cl["admission_rx_peak"] <= cl["admission_rx_bound"]
    assert rep["sustained_per_sec"] > 0


def test_thundering_herd_after_partition_heal():
    from minbft_tpu_torch.core import new_replica
    from minbft_tpu_torch.sample.config import SimpleConfiger
    from minbft_tpu_torch.sample.conn.inprocess import InProcessPeerConnector, make_testnet_stubs
    from minbft_tpu_torch.sample.conn.tcp import TcpReplicaServer, connect_many_replicas_tcp
    from minbft_tpu_torch.sample.requestconsumer import SimpleLedger
    from minbft_tpu_torch.testing import FaultNet, FaultPlan, InvariantChecker, chaos_seed

    seed = chaos_seed(default=0xF100D)
    n, f, n_clients = 4, 1, 80
    spec = LoadSpec(seed=0x4E4D, rate=120.0, duration_s=1.5, n_clients=n_clients)

    async def run():
        net = FaultNet(seed=seed, default_plan=FaultPlan(
            drop=0.02, delay=0.08, delay_s=(0.0005, 0.004), duplicate=0.02, reorder=0.04))
        store, auths = _mac_fleet(n, n_clients)
        cfg = SimpleConfiger(n=n, f=f, timeout_request=_t(60.0), timeout_prepare=_t(30.0))
        stubs = make_testnet_stubs(n)
        ledgers = [SimpleLedger() for _ in range(n)]
        replicas = []
        for i in range(n):
            r = new_replica(i, cfg, store.mac_replica_authenticator(i),
                            net.wrap(InProcessPeerConnector(stubs), f"r{i}"), ledgers[i])
            stubs[i].assign_replica(r)
            replicas.append(r)
        servers, addrs, connectors = [], {}, []
        try:
            for r in replicas:
                await r.start()
            for i in range(n):
                srv = TcpReplicaServer(stubs[i])
                servers.append(srv)
                addrs[i] = await srv.start("127.0.0.1:0")
            connectors = [connect_many_replicas_tcp(addrs, kind="client") for _ in range(2)]
            gen = OpenLoopGenerator(spec, n, f, list(range(n_clients)), auths, connectors,
                                    retransmit_interval=_t(0.4), drain_s=_t(30))

            async def herd():
                await asyncio.sleep(0.4)
                net.partition({"r0"}, {"r1", "r2", "r3"})
                await asyncio.sleep(0.6)
                net.heal_partition()
                net.reset_all()

            herd_task = asyncio.ensure_future(herd())
            rep = await gen.run()
            await herd_task
            assert rep["census_ok"], rep["census"]
            assert rep["timeouts"] == 0, rep
            assert rep["resolved"] == rep["arrivals"]
            assert net.census.counters.get("partition", 0) >= 1
            assert net.census.counters.get("reset_all", 0) >= 1
            assert net.replay_counts() == net.census.seeded_counts()
            writes = rep["census"]["writes"]
            deadline = asyncio.get_running_loop().time() + _t(30)
            while asyncio.get_running_loop().time() < deadline:
                if all(lg.length >= writes for lg in ledgers):
                    break
                await asyncio.sleep(0.05)
            assert all(lg.length >= writes for lg in ledgers), [lg.length for lg in ledgers]
            InvariantChecker(replicas, ledgers).check()
            return True
        finally:
            for conn in connectors:
                try:
                    await conn.close()
                except Exception:
                    pass
            for srv in servers:
                await srv.stop()
            for r in replicas:
                await r.stop()

    try:
        assert asyncio.run(run())
    except BaseException:
        print(f"replay with MINBFT_CHAOS_SEED={seed}")
        raise


def test_report_carries_slo_surface():
    async def run(target_ms):
        spec = LoadSpec(seed=0x510, rate=100.0, duration_s=0.8, n_clients=20)
        _store, auths = _mac_fleet(1, 20)
        gen = OpenLoopGenerator(spec, 1, 0, list(range(20)), auths, [_InstantEchoConn()],
                                retransmit_interval=None, drain_s=_t(10),
                                slo_target_ms=target_ms)
        return await gen.run(), gen

    rep, gen = asyncio.run(run(60_000.0))
    assert rep["census_ok"] and rep["timeouts"] == 0
    assert rep["slo_target_ms"] == 60_000.0 and rep["slo_good_fraction"] == 1.0
    assert rep["finality_p99_ms"] == pytest.approx(rep["p99_ms"], rel=1e-6)
    rep2, gen2 = asyncio.run(run(1e-6))
    assert rep2["census_ok"] and rep2["slo_good_fraction"] == 0.0
    doc = gen.sched_doc()
    assert doc["kind"] == "loadgen" and len(doc["sched_lat_ns"]) == rep["resolved"]
    assert all(ns > 0 for ns in doc["sched_lat_ns"].values())
    from minbft_tpu_torch.obs.slo import SLOPolicy, burn_rates

    b = burn_rates(gen2.slo_ring(), SLOPolicy(target_ms=1e-6), now=time.time() + 2.0,
                   group=None)
    assert b["slow_breached_per_sec"] > 0 and b["slow_good_per_sec"] == 0.0


def test_run_local_load_slo_contract_and_breach_forensics(tmp_path, monkeypatch):
    monkeypatch.setenv("MINBFT_TRACE", "1")
    monkeypatch.setenv("MINBFT_SLO_DUMP", str(tmp_path))
    spec = LoadSpec(seed=0x510E, rate=120.0, duration_s=1.0, n_clients=60)
    rep = asyncio.run(run_local_load(spec, drain_s=_t(15), slo_target_ms=1e-6, device=None))
    assert rep["census_ok"] and rep["slo_good_fraction"] == 0.0
    assert rep["slo_ok"] is False and 0 < rep["slo_objective"] <= 1.0
    bundles = sorted(tmp_path.glob("slo_breach.*.json"))
    assert len(bundles) == 1, bundles
    assert rep["slo_breach_bundle"] == str(bundles[0])
    doc = json.load(open(bundles[0]))
    assert doc["kind"] == "slo_breach" and doc["policy"]["target_ms"] == 1e-6
    breach = doc["breach"]
    assert breach["origin"] == "scheduled" and breach["breached"] > 0
    assert sum(breach["attribution_ms"].values()) == pytest.approx(
        breach["breached_spend_ms"], abs=0.01)
    assert "sched_wait" in breach["attribution_ms"] and doc["ledgers"]
    spec2 = LoadSpec(seed=0x510F, rate=80.0, duration_s=0.8, n_clients=40)
    rep2 = asyncio.run(run_local_load(spec2, drain_s=_t(15), slo_target_ms=60_000.0,
                                      device=None))
    assert rep2["slo_ok"] is True and rep2["slo_good_fraction"] == 1.0
    assert "slo_breach_bundle" not in rep2
    assert len(sorted(tmp_path.glob("slo_breach.*.json"))) == 1


# ---------------------------------------------------------------------------
# 3. what waits for the engine pool.


def test_run_local_load_refuses_chips_naming_item_7():
    spec = LoadSpec(seed=1, rate=10.0, duration_s=0.1, n_clients=2)
    for chips in (1, 2):
        with pytest.raises(api.NotPortedError, match="item 7"):
            asyncio.run(run_local_load(spec, chips=chips, device=None))
