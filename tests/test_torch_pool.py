"""The port's engine pool (minbft_tpu_torch/parallel/pool.py) on lists of
CPU devices, held against the reference's pool
(minbft_tpu/parallel/pool.py) on its 8 virtual JAX CPU devices.

Counterparts of tests/test_pool.py's cases (placement, clamping,
rebalance safety, the C = 1 identity, per-chip coalescing, striping, the
pool ledger, chip liveness and the prom surface; the reference's
``test_host_many_never_stripes`` has none, as the port has no host
queues), then: the same operation sequences through both packages' pools
giving equal placements and rebalance decisions, the rendered
``collect_engine_pool`` exposition of an idle C = 2 pool against the
reference's, ``chip_up`` after a hung dispatcher timed out on every
queue, ``bind_engine``, the dry run on ``["cpu"] * 2`` and a mixed grouped
cluster (2 port replicas on C = 2 pools, 2 reference replicas) whose
per-group ledgers are equal.  Every comparison is exact."""

import asyncio
import hashlib
import hmac as hmac_mod
import random
import threading

import jax
import numpy as np
import pytest

from minbft_tpu.groups import GroupRuntime as RefGroupRuntime
from minbft_tpu.obs.prom import collect_engine_pool as ref_collect_engine_pool
from minbft_tpu.obs.prom import render_families as ref_render_families
from minbft_tpu.parallel import EnginePool as RefEnginePool
from minbft_tpu.sample.authentication.mac import MacAuthenticator as RefMacAuthenticator
from minbft_tpu.sample.requestconsumer import SimpleLedger as RefLedger
from minbft_tpu_torch.groups import GroupRuntime, MultiGroupClient, group_for_key
from minbft_tpu_torch.obs import prom
from minbft_tpu_torch.obs.ledger import DeviceLedger, PoolLedger
from minbft_tpu_torch.parallel import BatchVerifier, EnginePool
from minbft_tpu_torch.parallel.dryrun import dryrun_multichip
from minbft_tpu_torch.sample.authentication import (
    MacAuthenticator,
    mac_authenticators_from_keys,
    mac_keys_from,
    new_test_mac_authenticators,
)
from minbft_tpu_torch.sample.authentication.authenticator import make_test_keys
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.sample.conn.inprocess import (
    InProcessClientConnector,
    InProcessPeerConnector,
    make_testnet_stubs,
)
from minbft_tpu_torch.sample.requestconsumer import SimpleLedger
from minbft_tpu_torch.utils import hostcrypto as hc
from test_torch_mac import _ref_mac_keys
from test_torch_slice import _SeededRng, _reference_authenticators


def _devs(k):
    return ["cpu"] * k


def _hmac_item(i: int, valid: bool = True):
    key = hashlib.sha256(b"pool-key-%d" % i).digest()
    msg = hashlib.sha256(b"pool-msg-%d" % i).digest()
    mac = hmac_mod.new(key, msg, hashlib.sha256).digest()
    if not valid:
        mac = bytes([mac[0] ^ 1]) + mac[1:]
    return key, msg, mac


# -- placement invariants ----------------------------------------------------


def test_placement_is_round_robin_and_unique():
    pool = EnginePool(chips=4, devices=_devs(4), max_batch=8)
    for g in range(12):
        assert pool.home_chip(g) == g % 4
    assert len(pool.placement()) == 12
    assert pool.home_chip(5) == 1  # repeated lookups never re-place
    assert pool.engine_for(3) is pool.engine_for(3)
    assert [str(e.device) for e in pool.engines] == ["cpu"] * 4
    assert pool.striped_engine.mesh.size == 4 and pool.stripe_threshold == 8


def test_chips_clamp_to_the_device_list():
    pool = EnginePool(chips=64, devices=_devs(3), max_batch=8)
    assert pool.requested_chips == 64 and pool.chips == 3
    with pytest.raises(ValueError):
        EnginePool(chips=0)
    with pytest.raises(ValueError):
        EnginePool(chips=2, mesh=object())
    with pytest.raises(ValueError):
        EnginePool(chips=2, device="cpu")
    # No list: every visible CUDA device, none here, so one engine on the
    # default device, which is CUDA: refused, never a quiet CPU engine.
    with pytest.raises(RuntimeError, match="cuda"):
        EnginePool(chips=64, max_batch=8)


def test_rebalance_never_migrates_a_group_with_inflight_dispatches():
    async def scenario():
        pool = EnginePool(chips=2, devices=_devs(2), max_batch=8, max_delay=0.01)
        f0 = pool.engine_for(0)  # home chip 0
        pool.engine_for(1)  # home chip 1
        pool.engine_for(2)  # home chip 0 (the idle migration candidate)
        release = threading.Event()

        def slow_dispatch(items):
            release.wait(30)
            return np.ones(len(items), dtype=bool)

        pool.engines[0]._queue("hmac_sha256", slow_dispatch)
        task = asyncio.create_task(f0.verify_hmac_sha256(*_hmac_item(0)))
        await asyncio.sleep(0.05)
        assert pool.group_inflight(0) == 1
        assert pool.rebalance(scores=[1.0, 0.0]) == {2: (0, 1)}
        assert pool.home_chip(0) == 0
        assert pool.rebalance(scores=[1.0, 0.0]) == {}
        release.set()
        assert await asyncio.wait_for(task, 10) is True
        assert pool.group_inflight(0) == 0
        assert pool.rebalance(scores=[1.0, 0.0]) == {0: (0, 1)}

    asyncio.run(scenario())


def test_rebalance_noop_cases():
    pool = EnginePool(chips=2, devices=_devs(2), max_batch=8)
    pool.engine_for(0)
    assert pool.rebalance(scores=[0.5, 0.5]) == {}
    assert EnginePool(chips=1, devices=["cpu"]).rebalance() == {}
    with pytest.raises(ValueError):
        pool.rebalance(scores=[1.0])


def test_placement_and_rebalance_decisions_equal_the_reference_pool():
    """One seeded sequence of touches and score vectors through both
    packages' pools: equal placements after every step and equal moves."""
    rng = random.Random(0x9001)
    for chips in (2, 3, 4):
        port = EnginePool(chips=chips, devices=_devs(chips), max_batch=8)
        ref = RefEnginePool(chips=chips, devices=jax.devices("cpu")[:chips], max_batch=8)
        for _ in range(40):
            if rng.random() < 0.5:
                g = rng.randrange(16)
                assert port.engine_for(g).group == ref.engine_for(g).group
                assert port.home_chip(g) == ref.home_chip(g)
            else:
                scores = [round(rng.random(), 2) for _ in range(chips)]
                gap = rng.choice([0.0, 0.25, 0.5])
                assert port.rebalance(scores, min_gap=gap) == ref.rebalance(scores, min_gap=gap)
            assert port.placement() == ref.placement()
            assert [port.groups_on(c) for c in range(chips)] == [
                ref.groups_on(c) for c in range(chips)]


# -- C = 1 identity ------------------------------------------------------------


def _drive_mixed(eng, seed: int):
    """tests/test_pool.py's deterministic load: mixed verdicts, in-round
    duplicates, cross-round repeats and rounds wider than max_batch,
    each round gathered before the next (``max_delay=0``)."""

    async def run():
        rng = random.Random(seed)
        valid = {i: rng.random() < 0.7 for i in range(40)}
        results = []
        for _ in range(8):
            idxs = [rng.randrange(40) for _ in range(12)]
            tasks = [asyncio.create_task(eng.verify_hmac_sha256(*_hmac_item(i, valid[i])))
                     for i in idxs]
            results.extend(await asyncio.gather(*tasks))
        return results

    return asyncio.run(run())


def test_c1_pool_is_byte_identical_to_the_bare_engine():
    kwargs = dict(max_batch=8, max_delay=0.0)
    bare = BatchVerifier(device="cpu", **kwargs)
    pool = EnginePool(chips=1, devices=["cpu"], **kwargs)
    fac = pool.engine_for(0)
    assert len(pool.engines) == 1 and pool.striped_engine is None
    assert pool.engines[0].buckets == bare.buckets
    assert _drive_mixed(bare, seed=0xC1) == _drive_mixed(fac, seed=0xC1)
    sb = bare.stats["hmac_sha256"]
    sp = pool.engines[0].stats["hmac_sha256"]
    for field in ("items", "batches", "max_batch_seen", "padded_lanes", "memo_hits",
                  "dispatch_timeouts", "flush_reasons", "occupancy"):
        assert getattr(sb, field) == getattr(sp, field), field
    assert set(pool.stats) == set(bare.stats)
    assert set(pool.queue_depths()) == set(bare.queue_depths())
    assert fac.stats["hmac_sha256"] is sp


# -- per-chip coalescing and striping ------------------------------------------


def test_two_groups_on_the_same_home_chip_coalesce_into_one_flush():
    async def run():
        pool = EnginePool(chips=2, devices=_devs(2), max_batch=8, max_delay=10.0)
        f0, f2 = pool.engine_for(0), pool.engine_for(2)
        assert pool.home_chip(0) == pool.home_chip(2) == 0
        tasks = [asyncio.create_task(f0.verify_hmac_sha256(*_hmac_item(i)))
                 for i in range(4)]
        tasks += [asyncio.create_task(f2.verify_hmac_sha256(*_hmac_item(4 + i)))
                  for i in range(4)]
        assert all(await asyncio.wait_for(asyncio.gather(*tasks), 10))
        st = pool.engines[0].stats["hmac_sha256"]
        assert st.items == 8 and st.batches == 1
        assert "hmac_sha256" not in pool.engines[1].stats
        assert "c0:hmac_sha256" in pool.stats

    asyncio.run(run())


def test_striped_and_home_chip_agree_on_adversarial_batches(monkeypatch):
    """An explicit batch above stripe_threshold goes through the mesh
    engine (two chunks of the plain K2); its verdicts equal the home
    chip's on the same adversarial items."""
    from minbft_tpu_torch.ops import p256

    chunks = []
    real = p256.ecdsa_verify_kernel_packed

    def spy(rows):
        chunks.append(rows.shape[0])
        return real(rows)

    monkeypatch.setattr(p256, "ecdsa_verify_kernel_packed", spy)
    pool = EnginePool(chips=2, devices=_devs(2), max_batch=4, buckets=(4,),
                      stripe_threshold=2)
    rng = _SeededRng(0x57)
    d, pub = hc.keygen(rng)
    items, expected = [], []
    for i in range(3):
        digest = hashlib.sha256(b"adv-%d" % i).digest()
        sig = hc.ecdsa_sign_py(d, digest)
        if i == 1:
            sig = (sig[0], sig[1] ^ 2)
        items.append((pub, digest, sig))
        expected.append(i != 1)
    fac = pool.engine_for(0)
    assert asyncio.run(fac.verify_ecdsa_p256_many(items)) == expected
    st = pool.striped_engine.stats["ecdsa_p256"]
    assert st.items == 3 and st.batches == 1 and st.padded_lanes == 1
    assert pool.striped_engine.mesh.size == 2 and chunks == [2, 2]
    assert "ecdsa_p256" not in pool.engines[0].stats
    # At the threshold the batch stays on the home chip, same verdicts.
    assert asyncio.run(fac.verify_ecdsa_p256_many(items[:2])) == expected[:2]
    assert chunks == [2, 2, 4]  # the home chip's one whole-bucket launch
    assert pool.engines[0].stats["ecdsa_p256"].items == 2
    assert "stripe:ecdsa_p256" in pool.stats and "c0:ecdsa_p256" in pool.stats


# -- pool ledger ----------------------------------------------------------------


def test_pool_ledger_c1_aggregate_reduces_to_device_ledger():
    pool = EnginePool(chips=1, devices=["cpu"], max_batch=8, max_delay=0.0)
    pl = PoolLedger(pool, now=0.0)
    dl = DeviceLedger(pool.engines[0], now=0.0)
    pl.set_ceiling("hmac_sha256", 1000.0, "test")
    dl.set_ceiling("hmac_sha256", 1000.0, "test")
    _drive_mixed(pool.engine_for(0), seed=0xD1)
    agg = pl.util_keys("p", "hmac_sha256", now=10.0)
    ref = dl.util_keys("p", "hmac_sha256", now=10.0)
    assert ref
    assert {k: v for k, v in agg.items() if k in ref} == ref
    assert agg["p_util_ceiling_source"] == "test"
    assert "p_chip0_util_busy" in agg


def test_pool_ledger_multichip_identity_and_scores():
    async def run():
        pool = EnginePool(chips=2, devices=_devs(2), max_batch=8, max_delay=0.01)
        pl = PoolLedger(pool, now=None)
        pl.set_ceiling("hmac_sha256", 1000.0, "test")
        f0, f1 = pool.engine_for(0), pool.engine_for(1)
        await asyncio.gather(
            *[f0.verify_hmac_sha256(*_hmac_item(i)) for i in range(8)],
            *[f1.verify_hmac_sha256(*_hmac_item(8 + i)) for i in range(4)],
        )
        keys = pl.util_keys("gp", "hmac_sha256")
        assert keys["gp_chip0_util_lanes_useful"] > 0
        assert keys["gp_chip1_util_lanes_useful"] > 0
        assert keys["gp_util_effective_per_sec"] > 0
        assert keys["gp_util_ceiling_source"] == "test x2"
        assert keys["gp_util_ceiling_per_sec"] == 2000.0
        scores = pl.chip_scores("hmac_sha256")
        assert len(scores) == 2 and all(s >= 0 for s in scores)

    asyncio.run(run())


# -- liveness and the prom surfaces ----------------------------------------------


def test_chip_up_reads_0_after_a_hung_dispatcher_times_out_on_every_queue():
    async def run():
        pool = EnginePool(chips=2, devices=_devs(2), max_batch=4, dispatch_timeout=0.2)
        assert pool.chip_up(0) and pool.chip_up(1)  # no queues yet: up
        eng = pool.engines[1]
        release = threading.Event()

        def hung(items):
            release.wait(30)
            return np.ones(len(items), dtype=bool)

        eng._queue("hmac_sha256", hung)
        f1 = pool.engine_for(1)
        with pytest.raises(TimeoutError):
            await f1.verify_hmac_sha256(*_hmac_item(0))
        assert pool.chip_up(1) is False and pool.chip_up(0) is True
        pool.engine_for(0)
        fams = {f[0]: f for f in prom.collect_engine_pool(pool)}
        assert fams["minbft_engine_pool_chips"][3][0][1] == 2
        ups = {lb["chip"]: v for lb, v in fams["minbft_engine_pool_chip_up"][3]}
        assert ups == {"0": 1, "1": 0}
        homes = {lb["group"]: v for lb, v in fams["minbft_engine_pool_home_chip"][3]}
        assert homes == {"0": 0, "1": 1}
        for fam in ("minbft_engine_pool_chip_busy", "minbft_engine_pool_chip_fill",
                    "minbft_engine_pool_chip_depth"):
            assert len(fams[fam][3]) == 2
        # One queue of the chip back to a success: the chip is up again.
        release.set()
        eng._queues["hmac_sha256"].dispatch = lambda items: np.ones(len(items), dtype=bool)
        assert await f1.verify_hmac_sha256(*_hmac_item(1)) is True
        assert pool.chip_up(1) is True

    asyncio.run(run())


def test_chip_utilization_rows_are_renderable_when_idle():
    pool = EnginePool(chips=2, devices=_devs(2), max_batch=4)
    rows = pool.chip_utilization()
    assert [r["chip"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) >= {"chip", "busy", "fill", "score", "depth", "groups"}
        assert r["busy"] == 0.0 and r["depth"] == 0


def test_idle_c2_exposition_equals_the_reference():
    """``collect_engine_pool`` of an idle C = 2 pool with three groups,
    rendered, against the reference's, byte for byte but for the two
    HELP lines whose wording the port changed (the busy window's name,
    and DOWN read as every queue timed out)."""
    port = EnginePool(chips=2, devices=_devs(2), max_batch=8)
    ref = RefEnginePool(chips=2, devices=jax.devices("cpu")[:2], max_batch=8)
    for pool in (port, ref):
        for g in (0, 1, 2):
            pool.engine_for(g)
    base = {"replica": "3"}
    got = prom.render_families(prom.collect_engine_pool(port, base))
    want = ref_render_families(ref_collect_engine_pool(ref, base))
    swapped = {
        "minbft_engine_pool_chip_busy": prom.CHIP_BUSY_HELP,
        "minbft_engine_pool_chip_up": prom.CHIP_UP_HELP,
    }
    lines = []
    for line in want.splitlines(keepends=True):
        parts = line.split(" ", 3)
        if line.startswith("# HELP ") and parts[2] in swapped:
            line = f"# HELP {parts[2]} {swapped[parts[2]]}\n"
        lines.append(line)
    assert got == "".join(lines)
    assert got.count("# HELP ") == 6


def test_group_runtime_collects_the_pool_families():
    auths, _ = new_test_mac_authenticators(4, usig_kind="hmac")
    pool = EnginePool(chips=2, devices=_devs(2), max_batch=8)
    rt = GroupRuntime(0, SimpleConfiger(n=4, f=1, groups=2), [auths[0], auths[0]],
                      InProcessPeerConnector(make_testnet_stubs(4)),
                      [SimpleLedger(), SimpleLedger()], engine_pool=pool)
    fams = {f[0]: f for f in prom.collect_group_runtime(rt, engine=pool, replica_id=0)}
    assert [lb for lb, _v in fams["minbft_engine_pool_home_chip"][3]] == [
        {"replica": "0", "group": "0"}, {"replica": "0", "group": "1"}]
    assert fams["minbft_engine_pool_chips"][3] == [({"replica": "0"}, 2)]


# -- bind_engine -------------------------------------------------------------------


def test_bind_engine_is_a_no_op_over_an_injected_engine_and_mac_forwards_to_its_usig():
    from minbft_tpu_torch.sample.authentication import new_test_authenticators

    engine = BatchVerifier(max_batch=8, device="cpu")
    other = BatchVerifier(max_batch=8, device="cpu")
    r_auths, _ = new_test_authenticators(4, usig_kind="hmac")
    assert r_auths[0]._engine is None
    r_auths[0].bind_engine(engine)
    assert r_auths[0]._engine is engine
    r_auths[0].bind_engine(other)  # an engine already there wins
    assert r_auths[0]._engine is engine
    m_auths, _ = new_test_mac_authenticators(4, usig_kind="hmac")
    mac = m_auths[1]
    assert isinstance(mac, MacAuthenticator) and mac._engine is None
    mac.bind_engine(other)
    assert mac._engine is other and mac._inner._engine is other
    mac.bind_engine(engine)
    assert mac._engine is other and mac._inner._engine is other


# -- the dry run and a mixed grouped cluster ----------------------------------------


def test_dryrun_multichip_on_two_cpu_devices():
    rep = dryrun_multichip(["cpu"] * 2)
    assert rep["batch"] == 4 and rep["groups"] == 2 and rep["requests"] == 2
    assert rep["placement"] == {0: 0, 1: 1}
    assert len({tuple(led) for led in rep["ledgers"]}) == 1
    pool = rep["pools"][0]
    assert pool.chips == 2 and pool.striped_engine.stats["ecdsa_p256"].items == 3
    assert all(pool.engines[c].stats["hmac_sha256"].batches > 0 for c in (0, 1))


def test_mixed_grouped_cluster_on_c2_pools_commits_with_equal_ledgers():
    """n = 4, G = 2, pairwise MACs and HMAC USIGs: replicas 0 and 1 are
    the port's, each with a C = 2 pool over two CPU devices (every MAC and
    UI it checks one lane of its group's home-chip K6), replicas 2 and 3
    the reference's, host crypto."""
    n, f, n_groups, n_clients = 4, 1, 2, 1
    port_auths, ref_auths = [], []
    for g in range(n_groups):
        keys = make_test_keys(n, n_clients, "hmac", rng=_SeededRng(110 + g))
        ref_keys = _ref_mac_keys(110 + g, n, n_clients)
        port_auths.append(mac_authenticators_from_keys(
            keys, mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair), n_clients))
        inner, _, _ = _reference_authenticators(keys)
        ref_auths.append([RefMacAuthenticator(i, False, n, ref_keys.view_for_replica(i),
                                              inner=inner[i]) for i in range(n)])
    pools = [EnginePool(chips=2, devices=_devs(2), max_batch=8, buckets=(8,))
             for _ in range(2)]
    ops = [b"pool-mixed-%d" % k for k in range(6)]

    async def run():
        stubs = make_testnet_stubs(n)
        ledgers, runtimes = [], []
        for i in range(n):
            cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0,
                                 groups=n_groups)
            if i < 2:
                led = [SimpleLedger() for _ in range(n_groups)]
                rt = GroupRuntime(i, cfg, [port_auths[g][0][i] for g in range(n_groups)],
                                  InProcessPeerConnector(stubs), led, engine_pool=pools[i])
            else:
                led = [RefLedger() for _ in range(n_groups)]
                rt = RefGroupRuntime(i, cfg, [ref_auths[g][i] for g in range(n_groups)],
                                     InProcessPeerConnector(stubs), led)
            stubs[i].assign_replica(rt)
            runtimes.append(rt)
            ledgers.append(led)
        for rt in runtimes:
            await rt.start()
        client = MultiGroupClient(0, n, f, n_groups,
                                  [port_auths[g][1][0] for g in range(n_groups)],
                                  InProcessClientConnector(stubs))
        await client.start()
        try:
            await asyncio.wait_for(asyncio.gather(*[client.request(op) for op in ops]), 120)
            per_g = [sum(group_for_key(op, n_groups) == g for op in ops)
                     for g in range(n_groups)]
            assert all(per_g), per_g
            for _ in range(600):
                if all(ledgers[i][g].length >= per_g[g] for i in range(n)
                       for g in range(n_groups)):
                    break
                await asyncio.sleep(0.05)
            for g in range(n_groups):
                assert [ledgers[i][g].length for i in range(n)] == [per_g[g]] * n
                assert len({ledgers[i][g].state_digest() for i in range(n)}) == 1
        finally:
            await client.stop()
            for rt in runtimes:
                await rt.stop()

    asyncio.run(run())
    for pool in pools:
        assert pool.placement() == {0: 0, 1: 1}
        for c in (0, 1):
            st = pool.engines[c].stats["hmac_sha256"]
            assert st.items > 0 and st.dispatch_timeouts == 0
