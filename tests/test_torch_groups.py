"""The port's multi-group consensus (minbft_tpu_torch/groups) against the
reference's (minbft_tpu/groups), on the CPU.

1. Byte-equality on seeded inputs: ``group_for_key`` and ``ShardRouter``
   on 512 seeded keys at every G tried, with the same refusals, and
   ``GroupAuthenticator`` tags: under one set of pairwise MAC keys and
   one HMAC USIG the two packages' group-g tags are byte-identical for
   every role, a group-1 tag never verifies in group 2 on either side,
   and ECDSA tags signed by one package verify in the other's wrapper of
   the same group only.
2. A mixed grouped cluster: 2 port and 2 reference GroupRuntimes (n = 4,
   G = 2) commit a port and a reference client's requests with equal
   ledgers in each group, either side holding the primaries.
3. The reference's scenarios (tests/test_groups.py) on port clusters: the
   commit across groups on both ingest paths, the pinned and unknown
   group frames, the wedged group, the saturated group processor, the
   group labels in the trace and in ``collect_group_runtime``'s families
   (family names, types, help and samples equal to the reference
   collector's on the same runtime), and the grouped testnet scaffold.
   The two scenarios that fail on the reference read the ledgers the
   moment the client holds f + 1 replies; their port copies wait, within
   a bound, for every correct replica to execute, then apply the
   reference's assertions, and one test makes that race deterministic on
   both packages (every frame into a group's primary held back: at the
   quorum the primary has not executed; released: it has).
4. The engine: a port cluster with HMAC USIGs and pairwise MACs on one
   CPU engine (every check one lane of the plain K6, no plain K2) shows a
   flush spanning groups and a mean batch at G = 4 above G = 1's at the
   same per-group load.

Keys come from numpy seeds; byte comparisons are exact."""

import asyncio
import sys

import numpy as np
import pytest

from minbft_tpu import api as ref_api
from minbft_tpu.groups import GroupAuthenticator as RefGroupAuthenticator
from minbft_tpu.groups import GroupRuntime as RefGroupRuntime
from minbft_tpu.groups import MultiGroupClient as RefMultiGroupClient
from minbft_tpu.groups import ShardRouter as RefShardRouter
from minbft_tpu.groups import group_for_key as ref_group_for_key
from minbft_tpu.sample.authentication.mac import MacAuthenticator as RefMacAuthenticator
from minbft_tpu.sample.requestconsumer import SimpleLedger as RefLedger
from minbft_tpu_torch import api
from minbft_tpu_torch.groups import (
    GroupAuthenticator,
    GroupRuntime,
    MultiGroupClient,
    ShardRouter,
    group_for_key,
    new_group_runtime,
)
from minbft_tpu_torch.messages import Request, marshal, pack_group
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.sample.authentication import (
    authenticators_from_keys,
    mac_authenticators_from_keys,
    mac_keys_from,
    new_test_authenticators,
)
from minbft_tpu_torch.sample.authentication.authenticator import make_test_keys
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.sample.conn.inprocess import (
    InProcessClientConnector,
    InProcessPeerConnector,
    make_testnet_stubs,
)
from minbft_tpu_torch.sample.requestconsumer import SimpleLedger
from minbft_tpu_torch.testing import FaultNet, FaultPlan, chaos_seed
from test_torch_mac import _ref_mac_keys
from test_torch_slice import _SeededRng, _reference_authenticators

TIME_SCALE = 5.0 if sys.flags.dev_mode else 1.0
CLIENT, REPLICA, USIG = (api.AuthenticationRole.CLIENT, api.AuthenticationRole.REPLICA,
                         api.AuthenticationRole.USIG)


def _t(seconds: float) -> float:
    return seconds * TIME_SCALE


# ---------------------------------------------------------------------------
# 1. byte-equality with the reference.


def test_group_for_key_and_shard_router_equal_the_reference():
    g = np.random.default_rng(1010)
    keys = [g.bytes(int(g.integers(0, 48))) for _ in range(512)] + [b"", b"user:42"]
    for n_groups in (1, 2, 3, 4, 7, 8, 16, 1000, 65536):
        port_router, ref_router = ShardRouter(n_groups), RefShardRouter(n_groups)
        got = [group_for_key(k, n_groups) for k in keys]
        assert got == [ref_group_for_key(k, n_groups) for k in keys]
        assert got == [port_router.group_for(k) for k in keys]
        assert got == [ref_router.group_for(k) for k in keys]
        assert all(0 <= x < n_groups for x in got)
    # the reference's pins
    assert group_for_key(b"user:42", 8) == 2 and group_for_key(b"", 4) == 0
    for bad in (0, -1, 65537):
        with pytest.raises(ValueError):
            group_for_key(b"x", bad)
        with pytest.raises(ValueError):
            ref_group_for_key(b"x", bad)
        with pytest.raises(ValueError):
            ShardRouter(bad)


def _mac_pair(seed: int, n: int = 4, n_clients: int = 2):
    """Port and reference MAC authenticators (replicas with an HMAC USIG,
    clients) over the same pairwise keys and the same USIG key."""
    keys = make_test_keys(n, n_clients, "hmac", rng=_SeededRng(seed))
    ref_keys = _ref_mac_keys(seed, n, n_clients)
    port = mac_authenticators_from_keys(
        keys, mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair), n_clients)
    inner, _, _ = _reference_authenticators(keys)
    ref = (
        [RefMacAuthenticator(i, False, n, ref_keys.view_for_replica(i), inner=inner[i])
         for i in range(n)],
        [RefMacAuthenticator(c, True, n, ref_keys.view_for_client(c)) for c in range(n_clients)],
    )
    return port, ref


@pytest.mark.parametrize("gid", [0, 1, 7, 65535])
def test_group_authenticator_mac_and_usig_tags_equal_the_reference(gid):
    (p_rep, p_cli), (r_rep, r_cli) = _mac_pair(71)
    msg = b"authen bytes of a grouped message"
    pr = [GroupAuthenticator(a, gid) for a in p_rep]
    rr = [RefGroupAuthenticator(a, gid) for a in r_rep]
    pc = [GroupAuthenticator(a, gid) for a in p_cli]
    rc = [RefGroupAuthenticator(a, gid) for a in r_cli]
    for c in range(2):
        assert pc[c].generate_message_authen_tag(CLIENT, msg) == \
            rc[c].generate_message_authen_tag(ref_api.AuthenticationRole.CLIENT, msg)
    for i in range(4):
        assert pr[i].generate_message_authen_tag(REPLICA, msg) == \
            rr[i].generate_message_authen_tag(ref_api.AuthenticationRole.REPLICA, msg)
        assert pr[i].generate_message_authen_tag(REPLICA, msg, audience=1) == \
            rr[i].generate_message_authen_tag(ref_api.AuthenticationRole.REPLICA, msg,
                                              audience=1)
        # the USIG certificate: same key, epoch and counter on both sides
        assert pr[i].generate_message_authen_tag(USIG, msg) == \
            rr[i].generate_message_authen_tag(ref_api.AuthenticationRole.USIG, msg)
    # group 0 is the empty prefix: the base authenticator's own tag
    base = p_cli[0].generate_message_authen_tag(CLIENT, msg)
    assert (pc[0].generate_message_authen_tag(CLIENT, msg) == base) == (gid == 0)

    async def cross():
        tag = rc[1].generate_message_authen_tag(ref_api.AuthenticationRole.CLIENT, msg)
        for r in range(4):
            await pr[r].verify_message_authen_tag(CLIENT, 1, msg, tag)
        other = GroupAuthenticator(p_rep[2], gid + 1 if gid < 65535 else 1)
        with pytest.raises(api.AuthenticationError):
            await other.verify_message_authen_tag(CLIENT, 1, msg, tag)
        out = await other.verify_message_authen_tags(CLIENT, [(1, msg, tag)])
        assert isinstance(out[0], api.AuthenticationError)

    asyncio.run(cross())


def test_group_authenticator_ecdsa_tags_cross_verify_within_their_group_only():
    keys = make_test_keys(1, 1, "hmac", rng=_SeededRng(72))
    (p_rep,), _ = authenticators_from_keys(keys)
    (r_rep,), _, _ = _reference_authenticators(keys)
    msg = b"payload"

    async def run():
        for signer, verifier, v_api in (
            (GroupAuthenticator(p_rep, 1), RefGroupAuthenticator(r_rep, 1), ref_api),
            (RefGroupAuthenticator(r_rep, 1), GroupAuthenticator(p_rep, 1), api),
        ):
            role = (api if isinstance(signer, GroupAuthenticator)
                    else ref_api).AuthenticationRole.REPLICA
            tag = signer.generate_message_authen_tag(role, msg)
            await verifier.verify_message_authen_tag(v_api.AuthenticationRole.REPLICA, 0,
                                                     msg, tag)
            wrong = type(verifier)(verifier._base, 2)
            with pytest.raises(v_api.AuthenticationError):
                await wrong.verify_message_authen_tag(v_api.AuthenticationRole.REPLICA, 0,
                                                      msg, tag)

    asyncio.run(run())


# ---------------------------------------------------------------------------
# cluster helpers (the reference's make_group_cluster, on the port).


async def make_group_cluster(n=4, f=1, n_groups=2, n_clients=2, cfg=None, usig_kind="hmac",
                             wrap_group_connector=None, per_group=None, **auth_kw):
    """In-process G-group cluster of port runtimes over the real
    shared-channel mux.  Returns (runtimes, per-group client auths, stubs,
    ledgers) with ledgers[i][g] = replica i's group-g ledger."""
    if cfg is None:
        cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0)
    if per_group is None:
        per_group = [new_test_authenticators(n, n_clients=n_clients, usig_kind=usig_kind,
                                             **auth_kw) for _ in range(n_groups)]
    stubs = make_testnet_stubs(n)
    ledgers = [[SimpleLedger() for _ in range(n_groups)] for _ in range(n)]
    runtimes = []
    for i in range(n):
        rt = GroupRuntime(
            i, cfg, [per_group[g][0][i] for g in range(n_groups)],
            InProcessPeerConnector(stubs), ledgers[i],
            wrap_group_connector=(
                (lambda g, c, _i=i: wrap_group_connector(g, c, _i))
                if wrap_group_connector is not None else None),
        )
        stubs[i].assign_replica(rt)
        runtimes.append(rt)
    for rt in runtimes:
        await rt.start()
    return runtimes, [per_group[g][1] for g in range(n_groups)], stubs, ledgers


def _mg_client(client_id, n, f, client_auths, stubs, **kw):
    return MultiGroupClient(
        client_id, n, f, len(client_auths),
        [client_auths[g][client_id] for g in range(len(client_auths))],
        InProcessClientConnector(stubs),
        retransmit_interval=kw.pop("retransmit_interval", 30.0), **kw,
    )


async def _group_executed(ledgers, gid, idxs, count, timeout=30.0) -> bool:
    """Wait, within ``timeout``, until group ``gid``'s ledger on every
    replica in ``idxs`` holds at least ``count`` blocks (f + 1 replies
    prove f + 1 executions, not all of them)."""
    deadline = asyncio.get_running_loop().time() + _t(timeout)
    while asyncio.get_running_loop().time() < deadline:
        if all(ledgers[i][gid].length >= count for i in idxs):
            return True
        await asyncio.sleep(0.02)
    return False


async def _stop(clients, runtimes):
    for c in clients:
        await c.stop()
    for rt in runtimes:
        await rt.stop()


# ---------------------------------------------------------------------------
# 2. a mixed reference/port grouped cluster.


@pytest.mark.parametrize("primary", ["port", "ref"])
def test_mixed_grouped_cluster_commits_with_equal_ledgers_per_group(primary):
    n, f, n_groups = 4, 1, 2
    keys = [make_test_keys(n, 2, "hmac", rng=_SeededRng(80 + g)) for g in range(n_groups)]
    port_auths = [authenticators_from_keys(k) for k in keys]
    ref_auths = [_reference_authenticators(k)[:2] for k in keys]
    port_ids = (0, 1) if primary == "port" else (2, 3)

    async def run():
        stubs = make_testnet_stubs(n)
        ledgers, runtimes = [], []
        for i in range(n):
            port_side = i in port_ids
            mk = GroupRuntime if port_side else RefGroupRuntime
            auths = port_auths if port_side else ref_auths
            led = [(SimpleLedger if port_side else RefLedger)() for _ in range(n_groups)]
            cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0,
                                 groups=n_groups)
            rt = mk(i, cfg, [auths[g][0][i] for g in range(n_groups)],
                    InProcessPeerConnector(stubs), led)
            stubs[i].assign_replica(rt)
            runtimes.append(rt)
            ledgers.append(led)
        for rt in runtimes:
            await rt.start()
        clients = [
            MultiGroupClient(0, n, f, n_groups, [port_auths[g][1][0] for g in range(n_groups)],
                             InProcessClientConnector(stubs)),
            RefMultiGroupClient(1, n, f, n_groups, [ref_auths[g][1][1] for g in range(n_groups)],
                                InProcessClientConnector(stubs)),
        ]
        for c in clients:
            await c.start()
        try:
            ops = [b"mixed-%d-%d" % (c, k) for c in range(2) for k in range(6)]
            await asyncio.wait_for(asyncio.gather(*[
                clients[int(op.split(b"-")[1])].request(op) for op in ops]), _t(60))
            per_g = [0] * n_groups
            for op in ops:
                per_g[group_for_key(op, n_groups)] += 1
            assert all(per_g), per_g
            for g in range(n_groups):
                assert await _group_executed(ledgers, g, range(n), per_g[g])
                lens = [ledgers[i][g].length for i in range(n)]
                assert lens == [per_g[g]] * n, (g, lens)
                assert len({ledgers[i][g].state_digest() for i in range(n)}) == 1
                chain = [ledgers[0][g].block(h).payload for h in range(1, per_g[g] + 1)]
                assert sorted(chain) == sorted(op for op in ops
                                               if group_for_key(op, n_groups) == g)
        finally:
            await _stop(clients, runtimes)

    asyncio.run(run())


# ---------------------------------------------------------------------------
# 3. the reference's scenarios on port clusters.


@pytest.mark.parametrize("ingest", ["1", "0"])
def test_group_runtime_commits_across_groups(ingest, monkeypatch):
    monkeypatch.setenv("MINBFT_BUNDLE_INGEST", ingest)

    async def run():
        runtimes, c_auths, stubs, ledgers = await make_group_cluster(n=4, f=1, n_groups=2)
        client = _mg_client(0, 4, 1, c_auths, stubs)
        await client.start()
        try:
            ops = [b"op-%d" % k for k in range(8)]
            results = await asyncio.wait_for(
                asyncio.gather(*[client.request(op) for op in ops]), _t(60))
            assert all(results)
            per_g = [0, 0]
            for op in ops:
                per_g[client.group_for(op)] += 1
            assert all(per_g), f"hash routing starved a group: {per_g}"
            for g in range(2):
                assert await _group_executed(ledgers, g, range(4), per_g[g])
                lens = [ledgers[i][g].length for i in range(4)]
                assert all(x == per_g[g] for x in lens), (g, lens, per_g)
            for rt in runtimes:
                assert [c.group for c in rt.cores] == [0, 1]
                assert [c.metrics.group for c in rt.cores] == [0, 1]
            agg = runtimes[0].metrics_aggregate()
            assert agg.get("requests_executed", 0) == len(ops)
        finally:
            await _stop([client], runtimes)
        return True

    assert asyncio.run(run())


def test_pinned_group_and_unknown_group_frames():
    async def run():
        runtimes, c_auths, stubs, ledgers = await make_group_cluster(n=4, f=1, n_groups=2)
        client = _mg_client(0, 4, 1, c_auths, stubs)
        await client.start()
        try:
            await asyncio.wait_for(client.request(b"pinned", group=1), _t(60))
            # f + 1 replies precede the last executions: wait for them all
            assert await _group_executed(ledgers, 1, range(4), 1)
            assert [ledgers[i][1].length for i in range(4)] == [1] * 4
            assert all(ledgers[i][0].length == 0 for i in range(4))
            with pytest.raises(ValueError):
                await client.request(b"x", group=7)
            handler = runtimes[0].client_message_stream_handler()

            async def one_shot():
                yield pack_group(9, marshal(Request(client_id=0, seq=1, operation=b"z")))

            out = handler.handle_message_stream(one_shot())
            with pytest.raises((asyncio.TimeoutError, StopAsyncIteration)):
                await asyncio.wait_for(out.__anext__(), _t(0.6))
            await out.aclose()
            await asyncio.wait_for(client.request(b"after", group=0), _t(60))
            assert await _group_executed(ledgers, 0, range(4), 1)
            assert [ledgers[i][0].length for i in range(4)] == [1] * 4
        finally:
            await _stop([client], runtimes)
        return True

    assert asyncio.run(run())


def test_wedged_group_does_not_block_others():
    async def run():
        net = FaultNet(seed=0xB10C, default_plan=FaultPlan(drop=1.0))
        runtimes, c_auths, stubs, ledgers = await make_group_cluster(
            n=4, f=1, n_groups=2,
            wrap_group_connector=lambda g, c, i: net.wrap(c, f"r{i}") if g == 1 else c,
        )
        client = _mg_client(0, 4, 1, c_auths, stubs)
        await client.start()
        try:
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(client.request(b"wedged", group=1), _t(2.0))
            ops = [b"ok-%d" % k for k in range(6)]
            await asyncio.wait_for(
                asyncio.gather(*[client.request(op, group=0) for op in ops]), _t(60))
            assert await _group_executed(ledgers, 0, range(4), len(ops))
            assert all(ledgers[i][1].length == 0 for i in range(4))
        finally:
            await _stop([client], runtimes)
        return True

    assert asyncio.run(run())


def test_saturated_group_processor_never_blocks_the_shared_drain(monkeypatch):
    from minbft_tpu_torch.core import message_handling as mh

    monkeypatch.setattr(mh, "_STREAM_CONCURRENCY", 4)

    async def run():
        net = FaultNet(seed=0xB10C2, default_plan=FaultPlan(drop=1.0))
        runtimes, c_auths, stubs, ledgers = await make_group_cluster(
            n=4, f=1, n_groups=2,
            wrap_group_connector=lambda g, c, i: net.wrap(c, f"r{i}") if g == 1 else c,
        )
        client = _mg_client(0, 4, 1, c_auths, stubs)
        await client.start()
        floods = []
        try:
            floods = [asyncio.ensure_future(client.request(b"flood-%d" % k, group=1))
                      for k in range(12)]
            await asyncio.sleep(_t(1.0))
            await asyncio.wait_for(client.request(b"ok", group=0), _t(60))
            assert await _group_executed(ledgers, 0, range(4), 1)
            assert all(ledgers[i][0].length >= 1 for i in range(4))
        finally:
            for t in floods:
                t.cancel()
            await asyncio.gather(*floods, return_exceptions=True)
            await _stop([client], runtimes)
        return True

    assert asyncio.run(run())


@pytest.mark.parametrize("package", ["port", "ref"])
def test_ledgers_read_at_the_quorum_can_miss_a_lagging_group_primary(package):
    """The cause of the two reference failures, made deterministic on a
    grouped cluster of each package: every frame into group 1's primary
    (replica 0) held back after a first request, no loss.  The backups
    still execute on the
    PREPARE plus their own COMMIT and reply, so the client accepts with
    f + 1 replies while replica 0 has not executed: the reference's
    assertion ``[ledgers[i][1].length ...] == [1] * 4``, read at that
    moment, fails.  Once the frames flow the primary executes and the
    same assertion holds — a race in when the test reads, not a fault of
    the runtime."""
    if package == "ref":
        from minbft_tpu.sample.authentication import new_test_authenticators as mk_auths
        from minbft_tpu.sample.config import SimpleConfiger as Cfg
        from minbft_tpu.sample.requestconsumer import SimpleLedger as Ledger
        from minbft_tpu.testing import FaultNet as Net

        runtime_cls, client_cls = RefGroupRuntime, RefMultiGroupClient
    else:
        mk_auths, Cfg, Ledger, Net = new_test_authenticators, SimpleConfiger, SimpleLedger, FaultNet
        runtime_cls, client_cls = GroupRuntime, MultiGroupClient

    async def run():
        net = Net(seed=chaos_seed(default=0x6A6))
        per_group = [mk_auths(4, n_clients=1, usig_kind="hmac") for _ in range(2)]
        stubs = make_testnet_stubs(4)
        ledgers = [[Ledger() for _ in range(2)] for _ in range(4)]
        cfg = Cfg(n=4, f=1, timeout_request=60.0, timeout_prepare=30.0)
        runtimes = []
        for i in range(4):
            rt = runtime_cls(
                i, cfg, [per_group[g][0][i] for g in range(2)],
                InProcessPeerConnector(stubs), ledgers[i],
                wrap_group_connector=(
                    lambda g, c, _i=i: net.wrap(c, f"r{_i}") if g == 1 else c),
            )
            stubs[i].assign_replica(rt)
            runtimes.append(rt)
        for rt in runtimes:
            await rt.start()
        client = client_cls(0, 4, 1, 2, [per_group[g][1][0] for g in range(2)],
                            InProcessClientConnector(stubs), retransmit_interval=30.0)
        await client.start()
        try:
            # Streams up (a backup subscribes to the primary's log with a
            # HELLO into it) and every group-1 ledger at one block.
            await asyncio.wait_for(client.request(b"warm", group=1), _t(30))
            assert await _group_executed(ledgers, 1, range(4), 1)
            net.stall(dst="r0")
            await asyncio.wait_for(client.request(b"pinned", group=1), _t(30))
            at_quorum = [ledgers[i][1].length for i in range(4)]
            assert at_quorum[0] == 1 and at_quorum != [2] * 4, at_quorum
            net.unstall(dst="r0")
            assert await _group_executed(ledgers, 1, range(4), 2)
            assert [ledgers[i][1].length for i in range(4)] == [2] * 4
        finally:
            await _stop([client], runtimes)
        return True

    assert asyncio.run(run())


def test_group_labels_in_trace_and_prom():
    from minbft_tpu_torch.obs.prom import collect_replica, merge_family_lists, render_families
    from minbft_tpu_torch.obs.trace import FlightRecorder, dump_path_for, filter_group
    from minbft_tpu_torch.utils.metrics import ReplicaMetrics

    rec = FlightRecorder.for_replica(2, group=3)
    assert rec.to_dict()["group"] == 3
    assert dump_path_for("replica", 2, base="/tmp/x", group=3) == "/tmp/x.r2g3.json"
    assert dump_path_for("replica", 2, base="/tmp/x") == "/tmp/x.r2.json"
    docs = [{"kind": "replica", "group": 0, "hists": {}},
            {"kind": "replica", "group": 1, "hists": {}},
            {"kind": "engine", "hists": {}}]
    assert {d.get("group") for d in filter_group(docs, 1)} == {1, None}
    m = ReplicaMetrics(group=2)
    m.inc("requests_executed", 5)
    text = render_families(merge_family_lists([
        collect_replica(metrics=m, replica_id=0),
        collect_replica(metrics=ReplicaMetrics(group=3), replica_id=0),
    ]))
    assert 'group="2"' in text
    assert text.count("# TYPE minbft_uptime_seconds gauge") == 1


# Families whose values are clock readings.
CLOCKED = {"minbft_uptime_seconds"}


def test_collect_group_runtime_matches_the_reference_collector():
    """``collect_group_runtime`` of a committing G = 2 port runtime (MACs,
    HMAC USIGs, one CPU engine) against the reference's collector on the
    same runtime: the same families with the same types, help and
    samples, each protocol family labelled per group, the engine's
    families once and unlabelled by group, and the stale-group gauge for
    every group."""
    from minbft_tpu.obs import prom as ref_prom
    from minbft_tpu_torch.obs import prom
    from minbft_tpu_torch.obs.timeseries import (
        CounterSampler,
        TimeSeries,
        register_engine_series,
        register_replica_series,
    )

    engine = BatchVerifier(max_batch=16, buckets=(16,), device="cpu")
    per_group = []
    for g in range(2):
        keys = make_test_keys(4, 1, "hmac", rng=_SeededRng(90 + g))
        ref_keys = _ref_mac_keys(90 + g, 4, 1)
        per_group.append(mac_authenticators_from_keys(
            keys, mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair), 1,
            engine=engine, client_engine=engine))

    async def run():
        runtimes, c_auths, stubs, ledgers = await make_group_cluster(per_group=per_group)
        client = _mg_client(0, 4, 1, c_auths, stubs)
        await client.start()
        try:
            for g in range(2):
                await asyncio.wait_for(client.request(b"prom-%d" % g, group=g), _t(60))
                assert await _group_executed(ledgers, g, range(4), 1)
            rt = runtimes[0]
            ts = TimeSeries()
            sampler = CounterSampler(ts)
            for core in rt.cores:
                register_replica_series(sampler, core.metrics, group=core.group)
            register_engine_series(sampler, engine)
            sampler.tick()
            sampler.tick()
            kw = dict(engine=engine, replica_id=0, timeseries=ts)
            peak = engine.queue_depth_peaks(reset=False)
            text_p = prom.render_families(prom.collect_group_runtime(rt, **kw))
            for name, q in engine._queues.items():
                q.peak_depth = peak[name]
            text_r = prom.render_families(ref_prom.collect_group_runtime(rt, **kw))
            return text_p, text_r
        finally:
            await _stop([client], runtimes)

    text_p, text_r = asyncio.run(run())
    fp, fr = prom.parse_exposition(text_p), ref_prom.parse_exposition(text_r)
    assert set(fp) == set(fr)
    for name in fp:
        assert fp[name]["type"] == fr[name]["type"], name
        if name == "minbft_build_info":
            assert [sorted(dict(k)) for k in fp[name]["samples"]] == \
                [sorted(dict(k)) for k in fr[name]["samples"]]
            continue
        if name in CLOCKED:
            assert fp[name]["samples"].keys() == fr[name]["samples"].keys()
            continue
        assert fp[name]["samples"] == fr[name]["samples"], name
    executed = fp["minbft_requests_executed_total"]["samples"]
    assert executed == {(("group", "0"), ("replica", "0")): 1,
                        (("group", "1"), ("replica", "0")): 1}
    keys = [dict(k) for k in fp["minbft_verify_queue_items_total"]["samples"]]
    assert keys == [{"queue": "hmac_sha256", "replica": "0"}]
    assert {dict(k)["group"] for k in fp["minbft_health_stale_group"]["samples"]} == {"0", "1"}


def test_engine_pool_is_refused_naming_its_item():
    auths, _ = new_test_authenticators(4, usig_kind="hmac")
    with pytest.raises(api.NotPortedError, match="item 7"):
        new_group_runtime(0, SimpleConfiger(n=4, f=1), [auths[0]],
                          InProcessPeerConnector(make_testnet_stubs(4)), [SimpleLedger()],
                          engine_pool=object())


def test_testnet_scaffold_declares_groups_and_config_layers(tmp_path):
    from minbft_tpu_torch.sample.config import load_config
    from minbft_tpu_torch.sample.peer.cli import main

    d = str(tmp_path)
    assert main(["testnet", "-n", "4", "--clients", "1", "-d", d, "--usig", "HMAC_SHA256",
                 "--base-port", "45300", "--groups", "8"]) == 0
    cfg = load_config(f"{d}/consensus.yaml")
    assert cfg.groups == 8
    assert load_config(f"{d}/consensus.yaml", env={"CONSENSUS_GROUPS": "2"}).groups == 2
    assert main(["testnet", "-n", "4", "--clients", "1", "-d", f"{d}/plain", "--usig",
                 "HMAC_SHA256", "--base-port", "45310"]) == 0
    assert load_config(f"{d}/plain/consensus.yaml").groups == 1


# ---------------------------------------------------------------------------
# 4. cross-group coalescing in one engine (the plain K6 on the CPU).


async def _run_coalescing_cluster(n_groups, waves, clients=2):
    """Fixed per-group load through one shared CPU engine, every check one
    K6 lane (pairwise MACs, HMAC USIGs); returns (the HMAC queue's
    dispatched batches, key -> group, the queue's stats)."""
    engine = BatchVerifier(max_batch=64, buckets=(64,), device="cpu")
    q = engine._queue("hmac_sha256", engine._dispatch_hmac)
    batches = []
    orig = q.dispatch

    def spy(items):
        batches.append(list(items))
        return orig(items)

    q.dispatch = spy
    per_group, key_group = [], {}
    for g in range(n_groups):
        keys = make_test_keys(4, clients, "hmac", rng=_SeededRng(100 + g))
        ref_keys = _ref_mac_keys(100 + g, 4, clients)
        per_group.append(mac_authenticators_from_keys(
            keys, mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair), clients,
            engine=engine, client_engine=engine))
        for k in [*ref_keys.client_replica.values(), *ref_keys.replica_pair.values(),
                  keys["usig_key"]]:
            key_group[k] = g
    runtimes, c_auths, stubs, ledgers = await make_group_cluster(
        n_groups=n_groups, n_clients=clients, per_group=per_group)
    mclients = [_mg_client(c, 4, 1, c_auths, stubs) for c in range(clients)]
    for mc in mclients:
        await mc.start()
    try:
        for wave in range(waves):
            await asyncio.wait_for(asyncio.gather(*[
                mc.request(b"w-%d-%d" % (mc.client_id, wave), group=g)
                for mc in mclients for g in range(n_groups)]), _t(120))
        for g in range(n_groups):
            assert await _group_executed(ledgers, g, range(4), waves * clients)
    finally:
        await _stop(mclients, runtimes)
    return batches, key_group, q.stats


def test_one_engine_flush_spans_groups_and_fills_more_with_groups():
    b1, m1, s1 = asyncio.run(_run_coalescing_cluster(1, waves=3))
    b4, m4, s4 = asyncio.run(_run_coalescing_cluster(4, waves=3))
    assert s1.items and s4.items and s1.dispatch_timeouts == s4.dispatch_timeouts == 0
    spans = [{m4[key] for key, _d, _m in b if key in m4} for b in b4]
    assert any(len(s) >= 2 for s in spans), [sorted(s) for s in spans]
    # at the same per-group load, four groups' checks coalesce in the one
    # queue: the mean batch rises
    assert s4.mean_batch > s1.mean_batch, (s1.mean_batch, s4.mean_batch)
