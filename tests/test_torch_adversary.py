"""The reference's chaos and Byzantine cluster scenarios
(tests/test_chaos.py from its adversary suite on, tests/test_byzantine.py)
on clusters of the port: the port's core, client, transports, fault
network (``minbft_tpu_torch.testing.faultnet``), adversary harness
(``testing.adversary``) and safety checker (``testing.invariants``, the
reference's rules), at the reference's sizes, host crypto.

Two scenarios differ from the reference's, in timing only:
``test_adversary_equivocation_rejected`` and
``test_adversary_stale_replay_wrong_view_and_counter_gap`` fail on the
reference because they run the checker the moment the client holds
f + 1 matching replies.  Backups execute a request on the PREPARE plus
their own COMMIT (f + 1 = 2 commitments), but the primary must wait for a
backup's COMMIT to arrive, so the client's f + 1 replies can come from
the two backups before the primary executed, and the committed-results
rule then finds the request missing from a correct ledger it was still
on its way to.  Here they wait, within a bound, for every correct
replica to execute the accepted requests, then check, with the rules
unchanged; ``test_checker_right_after_the_quorum_can_see_a_correct_laggard``
shows the race itself.
"""

import asyncio
import logging
import sys

import pytest

from minbft_tpu_torch.client import new_client
from minbft_tpu_torch.messages import Commit, Hello, Request, UI, marshal
from minbft_tpu_torch.messages.message import Prepare
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.sample.conn.inprocess import InProcessClientConnector
from minbft_tpu_torch.testing import (
    FaultNet,
    FaultPlan,
    InvariantChecker,
    chaos_seed,
)
from minbft_tpu_torch.testing.adversary import Adversary, ConflictingReplyReplica

# As in the reference: dev mode slows the hot path, so every wall-clock
# knob stretches by one factor (the seeded schedule is frame-indexed).
TIME_SCALE = 5.0 if sys.flags.dev_mode else 1.0


def _t(seconds: float) -> float:
    return seconds * TIME_SCALE


_log = logging.getLogger("minbft.chaos")


async def make_cluster(
    n=4, f=1, n_clients=1, usig_kind="hmac", cfg=None, wrap_conn=None, **auth_kw
):
    """An in-process cluster of the port (the reference's conftest
    ``make_cluster`` layout).  Returns (replicas, client_auths, stubs,
    ledgers); the caller stops the replicas."""
    from minbft_tpu_torch.core import new_replica
    from minbft_tpu_torch.sample.authentication import new_test_authenticators
    from minbft_tpu_torch.sample.conn.inprocess import (
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from minbft_tpu_torch.sample.requestconsumer import SimpleLedger

    if cfg is None:
        cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0)
    r_auths, c_auths = new_test_authenticators(
        n, n_clients=n_clients, usig_kind=usig_kind, **auth_kw
    )
    stubs = make_testnet_stubs(n)
    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    for i in range(n):
        conn = InProcessPeerConnector(stubs)
        if wrap_conn is not None:
            conn = wrap_conn(i, conn)
        r = new_replica(i, cfg, r_auths[i], conn, ledgers[i])
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    return replicas, c_auths, stubs, ledgers


async def _executed(ledgers, idxs, count, timeout=30.0) -> bool:
    """Wait, within ``timeout``, until every ledger in ``idxs`` holds at
    least ``count`` blocks (committed results are a convergence property:
    f + 1 replies prove f + 1 executions)."""
    deadline = asyncio.get_running_loop().time() + _t(timeout)
    while asyncio.get_running_loop().time() < deadline:
        if all(ledgers[i].length >= count for i in idxs):
            return True
        await asyncio.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# Byzantine adversary suite: real keys, real codec, hostile content.
# Every behavior must be rejected with no safety-invariant violation AND
# the cluster must still commit the honest workload.


def _short_cfg(vc=3.0):
    return SimpleConfiger(
        n=4, f=1, timeout_request=_t(0.8), timeout_prepare=_t(0.4),
        timeout_viewchange=_t(vc),
    )


def test_adversary_equivocation_rejected():
    """A Byzantine PRIMARY certifies one PREPARE, then re-sends the same
    UI over different content.  USIG counter monotonicity is the paper's
    core defense: one counter certifies ONE message, so the copy's cert
    cannot verify — backups must drop it, and the cluster (having lost
    only its primary to the adversary, within f=1) must view-change and
    keep committing."""

    async def run():
        replicas, c_auths, stubs, ledgers = await make_cluster(cfg=_short_cfg())
        client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs))
        await client.start()
        accepted = []
        r0 = await asyncio.wait_for(client.request(b"equiv-seed"), 30)
        accepted.append((b"equiv-seed", r0))

        # A genuine client-signed request to re-batch (from replica 1's
        # own COMMIT, which embeds the primary's PREPARE).
        commits = [
            m for m in replicas[1].handlers.message_log.snapshot()
            if isinstance(m, Commit)
        ]
        req = commits[0].prepare.requests[0]

        # The primary turns adversarial: its honest process stops, its
        # keys keep signing.
        stubs[0].crash()
        await replicas[0].stop()
        adv = Adversary(0, replicas[0].handlers.authenticator, 4)
        evil = Request(
            client_id=req.client_id, seq=req.seq + 999,
            operation=b"equiv-evil", signature=b"\x00" * 64,
        )
        pa, pb = adv.equivocating_prepares(0, [req], [evil])
        assert pb.ui.counter == pa.ui.counter  # the equivocation attempt

        m1 = replicas[1].metrics
        dropped = m1.counters.get("messages_dropped", 0)
        applied = m1.counters.get("prepares_accepted", 0)
        await adv.inject(stubs[1].peer_message_stream_handler(), [pa, pb])
        for _ in range(100):
            if m1.counters.get("messages_dropped", 0) > dropped:
                break
            await asyncio.sleep(0.02)
        # the conflicting copy is DROPPED (cert forgery)...
        assert m1.counters.get("messages_dropped", 0) >= dropped + 1
        # ...while at most the first certification was accepted.
        assert m1.counters.get("prepares_accepted", 0) <= applied + 1
        # nothing executed twice, nothing evil executed
        assert all(lg.length == 1 for lg in ledgers[1:])

        # honest workload continues (view change deposes the adversary)
        r1 = await asyncio.wait_for(client.request(b"after-equiv"), 45)
        accepted.append((b"after-equiv", r1))
        # The client's f + 1 replies can precede the new primary's own
        # execution (module docstring): wait for the correct replicas.
        assert await _executed(ledgers, (1, 2, 3), len(accepted))
        InvariantChecker(replicas, ledgers, correct=(1, 2, 3)).check(accepted)

        await client.stop()
        for r in replicas[1:]:
            await r.stop()
        return True

    assert asyncio.run(run())


def test_adversary_stale_replay_wrong_view_and_counter_gap():
    """Three adversarial behaviors from a backup's genuine keys:

    - stale-UI replay → dedup'd by once-only in-order capture (handled,
      no re-execution);
    - wrong-view PREPARE (genuinely certified, view the cluster is not
      in) → captured then refused, never applied;
    - counter-gap COMMIT (genuine cert, one counter burned unsent) →
      parked at capture, never processed past the gap.

    Throughout: the cluster keeps committing the honest workload."""

    async def run():
        replicas, c_auths, stubs, ledgers = await make_cluster(
            cfg=_short_cfg(vc=0.5)
        )
        client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs))
        await client.start()
        accepted = []
        r0 = await asyncio.wait_for(client.request(b"adv-seed"), 30)
        accepted.append((b"adv-seed", r0))
        for _ in range(200):
            if all(lg.length == 1 for lg in ledgers):
                break
            await asyncio.sleep(0.02)

        # Replica 2 turns adversarial (still within f=1).
        genuine_commit = next(
            m for m in replicas[2].handlers.message_log.snapshot()
            if isinstance(m, Commit)
        )
        stubs[2].crash()
        await replicas[2].stop()
        adv = Adversary(2, replicas[2].handlers.authenticator, 4)

        # -- stale-UI replay at replica 1
        m1 = replicas[1].metrics
        handled = m1.counters.get("messages_handled", 0)
        await adv.inject(
            stubs[1].peer_message_stream_handler(),
            [adv.replay(genuine_commit)] * 3,
        )
        for _ in range(100):
            if m1.counters.get("messages_handled", 0) >= handled + 3:
                break
            await asyncio.sleep(0.02)
        assert m1.counters.get("messages_handled", 0) >= handled + 3
        assert ledgers[1].length == 1  # no double execution

        # -- wrong-view PREPARE at replica 1 (adversary IS view 2's
        # primary, but the cluster is in view 0)
        applied = m1.counters.get("prepares_accepted", 0)
        wv = adv.wrong_view_prepare(2, [genuine_commit.prepare.requests[0]])
        # the future-view park expires after 2*max(vc_timeout, 1.0)
        # (2s at this cfg, 5s dev-mode-scaled), then the message must be
        # captured and REFUSED, not applied — hold past the expiry
        await adv.inject(
            stubs[1].peer_message_stream_handler(), [wv],
            hold_s=2.0 * max(_t(0.5), 1.0) + _t(1.5),
        )
        assert m1.counters.get("messages_dropped_future_view", 0) >= 1
        assert m1.counters.get("prepares_accepted", 0) == applied
        assert ledgers[1].length == 1

        # -- counter-gap COMMIT at replica 3
        gap_commit = adv.counter_gap_commit(genuine_commit.prepare)
        m3 = replicas[3].metrics
        counted = m3.counters.get("commitments_counted", 0)
        mark_before = replicas[3].handlers.peer_states.peer(2)._next_cv
        assert gap_commit.ui.counter > mark_before + 1  # a real gap
        await adv.inject(stubs[3].peer_message_stream_handler(), [gap_commit])
        # parked at capture: the watermark must NOT have advanced to (or
        # past) the gapped counter, and no commitment was counted for it
        assert replicas[3].handlers.peer_states.peer(2)._next_cv <= mark_before + 1
        assert m3.counters.get("commitments_counted", 0) == counted
        assert ledgers[3].length == 1

        # honest workload still commits (primary 0 is honest and alive)
        r1 = await asyncio.wait_for(client.request(b"adv-after"), 30)
        accepted.append((b"adv-after", r1))
        # The client's f + 1 replies can precede the primary's own
        # execution (module docstring): wait for the correct replicas.
        assert await _executed(ledgers, (0, 1, 3), len(accepted))
        InvariantChecker(replicas, ledgers, correct=(0, 1, 3)).check(accepted)

        await client.stop()
        for i in (0, 1, 3):
            await replicas[i].stop()
        return True

    assert asyncio.run(run())


def test_adversary_conflicting_replies_stay_below_quorum():
    """A replica answering clients with correctly-SIGNED wrong results:
    one liar's vote must never complete the client's f+1 matching-reply
    quorum, and the accepted result must be the honest ledgers' digest."""

    async def run():
        replicas, c_auths, stubs, ledgers = await make_cluster()
        # replica 2's identity is taken over by the reply forger
        stubs[2].crash()
        await replicas[2].stop()
        adv = Adversary(2, replicas[2].handlers.authenticator, 4)
        forger = ConflictingReplyReplica(adv)
        stubs[2].revive()
        stubs[2].assign_replica(forger)

        client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs))
        await client.start()
        res = await asyncio.wait_for(client.request(b"honest-op"), 30)
        assert res != forger.forged_result
        for _ in range(200):
            if forger.replies_sent >= 1:
                break
            await asyncio.sleep(0.02)
        assert forger.replies_sent >= 1  # the liar really voted
        for _ in range(200):
            if all(lg.length == 1 for lg in (ledgers[0], ledgers[1], ledgers[3])):
                break
            await asyncio.sleep(0.02)
        assert res == ledgers[0].block(1).digest()
        InvariantChecker(replicas, ledgers, correct=(0, 1, 3)).check(
            [(b"honest-op", res)]
        )

        await client.stop()
        for i in (0, 1, 3):
            await replicas[i].stop()
        return True

    assert asyncio.run(run())


# ---------------------------------------------------------------------------
# View change under message LOSS (satellite): the transition completes
# across lossy links, not just after clean crashes.


def test_view_change_completes_under_message_loss():
    seed = chaos_seed(default=0xA11CE)

    async def run():
        net = FaultNet(
            seed=seed,
            default_plan=FaultPlan(
                drop=0.05, delay=0.15, delay_s=(0.0005, 0.008),
                duplicate=0.05, reorder=0.08, reset=0.01,
            ),
        )
        cfg = SimpleConfiger(
            n=4, f=1, timeout_request=_t(0.8), timeout_prepare=_t(0.4),
            timeout_viewchange=_t(1.5),
        )
        replicas, c_auths, stubs, ledgers = await make_cluster(
            cfg=cfg, wrap_conn=lambda i, c: net.wrap(c, f"r{i}")
        )
        client = new_client(
            0, 4, 1, c_auths[0], InProcessClientConnector(stubs),
            retransmit_interval=_t(0.5),
        )
        await client.start()
        accepted = []
        r0 = await asyncio.wait_for(client.request(b"loss-seed"), _t(60))
        accepted.append((b"loss-seed", r0))

        stubs[0].crash()
        await replicas[0].stop()

        # REQ-VIEW-CHANGE / VIEW-CHANGE / NEW-VIEW now cross lossy links;
        # the timeout/escalation + redial-replay paths must still land a
        # completed transition.
        r1 = await asyncio.wait_for(client.request(b"loss-after-crash"), _t(90))
        accepted.append((b"loss-after-crash", r1))
        for r in replicas[1:]:
            cur, _ = await r.handlers.view_state.hold_view()
            assert cur >= 1, f"replica {r.id} still in view {cur}"
        deadline = asyncio.get_running_loop().time() + _t(30)
        while asyncio.get_running_loop().time() < deadline:
            if all(lg.length >= 2 for lg in ledgers[1:]):
                break
            await asyncio.sleep(0.05)
        InvariantChecker(replicas, ledgers, correct=(1, 2, 3)).check(accepted)
        assert net.census.counters.get("drop", 0) >= 1

        await client.stop()
        for r in replicas[1:]:
            await r.stop()
        return True

    try:
        assert asyncio.run(run())
    except BaseException:
        print(f"replay with MINBFT_CHAOS_SEED={seed}")
        raise


# ---------------------------------------------------------------------------
# Stalled (half-open) primary: frames stop, connections stay up — the
# request-timeout → view-change path must fire on BOTH transports (a
# closed connection is the easy case the old tests covered).


def test_stalled_primary_triggers_view_change_inprocess():
    async def run():
        net = FaultNet(seed=chaos_seed(default=0x57A11))
        replicas, c_auths, stubs, ledgers = await make_cluster(
            cfg=_short_cfg(), wrap_conn=lambda i, c: net.wrap(c, f"r{i}")
        )
        client = new_client(
            0, 4, 1, c_auths[0],
            net.wrap(InProcessClientConnector(stubs), "c0"),
            retransmit_interval=0.5,
        )
        await client.start()
        accepted = []
        r0 = await asyncio.wait_for(client.request(b"stall-seed"), 30)
        accepted.append((b"stall-seed", r0))

        net.stall_replica(0)  # half-open: streams stay up, frames stop
        r1 = await asyncio.wait_for(client.request(b"stall-after"), 60)
        accepted.append((b"stall-after", r1))
        for r in replicas[1:]:
            cur, _ = await r.handlers.view_state.hold_view()
            assert cur >= 1, f"replica {r.id} still in view {cur}"
        assert net.census.counters.get("stall", 0) >= 1
        net.unstall_replica(0)
        # committed-results is a convergence property (f+1 replies prove
        # only f+1 executions) — give laggards a bounded catch-up first.
        deadline = asyncio.get_running_loop().time() + _t(30)
        while asyncio.get_running_loop().time() < deadline:
            if all(lg.length >= len(accepted) for lg in ledgers[1:]):
                break
            await asyncio.sleep(0.05)
        InvariantChecker(replicas, ledgers, correct=(1, 2, 3)).check(accepted)

        await client.stop()
        for r in replicas:
            await r.stop()
        return True

    assert asyncio.run(run())


def test_stalled_primary_triggers_view_change_tcp():
    """Same half-open primary scenario over the native TCP transport:
    replica stubs behind TcpReplicaServer, dial-side TcpReplicaConnectors
    wrapped in the FaultNet, idle teardown armed."""

    async def run():
        from minbft_tpu_torch.core import new_replica
        from minbft_tpu_torch.sample.authentication import new_test_authenticators
        from minbft_tpu_torch.sample.conn.inprocess import make_testnet_stubs
        from minbft_tpu_torch.sample.conn.tcp import (
            TcpReplicaConnector,
            TcpReplicaServer,
            connect_many_replicas_tcp,
        )
        from minbft_tpu_torch.sample.requestconsumer import SimpleLedger

        net = FaultNet(seed=chaos_seed(default=0x7C9))
        n, f = 4, 1
        cfg = _short_cfg()
        r_auths, c_auths = new_test_authenticators(n, usig_kind="hmac")
        stubs = make_testnet_stubs(n)
        servers = {}
        addrs = {}
        for i in range(n):
            srv = TcpReplicaServer(stubs[i])
            addrs[i] = await srv.start("127.0.0.1:0")
            servers[i] = srv
        ledgers = [SimpleLedger() for _ in range(n)]
        replicas = []
        for i in range(n):
            conn = TcpReplicaConnector("peer", idle_timeout=30.0)
            for j, addr in addrs.items():
                if j != i:
                    conn.connect_replica(j, addr)
            r = new_replica(i, cfg, r_auths[i], net.wrap(conn, f"r{i}"), ledgers[i])
            stubs[i].assign_replica(r)
            replicas.append(r)
        for r in replicas:
            await r.start()
        client_conn = connect_many_replicas_tcp(addrs, kind="client")
        client = new_client(
            0, n, f, c_auths[0], net.wrap(client_conn, "c0"),
            retransmit_interval=0.5,
        )
        await client.start()
        try:
            accepted = []
            r0 = await asyncio.wait_for(client.request(b"tcp-stall-seed"), 60)
            accepted.append((b"tcp-stall-seed", r0))

            net.stall_replica(0)
            r1 = await asyncio.wait_for(client.request(b"tcp-stall-after"), 90)
            accepted.append((b"tcp-stall-after", r1))
            for r in replicas[1:]:
                cur, _ = await r.handlers.view_state.hold_view()
                assert cur >= 1, f"replica {r.id} still in view {cur}"
            assert net.census.counters.get("stall", 0) >= 1
            net.unstall_replica(0)
            # committed-results is a convergence property — wait for the
            # correct laggards before holding every ledger to it.
            deadline = asyncio.get_running_loop().time() + _t(30)
            while asyncio.get_running_loop().time() < deadline:
                if all(lg.length >= len(accepted) for lg in ledgers[1:]):
                    break
                await asyncio.sleep(0.05)
            InvariantChecker(replicas, ledgers, correct=(1, 2, 3)).check(accepted)
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()
            for srv in servers.values():
                await srv.stop()
            await client_conn.close()
        return True

    assert asyncio.run(run())


def test_tcp_idle_timeout_recovers_half_open_stream():
    """Satellite: the native TCP connector's per-stream read-idle timeout
    tears down a half-open connection (server alive, frames stalled by a
    faultnet stall BELOW the dialer's socket) so the redial loop can
    recover — without it the read parks forever."""
    from minbft_tpu_torch import api
    from minbft_tpu_torch.sample.conn.tcp import TcpReplicaConnector, TcpReplicaServer
    from minbft_tpu_torch.testing import FaultyConnectionHandler

    class _Echo(api.MessageStreamHandler):
        async def handle_message_stream(self, in_stream):
            async for data in in_stream:
                yield b"E:" + data

    class _EchoConn(api.ConnectionHandler):
        def peer_message_stream_handler(self):
            return _Echo()

        def client_message_stream_handler(self):
            return _Echo()

    async def run():
        net = FaultNet(seed=1)
        server = TcpReplicaServer(FaultyConnectionHandler(_EchoConn(), net, "srv"))
        addr = await server.start("127.0.0.1:0")
        conn = TcpReplicaConnector("peer", idle_timeout=0.4)
        conn.connect_replica(0, addr)
        try:
            handler = conn.replica_message_stream_handler(0)
            sent = asyncio.Event()

            async def outgoing():
                yield b"one"
                await sent.wait()
                yield b"two"
                await asyncio.sleep(60)

            out = handler.handle_message_stream(outgoing())
            assert await asyncio.wait_for(out.__anext__(), 10) == b"E:one"
            # Stall the server side: the TCP connection stays up but no
            # frames flow — the dialer's idle deadline must END the
            # stream (the redial loop's recovery signal)...
            net.stall(dst="srv")
            sent.set()
            t0 = asyncio.get_running_loop().time()
            with pytest.raises(StopAsyncIteration):
                await asyncio.wait_for(out.__anext__(), 10)
            assert asyncio.get_running_loop().time() - t0 < 5.0
            await out.aclose()
            # ...and after the stall heals, a fresh dial works again.
            net.unstall(dst="srv")
            h2 = conn.replica_message_stream_handler(0)

            async def once():
                yield b"back"
                await asyncio.sleep(60)

            out2 = h2.handle_message_stream(once())
            assert await asyncio.wait_for(out2.__anext__(), 10) == b"E:back"
            await out2.aclose()
        finally:
            await server.stop()
            await conn.close()
        return True

    assert asyncio.run(run())


# ---------------------------------------------------------------------------
# Silent tail loss: the hardest liveness hole a lossy link can open.  A
# replica that misses a burst's TAIL (a partition swallowing commits, a
# dropped NEW-VIEW with no follow-on traffic) has NOTHING to react to:
# no counter gap parks (nothing later arrived), no stream ends, no
# timeout fires.  Recovery is the dial loop's idle-refresh — tear down a
# silent stream and redial with a resumable HELLO so the publisher
# replays just the missed tail.


def test_idle_refresh_heals_silent_tail_loss():
    async def run():
        net = FaultNet(seed=chaos_seed(default=0x1D7E))  # faithful plan
        cfg = SimpleConfiger(
            n=4, f=1, timeout_request=_t(60.0), timeout_prepare=_t(30.0),
            timeout_viewchange=_t(1.0),
        )
        replicas, c_auths, stubs, ledgers = await make_cluster(
            cfg=cfg, wrap_conn=lambda i, c: net.wrap(c, f"r{i}")
        )
        client = new_client(
            0, 4, 1, c_auths[0],
            net.wrap(InProcessClientConnector(stubs), "c0"),
        )
        await client.start()
        accepted = []
        try:
            r0 = await asyncio.wait_for(client.request(b"tail-seed"), _t(30))
            accepted.append((b"tail-seed", r0))
            deadline = asyncio.get_running_loop().time() + _t(15)
            while asyncio.get_running_loop().time() < deadline:
                if all(lg.length == 1 for lg in ledgers):
                    break
                await asyncio.sleep(0.02)

            # r3 alone on the wrong side; the client stays with the
            # majority so NOTHING reaches r3 from here on.
            net.partition({"r0", "r1", "r2", "c0"}, {"r3"})
            for i in range(3):
                op = b"tail-%d" % i
                res = await asyncio.wait_for(client.request(op), _t(30))
                accepted.append((op, res))
            assert ledgers[3].length == 1  # r3 really missed the burst

            # Heal — and issue NO further traffic.  Without the
            # idle-refresh this wedges forever: the partition dropped
            # frames on streams that stayed up, so r3 sees only silence.
            net.heal_partition()
            deadline = asyncio.get_running_loop().time() + _t(45)
            while asyncio.get_running_loop().time() < deadline:
                if ledgers[3].length >= len(accepted):
                    break
                await asyncio.sleep(0.05)
            assert ledgers[3].length >= len(accepted), (
                f"r3 ledger stuck at {ledgers[3].length}/{len(accepted)} "
                "after heal (idle-refresh did not deliver the tail)"
            )
            assert replicas[3].metrics.counters.get("idle_redials", 0) >= 1
            InvariantChecker(replicas, ledgers).check(accepted)
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()
        return True

    assert asyncio.run(run())


# ---------------------------------------------------------------------------
# THE chaos soak: n=4/f=1 under seeded drop+delay+duplicate+reorder+
# corrupt(+reset), one partition-and-heal, one primary stall — 100% of
# issued requests must commit, invariants must hold on every replica,
# and the live census must match the schedule recomputed from the seed.


# Per-frame fault probabilities.  Calibrated to the BUNDLE-ingest frame
# dynamics: the batch runtime coalesces harder (one transport frame now
# carries a whole drained bundle), so the soak sees roughly half the
# seeded frames the per-task runtime did — ~90-110 on this container.
# corrupt at the old 0.008 had E[corrupt] ~ 0.7 there and legitimately
# came up zero; the raised rates also exercise corrupt's bigger blast
# radius (one flipped byte now rejects a whole coalesced bundle at
# split_multi), which the retransmit/replay paths must — and do —
# absorb.  The per-kind `>= 1 injected` assertion additionally gates on
# expected count at the observed frame volume (see the soak), so
# run-to-run frame-count swings can never turn a fair zero into a flake.
CHAOS_PLAN = FaultPlan(
    drop=0.03,
    delay=0.10,
    delay_s=(0.0005, 0.008),
    duplicate=0.03,
    reorder=0.05,
    corrupt=0.025,
    reset=0.004,
)


def test_chaos_soak_commits_under_faults():
    seed = chaos_seed(default=0xC4A05)

    async def run():
        net = FaultNet(seed=seed, default_plan=CHAOS_PLAN)
        cfg = SimpleConfiger(
            n=4, f=1, timeout_request=_t(0.8), timeout_prepare=_t(0.4),
            timeout_viewchange=_t(1.0),
        )
        replicas, c_auths, stubs, ledgers = await make_cluster(
            cfg=cfg, wrap_conn=lambda i, c: net.wrap(c, f"r{i}")
        )
        checker = InvariantChecker(replicas, ledgers)
        client = new_client(
            0, 4, 1, c_auths[0],
            net.wrap(InProcessClientConnector(stubs), "c0"),
            retransmit_interval=_t(0.4), max_inflight=8,
        )
        await client.start()
        accepted = []

        async def issue(tag, k, timeout=90):
            ops = [b"chaos-%s-%d" % (tag, i) for i in range(k)]
            results = await asyncio.gather(
                *[client.request(op, timeout=_t(timeout)) for op in ops]
            )
            accepted.extend(zip(ops, results))

        try:
            # Phase A: seeded chaos only (drop/delay/dup/reorder/corrupt).
            _log.warning("chaos phase A: 8 requests under seeded plan")
            await issue(b"a", 8)
            # Invariants hold MID-run: prefix consistency and UI
            # integrity are instant properties.  Committed-results is a
            # CONVERGENCE property (f+1 replies prove only f+1 replicas
            # executed; the rest legitimately lag under chaos), so give
            # the laggards a bounded catch-up before holding every
            # ledger to the accepted set.
            checker.check()
            deadline = asyncio.get_running_loop().time() + 45
            while asyncio.get_running_loop().time() < deadline:
                if all(lg.length >= len(accepted) for lg in ledgers):
                    break
                await asyncio.sleep(0.05)
            checker.check(accepted)

            # Phase B: partition {r0,r1} | {r2,r3} while traffic flows
            # (the majority-side primary keeps committing), then heal.
            _log.warning("chaos phase B: partition {r0,r1}|{r2,r3} + 6 requests")
            net.partition({"r0", "r1"}, {"r2", "r3"})
            issue_b = asyncio.ensure_future(issue(b"b", 6))
            await asyncio.sleep(1.5)
            net.heal_partition()
            _log.warning("chaos phase B: partition healed")
            t_heal = asyncio.get_running_loop().time()
            await issue_b
            # Recovery latency: heal → every partition-spanning request
            # client-accepted.
            recovery_after_heal_s = (
                asyncio.get_running_loop().time() - t_heal
            )

            # Let the post-partition view settle cluster-wide before
            # picking the primary to stall.
            deadline = asyncio.get_running_loop().time() + 30
            view = 0
            while asyncio.get_running_loop().time() < deadline:
                views = []
                for r in replicas:
                    cur, _ = await r.handlers.view_state.hold_view()
                    views.append(cur)
                if len(set(views)) == 1:
                    view = views[0]
                    break
                await asyncio.sleep(0.1)

            # Phase C: stall the CURRENT primary (half-open — streams
            # stay connected, frames stop) → request timeouts must
            # depose it and commits continue in the next view.
            primary = view % 4
            _log.warning(
                "chaos phase C: settled view %d, stalling primary r%d",
                view, primary,
            )
            net.stall_replica(primary)
            await issue(b"c", 6)
            # Commits resume with the new primary + one backup (f+1), so
            # the third survivor may legitimately still be applying the
            # NEW-VIEW when the batch resolves — poll, don't snapshot.
            survivors = [r for r in replicas if r.id != primary]
            deadline = asyncio.get_running_loop().time() + _t(30)
            views = {}
            while asyncio.get_running_loop().time() < deadline:
                for r in survivors:
                    cur, _ = await r.handlers.view_state.hold_view()
                    views[r.id] = cur
                if all(v > view for v in views.values()):
                    break
                await asyncio.sleep(0.05)
            assert all(v > view for v in views.values()), (
                f"survivors still at {views} (stalled primary {primary} "
                f"not deposed past view {view})"
            )
            net.unstall_replica(primary)

            # Freeze the seeded census NOW (heal clears the plan, and
            # post-heal frames draw from the zero plan).
            frames_snapshot = dict(net.census.frames)
            live_seeded = dict(net.census.seeded_counts())

            # Phase D: heal + reset every stream (redials replay full
            # logs — the convergence step), then a clean tail batch.
            _log.warning("chaos phase D: heal + reset_all + 4 requests")
            net.heal()
            net.reset_all()
            await issue(b"d", 4, timeout=60)

            # 100% of issued requests committed...
            assert len(accepted) == 24
            assert all(res for _, res in accepted)
            # ...on EVERY replica (the stalled ex-primary catches up).
            deadline = asyncio.get_running_loop().time() + 60
            while asyncio.get_running_loop().time() < deadline:
                if all(lg.length >= len(accepted) for lg in ledgers):
                    break
                await asyncio.sleep(0.1)
            lengths = [lg.length for lg in ledgers]
            assert all(l >= len(accepted) for l in lengths), lengths

            # Safety invariants across ALL replicas at teardown.
            summary = checker.check(accepted)
            assert summary["accepted_checked"] == 24

            # The faults really happened... asserted per kind only when
            # its EXPECTED count at the run's observed frame volume makes
            # a zero impossible-in-practice (E >= 5 -> P(zero) < 1%).
            # Frame volume is timing-dependent (bundle coalescing, host
            # load): a quiet run legitimately draws zero events of a
            # low-probability kind, and that is the seeded schedule
            # working, not a missing fault injector — the determinism
            # cross-check below (replayed == live) covers those kinds
            # exactly.  High-volume runs (CI's full-size soak) clear the
            # gate for every kind and keep the assertion's full strength.
            seeded_frames = sum(frames_snapshot.values())
            for kind, p in (
                ("drop", CHAOS_PLAN.drop),
                ("delay", CHAOS_PLAN.delay),
                ("duplicate", CHAOS_PLAN.duplicate),
                ("reorder", CHAOS_PLAN.reorder),
                ("corrupt", CHAOS_PLAN.corrupt),
            ):
                if seeded_frames * p >= 5.0:
                    assert net.census.counters.get(kind, 0) >= 1, (
                        kind, seeded_frames, net.census.counters)
            assert net.census.counters.get("stall", 0) >= 1
            assert net.census.counters.get("partition", 0) >= 1
            # ...and followed the seed's deterministic schedule exactly:
            # the same MINBFT_CHAOS_SEED + the same frame counts always
            # reproduce these per-kind injection counts.
            replayed = net.replay_counts(frames_snapshot, plan=CHAOS_PLAN)
            assert replayed == live_seeded, (replayed, live_seeded)
            out = net.census.snapshot()
            out["seed"] = seed
            out["time_scale"] = TIME_SCALE
            out["requests_committed"] = len(accepted)
            out["recovery_after_heal_s"] = round(recovery_after_heal_s, 3)
            return out
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()

    try:
        census = asyncio.run(run())
    except BaseException:
        print(f"replay with MINBFT_CHAOS_SEED={seed}")
        raise
    assert census["frames_total"] > 0


# ---------------------------------------------------------------------------
# tests/test_byzantine.py on the port.


async def _inject_peer_messages(stub, attacker, payloads) -> None:
    """Open a peer stream to the stub's replica (as the reference's HELLO
    handshake does) and pump crafted payloads into it.  ``attacker`` is
    the byzantine INSIDER replica whose stream this impersonates — the
    HELLO must carry its genuine signature now that the handshake is
    authenticated (an outsider without any replica key is refused at
    HELLO; see test_handlers_unit.test_id_spoofing_hello_is_refused)."""
    handler = stub.peer_message_stream_handler()
    done = asyncio.Event()

    async def outgoing():
        hello = Hello(replica_id=attacker.id)
        attacker.handlers.sign_message(hello)
        yield marshal(hello)
        for p in payloads:
            yield p
        # keep the stream open briefly so the payloads are consumed
        try:
            await asyncio.wait_for(done.wait(), 1.0)
        except asyncio.TimeoutError:
            return

    consumed = asyncio.ensure_future(_drain(handler.handle_message_stream(outgoing())))
    await asyncio.sleep(0.3)
    done.set()
    consumed.cancel()
    try:
        await consumed
    except (asyncio.CancelledError, Exception):
        pass


async def _drain(aiter):
    async for _ in aiter:
        pass


def test_cluster_survives_forged_and_malformed_peer_messages():
    async def run():
        replicas, c_auths, stubs, ledgers = await make_cluster()
        client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs))
        await client.start()

        # a healthy commit first
        assert await asyncio.wait_for(client.request(b"before-attack"), 30)

        # craft garbage from "replica 2" aimed at replica 1:
        fake_req = Request(client_id=0, seq=999, operation=b"evil", signature=b"x" * 64)
        fake_prep = Prepare(
            replica_id=0, view=0, requests=[fake_req],
            ui=UI(counter=77, cert=b"\x01" * 40),
        )
        payloads = [
            b"\xff\x00garbage-not-a-message",          # malformed wire bytes
            marshal(fake_prep),                          # forged primary UI
            marshal(
                Commit(replica_id=2, prepare=fake_prep, ui=UI(counter=9, cert=b"z" * 40))
            ),                                           # forged commit
            marshal(fake_req),                           # forged client sig via peer stream
        ]
        dropped_before = replicas[1].metrics.counters.get("messages_dropped", 0)
        await _inject_peer_messages(stubs[1], replicas[2], payloads)

        # give the drops a moment to be accounted
        for _ in range(100):
            if replicas[1].metrics.counters.get("messages_dropped", 0) >= dropped_before + 3:
                break
            await asyncio.sleep(0.02)
        assert replicas[1].metrics.counters.get("messages_dropped", 0) >= dropped_before + 3

        # the cluster is still live and consistent
        assert await asyncio.wait_for(client.request(b"after-attack"), 30)
        for _ in range(200):
            if all(lg.length == 2 for lg in ledgers):
                break
            await asyncio.sleep(0.02)
        assert all(lg.length == 2 for lg in ledgers), [lg.length for lg in ledgers]
        # no forged operation ever executed
        for lg in ledgers:
            ops = [lg.block(h).payload for h in range(1, lg.length + 1)]
            assert all(b"evil" not in op for op in ops), ops

        await client.stop()
        for r in replicas:
            await r.stop()

    asyncio.run(run())


def test_replayed_commit_is_idempotent():
    """A replica re-delivering its COMMIT (network duplication) must not
    double-execute (in-order once-only UI capture)."""

    async def run():
        replicas, c_auths, stubs, ledgers = await make_cluster()
        client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs))
        await client.start()
        assert await asyncio.wait_for(client.request(b"op"), 30)
        for _ in range(100):
            if all(lg.length == 1 for lg in ledgers):
                break
            await asyncio.sleep(0.02)

        # replay replica 2's genuine COMMIT at replica 1
        commits = [
            m for m in replicas[2].handlers.message_log.snapshot()
            if isinstance(m, Commit)
        ]
        assert commits
        handled_before = replicas[1].metrics.counters.get("messages_handled", 0)
        await _inject_peer_messages(stubs[1], replicas[2], [marshal(commits[0])] * 3)
        # positive delivery signal: the replays were actually handled
        # (validated, then deduplicated by in-order UI capture) — without
        # this the test could pass vacuously if injection silently failed
        for _ in range(100):
            if (
                replicas[1].metrics.counters.get("messages_handled", 0)
                >= handled_before + 3
            ):
                break
            await asyncio.sleep(0.02)
        assert (
            replicas[1].metrics.counters.get("messages_handled", 0)
            >= handled_before + 3
        )
        await asyncio.sleep(0.2)
        assert ledgers[1].length == 1  # no double execution

        await client.stop()
        for r in replicas:
            await r.stop()

    asyncio.run(run())


@pytest.mark.parametrize("package", ["port", "ref"])
def test_checker_right_after_the_quorum_can_see_a_correct_laggard(package):
    """The cause of the two reference failures, made deterministic, on a
    cluster of each package: hold
    back every frame into the primary (a stall, no loss).  The backups
    still execute on the PREPARE plus their own COMMIT and reply, so the
    client accepts with f + 1 replies while the correct primary has not
    executed: the checker, run at that moment, reports it missing.  Once
    the frames flow, the primary executes and the same check passes —
    a race in when the check runs, not a safety fault."""
    if package == "ref":
        from conftest import make_cluster as cluster
        from minbft_tpu.client import new_client as mk_client
        from minbft_tpu.sample.conn.inprocess import InProcessClientConnector as conn
        from minbft_tpu.testing import FaultNet as Net
        from minbft_tpu.testing import InvariantChecker as Checker
        from minbft_tpu.testing import InvariantViolation
    else:
        from minbft_tpu_torch.testing import InvariantViolation

        cluster, mk_client, conn = make_cluster, new_client, InProcessClientConnector
        Net, Checker = FaultNet, InvariantChecker

    async def run():
        net = Net(seed=chaos_seed(default=0x1A6))
        replicas, c_auths, stubs, ledgers = await cluster(
            wrap_conn=lambda i, c: net.wrap(c, f"r{i}")
        )
        client = mk_client(0, 4, 1, c_auths[0], conn(stubs))
        await client.start()
        try:
            # Streams up and every ledger at one block before the stall.
            accepted = [(b"warm-op", await asyncio.wait_for(
                client.request(b"warm-op"), 30))]
            assert await _executed(ledgers, range(4), 1)
            net.stall(dst="r0")
            res = await asyncio.wait_for(client.request(b"laggard-op"), 30)
            accepted.append((b"laggard-op", res))
            assert ledgers[0].length == 1  # the correct primary lags
            with pytest.raises(InvariantViolation, match="replica 0: client-accepted"):
                Checker(replicas, ledgers).check(accepted)
            net.unstall(dst="r0")
            assert await _executed(ledgers, range(4), 2)
            Checker(replicas, ledgers).check(accepted)
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()
        return True

    assert asyncio.run(run())
