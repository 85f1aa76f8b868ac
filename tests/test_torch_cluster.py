"""The port's replica core, client and in-process transport against the
JAX package's, on the CPU.

1. A port cluster and a reference cluster (n = 4, f = 1, HMAC USIG, no
   engine) built from one key dict commit the same 3 serial requests of
   one client: the block digests the clients receive and the replicas'
   final state digests are identical.
2. A mixed cluster: 2 reference replicas and 2 port replicas on one set
   of in-process stubs commit the same requests from a port client and a
   reference client with equal ledgers, with either side holding the
   primary (replica 0), under ECDSA and HMAC USIGs.
3. The cluster that chip_smoke.py drives on the card, at n = 3, f = 1,
   HMAC USIG, 1 request and 2 forged REQUESTs, on one shared CPU engine:
   its UI checks go through the plain K6 and its signature checks through
   the plain K2.
4. A replica whose engine fails to sign its REPLY loses that REPLY and
   signs nothing on the host; the other replicas' REPLYs carry the
   client.

Keys are made from a numpy seed; all comparisons are exact."""

import asyncio
import logging

import pytest

import chip_smoke
from test_torch_slice import _SeededRng, _reference_authenticators

from minbft_tpu.client import new_client as ref_new_client
from minbft_tpu.core import new_replica as ref_new_replica
from minbft_tpu.sample.config import SimpleConfiger as RefConfiger
from minbft_tpu.sample.requestconsumer import SimpleLedger as RefLedger
from minbft_tpu_torch.client import new_client
from minbft_tpu_torch.core import new_replica
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.sample.authentication import authenticators_from_keys
from minbft_tpu_torch.sample.authentication.authenticator import make_test_keys
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.sample.conn.inprocess import (
    InProcessClientConnector,
    InProcessPeerConnector,
    make_testnet_stubs,
)
from minbft_tpu_torch.sample.requestconsumer import SimpleLedger

_TIMEOUT = 60.0


async def _commit(
    port_ids, keys, f, ops_by_client, client_sides, port_auths=None, settled=lambda: True
):
    """Start an n-replica cluster on the port's stubs, replica i from the
    port if ``i in port_ids`` else from the reference, one client per
    entry of ``client_sides`` ("port" or "ref"); each client commits its
    operations serially.  The port's side takes ``port_auths`` (replica
    and client authenticators) if given, else host authenticators from
    ``keys``.  The cluster stops once every ledger holds every operation
    and ``settled()`` is true.  Returns (replies per client, ledgers)."""
    n = keys["n"]
    port_r, port_c = port_auths or authenticators_from_keys(keys)
    ref_r, ref_c, _ = _reference_authenticators(keys)
    stubs = make_testnet_stubs(n)
    ledgers, replicas = [], []
    for i in range(n):
        if i in port_ids:
            cfg = SimpleConfiger(n=n, f=f, timeout_request=_TIMEOUT, timeout_prepare=_TIMEOUT / 2)
            ledger = SimpleLedger()
            r = new_replica(i, cfg, port_r[i], InProcessPeerConnector(stubs), ledger)
        else:
            cfg = RefConfiger(n=n, f=f, timeout_request=_TIMEOUT, timeout_prepare=_TIMEOUT / 2)
            ledger = RefLedger()
            r = ref_new_replica(i, cfg, ref_r[i], InProcessPeerConnector(stubs), ledger)
        stubs[i].assign_replica(r)
        replicas.append(r)
        ledgers.append(ledger)
    for r in replicas:
        await r.start()
    clients = []
    for c, side in enumerate(client_sides):
        make = new_client if side == "port" else ref_new_client
        auth = port_c[c] if side == "port" else ref_c[c]
        cl = make(c, n, f, auth, InProcessClientConnector(stubs), seq_start=0)
        await cl.start()
        clients.append(cl)

    async def serial(cl, ops):
        return [await asyncio.wait_for(cl.request(op), _TIMEOUT) for op in ops]

    replies = await asyncio.gather(*[serial(cl, ops) for cl, ops in zip(clients, ops_by_client)])
    total = sum(len(ops) for ops in ops_by_client)
    for _ in range(int(_TIMEOUT / 0.02)):
        if all(led.length == total for led in ledgers) and settled():
            break
        await asyncio.sleep(0.02)
    for cl in clients:
        await cl.stop()
    for r in replicas:
        await r.stop()
    return replies, ledgers


def test_port_cluster_commits_byte_identically_to_the_reference():
    keys = make_test_keys(4, 1, "hmac", rng=_SeededRng(21))
    ops = [[b"op-%d" % k for k in range(3)]]
    port_replies, port_ledgers = asyncio.run(_commit(range(4), keys, 1, ops, ["port"]))
    ref_replies, ref_ledgers = asyncio.run(_commit((), keys, 1, ops, ["ref"]))
    assert port_replies == ref_replies
    assert len(set(port_replies[0])) == 3
    digests = {led.state_digest() for led in port_ledgers + ref_ledgers}
    assert digests == {port_replies[0][-1]}
    for led in port_ledgers + ref_ledgers:
        assert [led.block(h).payload for h in range(1, 4)] == ops[0]


@pytest.mark.parametrize("usig_kind", ["ecdsa", "hmac"])
@pytest.mark.parametrize("primary", ["port", "ref"])
def test_mixed_cluster_commits_with_equal_ledgers(primary, usig_kind):
    keys = make_test_keys(4, 2, usig_kind, rng=_SeededRng(22))
    port_ids = (0, 1) if primary == "port" else (2, 3)
    ops = [[b"port-%d" % k for k in range(3)], [b"ref-%d" % k for k in range(3)]]
    replies, ledgers = asyncio.run(_commit(port_ids, keys, 1, ops, ["port", "ref"]))
    assert [led.length for led in ledgers] == [6] * 4
    assert len({led.state_digest() for led in ledgers}) == 1
    chains = {tuple(led.block(h).payload for h in range(1, 7)) for led in ledgers}
    assert len(chains) == 1
    chain = chains.pop()
    assert sorted(chain) == sorted(ops[0] + ops[1])
    # Every reply is the digest of the block that holds its operation.
    for c, ops_c in enumerate(ops):
        for op, rep in zip(ops_c, replies[c]):
            assert ledgers[0].block(chain.index(op) + 1).digest() == rep


def test_cluster_driver_on_a_shared_cpu_engine():
    keys = make_test_keys(3, 2, "hmac", rng=_SeededRng(23))
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    # The core seeds the engine with a bundle's REQUEST signatures only
    # through an authenticator that batches them (message_handling).
    assert authenticators_from_keys(keys, engine=engine)[0][0].supports_batch_verify
    assert not authenticators_from_keys(keys)[0][0].supports_batch_verify
    no_window = (lambda: None, lambda: None)
    result = asyncio.run(chip_smoke.run_cluster(keys, 1, engine, 1, 1, 1, no_window, forged=2))
    chip_smoke.check_cluster(result, "cpu cluster")
    assert result["ledger_lengths"] == [1, 1, 1]
    assert result["dropped"] == [2, 2, 2] and result["replies_to_forged"] == 0
    hmac_q, ecdsa_q = engine.stats["hmac_sha256"], engine.stats["ecdsa_p256"]
    # PREPARE and COMMIT UIs through the HMAC queue (plain K6), REQUEST
    # and REPLY signatures through the ECDSA queue (plain K2).
    assert hmac_q.items >= 2 and ecdsa_q.items >= 3
    for st in (hmac_q, ecdsa_q):
        assert st.dispatch_timeouts == 0


def test_failed_reply_signature_is_not_redone_on_the_host():
    keys = make_test_keys(3, 1, "hmac", rng=_SeededRng(24))
    failing = BatchVerifier(max_batch=8, buckets=(8,), device="cpu", sign_on_device=True)

    def sign_kernel_fails(items):
        raise RuntimeError("k*G kernel failed")

    failing._dispatch_sign_ecdsa = sign_kernel_fails
    r_auths, c_auths = authenticators_from_keys(keys)
    r_auths[2] = authenticators_from_keys(keys, engine=failing)[0][2]
    host_signed = []
    sign = r_auths[2].generate_message_authen_tag

    def recording_sign(role, msg, audience=-1):
        # A REPLY is addressed to its client.  USIG certificates and the
        # control plane (HELLO on each peer link) are signed here by design.
        if audience >= 0:
            host_signed.append(role)
        return sign(role, msg, audience)

    r_auths[2].generate_message_authen_tag = recording_sign
    # On the replica's own logger: another test may have turned off its
    # propagation to the root logger.
    errors = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda rec: errors.append(rec.getMessage())
    replica_log = logging.getLogger("minbft.replica2")
    replica_log.addHandler(handler)
    ops = [[b"op-0"]]
    try:
        # Replica 2 learns of the failed batch on its own time: wait for
        # the record before the cluster stops.
        replies, ledgers = asyncio.run(_commit(
            range(3), keys, 1, ops, ["port"], port_auths=(r_auths, c_auths),
            settled=lambda: bool(errors),
        ))
    finally:
        replica_log.removeHandler(handler)
    assert replies == [[ledgers[0].block(1).digest()]]
    assert [led.length for led in ledgers] == [1, 1, 1]
    assert host_signed == []
    assert failing.sign_stats["ecdsa_p256"].host_fallback_items == 0
    assert any("batched REPLY signing failed" in m for m in errors)
