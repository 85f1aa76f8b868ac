"""The port's pairwise-MAC authenticator
(minbft_tpu_torch/sample/authentication/mac.py) against the reference's
(minbft_tpu/sample/authentication/mac.py), on the CPU.

1. Under one set of pairwise keys (the reference's ``MacKeys``, carried
   across by ``mac_keys_from``), both packages make byte-identical
   REQUEST vectors, REPLY MACs and REQ-VIEW-CHANGE vectors, each accepts
   the other's, and a flipped bit in a replica's slot is rejected by that
   replica only.
2. A port cluster (n = 4, f = 1, HMAC USIG) commits under MACs on a CPU
   engine: every MAC and UI check goes through the engine's HMAC queue
   (the plain K6).
3. A mixed cluster of 2 reference and 2 port replicas commits under MACs
   with equal ledgers, either side holding the primary.

Keys are made from a numpy seed; all comparisons are exact."""

import asyncio

import numpy as np
import pytest

from minbft_tpu import api as ref_api
from minbft_tpu.sample.authentication.mac import MacAuthenticator as RefMacAuthenticator
from minbft_tpu.sample.authentication.mac import MacKeys as RefMacKeys
from minbft_tpu_torch import api
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.sample.authentication import (
    MacAuthenticator,
    mac_authenticators_from_keys,
    mac_keys_from,
)
from minbft_tpu_torch.sample.authentication.authenticator import make_test_keys
from test_torch_cluster import _commit
from test_torch_slice import _SeededRng, _reference_authenticators

CLIENT, REPLICA = api.AuthenticationRole.CLIENT, api.AuthenticationRole.REPLICA


def _ref_mac_keys(seed: int, n: int, n_clients: int) -> RefMacKeys:
    """The reference's pairwise key material, drawn from a numpy seed."""
    g = np.random.default_rng(seed)
    return RefMacKeys(
        {(c, r): g.bytes(32) for c in range(n_clients) for r in range(n)},
        {(i, j): g.bytes(32) for i in range(n) for j in range(i + 1, n)},
    )


def _both(ref_keys, n, n_clients):
    """(port replicas, port clients, reference replicas, reference
    clients) of MAC authenticators over the same pairwise keys, no
    USIG."""
    port_keys = mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair)
    port = (
        [MacAuthenticator(i, False, n, port_keys.view_for_replica(i)) for i in range(n)],
        [MacAuthenticator(c, True, n, port_keys.view_for_client(c)) for c in range(n_clients)],
    )
    ref = (
        [RefMacAuthenticator(i, False, n, ref_keys.view_for_replica(i)) for i in range(n)],
        [RefMacAuthenticator(c, True, n, ref_keys.view_for_client(c)) for c in range(n_clients)],
    )
    return (*port, *ref)


def _flip(tag: bytes, at: int) -> bytes:
    return tag[:at] + bytes([tag[at] ^ 1]) + tag[at + 1 :]


def test_tags_are_byte_identical_across_packages():
    n, n_clients = 4, 2
    p_rep, p_cli, r_rep, r_cli = _both(_ref_mac_keys(8, n, n_clients), n, n_clients)
    msg = b"authen bytes of a message"
    ref_client, ref_replica = ref_api.AuthenticationRole.CLIENT, ref_api.AuthenticationRole.REPLICA
    for c in range(n_clients):
        req = p_cli[c].generate_message_authen_tag(CLIENT, msg)
        assert req == r_cli[c].generate_message_authen_tag(ref_client, msg)
        assert len(req) == n * 32
    for i in range(n):
        rvc = p_rep[i].generate_message_authen_tag(REPLICA, msg)
        assert rvc == r_rep[i].generate_message_authen_tag(ref_replica, msg)
        assert rvc[i * 32 : (i + 1) * 32] == bytes(32)
        for c in range(n_clients):
            reply = p_rep[i].generate_message_authen_tag(REPLICA, msg, audience=c)
            assert reply == r_rep[i].generate_message_authen_tag(ref_replica, msg, audience=c)

    async def cross():
        # Each package accepts the other's tags; a flipped bit in replica
        # 2's slot of a REQUEST vector is rejected by replica 2 only.
        req = r_cli[1].generate_message_authen_tag(ref_client, msg)
        for r in range(n):
            await p_rep[r].verify_message_authen_tag(CLIENT, 1, msg, req)
        bad = _flip(req, 2 * 32)
        await p_rep[1].verify_message_authen_tag(CLIENT, 1, msg, bad)
        with pytest.raises(api.AuthenticationError):
            await p_rep[2].verify_message_authen_tag(CLIENT, 1, msg, bad)
        reply = p_rep[3].generate_message_authen_tag(REPLICA, msg, audience=0)
        await r_cli[0].verify_message_authen_tag(ref_replica, 3, msg, reply)
        with pytest.raises(api.AuthenticationError):
            await p_cli[1].verify_message_authen_tag(REPLICA, 3, msg, reply)
        rvc = r_rep[0].generate_message_authen_tag(ref_replica, msg)
        await p_rep[2].verify_message_authen_tag(REPLICA, 0, msg, rvc)
        with pytest.raises(api.AuthenticationError):
            await p_rep[2].verify_message_authen_tag(REPLICA, 0, msg, _flip(rvc, 2 * 32 + 5))

    asyncio.run(cross())


def test_mac_keys_from_refuses_malformed_material():
    with pytest.raises(ValueError):
        mac_keys_from({(0, 0): b"short"}, {})
    with pytest.raises(ValueError):
        mac_keys_from({}, {(1, 0): bytes(32)})


def test_port_cluster_commits_under_macs_on_a_cpu_engine():
    keys = make_test_keys(4, 1, "hmac", rng=_SeededRng(41))
    mac_keys = mac_keys_from(*vars(_ref_mac_keys(41, 4, 1)).values())
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    auths = mac_authenticators_from_keys(keys, mac_keys, 1, engine=engine, client_engine=engine)
    ops = [[b"op-%d" % k for k in range(3)]]
    replies, ledgers = asyncio.run(_commit(range(4), keys, 1, ops, ["port"], port_auths=auths))
    assert [led.length for led in ledgers] == [3] * 4
    assert len({led.state_digest() for led in ledgers}) == 1
    assert replies == [[ledgers[0].block(h).digest() for h in (1, 2, 3)]]
    q = engine.stats["hmac_sha256"]
    # REQUEST slots (4 per request), REPLY MACs at the client (4 per
    # request) and the UIs of PREPARE and COMMIT, all through plain K6.
    assert q.items >= 3 * 8 and q.dispatch_timeouts == 0
    assert set(engine.stats) == {"hmac_sha256"}


@pytest.mark.parametrize("primary", ["port", "ref"])
def test_mixed_cluster_commits_under_macs_with_equal_ledgers(primary):
    n, n_clients = 4, 2
    keys = make_test_keys(n, n_clients, "hmac", rng=_SeededRng(42))
    ref_keys = _ref_mac_keys(42, n, n_clients)
    port_auths = mac_authenticators_from_keys(
        keys, mac_keys_from(ref_keys.client_replica, ref_keys.replica_pair), n_clients
    )
    inner, _, _ = _reference_authenticators(keys)
    ref_auths = (
        [RefMacAuthenticator(i, False, n, ref_keys.view_for_replica(i), inner=inner[i])
         for i in range(n)],
        [RefMacAuthenticator(c, True, n, ref_keys.view_for_client(c)) for c in range(n_clients)],
    )
    port_ids = (0, 1) if primary == "port" else (2, 3)
    ops = [[b"port-%d" % k for k in range(3)], [b"ref-%d" % k for k in range(3)]]
    replies, ledgers = asyncio.run(_commit(
        port_ids, keys, 1, ops, ["port", "ref"], port_auths=port_auths, ref_auths=ref_auths,
    ))
    assert [led.length for led in ledgers] == [6] * 4
    assert len({led.state_digest() for led in ledgers}) == 1
    chain = [ledgers[0].block(h).payload for h in range(1, 7)]
    assert sorted(chain) == sorted(ops[0] + ops[1])
    for c, ops_c in enumerate(ops):
        for op, rep in zip(ops_c, replies[c]):
            assert ledgers[0].block(chain.index(op) + 1).digest() == rep
