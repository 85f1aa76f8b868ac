"""The port's authentication slice as a whole against the JAX package.

- codec ``marshal`` and ``authen_bytes`` of the same REQUEST, PREPARE,
  COMMIT and REPLY are byte-identical between the packages;
- under the same keys (one dict of key material,
  ``authenticators_from_keys`` for the port and the reference's own
  classes for the reference), messages the reference signs are accepted
  by the port's authenticators (CPU engine: the plain K2/K3), messages
  the port signs are accepted by the reference's, and tampered copies are
  rejected by both with equal verdict vectors; a port USIG continues the
  counter of its reference twin;
- the authentication flow that chip_smoke.py drives on the card runs on
  the CPU at n = 4, 1 client, 8 requests, PREPAREs of 4;
- importing every port module loads neither jax nor the JAX package.

Inputs are made from a numpy seed; all comparisons are exact."""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from minbft_tpu import api as ref_api
from minbft_tpu import messages as ref_msgs
from minbft_tpu.sample.authentication.authenticator import (
    SampleAuthenticator as RefAuthenticator,
)
from minbft_tpu.usig.software import EcdsaUSIG as RefEcdsaUSIG
from minbft_tpu.usig.software import HmacUSIG as RefHmacUSIG
from minbft_tpu_torch import api
from minbft_tpu_torch import messages as port_msgs
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.sample.authentication import (
    authenticators_from_keys,
    new_test_authenticators,
)
from minbft_tpu_torch.sample.authentication.authenticator import (
    make_test_keys,
    pub_from_row,
)

CLIENT = api.AuthenticationRole.CLIENT
REPLICA = api.AuthenticationRole.REPLICA
USIG = api.AuthenticationRole.USIG


class _SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def randbelow(self, n):
        return int.from_bytes(self._g.bytes(40), "little") % n


def _messages(m):
    """REQUEST, PREPARE, COMMIT and REPLY of one package ``m``, built from
    the same field values."""
    reqs = [
        m.Request(client_id=0, seq=s, operation=b"op-%d" % s, signature=b"\x01" * 64)
        for s in (1, 2)
    ]
    prep = m.Prepare(
        replica_id=0, view=3, requests=reqs,
        ui=m.UI(counter=7, cert=b"\x02" * 72),
    )
    commit = m.Commit(replica_id=2, prepare=prep, ui=m.UI(counter=5, cert=b"\x03" * 72))
    reply = m.Reply(
        replica_id=1, client_id=0, seq=2, result=b"res", signature=b"\x04" * 64
    )
    return {"REQUEST": reqs[0], "PREPARE": prep, "COMMIT": commit, "REPLY": reply}


@pytest.mark.parametrize("kind", ["REQUEST", "PREPARE", "COMMIT", "REPLY"])
def test_codec_and_authen_bytes_are_byte_identical(kind):
    ours, theirs = _messages(port_msgs)[kind], _messages(ref_msgs)[kind]
    assert port_msgs.marshal(ours) == ref_msgs.marshal(theirs)
    assert port_msgs.authen_bytes(ours) == ref_msgs.authen_bytes(theirs)
    back = port_msgs.unmarshal(ref_msgs.marshal(theirs))
    assert port_msgs.marshal(back) == ref_msgs.marshal(theirs)


def _reference_authenticators(keys):
    """The reference's replica and client authenticators (host
    verification, no engine) under the key dict ``keys``, with its
    signature scheme (``keys["scheme"]``, ECDSA-P256 when absent) and ECDSA
    or HMAC USIGs (``keys["usig_kind"]``) carrying the same key, epoch and
    counter as the port's."""
    n = keys["n"]
    scheme = keys.get("scheme", "ecdsa-p256")
    pub = pub_from_row if scheme == "ecdsa-p256" else bytes
    replica_pubs = {i: pub(r) for i, r in enumerate(keys["replica_pub"])}
    client_pubs = {i: pub(r) for i, r in enumerate(keys["client_pub"])}
    usigs = []
    for i in range(n):
        if keys["usig_kind"] == "ecdsa":
            u = RefEcdsaUSIG(keys["usig_priv"][i], epoch=keys["usig_epoch"][i])
        else:
            u = RefHmacUSIG(keys["usig_key"], epoch=keys["usig_epoch"][i])
        u._counter = keys["usig_counter"][i]
        usigs.append(u)
    usig_ids = {i: u.id() for i, u in enumerate(usigs)}
    replicas = [
        RefAuthenticator(
            scheme=scheme,
            replica_priv=keys["replica_priv"][i], replica_pubs=replica_pubs,
            client_pubs=client_pubs, usig=usigs[i], usig_ids=usig_ids,
            own_replica_id=i,
        )
        for i in range(n)
    ]
    clients = [
        RefAuthenticator(
            scheme=scheme, client_priv=d, replica_pubs=replica_pubs,
            client_pubs=client_pubs,
        )
        for d in keys["client_priv"]
    ]
    return replicas, clients, usigs


def _tampered(tag):
    return tag[:-1] + bytes([tag[-1] ^ 1])


@pytest.fixture(scope="module")
def cross():
    """Sign with one package, verify with the other, honest and tampered."""
    keys = make_test_keys(4, 1, rng=_SeededRng(4))
    ref_r, ref_c, ref_usigs = _reference_authenticators(keys)
    msgs = _messages(ref_msgs)
    ab = {k: ref_msgs.authen_bytes(v) for k, v in msgs.items()}
    # The reference signs: client REQUEST, replica 1 REPLY, replica 0's
    # USIG certifies the PREPARE, replica 2's the COMMIT.
    ref_tags = {
        "REQUEST": ref_c[0].generate_message_authen_tag(ref_api.AuthenticationRole.CLIENT, ab["REQUEST"]),
        "REPLY": ref_r[1].generate_message_authen_tag(ref_api.AuthenticationRole.REPLICA, ab["REPLY"]),
        "PREPARE": ref_r[0].generate_message_authen_tag(ref_api.AuthenticationRole.USIG, ab["PREPARE"]),
        "COMMIT": ref_r[2].generate_message_authen_tag(ref_api.AuthenticationRole.USIG, ab["COMMIT"]),
    }
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu", sign_on_device=True)
    port_r, port_c = authenticators_from_keys(keys, engine=engine, client_engine=engine)

    async def port_verdicts(tags):
        async def one(auth, role, peer, kind, tag):
            try:
                await auth.verify_message_authen_tag(role, peer, ab[kind], tag)
            except api.AuthenticationError:
                return False
            return True

        checks = [
            (port_r[3], CLIENT, 0, "REQUEST"),
            (port_c[0], REPLICA, 1, "REPLY"),
            (port_r[3], USIG, 0, "PREPARE"),
            (port_r[3], USIG, 2, "COMMIT"),
        ]
        return await asyncio.gather(*[
            one(a, role, peer, kind, t)
            for a, role, peer, kind in checks
            for t in (tags[kind], _tampered(tags[kind]))
        ])

    port_on_ref = asyncio.run(port_verdicts(ref_tags))

    # The port signs under the same keys; its USIGs resume the counters
    # the reference's twins reached.
    keys["usig_counter"] = [u._counter for u in ref_usigs]
    port_r2, port_c2 = authenticators_from_keys(keys, engine=engine, client_engine=engine)

    async def port_sign():
        return await asyncio.gather(
            port_c2[0].generate_message_authen_tag_async(CLIENT, ab["REQUEST"]),
            port_r2[1].generate_message_authen_tag_async(REPLICA, ab["REPLY"]),
        )

    req_tag, reply_tag = asyncio.run(port_sign())
    port_tags = {
        "REQUEST": req_tag,
        "REPLY": reply_tag,
        "PREPARE": port_r2[0].generate_message_authen_tag(USIG, ab["PREPARE"]),
        "COMMIT": port_r2[2].generate_message_authen_tag(USIG, ab["COMMIT"]),
    }

    def ref_verdict(auth, role, peer, kind, tag):
        try:
            asyncio.run(auth.verify_message_authen_tag(role, peer, ab[kind], tag))
        except ref_api.AuthenticationError:
            return False
        return True

    R = ref_api.AuthenticationRole
    ref_checks = [
        (ref_r[3], R.CLIENT, 0, "REQUEST"),
        (ref_c[0], R.REPLICA, 1, "REPLY"),
        (ref_r[3], R.USIG, 0, "PREPARE"),
        (ref_r[3], R.USIG, 2, "COMMIT"),
    ]
    ref_on_port = [
        ref_verdict(a, role, peer, kind, t)
        for a, role, peer, kind in ref_checks
        for t in (port_tags[kind], _tampered(port_tags[kind]))
    ]
    return {
        "port_on_ref": list(port_on_ref),
        "ref_on_port": ref_on_port,
        "ref_tags": ref_tags,
        "port_tags": port_tags,
        "engine": engine,
    }


def test_port_accepts_reference_signed_and_rejects_tampered(cross):
    assert cross["port_on_ref"] == [True, False] * 4
    st = cross["engine"].stats["ecdsa_p256"]
    assert st.batches == 1 and st.items == 8  # one co-batched dispatch


def test_reference_accepts_port_signed_and_rejects_tampered(cross):
    assert cross["ref_on_port"] == [True, False] * 4
    assert cross["ref_on_port"] == cross["port_on_ref"]
    assert cross["engine"].sign_stats["ecdsa_p256"].host_fallback_items == 0


def test_port_usig_continues_its_reference_twins_counter(cross):
    for kind in ("PREPARE", "COMMIT"):
        ref_ui = ref_msgs.UI.from_bytes(cross["ref_tags"][kind])
        port_ui = port_msgs.UI.from_bytes(cross["port_tags"][kind])
        assert (ref_ui.counter, port_ui.counter) == (1, 2)
        assert port_ui.cert[:8] == ref_ui.cert[:8]  # same epoch


def test_authentication_flow_runs_on_cpu():
    keys = make_test_keys(4, 1, rng=_SeededRng(5))
    engine = BatchVerifier(
        max_batch=32, buckets=(8, 32), device="cpu", sign_on_device=True
    )
    replicas, clients = authenticators_from_keys(
        keys, engine=engine, client_engine=engine
    )
    result = asyncio.run(
        chip_smoke.run_auth_flow(replicas, clients, n_requests=8, prepare_size=4, f=1)
    )
    chip_smoke.check_flow(result, 8)
    phases = result["phases"]
    assert phases["request"]["honest"] == 4 * 8 and phases["request"]["forged"] == 4
    assert phases["prepare"]["honest"] == 2 * 3 and phases["commit"]["honest"] == 6 * 3
    assert phases["reply"]["honest"] == 8 * 4
    for st in list(engine.stats.values()) + list(engine.sign_stats.values()):
        assert st.dispatch_timeouts == 0
        assert getattr(st, "host_fallback_items", 0) == 0


def test_new_test_authenticators_host_path_and_unported_schemes():
    replicas, clients = new_test_authenticators(4, n_clients=1)  # host path
    req = port_msgs.Request(client_id=0, seq=1, operation=b"x")
    ab = port_msgs.authen_bytes(req)
    tag = clients[0].generate_message_authen_tag(CLIENT, ab)
    asyncio.run(replicas[1].verify_message_authen_tag(CLIENT, 0, ab, tag))
    with pytest.raises(api.AuthenticationError):
        asyncio.run(
            replicas[1].verify_message_authen_tag(CLIENT, 0, ab, _tampered(tag))
        )
    # Ed25519 (host path): a client's tag verifies on a replica, a
    # tampered one is rejected.
    ed_replicas, ed_clients = new_test_authenticators(4, scheme="ed25519")
    ed_tag = ed_clients[0].generate_message_authen_tag(CLIENT, ab)
    assert len(ed_tag) == 64 and ed_tag != tag
    asyncio.run(ed_replicas[1].verify_message_authen_tag(CLIENT, 0, ab, ed_tag))
    with pytest.raises(api.AuthenticationError):
        asyncio.run(
            ed_replicas[1].verify_message_authen_tag(CLIENT, 0, ab, _tampered(ed_tag))
        )
    # An HMAC USIG through an engine: its UI certificates are checked by
    # the engine's HMAC queue (the plain K6 here), not on the host.
    engine = BatchVerifier(device="cpu")
    hmac_replicas, _ = new_test_authenticators(2, usig_kind="hmac", engine=engine)
    ui = hmac_replicas[0].generate_message_authen_tag(USIG, ab)
    asyncio.run(hmac_replicas[1].verify_message_authen_tag(USIG, 0, ab, ui))
    with pytest.raises(api.AuthenticationError, match="invalid UI certificate"):
        asyncio.run(hmac_replicas[1].verify_message_authen_tag(USIG, 0, ab, _tampered(ui)))
    st = engine.stats["hmac_sha256"]
    assert (st.items, st.batches) == (2, 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import minbft_tpu_torch as pkg\n"
        "import minbft_tpu_torch.core, minbft_tpu_torch.client\n"
        "import minbft_tpu_torch.sample.conn.inprocess, minbft_tpu_torch.sample.config\n"
        "import minbft_tpu_torch.ops.hmac_sha256, minbft_tpu_torch.ops.ed25519\n"
        "import minbft_tpu_torch.bench, minbft_tpu_torch.obs.ledger\n"
        "import minbft_tpu_torch.obs.timeseries, minbft_tpu_torch.utils.loop\n"
        "import minbft_tpu_torch.sample.authentication.mac\n"
        "import minbft_tpu_torch.obs.prom, minbft_tpu_torch.testing\n"
        "import minbft_tpu_torch.testing.adversary, minbft_tpu_torch.sample.peer.cli\n"
        "import chip_smoke, chip_deploy_ab\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'minbft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'minbft_tpu' or m.startswith('minbft_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('minbft_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
