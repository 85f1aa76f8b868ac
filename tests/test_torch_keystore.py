"""The port's keystore (``minbft_tpu_torch.sample.authentication``
``keystore``/``keytool``) against the reference's: a keys.yaml written by
either package loads in the other, unsealed and sealed under an operator
secret (the sealed cases need the ``cryptography`` package, as the
reference's do), with the same key material, USIGs that restore from it
and authenticators that accept each other's tags; the P-384/P-521 host
schemes sign in one package and verify in the other; ``keytool
generate`` runs; the least-privilege copies and the 0600 mode hold."""

import asyncio
import os
import stat

import pytest

from minbft_tpu import api as ref_api
from minbft_tpu.sample.authentication import keystore as ref_ks
from minbft_tpu.sample.authentication.authenticator import SCHEMES as REF_SCHEMES
from minbft_tpu_torch import api
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.sample.authentication import keystore as port_ks
from minbft_tpu_torch.sample.authentication import keytool
from minbft_tpu_torch.sample.authentication.authenticator import SCHEMES
from minbft_tpu_torch.utils import hostcrypto as hc

PACKAGES = {"port": port_ks, "ref": ref_ks}
OTHER = {"port": "ref", "ref": "port"}
SECRET = b"operator-secret"


def _roles(pkg_api):
    return pkg_api.AuthenticationRole.REPLICA, pkg_api.AuthenticationRole.CLIENT


def _check_tags_cross(writer_store, reader_store, writer: str) -> None:
    """A replica and a client tag made from the writer's store verify
    under the reader's authenticators, and a flipped byte does not."""
    w_api, r_api = (api, ref_api) if writer == "port" else (ref_api, api)
    w_rep, w_cli = _roles(w_api)
    r_rep, r_cli = _roles(r_api)
    msg = b"payload"
    rep_tag = writer_store.replica_authenticator(0).generate_message_authen_tag(w_rep, msg)
    cli_tag = writer_store.client_authenticator(1).generate_message_authen_tag(w_cli, msg)
    verifier = reader_store.replica_authenticator(2)

    async def check():
        await verifier.verify_message_authen_tag(r_rep, 0, msg, rep_tag)
        await verifier.verify_message_authen_tag(r_cli, 1, msg, cli_tag)
        with pytest.raises(r_api.AuthenticationError):
            await verifier.verify_message_authen_tag(
                r_rep, 0, msg, bytes([rep_tag[0] ^ 1]) + rep_tag[1:])

    asyncio.run(check())


@pytest.mark.parametrize("usig_spec", ["NATIVE_ECDSA", "SOFT_ECDSA", "HMAC_SHA256"])
@pytest.mark.parametrize("sealed", [False, True], ids=["plain", "sealed"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_keys_yaml_loads_in_the_other_package(writer, sealed, usig_spec, tmp_path):
    if sealed:
        pytest.importorskip("cryptography")
    reader = OTHER[writer]
    if usig_spec == "NATIVE_ECDSA":
        from minbft_tpu.usig import native as ref_native

        if not ref_native.available(auto_build=True):
            pytest.skip("the reference's native USIG does not build here")
    store = PACKAGES[writer].generate_testnet_keys(
        3, n_clients=2, usig_spec=usig_spec, with_macs=True)
    path = str(tmp_path / "keys.yaml")
    store.save(path, secret=SECRET if sealed else None)
    with open(path) as fh:
        assert ("seal:" in fh.read()) == sealed
    loaded = PACKAGES[reader].KeyStore.load(path, secret=SECRET if sealed else None)
    assert loaded.to_dict() == store.to_dict()
    assert loaded.usig_spec == usig_spec
    for i in range(3):
        u = loaded.make_usig(i)  # restores from the writer's blob, anchors match
        assert u.id()[8:] == store.usig_anchors()[i]
    _check_tags_cross(store, loaded, writer)
    if sealed:
        with pytest.raises(Exception, match="sealed"):
            PACKAGES[reader].KeyStore.load(path, secret=None)


@pytest.mark.parametrize("curve", ["p384", "p521"])
@pytest.mark.parametrize("signer", ["port", "ref"])
def test_nist_schemes_sign_in_one_package_and_verify_in_the_other(signer, curve):
    pytest.importorskip("cryptography")
    name = f"ecdsa-{curve}"
    priv, pub = hc.nist_keygen(curve)
    sign = (SCHEMES if signer == "port" else REF_SCHEMES)[name].sign
    tag = sign(priv, b"message")

    async def check():
        if signer == "port":
            ok = await REF_SCHEMES[name].verify(pub, b"message", tag, None, False)
            bad = await REF_SCHEMES[name].verify(pub, b"messagE", tag, None, False)
        else:
            ok = await SCHEMES[name].verify(pub, b"message", tag, None)
            bad = await SCHEMES[name].verify(pub, b"messagE", tag, None)
        return ok, bad

    assert asyncio.run(check()) == (True, False)


@pytest.mark.parametrize("scheme", ["ecdsa-p384", "ecdsa-p521"])
def test_wide_curve_keystores_cross_packages_on_the_host(scheme, tmp_path):
    """P-384/P-521 keystores load across packages and authenticate; with
    an engine the port checks them on the host (no kernel computes them):
    the engine's queues stay empty."""
    pytest.importorskip("cryptography")
    store = port_ks.generate_testnet_keys(3, n_clients=2, scheme=scheme,
                                          usig_spec="SOFT_ECDSA")
    path = str(tmp_path / "keys.yaml")
    store.save(path, secret=None)
    loaded = ref_ks.KeyStore.load(path, secret=None)
    assert loaded.scheme == scheme
    _check_tags_cross(store, loaded, "port")
    _check_tags_cross(loaded, port_ks.KeyStore.load(path, secret=None), "ref")
    engine = BatchVerifier(max_batch=8, device="cpu")
    auth0 = store.replica_authenticator(0)
    auth1 = store.replica_authenticator(1, engine=engine)
    tag = auth0.generate_message_authen_tag(api.AuthenticationRole.REPLICA, b"m")
    asyncio.run(auth1.verify_message_authen_tag(api.AuthenticationRole.REPLICA, 0, b"m", tag))
    assert engine.stats == {}


def test_keytool_generate(tmp_path):
    out = str(tmp_path / "k.yaml")
    assert keytool.main(["generate", "-o", out, "-n", "3", "--clients", "2",
                         "--usig", "SOFT_ECDSA", "--macs"]) == 0
    for pkg in (port_ks, ref_ks):
        store = pkg.KeyStore.load(out, secret=None)
        assert len(store.replica_keys) == 3 and len(store.client_keys) == 2
        assert store.mac_keys is not None and store.usig_spec == "SOFT_ECDSA"
    assert stat.S_IMODE(os.stat(out).st_mode) == 0o600


def test_strip_private_and_mac_authenticators(tmp_path):
    store = port_ks.generate_testnet_keys(3, n_clients=1, usig_spec="HMAC_SHA256",
                                          with_macs=True)
    copy = store.strip_private(keep_replica=1)
    assert [k for k, (priv, _) in copy.replica_keys.items() if priv] == [1]
    assert all(priv is None for priv, _ in copy.client_keys.values())
    with pytest.raises(port_ks.KeyStoreError):
        copy.replica_authenticator(0)
    auth = copy.mac_replica_authenticator(1)
    client = store.mac_client_authenticator(0)
    tag = client.generate_message_authen_tag(api.AuthenticationRole.CLIENT, b"req")
    asyncio.run(auth.verify_message_authen_tag(api.AuthenticationRole.CLIENT, 0, b"req", tag))
    with pytest.raises(ValueError, match="integrity"):
        port_ks._soft_unseal(port_ks._soft_seal(5)[:-1] + b"\x00")
