"""The port's native USIG (``minbft_tpu_torch/native`` built by
``usig/native.py`` into ``build/native/``) against the reference's: the
port builds the library and runs its copy of ``usig_test.cc``; UIs made by
either package's native module verify under the other's ``EcdsaUSIG`` and
``NativeEcdsaUSIG``; a key sealed by either (plain v2, AES-GCM v3) restores
in the other with a fresh epoch; native UIs verify through the port's
engine on the CPU (the plain K2); the build raises without libcrypto and
survives concurrent first builds."""

import asyncio
import multiprocessing
import os
import subprocess

import pytest

from minbft_tpu.usig import native as ref_native
from minbft_tpu.usig.software import EcdsaUSIG as RefEcdsaUSIG
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.usig import UsigError
from minbft_tpu_torch.usig import native
from minbft_tpu_torch.usig.software import EcdsaUSIG, usig_verify_items


@pytest.fixture(scope="module")
def ref_lib():
    """The reference's own native module, built by its own loader."""
    if not ref_native.available(auto_build=True):
        pytest.skip("the reference's native USIG does not build here")
    return ref_native


def test_port_builds_into_build_and_its_cxx_test_passes():
    lib = native.build(with_test=True)
    out_dir = native.build_dir()
    assert lib == os.path.join(out_dir, "libusig.so")
    assert out_dir.startswith(native.BUILD_ROOT) and os.path.exists(lib)
    assert "minbft_tpu_torch" not in out_dir.split(os.sep)  # beside the package
    res = subprocess.run([os.path.join(out_dir, "usig_test")], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "all checks passed" in res.stdout
    # The port's sources are the reference's, comments aside.
    with open(os.path.join(native.NATIVE_DIR, "usig.cc")) as fh:
        assert "usig_seal2" in fh.read()


def test_counter_monotonic_and_cert_format():
    u = native.NativeEcdsaUSIG()
    uis = [u.create_ui(b"msg-%d" % i) for i in range(4)]
    assert [ui.counter for ui in uis] == [1, 2, 3, 4]
    assert all(len(ui.cert) == 8 + 64 for ui in uis)
    for i, ui in enumerate(uis):
        u.verify_ui(b"msg-%d" % i, ui, u.id())
    with pytest.raises(UsigError):
        u.verify_ui(b"other", uis[0], u.id())


@pytest.mark.parametrize("maker", ["port", "ref"])
def test_native_uis_verify_across_packages(maker, ref_lib):
    """A UI made by one package's native module verifies under the other
    package's software and native verifiers (and its own), and a changed
    message fails under each."""
    make = native.NativeEcdsaUSIG if maker == "port" else ref_lib.NativeEcdsaUSIG
    u = make()
    ui = u.create_ui(b"cross-check")
    verifiers = [EcdsaUSIG(), RefEcdsaUSIG(), native.NativeEcdsaUSIG(),
                 ref_lib.NativeEcdsaUSIG()]
    for v in verifiers:
        v.verify_ui(b"cross-check", ui, u.id())
        with pytest.raises(Exception, match="invalid|UI"):
            v.verify_ui(b"cross-check!", ui, u.id())


@pytest.mark.parametrize("secret", [None, b"operator-secret"], ids=["v2", "v3"])
@pytest.mark.parametrize("sealer", ["port", "ref"])
def test_sealed_blob_restores_in_the_other_package(sealer, secret, ref_lib):
    """Same key, fresh epoch, counter back at 1 (reference usig.c:168-186),
    whichever package sealed the blob and whichever restores it."""
    pkgs = {"port": native, "ref": ref_lib}
    other = "ref" if sealer == "port" else "port"
    u = pkgs[sealer].NativeEcdsaUSIG()
    blob = u.seal(secret)
    assert blob[:4] == (b"USG3" if secret else blob[:4])
    r = pkgs[other].NativeEcdsaUSIG.from_sealed(blob, secret)
    assert r.public_key == u.public_key and r.epoch != u.epoch
    ui = r.create_ui(b"after")
    assert ui.counter == 1
    u.verify_ui(b"after", ui, r.id())
    with pytest.raises(Exception):
        r.verify_ui(b"after", ui, u.id())  # the old epoch's ID
    if secret:
        with pytest.raises(Exception, match="secret"):
            pkgs[other].NativeEcdsaUSIG.from_sealed(blob)
    with pytest.raises(UsigError):
        native.NativeEcdsaUSIG.from_sealed(b"\x00" * 20)


def test_native_uis_verify_on_the_engine_plain_k2():
    """``usig_verify_items`` turns a native UI into a K2 lane; the port's
    engine on the CPU (the plain K2) accepts the honest lanes and rejects
    the forged one, at 8 lanes."""
    u = native.NativeEcdsaUSIG()
    lanes = []
    for i in range(7):
        ui = u.create_ui(b"batch-%d" % i)
        lanes.append(usig_verify_items(b"batch-%d" % i, ui, u.id()))
    q, payload, (r, s) = lanes[3]
    lanes.append((q, payload, (r, s ^ 2)))
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    verdicts = asyncio.run(engine.verify_ecdsa_p256_many(lanes))
    assert verdicts == [True] * 7 + [False]
    assert engine.stats["ecdsa_p256"].batches == 1


def test_build_raises_without_libcrypto(tmp_path, monkeypatch):
    candidates = native.LIBCRYPTO_CANDIDATES
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "LIBCRYPTO_CANDIDATES", (str(tmp_path / "none.so.3"),))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="libcrypto.so.3"):
        native.build()
    with pytest.raises(native.NativeBuildError):
        native.NativeEcdsaUSIG()
    assert native.available() is False
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(native, "LIBCRYPTO_CANDIDATES", candidates)
    with pytest.raises(native.NativeBuildError, match="compiler"):
        native.build()


def _build_in(root: str) -> str:
    native.BUILD_ROOT = root
    return native.build()


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Four processes reach a cold build directory at once (n replicas
    starting together): all get the library, built once."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        paths = pool.map(_build_in, [str(tmp_path)] * 4, chunksize=1)
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    leftovers = [f for f in os.listdir(os.path.dirname(paths[0])) if ".tmp" in f]
    assert leftovers == []
