"""The port's batch split (minbft_tpu_torch/parallel/mesh.py) on lists of
CPU devices, where every chunk runs the plain version of its kernel.

1. Each of the five sharded kernels (K2, K3, K6, K7, K8) over
   ``["cpu"] * 2``, and K2 and K6 also over ``["cpu"] * 8``, equals the
   single-device plain version on the same rows, adversarial and padding
   lanes included, and the HMAC and ECDSA verifiers equal the reference's
   sharded kernels on its 8-device mesh (the shapes ``tests/test_mesh.py``
   compiles).
2. Every chunk is launched before any is read back, and a failing chunk
   fails the whole call.
3. ``BatchVerifier(mesh=)`` pads its buckets to multiples of the mesh and
   resolves every lane; a 1-device mesh is the plain engine; a repeated
   device is allowed, mixed device types and a missing CUDA are refused.

Inputs are made from a numpy seed; every comparison is exact."""

import asyncio
import hashlib
import hmac as hmac_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minbft_tpu.ops import lowering as ref_lowering
from minbft_tpu.parallel import mesh as ref_mesh
from minbft_tpu_torch.ops import ed25519, hmac_sha256, limbs, p256
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.parallel import mesh as mesh_mod
from minbft_tpu_torch.utils import hostcrypto as hc
from test_torch_slice import _SeededRng

_LANES = 16  # test_mesh.py's shape: two lanes a device on eight


def _ecdsa_rows(seed: int) -> np.ndarray:
    """[16, 98] u16 K2 rows: honest lanes, a flipped s, a wrong key, a
    tampered digest, r = 0 and s = n (valid = 0), the key Q = G, and two
    zero padding rows."""
    rng = _SeededRng(seed)
    keys = [hc.keygen(rng) for _ in range(3)]
    items = []
    for i in range(_LANES - 2):
        d, q = keys[i % 3]
        dg = hashlib.sha256(b"mesh-%d-%d" % (seed, i)).digest()
        items.append((q, dg, hc.ecdsa_sign_py(d, dg)))
    q, dg, (r, s) = items[1]
    items[1] = (q, dg, (r, s ^ 2))
    items[3] = (keys[0][1], items[3][1], items[3][2])
    items[5] = (items[5][0], hashlib.sha256(b"other").digest(), items[5][2])
    items[7] = (items[7][0], items[7][1], (0, items[7][2][1]))
    items[9] = (items[9][0], items[9][1], (items[9][2][0], hc.N))
    dg = hashlib.sha256(b"generator").digest()
    items[11] = ((hc.GX, hc.GY), dg, hc.ecdsa_sign_py(1, dg))
    return p256.prepare_packed(items, _LANES)


def _hmac_rows(seed: int) -> np.ndarray:
    """[16, 24] u32 K6 rows: honest MACs, a flipped MAC, key and message
    bit, and two zero padding rows."""
    g = np.random.default_rng(seed)
    rows = np.zeros((_LANES, hmac_sha256.PACKED_COLS), dtype=np.uint32)
    for i in range(_LANES - 2):
        key, msg = g.bytes(32), g.bytes(32)
        mac = hmac_mod.new(key, msg, hashlib.sha256).digest()
        rows[i] = np.frombuffer(key + msg + mac, dtype=">u4")
    rows[2, 16] ^= 1
    rows[6, 0] ^= 1 << 7
    rows[10, 8] ^= 1 << 31
    return rows


def _ed25519_rows(seed: int) -> np.ndarray:
    """[16, 82] u16 K7 rows: honest lanes, a tampered message, a wrong
    key, a flipped R bit, S + L, an undecodable key, a short signature and
    two zero padding rows."""
    g = np.random.default_rng(seed)
    seeds = [g.bytes(32) for _ in range(3)]
    pubs = [hc.ed25519_keygen(sd)[1] for sd in seeds]
    items = []
    for i in range(_LANES - 2):
        msg = g.bytes(32)
        items.append((pubs[i % 3], msg, hc.ed25519_sign(seeds[i % 3], msg)))
    items[1] = (items[1][0], g.bytes(32), items[1][2])
    items[3] = (pubs[0], items[3][1], items[3][2])
    sig = items[5][2]
    items[5] = (items[5][0], items[5][1], bytes([sig[0] ^ 1]) + sig[1:])
    sig = items[7][2]
    s_big = int.from_bytes(sig[32:], "little") + hc.ED_L
    items[7] = (items[7][0], items[7][1], sig[:32] + s_big.to_bytes(32, "little"))
    y = 2
    while hc.ed_decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    items[9] = (y.to_bytes(32, "little"), items[9][1], items[9][2])
    items[11] = (items[11][0], items[11][1], items[11][2][:63])
    return ed25519.prepare_packed(items, _LANES)


def _nonces(modulus: int, edges, seed: int) -> np.ndarray:
    rng = _SeededRng(seed)
    vals = list(edges) + [rng.randbelow(modulus) for _ in range(_LANES - len(edges))]
    return limbs.to_limbs_batch(vals).astype(np.uint16)


_CASES = {
    "K2": (mesh_mod.sharded_ecdsa_kernel, p256.ecdsa_verify_kernel_packed,
           lambda: torch.from_numpy(_ecdsa_rows(31))),
    "K6": (mesh_mod.sharded_hmac_kernel, hmac_sha256.hmac_verify_kernel_packed,
           lambda: torch.from_numpy(_hmac_rows(32).view(np.int32))),
    "K7": (mesh_mod.sharded_ed25519_kernel, ed25519.ed25519_verify_kernel_packed,
           lambda: torch.from_numpy(_ed25519_rows(33))),
    "K3": (mesh_mod.sharded_ecdsa_sign_kernel, p256.ecdsa_kg_kernel,
           lambda: torch.from_numpy(_nonces(p256.N, [1, 2, p256.N - 1], 34))),
    "K8": (mesh_mod.sharded_ed25519_sign_kernel, ed25519.ed25519_rb_kernel,
           lambda: torch.from_numpy(_nonces(ed25519.L, [0, 1, ed25519.L - 1], 35))),
}
_memo: dict = {}


def _rows_and_plain(kid: str):
    """(rows, single-device plain output), made once per kernel."""
    if kid not in _memo:
        rows = _CASES[kid][2]()
        _memo[kid] = (rows, _CASES[kid][1](rows))
    return _memo[kid]


def _split(kid: str, n_dev: int) -> torch.Tensor:
    """The sharded kernel's output over ``["cpu"] * n_dev``, made once."""
    key = (kid, n_dev)
    if key not in _memo:
        rows, _plain = _rows_and_plain(kid)
        _memo[key] = _CASES[kid][0](mesh_mod.make_mesh(["cpu"] * n_dev))(rows)
    return _memo[key]


# Eight devices for the two verifiers also held against the reference's
# 8-device mesh; two for the others (a plain K7 chunk costs ~2 s here).
@pytest.mark.parametrize("kid,n_dev", [
    ("K2", 2), ("K2", 8), ("K6", 2), ("K6", 8), ("K7", 2), ("K3", 2), ("K8", 2),
])
def test_sharded_kernel_equals_the_single_device_plain_version(kid, n_dev):
    rows, plain = _rows_and_plain(kid)
    got = _split(kid, n_dev)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    assert torch.equal(got, plain)
    if plain.dtype == torch.bool:
        # The adversarial and padding lanes are rejected, honest ones pass.
        assert not got[-2:].any() and got.any() and not got.all()


@pytest.fixture(scope="module")
def ref_mesh8():
    ref_lowering.set_mode("loop")  # test_mesh.py's compile
    yield ref_mesh.make_mesh(jax.devices("cpu")[:8])
    ref_lowering.set_mode(None)


@pytest.mark.parametrize("kid", ["K2", "K6"])
def test_sharded_verifier_equals_the_reference_mesh(kid, ref_mesh8):
    """The port's 8-device split against the reference's sharded kernel
    on its 8-device mesh, on the same rows."""
    rows, _plain = _rows_and_plain(kid)
    if kid == "K2":
        ref_kernel = ref_mesh.sharded_ecdsa_kernel(ref_mesh8)
        ref_rows = jnp.asarray(rows.numpy())
    else:
        ref_kernel = ref_mesh.sharded_hmac_kernel(ref_mesh8)
        ref_rows = jnp.asarray(rows.numpy().view(np.uint32))
    want = np.asarray(ref_kernel(ref_rows))
    assert _split(kid, 8).numpy().tolist() == want.tolist()


class _Out:
    """A kernel output whose readback is logged."""

    def __init__(self, log, c, t):
        self.log, self.c, self.t = log, c, t

    def cpu(self):
        self.log.append(("read", self.c))
        return self.t


def test_every_chunk_launches_before_any_reads_back_and_a_chunk_failure_fails_the_call():
    log = []

    def kernel(x):
        c = sum(1 for e in log if e[0] == "launch")
        log.append(("launch", c))
        return _Out(log, c, x[:, 0] * 10 + c)

    rows = torch.arange(12).reshape(6, 2)
    out = mesh_mod.sharded_verifier(kernel, mesh_mod.make_mesh(["cpu"] * 3))(rows)
    assert log == [("launch", 0), ("launch", 1), ("launch", 2),
                   ("read", 0), ("read", 1), ("read", 2)]
    assert out.tolist() == [0, 20, 41, 61, 82, 102]  # chunks in lane order

    def failing(x):
        if x[0, 0] >= 6:
            raise RuntimeError("chunk 1 failed")
        return x[:, 0]

    with pytest.raises(RuntimeError, match="chunk 1 failed"):
        mesh_mod.sharded_verifier(failing, mesh_mod.make_mesh(["cpu"] * 2))(rows)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        mesh_mod.sharded_verifier(kernel, mesh_mod.make_mesh(["cpu"] * 4))(rows)


def test_make_mesh_devices_and_rounding(monkeypatch):
    m = mesh_mod.make_mesh(["cpu", "cpu"])  # a repeated device is allowed
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
    assert [mesh_mod.round_up_to_mesh(m, n) for n in (1, 2, 5, 6)] == [2, 2, 6, 6]
    assert mesh_mod.round_up_to_mesh(mesh_mod.make_mesh(["cpu"] * 8), 6) == 8
    with pytest.raises(ValueError):
        mesh_mod.make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="cuda:0"):
        mesh_mod.make_mesh(["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="one type"):
        mesh_mod.make_mesh(["cpu", "cuda"])


def _hmac_item(i: int, valid: bool = True):
    key = hashlib.sha256(b"mesh-key-%d" % i).digest()
    msg = hashlib.sha256(b"mesh-msg-%d" % i).digest()
    mac = hmac_mod.new(key, msg, hashlib.sha256).digest()
    if not valid:
        mac = bytes([mac[0] ^ 1]) + mac[1:]
    return key, msg, mac


def _verify_all(eng, items):
    async def run():
        return list(await asyncio.gather(*[eng.verify_hmac_sha256(*it) for it in items]))

    return asyncio.run(run())


@pytest.fixture
def hmac_chunks(monkeypatch):
    """The (rows, device) of every chunk the engine hands K6's wrapper."""
    log = []
    real = hmac_sha256.hmac_verify_kernel_packed

    def spy(rows):
        log.append((rows.shape[0], str(rows.device)))
        return real(rows)

    monkeypatch.setattr(hmac_sha256, "hmac_verify_kernel_packed", spy)
    return log


def test_mesh_engine_pads_buckets_to_the_mesh_and_resolves_every_lane(hmac_chunks):
    mesh8 = mesh_mod.make_mesh(["cpu"] * 8)
    eng = BatchVerifier(max_batch=16, buckets=(6, 16), mesh=mesh8)
    assert eng.buckets == (8, 16) and eng.mesh is mesh8
    assert eng.device == torch.device("cpu")
    items = [_hmac_item(i, valid=i % 3 != 1) for i in range(5)]
    assert _verify_all(eng, items) == [i % 3 != 1 for i in range(5)]
    st = eng.stats["hmac_sha256"]
    assert st.items == 5 and st.batches == 1 and st.padded_lanes == 3
    assert hmac_chunks == [(1, "cpu")] * 8  # the bucket of 8, one lane a device


def test_one_device_mesh_is_the_plain_engine(hmac_chunks):
    eng = BatchVerifier(max_batch=8, mesh=mesh_mod.make_mesh(["cpu"]))
    plain = BatchVerifier(max_batch=8, device="cpu")
    assert eng.mesh.devices == plain.mesh.devices == (torch.device("cpu"),)
    assert eng.device == plain.device and eng.buckets == plain.buckets
    items = [_hmac_item(i, valid=i != 2) for i in range(6)]
    assert _verify_all(eng, items) == _verify_all(plain, items)
    a, b = eng.stats["hmac_sha256"], plain.stats["hmac_sha256"]
    assert (a.items, a.batches, a.padded_lanes, a.flush_reasons) == (
        b.items, b.batches, b.padded_lanes, b.flush_reasons)
    # One whole-bucket chunk a dispatch, on either engine.
    assert hmac_chunks == [(8, "cpu")] * 2
