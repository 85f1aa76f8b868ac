"""The port's field arithmetic (minbft_tpu_torch/ops/limbs.py, the plain
version of kernel K1) against the JAX reference (minbft_tpu/ops/limbs.py
under jax.vmap, the CPU "loop" lowering its own tests use).

Every value is an integer, so every comparison is exact (tolerance 0).
Inputs are made from a numpy seed."""

import jax
import numpy as np
import pytest
import torch

from minbft_tpu.ops import limbs as ref
from minbft_tpu_torch.ops import backend
from minbft_tpu_torch.ops import limbs as port

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
R = 1 << 256


def _rand_ints(rng, count, modulus):
    return [int.from_bytes(rng.bytes(40), "little") % modulus for _ in range(count)]


def _operands(modulus, seed):
    """Random pairs plus the edge pairs of tests/test_limbs.py."""
    rng = np.random.default_rng(seed)
    edges = [(0, 0), (modulus - 1, modulus - 1), (1, modulus - 1), (0, modulus - 1)]
    a = [x for x, _ in edges] + _rand_ints(rng, 12, modulus)
    b = [y for _, y in edges] + _rand_ints(rng, 12, modulus)
    return a, b


def _ref_batched(spec, fn):
    return jax.jit(
        jax.vmap(
            lambda a, b: ref.fe_to_array(
                fn(spec, ref.fe_from_array(a), ref.fe_from_array(b))
            )
        )
    )


@pytest.mark.parametrize("modulus", [P256_P, P256_N], ids=["p", "n"])
@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_field_op_matches_reference(modulus, op):
    a, b = _operands(modulus, seed=modulus % 1000)
    la, lb = port.to_limbs_batch(a), port.to_limbs_batch(b)
    want = np.asarray(
        _ref_batched(ref.FieldSpec.make(modulus), getattr(ref, op))(la, lb)
    )
    got = getattr(port, op)(
        port.FieldSpec.make(modulus), port.fe_tensor(la), port.fe_tensor(lb)
    )
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    expect = {
        "mont_mul": lambda x, y: x * y * pow(R, -1, modulus) % modulus,
        "add_mod": lambda x, y: (x + y) % modulus,
        "sub_mod": lambda x, y: (x - y) % modulus,
    }[op]
    assert port.from_limbs_batch(got) == [expect(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("modulus", [P256_P, P256_N], ids=["p", "n"])
def test_fermat_inverse_matches_reference(modulus):
    a, _ = _operands(modulus, seed=7)
    a = [x for x in a if x][:3]
    spec_r, spec_p = ref.FieldSpec.make(modulus), port.FieldSpec.make(modulus)
    la = port.to_limbs_batch([x * R % modulus for x in a])  # Montgomery form
    want = np.asarray(
        jax.jit(jax.vmap(lambda x: ref.fe_to_array(
            ref.mont_inv(spec_r, ref.fe_from_array(x)))))(la)
    )
    got = port.mont_inv(spec_p, port.fe_tensor(la))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    plain = port.from_mont(spec_p, got)
    assert port.from_limbs_batch(plain) == [pow(x, -1, modulus) for x in a]


@pytest.mark.parametrize("op", port.FIELD_OPS)
def test_field_op_wrapper_cpu_is_the_plain_version(op):
    """K1's wrapper on CPU tensors returns the plain op's limbs as uint16."""
    a, b = _operands(P256_N, seed=11)
    ta = torch.from_numpy(port.to_limbs_batch(a).astype(np.uint16))
    tb = torch.from_numpy(port.to_limbs_batch(b).astype(np.uint16))
    got = port.field_op(op, ta, tb, field="n")
    spec = port.FieldSpec.make(P256_N)
    want = port.field_op_plain(op, spec, ta.to(torch.int64), tb.to(torch.int64))
    assert got.dtype == torch.uint16
    assert torch.equal(got.to(torch.int64), want)
    assert port.field_op.launches == 0  # no kernel on the CPU path


def test_field_op_raises_off_cpu_and_cuda():
    a = torch.zeros((4, 16), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError):
        port.field_op("mul", a, a)


def test_resolve_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        backend.resolve_device()
    with pytest.raises(RuntimeError):
        backend.resolve_device("cuda")
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_host_helpers_match_reference():
    rng = np.random.default_rng(3)
    vals = _rand_ints(rng, 9, R) + [0, R - 1, P256_N, P256_P - P256_N]
    rows_r, rows_p = ref.to_limbs_batch(vals), port.to_limbs_batch(vals)
    assert np.array_equal(rows_r, rows_p)
    assert np.array_equal(ref.to_limbs(vals[0]), port.to_limbs(vals[0]))
    assert ref.from_limbs_batch(rows_r) == port.from_limbs_batch(rows_p) == vals
    assert ref.from_limbs(rows_r[1]) == port.from_limbs(rows_p[1])
    assert np.array_equal(ref.limb_words(rows_r), port.limb_words(rows_p))
    for bound in (P256_N, P256_P, P256_P - P256_N, 1):
        assert np.array_equal(
            ref.limbs_lt(rows_r, bound), port.limbs_lt(rows_p, bound)
        )
        assert np.array_equal(
            ref.words_lt(ref.limb_words(rows_r), ref.words_of(bound)),
            port.words_lt(port.limb_words(rows_p), port.words_of(bound)),
        )
    assert np.array_equal(ref.limbs_is_zero(rows_r), port.limbs_is_zero(rows_p))
    assert np.array_equal(
        ref.limbs_add_const(rows_r[:9], P256_N),
        port.limbs_add_const(rows_p[:9], P256_N),
    )
    inv_vals = [v % P256_N for v in vals[:9]]
    assert ref.batch_inv_host(inv_vals, P256_N) == port.batch_inv_host(
        inv_vals, P256_N
    )
    for m in (P256_P, P256_N):
        sr, sp = ref.FieldSpec.make(m), port.FieldSpec.make(m)
        assert (sr.modulus, sr.m_prime, sr.r_mod, sr.r2_mod) == (
            sp.modulus, sp.m_prime, sp.r_mod, sp.r2_mod
        )
    buf = np.zeros((8, 98), np.uint16)
    assert port.staging_out(buf, 8, 98, 5) is buf
    with pytest.raises(ValueError):
        port.staging_out(buf, 8, 98, 9)
    with pytest.raises(ValueError):
        port.staging_out(np.zeros((8, 97), np.uint16), 8, 98, 1)
