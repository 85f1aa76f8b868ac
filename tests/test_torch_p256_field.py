"""The P-256 field ops of ``csrc/p256_field.cuh`` and the lane functions of
K2, K3 and K4, compiled for the host with g++ and held against Python's big
integers and the port's plain versions.

The header's PTX carry primitives have host bodies (an emulated carry flag)
under ``MBT_HOST_TEST``; the group form's ``__shfl_sync`` is emulated by T
host threads meeting at a barrier, one per thread of the group.  The
kernel sources are included whole: their kernels and launchers sit under
``__CUDACC__``, and a stub ``cuda_runtime.h`` stands in for CUDA's.  So the
arithmetic of both geometries the launchers pick (one thread per lane, a
group of 4) runs here exactly as written; what only the card shows (the
PTX itself, ptxas) the smoke checks there (``chip_smoke.py`` phases 2-4,
11 and 12).  Skipped where no g++ is installed.
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from minbft_tpu_torch.ops import limbs, p256
from minbft_tpu_torch.utils import hostcrypto as hc

CSRC = os.path.join(os.path.dirname(__file__), "..", "minbft_tpu_torch", "csrc")
P = p256.P
R = 1 << 256

# Host stand-ins for the CUDA names the header and the lane functions use.
HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __grid_constant__
#define MBT_HOST_TEST 1
struct Dim3 { unsigned x; };
thread_local Dim3 threadIdx;
static Dim3 blockIdx{0}, blockDim{128};
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
static std::barrier<>* g_bar;
static uint32_t g_buf[32];
static int g_threads;
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  unsigned lane = threadIdx.x & 31;
  g_buf[lane] = v;
  g_bar->arrive_and_wait();
  uint32_t r = g_buf[(lane / width) * width + (src % width)];
  g_bar->arrive_and_wait();
  return r;
}
#include "p256_field.cuh"
namespace k2lane {
#include "p256_verify.cu"
}
namespace k3lane {
#include "p256_kg.cu"
}
namespace k4lane {
#include "p256_kg_ladder.cu"
}

// Runs body(rank) on T host threads (one group), or inline for T = 1.
template <class Body> void on_group(int T, Body body) {
  if (T == 1) { body(0); return; }
  g_threads = T;
  std::barrier<> bar(T);
  g_bar = &bar;
  std::vector<std::thread> th;
  for (int t = 0; t < T; ++t) th.emplace_back([&, t] { threadIdx.x = t; body(t); });
  for (auto& x : th) x.join();
}

template <class F>
Fe field_op(const F& f, int op, const Fe& a, const Fe& b) {
  switch (op) {
    case 0: return f.mul(a, b);
    case 1: return f.sqr(a);
    case 2: return f.add(a, b);
    case 3: return f.sub(a, b);
    case 4: return f.to_mont(a);
    case 5: return f.from_mont(a);
    default: return p256_inv(f, a);
  }
}

// Case i on thread i mod T, as the K1 test kernel: in a group the
// multiplying ops go through muls over the group's T cases.
template <int T> void ops(int op, int n, const uint32_t* A, const uint32_t* B, uint32_t* out) {
  on_group(T, [&](int t) {
    P256Field<T> f;
    for (int i0 = 0; i0 < n; i0 += T) {
      int i = i0 + t < n ? i0 + t : n - 1;
      Fe a, b, r;
      memcpy(a.v, A + 8 * i, 32);
      memcpy(b.v, B + 8 * i, 32);
      if constexpr (T > 1) {
        if (op <= 1 || op == 4 || op == 5) {
          Fe by = op == 0 ? b : op == 1 ? a
                                : p256_constant(op == 4 ? kConstR2 : kConstUnit);
          Fe xs[T], ys[T], m[T];
          for (int j = 0; j < T; ++j) { xs[j] = f.from(a, j); ys[j] = f.from(by, j); }
          if (op == 1) f.template muls<T, (1u << T) - 1u>(xs, xs, m);
          else f.template muls<T, 0u>(xs, ys, m);
          r = m[t];
        } else {
          r = field_op(f, op, a, b);
        }
      } else {
        r = field_op(f, op, a, b);
      }
      if (i0 + t < n) memcpy(out + 8 * i, r.v, 32);
    }
  });
}

template <int T> void k2(int n, const uint16_t* rows, uint32_t* out) {
  on_group(T, [&](int t) {
    P256Field<T> f;
    for (int i = 0; i < n; ++i) {
      bool ok = k2lane::verify_lane(f, k2lane::PackedRow{rows + 98 * i});
      if (t == 0) out[i] = ok;
    }
  });
}

template <int T> void k3(int n, const uint16_t* k, const uint32_t* table, uint32_t* out) {
  on_group(T, [&](int t) {
    P256Field<T> f;
    for (int i = 0; i < n; ++i) {
      Pt r = k3lane::kg_lane(f, k + 16 * i, (const uint4*)table);
      if (t == 0) {
        memcpy(out + 16 * i, r.x.v, 32);
        memcpy(out + 16 * i + 8, r.z.v, 32);
      }
    }
  });
}

template <int T> void k4(int n, const uint16_t* k, uint32_t* out) {
  on_group(T, [&](int t) {
    P256Field<T> f;
    for (int i = 0; i < n; ++i) {
      Pt r = k4lane::kg_ladder_lane(f, k + 16 * i);
      if (t == 0) {
        memcpy(out + 16 * i, r.x.v, 32);
        memcpy(out + 16 * i + 8, r.z.v, 32);
      }
    }
  });
}

// stdin: "ops T op n" + 16 words a line | "k2 T n" + 98 u16 a row |
// "k3 T n" + 16 u16 a row, then the comb table's 16,384 words |
// "k4 T n" + 16 u16 a row; hex.
int main() {
  char kind[8];
  int T, n, op = 0;
  if (scanf("%7s %d", kind, &T) != 2) return 1;
  std::string k(kind);
  if (k == "ops" && scanf("%d", &op) != 1) return 1;
  if (scanf("%d", &n) != 1) return 1;
  auto rd = [](unsigned& v) { if (scanf("%x", &v) != 1) exit(1); };
  unsigned v;
  if (k == "ops") {
    std::vector<uint32_t> A(8 * n), B(8 * n), out(8 * n);
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < 8; ++j) { rd(v); A[8 * i + j] = v; }
      for (int j = 0; j < 8; ++j) { rd(v); B[8 * i + j] = v; }
    }
    if (T == 1) ops<1>(op, n, A.data(), B.data(), out.data());
    else ops<4>(op, n, A.data(), B.data(), out.data());
    for (int i = 0; i < 8 * n; ++i) printf("%x%c", out[i], i % 8 == 7 ? '\n' : ' ');
  } else if (k == "k2") {
    std::vector<uint16_t> rows(98 * n);
    for (auto& x : rows) { rd(v); x = (uint16_t)v; }
    std::vector<uint32_t> out(n);
    if (T == 1) k2<1>(n, rows.data(), out.data());
    else k2<4>(n, rows.data(), out.data());
    for (int i = 0; i < n; ++i) printf("%u\n", out[i]);
  } else {
    // Nonce rows 16-byte aligned, as the kernels read them.
    std::vector<uint4> kbuf(2 * n);
    uint16_t* kk = (uint16_t*)kbuf.data();
    for (int i = 0; i < 16 * n; ++i) { rd(v); kk[i] = (uint16_t)v; }
    std::vector<uint32_t> out(16 * n);
    if (k == "k3") {
      std::vector<uint32_t> table(64 * 16 * 16);
      for (auto& x : table) { rd(v); x = v; }
      if (T == 1) k3<1>(n, kk, table.data(), out.data());
      else k3<4>(n, kk, table.data(), out.data());
    } else {
      if (T == 1) k4<1>(n, kk, out.data());
      else k4<4>(n, kk, out.data());
    }
    for (int i = 0; i < 16 * n; ++i) printf("%x%c", out[i], i % 16 == 15 ? '\n' : ' ');
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the CUDA header for the host")
    d = tmp_path_factory.mktemp("p256_field")
    (d / "cuda_runtime.h").write_text("// stand-in: the harness defines what the lane code uses\n")
    (d / "host.cpp").write_text(HARNESS)
    exe = d / "host"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", f"-I{CSRC}", f"-I{d}", "-o", str(exe),
         str(d / "host.cpp"), "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    return str(exe)


def _run(exe: str, text: str) -> list:
    out = subprocess.run([exe], input=text, capture_output=True, text=True,
                         check=True, timeout=300).stdout
    return [line.split() for line in out.splitlines() if line.strip()]


def _words(x: int) -> list:
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(8)]


def _mont_mul(a: int, b: int) -> int:
    """The generic CIOS's value: (a*b + U*p) / 2^256 with U making it
    exact, less p where that is >= p."""
    t = a * b
    u = (-t * pow(P, -1, R)) % R
    v = (t + u * P) >> 256
    return v - P if v >= P else v


def _want(op: str, a: int, b: int) -> int:
    if op == "mul":
        return _mont_mul(a, b)
    if op == "sqr":
        return _mont_mul(a, a)
    if op == "add":
        return (a + b) % P
    if op == "sub":
        return (a - b) % P
    if op == "to_mont":
        return _mont_mul(a, R * R % P)
    if op == "from_mont":
        return _mont_mul(a, 1)
    acc = R % P  # inv: the generic square-and-multiply from the one
    for i in range(255, -1, -1):
        acc = _mont_mul(acc, acc)
        if ((P - 2) >> i) & 1:
            acc = _mont_mul(acc, a)
    return acc


OPS = ("mul", "sqr", "add", "sub", "to_mont", "from_mont", "inv")


@pytest.mark.parametrize("group", p256.GROUP_SIZES)
@pytest.mark.parametrize("op", OPS)
def test_field_op_matches_big_integers(host_bin, op, group):
    rng = random.Random(OPS.index(op) * 10 + group)
    edges = [0, 1, 2, P - 1, P - 2, R - 1 - P, P >> 1, 1 << 255, P - (1 << 96)]
    n = 8 if op == "inv" else 120
    va = edges + [rng.randrange(P) for _ in range(n)]
    vb = edges[::-1] + [rng.randrange(P) for _ in range(n)]
    if op in ("mul", "to_mont", "from_mont"):  # a first operand of any 256 bits
        va[-4:] = [P, P + 1, R - 1, P + rng.randrange(R - P)]
    text = f"ops {group} {OPS.index(op)} {len(va)}\n" + "\n".join(
        " ".join(f"{w:x}" for w in _words(a) + _words(b)) for a, b in zip(va, vb)
    )
    got = [sum(int(w, 16) << (32 * j) for j, w in enumerate(line))
           for line in _run(host_bin, text)]
    bad = [(hex(a), hex(b)) for a, b, g in zip(va, vb, got) if g != _want(op, a, b)]
    assert not bad, f"{op} T={group}: {len(bad)} wrong, first {bad[0]}"


def _verify_rows(count: int) -> np.ndarray:
    """Packed K2 rows: honest lanes, Q = G, -G, 2G, every 4th lane
    adversarial (tampered digest, wrong key, r = 0, s = n, flipped s), two
    crafted r2 lanes and two zero (padding) rows."""
    rng = random.Random(11)

    class _Rng:
        def randbelow(self, n):
            return rng.randrange(n)

    keys = [hc.keygen(_Rng()) for _ in range(3)]
    g = (hc.GX, hc.GY)
    signers = [keys[i % 3] for i in range(count)]
    signers[:3] = [(1, g), (hc.N - 1, (hc.GX, hc.P - hc.GY)), (2, hc.point_double(g))]
    items = []
    for d, q in signers:
        dg = bytes(rng.randrange(256) for _ in range(32))
        items.append((q, dg, hc.ecdsa_sign_py(d, dg)))
    for i in range(3, count, 4):
        q, dg, (r, s) = items[i]
        items[i] = [(q, bytes(32), (r, s)), (keys[0][1], dg, (r, s)), (q, dg, (0, s)),
                    (q, dg, (r, hc.N)), (q, dg, (r, s ^ 1))][(i // 4) % 5]
    rows = p256.prepare_packed(items, count + 2)
    for j, i in enumerate((4, 5)):  # r2 = r with r2_ok; then only r2 can match
        rows[i, 96] = 1
        rows[i, 80:96] = rows[i, 64:80]
        if j:
            rows[i, 64] ^= 1
    return rows


@pytest.fixture(scope="module")
def verify_rows():
    rows = _verify_rows(22)
    want = p256.verify_packed_plain(torch.from_numpy(rows.astype(np.int64))).numpy()
    return rows, want


@pytest.mark.parametrize("group", p256.GROUP_SIZES)
def test_k2_lane_matches_the_plain_version(host_bin, verify_rows, group):
    rows, want = verify_rows
    # A group's emulation costs ~0.5 s a lane: there, Q = G and -G (the
    # G+Q entry's doubling and negation cases), the lane only r2 can
    # accept, and a wrong key.
    lanes = np.arange(len(rows)) if group == 1 else np.array([0, 1, 5, 7])
    text = f"k2 {group} {len(lanes)}\n" + "\n".join(
        " ".join(f"{v:x}" for v in r) for r in rows[lanes])
    got = np.array([int(line[0]) for line in _run(host_bin, text)], bool)
    assert want[lanes].any() and not want[lanes].all()
    np.testing.assert_array_equal(got, want[lanes])


@pytest.mark.parametrize("group", p256.GROUP_SIZES)
def test_k3_lane_matches_the_plain_version(host_bin, group):
    rng = random.Random(3)
    nonces = [1, 2, p256.N - 1, 16, 1 << 252] + [rng.randrange(1, p256.N) for _ in range(3)]
    k = limbs.to_limbs_batch(nonces).astype(np.uint16)
    tab = p256.comb_table_words("cpu").numpy().view(np.uint32).reshape(-1)
    text = (f"k3 {group} {len(k)}\n"
            + "\n".join(" ".join(f"{v:x}" for v in r) for r in k) + "\n"
            + " ".join(f"{v:x}" for v in tab))
    got = np.array([[int(w, 16) for w in line] for line in _run(host_bin, text)], np.uint32)
    want = p256.kg_plain(torch.from_numpy(k.astype(np.int64)), p256.comb_table_limbs())
    np.testing.assert_array_equal(got.view(np.uint16).reshape(len(k), 2, 16),
                                  want.numpy().astype(np.uint16))


@pytest.fixture(scope="module")
def ladder_nonces():
    """k = 0, 1, 2, n - 1 and four random nonces, with the plain ladder's
    (X, Z)."""
    rng = random.Random(4)
    nonces = [0, 1, 2, p256.N - 1] + [rng.randrange(1, p256.N) for _ in range(4)]
    k = limbs.to_limbs_batch(nonces).astype(np.uint16)
    want = p256.kg_ladder_plain(torch.from_numpy(k.astype(np.int64)))
    return k, want.numpy().astype(np.uint16)


@pytest.mark.parametrize("group", p256.GROUP_SIZES)
def test_k4_lane_matches_the_plain_version(host_bin, ladder_nonces, group):
    k, want = ladder_nonces
    text = f"k4 {group} {len(k)}\n" + "\n".join(" ".join(f"{v:x}" for v in r) for r in k)
    got = np.array([[int(w, 16) for w in line] for line in _run(host_bin, text)], np.uint32)
    np.testing.assert_array_equal(got.view(np.uint16).reshape(len(k), 2, 16), want)
    assert not want[0, 1].any() and want[1:, 1].any(axis=1).all()  # Z = 0 only for k = 0
