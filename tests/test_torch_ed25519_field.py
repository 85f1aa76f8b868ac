"""The field ops mod 2^255 - 19 of ``csrc/ed25519_field.cuh`` and the lane
functions of K7 and K8, compiled for the host with g++ and held against
Python's big integers and the port's plain versions.

As in ``tests/test_torch_p256_field.py``: the PTX carry primitives have host
bodies (an emulated carry flag) under ``MBT_HOST_TEST``; the group form's
``__shfl_sync`` is emulated by T host threads meeting at a barrier, one per
thread of the group; the kernel sources are included whole (their kernels
and launchers sit under ``__CUDACC__``), with a stub ``cuda_runtime.h``.  So
the arithmetic of both geometries (one thread per lane, as K1's wrapper runs
the ops, and the group of 4 that K7, K7' and K8 run on) runs here exactly as
written; what only the card shows (the PTX
itself, ptxas) the smoke checks there (``chip_smoke.py`` phases 2, 7 and
12).  Skipped where no g++ is installed.

- every op (mul, sqr, add, sub, the multiply by 38, the inversion) at T = 1
  and 4 against big integers, on random values and the edges 0, 1, p - 1,
  p, 2^255 and 2^256 - 1 (add and sub follow the generic ops' rule there);
  the inverse of 0 is 0;
- K7's lane function, on a group of 4, against ``verify_packed_plain`` on
  16 rows: the lanes
  of ``tests/test_torch_ed25519.py`` (honest, tampered message, wrong key,
  bit-flipped R, S + L, R's y >= p, undecodable key, wrong length), three
  keys of small order and a zero padding row;
- K8's lane function, on a group of 4, against ``rb_plain`` bit for bit,
  r = 0, 1 and L - 1 among the nonces.
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from minbft_tpu_torch.ops import ed25519, limbs
from minbft_tpu_torch.utils import hostcrypto as hc
from test_torch_ed25519 import lanes  # noqa: F401  (the adversarial lanes)

CSRC = os.path.join(os.path.dirname(__file__), "..", "minbft_tpu_torch", "csrc")
P = ed25519.P
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
static inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
static std::barrier<>* g_bar;
static uint32_t g_buf[32];
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width) {
  unsigned lane = threadIdx.x & 31;
  g_buf[lane] = v;
  g_bar->arrive_and_wait();
  uint32_t r = g_buf[(lane / width) * width + (src % width)];
  g_bar->arrive_and_wait();
  return r;
}
#include "ed25519.cuh"
namespace k7lane {
#include "ed25519_verify.cu"
}
namespace k8lane {
#include "ed25519_rb.cu"
}

// Runs body(rank) on T host threads (one group), or inline for T = 1.
template <class Body> void on_group(int T, Body body) {
  if (T == 1) { body(0); return; }
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
    case 4: return f.mul_small(a, 38u);
    default: return ed_inv(f, a);
  }
}

// Case i on thread i mod T, as the K1 test kernel: in a group, mul and sqr
// go through muls over the group's T cases.
template <int T> void ops(int op, int n, const uint32_t* A, const uint32_t* B, uint32_t* out) {
  on_group(T, [&](int t) {
    FieldGeometry<EdF1, T> f;
    for (int i0 = 0; i0 < n; i0 += T) {
      int i = i0 + t < n ? i0 + t : n - 1;
      Fe a, b, r;
      memcpy(a.v, A + 8 * i, 32);
      memcpy(b.v, B + 8 * i, 32);
      if constexpr (T > 1) {
        if (op <= 1) {
          Fe xs[T], ys[T], m[T];
          for (int j = 0; j < T; ++j) { xs[j] = f.from(a, j); ys[j] = f.from(b, j); }
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

void k7(int n, const uint32_t* rows, uint32_t* out) {
  on_group(4, [&](int t) {
    EdTasks f;
    for (int i = 0; i < n; ++i) {
      bool ok = k7lane::verify_lane(f, k7lane::PackedRow{rows + 41 * i});
      if (t == 0) out[i] = ok;
    }
  });
}

void k8(int n, const uint16_t* r, const uint32_t* table, uint32_t* out) {
  on_group(4, [&](int t) {
    EdTasks f;
    for (int i = 0; i < n; ++i) {
      EdPt p = k8lane::rb_lane(f, r + 16 * i, (const uint4*)table);
      if (t == 0) {
        memcpy(out + 24 * i, p.x.v, 32);
        memcpy(out + 24 * i + 8, p.y.v, 32);
        memcpy(out + 24 * i + 16, p.z.v, 32);
      }
    }
  });
}

// stdin: "ops T op n" + 16 words a line | "k7 n" + 41 words a row |
// "k8 n" + 16 u16 a row, then the table's 24,576 words; hex.
int main() {
  char kind[8];
  int T = 4, n, op = 0;
  if (scanf("%7s", kind) != 1) return 1;
  std::string k(kind);
  if (k == "ops" && scanf("%d %d", &T, &op) != 2) return 1;
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
  } else if (k == "k7") {
    std::vector<uint32_t> rows(41 * n), out(n);
    for (auto& x : rows) { rd(v); x = v; }
    k7(n, rows.data(), out.data());
    for (int i = 0; i < n; ++i) printf("%u\n", out[i]);
  } else {
    std::vector<uint16_t> rr(16 * n);
    for (auto& x : rr) { rd(v); x = (uint16_t)v; }
    std::vector<uint32_t> table(64 * 16 * 24), out(24 * n);
    for (auto& x : table) { rd(v); x = v; }
    k8(n, rr.data(), table.data(), out.data());
    for (int i = 0; i < 24 * n; ++i) printf("%x%c", out[i], i % 24 == 23 ? '\n' : ' ');
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the CUDA header for the host")
    d = tmp_path_factory.mktemp("ed25519_field")
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


def _want(op: str, a: int, b: int) -> int:
    """Big-integer values: products and the inverse mod p; add and sub by
    the generic ops' rule (subtract p once iff a + b, or a + p - b, lies
    outside [0, p); the result mod 2^256), which is (a +- b) mod p for
    operands below p."""
    if op == "mul":
        return a * b % P
    if op == "sqr":
        return a * a % P
    if op == "mul38":
        return 38 * a % P
    if op == "inv":
        return pow(a, P - 2, P)
    t = a + b if op == "add" else a + P - b
    return t % R if 0 <= t < P else (t - P) % R


OPS = ("mul", "sqr", "add", "sub", "mul38", "inv")
# Threads per lane: 1 is EdF1, the one-thread ops (K1's wrapper, and each
# thread of a group); 4 the group K7, K7' and K8 run on.
GROUPS = (1, 4)
EDGES = [0, 1, 2, 19, 38, P - 2, P - 1, P, P + 1, 1 << 255, R - 39, R - 38, R - 1]


def _ops(exe: str, op: str, group: int, va: list, vb: list) -> list:
    text = f"ops {group} {OPS.index(op)} {len(va)}\n" + "\n".join(
        " ".join(f"{w:x}" for w in _words(a) + _words(b)) for a, b in zip(va, vb)
    )
    return [sum(int(w, 16) << (32 * j) for j, w in enumerate(line))
            for line in _run(exe, text)]


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("op", OPS)
def test_field_op_matches_big_integers(host_bin, op, group):
    rng = random.Random(OPS.index(op) * 10 + group)
    n = 8 if op == "inv" else 120
    va = EDGES + [rng.randrange(P) for _ in range(n)] + [rng.randrange(R) for _ in range(8)]
    vb = EDGES[::-1] + [rng.randrange(P) for _ in range(n)] + [rng.randrange(R) for _ in range(8)]
    got = _ops(host_bin, op, group, va, vb)
    bad = [(hex(a), hex(b)) for a, b, g in zip(va, vb, got) if g != _want(op, a, b)]
    assert not bad, f"{op} T={group}: {len(bad)} wrong, first {bad[0]}"


@pytest.mark.parametrize("group", GROUPS)
def test_inverse_of_zero_is_zero(host_bin, group):
    assert _ops(host_bin, "inv", group, [0, 1, P], [0, 0, 0]) == [0, 1, 0]


def _small_order_items() -> list:
    """Keys of order 1, 2 and 4 ((0, 1), (0, -1), (sqrt(-1), 0)) with R =
    S*B: the strict cofactorless verify accepts where k*A' vanishes."""
    items = []
    for j, y in enumerate((1, P - 1, 0)):
        pub = y.to_bytes(32, "little")
        assert hc.ed_decompress(pub) is not None
        s = 1 + 7919 * (j + 1)
        r_enc = hc.ed_compress(hc.ed_scalar_mult(s, hc.ED_BASE))
        items.append((pub, b"small order %d" % j, r_enc + s.to_bytes(32, "little")))
    return items


@pytest.fixture(scope="module")
def verify_rows(lanes):  # noqa: F811
    items = list(lanes[0]) + _small_order_items()
    rows = ed25519.prepare_packed(items, 16)
    want = ed25519.verify_packed_plain(torch.from_numpy(rows.astype(np.int64))).numpy()
    host = [hc.ed25519_verify_py(*it) for it in items]
    assert list(want[: len(items)]) == host and not want[len(items):].any()
    return rows, want


# The 16 rows in two runs (the emulated group costs ~1 s a valid lane).
@pytest.mark.parametrize("half", (0, 1))
def test_k7_lane_matches_the_plain_version(host_bin, verify_rows, half):
    rows, want = verify_rows
    lanes_ = np.arange(8 * half, 8 * half + 8)
    words = np.ascontiguousarray(rows[lanes_]).view(np.uint32)
    text = f"k7 {len(lanes_)}\n" + "\n".join(
        " ".join(f"{v:x}" for v in r) for r in words)
    got = np.array([int(line[0]) for line in _run(host_bin, text)], bool)
    assert want[lanes_].any() and not want[lanes_].all()
    np.testing.assert_array_equal(got, want[lanes_])


@pytest.mark.parametrize("nonces", [
    [0, 1, ed25519.L - 1, 16],
    [1 << 250] + [random.Random(8).randrange(ed25519.L) for _ in range(3)],
], ids=("edges", "random"))
def test_k8_lane_matches_the_plain_version_bit_for_bit(host_bin, nonces):
    r = limbs.to_limbs_batch(nonces).astype(np.uint16)
    tab = ed25519.comb_table_words("cpu").numpy().view(np.uint32).reshape(-1)
    text = (f"k8 {len(r)}\n"
            + "\n".join(" ".join(f"{v:x}" for v in row) for row in r) + "\n"
            + " ".join(f"{v:x}" for v in tab))
    got = np.array([[int(w, 16) for w in line] for line in _run(host_bin, text)], np.uint32)
    want = ed25519.rb_plain(torch.from_numpy(r.astype(np.int64)), ed25519.comb_table_limbs())
    np.testing.assert_array_equal(got.view(np.uint16).reshape(len(r), 3, 16),
                                  want.numpy().astype(np.uint16))
