"""The SHA-256 device functions of ``csrc/sha256.cuh`` (K5) and the HMAC
lane function of ``csrc/hmac_sha256.cu`` (K6, K6', K6s), compiled for the
host with g++ and held against the port's plain versions, ``hashlib`` and
Python's ``hmac``.

``__funnelshift_r`` gets a host body; the kernel source is included whole:
its kernels and launchers sit under ``__CUDACC__``, and a stub
``cuda_runtime.h`` stands in for CUDA's.  So the compressions, their
split form and the three-stage ``hmac32`` on a lane's 2 threads (host
threads, with an emulated ``__shfl_xor_sync``) run here exactly as
written; what only the card shows (ptxas, the SASS) the smoke
checks there (``chip_smoke.py`` phases 1, 6 and 12).  Skipped where no
g++ is installed.
"""

from __future__ import annotations

import hashlib
import hmac as py_hmac
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from minbft_tpu_torch.ops import hmac_sha256, sha256

CSRC = os.path.join(os.path.dirname(__file__), "..", "minbft_tpu_torch", "csrc")

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
#define __forceinline__ inline
#define __constant__
struct uint4 { uint32_t x, y, z, w; };
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31u;
  return s ? (lo >> s) | (hi << (32u - s)) : lo;
}
// A lane's pair of threads meets at a barrier to swap a value.
static std::barrier<>* g_bar;
static uint32_t g_buf[2];
static thread_local uint32_t g_rank;
static inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int m) {
  g_buf[g_rank] = v;
  g_bar->arrive_and_wait();
  uint32_t r = g_buf[g_rank ^ (uint32_t)m];
  g_bar->arrive_and_wait();
  return r;
}
#include "hmac_sha256.cu"

static void rd(uint32_t* p, int n) {
  for (int i = 0; i < n; ++i) {
    unsigned v;
    if (scanf("%x", &v) != 1) exit(1);
    p[i] = v;
  }
}
static void wr(const uint32_t* p, int n) {
  for (int i = 0; i < n; ++i) printf("%x%c", p[i], i == n - 1 ? '\n' : ' ');
}

// HMAC of one row on the lane's 2 threads (host threads).
void hmac_row(const uint32_t* row, uint32_t got[2][8]) {
  std::barrier<> bar(2);
  g_bar = &bar;
  std::vector<std::thread> th;
  for (int r = 0; r < 2; ++r)
    th.emplace_back([&, r] {
      g_rank = (uint32_t)r;
      hmac32(row, row + 8, got[r], (uint32_t)r, 0u);
    });
  for (auto& t : th) t.join();
}

// stdin: "c n" | "kw n", then n lines of 8 state + 16 block words | "h n",
// then n rows of key | msg | mac; hex.  Out: a state per line | a MAC and
// the verdict per row.
int main() {
  char kind[8];
  int n;
  if (scanf("%7s %d", kind, &n) != 2) return 1;
  std::string k(kind);
  if (k == "h") {
    for (int i = 0; i < n; ++i) {
      uint32_t row[24], got[2][8];
      rd(row, 24);
      hmac_row(row, got);
      if (memcmp(got[1], got[0], 32)) return 2;  // the pair disagrees
      uint32_t out[9];
      memcpy(out, got[0], 32);
      out[8] = equal8(got[0], row + 16);
      wr(out, 9);
    }
    return 0;
  }
  std::vector<uint32_t> st(8 * n), w(16 * n);
  for (int i = 0; i < n; ++i) {
    rd(&st[8 * i], 8);
    rd(&w[16 * i], 16);
  }
  for (int i = 0; i < n; ++i) {
    uint32_t* s = &st[8 * i];
    uint32_t* b = &w[16 * i];
    if (k == "c") {
      sha256::compress(s, b);
    } else {
      uint32_t kw[64];
      sha256::expand(b, kw);
      sha256::compress_kw(s, kw);
    }
  }
  for (int i = 0; i < n; ++i) wr(&st[8 * i], 8);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the CUDA source for the host")
    d = tmp_path_factory.mktemp("hmac_lane")
    (d / "cuda_runtime.h").write_text("// stand-in: the harness defines what the lane code uses\n")
    (d / "host.cpp").write_text(HARNESS)
    exe = d / "host"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", f"-I{CSRC}", f"-I{d}", "-o", str(exe),
         str(d / "host.cpp"), "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    return str(exe)


def _run(exe: str, head: str, rows: np.ndarray) -> np.ndarray:
    text = head + "\n" + "\n".join(" ".join(f"{v:x}" for v in r) for r in rows)
    out = subprocess.run([exe], input=text, capture_output=True, text=True,
                         check=True, timeout=120).stdout
    return np.array([[int(w, 16) for w in line.split()] for line in out.splitlines()],
                    dtype=np.uint32)


@pytest.fixture(scope="module")
def blocks():
    """24 (state, block) pairs: 8 one-block messages from the IV (their
    digests are hashlib's), then random states and blocks."""
    rng = np.random.default_rng(7)
    msgs = [b"", b"abc", bytes(55)] + [rng.bytes(int(n)) for n in (1, 13, 31, 32, 54)]
    st = np.tile(sha256.IV, (24, 1))
    blk = rng.integers(0, 2**32, size=(24, 16), dtype=np.uint32)
    for i, m in enumerate(msgs):
        blk[i] = sha256.pad_message(m)[0]
    st[len(msgs):] = rng.integers(0, 2**32, size=(24 - len(msgs), 8), dtype=np.uint32)
    want = sha256.as_u32(sha256.compress(torch.from_numpy(st.astype(np.int64)),
                                         torch.from_numpy(blk.astype(np.int64))))
    for i, m in enumerate(msgs):
        assert sha256.words_to_bytes(want[i]) == hashlib.sha256(m).digest()
    return st, blk, want


@pytest.mark.parametrize("form", ["c", "kw"])
def test_compressions_match_the_plain_version_and_hashlib(host_bin, blocks, form):
    """compress and expand + compress_kw."""
    st, blk, want = blocks
    got = _run(host_bin, f"{form} {len(st)}", np.concatenate([st, blk], axis=1))
    np.testing.assert_array_equal(got, want)


def _pairs(kind: str) -> list:
    """28 (key, msg) pairs: random, or edge keys and messages (all zero,
    all ones, the ipad and opad bytes, one bit set) with random partners."""
    rng = np.random.default_rng(11 if kind == "random" else 13)
    if kind == "random":
        return [(rng.bytes(32), rng.bytes(32)) for _ in range(28)]
    edges = [bytes(32), b"\xff" * 32, b"\x36" * 32, b"\x5c" * 32,
             b"\x80" + bytes(31), bytes(31) + b"\x01", b"\x36\x5c" * 16]
    return ([(e, rng.bytes(32)) for e in edges] + [(rng.bytes(32), e) for e in edges]
            + [(e, f) for e in edges for f in edges[:2]])


@pytest.mark.parametrize("kind", ["random", "edges"])
def test_hmac32_matches_python_hmac_and_the_plain_version(host_bin, kind):
    """hmac32 on a lane's 2 threads, over 32 rows: 28 (key, msg) pairs
    with their MACs, one bit flipped in the mac, the key or the message on
    every fourth, and four all-zero (padding) rows."""
    rows = np.zeros((32, 24), dtype=np.uint32)
    macs = []
    for i, (key, msg) in enumerate(_pairs(kind)):
        mac = py_hmac.new(key, msg, hashlib.sha256).digest()
        rows[i] = np.frombuffer(key + msg + mac, dtype=">u4")
    for j, i in enumerate(range(2, 28, 4)):
        rows[i, [16, 0, 8][j % 3] + j % 8] ^= np.uint32(1 << (5 * j % 32))
    for r in rows:
        b = r.astype(">u4").tobytes()
        macs.append(np.frombuffer(py_hmac.new(b[:32], b[32:64], hashlib.sha256).digest(),
                                  ">u4").astype(np.uint32))
    expect = np.array([py_hmac.compare_digest(m.astype(">u4").tobytes(),
                                              r[16:].astype(">u4").tobytes())
                       for m, r in zip(macs, rows)])
    assert 0 < expect.sum() < 28
    got = _run(host_bin, f"h {len(rows)}", rows)
    np.testing.assert_array_equal(got[:, :8], np.stack(macs))
    np.testing.assert_array_equal(got[:, 8].astype(bool), expect)
    plain = hmac_sha256.hmac_verify_plain(torch.from_numpy(rows.astype(np.int64)))
    np.testing.assert_array_equal(plain.numpy(), expect)
