"""Phase 14's deployment drive of ``chip_smoke.py`` from two checkouts on
one card, interleaved, and phase 15's chaos drive beside a clean drive
of the same size.

    python3 chip_deploy_ab.py --a <checkout> --b <checkout>

Each drive runs in a fresh process from its own checkout: that
checkout's ``chip_smoke.run_deployment(bench, checkout)`` at its
defaults (``peer testnet`` n = 4 with NATIVE_ECDSA USIGs, four ``peer
run`` processes over TCP with their engines on cuda:0, one ``peer
bench`` of 20 clients x depth 24), 2,000 requests, in the order A B B
A.  The kernel libraries of each checkout are built first, so no drive
pays a build.  Then, from ``--b`` only:

- clean, chaos, chaos, clean drives of 1,000 requests each (the chaos
  drive is ``run_deployment(..., chaos=True)``: the smoke's phase 15,
  whose size this is), so the two compare at one request count;
- one process that runs the bench's ``ingest`` and ``readonly``
  sections (the part of phase 13 the smoke runs just before phase 14)
  and then a clean drive of 2,000, to show whether they leave anything
  behind that slows the drive.

A host probe (a fixed pure-Python and hashing load, in seconds) is
printed first.  Every drive prints one JSON line (committed req/s,
latency p50/p99, seconds, start-up, each replica's host CPU seconds per
wall second, launches).  Needs one CUDA card and the repository beside it; exits non-zero
otherwise or when a drive fails."""

import argparse
import json
import os
import subprocess
import sys
import time

DRIVE = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke
from minbft_tpu_torch import bench
kind, n = sys.argv[1], int(sys.argv[2])
pre = {}
if kind == "after13":
    t0 = time.time()
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bench.main(["ingest", "readonly"])
    if rc != 0:
        sys.exit(f"ingest/readonly: exit code {rc}")
    pre = {"phase13_s": round(time.time() - t0, 1)}
kw = {"chaos": True} if kind == "chaos" else {}
r = chip_smoke.run_deployment(bench, os.getcwd(), n_requests=n, **kw)
keep = ("requests", "seconds", "req_per_sec", "p50_ms", "p99_ms", "start_s",
        "replica_cpu_per_wall", "client_cpu_per_wall", "launches")
print("DRIVE " + json.dumps({**{k: r[k] for k in keep if k in r}, **pre}))
"""

BUILD = ("from minbft_tpu_torch.ops import backend; "
         "print(round(backend.EXTENSION.build_all(), 1))")


def host_probe() -> float:
    """Seconds one interpreter takes for a fixed pure-Python and hashing
    load: the host's single-core speed, which the replicas' host-bound
    drives follow (each call gets its own machine)."""
    import hashlib

    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc = (acc * 31 + i) & 0xFFFFFFFF
    h = hashlib.sha256()
    block = bytes(1 << 20)
    for _ in range(256):
        h.update(block)
    return time.perf_counter() - t0


def run(tree: str, code: str, *args, timeout: float) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=tree + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code, *args], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="first checkout (e.g. the parent)")
    ap.add_argument("--b", required=True, help="second checkout (e.g. the change)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_deploy_ab: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"host probe: {host_probe():.3f} s; {os.cpu_count()} CPUs")
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    for label, tree in trees.items():
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            print(f"chip_deploy_ab: {tree} holds no chip_smoke.py", file=sys.stderr)
            return 2
        res = run(tree, BUILD, timeout=600)
        if res.returncode != 0:
            print(f"build {label}: {res.stderr[-2000:]}", file=sys.stderr)
            return 1
        print(f"build {label} ({tree}): {res.stdout.strip()} s")
    plan = [(c, "clean", 2000) for c in "ABBA"]
    plan += [("B", kind, 1000) for kind in ("clean", "chaos", "chaos", "clean")]
    plan.append(("B", "after13", 2000))
    failed = 0
    for i, (label, kind, n) in enumerate(plan, 1):
        t0 = time.time()
        res = run(trees[label], DRIVE, kind, str(n), timeout=1200)
        line = next((ln[6:] for ln in res.stdout.splitlines()
                     if ln.startswith("DRIVE ")), None)
        if res.returncode != 0 or line is None:
            failed += 1
            print(f"drive {i} {label} {kind} {n}: rc {res.returncode}: "
                  f"{res.stdout[-1000:]} {res.stderr[-2000:]}", file=sys.stderr)
            continue
        row = {"drive": i, "tree": label, "kind": kind, "card": smi,
               "wall_s": round(time.time() - t0, 1), **json.loads(line)}
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
