"""Whole-system tests of the port's deployment path: ``peer run``
replica *processes* of ``minbft_tpu_torch`` over TCP or gRPC sockets
commit requests from ``peer request`` processes — the reference's
``tests/test_process_cluster.py`` flow on the port, plus an engine
cluster (``--device cpu``: the kernels' plain versions behind the CLI)
and a mixed cluster of reference and port replica processes.

Replicas run ``--no-batch`` (serial host crypto) except in the engine
test, so no plain kernel runs where it is not the point; the last test
rehearses ``chip_smoke.py``'s chaos phase with host crypto."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from minbft_tpu_torch.utils.netports import free_base_port, wait_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = {"port": "minbft_tpu_torch.sample.peer", "ref": "minbft_tpu.sample.peer"}
HEX64 = re.compile(r"^[0-9a-f]{64}$")


def _scaffold(d, n, usig="SOFT_ECDSA", n_clients=1) -> int:
    """``peer testnet`` into ``d`` at a free base port, which it returns."""
    base_port = free_base_port(n)
    res = subprocess.run(
        [sys.executable, "-m", MODULE["port"], "testnet", "-n", str(n), "-d", d,
         "--base-port", str(base_port), "--usig", usig, "--clients", str(n_clients)],
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return base_port


@pytest.fixture(scope="module")
def scaffold3(tmp_path_factory):
    """One n = 3 SOFT_ECDSA scaffold for the module's three-replica port
    clusters: each copies it into its own directory and runs on its
    ports, one cluster after another."""
    d = str(tmp_path_factory.mktemp("scaffold3"))
    return d, _scaffold(d, 3)


class _Cluster:
    """n replica processes from a scaffold (made here, or a shared one
    copied in); ``packages[i]`` says which package runs replica i."""

    def __init__(self, d, packages, transport="tcp", env=None, run_args=("--no-batch",),
                 usig="SOFT_ECDSA", n_clients=1, scaffold=None):
        self.d = d
        self.packages = packages
        self.n = len(packages)
        self.transport = transport
        self.env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                        + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                        **(env or {}))
        if scaffold is None:
            self.base_port = _scaffold(d, self.n, usig, n_clients)
        else:  # a shared scaffold: (its directory, its base port)
            shutil.copytree(scaffold[0], d, dirs_exist_ok=True)
            self.base_port = scaffold[1]
        self.procs, self.logs = [], []
        for i, pkg in enumerate(packages):
            log = open(f"{d}/replica{i}.log", "wb")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE[pkg], *self.common(f"keys.replica{i}.yaml"),
                 "run", str(i), *run_args],
                env=self.env, stdout=subprocess.DEVNULL, stderr=log))
        assert wait_ports([self.base_port + i for i in range(self.n)]), self.tails()

    def common(self, keys="keys.yaml"):
        return ["--keys", f"{self.d}/{keys}", "--config", f"{self.d}/consensus.yaml",
                "--transport", self.transport]

    def request(self, *args, package="port", timeout=120):
        extra = ["--no-batch"] if package == "port" and "--device" not in args else []
        res = subprocess.run(
            [sys.executable, "-m", MODULE[package], *self.common(), "request",
             "--timeout", str(timeout), *extra, *args],
            env=self.env, capture_output=True, text=True, timeout=timeout + 60)
        assert res.returncode == 0, res.stderr + self.tails()
        return res.stdout.strip()

    def log(self, i) -> str:
        with open(f"{self.d}/replica{i}.log", errors="replace") as fh:
            return fh.read()

    def tails(self) -> str:
        return "".join(f"\n--- replica {i}\n{self.log(i)[-1500:]}" for i in range(self.n))

    def stop(self, i, kill=False) -> int:
        p = self.procs[i]
        p.kill() if kill else p.terminate()
        return p.wait(timeout=30)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            log.close()


@pytest.mark.parametrize("transport", ["tcp", "grpc"])
def test_three_process_cluster_commits(tmp_path, scaffold3, transport):
    """n = 3 port processes: a request commits (over TCP the read-only
    fast path then returns height 1 and that digest), a backup stopped by
    SIGTERM exits 0 and the remaining two still commit.  No ERROR record
    until the stop (over gRPC the survivors log the stopped peer's
    failed stream at ERROR, as the reference's core does)."""
    c = _Cluster(str(tmp_path), ["port"] * 3, transport=transport, scaffold=scaffold3)
    try:
        digest = c.request("process-cluster-op")
        assert HEX64.match(digest)
        if transport == "tcp":
            head = c.request("head", "--read-only", "--no-read-fallback")
            assert head == "0000000000000001" + digest
        for i in range(3):
            assert " ERROR " not in c.log(i), c.tails()
        assert c.stop(2) == 0
        assert "replica 2 shutting down" in c.log(2)
        assert HEX64.match(c.request("after-backup-stop"))
    finally:
        c.close()


def test_primary_crash_recovers_by_view_change(tmp_path, scaffold3):
    """Kill the view-0 primary process; the next request commits in a
    later view through the view-change protocol."""
    c = _Cluster(str(tmp_path), ["port"] * 3, env={
        "CONSENSUS_TIMEOUT_REQUEST": "2s", "CONSENSUS_TIMEOUT_PREPARE": "1s",
        "CONSENSUS_TIMEOUT_VIEWCHANGE": "5s"}, scaffold=scaffold3)
    try:
        assert HEX64.match(c.request("before-primary-crash"))
        c.stop(0, kill=True)
        assert HEX64.match(c.request("after-primary-crash", timeout=150))
        assert any("entered view" in c.log(i) for i in (1, 2)), c.tails()
    finally:
        c.close()


def test_engine_cluster_on_cpu_devices_with_hmac_usig(tmp_path):
    """The engine seam through the CLI: n = 4 port processes, each with
    its engine on ``--device cpu`` (the kernels' plain versions: K2 for
    REQUEST signatures, K6 for the HMAC USIG certificates, K3 for REPLY
    signatures), commit a request from a client whose engine is on the
    CPU too; on SIGTERM each exits 0 and its engine dump shows the
    batches it ran."""
    d = str(tmp_path)
    c = _Cluster(d, ["port"] * 4, usig="HMAC_SHA256",
                 run_args=("--device", "cpu", "--batch", "8"),
                 env={"MINBFT_TRACE_DUMP": f"{d}/trace", "OMP_NUM_THREADS": "2",
                      "CONSENSUS_TIMEOUT_REQUEST": "120s",
                      "CONSENSUS_TIMEOUT_PREPARE": "60s"})
    try:
        assert HEX64.match(c.request("--device", "cpu", "engine-op", timeout=240))
        # One at a time: each survivor shuts down after its peers left.
        for i in range(4):
            assert c.stop(i) == 0, c.tails()
        for i in range(4):
            with open(f"{d}/trace.engine{i}.json") as fh:
                rep = json.load(fh)["engine"]
            assert rep["device"] == "cpu"
            assert rep["verify"]["hmac_sha256"]["batches"] > 0
            assert all(q["dispatch_timeouts"] == 0 for q in rep["verify"].values())
            assert " ERROR " not in c.log(i)
            # the engine report the bench reads from the log
            assert f"replica {i} engine {{" in c.log(i)
        # REQUEST verified by every replica, REPLY signed by those that
        # executed it
        signed = [json.load(open(f"{d}/trace.engine{i}.json"))["engine"]["sign"]
                  for i in range(4)]
        assert sum(s.get("ecdsa_p256", {}).get("items", 0) for s in signed) >= 2
        assert all(s.get("ecdsa_p256", {}).get("host_fallback_items", 0) == 0
                   for s in signed)
    finally:
        c.close()


def test_mixed_reference_and_port_processes_over_tcp(tmp_path):
    """n = 3, f = 1: replicas 0 and 1 from the port, replica 2 from the
    reference, over TCP, with native USIGs (fresh epochs learned by trust
    on first use) where the reference's native module builds.  The
    reference's client commits a request; then port replica 1 is killed,
    so the f + 1 = 2 matching REPLYs the port's client waits for must
    come from port replica 0 and reference replica 2: the accepted digest
    is one both packages computed."""
    from minbft_tpu.usig import native as ref_native

    usig = "NATIVE_ECDSA" if ref_native.available(auto_build=True) else "SOFT_ECDSA"
    c = _Cluster(str(tmp_path), ["port", "port", "ref"], usig=usig)
    try:
        first = c.request("mixed-1", package="ref")
        assert HEX64.match(first)
        c.stop(1, kill=True)
        second = c.request("mixed-2")
        assert HEX64.match(second) and second != first
        for i in (0, 2):
            assert " ERROR " not in c.log(i), c.tails()
    finally:
        c.close()


def test_smoke_chaos_phase_rehearsed_with_host_crypto():
    """``chip_smoke.run_deployment(chaos=True)`` — the card's phase 15 — with
    ``device=None`` (``--no-batch`` replicas and client): four replica
    processes over TCP under ``MINBFT_CHAOS_SEED`` and the ``lossy`` plan
    with ``--metrics-port 0`` commit every request of a ``peer bench``;
    ``peer metrics``, ``top --once`` and ``slo --json`` read the live
    endpoints; each replica's scraped census is non-zero and equals the
    replay of the seed over its scraped frames; every process exits 0."""
    import chip_smoke
    from minbft_tpu_torch import bench

    out = chip_smoke.run_deployment(bench, REPO, device=None, n_requests=160,
                                    n_clients=4, depth=8, chaos=True)
    assert out["requests"] == 160 and len(out["replicas"]) == 4
    assert out["top"][0].startswith("TARGET") and len(out["top"]) >= 5
    for row in out["replicas"]:
        # Under the smoke's pinned seed every replica has a link whose
        # first frame draws a fault, so a census is never empty by chance.
        assert sum(row["census"].values()) > 0 and row["frames"] > 0
        assert "report" not in row  # no engine without a device
    assert out["phase_s"] < chip_smoke.CHAOS_BUDGET_S


def test_smoke_groups_and_load_phases_rehearsed_with_host_crypto():
    """``chip_smoke.py``'s phases 16 and 17 with ``device=None``
    (``--no-batch``): ``run_deployment(groups=4)`` — a 4-group testnet,
    four replica processes over TCP with ``--metrics-port 0`` and a ``peer
    bench`` routing by key — executes every
    request on every replica (each scrape labelled per group) and every
    replica's ledgers line is the same; ``run_peer_load`` at 1 and 4 groups
    exits 0 with the census of the seed."""
    import chip_smoke
    from minbft_tpu_torch import bench

    out = chip_smoke.run_deployment(bench, REPO, device=None, n_requests=40, n_clients=4,
                                    depth=8, groups=4)
    assert out["requests"] == 40
    (ledgers,) = out["ledgers"]
    assert [g["group"] for g in ledgers] == [0, 1, 2, 3]
    assert sum(g["length"] for g in ledgers) == 40 + 4
    assert out["executed_by_group"][0] == {str(g["group"]): g["length"] for g in ledgers}
    assert out["phase_s"] < chip_smoke.GROUPS_BUDGET_S
    for n_groups in (1, 4):
        rep = chip_smoke.run_peer_load(REPO, n_groups, device=None, rate=40.0, duration=1.0,
                                       clients=40)
        assert rep["census_ok"] and rep["n_groups"] == n_groups and "engine" not in rep
