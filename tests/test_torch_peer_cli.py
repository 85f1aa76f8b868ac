"""The port's ``peer`` CLI (``minbft_tpu_torch.sample.peer``): the shared
subcommands parse to the reference's namespace, the ``PEER_*`` and
``peer.yaml`` layering, the scaffold and the selftest (with its chaos
mode), the device rule (no CUDA and neither ``--device cpu`` nor
``--no-batch``: exit non-zero), the metrics endpoint and its readers
(``run --metrics-port``, ``metrics``, ``top``, ``slo``: a replica process
under ``MINBFT_CHAOS_SEED`` scraped as a user would, and the consoles'
output on a fixed exposition against the reference's), multi-group
deployments (``run --groups`` and a grouped ``request`` on a CPU engine:
every replica's ledgers equal per group), ``load`` (a CPU engine: exit
code 0, the census the seed's replay), and the options whose modules are
not ported yet (exit non-zero, naming the ROADMAP item)."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from minbft_tpu.sample.peer import cli as ref_cli
from minbft_tpu_torch.sample.authentication import KeyStore
from minbft_tpu_torch.sample.config import load_config
from minbft_tpu_torch.sample.peer import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv of each subcommand both CLIs have, with every option the reference
# knows given once (the port adds --device, and --no-batch to request and
# bench).
SHARED_ARGV = [
    ["--keys", "k.yaml", "--config", "c.yaml", "--auth", "mac", "--transport",
     "tcp", "--log-level", "debug", "run", "3", "--listen", "127.0.0.1:1",
     "--batch", "64", "--no-batch", "--metrics-interval", "2.5",
     "--peer-idle-timeout", "9", "--state-dir", "/s"],
    ["run", "0"],
    ["request", "a", "b", "--client-id", "2", "--timeout", "5", "--read-only",
     "--no-read-fallback", "--group", "0"],
    ["--transport", "tcp", "bench", "--clients", "20", "--client-base", "20",
     "--requests", "2000", "--depth", "48", "--timeout", "60", "--tag", "x"],
    ["selftest"],
    ["selftest", "--chaos-seed", "0x7", "--chaos-profile", "flaky"],
    ["metrics", "127.0.0.1:1", "127.0.0.1:2", "--timeout", "2", "--merged-only"],
    ["top", "127.0.0.1:1", "--interval", "1", "--once", "--timeout", "2",
     "--no-clear", "--stall-flag"],
    ["slo", "127.0.0.1:1", "--timeout", "2", "--json", "--dumps", "base",
     "--breach-flag"],
    ["testnet", "-n", "7", "-f", "3", "--clients", "20", "--base-port", "4000",
     "--host", "10.0.0.1", "-d", "net", "--usig", "NATIVE_ECDSA", "--macs", "--groups", "4"],
    ["load", "--rate", "50", "--duration", "2", "--seed", "0x5", "--process", "onoff",
     "--clients", "10", "--conns", "2", "--replicas", "7", "--groups", "2",
     "--read-fraction", "0.1", "--large-fraction", "0.2", "--scheme", "ecdsa-p256",
     "--expect-goodput", "1.5", "--drain", "3", "--slo-target-ms", "100"],
    ["load"],
]
PORT_ONLY = {"device", "no_batch"}


@pytest.fixture(autouse=True)
def _no_peer_env(monkeypatch):
    for var in list(os.environ):
        if var.startswith("PEER_") or var == "MINBFT_CHAOS_SEED":
            monkeypatch.delenv(var)


SUBCOMMANDS = ("run", "request", "bench", "selftest", "testnet", "metrics", "top", "slo",
               "load")


def _argv_id(argv):
    sub = next(x for x in argv if x in SUBCOMMANDS)
    return sub + ("-chaos" if "--chaos-seed" in argv else "")


@pytest.mark.parametrize("argv", SHARED_ARGV, ids=_argv_id)
def test_shared_subcommands_parse_to_the_reference_namespace(argv):
    port = vars(cli.build_parser().parse_args(argv))
    ref = vars(ref_cli.build_parser().parse_args(argv))
    extra = set(port) - set(ref)
    assert extra <= PORT_ONLY
    assert {k: v for k, v in port.items() if k not in extra} == ref
    if port["command"] in ("run", "request", "bench", "selftest", "load"):
        assert port["device"] == "cuda:0"


def test_peer_options_file_and_env_layering(tmp_path, monkeypatch):
    """File values replace the defaults, ``PEER_*`` overrides the file,
    flags override both (reference root.go:54-82), the port's ``device``
    included."""
    opt_file = tmp_path / "peer.yaml"
    opt_file.write_text(
        "keys: /etc/minbft/keys.yaml\nlog_level: debug\n"
        "run:\n  batch: 128\n  metrics_interval: 5\n  device: cpu\n"
        "request:\n  timeout: 7.5\n"
    )
    opts = cli.load_peer_options(str(opt_file), explicit=True)
    args = cli.build_parser(opts).parse_args(["run", "0"])
    assert (args.keys, args.log_level, args.batch, args.metrics_interval,
            args.device) == ("/etc/minbft/keys.yaml", "debug", 128, 5.0, "cpu")
    monkeypatch.setenv("PEER_BATCH", "64")
    monkeypatch.setenv("PEER_DEVICE", "cuda:1")
    args = cli.build_parser(opts).parse_args(["run", "0"])
    assert (args.batch, args.device) == (64, "cuda:1")
    args = cli.build_parser(opts).parse_args(["--keys", "k2.yaml", "run", "0",
                                              "--device", "cpu"])
    assert (args.keys, args.device) == ("k2.yaml", "cpu")
    assert cli.build_parser(opts).parse_args(["request", "op"]).timeout == 7.5
    monkeypatch.setenv("PEER_BATCH", "many")
    with pytest.raises(SystemExit, match="PEER_BATCH"):
        cli.build_parser(opts)
    bad = tmp_path / "bad.yaml"
    bad.write_text("run:\n  batsch: 10\n")
    with pytest.raises(SystemExit, match="unknown option"):
        cli.load_peer_options(str(bad), explicit=True)


def test_testnet_scaffold_and_selftest(tmp_path, monkeypatch):
    d = str(tmp_path)
    assert cli.main(["testnet", "-n", "5", "--clients", "2", "-d", d, "--usig",
                     "SOFT_ECDSA", "--base-port", "45100"]) == 0
    store = KeyStore.load(f"{d}/keys.yaml")
    assert len(store.replica_keys) == 5 and len(store.client_keys) == 2
    cfg = load_config(f"{d}/consensus.yaml")
    assert (cfg.n, cfg.f) == (5, 2)
    assert [p.addr for p in cfg.peers] == [f"127.0.0.1:{45100 + i}" for i in range(5)]
    with pytest.raises(SystemExit):
        cli.main(["testnet", "-n", "3", "-f", "2", "-d", d])
    # --usig auto: native when it builds, else the software seal.
    from minbft_tpu_torch.usig import native

    monkeypatch.setattr(native, "available", lambda: False)
    assert cli.main(["testnet", "-n", "3", "-d", f"{d}/soft", "--usig", "auto"]) == 0
    assert KeyStore.load(f"{d}/soft/keys.yaml").usig_spec == "SOFT_ECDSA"
    monkeypatch.undo()
    assert cli.main(["selftest", "--no-batch"]) == 0


@pytest.fixture
def testnet(tmp_path):
    d = str(tmp_path)
    assert cli.main(["testnet", "-n", "3", "-d", d, "--usig", "SOFT_ECDSA"]) == 0
    return ["--keys", f"{d}/keys.yaml", "--config", f"{d}/consensus.yaml"]


@pytest.mark.parametrize("sub", [["run", "0"], ["request", "op"], ["bench"], ["selftest"],
                                 ["load", "--duration", "0.1"]],
                         ids=lambda s: s[0])
def test_no_cuda_and_no_cpu_or_no_batch_exits(sub, testnet, monkeypatch):
    """The device rule: without CUDA, the default ``--device cuda:0``
    exits non-zero with a message — nothing falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(testnet + sub)
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code) and "--no-batch" in str(e.value.code)


def test_no_cuda_exits_non_zero_as_a_process(testnet):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "minbft_tpu_torch.sample.peer", *testnet, "run", "0"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr


@pytest.mark.parametrize("argv,item", [
    (["run", "0", "--no-batch", "--chips", "2", "--groups", "2"], "item 7"),
    (["run", "0", "--no-batch", "--chips", "0"], "item 7"),
], ids=["argv1-item 7", "argv2-item 7"])
def test_unported_run_options_exit(argv, item, testnet):
    with pytest.raises(SystemExit) as e:
        cli.main(testnet + argv)
    assert "not supported by the port yet" in str(e.value.code)
    assert item in str(e.value.code)


def test_grouped_request_pins_are_checked_against_the_config(tmp_path):
    d = str(tmp_path)
    assert cli.main(["testnet", "-n", "3", "-d", d, "--usig", "SOFT_ECDSA",
                     "--groups", "2"]) == 0
    assert load_config(f"{d}/consensus.yaml").groups == 2
    argv = ["--keys", f"{d}/keys.yaml", "--config", f"{d}/consensus.yaml", "request",
            "--no-batch", "--group"]
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(argv + ["2", "op"])
    assert cli.main(["testnet", "-n", "3", "-d", f"{d}/plain", "--usig", "SOFT_ECDSA"]) == 0
    with pytest.raises(SystemExit, match="declares no groups"):
        cli.main(["--keys", f"{d}/plain/keys.yaml", "--config", f"{d}/plain/consensus.yaml",
                  "request", "--no-batch", "--group", "1", "op"])


def test_run_groups_and_a_grouped_request_on_a_cpu_engine(tmp_path):
    """``testnet --groups 2 --macs`` (HMAC USIGs), three ``peer run
    --groups 2 --device cpu`` processes over TCP (every MAC and UI one
    lane of the plain K6), one ``request --group 1`` and one routed by
    key, both on a CPU engine; at SIGTERM every replica prints the same
    ledgers line (each group's length and state digest) and an engine
    report on the CPU."""
    from minbft_tpu_torch.groups import group_for_key
    from minbft_tpu_torch.utils.netports import free_base_port, wait_ports

    d = str(tmp_path)
    base = free_base_port(3)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for var in [v for v in env if v.startswith("PEER_")]:
        env.pop(var)
    peer = [sys.executable, "-m", "minbft_tpu_torch.sample.peer"]
    assert subprocess.run(peer + ["testnet", "-n", "3", "-d", d, "--usig", "HMAC_SHA256",
                                  "--macs", "--base-port", str(base)], env=env,
                          capture_output=True, timeout=120).returncode == 0
    common = ["--config", f"{d}/consensus.yaml", "--transport", "tcp", "--auth", "mac"]
    procs, logs = [], []
    try:
        for i in range(3):
            logs.append(open(f"{d}/r{i}.log", "wb"))
            procs.append(subprocess.Popen(
                peer + ["--keys", f"{d}/keys.replica{i}.yaml", *common, "run", str(i),
                        "--groups", "2", "--device", "cpu", "--batch", "8"],
                env=env, stdout=subprocess.DEVNULL, stderr=logs[i]))
        assert wait_ports([base + i for i in range(3)], timeout=120)
        client = peer + ["--keys", f"{d}/keys.yaml", *common]
        # the config declares no groups: the replicas' --groups 2 does, and
        # the client's environment says so (CONSENSUS_GROUPS)
        genv = dict(env, CONSENSUS_GROUPS="2")
        for argv in (["--group", "1", "pinned-op"], ["routed-op"]):
            res = subprocess.run(client + ["request", "--device", "cpu", "--timeout", "120",
                                           *argv], env=genv, capture_output=True, text=True,
                                 timeout=240)
            assert res.returncode == 0 and len(res.stdout.strip()) == 64, res.stderr[-2000:]
        time.sleep(1.0)
        for p in procs:
            p.terminate()
        assert [p.wait(timeout=60) for p in procs] == [0, 0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for fh in logs:
            fh.close()
    want = [0, 0]
    want[1] += 1
    want[group_for_key(b"routed-op", 2)] += 1
    lines = []
    for i in range(3):
        with open(f"{d}/r{i}.log") as fh:
            text = fh.read()
        assert "2 groups" in text
        assert " ERROR " not in text, text[-2000:]
        lines.append(next(json.loads(ln.split(" ledgers ", 1)[1]) for ln in text.splitlines()
                          if ln.startswith(f"replica {i} ledgers ")))
        eng = next(json.loads(ln.split(" engine ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith(f"replica {i} engine "))
        assert eng["device"] == "cpu" and eng["verify"]["hmac_sha256"]["items"] > 0
    assert [g["length"] for g in lines[0]] == want
    assert lines[1] == lines[0] and lines[2] == lines[0]


def test_load_on_a_cpu_engine_exits_0_with_the_census_of_the_seed():
    from minbft_tpu.loadgen import LoadSpec as RefLoadSpec
    from minbft_tpu.loadgen import replay_census as ref_replay

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "minbft_tpu_torch.sample.peer", "load", "--device", "cpu",
         "--rate", "30", "--duration", "1", "--clients", "20", "--groups",
         "2", "--seed", "0x10ad", "--expect-goodput", "1"],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert rep["census_ok"] and rep["goodput_ok"] and rep["timeouts"] == 0
    assert rep["census"] == ref_replay(RefLoadSpec(seed=0x10AD, rate=30.0, duration_s=1.0,
                                                   n_clients=20, n_groups=2))
    assert rep["engine"]["device"] == "cpu"
    assert rep["engine"]["verify"]["hmac_sha256"]["items"] > 0
    assert "engine cpu" in res.stderr


def test_chaos_selftest_prints_the_reference_census_line():
    """``selftest --chaos-seed 7`` (in-process, host crypto) commits its
    workload through the seeded lossy network with the invariants green,
    and prints the reference's lines for the same seed: the replay line,
    the census line (its form) and the verdict."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("MINBFT_CHAOS_SEED", None)
    out = {}
    for pkg, dev in (("minbft_tpu_torch", ["--no-batch"]), ("minbft_tpu", [])):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.sample.peer", "selftest",
                              "--chaos-seed", "7", *dev], env=env, capture_output=True,
                             text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-2000:]
        out[pkg] = [ln for ln in res.stderr.splitlines() if ln.startswith("chaos ")]
    port, ref = out["minbft_tpu_torch"], out["minbft_tpu"]
    assert len(port) == len(ref) == 3
    assert port[0] == ref[0] == (
        "chaos selftest: profile=lossy seed=0x7 (replay: MINBFT_CHAOS_SEED=0x7)")
    # The census line: the same form; its counts follow the frames the
    # run's timing coalesced, so they may differ between two runs.
    census = re.compile(r"chaos census: \{('[a-z_]+': \d+(, )?)*\} \(\d+ frames\)$")
    assert census.match(port[1]) and census.match(ref[1]), (port[1], ref[1])
    assert port[2] == ref[2] == (
        "chaos selftest ok: 6 requests committed on all 4 replicas under seed "
        "0x7, invariants green")


def test_run_metrics_port_under_chaos_scraped_by_peer_metrics_top_and_slo(tmp_path):
    """Three ``peer run --no-batch --metrics-port 0`` processes over TCP,
    each with ``MINBFT_CHAOS_SEED`` and ``MINBFT_CHAOS_PLAN=lossy``: a
    request commits; ``peer metrics`` (every target, merged), ``peer top
    --once`` and ``peer slo --json`` read the live endpoints; each
    replica's scraped fault census equals the reference's
    ``FaultNet.replay_counts`` of the seed over the scraped frame
    counts; SIGTERM stops each replica with exit code 0."""
    from minbft_tpu_torch.testing.recovery_soak import _census_from_scrape, _metrics_port
    from minbft_tpu.testing import FaultNet as RefFaultNet
    from minbft_tpu.testing import plan_from_spec as ref_plan
    from minbft_tpu_torch.obs.prom import parse_exposition, scrape
    from minbft_tpu_torch.utils.netports import free_base_port, wait_ports

    d = str(tmp_path)
    base = free_base_port(3)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for var in [v for v in env if v.startswith("PEER_")]:
        env.pop(var)
    chaos_env = dict(env, MINBFT_CHAOS_SEED="0x5eed", MINBFT_CHAOS_PLAN="lossy")
    peer = [sys.executable, "-m", "minbft_tpu_torch.sample.peer"]
    assert subprocess.run(peer + ["testnet", "-n", "3", "-d", d, "--usig", "SOFT_ECDSA",
                                  "--base-port", str(base)], env=env,
                          capture_output=True, timeout=120).returncode == 0
    common = ["--config", f"{d}/consensus.yaml", "--transport", "tcp"]
    procs, logs = [], []
    try:
        for i in range(3):
            logs.append(open(f"{d}/r{i}.log", "wb"))
            procs.append(subprocess.Popen(
                peer + ["--keys", f"{d}/keys.replica{i}.yaml", *common, "run", str(i),
                        "--no-batch", "--metrics-port", "0"],
                env=chaos_env, stdout=subprocess.DEVNULL, stderr=logs[i]))
        assert wait_ports([base + i for i in range(3)], timeout=60)
        addrs = [f"127.0.0.1:{_metrics_port(f'{d}/r{i}.log', 0, 60)}" for i in range(3)]
        client = peer + ["--keys", f"{d}/keys.yaml", *common]
        res = subprocess.run(client + ["request", "--no-batch", "--timeout", "60",
                                       "metrics-op"], env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0 and len(res.stdout.strip()) == 64, res.stderr
        # every replica executed: f + 1 replies precede the last one
        for addr in addrs:
            for _ in range(300):
                fams = parse_exposition(scrape(addr))
                if fams.get("minbft_requests_executed_total"):
                    break
                time.sleep(0.1)
        res = subprocess.run(peer + ["metrics", *addrs], env=env, capture_output=True,
                             text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        merged = parse_exposition(res.stdout.split("merged cluster aggregate", 1)[1]
                                  .split("\n", 1)[1])
        assert merged["minbft_requests_executed_total"]["samples"][()] == 3
        assert res.stdout.count("# ==== target ") == 3
        res = subprocess.run(peer + ["top", "--once", *addrs], env=env,
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        rows = res.stdout.splitlines()
        assert rows[0].startswith("TARGET") and sum(a in r for a in addrs for r in rows) >= 3
        res = subprocess.run(peer + ["slo", "--json", *addrs], env=env,
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        assert [t["addr"] for t in json.loads(res.stdout)["targets"]] == addrs
        plan = ref_plan("lossy")
        for i, addr in enumerate(addrs):
            census = _census_from_scrape(parse_exposition(scrape(addr)))
            want = RefFaultNet(seed=0x5EED, default_plan=plan).replay_counts(
                census["frames"], plan=plan)
            assert census["seeded"] == want and sum(census["frames"].values()) > 0
            with open(f"{d}/r{i}.log") as fh:
                assert f"replica {i} chaos: seed=0x5eed plan=lossy" in fh.read()
        for p in procs:
            p.terminate()
        assert [p.wait(timeout=60) for p in procs] == [0, 0, 0]
        with pytest.raises(OSError):
            scrape(addrs[0], timeout=2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for fh in logs:
            fh.close()


# A fixed exposition of two replicas: protocol counters, health, engine
# queues, the window gauges `top --once` reads, build info, SLO families.
_EXPO = {
    "0": """# TYPE minbft_build_info gauge
minbft_build_info{backend="cpu",git_rev="abc1234",pid="11",replica="0",run_id="11-5"} 1
# TYPE minbft_requests_executed_total counter
minbft_requests_executed_total{replica="0"} 120
# TYPE minbft_view_changes_completed_total counter
minbft_view_changes_completed_total{replica="0"} 2
# TYPE minbft_health_view gauge
minbft_health_view{replica="0"} 2
# TYPE minbft_health_commit_stall gauge
minbft_health_commit_stall{replica="0"} 0
# TYPE minbft_uptime_seconds gauge
minbft_uptime_seconds{replica="0"} 60.0
# TYPE minbft_verify_queue_items_total counter
minbft_verify_queue_items_total{queue="ecdsa_p256",replica="0"} 400
# TYPE minbft_verify_queue_batches_total counter
minbft_verify_queue_batches_total{queue="ecdsa_p256",replica="0"} 25
# TYPE minbft_verify_queue_device_seconds_total counter
minbft_verify_queue_device_seconds_total{queue="ecdsa_p256",replica="0"} 1.5
# TYPE minbft_verify_queue_depth gauge
minbft_verify_queue_depth{queue="ecdsa_p256",replica="0"} 3
# TYPE minbft_verify_queue_depth_peak gauge
minbft_verify_queue_depth_peak{queue="ecdsa_p256",replica="0"} 17
# TYPE minbft_sign_queue_depth gauge
minbft_sign_queue_depth{queue="ecdsa_p256",replica="0"} 1
# TYPE minbft_window_committed gauge
minbft_window_committed{replica="0"} 2.5
# TYPE minbft_window_loop_lag_p50_ms gauge
minbft_window_loop_lag_p50_ms{replica="0"} 0.75
# TYPE minbft_slo_good_total counter
minbft_slo_good_total{replica="0"} 110
# TYPE minbft_slo_breached_total counter
minbft_slo_breached_total{replica="0"} 10
# TYPE minbft_slo_target_ms gauge
minbft_slo_target_ms{replica="0"} 250.0
# TYPE minbft_slo_objective gauge
minbft_slo_objective{replica="0"} 0.99
# TYPE minbft_slo_budget_remaining gauge
minbft_slo_budget_remaining{replica="0"} 0.25
# TYPE minbft_slo_burn_threshold gauge
minbft_slo_burn_threshold{replica="0"} 6.0
# TYPE minbft_slo_burn_rate gauge
minbft_slo_burn_rate{replica="0",window="fast"} 8.0
minbft_slo_burn_rate{replica="0",window="slow"} 1.5
# TYPE minbft_slo_breach_dumps_total counter
minbft_slo_breach_dumps_total{replica="0"} 2
""",
    "1": """# TYPE minbft_requests_executed_total counter
minbft_requests_executed_total{replica="1"} 118
# TYPE minbft_health_view gauge
minbft_health_view{replica="1"} 2
# TYPE minbft_health_commit_stall gauge
minbft_health_commit_stall{replica="1"} 1
# TYPE minbft_uptime_seconds gauge
minbft_uptime_seconds{replica="1"} 59.0
# TYPE minbft_recovery_phase gauge
minbft_recovery_phase{replica="1"} 2
""",
}


@contextlib.contextmanager
def _fixed_servers():
    from minbft_tpu_torch.obs.prom import MetricsServer

    servers = [MetricsServer(lambda t=t: t, host="127.0.0.1", port=0)
               for t in _EXPO.values()]
    try:
        yield [f"127.0.0.1:{s.start()}" for s in servers]
    finally:
        for s in servers:
            s.stop()


def _console(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("flags", [[], ["--stall-flag"]], ids=["plain", "stall-flag"])
def test_top_once_on_a_fixed_exposition_matches_the_reference(flags):
    with _fixed_servers() as addrs:
        port_rc, port_out = _console(cli, ["top", "--once", *flags, *addrs])
        ref_rc, ref_out = _console(ref_cli, ["top", "--once", *flags, *addrs])
        # and the frame function itself, on the same parsed states
        states = {a: cli._scrape_top_state(a, 5.0) for a in addrs}
        ref_states = {a: ref_cli._scrape_top_state(a, 5.0) for a in addrs}
    assert (port_rc, port_out) == (ref_rc, ref_out)
    assert port_rc == (3 if flags else 0)
    assert "STALL" in port_out and "BREACH" in port_out and "vc=2" in port_out
    for st in list(states.values()) + list(ref_states.values()):
        st["mono"] = 0.0
    assert states == ref_states
    assert cli._top_frame(states, {"127.0.0.1:9": "down"}, {}) == \
        ref_cli._top_frame(ref_states, {"127.0.0.1:9": "down"}, {})


@pytest.mark.parametrize("fmt", [["--json"], []], ids=["json", "table"])
def test_slo_on_a_fixed_exposition_matches_the_reference(fmt):
    with _fixed_servers() as addrs:
        port_rc, port_out = _console(cli, ["slo", *fmt, "--breach-flag", *addrs])
        ref_rc, ref_out = _console(ref_cli, ["slo", *fmt, "--breach-flag", *addrs])
    assert (port_rc, port_out) == (ref_rc, ref_out) and port_rc == 3
    if fmt:
        rep = json.loads(port_out)
        g = rep["targets"][0]["groups"]["-"]
        assert g["breach"] and g["good_fraction"] == round(110 / 120, 4)
        assert rep["targets"][1]["groups"] == {}


def test_peer_run_refuses_corrupted_store(tmp_path, capsys):
    """A replica over a corrupted committed store exits 4 with a clear
    message, never serving and never starting fresh."""
    from minbft_tpu_torch.recovery import store_path
    from minbft_tpu_torch.utils.netports import free_base_port

    d = str(tmp_path)
    assert cli.main(["testnet", "-n", "3", "-d", d, "--usig", "SOFT_ECDSA",
                     "--base-port", str(free_base_port(3))]) == 0
    state_dir = os.path.join(d, "state")
    os.makedirs(state_dir)
    with open(store_path(state_dir, 0), "wb") as fh:
        fh.write(b"this is not a valid durable store file" * 4)
    rc = cli.main(["--keys", f"{d}/keys.yaml", "--config", f"{d}/consensus.yaml",
                   "run", "0", "--no-batch", "--state-dir", state_dir])
    err = capsys.readouterr().err
    assert rc == 4 and "corrupt" in err and "state-dir" in err
