"""The port's ``peer`` CLI (``minbft_tpu_torch.sample.peer``): the shared
subcommands parse to the reference's namespace, the ``PEER_*`` and
``peer.yaml`` layering, the scaffold and the selftest, the device rule
(no CUDA and neither ``--device cpu`` nor ``--no-batch``: exit non-zero)
and the options whose modules are not ported yet (exit non-zero, naming
the ROADMAP item)."""

import os
import subprocess
import sys

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
    ["testnet", "-n", "7", "-f", "3", "--clients", "20", "--base-port", "4000",
     "--host", "10.0.0.1", "-d", "net", "--usig", "NATIVE_ECDSA", "--macs"],
]
PORT_ONLY = {"device", "no_batch"}


@pytest.fixture(autouse=True)
def _no_peer_env(monkeypatch):
    for var in list(os.environ):
        if var.startswith("PEER_") or var == "MINBFT_CHAOS_SEED":
            monkeypatch.delenv(var)


@pytest.mark.parametrize("argv", SHARED_ARGV, ids=lambda a: a[a.index(next(
    x for x in a if x in ("run", "request", "bench", "selftest", "testnet")))])
def test_shared_subcommands_parse_to_the_reference_namespace(argv):
    port = vars(cli.build_parser().parse_args(argv))
    ref = vars(ref_cli.build_parser().parse_args(argv))
    extra = set(port) - set(ref)
    assert extra <= PORT_ONLY
    assert {k: v for k, v in port.items() if k not in extra} == ref
    if port["command"] in ("run", "request", "bench"):
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
    assert cli.main(["selftest"]) == 0


@pytest.fixture
def testnet(tmp_path):
    d = str(tmp_path)
    assert cli.main(["testnet", "-n", "3", "-d", d, "--usig", "SOFT_ECDSA"]) == 0
    return ["--keys", f"{d}/keys.yaml", "--config", f"{d}/consensus.yaml"]


@pytest.mark.parametrize("sub", [["run", "0"], ["request", "op"], ["bench"]],
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
    (["run", "0", "--no-batch", "--metrics-port", "0"], "item 5"),
    (["run", "0", "--no-batch", "--groups", "2"], "item 6"),
    (["run", "0", "--no-batch", "--chips", "0"], "item 7"),
    (["run", "0", "--no-batch"], "item 5"),  # with MINBFT_CHAOS_SEED
])
def test_unported_run_options_exit(argv, item, testnet, monkeypatch):
    if "--metrics-port" not in argv and "--groups" not in argv and "--chips" not in argv:
        monkeypatch.setenv("MINBFT_CHAOS_SEED", "0x1")
    with pytest.raises(SystemExit) as e:
        cli.main(testnet + argv)
    assert "not supported by the port yet" in str(e.value.code)
    assert item in str(e.value.code)


@pytest.mark.parametrize("argv", [
    ["selftest", "--chaos-seed", "7"],
    ["selftest", "--chaos-profile", "lossy"],
    ["testnet", "-n", "3", "--groups", "2"],
], ids=["chaos-seed", "chaos-profile", "testnet-groups"])
def test_unported_selftest_and_testnet_options_exit(argv, tmp_path):
    if argv[0] == "testnet":
        argv = argv + ["-d", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "not supported by the port yet" in str(e.value.code)


@pytest.mark.parametrize("sub", ["metrics", "top", "slo", "load"])
def test_subcommands_of_unported_modules_are_not_parsed(sub, capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args([sub, "127.0.0.1:1"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


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
