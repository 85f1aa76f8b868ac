"""peer — run a replica or submit requests from the command line.

Port of :mod:`minbft_tpu.sample.peer.cli` (reference sample/peer):
``peer run <id>`` loads the keystore + consensus config, assembles the
stack (authenticator, ledger, TCP or gRPC connector), and serves
(run.go:91-159); ``peer request <args…>`` is the client-side equivalent,
reading operations from argv or stdin (request.go:87-134); flags layer
over ``PEER_*`` environment variables (root.go:73-82) and a per-node
``peer.yaml``.

    # shared flags (--keys/--config/--auth/--transport) go BEFORE the
    # subcommand; per-subcommand flags (--listen/--batch/--device) after:
    python -m minbft_tpu_torch.sample.peer testnet -n 4 -d net/ --usig NATIVE_ECDSA
    python -m minbft_tpu_torch.sample.peer --keys net/keys.yaml \\
        --config net/consensus.yaml --transport tcp run 0
    python -m minbft_tpu_torch.sample.peer ... request "op"
    python -m minbft_tpu_torch.sample.peer ... bench --clients 20 --depth 24
    python -m minbft_tpu_torch.sample.peer selftest   # in-process n=4 smoke test

Device rule (``run``, ``request`` and ``bench``): each process owns one
:class:`~minbft_tpu_torch.parallel.BatchVerifier` on ``--device``
(default ``cuda:0``), which checks every signature, MAC and USIG
certificate on the card (K2, K6) and makes the process's own
REQUEST/REPLY signatures (K3).  ``--device cpu`` runs the kernels' plain
PyTorch versions; ``--no-batch`` asks for the reference's serial host
crypto.  Without CUDA, and with neither of those flags, the process exits
non-zero: nothing falls back to the host on its own.  The reference's CLI
clients sign and verify on the host; the port's use the engine.

Options whose modules are not ported yet exit non-zero naming the
ROADMAP.md item that will lift them: ``run --metrics-port`` (item 5,
``obs/prom.py``), ``--groups`` above 1 and ``--chips`` other than 1
(items 6 and 7), ``MINBFT_CHAOS_SEED`` and ``selftest --chaos-*`` (item 5,
``testing/``).  The subcommands ``metrics``, ``top``, ``slo`` and ``load``
come with those modules.

``MINBFT_TRACE_DUMP=base`` turns the flight recorder on: at shutdown a
replica writes its stage dump, its telemetry ring and
``{base}.engine{id}.json`` — the engine's queue histograms, per-queue
items, batches and dispatch timeouts, its device and the kernel launch
counts of the process.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys

from ..envflags import env_default


def _env(name: str, fallback, choices=None):
    return env_default("PEER", name, fallback, choices)


# Per-node options file (reference sample/peer/peer.yaml layered by viper
# under flags/env, root.go:54-82).  Same precedence here:
# flags > PEER_* env vars > options file > built-in defaults.
_PEER_OPTION_SCHEMA = {
    None: {"keys", "config", "log_level", "log_file", "auth", "transport"},
    "run": {"listen", "batch", "metrics_interval", "metrics_port",
            "metrics_host", "groups", "chips", "state_dir", "device"},
    "request": {"client_id", "timeout", "group", "device"},
}


class NotPortedError(SystemExit):
    """An option whose module is not ported yet (exits non-zero)."""

    def __init__(self, what: str, item: str):
        super().__init__(
            f"peer: {what} is not supported by the port yet "
            f"(ROADMAP.md queue 1 item {item})"
        )


def load_peer_options(path: str, explicit: bool) -> dict:
    """Load and validate a per-node ``peer.yaml``.  A missing DEFAULT path
    is fine (no file, no layering); a missing explicitly-requested one is
    an error.  Unknown keys fail loudly — a typo silently reverting an
    option to its default is how misconfigured replicas limp into
    clusters."""
    if not os.path.exists(path):
        if explicit:
            raise SystemExit(f"peer: options file {path!r} not found")
        return {}
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    if not isinstance(data, dict):
        raise SystemExit(f"peer: options file {path!r} must be a mapping")

    def check_scalar(name: str, v) -> None:
        # str() would happily stringify a YAML list/mapping into a bogus
        # "path" — reject non-scalars here, where the message can say so.
        if isinstance(v, (dict, list)):
            raise SystemExit(
                f"peer: option {name} in {path!r} must be a scalar, "
                f"got {type(v).__name__}"
            )

    for opt, val in data.items():
        if opt in _PEER_OPTION_SCHEMA[None]:
            check_scalar(opt, val)
            continue
        sub = _PEER_OPTION_SCHEMA.get(opt)
        if sub is None:
            raise SystemExit(f"peer: unknown option {opt!r} in {path!r}")
        if not isinstance(val, dict):
            raise SystemExit(
                f"peer: section {opt!r} in {path!r} must be a mapping"
            )
        for sub_opt, v in val.items():
            if sub_opt not in sub:
                raise SystemExit(
                    f"peer: unknown option {opt}.{sub_opt!r} in {path!r}"
                )
            check_scalar(f"{opt}.{sub_opt}", v)
    return data


def peek_options_path(argv=None):
    """Resolve the options-file path BEFORE full parsing (its values feed
    the parser's defaults): --options flag > PEER_OPTIONS env > peer.yaml."""
    argv = list(sys.argv[1:] if argv is None else argv)
    path = os.environ.get("PEER_OPTIONS", "peer.yaml")
    explicit = "PEER_OPTIONS" in os.environ
    for i, a in enumerate(argv):
        if a == "--options" and i + 1 < len(argv):
            path, explicit = argv[i + 1], True
        elif a.startswith("--options="):
            path, explicit = a.split("=", 1)[1], True
    return path, explicit


def build_parser(options: dict | None = None) -> argparse.ArgumentParser:
    options = options or {}

    def _opt(name: str, fallback, section=None, choices=None):
        src = options.get(section) if section else options
        v = (src or {}).get(name, fallback)
        if v is not fallback and v is not None:
            try:
                v = type(fallback)(v)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"peer: invalid options-file value {name}={v!r} "
                    f"(expected {type(fallback).__name__})"
                )
            if choices is not None and v not in choices:
                raise SystemExit(
                    f"peer: invalid options-file value {name}={v!r} "
                    f"(choose from {', '.join(map(str, choices))})"
                )
        elif v is None:
            v = fallback
        return _env(name, v, choices)

    def engine_args(sp, section=None) -> None:
        # The port's device rule (module docstring): the engine's device,
        # or --no-batch for the reference's serial host crypto.
        sp.add_argument(
            "--device",
            default=_opt("device", "cuda:0", section=section),
            help="the engine's device: cuda:N (default cuda:0) or cpu (the "
            "kernels' plain PyTorch versions); without CUDA the process "
            "exits unless --device cpu or --no-batch is given",
        )
        sp.add_argument(
            "--no-batch",
            action="store_true",
            help="no engine: serial host crypto, as the reference's "
            "--no-batch",
        )

    p = argparse.ArgumentParser(prog="peer", description="minbft-tpu peer (PyTorch port)")
    p.add_argument(
        "--options",
        default=peek_options_path()[0],
        help="per-node options file layered under env vars and flags "
        "(default: peer.yaml if present)",
    )
    p.add_argument(
        "--keys", default=_opt("keys", "keys.yaml"), help="keystore path"
    )
    p.add_argument(
        "--config",
        default=_opt("config", "consensus.yaml"),
        help="consensus config path",
    )
    _levels = ("debug", "info", "warning", "error")
    p.add_argument(
        "--log-level",
        default=_opt("log_level", "info", choices=_levels),
        choices=_levels,
    )
    p.add_argument("--log-file", default=_opt("log_file", "") or None)
    _auths = ("signatures", "mac")
    p.add_argument(
        "--auth",
        choices=_auths,
        default=_opt("auth", "signatures", choices=_auths),
        help="message authentication: public-key signatures (default) or "
        "pairwise MACs (keys.yaml needs a macs section: keytool --macs)",
    )
    _transports = ("grpc", "tcp")
    p.add_argument(
        "--transport",
        choices=_transports,
        default=_opt("transport", "grpc", choices=_transports),
        help="wire transport: gRPC bidi streams (default) or the native "
        "length-prefixed TCP framing (lower per-frame cost; same "
        "authenticated protocol above it)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="run a replica")
    r.add_argument("id", type=int, help="replica id")
    r.add_argument(
        "--listen",
        default=_opt("listen", "", section="run"),
        help="listen address (default: this id's addr from the config)",
    )
    r.add_argument(
        "--batch",
        type=int,
        default=_opt("batch", 512, section="run"),
        help="max verification batch per kernel launch (the engine's one "
        "bucket)",
    )
    engine_args(r, section="run")
    r.add_argument(
        "--metrics-interval",
        type=float,
        default=_opt("metrics_interval", 0.0, section="run"),
        help="log the protocol counters every N seconds (0 = off)",
    )
    r.add_argument(
        "--metrics-port",
        type=int,
        default=_opt("metrics_port", -1, section="run"),
        help="Prometheus endpoint: not ported yet (obs/prom.py); any "
        "value but the default -1 exits",
    )
    r.add_argument(
        "--metrics-host",
        default=_opt("metrics_host", "127.0.0.1", section="run"),
        help="bind address for --metrics-port",
    )
    r.add_argument(
        "--groups",
        type=int,
        default=_opt("groups", 0, section="run"),
        help="consensus groups per replica process: 0 (default) = the "
        "config's protocol.groups, which must be 1 here; more than one "
        "group is not ported yet (groups/) and exits",
    )
    r.add_argument(
        "--chips",
        type=int,
        default=_opt("chips", 1, section="run"),
        help="home chips of the multi-device engine pool: only 1 (the "
        "default, the one engine) is ported; any other value exits",
    )
    r.add_argument(
        "--peer-idle-timeout",
        type=float,
        default=_opt("peer_idle_timeout", 0.0, section="run"),
        help="TCP transport only: tear down a peer stream that delivers "
        "no frame for N seconds (a half-open link), so the redial loop "
        "can recover it; 0 = off (default)",
    )
    r.add_argument(
        "--state-dir",
        default=_opt("state_dir", "", section="run"),
        help="durable crash-recovery store directory (recovery/): every "
        "stable checkpoint is persisted atomically and reloaded at "
        "startup.  MINBFT_STATE_DIR is the env equivalent; empty "
        "(default) = no durability.  A corrupted committed store file is "
        "FATAL at startup (exit code 4).",
    )

    q = sub.add_parser("request", help="submit request(s) as a client")
    q.add_argument("ops", nargs="*", help="operations (default: stdin lines)")
    q.add_argument(
        "--client-id", type=int, default=_opt("client_id", 0, section="request")
    )
    q.add_argument(
        "--timeout", type=float, default=_opt("timeout", 30.0, section="request")
    )
    q.add_argument(
        "--group",
        type=int,
        default=_opt("group", -1, section="request"),
        help="pin requests to this consensus group (multi-group clusters "
        "are not ported yet; -1 = route by key, 0 = the ungrouped cluster)",
    )
    q.add_argument(
        "--read-only",
        action="store_true",
        help="read from committed state: fast path on all-n agreement, "
        "ordered-read fallback otherwise (mutates nothing either way)",
    )
    q.add_argument(
        "--no-read-fallback",
        action="store_true",
        help="with --read-only: fail instead of falling back to an "
        "ordered read when the all-n fast quorum cannot form",
    )
    engine_args(q, section="request")

    b = sub.add_parser(
        "bench",
        help="drive pipelined no-op requests from many clients and print "
        "one JSON line of throughput/latency stats (the multi-process "
        "bench's client process)",
    )
    b.add_argument("--clients", type=int, default=16, help="clients in this process")
    b.add_argument("--client-base", type=int, default=0, help="first client id")
    b.add_argument("--requests", type=int, default=1000, help="total across clients")
    b.add_argument("--depth", type=int, default=8, help="pipelined requests per client")
    b.add_argument("--timeout", type=float, default=240.0, help="per-request deadline")
    b.add_argument(
        "--read-only",
        action="store_true",
        help="drive read-only fast reads instead of ordered writes "
        "(one seed write, then reads — measures the no-consensus path)",
    )
    b.add_argument(
        "--tag", default="", help="payload tag (keeps concurrent procs' ops distinct)"
    )
    engine_args(b)

    st = sub.add_parser("selftest", help="in-process n=4 cluster smoke test")
    st.add_argument(
        "--chaos-seed",
        type=lambda s: int(s, 0),
        default=None,
        metavar="SEED",
        help="fault-injection network: not ported yet (testing/); exits",
    )
    st.add_argument(
        "--chaos-profile",
        choices=("lossy", "flaky", "slow"),
        default=None,
        help="fault plan: not ported yet (testing/); exits",
    )

    t = sub.add_parser(
        "testnet", help="scaffold keys.yaml + consensus.yaml for a local cluster"
    )
    t.add_argument("-n", "--replicas", type=int, default=3)
    t.add_argument("-f", "--faults", type=int, default=None, help="default (n-1)//2")
    t.add_argument("--clients", type=int, default=1)
    t.add_argument("--base-port", type=int, default=42600)
    t.add_argument("--host", default="127.0.0.1")
    t.add_argument("-d", "--dir", default=".", help="output directory")
    t.add_argument(
        "--usig",
        choices=("auto", "NATIVE_ECDSA", "SOFT_ECDSA", "HMAC_SHA256"),
        default="auto",
    )
    t.add_argument(
        "--macs", action="store_true",
        default=bool(_env("macs", 0)),
        help="include pairwise-MAC material (enables run/request --auth mac)",
    )
    t.add_argument(
        "--groups", type=int, default=1,
        help="consensus groups declared in consensus.yaml: only 1 is "
        "ported (groups/); more exits",
    )
    return p


def _log_opts(args):
    from ...core.options import with_log_file, with_log_level

    opts = [with_log_level(getattr(logging, args.log_level.upper()))]
    if args.log_file:
        opts.append(with_log_file(args.log_file))
    return opts


def _make_engine(args, max_batch: int, buckets=None):
    """The process's engine under the device rule (module docstring):
    None with ``--no-batch``; otherwise a BatchVerifier on ``--device``.
    CUDA asked for and absent exits non-zero."""
    if args.no_batch:
        return None
    import torch

    from ...parallel import BatchVerifier

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"peer: --device {args.device} but torch.cuda.is_available() is "
            "False: pass --device cpu for the kernels' plain versions or "
            "--no-batch for serial host crypto"
        )
    # On the CPU the sign queue runs the plain k*G too, so --device cpu
    # is the kernels' plain versions end to end.
    return BatchVerifier(
        max_batch=max_batch,
        buckets=buckets,
        device=device,
        sign_on_device=True if device.type == "cpu" else None,
    )


def engine_report(engine) -> dict:
    """What an engine did: its device, per queue the items, batches and
    dispatch timeouts (and host-signed items), the process's kernel
    launch counts (every engine of the process shares them), whether the
    process initialised CUDA (so holds a context on the card) and, on the
    card, the MiB its PyTorch allocator holds there (the CUDA context's
    own memory is not in it)."""
    import torch

    from ...ops import ed25519, hmac_sha256, p256

    wrappers = {
        "K2": p256.ecdsa_verify_kernel_packed,
        "K3": p256.ecdsa_kg_kernel,
        "K6": hmac_sha256.hmac_verify_kernel_packed,
        "K7": ed25519.ed25519_verify_kernel_packed,
        "K8": ed25519.ed25519_rb_kernel,
    }
    reserved = (torch.cuda.memory_reserved(engine.device) / 2**20
                if engine.device.type == "cuda" else 0.0)
    return {
        "device": str(engine.device),
        "cuda_context": torch.cuda.is_initialized(),
        "cuda_reserved_mib": reserved,
        "launches": {kid: w.launches for kid, w in wrappers.items()},
        "verify": {
            name: {"items": st.items, "batches": st.batches,
                   "dispatch_timeouts": st.dispatch_timeouts}
            for name, st in engine.stats.items()
        },
        "sign": {
            name: {"items": st.items, "batches": st.batches,
                   "dispatch_timeouts": st.dispatch_timeouts,
                   "host_fallback_items": st.host_fallback_items}
            for name, st in engine.sign_stats.items()
        },
    }


def _refuse_unported_run_options(args, cfg) -> None:
    """Exit on an option whose module is not ported."""
    if args.metrics_port >= 0:
        raise NotPortedError("--metrics-port (obs/prom.py)", "5")
    if os.environ.get("MINBFT_CHAOS_SEED"):
        raise NotPortedError("MINBFT_CHAOS_SEED (testing/faultnet.py)", "5")
    n_groups = args.groups if args.groups > 0 else getattr(cfg, "groups", 1)
    if n_groups > 1:
        raise NotPortedError(f"{n_groups} consensus groups (groups/)", "6")
    if args.chips != 1:
        raise NotPortedError(f"--chips {args.chips} (parallel/pool.py)", "7")


async def _run_replica(args) -> int:
    from ...core import new_replica
    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            TcpReplicaConnector as GrpcReplicaConnector,
        )
        from ...sample.conn.tcp import TcpReplicaServer as ReplicaServer
    else:
        from ...sample.conn.grpc import GrpcReplicaConnector, ReplicaServer
    from ...sample.requestconsumer import SimpleLedger

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    _refuse_unported_run_options(args, cfg)
    addrs = {p.id: p.addr for p in cfg.peers}
    if args.id not in addrs:
        raise SystemExit(f"peer: replica {args.id} not in {args.config} peers[]")

    # Eager tasks (3.12+): most protocol tasks complete without suspending
    # (memo hits, buffered sends) — running them synchronously at spawn
    # cuts event-loop scheduling overhead (same setting as the in-process
    # bench cluster).
    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)

    # One engine for this replica, one bucket (the reference's rule for
    # its device engine); the kernels build (or load from build/torch_ext/)
    # here, before the replica serves.
    engine = _make_engine(args, args.batch, buckets=(args.batch,))

    # One call = one authenticator instance = one fresh USIG epoch (the
    # keystore restores the sealed key per call).
    if args.auth == "mac":
        auth = store.mac_replica_authenticator(args.id, engine=engine)
    else:
        auth = store.replica_authenticator(args.id, engine=engine)

    if args.transport == "tcp":
        # Half-open peer detection (read-idle teardown) is a property of
        # the native framing only; gRPC manages its own channel health.
        conn = GrpcReplicaConnector(
            "peer", idle_timeout=args.peer_idle_timeout
        )
    else:
        conn = GrpcReplicaConnector("peer")
    for rid, addr in addrs.items():
        if rid != args.id:
            conn.connect_replica(rid, addr)

    # Durable crash-recovery store (recovery/): flag wins, then
    # MINBFT_STATE_DIR; empty = no durability.
    from ...recovery import CorruptStoreError, state_dir_from_env

    state_dir = getattr(args, "state_dir", "") or state_dir_from_env()

    ledger = SimpleLedger()
    replica = new_replica(
        args.id, cfg, auth, conn, ledger, opts=_log_opts(args),
        state_dir=state_dir or None,
    )
    server = ReplicaServer(replica)
    listen = args.listen or addrs[args.id]
    bound = await server.start(listen)
    print(
        f"replica {args.id} serving on {bound} "
        f"(engine: {engine.device if engine is not None else 'none, host crypto'})",
        file=sys.stderr,
    )
    try:
        await replica.start()
    except CorruptStoreError as e:
        # A committed store file that fails its own integrity or
        # certificate check is a hard startup refusal, not a warning.
        print(
            f"peer: FATAL: replica {args.id} durable state store is "
            f"corrupt — refusing to serve: {e}\n"
            f"peer: clear or restore the --state-dir contents to recover",
            file=sys.stderr,
        )
        await server.stop()
        await conn.close()
        return 4

    from ...obs import trace as obs_trace

    # Engine dispatcher spans are exported by the MINBFT_TRACE_DUMP
    # shutdown dump, so recording is gated on exactly that knob.
    dump_base = os.environ.get(obs_trace.TRACE_DUMP_ENV)
    if engine is not None and dump_base:
        engine.enable_obs_ring()

    # Latency-SLO ledger (obs/slo.py): the Handlers built their own
    # BudgetLedger when the policy is enabled (MINBFT_SLO_* env or the
    # config's protocol.slo block).
    from ...obs import slo as obs_slo

    slo_ledgers = [
        h.slo for h in [replica.handlers] if getattr(h, "slo", None) is not None
    ]
    slo_spool = obs_slo.BreachSpool.from_env() if slo_ledgers else None

    # Telemetry rings (obs/timeseries.py): sampled when the trace-dump
    # surface can read them ({base}.rN.ts.json); without it the sampler
    # stays off.
    tseries = sampler = None
    if dump_base:
        from ...obs import timeseries as obs_ts

        tseries = obs_ts.TimeSeries()
        sampler = obs_ts.CounterSampler(tseries)
        obs_ts.register_replica_series(sampler, replica.metrics)
        if engine is not None:
            obs_ts.register_engine_series(sampler, engine)
        for lg in slo_ledgers:
            obs_slo.register_slo_series(sampler, lg)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    # SIGINT and SIGTERM both route through the clean-stop path, so the
    # flight-recorder dump fires on ctrl-C exactly as on a managed stop.
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-Unix
            pass

    def dump_engine_obs() -> None:
        # Engine dispatcher spans + queue-wait histograms ride the
        # shutdown dump alongside the replica's stage dump; the port adds
        # the engine's report (device, per-queue counts, launches).
        if engine is None or not dump_base:
            return
        import json as _json

        from ...obs import critpath as obs_critpath

        doc = obs_critpath.engine_queue_doc(engine, ident=args.id)
        doc["engine"] = engine_report(engine)
        events = engine.drain_obs_events()
        if events:
            doc["events"] = [list(e) for e in events]
        # noqa: AH102 - one-shot crash/shutdown dump; forensics cannot rely on executors
        with open(f"{dump_base}.engine{args.id}.json", "w") as fh:
            _json.dump(doc, fh)

    def dump_ts() -> None:
        # The saturation timeline rides the same dump surface as the
        # trace files ({base}.r{id}.ts.json).
        if tseries is None or not dump_base:
            return
        from ...obs import timeseries as obs_ts

        obs_ts.dump_timeseries(
            tseries, f"{dump_base}.r{args.id}", extra={"id": args.id}
        )

    async def log_metrics() -> None:
        import json as _json

        while not stop.is_set():
            await asyncio.sleep(args.metrics_interval)
            snap = replica.metrics.snapshot()
            snap["executed_per_sec"] = round(
                replica.metrics.executed_per_sec(), 2
            )
            print(f"metrics: {_json.dumps(snap)}", file=sys.stderr)

    metrics_task = (
        loop.create_task(log_metrics()) if args.metrics_interval > 0 else None
    )
    sampler_task = (
        loop.create_task(sampler.run()) if sampler is not None else None
    )

    # Breach-forensics watch (obs/slo.py): needs the sampler — burn is a
    # ring reading, and without ticks the window is always empty.
    slo_watch_tasks = []
    if slo_spool is not None and sampler is not None:
        _slo_recorders = [replica.handlers.trace] if getattr(
            replica.handlers, "trace", None) is not None else []

        def _slo_bundle(burn: dict) -> dict:
            return obs_slo.build_bundle(
                slo_ledgers[0].policy,
                burn,
                slo_ledgers,
                recorders=_slo_recorders,
                timeseries=tseries,
            )

        for lg in slo_ledgers:
            slo_watch_tasks.append(loop.create_task(obs_slo.watch(
                tseries, lg.policy, slo_spool, _slo_bundle, group=lg.group
            )))

    async def stop_sampler() -> None:
        # Cancel-and-await: the sampler's CancelledError handler flushes
        # the final partial interval before the ring is dumped.
        for t in slo_watch_tasks:
            t.cancel()
        for t in slo_watch_tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        if sampler_task is not None:
            sampler_task.cancel()
            try:
                await sampler_task
            except asyncio.CancelledError:
                pass

    try:
        await stop.wait()
    except BaseException:
        # Fatal error (or a cancellation unwinding the process): the
        # trace must not die with it.  Best-effort stop (which dumps) and
        # engine dump, then let the error propagate.
        print(f"replica {args.id} crashing: dumping trace", file=sys.stderr)
        try:
            await stop_sampler()
            await replica.stop()
            dump_engine_obs()
            dump_ts()
        except Exception:  # noqa: BLE001 - forensics must not mask the
            pass  # original fatal error
        raise
    if metrics_task is not None:
        metrics_task.cancel()
        try:
            await metrics_task
        except asyncio.CancelledError:
            pass
    await stop_sampler()
    print(f"replica {args.id} shutting down", file=sys.stderr)
    await replica.stop()  # writes the replica's MINBFT_TRACE_DUMP file
    dump_engine_obs()
    dump_ts()
    await server.stop()
    await conn.close()
    if engine is not None:
        # One line a harness can read from the log (bench.py's mp runs).
        import json as _json

        print(f"replica {args.id} engine {_json.dumps(engine_report(engine))}",
              file=sys.stderr, flush=True)
    return 0


def _client_auth(args, store, client_id: int, engine):
    if args.auth == "mac":
        return store.mac_client_authenticator(client_id, engine=engine)
    return store.client_authenticator(client_id, engine=engine)


def _refuse_groups(cfg, pin: int) -> None:
    n_groups = getattr(cfg, "groups", 1)
    if n_groups > 1:
        raise NotPortedError(
            f"a config with {n_groups} consensus groups (groups/)", "6"
        )
    if pin > 0:
        # --group 0 against an ungrouped config stays accepted: group 0
        # IS the ungrouped wire format by definition (bare frames).
        raise SystemExit(
            f"peer: --group {pin} but the config declares no groups"
        )


async def _run_request(args) -> int:
    from ...client import new_client
    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            connect_many_replicas_tcp as connect_many_replicas,
        )
    else:
        from ...sample.conn.grpc import connect_many_replicas

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    addrs = {p.id: p.addr for p in cfg.peers}
    if len(addrs) < cfg.n:
        raise SystemExit("peer: config peers[] does not cover all replicas")
    _refuse_groups(cfg, getattr(args, "group", -1))
    # A client's batches are its own REQUEST signs and the f+1..n REPLYs
    # of each request: the engine's default ladder of buckets.
    engine = _make_engine(args, 512)

    ops = [op.encode() for op in args.ops]
    if not ops:
        ops = [line.rstrip("\n").encode() for line in sys.stdin if line.strip()]

    conn = connect_many_replicas(addrs, kind="client")
    client = new_client(
        args.client_id, cfg.n, cfg.f,
        _client_auth(args, store, args.client_id, engine), conn,
    )
    await client.start()
    rc = 0
    try:
        for op in ops:
            result = await asyncio.wait_for(
                client.request(
                    op,
                    read_only=getattr(args, "read_only", False),
                    read_fallback=not getattr(args, "no_read_fallback", False),
                    read_timeout=min(args.timeout, 30.0),
                ),
                args.timeout,
            )
            print(result.hex())
    except asyncio.TimeoutError:
        print("peer: request timed out", file=sys.stderr)
        rc = 1
    finally:
        await client.stop()
        await conn.close()
    return rc


async def _run_bench_clients(args) -> int:
    """Client process of the multi-process bench: ``--clients`` pipelined
    clients drive ``--requests`` no-ops and print ONE JSON line —
    committed count, wall seconds, every request's latency (ms) so the
    harness can aggregate exact percentiles across processes, and (with
    an engine) the engine's report: its device, queue counts and kernel
    launches."""
    import faulthandler
    import json as _json
    import time as _time

    from ...client import new_client
    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            connect_many_replicas_tcp as connect_many_replicas,
        )
    else:
        from ...sample.conn.grpc import connect_many_replicas

    # Wedge forensics: SIGUSR1 dumps every thread's stack to stderr.
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError):
        pass

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    addrs = {p.id: p.addr for p in cfg.peers}
    _refuse_groups(cfg, -1)
    # One engine for every client of this process: REQUEST signs (K3)
    # and REPLY verifies (K2) from all of them coalesce into its batches.
    engine = _make_engine(args, 512, buckets=(512,))

    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)

    conn = connect_many_replicas(addrs, kind="client")
    clients = []
    for k in range(args.clients):
        cid = args.client_base + k
        c = new_client(
            cid, cfg.n, cfg.f, _client_auth(args, store, cid, engine), conn,
            retransmit_interval=30.0,
        )
        await c.start()
        clients.append(c)

    per_client = max(args.requests // args.clients, 1)
    total = per_client * args.clients
    tag = (args.tag or "mp").encode()

    # settle the streams (and any cold server-side state) off the clock
    await asyncio.wait_for(clients[0].request(tag + b"-warmup"), args.timeout)

    latencies_ms: list = []

    read_only = getattr(args, "read_only", False)

    async def timed(client, k: int) -> None:
        t = _time.time()
        if read_only:
            # identical op bytes on purpose: reads have no dedup hazard,
            # and identical results are exactly what the all-n fast
            # quorum needs.  read_fallback=False: this mode MEASURES the
            # no-consensus path.
            await asyncio.wait_for(
                client.request(
                    b"head",
                    read_only=True,
                    read_timeout=min(args.timeout, 30.0),
                    read_fallback=False,
                ),
                args.timeout,
            )
        else:
            await asyncio.wait_for(
                client.request(tag + b"-%d-%d" % (client.client_id, k)),
                args.timeout,
            )
        latencies_ms.append(round((_time.time() - t) * 1e3, 2))

    async def drive(client) -> None:
        # Gather-windows, deliberately NOT a rolling semaphore window: the
        # window's burst of `depth` requests coalesces into few transport
        # frames and fills PREPARE batches.
        for k0 in range(0, per_client, args.depth):
            await asyncio.gather(
                *[
                    timed(client, k)
                    for k in range(k0, min(k0 + args.depth, per_client))
                ]
            )

    t0 = _time.time()
    cpu0 = _time.process_time()
    await asyncio.gather(*[drive(c) for c in clients])
    dt = _time.time() - t0
    cpu_s = _time.process_time() - cpu0

    async def teardown() -> None:
        for c in clients:
            await c.stop()
        await conn.close()

    # Best-effort teardown with a bound, then a HARD exit: grpc.aio's
    # channel/stream teardown can wedge asyncio.run's cancel-all in a
    # thread join.  This process exists only to emit one stats line —
    # once that's out, nothing it leaks matters.
    try:
        await asyncio.wait_for(teardown(), 10)
    except Exception:  # noqa: BLE001 - teardown is best-effort
        pass
    report = {
        "committed": total,
        "seconds": round(dt, 3),
        "req_per_sec": round(total / dt, 1),
        "cpu_per_wall": round(cpu_s / dt, 3),
        "latencies_ms": latencies_ms,
    }
    if engine is not None:
        report["engine"] = engine_report(engine)
    print(_json.dumps(report), flush=True)
    sys.stderr.flush()
    os._exit(0)


async def _run_selftest(args) -> int:
    """In-process n=4/f=1 commit through generated keys + the dummy
    connector — a deployment smoke test needing no files or sockets."""
    from ... import api
    from ...client import new_client
    from ...core import new_replica
    from ...sample.authentication import generate_testnet_keys
    from ...sample.config import SimpleConfiger
    from ...sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from ...sample.requestconsumer import SimpleLedger

    if args.chaos_seed is not None or args.chaos_profile is not None:
        raise NotPortedError("selftest --chaos-* (testing/faultnet.py)", "5")
    n, f = 4, 1
    store = generate_testnet_keys(n, n_clients=1)
    cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0)
    stubs = make_testnet_stubs(n)

    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    for i in range(n):
        r = new_replica(
            i,
            cfg,
            store.replica_authenticator(i),
            InProcessPeerConnector(stubs),
            ledgers[i],
            opts=_log_opts(args),
        )
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    client = new_client(
        0, n, f, store.client_authenticator(0), InProcessClientConnector(stubs),
    )
    await client.start()

    result = await asyncio.wait_for(client.request(b"selftest"), 60)
    for _ in range(200):
        if all(lg.length == 1 for lg in ledgers):
            break
        await asyncio.sleep(0.02)
    ok = all(lg.length == 1 for lg in ledgers)
    read_ok = False
    if ok:
        # and the read-only fast path: strict (no ordered fallback) so a
        # fast-quorum regression fails the selftest loudly
        try:
            head = await asyncio.wait_for(
                client.request(
                    b"head",
                    read_only=True,
                    read_fallback=False,
                    read_timeout=30.0,
                ),
                60,
            )
        except (asyncio.TimeoutError, api.ReadOnlyQueryError):
            head = b""
        read_ok = bool(head) and head.endswith(ledgers[0].state_digest())
        read_ok = read_ok and all(lg.length == 1 for lg in ledgers)
    await client.stop()
    for r in replicas:
        await r.stop()
    if not ok:
        print("selftest FAILED: not all ledgers committed", file=sys.stderr)
        return 1
    if not read_ok:
        print("selftest FAILED: read-only fast path", file=sys.stderr)
        return 1
    print(f"selftest ok: request committed on all {n} replicas, "
          f"fast read served "
          f"(usig={store.usig_spec}, result={result.hex()[:16]}…)", file=sys.stderr)
    return 0


def _run_testnet_scaffold(args) -> int:
    """Write keys.yaml + consensus.yaml for an n-replica local cluster
    (the docker-entrypoint key-generation step of the reference,
    sample/docker/docker-entrypoint.sh, as an explicit command)."""
    from ...sample.authentication import generate_testnet_keys

    if args.groups > 1:
        raise NotPortedError(f"testnet --groups {args.groups} (groups/)", "6")
    f = args.faults if args.faults is not None else (args.replicas - 1) // 2
    if args.replicas < 2 * f + 1:
        raise SystemExit(f"peer: n={args.replicas} < 2f+1 with f={f}")
    os.makedirs(args.dir, exist_ok=True)
    store = generate_testnet_keys(
        args.replicas, n_clients=args.clients, usig_spec=args.usig,
        with_macs=args.macs,
    )
    keys_path = os.path.join(args.dir, "keys.yaml")
    store.save(keys_path)
    # Per-replica least-privilege copies: replica i gets only its own
    # private material (and only its rows of the MAC matrix).  The full
    # keys.yaml stays for the operator/client side.  All files are
    # written 0600 (KeyStore.save).
    for i in range(args.replicas):
        store.strip_private(keep_replica=i).save(
            os.path.join(args.dir, f"keys.replica{i}.yaml")
        )
    peers = [
        {"id": i, "addr": f"{args.host}:{args.base_port + i}"}
        for i in range(args.replicas)
    ]
    cfg = {
        "protocol": {
            "n": args.replicas,
            "f": f,
            # Checkpointing on by default: every 128 executions the
            # replicas certify state, GC their logs behind the stable
            # certificate, and serve state transfer (override with
            # CONSENSUS_CHECKPOINT_PERIOD; 0 disables).
            "checkpointPeriod": 128,
            "logsize": 0,
            "batchsizePrepare": 64,
            "groups": max(1, args.groups),
            "timeout": {"request": "8s", "prepare": "4s", "viewchange": "8s"},
        },
        "peers": peers,
    }
    import yaml

    cfg_path = os.path.join(args.dir, "consensus.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=False)
    # Sample per-node options file (reference ships sample/peer/peer.yaml):
    # picked up automatically by `peer` run from this directory; every
    # value still overridable by PEER_* env vars and flags.
    peer_path = os.path.join(args.dir, "peer.yaml")
    if not os.path.exists(peer_path):
        with open(peer_path, "w") as fh:
            fh.write(
                "# Per-node peer options (layered under PEER_* env vars"
                " and flags)\n"
                "keys: keys.yaml\n"
                "config: consensus.yaml\n"
                "log_level: info\n"
                "#run:\n"
                "#  batch: 512\n"
                "#  device: cuda:0\n"
                "#  metrics_interval: 0\n"
                "#request:\n"
                "#  client_id: 0\n"
                "#  timeout: 30.0\n"
            )
    print(
        f"wrote {keys_path} (usig={store.usig_spec}), {cfg_path} "
        f"(n={args.replicas}, f={f}), and {peer_path}",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    path, explicit = peek_options_path(argv)
    args = build_parser(load_peer_options(path, explicit)).parse_args(argv)
    # Records from loggers other than the replica's own (which owns its
    # handler, core/options.py) carry their name and level: a log reader
    # can then tell an ERROR from the client or the engine apart.
    logging.basicConfig(format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.command == "run":
        # Optional uvloop (MINBFT_UVLOOP, auto-detected): must be
        # installed as the policy BEFORE asyncio.run creates the loop.
        from ...utils.loop import maybe_enable_uvloop

        if maybe_enable_uvloop():
            logging.getLogger("minbft.peer").info("event loop: uvloop")
        return asyncio.run(_run_replica(args))
    if args.command == "request":
        return asyncio.run(_run_request(args))
    if args.command == "bench":
        return asyncio.run(_run_bench_clients(args))
    if args.command == "selftest":
        return asyncio.run(_run_selftest(args))
    if args.command == "testnet":
        return _run_testnet_scaffold(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
