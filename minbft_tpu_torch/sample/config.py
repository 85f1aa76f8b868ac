"""Configuration provider (reference sample/config/viperconfiger.go).

``SimpleConfiger`` is the programmatic form; ``load_config`` reads the YAML
schema of the reference's consensus.yaml (protocol.{n,f,checkpointPeriod,
logsize,timeout.{request,prepare,viewchange}}, peers[] with id/addr) via
PyYAML (baked into the runtime image).

Layering (the viper equivalent, reference viperconfiger.go + root.go env
binding): ``CONSENSUS_*`` environment variables override file values —
``CONSENSUS_TIMEOUT_REQUEST=5s``, ``CONSENSUS_CHECKPOINT_PERIOD=16``, etc.
The quorum shape (n, f) is deliberately NOT env-overridable: it must be
identical cluster-wide and belongs to the shared file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from .. import api


@dataclasses.dataclass
class PeerAddr:
    id: int
    addr: str


class SimpleConfiger(api.Configer):
    def __init__(
        self,
        n: int,
        f: int,
        checkpoint_period: int = 0,
        logsize: int = 0,
        timeout_request: float = 2.0,
        timeout_prepare: float = 1.0,
        timeout_viewchange: float = 8.0,
        peers: Optional[List[PeerAddr]] = None,
        batchsize_prepare: int = 64,
        groups: int = 1,
        slo_target_ms: Optional[float] = None,
        slo_objective: Optional[float] = None,
    ):
        self._n = n
        self._f = f
        self._checkpoint_period = checkpoint_period
        self._logsize = logsize
        self._timeout_request = timeout_request
        self._timeout_prepare = timeout_prepare
        self._timeout_viewchange = timeout_viewchange
        self.peers = peers or []
        # Max requests coalesced into one PREPARE (this build's request
        # batching; the reference has none — roadmap README.md:505).
        self.batchsize_prepare = batchsize_prepare
        # Consensus groups per replica process (minbft_tpu/groups): G
        # independent MinBFT instances over shared transport + one
        # engine.  1 = the ungrouped runtime.  Like n/f this must be
        # identical cluster-wide, so it lives in the shared file —
        # CONSENSUS_GROUPS exists for test/bench layering only.
        self.groups = groups
        # Latency-SLO policy (obs/slo.py): finality budget + objective
        # fraction.  None = SLO accounting stays off unless the
        # MINBFT_SLO_* env knobs turn it on; a set target here enables
        # it (consensus.yaml ``protocol.slo.{target,objective}``).  The
        # MINBFT_SLO_* env always layers on top, including per-group
        # comma lists.
        self.slo_target_ms = slo_target_ms
        self.slo_objective = slo_objective

    @property
    def n(self) -> int:
        return self._n

    @property
    def f(self) -> int:
        return self._f

    @property
    def checkpoint_period(self) -> int:
        return self._checkpoint_period

    @property
    def logsize(self) -> int:
        return self._logsize

    @property
    def timeout_request(self) -> float:
        return self._timeout_request

    @property
    def timeout_prepare(self) -> float:
        return self._timeout_prepare

    @property
    def timeout_viewchange(self) -> float:
        return self._timeout_viewchange


def load_config(path: str, env: Optional[Dict[str, str]] = None) -> SimpleConfiger:
    """Load a consensus.yaml (reference sample/config/consensus.yaml schema),
    with ``CONSENSUS_*`` env overrides layered on top (see module doc)."""
    if env is None:
        env = os.environ
    # noqa: AH102 - one small config file read once at replica startup
    with open(path) as fh:
        text = fh.read()
    data = _parse_yaml(text)
    proto = data.get("protocol", {})
    timeout = proto.get("timeout", {})
    slo = proto.get("slo", {})
    peers = [
        PeerAddr(id=int(p["id"]), addr=str(p["addr"]))
        for p in data.get("peers", [])
    ]

    def layered(env_key: str, file_val, cast):
        v = env.get(f"CONSENSUS_{env_key}")
        return cast(v) if v is not None else cast(file_val)

    return SimpleConfiger(
        n=int(proto["n"]),
        f=int(proto["f"]),
        checkpoint_period=layered(
            "CHECKPOINT_PERIOD", proto.get("checkpointPeriod", 0), int
        ),
        logsize=layered("LOGSIZE", proto.get("logsize", 0), int),
        timeout_request=layered(
            "TIMEOUT_REQUEST", timeout.get("request", "2s"), _seconds
        ),
        timeout_prepare=layered(
            "TIMEOUT_PREPARE", timeout.get("prepare", "1s"), _seconds
        ),
        timeout_viewchange=layered(
            "TIMEOUT_VIEWCHANGE", timeout.get("viewchange", "8s"), _seconds
        ),
        peers=peers,
        batchsize_prepare=layered(
            "BATCHSIZE_PREPARE", proto.get("batchsizePrepare", 64), int
        ),
        groups=layered("GROUPS", proto.get("groups", 1), int),
        # `protocol.slo.target: 1s` / `.objective: 0.99`; absent keys
        # stay None so the SLO engine's env-gated default is untouched.
        slo_target_ms=(
            layered("SLO_TARGET", slo.get("target", "1s"), _seconds) * 1e3
            if "target" in slo or env.get("CONSENSUS_SLO_TARGET")
            else None
        ),
        slo_objective=(
            layered("SLO_OBJECTIVE", slo.get("objective", 0.99), float)
            if "objective" in slo or env.get("CONSENSUS_SLO_OBJECTIVE")
            else None
        ),
    )


def _seconds(v) -> float:
    """'1500ms' / '2s' / numeric → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def _parse_yaml(text: str) -> Dict:
    import yaml  # baked into the environment

    return yaml.safe_load(text) or {}
