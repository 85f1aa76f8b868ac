"""Process-incarnation identity for every observability surface.

Two problems share one fix:

- A merged multi-target scrape or a cross-node dump merge is only
  attributable if every sample says WHICH process produced it — a
  restarted replica keeps its replica id but is a different process
  with fresh counters and a fresh (client_id, seq) keyspace.
- The critpath/time-series mergers must be able to REFUSE splicing two
  incarnations of the same replica id into one timeline (the chimera
  problem): that requires a per-incarnation stamp that changes on every
  restart and never within one process lifetime.

``RUN_ID`` is that stamp: pid + wall-clock start nanoseconds, fixed at
first import.  ``build_info()`` is the attribution block (pid, backend,
git rev) rendered as the ``minbft_build_info`` gauge labels and merged
into trace/time-series dump metadata.  The module stays import-light:
jax is consulted only if something else already imported it — an
observability stamp; the port's copy reports the torch device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, Optional

# Per-incarnation run id: monotone across restarts of the same replica
# id (wall-clock start stamp), unique across concurrent processes (pid).
RUN_ID: str = f"{os.getpid()}-{time.time_ns()}"

_git_rev: Optional[str] = None


def git_rev() -> str:
    """Short git revision of the running tree, memoized.  Falls back to
    ``MINBFT_GIT_REV`` (container builds without a .git directory), then
    ``unknown`` — an attribution label, so it must never raise."""
    global _git_rev
    if _git_rev is not None:
        return _git_rev
    rev = os.environ.get("MINBFT_GIT_REV")
    if not rev:
        try:
            # noqa: AH101 - one-shot and cached (5s cap); attribution only
            rev = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            rev = "unknown"
    _git_rev = rev
    return rev


def backend() -> str:
    """The torch device the port's kernels run on: ``cuda:<card name>``
    when PyTorch sees a CUDA card, ``cpu`` otherwise (the plain PyTorch
    versions).  Never imports JAX."""
    import torch

    try:
        if torch.cuda.is_available():
            return f"cuda:{torch.cuda.get_device_name(0)}"
    except Exception:  # noqa: BLE001 - a dead driver is still a label
        return "error"
    return "cpu"


def build_info(
    replica_id: Optional[int] = None,
    group: Optional[int] = None,
    groups: Optional[int] = None,
) -> Dict[str, str]:
    """The attribution block: every value a STRING (Prometheus label
    values and JSON dump metadata share it verbatim)."""
    info = {
        "pid": str(os.getpid()),
        "run_id": RUN_ID,
        "backend": backend(),
        "git_rev": git_rev(),
    }
    if replica_id is not None:
        info["replica"] = str(replica_id)
    if group is not None:
        info["group"] = str(group)
    if groups is not None:
        info["groups"] = str(groups)
    return info
