"""Environment-variable flag binding shared by the CLIs (port of
:mod:`minbft_tpu.sample.envflags`).

The reference layers flags over env vars via viper's ``SetEnvPrefix``
(sample/peer/cmd/root.go:73-82).  argparse neither type-checks nor
``choices``-checks *defaults*, so env-sourced values must be validated
here, before they reach the parser.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def env_default(prefix: str, name: str, fallback, choices: Optional[Sequence] = None):
    """``$<PREFIX>_<NAME>`` coerced to ``type(fallback)``, else ``fallback``.

    Exits with a usage-style message on a value that fails coercion or is
    outside ``choices``."""
    var = f"{prefix}_{name.upper()}"
    v = os.environ.get(var)
    if v is None:
        return fallback
    try:
        value = type(fallback)(v)
    except ValueError:
        raise SystemExit(
            f"{prefix.lower()}: invalid {var}={v!r} "
            f"(expected {type(fallback).__name__})"
        )
    if choices is not None and value not in choices:
        raise SystemExit(
            f"{prefix.lower()}: invalid {var}={v!r} (choose from {', '.join(map(str, choices))})"
        )
    return value
