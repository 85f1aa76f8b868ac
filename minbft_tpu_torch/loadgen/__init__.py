"""Open-loop load harness of the port (counterpart of
:mod:`minbft_tpu.loadgen`): seeded arrival schedules, a
bounded-connection traffic generator measuring latency from SCHEDULED
arrival time, and the replay-census faithfulness contract.

The reference's ``perf/LOAD.md`` has the methodology; ``peer load`` and
the port bench's ``load`` section are the entry points.  The local
cluster's replicas check every request MAC or signature and every USIG
certificate through one engine on the card (``run_local_load(device=)``).
"""

from .arrivals import (
    Arrival,
    LoadSpec,
    Schedule,
    build_schedule,
    replay_census,
)
from .harness import OpenLoopGenerator

__all__ = [
    "Arrival",
    "LoadSpec",
    "Schedule",
    "build_schedule",
    "replay_census",
    "OpenLoopGenerator",
]
