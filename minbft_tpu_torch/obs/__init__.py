"""Observability of the port (copies of :mod:`minbft_tpu.obs`): the
flight recorder (``trace``), histograms (``hist``), the cluster critical
path (``critpath``, ``clockalign``), the event-loop lag sampler
(``looplag``), the SLO engine (``slo``), run attribution (``runinfo``),
the telemetry rings (``timeseries``), the device-utilization ledger
(``ledger``) and the Prometheus exposition (``prom``: ``peer run
--metrics-port`` and the ``peer metrics|top|slo`` scrapes)."""

from .ledger import Decomposition, DeviceLedger, QueueWindow
from .prom import (
    MetricsServer,
    collect_faultnet,
    collect_replica,
    render_families,
    scrape,
)
from .timeseries import CounterSampler, TimeSeries

__all__ = [
    "CounterSampler",
    "Decomposition",
    "DeviceLedger",
    "MetricsServer",
    "QueueWindow",
    "TimeSeries",
    "collect_faultnet",
    "collect_replica",
    "render_families",
    "scrape",
]
