"""Observability of the port (copies of :mod:`minbft_tpu.obs`): the
flight recorder (``trace``), histograms (``hist``), the cluster critical
path (``critpath``, ``clockalign``), the event-loop lag sampler
(``looplag``), the SLO engine (``slo``), run attribution (``runinfo``),
the telemetry rings (``timeseries``) and the device-utilization ledger
(``ledger``)."""

from .ledger import Decomposition, DeviceLedger, QueueWindow
from .timeseries import CounterSampler, TimeSeries

__all__ = [
    "CounterSampler",
    "Decomposition",
    "DeviceLedger",
    "QueueWindow",
    "TimeSeries",
]
