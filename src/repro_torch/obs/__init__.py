"""Observability + control subsystem for the HHZS reproduction.

``metrics``  — virtual-time :class:`MetricsRegistry`: counters, pull
gauges, dynamic collectors, windowed rates, and bounded ring-buffer time
series sampled on the DES clock by a daemon process (zero hot-path
overhead: every built-in signal is *pulled* at sample time).  Plus
:class:`Ewma`, the control plane's measurement filter.

``control``  — :class:`ControlPlane` v2: closes the loop from telemetry
to the store's knobs — compaction debt as a pressure signal, pluggable
control laws (AIMD, or :class:`PIController` with anti-windup) driving
per-tenant token-bucket rates toward p99 SLO targets, and — via
``AdmissionConfig.feedback_knobs`` — compaction pacing, migration
aggressiveness and the hinted-cache zone budget, with per-tenant
compaction-debt attribution biasing throttling toward the debt
generator.
"""
from .metrics import Counter, Ewma, MetricsRegistry, TIMELINE_KIND
from .control import KNOBS, ControlPlane, PIController

__all__ = ["Counter", "Ewma", "MetricsRegistry", "TIMELINE_KIND",
           "KNOBS", "ControlPlane", "PIController"]
