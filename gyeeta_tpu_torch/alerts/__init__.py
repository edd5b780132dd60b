"""Alerting: definitions, realtime evaluation, silences/inhibits/grouping.

Mirrors the reference's two-tier alert architecture — per-madhava realtime
evaluation of alert definitions against live state (``server/gy_malerts.cc``
MRT_ALERTDEF + RT_ALERT_VECS) and the central shyama ALERTMGR
(``server/gy_alertmgr.cc``: silences :5117, inhibits :5200, grouping :574,
actions :50) — collapsed into one manager: criteria masks evaluate
columnar over whole snapshots (every service in one vector op), and the
alert lifecycle (consecutive-hit counts, firing, notification routing)
runs host-side as control plane.

A copy of ``gyeeta_tpu/alerts/__init__.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from gyeeta_tpu_torch.alerts.defs import AlertDef, Silence, Inhibit
from gyeeta_tpu_torch.alerts.manager import AlertManager, Alert

__all__ = ["AlertDef", "Silence", "Inhibit", "AlertManager", "Alert"]
