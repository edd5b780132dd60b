"""Server notification log — the ``notifymsg`` subsystem backing store.

The reference surfaces operational messages to the UI via
notificationtbl rows (``server/gy_mdb_schema.cc:101`` — agent
connects/disconnects, alert lifecycle, config events) queryable as
SUBSYS_NOTIFYMSG. Here: a bounded in-memory ring the runtime and the
network edge append to; queryable live like every other subsystem.

A copy of ``gyeeta_tpu/utils/notifylog.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple, Optional

import numpy as np

NOTIFY_INFO = "info"
NOTIFY_WARN = "warn"
NOTIFY_ERROR = "error"


class Notification(NamedTuple):
    tusec: float
    ntype: str          # info | warn | error
    source: str         # agent | alert | server | config
    msg: str


class NotifyLog:
    def __init__(self, maxlen: int = 10_000,
                 clock: Optional[callable] = None):
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._clock = clock or time.time
        # producers include non-loop threads (the crashguard watchdog,
        # alert delivery callbacks): a lock keeps columns()'s snapshot
        # iteration safe against cross-thread appends
        import threading
        self._lock = threading.Lock()

    def add(self, msg: str, ntype: str = NOTIFY_INFO,
            source: str = "server") -> None:
        with self._lock:
            self._ring.append(
                Notification(self._clock(), ntype, source, msg))

    def add_alert(self, alert) -> None:
        """One fired :class:`~gyeeta_tpu_torch.alerts.manager.Alert` → entry
        (shared by both runtimes so the format/severity mapping can't
        diverge)."""
        self.add(f"alert {alert.alertname} [{alert.severity}] "
                 f"{alert.entity}",
                 ntype=NOTIFY_WARN if alert.severity in ("warning", "info")
                 else NOTIFY_ERROR, source="alert")

    def __len__(self) -> int:
        return len(self._ring)

    def columns(self, names=None):
        """Newest first."""
        with self._lock:
            rows = list(self._ring)[::-1]
        n = len(rows)

        def obj(vals):
            out = np.empty(n, object)
            out[:] = vals
            return out

        cols = {
            "time": np.array([r.tusec for r in rows], np.float64),
            "type": obj([r.ntype for r in rows]),
            "source": obj([r.source for r in rows]),
            "msg": obj([r.msg for r in rows]),
        }
        return cols, np.ones(n, bool)
