"""Alert action delivery: webhook executor + preset payload shapes.

The reference's alertmgr routes grouped alerts to action agents —
EMAIL / SLACK / PAGERDUTY / WEBHOOK (``server/gy_alertmgr.h:50-58``) —
executed off the evaluation path by a dedicated action thread
(``alert_act_thread``, ``server/gy_alertmgr.cc:3465``). Same split
here: :class:`ActionDispatcher` owns ONE worker thread and a bounded
queue; alert evaluation only enqueues (never blocks on the network),
the worker does HTTP POST with retry/backoff, and overflow drops the
oldest batch (counted) rather than stalling ingest.

Everything is a webhook underneath: ``slack``, ``email`` and
``pagerduty`` are payload presets over the same executor (the
reference's EMAIL/SLACK agents are likewise thin shapers over a
delivery channel). Templates are ``str.format`` over the group's
fields — no engine dependency.

A copy of ``gyeeta_tpu/alerts/deliver.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

_DEF_TIMEOUT = 5.0
_DEF_RETRIES = 2
_DEF_BACKOFF = 0.5
_MAX_QUEUE = 256

ACTION_TYPES = ("webhook", "slack", "email", "pagerduty")


class ActionConfig:
    """One configured action (CRUD objtype "action")."""

    def __init__(self, name: str, atype: str = "webhook",
                 url: str = "", method: str = "POST",
                 timeout_s: float = _DEF_TIMEOUT,
                 retries: int = _DEF_RETRIES,
                 backoff_s: float = _DEF_BACKOFF,
                 headers: Optional[dict] = None,
                 template: str = ""):
        if atype not in ACTION_TYPES:
            raise ValueError(f"action type must be one of {ACTION_TYPES}")
        if not url:
            raise ValueError("action needs a url")
        self.name = name
        self.atype = atype
        self.url = url
        self.method = method
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.headers = dict(headers or {})
        self.template = template

    @classmethod
    def from_json(cls, d: dict) -> "ActionConfig":
        return cls(name=d["name"], atype=d.get("type", "webhook"),
                   url=d.get("url", ""), method=d.get("method", "POST"),
                   timeout_s=d.get("timeout_s", _DEF_TIMEOUT),
                   retries=d.get("retries", _DEF_RETRIES),
                   backoff_s=d.get("backoff_s", _DEF_BACKOFF),
                   headers=d.get("headers"),
                   template=d.get("template", ""))


def _group_summary(group: list) -> dict:
    first = group[0]
    return {
        "alertname": first.alertname,
        "severity": first.severity,
        "subsys": first.subsys,
        "nalerts": len(group),
        "entities": [a.entity for a in group[:16]],
    }


def _render(template: str, group: list) -> str:
    s = _group_summary(group)
    default = (f"[{s['severity']}] {s['alertname']}: {s['nalerts']} "
               f"alert(s) on {s['subsys']}")
    if not template:
        return default
    try:
        return template.format(**s)
    except Exception:     # noqa: BLE001 — template is operator input;
        return default    # any format failure falls back, never raises


def build_payload(cfg: ActionConfig, group: list) -> bytes:
    """Grouped alerts → the action type's wire shape."""
    alerts = [{
        "alertname": a.alertname, "severity": a.severity,
        "subsys": a.subsys, "entity": a.entity, "tfired": a.tfired,
        "labels": a.labels, "annotations": a.annotations,
        "row": {k: (v if isinstance(v, (int, float, str, bool))
                    or v is None else str(v))
                for k, v in a.row.items()},
    } for a in group]
    if cfg.atype == "slack":
        obj = {"text": _render(cfg.template, group),
               "attachments": [{"fields": alerts}]}
    elif cfg.atype == "email":
        s = _group_summary(group)
        obj = {"subject": f"[{s['severity']}] {s['alertname']} "
                          f"({s['nalerts']} alerts)",
               "body": _render(cfg.template, group),
               "alerts": alerts}
    elif cfg.atype == "pagerduty":
        s = _group_summary(group)
        obj = {"event_action": "trigger",
               "payload": {"summary": _render(cfg.template, group),
                           "severity": s["severity"],
                           "source": s["subsys"],
                           "custom_details": {"alerts": alerts}}}
    else:
        obj = {"status": "firing",
               "groupSummary": _group_summary(group),
               "alerts": alerts}
    return json.dumps(obj).encode()


class ActionDispatcher:
    """One worker thread delivering queued (config, group) batches."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=_MAX_QUEUE)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = {"delivered": 0, "failed": 0, "retries": 0,
                      "dropped": 0}
        # in-flight accounting (enqueue→finished) for a race-free
        # drain(): an Event set on queue-empty can fire between a
        # worker's get() timeout and a concurrent enqueue
        self._pending = 0
        self._cv = threading.Condition()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="gyt-alert-actions", daemon=True)
            self._thread.start()

    def enqueue(self, cfg: ActionConfig, group: list) -> None:
        """Never blocks evaluation: on overflow the OLDEST batch drops
        (freshest alerts win — the reference likewise sheds when its
        action queue backs up)."""
        self._ensure_thread()
        with self._cv:
            self._pending += 1
        try:
            self._q.put_nowait((cfg, group))
            return
        except queue.Full:
            pass
        removed = 0
        try:
            self._q.get_nowait()      # shed the OLDEST batch
            removed = 1
        except queue.Empty:
            pass
        added = True
        try:
            self._q.put_nowait((cfg, group))
        except queue.Full:
            added = False
        lost = removed + (0 if added else 1)
        with self._cv:
            self.stats["dropped"] += lost
            self._pending -= lost
            self._cv.notify_all()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                cfg, group = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._deliver(cfg, group)
            except Exception:  # noqa: BLE001 — a poison batch (bad
                # config/payload) must not kill the worker; count it
                # as failed and keep draining
                self.stats["failed"] += 1
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _deliver(self, cfg: ActionConfig, group: list) -> None:
        body = build_payload(cfg, group)
        headers = {"Content-Type": "application/json", **cfg.headers}
        for attempt in range(cfg.retries + 1):
            try:
                req = urllib.request.Request(
                    cfg.url, data=body, headers=headers,
                    method=cfg.method)
                with urllib.request.urlopen(
                        req, timeout=cfg.timeout_s) as resp:
                    if 200 <= resp.status < 300:
                        self.stats["delivered"] += 1
                        return
            except (urllib.error.URLError, OSError, ValueError):
                pass
            if attempt < cfg.retries:
                self.stats["retries"] += 1
                time.sleep(cfg.backoff_s * (2 ** attempt))
        self.stats["failed"] += 1

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait until every enqueued batch has finished delivering
        (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def close(self, timeout: float = 5.0) -> None:
        """Drain queued deliveries (bounded), then stop the worker —
        SIGTERM with alerts in flight must not silently lose them (the
        compose stop_grace_period exists for exactly this drain)."""
        if self._thread is not None and self._thread.is_alive():
            self.drain(timeout)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
