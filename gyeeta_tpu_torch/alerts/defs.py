"""Alert/silence/inhibit definitions (the CRUD payloads).

Field names follow the reference's alertdef JSON (``common/gy_alerts.cc``
parse; shyama CRUD ``CRUD_ALERT_JSON`` path): ``alertname``, ``subsys``,
``filter`` (criteria string), ``severity``, ``numcheckfor`` (consecutive
5s checks before firing), ``repeataftersec`` (re-notification holdoff),
``action`` names, ``annotations``/``labels`` templates.

A copy of ``gyeeta_tpu/alerts/defs.py``; ``parse_dur`` comes from
``history/timeview.py``, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from gyeeta_tpu_torch.history.timeview import parse_dur
from gyeeta_tpu_torch.query import criteria, fieldmaps

SEVERITIES = ("info", "warning", "critical")

ALERT_MODES = ("realtime", "db")


class AlertDef(NamedTuple):
    name: str
    subsys: str
    filter: str
    severity: str = "warning"
    numcheckfor: int = 1          # consecutive matching checks to fire
    repeataftersec: float = 300.0  # holdoff before re-notifying an entity
    actions: tuple = ("log",)
    labels: tuple = ()             # ((key, value), ...) — immutable
    annotations: tuple = ()
    enabled: bool = True
    # mode "realtime": evaluated on the live snapshot every 5s check
    # mode "db": evaluated as periodic criteria-SQL over the history
    # store (ref MDB_ALERTDEF periodic queries, server/gy_malerts.cc) —
    # ``querysec`` is both the evaluation period and the lookback window
    mode: str = "realtime"
    querysec: float = 300.0
    # notification group-wait: alerts buffer for this many seconds after
    # the group opens, then emit as one batch (ref ALERT_GROUP
    # group-wait windows, server/gy_alertmgr.h:574). 0 = immediate.
    groupwaitsec: float = 0.0
    # realtime defs only: evaluate against the time-travel tier's
    # WINDOWED per-entity aggregate over this duration ("15m", "1h",
    # seconds) instead of the live snapshot — "alert when the 15m mean
    # error rate exceeds X". Needs history shards (hist_shard_dir);
    # checks are skipped (counted) until the first window exists.
    window: str = ""

    def validate(self) -> "AlertDef":
        """Definition-time checks shared by the JSON and direct-
        instance paths (``AlertManager.add_def`` runs this for BOTH):
        a typo'd subsys fails here with the valid-subsystem list, and
        a filter whose criteria target a different subsystem fails
        here too — at evaluation such criteria are skipped (all-pass),
        so the def would otherwise match every row, surfacing only at
        the first fold-time check."""
        fieldmaps.check_subsys(self.subsys)
        tree = criteria.parse(self.filter)
        if tree is None:
            raise ValueError("alertdef filter must be non-empty")
        criteria.check_filter_subsys(tree, self.subsys,
                                     what=f"alertdef {self.name!r}")
        if self.window:
            try:
                dur = parse_dur(self.window)
            except ValueError:
                raise ValueError(
                    f"alertdef {self.name!r}: bad window "
                    f"{self.window!r} (use seconds or 15m/2h/1d)")
            if dur <= 0:
                raise ValueError(
                    f"alertdef {self.name!r}: window must be positive")
            if self.mode != "realtime":
                raise ValueError(
                    f"alertdef {self.name!r}: window applies to "
                    "realtime defs (db defs window via querysec)")
        return self

    @classmethod
    def from_json(cls, d: dict) -> "AlertDef":
        if "alertname" not in d or "subsys" not in d or "filter" not in d:
            raise ValueError("alertdef needs alertname/subsys/filter")
        sev = d.get("severity", "warning")
        if sev not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        mode = d.get("mode", "realtime")
        if mode not in ALERT_MODES:
            raise ValueError(f"mode must be one of {ALERT_MODES}")
        return cls(
            name=d["alertname"], subsys=d["subsys"], filter=d["filter"],
            severity=sev,
            numcheckfor=max(1, int(d.get("numcheckfor", 1))),
            repeataftersec=float(d.get("repeataftersec", 300.0)),
            actions=cls._actions_of_json(d),
            labels=tuple(sorted(dict(d.get("labels", {})).items())),
            annotations=tuple(sorted(dict(d.get("annotations", {}))
                                     .items())),
            enabled=bool(d.get("enabled", True)),
            mode=mode,
            querysec=max(1.0, float(d.get("querysec", 300.0))),
            groupwaitsec=max(0.0, float(d.get("groupwaitsec", 0.0))),
            window=str(d.get("window", "") or ""),
        ).validate()

    @staticmethod
    def _actions_of_json(d: dict) -> tuple:
        # 'action'/'actions', string or list — a bare string must wrap,
        # never iterate into per-character "names"
        acts = d.get("action", d.get("actions", ("log",)))
        return (acts,) if isinstance(acts, str) else tuple(acts)


class Silence(NamedTuple):
    """Mute alerts matching ``filter`` between tstart and tend
    (ref silences: ``server/gy_alertmgr.cc:5117`` is_alert_silenced)."""
    name: str
    filter: Optional[str] = None       # None = match all
    alertnames: tuple = ()             # () = any alert
    tstart: float = 0.0
    tend: float = float("inf")

    @classmethod
    def from_json(cls, d: dict) -> "Silence":
        return cls(name=d["name"], filter=d.get("filter"),
                   alertnames=tuple(d.get("alertnames", ())),
                   tstart=float(d.get("tstart", 0.0)),
                   tend=float(d.get("tend", float("inf"))))


class Inhibit(NamedTuple):
    """While any alert matching ``src_alertnames`` fires, suppress alerts
    in ``target_alertnames`` (ref: ``gy_alertmgr.cc:5200``)."""
    name: str
    src_alertnames: tuple
    target_alertnames: tuple

    @classmethod
    def from_json(cls, d: dict) -> "Inhibit":
        return cls(name=d["name"],
                   src_alertnames=tuple(d["src_alertnames"]),
                   target_alertnames=tuple(d["target_alertnames"]))
