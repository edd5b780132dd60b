"""Alert manager: columnar realtime evaluation + lifecycle + routing.

One ``check()`` per 5s engine pass evaluates every enabled alertdef as a
criteria mask over its subsystem snapshot (the whole fleet in a handful of
vector ops — the tensor form of the reference's per-event RT_ALERT_VECS
walk, ``server/gy_malerts.cc:1869``), then advances per-entity lifecycle:

    pending (consecutive hits < numcheckfor) → firing → resolved

Alertdefs ARE continuous queries (ISSUE 18): each def is a standing
filter whose canonical form (``query/normalize.py:canonical_filter``)
lands it in a ``(column-source, criteria)`` group shared with every
other def asking the same question — the predicate evaluates ONCE per
group per check (``ncq_group_evals`` counts group passes; compare
against the def count), the same normalization+grouping the
subscription hub's CQ tier uses (``query/cq.py``). A def FIRES on
membership *enter* (gated by ``numcheckfor`` consecutive membership
checks) and RESOLVES on *leave* (``cq.advance_entities`` is the
lifecycle step). Column sources are rendered lazily per targeted
subsystem only — a subsystem no def targets costs nothing, and the
runtimes skip the whole pass (counted ``alert_eval_skipped``) when no
realtime def is enabled.

Silences and inhibits gate *notification*, not detection (matching the
reference: a silenced alert still tracks state, ``gy_alertmgr.cc:5117``).

Two evaluation modes (the reference's RT vs MDB alertdef split,
``server/gy_malerts.cc``): realtime defs run in ``check()`` against the
live snapshot; db-mode defs run in ``check_db()`` as periodic
criteria-SQL over the history store every ``querysec`` (db-row silences
match by alertname/time only — history rows carry presentation strings,
not live ordinals).

Notification grouping (ref ALERT_GROUP group-wait windows,
``gy_alertmgr.h:574``): a def with ``groupwaitsec > 0`` buffers its
notifications from the moment the group opens and emits them as one
batch when the wait expires (``flush_groups``, called from ``check``).
Actions are pluggable callables; "log" is built in (EMAIL/SLACK/
PAGERDUTY/WEBHOOK of ``gy_alertmgr.h:50`` register the same way;
network egress is deployment-specific).

A copy of ``gyeeta_tpu/alerts/manager.py`` over the port's query engine.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.alerts.defs import AlertDef, Inhibit, Silence
from gyeeta_tpu_torch.query import api, cq, criteria
from gyeeta_tpu_torch.query.normalize import canonical_filter


class Alert(NamedTuple):
    alertname: str
    severity: str
    subsys: str
    entity: str                  # svcid / hostid / flow key
    tfired: float
    labels: dict
    annotations: dict
    row: dict                    # snapshot row at fire time


class _EntityState(NamedTuple):
    nhits: int = 0
    firing: bool = False
    tlast_notify: float = -1e18


# The entity key is the COMPOSITE of every id-grained column present:
# one key alone under-identifies rows on several subsystems (tracereq
# rows are (svcid, api); svcprocmap rows are (svcid, taskid)), and a
# coarse key collapses per-entity state — numcheckfor then advances
# once per matching row per check and distinct entities suppress each
# other through repeataftersec.
_ENTITY_KEYS = ("svcid", "taskid", "cgid", "cliid", "serid", "api",
                "flowid", "alertname", "hostid",
                # topk rows: one entity per (metric, entity id) — so
                # "new flow enters the top-10" fires once per flow, not
                # once per rank shuffle
                "metric", "id")


def _entity_key_of(subsys: str, cols: dict, i: int) -> str:
    parts = [f"{k}={cols[k][i]}" for k in _ENTITY_KEYS if k in cols]
    return ",".join(parts) if parts else f"row={i}"


def _entity_key_of_row(row: dict) -> str:
    parts = [f"{k}={row[k]}" for k in _ENTITY_KEYS
             if k in row and row[k] is not None]
    if parts:
        return ",".join(parts)
    # id-less subsystems (clusterstate): the whole subsystem is one
    # entity — per-row keys would defeat dedup/numcheckfor entirely
    return "all"


class AlertManager:
    MAX_LOG = 10_000     # bounded notification history (oldest dropped)

    def __init__(self, cfg, clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.defs: dict[str, AlertDef] = {}
        self.silences: dict[str, Silence] = {}
        self.inhibits: dict[str, Inhibit] = {}
        self.alert_log: collections.deque = collections.deque(
            maxlen=self.MAX_LOG)
        self.actions: dict[str, Callable[[list], None]] = {
            "log": self.alert_log.extend,
        }
        # configured delivery actions (webhook/slack/email/pagerduty):
        # configs live here for CRUD + the actions subsystem; execution
        # runs on the dispatcher's worker thread (ref alert_act_thread,
        # gy_alertmgr.cc:3465) so evaluation never blocks on HTTP
        self.action_cfgs: dict[str, "deliver.ActionConfig"] = {}
        self._dispatcher = None
        self._state: dict[tuple, _EntityState] = {}
        self._trees: dict[str, object] = {}     # parsed filter cache
        # def name → canonical filter: the criteria-group identity
        # (defs sharing it share one predicate pass per check)
        self._canon: dict[str, str] = {}
        self._groups: dict[str, list] = {}      # name → [deadline, alerts]
        self._next_db: dict[str, float] = {}    # db-def → next eval time
        self._last_db: dict[str, float] = {}    # db-def → last eval time
        self._clock = clock or time.time
        self.stats = {"nchecks": 0, "nfired": 0, "nsilenced": 0,
                      "ninhibited": 0, "nresolved": 0, "ndbchecks": 0,
                      "ngroups_flushed": 0,
                      # windowed defs checked before the first history
                      # window exists skip COUNTED (check() bumps this;
                      # it must pre-exist or the += KeyErrors)
                      "nwindow_skipped": 0,
                      # criteria-group predicate passes per check():
                      # defs sharing a canonical filter share one pass,
                      # so this stays ≤ the enabled realtime def count
                      "ncq_group_evals": 0}

    # ------------------------------------------------------------- CRUD
    def add_def(self, d: dict | AlertDef) -> AlertDef:
        # BOTH paths validate at definition time: a typo'd subsys (or a
        # filter whose criteria target another subsystem) fails the
        # CRUD request with the valid-subsystem list instead of
        # erroring on every subsequent fold-time check
        ad = (d.validate() if isinstance(d, AlertDef)
              else AlertDef.from_json(d))
        self.defs[ad.name] = ad
        self._trees[f"def:{ad.name}"] = criteria.parse(ad.filter)
        self._canon[ad.name] = canonical_filter(ad.filter)
        return ad

    def delete_def(self, name: str) -> bool:
        self._state = {k: v for k, v in self._state.items()
                       if k[0] != name}
        self._trees.pop(f"def:{name}", None)
        self._canon.pop(name, None)
        return self.defs.pop(name, None) is not None

    # defs the runtimes must evaluate this pass — the zero-def (or
    # zero-REALTIME-def) short-circuit happens at the CALLER, before
    # any column/render work, counted ``alert_eval_skipped``
    def wants_realtime(self) -> bool:
        return any(ad.enabled and ad.mode == "realtime"
                   for ad in self.defs.values())

    def wants_db(self) -> bool:
        return any(ad.enabled and ad.mode == "db"
                   for ad in self.defs.values())

    def pending_groups(self) -> bool:
        return bool(self._groups)

    def add_silence(self, d: dict | Silence) -> Silence:
        s = d if isinstance(d, Silence) else Silence.from_json(d)
        self.silences[s.name] = s
        if s.filter:
            self._trees[f"sil:{s.name}"] = criteria.parse(s.filter)
        return s

    def add_inhibit(self, d: dict | Inhibit) -> Inhibit:
        i = d if isinstance(d, Inhibit) else Inhibit.from_json(d)
        self.inhibits[i.name] = i
        return i

    def register_action(self, name: str, fn: Callable[[list], None]):
        self.actions[name] = fn

    @property
    def dispatcher(self):
        if self._dispatcher is None:
            from gyeeta_tpu_torch.alerts.deliver import ActionDispatcher
            self._dispatcher = ActionDispatcher()
        return self._dispatcher

    def add_action(self, d: dict):
        """CRUD: configure a delivery action (ref actiondef CRUD →
        routed by alertdef.actions names)."""
        from gyeeta_tpu_torch.alerts import deliver
        cfg = d if isinstance(d, deliver.ActionConfig) \
            else deliver.ActionConfig.from_json(d)
        if cfg.name == "log":
            raise ValueError("'log' is built in")
        self.action_cfgs[cfg.name] = cfg
        self.actions[cfg.name] = \
            lambda group, _c=cfg: self.dispatcher.enqueue(_c, group)
        return cfg

    def delete_action(self, name: str) -> bool:
        if name == "log":
            return False
        self.action_cfgs.pop(name, None)
        return self.actions.pop(name, None) is not None

    def close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.close()
            self._dispatcher = None

    # ------------------------------------------------------------ check
    def firing(self) -> list[tuple]:
        return [k for k, v in self._state.items() if v.firing]

    def _silenced(self, ad: AlertDef, cols, i, now) -> bool:
        for s in self.silences.values():
            if not (s.tstart <= now <= s.tend):
                continue
            if s.alertnames and ad.name not in s.alertnames:
                continue
            if s.filter:
                tree = self._trees.get(f"sil:{s.name}") \
                    or criteria.parse(s.filter)
                one = {k: np.asarray(v[i:i + 1]) for k, v in cols.items()}
                if not bool(criteria.evaluate(tree, one, ad.subsys)[0]):
                    continue
            return True
        return False

    def _inhibited(self, ad: AlertDef) -> bool:
        firing_names = {k[0] for k in self.firing()}
        for inh in self.inhibits.values():
            if ad.name in inh.target_alertnames and \
                    firing_names & set(inh.src_alertnames):
                return True
        return False

    def check(self, st, columns_fn=None) -> list[Alert]:
        """Evaluate all defs against live engine state → newly-notified
        alerts (grouped per def, routed to actions).

        Each def is a CONTINUOUS QUERY: its predicate evaluates once
        per ``(column-source, canonical-filter)`` group — N defs asking
        an equivalent question share one vectorized pass (the mask
        cache below; ``ncq_group_evals`` counts passes) — and the
        entity lifecycle advances on membership enter/stay/leave
        (``cq.advance_entities``): fire on enter after ``numcheckfor``
        consecutive membership checks, resolve on leave. Column
        sources render lazily per TARGETED subsystem only.

        ``columns_fn(subsys) -> (cols, mask)`` overrides the column source
        (the sharded runtime evaluates alerts on gathered readbacks)."""
        now = self._clock()
        self.stats["nchecks"] += 1
        notified: list[Alert] = []
        cols_cache: dict[str, tuple] = {}
        mask_cache: dict[tuple, object] = {}

        for ad in self.defs.values():
            if not ad.enabled or ad.mode != "realtime":
                continue
            # a windowed def evaluates against the time-travel tier's
            # aggregate: the column source is addressed "subsys@window"
            # (both runtimes route the suffix to timeview); before the
            # first window exists the check skips, counted
            ckey = f"{ad.subsys}@{ad.window}" if ad.window \
                else ad.subsys
            if ckey not in cols_cache:
                try:
                    cols_cache[ckey] = (
                        columns_fn(ckey) if columns_fn is not None
                        else api._COLUMNS_OF[ad.subsys](self.cfg, st))
                except ValueError:
                    if not ad.window:
                        raise
                    self.stats["nwindow_skipped"] += 1
                    cols_cache[ckey] = None
            if cols_cache[ckey] is None:
                continue
            cols, base = cols_cache[ckey]
            # shared-predicate index: one mask per (column source,
            # canonical criteria) group per check — the group key
            # embeds ckey so live and windowed defs never share
            gkey = (ckey, self._canon.get(ad.name, ad.filter))
            if gkey not in mask_cache:
                tree = self._trees.get(f"def:{ad.name}") \
                    or criteria.parse(ad.filter)
                try:
                    mask_cache[gkey] = \
                        base & criteria.evaluate(tree, cols, ad.subsys)
                    self.stats["ncq_group_evals"] += 1
                except KeyError:
                    if not ad.window:
                        raise
                    # a windowed QUANTILE criterion over shards without
                    # delta panels: the field was omitted from the
                    # window columns (never approximated) — the GROUP
                    # skips; each def standing on it counts below,
                    # exactly like a not-yet-existing window, instead
                    # of one stale store breaking the whole alert pass
                    mask_cache[gkey] = None
            mask = mask_cache[gkey]
            if mask is None:
                self.stats["nwindow_skipped"] += 1
                continue
            hits = set(np.nonzero(mask)[0].tolist())

            inhibited = self._inhibited(ad)
            group: list[Alert] = []
            # the def's held membership (entity keys with state):
            # enter/stay advance nhits below, leave resolves after
            held = {k for k in self._state if k[0] == ad.name}
            seen_keys = set()
            for i in sorted(hits):
                ent = _entity_key_of(ad.subsys, cols, i)
                key = (ad.name, ent)
                seen_keys.add(key)
                es = self._state.get(key, _EntityState())
                nhits = es.nhits + 1
                firing = nhits >= ad.numcheckfor
                notify = (firing
                          and now - es.tlast_notify >= ad.repeataftersec)
                if notify and self._silenced(ad, cols, i, now):
                    self.stats["nsilenced"] += 1
                    notify = False
                if notify and inhibited:
                    self.stats["ninhibited"] += 1
                    notify = False
                if notify:
                    row = {k: cols[k][i] for k in cols}
                    group.append(Alert(
                        alertname=ad.name, severity=ad.severity,
                        subsys=ad.subsys, entity=ent, tfired=now,
                        labels=dict(ad.labels),
                        annotations=dict(ad.annotations),
                        row={k: (v.item() if hasattr(v, "item") else v)
                             for k, v in row.items()}))
                    es = es._replace(tlast_notify=now)
                self._state[key] = es._replace(nhits=nhits, firing=firing)

            # LEAVE resolves (and drops state — the dict must not grow
            # with entity churn); enter/stay already advanced above
            _enter, _stay, leave = cq.advance_entities(held, seen_keys)
            for key in leave:
                if self._state[key].firing:
                    self.stats["nresolved"] += 1
                del self._state[key]

            self._emit(ad, group, now, notified)
        notified.extend(self.flush_groups(now))
        return notified

    # -------------------------------------------------- grouping/routing
    def _route(self, ad: AlertDef, group: list) -> None:
        for act in ad.actions:
            fn = self.actions.get(act)
            if fn is not None:
                fn(group)

    def _emit(self, ad: AlertDef, group: list, now: float,
              notified: list) -> None:
        if not group:
            return
        self.stats["nfired"] += len(group)
        if ad.groupwaitsec > 0:
            g = self._groups.get(ad.name)
            if g is None:
                # group opens with its first alert; the wait clock starts
                self._groups[ad.name] = [now + ad.groupwaitsec,
                                         list(group)]
            else:
                g[1].extend(group)
            return
        notified.extend(group)
        self._route(ad, group)

    def flush_groups(self, now: Optional[float] = None) -> list:
        """Emit groups whose wait window expired → flushed alerts."""
        now = self._clock() if now is None else now
        out: list = []
        for name in list(self._groups):
            deadline, alerts = self._groups[name]
            if now < deadline:
                continue
            del self._groups[name]
            ad = self.defs.get(name)
            if ad is None:
                continue
            self.stats["ngroups_flushed"] += 1
            out.extend(alerts)
            self._route(ad, alerts)
        return out

    # ---------------------------------------------------- db-mode check
    def check_db(self, history, now: Optional[float] = None) -> list:
        """Evaluate due db-mode defs as criteria-SQL over the history
        store (the MDB_ALERTDEF periodic path, ``server/gy_malerts.cc``):
        each def runs every ``querysec`` over its own lookback window;
        matched rows advance the same entity lifecycle as realtime defs.
        """
        now = self._clock() if now is None else now
        notified: list = []
        for ad in self.defs.values():
            if not ad.enabled or ad.mode != "db":
                continue
            due = self._next_db.get(ad.name, 0.0)
            if now < due:
                continue
            # window starts at the PREVIOUS eval time, not now-querysec:
            # tick-grain scheduling slip would otherwise leave a sliver
            # of history no eval ever covers
            tstart = self._last_db.get(ad.name, now - ad.querysec)
            self._next_db[ad.name] = now + ad.querysec
            self._last_db[ad.name] = now
            self.stats["ndbchecks"] += 1
            rows = history.query(ad.subsys, tstart, now, ad.filter)
            inhibited = self._inhibited(ad)
            group: list = []
            seen_keys = set()
            seen_entities = set()
            for row in rows:
                ent = _entity_key_of_row(row)
                if ent in seen_entities:
                    continue           # one alert per entity per eval
                seen_entities.add(ent)
                key = (ad.name, ent)
                seen_keys.add(key)
                es = self._state.get(key, _EntityState())
                nhits = es.nhits + 1
                firing = nhits >= ad.numcheckfor
                notify = (firing
                          and now - es.tlast_notify >= ad.repeataftersec)
                if notify and self._silenced_db(ad, now):
                    self.stats["nsilenced"] += 1
                    notify = False
                if notify and inhibited:
                    self.stats["ninhibited"] += 1
                    notify = False
                if notify:
                    group.append(Alert(
                        alertname=ad.name, severity=ad.severity,
                        subsys=ad.subsys, entity=ent, tfired=now,
                        labels=dict(ad.labels),
                        annotations=dict(ad.annotations),
                        row=dict(row)))
                    es = es._replace(tlast_notify=now)
                self._state[key] = es._replace(nhits=nhits, firing=firing)
            for key in [k for k in self._state
                        if k[0] == ad.name and k not in seen_keys]:
                if self._state[key].firing:
                    self.stats["nresolved"] += 1
                del self._state[key]
            self._emit(ad, group, now, notified)
        notified.extend(self.flush_groups(now))
        return notified

    def _silenced_db(self, ad: AlertDef, now: float) -> bool:
        """db-row silencing: alertname + time window only (history rows
        are presentation-domain; filter silences apply to realtime)."""
        for s in self.silences.values():
            if not (s.tstart <= now <= s.tend):
                continue
            if s.alertnames and ad.name not in s.alertnames:
                continue
            if s.filter:
                continue
            return True
        return False
