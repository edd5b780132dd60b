"""Query-column providers over AlertManager state.

The reference serves alerts/alertdef/silences/inhibits as first-class
query subsystems from ALERTMGR's in-memory maps + shyama DB tables
(``server/gy_alertmgr.cc`` CRUD + ``gy_json_field_maps.h``
SUBSYS_ALERTS..SUBSYS_INHIBITS). Here the same four subsystems read the
AlertManager directly: the fired-alert log (bounded deque), the def
map, silences, and inhibit rules — filtered/sorted/projected by the
ordinary query engine once expressed as numpy columns.

A copy of ``gyeeta_tpu/alerts/columns.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import json

import numpy as np


def _obj(vals) -> np.ndarray:
    out = np.empty(len(vals), object)
    out[:] = vals
    return out


def alerts_columns(mgr, names=None):
    """Fired-alert log, newest first (SUBSYS_ALERTS)."""
    log = list(mgr.alert_log)[::-1]
    cols = {
        "tfired": np.array([a.tfired for a in log], np.float64),
        "alertname": _obj([a.alertname for a in log]),
        "severity": _obj([a.severity for a in log]),
        "subsys": _obj([a.subsys for a in log]),
        "entity": _obj([a.entity for a in log]),
        "labels": _obj([json.dumps(dict(a.labels)) for a in log]),
        "annotations": _obj([json.dumps(dict(a.annotations))
                             for a in log]),
    }
    return cols, np.ones(len(log), bool)


def alertdef_columns(mgr, names=None):
    defs = sorted(mgr.defs.values(), key=lambda d: d.name)
    firing = mgr.firing()
    nfiring = {d.name: 0 for d in defs}
    for key in firing:
        if key[0] in nfiring:
            nfiring[key[0]] += 1
    cols = {
        "alertname": _obj([d.name for d in defs]),
        "subsys": _obj([d.subsys for d in defs]),
        "filter": _obj([d.filter for d in defs]),
        "severity": _obj([d.severity for d in defs]),
        "mode": _obj([d.mode for d in defs]),
        "numcheckfor": np.array([d.numcheckfor for d in defs], np.float64),
        "repeataftersec": np.array([d.repeataftersec for d in defs],
                                   np.float64),
        "querysec": np.array([d.querysec for d in defs], np.float64),
        "groupwaitsec": np.array([d.groupwaitsec for d in defs],
                                 np.float64),
        "enabled": np.array([d.enabled for d in defs], bool),
        "nfiring": np.array([nfiring[d.name] for d in defs], np.float64),
    }
    return cols, np.ones(len(defs), bool)


def silences_columns(mgr, names=None, now=None):
    now = mgr._clock() if now is None else now
    sils = sorted(mgr.silences.values(), key=lambda s: s.name)
    cols = {
        "name": _obj([s.name for s in sils]),
        "filter": _obj([s.filter or "" for s in sils]),
        "alertnames": _obj([",".join(s.alertnames) for s in sils]),
        "tstart": np.array([s.tstart for s in sils], np.float64),
        "tend": np.array([min(s.tend, 1e18) for s in sils], np.float64),
        "active": np.array([s.tstart <= now <= s.tend for s in sils],
                           bool),
    }
    return cols, np.ones(len(sils), bool)


def actions_columns(mgr, names=None):
    """Registered alert actions + how many defs route to each
    (SUBSYS_ACTIONS; ref actionstbl + NODE_ACTION_SOCK routing)."""
    acts = sorted(mgr.actions)
    ndefs = {a: 0 for a in acts}
    for d in mgr.defs.values():
        for a in d.actions:
            if a in ndefs:
                ndefs[a] += 1
    cfgs = mgr.action_cfgs

    def redact(url: str) -> str:
        """scheme+host only: webhook paths ARE bearer secrets (Slack /
        PagerDuty incoming-webhook URLs) and the actions subsystem is
        readable by any query client."""
        from urllib.parse import urlsplit
        try:
            p = urlsplit(url)
            # no parseable host ⇒ show NOTHING (a schemeless
            # "host/path-secret" string would leak whole)
            return f"{p.scheme}://{p.netloc}/…" if p.netloc else ""
        except ValueError:
            return ""

    cols = {"name": _obj(acts),
            "type": _obj(["builtin" if a not in cfgs
                          else cfgs[a].atype for a in acts]),
            "target": _obj(["" if a not in cfgs
                            else redact(cfgs[a].url) for a in acts]),
            "ndefs": np.array([float(ndefs[a]) for a in acts])}
    return cols, np.ones(len(acts), bool)


def inhibits_columns(mgr, names=None):
    inhs = sorted(mgr.inhibits.values(), key=lambda i: i.name)
    firing_names = {k[0] for k in mgr.firing()}
    cols = {
        "name": _obj([i.name for i in inhs]),
        "srcalerts": _obj([",".join(i.src_alertnames) for i in inhs]),
        "targetalerts": _obj([",".join(i.target_alertnames)
                              for i in inhs]),
        "active": np.array(
            [bool(firing_names & set(i.src_alertnames)) for i in inhs],
            bool),
    }
    return cols, np.ones(len(inhs), bool)
