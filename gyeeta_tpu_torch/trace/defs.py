"""On-demand trace definitions: which services to capture, until when.

The control half of request tracing (§3.6 of the reference): a trace
definition selects listeners by criteria and a time bound; the control
plane distributes enable/disable to the owning agents
(``REQ_TRACE_DEF`` / ``SM_REQ_TRACE_DEF_NEW`` → partha ``REQ_TRACE_SET``,
``common/gy_trace_def.h``, ``gy_comm_proto.h:3295,3377``;
``server/gy_shconnhdlr.cc:1272``). Here the server owns the registry,
re-evaluates matches each tick against live svcinfo/svcstate columns,
and pushes ``COMM_TRACE_SET`` diffs down the agents' event conns.

A copy of ``gyeeta_tpu/trace/defs.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.query import criteria


class TraceDef(NamedTuple):
    name: str
    filter: Optional[str] = None    # criteria over svcinfo (None = all)
    tend: float = 0.0               # epoch sec; 0 = no expiry

    @classmethod
    def from_json(cls, d: dict) -> "TraceDef":
        if "name" not in d:
            raise ValueError("tracedef needs a name")
        filt = d.get("filter")
        if filt:
            tree = criteria.parse(filt)
            if tree is None:
                raise ValueError("tracedef filter must be non-empty")
        return cls(name=d["name"], filter=filt,
                   tend=float(d.get("tend", 0.0)))


class TraceDefs:
    """Registry + per-host applied-state diffing.

    ``target_svcids(columns_fn)`` evaluates every unexpired def against
    the live svcinfo columns → the set of (svcid, hostid) that should
    be capturing. ``diff_for_hosts`` turns that into per-host
    enable/disable lists relative to what was last pushed."""

    def __init__(self, clock=None):
        self.defs: dict[str, TraceDef] = {}
        self._applied: dict[int, set] = {}      # host → enabled svc ids
        self._trees: dict[str, object] = {}     # name → parsed filter
        self._nsvc: dict[str, int] = {}         # name → last match count
        self._clock = clock or time.time

    def add(self, d: dict | TraceDef) -> TraceDef:
        td = d if isinstance(d, TraceDef) else TraceDef.from_json(d)
        self.defs[td.name] = td
        self._trees[td.name] = (criteria.parse(td.filter)
                                if td.filter else None)
        return td

    def delete(self, name: str) -> bool:
        self._trees.pop(name, None)
        self._nsvc.pop(name, None)
        return self.defs.pop(name, None) is not None

    def _active_defs(self):
        now = self._clock()
        return [d for d in self.defs.values()
                if d.tend <= 0 or now < d.tend]

    def target_svcids(self, columns_fn) -> dict[int, set]:
        """→ {host_id: {svc_glob_id, ...}} that should be capturing.

        ``columns_fn('svcinfo') -> (cols, mask)`` supplies the listener
        inventory (svcid hex + hostid columns)."""
        out: dict[int, set] = {}
        defs = self._active_defs()
        if not defs:
            self._nsvc = {}
            return out
        cols, base = columns_fn("svcinfo")
        if not len(base):
            self._nsvc = {d.name: 0 for d in defs}
            return out
        for d in defs:
            mask = np.asarray(base, bool)
            tree = self._trees.get(d.name)
            if tree is not None:
                mask = mask & criteria.evaluate(tree, cols, "svcinfo")
            idx = np.nonzero(mask)[0]
            self._nsvc[d.name] = len(idx)
            for i in idx:
                hid = int(cols["hostid"][i])
                out.setdefault(hid, set()).add(
                    int(cols["svcid"][i], 16))
        return out

    def diff_for_hosts(self, targets: dict[int, set], hosts=None):
        """→ {host_id: (enable_ids, disable_ids)} vs the applied state;
        updates the applied state. Hosts with no change are absent.

        ``hosts`` restricts the diff to reachable hosts — state for an
        unreachable host must NOT be committed (its diff would be lost;
        the caller resyncs it on reconnect via ``forget_host``)."""
        out = {}
        cand = set(targets) | set(self._applied)
        if hosts is not None:
            cand &= set(hosts)
        for hid in cand:
            want = targets.get(hid, set())
            have = self._applied.get(hid, set())
            en = sorted(want - have)
            dis = sorted(have - want)
            if en or dis:
                out[hid] = (en, dis)
            if want:
                self._applied[hid] = want
            else:
                self._applied.pop(hid, None)
        return out

    def forget_host(self, host_id: int) -> None:
        """Reconnect resync: drop applied state so the next diff
        re-pushes everything (agents lose capture state on restart)."""
        self._applied.pop(host_id, None)

    def unapply(self, host_id: int, enable, disable) -> None:
        """Reverse a committed diff after its push FAILED: the agent
        never saw it, so its state is still the pre-diff one. Restoring
        that (applied − enables + disables) makes the next tick re-emit
        the same diff — including disables, which ``forget_host`` alone
        can never re-send (a host absent from both targets and applied
        produces no diff at all)."""
        have = (self._applied.get(host_id, set())
                - set(enable)) | set(disable)
        if have:
            self._applied[host_id] = have
        else:
            self._applied.pop(host_id, None)

    def columns(self):
        """(cols, mask) for the tracedef/tracestatus subsystems —
        shared by both runtimes so the column set cannot diverge."""
        rows = self.status_rows()

        def obj(k):
            out = np.empty(len(rows), object)
            out[:] = [r[k] for r in rows]
            return out

        cols = {"name": obj("name"), "filter": obj("filter"),
                "tend": np.array([float(r["tend"]) for r in rows]),
                "active": np.array([r["active"] for r in rows], bool),
                "nsvc": np.array([float(r["nsvc"]) for r in rows])}
        return cols, np.ones(len(rows), bool)

    def status_rows(self) -> list[dict]:
        now = self._clock()
        rows = []
        for d in sorted(self.defs.values(), key=lambda x: x.name):
            active = d.tend <= 0 or now < d.tend
            rows.append({"name": d.name, "filter": d.filter or "",
                         "tend": min(d.tend, 1e18), "active": active,
                         # per-def match count from the last evaluation
                         "nsvc": self._nsvc.get(d.name, 0)
                         if active else 0})
        return rows
