"""The port's alert tier against the reference's: the alert manager, its
definitions and query columns, webhook delivery, the CRUD channel and
the continuous-query engine alertdefs evaluate through.

- ``AlertManager``: eight ticks of seeded columns of four subsystems
  through both packages' managers with the same clock — pending →
  firing → resolved under ``numcheckfor``, ``repeataftersec``,
  group-wait batches, an alertname silence with a time window and a
  filter silence, an inhibit, two defs sharing one canonical filter
  (one predicate pass), a disabled def, a windowed def (skipped and
  counted without history shards) and a db-mode def (never evaluated by
  ``check``; ``check_db`` over both packages' history stores).
  Each tick's notified alerts, stats, firing set and the five alert
  subsystems' columns match exactly.
- Definition parsing and its errors, ``parse_dur``.
- ``deliver``: payload shapes of every action type, and the
  dispatcher posting to a local HTTP handler (retry after a failure,
  drain, close joining its thread); the manager routing a fired group
  to a webhook action.
- ``query/crud.crud`` over both packages' registries.
- ``query/delta`` and ``query/cq``: events, their application, the
  membership lifecycle and grouping keys over a seeded response series.

Every wait is bounded and every thread is joined in teardown.
"""

import http.server
import json
import threading
import time

import numpy as np
import pytest

from gyeeta_tpu.alerts import columns as j_ac, defs as j_defs
from gyeeta_tpu.alerts import deliver as j_dl
from gyeeta_tpu.alerts.manager import AlertManager as JMgr
from gyeeta_tpu.history.store import HistoryStore as JStore
from gyeeta_tpu.history.timeview import parse_dur as j_parse_dur
from gyeeta_tpu.query import cq as j_cq, crud as j_crud, delta as j_delta
from gyeeta_tpu.trace.defs import TraceDefs as JTraceDefs
from gyeeta_tpu.utils.notifylog import NotifyLog as JNotifyLog
from gyeeta_tpu.utils.tagreg import TagRegistry as JTags
from gyeeta_tpu_torch.alerts import columns as t_ac, defs as t_defs
from gyeeta_tpu_torch.alerts import deliver as t_dl
from gyeeta_tpu_torch.alerts.manager import AlertManager as TMgr
from gyeeta_tpu_torch.history.store import HistoryStore as TStore
from gyeeta_tpu_torch.query import cq as t_cq, crud as t_crud, \
    delta as t_delta
from gyeeta_tpu_torch.trace.defs import TraceDefs as TTraceDefs
from gyeeta_tpu_torch.utils.notifylog import NotifyLog as TNotifyLog
from gyeeta_tpu_torch.utils.tagreg import TagRegistry as TTags

N_TICKS = 8
N_SVC, N_HOST, N_TASK = 12, 5, 9

DEFS = [
    {"alertname": "svc_busy", "subsys": "svcstate",
     "filter": "{ svcstate.qps5s > 50 }", "numcheckfor": 2,
     "repeataftersec": 12},
    {"alertname": "svc_busy_crit", "subsys": "svcstate",
     "filter": "{svcstate.qps5s>50.0}", "severity": "critical",
     "actions": "log"},
    {"alertname": "svc_bad", "subsys": "svcstate",
     "filter": "{ svcstate.state in 'Bad','Severe' }",
     "groupwaitsec": 11},
    {"alertname": "host_issue", "subsys": "hoststate",
     "filter": "{ hoststate.nprocissue > 1 }",
     "labels": {"team": "infra"}, "annotations": {"summary": "procs"}},
    {"alertname": "cpu_hot", "subsys": "cpumem",
     "filter": "{ cpumem.cpu > 70 }", "severity": "info"},
    {"alertname": "task_hot", "subsys": "taskstate",
     "filter": "{ taskstate.cpu > 30 }", "enabled": False},
    {"alertname": "svc_busy_15m", "subsys": "svcstate",
     "filter": "{ svcstate.qps5s > 10 }", "window": "15m"},
    {"alertname": "svc_db", "subsys": "svcstate",
     "filter": "{ svcstate.qps5s > 10 }", "mode": "db", "querysec": 60},
]
SILENCES = [{"name": "quiet_cpu", "alertnames": ["cpu_hot"],
             "tstart": 1010.0, "tend": 1025.0},
            {"name": "quiet_host1", "filter": "{ svcstate.hostid = 1 }"}]
INHIBITS = [{"name": "host_over_busy", "src_alertnames": ["host_issue"],
             "target_alertnames": ["svc_busy"]}]


def _columns(tick):
    """Seeded columns of the four subsystems the defs target."""
    r = np.random.default_rng(100 + tick)
    hexid = lambda n, s: np.array(  # noqa: E731
        [format((i + 1) * s & (2**64 - 1), "016x") for i in range(n)],
        object)
    return {
        "svcstate": ({"svcid": hexid(N_SVC, 0x9E3779B97F4A7C15),
                      "qps5s": r.integers(0, 100, N_SVC).astype(float),
                      "state": r.integers(0, 6, N_SVC).astype(np.int32),
                      "hostid": (np.arange(N_SVC) % N_HOST).astype(float)},
                     np.arange(N_SVC) != 7),
        "hoststate": ({"hostid": np.arange(N_HOST, dtype=float),
                       "nprocissue": r.integers(0, 4, N_HOST).astype(float),
                       "state": r.integers(0, 6, N_HOST).astype(np.int32)},
                      np.ones(N_HOST, bool)),
        "cpumem": ({"hostid": np.arange(N_HOST, dtype=float),
                    "cpu": r.uniform(0, 100, N_HOST)},
                   np.ones(N_HOST, bool)),
        "taskstate": ({"taskid": hexid(N_TASK, 0xBF58476D1CE4E5B9),
                       "cpu": r.uniform(0, 60, N_TASK),
                       "hostid": (np.arange(N_TASK) % N_HOST
                                  ).astype(float)},
                      np.ones(N_TASK, bool)),
    }


def _columns_fn(cols):
    def fn(subsys):
        if "@" in subsys:
            raise ValueError("windowed alertdef needs history shards "
                             "(hist_shard_dir)")
        return cols[subsys]
    return fn


def assert_cols_equal(ref, got, what=""):
    (rc, rm), (gc, gm) = ref, got
    np.testing.assert_array_equal(gm, rm, err_msg=f"{what} mask")
    assert list(gc) == list(rc), what
    for k in rc:
        a, b = np.asarray(rc[k]), np.asarray(gc[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{k}")


def _alert_cols(ac, mgr, now):
    return {"alerts": ac.alerts_columns(mgr),
            "alertdef": ac.alertdef_columns(mgr),
            "silences": ac.silences_columns(mgr, now=now),
            "inhibits": ac.inhibits_columns(mgr),
            "actions": ac.actions_columns(mgr)}


@pytest.fixture(scope="module")
def lifecycle():
    """Both managers through N_TICKS checks → per-tick observations."""
    now = [1000.0]
    clock = lambda: now[0]  # noqa: E731
    mgrs = {"ref": JMgr(None, clock=clock), "port": TMgr(None, clock=clock)}
    seen = {k: [] for k in mgrs}
    for m in mgrs.values():
        for d in DEFS:
            m.add_def(dict(d))
        for s in SILENCES:
            m.add_silence(dict(s))
        for i in INHIBITS:
            m.add_inhibit(dict(i))
    ac = {"ref": j_ac, "port": t_ac}
    for tick in range(N_TICKS):
        now[0] += 5.0
        cols = _columns(tick)
        for side, m in mgrs.items():
            if tick == 5:
                m.delete_def("svc_bad")
            fired = m.check(None, columns_fn=_columns_fn(cols))
            seen[side].append({
                "fired": [tuple(a) for a in fired],
                "stats": dict(m.stats),
                "firing": sorted(m.firing()),
                "state": dict(m._state),
                "log": [tuple(a) for a in m.alert_log],
                "cols": _alert_cols(ac[side], m, now[0]),
                "wants": (m.wants_realtime(), m.wants_db(),
                          m.pending_groups())})
    return mgrs, seen


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_alert_check_matches_reference(lifecycle, tick):
    _, seen = lifecycle
    ref, got = seen["ref"][tick], seen["port"][tick]
    for k in ("fired", "stats", "firing", "state", "log", "wants"):
        assert got[k] == ref[k], k
    for name in ref["cols"]:
        assert_cols_equal(ref["cols"][name], got["cols"][name],
                          f"{name}@{tick}")


def test_alert_lifecycle_reaches_every_path(lifecycle):
    """Pending, firing, resolved, silenced, inhibited, grouped and
    windowed-skipped all happened; the shared filter costs one pass."""
    mgrs, seen = lifecycle
    s = seen["port"][-1]["stats"]
    for k in ("nfired", "nsilenced", "ninhibited", "nresolved",
              "ngroups_flushed", "nwindow_skipped"):
        assert s[k] > 0, k
    assert s["nchecks"] == N_TICKS and s["ndbchecks"] == 0
    # 4 realtime groups a check (svc_busy + svc_busy_crit share one;
    # svc_bad until its delete at tick 5; the windowed def skips)
    assert s["ncq_group_evals"] == 5 * 4 + 3 * 3
    assert s["nwindow_skipped"] == N_TICKS


def test_db_mode_def_check_db_matches_reference():
    """A db-mode def is never evaluated by ``check``; ``check_db``
    evaluates it over a history store's rows every ``querysec``, as the
    reference's does: the same alerts, firing set and stats."""
    seen = {}
    for side, mgr_cls, store_cls in (("ref", JMgr, JStore),
                                     ("port", TMgr, TStore)):
        now = [1000.0]
        m = mgr_cls(None, clock=lambda: now[0])
        m.add_def(dict(DEFS[-1]))
        assert m.wants_db() and not m.wants_realtime()
        assert m.check(None, columns_fn=_columns_fn(_columns(0))) == []
        assert m.stats["ncq_group_evals"] == 0
        hs = store_cls(":memory:")
        out = []
        for tick in range(4):
            cols, live = _columns(tick)["svcstate"]
            hs.write("svcstate", now[0] - 1.0, [
                {"svcid": cols["svcid"][i], "qps5s": cols["qps5s"][i],
                 "hostid": cols["hostid"][i]}
                for i in np.nonzero(live)[0]])
            out.append([tuple(a) for a in m.check_db(hs)])
            now[0] += 40.0
        seen[side] = (out, dict(m.stats), sorted(m.firing()))
        hs.db.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"][1]["ndbchecks"] == 2 and any(seen["port"][0])


@pytest.mark.parametrize("v", [900, "900", "15m", "2h", "1d", " 30S "])
def test_parse_dur_matches_reference(v):
    assert t_defs.parse_dur(v) == j_parse_dur(v)


@pytest.mark.parametrize("bad", [
    {"subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }"},
    {"alertname": "a", "subsys": "nosuch", "filter": "{ x.y > 1 }"},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ hoststate.x > 1 }"},
    {"alertname": "a", "subsys": "svcstate",
     "filter": "{ hoststate.nprocissue > 1 }"},
    {"alertname": "a", "subsys": "svcstate", "filter": ""},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }",
     "severity": "fatal"},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }",
     "mode": "batch"},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }",
     "window": "soon"},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }",
     "window": "-5m"},
    {"alertname": "a", "subsys": "svcstate", "filter": "{ svcstate.qps5s > 1 }",
     "window": "5m", "mode": "db"},
])
def test_alertdef_errors_match_reference(bad):
    with pytest.raises(Exception) as ref:
        j_defs.AlertDef.from_json(dict(bad))
    with pytest.raises(Exception) as got:
        t_defs.AlertDef.from_json(dict(bad))
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("d", DEFS + SILENCES + INHIBITS,
                         ids=lambda d: d.get("alertname", d.get("name")))
def test_definitions_parse_like_reference(d):
    if "alertname" in d:
        ref, got = j_defs.AlertDef.from_json(d), t_defs.AlertDef.from_json(d)
    elif "src_alertnames" in d:
        ref, got = j_defs.Inhibit.from_json(d), t_defs.Inhibit.from_json(d)
    else:
        ref, got = j_defs.Silence.from_json(d), t_defs.Silence.from_json(d)
    assert tuple(got) == tuple(ref)


# --------------------------------------------------------- delivery
class _Hook(http.server.BaseHTTPRequestHandler):
    received: list = []
    fail_first: int = 0

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        cls = type(self)
        if cls.fail_first > 0:
            cls.fail_first -= 1
            self.send_response(500)
            self.end_headers()
            return
        cls.received.append((self.path, json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture()
def hook_server(monkeypatch):
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    _Hook.received = []
    _Hook.fail_first = 0
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5.0)


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _group(pkg_mgr):
    from gyeeta_tpu.alerts.manager import Alert as JA
    from gyeeta_tpu_torch.alerts.manager import Alert as TA
    cls = JA if pkg_mgr == "ref" else TA
    return [cls(alertname="svc_busy", severity="critical",
                subsys="svcstate", entity=f"svcid={i:016x}",
                tfired=1000.0 + i, labels={"team": "a"},
                annotations={"s": "x"},
                row={"qps5s": 60.0 + i, "obj": None, "arr": (1, 2)})
            for i in range(20)]


@pytest.mark.parametrize("atype", t_dl.ACTION_TYPES)
@pytest.mark.parametrize("template", ["", "{alertname}: {nalerts}",
                                      "{nosuch}"])
def test_payload_matches_reference(atype, template):
    d = {"name": "a", "type": atype, "url": "http://127.0.0.1:1/x",
         "template": template}
    ref = j_dl.build_payload(j_dl.ActionConfig.from_json(d),
                             _group("ref"))
    got = t_dl.build_payload(t_dl.ActionConfig.from_json(d),
                             _group("port"))
    assert got == ref


@pytest.mark.parametrize("bad", [{"name": "a", "url": "http://x",
                                  "type": "fax"}, {"name": "a"}])
def test_action_config_errors_match_reference(bad):
    with pytest.raises(ValueError) as ref:
        j_dl.ActionConfig.from_json(bad)
    with pytest.raises(ValueError) as got:
        t_dl.ActionConfig.from_json(bad)
    assert str(got.value) == str(ref.value)


def test_dispatcher_posts_like_reference(hook_server):
    """Both dispatchers post the same body to a local handler; the
    first POST of each fails and is retried."""
    out = {}
    for side, dl in (("ref", j_dl), ("port", t_dl)):
        _Hook.received = []
        _Hook.fail_first = 1
        disp = dl.ActionDispatcher()
        try:
            cfg = dl.ActionConfig(f"{side}_hook", url=f"{hook_server}/{side}",
                                  backoff_s=0.01, timeout_s=2.0)
            disp.enqueue(cfg, _group(side))
            disp.enqueue(cfg, _group(side)[:3])
            assert disp.drain(timeout=10.0)
            out[side] = (list(_Hook.received), dict(disp.stats))
        finally:
            disp.close()
        assert disp._thread is None
    (rr, rs), (gr, gs) = out["ref"], out["port"]
    assert [b for _, b in gr] == [b for _, b in rr] and len(gr) == 2
    assert [p for p, _ in gr] == ["/port"] * 2
    assert gs == rs == {"delivered": 2, "failed": 0, "retries": 1,
                        "dropped": 0}


def test_manager_routes_to_webhook_and_closes(hook_server):
    now = [10.0]
    m = TMgr(None, clock=lambda: now[0])
    try:
        m.add_action({"name": "hook", "type": "webhook",
                      "url": hook_server + "/alerts", "timeout_s": 2.0})
        m.add_def({"alertname": "busy", "subsys": "svcstate",
                   "filter": "{ svcstate.qps5s > 50 }",
                   "actions": ["hook", "log"]})
        fired = m.check(None, columns_fn=_columns_fn(_columns(0)))
        assert fired and _wait(lambda: len(_Hook.received) == 1)
        path, body = _Hook.received[0]
        assert path == "/alerts" and body["status"] == "firing"
        assert body["groupSummary"]["nalerts"] == len(fired)
        assert len(m.alert_log) == len(fired)
        cols, _ = t_ac.actions_columns(m)
        assert list(cols["name"]) == ["hook", "log"]
        assert list(cols["target"]) == [hook_server + "/…", ""]
        assert not m.delete_action("log") and m.delete_action("hook")
    finally:
        m.close()
    assert m._dispatcher is None


# --------------------------------------------------------------- CRUD
class _Rt:
    def __init__(self, mgr, tags, tdefs, log):
        self.alerts, self.tags, self.tracedefs, self.notifylog = \
            mgr, tags, tdefs, log


CRUD_REQS = [
    {"op": "add", "objtype": "alertdef", **DEFS[0]},
    {"op": "add", "objtype": "alertdef", **DEFS[3]},
    {"op": "add", "objtype": "silence", **SILENCES[0]},
    {"op": "add", "objtype": "inhibit", **INHIBITS[0]},
    {"op": "add", "objtype": "action", "name": "hook",
     "url": "http://127.0.0.1:9/x"},
    {"op": "add", "objtype": "tag", "taskid": "00000000000000AB",
     "tag": "web"},
    {"op": "add", "objtype": "tracedef", "name": "td",
     "filter": "{ svcinfo.port > 1 }"},
    {"op": "delete", "objtype": "alertdef", "alertname": "svc_busy"},
    {"op": "delete", "objtype": "silence", "name": "quiet_cpu"},
    {"op": "delete", "objtype": "silence", "name": "quiet_cpu"},
    {"op": "delete", "objtype": "inhibit", "name": "host_over_busy"},
    {"op": "delete", "objtype": "action", "name": "hook"},
    {"op": "delete", "objtype": "tag", "taskid": "00000000000000ab"},
    {"op": "delete", "objtype": "tracedef", "name": "td"},
    {"op": "delete", "objtype": "tracedef"},
    {"op": "add", "objtype": "widget"},
    {"op": "update", "objtype": "tag"},
    {"op": "add", "objtype": "action", "name": "log",
     "url": "http://127.0.0.1:9/x"},
]


def test_crud_replies_match_reference():
    now = [3.0]
    clock = lambda: now[0]  # noqa: E731
    rts = {"ref": _Rt(JMgr(None, clock=clock), JTags(),
                      JTraceDefs(clock=clock), JNotifyLog(clock=clock)),
           "port": _Rt(TMgr(None, clock=clock), TTags(),
                       TTraceDefs(clock=clock), TNotifyLog(clock=clock))}
    outs = {k: [] for k in rts}
    for req in CRUD_REQS:
        now[0] += 1.0
        for side, crud in (("ref", j_crud.crud), ("port", t_crud.crud)):
            try:
                outs[side].append(crud(rts[side], dict(req)))
            except Exception as e:
                outs[side].append((type(e).__name__, str(e)))
    assert outs["port"] == outs["ref"]
    assert sum(isinstance(o, tuple) for o in outs["port"]) == 4
    assert_cols_equal(rts["ref"].notifylog.columns(),
                      rts["port"].notifylog.columns(), "notifymsg")
    assert t_crud.CRUD_OBJS == j_crud.CRUD_OBJS
    for rt in rts.values():
        rt.alerts.close()


# ------------------------------------------------ continuous queries
STATES = ("Idle", "Good", "OK", "Bad", "Severe", "Down")


def _responses(n_ticks=6, n=10):
    """A seeded series of svcstate-like responses: rows come and go,
    values move, order follows a sort column."""
    r = np.random.default_rng(7)
    out = []
    for t in range(n_ticks):
        ids = sorted(r.choice(n + 4, n, replace=False).tolist())
        rows = [{"svcid": format(i, "016x"), "qps5s": float(r.integers(
            0, 90)), "state": STATES[int(r.integers(0, 6))],
            "hostid": float(i % 3)} for i in ids]
        rows.sort(key=lambda x: x["qps5s"], reverse=True)
        out.append({"recs": rows, "nrecs": len(rows), "snaptick": t})
    return out


def test_delta_events_match_reference():
    resps = _responses()
    prev_t = prev_j = None
    for curr in resps:
        ref = j_delta.compute_event(prev_j, curr)
        got = t_delta.compute_event(prev_t, curr)
        assert got == ref
        prev_j = j_delta.apply_event(prev_j, ref[0])
        prev_t = t_delta.apply_event(prev_t, got[0])
        assert json.dumps(prev_t) == json.dumps(prev_j) == json.dumps(curr)
    assert t_delta.full_event(resps[0]) == j_delta.full_event(resps[0])
    assert t_delta.ack_event(3) == j_delta.ack_event(3)
    with pytest.raises(t_delta.ResyncRequired):
        t_delta.apply_event(None, {"t": "delta", "snaptick": 1, "base": 0})


@pytest.mark.parametrize("filt", ["{ svcstate.qps5s > 40 }",
                                  "{ svcstate.state in 'Bad','Severe' }",
                                  "( { svcstate.qps5s > 10 } and not "
                                  "{ svcstate.hostid = 1 } )"])
def test_cq_membership_matches_reference(filt):
    sub = "svcstate"
    jf, jt = j_cq.parse_standing(sub, filt)
    tf, tt = t_cq.parse_standing(sub, filt)
    assert tf == jf
    assert t_cq.group_key(sub, filt) == j_cq.group_key(sub, filt)
    assert t_cq.panel_kf(sub) == j_cq.panel_kf(sub)
    jm, tm = j_cq.Membership(sub, jf, jt), t_cq.Membership(sub, tf, tt)
    jprev, tprev = {}, {}
    for tick, resp in enumerate(_responses()):
        kf = t_cq.panel_kf(sub)
        rows = resp["recs"]
        tcur = {t_cq.row_key(r, kf): r for r in rows}
        jcur = {j_cq.row_key(r, kf): r for r in rows}
        assert tcur == jcur
        tdiff, jdiff = t_cq.panel_diff(tprev, tcur), \
            j_cq.panel_diff(jprev, jcur)
        assert tdiff == jdiff
        tcols = t_cq.columns_of_rows(sub, tdiff[1])
        jcols = j_cq.columns_of_rows(sub, jdiff[1])
        assert list(tcols) == list(jcols)
        for k in tcols:
            np.testing.assert_array_equal(tcols[k], jcols[k])
        tmatch = t_cq.match_mask(tt, sub, tdiff[1], tcols)
        jmatch = j_cq.match_mask(jt, sub, jdiff[1])
        np.testing.assert_array_equal(tmatch, jmatch)
        base = tm.snaptick
        got = t_cq.advance(tm, tdiff[0], tdiff[1], tmatch, tdiff[2], tick)
        ref = j_cq.advance(jm, jdiff[0], jdiff[1], jmatch, jdiff[2], tick)
        assert got == ref
        assert t_cq.events_of(base, tick, kf, *got) == \
            j_cq.events_of(base, tick, kf, *ref)
        assert t_cq.response_of(tm) == j_cq.response_of(jm)
        tprev, jprev = tcur, jcur
    resp = t_cq.response_of(tm)
    assert t_cq.members_of_response(resp) == j_cq.members_of_response(resp)
    full = {k: v for k, v in list(tcur.items())[:3]}
    assert t_cq.rebuild(tm, full, 9) == j_cq.rebuild(jm, full, 9)
    assert t_cq.advance_entities({1, 2}, {2, 3}) == \
        j_cq.advance_entities({1, 2}, {2, 3})


@pytest.mark.parametrize("sub,filt", [("svcstate", ""),
                                      ("nosuch", "{ x.y > 1 }"),
                                      ("svcstate", "{ hoststate.state = 1 }")])
def test_cq_standing_errors_match_reference(sub, filt):
    with pytest.raises(Exception) as ref:
        j_cq.parse_standing(sub, filt)
    with pytest.raises(Exception) as got:
        t_cq.parse_standing(sub, filt)
    assert str(got.value) == str(ref.value)
