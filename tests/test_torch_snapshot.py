"""The port's snapshot tier, ``selfstats``, ``metrics`` and
``multiquery`` against the reference's, and the snapshot's isolation.

Against the reference, over ``tests/test_torch_delta_fold.py``'s
delta-fed four-tick run (:func:`run_delta_both`, shared per process):
the snapshot-served JSON of every served subsystem after every tick,
``multiquery`` batches (bad, nested and CRUD sub-queries included), and
the ``selfstats`` and ``metrics`` payloads. ``selfstats_response`` and
``prom.render`` are held equal on equal ``Stats`` (the clock pinned);
at the runtime level the payloads compare on everything but what only
the reference has (its native decoder's counters and gauge) and stage
times, which are wall-clock readings: the alert manager's section and
``gyt_alerts_*`` lines and the drop-pressure counters included.

Port only: a published snapshot does not change under later feeds; it
is republished on ``restore``; its result cache, bootstrap publish,
freshness gauges and refusals.
"""

import time

import numpy as np
import pytest
import torch

from gyeeta_tpu.alerts import AlertManager as JAlerts
from gyeeta_tpu.obs import prom as j_prom
from gyeeta_tpu.obs.spans import SpanTracer as JSpans
from gyeeta_tpu.query import crud as j_crud, normalize as j_norm
from gyeeta_tpu.utils import selfstats as j_ss
from gyeeta_tpu_torch.alerts import AlertManager as TAlerts
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.obs import prom as t_prom
from gyeeta_tpu_torch.obs.spans import SpanTracer as TSpans
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.query import api as t_api, crud as t_crud, \
    snapshot as t_snap
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import edgefold as t_ef
from gyeeta_tpu_torch.utils import selfstats as t_ss
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.tensor import tree_leaves
from test_torch_delta_fold import N_TICKS, OPTS, SIM_KW, run_delta_both, \
    t_cfg
from test_torch_runtime import SERVED, assert_json_equal

# counters and gauges only the reference keeps: none (its native
# decoder's are the port's too)
REF_ONLY_COUNTERS: set = set()


def _ref_only(name: str) -> bool:
    return name in REF_ONLY_COUNTERS


@pytest.fixture(scope="module")
def runs():
    return run_delta_both()


# --------------------------------------------------- snapshot-served JSON
@pytest.mark.parametrize("subsys", SERVED)
def test_snapshot_json_matches_reference_every_tick(runs, subsys):
    for tick in range(N_TICKS):
        ref = runs["j_ticks"][tick]["snap"][subsys]
        got = runs["t_ticks"][tick]["snap"][subsys]
        assert got["snaptick"] == tick
        assert_json_equal(ref, got, f"{subsys}@{tick}")


MULTI = [
    {"subsys": "svcstate", "maxrecs": 5, "sortcol": "qps5s"},
    {"subsys": "hoststate", "consistency": "snapshot"},
    {"subsys": "topk", "consistency": "snapshot", "maxrecs": 8},
    {"subsys": "svcstate", "filter": "{ svcstate.qps5s > 0 }",
     "consistency": "strong"},
    {"subsys": "bogus"},
    {"subsys": "svcstate", "filter": "{ svcstate.nosuch > 1 }"},
    {"subsys": "svcstate", "consistency": "eventual"},
    {"multiquery": [{"subsys": "svcstate"}]},
    {"op": "add", "subsys": "alertdef"},
    "svcstate",
    {"subsys": "clusterstate"},
    {"subsys": "svcdependency", "consistency": "snapshot"},
    {"subsys": "traceuniq"},
    {"subsys": "hostlist", "consistency": "snapshot"},
    {"subsys": "svcsumm"},
    {"subsys": "flowstate", "maxrecs": 3},
]


def test_multiquery_matches_reference(runs):
    assert len(MULTI) == 16
    req = {"multiquery": MULTI}
    ref, got = runs["jr"].query(req), runs["tr"].query(req)
    assert got["nqueries"] == 16
    assert sum("error" in r for r in got["multiquery"]) == 6
    assert_json_equal(ref, got, "multiquery")


@pytest.mark.parametrize("bad", [{"multiquery": [{}] * 17},
                                 {"multiquery": {"subsys": "svcstate"}}])
def test_multiquery_envelope_refused_like_reference(runs, bad):
    with pytest.raises(ValueError) as ref:
        runs["jr"].query(bad)
    with pytest.raises(ValueError) as got:
        runs["tr"].query(bad)
    assert str(got.value) == str(ref.value)


def test_crud_multiquery_matches_reference():
    calls = []

    def fn(sub):
        calls.append(sub)
        if sub.get("subsys") == "boom":
            raise KeyError("boom")
        return {"n": len(calls)}

    req = {"multiquery": [{"subsys": "a"}, {"subsys": "boom"}, 3,
                          {"op": "x"}, {"subsys": "b"}]}
    got = t_crud.multiquery(fn, req)
    calls.clear()
    assert got == j_crud.multiquery(fn, req)


# ---------------------------------------------- selfstats and metrics
def _fill(stats, spans=None):
    """The same bumps, gauges and timings into a registry of either
    package (rank-boundary timing counts included)."""
    for name, n in (("conn_events", 12345), ("queries", 3),
                    ("nm_queries|verb=svcstate", 4),
                    ("nm_queries|verb=hostlist", 1), ("weird-name.x", 2)):
        stats.bump(name, n)
    for name, v in (("tick", 7), ("engine_svc_live", 33.0),
                    ("snapshot_age_seconds", 0.25), ("inf_gauge", np.inf),
                    ("fold_rate|shard=0", 1.5e6)):
        stats.gauge(name, v)
    for ms in [0.005, 0.4, 0.4, 2.0] + [1.0] * 99 + [900.0]:
        stats.observe_ms("decode_fold", ms)
    stats.observe_ms("tick", 61.3)
    if spans is not None:
        for i in range(5):
            spans.record(("deframe", "decode_fold", "tick")[i % 3],
                         1.7e9 + i, 0.123456 * i, nrec=10 * i,
                         path="python")


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + 42.0)


def test_selfstats_response_matches_reference_on_equal_stats(pinned):
    ts, js = t_ss.Stats(), j_ss.Stats()
    ts.t_start = js.t_start = 1.7e9
    tsp, jsp = TSpans(capacity=4), JSpans(capacity=4)
    _fill(ts, tsp), _fill(js, jsp)
    tm, jm = TAlerts(None), JAlerts(None)
    for m in (tm, jm):
        m.stats["nfired"], m.stats["ncq_group_evals"] = 3, 7
    got = t_ss.selfstats_response(ts, tm, spans=tsp)
    ref = j_ss.selfstats_response(js, jm, spans=jsp)
    assert got == ref
    assert got["counters"]["uptime_sec"] == 42.0
    assert len(got["spans"]) == 4 and got["alerts"] == ref["alerts"]
    assert got["alerts"]["nfired"] == 3
    assert t_ss.selfstats_response(ts, None)["alerts"] == \
        j_ss.selfstats_response(js, None)["alerts"] == {}
    assert ts.delta() == js.delta() and ts.delta() == js.delta() == {}


def test_timing_rows_rank_semantics_match_reference():
    ts, js = t_ss.Stats(), j_ss.Stats()
    for n in (1, 2, 99, 100, 101):
        for s in (ts, js):
            for i in range(n):
                s.observe_ms(f"s{n}", 0.01 * 1.35 ** (i % 40))
    assert ts.timing_rows() == js.timing_rows()
    assert [t_ss.bucket_upper_ms(b) for b in range(64)] == \
        [j_ss.bucket_upper_ms(b) for b in range(64)]


def test_prom_render_matches_reference_on_equal_stats(pinned):
    ts, js = t_ss.Stats(), j_ss.Stats()
    ts.t_start = js.t_start = 1.7e9
    _fill(ts), _fill(js)
    got, ref = t_prom.render(ts), j_prom.render(js)
    assert got == ref
    tm, jm = TAlerts(None), JAlerts(None)
    for m in (tm, jm):
        m.stats["nsilenced"] = 4
    assert t_prom.render(ts, tm) == j_prom.render(js, jm)
    assert "gyt_alerts_nsilenced_total 4" in t_prom.render(ts, tm)
    assert 'gyt_nm_queries_total{verb="svcstate"} 4' in got
    assert 'gyt_stage_duration_seconds_count{stage="decode_fold"} 104' \
        in got
    assert t_prom.metrics_response(ts) == j_prom.metrics_response(js)
    assert t_prom.CONTENT_TYPE == j_prom.CONTENT_TYPE


def _prom_samples(text: str, families: set) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, val = line.rsplit(" ", 1)
        if name.split("{")[0] in families:
            out[name] = val
    return out


def test_runtime_selfstats_matches_reference(runs, pinned):
    """Counters equal but for the reference-only ones; the same timed
    stages (the port also times its host decode) and the same spans by
    name and record count; the alert managers' sections equal."""
    jr, tr = runs["jr"], runs["tr"]
    jr.stats.t_start = tr.stats.t_start = 1.7e9
    ref = jr.query({"subsys": "selfstats"})
    got = tr.query({"subsys": "selfstats", "consistency": "snapshot"})
    assert got["alerts"] == ref["alerts"]
    assert got["alerts"]["nchecks"] == N_TICKS
    rc = {k: v for k, v in ref["counters"].items() if not _ref_only(k)}
    assert got["counters"] == rc
    assert {r["stage"] for r in got["timings"]} - {"decode"} == \
        {r["stage"] for r in ref["timings"]}
    assert [(s["name"], s["nrec"]) for s in got["spans"]] == \
        [(s["name"], s["nrec"]) for s in ref["spans"]]
    assert {s["name"] for s in got["spans"]} == {"deframe", "decode_fold",
                                                 "tick"}


@pytest.mark.parametrize("consistency", ["strong", "snapshot"])
def test_runtime_metrics_match_reference(runs, consistency):
    """Every counter and gauge sample of the port's exposition equals
    the reference's, the alert manager's ``gyt_alerts_*`` lines too
    (stage histograms are wall-clock readings)."""
    jr, tr = runs["jr"], runs["tr"]
    req = {"subsys": "metrics", "consistency": consistency}
    ref, got = jr.query(req), tr.query(req)
    assert got["content_type"] == ref["content_type"]
    fam = {f"gyt_{k}_total" for k in tr.stats.counters} | \
        {f"gyt_{k}" for k in tr.stats.gauges if k != "snapshot_age_seconds"}
    fam = {f.split("|")[0] for f in fam}
    alert_fam = {f"gyt_alerts_{k}_total" for k in jr.alerts.stats}
    g, r = _prom_samples(got["text"], fam | alert_fam), \
        _prom_samples(ref["text"], fam | alert_fam)
    assert g and g == r
    assert alert_fam <= set(g) and len(alert_fam) == 9
    assert f"gyt_snapshot_tick {N_TICKS - 1}" in got["text"]


# ------------------------------------------------------- port only
def _delta_buf(sim, ef, n_conn=200, n_resp=300):
    return t_wire.encode_frames_chunked(
        t_wire.NOTIFY_SKETCH_DELTA,
        ef.fold_sweep(sim.conn_records(n_conn), sim.resp_records(n_resp)))


def _runtime(clock=None, **opts):
    rt = TRuntime(t_cfg(), TOpts(**OPTS, **opts), clock=clock, device="cpu")
    sim = TSim(**SIM_KW)
    ef = t_ef.EdgeFold(t_ef.params_of_cfg(t_cfg()), host_id=0)
    rt.feed(sim.name_frames() + sim.listener_frames() + _delta_buf(sim, ef))
    return rt, sim, ef


def _leaves(snap):
    return (t_agg.state_to_numpy(snap.state), t_dg.dep_to_numpy(snap.dep))


def test_snapshot_is_isolated_from_later_feeds():
    """A published snapshot is a copy: feeding after the publish moves
    the live state and the strong answer, never the snapshot's leaves or
    its (re-rendered) JSON."""
    rt, sim, ef = _runtime()
    rt.run_tick()
    snap = rt.snapshot
    req = {"subsys": "svcstate", "maxrecs": 1000}
    before = rt.query(dict(req, consistency="snapshot"))
    strong = rt.query(req)
    leaves = _leaves(snap)
    live = {t.data_ptr() for t in tree_leaves(rt.state)
            + tree_leaves(rt.dep)}
    assert not live & {t.data_ptr() for t in tree_leaves(snap.state)
                       + tree_leaves(snap.dep)}
    rt.feed(_delta_buf(sim, ef))
    rt.flush()
    assert rt.snapshot is snap
    for a, b in zip(leaves[0] + leaves[1], sum(_leaves(snap), [])):
        np.testing.assert_array_equal(a, b)
    snap.on_mutation()                # re-render from the frozen state
    assert snap.result_cache_len() == 0
    assert rt.query(dict(req, consistency="snapshot")) == before
    after = rt.query(req)
    assert after != strong
    assert float(rt.state.n_conn) > float(snap.state.n_conn)


def test_snapshot_republished_on_restore(tmp_path):
    rt, sim, ef = _runtime(checkpoint_dir=str(tmp_path),
                           checkpoint_every_ticks=1)
    rt.run_tick()
    rt.feed(_delta_buf(sim, ef))
    rt.run_tick()
    v = rt.snapshot.version
    assert v == 2
    rt.feed(_delta_buf(sim, ef))      # staged and folded, then restored
    rt.flush()
    extra = rt.restore(tmp_path / "gyt_ckpt_00000001.npz")
    assert extra["tick"] == 1
    assert rt.snapshot.version == v + 1 and rt.snapshot.tick == 1
    for a, b in zip(t_agg.state_to_numpy(rt.state),
                    t_agg.state_to_numpy(rt.snapshot.state)):
        np.testing.assert_array_equal(a, b)
    req = {"subsys": "svcstate", "maxrecs": 1000}
    got = rt.query(dict(req, consistency="snapshot"))
    assert got.pop("snaptick") == 1 and got == rt.query(req)
    # a runtime that never published does not start on restore
    bare = TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")
    bare.restore(tmp_path / "gyt_ckpt_00000001.npz")
    assert bare.snapshot is None
    assert "snapshots_published" not in bare.stats.counters


def test_snapshot_bootstraps_and_caches_results():
    rt, _, _ = _runtime()
    assert rt.snapshot is None
    req = {"subsys": "svcstate", "consistency": "snapshot",
           "filter": "{ svcstate.qps5s >= 0 }"}
    first = rt.query(req)
    assert rt.stats.counters["snapshots_published"] == 1
    assert first["snaptick"] == 0
    # a differently spelt equal request hits the result cache
    again = rt.query({"consistency": "snapshot", "maxrecs": "1000",
                      "filter": "{svcstate.qps5s >= 0.0}",
                      "subsys": "svcstate", "sortdesc": True})
    assert again is first
    c = rt.stats.counters
    assert (c["query_cache_misses"], c["query_cache_hits"]) == (1, 1)
    assert rt.snapshot.result_cache_len() == 1


@pytest.mark.parametrize("req", [
    {"subsys": "svcstate", "maxrecs": "7", "filter": "{ svcstate.x == 1 }",
     "consistency": "snapshot"},
    {"subsys": "svcstate", "aggr": "count(*)", "groupby": "hostid",
     "sortdesc": False},
    {"subsys": "hoststate", "columns": ["hostid"], "sortdesc": True,
     "filter": "( { a.b > 1 } and not { a.c = 'x' } )"},
    {"subsys": "topk", "filter": "{ unparseable", "none": None},
])
def test_request_key_matches_reference(req):
    assert t_snap.request_key(req) == j_norm.request_key(req)


def test_metrics_snapshot_path_reads_the_clock():
    now = [1000.0]
    rt, _, _ = _runtime(clock=lambda: now[0])
    rt.run_tick()
    now[0] = 1003.5
    text = rt.query({"subsys": "metrics",
                     "consistency": "snapshot"})["text"]
    assert "gyt_snapshot_age_seconds 3.5" in text
    assert "gyt_snapshots_published_total 1" in text
    strong = rt.query({"subsys": "metrics"})["text"]
    assert "gyt_engine_svc_rows_live" in strong


@pytest.mark.parametrize("k", ["tstart", "tend", "at", "window"])
def test_historical_snapshot_query_refused(k):
    """Without history shards a historical request on the snapshot path
    is refused as the reference refuses it (a ValueError naming the
    shards it needs)."""
    rt, _, _ = _runtime()
    with pytest.raises(ValueError, match="needs history shards") as e:
        rt.query({"subsys": "svcstate", k: 5, "consistency": "snapshot"})
    assert type(e.value) is ValueError


def test_publish_times_and_counts():
    rt, _, _ = _runtime()
    for _ in range(3):
        rt.run_tick()
    assert rt.stats.counters["snapshots_published"] == 3
    assert rt.stats.gauges["snapshot_tick"] == 2.0
    assert rt.stats.timing_totals()["snapshot_publish"][0] == 3
    assert rt.snapshot.version == 3
    assert rt.snapshot.state.n_conn.device.type == "cpu"
    assert torch.equal(rt.snapshot.state.n_conn, rt.state.n_conn)
