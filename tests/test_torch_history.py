"""History through the port against the reference: the write-ahead
journal feeding the compactor's replay, snapshot shards, ``at=``,
``window=`` and ``tstart``/``tend`` queries, the tick's history sweep,
db-mode and windowed alertdefs.

One seeded stream (``ParthaSim(8, 4, seed=7)``: names, then four ticks
of conn, resp, listener, task, host, cpu/mem and trace records) goes
through ``feed`` and ``run_tick`` into the reference ``Runtime`` and the
port's ``Runtime(device="cpu")`` at ``tests/test_timeview.py``'s
geometry, both with ``journal_dir``, ``hist_shard_dir``,
``history_db`` (sqlite), ``hist_window_ticks=2`` and
``history_every_ticks=1``, on one clock of 5 s a tick; then each
package's ``Compactor`` replays its own WAL into shards at ticks 2 and
4 (:func:`run_hist_both`, one run a process).

Held, on the CPU:
- the tick reports, ``history_rows`` included: equal;
- the port's shard at tick 4 against the port's live state at tick 4:
  85/85 ``AggState`` and 29/29 ``DepGraph`` leaves bit for bit; and
  against the reference compactor's shard: bit for bit but
  ``flow_topk.evicted``, a difference of two float32 sums held to the
  reference's own mass rule (:func:`_evicted_close`);
- ``at=tick:4`` JSON of the port: equal to the port's live JSON at
  tick 4, and to the reference's ``at=`` JSON (floats rtol 1e-6, the
  rule of ``tests/test_torch_runtime.py``); ``window=`` and
  ``tstart``/``tend`` JSON against the reference's likewise;
- shards cross packages: the port's ``TimeView`` serves the reference's
  shard directory with the reference's JSON, and the reverse;
- windowed quantiles against the offline exact merge (exact to JSON's
  rounding), the rejection counted ``windowed_quant_rejected``, delta
  panels through the npz and the raw → mid downsample, retention,
  restart resume, a SIGKILL mid-compaction;
- the history writer (bounded queue, barrier), ``check_db`` and the
  group-wait against the reference's manager, the Postgres store's
  server-less contract, and the refusal of the sharded layouts.
"""

import functools
import pathlib
import shutil
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from gyeeta_tpu.alerts import AlertManager as JMgr
from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.history import HistoryStore as JStore
from gyeeta_tpu.history import open_store as j_open_store
from gyeeta_tpu.history import timeview as j_tv, winquant as j_wq
from gyeeta_tpu.history.compactor import Compactor as JCompactor
from gyeeta_tpu.history.pgstore import PgHistoryStore as JPg
from gyeeta_tpu.history.shards import ShardStore as JShardStore
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.alerts import AlertManager as TMgr
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.history import HistoryStore as TStore
from gyeeta_tpu_torch.history import open_store as t_open_store
from gyeeta_tpu_torch.history import pgstore as t_pg
from gyeeta_tpu_torch.history import timeview as t_tv, winquant as t_wq
from gyeeta_tpu_torch.history.compactor import Compactor as TCompactor
from gyeeta_tpu_torch.history.histwriter import HistoryWriter
from gyeeta_tpu_torch.history.shards import ShardStore as TShardStore
from gyeeta_tpu_torch.history.shards import PartedShardStore, \
    open_shard_store
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.query.api import _hex_id
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_runtime import _leaf_check, assert_json_equal

torch.set_num_threads(1)

GEOM = dict(n_hosts=8, svc_capacity=64, task_capacity=64,
            conn_batch=128, resp_batch=256, fold_k=2)
SIM_KW = dict(n_hosts=8, n_svcs=4, seed=7)
N_TICKS = 4
T0 = 1.7e9
TICK_SECONDS = 5.0
OPTS = dict(hist_window_ticks=2, history_every_ticks=1,
            dep_pair_capacity=1024, dep_edge_capacity=512)


@pytest.fixture(autouse=True, scope="module")
def no_xla_disk_cache():
    """The reference's remedy in ``tests/test_journal.py``: this module
    builds several reference Runtimes of one geometry, and on this
    jaxlib line an executable reloaded from a persistent-cache entry
    that a concurrent worker just wrote can run wrong or crash. Compile
    in this process instead."""
    from jax._src import compilation_cache as jcc
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "")
    jcc.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", old or "")
    jcc.reset_cache()


def _opts(cls, tmp, **kw):
    tmp.mkdir(parents=True, exist_ok=True)
    base = dict(OPTS, journal_dir=str(tmp / "wal"),
                hist_shard_dir=str(tmp / "shards"),
                history_db=str(tmp / "h.db"))
    base.update(kw)
    return cls(**base)


def tick_bytes(sim, w, tick):
    """One tick's byte stream of one package's sim and wire."""
    return (sim.conn_frames(256) + sim.resp_frames(512)
            + sim.listener_frames() + sim.task_frames()
            + w.encode_frames_chunked(w.NOTIFY_HOST_STATE,
                                      sim.host_state_records())
            + w.encode_frames_chunked(w.NOTIFY_CPU_MEM_STATE,
                                      sim.cpu_mem_records(
                                          hot_cpu=[tick % 8]))
            + sim.trace_frames(128))


def tick_buffers(sim_cls, w):
    """Names, then the four ticks' byte streams of one package."""
    sim = sim_cls(**SIM_KW)
    names = sim.name_frames()
    return names, [tick_bytes(sim, w, t) for t in range(N_TICKS)]


def _t_leaves(rt):
    return t_agg.state_to_numpy(rt.state), t_dg.dep_to_numpy(rt.dep)


def _j_leaves(rt):
    return ([np.asarray(x) for x in jax.tree.leaves(rt.state)],
            [np.asarray(x) for x in jax.tree.leaves(rt.dep)])


# live requests whose JSON at tick 4 the at= queries must reproduce
LIVE_REQS = {
    "svcstate": {"subsys": "svcstate", "maxrecs": 100,
                 "sortcol": "qps5s"},
    "topk": {"subsys": "topk", "maxrecs": 50},
    "flowstate": {"subsys": "flowstate", "maxrecs": 200},
    "svcdependency": {"subsys": "svcdependency", "maxrecs": 500},
    "taskstate": {"subsys": "taskstate", "maxrecs": 200},
    "tracereq": {"subsys": "tracereq", "maxrecs": 200},
    "hoststate": {"subsys": "hoststate"},
    "cpumem": {"subsys": "cpumem"},
    "clusterstate": {"subsys": "clusterstate"},
    "svcsumm": {"subsys": "svcsumm"},
    "activeconn": {"subsys": "activeconn", "maxrecs": 200},
    "clientconn": {"subsys": "clientconn", "maxrecs": 200},
}


def _run(rt, names, bufs, now, pkg):
    """Feed and tick one runtime → (reports, leaf captures at the
    window boundaries, live JSON and leaves at the last tick)."""
    wq = t_wq if pkg == "port" else j_wq
    rt.feed(names)
    caps = {0: {n: wq.leaf_of(rt.state, n).astype(np.float32).copy()
                for n in wq.DELTA_SPECS}}
    reports = []
    for buf in bufs:
        rt.feed(buf, hid=3, conn_id=11)
        now[0] += TICK_SECONDS
        reports.append(rt.run_tick())
        if rt._tick_no % 2 == 0:
            caps[rt._tick_no] = {
                n: wq.leaf_of(rt.state, n).astype(np.float32).copy()
                for n in wq.DELTA_SPECS}
    live = {k: rt.query(dict(r)) for k, r in LIVE_REQS.items()}
    leaves = _t_leaves(rt) if pkg == "port" else _j_leaves(rt)
    return reports, caps, live, leaves


@functools.lru_cache(maxsize=None)
def run_hist_both():
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gyt_torch_hist_"))
    j_names, j_bufs = tick_buffers(JSim, j_wire)
    t_names, t_bufs = tick_buffers(TSim, t_wire)
    assert (j_names, j_bufs) == (t_names, t_bufs)
    j_now, t_now = [T0], [T0]
    jr = JRuntime(JCfg(**GEOM), _opts(JOpts, tmp / "ref"),
                  clock=lambda: j_now[0])
    tr = TRuntime(TCfg(**GEOM), _opts(TOpts, tmp / "port"),
                  clock=lambda: t_now[0], device="cpu")
    out = {"tmp": tmp, "jr": jr, "tr": tr, "j_now": j_now,
           "t_now": t_now}
    (out["j_rep"], out["j_caps"], out["j_live"],
     out["j_leaves"]) = _run(jr, j_names, j_bufs, j_now, "ref")
    (out["t_rep"], out["t_caps"], out["t_live"],
     out["t_leaves"]) = _run(tr, t_names, t_bufs, t_now, "port")
    jc = JCompactor(jr.cfg, jr.opts, journal=jr.journal, stats=jr.stats,
                    clock=lambda: j_now[0])
    tc = TCompactor(tr.cfg, tr.opts, journal=tr.journal, stats=tr.stats,
                    clock=lambda: t_now[0], device="cpu")
    out["j_comp"] = jc.compact_once(seal=True, upto_tick=jr._tick_no)
    out["t_comp"] = tc.compact_once(seal=True, upto_tick=tr._tick_no)
    out["jc"], out["tc"] = jc, tc
    return out


@pytest.fixture(scope="module")
def runs():
    out = run_hist_both()
    yield out
    # threads: journal writers, history writers, the replay runtimes
    for k in ("tc", "jc", "tr", "jr"):
        out[k].close()
    run_hist_both.cache_clear()
    shutil.rmtree(out["tmp"], ignore_errors=True)


def _shard(c, tick1, level="raw"):
    ent = [e for e in c.store.shards(level) if e["tick1"] == tick1][0]
    return ent, c.store.load(ent)


def _both(runs, req):
    """The same request through both runtimes → (reference, port)
    replies, or their ValueError messages."""
    def one(rt):
        try:
            return rt.query(dict(req))
        except ValueError as e:
            return ("ValueError", str(e))
    return one(runs["jr"]), one(runs["tr"])


# ------------------------------------------ request forms and options
FORMS = {
    "tstart": {"subsys": "svcstate", "tstart": T0 + 9.0},
    "tend": {"subsys": "svcstate", "tend": T0 + 11.0},
    "at": {"subsys": "svcstate", "at": "tick:2"},
    "window": {"subsys": "svcstate", "window": "6s"},
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_history_request_form_answers_like_reference(runs, form):
    """Each historical request form answers through ``query`` as the
    reference's does: ``tstart``/``tend`` from the relational store,
    ``at``/``window`` from the shards."""
    ref, got = _both(runs, FORMS[form])
    assert got["recs"] and "ValueError" not in got
    assert_json_equal(ref, got)


def _option_run(pkg, tmp, field):
    """A runtime with one history option set, fed two ticks of the
    stream → what that option makes observable."""
    Rt, Opts, Cfg, Sim, w = (
        (JRuntime, JOpts, JCfg, JSim, j_wire) if pkg == "ref"
        else (TRuntime, TOpts, TCfg, TSim, t_wire))
    tmp.mkdir(parents=True, exist_ok=True)
    path = {"history_db": tmp / "h.db", "journal_dir": tmp / "wal",
            "hist_shard_dir": tmp / "shards"}[field]
    extra = {"device": "cpu"} if pkg == "port" else {}
    rt = Rt(Cfg(**GEOM), Opts(**OPTS, **{field: str(path)}),
            clock=lambda: T0, **extra)
    try:
        sim = Sim(**SIM_KW)
        rt.feed(sim.name_frames())
        reps = []
        for t in range(2):
            rt.feed(tick_bytes(sim, w, t))
            reps.append(rt.run_tick())
        if field == "history_db":
            seen = rt.query({"subsys": "hoststate", "tstart": 0})
        elif field == "journal_dir":
            rt.journal.fsync()
            seen = [len(c) for _h, _t, _c, c in rt.journal.read_from()]
        else:
            with pytest.raises(ValueError) as e:
                rt.query({"subsys": "svcstate", "at": "tick:2"})
            seen = str(e.value)
        return reps, seen
    finally:
        rt.close()


@pytest.mark.parametrize("field", ["history_db", "journal_dir",
                                   "hist_shard_dir"])
def test_history_option_builds_working_runtime(tmp_path, field):
    """``RuntimeOpts`` with one history option builds a port runtime
    that behaves as the reference's with the same option."""
    ref = _option_run("ref", tmp_path / "ref", field)
    got = _option_run("port", tmp_path / "port", field)
    assert got[0] == ref[0]
    if field == "history_db":
        assert got[0][0]["history_rows"] > 0
        assert_json_equal(ref[1], got[1])
    else:
        assert got[1] == ref[1] and got[1]


# ------------------------------------------------------------ the run
@pytest.mark.parametrize("tick", range(N_TICKS))
def test_tick_report_with_history_matches_reference(runs, tick):
    ref, got = runs["j_rep"][tick], runs["t_rep"][tick]
    assert got == ref
    assert got["history_rows"] > 0 and got["tick"] == tick + 1


def test_compaction_report_matches_reference(runs):
    ref, got = runs["j_comp"], runs["t_comp"]
    assert got["windows"] == ref["windows"] == 2
    for k in ("chunks", "records", "tick", "retention_dropped"):
        assert got[k] == ref[k], k
    assert got["records"] > 0
    for k in ("compact_shards", "compact_passes", "wal_appended_chunks",
              "history_write_sweeps", "history_write_rows"):
        assert runs["tr"].stats.counters[k] \
            == runs["jr"].stats.counters[k], k
    assert "compact_replay_ev_per_sec" in runs["tr"].stats.gauges


def test_shard_listing_matches_reference(runs):
    ref = runs["jc"].store.shards()
    got = runs["tc"].store.shards()
    assert [{k: e[k] for k in ("file", "level", "tick0", "tick1", "t0",
                               "t1")} for e in got] \
        == [{k: e[k] for k in ("file", "level", "tick0", "tick1", "t0",
                               "t1")} for e in ref]
    assert runs["tc"].store.position() == runs["jc"].store.position()


_STATE_PATHS = tree_paths(t_agg.init(TCfg(**GEOM), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))
_EVICTED = _STATE_PATHS.index("flow_topk.evicted")
_TOPK_COUNTS = _STATE_PATHS.index("flow_topk.counts")


def _evicted_close(got: float, ref: float, mass: float) -> bool:
    """``flow_topk.evicted`` is a difference of two float32 sums over
    the top-K lanes (``sketch/topk.py``), so its rounding scales with
    the top-K mass, not with its own value, and it depends on the order
    of the sum. The reference's own rule for it: the top-K mass plus
    ``evicted`` conserved within rtol 1e-5 (``tests/test_parallel.py``),
    and its fleet parity test compares ``flowstate`` modulo
    ``evictedbytes`` (``tests/test_shardfeed.py``)."""
    return abs(got - ref) <= 1e-5 * mass


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_shard_state_leaf_equals_live_and_reference(runs, i):
    """The port's shard at tick 4 == the port's live state at tick 4,
    bit for bit, and == the reference compactor's shard."""
    _, data = _shard(runs["tc"], 4)
    _, ref = _shard(runs["jc"], 4)
    live = runs["t_leaves"][0]
    assert len(data["state"]) == len(live) == len(ref["state"]) == 85
    a, b, r = data["state"][i], live[i], ref["state"][i]
    assert a.dtype == b.dtype == r.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b, err_msg=_STATE_PATHS[i])
    if i == _EVICTED:
        mass = float(r) + float(ref["state"][_TOPK_COUNTS].sum())
        assert _evicted_close(float(a), float(r), mass), (a, r, mass)
    else:
        np.testing.assert_array_equal(a, r, err_msg=_STATE_PATHS[i])


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_shard_dep_leaf_equals_live_and_reference(runs, i):
    _, data = _shard(runs["tc"], 4)
    _, ref = _shard(runs["jc"], 4)
    live = runs["t_leaves"][1]
    assert len(data["dep"]) == len(live) == len(ref["dep"]) == 29
    a, b, r = data["dep"][i], live[i], ref["dep"][i]
    assert a.dtype == b.dtype == r.dtype
    np.testing.assert_array_equal(a, b, err_msg=_DEP_PATHS[i])
    np.testing.assert_array_equal(a, r, err_msg=_DEP_PATHS[i])


@pytest.mark.parametrize("panel", ["svc_resp", "api_resp", "task_cpu"])
def test_delta_panels_match_reference(runs, panel):
    for tick1 in (2, 4):
        _, got = _shard(runs["tc"], tick1)
        _, ref = _shard(runs["jc"], tick1)
        g, r = got["deltas"][panel], ref["deltas"][panel]
        assert g["key"].tolist() == r["key"].tolist()
        np.testing.assert_array_equal(g["hist"], r["hist"])
        assert set(g) == set(r)
        for k in g.get("td", {}):
            np.testing.assert_array_equal(g["td"][k], r["td"][k])


@pytest.mark.parametrize("subsys", ["svcstate", "hoststate",
                                    "clusterstate", "taskstate", "cpumem",
                                    "tracereq"])
def test_shard_columns_match_reference(runs, subsys):
    _, got = _shard(runs["tc"], 4)
    _, ref = _shard(runs["jc"], 4)
    gc, gm = got["columns"][subsys]
    rc, rm = ref["columns"][subsys]
    np.testing.assert_array_equal(gm, rm)
    assert list(gc) == list(rc)
    for c in rc:
        assert gc[c].dtype == rc[c].dtype, c
        if rc[c].dtype == object:
            assert gc[c].tolist() == rc[c].tolist(), c
        else:
            np.testing.assert_allclose(gc[c], rc[c], rtol=1e-6, atol=0,
                                       err_msg=c)


# ------------------------------------------------------------- at= JSON
@pytest.mark.parametrize("name", sorted(LIVE_REQS))
def test_at_query_equals_live_and_reference(runs, name):
    """``at=tick:4`` from the shard == the live query at tick 4 (the
    port against itself: equal JSON), and == the reference's at=."""
    req = dict(LIVE_REQS[name], at="tick:4")
    ref, got = _both(runs, req)
    assert got["tick"] == ref["tick"] == 4
    assert got["recs"] == runs["t_live"][name]["recs"]
    if name == "flowstate":
        # evictedbytes: the top-K's evicted mass (_evicted_close)
        mass = float(runs["j_leaves"][0][_EVICTED]) + float(
            runs["j_leaves"][0][_TOPK_COUNTS].sum())
        for r, g in zip(ref["recs"], got["recs"]):
            assert _evicted_close(g.pop("evictedbytes"),
                                  r.pop("evictedbytes"), mass)
    assert_json_equal(ref, got)


@pytest.mark.parametrize("name", ["svcstate", "topk", "svcdependency"])
def test_at_query_snapshot_consistency_matches_reference(runs, name):
    req = dict(LIVE_REQS[name], at="tick:2", consistency="snapshot")
    ref, got = _both(runs, req)
    assert got["tick"] == 2
    assert_json_equal(ref, got)


@pytest.mark.parametrize("subsys", ["svcinfo", "alerts"])
def test_at_query_registry_view_refused_like_reference(runs, subsys):
    ref, got = _both(runs, {"subsys": subsys, "at": "tick:4"})
    assert got[0] == "ValueError" and "not available historically" \
        in got[1]
    assert got == ref


# --------------------------------------------------------- window= JSON
WINDOW_REQS = {
    "svcstate": {"subsys": "svcstate", "window": "1h", "maxrecs": 100},
    "svcstate_sorted": {"subsys": "svcstate", "window": "1h",
                        "filter": "{ svcstate.qps5s > 0 }",
                        "sortcol": "qps5s", "maxrecs": 5},
    "tracereq": {"subsys": "tracereq", "window": "1h", "maxrecs": 200,
                 "filter": "{ tracereq.nreq > 0 }"},
    "taskstate": {"subsys": "taskstate", "window": "1h", "maxrecs": 200},
    "topk": {"subsys": "topk", "window": "1h", "maxrecs": 50},
    "hoststate": {"subsys": "hoststate", "window": "1h"},
    "clusterstate": {"subsys": "clusterstate", "window": "1h"},
    "cpumem": {"subsys": "cpumem", "window": "1h"},
    "svcstate_p99": {"subsys": "svcstate", "window": "1h",
                     "columns": ["svcid", "p99resp5s", "p95resp5s"],
                     "sortcol": "p99resp5s", "maxrecs": 10},
    "svcstate_aggr": {"subsys": "svcstate", "window": "1h",
                      "aggr": ["max(p99resp5s)", "avg(qps5s)"]},
}


@pytest.mark.parametrize("name", sorted(WINDOW_REQS))
def test_window_query_matches_reference(runs, name):
    ref, got = _both(runs, WINDOW_REQS[name])
    assert "shards" not in got or got["shards"] == 2
    assert_json_equal(ref, got)


def test_window_topk_diff_has_honest_bounds(runs):
    tk = runs["tr"].query({"subsys": "topk", "window": "1h",
                           "maxrecs": 50})
    assert tk["nrecs"] > 0
    assert all("errbound" in r and r["value"] > 0 for r in tk["recs"])


def test_partial_window_matches_reference(runs):
    """``tstart`` inside the second window, on the shard tier (a
    runtime without ``history_db``), against the reference."""
    ents = runs["tc"].store.shards("raw")
    mid = (ents[0]["t1"] + ents[1]["t1"]) / 2.0
    req = {"subsys": "svcstate", "tstart": mid,
           "tend": ents[-1]["t1"] + 1.0, "maxrecs": 100}
    out = {}
    for pkg, cls, rtc, extra in (
            ("ref", JOpts, JRuntime, {}), ("port", TOpts, TRuntime,
                                           {"device": "cpu"})):
        d = runs["tmp"] / pkg
        rt = rtc(JCfg(**GEOM) if pkg == "ref" else TCfg(**GEOM),
                 cls(**OPTS, hist_shard_dir=str(d / "shards")),
                 clock=lambda: T0 + 100.0, **extra)
        try:
            out[pkg] = rt.query(dict(req))
        finally:
            rt.close()
    assert out["port"]["shards"] == 1
    assert_json_equal(out["ref"], out["port"])


# ------------------------------------------------- tstart/tend over SQL
SQL_REQS = {
    "all": {"subsys": "svcstate", "tstart": 0, "tend": 4e9},
    "filter": {"subsys": "svcstate", "tstart": T0, "tend": T0 + 12.0,
               "filter": "{ svcstate.qps5s > 10 }"},
    "hoststate": {"subsys": "hoststate", "tstart": 0},
    "cpumem": {"subsys": "cpumem", "tstart": 0, "maxrecs": 5},
    "aggr": {"subsys": "svcstate", "tstart": 0, "tend": 4e9,
             "aggr": ["sum(nqry5s) as n", "max(p99resp5s)"],
             "groupby": ["svcid"]},
    "aggr_time": {"subsys": "taskstate", "tstart": 0, "tend": 4e9,
                  "aggr": ["count(*) as n"], "groupby": ["time"],
                  "step": 10},
}


@pytest.mark.parametrize("name", sorted(SQL_REQS))
def test_tstart_sql_query_matches_reference(runs, name):
    ref, got = _both(runs, SQL_REQS[name])
    assert got.get("recs")
    assert_json_equal(ref, got)


def test_sql_sweep_rows_read_back(runs):
    """Read-your-writes: every sweep row of every tick is in the store
    (4 sweeps × 32 services)."""
    got = runs["tr"].query({"subsys": "svcstate", "tstart": 0,
                            "tend": 4e9})
    assert len(got["recs"]) == N_TICKS * 32
    assert runs["tr"].stats.counters["history_write_sweeps"] == N_TICKS


def test_relational_history_refused_on_snapshot_path(runs):
    ref, got = _both(runs, {"subsys": "svcstate", "tstart": 0,
                            "consistency": "snapshot"})
    assert got == ref and got[0] == "ValueError"


# ------------------------------------------------ shards across packages
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("name", ["svcstate", "topk", "flowstate",
                                  "svcdependency", "taskstate"])
def test_shards_serve_across_packages(runs, writer, name):
    """A shard directory written by one package's compactor answers the
    other package's ``at=`` query with the writer's JSON."""
    d = runs["tmp"] / writer / "shards"
    req = dict(LIVE_REQS[name], at="tick:4")
    clock = lambda: T0 + 100.0  # noqa: E731
    jr = JRuntime(JCfg(**GEOM), JOpts(**OPTS, hist_shard_dir=str(d)),
                  clock=clock)
    tr = TRuntime(TCfg(**GEOM), TOpts(**OPTS, hist_shard_dir=str(d)),
                  clock=clock, device="cpu")
    try:
        # the names of the stream: the live runtimes' intern tables
        names, _ = tick_buffers(TSim, t_wire)
        jr.feed(names)
        tr.feed(names)
        assert_json_equal(jr.query(dict(req)), tr.query(dict(req)))
    finally:
        jr.close()
        tr.close()


# ----------------------------------------------------- windowed quantiles
def test_windowed_quantiles_match_offline_exact_merge(runs):
    """``window=`` p50/p95/p99 equal the quantile of the offline exact
    merge: the monotone loghists captured at the window boundaries."""
    tr, caps = runs["tr"], runs["t_caps"]
    cfg = tr.cfg
    svcids = _hex_id(tr.state.tbl.key_hi.numpy(),
                     tr.state.tbl.key_lo.numpy())

    def quant(hist, spec, q, scale):
        return float(t_wq.np_hist_quantiles(
            np.asarray(hist, np.float32)[None, :], spec,
            [q])[0, 0]) / scale

    win = tr.query({"subsys": "svcstate", "window": "1h",
                    "maxrecs": 100})
    exp = caps[4]["svc_resp"] - caps[0]["svc_resp"]
    by_id = {svcids[i]: i for i in range(len(svcids))}
    checked = 0
    for r in win["recs"]:
        i = by_id.get(r["svcid"])
        if i is None or exp[i].sum() == 0:
            continue
        for field, q in (("p99resp5s", 0.99), ("p95resp5s", 0.95),
                         ("p50resp5d", 0.50)):
            # row_to_json rounds to 3 decimals
            assert r[field] == pytest.approx(
                quant(exp[i], cfg.resp_spec, q, 1e3), abs=5e-4), field
        assert r["p99resp5s"] >= r["p95resp5s"] >= r["p50resp5d"]
        checked += 1
    assert checked >= 8
    tk = tr.query({"subsys": "taskstate", "window": "1h",
                   "maxrecs": 200})
    expc = caps[4]["task_cpu"] - caps[0]["task_cpu"]
    wantc = sorted(round(quant(h, cfg.taskcpu_spec, 0.95, 1.0), 3)
                   for h in expc if h.sum() > 0)
    gotc = sorted(r["cpup95"] for r in tk["recs"] if r["cpup95"] > 0)
    assert gotc == pytest.approx([w for w in wantc if w > 0], abs=5e-4)
    tq = tr.query({"subsys": "tracereq", "window": "1h", "maxrecs": 200,
                   "filter": "{ tracereq.nreq > 0 }"})
    expt = caps[4]["api_resp"] - caps[0]["api_resp"]
    want = sorted(round(quant(h, cfg.apiresp_spec, 0.99, 1e3), 3)
                  for h in expt if h.sum() > 0)
    assert sorted(r["p99resp"] for r in tq["recs"]) \
        == pytest.approx(want, abs=5e-4)


def test_boundary_captures_match_reference(runs):
    for tick in (0, 2, 4):
        for n in t_wq.DELTA_SPECS:
            np.testing.assert_array_equal(runs["t_caps"][tick][n],
                                          runs["j_caps"][tick][n])


def _delta_less_store(cls, opts):
    store = cls(opts.hist_shard_dir)
    cols = {"svcid": np.array(["aa", "bb"], object),
            "svcname": np.array(["s1", "s2"], object),
            "qps5s": np.array([1.0, 2.0]),
            "p99resp5s": np.array([10.0, 20.0]),
            "hostid": np.array([0.0, 1.0])}
    for k, (t0, t1) in enumerate(((10.0, 20.0), (20.0, 30.0))):
        store.add_shard(level="raw", tick0=k * 2, tick1=k * 2 + 2,
                        t0=t0, t1=t1, state_leaves=[], dep_leaves=[],
                        columns={"svcstate": (cols, np.ones(2, bool))},
                        wal_pos=(0, 100 * (k + 1)))


def test_windowed_quantile_rejected_and_counted_like_reference(tmp_path):
    """Shards without delta panels reject windowed quantile references,
    counted ``windowed_quant_rejected``, and omit the fields from an
    implicit projection — as the reference does."""
    got = {}
    for pkg in ("ref", "port"):
        ocls = JOpts if pkg == "ref" else TOpts
        opts = ocls(**OPTS, hist_shard_dir=str(tmp_path / pkg))
        _delta_less_store(JShardStore if pkg == "ref" else TShardStore,
                          opts)
        rt = JRuntime(JCfg(**GEOM), opts) if pkg == "ref" else \
            TRuntime(TCfg(**GEOM), opts, device="cpu")
        try:
            errs = []
            for req in ({"columns": ["svcid", "p99resp5s"]},
                        {"sortcol": "p99resp5s"},
                        {"filter": "{ svcstate.p99resp5s > 5 }"},
                        {"aggr": ["max(p99resp5s)"]}):
                with pytest.raises(ValueError, match="windowed quantile"):
                    rt.query({"subsys": "svcstate", "window": "1h", **req})
                errs.append(req)
            out = rt.query({"subsys": "svcstate", "window": "1h",
                            "maxrecs": 10})
            rt.alerts.add_def({"alertname": "stale-p99",
                               "subsys": "svcstate",
                               "filter": "{ svcstate.p99resp5s > 1 }",
                               "window": "1h"})
            fired = rt.alerts.check(rt.state,
                                    columns_fn=rt._alert_columns)
            got[pkg] = (out, dict(rt.stats.counters),
                        dict(rt.alerts.stats), len(fired))
        finally:
            rt.close()
    (jout, jc, ja, jf), (tout, tc, ta, tf) = got["ref"], got["port"]
    assert tc["windowed_quant_rejected"] == jc["windowed_quant_rejected"] \
        == 4
    assert tc["windowed_quant_fields_omitted"] \
        == jc["windowed_quant_fields_omitted"] > 0
    assert all("p99resp5s" not in r for r in tout["recs"])
    assert_json_equal(jout, tout)
    assert ta["nwindow_skipped"] == ja["nwindow_skipped"] == 1
    assert tf == jf == 0


# ---------------------------------------------------- windowed alertdef
@pytest.mark.parametrize("path", ["live", "snapshot"])
def test_windowed_alertdef_fires_like_reference(runs, path):
    """A windowed alertdef reads ``svcstate@1h`` through the time-travel
    tier: live (``_alert_columns``) and from the published snapshot."""
    fired = {}
    for pkg, rt in (("ref", runs["jr"]), ("port", runs["tr"])):
        mgr = (JMgr if pkg == "ref" else TMgr)(rt.cfg,
                                               clock=lambda: T0 + 50.0)
        mgr.add_def({"alertname": "win-qps", "subsys": "svcstate",
                     "filter": "{ svcstate.qps5s >= 0 }",
                     "window": "1h"})
        mgr.add_def({"alertname": "win-p99", "subsys": "svcstate",
                     "filter": "{ svcstate.p99resp5s > 0 }",
                     "window": "1h"})
        cf = rt._alert_columns if path == "live" else rt.snapshot.columns
        fired[pkg] = sorted((a.alertname, a.entity)
                            for a in mgr.check(rt.state, columns_fn=cf))
        assert mgr.stats["nwindow_skipped"] == 0
    assert fired["port"] == fired["ref"]
    assert {n for n, _ in fired["port"]} == {"win-qps", "win-p99"}


# -------------------------------------------- delta panels and retention
def _drive(rt, sim, ticks):
    w = t_wire if isinstance(rt, TRuntime) else j_wire
    for _ in range(ticks):
        rt.feed(tick_bytes(sim, w, rt._tick_no))
        rt.run_tick()


def _small_run(tmp, cls_rt, cls_opts, cfg, ticks, seed, **kw):
    """A runtime of :func:`tick_bytes`' stream, on ``seed`` → (runtime,
    options, its sim, to continue the stream)."""
    opts = _opts(cls_opts, tmp, **kw)
    extra = {"device": "cpu"} if cls_rt is TRuntime else {}
    rt = cls_rt(cfg, opts, clock=lambda: T0, **extra)
    sim = (TSim if cls_rt is TRuntime else JSim)(n_hosts=8, n_svcs=4,
                                                 seed=seed)
    rt.feed(sim.name_frames())
    _drive(rt, sim, ticks)
    return rt, opts, sim


def test_retention_and_delta_downsample_match_reference(tmp_path):
    """Raw shards age into mid shards (hist_retain_raw=2,
    hist_mid_every=2, one tick a window): the listing, the merged
    columns, the summed delta panels and an ``at=`` on a mid shard
    equal the reference's; nothing is lost through the downsample."""
    kw = dict(hist_window_ticks=1, hist_mid_every=2, hist_retain_raw=2,
              hist_hour_every=2, hist_retain_mid=50, hist_retain_hour=10,
              history_db=None)
    out = {}
    for pkg in ("ref", "port"):
        cls_rt, cls_opts, cls_c, cfg = (
            (JRuntime, JOpts, JCompactor, JCfg(**GEOM)) if pkg == "ref"
            else (TRuntime, TOpts, TCompactor, TCfg(**GEOM)))
        rt, opts, _ = _small_run(tmp_path / pkg, cls_rt, cls_opts, cfg,
                                 6, 17, **kw)
        extra = {"device": "cpu"} if pkg == "port" else {}
        c = cls_c(cfg, opts, journal=rt.journal, stats=rt.stats,
                  clock=lambda: T0, **extra)
        try:
            c.compact_once(seal=True, upto_tick=rt._tick_no)
            mids, raws = c.store.shards("mid"), c.store.shards("raw")
            assert mids and len(raws) <= 4
            named = {e["file"] for e in c.store.shards()}
            assert named == {p.name for p in
                             c.store.dir.glob("gyt_shard_*.npz")}
            m0 = c.store.load(mids[0])
            final = (t_wq if pkg == "port" else j_wq).leaf_of(
                rt.state, "svc_resp").astype(np.float32)
            parts = [(c.store.load(e)["deltas"]["svc_resp"]["key"],
                      c.store.load(e)["deltas"]["svc_resp"]["hist"])
                     for e in mids + raws]
            _keys, merged = t_wq.merge_delta_rows(parts)
            assert float(merged.sum()) == pytest.approx(
                float(final.sum()), rel=1e-6)
            at = rt.query({"subsys": "topk",
                           "at": f"tick:{mids[0]['tick1']}"})
            assert at["nrecs"] > 0
            out[pkg] = ([(e["file"], e["tick0"], e["tick1"])
                         for e in c.store.shards()], m0, at,
                        rt.stats.counters["compact_downsampled"])
        finally:
            c.close()
            rt.close()
    (jl, jm, jat, jd), (tl, tm, tat, td) = out["ref"], out["port"]
    assert tl == jl and td == jd >= 1
    for subsys in jm["columns"]:
        for c in jm["columns"][subsys][0]:
            a = tm["columns"][subsys][0][c]
            b = jm["columns"][subsys][0][c]
            if b.dtype == object:
                assert a.tolist() == b.tolist(), (subsys, c)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=f"{subsys}.{c}")
    for n in jm["deltas"]:
        assert tm["deltas"][n]["key"].tolist() \
            == jm["deltas"][n]["key"].tolist()
        np.testing.assert_array_equal(tm["deltas"][n]["hist"],
                                      jm["deltas"][n]["hist"])
    td_ = tm["deltas"]["svc_resp"]["td"]
    assert np.allclose(td_["weights"].sum(axis=1),
                       tm["deltas"]["svc_resp"]["hist"].sum(axis=1),
                       rtol=1e-5)
    assert_json_equal(jat, tat)


def test_restart_resume_equals_uninterrupted_compactor(tmp_path):
    """A fresh port Compactor re-seeds its replay runtime from the
    newest raw shard and continues from the shard's WAL position: its
    shard at tick 4 equals an uninterrupted compactor's, leaf for leaf,
    and its floor holds unconsumed segments back."""
    cfg = TCfg(**GEOM)
    rt, opts, sim = _small_run(tmp_path / "a", TRuntime, TOpts, cfg, 2,
                               11, history_db=None)
    try:
        c1 = TCompactor(cfg, opts, journal=rt.journal, stats=rt.stats,
                        device="cpu")
        assert c1.compact_once(seal=True,
                               upto_tick=rt._tick_no)["windows"] == 1
        c1.close()
        _drive(rt, sim, 2)
        live = _t_leaves(rt)
        c2 = TCompactor(cfg, opts, journal=rt.journal, stats=rt.stats,
                        device="cpu")
        assert c2.compact_once(seal=True,
                               upto_tick=rt._tick_no)["windows"] == 1
        _, resumed = _shard(c2, 4)
        pos = c2.store.position()
        assert pos is not None and rt.journal._truncate_floor == pos[0]
        c2.close()
        # an uninterrupted compactor over a copy of the same WAL
        wal2 = tmp_path / "b" / "wal"
        shutil.copytree(opts.journal_dir, wal2)
        c3 = TCompactor(cfg, opts, journal_dir=str(wal2),
                        shard_dir=str(tmp_path / "b" / "shards"),
                        device="cpu")
        c3.compact_once(upto_tick=rt._tick_no)
        _, whole = _shard(c3, 4)
        c3.close()
    finally:
        rt.close()
    for kind, k in (("state", 0), ("dep", 1)):
        for i, (a, b, c) in enumerate(zip(resumed[kind], whole[kind],
                                          live[k])):
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} {i}")
            np.testing.assert_array_equal(a, c, err_msg=f"{kind} {i}")


def test_sigkill_mid_compaction_converges(tmp_path):
    """A compactor killed inside the shard write (twice) leaves a
    manifest naming only existing files; a fresh one sweeps the debris
    and converges to the live state."""
    cfg = TCfg(**GEOM)
    rt, opts, _ = _small_run(tmp_path, TRuntime, TOpts, cfg, 4, 13,
                             history_db=None)
    live = _t_leaves(rt)

    class Boom(RuntimeError):
        pass

    crashes = 0
    try:
        while True:
            c = TCompactor(cfg, opts, journal=rt.journal, device="cpu")
            orig = c.store.add_shard

            def dying_add(*a, _orig=orig, _c=c, **kw):
                if crashes < 2:
                    (_c.store.dir / "gyt_shard_raw_99999998_99999999"
                     ".tmp.npz").write_bytes(b"partial write")
                    raise Boom()
                return _orig(*a, **kw)

            c.store.add_shard = dying_add
            try:
                c.compact_once(seal=True, upto_tick=rt._tick_no)
            except Boom:
                crashes += 1
                for e in c.store.manifest()["shards"]:
                    assert (c.store.dir / e["file"]).exists()
                continue
            finally:
                c.close()
            break
    finally:
        rt.close()
    assert crashes == 2
    store = TShardStore(opts.hist_shard_dir)
    assert not list(store.dir.glob("*.tmp.npz"))
    ent = [e for e in store.shards("raw") if e["tick1"] == 4][0]
    for a, b in zip(store.load(ent)["state"], live[0]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ shard store
def test_shard_store_roundtrip_resolution_and_cross_load(tmp_path):
    """The store's round trip and at=/window= resolution equal the
    reference's, and each package loads the other's shard files."""
    cols = {"svcstate": (
        {"svcid": np.array(["aa", "bb"], object),
         "qps5s": np.array([1.0, 2.0])},
        np.array([True, False]))}
    out = {}
    for pkg, cls in (("ref", JShardStore), ("port", TShardStore)):
        store = cls(tmp_path / pkg)
        store.add_shard(level="raw", tick0=0, tick1=2, t0=10.0, t1=20.0,
                        state_leaves=[np.arange(4, dtype=np.uint32)],
                        dep_leaves=[np.ones(2, np.float32)],
                        columns=cols, wal_pos=(0, 100))
        store.add_shard(level="raw", tick0=2, tick1=4, t0=20.0, t1=30.0,
                        state_leaves=[np.arange(4, dtype=np.uint32) + 1],
                        dep_leaves=[np.ones(2, np.float32)],
                        columns=cols, wal_pos=(0, 200))
        out[pkg] = (store.position(), store.tick(),
                    [store.resolve_at(a)["tick1"] for a in
                     (25.0, 30.0, 5.0, ("tick", 3), ("tick", 4))],
                    [[e["tick1"] for e in store.resolve_window(*w)]
                     for w in ((15.0, 35.0), (25.0, 35.0))])
    assert out["port"] == out["ref"]
    assert out["port"][0] == (0, 200)
    assert out["port"][2] == [2, 4, 2, 2, 4]
    for reader, writer in ((TShardStore, "ref"), (JShardStore, "port")):
        store = reader(tmp_path / writer)
        data = store.load(store.shards()[0])
        assert data["columns"]["svcstate"][0]["svcid"].dtype == object
        assert list(data["columns"]["svcstate"][0]["svcid"]) == ["aa",
                                                                 "bb"]
        assert data["state"][0].dtype == np.uint32
        np.testing.assert_array_equal(data["state"][0], np.arange(4))


def test_shard_store_sweeps_orphans(tmp_path):
    store = TShardStore(tmp_path / "sh")
    store.add_shard(level="raw", tick0=0, tick1=2, t0=1.0, t1=2.0,
                    state_leaves=[np.arange(2)], dep_leaves=[],
                    columns={}, wal_pos=(0, 50))
    (store.dir / "gyt_shard_raw_00000099_00000100.tmp.npz").write_bytes(
        b"torn")
    (store.dir / "gyt_shard_raw_00000004_00000006.npz").write_bytes(
        b"orphan - manifest never saw it")
    store2 = TShardStore(store.dir)
    assert store2.sweep_stale_tmp() == 2
    assert {p.name for p in store.dir.glob("*.npz")} \
        == {"gyt_shard_raw_00000000_00000002.npz"}
    assert len(store2.shards()) == 1


@pytest.mark.parametrize("seed", [3, 9])
def test_window_aggregation_matches_reference(seed):
    """``aggregate_window_columns`` and its keyed-loop reference form
    against the reference package's, on random panels with churn."""
    rng = np.random.default_rng(seed)
    ids = np.array([f"{i:016x}" for i in range(300)], object)
    parts = []
    for _ in range(4):
        cols = {"svcid": ids,
                "svcname": np.array([f"svc-{i % 97}" for i in range(300)],
                                    object),
                "qps5s": rng.uniform(0, 100, 300),
                "state": rng.integers(0, 5, 300).astype(np.int32),
                "hostid": (np.arange(300) % 8).astype(np.float64)}
        parts.append((cols, rng.uniform(size=300) > 0.3))
    want, wmask = j_tv.aggregate_window_columns("svcstate", parts)
    for fn in (t_tv.aggregate_window_columns,
               t_tv.aggregate_window_columns_ref):
        got, gmask = fn("svcstate", parts)
        assert list(got) == list(want)
        np.testing.assert_array_equal(gmask, wmask)
        for c in want:
            if want[c].dtype == object:
                assert got[c].tolist() == want[c].tolist(), c
            else:
                np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("v", [900, "900", "15m", "2h", " 1D "])
def test_parse_dur_and_when_match_reference(v):
    assert t_tv.parse_dur(v) == j_tv.parse_dur(v)
    for w in ("tick:7", "-15m", "1700000000", 1.5e9):
        assert t_tv.parse_when(w, T0) == j_tv.parse_when(w, T0)


def test_timeview_errors_match_reference(tmp_path):
    got = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            bare = JRuntime(JCfg(**GEOM), JOpts(**OPTS))
            shard = JRuntime(JCfg(**GEOM), JOpts(
                **OPTS, hist_shard_dir=str(tmp_path / pkg)))
        else:
            bare = TRuntime(TCfg(**GEOM), TOpts(**OPTS), device="cpu")
            shard = TRuntime(TCfg(**GEOM), TOpts(
                **OPTS, hist_shard_dir=str(tmp_path / pkg)),
                device="cpu")
        msgs = []
        try:
            for rt, req in ((bare, {"subsys": "svcstate", "at": "tick:1"}),
                            (bare, {"subsys": "svcstate", "tstart": 0}),
                            (bare, {"subsys": "svcstate", "window": "5m",
                                    "consistency": "snapshot"}),
                            (shard, {"subsys": "svcstate",
                                     "at": "tick:1"}),
                            (shard, {"subsys": "svcstate",
                                     "window": "1h"})):
                with pytest.raises(ValueError) as e:
                    rt.query(dict(req))
                msgs.append(str(e.value))
        finally:
            bare.close()
            shard.close()
        got[pkg] = msgs
    assert got["port"] == got["ref"]
    assert "time-travel" in got["port"][0]
    assert "no history shards" in got["port"][3]


# ---------------------------------------------------------- layouts
def test_parted_store_and_sharded_wal_open(tmp_path):
    """A parted root (``part_NN/`` before its first pass) opens as the
    parallel compactor's ``PartedShardStore`` and a runtime serves over
    it (no window yet); a sharded WAL (``shard_NN/``) is read by the
    compactor's tick-merged walk: an empty one compacts to nothing."""
    parted = tmp_path / "parted"
    (parted / "part_00").mkdir(parents=True)
    store = open_shard_store(parted)
    assert isinstance(store, PartedShardStore) and len(store.parts) == 1
    assert (store.shards(), store.position(), store.tick()) \
        == ([], None, 0)
    rt = TRuntime(TCfg(**GEOM), TOpts(**OPTS, hist_shard_dir=str(parted)),
                  device="cpu")
    try:
        assert isinstance(rt.timeview.store, PartedShardStore)
        with pytest.raises(ValueError, match="no history shards"):
            rt.query({"subsys": "svcstate", "at": "tick:1"})
    finally:
        rt.close()
    wal = tmp_path / "wal"
    (wal / "shard_00").mkdir(parents=True)
    c = TCompactor(TCfg(**GEOM), TOpts(**OPTS, journal_dir=str(wal),
                                       hist_shard_dir=str(tmp_path / "s")),
                   device="cpu")
    try:
        rep = c.compact_once()
        assert (rep["chunks"], rep["windows"]) == (0, 0)
    finally:
        c.close()


def test_compactor_daemon_starts_and_stops(tmp_path):
    """The daemon thread compacts on its cadence and is joined by
    ``close``."""
    cfg = TCfg(**GEOM)
    rt, opts, _ = _small_run(tmp_path, TRuntime, TOpts, cfg, 2, 5,
                             history_db=None)
    c = TCompactor(cfg, opts, journal=rt.journal, stats=rt.stats,
                   device="cpu")
    try:
        c.start(interval=0.05)
        thread = c._thread
        deadline = threading.Event()
        for _ in range(200):
            if rt.stats.counters.get("compact_passes", 0) >= 2:
                break
            deadline.wait(0.05)
        assert rt.stats.counters["compact_passes"] >= 2
        assert rt.stats.counters.get("compact_errors", 0) == 0
    finally:
        c.close()
        rt.close()
    assert c._thread is None and not thread.is_alive()


# ------------------------------------------------------- history writer
class _SlowStore:
    """write() blocks until released: a stalled database."""

    def __init__(self):
        self.gate = threading.Event()
        self.writes = []

    def write(self, subsys, t, rows):
        self.gate.wait(timeout=10.0)
        self.writes.append((subsys, t, len(rows)))
        return len(rows)


def test_history_writer_bounded_queue_and_barrier():
    store = _SlowStore()
    stats = Stats()
    hw = HistoryWriter(store, stats=stats, max_queue=2)
    try:
        hw.write_sweep([("svcstate", 1.0, [{"a": 1}] * 3)])
        ev = threading.Event()
        for _ in range(1000):
            if hw._busy:
                break
            ev.wait(0.005)
        for i in range(4):
            hw.write_sweep([("svcstate", 2.0 + i, [{"a": 1}] * 2)])
        assert stats.counters["history_write_dropped"] == 2
        assert stats.counters["history_write_dropped_rows"] == 4
        assert stats.gauges["history_write_queue_depth"] == 2.0
        store.gate.set()
        assert hw.barrier(timeout=10.0)
        assert stats.counters["history_write_sweeps"] == 3
        assert [w[1] for w in store.writes] == [1.0, 4.0, 5.0]
    finally:
        store.gate.set()
        hw.close()
    assert not hw._worker.is_alive()
    hw.write_sweep([("svcstate", 9.0, [])])   # after close: a no-op


# ------------------------------------------------------------- check_db
class _Clock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _alerts(fired):
    return [(a.alertname, a.severity, a.entity, a.tfired,
             sorted(a.row.items())) for a in fired]


def _db_scenario(mgr_cls, store_cls, scenario):
    """One of ``tests/test_alerts_db.py``'s scenarios on one package →
    what each check returned, the log of routed alerts and the stats."""
    clk = _Clock()
    am = mgr_cls(JCfg(n_hosts=4, svc_capacity=64), clock=clk)
    routed = []
    am.register_action("collect", routed.extend)
    hs = store_cls(":memory:")
    out = []
    if scenario == "fires":
        am.add_def({"alertname": "badhosts", "subsys": "hoststate",
                    "filter": "{ hoststate.state = 'Bad' }", "mode": "db",
                    "querysec": 60.0, "severity": "critical"})
        hs.write("hoststate", clk.t - 10, [{"hostid": 1, "state": "Bad"},
                                           {"hostid": 2,
                                            "state": "Good"}])
        out.append(am.check_db(hs))
    elif scenario == "period_repeat":
        am.add_def({"alertname": "badhosts", "subsys": "hoststate",
                    "filter": "{ hoststate.state = 'Bad' }", "mode": "db",
                    "querysec": 60.0, "repeataftersec": 3600.0})
        hs.write("hoststate", clk.t - 10, [{"hostid": 1, "state": "Bad"}])
        out.append(am.check_db(hs))
        clk.t += 30
        out.append(am.check_db(hs))
        clk.t += 31
        hs.write("hoststate", clk.t - 5, [{"hostid": 1, "state": "Bad"}])
        out.append(am.check_db(hs))
    elif scenario == "numcheckfor":
        am.add_def({"alertname": "persist", "subsys": "hoststate",
                    "filter": "{ hoststate.state = 'Bad' }", "mode": "db",
                    "querysec": 60.0, "numcheckfor": 2,
                    "repeataftersec": 0.0})
        for _ in range(2):
            hs.write("hoststate", clk.t - 5, [{"hostid": 3,
                                               "state": "Bad"}])
            out.append(am.check_db(hs))
            clk.t += 61
        out.append(am.check_db(hs))
    elif scenario == "group_wait":
        am.add_def({"alertname": "grp", "subsys": "hoststate",
                    "filter": "{ hoststate.state = 'Bad' }", "mode": "db",
                    "querysec": 30.0, "groupwaitsec": 90.0,
                    "repeataftersec": 0.0, "action": "collect"})
        hs.write("hoststate", clk.t - 5, [{"hostid": 1, "state": "Bad"}])
        out.append(am.check_db(hs))
        clk.t += 31
        hs.write("hoststate", clk.t - 5, [{"hostid": 2, "state": "Bad"}])
        out.append(am.check_db(hs))
        clk.t += 61
        out.append(am.check_db(hs))
    elif scenario == "silenced_inhibited":
        am.add_def({"alertname": "src", "subsys": "hoststate",
                    "filter": "{ hoststate.state = 'Bad' }", "mode": "db",
                    "querysec": 10.0, "repeataftersec": 0.0})
        am.add_def({"alertname": "tgt", "subsys": "cpumem",
                    "filter": "{ cpumem.cpustate = 'Severe' }",
                    "mode": "db", "querysec": 10.0,
                    "repeataftersec": 0.0})
        am.add_silence({"name": "s1", "alertnames": ["src"],
                        "tstart": clk.t + 5, "tend": clk.t + 15})
        am.add_inhibit({"name": "i1", "src_alertnames": ["src"],
                        "target_alertnames": ["tgt"]})
        hs.write("hoststate", clk.t - 5, [{"hostid": 1, "state": "Bad"}])
        hs.write("cpumem", clk.t - 5, [{"hostid": 1,
                                        "cpustate": "Severe"}])
        for _ in range(3):
            out.append(am.check_db(hs))
            clk.t += 11
    return ([_alerts(o) for o in out], _alerts(routed), dict(am.stats),
            am.firing())


@pytest.mark.parametrize("scenario", ["fires", "period_repeat",
                                      "numcheckfor", "group_wait",
                                      "silenced_inhibited"])
def test_check_db_matches_reference(scenario):
    ref = _db_scenario(JMgr, JStore, scenario)
    got = _db_scenario(TMgr, TStore, scenario)
    assert got == ref
    assert any(ref[0]) or ref[1]
    assert got[2]["ndbchecks"] > 0


def test_db_alertdef_through_run_tick_matches_reference():
    """A db-mode def evaluated by the tick after the writer's barrier:
    equal reports and alerts."""
    got = {}
    for pkg in ("ref", "port"):
        clk = _Clock()
        if pkg == "ref":
            rt = JRuntime(JCfg(**GEOM), JOpts(
                **OPTS, history_db=":memory:"), clock=clk)
            sim = JSim(**SIM_KW)
            w = j_wire
        else:
            rt = TRuntime(TCfg(**GEOM), TOpts(
                **OPTS, history_db=":memory:"), clock=clk, device="cpu")
            sim = TSim(**SIM_KW)
            w = t_wire
        try:
            rt.query({"op": "add", "objtype": "alertdef",
                      "alertname": "cpu-hot-db", "subsys": "cpumem",
                      "filter": "{ cpumem.cpustate = 'Severe' }",
                      "mode": "db", "querysec": 5.0,
                      "repeataftersec": 0.0})
            rt.feed(tick_bytes(sim, w, 2))      # host 2's cpu is hot
            reps = [rt.run_tick()]
            clk.t += 6
            reps.append(rt.run_tick())
            got[pkg] = (reps, _alerts(rt.alerts.alert_log),
                        dict(rt.alerts.stats))
        finally:
            rt.close()
    assert got["port"] == got["ref"]
    assert any(a[0] == "cpu-hot-db" and a[2] == "hostid=2"
               for a in got["port"][1])


# ----------------------------------------------------- Postgres, no server
def test_open_store_routes_by_url(tmp_path):
    s = t_open_store(str(tmp_path / "h.db"))
    assert isinstance(s, TStore) and not isinstance(s, t_pg.PgHistoryStore)
    s.db.close()
    for mod in ("psycopg", "psycopg2"):
        try:
            __import__(mod)
            return
        except ImportError:
            pass
    for fn in (t_open_store, j_open_store):
        with pytest.raises(RuntimeError, match="psycopg"):
            fn("postgresql://u:p@nowhere/db")


def test_pgdb_facade_translates_paramstyle():
    calls = []

    class FakeCur:
        def execute(self, q, p=None):
            calls.append((q, p))

        def executemany(self, q, seq):
            calls.append((q, list(seq)))

    class FakeConn:
        autocommit = False

        def cursor(self):
            return FakeCur()

    conn = FakeConn()
    db = t_pg._PgDb(conn)
    assert conn.autocommit is True
    db.execute("SELECT x FROM t WHERE a = ? AND b IN (?,?)", (1, 2, 3))
    assert calls[0] == ("SELECT x FROM t WHERE a = %s "
                        "AND b IN (%s,%s)", [1, 2, 3])
    db.execute("SELECT 1 FROM t WHERE n LIKE '%x%'")
    assert calls[-1] == ("SELECT 1 FROM t WHERE n LIKE '%x%'", None)
    with db:
        pass
    assert [c[0] for c in calls[-2:]] == ["BEGIN", "COMMIT"]
    with pytest.raises(RuntimeError):
        with db:
            raise RuntimeError("boom")
    assert calls[-1][0] == "ROLLBACK"


class _FakePgCursor:
    """The Postgres DB-API surface emulated on sqlite (the reference's
    ``tests/test_pgstore.py`` fake): what the store emits runs through
    a real SQL engine."""

    def __init__(self, conn):
        self._conn = conn

    @staticmethod
    def _xlate(q: str) -> str:
        q = q.replace("%s", "?")
        q = q.replace("double precision", "real")
        q = q.replace("boolean", "integer")
        if "information_schema.tables" in q:
            q = q.replace("information_schema.tables", "sqlite_master")
            q = q.replace("table_name", "name")
            q = q.replace("table_schema = current_schema()", "1=1")
            q = q.replace("table_type = 'BASE TABLE'", "type = 'table'")
        return q

    def execute(self, q, params=None):
        self._cur = self._conn.execute(self._xlate(q), params or [])
        return self

    def executemany(self, q, seq):
        self._cur = self._conn.executemany(self._xlate(q), seq)
        return self

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()

    def __iter__(self):
        return iter(self._cur)


class _FakePgConn:
    def __init__(self):
        import math
        import sqlite3

        self._db = sqlite3.connect(":memory:", isolation_level=None)
        self._db.create_function(
            "strpos", 2, lambda s, sub: 0 if s is None
            else (s.find(sub) + 1))
        self._db.create_function("FLOOR", 1, math.floor)
        self.autocommit = False

    def cursor(self):
        return _FakePgCursor(self._db)

    def close(self):
        self._db.close()


def _pg_rows(n=16):
    return [{"svcid": f"{i:016x}", "svcname": f"svc-{i}",
             "qps5s": float(i), "p99resp5s": 10.0 * i,
             "state": "OK" if i % 2 else "Bad", "hostid": i % 4}
            for i in range(n)]


def _pg_contract(hs):
    t = 1_700_000_000.0
    day = 86400.0
    out = [hs.write("svcstate", t, _pg_rows())]
    out.append(hs.query("svcstate", t - 60, t + 60,
                        "{ svcstate.qps5s > 7 }"))
    out.append(hs.query("svcstate", t - 60, t + 60,
                        "{ svcstate.svcname substr 'svc-1' }"))
    out.append(hs.query("svcstate", t - 60, t + 60,
                        "{ svcstate.state = 'Bad' }"))
    out.append(hs.aggr_query("svcstate", t - 60, t + 60,
                             ["sum(qps5s) as tq", "count(*) as n"],
                             groupby=["hostid"]))
    hs.write("svcstate", t + 61, _pg_rows(4))
    out.append(hs.aggr_query("svcstate", t, t + 120, ["count(*) as n"],
                             groupby=["time"], step=60.0))
    hs.write("svcstate", t + 3 * day, _pg_rows(2))
    out.append(hs.days())
    hs.db.execute("CREATE TABLE svcstatetbl_backup (x real)")
    out.append(hs.cleanup(keep_days=1, now=t + 3 * day))
    out.append(hs.query("svcstate", t + 3 * day - 60, t + 3 * day + 60,
                        None))
    return out


def test_fake_pg_store_contract_matches_reference(monkeypatch):
    import gyeeta_tpu.history.pgstore as j_pgmod

    monkeypatch.setattr(t_pg, "_connect", lambda dsn: _FakePgConn())
    monkeypatch.setattr(j_pgmod, "_connect", lambda dsn: _FakePgConn())
    got = _pg_contract(t_pg.PgHistoryStore("postgresql://fake/fake"))
    ref = _pg_contract(JPg("postgresql://fake/fake"))
    assert got == ref
    assert got[0] == 16 and len(got[1]) == 8 and len(got[3]) == 8
    assert [r["n"] for r in got[5]] == [16, 4]
    assert got[7] == 1
