"""The delta section of ``fold_all`` through the port's ``Runtime``
against the reference's, fed the same bytes; and the port's delta-fed
engine against its own raw-fed one.

One seeded stream of four ticks goes through ``feed`` (each tick's
buffer in two calls, cut inside the SKETCH_DELTA frames) and
``run_tick`` into the reference ``Runtime`` and the port's
``Runtime(device="cpu")``, both on one clock of 5 s a tick, after the
same CRUD requests (``test_torch_registries.runtime_ops``): the
announce-rate records of ``test_torch_registries.registry_frames``,
names (tick 0), the raw LISTENER_STATE and
HOST_STATE sweeps, one agent's edge-folded conn/resp sweep as
SKETCH_DELTA records (``hll_refresh_every=3``, a truncating
``flow_max``; tick 2 adds records of an unknown kind and with
out-of-range items), raw TCP_CONN and RESP_SAMPLE records beside them,
and AGENT_STATS records. Every delta dispatch rides ``fold_all`` with
the sections staged beside it.

Held against the reference: each tick's report (``alerts_fired``
included), the ``preagg_*``,
``agent_*``/``spool_*`` and fold counters, all 85 ``AggState`` and 29
``DepGraph`` leaves after every tick (integer, bool, u32 and max-merged
state exact; f32 sums rtol 1e-6; digests rtol 1e-5) and the strong-path
query JSON of every served subsystem. ``tests/test_torch_snapshot.py``
shares this run (:func:`run_delta_both`) for the snapshot tier.

Port only: the reference's delta-vs-raw property (tests/test_preagg.py)
at 40 sweeps, with its bounds, between two port runtimes.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.sketch import edgefold as j_ef
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.engine import aggstate as t_agg, table as t_tbl
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import edgefold as t_ef
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_edgefold import cfgs
from test_torch_registries import prime_vips, registry_frames, runtime_ops
from test_torch_runtime import SERVED, _leaf_check, assert_json_equal

torch.set_num_threads(1)

N_TICKS = 4
SIM_KW = dict(n_hosts=8, n_svcs=4, n_clients=256, seed=7)
OPTS = dict(dep_pair_capacity=256, dep_edge_capacity=1024)
CFG_OVER = dict(task_capacity=128, api_capacity=256)
FLOW_MAX = 24
# the counters of the delta path (decode and the agent's stats frames)
DELTA_COUNTERS = ("preagg_delta_records", "preagg_lanes",
                  "preagg_source_conn", "preagg_source_resp",
                  "preagg_oob_items", "preagg_unknown_kinds",
                  "spool_dropped", "spool_dropped_records", "spool_resent",
                  "agent_connect_timeouts")
FOLD_COUNTERS = ("conn_events", "resp_events", "listener_records",
                 "host_records", "names_interned", "fold_dispatches",
                 "td_partial_flushes", "topk_recover_readbacks",
                 "snapshots_published")


def j_cfg():
    return cfgs(**CFG_OVER)[0]


def t_cfg():
    return cfgs(**CFG_OVER)[1]


def _odd_records(w):
    """Delta records the decoder must drop and count: an unknown kind,
    and loghist pairs past the engine's 32 buckets."""
    r = np.zeros(2, w.DELTA_DT)
    r["kind"] = [99, w.DK_SVC_HIST]
    r["nitem"] = [0, 2]
    pv = r["payload"][1][:12].view(w.DELTA_PAIR_DT)
    pv["idx"], pv["wt"] = [3, 4000], [1.0, 1.0]
    return r


def tick_buffers(sim_cls, ef_mod, w, params):
    """The four ticks' byte streams of one package → [(buf, cut)]."""
    sim = sim_cls(**SIM_KW)
    reg = sim_cls(**dict(SIM_KW, seed=9))   # the registry records' stream
    ef = ef_mod.EdgeFold(params, host_id=0, hll_refresh_every=3)
    out = []
    for tick in range(N_TICKS):
        delta = ef.fold_sweep(sim.conn_records(300), sim.resp_records(500))
        if tick == 2:
            delta = np.concatenate([delta, _odd_records(w)])
        dbytes = w.encode_frames_chunked(w.NOTIFY_SKETCH_DELTA, delta)
        agent = np.zeros(2, w.AGENT_STATS_DT)
        agent["host_id"] = [1, 2]
        agent["spool_dropped"] = [tick, 1]
        agent["spool_dropped_records"] = [10 * tick, 3]
        agent["spool_resent"] = [2, 0]
        agent["connect_timeouts"] = [0, tick]
        head = (registry_frames(reg, w, tick)
                + (sim.name_frames() if tick == 0 else b"")
                + sim.listener_frames()
                + w.encode_frames_chunked(w.NOTIFY_HOST_STATE,
                                          sim.host_state_records()))
        buf = (head + dbytes
               + w.encode_frames_chunked(w.NOTIFY_TCP_CONN,
                                         sim.conn_records(40))
               + sim.resp_frames(60)
               + w.encode_frames_chunked(w.NOTIFY_AGENT_STATS, agent))
        out.append((buf, len(head) + len(dbytes) // 2 + 5))
    return out


def _feed_ticks(rt, bufs, per_tick, now):
    """Feed each tick in two calls, advance the clock, run its tick, and
    record what ``per_tick(rt)`` reads after it."""
    reports, seen, partial = [], [], 0
    for buf, cut in bufs:
        rt.feed(buf[:cut])
        partial += bool(rt._pending)
        rt.feed(buf[cut:])
        now[0] += 5.0
        reports.append(rt.run_tick())
        seen.append(per_tick(rt))
    return reports, seen, partial


def _snapshot_json(rt):
    prime_vips(rt)                    # svcipclust never waits on DNS
    return {s: rt.query({"subsys": s, "maxrecs": 10000,
                         "consistency": "snapshot"}) for s in SERVED}


@functools.lru_cache(maxsize=None)
def run_delta_both():
    """Run the stream through both runtimes once per process, after the
    same CRUD requests → the runtimes, reports, counters, per-tick
    leaves and per-tick snapshot-served JSON."""
    jc, tc = j_cfg(), t_cfg()
    j_bufs = tick_buffers(JSim, j_ef, j_wire,
                          j_ef.params_of_cfg(jc, flow_max=FLOW_MAX, env={}))
    t_bufs = tick_buffers(TSim, t_ef, t_wire,
                          t_ef.params_of_cfg(tc, flow_max=FLOW_MAX))
    assert j_bufs == t_bufs
    j_now, t_now = [1.7e9], [1.7e9]
    jr = JRuntime(jc, JOpts(**OPTS), clock=lambda: j_now[0])
    tr = TRuntime(tc, TOpts(**OPTS), clock=lambda: t_now[0], device="cpu")
    ops = runtime_ops(TSim(**SIM_KW))
    assert [jr.query(dict(o)) for o in ops] == \
        [tr.query(dict(o)) for o in ops]

    def j_seen(rt):
        return {"state": [np.asarray(x) for x in jax.tree.leaves(rt.state)],
                "dep": [np.asarray(x) for x in jax.tree.leaves(rt.dep)],
                "snap": _snapshot_json(rt)}

    def t_seen(rt):
        return {"state": t_agg.state_to_numpy(rt.state),
                "dep": t_dg.dep_to_numpy(rt.dep),
                "snap": _snapshot_json(rt)}

    j_rep, j_ticks, j_partial = _feed_ticks(jr, j_bufs, j_seen, j_now)
    t_rep, t_ticks, t_partial = _feed_ticks(tr, t_bufs, t_seen, t_now)
    return {"jr": jr, "tr": tr, "j_rep": j_rep, "t_rep": t_rep,
            "j_ctr": dict(jr.stats.counters),
            "t_ctr": dict(tr.stats.counters),
            "j_ticks": j_ticks, "t_ticks": t_ticks,
            "partial": (j_partial, t_partial)}


@pytest.fixture(scope="module")
def runs():
    return run_delta_both()


# ------------------------------------------------------------ the run
@pytest.mark.parametrize("tick", range(N_TICKS))
def test_tick_report_matches_reference(runs, tick):
    ref, got = runs["j_rep"][tick], runs["t_rep"][tick]
    assert got == ref and "alerts_fired" in got
    assert got["tick"] == tick + 1


@pytest.mark.parametrize("name", DELTA_COUNTERS + FOLD_COUNTERS)
def test_counter_matches_reference(runs, name):
    got = runs["t_ctr"].get(name)
    assert got is not None and got == runs["j_ctr"].get(name)


def test_counter_sets_match_reference(runs):
    j, t = runs["j_ctr"], runs["t_ctr"]
    assert set(t) <= set(j)
    assert set(j) - set(t) <= {"ref_native_decoded",
                               "ref_fallback_decoded"}
    assert all(t[k] == j[k] for k in t)


def test_stream_reaches_every_path(runs):
    """Partial frames resumed, delta records dropped and counted, the
    agent's truncated flow mass charged, every delta family folded."""
    ctr, tr = runs["t_ctr"], runs["tr"]
    assert min(runs["partial"]) > 0
    assert ctr["preagg_oob_items"] == ctr["preagg_unknown_kinds"] == 1
    assert ctr["fold_dispatches"] > 2 * N_TICKS
    assert float(tr.state.flow_topk.evicted) > 0
    # the sim's 32 services and the odd records' key (0, 0)
    assert int(tr.state.tbl.n_live) == 33
    assert int((tr.state.glob_hll.regs > 0).sum()) > 0
    assert float(tr.dep.e_ctr[:, 0].sum()) > 0
    assert float(tr.state.inv.n_hot) > 0
    assert sum(r["alerts_fired"] for r in runs["t_rep"]) > 0
    assert tr.alerts.stats == runs["jr"].alerts.stats


_STATE_PATHS = tree_paths(t_agg.init(t_cfg(), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_state_leaf_matches_reference_every_tick(runs, i):
    for tick in range(N_TICKS):
        ref = runs["j_ticks"][tick]["state"]
        got = runs["t_ticks"][tick]["state"]
        assert len(ref) == len(got) == len(_STATE_PATHS) == 85
        _leaf_check(f"{_STATE_PATHS[i]}@{tick}", ref[i], got[i])


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_dep_leaf_matches_reference_every_tick(runs, i):
    for tick in range(N_TICKS):
        ref = runs["j_ticks"][tick]["dep"]
        got = runs["t_ticks"][tick]["dep"]
        assert len(ref) == len(got) == len(_DEP_PATHS) == 29
        _leaf_check(f"{_DEP_PATHS[i]}@{tick}", ref[i], got[i])


@pytest.mark.parametrize("subsys", SERVED)
def test_strong_query_json_matches_reference(runs, subsys):
    req = {"subsys": subsys, "maxrecs": 10000}
    assert_json_equal(runs["jr"].query(req), runs["tr"].query(req), subsys)


# ----------------------------------------------- delta vs raw (port only)
def _rows_of(rt, keys64):
    hi = torch.from_numpy((keys64 >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((keys64 & np.uint64(0xFFFFFFFF)).astype(np.int64))
    return t_tbl.lookup(rt.state.tbl, hi, lo).numpy()


def _edge_dict(dep):
    live = t_tbl.live_mask(dep.edge_tbl).numpy()
    cols = [getattr(dep, f).numpy()[live]
            for f in ("e_cli_hi", "e_cli_lo", "e_ser_hi", "e_ser_lo")]
    ctr = dep.e_ctr.numpy()[live]
    return {tuple(int(c[i]) for c in cols): tuple(ctr[i].tolist())
            for i in range(len(ctr))}


def test_delta_vs_raw_property_40_sweeps():
    """tests/test_preagg.py's bounds between a raw-fed and a delta-fed
    port runtime over 40 mixed sweeps: HLL registers bit-identical,
    loghist totals per service equal with at most max(2, 1e-4 of the
    total) bucket flips, counters rtol 1e-4, event counts exact, CMS
    mass of the delta runtime + the agent's residual = the raw mass
    (rtol 1e-5), dependency edges equal as a key set, values rtol
    1e-5."""
    _, cfg = cfgs(cms_width=1 << 14)
    sims = [TSim(n_hosts=4, n_svcs=2, n_clients=256, seed=23)
            for _ in range(2)]
    raw, dlt = (TRuntime(cfg, TOpts(**OPTS), device="cpu")
                for _ in range(2))
    ef = t_ef.EdgeFold(t_ef.params_of_cfg(cfg, flow_max=24), host_id=0,
                       hll_refresh_every=100)
    for rt, sim in ((raw, sims[0]), (dlt, sims[1])):
        rt.feed(sim.listener_frames())
    rng = np.random.default_rng(4)
    for i in range(40):
        nc, nr = int(rng.integers(8, 80)), int(rng.integers(8, 120))
        conn, resp = sims[0].conn_records(nc), sims[0].resp_records(nr)
        conn2, resp2 = sims[1].conn_records(nc), sims[1].resp_records(nr)
        raw.feed(t_wire.encode_frames_chunked(t_wire.NOTIFY_TCP_CONN, conn)
                 + t_wire.encode_frames_chunked(t_wire.NOTIFY_RESP_SAMPLE,
                                                resp))
        dlt.feed(t_wire.encode_frames_chunked(
            t_wire.NOTIFY_SKETCH_DELTA, ef.fold_sweep(conn2, resp2)))
        if i % 25 == 7:               # the raw 5s sweeps beside the deltas
            for rt, sim in ((raw, sims[0]), (dlt, sims[1])):
                rt.feed(sim.listener_frames() + sim.task_frames()
                        + t_wire.encode_frames_chunked(
                            t_wire.NOTIFY_HOST_STATE,
                            sim.host_state_records()))
    raw.flush(), dlt.flush()
    resid = ef.stats["resid_bytes"]
    sA, sB = raw.state, dlt.state
    keys = sims[0].glob_ids.reshape(-1)
    ra, rb = _rows_of(raw, keys), _rows_of(dlt, keys)
    assert (ra >= 0).all() and (rb >= 0).all()
    np.testing.assert_array_equal(sA.glob_hll.regs.numpy(),
                                  sB.glob_hll.regs.numpy())
    np.testing.assert_array_equal(sA.svc_hll.regs.numpy()[ra],
                                  sB.svc_hll.regs.numpy()[rb])
    ha, hb = sA.resp_win.cur.numpy()[ra], sB.resp_win.cur.numpy()[rb]
    np.testing.assert_array_equal(ha.sum(axis=1), hb.sum(axis=1))
    flips = float(np.abs(ha - hb).sum()) / 2
    assert flips <= max(2.0, 1e-4 * ha.sum()), flips
    np.testing.assert_allclose(sA.ctr_win.cur.numpy()[ra],
                               sB.ctr_win.cur.numpy()[rb],
                               rtol=1e-4, atol=1e-3)
    assert float(sA.n_conn) == float(sB.n_conn)
    assert float(sA.n_resp) == float(sB.n_resp)
    mA = float(sA.cms.counts[0].sum())
    mB = float(sB.cms.counts[0].sum())
    assert mB <= mA * (1 + 1e-6)
    np.testing.assert_allclose(mA, mB + resid, rtol=1e-5)
    ea, eb = _edge_dict(raw.dep), _edge_dict(dlt.dep)
    assert ea and set(ea) == set(eb)
    for k in ea:
        np.testing.assert_allclose(ea[k], eb[k], rtol=1e-5, atol=1e-3)
