"""The port's ``Runtime`` against the reference's, fed the same bytes.

One seeded stream of four ticks — the announce-rate records of
``test_torch_registries.registry_frames`` (LISTENER_INFO and HOST_INFO
on ticks 0 and 2, CGROUP_STATE, MOUNT_STATE and NETIF_STATE sweeps,
VIP-dialled service flows), NAME_INTERN (tick 0), SWEEP_SEQ,
LISTENER_STATE, AGGR_TASK_STATE (a partial sweep at tick 3), HOST_STATE,
CPU_MEM_STATE, REQ_TRACE, then TCP_CONN (plain flows, service→service
flows and split halves, each server half held for the next tick, those
of tick 0 never sent) and
RESP_SAMPLE — goes through ``feed`` in uneven byte cuts (frames split
across calls resume from the partial-frame buffer), with ``run_tick``
after each tick, into the reference ``Runtime`` and the port's
``Runtime(device="cpu")``, both on one clock of 5 s a tick, after the
same CRUD requests (``"op"``: alertdefs, silences, an inhibit, a
tracedef, a tag). The ticks age tasks and APIs every second tick and
checkpoint every second tick.

Held against the reference: each tick's report (``alerts_fired``
included; ``history_rows`` with a ``history_db`` is held in
``tests/test_torch_history.py``), the CRUD
replies, each tick's ``trace_control_diff``, the selfstats counters
(``stage_slab_flips`` of the double-buffered staging slabs among them),
the alert manager's stats and log, the five record kinds' registries,
all 85 ``AggState`` and 29 ``DepGraph`` leaves after the last tick
(integer, bool, u32 and max-merged state exact; f32 sums rtol 1e-6;
digests rtol 1e-5), the ``heavy_recover`` dict (floats rtol 1e-6),
checkpoints both ways (each restored runtime answering every served
subsystem with equal JSON) and the staging builders' columns. The
query JSON of the live runtimes is in
``tests/test_torch_query.py``, which shares this run (:func:`run_both`).
"""

import functools
import pathlib
import socket
import tempfile

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.ingest import native as j_native
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.utils import checkpoint as j_ckpt
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import loghist as t_lh
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_registries import prime_vips, registry_frames, runtime_ops

torch.set_num_threads(1)

N_TICKS = 4
SIM_KW = dict(n_hosts=8, n_svcs=4, n_clients=256)
OPTS = dict(dep_pair_capacity=64, dep_edge_capacity=256,
            dep_pair_ttl_ticks=1, dep_edge_ttl_ticks=2,
            task_age_every_ticks=2, task_max_age_ticks=1,
            api_max_age_ticks=2, checkpoint_every_ticks=2)
# each tick's buffer is fed in four calls, cut this many bytes before
# its end (inside the conn/resp frames: the sweep sections of a tick
# fold in one dispatch, conn/resp stage until the tick's flush)
CUTS_FROM_END = (9001, 5000, 333)
# the 43 subsystems the port serves: 20 of the engine's state and
# dependency graph, and 23 of the host-side registries and the alert tier
SERVED = ("svcstate", "hoststate", "clusterstate", "flowstate", "taskstate",
          "topcpu", "toppgcpu", "toprss", "topdelay", "topfork", "cpumem",
          "tracereq", "traceuniq", "svcsumm", "hostlist", "topk",
          "svcdependency", "svcmesh", "activeconn", "clientconn")
NEW_SERVED = ("svcinfo", "procinfo", "hostinfo", "extsvcstate",
              "svcprocmap", "tracedef", "tracestatus", "traceconn", "tags",
              "mountstate", "netif", "extactiveconn", "extclientconn",
              "exttracereq", "cgroupstate", "svcipclust", "serverstatus",
              "notifymsg", "alerts", "alertdef", "silences", "inhibits",
              "actions")
SERVED = SERVED + NEW_SERVED
# counters only the reference keeps: none (the native decoder's
# ref_native_decoded and ref_fallback_decoded are the port's too)
REF_ONLY_COUNTERS: set = set()
FOLD_COUNTERS = ("conn_events", "resp_events", "listener_records",
                 "host_records", "task_records", "cpumem_records",
                 "trace_records", "resp_from_trace", "sweep_marks",
                 "names_interned", "fold_dispatches", "slab_dispatches",
                 "stage_slab_flips", "td_partial_flushes",
                 "topk_recover_readbacks", "topk_hot_promotions",
                 "checkpoints", "listener_infos", "host_infos",
                 "cgroup_records", "mount_records", "netif_records")
TICK_SECONDS = 5.0
_EXACT_F32 = (".inv.prio", ".svc_td.vmin", ".svc_td.vmax", ".h_bytes")


def j_cfg():
    return graft._tiny_cfg()._replace(n_hosts=8, task_capacity=128,
                                      api_capacity=256)


def t_cfg():
    return t_agg.EngineCfg(
        svc_capacity=64, n_hosts=8,
        resp_spec=t_lh.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64),
        hll_p_svc=6, hll_p_global=8, cms_depth=2, cms_width=1 << 10,
        topk_capacity=32, td_capacity=16, task_capacity=128,
        api_capacity=256, conn_batch=64, resp_batch=64, listener_batch=64)


def tick_buffers(sim_cls, w):
    """The four ticks' byte streams of one package's sim and wire."""
    sim = sim_cls(**SIM_KW)
    reg = sim_cls(**SIM_KW, seed=9)   # the registry records' own stream
    out, late = [], None
    for tick in range(N_TICKS):
        seq = np.zeros(SIM_KW["n_hosts"], w.SWEEP_SEQ_DT)
        seq["host_id"] = np.arange(SIM_KW["n_hosts"])
        seq["seq"] = 10 * tick + seq["host_id"]
        tasks = sim.aggr_task_records()
        if tick == 3:                 # a partial sweep: the rest age out
            tasks = tasks[:8]
        cli, ser = sim.svc_conn_records(8, split_halves=True)
        # server halves ride the next tick, but tick 0's never come:
        # its client halves expire
        conns = np.concatenate(
            [sim.conn_records(40), sim.svc_conn_records(8), cli]
            + ([late] if late is not None and tick != 1 else []))
        late = ser
        out.append(
            registry_frames(reg, w, tick)
            + (sim.name_frames() if tick == 0 else b"")
            + w.encode_frames_chunked(w.NOTIFY_SWEEP_SEQ, seq)
            + sim.listener_frames()
            + w.encode_frames_chunked(w.NOTIFY_AGGR_TASK_STATE, tasks)
            + w.encode_frames_chunked(w.NOTIFY_HOST_STATE,
                                      sim.host_state_records())
            + w.encode_frames_chunked(w.NOTIFY_CPU_MEM_STATE,
                                      sim.cpu_mem_records(
                                          hot_cpu=[tick % 8],
                                          hot_mem=[(tick + 3) % 8]))
            + sim.trace_frames(80)
            + w.encode_frames_chunked(w.NOTIFY_TCP_CONN, conns)
            + sim.resp_frames(100))
    return out


def _feed_ticks(rt, bufs, now):
    """Feed each tick in uneven cuts, advance the clock, run the tick
    and take the tracedefs' diff → (reports, diffs, partial feeds)."""
    reports, diffs, partial = [], [], 0
    for buf in bufs:
        cuts = [0] + [len(buf) - c for c in CUTS_FROM_END] + [len(buf)]
        for a, b in zip(cuts, cuts[1:]):
            rt.feed(buf[a:b])
            partial += bool(rt._pending)
        now[0] += TICK_SECONDS
        reports.append(rt.run_tick())
        diffs.append(rt.trace_control_diff(
            hosts=None if len(diffs) != 1 else range(4)))
    return reports, diffs, partial


@functools.lru_cache(maxsize=None)
def run_both():
    """Run the stream through both runtimes once per process, after the
    same CRUD requests → dict of the runtimes, their CRUD replies,
    reports, tracedef diffs and counters (copied right after the run:
    later recoveries and queries bump them). Both runtimes' DNS caches
    are primed with the same name for every VIP."""
    j_bufs = tick_buffers(JSim, j_wire)
    t_bufs = tick_buffers(TSim, t_wire)
    assert j_bufs == t_bufs
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gyt_torch_rt_"))
    j_now, t_now = [1.7e9], [1.7e9]
    jr = JRuntime(j_cfg(), JOpts(**OPTS, checkpoint_dir=str(tmp / "ref")),
                  clock=lambda: j_now[0])
    tr = TRuntime(t_cfg(), TOpts(**OPTS, checkpoint_dir=str(tmp / "port")),
                  clock=lambda: t_now[0], device="cpu")
    ops = runtime_ops(TSim(**SIM_KW))
    j_crud = [jr.query(dict(o)) for o in ops]
    t_crud = [tr.query(dict(o)) for o in ops]
    j_rep, j_diff, j_partial = _feed_ticks(jr, j_bufs, j_now)
    t_rep, t_diff, t_partial = _feed_ticks(tr, t_bufs, t_now)
    ctr = (dict(jr.stats.counters), dict(tr.stats.counters))
    prime_vips(tr, prime_vips(jr))
    return {"jr": jr, "tr": tr, "j_rep": j_rep, "t_rep": t_rep,
            "j_crud": j_crud, "t_crud": t_crud,
            "j_diff": j_diff, "t_diff": t_diff,
            "j_ctr": ctr[0], "t_ctr": ctr[1],
            "partial": (j_partial, t_partial), "tmp": tmp}


@pytest.fixture(scope="module")
def runs():
    return run_both()


def assert_json_equal(ref, got, path="$"):
    """Strings, ints and bools exact; floats rtol 1e-6."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), \
            (path, sorted(set(got) ^ set(ref)))
        for k in ref:
            assert_json_equal(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), \
            (path, len(got), len(ref))
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_json_equal(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) or isinstance(got, float):
        assert got == pytest.approx(ref, rel=1e-6, abs=0), path
    else:
        assert type(got) is type(ref) and got == ref, (path, ref, got)


def _leaf_check(path, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (path, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind != "f" or path.endswith(_EXACT_F32):
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        rtol = 1e-5 if path.startswith(".svc_td") else 1e-6
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=path)


# ------------------------------------------------------------ the run
@pytest.mark.parametrize("tick", range(N_TICKS))
def test_tick_report_matches_reference(runs, tick):
    ref, got = runs["j_rep"][tick], runs["t_rep"][tick]
    assert set(got) == set(ref) and "alerts_fired" in got
    for k in got:
        if k == "checkpoint":
            assert pathlib.Path(got[k]).name == pathlib.Path(ref[k]).name
        else:
            assert got[k] == ref[k], k
    assert got["tick"] == tick + 1
    assert ("checkpoint" in got) == (tick % 2 == 1)


@pytest.mark.parametrize("name", FOLD_COUNTERS)
def test_fold_counter_matches_reference(runs, name):
    assert runs["t_ctr"].get(name) == runs["j_ctr"].get(name)


def test_counter_sets_match_reference(runs):
    j, t = runs["j_ctr"], runs["t_ctr"]
    assert set(t) <= set(j)
    assert set(j) - set(t) <= REF_ONLY_COUNTERS
    assert all(t[k] == j[k] for k in t)


def test_stream_reaches_every_path(runs):
    """Partial frames resumed, every section and the bridge folded, the
    digest stage flushed, halves paired across ticks, tasks aged."""
    ctr, tr = runs["t_ctr"], runs["tr"]
    assert min(runs["partial"]) > 0
    for k in FOLD_COUNTERS:
        assert ctr.get(k, 0) > 0, k
    assert tr._sweep_last_seq == {h: 30 + h for h in range(8)}
    assert sum(r["alerts_fired"] for r in runs["t_rep"]) > 0
    assert any(runs["t_diff"]) and len(tr.natclusters) > 0
    assert float(tr.dep.n_paired) > 0 and float(tr.dep.n_expired) > 0
    assert int(tr.state.task_tbl.n_live) < 64
    assert len(np.unique(tr.state.svc_state.numpy())) >= 3


_STATE_PATHS = tree_paths(t_agg.init(t_cfg(), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_state_leaf_matches_reference(runs, i):
    ref = [np.asarray(x) for x in jax.tree.leaves(runs["jr"].state)]
    got = t_agg.state_to_numpy(runs["tr"].state)
    assert len(ref) == len(got) == len(_STATE_PATHS) == 85
    _leaf_check(_STATE_PATHS[i], ref[i], got[i])


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_dep_leaf_matches_reference(runs, i):
    ref = [np.asarray(x) for x in jax.tree.leaves(runs["jr"].dep)]
    got = t_dg.dep_to_numpy(runs["tr"].dep)
    assert len(ref) == len(got) == len(_DEP_PATHS) == 29
    _leaf_check(_DEP_PATHS[i], ref[i], got[i])


def test_heavy_recover_matches_reference(runs):
    ref, got = runs["jr"].heavy_recover(), runs["tr"].heavy_recover()
    assert set(got) == set(ref)
    assert got["recovered_keys"] == ref["recovered_keys"] > 0
    assert got["new_hot"] == ref["new_hot"]
    for k in ("evicted", "err_term", "total_mass"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=0), k
    # rows by id: a last-ulp difference may reorder near ties
    rows = {r[0]: r[1:] for r in got["flows"]}
    assert len(rows) == len(got["flows"]) == len(ref["flows"])
    for rid, val, eb, src in ref["flows"]:
        g = rows[rid]
        assert g[2] == src
        assert g[0] == pytest.approx(val, rel=1e-6, abs=0)
        assert g[1] == pytest.approx(eb, rel=1e-6, abs=1e-6 * val)
    assert {r[3] for r in got["flows"]} == {"exact", "recovered"}


# -------------------------------------------------------- checkpoints
def _ckpt(runs, side, tick=N_TICKS):
    return runs["tmp"] / side / f"gyt_ckpt_{tick:08d}.npz"


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_across_packages(runs, writer):
    """A checkpoint written by one package's tick cadence restores in
    both; the restored port state equals the writer's state leaf for
    leaf, and the two restored runtimes answer every served subsystem
    with equal JSON."""
    path = _ckpt(runs, writer)
    clock = lambda: 1.7e9  # noqa: E731  (serverstatus reads uptime)
    jr2 = JRuntime(j_cfg(), JOpts(**OPTS), clock=clock)
    tr2 = TRuntime(t_cfg(), TOpts(**OPTS), clock=clock, device="cpu")
    j_extra, t_extra = jr2.restore(path), tr2.restore(path)
    assert t_extra == j_extra
    assert t_extra["tick"] == N_TICKS
    assert t_extra["sweep_seq"] == {str(h): 30 + h for h in range(8)}
    assert tr2._tick_no == jr2._tick_no == N_TICKS
    assert tr2._sweep_last_seq == jr2._sweep_last_seq
    src = [np.asarray(x) for x in jax.tree.leaves(runs["jr"].state)]
    for p, a, b in zip(_STATE_PATHS, src,
                       t_agg.state_to_numpy(tr2.state)):
        _leaf_check(p, a, b)
    for subsys in SERVED:
        req = {"subsys": subsys, "maxrecs": 10000}
        assert_json_equal(jr2.query(req), tr2.query(req), subsys)


def test_checkpoint_fingerprint_and_save_match_reference(runs, tmp_path):
    """``repr(cfg)`` (nested LogHistSpec/WindowSpec included) and the
    npz layout equal the reference's: the port's ``save`` of the live
    state reads back through the reference's ``restore``."""
    from gyeeta_tpu_torch.utils import checkpoint as t_ckpt

    assert repr(t_cfg()) == repr(j_cfg())
    assert t_ckpt._cfg_fingerprint(t_cfg()) == \
        j_ckpt._cfg_fingerprint(j_cfg())
    p = t_ckpt.save(tmp_path / "c.npz", t_cfg(), runs["tr"].state,
                    extra={"tick": 9})
    (tmp_path / "stale.tmp.npz").write_bytes(b"x")
    t_ckpt.save(tmp_path / "d.npz", t_cfg(), runs["tr"].state)
    assert not list(tmp_path.glob("*.tmp.npz"))
    st, extra = j_ckpt.restore(p, j_cfg(), runs["jr"].state)
    assert extra == {"tick": 9}
    for path, a, b in zip(_STATE_PATHS, jax.tree.leaves(st),
                          t_agg.state_to_numpy(runs["tr"].state)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=path)
    with pytest.raises(ValueError, match="fingerprint"):
        t_ckpt.restore(p, t_cfg()._replace(svc_capacity=128),
                       runs["tr"].state)


# ------------------------------------------------------------ staging
def _recs():
    sim = JSim(**SIM_KW, seed=3)
    cli, ser = sim.svc_conn_records(8, split_halves=True)
    tasks = sim.aggr_task_records()
    ping = np.zeros(9, j_wire.TASK_PING_DT)
    ping["aggr_task_id"] = tasks["aggr_task_id"][:9]
    ping["host_id"] = tasks["host_id"][:9]
    return {
        "conn": np.concatenate([sim.conn_records(50), cli, ser]),
        "resp": sim.resp_records(70),
        "listener": sim.listener_state_records(),
        "task": tasks,
        "cpumem": sim.cpu_mem_records(hot_cpu=[1]),
        "host": sim.host_state_records(),
        "trace": sim.trace_records(40),
        "ping": ping,
    }


_BUILDERS = {
    "ping_batch": lambda d, r: d.ping_batch(r["ping"], 80),
    "listener_batch_fast": lambda d, r: d.listener_batch_fast(
        r["listener"], 64),
    "task_batch_fast": lambda d, r: d.task_batch_fast(r["task"], 80),
    "cpumem_batch_fast": lambda d, r: d.cpumem_batch_fast(r["cpumem"], 16),
    "host_batch_fast": lambda d, r: d.host_batch_fast(r["host"], 16),
    "conn_slab": lambda d, r: d.conn_slab(
        [r["conn"][:30], r["conn"][30:]], 3, 40),
    "resp_slab": lambda d, r: d.resp_slab(r["resp"], 1, 80),
    "conn_slab_1": lambda d, r: d.conn_slab(r["conn"][:50], 1, 64),
    "trace_batch": lambda d, r: d.trace_batch(r["trace"], 48),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_staging_builder_columns_match_reference(name):
    """The port's numpy builders give the columns of the reference's
    (native where it is built) builders."""
    recs = _recs()
    ref, got = _BUILDERS[name](j_dec, recs), _BUILDERS[name](t_dec, recs)
    assert got._fields == ref._fields
    for f, a, b in zip(got._fields, ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_drain_plan_and_bridge_match_reference():
    sim = JSim(**SIM_KW, seed=4)
    buf = (sim.name_frames() + sim.listener_frames() * 3
           + sim.task_frames() + sim.trace_frames(300)
           + sim.conn_frames(150) + sim.resp_frames(200))
    cut = len(buf) - 77
    for j_drain in (j_native.drain2, j_native._drain_py2):
        jo, jc, ju = j_drain(buf[:cut])
        to, tc, tu = t_wire.drain2(buf[:cut])
        assert (tc, tu) == (jc, ju) and sorted(to) == sorted(jo)
        for k in jo:
            assert to[k].tobytes() == jo[k].tobytes()
    j_plan = list(j_dec.drain_chunks(jo, 64, 64, 40))
    t_plan = list(t_dec.drain_chunks(to, 64, 64, 40))
    assert [p[0] for p in t_plan] == [p[0] for p in j_plan]
    for a, b in zip(j_plan, t_plan):
        for x, y in zip(a[1:], b[1:]):
            assert x.tobytes() == y.tobytes()
    tr = to[t_wire.NOTIFY_REQ_TRACE]
    assert t_dec.resp_from_trace(tr).tobytes() == \
        j_dec.resp_from_trace(tr).tobytes()
    raw = [to[t_wire.NOTIFY_TCP_CONN][i:i + 40] for i in range(0, 150, 40)]
    j_raw = list(raw)
    assert [len(c) for c in t_dec.take_raw_chunks(raw, 70)[0]] == \
        [len(c) for c in j_dec.take_raw_chunks(j_raw, 70)[0]]
    assert [len(c) for c in raw] == [len(c) for c in j_raw]


def test_name_frames_byte_identical():
    kw = dict(n_hosts=5, n_svcs=3, host_base=40, n_groups=4)
    assert TSim(**kw).name_frames() == JSim(**kw).name_frames()


# ------------------------------------------- registries, alerts, CRUD
# record kind → (registry attribute, selfstats counter)
_REGISTRY_KINDS = {
    "LISTENER_INFO": ("svcreg", "listener_infos"),
    "HOST_INFO": ("hostinfo", "host_infos"),
    "CGROUP_STATE": ("cgroups", "cgroup_records"),
    "MOUNT_STATE": ("mounts", "mount_records"),
    "NETIF_STATE": ("netifs", "netif_records"),
}


def _cols_equal(ref, got, what):
    (rc, rm), (gc, gm) = ref, got
    np.testing.assert_array_equal(gm, rm, err_msg=what)
    assert list(gc) == list(rc), what
    for k in rc:
        a, b = np.asarray(rc[k]), np.asarray(gc[k])
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{k}")


@pytest.mark.parametrize("kind", sorted(_REGISTRY_KINDS))
def test_record_kind_matches_reference(runs, kind):
    """Each announce-rate record kind lands in its registry as in the
    reference: the same count, the same columns (names resolved), the
    same ageing clock."""
    reg, ctr = _REGISTRY_KINDS[kind]
    jreg, treg = getattr(runs["jr"], reg), getattr(runs["tr"], reg)
    assert runs["t_ctr"][ctr] == runs["j_ctr"][ctr] > 0
    assert len(treg) == len(jreg) > 0
    _cols_equal(jreg.columns(runs["jr"].names),
                treg.columns(runs["tr"].names), kind)
    assert getattr(treg, "_sweep", None) == getattr(jreg, "_sweep", None)


def test_crud_replies_match_reference(runs):
    assert runs["t_crud"] == runs["j_crud"]
    assert all(r["ok"] for r in runs["t_crud"])


@pytest.mark.parametrize("req", [
    {"op": "add", "subsys": "alertdef"},
    {"op": "add", "objtype": "alertdef", "alertname": "x",
     "subsys": "svcstate", "filter": "{ hoststate.nprocissue > 1 }"},
    {"op": "delete", "objtype": "silence"},
    {"op": "rename", "objtype": "tag"},
], ids=["no objtype", "foreign filter", "no name", "bad op"])
def test_op_request_errors_match_reference(req):
    """An ``"op"`` request is the CRUD channel's: a bad one fails with
    the reference's error."""
    with pytest.raises(Exception) as ref:
        JRuntime(j_cfg(), JOpts(**OPTS)).query(dict(req))
    with pytest.raises(Exception) as got:
        _fresh().query(dict(req))
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


def test_trace_control_diff_matches_reference(runs):
    assert runs["t_diff"] == runs["j_diff"]
    assert runs["tr"].trace_control_diff() == \
        runs["jr"].trace_control_diff()


def test_alert_manager_matches_reference(runs):
    jm, tm = runs["jr"].alerts, runs["tr"].alerts
    assert tm.stats == jm.stats
    assert tm.stats["nfired"] > 0 and tm.stats["nwindow_skipped"] > 0
    assert [tuple(a) for a in tm.alert_log] == \
        [tuple(a) for a in jm.alert_log]
    assert sorted(tm.firing()) == sorted(jm.firing())
    _cols_equal(runs["jr"].notifylog.columns(),
                runs["tr"].notifylog.columns(), "notifymsg")


def test_close_joins_background_threads(monkeypatch):
    """``close`` joins the resolver and the delivery worker; a second
    call is a no-op. (No lookup leaves the process: the resolver's
    ``getnameinfo`` fails here, as for an unresolvable address.)"""
    def refuse(*a, **kw):
        raise OSError("no lookups in tests")

    monkeypatch.setattr(socket, "getnameinfo", refuse)
    rt = _fresh()
    rt.dns.get("10.0.0.1")            # a miss starts the resolver
    assert rt.dns._thread is not None
    rt.close()
    rt.close()
    assert rt.dns._thread is None and rt.alerts._dispatcher is None


# ------------------------------------------------------------ fresh
def _fresh():
    return TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")


def test_bad_frame_drops_pending_and_counts():
    rt = _fresh()
    buf = TSim(**SIM_KW).conn_frames(5)
    assert rt.feed(buf[:40]) == 0 and rt._pending == buf[:40]
    with pytest.raises(t_wire.FrameError):
        rt.feed(buf[40:] + b"\x00" * 32)
    assert rt._pending == b"" and rt.stats.counters["frames_bad"] == 1
    assert rt.feed(buf) == 5 and rt.stats.counters["conn_events"] == 5
