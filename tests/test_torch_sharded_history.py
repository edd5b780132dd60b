"""History through the port's sharded runtime against the reference's:
a ``Compactor`` whose ``runtime_factory`` builds a ``ShardedRuntime``
replays the mesh's per-shard WAL into shards of the reference's stacked
``(n, ...)`` leaves, and ``at=`` / ``window=`` queries on the mesh are
served from them (the contract of the reference's
``tests/test_timeview.py::test_sharded_replay_parity_and_time_travel``).

One seeded stream, on the CPU: ``ParthaSim(8 hosts × 4 services, seed
31)`` at ``tests/test_timeview.py``'s geometry, names, then four ticks
of conn, resp, listener, task, host, cpu/mem and trace records, into the
port's ``ShardedRuntime(make_mesh(8, device="cpu"))`` and the
reference's ``ShardedRuntime(make_mesh(8))`` (eight virtual CPU
devices), both with a per-shard journal and ``hist_window_ticks=2``.
Each package's compactor reads its own WAL through an 8-shard factory:

- ``whole`` (both packages): one pass after tick 4 → 2 windows (ticks 2
  and 4);
- ``resumed`` (the port): one pass after tick 2 into its own store,
  closed, then a fresh compactor re-seeded from that stacked shard (the
  restart resume) reads on to tick 4.

Held against the reference's ``whole`` shards at ticks 2 and 4: the 85
``AggState`` and 29 ``DepGraph`` stacked leaves bit for bit but
``flow_topk.evicted``, a difference of two float32 sums held to the
reference's mass rule (:func:`_evicted_close`, as
``tests/test_torch_history.py``); the column panels (strings, ints and
masks exact, floats rtol 1e-6) and the delta panels (keys, histograms
and digests exact); and the ``at=`` / ``window=`` JSON on the meshes
(floats rtol 1e-6; ``flowstate``'s ``evictedbytes`` by the mass rule).
Held against the port itself: both tick-4 shards equal
``parallel/sharded.state_to_numpy`` / ``dep_to_numpy`` of the live mesh
bit for bit, the resumed delta panels equal the whole pass's,
``at="tick:4"`` rows equal the live rows, ``window="1h"`` topk rows
carry ``errbound``, and windowed p99 is within 5e-4 of the reference's
numpy ``winquant.np_hist_quantiles`` over the live delta of the stacked
monotone leaf, shard-major.
"""

import functools
import pathlib
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.history import winquant as j_wq
from gyeeta_tpu.history.compactor import Compactor as JCompactor
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.parallel import make_mesh as j_make_mesh
from gyeeta_tpu.parallel.shardedrt import ShardedRuntime as JSR
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.history import winquant as t_wq
from gyeeta_tpu_torch.history.compactor import Compactor
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg, sharded
from gyeeta_tpu_torch.parallel.mesh import make_mesh
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
from gyeeta_tpu_torch.query.api import _hex_id
from gyeeta_tpu_torch.sim import ParthaSim
from gyeeta_tpu_torch.utils.config import RuntimeOpts
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_runtime import assert_json_equal

torch.set_num_threads(1)

GEOM = dict(n_hosts=8, svc_capacity=64, task_capacity=64,
            conn_batch=128, resp_batch=256, fold_k=2)
N_SHARDS = 8
T0 = 1.7e9
TICK_SECONDS = 5.0
SVC_REQ = {"subsys": "svcstate", "maxrecs": 100, "sortcol": "qps5s"}
# stored panels of the shard: their at= rows equal the live rows
AT_REQS = {
    "svcstate": SVC_REQ,
    "taskstate": {"subsys": "taskstate", "maxrecs": 200},
    "hoststate": {"subsys": "hoststate"},
    "cpumem": {"subsys": "cpumem"},
    "clusterstate": {"subsys": "clusterstate"},
    "tracereq": {"subsys": "tracereq", "maxrecs": 200},
}
# at= requests held against the reference's at= on its mesh
REF_AT_REQS = dict(AT_REQS, **{
    "topk": {"subsys": "topk", "maxrecs": 50},
    "flowstate": {"subsys": "flowstate", "maxrecs": 200},
    "svcdependency": {"subsys": "svcdependency", "maxrecs": 500},
    "svcsumm": {"subsys": "svcsumm"},
})
# window= requests held against the reference's
WINDOW_REQS = {
    "svcstate": {"subsys": "svcstate", "window": "1h", "maxrecs": 100,
                 "sortcol": "qps5s"},
    "topk": {"subsys": "topk", "window": "1h", "maxrecs": 20},
    "taskstate": {"subsys": "taskstate", "window": "6s", "maxrecs": 200},
    "tracereq": {"subsys": "tracereq", "window": "1h", "maxrecs": 200},
}

_STATE_PATHS = tree_paths(t_agg.init(EngineCfg(**GEOM), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))
_EVICTED = _STATE_PATHS.index("flow_topk.evicted")
_TOPK_COUNTS = _STATE_PATHS.index("flow_topk.counts")


@pytest.fixture(autouse=True, scope="module")
def no_xla_disk_cache():
    """Compile the reference's mesh programs in this process: on this
    jaxlib line a reloaded persistent-cache ``shard_map`` executable can
    crash the process (``tests/conftest.py``)."""
    from jax._src import compilation_cache as jcc
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "")
    jcc.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", old or "")
    jcc.reset_cache()


def _tick_bytes(sim, w, tick):
    """One tick's byte stream of one package's sim and wire."""
    return (sim.conn_frames(256) + sim.resp_frames(512)
            + sim.listener_frames() + sim.task_frames()
            + w.encode_frames_chunked(w.NOTIFY_HOST_STATE,
                                      sim.host_state_records())
            + w.encode_frames_chunked(w.NOTIFY_CPU_MEM_STATE,
                                      sim.cpu_mem_records(
                                          hot_cpu=[tick % 8]))
            + sim.trace_frames(128))


def _factory(cfg, opts):
    return ShardedRuntime(cfg, make_mesh(N_SHARDS, device="cpu"), opts)


def _j_factory(cfg, opts):
    return JSR(cfg, j_make_mesh(N_SHARDS), opts)


def _opts(cls, tmp):
    return cls(journal_dir=str(tmp / "wal"),
               hist_shard_dir=str(tmp / "shards"), hist_window_ticks=2,
               dep_pair_capacity=1024, dep_edge_capacity=512)


def _reference(tmp, bufs):
    """The reference's mesh fed ``bufs`` (names, then a tick each), its
    live JSON at the last tick, and its compactor's one pass."""
    now = [T0]
    jr = JSR(JCfg(**GEOM), j_make_mesh(N_SHARDS), _opts(JOpts, tmp),
             clock=lambda: now[0])
    jr.feed(bufs[0])
    for buf in bufs[1:]:
        jr.feed(buf)
        now[0] += TICK_SECONDS
        jr.run_tick()
    live = {k: jr.query(dict(r)) for k, r in REF_AT_REQS.items()}
    jc = JCompactor(jr.cfg, jr.opts, journal=jr.journal,
                    clock=lambda: now[0], runtime_factory=_j_factory)
    rep = jc.compact_once(seal=True, upto_tick=jr._tick_no)
    return {"jr": jr, "jc": jc, "j_rep": rep, "j_live": live,
            "j_leaves": ([np.asarray(x) for x in jax.tree.leaves(jr.state)],
                         [np.asarray(x) for x in jax.tree.leaves(jr.dep)])}


@functools.lru_cache(maxsize=None)
def run_sharded_history():
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gyt_torch_shist_"))
    j_sim = JSim(n_hosts=8, n_svcs=4, seed=31)
    j_bufs = [j_sim.name_frames()] + [_tick_bytes(j_sim, j_wire, t)
                                      for t in range(4)]
    now = [T0]
    clock = lambda: now[0]  # noqa: E731
    opts = _opts(RuntimeOpts, tmp)
    cfg = EngineCfg(**GEOM)
    srt = ShardedRuntime(cfg, make_mesh(N_SHARDS, device="cpu"), opts,
                         clock=clock)
    out = {"tmp": tmp, "srt": srt, "opts": opts}
    sim = ParthaSim(n_hosts=8, n_svcs=4, seed=31)
    names = sim.name_frames()
    assert names == j_bufs[0]
    srt.feed(names)
    base_resp = srt.delta_leaves()["svc_resp"].copy()

    def drive(ticks):
        for _ in range(ticks):
            buf = _tick_bytes(sim, wire, srt._tick_no)
            assert buf == j_bufs[1 + srt._tick_no]
            srt.feed(buf)
            now[0] += TICK_SECONDS
            srt.run_tick()

    def compactor(shard_dir):
        return Compactor(cfg, opts, journal=srt.journal, clock=clock,
                         shard_dir=str(shard_dir),
                         runtime_factory=_factory)

    drive(2)
    first = compactor(tmp / "resumed")
    out["first"] = first.compact_once(seal=True, upto_tick=srt._tick_no)
    first.close()
    drive(2)
    out["live"] = (sharded.state_to_numpy(srt.state),
                   sharded.dep_to_numpy(srt.dep))
    out["exp_resp"] = (srt.delta_leaves()["svc_resp"]
                       - base_resp).astype(np.float32)
    out["live_json"] = {k: srt.query(dict(r))
                        for k, r in REF_AT_REQS.items()}
    whole = compactor(tmp / "shards")
    out["whole"] = whole
    out["whole_rep"] = whole.compact_once(seal=True,
                                          upto_tick=srt._tick_no)
    resumed = compactor(tmp / "resumed")
    out["resumed"] = resumed
    out["resumed_rep"] = resumed.compact_once(seal=True,
                                              upto_tick=srt._tick_no)
    out.update(_reference(tmp / "ref", j_bufs))
    return out


@pytest.fixture(scope="module")
def run():
    out = run_sharded_history()
    yield out
    for k in ("resumed", "whole", "srt", "jc", "jr"):
        out[k].close()
    run_sharded_history.cache_clear()
    shutil.rmtree(out["tmp"], ignore_errors=True)


def _shard(run, which, tick1=4):
    """The raw shard of compactor ``which`` ending at ``tick1``, loaded
    once a module."""
    key = ("loaded", which, tick1)
    if key not in run:
        c = run[which]
        ent = [e for e in c.store.shards("raw") if e["tick1"] == tick1][0]
        run[key] = c.store.load(ent)
    return run[key]


def test_compaction_windows_and_resume_position(run):
    """The whole pass emits the 2 windows; the resumed compactor starts
    from the first pass's stacked shard (its per-shard WAL triples) and
    emits only the window after it."""
    assert run["first"]["windows"] == 1 and run["first"]["tick"] == 2
    assert run["whole_rep"]["windows"] == 2
    assert run["resumed_rep"]["windows"] == 1
    assert run["whole_rep"]["tick"] == run["resumed_rep"]["tick"] == 4
    assert 0 < run["resumed_rep"]["records"] < run["whole_rep"]["records"]
    assert [(e["tick0"], e["tick1"])
            for e in run["whole"].store.shards("raw")] == [(0, 2), (2, 4)]
    # the stream is fed as host 0, so the WAL is shard_00's alone: the
    # resume position is its [shard, seg, off] triple
    wal = [_shard(run, which)["meta"]["wal"]
           for which in ("whole", "resumed")]
    assert wal[0] == wal[1] and [e[0] for e in wal[0]] == [0]
    assert len(wal[0][0]) == 3


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_stacked_state_leaf_equals_live_mesh(run, i):
    live = run["live"][0][i]
    assert live.shape[0] == N_SHARDS
    for which in ("whole", "resumed"):
        got = _shard(run, which)["state"]
        assert len(got) == len(_STATE_PATHS) == 85
        assert got[i].dtype == live.dtype and got[i].shape == live.shape
        np.testing.assert_array_equal(got[i], live,
                                      err_msg=f"{which} {_STATE_PATHS[i]}")


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_stacked_dep_leaf_equals_live_mesh(run, i):
    live = run["live"][1][i]
    assert live.shape[0] == N_SHARDS
    for which in ("whole", "resumed"):
        got = _shard(run, which)["dep"]
        assert len(got) == len(_DEP_PATHS) == 29
        assert got[i].dtype == live.dtype
        np.testing.assert_array_equal(got[i], live,
                                      err_msg=f"{which} {_DEP_PATHS[i]}")


@pytest.mark.parametrize("panel", sorted(t_wq.DELTA_SPECS))
def test_resumed_delta_panels_equal_whole(run, panel):
    """The resumed compactor's delta base is the stacked shard's
    monotone leaf: its tick-4 delta panel equals the whole pass's, row
    for row. The keys' ids agree; their names do not, since the intern
    table is host state that a shard does not carry and the names were
    folded before the resume point (the flat compactor's resume does
    the same, in both packages)."""
    got = _shard(run, "resumed")["deltas"][panel]
    want = _shard(run, "whole")["deltas"][panel]
    assert len(want["key"]) > 0

    def ids(keys):
        return [k.split(t_wq.KEY_SEP)[0] for k in keys.tolist()]
    assert ids(got["key"]) == ids(want["key"])
    np.testing.assert_array_equal(got["hist"], want["hist"])


@pytest.mark.parametrize("name", sorted(AT_REQS))
def test_at_tick_rows_equal_live(run, name):
    got = run["srt"].query(dict(AT_REQS[name], at="tick:4"))
    want = run["live_json"][name]
    assert got["recs"] == want["recs"]
    assert got["nrecs"] == want["nrecs"] > 0


def test_window_topk_rows_carry_errbound(run):
    tk = run["srt"].query({"subsys": "topk", "window": "1h",
                           "maxrecs": 20})
    assert tk["nrecs"] > 0
    assert all("errbound" in r for r in tk["recs"])


def test_windowed_p99_matches_offline_exact_merge(run):
    """``window=1h`` p99 on the mesh equals the quantile of the live
    delta of the stacked ``resp_win.alltime``, read shard-major, through
    the reference's numpy mirror."""
    srt = run["srt"]
    win = srt.query({"subsys": "svcstate", "window": "1h",
                     "maxrecs": 100})
    key_hi = np.concatenate([st.tbl.key_hi.numpy().reshape(-1)
                             for st in srt.state])
    key_lo = np.concatenate([st.tbl.key_lo.numpy().reshape(-1)
                             for st in srt.state])
    by_id = {s: i for i, s in enumerate(_hex_id(key_hi, key_lo))}
    exp = run["exp_resp"]
    assert exp.shape[0] == N_SHARDS * GEOM["svc_capacity"]
    checked = 0
    for r in win["recs"]:
        i = by_id.get(r["svcid"])
        if i is None or exp[i].sum() == 0:
            continue
        want = float(j_wq.np_hist_quantiles(
            exp[i][None, :], srt.cfg.resp_spec, [0.99])[0, 0]) / 1e3
        assert r["p99resp5s"] == pytest.approx(want, abs=5e-4)
        assert r["p99resp5s"] >= r["p95resp5s"] >= r["p50resp5d"]
        checked += 1
    assert checked >= 8


def test_leaf_of_reads_per_shard_state_as_stacked_leaf(run):
    """The sharded runtime's delta leaves (``winquant.leaf_of`` of each
    shard, in shard order) are the stacked leaf reshaped to rows,
    shard-major, as the reference's ``leaf_of`` reads its stacked
    state."""
    srt = run["srt"]
    stacked = sharded.state_to_numpy(srt.state)
    got = srt.delta_leaves()
    assert sorted(got) == sorted(t_wq.DELTA_SPECS)
    for name, spec in t_wq.DELTA_SPECS.items():
        leaf = stacked[_STATE_PATHS.index(spec.leaf)]
        np.testing.assert_array_equal(got[name],
                                      leaf.reshape(-1, leaf.shape[-1]))


# ------------------------------------------------- against the reference
def _evicted_close(got, ref, mass) -> bool:
    """``flow_topk.evicted`` is a difference of two float32 sums over
    the top-K lanes, so its rounding scales with the top-K mass and
    depends on the order of the sum: the reference's own rule, the
    top-K mass plus ``evicted`` conserved within rtol 1e-5
    (``tests/test_parallel.py``, as ``tests/test_torch_history.py``)."""
    return bool(np.all(np.abs(np.asarray(got, np.float64)
                              - np.asarray(ref, np.float64))
                       <= 1e-5 * np.asarray(mass, np.float64)))


def test_compaction_report_matches_reference(run):
    ref, got = run["j_rep"], run["whole_rep"]
    assert got["windows"] == ref["windows"] == 2
    for k in ("chunks", "records", "tick", "retention_dropped"):
        assert got[k] == ref[k], k
    assert [(e["tick0"], e["tick1"]) for e in run["jc"].store.shards("raw")] \
        == [(e["tick0"], e["tick1"])
            for e in run["whole"].store.shards("raw")]


@pytest.mark.parametrize("tick1", [2, 4])
@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_stacked_state_leaf_equals_reference(run, i, tick1):
    """The port's stacked shard == the reference's sharded compactor's,
    leaf for leaf, at both window ends."""
    got = _shard(run, "whole", tick1)["state"]
    ref = _shard(run, "jc", tick1)["state"]
    assert len(got) == len(ref) == 85
    a, r = got[i], ref[i]
    assert a.dtype == r.dtype and a.shape == r.shape
    assert r.shape[0] == N_SHARDS
    if i == _EVICTED:
        mass = r.astype(np.float64) \
            + ref[_TOPK_COUNTS].astype(np.float64).sum(axis=-1)
        assert _evicted_close(a, r, mass), (a, r, mass)
    else:
        np.testing.assert_array_equal(a, r, err_msg=_STATE_PATHS[i])


@pytest.mark.parametrize("tick1", [2, 4])
@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_stacked_dep_leaf_equals_reference(run, i, tick1):
    got = _shard(run, "whole", tick1)["dep"]
    ref = _shard(run, "jc", tick1)["dep"]
    assert len(got) == len(ref) == 29
    assert got[i].dtype == ref[i].dtype and ref[i].shape[0] == N_SHARDS
    np.testing.assert_array_equal(got[i], ref[i], err_msg=_DEP_PATHS[i])


@pytest.mark.parametrize("tick1", [2, 4])
@pytest.mark.parametrize("subsys", ["svcstate", "hoststate",
                                    "clusterstate", "taskstate", "cpumem",
                                    "tracereq"])
def test_shard_columns_equal_reference(run, subsys, tick1):
    """The shard's column panels (the task panel every slab row of every
    shard, shard-major; the others the mesh's merged columns)."""
    gc, gm = _shard(run, "whole", tick1)["columns"][subsys]
    rc, rm = _shard(run, "jc", tick1)["columns"][subsys]
    np.testing.assert_array_equal(gm, rm)
    assert list(gc) == list(rc) and len(gm) > 0
    for c in rc:
        assert gc[c].dtype == rc[c].dtype, c
        if rc[c].dtype == object:
            assert gc[c].tolist() == rc[c].tolist(), c
        else:
            np.testing.assert_allclose(gc[c], rc[c], rtol=1e-6, atol=0,
                                       err_msg=c)


@pytest.mark.parametrize("tick1", [2, 4])
@pytest.mark.parametrize("panel", sorted(t_wq.DELTA_SPECS))
def test_delta_panels_equal_reference(run, panel, tick1):
    g = _shard(run, "whole", tick1)["deltas"][panel]
    r = _shard(run, "jc", tick1)["deltas"][panel]
    assert set(g) == set(r)
    assert g["key"].tolist() == r["key"].tolist() and len(r["key"]) > 0
    np.testing.assert_array_equal(g["hist"], r["hist"])
    for k in r.get("td", {}):
        np.testing.assert_array_equal(g["td"][k], r["td"][k], err_msg=k)


@pytest.mark.parametrize("tick", [2, 4])
@pytest.mark.parametrize("name", sorted(REF_AT_REQS))
def test_at_tick_json_equals_reference(run, name, tick):
    """``at=`` on the port's mesh == ``at=`` on the reference's, both
    served from their compactors' stacked shards."""
    req = dict(REF_AT_REQS[name], at=f"tick:{tick}")
    got, ref = run["srt"].query(dict(req)), run["jr"].query(dict(req))
    assert got["tick"] == ref["tick"] == tick
    assert ref["nrecs"] > 0
    if name == "flowstate":
        # evictedbytes: the top-K's evicted mass (_evicted_close)
        leaves = _shard(run, "jc", tick)["state"]
        mass = float(leaves[_EVICTED].astype(np.float64).sum()
                     + leaves[_TOPK_COUNTS].astype(np.float64).sum())
        assert len(got["recs"]) == len(ref["recs"])
        for r, g in zip(ref["recs"], got["recs"]):
            assert _evicted_close(g.pop("evictedbytes"),
                                  r.pop("evictedbytes"), mass)
    assert_json_equal(ref, got)


@pytest.mark.parametrize("name", sorted(WINDOW_REQS))
def test_window_json_equals_reference(run, name):
    """``window=`` on the port's mesh == on the reference's: the merged
    window panels and the windowed quantiles from the delta panels."""
    req = WINDOW_REQS[name]
    got, ref = run["srt"].query(dict(req)), run["jr"].query(dict(req))
    assert ref["nrecs"] > 0
    assert_json_equal(ref, got)
