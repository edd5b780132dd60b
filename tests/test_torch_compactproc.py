"""The port's parallel history compaction against the reference's.

One per-shard WAL (two ``shard_NN/`` journals of host-disjoint sims, the
layout ``serve --shards 2`` writes) is compacted by the port's
``ParallelCompactor(device="cpu")`` with one worker process and with
two, and, shard by shard, by the reference's stock ``Compactor`` in this
process (the reference's parallel compactor states that a part is
exactly that: ``gyeeta_tpu/history/compactproc.py``), under a root
manifest the reference's ``PartedShardStore.rebuild_root`` writes.

- The port's parts are the same for any worker count: every state, dep,
  column and delta array equal, and the root manifests' windows equal.
- Leaf by leaf they equal the reference's parts, ``flow_topk.evicted``
  (a difference of two float32 sums) under the reference's conservation
  rule, rtol 1e-5 of the top-K mass (ROADMAP.md §3); the root manifests
  agree on windows, positions and tick.
- ``at=``, ``window=`` and ``tstart`` JSON over the port's parted store
  equals the reference's over its own, and ``at=`` svcstate equals a
  single runtime's live fold of the same stream.
- The guards raise as the reference's do (a flat WAL, more workers than
  WAL shards); a worker that cannot reach CUDA reports the error and the
  pass raises; a worker killed at each boundary leaves the root manifest
  consistent and the retried pass converges (``slow``, as the
  reference marks it).
"""

from __future__ import annotations

import os
import queue

import numpy as np
import pytest
import torch

from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.history import shards as JSH
from gyeeta_tpu.history.compactor import Compactor as JCompactor
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.history import compactproc as t_cp
from gyeeta_tpu_torch.history import shards as TSH
from gyeeta_tpu_torch.history.compactor import Compactor as TCompactor
from gyeeta_tpu_torch.history.compactor import strip_opts
from gyeeta_tpu_torch.history.compactproc import ParallelCompactor
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils import journal as TJ
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_runtime import assert_json_equal

GEOM = dict(n_hosts=8, svc_capacity=64, task_capacity=64, conn_batch=128,
            resp_batch=256, fold_k=2)
OPTS = dict(hist_window_ticks=2, dep_pair_capacity=1024,
            dep_edge_capacity=512)
NSHARDS = 2
TICKS = 4

_STATE_PATHS = tree_paths(t_agg.init(TCfg(**GEOM), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))
_EVICTED = _STATE_PATHS.index("flow_topk.evicted")
_TOPK_COUNTS = _STATE_PATHS.index("flow_topk.counts")

QUERIES = {
    "at_svcstate": {"subsys": "svcstate", "at": f"tick:{TICKS}",
                    "maxrecs": 100, "sortcol": "svcid"},
    "at_hoststate": {"subsys": "hoststate", "at": f"tick:{TICKS}",
                     "maxrecs": 100},
    "at_taskstate": {"subsys": "taskstate", "at": "tick:2",
                     "maxrecs": 100},
    "at_clusterstate": {"subsys": "clusterstate", "at": f"tick:{TICKS}"},
    "at_svcdependency": {"subsys": "svcdependency",
                         "at": f"tick:{TICKS}", "maxrecs": 100},
    "at_topk": {"subsys": "topk", "at": f"tick:{TICKS}", "maxrecs": 20},
    "window_svcstate": {"subsys": "svcstate", "window": "1h",
                        "maxrecs": 100, "sortcol": "svcid"},
    "window_topk": {"subsys": "topk", "window": "1h", "maxrecs": 20},
    "window_taskstate": {"subsys": "taskstate", "window": "1h",
                         "maxrecs": 100},
}


def sims(cls):
    return [cls(n_hosts=4, n_svcs=2, seed=100 + s, host_base=s * 4)
            for s in range(NSHARDS)]


def tick_frames(sim):
    return (sim.conn_frames(128) + sim.resp_frames(256)
            + sim.listener_frames() + sim.task_frames()
            + t_wire.encode_frame(t_wire.NOTIFY_HOST_STATE,
                                  sim.host_state_records()))


def make_sharded_wal(wal: str, ticks: int = TICKS,
                     seal_at: int | None = None) -> int | None:
    """A per-shard WAL without a serving process: per-shard journals,
    host-disjoint sims, chunk tick stamps on the shared cadence — the
    layout ``serve --shards`` writes. ``seal_at``: seal every shard's
    active segment before tick ``seal_at``'s chunk → the largest
    sealed bound (the reference bench's warm bound), else None."""
    bounds = []
    for s, sim in enumerate(sims(TSim)):
        j = TJ.Journal(os.path.join(wal, f"shard_{s:02d}"))
        j.append(sim.name_frames(), hid=s * 4, tick=0)
        for t in range(ticks):
            if t == seal_at:
                bounds.append(j.seal_active())
            j.append(tick_frames(sim), hid=s * 4, tick=t)
        j.close()
    return max(bounds) if bounds else None


def _port_pass(wal, shard_dir, procs, env=None):
    pc = ParallelCompactor(TCfg(**GEOM), TOpts(**OPTS), procs,
                           journal_dir=wal, shard_dir=str(shard_dir),
                           stats=Stats(), device="cpu", env=env)
    try:
        return pc.compact_once(upto_tick=TICKS)
    finally:
        pc.close()


@pytest.fixture(scope="module")
def parted(tmp_path_factory):
    base = tmp_path_factory.mktemp("t_compactproc")
    wal = str(base / "wal")
    make_sharded_wal(wal)
    reps = {p: _port_pass(wal, base / f"sh{p}", p) for p in (1, 2)}
    # the reference's parts: its stock Compactor a WAL shard, in process
    jcfg, jopts = JCfg(**GEOM), JOpts(**OPTS)
    for s, sub in enumerate(TJ.sharded_subdirs(wal)):
        c = JCompactor(jcfg, jopts, journal_dir=str(sub),
                       shard_dir=str(base / "ref" / f"part_{s:02d}"),
                       stats=JStats())
        try:
            c.compact_once(upto_tick=TICKS)
        finally:
            c.close()
    JSH.PartedShardStore(base / "ref", nparts=NSHARDS).rebuild_root()
    # the live oracle: one port runtime folds the union in tick order
    rt = TRuntime(TCfg(**GEOM), TOpts(dep_pair_capacity=1024,
                                      dep_edge_capacity=512), device="cpu")
    try:
        ss = sims(TSim)
        for sim in ss:
            rt.feed(sim.name_frames())
        for _ in range(TICKS):
            for sim in ss:
                rt.feed(tick_frames(sim))
            rt.run_tick()
        control = rt.query({"subsys": "svcstate", "maxrecs": 100,
                            "sortcol": "svcid", "consistency": "strong"})
    finally:
        rt.close()
    # the JSON of every query over each package's parted store
    jrt = JRuntime(jcfg, JOpts(**OPTS, hist_shard_dir=str(base / "ref")))
    trt = TRuntime(TCfg(**GEOM), TOpts(**OPTS,
                                       hist_shard_dir=str(base / "sh1")),
                   device="cpu")
    try:
        ents = TSH.open_shard_store(base / "sh1").shards("raw")
        # a tstart range only the last window's shards sample
        mid = (ents[0]["t1"] + ents[-1]["t1"]) / 2.0
        reqs = dict(QUERIES, tstart_svcstate={
            "subsys": "svcstate", "tstart": mid,
            "tend": ents[-1]["t1"] + 1.0, "maxrecs": 100,
            "sortcol": "svcid"})
        answers = {n: (jrt.query(dict(q)), trt.query(dict(q)))
                   for n, q in reqs.items()}
    finally:
        jrt.close()
        trt.close()
    return {"base": base, "wal": wal, "reps": reps, "control": control,
            "answers": answers}


def _entries(store):
    return [(e["level"], e["tick0"], e["tick1"]) for e in store.shards()]


def test_parallel_bit_identical_any_worker_count(parted):
    s1 = TSH.open_shard_store(parted["base"] / "sh1")
    s2 = TSH.open_shard_store(parted["base"] / "sh2")
    assert isinstance(s1, TSH.PartedShardStore)
    assert isinstance(s2, TSH.PartedShardStore)
    assert _entries(s1) == _entries(s2)
    assert len(s1.shards()) == TICKS // OPTS["hist_window_ticks"]
    for a, b in zip(s1.shards(), s2.shards()):
        assert len(a["parts"]) == len(b["parts"]) == NSHARDS
        for p in range(NSHARDS):
            da = s1.load_part(p, a["parts"][p])
            db = s2.load_part(p, b["parts"][p])
            for i, (x, y) in enumerate(zip(da["state"], db["state"])):
                assert x.dtype == y.dtype and np.array_equal(x, y), \
                    _STATE_PATHS[i]
            for i, (x, y) in enumerate(zip(da["dep"], db["dep"])):
                assert np.array_equal(x, y), _DEP_PATHS[i]
            assert set(da["columns"]) == set(db["columns"])
            for sub in da["columns"]:
                ca, ma = da["columns"][sub]
                cb, mb = db["columns"][sub]
                assert np.array_equal(ma, mb)
                for c in ca:
                    assert ca[c].tolist() == cb[c].tolist(), (sub, c)
            assert set(da["deltas"]) == set(db["deltas"]) != set()
            for n in da["deltas"]:
                assert np.array_equal(da["deltas"][n]["hist"],
                                      db["deltas"][n]["hist"])
                assert da["deltas"][n]["key"].tolist() \
                    == db["deltas"][n]["key"].tolist()
    pos = s1.position()
    assert pos == s2.position() and all(len(p) == 3 for p in pos)
    r1, r2 = parted["reps"][1], parted["reps"][2]
    assert (r1["workers"], r2["workers"]) == (1, 2)
    assert r1["records"] == r2["records"] > 0
    assert r1["windows"] == r2["windows"] == \
        TICKS // OPTS["hist_window_ticks"] * NSHARDS
    # the CPU runs the plain versions: no kernel launches in a worker
    assert set(r2["per_shard"]) == set(range(NSHARDS))
    assert all(v == 0 for v in r2["launches"].values())


def _assert_columns_and_deltas_equal(got, ref) -> None:
    """A port part's columns and delta panels against the reference's
    (identities exact, floats rtol 1e-6, histograms exact)."""
    assert set(got["columns"]) == set(ref["columns"])
    for sub, (rc, rm) in ref["columns"].items():
        gc, gm = got["columns"][sub]
        np.testing.assert_array_equal(gm, rm)
        assert list(gc) == list(rc), sub
        for c in rc:
            assert gc[c].dtype == rc[c].dtype, (sub, c)
            if rc[c].dtype == object:
                assert gc[c].tolist() == rc[c].tolist(), (sub, c)
            else:
                np.testing.assert_allclose(gc[c], rc[c], rtol=1e-6,
                                           atol=0, err_msg=f"{sub}.{c}")
    assert set(got["deltas"]) == set(ref["deltas"]) != set()
    for n, r in ref["deltas"].items():
        g = got["deltas"][n]
        assert g["key"].tolist() == r["key"].tolist()
        np.testing.assert_array_equal(g["hist"], r["hist"])


def test_worker_reports_its_connresp_dispatches(parted, monkeypatch,
                                                tmp_path):
    """Each worker's report counts its replay runtime's conn/resp
    dispatches (the denominator of launches a replayed dispatch): the
    same for any worker count, and equal to the ``fold_all`` calls with
    a conn/resp slab of a stock ``Compactor`` replaying that shard."""
    from gyeeta_tpu_torch.engine import step as t_step

    per = {p: parted["reps"][p]["per_shard"] for p in (1, 2)}
    for s in range(NSHARDS):
        d1, d2 = per[1][s]["dispatches"], per[2][s]["dispatches"]
        assert d1 == d2
        assert d1["connresp_dispatches"] >= d1["slab_dispatches"]
        assert d1["fold_dispatches"] >= d1["connresp_dispatches"] > 0
    fold_all, n = t_step.fold_all, [0]

    def counting(*a, **kw):
        n[0] += kw.get("connresp") is not None
        return fold_all(*a, **kw)

    monkeypatch.setattr(t_step, "fold_all", counting)
    c = TCompactor(TCfg(**GEOM), TOpts(**OPTS),
                   journal_dir=str(TJ.sharded_subdirs(parted["wal"])[0]),
                   shard_dir=str(tmp_path / "stock"), device="cpu")
    try:
        c.compact_once(upto_tick=TICKS)
    finally:
        c.close()
    assert n[0] == per[1][0]["dispatches"]["connresp_dispatches"]


def test_runtime_factory_builds_the_replay_runtime(parted, tmp_path):
    """``Compactor(runtime_factory=)``: the replay runtime is the
    factory's, built once with the side channels stripped, and its
    shards are the stock replay's (here, part 0 of the parted store)."""
    made = []

    def factory(cfg, o):
        made.append(o)
        return TRuntime(cfg, o, device="cpu")

    sub = TJ.sharded_subdirs(parted["wal"])[0]
    c = TCompactor(TCfg(**GEOM), TOpts(**OPTS), journal_dir=str(sub),
                   shard_dir=str(tmp_path / "f"), runtime_factory=factory,
                   device="cpu")
    try:
        rep = c.compact_once(upto_tick=TICKS)
        ents = c.store.shards("raw")
        got = [c.store.load(e) for e in ents]
    finally:
        c.close()
    assert len(made) == 1 and made[0] == strip_opts(TOpts(**OPTS))
    assert rep["windows"] == len(ents) == TICKS // OPTS["hist_window_ticks"]
    want = TSH.open_shard_store(parted["base"] / "sh1")
    for g, e in zip(got, want.shards()):
        w = want.load_part(0, e["parts"][0])
        for i, (x, y) in enumerate(zip(g["state"], w["state"])):
            assert np.array_equal(x, y), _STATE_PATHS[i]
        for i, (x, y) in enumerate(zip(g["dep"], w["dep"])):
            assert np.array_equal(x, y), _DEP_PATHS[i]


def test_warm_pass_resumes_into_the_same_parts(parted, tmp_path):
    """``GYT_COMPACT_WARM_SEQ`` / ``_WARM_TICK``: each worker first
    replays its shard below the warm bound (the first window, sealed on
    its own) into its part; the measured pass resumes from that shard
    and replays only the rest. The parts' state and dep leaves equal a
    cold pass's; their columns and deltas equal the reference's stock
    ``Compactor`` run the same way, a warm bounded pass then a resumed
    one (a resumed replay has not seen the names interned before its
    resume point, so both render those entities by hex id)."""
    wal = str(tmp_path / "wal")
    win = OPTS["hist_window_ticks"]
    warm = make_sharded_wal(wal, seal_at=win)
    assert warm is not None
    rep = _port_pass(wal, tmp_path / "sh", 2,
                     env={"GYT_COMPACT_WARM_SEQ": warm,
                          "GYT_COMPACT_WARM_TICK": win})
    cold = parted["reps"][2]
    assert rep["windows"] == NSHARDS * (TICKS // win - 1)
    assert 0 < rep["records"] < cold["records"]
    for s in range(NSHARDS):
        assert 0 < rep["per_shard"][s]["records"] \
            < cold["per_shard"][s]["records"]
    jcfg, jopts = JCfg(**GEOM), JOpts(**OPTS)
    for s, sub in enumerate(TJ.sharded_subdirs(wal)):
        for bound, upto in ((warm, win), (None, TICKS)):
            c = JCompactor(jcfg, jopts, journal_dir=str(sub),
                           shard_dir=str(tmp_path / "ref"
                                         / f"part_{s:02d}"),
                           stats=JStats(), upto_seq=bound)
            try:
                c.compact_once(upto_tick=upto)
            finally:
                c.close()
    JSH.PartedShardStore(tmp_path / "ref", nparts=NSHARDS).rebuild_root()
    got = TSH.open_shard_store(tmp_path / "sh")
    cold_store = TSH.open_shard_store(parted["base"] / "sh2")
    ref = JSH.open_shard_store(tmp_path / "ref")
    assert _entries(got) == _entries(cold_store) == _entries(ref)
    assert len(got.shards()) == TICKS // win
    for a, b, r in zip(got.shards(), cold_store.shards(), ref.shards()):
        for p in range(NSHARDS):
            da = got.load_part(p, a["parts"][p])
            db = cold_store.load_part(p, b["parts"][p])
            for i, (x, y) in enumerate(zip(da["state"], db["state"])):
                assert x.dtype == y.dtype and np.array_equal(x, y), \
                    _STATE_PATHS[i]
            for i, (x, y) in enumerate(zip(da["dep"], db["dep"])):
                assert np.array_equal(x, y), _DEP_PATHS[i]
            _assert_columns_and_deltas_equal(
                da, ref.load_part(p, r["parts"][p]))


def _part_pairs(parted):
    """(port part, reference part) loaded once a module."""
    if "pairs" not in parted:
        got = TSH.open_shard_store(parted["base"] / "sh2")
        ref = JSH.open_shard_store(parted["base"] / "ref")
        parted["pairs"] = [(got.load_part(p, a["parts"][p]),
                            ref.load_part(p, b["parts"][p]))
                           for a, b in zip(got.shards(), ref.shards())
                           for p in range(NSHARDS)]
    return parted["pairs"]


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_part_state_leaf_equals_reference(parted, i):
    n = 0
    for got, ref in _part_pairs(parted):
        a, r = got["state"][i], ref["state"][i]
        assert a.dtype == r.dtype and a.shape == r.shape
        if i == _EVICTED:
            mass = float(r) + float(ref["state"][_TOPK_COUNTS].sum())
            assert abs(float(a) - float(r)) <= 1e-5 * mass, (a, r, mass)
        else:
            np.testing.assert_array_equal(a, r, err_msg=_STATE_PATHS[i])
        n += 1
    assert n == TICKS // OPTS["hist_window_ticks"] * NSHARDS


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_part_dep_leaf_equals_reference(parted, i):
    for got, ref in _part_pairs(parted):
        a, r = got["dep"][i], ref["dep"][i]
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r, err_msg=_DEP_PATHS[i])


def test_part_columns_and_deltas_equal_reference(parted):
    for got, ref in _part_pairs(parted):
        _assert_columns_and_deltas_equal(got, ref)


def test_root_manifest_equals_reference(parted):
    got = TSH.open_shard_store(parted["base"] / "sh1")
    ref = JSH.open_shard_store(parted["base"] / "ref")
    keys = ("level", "tick0", "tick1", "t0", "t1")
    assert [{k: e[k] for k in keys} for e in got.shards()] \
        == [{k: e[k] for k in keys} for e in ref.shards()]
    assert [[p["file"] for p in e["parts"]] for e in got.shards()] \
        == [[p["file"] for p in e["parts"]] for e in ref.shards()]
    assert got.position() == ref.position()
    assert got.tick() == ref.tick() == TICKS
    assert got.manifest()["layout"] == "parted"


@pytest.mark.parametrize("name", sorted(QUERIES) + ["tstart_svcstate"])
def test_parted_query_json_equals_reference(parted, name):
    ref, got = parted["answers"][name]
    assert got["nrecs"] > 0
    if "window" in name or "tstart" in name:
        assert got["shards"] == ref["shards"] >= 1
    assert_json_equal(ref, got)


def test_parted_at_equals_live_control_fold(parted):
    _ref, got = parted["answers"]["at_svcstate"]
    assert got["recs"] == parted["control"]["recs"]
    assert got["tick"] == TICKS


def test_guards_flat_wal_and_excess_procs(parted, tmp_path):
    flat = tmp_path / "flatwal"
    j = TJ.Journal(flat)
    j.append(b"x" * 64, tick=0)
    j.close()
    with pytest.raises(ValueError, match="SHARDED WAL"):
        ParallelCompactor(TCfg(**GEOM), TOpts(**OPTS), 2,
                          journal_dir=str(flat),
                          shard_dir=str(tmp_path / "s"), device="cpu")
    with pytest.raises(ValueError, match="compact-procs"):
        ParallelCompactor(TCfg(**GEOM), TOpts(**OPTS), NSHARDS + 1,
                          journal_dir=parted["wal"],
                          shard_dir=str(tmp_path / "s2"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the refusal of a host without a GPU")
def test_no_cpu_fallback_without_a_gpu(parted, tmp_path):
    """CUDA by default: the supervisor refuses without a GPU, and a
    worker asked for CUDA reports the error instead of replaying on the
    CPU (the pass then raises naming the missing shards)."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelCompactor(TCfg(**GEOM), TOpts(**OPTS), 1,
                          journal_dir=parted["wal"],
                          shard_dir=str(tmp_path / "s"))
    q = queue.Queue()
    job = (0, str(TJ.sharded_subdirs(parted["wal"])[0]),
           str(tmp_path / "p" / "part_00"), None)
    t_cp._part_group_worker(TCfg(**GEOM), TOpts(**OPTS), [job], TICKS, q,
                            device="cuda")
    kind, _pid, err = q.get_nowait()
    assert kind == "err" and "no CUDA device" in err
    assert not (tmp_path / "p" / "part_00" / TSH.MANIFEST).exists()


@pytest.mark.slow
def test_parallel_sigkill_at_every_worker_boundary(parted, tmp_path):
    """Kill a worker (os._exit(9), no cleanup) right after each shard's
    part lands but before the supervisor publishes: the pass fails
    loudly, the root manifest never names a window every part has not
    emitted, and the retried pass converges to the uninterrupted run."""
    sh = tmp_path / "shk"
    for die_shard in range(NSHARDS):
        with pytest.raises(RuntimeError, match="parallel compaction"):
            _port_pass(parted["wal"], sh, 2,
                       env={"GYT_COMPACT_DIE_SHARD": str(die_shard)})
        store = TSH.PartedShardStore(sh)
        for ent in store.shards():
            for p, pe in enumerate(ent["parts"]):
                assert (store.parts[p].dir / pe["file"]).exists()
        assert _port_pass(parted["wal"], sh, 2)["windows"] >= 0
    ref = TSH.open_shard_store(parted["base"] / "sh1")
    got = TSH.open_shard_store(sh)
    assert _entries(ref) == _entries(got)
    for a, b in zip(ref.shards(), got.shards()):
        for p in range(NSHARDS):
            da = ref.load_part(p, a["parts"][p])
            db = got.load_part(p, b["parts"][p])
            for x, y in zip(da["state"], db["state"]):
                assert np.array_equal(x, y)

