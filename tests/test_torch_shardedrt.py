"""The port's ``ShardedRuntime`` against the reference's, fed the same bytes.

One module-scoped pair (:func:`run_sharded_both`): the reference's
``ShardedRuntime(CFG, make_mesh(4), OPTS)`` on four of the 8 virtual CPU
devices and the port's on ``make_mesh(4, device="cpu")``, both with a
per-shard journal and checkpoints, on one clock of 5 s a tick, after the
same CRUD requests (``test_torch_registries.runtime_ops``). The stream
is ``tests/test_shardedrt.py``'s (16 hosts × 3 services, seed 41, three
ticks) with the paths it does not reach added: split conn halves (the
server halves a tick later, so they pair across shards), request
traces, the registry records of ``test_torch_registries
.registry_frames`` and SKETCH_DELTA sweeps of two agents' ``EdgeFold``;
after the last tick (which checkpoints) one more buffer, large enough
to fill a ``(fold_k, B)`` slab on every shard, is fed.

Held against the reference: the tick reports, the CRUD replies, every
shard's 85 ``AggState`` and 29 ``DepGraph`` leaves (integer, bool, u32
and max-merged state exact; f32 sums rtol 1e-6; digests rtol 1e-5;
``flow_topk.evicted`` by the reference's mass rule, ROADMAP.md §3), the
JSON of every subsystem on the strong path (``shardlist`` included;
``flowstate`` modulo ``evictedbytes``) and of the snapshot path, and
checkpoints both ways (either package's 4-shard checkpoint restores in
the other). The port alone: restore + ``replay_journal`` from the
per-shard WAL reproduces the live state bit for bit, a 2×2 mesh equals
the 4-shard run, and the entry points take CUDA unless the CPU is asked
for. The mesh on the card against its CPU run is
``tests/test_torch_mesh_gpu.py`` (no JAX: it runs on the GPU machine).

This module compiles the reference's mesh programs, so it turns the
persistent XLA cache off for itself (:func:`no_xla_disk_cache`).
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
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.parallel import make_mesh as j_make_mesh
from gyeeta_tpu.parallel.shardedrt import ShardedRuntime as JSR
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.parallel import depgraph as t_dg, sharded as t_sh
from gyeeta_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime as TSR
from gyeeta_tpu_torch.query import api as t_api
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import edgefold as t_ef
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_shardedrt import _streams
from test_torch_registries import prime_vips, registry_frames, runtime_ops
from test_torch_runtime import assert_json_equal

torch.set_num_threads(1)

GEOM = dict(n_hosts=16, svc_capacity=256, task_capacity=256,
            conn_batch=256, resp_batch=512, listener_batch=64, fold_k=2)
OPTS = dict(dep_pair_capacity=1024, dep_edge_capacity=512,
            checkpoint_every_ticks=3)
TICK_SECONDS = 5.0
T0 = 1.7e9
SERVED = tuple(sorted(t_api.SERVED)) + ("shardlist",)
# the snapshot path: the reference's snapshot hostlist numbers hosts by
# their position in the concatenated per-shard panels (ROADMAP.md §3),
# so it is held against the port's strong path instead
SNAP_SUBSYS = tuple(s for s in SERVED if s != "hostlist")
_STATE_PATHS = tree_paths(t_agg.init(TCfg(**GEOM), "meta"))
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


def stream():
    """(buffers: names, then one a tick; the buffer after the last
    tick)."""
    bufs = _streams()
    sim = JSim(n_hosts=16, n_svcs=3, seed=5)
    reg = TSim(n_hosts=16, n_svcs=3, seed=9)
    params = t_ef.params_of_cfg(TCfg(**GEOM))
    folds = [t_ef.EdgeFold(params, host_id=h) for h in (1, 2)]
    cli, ser = sim.svc_conn_records(200, split_halves=True)
    late = None
    for i in range(1, len(bufs)):
        delta = folds[i % 2].fold_sweep(sim.conn_records(150),
                                        sim.resp_records(200))
        extra = (registry_frames(reg, j_wire, i - 1)
                 + j_wire.encode_frame(j_wire.NOTIFY_TCP_CONN, cli)
                 + sim.trace_frames(60)
                 + j_wire.encode_frames_chunked(j_wire.NOTIFY_SKETCH_DELTA,
                                                delta))
        if late is not None:
            extra += j_wire.encode_frame(j_wire.NOTIFY_TCP_CONN, late)
        late = ser
        cli, ser = sim.svc_conn_records(200, split_halves=True)
        bufs[i] += extra
    # the post-tick buffer fills a (fold_k, B) slab on every shard
    return bufs, sim.conn_frames(2400) + sim.resp_frames(600)


def _opts(cls, tmp, tag):
    return cls(**OPTS, journal_dir=str(tmp / tag / "wal"),
               checkpoint_dir=str(tmp / tag / "ckpt"))


def _drive(rt, bufs, post, now):
    """Feed every buffer (journaled under hid = its index), tick after
    each but the first, then the post-tick buffer → tick reports."""
    reports = []
    for i, buf in enumerate(bufs):
        rt.feed(buf, hid=i, conn_id=i)
        if i > 0:
            now[0] += TICK_SECONDS
            reports.append(rt.run_tick())
    rt.feed(post, hid=5, conn_id=9)
    rt.flush()
    return reports


@functools.lru_cache(maxsize=None)
def run_sharded_both():
    """The stream through both packages' 4-shard runtimes, once per
    process → dict of the runtimes, reports, CRUD replies, tmp dir."""
    bufs, post = stream()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gyt_torch_srt_"))
    j_now, t_now = [T0], [T0]
    jr = JSR(JCfg(**GEOM), j_make_mesh(4), _opts(JOpts, tmp, "ref"),
             clock=lambda: j_now[0])
    tr = TSR(TCfg(**GEOM), make_mesh(4, device="cpu"),
             _opts(TOpts, tmp, "port"), clock=lambda: t_now[0])
    ops = runtime_ops(TSim(n_hosts=16, n_svcs=3, seed=41))
    j_crud = [jr.query(dict(o)) for o in ops]
    t_crud = [tr.query(dict(o)) for o in ops]
    j_rep = _drive(jr, bufs, post, j_now)
    t_rep = _drive(tr, bufs, post, t_now)
    for rt in (jr, tr):
        rt.journal.fsync()
    prime_vips(tr, prime_vips(jr))
    return {"jr": jr, "tr": tr, "j_rep": j_rep, "t_rep": t_rep,
            "j_crud": j_crud, "t_crud": t_crud, "tmp": tmp,
            "bufs": bufs, "post": post,
            "j_state": [np.asarray(x) for x in
                        jax.tree_util.tree_leaves(jr.state)],
            "j_dep": [np.asarray(x) for x in
                      jax.tree_util.tree_leaves(jr.dep)],
            "t_state": t_sh.state_to_numpy(tr.state),
            "t_dep": t_sh.dep_to_numpy(tr.dep)}


@pytest.fixture(scope="module")
def runs():
    out = run_sharded_both()
    yield out
    out["jr"].close()
    out["tr"].close()


def _leaf_check(path, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (path, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        rtol = 1e-5 if path.startswith("svc_td") else 1e-6
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=path)


def _evicted_close(got, ref, counts):
    """``flow_topk.evicted`` is a difference of two f32 sums (ROADMAP.md
    §3): held to the reference's rule, the top-K mass plus evicted
    conserved within rtol 1e-5, shard by shard."""
    for g, r, c in zip(np.ravel(got), np.ravel(ref), counts):
        assert abs(float(g) - float(r)) <= 1e-5 * (float(r) + c.sum())


# ------------------------------------------------------------ the run
def test_tick_reports_and_crud_match_reference(runs):
    def named(reps):              # each package checkpoints in its dir
        return [{k: pathlib.Path(v).name if k == "checkpoint" else v
                 for k, v in r.items()} for r in reps]

    assert named(runs["t_rep"]) == named(runs["j_rep"])
    assert [r["tick"] for r in runs["t_rep"]] == [1, 2, 3]
    assert "checkpoint" in runs["t_rep"][-1]
    assert runs["t_crud"] == runs["j_crud"]


def test_stream_reaches_every_path(runs):
    tr = runs["tr"]
    c = tr.stats.counters
    for k in ("preagg_delta_records", "fold_dispatches",
              "slab_dispatches", "listener_infos", "cgroup_records"):
        assert c.get(k, 0) > 0, k
    assert sum(float(d.n_paired) for d in tr.dep) > 0
    # every shard folded conn events and holds its own hosts only
    for s, st in enumerate(tr.state):
        assert float(st.n_conn) > 0
        seen = np.nonzero(st.host_last_tick.numpy() >= 0)[0]
        assert len(seen) and (seen % 4 == s).all()


@pytest.mark.parametrize("i", range(len(_STATE_PATHS)), ids=_STATE_PATHS)
def test_state_leaf_matches_reference(runs, i):
    a, b = runs["j_state"][i], runs["t_state"][i]
    if i == _EVICTED:
        assert a.shape == b.shape == (4,) and a.dtype == b.dtype
        _evicted_close(b, a, runs["j_state"][_TOPK_COUNTS])
    else:
        _leaf_check(_STATE_PATHS[i], a, b)


@pytest.mark.parametrize("i", range(len(_DEP_PATHS)), ids=_DEP_PATHS)
def test_dep_leaf_matches_reference(runs, i):
    _leaf_check(_DEP_PATHS[i], runs["j_dep"][i], runs["t_dep"][i])


def _query_equal(ref, got, subsys):
    if subsys == "flowstate":
        counts = [sum(r["bytes"] for r in ref["recs"])]
        for a, b in zip(ref["recs"], got["recs"]):
            _evicted_close([b.pop("evictedbytes")],
                           [a.pop("evictedbytes")], [np.array(counts)])
    assert_json_equal(ref, got, subsys)


@pytest.mark.parametrize("subsys", SERVED)
def test_query_matches_reference(runs, subsys):
    req = {"subsys": subsys, "maxrecs": 2000}
    ref, got = runs["jr"].query(dict(req)), runs["tr"].query(dict(req))
    _query_equal(ref, got, subsys)


@pytest.mark.parametrize("subsys", SNAP_SUBSYS)
def test_snapshot_query_matches_reference(runs, subsys):
    req = {"subsys": subsys, "maxrecs": 2000, "consistency": "snapshot"}
    ref, got = runs["jr"].query(dict(req)), runs["tr"].query(dict(req))
    _query_equal(ref, got, subsys)


def test_snapshot_hostlist_numbers_hosts_by_id(runs):
    tr = runs["tr"]
    snap = tr.query({"subsys": "hostlist", "consistency": "snapshot"})
    assert [r["hostid"] for r in snap["recs"]] == [float(h)
                                                   for h in range(16)]
    assert snap["snaptick"] == 2        # published before tick 3 closed


def test_shardlist_rows(runs):
    out = runs["tr"].query({"subsys": "shardlist", "sortcol": "shard"})
    assert out["nrecs"] == 4
    assert sum(r["nhosts"] for r in out["recs"]) == 16
    assert sum(r["nconn"] for r in out["recs"]) == \
        runs["tr"].rollup_stats()["n_conn"]


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_across_packages(runs, writer):
    """The tick-3 checkpoint of either package's 4-shard runtime
    restores in the other's: the stacked leaves come back equal."""
    tmp = runs["tmp"]
    path = sorted((tmp / writer / "ckpt").glob("gyt_ckpt_*.npz"))[-1]
    if writer == "ref":
        rt = TSR(TCfg(**GEOM), make_mesh(4, device="cpu"), TOpts(**OPTS))
        extra = rt.restore(path)
        got = t_sh.state_to_numpy(rt.state)
    else:
        rt = JSR(JCfg(**GEOM), j_make_mesh(4), JOpts(**OPTS))
        extra = rt.restore(path)
        got = [np.asarray(x) for x in jax.tree_util.tree_leaves(rt.state)]
    try:
        assert extra["tick"] == 3 and len(extra["wal"]) == 4
        with np.load(path) as z:
            want = [z[f"leaf_{i}"] for i in range(len(_STATE_PATHS))]
        for p, a, b in zip(_STATE_PATHS, want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a, err_msg=p)
    finally:
        rt.close()


def test_replay_journal_reproduces_live_state(runs):
    """Restore the tick-3 checkpoint into a fresh 4-shard runtime over a
    copy of the live per-shard WAL, replay it from the checkpoint's
    per-shard positions: the state equals the live one, bit for bit."""
    tmp = runs["tmp"]
    wal = tmp / "replay_wal"
    shutil.copytree(tmp / "port" / "wal", wal)
    assert sorted(p.name for p in wal.iterdir()) == \
        [f"shard_{s:02d}" for s in range(4)]
    rt = TSR(TCfg(**GEOM), make_mesh(4, device="cpu"),
             TOpts(**OPTS, journal_dir=str(wal)))
    try:
        extra = rt.restore(sorted((tmp / "port" / "ckpt")
                                  .glob("gyt_ckpt_*.npz"))[-1])
        rep = rt.replay_journal(extra["wal"])
        assert rep["chunks"] == 1            # the post-tick buffer
        for p, a, b in zip(_STATE_PATHS, runs["t_state"],
                           t_sh.state_to_numpy(rt.state)):
            np.testing.assert_array_equal(b, a, err_msg=p)
    finally:
        rt.close()


# ------------------------------------------------------------ the port
def test_mesh2d_equals_1d(runs):
    """A 2×2 mesh routes the pairing in two stages and reduces over
    both axes: fed the same bytes, its shards, rollup and queries equal
    the 4-shard run's."""
    now = [T0]
    rt = TSR(TCfg(**GEOM), make_mesh2d(2, 2, device="cpu"),
             TOpts(**OPTS), clock=lambda: now[0])
    try:
        for o in runtime_ops(TSim(n_hosts=16, n_svcs=3, seed=41)):
            rt.query(dict(o))
        _drive(rt, runs["bufs"], runs["post"], now)
        for p, a, b in zip(_STATE_PATHS + _DEP_PATHS,
                           runs["t_state"] + runs["t_dep"],
                           t_sh.state_to_numpy(rt.state)
                           + t_sh.dep_to_numpy(rt.dep)):
            np.testing.assert_array_equal(b, a, err_msg=p)
        assert rt.rollup_stats() == runs["tr"].rollup_stats()
        for subsys in ("svcdependency", "topk", "flowstate", "shardlist"):
            req = {"subsys": subsys, "maxrecs": 2000}
            assert_json_equal(runs["tr"].query(dict(req)),
                              rt.query(dict(req)), subsys)
    finally:
        rt.close()


def test_entry_points_take_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is the default and works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSR(TCfg(**GEOM), None, TOpts(**OPTS))
    rt = TSR(TCfg(**GEOM), make_mesh(2, device="cpu"), TOpts(**OPTS))
    try:
        assert {st.n_conn.device.type for st in rt.state} == {"cpu"}
        assert rt.query({"subsys": "shardlist"})["nrecs"] == 2
    finally:
        rt.close()
