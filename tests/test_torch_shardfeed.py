"""The sharded serving edge and the per-shard WAL, on the CPU.

- :class:`~gyeeta_tpu_torch.net.shardfeed.ShardFeeder` against the
  reference's: the same runs fed, the same counted oldest-first drops
  and gauges, the barrier folding what is queued;
- ``GytServer(shard_ingest=True)`` over a 4-shard ``ShardedRuntime``
  with one of the reference's ``NetAgent``\\ s over loopback TCP: a
  reconnecting agent keeps its sticky host id, so its chunks journal
  into one ``shard_NN/`` subdir and fold into one shard;
- the fleet view: the 4-shard runtime fed the reference's parity stream
  (``tests/test_shardfeed.py``: a flow universe that fits the exact
  top-K) answers as the port's single ``Runtime`` fed the same bytes,
  row for row (``flowstate`` modulo ``evictedbytes``);
- ``ShardedJournal`` writes the reference's ``shard_NN/`` segments byte
  for byte on one fixed clock; both packages' tick-merged readers
  (``read_from``, ``read_sealed_sharded``) yield the same sequence; the
  compactor's walk over the sharded WAL keeps per-shard positions and
  equals a flat replay of the merged stream;
- ``serve --shards 4 --device cpu``: the daemon serves the sharded
  runtime, journals per shard and answers ``shardlist``; without
  ``--device`` it takes CUDA and raises on a machine without one.

No reference runtime is started (nothing of it compiles): the
reference's journal, feeder and agent are plain Python.
"""

import asyncio
import json
import pathlib

import numpy as np
import pytest
import torch

from gyeeta_tpu.net.agent import NetAgent
from gyeeta_tpu.net import shardfeed as j_sf
from gyeeta_tpu.utils import journal as j_jn
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch import server_main as t_main
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.history.compactor import Compactor as TCompactor
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.net import shardfeed as t_sf
from gyeeta_tpu_torch.net.agent import QueryClient
from gyeeta_tpu_torch.net.server import GytServer
from gyeeta_tpu_torch.parallel.mesh import make_mesh
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
from gyeeta_tpu_torch.runtime import Runtime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils import crashguard, journal as t_jn
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats as TStats

torch.set_num_threads(1)

GEOM = dict(n_hosts=16, svc_capacity=256, task_capacity=256,
            conn_batch=256, resp_batch=512, listener_batch=64, fold_k=2)
OPTS = dict(dep_pair_capacity=4096, dep_edge_capacity=4096)
TIMEOUT = 20.0                  # every socket wait, seconds
T0 = 1.7e9


def _rows_json(out, drop=()):
    recs = [{k: v for k, v in r.items() if k not in drop}
            for r in out["recs"]]
    key = lambda r: json.dumps(r, sort_keys=True, default=str)  # noqa
    return json.dumps(sorted(recs, key=key), sort_keys=True, default=str)


# ---------------------------------------------------------- shard feeder
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_shard_feeder_counted_drops_and_barrier(pkg):
    """Queue overflow drops the oldest run of a shard, counted and
    gauged; the barrier feeds what is still queued, in order."""
    mod, Stats = (j_sf, JStats) if pkg == "ref" else (t_sf, TStats)

    class FakeRT:
        n = 4

        def __init__(self):
            self.stats = Stats()
            self.fed = []

        def feed(self, buf, hid=0, conn_id=0):
            self.fed.append((bytes(buf), hid, conn_id))
            return len(buf)

    rt = FakeRT()
    f = mod.ShardFeeder(rt, queue_max_mb=1e-5)     # ~10 bytes
    f.submit(b"a" * 8, hid=1)
    f.submit(b"b" * 8, hid=1, conn_id=3)          # 'a' drops
    f.submit(b"c" * 8, hid=2)
    f.submit(b"d" * 2, hid=6)                     # shard 2: 10 bytes
    assert f.queue_depth() == 3 and f.queue_depth(2) == 2
    assert f.flush_pending() == 3
    assert rt.fed == [(b"b" * 8, 1, 3), (b"c" * 8, 2, 0),
                      (b"d" * 2, 6, 0)]
    c = rt.stats.counters
    assert c.get("shard_ingest_dropped|shard=1") == 1
    assert c.get("shard_ingest_dropped_bytes|shard=1") == 8
    assert rt.stats.gauges["shard_ingest_queue_bytes|shard=2"] == 0.0
    assert f.shard_of(13) == 1


def test_feeders_of_both_packages_agree():
    """One stream of runs through each package's feeder: the same fed
    sequence, counters and gauges."""
    rng = np.random.default_rng(3)
    runs = [(bytes(rng.integers(0, 256, int(n), np.uint8)), int(h))
            for n, h in zip(rng.integers(1, 64, 200),
                            rng.integers(0, 16, 200))]
    out = []
    for mod, Stats in ((j_sf, JStats), (t_sf, TStats)):
        class FakeRT:
            n = 4
            stats = Stats()
            fed = []

            def feed(self, buf, hid=0, conn_id=0):
                self.fed.append((buf, hid, conn_id))

        rt = FakeRT()
        f = mod.ShardFeeder(rt, queue_max_mb=2e-4)
        for i, (buf, h) in enumerate(runs):
            f.submit(buf, hid=h, conn_id=i)
            if i % 37 == 0:
                f.flush_pending()
        f.flush_pending()
        out.append((rt.fed, dict(rt.stats.counters),
                    dict(rt.stats.gauges)))
    assert out[1] == out[0]
    assert any(k.startswith("shard_ingest_dropped") for k in out[1][1])


# ------------------------------------------------------------ serving edge
def _w(coro):
    return asyncio.wait_for(coro, TIMEOUT)


def test_reconnect_lands_on_same_shard(tmp_path):
    """``GytServer(shard_ingest=True)`` puts a queue a shard between
    the conns and the runtime; an agent reconnecting with its machine
    id keeps its host id, so both sessions journal into one shard
    subdir and fold into one shard."""
    async def go():
        opts = TOpts(**OPTS, journal_dir=str(tmp_path / "wal"))
        srt = ShardedRuntime(TCfg(**GEOM), make_mesh(4, device="cpu"),
                             opts)
        srv = GytServer(srt, tick_interval=None, idle_timeout=300.0,
                        hostmap_path=str(tmp_path / "hostmap.json"),
                        shard_ingest=True, shard_queue_mb=4.0)
        try:
            host, port = await _w(srv.start())
            assert srv._feeder is not None \
                and srv._feeder.max_bytes == 4 << 20
            hids = []
            for seed in (5, 6):
                agent = NetAgent(machine_id=0xABCD1234, seed=seed,
                                 n_svcs=3)
                hids.append(await _w(agent.connect(host, port)))
                await _w(agent.send_sweep(n_conn=128, n_resp=128))
                await agent.close()
            assert hids[0] == hids[1]
            shard = srv._feeder.shard_of(hids[0])
            srv._feed_barrier()
            srt.flush()
            srt.journal.fsync()
            per_shard = [sum(1 for _ in t_jn.read_sealed(d, None, None))
                         for d in t_jn.sharded_subdirs(opts.journal_dir)]
            assert len(per_shard) == 4 and per_shard[shard] > 0
            assert sum(per_shard) == per_shard[shard]
            rows = srt.query({"subsys": "shardlist", "sortcol": "shard"})
            nconn = [r["nconn"] for r in sorted(rows["recs"],
                                                key=lambda r: r["shard"])]
            assert nconn[shard] > 0 and sum(nconn) == nconn[shard]
        finally:
            await srv.stop()

    asyncio.run(go())


def _parity_stream():
    sim = TSim(n_hosts=16, n_svcs=2, n_clients=24, seed=77)
    bufs = [sim.name_frames()]
    for _ in range(2):
        bufs.append(sim.conn_frames(256) + sim.resp_frames(512)
                    + sim.listener_frames() + sim.task_frames()
                    + t_wire.encode_frame(t_wire.NOTIFY_HOST_STATE,
                                          sim.host_state_records()))
    return bufs


def test_fleet_view_equals_single_runtime():
    """The reference's fleet-view oracle (``tests/test_shardfeed.py``):
    state, dependency graph and heavy hitters of the 4-shard mesh render
    as the single runtime's fold of the same stream."""
    cfg = TCfg(**GEOM)._replace(topk_capacity=1024)
    srt = ShardedRuntime(cfg, make_mesh(4, device="cpu"), TOpts(**OPTS))
    rt = Runtime(cfg, TOpts(**OPTS), device="cpu")
    try:
        for i, buf in enumerate(_parity_stream()):
            srt.feed(buf)
            rt.feed(buf)
            if i > 0:
                srt.run_tick()
                rt.run_tick()
        for subsys in ("svcstate", "hoststate", "taskstate",
                       "svcdependency", "activeconn", "topk"):
            a = _rows_json(srt.query({"subsys": subsys, "maxrecs": 4000}))
            b = _rows_json(rt.query({"subsys": subsys, "maxrecs": 4000}))
            assert a == b, f"{subsys} diverged"
        a = _rows_json(srt.query({"subsys": "flowstate", "maxrecs": 4000}),
                       drop=("evictedbytes",))
        b = _rows_json(rt.query({"subsys": "flowstate", "maxrecs": 4000}),
                       drop=("evictedbytes",))
        assert a == b, "flowstate diverged"
        # the tick's fleet rollup seeded both column caches
        assert srt.stats.gauges.get("rollup_seconds") is not None
        assert srt.snapshot._cols.peek("__edgeset") is not None
    finally:
        srt.close()
        rt.close()


# ---------------------------------------------------------- per-shard WAL
def _write_sharded(mod, path, stats):
    rng = np.random.default_rng(11)
    j = mod.ShardedJournal(path, 4, segment_max_bytes=1 << 12,
                           fsync_bytes=1 << 30, stats=stats,
                           clock=lambda: T0)     # the writer threads
    #                                              read it too
    for i in range(240):
        j.append(bytes(rng.integers(0, 256, int(rng.integers(8, 200)),
                                    np.uint8)),
                 hid=int(rng.integers(0, 16)), conn_id=i, tick=i // 40)
    j.fsync()
    pos = j.position()
    j.seal_active()
    return j, pos


def test_sharded_journal_bytes_match_reference(tmp_path):
    jj, jpos = _write_sharded(j_jn, tmp_path / "ref", JStats())
    tj, tpos = _write_sharded(t_jn, tmp_path / "port", TStats())
    try:
        assert tpos == jpos and len(tpos) == 4
        assert tj.sealed_upto() == jj.sealed_upto()
        files = sorted(p.relative_to(tmp_path / "ref")
                       for p in (tmp_path / "ref").rglob("*") if p.is_file())
        assert [str(f.parent) for f in files][0] == "shard_00"
        assert files == sorted(p.relative_to(tmp_path / "port")
                               for p in (tmp_path / "port").rglob("*")
                               if p.is_file())
        for f in files:
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "ref" / f).read_bytes(), f
        assert list(tj.read_from(None)) == list(jj.read_from(None))
        mid = [list(p) for p in jpos]
        assert list(tj.read_from(mid)) == list(jj.read_from(mid))
        subs = t_jn.sharded_subdirs(tmp_path / "port")
        assert list(t_jn.read_sealed_sharded(subs)) == list(
            j_jn.read_sealed_sharded(j_jn.sharded_subdirs(tmp_path / "ref")))
        assert tj.gauges().keys() == jj.gauges().keys()
        assert tj.truncate_upto([[1, 0]] * 4) == \
            jj.truncate_upto([[1, 0]] * 4)
    finally:
        tj.close()
        jj.close()


def test_compactor_walks_sharded_wal_in_tick_order(tmp_path):
    """A 2-shard runtime's per-shard WAL → the compactor's tick-merged
    walk into its flat replay runtime: per-shard resume positions, and
    the replayed state equals a flat runtime fed the merged chunk
    stream at the same tick boundaries."""
    geom = dict(n_hosts=8, svc_capacity=64, task_capacity=64,
                conn_batch=128, resp_batch=256, fold_k=2)
    opts = TOpts(dep_pair_capacity=1024, dep_edge_capacity=512,
                 journal_dir=str(tmp_path / "wal"),
                 hist_shard_dir=str(tmp_path / "shards"),
                 hist_window_ticks=2)
    sim = TSim(n_hosts=8, n_svcs=3, seed=7)
    src = ShardedRuntime(TCfg(**geom), make_mesh(2, device="cpu"), opts)
    try:
        src.feed(sim.name_frames(), hid=0)
        for tick in range(4):
            for h in range(2):
                src.feed(sim.conn_frames(200) + sim.resp_frames(300)
                         + sim.listener_frames(), hid=h)
            src.run_tick()
        src.feed(sim.conn_frames(10), hid=1)
        src.flush()
        src.journal.seal_active()
        src.journal.fsync()
    finally:
        src.close()
    hopts = opts._replace(journal_dir=None)
    c = TCompactor(TCfg(**geom), hopts, journal_dir=str(tmp_path / "wal"),
                   device="cpu")
    flat = Runtime(TCfg(**geom), TOpts(dep_pair_capacity=1024,
                                       dep_edge_capacity=512), device="cpu")
    try:
        rep = c.compact_once()
        assert rep["windows"] == 2
        pos = c.store.position()
        assert [p[0] for p in pos] == [0, 1] and len(pos[0]) == 3
        subs = t_jn.sharded_subdirs(tmp_path / "wal")
        for _s, _q, _o, _t, hid, tick, cid, chunk in \
                t_jn.read_sealed_sharded(subs):
            while flat._tick_no < tick:
                flat.run_tick()
            flat.feed(chunk, hid=hid, conn_id=cid)
        flat.flush()
        ent = [e for e in c.store.shards("raw") if e["tick1"] == 4][0]
        got = c.store.load(ent)["state"]
        # the replay runtime ran on to the last chunk's tick (4)
        from gyeeta_tpu_torch.engine import aggstate
        for i, (a, b) in enumerate(zip(
                aggstate.state_to_numpy(c._rt.state),
                aggstate.state_to_numpy(flat.state))):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        assert len(got) == 85
    finally:
        c.close()
        flat.close()


# ----------------------------------------------------------------- daemon
def test_serve_shards_4_on_the_cpu_answers(tmp_path, monkeypatch):
    """``serve --shards 4 --device cpu``: the daemon's runtime is a
    4-shard ``ShardedRuntime`` behind per-shard ingest queues; an
    agent's sweep journals into its shard's subdir and ``shardlist``
    answers over the GYT query edge. Without ``--device`` the daemon
    takes CUDA (and raises here, with no GPU)."""
    monkeypatch.setattr(crashguard, "enable_crash_dumps", lambda p: None)
    cfgf = tmp_path / "gyt.json"
    cfgf.write_text(json.dumps({"engine": GEOM, "runtime": OPTS}))
    argv = ["--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
            "--tick-interval", "0", "--shards", "4",
            "--journal-dir", str(tmp_path / "wal")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_main.Daemon(t_main.parse_args(argv), env={})

    async def go():
        d = t_main.Daemon(t_main.parse_args(argv + ["--device", "cpu"]),
                          env={})
        assert isinstance(d.rt, ShardedRuntime) and d.rt.n == 4
        assert d.srv._feeder is not None
        task = asyncio.create_task(d.run())
        qc = QueryClient()
        try:
            while d.srv._server is None:
                await asyncio.sleep(0.01)
            host, port = d.srv.host, d.srv.port
            agent = NetAgent(seed=3, n_svcs=2)
            hid = await _w(agent.connect(host, port))
            await _w(agent.send_sweep(n_conn=64, n_resp=64))
            await agent.close()
            await _w(qc.connect(host, port))
            out = await _w(qc.query({"subsys": "shardlist",
                                     "consistency": "strong"}))
            assert out["nrecs"] == 4
            rows = {r["shard"]: r for r in out["recs"]}
            assert rows[float(hid % 4)]["nconn"] > 0
            svc = await _w(qc.query({"subsys": "svcstate",
                                     "consistency": "strong"}))
            assert svc["nrecs"] > 0
        finally:
            await qc.close()
            d.stop_event.set()
            await asyncio.wait_for(task, 60)
        subs = [p.name for p in t_jn.sharded_subdirs(tmp_path / "wal")]
        assert subs == [f"shard_{s:02d}" for s in range(4)]
        assert any(pathlib.Path(tmp_path / "wal" / s).glob("gyt_wal_*")
                   for s in subs)

    asyncio.run(go())
