"""The port's write-ahead journal and stream capture against the
reference's: ``utils/journal.py`` and ``utils/replay.py``.

Each case runs the same operations through both packages on the same
fixed clock and holds the port to the reference: what reads back, the
positions, the counters and the segment and capture files byte for
byte (the ``GYTWAL01`` and ``GYTREC01`` formats). Through the
runtimes, at ``tests/test_timeview.py``'s geometry: the WAL a port
``Runtime`` writes equals the reference's byte for byte, a WAL written
by either package replays in the other onto the state of a direct fold
(integer and max state exact, f32 sums rtol 1e-6: the rule of
``tests/test_torch_runtime.py``), and a checkpoint → ``restore`` →
``replay_journal`` recovery lands on the uninterrupted run's state.
Every journal is closed in a ``finally``: its writer is a thread.
"""

import functools
import os
import pathlib
import shutil
import struct
import tempfile

import jax
import numpy as np
import pytest
import torch

from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.utils import journal as j_jn, replay as j_rp
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils import journal as t_jn, replay as t_rp
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats as TStats
from gyeeta_tpu_torch.utils.tensor import tree_paths
from test_torch_history import _EVICTED, _TOPK_COUNTS, _evicted_close
from test_torch_runtime import _leaf_check

torch.set_num_threads(1)

GEOM = dict(n_hosts=8, svc_capacity=64, task_capacity=64,
            conn_batch=128, resp_batch=256, fold_k=2)
OPTS = dict(dep_pair_capacity=1024, dep_edge_capacity=512)
T0 = 1.7e9
PKGS = {"ref": (j_jn, JStats), "port": (t_jn, TStats)}


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


def _clock():
    """A fixed clock that ticks 1 ms a call (append times differ, and
    both packages see the same sequence)."""
    t = [T0]

    def clock():
        t[0] += 1e-3
        return t[0]
    return clock


def _files(d) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted(pathlib.Path(d).glob("gyt_wal_*.gytwal"))}


def _both(tmp_path, scenario):
    """Run ``scenario(jn_module, stats_cls, dir, clock)`` through both
    packages → (reference result, port result); each result ends with
    the segment files' bytes."""
    out = {}
    for pkg, (jn, st) in PKGS.items():
        d = tmp_path / pkg
        res = scenario(jn, st, d, _clock())
        out[pkg] = (res, _files(d))
    return out["ref"], out["port"]


# ------------------------------------------------------- WAL file format
def _roundtrip(jn, st_cls, d, clock):
    st = st_cls()
    j = jn.Journal(d, fsync_bytes=1, stats=st, clock=clock)
    try:
        j.append(b"alpha", hid=3, conn_id=9, tick=2)
        j.fsync()
        pos = j.position()
        j.append(b"beta" * 200, hid=7, conn_id=11, tick=5)
        every = list(j.read_from(None))
        after = list(j.read_from(pos))
        j.fsync()
        return (every, after, pos, st.counters["wal_appended_chunks"],
                st.counters["wal_appended_bytes"],
                st.counters["wal_fsyncs"] >= 1)
    finally:
        j.close()


def test_journal_roundtrip_position_and_attribution(tmp_path):
    ref, got = _both(tmp_path, _roundtrip)
    assert got == ref
    every, after = got[0][0], got[0][1]
    assert every == [(3, 2, 9, b"alpha"), (7, 5, 11, b"beta" * 200)]
    assert after == [(7, 5, 11, b"beta" * 200)]
    assert got[0][5]
    assert list(got[1].values())[0][:8] == b"GYTWAL01"


def _torn(jn, st_cls, d, clock):
    j = jn.Journal(d, stats=st_cls(), clock=clock)
    j.append(b"good chunk", hid=1)
    j.close()
    seg = j._segpath(0)
    size0 = seg.stat().st_size
    with open(seg, "ab") as f:        # SIGKILL mid-write: half a header
        f.write(b"\x01\x02\x03\x04")
    st2 = st_cls()
    j2 = jn.Journal(d, stats=st2, clock=clock)
    try:
        truncated = seg.stat().st_size == size0
        j2.append(b"after repair", hid=2)
        return (st2.counters["wal_torn_tail"], truncated,
                [b for _, _, _, b in j2.read_from(None)])
    finally:
        j2.close()


def test_journal_torn_tail_truncated_and_counted(tmp_path):
    ref, got = _both(tmp_path, _torn)
    assert got == ref
    assert got[0] == (1, True, [b"good chunk", b"after repair"])


def _rotation(jn, st_cls, d, clock):
    st = st_cls()
    j = jn.Journal(d, segment_max_bytes=1 << 16, fsync_bytes=1 << 30,
                   stats=st, clock=clock)
    try:
        for i in range(20):
            j.append(bytes([i]) * 8192, hid=i, tick=i // 4)
        j.fsync()
        segs = j.segments()
        n = len(list(j.read_from(None)))
        files = _files(d)
        newest = j.position()[0]
        ndel = j.truncate_upto(newest)
        return (segs, n, st.counters["wal_rotations"], ndel,
                j.segments(), files)
    finally:
        j.close()


def test_journal_rotation_and_truncate_upto(tmp_path):
    ref, got = _both(tmp_path, _rotation)
    assert got == ref
    segs, n, rot, ndel, left, _ = got[0]
    assert len(segs) >= 2 and rot >= 1 and n == 20
    assert ndel == len(segs) - 1 and left == [segs[-1]]


def _seal(jn, st_cls, d, clock):
    j = jn.Journal(d, fsync_bytes=1 << 30, stats=st_cls(), clock=clock)
    try:
        out = []
        j.append(b"a" * 100, hid=1, tick=1)
        j.append(b"b" * 100, hid=2, tick=2)
        out.append((j.seal_active(), j.sealed_upto()))
        j.append(b"c" * 100, hid=3, tick=3)
        j.fsync()
        got = list(jn.read_sealed(d, None, j.sealed_upto()))
        out.append(got)
        out.append(list(jn.read_sealed(d, (got[0][0], got[0][1]),
                                       j.sealed_upto())))
        j.set_truncate_floor(0)
        out.append((j.truncate_upto(j.position()[0]), j.segments()))
        j.set_truncate_floor(1)
        out.append((j.truncate_upto(j.position()[0]), j.segments()))
        j.set_truncate_floor(0)
        out.append(j._truncate_floor)
        seq = j.seal_active()
        out.append((seq, j.seal_active()))
        return out
    finally:
        j.close()


def test_journal_seal_floor_and_sealed_reads(tmp_path):
    ref, got = _both(tmp_path, _seal)
    assert got == ref
    out = got[0]
    assert out[0] == (1, 1)
    assert [g[3] for g in out[1]] == [1, 2]          # hid; active excluded
    assert [g[3] for g in out[2]] == [2]
    assert out[3] == (0, [0, 1]) and out[4] == (1, [1])
    assert out[5] == 1 and out[6][0] == out[6][1]


def _floors(jn, st_cls, d, clock):
    j = jn.Journal(d, segment_max_bytes=1 << 14, fsync_bytes=1 << 30,
                   clock=clock)
    try:
        for i in range(24):
            j.append(b"x" * 4096, hid=i)
        j.seal_active()
        segs = j.segments()
        newest = j.position()[0]
        j.set_truncate_floor(newest, name="compact")
        j.set_truncate_floor(1, name="ship")
        out = [segs, j._truncate_floor, j.truncate_upto(newest),
               j.segments()]
        j.set_truncate_floor(0, name="ship")
        out.append(j._truncate_floor)
        j.set_truncate_floor(newest + 5, name="ship")
        out.append(j._truncate_floor == newest)
        return out
    finally:
        j.close()


def test_named_truncate_floors_pin_unshipped_segments(tmp_path):
    ref, got = _both(tmp_path, _floors)
    assert got == ref
    segs, floor, ndel, left, floor2, binds = got[0]
    assert len(segs) >= 3 and floor == 1 and ndel == 1
    assert 0 not in left and 1 in left and floor2 == 1 and binds


def _gap(jn, st_cls, d, clock):
    """A position whose segment was truncated away resumes at the
    oldest segment, counted; a torn tail ends a sealed read cleanly."""
    st = st_cls()
    j = jn.Journal(d, segment_max_bytes=1 << 14, fsync_bytes=1 << 30,
                   clock=clock)
    try:
        for i in range(40):               # three 64 KiB segments
            j.append(b"y" * 4096, hid=i)
        j.seal_active()
        j.set_truncate_floor(1)
        j.truncate_upto(1)
        first = j.segments()[0]
        resumed = [e[3] for e in jn.read_sealed(d, (0, 8), None,
                                                stats=st)]
    finally:
        j.close()
    seg = d / "gyt_wal_{:08d}.gytwal".format(first)
    seg.write_bytes(seg.read_bytes()[:-100])
    short = [e[3] for e in jn.read_sealed(d, None, None, stats=st)]
    return (resumed, short, st.counters["wal_position_gap"],
            st.counters["wal_torn_tail_read"], jn.dir_segments(d),
            jn.floors_of((3, 77)))


def test_sealed_read_position_gap_and_torn_read(tmp_path):
    ref, got = _both(tmp_path, _gap)
    assert got == ref
    resumed, short, gap, torn, _segs, floor = got[0]
    assert gap == 1 and torn == 1 and floor == 3
    assert len(short) == len(resumed) - 1


def test_concurrent_appends_all_land_in_order(tmp_path):
    """Appends from more threads than cores, with the interpreter
    switching threads every microsecond, while the writer rotates
    segments: every chunk lands once, each thread's in its own order,
    and the counters add up."""
    import sys
    import threading

    n_threads, n_each = 12, 150
    st = TStats()
    j = t_jn.Journal(tmp_path / "wal", segment_max_bytes=1 << 16,
                     fsync_bytes=1 << 14, stats=st)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(t):
            for i in range(n_each):
                j.append(bytes([t]) * (100 + i), hid=t, conn_id=i)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        got = list(j.read_from(None))
    finally:
        sys.setswitchinterval(old)
        j.close()
    assert len(got) == n_threads * n_each
    for t in range(n_threads):
        mine = [(cid, chunk) for hid, _tick, cid, chunk in got if hid == t]
        assert mine == [(i, bytes([t]) * (100 + i)) for i in range(n_each)]
    assert st.counters["wal_appended_chunks"] == n_threads * n_each
    assert st.counters["wal_rotations"] >= 1
    assert st.counters.get("wal_backlog_dropped", 0) == 0


# --------------------------------------------- runtimes: feed → WAL → replay
def _bufs(sim_cls, w):
    sim = sim_cls(n_hosts=8, n_svcs=4, seed=3)
    out = [sim.name_frames()]
    for tick in range(3):
        out.append(sim.conn_frames(256) + sim.resp_frames(512)
                   + sim.listener_frames() + sim.task_frames())
    return out


def _t_leaves(rt):
    return t_agg.state_to_numpy(rt.state), t_dg.dep_to_numpy(rt.dep)


def _j_leaves(rt):
    return ([np.asarray(x) for x in jax.tree.leaves(rt.state)],
            [np.asarray(x) for x in jax.tree.leaves(rt.dep)])


def _feed(rt, bufs, clock_t):
    n = 0
    for i, b in enumerate(bufs):
        # split each buffer: a partial frame journals in the call that
        # completes it
        n += rt.feed(b[:len(b) // 3], hid=i, conn_id=100 + i)
        n += rt.feed(b[len(b) // 3:], hid=i, conn_id=100 + i)
        if i:
            clock_t[0] += 5.0
            rt.run_tick()
    rt.flush()
    rt.journal.fsync()
    return n


@functools.lru_cache(maxsize=None)
def run_wal_both():
    """Both packages' runtimes fed the same bytes with a journal on one
    fixed clock; then each package's runtime replays the OTHER
    package's WAL."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="gyt_torch_wal_"))
    j_bufs, t_bufs = _bufs(JSim, j_wire), _bufs(TSim, t_wire)
    assert j_bufs == t_bufs
    out = {"tmp": tmp}
    clk = {"ref": [T0], "port": [T0]}
    jr = JRuntime(JCfg(**GEOM), JOpts(**OPTS,
                                      journal_dir=str(tmp / "ref")),
                  clock=lambda: clk["ref"][0])
    tr = TRuntime(TCfg(**GEOM), TOpts(**OPTS,
                                      journal_dir=str(tmp / "port")),
                  clock=lambda: clk["port"][0], device="cpu")
    try:
        out["n"] = (_feed(jr, j_bufs, clk["ref"]),
                    _feed(tr, t_bufs, clk["port"]))
        out["direct"] = {"ref": _j_leaves(jr), "port": _t_leaves(tr)}
        out["ctr"] = {"ref": dict(jr.stats.counters),
                      "port": dict(tr.stats.counters)}
    finally:
        jr.close()
        tr.close()
    out["files"] = {"ref": _files(tmp / "ref"),
                    "port": _files(tmp / "port")}
    # cross replays: each package's fresh runtime re-folds the other's
    # WAL (and its own) through replay_journal
    out["replay"] = {}
    for reader, writer in (("ref", "port"), ("port", "ref"),
                           ("port", "port")):
        d = tmp / f"{reader}_reads_{writer}"
        shutil.copytree(tmp / writer, d)
        if reader == "ref":
            rt = JRuntime(JCfg(**GEOM), JOpts(**OPTS, journal_dir=str(d)))
        else:
            rt = TRuntime(TCfg(**GEOM), TOpts(**OPTS, journal_dir=str(d)),
                          device="cpu")
        try:
            # the writer ticked between buffers: replay ticks at each
            # chunk's tick stamp, as the compactor does
            rep = {"chunks": 0, "records": 0}
            rt._journal_replaying = True
            for hid, tick, cid, chunk in rt.journal.read_from(None):
                while rt._tick_no < tick:
                    rt.run_tick()
                rep["records"] += rt.feed(chunk, hid=hid, conn_id=cid)
                rep["chunks"] += 1
            rt._journal_replaying = False
            while rt._tick_no < 3:        # the writer's last tick
                rt.run_tick()
            rt.flush()
            out["replay"][(reader, writer)] = (
                rep, _j_leaves(rt) if reader == "ref" else _t_leaves(rt),
                rt.stats.counters.get("wal_appended_chunks", 0))
        finally:
            rt.close()
    return out


@pytest.fixture(scope="module")
def wal_runs():
    out = run_wal_both()
    yield out
    run_wal_both.cache_clear()
    shutil.rmtree(out["tmp"], ignore_errors=True)


def test_runtime_wal_bytes_equal_reference(wal_runs):
    """With one fixed clock the port's runtime writes the reference's
    WAL byte for byte: the same accepted chunks, cut at the same frame
    boundaries, with the same attribution and tick stamps."""
    ref, got = wal_runs["files"]["ref"], wal_runs["files"]["port"]
    assert list(got) == list(ref) and got == ref
    assert wal_runs["n"][0] == wal_runs["n"][1]
    for k in ("wal_appended_chunks", "wal_appended_bytes"):
        assert wal_runs["ctr"]["port"][k] == wal_runs["ctr"]["ref"][k], k


_STATE_PATHS = tree_paths(t_agg.init(TCfg(**GEOM), "meta"))
_DEP_PATHS = tree_paths(t_dg.init(1, 1, "meta"))


@pytest.mark.parametrize("reader,writer", [("ref", "port"),
                                           ("port", "ref"),
                                           ("port", "port")])
def test_wal_replays_across_packages(wal_runs, reader, writer):
    """A WAL written by one package, replayed by the other (or itself),
    re-folds every record onto the reader's direct-fold state: exact
    within a package, the parity rule across packages. Replay appends
    nothing."""
    rep, (state, dep), appended = wal_runs["replay"][(reader, writer)]
    assert rep["records"] == wal_runs["n"][0] and appended == 0
    own_s, own_d = wal_runs["direct"][reader]
    for a, b in zip(state + dep, own_s + own_d):
        np.testing.assert_array_equal(a, b)
    ref_s, ref_d = wal_runs["direct"]["ref"]
    for i, (path, a, b) in enumerate(zip(_STATE_PATHS + _DEP_PATHS,
                                         ref_s + ref_d, state + dep)):
        if i == _EVICTED:
            mass = float(a) + float(ref_s[_TOPK_COUNTS].sum())
            assert _evicted_close(float(b), float(a), mass), (a, b)
        else:
            _leaf_check(path, a, b)


def _ckpt_run(pkg, tmp):
    """The reference's checkpoint-position case on one package: a
    checkpoint records the fsynced WAL position; restore + replay from
    it re-folds only the post-checkpoint window, and the post-save
    truncation ran."""
    Rt, Opts, Cfg, Sim = ((JRuntime, JOpts, JCfg, JSim) if pkg == "ref"
                          else (TRuntime, TOpts, TCfg, TSim))
    extra = {"device": "cpu"} if pkg == "port" else {}
    sim = Sim(n_hosts=2, n_svcs=2, seed=4)
    opts = Opts(**OPTS, journal_dir=str(tmp / "wal"),
                checkpoint_dir=str(tmp / "ck"), checkpoint_every_ticks=1)
    rt = Rt(Cfg(**GEOM), opts, clock=lambda: T0, **extra)
    rt2 = None
    try:
        rt.feed(sim.conn_frames(64), hid=0, conn_id=1)
        report = rt.run_tick()
        n_mid = float(rt.state.n_conn)
        n_post = rt.feed(sim.conn_frames(32), hid=1, conn_id=1)
        rt.flush()
        rt.journal.fsync()
        want = float(rt.state.n_conn)
        rt2 = Rt(Cfg(**GEOM), opts._replace(checkpoint_dir=None),
                 clock=lambda: T0, **extra)
        ext = rt2.restore(report["checkpoint"])
        rep = rt2.replay_journal(ext.get("wal"))
        rt2.flush()
        return (pathlib.Path(report["checkpoint"]).name, ext, rep,
                float(rt2.state.n_conn), want, n_mid, n_post,
                rt2.stats.counters["wal_replayed_chunks"],
                rt2.stats.counters["wal_replayed_records"],
                rt2._pending)
    finally:
        rt.close()
        if rt2 is not None:
            rt2.close()


def test_checkpoint_position_bounds_replay_like_reference(tmp_path):
    ref = _ckpt_run("ref", tmp_path / "ref")
    got = _ckpt_run("port", tmp_path / "port")
    assert got == ref
    name, ext, rep, n2, want, n_mid, n_post, nch, nrec, pend = got
    assert ext["wal"] and ext["tick"] == 1
    assert n2 == want > n_mid and nch == 1 and nrec == n_post
    assert rep == {"chunks": 1, "records": n_post} and pend == b""


def test_clean_shutdown_leaves_empty_wal_window(tmp_path):
    """Close (fsync) → a checkpoint at the journal's end → truncate:
    a restore replays zero chunks."""
    sim = TSim(n_hosts=2, n_svcs=2, seed=5)
    opts = TOpts(**OPTS, journal_dir=str(tmp_path / "wal"))
    rt = TRuntime(TCfg(**GEOM), opts, device="cpu")
    rt.feed(sim.conn_frames(64), hid=0, conn_id=1)
    rt.flush()
    rt.close()
    extra = t_jn.checkpoint_extra(rt, rt._tick_no)
    path = tmp_path / "gyt_final_00000000.npz"
    from gyeeta_tpu_torch.utils import checkpoint as t_ckpt
    t_ckpt.save(path, rt.cfg, rt.state, extra=extra)
    assert t_jn.post_checkpoint_truncate(rt, extra) == 0
    rt2 = TRuntime(TCfg(**GEOM), opts, device="cpu")
    try:
        ext = rt2.restore(path)
        rep = rt2.replay_journal(ext["wal"])
        assert rep == {"chunks": 0, "records": 0}
        assert float(rt2.state.n_conn) == float(rt.state.n_conn) > 0
    finally:
        rt2.close()


def test_sweep_seq_high_water_mark_checkpointed(tmp_path):
    got = {}
    for pkg, Rt, Opts, Cfg, w, extra in (
            ("ref", JRuntime, JOpts, JCfg, j_wire, {}),
            ("port", TRuntime, TOpts, TCfg, t_wire, {"device": "cpu"})):
        rt = Rt(Cfg(**GEOM), Opts(**OPTS,
                                  journal_dir=str(tmp_path / pkg)),
                **extra)
        try:
            rec = np.zeros(1, w.SWEEP_SEQ_DT)
            for hid, seq in ((1, 3), (1, 7), (2, 5), (1, 6)):
                rec["host_id"], rec["seq"] = hid, seq
                rt.feed(w.encode_frame(w.NOTIFY_SWEEP_SEQ, rec))
            ext = (j_jn if pkg == "ref" else t_jn).checkpoint_extra(
                rt, tick=4)
            got[pkg] = (dict(rt._sweep_last_seq), ext,
                        tuple(ext["wal"]) == rt.journal.position())
        finally:
            rt.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == {1: 7, 2: 5}
    assert got["port"][1]["sweep_seq"] == {"1": 7, "2": 5}


def test_replay_after_restore_equals_uninterrupted_run(tmp_path):
    """The recovery path: a checkpoint at the last tick, more feeds, a
    crash (the writer aborted after its last fsync); a fresh runtime
    restores the checkpoint and replays the WAL from its position → the
    uninterrupted run's 85 state leaves. The dependency graph is not
    checkpointed (the reference's design: it rebuilds from traffic), so
    its 29 leaves are held against a runtime that restored the same
    checkpoint and was fed the post-checkpoint bytes directly."""
    bufs = _bufs(TSim, t_wire)
    opts = TOpts(**OPTS, journal_dir=str(tmp_path / "wal"),
                 checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every_ticks=3)
    rt = TRuntime(TCfg(**GEOM), opts, clock=lambda: T0, device="cpu")
    try:
        for i, b in enumerate(bufs):
            rt.feed(b, hid=i)
            if i:
                rep = rt.run_tick()
        ck = rep["checkpoint"]
        post = bufs[1][:5000], bufs[1][5000:]
        n_post = sum(rt.feed(b, hid=9) for b in post)
        rt.flush()
        rt.journal.fsync()
        want = _t_leaves(rt)
        tick = rt._tick_no
    finally:
        rt.journal.abort()                # the crash: no more syncs
        rt.close()
    ropts = opts._replace(checkpoint_dir=None)
    rt2 = TRuntime(TCfg(**GEOM), ropts, clock=lambda: T0, device="cpu")
    rt3 = TRuntime(TCfg(**GEOM), ropts._replace(journal_dir=None),
                   clock=lambda: T0, device="cpu")
    try:
        ext = rt2.restore(ck)
        assert ext["tick"] == tick == 3
        rep = rt2.replay_journal(ext["wal"])
        assert rep["records"] == n_post > 0 and rt2._tick_no == tick
        rt3.restore(ck)
        for b in post:
            rt3.feed(b)
        rt3.flush()
        got, direct = _t_leaves(rt2), _t_leaves(rt3)
        for path, a, b in zip(_STATE_PATHS, want[0], got[0]):
            np.testing.assert_array_equal(b, a, err_msg=path)
        for path, a, b in zip(_DEP_PATHS, direct[1], got[1]):
            np.testing.assert_array_equal(b, a, err_msg=path)
    finally:
        rt2.close()
        rt3.close()


# ------------------------------------------------------- capture/replay
def test_gytrec_bytes_and_torn_tail_match_reference(tmp_path):
    sim = TSim(n_hosts=2, n_svcs=2, seed=1)
    chunks = [sim.conn_frames(16), b"A" * 100, sim.resp_frames(16)]
    for pkg, rp in (("ref", j_rp), ("port", t_rp)):
        rec = rp.StreamRecorder(tmp_path / f"{pkg}.gytrec",
                                clock=_clock())
        for c in chunks:
            rec.write(c)
        rec.write(b"")
        rec.close()
    data = (tmp_path / "port.gytrec").read_bytes()
    assert data == (tmp_path / "ref.gytrec").read_bytes()
    assert data[:8] == b"GYTREC01"
    cap = tmp_path / "cut.gytrec"
    # cut mid-payload of the last chunk, and mid-header of the first
    for cut, want in ((len(data) - 40, chunks[:2]), (13, [])):
        cap.write_bytes(data[:cut])
        out = {}
        for pkg, rp, st_cls in (("ref", j_rp, JStats),
                                ("port", t_rp, TStats)):
            st = st_cls()
            got = [c for _, c in rp.read_chunks(cap, stats=st)]
            fed = []
            n = rp.play(cap, fed.append, stats=st)
            out[pkg] = (got, fed, n, st.counters["replay_torn_tail"])
        assert out["port"] == out["ref"]
        assert out["port"][0] == want and out["port"][3] == 2


def test_recorder_fsync_on_chunk_flag(tmp_path, monkeypatch):
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd),
                                                 real_fsync(fd))[1])
    rec = t_rp.StreamRecorder(tmp_path / "a.gytrec", fsync=True)
    rec.write(b"x" * 10)
    rec.write(b"y" * 10)
    rec.close()
    assert len(calls) == 2
    rec2 = t_rp.StreamRecorder(tmp_path / "b.gytrec")
    rec2.write(b"x" * 10)
    rec2.close()
    assert len(calls) == 2


def test_complete_prefix_matches_reference():
    sim = TSim(n_hosts=2, n_svcs=2, seed=1)
    buf = sim.conn_frames(32) + sim.resp_frames(32)
    for b in (buf, buf[:-5], b"", buf[:10], buf[:200]):
        assert t_wire.complete_prefix(b) == j_wire.complete_prefix(b)
    assert t_wire.complete_prefix(buf) == len(buf)
    assert t_wire.complete_prefix(buf[:-5]) < len(buf) - 5
    bad_size = struct.pack("<II", t_wire.MAGIC_PM, 4) + bytes(24)
    for bad in (b"\x00" * 32, bad_size):
        for w in (t_wire, j_wire):
            with pytest.raises(w.FrameError):
                w.complete_prefix(bad)


def test_remap_host_ids_and_paced_chunks_match_reference(tmp_path):
    sim = TSim(n_hosts=2, n_svcs=2, seed=9)
    buf = (t_wire.encode_frame(t_wire.NOTIFY_HOST_STATE,
                               sim.host_state_records())
           + sim.conn_frames(24) + sim.name_frames())
    assert t_rp.remap_host_ids(buf, 4) == j_rp.remap_host_ids(buf, 4)
    assert t_rp.remap_host_ids(buf, 4) != buf
    cap = tmp_path / "h.gytrec"
    rec = t_rp.StreamRecorder(cap, clock=_clock())
    # frames cut across chunk boundaries reassemble before the remap
    rec.write(buf[:50])
    rec.write(buf[50:333])
    rec.write(buf[333:])
    rec.close()
    got = list(t_rp.paced_chunks(cap, host_id_offset=4))
    assert got == list(j_rp.paced_chunks(cap, host_id_offset=4))
    assert b"".join(c for _, c in got) == t_rp.remap_host_ids(buf, 4)


def test_replay_host_remap_into_runtimes(tmp_path):
    """host_id translation relocates a capture onto more hosts, in both
    packages' runtimes."""
    sim = TSim(n_hosts=2, n_svcs=2, seed=9)
    cap = tmp_path / "h.gytrec"
    rec = t_rp.StreamRecorder(cap, clock=lambda: 1.0)
    rec.write(t_wire.encode_frame(t_wire.NOTIFY_HOST_STATE,
                                  sim.host_state_records()))
    rec.close()
    seen = {}
    for pkg, rt in (("ref", JRuntime(JCfg(**GEOM), JOpts(**OPTS))),
                    ("port", TRuntime(TCfg(**GEOM), TOpts(**OPTS),
                                      device="cpu"))):
        try:
            rp = j_rp if pkg == "ref" else t_rp
            n = rp.play(cap, rt.feed) + rp.play(cap, rt.feed,
                                                host_id_offset=4)
            rt.flush()
            last = np.asarray(rt.state.host_last_tick)
            seen[pkg] = (n, set(np.nonzero(last >= 0)[0].tolist()))
        finally:
            rt.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] == {0, 1, 4, 5}


def test_record_replay_equivalence(tmp_path):
    """A capture of a stream cut mid-frame, played into a runtime,
    answers svcstate with the direct feed's counts (the contract of the
    reference's ``tests/test_replay.py``). Port only: under parallel
    load the reference's own runtime miscounts this stream (ROADMAP.md
    §3)."""
    bufs = _bufs(TSim, t_wire)
    cap = tmp_path / "cap.gytrec"
    rec = t_rp.StreamRecorder(cap, clock=_clock())
    for b in bufs:
        rec.write(b[:777])
        rec.write(b[777:])
    rec.close()
    rt = TRuntime(TCfg(**GEOM), TOpts(**OPTS), clock=lambda: T0,
                  device="cpu")
    direct = TRuntime(TCfg(**GEOM), TOpts(**OPTS), clock=lambda: T0,
                      device="cpu")
    try:
        assert t_rp.play(cap, rt.feed) == sum(map(len, bufs))
        for b in bufs:
            direct.feed(b)
        rt.run_tick()
        direct.run_tick()
        q = {"subsys": "svcstate", "maxrecs": 64}
        got, live = rt.query(dict(q)), direct.query(dict(q))
    finally:
        rt.close()
        direct.close()
    assert got["ntotal"] == live["ntotal"] == 32
    by_id = {r["svcid"]: r for r in live["recs"]}
    for r in got["recs"]:
        assert r["nqry5s"] == by_id[r["svcid"]]["nqry5s"]
