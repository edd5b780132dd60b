"""The port's ``fold_all`` dispatch and 5s tick against the reference.

One "everything" stream: each tick folds every sweep section (listener,
host, task, cpu/mem, trace, ping) and a conn/resp K-slab whose conn
lanes mix plain flows, two-sided service→service flows and split halves
(some paired within a dispatch, some a tick later, some never), in ONE
``fold_all`` dispatch; then the tick: ``td_flush`` → ``classify_pass`` →
``tick_5s`` → ``depgraph.age`` → ``age_tasks`` / ``age_apis`` →
``delete_services`` (tick 1) → ``compact_state`` / ``compact_tasks``.
After every tick all 85 ``AggState`` and all 29 ``DepGraph`` leaves are
held against the reference's.

The reference compiles one ``fold_all`` variant per section-presence
combination, so every tick carries every section: the task sweep of
tick 2 covers a few groups only (same lane count), which lets
``age_tasks`` retire the rest.

Tolerances (those of ``tests/test_torch_fold.py``): integer, bool and
uint32 leaves and the max-merged f32 leaves exact (``svc_state``,
``svc_issue`` and ``resp_hi_bits`` among them); f32 sums rtol 1e-6;
digests rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gyeeta_tpu.engine import aggstate as j_agg, compact as j_cmp, \
    step as j_step
from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.parallel import depgraph as j_dg
from gyeeta_tpu.semantic import derive as j_der
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.engine import aggstate as t_agg, compact as t_cmp, \
    step as t_step
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.semantic import derive as t_der
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import loghist as t_lh

torch.set_num_threads(1)

N_TICKS = 4
K, B = 3, 40          # conn/resp slab: 120 conn lanes a dispatch
PC, EC = 64, 256      # pair chunks of 16 lanes: 7 + an 8-lane remainder
PTTL, ETTL = 1, 2
TASK_AGE, API_AGE = 1, 2
LANES = dict(listener=48, host=16, task=80, cpumem=16, trace=96, ping=16)
SIM_KW = dict(n_hosts=8, n_svcs=4, n_clients=256)
_EXACT_F32 = (".inv.prio", ".svc_td.vmin", ".svc_td.vmax", ".h_bytes")


def _j_cfg():
    return graft._tiny_cfg()._replace(n_hosts=8, task_capacity=128,
                                      api_capacity=256)


def _t_cfg():
    return t_agg.EngineCfg(
        svc_capacity=64, n_hosts=8,
        resp_spec=t_lh.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64),
        hll_p_svc=6, hll_p_global=8, cms_depth=2, cms_width=1 << 10,
        topk_capacity=32, td_capacity=16, task_capacity=128,
        api_capacity=256, conn_batch=64, resp_batch=64, listener_batch=64)


def _decode(wire, buf, sub):
    frames, used = wire.decode_frames(buf)
    assert used == len(buf)
    return np.concatenate([r for s, r in frames if s == sub])


class _Stream:
    """Per-tick sections of one package, from its own sim, wire decode
    and batch builders (the same seed → the same records)."""

    def __init__(self, sim_cls, wire, dec):
        self.sim, self.wire, self.dec = sim_cls(**SIM_KW), wire, dec
        self.late = None            # server halves held for the next tick

    def sections(self, tick):
        sim, w, d = self.sim, self.wire, self.dec
        tasks = _decode(w, sim.task_frames(), w.NOTIFY_AGGR_TASK_STATE)
        if tick == 2:               # a partial sweep: the rest age out
            tasks = tasks[:8]
        pings = np.zeros(8, w.TASK_PING_DT)
        pings["aggr_task_id"] = tasks["aggr_task_id"][-8:]
        pings["host_id"] = tasks["host_id"][-8:]
        out = {
            "listener": d.listener_batch(_decode(
                w, sim.listener_frames(), w.NOTIFY_LISTENER_STATE),
                LANES["listener"]),
            "host": d.host_batch(sim.host_state_records(), LANES["host"]),
            "task": d.task_batch(tasks, LANES["task"]),
            "cpumem": d.cpumem_batch(sim.cpu_mem_records(
                hot_cpu=[tick % 8], hot_mem=[(tick + 3) % 8]),
                LANES["cpumem"]),
            "trace": d.trace_batch(_decode(w, sim.trace_frames(80),
                                           w.NOTIFY_REQ_TRACE),
                                   LANES["trace"]),
            "ping": d.ping_batch(_decode(
                w, w.encode_frames_chunked(w.NOTIFY_TASK_PING, pings),
                w.NOTIFY_TASK_PING), LANES["ping"]),
        }
        cbs, rbs = [], []
        for k in range(K):
            cli, ser = sim.svc_conn_records(8, split_halves=True)
            parts = [sim.conn_records(12), sim.svc_conn_records(4), cli]
            if k < K - 1:
                parts.append(ser)   # paired within this dispatch
            elif tick % 2 == 0:
                self.late = ser     # paired next tick
            if k == 0 and self.late is not None and tick % 2 == 1:
                parts.append(self.late)
            recs = _decode(w, w.encode_frames_chunked(
                w.NOTIFY_TCP_CONN, np.concatenate(parts)), w.NOTIFY_TCP_CONN)
            cbs.append(d.conn_batch(recs, B))
            rbs.append(d.resp_batch(sim.resp_records(B), B))
        out["connresp"] = (cbs, rbs)
        return out


def _doomed(sim):
    """The two services deleted at tick 1 (then re-announced)."""
    gid = sim.glob_ids[0, :2]
    return ((gid >> np.uint64(32)).astype(np.uint32),
            (gid & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _jax_run():
    cfg = _j_cfg()
    stream = _Stream(JSim, j_wire, j_dec)
    fold = jax.jit(lambda s, d, t, secs: j_step.fold_all(cfg, s, d, t,
                                                         **secs))
    health = jax.jit(lambda s, d: j_step.engine_health_vec(cfg, s, d))

    @jax.jit
    def upkeep(st, dep, tick):
        st = j_step.td_flush(cfg, st)
        st = j_der.classify_pass(cfg, st)
        st = j_step.tick_5s(cfg, st)
        dep = j_dg.age(dep, tick, PTTL, ETTL)
        st = j_step.age_tasks(cfg, st, TASK_AGE)
        return j_step.age_apis(cfg, st, API_AGE), dep

    delete = jax.jit(lambda s, hi, lo: j_cmp.delete_services(cfg, s, hi,
                                                              lo))
    compact = jax.jit(lambda s: j_step.compact_tasks(
        cfg, j_cmp.compact_state(cfg, s)))
    st, dep = j_agg.init(cfg), j_dg.init(PC, EC)
    out = {"state": [], "dep": [], "pressure": [], "health": []}
    stack = lambda bs: jax.tree.map(  # noqa: E731
        lambda *x: jnp.asarray(np.stack(x)), *bs)
    for tick in range(N_TICKS):
        secs = {k: (stack(v[0]), stack(v[1])) if k == "connresp"
                else jax.tree.map(jnp.asarray, v)
                for k, v in stream.sections(tick).items()}
        st, dep, p = fold(st, dep, np.int32(tick), secs)
        out["pressure"].append(int(p))
        out["health"].append(np.asarray(health(st, dep)))
        st, dep = upkeep(st, dep, np.int32(tick))
        if tick == 1:
            hi, lo = _doomed(stream.sim)
            st, _ = delete(st, jnp.asarray(hi), jnp.asarray(lo))
        st = compact(st)
        out["state"].append([np.asarray(x) for x in jax.tree.leaves(st)])
        out["dep"].append([np.asarray(x) for x in jax.tree.leaves(dep)])
    out["paths"] = [jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(st)[0]]
    out["dep_paths"] = [jax.tree_util.keystr(p) for p, _ in
                        jax.tree_util.tree_flatten_with_path(dep)[0]]
    return out


def _torch_run():
    cfg = _t_cfg()
    stream = _Stream(TSim, t_wire, t_dec)
    st, dep = t_agg.init(cfg, "cpu"), t_dg.init(PC, EC, "cpu")
    out = {"state": [], "dep": [], "pressure": [], "health": []}
    for tick in range(N_TICKS):
        secs = {k: (t_dec.to_device(v[0], "cpu"),
                    t_dec.to_device(v[1], "cpu")) if k == "connresp"
                else t_dec.to_device(v, "cpu")
                for k, v in stream.sections(tick).items()}
        st, dep, p = t_step.fold_all(cfg, st, dep, tick, **secs)
        assert isinstance(p, torch.Tensor) and p.dim() == 0
        out["pressure"].append(int(p))
        out["health"].append(t_step.engine_health_vec(cfg, st, dep).numpy())
        st = t_step.td_flush(cfg, st)
        st = t_der.classify_pass(cfg, st)
        st = t_step.tick_5s(cfg, st)
        dep = t_dg.age(dep, tick, PTTL, ETTL)
        st = t_step.age_tasks(cfg, st, TASK_AGE)
        st = t_step.age_apis(cfg, st, API_AGE)
        if tick == 1:
            hi, lo = _doomed(stream.sim)
            st, _ = t_cmp.delete_services(
                cfg, st, torch.from_numpy(hi.astype(np.int64)),
                torch.from_numpy(lo.astype(np.int64)))
        st = t_cmp.compact_state(cfg, st)
        st = t_step.compact_tasks(cfg, st)
        out["state"].append(t_agg.state_to_numpy(st))
        out["dep"].append(t_dg.dep_to_numpy(dep))
    return out


@pytest.fixture(scope="module")
def runs():
    return _jax_run(), _torch_run()


def _assert_leaves(paths, ref, got, n):
    assert len(paths) == len(ref) == len(got) == n
    for p, a, b in zip(paths, ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (p, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind != "f" or p.endswith(_EXACT_F32):
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            rtol = 1e-5 if p.startswith(".svc_td") else 1e-6
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=p)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_state_leaves_match_reference(runs, tick):
    ref, got = runs
    _assert_leaves(ref["paths"], ref["state"][tick], got["state"][tick], 85)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_dep_leaves_match_reference(runs, tick):
    ref, got = runs
    _assert_leaves(ref["dep_paths"], ref["dep"][tick], got["dep"][tick], 29)


def test_pressure_and_health_match_reference(runs):
    ref, got = runs
    assert got["pressure"] == ref["pressure"]
    assert len(t_step.HEALTH_KEYS) == len(got["health"][0]) == 23
    for a, b in zip(ref["health"], got["health"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


def test_stream_exercises_every_section(runs):
    """The stream reaches what it claims to test (counts on the port's
    run, which equals the reference's)."""
    ref, got = runs
    at = lambda t, name: got["state"][t][ref["paths"].index(name)]  # noqa: E731,E501
    dat = lambda t, name: got["dep"][t][ref["dep_paths"].index(name)]  # noqa: E731,E501
    assert at(0, ".tbl.n_live") == 32 and at(1, ".tbl.n_live") == 30
    assert at(0, ".task_tbl.n_live") == 64 > at(2, ".task_tbl.n_live") > 0
    assert at(2, ".task_tbl.n_tomb") == 0            # compacted
    assert at(3, ".api_tbl.n_live") > 0
    assert (at(3, ".host_last_tick") == 3).all()
    assert len(np.unique(at(3, ".svc_state"))) >= 3
    assert (at(3, ".cm_cpu_issue") > 0).any() and \
        (at(3, ".cm_mem_issue") > 0).any()
    assert dat(0, ".half_tbl.n_live") > 0            # held for tick 1
    assert dat(1, ".n_paired") > dat(0, ".n_paired") > 0
    assert dat(3, ".n_expired") > 0 and dat(3, ".edge_tbl.n_live") > 0


def _tiny_sections(seed):
    cfg = _t_cfg()
    st = _Stream(TSim, t_wire, t_dec)
    st.sim = TSim(**SIM_KW, seed=seed)
    s = st.sections(0)
    return cfg, (t_dec.to_device(s["connresp"][0], "cpu"),
                 t_dec.to_device(s["connresp"][1], "cpu"))


def test_connresp_fold_all_equals_fold_many_then_dep_fold_many():
    cfg, (cbs, rbs) = _tiny_sections(5)
    st, dep, p = t_step.fold_all(cfg, t_agg.init(cfg, "cpu"),
                                 t_dg.init(PC, EC, "cpu"), 3,
                                 connresp=(cbs, rbs))
    st2 = t_step.fold_many(cfg, t_agg.init(cfg, "cpu"), cbs, rbs)
    dep2 = t_dg.dep_fold_many(t_dg.init(PC, EC, "cpu"), cbs, 3)
    for a, b in zip(t_agg.state_to_numpy(st), t_agg.state_to_numpy(st2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_dg.dep_to_numpy(dep), t_dg.dep_to_numpy(dep2)):
        np.testing.assert_array_equal(a, b)
    assert int(p) == int(t_step.stage_pressure(st2))
    assert float(dep.n_paired) > 0


def test_fold_all_delta_section_raises():
    """The delta section (ported since this test refused it) raises on
    anything but a DeltaBatch, and folds one exactly as
    ``ingest_delta`` does; the section order is the reference's."""
    from gyeeta_tpu_torch.sketch import edgefold as t_ef

    cfg = _t_cfg()
    st, dep = t_agg.init(cfg, "cpu"), t_dg.init(PC, EC, "cpu")
    with pytest.raises(AttributeError):
        t_step.fold_all(cfg, st, dep, 0, delta=object())
    sim = TSim(**SIM_KW)
    ef = t_ef.EdgeFold(t_ef.params_of_cfg(cfg), host_id=0)
    db = t_dec.to_device(t_dec.delta_batch(
        ef.fold_sweep(sim.conn_records(100), sim.resp_records(150)), 256,
        resp_nbuckets=cfg.resp_spec.nbuckets,
        hll_m_svc=1 << cfg.hll_p_svc, hll_m_glob=1 << cfg.hll_p_global),
        "cpu")
    st, dep, p = t_step.fold_all(cfg, t_agg.init(cfg, "cpu"),
                                 t_dg.init(PC, EC, "cpu"), 2, delta=db)
    st2, dep2 = t_step.ingest_delta(cfg, t_agg.init(cfg, "cpu"),
                                    t_dg.init(PC, EC, "cpu"), db, 2)
    for a, b in zip(t_agg.state_to_numpy(st) + t_dg.dep_to_numpy(dep),
                    t_agg.state_to_numpy(st2) + t_dg.dep_to_numpy(dep2)):
        np.testing.assert_array_equal(a, b)
    assert float(st.n_conn) == 100 and int(p) > 0
    assert t_step.FOLD_ALL_ORDER == j_step.FOLD_ALL_ORDER
    assert t_step.HEALTH_KEYS == j_step.HEALTH_KEYS


def test_table_delete_tombstone_compact_match_reference():
    """The table upkeep ``fold_all``'s tick relies on, on its own:
    upsert → delete (with a repeated and an absent key) →
    tombstone_rows → compact, every leaf against the reference's."""
    from gyeeta_tpu.engine import table as j_tbl
    from gyeeta_tpu_torch.engine import table as t_tbl

    rng = np.random.default_rng(21)
    hi = rng.integers(0, 2**32 - 2, 40, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32 - 2, 40, dtype=np.uint64).astype(np.uint32)
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    jt, _ = j_tbl.upsert(j_tbl.init(64), jnp.asarray(hi), jnp.asarray(lo))
    tt, _ = t_tbl.upsert(t_tbl.init(64, "cpu"), t(hi), t(lo))
    dh = np.r_[hi[:6], hi[2], np.uint32(7)]
    dl = np.r_[lo[:6], lo[2], np.uint32(9)]
    jt, jr = j_tbl.delete(jt, jnp.asarray(dh), jnp.asarray(dl))
    tt, tr = t_tbl.delete(tt, t(dh), t(dl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    mask = np.zeros(64, bool)
    mask[::5] = True
    jt, jk = j_tbl.tombstone_rows(jt, jnp.asarray(mask))
    tt, tk = t_tbl.tombstone_rows(tt, torch.from_numpy(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    col = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    jt, jc = j_tbl.compact(jt, {"c": jnp.asarray(col)})
    tc = torch.from_numpy(col.copy())
    tt = t_tbl.compact(tt, (tc,))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc["c"]))
    for name, a, b in zip(tt._fields, jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(
            b.numpy().dtype), err_msg=name)
    assert int(tt.n_tomb) == 0 and 0 < int(tt.n_live) < 40
