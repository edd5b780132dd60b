"""The port's fold slice against the JAX reference, leaf by leaf.

Both packages get the same sim stream (same seed → byte-identical wire
frames) at ``__graft_entry__._tiny_cfg()`` geometry, each through its
own wire decode and batch builders, and fold it with their own
``fold_step`` / ``fold_many`` / ``td_flush_partial`` / ``td_flush`` /
``tick_5s``. The port runs on the CPU, where each kernel wrapper takes
its plain PyTorch version.

Tolerances (``_assert_leaves``): integer, bool and uint32 leaves and the
max-merged f32 leaves (invertible priorities, digest min/max) must be
equal. f32 sums (counters, loghists, CMS, top-K counts) match within
rtol 1e-6, the reference's own bar for its scatter-add kernel: XLA and
PyTorch reduce whole-array sums in different orders. t-digest
means/weights match within rtol 1e-5: the compression's sort order is
exact but its cumulative and segment sums are not taken in the same
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gyeeta_tpu.engine import aggstate as j_agg, step as j_step
from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.query import readback as j_rb
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.engine import aggstate as t_agg, step as t_step
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.query import readback as t_rb
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import loghist as t_lh

torch.set_num_threads(1)

K = 4          # microbatches per fold_many dispatch
N_DISPATCH = 3


def _tiny_cfg(**kw):
    """The port's copy of ``__graft_entry__._tiny_cfg()``."""
    return t_agg.EngineCfg(
        svc_capacity=64, n_hosts=16,
        resp_spec=t_lh.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64),
        hll_p_svc=6, hll_p_global=8, cms_depth=2, cms_width=1 << 10,
        topk_capacity=32, td_capacity=16,
        conn_batch=64, resp_batch=64, listener_batch=64)._replace(**kw)


def _leaf_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


_EXACT_F32 = (".inv.prio", ".svc_td.vmin", ".svc_td.vmax")


def _assert_leaves(paths, ref, got):
    assert len(ref) == len(got) == 85
    for p, a, b in zip(paths, ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (p, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind != "f" or p.endswith(_EXACT_F32):
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            rtol = 1e-5 if p.startswith(".svc_td") else 1e-6
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=p)


def _batches(sim, wire, dec, cfg, n):
    """n (conn, resp) microbatch pairs: sim → wire frames → decode."""
    out = []
    for _ in range(n):
        frames, used = wire.decode_frames(
            sim.conn_frames(cfg.conn_batch) + sim.resp_frames(cfg.resp_batch))
        assert used and [s for s, _ in frames] == [
            wire.NOTIFY_TCP_CONN, wire.NOTIFY_RESP_SAMPLE]
        out.append((dec.conn_batch(frames[0][1], cfg.conn_batch),
                    dec.resp_batch(frames[1][1], cfg.resp_batch)))
    return out


def _jax_run(budget):
    """The reference slice; returns every stage's leaves."""
    cfg = graft._tiny_cfg()
    if budget is not None:
        cfg = cfg._replace(topk_budget=budget)
    sim = JSim(n_hosts=cfg.n_hosts, n_svcs=4, n_clients=256)
    stack = lambda bs: jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *bs)  # noqa: E731,E501
    st = j_agg.init(cfg)
    out = {"init": [np.asarray(x) for x in jax.tree_util.tree_leaves(st)],
           "paths": _leaf_paths(st)}
    (cb, rb), = _batches(sim, j_wire, j_dec, cfg, 1)
    st = jax.jit(lambda s, c, r: j_step.fold_step(cfg, s, c, r))(st, cb, rb)
    out["fold_step"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]
    many = jax.jit(lambda s, c, r: j_step.fold_many(cfg, s, c, r))
    for _ in range(N_DISPATCH):
        bs = _batches(sim, j_wire, j_dec, cfg, K)
        st = many(st, stack([c for c, _ in bs]), stack([r for _, r in bs]))
    st = jax.jit(lambda s: j_step.td_flush_partial(cfg, s))(st)
    st = jax.jit(lambda s: j_step.td_flush(cfg, s))(st)
    st = jax.jit(lambda s: j_step.tick_5s(cfg, s))(st)
    out["final"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]
    out["svc_rows"] = j_rb.svc_rows_to_host(cfg, j_rb.svc_snapshot(cfg, st, 0))
    out["flow"] = {k: np.asarray(v)
                   for k, v in j_rb.flow_snapshot(cfg, st, 16).items()}
    return cfg, out


def _torch_run(budget):
    cfg = _tiny_cfg() if budget is None else _tiny_cfg(topk_budget=budget)
    sim = TSim(n_hosts=cfg.n_hosts, n_svcs=4, n_clients=256)
    st = t_agg.init(cfg, device="cpu")
    out = {"init": t_agg.state_to_numpy(st)}
    (cb, rb), = _batches(sim, t_wire, t_dec, cfg, 1)
    st = t_step.fold_step(cfg, st, t_dec.to_device(cb, "cpu"),
                          t_dec.to_device(rb, "cpu"))
    out["fold_step"] = t_agg.state_to_numpy(st)
    for _ in range(N_DISPATCH):
        bs = _batches(sim, t_wire, t_dec, cfg, K)
        st = t_step.fold_many(cfg, st,
                              t_dec.to_device([c for c, _ in bs], "cpu"),
                              t_dec.to_device([r for _, r in bs], "cpu"))
    st = t_step.td_flush_partial(cfg, st)
    st = t_step.td_flush(cfg, st)
    st = t_step.tick_5s(cfg, st)
    out["final"] = t_agg.state_to_numpy(st)
    out["state"] = st
    out["svc_rows"] = t_rb.svc_rows_to_host(cfg, t_rb.svc_snapshot(cfg, st, 0))
    out["flow"] = {k: v.numpy()
                   for k, v in t_rb.flow_snapshot(cfg, st, 16).items()}
    return cfg, out


# None: the tiny geometry's default budget (2048 ≥ the lanes, so every
# lane enters top-K); 16: the budgeted candidate selection of
# step.ingest_conn, whose −1 scores on padding and cold lanes tie
@pytest.fixture(scope="module", params=[None, 16], ids=["budget_all", "budget16"])
def runs(request):
    return _jax_run(request.param), _torch_run(request.param)


def test_cfg_repr_matches_reference():
    assert repr(_tiny_cfg()) == repr(graft._tiny_cfg())
    assert repr(t_agg.EngineCfg()) == repr(j_agg.EngineCfg())


def test_init_leaves_match_reference(runs):
    (_, ref), (_, got) = runs
    _assert_leaves(ref["paths"], ref["init"], got["init"])


def test_fold_step_matches_reference(runs):
    (_, ref), (_, got) = runs
    _assert_leaves(ref["paths"], ref["fold_step"], got["fold_step"])


def test_fold_many_flush_tick_match_reference(runs):
    (_, ref), (_, got) = runs
    _assert_leaves(ref["paths"], ref["final"], got["final"])
    assert got["final"][ref["paths"].index(".tbl.n_live")] > 0


def test_state_numpy_round_trip(runs):
    (_, ref), (_, got) = runs
    back = t_agg.state_to_numpy(
        t_agg.state_from_numpy(t_agg.state_to_numpy(got["state"]), "cpu"))
    from_ref = t_agg.state_to_numpy(t_agg.state_from_numpy(ref["final"],
                                                           "cpu"))
    for a, b, c in zip(got["final"], back, from_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    for a, c in zip(ref["final"], from_ref):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(c, a)


def test_snapshots_match_reference(runs):
    (_, ref), (_, got) = runs
    assert len(got["svc_rows"]) == len(ref["svc_rows"]) > 0
    for r, g in zip(ref["svc_rows"], got["svc_rows"]):
        assert r.keys() == g.keys() and r["glob_id"] == g["glob_id"]
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    assert ref["flow"].keys() == got["flow"].keys()
    for k, v in ref["flow"].items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got["flow"][k], v, rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got["flow"][k].astype(v.dtype), v,
                                          err_msg=k)
