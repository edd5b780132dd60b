"""The port's sketches against the reference's, on the same inputs.

Tolerances, each for the reason given: integer state, max state and
top-K keys are exact (order-free or integer arithmetic); f32 sums match
within rtol 1e-6 (XLA and PyTorch reduce in different orders); t-digest
means/weights within rtol 1e-5 (the compression's sort order is exact,
its cumulative and segment sums are not). Each top-k call site gets a
tie-heavy input, since ``lax.top_k`` puts the lower index first on ties
and the port must too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyeeta_tpu.sketch import countmin as JC, hyperloglog as JHLL, \
    invertible as JI, loghist as JL, tdigest as JT, topk as JK, windows as JW
from gyeeta_tpu_torch.sketch import countmin as TC, hyperloglog as THLL, \
    invertible as TI, loghist as TL, tdigest as TT, topk as TK, windows as TW
from gyeeta_tpu_torch.utils.tensor import tree_leaves

torch.set_num_threads(1)
CPU = "cpu"


def _keys(n, seed, distinct=None):
    rng = np.random.default_rng(seed)
    pool = distinct or n
    hi = rng.integers(0, 2**32, pool, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, pool, dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, pool, n)
    return hi[pick], lo[pick]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _np(x):
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a


def _same_tree(got, ref, rtol=None):
    g, r = tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape
        if rtol is None or b.dtype.kind != "f":
            np.testing.assert_array_equal(a.astype(b.dtype) if
                                          b.dtype == np.uint32 else a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def test_hll_update_entities_update_estimate_merge():
    hi, lo = _keys(700, 1, distinct=300)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 8, 700).astype(np.int32)
    valid = rng.random(700) < 0.8
    j = jax.jit(lambda r, h, l, ok: JHLL.update_entities(
        JHLL.init(p=6, entities=(8,)), r, h, l, valid=ok))(
        jnp.asarray(rows), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(valid))
    t = THLL.update_entities(THLL.init(p=6, entities=(8,), device=CPU),
                             _t(rows), _t(hi), _t(lo), valid=_t(valid))
    _same_tree(t, j)
    jg = jax.jit(lambda h, l, ok: JHLL.update(JHLL.init(p=8), h, l,
                                              valid=ok))(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    tg = THLL.update(THLL.init(p=8, device=CPU), _t(hi), _t(lo),
                     valid=_t(valid))
    _same_tree(tg, jg)
    for a, b in ((t, j), (tg, jg)):
        np.testing.assert_allclose(_np(THLL.estimate(a)),
                                   np.asarray(jax.jit(JHLL.estimate)(b)),
                                   rtol=1e-6)
    _same_tree(THLL.merge(t, t), JHLL.merge(j, j))


def test_cms_update_query_bound_total_merge():
    hi, lo = _keys(900, 3, distinct=200)
    rng = np.random.default_rng(4)
    vals = np.round(rng.pareto(1.5, 900) * 2000).astype(np.float32)
    valid = rng.random(900) < 0.9
    j = jax.jit(lambda h, l, v, ok: JC.update(JC.init(2, 1 << 8), h, l, v,
                                              valid=ok))(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
        jnp.asarray(valid))
    t = TC.update(TC.init(2, 1 << 8, device=CPU), _t(hi), _t(lo), _t(vals),
                  valid=_t(valid))
    _same_tree(t, j, rtol=1e-6)
    for fn_t, fn_j in ((TC.query, JC.query), (TC.upper_bound, JC.upper_bound)):
        np.testing.assert_allclose(_np(fn_t(t, _t(hi), _t(lo))),
                                   np.asarray(jax.jit(fn_j)(
                                       j, jnp.asarray(hi), jnp.asarray(lo))),
                                   rtol=1e-6)
    np.testing.assert_allclose(_np(TC.total(t)), np.asarray(JC.total(j)),
                               rtol=1e-6)
    _same_tree(TC.merge(t, t), JC.merge(j, j), rtol=1e-6)


SPEC = dict(vmin=1.0, vmax=1e8, nbuckets=64)


def test_loghist_buckets_updates_quantiles():
    rng = np.random.default_rng(5)
    scales = np.geomspace(200.0, 50_000.0, 8)
    v = (rng.lognormal(0.0, 0.7, 4000) * scales[rng.integers(0, 8, 4000)])
    v = np.concatenate([np.minimum(v, 4e9).astype(np.uint32)
                        .astype(np.float32), [0, 1, 1e8, 3e9]]) \
        .astype(np.float32)
    js, ts = JL.LogHistSpec(**SPEC), TL.LogHistSpec(**SPEC)
    np.testing.assert_array_equal(_np(TL.bucket_of(ts, _t(v))),
                                  np.asarray(JL.bucket_of(js,
                                                          jnp.asarray(v))))
    b = np.arange(64, dtype=np.int32)
    np.testing.assert_allclose(_np(TL.bucket_mid(ts, _t(b))),
                               np.asarray(JL.bucket_mid(js, jnp.asarray(b))),
                               rtol=1e-6)
    rows = rng.integers(0, 6, len(v)).astype(np.int32)
    valid = rng.random(len(v)) < 0.9
    jh = jax.jit(lambda r, x, ok: JL.update_entities(
        JL.init(js, (6,)), js, r, x, valid=ok))(
        jnp.asarray(rows), jnp.asarray(v), jnp.asarray(valid))
    th = TL.update_entities(torch.zeros((6, ts.nbuckets)), ts, _t(rows),
                            _t(v), valid=_t(valid))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    qs = (0.25, 0.5, 0.95, 0.99)
    np.testing.assert_allclose(_np(TL.quantiles(th, ts, qs)),
                               np.asarray(jax.jit(
                                   lambda h: JL.quantiles(h, js, qs))(jh)),
                               rtol=1e-6)
    np.testing.assert_array_equal(_np(TL.counts_total(th)),
                                  np.asarray(JL.counts_total(jh)))


def test_windows_tick_and_read():
    jl = (JW.WindowSpec(2, 3), JW.WindowSpec(5, 2))
    tl = (TW.WindowSpec(2, 3), TW.WindowSpec(5, 2))
    j, t = JW.init((3, 4), jl), TW.init((3, 4), tl, device=CPU)
    rng = np.random.default_rng(6)
    add_tick = jax.jit(lambda w, d: JW.tick(JW.add(w, d), jl))
    for _ in range(14):
        d = (rng.random((3, 4)) * 100).astype(np.float32)
        j = add_tick(j, jnp.asarray(d))
        t.cur.add_(_t(d))
        t = TW.tick(t, tl)
        _same_tree(t, j, rtol=1e-6)
    for level in (-1, 0, 1, 2):
        np.testing.assert_allclose(_np(TW.read(t, level)),
                                   np.asarray(JW.read(j, level)), rtol=1e-6)


def _stage_inputs(seed, S=12, n=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, S, n).astype(np.int32)
    rows[:40] = 3                                  # one entity overflows
    vals = (rng.lognormal(0, 0.7, n) * 1000).astype(np.float32)
    return rows, vals


def test_tdigest_stage_flush_topm_quantiles():
    S, C, cap = 12, 8, 24
    jd, td = JT.init(C, (S,)), TT.init(C, (S,), device=CPU)
    jv, jn = jnp.zeros((S, cap)), jnp.zeros((S,), jnp.int32)
    tv, tn = torch.zeros((S, cap)), torch.zeros(S, dtype=torch.int32)
    qs = (0.25, 0.5, 0.95, 0.99)
    stage = jax.jit(JT.stage_samples)
    topm = jax.jit(JT.flush_staged_topm, static_argnums=3)
    for seed in (7, 8, 9):
        rows, vals = _stage_inputs(seed, S)
        jv, jn, jo = stage(jv, jn, jnp.asarray(rows), jnp.asarray(vals))
        tv, tn, to = TT.stage_samples(tv, tn, _t(rows), _t(vals))
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        assert int(to) == int(jo) > 0
        # tie-heavy top-m: many stages hold equal fills
        jd, jv, jn = topm(jd, jv, jn, 5)
        td, tv, tn = TT.flush_staged_topm(td, tv, tn, 5)
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
        _same_tree(td, jd, rtol=1e-5)
    jd, jv, jn = jax.jit(JT.flush_staged)(jd, jv, jn)
    td, tv, tn = TT.flush_staged(td, tv, tn)
    _same_tree(td, jd, rtol=1e-5)
    assert not _np(tn).any() and not _np(tv).any()
    np.testing.assert_allclose(
        _np(TT.quantiles_entities(td, qs)),
        np.asarray(jax.jit(JT.quantiles_entities, static_argnums=1)(jd, qs)),
        rtol=1e-5)
    one = TT.TDigest(*(x[3] for x in td))
    np.testing.assert_allclose(
        _np(TT.quantiles(one, qs)),
        np.asarray(jax.jit(JT.quantiles, static_argnums=1)(
            JT.TDigest(*(x[3] for x in jd)), qs)),
        rtol=1e-5)


def _topk_lanes(seed, n=200, distinct=40):
    hi, lo = _keys(n, seed, distinct=distinct)
    rng = np.random.default_rng(seed)
    # integer masses drawn from few values: many equal segment totals
    vals = rng.integers(1, 4, n).astype(np.float32) * 100
    valid = rng.random(n) < 0.85
    return hi, lo, vals, valid


def test_topk_update_query_ties():
    jk, tk = JK.init(16), TK.init(16, device=CPU)
    upd = jax.jit(lambda k, h, l, v, ok: JK.update(k, h, l, v, valid=ok))
    for seed in (10, 11, 12):
        hi, lo, vals, valid = _topk_lanes(seed)
        args = (hi, lo, vals)
        jk = upd(jk, *map(jnp.asarray, args), jnp.asarray(valid))
        tk = TK.update(tk, *map(_t, args), valid=_t(valid))
        _same_tree(tk, jk, rtol=1e-6)
    # est-budgeted compaction with tied estimates (topk.py:95)
    hi, lo, vals, valid = _topk_lanes(13)
    est = np.repeat(np.float32([5, 3, 3, 1]), 50)
    jb = jax.jit(lambda k, h, l, v, ok, e: JK.update(
        k, h, l, v, valid=ok, est=e, budget=60))(
        jk, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
        jnp.asarray(valid), jnp.asarray(est))
    tb = TK.update(tk, _t(hi), _t(lo), _t(vals), valid=_t(valid),
                   est=_t(est), budget=60)
    _same_tree(tb, jb, rtol=1e-6)
    # query over tied counts (topk.py:175)
    tied = tb._replace(counts=torch.full((16,), 7.0))
    jt = jb._replace(counts=jnp.full((16,), 7.0))
    for a, b in zip(TK.query(tied, 9),
                    jax.jit(JK.query, static_argnums=1)(jt, 9)):
        np.testing.assert_array_equal(_np(a).astype(np.asarray(b).dtype),
                                      np.asarray(b))


@pytest.mark.parametrize("budget", [0, 50], ids=["all_lanes", "budget50"])
def test_invertible_update_ties(budget):
    ji, ti = JI.init(2, 64), TI.init(2, 64, device=CPU)
    upd = jax.jit(lambda s, h, l, p, ok, hot: JI.update(
        s, h, l, p, ok, hot=hot, budget=budget))
    for seed in (14, 15):
        hi, lo = _keys(300, seed, distinct=120)
        rng = np.random.default_rng(seed)
        # priorities from few values: equal-priority contests per bucket
        prio = rng.integers(0, 4, 300).astype(np.float32) * 10
        valid = rng.random(300) < 0.9
        hot = prio >= 20
        ji = upd(ji, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(prio),
                 jnp.asarray(valid), jnp.asarray(hot))
        ti = TI.update(ti, _t(hi), _t(lo), _t(prio), _t(valid), hot=_t(hot),
                       budget=budget)
        _same_tree(ti, ji)
    assert int((_np(ti.prio) > 0).sum()) > 0


@pytest.mark.parametrize("kept_at_zero", [False, True],
                         ids=["zero_untouched", "zero_written"])
def test_drop_scatters_match_jax_drop_mode(kept_at_zero):
    """``set_drop``/``add_drop`` are JAX's ``mode="drop"`` scatters: the
    port aims dropped lanes at element 0 and must leave it as JAX does,
    also when a kept lane writes element 0."""
    from gyeeta_tpu_torch.utils.tensor import add_drop, set_drop
    rng = np.random.default_rng(16)
    base = rng.integers(1, 100, 32).astype(np.int32)
    idx = rng.permutation(np.arange(1, 32))[:12].astype(np.int32)
    idx[0] = 0 if kept_at_zero else idx[0]
    vals = rng.integers(100, 200, 12).astype(np.int32)
    keep = np.ones(12, bool)
    keep[3::4] = False
    jidx = jnp.where(jnp.asarray(keep), jnp.asarray(idx), 32)
    want = np.asarray(jnp.asarray(base).at[jidx].set(jnp.asarray(vals),
                                                     mode="drop"))
    got = _t(base)
    set_drop(got, _t(idx), _t(vals), _t(keep))
    np.testing.assert_array_equal(got.numpy(), want)
    fb = base.astype(np.float32)
    want = np.asarray(jnp.asarray(fb).at[jidx].add(
        jnp.asarray(vals, jnp.float32), mode="drop"))
    got = _t(fb)
    add_drop(got, _t(idx), _t(vals.astype(np.float32)), _t(keep))
    np.testing.assert_array_equal(got.numpy(), want)
