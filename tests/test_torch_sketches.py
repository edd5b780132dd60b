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
        t = TW.tick(TW.add(t, _t(d)), tl)
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


# ------------------------------------------------- the mergeable sketch API
# The cases of tests/test_sketches.py (loghist, t-digest, top-K) and
# tests/test_invertible.py's merge, each run through both packages on the
# same numpy inputs: a case yields (name, port result, reference result,
# rtol, None for exact, or "digest" for :func:`_same_digest`) and holds the
# port to the reference's own accuracy bound where that test states one.
def _same_digest(got, ref):
    """t-digest parity. ``_k1``'s ``arcsin`` differs from XLA's by an ulp
    for about a third of f32 inputs, so a sample whose arcsine scale sits
    within an ulp of a cluster boundary can land in the neighbouring
    centroid (at 200,000 lognormal samples in 20 updates of 128
    centroids: one sample at the 11th update, two more at the 19th). Held:
    vmin, vmax and the total weight exact; every other centroid's weight
    exact and its mean within rtol 1e-5; where weights differ, they
    differ in adjacent pairs by whole samples moved from one to the
    other (at most 1e-4 of the total), with the means of the pair within
    rtol 1e-4."""
    gm, gw, gmin, gmax = (_np(x) for x in got)
    rm, rw, rmin, rmax = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gmin, rmin)
    np.testing.assert_array_equal(gmax, rmax)
    np.testing.assert_array_equal(gw.sum(-1), rw.sum(-1))
    dw = (gw - rw).reshape(-1, gw.shape[-1])
    moved = np.zeros(dw.shape, bool)
    for row, d in zip(moved, dw):
        for j in np.nonzero(d)[0]:
            assert d[j] == np.round(d[j]), "a fraction of a sample moved"
            assert (j > 0 and d[j - 1] == -d[j]) \
                or (j + 1 < len(d) and d[j + 1] == -d[j]), \
                "weight moved other than between neighbouring centroids"
            row[j] = True
    assert np.abs(dw).sum() <= 2e-4 * rw.sum()
    moved = moved.reshape(gw.shape)
    np.testing.assert_allclose(gm[~moved], rm[~moved], rtol=1e-5, atol=0)
    np.testing.assert_allclose(gm[moved], rm[moved], rtol=1e-4, atol=0)


def _lognormal(seed, n, mean, sigma):
    return np.random.default_rng(seed).lognormal(mean, sigma, n) \
        .astype(np.float32)


def _case_loghist_global_update():
    """``test_loghist_quantile_error_bound``: RESP_TIME_SPEC, one global
    histogram of 100,000 lognormal latencies."""
    from gyeeta_tpu_torch.sketch import exact
    assert TL.RESP_TIME_SPEC == tuple(JL.RESP_TIME_SPEC)
    ts, js = TL.RESP_TIME_SPEC, JL.RESP_TIME_SPEC
    v = np.clip(_lognormal(20, 100_000, -4.0, 1.5), ts.vmin,
                ts.vmax * 0.99)
    jh = jax.jit(lambda h, x: JL.update(h, js, x))(JL.init(js),
                                                   jnp.asarray(v))
    th = TL.update(TL.init(ts, device=CPU), ts, _t(v))
    qs = np.array([0.25, 0.5, 0.95, 0.99], np.float32)
    tq = _np(TL.quantiles(th, ts, tuple(qs)))
    truth = exact.quantiles(v, qs)
    assert (np.abs(tq - truth) / truth).max() < 2 * ts.rel_error + 0.01
    yield "hist", th, jh, None
    yield "quantiles", tq, JL.quantiles(jh, js, jnp.asarray(qs)), 1e-6


def _case_loghist_weighted_valid():
    """``update`` with weights and a ``valid`` mask (PERCENT_SPEC)."""
    ts, js = TL.PERCENT_SPEC, JL.PERCENT_SPEC
    rng = np.random.default_rng(21)
    v = (rng.random(5000) * 120).astype(np.float32)
    w = rng.integers(1, 5, 5000).astype(np.float32)
    ok = rng.random(5000) < 0.7
    jh = JL.update(JL.init(js, (), jnp.float32), js, jnp.asarray(v),
                   jnp.asarray(w), jnp.asarray(ok))
    th = TL.update(TL.init(ts, (), torch.float32, CPU), ts, _t(v), _t(w),
                   _t(ok))
    yield "hist", th, jh, None


def _case_loghist_entities_init():
    """``test_loghist_per_entity_scatter``: ``init`` with an entity axis."""
    ts = TL.LogHistSpec(1e-4, 10.0, 256)
    js = JL.LogHistSpec(1e-4, 10.0, 256)
    rng = np.random.default_rng(22)
    rows = rng.integers(0, 16, 50_000).astype(np.int32)
    v = _lognormal(23, 50_000, -2.0, 1.0)
    jh = jax.jit(lambda h, r, x: JL.update_entities(h, js, r, x))(
        JL.init(js, entities=(16,)), jnp.asarray(rows), jnp.asarray(v))
    th = TL.update_entities(TL.init(ts, entities=(16,), device=CPU), ts,
                            _t(rows), _t(v))
    np.testing.assert_array_equal(
        _np(TL.counts_total(th)),
        np.bincount(rows, minlength=16).astype(np.float32))
    yield "hist", th, jh, None
    yield "quantiles", TL.quantiles(th, ts, (0.5, 0.99)), \
        JL.quantiles(jh, js, jnp.asarray([0.5, 0.99])), 1e-6


def _case_loghist_merge():
    """``test_loghist_merge_additive``: RATE_SPEC, merge == update."""
    ts, js = TL.RATE_SPEC, JL.RATE_SPEC
    rng = np.random.default_rng(24)
    v1 = rng.exponential(100, 10_000).astype(np.float32)
    v2 = rng.exponential(1000, 10_000).astype(np.float32)
    j1 = JL.update(JL.init(js), js, jnp.asarray(v1))
    j2 = JL.update(JL.init(js), js, jnp.asarray(v2))
    t1 = TL.update(TL.init(ts, device=CPU), ts, _t(v1))
    t2 = TL.update(TL.init(ts, device=CPU), ts, _t(v2))
    tm = TL.merge(t1, t2)
    np.testing.assert_array_equal(_np(tm),
                                  _np(TL.update(t1.clone(), ts, _t(v2))))
    yield "merge", tm, JL.merge(j1, j2), None


def _case_tdigest_update_count():
    """``test_tdigest_quantiles_vs_exact``: 200,000 lognormal samples in
    20 ``update`` calls, then quantiles and ``count``."""
    from gyeeta_tpu_torch.sketch import exact
    v = _lognormal(25, 200_000, 0.0, 2.0)
    jd, td = JT.init(capacity=128), TT.init(capacity=128, device=CPU)
    upd = jax.jit(JT.update)
    for chunk in np.array_split(v, 20):
        jd = upd(jd, jnp.asarray(chunk))
        td = TT.update(td, _t(chunk))
    qs = np.array([0.01, 0.25, 0.5, 0.75, 0.95, 0.99], np.float32)
    tq = _np(TT.quantiles(td, qs))
    truth = exact.quantiles(v, qs)
    assert (np.abs(tq - truth) / truth).max() < 0.02
    assert float(TT.count(td)) == pytest.approx(len(v), rel=1e-6)
    yield "digest", td, jd, "digest"
    yield "quantiles", tq, JT.quantiles(jd, jnp.asarray(qs)), 1e-5
    yield "count", TT.count(td), JT.count(jd), 1e-6


def _case_tdigest_update_valid():
    """``update`` with a ``valid`` mask: masked lanes carry no weight and
    leave vmin/vmax alone."""
    rng = np.random.default_rng(26)
    v = (rng.normal(50.0, 10.0, 3000)).astype(np.float32)
    ok = rng.random(3000) < 0.6
    jd = JT.update(JT.init(32), jnp.asarray(v), jnp.asarray(ok))
    td = TT.update(TT.init(32, device=CPU), _t(v), _t(ok))
    assert float(TT.count(td)) == ok.sum()
    yield "digest", td, jd, "digest"


def _case_tdigest_merge():
    """``test_tdigest_merge``: two single digests merged."""
    from gyeeta_tpu_torch.sketch import exact
    rng = np.random.default_rng(27)
    v1 = rng.normal(10.0, 2.0, 50_000).astype(np.float32)
    v2 = rng.normal(20.0, 2.0, 50_000).astype(np.float32)
    ja = JT.update(JT.init(128), jnp.asarray(v1))
    jb = JT.update(JT.init(128), jnp.asarray(v2))
    ta = TT.update(TT.init(128, device=CPU), _t(v1))
    tb = TT.update(TT.init(128, device=CPU), _t(v2))
    tm = TT.merge(ta, tb)
    qs = np.array([0.1, 0.5, 0.9], np.float32)
    tq = _np(TT.quantiles(tm, qs))
    truth = exact.quantiles(np.concatenate([v1, v2]), qs)
    assert (np.abs(tq - truth) / np.abs(truth)).max() < 0.03
    yield "merge", tm, JT.merge(ja, jb), "digest"


def _case_tdigest_merge_entities():
    """``merge`` over a leading entity batch (the reference vmaps the
    compression), then the per-entity ``count``."""
    S, C, cap = 12, 8, 24
    digests = []
    for seed in (28, 29):
        jd, td = JT.init(C, (S,)), TT.init(C, (S,), device=CPU)
        rows, vals = _stage_inputs(seed, S)
        jv, jn, _ = JT.stage_samples(jnp.zeros((S, cap)),
                                     jnp.zeros((S,), jnp.int32),
                                     jnp.asarray(rows), jnp.asarray(vals))
        tv, tn, _ = TT.stage_samples(torch.zeros((S, cap)),
                                     torch.zeros(S, dtype=torch.int32),
                                     _t(rows), _t(vals))
        digests.append((JT.flush_staged(jd, jv, jn)[0],
                        TT.flush_staged(td, tv, tn)[0]))
    (ja, ta), (jb, tb) = digests
    tm, jm = TT.merge(ta, tb), JT.merge(ja, jb)
    yield "merge", tm, jm, "digest"
    yield "count", TT.count(tm), JT.count(jm), 1e-6


def _case_topk_heavy_hitters():
    """``test_topk_heavy_hitters``: a zipf stream of 200,000 lanes in
    chunks of 20,000 into a 256-slot table."""
    from gyeeta_tpu_torch.sketch import exact
    rng = np.random.default_rng(30)
    p = 1.0 / np.arange(1, 5001)
    draws = rng.choice(5000, size=200_000, p=p / p.sum())
    hi = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    hi, lo = hi[draws], lo[draws]
    vals = np.ones(len(hi), np.float32)
    jk, tk = JK.init(capacity=256), TK.init(capacity=256, device=CPU)
    upd = jax.jit(JK.update)
    for s in range(0, len(hi), 20_000):
        sl = slice(s, s + 20_000)
        jk = upd(jk, jnp.asarray(hi[sl]), jnp.asarray(lo[sl]),
                 jnp.asarray(vals[sl]))
        tk = TK.update(tk, _t(hi[sl]), _t(lo[sl]), _t(vals[sl]))
    gh, gl, gv = (_np(x) for x in TK.query(tk, 10))
    got = {(int(a) << 32) | int(b) for a, b in zip(gh, gl)}
    assert len({int(k) for k, _ in exact.topk(hi, lo, vals, 10)}
               & got) >= 9
    yield "table", tk, jk, 1e-6


def _case_topk_merge():
    """``test_topk_merge``: 100 distinct keys fit a 128-slot table, so
    the merged totals are exact; plus a tie-heavy merge that truncates."""
    from gyeeta_tpu_torch.sketch import exact
    hi, lo = _keys(10_000, 31, distinct=100)
    vals = np.ones(10_000, np.float32)
    halves = (slice(0, 5000), slice(5000, None))
    ja, jb = (JK.update(JK.init(128), jnp.asarray(hi[h]),
                        jnp.asarray(lo[h]), jnp.asarray(vals[h]))
              for h in halves)
    ta, tb = (TK.update(TK.init(128, device=CPU), _t(hi[h]), _t(lo[h]),
                        _t(vals[h])) for h in halves)
    tm = TK.merge(ta, tb)
    tmap = exact.key_totals(hi, lo, vals)
    for a, b, v in zip(*(_np(x) for x in TK.query(tm, 100))):
        assert abs(v - tmap[(int(a) << 32) | int(b)]) < 1e-3
    yield "merge", tm, JK.merge(ja, jb), 1e-6
    tables = []
    for seed in (32, 33):
        h, l, v, ok = _topk_lanes(seed)
        tables.append((JK.update(JK.init(16), jnp.asarray(h),
                                 jnp.asarray(l), jnp.asarray(v),
                                 valid=jnp.asarray(ok)),
                       TK.update(TK.init(16, device=CPU), _t(h), _t(l),
                                 _t(v), valid=_t(ok))))
    (ja, ta), (jb, tb) = tables
    yield "merge_truncating", TK.merge(ta, tb), JK.merge(ja, jb), 1e-6


def _case_topk_dense():
    """``test_dense_topk``, and a tie-heavy 2-D stat (ties keep the
    lower index first, as ``lax.top_k`` does)."""
    stats = np.array([5.0, 1.0, 9.0, 7.0, 3.0], np.float32)
    v, i = TK.dense_topk(_t(stats), 3)
    np.testing.assert_array_equal(_np(i), [2, 3, 0])
    yield "dense", (v, i), JK.dense_topk(jnp.asarray(stats), 3), None
    tied = np.random.default_rng(34).integers(0, 4, (6, 40)) \
        .astype(np.float32)
    yield "dense_ties", TK.dense_topk(_t(tied), 7), \
        jax.lax.top_k(jnp.asarray(tied), 7), None


def _case_invertible_merge():
    """``test_merge_prefers_higher_priority``, and a merge of two
    sketches with equal-priority contests in many buckets."""
    one = np.array([True])
    k3, k4 = np.array([3], np.uint32), np.array([4], np.uint32)
    ja, jb = (JI.update(JI.init(1, 16), jnp.asarray(k3), jnp.asarray(k4),
                        jnp.asarray([p]), jnp.asarray(one))
              for p in (10.0, 20.0))
    ta, tb = (TI.update(TI.init(1, 16, device=CPU), _t(k3), _t(k4),
                        torch.tensor([p]), _t(one)) for p in (10.0, 20.0))
    tm = TI.merge(ta, tb)
    assert float(_np(tm.prio).max()) == 20.0
    assert bool(_np(TI.decode_keys(tm)[2]).any())
    yield "merge", tm, JI.merge(ja, jb), None
    sk = []
    for seed in (35, 36):
        hi, lo = _keys(300, seed, distinct=120)
        rng = np.random.default_rng(seed)
        prio = rng.integers(0, 4, 300).astype(np.float32) * 10
        ok = rng.random(300) < 0.9
        sk.append((JI.update(JI.init(2, 64), jnp.asarray(hi),
                             jnp.asarray(lo), jnp.asarray(prio),
                             jnp.asarray(ok), hot=jnp.asarray(prio >= 20)),
                   TI.update(TI.init(2, 64, device=CPU), _t(hi), _t(lo),
                             _t(prio), _t(ok), hot=_t(prio >= 20))))
    (ja, ta), (jb, tb) = sk
    yield "merge_ties", TI.merge(ta, tb), JI.merge(ja, jb), None


_MERGE_CASES = {
    "loghist_global_update": _case_loghist_global_update,
    "loghist_weighted_valid": _case_loghist_weighted_valid,
    "loghist_entities_init": _case_loghist_entities_init,
    "loghist_merge": _case_loghist_merge,
    "tdigest_update_count": _case_tdigest_update_count,
    "tdigest_update_valid": _case_tdigest_update_valid,
    "tdigest_merge": _case_tdigest_merge,
    "tdigest_merge_entities": _case_tdigest_merge_entities,
    "topk_heavy_hitters": _case_topk_heavy_hitters,
    "topk_merge": _case_topk_merge,
    "topk_dense": _case_topk_dense,
    "invertible_merge": _case_invertible_merge,
}


@pytest.mark.parametrize("case", sorted(_MERGE_CASES))
def test_mergeable_api_matches_reference(case):
    n = 0
    for name, got, want, rtol in _MERGE_CASES[case]():
        try:
            if rtol == "digest":
                _same_digest(got, want)
            else:
                _same_tree(got, want, rtol=rtol)
        except AssertionError as e:
            raise AssertionError(f"{case}: {name}: {e}") from None
        n += 1
    assert n > 0


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
