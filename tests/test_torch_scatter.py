"""The port's scatter kernels' plain versions against the reference's
Pallas kernels (``gyeeta_tpu/sketch/pallas_scatter.py``), which run in
Pallas interpret mode on the CPU.

The Pallas calls are made through ``_scatter_max_call`` /
``_scatter_add_call`` — the functions that reach ``pl.pallas_call`` —
so no XLA fallback can stand in for them. Max is order-free: exact.
Add: exact for integer-valued sums below 2**24; rtol 1e-6 otherwise (the
reference's own bar, pallas_scatter.py:178), since the CUDA kernel adds
in no fixed order.

The masked sites (``keep``, rows of -1, ``row * stride + col``, several
sites in one call) are held against JAX's ``.at[].max/.add(mode="drop")``
and the reference's own ``ingest_delta`` expressions; the ``gpu`` cases
hold every kernel entry against its plain version on the card.

JAX is imported inside the ``pallas`` fixture, so that the CUDA-only test
also runs where JAX is not installed (the GPU machine):
``python -m pytest --noconftest -m gpu tests/test_torch_scatter.py``.
"""

import numpy as np
import pytest
import torch

from gyeeta_tpu_torch.sketch import scatter as S

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    from gyeeta_tpu.sketch import pallas_scatter
    return pallas_scatter, jnp

N = 512


def _lanes(size, dtype, seed, negative=False):
    """N lanes with many duplicate indices; every 4th lane is padding
    (value 0, as the callers pre-mask it)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, size, N).astype(np.int32)
    idx[::7] = idx[0]                              # a hot duplicate
    if dtype == np.int32:
        val = rng.integers(0, 23, N).astype(np.int32)
    else:
        val = (rng.random(N) * 1e3).astype(np.float32)
        if negative:
            val -= np.float32(500.0)
    val[::4] = 0
    return idx, val


CASES = [
    ("hll_global_i32", (1 << 10,), np.int32),
    ("hll_entities_i32", (16, 64), np.int32),
    ("inv_prio_f32", (2, 256), np.float32),
]


@pytest.mark.parametrize("name,shape,dtype", CASES, ids=[c[0] for c in CASES])
def test_scatter_max_matches_pallas(pallas, name, shape, dtype):
    P, jnp = pallas
    rng = np.random.default_rng(5)
    base = (rng.integers(0, 8, shape) if dtype == np.int32
            else rng.random(shape) * 300).astype(dtype)
    idx, val = _lanes(base.size, dtype, 11)
    ref = np.asarray(P._scatter_max_call(jnp.asarray(base.reshape(-1)),
                                         jnp.asarray(idx), jnp.asarray(val)))
    got = torch.from_numpy(base.copy())
    out = S.scatter_max(got, torch.from_numpy(idx), torch.from_numpy(val))
    assert out is got
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref)


def test_scatter_max_f32_negative_values_match_pallas(pallas):
    P, jnp = pallas
    base = np.linspace(-400, 400, 256).astype(np.float32)
    idx, val = _lanes(256, np.float32, 12, negative=True)
    ref = np.asarray(P._scatter_max_call(jnp.asarray(base), jnp.asarray(idx),
                                         jnp.asarray(val)))
    got = torch.from_numpy(base.copy())
    S.scatter_max(got, torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("integer", [True, False], ids=["int_valued",
                                                        "float_valued"])
def test_scatter_add_matches_pallas(pallas, integer):
    P, jnp = pallas
    rng = np.random.default_rng(6)
    depth, width = 2, 512
    idx, val = _lanes(width, np.float32, 13)
    if integer:
        val = np.round(val)
    # the CMS layout: row offsets r*width, values tiled per row
    flat_idx = np.concatenate([idx + r * width for r in range(depth)])
    flat_val = np.tile(val, depth)
    base = np.round(rng.random((depth, width)) * 100).astype(np.float32)
    ref = np.asarray(P._scatter_add_call(jnp.asarray(base.reshape(-1)),
                                         jnp.asarray(flat_idx),
                                         jnp.asarray(flat_val)))
    got = torch.from_numpy(base.copy())
    S.scatter_add(got, torch.from_numpy(flat_idx),
                  torch.from_numpy(flat_val))
    if integer:
        np.testing.assert_array_equal(got.numpy().reshape(-1), ref)
    else:
        np.testing.assert_allclose(got.numpy().reshape(-1), ref, rtol=1e-6)


def test_wrapper_checks_and_cpu_counts_nothing():
    regs = torch.zeros(64, dtype=torch.int32)
    idx = torch.arange(8, dtype=torch.int32)
    val = torch.ones(8, dtype=torch.int32)
    S.reset_counts()
    S.scatter_max(regs, idx, val)
    assert S.launch_counts() == dict.fromkeys(S.ROUTES, 0)
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx.short(), val)             # idx dtype
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx, val.float())             # val dtype
    with pytest.raises(TypeError):
        S.scatter_add(regs.long(), idx, val.long())       # add: f32, int32
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx, val, keep=idx)           # keep not bool
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx, val, col=idx.long())     # col not int32
    with pytest.raises(TypeError):
        S.scatter_max(regs.long(), idx, val.long())       # target dtype
    with pytest.raises(ValueError):
        S.scatter_max(torch.zeros(8, 8, dtype=torch.int32).t(), idx, val)
    with pytest.raises(ValueError):
        S.scatter_max(regs, idx[:4], val)                 # shapes
    with pytest.raises(IndexError):
        S.scatter_max(regs, torch.tensor([64], dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32))  # out of range
    with pytest.raises(ValueError):
        S.scatter_max(regs, idx, val, route="elsewhere")  # unknown route


@pytest.mark.gpu
def test_cuda_tensor_launches_kernel_not_plain(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    def refuse(*a):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(S, "site_plain", refuse)
    monkeypatch.setattr(S, "scatter_sites_plain", refuse)
    idx, val = _lanes(1 << 10, np.int32, 21)
    regs = torch.zeros(1 << 10, dtype=torch.int32, device="cuda")
    S.reset_counts()
    S.scatter_max(regs, torch.from_numpy(idx).cuda(),
                  torch.from_numpy(val).cuda())
    fidx, fval = _lanes(1 << 10, np.float32, 22)
    counts = torch.zeros(1 << 10, device="cuda")
    S.scatter_add(counts, torch.from_numpy(fidx).cuda(),
                  torch.from_numpy(np.round(fval)).cuda())
    torch.cuda.synchronize()
    assert S.launch_counts() == dict(dict.fromkeys(S.ROUTES, 0),
                                     scatter_max=1, scatter_add=1)
    want = np.zeros(1 << 10, np.int32)
    np.maximum.at(want, idx, val)
    np.testing.assert_array_equal(regs.cpu().numpy(), want)
    wadd = np.zeros(1 << 10, np.float32)
    np.add.at(wadd, fidx, np.round(fval))
    np.testing.assert_array_equal(counts.cpu().numpy(), wadd)


# ---- masked sites: keep, rows of -1, row * stride + col
# (op, target dtype); each held against JAX's .at[].max/.add(mode="drop")
SITE_OPS = [("max", np.int32), ("max", np.float32), ("add", np.float32),
            ("add", np.int32)]
# lane sets: the delta loghist site's collisions (4,096 lanes onto 75
# targets, a third of the lanes dropped, some rows -1), every lane
# dropped, none dropped, no lanes at all, and flat indices (no column)
SITE_CASES = ["collide", "all_dropped", "none_dropped", "zero_lanes",
              "flat"]
ROWS, STRIDE = 48, 16


def _site_lanes(case, dtype, seed, integer=False):
    """(base, row, col or None, val, keep) from a seeded generator; f32
    values ``integer``-valued on request (sums exact in any order)."""
    rng = np.random.default_rng(seed)
    n = {"zero_lanes": 0}.get(case, 4096)
    if dtype == np.int32:
        base = rng.integers(-50, 50, ROWS * STRIDE).astype(np.int32)
        val = rng.integers(-60, 60, n).astype(np.int32)
    else:
        base = (rng.random(ROWS * STRIDE) * 600 - 300).astype(np.float32)
        val = (rng.random(n) * 1e3 - 500).astype(np.float32)
        if integer:
            base, val = np.round(base), np.round(val)
    if case == "flat":
        row = rng.integers(0, ROWS * STRIDE, n).astype(np.int64)
        col = None
    else:
        pool = rng.choice(ROWS * STRIDE, 75, replace=False)
        flat = pool[rng.integers(0, 75, n)]
        row, col = (flat // STRIDE).astype(np.int64), \
            (flat % STRIDE).astype(np.int32)
    keep = rng.random(n) < 0.66
    if case == "all_dropped":
        keep[:] = False
    elif case == "none_dropped":
        keep[:] = True
    if case in ("collide", "flat"):
        row[rng.random(n) < 0.1] = -1          # missing lookup rows
    # a dropped lane's row may lie past the target (stage_samples aims
    # its dropped lanes at row S): it must not be read as an index
    row[~keep & (rng.random(n) < 0.5)] = ROWS * STRIDE + 7
    return base, row, col, val, keep


def _jax_drop(jnp, op, base, row, col, val, keep, stride):
    """JAX's mode="drop" scatter of the same lanes: dropped lanes are
    aimed past the end."""
    flat = row * stride + (0 if col is None else col)
    idx = jnp.asarray(np.where(keep & (row >= 0), flat, base.size))
    ref = jnp.asarray(base).at[idx]
    ref = ref.max(jnp.asarray(val), mode="drop") if op == "max" \
        else ref.add(jnp.asarray(val), mode="drop")
    return np.asarray(ref)


def _site(op, base, row, col, val, keep, stride, device="cpu"):
    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)
    return S.Site(op, t(base.copy()), t(row), t(val), t(keep), t(col),
                  stride)


@pytest.mark.parametrize("case", SITE_CASES)
@pytest.mark.parametrize("op,dtype", SITE_OPS,
                         ids=[f"{o}_{np.dtype(d).name}" for o, d in SITE_OPS])
def test_masked_site_matches_jax_drop_mode(pallas, op, dtype, case):
    """The plain masked version (the CPU route of every wrapper) equals
    JAX's drop-mode scatter exactly: max is order-free, int32 sums are
    exact, and f32 sums run in lane order on both sides."""
    _, jnp = pallas
    base, row, col, val, keep = _site_lanes(case, dtype, 31)
    stride = 1 if col is None else STRIDE
    want = _jax_drop(jnp, op, base, row, col, val, keep, stride)
    site = _site(op, base, row, col, val, keep, stride)
    wrapper = S.scatter_max if op == "max" else S.scatter_add
    S.reset_counts()
    out = wrapper(site.target, site.row, site.val, keep=site.keep,
                  col=site.col, stride=stride)
    assert out is site.target
    assert S.launch_counts() == dict.fromkeys(S.launch_counts(), 0)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("op,dtype", [("max", np.int32), ("add", np.float32)],
                         ids=["max_int32", "add_float32"])
def test_masked_site_matches_pallas_kernel(pallas, op, dtype):
    """The masked form at the call sites' old pre-masked lanes (dropped
    lanes at index 0 with the identity) through the reference's Pallas
    kernel, in interpret mode: the same registers."""
    P, jnp = pallas
    base, row, col, val, keep = _site_lanes("collide", dtype, 32)
    ok = keep & (row >= 0)
    idx = np.where(ok, row * STRIDE + col, 0).astype(np.int32)
    ident = np.iinfo(np.int32).min if op == "max" else np.float32(-0.0)
    pv = np.where(ok, val, ident).astype(dtype)
    call = P._scatter_max_call if op == "max" else P._scatter_add_call
    want = np.asarray(call(jnp.asarray(base), jnp.asarray(idx),
                           jnp.asarray(pv)))
    site = _site(op, base, row, col, val, keep, STRIDE)
    S.site_plain(site)
    np.testing.assert_array_equal(site.target.numpy(), want)


def test_sites_one_call_matches_reference_delta_merges(pallas):
    """scatter_sites over ingest_delta's three merges equals the
    reference's own expressions (gyeeta_tpu/engine/step.py ingest_delta:
    ``cur.at[roww, bucket].add(w)``, ``regs.at[row, reg].max(rank)``,
    ``regs.at[reg].max(rank)`` with missing rows at row 0 and value 0)."""
    _, jnp = pallas
    rng = np.random.default_rng(33)
    S_, nb, m, mg, n = 40, 12, 16, 256, 4096
    cur = np.round(rng.random((S_, nb)) * 50).astype(np.float32)
    regs = rng.integers(0, 9, (S_, m)).astype(np.int32)
    gregs = rng.integers(0, 9, mg).astype(np.int32)
    rh = rng.integers(-1, S_, n).astype(np.int32)
    hv = rng.random(n) < 0.7
    bucket = rng.integers(0, nb, n).astype(np.int32)
    w = np.round(rng.random(n) * 20).astype(np.float32)
    rs = rng.integers(-1, S_, n).astype(np.int32)
    sv = rng.random(n) < 0.7
    reg = rng.integers(0, m, n).astype(np.int32)
    rank = rng.integers(0, 20, n).astype(np.int32)
    greg = rng.integers(0, mg, n).astype(np.int32)
    gv = rng.random(n) < 0.5
    grank = rng.integers(0, 20, n).astype(np.int32)
    ok_h, ok_s = hv & (rh >= 0), sv & (rs >= 0)
    want_h = np.asarray(jnp.asarray(cur).at[
        jnp.where(ok_h, rh, 0), bucket].add(jnp.where(ok_h, w, 0.0)))
    want_s = np.asarray(jnp.asarray(regs).at[
        jnp.where(ok_s, rs, 0), reg].max(jnp.where(ok_s, rank, 0)))
    want_g = np.asarray(jnp.asarray(gregs).at[greg].max(
        jnp.where(gv, grank, 0)))
    t = torch.from_numpy
    g_cur, g_regs, g_gregs = t(cur.copy()), t(regs.copy()), t(gregs.copy())
    S.reset_counts()
    S.scatter_sites((
        S.Site("add", g_cur, t(rh), t(w), keep=t(hv), col=t(bucket),
               stride=nb),
        S.Site("max", g_regs, t(rs), t(rank), keep=t(sv), col=t(reg),
               stride=m),
        S.Site("max", g_gregs, t(greg), t(grank), keep=t(gv))),
        route="delta_merge")
    assert S.launches["delta_merge"] == 0          # the CPU counts nothing
    np.testing.assert_array_equal(g_cur.numpy(), want_h)
    np.testing.assert_array_equal(g_regs.numpy(), want_s)
    np.testing.assert_array_equal(g_gregs.numpy(), want_g)
    with pytest.raises(ValueError):
        S.scatter_sites([S.Site("max", g_gregs, t(greg), t(grank))] * 9,
                        route="delta_merge")


@pytest.mark.parametrize("case", ["collide", "all_dropped", "none_dropped",
                                  "zero_lanes"])
def test_add_drop_int32_equals_old_behaviour(case):
    """add_drop on an int32 target (the t-digest stage counts) equals
    the where + index_put_(accumulate=True) it always ran, and the plain
    version of the int32 scatter-add that it launches on the card."""
    from gyeeta_tpu_torch.utils.tensor import add_drop
    base, row, _, val, keep = _site_lanes(case, np.int32, 34)
    row = np.where(row < 0, 0, row % base.size)   # add_drop's rows exist
    row[~keep & (np.arange(row.size) % 3 == 0)] = base.size  # row S
    t = torch.from_numpy
    old = t(base.copy())
    tgt = torch.where(t(keep), t(row), 0)
    old.index_put_((tgt,), torch.where(t(keep), t(val), 0),
                   accumulate=True)
    got = t(base.copy())
    add_drop(got, t(row), t(val), t(keep))
    np.testing.assert_array_equal(got.numpy(), old.numpy())
    plain = S.scatter_add_plain(t(base.copy()), t(row), t(val), keep=t(keep))
    np.testing.assert_array_equal(plain.numpy(), old.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", SITE_CASES)
@pytest.mark.parametrize("op,dtype", SITE_OPS,
                         ids=[f"{o}_{np.dtype(d).name}" for o, d in SITE_OPS])
def test_cuda_site_matches_plain(op, dtype, case):
    """Each wrapper's launch on the card against its plain version on the
    same inputs: max and int32 add exact, f32 add rtol 1e-6 (atomics and
    the warp's shuffle sum add in no fixed order; the values are
    integers, as the loghist weights are, so the sums below 2**24 come
    out exact all the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    base, row, col, val, keep = _site_lanes(case, dtype, 35, integer=True)
    stride = 1 if col is None else STRIDE
    got = _site(op, base, row, col, val, keep, stride, "cuda")
    want = _site(op, base, row, col, val, keep, stride, "cuda")
    wrapper = S.scatter_max if op == "max" else S.scatter_add
    S.reset_counts()
    wrapper(got.target, got.row, got.val, keep=got.keep, col=got.col,
            stride=stride)
    S.site_plain(want)
    torch.cuda.synchronize()
    route = "scatter_max" if op == "max" else "scatter_add"
    assert S.launch_counts() == dict(
        dict.fromkeys(S.ROUTES, 0), **{route: int(case != "zero_lanes")})
    rtol = 1e-6 if (op, dtype) == ("add", np.float32) else 0
    torch.testing.assert_close(got.target, want.target, rtol=rtol, atol=0)


@pytest.mark.gpu
def test_cuda_sites_one_launch_matches_plain():
    """The three delta merges in one launch against the plain sites."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    sites = []
    for k, (op, dtype) in enumerate(SITE_OPS):
        base, row, col, val, keep = _site_lanes("collide", dtype, 36 + k,
                                                integer=True)
        sites.append((op, base, row, col, val, keep))
    got = [_site(*s[:5], s[5], STRIDE, "cuda") for s in sites]
    want = [_site(*s[:5], s[5], STRIDE, "cuda") for s in sites]
    S.reset_counts()
    S.scatter_sites(got, route="delta_merge")
    S.scatter_sites_plain(want)
    torch.cuda.synchronize()
    assert S.launch_counts() == dict(dict.fromkeys(S.ROUTES, 0),
                                     delta_merge=1)
    for g, w in zip(got, want):
        rtol = 1e-6 if g.target.dtype == torch.float32 and g.op == "add" \
            else 0
        torch.testing.assert_close(g.target, w.target, rtol=rtol, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["collide", "flat"])
def test_cuda_f32_add_of_fractions_within_reordering_bound(case):
    """f32 sums of non-integer values of both signs, where a sum that
    cancels near zero cannot keep a relative tolerance: the kernel's sum
    in any order stays within the error bound of a reordered float sum,
    2 k u (sum of |terms|) for k terms a target (u = 2**-24)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    base, row, col, val, keep = _site_lanes(case, np.float32, 37)
    stride = 1 if col is None else STRIDE
    got = _site("add", base, row, col, val, keep, stride, "cuda")
    want = _site("add", base, row, col, val, keep, stride, "cuda")
    S.scatter_add(got.target, got.row, got.val, keep=got.keep, col=got.col,
                  stride=stride)
    S.site_plain(want)
    mag = _site("add", np.abs(base).astype(np.float64), row, col,
                np.abs(val).astype(np.float64), keep, stride, "cuda")
    terms = _site("add", np.ones_like(base, np.float64), row, col,
                  np.ones_like(val, np.float64), keep, stride, "cuda")
    S.site_plain(mag)
    S.site_plain(terms)
    bound = 2 * terms.target.max() * 2.0 ** -24 * mag.target
    err = (got.target.double() - want.target.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["collide", "all_dropped", "none_dropped",
                                  "zero_lanes"])
def test_cuda_add_drop_int32_launches_the_kernel(case):
    """add_drop of int32 stage counts on the card launches the int32
    scatter-add once (route ``add_drop``) and equals the sorted
    index_put_(accumulate=True) it replaced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from gyeeta_tpu_torch.utils.tensor import add_drop
    base, row, _, val, keep = _site_lanes(case, np.int32, 38)
    row = np.where(row < 0, 0, row % base.size)
    row[~keep & (np.arange(row.size) % 3 == 0)] = base.size
    t = lambda a: torch.from_numpy(a).cuda()          # noqa: E731
    old = t(base.copy())
    old.index_put_((torch.where(t(keep), t(row), 0),),
                   torch.where(t(keep), t(val), 0), accumulate=True)
    got = t(base.copy())
    S.reset_counts()
    add_drop(got, t(row), t(val), t(keep))
    torch.cuda.synchronize()
    assert S.launch_counts() == dict(dict.fromkeys(S.ROUTES, 0),
                                     add_drop=int(case != "zero_lanes"))
    torch.testing.assert_close(got, old, rtol=0, atol=0)
