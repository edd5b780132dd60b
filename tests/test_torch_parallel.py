"""The port's mesh, pairing dispatch and roll-up against the reference's.

The reference runs its sharded programs under ``shard_map`` on the
8-device virtual CPU platform (``tests/conftest.py``); the port drives
per-shard tensor lists on ``make_mesh(n, device="cpu")``. Held against
the reference, on a 4-shard and a 2×2 mesh:

- host routing (``shard_batches``, ``shard_of_host``) and the flow-key
  owner (``owner_shard``), exactly;
- ``dispatch_fields`` (the capacity-bucketed ``all_to_all``): every
  routed lane, its order, validity and the overflow count, exactly —
  with a skewed key that overflows the capacity and without;
- ``pairing_fn`` on the reference's pairing cases (halves landing on
  different shards pair; overflow counted) and its pair tables, leaf
  for leaf;
- the sharded conn/resp fold, then ``rollup_fn`` and ``fleet_rollup_fn``
  on the same per-shard states carried across packages
  (``sharded.state_from_numpy``): integer and max-merged leaves exact,
  f32 sums rtol 1e-6; the 2×2 mesh's rollup equals the 1-D mesh's.

This module compiles the reference's mesh programs, so it turns the
persistent XLA cache off for itself (:func:`no_xla_disk_cache`).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P

from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.ingest import decode as j_dec
from gyeeta_tpu.parallel import depgraph as j_dg, mesh as j_mesh, \
    pairing as j_pair, rollup as j_roll, sharded as j_sh
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.sketch import loghist as j_lh
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.ingest import decode as t_dec
from gyeeta_tpu_torch.parallel import mesh as t_mesh, \
    pairing as t_pair, rollup as t_roll, sharded as t_sh
from gyeeta_tpu_torch.sketch import loghist as t_lh
from gyeeta_tpu_torch.utils.tensor import tree_leaves

torch.set_num_threads(1)

GEOM = dict(svc_capacity=32, n_hosts=16, hll_p_svc=4, hll_p_global=8,
            cms_depth=2, cms_width=1 << 8, topk_capacity=16, td_capacity=8,
            conn_batch=64, resp_batch=64, listener_batch=32,
            hh_width=64)
SPEC = dict(vmin=1.0, vmax=1e8, nbuckets=32)
MESHES = {"1d": (4,), "2x2": (2, 2)}


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


def j_cfg():
    return JCfg(resp_spec=j_lh.LogHistSpec(**SPEC), **GEOM)


def t_cfg():
    return TCfg(resp_spec=t_lh.LogHistSpec(**SPEC), **GEOM)


def meshes(kind):
    if kind == "1d":
        return j_mesh.make_mesh(4), t_mesh.make_mesh(4, device="cpu")
    return (j_mesh.make_mesh2d(2, 2),
            t_mesh.make_mesh2d(2, 2, device="cpu"))


def _t(a):
    a = np.asarray(a)
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _np(t):
    a = t.cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def _leaf_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (what, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


# ---------------------------------------------------------------- routing
def test_mesh_geometry_and_placement():
    m = t_mesh.make_mesh(4, device="cpu")
    assert m.n == 4 and m.axis_names == ("hosts",) and m.shape == \
        {"hosts": 4}
    m2 = t_mesh.make_mesh2d(2, 3, device="cpu")
    assert m2.axis_names == ("slices", "hosts") and m2.n == 6
    assert t_mesh.axes_of(m2) == j_mesh.axes_of(j_mesh.make_mesh2d(2, 3))
    assert {d.type for d in m2.devices} == {"cpu"}
    ids = np.arange(40)
    np.testing.assert_array_equal(t_mesh.shard_of_host(ids, 4),
                                  j_mesh.shard_of_host(ids, 4))


def test_shard_of_host_routing():
    sim = JSim(n_hosts=16, n_svcs=2, seed=21)
    conn = sim.conn_records(64)
    jm, tm = meshes("1d")
    ref = j_sh.shard_batches(j_cfg(), jm, (j_dec.conn_batch, 32), conn,
                             conn["host_id"])
    got = t_sh.shard_batches(t_cfg(), tm, (t_dec.conn_batch, 32), conn,
                             conn["host_id"])
    assert len(got) == 4
    for s, b in enumerate(got):
        for name in b._fields:
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(ref, name)[s], name)
        assert (b.host_id[b.valid] % 4 == s).all()
    assert sum(int(b.valid.sum()) for b in got) == 64


def test_owner_shard_matches_reference():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    for n in (2, 4, 8):
        ref = np.asarray(j_pair.owner_shard(hi, lo, n))
        np.testing.assert_array_equal(t_pair.owner_shard(hi, lo, n), ref)
        np.testing.assert_array_equal(
            t_pair.owner_shard(_t(hi), _t(lo), n).numpy(), ref)


# -------------------------------------------------------------- dispatch
def _lanes(n, B, seed, skew):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, (n, B), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (n, B), dtype=np.uint64).astype(np.uint32)
    if skew:                      # one key a third of the lanes: overflow
        hi[:, :B // 3], lo[:, :B // 3] = 7, 9
    return hi, lo, rng.random((n, B)) < 0.5, rng.random((n, B)) < 0.8


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("cap", [8, 64])
def test_dispatch_fields_matches_reference(kind, cap):
    """Every routed lane, its slot, validity and the overflow count."""
    jm, tm = meshes(kind)
    B = 64
    hi, lo, cli, val = _lanes(tm.n, B, cap, skew=True)
    axes = j_mesh.axes_of(jm)
    sizes = tuple(jm.shape[a] for a in axes)

    @partial(jax.shard_map, mesh=jm, in_specs=(P(axes),) * 4,
             out_specs=(P(axes),) * 5, check_vma=False)
    def route(h, lw, c, v):
        out = j_pair._dispatch(h[0], lw[0], c[0], v[0], axes, sizes, cap)
        return tuple(x[None] for x in out)

    shd = NamedSharding(jm, P(axes))
    ref = [np.asarray(x) for x in jax.jit(route)(
        *[jax.device_put(x, shd) for x in (hi, lo, cli, val)])]
    got = t_pair._dispatch(tm, [_t(x) for x in hi], [_t(x) for x in lo],
                           [_t(x) for x in cli], [_t(x) for x in val], cap)
    for i, (r, g) in enumerate(zip(ref, got)):
        g = np.stack([_np(x) for x in g])
        assert g.shape == r.shape and g.dtype == r.dtype, i
        np.testing.assert_array_equal(g, r, err_msg=str(i))
    if cap == 8:
        assert ref[4].sum() > 0       # the skewed key overflowed


def _pair_halves(n, B, F, is_cli, seed):
    rng = np.random.default_rng(seed)
    fhi = np.random.default_rng(17).integers(1, 2**31, F).astype(np.uint32)
    flo = np.random.default_rng(18).integers(1, 2**31, F).astype(np.uint32)
    out = [np.zeros((n, B), np.uint32), np.zeros((n, B), np.uint32),
           np.zeros((n, B), bool), np.zeros((n, B), bool)]
    shard, fill = rng.integers(0, n, F), np.zeros(n, int)
    for i in range(F):
        s = shard[i]
        out[0][s, fill[s]], out[1][s, fill[s]] = fhi[i], flo[i]
        out[2][s, fill[s]], out[3][s, fill[s]] = is_cli, True
        fill[s] += 1
    return out


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_pairing_fn_matches_reference(kind):
    """Halves reported on different shards pair at their owner; the
    tables, stats and overflow equal the reference's."""
    jm, tm = meshes(kind)
    n, B, F = tm.n, 32, 60
    axes = j_mesh.axes_of(jm)
    shd = NamedSharding(jm, P(axes))
    jpt = j_pair.pair_init_sharded(jm, 128)
    jstep = j_pair.pairing_fn(jm, cap_per_dest=B)
    tpt = t_pair.pair_init_sharded(tm, 128)
    tstep = t_pair.pairing_fn(tm, cap_per_dest=B)
    for step_i, is_cli in enumerate((True, False)):
        h = _pair_halves(n, B, F, is_cli, seed=step_i)
        jpt, jst = jstep(jpt, *[jax.device_put(x, shd) for x in h])
        tpt, tst = tstep(tpt, *[[_t(r) for r in x] for x in h])
        for k in ("n_paired", "n_dropped", "n_table_live"):
            assert float(tst[k]) == float(jst[k]), k
    assert float(tst["n_paired"]) == F and float(tst["n_dropped"]) == 0
    for i, (r, g) in enumerate(zip(jax.tree_util.tree_leaves(jpt),
                                   t_pair.pair_to_numpy(tpt))):
        _leaf_close(r, g, f"pair leaf {i}")
    # carried across and back, exactly
    back = t_pair.pair_to_numpy(t_pair.pair_from_numpy(
        t_pair.pair_to_numpy(tpt), tm))
    for a, b in zip(back, t_pair.pair_to_numpy(tpt)):
        np.testing.assert_array_equal(a, b)


def test_pairing_overflow_counted():
    """All lanes target one owner: a capacity of 2 drops the rest."""
    jm, tm = meshes("1d")
    n, B = tm.n, 32
    ones = [torch.ones(B, dtype=torch.bool) for _ in range(n)]
    pt = t_pair.pair_init_sharded(tm, 128)
    pt, st = t_pair.pairing_fn(tm, cap_per_dest=2)(
        pt, [torch.full((B,), 12345) for _ in range(n)],
        [torch.full((B,), 67890) for _ in range(n)], ones, ones)
    assert float(st["n_dropped"]) == n * (B - 2)
    assert float(st["n_table_live"]) == 1


# ---------------------------------------------------------------- rollup
@functools.lru_cache(maxsize=None)
def folded(kind):
    """Both packages' sharded conn/resp fold of the same records, plus
    the direct-edge fold → (ref state, ref dep, port state, port dep)."""
    jm, tm = meshes(kind)
    sim = JSim(n_hosts=16, n_svcs=2, n_clients=64, seed=3)
    jst, tst = j_sh.init_sharded(j_cfg(), jm), t_sh.init_sharded(t_cfg(), tm)
    jdep = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x)[None],
                                  (tm.n,) + np.asarray(x).shape),
        j_dg.init(256, 256))
    jdep = jax.tree.map(lambda x: jax.device_put(
        x, NamedSharding(jm, P(j_mesh.axes_of(jm)))), jdep)
    tdep = t_sh.dep_init_sharded(tm, 256, 256)
    jfold = j_sh.fold_step_dep_sharded(j_cfg(), jm, cap_per_dest=64)
    for _ in range(2):
        conn = np.concatenate([sim.conn_records(120),
                               *sim.svc_conn_records(20,
                                                     split_halves=True)])
        resp = sim.resp_records(120)
        mk = lambda dec, recs: j_sh.shard_batches(  # noqa: E731
            j_cfg(), jm, (dec, 64), recs, recs["host_id"])
        cb, rb = mk(j_dec.conn_batch, conn), mk(j_dec.resp_batch, resp)
        jst, jdep, _ = jfold(jst, jdep, j_sh.put_sharded(jm, cb),
                             j_sh.put_sharded(jm, rb), np.int32(1))
        tcb = t_sh.put_sharded(tm, t_sh.shard_batches(
            t_cfg(), tm, (t_dec.conn_batch, 64), conn, conn["host_id"]))
        trb = t_sh.put_sharded(tm, t_sh.shard_batches(
            t_cfg(), tm, (t_dec.resp_batch, 64), resp, resp["host_id"]))
        tst, tdep, _ = t_sh.fold_step_dep_sharded(
            t_cfg(), tm, tst, tdep, tcb, trb, 1, cap_per_dest=64)
    return jst, jdep, tst, tdep


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_sharded_fold_matches_reference(kind):
    jst, jdep, tst, tdep = folded(kind)
    for i, (r, g) in enumerate(zip(jax.tree_util.tree_leaves(jst),
                                   t_sh.state_to_numpy(tst))):
        _leaf_close(r, g, f"state leaf {i}")
    for i, (r, g) in enumerate(zip(jax.tree_util.tree_leaves(jdep),
                                   t_sh.dep_to_numpy(tdep))):
        _leaf_close(r, g, f"dep leaf {i}")
    assert float(sum(d.n_paired for d in tdep)) > 0


def _carried(kind):
    """The reference's folded per-shard states and graphs carried into
    the port (``state_from_numpy``): both roll-ups see the same input."""
    jst, jdep, _, _ = folded(kind)
    _, tm = meshes(kind)
    st = t_sh.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)], tm)
    dep = t_sh.dep_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jdep)], tm)
    return jst, jdep, st, dep


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rollup_matches_reference(kind):
    jm, tm = meshes(kind)
    jst, _, st, _ = _carried(kind)
    ref = jax.tree_util.tree_leaves(j_roll.rollup_fn(j_cfg(), jm)(jst))
    got = tree_leaves(t_roll.rollup_fn(t_cfg(), tm)(st))
    assert len(ref) == len(got) == 18
    for i, (r, g) in enumerate(zip(ref, got)):
        _leaf_close(r, _np(g), f"rollup leaf {i}")


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_fleet_rollup_matches_reference(kind):
    jm, tm = meshes(kind)
    jst, jdep, st, dep = _carried(kind)
    ref = j_roll.fleet_rollup_fn(j_cfg(), jm, 512)(jst, jdep)
    got = t_roll.fleet_rollup_fn(t_cfg(), tm, 512)(st, dep)
    for part in ("rollup", "edges"):
        r = jax.tree_util.tree_leaves(getattr(ref, part))
        g = tree_leaves(getattr(got, part))
        assert len(r) == len(g)
        for i, (a, b) in enumerate(zip(r, g)):
            _leaf_close(a, _np(b), f"{part} leaf {i}")
    np.testing.assert_allclose(_np(got.health), np.asarray(ref.health),
                               rtol=1e-6, atol=0)
    assert float(got.edges.nconn.sum()) > 0


def test_rollup_2x2_equals_1d():
    """The two-level mesh's collectives reduce over both axes: the same
    records folded on a 2×2 and a 4-shard mesh roll up alike."""
    a = tree_leaves(t_roll.rollup_fn(t_cfg(), None)(folded("1d")[2]))
    b = tree_leaves(t_roll.rollup_fn(t_cfg(), None)(folded("2x2")[2]))
    for i, (x, y) in enumerate(zip(a, b)):
        _leaf_close(_np(x), _np(y), f"rollup leaf {i}")


def test_state_bridge_round_trip():
    _, _, tst, tdep = folded("1d")
    tm = meshes("1d")[1]
    for to_np, from_np, tree in (
            (t_sh.state_to_numpy, t_sh.state_from_numpy, tst),
            (t_sh.dep_to_numpy, t_sh.dep_from_numpy, tdep)):
        leaves = to_np(tree)
        assert all(x.shape[0] == 4 for x in leaves)
        for a, b in zip(leaves, to_np(from_np(leaves, tm))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="4 shards"):
        t_sh.state_from_numpy(t_sh.state_to_numpy(tst[:2]), tm)
