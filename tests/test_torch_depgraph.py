"""The port's single-device dependency graph against the reference, all
29 ``DepGraph`` leaves: direct (two-sided) edges, split-half pairing at a
pair capacity small enough that ``dep_fold_many`` runs several chunks
and a remainder, halves whose partner arrives a dispatch later, TTL
``age``, and the edge view and mesh clusters. Integer, bool, u32 and
max-merged (``h_bytes``) leaves are exact; f32 sums rtol 1e-6.

Also the sync-free helpers the port uses in place of JAX's
``mode="drop"`` scatters and ``jnp.nonzero(size=...)``, and the
no-valid-lane identity of ``pair_halves`` that lets the port run it
without the reference's ``lax.cond``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.parallel import depgraph as j_dg
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.ingest import decode as t_dec
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.utils import tensor as T

torch.set_num_threads(1)
PC, EC = 64, 256      # pair capacity → 16-lane pairing chunks
K, B = 3, 40          # 120 lanes a dispatch: 7 chunks + an 8-lane remainder
PTTL, ETTL = 1, 3


def _leaf_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_dep(ref, got):
    paths = _leaf_paths(j_dg.init(1, 1))
    assert len(ref) == len(got) == len(paths) == 29
    for p, a, b in zip(paths, ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, (p, a.dtype,
                                                           b.dtype)
        if a.dtype.kind != "f" or p == ".h_bytes":
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=p)


def _dispatches():
    """Conn slabs of (K, B): plain flows (task→svc direct edges),
    two-sided svc→svc flows, split halves (some partners a dispatch
    later, the last dispatch's never)."""
    sim = JSim(n_hosts=8, n_svcs=4, n_clients=256)
    late = None
    out = []
    for d in range(4):
        bs = []
        for k in range(K):
            cs, ss = sim.svc_conn_records(10, split_halves=True)
            parts = [sim.conn_records(6), sim.svc_conn_records(4), cs]
            if d < 3:
                parts.append(ss)
            if k == 0 and late is not None:
                parts.append(late)
            late = ss if k == K - 1 else late
            recs = np.concatenate(parts)
            frames, _ = j_wire.decode_frames(
                j_wire.encode_frames_chunked(j_wire.NOTIFY_TCP_CONN, recs))
            bs.append(j_dec.conn_batch(frames[0][1], B))
        out.append(bs)
    return out


def _stack_j(bs):
    return jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *bs)


# one compiled reference dispatch shape, shared by the tests
_J_MANY = jax.jit(j_dg.dep_fold_many)


@pytest.fixture(scope="module")
def runs():
    """Both packages through the same dispatches, ageing and views."""
    slabs = _dispatches()
    j_age = jax.jit(lambda d, t: j_dg.age(d, t, PTTL, ETTL))
    jd, td = j_dg.init(PC, EC), t_dg.init(PC, EC, "cpu")
    out = {"ref": [], "got": []}
    for tick, bs in enumerate(slabs):
        jd = _J_MANY(jd, _stack_j(bs), np.int32(tick))
        td = t_dg.dep_fold_many(td, t_dec.to_device(bs, "cpu"), tick)
        out["ref"].append([np.asarray(x) for x in jax.tree.leaves(jd)])
        out["got"].append(t_dg.dep_to_numpy(td))
    for tick in (5, 7):           # halves expire first, then edges
        jd = j_age(jd, np.int32(tick))
        td = t_dg.age(td, tick, PTTL, ETTL)
        out["ref"].append([np.asarray(x) for x in jax.tree.leaves(jd)])
        out["got"].append(t_dg.dep_to_numpy(td))
    out["ref_dep"], out["dep"], out["slabs"] = jd, td, slabs
    return out


@pytest.mark.parametrize("step", range(6), ids=[
    "dispatch0", "dispatch1", "dispatch2", "dispatch3_halves_left",
    "age_halves", "age_edges"])
def test_dep_leaves_match_reference(runs, step):
    _assert_dep(runs["ref"][step], runs["got"][step])


def test_stream_exercises_pairing_and_ageing(runs):
    paths = _leaf_paths(j_dg.init(1, 1))
    at = lambda step, name: runs["got"][step][paths.index(name)]  # noqa: E731
    assert at(0, ".n_paired") > 0 and at(0, ".edge_tbl.n_live") > 0
    # the last dispatch left halves with no partner; ageing expires them
    assert at(3, ".half_tbl.n_live") > 0
    assert at(4, ".half_tbl.n_live") == 0 and at(4, ".n_expired") > 0
    assert at(5, ".edge_tbl.n_live") < at(4, ".edge_tbl.n_live")
    assert at(5, ".n_dropped") == 0


def test_direct_edges_match_reference():
    """Two-sided flows only: every lane is a direct edge, and the port's
    one-batch ``dep_step``, batch by batch, gives the same edges (slots
    may differ: the batches claim them in another order)."""
    sim = JSim(n_hosts=8, n_svcs=4, n_clients=256, seed=3)
    bs = [j_dec.conn_batch(np.concatenate([sim.svc_conn_records(24),
                                           sim.conn_records(12)]), B)
          for _ in range(K)]
    jd = _J_MANY(j_dg.init(PC, EC), _stack_j(bs), np.int32(2))
    td = t_dg.dep_fold_many(t_dg.init(PC, EC, "cpu"),
                            t_dec.to_device(bs, "cpu"), 2)
    _assert_dep([np.asarray(x) for x in jax.tree.leaves(jd)],
                t_dg.dep_to_numpy(td))
    assert int(td.half_tbl.n_live) == 0 and float(td.n_paired) == 0
    assert float(td.e_nconn.sum()) == K * 36
    one = t_dg.init(PC, EC, "cpu")
    for cb in bs:
        one = t_dg.dep_step(one, t_dec.to_device(cb, "cpu"), 2)
    def edges(d):
        live = t_dg.table.live_mask(d.edge_tbl)
        keys = zip(d.edge_tbl.key_hi[live].tolist(),
                   d.edge_tbl.key_lo[live].tolist())
        return dict(zip(keys, d.e_ctr[live].tolist()))

    assert edges(one) == edges(td) and len(edges(td)) > 10


def test_edges_local_and_mesh_clusters_match_reference(runs):
    jd, td = runs["ref_dep"], runs["dep"]
    # the view before the edge TTL fired: rebuild from dispatch 3's leaves
    jd = j_dg.DepGraph(*jax.tree.unflatten(
        jax.tree.structure(jd), [jnp.asarray(a) for a in runs["ref"][3]]))
    td = t_dg.dep_from_numpy(runs["got"][3], "cpu")
    jes = jax.jit(j_dg.edges_local)(jd)
    tes = t_dg.edges_local(td)
    for name, a, b in zip(tes._fields, jax.tree.leaves(jes),
                          T.tree_leaves(tes)):
        a = np.asarray(a)
        b = b.numpy().astype(a.dtype) if a.dtype == np.uint32 else b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    jn, jl, js = jax.jit(lambda e: j_dg.mesh_clusters(e, 64, 4))(jes)
    tn, tl, ts = t_dg.mesh_clusters(tes, 64, 4)
    np.testing.assert_array_equal(tn.key_hi.numpy(),
                                  np.asarray(jn.key_hi).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn.n_live) > 0 and int(ts.max()) > 1


def test_pair_halves_without_valid_lane_is_identity(runs):
    td = t_dg.dep_from_numpy(runs["got"][3], "cpu")
    assert int(td.half_tbl.n_live) > 0          # halves are in flight
    cb = t_dec.to_device(runs["slabs"][0][0], "cpu")
    _, hv = t_dg.halves_from_conn(cb)
    assert bool(hv.valid.any())
    after = t_dg.pair_halves_cond(td, hv._replace(
        valid=torch.zeros_like(hv.valid)), 9)
    for name, a, b in zip(range(29), runs["got"][3],
                          t_dg.dep_to_numpy(after)):
        np.testing.assert_array_equal(b, a, err_msg=str(name))


def test_dep_numpy_round_trip(runs):
    back = t_dg.dep_to_numpy(t_dg.dep_from_numpy(runs["ref"][2], "cpu"))
    for a, b in zip(runs["ref"][2], back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        t_dg.dep_from_numpy(runs["ref"][2][:-1], "cpu")


@pytest.mark.parametrize("size", [1, 5, 16, 40])
def test_compact_true_is_fixed_size_nonzero(size):
    m = np.random.default_rng(size).random(40) < 0.3
    want = np.full(size, 99)
    nz = np.nonzero(m)[0][:size]
    want[:len(nz)] = nz
    got = T.compact_true(torch.from_numpy(m), size, 99)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.nonzero(jnp.asarray(m), size=size,
                                            fill_value=99)[0]))


@pytest.mark.parametrize("reduce", ["amax", "amin"])
def test_reduce_and_set_rows_drop_match_jax(reduce):
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 8, 64)
    keep = rng.random(64) < 0.6
    vals = rng.normal(size=64).astype(np.float32)
    base = rng.normal(size=8).astype(np.float32)
    lanes = jnp.asarray(np.where(keep, idx, 8))
    at = jnp.asarray(base).at[lanes]
    want = at.max(vals, mode="drop") if reduce == "amax" \
        else at.min(vals, mode="drop")
    got = torch.from_numpy(base.copy())
    T.reduce_drop(got, torch.from_numpy(idx), torch.from_numpy(vals),
                  torch.from_numpy(keep), reduce)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # whole-row sets, bool and int32 included, repeated rows equal-valued
    rows = np.arange(8, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                            np.float32)
    for dt in (np.float32, np.int32, bool):
        dst = np.zeros((8, 3), dt)
        want = jnp.asarray(dst).at[lanes].set(
            jnp.asarray(rows[idx].astype(dt)), mode="drop")
        got = torch.from_numpy(dst.copy())
        T.set_rows_drop(got, torch.from_numpy(idx),
                        torch.from_numpy(rows[idx].astype(dt)),
                        torch.from_numpy(keep))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
