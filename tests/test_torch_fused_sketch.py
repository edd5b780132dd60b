"""The fused sketch updates: their plain versions against the reference on
edge cases, the shared hash header built for the host, and each fused
CUDA kernel against its plain version on the card.

- Plain versions (``hyperloglog.update`` / ``update_entities``,
  ``countmin.update``, ``invertible.update`` on CPU tensors) against the
  JAX functions of ``gyeeta_tpu/sketch`` on the XLA path: HLL ranks at
  the ``32-p`` clamp, all-invalid batches, a CMS width that is not a
  power of two, invertible lanes whose distinct keys tie at a bucket's
  new maximum priority, incumbents that only equal it, and the budgeted
  selection. HLL and invertible state exact; CMS rtol 1e-6 (XLA and
  PyTorch add in different orders; the reference's own bar,
  pallas_scatter.py:178).
- ``csrc/hash32.cuh`` compiled by the host C++ compiler through a small
  shim and held bit for bit against ``utils/hashing.py``: mix64,
  range_map, the Kirsch-Mitzenmacher rows and the HLL index and rank.
- ``gpu``-marked: each fused kernel against its plain version on the
  card, at small sizes:
  ``python -m pytest --noconftest -m gpu tests/test_torch_fused_sketch.py``.

JAX is imported inside the ``ref`` fixture, so that the CUDA-only tests
also run where JAX is not installed (the GPU machine).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gyeeta_tpu_torch.sketch import countmin as TC, hyperloglog as THLL, \
    invertible as TI
from gyeeta_tpu_torch.utils import hashing as H

torch.set_num_threads(1)
CSRC = Path(TC.__file__).resolve().parents[1] / "csrc"
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from gyeeta_tpu.sketch import countmin, hyperloglog, invertible
    return jax, jnp, hyperloglog, countmin, invertible


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _keys(n, seed, distinct=None):
    rng = np.random.default_rng(seed)
    pool = distinct or n
    hi = rng.integers(0, 2**32, pool, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, pool, dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, pool, n)
    return hi[pick], lo[pick]


def _fmix32_inv(h):
    """Inverse of ``hashing.fmix32`` (each of its steps is a bijection)."""
    h = np.asarray(h, np.uint32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(pow(H._C2, -1, 2**32))
        h = h ^ (h >> np.uint32(13)) ^ (h >> np.uint32(26))
        h = h * np.uint32(pow(H._C1, -1, 2**32))
        h = h ^ (h >> np.uint32(16))
    return h


def _keys_hashing_to(h, salt, seed):
    """Keys (hi, lo) with ``mix64(hi, lo, salt) == h``: a seeded random
    ``lo``, and ``hi`` solved through the inverse finalizer."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**32, len(h), dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        s = np.uint32((salt + 1) & M32) * np.uint32(H._GOLDEN)
    hi = _fmix32_inv(h) ^ H.fmix32(lo ^ s) ^ np.uint32(salt)
    return hi.astype(np.uint32), lo


def _clamp_keys(p, seed):
    """32 keys whose HLL hash leaves the low 32-p bits zero (rank clamped
    to 32-p+1), 32 that leave only the lowest bit set (rank 32-p), and
    the all-zero and all-one hashes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << p, 64, dtype=np.uint64).astype(np.uint32)
    h = idx << np.uint32(32 - p)
    h[32:] |= np.uint32(1)
    h = np.concatenate([h, np.array([0, M32], np.uint32)])
    hi, lo = _keys_hashing_to(h, THLL._HLL_SALT, seed + 1)
    np.testing.assert_array_equal(H.mix64(hi, lo, THLL._HLL_SALT), h)
    _, rank = THLL._idx_rank(hi, lo, p)
    assert (rank[:32] == 32 - p + 1).all() and (rank[32:64] == 32 - p).all()
    assert rank[64] == 32 - p + 1 and rank[65] == 1
    return hi, lo


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(
        np.int64) if np.asarray(j).dtype == np.uint32 else np.asarray(j))


# ------------------------------------------------------------------ HLL
@pytest.mark.parametrize("p", [6, 8])
def test_hll_rank_clamp_matches_reference(ref, p):
    jax, jnp, JHLL, _, _ = ref
    hi, lo = _clamp_keys(p, 40 + p)
    rng = np.random.default_rng(p)
    rows = rng.integers(0, 4, len(hi)).astype(np.int32)
    valid = np.ones(len(hi), bool)
    valid[::5] = False
    jg = JHLL.update(JHLL.init(p=p), jnp.asarray(hi), jnp.asarray(lo),
                     valid=jnp.asarray(valid))
    tg = THLL.update(THLL.init(p=p, device="cpu"), _t(hi), _t(lo),
                     valid=_t(valid))
    _same(tg.regs, jg.regs)
    assert int(tg.regs.max()) == 32 - p + 1
    je = JHLL.update_entities(JHLL.init(p=p, entities=(4,)),
                              jnp.asarray(rows), jnp.asarray(hi),
                              jnp.asarray(lo), valid=jnp.asarray(valid))
    te = THLL.update_entities(THLL.init(p=p, entities=(4,), device="cpu"),
                              _t(rows), _t(hi), _t(lo), valid=_t(valid))
    _same(te.regs, je.regs)


def test_all_invalid_batch_changes_nothing(ref):
    jax, jnp, JHLL, JC, JI = ref
    hi, lo = _keys(96, 3)
    none = np.zeros(96, bool)
    rows = np.arange(96, dtype=np.int32) % 4
    vals = np.arange(96, dtype=np.float32) + 1
    base = np.random.default_rng(4).integers(0, 5, (4, 64)).astype(np.int32)
    je = JHLL.update_entities(JHLL.HLL(jnp.asarray(base)), jnp.asarray(rows),
                              jnp.asarray(hi), jnp.asarray(lo),
                              valid=jnp.asarray(none))
    te = THLL.update_entities(THLL.HLL(torch.from_numpy(base.copy())),
                              _t(rows), _t(hi), _t(lo), valid=_t(none))
    _same(te.regs, je.regs)
    np.testing.assert_array_equal(te.regs.numpy(), base)
    tg = THLL.update(THLL.HLL(torch.from_numpy(base[0].copy())), _t(hi),
                     _t(lo), valid=_t(none))
    np.testing.assert_array_equal(tg.regs.numpy(), base[0])
    jc = JC.update(JC.init(2, 1 << 10), jnp.asarray(hi), jnp.asarray(lo),
                   jnp.asarray(vals), valid=jnp.asarray(none))
    tc = TC.update(TC.init(2, 1 << 10, device="cpu"), _t(hi), _t(lo),
                   _t(vals), valid=_t(none))
    _same(tc.counts, jc.counts)
    assert not tc.counts.any()
    ji = JI.update(JI.init(2, 256), jnp.asarray(hi), jnp.asarray(lo),
                   jnp.asarray(vals), jnp.asarray(none))
    ti = TI.update(TI.init(2, 256, device="cpu"), _t(hi), _t(lo), _t(vals),
                   _t(none))
    for a, b in zip(ti, ji):
        _same(a, b)


# ------------------------------------------------------------------ CMS
@pytest.mark.parametrize("depth,width", [(2, 1 << 10), (3, 1000), (4, 1021)])
def test_cms_width_matches_reference(ref, depth, width):
    jax, jnp, _, JC, _ = ref
    hi, lo = _keys(700, 5, distinct=250)
    rng = np.random.default_rng(6)
    vals = (rng.pareto(1.5, 700) * 3000).astype(np.float32)
    valid = rng.random(700) < 0.85
    jc = JC.update(JC.init(depth, width), jnp.asarray(hi), jnp.asarray(lo),
                   jnp.asarray(vals), valid=jnp.asarray(valid))
    tc = TC.update(TC.init(depth, width, device="cpu"), _t(hi), _t(lo),
                   _t(vals), valid=_t(valid))
    np.testing.assert_allclose(tc.counts.numpy(), np.asarray(jc.counts),
                               rtol=1e-6, atol=0)
    for r, b in enumerate(H.bucket_indices_km(hi, lo, depth, width)):
        assert b.max() < width
        np.testing.assert_array_equal(
            tc.counts[r].numpy() > 0,
            np.bincount(b[valid], minlength=width) > 0)


# ----------------------------------------------------------- invertible
def _tie_lanes(width, seed):
    """Lanes whose distinct keys collide in row-0 buckets and share each
    bucket's top priority: groups of random keys, and groups of keys with
    one ``key_hi`` and distinct ``key_lo`` (the second tie-break round).
    → (hi, lo, prio, valid)."""
    rng = np.random.default_rng(seed)
    hi, lo = _keys(4096, seed)
    hi[:2048] = hi[0]
    b0 = H.bucket_index(hi, lo, TI._SALT_BUCKET, width)
    lanes = []
    for half in (slice(0, 2048), slice(2048, 4096)):
        idx = np.arange(4096)[half]
        for b in np.unique(b0[idx])[:24]:
            grp = idx[b0[idx] == b][:4]
            top = np.float32(rng.integers(50, 60))
            pr = np.full(len(grp), top, np.float32)
            pr[-1] = top - 1 if len(grp) > 2 else top
            lanes += [(i, p) for i, p in zip(grp, pr)]
    sel = np.array([i for i, _ in lanes])
    prio = np.array([p for _, p in lanes], np.float32)
    valid = rng.random(len(sel)) < 0.9
    hi, lo = hi[sel], lo[sel]
    # duplicate lanes of one key, and an invalid lane with a huge prio
    hi = np.concatenate([hi, hi[:6], hi[7:8]])
    lo = np.concatenate([lo, lo[:6], lo[7:8]])
    prio = np.concatenate([prio, prio[:6], [1e9]]).astype(np.float32)
    valid = np.concatenate([valid, valid[:6], [False]])
    return hi, lo, prio, valid


@pytest.mark.parametrize("budget", [0, 48])
def test_invertible_ties_and_budget_match_reference(ref, budget):
    jax, jnp, _, _, JI = ref
    w = 256
    hi, lo, prio, valid = _tie_lanes(w, 8)
    hot = prio >= 55
    jup = jax.jit(JI.update, static_argnames="budget")
    j = JI.init(2, w)
    t = TI.init(2, w, device="cpu")
    # the second batch: the same keys, some raising and some only
    # equalling their buckets' priorities (an incumbent that is only
    # equalled stays put), and fresh keys
    hi2, lo2 = _keys(64, 9)
    prio2 = np.concatenate([prio + np.float32(1) * (np.arange(len(prio)) % 2),
                            np.full(64, 55, np.float32)]).astype(np.float32)
    batches = [(hi, lo, prio, valid, hot),
               (np.concatenate([hi, hi2]), np.concatenate([lo, lo2]), prio2,
                np.concatenate([valid, np.ones(64, bool)]),
                np.concatenate([hot, np.zeros(64, bool)]))]
    for bh, bl, bp, bv, bhot in batches:
        j = jup(j, jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(bp),
                jnp.asarray(bv), hot=jnp.asarray(bhot), budget=budget)
        t = TI.update(t, _t(bh), _t(bl), _t(bp), _t(bv), hot=_t(bhot),
                      budget=budget)
        for a, b in zip(t, j):
            _same(a, b)
    assert int((t.fp != 0).sum()) > 40


# ------------------------------------------------- hash32.cuh on the host
_SHIM = r"""
#include "hash32.cuh"
extern "C" void shim(const uint32_t* hi, const uint32_t* lo, int n,
                     uint32_t salt, uint32_t hll_salt, uint32_t nb,
                     int depth, int p,
                     uint32_t* mix, uint32_t* rmap, uint32_t* km,
                     uint32_t* idx, int* rank, uint32_t* fm) {
    for (int i = 0; i < n; ++i) {
        mix[i] = gyt::mix64(hi[i], lo[i], salt);
        rmap[i] = gyt::range_map(mix[i], nb);
        const uint32_t h1 = gyt::mix64(hi[i], lo[i], gyt::kKmSalt1);
        const uint32_t h2 = gyt::mix64(hi[i], lo[i], gyt::kKmSalt2) | 1u;
        for (int r = 0; r < depth; ++r)
            km[r * n + i] = gyt::km_bucket(h1, h2, r, nb);
        const uint32_t h = gyt::mix64(hi[i], lo[i], hll_salt);
        idx[i] = gyt::hll_index(h, p);
        rank[i] = gyt::hll_rank(h, p);
        fm[i] = gyt::fmix32(lo[i]);
    }
}
"""


@pytest.fixture(scope="module")
def hash_shim(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++ or clang++) on PATH to "
                    "build csrc/hash32.cuh")
    d = tmp_path_factory.mktemp("hash32")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    lib.shim.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_uint32,
                         ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                         ctypes.c_int] + [ptr] * 6
    lib.shim.restype = None
    return lib


@pytest.mark.parametrize("salt,nb,p", [
    (THLL._HLL_SALT, 1 << 10, 6),
    (TI._SALT_BUCKET + 1, 4096, 14),
    (0xFFFFFFFF, 1000, 8),
])
def test_hash32_header_matches_hashing_py(hash_shim, salt, nb, p):
    n, depth = 1 << 16, 4
    hi, lo = _keys(n, salt & 0xFFFF)
    hi[:66], lo[:66] = _clamp_keys(p, 7)
    hi[66], lo[66] = 0, 0
    hi[67], lo[67] = M32, M32
    out = {k: np.zeros(n, np.uint32) for k in ("mix", "rmap", "idx", "fm")}
    km = np.zeros((depth, n), np.uint32)
    rank = np.zeros(n, np.int32)
    p_ = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    hash_shim.shim(p_(hi), p_(lo), n, salt, THLL._HLL_SALT, nb, depth, p,
                   p_(out["mix"]),
                   p_(out["rmap"]), p_(km), p_(out["idx"]), p_(rank),
                   p_(out["fm"]))
    mix = H.mix64(hi, lo, salt)
    np.testing.assert_array_equal(out["mix"], mix)
    np.testing.assert_array_equal(out["rmap"], H._range_map(mix, nb))
    np.testing.assert_array_equal(out["fm"], H.fmix32(lo))
    for r, b in enumerate(H.bucket_indices_km(hi, lo, depth, nb)):
        np.testing.assert_array_equal(km[r], b)
    want_idx, want_rank = THLL._idx_rank(hi, lo, p)
    np.testing.assert_array_equal(out["idx"], want_idx)
    np.testing.assert_array_equal(rank, want_rank)
    assert (want_rank == 32 - p + 1).sum() >= 33
    # the torch path of hashing.py agrees with its numpy path
    np.testing.assert_array_equal(
        H.mix64(_t(hi), _t(lo), salt).numpy(), mix.astype(np.int64))


# ------------------------------------------------------- on the card only
def _on_cuda(x):
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    return isinstance(x, tuple) and any(_on_cuda(y) for y in x)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused kernels have no CPU mode")

    def guard(fn):
        def plain_on_cpu_only(*a, **k):
            if any(_on_cuda(x) for x in (*a, *k.values())):
                raise AssertionError(f"{fn.__name__} ran on a CUDA tensor")
            return fn(*a, **k)
        return plain_on_cpu_only

    for mod, names in ((THLL, ("update_plain", "update_entities_plain")),
                       (TC, ("update_plain",)),
                       (TI, ("write_candidates_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, guard(getattr(mod, name)))
    return torch.device("cuda")


def _c(a, dev):
    return _t(a).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [6, 14])
def test_cuda_hll_update_kernel_matches_plain(cuda, p):
    hi, lo = _keys(5000, 11, distinct=1500)
    ch, cl = _clamp_keys(p, 12)
    hi, lo = np.concatenate([hi, ch]), np.concatenate([lo, cl])
    n = len(hi)
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 64, n).astype(np.int64)
    valid = rng.random(n) < 0.8
    rows[~valid] = -1                 # ignored on invalid lanes
    base = rng.integers(0, 4, (64, 1 << p)).astype(np.int32)
    THLL.launches = 0
    got = [THLL.update_entities(THLL.HLL(_c(base, cuda)), _c(rows, cuda),
                                _c(hi, cuda), _c(lo, cuda),
                                valid=_c(valid, cuda)),
           THLL.update(THLL.HLL(_c(base[0], cuda)), _c(hi, cuda),
                       _c(lo, cuda), valid=_c(valid, cuda)),
           THLL.update(THLL.HLL(_c(base[1], cuda)), _c(hi, cuda),
                       _c(lo, cuda))]
    torch.cuda.synchronize()
    assert THLL.launches == 3
    want = [THLL.update_entities(THLL.HLL(_t(base)), _t(rows), _t(hi),
                                 _t(lo), valid=_t(valid)),
            THLL.update(THLL.HLL(_t(base[0])), _t(hi), _t(lo),
                        valid=_t(valid)),
            THLL.update(THLL.HLL(_t(base[1])), _t(hi), _t(lo))]
    assert THLL.launches == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.regs.cpu().numpy(), w.regs.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("depth,width", [(2, 1 << 10), (3, 1000)])
def test_cuda_cms_update_kernel_matches_plain(cuda, depth, width):
    hi, lo = _keys(6000, 14, distinct=900)
    rng = np.random.default_rng(15)
    vals = (rng.pareto(1.5, 6000) * 3000).astype(np.float32)
    valid = rng.random(6000) < 0.85
    TC.launches = 0
    got = TC.update(TC.init(depth, width, device=cuda), _c(hi, cuda),
                    _c(lo, cuda), _c(vals, cuda), valid=_c(valid, cuda))
    torch.cuda.synchronize()
    want = TC.update(TC.init(depth, width, device="cpu"), _t(hi), _t(lo),
                     _t(vals), valid=_t(valid))
    assert TC.launches == 1
    np.testing.assert_allclose(got.counts.cpu().numpy(), want.counts.numpy(),
                               rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 4096, 8192])
def test_cuda_inv_update_kernel_matches_plain(cuda, width):
    hi, lo, prio, valid = _tie_lanes(width, 16)
    hi2, lo2 = _keys(3000, 17, distinct=700)
    rng = np.random.default_rng(18)
    hi, lo = np.concatenate([hi, hi2]), np.concatenate([lo, lo2])
    prio = np.concatenate([prio, rng.integers(1, 60, 3000)]) \
        .astype(np.float32)
    valid = np.concatenate([valid, rng.random(3000) < 0.9])
    TI.launches = 0
    g = TI.init(2, width, device=cuda)
    c = TI.init(2, width, device="cpu")
    for step in range(2):
        bp = prio + np.float32(step) * (np.arange(len(prio)) % 3 == 0)
        g = TI.update(g, _c(hi, cuda), _c(lo, cuda), _c(bp, cuda),
                      _c(valid, cuda), budget=1024 * step)
        c = TI.update(c, _t(hi), _t(lo), _t(bp), _t(valid),
                      budget=1024 * step)
    torch.cuda.synchronize()
    assert TI.launches == 2
    for name, a, b in zip(TI.InvSketch._fields, g, c):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                      err_msg=name)


@pytest.mark.gpu
def test_cuda_inv_update_too_wide_raises(cuda):
    sk = TI.init(2, 1 << 15, device=cuda)
    hi, lo = _keys(8, 19)
    with pytest.raises(ValueError, match="shared memory"):
        TI.update(sk, _c(hi, cuda), _c(lo, cuda), torch.ones(8, device=cuda),
                  torch.ones(8, dtype=torch.bool, device=cuda))
