"""The port's hashing against the reference's numpy and jnp paths.

Exact: every index the sketches use comes from these functions, and the
port carries u32 values in int64 (``gyeeta_tpu_torch/utils/hashing.py``).
Inputs are adversarial u32 values (0, 1, 0x7FFFFFFF, 0x80000000,
0xFFFFFFFE, 0xFFFFFFFF) plus seeded random ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyeeta_tpu.utils import hashing as JH
from gyeeta_tpu_torch.utils import hashing as TH

torch.set_num_threads(1)

_EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _u32(n, seed):
    r = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([_EDGE, r.astype(np.uint32)])


HI = _u32(250, 1)
LO = np.roll(_u32(250, 2), 3)       # edge values meet other edge values


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(t_out, *refs):
    got = _np(t_out)
    for ref in refs:
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got, ref.astype(np.int64)
                                      if got.dtype == np.int64 else ref)
        assert got.dtype in (np.int64, ref.dtype)


def test_fmix32():
    _same(TH.fmix32(_t(HI)), JH.fmix32(HI), JH.fmix32(jnp.asarray(HI)))
    np.testing.assert_array_equal(TH.fmix32(HI), JH.fmix32(HI))


@pytest.mark.parametrize("salt", [0, 1, 0x1F123BB5, 0x7AB1E5, 0xFFFFFFFF])
def test_mix64(salt):
    _same(TH.mix64(_t(HI), _t(LO), salt), JH.mix64(HI, LO, salt),
          JH.mix64(jnp.asarray(HI), jnp.asarray(LO), salt))
    np.testing.assert_array_equal(TH.mix64(HI, LO, salt),
                                  JH.mix64(HI, LO, salt))


@pytest.mark.parametrize("depth,nbuckets", [(1, 1 << 10), (2, 1 << 17),
                                            (4, 1000), (3, 2**31 - 1)])
def test_bucket_indices_km(depth, nbuckets):
    got = TH.bucket_indices_km(_t(HI), _t(LO), depth, nbuckets)
    ref_np = JH.bucket_indices_km(HI, LO, depth, nbuckets)
    ref_j = JH.bucket_indices_km(jnp.asarray(HI), jnp.asarray(LO), depth,
                                 nbuckets)
    own_np = TH.bucket_indices_km(HI, LO, depth, nbuckets)
    for g, a, b, c in zip(got, ref_np, ref_j, own_np):
        assert g.dtype == torch.int32
        _same(g, a, b)
        np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("nbuckets", [1, 7, 4096, 1 << 17, 2**31 - 1])
def test_range_map_and_bucket_index(nbuckets):
    _same(TH._range_map(_t(HI), nbuckets), JH._range_map(HI, nbuckets),
          JH._range_map(jnp.asarray(HI), nbuckets))
    _same(TH.bucket_index(_t(HI), _t(LO), 0x1B5E12A7, nbuckets),
          JH.bucket_index(HI, LO, 0x1B5E12A7, nbuckets),
          JH.bucket_index(jnp.asarray(HI), jnp.asarray(LO), 0x1B5E12A7,
                          nbuckets))


def test_leading_zeros32():
    x = np.concatenate([HI, (np.uint32(1) << np.arange(32, dtype=np.uint32)),
                        (np.uint32(1) << np.arange(32, dtype=np.uint32))
                        - np.uint32(1)])
    got = TH.leading_zeros32(_t(x))
    assert got.dtype == torch.int32
    _same(got, JH.leading_zeros32(x), JH.leading_zeros32(jnp.asarray(x)))


def test_flow_key():
    rng = np.random.default_rng(3)
    sport = np.concatenate([[0, 0xFFFF, 1, 0x8000, 0, 0xFFFF],
                            rng.integers(0, 2**16, 250)]).astype(np.uint32)
    dport = np.roll(sport, 1)
    proto = np.full(len(HI), 6, np.uint32)
    args = (HI, LO, np.roll(HI, 5), np.roll(LO, 7), sport, dport, proto)
    got = TH.flow_key(*map(_t, args))
    ref = JH.flow_key(*args)
    ref_j = JH.flow_key(*map(jnp.asarray, args))
    for g, a, b in zip(got, ref, ref_j):
        _same(g, a, b)
    for g, a in zip(TH.flow_key(*args), ref):
        np.testing.assert_array_equal(g, a)


def test_int32_inputs_reinterpret_as_u32():
    """A negative int32 tensor is its two's-complement u32, as
    ``astype(uint32)`` reads it."""
    x = HI.view(np.int32)
    _same(TH.fmix32(torch.from_numpy(x.copy())), JH.fmix32(HI))
