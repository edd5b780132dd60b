"""The port's scatter kernels' plain versions against the reference's
Pallas kernels (``gyeeta_tpu/sketch/pallas_scatter.py``), which run in
Pallas interpret mode on the CPU.

The Pallas calls are made through ``_scatter_max_call`` /
``_scatter_add_call`` — the functions that reach ``pl.pallas_call`` —
so no XLA fallback can stand in for them. Max is order-free: exact.
Add: exact for integer-valued sums below 2**24; rtol 1e-6 otherwise (the
reference's own bar, pallas_scatter.py:178), since the CUDA kernel adds
in no fixed order.

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
    assert S.scatter_max_launches == 0 and S.scatter_add_launches == 0
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx.long(), val)              # idx dtype
    with pytest.raises(TypeError):
        S.scatter_max(regs, idx, val.float())             # val dtype
    with pytest.raises(TypeError):
        S.scatter_add(regs, idx, val)                     # add is f32 only
    with pytest.raises(TypeError):
        S.scatter_max(regs.long(), idx, val.long())       # target dtype
    with pytest.raises(ValueError):
        S.scatter_max(torch.zeros(8, 8, dtype=torch.int32).t(), idx, val)
    with pytest.raises(ValueError):
        S.scatter_max(regs, idx[:4], val)                 # shapes
    with pytest.raises(IndexError):
        S.scatter_max(regs, torch.tensor([64], dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32))  # out of range


@pytest.mark.gpu
def test_cuda_tensor_launches_kernel_not_plain(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    def refuse(*a):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(S, "scatter_max_plain", refuse)
    monkeypatch.setattr(S, "scatter_add_plain", refuse)
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
    assert S.scatter_max_launches == 1 and S.scatter_add_launches == 1
    want = np.zeros(1 << 10, np.int32)
    np.maximum.at(want, idx, val)
    np.testing.assert_array_equal(regs.cpu().numpy(), want)
    wadd = np.zeros(1 << 10, np.float32)
    np.add.at(wadd, fidx, np.round(fval))
    np.testing.assert_array_equal(counts.cpu().numpy(), wadd)
