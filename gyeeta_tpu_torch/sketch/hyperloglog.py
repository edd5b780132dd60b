"""HyperLogLog distinct counting as a device tensor.

Counterpart of ``gyeeta_tpu/sketch/hyperloglog.py``: a fixed
2^p-register sketch per entity row (``(..., m)`` int32), updated by
scatter-max and merged by elementwise max.

On a CUDA tensor :func:`update` and :func:`update_entities` launch one
fused kernel, ``gyt_hll_update`` (``csrc/sketch_update.cu``): hash,
register index, rank and ``atomicMax`` in one pass over the keys, each
launch counted in :data:`launches`. On a CPU tensor they run their plain
versions (:func:`update_plain`, :func:`update_entities_plain`): the
hash chain of :func:`lanes` followed by ``scatter.scatter_max_plain``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H

_HLL_SALT = 0x1F123BB5      # csrc/sketch_update.cu kHllSalt
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong]

launches = 0                # gyt_hll_update launches


class HLL(NamedTuple):
    regs: torch.Tensor  # (..., m) int32 registers (0..32-p+1)


def init(p: int = 14, entities: tuple = (), device=None) -> HLL:
    m = 1 << p
    return HLL(regs=torch.zeros(entities + (m,), dtype=torch.int32,
                                device=resolve(device)))


def _idx_rank(key_hi, key_lo, p: int):
    h = H.mix64(key_hi, key_lo, _HLL_SALT)
    if isinstance(h, np.ndarray):
        idx = (h >> np.uint32(32 - p)).astype(np.int32)
        w = (h << np.uint32(p)).astype(np.uint32)
        rank = np.minimum(H.leading_zeros32(w), 32 - p) + 1
        return idx, rank
    idx = (h >> (32 - p)).to(torch.int32)
    w = (h << p) & H.M32
    rank = torch.clamp(H.leading_zeros32(w), max=32 - p) + 1
    return idx, rank


def lanes(regs: torch.Tensor, entity_row, key_hi, key_lo, valid=None):
    """The plain hash chain → (flat register index int32, rank int32),
    the ``scatter_max`` lanes of an update. ``entity_row`` None: the
    global update (no entity axis). Invalid lanes carry rank 0 at row 0
    (a max-with-0 no-op)."""
    m = regs.shape[-1]
    p = int(np.log2(m))
    idx, rank = _idx_rank(key_hi, key_lo, p)
    if valid is not None:
        rank = torch.where(valid, rank, 0)
        if entity_row is not None:
            entity_row = torch.where(valid, entity_row, 0)
    if entity_row is not None:
        idx = (entity_row.to(torch.int64) * m + idx).to(torch.int32)
    return idx, rank.to(torch.int32)


def update_plain(sk: HLL, key_hi, key_lo, valid=None) -> HLL:
    """Plain PyTorch version of :func:`update` (in place)."""
    scatter.scatter_max_plain(sk.regs, *lanes(sk.regs, None, key_hi, key_lo,
                                              valid))
    return sk


def update_entities_plain(sk: HLL, entity_row, key_hi, key_lo,
                          valid=None) -> HLL:
    """Plain PyTorch version of :func:`update_entities` (in place)."""
    scatter.scatter_max_plain(sk.regs, *lanes(sk.regs, entity_row, key_hi,
                                              key_lo, valid))
    return sk


def _launch(regs: torch.Tensor, entity_row, key_hi, key_lo, valid) -> None:
    global launches
    if regs.dtype != torch.int32 or not regs.is_contiguous():
        raise TypeError(f"registers must be contiguous int32, got "
                        f"{regs.dtype}")
    m = regs.shape[-1]
    p = m.bit_length() - 1
    if m != 1 << p or not 1 <= p <= 31:
        raise ValueError(f"{m} registers a row: need 2^p, 1 <= p <= 31")
    n = key_hi.shape[0]
    dev = regs.device
    hi = scatter.lane_column(key_hi, torch.int64, n, dev, "key_hi")
    lo = scatter.lane_column(key_lo, torch.int64, n, dev, "key_lo")
    row = None if entity_row is None else \
        scatter.lane_column(entity_row, torch.int64, n, dev, "entity_row")
    ok = None if valid is None else \
        scatter.lane_column(valid, torch.bool, n, dev, "valid")
    if n == 0:
        return
    scatter.launch("gyt_hll_update", _ARGS, dev, regs.data_ptr(),
                   hi.data_ptr(), lo.data_ptr(),
                   None if row is None else row.data_ptr(),
                   None if ok is None else ok.data_ptr(), n, p,
                   regs.numel() // m)
    launches += 1


def update(sk: HLL, key_hi, key_lo, valid=None) -> HLL:
    """Global (no entity axis) register update, in place; lanes whose
    ``valid`` is False write nothing."""
    if sk.regs.device.type == "cpu":
        return update_plain(sk, key_hi, key_lo, valid)
    _launch(sk.regs, None, key_hi, key_lo, valid)
    return sk


def update_entities(sk: HLL, entity_row, key_hi, key_lo, valid=None) -> HLL:
    """Per-entity update, in place: scatter-max at (entity_row, register),
    flattened to ``row*m + register``. A valid lane's row must lie in
    the register file (the kernel traps otherwise)."""
    if sk.regs.device.type == "cpu":
        return update_entities_plain(sk, entity_row, key_hi, key_lo, valid)
    _launch(sk.regs, entity_row, key_hi, key_lo, valid)
    return sk


def estimate(sk: HLL):
    """Cardinality estimate per entity (small/large-range corrected)."""
    m = sk.regs.shape[-1]
    if m >= 128:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    elif m == 64:
        alpha = 0.709
    elif m == 32:
        alpha = 0.697
    else:
        alpha = 0.673
    regs = sk.regs.to(torch.float32)
    inv_sum = torch.sum(torch.exp2(-regs), dim=-1)
    raw = alpha * m * m / inv_sum
    zeros = torch.sum(sk.regs == 0, dim=-1).to(torch.float32)
    # small-range: linear counting when estimate <= 2.5m and empty regs exist
    lc = m * torch.log(m / torch.clamp(zeros, min=1e-9))
    small = (raw <= 2.5 * m) & (zeros > 0)
    est = torch.where(small, lc, raw)
    # large-range (32-bit hash space)
    two32 = torch.tensor(2.0**32, dtype=torch.float32, device=regs.device)
    large = est > two32 / 30.0
    return torch.where(large, -two32 * torch.log1p(-est / two32), est)


def merge(a: HLL, b: HLL) -> HLL:
    return HLL(regs=torch.maximum(a.regs, b.regs))
