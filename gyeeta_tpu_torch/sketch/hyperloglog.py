"""HyperLogLog distinct counting as a device tensor.

Counterpart of ``gyeeta_tpu/sketch/hyperloglog.py``: a fixed
2^p-register sketch per entity row (``(..., m)`` int32), updated by
scatter-max — here always through :func:`scatter.scatter_max`, the CUDA
kernel on the card — and merged by elementwise max.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H

_HLL_SALT = 0x1F123BB5


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


def update(sk: HLL, key_hi, key_lo, valid=None) -> HLL:
    """Global (no entity axis) register update, in place. Rank is
    pre-masked to 0 on invalid lanes (a max-with-0 no-op)."""
    p = int(np.log2(sk.regs.shape[-1]))
    idx, rank = _idx_rank(key_hi, key_lo, p)
    if valid is not None:
        rank = torch.where(valid, rank, 0)
    scatter.scatter_max(sk.regs, idx, rank.to(torch.int32))
    return sk


def update_entities(sk: HLL, entity_row, key_hi, key_lo, valid=None) -> HLL:
    """Per-entity update, in place: scatter-max at (entity_row, register),
    flattened to ``row*m + register``."""
    m = sk.regs.shape[-1]
    p = int(np.log2(m))
    idx, rank = _idx_rank(key_hi, key_lo, p)
    if valid is not None:
        rank = torch.where(valid, rank, 0)
        entity_row = torch.where(valid, entity_row, 0)
    flat_idx = (entity_row.to(torch.int64) * m + idx).to(torch.int32)
    scatter.scatter_max(sk.regs, flat_idx, rank.to(torch.int32))
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
