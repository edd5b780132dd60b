"""Count-Min sketch as a device tensor.

Counterpart of ``gyeeta_tpu/sketch/countmin.py``: ``(depth, width)``
f32 counts, row streams from Kirsch-Mitzenmacher double hashing. The
update flattens every row into one scatter-add with row offsets
``r*width`` and goes through :func:`scatter.scatter_add`, the CUDA
kernel on the card. Estimates are upper bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H


class CMS(NamedTuple):
    counts: torch.Tensor  # (depth, width) float32


def init(depth: int = 4, width: int = 1 << 16, dtype=torch.float32,
         device=None) -> CMS:
    return CMS(counts=torch.zeros((depth, width), dtype=dtype,
                                  device=resolve(device)))


def update(sk: CMS, key_hi, key_lo, values, valid=None) -> CMS:
    """Scatter-add ``values`` for 64-bit keys, in place; padding lanes
    (``valid`` False) add 0."""
    depth, width = sk.counts.shape
    vals = values.to(sk.counts.dtype)
    if valid is not None:
        vals = torch.where(valid, vals, torch.zeros_like(vals))
    buckets = H.bucket_indices_km(key_hi, key_lo, depth, width)
    flat_idx = torch.cat([b + r * width for r, b in enumerate(buckets)])
    scatter.scatter_add(sk.counts, flat_idx, vals.repeat(depth))
    return sk


def query(sk: CMS, key_hi, key_lo):
    """Point estimate (min over rows) for a batch of keys."""
    depth, width = sk.counts.shape
    est = None
    for r, idx in enumerate(H.bucket_indices_km(key_hi, key_lo, depth,
                                                width)):
        v = sk.counts[r][idx]
        est = v if est is None else torch.minimum(est, v)
    return est


def upper_bound(sk: CMS, key_hi, key_lo, rows: int = 1):
    """Point estimate from the first ``rows`` hash rows only — still an
    upper bound, at 1/depth of the gather cost."""
    depth, width = sk.counts.shape
    rows = min(rows, depth)
    est = None
    for r, idx in enumerate(H.bucket_indices_km(key_hi, key_lo, rows,
                                                width)):
        v = sk.counts[r][idx]
        est = v if est is None else torch.minimum(est, v)
    return est


def merge(a: CMS, b: CMS) -> CMS:
    return CMS(counts=a.counts + b.counts)


def total(sk: CMS):
    """Total inserted weight (any row sums to it)."""
    return sk.counts[0].sum()
