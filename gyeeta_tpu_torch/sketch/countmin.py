"""Count-Min sketch as a device tensor.

Counterpart of ``gyeeta_tpu/sketch/countmin.py``: ``(depth, width)``
f32 counts, row streams from Kirsch-Mitzenmacher double hashing.
Estimates are upper bounds.

On a CUDA tensor :func:`update` launches one fused kernel,
``gyt_cms_update`` (``csrc/sketch_update.cu``): each lane hashes its key
once and adds its value to its bucket in every row, each launch counted
in :data:`launches`. On a CPU tensor it runs :func:`update_plain`: the
hash chain of :func:`lanes` (every row flattened into one scatter-add
with row offsets ``r*width``) followed by ``scatter.scatter_add_plain``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_int]

launches = 0                # gyt_cms_update launches


class CMS(NamedTuple):
    counts: torch.Tensor  # (depth, width) float32


def init(depth: int = 4, width: int = 1 << 16, dtype=torch.float32,
         device=None) -> CMS:
    return CMS(counts=torch.zeros((depth, width), dtype=dtype,
                                  device=resolve(device)))


def lanes(counts: torch.Tensor, key_hi, key_lo, values, valid=None):
    """The plain hash chain → (flat index int32, value), the
    ``scatter_add`` lanes of an update: row r's lanes at offset
    ``r*width``; padding lanes (``valid`` False) add 0."""
    depth, width = counts.shape
    vals = values.to(counts.dtype)
    if valid is not None:
        vals = torch.where(valid, vals, torch.zeros_like(vals))
    buckets = H.bucket_indices_km(key_hi, key_lo, depth, width)
    flat_idx = torch.cat([b + r * width for r, b in enumerate(buckets)])
    return flat_idx, vals.repeat(depth)


def update_plain(sk: CMS, key_hi, key_lo, values, valid=None) -> CMS:
    """Plain PyTorch version of :func:`update` (in place)."""
    scatter.scatter_add_plain(sk.counts, *lanes(sk.counts, key_hi, key_lo,
                                                values, valid))
    return sk


def update(sk: CMS, key_hi, key_lo, values, valid=None) -> CMS:
    """Add ``values`` for 64-bit keys into every row, in place; padding
    lanes (``valid`` False) add nothing."""
    global launches
    counts = sk.counts
    if counts.device.type == "cpu":
        return update_plain(sk, key_hi, key_lo, values, valid)
    if counts.dtype != torch.float32 or not counts.is_contiguous():
        raise TypeError(f"counts must be contiguous float32, got "
                        f"{counts.dtype}")
    depth, width = counts.shape
    n = key_hi.shape[0]
    dev = counts.device
    hi = scatter.lane_column(key_hi, torch.int64, n, dev, "key_hi")
    lo = scatter.lane_column(key_lo, torch.int64, n, dev, "key_lo")
    vals = scatter.lane_column(values, torch.float32, n, dev, "values")
    ok = None if valid is None else \
        scatter.lane_column(valid, torch.bool, n, dev, "valid")
    if n == 0:
        return sk
    scatter.launch("gyt_cms_update", _ARGS, dev, counts.data_ptr(),
                   hi.data_ptr(), lo.data_ptr(), vals.data_ptr(),
                   None if ok is None else ok.data_ptr(), n, depth, width)
    launches += 1
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
