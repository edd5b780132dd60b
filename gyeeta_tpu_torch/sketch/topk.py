"""Top-K heavy hitters over unbounded 64-bit key spaces, as tensors.

Counterpart of ``gyeeta_tpu/sketch/topk.py`` (Misra-Gries-style
truncation): concat the candidate table with the batch lanes, group
equal 64-bit keys with one stable sort, segment-sum duplicates, keep the
top ``capacity`` totals. Evicted mass is accounted in ``evicted``.

The grouping sort orders keys by unsigned ``(hi, lo)`` — the order of
the reference's CPU path — on every device, and every top-k goes
through the shared stable top-k (lower index first on ties).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import top_k

# Reserved sentinel key marking empty/invalid slots (u32 carrier value).
SENTINEL = 0xFFFFFFFF


class TopK(NamedTuple):
    key_hi: torch.Tensor   # (cap,) u32 carrier (SENTINEL = empty slot)
    key_lo: torch.Tensor   # (cap,) u32 carrier
    counts: torch.Tensor   # (cap,) float32
    evicted: torch.Tensor  # () float32 — total mass dropped by truncation


def init(capacity: int = 256, device=None) -> TopK:
    dev = resolve(device)
    return TopK(
        key_hi=torch.full((capacity,), SENTINEL, dtype=torch.int64,
                          device=dev),
        key_lo=torch.full((capacity,), SENTINEL, dtype=torch.int64,
                          device=dev),
        counts=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        evicted=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _combine(hi, lo, vals, capacity: int, evicted) -> TopK:
    """Group by 64-bit key, merge duplicates, keep the heaviest
    ``capacity``."""
    # one int64 key in unsigned (hi, lo) order: hi shifted into the
    # signed range, so the product and sum cannot overflow
    key = (hi - 2**31) * 2**32 + lo
    order = torch.argsort(key, stable=True)
    hi_s, lo_s, v_s = hi[order], lo[order], vals[order]
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=hi.device),
        (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]),
    ])
    seg = torch.cumsum(first.to(torch.int64), dim=0) - 1
    n = hi_s.shape[0]
    seg_tot = torch.zeros(n, dtype=torch.float32, device=hi.device) \
        .index_put_((seg,), v_s, accumulate=True)
    # each segment's total on its first lane; other lanes get 0 mass
    # and sentinel keys, so top-k never surfaces a duplicate key
    lane_tot = torch.where(first, seg_tot[seg], 0.0)
    sentinel_lane = (hi_s == SENTINEL) & (lo_s == SENTINEL)
    lane_tot = torch.where(sentinel_lane, 0.0, lane_tot)
    keep_key = first & ~sentinel_lane
    hi_k = torch.where(keep_key, hi_s, SENTINEL)
    lo_k = torch.where(keep_key, lo_s, SENTINEL)
    top_v, top_i = top_k(lane_tot, capacity)
    empty = top_v <= 0.0
    out_hi = torch.where(empty, SENTINEL, hi_k[top_i])
    out_lo = torch.where(empty, SENTINEL, lo_k[top_i])
    out_v = torch.where(empty, 0.0, top_v)
    new_evicted = evicted + (torch.sum(lane_tot) - torch.sum(out_v))
    return TopK(key_hi=out_hi, key_lo=out_lo, counts=out_v,
                evicted=new_evicted)


def update(sk: TopK, key_hi, key_lo, values, valid=None, est=None,
           budget: int = 0) -> TopK:
    """Fold a batch of (key, value) lanes into the top-K table.

    ``est``/``budget``: sketch-assisted candidate compaction — only the
    ``budget`` highest-estimate valid lanes enter the grouping sort, and
    the mass left out is added to ``evicted``. Requires ``valid``."""
    capacity = sk.counts.shape[0]
    vals = values.to(torch.float32)
    key_hi = H.u32(key_hi)
    key_lo = H.u32(key_lo)
    if valid is not None:
        vals = torch.where(valid, vals, 0.0)
        # invalid lanes get the sentinel key → merged into the dead segment
        key_hi = torch.where(valid, key_hi, SENTINEL)
        key_lo = torch.where(valid, key_lo, SENTINEL)
    n = key_hi.shape[0]
    evicted = sk.evicted
    if est is not None and 0 < budget < n:
        if valid is None:
            raise ValueError("est-compacted update requires valid")
        score = torch.where(valid, est.to(torch.float32), -1.0)
        _, idx = top_k(score, budget)
        hi_c, lo_c, v_c = key_hi[idx], key_lo[idx], vals[idx]
        evicted = evicted + torch.sum(vals) - torch.sum(v_c)
        key_hi, key_lo, vals = hi_c, lo_c, v_c
    return _combine(torch.cat([sk.key_hi, key_hi]),
                    torch.cat([sk.key_lo, key_lo]),
                    torch.cat([sk.counts, vals]), capacity, evicted)


def merge(a: TopK, b: TopK) -> TopK:
    """Two tables → one of ``a``'s capacity: duplicate keys sum, the
    truncated mass joins both tables' ``evicted``."""
    return _combine(torch.cat([a.key_hi, b.key_hi]),
                    torch.cat([a.key_lo, b.key_lo]),
                    torch.cat([a.counts, b.counts]), a.counts.shape[0],
                    a.evicted + b.evicted)


def query(sk: TopK, k: int):
    """(key_hi, key_lo, counts) of the top k entries, count descending."""
    k = min(k, sk.counts.shape[0])
    v, i = top_k(sk.counts, k)
    return sk.key_hi[i], sk.key_lo[i], v


def dense_topk(stats, k: int):
    """(values, row indices) of the ``k`` largest entries of a dense
    per-entity stat along its last axis, lower index first on ties."""
    return top_k(stats, k)
