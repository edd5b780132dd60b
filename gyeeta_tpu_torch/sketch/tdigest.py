"""t-digest as fixed-capacity centroid tensors.

Counterpart of ``gyeeta_tpu/sketch/tdigest.py``: the merging t-digest
with k-bin compression (sort by mean, midpoint quantiles, arcsine scale
k1, segment-sum into the fixed C slots). The reference vmaps the
compression over entity rows; here the batch dimension is written out
(``(R, N)`` tensors). Every argsort is stable, as ``jnp.argsort`` is,
and the top-m selection of :func:`flush_staged_topm` uses the shared
stable top-k, so rows and ties come out in the reference's order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.utils.tensor import set_drop, add_drop, top_k


class TDigest(NamedTuple):
    means: torch.Tensor    # (..., C) float32, sorted ascending among occupied
    weights: torch.Tensor  # (..., C) float32, 0 = empty slot
    vmin: torch.Tensor     # (...,) float32 observed min (inf if empty)
    vmax: torch.Tensor     # (...,) float32 observed max (-inf if empty)


def init(capacity: int = 128, entities: tuple = (), device=None) -> TDigest:
    dev = resolve(device)
    return TDigest(
        means=torch.zeros(entities + (capacity,), dtype=torch.float32,
                          device=dev),
        weights=torch.zeros(entities + (capacity,), dtype=torch.float32,
                            device=dev),
        vmin=torch.full(entities, math.inf, dtype=torch.float32, device=dev),
        vmax=torch.full(entities, -math.inf, dtype=torch.float32,
                        device=dev),
    )


def _k1(q, delta):
    # arcsine scale: dense bins at the tails → tail quantile accuracy
    return (delta / (2.0 * math.pi)) * torch.arcsin(
        torch.clamp(2.0 * q - 1.0, -1.0, 1.0))


def _compress(means, weights, capacity: int):
    """Cluster each row of (R, N) (means, weights) into ≤capacity
    centroids → (R, capacity) means and weights."""
    delta = 2.0 * (capacity - 1)
    # empty slots sort to the end
    sort_key = torch.where(weights > 0, means, math.inf)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    m = torch.gather(means, -1, order)
    w = torch.gather(weights, -1, order)
    tot = torch.sum(w, dim=-1, keepdim=True)
    cum = torch.cumsum(w, dim=-1)
    q_mid = (cum - 0.5 * w) / torch.clamp(tot, min=1e-30)
    zero = torch.zeros((), dtype=torch.float32, device=means.device)
    k = _k1(q_mid, delta) - _k1(zero, delta)
    cid = torch.clamp(torch.floor(k).to(torch.int64), 0, capacity - 1)
    cid = torch.where(w > 0, cid, capacity - 1)
    shape = means.shape[:-1] + (capacity,)
    new_w = torch.zeros(shape, dtype=torch.float32, device=means.device) \
        .scatter_add_(-1, cid, w)
    new_s = torch.zeros(shape, dtype=torch.float32, device=means.device) \
        .scatter_add_(-1, cid, w * m)
    new_m = torch.where(new_w > 0, new_s / torch.clamp(new_w, min=1e-30),
                        0.0)
    return new_m, new_w


def update(sk: TDigest, values, valid=None) -> TDigest:
    """Fold a batch of unit-weight samples into a single-entity digest
    → a new digest; a lane with ``valid`` False carries no weight."""
    capacity = sk.means.shape[-1]
    vals = values.to(torch.float32)
    w_in = torch.ones_like(vals)
    if valid is not None:
        w_in = torch.where(valid, w_in, 0.0)
    new_m, new_w = _compress(torch.cat([sk.means, vals])[None],
                             torch.cat([sk.weights, w_in])[None], capacity)
    return TDigest(
        means=new_m[0], weights=new_w[0],
        vmin=torch.minimum(sk.vmin,
                           torch.where(w_in > 0, vals, math.inf).amin()),
        vmax=torch.maximum(sk.vmax,
                           torch.where(w_in > 0, vals, -math.inf).amax()))


def merge(a: TDigest, b: TDigest) -> TDigest:
    """Concatenate and recompress, row by row over any leading entity
    axes → a new digest of ``a``'s capacity."""
    capacity = a.means.shape[-1]
    all_m = torch.cat([a.means, b.means], dim=-1)
    all_w = torch.cat([a.weights, b.weights], dim=-1)
    new_m, new_w = _compress(all_m.reshape(-1, all_m.shape[-1]),
                             all_w.reshape(-1, all_w.shape[-1]), capacity)
    return TDigest(means=new_m.reshape(a.means.shape),
                   weights=new_w.reshape(a.weights.shape),
                   vmin=torch.minimum(a.vmin, b.vmin),
                   vmax=torch.maximum(a.vmax, b.vmax))


def count(sk: TDigest):
    """Total weight of each digest."""
    return sk.weights.sum(dim=-1)


def stage_samples(stage_v, stage_n, rows, values, valid=None):
    """Append per-entity samples into the (S, cap) staging buffer without
    compressing, in place. Returns (stage_v, stage_n, n_overflow);
    samples past a full entity buffer are dropped and counted."""
    S, cap = stage_v.shape
    B = rows.shape[0]
    vals = values.to(torch.float32)
    ok = rows >= 0
    if valid is not None:
        ok = ok & valid
    rows_ok = torch.where(ok, rows.to(torch.int64), S)
    order = torch.argsort(rows_ok, stable=True)
    r_s = rows_ok[order]
    v_s = vals[order]
    lane = torch.arange(B, dtype=torch.int64, device=rows.device)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=rows.device),
                       r_s[1:] != r_s[:-1]])
    seg_start = torch.cummax(torch.where(first, lane, 0), dim=0).values
    pos = lane - seg_start
    base = stage_n[torch.clamp(r_s, 0, S - 1)].to(torch.int64)
    slot = base + pos
    keep = (r_s < S) & (slot < cap)
    n_overflow = torch.sum((r_s < S) & (slot >= cap)).to(torch.int32)
    set_drop(stage_v, r_s * cap + slot, v_s, keep)
    add_drop(stage_n, r_s, keep.to(torch.int32), keep)
    return stage_v, stage_n, n_overflow


def _fold_stage(means, weights, vmin, vmax, stage, n):
    """Compress staged rows into their digests → (means, weights, vmin,
    vmax) of the same rows."""
    C = means.shape[-1]
    cap = stage.shape[-1]
    occ = torch.arange(cap, device=stage.device)[None, :] < n[:, None]
    all_m = torch.cat([means, stage], dim=-1)
    all_w = torch.cat([weights, occ.to(torch.float32)], dim=-1)
    new_m, new_w = _compress(all_m, all_w, C)
    v_min = torch.where(occ, stage, math.inf).amin(dim=-1)
    v_max = torch.where(occ, stage, -math.inf).amax(dim=-1)
    return new_m, new_w, torch.minimum(vmin, v_min), \
        torch.maximum(vmax, v_max)


def flush_staged(sk: TDigest, stage_v, stage_n):
    """Fold the whole staging buffer into the per-entity digests in one
    batched compression and clear the stage, in place. Returns
    (digest, stage_v, stage_n)."""
    new = _fold_stage(sk.means, sk.weights, sk.vmin, sk.vmax, stage_v,
                      stage_n)
    for dst, src in zip(sk, new):
        dst.copy_(src)
    stage_v.zero_()
    stage_n.zero_()
    return sk, stage_v, stage_n


def flush_staged_topm(sk: TDigest, stage_v, stage_n, m: int):
    """Partial flush, in place: compress only the ``m`` entities with the
    fullest stages (O(m) instead of O(S)) and clear their stages. Rows
    with nothing staged keep their centroids bit for bit."""
    S = sk.means.shape[0]
    m = min(m, S)
    nsel, idx = top_k(stage_n, m)
    sel = [x[idx] for x in sk]
    new_m, new_w, v_min, v_max = _fold_stage(*sel, stage_v[idx], nsel)
    has = (nsel > 0)[:, None]
    sk.means.index_copy_(0, idx, torch.where(has, new_m, sel[0]))
    sk.weights.index_copy_(0, idx, torch.where(has, new_w, sel[1]))
    sk.vmin.index_copy_(0, idx, v_min)
    sk.vmax.index_copy_(0, idx, v_max)
    stage_v.index_fill_(0, idx, 0.0)
    stage_n.index_fill_(0, idx, 0)
    return sk, stage_v, stage_n


def quantiles(sk: TDigest, qs):
    """Quantile estimates of digests with any leading entity axes:
    (..., C) → (..., Q). Empty digests return 0."""
    qs = torch.as_tensor(qs, dtype=torch.float32, device=sk.means.device)
    w = sk.weights
    m = sk.means
    vmin = sk.vmin[..., None]
    vmax = sk.vmax[..., None]
    sort_key = torch.where(w > 0, m, math.inf)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    m = torch.gather(m, -1, order)
    w = torch.gather(w, -1, order)
    # empty tail slots interpolate toward the observed max, not toward 0
    m = torch.where(w > 0, m, vmax)
    tot = torch.sum(w, dim=-1, keepdim=True)
    cum = torch.cumsum(w, dim=-1)
    left = cum - 0.5 * w                      # midpoint mass per centroid
    target = qs * tot                         # (..., Q)
    ge = left[..., None, :] >= target[..., :, None]            # (..., Q, C)
    hi_idx = torch.argmax(ge.to(torch.uint8), dim=-1)
    hi_idx = torch.where(ge.any(dim=-1), hi_idx, m.shape[-1] - 1)
    lo_idx = torch.clamp(hi_idx - 1, min=0)
    x0 = torch.gather(left, -1, lo_idx)
    x1 = torch.gather(left, -1, hi_idx)
    y0 = torch.gather(m, -1, lo_idx)
    y1 = torch.gather(m, -1, hi_idx)
    t = torch.where(x1 > x0, (target - x0) / torch.clamp(x1 - x0, min=1e-30),
                    0.0)
    est = y0 + t * (y1 - y0)
    # below the first midpoint → interpolate from vmin
    left0 = left[..., :1]
    below = target < left0
    est = torch.where(below, vmin + (m[..., :1] - vmin) *
                      (target / torch.clamp(left0, min=1e-30)), est)
    est = torch.minimum(torch.maximum(est, vmin), vmax)
    return torch.where(tot > 0, est, 0.0)


quantiles_entities = quantiles
