"""Log-bucketed histogram — the per-entity quantile sketch.

Counterpart of ``gyeeta_tpu/sketch/loghist.py``: ``(..., B)`` counts
over geometric buckets, one scatter-add per microbatch. The bucket is
``floor(log(v/vmin)/log γ)`` taken in f32 torch exactly as the
reference writes it (never through numpy, whose f32 log rounds some
boundary samples differently); a numpy array takes the reference's
numpy path, for the agent-side fold. On the card CUDA's ``logf`` may
still move a boundary sample by one bucket.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.utils.tensor import add_drop


class LogHistSpec(NamedTuple):
    vmin: float
    vmax: float
    nbuckets: int

    @property
    def gamma(self) -> float:
        return float((self.vmax / self.vmin) ** (1.0 / self.nbuckets))

    @property
    def rel_error(self) -> float:
        """Guaranteed max relative quantile error (midpoint interpolation)."""
        g = self.gamma
        return (g - 1.0) / (g + 1.0)


# Response-time spec: 10us .. 100s. gamma≈1.0328 → ≤1.7% error.
RESP_TIME_SPEC = LogHistSpec(vmin=1e-5, vmax=100.0, nbuckets=512)
# QPS / rate spec, geometric over 0.1 .. 1e7.
RATE_SPEC = LogHistSpec(vmin=0.1, vmax=1e7, nbuckets=256)
# Generic percent 0..100.
PERCENT_SPEC = LogHistSpec(vmin=0.5, vmax=100.0, nbuckets=128)


def init(spec: LogHistSpec, entities: tuple = (), dtype=torch.float32,
         device=None):
    """Zero counts of shape ``entities + (B,)``."""
    return torch.zeros(tuple(entities) + (spec.nbuckets,), dtype=dtype,
                       device=resolve(device))


def bucket_of(spec: LogHistSpec, values):
    """values → bucket index [0, B) (int32), clamped at both ends. A
    numpy array takes the reference's numpy path (the agent-side fold of
    ``sketch/edgefold.py`` runs on the host)."""
    if isinstance(values, np.ndarray):
        v = np.maximum(values.astype(np.float32), spec.vmin)
        inv_log_gamma = 1.0 / np.log(spec.gamma)
        b = np.floor(np.log(v / spec.vmin) * inv_log_gamma).astype(np.int32)
        return np.clip(b, 0, spec.nbuckets - 1)
    v = torch.clamp(values.to(torch.float32), min=spec.vmin)
    inv_log_gamma = float(1.0 / np.log(spec.gamma))
    b = torch.floor(torch.log(v / spec.vmin) * inv_log_gamma).to(torch.int32)
    return torch.clamp(b, 0, spec.nbuckets - 1)


def bucket_mid(spec: LogHistSpec, bucket):
    """Geometric midpoint of each bucket."""
    g = spec.gamma
    return spec.vmin * torch.exp(
        (bucket.to(torch.float32) + 0.5) * float(np.float32(np.log(g))))


def update(hist, spec: LogHistSpec, values, weights=None, valid=None):
    """Global histogram (no entity axis) scatter-add, in place: each
    lane adds its weight (1 without ``weights``) to its value's bucket;
    a lane with ``valid`` False adds nothing."""
    b = bucket_of(spec, values)
    w = torch.ones_like(values, dtype=hist.dtype) if weights is None \
        else weights.to(hist.dtype)
    keep = torch.ones_like(b, dtype=torch.bool) if valid is None \
        else valid
    add_drop(hist, b, w, keep)
    return hist


def update_entities(hist, spec: LogHistSpec, entity_row, values,
                    weights=None, valid=None):
    """Per-entity scatter-add at (row, bucket), in place (lane order on
    the CPU)."""
    b = bucket_of(spec, values)
    w = torch.ones_like(values, dtype=hist.dtype) if weights is None \
        else weights.to(hist.dtype)
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
        entity_row = torch.where(valid, entity_row, 0)
    hist.index_put_((entity_row.to(torch.int64), b.to(torch.int64)), w,
                    accumulate=True)
    return hist


def quantiles(hist, spec: LogHistSpec, qs):
    """Quantile estimates per entity: hist (..., B), qs (Q,) → (..., Q).
    Empty histograms return 0."""
    if not isinstance(qs, torch.Tensor):
        # filled on the device: a host copy would block (a sync)
        qs = torch.stack([torch.full((), q, dtype=torch.float32,
                                     device=hist.device) for q in qs])
    cdf = torch.cumsum(hist.to(torch.float32), dim=-1)       # (..., B)
    tot = cdf[..., -1:]                                      # (..., 1)
    target = qs * tot                                        # (..., Q)
    # first bucket where cdf >= target
    ge = cdf[..., None, :] >= target[..., :, None] - 1e-6    # (..., Q, B)
    idx = torch.argmax(ge.to(torch.uint8), dim=-1).to(torch.int32)
    val = bucket_mid(spec, idx)
    return torch.where(tot > 0, val, 0.0)


def merge(a, b):
    """Histograms merge by addition (the shard roll-up)."""
    return a + b


def counts_total(hist):
    return hist.sum(dim=-1)


def mean(hist, spec: LogHistSpec):
    """Mean of each entity's histogram over bucket midpoints (0 if
    empty)."""
    mids = bucket_mid(spec, torch.arange(spec.nbuckets, dtype=torch.int32,
                                         device=hist.device))
    tot = hist.sum(dim=-1)
    s = (hist.to(torch.float32) * mids).sum(dim=-1)
    return torch.where(tot > 0, s / torch.clamp(tot, min=1.0), 0.0)
