"""Invertible heavy-flow sketch: candidate buckets that remember keys.

Counterpart of ``gyeeta_tpu/sketch/invertible.py`` (update side; decode
comes with heavy-hitter recovery in a later slice): a ``(depth, width)``
bucket array where each bucket keeps the key with the highest CMS
priority that ever hashed there, XOR-folded with a fingerprint-derived
mask. The ``prio`` scatter-max goes through :func:`scatter.scatter_max`
(f32; the CUDA kernel on the card). Candidate replacement settles one
winner per bucket by lexicographic (prio, key_hi, key_lo) max rounds, so
duplicate lanes of one key write identical values and the result never
depends on scatter order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import set_drop, top_k

_SALT_BUCKET = 0x1B5E12A7
_SALT_FP = 0x7F4A7C15
_MASK_HI = 0xA5A5A5A5
_MASK_LO = 0x5A5A5A5A


class InvSketch(NamedTuple):
    prio: torch.Tensor     # (d, w) f32 candidate priority (CMS estimate)
    enc_hi: torch.Tensor   # (d, w) u32 carrier: XOR-folded key high half
    enc_lo: torch.Tensor   # (d, w) u32 carrier: XOR-folded key low half
    fp: torch.Tensor       # (d, w) u32 carrier: candidate fingerprint
    n_hot: torch.Tensor    # () f32 lanes at/above the hot threshold


def init(depth: int = 2, width: int = 4096, device=None) -> InvSketch:
    dev = resolve(device)
    z = lambda dt: torch.zeros((depth, width), dtype=dt, device=dev)  # noqa: E731,E501
    return InvSketch(prio=z(torch.float32), enc_hi=z(torch.int64),
                     enc_lo=z(torch.int64), fp=z(torch.int64),
                     n_hot=torch.zeros((), dtype=torch.float32, device=dev))


def fingerprint(key_hi, key_lo):
    """32-bit key fingerprint on its own hash stream."""
    return H.mix64(key_hi, key_lo, _SALT_FP)


def buckets(key_hi, key_lo, depth: int, width: int) -> list:
    """Per-row bucket indices on the invertible tier's own salts."""
    return [H.bucket_index(key_hi, key_lo, _SALT_BUCKET + r, width)
            for r in range(depth)]


def encode_key(key_hi, key_lo, fp):
    """XOR-fold the key halves with fingerprint-derived masks."""
    if isinstance(fp, np.ndarray):
        with np.errstate(over="ignore"):
            return (key_hi ^ H.fmix32(fp ^ np.uint32(_MASK_HI)),
                    key_lo ^ H.fmix32(fp ^ np.uint32(_MASK_LO)))
    return (H.u32(key_hi) ^ H.fmix32(fp ^ _MASK_HI),
            H.u32(key_lo) ^ H.fmix32(fp ^ _MASK_LO))


def update(sk: InvSketch, key_hi, key_lo, prio, valid,
           hot=None, budget: int = 0) -> InvSketch:
    """Fold a batch of key lanes with per-lane ``prio``, in place.

    ``hot``: optional bool mask of lanes at/above the hot admission
    threshold (counted into ``n_hot`` before compaction). ``budget``:
    only the ``budget`` highest-priority lanes enter the candidate
    writes (0 = every lane competes)."""
    d, w = sk.prio.shape
    key_hi = H.u32(key_hi)
    key_lo = H.u32(key_lo)
    pr = torch.where(valid, prio.to(torch.float32), 0.0)
    n = key_hi.shape[0]
    n_hot = sk.n_hot
    if hot is not None:
        n_hot = n_hot + torch.sum(valid & hot).to(torch.float32)
    if 0 < budget < n:
        score = torch.where(valid, pr, -1.0)
        _, sel = top_k(score, budget)
        key_hi, key_lo = key_hi[sel], key_lo[sel]
        pr = torch.where(score[sel] >= 0, pr[sel], 0.0)
        valid = valid[sel] & (score[sel] >= 0)
    bks = buckets(key_hi, key_lo, d, w)
    old = [sk.prio[r][b.to(torch.int64)] for r, b in enumerate(bks)]
    flat_idx = torch.cat([b + r * w for r, b in enumerate(bks)])
    scatter.scatter_max(sk.prio, flat_idx, pr.repeat(d))

    fp_l = fingerprint(key_hi, key_lo)
    e_hi, e_lo = encode_key(key_hi, key_lo, fp_l)
    for r, b in enumerate(bks):
        bl = b.to(torch.int64)
        # winners: lanes that reached the bucket's NEW max priority AND
        # strictly raised it (an unchallenged incumbent stays put)
        win = valid & (pr == sk.prio[r][bl]) & (pr > old[r])
        # lexicographic tie-break between distinct keys at equal
        # priority: max key_hi among winners, then key_lo
        for key in (key_hi, key_lo):
            mx = torch.zeros(w, dtype=torch.int64, device=key.device) \
                .index_reduce_(0, bl, torch.where(win, key, 0), "amax")
            win = win & (key == mx[bl])
        set_drop(sk.enc_hi[r], bl, e_hi, win)
        set_drop(sk.enc_lo[r], bl, e_lo, win)
        set_drop(sk.fp[r], bl, fp_l, win)
    return sk._replace(n_hot=n_hot)
