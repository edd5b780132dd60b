"""Invertible heavy-flow sketch: candidate buckets that remember keys.

Counterpart of ``gyeeta_tpu/sketch/invertible.py``: a ``(depth, width)``
bucket array where each bucket keeps the key with the highest CMS
priority that ever hashed there, XOR-folded with a fingerprint-derived
mask. Candidate replacement settles one winner per bucket by
lexicographic (prio, key_hi, key_lo) max rounds, so duplicate lanes of
one key write identical values and the result never depends on scatter
order.

:func:`update` keeps the hot count and the budgeted candidate selection
in PyTorch and hands the surviving lanes to :func:`write_candidates`. On
a CUDA tensor that launches one fused kernel, ``gyt_inv_update``
(``csrc/sketch_update.cu``: the priority scatter-max and the winner
election of each row in shared memory), counted in :data:`launches`; on
a CPU tensor it runs :func:`write_candidates_plain`.

Recovery reads the buckets back: :func:`decode_keys` un-folds and
verifies every candidate, :func:`decode` adds its CMS estimate, and the
host half (:func:`cms_error_term`, :func:`merge_recovered_np`) merges
them with the exact top-K lanes into the heavy-flow view.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.sketch import scatter
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import set_drop, top_k

# the kernel's own copies: csrc/sketch_update.cu kInvSalt* / kInvMask*
_SALT_BUCKET = 0x1B5E12A7
_SALT_FP = 0x7F4A7C15
_MASK_HI = 0xA5A5A5A5
_MASK_LO = 0x5A5A5A5A
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3

launches = 0                # gyt_inv_update launches


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


def decode_key(enc_hi, enc_lo, fp):
    """Inverse of :func:`encode_key` (XOR is its own inverse)."""
    return encode_key(enc_hi, enc_lo, fp)


def lanes(prio: torch.Tensor, key_hi, key_lo, pr):
    """The plain hash chain of the priority update → (per-row bucket
    indices, flat index int32, value): the ``scatter_max`` lanes, row
    r's at offset ``r*width``, ``pr`` pre-masked (0 on invalid lanes)."""
    d, w = prio.shape
    bks = buckets(key_hi, key_lo, d, w)
    flat_idx = torch.cat([b + r * w for r, b in enumerate(bks)])
    return bks, flat_idx, pr.repeat(d)


def write_candidates_plain(sk: InvSketch, key_hi, key_lo, prio,
                           valid) -> None:
    """Plain PyTorch version of :func:`write_candidates` (in place)."""
    w = sk.prio.shape[1]
    key_hi = H.u32(key_hi)
    key_lo = H.u32(key_lo)
    pr = torch.where(valid, prio.to(torch.float32), 0.0)
    bks, flat_idx, flat_pr = lanes(sk.prio, key_hi, key_lo, pr)
    old = [sk.prio[r][b.to(torch.int64)] for r, b in enumerate(bks)]
    scatter.scatter_max_plain(sk.prio, flat_idx, flat_pr)

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


def write_candidates(sk: InvSketch, key_hi, key_lo, prio, valid) -> None:
    """Fold lanes with priority ``prio`` (0 where ``valid`` is False) into
    the buckets, in place: each bucket's priority becomes its max, and a
    lane that strictly raised it, with the largest (key_hi, key_lo) among
    such lanes, writes its encoded key and fingerprint there."""
    global launches
    if sk.prio.device.type == "cpu":
        write_candidates_plain(sk, key_hi, key_lo, prio, valid)
        return
    d, w = sk.prio.shape
    if sk.prio.dtype != torch.float32 or any(
            t.dtype != torch.int64 for t in (sk.enc_hi, sk.enc_lo, sk.fp)):
        raise TypeError("prio must be float32 and enc_hi/enc_lo/fp int64")
    if not all(t.is_contiguous() and t.shape == (d, w)
               for t in (sk.prio, sk.enc_hi, sk.enc_lo, sk.fp)):
        raise ValueError("prio, enc_hi, enc_lo and fp must be contiguous "
                         f"({d}, {w})")
    n = key_hi.shape[0]
    dev = sk.prio.device
    hi = scatter.lane_column(key_hi, torch.int64, n, dev, "key_hi")
    lo = scatter.lane_column(key_lo, torch.int64, n, dev, "key_lo")
    pr = scatter.lane_column(prio, torch.float32, n, dev, "prio")
    ok = scatter.lane_column(valid, torch.bool, n, dev, "valid")
    if n == 0:
        return
    scatter.launch(
        "gyt_inv_update", _ARGS, dev, sk.prio.data_ptr(),
        sk.enc_hi.data_ptr(), sk.enc_lo.data_ptr(), sk.fp.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), pr.data_ptr(), ok.data_ptr(), n, d, w,
        refused=f"a row of {w} buckets needs {12 * w} B of shared memory, "
        "more than a block of this card may use")
    launches += 1


def update(sk: InvSketch, key_hi, key_lo, prio, valid,
           hot=None, budget: int = 0) -> InvSketch:
    """Fold a batch of key lanes with per-lane ``prio``, in place.

    ``hot``: optional bool mask of lanes at/above the hot admission
    threshold (counted into ``n_hot`` before compaction). ``budget``:
    only the ``budget`` highest-priority lanes enter the candidate
    writes (0 = every lane competes)."""
    prio = prio.to(torch.float32)
    n = key_hi.shape[0]
    n_hot = sk.n_hot
    if hot is not None:
        n_hot = n_hot + torch.sum(valid & hot).to(torch.float32)
    if 0 < budget < n:
        score = torch.where(valid, prio, -1.0)
        _, sel = top_k(score, budget)
        key_hi, key_lo, prio = key_hi[sel], key_lo[sel], prio[sel]
        valid = valid[sel] & (score[sel] >= 0)
    write_candidates(sk, key_hi, key_lo, prio, valid)
    return sk._replace(n_hot=n_hot)


# ------------------------------------------------------------- recovery
def decode_keys(sk: InvSketch):
    """Un-fold every bucket's candidate → ``(khi, klo, ok)``, all
    ``(d, w)``. ``ok``: the bucket is occupied, the decoded key's
    fingerprint matches the stored one, and the key hashes into its own
    bucket position on that row's stream."""
    d, w = sk.prio.shape
    khi, klo = decode_key(sk.enc_hi, sk.enc_lo, sk.fp)
    ok = (sk.prio > 0) & (fingerprint(khi, klo) == sk.fp)
    pos = torch.arange(w, dtype=torch.int64, device=khi.device)
    rows = [ok[r] & (H.bucket_index(khi[r], klo[r], _SALT_BUCKET + r, w)
                     == pos) for r in range(d)]
    return khi, klo, torch.stack(rows)


def decode(sk: InvSketch, cms):
    """Full recovery pass: decoded candidates and their CMS point
    estimates, flattened to ``(d·w,)`` columns."""
    from gyeeta_tpu_torch.sketch import countmin

    khi, klo, ok = decode_keys(sk)
    hi_f, lo_f = khi.reshape(-1), klo.reshape(-1)
    est = countmin.query(cms, hi_f, lo_f).to(torch.float32)
    est = torch.where(ok.reshape(-1), est, 0.0)
    return {"hh_hi": hi_f, "hh_lo": lo_f, "hh_ok": ok.reshape(-1),
            "hh_est": est}


def merge(a: InvSketch, b: InvSketch) -> InvSketch:
    """Bucket-wise merge → a new sketch: the higher-priority candidate
    wins each bucket (the streaming update's rule; ``a`` keeps a tie);
    ``n_hot`` adds."""
    take_b = b.prio > a.prio
    return InvSketch(prio=torch.maximum(a.prio, b.prio),
                     enc_hi=torch.where(take_b, b.enc_hi, a.enc_hi),
                     enc_lo=torch.where(take_b, b.enc_lo, a.enc_lo),
                     fp=torch.where(take_b, b.fp, a.fp),
                     n_hot=a.n_hot + b.n_hot)


def cms_error_term(total_mass, width: int):
    """Per-key CMS overestimate bound, ``2·N/width``: the error term
    every recovered row carries (recovered counts are upper bounds)."""
    return 2.0 * total_mass / max(int(width), 1)


def merge_recovered_np(rec: dict, err_term: float,
                       hot_thresh: float = 0.0):
    """Host half of recovery: the exact top-K lanes ∪ the decoded
    candidates → ``(flow_rows, recovered_ids, hot_ids)``. Rows are
    ``(id_hex, value, errbound, source)``, heaviest first (value desc,
    id asc on ties). Exact lanes: value = max(count, est), errbound =
    value − count. Recovered-only candidates: value = est, errbound =
    ``err_term``. ``hot_ids``: recovered ids at/above ``hot_thresh``
    (all of them when it is 0)."""
    t_hi = np.asarray(rec["topk_hi"], np.uint64)
    t_lo = np.asarray(rec["topk_lo"], np.uint64)
    t_cnt = np.asarray(rec["topk_counts"], np.float64)
    t_est = np.asarray(rec["topk_est"], np.float64)
    m = t_cnt > 0
    exact_ids = (t_hi[m] << np.uint64(32)) | t_lo[m]
    rows = []
    for k, cnt, est in zip(exact_ids.tolist(), t_cnt[m].tolist(),
                           t_est[m].tolist()):
        val = max(cnt, est)
        rows.append((format(int(k), "016x"), float(val),
                     float(val - cnt), "exact"))
    exact_set = set(exact_ids.tolist())

    c_ok = np.asarray(rec["hh_ok"], bool)
    c_hi = np.asarray(rec["hh_hi"], np.uint64)[c_ok]
    c_lo = np.asarray(rec["hh_lo"], np.uint64)[c_ok]
    c_est = np.asarray(rec["hh_est"], np.float64)[c_ok]
    cand = {}
    for k, v in zip(((c_hi << np.uint64(32)) | c_lo).tolist(),
                    c_est.tolist()):
        if v > 0 and k not in exact_set:
            cand[k] = max(cand.get(k, 0.0), v)
    recovered_ids = set(cand)
    hot_ids = {k for k, v in cand.items() if v >= hot_thresh} \
        if hot_thresh > 0 else set(recovered_ids)
    rows.extend((format(k, "016x"), float(v), float(err_term),
                 "recovered") for k, v in cand.items())
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows, recovered_ids, hot_ids
