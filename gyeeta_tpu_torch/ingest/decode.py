"""Structured wire records → fixed-shape columnar microbatches (numpy).

Counterpart of ``gyeeta_tpu/ingest/decode.py`` for the two record types
of the fold path. The builders stay numpy, exactly as in the reference:
64-bit ids split into ``(hi, lo)`` uint32 pairs, IPs folded to two
uint32 words, the flow 5-tuple hashed to a 64-bit key on the host
(bit-identical to the device hash), and a ``valid`` lane mask marking
padding. :func:`to_device` is the one step the port adds: it stacks K
batches to ``(K, B)`` columns and moves them to the device, with every
uint32 column in the int64 carrier of ``utils/hashing.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils import hashing as H

# listener-stat / host-panel / task / cpu-mem column counts: the widths
# of the state leaves these streams fill (not folded on this path)
NSTAT = 16
NTASKSTAT = 10
NHOSTCOL = 11
NCM = 16


def split_u64(a) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def fold_ip(ip_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,16) uint8 → two uint32 words (xor-fold halves)."""
    w = ip_bytes.reshape(-1, 4, 4).copy().view("<u4").reshape(-1, 4)
    return (w[:, 0] ^ w[:, 2]).astype(np.uint32), \
        (w[:, 1] ^ w[:, 3]).astype(np.uint32)


class ConnBatch(NamedTuple):
    """Columnar TCP_CONN microbatch (all shape (B,))."""
    svc_hi: np.ndarray        # ser_glob_id split — per-service routing key
    svc_lo: np.ndarray
    flow_hi: np.ndarray       # 5-tuple flow key
    flow_lo: np.ndarray
    cli_hi: np.ndarray        # client endpoint identity (HLL distinct-cli)
    cli_lo: np.ndarray
    cli_task_hi: np.ndarray   # client process-group id
    cli_task_lo: np.ndarray
    cli_rel_hi: np.ndarray    # client related-listener id
    cli_rel_lo: np.ndarray
    bytes_sent: np.ndarray    # float32
    bytes_rcvd: np.ndarray    # float32
    duration_us: np.ndarray   # float32 (0 if still open)
    host_id: np.ndarray       # int32 source agent
    is_close: np.ndarray      # bool — close-notification record
    is_accept: np.ndarray     # bool — server-side (accept-observed)
    valid: np.ndarray         # bool lane mask


class RespBatch(NamedTuple):
    svc_hi: np.ndarray
    svc_lo: np.ndarray
    resp_us: np.ndarray       # float32 response/service time in usec
    host_id: np.ndarray
    valid: np.ndarray


def _pad(a: np.ndarray, size: int, fill=0):
    out = np.full((size,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a[:size]
    return out


def _check_fit(recs, size):
    """Batch builders never truncate silently."""
    if len(recs) > size:
        raise ValueError(
            f"{len(recs)} records exceed batch size {size}; split upstream")
    return len(recs)


def conn_batch(recs: np.ndarray, size: int = wire.MAX_CONNS_PER_BATCH
               ) -> ConnBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    svc_hi, svc_lo = split_u64(r["ser_glob_id"])
    # NAT-aware flow identity: when conntrack resolved a translated
    # tuple, both halves key on the POST-NAT 5-tuple
    nat_c = r["nat_cli"]["ip"].any(axis=1)
    nat_s = r["nat_ser"]["ip"].any(axis=1)
    eff_cli = np.where(nat_c[:, None], r["nat_cli"]["ip"], r["cli"]["ip"])
    eff_ser = np.where(nat_s[:, None], r["nat_ser"]["ip"], r["ser"]["ip"])
    eff_cport = np.where(nat_c, r["nat_cli"]["port"], r["cli"]["port"])
    eff_sport = np.where(nat_s, r["nat_ser"]["port"], r["ser"]["port"])
    cip_hi, cip_lo = fold_ip(np.ascontiguousarray(eff_cli))
    sip_hi, sip_lo = fold_ip(np.ascontiguousarray(eff_ser))
    proto = np.full(n, 6, np.uint32)  # TCP
    f_hi, f_lo = H.flow_key(cip_hi, cip_lo, sip_hi, sip_lo,
                            eff_cport.astype(np.uint32),
                            eff_sport.astype(np.uint32), proto)
    # client endpoint identity = address hash only (distinct clients)
    c_hi = H.fmix32(cip_hi ^ np.uint32(0xC11E57))
    c_lo = H.fmix32(cip_lo ^ c_hi)
    t_hi, t_lo = split_u64(r["cli_task_aggr_id"])
    rel_hi, rel_lo = split_u64(r["cli_related_listen_id"])
    closed = r["tusec_close"] > 0
    dur = np.where(closed, r["tusec_close"] - r["tusec_start"],
                   0).astype(np.float32)
    valid = np.zeros(size, bool)
    valid[:n] = True
    return ConnBatch(
        svc_hi=_pad(svc_hi, size), svc_lo=_pad(svc_lo, size),
        flow_hi=_pad(f_hi, size), flow_lo=_pad(f_lo, size),
        cli_hi=_pad(c_hi, size), cli_lo=_pad(c_lo, size),
        cli_task_hi=_pad(t_hi, size), cli_task_lo=_pad(t_lo, size),
        cli_rel_hi=_pad(rel_hi, size), cli_rel_lo=_pad(rel_lo, size),
        bytes_sent=_pad(r["bytes_sent"].astype(np.float32), size),
        bytes_rcvd=_pad(r["bytes_rcvd"].astype(np.float32), size),
        duration_us=_pad(dur, size),
        host_id=_pad(r["host_id"].astype(np.int32), size),
        is_close=_pad(closed, size),
        is_accept=_pad((r["flags"] & 2) != 0, size),
        valid=valid,
    )


def resp_batch(recs: np.ndarray, size: int = wire.MAX_RESP_PER_BATCH
               ) -> RespBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    svc_hi, svc_lo = split_u64(r["glob_id"])
    valid = np.zeros(size, bool)
    valid[:n] = True
    return RespBatch(
        svc_hi=_pad(svc_hi, size), svc_lo=_pad(svc_lo, size),
        resp_us=_pad(r["resp_usec"].astype(np.float32), size),
        host_id=_pad(r["host_id"].astype(np.int32), size),
        valid=valid,
    )


def _col_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.astype(np.int64)          # the u32 carrier
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_device(batches, device=None):
    """One batch (a ConnBatch/RespBatch of ``(B,)`` columns) or a list
    of K batches → the same NamedTuple of tensors on ``device``,
    ``(B,)`` or stacked ``(K, B)``. Defaults to CUDA; raises without a
    GPU unless ``device="cpu"``."""
    dev = resolve(device)
    if isinstance(batches, tuple):
        return type(batches)(*(_col_to_tensor(c, dev) for c in batches))
    cls = type(batches[0])
    return cls(*(_col_to_tensor(np.stack(cols), dev)
                 for cols in zip(*batches)))
