"""Device-resident keyed entity table (open addressing, batched probes).

Counterpart of ``gyeeta_tpu/engine/table.py``: a fixed-capacity hash
slab of 64-bit keys carried as ``(hi, lo)`` u32 halves (the int64
carrier of ``utils/hashing.py``), resolved for a whole batch in
``PROBES`` double-hash rounds. Intra-batch insert races are settled by a
scatter-min over lane numbers, so one batch always gives one slab.

:func:`upsert`, :func:`upsert_fast` / :func:`upsert_fast2`,
:func:`delete`, :func:`tombstone_rows` and :func:`compact` update the
table (and :func:`compact` the state columns) in place, the reference
donates them. :func:`upsert_fast2`'s ``lax.cond`` becomes a Python
``if`` on the any-miss flag: one device→host sync per call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import set_drop, set_rows_drop

# Key sentinels (u32 carrier values).
EMPTY = 0xFFFFFFFF
TOMB = 0xFFFFFFFE

PROBES = 16  # double-hash probe rounds


class Table(NamedTuple):
    key_hi: torch.Tensor   # (S,) u32 carrier
    key_lo: torch.Tensor   # (S,) u32 carrier
    n_live: torch.Tensor   # () int32 — live keys
    n_tomb: torch.Tensor   # () int32 — tombstones awaiting compaction
    n_drop: torch.Tensor   # () int32 — inserts dropped (probe exhaustion)


def init(capacity: int, device=None) -> Table:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    dev = resolve(device)
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return Table(
        key_hi=torch.full((capacity,), EMPTY, dtype=torch.int64, device=dev),
        key_lo=torch.full((capacity,), EMPTY, dtype=torch.int64, device=dev),
        n_live=z(), n_tomb=z(), n_drop=z())


def _probe_slots(khi, klo, capacity: int):
    """(B, PROBES) int64 candidate slots via double hashing (odd step)."""
    h1 = H.mix64(khi, klo, 0x7AB1E5)
    h2 = H.mix64(khi, klo, 0x57E9) | 1
    p = torch.arange(PROBES, dtype=torch.int64, device=h1.device)
    return (h1[:, None] + p[None, :] * h2[:, None]) & (capacity - 1)


def _is_empty(hi, lo):
    return (hi == EMPTY) & (lo == EMPTY)


def _is_tomb(hi, lo):
    return (hi == TOMB) & (lo == TOMB)


def _first_true(m):
    """Index of the first True along dim 1 (0 when none, like argmax)."""
    return torch.argmax(m.to(torch.uint8), dim=1, keepdim=True)


def upsert(tbl: Table, khi, klo, valid=None):
    """Resolve (or insert) a batch of keys, in place → (table, rows).

    rows: (B,) int64 — slab row per lane, or -1 for invalid lanes and
    for inserts dropped after probe exhaustion (counted in ``n_drop``).
    """
    capacity = tbl.key_hi.shape[0]
    khi = H.u32(khi)
    klo = H.u32(klo)
    B = khi.shape[0]
    dev = khi.device
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=dev)
    # never insert sentinel-valued keys
    valid = valid & ~_is_empty(khi, klo) & ~_is_tomb(khi, klo)
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    slots = _probe_slots(khi, klo, capacity)            # (B, P)
    rows = torch.full((B,), -1, dtype=torch.int64, device=dev)
    key_hi, key_lo = tbl.key_hi, tbl.key_lo
    inserted = torch.zeros((), dtype=torch.int32, device=dev)

    def match_rows(rows):
        m = (key_hi[slots] == khi[:, None]) & (key_lo[slots] == klo[:, None])
        found = m.any(dim=1) & valid
        mrow = slots.gather(1, _first_true(m))[:, 0]
        return torch.where((rows < 0) & found, mrow, rows)

    for _ in range(PROBES):
        rows = match_rows(rows)
        unresolved = valid & (rows < 0)
        cur_hi = key_hi[slots]
        cur_lo = key_lo[slots]
        claimable = _is_empty(cur_hi, cur_lo) | _is_tomb(cur_hi, cur_lo)
        target = slots.gather(1, _first_true(claimable))[:, 0]
        want = unresolved & claimable.any(dim=1)
        # deterministic winner per contested slot: lowest lane index
        winner = torch.full((capacity + 1,), B, dtype=torch.int32,
                            device=dev).index_reduce_(
            0, torch.where(want, target, capacity), lane, "amin")
        win = want & (winner[target] == lane)
        was_tomb = _is_tomb(key_hi[target], key_lo[target])
        set_drop(key_hi, target, khi, win)
        set_drop(key_lo, target, klo, win)
        rows = torch.where(win, target, rows)
        inserted += win.sum().to(torch.int32)
        tbl.n_tomb.sub_((win & was_tomb).sum().to(torch.int32))
    # duplicates of a last-round winner resolve in this final pass
    rows = match_rows(rows)
    tbl.n_live.add_(inserted)
    tbl.n_drop.add_((valid & (rows < 0)).sum().to(torch.int32))
    return tbl, rows


def upsert_fast(tbl: Table, khi, klo, valid=None):
    """:func:`upsert_fast2` without the flag → (table, rows)."""
    tbl, rows, _ = upsert_fast2(tbl, khi, klo, valid)
    return tbl, rows


def upsert_fast2(tbl: Table, khi, klo, valid=None):
    """Upsert that skips the insert rounds when every key already
    resolves → (table, rows, any_miss). ``any_miss`` (a Python bool) is
    True when the batch carried a key not yet resident; reading it is
    the one device→host sync of this call."""
    khi = H.u32(khi)
    klo = H.u32(klo)
    if valid is None:
        valid = torch.ones((khi.shape[0],), dtype=torch.bool,
                           device=khi.device)
    rows0 = lookup(tbl, khi, klo, valid)
    any_miss = bool(torch.any(valid & (rows0 < 0) & ~_is_empty(khi, klo)
                              & ~_is_tomb(khi, klo)))
    if any_miss:
        tbl, rows = upsert(tbl, khi, klo, valid)
    else:
        rows = rows0
    return tbl, rows, any_miss


def lookup(tbl: Table, khi, klo, valid=None):
    """Rows for a batch of keys without inserting; -1 = absent."""
    capacity = tbl.key_hi.shape[0]
    khi = H.u32(khi)
    klo = H.u32(klo)
    if valid is None:
        valid = torch.ones((khi.shape[0],), dtype=torch.bool,
                           device=khi.device)
    slots = _probe_slots(khi, klo, capacity)
    m = (tbl.key_hi[slots] == khi[:, None]) & \
        (tbl.key_lo[slots] == klo[:, None])
    found = m.any(dim=1) & valid
    rows = slots.gather(1, _first_true(m))[:, 0]
    return torch.where(found, rows, -1)


def live_mask(tbl: Table):
    return ~_is_empty(tbl.key_hi, tbl.key_lo) & \
        ~_is_tomb(tbl.key_hi, tbl.key_lo)


def delete(tbl: Table, khi, klo, valid=None):
    """Tombstone a batch of keys in place → (table, rows_deleted).

    Callers clear state columns at the returned rows (>= 0). A row stays
    unusable until :func:`compact` or until an insert reclaims it."""
    rows = lookup(tbl, khi, klo, valid)
    hit_lane = rows >= 0
    set_rows_drop(tbl.key_hi, rows, TOMB, hit_lane)
    set_rows_drop(tbl.key_lo, rows, TOMB, hit_lane)
    # count distinct rows: duplicate lanes of one key must not double-count
    hit = torch.zeros_like(tbl.key_hi, dtype=torch.bool)
    set_rows_drop(hit, rows, True, hit_lane)
    ndel = hit.sum().to(torch.int32)
    tbl.n_live.sub_(ndel)
    tbl.n_tomb.add_(ndel)
    return tbl, rows


def tombstone_rows(tbl: Table, row_mask):
    """Tombstone every live row where ``row_mask`` is True, in place →
    (table, killed_mask). Callers zero the state columns at killed rows
    (or leave them for :func:`compact`)."""
    kill = live_mask(tbl) & row_mask
    n = kill.sum().to(torch.int32)
    tbl.key_hi.masked_fill_(kill, TOMB)
    tbl.key_lo.masked_fill_(kill, TOMB)
    tbl.n_live.sub_(n)
    tbl.n_tomb.add_(n)
    return tbl, kill


def compact(tbl: Table, state_cols):
    """Reclaim tombstones and zero dead state columns, in place.

    A tombstone is operationally an empty slot here (lookups scan every
    probe position; inserts claim either), so compaction never moves a
    key: TOMB becomes EMPTY and every row that holds no live key has its
    state zeroed. ``state_cols``: an iterable of ``(S, ...)`` tensors
    indexed by row (views are written through). Returns the table."""
    tomb = _is_tomb(tbl.key_hi, tbl.key_lo)
    dead = ~live_mask(tbl)
    tbl.key_hi.masked_fill_(tomb, EMPTY)
    tbl.key_lo.masked_fill_(tomb, EMPTY)
    tbl.n_tomb.zero_()
    for col in state_cols:
        col.masked_fill_(dead.view((-1,) + (1,) * (col.dim() - 1)), 0)
    return tbl
