"""Cross-shard conn-half pairing: capacity-bucketed all_to_all + tables.

Counterpart of ``gyeeta_tpu/parallel/pairing.py``. The flow-key space
is hash-sharded over the mesh (:func:`owner_shard`); every shard routes
its locally observed halves to the owner shard with one capacity-
bucketed ``all_to_all`` a mesh axis (:func:`dispatch_fields`, an
EP/MoE-style dispatch), and the owner upserts them into its slice of a
pair table. A pair completes when both halves have landed on the same
row. Exact join: this path is not sketched.

Capacity discipline: each shard sends at most ``cap`` lanes to each
owner a step; overflow lanes are dropped and counted. The routed lane
order is the reference's: a stable sort by destination, each
destination's lanes in arrival order, so the owner's table claims the
same rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.parallel import mesh as M
from gyeeta_tpu_torch.parallel.partition import stack_leaves, \
    unstack_leaves
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import set_rows_drop, tree_leaves, \
    tree_unflatten

_OWNER_SALT = 0x9A1C


class PairTable(NamedTuple):
    """One shard's slice of the global pairing table."""
    tbl: table.Table
    cli_seen: torch.Tensor   # (S,) bool — client half landed
    ser_seen: torch.Tensor   # (S,) bool — server half landed
    n_paired: torch.Tensor   # () f32 — completed pairs (monotonic)
    n_dropped: torch.Tensor  # () f32 — dispatch overflow + table drops


def pair_init(capacity: int, device=None) -> PairTable:
    tbl = table.init(capacity, device=device)
    dev = tbl.key_hi.device
    return PairTable(
        tbl=tbl,
        cli_seen=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        ser_seen=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        n_paired=torch.zeros((), dtype=torch.float32, device=dev),
        n_dropped=torch.zeros((), dtype=torch.float32, device=dev))


def owner_shard(flow_hi, flow_lo, n_shards: int):
    """Deterministic flow-key → owner shard (the sharding of the global
    pair table). Works on numpy arrays or tensors."""
    return H.mix64(flow_hi, flow_lo, _OWNER_SALT) % n_shards


def _bucket(dest, valid, m: int, cap_k: int):
    """One shard's capacity buckets for one stage: the stable sort by
    destination, each lane's slot in the ``(m·cap_k,)`` send buffer
    (``m·cap_k`` for a dropped lane: the spare slot) → (order, slot,
    keep, dropped lanes as f32)."""
    B = dest.shape[0]
    _, order = torch.sort(dest, stable=True)
    d_s = dest[order]
    counts = torch.bincount(d_s, minlength=m + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(B, dtype=torch.int64, device=dest.device) \
        - offsets[d_s]
    keep = (d_s < m) & (pos < cap_k)
    slot = torch.where(keep, d_s * cap_k + pos, m * cap_k)
    dropped = (valid.sum() - keep.sum()).to(torch.float32)
    return order, slot, keep, dropped


def _scatter(x, order, slot, size: int, fill):
    """``x`` in the sort's order (``order`` None: already in it) into a
    ``(size,)`` buffer of ``fill`` at ``slot``; dropped lanes land in
    one spare slot, cut off."""
    buf = torch.full((size + 1,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    buf[slot] = x if order is None else x[order]
    return buf[:size]


def dispatch_fields(mesh, fields: list, valid: list, owner: list,
                    cap: int):
    """Route lanes to their owner shard: one capacity-bucketed
    ``all_to_all`` a mesh axis, outermost first.

    ``fields``: per shard, ``{name: ((B,) tensor, fill)}``; ``valid``
    and ``owner`` (global owner shard, row-major over the mesh) per
    shard. On a 1-D mesh this is one stage; on a two-level mesh each
    lane crosses the outer axis at most once, to its owner's slice, and
    then moves along the inner axis to its owner. Stage k's cap a
    destination is ``cap × (owners downstream)``, so an outer stage
    never throttles below the final per-owner capacity.
    Returns (per-shard routed fields, per-shard routed valid, per-shard
    dropped counts as f32 tensors)."""
    names = list(fields[0])
    arrs = [{k: f[k][0] for k in names} for f in fields]
    fills = {k: fields[0][k][1] for k in names}
    owner = [o.to(torch.int64) for o in owner]
    dropped = [torch.zeros((), dtype=torch.float32, device=v.device)
               for v in valid]
    sizes = mesh.sizes
    stride = 1
    for s in sizes[1:]:
        stride *= s
    for k, (ax, m) in enumerate(zip(mesh.axis_names, sizes)):
        cap_k = cap * stride
        size = m * cap_k
        sends, new_valid, new_owner = [], [], []
        for s in range(mesh.n):
            v = valid[s]
            dest = torch.where(v, (owner[s] // stride) % m, m)
            order, slot, keep, drop = _bucket(dest, v, m, cap_k)
            dropped[s] = dropped[s] + drop
            sends.append({kk: _scatter(arrs[s][kk], order, slot, size,
                                       fills[kk]) for kk in names})
            new_valid.append(_scatter(keep, None, slot, size, False))
            if k + 1 < len(sizes):
                new_owner.append(_scatter(owner[s], order, slot, size, 0))
        arrs = [dict(zip(names, cols)) for cols in zip(*(
            M.all_to_all([snd[kk] for snd in sends], mesh, ax)
            for kk in names))]
        valid = M.all_to_all(new_valid, mesh, ax)
        if k + 1 < len(sizes):
            # owner rides along only while later stages route by it
            owner = M.all_to_all(new_owner, mesh, ax)
            stride //= sizes[k + 1]
    return arrs, valid, dropped


def _dispatch(mesh, flow_hi: list, flow_lo: list, is_cli: list,
              valid: list, cap: int):
    """Pairing-lane dispatch (see :func:`dispatch_fields`)."""
    owner = [owner_shard(h, lo, mesh.n) for h, lo in zip(flow_hi, flow_lo)]
    routed, r_val, dropped = dispatch_fields(
        mesh, [{"hi": (h, 0), "lo": (lo, 0), "cli": (c, False)}
               for h, lo, c in zip(flow_hi, flow_lo, is_cli)],
        valid, owner, cap)
    return ([r["hi"] for r in routed], [r["lo"] for r in routed],
            [r["cli"] for r in routed], r_val, dropped)


def _pair_local(pt: PairTable, r_hi, r_lo, r_cli, r_valid) -> PairTable:
    """Upsert received halves into the local pair-table slice (in
    place; returns the table with its scalars replaced)."""
    both_before = pt.cli_seen & pt.ser_seen
    tbl, rows = table.upsert(pt.tbl, r_hi, r_lo, valid=r_valid)
    ok = r_valid & (rows >= 0)
    set_rows_drop(pt.cli_seen, rows, True, ok & r_cli)
    set_rows_drop(pt.ser_seen, rows, True, ok & ~r_cli)
    new_pairs = ((pt.cli_seen & pt.ser_seen) & ~both_before).sum()
    tab_dropped = (r_valid & (rows < 0)).sum().to(torch.float32)
    return pt._replace(
        tbl=tbl, n_paired=pt.n_paired + new_pairs.to(torch.float32),
        n_dropped=pt.n_dropped + tab_dropped)


def pair_init_sharded(mesh, capacity: int) -> list:
    """One empty pair-table slice a shard, on its device."""
    return [pair_init(capacity, d) for d in mesh.devices]


def pairing_fn(mesh, cap_per_dest: int):
    """``(pair tables, flow_hi, flow_lo, is_cli, valid) → (pair tables,
    stats)``, every argument a per-shard list of ``(B,)`` tensors.
    ``stats`` (on the first shard's device): total pairs completed,
    total dropped, total live table rows."""

    def step(pts: list, fhi: list, flo: list, is_cli: list, valid: list):
        r_hi, r_lo, r_cli, r_val, o_drop = _dispatch(
            mesh, fhi, flo, is_cli, valid, cap_per_dest)
        out = []
        for s, pt in enumerate(pts):
            pt = pt._replace(n_dropped=pt.n_dropped + o_drop[s])
            out.append(_pair_local(pt, r_hi[s], r_lo[s], r_cli[s],
                                   r_val[s]))
        stats = {
            "n_paired": M.psum([p.n_paired for p in out]),
            "n_dropped": M.psum([p.n_dropped for p in out]),
            "n_table_live": M.psum([p.tbl.n_live.to(torch.float32)
                                    for p in out]),
        }
        return out, stats

    return step


# ------------------------------------------------------------ numpy bridge
def pair_to_numpy(pts: list) -> list:
    """Per-shard pair tables → the reference's stacked ``(n, ...)``
    leaves in its flattened order and dtypes (u32 keys as uint32)."""
    per = []
    for pt in pts:
        leaves = []
        for leaf in tree_leaves(pt):
            a = leaf.detach().cpu().numpy().copy()
            leaves.append(a.astype(np.uint32) if a.dtype == np.int64
                          else a)
        per.append(leaves)
    return stack_leaves(per)


def pair_from_numpy(stacked, mesh) -> list:
    """Inverse of :func:`pair_to_numpy` onto ``mesh``'s devices."""
    out = []
    for leaves, dev in zip(unstack_leaves(stacked, mesh.n), mesh.devices):
        ts = [torch.tensor(a.astype(np.int64) if a.dtype == np.uint32
                           else a, device=dev) for a in leaves]
        out.append(tree_unflatten(pair_init(1, "meta"), ts))
    return out
