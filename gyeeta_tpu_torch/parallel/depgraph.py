"""Service dependency graph: paired flows → svc→svc edge slab → clusters.

Counterpart of ``gyeeta_tpu/parallel/depgraph.py``:

- **half table**: flow-key-addressed slab of unpaired conn halves with
  their payloads (client entity id, server glob id, bytes). A row whose
  two halves have landed is drained the same step: its edge is folded
  and the row tombstoned, so the table holds only in-flight halves.
- **edge slab**: (cli_entity, ser_listener)-keyed table accumulating
  nconn/bytes per dependency edge. Conn records that carry both sides
  fold straight into it and skip pairing.
- **cluster labels**: min-label propagation over the svc→svc edges, a
  fixed number of sweeps (:func:`mesh_clusters`).
- **the sharded step** (:func:`dep_step_fn`): direct lanes fold into
  the local shard's edge slab; one-sided halves ride the capacity-
  bucketed ``all_to_all`` to their flow-owner shard
  (:func:`_dispatch_halves`) and pair there. :func:`edge_rollup_fn`
  merges every shard's edges into one view.

Every function updates the graph's buffers in place and returns it (the
reference donates them). Where the reference branches with
``lax.cond``, the port either reads the flag back once (a device→host
sync) or runs the branch unconditionally where that gives the same
result: :func:`fold_edges` reuses the any-miss flag its own
``upsert_fast2`` read; :func:`pair_halves` with no valid lane is the
identity, so :func:`pair_halves_cond` runs it without a test and
:func:`dep_fold_many` tests once per dispatch whether any lane is a
half.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.parallel.mesh import gather_all
from gyeeta_tpu_torch.parallel.pairing import dispatch_fields, owner_shard
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.tensor import add_drop, compact_true, \
    reduce_drop, set_rows_drop, tree_leaves, tree_map, tree_unflatten

_EDGE_SALT = 0x5E1FD0


class DepGraph(NamedTuple):
    # ---- unpaired halves, keyed by flow key ----
    half_tbl: table.Table
    h_cli_hi: torch.Tensor    # (P,) u32 carrier: client entity id
    h_cli_lo: torch.Tensor
    h_cli_svc: torch.Tensor   # (P,) bool — client entity is a listener
    h_ser_hi: torch.Tensor    # (P,) u32 carrier: server glob id
    h_ser_lo: torch.Tensor
    h_bytes: torch.Tensor     # (P,) f32 — flow bytes (max of the halves)
    h_cli_seen: torch.Tensor  # (P,) bool
    h_ser_seen: torch.Tensor  # (P,) bool
    h_last_tick: torch.Tensor  # (P,) i32 — for TTL eviction
    # ---- dependency edges, keyed by mix(cli, ser) ----
    edge_tbl: table.Table
    e_cli_hi: torch.Tensor    # (E,) u32 carrier: endpoint ids
    e_cli_lo: torch.Tensor
    e_cli_svc: torch.Tensor   # (E,) bool — svc→svc edge (mesh member)
    e_ser_hi: torch.Tensor
    e_ser_lo: torch.Tensor
    e_ctr: torch.Tensor       # (E, 2) f32 — [:, 0] nconn, [:, 1] bytes
    e_last_tick: torch.Tensor  # (E,) i32
    # ---- counters ----
    n_paired: torch.Tensor    # () f32 — halves joined into an edge
    n_expired: torch.Tensor   # () f32 — halves evicted unpaired (TTL)
    n_dropped: torch.Tensor   # () f32 — table overflow drops

    @property
    def e_nconn(self):
        """(E,) flows-per-edge view of ``e_ctr``."""
        return self.e_ctr[:, 0]

    @property
    def e_bytes(self):
        """(E,) bytes-per-edge view of ``e_ctr``."""
        return self.e_ctr[:, 1]


def init(pair_capacity: int = 4096, edge_capacity: int = 2048,
         device=None) -> DepGraph:
    """A fresh graph on ``device`` (CUDA by default; raises without a
    GPU unless ``device="cpu"``)."""
    return _init(pair_capacity, edge_capacity, resolve(device))


def _init(Pc: int, E: int, dev: torch.device) -> DepGraph:
    def z(n, dt):
        return torch.zeros(n, dtype=dt, device=dev)

    def u32(n):
        return z((n,), torch.int64)

    def neg(n):
        return torch.full((n,), -1, dtype=torch.int32, device=dev)

    return DepGraph(
        half_tbl=table.init(Pc, device=dev),
        h_cli_hi=u32(Pc), h_cli_lo=u32(Pc),
        h_cli_svc=z((Pc,), torch.bool),
        h_ser_hi=u32(Pc), h_ser_lo=u32(Pc),
        h_bytes=z((Pc,), torch.float32),
        h_cli_seen=z((Pc,), torch.bool),
        h_ser_seen=z((Pc,), torch.bool),
        h_last_tick=neg(Pc),
        edge_tbl=table.init(E, device=dev),
        e_cli_hi=u32(E), e_cli_lo=u32(E),
        e_cli_svc=z((E,), torch.bool),
        e_ser_hi=u32(E), e_ser_lo=u32(E),
        e_ctr=z((E, 2), torch.float32),
        e_last_tick=neg(E),
        n_paired=z((), torch.float32),
        n_expired=z((), torch.float32),
        n_dropped=z((), torch.float32),
    )


def _ticks(tick, n: int, dev) -> torch.Tensor:
    """The tick (a Python int or a 0-d tensor) as an (n,) int32 column,
    filled on the device (no blocking host→device copy)."""
    if isinstance(tick, torch.Tensor):
        return tick.to(torch.int32).expand(n)
    return torch.full((n,), int(tick), dtype=torch.int32, device=dev)


# ------------------------------------------------------------------ edges
def edge_key(cli_hi, cli_lo, ser_hi, ser_lo):
    """(cli, ser) → 64-bit edge table key as (hi, lo) u32 carriers."""
    khi = H.mix64(cli_hi, cli_lo, _EDGE_SALT) ^ H.u32(ser_hi)
    klo = H.mix64(ser_hi, ser_lo, _EDGE_SALT) ^ H.u32(cli_lo)
    return khi, klo


def fold_edges(dep: DepGraph, cli_hi, cli_lo, cli_svc, ser_hi, ser_lo,
               byts, valid, tick, nconn=None) -> DepGraph:
    """Accumulate (cli→ser) flows into the edge slab (batched upsert).

    The identity columns change only when a row is claimed, so they are
    written only when the upsert's any-miss flag (already read back by
    ``upsert_fast2``) is set. ``nconn``: per-lane flow count (default 1
    a lane)."""
    khi, klo = edge_key(cli_hi, cli_lo, ser_hi, ser_lo)
    tbl, rows, any_new = table.upsert_fast2(dep.edge_tbl, khi, klo,
                                            valid=valid)
    ok = valid & (rows >= 0)
    if any_new:
        set_rows_drop(dep.e_cli_hi, rows, H.u32(cli_hi), ok)
        set_rows_drop(dep.e_cli_lo, rows, H.u32(cli_lo), ok)
        set_rows_drop(dep.e_cli_svc, rows, cli_svc, ok)
        set_rows_drop(dep.e_ser_hi, rows, H.u32(ser_hi), ok)
        set_rows_drop(dep.e_ser_lo, rows, H.u32(ser_lo), ok)
    n = torch.ones_like(byts) if nconn is None else nconn.to(torch.float32)
    add_drop(dep.e_ctr, rows, torch.stack([n, byts], dim=1), ok)
    set_rows_drop(dep.e_last_tick, rows, _ticks(tick, rows.shape[0],
                                                rows.device), ok)
    return dep._replace(
        edge_tbl=tbl,
        n_dropped=dep.n_dropped + (valid & (rows < 0)).sum()
        .to(torch.float32))


# ------------------------------------------------------------------ halves
class Halves(NamedTuple):
    """Pairing lanes (all shape (B,))."""
    flow_hi: torch.Tensor
    flow_lo: torch.Tensor
    is_cli: torch.Tensor     # bool — this lane is the client-side half
    pay_hi: torch.Tensor     # payload: cli entity id / ser glob id
    pay_lo: torch.Tensor
    pay_svc: torch.Tensor    # bool — (cli halves) entity is a listener
    byts: torch.Tensor       # f32
    valid: torch.Tensor


def halves_from_conn(cb):
    """Split a ConnBatch into direct-edge lanes and pairing halves →
    ``(direct_lanes, halves)``: a record that knows both sides folds
    straight into the edge slab; one that knows one side is a half."""
    rel = (cb.cli_rel_hi | cb.cli_rel_lo) != 0
    cli_id_hi = torch.where(rel, cb.cli_rel_hi, cb.cli_task_hi)
    cli_id_lo = torch.where(rel, cb.cli_rel_lo, cb.cli_task_lo)
    know_cli = (cli_id_hi | cli_id_lo) != 0
    know_ser = (cb.svc_hi | cb.svc_lo) != 0
    byts = cb.bytes_sent + cb.bytes_rcvd
    direct = (cli_id_hi, cli_id_lo, rel, cb.svc_hi, cb.svc_lo,
              byts, cb.valid & know_cli & know_ser)
    is_cli = know_cli
    halves = Halves(
        flow_hi=cb.flow_hi, flow_lo=cb.flow_lo, is_cli=is_cli,
        pay_hi=torch.where(is_cli, cli_id_hi, cb.svc_hi),
        pay_lo=torch.where(is_cli, cli_id_lo, cb.svc_lo),
        pay_svc=rel & is_cli,
        byts=byts, valid=cb.valid & (know_cli ^ know_ser))
    return direct, halves


def pair_halves(dep: DepGraph, hv: Halves, tick) -> DepGraph:
    """Land halves in the half table; drain rows that just completed.

    With no valid lane this is the identity: nothing lands, and no row
    is complete, since a completed row is drained the step it
    completes."""
    tbl, rows = table.upsert(dep.half_tbl, hv.flow_hi, hv.flow_lo,
                             valid=hv.valid)
    ok = hv.valid & (rows >= 0)
    okc = ok & hv.is_cli                          # client-half lanes
    oks = ok & ~hv.is_cli                         # server-half lanes
    set_rows_drop(dep.h_cli_hi, rows, H.u32(hv.pay_hi), okc)
    set_rows_drop(dep.h_cli_lo, rows, H.u32(hv.pay_lo), okc)
    set_rows_drop(dep.h_cli_svc, rows, hv.pay_svc, okc)
    set_rows_drop(dep.h_ser_hi, rows, H.u32(hv.pay_hi), oks)
    set_rows_drop(dep.h_ser_lo, rows, H.u32(hv.pay_lo), oks)
    reduce_drop(dep.h_bytes, rows, hv.byts, ok, "amax")
    set_rows_drop(dep.h_cli_seen, rows, True, okc)
    set_rows_drop(dep.h_ser_seen, rows, True, oks)
    set_rows_drop(dep.h_last_tick, rows,
                  _ticks(tick, rows.shape[0], rows.device), ok)

    done = dep.h_cli_seen & dep.h_ser_seen   # rows holding both halves
    dep = dep._replace(
        half_tbl=tbl,
        n_paired=dep.n_paired + done.sum().to(torch.float32),
        n_dropped=dep.n_dropped
        + (hv.valid & (rows < 0)).sum().to(torch.float32))
    # fold the completed rows' edges, then tombstone + clear them. A row
    # completes only when a lane of this batch landed its second half,
    # so at most B rows are done: a B-lane ascending compaction of the
    # done mask covers them all
    Pc = dep.h_bytes.shape[0]
    idx = compact_true(done, hv.valid.shape[0], Pc)
    have = idx < Pc
    at = torch.where(have, idx, 0)

    def get(col):
        return torch.where(have, col[at], torch.zeros((), dtype=col.dtype,
                                                       device=col.device))

    dep = fold_edges(dep, get(dep.h_cli_hi), get(dep.h_cli_lo),
                     get(dep.h_cli_svc), get(dep.h_ser_hi),
                     get(dep.h_ser_lo), get(dep.h_bytes), have, tick)
    return _clear_half_rows(dep, done)


def pair_halves_cond(dep: DepGraph, hv: Halves, tick) -> DepGraph:
    """The reference's ``lax.cond`` around :func:`pair_halves` skips it
    when no lane is a half. That skipped branch is the identity, so the
    port runs :func:`pair_halves` unconditionally: the same result, and
    no device→host sync for the test."""
    return pair_halves(dep, hv, tick)


def _clear_half_rows(dep: DepGraph, kill) -> DepGraph:
    tbl, killed = table.tombstone_rows(dep.half_tbl, kill)
    for col, v in ((dep.h_cli_hi, 0), (dep.h_cli_lo, 0),
                   (dep.h_cli_svc, False), (dep.h_ser_hi, 0),
                   (dep.h_ser_lo, 0), (dep.h_bytes, 0.0),
                   (dep.h_cli_seen, False), (dep.h_ser_seen, False),
                   (dep.h_last_tick, -1)):
        col.masked_fill_(killed, v)
    return dep._replace(half_tbl=tbl)


def age(dep: DepGraph, tick, pair_ttl_ticks: int,
        edge_ttl_ticks: int) -> DepGraph:
    """TTL eviction: unpaired halves expire fast; edges linger for the
    query horizon."""
    stale_h = (dep.h_last_tick >= 0) & (tick - dep.h_last_tick
                                        > pair_ttl_ticks)
    dep = dep._replace(
        n_expired=dep.n_expired + stale_h.sum().to(torch.float32))
    dep = _clear_half_rows(dep, stale_h)
    stale_e = (dep.e_last_tick >= 0) & (tick - dep.e_last_tick
                                        > edge_ttl_ticks)
    etbl, ekilled = table.tombstone_rows(dep.edge_tbl, stale_e)
    for col, v in ((dep.e_cli_hi, 0), (dep.e_cli_lo, 0),
                   (dep.e_cli_svc, False), (dep.e_ser_hi, 0),
                   (dep.e_ser_lo, 0), (dep.e_last_tick, -1)):
        col.masked_fill_(ekilled, v)
    dep.e_ctr.masked_fill_(ekilled[:, None], 0.0)
    return dep._replace(edge_tbl=etbl)


# ------------------------------------------------------- single-device step
def dep_step(dep: DepGraph, cb, tick) -> DepGraph:
    """One conn batch → edges (direct lanes fold, halves pair here)."""
    direct, hv = halves_from_conn(cb)
    dep = fold_edges(dep, *direct, tick)
    return pair_halves_cond(dep, hv, tick)


def dep_fold_many(dep: DepGraph, cbs, tick) -> DepGraph:
    """K stacked ``(K, B)`` conn batches → one flat direct-edge fold +
    chunked pairing.

    Direct lanes fold in one ``upsert_fast2``. Pairing recycles rows, so
    its lanes run in chunks of ``capacity // 4`` lanes, each seeing the
    table the previous chunk left, the remainder chunk last (the
    reference's ``lax.scan``, as a Python loop). One read-back per
    dispatch decides whether any lane is a half at all (the reference's
    outer ``lax.cond``); the chunks then run without a test."""
    K, B = cbs.valid.shape[:2]
    n = K * B
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), cbs)
    direct, hv = halves_from_conn(flat)
    dep = fold_edges(dep, *direct, tick)
    capacity = dep.h_last_tick.shape[0]
    chunk = max(1, min(n, capacity // 4))
    if not bool(hv.valid.any()):
        return dep
    for lo in range(0, n, chunk):
        dep = pair_halves(dep, tree_map(lambda x: x[lo:lo + chunk], hv),
                          tick)
    return dep


# ------------------------------------------------------------ sharded step
def dep_step_fn(mesh, cap_per_dest: int):
    """``(per-shard deps, per-shard conn batches, tick) → deps``: each
    shard folds its direct lanes, its one-sided halves ride the
    dispatch to their flow-owner shard and pair there."""

    def step(deps: list, cbs: list, tick) -> list:
        deps, hvs = list(deps), []
        for s, cb in enumerate(cbs):
            direct, hv = halves_from_conn(cb)
            deps[s] = fold_edges(deps[s], *direct, tick)
            hvs.append(hv)
        routed, o_drop = _dispatch_halves(mesh, hvs, cap_per_dest)
        return [pair_halves_cond(d._replace(n_dropped=d.n_dropped + od),
                                 r, tick)
                for d, r, od in zip(deps, routed, o_drop)]

    return step


def _dispatch_halves(mesh, hvs: list, cap: int):
    """Capacity-bucketed dispatch of every shard's Halves to their
    flow-owner shards → (received Halves a shard, dropped a shard)."""
    owner = [owner_shard(hv.flow_hi, hv.flow_lo, mesh.n) for hv in hvs]
    routed, r_val, dropped = dispatch_fields(
        mesh, [{"fhi": (hv.flow_hi, 0), "flo": (hv.flow_lo, 0),
                "cli": (hv.is_cli, False), "phi": (hv.pay_hi, 0),
                "plo": (hv.pay_lo, 0), "psvc": (hv.pay_svc, False),
                "byts": (hv.byts, 0.0)} for hv in hvs],
        [hv.valid for hv in hvs], owner, cap)
    return [Halves(flow_hi=r["fhi"], flow_lo=r["flo"], is_cli=r["cli"],
                   pay_hi=r["phi"], pay_lo=r["plo"], pay_svc=r["psvc"],
                   byts=r["byts"], valid=v)
            for r, v in zip(routed, r_val)], dropped


# ------------------------------------------------------------ edge views
class EdgeSet(NamedTuple):
    """A dense merged edge view."""
    tbl: table.Table
    cli_hi: torch.Tensor
    cli_lo: torch.Tensor
    cli_svc: torch.Tensor
    ser_hi: torch.Tensor
    ser_lo: torch.Tensor
    nconn: torch.Tensor
    byts: torch.Tensor


def _edge_merge(cap: int, cli_hi, cli_lo, cli_svc, ser_hi, ser_lo,
                nconn, byts, valid) -> EdgeSet:
    """Merge flat edge lanes (counts additive) into a fresh dense slab."""
    dev = cli_hi.device
    khi, klo = edge_key(cli_hi, cli_lo, ser_hi, ser_lo)
    tbl, rows = table.upsert(table.init(cap, device=dev), khi, klo,
                             valid=valid)
    ok = valid & (rows >= 0)

    def set_(v, dt):
        out = torch.zeros((cap,), dtype=dt, device=dev)
        set_rows_drop(out, rows, v, ok)
        return out

    def add_(v):
        out = torch.zeros((cap,), dtype=torch.float32, device=dev)
        add_drop(out, rows, v, ok)
        return out

    return EdgeSet(
        tbl=tbl,
        cli_hi=set_(H.u32(cli_hi), torch.int64),
        cli_lo=set_(H.u32(cli_lo), torch.int64),
        cli_svc=set_(cli_svc, torch.bool),
        ser_hi=set_(H.u32(ser_hi), torch.int64),
        ser_lo=set_(H.u32(ser_lo), torch.int64),
        nconn=add_(nconn), byts=add_(byts))


def edges_local(dep: DepGraph) -> EdgeSet:
    """Single-device edge view as an EdgeSet."""
    return _edge_merge(dep.e_ctr.shape[0], dep.e_cli_hi, dep.e_cli_lo,
                       dep.e_cli_svc, dep.e_ser_hi, dep.e_ser_lo,
                       dep.e_nconn, dep.e_bytes,
                       table.live_mask(dep.edge_tbl))


def edge_merge_shards(deps: list, out_capacity: int) -> EdgeSet:
    """Every shard's live edges gathered in shard order and merged
    (counts additive) into one dense view on the first shard's
    device."""
    def g(f):
        return gather_all([f(d) for d in deps])

    return _edge_merge(
        out_capacity, g(lambda d: d.e_cli_hi), g(lambda d: d.e_cli_lo),
        g(lambda d: d.e_cli_svc), g(lambda d: d.e_ser_hi),
        g(lambda d: d.e_ser_lo), g(lambda d: d.e_nconn),
        g(lambda d: d.e_bytes), g(lambda d: table.live_mask(d.edge_tbl)))


def edge_rollup_fn(mesh, out_capacity: int):
    """``per-shard deps → merged EdgeSet`` (:func:`edge_merge_shards`)."""
    return lambda deps: edge_merge_shards(deps, out_capacity)


# --------------------------------------------------------- mesh clustering
def mesh_clusters(es: EdgeSet, node_capacity: int, n_iters: int = 16):
    """Svc-mesh coalescing: connected components of the svc→svc edges →
    ``(node_tbl, labels, sizes)``: a node table keyed by listener id, a
    per-row cluster label (the min node row reachable within
    ``n_iters`` sweeps) and per-row member count of the row's cluster."""
    dev = es.cli_hi.device
    use = table.live_mask(es.tbl) & es.cli_svc
    ntbl = table.init(node_capacity, device=dev)
    ntbl, cli_rows = table.upsert(ntbl, es.cli_hi, es.cli_lo, valid=use)
    ntbl, ser_rows = table.upsert(ntbl, es.ser_hi, es.ser_lo, valid=use)
    ok = use & (cli_rows >= 0) & (ser_rows >= 0)
    cz = torch.where(ok, cli_rows, 0)
    sz = torch.where(ok, ser_rows, 0)
    labels = torch.arange(node_capacity, dtype=torch.int32, device=dev)
    for _ in range(n_iters):
        m = torch.minimum(labels[cz], labels[sz])
        reduce_drop(labels, cli_rows, m, ok, "amin")
        reduce_drop(labels, ser_rows, m, ok, "amin")
    live = table.live_mask(ntbl)
    labels = torch.where(live, labels, -1)
    counts = torch.zeros((node_capacity + 1,), dtype=torch.int32,
                         device=dev)
    counts.index_put_((torch.where(live, labels, node_capacity)
                       .to(torch.int64),),
                      torch.ones_like(labels), accumulate=True)
    sizes = torch.where(live, counts[torch.where(live, labels, 0)
                                     .to(torch.int64)], 0)
    return ntbl, labels, sizes


# ------------------------------------------------------------- numpy bridge
def dep_to_numpy(dep: DepGraph) -> list:
    """The graph's 29 leaves as numpy arrays, in the reference's
    flattened order and dtypes: u32 carriers come back as uint32."""
    out = []
    for leaf in tree_leaves(dep):
        a = leaf.detach().cpu().numpy().copy()
        if a.dtype == np.int64:
            if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
                raise ValueError("u32 carrier leaf holds a value outside "
                                 "[0, 2**32)")
            a = a.astype(np.uint32)
        out.append(a)
    return out


def dep_from_numpy(leaves, device=None) -> DepGraph:
    """Inverse of :func:`dep_to_numpy`: the reference's 29 flattened
    leaves → a DepGraph on ``device``."""
    if len(leaves) != 29:
        raise ValueError(f"{len(leaves)} leaves do not form a DepGraph")
    dev = resolve(device)
    tensors = []
    for a in leaves:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        tensors.append(torch.tensor(a, device=dev))
    return tree_unflatten(_init(1, 1, torch.device("meta")), tensors)
