"""Cluster roll-up: every shard's sketches → one global view.

Counterpart of ``gyeeta_tpu/parallel/rollup.py`` — the madhava→shyama
aggregation RPCs as collectives over the per-shard states
(``parallel/mesh.py``):

- Count-Min counters and totals are additive → ``psum``,
- HLL registers merge by elementwise max → ``pmax``,
- top-K survivors and invertible heavy-hitter candidates are gathered
  side by side (shard order) and combined once: the candidates are
  point-queried against the merged CMS, so recovered counts are
  cluster totals.

Every output lies on the first shard's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gyeeta_tpu_torch.engine import aggstate, step, table
from gyeeta_tpu_torch.ingest import decode
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.parallel.mesh import gather_all, pmax, psum
from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, \
    invertible, topk


class GlobalRollup(NamedTuple):
    """The shyama-level merged view."""
    glob_hll: hll.HLL          # distinct flow endpoints, cluster-wide
    cms: countmin.CMS          # flow-key → bytes, cluster-wide
    flow_topk: topk.TopK       # heavy hitters across all shards
    n_conn: torch.Tensor       # () totals
    n_resp: torch.Tensor
    n_svc_live: torch.Tensor   # () live service rows cluster-wide
    host_totals: torch.Tensor  # (NHOSTCOL,) summed host panel
    n_hosts_up: torch.Tensor   # () hosts that have reported
    hh_hi: torch.Tensor        # (n·d·w,) candidate key halves
    hh_lo: torch.Tensor
    hh_ok: torch.Tensor        # (n·d·w,) bool decode verification
    hh_est: torch.Tensor       # (n·d·w,) f32 global CMS estimate
    hh_topk_est: torch.Tensor  # (cap,) f32 global CMS estimate of the
    #                             merged exact lanes
    hh_n_hot: torch.Tensor     # () hot-admission lanes, summed
    hh_total_mass: torch.Tensor  # () total folded flow mass (global)


def _rollup_local(states: list) -> GlobalRollup:
    """The merge of every shard's state: HLL ``pmax``, CMS ``psum``,
    the gathered top-K combined, each shard's invertible buckets
    decoded locally and the gathered candidates estimated against the
    merged CMS."""
    regs = pmax([st.glob_hll.regs for st in states])
    gcms = countmin.CMS(counts=psum([st.cms.counts for st in states]))
    merged_topk = topk._combine(
        gather_all([st.flow_topk.key_hi for st in states]),
        gather_all([st.flow_topk.key_lo for st in states]),
        gather_all([st.flow_topk.counts for st in states]),
        states[0].flow_topk.counts.shape[0],
        psum([st.flow_topk.evicted for st in states]))
    dec = [invertible.decode_keys(st.inv) for st in states]
    hh_hi = gather_all([k[0].reshape(-1) for k in dec])
    hh_lo = gather_all([k[1].reshape(-1) for k in dec])
    hh_ok = gather_all([k[2].reshape(-1) for k in dec])
    hh_est = torch.where(hh_ok, countmin.query(gcms, hh_hi, hh_lo)
                         .to(torch.float32), 0.0)
    hh_topk_est = torch.where(
        merged_topk.counts > 0,
        countmin.query(gcms, merged_topk.key_hi, merged_topk.key_lo)
        .to(torch.float32), 0.0)
    live = [table.live_mask(st.tbl).sum().to(torch.float32)
            for st in states]
    reported = [st.host_panel[:, decode.HOST_NTASKS] > 0
                for st in states]
    return GlobalRollup(
        glob_hll=hll.HLL(regs=regs), cms=gcms, flow_topk=merged_topk,
        hh_hi=hh_hi, hh_lo=hh_lo, hh_ok=hh_ok, hh_est=hh_est,
        hh_topk_est=hh_topk_est,
        hh_n_hot=psum([st.inv.n_hot for st in states]),
        hh_total_mass=countmin.total(gcms),
        n_conn=psum([st.n_conn for st in states]),
        n_resp=psum([st.n_resp for st in states]),
        n_svc_live=psum(live),
        host_totals=psum([
            torch.where(r[:, None], st.host_panel, 0.0).sum(dim=0)
            for r, st in zip(reported, states)]),
        n_hosts_up=psum([r.sum().to(torch.float32) for r in reported]))


def rollup_fn(cfg: aggstate.EngineCfg, mesh):
    """``per-shard states → GlobalRollup`` (:func:`_rollup_local`)."""
    return _rollup_local


class FleetView(NamedTuple):
    """The once-per-tick fleet view: cluster aggregates and heavy-hitter
    candidates (:class:`GlobalRollup`), the merged service dependency
    graph (``depgraph.EdgeSet``) and the merged engine-health vector —
    the madhava→shyama push cycle in one pass over the shards."""
    rollup: GlobalRollup
    edges: object                  # depgraph.EdgeSet
    health: torch.Tensor           # (len(HEALTH_KEYS),) f32, merged


def health_merge(vecs: list):
    """Per-shard health vectors → one: sums across shards, max for the
    digest-stage pressure (``td_stage_max``)."""
    vsum, vmax = psum(vecs), pmax(vecs)
    is_max = torch.zeros(len(step.HEALTH_KEYS), dtype=torch.bool,
                         device=vsum.device)
    is_max[step.HEALTH_KEYS.index("td_stage_max")] = True
    return torch.where(is_max, vmax, vsum)


def fleet_rollup_fn(cfg: aggstate.EngineCfg, mesh, edge_capacity: int):
    """``(per-shard states, per-shard deps) → FleetView``."""

    def roll(states: list, deps: list) -> FleetView:
        return FleetView(
            rollup=_rollup_local(states),
            edges=dg.edge_merge_shards(deps, edge_capacity),
            health=health_merge([step.engine_health_vec(cfg, st, d)
                                 for st, d in zip(states, deps)]))

    return roll
