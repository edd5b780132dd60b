"""Microbatch fold steps — the hot loop, on tensors.

Counterpart of ``gyeeta_tpu/engine/step.py``: ``ingest_conn``
(entity-table upsert, windowed counters, per-service HLL, global HLL,
CMS, budgeted top-K, invertible heavy-hitter buckets),
``ingest_resp_flat`` (loghist and t-digest staging), ``fold_step`` /
``fold_many``, the sweep sections (``ingest_listener``, ``ingest_host``,
``ingest_task``, ``ingest_cpumem``, ``ingest_trace``, ``ping_tasks``),
edge pre-aggregation's ``ingest_delta``,
``fold_all`` (every section + the conn/resp slab + the dependency graph
in one dispatch), the digest flushes, ``tick_5s``, the tick's upkeep
(``age_tasks``, ``age_apis``, ``compact_tasks``), the health vector and
the read-only ``heavy_recover`` pass.

The reference jits these with state donation (``jit_fold_step``); here
every function updates the large state buffers IN PLACE and returns the
state with its small leaves replaced. The state passed in is consumed,
as a donated one is: keep using the returned state. Batches are the
tensor columns of ``ingest/decode.to_device``. PyTorch runs eagerly, so
there is nothing to compile; each ``upsert_fast2`` any-miss test (conn
fold, trace fold, delta fold, dependency edges) is one device→host
sync.
"""

from __future__ import annotations

import numpy as np
import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.engine.aggstate import AggState, EngineCfg
from gyeeta_tpu_torch.ingest import decode as D
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.semantic import cpumem as CM
from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, \
    invertible, loghist, scatter, tdigest, topk, windows
from gyeeta_tpu_torch.utils.tensor import add_drop, set_drop, \
    set_rows_drop, top_k, tree_map


def ingest_conn(cfg: EngineCfg, st: AggState, cb) -> AggState:
    """Fold a ConnBatch of ``(B,)`` tensor columns.

    Only accept-observed (server-side) lanes touch the per-service slab
    and the additive CMS / flow top-K; the global HLL sees every valid
    lane (it dedups by flow key)."""
    valid = cb.valid
    svc_side = valid & cb.is_accept
    tbl, rows, any_new = table.upsert_fast2(st.tbl, cb.svc_hi, cb.svc_lo,
                                            svc_side)
    ok = svc_side & (rows >= 0)
    rowz = torch.where(ok, rows, 0)

    # per-svc windowed counters: one row scatter-add of a (B, NCTR)
    # block in CTR_* column order
    upd = torch.stack([cb.bytes_sent, cb.bytes_rcvd,
                       cb.is_close.to(torch.float32), cb.duration_us], dim=1)
    add_drop(st.ctr_win.cur, rowz, upd, ok)

    # service → host homing changes only when a row is claimed
    if any_new:
        set_drop(st.svc_host, rowz, cb.host_id, ok)
    hll.update_entities(st.svc_hll, rowz, cb.cli_hi, cb.cli_lo, valid=ok)
    hll.update(st.glob_hll, cb.flow_hi, cb.flow_lo, valid=valid)
    # byte accounting takes the accept side only
    tot_bytes = cb.bytes_sent + cb.bytes_rcvd
    countmin.update(st.cms, cb.flow_hi, cb.flow_lo, tot_bytes,
                    valid=svc_side)
    # sketch-assisted candidate compaction: the CMS, queried after this
    # batch folded into it, upper-bounds every flow's cumulative mass
    est = None
    if 0 < cfg.topk_budget:
        est = countmin.upper_bound(st.cms, cb.flow_hi, cb.flow_lo)
    # priority-aware hot admission: an absolute floor of the total mass
    hot = None
    if est is not None and cfg.hh_hot_frac > 0:
        thresh = float(np.float32(cfg.hh_hot_frac)) * countmin.total(st.cms)
        hot = est >= thresh
    n = cb.flow_hi.shape[0]
    sel = None
    if est is not None and 0 < cfg.topk_budget < n:
        # one candidate selection feeds both heavy-hitter structures:
        # score = estimate on admitted lanes, −1 on padding/cold lanes
        score = torch.where(svc_side, est.to(torch.float32), -1.0)
        if hot is not None:
            score = torch.where(hot, score, -1.0)
        _, sel = top_k(score, cfg.topk_budget)
        sel_ok = score[sel] >= 0.0
        c_hi, c_lo = cb.flow_hi[sel], cb.flow_lo[sel]
        c_vals = torch.where(sel_ok, tot_bytes[sel].to(torch.float32), 0.0)
        c_prio = torch.where(sel_ok, est[sel].to(torch.float32), 0.0)
        extra_evicted = (torch.sum(torch.where(svc_side, tot_bytes, 0.0))
                         - torch.sum(c_vals))
    if sel is not None:
        ftk = st.flow_topk._replace(
            evicted=st.flow_topk.evicted + extra_evicted)
        flow_topk = topk.update(ftk, c_hi, c_lo, c_vals, valid=sel_ok)
    else:
        flow_topk = topk.update(
            st.flow_topk, cb.flow_hi, cb.flow_lo, tot_bytes,
            valid=svc_side, est=est, budget=cfg.topk_budget)
    if cfg.hh_width <= 0:
        inv = st.inv
    else:
        if sel is not None:
            inv = invertible.update(st.inv, c_hi, c_lo, c_prio,
                                    valid=sel_ok)
        else:
            inv_prio = est if est is not None else tot_bytes
            inv = invertible.update(st.inv, cb.flow_hi, cb.flow_lo,
                                    inv_prio, valid=svc_side,
                                    budget=cfg.topk_budget)
        if hot is not None:
            inv = inv._replace(n_hot=inv.n_hot + torch.sum(
                svc_side & hot).to(torch.float32))
    return st._replace(
        tbl=tbl, flow_topk=flow_topk, inv=inv,
        n_conn=st.n_conn + torch.sum(valid).to(torch.float32))


def ingest_resp(cfg: EngineCfg, st: AggState, rb) -> AggState:
    """Fold one RespBatch (lookup-only: a response sample never creates a
    service row; unknowns are counted, not folded)."""
    return ingest_resp_flat(cfg, st, rb)


def td_flush(cfg: EngineCfg, st: AggState) -> AggState:
    """Compress every staged digest sample into the per-svc digests and
    clear the stage."""
    tdigest.flush_staged(st.svc_td, st.td_stage, st.td_stage_n)
    return st


def td_flush_partial(cfg: EngineCfg, st: AggState) -> AggState:
    """Compress the ``cfg.td_flush_m`` fullest digest stages and clear
    them — the hot-loop flush, triggered from host-side pressure."""
    tdigest.flush_staged_topm(st.svc_td, st.td_stage, st.td_stage_n,
                              cfg.td_flush_m)
    return st


def stage_pressure(st: AggState):
    """Max staged-sample count over entities (a 0-d int32 tensor)."""
    return torch.max(st.td_stage_n)


def flatten(batch):
    """A (K, B) stacked batch → the same batch as (K*B,) lanes."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), batch)


def ingest_resp_bulk(cfg: EngineCfg, st: AggState, rbs) -> AggState:
    """Flatten a (K, B) stacked resp batch and fold it in one pass."""
    return ingest_resp_flat(cfg, st, flatten(rbs))


def ingest_resp_flat(cfg: EngineCfg, st: AggState, flat) -> AggState:
    """Response samples in one pass over flat lanes: one table lookup,
    one loghist scatter-add, one digest staging route (1-in-N duty
    cycle; the loghist folds every sample)."""
    valid = flat.valid
    rows = table.lookup(st.tbl, flat.svc_hi, flat.svc_lo, valid)
    ok = valid & (rows >= 0)
    n_unknown = torch.sum(valid & (rows < 0)).to(torch.float32)
    rowz = torch.where(ok, rows, 0)
    loghist.update_entities(st.resp_win.cur, cfg.resp_spec, rowz,
                            flat.resp_us, valid=ok)
    k = max(1, cfg.td_sample_stride)
    _, _, n_over = tdigest.stage_samples(
        st.td_stage, st.td_stage_n, torch.where(ok, rows, -1)[::k],
        flat.resp_us[::k])
    return st._replace(
        n_resp=st.n_resp + torch.sum(valid).to(torch.float32),
        n_resp_unknown=st.n_resp_unknown + n_unknown,
        n_td_overflow=st.n_td_overflow + n_over.to(torch.float32),
    )


def ingest_listener(cfg: EngineCfg, st: AggState, lb) -> AggState:
    """Fold a ListenerBatch: gauges + learned QPS/active-conn baselines
    (one QPS and one active-conn sample per service per 5s sweep, the
    classifier's self-learned percentiles)."""
    valid = lb.valid
    tbl, rows = table.upsert(st.tbl, lb.svc_hi, lb.svc_lo, valid)
    ok = valid & (rows >= 0)
    rowz = torch.where(ok, rows, 0)
    set_rows_drop(st.svc_stats, rows, lb.stats, ok)
    set_rows_drop(st.svc_host, rows, lb.host_id, ok)
    loghist.update_entities(st.qps_hist, cfg.qps_spec, rowz,
                            lb.stats[:, D.STAT_NQRYS] / 5.0, valid=ok)
    loghist.update_entities(st.active_hist, cfg.active_spec, rowz,
                            lb.stats[:, D.STAT_NCONNS_ACTIVE], valid=ok)
    return st._replace(tbl=tbl)


def ingest_task(cfg: EngineCfg, st: AggState, tb) -> AggState:
    """Fold a TaskBatch (5s process-group sweep): gauges + agent state +
    learned CPU% baseline + last-seen tick for ageing."""
    valid = tb.valid
    tbl, rows = table.upsert(st.task_tbl, tb.key_hi, tb.key_lo, valid)
    ok = valid & (rows >= 0)
    rowz = torch.where(ok, rows, 0)
    for col, v in ((st.task_stats, tb.stats), (st.task_state, tb.state),
                   (st.task_issue, tb.issue), (st.task_host, tb.host_id),
                   (st.task_comm_hi, tb.comm_hi),
                   (st.task_comm_lo, tb.comm_lo),
                   (st.task_rel_hi, tb.rel_hi), (st.task_rel_lo, tb.rel_lo)):
        set_rows_drop(col, rows, v, ok)
    loghist.update_entities(st.task_cpu_hist, cfg.taskcpu_spec, rowz,
                            tb.stats[:, D.TASK_CPU_PCT], valid=ok)
    set_rows_drop(st.task_last_tick, rows, st.resp_win.tick, ok)
    return st._replace(task_tbl=tbl)


# api_ctr column indices
APIC_NREQ = 0
APIC_NERR = 1
APIC_BYTES_IN = 2
APIC_BYTES_OUT = 3


def ingest_trace(cfg: EngineCfg, st: AggState, tb) -> AggState:
    """Fold a TraceBatch into the per-(svc, api) slab: counters +
    response-time loghist. Also upserts the SERVICE row (a parsed
    server-side transaction is evidence of a live listener) and adds
    parsed server errors into its ser_errors gauge."""
    svc_tbl, svc_rows = table.upsert_fast(st.tbl, tb.svc_hi, tb.svc_lo,
                                          tb.valid)
    svc_ok = tb.valid & (svc_rows >= 0)
    set_rows_drop(st.svc_host, svc_rows, tb.host_id, svc_ok)
    add_drop(st.svc_stats[:, D.STAT_SER_ERRORS], svc_rows,
             tb.is_err.to(torch.float32), svc_ok)
    st = st._replace(tbl=svc_tbl)
    valid = tb.valid
    tbl, rows = table.upsert(st.api_tbl, tb.key_hi, tb.key_lo, valid)
    ok = valid & (rows >= 0)
    rowz = torch.where(ok, rows, 0)
    # one row add of the (B, 4) block in APIC_* column order
    add_drop(st.api_ctr, rows, torch.stack(
        [torch.ones_like(tb.byin), tb.is_err.to(torch.float32), tb.byin,
         tb.byout], dim=1), ok)
    loghist.update_entities(st.api_resp_hist, cfg.apiresp_spec, rowz,
                            tb.resp_us, valid=ok)
    for col, v in ((st.api_svc_hi, tb.svc_hi), (st.api_svc_lo, tb.svc_lo),
                   (st.api_id_hi, tb.api_hi), (st.api_id_lo, tb.api_lo),
                   (st.api_proto, tb.proto), (st.api_host, tb.host_id),
                   (st.api_last_tick, st.resp_win.tick)):
        set_rows_drop(col, rows, v, ok)
    return st._replace(api_tbl=tbl)


def age_apis(cfg: EngineCfg, st: AggState, max_age_ticks: int) -> AggState:
    """Tombstone (svc, api) rows unseen for ``max_age_ticks`` ticks."""
    stale = (st.api_last_tick >= 0) & (st.resp_win.tick - st.api_last_tick
                                       > max_age_ticks)
    tbl, killed = table.tombstone_rows(st.api_tbl, stale)
    for col in (st.api_svc_hi, st.api_svc_lo, st.api_id_hi, st.api_id_lo,
                st.api_proto):
        col.masked_fill_(killed, 0)
    st.api_resp_hist.masked_fill_(killed[:, None], 0.0)
    st.api_ctr.masked_fill_(killed[:, None], 0.0)
    st.api_host.masked_fill_(killed, -1)
    st.api_last_tick.masked_fill_(killed, -1)
    return st._replace(api_tbl=tbl)


def ping_tasks(cfg: EngineCfg, st: AggState, pb) -> AggState:
    """Fold a PingBatch (process-group keepalives): refresh
    ``task_last_tick`` of rows that EXIST — lookup, never upsert."""
    rows = table.lookup(st.task_tbl, pb.key_hi, pb.key_lo, pb.valid)
    set_rows_drop(st.task_last_tick, rows, st.resp_win.tick, rows >= 0)
    return st


def ingest_delta(cfg: EngineCfg, st: AggState, dep, db, tick):
    """Fold a DeltaBatch (``ingest/decode.delta_batch`` on the device):
    edge pre-aggregation, the partials an agent folded from its own
    conn/resp streams (``sketch/edgefold.py``) → ``(state, dep)``.
    Every merge is the monotone one the raw fold applies, so a delta-fed
    engine reaches the raw-fed state up to float-addition order and the
    agent's declared flow truncation:

    - counters, dependency edges: row scatter-adds of per-sweep sums;
    - loghist bucket counts (an add at ``row * B + bucket``; integer-
      valued counts: the sum is exact in any order) and the per-service
      and global HLL registers (a max at ``row * m + reg`` and at
      ``reg``): ONE :func:`scatter.scatter_sites` launch, whose masked
      lanes write nothing;
    - flows: aggregated ``(key, bytes)`` lanes into the CMS, top-K and
      invertible buckets as raw lanes go, the agent's truncated residual
      charged to the top-K ``evicted`` bound.

    One table upsert a dispatch (the unique service keys); every family
    then resolves its rows by lookups against the updated table."""
    # ---- one upsert over the unique service keys of the dispatch
    tbl, urows, any_new = table.upsert_fast2(st.tbl, db.svc_hi, db.svc_lo,
                                             db.svc_valid)
    if any_new:               # the owning host changes only when claimed
        set_drop(st.svc_host, urows, db.svc_host,
                 db.svc_valid & (urows >= 0))

    # ---- per-service exact counters (ctr_win order) + event counts
    rc = table.lookup(tbl, db.ctr_hi, db.ctr_lo, db.ctr_valid)
    ok_c = db.ctr_valid & (rc >= 0)
    add_drop(st.ctr_win.cur, rc, db.ctr_vals[:, :4], ok_c)
    n_conn_add = torch.sum(torch.where(ok_c, db.ctr_vals[:, 4], 0.0))
    n_resp_add = torch.sum(torch.where(ok_c, db.ctr_vals[:, 5], 0.0))

    # ---- one launch: per-service resp loghist bucket counts,
    # per-service distinct-client HLL register maxes and global flow HLL
    # register maxes (lanes whose row is missing write nothing)
    rh = table.lookup(tbl, db.hist_hi, db.hist_lo, db.hist_valid)
    rs = table.lookup(tbl, db.shll_hi, db.shll_lo, db.shll_valid)
    scatter.scatter_sites((
        scatter.Site("add", st.resp_win.cur, rh, db.hist_w,
                     keep=db.hist_valid, col=db.hist_bucket,
                     stride=cfg.resp_spec.nbuckets),
        scatter.Site("max", st.svc_hll.regs, rs, db.shll_rank,
                     keep=db.shll_valid, col=db.shll_reg,
                     stride=st.svc_hll.regs.shape[-1]),
        scatter.Site("max", st.glob_hll.regs, db.ghll_reg, db.ghll_rank,
                     keep=db.ghll_valid)), route="delta_merge")

    # ---- t-digest stage (strided at the agent)
    rt_ = table.lookup(tbl, db.td_hi, db.td_lo, db.td_valid)
    ok_t = db.td_valid & (rt_ >= 0)
    _, _, n_over = tdigest.stage_samples(
        st.td_stage, st.td_stage_n, torch.where(ok_t, rt_, -1), db.td_val)

    # ---- flow aggregates → CMS, top-K, invertible buckets
    fv = db.flow_valid
    countmin.update(st.cms, db.flow_hi, db.flow_lo, db.flow_val, valid=fv)
    est = countmin.upper_bound(st.cms, db.flow_hi, db.flow_lo)
    ftk = st.flow_topk._replace(
        evicted=st.flow_topk.evicted + db.evicted_add[0])
    hot = None
    vhot = fv
    if cfg.hh_hot_frac > 0:
        thresh = float(np.float32(cfg.hh_hot_frac)) * countmin.total(st.cms)
        hot = est >= thresh
        vhot = fv & hot
        # cold valid mass never reaches the exact merge: accounted
        ftk = ftk._replace(evicted=ftk.evicted + torch.sum(
            torch.where(fv & ~hot, db.flow_val, 0.0)))
    flow_topk = topk.update(ftk, db.flow_hi, db.flow_lo, db.flow_val,
                            valid=vhot, est=est, budget=cfg.topk_budget)
    if cfg.hh_width <= 0:
        inv = st.inv
    else:
        inv = invertible.update(st.inv, db.flow_hi, db.flow_lo,
                                torch.where(vhot, est, 0.0), valid=vhot,
                                budget=cfg.topk_budget)
        if hot is not None:
            inv = inv._replace(n_hot=inv.n_hot + torch.sum(
                fv & hot).to(torch.float32))

    # ---- dependency edges (pre-aggregated direct edges)
    dep = dg.fold_edges(dep, db.dep_cli_hi, db.dep_cli_lo, db.dep_cli_svc,
                        db.dep_ser_hi, db.dep_ser_lo, db.dep_bytes,
                        db.dep_valid, tick, nconn=db.dep_nconn)
    st = st._replace(
        tbl=tbl, flow_topk=flow_topk, inv=inv,
        n_conn=st.n_conn + n_conn_add, n_resp=st.n_resp + n_resp_add,
        n_td_overflow=st.n_td_overflow + n_over.to(torch.float32))
    return st, dep


def age_tasks(cfg: EngineCfg, st: AggState, max_age_ticks: int) -> AggState:
    """Tombstone process groups not seen for ``max_age_ticks`` base
    ticks (by last-sweep tick)."""
    stale = (st.task_last_tick >= 0) & (st.resp_win.tick
                                        - st.task_last_tick > max_age_ticks)
    tbl, killed = table.tombstone_rows(st.task_tbl, stale)
    st.task_stats.masked_fill_(killed[:, None], 0.0)
    st.task_state.masked_fill_(killed, 0)
    st.task_issue.masked_fill_(killed, 0)
    st.task_host.masked_fill_(killed, -1)
    # cpu_hist is scatter-added, never overwritten: zero it here or a
    # reclaimed slot inherits the dead group's learned baseline
    st.task_cpu_hist.masked_fill_(killed[:, None], 0.0)
    st.task_last_tick.masked_fill_(killed, -1)
    return st._replace(task_tbl=tbl)


def compact_tasks(cfg: EngineCfg, st: AggState) -> AggState:
    """Reclaim the task slab's tombstones in place (cf. compact_state)."""
    tbl = table.compact(st.task_tbl, (
        st.task_stats, st.task_state, st.task_issue, st.task_host,
        st.task_comm_hi, st.task_comm_lo, st.task_rel_hi, st.task_rel_lo,
        st.task_cpu_hist, st.task_last_tick))
    dead = ~table.live_mask(tbl)
    st.task_host.masked_fill_(dead, -1)
    st.task_last_tick.masked_fill_(dead, -1)
    return st._replace(task_tbl=tbl)


def ingest_host(cfg: EngineCfg, st: AggState, hb) -> AggState:
    """Fold a HostBatch: dense panel write by host_id."""
    ok = hb.valid & (hb.host_id >= 0) & (hb.host_id < cfg.n_hosts)
    set_rows_drop(st.host_panel, hb.host_id, hb.panel, ok)
    set_rows_drop(st.host_last_tick, hb.host_id, st.resp_win.tick, ok)
    return st


def ingest_cpumem(cfg: EngineCfg, st: AggState, cm) -> AggState:
    """Fold a CpuMemBatch (the 2s path): panel write + fleet-wide
    classification (``semantic/cpumem.py``)."""
    ok = cm.valid & (cm.host_id >= 0) & (cm.host_id < cfg.n_hosts)
    set_rows_drop(st.host_cm, cm.host_id, cm.vals, ok)
    cpu_state, cpu_issue = CM.classify_cpu(st.host_cm)
    mem_state, mem_issue = CM.classify_mem(st.host_cm)
    st.cm_cpu_state.copy_(cpu_state)
    st.cm_cpu_issue.copy_(cpu_issue)
    st.cm_mem_state.copy_(mem_state)
    st.cm_mem_issue.copy_(mem_issue)
    set_rows_drop(st.cm_last_tick, cm.host_id, st.resp_win.tick, ok)
    return st


def tick_5s(cfg: EngineCfg, st: AggState) -> AggState:
    """Close the 5s base slab on all windowed state."""
    windows.tick(st.resp_win, cfg.levels)
    windows.tick(st.ctr_win, cfg.levels)
    return st


def fold_step(cfg: EngineCfg, st: AggState, cb, rb) -> AggState:
    """The flagship step: one conn batch + one resp batch."""
    st = ingest_conn(cfg, st, cb)
    return ingest_resp(cfg, st, rb)


def fold_many(cfg: EngineCfg, st: AggState, cbs, rbs) -> AggState:
    """Fold K stacked ``(K, B)`` microbatches as ONE ``(K*B,)``-lane
    batch (every fold op is order-independent across microbatches).
    The digest flush is not part of it: the caller watches
    :func:`stage_pressure` and runs :func:`td_flush_partial`."""
    st = ingest_conn(cfg, st, flatten(cbs))
    return ingest_resp_bulk(cfg, st, rbs)


# ------------------------------------------------------- health readback
# engine_health_vec layout: one f32 scalar per key, read back in one
# small transfer per report cadence (never per event)
HEALTH_KEYS = (
    "svc_live", "svc_tomb", "svc_drop",
    "task_live", "task_tomb", "task_drop",
    "api_live", "api_tomb", "api_drop",
    "td_stage_max",
    "n_conn", "n_resp", "n_resp_unknown", "n_td_overflow",
    "dep_half_live", "dep_edge_live", "dep_edge_drop",
    "dep_paired", "dep_expired", "dep_dropped",
    "topk_evicted", "hh_occupied", "hh_hot_lanes",
)


def engine_health_vec(cfg: EngineCfg, st: AggState, dep) -> torch.Tensor:
    """Device-state health as ONE (len(HEALTH_KEYS),) f32 tensor: slab
    fills, tombstones and probe-failure drops of every keyed table,
    digest-stage pressure, dep-graph fill and drop counters, the event
    counters and the heavy-hitter tier's fill."""
    def s(v):
        return v.sum().to(torch.float32)

    return torch.stack((
        s(st.tbl.n_live), s(st.tbl.n_tomb), s(st.tbl.n_drop),
        s(st.task_tbl.n_live), s(st.task_tbl.n_tomb),
        s(st.task_tbl.n_drop),
        s(st.api_tbl.n_live), s(st.api_tbl.n_tomb), s(st.api_tbl.n_drop),
        st.td_stage_n.max().to(torch.float32),
        s(st.n_conn), s(st.n_resp), s(st.n_resp_unknown),
        s(st.n_td_overflow),
        s(dep.half_tbl.n_live), s(dep.edge_tbl.n_live),
        s(dep.edge_tbl.n_drop),
        s(dep.n_paired), s(dep.n_expired), s(dep.n_dropped),
        s(st.flow_topk.evicted), s(st.inv.prio > 0), s(st.inv.n_hot),
    ))


def heavy_recover(cfg: EngineCfg, st: AggState) -> dict:
    """Heavy-hitter recovery: one read-only pass over ``st.inv``,
    ``st.cms`` and ``st.flow_topk`` — the decoded, verified candidates
    with their CMS estimates, and the exact top-K lanes with theirs —
    as a dict of device tensors (the caller reads them back once)."""
    out = invertible.decode(st.inv, st.cms)
    t_hi, t_lo, t_counts = topk.query(st.flow_topk, cfg.topk_capacity)
    # CMS estimate for the exact lanes too: truth ∈ [count, est]
    t_est = countmin.query(st.cms, t_hi, t_lo).to(torch.float32)
    out.update({
        "topk_hi": t_hi, "topk_lo": t_lo, "topk_counts": t_counts,
        "topk_est": torch.where(t_counts > 0, t_est, 0.0),
        "evicted": st.flow_topk.evicted,
        "total_mass": countmin.total(st.cms),
        "n_hot": st.inv.n_hot,
    })
    return out


# --------------------------------------------------------- fused dispatch
# Canonical sub-fold order inside fold_all (the reference's order, so a
# fused dispatch equals the section-by-section sequence)
FOLD_ALL_ORDER = ("listener", "host", "task", "cpumem", "trace", "ping",
                  "delta", "connresp")


def fold_all(cfg: EngineCfg, st: AggState, dep, tick, *, listener=None,
             host=None, task=None, cpumem=None, trace=None, ping=None,
             delta=None, connresp=None):
    """One feed dispatch: every present sweep section in
    :data:`FOLD_ALL_ORDER`, then the conn/resp K-slab (``connresp`` =
    ``(cbs, rbs)``, stacked ``(K, B)``) with the dependency-graph fold
    → ``(state, dep, pressure)``. ``pressure`` is :func:`stage_pressure`
    as a 0-d device tensor, not read back. Absent sections are ``None``
    and cost nothing."""
    if listener is not None:
        st = ingest_listener(cfg, st, listener)
    if host is not None:
        st = ingest_host(cfg, st, host)
    if task is not None:
        st = ingest_task(cfg, st, task)
    if cpumem is not None:
        st = ingest_cpumem(cfg, st, cpumem)
    if trace is not None:
        st = ingest_trace(cfg, st, trace)
    if ping is not None:
        st = ping_tasks(cfg, st, ping)
    if delta is not None:
        st, dep = ingest_delta(cfg, st, dep, delta, tick)
    if connresp is not None:
        cbs, rbs = connresp
        st = fold_many(cfg, st, cbs, rbs)
        dep = dg.dep_fold_many(dep, cbs, tick)
    return st, dep, stage_pressure(st)
