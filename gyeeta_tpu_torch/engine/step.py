"""Microbatch fold steps — the hot loop, on tensors.

Counterpart of ``gyeeta_tpu/engine/step.py`` for the flow-event path:
``ingest_conn`` (entity-table upsert, windowed counters, per-service
HLL, global HLL, CMS, budgeted top-K, invertible heavy-hitter buckets),
``ingest_resp_flat`` (loghist and t-digest staging), ``fold_step`` /
``fold_many``, the digest flushes and ``tick_5s``.

The reference jits these with state donation (``jit_fold_step``); here
every function updates the large state buffers IN PLACE and returns the
state with its small leaves replaced. The state passed in is consumed,
as a donated one is: keep using the returned state. Batches are the
tensor columns of ``ingest/decode.to_device``. PyTorch runs eagerly, so
there is nothing to compile; the table upsert's any-miss test is one
device→host sync per conn fold.
"""

from __future__ import annotations

import numpy as np
import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.engine.aggstate import AggState, EngineCfg
from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, \
    invertible, loghist, tdigest, topk, windows
from gyeeta_tpu_torch.utils.tensor import add_drop, set_drop, top_k, \
    tree_map


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
