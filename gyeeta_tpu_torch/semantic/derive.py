"""Derive classifier signals from live AggState + run the 5s classify pass.

Counterpart of ``gyeeta_tpu/semantic/derive.py``: for every service row
at once, read current and historical percentiles out of the sketch
state, join the process-group sweep into per-service task signals, look
up host pressure, build ``SvcSignals``, run the rule cascade, and store
the state/issue and the 8-tick high-response bit history back into the
engine state (in place).
"""

from __future__ import annotations

import math

import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.engine.aggstate import AggState, EngineCfg
from gyeeta_tpu_torch.ingest import decode as D
from gyeeta_tpu_torch.semantic import svcstate
from gyeeta_tpu_torch.sketch import loghist, windows
from gyeeta_tpu_torch.utils.tensor import add_drop

_QS = (0.95, 0.99)


def _popcount8(x):
    return sum((x >> k) & 1 for k in range(8))


def _b_1ms(spec: loghist.LogHistSpec) -> int:
    """Bucket of 1 ms (resp values are usec), by ``bucket_of``'s formula
    in Python."""
    return int(min(spec.nbuckets - 1, max(0, math.floor(
        math.log(max(1000.0, spec.vmin) / spec.vmin)
        / math.log(spec.gamma)))))


def _segment_sum(tgt, vals, keep, n: int):
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    add_drop(out, tgt, vals, keep)
    return out


def signals(cfg: EngineCfg, st: AggState):
    """AggState → (SvcSignals, high_resp_now) over all service rows."""
    spec = cfg.resp_spec
    h5 = st.resp_win.cur                       # current 5s slab
    h300 = windows.read(st.resp_win, 0)        # 5 min
    h5day = windows.read(st.resp_win, 1)       # 5 days
    q5 = loghist.quantiles(h5, spec, _QS)
    q300 = loghist.quantiles(h300, spec, _QS)
    q5day = loghist.quantiles(h5day, spec, _QS)

    b5 = loghist.bucket_of(spec, q5[:, 0])
    b300 = loghist.bucket_of(spec, q300[:, 0])
    b5day = loghist.bucket_of(spec, q5day[:, 0])
    b_1ms = _b_1ms(spec)

    gauges = st.svc_stats
    # prefer live resp samples; fall back to the agent-reported gauge
    # when the resp stream is sampled out
    nqrys = torch.maximum(loghist.counts_total(h5), gauges[:, D.STAT_NQRYS])
    # the reference's compiled nqrys / 5.0 multiplies by the float32
    # reciprocal (XLA's rewrite): the same rounding here
    curr_qps = nqrys * 0.2

    qps_q = loghist.quantiles(st.qps_hist, cfg.qps_spec, (0.95, 0.25))
    act_q = loghist.quantiles(st.active_hist, cfg.active_spec, (0.95, 0.25))

    ntasks = gauges[:, D.STAT_NTASKS]
    ntasks_issue = gauges[:, D.STAT_NTASKS_ISSUE]
    delay_ms = (gauges[:, D.STAT_TASKS_DELAY_US]
                + gauges[:, D.STAT_TASKS_CPUDELAY_US]
                + gauges[:, D.STAT_TASKS_BLKIODELAY_US]) / 1000.0

    # task-tier join: process-group sweeps summed into their service row
    # (via related_listen_id); the stronger of the two paths wins
    task_live = table.live_mask(st.task_tbl)
    rel_rows = table.lookup(st.tbl, st.task_rel_hi, st.task_rel_lo,
                            valid=task_live)
    joined = rel_rows >= 0
    tstats = st.task_stats
    S = cfg.svc_capacity
    t_issue = _segment_sum(rel_rows, tstats[:, D.TASK_NTASKS_ISSUE],
                           joined, S)
    t_ntasks = _segment_sum(rel_rows, tstats[:, D.TASK_NTASKS], joined, S)
    t_delay = _segment_sum(
        rel_rows, tstats[:, D.TASK_CPU_DELAY_MS]
        + tstats[:, D.TASK_VM_DELAY_MS] + tstats[:, D.TASK_BLKIO_DELAY_MS],
        joined, S)
    ntasks = torch.maximum(ntasks, t_ntasks)
    ntasks_issue = torch.maximum(ntasks_issue, t_issue)
    delay_ms = torch.maximum(delay_ms, t_delay)
    task_issue = ntasks_issue > 0
    task_severe = task_issue & ((ntasks_issue >= ntasks)
                                | (delay_ms >= 1000.0))
    task_delay = delay_ms > 0

    # host pressure flags looked up through the service→host mapping
    hostz = torch.clamp(st.svc_host, 0, cfg.n_hosts - 1).to(torch.int64)
    has_host = st.svc_host >= 0
    cpu_issue = has_host & (st.host_panel[hostz, D.HOST_CPU_ISSUE] > 0)
    mem_issue = has_host & (st.host_panel[hostz, D.HOST_MEM_ISSUE] > 0)

    mean5 = loghist.mean(h5, spec)
    mean5day = loghist.mean(h5day, spec)

    low = (b5 <= b_1ms) | (q5[:, 0] < q5day[:, 0])
    same = b5 == b5day
    high_now = ~low & ~same

    sig = svcstate.SvcSignals(
        b5=b5, b300=b300, b5day=b5day,
        r5p95=q5[:, 0], r5p99=q5[:, 1],
        r5dayp95=q5day[:, 0], r5dayp99=q5day[:, 1],
        mean5=mean5, mean5day=mean5day,
        nqrys_5s=nqrys, curr_qps=curr_qps,
        qps_p95=qps_q[:, 0], qps_p25=qps_q[:, 1],
        curr_active=gauges[:, D.STAT_NCONNS_ACTIVE],
        active_p95=act_q[:, 0], active_p25=act_q[:, 1],
        nconn=gauges[:, D.STAT_NCONNS],
        ser_errors=gauges[:, D.STAT_SER_ERRORS],
        task_issue=task_issue, task_severe=task_severe,
        task_delay=task_delay,
        ntasks_issue=ntasks_issue,
        ntasks_noissue=torch.clamp(ntasks - ntasks_issue, min=0.0),
        tasks_delay_msec=delay_ms,
        total_resp_msec=gauges[:, D.STAT_TOTAL_RESP_MS],
        cpu_issue=cpu_issue, mem_issue=mem_issue,
        high_resp_ticks=_popcount8(
            ((st.resp_hi_bits << 1) | high_now.to(torch.int32)) & 0xFF),
        b_1ms=b_1ms,
    )
    return sig, high_now


def classify_pass(cfg: EngineCfg, st: AggState) -> AggState:
    """One 5s classification sweep: state, issue and the high-response
    bit history of every service row, written in place."""
    sig, high_now = signals(cfg, st)
    state, issue = svcstate.classify(sig)
    dead = ~table.live_mask(st.tbl)
    st.svc_state.copy_(state.masked_fill_(dead, 0))
    st.svc_issue.copy_(issue.masked_fill_(dead, 0))
    st.resp_hi_bits.copy_(((st.resp_hi_bits << 1)
                           | high_now.to(torch.int32)) & 0xFF)
    return st
