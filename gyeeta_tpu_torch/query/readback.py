"""Point-in-time readbacks of live AggState and the dependency graph.

Counterpart of ``gyeeta_tpu/query/readback.py``. :func:`svc_snapshot`
and :func:`flow_snapshot` return dense device columns (the fold path's
own questions; :func:`svc_rows_to_host` reads them back once per column
and assembles per-service rows). The readbacks the query layer's column
builders call — the svcstate groups (:func:`svcstate_base`, ``_vol``,
``_cli``, ``_qlevel`` and their row-sliced ``_rows`` forms),
:func:`svcstate_snapshot`, :func:`host_snapshot`,
:func:`task_snapshot`, :func:`trace_snapshot`,
:func:`dep_edges_snapshot` and :func:`dep_mesh_snapshot` — compute on
the state's device and return numpy arrays in the reference's dtypes:
a u32 carried in an int64 tensor comes back as ``uint32``, as
``aggstate.state_to_numpy`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.engine.aggstate import (
    AggState, EngineCfg, CTR_BYTES_SENT, CTR_BYTES_RCVD, CTR_NCONN_CLOSED,
    CTR_DUR_SUM_US,
)
from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, \
    loghist, tdigest, topk, windows

DEFAULT_QS = (0.25, 0.5, 0.95, 0.99)


def svc_snapshot(cfg: EngineCfg, st: AggState, level: int = 0):
    """Per-service live snapshot at a window level (0=5min, 1=5d, 2=all):
    dense (S,) columns, row validity in ``live``."""
    live = table.live_mask(st.tbl)
    resp_hist = windows.read(st.resp_win, level)
    ctr = windows.read(st.ctr_win, level)
    resp_q_us = loghist.quantiles(resp_hist, cfg.resp_spec, DEFAULT_QS)
    td_q_us = tdigest.quantiles_entities(st.svc_td, DEFAULT_QS)
    nresp = loghist.counts_total(resp_hist)
    elapsed = torch.clamp(st.resp_win.tick.to(torch.float32), min=1.0)
    if level < len(cfg.levels):
        lv = cfg.levels[level] if level >= 0 else None
        span_ticks = 1.0 if lv is None else float(lv.stride_ticks * lv.nslots)
        # before the window fills, the data covers only `elapsed` ticks
        span_sec = torch.clamp(elapsed, max=span_ticks) * 5.0
    else:
        span_sec = elapsed * 5.0
    return {
        "glob_id_hi": st.tbl.key_hi,
        "glob_id_lo": st.tbl.key_lo,
        "live": live,
        "nresp": nresp,
        "qps": nresp / span_sec,
        "resp_p25_us": resp_q_us[:, 0],
        "resp_p50_us": resp_q_us[:, 1],
        "resp_p95_us": resp_q_us[:, 2],
        "resp_p99_us": resp_q_us[:, 3],
        "td_p50_us": td_q_us[:, 1],
        "td_p95_us": td_q_us[:, 2],
        "td_p99_us": td_q_us[:, 3],
        "bytes_sent": ctr[:, CTR_BYTES_SENT],
        "bytes_rcvd": ctr[:, CTR_BYTES_RCVD],
        "nconn_closed": ctr[:, CTR_NCONN_CLOSED],
        "mean_conn_dur_us": ctr[:, CTR_DUR_SUM_US]
        / torch.clamp(ctr[:, CTR_NCONN_CLOSED], min=1.0),
        "distinct_clients": hll.estimate(st.svc_hll),
        "stats": st.svc_stats,
    }


def flow_snapshot(cfg: EngineCfg, st: AggState, k: int = 64):
    """Heavy-hitter flows by bytes + global distinct-endpoint estimate."""
    f_hi, f_lo, f_bytes = topk.query(st.flow_topk, k)
    return {
        "flow_hi": f_hi,
        "flow_lo": f_lo,
        "flow_bytes": f_bytes,
        "evicted_bytes": st.flow_topk.evicted,
        "distinct_flows": hll.estimate(st.glob_hll),
        "total_bytes": countmin.total(st.cms),
    }


def svc_rows_to_host(cfg: EngineCfg, snap: dict) -> list[dict]:
    """Device snapshot → list of per-service dicts (live rows only).
    One device→host transfer per column, then row assembly."""
    host = {k: v.cpu().numpy() for k, v in snap.items()}
    live = host["live"]
    idx = np.nonzero(live)[0]
    gid = (host["glob_id_hi"].astype(np.uint64) << np.uint64(32)) \
        | host["glob_id_lo"].astype(np.uint64)
    scalar_cols = [k for k, v in host.items()
                   if k not in ("glob_id_hi", "glob_id_lo", "live", "stats")
                   and v.ndim == 1]
    out = []
    for i in idx:
        row = {"glob_id": int(gid[i])}
        for k in scalar_cols:
            row[k] = float(host[k][i])
        out.append(row)
    return out


def _host(d: dict) -> dict:
    """Device columns → numpy in the reference's dtypes (an int64 tensor
    is a u32 carrier here: it comes back as uint32)."""
    out = {}
    for k, v in d.items():
        a = v.detach().cpu().numpy()
        if a.dtype == np.int64:
            a = a.astype(np.uint32)
        out[k] = a
    return out


# ------------------------------------------------ grouped svcstate readback
# Queries read svcstate column GROUPS on demand (cached per state version)
# and compute projection-only groups over just the result rows.
_QS3 = (0.5, 0.95, 0.99)


def svcstate_base(cfg: EngineCfg, st: AggState):
    """Cheap gauges: ids, liveness, classification, stats panel."""
    return _host({
        "glob_id_hi": st.tbl.key_hi,
        "glob_id_lo": st.tbl.key_lo,
        "live": table.live_mask(st.tbl),
        "state": st.svc_state,
        "issue": st.svc_issue,
        "hostid": st.svc_host,
        "stats": st.svc_stats,
    })


def _vol(cur, stats):
    from gyeeta_tpu_torch.ingest.decode import STAT_NQRYS

    nqrys = torch.maximum(loghist.counts_total(cur), stats[:, STAT_NQRYS])
    # the reference's compiled nqrys / 5.0 multiplies by the float32
    # reciprocal (XLA's rewrite): the same rounding here
    return _host({"nqry5s": nqrys, "qps5s": nqrys * 0.2})


def svcstate_vol(cfg: EngineCfg, st: AggState):
    """Query volume from the current 5s slab."""
    return _vol(st.resp_win.cur, st.svc_stats)


def svcstate_vol_rows(cfg: EngineCfg, st: AggState, idx):
    return _vol(st.resp_win.cur[idx], st.svc_stats[idx])


def svcstate_cli(cfg: EngineCfg, st: AggState):
    return _host({"nclients": hll.estimate(st.svc_hll)})


def svcstate_cli_rows(cfg: EngineCfg, st: AggState, idx):
    return _host({"nclients": hll.estimate(
        st.svc_hll._replace(regs=st.svc_hll.regs[idx]))})


def _qcols(cfg: EngineCfg, h, level: int):
    q = loghist.quantiles(h, cfg.resp_spec, _QS3)
    if level == -1:
        out = {"resp5s_us": loghist.mean(h, cfg.resp_spec),
               "p95resp5s_us": q[:, 1], "p99resp5s_us": q[:, 2]}
    elif level == 0:
        out = {"p95resp5m_us": q[:, 1]}
    else:
        out = {"p50resp5d_us": q[:, 0], "p95resp5d_us": q[:, 1]}
    return _host(out)


def svcstate_qlevel(cfg: EngineCfg, st: AggState, level: int):
    """Latency columns for ONE window level (full capacity)."""
    return _qcols(cfg, windows.read(st.resp_win, level), level)


def svcstate_qlevel_rows(cfg: EngineCfg, st: AggState, idx, level: int):
    """Latency columns for one level over just rows ``idx`` (a device
    index tensor): the window total is gathered before the add, so the
    cost follows ``len(idx)``, not capacity."""
    win = st.resp_win
    if level == -1:
        h = win.cur[idx]
    elif level < len(win.totals):
        h = win.totals[level][idx] + win.cur[idx]
    else:
        h = win.alltime[idx] + win.cur[idx]
    return _qcols(cfg, h, level)


def svcstate_snapshot(cfg: EngineCfg, st: AggState):
    """The whole svcstate readback in one pass: current 5s window, the
    5 min and 5 day windows, gauges and the classification."""
    from gyeeta_tpu_torch.ingest.decode import STAT_NQRYS

    spec = cfg.resp_spec
    h5 = st.resp_win.cur
    q5 = loghist.quantiles(h5, spec, _QS3)
    q5m = loghist.quantiles(windows.read(st.resp_win, 0), spec, _QS3)
    q5d = loghist.quantiles(windows.read(st.resp_win, 1), spec, _QS3)
    nqrys = torch.maximum(loghist.counts_total(h5),
                          st.svc_stats[:, STAT_NQRYS])
    return _host({
        "glob_id_hi": st.tbl.key_hi,
        "glob_id_lo": st.tbl.key_lo,
        "live": table.live_mask(st.tbl),
        "nqry5s": nqrys,
        "qps5s": nqrys * 0.2,          # as in _vol
        "resp5s_us": loghist.mean(h5, spec),
        "p95resp5s_us": q5[:, 1],
        "p99resp5s_us": q5[:, 2],
        "p95resp5m_us": q5m[:, 1],
        "p50resp5d_us": q5d[:, 0],
        "p95resp5d_us": q5d[:, 1],
        "state": st.svc_state,
        "issue": st.svc_issue,
        "hostid": st.svc_host,
        "nclients": hll.estimate(st.svc_hll),
        "stats": st.svc_stats,
    })


def host_snapshot(cfg: EngineCfg, st: AggState):
    return _host({"panel": st.host_panel})


def task_snapshot(cfg: EngineCfg, st: AggState):
    """Per-process-group snapshot: gauges, the agent's classification
    and the learned CPU baseline's p95."""
    cpu_p95 = loghist.quantiles(st.task_cpu_hist, cfg.taskcpu_spec,
                                (0.95,))[:, 0]
    return _host({
        "key_hi": st.task_tbl.key_hi,
        "key_lo": st.task_tbl.key_lo,
        "live": table.live_mask(st.task_tbl),
        "stats": st.task_stats,
        "state": st.task_state,
        "issue": st.task_issue,
        "hostid": st.task_host,
        "comm_hi": st.task_comm_hi,
        "comm_lo": st.task_comm_lo,
        "rel_hi": st.task_rel_hi,
        "rel_lo": st.task_rel_lo,
        "cpu_p95": cpu_p95,
    })


def dep_edges_snapshot(dep):
    """Dependency-edge columns (svcdependency)."""
    from gyeeta_tpu_torch.parallel import depgraph as dg

    es = dg.edges_local(dep)
    return _host({
        "e_live": table.live_mask(es.tbl),
        "e_cli_hi": es.cli_hi, "e_cli_lo": es.cli_lo,
        "e_cli_svc": es.cli_svc,
        "e_ser_hi": es.ser_hi, "e_ser_lo": es.ser_lo,
        "e_nconn": es.nconn, "e_bytes": es.byts,
    })


def dep_mesh_snapshot(dep, n_iters: int = 16):
    """Mesh-cluster labels over the svc→svc edges (svcmesh). The node
    table holds up to two distinct endpoints per edge: 2× the edge
    slab."""
    from gyeeta_tpu_torch.parallel import depgraph as dg

    es = dg.edges_local(dep)
    ntbl, labels, sizes = dg.mesh_clusters(es, 2 * es.nconn.shape[0],
                                           n_iters)
    return _host({
        "n_hi": ntbl.key_hi, "n_lo": ntbl.key_lo,
        "n_mask": table.live_mask(ntbl),
        "n_label": labels, "n_size": sizes,
    })


def trace_snapshot(cfg: EngineCfg, st: AggState):
    """Per-(svc, api) snapshot: counters and latency percentiles."""
    q = loghist.quantiles(st.api_resp_hist, cfg.apiresp_spec, _QS3)
    return _host({
        "live": table.live_mask(st.api_tbl),
        "svc_hi": st.api_svc_hi, "svc_lo": st.api_svc_lo,
        "api_hi": st.api_id_hi, "api_lo": st.api_id_lo,
        "proto": st.api_proto,
        "ctr": st.api_ctr,
        "p50_us": q[:, 0], "p95_us": q[:, 1], "p99_us": q[:, 2],
        "hostid": st.api_host,
    })

