"""Point-in-time readbacks of live AggState.

Counterpart of ``gyeeta_tpu/query/readback.py`` for the fold path's
questions: per-service p50/p95/p99, bytes and distinct clients
(:func:`svc_snapshot`), and the heaviest flows (:func:`flow_snapshot`).
Each returns a dict of dense device columns; :func:`svc_rows_to_host`
reads them back once per column and assembles per-service rows.
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
