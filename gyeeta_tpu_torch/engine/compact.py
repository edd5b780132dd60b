"""Whole-engine slab compaction and service deletion.

Counterpart of ``gyeeta_tpu/engine/compact.py``. Compaction never moves
a key (``table.compact``), so here it is masked writes on the existing
buffers: every row-indexed column (the window rings through a view with
the row axis first) has its dead rows zeroed in place, and the
non-additive per-row state gets its empty value back — no copy of the
slab, whose HLL registers alone are 512 MiB at north-star geometry.
"""

from __future__ import annotations

import torch

from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.engine.aggstate import AggState, EngineCfg
from gyeeta_tpu_torch.utils.tensor import set_rows_drop


def _rows_leading(st: AggState) -> dict:
    """Row-indexed tensors with the row axis first. Window rings are
    (nslots, S, ...): their entries are ``movedim`` views, so writes
    through them land in the rings."""
    cols = {
        "resp_cur": st.resp_win.cur,
        "resp_alltime": st.resp_win.alltime,
        "ctr_cur": st.ctr_win.cur,
        "ctr_alltime": st.ctr_win.alltime,
        "svc_hll": st.svc_hll.regs,
        "td_means": st.svc_td.means,
        "td_weights": st.svc_td.weights,
        "td_vmin": st.svc_td.vmin,
        "td_vmax": st.svc_td.vmax,
        "td_stage": st.td_stage,
        "td_stage_n": st.td_stage_n,
        "svc_stats": st.svc_stats,
        "qps_hist": st.qps_hist,
        "active_hist": st.active_hist,
        "svc_host": st.svc_host,
        "svc_state": st.svc_state,
        "svc_issue": st.svc_issue,
        "resp_hi_bits": st.resp_hi_bits,
    }
    for name, win in (("resp", st.resp_win), ("ctr", st.ctr_win)):
        for i, (ring, tot) in enumerate(zip(win.rings, win.totals)):
            cols[f"{name}_ring{i}"] = torch.movedim(ring, 0, 1)
            cols[f"{name}_tot{i}"] = tot
    return cols


def compact_state(cfg: EngineCfg, st: AggState) -> AggState:
    """Reclaim the service slab's tombstones; every row that holds no
    live key is reset (zeros; digest min/max to +/-inf, host to -1), in
    place."""
    tbl = table.compact(st.tbl, _rows_leading(st).values())
    dead = ~table.live_mask(tbl)
    st.svc_td.vmin.masked_fill_(dead, torch.inf)
    st.svc_td.vmax.masked_fill_(dead, -torch.inf)
    st.svc_host.masked_fill_(dead, -1)
    return st._replace(tbl=tbl)


def delete_services(cfg: EngineCfg, st: AggState, khi, klo):
    """Tombstone services + zero their gauges → (state, rows). Sketch and
    window state is left for :func:`compact_state` to sweep."""
    tbl, rows = table.delete(st.tbl, khi, klo)
    hit = rows >= 0
    set_rows_drop(st.svc_stats, rows, 0.0, hit)
    set_rows_drop(st.svc_state, rows, 0, hit)
    set_rows_drop(st.svc_issue, rows, 0, hit)
    return st._replace(tbl=tbl), rows
