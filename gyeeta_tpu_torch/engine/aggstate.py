"""AggState: the device-resident aggregation state as a NamedTuple tree.

Counterpart of ``gyeeta_tpu/engine/aggstate.py``. ``EngineCfg`` (with
``LogHistSpec`` and ``WindowSpec``) is a copy with the same class names,
fields and defaults, so ``repr(cfg)`` — and with it the checkpoint
fingerprint — is the same in both packages. ``AggState`` has the
reference's 85 leaves in ``jax.tree_util.tree_flatten`` order, including
the task/api/cpumem leaves this slice does not fold.

uint32 leaves are held in the int64 carrier of ``utils/hashing.py``;
they are the only int64 leaves, which is how :func:`state_to_numpy`
and :func:`state_from_numpy` map them back and forth bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.engine import table
from gyeeta_tpu_torch.ingest import decode
from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, \
    invertible, loghist, tdigest, topk, windows
from gyeeta_tpu_torch.utils.tensor import tree_leaves, tree_unflatten

# conn-counter columns (windowed, per service)
CTR_BYTES_SENT = 0
CTR_BYTES_RCVD = 1
CTR_NCONN_CLOSED = 2
CTR_DUR_SUM_US = 3
NCTR = 4


class EngineCfg(NamedTuple):
    """Static engine geometry (field names and defaults as the
    reference's, whose comments explain each)."""
    svc_capacity: int = 1024
    n_hosts: int = 64
    resp_spec: loghist.LogHistSpec = loghist.LogHistSpec(
        vmin=1.0, vmax=1e8, nbuckets=256)
    qps_spec: loghist.LogHistSpec = loghist.LogHistSpec(
        vmin=1.0, vmax=1e6, nbuckets=64)
    active_spec: loghist.LogHistSpec = loghist.LogHistSpec(
        vmin=1.0, vmax=1e5, nbuckets=32)
    levels: tuple = windows.LEVELS_DEFAULT
    task_capacity: int = 2048
    api_capacity: int = 4096
    apiresp_spec: loghist.LogHistSpec = loghist.LogHistSpec(
        vmin=1.0, vmax=1e8, nbuckets=128)
    taskcpu_spec: loghist.LogHistSpec = loghist.LogHistSpec(
        vmin=0.1, vmax=1e4, nbuckets=32)
    hll_p_svc: int = 10
    hll_p_global: int = 14
    cms_depth: int = 2
    cms_width: int = 1 << 17
    topk_capacity: int = 512
    topk_budget: int = 2048
    hh_depth: int = 2
    hh_width: int = 4096
    hh_hot_frac: float = 1e-5
    td_capacity: int = 64
    td_stage_cap: int = 512
    td_sample_stride: int = 16
    td_flush_m: int = 256
    conn_batch: int = 2048
    resp_batch: int = 4096
    listener_batch: int = 512
    fold_k: int = 16


class AggState(NamedTuple):
    tbl: table.Table                  # service key slab (glob_id → row)
    resp_win: windows.MultiWindow     # (S, B) resp-time loghist, windowed
    ctr_win: windows.MultiWindow      # (S, NCTR) conn counters, windowed
    svc_hll: hll.HLL                  # (S, m) distinct client endpoints
    svc_td: tdigest.TDigest           # (S, C) per-svc resp digest
    td_stage: torch.Tensor            # (S, cap) staged raw samples
    td_stage_n: torch.Tensor          # (S,) int32 staged fill counts
    svc_stats: torch.Tensor           # (S, NSTAT) listener-state gauges
    qps_hist: torch.Tensor            # (S, Bq) learned QPS baseline hist
    active_hist: torch.Tensor         # (S, Ba) learned active-conn baseline
    svc_host: torch.Tensor            # (S,) int32 owning host id (-1 unset)
    svc_state: torch.Tensor           # (S,) int32 semantic state
    svc_issue: torch.Tensor           # (S,) int32 semantic issue
    resp_hi_bits: torch.Tensor        # (S,) int32 8-tick high-resp history
    host_panel: torch.Tensor          # (H, NHOSTCOL) last host state
    host_last_tick: torch.Tensor      # (H,) int32 tick of last host report
    host_cm: torch.Tensor             # (H, NCM) last raw 2s cpu/mem gauges
    cm_cpu_state: torch.Tensor        # (H,) int32
    cm_cpu_issue: torch.Tensor        # (H,) int32
    cm_mem_state: torch.Tensor        # (H,) int32
    cm_mem_issue: torch.Tensor        # (H,) int32
    cm_last_tick: torch.Tensor        # (H,) int32
    task_tbl: table.Table             # aggr_task_id → row
    task_stats: torch.Tensor          # (T, NTASKSTAT) last sweep gauges
    task_state: torch.Tensor          # (T,) int32
    task_issue: torch.Tensor          # (T,) int32
    task_host: torch.Tensor           # (T,) int32 owning host (-1 unset)
    task_comm_hi: torch.Tensor        # (T,) u32 carrier: comm id halves
    task_comm_lo: torch.Tensor
    task_rel_hi: torch.Tensor         # (T,) u32 carrier: related listener
    task_rel_lo: torch.Tensor
    task_cpu_hist: torch.Tensor       # (T, Bc) learned CPU% baseline
    task_last_tick: torch.Tensor      # (T,) int32
    api_tbl: table.Table              # mix(svc, api) → row
    api_svc_hi: torch.Tensor          # (A,) u32 carrier: service id halves
    api_svc_lo: torch.Tensor
    api_id_hi: torch.Tensor           # (A,) u32 carrier: api signature
    api_id_lo: torch.Tensor
    api_proto: torch.Tensor           # (A,) int32
    api_resp_hist: torch.Tensor       # (A, Ba) response-time loghist
    api_ctr: torch.Tensor             # (A, 4) nreq/nerr/bytes_in/bytes_out
    api_host: torch.Tensor            # (A,) int32 last reporting host
    api_last_tick: torch.Tensor       # (A,) int32
    glob_hll: hll.HLL                 # distinct flow endpoints global
    cms: countmin.CMS                 # flow-key → bytes
    flow_topk: topk.TopK              # heavy-hitter flows by bytes
    inv: invertible.InvSketch         # invertible candidate buckets
    n_conn: torch.Tensor              # () f32 counters
    n_resp: torch.Tensor
    n_td_overflow: torch.Tensor       # samples that missed the digest path
    n_resp_unknown: torch.Tensor      # resp samples for unannounced svcs


def init(cfg: EngineCfg, device=None) -> AggState:
    """Fresh state on ``device`` (CUDA by default; raises without a GPU
    unless ``device="cpu"``)."""
    return _init(cfg, resolve(device))


def _init(cfg: EngineCfg, dev: torch.device) -> AggState:
    S = cfg.svc_capacity
    H = cfg.n_hosts
    T = cfg.task_capacity
    A = cfg.api_capacity
    f32, i32, u32 = torch.float32, torch.int32, torch.int64

    def z(shape, dt=f32):
        return torch.zeros(shape, dtype=dt, device=dev)

    def neg(shape):
        return torch.full(shape, -1, dtype=i32, device=dev)

    return AggState(
        tbl=table.init(S, device=dev),
        resp_win=windows.init((S, cfg.resp_spec.nbuckets), cfg.levels,
                              device=dev),
        ctr_win=windows.init((S, NCTR), cfg.levels, device=dev),
        svc_hll=hll.init(p=cfg.hll_p_svc, entities=(S,), device=dev),
        svc_td=tdigest.init(capacity=cfg.td_capacity, entities=(S,),
                            device=dev),
        td_stage=z((S, cfg.td_stage_cap)),
        td_stage_n=z((S,), i32),
        svc_stats=z((S, decode.NSTAT)),
        qps_hist=z((S, cfg.qps_spec.nbuckets)),
        active_hist=z((S, cfg.active_spec.nbuckets)),
        svc_host=neg((S,)),
        svc_state=z((S,), i32),
        svc_issue=z((S,), i32),
        resp_hi_bits=z((S,), i32),
        host_panel=z((H, decode.NHOSTCOL)),
        host_last_tick=neg((H,)),
        host_cm=z((H, decode.NCM)),
        cm_cpu_state=z((H,), i32),
        cm_cpu_issue=z((H,), i32),
        cm_mem_state=z((H,), i32),
        cm_mem_issue=z((H,), i32),
        cm_last_tick=neg((H,)),
        task_tbl=table.init(T, device=dev),
        task_stats=z((T, decode.NTASKSTAT)),
        task_state=z((T,), i32),
        task_issue=z((T,), i32),
        task_host=neg((T,)),
        task_comm_hi=z((T,), u32),
        task_comm_lo=z((T,), u32),
        task_rel_hi=z((T,), u32),
        task_rel_lo=z((T,), u32),
        task_cpu_hist=z((T, cfg.taskcpu_spec.nbuckets)),
        task_last_tick=neg((T,)),
        api_tbl=table.init(A, device=dev),
        api_svc_hi=z((A,), u32),
        api_svc_lo=z((A,), u32),
        api_id_hi=z((A,), u32),
        api_id_lo=z((A,), u32),
        api_proto=z((A,), i32),
        api_resp_hist=z((A, cfg.apiresp_spec.nbuckets)),
        api_ctr=z((A, 4)),
        api_host=neg((A,)),
        api_last_tick=neg((A,)),
        glob_hll=hll.init(p=cfg.hll_p_global, device=dev),
        cms=countmin.init(cfg.cms_depth, cfg.cms_width, device=dev),
        flow_topk=topk.init(cfg.topk_capacity, device=dev),
        inv=invertible.init(cfg.hh_depth, max(cfg.hh_width, 1), device=dev),
        n_conn=z(()),
        n_resp=z(()),
        n_td_overflow=z(()),
        n_resp_unknown=z(()),
    )


def state_to_numpy(st: AggState) -> list:
    """The state's leaves as numpy arrays, in the reference's flattened
    order and dtypes (the list ``checkpoint.save`` writes as
    ``leaf_{i}``): u32 carriers come back as uint32."""
    out = []
    for leaf in tree_leaves(st):
        a = leaf.detach().cpu().numpy().copy()
        if a.dtype == np.int64:
            if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
                raise ValueError("u32 carrier leaf holds a value outside "
                                 "[0, 2**32)")
            a = a.astype(np.uint32)
        out.append(a)
    return out


def state_from_numpy(leaves, device=None) -> AggState:
    """Inverse of :func:`state_to_numpy`: the reference's flattened
    leaves → an AggState on ``device``. uint32 leaves go into the int64
    carrier; every other leaf keeps its dtype."""
    n_levels, rem = divmod(len(leaves) - _N_FIXED_LEAVES, 4)
    if rem or n_levels < 0:
        raise ValueError(f"{len(leaves)} leaves do not form an AggState")
    dev = resolve(device)
    tensors = []
    for a in leaves:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        tensors.append(torch.tensor(a, device=dev))
    template = _init(EngineCfg(svc_capacity=1, n_hosts=1, task_capacity=1,
                               api_capacity=1,
                               levels=(windows.WindowSpec(1, 1),) * n_levels,
                               hll_p_svc=0, hll_p_global=0, cms_depth=1,
                               cms_width=1, topk_capacity=1, hh_depth=1,
                               hh_width=1, td_capacity=1, td_stage_cap=1),
                     torch.device("meta"))
    return tree_unflatten(template, tensors)


# leaves besides the two windows' per-level rings and totals (4 a level)
_N_FIXED_LEAVES = 77
