"""Structured wire records → fixed-shape columnar microbatches (numpy).

Counterpart of ``gyeeta_tpu/ingest/decode.py`` for the record types of
``fold_all``: the conn/resp slab, the sweep sections (listener, host,
task, cpu/mem, trace, ping) and the SKETCH_DELTA section of edge
pre-aggregation (:func:`delta_batch`). The builders stay numpy, exactly
as in the reference:
64-bit ids split into ``(hi, lo)`` uint32 pairs, IPs folded to two
uint32 words, the flow 5-tuple hashed to a 64-bit key on the host
(bit-identical to the device hash), and a ``valid`` lane mask marking
padding. :func:`to_device` is the one step the port adds: it stacks K
batches to ``(K, B)`` columns and moves them to the device, with every
uint32 column in the int64 carrier of ``utils/hashing.py``.

The runtime's staging helpers are here too: :func:`drain_chunks` (the
fold plan of a drained feed), :func:`take_raw_chunks`,
:func:`conn_slab` / :func:`resp_slab` (raw records → one ``(K, B)``
slab, decoded in place into a reused buffer of the double-buffered
staging slabs: :func:`alloc_conn_cols` / :func:`alloc_resp_cols`) and
:func:`resp_from_trace` (the trace→resp bridge). The slab and section
builders decode through the native C++ path of ``ingest/native`` unless
asked for numpy (``native=False``), bit for bit the same columns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.ingest import native as nat, wire
from gyeeta_tpu_torch.utils import hashing as H

# stat column indices of ListenerBatch.stats (and AggState.svc_stats)
STAT_NQRYS = 0
STAT_TOTAL_RESP_MS = 1
STAT_NCONNS = 2
STAT_NCONNS_ACTIVE = 3
STAT_NTASKS = 4
STAT_KB_IN = 5
STAT_KB_OUT = 6
STAT_SER_ERRORS = 7
STAT_CLI_ERRORS = 8
STAT_TASKS_DELAY_US = 9
STAT_TASKS_CPUDELAY_US = 10
STAT_TASKS_BLKIODELAY_US = 11
STAT_USER_CPU = 12
STAT_SYS_CPU = 13
STAT_RSS_MB = 14
STAT_NTASKS_ISSUE = 15
NSTAT = 16

# task stat column indices of TaskBatch.stats (and AggState.task_stats)
TASK_TCP_KB = 0
TASK_TCP_CONNS = 1
TASK_CPU_PCT = 2
TASK_RSS_MB = 3
TASK_CPU_DELAY_MS = 4
TASK_VM_DELAY_MS = 5
TASK_BLKIO_DELAY_MS = 6
TASK_NTASKS = 7
TASK_NTASKS_ISSUE = 8
TASK_FORKS_SEC = 9
NTASKSTAT = 10

_TASK_STAT_FIELDS = (
    "tcp_kbytes", "tcp_conns", "total_cpu_pct", "rss_mb", "cpu_delay_msec",
    "vm_delay_msec", "blkio_delay_msec", "ntasks_total", "ntasks_issue",
    "forks_sec",
)

# host panel column indices of HostBatch.panel (and AggState.host_panel)
HOST_NTASKS = 0
HOST_NTASKS_ISSUE = 1
HOST_NTASKS_SEVERE = 2
HOST_NLISTEN = 3
HOST_NLISTEN_ISSUE = 4
HOST_NLISTEN_SEVERE = 5
HOST_CPU_ISSUE = 6
HOST_MEM_ISSUE = 7
HOST_SEVERE_CPU = 8
HOST_SEVERE_MEM = 9
HOST_STATE = 10
NHOSTCOL = 11

_HOST_PANEL_FIELDS = (
    "ntasks", "ntasks_issue", "ntasks_severe", "nlisten", "nlisten_issue",
    "nlisten_severe", "cpu_issue", "mem_issue", "severe_cpu_issue",
    "severe_mem_issue", "curr_state",
)

# cpu/mem column indices of CpuMemBatch.vals (and AggState.host_cm)
CM_CPU_PCT = 0
CM_USERCPU_PCT = 1
CM_SYSCPU_PCT = 2
CM_IOWAIT_PCT = 3
CM_MAX_CORE_CPU_PCT = 4
CM_CS_SEC = 5
CM_FORKS_SEC = 6
CM_PROCS_RUNNING = 7
CM_RSS_PCT = 8
CM_COMMIT_PCT = 9
CM_SWAP_FREE_PCT = 10
CM_PG_INOUT_SEC = 11
CM_SWAP_INOUT_SEC = 12
CM_ALLOCSTALL_SEC = 13
CM_OOM_KILLS = 14
CM_NCPUS = 15
NCM = 16

_CM_FIELDS = (
    "cpu_pct", "usercpu_pct", "syscpu_pct", "iowait_pct",
    "max_core_cpu_pct", "cs_sec", "forks_sec", "procs_running",
    "rss_pct", "commit_pct", "swap_free_pct", "pg_inout_sec",
    "swap_inout_sec", "allocstall_sec", "oom_kills", "ncpus",
)

_LISTENER_STAT_FIELDS = (
    "nqrys_5s", "total_resp_5sec", "nconns", "nconns_active", "ntasks",
    "curr_kbytes_inbound", "curr_kbytes_outbound", "ser_errors",
    "cli_errors", "tasks_delay_usec", "tasks_cpudelay_usec",
    "tasks_blkiodelay_usec", "tasks_user_cpu", "tasks_sys_cpu",
    "tasks_rss_mb", "ntasks_issue",
)


def split_u64(a) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(a, np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def fold_ip(ip_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,16) uint8 → two uint32 words (xor-fold halves)."""
    w = ip_bytes.reshape(-1, 4, 4).copy().view("<u4").reshape(-1, 4)
    return (w[:, 0] ^ w[:, 2]).astype(np.uint32), \
        (w[:, 1] ^ w[:, 3]).astype(np.uint32)


class ConnBatch(NamedTuple):
    """Columnar TCP_CONN microbatch (all shape (B,))."""
    svc_hi: np.ndarray        # ser_glob_id split — per-service routing key
    svc_lo: np.ndarray
    flow_hi: np.ndarray       # 5-tuple flow key
    flow_lo: np.ndarray
    cli_hi: np.ndarray        # client endpoint identity (HLL distinct-cli)
    cli_lo: np.ndarray
    cli_task_hi: np.ndarray   # client process-group id
    cli_task_lo: np.ndarray
    cli_rel_hi: np.ndarray    # client related-listener id
    cli_rel_lo: np.ndarray
    bytes_sent: np.ndarray    # float32
    bytes_rcvd: np.ndarray    # float32
    duration_us: np.ndarray   # float32 (0 if still open)
    host_id: np.ndarray       # int32 source agent
    is_close: np.ndarray      # bool — close-notification record
    is_accept: np.ndarray     # bool — server-side (accept-observed)
    valid: np.ndarray         # bool lane mask


class RespBatch(NamedTuple):
    svc_hi: np.ndarray
    svc_lo: np.ndarray
    resp_us: np.ndarray       # float32 response/service time in usec
    host_id: np.ndarray
    valid: np.ndarray


class ListenerBatch(NamedTuple):
    """Columnar LISTENER_STATE microbatch: key + packed stat columns."""
    svc_hi: np.ndarray
    svc_lo: np.ndarray
    stats: np.ndarray         # (B, NSTAT) float32, see STAT_* indices
    host_id: np.ndarray
    valid: np.ndarray


class HostBatch(NamedTuple):
    """Columnar HOST_STATE microbatch (dense panel write by host_id)."""
    host_id: np.ndarray       # int32
    panel: np.ndarray         # (B, NHOSTCOL) float32, HOST_* order
    valid: np.ndarray


class CpuMemBatch(NamedTuple):
    """Columnar CPU_MEM_STATE (2s) microbatch: raw gauges by host."""
    host_id: np.ndarray       # int32
    vals: np.ndarray          # (B, NCM) float32, CM_* indices
    valid: np.ndarray


class TraceBatch(NamedTuple):
    """Columnar REQ_TRACE microbatch: one parsed transaction per lane."""
    key_hi: np.ndarray        # mix(svc, api) — per-API routing key
    key_lo: np.ndarray
    svc_hi: np.ndarray        # service glob id halves
    svc_lo: np.ndarray
    api_hi: np.ndarray        # interned api signature halves
    api_lo: np.ndarray
    resp_us: np.ndarray       # float32
    byin: np.ndarray          # float32
    byout: np.ndarray         # float32
    proto: np.ndarray         # int32
    is_err: np.ndarray        # bool
    host_id: np.ndarray       # int32
    valid: np.ndarray


class PingBatch(NamedTuple):
    """Columnar TASK_PING microbatch (process-group keepalives): keys
    only — the fold refreshes ``task_last_tick`` of EXISTING rows and
    never inserts."""
    key_hi: np.ndarray        # aggr_task_id split
    key_lo: np.ndarray
    host_id: np.ndarray       # int32
    valid: np.ndarray


class TaskBatch(NamedTuple):
    """Columnar AGGR_TASK_STATE microbatch (process-group 5s sweep)."""
    key_hi: np.ndarray        # aggr_task_id split — process-group key
    key_lo: np.ndarray
    comm_hi: np.ndarray       # interned comm id
    comm_lo: np.ndarray
    rel_hi: np.ndarray        # related_listen_id (task→svc join)
    rel_lo: np.ndarray
    stats: np.ndarray         # (B, NTASKSTAT) float32, TASK_* indices
    state: np.ndarray         # int32 agent-classified state
    issue: np.ndarray         # int32 agent-classified issue source
    host_id: np.ndarray       # int32
    valid: np.ndarray


class DeltaBatch(NamedTuple):
    """Columnar SKETCH_DELTA microbatch: the wire's typed-envelope
    records (``wire.DELTA_DT``) expanded on the host into per-family
    fixed lanes that ``engine/step.py:ingest_delta`` scatters directly;
    the unique svc-key section drives one table upsert a dispatch."""
    # unique svc keys across every svc-referencing family (one upsert)
    svc_hi: np.ndarray        # (Lk,) uint32
    svc_lo: np.ndarray
    svc_host: np.ndarray      # (Lk,) int32 — owning agent
    svc_valid: np.ndarray
    # per-svc exact counter rows (ctr_win order + n_conn/n_resp)
    ctr_hi: np.ndarray        # (Lc,)
    ctr_lo: np.ndarray
    ctr_vals: np.ndarray      # (Lc, 6) float32
    ctr_valid: np.ndarray
    # per-svc resp loghist bucket counts
    hist_hi: np.ndarray       # (Lh,)
    hist_lo: np.ndarray
    hist_bucket: np.ndarray   # (Lh,) int32
    hist_w: np.ndarray        # (Lh,) float32
    hist_valid: np.ndarray
    # per-svc distinct-client HLL register maxes
    shll_hi: np.ndarray       # (Ls,)
    shll_lo: np.ndarray
    shll_reg: np.ndarray      # (Ls,) int32
    shll_rank: np.ndarray     # (Ls,) int32
    shll_valid: np.ndarray
    # global flow-HLL register maxes
    ghll_reg: np.ndarray      # (Lg,) int32
    ghll_rank: np.ndarray     # (Lg,) int32
    ghll_valid: np.ndarray
    # per-svc t-digest stage samples (pre-strided at the agent)
    td_hi: np.ndarray         # (Lt,)
    td_lo: np.ndarray
    td_val: np.ndarray        # (Lt,) float32
    td_valid: np.ndarray
    # flow aggregates (CMS / top-K / invertible inputs)
    flow_hi: np.ndarray       # (Lf,)
    flow_lo: np.ndarray
    flow_val: np.ndarray      # (Lf,) float32
    flow_valid: np.ndarray
    # dependency edges (direct-edge fold)
    dep_cli_hi: np.ndarray    # (Ld,)
    dep_cli_lo: np.ndarray
    dep_cli_svc: np.ndarray   # (Ld,) bool
    dep_ser_hi: np.ndarray
    dep_ser_lo: np.ndarray
    dep_nconn: np.ndarray     # (Ld,) float32
    dep_bytes: np.ndarray     # (Ld,) float32
    dep_valid: np.ndarray
    # sweep residuals: agent-truncated flow mass → top-K evicted bound
    evicted_add: np.ndarray   # (1,) float32


# SKETCH_DELTA records a dispatch (the drain_chunks chunk size and the
# runtime's delta section lanes)
DELTA_LANES_DEFAULT = 256


def _pad(a: np.ndarray, size: int, fill=0):
    out = np.full((size,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a[:size]
    return out


def _check_fit(recs, size):
    """Batch builders never truncate silently."""
    if len(recs) > size:
        raise ValueError(
            f"{len(recs)} records exceed batch size {size}; split upstream")
    return len(recs)


def _conn_cols(r: np.ndarray) -> dict:
    """TCP_CONN records → unpadded ConnBatch columns (all but
    ``valid``)."""
    n = len(r)
    svc_hi, svc_lo = split_u64(r["ser_glob_id"])
    # NAT-aware flow identity: when conntrack resolved a translated
    # tuple, both halves key on the POST-NAT 5-tuple
    nat_c = r["nat_cli"]["ip"].any(axis=1)
    nat_s = r["nat_ser"]["ip"].any(axis=1)
    eff_cli = np.where(nat_c[:, None], r["nat_cli"]["ip"], r["cli"]["ip"])
    eff_ser = np.where(nat_s[:, None], r["nat_ser"]["ip"], r["ser"]["ip"])
    eff_cport = np.where(nat_c, r["nat_cli"]["port"], r["cli"]["port"])
    eff_sport = np.where(nat_s, r["nat_ser"]["port"], r["ser"]["port"])
    cip_hi, cip_lo = fold_ip(np.ascontiguousarray(eff_cli))
    sip_hi, sip_lo = fold_ip(np.ascontiguousarray(eff_ser))
    proto = np.full(n, 6, np.uint32)  # TCP
    f_hi, f_lo = H.flow_key(cip_hi, cip_lo, sip_hi, sip_lo,
                            eff_cport.astype(np.uint32),
                            eff_sport.astype(np.uint32), proto)
    # client endpoint identity = address hash only (distinct clients)
    c_hi = H.fmix32(cip_hi ^ np.uint32(0xC11E57))
    c_lo = H.fmix32(cip_lo ^ c_hi)
    t_hi, t_lo = split_u64(r["cli_task_aggr_id"])
    rel_hi, rel_lo = split_u64(r["cli_related_listen_id"])
    closed = r["tusec_close"] > 0
    dur = np.where(closed, r["tusec_close"] - r["tusec_start"],
                   0).astype(np.float32)
    return dict(
        svc_hi=svc_hi, svc_lo=svc_lo, flow_hi=f_hi, flow_lo=f_lo,
        cli_hi=c_hi, cli_lo=c_lo, cli_task_hi=t_hi, cli_task_lo=t_lo,
        cli_rel_hi=rel_hi, cli_rel_lo=rel_lo,
        bytes_sent=r["bytes_sent"].astype(np.float32),
        bytes_rcvd=r["bytes_rcvd"].astype(np.float32),
        duration_us=dur, host_id=r["host_id"].astype(np.int32),
        is_close=closed, is_accept=(r["flags"] & 2) != 0)


def _resp_cols(r: np.ndarray) -> dict:
    """RESP_SAMPLE records → unpadded RespBatch columns (all but
    ``valid``)."""
    svc_hi, svc_lo = split_u64(r["glob_id"])
    return dict(svc_hi=svc_hi, svc_lo=svc_lo,
                resp_us=r["resp_usec"].astype(np.float32),
                host_id=r["host_id"].astype(np.int32))


def conn_batch(recs: np.ndarray, size: int = wire.MAX_CONNS_PER_BATCH
               ) -> ConnBatch:
    n = _check_fit(recs, size)
    cols = {k: _pad(v, size) for k, v in _conn_cols(recs[:n]).items()}
    return ConnBatch(valid=_valid(n, size), **cols)


def resp_batch(recs: np.ndarray, size: int = wire.MAX_RESP_PER_BATCH
               ) -> RespBatch:
    n = _check_fit(recs, size)
    cols = {k: _pad(v, size) for k, v in _resp_cols(recs[:n]).items()}
    return RespBatch(valid=_valid(n, size), **cols)


def _valid(n: int, size: int) -> np.ndarray:
    valid = np.zeros(size, bool)
    valid[:n] = True
    return valid


def _packed(r, fields) -> np.ndarray:
    """Record fields → one (n, len(fields)) float32 block."""
    out = np.zeros((len(r), len(fields)), np.float32)
    for i, f in enumerate(fields):
        out[:, i] = r[f].astype(np.float32)
    return out


def listener_batch(recs: np.ndarray,
                   size: int = wire.MAX_LISTENERS_PER_BATCH
                   ) -> ListenerBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    svc_hi, svc_lo = split_u64(r["glob_id"])
    return ListenerBatch(
        svc_hi=_pad(svc_hi, size), svc_lo=_pad(svc_lo, size),
        stats=_pad(_packed(r, _LISTENER_STAT_FIELDS), size),
        host_id=_pad(r["host_id"].astype(np.int32), size),
        valid=_valid(n, size),
    )


def task_batch(recs: np.ndarray, size: int = wire.MAX_TASKS_PER_BATCH
               ) -> TaskBatch:
    """AGGR_TASK_STATE records → columnar microbatch."""
    n = _check_fit(recs, size)
    r = recs[:n]
    k_hi, k_lo = split_u64(r["aggr_task_id"])
    c_hi, c_lo = split_u64(r["comm_id"])
    rl_hi, rl_lo = split_u64(r["related_listen_id"])
    return TaskBatch(
        key_hi=_pad(k_hi, size), key_lo=_pad(k_lo, size),
        comm_hi=_pad(c_hi, size), comm_lo=_pad(c_lo, size),
        rel_hi=_pad(rl_hi, size), rel_lo=_pad(rl_lo, size),
        stats=_pad(_packed(r, _TASK_STAT_FIELDS), size),
        state=_pad(r["curr_state"].astype(np.int32), size),
        issue=_pad(r["curr_issue"].astype(np.int32), size),
        host_id=_pad(r["host_id"].astype(np.int32), size),
        valid=_valid(n, size),
    )


def trace_batch(recs: np.ndarray, size: int = wire.MAX_TRACE_PER_BATCH
                ) -> TraceBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    svc_hi, svc_lo = split_u64(r["svc_glob_id"])
    api_hi, api_lo = split_u64(r["api_id"])
    # per-API slab key: one mixed 64-bit id over (svc, api)
    k_hi = H.mix64(svc_hi ^ api_hi, svc_lo, 0xA91D)
    k_lo = H.mix64(api_lo, svc_lo ^ api_lo, 0x77E1)
    return TraceBatch(
        key_hi=_pad(k_hi, size), key_lo=_pad(k_lo, size),
        svc_hi=_pad(svc_hi, size), svc_lo=_pad(svc_lo, size),
        api_hi=_pad(api_hi, size), api_lo=_pad(api_lo, size),
        resp_us=_pad(r["resp_usec"].astype(np.float32), size),
        byin=_pad(r["bytes_in"].astype(np.float32), size),
        byout=_pad(r["bytes_out"].astype(np.float32), size),
        proto=_pad(r["proto"].astype(np.int32), size),
        is_err=_pad(r["is_error"].astype(bool), size),
        host_id=_pad(r["host_id"].astype(np.int32), size),
        valid=_valid(n, size),
    )


def cpumem_batch(recs: np.ndarray, size: int = wire.MAX_CPUMEM_PER_BATCH
                 ) -> CpuMemBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    return CpuMemBatch(
        host_id=_pad(r["host_id"].astype(np.int32), size),
        vals=_pad(_packed(r, _CM_FIELDS), size),
        valid=_valid(n, size),
    )


def host_batch(recs: np.ndarray, size: int = wire.MAX_HOSTS_PER_BATCH
               ) -> HostBatch:
    n = _check_fit(recs, size)
    r = recs[:n]
    return HostBatch(
        host_id=_pad(r["host_id"].astype(np.int32), size),
        panel=_pad(_packed(r, _HOST_PANEL_FIELDS), size),
        valid=_valid(n, size),
    )


# ------------------------------------------------ native section builders
# The sections decode through the native C++ path (``ingest/native``) by
# default, bit for bit the columns of the numpy builders above; the
# caller picks the numpy path with ``native=False``. ``stats`` counts
# the decoded records by path (``_count_path``).


def _count_path(stats, used_native: bool, n: int) -> None:
    """Per-path decode counters of selfstats: ``ref_native_decoded`` /
    ``ref_fallback_decoded``, bumped by the records each section
    decodes."""
    if stats is not None and n:
        stats.bump("ref_native_decoded" if used_native
                   else "ref_fallback_decoded", n)


def listener_batch_fast(recs: np.ndarray,
                        size: int = wire.MAX_LISTENERS_PER_BATCH,
                        stats=None, native: bool = True) -> ListenerBatch:
    """LISTENER_STATE records → ListenerBatch: the id split and the stat
    matrix in one native pass each (``native=False``: the numpy
    :func:`listener_batch`)."""
    n = _check_fit(recs, size)
    _count_path(stats, native, n)
    if not native:
        return listener_batch(recs, size)
    r = recs[:n]
    svc_hi = np.zeros(size, np.uint32)
    svc_lo = np.zeros(size, np.uint32)
    stat_m = np.zeros((size, NSTAT), np.float32)
    host_id = np.zeros(size, np.int32)
    nat.split_u64_into(r, "glob_id", svc_hi, svc_lo)
    nat.pack_f32_into(r, _LISTENER_STAT_FIELDS, stat_m)
    nat.pack_i32_into(r, "host_id", host_id)
    return ListenerBatch(svc_hi=svc_hi, svc_lo=svc_lo, stats=stat_m,
                         host_id=host_id, valid=_valid(n, size))


def task_batch_fast(recs: np.ndarray,
                    size: int = wire.MAX_TASKS_PER_BATCH,
                    stats=None, native: bool = True) -> TaskBatch:
    """AGGR_TASK_STATE records → TaskBatch, native (see
    :func:`listener_batch_fast`)."""
    n = _check_fit(recs, size)
    _count_path(stats, native, n)
    if not native:
        return task_batch(recs, size)
    r = recs[:n]
    cols = {k: np.zeros(size, np.uint32)
            for k in ("key_hi", "key_lo", "comm_hi", "comm_lo", "rel_hi",
                      "rel_lo")}
    stat_m = np.zeros((size, NTASKSTAT), np.float32)
    state, issue, host_id = (np.zeros(size, np.int32) for _ in range(3))
    nat.split_u64_into(r, "aggr_task_id", cols["key_hi"], cols["key_lo"])
    nat.split_u64_into(r, "comm_id", cols["comm_hi"], cols["comm_lo"])
    nat.split_u64_into(r, "related_listen_id", cols["rel_hi"],
                       cols["rel_lo"])
    nat.pack_f32_into(r, _TASK_STAT_FIELDS, stat_m)
    nat.pack_i32_into(r, "curr_state", state)
    nat.pack_i32_into(r, "curr_issue", issue)
    nat.pack_i32_into(r, "host_id", host_id)
    return TaskBatch(stats=stat_m, state=state, issue=issue,
                     host_id=host_id, valid=_valid(n, size), **cols)


def ping_batch(recs: np.ndarray, size: int = wire.MAX_PINGS_PER_BATCH,
               stats=None, native: bool = True) -> PingBatch:
    """TASK_PING records → columnar keepalive microbatch (the key split
    native unless ``native=False``)."""
    n = _check_fit(recs, size)
    _count_path(stats, native, n)
    r = recs[:n]
    if not native:
        k_hi, k_lo = split_u64(r["aggr_task_id"])
        return PingBatch(key_hi=_pad(k_hi, size), key_lo=_pad(k_lo, size),
                         host_id=_pad(r["host_id"].astype(np.int32), size),
                         valid=_valid(n, size))
    k_hi = np.zeros(size, np.uint32)
    k_lo = np.zeros(size, np.uint32)
    host_id = np.zeros(size, np.int32)
    nat.split_u64_into(r, "aggr_task_id", k_hi, k_lo)
    nat.pack_i32_into(r, "host_id", host_id)
    return PingBatch(key_hi=k_hi, key_lo=k_lo, host_id=host_id,
                     valid=_valid(n, size))


def cpumem_batch_fast(recs: np.ndarray,
                      size: int = wire.MAX_CPUMEM_PER_BATCH,
                      stats=None, native: bool = True) -> CpuMemBatch:
    """CPU_MEM_STATE records → CpuMemBatch, native (see
    :func:`listener_batch_fast`)."""
    n = _check_fit(recs, size)
    _count_path(stats, native, n)
    if not native:
        return cpumem_batch(recs, size)
    r = recs[:n]
    vals = np.zeros((size, NCM), np.float32)
    host_id = np.zeros(size, np.int32)
    nat.pack_f32_into(r, _CM_FIELDS, vals)
    nat.pack_i32_into(r, "host_id", host_id)
    return CpuMemBatch(host_id=host_id, vals=vals, valid=_valid(n, size))


def host_batch_fast(recs: np.ndarray,
                    size: int = wire.MAX_HOSTS_PER_BATCH,
                    stats=None, native: bool = True) -> HostBatch:
    """HOST_STATE records → HostBatch, native (see
    :func:`listener_batch_fast`)."""
    n = _check_fit(recs, size)
    _count_path(stats, native, n)
    if not native:
        return host_batch(recs, size)
    r = recs[:n]
    panel = np.zeros((size, NHOSTCOL), np.float32)
    host_id = np.zeros(size, np.int32)
    nat.pack_f32_into(r, _HOST_PANEL_FIELDS, panel)
    nat.pack_i32_into(r, "host_id", host_id)
    return HostBatch(host_id=host_id, panel=panel, valid=_valid(n, size))


def _delta_pad(a, lanes, dtype):
    a = np.asarray(a)
    out = np.zeros((lanes,) + a.shape[1:], dtype)
    out[: len(a)] = a[:lanes]
    return out


def _delta_mask(n, lanes):
    v = np.zeros(lanes, bool)
    v[:n] = True
    return v


def delta_batch(recs: np.ndarray, size: int = DELTA_LANES_DEFAULT,
                stats=None, resp_nbuckets: int = 0,
                hll_m_svc: int = 0, hll_m_glob: int = 0) -> DeltaBatch:
    """SKETCH_DELTA records → expanded per-family columnar lanes.

    ``resp_nbuckets`` / ``hll_m_svc`` / ``hll_m_glob``: the consuming
    engine's geometry — payload items whose index falls outside it are
    DROPPED AND COUNTED (``preagg_oob_items``), never scattered out of
    range (a corrupt or mis-negotiated index must not fold garbage).
    Family lane budgets derive from ``size`` at the per-record payload
    maxima, so a ≤size record batch can never overflow a family."""
    n = _check_fit(recs, size)
    r = recs[:n]
    kinds = r["kind"]
    nitem = r["nitem"].astype(np.int64)
    oob = 0

    def pairs_of(mask, cap_items):
        """(svc64, idx, wt, src_row) lanes for one pair-payload kind."""
        rows = np.nonzero(mask)[0]
        if not len(rows):
            z = np.empty(0, np.int64)
            return (np.empty(0, np.uint32), np.empty(0, np.uint32),
                    z, np.empty(0, np.float32), 0)
        P = wire.DELTA_PAIRS
        pv = r["payload"][rows].reshape(len(rows), -1)[
            :, : P * 6].copy().reshape(-1).view(wire.DELTA_PAIR_DT)
        ni = np.minimum(nitem[rows], P)
        lane = np.arange(P)[None, :]
        keep = (lane < ni[:, None]).reshape(-1)
        idx = pv["idx"].astype(np.int64)[keep]
        wt = pv["wt"].astype(np.float32)[keep]
        src = np.repeat(rows, P)[keep]
        no = 0
        if cap_items:
            ok = idx < cap_items
            no = int((~ok).sum())
            idx, wt, src = idx[ok], wt[ok], src[ok]
        return (r["key_hi"][src], r["key_lo"][src], idx, wt, no)

    # ---- ctr rows
    cm = kinds == wire.DK_SVC_CTR
    crows = np.nonzero(cm)[0]
    if len(crows):
        ctr_vals = r["payload"][crows].reshape(len(crows), -1)[
            :, :24].copy().view("<f4")[:, :6]
    else:
        ctr_vals = np.zeros((0, 6), np.float32)
    Lc = size
    ctr = (_delta_pad(r["key_hi"][crows], Lc, np.uint32),
           _delta_pad(r["key_lo"][crows], Lc, np.uint32),
           _delta_pad(ctr_vals, Lc, np.float32),
           _delta_mask(len(crows), Lc))

    # ---- sparse-pair families
    hh, hl, hb, hw, no = pairs_of(kinds == wire.DK_SVC_HIST,
                                  resp_nbuckets)
    oob += no
    Lh = size * wire.DELTA_PAIRS
    sh, sl, sr, srk, no = pairs_of(kinds == wire.DK_SVC_HLL, hll_m_svc)
    oob += no
    gh_, gl_, gr, grk, no = pairs_of(kinds == wire.DK_GLOB_HLL,
                                     hll_m_glob)
    oob += no

    # ---- td sample rows
    tm = np.nonzero(kinds == wire.DK_SVC_TD)[0]
    S = wire.DELTA_SAMPLES
    if len(tm):
        pv = r["payload"][tm].reshape(len(tm), -1).copy().view("<f4")
        ni = np.minimum(nitem[tm], S)
        keep = (np.arange(S)[None, :] < ni[:, None]).reshape(-1)
        td_v = pv.reshape(-1)[keep]
        src = np.repeat(tm, S)[keep]
        td_hi, td_lo = r["key_hi"][src], r["key_lo"][src]
    else:
        td_v = np.empty(0, np.float32)
        td_hi = td_lo = np.empty(0, np.uint32)
    Lt = size * S

    # ---- flow rows
    fm = np.nonzero(kinds == wire.DK_FLOW)[0]
    F = wire.DELTA_FLOWS
    if len(fm):
        pv = r["payload"][fm].reshape(len(fm), -1)[
            :, : F * 12].copy().reshape(-1).view(wire.DELTA_FLOW_DT)
        ni = np.minimum(nitem[fm], F)
        keep = (np.arange(F)[None, :] < ni[:, None]).reshape(-1)
        fl_hi = pv["hi"][keep]
        fl_lo = pv["lo"][keep]
        fl_v = pv["val"].astype(np.float32)[keep]
    else:
        fl_hi = fl_lo = np.empty(0, np.uint32)
        fl_v = np.empty(0, np.float32)
    Lf = size * F

    # ---- dep rows
    dm = np.nonzero(kinds == wire.DK_DEP)[0]
    if len(dm):
        pv = r["payload"][dm].reshape(len(dm), -1)[
            :, :8].copy().view("<f4")
        dep_nconn, dep_bytes = pv[:, 0].copy(), pv[:, 1].copy()
    else:
        dep_nconn = dep_bytes = np.empty(0, np.float32)
    Ld = size

    # ---- residuals + unknown kinds (forward compat inside the subtype)
    resid = float(r["errb"][kinds == wire.DK_RESID].astype(
        np.float64).sum())
    known = np.isin(kinds, (wire.DK_SVC_CTR, wire.DK_SVC_HIST,
                            wire.DK_SVC_HLL, wire.DK_GLOB_HLL,
                            wire.DK_SVC_TD, wire.DK_FLOW, wire.DK_DEP,
                            wire.DK_RESID))
    n_unknown = int((~known).sum())

    # ---- unique svc keys across the svc-referencing families (the
    # one-upsert section; host attribution from the first mention)
    svcm = np.isin(kinds, (wire.DK_SVC_CTR, wire.DK_SVC_HIST,
                           wire.DK_SVC_HLL, wire.DK_SVC_TD))
    k64 = ((r["key_hi"][svcm].astype(np.uint64) << np.uint64(32))
           | r["key_lo"][svcm].astype(np.uint64))
    uk, first = np.unique(k64, return_index=True)
    uhost = r["host_id"][svcm][first].astype(np.int32)
    Lk = size

    if stats is not None:
        fills = (len(crows) + len(hb) + len(sr) + len(gr) + len(td_v)
                 + len(fl_v) + len(dm))
        stats.bump("preagg_lanes", fills)
        if len(crows):
            stats.bump("preagg_source_conn",
                       int(ctr_vals[:, 4].astype(np.float64).sum()))
            stats.bump("preagg_source_resp",
                       int(ctr_vals[:, 5].astype(np.float64).sum()))
        if oob:
            stats.bump("preagg_oob_items", oob)
        if n_unknown:
            stats.bump("preagg_unknown_kinds", n_unknown)

    u32 = np.uint32
    return DeltaBatch(
        svc_hi=_delta_pad((uk >> np.uint64(32)).astype(u32), Lk, u32),
        svc_lo=_delta_pad(uk.astype(u32), Lk, u32),
        svc_host=_delta_pad(uhost, Lk, np.int32),
        svc_valid=_delta_mask(len(uk), Lk),
        ctr_hi=ctr[0], ctr_lo=ctr[1], ctr_vals=ctr[2], ctr_valid=ctr[3],
        hist_hi=_delta_pad(hh, Lh, u32),
        hist_lo=_delta_pad(hl, Lh, u32),
        hist_bucket=_delta_pad(hb.astype(np.int32), Lh, np.int32),
        hist_w=_delta_pad(hw, Lh, np.float32),
        hist_valid=_delta_mask(len(hb), Lh),
        shll_hi=_delta_pad(sh, Lh, u32),
        shll_lo=_delta_pad(sl, Lh, u32),
        shll_reg=_delta_pad(sr.astype(np.int32), Lh, np.int32),
        shll_rank=_delta_pad(srk.astype(np.int32), Lh, np.int32),
        shll_valid=_delta_mask(len(sr), Lh),
        ghll_reg=_delta_pad(gr.astype(np.int32), Lh, np.int32),
        ghll_rank=_delta_pad(grk.astype(np.int32), Lh, np.int32),
        ghll_valid=_delta_mask(len(gr), Lh),
        td_hi=_delta_pad(td_hi, Lt, u32),
        td_lo=_delta_pad(td_lo, Lt, u32),
        td_val=_delta_pad(td_v.astype(np.float32), Lt, np.float32),
        td_valid=_delta_mask(len(td_v), Lt),
        flow_hi=_delta_pad(fl_hi, Lf, u32),
        flow_lo=_delta_pad(fl_lo, Lf, u32),
        flow_val=_delta_pad(fl_v, Lf, np.float32),
        flow_valid=_delta_mask(len(fl_v), Lf),
        dep_cli_hi=_delta_pad(r["aux_hi"][dm], Ld, u32),
        dep_cli_lo=_delta_pad(r["aux_lo"][dm], Ld, u32),
        dep_cli_svc=_delta_pad((r["flags"][dm] & 1).astype(bool), Ld,
                               bool),
        dep_ser_hi=_delta_pad(r["key_hi"][dm], Ld, u32),
        dep_ser_lo=_delta_pad(r["key_lo"][dm], Ld, u32),
        dep_nconn=_delta_pad(dep_nconn, Ld, np.float32),
        dep_bytes=_delta_pad(dep_bytes, Ld, np.float32),
        dep_valid=_delta_mask(len(dm), Ld),
        evicted_add=np.array([resid], np.float32),
    )

def take_raw_chunks(lst: list, want: int) -> tuple[list, int]:
    """Pop up to ``want`` records off a raw-record-array backlog as a
    list of array views (no copy, no concatenation)."""
    out, got = [], 0
    while lst and got < want:
        a = lst[0]
        take = min(len(a), want - got)
        if take == len(a):
            lst.pop(0)
        else:
            lst[0] = a[take:]
            a = a[:take]
        out.append(a)
        got += take
    return out, got


def _concat_chunks(chunks: list, dtype) -> np.ndarray:
    if not chunks:
        return np.empty(0, dtype)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


# staging-slab column dtypes: the u32 columns in their int64 carrier,
# so a decode widens in place and the copy to the device is the column
# as the fold consumes it
_CONN_COL_DTYPES = dict(
    svc_hi=np.int64, svc_lo=np.int64, flow_hi=np.int64, flow_lo=np.int64,
    cli_hi=np.int64, cli_lo=np.int64, cli_task_hi=np.int64,
    cli_task_lo=np.int64, cli_rel_hi=np.int64, cli_rel_lo=np.int64,
    bytes_sent=np.float32, bytes_rcvd=np.float32, duration_us=np.float32,
    host_id=np.int32, is_close=np.bool_, is_accept=np.bool_,
    valid=np.bool_)
_RESP_COL_DTYPES = dict(svc_hi=np.int64, svc_lo=np.int64,
                        resp_us=np.float32, host_id=np.int32,
                        valid=np.bool_)
_TORCH_DTYPE = {np.int64: torch.int64, np.int32: torch.int32,
                np.float32: torch.float32, np.bool_: torch.bool}


def _alloc_cols(dtypes: dict, size: int, pin: bool) -> dict:
    if not pin:
        return {k: np.zeros(size, dt) for k, dt in dtypes.items()}
    # page-locked host memory, written through numpy views (the array
    # keeps its tensor alive): copies out of it run asynchronously
    return {k: torch.zeros(size, dtype=_TORCH_DTYPE[dt],
                           pin_memory=True).numpy()
            for k, dt in dtypes.items()}


def alloc_conn_cols(size: int, pin: bool = False) -> dict:
    """Zeroed flat ConnBatch columns (``valid`` included): one buffer of
    the runtime's double-buffered staging slabs. ``pin`` allocates them
    in page-locked memory (for CUDA)."""
    return _alloc_cols(_CONN_COL_DTYPES, size, pin)


def alloc_resp_cols(size: int, pin: bool = False) -> dict:
    """Zeroed flat RespBatch columns: the resp half of a staging-slab
    buffer (see :func:`alloc_conn_cols`)."""
    return _alloc_cols(_RESP_COL_DTYPES, size, pin)


def _reuse_cols(cols: dict, n: int, clear_to: int) -> None:
    """Reset a reused staging buffer to the all-zero padding of a fresh
    one: lanes ``[n, clear_to)`` may hold a previous, larger fill."""
    if clear_to > n:
        for a in cols.values():
            a[n:clear_to] = 0


def _fill_cols(cols: dict, out: dict, n: int, clear_to: int) -> dict:
    _reuse_cols(out, n, clear_to)
    for k, v in cols.items():
        out[k][:n] = v                # u32 widens in place
    out["valid"][:n] = True
    return out


def _batch_dtypes(dtypes: dict) -> dict:
    """Staging dtypes with the id columns as the batch builders' uint32
    (a fresh native batch has the numpy builders' columns)."""
    return {k: (np.uint32 if dt is np.int64 else dt)
            for k, dt in dtypes.items()}


def _native_cols(chunks: list, size: int, out, clear_to: int,
                 dtypes: dict, decode_into) -> dict:
    """Decode each chunk straight into the column buffers at its lane
    offset: ``out`` (a staging buffer, reused, lanes ``[n, clear_to)``
    re-zeroed) or fresh uint32-id columns."""
    n = sum(len(c) for c in chunks)
    if n > size:
        raise ValueError(
            f"{n} records exceed batch size {size}; split upstream")
    if out is None:
        cols = _alloc_cols(_batch_dtypes(dtypes), size, False)
    else:
        cols = out
        _reuse_cols(cols, n, clear_to)
    off = 0
    for c in chunks:
        if len(c):
            decode_into(c, cols, off)
            off += len(c)
    cols["valid"][:n] = True
    return cols


def conn_batch_parts(chunks: list, size: int, out=None,
                     clear_to: int = 0, stats=None,
                     native: bool = True) -> ConnBatch:
    """A list of raw TCP_CONN chunks (total ≤ size) → one flat padded
    ConnBatch. Native: each chunk decodes straight into the column
    buffers at its lane offset (no concatenate). ``out``: a column dict
    of :func:`alloc_conn_cols`, reused across dispatches, decoded into
    in place with lanes ``[n, clear_to)`` re-zeroed — the same columns
    as a fresh batch. ``native=False``: the numpy builders."""
    _count_path(stats, native, sum(len(c) for c in chunks))
    if native:
        return ConnBatch(**_native_cols(chunks, size, out, clear_to,
                                        _CONN_COL_DTYPES,
                                        nat.decode_conn_into))
    recs = _concat_chunks(chunks, wire.TCP_CONN_DT)
    if out is None:
        return conn_batch(recs, size)
    n = _check_fit(recs, size)
    return ConnBatch(**_fill_cols(_conn_cols(recs), out, n, clear_to))


def _decode_resp_into(recs, cols: dict, off: int) -> None:
    nat.decode_resp_into(recs, cols["svc_hi"], cols["svc_lo"],
                         cols["resp_us"], cols["host_id"], off)


def resp_batch_parts(chunks: list, size: int, out=None,
                     clear_to: int = 0, stats=None,
                     native: bool = True) -> RespBatch:
    """A list of raw RESP_SAMPLE chunks (total ≤ size) → one flat padded
    RespBatch (see :func:`conn_batch_parts`; ``out`` is an
    :func:`alloc_resp_cols` dict)."""
    _count_path(stats, native, sum(len(c) for c in chunks))
    if native:
        return RespBatch(**_native_cols(chunks, size, out, clear_to,
                                        _RESP_COL_DTYPES,
                                        _decode_resp_into))
    recs = _concat_chunks(chunks, wire.RESP_SAMPLE_DT)
    if out is None:
        return resp_batch(recs, size)
    n = _check_fit(recs, size)
    return RespBatch(**_fill_cols(_resp_cols(recs), out, n, clear_to))


def conn_slab(recs, k: int, b: int, out=None, clear_to: int = 0,
              stats=None, native: bool = True) -> ConnBatch:
    """TCP_CONN records (n ≤ k·b; an array or a list of chunk arrays)
    → ConnBatch with ``(k, b)`` stacked columns: one flat decode and a
    reshape. Record i lands in flattened lane i, the padding at the
    tail (the fold reads lanes only through ``valid``). ``out`` /
    ``clear_to``: decode into a staging buffer (:func:`conn_batch_parts`).
    """
    chunks = recs if isinstance(recs, list) else [recs]
    cb = conn_batch_parts(chunks, k * b, out=out, clear_to=clear_to,
                          stats=stats, native=native)
    return ConnBatch(*(x.reshape(k, b) for x in cb))


def resp_slab(recs, k: int, b: int, out=None, clear_to: int = 0,
              stats=None, native: bool = True) -> RespBatch:
    """RESP_SAMPLE records (n ≤ k·b; array or chunk list) → RespBatch
    with ``(k, b)`` stacked columns (see :func:`conn_slab`)."""
    chunks = recs if isinstance(recs, list) else [recs]
    rb = resp_batch_parts(chunks, k * b, out=out, clear_to=clear_to,
                          stats=stats, native=native)
    return RespBatch(*(x.reshape(k, b) for x in rb))


def drain_chunks(recs: dict, conn_batch: int, resp_batch: int,
                 listener_batch: int):
    """Drained records-by-subtype → a fold plan of lane-sized chunks,
    yielding ``(kind, *chunks)`` in the reference's order: conn/resp
    pairs, listener, host, task, cpumem, trace, listener_info,
    host_info, cgroup, mount, netif, ping, delta, agent_stats, names."""
    conn = recs.get(wire.NOTIFY_TCP_CONN)
    resp = recs.get(wire.NOTIFY_RESP_SAMPLE)
    nc = 0 if conn is None else len(conn)
    nr = 0 if resp is None else len(resp)
    npair = max(-(-nc // conn_batch), -(-nr // resp_batch)) \
        if (nc or nr) else 0
    for i in range(npair):
        cchunk = conn[i * conn_batch:(i + 1) * conn_batch] if nc \
            else np.empty(0, wire.TCP_CONN_DT)
        rchunk = resp[i * resp_batch:(i + 1) * resp_batch] if nr \
            else np.empty(0, wire.RESP_SAMPLE_DT)
        yield ("connresp", cchunk, rchunk)
    chunked = ((wire.NOTIFY_LISTENER_STATE, "listener", listener_batch),
               (wire.NOTIFY_HOST_STATE, "host", wire.MAX_HOSTS_PER_BATCH),
               (wire.NOTIFY_AGGR_TASK_STATE, "task",
                wire.MAX_TASKS_PER_BATCH),
               (wire.NOTIFY_CPU_MEM_STATE, "cpumem",
                wire.MAX_CPUMEM_PER_BATCH),
               (wire.NOTIFY_REQ_TRACE, "trace", wire.MAX_TRACE_PER_BATCH))
    for sub, kind, lanes in chunked:
        r = recs.get(sub)
        if r is not None:
            for i in range(0, len(r), lanes):
                yield (kind, r[i:i + lanes])
    for sub, kind in ((wire.NOTIFY_LISTENER_INFO, "listener_info"),
                      (wire.NOTIFY_HOST_INFO, "host_info"),
                      (wire.NOTIFY_CGROUP_STATE, "cgroup"),
                      (wire.NOTIFY_MOUNT_STATE, "mount"),
                      (wire.NOTIFY_NETIF_STATE, "netif")):
        r = recs.get(sub)
        if r is not None:
            yield (kind, r)
    png = recs.get(wire.NOTIFY_TASK_PING)
    if png is not None:
        for i in range(0, len(png), wire.MAX_PINGS_PER_BATCH):
            yield ("ping", png[i:i + wire.MAX_PINGS_PER_BATCH])
    dl = recs.get(wire.NOTIFY_SKETCH_DELTA)
    if dl is not None:
        for i in range(0, len(dl), DELTA_LANES_DEFAULT):
            yield ("delta", dl[i:i + DELTA_LANES_DEFAULT])
    ast = recs.get(wire.NOTIFY_AGENT_STATS)
    if ast is not None:
        yield ("agent_stats", ast)
    nm = recs.get(wire.NOTIFY_NAME_INTERN)
    if nm is not None:
        yield ("names", nm)


def resp_from_trace(recs: np.ndarray) -> np.ndarray:
    """REQ_TRACE records → RESP_SAMPLE records (the trace→resp bridge):
    each parsed transaction's measured latency joins its service's
    response stream."""
    out = np.zeros(len(recs), wire.RESP_SAMPLE_DT)
    out["glob_id"] = recs["svc_glob_id"]
    out["resp_usec"] = recs["resp_usec"]
    out["host_id"] = recs["host_id"]
    return out


def _col_to_tensor(a: np.ndarray, device, staged: bool) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.astype(np.int64)          # the u32 carrier
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not staged:
        return t.to(device)
    # a staging-slab buffer the host decodes into again two dispatches
    # on: an asynchronous copy on CUDA (the caller records an event and
    # waits on it before that decode), a copy of its own on the CPU
    return t.to(device, non_blocking=True) if device.type == "cuda" \
        else t.clone()


def to_device(batches, device=None, staged: bool = False):
    """One batch (any batch NamedTuple of this module, ``(B, ...)``
    columns) or a list of K batches → the same NamedTuple of tensors on
    ``device``, ``(B,)`` or stacked ``(K, B)``. Defaults to CUDA; raises
    without a GPU unless ``device="cpu"``. ``staged``: the batch views a
    staging-slab buffer of :func:`alloc_conn_cols` /
    :func:`alloc_resp_cols` (copied without blocking on CUDA)."""
    dev = resolve(device)
    if isinstance(batches, tuple):
        return type(batches)(*(_col_to_tensor(c, dev, staged)
                               for c in batches))
    cls = type(batches[0])
    return cls(*(_col_to_tensor(np.stack(cols), dev, False)
                 for cols in zip(*batches)))
