"""Query API: QUERY_OPTIONS-style requests over live engine state.

Counterpart of ``gyeeta_tpu/query/api.py``: a request is device
readbacks (``query/readback.py``, on the state's device) + one columnar
criteria mask + host-side JSON row assembly. Request shape (a
JSON-compatible dict)::

    {"subsys": "svcstate", "filter": "{ svcstate.state in 'Bad','Severe' }",
     "columns": ["svcid", "p95resp5s", "state"],    # optional projection
     "sortcol": "p95resp5s", "sortdesc": true,      # optional sort
     "maxrecs": 100}

The port serves 43 subsystems (:data:`SERVED`): those whose columns
come from ``AggState``, the ``DepGraph`` or the host-side listener
registry here, and those the runtime answers from its own providers
(its registries, the alert manager, the notification log); plus the
process-local ``selfstats`` and ``metrics`` (:func:`local_response`).
The sharded runtime (``parallel/shardedrt.py``) also serves
``shardlist``, one row a shard; a single runtime answers it as the
reference's does, with ``ValueError("unknown subsystem")``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gyeeta_tpu_torch.engine.aggstate import AggState, EngineCfg
from gyeeta_tpu_torch.ingest import decode as D, wire
from gyeeta_tpu_torch.obs import prom
from gyeeta_tpu_torch.query import criteria, fieldmaps, readback
from gyeeta_tpu_torch.query.lazycols import LazyCols, rows_of
from gyeeta_tpu_torch.semantic import hoststate, states as S
from gyeeta_tpu_torch.utils.selfstats import selfstats_response


class QueryOptions(NamedTuple):
    subsys: str
    filter: Optional[str] = None
    columns: Optional[tuple] = None
    sortcol: Optional[str] = None
    sortdesc: bool = True
    maxrecs: int = 1000
    aggr: Optional[tuple] = None       # e.g. ("avg(qps5s)", "count(*)")
    groupby: Optional[tuple] = None    # e.g. ("hostid",)

    @classmethod
    def from_json(cls, req: dict) -> "QueryOptions":
        known = {"subsys", "filter", "columns", "sortcol", "sortdesc",
                 "maxrecs", "aggr", "groupby"}
        unknown = set(req) - known
        if unknown:
            raise ValueError(f"unknown query options: {sorted(unknown)}")
        if "subsys" not in req:
            raise ValueError("query needs 'subsys'")
        cols = req.get("columns")
        ag = req.get("aggr")
        gb = req.get("groupby")
        if isinstance(ag, str):
            ag = [ag]
        if isinstance(gb, str):
            gb = [gb]
        return cls(
            subsys=req["subsys"], filter=req.get("filter"),
            columns=tuple(cols) if cols else None,
            sortcol=req.get("sortcol"),
            sortdesc=bool(req.get("sortdesc", True)),
            maxrecs=int(req.get("maxrecs", 1000)),
            aggr=tuple(ag) if ag else None,
            groupby=tuple(gb) if gb else None,
        )


def _hex_id(hi, lo):
    gid = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return np.array([format(int(g), "016x") for g in gid], object)


def _names_of(names, kind, hi, lo):
    """Resolve interned 64-bit ids to names (hex-id fallback)."""
    if names is None:
        return _hex_id(hi, lo)
    ids = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return names.resolve_array(kind, ids)


def _pad_idx(idx: np.ndarray, cap: int, device):
    """Row indices → (padded index tensor on ``device``, true length):
    the row-sliced loaders gather on the state's device. Padding to the
    next power of two (at least 8, at most ``cap``) keeps the gathers to
    log2(capacity) shapes, as the reference's jit shapes are."""
    n = len(idx)
    p = 8
    while p < n:
        p <<= 1
    p = min(p, cap)
    out = np.zeros(p, np.int64)
    out[:n] = idx
    return torch.from_numpy(out).to(device), n


_QCOLS_OF_LEVEL = {
    -1: (("resp5s", "resp5s_us"), ("p95resp5s", "p95resp5s_us"),
         ("p99resp5s", "p99resp5s_us")),
    0: (("p95resp5m", "p95resp5m_us"),),
    1: (("p50resp5d", "p50resp5d_us"), ("p95resp5d", "p95resp5d_us")),
}


def svc_columns(cfg: EngineCfg, st: AggState, names=None):
    """svcstate columns (reference JSON names' units: msec) as
    :class:`~gyeeta_tpu_torch.query.lazycols.LazyCols`: the gauge panel
    is eager; the per-window latency quantiles, query volume, HLL client
    counts and string columns load group at a time when a filter or sort
    names them, and over just the result rows for a projection."""
    base = readback.svcstate_base(cfg, st)
    dev = st.tbl.key_hi.device
    g = base["stats"]
    hi, lo = base["glob_id_hi"], base["glob_id_lo"]
    eager = {
        "nconns": g[:, D.STAT_NCONNS],
        "nactive": g[:, D.STAT_NCONNS_ACTIVE],
        "nprocs": g[:, D.STAT_NTASKS],
        "kbin15s": g[:, D.STAT_KB_IN],
        "kbout15s": g[:, D.STAT_KB_OUT],
        "sererr": g[:, D.STAT_SER_ERRORS],
        "clierr": g[:, D.STAT_CLI_ERRORS],
        "delayus": g[:, D.STAT_TASKS_DELAY_US],
        "cpudelus": g[:, D.STAT_TASKS_CPUDELAY_US],
        "iodelus": g[:, D.STAT_TASKS_BLKIODELAY_US],
        "usercpu": g[:, D.STAT_USER_CPU],
        "syscpu": g[:, D.STAT_SYS_CPU],
        "rssmb": g[:, D.STAT_RSS_MB],
        "nissue": g[:, D.STAT_NTASKS_ISSUE],
        "state": base["state"],
        "issue": base["issue"],
        "hostid": base["hostid"],
    }

    def _qcols(level, d):
        return {col: d[src] / 1e3 for col, src in _QCOLS_OF_LEVEL[level]}

    def _qload(level):
        return lambda: _qcols(level,
                              readback.svcstate_qlevel(cfg, st, level))

    def _qrows(level):
        def load(idx):
            pidx, n = _pad_idx(idx, cfg.svc_capacity, dev)
            d = readback.svcstate_qlevel_rows(cfg, st, pidx, level)
            return {k: v[:n] for k, v in _qcols(level, d).items()}
        return load

    def _vol_rows(idx):
        pidx, n = _pad_idx(idx, cfg.svc_capacity, dev)
        d = readback.svcstate_vol_rows(cfg, st, pidx)
        return {k: v[:n] for k, v in d.items()}

    def _cli_rows(idx):
        pidx, n = _pad_idx(idx, cfg.svc_capacity, dev)
        d = readback.svcstate_cli_rows(cfg, st, pidx)
        return {k: v[:n] for k, v in d.items()}

    group_of = {"svcid": "sid", "svcname": "sname",
                "nqry5s": "vol", "qps5s": "vol", "nclients": "cli"}
    load = {
        "sid": lambda: {"svcid": _hex_id(hi, lo)},
        "sname": lambda: {"svcname": _names_of(
            names, wire.NAME_KIND_SVC, hi, lo)},
        "vol": lambda: readback.svcstate_vol(cfg, st),
        "cli": lambda: readback.svcstate_cli(cfg, st),
    }
    load_rows = {
        "sid": lambda idx: {"svcid": _hex_id(hi[idx], lo[idx])},
        "sname": lambda idx: {"svcname": _names_of(
            names, wire.NAME_KIND_SVC, hi[idx], lo[idx])},
        "vol": _vol_rows,
        "cli": _cli_rows,
    }
    for level, pairs in _QCOLS_OF_LEVEL.items():
        key = f"q{level}"
        for col, _src in pairs:
            group_of[col] = key
        load[key] = _qload(level)
        load_rows[key] = _qrows(level)
    return LazyCols(eager, group_of, load, load_rows), base["live"]


# a host is Down after this many base ticks without a report (30 s)
DOWN_AFTER_TICKS = 6


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _live_rows(snap: dict, mask: str) -> dict:
    """A slab readback cut to its live rows, in slab order: the rows a
    query can return, so the host formats ids and names for those only
    (the reference formats every slab row; the JSON is the same)."""
    idx = np.nonzero(snap[mask])[0]
    return {k: v[idx] for k, v in snap.items()}


def host_columns(cfg: EngineCfg, st: AggState, names=None) -> dict:
    panel_t = st.host_panel
    states_t = hoststate.classify_hosts(
        ntask_issue=panel_t[:, D.HOST_NTASKS_ISSUE],
        ntask_severe=panel_t[:, D.HOST_NTASKS_SEVERE],
        nlisten_issue=panel_t[:, D.HOST_NLISTEN_ISSUE],
        nlisten_severe=panel_t[:, D.HOST_NLISTEN_SEVERE],
        cpu_issue=panel_t[:, D.HOST_CPU_ISSUE] > 0,
        mem_issue=panel_t[:, D.HOST_MEM_ISSUE] > 0,
        severe_cpu=panel_t[:, D.HOST_SEVERE_CPU] > 0,
        severe_mem=panel_t[:, D.HOST_SEVERE_MEM] > 0)
    panel = readback.host_snapshot(cfg, st)["panel"]
    last = _np(st.host_last_tick)
    now = int(st.resp_win.tick)
    reported = last >= 0
    down = reported & (now - last > DOWN_AFTER_TICKS)
    states = np.where(down, S.STATE_DOWN, _np(states_t))
    hostids, hostnames = _host_name_cols(panel.shape[0], names)
    cols = {
        "hostid": hostids,
        "hostname": hostnames,
        "nprocissue": panel[:, D.HOST_NTASKS_ISSUE],
        "nprocsevere": panel[:, D.HOST_NTASKS_SEVERE],
        "nproc": panel[:, D.HOST_NTASKS],
        "nlistissue": panel[:, D.HOST_NLISTEN_ISSUE],
        "nlistsevere": panel[:, D.HOST_NLISTEN_SEVERE],
        "nlisten": panel[:, D.HOST_NLISTEN],
        "state": states,
        "cpuissue": panel[:, D.HOST_CPU_ISSUE],
        "memissue": panel[:, D.HOST_MEM_ISSUE],
        "severecpu": panel[:, D.HOST_SEVERE_CPU],
        "severemem": panel[:, D.HOST_SEVERE_MEM],
    }
    return cols, reported


def task_columns(cfg: EngineCfg, st: AggState, names=None,
                 live_only: bool = True) -> dict:
    """taskstate columns (ref MAGGR_TASK / aggrtaskstate): the live rows,
    or with ``live_only=False`` every slab row, as the reference renders
    them (a history shard's panel, which the ``task_cpu`` delta panel
    aligns with row for row)."""
    snap = readback.task_snapshot(cfg, st)
    if live_only:
        snap = _live_rows(snap, "live")
    g = snap["stats"]
    cols = _task_identity_cols(snap, names)
    cols |= {
        "tcpkb": g[:, D.TASK_TCP_KB],
        "tcpconns": g[:, D.TASK_TCP_CONNS],
        "cpu": g[:, D.TASK_CPU_PCT],
        "cpup95": snap["cpu_p95"],
        "rssmb": g[:, D.TASK_RSS_MB],
        "cpudelms": g[:, D.TASK_CPU_DELAY_MS],
        "vmdelms": g[:, D.TASK_VM_DELAY_MS],
        "iodelms": g[:, D.TASK_BLKIO_DELAY_MS],
        "ntasks": g[:, D.TASK_NTASKS],
        "nissue": g[:, D.TASK_NTASKS_ISSUE],
        "forks": g[:, D.TASK_FORKS_SEC],
        "state": snap["state"],
        "issue": snap["issue"],
        "hostid": snap["hostid"],
    }
    return cols, snap["live"]


def flow_columns(cfg: EngineCfg, st: AggState, k: int = 128,
                 names=None) -> dict:
    snap = readback._host(readback.flow_snapshot(cfg, st, k))
    valid = snap["flow_bytes"] > 0
    cols = {
        "flowid": _hex_id(snap["flow_hi"], snap["flow_lo"]),
        "bytes": snap["flow_bytes"],
        "evictedbytes": np.full(len(valid), float(snap["evicted_bytes"])),
    }
    return cols, valid


# rows emitted per topk metric before maxrecs/filters apply
TOPK_PER_METRIC = 64


def heavy_topk_columns(flow_rows, svc=None, trace=None,
                       per_metric: int = TOPK_PER_METRIC):
    """The ``topk`` subsystem's union columns. ``flow_rows``: merged
    heavy flows as ``(id_hex, value, errbound, source)`` tuples,
    heaviest first (``Runtime.heavy_recover``); ``svc``/``trace``: the
    (cols, live) snapshots for the dense rankings (top services by
    conns and by error rate, top APIs by p99). Every row carries its
    error bound; dense rows are exact (0)."""
    metric, rank, ids, names_, value, errb, source = \
        [], [], [], [], [], [], []

    def emit(m, rows):
        for i, (rid, rname, val, eb, src) in enumerate(
                rows[:per_metric]):
            metric.append(m)
            rank.append(float(i + 1))
            ids.append(rid)
            names_.append(rname)
            value.append(float(val))
            errb.append(float(eb))
            source.append(src)

    emit("bytes", [(rid, "", val, eb, src)
                   for rid, val, eb, src in flow_rows])

    def dense(cols, live, valcol, idcol, namecol, valfn=None):
        idx = np.nonzero(np.asarray(live, bool))[0]
        if len(idx) == 0:
            return []
        vals = (valfn(cols, idx) if valfn is not None
                else np.asarray(cols[valcol], np.float64)[idx])
        order = np.argsort(vals, kind="stable")[::-1]
        keep = order[: per_metric]
        keep = keep[vals[keep] > 0]
        got = rows_of(cols, [idcol, namecol], idx[keep])
        rows = [(got[idcol][j], got[namecol][j], vals[keep[j]], 0.0,
                 "dense") for j in range(len(keep))]
        # deterministic rank on tied values: value desc, id asc
        rows.sort(key=lambda r: (-r[2], r[0]))
        return rows

    if svc is not None:
        scols, slive = svc
        emit("conns", dense(scols, slive, "nconns", "svcid", "svcname"))

        def errrate(cols, idx):
            err = np.asarray(cols["sererr"], np.float64)[idx]
            nq = np.asarray(cols["nqry5s"], np.float64)[idx]
            return err / np.maximum(nq, 1.0)

        emit("errrate", dense(scols, slive, None, "svcid", "svcname",
                              valfn=errrate))
    if trace is not None:
        tcols, tlive = trace
        idx = np.nonzero(np.asarray(tlive, bool))[0]
        rows = []
        if len(idx):
            p99 = np.asarray(tcols["p99resp"], np.float64)[idx]
            keep = np.argsort(p99, kind="stable")[::-1][: per_metric]
            keep = keep[p99[keep] > 0]
            got = rows_of(tcols, ["svcid", "svcname", "api"], idx[keep])
            rows = [(got["svcid"][j],
                     f"{got['svcname'][j]}:{got['api'][j]}",
                     p99[keep[j]], 0.0, "dense")
                    for j in range(len(keep))]
            rows.sort(key=lambda r: (-r[2], r[0], r[1]))
        emit("p99resp", rows)

    n = len(metric)
    cols = {
        "metric": _obj_col(metric), "rank": np.asarray(rank, np.float64),
        "id": _obj_col(ids), "name": _obj_col(names_),
        "value": np.asarray(value, np.float64),
        "errbound": np.asarray(errb, np.float64),
        "source": _obj_col(source),
    }
    return cols, np.ones(n, bool)


def _obj_col(vals) -> np.ndarray:
    out = np.empty(len(vals), object)
    out[:] = [str(v) for v in vals]
    return out


def _host_name_cols(n: int, names):
    """(hostids, hostnames) shared by every host-axis subsystem."""
    hostids = np.arange(n)
    if names is None:
        hostnames = np.array([str(h) for h in hostids], object)
    else:
        hostnames = np.array(
            [names.lookup(wire.NAME_KIND_HOST, h) or str(h)
             for h in hostids], object)
    return hostids, hostnames


def hostlist_columns(last: np.ndarray, tick: int, names=None):
    """hostlist (ref parthalist): hosts that have ever reported, with
    liveness from their last-report tick (``last``, per host) as of
    ``tick``."""
    seen = np.nonzero(last >= 0)[0]
    age = tick - last[seen]
    _, hostnames = _host_name_cols(len(last), names)
    cols = {
        "hostid": seen.astype(np.float64),
        "hostname": np.asarray(hostnames, object)[seen],
        "up": age <= DOWN_AFTER_TICKS,
        "lastseen": age.astype(np.float64),
    }
    return cols, np.ones(len(seen), bool)


def cpumem_columns(cfg: EngineCfg, st: AggState, names=None) -> dict:
    """cpumem: raw 2s gauges + server-side classification."""
    vals = _np(st.host_cm)
    reported = _np(st.cm_last_tick) >= 0
    hostids, hostnames = _host_name_cols(vals.shape[0], names)
    cols = {
        "hostid": hostids,
        "hostname": hostnames,
        "cpu": vals[:, D.CM_CPU_PCT],
        "usercpu": vals[:, D.CM_USERCPU_PCT],
        "syscpu": vals[:, D.CM_SYSCPU_PCT],
        "iowait": vals[:, D.CM_IOWAIT_PCT],
        "corecpu": vals[:, D.CM_MAX_CORE_CPU_PCT],
        "cs": vals[:, D.CM_CS_SEC],
        "forks": vals[:, D.CM_FORKS_SEC],
        "runq": vals[:, D.CM_PROCS_RUNNING],
        "rsspct": vals[:, D.CM_RSS_PCT],
        "commitpct": vals[:, D.CM_COMMIT_PCT],
        "swapfreepct": vals[:, D.CM_SWAP_FREE_PCT],
        "pginout": vals[:, D.CM_PG_INOUT_SEC],
        "swapinout": vals[:, D.CM_SWAP_INOUT_SEC],
        "allocstall": vals[:, D.CM_ALLOCSTALL_SEC],
        "oom": vals[:, D.CM_OOM_KILLS],
        "cpustate": _np(st.cm_cpu_state),
        "cpuissue": _np(st.cm_cpu_issue),
        "memstate": _np(st.cm_mem_state),
        "memissue": _np(st.cm_mem_issue),
    }
    return cols, reported


def trace_columns(cfg: EngineCfg, st: AggState, names=None) -> dict:
    """tracereq: per-(service, API) latency aggregates."""
    from gyeeta_tpu_torch.engine import step

    snap = readback.trace_snapshot(cfg, st)
    ctr = snap["ctr"]
    cols = {
        "svcid": _hex_id(snap["svc_hi"], snap["svc_lo"]),
        "svcname": _names_of(names, wire.NAME_KIND_SVC,
                             snap["svc_hi"], snap["svc_lo"]),
        "api": _names_of(names, wire.NAME_KIND_API,
                         snap["api_hi"], snap["api_lo"]),
        "proto": snap["proto"],
        "nreq": ctr[:, step.APIC_NREQ],
        "nerr": ctr[:, step.APIC_NERR],
        "bytesin": ctr[:, step.APIC_BYTES_IN],
        "bytesout": ctr[:, step.APIC_BYTES_OUT],
        "p50resp": snap["p50_us"] / 1e3,
        "p95resp": snap["p95_us"] / 1e3,
        "p99resp": snap["p99_us"] / 1e3,
        "hostid": snap["hostid"],
    }
    return cols, snap["live"]


def cluster_columns(cfg: EngineCfg, st: AggState, names=None) -> dict:
    """clusterstate: hosts per state and the issue ratio, one row (the
    rollup runs on the host columns, in numpy, as the reference's)."""
    return cluster_from_hosts(*host_columns(cfg, st))


def cluster_from_hosts(hcols, reported):
    """hoststate columns and their reported mask → the clusterstate row
    (shared with the sharded runtime, which merges hosts first)."""
    reported = np.asarray(reported, bool)
    state = np.asarray(hcols["state"])
    counts = [int((reported & (state == s)).sum()) for s in range(6)]
    n_up = int(reported.sum())
    c = {"nhosts": n_up, "nidle": counts[S.STATE_IDLE],
         "ngood": counts[S.STATE_GOOD], "nok": counts[S.STATE_OK],
         "nbad": counts[S.STATE_BAD], "nsevere": counts[S.STATE_SEVERE],
         "ndown": counts[S.STATE_DOWN],
         "issue_frac": (counts[S.STATE_BAD] + counts[S.STATE_SEVERE])
         / max(n_up, 1)}
    cols = {k: np.array([float(v)]) for k, v in c.items()}
    return cols, np.ones(1, bool)


def task_comm_names_from(names, key, comm, live, task_hi, task_lo):
    """Resolve process-group ids → comm names given task-slab arrays
    (key/comm as u64, live mask)."""
    comm_of = dict(zip(key[live].tolist(), comm[live].tolist()))
    want = ((task_hi.astype(np.uint64) << np.uint64(32))
            | task_lo.astype(np.uint64))
    comm_ids = np.array([comm_of.get(int(t), 0) for t in want], np.uint64)
    if names is None:
        return _hex_id(task_hi, task_lo)
    resolved = names.resolve_array(wire.NAME_KIND_COMM, comm_ids)
    fallback = _hex_id(task_hi, task_lo)
    return np.where(comm_ids != 0, resolved, fallback)


def _task_slab_arrays(st: AggState):
    u64 = lambda t: _np(t).astype(np.uint64)  # noqa: E731
    key = (u64(st.task_tbl.key_hi) << np.uint64(32)) \
        | u64(st.task_tbl.key_lo)
    comm = (u64(st.task_comm_hi) << np.uint64(32)) | u64(st.task_comm_lo)
    live = _np((st.task_tbl.key_hi != 0xFFFFFFFF)
               | (st.task_tbl.key_lo != 0xFFFFFFFF))
    return key, comm, live


def _task_comm_names(st: AggState, names, task_hi, task_lo):
    """Resolve process-group ids → comm names via the live task slab."""
    key, comm, live = _task_slab_arrays(st)
    return task_comm_names_from(names, key, comm, live, task_hi, task_lo)


def dep_columns(cfg: EngineCfg, st: AggState, names=None,
                dep=None) -> dict:
    """svcdependency: one row per (caller → service) edge."""
    if dep is None:
        raise ValueError("svcdependency needs a dependency graph "
                         "(runtime not configured with one)")
    snap = _live_rows(readback.dep_edges_snapshot(dep), "e_live")
    cli_svc = snap["e_cli_svc"]
    # caller name: listener name for svc→svc edges, comm (via the task
    # slab) for task→svc edges
    svc_names = _names_of(names, wire.NAME_KIND_SVC,
                          snap["e_cli_hi"], snap["e_cli_lo"])
    task_names = _task_comm_names(st, names, snap["e_cli_hi"],
                                  snap["e_cli_lo"])
    cols = {
        "cliid": _hex_id(snap["e_cli_hi"], snap["e_cli_lo"]),
        "cliname": np.where(cli_svc, svc_names, task_names),
        "clisvc": cli_svc,
        "serid": _hex_id(snap["e_ser_hi"], snap["e_ser_lo"]),
        "sername": _names_of(names, wire.NAME_KIND_SVC,
                             snap["e_ser_hi"], snap["e_ser_lo"]),
        "nconn": snap["e_nconn"],
        "bytes": snap["e_bytes"],
    }
    return cols, snap["e_live"]


def mesh_columns(cfg: EngineCfg, st: AggState, names=None,
                 dep=None) -> dict:
    """svcmesh: one row per service in the dependency mesh, labelled
    with its coalesced cluster."""
    if dep is None:
        raise ValueError("svcmesh needs a dependency graph")
    snap = _live_rows(readback.dep_mesh_snapshot(dep), "n_mask")
    cols = {
        "svcid": _hex_id(snap["n_hi"], snap["n_lo"]),
        "svcname": _names_of(names, wire.NAME_KIND_SVC,
                             snap["n_hi"], snap["n_lo"]),
        "clusterid": snap["n_label"],
        "clustersize": snap["n_size"],
    }
    return cols, snap["n_mask"]


def _group_edges(snap: dict, end: str):
    """Group live dep edges by one endpoint (``cli`` or ``ser``) →
    (hi, lo, inv, segsum, live_idx)."""
    live = np.nonzero(snap["e_live"])[0]
    ids64 = ((snap[f"e_{end}_hi"][live].astype(np.uint64) << np.uint64(32))
             | snap[f"e_{end}_lo"][live].astype(np.uint64))
    ids, inv = np.unique(ids64, return_inverse=True)
    n = len(ids)

    def segsum(vals):
        out = np.zeros(n, np.float64)
        np.add.at(out, inv, vals.astype(np.float64))
        return out

    hi = (ids >> np.uint64(32)).astype(np.uint32)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo, inv, segsum, live


def activeconn_from_edges(snap: dict, names=None):
    """Group a dep-edge column snapshot by server service."""
    hi, lo, inv, segsum, live = _group_edges(snap, "ser")
    cols = {
        "svcid": _hex_id(hi, lo),
        "svcname": _names_of(names, wire.NAME_KIND_SVC, hi, lo),
        "nclients": segsum(np.ones(len(live))),
        "nconn": segsum(snap["e_nconn"][live]),
        "bytes": segsum(snap["e_bytes"][live]),
        "nsvccli": segsum(snap["e_cli_svc"][live]),
    }
    return cols, np.ones(len(hi), bool)


def activeconn_columns(cfg: EngineCfg, st: AggState, names=None,
                       dep=None) -> dict:
    """activeconn: per-service caller rollup of the dep edges."""
    if dep is None:
        raise ValueError("activeconn needs a dependency graph")
    return activeconn_from_edges(readback.dep_edges_snapshot(dep), names)


def clientconn_from_edges(snap: dict, names=None, task_names_fn=None):
    """Group dep edges by caller (what does this process group or
    service call). ``task_names_fn(hi, lo) -> names`` resolves
    task-group callers."""
    hi, lo, inv, segsum, live = _group_edges(snap, "cli")
    is_svc = np.zeros(len(hi), bool)
    np.maximum.at(is_svc, inv, snap["e_cli_svc"][live].astype(bool))
    svc_names = _names_of(names, wire.NAME_KIND_SVC, hi, lo)
    task_names = (task_names_fn(hi, lo) if task_names_fn is not None
                  else _hex_id(hi, lo))
    cols = {
        "cliid": _hex_id(hi, lo),
        "cliname": np.where(is_svc, svc_names, task_names),
        "clisvc": is_svc,
        "nservers": segsum(np.ones(len(live))),
        "nconn": segsum(snap["e_nconn"][live]),
        "bytes": segsum(snap["e_bytes"][live]),
    }
    return cols, np.ones(len(hi), bool)


def clientconn_columns(cfg: EngineCfg, st: AggState, names=None,
                       dep=None) -> dict:
    if dep is None:
        raise ValueError("clientconn needs a dependency graph")
    return clientconn_from_edges(
        readback.dep_edges_snapshot(dep), names,
        lambda hi, lo: _task_comm_names(st, names, hi, lo))


def svcsumm_from_svc(cols, live, names=None):
    """Group svcstate columns by host → svcsumm columns."""
    idx = np.nonzero(live)[0]
    hosts = np.asarray(cols["hostid"])[idx].astype(np.int64)
    ids, inv = np.unique(hosts, return_inverse=True)
    n = len(ids)

    def segsum(vals):
        out = np.zeros(n, np.float64)
        np.add.at(out, inv, np.asarray(vals, np.float64))
        return out

    state = np.asarray(cols["state"])[idx]
    if names is not None:
        hostnames = names.resolve_array(
            wire.NAME_KIND_HOST, ids.astype(np.uint64))
    else:
        hostnames = np.array([str(i) for i in ids], object)
    out = {
        "hostid": ids.astype(np.float64),
        "hostname": hostnames,
        "nsvc": segsum(np.ones(len(idx))),
        "nidle": segsum(state == S.STATE_IDLE),
        "ngood": segsum(state == S.STATE_GOOD),
        "nok": segsum(state == S.STATE_OK),
        "nbad": segsum(state == S.STATE_BAD),
        "nsevere": segsum(state == S.STATE_SEVERE),
        "ndown": segsum(state == S.STATE_DOWN),
        "nissue": segsum(state >= S.STATE_BAD),
        "totqps": segsum(np.asarray(cols["qps5s"])[idx]),
        "totactive": segsum(np.asarray(cols["nactive"])[idx]),
        "totkbin": segsum(np.asarray(cols["kbin15s"])[idx]),
        "totkbout": segsum(np.asarray(cols["kbout15s"])[idx]),
    }
    return out, np.ones(n, bool)


def svcsumm_columns(cfg: EngineCfg, st: AggState, names=None):
    """svcsumm: per-host service-state summary."""
    cols, live = svc_columns(cfg, st, names=names)
    return svcsumm_from_svc(cols, live, names)


def svcinfo_columns(cfg: EngineCfg, st: AggState, names=None,
                    svcreg=None):
    """svcinfo: the host-side listener-metadata registry."""
    if svcreg is None:
        raise ValueError("svcinfo needs the listener-info registry")
    return svcreg.columns(names)


_EXT_JOIN_KEYS = (("ip", ""), ("port", 0.0), ("comm", ""),
                  ("cmdline", ""), ("pid", 0.0), ("tstart", 0.0))


def info_join(cols, live, info_cols, idcol="svcid",
              keys=_EXT_JOIN_KEYS):
    """Left-join svcinfo metadata columns onto any column set whose
    ``idcol`` holds service glob-id hex strings (the "extended"
    subsystems: state ⋈ info). Rows without announced metadata keep
    defaults."""
    n = len(cols[idcol])
    # a lazy column set materializes everything: ext views are
    # full-width joins
    joined = cols.full() if isinstance(cols, LazyCols) else dict(cols)
    out = {}
    for key, default in keys:
        col = np.empty(n, object if isinstance(default, str)
                       else np.float64)
        col[:] = default
        out[key] = col
    if info_cols:
        pos_of = {sid: j for j, sid in enumerate(info_cols["svcid"])}
        for i in np.nonzero(np.asarray(live, bool))[0]:
            j = pos_of.get(joined[idcol][i])
            if j is not None:
                for key, _ in keys:
                    out[key][i] = info_cols[key][j]
    joined.update(out)
    return joined, live


def extsvcstate_columns(cfg: EngineCfg, st: AggState, names=None,
                        svcreg=None):
    """extsvcstate: svcstate ⋈ svcinfo on svcid. State rows without
    announced metadata still appear, with empty info columns."""
    cols, live = svc_columns(cfg, st, names=names)
    info_cols, _ = (svcreg.columns(names) if svcreg is not None
                    else ({}, None))
    return info_join(cols, live, info_cols)


def svcprocmap_columns(cfg: EngineCfg, st: AggState, names=None,
                       svcreg=None):
    """svcprocmap: listener ↔ process-group mapping through the shared
    related_listen_id."""
    tcols, tlive = task_columns(cfg, st, names=names)
    info_cols, _ = (svcreg.columns(names) if svcreg is not None
                    else (None, None))
    return svcprocmap_join(tcols, tlive, info_cols)


def svcprocmap_join(tcols, tlive, info_cols):
    """Join task columns with svcinfo on related_listen_id."""
    rows = {"svcid": [], "svcname": [], "relsvcid": [], "taskid": [],
            "comm": [], "hostid": []}
    if info_cols is not None and len(tcols["taskid"]):
        by_rel: dict[str, list[int]] = {}
        for i in np.nonzero(tlive)[0]:
            by_rel.setdefault(tcols["relsvcid"][i], []).append(i)
        for j, rel in enumerate(info_cols["relsvcid"]):
            for i in by_rel.get(rel, ()):
                rows["svcid"].append(info_cols["svcid"][j])
                rows["svcname"].append(info_cols["svcname"][j])
                rows["relsvcid"].append(rel)
                rows["taskid"].append(tcols["taskid"][i])
                rows["comm"].append(tcols["comm"][i])
                rows["hostid"].append(float(tcols["hostid"][i]))
    n = len(rows["svcid"])
    cols = {}
    for k, vals in rows.items():
        if k == "hostid":
            cols[k] = np.array(vals, np.float64)
        else:
            col = np.empty(n, object)
            col[:] = vals
            cols[k] = col
    return cols, np.ones(n, bool)


def traceuniq_from_trace(tcols, tlive):
    """Group per-(svc, api) trace columns by service → traceuniq."""
    idx = np.nonzero(np.asarray(tlive, bool))[0]
    svc = np.asarray(tcols["svcid"])[idx]
    ids, inv = np.unique(svc, return_inverse=True)
    n = len(ids)

    def segsum(vals):
        out = np.zeros(n, np.float64)
        np.add.at(out, inv, np.asarray(vals, np.float64))
        return out

    name_of = {}
    for j, i in enumerate(idx):
        name_of.setdefault(svc[j], tcols["svcname"][i])
    cols = {
        "svcid": ids.astype(object),
        "svcname": np.array([name_of[s] for s in ids], object),
        "napis": segsum(np.ones(len(idx))),
        "nreq": segsum(np.asarray(tcols["nreq"])[idx]),
        "nerr": segsum(np.asarray(tcols["nerr"])[idx]),
    }
    return cols, np.ones(n, bool)


def _task_identity_cols(snap, names):
    """Identity columns over a task snapshot."""
    return {
        "taskid": _hex_id(snap["key_hi"], snap["key_lo"]),
        "comm": _names_of(names, wire.NAME_KIND_COMM,
                          snap["comm_hi"], snap["comm_lo"]),
        "relsvcid": _hex_id(snap["rel_hi"], snap["rel_lo"]),
    }


def procinfo_columns(cfg: EngineCfg, st: AggState, names=None):
    """procinfo: the static face of the process-group slab (identity,
    placement, service linkage)."""
    snap = _live_rows(readback.task_snapshot(cfg, st), "live")
    rel_ids = ((snap["rel_hi"].astype(np.uint64) << np.uint64(32))
               | snap["rel_lo"].astype(np.uint64))
    if names is not None:
        svcnames = names.resolve_array(wire.NAME_KIND_SVC, rel_ids,
                                       fallback_hex=False)
    else:
        svcnames = np.full(len(rel_ids), "", object)
    cols = _task_identity_cols(snap, names)
    cols.update({
        "svcname": np.where(rel_ids == 0, "", svcnames),
        "ntasks": snap["stats"][:, D.TASK_NTASKS],
        "hostid": snap["hostid"],
    })
    return cols, snap["live"]


_COLUMNS_OF = {
    fieldmaps.SUBSYS_SVCSTATE: svc_columns,
    fieldmaps.SUBSYS_HOSTSTATE: host_columns,
    fieldmaps.SUBSYS_CLUSTERSTATE: cluster_columns,
    fieldmaps.SUBSYS_FLOWSTATE: flow_columns,
    fieldmaps.SUBSYS_TASKSTATE: task_columns,
    fieldmaps.SUBSYS_TOPCPU: task_columns,
    fieldmaps.SUBSYS_TOPPGCPU: task_columns,
    fieldmaps.SUBSYS_TOPRSS: task_columns,
    fieldmaps.SUBSYS_TOPDELAY: task_columns,
    fieldmaps.SUBSYS_TOPFORK: task_columns,
    fieldmaps.SUBSYS_CPUMEM: cpumem_columns,
    fieldmaps.SUBSYS_TRACEREQ: trace_columns,
    fieldmaps.SUBSYS_SVCSUMM: svcsumm_columns,
    fieldmaps.SUBSYS_PROCINFO: procinfo_columns,
}

# subsystems whose columns come from the dependency graph, not AggState
_DEP_COLUMNS_OF = {
    fieldmaps.SUBSYS_SVCDEP: dep_columns,
    fieldmaps.SUBSYS_SVCMESH: mesh_columns,
    fieldmaps.SUBSYS_ACTIVECONN: activeconn_columns,
    fieldmaps.SUBSYS_CLIENTCONN: clientconn_columns,
}

# subsystems backed by the host-side listener-metadata registry
_SVCREG_COLUMNS_OF = {
    fieldmaps.SUBSYS_SVCINFO: svcinfo_columns,
    fieldmaps.SUBSYS_EXTSVCSTATE: extsvcstate_columns,
    fieldmaps.SUBSYS_SVCPROCMAP: svcprocmap_columns,
}

# subsystems the runtime answers from its own providers (heavy-hitter
# recovery, the trace slab grouped, the host-report ticks, the host-side
# registries, the alert manager, the notification log, its own status)
RUNTIME_SUBSYS = (
    fieldmaps.SUBSYS_TOPK, fieldmaps.SUBSYS_TRACEUNIQ,
    fieldmaps.SUBSYS_HOSTLIST, fieldmaps.SUBSYS_HOSTINFO,
    fieldmaps.SUBSYS_TRACEDEF, fieldmaps.SUBSYS_TRACESTATUS,
    fieldmaps.SUBSYS_TRACECONN, fieldmaps.SUBSYS_TAGS,
    fieldmaps.SUBSYS_MOUNTSTATE, fieldmaps.SUBSYS_NETIF,
    fieldmaps.SUBSYS_EXTACTIVECONN, fieldmaps.SUBSYS_EXTCLIENTCONN,
    fieldmaps.SUBSYS_EXTTRACEREQ, fieldmaps.SUBSYS_CGROUPSTATE,
    fieldmaps.SUBSYS_SVCIPCLUST, fieldmaps.SUBSYS_ALERTS,
    fieldmaps.SUBSYS_ALERTDEF, fieldmaps.SUBSYS_SILENCES,
    fieldmaps.SUBSYS_INHIBITS, fieldmaps.SUBSYS_ACTIONS,
    fieldmaps.SUBSYS_NOTIFYMSG, fieldmaps.SUBSYS_SERVERSTATUS)

# every subsystem the port serves (43)
SERVED = (tuple(_COLUMNS_OF) + tuple(_DEP_COLUMNS_OF)
          + tuple(_SVCREG_COLUMNS_OF) + RUNTIME_SUBSYS)

# top-N views: preset sort + limit over taskstate columns
_TOP_PRESETS = {
    fieldmaps.SUBSYS_TOPCPU: ("cpu", 15),
    fieldmaps.SUBSYS_TOPPGCPU: ("cpu", 10),
    fieldmaps.SUBSYS_TOPRSS: ("rssmb", 8),
    fieldmaps.SUBSYS_TOPDELAY: ("cpudelms", 15),
    fieldmaps.SUBSYS_TOPFORK: ("forks", 15),
}


def check_served(subsys: str) -> str:
    """``subsys`` if it is a subsystem of the field maps; ValueError
    otherwise."""
    if subsys not in fieldmaps.FIELDS_OF_SUBSYS:
        raise ValueError(f"unknown subsystem {subsys!r}")
    return subsys


def columns_for(cfg: EngineCfg, st: AggState, subsys: str, names=None,
                dep=None, svcreg=None, aux=None):
    """Resolve a subsystem to its (cols, base_mask) column source:
    runtime providers (``aux``) ≻ the listener registry ≻ dep-graph
    views ≻ device-slab readbacks. Shared by query execution and
    realtime alertdef evaluation."""
    check_served(subsys)
    if aux is not None and subsys in aux:
        return aux[subsys]()
    if subsys in _SVCREG_COLUMNS_OF:
        return _SVCREG_COLUMNS_OF[subsys](cfg, st, names=names,
                                          svcreg=svcreg)
    if subsys in _DEP_COLUMNS_OF:
        return _DEP_COLUMNS_OF[subsys](cfg, st, names=names, dep=dep)
    if subsys == fieldmaps.SUBSYS_SHARDLIST:
        # the sharded runtime's view: a single runtime has no shards
        raise ValueError(f"unknown subsystem {subsys!r}")
    if subsys not in _COLUMNS_OF:
        raise ValueError(f"subsystem {subsys!r} is answered by the "
                         "runtime (Runtime.query)")
    return _COLUMNS_OF[subsys](cfg, st, names=names)


# process-local subsystems answered by the runtime itself: the
# self-metrics readback and the Prometheus exposition
LOCAL_SUBSYS = ("selfstats", "metrics")


def local_response(rt, req: dict, snapshot=None):
    """Answer a process-local subsystem for a runtime (``.stats``,
    ``.alerts``, ``.spans``, ``.flush()``, ``.engine_health()``), or
    None when ``req`` targets an engine subsystem.

    ``snapshot`` (an ``EngineSnapshot``) selects the snapshot path: a
    ``metrics`` scrape refreshes only the freshness gauges and renders
    the gauges the last tick's health pass left, without touching live
    device state; the strong path folds staged records and refreshes
    the health gauges first."""
    subsys = req.get("subsys")
    if subsys == "selfstats":
        return selfstats_response(rt.stats, rt.alerts, spans=rt.spans)
    if subsys == "metrics":
        if snapshot is None:
            rt.flush()
            rt.engine_health()
        else:
            rt.stats.gauge("snapshot_age_seconds", max(
                0.0, rt._clock() - snapshot.published_at))
            rt.stats.gauge("snapshot_tick", float(snapshot.tick))
        return prom.metrics_response(rt.stats, rt.alerts)
    return None


def execute(cfg: EngineCfg, st: AggState, opts: QueryOptions,
            names=None, dep=None, columns_fn=None, svcreg=None,
            aux=None) -> dict:
    """Run one point-in-time query → {"recs": [...], "nrecs": N}.

    ``columns_fn(subsys) -> (cols, base_mask)`` overrides the column
    source (the runtime's version-keyed cache); ``aux`` maps subsystem
    names to zero-arg column providers."""
    check_served(opts.subsys)
    preset = _TOP_PRESETS.get(opts.subsys)
    if preset is not None and opts.sortcol is None and not opts.aggr:
        opts = opts._replace(sortcol=preset[0],
                             maxrecs=min(opts.maxrecs, preset[1]))
    if columns_fn is not None:
        cols, base_mask = columns_fn(opts.subsys)
    else:
        cols, base_mask = columns_for(cfg, st, opts.subsys, names=names,
                                      dep=dep, svcreg=svcreg, aux=aux)
    tree = criteria.parse(opts.filter) if opts.filter else None
    mask = base_mask & criteria.evaluate(tree, cols, opts.subsys)
    idx = np.nonzero(mask)[0]

    if opts.aggr:
        from gyeeta_tpu_torch.query import aggr as A

        if opts.groupby and "time" in opts.groupby:
            raise ValueError("groupby 'time' is historical-only")
        specs = [A.parse_aggr(s, opts.subsys) for s in opts.aggr]
        gb = A.parse_groupby(opts.groupby, opts.subsys)
        fmap = fieldmaps.field_map(opts.subsys)
        recs = A.aggregate_columns(cols, idx, specs, gb, fmap)
        if opts.sortcol:
            if opts.sortcol not in (tuple(s.alias for s in specs) + gb):
                raise ValueError(
                    f"sortcol {opts.sortcol!r} must be a groupby field "
                    f"or aggregation alias")
            recs.sort(key=lambda r: r[opts.sortcol],
                      reverse=opts.sortdesc)
        return {"recs": recs[: opts.maxrecs], "nrecs":
                min(len(recs), opts.maxrecs), "ngroups": len(recs)}

    if opts.sortcol:
        fmap = fieldmaps.field_map(opts.subsys)
        fd = fmap.get(opts.sortcol)
        if fd is None:
            raise ValueError(f"unknown sort column {opts.sortcol!r}")
        key = np.asarray(cols[fd.col])[idx]
        order = np.argsort(key, kind="stable")
        idx = idx[order[::-1] if opts.sortdesc else order]
    idx = idx[: opts.maxrecs]

    fmap = fieldmaps.field_map(opts.subsys)
    want = opts.columns or tuple(fmap)
    unknown = [c for c in want if c not in fmap]
    if unknown:
        raise ValueError(f"unknown columns {unknown}")
    # late materialization: project only the result rows
    colnames = [fmap[c].col for c in want if fmap[c].col in cols]
    if isinstance(cols, LazyCols):
        sliced = cols.rows_many(colnames, idx)
        recs = [fieldmaps.row_to_json(
            opts.subsys, {c: sliced[c][j] for c in colnames})
            for j in range(len(idx))]
    else:
        recs = [fieldmaps.row_to_json(
            opts.subsys, {c: cols[c][i] for c in colnames})
            for i in idx]
    return {"recs": recs, "nrecs": len(recs),
            "ntotal": int(base_mask.sum())}


def query_json(cfg: EngineCfg, st: AggState, req: dict,
               names=None, dep=None, svcreg=None, aux=None) -> dict:
    """JSON-envelope entry point."""
    return execute(cfg, st, QueryOptions.from_json(req), names=names,
                   dep=dep, svcreg=svcreg, aux=aux)
