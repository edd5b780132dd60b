"""Runtime: the aggregation-server loop of the port.

Counterpart of ``gyeeta_tpu/runtime.py`` on its default fused-fold
path: ``feed()`` takes byte streams (the reference's Python deframe),
stages raw conn/resp records and sweep sections on the host and folds
them in one ``fold_all`` dispatch per feed boundary; ``run_tick()``
closes a 5s window (digest drain, classification, heavy-hitter
recovery, dependency-graph ageing, health readback, window tick,
ageing and compaction cadences, checkpoints); ``query()`` answers the
JSON query API over the live state (the strong path: staged events are
folded first).

The state lives on ``device`` — CUDA unless the caller asks for the
CPU, and a GPU-less machine raises (``device.resolve``). Tiers not
ported yet — the alert manager, the snapshot tier, history and the
journal, the host-side registries, edge pre-aggregation — refuse their
records, options, subsystems and request forms with
:class:`~gyeeta_tpu_torch.unported.NotPortedError`, naming the
ROADMAP.md item that ports them.

Host↔device crossings of a feed: the section and slab columns go to the
device once per dispatch; the digest-stage pressure of the dispatch two
back is read (``int()``, a sync) before each dispatch, exactly the
reference's lag, because the timing of ``td_flush_partial`` changes the
digest state; the tick number goes to ``fold_all`` as a host int, which
it fills on the device.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np

from gyeeta_tpu_torch import unported
from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.engine import aggstate, compact, step
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.ingest import decode, wire
from gyeeta_tpu_torch.obs import health as obs_health
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.query import api
from gyeeta_tpu_torch.semantic import derive
from gyeeta_tpu_torch.sketch import invertible
from gyeeta_tpu_torch.utils import checkpoint as ckpt
from gyeeta_tpu_torch.utils.colcache import ColumnCache
from gyeeta_tpu_torch.utils.config import RuntimeOpts, check_ported
from gyeeta_tpu_torch.utils.intern import InternTable
from gyeeta_tpu_torch.utils.selfstats import Stats

# a native resp stream is "live" for bridge-suppression purposes if it
# reported within this many base ticks (2 min at 5s)
_RESP_FRESH_TICKS = 24


def _slab_lanes() -> dict:
    """Per-section lane capacities of the fused fold slab: 1-2 wire-max
    batches a section (the reference's defaults)."""
    return {
        "listener": 2 * wire.MAX_LISTENERS_PER_BATCH,
        "host": wire.MAX_HOSTS_PER_BATCH,
        "task": 2 * wire.MAX_TASKS_PER_BATCH,
        "cpumem": wire.MAX_CPUMEM_PER_BATCH,
        "trace": wire.MAX_TRACE_PER_BATCH,
        "ping": wire.MAX_PINGS_PER_BATCH,
    }


# fused-slab section plumbing: selfstats counter, wire subtype (for the
# raw-backlog concat dtype) and columnar builder per device-fold kind
_SECTION_COUNTERS = {
    "listener": "listener_records", "host": "host_records",
    "task": "task_records", "ping": "task_pings",
    "cpumem": "cpumem_records", "trace": "trace_records",
}
_SECTION_SUBTYPES = {
    "listener": wire.NOTIFY_LISTENER_STATE, "host": wire.NOTIFY_HOST_STATE,
    "task": wire.NOTIFY_AGGR_TASK_STATE, "ping": wire.NOTIFY_TASK_PING,
    "cpumem": wire.NOTIFY_CPU_MEM_STATE, "trace": wire.NOTIFY_REQ_TRACE,
}
_SECTION_BUILDERS = {
    "listener": decode.listener_batch_fast, "host": decode.host_batch_fast,
    "task": decode.task_batch_fast, "ping": decode.ping_batch,
    "cpumem": decode.cpumem_batch_fast, "trace": decode.trace_batch,
}

# record kinds of unported tiers → the ROADMAP.md item that ports them
_UNPORTED_KINDS = {
    wire.NOTIFY_LISTENER_INFO: ("LISTENER_INFO records",
                                unported.REGISTRIES),
    wire.NOTIFY_HOST_INFO: ("HOST_INFO records", unported.REGISTRIES),
    wire.NOTIFY_CGROUP_STATE: ("CGROUP_STATE records", unported.REGISTRIES),
    wire.NOTIFY_MOUNT_STATE: ("MOUNT_STATE records", unported.REGISTRIES),
    wire.NOTIFY_NETIF_STATE: ("NETIF_STATE records", unported.REGISTRIES),
    wire.NOTIFY_AGENT_STATS: ("AGENT_STATS records", unported.SNAPSHOT),
    wire.NOTIFY_SKETCH_DELTA: ("SKETCH_DELTA records",
                               unported.EDGE_PREAGG),
}

# process-local subsystems of the reference (selfstats readback and the
# Prometheus exposition)
LOCAL_SUBSYS = ("selfstats", "metrics")


class Runtime:
    def __init__(self, cfg: Optional[EngineCfg] = None,
                 opts: Optional[RuntimeOpts] = None, clock=None,
                 device=None):
        self.device = resolve(device)
        self.cfg = cfg or EngineCfg()
        self.opts = check_ported(opts or RuntimeOpts())
        self.state = aggstate.init(self.cfg, self.device)
        self.stats = Stats()
        # the wall clock of the reference's alert and snapshot tiers,
        # which read it; kept for their port
        self._clock = clock or time.time
        # per-host sweep-seq high-water marks (NOTIFY_SWEEP_SEQ),
        # checkpointed
        self._sweep_last_seq: dict[int, int] = {}
        self._tick_no = 0             # host-side mirror of the window tick
        self._pending = b""           # partial-frame resume buffer
        # conn/resp stage RAW record arrays; they decode once per slab
        self._conn_raw: list = []
        self._resp_raw: list = []
        self._n_conn_raw = 0
        self._n_resp_raw = 0
        # last tick each host sent a native RESP_SAMPLE: the trace→resp
        # bridge skips hosts with a recent native stream
        self._host_resp_tick = np.full(self.cfg.n_hosts, -(10 ** 9),
                                       np.int64)
        self._td_dirty = False        # digest stage may be non-empty
        self._cols = ColumnCache()    # version-keyed column memo
        # recovered-hot keys of the previous recovery (promotions count
        # keys newly recovered at/above the hot threshold)
        self._hh_prev_hot: set = set()
        # pressure scalars of recent dispatches, read at lag 2
        self._pressures: deque = deque()
        self.dep = dg.init(self.opts.dep_pair_capacity,
                           self.opts.dep_edge_capacity, self.device)
        self._slab_lanes_cfg = _slab_lanes()
        # per-section raw record backlogs that ride the next fold_all
        # dispatch (drained at the end of every ingest_records call)
        self._stage_recs = {k: [] for k in self._slab_lanes_cfg}
        self._stage_n = {k: 0 for k in self._slab_lanes_cfg}
        self.names = InternTable()
        self._aux = {
            "topk": self._topk_columns,
            "traceuniq": self._traceuniq_columns,
            "hostlist": self._hostlist_columns,
        }

    # ------------------------------------------------------------- ingest
    def feed(self, buf: bytes) -> int:
        """Ingest a byte stream (any number of frames, any mix of types)
        → records accepted. A trailing partial frame is kept for the
        next call."""
        data = (self._pending + buf) if self._pending else buf
        try:
            with self.stats.timeit("deframe"):
                recs, consumed, unknown = wire.drain2(data)
        except wire.FrameError:
            self.stats.bump("frames_bad")
            self._pending = b""       # poison frame: drop buffer, resync
            raise
        self._pending = data[consumed:]
        if unknown:
            # skipped unknown-subtype frames: accounted loss
            self.stats.bump("records_unknown_subtype", unknown)
        return self.ingest_records(recs)

    def ingest_records(self, recs: dict) -> int:
        """Fold a drained {subtype: record array} dict. A record kind of
        an unported tier is refused before anything is staged."""
        for sub, (what, item) in _UNPORTED_KINDS.items():
            if sub in recs:
                raise unported.refuse(what, item)
        n = 0
        sw = recs.pop(wire.NOTIFY_SWEEP_SEQ, None)
        if sw is not None and len(sw):
            for h, s in zip(sw["host_id"].tolist(), sw["seq"].tolist()):
                if s > self._sweep_last_seq.get(h, 0):
                    self._sweep_last_seq[h] = s
            self.stats.bump("sweep_marks", len(sw))
            n += len(sw)
        conn = recs.pop(wire.NOTIFY_TCP_CONN, None)
        if conn is not None and len(conn):
            self._conn_raw.append(conn)
            self._n_conn_raw += len(conn)
            self.stats.bump("conn_events", len(conn))
            n += len(conn)
        resp = recs.pop(wire.NOTIFY_RESP_SAMPLE, None)
        if resp is not None and len(resp):
            hid = resp["host_id"]
            self._host_resp_tick[hid[hid < self.cfg.n_hosts]] = \
                self._tick_no
            self._resp_raw.append(resp)
            self._n_resp_raw += len(resp)
            self.stats.bump("resp_events", len(resp))
            n += len(resp)
        for kind, *chunks in decode.drain_chunks(
                recs, self.cfg.conn_batch, self.cfg.resp_batch,
                self.cfg.listener_batch):
            if kind in _SECTION_COUNTERS:
                n += self._stage_section(kind, chunks[0])
            elif kind == "names":
                # names are not telemetry events, but resolved names are
                # part of every view
                self.stats.bump("names_interned",
                                self.names.update(chunks[0]))
                self._cols.bump()
        self._dispatch_fused_pending()
        if n:
            self._cols.bump()
        return n

    def _observe_trace(self, recs) -> None:
        """Host half of the trace fold: the trace→resp bridge, with
        per-host native-stream precedence (hosts with a recent native
        RESP_SAMPLE stream are not bridged)."""
        if self.opts.trace_resp_bridge:
            rs = decode.resp_from_trace(recs)
            hid = rs["host_id"]
            fresh = (self._tick_no - self._host_resp_tick[
                np.minimum(hid, self.cfg.n_hosts - 1)]
                <= _RESP_FRESH_TICKS)
            rs = rs[(hid >= self.cfg.n_hosts) | ~fresh]
            if len(rs):
                self._resp_raw.append(rs)
                self._n_resp_raw += len(rs)
                self.stats.bump("resp_from_trace", len(rs))

    # ------------------------------------------------- fused fold path
    def _stage_section(self, kind: str, recs) -> int:
        """Stage one drained chunk into its fused-slab section,
        dispatching the pending slab first when the section would
        overflow its lanes."""
        if kind == "trace":
            self._observe_trace(recs)
        if self._stage_n[kind] + len(recs) > self._slab_lanes_cfg[kind]:
            self._dispatch_fused()
        self._stage_recs[kind].append(recs)
        self._stage_n[kind] += len(recs)
        self.stats.bump(_SECTION_COUNTERS[kind], len(recs))
        return len(recs)

    def _dispatch_fused_pending(self) -> None:
        """End-of-ingest fold boundary: one dispatch folds every staged
        section plus (when full) the conn/resp K-slab; further full
        K-slabs drain in connresp-only dispatches."""
        K = self.cfg.fold_k
        nc, nr = K * self.cfg.conn_batch, K * self.cfg.resp_batch
        while (any(self._stage_n.values())
               or self._n_conn_raw >= nc or self._n_resp_raw >= nr):
            self._dispatch_fused(
                connresp="slab" if (self._n_conn_raw >= nc
                                    or self._n_resp_raw >= nr)
                else None)

    def _take_connresp(self, k: int):
        """Decode up to ``k`` microbatches of the staged conn/resp
        records into one ``(k, B)`` slab → (conn slab, resp slab,
        records taken)."""
        crecs, nc = decode.take_raw_chunks(self._conn_raw,
                                           k * self.cfg.conn_batch)
        rrecs, nr = decode.take_raw_chunks(self._resp_raw,
                                           k * self.cfg.resp_batch)
        self._n_conn_raw -= nc
        self._n_resp_raw -= nr
        return (decode.conn_slab(crecs, k, self.cfg.conn_batch),
                decode.resp_slab(rrecs, k, self.cfg.resp_batch), nc, nr)

    def _dispatch_fused(self, connresp=None) -> None:
        """One fused device dispatch: the staged sections, optionally
        the conn/resp slab (``connresp``: None, "slab" = ``(K, B)``, or
        "single" = ``(1, B)``, the flush shape), the dependency fold
        and the digest-stage pressure scalar."""
        sections = {}
        with self.stats.timeit("decode"):
            for kind in self._slab_lanes_cfg:
                if self._stage_n[kind]:
                    recs = decode._concat_chunks(
                        self._stage_recs[kind],
                        wire.DTYPE_OF_SUBTYPE[_SECTION_SUBTYPES[kind]])
                    sections[kind] = _SECTION_BUILDERS[kind](
                        recs, self._slab_lanes_cfg[kind])
                    self._stage_recs[kind] = []
                    self._stage_n[kind] = 0
            if connresp == "slab":
                K = self.cfg.fold_k
                cbs, rbs, nc, nr = self._take_connresp(K)
                # host-side staging gauges: slab fill at dispatch
                self.stats.gauge("engine_stage_slab_conn_occupancy",
                                 round(nc / (K * self.cfg.conn_batch), 4))
                self.stats.gauge("engine_stage_slab_resp_occupancy",
                                 round(nr / (K * self.cfg.resp_batch), 4))
                sections["connresp"] = (cbs, rbs)
                self.stats.bump("slab_dispatches")
            elif connresp == "single":
                cbs, rbs, _, _ = self._take_connresp(1)
                sections["connresp"] = (cbs, rbs)
        if not sections:
            return
        # lag-2 pressure scalar (a fold_all output two dispatches back):
        # flush the fullest digest stages before this dispatch when
        # headroom is low
        if (len(self._pressures) >= 2
                and int(self._pressures.popleft())
                > self.cfg.td_stage_cap // 2):
            self.state = step.td_flush_partial(self.cfg, self.state)
            self.stats.bump("td_partial_flushes")
        names = tuple(k for k in step.FOLD_ALL_ORDER if k in sections)
        with self.stats.timeit("fold_dispatch"):
            secs = {k: (decode.to_device(sections[k][0], self.device),
                        decode.to_device(sections[k][1], self.device))
                    if k == "connresp"
                    else decode.to_device(sections[k], self.device)
                    for k in names}
            self.state, self.dep, pressure = step.fold_all(
                self.cfg, self.state, self.dep, self._tick_no, **secs)
        self._pressures.append(pressure)
        if "connresp" in sections:
            self._td_dirty = True
        self.stats.bump("fold_dispatches")

    def flush(self) -> int:
        """Fold every staged record: a ``(1, B)`` dispatch when the
        leftovers fit one microbatch, padded ``(K, B)`` slabs otherwise.
        Called at every cadence and query boundary. Returns conn/resp
        records folded."""
        n = self._n_conn_raw + self._n_resp_raw
        while (self._n_conn_raw or self._n_resp_raw
               or any(self._stage_n.values())):
            if (self._n_conn_raw <= self.cfg.conn_batch
                    and self._n_resp_raw <= self.cfg.resp_batch):
                self._dispatch_fused(
                    connresp="single"
                    if (self._n_conn_raw or self._n_resp_raw) else None)
            else:
                self._dispatch_fused(connresp="slab")
        if n:
            self._cols.bump()
        return n

    def td_drain(self, max_iters: int | None = None) -> int:
        """Drain the digest stage with partial flushes, each after one
        readback of the stage pressure; ``max_iters`` bounds the work
        per call. Returns flushes run."""
        self.flush()
        self._cols.bump()
        i = 0
        while max_iters is None or i < max_iters:
            if int(step.stage_pressure(self.state)) <= 0:
                self._td_dirty = False
                self._pressures.clear()
                break
            self.state = step.td_flush_partial(self.cfg, self.state)
            self.stats.bump("td_partial_flushes")
            i += 1
        return i

    # ------------------------------------------------------------ health
    def engine_health(self) -> dict:
        """Device-state health gauges from one batched readback, folded
        into ``self.stats`` gauges."""
        vec = step.engine_health_vec(self.cfg, self.state, self.dep)
        gauges = obs_health.gauges_from_vec(
            vec.cpu().numpy(), obs_health.capacities(self.cfg, self.opts))
        for k, v in gauges.items():
            self.stats.gauge(k, v)
        return gauges

    # -------------------------------------------------- heavy hitters
    def heavy_recover(self) -> dict:
        """Heavy-hitter key recovery: one read-only pass on the device
        (``step.heavy_recover``), read back once; the host merges the
        exact top-K lanes and the verified candidates into the
        bound-annotated heavy-flow view of the ``topk`` subsystem."""
        self.flush()
        with self.stats.timeit("topk_recover"):
            out = {k: v.cpu().numpy() for k, v in
                   step.heavy_recover(self.cfg, self.state).items()}
        self.stats.bump("topk_recover_readbacks")
        evicted = float(out["evicted"])
        total = float(out["total_mass"])
        err_term = invertible.cms_error_term(total, self.cfg.cms_width)
        hot_thresh = (self.cfg.hh_hot_frac * total
                      if self.cfg.hh_hot_frac > 0 else 0.0)
        flows, recovered, hot = invertible.merge_recovered_np(
            out, err_term, hot_thresh)
        new_hot = hot - self._hh_prev_hot
        if new_hot:
            self.stats.bump("topk_hot_promotions", len(new_hot))
        self._hh_prev_hot = hot
        self.stats.gauge("topk_recovered_keys", float(len(recovered)))
        self.stats.gauge("topk_evicted_mass", evicted)
        return {"flows": flows, "recovered_keys": len(recovered),
                "evicted": evicted, "err_term": err_term,
                "total_mass": total, "new_hot": len(new_hot)}

    def _topk_columns(self):
        """topk columns: heavy flows (exact ∪ recovered) and the dense
        service/API rankings; recovery memoized per state version."""
        rec = self._cols.get("__hh_recover", self.heavy_recover)
        return api.heavy_topk_columns(
            rec["flows"], svc=self._cached_columns("svcstate"),
            trace=self._cached_columns("tracereq"))

    # ------------------------------------------------------------ cadence
    def run_tick(self) -> dict:
        with self.stats.timeit("tick"):
            return self._run_tick()

    def _run_tick(self) -> dict:
        """Close one 5s window → the tick report (the reference's keys
        but those of unported tiers: ``alerts_fired``,
        ``history_rows``)."""
        self.flush()
        if self._td_dirty:    # tick-cadence digest compression (bounded)
            self.td_drain(max_iters=self.opts.td_drain_iters_per_tick)
        report = {}
        self.state = derive.classify_pass(self.cfg, self.state)
        self._cols.bump()             # classify + tick mutate views
        ev = self.opts.hh_recover_every_ticks
        if ev and self.cfg.hh_width > 0 \
                and (self._tick_no + 1) % ev == 0:
            report["topk_recovered"] = self._cols.get(
                "__hh_recover", self.heavy_recover)["recovered_keys"]
        tick = int(self.state.resp_win.tick) + 1
        report["tick"] = tick
        self._tick_no = tick
        self.stats.gauge("tick", tick)
        self.dep = dg.age(self.dep, tick, self.opts.dep_pair_ttl_ticks,
                          self.opts.dep_edge_ttl_ticks)
        self.engine_health()
        self.state = step.tick_5s(self.cfg, self.state)
        if tick % self.opts.task_age_every_ticks == 0:
            self.state = step.age_tasks(self.cfg, self.state,
                                        self.opts.task_max_age_ticks)
            self.state = step.age_apis(self.cfg, self.state,
                                       self.opts.api_max_age_ticks)
        n_tomb = int(self.state.tbl.n_tomb)
        if n_tomb > self.cfg.svc_capacity * self.opts.compact_tomb_frac:
            self.state = compact.compact_state(self.cfg, self.state)
            self.stats.bump("compactions")
            report["compacted"] = True
        nt_tomb = int(self.state.task_tbl.n_tomb)
        if nt_tomb > self.cfg.task_capacity * self.opts.compact_tomb_frac:
            self.state = step.compact_tasks(self.cfg, self.state)
            self.stats.bump("task_compactions")
            report["task_compacted"] = True
        if (self.opts.checkpoint_dir
                and tick % self.opts.checkpoint_every_ticks == 0):
            extra: dict = {"tick": tick}
            if self._sweep_last_seq:
                extra["sweep_seq"] = {str(k): int(v) for k, v in
                                      self._sweep_last_seq.items()}
            path = ckpt.save(
                f"{self.opts.checkpoint_dir}/gyt_ckpt_{tick:08d}.npz",
                self.cfg, self.state, extra=extra)
            report["checkpoint"] = str(path)
            self.stats.bump("checkpoints")
        self._cols.bump()
        return report

    # ------------------------------------------------------- providers
    def _hostlist_columns(self):
        """hostlist (ref parthalist): hosts that have ever reported,
        with liveness from the last-report tick."""
        last = self.state.host_last_tick.cpu().numpy()
        seen = np.nonzero(last >= 0)[0]
        age = self._tick_no - last[seen]
        _, hostnames = api._host_name_cols(self.cfg.n_hosts, self.names)
        cols = {
            "hostid": seen.astype(np.float64),
            "hostname": np.asarray(hostnames, object)[seen],
            "up": age <= api.DOWN_AFTER_TICKS,
            "lastseen": age.astype(np.float64),
        }
        return cols, np.ones(len(seen), bool)

    def _cached_columns(self, subsys: str):
        """Version-keyed column cache: readbacks recompute only after
        the state changed (feed, tick, flush and restore bump it)."""
        if subsys in self._aux:
            return self._aux[subsys]()
        return self._cols.get(subsys, lambda: api.columns_for(
            self.cfg, self.state, subsys, names=self.names, dep=self.dep))

    def _traceuniq_columns(self):
        """traceuniq: distinct API signatures per service, grouped from
        the per-(svc, api) slab."""
        tcols, tlive = api.trace_columns(self.cfg, self.state,
                                         names=self.names)
        return api.traceuniq_from_trace(tcols, tlive)

    # -------------------------------------------------------------- query
    def query(self, req: dict) -> dict:
        """Point-in-time JSON query on the strong path: staged events
        are folded first, then the live state is read. The request
        forms of unported tiers raise."""
        if req.get("op"):
            raise unported.refuse("CRUD requests ('op')", unported.ALERTS)
        if "multiquery" in req:
            raise unported.refuse("multiquery", unported.SNAPSHOT)
        if req.get("consistency") == "snapshot":
            raise unported.refuse("consistency='snapshot'",
                                  unported.SNAPSHOT)
        if "consistency" in req:
            req = dict(req)
            if req.pop("consistency") != "strong":
                raise ValueError(
                    "consistency must be 'snapshot' or 'strong'")
        if req.get("subsys") in LOCAL_SUBSYS:
            raise unported.refuse(f"subsystem {req['subsys']!r}",
                                  unported.SNAPSHOT)
        with self.stats.timeit("query"):
            return self._query(req)

    def _query(self, req: dict) -> dict:
        for k in ("tstart", "tend", "at", "window"):
            if k in req:
                raise unported.refuse(f"historical queries ({k!r})",
                                      unported.HISTORY)
        self.flush()                  # live queries see all staged events
        self.stats.bump("queries")
        return api.execute(self.cfg, self.state,
                           api.QueryOptions.from_json(req),
                           names=self.names,
                           columns_fn=self._cached_columns)

    def restore(self, path) -> dict:
        """Restore a checkpoint (from either package): staged records
        and partial-frame bytes are dropped (folding them into the
        checkpointed state would double-count), the dependency graph is
        re-initialised (it is not checkpointed), and the tick mirror and
        the sweep-seq marks realign to the checkpoint's."""
        self._conn_raw, self._resp_raw = [], []
        self._n_conn_raw = self._n_resp_raw = 0
        self._stage_recs = {k: [] for k in self._slab_lanes_cfg}
        self._stage_n = {k: 0 for k in self._slab_lanes_cfg}
        self._pending = b""
        self._cols.bump()
        # the checkpoint may carry a non-empty digest stage
        self._td_dirty = True
        self._pressures.clear()
        self.state, extra = ckpt.restore(path, self.cfg, self.state)
        self.dep = dg.init(self.opts.dep_pair_capacity,
                           self.opts.dep_edge_capacity, self.device)
        self._tick_no = int(extra.get("tick", 0))
        self._sweep_last_seq = {
            int(k): int(v)
            for k, v in extra.get("sweep_seq", {}).items()}
        return extra
