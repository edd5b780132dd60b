"""ShardedRuntime: the full product loop over a mesh of shards.

Counterpart of ``gyeeta_tpu/parallel/shardedrt.py``. The single-device
:class:`~gyeeta_tpu_torch.runtime.Runtime` is one madhava; this is the
whole tier. Every shard owns an ``AggState`` and a ``DepGraph`` for its
slice of the host space (``host_id % n``), on its own device of the
mesh (``parallel/mesh.py``: N shards on one card are N logical shards
of it), and the subsystems the reference runs as madhava→shyama RPCs
become collectives:

- **ingest**: each record's host is hashed to its shard once, at
  staging (:meth:`ShardedRuntime._stage_raw`); a slab dispatch decodes
  every shard's lanes from its own bucket into its own pair of pinned
  staging buffers and runs the per-shard fold — the conn fold launches
  the fused sketch kernels on every shard;
- **pairing / dependency graph**: the one-sided conn halves ride the
  capacity-bucketed ``all_to_all`` to their flow-owner shard and pair
  there (``parallel/depgraph.py``);
- **tick**: per-shard digest drain, classify, ageing and ``tick_5s``;
  one :func:`~gyeeta_tpu_torch.parallel.rollup.fleet_rollup_fn` over
  every shard (cluster rollup, merged edges, merged health vector)
  seeds the column caches, heavy hitters recover against the merged
  CMS, and the published snapshot serves the window's queries;
- **queries and alerts**: per-shard columns concatenated in shard order
  and run through the same filter/sort/aggregation pipeline — the
  multi-madhava scatter of the reference's web tier — so alertdefs,
  JSON queries and history writes see a cluster-wide view; the
  ``shardlist`` subsystem lists the shards.

The journal is per shard (``utils/journal.py``'s ``ShardedJournal``,
``shard_NN/``); a checkpoint stores the reference's stacked
``(n_shards, ...)`` leaves, so either package restores it.

The host side (registries, alert manager, CRUD, the query entry points,
journal replay) is the single runtime's, inherited; everything that
touches device state is overridden here.
"""

from __future__ import annotations

import numpy as np
import torch

from gyeeta_tpu_torch.engine import step, table
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.history import winquant as WQ
from gyeeta_tpu_torch.ingest import decode, wire
from gyeeta_tpu_torch.obs import health as obs_health
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.parallel import rollup, sharded
from gyeeta_tpu_torch.parallel.mesh import make_mesh
from gyeeta_tpu_torch.parallel.partition import ShardLayout
from gyeeta_tpu_torch.query import api, fieldmaps
from gyeeta_tpu_torch.query.lazycols import LazyCols, merge_lazy
from gyeeta_tpu_torch.query.snapshot import EngineSnapshot, \
    recover_rollup
from gyeeta_tpu_torch.runtime import _AGENT_STATS_COUNTERS, \
    _REGISTRY_KINDS, _RESP_FRESH_TICKS, Runtime
from gyeeta_tpu_torch.sketch import topk
from gyeeta_tpu_torch.utils import checkpoint as ckpt
from gyeeta_tpu_torch.utils import droppressure
from gyeeta_tpu_torch.utils import journal as J
from gyeeta_tpu_torch.utils.config import RuntimeOpts

# sweep-section kind → (per-shard fold, lanes, selfstats counter)
_SECTION_FOLDS = {
    "listener": (sharded.ingest_listener_sharded, None, None),
    "host": (sharded.ingest_host_sharded, wire.MAX_HOSTS_PER_BATCH, None),
    "task": (sharded.ingest_task_sharded, wire.MAX_TASKS_PER_BATCH, None),
    "ping": (sharded.ping_tasks_sharded, wire.MAX_PINGS_PER_BATCH,
             "task_pings"),
    "cpumem": (sharded.ingest_cpumem_sharded, wire.MAX_CPUMEM_PER_BATCH,
               None),
    "trace": (sharded.ingest_trace_sharded, wire.MAX_TRACE_PER_BATCH,
              None),
}


class ShardedRuntime(Runtime):
    def __init__(self, cfg: EngineCfg | None = None, mesh=None,
                 opts: RuntimeOpts | None = None, clock=None,
                 device=None, deframe: str = "native", profiler=None):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.n = self.mesh.n
        self.device = self.mesh.devices[0]
        # the one layout: fold, ingest-edge host hash and the per-shard
        # WAL subdirs all ask it
        self.layout = ShardLayout(self.mesh)
        self._init_host(cfg, opts, clock, deframe, profiler)
        self.state = sharded.init_sharded(self.cfg, self.mesh)
        self.dep = sharded.dep_init_sharded(
            self.mesh, self.opts.dep_pair_capacity,
            self.opts.dep_edge_capacity)
        self._sect_builders = self._section_builders()
        # conn/resp staging PER SHARD: records are routed by host at
        # staging time, so a dispatch builds every shard's lanes from
        # its own bucket. _n_conn_raw/_n_resp_raw stay the totals (the
        # serving edge's admission controller reads them).
        self._conn_raw: list = [[] for _ in range(self.n)]
        self._resp_raw: list = [[] for _ in range(self.n)]
        self._conn_staged = [0] * self.n
        self._resp_staged = [0] * self.n
        self._n_conn_raw = 0
        self._n_resp_raw = 0
        # per-shard folded events → shard_fold_ev_per_sec gauges
        self._shard_events = np.zeros(self.n, np.int64)
        self._shard_rate_mark = np.zeros(self.n, np.int64)
        self._shard_rate_t: float = self._clock()
        self._pressure = None         # device scalar of the last slab
        # double-buffered conn/resp staging slabs a shard (pinned on
        # CUDA), flipped each slab dispatch; "copied" is the buffer's
        # copy event, waited on before the next decode into it
        K = self.cfg.fold_k
        self._slab_bufs = [
            [{"conn": decode.alloc_conn_cols(K * self.cfg.conn_batch,
                                             d.type == "cuda"),
              "resp": decode.alloc_resp_cols(K * self.cfg.resp_batch,
                                             d.type == "cuda"),
              "hw_conn": 0, "hw_resp": 0, "copied": None}
             for _ in range(2)] for d in self.mesh.devices]
        self._slab_active = 0
        self._roll = rollup.rollup_fn(self.cfg, self.mesh)
        self._fleet_roll = rollup.fleet_rollup_fn(
            self.cfg, self.mesh, self.opts.dep_edge_capacity)
        self._edge_roll = dg.edge_rollup_fn(self.mesh,
                                            self.opts.dep_edge_capacity)
        self._aux["shardlist"] = self._shardlist_columns

    def _make_journal(self, clock):
        """The per-shard journal (``shard_NN/`` subdirs, placed by the
        layout's host hash); a one-shard mesh keeps the flat layout."""
        if self.n == 1:
            return super()._make_journal(clock)
        return J.ShardedJournal(
            self.opts.journal_dir, self.n,
            subdir_fmt=self.layout.WAL_SUBDIR_FMT,
            segment_max_bytes=self.opts.journal_segment_mb << 20,
            fsync_bytes=self.opts.journal_fsync_kb << 10,
            fsync_ms=self.opts.journal_fsync_ms,
            backlog_max_bytes=self.opts.journal_backlog_mb << 20,
            stats=self.stats, clock=clock)

    # ------------------------------------------------------------- ingest
    def _stack(self, kind: str, recs, lanes: int, shard=None) -> list:
        """Route ``recs`` by host to the shards and build one batch a
        shard on its device; records already routed to ``shard`` (the
        ingest workers' rings) go to that shard's batch unhashed."""
        fns = (self._sect_builders[kind], lanes)
        if shard is None:
            per = sharded.shard_batches(self.cfg, self.mesh, fns, recs,
                                        recs["host_id"])
        else:
            per = sharded.stack_prerouted(
                fns, [recs if s == shard else recs[:0]
                      for s in range(self.n)])
        return self.layout.put(per)

    def _dispatch_fused_pending(self) -> None:
        """No end-of-ingest fold boundary: sections fold as they arrive
        and conn/resp a full slab at a time (``flush`` folds the rest),
        so :meth:`Runtime.feed_batch` is a feed a piece here."""

    def ingest_records(self, recs: dict, shard=None) -> int:
        """Fold a drained ``{subtype: record array}`` dict (the post-
        deframe half of :meth:`feed`). Conn/resp records stage by shard
        and fold a slab at a time; every other section folds at once,
        each shard's lanes routed by host. The multi-process ingest
        supervisor (``net/ingestproc.py``) and the relay hub drain their
        batches through here with ``shard=`` set: the worker already
        routed the records by the layout's host hash, so they go straight
        into that shard's staging bucket and batch, with no re-hash."""
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
            with self._reg_lock:
                self.natclusters.observe_conns(conn)
            self._stage(self._conn_raw, self._conn_staged, conn, shard)
            self._n_conn_raw += len(conn)
            self.stats.bump("conn_events", len(conn))
            n += len(conn)
        resp = recs.pop(wire.NOTIFY_RESP_SAMPLE, None)
        if resp is not None and len(resp):
            hid = resp["host_id"]
            self._host_resp_tick[hid[hid < self.cfg.n_hosts]] = \
                self._tick_no
            self._stage(self._resp_raw, self._resp_staged, resp, shard)
            self._n_resp_raw += len(resp)
            self.stats.bump("resp_events", len(resp))
            n += len(resp)
        slab_c = self.cfg.fold_k * self.cfg.conn_batch
        slab_r = self.cfg.fold_k * self.cfg.resp_batch
        while (max(self._conn_staged) >= slab_c
               or max(self._resp_staged) >= slab_r):
            self._dispatch_slab(slab_c, slab_r)
        for kind, *chunks in decode.drain_chunks(
                recs, self.cfg.conn_batch, self.cfg.resp_batch,
                self.cfg.listener_batch):
            if kind in _SECTION_FOLDS:
                fold, lanes, ctr = _SECTION_FOLDS[kind]
                if kind == "trace":
                    with self._reg_lock:
                        self.traceconns.observe(chunks[0])
                self.state = fold(self.cfg, self.state, self._stack(
                    kind, chunks[0], lanes or self.cfg.listener_batch,
                    shard))
                n += len(chunks[0])
                if ctr:
                    self.stats.bump(ctr, len(chunks[0]))
                if kind == "trace" and self.opts.trace_resp_bridge:
                    self._bridge_trace(chunks[0])
            elif kind == "delta":
                db = self._stack("delta", chunks[0],
                                 decode.DELTA_LANES_DEFAULT, shard)
                self.state, self.dep = sharded.ingest_delta_sharded(
                    self.cfg, self.state, self.dep, db, self._tick_no)
                n += len(chunks[0])
                self.stats.bump("preagg_delta_records", len(chunks[0]))
            elif kind in _REGISTRY_KINDS:
                reg, ctr = _REGISTRY_KINDS[kind]
                with self._reg_lock:
                    self.stats.bump(ctr,
                                    getattr(self, reg).update(chunks[0]))
                n += len(chunks[0])
            elif kind == "agent_stats":
                for fld, ctr in _AGENT_STATS_COUNTERS:
                    tot = int(chunks[0][fld].sum())
                    if tot:
                        self.stats.bump(ctr, tot)
            elif kind == "names":
                with self._reg_lock:
                    self.stats.bump("names_interned",
                                    self.names.update(chunks[0]))
        self._cols.bump()
        return n

    def _bridge_trace(self, recs) -> None:
        """The trace→resp bridge: hosts with a recent native resp stream
        are not bridged; the rest stage by shard."""
        rs = decode.resp_from_trace(recs)
        hid = rs["host_id"]
        fresh = (self._tick_no - self._host_resp_tick[
            np.minimum(hid, self.cfg.n_hosts - 1)] <= _RESP_FRESH_TICKS)
        rs = rs[(hid >= self.cfg.n_hosts) | ~fresh]
        if len(rs):
            self._stage_raw(self._resp_raw, self._resp_staged, rs)
            self._n_resp_raw += len(rs)
            self.stats.bump("resp_from_trace", len(rs))

    def _stage(self, buckets: list, counts: list, recs, shard) -> None:
        """Stage by host hash, or straight into ``shard``'s bucket."""
        if shard is None:
            self._stage_raw(buckets, counts, recs)
        else:
            buckets[shard].append(recs)
            counts[shard] += len(recs)

    def _stage_raw(self, buckets: list, counts: list, recs) -> None:
        """Hash each record's host to its shard and append the per-shard
        slices: one stable argsort a record array, so within a shard the
        arrival order is what the fold sees."""
        if self.n == 1:
            buckets[0].append(recs)
            counts[0] += len(recs)
            return
        dest = np.asarray(self.layout.shard_of_host(
            recs["host_id"].astype(np.int64)))
        order = np.argsort(dest, kind="stable")
        recs = recs[order]
        bounds = np.searchsorted(dest[order], np.arange(self.n + 1))
        for s in range(self.n):
            a, b = int(bounds[s]), int(bounds[s + 1])
            if b > a:
                buckets[s].append(recs[a:b])
                counts[s] += b - a

    def _take_shard_raw(self, buckets: list, counts: list,
                        lanes: int) -> list:
        """Pop up to ``lanes`` records off every shard's bucket (chunk
        lists, no concatenation)."""
        out = []
        for s in range(self.n):
            got, k = decode.take_raw_chunks(buckets[s], lanes)
            counts[s] -= k
            out.append(got)
        return out

    def _flip_slab_bufs(self) -> list:
        """Every shard's idle staging buffer, made the active one; waits
        for its copies of two dispatches back to leave it."""
        bufs = [pair[self._slab_active] for pair in self._slab_bufs]
        self._slab_active ^= 1
        self.stats.bump("stage_slab_flips")
        for buf in bufs:
            if buf["copied"] is not None:
                buf["copied"].synchronize()
                buf["copied"] = None
        return bufs

    @staticmethod
    def _decode_into(buf: dict, key: str, parts_fn, chunks, lanes: int,
                     **kw):
        """Decode ``chunks`` into the first ``lanes`` lanes of one
        staging buffer; ``hw_*`` tracks how far it holds stale lanes."""
        hw = buf["hw_" + key]
        cols = {k: v[:lanes] for k, v in buf[key].items()}
        nrec = sum(len(c) for c in chunks)
        out = parts_fn(chunks, lanes, out=cols, clear_to=min(hw, lanes),
                       **kw)
        buf["hw_" + key] = hw if hw > lanes else nrec
        return out

    def _dispatch_slab(self, lanes_c: int, lanes_r: int) -> None:
        """Decode and fold up to ``lanes_c``/``lanes_r`` staged records
        of every shard in one sharded dispatch."""
        crecs = self._take_shard_raw(self._conn_raw, self._conn_staged,
                                     lanes_c)
        rrecs = self._take_shard_raw(self._resp_raw, self._resp_staged,
                                     lanes_r)
        ncs = [sum(len(c) for c in x) for x in crecs]
        nrs = [sum(len(c) for c in x) for x in rrecs]
        nc, nr = sum(ncs), sum(nrs)
        self._n_conn_raw -= nc
        self._n_resp_raw -= nr
        self._shard_events += np.asarray(ncs) + np.asarray(nrs)
        kw = dict(stats=self.stats, native=self._native)
        with self.stats.timeit("fold_dispatch"), \
                self.spans.span("decode_fold", nrec=nc + nr,
                                path=self.deframe), \
                self._profiler.fold(self.device):
            bufs = self._flip_slab_bufs()
            with self.stats.timeit("decode"):
                cbs = [self._decode_into(b, "conn",
                                         decode.conn_batch_parts, c,
                                         lanes_c, **kw)
                       for b, c in zip(bufs, crecs)]
                rbs = [self._decode_into(b, "resp",
                                         decode.resp_batch_parts, r,
                                         lanes_r, **kw)
                       for b, r in zip(bufs, rrecs)]
            cbs = self.layout.put(cbs, staged=True)
            rbs = self.layout.put(rbs, staged=True)
            for buf, d in zip(bufs, self.mesh.devices):
                if d.type == "cuda":
                    buf["copied"] = torch.cuda.Event()
                    buf["copied"].record(torch.cuda.current_stream(d))
            # the previous dispatch's pressure scalar (one read-back):
            # flush the fullest per-shard stages first when headroom is
            # low
            if (self._pressure is not None
                    and int(self._pressure) > self.cfg.td_stage_cap // 2):
                self.state = sharded.td_flush_sharded(self.cfg,
                                                      self.state)
                self.stats.bump("td_partial_flushes")
            cap = self.cfg.conn_batch * (
                self.cfg.fold_k if lanes_c > self.cfg.conn_batch else 1)
            self.state, self.dep, self._pressure = \
                sharded.fold_step_dep_sharded(
                    self.cfg, self.mesh, self.state, self.dep, cbs, rbs,
                    self._tick_no, cap)
            self.stats.bump("fold_dispatches")
            if lanes_c > self.cfg.conn_batch:
                self.stats.bump("slab_dispatches")
        self._td_dirty = True

    def flush(self) -> int:
        """Fold the staged conn/resp leftovers in chunk-width
        dispatches; the state is query-ready afterwards."""
        folded = self._n_conn_raw + self._n_resp_raw
        while self._n_conn_raw or self._n_resp_raw:
            self._dispatch_slab(self.cfg.conn_batch, self.cfg.resp_batch)
        if folded:
            self._cols.bump()
        return folded

    def td_drain(self, max_iters: int | None = None) -> int:
        """Drain the per-shard digest stages with partial flushes, each
        after one read-back of the global stage pressure."""
        self.flush()
        self._cols.bump()
        i = 0
        while max_iters is None or i < max_iters:
            if int(sharded.td_pressure_sharded(self.state)) <= 0:
                self._td_dirty = False
                self._pressure = None
                break
            self.state = sharded.td_flush_sharded(self.cfg, self.state)
            self.stats.bump("td_partial_flushes")
            i += 1
        return i

    # ---------------------------------------------------- merged columns
    def _shard_state(self, s: int, state=None):
        """Shard ``s``'s state (the live one, or of ``state``)."""
        return (self.state if state is None else state)[s]

    def _cached_columns(self, subsys: str):
        """Cluster-wide (cols, mask), version-cached; registry- and
        CRUD-backed views are never cached."""
        if subsys in self._aux:
            return self._aux[subsys]()
        out = self._cols.get(subsys, lambda: self._merged_columns_state(
            subsys, self.state, self.dep, self._cols, live=True))
        if subsys == fieldmaps.SUBSYS_PROCINFO:
            out = self.tags.with_tags(out)
        return out

    def _merged_columns_state(self, subsys: str, state, dep, cache,
                              live: bool = False, reg: bool = False):
        """Per-shard provider outputs concatenated in shard order, or
        rollup-backed for the global subsystems — over (state, dep,
        cache), so one pipeline serves the live mesh, the published
        snapshot and shard-materialized history. ``live`` routes
        recursive lookups through the cached path and keeps the
        registry joins; ``reg`` keeps the registry joins over a frozen
        state (the published snapshot)."""
        if live:
            get = self._cached_columns
        else:
            def get(s):
                return cache.get(s, lambda: self._merged_columns_state(
                    s, state, dep, cache, reg=reg))
        if subsys == fieldmaps.SUBSYS_SVCINFO:
            if not (live or reg):
                raise ValueError("svcinfo is registry-backed — not "
                                 "available historically")
            return self.svcreg.columns(self.names)
        if subsys == fieldmaps.SUBSYS_SVCSUMM:
            # grouped after the merge: one host's services span shards
            cols, live_m = get(fieldmaps.SUBSYS_SVCSTATE)
            return api.svcsumm_from_svc(cols, live_m, self.names)
        if subsys == fieldmaps.SUBSYS_EXTSVCSTATE:
            if not (live or reg):
                raise ValueError("extsvcstate joins the live registry — "
                                 "not available historically")
            cols, live_m = get(fieldmaps.SUBSYS_SVCSTATE)
            info_cols, _ = self.svcreg.columns(self.names)
            return api.info_join(cols, live_m, info_cols)
        if subsys == fieldmaps.SUBSYS_SVCPROCMAP:
            if not (live or reg):
                raise ValueError("svcprocmap joins the live registry — "
                                 "not available historically")
            tcols, tlive = get(fieldmaps.SUBSYS_TASKSTATE)
            info_cols, _ = self.svcreg.columns(self.names)
            return api.svcprocmap_join(tcols, tlive, info_cols)
        if subsys in (fieldmaps.SUBSYS_SVCDEP, fieldmaps.SUBSYS_SVCMESH,
                      fieldmaps.SUBSYS_ACTIVECONN,
                      fieldmaps.SUBSYS_CLIENTCONN):
            # run_tick seeds __edgeset from the fleet rollup; a miss
            # pays the edge merge alone
            es = cache.get("__edgeset", lambda: self._edge_roll(dep))
            return self._dep_cols_from_edgeset(subsys, es, state, cache)
        if subsys == fieldmaps.SUBSYS_FLOWSTATE:
            ru = cache.get("__rollup", lambda: self._roll(state))
            k = min(128, int(ru.flow_topk.counts.shape[0]))
            f_hi, f_lo, f_bytes = (x.cpu().numpy()
                                   for x in topk.query(ru.flow_topk, k))
            cols = {
                "flowid": api._hex_id(f_hi, f_lo),
                "bytes": f_bytes,
                "evictedbytes": np.full(len(f_bytes),
                                        float(ru.flow_topk.evicted)),
            }
            return cols, f_bytes > 0
        if subsys == fieldmaps.SUBSYS_CLUSTERSTATE:
            return api.cluster_from_hosts(*get(fieldmaps.SUBSYS_HOSTSTATE))
        api.check_served(subsys)
        provider = api._COLUMNS_OF.get(subsys)
        if provider is None:
            raise ValueError(f"subsystem {subsys!r} is answered by the "
                             "runtime (ShardedRuntime.query)")
        parts = [provider(self.cfg, st, names=self.names) for st in state]
        if all(isinstance(p[0], LazyCols) for p in parts):
            # lazy groups concatenate on first reference: a query reads
            # only the groups its filter and sort name
            cols = merge_lazy([p[0] for p in parts],
                              widths=[len(p[1]) for p in parts])
        else:
            cols = {k: np.concatenate([p[0][k] for p in parts])
                    for k in parts[0][0]}
        mask = np.concatenate([np.asarray(p[1]) for p in parts])
        return cols, mask

    def _gathered_task_names(self, hi, lo, state):
        """Task-group caller names through every shard's task slab."""
        keys, comms, lives = [], [], []
        for st in state:
            k, c, lv = api._task_slab_arrays(st)
            keys.append(k)
            comms.append(c)
            lives.append(lv)
        return api.task_comm_names_from(
            self.names, np.concatenate(keys), np.concatenate(comms),
            np.concatenate(lives), hi, lo)

    def _dep_cols_from_edgeset(self, subsys: str, es, state, cache):
        def h(x):
            return x.cpu().numpy()

        if subsys in (fieldmaps.SUBSYS_ACTIVECONN,
                      fieldmaps.SUBSYS_CLIENTCONN):
            snap = {
                "e_live": h(table.live_mask(es.tbl)),
                "e_cli_hi": h(es.cli_hi), "e_cli_lo": h(es.cli_lo),
                "e_ser_hi": h(es.ser_hi), "e_ser_lo": h(es.ser_lo),
                "e_nconn": h(es.nconn), "e_bytes": h(es.byts),
                "e_cli_svc": h(es.cli_svc),
            }
            if subsys == fieldmaps.SUBSYS_CLIENTCONN:
                return api.clientconn_from_edges(
                    snap, self.names,
                    lambda hi, lo: self._gathered_task_names(hi, lo,
                                                             state))
            return api.activeconn_from_edges(snap, self.names)
        if subsys == fieldmaps.SUBSYS_SVCMESH:
            ntbl, labels, sizes = dg.mesh_clusters(
                es, 2 * es.nconn.shape[0])
            n_hi, n_lo = h(ntbl.key_hi), h(ntbl.key_lo)
            cols = {
                "svcid": api._hex_id(n_hi, n_lo),
                "svcname": api._names_of(self.names, wire.NAME_KIND_SVC,
                                         n_hi, n_lo),
                "clusterid": h(labels),
                "clustersize": h(sizes),
            }
            return cols, h(table.live_mask(ntbl))
        live = h(table.live_mask(es.tbl))
        cli_hi, cli_lo = h(es.cli_hi), h(es.cli_lo)
        ser_hi, ser_lo = h(es.ser_hi), h(es.ser_lo)
        cli_svc = h(es.cli_svc)
        svc_names = api._names_of(self.names, wire.NAME_KIND_SVC,
                                  cli_hi, cli_lo)
        task_names = self._gathered_task_names(cli_hi, cli_lo, state)
        cols = {
            "cliid": api._hex_id(cli_hi, cli_lo),
            "cliname": np.where(cli_svc, svc_names, task_names),
            "clisvc": cli_svc,
            "serid": api._hex_id(ser_hi, ser_lo),
            "sername": api._names_of(self.names, wire.NAME_KIND_SVC,
                                     ser_hi, ser_lo),
            "nconn": h(es.nconn),
            "bytes": h(es.byts),
        }
        return cols, live

    # ------------------------------------------------------- providers
    def heavy_recover(self) -> dict:
        """Cluster-wide heavy-hitter recovery: the rollup decodes every
        shard's invertible buckets, gathers the candidates and
        estimates each against the merged CMS; the host merges them
        with the merged exact top-K lanes (one read-back)."""
        self.flush()
        with self.stats.timeit("topk_recover"):
            ru = self._cols.get("__rollup", lambda: self._roll(self.state))
            rec = recover_rollup(self.cfg, ru)
        self.stats.bump("topk_recover_readbacks")
        new_hot = rec["hot"] - self._hh_prev_hot
        if new_hot:
            self.stats.bump("topk_hot_promotions", len(new_hot))
        self._hh_prev_hot = rec["hot"]
        self.stats.gauge("topk_recovered_keys", float(len(rec["recovered"])))
        self.stats.gauge("topk_evicted_mass", rec["evicted"])
        return {"flows": rec["flows"],
                "recovered_keys": len(rec["recovered"]),
                "evicted": rec["evicted"], "err_term": rec["err_term"],
                "total_mass": rec["total_mass"], "new_hot": len(new_hot)}

    def _traceuniq_columns(self):
        tcols, tlive = self._cached_columns(fieldmaps.SUBSYS_TRACEREQ)
        return api.traceuniq_from_trace(tcols, tlive)

    def _host_last_ticks(self, s: int, state=None) -> np.ndarray:
        """Shard ``s``'s ``host_last_tick``: a host has reported when
        its last tick is ≥ 0 (each shard's panel holds its own hosts)."""
        return self._shard_state(s, state).host_last_tick.cpu().numpy()

    def _hostlist_columns(self):
        """hostlist over the mesh: the seen rows of every shard's host
        panel (global ids), sorted by host id."""
        return self.hostlist_columns(self.state, self._tick_no)

    def hostlist_columns(self, state, tick: int):
        ids, age = [], []
        for s in range(self.n):
            last = self._host_last_ticks(s, state)
            seen = np.nonzero(last >= 0)[0]
            ids.append(seen)
            age.append(tick - last[seen])
        ids, age = np.concatenate(ids), np.concatenate(age)
        order = np.argsort(ids, kind="stable")
        ids, age = ids[order], age[order]
        cols = {
            "hostid": ids.astype(np.float64),
            "hostname": self.names.resolve_array(wire.NAME_KIND_HOST,
                                                 ids.astype(np.uint64)),
            "up": age <= api.DOWN_AFTER_TICKS,
            "lastseen": age.astype(np.float64),
        }
        return cols, np.ones(len(ids), bool)

    def nhosts_reported(self, state=None) -> int:
        """Hosts that have ever reported (disjoint across shards)."""
        return sum(int((self._host_last_ticks(s, state) >= 0).sum())
                   for s in range(self.n))

    def _serverstatus_columns(self):
        ru = self._cols.get("__rollup", lambda: self._roll(self.state))
        return self.serverstatus_columns(
            tick=self._tick_no, nhosts=self.nhosts_reported(),
            nsvc=float(ru.n_svc_live))

    def _shardlist_columns(self, state=None):
        """One row a shard (the madhavalist analogue): live rows, hosts,
        fold counters and drop diagnostics."""
        rows = []
        for s in range(self.n):
            st = self._shard_state(s, state)
            rows.append((float(s), float(st.tbl.n_live),
                         float((st.host_last_tick >= 0).sum()),
                         float(st.n_conn), float(st.n_resp),
                         float(st.task_tbl.n_live),
                         float(st.tbl.n_drop + st.task_tbl.n_drop)))
        names = ("shard", "nsvc", "nhosts", "nconn", "nresp", "ntaskrows",
                 "ndropped")
        cols = {k: np.array([r[i] for r in rows], np.float64)
                for i, k in enumerate(names)}
        return cols, np.ones(self.n, bool)

    # ----------------------------------------------------- snapshot tier
    def publish_snapshot(self) -> EngineSnapshot:
        """Freeze every shard's state and dependency graph (device
        clones) into an immutable :class:`EngineSnapshot` and swap it
        in; the merged-columns pipeline and the rollup serve the frozen
        lists unchanged."""
        self.snapshot = None
        with self.stats.timeit("snapshot_publish"):
            state, dep = sharded.clone(self.state), sharded.clone(self.dep)
        self._snap_version += 1
        self.snapshot = EngineSnapshot(
            self, state, dep, tick=self._tick_no,
            published_at=self._clock(), version=self._snap_version)
        self.stats.bump("snapshots_published")
        self.stats.gauge("snapshot_tick", float(self._tick_no))
        self.stats.gauge("snapshot_age_seconds", 0.0)
        return self.snapshot

    # ------------------------------------------------------------ cadence
    def _shard_rate_gauges(self) -> None:
        """Per-shard fold rates and staged-slab occupancy at tick
        cadence (host-side counters, no device read-back)."""
        now = self._clock()
        dt = max(now - self._shard_rate_t, 1e-9)
        delta = self._shard_events - self._shard_rate_mark
        cap = max(1, self.cfg.fold_k
                  * (self.cfg.conn_batch + self.cfg.resp_batch))
        for s in range(self.n):
            self.stats.gauge(f"shard_fold_ev_per_sec|shard={s}",
                             round(float(delta[s]) / dt, 1))
        for s in range(self.n):
            occ = (self._conn_staged[s] + self._resp_staged[s]) / cap
            self.stats.gauge(f"shard_stage_occupancy|shard={s}",
                             round(occ, 4))
        self._shard_rate_t = now
        self._shard_rate_mark = self._shard_events.copy()

    def engine_health(self, vec=None) -> dict:
        """Cluster-wide health gauges (sums over every shard, max stage
        pressure) into ``self.stats``; ``run_tick`` passes the fleet
        rollup's vector, a scrape between ticks reads one back."""
        if vec is None:
            vec = rollup.health_merge(
                [step.engine_health_vec(self.cfg, st, d)
                 for st, d in zip(self.state, self.dep)]).cpu().numpy()
        gauges = obs_health.gauges_from_vec(
            vec, obs_health.capacities(self.cfg, self.opts,
                                       n_shards=self.n))
        gauges["native_decode_available"] = 1.0 if self._native else 0.0
        if self.journal is not None:
            gauges.update(self.journal.gauges())
        for k, v in gauges.items():
            self.stats.gauge(k, v)
        return gauges

    def _run_tick(self) -> dict:
        """Close one 5s window on every shard → the tick report: digest
        drain, classify, snapshot publish, the fleet rollup over the
        frozen snapshot (seeding both column caches), heavy-hitter
        recovery, the alert check, health and drop pressure, the window
        tick and ageing, dependency and registry ageing, the history
        sweep, the journal's poll and checkpoints."""
        report = {}
        self.flush()
        if self._td_dirty:
            self.td_drain(max_iters=self.opts.td_drain_iters_per_tick)
        self.state = sharded.classify_sharded(self.cfg, self.state)
        self._cols.bump()
        snap = self.publish_snapshot()
        t_ru = self._clock()
        with self.stats.timeit("rollup"):
            fv = self._fleet_roll(snap.state, snap.dep)
            health_vec = fv.health.cpu().numpy()
        self.stats.gauge("rollup_seconds", round(self._clock() - t_ru, 6))
        for cache in (snap._cols, self._cols):
            cache.get("__rollup", lambda: fv.rollup)
            cache.get("__edgeset", lambda: fv.edges)
        ev = self.opts.hh_recover_every_ticks
        if ev and self.cfg.hh_width > 0 \
                and (self._tick_no + 1) % ev == 0:
            report["topk_recovered"] = self._cols.get(
                "__hh_recover", self.heavy_recover)["recovered_keys"]
        if self.alerts.wants_realtime():
            fired = self.alerts.check(None, columns_fn=snap.columns)
        else:
            self.stats.bump("alert_eval_skipped")
            fired = self.alerts.flush_groups()
        report["alerts_fired"] = len(fired)
        for a in fired:
            self.notifylog.add_alert(a)
        self._tick_no += 1
        tick = self._tick_no
        report["tick"] = tick
        health = self.engine_health(vec=health_vec)
        self._shard_rate_gauges()
        self._last_drops = droppressure.check(
            obs_health.drops_for_pressure(health),
            {"svc": self.cfg.svc_capacity,
             "task": self.cfg.task_capacity,
             "api": self.cfg.api_capacity,
             "dep": self.opts.dep_pair_capacity},
            self._last_drops, self.notifylog, self.stats)
        self.state = sharded.tick_5s_sharded(self.cfg, self.state)
        if tick % self.opts.task_age_every_ticks == 0:
            self.state = sharded.age_tasks_sharded(
                self.cfg, self.state, self.opts.task_max_age_ticks)
            self.state = sharded.age_apis_sharded(
                self.cfg, self.state, self.opts.api_max_age_ticks)
        self.dep = [dg.age(d, tick, self.opts.dep_pair_ttl_ticks,
                           self.opts.dep_edge_ttl_ticks) for d in self.dep]
        with self._reg_lock:      # ageing mutates what renders iterate
            self.cgroups.age()
            self.mounts.age()
            self.netifs.age()
            self.natclusters.age()
            self.traceconns.age()
        if (self.history is not None
                and tick % self.opts.history_every_ticks == 0):
            report["history_rows"] = self._history_sweep(snap)
        # db-mode alertdefs run after the history write, so a due def
        # sees this very tick's sweep
        if self.history is not None and self.alerts.wants_db():
            self._histwriter.barrier()
            fired = self.alerts.check_db(self.history)
            report["alerts_fired"] += len(fired)
            for a in fired:
                self.notifylog.add_alert(a)
        if self.journal is not None:
            self.journal.poll()
        if (self.opts.checkpoint_dir
                and tick % self.opts.checkpoint_every_ticks == 0):
            extra = J.checkpoint_extra(self, tick)
            path = ckpt.save(
                f"{self.opts.checkpoint_dir}/gyt_ckpt_{tick:08d}.npz",
                self.cfg, self.state, extra=extra)
            J.post_checkpoint_truncate(self, extra)
            report["checkpoint"] = str(path)
            self.stats.bump("checkpoints")
        self._cols.bump()
        return report

    # ------------------------------------------------------ engine leaves
    def leaves(self) -> tuple:
        """``(state, dep)`` as the reference's stacked ``(n_shards,
        ...)`` leaves."""
        return sharded.state_to_numpy(self.state), \
            sharded.dep_to_numpy(self.dep)

    def load_leaves(self, state_leaves, dep_leaves) -> None:
        """Re-seed every shard from :meth:`leaves`' stacked form."""
        self.state = sharded.state_from_numpy(
            ckpt.fit_leaves(state_leaves, self.state, "shard"), self.mesh)
        self.dep = sharded.dep_from_numpy(
            ckpt.fit_leaves(dep_leaves, self.dep, "shard"), self.mesh)
        self._pressure = None

    def delta_leaves(self) -> dict:
        """The monotone loghist leaves, shard-major, as the stacked leaf
        reads."""
        return {name: np.concatenate([WQ.leaf_of(st, name)
                                      for st in self.state])
                for name in WQ.DELTA_SPECS}

    def task_panel(self) -> tuple:
        """Every slab row of every shard, shard-major."""
        parts = [api.task_columns(self.cfg, st, names=self.names,
                                  live_only=False) for st in self.state]
        return ({k: np.concatenate([p[0][k] for p in parts])
                 for k in parts[0][0]},
                np.concatenate([np.asarray(p[1]) for p in parts]))

    # -------------------------------------------------- restore/recovery
    def restore(self, path) -> dict:
        """Restore a checkpoint of this mesh's geometry (the stacked
        ``(n_shards, ...)`` leaves of either package): staged records
        and partial-frame bytes are dropped, the dependency graphs are
        re-initialised (they are not checkpointed), and the tick and
        sweep marks realign to the checkpoint's."""
        self._conn_raw = [[] for _ in range(self.n)]
        self._resp_raw = [[] for _ in range(self.n)]
        self._conn_staged = [0] * self.n
        self._resp_staged = [0] * self.n
        self._n_conn_raw = self._n_resp_raw = 0
        self._pending = b""
        self._cols.bump()
        self._td_dirty = True
        self._pressure = None
        self.state, extra = ckpt.restore(path, self.cfg, self.state)
        self.dep = sharded.dep_init_sharded(
            self.mesh, self.opts.dep_pair_capacity,
            self.opts.dep_edge_capacity)
        self._tick_no = int(extra.get("tick", 0))
        self._sweep_last_seq = {
            int(k): int(v)
            for k, v in extra.get("sweep_seq", {}).items()}
        if self.snapshot is not None:
            self.publish_snapshot()
        return extra

    def rollup_stats(self) -> dict:
        """Cluster totals (the MS_CLUSTER_STATE analogue)."""
        self.flush()
        ru = self._roll(self.state)
        return {"n_conn": float(ru.n_conn), "n_resp": float(ru.n_resp),
                "n_svc_live": float(ru.n_svc_live),
                "n_hosts_up": float(ru.n_hosts_up)}


