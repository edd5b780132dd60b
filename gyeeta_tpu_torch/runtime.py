"""Runtime: the aggregation-server loop of the port.

Counterpart of ``gyeeta_tpu/runtime.py`` on its default fused-fold
path: ``feed()`` takes byte streams (deframed and decoded by the native
C++ path of ``ingest/native`` unless ``deframe="python"`` asks for the
numpy one, bit for bit the same records and columns),
stages raw conn/resp records, sweep sections and edge pre-aggregated
SKETCH_DELTA records on the host and folds them in one ``fold_all``
dispatch per feed boundary, and keeps the announce-rate records
(listener, host, cgroup, mount and interface inventories, traced
connections, VIP clusters) in host-side registries; ``run_tick()``
closes a 5s window (digest drain, classification, snapshot publish,
heavy-hitter recovery, the alert check, dependency-graph and registry
ageing, the history sweep and db-mode alertdefs, health readback and
drop pressure, window tick, ageing and compaction cadences, the
journal's poll, checkpoints); ``query()`` answers the JSON query API on
the strong path (staged events are folded first, the live state is
read) or, with ``consistency="snapshot"``, from the last published
:class:`~gyeeta_tpu_torch.query.snapshot.EngineSnapshot`; it also
serves ``multiquery`` batches, the ``selfstats`` and ``metrics``
subsystems and the CRUD channel (``"op"`` requests: alertdefs,
silences, inhibits, actions, tags, tracedefs).

History (``history/``): with ``journal_dir`` every accepted byte run
appends to the write-ahead journal before its fold
(:meth:`Runtime.replay_journal` re-folds it after a ``restore``); with
``history_db`` the tick renders its history sweep and a writer thread
stores it; with ``hist_shard_dir`` the ``at=``/``window=`` request
forms (and ``tstart``/``tend`` without a ``history_db``) are served
from the shards a :class:`~gyeeta_tpu_torch.history.compactor.Compactor`
writes.

The state lives on ``device`` — CUDA unless the caller asks for the
CPU, and a GPU-less machine raises (``device.resolve``).

Host↔device crossings of a feed: the conn/resp slab is decoded into one
of two pinned staging buffers, flipped each slab dispatch, and copied
to the device without blocking; the buffer's copy event is waited on
before the host decodes into it again, two dispatches later. The
section columns go to the device once per dispatch; the digest-stage
pressure of the dispatch two back is read (``int()``, a sync) before
each dispatch, exactly the reference's lag, because the timing of
``td_flush_partial`` changes the digest state; the tick number goes to
``fold_all`` as a host int, which it fills on the device.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from gyeeta_tpu_torch import version as V
from gyeeta_tpu_torch.alerts import AlertManager, columns as AC
from gyeeta_tpu_torch.device import resolve
from gyeeta_tpu_torch.engine import aggstate, compact, step
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.history import open_store, winquant as WQ
from gyeeta_tpu_torch.history.histwriter import HistoryWriter
from gyeeta_tpu_torch.history.shards import open_shard_store
from gyeeta_tpu_torch.history.timeview import TimeView, route_historical
from gyeeta_tpu_torch.ingest import decode, native, wire
from gyeeta_tpu_torch.obs import health as obs_health
from gyeeta_tpu_torch.obs.spans import FoldProfiler, SpanTracer
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.query import api, crud
from gyeeta_tpu_torch.query.snapshot import EngineSnapshot, recover
from gyeeta_tpu_torch.semantic import derive
from gyeeta_tpu_torch.trace.defs import TraceDefs
from gyeeta_tpu_torch.utils import checkpoint as ckpt
from gyeeta_tpu_torch.utils import dnsmap, droppressure
from gyeeta_tpu_torch.utils import journal as J
from gyeeta_tpu_torch.utils.colcache import ColumnCache
from gyeeta_tpu_torch.utils.config import RuntimeOpts
from gyeeta_tpu_torch.utils.hostreg import CgroupRegistry, \
    HostInfoRegistry, MountRegistry, NetIfRegistry
from gyeeta_tpu_torch.utils.intern import InternTable
from gyeeta_tpu_torch.utils.natreg import NatClusterRegistry
from gyeeta_tpu_torch.utils.notifylog import NotifyLog
from gyeeta_tpu_torch.utils.selfstats import Stats
from gyeeta_tpu_torch.utils.svcreg import SvcInfoRegistry
from gyeeta_tpu_torch.utils.tagreg import TagRegistry
from gyeeta_tpu_torch.utils.traceconnreg import TraceConnRegistry
from gyeeta_tpu_torch.utils.tensor import tree_map

# a native resp stream is "live" for bridge-suppression purposes if it
# reported within this many base ticks (2 min at 5s)
_RESP_FRESH_TICKS = 24


def _slab_lanes() -> dict:
    """Per-section lane capacities of the fused fold slab: 1-2 wire-max
    batches a section, and the drain chunk of SKETCH_DELTA records (each
    expands into its per-family payload lanes on the host) — the
    reference's defaults."""
    return {
        "listener": 2 * wire.MAX_LISTENERS_PER_BATCH,
        "host": wire.MAX_HOSTS_PER_BATCH,
        "task": 2 * wire.MAX_TASKS_PER_BATCH,
        "cpumem": wire.MAX_CPUMEM_PER_BATCH,
        "trace": wire.MAX_TRACE_PER_BATCH,
        "ping": wire.MAX_PINGS_PER_BATCH,
        "delta": decode.DELTA_LANES_DEFAULT,
    }


# fused-slab section plumbing: selfstats counter, wire subtype (for the
# raw-backlog concat dtype) and columnar builder per device-fold kind
_SECTION_COUNTERS = {
    "listener": "listener_records", "host": "host_records",
    "task": "task_records", "ping": "task_pings",
    "cpumem": "cpumem_records", "trace": "trace_records",
    "delta": "preagg_delta_records",
}
_SECTION_SUBTYPES = {
    "listener": wire.NOTIFY_LISTENER_STATE, "host": wire.NOTIFY_HOST_STATE,
    "task": wire.NOTIFY_AGGR_TASK_STATE, "ping": wire.NOTIFY_TASK_PING,
    "cpumem": wire.NOTIFY_CPU_MEM_STATE, "trace": wire.NOTIFY_REQ_TRACE,
    "delta": wire.NOTIFY_SKETCH_DELTA,
}
_SECTION_BUILDERS = {
    "listener": decode.listener_batch_fast, "host": decode.host_batch_fast,
    "task": decode.task_batch_fast, "ping": decode.ping_batch,
    "cpumem": decode.cpumem_batch_fast,
}   # each bound per runtime to its stats and decode path; + "trace"
#     (numpy on both paths) and "delta" (bound to the geometry)

# announce-rate record kinds → (registry attribute, selfstats counter)
_REGISTRY_KINDS = {
    "listener_info": ("svcreg", "listener_infos"),
    "host_info": ("hostinfo", "host_infos"),
    "cgroup": ("cgroups", "cgroup_records"),
    "mount": ("mounts", "mount_records"),
    "netif": ("netifs", "netif_records"),
}

# agent delivery-continuity fields of AGENT_STATS → server counters
_AGENT_STATS_COUNTERS = (
    ("spool_dropped", "spool_dropped"),
    ("spool_dropped_records", "spool_dropped_records"),
    ("spool_resent", "spool_resent"),
    ("connect_timeouts", "agent_connect_timeouts"))


class Runtime:
    def __init__(self, cfg: Optional[EngineCfg] = None,
                 opts: Optional[RuntimeOpts] = None, clock=None,
                 device=None, deframe: str = "native",
                 profiler: Optional[FoldProfiler] = None):
        self.device = resolve(device)
        self._init_host(cfg, opts, clock, deframe, profiler)
        self.state = aggstate.init(self.cfg, self.device)
        # pressure scalars of recent dispatches, read at lag 2
        self._pressures: deque = deque()
        self.dep = dg.init(self.opts.dep_pair_capacity,
                           self.opts.dep_edge_capacity, self.device)
        self._slab_lanes_cfg = _slab_lanes()
        self._sect_builders = self._section_builders()
        # per-section raw record backlogs that ride the next fold_all
        # dispatch (drained at the end of every ingest_records call)
        self._stage_recs = {k: [] for k in self._slab_lanes_cfg}
        self._stage_n = {k: 0 for k in self._slab_lanes_cfg}
        # conn/resp stage RAW record arrays; they decode once per slab
        self._conn_raw: list = []
        self._resp_raw: list = []
        self._n_conn_raw = 0
        self._n_resp_raw = 0
        # double-buffered conn/resp staging slabs (pinned on CUDA): the
        # host decodes into the idle buffer while the copies out of the
        # other may still be in flight; "copied" is that buffer's copy
        # event, waited on before the next decode into it
        K = self.cfg.fold_k
        pin = self.device.type == "cuda"
        self._slab_bufs = [
            {"conn": decode.alloc_conn_cols(K * self.cfg.conn_batch, pin),
             "resp": decode.alloc_resp_cols(K * self.cfg.resp_batch, pin),
             "hw_conn": 0, "hw_resp": 0, "copied": None}
            for _ in range(2)]
        self._slab_active = 0

    def _init_host(self, cfg, opts, clock, deframe: str,
                   profiler=None) -> None:
        """The host side of a runtime, shared with the sharded one: the
        decode path, configuration, counters, the fold profiler, the
        alert manager, the relational history, the journal and the
        time-travel tier, the registries and the providers of the
        runtime-answered views."""
        # the host decode path: the native C++ deframer and columnar
        # decoders (built at first use; a failed build raises), or the
        # numpy path the tests hold it against
        if deframe not in ("native", "python"):
            raise ValueError(f"deframe must be 'native' or 'python', "
                             f"got {deframe!r}")
        self.deframe = deframe
        self._native = deframe == "native"
        if self._native:
            native.lib()
        self.cfg = cfg or EngineCfg()
        self.opts = opts or RuntimeOpts()
        self.stats = Stats()
        self.spans = SpanTracer()     # pipeline span ring (selfstats)
        # opt-in torch.profiler bracket of the first fold dispatches
        self._profiler = profiler if profiler is not None \
            else FoldProfiler()
        self.alerts = AlertManager(self.cfg, clock=clock)
        # relational history: run_tick renders the sweep on this thread
        # and a single writer thread stores it (reads that need their
        # writes, db-mode alertdefs and tstart/tend queries, barrier())
        self.history = (open_store(self.opts.history_db)
                        if self.opts.history_db else None)
        self._histwriter = (HistoryWriter(
            self.history, stats=self.stats,
            max_queue=self.opts.history_queue_max)
            if self.history is not None else None)
        # wall clock of the snapshot tier's freshness gauges
        self._clock = clock or time.time
        # write-ahead event journal: every accepted byte run appends
        # after validation, before the fold
        self.journal = self._make_journal(clock) \
            if self.opts.journal_dir else None
        self._journal_replaying = False
        # time-travel tier: at=/window= requests materialize compaction
        # shards. The journal's truncate floor starts at the compactor's
        # durable position, so checkpoints never delete unconsumed
        # segments.
        self.timeview = None
        if self.opts.hist_shard_dir:
            store = open_shard_store(self.opts.hist_shard_dir,
                                     stats=self.stats)
            self.timeview = TimeView(self, store, clock=clock)
            if self.journal is not None:
                pos = store.position()
                fl = J.floors_of(pos) if pos else 0
                if isinstance(fl, list) \
                        and not hasattr(self.journal, "shards"):
                    fl = min(fl) if fl else 0
                self.journal.set_truncate_floor(fl)
        # per-host sweep-seq high-water marks (NOTIFY_SWEEP_SEQ),
        # checkpointed
        self._sweep_last_seq: dict[int, int] = {}
        self._tick_no = 0             # host-side mirror of the window tick
        self._pending = b""           # partial-frame resume buffer
        # set inside feed_batch: the end-of-ingest fold boundary moves
        # to the end of the batch
        self._defer_dispatch = False
        # last tick each host sent a native RESP_SAMPLE: the trace→resp
        # bridge skips hosts with a recent native stream
        self._host_resp_tick = np.full(self.cfg.n_hosts, -(10 ** 9),
                                       np.int64)
        self._td_dirty = False        # digest stage may be non-empty
        self._cols = ColumnCache()    # version-keyed column memo
        # recovered-hot keys of the previous recovery (promotions count
        # keys newly recovered at/above the hot threshold)
        self._hh_prev_hot: set = set()
        self.snapshot = None          # last published EngineSnapshot
        self._snap_version = 0
        # registry renders run on query threads in snapshot mode while
        # updates run on the feed loop: the lock keeps dict iteration
        # away from structural mutation
        self._reg_lock = threading.RLock()
        self.names = InternTable()
        self.svcreg = SvcInfoRegistry()
        self.hostinfo = HostInfoRegistry()
        self.cgroups = CgroupRegistry()
        self.mounts = MountRegistry()
        self.netifs = NetIfRegistry()
        self.natclusters = NatClusterRegistry()
        self.traceconns = TraceConnRegistry()
        self.tags = TagRegistry()
        self.dns = dnsmap.DnsCache()
        self.notifylog = NotifyLog(clock=clock)
        self.tracedefs = TraceDefs(clock=clock)
        self._last_drops: dict = {}   # drop-pressure counters, last tick
        self._t_started = self._clock()
        self._aux = {
            "topk": self._topk_columns,
            "tracedef": lambda: self.tracedefs.columns(),
            "tracestatus": lambda: self.tracedefs.columns(),
            "traceuniq": self._traceuniq_columns,
            "traceconn": lambda: self.traceconns.columns(
                self.names, svc_task_ids=self._svc_task_ids()),
            "extactiveconn": lambda: self._ext_join("activeconn"),
            "extclientconn": lambda: self._ext_join("clientconn",
                                                    idcol="cliid"),
            "exttracereq": lambda: self._ext_join("tracereq"),
            "hostinfo": lambda: self.hostinfo.columns(self.names),
            "cgroupstate": lambda: self.cgroups.columns(self.names),
            "mountstate": lambda: self.mounts.columns(self.names),
            "netif": lambda: self.netifs.columns(self.names),
            "alerts": lambda: AC.alerts_columns(self.alerts),
            "alertdef": lambda: AC.alertdef_columns(self.alerts),
            "silences": lambda: AC.silences_columns(self.alerts),
            "inhibits": lambda: AC.inhibits_columns(self.alerts),
            "actions": lambda: AC.actions_columns(self.alerts),
            "notifymsg": lambda: self.notifylog.columns(self.names),
            "hostlist": self._hostlist_columns,
            "serverstatus": self._serverstatus_columns,
            "svcipclust": lambda: dnsmap.annotate_vip_cols(
                self.natclusters.columns(self.names), self.dns),
            "tags": lambda: self.tags.columns(),
        }

    def _make_journal(self, clock):
        """The write-ahead journal of ``opts.journal_dir``."""
        return J.Journal(
            self.opts.journal_dir,
            segment_max_bytes=self.opts.journal_segment_mb << 20,
            fsync_bytes=self.opts.journal_fsync_kb << 10,
            fsync_ms=self.opts.journal_fsync_ms,
            backlog_max_bytes=self.opts.journal_backlog_mb << 20,
            stats=self.stats, clock=clock)

    def _section_builders(self) -> dict:
        """Columnar builder a sweep-section kind, bound to this
        runtime's counters, decode path and delta geometry (delta
        payload indices outside it are dropped and counted at decode,
        never scattered out of range)."""
        dims = dict(resp_nbuckets=self.cfg.resp_spec.nbuckets,
                    hll_m_svc=1 << self.cfg.hll_p_svc,
                    hll_m_glob=1 << self.cfg.hll_p_global)
        out = {k: functools.partial(fn, stats=self.stats,
                                    native=self._native)
               for k, fn in _SECTION_BUILDERS.items()}
        out["trace"] = decode.trace_batch
        out["delta"] = lambda r, sz: decode.delta_batch(
            r, sz, stats=self.stats, **dims)
        return out

    # ------------------------------------------------------------- ingest
    def feed(self, buf: bytes, hid: int = 0, conn_id: int = 0) -> int:
        """Ingest a byte stream (any number of frames, any mix of types)
        → records accepted. A trailing partial frame is kept for the
        next call. ``hid`` / ``conn_id`` attribute the bytes in the
        write-ahead journal (direct feeds default to 0)."""
        data = (self._pending + buf) if self._pending else buf
        try:
            with self.stats.timeit("deframe"), \
                    self.spans.span("deframe", nrec=len(data),
                                    path=self.deframe):
                recs, consumed, unknown = self.drain2(data)
        except wire.FrameError:
            self.stats.bump("frames_bad")
            self._pending = b""       # poison frame: drop buffer, resync
            raise
        self._pending = data[consumed:]
        # WAL append after validation, before the fold: exactly the
        # bytes drain2 accepted (a pending partial frame journals in the
        # call that completes it). Replay suppresses the append.
        if (consumed and self.journal is not None
                and not self._journal_replaying):
            self.journal.append(data[:consumed], hid=hid,
                                conn_id=conn_id, tick=self._tick_no)
        if unknown:
            # skipped unknown-subtype frames: accounted loss
            self.stats.bump("records_unknown_subtype", unknown)
        return self.ingest_records(recs)

    def feed_batch(self, pieces) -> list:
        """Feed several buffers of complete frames — ``(buf, hid,
        conn_id)`` each, several conns' — with ONE fold boundary, at the
        end of the batch, instead of one a buffer (sections that would
        overflow their lanes still dispatch on the way). Each buffer is
        deframed, validated and journaled on its own, so a failure is
        attributed to its conn: → one entry a piece, the records it
        accepted or the exception it raised. A ``wire.FrameError`` fails
        its piece alone; any other failure ends the batch there: that
        piece and the ones after it get the exception, the pieces before
        it stand, and a failure of the closing fold boundary goes to the
        last piece taken (whose feed would have carried it alone). Fold
        semantics are those of one feed of the joined buffers (what a
        conn whose reads TCP coalesced gives); the serving edge batches
        the conns ready in one loop iteration this way: a feed a sweep
        costs a dispatch of the sweep sections, which hundreds of small
        agents cannot afford."""
        out: list = []
        self._defer_dispatch = True
        try:
            for i, (buf, hid, conn_id) in enumerate(pieces):
                try:
                    out.append(self.feed(buf, hid=hid, conn_id=conn_id))
                except wire.FrameError as e:
                    out.append(e)
                except Exception as e:     # noqa: BLE001 — attributed
                    out.extend([e] * (len(pieces) - i))
                    break
        finally:
            self._defer_dispatch = False
        try:
            self._dispatch_fused_pending()
        except Exception as e:             # noqa: BLE001 — attributed
            taken = [i for i, r in enumerate(out)
                     if not isinstance(r, BaseException)]
            if not taken:
                raise
            out[taken[-1]] = e
        return out

    def drain2(self, data: bytes) -> tuple[dict, int, int]:
        """This runtime's deframe (``native.drain2`` or
        ``wire.drain2``) → (records by subtype, consumed, unknown)."""
        return (native.drain2(data) if self._native
                else wire.drain2(data))

    def ingest_records(self, recs: dict) -> int:
        """Fold a drained {subtype: record array} dict (the post-
        deframe half of :meth:`feed`; the feed pipeline's decode worker
        hands these over, ``ingest/pipeline.py``)."""
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
            elif kind in _REGISTRY_KINDS:
                reg, ctr = _REGISTRY_KINDS[kind]
                with self._reg_lock:
                    self.stats.bump(ctr,
                                    getattr(self, reg).update(chunks[0]))
                n += len(chunks[0])
            elif kind == "agent_stats":
                # agent delivery-continuity deltas → server counters
                for fld, ctr in _AGENT_STATS_COUNTERS:
                    tot = int(chunks[0][fld].sum())
                    if tot:
                        self.stats.bump(ctr, tot)
            elif kind == "names":
                # names are not telemetry events, but resolved names are
                # part of every view
                with self._reg_lock:
                    self.stats.bump("names_interned",
                                    self.names.update(chunks[0]))
                self._cols.bump()
        if not self._defer_dispatch:
            self._dispatch_fused_pending()
        if n:
            self._cols.bump()
        return n

    def _observe_trace(self, recs) -> None:
        """Host half of the trace fold: the traced-connection registry
        and the trace→resp bridge, with per-host native-stream
        precedence (hosts with a recent native RESP_SAMPLE stream are
        not bridged)."""
        with self._reg_lock:
            self.traceconns.observe(recs)
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

    def _take_connresp(self, k: int, buf=None):
        """Decode up to ``k`` microbatches of the staged conn/resp
        records into one ``(k, B)`` slab → (conn slab, resp slab,
        records taken). ``buf``: a staging-slab buffer to decode into
        (its previous copies to the device have landed)."""
        crecs, nc = decode.take_raw_chunks(self._conn_raw,
                                           k * self.cfg.conn_batch)
        rrecs, nr = decode.take_raw_chunks(self._resp_raw,
                                           k * self.cfg.resp_batch)
        self._n_conn_raw -= nc
        self._n_resp_raw -= nr
        kw = dict(stats=self.stats, native=self._native)
        if buf is None:
            return (decode.conn_slab(crecs, k, self.cfg.conn_batch, **kw),
                    decode.resp_slab(rrecs, k, self.cfg.resp_batch, **kw),
                    nc, nr)
        cbs = decode.conn_slab(crecs, k, self.cfg.conn_batch,
                               out=buf["conn"], clear_to=buf["hw_conn"],
                               **kw)
        rbs = decode.resp_slab(rrecs, k, self.cfg.resp_batch,
                               out=buf["resp"], clear_to=buf["hw_resp"],
                               **kw)
        buf["hw_conn"], buf["hw_resp"] = nc, nr
        return cbs, rbs, nc, nr

    def _flip_slab_buf(self) -> dict:
        """The idle staging-slab buffer, made the active one; waits for
        its copies of two dispatches back to leave it."""
        buf = self._slab_bufs[self._slab_active]
        self._slab_active ^= 1
        self.stats.bump("stage_slab_flips")
        if buf["copied"] is not None:
            buf["copied"].synchronize()
            buf["copied"] = None
        return buf

    def _dispatch_fused(self, connresp=None) -> None:
        """One fused device dispatch: the staged sections, optionally
        the conn/resp slab (``connresp``: None, "slab" = ``(K, B)``, or
        "single" = ``(1, B)``, the flush shape), the dependency fold
        and the digest-stage pressure scalar."""
        sections = {}
        nc = nr = 0
        buf = None
        with self.stats.timeit("decode"):
            for kind in self._slab_lanes_cfg:
                if self._stage_n[kind]:
                    recs = decode._concat_chunks(
                        self._stage_recs[kind],
                        wire.DTYPE_OF_SUBTYPE[_SECTION_SUBTYPES[kind]])
                    sections[kind] = self._sect_builders[kind](
                        recs, self._slab_lanes_cfg[kind])
                    self._stage_recs[kind] = []
                    self._stage_n[kind] = 0
            if connresp == "slab":
                K = self.cfg.fold_k
                buf = self._flip_slab_buf()
                cbs, rbs, nc, nr = self._take_connresp(K, buf)
                # host-side staging gauges: slab fill at dispatch
                self.stats.gauge("engine_stage_slab_conn_occupancy",
                                 round(nc / (K * self.cfg.conn_batch), 4))
                self.stats.gauge("engine_stage_slab_resp_occupancy",
                                 round(nr / (K * self.cfg.resp_batch), 4))
                sections["connresp"] = (cbs, rbs)
                self.stats.bump("slab_dispatches")
            elif connresp == "single":
                cbs, rbs, nc, nr = self._take_connresp(1)
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
        with self.stats.timeit("fold_dispatch"), \
                self.spans.span("decode_fold", nrec=nc + nr,
                                path=self.deframe), \
                self._profiler.fold(self.device):
            staged = buf is not None
            secs = {k: (decode.to_device(sections[k][0], self.device,
                                         staged=staged),
                        decode.to_device(sections[k][1], self.device,
                                         staged=staged))
                    if k == "connresp"
                    else decode.to_device(sections[k], self.device)
                    for k in names}
            if staged and self.device.type == "cuda":
                buf["copied"] = torch.cuda.Event()
                buf["copied"].record()
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
        # decode-path gauge: the native deframer and decoders in use
        gauges["native_decode_available"] = 1.0 if self._native else 0.0
        # WAL health: fsync lag (the RPO bound), pending bytes, segments
        if self.journal is not None:
            gauges.update(self.journal.gauges())
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
            rec = recover(self.cfg, self.state)
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

    def _topk_columns(self):
        """topk columns: heavy flows (exact ∪ recovered) and the dense
        service/API rankings; recovery memoized per state version."""
        rec = self._cols.get("__hh_recover", self.heavy_recover)
        return api.heavy_topk_columns(
            rec["flows"], svc=self._cached_columns("svcstate"),
            trace=self._cached_columns("tracereq"))

    # ----------------------------------------------------- snapshot tier
    def publish_snapshot(self) -> EngineSnapshot:
        """Freeze the current engine view into an immutable
        :class:`EngineSnapshot` and swap it in: every ``AggState`` and
        ``DepGraph`` leaf cloned on the device (the folds write the live
        tensors in place, so a view would change under the next feed).
        Called once a tick, after classification, and on ``restore``.
        The replaced snapshot is dropped before the copy, so a publish
        holds two copies of the state, not three, unless a caller still
        holds the old one."""
        self.snapshot = None
        with self.stats.timeit("snapshot_publish"):
            state = tree_map(torch.clone, self.state)
            dep = tree_map(torch.clone, self.dep)
        self._snap_version += 1
        self.snapshot = EngineSnapshot(
            self, state, dep, tick=self._tick_no,
            published_at=self._clock(), version=self._snap_version)
        self.stats.bump("snapshots_published")
        self.stats.gauge("snapshot_tick", float(self._tick_no))
        self.stats.gauge("snapshot_age_seconds", 0.0)
        return self.snapshot

    # ------------------------------------------------------------ cadence
    def run_tick(self) -> dict:
        with self.stats.timeit("tick"), self.spans.span(
                "tick", nrec=self._tick_no):
            return self._run_tick()

    def _run_tick(self) -> dict:
        """Close one 5s window → the tick report. The snapshot
        dashboards read for the next window is published right after
        classification; the alert check and the history sweep read
        their columns through it, which pre-warms them for the queries
        of the window."""
        self.flush()
        if self._td_dirty:    # tick-cadence digest compression (bounded)
            self.td_drain(max_iters=self.opts.td_drain_iters_per_tick)
        report = {}
        self.state = derive.classify_pass(self.cfg, self.state)
        self._cols.bump()             # classify + tick mutate views
        snap = self.publish_snapshot()
        ev = self.opts.hh_recover_every_ticks
        if ev and self.cfg.hh_width > 0 \
                and (self._tick_no + 1) % ev == 0:
            report["topk_recovered"] = self._cols.get(
                "__hh_recover", self.heavy_recover)["recovered_keys"]
        fired = self._alert_step(snap)
        tick = int(self.state.resp_win.tick) + 1
        report["tick"] = tick
        self._tick_no = tick
        self.stats.gauge("tick", tick)
        self.dep = dg.age(self.dep, tick, self.opts.dep_pair_ttl_ticks,
                          self.opts.dep_edge_ttl_ticks)
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
            fired += self.alerts.check_db(self.history)
        report["alerts_fired"] = len(fired)
        for a in fired:
            self.notifylog.add_alert(a)
        self._drop_pressure_step()
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
        # fsync cadence backstop: a quiet wire must not hold journal
        # bytes unsynced past a tick
        if self.journal is not None:
            self.journal.poll()
        if (self.opts.checkpoint_dir
                and tick % self.opts.checkpoint_every_ticks == 0):
            extra = J.checkpoint_extra(self, tick)
            path = ckpt.save(
                f"{self.opts.checkpoint_dir}/gyt_ckpt_{tick:08d}.npz",
                self.cfg, self.state, extra=extra)
            # the checkpoint supersedes older WAL segments: drop them
            J.post_checkpoint_truncate(self, extra)
            report["checkpoint"] = str(path)
            self.stats.bump("checkpoints")
        self._cols.bump()
        return report

    def _history_sweep(self, snap) -> int:
        """Render the relational history sweep through ``snap``'s
        columns on this thread and hand it to the writer thread → rows
        written (the clusterstate row included)."""
        now = self._clock()
        n = getattr(self, "n", 1)     # shards: a slab each
        limits = (("svcstate", n * self.cfg.svc_capacity),
                  ("hoststate", self.cfg.n_hosts), ("clusterstate", None),
                  ("taskstate", n * self.cfg.task_capacity),
                  ("cpumem", self.cfg.n_hosts),
                  ("tracereq", n * self.cfg.api_capacity))
        if len(self.cgroups):
            limits += (("cgroupstate", 100_000),)
        sweep, nrows = [], 0
        for subsys, maxrecs in limits:
            qo = api.QueryOptions(subsys=subsys) if maxrecs is None \
                else api.QueryOptions(subsys=subsys, maxrecs=maxrecs)
            out = api.execute(self.cfg, None, qo, names=self.names,
                              columns_fn=snap.columns)
            sweep.append((subsys, now, out["recs"]))
            # the reference counts the clusterstate sweep as one row
            nrows += 1 if maxrecs is None else out["nrecs"]
        self._histwriter.write_sweep(sweep)
        return nrows

    def _alert_step(self, snap) -> list:
        """The tick's realtime alert check over ``snap``'s columns → the
        alerts notified. Without an enabled realtime def no column is
        rendered (counted ``alert_eval_skipped``); pending group-wait
        batches still flush."""
        if self.alerts.wants_realtime():
            return self.alerts.check(self.state, columns_fn=snap.columns)
        self.stats.bump("alert_eval_skipped")
        return self.alerts.flush_groups()

    def _drop_pressure_step(self) -> None:
        """The tick's health readback, and the drop-pressure check on
        the probe-failure and dependency-drop counters it carries
        (growing drops → a notifymsg entry, counters and a gauge)."""
        health = self.engine_health()
        self._last_drops = droppressure.check(
            obs_health.drops_for_pressure(health),
            {"svc": self.cfg.svc_capacity,
             "task": self.cfg.task_capacity,
             "api": self.cfg.api_capacity,
             "dep": self.opts.dep_pair_capacity},
            self._last_drops, self.notifylog, self.stats)

    # ------------------------------------------------------- providers
    def _hostlist_columns(self):
        """hostlist (ref parthalist) over the live state."""
        return api.hostlist_columns(self.state.host_last_tick.cpu().numpy(),
                                    self._tick_no, self.names)

    def serverstatus_columns(self, tick: int, nhosts: int, nsvc: float):
        """serverstatus (one row of self status) at ``tick`` over
        ``nhosts`` reporting hosts and ``nsvc`` live services, with the
        live counters."""
        c = self.stats.counters
        num = lambda v: np.array([float(v)], np.float64)  # noqa: E731
        cols = {
            "uptime": num(self._clock() - self._t_started),
            "tick": num(tick),
            "nhosts": num(nhosts),
            "nsvc": num(nsvc),
            # exact host-side int counters
            "connevents": num(c.get("conn_events", 0)),
            "respevents": num(c.get("resp_events", 0)),
            "queries": num(c.get("queries", 0)),
            "alertsfired": num(self.alerts.stats.get("nfired", 0)),
            "wirever": num(V.CURR_WIRE_VERSION),
            "version": np.array([V.__version__], object),
        }
        return cols, np.ones(1, bool)

    def _serverstatus_columns(self):
        return self.serverstatus_columns(
            tick=self._tick_no,
            nhosts=int((self.state.host_last_tick >= 0).sum()),
            nsvc=float(self.state.tbl.n_live))

    def _alert_columns(self, subsys: str):
        """Column source of realtime alertdefs and tracedefs: the same
        dispatch as a query, so a def can target any served subsystem.
        A ``subsys@window`` source (a windowed alertdef) reads the
        time-travel tier's windowed aggregate."""
        if "@" in subsys:
            base, _, win = subsys.partition("@")
            if self.timeview is None:
                raise ValueError("windowed alertdef needs history shards "
                                 "(hist_shard_dir)")
            return self.timeview.window_columns_for(base, win)
        return self._cached_columns(subsys)

    def _cached_columns(self, subsys: str):
        """Version-keyed column cache: readbacks recompute only after
        the state changed (feed, tick, flush and restore bump it).
        Registry- and CRUD-backed views are never cached: they change
        without a version bump."""
        if subsys in self._aux:
            return self._aux[subsys]()
        out = self._cols.get(subsys, lambda: api.columns_for(
            self.cfg, self.state, subsys, names=self.names, dep=self.dep,
            svcreg=self.svcreg, aux=self._aux))
        if subsys == "procinfo":
            # joined outside the cache: tags change through CRUD
            out = self.tags.with_tags(out)
        return out

    def _ext_join(self, base_subsys: str, idcol: str = "svcid"):
        """ext* subsystems: base columns ⋈ svcinfo metadata."""
        cols, live = self._alert_columns(base_subsys)
        info_cols, _ = self.svcreg.columns(self.names)
        return api.info_join(cols, live, info_cols, idcol=idcol)

    def _svc_task_ids(self):
        """Hex process-group ids that serve a listener (taskstate rows
        with a nonzero relsvcid): the traceconn ``csvc`` source."""
        cols, live = self._cached_columns("taskstate")
        zero = "0" * 16
        return {t for t, r, ok in zip(cols["taskid"], cols["relsvcid"],
                                      live) if ok and r != zero}

    def _traceuniq_columns(self):
        """traceuniq: distinct API signatures per service, grouped from
        the per-(svc, api) slab."""
        tcols, tlive = api.trace_columns(self.cfg, self.state,
                                         names=self.names)
        return api.traceuniq_from_trace(tcols, tlive)

    # ------------------------------------------------------- trace control
    def trace_control_diff(self, hosts=None):
        """Evaluate tracedefs against the live svcinfo → per-host
        enable/disable diffs for the network edge to push. ``hosts``
        restricts them to reachable agents."""
        targets = self.tracedefs.target_svcids(self._alert_columns)
        return self.tracedefs.diff_for_hosts(targets, hosts=hosts)

    # ---------------------------------------------------------------- CRUD
    def crud(self, req: dict) -> dict:
        """One CRUD request (``{"op": "add"|"delete", "objtype": ...}``)
        under the registry lock; the published snapshot's caches drop,
        so its next query re-renders the changed views."""
        with self._reg_lock:
            out = crud.crud(self, req)
        snap = self.snapshot
        if snap is not None:
            snap.on_mutation()
        return out

    # -------------------------------------------------------------- query
    def query(self, req: dict) -> dict:
        """Point-in-time JSON query. ``consistency``: ``"strong"`` (the
        default: staged events are folded first, then the live state is
        read) or ``"snapshot"`` (the last published snapshot; no fold).
        A request with ``"op"`` goes to the CRUD channel; a
        ``"multiquery"`` list runs up to 16 plain queries in one call.
        ``at``/``window`` requests (and ``tstart``/``tend`` without a
        ``history_db``) are served from the history shards,
        ``tstart``/``tend`` with one from the relational store."""
        if req.get("op"):
            return self.crud(req)
        if "multiquery" in req:
            return crud.multiquery(self.query, req)
        if req.get("consistency") == "snapshot":
            return self.query_snapshot(req)
        if "consistency" in req:
            req = dict(req)
            if req.pop("consistency") != "strong":
                raise ValueError(
                    "consistency must be 'snapshot' or 'strong'")
        out = api.local_response(self, req)
        if out is not None:
            return out
        with self.stats.timeit("query"):
            return self._query(req)

    def query_snapshot(self, req: dict) -> dict:
        """Serve a live query from the last published snapshot: no
        ``flush()``, no fold. Publishes one first if none exists yet.
        ``at``/``window`` requests go to the shard tier (also fold-free);
        relational ``tstart``/``tend`` needs ``consistency="strong"``."""
        req = {k: v for k, v in req.items() if k != "consistency"}
        snap = self.snapshot
        if snap is None:
            snap = self.publish_snapshot()
        if req.get("subsys") in api.LOCAL_SUBSYS:
            return api.local_response(self, req, snapshot=snap)
        if ("tstart" in req or "tend" in req) and "at" not in req \
                and "window" not in req and self.history is not None:
            raise ValueError(
                "relational history queries need consistency=strong")
        out = route_historical(self, req)
        if out is not None:
            return out
        self.stats.bump("queries")
        with self.stats.timeit("query"):
            return snap.query(req)

    def _query(self, req: dict) -> dict:
        out = route_historical(self, req)
        if out is not None:
            return out
        if "tstart" in req or "tend" in req:
            return self._history_query(req)
        self.flush()                  # live queries see all staged events
        self.stats.bump("queries")
        return api.execute(self.cfg, self.state,
                           api.QueryOptions.from_json(req),
                           names=self.names,
                           columns_fn=self._cached_columns)

    def _history_query(self, req: dict) -> dict:
        """``tstart``/``tend`` over the relational history store (which
        ``route_historical`` left to it), after the writer's queue has
        drained (read-your-writes)."""
        self._histwriter.barrier()
        now = self._clock()
        tstart = float(req.get("tstart", 0))
        tend = float(req.get("tend", now))
        if req.get("aggr"):
            recs = self.history.aggr_query(
                req["subsys"], tstart, tend, req["aggr"],
                groupby=req.get("groupby"), filter=req.get("filter"),
                step=float(req["step"]) if req.get("step") else None,
                maxrecs=int(req.get("maxrecs", 10000)))
            return {"recs": recs, "nrecs": len(recs)}
        return {"recs": self.history.query(
            req["subsys"], tstart, tend, req.get("filter"),
            int(req.get("maxrecs", 10000)))}

    def close(self) -> None:
        """Join the background threads — alert delivery, the DNS
        resolver, the journal's writer (after an fsync) and the history
        writer (after it drains) — and close the history store.
        Idempotent."""
        self._profiler.close()        # write a short bracket's trace
        self.alerts.close()
        self.dns.close()
        if self.journal is not None:
            self.journal.close()
        if self._histwriter is not None:
            self._histwriter.close()
        if self.history is not None:
            self.history.db.close()       # a second close is a no-op

    # ------------------------------------------------------ engine leaves
    def leaves(self) -> tuple:
        """``(state, dep)`` as numpy leaves in the reference's order and
        dtypes: what a history shard holds (``history/compactor.py``)."""
        return aggstate.state_to_numpy(self.state), \
            dg.dep_to_numpy(self.dep)

    def load_leaves(self, state_leaves, dep_leaves) -> None:
        """Re-seed state and dep from :meth:`leaves`' form, each leaf
        checked against the live one (ValueError on a mismatch), and
        forget the pressure of the dispatches before them."""
        self.state = aggstate.state_from_numpy(
            ckpt.fit_leaves(state_leaves, self.state, "shard"),
            self.device)
        self.dep = dg.dep_from_numpy(
            ckpt.fit_leaves(dep_leaves, self.dep, "shard"), self.device)
        self._pressures.clear()

    def delta_leaves(self) -> dict:
        """The monotone loghist leaves a window's sketch deltas
        difference, ``{name: (rows, B)}`` (``winquant.DELTA_SPECS``)."""
        return {name: WQ.leaf_of(self.state, name)
                for name in WQ.DELTA_SPECS}

    def task_panel(self) -> tuple:
        """The taskstate panel of every slab row, live or not: the
        ``task_cpu`` delta leaf's rows, one for one."""
        return api.task_columns(self.cfg, self.state, names=self.names,
                                live_only=False)

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
        # snapshot serving must not keep answering from the state before
        # the restore: republish (only where a snapshot was published)
        if self.snapshot is not None:
            self.publish_snapshot()
        return extra

    def replay_journal(self, pos=None) -> dict:
        """Re-fold WAL chunks from ``pos`` (a checkpoint's recorded
        ``extra["wal"]``; None = the journal's start) through the normal
        decode/fold path: the recovery after :meth:`restore`."""
        return J.replay_journal(self, pos)
