"""GytServer: the TCP serving edge (asyncio, COMM_HEADER framing).

Counterpart of ``gyeeta_tpu/net/server.py`` over the port's
:class:`~gyeeta_tpu_torch.runtime.Runtime`: the bytes agents stream go
through ``Runtime.feed`` (the native deframer) into the fold on the
runtime's device, queries on every edge read the runtime on the loop
thread or its published snapshot on the executor's threads. Over the
sharded runtime, ``shard_ingest`` puts a bounded byte queue and a drain
task a shard between the conns and the runtime
(:class:`~gyeeta_tpu_torch.net.shardfeed.ShardFeeder`).
``ingest_procs > 1`` hands registered event conns to ingest worker
processes (``net/ingestproc.py``) that deframe, journal and publish
decoded records into shared-memory rings the serving loop drains into
the sharded runtime; ``relay_port`` accepts remote ingest relays
(``net/relay.py``). Their knobs are reads of the ``env`` mapping the
server is given (``None`` means no environment). The edge
pre-aggregation advert is the explicit ``preagg`` argument.
The direct feed path folds the event conns whose bytes arrive in one
loop iteration with one fold boundary (``Runtime.feed_batch``): a feed
ends with a dispatch of the staged sweep sections, which a fleet of
hundreds of small agents cannot pay a sweep each.

The role of madhava's accept + L1 threads and shyama's registrar in one
single-controller process (ref ``server/gy_mconnhdlr.cc:2430-2520`` recv/
frame loop; ``server/gy_shconnhdlr.cc:7463`` partha registration,
``:5876`` placement): agents connect, register their machine-id (version
gated, ``common/gy_comm_proto.h:55-56``), get a sticky dense ``host_id``,
and stream EVENT_NOTIFY frames that drain straight into ``Runtime.feed``;
query clients multiplex JSON queries over the same framing (``QUERY_CMD``/
``QUERY_RESPONSE``, :502,536).

Connection roles commit at registration (the CLI_TYPE_E discipline,
``gy_comm_proto.h:91-99``): an event conn switches to bulk reads — every
``read()`` hands whatever bytes arrived to ``Runtime.feed``, which owns
framing, partial-frame resume and the staged K-slab fold path, so the
per-frame work stays in the native deframer, not in Python. A query conn
stays frame-at-a-time and answers each ``QUERY_CMD`` with a framed JSON
response (seqid echoed).

Concurrency model: one asyncio loop owns the Runtime — the device's
stream is the parallelism (no L2 worker pools). ``run_tick`` runs on the
loop thread and holds it for the tick (a fraction of a second on the
card); the conn deadlines (handshake 10 s, idle at least 30 s) are far
longer, so a tick delays their checks but reaps no conn that is live.
"""

from __future__ import annotations

import asyncio
import json
import logging
import pathlib
from typing import Optional

import numpy as np

from gyeeta_tpu_torch import version
from gyeeta_tpu_torch.ingest import refproto, refquery, wire
from gyeeta_tpu_torch.net.shardfeed import ShardFeeder
from gyeeta_tpu_torch.runtime import Runtime

log = logging.getLogger("gyeeta_tpu_torch.net")

_HSZ = wire.HEADER_DT.itemsize
_READ_SZ = 1 << 20
# a conn's stream buffer: asyncio's 64 KB default hands a bulk conn's
# bytes over in ~128 KB reads, a fold boundary each; 256 KB keeps a
# fleet's buffered bytes bounded (reading pauses at twice this a conn)
_READ_LIMIT = 1 << 18


class _ConnReaped(Exception):
    """A conn deadline fired (handshake / idle / write); the counter
    was already bumped — callers just unwind and close."""

    def __init__(self, kind: str):
        super().__init__(f"conn reaped ({kind} deadline)")
        self.kind = kind


class GytServer:
    def __init__(self, rt: Runtime, host: str = "127.0.0.1",
                 port: int = 0, tick_interval: Optional[float] = 5.0,
                 hostmap_path: Optional[str] = None,
                 record_path: Optional[str] = None,
                 advertise_host: Optional[str] = None,
                 feed_pipeline: bool = False,
                 handshake_timeout: float = 10.0,
                 idle_timeout: Optional[float] = None,
                 write_timeout: float = 10.0,
                 frame_error_budget: int = 8,
                 throttle_hold_ms: int = 1500,
                 throttle_lag_s: float = 0.75,
                 throttle_pending_mb: float = 32.0,
                 throttle_slab_frac: float = 0.85,
                 throttle_ring_frac: float = 0.75,
                 query_workers: Optional[int] = None,
                 query_queue_max: Optional[int] = None,
                 query_snapshot: bool = True,
                 shard_ingest: bool = False,
                 shard_queue_mb: float = 8.0,
                 ingest_procs: int = 1,
                 sub_persist: Optional[str] = None,
                 relay_port: Optional[int] = None,
                 relay_host: str = "0.0.0.0",
                 preagg: bool = False, env=None):
        self.env = {} if env is None else env
        # direct feeds: one fold boundary for the event conns whose
        # bytes arrived in the same loop iteration (Runtime.feed_batch)
        # instead of one a read, which costs a fleet of small agents a
        # dispatch a sweep. The pipeline and the shard feeder queue
        # bytes their own way
        self._batch: list = []
        self.rt = rt
        self.host = host
        self.port = port
        # the madhava address handed to stock parthas in
        # PS_REGISTER_RESP_S: a wildcard bind is not dialable, so it
        # falls back to the machine's hostname (configure explicitly
        # when parthas reach the server through NAT/a service VIP)
        import socket as _socket
        self.advertise_host = advertise_host or (
            host if host not in ("", "0.0.0.0", "::") else
            _socket.gethostname())
        self.tick_interval = tick_interval
        # ---- conn deadlines (the slow-loris / half-open hardening):
        # handshake_timeout bounds the registration phase (any role);
        # idle_timeout reaps silent conns — default tied to the
        # expected sweep cadence (agents sweep every ~tick_interval, so
        # 12 missed sweeps = dead); write_timeout bounds control pushes
        # into a non-draining peer; frame_error_budget closes a query
        # conn after N recoverable frame-level errors. Every reap or
        # reject lands on a labeled counter (conn_timeouts|kind=...,
        # frames_rejected|reason=...) rendered in /metrics.
        self.handshake_timeout = handshake_timeout
        # ---- admission control (server→agent backpressure): when the
        # durable-ingest tier falls behind — journal fsync lag past
        # throttle_lag_s, unsynced WAL bytes past throttle_pending_mb,
        # staged-slab occupancy past throttle_slab_frac, or the
        # droppressure vector active — push a COMM_THROTTLE telling
        # agents to hold feeds in their PR-4 spool for throttle_hold_ms.
        # Priority-aware (PSketch, PAPERS.md): trace/pcap first
        # (FEED_TRACE), everything only under engine drop pressure
        # (FEED_ALL) — health classification degrades last.
        # throttle_hold_ms=0 disables the controller.
        self.throttle_hold_ms = int(throttle_hold_ms)
        self.throttle_lag_s = float(throttle_lag_s)
        self.throttle_pending_mb = float(throttle_pending_mb)
        self.throttle_slab_frac = float(throttle_slab_frac)
        # worker-ring backlog (multi-process ingest): occupancy past
        # throttle_ring_frac trips the trace throttle, ≥0.95 holds
        # EVERYTHING — throttle the agents BEFORE the drop-oldest rings
        # shed records
        self.throttle_ring_frac = float(throttle_ring_frac)
        self._throttle_level = 0          # 0=off, 1=trace, 2=all
        if idle_timeout is None:
            idle_timeout = max(30.0, 12.0 * tick_interval) \
                if tick_interval else 60.0
        self.idle_timeout = idle_timeout if idle_timeout > 0 else None
        self.write_timeout = write_timeout
        self.frame_error_budget = frame_error_budget
        # optional wire capture (utils/replay.py): every complete-frame
        # run fed to the runtime is also appended to the capture file
        self._recorder = None
        if record_path:
            from gyeeta_tpu_torch.utils.replay import StreamRecorder
            self._recorder = StreamRecorder(record_path)
        self._server: Optional[asyncio.AbstractServer] = None
        self._tick_task: Optional[asyncio.Task] = None
        # optional liveness watchdog (utils/crashguard.TickWatchdog):
        # beaten after each successful tick; the daemon arms it
        self.watchdog = None
        # machine-id → host_id stickiness (the pardbmap_ placement map,
        # gy_shconnhdlr.cc:5876); optionally persisted across restarts
        self._hostmap_path = pathlib.Path(hostmap_path) \
            if hostmap_path else None
        self.hostmap: dict[int, int] = self._load_hostmap()
        # host_id → event-conn writer: the reverse-direction channel for
        # server→agent control (trace capture enable/disable — the
        # reference's CLI_TYPE_RESP_REQ conns carry this, gy_comm_proto.h)
        self._event_writers: dict[int, asyncio.StreamWriter] = {}
        self._open_conns: set = set()      # every live conn's writer
        self._conn_seq = 0                 # dense conn ids (WAL
        #                                    attribution: torn tails
        #                                    name their conn)
        # optional L1/L2 decode pipeline (multi-core hosts): deframe
        # runs on a worker thread; tick/query paths barrier through
        # _feed_barrier so no submitted bytes are invisible at a
        # cadence or query boundary
        # stock LISTENER_DOMAIN payloads awaiting svcreg resolution
        self._pending_domains: dict = {}
        self._pipe = None
        if feed_pipeline:
            from gyeeta_tpu_torch.ingest.pipeline import FeedPipeline
            # the recorder moves INTO the pipeline: only buffers that
            # decoded cleanly get recorded (replayability; see the
            # pipeline docstring for the poison-frame divergence)
            self._pipe = FeedPipeline(rt, recorder=self._recorder)
        # --shards mode: per-shard ingest loops between the conn
        # handlers and the sharded runtime (net/shardfeed.py), exclusive
        # with the decode pipeline (the feeder owns the handoff)
        self._feeder = None
        if shard_ingest and getattr(rt, "n", 1) > 1:
            if self._pipe is not None:
                raise ValueError(
                    "--feed-pipeline and shard ingest are mutually "
                    "exclusive (the shard feeder owns the handoff)")
            self._feeder = ShardFeeder(rt, queue_max_mb=shard_queue_mb)
        # the direct path folds a loop iteration's conns with one
        # boundary (Runtime.feed_batch)
        self._batch_feeds = self._pipe is None and self._feeder is None
        # ---- multi-process ingest edge (net/ingestproc.py): N worker
        # processes own wire validation + deframe/decode + WAL append
        # for their sticky shard groups and publish decoded record
        # batches into shared-memory rings; this process keeps the ONE
        # listener + registration and drains the rings into the fold.
        # ingest_procs <= 1 (the default) spawns nothing — byte-for-
        # byte today's in-process path.
        self._ingest = None
        self._ingest_tasks: list = []
        if ingest_procs and int(ingest_procs) > 1:
            if getattr(rt, "n", 1) < int(ingest_procs):
                raise ValueError(
                    f"--ingest-procs {ingest_procs} needs --shards >= "
                    f"{ingest_procs} (one worker owns at least one "
                    "whole shard group)")
            from gyeeta_tpu_torch.net.ingestproc import IngestSupervisor, \
                ProcWalView
            self._ingest = IngestSupervisor(
                rt, int(ingest_procs),
                journal_dir=rt.opts.journal_dir,
                idle_timeout=self.idle_timeout, env=self.env)
            if rt.journal is not None:
                # the WORKERS own the WAL writers from here: release
                # this process's segment handles (restore/replay used
                # them already — Daemon builds the server after
                # recovery) and swap in the cross-process view so
                # checkpoint/truncate/compactor handoff keep working
                rt.journal.close()
                rt.journal = ProcWalView(
                    self._ingest, rt.opts.journal_dir,
                    getattr(rt, "n", 1), stats=rt.stats,
                    subdir_fmt=getattr(
                        getattr(rt, "layout", None), "WAL_SUBDIR_FMT",
                        "shard_{:02d}"))
        # ---- remote ingest relay hub (net/relay.py): accepts REMOTE
        # relay uplinks carrying the shm-ring contract over TCP —
        # decoded batches with cumulative per-shard record chains, so
        # published == consumed + counted drops holds across machines.
        # Registration RPCs land on the SAME sticky hostmap; the relay
        # owns its WAL on its own host. relay_port=None binds nothing.
        self._relay = None
        if relay_port is not None:
            from gyeeta_tpu_torch.net.relay import RelayHub
            self._relay = RelayHub(rt, self._relay_register,
                                   host=relay_host, port=relay_port,
                                   env=self.env)
        # stock-partha registration state: machine-id → the ident key
        # issued at PS_REGISTER (the SM_PARTHA_IDENT_NOTIFY flow,
        # gy_comm_proto.h:946 — shyama hands the key to madhava; the
        # single controller holds both roles so a dict suffices)
        self._ref_idents: dict[int, int] = {}
        # stable madhava id presented to stock parthas (sticky across
        # a process run; parthas compare it on reconnect)
        import secrets as _sec
        self._madhava_id = _sec.randbits(63) | 1
        # NM query edge (node-webserver conns, net/nmhandle.py): sticky
        # conn identity per (hostname, port) + live-conn gauge
        self._nm_idents: dict[tuple, object] = {}
        self._nm_conns_live = 0
        # ---- snapshot-isolated query serving (query/snapshot.py +
        # net/qexec.py): live queries on ANY edge default to reading
        # the last published per-tick snapshot on a bounded worker
        # pool — the fold never waits on a dashboard and a dashboard
        # never waits on the fold. CRUD, multiquery, historical SQL
        # and explicit consistency=strong requests stay inline on the
        # loop (they mutate live structures / need the live handle).
        from gyeeta_tpu_torch.net import qexec as _qexec
        self.query_snapshot = bool(query_snapshot)
        self.qexec = _qexec.QueryExecutor(rt, workers=query_workers,
                                          queue_max=query_queue_max)
        # edge pre-aggregation advert (wire v5): registered event conns
        # are told the sketch geometry their delta sweeps fold with
        self.preagg = bool(preagg)
        # ---- streaming subscriptions (net/subs.py): clients register
        # a query ONCE (COMM_SUBSCRIBE_CMD on the GYT edge; the REST
        # gateway relays /v1/subscribe onto it) and the tick loop
        # pushes per-tick row deltas — render once, diff once, push to
        # every subscriber of that normalized query
        from gyeeta_tpu_torch.net.subs import SubscriptionHub
        self.subs = SubscriptionHub(self._sub_fetch, rt.stats,
                                    persist_path=sub_persist)

    async def _sub_fetch(self, req: dict) -> dict:
        """Subscription render: the same admission-controlled off-loop
        snapshot path every poll query rides (``net/qexec.py``)."""
        return await self.qexec.run(req)

    async def push_subscriptions(self) -> int:
        """Push per-tick subscription deltas (called by the tick loop
        after ``run_tick``; tests drive it directly after manual
        ticks). Returns events delivered."""
        if not self.subs.nsubs:
            return 0
        return await self.subs.push_tick()

    def _nm_register(self, hostname: str, port: int):
        """Sticky NM conn identity for a node (hostname, port) pair —
        reconnects get the same conn_id (the reference's per-node conn
        object). Bounded like the partha ident map."""
        from gyeeta_tpu_torch.net import nmhandle
        key = (hostname, port)
        st = self._nm_idents.get(key)
        if st is None:
            if len(self._nm_idents) >= 4 * self.rt.cfg.n_hosts + 64:
                self._nm_idents.clear()      # epoch reset, re-learns
            st = nmhandle.NMConnState(hostname, port,
                                      len(self._nm_idents) + 1)
            self._nm_idents[key] = st
        return st

    # -------------------------------------------------------- registration
    def _load_hostmap(self) -> dict:
        if self._hostmap_path and self._hostmap_path.exists():
            raw = json.loads(self._hostmap_path.read_text())
            return {int(k): int(v) for k, v in raw.items()}
        return {}

    def _save_hostmap(self) -> None:
        if self._hostmap_path:
            tmp = self._hostmap_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {str(k): v for k, v in self.hostmap.items()}))
            tmp.replace(self._hostmap_path)

    def _register(self, req: np.ndarray) -> tuple[int, int]:
        """REGISTER_REQ record → (status, host_id)."""
        ver = int(req["wire_version"])
        if ver < version.MIN_WIRE_VERSION:
            return wire.REG_ERR_VERSION, 0
        if int(req["conn_type"]) != wire.CONN_EVENT:
            return wire.REG_OK, 0xFFFFFFFF    # query conns hold no host slot
        mid = (int(req["machine_id_hi"]) << 64) | int(req["machine_id_lo"])
        return self._host_for_machine(mid)

    def _host_for_machine(self, mid: int) -> tuple[int, int]:
        """Sticky machine-id → dense host_id allocation (shared by the
        GYT and stock-partha registration paths)."""
        hid = self.hostmap.get(mid)
        if hid is not None:
            # a known machine re-registering IS a reconnect — the
            # server-side half of the supervision story (the agent's
            # spool counters arrive separately as NOTIFY_AGENT_STATS)
            self.rt.stats.bump("agent_reconnects")
        if hid is None:
            if len(self.hostmap) >= self.rt.cfg.n_hosts:
                return wire.REG_ERR_CAPACITY, 0
            used = set(self.hostmap.values())
            hid = next(i for i in range(self.rt.cfg.n_hosts)
                       if i not in used)
            self.hostmap[mid] = hid
            self._save_hostmap()
            self.rt.stats.bump("agents_registered")
            self.rt.notifylog.add(
                f"agent registered: machine {mid:032x} -> host {hid}",
                source="agent")
        return wire.REG_OK, hid

    def _relay_register(self, mid: int, conn_type: int,
                        ver: int) -> tuple[int, int, int]:
        """Registration RPC from a remote ingest relay → (status,
        host_id, last_seq). Same gates + sticky hostmap as the local
        handshake, so an agent's identity survives moving between a
        direct conn and any relay."""
        if ver < version.MIN_WIRE_VERSION:
            return wire.REG_ERR_VERSION, 0, 0
        if conn_type != wire.CONN_EVENT:
            return wire.REG_OK, 0xFFFFFFFF, 0
        status, hid = self._host_for_machine(mid)
        last_seq = 0
        if status == wire.REG_OK:
            last_seq = int(getattr(self.rt, "_sweep_last_seq",
                                   {}).get(hid, 0))
        return status, hid, last_seq

    _DOMAIN_MAX_PENDING = 8192
    _DOMAIN_MAX_AGE_TICKS = 12

    def _drain_ref_session(self, sess) -> None:
        """Route frameless stock-partha payloads collected by the
        adapter session: agent NOTIFICATION_MSGs → the notifymsg ring;
        LISTENER_DOMAIN names queue for tick-time resolution (the
        referenced LISTENER_INFO may still ride the decode pipeline —
        resolving inline would force a pipeline barrier per batch)."""
        if sess.notifications:
            msgs, sess.notifications = sess.notifications, []
            for ntype, msg in msgs:
                self.rt.notifylog.add(msg, ntype=ntype, source="agent")
        if sess.domains:
            doms, sess.domains = sess.domains, []
            for gid, dom, _tag in doms:
                if dom and len(self._pending_domains) < \
                        self._DOMAIN_MAX_PENDING:
                    self._pending_domains[gid] = (dom, 0)
        if sess.nat_conns:
            nats, sess.nat_conns = sess.nat_conns, []
            for recs in nats:
                # VIP/NAT registry only — never engine-fed
                self.rt.natclusters.observe_conns(recs)
        if sess.n_events:
            evs = sess.n_events
            sess.n_events = type(evs)()
            for subtype, cnt in evs.items():
                self.rt.stats.bump(f"ref_evt_0x{subtype:x}", cnt)
        if sess.n_skipped:
            # distinct from frames_ref_skipped (pre-registration
            # handshake skips): this counts post-adapt whole-frame
            # skips (unknown subtype / non-NOTIFY / truncated)
            self.rt.stats.bump("ref_unadapted_frames", sess.n_skipped)
            sess.n_skipped = 0

    def _resolve_pending_domains(self) -> None:
        """Tick-cadence domain resolution (after run_tick: the feed
        barrier already ran). Unresolvable entries retry for a few
        ticks — a listener announced slightly later still gets its
        domain — then drop COUNTED, not silently."""
        if not self._pending_domains:
            return
        nxt: dict = {}
        for gid, (dom, age) in self._pending_domains.items():
            info = self.rt.svcreg.get(gid)
            if info is not None:
                self.rt.dns.prime(info["ip"], dom)
            elif age + 1 < self._DOMAIN_MAX_AGE_TICKS:
                nxt[gid] = (dom, age + 1)
            else:
                self.rt.stats.bump("ref_domains_unresolved")
        self._pending_domains = nxt

    # ----------------------------------------------------------- feed path
    def _feed(self, buf: bytes, hid: int = 0, conn_id: int = 0) -> int:
        """Ingest complete-frame bytes: through the decode pipeline
        when enabled, else directly. ``hid``/``conn_id`` attribute the
        bytes in the write-ahead journal."""
        if self._feeder is not None:
            return self._feeder.submit(buf, hid=hid, conn_id=conn_id)
        if self._pipe is not None:
            return self._pipe.feed(buf, hid=hid, conn_id=conn_id)
        if self._batch:
            # the bytes queued before these fold first
            self._feed_batch()
        return self.rt.feed(buf, hid=hid, conn_id=conn_id)

    def _feed_barrier(self) -> None:
        """Make every submitted byte visible (the ingest rings', the
        shard queues' and the pipeline's barrier) before a tick or query
        reads state. With ingest workers this drains what the rings
        HOLD — bytes still inside a worker's deframe loop surface next
        barrier (the cross-process analogue of a conn's partial
        frame)."""
        if self._ingest is not None:
            self._ingest.drain()
        if self._feeder is not None:
            self._feeder.flush_pending()
        if self._pipe is not None:
            self._pipe.flush()
        if self._batch:
            self._feed_batch()

    def _feed_later(self, buf: bytes, hid: int, conn_id: int):
        """Queue complete-frame bytes for this loop iteration's batch →
        a future of the records accepted (or the piece's FrameError)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._batch.append((buf, hid, conn_id, fut))
        if len(self._batch) == 1:
            # after the read callbacks already scheduled this iteration
            loop.call_soon(self._feed_batch)
        return fut

    def _feed_batch(self) -> None:
        """Fold the queued pieces → each waiter gets its own piece's
        result: a piece that failed fails its conn alone, the pieces
        folded before it stand (``Runtime.feed_batch``)."""
        batch, self._batch = self._batch, []
        if not batch:
            return
        try:
            res = self.rt.feed_batch([b[:3] for b in batch])
        except Exception as e:     # noqa: BLE001 — no piece was taken
            res = [e] * len(batch)
        for (_, _, _, fut), r in zip(batch, res):
            if fut.done():
                continue
            if isinstance(r, BaseException):
                fut.set_exception(r)
            else:
                fut.set_result(r)

    # ---------------------------------------------------- query routing
    def _inline_query(self, req: dict) -> bool:
        """True when the request must run inline on the loop: CRUD and
        multiquery mutate/compose against live structures, relational
        tstart/tend history reads a thread-bound DB handle, shard-tier
        at=/window= requests materialize through the runtime's shared
        TimeView, and an explicit ``consistency=strong`` asked for the
        flush-then-read semantics (tests / ``nm probe``)."""
        if not self.query_snapshot:
            return True
        if req.get("op") or "multiquery" in req:
            return True
        if req.get("consistency") == "strong":
            return True
        return any(k in req for k in ("at", "window", "tstart", "tend"))

    async def run_query(self, req: dict) -> dict:
        """One query request → response dict, shared by the GYT query
        loop and the NM edge (the REST gateway rides the GYT loop).
        Snapshot-eligible queries run OFF-loop on the executor with
        admission control; everything else keeps the original inline
        strong path (feed barrier + live read). Raises
        :class:`~gyeeta_tpu_torch.net.qexec.Overloaded` on shed."""
        if self._inline_query(req):
            self._feed_barrier()
            return self.rt.query(req)
        return await self.qexec.run(req)

    # ------------------------------------------------------------- serving
    async def start(self) -> tuple[str, int]:
        # snapshot serving needs a snapshot BEFORE the first tick: the
        # bootstrap publish happens here on the loop, so query worker
        # threads never publish (they'd race the feed path)
        if self.query_snapshot and getattr(self.rt, "snapshot",
                                           None) is None:
            self.rt.publish_snapshot()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=_READ_LIMIT)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        if self._feeder is not None:
            self._feeder.start()
        if self._ingest is not None:
            self._ingest.start(asyncio.get_running_loop())
            self._ingest_tasks = [
                asyncio.create_task(self._ingest_drain_loop()),
                asyncio.create_task(self._ingest_monitor_loop())]
        if self._relay is not None:
            await self._relay.start()
        if self.tick_interval:
            self._tick_task = asyncio.create_task(self._tick_loop())
        log.info("gyt server on %s:%d", self.host, self.port)
        return self.host, self.port

    async def _ingest_drain_loop(self) -> None:
        """Pull decoded record batches out of the worker rings into
        the staging slabs. Adaptive cadence: drain again immediately
        while records flow, back off to the poll interval when idle
        (an empty drain reads one head word per ring)."""
        from gyeeta_tpu_torch.net import ingestproc
        iv = ingestproc.drain_interval_s(self.env)
        while True:
            try:
                n = self._ingest.drain()
            except Exception:                  # pragma: no cover
                log.exception("ingest ring drain failed")
                n = 0
            await asyncio.sleep(0.0 if n else iv)

    async def _ingest_monitor_loop(self) -> None:
        """Worker liveness + metrics cadence: respawn dead/wedged
        workers onto their sticky shard groups, publish the
        gyt_ingest_proc_* counter/gauge rows."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self._ingest.poll()
            except Exception:                  # pragma: no cover
                log.exception("ingest worker monitor failed")

    async def stop(self) -> None:
        if self._tick_task:
            self._tick_task.cancel()
            self._tick_task = None
        if self._relay is not None:
            # stop accepting relay batches before the runtime winds
            # down (a batch landing mid-close would stage into a
            # closing runtime); shutdown is not relay loss — no epoch
            # finalize, the relays reconnect to the restarted hub
            await self._relay.stop()
        if self._server:
            self._server.close()
            # force-close live conns BEFORE wait_closed: since 3.12.1
            # Server.wait_closed waits for every active handler, and a
            # stopping server must not wait on agents that never hang
            # up (the crash/restart path drops them; they reconnect)
            for w in list(self._open_conns):
                w.close()
            await self._server.wait_closed()
            self._server = None
        if self._recorder is not None:
            rec, self._recorder = self._recorder, None
            rec.close()      # live conns see None, never a closed file
        self.subs.close()    # flush + close the continuation ring file
        if self._ingest is not None:
            # graceful worker drain BEFORE the runtime closes: workers
            # stop their conns, fsync + close their WALs and report
            # final positions; every ring slot is folded before stop()
            # returns — the final checkpoint supersedes the whole WAL
            # window (the SIGTERM drain contract, tested with
            # --ingest-procs 2 in tests/test_torch_ingestproc.py)
            for t in self._ingest_tasks:
                t.cancel()
            self._ingest_tasks = []
            self._ingest.stop()
            self._ingest.close()     # rings unlinked (positions cached)
        if self._feeder is not None:
            await self._feeder.stop()    # drain queued runs, then fold
        if self._pipe is not None:
            self._pipe.close()           # barrier + worker shutdown
        self.qexec.close()   # query worker pool (no new snapshot reads)
        self.rt.close()      # alert delivery worker + history handle

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_interval)
            try:
                self._feed_barrier()
                self.rt.run_tick()
                if self._ingest is not None:
                    # workers stamp WAL chunks with the window tick
                    # (replay merge order + compactor window evidence)
                    self._ingest.broadcast_tick(self.rt._tick_no)
                if self._relay is not None:
                    # remote relays stamp THEIR WALs with the same tick
                    self._relay.broadcast_tick(self.rt._tick_no)
                self._resolve_pending_domains()
                await self.push_trace_control()
                await self.push_throttle()
                await self.push_subscriptions()
                if self.watchdog is not None:
                    self.watchdog.beat()      # liveness heartbeat
            except Exception:                     # pragma: no cover
                log.exception("tick failed")

    # ------------------------------------------------- admission control
    def throttle_level(self) -> int:
        """Evaluate the durable-ingest pressure signals → 0 (open),
        1 (hold trace/pcap feeds), 2 (hold every sweep). Reads the
        gauges ``run_tick``'s one-readback health pass just refreshed
        — no extra device transfer."""
        if not self.throttle_hold_ms:
            return 0
        g = self.rt.stats.gauges
        # engine drop pressure: the engine is ALREADY shedding — hold
        # everything (spooled sweeps beat probe-failure garbage)
        if g.get("engine_drop_pressure"):
            return 2
        lvl = 0
        # worker-ring backlog (multi-process ingest): the rings are
        # drop-oldest — occupancy approaching full means the NEXT
        # burst sheds records, so agents must spool first. Head−tail
        # occupancy reads two shared-memory words per shard ring.
        if self._ingest is not None:
            frac = self._ingest.ring_backlog_frac()
            self.rt.stats.gauge("ingest_ring_backlog_frac", frac)
            if frac >= 0.95:
                return 2
            if frac > self.throttle_ring_frac:
                lvl = 1
        if g.get("journal_fsync_lag_seconds", 0.0) > self.throttle_lag_s:
            lvl = 1
        if g.get("journal_pending_bytes", 0.0) \
                > self.throttle_pending_mb * (1 << 20):
            lvl = 1
        # staged-slab occupancy: records accepted but not yet folded
        cap = max(1, (self.rt.cfg.conn_batch + self.rt.cfg.resp_batch)
                  * self.rt.cfg.fold_k)
        staged = (getattr(self.rt, "_n_conn_raw", 0)
                  + getattr(self.rt, "_n_resp_raw", 0))
        if staged / cap > self.throttle_slab_frac:
            lvl = 1
        return lvl

    async def push_throttle(self) -> int:
        """Admission-control push: (re)issue COMM_THROTTLE holds while
        pressure persists, release early when it clears. Every
        transition lands on ``throttle|feed=...`` (rendered as
        ``gyt_throttle_total{feed=...}``); the current level rides the
        ``throttle_state`` gauge. Returns frames pushed."""
        lvl = self.throttle_level()
        prev = self._throttle_level
        if lvl != prev:
            if lvl == 2:
                self.rt.stats.bump("throttle|feed=all")
            elif lvl == 1:
                self.rt.stats.bump("throttle|feed=trace")
            else:
                self.rt.stats.bump("throttle_released")
            self.rt.notifylog.add(
                f"admission control: throttle level {prev} -> {lvl} "
                f"(journal lag/pending, slab occupancy, droppressure)",
                ntype="warn" if lvl else "info", source="selfmon")
        self._throttle_level = lvl
        self.rt.stats.gauge("throttle_state", float(lvl))
        if lvl == 0 and prev == 0:
            return 0                      # steady open state: no frame
        # one frame always carries BOTH classes with their hold: a
        # level drop releases the no-longer-held class early (hold 0)
        # instead of waiting out its deadline on the agent
        frame = wire.encode_throttle_multi(
            ((wire.FEED_TRACE, self.throttle_hold_ms if lvl >= 1 else 0),
             (wire.FEED_ALL, self.throttle_hold_ms if lvl == 2 else 0)))
        n = 0
        for hid, w in list(self._event_writers.items()):
            try:
                w.write(frame)
                if self.write_timeout:
                    await asyncio.wait_for(w.drain(), self.write_timeout)
                else:
                    await w.drain()
                n += 1
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    TimeoutError):
                # a dead conn re-learns the hold on reconnect (the
                # controller re-pushes every tick while pressure holds)
                continue
        return n

    async def push_trace_control(self) -> int:
        """Evaluate tracedefs and push enable/disable diffs to the
        owning agents' event conns (the REQ_TRACE_SET distribution,
        ``gy_shconnhdlr.cc:1272`` → partha). Returns records pushed."""
        diffs = self.rt.trace_control_diff(
            hosts=list(self._event_writers))
        n = 0
        for hid, (enable, disable) in diffs.items():
            w = self._event_writers.get(hid)
            if w is None:
                continue
            ids = list(enable) + list(disable)
            flags = [1] * len(enable) + [0] * len(disable)
            try:
                w.write(wire.encode_trace_set(ids, flags))
                # write deadline: a non-draining agent (full socket
                # buffers, wedged peer) must not stall the tick loop —
                # reap the conn and re-emit the diff on reconnect
                if self.write_timeout:
                    await asyncio.wait_for(w.drain(), self.write_timeout)
                else:
                    await w.drain()
                n += len(ids)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    TimeoutError) as e:
                if isinstance(e, (asyncio.TimeoutError, TimeoutError)) \
                        and not isinstance(e, OSError):
                    self.rt.stats.bump("conn_timeouts|kind=write")
                    w.close()     # half-dead conn: force the reconnect
                # the diff was already committed to the applied state;
                # a failed push that does NOT tear down the reader path
                # would leave the host silently out of sync. Restore the
                # pre-diff state so next tick re-emits the SAME diff
                # (forget_host would lose pending disables forever).
                self.rt.tracedefs.unapply(hid, enable, disable)
        if n:
            self.rt.stats.bump("trace_sets_pushed", n)
        return n

    async def _tread(self, coro, kind: str):
        """Await ``coro`` under the ``kind`` conn deadline. A fired
        deadline bumps ``conn_timeouts|kind=...`` and raises
        :class:`_ConnReaped` so the conn unwinds and closes without
        ever blocking the tick loop."""
        t = self.handshake_timeout if kind == "handshake" \
            else self.idle_timeout
        if not t:
            return await coro
        try:
            return await asyncio.wait_for(coro, t)
        except (asyncio.TimeoutError, TimeoutError):
            self.rt.stats.bump(f"conn_timeouts|kind={kind}")
            raise _ConnReaped(kind) from None

    async def _read_frame(self, reader, first: bytes = b""
                          ) -> tuple[int, bytes]:
        """→ (data_type, payload_bytes). Raises IncompleteReadError at
        EOF, FrameError (with reason) on poison headers — the shared
        validated reader (``ingest/wire.py:read_frame``); ``first``
        carries bytes already peeked off the stream."""
        return await wire.read_frame(reader, first)

    async def _ref_conn(self, reader, writer, first: bytes,
                        conn_id: int = 0) -> None:
        """Stock-partha connection: the gy_comm_proto registration
        handshake, then the reference NOTIFY stream via the adapter.

        The single controller plays BOTH reference roles
        (``gy_comm_proto.h:584-952``): a PS_REGISTER_REQ_S gets a
        PS_REGISTER_RESP_S pointing the partha at ourselves as its
        madhava (ident key issued here, the SM_PARTHA_IDENT_NOTIFY
        flow collapsed); a PM_CONNECT_CMD_S validates versions + the
        ident key, allocates the sticky host_id, replies
        PM_CONNECT_RESP_S, and hands the conn to the event loop —
        where ``refproto.adapt`` folds the notify stream natively.
        """
        import secrets
        import time as _time

        RP = refproto
        hdr_b = first + await self._tread(reader.readexactly(
            RP.REF_HEADER_DT.itemsize - len(first)), "handshake")
        while True:
            hdr = np.frombuffer(hdr_b, RP.REF_HEADER_DT, count=1)[0]
            if int(hdr["magic"]) not in RP.REF_MAGICS:
                raise wire.FrameError(
                    f"bad reference magic 0x{int(hdr['magic']):08x}",
                    reason="bad_magic")
            total = int(hdr["total_sz"])
            if total < len(hdr_b) or total >= wire.MAX_COMM_DATA_SZ:
                raise wire.FrameError(f"bad ref total_sz {total}",
                                      reason="bad_size")
            body = await self._tread(
                reader.readexactly(total - len(hdr_b)), "handshake")
            dtype = int(hdr["data_type"])
            now = int(_time.time())
            if dtype == RP.REF_COMM_PS_REGISTER_REQ:
                req = RP.parse_ps_register_req(body)
                err, es = self._ref_gate(req, "min_shyama_version")
                key = 0
                if not err:
                    mid = ((req["machine_id_hi"] << 64)
                           | req["machine_id_lo"])
                    # bound the unauthenticated-registration state:
                    # slack over n_hosts for churned machine ids, but
                    # no unbounded growth from random-id floods
                    if mid not in self._ref_idents and \
                            len(self._ref_idents) >= \
                            4 * self.rt.cfg.n_hosts:
                        err, es = 116, "max partha registrations"
                    else:
                        key = self._ref_idents.setdefault(
                            mid, secrets.randbits(63) | 1)
                writer.write(RP.encode_ps_register_resp(
                    err, es, self.advertise_host, self.port, key,
                    self._madhava_id, now))
                await writer.drain()
                if err:
                    self.rt.stats.bump("conns_ref_rejected")
                    return
                self.rt.stats.bump("ref_ps_registered")
                # the partha now dials its madhava (us) on new conns;
                # this shyama conn stays up for status traffic
            elif dtype == RP.REF_COMM_PM_CONNECT_CMD:
                req = RP.parse_pm_connect_cmd(body)
                err, es = self._ref_gate(req, "min_madhava_version")
                mid = ((req["machine_id_hi"] << 64)
                       | req["machine_id_lo"])
                host_id = 0
                if not err and self._ref_idents.get(mid) != \
                        req["partha_ident_key"]:
                    err, es = 113, ("unknown partha ident key - "
                                    "register with shyama first")
                if not err:
                    status, host_id = self._host_for_machine(mid)
                    if status != wire.REG_OK:
                        err, es = 116, "max partha hosts exceeded"
                writer.write(RP.encode_pm_connect_resp(
                    err, es, self._madhava_id, now))
                await writer.drain()
                if err:
                    self.rt.stats.bump("conns_ref_rejected")
                    return
                self.rt.stats.bump("ref_pm_connected")
                # conns_ref_adapted is counted by the event loop when
                # it sees the first reference-magic data (one count
                # per adapted conn, same as direct-stream ref conns)
                await self._event_loop(
                    reader, host_id,
                    ref_session=refproto.RefSession(
                        region=req.get("region_name", ""),
                        zone=req.get("zone_name", "")),
                    conn_id=conn_id)
                return
            elif dtype == refquery.REF_COMM_NM_CONNECT_CMD:
                # stock node webserver: the query edge (NM_CONNECT_CMD_S
                # → RESP_S handshake + QUERY_WEB_JSON / CRUD_*_JSON
                # loop, net/nmhandle.py)
                from gyeeta_tpu_torch.net import nmhandle
                await nmhandle.serve_nm_conn(self, reader, writer, body)
                return
            else:
                # pre-registration frame of an unhandled type: skip it
                # whole (the reference's recv loop does the same for
                # unknown events)
                self.rt.stats.bump("frames_ref_skipped")
            hdr_b = await self._tread(
                reader.readexactly(RP.REF_HEADER_DT.itemsize),
                "handshake")

    def _ref_gate(self, req: dict, min_field: str) -> tuple[int, str]:
        """Version gates of the reference's validate_fields
        (``gy_comm_proto.h:55-56``): comm version must match ours;
        partha must be ≥ our floor; our version must satisfy the
        partha's floor. → (err_code, error_string)."""
        RP = refproto
        if req["comm_version"] != RP.REF_COMM_VERSION:
            return 101, (f"comm version {req['comm_version']} "
                         f"unsupported (need {RP.REF_COMM_VERSION})")
        if req["partha_version"] < RP.REF_MIN_PARTHA_VERSION:
            return 103, "partha version below minimum supported"
        if req.get(min_field, 0) > RP.REF_MADHAVA_VERSION:
            return 102, "server version below partha's minimum"
        return 0, ""

    async def _handle_conn(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        self._open_conns.add(writer)
        self._conn_seq += 1
        conn_id = self._conn_seq
        try:
            # peek the first header: a reference COMM_HEADER magic means
            # a STOCK PARTHA — route it through the gy_comm_proto
            # registration handshake instead of GYT registration.
            # The whole pre-registration phase runs under the handshake
            # deadline: a slow-loris peer (valid magic, header never
            # completed) is reaped, counted, and cannot pin a handler.
            try:
                first = await self._tread(reader.readexactly(4),
                                          "handshake")
            except (asyncio.IncompleteReadError, ConnectionError,
                    _ConnReaped):
                return
            if int.from_bytes(first, "little") in refproto.REF_MAGICS:
                try:
                    await self._ref_conn(reader, writer, first, conn_id)
                except (asyncio.IncompleteReadError, ConnectionError,
                        _ConnReaped):
                    pass
                return
            # every conn opens with one REGISTER_REQ declaring its role
            try:
                dtype, payload = await self._tread(
                    self._read_frame(reader, first), "handshake")
            except (asyncio.IncompleteReadError, ConnectionError,
                    _ConnReaped):
                return
            if dtype != wire.COMM_REGISTER_REQ:
                self.rt.stats.bump("conns_unregistered")
                return
            req = np.frombuffer(payload, wire.REGISTER_REQ_DT, count=1)[0]
            status, host_id = self._register(req)
            # v4 tail: the durable sweep-seq high-water mark for this
            # host — a reconnecting agent prunes already-durable sweeps
            # from its resend spool (the WAL dedup contract)
            last_seq = 0
            preagg = None
            if (status == wire.REG_OK
                    and int(req["conn_type"]) == wire.CONN_EVENT
                    and host_id != 0xFFFFFFFF):
                last_seq = int(getattr(self.rt, "_sweep_last_seq",
                                       {}).get(host_id, 0))
                # edge pre-aggregation advert (wire v5): when the
                # server opts in (preagg=True), tell the agent EXACTLY
                # which sketch geometry to fold with — the engine-cfg
                # constants its delta partials must land in
                # (sketch/edgefold.py). Pre-v5 agents ignore the tail.
                from gyeeta_tpu_torch.sketch import edgefold
                if self.preagg:
                    preagg = edgefold.params_of_cfg(self.rt.cfg)
                    self.rt.stats.bump("preagg_agents_negotiated")
            writer.write(wire.encode_register_resp(
                status, host_id, version.CURR_WIRE_VERSION, last_seq,
                preagg=preagg))
            await writer.drain()
            if status != wire.REG_OK:
                return
            if int(req["conn_type"]) == wire.CONN_EVENT:
                if host_id != 0xFFFFFFFF:
                    self._event_writers[host_id] = writer
                    # reconnect resync: re-push full capture state
                    self.rt.tracedefs.forget_host(host_id)
                try:
                    if self._ingest is not None \
                            and host_id != 0xFFFFFFFF:
                        await self._handoff_event_conn(
                            reader, writer, host_id, conn_id)
                    else:
                        await self._event_loop(reader, host_id,
                                               conn_id=conn_id)
                finally:
                    if self._event_writers.get(host_id) is writer:
                        del self._event_writers[host_id]
                        # applied capture state is unknowable once the
                        # conn drops; rebuild it on reconnect
                        self.rt.tracedefs.forget_host(host_id)
            else:
                await self._query_loop(reader, writer)
        except wire.FrameError as e:
            log.warning("conn %s: %s — closing", peer, e)
            self.rt.stats.bump("conns_framing_errors")
            # attribute the reject (bad_magic / bad_size / truncated /
            # bad_frame) — the no-silent-loss accounting surface
            self.rt.stats.bump(
                "frames_rejected|reason="
                f"{getattr(e, 'reason', 'bad_frame')}")
        except _ConnReaped as e:
            log.info("conn %s: %s", peer, e)
        finally:
            self._open_conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):   # pragma: no cover
                pass

    async def _handoff_event_conn(self, reader, writer, host_id: int,
                                  conn_id: int) -> None:
        """Multi-process ingest: hand this registered event conn's
        socket to its shard group's worker and park until it dies.

        The transport stops reading FIRST; whatever the stream reader
        already buffered ships to the worker as initial bytes (no
        awaits between the pause and the snapshot, so no byte can
        slip past). This process keeps the (paused) transport: the
        reverse direction — trace control, COMM_THROTTLE — still
        writes from the supervisor, while the worker owns every read.
        A worker crash (or its conn_closed notice) sets the death
        event; unwinding closes the socket and the agent reconnects
        through this listener — same port, same sticky hid, same
        shard group after the respawn."""
        transport = writer.transport
        transport.pause_reading()
        initial = bytes(reader._buffer)          # noqa: SLF001
        reader._buffer.clear()                   # noqa: SLF001
        sock = writer.get_extra_info("socket")
        death = asyncio.Event()
        if sock is None or not self._ingest.handoff(
                host_id, conn_id, sock.fileno(), initial, death):
            # owning worker down (respawn window): close — the agent's
            # supervision loop retries and lands on the fresh worker
            self.rt.stats.bump("ingest_handoff_failed")
            return
        self.rt.stats.bump("ingest_conns_handed_off")
        await death.wait()

    async def _event_loop(self, reader, host_id: int = 0,
                          ref_session=None, conn_id: int = 0) -> None:
        """Bulk ingest: socket bytes → Runtime.feed.

        Partial-frame reassembly happens HERE, per connection: the
        runtime decoder is shared by every conn, so each conn's
        trailing partial frame must be held back or another conn's
        bytes would splice into the middle of it (the reference's
        per-conn recv buffers give the same guarantee,
        ``common/gy_epoll_conntrack.h`` partial-read resume).

        A conn whose frames carry the REFERENCE's COMM_HEADER magics
        (a stock partha / gy_comm_proto producer) is detected by its
        first complete header and routed through the ingest adapter
        (``ingest/refproto.py``) — adapted GYT frames feed the same
        runtime path, and the capture recorder sees the ADAPTED bytes
        (recorded bytes are always replayable GYT frames)."""
        pending = b""
        ref_mode = False
        if ref_session is None:               # per-conn adapter state
            ref_session = refproto.RefSession()
        while True:
            # idle deadline: an agent conn that stops sweeping (half-
            # open, wedged peer) is reaped on the sweep-cadence budget
            data = await self._tread(reader.read(_READ_SZ), "idle")
            if not data:
                if pending:
                    # EOF mid-frame: the tail was truncated in flight —
                    # count it, don't just drop it on the floor
                    self.rt.stats.bump(
                        "frames_rejected|reason=truncated")
                return
            data = pending + data
            if not ref_mode and len(data) >= 4 and int.from_bytes(
                    data[:4], "little") in refproto.REF_MAGICS:
                ref_mode = True
                self.rt.stats.bump("conns_ref_adapted")
            if ref_mode:
                try:
                    gyt, k = refproto.adapt(data, host_id,
                                            session=ref_session)
                except wire.FrameError:
                    self.rt.stats.bump("frames_bad")
                    raise
                pending = data[k:]
                if gyt:
                    self._feed(gyt, host_id, conn_id)
                    # pipeline mode records inside the pipeline (only
                    # validated buffers)
                    rec = self._recorder
                    if rec is not None and self._pipe is None:
                        rec.write(gyt)
                # drain AFTER the feed: domain payloads reference
                # listeners whose LISTENER_INFO may ride the same batch
                self._drain_ref_session(ref_session)
                continue
            try:
                k = wire.complete_prefix(data)
            except wire.FrameError:
                # poison header: close the conn — the agent reconnects
                # and resyncs (the reference closes on bad COMM_HEADER)
                self.rt.stats.bump("frames_bad")
                raise
            pending = data[k:]
            if k:
                # feed FIRST: a chunk that fails deep validation
                # (nevents caps) must not poison the capture file —
                # recorded bytes are exactly the ingested bytes
                if self._batch_feeds:
                    await self._feed_later(data[:k], host_id, conn_id)
                else:
                    self._feed(data[:k], host_id, conn_id)
                rec = self._recorder   # no await between check & write
                if rec is not None and self._pipe is None:
                    rec.write(data[:k])

    async def _query_loop(self, reader, writer) -> None:
        try:
            await self._query_loop_inner(reader, writer)
        finally:
            # conn teardown IS unsubscribe: every subscription this
            # conn registered stops costing a render share
            self.subs.unsubscribe_conn(writer)

    async def _subscribe_cmd(self, writer, payload) -> bool:
        """One COMM_SUBSCRIBE_CMD → hub registration whose pushes ride
        this conn as QS_PARTIAL QUERY_RESP frames (seqid echoed).
        Returns False on a recoverable envelope error (the conn and
        its error budget continue)."""
        from gyeeta_tpu_torch.net.subs import SubscribeError
        try:
            seqid, _, req = wire.decode_query_payload(payload)
        except Exception:
            self.rt.stats.bump("frames_rejected|reason=bad_query")
            return False

        async def send(ev, _seqid=seqid, _w=writer):
            _w.write(wire.encode_query(_seqid, ev, wire.QS_PARTIAL,
                                       resp=True))
            if self.write_timeout:
                await asyncio.wait_for(_w.drain(), self.write_timeout)
            else:
                await _w.drain()

        try:
            last = (req or {}).get("last_snaptick")
            await self.subs.subscribe(req or {}, send,
                                      last_snaptick=last,
                                      conn_tag=writer)
            self.rt.stats.bump("net_subscribes")
            return True
        except (SubscribeError, ValueError, RuntimeError) as e:
            writer.write(wire.encode_query(seqid, {"error": str(e)},
                                           wire.QS_ERROR, resp=True))
            await writer.drain()
            return False

    async def _query_loop_inner(self, reader, writer) -> None:
        outstanding = 0
        bad_frames = 0
        while True:
            try:
                # a conn holding subscriptions is PUSH-only from here:
                # it legitimately never sends another frame, so the
                # idle reap does not apply (dead conns surface as
                # failed pushes and unsubscribe there)
                if self.subs.conn_subscribed(writer):
                    dtype, payload = await self._read_frame(reader)
                else:
                    dtype, payload = await self._tread(
                        self._read_frame(reader), "idle")
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if dtype == wire.COMM_SUBSCRIBE_CMD:
                if not await self._subscribe_cmd(writer, payload):
                    bad_frames += 1
                    if bad_frames > self.frame_error_budget:
                        self.rt.stats.bump(
                            "frames_rejected|reason=error_budget")
                        return
                continue
            if dtype != wire.COMM_QUERY_CMD:
                self.rt.stats.bump("frames_unknown_type")
                bad_frames += 1
                if bad_frames > self.frame_error_budget:
                    # per-conn error budget: N recoverable frame-level
                    # errors → close (a peer spraying junk that parses
                    # as frames must not spin the loop forever)
                    self.rt.stats.bump(
                        "frames_rejected|reason=error_budget")
                    return
                continue
            try:
                seqid, _, req = wire.decode_query_payload(payload)
            except Exception:
                self.rt.stats.bump("frames_rejected|reason=bad_query")
                bad_frames += 1
                if bad_frames > self.frame_error_budget:
                    self.rt.stats.bump(
                        "frames_rejected|reason=error_budget")
                    return
                continue
            if outstanding >= wire.MAX_OUTSTANDING_QUERIES:
                writer.write(wire.encode_query(
                    seqid, {"error": "busy"}, wire.QS_BUSY, resp=True))
                await writer.drain()
                continue
            outstanding += 1
            try:
                self.rt.stats.bump("net_queries")
                out = await self.run_query(req)
            except Exception as e:
                from gyeeta_tpu_torch.net.qexec import Overloaded
                outstanding -= 1
                # admission-control shed answers QS_BUSY (counted in
                # gyt_queries_shed_total) — the client backs off; a
                # plain error keeps the conn and the loop alive
                status = wire.QS_BUSY if isinstance(e, Overloaded) \
                    else wire.QS_ERROR
                writer.write(wire.encode_query(seqid, {"error": str(e)},
                                               status, resp=True))
                await writer.drain()
                continue
            try:
                # large results stream as QS_PARTIAL chunks with a drain
                # per chunk: bounded transport memory (the 16MB-frame /
                # multi-GB discipline of the reference webserver)
                sent = 0
                try:
                    for frame in wire.iter_query_frames(seqid, out,
                                                        wire.QS_OK):
                        writer.write(frame)
                        await writer.drain()
                        sent += 1
                except Exception as e:
                    if sent == 0 and not isinstance(e, ConnectionError):
                        # e.g. unserializable result: the query still
                        # gets its QS_ERROR and the conn survives
                        writer.write(wire.encode_query(
                            seqid, {"error": str(e)}, wire.QS_ERROR,
                            resp=True))
                        await writer.drain()
                    else:
                        raise   # mid-stream failure: close (resync)
            finally:
                outstanding -= 1
