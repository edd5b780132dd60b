"""Agent-side clients: NetAgent (partha equivalent) + QueryClient.

NetAgent mirrors partha's connection bring-up (ref
``partha/gy_paconnhdlr.cc:1200`` blocking_shyama_register →
``:1665`` connect_madhava): open a TCP conn, send REGISTER_REQ with the
machine-id, learn the assigned ``host_id``, then construct a single-host
``ParthaSim`` at that global host index and stream its telemetry as
EVENT_NOTIFY frames. On reconnect the machine-id maps back to the same
host_id (sticky placement), and the agent resends its name announcements
(the resend-inventory-on-reconnect recovery of the reference,
``gy_socket_stat.h:1235``).

:meth:`NetAgent.run_forever` is the supervision tier (the parmon
respawn loop of the reference, ``gypartha.cc:965``, collapsed into the
agent itself): jittered exponential-backoff reconnects, sweeps KEEP
being produced on cadence during an outage and buffer in a bounded
spool (drop-oldest, every drop counted), and the spool resends on
reconnect — at-least-once delivery of sweeps within the spool bound,
with agent-side counters (``stats``) reported to the server as
NOTIFY_AGENT_STATS deltas so fleet-wide loss renders in /metrics.

QueryClient is the Node-webserver peer: a query-role conn multiplexing
JSON queries by seqid. Both clients dial and read under deadlines — a
wedged server yields a clear timeout error plus a counter, never an
infinite hang.

Counterpart of ``gyeeta_tpu/net/agent.py``: the same seed, host id and
sweep count build the same wire bytes, through the port's ``wire``,
``ParthaSim``, ``EdgeFold`` and ``hash_bytes_np``. The agent does no
device work and imports no ``torch`` on its raw path; the host
collectors read their knobs from the ``env`` mapping a caller hands
over (``None`` means no environment). ``livecap=True`` opens the
port's ``trace/livecap.LiveCapture`` on the traced listeners' ports and
parses their traffic with the port's protocol parsers, as the
reference does; a refused AF_PACKET socket (no CAP_NET_RAW) turns the
capture off for good (``_cap_denied``) and raises nothing.
"""

from __future__ import annotations

import asyncio
import collections
import random
from typing import Optional

import numpy as np

from gyeeta_tpu_torch import version
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.sim.partha import ParthaSim
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.selfstats import Stats

_HSZ = wire.HEADER_DT.itemsize

# one validated reader on both ends of the wire (ingest/wire.py): magic
# gate + total_sz/padding bounds before any body read — a corrupt header
# can neither hang readexactly on a multi-MB read nor crash a short one
_read_frame = wire.read_frame

# errors that mean "the conn is gone / unusable" to a supervised client
_CONN_ERRORS = (ConnectionError, OSError, EOFError,
                asyncio.IncompleteReadError, wire.FrameError,
                asyncio.TimeoutError, TimeoutError)


async def register_ex(host: str, port: int, machine_id: int,
                      conn_type: int,
                      wire_version: int = version.CURR_WIRE_VERSION,
                      hostname_id: int = 0):
    """Open + register one conn → (reader, writer, status, host_id,
    last_seq, preagg). ``last_seq`` is the server's durable sweep-seq
    high-water mark for this host (0 from pre-v4 servers) — the WAL
    dedup handshake (see ``wire.NOTIFY_SWEEP_SEQ``); ``preagg`` is the
    server's edge pre-aggregation advert (the v5 tail — the sketch
    geometry delta sweeps must fold with), or None."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(wire.encode_register_req(
            machine_id, conn_type, wire_version, hostname_id))
        await writer.drain()
        dtype, payload = await _read_frame(reader)
    except BaseException:
        writer.close()
        raise
    if dtype != wire.COMM_REGISTER_RESP:
        writer.close()
        raise wire.FrameError(f"expected REGISTER_RESP, got {dtype}")
    status, host_id, _ver, last_seq, preagg = \
        wire.decode_register_resp(payload)
    return reader, writer, status, host_id, last_seq, preagg


async def register(host: str, port: int, machine_id: int, conn_type: int,
                   wire_version: int = version.CURR_WIRE_VERSION,
                   hostname_id: int = 0):
    """Open + register one conn → (reader, writer, status, host_id)."""
    reader, writer, status, host_id, _seq, _pre = await register_ex(
        host, port, machine_id, conn_type, wire_version, hostname_id)
    return reader, writer, status, host_id


class NetAgent:
    """One host agent over a real socket.

    ``collect=True`` turns on the REAL host collectors
    (``net/collect.py``): host inventory, 2s CPU/mem gauges, and cgroup
    sweeps are then measured from this machine's /proc //sys instead of
    simulated; conn/resp/listener/task streams stay simulated (their
    kernel-side capture has no userspace equivalent — the reference
    needs eBPF for them)."""

    def __init__(self, machine_id: Optional[int] = None, seed: int = 0,
                 n_svcs: int = 4, n_groups: int = 6,
                 wire_version: int = version.CURR_WIRE_VERSION,
                 collect: bool = False, real: bool = False,
                 livecap: bool = False, cap_ifname: str = "lo",
                 connect_timeout: float = 15.0,
                 spool_max_bytes: int = 8 << 20,
                 resend_last: int = 2,
                 preagg: Optional[bool] = None,
                 env=None):
        self.machine_id = machine_id if machine_id is not None \
            else H.hash_bytes_np(f"sim-agent-{seed}".encode())
        self.seed = seed
        self.n_svcs = n_svcs
        self.n_groups = n_groups
        self.wire_version = wire_version
        self.collect = collect
        # knob mapping of the host collectors (GYT_CLOUD_META,
        # GYT_CLOUD_META_URL, GYT_STAT_NETFS, the container marker)
        self.env = {} if env is None else env
        # real=True: flows/listeners come from THIS host's kernel via
        # the sock_diag sweep (net/tcpconn.py) instead of the simulator
        # — the inet_diag path of the reference
        # (``common/gy_socket_stat.cc:8598``). resp/trace streams stay
        # absent in real mode (they need eBPF the reference has and
        # userspace does not).
        self.real = real
        # livecap=True (with real=True): REQ_TRACE_SET enables start a
        # privilege-gated AF_PACKET capture of the traced listeners'
        # ports; parsed transactions stream as REQ_TRACE frames — the
        # reference's per-svc capture activation (gy_svc_net_capture.h
        # :153), with the packet socket as the observation point
        self.livecap = livecap
        self.cap_ifname = cap_ifname
        self._cap = None
        self._cap_ports: set = set()
        self._cap_denied = False      # CAP_NET_RAW refused (final)
        # captures opened, and closed by a sweep that found no traced
        # port (the exit report's ``livecap`` entry)
        self._cap_opens = 0
        self._cap_closes = 0
        self.host_id: Optional[int] = None
        self.sim: Optional[ParthaSim] = None
        self._tcpconn = None
        self._taskproc = None
        self._cpumem = None
        self._cgroups = None
        self._mounts = None
        self._netifs = None
        self._writer = None
        self._ctrl_task = None
        # svc glob ids with capture enabled by the server (REQ_TRACE_SET
        # analogue); empty = no tracing
        self.trace_enabled: set = set()
        # ---- delivery continuity (the supervised-reconnect tier)
        # dial deadline: a wedged server must yield a clear timeout
        # error + counter, never an infinite hang
        self.connect_timeout = connect_timeout
        # agent-side self-metrics: reconnects, spool drops/resends,
        # records built/sent — the loss-accounting surface; deltas are
        # reported to the server as NOTIFY_AGENT_STATS on reconnect
        self.stats = Stats()
        # bounded sweep spool: sweeps produced during an outage buffer
        # here (oldest first) and resend on reconnect; drop-oldest when
        # past spool_max_bytes, every drop counted (sweeps AND records)
        self.spool_max_bytes = spool_max_bytes
        self._spool: collections.deque = collections.deque()
        self._spool_bytes = 0
        # recently-sent sweeps held unconfirmed: a write into a dying
        # socket "succeeds" into the kernel buffer, so the last few
        # sweeps respool on conn loss (at-least-once; duplicates are
        # fold noise, silent loss is not)
        self._unconfirmed: collections.deque = collections.deque(
            maxlen=max(1, resend_last))
        self._stats_reported: dict = {}
        # set by the control-loop reader the moment the conn's read
        # half hits EOF/reset — the supervisor's fast-fail signal
        self._conn_dead = False
        # ---- durable-ingest additions (wire v4)
        # monotone per-process sweep counter: every built sweep opens
        # with a NOTIFY_SWEEP_SEQ mark carrying it. The server journals
        # the high-water mark with its checkpoints and echoes it back
        # in REGISTER_RESP, so a reconnect prunes already-DURABLE
        # sweeps from the spool (checkpoint + WAL replay + resend never
        # double-folds a sweep)
        self._sweep_seq = 0
        # server→agent admission control (COMM_THROTTLE): feed class →
        # monotonic deadline until which that class holds in the spool
        self._hold_until: dict[int, float] = {}
        # ---- edge pre-aggregation (wire v5, sketch/edgefold.py)
        # preagg=None follows the server's REGISTER_RESP advert (the
        # serve-negotiated default: GYT_PREAGG=1 on the server flips
        # the fleet); False opts this agent out; True REQUIRES the
        # advert and falls back raw COUNTED when it is absent (the
        # agent cannot guess the server's sketch geometry). Sim-mode
        # only: real collectors keep the raw contract.
        self.preagg = preagg
        self._preagg_params: Optional[dict] = None
        self._edgefold = None

    async def connect(self, host: str, port: int,
                      timeout: Optional[float] = None) -> int:
        """Register the event conn under a dial deadline; returns the
        assigned host_id. Raises ``ConnectionError`` with a clear
        message (and bumps ``connect_timeouts``) when the deadline
        fires against a wedged server."""
        t = self.connect_timeout if timeout is None else timeout
        try:
            return await asyncio.wait_for(self._connect(host, port), t)
        except (asyncio.TimeoutError, TimeoutError):
            self.stats.bump("connect_timeouts")
            self._drop_conn()     # _connect may have died mid-bring-up
            raise ConnectionError(
                f"agent connect to {host}:{port} timed out "
                f"after {t:.1f}s") from None

    async def _connect(self, host: str, port: int) -> int:
        # the server re-applies capture state from scratch on reconnect
        # (forget_host → full re-push of current targets only); stale
        # local enables from before the drop must not survive it — and
        # neither may a still-draining old control loop, which could
        # decode a buffered TRACE_SET and re-add them after the clear
        if self._ctrl_task:
            self._ctrl_task.cancel()
            self._ctrl_task = None
        self.trace_enabled.clear()
        self._conn_dead = False
        hostname_id = self.machine_id & 0xFFFFFFFF
        reader, writer, status, hid, last_seq, preagg_adv = \
            await register_ex(
                host, port, self.machine_id, wire.CONN_EVENT,
                self.wire_version, hostname_id)
        if status != wire.REG_OK:
            writer.close()
            raise ConnectionRefusedError(f"registration status {status}")
        self.host_id = hid
        self._writer = writer
        # the server's durable high-water mark: sweeps at or below it
        # are already in its checkpoint+WAL — drop them from the resend
        # surfaces instead of double-folding them (counted)
        if last_seq:
            self._prune_acked(last_seq)
        # a 1-host sim rooted at the assigned global host index —
        # glob_ids/task_ids derive from it, so streams are fleet-unique.
        # Sticky reconnects (same hid) KEEP the sim: telemetry produced
        # during the outage stays continuous instead of replaying from
        # the seed (the reference agent keeps collecting while down)
        if self.sim is None or self.sim.host_base != hid:
            self.sim = ParthaSim(
                n_hosts=1, n_svcs=self.n_svcs, n_groups=self.n_groups,
                seed=1000 + hid, host_base=hid)
        # edge pre-aggregation: enable only on a server advert (the
        # advert carries the sketch geometry the partials must land
        # in); the local fold's cumulative HLL state survives sticky
        # reconnects like the sim does
        self._preagg_params = None
        if (preagg_adv is not None and self.preagg is not False
                and not self.real):
            self._preagg_params = preagg_adv
            if self._edgefold is None \
                    or self._edgefold.host_id != hid \
                    or self._edgefold.params != preagg_adv:
                from gyeeta_tpu_torch.sketch.edgefold import EdgeFold
                self._edgefold = EdgeFold(preagg_adv, host_id=hid)
        elif self.preagg:
            # explicit opt-in against a server that never advertised:
            # stay raw, counted (never guess the sketch geometry)
            self.stats.bump("preagg_not_advertised")
        if self.collect:
            from gyeeta_tpu_torch.net import collect as C
            self._cpumem = C.CpuMemCollector(host_id=hid)
            self._cgroups = C.CgroupCollector(host_id=hid)
            self._cgroups.sample()        # prime the delta baseline
            self._mounts = C.MountCollector(host_id=hid, env=self.env)
            self._netifs = C.NetIfCollector(host_id=hid)
            self._netifs.sample()         # prime the rate baseline
        if self.real:
            from gyeeta_tpu_torch.net.taskproc import ProcTaskCollector
            from gyeeta_tpu_torch.net.tcpconn import TcpConnCollector
            self._tcpconn = TcpConnCollector(
                host_id=hid, machine_id=self.machine_id)
            if self._taskproc is not None:
                self._taskproc.close()    # reconnect: no netlink leak
            self._taskproc = ProcTaskCollector(
                host_id=hid, machine_id=self.machine_id)
        # server→agent control frames ride the same conn in reverse
        self._ctrl_task = asyncio.create_task(self._control_loop(reader))
        await self.send_names()
        return hid

    async def _control_loop(self, reader) -> None:
        """Apply COMM_TRACE_SET capture control from the server.

        Doubles as the conn-death watch: the read half sees the
        server's FIN/RST immediately, while the write half can keep
        "succeeding" into kernel buffers for several sweeps — sweeps
        that would slip past the unconfirmed ring. The ``_conn_dead``
        flag makes the supervisor stop sending the instant EOF lands."""
        try:
            while True:
                try:
                    dtype, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError,
                        OSError, wire.FrameError):
                    return
                if dtype == wire.COMM_THROTTLE:
                    # admission control: hold the named feed classes in
                    # the spool for hold_ms (0 releases early). Unknown
                    # feed ids are skipped — forward compatible, the
                    # NOTIFY_AGENT_STATS versioning discipline
                    now = asyncio.get_running_loop().time()
                    for t in wire.decode_throttle(payload):
                        feed = int(t["feed"])
                        if feed not in (wire.FEED_TRACE, wire.FEED_ALL):
                            continue
                        hold = int(t["hold_ms"])
                        if hold:
                            self._hold_until[feed] = now + hold / 1e3
                            self.stats.bump(
                                "throttle_held|feed="
                                + ("all" if feed == wire.FEED_ALL
                                   else "trace"))
                        else:
                            self._hold_until.pop(feed, None)
                    continue
                if dtype != wire.COMM_TRACE_SET:
                    continue
                for r in wire.decode_trace_set(payload):
                    if r["enable"]:
                        self.trace_enabled.add(int(r["svc_glob_id"]))
                    else:
                        self.trace_enabled.discard(int(r["svc_glob_id"]))
        finally:
            # only the CURRENT conn's watcher may flag death — a
            # cancelled predecessor's late finally must not poison a
            # freshly established conn
            if self._ctrl_task is asyncio.current_task():
                self._conn_dead = True

    async def send_names(self) -> None:
        """Announce inventory: names + listener metadata + host info
        (the reference agent resends its inventory on reconnect)."""
        import os
        hostname = (os.uname().nodename if (self.collect or self.real)
                    else f"agent-{self.host_id}.sim")
        buf = b""
        if not self.real:
            # sim inventory; real listeners announce themselves on the
            # first sweep (the collector emits LISTENER_INFO on sight)
            buf += (self.sim.name_frames()
                    + wire.encode_frame(wire.NOTIFY_LISTENER_INFO,
                                        self.sim.listener_info_records()))
        # hostname AFTER sim names: the sim announces a placeholder
        # host name and the intern table is last-write-wins
        buf += wire.encode_frame(
            wire.NOTIFY_NAME_INTERN,
            wire_name_record(wire.NAME_KIND_HOST, self.host_id,
                             hostname))
        if self.collect:
            from gyeeta_tpu_torch.net import collect as C
            hi, names = C.collect_host_info(host_id=self.host_id,
                                            env=self.env)
            buf += (wire.encode_frame(wire.NOTIFY_NAME_INTERN, names)
                    + wire.encode_frame(wire.NOTIFY_HOST_INFO, hi))
        else:
            buf += self.sim.host_info_frames()
        self._writer.write(buf)
        await self._writer.drain()

    async def send_sweep(self, n_conn: int = 256, n_resp: int = 512
                         ) -> None:
        """One 5s-equivalent sweep: flows, resp samples, state records."""
        buf = self.build_sweep(n_conn, n_resp)
        self._writer.write(buf)
        await self._writer.drain()

    def _held(self, feed: int) -> bool:
        """True while the server's COMM_THROTTLE hold on ``feed`` is
        active (expired holds are dropped lazily)."""
        until = self._hold_until.get(feed)
        if until is None:
            return False
        try:
            now = asyncio.get_running_loop().time()
        except RuntimeError:              # sync caller (tests)
            import time as _t
            now = _t.monotonic()
        if now >= until:
            del self._hold_until[feed]
            return False
        return True

    def _sweep_mark(self) -> bytes:
        """One NOTIFY_SWEEP_SEQ record opening the sweep (the WAL
        dedup mark — see ``_connect``)."""
        self._sweep_seq += 1
        rec = np.zeros(1, wire.SWEEP_SEQ_DT)
        rec["host_id"] = self.host_id or 0
        rec["seq"] = self._sweep_seq
        return wire.encode_frame(wire.NOTIFY_SWEEP_SEQ, rec)

    def build_sweep(self, n_conn: int = 256, n_resp: int = 512) -> bytes:
        """Build one sweep's frames WITHOUT sending (the supervisor
        keeps producing on cadence during an outage and spools these).
        Opens with a sweep-seq mark (WAL dedup)."""
        s = self.sim
        mark = self._sweep_mark()
        if self.real:
            buf = mark + self._real_sweep_frames()
        else:
            if self._preagg_params is not None:
                # edge pre-aggregation: fold the conn/resp streams
                # locally and ship ONE mergeable-delta stream instead
                # of N raw tuples (sketch/edgefold.py); the 5s state
                # sweeps (listener/task/host) are already one record
                # per entity and stay raw
                conn = s.conn_records(n_conn)
                resp = s.resp_records(n_resp)
                delta = self._edgefold.fold_sweep(conn, resp)
                hot = wire.encode_frames_chunked(
                    wire.NOTIFY_SKETCH_DELTA, delta)
                self.stats.bump("preagg_sweeps")
                self.stats.bump("preagg_source_records",
                                len(conn) + len(resp))
                self.stats.bump("preagg_delta_records", len(delta))
            else:
                hot = s.conn_frames(n_conn) + s.resp_frames(n_resp)
            buf = (mark + hot
                   + s.listener_frames() + s.task_frames()
                   + wire.encode_frame(wire.NOTIFY_HOST_STATE,
                                       s.host_state_records()))
            if self.trace_enabled and not self._held(wire.FEED_TRACE):
                # capture on for some services: emit their transactions
                # (priority-aware shedding: a FEED_TRACE hold drops the
                # trace stream from the sweep FIRST, so svc/task state
                # — the health classification inputs — degrade last)
                buf += s.trace_frames(n_resp,
                                      only_svcs=self.trace_enabled)
            elif self.trace_enabled:
                self.stats.bump("trace_frames_throttled")
        if self.collect:
            buf += wire.encode_frame(wire.NOTIFY_CPU_MEM_STATE,
                                     self._cpumem.sample())
            cg, cgnames = self._cgroups.sample()
            if len(cgnames):
                buf += wire.encode_frame(wire.NOTIFY_NAME_INTERN,
                                         cgnames)
            if len(cg):
                buf += wire.encode_frame(wire.NOTIFY_CGROUP_STATE, cg)
            for sub, (recs, names) in (
                    (wire.NOTIFY_MOUNT_STATE, self._mounts.sample()),
                    (wire.NOTIFY_NETIF_STATE, self._netifs.sample())):
                buf += wire.encode_frames_chunked(
                    wire.NOTIFY_NAME_INTERN, names)
                buf += wire.encode_frames_chunked(sub, recs)
        else:
            buf += (s.cgroup_frames()
                    + wire.encode_frame(wire.NOTIFY_CPU_MEM_STATE,
                                        s.cpu_mem_records()))
        return buf

    def _real_sweep_frames(self) -> bytes:
        """One real sock_diag sweep → wire frames (cap-split per type)."""
        import time as _time

        d = self._tcpconn.sweep()
        trecs, tnames = self._taskproc.sweep(
            task_net=d["task_net"],
            listener_of_comm=d["listener_of_comm"])
        buf = (wire.encode_frames_chunked(wire.NOTIFY_NAME_INTERN,
                                          d["names"])
               + wire.encode_frames_chunked(wire.NOTIFY_NAME_INTERN,
                                            tnames)
               + wire.encode_frames_chunked(wire.NOTIFY_LISTENER_INFO,
                                            d["listener_info"])
               + wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN,
                                            d["conns"])
               + wire.encode_frames_chunked(wire.NOTIFY_LISTENER_STATE,
                                            d["listeners"])
               + wire.encode_frames_chunked(
                   wire.NOTIFY_AGGR_TASK_STATE, trecs))
        hs = np.zeros(1, wire.HOST_STATE_DT)
        hs[0]["curr_time_usec"] = int(_time.time() * 1e6)
        hs[0]["nlisten"] = len(d["listeners"])
        hs[0]["ntasks"] = int(trecs["ntasks_total"].sum())
        hs[0]["ntasks_issue"] = int(trecs["ntasks_issue"].sum())
        hs[0]["curr_state"] = 1               # OK; issues come from the
        hs[0]["host_id"] = self.host_id       # server-side classifiers
        buf += wire.encode_frame(wire.NOTIFY_HOST_STATE, hs)
        if self.livecap:
            buf += self._livecap_frames()
        return buf

    def _livecap_frames(self) -> bytes:
        """Drain the live capture → REQ_TRACE frames for traced svcs.

        The capture's port set tracks the TRACED listeners (trace
        control diff → ports via the sock_diag listener registry).
        Retargeting mutates the live socket's port filter in place —
        still-traced services keep their buffered frames and in-flight
        TCP state. Degrades to no-op without CAP_NET_RAW (cached);
        transient open failures retry next sweep."""
        from gyeeta_tpu_torch.trace import livecap as LC
        from gyeeta_tpu_torch.trace.proto import transactions_to_records

        want = self._tcpconn.listener_ports(self.trace_enabled)
        if not want:
            if self._cap is not None:
                self._cap.close()
                self._cap = None
                self._cap_closes += 1
            self._cap_ports = set()
            return b""
        if self._cap is None:
            if self._cap_denied:
                return b""
            try:
                self._cap = LC.LiveCapture(self.cap_ifname, ports=want)
                self._cap_ports = set(want)
                self._cap_opens += 1
            except PermissionError:
                self._cap_denied = True       # no CAP_NET_RAW: final
                return b""
            except OSError:
                return b""                    # transient: retry later
        elif want != self._cap_ports:
            # in-place retarget: keep the socket + buffered frames
            self._cap.ports = set(want)
            self._cap_ports = set(want)
        self._cap.poll()
        buf = b""
        for f in self._cap.drain():
            gid = self._tcpconn.resolve_listener(
                f.ser[0], f.ser[1], gids=self.trace_enabled)
            if gid is None:
                continue
            recs, name_recs = transactions_to_records(
                f.transactions, svc_glob_id=gid, host_id=self.host_id)
            buf += (wire.encode_frames_chunked(
                wire.NOTIFY_NAME_INTERN, name_recs)
                + wire.encode_frames_chunked(wire.NOTIFY_REQ_TRACE,
                                             recs))
        return buf

    # --------------------------------------------------- supervision tier
    def _spool_push(self, buf: bytes, nrec: int, seq: int = 0) -> None:
        """Buffer one undelivered sweep; drop-oldest past the byte
        bound, every drop counted (sweeps and records — the no-silent-
        loss accounting). ``seq`` is the sweep's dedup mark (0 = not a
        marked sweep, never pruned by the server ack)."""
        self._spool.append((buf, nrec, seq))
        self._spool_bytes += len(buf)
        self.stats.bump("sweeps_spooled")
        while self._spool_bytes > self.spool_max_bytes \
                and len(self._spool) > 1:
            old, oldrec, _ = self._spool.popleft()
            self._spool_bytes -= len(old)
            self.stats.bump("spool_dropped")
            self.stats.bump("spool_dropped_records", oldrec)

    def spool_len(self) -> int:
        return len(self._spool)

    def spool_records(self) -> int:
        """Records currently buffered (spool + unconfirmed tail)."""
        return (sum(n for _, n, _ in self._spool)
                + sum(n for _, n, _ in self._unconfirmed))

    def _respool_unconfirmed(self) -> None:
        """Conn lost: the last few written sweeps may have died in the
        kernel buffer — move them to the spool front (oldest first) so
        the reconnect resends them (at-least-once delivery)."""
        for buf, nrec, seq in reversed(self._unconfirmed):
            self._spool.appendleft((buf, nrec, seq))
            self._spool_bytes += len(buf)
        self._unconfirmed.clear()
        # re-apply the bound from the old end
        while self._spool_bytes > self.spool_max_bytes \
                and len(self._spool) > 1:
            old, oldrec, _ = self._spool.popleft()
            self._spool_bytes -= len(old)
            self.stats.bump("spool_dropped")
            self.stats.bump("spool_dropped_records", oldrec)

    def _prune_acked(self, last_seq: int) -> None:
        """Drop sweeps the server proved DURABLE (seq ≤ its
        REGISTER_RESP high-water mark) from the spool and the
        unconfirmed ring: the checkpoint+WAL already hold them, so a
        resend would double-fold (counted, the dedup half of the WAL
        contract)."""
        npruned = nrec_pruned = 0
        for ring in (self._spool, self._unconfirmed):
            keep = [e for e in ring
                    if not (e[2] and e[2] <= last_seq)]
            npruned += len(ring) - len(keep)
            for e in ring:
                if e[2] and e[2] <= last_seq:
                    nrec_pruned += e[1]
                    if ring is self._spool:
                        self._spool_bytes -= len(e[0])
            ring.clear()
            ring.extend(keep)
        if npruned:
            self.stats.bump("spool_pruned_acked", npruned)
            self.stats.bump("spool_pruned_records", nrec_pruned)
            # pruned-from-ring sweeps were delivered AND made durable
            self.stats.bump("records_sent", nrec_pruned)

    async def _send_buf(self, buf: bytes, nrec: int, seq: int = 0) -> None:
        """Write one sweep and account it as (tentatively) delivered."""
        if self._conn_dead or self._writer.is_closing():
            # the read half already saw the server go away: writing
            # would "succeed" into a dead socket and overflow the
            # unconfirmed ring's recovery window
            raise ConnectionResetError("conn read half saw EOF")
        self._writer.write(buf)
        await self._writer.drain()
        evicted = None
        if len(self._unconfirmed) == self._unconfirmed.maxlen:
            evicted = self._unconfirmed[0]
        self._unconfirmed.append((buf, nrec, seq))
        if evicted is not None:
            self.stats.bump("records_sent", evicted[1])

    async def _resend_spool(self) -> None:
        """Drain the spool over the live conn (oldest first) — on
        reconnect, and whenever a throttle hold expires with sweeps
        still buffered."""
        while self._spool and not self._held(wire.FEED_ALL):
            buf, nrec, seq = self._spool[0]
            await self._send_buf(buf, nrec, seq)
            self._spool.popleft()
            self._spool_bytes -= len(buf)
            self.stats.bump("spool_resent")

    def _drop_conn(self) -> None:
        """Tear down a dead conn quietly (the supervisor's half of
        ``close()`` — collectors and the sim survive for the retry)."""
        if self._ctrl_task:
            self._ctrl_task.cancel()
            self._ctrl_task = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:       # pragma: no cover — already dead
                pass
            self._writer = None

    def _stats_report_frame(self) -> bytes:
        """NOTIFY_AGENT_STATS frame carrying counter DELTAS since the
        last report (server folds them into monotone counters), or
        b"" when nothing changed."""
        rec = np.zeros(1, wire.AGENT_STATS_DT)
        rec["host_id"] = self.host_id or 0
        changed = False
        for fld in ("spool_dropped", "spool_dropped_records",
                    "spool_resent", "connect_timeouts"):
            cur = int(self.stats.counters.get(fld, 0))
            delta = cur - self._stats_reported.get(fld, 0)
            if delta:
                rec[fld] = delta
                self._stats_reported[fld] = cur
                changed = True
        return wire.encode_frame(wire.NOTIFY_AGENT_STATS, rec) \
            if changed else b""

    async def run_forever(self, host: str, port: int, *,
                          interval: float = 5.0, n_conn: int = 256,
                          n_resp: int = 512, backoff_base: float = 0.5,
                          backoff_cap: float = 30.0,
                          backoff_jitter: float = 0.25,
                          stop: Optional[asyncio.Event] = None) -> None:
        """Supervised agent loop: NEVER exits on a connection failure
        (the parmon respawn discipline, ref ``gypartha.cc:965``).

        Sweeps are produced on ``interval`` cadence whether or not the
        conn is up — undeliverable ones spool (bounded, drop-oldest
        counted) and resend on reconnect. Reconnects follow jittered
        exponential backoff (``backoff_base·2^k`` capped at
        ``backoff_cap``, +0..``backoff_jitter`` fraction of jitter,
        deterministic per agent seed). Returns only when ``stop`` is
        set or the task is cancelled."""
        rng = random.Random((self.seed << 1) ^ 0x5EED)
        loop = asyncio.get_running_loop()
        backoff = backoff_base
        next_retry = loop.time()          # connect immediately
        next_sweep: Optional[float] = None
        while not (stop is not None and stop.is_set()):
            now = loop.time()
            # ---- (re)connect phase, backoff-gated
            if self._writer is None and now >= next_retry:
                try:
                    await self.connect(host, port)
                    if int(self.stats.counters.get("agent_connects", 0)):
                        self.stats.bump("agent_reconnects")
                    self.stats.bump("agent_connects")
                    backoff = backoff_base
                    await self._resend_spool()
                    # report AFTER the resend so this reconnect's
                    # resent/dropped counts ride this report
                    report = self._stats_report_frame()
                    if report:
                        self._writer.write(report)
                        await self._writer.drain()
                    if next_sweep is None:
                        next_sweep = loop.time()
                except asyncio.CancelledError:
                    raise
                except _CONN_ERRORS:
                    self.stats.bump("connect_failures")
                    self._drop_conn()
                    self._respool_unconfirmed()
                    next_retry = loop.time() + backoff * (
                        1.0 + backoff_jitter * rng.random())
                    backoff = min(backoff * 2.0, backoff_cap)
            # ---- sweep cadence (runs even while disconnected, once
            # the first registration has given the sim its identity)
            now = loop.time()
            if next_sweep is not None and now >= next_sweep:
                buf = self.build_sweep(n_conn, n_resp)
                seq = self._sweep_seq
                nrec = wire.count_events(buf)
                self.stats.bump("sweeps_built")
                self.stats.bump("records_built", nrec)
                if self._writer is not None \
                        and not self._held(wire.FEED_ALL):
                    try:
                        await self._send_buf(buf, nrec, seq)
                    except _CONN_ERRORS:
                        self.stats.bump("agent_disconnects")
                        self._drop_conn()
                        self._respool_unconfirmed()
                        self._spool_push(buf, nrec, seq)
                        next_retry = loop.time() + backoff * (
                            1.0 + backoff_jitter * rng.random())
                        backoff = min(backoff * 2.0, backoff_cap)
                else:
                    # outage OR a server FEED_ALL throttle hold: the
                    # sweep rides the same bounded spool either way
                    # (server pressure becomes agent-side spooling)
                    if self._writer is not None:
                        self.stats.bump("sweeps_throttled")
                    self._spool_push(buf, nrec, seq)
                next_sweep += interval
            # a throttle hold that expired with sweeps still buffered:
            # drain them now (the reconnect path drains its own spool)
            if (self._writer is not None and self._spool
                    and not self._held(wire.FEED_ALL)):
                try:
                    await self._resend_spool()
                except asyncio.CancelledError:
                    raise
                except _CONN_ERRORS:
                    self.stats.bump("agent_disconnects")
                    self._drop_conn()
                    self._respool_unconfirmed()
                    next_retry = loop.time() + backoff * (
                        1.0 + backoff_jitter * rng.random())
                    backoff = min(backoff * 2.0, backoff_cap)
            # ---- sleep until the next deadline (sweep / retry / stop)
            deadlines = []
            if next_sweep is not None:
                deadlines.append(next_sweep)
            if self._writer is None:
                deadlines.append(next_retry)
            delay = max(0.0, (min(deadlines) if deadlines
                              else interval) - loop.time())
            if stop is not None:
                try:
                    await asyncio.wait_for(stop.wait(),
                                           timeout=max(delay, 0.001))
                except (asyncio.TimeoutError, TimeoutError):
                    pass
            else:
                await asyncio.sleep(max(delay, 0.001))

    async def close(self) -> None:
        if self._ctrl_task:
            self._ctrl_task.cancel()
            self._ctrl_task = None
        if self._taskproc is not None:
            self._taskproc.close()        # netlink TASKSTATS socket
            self._taskproc = None
        if self._cap is not None:
            self._cap.close()             # AF_PACKET socket
            self._cap = None
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None


def wire_name_record(kind: int, name_id: int, name: str) -> np.ndarray:
    from gyeeta_tpu_torch.utils.intern import InternTable
    return InternTable.records([(kind, name_id, name)])


class QueryClient:
    """Query-role conn: JSON queries multiplexed by seqid.

    Dial and per-request deadlines (``connect_timeout`` /
    ``request_timeout``) guard against a wedged server: a fired
    deadline raises a clear error, bumps a counter on ``stats``, and
    resets the conn (the response stream is desynced once a request
    is abandoned mid-flight)."""

    def __init__(self, machine_id: Optional[int] = None,
                 connect_timeout: float = 10.0,
                 request_timeout: Optional[float] = 60.0):
        self.machine_id = machine_id if machine_id is not None \
            else H.hash_bytes_np(b"query-client")
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.stats = Stats()
        self._reader = None
        self._writer = None
        self._seq = 0

    async def connect(self, host: str, port: int,
                      timeout: Optional[float] = None) -> None:
        t = self.connect_timeout if timeout is None else timeout
        try:
            reader, writer, status, _ = await asyncio.wait_for(
                register(host, port, self.machine_id, wire.CONN_QUERY),
                t)
        except (asyncio.TimeoutError, TimeoutError):
            self.stats.bump("connect_timeouts")
            raise ConnectionError(
                f"query connect to {host}:{port} timed out "
                f"after {t:.1f}s") from None
        if status != wire.REG_OK:
            writer.close()
            raise ConnectionRefusedError(f"registration status {status}")
        self._reader, self._writer = reader, writer

    async def query(self, req: dict,
                    timeout: Optional[float] = None) -> dict:
        t = self.request_timeout if timeout is None else timeout
        if t is None:
            return await self._query(req)
        try:
            return await asyncio.wait_for(self._query(req), t)
        except (asyncio.TimeoutError, TimeoutError):
            self.stats.bump("query_timeouts")
            # the conn is desynced (the response may still arrive):
            # reset it so a retry cannot read a stale tail
            await self.close()
            raise TimeoutError(
                f"query timed out after {t:.1f}s "
                f"(subsys {req.get('subsys')!r})") from None

    async def _query(self, req: dict) -> dict:
        import json

        self._seq += 1
        seq = self._seq
        self._writer.write(wire.encode_query(seq, req))
        await self._writer.drain()
        chunks = []       # joined once at the end: O(N) for GB responses
        while True:       # streamed responses: QS_PARTIAL chunks → final
            dtype, payload = await _read_frame(self._reader)
            if dtype != wire.COMM_QUERY_RESP:
                raise wire.FrameError(f"expected QUERY_RESP, got {dtype}")
            seqid, status, chunk = wire.decode_query_chunk(payload)
            if seqid != seq:
                raise wire.FrameError(f"seqid mismatch {seqid} != {seq}")
            chunks.append(chunk)
            if status != wire.QS_PARTIAL:
                break
        obj = json.loads(b"".join(chunks) or b"null")
        if status != wire.QS_OK:
            raise RuntimeError(obj.get("error", f"query status {status}"))
        return obj

    async def close(self) -> None:
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
