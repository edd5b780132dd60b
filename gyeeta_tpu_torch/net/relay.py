"""Remote ingest relay: the shm-ring contract promoted to TCP.

``utils/shmring.py`` carries an exact cross-PROCESS ledger — every
record a worker publishes is either consumed by the fold or counted as
a drop, anchored by the per-shard cumulative record chain in each slot
header. This module carries the SAME contract across MACHINES (the
madhava→shyama hop of the source paper's two-level topology; the sPIN
near-wire shape of PAPERS.md): a :class:`RelayWorker` runs the full
ingest edge — accept, registration (forwarded to the supervisor so
hostmap allocation stays global), wire validation, native
deframe/decode, WAL append, shard split — on a REMOTE host and ships
decoded columnar batches to the supervisor as commit-then-head framed
messages over one TCP uplink:

- Every ``T_BATCH`` frame carries ``(shard, nrec, seq, cum)`` where
  ``cum`` is the relay's cumulative published-record count for that
  shard — the TCP analogue of the slot header's ``cum_records``
  anchor. The consumer's gap math is byte-for-byte the ring drain's:
  ``gap = (cum - nrec) - accounted`` counts EXACTLY the records lost
  to relay spool overflow, a connection death mid-frame, or a relay
  process restart. ``published == consumed + counted drops`` holds
  across the wire, across reconnects, and across relay respawns.
- The relay's bounded send spool is drop-OLDEST (the ring's overwrite
  policy): a WAN stall sheds the oldest batches counted, never blocks
  the socket edge, and never grows without bound. ``cum`` advances at
  publish time — before the spool — so shed batches surface as counted
  gaps at the consumer, not silence.
- Epochs mirror the worker monitor: each relay process run carries a
  fresh instance token in its HELLO. A new token finalizes the
  previous epoch — any records published-but-never-consumed are
  counted dropped right then (``hw - accounted`` per shard), exactly
  like the supervisor draining a dead worker's rings. A reconnect
  with the SAME token is a continuation: the retained spool resumes
  and nothing is double-counted (frames leave the spool only once
  fully written, so at-most-once delivery + exact counted loss).
- Heartbeats (0.2s) carry the relay's counter block and per-shard
  ``cum`` high-water marks, so the supervisor's ledger includes
  records that died in a lost spool and its monitor rows
  (``gyt_relay_up``, ``gyt_relay_heartbeat_age_seconds``,
  ``gyt_relay_epoch``, ``gyt_relay_pid``) mirror the local
  ``gyt_ingest_proc_*`` supervision surface.
- WAL ownership moves WITH the edge: ``--journal-dir`` makes the
  relay journal validated chunks on ITS host (the remote worker owns
  its shard WALs, same as the local mproc split). The supervisor
  never journals relay-fed records — re-journaling a decoded batch
  would double-count on replay.

The supervisor side (:class:`RelayHub`) is ~200 lines riding the
existing machinery: batches unpack through ``shmring.unpack_sections``
into ``Runtime.ingest_records`` (the staging path the local ring drain
uses), registration RPCs land on the server's sticky
machine-id→host_id allocator, and all accounting renders as the
``gyt_relay_*`` metric families.

Counterpart of ``gyeeta_tpu/net/relay.py``, with the same frame types,
T_BATCH header ``(shard, nrec, seq, cum)`` and JSON bodies, so either
package's relay uplinks into either package's hub. The relay touches no
device; the hub hands its batches to the runtime on its device. Knobs
are reads of an explicit ``env`` mapping (``None`` means no
environment): the relay's ``GYT_RELAY_BATCH_KB``, ``GYT_RELAY_SPOOL_MB``,
``GYT_RELAY_HB_S``, ``GYT_RELAY_REG_TIMEOUT_S`` and
``GYT_INGEST_STAGE_MS`` from its config's ``env`` entry, the hub's
``GYT_RELAY_HB_STALE_S`` from its ``env`` argument.
"""

from __future__ import annotations

import json
import logging
import os
import selectors
import socket
import struct
import time
from collections import deque
from typing import Optional

from gyeeta_tpu_torch.net.ingestproc import IngestWorker, _Conn, _ShmStats

log = logging.getLogger("gyeeta_tpu_torch.net.relay")

# ---------------------------------------------------------------- frames
# [magic u32 | type u16 | flags u16 | body_len u32] + body
RELAY_MAGIC = 0x47595452                  # "RTYG" on the wire
_FH = struct.Struct("<IHHI")
# batch body prefix: shard, nrec, seq, cum (then packed record sections)
_BH = struct.Struct("<IIQQ")
MAX_BODY = 16 * 1024 * 1024               # same cap as the wire tier

T_HELLO = 1        # relay → hub   JSON {relay_id, token, pid, nshards?}
T_HELLO_OK = 2     # hub → relay   JSON {ok, nshards, tick} | {error}
T_HB = 3           # relay → hub   JSON {hb, counters, cum}
T_BATCH = 4        # relay → hub   _BH + pack_sections payload
T_RPC = 5          # relay → hub   JSON {rid, op, ...}
T_RPC_RESP = 6     # hub → relay   JSON {rid, ...}
T_TICK = 7         # hub → relay   JSON {tick}

# relay-side counters beyond the shmring set, reported via heartbeat
# and folded into gyt_relay_proc_* rows by the hub (delta-folded, so
# respawn resets stay correct)
_EXTRA_COUNTERS = ("spool_dropped_batches", "spool_dropped_records",
                   "reg_refused", "uplink_reconnects")
_FOLD_COUNTERS = ("accepted_records", "accepted_chunks",
                  "accepted_bytes", "published_records", "frames_bad",
                  "unknown_records", "wal_appended_chunks",
                  "wal_backlog_dropped", "spool_dropped_batches",
                  "spool_dropped_records", "reg_refused",
                  "uplink_reconnects")


def frame(ftype: int, body: bytes) -> bytes:
    if len(body) >= MAX_BODY:
        raise ValueError(f"relay frame body {len(body)}B over cap")
    return _FH.pack(RELAY_MAGIC, ftype, 0, len(body)) + body


def jframe(ftype: int, obj: dict) -> bytes:
    return frame(ftype, json.dumps(obj).encode())


def batch_spool_max(env=None) -> int:
    env = {} if env is None else env
    return max(1 << 20, int(env.get("GYT_RELAY_SPOOL_MB", "8")) << 20)


def batch_payload_bytes(env=None) -> int:
    env = {} if env is None else env
    return max(4096, int(env.get("GYT_RELAY_BATCH_KB", "128")) * 1024)


def hb_interval_s(env=None) -> float:
    env = {} if env is None else env
    return max(0.05, float(env.get("GYT_RELAY_HB_S", "0.2")))


def hb_stale_s(env=None) -> float:
    env = {} if env is None else env
    return max(0.5, float(env.get("GYT_RELAY_HB_STALE_S", "5.0")))


# ======================================================================
# Relay-side publisher: the WorkerShm duck type
# ======================================================================

class RelayPublisher:
    """Duck-types the ``WorkerShm`` producer surface the IngestWorker
    machinery publishes through, backed by a bounded drop-oldest frame
    spool instead of shared-memory rings. ``cum`` advances at publish
    time — BEFORE spool admission — so a shed batch is a counted gap
    at the consumer, exactly like a ring overwrite."""

    def __init__(self, slot_payload: int, spool_max: int):
        from gyeeta_tpu_torch.utils import shmring
        self.slot_payload = int(slot_payload)
        self.spool_max = int(spool_max)
        self.spool: deque = deque()        # whole T_BATCH frames
        self.spool_bytes = 0
        self._cum: dict[int, int] = {}
        self._seq: dict[int, int] = {}
        self._counters = {n: 0 for n in shmring.COUNTER_NAMES}
        for n in _EXTRA_COUNTERS:
            self._counters[n] = 0
        self._counters["pid"] = os.getpid()

    # --- counter surface (same names/semantics as the ring header) ---
    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def set_counter(self, name: str, value: int) -> None:
        self._counters[name] = int(value)

    def add_counter(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(n)

    def counters(self) -> dict:
        d = dict(self._counters)
        d["spool_bytes"] = self.spool_bytes
        return d

    def heartbeat(self) -> None:
        self.add_counter("hb_seq")
        self.set_counter("hb_time_us", int(time.time() * 1e6))

    def bump_epoch(self) -> int:
        return 0                           # epochs ride the HELLO token

    def heads(self) -> list:
        n = (max(self._cum) + 1) if self._cum else 0
        return [self._cum.get(s, 0) for s in range(n)]

    def cum(self) -> dict:
        return dict(self._cum)

    def close(self) -> None:
        pass

    # ----------------------------------------------------------- publish
    def publish(self, shard: int, payload: bytes, nrec: int) -> None:
        if len(payload) > self.slot_payload:
            raise ValueError(
                f"payload {len(payload)}B > batch {self.slot_payload}B")
        shard = int(shard)
        seq = self._seq.get(shard, 0) + 1
        cum = self._cum.get(shard, 0) + int(nrec)
        self._seq[shard] = seq
        self._cum[shard] = cum
        self.add_counter("published_records", nrec)
        self.add_counter("published_slots")
        f = frame(T_BATCH, _BH.pack(shard, int(nrec), seq, cum)
                  + payload)
        self.spool.append(f)
        self.spool_bytes += len(f)
        while self.spool_bytes > self.spool_max and len(self.spool) > 1:
            old = self.spool.popleft()
            self.spool_bytes -= len(old)
            _s, onrec, _q, _c = _BH.unpack_from(old, _FH.size)
            self.add_counter("spool_dropped_batches")
            self.add_counter("spool_dropped_records", onrec)


# ======================================================================
# Relay worker process (remote host)
# ======================================================================

class _PendingConn:
    """An accepted agent conn before its registration round trip."""

    __slots__ = ("sock", "fd", "buf", "leftover", "t0", "rid")

    def __init__(self, sock):
        self.sock = sock
        self.fd = sock.fileno()
        self.buf = b""
        self.leftover = b""
        self.t0 = time.time()
        self.rid = 0


_L_LISTEN = "listen"
_L_UPLINK = "uplink"


class RelayWorker(IngestWorker):
    """The ingest edge on a remote host. Reuses the IngestWorker's
    validated byte path (``_on_bytes`` → ``_ingest_chunk`` → staged
    ``_flush_shard``) verbatim, with :class:`RelayPublisher` standing
    in for the shared-memory rings and a supervised TCP uplink in
    place of the ctrl socket. Single-threaded selector loop; the only
    other threads are WAL writer threads (``--journal-dir``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        env = cfg.get("env") or {}
        self.relay_id = str(cfg.get("relay_id") or
                            f"relay-{socket.gethostname()}")
        # fresh instance token per process run = the epoch boundary
        import uuid
        self.token = uuid.uuid4().hex[:16]
        self.w = 0
        self.nshards = int(cfg.get("nshards") or 1)
        self._nshards_known = bool(cfg.get("nshards"))
        self.shards = list(range(self.nshards))
        self.idle_timeout = float(cfg.get("idle_timeout") or 0)
        self.shm = RelayPublisher(batch_payload_bytes(env),
                                  batch_spool_max(env))
        self._stage = {}
        self._stage_bytes = {}
        self._stage_t0 = {}
        self._stage_max_age = float(
            env.get("GYT_INGEST_STAGE_MS", "15")) / 1e3
        self.sel = selectors.DefaultSelector()
        self.conns: dict[int, _Conn] = {}
        self.tick = 0
        self.running = True
        self._stop_reason: Optional[str] = None
        self.journals: dict = {}
        self._jdir = cfg.get("journal_dir")
        self._jkw = cfg.get("journal_kw") or {}
        self._wal_fmt = cfg.get("wal_subdir_fmt", "shard_{:02d}")
        # agent listener
        self._listener = socket.create_server(
            (cfg.get("listen_host", "127.0.0.1"),
             int(cfg.get("listen_port", 0))), backlog=128)
        self._listener.setblocking(False)
        self.listen_addr = self._listener.getsockname()[:2]
        self.sel.register(self._listener, selectors.EVENT_READ,
                          _L_LISTEN)
        # supervisor uplink
        self.sup_host, self.sup_port = cfg["supervisor"]
        self._up_sock: Optional[socket.socket] = None
        self._up_state = "down"            # down | connecting | up
        self._up_ready = False             # HELLO_OK received
        self._up_rx = b""
        self._up_partial: Optional[bytes] = None
        self._up_off = 0
        self._up_events = 0
        self._up_next_t = 0.0
        self._up_backoff = 0.0
        self._ctrlq: deque = deque()       # HELLO/RPC/HB — never shed
        self._pending_regs: dict[int, _PendingConn] = {}
        self._pending_by_fd: dict[int, _PendingConn] = {}
        self._reg_rid = 0
        self._conn_seq = 0
        self._hb_s = hb_interval_s(env)
        self._reg_timeout = float(
            env.get("GYT_RELAY_REG_TIMEOUT_S", "10"))

    # -------------------------------------------------- supervisor-free
    def _notify(self, ev: str, **kw) -> None:
        # conn lifecycle events stay local: the hub supervises via
        # heartbeats, not per-conn ctrl messages
        pass

    def _make_journals(self) -> None:
        if not self._jdir or self.journals:
            return
        from gyeeta_tpu_torch.utils.journal import Journal
        for s in range(self.nshards):
            sub = self._jdir if self.nshards == 1 \
                else os.path.join(self._jdir, self._wal_fmt.format(s))
            self.journals[s] = Journal(sub, stats=_ShmStats(self.shm),
                                       **self._jkw)

    # ------------------------------------------------------------ uplink
    def _up_drop(self, why: str) -> None:
        if self._up_sock is not None:
            try:
                self.sel.unregister(self._up_sock)
            except (KeyError, ValueError):
                pass
            try:
                self._up_sock.close()
            except OSError:
                pass
        if self._up_state != "down":
            self.shm.add_counter("uplink_reconnects")
        self._up_sock = None
        self._up_state = "down"
        self._up_ready = False
        self._up_rx = b""
        # a half-written frame died with the conn: the consumer counts
        # it as a cum gap — exactly a ring overwrite's fate
        self._up_partial = None
        self._up_off = 0
        self._up_backoff = min(2.0, max(0.2, self._up_backoff * 2))
        self._up_next_t = time.monotonic() + self._up_backoff
        # registrations in flight can never complete: refuse them so
        # the agents retry against the respawned uplink
        for p in list(self._pending_regs.values()):
            self._drop_pending(p, "uplink_down")
        log.info("relay %s: uplink down (%s)", self.relay_id, why)

    def _up_connect(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            s.connect((self.sup_host, self.sup_port))
        except BlockingIOError:
            pass
        except OSError:
            s.close()
            self._up_backoff = min(2.0, max(0.2, self._up_backoff * 2))
            self._up_next_t = time.monotonic() + self._up_backoff
            return
        self._up_sock = s
        self._up_state = "connecting"
        self._up_events = selectors.EVENT_READ | selectors.EVENT_WRITE
        self.sel.register(s, self._up_events, _L_UPLINK)

    def _up_established(self) -> None:
        err = self._up_sock.getsockopt(socket.SOL_SOCKET,
                                       socket.SO_ERROR)
        if err:
            self._up_drop(f"connect_error_{err}")
            return
        self._up_state = "up"
        self._up_backoff = 0.0
        hello = {"relay_id": self.relay_id, "token": self.token,
                 "pid": os.getpid(), "wire": 1}
        if self._nshards_known:
            hello["nshards"] = self.nshards
        self._ctrlq.appendleft(jframe(T_HELLO, hello))

    def _up_want_write(self) -> bool:
        return bool(self._ctrlq or self.shm.spool
                    or self._up_partial is not None)

    def _up_update_events(self) -> None:
        if self._up_sock is None or self._up_state == "connecting":
            return
        ev = selectors.EVENT_READ
        if self._up_want_write():
            ev |= selectors.EVENT_WRITE
        if ev != self._up_events:
            self._up_events = ev
            try:
                self.sel.modify(self._up_sock, ev, _L_UPLINK)
            except (KeyError, ValueError):   # pragma: no cover
                pass

    def _up_flush(self) -> None:
        if self._up_state != "up" or self._up_sock is None:
            return
        while True:
            if self._up_partial is None:
                if self._ctrlq:
                    self._up_partial = self._ctrlq.popleft()
                elif self.shm.spool:
                    f = self.shm.spool.popleft()
                    self.shm.spool_bytes -= len(f)
                    self._up_partial = f
                else:
                    break
                self._up_off = 0
            try:
                n = self._up_sock.send(self._up_partial[self._up_off:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._up_drop("send_error")
                return
            if n <= 0:                     # pragma: no cover
                break
            self._up_off += n
            if self._up_off >= len(self._up_partial):
                self._up_partial = None
                self._up_off = 0

    def _up_readable(self) -> None:
        try:
            data = self._up_sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._up_drop("recv_error")
            return
        if not data:
            self._up_drop("eof")
            return
        self._up_rx += data
        while len(self._up_rx) >= _FH.size:
            magic, ftype, _fl, blen = _FH.unpack_from(self._up_rx, 0)
            if magic != RELAY_MAGIC or blen >= MAX_BODY:
                self._up_drop("bad_frame")
                return
            if len(self._up_rx) < _FH.size + blen:
                break
            body = self._up_rx[_FH.size:_FH.size + blen]
            self._up_rx = self._up_rx[_FH.size + blen:]
            try:
                self._up_dispatch(ftype, body)
            except Exception:              # pragma: no cover
                log.exception("relay uplink dispatch failed")

    def _up_dispatch(self, ftype: int, body: bytes) -> None:
        if ftype == T_HELLO_OK:
            msg = json.loads(body)
            if not msg.get("ok"):
                log.error("relay %s rejected by supervisor: %s",
                          self.relay_id, msg.get("error"))
                self.running = False
                self._stop_reason = "hello_rejected"
                return
            n = int(msg.get("nshards", 1))
            if self._nshards_known and n != self.nshards:
                log.error("relay %s: nshards drift %d -> %d; exiting",
                          self.relay_id, self.nshards, n)
                self.running = False
                self._stop_reason = "nshards_drift"
                return
            self.nshards = n
            self._nshards_known = True
            self.shards = list(range(n))
            self.tick = int(msg.get("tick", self.tick))
            self._make_journals()
            self._up_ready = True
        elif ftype == T_RPC_RESP:
            msg = json.loads(body)
            self._on_reg_resp(msg)
        elif ftype == T_TICK:
            self.tick = int(json.loads(body).get("tick", self.tick))

    # ------------------------------------------------------ registration
    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:                # pragma: no cover
                return
            if not self._up_ready:
                # no uplink, no hostmap: refuse now, the agent's
                # supervised reconnect retries after the uplink heals
                self.shm.add_counter("reg_refused")
                sock.close()
                continue
            sock.setblocking(False)
            p = _PendingConn(sock)
            self._pending_by_fd[p.fd] = p
            self.sel.register(sock, selectors.EVENT_READ, p)

    def _drop_pending(self, p: _PendingConn, _why: str) -> None:
        try:
            self.sel.unregister(p.sock)
        except (KeyError, ValueError):
            pass
        try:
            p.sock.close()
        except OSError:
            pass
        self._pending_by_fd.pop(p.fd, None)
        if p.rid:
            self._pending_regs.pop(p.rid, None)
        self.shm.add_counter("reg_refused")

    def _on_reg_readable(self, p: _PendingConn) -> None:
        try:
            data = p.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop_pending(p, "error")
            return
        if not data:
            self._drop_pending(p, "eof")
            return
        p.buf += data
        self._try_register(p)

    def _try_register(self, p: _PendingConn) -> None:
        from gyeeta_tpu_torch.ingest import wire
        import numpy as np
        hsz = wire.HEADER_DT.itemsize
        if len(p.buf) < hsz:
            return
        magic, total = struct.unpack_from("<II", p.buf, 0)
        if magic != wire.MAGIC_PM or total < hsz \
                or total >= wire.MAX_COMM_DATA_SZ:
            self.shm.add_counter("frames_bad")
            self._drop_pending(p, "bad_magic")
            return
        if len(p.buf) < total:
            return
        dtype = int.from_bytes(p.buf[8:12], "little")
        if dtype != wire.COMM_REGISTER_REQ \
                or total < hsz + wire.REGISTER_REQ_DT.itemsize:
            self.shm.add_counter("frames_bad")
            self._drop_pending(p, "no_register")
            return
        if p.rid:                          # already in flight
            return
        req = np.frombuffer(p.buf, wire.REGISTER_REQ_DT, count=1,
                            offset=hsz)[0]
        p.leftover = bytes(p.buf[total:])
        p.buf = b""
        self._reg_rid += 1
        p.rid = self._reg_rid
        self._pending_regs[p.rid] = p
        mid = (int(req["machine_id_hi"]) << 64) \
            | int(req["machine_id_lo"])
        self._ctrlq.append(jframe(T_RPC, {
            "rid": p.rid, "op": "register", "mid": mid,
            "conn_type": int(req["conn_type"]),
            "wire_version": int(req["wire_version"]),
            "hostname_id": int(req["hostname_id"])}))

    def _on_reg_resp(self, msg: dict) -> None:
        from gyeeta_tpu_torch import version
        from gyeeta_tpu_torch.ingest import wire
        p = self._pending_regs.pop(int(msg.get("rid", 0)), None)
        if p is None:
            return
        self._pending_by_fd.pop(p.fd, None)
        status = int(msg.get("status", wire.REG_ERR_CAPACITY))
        hid = int(msg.get("hid", 0))
        resp = wire.encode_register_resp(
            status, hid, version.CURR_WIRE_VERSION,
            int(msg.get("last_seq", 0)))
        try:
            p.sock.sendall(resp)
        except OSError:
            self._drop_pending(p, "resp_error")
            return
        event = (status == wire.REG_OK and hid != 0xFFFFFFFF
                 and int(msg.get("conn_type", wire.CONN_EVENT))
                 == wire.CONN_EVENT)
        if not event:
            # the relay is an EVENT-only edge: query conns belong on
            # the serving tier / gateway, not the ingest relay
            self._drop_pending(p, "refused")
            return
        self._conn_seq += 1
        c = _Conn(p.sock, hid, self._conn_seq, hid % self.nshards)
        self.conns[c.fd] = c
        try:
            self.sel.modify(p.sock, selectors.EVENT_READ, c)
        except (KeyError, ValueError):     # pragma: no cover
            self._drop_pending(p, "sel_error")
            return
        self.shm.add_counter("conns_open")
        if p.leftover:
            try:
                self._on_bytes(c, p.leftover)
            except wire.FrameError:
                self.shm.add_counter("frames_bad")
                self._close_conn(c, "frame_error")

    def _reap_pending(self, now: float) -> None:
        for p in list(self._pending_by_fd.values()):
            if now - p.t0 > self._reg_timeout:
                self._drop_pending(p, "reg_timeout")

    # ------------------------------------------------------------- loop
    def run(self) -> None:
        import signal
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:                 # non-main thread (tests)
            pass
        last_hb = 0.0
        last_reap = time.time()
        while self.running:
            now_m = time.monotonic()
            if self._up_sock is None and now_m >= self._up_next_t:
                self._up_connect()
            timeout = 0.2 if not self._stage else self._stage_max_age
            events = self.sel.select(timeout=timeout)
            for key, ev in events:
                data = key.data
                if data is _L_LISTEN:
                    self._accept()
                elif data is _L_UPLINK:
                    if self._up_state == "connecting" \
                            and ev & selectors.EVENT_WRITE:
                        self._up_established()
                    if self._up_sock is not None \
                            and ev & selectors.EVENT_READ:
                        self._up_readable()
                elif isinstance(data, _PendingConn):
                    self._on_reg_readable(data)
                else:
                    self._on_readable(data)
            self._flush_stage(only_aged=True)
            now = time.time()
            if now - last_hb >= self._hb_s:
                self.shm.heartbeat()
                if self._up_ready:
                    self._ctrlq.append(jframe(T_HB, {
                        "hb": self.shm.counter("hb_seq"),
                        "counters": self.shm.counters(),
                        "cum": {str(s): c
                                for s, c in self.shm.cum().items()}}))
                last_hb = now
            self._up_flush()
            self._up_update_events()
            if now - last_reap >= 1.0:
                last_reap = now
                self._reap_pending(now)
                if self.idle_timeout:
                    for c in list(self.conns.values()):
                        if now - c.last_rx > self.idle_timeout:
                            self._close_conn(c, "idle")
        self._finish()

    def _finish(self) -> None:
        """Graceful exit: close conns, flush the stage, give the spool
        a bounded final flush (records the kernel already holds still
        deliver; anything left is the next epoch's counted drop),
        close WALs."""
        for c in list(self.conns.values()):
            self._close_conn(c, "relay_stop")
        for p in list(self._pending_by_fd.values()):
            self._drop_pending(p, "relay_stop")
        self._flush_stage()
        if self._up_ready:
            self._ctrlq.append(jframe(T_HB, {
                "hb": self.shm.counter("hb_seq") + 1,
                "counters": self.shm.counters(),
                "cum": {str(s): c
                        for s, c in self.shm.cum().items()}}))
        deadline = time.monotonic() + 2.0
        while (self._up_state == "up" and self._up_want_write()
               and time.monotonic() < deadline):
            self._up_flush()
            if self._up_want_write():
                time.sleep(0.005)
        for j in self.journals.values():
            j.close()
        if self._up_sock is not None:
            try:
                self._up_sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:                    # pragma: no cover
            pass


# ======================================================================
# Supervisor-side hub (serve process)
# ======================================================================

class _RelayState:
    """Hub-side ledger + liveness state for one relay identity."""

    __slots__ = ("relay_id", "token", "writer", "accounted", "hw",
                 "last_hb", "last_counters", "epochs", "pid",
                 "connects")

    def __init__(self, relay_id: str):
        self.relay_id = relay_id
        self.token: Optional[str] = None
        self.writer = None
        self.accounted: dict[int, int] = {}   # consumed + dropped (cum)
        self.hw: dict[int, int] = {}          # published high water
        self.last_hb = time.monotonic()
        self.last_counters: dict = {}
        self.epochs = 0
        self.pid = 0
        self.connects = 0


class RelayHub:
    """Accept relay uplinks, consume framed batches into the runtime's
    staging slabs with the ring drain's exact gap accounting, answer
    registration RPCs against the server's sticky hostmap, and publish
    the ``gyt_relay_*`` supervision rows."""

    def __init__(self, rt, register_cb, host: str = "0.0.0.0",
                 port: int = 0, env=None):
        self.env = {} if env is None else env
        self.rt = rt
        self.stats = rt.stats
        self.register_cb = register_cb
        self.host, self.port = host, int(port)
        self._sharded = int(getattr(rt, "n", 1)) > 1
        self.nshards = max(1, int(getattr(rt, "n", 1)))
        self._relays: dict[str, _RelayState] = {}
        self._server = None
        self._mon_task = None
        self._tick = 0

    # ---------------------------------------------------------- lifecycle
    async def start(self):
        import asyncio
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        self._mon_task = asyncio.create_task(self._monitor())
        log.info("relay hub on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._mon_task is not None:
            self._mon_task.cancel()
            self._mon_task = None
        if self._server is not None:
            self._server.close()
            for st in self._relays.values():
                if st.writer is not None:
                    try:
                        st.writer.close()
                    except Exception:      # pragma: no cover
                        pass
                    st.writer = None
            await self._server.wait_closed()
            self._server = None

    def broadcast_tick(self, tick: int) -> None:
        self._tick = int(tick)
        f = jframe(T_TICK, {"tick": self._tick})
        for st in self._relays.values():
            if st.writer is not None:
                try:
                    st.writer.write(f)
                except Exception:          # pragma: no cover
                    pass

    def relays_up(self) -> int:
        return sum(1 for st in self._relays.values()
                   if st.writer is not None)

    # ------------------------------------------------------------ ledger
    def _finalize_epoch(self, st: _RelayState) -> None:
        """Close a dead epoch's books: records the relay published
        that never arrived (lost spool, death mid-frame) are counted
        dropped NOW — the TCP analogue of draining a dead worker's
        rings. published == consumed + dropped holds exactly at every
        epoch boundary."""
        for shard, hw in st.hw.items():
            gap = hw - st.accounted.get(shard, 0)
            if gap > 0:
                self.stats.bump(
                    f"relay_dropped_records|relay={st.relay_id},"
                    f"shard={shard}", gap)
                st.accounted[shard] = hw

    # ------------------------------------------------------------- conn
    async def _handle(self, reader, writer) -> None:
        st: Optional[_RelayState] = None
        try:
            st = await self._conn_loop(reader, writer)
        except Exception:                  # pragma: no cover
            log.exception("relay hub conn failed")
        finally:
            if st is not None and st.writer is writer:
                st.writer = None
                self.stats.gauge(
                    f"relay_up|relay={st.relay_id}", 0.0)
            try:
                writer.close()
            except Exception:              # pragma: no cover
                pass

    async def _read_frame(self, reader):
        hdr = await reader.readexactly(_FH.size)
        magic, ftype, _fl, blen = _FH.unpack(hdr)
        if magic != RELAY_MAGIC or blen >= MAX_BODY:
            raise ValueError(f"bad relay frame {magic:#x}/{blen}")
        body = await reader.readexactly(blen) if blen else b""
        return ftype, body

    async def _conn_loop(self, reader, writer):
        import asyncio
        try:
            ftype, body = await asyncio.wait_for(
                self._read_frame(reader), 15.0)
        except (asyncio.IncompleteReadError, ValueError,
                asyncio.TimeoutError, ConnectionError, OSError):
            return None
        if ftype != T_HELLO:
            self.stats.bump("relay_frames_bad")
            return None
        hello = json.loads(body)
        relay_id = str(hello.get("relay_id") or "")
        token = str(hello.get("token") or "")
        if not relay_id or not token:
            writer.write(jframe(T_HELLO_OK,
                                {"ok": False, "error": "bad hello"}))
            await writer.drain()
            return None
        want_n = hello.get("nshards")
        if want_n is not None and int(want_n) != self.nshards:
            writer.write(jframe(T_HELLO_OK, {
                "ok": False,
                "error": f"nshards {want_n} != {self.nshards}"}))
            await writer.drain()
            return None
        st = self._relays.get(relay_id)
        if st is None:
            st = _RelayState(relay_id)
            self._relays[relay_id] = st
            self.rt.notifylog.add(
                f"ingest relay registered: {relay_id}",
                source="selfmon")
        if st.writer is not None:
            try:
                st.writer.close()          # new uplink wins
            except Exception:              # pragma: no cover
                pass
        if st.token is not None and st.token != token:
            # a NEW process instance: the old epoch's in-flight spool
            # is gone — close its books exactly, then start fresh
            self._finalize_epoch(st)
            st.accounted = {}
            st.hw = {}
            st.last_counters = {}
            st.epochs += 1
            self.stats.bump(f"relay_epochs|relay={relay_id}")
            self.rt.notifylog.add(
                f"ingest relay {relay_id} restarted (epoch "
                f"{st.epochs})", ntype="warn", source="selfmon")
        elif st.token == token:
            self.stats.bump(f"relay_reconnects|relay={relay_id}")
        else:
            st.epochs += 1
        st.token = token
        st.writer = writer
        st.pid = int(hello.get("pid", 0))
        st.last_hb = time.monotonic()
        st.connects += 1
        writer.write(jframe(T_HELLO_OK, {"ok": True,
                                         "nshards": self.nshards,
                                         "tick": self._tick}))
        await writer.drain()
        self.stats.gauge(f"relay_up|relay={relay_id}", 1.0)
        while True:
            try:
                ftype, body = await self._read_frame(reader)
            except (asyncio.IncompleteReadError, ConnectionError,
                    OSError):
                return st
            except ValueError:
                self.stats.bump("relay_frames_bad")
                return st
            if st.writer is not writer:
                return st                  # superseded by a new uplink
            if ftype == T_BATCH:
                self._on_batch(st, body)
            elif ftype == T_HB:
                self._on_hb(st, json.loads(body))
            elif ftype == T_RPC:
                await self._on_rpc(st, writer, json.loads(body))

    # ---------------------------------------------------------- consume
    def _publish_hw(self, st: _RelayState, shard: int,
                    cum: int) -> None:
        hw = st.hw.get(shard, 0)
        if cum > hw:
            self.stats.bump(
                f"relay_published_records|relay={st.relay_id}",
                cum - hw)
            st.hw[shard] = cum

    def _on_batch(self, st: _RelayState, body: bytes) -> None:
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.utils import shmring
        if len(body) < _BH.size:
            self.stats.bump("relay_frames_bad")
            return
        shard, nrec, _seq, cum = _BH.unpack_from(body, 0)
        shard = int(shard) % self.nshards
        rid = st.relay_id
        self._publish_hw(st, shard, int(cum))
        acc = st.accounted.get(shard, 0)
        gap = (int(cum) - int(nrec)) - acc
        if gap > 0:
            # the drain-side half of the cross-machine ledger: records
            # the relay published that never reached us (spool shed /
            # conn death) — counted, attributed, never silent
            self.stats.bump(
                f"relay_dropped_records|relay={rid},shard={shard}",
                gap)
        st.accounted[shard] = max(acc, int(cum))
        recs, nr = shmring.unpack_sections(body[_BH.size:],
                                           wire.DTYPE_OF_SUBTYPE)
        if nr < int(nrec):
            self.stats.bump(f"relay_unknown_records|relay={rid}",
                            int(nrec) - nr)
        if recs:
            if self._sharded:
                self.rt.ingest_records(recs, shard=shard)
            else:
                self.rt.ingest_records(recs)
        self.stats.bump(f"relay_consumed_records|relay={rid}",
                        int(nrec))
        self.stats.bump(f"relay_batches|relay={rid}")
        self.stats.bump(f"relay_bytes|relay={rid}",
                        len(body) + _FH.size)

    def _on_hb(self, st: _RelayState, msg: dict) -> None:
        st.last_hb = time.monotonic()
        for s, c in (msg.get("cum") or {}).items():
            self._publish_hw(st, int(s) % self.nshards, int(c))
        ctrs = msg.get("counters") or {}
        last = st.last_counters
        for name in _FOLD_COUNTERS:
            d = int(ctrs.get(name, 0)) - int(last.get(name, 0))
            if d > 0:
                self.stats.bump(
                    f"relay_proc_{name}|relay={st.relay_id}", d)
        st.last_counters = {k: int(v) for k, v in ctrs.items()
                            if isinstance(v, (int, float))}
        self.stats.gauge(f"relay_spool_bytes|relay={st.relay_id}",
                         float(ctrs.get("spool_bytes", 0)))
        self.stats.gauge(
            f"relay_conns|relay={st.relay_id}",
            float(max(0, int(ctrs.get("conns_open", 0))
                      - int(ctrs.get("conns_closed", 0)))))

    async def _on_rpc(self, st: _RelayState, writer,
                      msg: dict) -> None:
        rid = msg.get("rid")
        if msg.get("op") == "register":
            status, hid, last_seq = self.register_cb(
                int(msg.get("mid", 0)),
                int(msg.get("conn_type", 0)),
                int(msg.get("wire_version", 0)))
            self.stats.bump(
                f"relay_registrations|relay={st.relay_id}")
            writer.write(jframe(T_RPC_RESP, {
                "rid": rid, "status": int(status), "hid": int(hid),
                "last_seq": int(last_seq),
                "conn_type": int(msg.get("conn_type", 0))}))
        else:
            writer.write(jframe(T_RPC_RESP,
                                {"rid": rid, "error": "unknown op"}))
        try:
            await writer.drain()
        except (ConnectionError, OSError):  # pragma: no cover
            pass

    # ----------------------------------------------------------- monitor
    async def _monitor(self) -> None:
        import asyncio
        stale = hb_stale_s(self.env)
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            for st in self._relays.values():
                up = st.writer is not None
                age = now - st.last_hb
                self.stats.gauge(f"relay_up|relay={st.relay_id}",
                                 1.0 if up and age < stale else 0.0)
                self.stats.gauge(
                    f"relay_heartbeat_age_seconds|relay={st.relay_id}",
                    round(min(age, 1e9), 3))
                self.stats.gauge(f"relay_epoch|relay={st.relay_id}",
                                 float(st.epochs))
                if st.pid:
                    self.stats.gauge(f"relay_pid|relay={st.relay_id}",
                                     float(st.pid))


# ======================================================================
# CLI entry (the remote-host process)
# ======================================================================

def relay_main(argv=None, env=None) -> int:
    """``env``: the relay's knob mapping (the CLI hands over
    ``os.environ``; ``None`` = the defaults)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch relay",
        description="remote ingest relay: agents register and stream "
                    "here; decoded batches ship to the supervisor "
                    "over one exact-ledger TCP uplink")
    ap.add_argument("--supervisor", required=True,
                    help="HOST:PORT of the serve process --relay-port")
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=0)
    ap.add_argument("--relay-id", default=None)
    ap.add_argument("--journal-dir", default=None,
                    help="WAL root on THIS host (the relay owns its "
                         "shard WALs, like a local ingest worker)")
    ap.add_argument("--idle-timeout", type=float, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s relay %(message)s")
    host, _, port = args.supervisor.rpartition(":")
    cfg = {"supervisor": (host or "127.0.0.1", int(port)),
           "listen_host": args.listen_host,
           "listen_port": args.listen_port,
           "relay_id": args.relay_id,
           "journal_dir": args.journal_dir,
           "idle_timeout": args.idle_timeout,
           "env": {} if env is None else dict(env)}
    w = RelayWorker(cfg)
    # machine-parsable bind line: harnesses (and operators scripting
    # ephemeral ports) read the actual listen address from stdout
    print(f"RELAY_LISTEN {w.listen_addr[0]} {w.listen_addr[1]}",
          flush=True)
    w.run()
    return 0
