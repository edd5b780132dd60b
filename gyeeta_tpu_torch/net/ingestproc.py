"""Multi-process ingest workers: the million-agent control plane edge.

One Python process used to own every shard's socket edge — deframe,
decode, WAL append and fold all shared one GIL, which ROADMAP names
"the actual ceiling for 'millions of users', independent of device
speed". This module splits the ingest edge out of the fold process
(the sPIN near-wire-processing shape, PAPERS.md 1709.05483: every
process builds its own shard-local data, the runtime assembles the
global view):

- ``serve --ingest-procs N`` runs N **ingest worker processes**, each
  owning a sticky SHARD GROUP (shard ``s`` → worker ``s % N`` — the
  same ``ShardLayout`` hid-hash that places folds and ``shard_NN/``
  WAL subdirs partitions the socket edge). The supervisor (the fold
  process) keeps the ONE listening socket and the registration
  handshake (hostmap allocation is shared state); the instant an
  event conn registers, its socket fd is handed to the owning worker
  over a ``SCM_RIGHTS`` control channel. Workers then own the bulk
  read loop: wire validation, native deframe/decode, and the WAL
  append for their shards — near the wire, off the fold GIL.
- Workers publish **decoded columnar record batches** — never raw
  bytes — into per-shard shared-memory rings (``utils/shmring.py``).
  The fold process drains rings straight into its per-shard staging
  slabs (``ShardedRuntime.ingest_records(recs, shard=s)`` →
  ``sharded.stack_prerouted``), so the fused fold dispatch path is
  unchanged.
- Crash containment: a SIGKILL'd worker loses only its open conns.
  The supervisor detects death (process exit or a stale heartbeat
  word in the ring header), respawns the worker onto the SAME shard
  group, rings and WAL subdirs (sticky assignment), and the agents
  reconnect through the supervisor's still-open listener — no port
  churn. The accounting ledger extends across the process boundary:
  worker-side accepted counters live in the ring header, ring
  overwrites are counted in records by the consumer, and
  ``accepted + dropped + spooled == records_built`` stays exact
  through a crash/respawn window (tests/test_torch_ingestproc.py).

``--ingest-procs 1`` (the default) spawns nothing: the in-process
path is byte-for-byte today's behavior.

Control protocol (AF_UNIX SOCK_SEQPACKET, one JSON header + optional
binary tail per packet, fds via SCM_RIGHTS):

    supervisor → worker:  conn (fd + initial bytes), wal (journal a
                          chunk for a supervisor-handled ref conn),
                          tick, quiesce, seal, stop
    worker → supervisor:  conn_closed, quiesced, sealed, stopped

``quiesce`` is the checkpoint barrier: workers fsync their journals
and reply (positions, ring heads); the supervisor drains every ring
to the replied head before recording positions — everything at or
below a checkpointed WAL position is provably folded.

Counterpart of ``gyeeta_tpu/net/ingestproc.py``, with its control
protocol, ring layout and WAL layout unchanged. The workers touch no
device: their import chain (this module, ``ingest/wire``,
``ingest/native``, ``utils/journal``, ``utils/shmring``) imports neither
``torch`` nor anything that initialises CUDA, so N workers claim no
device context; the supervisor's drain hands their batches to the
runtime on its device, where each staged slab launches the fused
kernels. Knobs are reads of the ``env`` mapping the supervisor is given
(``None`` means no environment): ``GYT_INGEST_DRAIN_MS`` (the serving
loop's idle drain cadence), ``GYT_INGEST_HB_STALE_S`` (heartbeat age of a
wedged worker), ``GYT_INGEST_STAGE_MS`` (a worker's publish staging
age) and the ring geometry ``GYT_SHM_RING_SLOTS`` /
``GYT_SHM_RING_SLOT_KB``; a worker reads its own from the ``env`` entry
of its JSON config, and the child process's environment is built from
the same mapping.
"""

from __future__ import annotations

import json
import logging
import os
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid
from typing import Optional

log = logging.getLogger("gyeeta_tpu_torch.net.ingestproc")

# the knobs a worker reads from its config's "env" entry
_WORKER_KNOBS = ("GYT_INGEST_STAGE_MS",)

_MSG_HDR = struct.Struct("<I")          # json length; binary tail follows
_CTRL_BUF = 4 << 20
_READ_SZ = 1 << 20


def _pack_msg(obj: dict, blob: bytes = b"") -> bytes:
    j = json.dumps(obj).encode()
    return _MSG_HDR.pack(len(j)) + j + blob


def _unpack_msg(data: bytes) -> tuple[dict, bytes]:
    (jlen,) = _MSG_HDR.unpack_from(data, 0)
    obj = json.loads(data[_MSG_HDR.size:_MSG_HDR.size + jlen])
    return obj, data[_MSG_HDR.size + jlen:]


def drain_interval_s(env=None) -> float:
    env = {} if env is None else env
    return max(0.001,
               float(env.get("GYT_INGEST_DRAIN_MS", "15")) / 1e3)


def hb_stale_s(env=None) -> float:
    """Heartbeat age past which a live-pid worker counts as wedged."""
    env = {} if env is None else env
    return max(0.5, float(env.get("GYT_INGEST_HB_STALE_S", "5.0")))


# ======================================================================
# Worker process
# ======================================================================

class _Conn:
    __slots__ = ("sock", "fd", "hid", "conn_id", "pending", "last_rx",
                 "shard")

    def __init__(self, sock, hid, conn_id, shard):
        self.sock = sock
        self.fd = sock.fileno()
        self.hid = hid
        self.conn_id = conn_id
        self.shard = shard
        self.pending = b""
        self.last_rx = time.time()


class IngestWorker:
    """One shard group's wire edge: accept-handoff conns, validate,
    deframe/decode, WAL-append, publish decoded slabs. Runs a
    selector loop on the main thread; the only other threads are the
    WAL writer threads inside each :class:`~..utils.journal.Journal`."""

    def __init__(self, cfg: dict, ctrl_fd: int):
        from gyeeta_tpu_torch.utils import shmring
        self.cfg = cfg
        env = cfg.get("env") or {}
        self.w = int(cfg["worker"])
        self.nshards = int(cfg["nshards"])
        self.shards = [int(s) for s in cfg["shards"]]
        self.idle_timeout = float(cfg.get("idle_timeout") or 0)
        self.shm = shmring.WorkerShm(cfg["shm"], env=env)
        # per-shard publish staging (the edge's analogue of the fold's
        # staging slabs): decoded records accumulate until a slot's
        # worth is ready or the stage ages out — per-slot fixed costs
        # then amortize over hundreds of records even when the wire
        # delivers dribbles (small recvs used to cost 3-4x per record)
        self._stage: dict = {}             # shard → {subtype: [arrays]}
        self._stage_bytes = {}             # shard → staged payload bytes
        self._stage_t0 = {}                # shard → first-stage time
        self._stage_max_age = float(
            env.get("GYT_INGEST_STAGE_MS", "15")) / 1e3
        self.shm.bump_epoch()
        self.shm.set_counter("done", 0)
        self.ctrl = socket.socket(fileno=ctrl_fd)
        self.ctrl.setblocking(False)
        self.sel = selectors.DefaultSelector()
        self.sel.register(self.ctrl, selectors.EVENT_READ, None)
        self.conns: dict[int, _Conn] = {}
        self.tick = 0
        self.running = True
        self._stop_reason: Optional[str] = None
        # per-owned-shard WAL (same shard_NN/ layout the in-process
        # ShardedJournal writes; a 1-shard flat runtime keeps the flat
        # dir so Runtime replay reads it unchanged)
        self.journals: dict = {}
        jdir = cfg.get("journal_dir")
        if jdir:
            from gyeeta_tpu_torch.utils.journal import Journal
            jkw = cfg.get("journal_kw") or {}
            fmt = cfg.get("wal_subdir_fmt", "shard_{:02d}")
            for s in self.shards:
                sub = jdir if self.nshards == 1 \
                    else os.path.join(jdir, fmt.format(s))
                self.journals[s] = Journal(sub, stats=_ShmStats(self.shm),
                                           **jkw)

    # ------------------------------------------------------------ ctrl
    def _ctrl_recv(self) -> bool:
        try:
            data, fds, _flags, _addr = socket.recv_fds(
                self.ctrl, _CTRL_BUF, 4)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            data, fds = b"", []
        if not data:
            # supervisor gone: a dying fold process takes the edge
            # down with it (agents reconnect to the respawned stack)
            self.running = False
            self._stop_reason = "ctrl_eof"
            return False
        msg, blob = _unpack_msg(data)
        cmd = msg.get("cmd")
        if cmd == "conn" and fds:
            from gyeeta_tpu_torch.ingest import wire
            sock = socket.socket(fileno=fds[0])
            sock.setblocking(False)
            hid = int(msg["hid"])
            shard = hid % self.nshards
            c = _Conn(sock, hid, int(msg["conn_id"]), shard)
            self.conns[c.fd] = c
            self.sel.register(sock, selectors.EVENT_READ, c)
            self.shm.add_counter("conns_open")
            if blob:
                try:
                    self._on_bytes(c, blob)
                except wire.FrameError:
                    # poison bytes buffered before the handoff: same
                    # containment as _on_readable — only this conn dies,
                    # never the whole shard group's worker
                    self.shm.add_counter("frames_bad")
                    self._close_conn(c, "frame_error")
        elif cmd == "wal":
            # a supervisor-handled conn's validated chunk (stock-partha
            # adapter path): journal it here — this worker owns the
            # shard's WAL files
            j = self.journals.get(int(msg["hid"]) % self.nshards)
            if j is not None:
                j.append(blob, hid=int(msg["hid"]),
                         conn_id=int(msg.get("conn_id", 0)),
                         tick=self.tick)
                self.shm.add_counter("wal_appended_chunks")
        elif cmd == "tick":
            self.tick = int(msg["tick"])
        elif cmd == "quiesce":
            # staged records MUST publish before the position ships:
            # the checkpoint contract is "everything at/below the
            # position is in a ring the supervisor will drain" — a
            # record parked in worker staging would otherwise fold
            # after the checkpoint yet sit below its WAL position
            self._flush_stage()
            for j in self.journals.values():
                j.fsync()
            self._reply(msg, "quiesced",
                        wal={str(s): list(j.position())
                             for s, j in self.journals.items()},
                        heads=self.shm.heads())
        elif cmd == "seal":
            self._reply(msg, "sealed",
                        bounds={str(s): j.seal_active()
                                for s, j in self.journals.items()})
        elif cmd == "stop":
            self.running = False
            self._stop_reason = "stop"
            self._stop_req = msg
        return True

    def _ctrl_send(self, data: bytes, timeout: float = 5.0) -> bool:
        """Send one ctrl packet, waiting (bounded) for the SEQPACKET
        buffer to drain on EAGAIN. SEQPACKET sends are atomic, so a
        BlockingIOError means NOTHING was sent and a straight retry is
        safe. Dropping instead would be far worse than a short stall:
        a lost conn_closed parks the supervisor's handoff task on its
        death event forever, and a lost quiesced/stopped reply stalls
        the checkpoint barrier for its full timeout."""
        import select
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.ctrl.sendall(data)
                return True
            except BlockingIOError:
                remain = deadline - time.monotonic()
                if remain <= 0:             # pragma: no cover
                    return False
                select.select([], [self.ctrl], [], min(remain, 0.1))
            except OSError:                 # pragma: no cover
                return False

    def _reply(self, req: dict, ev: str, **kw) -> None:
        self._ctrl_send(_pack_msg({"ev": ev, "req": req.get("req"),
                                   **kw}))

    def _notify(self, ev: str, **kw) -> None:
        self._ctrl_send(_pack_msg({"ev": ev, **kw}))

    # ------------------------------------------------------------ conns
    def _close_conn(self, c: _Conn, reason: str) -> None:
        try:
            self.sel.unregister(c.sock)
        except (KeyError, ValueError):      # pragma: no cover
            pass
        try:
            c.sock.close()
        except OSError:                     # pragma: no cover
            pass
        self.conns.pop(c.fd, None)
        self.shm.add_counter("conns_closed")
        self._notify("conn_closed", hid=c.hid, conn_id=c.conn_id,
                     reason=reason)

    def _on_readable(self, c: _Conn) -> None:
        from gyeeta_tpu_torch.ingest import wire
        # drain-to-EAGAIN with a byte budget: coalesce whatever the
        # wire already delivered into ONE deframe pass (per-chunk
        # costs amortize; the budget keeps one hot conn from starving
        # the others in the selector round)
        parts = []
        got = 0
        eof = False
        while got < 4 * _READ_SZ:
            try:
                data = c.sock.recv(_READ_SZ)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(c, "error")
                return
            if not data:
                eof = True
                break
            parts.append(data)
            got += len(data)
        if got:
            c.last_rx = time.time()
            try:
                self._on_bytes(c, b"".join(parts))
            except wire.FrameError:
                # poison header/frame: counted, conn closed — the agent
                # reconnects and resyncs (the in-process edge does the
                # same)
                self.shm.add_counter("frames_bad")
                self._close_conn(c, "frame_error")
                return
        if eof:
            if c.pending:
                self.shm.add_counter("frames_bad")
            self._close_conn(c, "eof")

    def _on_bytes(self, c: _Conn, data: bytes) -> None:
        from gyeeta_tpu_torch.ingest import wire
        data = (c.pending + data) if c.pending else data
        k = wire.complete_prefix(data)      # may raise FrameError
        c.pending = data[k:]
        if k:
            self._ingest_chunk(c, data[:k])

    # ----------------------------------------------------------- ingest
    def _ingest_chunk(self, c: _Conn, chunk: bytes) -> None:
        """One validated complete-frame run: WAL append (post-
        validation, pre-publish — the same ordering the in-process
        feed path uses), native deframe to record arrays, shard split,
        ring publish."""
        from gyeeta_tpu_torch.ingest import native, wire
        from gyeeta_tpu_torch.utils import shmring
        j = self.journals.get(c.shard)
        if j is not None:
            j.append(chunk, hid=c.hid, conn_id=c.conn_id,
                     tick=self.tick)
            self.shm.add_counter("wal_appended_chunks")
        recs, _consumed, unknown = native.drain2(chunk)
        if unknown:
            self.shm.add_counter("unknown_records", unknown)
        nrec = sum(len(a) for a in recs.values())
        self.shm.add_counter("accepted_chunks")
        self.shm.add_counter("accepted_bytes", len(chunk))
        if not nrec:
            return
        self.shm.add_counter("accepted_records", nrec)
        now = time.time()
        for shard, srecs in self._split_shards(recs, c.shard).items():
            st = self._stage.setdefault(shard, {})
            for subtype, arr in srecs.items():
                st.setdefault(subtype, []).append(arr)
                self._stage_bytes[shard] = \
                    self._stage_bytes.get(shard, 0) + arr.nbytes
            self._stage_t0.setdefault(shard, now)
            if self._stage_bytes[shard] >= self.shm.slot_payload:
                self._flush_shard(shard)

    def _flush_shard(self, shard: int) -> None:
        """Publish one shard's staged records (merged per subtype) —
        a slot's worth amortizes the per-slot fixed cost ~100x vs
        publishing every dribble chunk on its own."""
        import numpy as np

        from gyeeta_tpu_torch.utils import shmring
        st = self._stage.pop(shard, None)
        self._stage_bytes.pop(shard, None)
        self._stage_t0.pop(shard, None)
        if not st:
            return
        merged = {sub: (arrs[0] if len(arrs) == 1
                        else np.concatenate(arrs))
                  for sub, arrs in st.items()}
        for payload, n in shmring.split_records(
                merged, self.shm.slot_payload):
            self.shm.publish(shard, payload, n)

    def _flush_stage(self, only_aged: bool = False) -> None:
        now = time.time()
        for shard in list(self._stage):
            if not only_aged or now - self._stage_t0.get(shard, now) \
                    >= self._stage_max_age:
                self._flush_shard(shard)

    def _split_shards(self, recs: dict, home: int) -> dict:
        """Route each record array per shard by its host hash (the
        layout rule, ``mesh.shard_of_host`` = hid % nshards); records
        without a host column ride the conn's home shard. Relay conns
        carry many hosts per chunk, so this is per-RECORD routing —
        the same split the fold's ``_stage_raw`` used to do."""
        import numpy as np
        if self.nshards == 1:
            return {0: recs}
        out: dict = {}
        for subtype, arr in recs.items():
            names = arr.dtype.names or ()
            if "host_id" not in names:
                out.setdefault(home, {})[subtype] = arr
                continue
            dest = arr["host_id"].astype(np.int64) % self.nshards
            order = np.argsort(dest, kind="stable")
            arr = arr[order]
            bounds = np.searchsorted(dest[order],
                                     np.arange(self.nshards + 1))
            for s in range(self.nshards):
                a, b = int(bounds[s]), int(bounds[s + 1])
                if b > a:
                    out.setdefault(s, {})[subtype] = arr[a:b]
        return out

    # ------------------------------------------------------------- loop
    def run(self) -> None:
        import signal
        signal.signal(signal.SIGTERM, self._on_sigterm)
        last_hb = 0.0
        last_reap = time.time()
        while self.running:
            events = self.sel.select(timeout=0.2 if not self._stage
                                     else self._stage_max_age)
            for key, _ev in events:
                if key.data is None:
                    if not self._ctrl_recv():
                        break
                else:
                    self._on_readable(key.data)
            # age-based flush only: an idle SELECT round is not a
            # quiet wire — a worker that outruns its producers sees
            # empty rounds constantly, and flushing dribbles there
            # would undo the whole point of staging (the select
            # timeout above shrinks to the staging budget while
            # records are parked, so age is honored promptly)
            self._flush_stage(only_aged=True)
            now = time.time()
            if now - last_hb >= 0.2:
                self.shm.heartbeat()
                last_hb = now
            if self.idle_timeout and now - last_reap >= 1.0:
                last_reap = now
                for c in list(self.conns.values()):
                    if now - c.last_rx > self.idle_timeout:
                        self._close_conn(c, "idle")
        self._finish()

    def _on_sigterm(self, _sig, _frm) -> None:
        self.running = False
        self._stop_reason = self._stop_reason or "sigterm"

    def _finish(self) -> None:
        """Graceful exit: close conns, drain + fsync the WAL, publish
        final positions, mark done in the ring header. Everything
        already published stays in the rings for the supervisor's
        final drain — a clean SIGTERM leaves an EMPTY replay window."""
        for c in list(self.conns.values()):
            self._close_conn(c, "worker_stop")
        self._flush_stage()
        positions = {}
        for s, j in self.journals.items():
            j.close()                      # drain + fsync + close
            positions[str(s)] = list(j.position())
        self.shm.heartbeat()
        self.shm.set_counter("done", 1)
        req = getattr(self, "_stop_req", None)
        if req is not None:
            self._reply(req, "stopped", wal=positions,
                        heads=self.shm.heads())
        self.shm.close()


class _ShmStats:
    """Stats shim mapping the worker Journal's counters onto ring-
    header words (the supervisor renders them as gyt_ingest_proc_*)."""

    _MAP = {"wal_backlog_dropped": "wal_backlog_dropped"}

    def __init__(self, shm):
        self.shm = shm

    def bump(self, name, n=1):
        tgt = self._MAP.get(name)
        if tgt:
            self.shm.add_counter(tgt, n)

    def gauge(self, name, v):
        pass

    def timeit(self, name):
        import contextlib
        return contextlib.nullcontext()


def worker_main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch.net.ingestproc")
    ap.add_argument("--ctrl-fd", type=int, required=True)
    ap.add_argument("--cfg", required=True)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.WARNING,
        format="%(asctime)s %(levelname)s ingestproc %(message)s")
    cfg = json.loads(args.cfg)
    IngestWorker(cfg, args.ctrl_fd).run()
    return 0


# ======================================================================
# Supervisor (fold-process side)
# ======================================================================

class _WorkerHandle:
    """Supervisor-side state for one worker slot: subprocess, ctrl
    socket + reader thread, shm segment, pending sync requests, and
    the conns currently assigned to it."""

    def __init__(self, w: int, shards: list):
        self.w = w
        self.shards = shards
        self.proc: Optional[subprocess.Popen] = None
        self.ctrl: Optional[socket.socket] = None
        self.shm = None
        self.reader: Optional[threading.Thread] = None
        self.up = False
        self.pending: dict = {}            # req id → [Event, reply]
        self.conns: dict = {}              # conn_id → death Event
        self.last_counters: dict = {}
        self.spawned = 0


class IngestSupervisor:
    """Spawn/respawn ingest workers, hand off registered event conns,
    drain the shared-memory rings into the runtime, and carry the
    WAL/checkpoint barrier across the process boundary."""

    def __init__(self, rt, nprocs: int, journal_dir: Optional[str],
                 idle_timeout: Optional[float] = None, env=None):
        """``env``: the knob mapping (module docstring); ``None`` means
        no environment."""
        from gyeeta_tpu_torch.utils import shmring
        self.env = {} if env is None else dict(env)
        self.rt = rt
        self.stats = rt.stats
        self.n = int(getattr(rt, "n", 1))
        self.nprocs = int(nprocs)
        if self.nprocs > max(1, self.n):
            raise ValueError(
                f"--ingest-procs {self.nprocs} > shards {self.n}: one "
                "worker owns at least one whole shard group")
        self.journal_dir = journal_dir
        self.idle_timeout = idle_timeout
        self._layout = getattr(rt, "layout", None)
        self._sharded = self.n > 1
        self._lock = threading.Lock()       # ctrl sends + spawn state
        self._req_seq = 0
        self._stopping = False
        self._loop = None                   # asyncio loop (set at start)
        self._final_wal: Optional[dict] = None
        self._run_id = uuid.uuid4().hex[:8]
        groups = [[s for s in range(max(1, self.n))
                   if s % self.nprocs == w]
                  for w in range(self.nprocs)]
        self.workers = [_WorkerHandle(w, groups[w])
                        for w in range(self.nprocs)]
        slots = shmring.ring_slots(self.env)
        slot_kb = shmring.ring_slot_bytes(self.env)
        for h in self.workers:
            h.shm = shmring.WorkerShm(
                f"gyt_ing_{os.getpid()}_{self._run_id}_{h.w}",
                nshards=max(1, self.n), slots=slots,
                slot_bytes=slot_kb, create=True)

    # ---------------------------------------------------------- workers
    def worker_of_shard(self, shard: int) -> int:
        return int(shard) % self.nprocs

    def worker_of_hid(self, hid: int) -> int:
        s = (int(self._layout.shard_of_host(int(hid)))
             if self._layout is not None else int(hid) % max(1, self.n))
        return self.worker_of_shard(s)

    def start(self, loop=None) -> None:
        self._loop = loop
        # the workers deframe natively: build the library here once, so
        # no two workers race a g++ run into build/native
        from gyeeta_tpu_torch.ingest import native
        native.lib()
        for h in self.workers:
            self._spawn(h)

    def _spawn(self, h: _WorkerHandle) -> None:
        # zero the heartbeat words BEFORE the child exists: they
        # persist in the shared segment across respawns, and poll()'s
        # wedged check must not judge the new worker by the dead
        # epoch's last stamp (slow interpreter/numpy startup past
        # GYT_INGEST_HB_STALE_S would otherwise respawn-loop forever).
        # hb_seq == 0 disarms the check until the new loop's first beat.
        h.shm.set_counter("hb_seq", 0)
        h.shm.set_counter("hb_time_us", 0)
        sup_sock, child_sock = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_SEQPACKET)
        for s in (sup_sock, child_sock):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                             _CTRL_BUF)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                             _CTRL_BUF)
            except OSError:                 # pragma: no cover
                pass
        jkw = None
        if self.journal_dir:
            o = self.rt.opts
            jkw = dict(segment_max_bytes=o.journal_segment_mb << 20,
                       fsync_bytes=o.journal_fsync_kb << 10,
                       fsync_ms=o.journal_fsync_ms,
                       backlog_max_bytes=o.journal_backlog_mb << 20)
        cfg = {"worker": h.w, "nshards": max(1, self.n),
               "shards": h.shards, "shm": h.shm.name,
               "journal_dir": self.journal_dir, "journal_kw": jkw,
               "idle_timeout": self.idle_timeout,
               "wal_subdir_fmt": getattr(self._layout,
                                         "WAL_SUBDIR_FMT",
                                         "shard_{:02d}"),
               # the worker attaches to a ring the supervisor owns
               "env": {**{k: self.env[k] for k in _WORKER_KNOBS
                          if k in self.env},
                       "GYT_SHMRING_NOTRACK": "1"}}
        child_fd = child_sock.fileno()
        env = dict(self.env, GYT_SHMRING_NOTRACK="1")
        # the worker must import gyeeta_tpu_torch regardless of the
        # supervisor's cwd (serve may run from anywhere)
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_parent + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        h.proc = subprocess.Popen(
            [sys.executable, "-m", "gyeeta_tpu_torch.net.ingestproc",
             "--ctrl-fd", str(child_fd), "--cfg", json.dumps(cfg)],
            pass_fds=[child_fd], env=env, close_fds=True)
        child_sock.close()
        h.ctrl = sup_sock
        h.up = True
        h.spawned += 1
        h.reader = threading.Thread(
            target=self._reader_loop, args=(h,),
            name=f"gyt-ingest-ctrl-{h.w}", daemon=True)
        h.reader.start()
        log.info("ingest worker %d: pid %d, shards %s", h.w,
                 h.proc.pid, h.shards)

    # ----------------------------------------------------- ctrl plumbing
    def _reader_loop(self, h: _WorkerHandle) -> None:
        ctrl = h.ctrl
        while True:
            try:
                data = ctrl.recv(_CTRL_BUF)
            except OSError:
                data = b""
            if not data:
                break
            try:
                msg, _blob = _unpack_msg(data)
            except Exception:               # pragma: no cover
                continue
            ev = msg.get("ev")
            rid = msg.get("req")
            if rid is not None and rid in h.pending:
                slot = h.pending.pop(rid)
                slot[1] = msg
                slot[0].set()
            elif ev == "conn_closed":
                self._on_conn_closed(h, msg)
        # EOF: the worker died (or closed on graceful stop) — release
        # its conns so the serving edge closes them and agents reconnect
        self._release_conns(h)

    def _on_conn_closed(self, h: _WorkerHandle, msg: dict) -> None:
        ev = h.conns.pop(int(msg.get("conn_id", 0)), None)
        reason = msg.get("reason", "")
        if reason == "idle":
            self.stats.bump("conn_timeouts|kind=idle")
        if ev is not None:
            self._set_event(ev)

    def _release_conns(self, h: _WorkerHandle) -> None:
        conns, h.conns = h.conns, {}
        for ev in conns.values():
            self._set_event(ev)

    def _set_event(self, ev) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(ev.set)
        else:                               # pragma: no cover
            ev.set()

    def _send(self, h: _WorkerHandle, msg: dict, blob: bytes = b"",
              fds: tuple = ()) -> bool:
        if not h.up or h.ctrl is None:
            return False
        data = _pack_msg(msg, blob)
        try:
            with self._lock:
                if fds:
                    socket.send_fds(h.ctrl, [data], list(fds))
                else:
                    h.ctrl.sendall(data)
            return True
        except OSError:
            return False

    def _request(self, h: _WorkerHandle, msg: dict,
                 timeout: float = 30.0) -> Optional[dict]:
        """Synchronous ctrl round trip (safe from any thread: the
        reply is fulfilled by the reader thread)."""
        with self._lock:
            self._req_seq += 1
            rid = self._req_seq
        ev = threading.Event()
        slot = [ev, None]
        h.pending[rid] = slot
        if not self._send(h, {**msg, "req": rid}):
            h.pending.pop(rid, None)
            return None
        if not ev.wait(timeout):
            h.pending.pop(rid, None)
            return None
        return slot[1]

    # ------------------------------------------------------------ handoff
    def handoff(self, hid: int, conn_id: int, sock_fd: int,
                initial: bytes, death_event) -> bool:
        """Hand one registered event conn to its shard group's worker.
        Returns False when the worker is down (the caller closes the
        conn; the agent reconnects after the respawn)."""
        h = self.workers[self.worker_of_hid(hid)]
        if not h.up:
            return False
        h.conns[int(conn_id)] = death_event
        ok = self._send(h, {"cmd": "conn", "hid": int(hid),
                            "conn_id": int(conn_id)},
                        blob=initial, fds=(sock_fd,))
        if not ok:
            h.conns.pop(int(conn_id), None)
        return ok

    def forward_wal(self, hid: int, conn_id: int, chunk: bytes) -> bool:
        """Journal a supervisor-handled conn's validated chunk in the
        owning worker (stock-partha adapter streams keep durability
        in mproc mode; the records themselves fold in-process)."""
        h = self.workers[self.worker_of_hid(hid)]
        return self._send(h, {"cmd": "wal", "hid": int(hid),
                              "conn_id": int(conn_id)}, blob=chunk)

    def broadcast_tick(self, tick: int) -> None:
        for h in self.workers:
            self._send(h, {"cmd": "tick", "tick": int(tick)})

    def ring_backlog_frac(self) -> float:
        """Worst committed-but-unconsumed occupancy across every
        (worker, shard) ring, as a fraction of ring capacity — the
        admission controller's overload signal (``net/server.py``
        throttles agents BEFORE the drop-oldest rings shed). Reads two
        shared-memory words per ring; 0.0 when nothing is spawned."""
        worst = 0.0
        for h in self.workers:
            if h.shm is None or not h.shm.slots:
                continue
            for s in range(max(1, self.n)):
                # fraction per ring, against ITS OWN capacity — mixing
                # a global worst count with one worker's slot count
                # skews the signal under per-worker sizing
                f = h.shm.backlog(s) / h.shm.slots
                if f > worst:
                    worst = f
        return worst

    # -------------------------------------------------------------- drain
    def drain(self, max_slots_per_ring: int = 0) -> int:
        """Drain every ring into the runtime's staging slabs. Called
        from the serving loop (drain task + feed barrier). Returns
        records ingested; ring overwrites land on counted per-shard
        drop counters — the no-silent-loss ledger."""
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.utils import shmring
        total = 0
        for h in self.workers:
            for s in range(max(1, self.n)):
                bufs, nrec, ds, dr = h.shm.drain(s, max_slots_per_ring)
                if ds:
                    self.stats.bump(
                        f"ingest_ring_dropped_slots|shard={s}", ds)
                    self.stats.bump(
                        f"ingest_ring_dropped_records|shard={s}", dr)
                if not bufs:
                    continue
                consumed = 0
                for payload in bufs:
                    recs, nr = shmring.unpack_sections(
                        payload, wire.DTYPE_OF_SUBTYPE)
                    consumed += nr
                    if not recs:
                        continue
                    if self._sharded:
                        total += self.rt.ingest_records(recs, shard=s)
                    else:
                        total += self.rt.ingest_records(recs)
                # the fold-side half of the cross-process ledger:
                # published == consumed + dropped, exactly
                self.stats.bump("ingest_ring_consumed_records",
                                consumed)
                self.stats.gauge(
                    f"ingest_ring_backlog_slots|proc={h.w}",
                    float(h.shm.backlog()))
        return total

    def _drain_to_heads(self, heads_by_worker: dict,
                        timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.drain()
            lag = 0
            for h in self.workers:
                heads = heads_by_worker.get(h.w)
                if heads is None:
                    continue
                tails = h.shm.tails()
                lag += sum(max(0, int(hd) - int(t))
                           for hd, t in zip(heads, tails))
            if lag == 0:
                return
            time.sleep(0.002)

    # -------------------------------------------------- checkpoint barrier
    def quiesce(self, timeout: float = 30.0) -> dict:
        """The cross-process checkpoint barrier: every worker fsyncs
        its journals and replies (positions, ring heads); the rings
        are drained to those heads before returning. The returned
        per-shard positions are safe to record in a checkpoint —
        every chunk at/below them has been folded (or counted as a
        ring drop)."""
        if self._stopping and self._final_wal is not None:
            return dict(self._final_wal)
        positions: dict = {}
        heads: dict = {}
        for h in self.workers:
            rep = self._request(h, {"cmd": "quiesce"}, timeout)
            if rep is None:
                continue                    # dead worker: files are as
            #                                 durable as its last fsync
            heads[h.w] = rep.get("heads") or []
            for s, pos in (rep.get("wal") or {}).items():
                positions[int(s)] = [int(pos[0]), int(pos[1])]
        self._drain_to_heads(heads)
        return positions

    def seal(self, timeout: float = 30.0) -> dict:
        """Proxy ``Journal.seal_active`` into the workers (the history
        compactor's handoff). Returns {shard: first-sealed bound}."""
        bounds: dict = {}
        for h in self.workers:
            rep = self._request(h, {"cmd": "seal"}, timeout)
            for s, b in ((rep or {}).get("bounds") or {}).items():
                bounds[int(s)] = int(b)
        return bounds

    # ----------------------------------------------------------- monitor
    def poll(self) -> int:
        """Liveness + metrics pass (call at ~1s cadence from the
        serving loop): respawn dead/wedged workers onto their sticky
        shard groups, fold worker-header counter deltas into the
        fold-process Stats registry (→ gyt_ingest_proc_* rows).
        Returns workers respawned."""
        from gyeeta_tpu_torch.utils.shmring import COUNTER_NAMES
        respawned = 0
        stale = hb_stale_s(self.env)
        for h in self.workers:
            ctrs = h.shm.counters()
            # counter deltas → labeled counters (monotone totals render
            # in /metrics; deltas keep respawn resets correct)
            last = h.last_counters
            for name in ("accepted_records", "accepted_chunks",
                         "accepted_bytes", "published_records",
                         "frames_bad", "unknown_records",
                         "wal_appended_chunks", "wal_backlog_dropped"):
                d = ctrs[name] - last.get(name, 0)
                if d > 0:
                    self.stats.bump(
                        f"ingest_proc_{name}|proc={h.w}", d)
            h.last_counters = {k: ctrs[k] for k in COUNTER_NAMES}
            age = h.shm.hb_age_s()
            self.stats.gauge(
                f"ingest_proc_heartbeat_age_seconds|proc={h.w}",
                round(min(age, 1e9), 3))
            self.stats.gauge(f"ingest_proc_up|proc={h.w}",
                             1.0 if h.up else 0.0)
            self.stats.gauge(f"ingest_proc_epoch|proc={h.w}",
                             float(h.shm.epoch()))
            # the worker's pid as a gauge: lets an operator (or the
            # fault-injection harness) target one worker from OUTSIDE
            # the serve process — kill a wedged one, strace a slow one
            if h.proc is not None:
                self.stats.gauge(f"ingest_proc_pid|proc={h.w}",
                                 float(h.proc.pid))
            self.stats.gauge(f"ingest_proc_conns|proc={h.w}",
                             float(max(0, ctrs["conns_open"]
                                       - ctrs["conns_closed"])))
            if self._stopping:
                continue
            dead = h.proc is not None and h.proc.poll() is not None
            wedged = (h.up and not dead and ctrs["hb_seq"] > 0
                      and age > stale)
            if dead or wedged:
                if wedged:                  # pragma: no cover — chaos
                    try:
                        h.proc.kill()
                    except OSError:
                        pass
                self._teardown(h)
                self.stats.bump(f"ingest_proc_respawns|proc={h.w}")
                self.rt.notifylog.add(
                    f"ingest worker {h.w} "
                    f"{'wedged' if wedged else 'died'} — respawning "
                    f"onto shards {h.shards}", ntype="warn",
                    source="selfmon")
                self._spawn(h)
                respawned += 1
        return respawned

    def _teardown(self, h: _WorkerHandle) -> None:
        h.up = False
        self._release_conns(h)
        if h.ctrl is not None:
            try:
                h.ctrl.close()
            except OSError:                 # pragma: no cover
                pass
            h.ctrl = None
        if h.proc is not None:
            try:
                h.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:   # pragma: no cover
                h.proc.kill()
                h.proc.wait(timeout=5.0)

    # --------------------------------------------------------- lifecycle
    def stop(self, timeout: float = 30.0) -> dict:
        """Graceful stop: workers close conns, drain + fsync their
        WALs and report final positions; the rings are drained to
        their final heads BEFORE this returns — the final checkpoint
        therefore supersedes the whole WAL window (respawn replays
        ZERO chunks). Returns the final per-shard WAL positions."""
        self._stopping = True
        positions: dict = {}
        heads: dict = {}
        for h in self.workers:
            rep = self._request(h, {"cmd": "stop"}, timeout)
            if rep is not None:
                heads[h.w] = rep.get("heads") or []
                for s, pos in (rep.get("wal") or {}).items():
                    positions[int(s)] = [int(pos[0]), int(pos[1])]
        self._drain_to_heads(heads)
        for h in self.workers:
            self._teardown(h)
        self._final_wal = dict(positions)
        return positions

    def close(self) -> None:
        for h in self.workers:
            if h.shm is not None:
                h.shm.close()
                h.shm.unlink()

    def wal_positions(self) -> Optional[dict]:
        return self._final_wal


# ======================================================================
# Fold-process WAL view
# ======================================================================

class ProcWalView:
    """Duck-types :class:`~gyeeta_tpu_torch.utils.journal.Journal` for the
    fold process while ingest WORKERS own the segment writers: the
    checkpoint path (``fsync``/``position``/``truncate_upto``), replay
    (``read_from`` — only used before workers spawn), the compactor
    handoff (``seal_active``/``sealed_upto``/``set_truncate_floor``)
    and the health gauges all keep working; ``append`` forwards the
    chunk to the owning worker's journal over the control channel."""

    def __init__(self, sup: IngestSupervisor, path, n_shards: int,
                 stats=None, subdir_fmt: str = "shard_{:02d}"):
        import pathlib
        from gyeeta_tpu_torch.utils.journal import _NullStats
        self.sup = sup
        self.dir = pathlib.Path(path)
        self.n = int(n_shards)
        self.subdir_fmt = subdir_fmt
        self.stats = stats if stats is not None else _NullStats()
        self._pos: dict = {}               # shard → [seg, off]
        self._floors: dict = {}
        self._sealed: dict = {}

    def _subdir(self, s: int):
        return self.dir if self.n == 1 \
            else self.dir / self.subdir_fmt.format(s)

    # ------------------------------------------------------------ append
    def append(self, buf: bytes, hid: int = 0, conn_id: int = 0,
               tick: int = 0) -> None:
        if not self.sup.forward_wal(hid, conn_id, buf):
            self.stats.bump("wal_forward_failed")

    def poll(self) -> None:
        pass

    # ----------------------------------------------------------- barrier
    def fsync(self) -> None:
        self._pos.update(self.sup.quiesce())

    def position(self) -> list:
        """Per-shard [seg, off] (the ShardedJournal shape) from the
        last quiesce; shards with no traffic yet report [0, MAGIC]."""
        from gyeeta_tpu_torch.utils.journal import MAGIC
        out = []
        for s in range(self.n):
            out.append(list(self._pos.get(s, [0, len(MAGIC)])))
        return out if self.n > 1 else tuple(out[0])

    def seal_active(self):
        b = self.sup.seal()
        self._sealed.update(b)
        if self.n == 1:
            return b.get(0, 0)
        return [b.get(s, 0) for s in range(self.n)]

    def sealed_upto(self):
        if self.n == 1:
            return self._sealed.get(0, 0)
        return [self._sealed.get(s, 0) for s in range(self.n)]

    def set_truncate_floor(self, seq, name: str = "compact") -> None:
        fl = self._floors.setdefault(name, {})
        if isinstance(seq, (list, tuple)):
            for s, v in enumerate(seq):
                fl[s] = max(fl.get(s, 0), int(v))
        else:
            for s in range(self.n):
                fl[s] = max(fl.get(s, 0), int(seq))

    # ---------------------------------------------------------- truncate
    def truncate_upto(self, bounds) -> int:
        """File-level truncation (safe cross-process: workers hold
        only their ACTIVE segment open, and the bound never reaches
        it — the bound IS a quiesced position's segment)."""
        from gyeeta_tpu_torch.utils.journal import _SEG_FMT, dir_segments
        n = 0
        per = {}
        if isinstance(bounds, (list, tuple)) \
                and bounds and isinstance(bounds[0], (list, tuple)):
            per = {s: int(b[0]) for s, b in enumerate(bounds)}
        else:
            b = int(bounds[0]) if isinstance(bounds, (list, tuple)) \
                else int(bounds)
            per = {s: b for s in range(self.n)}
        for s in range(self.n):
            bound = per.get(s, 0)
            floors = [fl[s] for fl in self._floors.values() if s in fl]
            if floors:
                bound = min(bound, min(floors))
            d = self._subdir(s)
            if not d.is_dir():
                continue
            segs = dir_segments(d)
            for seg in segs:
                if seg >= bound or seg == (segs[-1] if segs else 0):
                    continue
                try:
                    (d / _SEG_FMT.format(seg)).unlink()
                    n += 1
                except OSError:             # pragma: no cover
                    pass
        if n:
            self.stats.bump("wal_segments_deleted", n)
        return n

    # -------------------------------------------------------------- read
    def read_from(self, pos=None):
        """K-way tick-merged read over the shard subdirs (only used
        at restore time, before the workers spawn — the files are
        quiet then)."""
        import heapq
        from gyeeta_tpu_torch.utils.journal import read_sealed

        if self.n == 1:
            p = tuple(pos) if pos else None
            for _seg, _nxt, _t, hid, tick, cid, chunk in read_sealed(
                    self.dir, p, None, stats=self.stats):
                yield hid, tick, cid, chunk
            return
        pos_list = None
        if pos is not None:
            pos = list(pos)
            if pos and isinstance(pos[0], (list, tuple)):
                pos_list = pos
            else:
                self.stats.bump("wal_position_gap")

        def stream(s):
            p = tuple(pos_list[s]) if pos_list is not None \
                and s < len(pos_list) else None
            d = self._subdir(s)
            if not d.is_dir():
                return
            for _seg, _nxt, _t, hid, tick, cid, chunk in read_sealed(
                    d, p, None, stats=self.stats):
                yield (tick, s, hid, cid, chunk)

        for tick, _s, hid, cid, chunk in heapq.merge(
                *(stream(s) for s in range(self.n)),
                key=lambda e: e[0]):
            yield hid, tick, cid, chunk

    # ------------------------------------------------------------ gauges
    def gauges(self) -> dict:
        total = 0
        nseg = 0
        for s in range(self.n):
            d = self._subdir(s)
            if not d.is_dir():
                continue
            for p in d.glob("gyt_wal_*.gytwal"):
                try:
                    total += p.stat().st_size
                    nseg += 1
                except OSError:             # pragma: no cover
                    pass
        try:
            backlog = sum(h.shm.backlog() for h in self.sup.workers)
        except (ValueError, OSError):       # rings already unlinked
            backlog = 0
        return {"journal_segments": float(nseg),
                "journal_bytes": float(total),
                "journal_backlog_bytes": 0.0,
                "journal_pending_bytes": 0.0,
                "ingest_ring_backlog_slots": float(backlog)}

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        pass                                # workers own the writers

    def abort(self) -> None:
        pass


if __name__ == "__main__":
    sys.exit(worker_main())
