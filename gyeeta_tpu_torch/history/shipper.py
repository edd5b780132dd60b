"""Source-region segment shipper: sealed WAL segments → remote staging.

Counterpart of ``gyeeta_tpu/history/shipper.py``: the sending half of
the segment-ship protocol (``net/segship.py`` has the wire format, the
receiver, and the crash-consistency contract). A
:class:`SegmentShipper` runs beside the source journal — in the serve
process (``serve --ship-to HOST:PORT``) or standalone over a WAL
directory (``gyeeta_tpu_torch ship``) — and repeatedly:

1. scans the journal for SEALED segments (``sealed_upto`` bounds the
   scan when a live journal is attached; in offline dir mode every
   present segment is sealed — the dir must have no live writer),
2. ships each not-yet-terminal segment in ascending seq order per
   shard: one content-hashing read pass (blake2b + chunk count), a
   ``T_SMETA`` announce, then raw ``T_SDATA`` frames from the offset
   the receiver already holds (per-segment RESUME after any
   disconnect or SIGKILL on either side),
3. advances the journal's NAMED ship truncate floor
   (``set_truncate_floor(floor, name="ship")``) to the oldest
   non-terminal seq — checkpoint truncation can never delete a
   sealed-but-unshipped segment, so the ship tier's disk pin is
   exactly (sealed − landed) segments,
4. heartbeats its cumulative counters + the monotone
   ``sealed_segments`` high-water so the receiver's global ledger
   (``sealed == shipped + counted drops``) includes segments that
   never made it off the box.

Supervised like the relay worker: jittered reconnect backoff, one
instance token per process run (the receiver's epoch boundary). A
terminal receiver verdict (``done``/``shed``/``conflict``) marks the
key locally so steady state re-announces nothing; a shipper restart
re-announces everything still on disk and the receiver's ledger
answers ``done`` instantly.

Optional bounded pinned backlog (``GYT_SHIP_PIN_MB`` > 0): when the
floor-pinned unshipped bytes exceed the bound (a long receiver
outage), the OLDEST unshipped segment is announced as a permanent
``T_SDROP`` — a counted ledger drop, never silence — and the floor
advances. Default 0 = unbounded: disk pays for exactness.

Both WAL layouts ship byte for byte (a flat dir as shard 0, a
``shard_NN/`` root shard by shard), from a live journal — a flat
:class:`~gyeeta_tpu_torch.utils.journal.Journal`, the sharded runtime's
:class:`~gyeeta_tpu_torch.utils.journal.ShardedJournal`, or the
multi-process ingest edge's ``ProcWalView`` (``net/ingestproc.py``,
whose workers own the segment writers) — or from a dir in offline mode.
The knobs (``GYT_SHIP_SCAN_S``, ``GYT_SHIP_HB_S``, ``GYT_SHIP_CHUNK_KB``,
``GYT_SHIP_PIN_MB`` and the crash hook ``GYT_SHIP_DIE_AFTER_ACKS``) are read from ``cfg["env"]``;
without one, the reference's defaults.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pathlib
import random
import socket
import struct
import time
import uuid
from typing import Optional

from gyeeta_tpu_torch.net import segship as SP
from gyeeta_tpu_torch.utils import journal as J

log = logging.getLogger("gyeeta_tpu_torch.history.shipper")


def pin_max_bytes(env=None) -> int:
    env = {} if env is None else env
    mb = int(env.get("GYT_SHIP_PIN_MB", "0") or 0)
    return mb << 20


def seg_info(path) -> tuple[int, str, int]:
    """One read pass over a sealed segment: (size, blake2b hex,
    record count). Records are WAL chunks; a torn header ends the
    count cleanly (sealed segments should have none — the writer
    truncates torn tails on open — but a foreign copy might)."""
    data = pathlib.Path(path).read_bytes()
    h = hashlib.blake2b(data, digest_size=32).hexdigest()
    nrec = 0
    off = len(J.MAGIC)
    whdr = J._WHDR
    while off + whdr.size <= len(data):
        try:
            _t, nbytes, _hid, _tick, _cid = whdr.unpack_from(data, off)
        except struct.error:               # pragma: no cover
            break
        if off + whdr.size + nbytes > len(data):
            break
        nrec += 1
        off += whdr.size + nbytes
    return len(data), h, nrec


class SegmentShipper:
    """Threaded blocking-socket uplink shipping sealed segments to a
    :class:`~gyeeta_tpu_torch.net.segship.SegmentReceiver`. ``cfg`` keys:

    - ``target``: (host, port) of the receiver,
    - ``shipper_id``: stable source identity (the provenance key),
    - ``journal``: live Journal or ShardedJournal (ship floor +
      sealed bound), or None with
    - ``dir``: offline WAL root (every segment treated as sealed),
    - ``stats``: source-side Stats registry (``ship_*`` rows),
    - ``scan_s`` / ``hb_s`` / ``chunk_bytes`` / ``pin_bytes`` knobs,
    - ``once``: one full pass then stop (the CLI's batch mode),
    - ``env``: the ``GYT_SHIP_*`` mapping (None = the defaults).
    """

    def __init__(self, cfg: dict):
        self.cfg = dict(cfg)
        self.target = tuple(cfg["target"])
        self.shipper_id = str(cfg.get("shipper_id")
                              or f"ship-{socket.gethostname()}")
        self.journal = cfg.get("journal")
        d = cfg.get("dir")
        if self.journal is not None:
            self.dir = pathlib.Path(self.journal.dir)
        elif d is not None:
            self.dir = pathlib.Path(d)
        else:
            raise ValueError("SegmentShipper needs a journal or a dir")
        self.stats = cfg.get("stats") or J._NullStats()
        env = cfg.get("env")
        env = {} if env is None else env
        self.scan_s = float(cfg.get("scan_s",
                                    env.get("GYT_SHIP_SCAN_S", 0.5)))
        self.hb_s = float(cfg.get("hb_s", SP.hb_interval_s(env)))
        self.chunk = int(cfg.get("chunk_bytes", SP.chunk_bytes(env)))
        self.pin_max = int(cfg.get("pin_bytes", pin_max_bytes(env)))
        self.once = bool(cfg.get("once"))
        self.token = uuid.uuid4().hex[:16]
        self.running = True
        self._sock: Optional[socket.socket] = None
        self._rbuf = b""
        self._backoff = 0.1
        self._last_hb = 0.0
        self._done: set[tuple[int, int]] = set()   # terminal keys
        self._counted: set[tuple[int, int]] = set()  # sealed-counted
        self._floors: dict[int, int] = {}
        # crash injection for the chaos smoke: _exit(9) right after
        # the k-th segment reaches a terminal verdict — the SIGKILL-at
        # -every-ship-boundary probe
        self._die_after = int(env.get("GYT_SHIP_DIE_AFTER_ACKS", "0")
                              or 0)
        self._acks = 0
        # layout: a sharded WAL root owns shard_NN/ subdirs; a flat dir
        # ships as shard 0 into the staging root. Duck-typed across
        # Journal, ShardedJournal and the multi-process ProcWalView
        # (n + subdir_fmt, no .shards list).
        sharded = False
        if self.journal is not None:
            shards = getattr(self.journal, "shards", None)
            if shards is not None:         # ShardedJournal
                self.subdirs = [pathlib.Path(j.dir) for j in shards]
                sharded = True
            elif int(getattr(self.journal, "n", 1)) > 1:
                fmt = getattr(self.journal, "subdir_fmt",
                              "shard_{:02d}")   # ProcWalView
                self.subdirs = [self.dir / fmt.format(s)
                                for s in range(self.journal.n)]
                sharded = True
            else:
                self.subdirs = [self.dir]
        else:
            subs = J.sharded_subdirs(self.dir)
            sharded = bool(subs)
            self.subdirs = list(subs) or [self.dir]
        self.layout = "sharded" if sharded else "flat"

    # ------------------------------------------------------------ socket
    def _connect(self) -> bool:
        try:
            s = socket.create_connection(self.target, timeout=10.0)
            s.settimeout(30.0)
            self._sock, self._rbuf = s, b""
            self._send(SP.jframe(SP.T_SHELLO, {
                "shipper_id": self.shipper_id, "token": self.token,
                "pid": os.getpid(), "layout": self.layout,
                "nshards": len(self.subdirs),
                "host": socket.gethostname()}))
            ftype, msg = self._recv_json()
            if ftype != SP.T_SHELLO_OK or not msg.get("ok"):
                log.warning("ship hello refused: %s", msg)
                self.stats.bump("ship_hello_refused")
                self._drop_sock()
                return False
            self._backoff = 0.1
            self.stats.gauge("ship_uplink_up", 1.0)
            return True
        except (OSError, ValueError):
            self._drop_sock()
            return False

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:                # pragma: no cover
                pass
            self._sock = None
            self.stats.bump("ship_reconnects")
            self.stats.gauge("ship_uplink_up", 0.0)
        self._rbuf = b""

    def _send(self, buf: bytes) -> None:
        self._sock.sendall(buf)

    def _recv_frame(self) -> tuple[int, bytes]:
        need = SP._FH.size
        while len(self._rbuf) < need:
            b = self._sock.recv(65536)
            if not b:
                raise ConnectionError("ship uplink closed")
            self._rbuf += b
        magic, ftype, _fl, blen = SP._FH.unpack_from(self._rbuf, 0)
        if magic != SP.SHIP_MAGIC or blen >= SP.MAX_BODY:
            raise ValueError("bad ship frame")
        need = SP._FH.size + blen
        while len(self._rbuf) < need:
            b = self._sock.recv(65536)
            if not b:
                raise ConnectionError("ship uplink closed")
            self._rbuf += b
        body = self._rbuf[SP._FH.size:need]
        self._rbuf = self._rbuf[need:]
        return ftype, body

    def _recv_json(self) -> tuple[int, dict]:
        import json
        ftype, body = self._recv_frame()
        return ftype, (json.loads(body) if body else {})

    # -------------------------------------------------------------- scan
    def _sealed_bounds(self) -> list[Optional[int]]:
        """Per-shard EXCLUSIVE sealed bound; None = every present
        segment is sealed (offline dir mode)."""
        if self.journal is None:
            return [None] * len(self.subdirs)
        u = self.journal.sealed_upto()
        if isinstance(u, (list, tuple)):
            return [int(x) for x in u]
        return [int(u)]

    def _pending(self) -> list[tuple[int, int, pathlib.Path]]:
        """(shard, seq, path) of sealed, non-terminal segments,
        shard-major ascending-seq (the floor advances in order)."""
        out = []
        bounds = self._sealed_bounds()
        for s, sub in enumerate(self.subdirs):
            bound = bounds[s] if s < len(bounds) else None
            for seq in J.dir_segments(sub):
                if bound is not None and seq >= bound:
                    continue
                if (s, seq) in self._done:
                    continue
                out.append((s, seq, sub / J._SEG_FMT.format(seq)))
        return out

    def _advance_floor(self) -> None:
        """Ship floor per shard: the oldest non-terminal sealed seq
        (or the sealed bound when nothing is pending). Registered
        under the "ship" name so truncation bounds at
        min(checkpoint, compactor, ship)."""
        if self.journal is None:
            return
        bounds = self._sealed_bounds()
        floors = []
        for s, sub in enumerate(self.subdirs):
            bound = bounds[s] if s < len(bounds) else None
            segs = [q for q in J.dir_segments(sub)
                    if bound is None or q < bound]
            pend = [q for q in segs if (s, q) not in self._done]
            if pend:
                fl = min(pend)
            elif bound is not None:
                fl = bound
            else:
                fl = (max(segs) + 1) if segs else 0
            floors.append(int(fl))
            self._floors[s] = int(fl)
        if len(self.subdirs) > 1:
            self.journal.set_truncate_floor(floors, name="ship")
        else:
            self.journal.set_truncate_floor(floors[0], name="ship")
        self.stats.gauge("ship_floor_segments",
                         float(sum(floors)))

    def _count_sealed(self) -> None:
        """Source-side sealed ledger: segment count is the monotone
        per-shard sealed_upto sum (survives restarts + truncation);
        records/bytes bump once per newly observed key (cumulative,
        delta-folded by the receiver per epoch)."""
        bounds = self._sealed_bounds()
        if all(b is not None for b in bounds):
            total = sum(bounds)
        else:
            total = sum(len(J.dir_segments(sub))
                        for sub in self.subdirs)
        self.stats.gauge("ship_sealed_segments", float(total))
        self._sealed_total = total

    # -------------------------------------------------------------- ship
    def _ship_one(self, shard: int, seq: int,
                  path: pathlib.Path) -> bool:
        """Announce + stream one segment to a terminal verdict.
        Returns True when the key reached a terminal state."""
        import json
        try:
            size, digest, nrec = seg_info(path)
        except OSError:
            return False                   # raced truncation; rescan
        if (shard, seq) not in self._counted:
            self._counted.add((shard, seq))
            self.stats.bump("ship_sealed_records", nrec)
            self.stats.bump("ship_sealed_bytes", size)
        meta = {"shard": shard, "seq": seq, "size": size,
                "hash": digest, "nrec": nrec,
                "src": {"host": socket.gethostname(),
                        "pid": os.getpid()}}
        self._send(SP.jframe(SP.T_SMETA, meta))
        ftype, resp = self._recv_json()
        if ftype != SP.T_SRESP:
            raise ValueError("expected SRESP")
        status = resp.get("status")
        if status in ("done", "shed", "conflict"):
            if status != "done":
                self.stats.bump("ship_dropped_segments")
                self.stats.bump("ship_dropped_records", nrec)
                self.stats.bump("ship_dropped_bytes", size)
                if status == "conflict":
                    self.stats.bump("ship_hash_conflicts")
            else:
                self._bump_shipped(nrec, size)
            self._terminal(shard, seq)
            return True
        if status != "send":
            raise ValueError(f"bad SRESP status {status!r}")
        off = int(resp.get("off", 0))
        if off:
            self.stats.bump("ship_resumed_bytes", off)
        with open(path, "rb") as f:
            f.seek(off)
            while True:
                b = f.read(self.chunk)
                if not b:
                    break
                self._send(SP.frame(SP.T_SDATA, b))
        self._send(SP.jframe(SP.T_SEND, {}))
        ftype, ack = self._recv_json()
        if ftype != SP.T_SACK:
            raise ValueError("expected SACK")
        if not ack.get("ok"):
            # wire corruption — the receiver discarded the partial;
            # re-announce re-ships the immutable bytes from scratch
            self.stats.bump("ship_hash_retries")
            return False
        self._bump_shipped(nrec, size)
        self._terminal(shard, seq)
        return True

    def _bump_shipped(self, nrec: int, size: int) -> None:
        self.stats.bump("ship_shipped_segments")
        self.stats.bump("ship_shipped_records", nrec)
        self.stats.bump("ship_shipped_bytes", size)

    def _terminal(self, shard: int, seq: int) -> None:
        self._done.add((shard, seq))
        self._acks += 1
        if self._die_after and self._acks >= self._die_after:
            os._exit(9)                    # chaos: die AT the boundary

    def _shed_backlog(self) -> None:
        """Bounded pinned backlog: with GYT_SHIP_PIN_MB set, a
        receiver outage longer than the bound sheds the OLDEST
        unshipped segments as announced permanent drops (counted at
        both ends) instead of pinning disk forever."""
        if not self.pin_max:
            return
        pend = self._pending()
        total = 0
        sizes = {}
        for s, q, p in pend:
            try:
                sizes[(s, q)] = p.stat().st_size
                total += sizes[(s, q)]
            except OSError:
                sizes[(s, q)] = 0
        for s, q, p in pend:               # oldest-first per shard
            if total <= self.pin_max:
                break
            try:
                size, digest, nrec = seg_info(p)
            except OSError:
                continue
            try:
                self._send(SP.jframe(SP.T_SDROP, {
                    "shard": s, "seq": q, "size": size, "nrec": nrec,
                    "hash": digest, "reason": "source_shed"}))
                ftype, ack = self._recv_json()
                if ftype != SP.T_SACK or not ack.get("ok"):
                    continue
            except (OSError, ValueError, ConnectionError):
                raise
            self.stats.bump("ship_dropped_segments")
            self.stats.bump("ship_dropped_records", nrec)
            self.stats.bump("ship_dropped_bytes", size)
            self._terminal(s, q)
            total -= sizes.get((s, q), 0)

    def _heartbeat(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_hb < self.hb_s:
            return
        self._last_hb = now
        snap = getattr(self.stats, "snapshot", None)
        ctrs = {k: v for k, v in (snap() if snap else {}).items()
                if isinstance(v, (int, float))
                and str(k).startswith("ship_")}
        self._send(SP.jframe(SP.T_SHB, {
            "counters": ctrs,
            "sealed_segments": getattr(self, "_sealed_total", 0)}))

    # --------------------------------------------------------------- run
    def run(self) -> None:
        """Supervised loop: connect → ship pending → floor → idle
        scan. ``stop()`` (or ``once``) ends it."""
        while self.running:
            if self._sock is None:
                if not self._connect():
                    time.sleep(self._backoff
                               * (1.0 + random.random() * 0.25))
                    self._backoff = min(self._backoff * 2, 5.0)
                    continue
            try:
                pending = self._pending()
                self._count_sealed()
                progressed = False
                for s, q, p in pending:
                    if not self.running:
                        break
                    if self._ship_one(s, q, p):
                        progressed = True
                    self._advance_floor()
                    self._heartbeat()
                self._shed_backlog()
                self._advance_floor()
                self._heartbeat(force=progressed)
                if self.once and not self._pending():
                    self._heartbeat(force=True)
                    break
                t_end = time.monotonic() + self.scan_s
                while self.running and time.monotonic() < t_end:
                    self._heartbeat()
                    time.sleep(min(0.05, self.scan_s))
            except (ConnectionError, OSError, ValueError) as e:
                log.info("ship uplink lost (%s); reconnecting", e)
                self._drop_sock()
        self._drop_sock()

    def stop(self) -> None:
        self.running = False

    def ship_once(self) -> dict:
        """Blocking single pass (the CLI batch mode): ship every
        sealed segment to a terminal verdict, return the local
        counters."""
        self.once = True
        self.run()
        snap = getattr(self.stats, "snapshot", None)
        return {k: v for k, v in (snap() if snap else {}).items()
                if str(k).startswith("ship_")}


# ======================================================================
# CLI entry (the source-region process)
# ======================================================================

def ship_main(argv=None, env=None) -> int:
    """``env``: the ``GYT_SHIP_*`` mapping (the CLI hands over
    ``os.environ``; ``None`` = the defaults)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch ship",
        description="ship sealed WAL segments to a remote compaction "
                    "region's staging receiver (net/segship.py)")
    ap.add_argument("--dir", required=True,
                    help="WAL root (flat or shard_NN/) — must have no "
                         "live writer in dir mode")
    ap.add_argument("--to", required=True,
                    help="HOST:PORT of the segment receiver")
    ap.add_argument("--id", default=None, help="stable shipper id")
    ap.add_argument("--once", action="store_true",
                    help="one full pass, then exit (default: follow)")
    ap.add_argument("--scan-s", type=float, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s shipper %(message)s")
    from gyeeta_tpu_torch.utils.selfstats import Stats
    host, _, port = args.to.rpartition(":")
    cfg = {"target": (host or "127.0.0.1", int(port)),
           "shipper_id": args.id, "dir": args.dir, "stats": Stats(),
           "once": args.once, "env": env}
    if args.scan_s is not None:
        cfg["scan_s"] = args.scan_s
    sh = SegmentShipper(cfg)
    print(f"SHIP_RUN id={sh.shipper_id} layout={sh.layout} "
          f"shards={len(sh.subdirs)}", flush=True)
    if args.once:
        rep = sh.ship_once()
        print("SHIP_DONE "
              f"shipped={rep.get('ship_shipped_segments', 0)} "
              f"dropped={rep.get('ship_dropped_segments', 0)}",
              flush=True)
    else:
        import signal

        def _stop(_sig, _frm):
            sh.stop()
        try:
            signal.signal(signal.SIGTERM, _stop)
            signal.signal(signal.SIGINT, _stop)
        except ValueError:                 # non-main thread (tests)
            pass
        sh.run()
    return 0


if __name__ == "__main__":                 # pragma: no cover
    raise SystemExit(ship_main())
