"""Sealed-segment shipping: the compaction tier's WAN hop.

Counterpart of ``gyeeta_tpu/net/segship.py``: the wire format, the
receiver and the crash-consistency contract, byte for byte on the wire,
in the staging dir and in the ledger. SEALED ``gyt_wal_*.gytwal``
segments — immutable by construction — ship from a source region
(:class:`~gyeeta_tpu_torch.history.shipper.SegmentShipper`) to a
compaction region's STAGING directory, where the port's ``Compactor``
replays them on the region's device exactly as if local (same file
names, same seq numbering → the same shards).

The knob readers (:func:`hb_interval_s`, :func:`hb_stale_s`,
:func:`chunk_bytes`, :func:`stage_max_bytes`) and the receiver read the
``env`` mapping they are given (``GYT_SHIP_*``; the crash-injection
hooks ``GYT_SHIP_RECV_DIE_AFTER`` and ``GYT_SHIP_RECV_DIE_MODE`` too);
``None`` means no environment: the reference's defaults.

The supervision shape, adapted to a file-granular unit of work:

- **Epochs**: each shipper process run carries a fresh instance token
  in its HELLO. A new token is an epoch boundary (counted); a
  reconnect with the SAME token is a continuation — in-flight partial
  transfers resume at the byte offset the receiver already holds.
- **Content hashes**: every segment announces ``blake2b`` over its
  full bytes. The receiver verifies the hash over the COMPLETE landed
  file (including any resumed prefix) before publishing it — a
  mismatch discards the partial, counts ``ship_hash_mismatches``, and
  the shipper re-ships from scratch. No torn or corrupted segment can
  ever become visible to the compactor.
- **Atomic landing**: bytes stream into a hidden ``.ship_*.part``
  file (invisible to ``dir_segments``/the compactor); on verify the
  receiver fsyncs, renames to the final segment name, fsyncs the
  directory, then appends the landing to the content-hash LEDGER
  (``gyt_ship_ledger.jsonl``, fsynced) before acking. Every crash
  interleaving reconciles on the next announce: rename-but-no-ledger
  re-verifies the landed file's hash; ledger-but-no-ack answers the
  re-announce with ``done``. Partials are kept across disconnects and
  shipper SIGKILLs (segments are immutable, the end-to-end hash makes
  offset resume safe) but SWEPT, counted, on receiver restart (a torn
  receiver-side tail is not trustworthy).
- **Ledger**: the append-only JSONL ledger is the authoritative
  dedup + provenance record — one line per terminal key
  ``shard/seq`` with status ``landed``/``shed``/``dropped``, the
  content hash, and the source identity (shipper id, instance token,
  epoch, pid). A landed-then-swept segment (staging reclaim after
  compaction) still answers ``done`` by ledger, so re-announces after
  ANY crash never double-land or double-count. ``gyeeta_tpu_torch
  compact list`` renders it as per-segment provenance.
- **Global ledger invariant**: ``sealed == shipped + counted drops``.
  ``sealed`` (segments the source ever sealed) arrives on shipper
  heartbeats as the monotone per-shard ``sealed_upto`` sum (monotone
  across shipper restarts — seq numbering is persistent); ``shipped``
  and ``dropped`` are distinct ledger keys, re-derived from the
  ledger at receiver restart. Receiver staging-bound sheds and
  shipper-announced permanent drops (``T_SDROP``) are the ONLY drop
  paths, both counted — never silence.
- **Bounded staging**: a META whose size would push staging past
  ``GYT_SHIP_STAGE_MB`` is SHED (terminal, counted,
  ``ship_stage_sheds``); landed segments strictly below the
  compaction floor are swept by :meth:`SegmentReceiver.sweep_below`
  to reclaim staging space (``ship_staged_swept``).

The receiver lands the sharded layout (``shard_NN/``) as the reference
does, and the compaction region's staging loop replays it with the
compactor's tick-merged walk.
The source journal side of the contract lives in ``utils/journal.py``:
the shipper registers a NAMED truncate floor
(``set_truncate_floor(seq, name="ship")``) at the oldest unshipped
segment, and truncation bounds at the MIN over all named floors — a
sealed-but-unshipped segment can never be deleted by checkpoint
truncation.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib
import struct
import time
from typing import Optional

from gyeeta_tpu_torch.utils.journal import _SEG_FMT, _NullStats, \
    dir_segments

log = logging.getLogger("gyeeta_tpu_torch.net.segship")

# ---------------------------------------------------------------- frames
# [magic u32 | type u16 | flags u16 | body_len u32] + body — the relay
# frame shape with its own magic so a mis-wired port fails loudly.
SHIP_MAGIC = 0x47595453                   # "STYG" on the wire
_FH = struct.Struct("<IHHI")
MAX_BODY = 16 * 1024 * 1024

T_SHELLO = 1      # shipper → recv  JSON {shipper_id, token, pid,
#                                         layout, nshards}
T_SHELLO_OK = 2   # recv → shipper  JSON {ok} | {ok: False, error}
T_SMETA = 3       # shipper → recv  JSON {shard, seq, size, hash,
#                                         nrec, src{...}}
T_SRESP = 4       # recv → shipper  JSON {status: send|done|shed|
#                                         conflict, off?}
T_SDATA = 5       # shipper → recv  raw segment bytes at current offset
T_SEND = 6        # shipper → recv  JSON {} — end of segment stream
T_SACK = 7        # recv → shipper  JSON {ok} | {ok: False, reason}
T_SDROP = 8       # shipper → recv  JSON {shard, seq, size, nrec,
#                                         reason} — permanent drop
T_SHB = 9         # shipper → recv  JSON {counters, sealed_segments}

LEDGER_NAME = "gyt_ship_ledger.jsonl"
_PART_FMT = ".ship_{:08d}.part"
_PART_GLOB = ".ship_*.part"

# shipper-side cumulative counters the receiver delta-folds per epoch
# into ship_src_* rows (same shape as the relay hub's _FOLD_COUNTERS —
# a respawned shipper restarts them at 0, the new-token epoch boundary
# resets the fold baseline)
_FOLD_COUNTERS = ("ship_sealed_records", "ship_sealed_bytes",
                  "ship_reconnects", "ship_hash_retries")


def frame(ftype: int, body: bytes) -> bytes:
    if len(body) >= MAX_BODY:
        raise ValueError(f"ship frame body {len(body)}B over cap")
    return _FH.pack(SHIP_MAGIC, ftype, 0, len(body)) + body


def jframe(ftype: int, obj: dict) -> bytes:
    return frame(ftype, json.dumps(obj).encode())


def hb_interval_s(env=None) -> float:
    env = {} if env is None else env
    return max(0.05, float(env.get("GYT_SHIP_HB_S", "0.2")))


def hb_stale_s(env=None) -> float:
    env = {} if env is None else env
    return max(0.5, float(env.get("GYT_SHIP_HB_STALE_S", "5.0")))


def chunk_bytes(env=None) -> int:
    env = {} if env is None else env
    return max(4096, int(env.get("GYT_SHIP_CHUNK_KB", "256")) * 1024)


def stage_max_bytes(env=None) -> int:
    env = {} if env is None else env
    return max(1 << 20, int(env.get("GYT_SHIP_STAGE_MB", "1024")) << 20)


def seg_hash(path) -> str:
    """blake2b content hash of a segment file (the ship identity)."""
    h = hashlib.blake2b(digest_size=32)
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 20)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def key_of(shard: int, seq: int) -> str:
    return f"{int(shard):02d}/{int(seq):08d}"


# ======================================================================
# Receiver (compaction-region side)
# ======================================================================

class _ShipperState:
    """Receiver-side liveness + epoch state for one shipper identity."""

    __slots__ = ("shipper_id", "token", "writer", "last_hb",
                 "last_counters", "epochs", "pid", "connects")

    def __init__(self, shipper_id: str):
        self.shipper_id = shipper_id
        self.token: Optional[str] = None
        self.writer = None
        self.last_hb = time.monotonic()
        self.last_counters: dict = {}
        self.epochs = 0
        self.pid = 0
        self.connects = 0


class _Recv:
    """One in-flight segment transfer on one connection."""

    __slots__ = ("key", "meta", "path", "part", "f", "hasher", "off")

    def __init__(self, key, meta, path, part, f, hasher, off):
        self.key = key
        self.meta = meta
        self.path = path          # final segment path
        self.part = part          # hidden partial path
        self.f = f
        self.hasher = hasher
        self.off = off


class SegmentReceiver:
    """Accept shipper uplinks and land sealed WAL segments into a
    staging directory, hash-verified and crash-consistent, publishing
    the ``gyt_ship_*`` supervision rows. The staging dir replays
    through the port's ``Compactor`` exactly as a local WAL root."""

    def __init__(self, staging_dir, stats=None, host: str = "0.0.0.0",
                 port: int = 0, floors_fn=None, notifylog=None,
                 env=None):
        self.dir = pathlib.Path(staging_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.stats = stats if stats is not None else _NullStats()
        self.host, self.port = host, int(port)
        self.env = {} if env is None else env
        self.stage_max = stage_max_bytes(self.env)
        # optional compaction-floor source: () -> per-shard floor list
        # (or a flat int); the monitor sweeps landed segments strictly
        # below it so staging disk is bounded by compaction lag
        self.floors_fn = floors_fn
        self.notifylog = notifylog
        self._shippers: dict[str, _ShipperState] = {}
        self._server = None
        self._mon_task = None
        self.owner: Optional[dict] = None   # {shipper, layout, nshards}
        self.ledger: dict[str, dict] = {}
        self._ledger_f = None
        # crash-injection hooks for the chaos smoke: die at the k-th
        # landing, either right after the rename (mode "rename" — the
        # ledger never hears of a durably landed file) or right after
        # the ledger append (mode "ledger" — landed + ledgered, never
        # acked). Both must reconcile on the next announce.
        self._die_after = int(self.env.get("GYT_SHIP_RECV_DIE_AFTER",
                                           "0") or 0)
        self._die_mode = self.env.get("GYT_SHIP_RECV_DIE_MODE",
                                      "ledger")
        self._landings = 0
        self._load_ledger()
        self._sweep_partials()

    # --------------------------------------------------------- durability
    def _load_ledger(self) -> None:
        """Replay the ledger into memory; a torn tail line (crash mid
        append) is dropped, counted — every complete line is a terminal
        fact. Global shipped/dropped counters re-derive here so a
        receiver restart keeps the ledger invariant exact."""
        lp = self.dir / LEDGER_NAME
        shipped = dropped = 0
        if lp.exists():
            with open(lp, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        self.stats.bump("ship_ledger_torn_tail")
                        break
                    try:
                        e = json.loads(raw)
                    except ValueError:
                        self.stats.bump("ship_ledger_torn_tail")
                        break
                    if e.get("meta") == "owner":
                        self.owner = e
                        continue
                    k = e.get("k")
                    if not k or k in self.ledger:
                        continue
                    self.ledger[k] = e
                    if e.get("status") == "landed":
                        shipped += 1
                        self.stats.bump("ship_shipped_records",
                                        int(e.get("nrec", 0)))
                        self.stats.bump("ship_shipped_bytes",
                                        int(e.get("size", 0)))
                    else:
                        dropped += 1
                        self.stats.bump("ship_dropped_records",
                                        int(e.get("nrec", 0)))
                        self.stats.bump("ship_dropped_bytes",
                                        int(e.get("size", 0)))
        if shipped:
            self.stats.bump("ship_shipped_segments", shipped)
        if dropped:
            self.stats.bump("ship_dropped_segments", dropped)
        self._ledger_f = open(lp, "ab")

    def _ledger_append(self, entry: dict) -> None:
        self._ledger_f.write(json.dumps(entry, sort_keys=True).encode()
                             + b"\n")
        self._ledger_f.flush()
        os.fsync(self._ledger_f.fileno())
        if "k" in entry:
            self.ledger[entry["k"]] = entry

    def _sweep_partials(self) -> None:
        """Receiver restart: a partial's tail may be torn (our own
        unsynced writes died with us) — sweep them all, counted. The
        shipper re-ships from offset 0; the content hash would have
        rejected the torn bytes anyway."""
        n = 0
        for p in list(self.dir.glob(_PART_GLOB)) \
                + list(self.dir.glob("shard_*/" + _PART_GLOB)):
            try:
                p.unlink()
                n += 1
            except OSError:                # pragma: no cover
                pass
        if n:
            self.stats.bump("ship_partials_swept", n)

    def _dir_for(self, shard: int) -> pathlib.Path:
        if self.owner and self.owner.get("layout") == "sharded":
            d = self.dir / f"shard_{int(shard):02d}"
            d.mkdir(parents=True, exist_ok=True)
            return d
        return self.dir

    def staging_bytes(self) -> int:
        total = 0
        for pat in ("*.gytwal", "shard_*/*.gytwal",
                    _PART_GLOB, "shard_*/" + _PART_GLOB):
            for p in self.dir.glob(pat):
                try:
                    total += p.stat().st_size
                except OSError:            # pragma: no cover
                    pass
        return total

    def sweep_below(self, floors) -> int:
        """Reclaim staging: delete LANDED segments strictly below the
        per-shard compaction floor (``journal.floors_of`` of the parted
        store's position). The ledger entries stay — a re-announce of a
        swept segment still answers ``done`` by hash."""
        if floors is None:
            return 0
        if not isinstance(floors, (list, tuple)):
            floors = [int(floors)]
        n = 0
        for s, fl in enumerate(floors):
            d = self._dir_for(s)
            for seq in dir_segments(d):
                if seq >= int(fl):
                    continue
                if self.ledger.get(key_of(s, seq),
                                   {}).get("status") != "landed":
                    continue
                try:
                    (d / _SEG_FMT.format(seq)).unlink()
                    n += 1
                except OSError:            # pragma: no cover
                    pass
        if n:
            self.stats.bump("ship_staged_swept", n)
        return n

    # ---------------------------------------------------------- lifecycle
    async def start(self):
        import asyncio
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        self._mon_task = asyncio.create_task(self._monitor())
        # publish the staging footprint immediately (the monitor's
        # first tick is a second away; scrapes must not miss it)
        self.stats.gauge("ship_staging_bytes",
                         float(self.staging_bytes()))
        log.info("segment receiver on %s:%d staging=%s",
                 self.host, self.port, self.dir)
        return self.host, self.port

    async def stop(self) -> None:
        if self._mon_task is not None:
            self._mon_task.cancel()
            self._mon_task = None
        if self._server is not None:
            self._server.close()
            for st in self._shippers.values():
                if st.writer is not None:
                    try:
                        st.writer.close()
                    except Exception:      # pragma: no cover
                        pass
                    st.writer = None
            await self._server.wait_closed()
            self._server = None
        if self._ledger_f is not None:
            self._ledger_f.close()
            self._ledger_f = None

    async def _monitor(self) -> None:
        import asyncio
        stale = hb_stale_s(self.env)
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            for st in self._shippers.values():
                up = st.writer is not None
                age = now - st.last_hb
                self.stats.gauge(
                    f"ship_up|shipper={st.shipper_id}",
                    1.0 if up and age < stale else 0.0)
                self.stats.gauge(
                    f"ship_heartbeat_age_seconds|shipper="
                    f"{st.shipper_id}", round(min(age, 1e9), 3))
                self.stats.gauge(
                    f"ship_epoch|shipper={st.shipper_id}",
                    float(st.epochs))
                if st.pid:
                    self.stats.gauge(
                        f"ship_pid|shipper={st.shipper_id}",
                        float(st.pid))
            self.stats.gauge("ship_staging_bytes",
                             float(self.staging_bytes()))
            if self.floors_fn is not None:
                try:
                    self.sweep_below(self.floors_fn())
                except Exception:          # pragma: no cover
                    log.exception("ship staging sweep failed")

    # -------------------------------------------------------------- conn
    async def _read_frame(self, reader):
        import asyncio  # noqa: F401 — exception types on callers
        hdr = await reader.readexactly(_FH.size)
        magic, ftype, _fl, blen = _FH.unpack(hdr)
        if magic != SHIP_MAGIC or blen >= MAX_BODY:
            raise ValueError(f"bad ship frame {magic:#x}/{blen}")
        body = await reader.readexactly(blen) if blen else b""
        return ftype, body

    async def _handle(self, reader, writer) -> None:
        import asyncio
        st: Optional[_ShipperState] = None
        rx: Optional[_Recv] = None
        try:
            st, rx = await self._conn_loop(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except ValueError:
            self.stats.bump("ship_frames_bad")
        except Exception:                  # pragma: no cover
            log.exception("ship receiver conn failed")
        finally:
            # keep the partial on disk — a reconnect resumes from its
            # offset (segments are immutable; the end hash protects it)
            if rx is not None and rx.f is not None:
                try:
                    rx.f.close()
                except OSError:            # pragma: no cover
                    pass
            if st is not None and st.writer is writer:
                st.writer = None
                self.stats.gauge(
                    f"ship_up|shipper={st.shipper_id}", 0.0)
            try:
                writer.close()
            except Exception:              # pragma: no cover
                pass

    async def _conn_loop(self, reader, writer):
        import asyncio
        try:
            ftype, body = await asyncio.wait_for(
                self._read_frame(reader), 15.0)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ValueError, ConnectionError, OSError):
            return None, None
        if ftype != T_SHELLO:
            self.stats.bump("ship_frames_bad")
            return None, None
        hello = json.loads(body)
        shipper_id = str(hello.get("shipper_id") or "")
        token = str(hello.get("token") or "")
        layout = str(hello.get("layout") or "flat")
        if not shipper_id or not token \
                or layout not in ("flat", "sharded"):
            writer.write(jframe(T_SHELLO_OK,
                                {"ok": False, "error": "bad hello"}))
            await writer.drain()
            return None, None
        if self.owner is None:
            # first shipper binds the staging dir: ONE source region
            # per staging dir (shard/seq must be collision-free for
            # the replay to be bit-identical) — recorded in the ledger
            self.owner = {"meta": "owner", "shipper": shipper_id,
                          "layout": layout,
                          "nshards": int(hello.get("nshards", 1))}
            self._ledger_append(self.owner)
        if self.owner.get("shipper") != shipper_id \
                or self.owner.get("layout") != layout:
            writer.write(jframe(T_SHELLO_OK, {
                "ok": False,
                "error": f"staging dir owned by shipper "
                         f"{self.owner.get('shipper')}"
                         f"/{self.owner.get('layout')}"}))
            await writer.drain()
            self.stats.bump("ship_hello_refused")
            return None, None
        st = self._shippers.get(shipper_id)
        if st is None:
            st = _ShipperState(shipper_id)
            self._shippers[shipper_id] = st
            if self.notifylog is not None:
                self.notifylog.add(
                    f"segment shipper registered: {shipper_id}",
                    source="selfmon")
        if st.writer is not None:
            try:
                st.writer.close()          # new uplink wins
            except Exception:              # pragma: no cover
                pass
        if st.token is not None and st.token != token:
            # a NEW shipper process: epoch boundary — the fold
            # baseline for its cumulative heartbeat counters resets
            st.last_counters = {}
            st.epochs += 1
            self.stats.bump(f"ship_epochs|shipper={shipper_id}")
            if self.notifylog is not None:
                self.notifylog.add(
                    f"segment shipper {shipper_id} restarted "
                    f"(epoch {st.epochs})", ntype="warn",
                    source="selfmon")
        elif st.token == token:
            self.stats.bump(f"ship_reconnects|shipper={shipper_id}")
        st.token = token
        st.writer = writer
        st.pid = int(hello.get("pid", 0))
        st.last_hb = time.monotonic()
        st.connects += 1
        writer.write(jframe(T_SHELLO_OK, {"ok": True}))
        await writer.drain()
        self.stats.gauge(f"ship_up|shipper={shipper_id}", 1.0)
        rx: Optional[_Recv] = None
        while True:
            ftype, body = await self._read_frame(reader)
            if st.writer is not writer:
                return st, rx              # superseded by a new uplink
            if ftype == T_SMETA:
                rx = self._on_meta(st, writer, json.loads(body))
            elif ftype == T_SDATA:
                if rx is None:
                    self.stats.bump("ship_frames_bad")
                else:
                    rx.f.write(body)
                    rx.hasher.update(body)
                    rx.off += len(body)
            elif ftype == T_SEND:
                rx = self._on_end(st, writer, rx)
            elif ftype == T_SDROP:
                self._on_drop(st, writer, json.loads(body))
            elif ftype == T_SHB:
                self._on_hb(st, json.loads(body))
            else:
                self.stats.bump("ship_frames_bad")
            await writer.drain()

    # ------------------------------------------------------------ segment
    def _on_meta(self, st: _ShipperState, writer,
                 meta: dict) -> Optional[_Recv]:
        shard, seq = int(meta.get("shard", 0)), int(meta.get("seq", 0))
        size = int(meta.get("size", 0))
        want = str(meta.get("hash") or "")
        k = key_of(shard, seq)
        ent = self.ledger.get(k)
        if ent is not None:
            if ent.get("status") == "landed" and ent.get("hash") != want:
                # an immutable segment re-announced with a DIFFERENT
                # hash: source-side corruption or seq reuse — refuse,
                # loudly; the landed bytes stay authoritative
                self.stats.bump("ship_hash_conflicts")
                writer.write(jframe(T_SRESP, {"status": "conflict",
                                              "k": k}))
                return None
            writer.write(jframe(T_SRESP, {
                "status": "done" if ent.get("status") == "landed"
                else "shed", "k": k}))
            return None
        d = self._dir_for(shard)
        final = d / _SEG_FMT.format(seq)
        if final.exists():
            # landed but crashed before the ledger append: verify the
            # file's hash NOW — a match completes the landing (ledger +
            # done), a mismatch sweeps the stray and re-receives
            if seg_hash(final) == want:
                self._land_ledger(st, meta, k)
                writer.write(jframe(T_SRESP, {"status": "done",
                                              "k": k}))
                return None
            try:
                final.unlink()
            except OSError:                # pragma: no cover
                pass
            self.stats.bump("ship_hash_mismatches")
        part = d / _PART_FMT.format(seq)
        have = part.stat().st_size if part.exists() else 0
        if have == 0 \
                and self.staging_bytes() + size > self.stage_max:
            # bounded staging: a segment that cannot fit is SHED —
            # terminal, counted, in the ledger (the drop half of
            # sealed == shipped + dropped). The source keeps its copy
            # pinned only until this verdict; never silent.
            self.stats.bump("ship_stage_sheds")
            self._drop_ledger(st, meta, k, "stage_full")
            writer.write(jframe(T_SRESP, {"status": "shed", "k": k}))
            return None
        hasher = hashlib.blake2b(digest_size=32)
        if have > size:                    # stale oversized partial
            try:
                part.unlink()
            except OSError:                # pragma: no cover
                pass
            have = 0
        if have:
            with open(part, "rb") as f:
                while True:
                    b = f.read(1 << 20)
                    if not b:
                        break
                    hasher.update(b)
            self.stats.bump("ship_resumes")
        f = open(part, "ab")
        writer.write(jframe(T_SRESP, {"status": "send", "off": have,
                                      "k": k}))
        return _Recv(k, meta, final, part, f, hasher, have)

    def _on_end(self, st: _ShipperState, writer,
                rx: Optional[_Recv]) -> None:
        if rx is None:
            self.stats.bump("ship_frames_bad")
            return None
        meta = rx.meta
        size = int(meta.get("size", 0))
        ok = (rx.off == size
              and rx.hasher.hexdigest() == str(meta.get("hash")))
        if not ok:
            # transfer corruption: discard the partial entirely — the
            # shipper re-ships the immutable source bytes from scratch
            try:
                rx.f.close()
                rx.part.unlink()
            except OSError:                # pragma: no cover
                pass
            self.stats.bump("ship_hash_mismatches")
            writer.write(jframe(T_SACK, {"ok": False, "k": rx.key,
                                         "reason": "hash"}))
            return None
        # atomic landing: data fsync → rename → dir fsync → ledger
        # (fsynced) → ack. A crash between any two steps reconciles on
        # re-announce (see _on_meta's final-exists branch).
        rx.f.flush()
        os.fsync(rx.f.fileno())
        rx.f.close()
        os.rename(rx.part, rx.path)
        dfd = os.open(rx.path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._landings += 1
        if self._die_after and self._landings >= self._die_after \
                and self._die_mode == "rename":
            os._exit(9)
        self._land_ledger(st, meta, rx.key)
        if self._die_after and self._landings >= self._die_after \
                and self._die_mode == "ledger":
            os._exit(9)
        writer.write(jframe(T_SACK, {"ok": True, "k": rx.key}))
        return None

    def _land_ledger(self, st: _ShipperState, meta: dict,
                     k: str) -> None:
        self._ledger_append({
            "k": k, "shard": int(meta.get("shard", 0)),
            "seq": int(meta.get("seq", 0)), "status": "landed",
            "hash": str(meta.get("hash")),
            "size": int(meta.get("size", 0)),
            "nrec": int(meta.get("nrec", 0)),
            "src": dict(meta.get("src") or {},
                        shipper=st.shipper_id, token=st.token,
                        epoch=st.epochs, pid=st.pid),
            "t_usec": int(time.time() * 1e6)})
        self.stats.bump("ship_shipped_segments")
        self.stats.bump("ship_shipped_records",
                        int(meta.get("nrec", 0)))
        self.stats.bump("ship_shipped_bytes",
                        int(meta.get("size", 0)))

    def _drop_ledger(self, st: _ShipperState, meta: dict, k: str,
                     reason: str) -> None:
        self._ledger_append({
            "k": k, "shard": int(meta.get("shard", 0)),
            "seq": int(meta.get("seq", 0)), "status": "dropped"
            if reason != "stage_full" else "shed",
            "reason": reason, "hash": str(meta.get("hash") or ""),
            "size": int(meta.get("size", 0)),
            "nrec": int(meta.get("nrec", 0)),
            "src": dict(meta.get("src") or {},
                        shipper=st.shipper_id, token=st.token,
                        epoch=st.epochs, pid=st.pid),
            "t_usec": int(time.time() * 1e6)})
        self.stats.bump("ship_dropped_segments")
        self.stats.bump("ship_dropped_records",
                        int(meta.get("nrec", 0)))
        self.stats.bump("ship_dropped_bytes",
                        int(meta.get("size", 0)))

    def _on_drop(self, st: _ShipperState, writer, msg: dict) -> None:
        """Shipper-announced permanent drop (its pinned backlog hit
        its bound and shed the oldest unshipped segment): enters the
        ledger as a counted drop so the global invariant still
        closes."""
        k = key_of(int(msg.get("shard", 0)), int(msg.get("seq", 0)))
        if k not in self.ledger:
            self._drop_ledger(st, msg, k,
                              str(msg.get("reason") or "source_shed"))
        writer.write(jframe(T_SACK, {"ok": True, "k": k}))

    def _on_hb(self, st: _ShipperState, msg: dict) -> None:
        st.last_hb = time.monotonic()
        sid = st.shipper_id
        sealed = msg.get("sealed_segments")
        if sealed is not None:
            # monotone across shipper restarts (seq numbering is
            # persistent in the source dir) — a plain set, no folding
            self.stats.gauge(f"ship_sealed_segments|shipper={sid}",
                             float(sealed))
        ctrs = msg.get("counters") or {}
        last = st.last_counters
        for name in _FOLD_COUNTERS:
            d = int(ctrs.get(name, 0)) - int(last.get(name, 0))
            if d > 0:
                self.stats.bump(f"ship_src_{name[5:]}|shipper={sid}",
                                d)
        st.last_counters = {key: int(v) for key, v in ctrs.items()
                            if isinstance(v, (int, float))}


# ======================================================================
# CLI entry (the compaction-region staging process)
# ======================================================================

def recv_main(argv=None, env=None) -> int:
    """``env``: the ``GYT_SHIP_*`` mapping (the CLI hands over
    ``os.environ``; ``None`` = the defaults)."""
    import argparse
    import asyncio
    import signal

    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch shiprecv",
        description="segment-ship receiver: sealed WAL segments from "
                    "a source region land here, hash-verified, for "
                    "the compaction tier to replay as if local")
    ap.add_argument("--staging", required=True,
                    help="staging dir (becomes the compactor's "
                         "--journal-dir)")
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s segship %(message)s")
    from gyeeta_tpu_torch.utils.selfstats import Stats

    async def run():
        rcv = SegmentReceiver(args.staging, stats=Stats(),
                              host=args.listen_host,
                              port=args.listen_port, env=env)
        host, port = await rcv.start()
        # machine-parsable bind line, like the relay's RELAY_LISTEN
        print(f"SHIP_LISTEN {host} {port}", flush=True)
        stopper = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stopper.set)
            except (NotImplementedError, ValueError):
                pass
        await stopper.wait()
        await rcv.stop()

    asyncio.run(run())
    return 0


if __name__ == "__main__":                 # pragma: no cover
    raise SystemExit(recv_main())
