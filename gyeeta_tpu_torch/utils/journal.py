"""Write-ahead event journal: bounded-RPO durability for the ingest edge.

Counterpart of ``gyeeta_tpu/utils/journal.py``, byte for byte in its
file format: a segment written by either package reads and replays in
the other. Engine state lives on the device and checkpoints on a
cadence, so without a journal a crash between two ``gyt_ckpt_*.npz``
saves loses every event folded since the last one. The journal closes
that gap at the WIRE boundary: every accepted event-stream chunk (after
``wire.drain2`` validated it, before the fold) appends to tick-stamped,
size-rotated segment files, and recovery re-folds the journal from the
checkpoint's recorded position through the normal decode/fold path.

File format (little-endian), one segment = ``gyt_wal_<seq:08d>.gytwal``:
8-byte magic ``GYTWAL01``, then chunks of
``{t_usec u8, nbytes u4, host_id u4, tick u8, conn_id u8}`` + bytes —
the ``GYTREC01`` capture-chunk shape (``utils/replay.py``) widened with
the attribution fields replay needs (``hid`` the agent's host,
``conn_id`` attributes torn tails, ``tick`` bounds the window).

Durability contract:
- the ingest thread only ENQUEUES chunks (microseconds); one WAL
  writer thread owns the file — it drains the backlog, writes, and
  group-fsyncs on a byte/ms cadence (``fsync_bytes`` / ``fsync_ms``).
  RPO is bounded by the last fsync, not the last checkpoint; the lag
  and the backlog ride gauges (``journal_fsync_lag_seconds``,
  ``journal_backlog_bytes``);
- when the wire outruns the disk, the backlog saturates at
  ``backlog_max_bytes`` and drops whole oldest chunks — counted
  (``wal_backlog_dropped``/``_bytes``), never silent;
- :meth:`fsync` is the BLOCKING form (checkpoint positions, close):
  it drains the backlog and syncs before returning, so a position
  recorded in checkpoint metadata is durable — checkpoint + replay
  never double-folds;
- a torn tail (SIGKILL / power loss mid-write) is truncated on open,
  counted (``wal_torn_tail``), and appends continue from the cut;
- segments wholly older than the newest durable checkpoint are
  deleted after each successful save, except those a named consumer
  (the history compactor) has not consumed yet.

The sharded runtime journals per shard: :class:`ShardedJournal` keeps
one :class:`Journal` a ``shard_NN/`` subdir, placed by the host→shard
hash the fold routes by, and its readers (:meth:`ShardedJournal
.read_from`, :func:`read_sealed_sharded`) merge the shards' streams by
window tick.
"""

from __future__ import annotations

import collections
import os
import pathlib
import struct
import threading
import time
from typing import Iterator, Optional

MAGIC = b"GYTWAL01"
# {t_usec u8, nbytes u4, host_id u4, tick u8, conn_id u8}
_WHDR = struct.Struct("<QIIQQ")
_SEG_FMT = "gyt_wal_{:08d}.gytwal"
_SEG_GLOB = "gyt_wal_*.gytwal"


class _NullStats:
    """Stats shim so the journal works without a registry attached."""

    def bump(self, name, n=1):
        pass

    def gauge(self, name, v):
        pass

    def timeit(self, name):
        import contextlib
        return contextlib.nullcontext()


class Journal:
    """Append-only segmented WAL: lock-cheap enqueue on the ingest
    thread, one writer thread doing write/rotate/group-fsync, torn-tail
    repair on open."""

    def __init__(self, path, *, segment_max_bytes: int = 64 << 20,
                 fsync_bytes: int = 1 << 20, fsync_ms: float = 50.0,
                 backlog_max_bytes: int = 64 << 20,
                 stats=None, clock=None):
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = max(int(segment_max_bytes), 1 << 16)
        self.fsync_bytes = max(int(fsync_bytes), 1)
        self.fsync_ms = float(fsync_ms)
        self.backlog_max_bytes = max(int(backlog_max_bytes), 1 << 16)
        self.stats = stats if stats is not None else _NullStats()
        self._clock = clock or time.time
        self._f = None
        self._seq = 0
        self._off = len(MAGIC)            # logical end incl. backlog
        segs = self.segments()
        if segs:
            # resume the newest segment; a torn tail (crash mid-write)
            # is physically truncated so new appends never interleave
            # with a half-written chunk
            self._seq = segs[-1]
            self._off = self._recover_tail(self._segpath(self._seq))
            self._f = open(self._segpath(self._seq), "r+b")
            self._f.seek(self._off)
        else:
            self._open_segment(0)
        # ---- writer thread state (all under _cv's lock)
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._q_bytes = 0
        self._unsynced_bytes = 0          # written but not yet fsynced
        self._oldest_unsynced_t: Optional[float] = None
        self._closing = False
        self._sync_req = False            # a blocking fsync() waits on it
        self._seal_req = False            # a blocking seal_active() waits
        # consumer handoff: segments >= a registered floor are NEVER
        # truncated even when a checkpoint supersedes them. NAMED floors
        # (one per consumer: the history compactor, the remote-ship
        # tier, ...) each advance monotonically; the effective bound is
        # the MIN over every registered floor, so no consumer can lose
        # a segment another consumer has already released. Empty = no
        # consumer registered (the pre-history behavior).
        self._floors: dict = {}
        self._worker = threading.Thread(
            target=self._writer_loop, name="gyt-wal-writer", daemon=True)
        self._worker.start()

    # ----------------------------------------------------------- segments
    def _segpath(self, seq: int) -> pathlib.Path:
        return self.dir / _SEG_FMT.format(seq)

    def segments(self) -> list[int]:
        """Existing segment sequence numbers, ascending."""
        out = []
        for p in self.dir.glob(_SEG_GLOB):
            try:
                out.append(int(p.stem.split("_")[-1]))
            except ValueError:              # foreign file — not ours
                continue
        return sorted(out)

    def _open_segment(self, seq: int) -> None:
        self._seq = seq
        self._f = open(self._segpath(seq), "ab")
        if self._f.tell() == 0:
            self._f.write(MAGIC)
            # the header must be ON DISK immediately: a reader (or a
            # crash) between open and the first cadence sync would
            # otherwise see a 0-byte "journal" and reject it
            self._f.flush()
        self._off = self._f.tell()

    def _recover_tail(self, path: pathlib.Path) -> int:
        """Walk ``path``'s chunks; truncate anything after the last
        complete one (the SIGKILL-mid-write repair). Returns the byte
        offset appends resume from."""
        size = path.stat().st_size
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
            if len(head) < len(MAGIC):
                # torn during creation: rewrite as empty
                self.stats.bump("wal_torn_tail")
                with open(path, "wb") as w:
                    w.write(MAGIC)
                return len(MAGIC)
            if head != MAGIC:
                raise ValueError(f"{path}: not a GYTWAL01 journal")
            off = len(MAGIC)
            torn = False
            while True:
                hdr = f.read(_WHDR.size)
                if len(hdr) < _WHDR.size:
                    torn = len(hdr) > 0
                    break
                _t, n, _hid, _tick, _cid = _WHDR.unpack(hdr)
                if off + _WHDR.size + n > size:
                    torn = True
                    break
                f.seek(n, 1)
                off += _WHDR.size + n
        if off < size:
            torn = True
        if torn:
            self.stats.bump("wal_torn_tail")
            os.truncate(path, off)
        return off

    # ------------------------------------------------------------- append
    def append(self, buf: bytes, hid: int = 0, conn_id: int = 0,
               tick: int = 0) -> None:
        """Enqueue one validated chunk for the writer thread — the
        ingest path never blocks on the disk. Past
        ``backlog_max_bytes`` the OLDEST queued chunks drop, counted
        (the admission controller's throttle exists to keep the fleet
        away from this point)."""
        if not buf:
            return
        if self._f is None:
            raise ValueError("journal is closed")
        now = self._clock()
        entry = (now, int(hid) & 0xFFFFFFFF, int(tick),
                 int(conn_id) & (2 ** 64 - 1), buf)
        # journal_append times what the FEED PATH pays (the enqueue —
        # microseconds); the physical write/fsync cost shows up as
        # journal_write / journal_fsync on the writer thread
        with self.stats.timeit("journal_append"), self._cv:
            self._q.append(entry)
            self._q_bytes += len(buf)
            while self._q_bytes > self.backlog_max_bytes \
                    and len(self._q) > 1:
                old = self._q.popleft()
                self._q_bytes -= len(old[4])
                self.stats.bump("wal_backlog_dropped")
                self.stats.bump("wal_backlog_dropped_bytes",
                                len(old[4]))
            self._cv.notify_all()
        self.stats.bump("wal_appended_chunks")
        self.stats.bump("wal_appended_bytes", _WHDR.size + len(buf))

    # ------------------------------------------------------ writer thread
    # The worker OWNS the file object: writes, rotation and every
    # os.fsync happen on this thread only. The ingest thread enqueues;
    # blocking fsync() raises _sync_req and waits for the worker to
    # drain + sync (single-writer discipline — no cross-thread flushes
    # on one BufferedWriter).
    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                timeout = 0.5
                if self._unsynced_bytes:
                    # sleep only until the ms budget of the oldest
                    # unsynced byte expires
                    timeout = max(0.0, self.fsync_ms / 1e3
                                  - (self._clock()
                                     - (self._oldest_unsynced_t or 0)))
                if not self._q and not self._closing \
                        and not self._sync_req and not self._seal_req \
                        and not self._sync_due():
                    self._cv.wait(timeout=timeout)
                batch = list(self._q)
                self._q.clear()
                self._q_bytes = 0
                closing = self._closing
                sync_req = self._sync_req
                seal_req = self._seal_req
            for t, hid, tick, cid, buf in batch:
                self._write_one(t, hid, tick, cid, buf)
            if seal_req and self._off > len(MAGIC):
                # compaction handoff: rotate so the current segment
                # becomes sealed (immutable) and readable by the
                # compactor; an empty active segment needs no rotation
                self._rotate()
            if (sync_req or closing or self._sync_due()) \
                    and self._unsynced_bytes:
                self._sync_now()
            with self._cv:
                if seal_req and not self._q:
                    self._seal_req = False
                    self._cv.notify_all()
                if sync_req and not self._q:
                    self._sync_req = False
                    self._cv.notify_all()
                if closing and not self._q:
                    self._cv.notify_all()
                    return

    def _sync_due(self) -> bool:
        if not self._unsynced_bytes:
            return False
        if self._unsynced_bytes >= self.fsync_bytes:
            return True
        return (self._clock() - (self._oldest_unsynced_t or 0)) * 1e3 \
            >= self.fsync_ms

    def _write_one(self, t: float, hid: int, tick: int, cid: int,
                   buf: bytes) -> None:
        with self.stats.timeit("journal_write"):
            if (self._off + _WHDR.size + len(buf) > self.segment_max_bytes
                    and self._off > len(MAGIC)):
                self._rotate()
            self._f.write(_WHDR.pack(int(t * 1e6), len(buf), hid,
                                     tick, cid))
            self._f.write(buf)
            self._off += _WHDR.size + len(buf)
        self._unsynced_bytes += _WHDR.size + len(buf)
        if self._oldest_unsynced_t is None:
            self._oldest_unsynced_t = t

    def _rotate(self) -> None:
        self._sync_now()
        self._f.close()
        self.stats.bump("wal_rotations")
        self._open_segment(self._seq + 1)

    def _sync_now(self) -> None:
        lag = (self._clock() - self._oldest_unsynced_t) \
            if self._oldest_unsynced_t is not None else 0.0
        with self.stats.timeit("journal_fsync"):
            self._f.flush()
            os.fsync(self._f.fileno())
        self.stats.bump("wal_fsyncs")
        self.stats.gauge("journal_fsync_lag_seconds", round(lag, 4))
        self._unsynced_bytes = 0
        self._oldest_unsynced_t = None

    # --------------------------------------------------------- barriers
    def poll(self) -> None:
        """Cadence hook (tick loop): nudge the writer so a quiet wire
        still syncs within the ms budget."""
        with self._cv:
            self._cv.notify_all()

    def fsync(self) -> None:
        """Make every appended byte durable BEFORE returning (the
        blocking form: checkpoint positions, close). Idempotent; safe
        after close (no-op)."""
        if self._f is None:
            return
        if threading.current_thread() is self._worker:
            self._sync_now()          # writer-side call (rotation)
            return
        with self._cv:
            if not self._worker.is_alive():       # pragma: no cover
                return
            self._sync_req = True
            self._cv.notify_all()
            while self._sync_req and self._worker.is_alive():
                self._cv.wait(timeout=0.05)

    def seal_active(self) -> int:
        """Rotate the active segment so every byte appended so far sits
        in a SEALED (immutable) segment the history compactor can
        consume (``history/compactor.py``). Blocking, like
        :meth:`fsync`. No-op on an empty active segment or a closed
        journal. Returns the first sealed-segment bound afterwards
        (the new active seq — sealed segments are all ``< seq``)."""
        if self._f is None:
            return self._seq
        with self._cv:
            if not self._worker.is_alive():       # pragma: no cover
                return self._seq
            self._seal_req = True
            self._cv.notify_all()
            while self._seal_req and self._worker.is_alive():
                self._cv.wait(timeout=0.05)
        return self._seq

    def sealed_upto(self) -> int:
        """Exclusive upper bound of sealed segments (the active seq);
        the compactor never reads at/after it while the writer lives."""
        return self._seq

    @property
    def _truncate_floor(self) -> Optional[int]:
        """Effective truncation floor: the MIN over every named
        consumer floor (None when no consumer has registered)."""
        return min(self._floors.values()) if self._floors else None

    def set_truncate_floor(self, seq: int, name: str = "compact") -> None:
        """Register a consumer's position under ``name``: segments >=
        ``seq`` are held back from checkpoint truncation until that
        consumer has processed them (the compactor rolling them into
        snapshot shards; the segment shipper landing them in the remote
        compaction region). Each named floor is monotone — it never
        moves backwards — and truncation bounds at the MIN across all
        names, so e.g. a sealed-but-unshipped segment stays on disk no
        matter how far ahead checkpoints and local compaction run."""
        cur = self._floors.get(name)
        self._floors[name] = int(seq) if cur is None \
            else max(cur, int(seq))

    # ----------------------------------------------------------- position
    def position(self) -> tuple[int, int]:
        """(segment_seq, byte_offset) of the DURABLE end. Call
        :meth:`fsync` first (checkpoint metadata does) — after it the
        backlog is empty and every byte below the offset is synced."""
        return (self._seq, self._off)

    def gauges(self) -> dict:
        """Operator gauges, refreshed per report cadence (they ride the
        same one-readback path as the engine-health vector)."""
        now = self._clock()
        with self._cv:
            backlog = self._q_bytes
        lag = (now - self._oldest_unsynced_t) \
            if self._oldest_unsynced_t is not None else 0.0
        total = 0
        nseg = 0
        for s in self.segments():
            try:
                total += self._segpath(s).stat().st_size
                nseg += 1
            except OSError:
                pass
        return {
            "journal_backlog_bytes": float(backlog),
            "journal_pending_bytes": float(backlog
                                           + self._unsynced_bytes),
            "journal_fsync_lag_seconds": round(max(lag, 0.0), 4),
            "journal_segments": float(nseg),
            "journal_bytes": float(total),
        }

    # ----------------------------------------------------------- truncate
    def truncate_upto(self, seg_seq: int) -> int:
        """Delete segments wholly older than ``seg_seq`` (the newest
        durable checkpoint's segment). When a history compactor has
        registered a truncate floor, segments it has not consumed yet
        are held back regardless of checkpoint position (otherwise a
        checkpoint cadence faster than the compaction cadence would
        silently punch holes in the history). Returns segments
        deleted."""
        bound = int(seg_seq)
        if self._truncate_floor is not None:
            bound = min(bound, self._truncate_floor)
        n = 0
        for s in self.segments():
            if s >= bound or s == self._seq:
                continue
            try:
                self._segpath(s).unlink()
                n += 1
            except OSError:
                pass
        if n:
            self.stats.bump("wal_segments_deleted", n)
        return n

    # --------------------------------------------------------------- read
    def read_from(self, pos: Optional[tuple] = None
                  ) -> Iterator[tuple[int, int, int, bytes]]:
        """Yield ``(hid, tick, conn_id, chunk)`` from ``pos`` (a
        ``position()`` tuple; None = the very beginning) through the
        end. Drains + syncs first when the writer is live (same-process
        reads see everything appended). A torn tail ends the walk
        cleanly (counted, never a struct error)."""
        if self._f is not None:
            self.fsync()
        segs = self.segments()
        if not segs:
            return
        if pos is None:
            start_seq, start_off = segs[0], len(MAGIC)
        else:
            start_seq, start_off = int(pos[0]), int(pos[1])
        if start_seq not in segs and segs and segs[0] > start_seq:
            # the position's segment is gone (over-eager truncation /
            # foreign cleanup): replay what exists, loudly
            self.stats.bump("wal_position_gap")
            start_seq, start_off = segs[0], len(MAGIC)
        for s in segs:
            if s < start_seq:
                continue
            off = start_off if s == start_seq else len(MAGIC)
            yield from self._read_segment(self._segpath(s), off)

    def _read_segment(self, path: pathlib.Path, off: int
                      ) -> Iterator[tuple[int, int, int, bytes]]:
        for _nxt, _t, hid, tick, cid, chunk in read_entries(
                path, off, self.stats):
            yield hid, tick, cid, chunk

    # -------------------------------------------------------------- close
    def close(self) -> None:
        """Drain + fsync + close (the graceful-shutdown path).
        Idempotent."""
        if self._f is None:
            return
        self.fsync()
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
        self._f.close()
        self._f = None

    def abort(self) -> None:
        """Close WITHOUT draining or fsync — the chaos/test hook
        emulating a SIGKILL'd writer (queued chunks vanish exactly like
        unsynced page-cache bytes would)."""
        if self._f is None:
            return
        with self._cv:
            self._q.clear()
            self._q_bytes = 0
            self._closing = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
        self._f.close()
        self._f = None


class ShardedJournal:
    """Per-shard WAL: one :class:`Journal` per ``shard_NN/`` subdir,
    placed by the SAME sticky hid→shard hash the fold routes by
    (``parallel/partition.py``'s ``ShardLayout``). Journaling therefore
    shards with the fold: a chunk journaled for host h replays into
    exactly the shard that folded it live (stable across reconnect and
    ``--restore-latest``).

    Duck-type compatible with :class:`Journal` where the runtimes and
    the checkpoint/replay helpers touch it; positions are PER SHARD
    (a list of ``[seg_seq, byte_off]`` pairs, shard-indexed)."""

    def __init__(self, path, n_shards: int, *,
                 subdir_fmt: str = "shard_{:02d}",
                 segment_max_bytes: int = 64 << 20,
                 fsync_bytes: int = 1 << 20, fsync_ms: float = 50.0,
                 backlog_max_bytes: int = 64 << 20,
                 stats=None, clock=None):
        self.dir = pathlib.Path(path)
        self.n = int(n_shards)
        self.subdir_fmt = subdir_fmt
        self.stats = stats if stats is not None else _NullStats()
        self._clock = clock or time.time
        # counters accumulate correctly across sub-journals (shared
        # registry); the per-sync lag gauge is last-writer-wins noise —
        # gauges() computes the honest merge on demand
        self.shards = [
            Journal(self.dir / subdir_fmt.format(s),
                    segment_max_bytes=segment_max_bytes,
                    fsync_bytes=fsync_bytes, fsync_ms=fsync_ms,
                    backlog_max_bytes=backlog_max_bytes,
                    stats=self.stats, clock=clock)
            for s in range(self.n)]

    def shard_of(self, hid: int) -> int:
        return int(hid) % self.n

    # ------------------------------------------------------------- append
    def append(self, buf: bytes, hid: int = 0, conn_id: int = 0,
               tick: int = 0) -> None:
        self.shards[self.shard_of(hid)].append(
            buf, hid=hid, conn_id=conn_id, tick=tick)

    # ----------------------------------------------------------- barriers
    def poll(self) -> None:
        for j in self.shards:
            j.poll()

    def fsync(self) -> None:
        for j in self.shards:
            j.fsync()

    def seal_active(self) -> list:
        return [j.seal_active() for j in self.shards]

    def sealed_upto(self) -> list:
        return [j.sealed_upto() for j in self.shards]

    def set_truncate_floor(self, seq, name: str = "compact") -> None:
        """Per-shard floors (a list), or one floor broadcast; ``name``
        scopes the floor to one consumer (see :meth:`Journal
        .set_truncate_floor`)."""
        if isinstance(seq, (list, tuple)):
            for j, s in zip(self.shards, seq):
                j.set_truncate_floor(int(s), name=name)
        else:
            for j in self.shards:
                j.set_truncate_floor(int(seq), name=name)

    # ----------------------------------------------------------- position
    def position(self) -> list:
        """Per-shard ``[seg_seq, byte_off]`` durable ends (call
        :meth:`fsync` first, as checkpoint metadata does)."""
        return [list(j.position()) for j in self.shards]

    def gauges(self) -> dict:
        out: dict = {}
        for j in self.shards:
            for k, v in j.gauges().items():
                if k == "journal_fsync_lag_seconds":
                    out[k] = max(out.get(k, 0.0), v)    # worst shard
                else:
                    out[k] = out.get(k, 0.0) + v
        return out

    def truncate_upto(self, bounds) -> int:
        """Per-shard checkpoint truncation (``bounds``: shard-indexed
        segment floors, the checkpoint's recorded per-shard positions)."""
        n = 0
        if isinstance(bounds, (list, tuple)):
            for j, b in zip(self.shards, bounds):
                n += j.truncate_upto(
                    int(b[0]) if isinstance(b, (list, tuple)) else int(b))
        else:
            for j in self.shards:
                n += j.truncate_upto(int(bounds))
        return n

    # --------------------------------------------------------------- read
    def read_from(self, pos=None
                  ) -> Iterator[tuple[int, int, int, bytes]]:
        """Yield ``(hid, tick, conn_id, chunk)`` across every shard's
        journal from per-shard positions, k-way-merged by window tick
        (each shard's stream is tick-monotone, so the merged replay
        folds windows in order — the cross-shard interleave within a
        tick is irrelevant: records are host-disjoint by construction).
        ``pos``: shard-indexed pairs from :meth:`position`, or None."""
        import heapq

        if pos is not None:
            pos = list(pos)
            if not pos or not isinstance(pos[0], (list, tuple)):
                # a flat (seg, off) from a pre-shard checkpoint cannot
                # be mapped onto subdirs — replay everything, loudly
                self.stats.bump("wal_position_gap")
                pos = None

        def stream(s):
            p = tuple(pos[s]) if pos is not None and s < len(pos) \
                else None
            for hid, tick, cid, chunk in self.shards[s].read_from(p):
                yield (tick, s, hid, cid, chunk)

        for tick, _s, hid, cid, chunk in heapq.merge(
                *(stream(s) for s in range(self.n)),
                key=lambda e: e[0]):
            yield hid, tick, cid, chunk

    # -------------------------------------------------------------- close
    def close(self) -> None:
        for j in self.shards:
            j.close()

    def abort(self) -> None:
        for j in self.shards:
            j.abort()


# ---------------------------------------------------- sealed-segment read
# Position-yielding walkers over WAL segment FILES, usable without a
# live Journal instance (the history compactor reads sealed segments of
# the serving process's journal dir, or a dir no process owns). Sealed
# segments are immutable, so no locking against the writer thread is
# needed.

def floors_of(pos):
    """Per-shard segment floors from a stored WAL position: a flat
    ``(seg, off)`` pair → its segment int; ``[shard, seg, off]``
    triples (sharded WAL) → a shard-indexed floor list (gaps 0)."""
    if pos and isinstance(pos[0], (list, tuple)):
        m = {int(e[0]): int(e[1]) for e in pos}
        return [m.get(s, 0) for s in range(max(m) + 1)]
    return int(pos[0])


def dir_segments(path) -> list[int]:
    """Segment sequence numbers in a journal dir, ascending."""
    out = []
    for p in pathlib.Path(path).glob(_SEG_GLOB):
        try:
            out.append(int(p.stem.split("_")[-1]))
        except ValueError:
            continue
    return sorted(out)


def sharded_subdirs(path) -> list:
    """``shard_NN`` subdirectories of a sharded WAL root, shard-index
    order; empty for a flat (single-journal) dir. The segment shipper
    and the staging compaction loop detect the layout with it, without
    a live journal object."""
    d = pathlib.Path(path)
    if not d.is_dir():
        return []
    out = []
    for p in sorted(d.glob("shard_*")):
        if p.is_dir():
            try:
                out.append((int(p.name.split("_")[-1]), p))
            except ValueError:
                continue
    return [p for _i, p in sorted(out)]


def read_entries(path, off: int = len(MAGIC), stats=None
                 ) -> Iterator[tuple[int, float, int, int, int, bytes]]:
    """Walk one segment file from byte ``off``, yielding
    ``(next_off, t_epoch, hid, tick, conn_id, chunk)`` — the
    position-carrying form the compactor needs to record a resumable
    manifest position (and the append timestamps that become shard
    wall-time ranges). A torn tail ends the walk cleanly (counted when
    ``stats``)."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a GYTWAL01 journal")
        f.seek(off)
        while True:
            hdr = f.read(_WHDR.size)
            if len(hdr) < _WHDR.size:
                if hdr and stats is not None:
                    stats.bump("wal_torn_tail_read")
                return
            t, n, hid, tick, cid = _WHDR.unpack(hdr)
            chunk = f.read(n)
            if len(chunk) < n:          # torn mid-payload
                if stats is not None:
                    stats.bump("wal_torn_tail_read")
                return
            off += _WHDR.size + n
            yield off, t / 1e6, hid, tick, cid, chunk


def read_sealed(path, pos: Optional[tuple] = None,
                upto_seq: Optional[int] = None, stats=None
                ) -> Iterator[tuple]:
    """Walk a journal dir's SEALED segments from ``pos``
    (``(seg_seq, byte_off)``; None = the very beginning), yielding
    ``(seg_seq, next_off, t_epoch, hid, tick, conn_id, chunk)``.

    ``upto_seq`` excludes the live writer's active segment (pass
    ``journal.sealed_upto()``); None reads every segment — only safe
    when no writer owns the dir (offline compaction / closed journal).
    A position whose segment was truncated away resumes at the oldest
    surviving segment, counted (``wal_position_gap``)."""
    segs = dir_segments(path)
    if upto_seq is not None:
        segs = [s for s in segs if s < int(upto_seq)]
    if not segs:
        return
    if pos is None:
        start_seq, start_off = segs[0], len(MAGIC)
    else:
        start_seq, start_off = int(pos[0]), int(pos[1])
    if start_seq not in segs and segs[0] > start_seq:
        if stats is not None:
            stats.bump("wal_position_gap")
        start_seq, start_off = segs[0], len(MAGIC)
    d = pathlib.Path(path)
    for s in segs:
        if s < start_seq:
            continue
        off = start_off if s == start_seq else len(MAGIC)
        seg = d / _SEG_FMT.format(s)
        for nxt, t, hid, tick, cid, chunk in read_entries(seg, off,
                                                          stats):
            yield s, nxt, t, hid, tick, cid, chunk


def read_sealed_sharded(subdirs, pos_map=None, uptos=None, stats=None
                        ) -> Iterator[tuple]:
    """Walk every shard subdir's sealed segments, k-way-merged by
    window tick (each shard's stream is tick-monotone), yielding
    ``(shard, seg_seq, next_off, t_epoch, hid, tick, conn_id, chunk)``
    — the sharded twin of :func:`read_sealed`, with the shard index
    prepended so the caller can keep per-shard resume positions.
    ``pos_map``: {shard: (seg, off)}; ``uptos``: per-shard exclusive
    segment bounds (a live ``ShardedJournal.sealed_upto()`` list), or
    None for offline dirs."""
    import heapq

    def stream(s, d):
        p = (pos_map or {}).get(s)
        u = uptos[s] if uptos is not None else None
        for seq, nxt, t, hid, tick, cid, chunk in read_sealed(
                d, p, u, stats=stats):
            yield (tick, s, seq, nxt, t, hid, cid, chunk)

    for tick, s, seq, nxt, t, hid, cid, chunk in heapq.merge(
            *(stream(s, d) for s, d in enumerate(subdirs)),
            key=lambda e: e[0]):
        yield s, seq, nxt, t, hid, tick, cid, chunk


# ------------------------------------------------------- runtime helpers
# Duck-typed over a runtime (rt.journal, rt.feed, rt.flush, rt.stats,
# rt._sweep_last_seq, rt._journal_replaying) so the durability contract
# lives in exactly one place.

def checkpoint_extra(rt, tick: int) -> dict:
    """Checkpoint metadata: window tick, the per-host sweep-seq
    high-water marks (the dedup state), and — when a journal is
    attached — its fsynced position, so replay starts exactly where
    the checkpointed state ends."""
    extra: dict = {"tick": int(tick)}
    seqs = getattr(rt, "_sweep_last_seq", None)
    if seqs:
        extra["sweep_seq"] = {str(k): int(v) for k, v in seqs.items()}
    j = getattr(rt, "journal", None)
    if j is not None:
        j.fsync()                    # the position must be durable
        extra["wal"] = list(j.position())
    return extra


def post_checkpoint_truncate(rt, extra: dict) -> int:
    """After a successful checkpoint save: drop journal segments the
    checkpoint supersedes (bounds WAL disk to ~one interval). Handles
    both position shapes: flat ``(seg, off)`` and the sharded journal's
    per-shard pair list."""
    j = getattr(rt, "journal", None)
    if j is None or "wal" not in extra:
        return 0
    wal = extra["wal"]
    if wal and isinstance(wal[0], (list, tuple)):
        return j.truncate_upto(wal)
    return j.truncate_upto(int(wal[0]))


def replay_journal(rt, pos: Optional[tuple] = None) -> dict:
    """Re-fold journal chunks from ``pos`` through the normal
    decode/fold path (``rt.feed``). Appends are suppressed while
    replaying (the chunks are already in the WAL). Tolerates a torn
    tail (the journal open already truncated it; reads stop cleanly).
    Returns {"chunks": n, "records": n}."""
    j = getattr(rt, "journal", None)
    if j is None:
        return {"chunks": 0, "records": 0}
    nch = nrec = 0
    rt._journal_replaying = True
    try:
        with rt.stats.timeit("wal_replay"):
            for hid, _tick, conn_id, chunk in j.read_from(
                    tuple(pos) if pos else None):
                nrec += rt.feed(chunk, hid=hid, conn_id=conn_id)
                nch += 1
        rt.flush()
    finally:
        rt._journal_replaying = False
        # a partial frame at the WAL cut must not splice into live
        # conn bytes fed after recovery
        rt._pending = b""
    rt.stats.bump("wal_replayed_chunks", nch)
    rt.stats.bump("wal_replayed_records", nrec)
    return {"chunks": nch, "records": nrec}
