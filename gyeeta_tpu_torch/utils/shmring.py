"""Shared-memory staging rings: the ingest-worker → fold-process wire.

The million-agent control plane splits the socket edge out of the fold
process (``net/ingestproc.py``): N ingest worker processes own wire
validation, native deframe/decode and the WAL append, and publish
DECODED columnar record batches — not raw bytes — into fixed-slot
rings living in one ``multiprocessing.shared_memory`` segment per
worker. The fold process drains the rings straight into its per-shard
staging slabs, so the fused fold dispatch path is unchanged.

Layout of one worker segment (all offsets fixed at creation)::

    [ worker header 512B | shard-0 ring | shard-1 ring | ... ]
    ring   = [ ring header 64B | slot 0 | slot 1 | ... ]
    slot   = [ slot header 32B | payload (packed record sections) ]

Concurrency contract — SPSC per ring, crash-tolerant:

- Exactly ONE producer (the worker) writes a ring, exactly ONE
  consumer (the fold process) reads it. The producer writes the slot
  payload, then the slot's ``seq`` word, then advances the ring-header
  ``head``; the consumer only reads slots below ``head``, so a worker
  killed mid-write never exposes a torn slot (head was not advanced —
  the respawned worker resumes at ``head`` and overwrites it).
- Drop-oldest COUNTED: the producer never blocks — when the consumer
  lags a full ring behind, the oldest unread slot is overwritten. The
  consumer detects the lap from the slot ``seq`` (every slot carries
  the producer's cumulative published-record count, so skipped slots
  are accounted in RECORDS, not just slots — the cross-process half of
  the no-silent-loss ledger).
- The worker header carries heartbeat words (monotone ``hb_seq``, a
  wall-clock stamp, the worker pid/epoch) plus the worker-side ledger
  counters; the supervisor reads them per poll cadence to detect a
  hung worker (process alive, loop wedged) and to render the
  ``gyt_ingest_proc_*`` metric rows.

Knobs, read from the ``env`` mapping a caller hands over (``None``
means no environment: the defaults):

- ``GYT_SHM_RING_SLOTS``    — slots per shard ring (default 64)
- ``GYT_SHM_RING_SLOT_KB``  — payload bytes per slot (default 128)
- ``GYT_SHMRING_NOTRACK``   — ``"1"`` in a worker process: an attach by
  name unregisters the segment from ``multiprocessing``'s resource
  tracker, so the supervisor stays its only owner

Sizing: one worker segment is ``nshards * slots * (32 + slot_kb*1024)``
bytes — at the defaults, ~8 MiB per worker on an 8-shard mesh.

Counterpart of ``gyeeta_tpu/utils/shmring.py`` in the same byte layout
(headers, slot chain and packed sections), so a ring one package's
producer writes drains through the other's consumer. Pure numpy and the
standard library: the ingest workers that publish into it touch no
device.
"""

from __future__ import annotations

import os
import struct
import time
from multiprocessing import shared_memory
from typing import Iterator, Optional

import numpy as np

MAGIC = 0x47595452494E4731          # "GYTRING1"

# ---- worker header (512 bytes) ----------------------------------------
# fixed scalar words first, then the named counter block
_WH = struct.Struct("<QIIQQ")        # magic, nshards, nslots, slot_bytes,
#                                      epoch
_WH_COUNTERS_OFF = 64
# Ledger + liveness counters, one u64 each, in this exact order. The
# supervisor folds deltas of these into the fold-process Stats registry
# (rendered as gyt_ingest_proc_* rows in /metrics).
COUNTER_NAMES = (
    "pid", "hb_seq", "hb_time_us", "done",
    "accepted_records",      # records drain2 built from accepted chunks
    "accepted_chunks",       # validated complete-frame chunks
    "accepted_bytes",        # wire bytes of those chunks
    "published_records",     # records committed into ring slots
    "published_slots",
    "frames_bad",            # poison frames (conn closed, counted)
    "unknown_records",       # unknown-subtype records (version skew)
    "wal_appended_chunks",   # chunks enqueued to the worker's WAL
    "wal_backlog_dropped",   # worker WAL backlog drops (counted loss)
    "conns_open",            # live event conns owned by the worker
    "conns_closed",
    "sweep_frames",          # reserved / roll-up convenience
)
WORKER_HEADER_BYTES = 512
assert _WH_COUNTERS_OFF + 8 * len(COUNTER_NAMES) <= WORKER_HEADER_BYTES

# ---- ring header (64 bytes): head only (tail is consumer-local) -------
_RH = struct.Struct("<Q")
RING_HEADER_BYTES = 64

# ---- slot header (32 bytes) -------------------------------------------
# seq, nbytes, nrec, cum_records (producer's published_records AFTER
# this slot — the drop-accounting anchor)
_SH = struct.Struct("<QIIQ")
SLOT_HEADER_BYTES = 32

# ---- packed payload: repeated record sections -------------------------
# [subtype u16 | reserved u16 | nrec u32 | nbytes u64 | raw bytes]
_SEC = struct.Struct("<HHIQ")


def ring_slots(env=None) -> int:
    env = {} if env is None else env
    return max(4, int(env.get("GYT_SHM_RING_SLOTS", "64")))


def ring_slot_bytes(env=None) -> int:
    env = {} if env is None else env
    return max(4096,
               int(env.get("GYT_SHM_RING_SLOT_KB", "128")) * 1024)


def pack_sections(recs: dict) -> bytes:
    """{subtype: structured record array} → one packed payload. The
    arrays must be C-contiguous structured arrays of the wire dtypes
    (``wire.DTYPE_OF_SUBTYPE``) — exactly what ``native.drain2``
    builds."""
    parts = []
    for subtype, arr in recs.items():
        if arr is None or len(arr) == 0:
            continue
        raw = np.ascontiguousarray(arr).tobytes()
        parts.append(_SEC.pack(int(subtype), 0, len(arr), len(raw)))
        parts.append(raw)
    return b"".join(parts)


def unpack_sections(buf, dtype_of_subtype: dict) -> tuple[dict, int]:
    """Packed payload → ({subtype: record array COPY}, nrec). Arrays
    are copied out of the (reused) ring slot buffer. Unknown subtypes
    are skipped and counted in the second return slot of the caller's
    ledger (they can only appear on version skew between worker and
    fold builds — same image in practice)."""
    out: dict = {}
    n = 0
    off = 0
    end = len(buf)
    while off + _SEC.size <= end:
        subtype, _r, nrec, nbytes = _SEC.unpack_from(buf, off)
        off += _SEC.size
        if off + nbytes > end:
            break                      # torn section: stop cleanly
        dt = dtype_of_subtype.get(subtype)
        if dt is not None and nrec:
            arr = np.frombuffer(buf, dtype=dt, count=nrec,
                                offset=off).copy()
            prev = out.get(subtype)
            out[subtype] = arr if prev is None \
                else np.concatenate([prev, arr])
            n += nrec
        off += nbytes
    return out, n


def split_records(recs: dict, max_payload: int) -> Iterator[tuple]:
    """Split a {subtype: array} dict into (payload, nrec) pieces that
    each fit ``max_payload`` bytes once packed. Record arrays split on
    record boundaries; a single record always fits (wire record dtypes
    are hundreds of bytes, slots are tens of KiB)."""
    cur: dict = {}
    cur_bytes = 0
    cur_n = 0
    for subtype, arr in recs.items():
        if arr is None or len(arr) == 0:
            continue
        itemsize = arr.dtype.itemsize
        i = 0
        while i < len(arr):
            budget = max_payload - cur_bytes - _SEC.size
            take = min(len(arr) - i, max(0, budget // itemsize))
            if take <= 0:
                if not cur_n:
                    # even an empty batch can't fit one record: a wide
                    # dtype vs a tiny slot. Fail loud — continuing here
                    # would spin forever and wedge the ingest worker.
                    raise ValueError(
                        f"record itemsize {itemsize}B (subtype "
                        f"{subtype}) exceeds slot payload budget "
                        f"{max_payload - _SEC.size}B; raise "
                        "GYT_SHM_RING_SLOT_KB")
                yield pack_sections(cur), cur_n
                cur, cur_bytes, cur_n = {}, 0, 0
                continue
            piece = arr[i:i + take]
            cur[subtype] = piece if subtype not in cur \
                else np.concatenate([cur[subtype], piece])
            cur_bytes += _SEC.size + take * itemsize
            cur_n += take
            i += take
    if cur_n:
        yield pack_sections(cur), cur_n


class WorkerShm:
    """One worker's shared segment: header + ``nshards`` rings.

    The supervisor creates it (``create=True``) and keeps the handle
    for draining; the worker attaches by name. Both sides compute the
    same fixed offsets from the header geometry. ``env``: the knob
    mapping (``GYT_SHM_RING_*`` at creation, ``GYT_SHMRING_NOTRACK`` at
    an attach); ``None`` means no environment."""

    def __init__(self, name: str, nshards: int = 0,
                 slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None,
                 create: bool = False, env=None):
        env = {} if env is None else env
        self.name = name
        if create:
            self.slots = slots if slots is not None \
                else ring_slots(env)
            self.slot_payload = (slot_bytes if slot_bytes is not None
                                 else ring_slot_bytes(env))
            self.nshards = int(nshards)
            self.slot_bytes = SLOT_HEADER_BYTES + self.slot_payload
            total = WORKER_HEADER_BYTES + self.nshards * (
                RING_HEADER_BYTES
                + self.slots * (SLOT_HEADER_BYTES + self.slot_payload))
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=total)
            self.buf = self.shm.buf
            self.buf[:WORKER_HEADER_BYTES] = b"\0" * WORKER_HEADER_BYTES
            _WH.pack_into(self.buf, 0, MAGIC, self.nshards, self.slots,
                          self.slot_payload, 0)
            for s in range(self.nshards):
                roff = self._ring_off(s)
                self.buf[roff:roff + RING_HEADER_BYTES] = \
                    b"\0" * RING_HEADER_BYTES
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            # a non-multiprocessing child attaching by name must not
            # let the resource tracker unlink the segment at exit (the
            # supervisor owns the lifecycle) — Python < 3.13 has no
            # track=False, so worker processes unregister explicitly
            # (gated: a same-process attach, e.g. in tests, keeps the
            # creator's registration intact)
            if env.get("GYT_SHMRING_NOTRACK") == "1":
                try:
                    from multiprocessing import resource_tracker
                    resource_tracker.unregister(
                        self.shm._name, "shared_memory")  # noqa: SLF001
                except Exception:           # pragma: no cover
                    pass
            self.buf = self.shm.buf
            magic, nsh, slots_, slot_b, _epoch = _WH.unpack_from(
                self.buf, 0)
            if magic != MAGIC:
                raise ValueError(f"{name}: not a GYTRING1 segment")
            self.nshards, self.slots, self.slot_payload = \
                int(nsh), int(slots_), int(slot_b)
            self.slot_bytes = SLOT_HEADER_BYTES + self.slot_payload
        # producer-side mirrors (resumed from shm on attach, so a
        # respawned worker continues each ring's seq/cum chain — the
        # cum_records chain is PER SHARD: a global chain would make the
        # consumer count another ring's merely-undrained slots as drops)
        self._head = [self._read_head(s) for s in range(self.nshards)]
        self._cum_shard = [self._resume_cum(s)
                           for s in range(self.nshards)]
        # consumer-side state (fold-process local — a fold restart is a
        # full-system restart, so no need to persist it)
        self._tail = list(self._head)
        self._consumed_recs = [0] * self.nshards
        self._consumed_base = list(self._cum_shard)

    # ------------------------------------------------------------ offsets
    def _ring_off(self, shard: int) -> int:
        return WORKER_HEADER_BYTES + shard * (
            RING_HEADER_BYTES + self.slots * self.slot_bytes)

    def _slot_off(self, shard: int, idx: int) -> int:
        return self._ring_off(shard) + RING_HEADER_BYTES \
            + idx * self.slot_bytes

    def _read_head(self, shard: int) -> int:
        return _RH.unpack_from(self.buf, self._ring_off(shard))[0]

    def _resume_cum(self, shard: int) -> int:
        """Producer resume: per-shard cumulative record count from the
        most recently committed slot (never overwritten until the NEXT
        publish, so a respawned worker reads it reliably)."""
        head = self._head[shard]
        if head <= 0:
            return 0
        off = self._slot_off(shard, (head - 1) % self.slots)
        seq, _nb, _nr, cum = _SH.unpack_from(self.buf, off)
        return int(cum) if seq == head - 1 else 0

    def _write_head(self, shard: int, head: int) -> None:
        _RH.pack_into(self.buf, self._ring_off(shard), head)

    # ----------------------------------------------------------- counters
    def counter(self, name: str) -> int:
        i = COUNTER_NAMES.index(name)
        return struct.unpack_from(
            "<Q", self.buf, _WH_COUNTERS_OFF + 8 * i)[0]

    def set_counter(self, name: str, value: int) -> None:
        i = COUNTER_NAMES.index(name)
        struct.pack_into("<Q", self.buf, _WH_COUNTERS_OFF + 8 * i,
                         int(value) & (2 ** 64 - 1))

    def add_counter(self, name: str, n: int = 1) -> None:
        self.set_counter(name, self.counter(name) + int(n))

    def counters(self) -> dict:
        vals = struct.unpack_from(
            f"<{len(COUNTER_NAMES)}Q", self.buf, _WH_COUNTERS_OFF)
        return dict(zip(COUNTER_NAMES, vals))

    def heartbeat(self) -> None:
        """Producer liveness: bump hb_seq + wall stamp (the supervisor
        reaps a worker whose process is alive but whose hb_seq stops —
        a wedged loop is as dead as a SIGKILL)."""
        self.set_counter("pid", os.getpid())
        self.add_counter("hb_seq")
        self.set_counter("hb_time_us", int(time.time() * 1e6))

    def hb_age_s(self, now: Optional[float] = None) -> float:
        t = self.counter("hb_time_us") / 1e6
        if t <= 0:
            return float("inf")
        return max(0.0, (now if now is not None else time.time()) - t)

    def bump_epoch(self) -> int:
        magic, nsh, slots_, slot_b, epoch = _WH.unpack_from(self.buf, 0)
        _WH.pack_into(self.buf, 0, magic, nsh, slots_, slot_b,
                      epoch + 1)
        return epoch + 1

    def epoch(self) -> int:
        return _WH.unpack_from(self.buf, 0)[4]

    # ----------------------------------------------------------- producer
    def publish(self, shard: int, payload: bytes, nrec: int) -> None:
        """Commit one packed payload into shard ``shard``'s ring.
        Payload must fit ``slot_payload`` (callers split with
        :func:`split_records`). Write order: payload → slot header
        (with seq) → ring head. Never blocks; the oldest unread slot
        is overwritten when the consumer lags (the consumer counts the
        lap from cum_records)."""
        if len(payload) > self.slot_payload:
            raise ValueError(
                f"payload {len(payload)}B > slot {self.slot_payload}B")
        head = self._head[shard]
        off = self._slot_off(shard, head % self.slots)
        self.buf[off + SLOT_HEADER_BYTES:
                 off + SLOT_HEADER_BYTES + len(payload)] = payload
        self._cum_shard[shard] += int(nrec)
        _SH.pack_into(self.buf, off, head, len(payload), int(nrec),
                      self._cum_shard[shard])
        self._head[shard] = head + 1
        self._write_head(shard, head + 1)
        self.set_counter("published_records",
                         sum(self._cum_shard))
        self.add_counter("published_slots")

    # ----------------------------------------------------------- consumer
    def drain(self, shard: int, max_slots: int = 0) -> tuple:
        """Read committed slots for ``shard`` → (payload-bytes list,
        nrec_total, dropped_slots, dropped_records). Dropped = slots
        the producer overwrote before we read them (drop-oldest lap),
        with the record count recovered from the cum_records chain —
        counted loss, never silent."""
        head = self._read_head(shard)
        tail = self._tail[shard]
        if head <= tail:
            return [], 0, 0, 0
        dropped_slots = 0
        dropped_records = 0
        if head - tail > self.slots:
            # producer lapped us: the oldest unread slots are gone
            new_tail = head - self.slots
            dropped_slots = new_tail - tail
            tail = new_tail
        out = []
        nrec_total = 0
        while tail < head and (not max_slots or len(out) < max_slots):
            off = self._slot_off(shard, tail % self.slots)
            seq, nbytes, nrec, cum = _SH.unpack_from(self.buf, off)
            if seq != tail:
                # overwritten between the head read and ours (another
                # lap) — resync forward; the skipped RECORDS are
                # recovered by the cum-chain gap check at the next
                # valid slot read (possibly in a LATER drain call: the
                # stale head may end this one before another read)
                head2 = self._read_head(shard)
                new_tail = max(tail, head2 - self.slots)
                if new_tail == tail:        # torn/unexpected: bail out
                    break
                dropped_slots += new_tail - tail
                tail = new_tail
                continue
            payload = bytes(self.buf[off + SLOT_HEADER_BYTES:
                                     off + SLOT_HEADER_BYTES + nbytes])
            # validate the slot was not overwritten mid-copy
            seq2 = _SH.unpack_from(self.buf, off)[0]
            if seq2 != tail:
                continue                    # retry resyncs via seq path
            # cum-chain gap check, on EVERY slot: cum(after) - nrec is
            # the producer's ring total BEFORE this slot; anything this
            # consumer has not yet accounted — prior calls
            # (consumed_recs folds prior drops in), this call's
            # consumption, this call's earlier gaps — was overwritten
            # unread. Accumulated (+=), since the producer can lap us
            # more than once per drain; zero in steady state, and
            # negative (a cum reset after a failed producer resume)
            # never counts.
            gap = ((cum - nrec) - self._consumed_base[shard]
                   - self._consumed_recs[shard] - nrec_total
                   - dropped_records)
            if gap > 0:
                dropped_records += gap
            out.append(payload)
            nrec_total += nrec
            tail += 1
        self._tail[shard] = tail
        # the cursor covers consumed AND dropped records — both are
        # accounted, so the next lap's gap math starts clean
        self._consumed_recs[shard] += nrec_total + dropped_records
        return out, nrec_total, dropped_slots, dropped_records

    def backlog(self, shard: Optional[int] = None) -> int:
        """Committed-but-unconsumed slots (consumer side)."""
        if shard is not None:
            return max(0, self._read_head(shard) - self._tail[shard])
        return sum(self.backlog(s) for s in range(self.nshards))

    def heads(self) -> list:
        return [self._read_head(s) for s in range(self.nshards)]

    def tails(self) -> list:
        return list(self._tail)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        try:
            self.shm.close()
        except Exception:                   # pragma: no cover
            pass

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except Exception:                   # pragma: no cover
            pass
