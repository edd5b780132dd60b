"""Stream capture + replay — the pseudo-pcap test harness analogue.

Counterpart of ``gyeeta_tpu/utils/replay.py`` over the port's
``ingest/wire.py``; a capture written by either package replays in the
other.

The reference replays pcap files through its live parser with IP/netns
translation (``partha/gy_pseudo_pcap_cap.cc``, driven by runtime-config
``pcaptrace`` blocks) as its offline integration fixture. The TPU
framework's capture boundary is the WIRE, not packets: this module
records timestamped event-stream chunks to a file and replays them —
into a Runtime directly, or over a socket as a registered agent — with
optional time compression and host-id translation (the analogue of the
reference's IP/port translation, so one capture can simulate many
hosts).

File format (little-endian): 8-byte magic ``GYTREC01``, then chunks of
``{t_usec u8, nbytes u4, pad u4}`` + bytes. Chunks are whatever byte
runs the recorder saw — frame boundaries inside are the decoder's
business, exactly like a live socket.
"""

from __future__ import annotations

import pathlib
import struct
import time
from typing import Iterator, Optional

import numpy as np

from gyeeta_tpu_torch.ingest import wire

MAGIC = b"GYTREC01"
_CHDR = struct.Struct("<QII")


class StreamRecorder:
    """Append-only capture file; one ``write`` per byte run.

    ``fsync=True`` makes every chunk durable before ``write`` returns
    (power-loss-proof captures — the flush alone only survives a
    process crash, not a host crash)."""

    def __init__(self, path, clock=None, fsync: bool = False):
        import os as _os
        self.path = pathlib.Path(path)
        self._clock = clock or time.time
        self._fsync = fsync
        self._os_fsync = _os.fsync
        self._f = open(self.path, "ab")
        if self._f.tell() == 0:
            self._f.write(MAGIC)

    def write(self, buf: bytes) -> None:
        if not buf:
            return
        self._f.write(_CHDR.pack(int(self._clock() * 1e6),
                                 len(buf), 0))
        self._f.write(buf)
        # writes are already batched (one per complete-frame run): flush
        # each so a server crash loses at most the OS buffer, and never
        # a chunk header without its payload
        self._f.flush()
        if self._fsync:
            self._os_fsync(self._f.fileno())

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_chunks(path, stats=None) -> Iterator[tuple[int, bytes]]:
    """Yield (t_usec, chunk_bytes); validates the magic. Streams —
    captures can reach many GB at product ingest rates.

    A byte-chopped final chunk (crash mid-write / torn copy) ends the
    walk CLEANLY: counted on ``stats`` as ``replay_torn_tail`` when a
    registry is passed, never a struct error or a partial-payload
    yield."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a GYTREC capture")
        while True:
            hdr = f.read(_CHDR.size)
            if len(hdr) < _CHDR.size:
                if hdr and stats is not None:
                    stats.bump("replay_torn_tail")
                return
            tus, n, _pad = _CHDR.unpack(hdr)
            chunk = f.read(n)
            if len(chunk) < n:
                # truncated tail (crash mid-write): counted, clean stop
                if stats is not None:
                    stats.bump("replay_torn_tail")
                return
            yield tus, chunk


def remap_host_ids(buf: bytes, offset: int) -> bytes:
    """Re-encode every known frame with host_id += offset — the
    host-translation knob (the reference's pcap IP/port translation
    analogue). Entity glob-ids are NOT translated: a remapped replay
    RELOCATES the captured fleet to new host ids (service rows follow
    their keys); true fleet multiplication uses distinct simulated
    agents, whose ids derive from their host index. Unknown subtypes
    and non-event frames pass through untouched."""
    out = []
    view = memoryview(buf)
    off = 0
    hsz = wire.HEADER_DT.itemsize
    esz = wire.EVENT_NOTIFY_DT.itemsize
    while off + hsz <= len(buf):
        hdr = np.frombuffer(view, wire.HEADER_DT, 1, off)[0]
        total = int(hdr["total_sz"])
        if total < hsz or off + total > len(buf):
            break
        frame = bytes(view[off: off + total])
        if int(hdr["data_type"]) == wire.COMM_EVENT_NOTIFY:
            ev = np.frombuffer(view, wire.EVENT_NOTIFY_DT, 1, off + hsz)[0]
            dt = wire.DTYPE_OF_SUBTYPE.get(int(ev["subtype"]))
            nev = int(ev["nevents"])
            if dt is not None and "host_id" in (dt.names or ()):
                if hsz + esz + nev * dt.itemsize > total:
                    raise wire.FrameError(
                        f"nevents {nev} overflows frame at {off}")
                recs = np.frombuffer(view, dt, nev, off + hsz + esz).copy()
                with np.errstate(over="ignore"):
                    recs["host_id"] = (
                        recs["host_id"].astype(np.int64)
                        + np.int64(offset)).astype(np.uint32)
                frame = (frame[: hsz + esz] + recs.tobytes()
                         + frame[hsz + esz + recs.nbytes:])
        out.append(frame)
        off += total
    out.append(bytes(view[off:]))
    return b"".join(out)


def paced_chunks(path, speed: float = 0.0, host_id_offset: int = 0,
                 stats=None) -> Iterator[tuple[float, bytes]]:
    """Yield (delay_seconds, ready-to-feed bytes) for a capture — the
    ONE implementation of pacing, partial-frame reassembly, and host-id
    remapping, shared by the sync :func:`play` and the async CLI (which
    must interleave awaits). ``delay`` is how long the consumer should
    sleep before feeding this chunk (0 when running flat out)."""
    t0: Optional[int] = None
    w0 = time.monotonic()
    pending = b""
    for tus, chunk in read_chunks(path, stats=stats):
        delay = 0.0
        if speed > 0:
            if t0 is None:
                t0 = tus
            delay = max(0.0, w0 + (tus - t0) / 1e6 / speed
                        - time.monotonic())
        if host_id_offset:
            data = pending + chunk
            k = wire.complete_prefix(data)
            pending = data[k:]
            chunk = remap_host_ids(data[:k], host_id_offset)
        if chunk or delay:
            yield delay, chunk
    if pending:
        yield 0.0, pending             # trailing partial, unremappable


def play(path, feed_fn, speed: float = 0.0,
         host_id_offset: int = 0, sleep=time.sleep, stats=None) -> int:
    """Replay a capture through ``feed_fn(bytes)``.

    ``speed``: 0 = as fast as possible; N = N× recorded pace (1 = real
    time). Returns bytes fed. With ``host_id_offset``, frames that span
    chunk boundaries reassemble before remapping (the file format
    permits arbitrary chunking even though the server records
    complete-frame runs). A torn capture tail stops cleanly (counted on
    ``stats`` as ``replay_torn_tail``)."""
    n = 0
    for delay, chunk in paced_chunks(path, speed, host_id_offset, stats):
        if delay > 0:
            sleep(delay)
        feed_fn(chunk)
        n += len(chunk)
    return n
