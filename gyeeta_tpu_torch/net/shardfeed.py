"""Per-shard ingest loops for the ``--shards`` serving mode.

Counterpart of ``gyeeta_tpu/net/shardfeed.py``. The flat serving edge
feeds every conn's bytes straight into ``Runtime.feed`` from the conn
handler. At fleet scale on a mesh that couples two rates that should be
independent: how fast agent sockets drain, and how fast the shards
fold. :class:`ShardFeeder` decouples them with the reference's L1→L2
handoff shape
(``server/gy_mconnhdlr.h`` MPMC queues), sharded the same way the fold
is: every mesh shard gets a BOUNDED byte queue keyed by the conn's
sticky ``hid`` (the layout's hid→shard hash — the same rule that places
the records on shards and the chunks in ``shard_NN/`` WAL subdirs),
and one drain task per shard feeds the runtime in arrival order.

Why it helps even on one controller loop: conn reads stop paying fold
latency (they enqueue in microseconds and yield), drains batch
everything queued per shard into back-to-back ``feed`` calls (fuller
staging slabs per dispatch), and overload becomes a COUNTED per-shard
drop (``gyt_shard_ingest_dropped_*{shard=...}``) under the admission
controller's throttle instead of an invisible socket-buffer stall.
Queue depth and byte occupancy ride per-shard gauges.
"""

from __future__ import annotations

import asyncio
import collections
import logging
from typing import Optional

log = logging.getLogger("gyeeta_tpu_torch.net.shardfeed")


class ShardFeeder:
    def __init__(self, rt, queue_max_mb: float = 8.0):
        self.rt = rt
        self.n = int(getattr(rt, "n", 1))
        self.max_bytes = int(queue_max_mb * (1 << 20))
        self._q: list = [collections.deque() for _ in range(self.n)]
        self._q_bytes = [0] * self.n
        self._wake: list = [asyncio.Event() for _ in range(self.n)]
        self._tasks: list = []
        self._started = False

    def shard_of(self, hid: int) -> int:
        lay = getattr(self.rt, "layout", None)
        if lay is not None:
            return int(lay.shard_of_host(int(hid)))
        return int(hid) % self.n

    # ------------------------------------------------------------ submit
    def submit(self, buf: bytes, hid: int = 0, conn_id: int = 0) -> int:
        """Enqueue one complete-frame run onto its shard's ingest
        queue. Past the byte bound the OLDEST queued run drops,
        counted per shard — the wire outran the fold and the throttle;
        never a silent stall. Returns len(buf) (the feed-path
        convention of returning 'accepted')."""
        s = self.shard_of(hid)
        q = self._q[s]
        q.append((buf, hid, conn_id))
        self._q_bytes[s] += len(buf)
        stats = self.rt.stats
        while self._q_bytes[s] > self.max_bytes and len(q) > 1:
            old = q.popleft()
            self._q_bytes[s] -= len(old[0])
            stats.bump(f"shard_ingest_dropped|shard={s}")
            stats.bump(f"shard_ingest_dropped_bytes|shard={s}",
                       len(old[0]))
        stats.gauge(f"shard_ingest_queue_bytes|shard={s}",
                    float(self._q_bytes[s]))
        self._wake[s].set()
        return len(buf)

    # ------------------------------------------------------------- drain
    def _drain_shard_now(self, s: int) -> int:
        """Feed everything queued for shard ``s`` right now (one
        back-to-back run — fuller staging slabs per dispatch)."""
        fed = 0
        q = self._q[s]
        while q:
            buf, hid, conn_id = q.popleft()
            self._q_bytes[s] -= len(buf)
            self.rt.feed(buf, hid=hid, conn_id=conn_id)
            fed += 1
        self.rt.stats.gauge(f"shard_ingest_queue_bytes|shard={s}",
                            float(self._q_bytes[s]))
        return fed

    async def _drain_loop(self, s: int) -> None:
        while True:
            await self._wake[s].wait()
            self._wake[s].clear()
            try:
                self._drain_shard_now(s)
            except Exception:              # pragma: no cover
                log.exception("shard %d ingest drain failed", s)
            # yield so conn readers and other shards interleave
            await asyncio.sleep(0)

    def flush_pending(self) -> int:
        """Synchronous barrier: every submitted run is fed before a
        tick or a strong-consistency query reads state (the
        ``_feed_barrier`` contract of the serving edge)."""
        fed = 0
        for s in range(self.n):
            fed += self._drain_shard_now(s)
        return fed

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._started:
            return
        self._tasks = [asyncio.create_task(self._drain_loop(s))
                       for s in range(self.n)]
        self._started = True

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks = []
        self._started = False
        self.flush_pending()      # nothing submitted stays unfolded

    def queue_depth(self, s: Optional[int] = None) -> int:
        if s is not None:
            return len(self._q[s])
        return sum(len(q) for q in self._q)
