"""Off-loop query executor: bounded worker pool + admission control.

Counterpart of ``gyeeta_tpu/net/qexec.py``.

Every query edge (GYT binary, REST gateway, stock NM) used to execute
inline on the asyncio event loop — the same loop that drains agent
sockets into ``Runtime.feed``. A dashboard fleet therefore stalled the
fold and the fold stalled query p99. With snapshot serving
(``query/snapshot.py``) a live query never touches the fold, so it can
leave the loop entirely: :class:`QueryExecutor` runs it on a bounded
``ThreadPoolExecutor`` (snapshot reads are thread-safe — frozen device
buffers + GIL-shared result caches), and sheds with a COUNTED overload
error once the in-flight window fills, instead of wedging the loop
behind an unbounded queue (``gyt_queries_shed_total``; the reference's
L2 pools bound their MPMC queues the same way,
``server/gy_mconnhdlr.h:53-75``).

Shedding is queue-depth-aware (ROADMAP query item (d)): under
sustained overload the executor serves the NEWEST waiting query first
and sheds the OLDEST (the reference's default ``lifo`` policy) — a
dashboard refreshing every second wants its latest request answered,
not a 30-second-old one it already gave up on; the stale request costs
the same render and produces an ignored response. The reference's
``fifo`` control policy is not carried over. Every shed lands on
``gyt_queries_shed_total{policy=lifo}``.

Knobs (constructor arguments with the reference's defaults, where the
reference reads its environment):

- ``QueryExecutor(workers=4, queue_max=128)`` — pool width and max
  in-flight (queued + running) before shedding;
- ``GytServer(query_snapshot=True)`` — ``False`` routes the serving
  edges back to inline strong-consistency execution.

GIL relief: the worker threads above still serialize on
the GIL for the pure-Python half of a render, and the REST gateway
additionally pays ``json.dumps`` of every response body ON its
serving loop — at dashboard fan-out sizes that encode is the loop's
single biggest CPU bite. :class:`JsonRenderPool` moves the final
JSON encode of LARGE responses into a ``ProcessPoolExecutor``
(``JsonRenderPool(procs=0)``, 0 = off): the loop thread pays a cheap
C-speed pickle of the row dicts, the child pays the slow encode with
its own GIL, and the bytes come back ready to write. Small responses
(below ``min_rows``, default 64 rows) stay inline — the pickle round
trip would cost more than it frees. The children are spawned, never
forked, and receive plain host objects only (JSON-ready dicts): none
of them starts CUDA.

Snapshot reads on worker threads: the runtime publishes a snapshot on
the loop thread (device clones of the state), and the executor's
threads read it while the loop thread goes on folding on the same
device. The clone's copies were enqueued on the device stream before
the publish returned; every readback of it orders after them on that
stream, so a worker never reads a half-written clone and the fold path
takes no extra synchronisation.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
from typing import Optional


class Overloaded(Exception):
    """Admission control shed: the in-flight query window is full.
    The serving edge answers a counted busy/overload error; the loop
    (and the fold) stay live."""


def _encode_json(obj) -> bytes:
    """Child-process encode (top-level for pickling)."""
    import json
    return json.dumps(obj).encode()


class JsonRenderPool:
    """Off-GIL JSON encode tier for the REST gateway edge (see the
    module docstring). Safe by construction: a broken pool (killed
    child, fork trouble) falls back to the inline encode and counts
    it — responses never fail because the relief tier did."""

    def __init__(self, procs: int = 0, min_rows: int = 64, stats=None):
        self.procs = max(0, int(procs))
        self.min_rows = int(min_rows)
        self.stats = stats
        self._pool = None
        if self.procs > 0:
            # spawn, not fork: the serving process is multi-threaded
            # (CUDA runtime, query workers, WAL writer) and a forked
            # child can deadlock on locks snapshotted mid-hold, or
            # inherit a CUDA context it cannot use
            import multiprocessing
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.procs,
                mp_context=multiprocessing.get_context("spawn"))

    @property
    def enabled(self) -> bool:
        return self._pool is not None

    def _offloadable(self, obj) -> bool:
        return (self._pool is not None and isinstance(obj, dict)
                and obj.get("nrecs", 0) >= self.min_rows)

    def _bump(self, name: str) -> None:
        if self.stats is not None:
            self.stats.bump(name)

    async def encode(self, obj) -> bytes:
        import json
        if not self._offloadable(obj):
            return json.dumps(obj).encode()
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(self._pool, _encode_json,
                                             obj)
            self._bump("query_renders_offloaded")
            return out
        except Exception:               # noqa: BLE001 — relief tier
            self._bump("query_render_offload_errors")
            return json.dumps(obj).encode()

    def encode_sync(self, obj) -> bytes:
        """Blocking form (bench harness)."""
        import json
        if not self._offloadable(obj):
            return json.dumps(obj).encode()
        try:
            out = self._pool.submit(_encode_json, obj).result()
            self._bump("query_renders_offloaded")
            return out
        except Exception:               # noqa: BLE001
            self._bump("query_render_offload_errors")
            return json.dumps(obj).encode()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


class QueryExecutor:
    def __init__(self, rt, workers: Optional[int] = None,
                 queue_max: Optional[int] = None):
        self.rt = rt
        self.workers = 4 if workers is None else int(workers)
        self.queue_max = 128 if queue_max is None else int(queue_max)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, self.workers),
            thread_name_prefix="gyt-query")
        self._running = 0             # queries holding a worker thread
        # waiting room, newest at the right; (req, future) pairs.
        # All scheduling state is event-loop-confined — no locks.
        self._pending: collections.deque = collections.deque()

    @property
    def _inflight(self) -> int:
        return self._running + len(self._pending)

    # -------------------------------------------------------------- run
    async def run(self, req: dict) -> dict:
        """Admit one query: execute immediately while the pool has
        headroom, else wait in the newest-first queue. Raises
        :class:`Overloaded` (counted) when admission sheds it — the
        OLDEST waiter is shed, so THIS call usually proceeds and a
        stale one errors out instead."""
        stats = self.rt.stats
        loop = asyncio.get_running_loop()
        if self._running < self.workers and not self._pending:
            return await self._execute(loop, req)
        fut = loop.create_future()
        self._pending.append((req, fut))
        # depth-aware freshness shed: drop the OLDEST waiters past the
        # bound — the dashboard that sent them has already refreshed;
        # the newest request is the one still on screen
        while self._inflight > self.queue_max and len(self._pending) > 1:
            old_req, old_fut = self._pending.popleft()
            if not old_fut.done():
                stats.bump("queries_shed|policy=lifo")
                stats.bump("queries_shed")
                old_fut.set_exception(Overloaded(
                    f"query queue full (lifo: oldest shed, "
                    f"{self._inflight} in flight, max "
                    f"{self.queue_max})"))
        self._gauge()
        return await fut

    async def _execute(self, loop, req: dict) -> dict:
        self._running += 1
        self._gauge()
        try:
            return await loop.run_in_executor(self._pool, self._call,
                                              req)
        finally:
            self._running -= 1
            self._dispatch_next(loop)
            self._gauge()

    def _dispatch_next(self, loop) -> None:
        """A worker freed: hand it the newest waiter."""
        while self._pending and self._running < self.workers:
            req, fut = self._pending.pop()
            if fut.done():                # already shed
                continue

            async def _chain(req=req, fut=fut):
                try:
                    out = await self._execute(loop, req)
                except BaseException as e:     # noqa: BLE001
                    if not fut.done():
                        fut.set_exception(e)
                else:
                    if not fut.done():
                        fut.set_result(out)

            loop.create_task(_chain())
            return                        # _execute's finally continues

    def _gauge(self) -> None:
        self.rt.stats.gauge("query_queue_depth", float(self._inflight))

    def _call(self, req: dict) -> dict:
        return self.rt.query({**req, "consistency": "snapshot"})

    def close(self) -> None:
        for _req, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
