"""Batched single-writer thread for the relational history store.

The per-tick ``self.history.write(...)`` block used to run SYNCHRONOUS
SQL inside ``run_tick`` — a slow sqlite fsync or a stalled Postgres
round trip stalled the fold thread for its full duration (the exact
inversion the WAL writer thread already fixed for the journal). Now
the tick loop only renders the snapshot rows (device readbacks must
stay on the fold thread) and ENQUEUES the sweep; one writer thread
owns every store write.

Discipline (mirrors ``utils/journal.py``):
- bounded queue (``history_queue_max`` sweeps): when the DB outruns the
  tick cadence the OLDEST queued sweeps drop, COUNTED
  (``history_write_dropped`` / ``_rows``), never silently; queue depth
  rides the ``gyt_history_write_queue_depth`` gauge;
- read-your-writes where it matters: ``barrier()`` drains the queue
  before db-mode alertdef evaluation and historical SQL queries, so
  only the paths that actually read the store pay for ordering;
- ``close()`` drains and joins (graceful shutdown loses nothing).

Store access is serialized by the store's own lock (``HistoryStore``
methods are thread-safe), so reader threads and this writer share one
connection safely.

Counterpart of ``gyeeta_tpu/history/histwriter.py``.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterable, Optional


class _NullStats:
    def bump(self, name, n=1):
        pass

    def gauge(self, name, v):
        pass


class HistoryWriter:
    def __init__(self, store, stats=None, max_queue: int = 64):
        self.store = store
        self.stats = stats if stats is not None else _NullStats()
        self.max_queue = max(1, int(max_queue))
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._busy = False                # a sweep is mid-write
        self._closing = False
        self._worker = threading.Thread(target=self._loop,
                                        name="gyt-hist-writer",
                                        daemon=True)
        self._worker.start()

    def write_sweep(self, items: Iterable[tuple]) -> None:
        """Enqueue one tick's sweep: ``[(subsys, t, rows), ...]``. The
        fold thread returns in microseconds; a full queue drops the
        OLDEST sweep, counted."""
        items = list(items)
        if not items:
            return
        with self._cv:
            if self._closing:
                return
            while len(self._q) >= self.max_queue:
                old = self._q.popleft()
                self.stats.bump("history_write_dropped")
                self.stats.bump("history_write_dropped_rows",
                                sum(len(r) for _s, _t, r in old))
            self._q.append(items)
            self.stats.gauge("history_write_queue_depth",
                             float(len(self._q)))
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closing:
                    self._cv.wait(timeout=0.5)
                if not self._q and self._closing:
                    self._cv.notify_all()
                    return
                items = self._q.popleft()
                self._busy = True
                self.stats.gauge("history_write_queue_depth",
                                 float(len(self._q)))
            try:
                for subsys, t, rows in items:
                    self.store.write(subsys, t, rows)
                    self.stats.bump("history_write_rows", len(rows))
                self.stats.bump("history_write_sweeps")
            except Exception:     # noqa: BLE001 — a failing DB must
                #                   not kill the writer; counted loss
                self.stats.bump("history_write_errors")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def barrier(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued sweep is durably in the store
        (the read-your-writes gate for db-mode alertdefs and
        historical SQL queries). Returns False on timeout."""
        import time
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._q or self._busy) \
                    and self._worker.is_alive():
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    def close(self) -> None:
        """Drain + join (idempotent)."""
        with self._cv:
            if self._closing:
                return
            self._closing = True
            self._cv.notify_all()
        self._worker.join(timeout=30.0)
