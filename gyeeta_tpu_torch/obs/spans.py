"""Pipeline span tracer: a fixed-size ring of per-stage spans.

Counterpart of ``SpanTracer`` in ``gyeeta_tpu/obs/spans.py``. The ring
keeps the most recent N spans of the feed pipeline — one span a stage a
batch (``deframe`` in ``feed``, ``decode_fold`` a fold dispatch,
``tick`` in ``run_tick``), each with its record count, the decode path
and the host wall time — surfaced as ``spans`` in the ``selfstats``
payload. Recording a span is two clock reads and one list-slot write.
Wall times are the host's: a fold dispatch's span ends when its kernels
are queued, not when they finish.

The reference's opt-in device-trace bracket (``FoldProfiler``, armed by
an environment variable) is not ported.
"""

from __future__ import annotations

import contextlib
import time

_FIELDS = ("name", "t", "wallms", "nrec", "path")


class SpanTracer:
    """Lock-free single-writer ring buffer of (name, t, wallms, nrec,
    path) spans. ``capacity`` bounds memory forever; old spans are
    overwritten (the notifymsg-ring discipline)."""

    __slots__ = ("_buf", "_cap", "_i", "total")

    def __init__(self, capacity: int = 1024):
        self._buf: list = [None] * max(capacity, 1)
        self._cap = max(capacity, 1)
        self._i = 0
        self.total = 0          # spans ever recorded (overwrites included)

    def record(self, name: str, t: float, wallms: float,
               nrec: int = 0, path: str = "") -> None:
        self._buf[self._i] = (name, t, wallms, nrec, path)
        self._i = (self._i + 1) % self._cap
        self.total += 1

    @contextlib.contextmanager
    def span(self, name: str, nrec: int = 0, path: str = ""):
        """Record one span around a code block (host wall time)."""
        t = time.time()
        p0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t, (time.perf_counter() - p0) * 1e3,
                        nrec, path)

    def __len__(self) -> int:
        return min(self.total, self._cap)

    def rows(self, last: int = 128) -> list[dict]:
        """Newest-first span dicts (bounded by ``last``)."""
        n = min(len(self), last)
        out = []
        for k in range(1, n + 1):
            rec = self._buf[(self._i - k) % self._cap]
            if rec is None:          # pragma: no cover — len() guards
                break
            out.append({f: (round(v, 4) if f == "wallms" else v)
                        for f, v in zip(_FIELDS, rec)})
        return out

    def clear(self) -> None:
        self._buf = [None] * self._cap
        self._i = 0
        self.total = 0
