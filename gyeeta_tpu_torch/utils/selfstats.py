"""Runtime self-metrics: counters, gauges and per-stage timings.

Counterpart of ``gyeeta_tpu/utils/selfstats.py``: a registry with O(1)
``bump``/``gauge`` on the ingest path, wall-time histograms per stage in
geometric buckets (10 µs × 1.35^b) recorded by ``timeit``, and the
readbacks the ``selfstats`` and ``metrics`` subsystems render:
``snapshot``/``delta``/``timing_rows``/``timing_hists``/``export``,
:func:`selfstats_response` and :func:`bucket_upper_ms`.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time

import numpy as np

# timing buckets: 10us .. ~1000s, ×1.35 geometric (64 buckets)
_T_VMIN_MS = 0.01
_T_GAMMA = 1.35
_T_NB = 64
_T_LOG_GAMMA = math.log(_T_GAMMA)


class Stats:
    def __init__(self):
        self.counters: collections.Counter = collections.Counter()
        self.gauges: dict = {}
        self._last: dict = {}
        self._timings: dict[str, np.ndarray] = {}
        self._t_sum_ms: collections.Counter = collections.Counter()
        self.t_start = time.time()
        # Counter += and histogram increments are read-modify-write:
        # the registry takes a lock for renders on other threads
        self._mu = threading.Lock()

    def bump(self, name: str, n=1):
        with self._mu:
            self.counters[name] += n

    def gauge(self, name: str, v):
        with self._mu:
            self.gauges[name] = v

    # ------------------------------------------------------------ timing
    def observe_ms(self, name: str, ms: float) -> None:
        with self._mu:
            h = self._timings.get(name)
            if h is None:
                h = self._timings[name] = np.zeros(_T_NB, np.int64)
            b = 0 if ms <= _T_VMIN_MS else min(
                _T_NB - 1,
                int(math.log(ms / _T_VMIN_MS) / _T_LOG_GAMMA) + 1)
            h[b] += 1
            self._t_sum_ms[name] += ms

    @contextlib.contextmanager
    def timeit(self, name: str):
        """Per-stage wall-time histogram."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_ms(name, (time.perf_counter() - t0) * 1e3)

    @staticmethod
    def _bucket_ms(b: int) -> float:
        return _T_VMIN_MS * _T_GAMMA ** max(0, b - 1)

    def export(self) -> tuple[dict, dict]:
        """Consistent (counters, gauges) copies for renderers that
        iterate off-thread (the Prometheus exposition)."""
        with self._mu:
            return dict(self.counters), dict(self.gauges)

    def timing_rows(self) -> list[dict]:
        """One row per timed stage: count + p50/p95/p99 + total."""
        out = []
        for name, h, tot in self.timing_hists():
            n = int(h.sum())
            if n == 0:
                continue
            cum = np.cumsum(h)
            row = {"stage": name, "count": n,
                   "totalms": round(tot, 3)}
            for q, col in ((0.5, "p50ms"), (0.95, "p95ms"),
                           (0.99, "p99ms")):
                # rank semantics: the q-quantile sample is the
                # ceil(q*n)-th smallest, and the float product must not
                # skip an exact-boundary bucket (0.99*100 is
                # 99.000…0001 in binary; searchsorted on it walked past
                # a bucket whose cumulative count is exactly 99)
                r = min(n, max(1, math.ceil(q * n - 1e-9)))
                b = int(np.searchsorted(cum, r, side="left"))
                row[col] = round(self._bucket_ms(b), 4)
            out.append(row)
        return out

    def timing_hists(self) -> list[tuple[str, np.ndarray, float]]:
        """Raw geometric buckets per stage: (name, counts, total_ms) —
        the exposition source (``obs/prom.py`` maps these to cumulative
        ``le`` buckets)."""
        with self._mu:
            return [(name, self._timings[name].copy(),
                     float(self._t_sum_ms[name]))
                    for name in sorted(self._timings)]

    def timing_totals(self) -> dict:
        """{stage: (count, total ms)} of every timed stage."""
        with self._mu:
            return {k: (int(h.sum()), float(self._t_sum_ms[k]))
                    for k, h in self._timings.items()}

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.counters)
            out.update(self.gauges)
        out["uptime_sec"] = round(time.time() - self.t_start, 1)
        return out

    def delta(self) -> dict:
        """Counters since the previous delta() call (rate reporting)."""
        with self._mu:
            cur = dict(self.counters)
        out = {k: v - self._last.get(k, 0) for k, v in cur.items()}
        self._last = cur
        return {k: v for k, v in out.items() if v}


def selfstats_response(stats: Stats, alerts=None, spans=None) -> dict:
    """The ``selfstats`` query-subsystem payload. ``alerts``: an alert
    manager, whose ``.stats`` ride the payload as ``alerts`` (``{}``
    without one); ``spans``: the pipeline span ring
    (``obs/spans.SpanTracer``), whose newest entries ride it as
    ``spans``."""
    out = {"counters": stats.snapshot(),
           "timings": stats.timing_rows(),
           "alerts": dict(alerts.stats) if alerts is not None else {}}
    if spans is not None:
        out["spans"] = spans.rows()
    return out


# exposition helper (obs/prom.py): geometric bucket b covers
# (upper(b-1), upper(b)] with upper(0) = vmin — the cumulative-`le`
# mapping needs the upper edges
def bucket_upper_ms(b: int) -> float:
    """Upper edge (ms) of timing bucket ``b``; the last bucket is
    +Inf (it absorbs everything past vmin·γ^(NB-1))."""
    if b >= _T_NB - 1:
        return math.inf
    return _T_VMIN_MS * _T_GAMMA ** b
