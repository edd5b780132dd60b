"""Runtime self-metrics: counters, gauges and per-stage timings.

The part of ``gyeeta_tpu/utils/selfstats.py`` the runtime uses:
``bump``/``gauge`` into ``counters``/``gauges``, and ``timeit`` — a
wall-time histogram per stage in the reference's geometric buckets (10
µs × 1.35^b), with the total per stage beside it.
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
        self._timings: dict[str, np.ndarray] = {}
        self._t_sum_ms: collections.Counter = collections.Counter()
        self._mu = threading.Lock()

    def bump(self, name: str, n=1):
        with self._mu:
            self.counters[name] += n

    def gauge(self, name: str, v):
        with self._mu:
            self.gauges[name] = v

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

    def timing_totals(self) -> dict:
        """{stage: (count, total ms)} of every timed stage."""
        with self._mu:
            return {k: (int(h.sum()), float(self._t_sum_ms[k]))
                    for k, h in self._timings.items()}
