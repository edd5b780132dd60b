"""Exact CPU (numpy) reference implementations for sketch-accuracy tests.

Mirrors the reference's test strategy (SURVEY §4): each device sketch is
diffed against an exact host computation with explicit error bounds, the way
``test_histogram.cc``/``test_quantiles.cc`` assert on
``GY_HISTOGRAM``/``TIME_HISTOGRAM`` outputs.

Counterpart of ``gyeeta_tpu/sketch/exact.py`` (numpy only); it is also
``chip_smoke.py``'s oracle for the request-trace phase.
"""

from __future__ import annotations

import collections

import numpy as np


def distinct(keys_hi: np.ndarray, keys_lo: np.ndarray) -> int:
    k = (keys_hi.astype(np.uint64) << np.uint64(32)) | keys_lo.astype(np.uint64)
    return len(np.unique(k))


def quantiles(values: np.ndarray, qs) -> np.ndarray:
    return np.quantile(np.asarray(values, np.float64), qs)


def key_totals(keys_hi, keys_lo, values) -> dict:
    acc = collections.defaultdict(float)
    keys = (np.asarray(keys_hi, np.uint64) << np.uint64(32)) | np.asarray(
        keys_lo, np.uint64
    )
    for k, v in zip(keys.tolist(), np.asarray(values).tolist()):
        acc[k] += v
    return dict(acc)


def topk(keys_hi, keys_lo, values, k: int):
    acc = key_totals(keys_hi, keys_lo, values)
    items = sorted(acc.items(), key=lambda kv: -kv[1])[:k]
    return items


class StreamTopK:
    """Exact offline heavy-hitter reference over an event stream.

    Dict-based accumulation of (64-bit key → total weight) across any
    number of batches — the ground truth the device heavy-hitter tier
    (exact top-K lanes + invertible-sketch recovery) is measured
    against in tests and ``bench.py``'s ``topk_recover`` phase. Masks
    mirror the engine's admission rule so both sides count the same
    lanes (accept-observed flows only; see ``engine/step.py:
    ingest_conn``).
    """

    def __init__(self):
        self.acc: dict[int, float] = collections.defaultdict(float)

    def add(self, keys_hi, keys_lo, values, mask=None) -> None:
        hi = np.asarray(keys_hi, np.uint64)
        lo = np.asarray(keys_lo, np.uint64)
        v = np.asarray(values, np.float64)
        if mask is not None:
            m = np.asarray(mask, bool)
            hi, lo, v = hi[m], lo[m], v[m]
        keys = (hi << np.uint64(32)) | lo
        for k, w in zip(keys.tolist(), v.tolist()):
            self.acc[k] += w

    def add_conn_batch(self, cb) -> None:
        """Fold a decoded ConnBatch exactly the way the engine does:
        accept-observed lanes only, weight = bytes both ways."""
        self.add(cb.flow_hi, cb.flow_lo,
                 np.asarray(cb.bytes_sent, np.float64)
                 + np.asarray(cb.bytes_rcvd, np.float64),
                 mask=np.asarray(cb.valid) & np.asarray(cb.is_accept))

    def total(self) -> float:
        return float(sum(self.acc.values()))

    def __len__(self) -> int:
        return len(self.acc)

    def topk(self, k: int) -> list:
        """→ [(key64, exact_total)] heaviest first (key asc on ties —
        the same determinism rule as the recovered view)."""
        return sorted(self.acc.items(), key=lambda kv: (-kv[1], kv[0]))[:k]

    def topk_hex(self, k: int) -> list:
        return [(format(key, "016x"), v) for key, v in self.topk(k)]
