"""Reverse-DNS annotation cache: ip → domain, bounded + async.

The reference snoops DNS responses off the wire and keeps an ip→domain
map that makes connection views human-readable
(``common/gy_dns_mapping.h:46``). A userspace server can't snoop, but
it can REVERSE-resolve the addresses it serves in views — same
annotation, resolver-driven. Discipline:

- lookups NEVER block the query path: unknown ips return '' and are
  queued for one background worker (``socket.getnameinfo`` with
  NI_NAMEREQD so unresolvable addresses don't echo back as numeric
  strings);
- positive AND negative results cache with TTLs (negative shorter —
  DNS appears for freshly-deployed endpoints);
- bounded: oldest entries evict past ``capacity``.

A copy of ``gyeeta_tpu/utils/dnsmap.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional

_POS_TTL = 3600.0
_NEG_TTL = 300.0


class DnsCache:
    def __init__(self, capacity: int = 8192, clock=None):
        self._cache: dict[str, tuple] = {}   # ip → (domain, expiry)
        self._capacity = capacity
        self._clock = clock or time.monotonic
        self._q: queue.Queue = queue.Queue(maxsize=1024)
        self._queued: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- query
    def get(self, ip: str) -> str:
        """Cached domain for ip ('' unknown/unresolvable); schedules a
        background resolution on miss. Never blocks."""
        now = self._clock()
        ent = self._cache.get(ip)
        if ent is not None and ent[1] > now:
            return ent[0]
        self._schedule(ip)
        return ent[0] if ent is not None else ""

    def annotate(self, ips) -> list:
        return [self.get(ip) for ip in ips]

    def prime(self, ip: str, domain: str, ttl: float = 3600.0) -> None:
        """Insert a PASSIVELY-LEARNED mapping (port-53 snoop,
        ``trace/dnssnoop.py``) — what the IP was resolved AS, which
        beats reverse lookups for CDN/VIP addresses. Same
        oldest-expiry eviction as the resolver path: a full cache
        keeps LEARNING (expired/negative entries go first)."""
        if len(self._cache) >= self._capacity and ip not in self._cache:
            for k in sorted(self._cache,
                            key=lambda k: self._cache[k][1])[
                    : max(1, self._capacity // 8)]:
                del self._cache[k]
        self._cache[ip] = (domain, self._clock() + ttl)

    # ------------------------------------------------------ background
    def _schedule(self, ip: str) -> None:
        if ip in self._queued:
            return
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="gyt-dnsmap", daemon=True)
            self._thread.start()
        try:
            self._queued.add(ip)
            self._q.put_nowait(ip)
        except queue.Full:
            self._queued.discard(ip)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ip = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            domain, ttl = "", _NEG_TTL
            try:
                host, _ = socket.getnameinfo(
                    (ip, 0), socket.NI_NAMEREQD)
                domain, ttl = host, _POS_TTL
            except OSError:
                pass
            now = self._clock()
            if len(self._cache) >= self._capacity:
                # oldest-expiry eviction, amortized
                for k in sorted(self._cache,
                                key=lambda k: self._cache[k][1])[
                        : max(1, self._capacity // 8)]:
                    del self._cache[k]
            self._cache[ip] = (domain, now + ttl)
            self._queued.discard(ip)

    def set(self, ip: str, domain: str,
            ttl: float = _POS_TTL) -> None:
        """Direct insert (tests / future wire-snoop sources)."""
        self._cache[ip] = (domain, self._clock() + ttl)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def __len__(self) -> int:
        return len(self._cache)


def annotate_vip_cols(colmask, cache: DnsCache):
    """svcipclust (cols, mask) → same + a ``dns`` column for the VIP
    (applied OUTSIDE the registry's column cache — resolutions land
    asynchronously and must surface on the next query)."""
    import numpy as np

    cols, mask = colmask
    out = dict(cols)
    out["dns"] = np.array(
        [cache.get(str(v).rsplit(":", 1)[0]) for v in cols["vip"]],
        object)
    return out, mask
