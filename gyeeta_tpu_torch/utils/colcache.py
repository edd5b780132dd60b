"""Version-keyed column-snapshot memo of the runtime.

Counterpart of ``gyeeta_tpu/utils/colcache.py``: queries between state
changes serve cached ``(cols, mask)`` snapshots; every mutation path
calls :meth:`ColumnCache.bump`. Each published engine snapshot has one
of its own (``query/snapshot.py``).
"""

from __future__ import annotations


class ColumnCache:
    def __init__(self):
        self.version = 0
        self._cache: dict = {}

    def bump(self) -> None:
        """Invalidate and evict: an entry may hold lazy columns whose
        loaders read the live device state."""
        self.version += 1
        self._cache.clear()

    def peek(self, subsys: str):
        """The current-version entry for ``subsys``, or None (the
        lock-free fast path of the snapshot's single-flight compute)."""
        ent = self._cache.get(subsys)
        if ent is not None and ent[0] == self.version:
            return ent[1]
        return None

    def get(self, subsys: str, compute):
        """Cached value for ``subsys``; ``compute()`` runs only when the
        cached entry predates the current version."""
        ent = self._cache.get(subsys)
        if ent is not None and ent[0] == self.version:
            return ent[1]
        out = compute()
        self._cache[subsys] = (self.version, out)
        return out
