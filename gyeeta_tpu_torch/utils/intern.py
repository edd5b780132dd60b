"""String-intern service: 64-bit id ↔ name, per kind namespace.

Counterpart of ``gyeeta_tpu/utils/intern.py``. Strings travel once as
``NAME_INTERN`` announcements (``ingest/wire.py``) and thereafter as
64-bit ids inside hot records; this table resolves ids back to names for
the query layer, and its ``intern()`` half gives producers stable ids.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils import hashing as H


class InternTable:
    def __init__(self):
        self._names: dict[tuple[int, int], str] = {}
        self.version = 0    # bumped per update; registry caches key on it

    def __len__(self) -> int:
        return len(self._names)

    def update(self, recs: np.ndarray) -> int:
        """Fold a NAME_INTERN record array; returns names added/refreshed."""
        n = 0
        for r in recs:
            nlen = min(int(r["nlen"]), wire.MAX_NAME_BYTES)
            name = bytes(r["name"][:nlen]).decode("utf-8", "replace")
            self._names[(int(r["kind"]), int(r["name_id"]))] = name
            n += 1
        if n:
            self.version += 1
        return n

    def lookup(self, kind: int, name_id: int):
        """id → name, or None when the announcement hasn't arrived."""
        return self._names.get((kind, int(name_id)))

    def resolve_array(self, kind: int, ids: np.ndarray,
                      fallback_hex: bool = True) -> np.ndarray:
        """Vector id→name resolution for query columns. Unknown ids render
        as the hex id (queries never fail on a missing name)."""
        out = np.empty(len(ids), object)
        for i, v in enumerate(np.asarray(ids, np.uint64)):
            name = self._names.get((kind, int(v)))
            if name is None:
                name = format(int(v), "016x") if fallback_hex else ""
            out[i] = name
        return out

    @staticmethod
    def intern(name: str, kind: int = wire.NAME_KIND_COMM,
               name_id=None) -> int:
        """Name → stable 64-bit id (or use the given id, e.g. a glob_id)."""
        if name_id is None:
            name_id = H.hash_bytes_np(name.encode("utf-8"), salt=kind)
        return int(name_id)

    @staticmethod
    def records(entries) -> np.ndarray:
        """[(kind, name_id, name)] → NAME_INTERN record array."""
        out = np.zeros(len(entries), wire.NAME_INTERN_DT)
        for i, (kind, name_id, name) in enumerate(entries):
            raw = name.encode("utf-8")[: wire.MAX_NAME_BYTES]
            out[i]["name_id"] = np.uint64(name_id)
            out[i]["kind"] = kind
            out[i]["nlen"] = len(raw)
            out[i]["name"][: len(raw)] = np.frombuffer(raw, np.uint8)
        return out
