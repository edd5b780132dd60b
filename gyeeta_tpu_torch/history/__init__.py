"""Historical tier: day-partitioned relational store for state snapshots.

The reference keeps current state in memory and history in Postgres with
per-day partitioned tables (``server/gy_mdb_schema.cc:85-940``:
listenstatetbl, hoststatetbl, ... + partition create/cleanup functions).
Same design here: the live path is the device sketch readback; the
historical path is SQL over day-partitioned tables written on a cadence.

Backends behind one seam (``open_store``): sqlite3 (stdlib, default —
tests and single-box runs) and Postgres
(``history_db="postgresql://…"`` → ``pgstore.PgHistoryStore``, the
reference's durable tier; day-table partition maintenance mirrors its
add/drop partition jobs).

Counterpart of ``gyeeta_tpu/history/``.
"""

from gyeeta_tpu_torch.history.store import HistoryStore, to_sql
from gyeeta_tpu_torch.history.pgstore import PgHistoryStore, open_store

__all__ = ["HistoryStore", "PgHistoryStore", "open_store", "to_sql"]

# The time-travel tier (WAL compaction → columnar snapshot shards →
# windowed queries) lives beside the relational store:
#   history/shards.py    — shard files + manifest (ShardStore)
#   history/compactor.py — sealed-WAL → shard compaction daemon
#   history/compactproc.py — per-shard replay worker processes → the
#                          parted store (PartedShardStore)
#   history/timeview.py  — at=/window= query materialization
#   history/winquant.py  — per-window sketch deltas, windowed quantiles
#   history/histwriter.py — batched single-writer thread for this store
#   history/shipper.py   — sealed WAL segments → a remote region's staging
# (imported lazily by the runtimes to keep cold-start imports light)
