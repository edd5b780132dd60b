"""Postgres history backend behind the same SQL-generation seam.

The reference's durable tier is day-partitioned Postgres with partition
maintenance in PL/pgSQL (``common/gy_postgres.h:1493``,
``server/gy_mdb_schema.cc:85-940``). :class:`PgHistoryStore` keeps the
sqlite :class:`~gyeeta_tpu_torch.history.store.HistoryStore`'s EXACT query
semantics — criteria→SQL dual execution, cross-partition aggregation
merge, retention — and swaps only what the engine requires:

- connection + ``?``→``%s`` paramstyle (psycopg 3 or psycopg2,
  lazy-imported: the package stays importable without a driver);
- typed ``CREATE TABLE`` (sqlite's dynamic columns → double precision /
  text / boolean by field kind);
- catalog introspection (``information_schema`` for sqlite_master).

Per-day TABLES are the partition unit (created on first write, dropped
by retention) — the same maintenance granularity as the reference's
``add_partition``/``drop_partition`` jobs; native ``PARTITION BY
RANGE`` would change ops, not behavior, and the seam keeps either
choice private to this class.

Select at config time by URL: ``history_db="postgresql://…"`` routes
here, any other path stays sqlite (``history.open_store``).

Counterpart of ``gyeeta_tpu/history/pgstore.py``. Without a Postgres
driver the package still imports; the URL routing, the paramstyle
facade and the fake-connection contract are what its tests hold.
"""

from __future__ import annotations

from gyeeta_tpu_torch.history.store import _TABLES, HistoryStore, _day_of, \
    _table
from gyeeta_tpu_torch.query import fieldmaps


def _pg_type(fd) -> str:
    if fd.kind == "num":
        return "double precision"
    if fd.kind == "bool":
        return "boolean"
    return "text"                 # str + enum (presentation strings)


class _PgDb:
    """sqlite-shaped facade over a psycopg connection: qmark→format
    paramstyle; AUTOCOMMIT with explicit BEGIN/COMMIT only inside
    ``with`` blocks. Bare reads must not open transactions (a server
    answering historical queries would sit idle-in-transaction for
    hours, blocking vacuum, and one failed statement would poison the
    connection with 'current transaction is aborted' forever) —
    psycopg's own ``with conn`` also CLOSES the connection, which is
    not what the store's transaction blocks mean."""

    def __init__(self, conn):
        conn.autocommit = True
        self._conn = conn

    def execute(self, q: str, params=()):
        cur = self._conn.cursor()
        if params:
            cur.execute(q.replace("?", "%s"), list(params))
        else:
            # no args ⇒ no client-side %-interpolation: literal '%'
            # (LIKE patterns) must pass through untouched
            cur.execute(q)
        return cur

    def executemany(self, q: str, seq) -> None:
        cur = self._conn.cursor()
        cur.executemany(q.replace("?", "%s"), [list(p) for p in seq])

    def commit(self) -> None:
        pass                      # autocommit: nothing pending

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        self.execute("BEGIN")
        return self

    def __exit__(self, et, ev, tb):
        self.execute("COMMIT" if et is None else "ROLLBACK")


def _connect(dsn: str):
    try:
        import psycopg
        return psycopg.connect(dsn)
    except ImportError:
        pass
    try:
        import psycopg2
        return psycopg2.connect(dsn)
    except ImportError:
        raise RuntimeError(
            "postgresql:// history backend needs psycopg (v3) or "
            "psycopg2 installed") from None


class PgHistoryStore(HistoryStore):
    """Day-partitioned Postgres snapshot store (same interface)."""

    # CAST rounds in Postgres; FLOOR matches the numpy path's
    # ``time // step * step`` (and sqlite's truncating CAST)
    TIME_BUCKET_SQL = "FLOOR(time/{step})*{step}"
    # case-sensitive containment, same semantics as sqlite instr and
    # the live numpy path's `in`
    SUBSTR_SQL = "strpos({col}, ?) > 0"

    def __init__(self, dsn: str):
        import threading
        # deliberately NOT calling super().__init__ (it opens sqlite)
        self.db = _PgDb(_connect(dsn))
        self._known: set = set()
        # serializes the history writer thread against fold-thread
        # readers (one psycopg connection is not thread-safe)
        self._dblock = threading.RLock()

    # ---------------------------------------------------- overrides
    def _ensure(self, subsys: str, day: str) -> str:
        t = _table(subsys, day)
        if t not in self._known:
            fmap = fieldmaps.field_map(subsys)
            cols = ", ".join(
                f"{c} {_pg_type(fmap[c])}" if c in fmap else f"{c} text"
                for c in _TABLES[subsys])
            with self.db:
                self.db.execute(
                    f"CREATE TABLE IF NOT EXISTS {t} "
                    f"(time double precision, {cols})")
                self.db.execute(
                    f"CREATE INDEX IF NOT EXISTS idx_{t}_time "
                    f"ON {t}(time)")
            self._known.add(t)
        return t

    def _partition(self, subsys: str, day: str):
        t = _table(subsys, day)
        if t not in self._known:
            cur = self.db.execute(
                "SELECT table_name FROM information_schema.tables "
                "WHERE table_schema = current_schema() "
                "AND table_type = 'BASE TABLE' "
                "AND table_name = ?", (t,))
            if cur.fetchone() is None:
                return None
            self._known.add(t)
        return t

    def _own_partitions(self) -> list:
        """OUR day tables only: scoped to the current schema, base
        tables, and the exact names this store creates — a shared
        database must never lose a foreign table to retention."""
        cur = self.db.execute(
            "SELECT table_name FROM information_schema.tables "
            "WHERE table_schema = current_schema() "
            "AND table_type = 'BASE TABLE'")
        prefixes = tuple(f"{s}tbl_" for s in _TABLES)
        out = []
        for (name,) in cur.fetchall():
            for p in prefixes:
                day = name[len(p):]
                if name.startswith(p) and day.isdigit():
                    out.append((name, day))
                    break
        return out

    def cleanup(self, keep_days: int, now: float) -> int:
        cutoff = _day_of(now - keep_days * 86400.0)
        dropped = 0
        with self._dblock:
            for name, day in self._own_partitions():
                if day < cutoff:
                    self.db.execute(f"DROP TABLE {name}")
                    self._known.discard(name)
                    dropped += 1
            self.db.commit()
        return dropped

    def days(self) -> list:
        with self._dblock:
            return sorted({day for _, day in self._own_partitions()})


def open_store(path_or_dsn: str) -> HistoryStore:
    """Backend selection by URL: postgresql:// → Postgres, else sqlite."""
    if path_or_dsn.startswith(("postgresql://", "postgres://")):
        return PgHistoryStore(path_or_dsn)
    return HistoryStore(path_or_dsn)
