"""Day-partitioned history store + criteria→SQL dual execution.

Mirrors the reference's split (``common/gy_query_criteria.h``: every
criterion can both evaluate in-memory and emit a SQL WHERE clause): the
query layer evaluates criteria columnar on live snapshots, while this
module translates the same expression tree to SQL for the historical
path. Comparators without a clean SQL form (``like``/``notlike`` regex)
fall back to a post-filter in Python — flagged by ``to_sql``.

Counterpart of ``gyeeta_tpu/history/store.py`` over the port's
``criteria``, ``fieldmaps`` and ``aggr`` (sqlite3 from the standard
library); the tables and rows are the reference's.
"""

from __future__ import annotations

import datetime
import json
import sqlite3
from typing import Iterable, Optional

from gyeeta_tpu_torch.query import criteria as C
from gyeeta_tpu_torch.query import fieldmaps

# subsys → persisted columns (json field names; enum codecs applied on
# write so history stores presentation values like the reference DB does
# for state strings via statetojson)
_TABLES = {
    "svcstate": [f.json for f in fieldmaps.SVCSTATE_FIELDS],
    "hoststate": [f.json for f in fieldmaps.HOSTSTATE_FIELDS],
    "clusterstate": [f.json for f in fieldmaps.CLUSTERSTATE_FIELDS],
    "taskstate": [f.json for f in fieldmaps.TASKSTATE_FIELDS],
    "cpumem": [f.json for f in fieldmaps.CPUMEM_FIELDS],
    "tracereq": [f.json for f in fieldmaps.TRACEREQ_FIELDS],
}


def _day_of(t: float) -> str:
    return datetime.datetime.fromtimestamp(
        t, datetime.timezone.utc).strftime("%Y%m%d")


def _table(subsys: str, day: str) -> str:
    return f"{subsys}tbl_{day}"


# case-SENSITIVE containment, matching the live numpy path's `in`
# (criteria.py): sqlite instr / Postgres strpos — sqlite LIKE is
# ASCII case-insensitive and would diverge between backends
_SUBSTR_SQLITE = "instr({col}, ?) > 0"


def _bool_literal(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def to_sql(tree, subsys: str, substr_fmt: str = _SUBSTR_SQLITE):
    """Expression tree → (where_sql, params, exact) — exact=False when a
    post-filter pass is still required (regex comparators).
    ``substr_fmt`` is the backend's case-sensitive containment SQL."""
    if tree is None:
        return "1=1", [], True
    if isinstance(tree, C.Criterion):
        if tree.subsys != subsys:
            return "1=1", [], True     # CRIT_SKIP analogue
        fd = fieldmaps.field_map(subsys)[tree.field]
        col = fd.json
        vals = list(tree.values)
        if fd.kind == "bool":
            # sqlite stores bools as 0/1 and compares loosely; Postgres
            # boolean columns reject integer literals — normalize to
            # real bools so both backends see the same typed parameter
            vals = [_bool_literal(v) for v in vals]
        if fd.kind == "enum":
            # history rows store presentation strings (row_to_json);
            # normalize query literals (numeric or string) through the
            # codec so both execution paths compare in the same domain.
            # Ordering comparators would compare lexicographically in SQL
            # but by ordinal live — post-filter those instead of pruning.
            if tree.op in ("<", "<=", ">", ">="):
                return "1=1", [], False
            vals = [fd.to_json(fd.from_json(v)) for v in vals]
        if tree.op == "=":
            return f"{col} = ?", [vals[0]], True
        if tree.op == "!=":
            return f"{col} != ?", [vals[0]], True
        if tree.op in ("<", "<=", ">", ">="):
            return f"{col} {tree.op} ?", [vals[0]], True
        if tree.op == "in":
            q = ",".join("?" * len(vals))
            return f"{col} IN ({q})", vals, True
        if tree.op == "notin":
            q = ",".join("?" * len(vals))
            return f"{col} NOT IN ({q})", vals, True
        if tree.op in ("substr", "notsubstr"):
            expr = substr_fmt.format(col=col)
            if tree.op == "notsubstr":
                expr = f"NOT ({expr})"
            return expr, [str(vals[0])], True
        if tree.op in ("like", "notlike", "bit2", "bit3"):
            # no portable SQL form → select broadly, post-filter in python
            return "1=1", [], False
        raise ValueError(f"comparator {tree.op} not translatable")
    if tree.op == "not":
        inner, params, exact = to_sql(tree.children[0], subsys,
                                      substr_fmt)
        if not exact:
            # NOT over an approximated clause must not prune in SQL
            return "1=1", [], False
        return f"NOT ({inner})", params, True
    parts, params, exact = [], [], True
    for ch in tree.children:
        s, p, e = to_sql(ch, subsys, substr_fmt)
        parts.append(f"({s})")
        params.extend(p)
        exact = exact and e
    joiner = " AND " if tree.op == "and" else " OR "
    # an OR with an inexact branch must not prune rows in SQL
    if tree.op == "or" and not exact:
        return "1=1", [], False
    return joiner.join(parts), params, exact


class HistoryStore:
    """sqlite-backed day-partitioned snapshot store."""

    # floor-division time bucket (positive time): CAST truncates here;
    # backends where CAST rounds (Postgres) override with FLOOR
    TIME_BUCKET_SQL = "CAST(time/{step} AS INTEGER)*{step}"
    # case-sensitive containment (live-path semantics); PG overrides
    SUBSTR_SQL = _SUBSTR_SQLITE

    def __init__(self, path: str = ":memory:"):
        import threading
        # one connection shared between the fold thread's readers
        # (historical queries, db-mode alertdefs) and the history
        # writer thread (history/histwriter.py) — every access is
        # serialized by self._dblock, so check_same_thread can be off
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self._known: set = set()
        self._dblock = threading.RLock()

    def _ensure(self, subsys: str, day: str) -> str:
        t = _table(subsys, day)
        if t not in self._known:
            cols = ", ".join(f"{c}" for c in _TABLES[subsys])
            self.db.execute(
                f"CREATE TABLE IF NOT EXISTS {t} (time REAL, {cols})")
            self.db.execute(
                f"CREATE INDEX IF NOT EXISTS idx_{t}_time ON {t}(time)")
            self._known.add(t)
        return t

    def write(self, subsys: str, t: float, rows: Iterable[dict]) -> int:
        """Persist one snapshot sweep (rows from query.api.execute)."""
        if subsys not in _TABLES:
            raise ValueError(f"no history table for {subsys!r}")
        with self._dblock:
            tab = self._ensure(subsys, _day_of(t))
            cols = _TABLES[subsys]
            q = (f"INSERT INTO {tab} (time, {', '.join(cols)}) VALUES "
                 f"({', '.join('?' * (len(cols) + 1))})")
            params = [[t] + [r.get(c) for c in cols] for r in rows]
            with self.db:
                # one executemany per sweep: at snapshot scale (50k
                # hosts × 1/min) row-at-a-time commits amplify writes
                # (madhava batches via DB_WRITE_ARR,
                # server/gy_mconnhdlr.h:350)
                self.db.executemany(q, params)
        return len(params)

    def _partition(self, subsys: str, day: str):
        """Partition table name if it exists (cached probe), else None."""
        t = _table(subsys, day)
        if t not in self._known:
            row = self.db.execute(
                "SELECT name FROM sqlite_master WHERE name=?",
                (t,)).fetchone()
            if row is None:
                return None
            self._known.add(t)
        return t

    def _days_between(self, tstart: float, tend: float):
        d = datetime.datetime.fromtimestamp(tstart, datetime.timezone.utc)
        end = datetime.datetime.fromtimestamp(tend, datetime.timezone.utc)
        out = []
        while d.date() <= end.date():
            out.append(d.strftime("%Y%m%d"))
            d += datetime.timedelta(days=1)
        return out

    def query(self, subsys: str, tstart: float, tend: float,
              filter: Optional[str] = None, maxrecs: int = 10000):
        """Historical query: criteria → SQL across day partitions, with
        python post-filter for regex comparators (dual execution)."""
        tree = C.parse(filter) if filter else None
        where, params, exact = to_sql(tree, subsys,
                                      substr_fmt=self.SUBSTR_SQL)
        cols = ["time"] + _TABLES[subsys]
        out = []
        with self._dblock:
            for day in self._days_between(tstart, tend):
                t = self._partition(subsys, day)
                if t is None:
                    continue
                # with an inexact WHERE, LIMIT must count post-filtered
                # rows: stream unlimited and post-filter as we go
                q = (f"SELECT {', '.join(cols)} FROM {t} "
                     f"WHERE time >= ? AND time <= ? AND ({where}) "
                     f"ORDER BY time")
                for rec in self.db.execute(q, [tstart, tend] + params):
                    row = dict(zip(cols, rec))
                    if not exact and tree is not None \
                            and not self._match(tree, subsys, row):
                        continue
                    out.append(row)
                    if len(out) >= maxrecs:
                        return out
        return out

    @staticmethod
    def _match(tree, subsys: str, row: dict) -> bool:
        """Single-row in-memory eval (the post-filter half of dual
        execution): rebuild 1-element columns keyed like live snapshots."""
        import numpy as np
        fixed = {}
        fmap = fieldmaps.field_map(subsys)
        for k, v in row.items():
            if k == "time" or k not in fmap:
                continue
            fd = fmap[k]
            if v is None:
                # NULL column: enum -1 / NaN / "" never match a criterion
                arr = (np.array([""], object) if fd.kind == "str"
                       else np.array([-1.0 if fd.kind == "enum"
                                      else np.nan]))
            elif fd.kind == "enum":
                arr = np.array([float(fd.from_json(v))])
            elif isinstance(v, str):
                arr = np.array([v], object)
            else:
                arr = np.array([float(v)])
            fixed[fd.col] = arr
        return bool(C.evaluate(tree, fixed, subsys)[0])

    def aggr_query(self, subsys: str, tstart: float, tend: float,
                   aggr, groupby=None, filter: Optional[str] = None,
                   step: Optional[float] = None, maxrecs: int = 10000):
        """Historical aggregation (the ``web_db_aggr_*`` analogue).

        Exact-translatable filters with SQL-native ops push GROUP BY into
        each day partition and merge partials host-side; percentile ops or
        inexact filters fetch the filtered rows and run the shared numpy
        aggregator — identical semantics either way (dual execution,
        ``common/gy_query_common.cc:736``).
        """
        from gyeeta_tpu_torch.query import aggr as A

        specs = [A.parse_aggr(s, subsys) for s in (
            [aggr] if isinstance(aggr, str) else list(aggr))]
        if isinstance(groupby, str):
            groupby = [groupby]
        gb = A.parse_groupby(groupby, subsys)
        if "time" in gb and not step:
            raise ValueError("groupby 'time' needs 'step' seconds")
        tree = C.parse(filter) if filter else None
        where, params, exact = to_sql(tree, subsys,
                                      substr_fmt=self.SUBSTR_SQL)
        push = A.sql_pushdown(specs, gb, step,
                              bucket_expr=self.TIME_BUCKET_SQL) \
            if exact else None
        if push is not None:
            # avg is rewritten sum+count inside, so every SQL-native op
            # merges across partitions; only percentiles force numpy
            return self._aggr_sql(subsys, tstart, tend, push, specs, gb,
                                  where, params, step, maxrecs)
        cap = 1 << 22
        rows = self.query(subsys, tstart, tend, filter, maxrecs=cap)
        if len(rows) >= cap:
            # silently aggregating a truncated prefix would return
            # confidently wrong numbers — refuse instead
            raise ValueError(
                "aggregation fallback hit the row-fetch cap "
                f"({cap}); narrow the time range or drop "
                "percentile/regex terms so SQL pushdown applies")
        if "time" in gb:
            for r in rows:
                r["time"] = float(r["time"] // float(step) * float(step))
        out = A.aggregate_rows(rows, specs, gb)
        return out[:maxrecs]

    def _aggr_sql(self, subsys, tstart, tend, push, specs, gb, where,
                  params, step, maxrecs):
        """SQL GROUP BY per partition + cross-partition merge.

        AVG across partitions is not mergeable from partial AVGs — callers
        route non-mergeable multi-partition cases through the numpy path;
        here avg is rewritten as sum+count and divided after the merge.
        """
        sel, grp = push
        # rewrite avg → sum/count pairs for cross-partition mergeability
        sel2, post = [], []
        for i, s in enumerate(specs):
            if s.op == "avg":
                sel2.append(f"SUM({s.field}) AS \"__s{i}\"")
                sel2.append(f"COUNT({s.field}) AS \"__c{i}\"")
                post.append(("avg", s.alias, f"__s{i}", f"__c{i}"))
            else:
                sel2.append(sel[len(grp) + i])
                post.append((s.op, s.alias, s.alias, None))
        acc: dict = {}
        self._dblock.acquire()
        try:
            self._aggr_scan(subsys, tstart, tend, sel, sel2, grp, gb,
                            where, params, post, acc)
        finally:
            self._dblock.release()
        out = []
        for key, row in acc.items():
            rec = dict(zip(gb, key))
            for op, alias, scol, ccol in post:
                if op == "avg":
                    c = row.get(ccol) or 0
                    rec[alias] = (row.get(scol) or 0) / c if c else 0.0
                else:
                    # NULL (zero matching rows) → 0.0, matching the numpy
                    # path's _apply-on-empty so both execution paths agree
                    v = row.get(scol)
                    rec[alias] = 0.0 if v is None else v
            out.append(rec)
            if len(out) >= maxrecs:
                break
        return out

    def _aggr_scan(self, subsys, tstart, tend, sel, sel2, grp, gb,
                   where, params, post, acc) -> None:
        for day in self._days_between(tstart, tend):
            t = self._partition(subsys, day)
            if t is None:
                continue
            q = (f"SELECT {', '.join(list(sel[:len(grp)]) + sel2)} "
                 f"FROM {t} WHERE time >= ? AND time <= ? AND ({where})")
            if grp:
                q += f" GROUP BY {', '.join(grp)}"
            names = [g for g in gb] + [c.rsplit(' AS ', 1)[-1].strip('"')
                                       for c in sel2]
            for rec in self.db.execute(q, [tstart, tend] + params):
                row = dict(zip(names, rec))
                key = tuple(row[g] for g in gb)
                cur = acc.get(key)
                if cur is None:
                    acc[key] = row
                    continue
                for op, alias, scol, ccol in post:
                    if op in ("sum", "count"):
                        cur[scol] = (cur[scol] or 0) + (row[scol] or 0)
                    elif op in ("min", "max"):
                        vals = [x for x in (cur[scol], row[scol])
                                if x is not None]
                        cur[scol] = ((min if op == "min" else max)(vals)
                                     if vals else None)
                    elif op == "avg":
                        cur[scol] = (cur[scol] or 0) + (row[scol] or 0)
                        cur[ccol] = (cur[ccol] or 0) + (row[ccol] or 0)

    def cleanup(self, keep_days: int, now: float) -> int:
        """Drop partitions older than keep_days (partition maintenance,
        ref gy_mdb_schema.cc partition cleanup functions)."""
        cutoff = _day_of(now - keep_days * 86400.0)
        dropped = 0
        with self._dblock:
            rows = self.db.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name LIKE '%tbl_%'").fetchall()
            for (name,) in rows:
                day = name.rsplit("_", 1)[-1]
                if day.isdigit() and day < cutoff:
                    self.db.execute(f"DROP TABLE {name}")
                    self._known.discard(name)
                    dropped += 1
            self.db.commit()
        return dropped

    def days(self) -> list:
        with self._dblock:
            rows = self.db.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name LIKE '%tbl_%'").fetchall()
        return sorted({r[0].rsplit("_", 1)[-1] for r in rows})
