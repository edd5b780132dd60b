"""Aggregation queries: groupby + sum/avg/min/max/count/pNN.

The reference builds aggregated SQL per subsystem (``get_select_aggr_query``
+ custom groupby, ``common/gy_query_common.cc:736-754``; per-subsystem
``web_db_aggr_*`` handlers, ``server/gy_mnodehandle.cc:1083``). Here one
aggregation engine serves both execution paths:

- **live**: the filtered columnar snapshot is grouped host-side (numpy per
  group) — the live path is already one device readback, aggregation is
  arithmetic on its columns;
- **historical**: exact-translatable queries push SUM/AVG/MIN/MAX/COUNT +
  GROUP BY down into partition SQL; percentile ops or inexact filters fall
  back to fetching the filtered rows and running the *same* numpy
  aggregator — one semantics, two speeds (the dual-execution discipline of
  ``common/gy_query_criteria.h`` extended to aggregation).

Spec syntax (JSON): ``{"aggr": ["avg(qps5s)", "p95(p95resp5s) as p",
"count(*)"], "groupby": ["hostid"], "step": 300}`` — ``step`` (historical
only) buckets time into N-second groups, the reference's downsampling
interval.

A copy of ``gyeeta_tpu/query/aggr.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import collections
import re
from typing import NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.query import fieldmaps

_SPEC_RE = re.compile(
    r"^\s*(sum|avg|min|max|count|p(\d{1,2}(?:\.\d+)?))"
    r"\(\s*(\*|\w+)\s*\)"
    r"(?:\s+as\s+(\w+))?\s*$", re.IGNORECASE)

# ops with a direct sqlite form (percentiles are numpy-only)
_SQL_OPS = {"sum": "SUM", "avg": "AVG", "min": "MIN", "max": "MAX",
            "count": "COUNT"}


class AggrSpec(NamedTuple):
    op: str                  # sum|avg|min|max|count|pNN
    field: str               # json field name, or "*" (count only)
    alias: str               # output column name
    pct: Optional[float] = None


def parse_aggr(spec: str, subsys: str) -> AggrSpec:
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"bad aggregation {spec!r}; want op(field) [as alias] with op "
            f"in sum/avg/min/max/count/pNN")
    op, pct, field, alias = m.groups()
    op = op.lower()
    fmap = fieldmaps.field_map(subsys)
    if field == "*":
        if not op.startswith("count"):
            raise ValueError(f"{spec!r}: only count(*) may use '*'")
    else:
        fd = fmap.get(field)
        if fd is None:
            raise ValueError(f"unknown field {field!r} in {spec!r}")
        if op != "count" and fd.kind not in ("num", "bool"):
            raise ValueError(
                f"{spec!r}: cannot {op} over non-numeric field {field!r}")
    pctv = float(pct) if pct else None
    if pctv is not None:
        op = "pct"
    return AggrSpec(op=op, field=field,
                    alias=alias or spec.strip().replace(" ", ""),
                    pct=pctv)


def parse_groupby(groupby, subsys: str) -> tuple:
    fmap = fieldmaps.field_map(subsys)
    out = []
    for g in groupby or ():
        if g == "time":          # historical step-bucket pseudo-column
            out.append(g)
            continue
        if g not in fmap:
            raise ValueError(f"unknown groupby field {g!r}")
        out.append(g)
    return tuple(out)


def _apply(spec: AggrSpec, vals: np.ndarray) -> float:
    if spec.op == "count":
        return float(len(vals))
    if len(vals) == 0:
        return 0.0
    v = vals.astype(np.float64)
    if spec.op == "sum":
        return float(np.sum(v))
    if spec.op == "avg":
        return float(np.mean(v))
    if spec.op == "min":
        return float(np.min(v))
    if spec.op == "max":
        return float(np.max(v))
    if spec.op == "pct":
        return float(np.percentile(v, spec.pct))
    raise AssertionError(spec.op)


def aggregate_rows(rows: list, specs: list, groupby: tuple) -> list:
    """Group + aggregate row dicts (shared by live & history fallback).

    ``rows`` values are presentation-domain (enum strings etc.); groupby
    labels pass through as-is, aggregated fields must be numeric.
    """
    groups = collections.defaultdict(list)
    for r in rows:
        key = tuple(r.get(g) for g in groupby)
        groups[key].append(r)
    if not groups and not groupby:
        # global aggregate over zero rows still yields one row (SQL
        # aggregate-without-GROUP-BY semantics; _apply gives the zeros)
        groups[()] = []
    out = []
    for key, members in groups.items():
        rec = dict(zip(groupby, key))
        for s in specs:
            if s.field == "*":
                rec[s.alias] = float(len(members))
                continue
            vals = np.array([m[s.field] for m in members
                             if m.get(s.field) is not None], np.float64)
            rec[s.alias] = _apply(s, vals)
        out.append(rec)
    return out


def aggregate_columns(cols: dict, idx: np.ndarray, specs: list,
                      groupby: tuple, fmap: dict) -> list:
    """Columnar group-aggregate over selected row indices (live path)."""
    if groupby:
        keycols = [np.asarray(cols[fmap[g].col])[idx] for g in groupby]
        keys = list(zip(*[k.tolist() for k in keycols])) \
            if keycols else [()] * len(idx)
    else:
        keys = [()] * len(idx)
    groups = collections.defaultdict(list)
    for pos, k in enumerate(keys):
        groups[k].append(pos)
    if not groups and not groupby:
        # one zero row for a global aggregate over zero matches — the SQL
        # path and aggregate_rows agree on this shape
        groups[()] = []
    out = []
    for key, members in groups.items():
        rec = {}
        for g, kv in zip(groupby, key):
            fd = fmap[g]
            rec[g] = fd.to_json(kv) if fd.to_json else kv
        sel = idx[np.asarray(members, np.int64)]
        for s in specs:
            if s.field == "*":
                rec[s.alias] = float(len(sel))
                continue
            vals = np.asarray(cols[fmap[s.field].col])[sel]
            rec[s.alias] = _apply(s, vals.astype(np.float64))
        out.append(rec)
    return out


def sql_pushdown(specs: list, groupby: tuple, step: Optional[float],
                 bucket_expr: Optional[str] = None):
    """(select_exprs, group_exprs) for the exact-SQL fast path, or None
    when any op needs numpy (percentiles). ``bucket_expr`` is the
    backend's floor-division time-bucket SQL (CAST truncates in sqlite
    but ROUNDS in Postgres — each store supplies the form that floors,
    matching the numpy path's ``time // step * step``)."""
    sel, grp = [], []
    for g in groupby:
        if g == "time":
            if not step:
                raise ValueError("groupby 'time' needs a 'step' seconds")
            expr = (bucket_expr or
                    "CAST(time/{step} AS INTEGER)*{step}").format(
                step=float(step))
            sel.append(f"{expr} AS time")
            grp.append(expr)
        else:
            sel.append(g)
            grp.append(g)
    for s in specs:
        if s.op not in _SQL_OPS:
            return None
        arg = "*" if s.field == "*" else s.field
        sel.append(f"{_SQL_OPS[s.op]}({arg}) AS \"{s.alias}\"")
    return sel, grp
