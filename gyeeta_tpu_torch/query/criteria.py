"""Criteria/filter engine: Gyeeta filter strings → vectorized masks.

Grammar-compatible with the reference's filter language
(``common/gy_query_criteria.h:56-84`` comparators; boolean nesting via
``gy_boolparse``): leaf criteria are ``{ subsys.field op value }``, composed
with ``and`` / ``or`` / ``not`` and parentheses, e.g.::

    ( { svcstate.state in 'Bad','Severe' } and { svcstate.qps5s > 100 } )
      or { svcstate.sererr > 0 }

Differences from the reference (deliberate):
- evaluation is **columnar**: one numpy vector op per criterion over the
  whole readback snapshot, instead of a per-row expression walk — the
  in-memory analogue of the reference's dual "in-memory eval" path;
- ``like`` uses Python ``re`` (the reference uses RE2);
- the DNF expansion step (boolstuff) is unnecessary — the tree evaluates
  directly with short-circuit-free vector ops.

Supported comparators: = == != < <= > >= substr notsubstr like notlike
in notin bit2 bit3 (~ ~= =~ !~ aliases).

A copy of ``gyeeta_tpu/query/criteria.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.query import fieldmaps


class Criterion(NamedTuple):
    subsys: str
    field: str
    op: str
    values: tuple          # parsed literals (1 for scalar ops, n for in)


class BoolNode(NamedTuple):
    op: str                # "and" | "or" | "not"
    children: tuple


class ParseError(ValueError):
    pass


_COMP_ALIASES = {"==": "=", "~": "like", "~=": "like", "=~": "like",
                 "!~": "notlike"}
_COMPARATORS = ("<=", ">=", "!=", "==", "=~", "~=", "!~", "=", "<", ">",
                "~", "substr", "notsubstr", "like", "notlike", "in",
                "notin", "bit2", "bit3")

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<lbrace>\{) | (?P<rbrace>\}) |
      (?P<lparen>\() | (?P<rparen>\)) |
      (?P<comma>,) |
      (?P<str>'(?:[^'\\]|\\.)*') |
      (?P<num>-?\d+\.?\d*(?:[eE][+-]?\d+)?) |
      (?P<op><=|>=|!=|==|=~|~=|!~|[=<>~]) |
      (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )""", re.VERBOSE)


def _tokenize(s: str):
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ParseError(f"bad token at {s[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind):
        k, v = self.next()
        if k != kind:
            raise ParseError(f"expected {kind}, got {k}:{v!r}")
        return v

    # expr := and_expr ('or' and_expr)*
    def expr(self):
        left = self.and_expr()
        while self.peek() == ("word", "or"):
            self.next()
            left = BoolNode("or", (left, self.and_expr()))
        return left

    def and_expr(self):
        left = self.unary()
        while self.peek() == ("word", "and"):
            self.next()
            left = BoolNode("and", (left, self.unary()))
        return left

    def unary(self):
        if self.peek() == ("word", "not"):
            self.next()
            return BoolNode("not", (self.unary(),))
        k, _ = self.peek()
        if k == "lparen":
            self.next()
            e = self.expr()
            self.expect("rparen")
            return e
        if k == "lbrace":
            return self.criterion()
        raise ParseError(f"unexpected token {self.peek()!r}")

    def criterion(self):
        self.expect("lbrace")
        path = self.expect("word")
        if "." not in path:
            raise ParseError(f"criterion field must be subsys.field: {path}")
        subsys, field = path.split(".", 1)
        k, v = self.next()
        if k == "op":
            op = v
        elif k == "word" and v in _COMPARATORS:
            op = v
        else:
            raise ParseError(f"expected comparator, got {v!r}")
        op = _COMP_ALIASES.get(op, op)
        vals = [self._literal()]
        while self.peek()[0] == "comma":
            self.next()
            vals.append(self._literal())
        self.expect("rbrace")
        if len(vals) > 1 and op not in ("in", "notin"):
            raise ParseError(
                f"comparator {op!r} takes one value; use 'in' for lists")
        if subsys not in fieldmaps.FIELDS_OF_SUBSYS:
            raise ParseError(
                f"unknown subsystem {subsys!r}; "
                f"one of {sorted(fieldmaps.FIELDS_OF_SUBSYS)}")
        if field not in fieldmaps.field_map(subsys):
            raise ParseError(f"unknown field {subsys}.{field}")
        return Criterion(subsys, field, op, tuple(vals))

    def _literal(self):
        k, v = self.next()
        if k == "str":
            return re.sub(r"\\(.)", r"\1", v[1:-1])
        if k == "num":
            return float(v)
        if k == "word" and v.lower() in ("true", "false"):
            return v.lower() == "true"
        raise ParseError(f"expected literal, got {v!r}")


def parse(s: str):
    """Filter string → expression tree (Criterion / BoolNode)."""
    toks = _tokenize(s)
    if not toks:
        return None
    p = _Parser(toks)
    tree = p.expr()
    if p.i != len(toks):
        raise ParseError(f"trailing tokens: {p.toks[p.i:]}")
    return tree


def subsystems_of(tree) -> set:
    if tree is None:
        return set()
    if isinstance(tree, Criterion):
        return {tree.subsys}
    return set().union(*(subsystems_of(c) for c in tree.children))


def check_filter_subsys(tree, subsys: str, what: str = "filter") -> None:
    """Definition-time guard: every criterion in ``tree`` must target
    ``subsys``. Evaluation treats foreign-subsystem criteria as
    all-pass (the CRIT_SKIP join semantics queries want), which turns a
    typo'd/mismatched subsys in an alertdef filter into a def that
    silently matches EVERY row — and that only surfaces at the first
    fold-time check. Fail it where the definition is created instead.
    """
    foreign = subsystems_of(tree) - {subsys}
    if foreign:
        raise ValueError(
            f"{what} criteria reference subsystem"
            f"{'s' if len(foreign) > 1 else ''} {sorted(foreign)} but "
            f"the definition targets {subsys!r}; foreign criteria are "
            f"skipped (all-pass) at evaluation, so this definition "
            f"would match every row")


def _eval_criterion(c: Criterion, columns: dict, subsys: str, n: int):
    if c.subsys != subsys:
        # criteria for other subsystems pass (multi-subsystem filters are
        # resolved by the caller joining masks — ref CRIT_SKIP semantics)
        return np.ones(n, bool)
    fmap = fieldmaps.field_map(c.subsys)
    fd = fmap.get(c.field)
    if fd is None:
        raise ParseError(f"unknown field {c.subsys}.{c.field}")
    col = columns[fd.col]
    vals = c.values
    if fd.kind == "enum":
        vals = tuple(fd.from_json(v) for v in vals)
    v0 = vals[0]
    if fd.kind in ("num", "enum", "bool"):
        col = np.asarray(col, np.float64)
        if fd.kind == "bool" and isinstance(v0, bool):
            v0 = float(v0)
            vals = tuple(float(x) for x in vals)
        if c.op == "=":
            return col == v0
        if c.op == "!=":
            return col != v0
        if c.op == "<":
            return col < v0
        if c.op == "<=":
            return col <= v0
        if c.op == ">":
            return col > v0
        if c.op == ">=":
            return col >= v0
        if c.op == "bit2":
            return (col.astype(np.int64) & int(v0)) != 0
        if c.op == "bit3":
            return (col.astype(np.int64) & int(v0)) == int(v0)
        if c.op == "in":
            return np.isin(col, np.asarray(vals, np.float64))
        if c.op == "notin":
            return ~np.isin(col, np.asarray(vals, np.float64))
        raise ParseError(f"comparator {c.op} invalid for numeric "
                         f"field {c.field}")
    # string columns: object/str arrays
    col = np.asarray(col, object)
    sv = [str(x) for x in vals]
    if c.op == "=":
        return np.array([x == sv[0] for x in col], bool)
    if c.op == "!=":
        return np.array([x != sv[0] for x in col], bool)
    if c.op == "substr":
        return np.array([sv[0] in x for x in col], bool)
    if c.op == "notsubstr":
        return np.array([sv[0] not in x for x in col], bool)
    if c.op in ("like", "notlike"):
        rx = re.compile(sv[0])
        hit = np.array([bool(rx.search(x)) for x in col], bool)
        return hit if c.op == "like" else ~hit
    if c.op == "in":
        s = set(sv)
        return np.array([x in s for x in col], bool)
    if c.op == "notin":
        s = set(sv)
        return np.array([x not in s for x in col], bool)
    raise ParseError(f"comparator {c.op} invalid for string field {c.field}")


def evaluate(tree, columns: dict, subsys: str) -> np.ndarray:
    """Expression tree → (N,) bool mask over the snapshot columns."""
    n = len(next(iter(columns.values())))
    if tree is None:
        return np.ones(n, bool)
    if isinstance(tree, Criterion):
        return _eval_criterion(tree, columns, subsys, n)
    if tree.op == "not":
        return ~evaluate(tree.children[0], columns, subsys)
    masks = [evaluate(c, columns, subsys) for c in tree.children]
    if tree.op == "and":
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out
