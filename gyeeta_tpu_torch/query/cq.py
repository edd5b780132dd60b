"""Continuous-query engine: standing predicates evaluated server-side.

The reference evaluates filter criteria where the stream already flows
(``gy_query_criteria`` inside madhava); our subscription tier
(``net/subs.py``) pushed whole-panel deltas and left predicate work to
every client, and the alert manager ran a SECOND predicate evaluator
over the same columns. This module is the one evaluation engine both
now share:

- **Normalization + grouping** — a standing filter canonicalizes
  through ``query/normalize.py:canonical_filter`` and groups by
  ``(subsys, canonical-criteria)``: N subscribers (or N alertdefs)
  asking a semantically-equal question cost ONE predicate pass per
  tick. That is the sPIN move (PAPERS.md): computation rides the
  stream once, amortized over every consumer.

- **Membership carried across ticks** — each group holds the row set
  currently matching its predicate. A tick advances membership from
  the panel's CHANGED rows only (the hub already diffs the panel for
  its row-keyed delta stream): unchanged rows cannot change a pure
  predicate's verdict, so per-tick predicate cost is O(churn), not
  O(panel).

- **enter / leave / change events** — first-class delta kinds
  (``query/delta.py`` applies them): ``enter`` ships rows newly
  matching, ``leave`` ships the keys of rows that stopped matching
  (or left the panel), ``change`` ships members whose row bytes moved
  while still matching. Applying a tick's event chain client-side
  rebuilds the canonical membership response byte-exactly
  (property-tested against a brute-force replay oracle in
  ``tests/test_cq.py``).

Two evaluation domains, one grouping/lifecycle core:

- **row domain** (the hub): rendered JSON rows re-enter the criteria
  engine through :func:`columns_of_rows` (enum names decode back to
  ordinals via the field map's ``from_json``);
- **column domain** (the alert manager): raw snapshot columns — the
  same arrays queries render from — keep alert rows byte-identical to
  the legacy evaluator while the per-def predicate scan collapses
  into the shared group pass (:func:`advance_entities` is the
  enter/stay/leave lifecycle step alertdefs consume: fire on enter,
  count consecutive membership, resolve on leave).

A copy of ``gyeeta_tpu/query/cq.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gyeeta_tpu_torch.query import criteria, delta as D, fieldmaps
from gyeeta_tpu_torch.query.normalize import canonical_filter, request_key

# a continuous query's panel render: the FULL panel, one render per
# (panel, tick) shared by every criteria group standing on it (and by
# any plain subscriber of the same normalized request)
PANEL_MAXRECS = 1_000_000


def panel_request(subsys: str) -> dict:
    return {"subsys": subsys, "maxrecs": PANEL_MAXRECS}


def normalize_cq(subsys: str, filt: str) -> dict:
    """Canonical continuous-query envelope: the grouping identity.
    ``cq: true`` keeps the key disjoint from plain subscriptions of
    the same filter (they deliver different event streams)."""
    return {"subsys": subsys, "filter": canonical_filter(filt),
            "cq": True}


def group_key(subsys: str, filt: str) -> str:
    return request_key(normalize_cq(subsys, filt))


def parse_standing(subsys: str, filt: str):
    """Validate one standing filter at registration time →
    ``(canonical_filter, tree)``. Raises ``ValueError`` (or the
    criteria ``ParseError`` subclass) on an empty/unparseable filter,
    an unknown subsystem, or criteria targeting a foreign subsystem
    (which would silently match every row — same guard alertdefs
    get)."""
    fieldmaps.check_subsys(subsys)
    tree = criteria.parse(filt)
    if tree is None:
        raise ValueError("a continuous query needs a non-empty filter")
    criteria.check_filter_subsys(tree, subsys, what="continuous query")
    return canonical_filter(filt), tree


def panel_kf(subsys: str):
    """STABLE identity keying for a subsystem's membership rows: the
    delta tier's identity-field preference order restricted to the
    subsystem's field map. Computed from the schema — not per tick
    from observed rows — so hub, replay oracle, and a reconnecting
    client key identically at every tick (including empty panels)."""
    fmap = fieldmaps.field_map(subsys)
    kf = [f for f in D._KEY_FIELDS if f in fmap]    # noqa: SLF001
    return kf or "*"


def row_key(row: dict, kf) -> str:
    return D._key_of(row, kf)                       # noqa: SLF001


# ------------------------------------------------- row-domain predicate
def columns_of_rows(subsys: str, rows: list) -> dict:
    """Rendered JSON rows → the criteria engine's column domain.
    Inverse of the render direction: enum name strings decode to
    ordinals (``fd.from_json``), numeric/bool fields coerce to float64
    vectors, strings stay object arrays. Fields absent from the rows
    are absent from the columns (a criterion on one raises KeyError —
    the caller renders full panels, so this only bites projected
    responses, which continuous queries never are)."""
    cols: dict = {}
    if not rows:
        return cols
    fmap = fieldmaps.field_map(subsys)
    present = rows[0].keys()
    for jname, fd in fmap.items():
        if jname not in present:
            continue
        vals = [r.get(jname) for r in rows]
        if fd.kind == "enum":
            dec = fd.from_json
            out = np.empty(len(vals), np.float64)
            for i, v in enumerate(vals):
                try:
                    out[i] = dec(v)
                except (ValueError, TypeError):
                    out[i] = -1.0
            cols[fd.col] = out
        elif fd.kind in ("num", "bool"):
            out = np.empty(len(vals), np.float64)
            for i, v in enumerate(vals):
                try:
                    out[i] = float(v) if v is not None else 0.0
                except (ValueError, TypeError):
                    out[i] = 0.0
            cols[fd.col] = out
        else:
            cols[fd.col] = np.array(
                ["" if v is None else str(v) for v in vals], object)
    return cols


def match_mask(tree, subsys: str, rows: list,
               cols: Optional[dict] = None) -> np.ndarray:
    """One vectorized predicate pass over rendered rows → bool mask.
    Pass ``cols`` (from :func:`columns_of_rows`) to share the decode
    across the panel's criteria groups."""
    if not rows:
        return np.zeros(0, bool)
    if cols is None:
        cols = columns_of_rows(subsys, rows)
    return criteria.evaluate(tree, cols, subsys)


# ------------------------------------------------ membership lifecycle
class Membership:
    """One criteria group's row membership, carried across ticks.
    ``snaptick`` is the tick membership (or a member's row) last
    CHANGED — quiet ticks advance the stream with heartbeat acks, not
    new versions, so the version ring stores only change points."""

    __slots__ = ("subsys", "filt", "tree", "kf", "members", "snaptick")

    def __init__(self, subsys: str, filt: str, tree, kf=None,
                 members: Optional[dict] = None, snaptick=None):
        self.subsys = subsys
        self.filt = filt
        self.tree = tree
        self.kf = panel_kf(subsys) if kf is None else kf
        self.members: dict = {} if members is None else members
        self.snaptick = snaptick


def panel_diff(prev_map: dict, curr_map: dict):
    """One panel's tick step, shared by every group standing on it:
    ``(changed_keys, changed_rows, removed_keys)`` — rows new or
    byte-different since the last tick, and keys gone from the
    panel."""
    changed_keys, changed_rows = [], []
    for k, r in curr_map.items():
        if prev_map.get(k) != r:
            changed_keys.append(k)
            changed_rows.append(r)
    removed = [k for k in prev_map if k not in curr_map]
    return changed_keys, changed_rows, removed


def _sorted_dict(d: dict) -> dict:
    return {k: d[k] for k in sorted(d)}


def advance(m: Membership, changed_keys, changed_rows, match,
            removed, tick):
    """Advance one group's membership from the panel's changed rows →
    ``(enter, change, leave)`` (key-sorted dicts / key list). Mutates
    ``m.members`` and bumps ``m.snaptick`` to ``tick`` iff anything
    moved. Incremental is exact: an unchanged row keeps its predicate
    verdict (the oracle equivalence ``tests/test_cq.py`` pins)."""
    enter, change, leave = {}, {}, []
    for k, r, hit in zip(changed_keys, changed_rows, match):
        if hit:
            old = m.members.get(k)
            if old is None:
                enter[k] = r
            elif old != r:
                change[k] = r
            m.members[k] = r
        elif k in m.members:
            del m.members[k]
            leave.append(k)
    for k in removed:
        if k in m.members:
            del m.members[k]
            leave.append(k)
    leave.sort()
    enter = _sorted_dict(enter)
    change = _sorted_dict(change)
    if enter or change or leave:
        m.snaptick = tick
    return enter, change, leave


def rebuild(m: Membership, new_members: dict, tick):
    """Full (non-incremental) membership step: diff the freshly
    evaluated match set against the held one — the subscribe-time
    priming / retained-group refresh path, and the replay oracle's
    per-tick step."""
    enter = _sorted_dict({k: r for k, r in new_members.items()
                          if k not in m.members})
    change = _sorted_dict({k: r for k, r in new_members.items()
                           if k in m.members and m.members[k] != r})
    leave = sorted(k for k in m.members if k not in new_members)
    m.members = dict(new_members)
    if enter or change or leave:
        m.snaptick = tick
    return enter, change, leave


def advance_entities(members: set, hits: set):
    """Set-domain lifecycle step (the alert manager's view of the same
    engine): ``(enter, stay, leave)`` entity-key sets. A def FIRES on
    enter (after ``numcheckfor`` consecutive membership ticks — enter
    then stay), and RESOLVES on leave."""
    return hits - members, hits & members, members - hits


# ----------------------------------------------------- event envelope
def cq_response(subsys: str, filt: str, kf, snaptick,
                members: dict) -> dict:
    """The canonical membership response — what ``full`` events carry
    and what applying an event chain rebuilds byte-exactly. Rows sort
    by their membership key: deterministic without carrying an order
    vector (membership is a SET; panels keep ordering semantics)."""
    return {"subsys": subsys, "cqfilter": filt, "kf": kf,
            "snaptick": snaptick, "nrecs": len(members),
            "recs": [members[k] for k in sorted(members)]}


def response_of(m: Membership) -> dict:
    return cq_response(m.subsys, m.filt, m.kf, m.snaptick, m.members)


def members_of_response(resp: dict) -> dict:
    kf = resp.get("kf", "*")
    return {row_key(r, kf): r for r in resp.get("recs") or []}


def events_of(base, tick, kf, enter: dict, change: dict,
              leave: list) -> list:
    """One tick's membership movement → the first-class event chain
    (``leave`` → ``change`` → ``enter``, each kind only when
    non-empty). Bases chain WITHIN the tick: the first event bases on
    the group's previous version, the rest on the tick itself, so
    ``delta.apply_event`` applied in order needs no lookahead."""
    evs = []
    b = base
    if leave:
        evs.append({"t": "leave", "snaptick": tick, "base": b,
                    "kf": kf, "keys": leave})
        b = tick
    if change:
        evs.append({"t": "change", "snaptick": tick, "base": b,
                    "kf": kf, "rows": change})
        b = tick
    if enter:
        evs.append({"t": "enter", "snaptick": tick, "base": b,
                    "kf": kf, "rows": enter})
    return evs
