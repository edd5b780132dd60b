"""Row-keyed response deltas: push per-tick CHANGES, not re-renders.

A subscribed dashboard (``net/subs.py``) holds the last full response
it was delivered. When ``snaptick`` advances, the pushing tier renders
the query once, diffs the new response against the previous version
row-by-row, and ships only the difference — thousands of dashboards
cost one render + one diff per tick instead of thousands of polls,
and the wire carries rows that CHANGED, not the whole table (the same
"carry the mergeable delta, not the stream" move the ingest edge made
in PR 11).

The contract is **byte-exact reassembly**: applying the event stream
client-side rebuilds a response whose ``json.dumps`` equals the fresh
full render's, byte for byte, at every tick (property-tested in
``tests/test_delta.py``). That forces the format to carry complete
ordering and envelope information:

- ``order``  — the full row-key sequence of the new response (row
  ORDER is part of the response: sort columns move rows every tick);
- ``upsert`` — only the rows that are new or changed, keyed;
- ``env``    — every non-``recs`` envelope field (``nrecs``,
  ``ntotal``, ``snaptick``, …) verbatim;
- ``ekeys``  — the envelope's key order (dict order is part of the
  serialized bytes);
- ``kf``     — the key fields this delta keyed rows by. Identity
  fields are preferred (``svcid``/``hostid``/…: a row that changes
  VALUES still matches its old self, so only its new version ships);
  when a response has no identity fields — or two distinct rows
  collide on them — the delta falls back to whole-row keying
  (``kf="*"``), which is always correct: colliding keys are then
  byte-identical rows, so reassembly cannot pick a wrong one.

Deletes are implicit: a key absent from ``order`` is gone. When the
serialized delta would not beat the full body (churn-heavy ticks), the
pusher sends a ``full`` resync event instead — the ``full=`` escape —
so the wire never pays MORE than polling would.

Events are plain JSON dicts (one ``json.dumps`` away from both the
SSE ``data:`` line and the GYT binary subscription frame):

- ``{"t": "full",  "snaptick": T, "resp": {...}}``
- ``{"t": "delta", "snaptick": T, "base": P, "kf": [...], "order":
  [...], "upsert": {...}, "env": {...}, "ekeys": [...]}``
- ``{"t": "ack",   "snaptick": T}``  (reconnect at the current tick:
  nothing to send yet)

Continuous queries (``query/cq.py``) add three MEMBERSHIP kinds over
the same wire — a standing predicate's match set moving, not a panel
re-ordering. Rows sort by membership key on reassembly (membership is
a set; no ``order`` vector), and the same base-chain rule applies:

- ``{"t": "enter",  "snaptick": T, "base": P, "kf": [...],
  "rows": {key: row, ...}}``   (rows newly matching the predicate)
- ``{"t": "change", "snaptick": T, "base": P, "kf": [...],
  "rows": {key: row, ...}}``   (members whose row bytes changed)
- ``{"t": "leave",  "snaptick": T, "base": P, "kf": [...],
  "keys": [key, ...]}``        (rows that stopped matching / vanished)

A copy of ``gyeeta_tpu/query/delta.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import json
from typing import Optional

# identity-field preference order: stable across ticks, cheap to key.
# Deliberately excludes rank-like fields (a row that moves rank is the
# SAME row) and every value column.
_KEY_FIELDS = ("svcid", "taskid", "cliid", "hostid", "id", "metric",
               "shard", "name", "hostname")


class ResyncRequired(ValueError):
    """A delta arrived whose base version the applier does not hold —
    the subscriber must be resynced with a full event."""


def _dumps(obj) -> str:
    return json.dumps(obj)


def _key_fields_of(rows: list) -> list:
    for r in rows:
        return [f for f in _KEY_FIELDS if f in r]
    return []


def _key_of(row: dict, kf) -> str:
    if kf == "*":
        return json.dumps(row, sort_keys=True, separators=(",", ":"),
                          default=str)
    return json.dumps([row.get(f) for f in kf], separators=(",", ":"),
                      default=str)


def _keyed(rows: list, kf):
    """rows → {key: row}; None on a REAL collision (same key, different
    row). Identical duplicate rows may share a key safely — either copy
    reassembles to the same bytes."""
    out = {}
    for r in rows:
        k = _key_of(r, kf)
        prev = out.get(k)
        if prev is not None and prev != r:
            return None
        out[k] = r
    return out


def full_event(resp: dict) -> dict:
    return {"t": "full", "snaptick": resp.get("snaptick"),
            "resp": resp}


def ack_event(snaptick) -> dict:
    return {"t": "ack", "snaptick": snaptick}


def compute_event(prev: Optional[dict], curr: dict,
                  max_ratio: float = 1.0) -> tuple[dict, int, int]:
    """Diff two full responses → ``(event, event_bytes, full_bytes)``.

    ``prev=None`` (a fresh subscriber) always yields a full event.
    A delta that serializes to ≥ ``max_ratio`` × the full body is
    replaced by a full resync event — the ``full=`` escape."""
    full_bytes = len(_dumps(curr).encode())
    if prev is None:
        ev = full_event(curr)
        return ev, len(_dumps(ev).encode()), full_bytes
    prev_recs = prev.get("recs") or []
    curr_recs = curr.get("recs") or []
    kf = _key_fields_of(curr_recs) or _key_fields_of(prev_recs) or "*"
    prev_map = _keyed(prev_recs, kf)
    curr_map = _keyed(curr_recs, kf)
    if prev_map is None or curr_map is None:
        kf = "*"
        prev_map = _keyed(prev_recs, kf)
        curr_map = _keyed(curr_recs, kf)
    order = [_key_of(r, kf) for r in curr_recs]
    upsert = {k: r for k, r in zip(order, curr_recs)
              if prev_map.get(k) != r}
    ev = {"t": "delta", "snaptick": curr.get("snaptick"),
          "base": prev.get("snaptick"), "kf": kf, "order": order,
          "upsert": upsert,
          "env": {k: v for k, v in curr.items() if k != "recs"},
          "ekeys": list(curr.keys())}
    ev_bytes = len(_dumps(ev).encode())
    if ev_bytes >= max_ratio * full_bytes:
        ev = full_event(curr)
        return ev, len(_dumps(ev).encode()), full_bytes
    return ev, ev_bytes, full_bytes


def apply_event(prev: Optional[dict], event: dict) -> dict:
    """Apply one subscription event client-side → the full response.

    ``full`` replaces wholesale; ``ack`` returns ``prev`` unchanged;
    ``delta`` requires ``prev`` at the delta's ``base`` snaptick —
    anything else raises :class:`ResyncRequired` (the subscriber asks
    again with its last-seen snaptick, or just re-subscribes)."""
    t = event.get("t")
    if t == "full":
        return event["resp"]
    if t == "ack":
        if prev is None:
            raise ResyncRequired("ack with no held version")
        return prev
    if t in ("enter", "change", "leave"):
        return _apply_membership(prev, event)
    if t != "delta":
        raise ValueError(f"unknown subscription event {t!r}")
    if prev is None:
        raise ResyncRequired("delta with no held version")
    if prev.get("snaptick") != event.get("base"):
        raise ResyncRequired(
            f"delta base {event.get('base')} != held "
            f"{prev.get('snaptick')}")
    kf = event["kf"]
    prev_map = _keyed(prev.get("recs") or [], kf) or {}
    upsert = event["upsert"]
    rows = []
    for k in event["order"]:
        r = upsert.get(k, prev_map.get(k))
        if r is None:
            raise ResyncRequired(f"delta references unknown row {k!r}")
        rows.append(r)
    out = {}
    env = event["env"]
    for k in event["ekeys"]:
        out[k] = rows if k == "recs" else env[k]
    return out


def _apply_membership(prev: Optional[dict], event: dict) -> dict:
    """Apply one continuous-query membership event (``enter`` /
    ``change`` / ``leave``) to the held membership response. Same
    base-version contract as ``delta``; reassembled ``recs`` sort by
    membership key and the envelope keeps the held response's key
    order, so chained application stays byte-exact against the hub's
    canonical rendering (``cq.cq_response``)."""
    t = event["t"]
    if prev is None:
        raise ResyncRequired(f"{t} with no held version")
    if prev.get("snaptick") != event.get("base"):
        raise ResyncRequired(
            f"{t} base {event.get('base')} != held "
            f"{prev.get('snaptick')}")
    kf = event.get("kf", prev.get("kf", "*"))
    members = _keyed(prev.get("recs") or [], kf)
    if members is None:
        raise ResyncRequired("held membership rows collide on key")
    if t == "leave":
        for k in event["keys"]:
            if k not in members:
                raise ResyncRequired(f"leave of unknown member {k!r}")
            del members[k]
    else:
        for k, r in event["rows"].items():
            if t == "change" and k not in members:
                raise ResyncRequired(f"change of unknown member {k!r}")
            members[k] = r
    recs = [members[k] for k in sorted(members)]
    out = {}
    for k, v in prev.items():
        if k == "recs":
            out[k] = recs
        elif k == "snaptick":
            out[k] = event.get("snaptick")
        elif k == "nrecs":
            out[k] = len(recs)
        else:
            out[k] = v
    return out
