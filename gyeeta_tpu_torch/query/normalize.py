"""Request normalization: one canonical form for the result-cache key.

Counterpart of ``gyeeta_tpu/query/normalize.py``. Normalization keeps the
meaning of a live query envelope:

- key order never matters (the key is key-sorted canonical JSON);
- ``None`` values drop (absent and null are the same request);
- defaulted fields drop (``maxrecs`` at the :class:`QueryOptions`
  default, ``sortdesc=True``, ``consistency="snapshot"``);
- ``sortdesc`` without a ``sortcol`` drops (it has no effect);
- single-string ``aggr``/``groupby``/``columns`` become lists, and a
  numeric string ``maxrecs`` an int;
- filters canonicalize through the criteria parser (whitespace,
  comparator aliases, numeric spellings); an unparseable filter keeps
  its raw text.
"""

from __future__ import annotations

import json

# QueryOptions defaults (query/api.py) — a request carrying exactly
# these says nothing the bare request doesn't
_DEFAULTS = {"maxrecs": 1000, "sortdesc": True,
             "consistency": "snapshot"}

# envelope fields that make a request uncacheable / non-live — the
# callers gate on these before keying, but normalize() must still
# pass them through untouched so a key is never LOSSY
_PASSTHROUGH = ("at", "window", "tstart", "tend", "op", "multiquery")


def canonical_filter(s: str) -> str:
    """One canonical rendering per equivalence class of filter strings
    (modulo the criteria grammar). Unparseable input returns as-is."""
    from gyeeta_tpu_torch.query import criteria

    try:
        tree = criteria.parse(s)
    except Exception:           # noqa: BLE001 — keyed raw, fails alike
        return s
    return _render_tree(tree)


def _render_val(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)
    esc = str(v).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{esc}'"


def _render_tree(node) -> str:
    from gyeeta_tpu_torch.query.criteria import BoolNode, Criterion

    if isinstance(node, Criterion):
        vals = ",".join(_render_val(v) for v in node.values)
        return f"{{ {node.subsys}.{node.field} {node.op} {vals} }}"
    assert isinstance(node, BoolNode)
    if node.op == "not":
        return f"not {_render_tree(node.children[0])}"
    inner = f" {node.op} ".join(_render_tree(c) for c in node.children)
    return f"( {inner} )"


def normalize_request(req: dict) -> dict:
    """Canonical form of one live-query envelope (see module doc)."""
    out = {}
    for k in sorted(req):
        v = req[k]
        if v is None:
            continue
        if k == "maxrecs":
            try:
                v = int(v)
            except (TypeError, ValueError):
                pass
        elif k == "sortdesc":
            v = bool(v)
        elif k in ("aggr", "groupby", "columns"):
            v = [v] if isinstance(v, str) else list(v)
        elif k == "filter" and isinstance(v, str):
            v = canonical_filter(v)
        if _DEFAULTS.get(k, _SENTINEL) == v:
            continue
        out[k] = v
    if "sortcol" not in out:
        out.pop("sortdesc", None)
    return out


_SENTINEL = object()


def request_key(req: dict) -> str:
    """Normalized request hash key: key-sorted canonical JSON of the
    normalized envelope. Two dashboards asking the same question in a
    different spelling collapse to one render — on EVERY cache tier."""
    return json.dumps(normalize_request(req), sort_keys=True,
                      separators=(",", ":"), default=str)
