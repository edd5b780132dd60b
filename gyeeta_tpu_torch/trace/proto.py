"""API signature normalization of the request-trace tier.

Counterpart of the normalization half of ``gyeeta_tpu/trace/proto.py``:
the stock-partha adapter (``ingest/refproto.py``) turns each API_TRAN
request string into the signature the GYT agents emit, so traffic
aggregates by shape. The protocol parsers and the detector of that
module are agent-side and are not carried.

- HTTP: ``GET /users/1234/orders?x=1`` → ``GET /users/{}/orders``
  (numeric / UUID / hex / long segments templated, query string dropped);
- SQL: literals and numbers are replaced by placeholders, whitespace
  collapsed, identifier case preserved: ``SELECT * FROM t WHERE id=42``
  → ``SELECT * FROM t WHERE id=$``.
"""

from __future__ import annotations

import re

_NUMSEG = re.compile(
    rb"^(\d+|[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    rb"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}|[0-9a-fA-F]{16,})$")


def normalize_http(method: bytes, path: bytes, max_len: int = 128) -> str:
    """Route template: drop query string, template variable segments."""
    path = path.split(b"?", 1)[0].split(b"#", 1)[0]
    segs = path.split(b"/")
    out = []
    for s in segs:
        out.append(b"{}" if s and _NUMSEG.match(s) else s)
    norm = b"/".join(out) or b"/"
    sig = method.decode("latin1") + " " + norm.decode("latin1")
    return sig[:max_len]


_SQL_STR = re.compile(rb"'(?:[^']|'')*'")
_SQL_NUM = re.compile(rb"\b\d+(?:\.\d+)?\b")
_SQL_WS = re.compile(rb"\s+")


def normalize_sql(sql: bytes, max_len: int = 128) -> str:
    """SQL shape: literals → ``$``, numbers → ``$``, whitespace folded."""
    s = _SQL_STR.sub(b"$", sql)
    s = _SQL_NUM.sub(b"$", s)
    s = _SQL_WS.sub(b" ", s).strip()
    return s.decode("latin1", "replace")[:max_len]
