"""Batched queries: the reference's ``multiquery`` envelope.

Counterpart of ``multiquery`` in ``gyeeta_tpu/query/crud.py``. The rest
of that module — the CRUD channel over alert definitions, silences,
inhibits, actions, tags and trace definitions — waits for the alert
manager's port (ROADMAP.md, queue 1), and ``"op"`` requests are refused
until then.
"""

from __future__ import annotations


def multiquery(query_fn, req: dict) -> dict:
    """Run a batch of sub-queries through ``query_fn`` (one round trip;
    one bad sub-query does not fail the batch). Sub-queries must be
    plain queries: nesting or CRUD inside a batch is rejected (a
    16-wide batch nested N deep would fan out 16^N executions)."""
    subs = req["multiquery"]
    if not isinstance(subs, list) or len(subs) > 16:
        raise ValueError("multiquery: list of <=16 queries")
    out = []
    for sub in subs:
        if not isinstance(sub, dict) or "multiquery" in sub \
                or sub.get("op"):
            out.append({"error": "sub-query must be a plain query"})
            continue
        try:
            out.append(query_fn(sub))
        except Exception as e:
            out.append({"error": str(e)})
    return {"multiquery": out, "nqueries": len(out)}
