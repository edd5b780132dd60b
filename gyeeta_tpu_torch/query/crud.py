"""The CRUD channel and batched queries.

Counterpart of ``gyeeta_tpu/query/crud.py``: :func:`crud` serves
``{"op": "add"|"delete", "objtype": ...}`` requests over alert
definitions, silences, inhibits, actions, tags and trace definitions;
:func:`multiquery` runs the ``multiquery`` envelope.
"""

from __future__ import annotations

CRUD_OBJS = ("alertdef", "silence", "inhibit", "tracedef",
             "action", "tag")


def crud(rt, req: dict) -> dict:
    """``rt`` provides .alerts, .tags, .tracedefs, .notifylog."""
    op = req.get("op")
    objtype = req.get("objtype")
    if objtype not in CRUD_OBJS:
        raise ValueError(f"objtype must be one of {CRUD_OBJS}")
    if op == "add":
        if objtype == "alertdef":
            rt.alerts.add_def(req)
            name = req["alertname"]
        elif objtype == "silence":
            name = rt.alerts.add_silence(req).name
        elif objtype == "inhibit":
            name = rt.alerts.add_inhibit(req).name
        elif objtype == "action":
            name = rt.alerts.add_action(req).name
        elif objtype == "tag":
            rt.tags.set(req["taskid"], req.get("tag", ""))
            name = req["taskid"]
        else:
            name = rt.tracedefs.add(req).name
        rt.notifylog.add(f"{objtype} {name!r} added", source="config")
        return {"ok": True, "objtype": objtype, "name": name}
    if op == "delete":
        name = req.get("name") or req.get("alertname") \
            or req.get("taskid")
        if not name:
            raise ValueError("delete needs a name")
        if objtype == "alertdef":
            found = rt.alerts.delete_def(name)
        elif objtype == "silence":
            found = rt.alerts.silences.pop(name, None) is not None
        elif objtype == "inhibit":
            found = rt.alerts.inhibits.pop(name, None) is not None
        elif objtype == "action":
            found = rt.alerts.delete_action(name)
        elif objtype == "tag":
            found = rt.tags.delete(req.get("taskid") or name)
        else:
            found = rt.tracedefs.delete(name)
        if found:
            rt.notifylog.add(f"{objtype} {name!r} deleted",
                             source="config")
        return {"ok": found, "objtype": objtype, "name": name}
    raise ValueError("op must be add or delete")


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
