"""Self-observability tier of the port: exposition, device health, span
tracing, and the ``obs top`` frame.

``obs/prom.py`` renders the Prometheus text format (``GET /metrics`` and
the ``metrics`` subsystem), ``obs/health.py`` reads the engine's device
health back once a report, ``obs/spans.py`` traces the feed pipeline,
and :func:`format_top` renders one frame of ``python -m gyeeta_tpu_torch
obs top`` from a ``selfstats`` payload.

Counterpart of ``gyeeta_tpu/obs/__init__.py``. This package module
imports nothing: ``obs top`` runs on a client host without ``torch``.
"""

from __future__ import annotations


def format_top(selfstats: dict, prev_counters: dict | None = None,
               interval_s: float = 0.0, width: int = 78) -> str:
    """Render one ``obs top`` frame from a ``selfstats`` payload.

    ``prev_counters`` + ``interval_s`` turn cumulative counters into
    rates (the ``Stats.delta()`` view, computed client-side so the
    monitor never mutates server state)."""
    c = selfstats.get("counters", {})
    lines = []
    up = c.get("uptime_sec", 0)
    lines.append(f"gyt self-monitor — uptime {up}s")

    eng = {k: v for k, v in sorted(c.items())
           if str(k).startswith("engine_")}
    if eng:
        lines.append("")
        lines.append("engine health:")
        for k, v in eng.items():
            lines.append(f"  {k:<36} {v}")

    # durable-ingest surface: WAL fsync lag (the RPO bound), unsynced
    # bytes, segment footprint, replay/torn-tail counters, and the
    # admission-control state — the disk half of the health picture
    dur = {k: v for k, v in sorted(c.items())
           if str(k).startswith(("journal_", "wal_", "throttle"))}
    if dur:
        lines.append("")
        lines.append("durability / backpressure:")
        for k, v in dur.items():
            lines.append(f"  {k:<36} {v}")

    # query-serving surface: snapshot freshness, result-cache hit
    # rate, executor depth and shed counts (the 1k+ QPS dashboard
    # health picture — OPERATIONS.md "Query serving")
    qry = {k: v for k, v in sorted(c.items())
           if str(k).startswith(("query_", "queries", "snapshot"))}
    if qry:
        lines.append("")
        lines.append("query serving:")
        hits = c.get("query_cache_hits", 0)
        misses = c.get("query_cache_misses", 0)
        if hits or misses:
            qry["cache_hit_rate"] = round(hits / (hits + misses), 4)
        for k, v in qry.items():
            lines.append(f"  {k:<36} {v}")

    # query-fabric surface (gateway tier, net/gateway.py): edge-cache
    # hit tiers, fleet-wide single-render collapse, subscription fan
    # and the delta-vs-full wire ratio (OPERATIONS.md "Query fabric")
    gwm = {k: v for k, v in sorted(c.items())
           if str(k).startswith("gw_")}
    if gwm:
        lines.append("")
        lines.append("query fabric:")
        db, fb = c.get("gw_delta_bytes", 0), c.get("gw_full_bytes", 0)
        if fb:
            gwm["delta_vs_full_byte_ratio"] = round(db / fb, 4)
        # fault-domain derived rows (OPERATIONS.md "Failure domains &
        # degradation"): a hedge WIN rate near 1 means one replica is
        # consistently slow; resumes-vs-resyncs is the continuation
        # hit rate of the retained/persisted version rings
        hreq = c.get("gw_hedged_requests", 0)
        if hreq:
            gwm["hedge_win_rate"] = round(
                c.get("gw_hedged_wins", 0) / hreq, 4)
        resumes = c.get("gw_sub_resumes", 0)
        resyncs = c.get("gw_sub_resyncs", 0)
        if resumes or resyncs:
            gwm["sub_continuation_rate"] = round(
                resumes / (resumes + resyncs), 4)
        for k, v in gwm.items():
            lines.append(f"  {k:<36} {v}")

    # remote ingest relay surface (net/relay.py): per-relay published /
    # consumed / counted-dropped ledgers plus epoch and reconnect churn
    # (OPERATIONS.md "Regions & WAN deployment"). ledger_open is the
    # global invariant published − consumed − dropped summed over all
    # relays: a persistently nonzero value means records vanished
    # UNCOUNTED between the remote host and the hub — page on it.
    rly = {k: v for k, v in sorted(c.items())
           if str(k).startswith("relay_")}
    if rly:
        lines.append("")
        lines.append("remote ingest relay:")

        def _rsum(pfx: str) -> float:
            return sum(v for k, v in rly.items()
                       if str(k).startswith(pfx)
                       and isinstance(v, (int, float)))

        rly["ledger_open"] = round(
            _rsum("relay_published_records")
            - _rsum("relay_consumed_records")
            - _rsum("relay_dropped_records"), 4)
        for k, v in rly.items():
            lines.append(f"  {k:<36} {v}")

    # segment-shipping surface (history/shipper.py + net/segship.py):
    # sealed / shipped / counted-dropped SEGMENT ledgers per shipper
    # plus hash mismatches, staging sheds and heartbeat age
    # (OPERATIONS.md "Remote compaction region"). ship_open is the
    # global invariant sealed − shipped − dropped: persistently
    # nonzero and growing means sealed segments are NOT reaching the
    # compaction region — check the uplink before the source's disk
    # fills against the pinned ship floor.
    shp = {k: v for k, v in sorted(c.items())
           if str(k).startswith("ship_")}
    if shp:
        lines.append("")
        lines.append("segment shipping:")

        def _ssum(pfx: str) -> float:
            return sum(v for k, v in shp.items()
                       if str(k).startswith(pfx)
                       and isinstance(v, (int, float)))

        shp["ship_open"] = round(
            _ssum("ship_sealed_segments")
            - _ssum("ship_shipped_segments")
            - _ssum("ship_dropped_segments"), 4)
        for k, v in shp.items():
            lines.append(f"  {k:<36} {v}")

    # history tier (compactor + windowed quantiles, OPERATIONS.md
    # "Distributed compaction & windowed quantiles")
    hist = {k: v for k, v in sorted(c.items())
            if str(k).startswith(("compact_", "wd_",
                                  "windowed_quant"))}
    if hist:
        lines.append("")
        lines.append("history compaction:")
        for k, v in hist.items():
            lines.append(f"  {k:<36} {v}")

    plain = {k: v for k, v in sorted(c.items())
             if not str(k).startswith(("engine_", "journal_", "wal_",
                                       "throttle", "query_", "queries",
                                       "snapshot", "gw_", "relay_",
                                       "ship_", "compact_", "wd_",
                                       "windowed_quant"))
             and isinstance(v, (int, float))}
    lines.append("")
    hdr = f"  {'counter':<36} {'total':>12}"
    if prev_counters is not None and interval_s > 0:
        hdr += f" {'rate/s':>12}"
    lines.append("counters:")
    lines.append(hdr)
    for k, v in plain.items():
        if k == "uptime_sec":
            continue
        row = f"  {k:<36} {v:>12}"
        if prev_counters is not None and interval_s > 0:
            d = (v - prev_counters.get(k, 0)) / interval_s
            row += f" {d:>12.1f}"
        lines.append(row)

    timings = selfstats.get("timings") or []
    if timings:
        lines.append("")
        lines.append("stage timings:")
        lines.append(f"  {'stage':<20} {'count':>9} {'p50ms':>9} "
                     f"{'p95ms':>9} {'p99ms':>9} {'totalms':>11}")
        for r in timings:
            lines.append(
                f"  {r['stage']:<20} {r['count']:>9} {r['p50ms']:>9} "
                f"{r['p95ms']:>9} {r['p99ms']:>9} {r['totalms']:>11}")

    spans = selfstats.get("spans") or []
    if spans:
        lines.append("")
        lines.append("recent spans (newest first):")
        lines.append(f"  {'stage':<16} {'wallms':>9} {'nrec':>9} path")
        for s in spans[:16]:
            lines.append(f"  {s['name']:<16} {s['wallms']:>9} "
                         f"{s['nrec']:>9} {s.get('path', '')}")

    return "\n".join(ln[:width] for ln in lines) + "\n"
