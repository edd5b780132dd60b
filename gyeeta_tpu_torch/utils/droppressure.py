"""Drop-pressure monitoring: turn silent insert/overflow drops into
operator signals (VERDICT r4 #10).

Device tables drop inserts at probe exhaustion (``engine/table.py``
``n_drop``), the dep graph and the a2a pairing tier drop on dispatch
overflow (``parallel/depgraph.py``/``pairing.py`` ``n_dropped``).
Every drop is counted, but a counter an operator must poll is not a
signal — the reference prints pool/capture-stats pressure on cadence
(``common/gy_svc_net_capture.h:191`` print_stats) and raises
notifications for resource pressure. This helper diffs the counters
each tick and emits a notifymsg (warn; error when the growth rate
says the table is badly undersized) + selfstats gauges.

A copy of ``gyeeta_tpu/utils/droppressure.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

# growth per tick above this fraction of capacity = sizing failure
_ERROR_FRAC = 0.01


# sentinel key carried in the returned ``last`` dict: whether the
# previous check saw growth (the enter/exit edge detector)
_ACTIVE = "_pressure_active"


def check(drops: dict, caps: dict, last: dict, notifylog, stats) -> dict:
    """Compare cumulative drop counters against the previous tick.

    ``drops``: {name: cumulative count}; ``caps``: {name: capacity};
    ``last``: previous tick's ``drops`` (mutated copy returned).
    Emits one notifymsg per tick listing every growing counter.

    Counter surface (all visible in ``Stats.delta()`` and /metrics):
    ``dropped_records_<name>`` attributes drops per subsystem per
    cadence; ``drop_pressure_enter``/``drop_pressure_exit`` count the
    pressure-state edges; the ``engine_drop_pressure`` gauge holds the
    current state (1 = drops grew this tick).
    """
    grew = {}
    for name, v in drops.items():
        stats.gauge(f"drops_{name}", v)
        d = v - last.get(name, 0)
        if d > 0:
            grew[name] = d
            stats.bump(f"dropped_records_{name}", int(d))
    was_active = bool(last.get(_ACTIVE))
    if grew:
        severe = any(d >= max(_ERROR_FRAC * caps.get(n, 1 << 30), 1.0)
                     for n, d in grew.items())
        detail = ", ".join(f"{n}+{int(d)} (total {int(drops[n])})"
                           for n, d in sorted(grew.items()))
        notifylog.add(
            f"insert drops growing: {detail} — table under-sized or "
            f"overload; raise capacity or shed load",
            ntype="error" if severe else "warn", source="selfmon")
        stats.bump("drop_pressure_events")
        if not was_active:
            stats.bump("drop_pressure_enter")
    elif was_active:
        stats.bump("drop_pressure_exit")
    stats.gauge("engine_drop_pressure", 1.0 if grew else 0.0)
    out = dict(drops)
    out[_ACTIVE] = bool(grew)
    return out
