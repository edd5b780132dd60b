"""Engine health gauges: one batched device readback → named gauges.

Counterpart of ``gyeeta_tpu/obs/health.py``: ``engine/step.py``'s
``engine_health_vec`` packs the device-health surface into one small
f32 vector (read back once per tick); this module turns it into the
operator-facing gauge dict — occupancy against the configured
capacities, probe failures, evictions, dependency-graph fill. Occupancy
counts live + tombstoned rows: a tombstone occupies probe positions
until compaction.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.engine.step import HEALTH_KEYS


def capacities(cfg, opts, n_shards: int = 1) -> dict:
    """Total capacities backing the occupancy ratios."""
    return {
        "svc": cfg.svc_capacity * n_shards,
        "task": cfg.task_capacity * n_shards,
        "api": cfg.api_capacity * n_shards,
        "td_stage": cfg.td_stage_cap,      # per-entity; max, not summed
        "dep_pair": opts.dep_pair_capacity * n_shards,
        "dep_edge": opts.dep_edge_capacity * n_shards,
        "hh": cfg.hh_depth * max(cfg.hh_width, 1) * n_shards,
    }


def gauges_from_vec(vec, caps: dict) -> dict:
    """HEALTH_KEYS-ordered vector → {gauge_name: float} (ratios rounded
    to 4 places)."""
    h = dict(zip(HEALTH_KEYS, np.asarray(vec, np.float64).tolist()))
    occ = lambda live, tomb, cap: round(  # noqa: E731
        (live + tomb) / max(cap, 1), 4)
    return {
        "engine_svc_rows_live": h["svc_live"],
        "engine_svc_occupancy_ratio": occ(h["svc_live"], h["svc_tomb"],
                                          caps["svc"]),
        "engine_svc_tombstones": h["svc_tomb"],
        "engine_svc_probe_failures": h["svc_drop"],
        "engine_task_rows_live": h["task_live"],
        "engine_task_occupancy_ratio": occ(h["task_live"],
                                           h["task_tomb"], caps["task"]),
        "engine_task_tombstones": h["task_tomb"],
        "engine_task_probe_failures": h["task_drop"],
        "engine_api_rows_live": h["api_live"],
        "engine_api_occupancy_ratio": occ(h["api_live"], h["api_tomb"],
                                          caps["api"]),
        "engine_api_tombstones": h["api_tomb"],
        "engine_api_probe_failures": h["api_drop"],
        "engine_td_stage_pressure_ratio": round(
            h["td_stage_max"] / max(caps["td_stage"], 1), 4),
        "engine_conn_folded": h["n_conn"],
        "engine_resp_folded": h["n_resp"],
        "engine_resp_unknown_svc": h["n_resp_unknown"],
        "engine_td_overflow": h["n_td_overflow"],
        "engine_dep_pair_fill_ratio": round(
            h["dep_half_live"] / max(caps["dep_pair"], 1), 4),
        "engine_dep_edge_fill_ratio": round(
            h["dep_edge_live"] / max(caps["dep_edge"], 1), 4),
        "engine_dep_probe_failures": h["dep_edge_drop"],
        "engine_dep_paired": h["dep_paired"],
        "engine_dep_expired": h["dep_expired"],
        "engine_dep_dropped": h["dep_dropped"],
        "topk_evicted_mass": h["topk_evicted"],
        "engine_hh_occupancy_ratio": round(
            h["hh_occupied"] / max(caps["hh"], 1), 4),
        "engine_hh_hot_lanes": h["hh_hot_lanes"],
    }


def drops_for_pressure(gauges: dict) -> dict:
    """The cumulative drop counters ``utils/droppressure.check``
    watches, pulled from the health gauges (no extra readback)."""
    return {"svc": int(gauges["engine_svc_probe_failures"]),
            "task": int(gauges["engine_task_probe_failures"]),
            "api": int(gauges["engine_api_probe_failures"]),
            "dep": int(gauges["engine_dep_dropped"])}
