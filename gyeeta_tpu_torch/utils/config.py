"""Layered configuration: defaults ≺ JSON file ≺ env ≺ explicit overrides.

Counterpart of ``gyeeta_tpu/utils/config.py``: ``RuntimeOpts`` with the
reference's field names and defaults, :func:`load_engine_cfg`,
:func:`load_runtime_opts` and the mtime-polled :class:`HotReload` knob
file. The environment is an explicit argument: a loader reads the
``GYT_<FIELD>`` variables of the ``env`` mapping it is given and of
nothing else (``None`` = no environment layer). Only the command-line
boundary (``server_main``) hands ``os.environ`` in.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Mapping, NamedTuple, Optional

from gyeeta_tpu_torch.engine.aggstate import EngineCfg

ENV_PREFIX = "GYT_"

# EngineCfg ints settable by cfg file or env; loghist specs via *_vmin etc.
_INT_FIELDS = {"svc_capacity", "n_hosts", "hll_p_svc", "hll_p_global",
               "cms_depth", "cms_width", "topk_capacity", "td_capacity",
               "conn_batch", "resp_batch",
               "listener_batch", "fold_k", "task_capacity",
               "td_sample_stride", "td_stage_cap", "td_flush_m",
               "topk_budget", "hh_depth", "hh_width"}

# EngineCfg floats settable by cfg file or env
_FLOAT_FIELDS = {"hh_hot_frac"}


class RuntimeOpts(NamedTuple):
    """Process-level knobs outside engine geometry."""
    checkpoint_dir: Optional[str] = None
    checkpoint_every_ticks: int = 720       # 1 hour of 5s ticks
    history_db: Optional[str] = None        # relational history store:
    #                                         a sqlite path, or a
    #                                         postgresql:// URL
    history_every_ticks: int = 12           # history sweep cadence (1 min)
    compact_tomb_frac: float = 0.25         # compact when tombs exceed
    task_age_every_ticks: int = 12          # ageing sweep cadence (1 min)
    task_max_age_ticks: int = 36            # evict groups unseen for 3 min
    api_max_age_ticks: int = 360            # evict idle (svc,api) rows 30m
    debug_level: int = 0                    # hot-reloadable
    resp_sample_pct: float = 100.0          # hot-reloadable duty cycle
    trace_resp_bridge: bool = True          # parsed transactions also feed
    #                                         the per-svc response sketches
    #                                         (hosts with a live native
    #                                         RESP_SAMPLE stream excepted)
    hh_recover_every_ticks: int = 1         # heavy-hitter recovery cadence
    #                                         (0 = on demand only)
    td_drain_iters_per_tick: int = 2        # bounded digest compression
    #                                         per tick
    dep_pair_capacity: int = 65536          # in-flight unpaired halves
    dep_edge_capacity: int = 16384          # dependency edges tracked
    dep_pair_ttl_ticks: int = 24            # unpaired halves expire (2 min)
    dep_edge_ttl_ticks: int = 720           # idle edges expire (1 h)
    # write-ahead event journal (utils/journal.py): bounds data loss to
    # the last group fsync instead of the last checkpoint. None = off.
    journal_dir: Optional[str] = None
    journal_segment_mb: int = 64            # segment rotation size
    journal_fsync_kb: int = 1024            # group-fsync byte cadence
    journal_fsync_ms: float = 50.0          # …or ms cadence (first wins)
    journal_backlog_mb: int = 64            # writer backlog bound: past it
    #                                         the oldest queued chunks
    #                                         drop, counted
    # history tier: the relational writer's queue and the time-travel
    # shards (history/)
    history_queue_max: int = 64             # sweeps queued for the history
    #                                         writer thread; overflow drops
    #                                         the oldest, counted
    hist_shard_dir: Optional[str] = None    # snapshot-shard directory:
    #                                         enables at=/window= queries.
    #                                         None = off
    hist_window_ticks: int = 12             # raw shard window (1m at 5s)
    hist_mid_every: int = 15                # raws per mid shard (15m)
    hist_hour_every: int = 4                # mids per hour shard (1h)
    hist_retain_raw: int = 60               # raw shards kept before
    #                                         downsampling to mid (1h)
    hist_retain_mid: int = 96               # mid shards kept (24h)
    hist_retain_hour: int = 168             # hour shards kept (7d),
    #                                         older drop
    hist_compact_interval_s: float = 30.0   # compaction daemon cadence


def _coerce(key: str, v: Any):
    if key in _INT_FIELDS:
        return int(v)
    if key in _FLOAT_FIELDS:
        return float(v)
    return v


def load_engine_cfg(cfg_file: Optional[str] = None,
                    env: Optional[Mapping] = None,
                    **overrides) -> EngineCfg:
    """defaults ≺ JSON file ≺ ``GYT_<FIELD>`` of ``env`` ≺ kwargs."""
    env = {} if env is None else env
    spec_keys = {f"{n}_{p}" for n in ("resp", "qps", "active", "taskcpu")
                 for p in ("vmin", "vmax", "nbuckets")}
    known = set(EngineCfg._fields) | spec_keys
    vals: dict = {}
    if cfg_file:
        with open(cfg_file) as f:
            data = json.load(f)
        for k, v in data.get("engine", data).items():
            if k in known:
                vals[k] = _coerce(k, v)
    for k in known:
        ev = env.get(ENV_PREFIX + k.upper())
        if ev is not None:
            vals[k] = _coerce(k, ev)
    vals.update({k: _coerce(k, v) for k, v in overrides.items()})
    specs = {}
    for name in ("resp", "qps", "active", "taskcpu"):
        base = getattr(EngineCfg(), f"{name}_spec")
        parts = {}
        for p in ("vmin", "vmax", "nbuckets"):
            key = f"{name}_{p}"
            if key in vals:
                parts[p] = float(vals.pop(key)) if p != "nbuckets" \
                    else int(vals.pop(key))
        if parts:
            specs[f"{name}_spec"] = base._replace(**parts)
    unknown = set(vals) - set(EngineCfg._fields)
    if unknown:
        raise ValueError(f"unknown engine config keys: {sorted(unknown)}")
    return EngineCfg(**{**vals, **specs})


def load_runtime_opts(cfg_file: Optional[str] = None,
                      env: Optional[Mapping] = None,
                      **overrides) -> RuntimeOpts:
    """defaults ≺ the file's ``runtime`` section ≺ ``GYT_<FIELD>`` of
    ``env`` ≺ kwargs."""
    env = {} if env is None else env
    vals: dict = {}
    if cfg_file:
        with open(cfg_file) as f:
            data = json.load(f)
        for k, v in data.get("runtime", {}).items():
            if k in RuntimeOpts._fields:
                vals[k] = v
    for k in RuntimeOpts._fields:
        ev = env.get(ENV_PREFIX + k.upper())
        if ev is not None:
            d = getattr(RuntimeOpts(), k)
            vals[k] = type(d)(ev) if d is not None else ev
    vals.update(overrides)
    unknown = set(vals) - set(RuntimeOpts._fields)
    if unknown:
        raise ValueError(f"unknown runtime config keys: {sorted(unknown)}")
    return RuntimeOpts(**vals)


class HotReload:
    """mtime-polled runtime knob file: ``poll()`` re-reads the file when
    its mtime changed and returns the updated RuntimeOpts (only the
    hot-reloadable fields are applied)."""

    HOT_FIELDS = ("debug_level", "resp_sample_pct")

    def __init__(self, path, opts: RuntimeOpts):
        self.path = pathlib.Path(path)
        self.opts = opts
        self._mtime = 0.0

    def poll(self) -> RuntimeOpts:
        try:
            mtime = self.path.stat().st_mtime
        except FileNotFoundError:
            return self.opts
        if mtime == self._mtime:
            return self.opts
        self._mtime = mtime
        try:
            data = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError):
            return self.opts          # a malformed hot file is ignored
        # knobs live under "runtime" in the daemon config shape; a bare
        # knob file has them at the top level
        src = data.get("runtime", data) if isinstance(data, dict) else {}
        hot = {k: type(getattr(self.opts, k))(v)
               for k, v in src.items()
               if k in self.HOT_FIELDS and
               type(getattr(self.opts, k))(v) != getattr(self.opts, k)}
        if hot:   # unchanged file content keeps the object's identity
            self.opts = self.opts._replace(**hot)
        return self.opts
