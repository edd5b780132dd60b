"""Runtime options: the process-level knobs the ported runtime reads.

Counterpart of ``RuntimeOpts`` in ``gyeeta_tpu/utils/config.py``, with
the reference's field names and defaults (its hot-reload knobs
``debug_level`` and ``resp_sample_pct`` are read by nothing of the
runtime and are not carried).
"""

from __future__ import annotations

from typing import NamedTuple, Optional


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
