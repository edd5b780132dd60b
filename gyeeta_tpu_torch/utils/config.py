"""Runtime options: the process-level knobs the ported runtime reads.

Counterpart of ``RuntimeOpts`` in ``gyeeta_tpu/utils/config.py``, with
the reference's field names and defaults. The fields of tiers the port
does not have yet (``history_db``, ``journal_dir``, ``hist_shard_dir``)
exist so that a configuration naming them is refused by
:func:`check_ported` instead of being ignored.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from gyeeta_tpu_torch import unported


class RuntimeOpts(NamedTuple):
    """Process-level knobs outside engine geometry."""
    checkpoint_dir: Optional[str] = None
    checkpoint_every_ticks: int = 720       # 1 hour of 5s ticks
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
    # tiers not ported yet: setting one raises (check_ported)
    history_db: Optional[str] = None
    journal_dir: Optional[str] = None
    hist_shard_dir: Optional[str] = None


def check_ported(opts: RuntimeOpts) -> RuntimeOpts:
    """Raise :class:`~gyeeta_tpu_torch.unported.NotPortedError` for an
    option of an unported tier."""
    for field in ("history_db", "journal_dir", "hist_shard_dir"):
        if getattr(opts, field) is not None:
            raise unported.refuse(f"RuntimeOpts.{field}", unported.HISTORY)
    return opts
