"""Host CPU/memory issue classification for the 2s path.

Counterpart of ``gyeeta_tpu/semantic/cpumem.py``: every 2s sweep, raw
host gauges are judged against saturation thresholds and each host gets
a (state, issue-source) pair per dimension, in one branch-free pass over
the fleet, rules ordered most-severe-first (first hit wins the issue
source).
"""

from __future__ import annotations

import torch

from gyeeta_tpu_torch.ingest import decode as D
from gyeeta_tpu_torch.semantic import states as S


def _cascade(rules, state, none_issue: int):
    """Apply ``(cond, state, issue)`` rules in order: a rule takes the
    rows no earlier rule gave an issue source."""
    issue = torch.full_like(state, none_issue)
    for cond, st, isrc in rules:
        hit = cond & (issue == none_issue)
        state = torch.where(hit, st, state)
        issue = torch.where(hit, isrc, issue)
    return state, issue


def classify_cpu(vals):
    """(H, NCM) gauges → (state, issue) int32 per host (CPU dimension)."""
    cpu = vals[:, D.CM_CPU_PCT]
    core = vals[:, D.CM_MAX_CORE_CPU_PCT]
    iow = vals[:, D.CM_IOWAIT_PCT]
    cs = vals[:, D.CM_CS_SEC]
    forks = vals[:, D.CM_FORKS_SEC]
    runq = vals[:, D.CM_PROCS_RUNNING]
    ncpu = torch.clamp(vals[:, D.CM_NCPUS], min=1.0)

    state = torch.full(cpu.shape, S.STATE_GOOD, dtype=torch.int32,
                       device=vals.device)
    state = torch.where(cpu < 10.0, S.STATE_IDLE, state)
    state = torch.where(cpu >= 70.0, S.STATE_OK, state)
    return _cascade((
        (cpu >= 98.0, S.STATE_SEVERE, S.CISSUE_CPU_SATURATED),
        (iow >= 50.0, S.STATE_SEVERE, S.CISSUE_IOWAIT),
        (cpu >= 90.0, S.STATE_BAD, S.CISSUE_CPU_SATURATED),
        (iow >= 25.0, S.STATE_BAD, S.CISSUE_IOWAIT),
        (core >= 95.0, S.STATE_BAD, S.CISSUE_CORE_SATURATED),
        (cs >= 100_000.0 * ncpu, S.STATE_BAD, S.CISSUE_CONTEXT_SWITCH),
        (forks >= 300.0, S.STATE_BAD, S.CISSUE_FORKS),
        (runq >= 4.0 * ncpu, S.STATE_BAD, S.CISSUE_PROCS_RUNNING),
    ), state, S.CISSUE_NONE)


def classify_mem(vals):
    """(H, NCM) gauges → (state, issue) int32 per host (memory)."""
    rss = vals[:, D.CM_RSS_PCT]
    commit = vals[:, D.CM_COMMIT_PCT]
    swap_free = vals[:, D.CM_SWAP_FREE_PCT]
    pgio = vals[:, D.CM_PG_INOUT_SEC]
    swapio = vals[:, D.CM_SWAP_INOUT_SEC]
    stalls = vals[:, D.CM_ALLOCSTALL_SEC]
    oom = vals[:, D.CM_OOM_KILLS]

    state = torch.full(rss.shape, S.STATE_GOOD, dtype=torch.int32,
                       device=vals.device)
    state = torch.where(rss >= 75.0, S.STATE_OK, state)
    return _cascade((
        (oom > 0, S.STATE_SEVERE, S.MISSUE_OOM_KILL),
        ((swap_free <= 5.0) & (swapio > 0), S.STATE_SEVERE,
         S.MISSUE_SWAP_FULL),
        (stalls >= 50.0, S.STATE_SEVERE, S.MISSUE_RECLAIM_STALLS),
        (commit >= 95.0, S.STATE_BAD, S.MISSUE_COMMIT),
        (rss >= 90.0, S.STATE_BAD, S.MISSUE_RSS),
        (swapio >= 100.0, S.STATE_BAD, S.MISSUE_SWAP_IO),
        (pgio >= 10_000.0, S.STATE_BAD, S.MISSUE_PAGE_IO),
    ), state, S.MISSUE_NONE)
