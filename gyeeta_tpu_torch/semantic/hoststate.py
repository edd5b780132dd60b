"""Host and cluster state rollups.

Counterpart of ``gyeeta_tpu/semantic/hoststate.py``. Host: combines
host cpu/mem issue flags with per-host counts of task/listener issues
into one 6-state label, over the whole host panel, in the reference's
rule order. Cluster: counts of hosts per state plus the issue ratio
(the MS_CLUSTER_STATE payload).
"""

from __future__ import annotations

import torch

from gyeeta_tpu_torch.semantic.states import (
    STATE_IDLE, STATE_GOOD, STATE_OK, STATE_BAD, STATE_SEVERE,
)


def classify_hosts(ntask_issue, ntask_severe, nlisten_issue, nlisten_severe,
                   cpu_issue, mem_issue, severe_cpu, severe_mem,
                   cpu_idle=None):
    """→ (H,) int32 host states. The first matching rule wins."""
    H = ntask_issue.shape
    dev = ntask_issue.device
    if cpu_idle is None:
        cpu_idle = torch.zeros(H, dtype=torch.bool, device=dev)
    any_cpu_mem = cpu_issue | mem_issue
    any_entity = (ntask_issue > 0) | (nlisten_issue > 0)
    lsev = (nlisten_severe > 0) | (ntask_issue > 0)
    rules = (
        # severe everywhere
        (((ntask_severe > 0) | (nlisten_severe > 0))
         & (severe_cpu | severe_mem), STATE_SEVERE),
        # totally clean
        (~any_cpu_mem & ~any_entity & cpu_idle, STATE_IDLE),
        (~any_cpu_mem & ~any_entity, STATE_GOOD),
        # entity issues + host pressure
        (any_entity & any_cpu_mem
         & ((ntask_issue > 5) | (nlisten_issue > 5)), STATE_SEVERE),
        (any_entity & any_cpu_mem, STATE_BAD),
        # host pressure only
        (any_cpu_mem & (severe_cpu | severe_mem), STATE_BAD),
        (any_cpu_mem, STATE_OK),
        # listener issues only
        ((nlisten_issue > 0) & lsev & (nlisten_issue > 5), STATE_SEVERE),
        ((nlisten_issue > 0) & lsev, STATE_BAD),
        (nlisten_issue > 2, STATE_BAD),
        (nlisten_issue > 0, STATE_OK),
        # task issues only
        ((ntask_issue > 0) & ((ntask_severe > 0) | (ntask_issue > 5)),
         STATE_BAD),
        (ntask_issue > 0, STATE_OK),
    )
    state = torch.full(H, STATE_OK, dtype=torch.int32, device=dev)
    decided = torch.zeros(H, dtype=torch.bool, device=dev)
    for cond, st in rules:
        take = cond & ~decided
        state = torch.where(take, st, state)
        decided = decided | take
    return state


def cluster_state(host_states, valid=None):
    """Counts of hosts per state + issue ratio → dict of 0-d tensors."""
    if valid is None:
        valid = torch.ones(host_states.shape, dtype=torch.bool,
                           device=host_states.device)
    counts = [(valid & (host_states == st)).sum().to(torch.int32)
              for st in range(6)]
    n_up = valid.sum().to(torch.int32)
    n_issue = counts[STATE_BAD] + counts[STATE_SEVERE]
    return {
        "nhosts": n_up,
        "nidle": counts[STATE_IDLE],
        "ngood": counts[STATE_GOOD],
        "nok": counts[STATE_OK],
        "nbad": counts[STATE_BAD],
        "nsevere": counts[STATE_SEVERE],
        "ndown": counts[5],
        "issue_frac": n_issue / torch.clamp(n_up, min=1),
    }
