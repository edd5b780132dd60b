"""Vectorized service health classifier.

Counterpart of ``gyeeta_tpu/semantic/svcstate.py``: the rule structure
of the reference's per-listener state (its own 5s/5min/5day response
percentiles, current QPS and active conns against their learned
percentiles, errors, task delays, host pressure) as one first-match-wins
cascade over (S,) columns. Rules, their order and the reference's
documented deviations are the reference's; see its docstring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gyeeta_tpu_torch.semantic.states import (
    STATE_IDLE, STATE_GOOD, STATE_OK, STATE_BAD, STATE_SEVERE,
    ISSUE_NONE, ISSUE_TASKS, ISSUE_QPS_HIGH, ISSUE_ACTIVE_CONN_HIGH,
    ISSUE_SERVER_ERRORS,
)


class SvcSignals(NamedTuple):
    """Per-service classifier inputs, all (S,) float32/bool tensors.

    Response percentiles are loghist *bucket indices* (resolution-free
    comparisons); qps/active percentiles are plain values."""
    b5: torch.Tensor            # bucket of 5s-window p95 response
    b300: torch.Tensor          # bucket of 5min-window p95
    b5day: torch.Tensor         # bucket of 5day-window p95
    r5p95: torch.Tensor         # raw p95 values (usec)
    r5p99: torch.Tensor
    r5dayp95: torch.Tensor
    r5dayp99: torch.Tensor
    mean5: torch.Tensor         # 5s-window mean response
    mean5day: torch.Tensor
    nqrys_5s: torch.Tensor      # queries in current 5s window
    curr_qps: torch.Tensor
    qps_p95: torch.Tensor       # historical qps percentiles (learned)
    qps_p25: torch.Tensor
    curr_active: torch.Tensor   # current active conns
    active_p95: torch.Tensor
    active_p25: torch.Tensor
    nconn: torch.Tensor         # total conns
    ser_errors: torch.Tensor    # server errors in window
    task_issue: torch.Tensor    # bool — process-level issue (delays/cpu)
    task_severe: torch.Tensor   # bool
    task_delay: torch.Tensor    # bool — delay-type issue
    ntasks_issue: torch.Tensor
    ntasks_noissue: torch.Tensor
    tasks_delay_msec: torch.Tensor
    total_resp_msec: torch.Tensor
    cpu_issue: torch.Tensor     # bool — host cpu issue
    mem_issue: torch.Tensor     # bool
    high_resp_ticks: torch.Tensor  # recent high-response tick count (0..8)
    b_1ms: int = 0              # bucket index of 1 ms (static threshold)


def classify(s: SvcSignals):
    """→ (state, issue): (S,) int32 each. First matching rule wins;
    anything undecided is Bad with no attributed source."""
    rules = []

    def rule(cond, st, isrc):
        rules.append((cond, st, isrc))

    err = s.ser_errors
    nq = s.nqrys_5s
    many_err = err * 2 > nq
    some_err = err * 5 > nq
    has_err = err > 0
    ti = s.task_issue

    # ---- idle gate
    rule((s.curr_qps == 0) & ~(ti & s.task_severe & has_err),
         STATE_IDLE, ISSUE_NONE)

    # ---- branch A: low response
    low = (s.b5 <= s.b_1ms) | (s.r5p95 < s.r5dayp95)
    qps_low = (s.curr_qps <= s.qps_p25) & (s.qps_p25 < s.qps_p95)

    a1 = low & qps_low
    rule(a1 & ~ti & ~has_err, STATE_IDLE, ISSUE_NONE)
    rule(a1 & many_err, STATE_SEVERE, ISSUE_SERVER_ERRORS)
    rule(a1 & some_err, STATE_BAD, ISSUE_SERVER_ERRORS)
    rule(a1 & ~ti & has_err & (err < nq * 0.1), STATE_OK,
         ISSUE_SERVER_ERRORS)
    rule(a1 & ti & has_err, STATE_BAD, ISSUE_TASKS)
    rule(a1 & ti & s.task_severe & (s.ntasks_issue > 0)
         & (s.ntasks_noissue == 0), STATE_BAD, ISSUE_TASKS)
    rule(a1 & ti & (s.nconn > s.active_p25), STATE_OK, ISSUE_TASKS)

    rule(low & many_err, STATE_SEVERE, ISSUE_SERVER_ERRORS)
    rule(low & some_err, STATE_BAD, ISSUE_SERVER_ERRORS)
    rule(low & ti & s.task_severe & (s.ntasks_issue > 0)
         & (s.ntasks_noissue == 0), STATE_BAD, ISSUE_TASKS)
    rule(low & ~has_err & ((s.curr_qps <= s.qps_p95)
                           | (s.b5 + 2 <= s.b5day)), STATE_GOOD, ISSUE_NONE)
    rule(low & ~has_err, STATE_OK, ISSUE_QPS_HIGH)   # qps > p95
    rule(low, STATE_OK, ISSUE_SERVER_ERRORS)

    # ---- branch B: response equals the historical baseline
    same = s.b5 == s.b5day
    rule(same & many_err, STATE_SEVERE, ISSUE_SERVER_ERRORS)
    rule(same & some_err, STATE_BAD, ISSUE_SERVER_ERRORS)

    b2 = same & (s.mean5 <= s.mean5day * 0.8)
    b2_qlow = b2 & (s.curr_qps <= s.qps_p25)
    rule(b2_qlow & has_err, STATE_BAD, ISSUE_SERVER_ERRORS)
    rule(b2_qlow & ~ti, STATE_IDLE, ISSUE_NONE)
    rule(b2_qlow & (s.ntasks_issue > 0) & (s.ntasks_noissue == 0),
         STATE_BAD, ISSUE_TASKS)
    rule(b2_qlow & (s.ntasks_issue > 0) & (s.tasks_delay_msec >= 1000),
         STATE_BAD, ISSUE_TASKS)
    rule(b2 & ~ti & ~has_err, STATE_GOOD, ISSUE_NONE)
    rule(b2 & has_err & ti, STATE_BAD, ISSUE_TASKS)
    rule(b2 & has_err, STATE_OK, ISSUE_SERVER_ERRORS)
    rule(b2, STATE_OK, ISSUE_TASKS)

    rule(same & (s.mean5 <= s.mean5day * 1.2), STATE_OK, ISSUE_NONE)

    # ---- high-response section
    rule(many_err, STATE_SEVERE, ISSUE_SERVER_ERRORS)
    rule(some_err, STATE_BAD, ISSUE_SERVER_ERRORS)

    much_higher = (s.b5 > s.b5day + 2) & (s.b5 > s.b300)
    qps_high = ((s.curr_qps > s.qps_p95)
                & (s.curr_qps - s.qps_p95 > 5)
                & (s.curr_qps > s.qps_p95 * 1.1))
    rule(qps_high & much_higher, STATE_SEVERE, ISSUE_QPS_HIGH)
    rule(qps_high, STATE_BAD, ISSUE_QPS_HIGH)

    task_like = ti | (s.task_delay
                      & (s.ntasks_issue + s.ntasks_noissue > 2)
                      & (s.tasks_delay_msec * 4 > s.total_resp_msec))
    rule(task_like & much_higher, STATE_SEVERE, ISSUE_TASKS)
    rule(task_like, STATE_BAD, ISSUE_TASKS)

    act_high = ((s.curr_active > s.active_p95)
                & (s.curr_active - s.active_p95 > 1))
    rule(act_high & much_higher & (s.curr_active > 10), STATE_SEVERE,
         ISSUE_ACTIVE_CONN_HIGH)
    rule(act_high, STATE_BAD, ISSUE_ACTIVE_CONN_HIGH)

    # outliers only: p95 same but p99 worse → a few slow queries
    rule(same & (s.r5p99 > s.r5dayp99), STATE_OK, ISSUE_NONE)

    # low qps + low conns + bounded degradation
    calm = ((s.curr_qps <= s.qps_p25) & (s.curr_active <= s.active_p25)
            & (s.b5 <= s.b5day + 1))
    rule(calm & s.task_delay & s.cpu_issue & s.mem_issue, STATE_BAD,
         ISSUE_TASKS)
    rule(calm & s.task_delay & (s.cpu_issue | s.mem_issue)
         & (s.tasks_delay_msec * 4 > s.total_resp_msec), STATE_BAD,
         ISSUE_TASKS)
    rule(calm & has_err, STATE_OK, ISSUE_SERVER_ERRORS)
    rule(calm, STATE_OK, ISSUE_NONE)

    # transient: 5s worse but 5min == 5day
    transient = ((s.b5 <= s.b5day + 1) & (s.b300 == s.b5day)
                 & (s.mean5 > s.mean5day) & has_err)
    rule(transient, STATE_OK, ISSUE_SERVER_ERRORS)
    rule((s.b5 <= s.b5day + 1) & (s.b300 == s.b5day)
         & (s.mean5 > s.mean5day), STATE_OK, ISSUE_NONE)

    # not persistent: high resp for < 5 of the last 8 ticks
    rule(s.high_resp_ticks < 5, STATE_OK, ISSUE_NONE)

    # final: genuinely degraded
    rule(much_higher & (s.tasks_delay_msec * 4 > s.total_resp_msec),
         STATE_SEVERE, ISSUE_TASKS)
    rule(much_higher, STATE_SEVERE, ISSUE_NONE)
    rule((s.tasks_delay_msec * 4 > s.total_resp_msec), STATE_BAD,
         ISSUE_TASKS)

    shape, dev = s.b5.shape, s.b5.device
    state = torch.full(shape, STATE_BAD, dtype=torch.int32, device=dev)
    issue = torch.full(shape, ISSUE_NONE, dtype=torch.int32, device=dev)
    decided = torch.zeros(shape, dtype=torch.bool, device=dev)
    for cond, st, isrc in rules:
        take = cond & ~decided
        state = torch.where(take, st, state)
        issue = torch.where(take, isrc, issue)
        decided = decided | take
    return state, issue
