"""Real process collection: /proc walk → AGGR_TASK_STATE records.

The userspace analogue of the reference's task handler: it watches
fork/exec/exit via the proc connector and aggregates tasks into
process groups keyed by a comm+cgroup hash
(``common/gy_task_handler.cc:2568``, aggr id construction
``gy_task_handler.h:180``). Without netlink-connector privileges the
same information is recovered by sweeping ``/proc/[pid]`` on the 5s
cadence:

- **grouping**: pids aggregate by ``comm`` into the same stable
  ``aggr_task_id`` the TCP collector stamps on outbound conns
  (:func:`gyeeta_tpu_torch.net.tcpconn.aggr_task_id_of`), so conn→task joins
  line up without coordination.
- **cpu%**: delta of utime+stime across sweeps over wall time.
- **delays**: ``/proc/[pid]/schedstat`` field 2 is time spent waiting
  on the runqueue — the userspace stand-in for taskstats
  ``cpu_delay_total``; ``delayacct_blkio_ticks`` (stat field 42) gives
  block-IO delay when delayacct is on.
- **forks**: pids whose ``starttime`` postdates the previous sweep
  count as forks in their group (plus exits inferred by
  disappearance) — the TOPFORK signal.

Everything is delta-based and privilege-graceful: unreadable pids
(other users' /proc under hidepid, racing exits) are skipped, never
raised.

Counterpart of ``gyeeta_tpu/net/taskproc.py``: numpy and the standard
library, no device; group ids are the port's ``aggr_task_id_of``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.net.tcpconn import aggr_task_id_of
from gyeeta_tpu_torch.utils.intern import InternTable

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE_MB = (os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf")
            else 4096) / (1 << 20)


def _read_pid(pid: str):
    """One process sample: (comm, cpu_ticks, rss_mb, starttime_ticks,
    blkio_ticks, runq_wait_ns) or None on any error (racing exit)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # comm may contain spaces/parens: split around the LAST ')'
        lp = data.rindex(b")")
        comm = data[data.index(b"(") + 1: lp].decode(
            "utf-8", "replace")[:16]
        rest = data[lp + 2:].split()
        utime, stime = int(rest[11]), int(rest[12])
        starttime = int(rest[19])
        rss_pages = int(rest[21])
        blkio = int(rest[39]) if len(rest) > 39 else 0
        runq = 0
        try:
            with open(f"/proc/{pid}/schedstat", "rb") as f:
                parts = f.read().split()
            if len(parts) >= 2:
                runq = int(parts[1])
        except (OSError, ValueError):
            pass
        return (comm, utime + stime, rss_pages * _PAGE_MB, starttime,
                blkio, runq)
    except (OSError, ValueError, IndexError):
        return None


class ProcTaskCollector:
    """5s-cadence /proc sweep → per-process-group wire records.

    ``sweep(task_net=None, listener_of_comm=None)`` →
    (AGGR_TASK_DT records, NAME_INTERN records). ``task_net`` is the
    TCP collector's per-group {aggr_id: [kbytes, nconns]} traffic map;
    ``listener_of_comm`` maps a comm to its listener glob_id so
    serving groups carry ``related_listen_id`` (the task↔svc join the
    reference maintains via its listener↔task tables).
    """

    def __init__(self, host_id: int = 0, machine_id: int = 1,
                 max_groups: int = wire.MAX_TASKS_PER_BATCH,
                 netlink_delays: bool = True):
        self.host_id = host_id
        self.machine_id = machine_id
        self.max_groups = max_groups
        self._prev_pids: dict = {}     # pid -> starttime (fork detect)
        self._prev_group: dict = {}    # comm -> [cpu_ticks, blkio, runq]
        self._prev_vm: dict = {}       # comm -> vm_delay_ns total
        self._prev_t = 0.0
        self._announced: set = set()   # comm ids already name-announced
        # netlink TASKSTATS: swap-in + reclaim + thrashing delays, the
        # classes schedstat cannot see (ref gy_acct_taskstat.h:209).
        # Privilege-gated: None when CAP_NET_ADMIN/kernel support is
        # absent — vm_delay_msec then stays 0 (documented degradation)
        self._td = None
        if netlink_delays:
            from gyeeta_tpu_torch.net import taskdelays
            if taskdelays.available():
                self._td = taskdelays.TaskDelayReader()
        # cn_proc connector: EVENT-accurate fork counting (ref consumes
        # the proc-connector stream, gy_misc.h:1181) — replaces the
        # starttime/appearance inference when the multicast join is
        # permitted; same degradation discipline as the delays
        self._pc = None
        if netlink_delays:
            from gyeeta_tpu_torch.net import procconn
            if procconn.available():
                try:
                    self._pc = procconn.ProcConnector()
                except OSError:
                    self._pc = None

    def sweep(self, task_net=None, listener_of_comm=None
              ) -> tuple[np.ndarray, np.ndarray]:
        now = time.monotonic()
        dt = max(now - self._prev_t, 1e-3) if self._prev_t else 0.0
        first = self._prev_t == 0.0
        self._prev_t = now
        task_net = task_net or {}
        listener_of_comm = listener_of_comm or {}

        try:
            pids = [d for d in os.listdir("/proc") if d.isdigit()]
        except OSError:
            return (np.empty(0, wire.AGGR_TASK_DT),
                    np.empty(0, wire.NAME_INTERN_DT))

        groups: dict = {}   # comm -> [cpu, rss, n, forks, blkio, runq]
        vm_now: dict = {}   # comm -> swap+reclaim+thrash delay ns total
        cur_pids: dict = {}
        comm_of_pid: dict = {}
        for pid in pids:
            s = _read_pid(pid)
            if s is None:
                continue
            comm, cpu, rss, starttime, blkio, runq = s
            cur_pids[pid] = starttime
            comm_of_pid[int(pid)] = comm
            g = groups.setdefault(comm, [0, 0.0, 0, 0, 0, 0])
            g[0] += cpu
            g[1] += rss
            g[2] += 1
            prev_start = self._prev_pids.get(pid)
            if not first and (prev_start is None
                              or prev_start != starttime):
                g[3] += 1              # new pid (or pid reuse) = a fork
            g[4] += blkio
            g[5] += runq
            if self._td is not None:
                d = self._td.get(int(pid))
                if d is not None:
                    vm_now[comm] = (vm_now.get(comm, 0)
                                    + d["swapin_delay_ns"]
                                    + d["freepages_delay_ns"]
                                    + d["thrashing_delay_ns"])
        self._prev_pids = cur_pids

        if self._pc is not None:
            # event-accurate forks override the starttime inference:
            # count FORK events by the parent's comm group (parent
            # resolved from this sweep's /proc read; a parent that
            # already exited falls through silently)
            from gyeeta_tpu_torch.net.procconn import PROC_EVENT_FORK
            ev_forks: dict = {}
            for e in self._pc.poll():
                # new PROCESSES only: a thread clone also emits FORK
                # but with child_pid != child_tgid — counting those
                # would inflate thread-pool-heavy comms
                if e.what == PROC_EVENT_FORK \
                        and e.child_pid == e.child_tgid:
                    comm = comm_of_pid.get(e.tgid)
                    if comm is not None:
                        ev_forks[comm] = ev_forks.get(comm, 0) + 1
            for comm, nf in ev_forks.items():
                if comm in groups:
                    groups[comm][3] = nf

        # truncation: primary order is group size (the taskstate /
        # topcpu signal), with a BOUNDED reserve of slots for the top
        # fork-churners a by-size sort would drop (single-pid
        # respawners, the TOPFORK signal) — neither signal can evict
        # the other wholesale
        comms = sorted(groups, key=lambda c: -groups[c][2])
        if len(comms) > self.max_groups:
            nres = max(self.max_groups // 8, 1)
            base = comms[: self.max_groups - nres]
            kept = set(base)
            forkers = [c for c in sorted(
                groups, key=lambda c: -groups[c][3])
                if groups[c][3] > 0 and c not in kept][:nres]
            # unused reserve slots go back to the by-size order
            fill = [c for c in comms[len(base):]
                    if c not in forkers][: nres - len(forkers)]
            comms = base + forkers + fill
        # baselines advance for EVERY group each sweep — a group capped
        # out of the report must not accumulate multi-sweep deltas that
        # later get divided by a single dt
        prev_of = {c: self._prev_group.get(
            c, [groups[c][0], groups[c][4], groups[c][5]])
            for c in comms}
        self._prev_group = {c: [g[0], g[4], g[5]]
                            for c, g in groups.items()}
        prev_vm_of, self._prev_vm = self._prev_vm, dict(vm_now)
        out = np.zeros(len(comms), wire.AGGR_TASK_DT)
        names = []
        from gyeeta_tpu_torch.semantic import states as S
        for i, comm in enumerate(comms):
            cpu, rss, n, forks, blkio, runq = groups[comm]
            pg = prev_of[comm]
            aggr_id = aggr_task_id_of(self.machine_id, comm)
            comm_id = InternTable.intern(comm, wire.NAME_KIND_COMM)
            if comm_id not in self._announced:
                self._announced.add(comm_id)
                names.append((wire.NAME_KIND_COMM, comm_id, comm))
            r = out[i]
            r["aggr_task_id"] = aggr_id
            r["comm_id"] = comm_id
            r["related_listen_id"] = listener_of_comm.get(comm, 0)
            net = task_net.get(aggr_id)
            if net:
                r["tcp_kbytes"] = min(int(net[0]), 2**32 - 1)
                r["tcp_conns"] = min(int(net[1]), 2**32 - 1)
            if dt:
                r["total_cpu_pct"] = 100.0 * max(cpu - pg[0], 0) \
                    / _CLK_TCK / dt
                # delays accumulated THIS sweep (ns / ticks → msec)
                r["cpu_delay_msec"] = min(
                    max(runq - pg[2], 0) / 1e6, 2**31)
                r["blkio_delay_msec"] = min(
                    max(blkio - pg[1], 0) * 1000.0 / _CLK_TCK, 2**31)
                if comm in vm_now:
                    pv = prev_vm_of.get(comm, vm_now[comm])
                    r["vm_delay_msec"] = min(
                        max(vm_now[comm] - pv, 0) / 1e6, 2**31)
                r["forks_sec"] = forks / dt
            r["rss_mb"] = min(int(rss), 2**32 - 1)
            r["ntasks_total"] = min(n, 2**16 - 1)
            cpu_d = float(r["cpu_delay_msec"])
            io_d = float(r["blkio_delay_msec"])
            issue = cpu_d > 500 or io_d > 300
            r["ntasks_issue"] = min(n, 2**16 - 1) if issue else 0
            r["curr_state"] = (
                S.STATE_SEVERE if cpu_d > 1200 else
                S.STATE_BAD if issue else
                S.STATE_OK if float(r["total_cpu_pct"]) > 1.0
                else S.STATE_IDLE)
            r["curr_issue"] = (
                S.TISSUE_CPU_DELAY if cpu_d > 500 else
                S.TISSUE_BLKIO_DELAY if io_d > 300 else S.TISSUE_NONE)
            r["host_id"] = self.host_id
        return out, (InternTable.records(names) if names
                     else np.empty(0, wire.NAME_INTERN_DT))

    def close(self) -> None:
        if self._td is not None:
            self._td.close()
            self._td = None
        if self._pc is not None:
            self._pc.close()
            self._pc = None
