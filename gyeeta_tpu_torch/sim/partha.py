"""Deterministic multi-agent event generator: the streams of ``fold_all``.

Counterpart of ``gyeeta_tpu/sim/partha.py`` for the TCP_CONN and
RESP_SAMPLE streams (flows, service→service flows, split halves), the
5s LISTENER_STATE / AGGR_TASK_STATE / HOST_STATE sweeps, the 2s
CPU_MEM_STATE sweep, REQ_TRACE transactions, the NAME_INTERN
announcements of every name the fleet uses, the LISTENER_INFO,
HOST_INFO and CGROUP_STATE inventories, rotating churn traffic, and the
edge pre-aggregated form of a conn/resp sweep
(:meth:`ParthaSim.delta_frames`). It draws from
``np.random.default_rng(seed)`` in the reference's order, so the same
seed and the same sequence of calls give byte-identical records in both
packages.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.semantic import states as S
from gyeeta_tpu_torch.trace.proto import PROTO_HTTP1, PROTO_POSTGRES
from gyeeta_tpu_torch.utils import hashing as H

# salt of interned comm names (the reference's wire.NAME_KIND_COMM)
_NAME_KIND_COMM = 1


class ParthaSim:
    def __init__(self, n_hosts: int = 64, n_svcs: int = 16,
                 n_clients: int = 4096, seed: int = 42,
                 zipf_a: float = 1.3, n_groups: int = 8,
                 host_base: int = 0, cli_groups_per_svc: int = 8):
        self.n_hosts = n_hosts
        self.n_svcs = n_svcs
        self.n_clients = n_clients
        self.n_groups = n_groups
        self.host_base = host_base
        self.rng = np.random.default_rng(seed)
        self._edgefold = None   # delta_frames' agent-side fold state
        self.zipf_a = zipf_a
        # distinct client process groups calling each service
        self.cli_groups_per_svc = cli_groups_per_svc
        # stable 64-bit glob_ids per (host, svc), from the global host id
        hs = np.arange(host_base, host_base + n_hosts,
                       dtype=np.uint64)[:, None]
        sv = np.arange(n_svcs, dtype=np.uint64)[None, :]
        raw = (hs << np.uint64(32)) | (sv + np.uint64(1))
        self.glob_ids = _splitmix64(raw)                    # (H, S)
        # per-service latency scale: log-spaced 200us..50ms across services
        scales = np.geomspace(200.0, 50_000.0, n_svcs)
        self.svc_latency_us = np.tile(scales, (n_hosts, 1))  # (H, S)
        # client IPv4 pool (10.x.y.z)
        self.cli_ips = self.rng.integers(
            0x0A000000, 0x0AFFFFFF, size=(n_clients,), dtype=np.uint32)
        self.tusec = np.uint64(1_700_000_000_000_000)
        # stable process-group ids per (host, group) + interned comm ids
        # (neither draws from the rng)
        gr = np.arange(n_groups, dtype=np.uint64)[None, :]
        self.task_ids = _splitmix64(
            (hs << np.uint64(24)) | gr | np.uint64(0x7A5C << 48))
        self.comm_ids = np.array(
            [H.hash_bytes_np(f"proc-{g}".encode("utf-8"), _NAME_KIND_COMM)
             for g in range(n_groups)], np.uint64)

    def resp_records(self, n: int) -> np.ndarray:
        """n response-time samples across all hosts/services."""
        r = self.rng
        host = r.integers(0, self.n_hosts, n)
        svc = r.integers(0, self.n_svcs, n)
        scale = self.svc_latency_us[host, svc]
        lat = r.lognormal(mean=0.0, sigma=0.7, size=n) * scale
        out = np.zeros(n, wire.RESP_SAMPLE_DT)
        out["glob_id"] = self.glob_ids[host, svc]
        out["resp_usec"] = np.minimum(lat, 4e9).astype(np.uint32)
        out["host_id"] = (host + self.host_base).astype(np.uint32)
        return out

    def conn_records(self, n: int) -> np.ndarray:
        """n TCP_CONN close notifications with zipf-heavy flow keys."""
        r = self.rng
        host = r.integers(0, self.n_hosts, n)
        svc = r.integers(0, self.n_svcs, n)
        # zipf rank → client index: few clients dominate (heavy hitters)
        rank = r.zipf(self.zipf_a, n)
        cli = (rank - 1) % self.n_clients
        cli_ip = self.cli_ips[cli]
        sport = (20000 + (rank % 20000)).astype(np.uint16)
        out = np.zeros(n, wire.TCP_CONN_DT)
        _put_ipv4(out["cli"], cli_ip, sport)
        ser_ip = (0xC0A80000
                  | ((host.astype(np.uint32) + self.host_base) & 0xFFFF))
        _put_ipv4(out["ser"], ser_ip.astype(np.uint32),
                  (8000 + svc).astype(np.uint16))
        dur = (r.lognormal(1.0, 1.0, n) * 50_000).astype(np.uint64)
        out["tusec_start"] = self.tusec
        out["tusec_close"] = self.tusec + dur
        # client group: one of the svc's bounded caller deployments
        grp = (rank - 1) % self.cli_groups_per_svc
        out["cli_task_aggr_id"] = _splitmix64(
            (host.astype(np.uint64) * np.uint64(131071)
             + svc.astype(np.uint64)) * np.uint64(64)
            + grp.astype(np.uint64) + np.uint64(0xABCD))
        out["ser_glob_id"] = self.glob_ids[host, svc]
        out["ser_related_listen_id"] = out["ser_glob_id"]
        nbytes = (r.pareto(1.5, n) + 1.0) * 2000.0
        out["bytes_sent"] = np.minimum(nbytes, 2**40).astype(np.uint64)
        out["bytes_rcvd"] = np.minimum(nbytes * 9.0, 2**40).astype(np.uint64)
        out["cli_pid"] = cli.astype(np.int32) + 1000
        out["ser_pid"] = svc.astype(np.int32) + 300
        out["host_id"] = (host + self.host_base).astype(np.uint32)
        # accept-observed: the service host's own close notifications
        out["flags"] = 2
        self.tusec += np.uint64(5_000_000)
        return out

    def churn_records(self, phase: int, n_conn: int = 256,
                      n_resp: int = 512, duty: int = 3):
        """One tick of deterministically rotating traffic → (conn, resp)
        record arrays: tick ``phase`` directs all traffic at services
        where ``(svc + phase) % duty != 0``, so each service swings
        between loaded and idle every ``duty`` ticks (a threshold
        predicate's match set gains and loses rows every tick)."""
        allowed = np.array([s for s in range(self.n_svcs)
                            if (s + phase) % duty != 0], np.int64)
        if not len(allowed):
            allowed = np.arange(self.n_svcs, dtype=np.int64)
        conn = self.conn_records(n_conn)
        resp = self.resp_records(n_resp)
        r = self.rng
        for out, n in ((conn, n_conn), (resp, n_resp)):
            host = r.integers(0, self.n_hosts, n)
            svc = allowed[r.integers(0, len(allowed), n)]
            out["host_id"] = (host + self.host_base).astype(np.uint32)
            gid = self.glob_ids[host, svc]
            if "ser_glob_id" in out.dtype.names:
                out["ser_glob_id"] = gid
                out["ser_related_listen_id"] = gid
            else:
                out["glob_id"] = gid
        return conn, resp

    def svc_call_graph(self):
        """The fleet's deterministic service→service call topology: each
        service (h, j) calls one downstream service. Returns
        (cal_h, cal_j, cee_h, cee_j), flat int arrays of length
        n_hosts*n_svcs."""
        h = np.repeat(np.arange(self.n_hosts), self.n_svcs)
        j = np.tile(np.arange(self.n_svcs), self.n_hosts)
        cee_h = (h * 31 + j * 7 + 1) % self.n_hosts
        cee_j = (j + 1) % self.n_svcs
        return h, j, cee_h, cee_j

    def listener_info_records(self) -> np.ndarray:
        """Static metadata announcements (LISTENER_INFO) for every
        listener (no draw from the rng)."""
        n = self.n_hosts * self.n_svcs
        host = np.repeat(np.arange(self.n_hosts, dtype=np.uint32),
                         self.n_svcs)
        svc = np.tile(np.arange(self.n_svcs, dtype=np.uint32),
                      self.n_hosts)
        out = np.zeros(n, wire.LISTENER_INFO_DT)
        out["glob_id"] = self.glob_ids.reshape(-1)
        ser_ip = (0xC0A80000
                  | ((host + np.uint32(self.host_base)) & 0xFFFF))
        _put_ipv4(out["addr"], ser_ip, (8000 + svc).astype(np.uint16))
        out["tusec_start"] = self.tusec - np.uint64(3_600_000_000)
        out["comm_id"] = self.comm_ids[svc % self.n_groups]
        out["cmdline_id"] = self.comm_ids[svc % self.n_groups]
        out["related_listen_id"] = out["glob_id"]
        out["pid"] = (300 + svc).astype(np.int32)
        out["is_any_ip"] = 1
        out["is_http"] = (svc % 2 == 0)
        out["host_id"] = host + self.host_base
        return out

    def svc_conn_records(self, n: int, split_halves: bool = False,
                         nat: bool = False):
        """n service→service flows drawn from the fleet call graph.

        ``split_halves=False`` emits one record per flow carrying both
        sides (the locally-resolved case). ``split_halves=True`` emits
        TWO half records per flow with identical 5-tuples: a
        connect-observed record from the caller's host (``ser_glob_id``
        0) and an accept-observed record from the callee's host (client
        identity 0), the inputs the pairing tier joins. Returns one
        record array, or a ``(cli_side, ser_side)`` tuple when
        ``split_halves``."""
        r = self.rng
        cal_h, cal_j, cee_h, cee_j = self.svc_call_graph()
        pick = r.integers(0, len(cal_h), n)
        ch, cj = cal_h[pick], cal_j[pick]
        sh, sj = cee_h[pick], cee_j[pick]
        cli_ip = (0xC0A80000
                  | ((ch.astype(np.uint32) + self.host_base) & 0xFFFF))
        ser_ip = (0xC0A80000
                  | ((sh.astype(np.uint32) + self.host_base) & 0xFFFF))
        sport = (30000 + r.integers(0, 20000, n)).astype(np.uint16)
        dport = (8000 + sj).astype(np.uint16)
        # one byte draw per FLOW: both halves report the same totals
        nbytes = (r.pareto(1.5, n) + 1.0) * 3000.0

        def base(hs) -> np.ndarray:
            out = np.zeros(n, wire.TCP_CONN_DT)
            _put_ipv4(out["cli"], cli_ip.astype(np.uint32), sport)
            _put_ipv4(out["ser"], ser_ip.astype(np.uint32), dport)
            out["tusec_start"] = self.tusec
            out["tusec_close"] = self.tusec + np.uint64(100_000)
            out["bytes_sent"] = np.minimum(nbytes, 2**40).astype(np.uint64)
            out["bytes_rcvd"] = np.minimum(nbytes * 4, 2**40).astype(
                np.uint64)
            out["host_id"] = (hs + self.host_base).astype(np.uint32)
            return out

        cli_side = base(ch)
        cli_side["cli_task_aggr_id"] = self.task_ids[
            ch, cj % self.n_groups]
        cli_side["cli_related_listen_id"] = self.glob_ids[ch, cj]
        cli_side["flags"] = 1                    # connect-observed
        if nat:
            # callee behind a VIP: the flow key comes from the post-NAT
            # view both sides share
            vip = (0x0AFE0000 | sj.astype(np.uint32))
            _put_ipv4(cli_side["ser"], vip, (80 + sj).astype(np.uint16))
            _put_ipv4(cli_side["nat_cli"], cli_ip.astype(np.uint32),
                      sport)
            _put_ipv4(cli_side["nat_ser"], ser_ip.astype(np.uint32),
                      dport)
        if not split_halves:
            cli_side["ser_glob_id"] = self.glob_ids[sh, sj]
            cli_side["ser_related_listen_id"] = cli_side["ser_glob_id"]
            self.tusec += np.uint64(1_000_000)
            return cli_side
        ser_side = base(sh)
        ser_side["ser_glob_id"] = self.glob_ids[sh, sj]
        ser_side["ser_related_listen_id"] = ser_side["ser_glob_id"]
        ser_side["flags"] = 2                    # accept-observed
        self.tusec += np.uint64(1_000_000)
        return cli_side, ser_side

    def listener_state_records(self) -> np.ndarray:
        """One 5s LISTENER_STATE sweep over every (host, svc)."""
        r = self.rng
        n = self.n_hosts * self.n_svcs
        host = np.repeat(np.arange(self.n_hosts, dtype=np.uint32),
                         self.n_svcs)
        out = np.zeros(n, wire.LISTENER_STATE_DT)
        out["glob_id"] = self.glob_ids.reshape(-1)
        qps = r.poisson(200, n)
        out["nqrys_5s"] = qps
        out["total_resp_5sec"] = (
            qps * self.svc_latency_us.reshape(-1) / 1000.0).astype(np.uint32)
        out["nconns"] = r.poisson(50, n)
        out["nconns_active"] = np.minimum(out["nconns"], r.poisson(20, n))
        out["ntasks"] = 1 + r.integers(0, 4, n)
        out["p95_5s_resp_ms"] = (
            self.svc_latency_us.reshape(-1) * 2.5 / 1000.0).astype(np.uint32)
        out["curr_kbytes_inbound"] = r.poisson(500, n)
        out["curr_kbytes_outbound"] = r.poisson(4000, n)
        out["ser_errors"] = (r.random(n) < 0.02) * r.poisson(3, n)
        out["tasks_delay_usec"] = r.poisson(100, n)
        out["host_id"] = host + self.host_base
        return out

    def aggr_task_records(self) -> np.ndarray:
        """One 5s AGGR_TASK_STATE sweep: ``n_groups`` process groups per
        host."""
        r = self.rng
        n = self.n_hosts * self.n_groups
        host = np.repeat(np.arange(self.n_hosts, dtype=np.uint32),
                         self.n_groups)
        grp = np.tile(np.arange(self.n_groups, dtype=np.uint64),
                      self.n_hosts)
        out = np.zeros(n, wire.AGGR_TASK_DT)
        out["aggr_task_id"] = self.task_ids.reshape(-1)
        out["comm_id"] = self.comm_ids[grp]
        # groups 0..n_svcs-1 serve the corresponding listener
        svc = np.minimum(grp, self.n_svcs - 1).astype(np.int64)
        serves = grp < self.n_svcs
        out["related_listen_id"] = np.where(
            serves, self.glob_ids[host, svc], 0)
        out["tcp_kbytes"] = r.poisson(800, n) * serves
        out["tcp_conns"] = r.poisson(30, n) * serves
        cpu = (r.pareto(2.0, n) + 0.2) * 8.0
        out["total_cpu_pct"] = np.minimum(cpu, 3200.0).astype(np.float32)
        out["rss_mb"] = 64 + r.integers(0, 4096, n)
        cpu_delay = (r.random(n) < 0.06) * r.integers(50, 2000, n)
        io_delay = (r.random(n) < 0.04) * r.integers(20, 1500, n)
        out["cpu_delay_msec"] = cpu_delay
        out["blkio_delay_msec"] = io_delay
        out["vm_delay_msec"] = (r.random(n) < 0.01) * r.integers(10, 500, n)
        out["ntasks_total"] = 1 + r.integers(0, 16, n)
        # fork churn: mostly quiet groups, a heavy-tailed few
        out["forks_sec"] = np.where(
            r.random(n) < 0.15, r.pareto(1.5, n) * 5.0, 0.0
        ).astype(np.float32)
        issue = (cpu_delay > 500) | (io_delay > 300)
        out["ntasks_issue"] = issue * (1 + r.integers(
            0, out["ntasks_total"].astype(np.int64), n))
        out["curr_state"] = np.where(
            issue, np.where(cpu_delay > 1200, S.STATE_SEVERE, S.STATE_BAD),
            np.where(out["total_cpu_pct"] > 1.0, S.STATE_OK, S.STATE_IDLE)
        ).astype(np.uint8)
        out["curr_issue"] = np.where(
            cpu_delay > 500, S.TISSUE_CPU_DELAY,
            np.where(io_delay > 300, S.TISSUE_BLKIO_DELAY,
                     S.TISSUE_NONE)).astype(np.uint8)
        out["host_id"] = host + self.host_base
        return out

    # API signature pool of the trace stream (ids are content hashes)
    API_SIGS = ("GET /v1/items/{}", "POST /v1/items",
                "GET /v1/search", "SELECT * FROM items WHERE id=$",
                "INSERT INTO events VALUES ($)")

    def trace_records(self, n: int, err_pct: float = 0.02) -> np.ndarray:
        """n REQ_TRACE transactions over the fleet's services."""
        r = self.rng
        host = r.integers(0, self.n_hosts, n)
        svc = r.integers(0, self.n_svcs, n)
        api_i = r.integers(0, len(self.API_SIGS), n)
        out = np.zeros(n, wire.REQ_TRACE_DT)
        out["svc_glob_id"] = self.glob_ids[host, svc]
        api_ids = np.array([H.hash_bytes_np(s.encode())
                            for s in self.API_SIGS], np.uint64)
        out["api_id"] = api_ids[api_i]
        out["tusec"] = self.tusec
        lat = self.svc_latency_us[host, svc]
        out["resp_usec"] = (r.lognormal(0.0, 0.8, n) * lat).astype(
            np.uint32)
        is_sql = api_i >= 3
        err = r.random(n) < err_pct
        out["status"] = np.where(is_sql, err.astype(np.uint16),
                                 np.where(err, 500, 200))
        out["proto"] = np.where(is_sql, PROTO_POSTGRES, PROTO_HTTP1)
        out["is_error"] = err
        out["bytes_in"] = r.integers(100, 2000, n)
        out["bytes_out"] = r.integers(200, 50_000, n)
        # traced-connection identity: a handful of persistent client
        # conns per (client group, service) pair
        ch = r.integers(0, self.n_hosts, n)
        cg = r.integers(0, self.n_groups, n)
        cli_task = self.task_ids[ch, cg]
        out["cli_task_aggr_id"] = cli_task
        out["cli_comm_id"] = self.comm_ids[cg]
        conn_no = r.integers(0, 4, n).astype(np.uint64)
        khi = (cli_task >> np.uint64(32)).astype(np.uint32)
        klo = cli_task.astype(np.uint32) \
            ^ out["svc_glob_id"].astype(np.uint32)
        chi = H.mix64(khi, klo, 0xC0)
        clo = H.mix64(khi, klo, 0xC1)
        out["conn_id"] = ((chi.astype(np.uint64) << np.uint64(32))
                          | clo.astype(np.uint64)) ^ conn_no
        out["host_id"] = (host + self.host_base).astype(np.uint32)
        return out

    def trace_frames(self, n: int, only_svcs=None) -> bytes:
        """``only_svcs``: an iterable of enabled svc glob ids — records
        for other services are filtered out (the agent captures only
        where a trace definition enabled it)."""
        recs = self.trace_records(n)
        if only_svcs is not None:
            keep = np.isin(recs["svc_glob_id"],
                           np.fromiter(only_svcs, np.uint64,
                                       len(only_svcs)))
            recs = recs[keep]
        return b"".join(
            wire.encode_frame(wire.NOTIFY_REQ_TRACE,
                              recs[i:i + wire.MAX_TRACE_PER_BATCH])
            for i in range(0, len(recs), wire.MAX_TRACE_PER_BATCH))

    def cpu_mem_records(self, hot_cpu=(), hot_mem=()) -> np.ndarray:
        """One 2s CPU_MEM_STATE sweep. ``hot_cpu``/``hot_mem`` are local
        host indices forced into saturation."""
        r = self.rng
        n = self.n_hosts
        out = np.zeros(n, wire.CPU_MEM_DT)
        cpu = np.clip(r.normal(35.0, 15.0, n), 1.0, 85.0)
        out["cpu_pct"] = cpu
        out["usercpu_pct"] = cpu * 0.7
        out["syscpu_pct"] = cpu * 0.3
        out["iowait_pct"] = np.clip(r.exponential(2.0, n), 0.0, 15.0)
        out["max_core_cpu_pct"] = np.clip(cpu * 1.5, 0.0, 90.0)
        out["cs_sec"] = r.poisson(20_000, n)
        out["forks_sec"] = r.poisson(20, n)
        out["procs_running"] = r.poisson(3, n)
        out["rss_pct"] = np.clip(r.normal(50.0, 12.0, n), 5.0, 72.0)
        out["commit_pct"] = np.clip(r.normal(60.0, 10.0, n), 10.0, 90.0)
        out["swap_free_pct"] = np.clip(r.normal(90.0, 5.0, n), 50.0, 100.0)
        out["pg_inout_sec"] = r.poisson(200, n)
        out["ncpus"] = 16.0
        hot_cpu = np.asarray(list(hot_cpu), int)
        hot_mem = np.asarray(list(hot_mem), int)
        if len(hot_cpu):
            out["cpu_pct"][hot_cpu] = 99.0
            out["usercpu_pct"][hot_cpu] = 95.0
        if len(hot_mem):
            out["rss_pct"][hot_mem] = 96.0
            out["oom_kills"][hot_mem] = 1.0
        out["host_id"] = np.arange(n, dtype=np.uint32) + self.host_base
        return out

    def host_state_records(self) -> np.ndarray:
        r = self.rng
        n = self.n_hosts
        out = np.zeros(n, wire.HOST_STATE_DT)
        out["curr_time_usec"] = self.tusec
        out["ntasks"] = 100 + r.integers(0, 50, n)
        out["ntasks_issue"] = (r.random(n) < 0.1) * r.integers(1, 5, n)
        out["nlisten"] = self.n_svcs
        out["nlisten_issue"] = (r.random(n) < 0.1) * r.integers(1, 3, n)
        out["cpu_issue"] = r.random(n) < 0.05
        out["mem_issue"] = r.random(n) < 0.03
        out["host_id"] = np.arange(n, dtype=np.uint32) + self.host_base
        return out

    # fixed inventory vocabulary (interned as NAME_KIND_MISC)
    DISTROS = ("Debian 12", "Ubuntu 22.04", "AlmaLinux 9")
    KERNELS = ("6.1.0-18-amd64", "5.15.0-105-generic")
    CPUTYPES = ("Xeon-8481C", "EPYC-9B14")
    REGIONS = ("us-east1", "eu-west4")
    CGPATHS = ("/sys/fs/cgroup/system.slice", "/sys/fs/cgroup/user.slice",
               "/sys/fs/cgroup/kubepods/burstable",
               "/sys/fs/cgroup/kubepods/besteffort")

    def name_records(self) -> np.ndarray:
        """Intern announcements for every name this agent fleet uses
        (no draw from the rng)."""
        from gyeeta_tpu_torch.utils.intern import InternTable
        entries = []
        for sig in self.API_SIGS:
            entries.append((wire.NAME_KIND_API,
                            H.hash_bytes_np(sig.encode()), sig))
        for g in range(self.n_groups):
            entries.append((wire.NAME_KIND_COMM, self.comm_ids[g],
                            f"proc-{g}"))
        for h in range(self.n_hosts):
            for s in range(self.n_svcs):
                entries.append((wire.NAME_KIND_SVC, self.glob_ids[h, s],
                                f"svc-{s}.host-{h}"))
            entries.append((wire.NAME_KIND_HOST, h, f"host-{h}.sim"))
        misc = list(self.DISTROS + self.KERNELS + self.CPUTYPES
                    + self.CGPATHS)
        for r in self.REGIONS:
            misc += [r, f"{r}-a", f"{r}-b"]
        for h in range(self.n_hosts):
            misc.append(f"i-{h + self.host_base:016x}")
        for s in misc:
            entries.append((wire.NAME_KIND_MISC,
                            InternTable.intern(s, wire.NAME_KIND_MISC), s))
        return InternTable.records(entries)

    def host_info_records(self) -> np.ndarray:
        """Static host inventory (HOST_INFO): deterministic per host id,
        so a reconnect's resend is idempotent (no draw from the rng)."""
        from gyeeta_tpu_torch.utils.intern import InternTable

        def mid(s):
            return InternTable.intern(s, wire.NAME_KIND_MISC)

        n = self.n_hosts
        hs = np.arange(n) + self.host_base
        out = np.zeros(n, wire.HOST_INFO_DT)
        out["host_id"] = hs
        out["ncpus"] = 8 << (hs % 3)
        out["nnuma"] = 1 + (hs % 2)
        out["ram_mb"] = 32768 << (hs % 3)
        out["swap_mb"] = 2048
        out["boot_tusec"] = self.tusec - np.uint64(86_400_000_000)
        out["kern_ver_id"] = [mid(self.KERNELS[h % 2]) for h in hs]
        out["distro_id"] = [mid(self.DISTROS[h % 3]) for h in hs]
        out["cputype_id"] = [mid(self.CPUTYPES[h % 2]) for h in hs]
        out["instance_id"] = [mid(f"i-{h:016x}") for h in hs]
        region = [self.REGIONS[h % 2] for h in hs]
        out["region_id"] = [mid(r) for r in region]
        out["zone_id"] = [mid(f"{r}-{'ab'[h % 2]}")
                          for r, h in zip(region, hs)]
        out["virt_type"] = 1
        out["cloud_type"] = 1 + (hs % 3)
        out["is_k8s"] = (hs % 4) == 0
        return out

    def cgroup_records(self) -> np.ndarray:
        """One 5s CGROUP_STATE sweep: a few tracked cgroups per host
        with utilization jitter; kubepods throttle under load."""
        from gyeeta_tpu_torch.utils.intern import InternTable

        r = self.rng
        npaths = len(self.CGPATHS)
        n = self.n_hosts * npaths
        host = np.repeat(np.arange(self.n_hosts) + self.host_base, npaths)
        path_i = np.tile(np.arange(npaths), self.n_hosts)
        out = np.zeros(n, wire.CGROUP_DT)
        dir_ids = np.array([InternTable.intern(p, wire.NAME_KIND_MISC)
                            for p in self.CGPATHS], np.uint64)
        out["dir_id"] = dir_ids[path_i]
        out["cg_id"] = _splitmix64(
            (host.astype(np.uint64) << np.uint64(8))
            | path_i.astype(np.uint64))
        out["host_id"] = host
        out["is_v2"] = True
        limited = path_i >= 2                 # kubepods have cpu limits
        out["cpu_pct"] = r.random(n) * 40.0
        out["cpu_limit_pct"] = np.where(limited, 50.0, -1.0)
        throttled = limited & (r.random(n) < 0.1)
        out["cpu_throttled_pct"] = np.where(throttled,
                                            r.random(n) * 30.0, 0.0)
        out["rss_mb"] = r.random(n) * 4096.0
        out["memory_limit_mb"] = np.where(limited, 8192.0, -1.0)
        out["pgmajfault_sec"] = r.random(n) * 2.0
        out["nprocs"] = r.integers(1, 64, n)
        out["state"] = np.where(throttled, 3, 1)   # Bad when throttled
        return out

    def conn_frames(self, n_events: int) -> bytes:
        """n_events conn records framed into ≤2048-record messages."""
        return wire.encode_frames_chunked(
            wire.NOTIFY_TCP_CONN, self.conn_records(n_events))

    def delta_frames(self, n_conn: int, n_resp: int,
                     params: dict | None = None) -> bytes:
        """Edge pre-aggregation form of one conn + resp sweep: the
        records folded locally (``sketch/edgefold.py``) and framed as
        one NOTIFY_SKETCH_DELTA stream instead of raw tuples. The fold
        state (the cumulative HLL registers) persists on the sim, so
        successive sweeps ship only the registers that rose."""
        from gyeeta_tpu_torch.sketch import edgefold as EF
        if self._edgefold is None:
            self._edgefold = EF.EdgeFold(
                params if params is not None else EF.default_params(),
                host_id=self.host_base)
        return wire.encode_frames_chunked(
            wire.NOTIFY_SKETCH_DELTA,
            self._edgefold.fold_sweep(self.conn_records(n_conn),
                                      self.resp_records(n_resp)))

    def resp_frames(self, n_events: int) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_RESP_SAMPLE, self.resp_records(n_events))

    def listener_frames(self) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_LISTENER_STATE, self.listener_state_records())

    def task_frames(self) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_AGGR_TASK_STATE, self.aggr_task_records())

    def name_frames(self) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_NAME_INTERN, self.name_records())

    def host_info_frames(self) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_HOST_INFO, self.host_info_records())

    def cgroup_frames(self) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_CGROUP_STATE, self.cgroup_records())


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        z = x
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


def _put_ipv4(ip_port_view: np.ndarray, ipv4: np.ndarray,
              port: np.ndarray) -> None:
    """Write IPv4-mapped addresses (::ffff:a.b.c.d) + port into IP_PORT."""
    ip = ip_port_view["ip"]
    ip[:, 10] = 0xFF
    ip[:, 11] = 0xFF
    ip[:, 12] = (ipv4 >> 24).astype(np.uint8)
    ip[:, 13] = ((ipv4 >> 16) & 0xFF).astype(np.uint8)
    ip[:, 14] = ((ipv4 >> 8) & 0xFF).astype(np.uint8)
    ip[:, 15] = (ipv4 & 0xFF).astype(np.uint8)
    ip_port_view["port"] = port
