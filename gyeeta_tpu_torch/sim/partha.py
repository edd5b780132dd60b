"""Deterministic multi-agent event generator: the fold path's two streams.

Counterpart of ``gyeeta_tpu/sim/partha.py`` for the TCP_CONN and
RESP_SAMPLE streams. It draws from ``np.random.default_rng(seed)`` in
the reference's order, so the same seed and the same sequence of calls
give byte-identical records in both packages. The reference's interned
comm ids draw nothing from the rng and are not needed on this path.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire


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

    def conn_frames(self, n_events: int) -> bytes:
        """n_events conn records framed into ≤2048-record messages."""
        return wire.encode_frames_chunked(
            wire.NOTIFY_TCP_CONN, self.conn_records(n_events))

    def resp_frames(self, n_events: int) -> bytes:
        return wire.encode_frames_chunked(
            wire.NOTIFY_RESP_SAMPLE, self.resp_records(n_events))


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
