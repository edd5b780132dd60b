"""Host-side listener-metadata registry (the svcinfo backing store).

The reference keeps per-listener static metadata (bind address, command
line, start time) in madhava's listener tables and serves the ``svcinfo``
subsystem from them. Metadata is announce-rate (once per listener +
reconnect resends), so it stays host-side here — only hot-path columns
live on device. Records arrive as NOTIFY_LISTENER_INFO.

A copy of ``gyeeta_tpu/utils/svcreg.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import ipaddress

import numpy as np


def format_ip(ip16: np.ndarray) -> str:
    """16 raw bytes → presentation address (v4-mapped → dotted quad)."""
    b = bytes(ip16.tolist() if hasattr(ip16, "tolist") else ip16)
    addr = ipaddress.IPv6Address(b)
    v4 = addr.ipv4_mapped
    return str(v4) if v4 is not None else str(addr)


class SvcInfoRegistry:
    def __init__(self):
        self._by_id: dict[int, dict] = {}
        self._cols_cache = None     # built columns; invalidated on update

    def update(self, recs: np.ndarray) -> int:
        if len(recs):
            self._cols_cache = None
        for r in recs:
            gid = int(r["glob_id"])
            self._by_id[gid] = {
                "ip": format_ip(r["addr"]["ip"]),
                "port": int(r["addr"]["port"]),
                "tstart_usec": int(r["tusec_start"]),
                "cmdline_id": int(r["cmdline_id"]),
                "comm_id": int(r["comm_id"]),
                "relsvcid": int(r["related_listen_id"]),
                "pid": int(r["pid"]),
                "is_any_ip": bool(r["is_any_ip"]),
                "is_http": bool(r["is_http"]),
                "hostid": int(r["host_id"]),
            }
        return len(recs)

    def get(self, glob_id: int) -> dict | None:
        return self._by_id.get(glob_id)

    def __len__(self) -> int:
        return len(self._by_id)

    def columns(self, names=None):
        """Dense presentation columns for the svcinfo subsystem.

        Built columns are cached until the next ``update`` — metadata is
        announce-rate while queries are interactive-rate, so per-query
        Python row loops would stall the ingest loop at 65k listeners.
        (Cache keys on the names registry identity: resolved names can
        change when late NAME_INTERN announcements land, which bumps
        ``names.version``.)"""
        from gyeeta_tpu_torch.ingest import wire

        ver = getattr(names, "version", None)
        if self._cols_cache is not None and self._cols_cache[0] == ver:
            return self._cols_cache[1]

        ids = sorted(self._by_id)
        rows = [self._by_id[i] for i in ids]
        n = len(ids)

        def resolve(kind, vals):
            vals = np.asarray(vals, np.uint64)
            if names is None:
                return np.array([format(int(v), "016x") for v in vals],
                                object)
            return names.resolve_array(kind, vals)

        def num(key):
            return np.array([r[key] for r in rows], np.float64)

        cols = {
            "svcid": np.array([format(i, "016x") for i in ids], object),
            "svcname": resolve(wire.NAME_KIND_SVC, ids),
            "ip": np.array([r["ip"] for r in rows], object),
            "port": num("port"),
            "tstart": np.array([r["tstart_usec"] / 1e6 for r in rows],
                               np.float64),
            "comm": resolve(wire.NAME_KIND_COMM,
                            [r["comm_id"] for r in rows]),
            "cmdline": resolve(wire.NAME_KIND_COMM,
                               [r["cmdline_id"] for r in rows]),
            "pid": num("pid"),
            "relsvcid": np.array([format(r["relsvcid"], "016x")
                                  for r in rows], object),
            "anyip": np.array([r["is_any_ip"] for r in rows], bool),
            "ishttp": np.array([r["is_http"] for r in rows], bool),
            "hostid": num("hostid"),
        }
        out = (cols, np.ones(n, bool))
        self._cols_cache = (ver, out)
        return out
