"""Host-side registries for announce-rate inventory records.

Two registries backing query subsystems that the reference serves from
madhava's in-memory host tables + Postgres info tables:

- :class:`HostInfoRegistry` — static host inventory (``hostinfo``
  subsystem; reference ``HOST_INFO_NOTIFY`` → hostinfotbl,
  ``common/gy_sys_hardware.h`` SYS_HARDWARE + cloud IMDS metadata,
  ``common/gy_cloud_metadata.h``);
- :class:`CgroupRegistry` — 5s per-cgroup stats (``cgroupstate``
  subsystem; reference ``common/gy_cgroup_stat.h`` CGROUP_HANDLE).

Both follow the SvcInfoRegistry pattern: dict keyed by entity id,
columns() builds dense numpy presentation columns cached until the next
update. Cgroups age out when a host stops reporting them (deleted
cgroups simply vanish from sweeps — there is no delete message).

A copy of ``gyeeta_tpu/utils/hostreg.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

VIRT_NAMES = ("none", "vm", "container")
CLOUD_NAMES = ("none", "aws", "gcp", "azure")


class HostInfoRegistry:
    def __init__(self):
        self._by_id: dict[int, dict] = {}
        self._cache = None

    def update(self, recs: np.ndarray) -> int:
        if len(recs):
            self._cache = None
        for r in recs:
            self._by_id[int(r["host_id"])] = {
                "ncpus": int(r["ncpus"]),
                "nnuma": int(r["nnuma"]),
                "ram_mb": int(r["ram_mb"]),
                "swap_mb": int(r["swap_mb"]),
                "boot_tusec": int(r["boot_tusec"]),
                "kern_ver_id": int(r["kern_ver_id"]),
                "distro_id": int(r["distro_id"]),
                "cputype_id": int(r["cputype_id"]),
                "instance_id": int(r["instance_id"]),
                "region_id": int(r["region_id"]),
                "zone_id": int(r["zone_id"]),
                "virt_type": int(r["virt_type"]),
                "cloud_type": int(r["cloud_type"]),
                "is_k8s": bool(r["is_k8s"]),
            }
        return len(recs)

    def get(self, host_id: int) -> dict | None:
        return self._by_id.get(host_id)

    def __len__(self) -> int:
        return len(self._by_id)

    def columns(self, names=None):
        from gyeeta_tpu_torch.ingest import wire

        ver = getattr(names, "version", None)
        if self._cache is not None and self._cache[0] == ver:
            return self._cache[1]
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

        def enum_name(key, table):
            return np.array(
                [table[r[key]] if 0 <= r[key] < len(table) else "?"
                 for r in rows], object)

        cols = {
            "hostid": np.array(ids, np.float64),
            "host": resolve(wire.NAME_KIND_HOST, ids),
            "ncpus": num("ncpus"),
            "nnuma": num("nnuma"),
            "rammb": num("ram_mb"),
            "swapmb": num("swap_mb"),
            "boot": np.array([r["boot_tusec"] / 1e6 for r in rows],
                             np.float64),
            "kernverstr": resolve(wire.NAME_KIND_MISC,
                                  [r["kern_ver_id"] for r in rows]),
            "dist": resolve(wire.NAME_KIND_MISC,
                            [r["distro_id"] for r in rows]),
            "cputype": resolve(wire.NAME_KIND_MISC,
                               [r["cputype_id"] for r in rows]),
            "instanceid": resolve(wire.NAME_KIND_MISC,
                                  [r["instance_id"] for r in rows]),
            "region": resolve(wire.NAME_KIND_MISC,
                              [r["region_id"] for r in rows]),
            "zone": resolve(wire.NAME_KIND_MISC,
                            [r["zone_id"] for r in rows]),
            "virt": enum_name("virt_type", VIRT_NAMES),
            "cloud": enum_name("cloud_type", CLOUD_NAMES),
            "isk8s": np.array([r["is_k8s"] for r in rows], bool),
        }
        out = (cols, np.ones(n, bool))
        self._cache = (ver, out)
        return out


class CgroupRegistry:
    """Keyed by (host_id, cg_id); rows age out after ``max_age`` sweeps
    without an update (the agent resends every live cgroup each 5s)."""

    def __init__(self, max_age: int = 24):
        self._by_key: dict[tuple[int, int], dict] = {}
        self._cache = None
        self._sweep = 0
        self.max_age = max_age

    def update(self, recs: np.ndarray) -> int:
        if len(recs):
            self._cache = None
        for r in recs:
            self._by_key[(int(r["host_id"]), int(r["cg_id"]))] = {
                "dir_id": int(r["dir_id"]),
                "cpu_pct": float(r["cpu_pct"]),
                "cpu_limit_pct": float(r["cpu_limit_pct"]),
                "cpu_throttled_pct": float(r["cpu_throttled_pct"]),
                "rss_mb": float(r["rss_mb"]),
                "memory_limit_mb": float(r["memory_limit_mb"]),
                "pgmajfault_sec": float(r["pgmajfault_sec"]),
                "nprocs": int(r["nprocs"]),
                "is_v2": bool(r["is_v2"]),
                "state": int(r["state"]),
                "sweep": self._sweep,
            }
        return len(recs)

    def age(self) -> int:
        """Advance the sweep clock and drop rows unseen for max_age
        sweeps. Call once per server tick."""
        self._sweep += 1
        dead = [k for k, v in self._by_key.items()
                if self._sweep - v["sweep"] > self.max_age]
        for k in dead:
            del self._by_key[k]
        if dead:
            self._cache = None
        return len(dead)

    def __len__(self) -> int:
        return len(self._by_key)

    def columns(self, names=None):
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.semantic.states import STATE_NAMES

        ver = getattr(names, "version", None)
        if self._cache is not None and self._cache[0] == (ver, self._sweep):
            return self._cache[1]
        keys = sorted(self._by_key)
        rows = [self._by_key[k] for k in keys]
        n = len(keys)

        def num(key):
            return np.array([r[key] for r in rows], np.float64)

        if names is None:
            dirs = np.array(
                [format(r["dir_id"], "016x") for r in rows], object)
        else:
            dirs = names.resolve_array(
                wire.NAME_KIND_MISC,
                np.array([r["dir_id"] for r in rows], np.uint64))
        cols = {
            "cgid": np.array([format(c, "016x") for _, c in keys], object),
            "dir": dirs,
            "hostid": np.array([h for h, _ in keys], np.float64),
            "cpupct": num("cpu_pct"),
            "cpulimpct": num("cpu_limit_pct"),
            "throttlepct": num("cpu_throttled_pct"),
            "rssmb": num("rss_mb"),
            "memlimmb": num("memory_limit_mb"),
            "pgmajfps": num("pgmajfault_sec"),
            "nprocs": num("nprocs"),
            "isv2": np.array([r["is_v2"] for r in rows], bool),
            "state": np.array([r["state"] for r in rows], np.int32),
            "statestr": np.array(
                [STATE_NAMES[r["state"]]
                 if 0 <= r["state"] < len(STATE_NAMES) else "?"
                 for r in rows], object),
        }
        out = (cols, np.ones(n, bool))
        self._cache = ((ver, self._sweep), out)
        return out


class MountRegistry:
    """Keyed by (host_id, mnt_id); same sweep-ageing discipline as
    :class:`CgroupRegistry` (MOUNT_HDLR capability server-side)."""

    def __init__(self, max_age: int = 24):
        self._by_key: dict[tuple[int, int], dict] = {}
        self._cache = None
        self._sweep = 0
        self.max_age = max_age

    def update(self, recs: np.ndarray) -> int:
        if len(recs):
            self._cache = None
        for r in recs:
            self._by_key[(int(r["host_id"]), int(r["mnt_id"]))] = {
                "dir_id": int(r["dir_id"]),
                "fstype_id": int(r["fstype_id"]),
                "size_mb": float(r["size_mb"]),
                "free_mb": float(r["free_mb"]),
                "used_pct": float(r["used_pct"]),
                "inodes_used_pct": float(r["inodes_used_pct"]),
                "is_network_fs": bool(r["is_network_fs"]),
                "sweep": self._sweep,
            }
        return len(recs)

    def age(self) -> int:
        self._sweep += 1
        dead = [k for k, v in self._by_key.items()
                if self._sweep - v["sweep"] > self.max_age]
        for k in dead:
            del self._by_key[k]
        if dead:
            self._cache = None
        return len(dead)

    def __len__(self) -> int:
        return len(self._by_key)

    def columns(self, names=None):
        from gyeeta_tpu_torch.ingest import wire

        ver = getattr(names, "version", None)
        if self._cache is not None and self._cache[0] == (ver,
                                                          self._sweep):
            return self._cache[1]
        keys = sorted(self._by_key)
        rows = [self._by_key[k] for k in keys]
        n = len(keys)

        def num(key):
            return np.array([r[key] for r in rows], np.float64)

        def resolve(idkey):
            ids = np.array([r[idkey] for r in rows], np.uint64)
            if names is None:
                return np.array([format(i, "016x") for i in ids],
                                object)
            return names.resolve_array(wire.NAME_KIND_MISC, ids)

        cols = {
            "hostid": np.array([h for h, _ in keys], np.float64),
            "mnt": resolve("dir_id"),
            "fstype": resolve("fstype_id"),
            "sizemb": num("size_mb"),
            "freemb": num("free_mb"),
            "usedpct": num("used_pct"),
            "inodepct": num("inodes_used_pct"),
            "netfs": np.array([r["is_network_fs"] for r in rows],
                              bool),
        }
        out = (cols, np.ones(n, bool))
        self._cache = ((ver, self._sweep), out)
        return out


class NetIfRegistry:
    """Keyed by (host_id, if_id); NET_IF_HDLR capability server-side."""

    def __init__(self, max_age: int = 24):
        self._by_key: dict[tuple[int, int], dict] = {}
        self._cache = None
        self._sweep = 0
        self.max_age = max_age

    def update(self, recs: np.ndarray) -> int:
        if len(recs):
            self._cache = None
        for r in recs:
            self._by_key[(int(r["host_id"]), int(r["if_id"]))] = {
                "name_id": int(r["name_id"]),
                "speed_mbps": float(r["speed_mbps"]),
                "rx_mb_sec": float(r["rx_mb_sec"]),
                "tx_mb_sec": float(r["tx_mb_sec"]),
                "rx_errs_sec": float(r["rx_errs_sec"]),
                "tx_errs_sec": float(r["tx_errs_sec"]),
                "is_up": bool(r["is_up"]),
                "sweep": self._sweep,
            }
        return len(recs)

    def age(self) -> int:
        self._sweep += 1
        dead = [k for k, v in self._by_key.items()
                if self._sweep - v["sweep"] > self.max_age]
        for k in dead:
            del self._by_key[k]
        if dead:
            self._cache = None
        return len(dead)

    def __len__(self) -> int:
        return len(self._by_key)

    def columns(self, names=None):
        from gyeeta_tpu_torch.ingest import wire

        ver = getattr(names, "version", None)
        if self._cache is not None and self._cache[0] == (ver,
                                                          self._sweep):
            return self._cache[1]
        keys = sorted(self._by_key)
        rows = [self._by_key[k] for k in keys]
        n = len(keys)

        def num(key):
            return np.array([r[key] for r in rows], np.float64)

        ids = np.array([r["name_id"] for r in rows], np.uint64)
        if names is None:
            ifnames = np.array([format(i, "016x") for i in ids], object)
        else:
            ifnames = names.resolve_array(wire.NAME_KIND_MISC, ids)
        cols = {
            "hostid": np.array([h for h, _ in keys], np.float64),
            "name": ifnames,
            "speedmbps": num("speed_mbps"),
            "rxmbsec": num("rx_mb_sec"),
            "txmbsec": num("tx_mb_sec"),
            "rxerrsec": num("rx_errs_sec"),
            "txerrsec": num("tx_errs_sec"),
            "up": np.array([r["is_up"] for r in rows], bool),
        }
        out = (cols, np.ones(n, bool))
        self._cache = ((ver, self._sweep), out)
        return out
