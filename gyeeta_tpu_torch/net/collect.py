"""Real host collectors: /proc, /sys/fs/cgroup, os-release → wire records.

The agent-side measurement half of the reference's L2/L3 collectors,
re-scoped to what a userspace-only agent can read:

- :class:`CpuMemCollector` — /proc/stat + /proc/meminfo + /proc/vmstat
  deltas → one ``CPU_MEM_DT`` record per 2s sweep (the reference's
  ``SYS_CPU_STATS``/``SYS_MEM_STATS`` sampling,
  ``common/gy_sys_stat.cc:1144``; classification stays server-side);
- :func:`collect_host_info` — os-release / cpuinfo / topology →
  ``HOST_INFO_DT`` + its NAME_INTERN announcements (the
  ``SYS_HARDWARE`` inventory, ``common/gy_sys_hardware.h``; cloud IMDS
  is left "none" — no egress assumption, unlike
  ``common/gy_cloud_metadata.cc``);
- :class:`CgroupCollector` — cgroup v2 unified (or v1 cpuacct/memory)
  walk with usage/throttle deltas → ``CGROUP_DT`` records (the
  ``CGROUP_HANDLE`` stats tier, ``common/gy_cgroup_stat.h``).

Everything degrades to empty records when a surface is missing
(containers often mask /proc pieces); collectors never raise on I/O.

eBPF flow/response capture has no userspace equivalent — conn/resp
streams still come from instrumented workloads or the simulator; these
collectors make the host/cgroup/inventory subsystems REAL on any Linux
box the agent runs on.

Counterpart of ``gyeeta_tpu/net/collect.py``: numpy and the standard
library, no device. The environment knobs are read from an ``env``
mapping a caller hands over (``None`` means no environment):
``collect_host_info`` reads the container marker ``container`` and the
cloud probe's ``GYT_CLOUD_META``/``GYT_CLOUD_META_URL`` from it, and
``MountCollector`` its ``GYT_STAT_NETFS``.
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Optional

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils.intern import InternTable


def _read(path: str) -> str:
    try:
        return pathlib.Path(path).read_text()
    except OSError:
        return ""


def _fields(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 2:
            out[parts[0].rstrip(":")] = parts[1]
    return out


# ------------------------------------------------------------------ cpumem
class _CpuSample:
    def __init__(self):
        stat = _read("/proc/stat")
        self.t = time.monotonic()
        self.cores = {}
        self.total = None
        self.ctxt = 0
        self.processes = 0
        self.procs_running = 0
        self.btime = 0
        for line in stat.splitlines():
            p = line.split()
            if not p:
                continue
            if p[0] == "cpu":
                self.total = np.array(p[1:11], np.float64)
            elif p[0].startswith("cpu"):
                self.cores[p[0]] = np.array(p[1:11], np.float64)
            elif p[0] == "ctxt":
                self.ctxt = int(p[1])
            elif p[0] == "processes":
                self.processes = int(p[1])
            elif p[0] == "procs_running":
                self.procs_running = int(p[1])
            elif p[0] == "btime":
                self.btime = int(p[1])
        vm = _fields(_read("/proc/vmstat"))
        self.pgin = int(vm.get("pgpgin", 0)) + int(vm.get("pgpgout", 0))
        self.swap = int(vm.get("pswpin", 0)) + int(vm.get("pswpout", 0))
        self.oom = int(vm.get("oom_kill", 0))
        self.allocstall = sum(int(v) for k, v in vm.items()
                              if k.startswith("allocstall"))


def _cpu_pcts(prev: np.ndarray, cur: np.ndarray):
    """(total%, user%, sys%, iowait%) from two /proc/stat count rows."""
    d = cur - prev
    tot = max(float(d.sum()), 1e-9)
    idle = float(d[3] + d[4])                  # idle + iowait
    return (100.0 * (tot - idle) / tot,
            100.0 * float(d[0] + d[1]) / tot,  # user + nice
            100.0 * float(d[2]) / tot,
            100.0 * float(d[4]) / tot)


class CpuMemCollector:
    """Delta-based host CPU/mem sampler; call :meth:`sample` per sweep."""

    def __init__(self, host_id: int = 0):
        self.host_id = host_id
        self._prev = _CpuSample()

    def sample(self) -> np.ndarray:
        cur = _CpuSample()
        prev, self._prev = self._prev, cur
        dt = max(cur.t - prev.t, 1e-3)
        out = np.zeros(1, wire.CPU_MEM_DT)
        r = out[0]
        if cur.total is not None and prev.total is not None:
            cpu, usr, sys_, iow = _cpu_pcts(prev.total, cur.total)
            r["cpu_pct"], r["usercpu_pct"] = cpu, usr
            r["syscpu_pct"], r["iowait_pct"] = sys_, iow
            core_pcts = [
                _cpu_pcts(prev.cores[c], cur.cores[c])[0]
                for c in cur.cores if c in prev.cores]
            r["max_core_cpu_pct"] = max(core_pcts, default=cpu)
        r["cs_sec"] = (cur.ctxt - prev.ctxt) / dt
        r["forks_sec"] = (cur.processes - prev.processes) / dt
        r["procs_running"] = cur.procs_running
        mem = _fields(_read("/proc/meminfo"))

        def kb(key):
            return float(mem.get(key, 0))

        total = max(kb("MemTotal"), 1.0)
        avail = kb("MemAvailable")
        r["rss_pct"] = 100.0 * (total - avail) / total
        climit = kb("CommitLimit")
        r["commit_pct"] = (100.0 * kb("Committed_AS") / climit
                           if climit > 0 else 0.0)
        stot = kb("SwapTotal")
        r["swap_free_pct"] = (100.0 * kb("SwapFree") / stot
                              if stot > 0 else 100.0)
        r["pg_inout_sec"] = (cur.pgin - prev.pgin) / dt
        r["swap_inout_sec"] = (cur.swap - prev.swap) / dt
        r["allocstall_sec"] = (cur.allocstall - prev.allocstall) / dt
        r["oom_kills"] = cur.oom - prev.oom
        r["ncpus"] = len(cur.cores) or (os.cpu_count() or 1)
        r["host_id"] = self.host_id
        return out


# ---------------------------------------------------------------- hostinfo
def collect_host_info(host_id: int = 0, env=None):
    """→ (HOST_INFO_DT record array, NAME_INTERN record array). ``env``:
    the knob mapping (the container marker, the cloud probe's gate)."""
    env = {} if env is None else env

    def osrel(key):
        for line in _read("/etc/os-release").splitlines():
            if line.startswith(key + "="):
                return line.split("=", 1)[1].strip().strip('"')
        return ""

    distro = osrel("PRETTY_NAME") or osrel("NAME") or "linux"
    kern = os.uname().release
    cputype = ""
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("model name"):
            cputype = line.split(":", 1)[1].strip()
            break
    if not cputype:
        cputype = os.uname().machine
    mem = _fields(_read("/proc/meminfo"))
    nnuma = len([d for d in pathlib.Path(
        "/sys/devices/system/node").glob("node[0-9]*")]) \
        if pathlib.Path("/sys/devices/system/node").exists() else 1
    btime = 0
    for line in _read("/proc/stat").splitlines():
        if line.startswith("btime"):
            btime = int(line.split()[1])
    hyper = "hypervisor" in _read("/proc/cpuinfo")
    in_container = pathlib.Path("/.dockerenv").exists() or \
        "container" in env
    is_k8s = pathlib.Path(
        "/var/run/secrets/kubernetes.io").exists()

    def mid(s):
        return InternTable.intern(s, wire.NAME_KIND_MISC)

    out = np.zeros(1, wire.HOST_INFO_DT)
    r = out[0]
    r["host_id"] = host_id
    r["ncpus"] = os.cpu_count() or 1
    r["nnuma"] = max(nnuma, 1)
    r["ram_mb"] = float(mem.get("MemTotal", 0)) / 1024
    r["swap_mb"] = float(mem.get("SwapTotal", 0)) / 1024
    r["boot_tusec"] = btime * 1_000_000
    r["kern_ver_id"] = mid(kern)
    r["distro_id"] = mid(distro)
    r["cputype_id"] = mid(cputype)
    # cloud IMDS is config-gated (GYT_CLOUD_META=1) — the no-egress
    # default stays, but the descope is a flag, not an absence
    # (utils/cloudmeta.py; ref gy_cloud_metadata.cc:27-67)
    from gyeeta_tpu_torch.utils import cloudmeta
    cm = cloudmeta.detect(env=env)
    iid = cm["instance_id"] if cm else ""
    region = cm["region"] if cm else ""
    zone = cm["zone"] if cm else ""
    r["instance_id"] = mid(iid)
    r["region_id"] = mid(region)
    r["zone_id"] = mid(zone)
    r["virt_type"] = 2 if in_container else (1 if hyper else 0)
    r["cloud_type"] = cm["cloud_type"] if cm else 0
    r["is_k8s"] = is_k8s
    names = InternTable.records(
        [(wire.NAME_KIND_MISC, mid(s), s)
         for s in (kern, distro, cputype, "", iid, region, zone)])
    return out, names


# ----------------------------------------------------------------- cgroups
_CG_ROOT = "/sys/fs/cgroup"


def _cg_is_v2(root: str = _CG_ROOT) -> bool:
    return pathlib.Path(root, "cgroup.controllers").exists()


class _CgSample:
    def __init__(self, path: pathlib.Path, v2: bool,
                 root: str = _CG_ROOT):
        self.t = time.monotonic()
        if v2:
            st = _fields(_read(str(path / "cpu.stat")))
            self.cpu_usec = int(st.get("usage_usec", 0))
            self.nr_periods = int(st.get("nr_periods", 0))
            self.nr_throttled = int(st.get("nr_throttled", 0))
            self.rss = int(_read(str(path / "memory.current")) or 0)
            lim = _read(str(path / "memory.max")).strip()
            self.mem_limit = -1 if lim in ("", "max") else int(lim)
            cpu_max = _read(str(path / "cpu.max")).split()
            self.cpu_limit_pct = -1.0
            if len(cpu_max) == 2 and cpu_max[0] != "max":
                self.cpu_limit_pct = 100.0 * int(cpu_max[0]) / int(
                    cpu_max[1])
            mst = _fields(_read(str(path / "memory.stat")))
            self.pgmaj = int(mst.get("pgmajfault", 0))
            pids = _read(str(path / "pids.current")).strip()
            self.nprocs = int(pids) if pids.isdigit() else 0
        else:
            sub = _sub(path, root)
            self.cpu_usec = int(
                _read(f"{root}/cpuacct{sub}/cpuacct.usage")
                or 0) // 1000
            st = _fields(_read(f"{root}/cpu{sub}/cpu.stat"))
            self.nr_periods = int(st.get("nr_periods", 0))
            self.nr_throttled = int(st.get("nr_throttled", 0))
            self.rss = int(_read(
                f"{root}/memory{sub}/memory.usage_in_bytes") or 0)
            lim = _read(
                f"{root}/memory{sub}/memory.limit_in_bytes").strip()
            self.mem_limit = int(lim) if lim.isdigit() else -1
            if self.mem_limit > 1 << 60:        # v1 "unlimited"
                self.mem_limit = -1
            self.cpu_limit_pct = -1.0
            mst = _fields(_read(f"{root}/memory{sub}/memory.stat"))
            self.pgmaj = int(mst.get("pgmajfault", 0))
            procs = _read(f"{root}/cpu{sub}/cgroup.procs")
            self.nprocs = len(procs.splitlines())


def _sub(path: pathlib.Path, root: str = _CG_ROOT) -> str:
    """v1 helper: the subpath below the controller root ('' for root)."""
    s = str(path)
    for ctrl in ("/cpuacct", "/cpu", "/memory"):
        pre = root + ctrl
        if s.startswith(pre):
            return s[len(pre):]
    return ""


class CgroupCollector:
    """Tracks up to ``max_groups`` cgroup dirs (top 2 levels) with
    delta-based cpu%/throttle rates. v2 unified or v1 controllers."""

    def __init__(self, host_id: int = 0, root: str = _CG_ROOT,
                 max_groups: int = 64):
        self.host_id = host_id
        self.root = pathlib.Path(root)
        self.v2 = _cg_is_v2(root)
        self.max_groups = max_groups
        self._base = self.root if self.v2 else self.root / "cpu"
        self._prev: dict[str, _CgSample] = {}

    def _dirs(self):
        base = self._base
        if not base.exists():
            return
        yield base
        n = 1

        def children(d):
            # per-directory guard: one unreadable slice must not end
            # the walk for every group sorting after it
            try:
                return sorted(p for p in d.iterdir() if p.is_dir())
            except OSError:
                return []

        for d1 in children(base):
            yield d1
            n += 1
            if n >= self.max_groups:
                return
            for d2 in children(d1):
                yield d2
                n += 1
                if n >= self.max_groups:
                    return

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        """→ (CGROUP_DT records, NAME_INTERN records for the paths)."""
        recs = []
        names = []
        ncpu = os.cpu_count() or 1
        seen = set()
        for d in self._dirs():
            key = str(d)
            seen.add(key)
            try:
                cur = _CgSample(d, self.v2, str(self.root))
            except (OSError, ValueError):
                continue
            prev = self._prev.get(key)
            self._prev[key] = cur
            if prev is None:
                continue                  # need a delta
            dt = max(cur.t - prev.t, 1e-3)
            r = np.zeros((), wire.CGROUP_DT)
            disp = "/" + str(d.relative_to(self._base)) \
                if d != self._base else "/"
            dir_id = InternTable.intern(disp, wire.NAME_KIND_MISC)
            r["cg_id"] = np.uint64(dir_id) ^ np.uint64(self.host_id)
            r["dir_id"] = dir_id
            # cpu% normalized to one core (matches sim semantics)
            r["cpu_pct"] = min(
                (cur.cpu_usec - prev.cpu_usec) / (dt * 1e4), 1e4)
            r["cpu_limit_pct"] = cur.cpu_limit_pct
            dper = cur.nr_periods - prev.nr_periods
            dthr = cur.nr_throttled - prev.nr_throttled
            r["cpu_throttled_pct"] = 100.0 * dthr / dper if dper else 0.0
            r["rss_mb"] = cur.rss / (1 << 20)
            r["memory_limit_mb"] = (cur.mem_limit / (1 << 20)
                                    if cur.mem_limit > 0 else -1.0)
            r["pgmajfault_sec"] = (cur.pgmaj - prev.pgmaj) / dt
            r["nprocs"] = cur.nprocs
            r["is_v2"] = self.v2
            thr = float(r["cpu_throttled_pct"])
            busy = float(r["cpu_pct"]) > 90.0 * ncpu
            r["state"] = 3 if (thr > 25.0 or busy) else 1
            r["host_id"] = self.host_id
            recs.append(r)
            names.append((wire.NAME_KIND_MISC, dir_id, disp))
        # evict samples for cgroups that vanished (pod churn would grow
        # the baseline dict without bound otherwise)
        for key in [k for k in self._prev if k not in seen]:
            del self._prev[key]
        rec_arr = (np.array(recs, dtype=wire.CGROUP_DT)
                   if recs else np.empty(0, wire.CGROUP_DT))
        return rec_arr, InternTable.records(names)


# ----------------------------------------------------------------- mounts
_NETWORK_FS = {"nfs", "nfs4", "cifs", "smbfs", "glusterfs", "cephfs",
               "ocfs2", "afs", "9p", "fuse.sshfs"}
_SKIP_FS = {"proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup",
            "cgroup2", "securityfs", "debugfs", "tracefs", "configfs",
            "pstore", "bpf", "mqueue", "hugetlbfs", "autofs", "ramfs",
            "binfmt_misc", "fusectl", "rpc_pipefs",
            "squashfs", "nsfs", "efivarfs"}
# NOTE: overlay is NOT skipped — a containerized agent's rootfs is
# overlayfs and filling its writable layer is exactly the disk-full
# signal mount monitoring exists for


class MountCollector:
    """Mount/filesystem inventory with freespace (the MOUNT_HDLR
    capability, ``common/gy_mount_disk.h:233``): /proc/self/mounts +
    statvfs per real filesystem; pseudo-filesystems are skipped the
    way the reference's fscategory filter does."""

    def __init__(self, host_id: int = 0, max_mounts: int = 256,
                 env=None):
        self.host_id = host_id
        self.max_mounts = max_mounts
        # GYT_STAT_NETFS=1 opts network mounts into statvfs
        self.stat_netfs = bool(({} if env is None else env).get(
            "GYT_STAT_NETFS"))

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        from gyeeta_tpu_torch.utils import hashing as H

        rows, names = [], []
        seen = set()
        for line in _read("/proc/self/mounts").splitlines():
            p = line.split()
            if len(p) < 3:
                continue
            dev, mnt, fstype = p[0], p[1], p[2]
            base_fs = fstype.split(".", 1)[0]
            if fstype in _SKIP_FS or base_fs in _SKIP_FS:
                continue
            mnt = mnt.replace("\\040", " ")
            if mnt in seen or len(rows) >= self.max_mounts:
                continue
            seen.add(mnt)
            is_netfs = (base_fs in _NETWORK_FS or fstype in _NETWORK_FS)
            if is_netfs and not self.stat_netfs:
                # a hung NFS/CIFS server turns statvfs into an
                # UNINTERRUPTIBLE sleep that would freeze the agent's
                # whole event loop — inventory network mounts without
                # touching them (GYT_STAT_NETFS=1 opts in)
                size_mb = free_mb = 0.0
                st = None
            else:
                try:
                    st = os.statvfs(mnt)
                except OSError:
                    continue
                size_mb = st.f_blocks * st.f_frsize / (1 << 20)
                if size_mb <= 0:
                    continue
                free_mb = st.f_bavail * st.f_frsize / (1 << 20)
            r = np.zeros((), wire.MOUNT_DT)
            dir_id = InternTable.intern(mnt, wire.NAME_KIND_MISC)
            fs_id = InternTable.intern(fstype, wire.NAME_KIND_MISC)
            r["mnt_id"] = H.hash_bytes_np(
                f"{dev}:{mnt}".encode()) or 1
            r["dir_id"], r["fstype_id"] = dir_id, fs_id
            r["size_mb"] = size_mb
            r["free_mb"] = free_mb
            r["used_pct"] = (100.0 * (1.0 - free_mb / size_mb)
                             if size_mb else 0.0)
            tot_i = st.f_files if st is not None else 0
            r["inodes_used_pct"] = (
                100.0 * (tot_i - st.f_favail) / tot_i if tot_i else 0.0)
            r["is_network_fs"] = is_netfs
            r["host_id"] = self.host_id
            rows.append(r)
            names += [(wire.NAME_KIND_MISC, dir_id, mnt),
                      (wire.NAME_KIND_MISC, fs_id, fstype)]
        recs = (np.stack(rows) if rows
                else np.empty(0, wire.MOUNT_DT))
        return recs, InternTable.records(names) if names \
            else np.empty(0, wire.NAME_INTERN_DT)


# ------------------------------------------------------------ interfaces
class NetIfCollector:
    """Interface inventory + rate deltas (the NET_IF_HDLR capability,
    ``common/gy_netif.h:708``): /sys/class/net statistics swept on the
    agent cadence; loopback included (it carries real traffic in
    single-box deployments)."""

    def __init__(self, host_id: int = 0, max_ifs: int = 64):
        self.host_id = host_id
        self.max_ifs = max_ifs
        self._prev: dict[str, tuple] = {}
        self._t_prev = 0.0

    @staticmethod
    def _stat(ifname: str, stat: str) -> int:
        try:
            return int(_read(
                f"/sys/class/net/{ifname}/statistics/{stat}") or 0)
        except ValueError:
            return 0

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        now = time.monotonic()
        dt = max(now - self._t_prev, 1e-3) if self._t_prev else 0.0
        self._t_prev = now
        try:
            allifs = sorted(os.listdir("/sys/class/net"))
        except OSError:
            allifs = []
        # physical interfaces FIRST under the cap: a k8s node's 100+
        # veth/cali* names must never crowd out the real uplink
        phys = [i for i in allifs
                if os.path.exists(f"/sys/class/net/{i}/device")]
        rest = [i for i in allifs if i not in set(phys)]
        ifs = (phys + rest)[: self.max_ifs]
        rows, names = [], []
        from gyeeta_tpu_torch.utils import hashing as H
        for ifname in ifs:
            cur = (self._stat(ifname, "rx_bytes"),
                   self._stat(ifname, "tx_bytes"),
                   self._stat(ifname, "rx_errors"),
                   self._stat(ifname, "tx_errors"))
            prev = self._prev.get(ifname)
            self._prev[ifname] = cur
            if prev is None or not dt:
                continue                  # need a delta baseline
            r = np.zeros((), wire.NETIF_DT)
            name_id = InternTable.intern(ifname, wire.NAME_KIND_MISC)
            r["if_id"] = H.hash_bytes_np(b"IF" + ifname.encode()) or 1
            r["name_id"] = name_id
            try:
                r["speed_mbps"] = float(
                    _read(f"/sys/class/net/{ifname}/speed") or -1)
            except ValueError:
                r["speed_mbps"] = -1.0
            r["rx_mb_sec"] = max(cur[0] - prev[0], 0) / dt / (1 << 20)
            r["tx_mb_sec"] = max(cur[1] - prev[1], 0) / dt / (1 << 20)
            r["rx_errs_sec"] = max(cur[2] - prev[2], 0) / dt
            r["tx_errs_sec"] = max(cur[3] - prev[3], 0) / dt
            oper = _read(f"/sys/class/net/{ifname}/operstate").strip()
            r["is_up"] = oper in ("up", "unknown")   # lo says unknown
            r["host_id"] = self.host_id
            rows.append(r)
            names.append((wire.NAME_KIND_MISC, name_id, ifname))
        # forget vanished interfaces
        for k in [k for k in self._prev if k not in set(ifs)]:
            del self._prev[k]
        recs = (np.stack(rows) if rows
                else np.empty(0, wire.NETIF_DT))
        return recs, InternTable.records(names) if names \
            else np.empty(0, wire.NAME_INTERN_DT)
