"""The port's host collectors and cloud probe against the reference's.

Each collector of both packages reads the same fixed ``/proc`` and
``/sys`` text (each module's ``_read`` replaced by one fake file system,
the clock pinned) and must give byte-equal records and name
announcements: ``_fields`` and ``_cpu_pcts``, ``CpuMemCollector``,
``collect_host_info``, ``CgroupCollector`` over a fake v2 and v1 tree
(``root=``), ``MountCollector`` and ``NetIfCollector``. The knobs the
port reads from an ``env`` mapping (the container marker,
``GYT_CLOUD_META``/``GYT_CLOUD_META_URL``, ``GYT_STAT_NETFS``) give what
the reference gives with the same variables in ``os.environ``; the
cloud probe answers a local fake IMDS server alike for AWS, GCP and
Azure. Everything compared is exact.
"""

import http.server
import os
import threading
import time

import pytest

from gyeeta_tpu.net import collect as j_col
from gyeeta_tpu.utils import cloudmeta as j_cm
from gyeeta_tpu_torch.net import collect as t_col
from gyeeta_tpu_torch.utils import cloudmeta as t_cm

STAT0 = """cpu  100 5 50 1000 20 0 3 0 0 0
cpu0 50 2 25 500 10 0 1 0 0 0
cpu1 50 3 25 500 10 0 2 0 0 0
intr 12345
ctxt 5000
btime 1700000000
processes 800
procs_running 3
procs_blocked 0
"""
STAT1 = """cpu  160 5 80 1100 30 0 4 0 0 0
cpu0 90 2 45 540 14 0 1 0 0 0
cpu1 70 3 35 560 16 0 3 0 0 0
intr 22345
ctxt 9000
btime 1700000000
processes 830
procs_running 5
procs_blocked 1
"""
VMSTAT0 = "pgpgin 100\npgpgout 50\npswpin 1\npswpout 2\noom_kill 0\n" \
    "allocstall_dma 1\nallocstall_normal 2\n"
VMSTAT1 = "pgpgin 900\npgpgout 450\npswpin 5\npswpout 9\noom_kill 1\n" \
    "allocstall_dma 3\nallocstall_normal 7\n"
MEMINFO = """MemTotal:       32768000 kB
MemFree:         1000000 kB
MemAvailable:   20000000 kB
SwapTotal:       2048000 kB
SwapFree:        1024000 kB
CommitLimit:    18432000 kB
Committed_AS:    9000000 kB
"""
OSREL = 'NAME="Debian GNU/Linux"\nPRETTY_NAME="Debian GNU/Linux 12"\n'
CPUINFO = "processor\t: 0\nmodel name\t: Fake CPU @ 2.0GHz\n" \
    "flags\t\t: fpu hypervisor\n"
MOUNTS = """/dev/sda1 / ext4 rw,relatime 0 0
proc /proc proc rw 0 0
tmpfs /run tmpfs rw 0 0
server:/export /mnt/nfs nfs4 rw 0 0
/dev/sdb1 /data\\040dir xfs rw 0 0
overlay /var/lib/docker/overlay2/x/merged overlay rw 0 0
/dev/sdb1 /data\\040dir xfs rw 0 0
"""
NETIFS = ("eth0", "lo", "veth1")


class FakeFS:
    """One mapping of path → text served to both packages' ``_read``."""

    def __init__(self, files):
        self.files = dict(files)

    def read(self, path):
        return self.files.get(str(path), "")


@pytest.fixture
def fs(monkeypatch):
    f = FakeFS({"/proc/stat": STAT0, "/proc/vmstat": VMSTAT0,
                "/proc/meminfo": MEMINFO, "/etc/os-release": OSREL,
                "/proc/cpuinfo": CPUINFO, "/proc/self/mounts": MOUNTS})
    for mod in (j_col, t_col):
        monkeypatch.setattr(mod, "_read", f.read)
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    f.clock = clock
    return f


@pytest.mark.parametrize("text", [STAT1, VMSTAT1, MEMINFO, OSREL, "",
                                  "a\nb: 1\n c  2 3\n"])
def test_fields_equal(text):
    assert t_col._fields(text) == j_col._fields(text)


@pytest.mark.parametrize("rows", [
    ([100, 5, 50, 1000, 20, 0, 3, 0, 0, 0],
     [160, 5, 80, 1100, 30, 0, 4, 0, 0, 0]),
    ([0] * 10, [0] * 10),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13, 14, 15, 16, 17, 18, 19,
                                       20])])
def test_cpu_pcts_equal(rows):
    import numpy as np
    a, b = (np.array(r, np.float64) for r in rows)
    assert t_col._cpu_pcts(a, b) == j_col._cpu_pcts(a, b)


def test_cpumem_records_equal(fs):
    cols = [m.CpuMemCollector(host_id=7) for m in (j_col, t_col)]
    fs.files.update({"/proc/stat": STAT1, "/proc/vmstat": VMSTAT1})
    fs.clock[0] += 2.0
    j, t = (c.sample() for c in cols)
    assert t.tobytes() == j.tobytes()
    assert float(t["cpu_pct"][0]) > 0 and int(t["host_id"][0]) == 7


@pytest.mark.parametrize("container", [None, "podman"])
def test_host_info_equal(fs, monkeypatch, container):
    if container:
        monkeypatch.setenv("container", container)
    else:
        monkeypatch.delenv("container", raising=False)
    monkeypatch.delenv("GYT_CLOUD_META", raising=False)
    j = j_col.collect_host_info(host_id=3)
    t = t_col.collect_host_info(
        host_id=3, env={"container": container} if container else None)
    assert t[0].tobytes() == j[0].tobytes()
    assert t[1].tobytes() == j[1].tobytes()
    if container:
        assert int(t[0]["virt_type"][0]) == 2


def _cg_tree(root, v2):
    """A fake cgroup tree (two levels) with the counters the sampler
    reads."""
    if v2:
        (root / "cgroup.controllers").write_text("cpu memory pids\n")
        dirs = [root, root / "a", root / "a" / "x", root / "b"]
        for i, d in enumerate(dirs):
            d.mkdir(parents=True, exist_ok=True)
            (d / "cpu.stat").write_text(
                f"usage_usec {1000 * (i + 1)}\nnr_periods {10 * i}\n"
                f"nr_throttled {i}\n")
            (d / "memory.current").write_text(f"{(i + 1) << 20}\n")
            (d / "memory.max").write_text("max\n" if i % 2 else
                                          f"{(i + 4) << 20}\n")
            (d / "cpu.max").write_text("50000 100000\n" if i else
                                       "max 100000\n")
            (d / "memory.stat").write_text(f"pgmajfault {i * 3}\n")
            (d / "pids.current").write_text(f"{i + 2}\n")
        return dirs
    dirs = []
    for ctrl in ("cpu", "cpuacct", "memory"):
        for sub in ("", "/a", "/a/x"):
            d = root / (ctrl + sub)
            d.mkdir(parents=True, exist_ok=True)
            (d / "cpuacct.usage").write_text("5000000\n")
            (d / "cpu.stat").write_text("nr_periods 20\nnr_throttled 2\n")
            (d / "memory.usage_in_bytes").write_text(f"{3 << 20}\n")
            (d / "memory.limit_in_bytes").write_text(f"{8 << 20}\n")
            (d / "memory.stat").write_text("pgmajfault 4\n")
            (d / "cgroup.procs").write_text("1\n2\n")
            if ctrl == "cpu":
                dirs.append(d)
    return dirs


def _bump_tree(root, dirs, v2):
    """The counters a sweep later: cpu time, throttling, major faults."""
    for i, d in enumerate(dirs):
        if v2:
            (d / "cpu.stat").write_text(
                f"usage_usec {1000 * (i + 1) + 50000 * (i + 1)}\n"
                f"nr_periods {10 * i + 20}\nnr_throttled {i + 5}\n")
            (d / "memory.stat").write_text(f"pgmajfault {i * 3 + 7}\n")
        else:
            sub = d.relative_to(root / "cpu")
            (d / "cpu.stat").write_text("nr_periods 40\nnr_throttled 12\n")
            (root / "cpuacct" / sub / "cpuacct.usage").write_text(
                f"{5000000 + 700000 * (i + 1)}\n")


@pytest.mark.parametrize("v2", [True, False], ids=["v2", "v1"])
def test_cgroup_records_equal(tmp_path, monkeypatch, v2):
    clock = [500.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    dirs = _cg_tree(tmp_path, v2)
    cols = [m.CgroupCollector(host_id=4, root=str(tmp_path))
            for m in (j_col, t_col)]
    for c in cols:
        c.sample()                       # the delta baseline
    _bump_tree(tmp_path, dirs, v2)
    clock[0] += 5.0
    (jr, jn), (tr, tn) = (c.sample() for c in cols)
    assert len(tr) == len(jr) > 0
    assert tr.tobytes() == jr.tobytes()
    assert tn.tobytes() == jn.tobytes()


@pytest.mark.parametrize("netfs", [False, True], ids=["skip_netfs",
                                                      "stat_netfs"])
def test_mount_records_equal(fs, monkeypatch, netfs):
    class St:
        f_blocks, f_frsize, f_bavail = 1000000, 4096, 250000
        f_files, f_favail = 65536, 60000
    monkeypatch.setattr(os, "statvfs", lambda p: St())
    if netfs:
        monkeypatch.setenv("GYT_STAT_NETFS", "1")
    else:
        monkeypatch.delenv("GYT_STAT_NETFS", raising=False)
    jr, jn = j_col.MountCollector(host_id=2).sample()
    tr, tn = t_col.MountCollector(
        host_id=2, env={"GYT_STAT_NETFS": "1"} if netfs else {}).sample()
    assert len(tr) == len(jr) == 4
    assert tr.tobytes() == jr.tobytes()
    assert tn.tobytes() == jn.tobytes()
    nfs = tr[tr["is_network_fs"].astype(bool)]
    assert (float(nfs["size_mb"][0]) > 0) == netfs


def test_netif_records_equal(fs, monkeypatch):
    real_listdir, real_exists = os.listdir, os.path.exists
    monkeypatch.setattr(os, "listdir", lambda p: list(NETIFS)
                        if p == "/sys/class/net" else real_listdir(p))
    monkeypatch.setattr(os.path, "exists", lambda p: p in (
        "/sys/class/net/eth0/device",) or (
        real_exists(p) if not str(p).startswith("/sys/class/net")
        else False))

    def stats(k):
        for i, ifn in enumerate(NETIFS):
            base = f"/sys/class/net/{ifn}"
            fs.files.update({
                f"{base}/statistics/rx_bytes": str((i + 1) * k * 10 ** 6),
                f"{base}/statistics/tx_bytes": str((i + 2) * k * 10 ** 5),
                f"{base}/statistics/rx_errors": str(k * i),
                f"{base}/statistics/tx_errors": str(k),
                f"{base}/speed": "10000" if ifn == "eth0" else "",
                f"{base}/operstate": "unknown" if ifn == "lo" else "up"})
    stats(1)
    cols = [m.NetIfCollector(host_id=5) for m in (j_col, t_col)]
    for c in cols:
        c.sample()
    stats(3)
    fs.clock[0] += 5.0
    (jr, jn), (tr, tn) = (c.sample() for c in cols)
    assert len(tr) == len(jr) == len(NETIFS)
    assert tr.tobytes() == jr.tobytes()
    assert tn.tobytes() == jn.tobytes()


# ----------------------------------------------------------- cloud probe
class _FakeIMDS(http.server.BaseHTTPRequestHandler):
    mode = "aws"

    def log_message(self, *a):
        pass

    def _send(self, body: str, code: int = 200):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_PUT(self):
        if self.mode == "aws" and self.path == "/latest/api/token":
            return self._send("tok-9")
        self._send("", 404)

    def do_GET(self):
        m, p = self.mode, self.path
        if m == "aws" and self.headers.get(
                "X-aws-ec2-metadata-token") == "tok-9":
            if p == "/latest/meta-data/instance-id":
                return self._send("i-0port")
            if p.endswith("availability-zone"):
                return self._send("eu-north-1c")
        elif m == "gcp" and self.headers.get("Metadata-Flavor") == "Google":
            if p == "/computeMetadata/v1/instance/id":
                return self._send("771")
            if p == "/computeMetadata/v1/instance/zone":
                return self._send("projects/9/zones/asia-south1-b")
        elif m == "azure" and p.startswith("/metadata/instance/compute") \
                and self.headers.get("Metadata") == "true":
            return self._send('{"vmId": "az-7", "location": "uksouth", '
                              '"zone": "3"}')
        self._send("", 404)


@pytest.fixture
def imds():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _FakeIMDS)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    for mod in (j_cm, t_cm):
        mod._cached.clear()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    for mod in (j_cm, t_cm):
        mod._cached.clear()


def test_cloud_probe_gated_off(monkeypatch):
    monkeypatch.delenv("GYT_CLOUD_META", raising=False)
    assert j_cm.detect() is None
    assert t_cm.detect() is None and t_cm.detect(env={}) is None
    # the port never reads os.environ: the gate is the mapping
    monkeypatch.setenv("GYT_CLOUD_META", "1")
    monkeypatch.setenv("GYT_CLOUD_META_URL", "http://127.0.0.1:9")
    assert t_cm.detect() is None


@pytest.mark.parametrize("mode", ["aws", "gcp", "azure"])
def test_cloud_probe_equal(imds, monkeypatch, mode):
    monkeypatch.setattr(_FakeIMDS, "mode", mode)
    monkeypatch.setenv("GYT_CLOUD_META", "1")
    monkeypatch.setenv("GYT_CLOUD_META_URL", imds)
    j = j_cm.detect()
    t = t_cm.detect(env={"GYT_CLOUD_META": "1",
                         "GYT_CLOUD_META_URL": imds})
    assert t == j and t["cloud_type"] > 0
    assert t_cm.detect(base=imds) == j_cm.detect(base=imds)


def test_host_info_cloud_fields_equal(fs, imds, monkeypatch):
    monkeypatch.setattr(_FakeIMDS, "mode", "aws")
    monkeypatch.setenv("GYT_CLOUD_META", "1")
    monkeypatch.setenv("GYT_CLOUD_META_URL", imds)
    monkeypatch.delenv("container", raising=False)
    j = j_col.collect_host_info(host_id=1)
    t = t_col.collect_host_info(host_id=1, env={
        "GYT_CLOUD_META": "1", "GYT_CLOUD_META_URL": imds})
    assert t[0].tobytes() == j[0].tobytes()
    assert t[1].tobytes() == j[1].tobytes()
    assert int(t[0]["cloud_type"][0]) == t_cm.CLOUD_AWS
