"""The port's host-side registries against the reference's, class by
class: the same seeded records into both, the same columns out.

Covered: ``SvcInfoRegistry`` (with ``format_ip``), ``HostInfoRegistry``,
``CgroupRegistry``, ``MountRegistry`` and ``NetIfRegistry`` with their
``age()`` over several ticks, ``NatClusterRegistry`` (direct VIP rows,
split halves resolved by the backend's own accept half, ageing),
``TraceConnRegistry`` (tallies, eviction, ageing, the ``csvc`` flag),
``TagRegistry``, ``DnsCache`` (primed; a miss resolves on the
background thread, which ``close`` joins), ``TraceDefs``, ``NotifyLog``
and ``droppressure.check``; the query-side joins of ``query/api.py``;
the sim's inventory records and frames byte for byte; and the staging
slabs: ``conn_slab``/``resp_slab(out=, clear_to=)`` over a long slab
then a short one equal the reference's, with no stale lane. Columns
match exactly: strings, ints, bools and floats.
"""

import socket

import numpy as np
import pytest
import torch

from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.query import api as j_api
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.trace import defs as j_td
from gyeeta_tpu.utils import dnsmap as j_dns, droppressure as j_dp
from gyeeta_tpu.utils import hostreg as j_host, natreg as j_nat
from gyeeta_tpu.utils import notifylog as j_nl, selfstats as j_ss
from gyeeta_tpu.utils import svcreg as j_svc, tagreg as j_tag
from gyeeta_tpu.utils import traceconnreg as j_tc
from gyeeta_tpu.utils.intern import InternTable as JNames
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.query import api as t_api
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.trace import defs as t_td
from gyeeta_tpu_torch.utils import dnsmap as t_dns, droppressure as t_dp
from gyeeta_tpu_torch.utils import hostreg as t_host, natreg as t_nat
from gyeeta_tpu_torch.utils import notifylog as t_nl, selfstats as t_ss
from gyeeta_tpu_torch.utils import svcreg as t_svc, tagreg as t_tag
from gyeeta_tpu_torch.utils import traceconnreg as t_tc
from gyeeta_tpu_torch.utils.intern import InternTable as TNames

SIM_KW = dict(n_hosts=6, n_svcs=5, n_clients=128, seed=21)


@pytest.fixture(autouse=True)
def no_lookups(monkeypatch):
    """No name resolution leaves the process: a cache miss resolves to
    nothing, as an unresolvable address does."""
    def refuse(*a, **kw):
        raise OSError("no lookups in tests")
    monkeypatch.setattr(socket, "getnameinfo", refuse)


def assert_cols_equal(ref, got, what=""):
    (rc, rm), (gc, gm) = ref, got
    np.testing.assert_array_equal(gm, rm, err_msg=f"{what} mask")
    assert list(gc) == list(rc), what
    for k in rc:
        a, b = np.asarray(rc[k]), np.asarray(gc[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{k}")


def _names(sim_j, sim_t):
    jn, tn = JNames(), TNames()
    jn.update(sim_j.name_records())
    tn.update(sim_t.name_records())
    assert tn.version == jn.version == 1 and len(tn) == len(jn)
    return jn, tn


def _sims():
    return JSim(**SIM_KW), TSim(**SIM_KW)


def mount_records(w, n_hosts, tick, per_host=3):
    n = n_hosts * per_host
    out = np.zeros(n, w.MOUNT_DT)
    out["host_id"] = np.repeat(np.arange(n_hosts), per_host)
    out["mnt_id"] = np.arange(n) * 31 + 5
    out["dir_id"] = np.arange(n) % per_host + 900
    out["fstype_id"] = 4
    out["size_mb"] = 5000.0
    out["free_mb"] = (np.arange(n) * 97 + tick * 13) % 5000
    out["used_pct"] = 100.0 - out["free_mb"] / 50.0
    out["inodes_used_pct"] = np.arange(n) % 9
    out["is_network_fs"] = np.arange(n) % 2
    return out


def netif_records(w, n_hosts, tick, per_host=2):
    n = n_hosts * per_host
    out = np.zeros(n, w.NETIF_DT)
    out["host_id"] = np.repeat(np.arange(n_hosts), per_host)
    out["if_id"] = np.arange(n) * 17 + 1
    out["name_id"] = np.arange(n) % per_host + 700
    out["speed_mbps"] = 1000.0
    out["rx_mb_sec"] = (np.arange(n) + tick) % 40
    out["tx_mb_sec"] = (np.arange(n) * 3 + tick) % 30
    out["rx_errs_sec"] = np.arange(n) % 2
    out["tx_errs_sec"] = tick % 3
    out["is_up"] = np.arange(n) % 5 != 2
    return out


def registry_frames(sim, w, tick, nat_flows=6):
    """One tick's announce-rate records for a runtime stream: listener
    and host inventories on ticks 0 and 2 (the second a resend), the
    cgroup, mount and interface sweeps every tick (a partial one on
    tick 3), and service flows dialled through a VIP."""
    out = b""
    if tick in (0, 2):
        out += (w.encode_frames_chunked(w.NOTIFY_LISTENER_INFO,
                                        sim.listener_info_records())
                + sim.host_info_frames())
    cg = sim.cgroup_records()
    mnt = mount_records(w, sim.n_hosts, tick)
    nif = netif_records(w, sim.n_hosts, tick)
    if tick == 3:
        cg, mnt, nif = cg[::2], mnt[1:], nif[:-3]
    return (out + w.encode_frames_chunked(w.NOTIFY_CGROUP_STATE, cg)
            + w.encode_frames_chunked(w.NOTIFY_MOUNT_STATE, mnt)
            + w.encode_frames_chunked(w.NOTIFY_NETIF_STATE, nif)
            + w.encode_frames_chunked(
                w.NOTIFY_TCP_CONN, sim.svc_conn_records(nat_flows,
                                                        nat=True)))


def runtime_ops(sim):
    """CRUD requests a runtime stream installs before its first tick:
    realtime alertdefs over svcstate, hoststate, cpumem and taskstate
    (two sharing one canonical filter, one with group-wait), a windowed
    and a db-mode def, a silence, an inhibit, a tracedef and a tag."""
    defs = [
        {"alertname": "svc_qps", "subsys": "svcstate",
         "filter": "{ svcstate.qps5s > 30 }", "numcheckfor": 2},
        {"alertname": "svc_qps_crit", "subsys": "svcstate",
         "filter": "{svcstate.qps5s>30.0}", "severity": "critical"},
        {"alertname": "svc_state", "subsys": "svcstate",
         "filter": "{ svcstate.state in 'OK','Bad','Severe' }",
         "groupwaitsec": 7},
        {"alertname": "host_procs", "subsys": "hoststate",
         "filter": "{ hoststate.nprocissue > 0 }"},
        {"alertname": "cpu_hot", "subsys": "cpumem",
         "filter": "{ cpumem.cpu > 50 }"},
        {"alertname": "task_cpu", "subsys": "taskstate",
         "filter": "{ taskstate.cpu > 20 }", "repeataftersec": 8},
        {"alertname": "svc_qps_15m", "subsys": "svcstate",
         "filter": "{ svcstate.qps5s > 30 }", "window": "15m"},
        {"alertname": "svc_db", "subsys": "svcstate",
         "filter": "{ svcstate.qps5s > 30 }", "mode": "db"},
    ]
    return ([dict(d, op="add", objtype="alertdef") for d in defs] + [
        {"op": "add", "objtype": "silence", "name": "quiet_tasks",
         "alertnames": ["task_cpu"]},
        {"op": "add", "objtype": "silence", "name": "quiet_host0",
         "filter": "{ svcstate.hostid = 0 }",
         "alertnames": ["svc_qps_crit"]},
        {"op": "add", "objtype": "inhibit", "name": "procs_over_cpu",
         "src_alertnames": ["host_procs"], "target_alertnames": ["cpu_hot"]},
        {"op": "add", "objtype": "tracedef", "name": "http",
         "filter": "{ svcinfo.ishttp = true }"},
        {"op": "add", "objtype": "tag", "tag": "frontend",
         "taskid": format(int(sim.task_ids[0, 0]), "016x")},
    ])


def prime_vips(rt, ips=None) -> list:
    """Prime a runtime's DNS cache with a name for every VIP of its
    svcipclust view (or for ``ips``) → the addresses primed."""
    if ips is None:
        cols, _ = rt.natclusters.columns()
        ips = sorted({str(v).rsplit(":", 1)[0] for v in cols["vip"]})
    for ip in ips:
        rt.dns.prime(ip, f"vip-{ip.replace('.', '-')}.svc.local")
    return ips


# ------------------------------------------------------------ format_ip
@pytest.mark.parametrize("raw", [
    bytes(10) + b"\xff\xff" + bytes([10, 1, 2, 3]),
    bytes(range(16)),
    bytes(16),
    b"\xfe\x80" + bytes(13) + b"\x01",
])
def test_format_ip_matches_reference(raw):
    a = np.frombuffer(raw, np.uint8)
    assert t_svc.format_ip(a) == j_svc.format_ip(a)


# ---------------------------------------------------------- svcinfo
@pytest.mark.parametrize("with_names", [False, True])
def test_svcinfo_registry_matches_reference(with_names):
    js, ts = _sims()
    jn, tn = _names(js, ts) if with_names else (None, None)
    jr, tr = j_svc.SvcInfoRegistry(), t_svc.SvcInfoRegistry()
    recs = js.listener_info_records()
    assert recs.tobytes() == ts.listener_info_records().tobytes()
    assert tr.update(recs[:17]) == jr.update(recs[:17]) == 17
    assert_cols_equal(jr.columns(jn), tr.columns(tn), "svcinfo")
    # a resend and the rest: updates in place, cache invalidated
    tr.update(recs), jr.update(recs)
    assert len(tr) == len(jr) == len(recs)
    assert_cols_equal(jr.columns(jn), tr.columns(tn), "svcinfo")
    gid = int(recs["glob_id"][3])
    assert tr.get(gid) == jr.get(gid) and tr.get(12345) is None
    assert tr.columns(tn) is tr.columns(tn)      # cached per names


# ------------------------------------------------- host inventories
def _host_regs(kind):
    return {"hostinfo": (j_host.HostInfoRegistry, t_host.HostInfoRegistry),
            "cgroup": (j_host.CgroupRegistry, t_host.CgroupRegistry),
            "mount": (j_host.MountRegistry, t_host.MountRegistry),
            "netif": (j_host.NetIfRegistry, t_host.NetIfRegistry)}[kind]


def _inventory(kind, js, ts, tick):
    if kind == "hostinfo":
        a, b = js.host_info_records(), ts.host_info_records()
    elif kind == "cgroup":
        a, b = js.cgroup_records(), ts.cgroup_records()
    elif kind == "mount":
        a = mount_records(j_wire, js.n_hosts, tick)
        b = mount_records(t_wire, ts.n_hosts, tick)
    else:
        a = netif_records(j_wire, js.n_hosts, tick)
        b = netif_records(t_wire, ts.n_hosts, tick)
    assert a.tobytes() == b.tobytes()
    return a


@pytest.mark.parametrize("with_names", [False, True])
@pytest.mark.parametrize("kind", ["hostinfo", "cgroup", "mount", "netif"])
def test_host_registry_and_ageing_match_reference(kind, with_names):
    """Six sweeps, the later ones partial (the first third of the rows
    stop reporting), with ``age()`` between ticks at ``max_age=2``: the
    silent rows age out on the same tick in both packages."""
    js, ts = _sims()
    jn, tn = _names(js, ts) if with_names else (None, None)
    jcls, tcls = _host_regs(kind)
    ageing = kind != "hostinfo"
    jr, tr = (jcls(max_age=2), tcls(max_age=2)) if ageing \
        else (jcls(), tcls())
    for tick in range(6):
        recs = _inventory(kind, js, ts, tick)
        if tick >= 2:
            recs = recs[len(recs) // 3:]
        assert tr.update(recs) == jr.update(recs)
        assert_cols_equal(jr.columns(jn), tr.columns(tn), f"{kind}@{tick}")
        if ageing:
            assert tr.age() == jr.age()
        assert len(tr) == len(jr)
    if ageing:
        assert len(tr) < len(_inventory(kind, js, ts, 9))
    assert_cols_equal(jr.columns(jn), tr.columns(tn), kind)


def test_host_info_get_matches_reference():
    js, ts = _sims()
    jr, tr = j_host.HostInfoRegistry(), t_host.HostInfoRegistry()
    jr.update(js.host_info_records()), tr.update(ts.host_info_records())
    for h in range(js.n_hosts + 1):
        assert tr.get(h) == jr.get(h)


# ------------------------------------------------------- NAT clusters
def _nat_stream(sim, tick):
    """Merged VIP rows, split halves (client half first, the backend's
    accept half in the same chunk or the next) and plain traffic."""
    merged = sim.svc_conn_records(30, nat=True)
    cli, ser = sim.svc_conn_records(12, split_halves=True, nat=True)
    plain = sim.conn_records(20)
    return [np.concatenate([merged, plain, cli]), ser] if tick % 2 \
        else [np.concatenate([merged, cli, ser, plain])]


@pytest.mark.parametrize("with_names", [False, True])
def test_nat_cluster_registry_matches_reference(with_names):
    js, ts = _sims()
    jn, tn = _names(js, ts) if with_names else (None, None)
    jr = j_nat.NatClusterRegistry(max_vips=16, max_age=3)
    tr = t_nat.NatClusterRegistry(max_vips=16, max_age=3)
    sizes = []
    for tick in range(8):
        jc, tc = _nat_stream(js, tick), _nat_stream(ts, tick)
        if tick >= 4:                 # VIP traffic stops: members age
            jc, tc = [js.conn_records(10)], [ts.conn_records(10)]
        for a, b in zip(jc, tc):
            assert a.tobytes() == b.tobytes()
            assert tr.observe_conns(b) == jr.observe_conns(a)
        assert_cols_equal(jr.columns(jn), tr.columns(tn), f"nat@{tick}")
        assert tr.age() == jr.age()
        assert len(tr) == len(jr)
        sizes.append(len(tr))
    assert max(sizes) > sizes[-1]


# ---------------------------------------------------- traced conns
def test_traceconn_registry_matches_reference():
    js, ts = _sims()
    jn, tn = _names(js, ts)
    jr, tr = j_tc.TraceConnRegistry(capacity=40), \
        t_tc.TraceConnRegistry(capacity=40)
    for tick in range(5):
        a, b = js.trace_records(60), ts.trace_records(60)
        assert a.tobytes() == b.tobytes()
        assert tr.observe(b) == jr.observe(a)
        task_ids = {format(int(t), "016x")
                    for t in a["cli_task_aggr_id"][::3]}
        for names in (None, (jn, tn)):
            ref = jr.columns(names and names[0], svc_task_ids=task_ids)
            got = tr.columns(names and names[1], svc_task_ids=task_ids)
            assert_cols_equal(ref, got, f"traceconn@{tick}")
        assert tr.age(max_idle_ticks=2) == jr.age(max_idle_ticks=2)
    assert len(tr) == len(jr) <= 40
    assert tr.observe(b[:0]) == jr.observe(a[:0]) == 0


# --------------------------------------------------------------- tags
def test_tag_registry_matches_reference():
    jr, tr = j_tag.TagRegistry(), t_tag.TagRegistry()
    ids = [format(i * 0x9E3779B97F4A7C15 & (2**64 - 1), "016x")
           for i in range(1, 6)]
    for r in (jr, tr):
        for i, t in enumerate(ids):
            r.set(t.upper() if i % 2 else t, f"team-{i}" + "x" * 200 * i)
        assert r.delete(ids[2]) and not r.delete(ids[2])
    assert_cols_equal(jr.columns(), tr.columns(), "tags")
    cols = {"taskid": np.array(ids + ["0" * 16], object),
            "cpu": np.arange(6.0)}
    mask = np.ones(6, bool)
    assert_cols_equal(jr.with_tags((cols, mask)),
                      tr.with_tags((cols, mask)), "procinfo tags")
    for bad in (("xyz", "t"), (ids[0], "")):
        with pytest.raises(ValueError) as a:
            jr.set(*bad)
        with pytest.raises(ValueError) as b:
            tr.set(*bad)
        assert str(a.value) == str(b.value)


# ---------------------------------------------------------------- DNS
def _colmask():
    vips = np.array(["10.254.0.1:80", "10.254.0.2:81", "10.254.0.1:80",
                     "fe80::1:443"], object)
    return {"vip": vips, "nsvc": np.arange(4.0)}, np.ones(4, bool)


def test_dns_cache_primed_matches_reference():
    now = [100.0]
    jc = j_dns.DnsCache(capacity=3, clock=lambda: now[0])
    tc = t_dns.DnsCache(capacity=3, clock=lambda: now[0])
    try:
        for c in (jc, tc):
            c.prime("10.254.0.1", "vip-a.local")
            c.prime("10.254.0.2", "vip-b.local", ttl=10.0)
            c.set("fe80::1", "link.local")
        assert_cols_equal(j_dns.annotate_vip_cols(_colmask(), jc),
                          t_dns.annotate_vip_cols(_colmask(), tc), "dns")
        assert len(tc) == len(jc) == 3
        now[0] += 20.0                # vip-b expired: stale name served
        for c in (jc, tc):
            c.prime("10.9.9.9", "new.local")      # full: oldest evicted
        assert len(tc) == len(jc) == 3
        assert tc.annotate(["10.9.9.9", "10.254.0.1"]) == \
            jc.annotate(["10.9.9.9", "10.254.0.1"])
        assert tc._thread is None and jc._thread is None
    finally:
        jc.close(), tc.close()


def test_dns_cache_miss_resolves_in_background_and_closes():
    """A miss answers '' at once and queues the address; the worker's
    failed lookup caches a negative entry; close() joins the thread."""
    jc, tc = j_dns.DnsCache(), t_dns.DnsCache()
    try:
        assert tc.get("10.1.2.3") == jc.get("10.1.2.3") == ""
        for c in (jc, tc):
            assert _wait(lambda c=c: "10.1.2.3" in c._cache)
        assert tc._cache["10.1.2.3"][0] == jc._cache["10.1.2.3"][0] == ""
        assert tc.get("10.1.2.3") == ""
    finally:
        jc.close(), tc.close()
    assert tc._thread is None and jc._thread is None


def _wait(cond, timeout=5.0):
    import time
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------- tracedefs
def _svcinfo_cols(js, ts):
    jr, tr = j_svc.SvcInfoRegistry(), t_svc.SvcInfoRegistry()
    jr.update(js.listener_info_records())
    tr.update(ts.listener_info_records())
    return jr.columns(), tr.columns()


def test_tracedefs_match_reference():
    js, ts = _sims()
    jcols, tcols = _svcinfo_cols(js, ts)
    now = [50.0]
    jd, td = j_td.TraceDefs(clock=lambda: now[0]), \
        t_td.TraceDefs(clock=lambda: now[0])
    defs = [{"name": "http", "filter": "{ svcinfo.ishttp = true }"},
            {"name": "port", "filter": "{ svcinfo.port > 8002 }",
             "tend": 60.0},
            {"name": "all"}]
    for d in defs:
        assert td.add(d) == jd.add(d)
    steps = []
    for step_ in range(4):
        jt = jd.target_svcids(lambda s: jcols)
        tt = td.target_svcids(lambda s: tcols)
        assert tt == jt
        hosts = None if step_ != 1 else [0, 1, 2]
        steps.append(td.diff_for_hosts(tt, hosts=hosts))
        assert steps[-1] == jd.diff_for_hosts(jt, hosts=hosts)
        assert_cols_equal(jd.columns(), td.columns(), f"tracedef@{step_}")
        assert td.status_rows() == jd.status_rows()
        now[0] += 6.0                 # "port" expires after step 1
        if step_ == 2:
            assert td.delete("all") and jd.delete("all")
            td.forget_host(3), jd.forget_host(3)
            en, dis = steps[0].get(4, ([], []))
            td.unapply(4, en, dis), jd.unapply(4, en, dis)
    assert any(steps) and not td.delete("nosuch")
    for bad in ({"filter": "{ svcinfo.port > 1 }"},
                {"name": "x", "filter": "{ svcinfo.nosuch > 1 }"}):
        with pytest.raises(Exception) as a:
            jd.add(bad)
        with pytest.raises(Exception) as b:
            td.add(bad)
        assert str(a.value) == str(b.value)


# ---------------------------------------------------------- notifylog
class _A:
    def __init__(self, name, sev, ent):
        self.alertname, self.severity, self.entity = name, sev, ent


def test_notifylog_matches_reference():
    now = [10.0]
    jl = j_nl.NotifyLog(maxlen=5, clock=lambda: now[0])
    tl = t_nl.NotifyLog(maxlen=5, clock=lambda: now[0])
    for i in range(8):
        now[0] += 1.5
        for lg in (jl, tl):
            if i % 3 == 0:
                lg.add_alert(_A(f"a{i}", ("info", "warning",
                                          "critical")[i % 3], f"svc{i}"))
            else:
                lg.add(f"msg {i}", ntype=("info", "warn", "error")[i % 3],
                       source="server")
    assert len(tl) == len(jl) == 5
    assert_cols_equal(jl.columns(), tl.columns(), "notifymsg")


# ------------------------------------------------------ drop pressure
def test_drop_pressure_matches_reference():
    """Six ticks of cumulative drop counters (growth, a severe jump,
    quiet, growth again): the same counters, gauges and notifications."""
    now = [0.0]
    caps = {"svc": 100, "task": 50, "api": 1 << 20, "dep": 1000}
    ticks = [{"svc": 0, "task": 0, "api": 0, "dep": 0},
             {"svc": 0, "task": 2, "api": 0, "dep": 0},
             {"svc": 5, "task": 2, "api": 1, "dep": 40},
             {"svc": 5, "task": 2, "api": 1, "dep": 40},
             {"svc": 5, "task": 2, "api": 1, "dep": 40},
             {"svc": 6, "task": 2, "api": 1, "dep": 41}]
    sides = []
    for dp, ss, nl in ((j_dp, j_ss, j_nl), (t_dp, t_ss, t_nl)):
        stats = ss.Stats()
        log = nl.NotifyLog(clock=lambda: now[0])
        last = {}
        lasts = []
        for d in ticks:
            last = dp.check(d, caps, last, log, stats)
            lasts.append(dict(last))
        sides.append((dict(stats.counters), dict(stats.gauges),
                      log.columns(), lasts))
    (jc, jg, jl, jla), (tc, tg, tl, tla) = sides
    assert tc == jc and tg == jg and tla == jla
    assert tc["drop_pressure_enter"] == 2 and tc["drop_pressure_exit"] == 1
    assert_cols_equal(jl, tl, "notifymsg")


# ------------------------------------------------------- query joins
def _svc_like(ids):
    return {"svcid": np.array(ids, object),
            "qps5s": np.arange(len(ids), dtype=np.float64)}


@pytest.mark.parametrize("idcol", ["svcid", "cliid"])
def test_info_join_matches_reference(idcol):
    js, ts = _sims()
    jinfo, tinfo = _svcinfo_cols(js, ts)
    ids = list(jinfo[0]["svcid"][::2]) + ["0" * 16, "f" * 16]
    cols = _svc_like(ids)
    cols[idcol] = cols.pop("svcid")
    live = np.arange(len(ids)) % 4 != 1
    assert_cols_equal(j_api.info_join(dict(cols), live, jinfo[0],
                                      idcol=idcol),
                      t_api.info_join(dict(cols), live, tinfo[0],
                                      idcol=idcol), "ext join")
    assert_cols_equal(j_api.info_join(dict(cols), live, {}, idcol=idcol),
                      t_api.info_join(dict(cols), live, {}, idcol=idcol),
                      "ext join, no info")


def test_svcprocmap_join_matches_reference():
    js, ts = _sims()
    jinfo, tinfo = _svcinfo_cols(js, ts)
    rel = list(jinfo[0]["relsvcid"][:7]) + ["0" * 16]
    tcols = {"taskid": np.array([format(i, "016x") for i in range(24)],
                                object),
             "relsvcid": np.array([rel[i % 8] for i in range(24)], object),
             "comm": np.array([f"p{i % 3}" for i in range(24)], object),
             "hostid": np.arange(24) % 6}
    tlive = np.arange(24) % 5 != 0
    assert_cols_equal(j_api.svcprocmap_join(tcols, tlive, jinfo[0]),
                      t_api.svcprocmap_join(tcols, tlive, tinfo[0]),
                      "svcprocmap")
    assert_cols_equal(j_api.svcprocmap_join(tcols, tlive, None),
                      t_api.svcprocmap_join(tcols, tlive, None),
                      "svcprocmap, no info")


# ------------------------------------------------------ sim inventory
@pytest.mark.parametrize("method", [
    "listener_info_records", "host_info_records", "cgroup_records",
    "host_info_frames", "cgroup_frames"])
def test_inventory_records_byte_identical(method):
    kw = dict(n_hosts=5, n_svcs=3, host_base=40, n_groups=4, seed=2)
    j, t = getattr(JSim(**kw), method)(), getattr(TSim(**kw), method)()
    assert (t if isinstance(t, bytes) else t.tobytes()) == \
        (j if isinstance(j, bytes) else j.tobytes())


@pytest.mark.parametrize("phase", range(3))
def test_churn_records_byte_identical(phase):
    js, ts = JSim(**SIM_KW), TSim(**SIM_KW)
    for p in range(phase + 1):
        jc, jr = js.churn_records(p, n_conn=50, n_resp=70)
        tc, tr = ts.churn_records(p, n_conn=50, n_resp=70)
    assert tc.tobytes() == jc.tobytes() and tr.tobytes() == jr.tobytes()


# ------------------------------------------------------ staging slabs
def _conn_resp(seed):
    sim = JSim(**SIM_KW)
    sim.rng = np.random.default_rng(seed)
    cli, ser = sim.svc_conn_records(20, split_halves=True, nat=True)
    return (np.concatenate([sim.conn_records(260), cli, ser]),
            sim.resp_records(300))


def _assert_batch_equal(ref, got, what):
    assert got._fields == ref._fields
    for f, a, b in zip(got._fields, ref, got):
        assert a.shape == b.shape, (what, f)
        # the port's u32 columns live in their int64 carrier
        np.testing.assert_array_equal(b, a.astype(b.dtype),
                                      err_msg=f"{what}.{f}")


@pytest.mark.parametrize("k,b", [(2, 128), (4, 64)])
def test_staging_slab_reuse_matches_reference(k, b):
    """Two staging buffers a side, flipped as the runtime flips them:
    a long fill, then a short one into the same buffer (``clear_to`` =
    the long fill's count) equals the reference's slab and a fresh
    slab: no lane of the long fill survives."""
    size = k * b
    conns, resps = _conn_resp(5)
    jbufs = [(j_dec.alloc_conn_cols(size), j_dec.alloc_resp_cols(size))
             for _ in range(2)]
    tbufs = [(t_dec.alloc_conn_cols(size), t_dec.alloc_resp_cols(size))
             for _ in range(2)]
    hw = [[0, 0], [0, 0]]
    fills = [(size, size), (size - 7, size // 3), (9, 2), (0, 17),
             (size // 2, size)]
    for i, (nc, nr) in enumerate(fills):
        side = i % 2
        c = [conns[:nc // 2], conns[nc // 2:nc]]
        r = resps[:nr]
        jcb = j_dec.conn_slab(c, k, b, out=jbufs[side][0],
                              clear_to=hw[side][0])
        jrb = j_dec.resp_slab(r, k, b, out=jbufs[side][1],
                              clear_to=hw[side][1])
        tcb = t_dec.conn_slab(c, k, b, out=tbufs[side][0],
                              clear_to=hw[side][0])
        trb = t_dec.resp_slab(r, k, b, out=tbufs[side][1],
                              clear_to=hw[side][1])
        hw[side] = [nc, nr]
        _assert_batch_equal(jcb, tcb, f"conn fill {i}")
        _assert_batch_equal(jrb, trb, f"resp fill {i}")
        _assert_batch_equal(t_dec.conn_slab(c, k, b), tcb, f"fresh {i}")
        _assert_batch_equal(t_dec.resp_slab(r, k, b), trb, f"fresh {i}")
        assert tcb.valid.sum() == nc and trb.valid.sum() == nr
        # the slab views the buffer: the decode wrote in place
        assert np.shares_memory(tcb.svc_hi, tbufs[side][0]["svc_hi"])


def test_staging_columns_use_the_u32_carrier():
    cols = t_dec.alloc_conn_cols(8)
    assert set(cols) == set(t_dec.ConnBatch._fields)
    assert cols["svc_hi"].dtype == np.int64
    assert set(t_dec.alloc_resp_cols(8)) == set(t_dec.RespBatch._fields)
    conns, _ = _conn_resp(1)
    cb = t_dec.conn_batch_parts([conns[:8]], 8, out=cols)
    ref = j_dec.conn_batch(conns[:8], 8)
    assert int(cb.svc_hi.max()) == int(ref.svc_hi.max()) >= 2**31
    # a staged CPU copy does not alias the buffer it was taken from
    t = t_dec.to_device(cb, "cpu", staged=True)
    assert not np.shares_memory(t.svc_hi.numpy(), cols["svc_hi"])
    with pytest.raises(ValueError, match="exceed"):
        t_dec.conn_batch_parts([conns[:9]], 8, out=cols)


@pytest.mark.gpu
def test_staging_copy_event_guards_the_buffer():
    """On CUDA the staging buffers are pinned, a slab dispatch records
    a copy event on its buffer, and every decode into a buffer after
    its first fill waits for that event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: pinned memory and copy events "
                    "exist only there")
    from gyeeta_tpu_torch.engine.aggstate import EngineCfg
    from gyeeta_tpu_torch.runtime import Runtime

    rt = Runtime(EngineCfg(n_hosts=8, svc_capacity=64, conn_batch=64,
                           resp_batch=64, fold_k=2), device="cuda")
    assert all(torch.from_numpy(a).is_pinned() for buf in rt._slab_bufs
               for half in ("conn", "resp") for a in buf[half].values())
    waits = []
    orig = torch.cuda.Event.synchronize

    def counted(ev):
        waits.append(ev)
        return orig(ev)

    sim = TSim(n_hosts=8, n_svcs=4, seed=3)
    torch.cuda.Event.synchronize = counted
    try:
        for _ in range(5):
            rt.feed(sim.conn_frames(128) + sim.resp_frames(128))
    finally:
        torch.cuda.Event.synchronize = orig
    flips = rt.stats.counters["stage_slab_flips"]
    assert flips == 5 and len(waits) == flips - 2
    rt.close()
