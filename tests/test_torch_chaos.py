"""The port's chaos proxy and node-webserver client against the
reference's.

- ``FaultPlan``: for a set of seeds, fault kinds and windows, the same
  ``(byte offset, kind)`` schedule a conn, the same window edges and
  per-direction latency; unknown kinds and empty region-kill windows
  refused alike; ``RegionKill`` schedules equal.
- ``ChaosProxy`` over loopback: a re-splitting, delaying pass-through
  delivers the stream intact; a corrupt fault at a fixed offset flips
  the same byte through either package's proxy.
- ``NodeWebSim`` against the port's ``GytServer(device="cpu")`` fed by
  two of the port's agents: the handshake, ``query_web`` answers,
  ``crud_alert`` and ``crud_generic`` replies and the error envelope
  equal the reference's ``NodeWebSim`` against the same server.

Exact throughout.
"""

import asyncio
import os

import pytest

from gyeeta_tpu.sim import chaos as j_ch
from gyeeta_tpu.sim.nodeweb import NMError as JNMError
from gyeeta_tpu.sim.nodeweb import NodeWebSim as JNodeWebSim
from gyeeta_tpu_torch.sim import chaos as t_ch
from gyeeta_tpu_torch.sim.nodeweb import NMError as TNMError
from gyeeta_tpu_torch.sim.nodeweb import NodeWebSim as TNodeWebSim

TIMEOUT = 20.0


def _w(coro):
    return asyncio.wait_for(coro, TIMEOUT)


PLANS = {
    "corrupt_s0": dict(seed=0, fault_kinds=("corrupt",)),
    "all_s3": dict(seed=3, fault_kinds=("corrupt", "truncate",
                                        "disconnect"),
                   mean_fault_bytes=64 << 10),
    "stall_s17": dict(seed=17, fault_kinds=("stall", "disconnect"),
                      first_fault_bytes=4096, mean_fault_bytes=1000),
    "windows_s12345": dict(seed=12345, fault_kinds=("truncate",),
                           kill_windows=[(1, 2)],
                           wedge_windows=[(0.5, 1.5), (3, 4)],
                           partition_windows=[(2, 2.5)],
                           latency_s=0.01, jitter_s=0.002,
                           latency_c2s_s=0.05, jitter_s2c_s=0.0,
                           fault_both=True, resplit=512),
    "none": dict(seed=1),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_schedules_equal(name):
    j, t = j_ch.FaultPlan(**PLANS[name]), t_ch.FaultPlan(**PLANS[name])
    for conn in range(4):
        assert list(t.conn_faults(conn, 300)) == \
            list(j.conn_faults(conn, 300))
        for salt in (1, 2, 3):
            rj, rt = j._rng(conn, salt), t._rng(conn, salt)
            assert [rt.random() for _ in range(8)] == \
                [rj.random() for _ in range(8)]
    for x in [i * 0.25 for i in range(20)]:
        assert (t.in_kill_window(x), t.in_wedge_window(x),
                t.in_partition_window(x)) == (
            j.in_kill_window(x), j.in_wedge_window(x),
            j.in_partition_window(x))
    for d in ("c2s", "s2c"):
        assert (t.latency_for(d), t.jitter_for(d)) == \
            (j.latency_for(d), j.jitter_for(d))


def test_refusals_equal():
    for mod in (j_ch, t_ch):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultPlan(fault_kinds=("melt",))
        with pytest.raises(ValueError, match="empty region-kill"):
            mod.RegionKill([(2.0, 1.0)])
    assert t_ch.FAULT_KINDS == j_ch.FAULT_KINDS


def test_region_kill_schedule_equal():
    w = [(3.0, 4.0), (0.5, 1.5)]
    j, t = j_ch.RegionKill(w), t_ch.RegionKill(w)
    assert t.windows == j.windows and t.end == j.end == 4.0
    assert [t.in_window(x / 4) for x in range(20)] == \
        [j.in_window(x / 4) for x in range(20)]

    async def run(rk_mod):
        seen = []
        rk = rk_mod.RegionKill([(0.0, 0.05)],
                               kill_cb=lambda: seen.append("kill"),
                               restart_cb=lambda: seen.append("up"),
                               poll_s=0.01)
        await _w(rk.run())
        return seen, dict(rk.stats)
    assert asyncio.run(run(t_ch)) == asyncio.run(run(j_ch)) == (
        ["kill", "up"], {"region_kills": 1, "region_restarts": 1})


async def _sink_server():
    """A server that keeps every byte it gets, per conn."""
    got = []

    async def handle(r, w):
        buf = bytearray()
        got.append(buf)
        while True:
            d = await r.read(1 << 16)
            if not d:
                break
            buf += d
        w.close()
    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1], got


async def _through(mod, plan, payload):
    srv, port, got = await _sink_server()
    proxy = mod.ChaosProxy("127.0.0.1", port, plan)
    try:
        ph, pp = await _w(proxy.start())
        r, w = await _w(asyncio.open_connection(ph, pp))
        w.write(payload)
        await _w(w.drain())
        w.close()
        for _ in range(400):
            if got and proxy.stats.get("corrupt", 0) + len(got[0]) \
                    >= len(payload) and not proxy._conns:
                break
            await asyncio.sleep(0.01)
        return bytes(got[0]) if got else b"", dict(proxy.stats)
    finally:
        await proxy.stop()
        srv.close()
        await srv.wait_closed()


def test_proxy_resplit_passthrough_intact():
    payload = os.urandom(300_000)
    plan = t_ch.FaultPlan(seed=5, resplit=4096, latency_s=0.0005,
                          jitter_s=0.0005)
    got, stats = asyncio.run(_through(t_ch, plan, payload))
    assert got == payload
    assert stats["delayed_chunks_c2s"] > len(payload) // 4096


def test_proxy_corrupts_the_same_byte():
    payload = bytes(range(256)) * 64
    out = []
    for mod in (j_ch, t_ch):
        plan = mod.FaultPlan(seed=9, fault_kinds=("corrupt",),
                             first_fault_bytes=1000,
                             mean_fault_bytes=1 << 30)
        out.append(asyncio.run(_through(mod, plan, payload)))
    (gj, sj), (gt, st) = out
    assert gt == gj and st == sj == {"corrupt": 1}
    diff = [i for i, (a, b) in enumerate(zip(gt, payload)) if a != b]
    assert diff == [1000] and gt[1000] == payload[1000] ^ 0xFF


# ----------------------------------------------------------- NodeWebSim
NM_QUERIES = (("svcstate", dict(maxrecs=100)),
              ("hoststate", dict()),
              ("taskstate", dict(maxrecs=5, sortcol="cpu", sortdir="desc")),
              ("clusterstate", dict()),
              ("alertdef", dict()))


def test_nodeweb_answers_equal():
    from gyeeta_tpu_torch.engine.aggstate import EngineCfg
    from gyeeta_tpu_torch.net.agent import NetAgent
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    cfg = EngineCfg(n_hosts=8, svc_capacity=64, task_capacity=128,
                    api_capacity=64, conn_batch=128, resp_batch=256,
                    listener_batch=32, fold_k=2, cms_width=1 << 10,
                    hh_width=256, topk_capacity=16, hll_p_svc=4,
                    hll_p_global=8)

    async def go():
        rt = Runtime(cfg, RuntimeOpts(dep_pair_capacity=128,
                                      dep_edge_capacity=128), device="cpu")
        srv = GytServer(rt, tick_interval=None)
        agents = [NetAgent(seed=60 + i, n_svcs=2, n_groups=3)
                  for i in range(2)]
        out = {}
        try:
            host, port = await _w(srv.start())
            for a in agents:
                await _w(a.connect(host, port))
                await _w(a.send_sweep(n_conn=32, n_resp=64))
            c = rt.stats.counters
            for _ in range(400):
                if c.get("sweep_marks", 0) >= 2:
                    break
                await asyncio.sleep(0.01)
            srv._feed_barrier()
            rt.flush()
            rt.run_tick()
            for tag, NW, Err in (("ref", JNodeWebSim, JNMError),
                                 ("port", TNodeWebSim, TNMError)):
                nw = NW(hostname=f"nw-{tag}")
                hs = await _w(nw.connect(host, port))
                try:
                    res = {"hs": {k: v for k, v in hs.items()}}
                    for sub, kw in NM_QUERIES:
                        res[sub] = await _w(nw.query_web(sub, **kw))
                    name = f"def-{tag}"
                    res["add"] = await _w(nw.crud_alert({
                        "op": "add", "objtype": "alertdef",
                        "alertname": name, "subsys": "svcstate",
                        "filter": "{ svcstate.state in 'Severe' }"}))
                    res["list"] = [r.get("alertname") for r in (
                        await _w(nw.query_web("alertdef")))["recs"]]
                    res["del"] = await _w(nw.crud_alert({
                        "op": "delete", "objtype": "alertdef",
                        "name": name}))
                    res["tag"] = await _w(nw.crud_generic({
                        "op": "add", "objtype": "tag",
                        "taskid": "00000000000000ab", "tag": tag}))
                    try:
                        await _w(nw.query_web("nosuchsubsys"))
                        res["err"] = None
                    except Err as e:
                        res["err"] = (str(e), e.errcode)
                    out[tag] = res
                finally:
                    await nw.close()
        finally:
            for a in agents:
                await a.close()
            await srv.stop()
        return out
    out = asyncio.run(go())
    ref, port = out["ref"], out["port"]
    assert port["hs"] == ref["hs"] and port["hs"]["error_code"] == 0
    for sub, _ in NM_QUERIES:
        assert port[sub] == ref[sub], sub
    assert port["svcstate"]["nrecs"] == 4
    assert port["list"] == ["def-port"] and ref["list"] == ["def-ref"]
    for k in ("add", "del"):
        assert port[k] == {**ref[k], **{kk: vv for kk, vv in port[k].items()
                                        if "def-" in str(vv)}}
    assert port["err"] == ref["err"] and port["err"] is not None
