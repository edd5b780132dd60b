"""The port's serving edge against the reference's, over real sockets.

A reference ``GytServer`` over the reference ``Runtime`` and the port's
``GytServer`` over ``Runtime(device="cpu")``, each on an ephemeral
loopback port with manual ticks and a fake clock of 5 s a tick, are fed
the same stream: three of the reference's ``NetAgent``\\ s register over
TCP (sequentially, so both servers hand out the same host ids) and send
one sweep each per tick, each sweep ingested before the next is sent; a
stock partha registers (PS_REGISTER → PM_CONNECT) and streams reference
NOTIFY frames. A ``svcstate`` subscription is open throughout.

Held against the reference: the tick reports and counters, the host map,
the subscription's per-tick events, the stock-partha session's fold, and
the query JSON of all 43 served subsystems over the GYT ``QueryClient``
(strings, ints and bools exact, floats rtol 1e-6; ``flowstate``'s
``evictedbytes`` under the reference's mass rule), with a subset over
the NM edge (the reference's ``NodeWebSim``) and over each package's
``WebGateway`` HTTP, each equal across the three edges. A port server
with ``feed_pipeline=True`` fed the same agents answers the same JSON;
the host map survives a restart; the handshake and idle reaps are
counted; the options of the sharded tier's worker processes build their
supervisor and hub, and ``ingest_procs`` keeps the reference's guard.
"""

import asyncio
import functools
import json
import tempfile
from pathlib import Path
from unittest import mock

import pytest

from gyeeta_tpu.ingest import refproto as JRP
from gyeeta_tpu.net.agent import NetAgent
from gyeeta_tpu.net.agent import QueryClient as JQueryClient
from gyeeta_tpu.net.server import GytServer as JGytServer
from gyeeta_tpu.net.subs import SubscribeClient as JSubscribeClient
from gyeeta_tpu.net.webgw import WebGateway as JWebGateway
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.sim.nodeweb import NodeWebSim
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.net.agent import QueryClient as TQueryClient
from gyeeta_tpu_torch.net.server import GytServer as TGytServer
from gyeeta_tpu_torch.net.subs import SubscribeClient as TSubscribeClient
from gyeeta_tpu_torch.net.webgw import WebGateway as TWebGateway
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from test_refhandshake import (_active_conn_record, _new_listener_record,
                               _top_procs_payload)
from test_refproto import _ref_frame
from test_torch_registries import prime_vips, runtime_ops
from test_torch_runtime import SERVED, SIM_KW, assert_json_equal, j_cfg, \
    t_cfg
from gyeeta_tpu_torch.sim import ParthaSim as TSim

N_TICKS = 3
N_AGENTS = 3
SWEEP = dict(n_conn=40, n_resp=60)
OPTS = dict(dep_pair_capacity=64, dep_edge_capacity=256)
TIMEOUT = 20.0                  # every socket wait, seconds
NM_SUBSET = ("svcstate", "hoststate", "taskstate", "flowstate",
             "svcinfo", "alertdef", "serverstatus", "topk")
REST_SUBSET = ("svcstate", "hoststate", "clusterstate", "flowstate",
               "hostinfo", "svcsumm", "cpumem")
MID = (0x57AC, 0x0BB1)          # the stock partha's machine id


def _w(coro):
    return asyncio.wait_for(coro, TIMEOUT)


async def _until(pred, what):
    """Poll ``pred`` (the server folds on the loop) under the socket
    deadline."""
    async def spin():
        while not pred():
            await asyncio.sleep(0.005)
    try:
        await _w(spin())
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


async def _http_query(host, port, req):
    async def go():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            body = json.dumps(req).encode()
            writer.write(b"POST /query HTTP/1.1\r\nHost: t\r\n"
                         b"Connection: close\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode()
                         + body)
            await writer.drain()
            raw = await reader.read(-1)
        finally:
            writer.close()
        head, _, rbody = raw.partition(b"\r\n\r\n")
        assert b" 200 " in head.splitlines()[0], head
        return json.loads(rbody)
    return await _w(go())


def _ctr(rt, name):
    return rt.stats.counters.get(name, 0)


def _folded(srv, rt, name, before):
    """→ a predicate: counter ``name`` past ``before`` once every
    submitted byte is folded (the feed pipeline's barrier, then the
    runtime's flush: every path dispatches at the same boundaries, as
    the top-K's truncation depends on them)."""
    def pred():
        srv._feed_barrier()
        rt.flush()
        return _ctr(rt, name) > before
    return pred


async def _stock_partha(host, port, rt):
    """PS_REGISTER → PM_CONNECT → reference NOTIFY frames; returns the
    conn's writer (closed by the caller) once the frames are folded."""
    r1, w1 = await _w(asyncio.open_connection(host, port))
    try:
        w1.write(JRP.encode_ps_register_req(*MID, hostname="stockpartha"))
        await _w(w1.drain())
        ps = JRP.parse_ps_register_resp(await _w(r1.readexactly(
            16 + JRP.REF_PS_REGISTER_RESP_DT.itemsize)))
    finally:
        w1.close()
    assert ps["error_code"] == 0, ps
    r2, w2 = await _w(asyncio.open_connection(host, port))
    w2.write(JRP.encode_pm_connect_cmd(*MID, ps["partha_ident_key"],
                                       ps["madhava_id"]))
    await _w(w2.drain())
    pm = JRP.parse_pm_connect_resp(await _w(r2.readexactly(
        16 + JRP.REF_PM_CONNECT_RESP_DT.itemsize)))
    assert pm["error_code"] == 0, pm
    glob = 0x57CC01
    before = _ctr(rt, "conn_events")
    w2.write(_ref_frame(JRP.REF_NOTIFY_NEW_LISTENER, 1,
                        _new_listener_record(glob, 8080, b"svc-a"))
             + _ref_frame(JRP.REF_NOTIFY_ACTIVE_CONN_STATS, 1,
                          _active_conn_record(glob, 0xCA, 64_000))
             + _ref_frame(JRP.REF_NOTIFY_TASK_TOP_PROCS, 1,
                          _top_procs_payload()))
    await _w(w2.drain())
    await _until(lambda: _ctr(rt, "conn_events") > before,
                 "the stock partha's frames")
    return w2


async def _session(pkg, tmp, feed_pipeline=False, full=True):
    """One server's run → dict of everything the tests compare."""
    port_pkg = pkg == "port"
    Runtime, Opts, Server, QC, GW, SC = (
        (TRuntime, TOpts, TGytServer, TQueryClient, TWebGateway,
         TSubscribeClient) if port_pkg else
        (JRuntime, JOpts, JGytServer, JQueryClient, JWebGateway,
         JSubscribeClient))
    now = [1.7e9]
    kw = dict(device="cpu") if port_pkg else {}
    rt = Runtime(t_cfg() if port_pkg else j_cfg(), Opts(**OPTS),
                 clock=lambda: now[0], **kw)
    srv = Server(rt, tick_interval=None, feed_pipeline=feed_pipeline,
                 hostmap_path=str(tmp / f"{pkg}_hostmap.json"))
    out = {"reports": [], "sub_events": []}
    agents, closers = [], []
    gw = qc = nw = sc = None
    try:
        host, port = await _w(srv.start())
        for i in range(N_AGENTS):
            a = NetAgent(seed=i, n_svcs=2, n_groups=3)
            agents.append(a)
            before = _ctr(rt, "names_interned")
            out.setdefault("hids", []).append(await _w(a.connect(host,
                                                                 port)))
            # the registration's inventory frames are folded before
            # the next agent registers
            await _until(_folded(srv, rt, "names_interned", before),
                         "an agent's inventory")
        if full:
            # CRUD over the wire: alertdefs, silences, an inhibit, a
            # tracedef and a tag (the tracedef's enables are pushed to
            # the agents' event conns each tick)
            qc = QC()
            await _w(qc.connect(host, port))
            out["crud"] = [await _w(qc.query(dict(o)))
                           for o in runtime_ops(TSim(**SIM_KW))]
            sc = SC()
            await _w(sc.connect(host, port))
            await _w(sc.subscribe({"subsys": "svcstate", "maxrecs": 100}))
            events = sc.events(stall_timeout=TIMEOUT)
        for tick in range(N_TICKS):
            for a in agents:
                marks = _ctr(rt, "sweep_marks")
                await _w(a.send_sweep(**SWEEP))
                await _until(_folded(srv, rt, "sweep_marks", marks),
                             "a sweep")
            if full and tick == N_TICKS - 1:
                closers.append(await _stock_partha(host, port, rt))
            srv._feed_barrier()
            rt.flush()
            now[0] += 5.0
            out["reports"].append(rt.run_tick())
            if full:
                await srv.push_subscriptions()
                ev = await _w(events.__anext__())
                while ev.get("t") == "ack":
                    ev = await _w(events.__anext__())
                out["sub_events"].append(ev)
        # the VIP views resolve names: primed, never looked up
        prime_vips(rt)
        if qc is None:
            qc = QC()
            await _w(qc.connect(host, port))
        subsets = SERVED if full else ("svcstate", "flowstate",
                                       "taskstate", "hoststate")
        out["gyt"] = {s: await _w(qc.query({"subsys": s, "maxrecs": 10000}))
                      for s in subsets}
        if full:
            nw = NodeWebSim()
            await _w(nw.connect(host, port))
            out["nm"] = {s: await _w(nw.query_web(s, maxrecs=10000))
                         for s in NM_SUBSET}
            gw = GW(host, port)
            gh, gp = await _w(gw.start())
            out["rest"] = {s: await _http_query(gh, gp, {"subsys": s,
                                                         "maxrecs": 10000})
                           for s in REST_SUBSET}
        st = rt.state.flow_topk
        out["mass"] = (float(st.evicted) + float(st.counts.sum()))
        out["counters"] = dict(rt.stats.counters)
        out["hostmap"] = dict(srv.hostmap)
        out["machine_ids"] = [a.machine_id for a in agents]
    finally:
        if sc is not None:
            await sc.close()
        if nw is not None:
            await nw.close()
        if qc is not None:
            await qc.close()
        if gw is not None:
            await gw.stop()
        for w in closers:
            w.close()
        for a in agents:
            await a.close()
        await srv.stop()
    return out


@functools.lru_cache(maxsize=None)
def run_servers():
    tmp = Path(tempfile.mkdtemp(prefix="gyt_torch_srv_"))
    # a DNS miss would start a lookup off the box: refuse it
    with mock.patch("socket.getnameinfo", side_effect=OSError("no dns")):
        ref = asyncio.run(_session("ref", tmp))
        port = asyncio.run(_session("port", tmp))
    return {"ref": ref, "port": port, "tmp": tmp}


@pytest.fixture(scope="module")
def runs():
    return run_servers()


def _assert_query_equal(ref, got, mass, what):
    ref, got = json.loads(json.dumps(ref)), json.loads(json.dumps(got))
    if what.endswith("flowstate"):
        # evictedbytes: a difference of two f32 sums (ROADMAP.md §3)
        for r, g in zip(ref.get("recs", []), got.get("recs", [])):
            assert abs(g.pop("evictedbytes") - r.pop("evictedbytes")) \
                <= 1e-5 * mass, what
    assert_json_equal(ref, got, what)


def test_agents_get_the_same_host_ids(runs):
    assert runs["port"]["hids"] == runs["ref"]["hids"] == \
        list(range(N_AGENTS))


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_tick_report_matches_reference(runs, tick):
    ref, got = runs["ref"]["reports"][tick], runs["port"]["reports"][tick]
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], float):
            assert got[k] == pytest.approx(ref[k], rel=1e-6), k
        else:
            assert got[k] == ref[k], k


def test_counters_match_reference(runs):
    j, t = runs["ref"]["counters"], runs["port"]["counters"]
    assert t == j
    for k in ("agents_registered", "ref_native_decoded", "net_queries",
              "conns_ref_adapted", "ref_pm_connected", "ref_ps_registered",
              "net_subscribes"):
        assert t.get(k, 0) > 0, k
    assert "ref_fallback_decoded" not in t


@pytest.mark.parametrize("subsys", SERVED)
def test_gyt_query_json_matches_reference(runs, subsys):
    ref, got = runs["ref"]["gyt"][subsys], runs["port"]["gyt"][subsys]
    assert got["nrecs"] == ref["nrecs"]
    _assert_query_equal(ref, got, runs["ref"]["mass"], subsys)


def test_most_subsystems_have_rows(runs):
    """The agents' stream reaches most views (the simulated agents send
    no request traces, mounts or interfaces, and no NAT'd flows)."""
    empty = sorted(s for s, out in runs["port"]["gyt"].items()
                   if not out["nrecs"])
    assert len(empty) <= 8, empty


@pytest.mark.parametrize("subsys", NM_SUBSET)
def test_nm_edge_matches_reference_and_gyt(runs, subsys):
    got = runs["port"]["nm"][subsys]
    _assert_query_equal(runs["ref"]["nm"][subsys], got,
                        runs["ref"]["mass"], f"nm.{subsys}")
    assert got == runs["port"]["gyt"][subsys]


@pytest.mark.parametrize("subsys", REST_SUBSET)
def test_rest_edge_matches_reference_and_gyt(runs, subsys):
    got = runs["port"]["rest"][subsys]
    _assert_query_equal(runs["ref"]["rest"][subsys], got,
                        runs["ref"]["mass"], f"rest.{subsys}")
    assert got == runs["port"]["gyt"][subsys]


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_subscription_event_matches_reference(runs, tick):
    ref = runs["ref"]["sub_events"][tick]
    got = runs["port"]["sub_events"][tick]
    assert got["t"] == ref["t"]
    _assert_query_equal(ref, got, runs["ref"]["mass"], f"sub{tick}")


def test_crud_replies_match_reference(runs):
    assert_json_equal(runs["ref"]["crud"], runs["port"]["crud"])
    assert all(r.get("ok") for r in runs["port"]["crud"])


def test_stock_partha_session_folds_like_reference(runs):
    for pkg in ("ref", "port"):
        c = runs[pkg]["counters"]
        assert c["ref_pm_connected"] == c["ref_ps_registered"] == 1
    svc = {r["svcid"]: r for r in runs["port"]["gyt"]["svcstate"]["recs"]}
    assert f"{0x57CC01:016x}" in svc
    assert any(r.get("comm") == "svc-a"
               for r in runs["port"]["gyt"]["svcinfo"]["recs"])
    assert runs["port"]["hostmap"] == runs["ref"]["hostmap"]


def test_feed_pipeline_equals_direct_path():
    direct = asyncio.run(_session(
        "port", Path(tempfile.mkdtemp(prefix="gyt_torch_direct_")),
        full=False))
    piped = asyncio.run(_session(
        "port", Path(tempfile.mkdtemp(prefix="gyt_torch_pipe_")),
        feed_pipeline=True, full=False))
    assert piped["reports"] == direct["reports"]
    for s, ref in direct["gyt"].items():
        _assert_query_equal(ref, piped["gyt"][s], direct["mass"], s)
    assert piped["counters"] == direct["counters"]


def test_hostmap_survives_restart(runs):
    """A port server restarted over the same host map file gives a
    known machine its old host id, counted as a reconnect."""
    tmp = runs["tmp"]
    mids = runs["port"]["machine_ids"]

    async def go():
        rt = TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")
        srv = TGytServer(rt, tick_interval=None,
                         hostmap_path=str(tmp / "port_hostmap.json"))
        a = NetAgent(machine_id=mids[2], seed=2)
        try:
            host, port = await _w(srv.start())
            hid = await _w(a.connect(host, port))
            return hid, dict(rt.stats.counters)
        finally:
            await a.close()
            await srv.stop()
    hid, ctr = asyncio.run(go())
    assert hid == runs["port"]["hids"][2]
    assert ctr.get("agent_reconnects") == 1
    assert "agents_registered" not in ctr


def test_handshake_and_idle_reaps_are_counted():
    async def go():
        rt = TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")
        srv = TGytServer(rt, tick_interval=None, handshake_timeout=0.2,
                         idle_timeout=0.3)
        a = NetAgent(seed=5)
        try:
            host, port = await _w(srv.start())
            # a peer that connects and never registers
            r, w = await _w(asyncio.open_connection(host, port))
            await _until(lambda: _ctr(rt, "conn_timeouts|kind=handshake")
                         == 1, "the handshake reap")
            assert await _w(r.read()) == b""        # closed by the server
            w.close()
            # a registered event conn that goes silent
            await _w(a.connect(host, port))
            await _until(lambda: _ctr(rt, "conn_timeouts|kind=idle") == 1,
                         "the idle reap")
            return dict(rt.stats.counters)
        finally:
            await a.close()
            await srv.stop()
    ctr = asyncio.run(go())
    assert ctr["conn_timeouts|kind=handshake"] == 1
    assert ctr["conn_timeouts|kind=idle"] == 1


# the worker-process options: a single runtime (one shard) refuses
# ingest_procs > 1 with the reference's ValueError, a two-shard runtime
# gets its supervisor and rings (and its WAL view); relay_port starts a
# hub on an ephemeral port and stops it
@pytest.mark.parametrize("kw", [dict(ingest_procs=2),
                                dict(relay_port=0)],
                         ids=["ingest_procs", "relay_port"])
def test_sharded_options_build(kw, tmp_path):
    from gyeeta_tpu_torch.net.ingestproc import ProcWalView
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    rt = TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")
    try:
        if "ingest_procs" in kw:
            with pytest.raises(ValueError, match="needs --shards >= 2"):
                TGytServer(rt, tick_interval=None, **kw)
        else:
            srv = TGytServer(rt, tick_interval=None,
                             relay_host="127.0.0.1", **kw)

            async def go():
                await srv.start()
                try:
                    return srv._relay.host, srv._relay.port
                finally:
                    await srv.stop()
            host, port = asyncio.run(go())
            assert host == "127.0.0.1" and port > 0
            return
    finally:
        rt.close()
    srt = ShardedRuntime(t_cfg(), make_mesh(2, device="cpu"),
                         TOpts(**OPTS, journal_dir=str(tmp_path / "wal")))
    srv = TGytServer(srt, tick_interval=None, **kw)
    try:
        assert [h.shards for h in srv._ingest.workers] == [[0], [1]]
        assert isinstance(srt.journal, ProcWalView)
    finally:
        srv._ingest.close()
        srt.close()


def test_preagg_advert_is_an_argument():
    """``preagg=True`` advertises the engine's sketch geometry to a
    registering agent, which then sends delta sweeps."""
    async def go():
        rt = TRuntime(t_cfg(), TOpts(**OPTS), device="cpu")
        srv = TGytServer(rt, tick_interval=None, preagg=True)
        a = NetAgent(seed=3, n_svcs=2, n_groups=3)
        try:
            host, port = await _w(srv.start())
            await _w(a.connect(host, port))
            marks = _ctr(rt, "sweep_marks")
            await _w(a.send_sweep(**SWEEP))
            await _until(lambda: _ctr(rt, "sweep_marks") > marks, "a sweep")
            return dict(rt.stats.counters)
        finally:
            await a.close()
            await srv.stop()
    ctr = asyncio.run(go())
    assert ctr["preagg_agents_negotiated"] == 1
    assert ctr["preagg_delta_records"] > 0
