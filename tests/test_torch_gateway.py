"""The port's fabric gateway against the reference's, in front of the
same port replicas.

Two port ``GytServer``\\ s, each over its own ``Runtime(device="cpu")`` at
``tests/test_gateway.py``'s geometry, are fed one seeded stream on one
fake clock of 5 s a tick, so the two replicas answer alike. A pair of
reference ``FabricGateway``\\ s and a pair of the port's stand side by
side in front of them (peered within each pair, the rendezvous owner
pinned to the first gateway of each pair so both packages take the same
route; hedging off so a slow CPU render cannot fork the counters), and
every step runs through both pairs on the same tick
(:func:`fabric_run`, one run a process). Held equal between the two
packages: the bodies of the REST, GYT and NM fronts (and equal to the
replica's own answer), and the ``gyt_gw_*`` counter deltas of the local
cache, the peer exchange, single-flight and the negative TTL; the SSE
and GYT subscription pushes, reassembled byte-equal to a fresh render;
the ``/metrics`` families.

Unit cases run through both packages with the same fakes and compare
what each observes: the historical cache, a lagging replica, the owner
adopting a peer's newer tick, serialized peer conns, and hub mode in
front of a poll-mode gateway. The fault-domain cases of
``tests/test_failover.py`` run on the port's classes: K failures before
mark-down, last resort and half-open recovery, the hedged read,
rendezvous ownership and the owner-down scan, peer-conn recovery, the
persisted subscription ring (with its torn tail and its bound), a
stalled subscribe and the supervised stream's byte-equal failover. No
reference ``Runtime`` is started, so nothing compiles.
"""

import asyncio
import json
import socket
import time

import pytest
import torch

from gyeeta_tpu.net import gateway as j_gw
from gyeeta_tpu.net import subs as j_subs
from gyeeta_tpu.sim.nodeweb import NodeWebSim
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.net import gateway as t_gw
from gyeeta_tpu_torch.net import subs as t_subs
from gyeeta_tpu_torch.net.agent import QueryClient
from gyeeta_tpu_torch.net.server import GytServer
from gyeeta_tpu_torch.query import delta as D
from gyeeta_tpu_torch.query import normalize as t_norm
from gyeeta_tpu_torch.query import snapshot as t_snap
from gyeeta_tpu_torch.runtime import Runtime
from gyeeta_tpu_torch.sim import ParthaSim
from gyeeta_tpu_torch.utils.config import RuntimeOpts
from gyeeta_tpu_torch.utils.selfstats import Stats

torch.set_num_threads(1)

CFG = EngineCfg(n_hosts=8, svc_capacity=256, task_capacity=256,
                conn_batch=256, resp_batch=512, listener_batch=64,
                fold_k=2)
TIMEOUT = 20.0                  # every socket wait, seconds
DEAD = ("127.0.0.1", 9)         # nothing listens on discard
PKGS = ("ref", "port")
GW = {"ref": j_gw, "port": t_gw}
STATS = {"ref": JStats, "port": Stats}
Q = {"subsys": "svcstate", "sortcol": "qps5s", "sortdesc": True,
     "maxrecs": 50}
FRONT_SUBSYS = ("svcstate", "hoststate", "topk", "flowstate",
                "clusterstate", "svcsumm", "svcinfo", "activeconn")


def _w(coro, timeout=TIMEOUT):
    return asyncio.wait_for(coro, timeout)


async def _until(cond, what, timeout=TIMEOUT):
    async def spin():
        while not cond():
            await asyncio.sleep(0.01)
    try:
        await _w(spin(), timeout)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


@pytest.fixture(autouse=True)
def no_dns(monkeypatch):
    """A lookup off the box is refused while a test runs."""
    def refuse(*_a, **_k):
        raise OSError("no dns")
    monkeypatch.setattr(socket, "getnameinfo", refuse)


def _ctrs(gw):
    return {k: v for k, v in gw.stats.counters.items()
            if k.startswith("gw_")}


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Replicas:
    """Port ``GytServer``\\ s, each over its own CPU runtime fed the same
    seeded stream on one fake clock of 5 s a tick."""

    def __init__(self, n=2, seed=21):
        self.now = [1.7e9]
        self.rts = [Runtime(CFG, RuntimeOpts(), clock=lambda: self.now[0],
                            device="cpu") for _ in range(n)]
        self.sims = [ParthaSim(n_hosts=8, n_svcs=4, seed=seed)
                     for _ in range(n)]
        for rt, sim in zip(self.rts, self.sims):
            rt.feed(sim.name_frames())
            rt.feed(sim.listener_frames())
        self.srvs = [GytServer(rt, tick_interval=None, idle_timeout=300.0)
                     for rt in self.rts]
        self.addrs = []
        self.advance()

    async def start(self):
        for s in self.srvs:
            self.addrs.append(await _w(s.start()))
        return self

    def advance(self):
        """One tick on every replica, with no await in between."""
        self.now[0] += 5.0
        for rt, sim in zip(self.rts, self.sims):
            rt.feed(sim.conn_frames(256) + sim.resp_frames(512)
                    + wire.encode_frame(wire.NOTIFY_HOST_STATE,
                                        sim.host_state_records()))
            rt.run_tick()

    @property
    def tick(self):
        return self.rts[0].snapshot.tick

    async def stop(self):
        for s in self.srvs:
            await _w(s.stop())          # closes its runtime


def _mk(pkg, ups, **kw):
    kw = {"poll_s": 0.05, "hedge_ms": 0, "peer_timeout_s": 10.0, **kw}
    return GW[pkg].FabricGateway(list(ups), **kw)


async def _http(host, port, method, target, body=b""):
    reader, writer = await _w(asyncio.open_connection(host, port))
    try:
        writer.write(f"{method} {target} HTTP/1.1\r\nHost: t\r\n"
                     f"Connection: close\r\nContent-Length: {len(body)}"
                     "\r\n\r\n".encode() + body)
        await _w(writer.drain())
        raw = await _w(reader.read(-1))
    finally:
        writer.close()
    head, _, rbody = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rbody


async def _sse_open(host, port, qs):
    reader, writer = await _w(asyncio.open_connection(host, port))
    writer.write(f"GET /v1/subscribe?{qs} HTTP/1.1\r\nHost: s\r\n\r\n"
                 .encode())
    await _w(writer.drain())
    head = await _w(reader.readuntil(b"\r\n\r\n"))
    assert b"200" in head.split(b"\r\n", 1)[0]
    events = []

    async def loop():
        async for ev in t_subs.read_sse_events(reader):
            events.append(ev)
    return writer, events, asyncio.create_task(loop())


async def _gyt_sub(host, port, req):
    sc = t_subs.SubscribeClient()
    await _w(sc.connect(host, port))
    await _w(sc.subscribe(dict(req)))
    events = []

    async def loop():
        async for ev in sc.events():
            events.append(ev)
    return sc, events, asyncio.create_task(loop())


def _drop_sse_conns(gw):
    """The reference's SSE handler parks until a push to the closed
    client fails (a client's EOF leaves the server transport open), and
    its ``stop`` waits for every conn: abort its subscribers' conns."""
    for s in list(gw.subs._subs.values()):
        tr = getattr(s.conn_tag, "transport", None)
        if tr is not None:
            tr.abort()


# ================================================== the fabric, side by side
async def _fabric():
    reps = await Replicas().start()
    out = {"phases": {}, "fronts": {}, "direct": {}, "subs": {},
           "metrics": {}}
    gws, closers, tasks = {}, [], []
    try:
        for pkg in PKGS:
            g1 = _mk(pkg, reps.addrs)
            h1, p1 = await _w(g1.start())
            g2 = _mk(pkg, reps.addrs, peers=[(h1, p1)])
            h2, p2 = await _w(g2.start())
            gws[pkg] = (g1, g2)
            g1.peers = [(h2, p2)]               # full peer mesh
            # one owner for every key in both packages
            g1._owner_peer = lambda key: None
            g2._owner_peer = lambda key, a=(h1, p1): a

        def seen(tick):
            return all(g.fabric_tick >= tick for pair in gws.values()
                       for g in pair)

        await _until(lambda: seen(reps.tick), "tick discovery")

        async def phase(name, fn):
            rec = {}
            for pkg in PKGS:
                before = [_ctrs(g) for g in gws[pkg]]
                res = await fn(*gws[pkg])
                rec[pkg] = {"result": res, "deltas": [
                    _delta(b, _ctrs(g)) for b, g in zip(before, gws[pkg])]}
            out["phases"][name] = rec

        async def cache(g1, g2):
            o1 = await _w(g1.query(dict(Q)))
            o2 = await _w(g1.query(dict(Q)))
            o3 = await _w(g1.query({"subsys": "svcstate", "maxrecs": 50,
                                    "sortcol": "qps5s"}))  # sortdesc dflt
            return {"same": o2 is o1 and o3 is o1, "body": json.dumps(o1),
                    "nrecs": o1["nrecs"]}

        async def peer(g1, g2):
            return {"body": json.dumps(await _w(g2.query(dict(Q))))}

        async def stampede(g1, g2):
            outs = await _w(asyncio.gather(
                *[g1.query(dict(Q)) for _ in range(16)]))
            return {"ticks": sorted({o["snaptick"] for o in outs}),
                    "body": json.dumps(outs[0])}

        async def negative(g1, g2):
            errs = []
            for g in (g1, g1, g2):
                try:
                    await _w(g.query({"subsys": "nosuchsubsys"}))
                except RuntimeError as e:
                    errs.append(str(e))
            return {"errors": errs}

        await phase("cache", cache)
        await phase("peer", peer)
        reps.advance()
        await _until(lambda: seen(reps.tick), "the fresh tick")
        await phase("singleflight", stampede)
        await phase("negative", negative)

        # ---- the three fronts of the first gateway, and the replica
        qc = QueryClient()
        await _w(qc.connect(*reps.addrs[0]))
        closers.append(qc.close)
        for s in FRONT_SUBSYS:
            out["direct"][s] = await _w(qc.query({"subsys": s,
                                                  "maxrecs": 10000}))
        for pkg in PKGS:
            g1 = gws[pkg][0]
            f = out["fronts"][pkg] = {"gyt": {}, "rest": {}, "nm": {},
                                      "rest_get": {}}
            gq = QueryClient()
            await _w(gq.connect(g1.host, g1.port))
            closers.append(gq.close)
            nm = NodeWebSim()
            await _w(nm.connect(g1.host, g1.port))
            closers.append(nm.close)
            for s in FRONT_SUBSYS:
                req = {"subsys": s, "maxrecs": 10000}
                f["gyt"][s] = await _w(gq.query(dict(req)))
                st, body = await _http(g1.host, g1.port, "POST", "/query",
                                       json.dumps(req).encode())
                assert st == 200, body
                f["rest"][s] = json.loads(body)
                st, body = await _http(g1.host, g1.port, "GET",
                                       f"/v1/{s}?maxrecs=10000")
                f["rest_get"][s] = json.loads(body)
                f["nm"][s] = await _w(nm.query_web(s, maxrecs=10000))

        # ---- subscriptions: GYT binary on the first gateway, SSE on
        # the second, in both packages
        streams = {}
        for pkg in PKGS:
            g1, g2 = gws[pkg]
            sc, ev_g, t_g = await _gyt_sub(g1.host, g1.port, Q)
            closers.append(sc.close)
            w, ev_s, t_s = await _sse_open(
                g2.host, g2.port, "subsys=svcstate&sortcol=qps5s&"
                "sortdesc=true&maxrecs=50")
            closers.append(w.close)
            tasks += [t_g, t_s]
            streams[pkg] = (ev_g, ev_s)
        await _until(lambda: all(a and b for a, b in streams.values()),
                     "the initial full events")
        n0 = {pkg: (len(a), len(b)) for pkg, (a, b) in streams.items()}
        reps.advance()
        await _until(lambda: all(
            len(a) > n0[p][0] and len(b) > n0[p][1]
            for p, (a, b) in streams.items()), "the pushed events")
        for pkg in PKGS:
            g1, g2 = gws[pkg]
            ev_g, ev_s = streams[pkg]
            held = [D.apply_event(D.apply_event(None, ev[0]), ev[-1])
                    for ev in (ev_g, ev_s)]
            fresh = [json.loads(json.dumps(await _w(g.query(dict(Q)))))
                     for g in (g1, g2)]
            out["subs"][pkg] = {
                "types": [[e["t"] for e in ev] for ev in (ev_g, ev_s)],
                "held": [json.dumps(h) for h in held],
                "fresh": [json.dumps(f) for f in fresh],
                "pushed": [g.stats.counters.get("gw_deltas_pushed", 0)
                           + g.stats.counters.get("gw_resyncs", 0)
                           for g in (g1, g2)],
                "subscribers": [g.stats.gauges.get("gw_subscribers")
                                for g in (g1, g2)],
                "edges": [g.stats.counters.get(f"gw_queries|edge={e}")
                          for g, e in ((g1, "gyt_sub"), (g2, "sse"))]}
            st, body = await _http(g1.host, g1.port, "GET", "/metrics")
            out["metrics"][pkg] = (st, body.decode())
            st, body = await _http(g1.host, g1.port, "GET", "/healthz")
            out["metrics"][pkg + "_healthz"] = (st, json.loads(body))
    finally:
        for t in tasks:
            t.cancel()
        for c in closers:
            res = c()
            if asyncio.iscoroutine(res):
                await _w(res)
        for pkg, pair in gws.items():
            # the second gateway first: its peer conn is the first's
            # client, and a server's stop waits for its clients
            for g in reversed(pair):
                if pkg == "ref":
                    _drop_sse_conns(g)
                await _w(g.stop())
        await reps.stop()
    return out


_RUN = {}


def fabric_run():
    if "out" not in _RUN:
        _RUN["out"] = asyncio.run(_fabric())
    return _RUN["out"]


@pytest.fixture(scope="module")
def fab():
    yield fabric_run()
    _RUN.clear()


@pytest.mark.parametrize("name", ["cache", "peer", "singleflight",
                                  "negative"])
def test_phase_counters_and_bodies_match_reference(fab, name):
    ph = fab["phases"][name]
    assert ph["port"]["result"] == ph["ref"]["result"]
    assert ph["port"]["deltas"] == ph["ref"]["deltas"]


def test_local_cache_hits(fab):
    got = fab["phases"]["cache"]["port"]
    assert got["result"]["same"] and got["result"]["nrecs"] > 0
    assert got["deltas"][0]["gw_cache_hits|tier=local"] == 2
    assert got["deltas"][0]["gw_cache_misses"] == 1


def test_peer_exchange_one_fleet_render(fab):
    ph = fab["phases"]
    got = ph["peer"]["port"]
    assert got["result"]["body"] == ph["cache"]["port"]["result"]["body"]
    assert got["deltas"][1]["gw_cache_hits|tier=peer"] == 1
    assert got["deltas"][1]["gw_peer_hits"] == 1
    assert got["deltas"][0]["gw_peer_served_hits"] == 1
    assert "gw_renders_upstream" not in got["deltas"][1]


def test_singleflight_one_upstream_render(fab):
    got = fab["phases"]["singleflight"]["port"]
    assert len(got["result"]["ticks"]) == 1
    assert got["deltas"][0]["gw_renders_upstream"] == 1
    assert got["deltas"][0]["gw_singleflight_waits"] == 15


def test_negative_ttl_shared_by_the_fleet(fab):
    got = fab["phases"]["negative"]["port"]
    assert len(got["result"]["errors"]) == 3
    assert len(set(got["result"]["errors"])) == 1
    assert got["deltas"][0]["gw_cache_hits|tier=neg"] == 2
    assert got["deltas"][1].get("gw_renders_upstream", 0) == 0


@pytest.mark.parametrize("front", ["gyt", "rest", "rest_get", "nm"])
@pytest.mark.parametrize("subsys", FRONT_SUBSYS)
def test_front_body_equals_reference_and_replica(fab, front, subsys):
    got = fab["fronts"]["port"][front][subsys]
    assert got == fab["fronts"]["ref"][front][subsys]
    assert json.dumps(got) == json.dumps(fab["direct"][subsys])


def test_subscription_pushes_match_reference(fab):
    got, ref = fab["subs"]["port"], fab["subs"]["ref"]
    assert got == ref
    assert [t[0] for t in got["types"]] == ["full", "full"]
    assert got["held"] == got["fresh"]      # byte-equal reassembly
    assert all(n >= 1 for n in got["pushed"])
    assert got["subscribers"] == [1.0, 1.0]
    assert got["edges"] == [1, 1]


def test_metrics_and_healthz_match_reference(fab):
    fams = {}
    for pkg in PKGS:
        st, text = fab["metrics"][pkg]
        assert st == 200
        fams[pkg] = {ln.split("{")[0].split(" ")[0]
                     for ln in text.splitlines()
                     if ln.startswith("gyt_gw_")}
    # which peer-exchange families appear depends on when each
    # gateway's poller saw the pushed tick: hold the ones every run has
    for fam in ("gyt_gw_cache_hits_total", "gyt_gw_subscribers",
                "gyt_gw_cache_misses_total", "gyt_gw_upstream_state",
                "gyt_gw_renders_upstream_total", "gyt_gw_queries_total",
                "gyt_gw_singleflight_waits_total",
                "gyt_gw_peer_served_requests_total",
                "gyt_gw_upstream_ewma_ms"):
        assert fam in fams["port"] and fam in fams["ref"], fam
    assert 'state="up"} 1' in fab["metrics"]["port"][1]
    st, hz = fab["metrics"]["port_healthz"]
    assert st == 200 and hz["ok"] and hz["upstreams_up"] == 2
    assert hz == fab["metrics"]["ref_healthz"][1]


def test_request_key_is_the_replica_cache_key():
    a = {"subsys": "svcstate", "maxrecs": 1000, "sortdesc": True,
         "filter": "{svcstate.qps5s>1.0}"}
    b = {"filter": "{ svcstate.qps5s  >  1 }", "subsys": "svcstate"}
    assert t_gw.request_key is t_norm.request_key is t_snap.request_key
    assert t_norm.request_key(a) == t_norm.request_key(b) \
        == j_gw.request_key(a)


# ============================================ unit cases, both packages
async def _hist(pkg):
    gw = GW[pkg].FabricGateway([DEAD])
    calls = []

    async def fake(req):
        calls.append(dict(req))
        if "at" in req:
            return {"nrecs": 1, "recs": [{"x": len(calls)}], "at": 100.0,
                    "tick": 4, "hist_cover_t": 200.0,
                    "hist_cover_tick": 8}
        return {"nrecs": 1, "recs": [{"x": len(calls)}],
                "window": [50.0, 120.0], "shards": 2,
                "hist_cover_t": 200.0, "hist_cover_tick": 8}

    gw._upstream_query = fake
    seq = []
    for q in ({"subsys": "svcstate", "at": "tick:4"},
              {"subsys": "svcstate", "at": "tick:4"},
              {"subsys": "hoststate", "at": 150.0},
              {"subsys": "hoststate", "at": "tick:4"},
              {"subsys": "svcstate", "window": "1m", "tend": 120.0},
              {"subsys": "svcstate", "window": "1m", "tend": 120.0},
              {"subsys": "svcstate", "window": "1m"},
              {"subsys": "svcstate", "window": "1m"},
              {"subsys": "svcstate", "at": 999.0},
              {"subsys": "svcstate", "at": 999.0},
              {"subsys": "svcstate", "at": "tick:4",
               "consistency": "strong"}):
        r = await gw.query(dict(q))
        seq.append((r["recs"][0]["x"], len(calls)))
    gw._render.close()
    gw.subs.close()
    return {"seq": seq, "ctrs": _ctrs(gw)}


def test_historical_cache_no_ttl_matches_reference():
    got, ref = asyncio.run(_hist("port")), asyncio.run(_hist("ref"))
    assert got == ref
    assert [n for _, n in got["seq"]] == [1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 8]
    c = got["ctrs"]
    assert c["gw_hist_cache_hits"] == 3
    assert c["gw_hist_cache_uncacheable"] == 2
    assert c["gw_queries_uncached"] == 1


async def _lagging(pkg):
    gw = GW[pkg].FabricGateway([DEAD])
    gw.upstreams[0].tick = 7        # fabric tick, no watcher task
    calls = []

    async def fake(req):
        calls.append(req)
        t = 6 if len(calls) == 1 else 7     # lags, then catches up
        return {"snaptick": t, "nrecs": 1, "recs": [{"n": t}]}

    gw._upstream_query = fake
    q = {"subsys": "svcstate"}
    k = GW[pkg].request_key(q)
    o1 = await gw.query(dict(q))
    parked = [(7, k) in gw._cache, (6, k) in gw._cache]
    o2 = await gw.query(dict(q))
    o3 = await gw.query(dict(q))
    gw._render.close()
    gw.subs.close()
    return {"ticks": [o1["snaptick"], o2["snaptick"]], "parked": parked,
            "calls": len(calls), "same": o3 is o2, "ctrs": _ctrs(gw)}


def test_lagging_replica_not_cached_under_current_tick():
    got = asyncio.run(_lagging("port"))
    assert got == asyncio.run(_lagging("ref"))
    assert got["ticks"] == [6, 7] and got["parked"] == [False, True]
    assert got["calls"] == 2 and got["same"]


async def _adopt(pkg):
    gw = GW[pkg].FabricGateway([DEAD])
    gw.upstreams[0].tick = 5        # our poller is behind
    k = GW[pkg].request_key({"subsys": "svcstate"})

    async def fake(req):
        return {"snaptick": 7, "nrecs": 1, "recs": [{"a": 1}]}

    gw._upstream_query = fake
    out = await gw._serve_peer({"tick": 7, "key": k,
                                "req": {"subsys": "svcstate"}})
    out2 = await gw._serve_peer({"tick": 7, "key": k})
    res = {"fabric_tick": gw.fabric_tick, "cached": (7, k) in gw._cache,
           "same": out2["resp"] is out["resp"], "resp": out["resp"],
           "ctrs": _ctrs(gw)}
    gw._render.close()
    gw.subs.close()
    return res


def test_peer_request_adopts_newer_tick():
    got = asyncio.run(_adopt("port"))
    assert got == asyncio.run(_adopt("ref"))
    assert got["fabric_tick"] == 7 and got["cached"] and got["same"]
    assert got["ctrs"]["gw_peer_tick_adopted"] == 1
    assert got["ctrs"]["gw_peer_served_hits"] == 1


async def _serialized(pkg):
    gw1 = _mk(pkg, [DEAD], poll_s=3600.0)
    h1, p1 = await _w(gw1.start())
    gw2 = _mk(pkg, [DEAD], peers=[(h1, p1)], poll_s=3600.0,
              peer_timeout_s=5.0)
    try:
        for i in range(12):
            gw1._cache_put((5, f"k{i}"),
                           ["ok", {"i": i, "snaptick": 5}, None])
        gw2._owner_peer = lambda key: (h1, p1)
        outs = await _w(asyncio.gather(
            *[gw2._peer_get(5, f"k{i}", {"subsys": "svcstate"})
              for i in range(12)]))
        return {"order": [o[1]["i"] for o in outs], "ctrs": _ctrs(gw2)}
    finally:
        await _w(gw2.stop())
        await _w(gw1.stop())


def test_peer_exchange_serializes_per_conn():
    got = asyncio.run(_serialized("port"))
    assert got == asyncio.run(_serialized("ref"))
    assert got["order"] == list(range(12))
    assert got["ctrs"].get("gw_peer_errors", 0) == 0
    assert got["ctrs"]["gw_peer_hits"] == 12


async def _hub_mode():
    reps = await Replicas(n=1).start()
    out, subs, tasks, gws = {}, [], [], []
    try:
        pairs = {}
        for pkg in PKGS:
            gwa = _mk(pkg, reps.addrs)
            ha, pa = await _w(gwa.start())
            gwb = GW[pkg].FabricGateway([(ha, pa)], hub=True)
            hb, pb = await _w(gwb.start())
            gws += [gwb, gwa]
            pairs[pkg] = (gwa, gwb)
        await _until(lambda: all(b.fabric_tick >= reps.tick
                                 for _, b in pairs.values()),
                     "hub tick via the heartbeat relay")
        readers = {}
        for pkg, (gwa, gwb) in pairs.items():
            readers[pkg] = []
            for _ in range(2):      # TWO local subscribers, ONE stream
                sc, evs, t = await _gyt_sub(gwb.host, gwb.port, Q)
                subs.append(sc)
                tasks.append(t)
                readers[pkg].append(evs)
        await _until(lambda: all(r for rs in readers.values()
                                 for r in rs), "fulls through the relay")
        n0 = {p: [len(r) for r in rs] for p, rs in readers.items()}
        reps.advance()
        await _until(lambda: all(len(r) > n0[p][i]
                                 for p, rs in readers.items()
                                 for i, r in enumerate(rs)),
                     "the hub's delta push")
        for pkg, (gwa, gwb) in pairs.items():
            rs = readers[pkg]
            held = D.apply_event(D.apply_event(None, rs[0][0]), rs[0][-1])
            full = json.loads(json.dumps(await _w(gwa.query(dict(Q)))))
            r0 = gwb.stats.counters.get("gw_renders_upstream", 0)
            one = await _w(gwb.query(dict(Q)))
            out[pkg] = {
                "held": json.dumps(held), "full": json.dumps(full),
                "one_shot": one["snaptick"] == full["snaptick"],
                "relays": gwb.stats.counters.get(
                    "gw_region_relays_opened"),
                "keys": gwb.stats.gauges.get("gw_region_keys"),
                "region_hits": gwb.stats.counters.get(
                    "gw_cache_hits|tier=region", 0) >= 1,
                "renders": gwb.stats.counters.get(
                    "gw_renders_upstream", 0) - r0,
                "events": gwb.stats.counters.get("gw_region_events",
                                                 0) >= 2,
                "bytes": gwb.stats.counters.get("gw_region_event_bytes",
                                                0) > 0}
    finally:
        for t in tasks:
            t.cancel()
        for sc in subs:
            await _w(sc.close())
        for g in gws:
            await _w(g.stop())
        await reps.stop()
    return out


def test_hub_mode_region_relay_matches_reference():
    out = asyncio.run(_hub_mode())
    got = out["port"]
    assert got == out["ref"]
    assert got["held"] == got["full"] and got["one_shot"]
    assert got["relays"] == 2 and got["keys"] == 2.0
    assert got["region_hits"] and got["renders"] == 0
    assert got["events"] and got["bytes"]


# ================================= fault domains (tests/test_failover.py)
@pytest.mark.parametrize("pkg", PKGS)
def test_circuit_k_failures_not_one(pkg):
    st = STATS[pkg]()
    u = GW[pkg]._Upstream("127.0.0.1", 9999, 1, stats=st, down_after=3)
    lbl = "upstream=127.0.0.1:9999"
    assert u.state == "up"
    u.record_fail()
    assert u.state == "up" and u.fails == 1     # ONE failure: still up
    u.record_ok(5.0)
    assert u.fails == 0                          # success resets
    u.record_fail()
    u.record_fail()
    assert u.state == "up"                       # 2 consecutive: up
    u.record_fail()
    assert u.state == "down"                     # K=3: breaker opens
    assert st.counters.get(f"gw_upstream_flaps|{lbl}") == 1
    assert u.probe_at > time.monotonic() and not u.probe_due()
    assert st.gauges.get(f"gw_upstream_state|{lbl},state=down") == 1.0
    assert st.gauges.get(f"gw_upstream_state|{lbl},state=up") == 0.0
    b0 = u.backoff_s
    u._set_state("half_open")
    u.record_fail()
    assert u.state == "down" and u.backoff_s == 2 * b0
    u.record_ok(3.0)
    assert u.state == "up" and u.backoff_s == u.probe_base_s
    assert st.counters.get(f"gw_upstream_recoveries|{lbl}") == 1


def test_failover_last_resort_and_halfopen_recovery():
    async def scenario():
        reps = await Replicas(n=1).start()
        live = reps.addrs[0]
        gw = t_gw.FabricGateway([DEAD, live], poll_s=3600.0, down_after=3,
                                hedge_ms=0)
        gw2 = t_gw.FabricGateway([live], poll_s=3600.0, down_after=3,
                                 hedge_ms=0)
        try:
            # strong reads bypass the edge cache: every query fails over
            for _ in range(8):
                out = await _w(gw.query({"subsys": "serverstatus",
                                         "maxrecs": 1,
                                         "consistency": "strong"}))
                assert out["nrecs"] == 1         # never raises
            dead = gw.upstreams[0]
            assert dead.state == "down"
            assert gw.stats.counters.get(
                f"gw_upstream_flaps|upstream={dead.label}") == 1
            assert gw.stats.counters.get("gw_upstream_errors", 0) >= 3
            assert gw._ranked()[0].label == f"{live[0]}:{live[1]}"
            # half-open probe on the ONLY upstream
            u = gw2.upstreams[0]
            for _ in range(3):
                u.record_fail()
            assert u.state == "down"
            u.probe_at = 0.0                     # probe due NOW
            out = await _w(gw2.query({"subsys": "serverstatus",
                                      "maxrecs": 1,
                                      "consistency": "strong"}))
            assert out["nrecs"] == 1 and u.state == "up"
            assert gw2.stats.counters.get(
                f"gw_upstream_recoveries|upstream={u.label}") == 1
        finally:
            await _w(gw.stop())
            await _w(gw2.stop())
            await reps.stop()

    asyncio.run(scenario())


def test_hedged_read_first_response_wins():
    async def scenario():
        gw = t_gw.FabricGateway([("a", 1), ("b", 2)], hedge_ms=30.0)
        slow, fast = gw.upstreams
        slow.ewma_ms, fast.ewma_ms = 1.0, 2.0   # rank slow first

        async def fake(u, req, timeout=None):
            if u is slow:
                await asyncio.sleep(0.5)
                return {"snaptick": 1, "who": "slow"}
            return {"snaptick": 1, "who": "fast"}

        gw._query_one = fake
        gw._rr = 1                               # rotation lands at 0
        t0 = time.monotonic()
        out = await _w(gw._upstream_query({"subsys": "svcstate"}))
        assert out["who"] == "fast"
        assert time.monotonic() - t0 < 0.4       # did not wait out slow
        assert gw.stats.counters.get("gw_hedged_requests") == 1
        assert gw.stats.counters.get("gw_hedged_wins") == 1
        # a primary answering INSIDE the budget never hedges
        gw.stats.counters.pop("gw_hedged_requests", None)
        slow.ewma_ms, fast.ewma_ms = 5.0, 1.0   # rank fast first
        gw._rr = 1
        out = await _w(gw._upstream_query({"subsys": "svcstate"}))
        assert out["who"] == "fast"
        assert gw.stats.counters.get("gw_hedged_requests", 0) == 0
        gw._render.close()
        gw.subs.close()

    asyncio.run(scenario())


def test_rendezvous_owner_consistent_balanced_and_like_reference():
    a = t_gw.FabricGateway([DEAD], advertise="127.0.0.1:1111",
                           peers=[("127.0.0.1", 2222)])
    b = t_gw.FabricGateway([DEAD], advertise="127.0.0.1:2222",
                           peers=[("127.0.0.1", 1111)])
    ja = j_gw.FabricGateway([DEAD], advertise="127.0.0.1:1111",
                            peers=[("127.0.0.1", 2222)])
    owned_a = 0
    for i in range(200):
        key = f"key-{i}"
        oa, ob = a._owner_peer(key), b._owner_peer(key)
        assert oa == ja._owner_peer(key), key
        if oa is None:
            assert ob == ("127.0.0.1", 1111), key
            owned_a += 1
        else:
            assert oa == ("127.0.0.1", 2222) and ob is None, key
    assert 50 < owned_a < 150, owned_a
    # the advertised identity also comes in through the env mapping
    c = t_gw.FabricGateway([DEAD], env={"GYT_GW_ADVERTISE": "h:1",
                                        "GYT_GW_DOWN_AFTER": "5",
                                        "GYT_GW_HEDGE_MS": "12"})
    assert (c._ident(), c.down_after, c.hedge_ms) == ("h:1", 5, 12.0)
    d = t_gw.FabricGateway([DEAD])
    assert (d.down_after, d.hedge_ms, d.poll_s, d.neg_ttl_s) == \
        (3, 75.0, 0.5, 2.0)
    for g in (a, b, ja, c, d):
        g._render.close()
        g.subs.close()


def test_owner_down_falls_back_to_scan():
    async def scenario():
        holder = t_gw.FabricGateway([DEAD], poll_s=3600.0)
        hh, hp = await _w(holder.start())
        gw = t_gw.FabricGateway([DEAD], poll_s=3600.0,
                                peers=[DEAD, (hh, hp)], peer_timeout_s=2.0)
        try:
            holder._cache_put((7, "k0"),
                              ["ok", {"snaptick": 7, "v": 42}, None])
            gw._owner_peer = lambda key: DEAD    # the owner is down
            got = await _w(gw._peer_get(7, "k0", {"subsys": "svcstate"}))
            assert got == ("hit", {"snaptick": 7, "v": 42})
            assert gw.stats.counters.get("gw_peer_owner_down") == 1
            assert gw.stats.counters.get("gw_peer_errors") == 1
        finally:
            await _w(gw.stop())
            await _w(holder.stop())

    asyncio.run(scenario())


def test_peer_conn_recovery_after_mid_exchange_kill():
    async def scenario():
        async def trap(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            try:
                await reader.readexactly(10)
            except asyncio.IncompleteReadError:
                pass
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Le")  # torn
            await writer.drain()
            writer.close()

        trap_srv = await asyncio.start_server(trap, "127.0.0.1", 0)
        th, tp = trap_srv.sockets[0].getsockname()[:2]
        gw = t_gw.FabricGateway([DEAD], poll_s=3600.0, peers=[(th, tp)],
                                peer_timeout_s=1.0)
        peer = None
        try:
            gw._owner_peer = lambda key: (th, tp)
            got = await _w(gw._peer_get(3, "k", {"subsys": "svcstate"}))
            assert got is None
            assert gw.stats.counters.get("gw_peer_errors", 0) >= 1
            ent = gw._peer_conns.get((th, tp))
            assert ent is None or ent[1] is None     # conn torn down
            trap_srv.close()
            await _w(trap_srv.wait_closed())
            # a real gateway takes over the address: the next exchange
            # reconnects and the response routes correctly
            peer = t_gw.FabricGateway([DEAD], poll_s=3600.0, host=th,
                                      port=tp)
            await _w(peer.start())
            peer._cache_put((3, "k"), ["ok", {"snaptick": 3, "v": 7},
                                       None])
            got = await _w(gw._peer_get(3, "k", {"subsys": "svcstate"}))
            assert got == ("hit", {"snaptick": 3, "v": 7})
        finally:
            trap_srv.close()
            await _w(gw.stop())         # the peer's client: first
            if peer is not None:
                await _w(peer.stop())

    asyncio.run(scenario())


def _mk_fetch(state):
    # wide stable rows + ONE changing row per tick: a delta genuinely
    # beats the full body, so continuation replay is a real delta
    pad = "x" * 64

    async def fetch(req):
        t = state["t"]
        recs = [{"hostid": f"h{i}", "v": i * 1000, "pad": pad}
                for i in range(40)]
        recs[0] = {"hostid": "h0", "v": t, "pad": pad}
        return {"subsys": req.get("subsys", "svcstate"), "nrecs": 40,
                "snaptick": t, "recs": recs}
    return fetch


async def _ring(mod, stats_cls, path):
    """A hub persisting its rings, restarted over the same file: the
    events a reconnect gets inside and outside the restored ring."""
    state = {"t": 0}
    fetch = _mk_fetch(state)
    hub = mod.SubscriptionHub(fetch, stats_cls(), persist_path=path)
    got = []

    async def send(ev):
        got.append(ev)

    sid = await hub.subscribe({"subsys": "svcstate"}, send)
    for t in (1, 2, 3):
        state["t"] = t
        await hub.push_tick()
    hub.unsubscribe(sid)
    retained = len(hub._versions)
    hub.close()
    state["t"] = 5
    hub2 = mod.SubscriptionHub(fetch, stats_cls(), persist_path=path)
    got2, got3 = [], []

    async def send2(ev):
        got2.append(ev)

    async def send3(ev):
        got3.append(ev)

    await hub2.subscribe({"subsys": "svcstate"}, send2, last_snaptick=2)
    await hub2.subscribe({"subsys": "svcstate"}, send3, last_snaptick=-99)
    held_v2 = await _mk_fetch({"t": 2})({"subsys": "svcstate"})
    out = {"events": got, "retained": retained, "resume": got2,
           "resync": got3,
           "applied": json.dumps(D.apply_event(held_v2, got2[0])),
           "fresh": json.dumps(await fetch({"subsys": "svcstate"})),
           "ctrs": dict(hub2.stats.counters),
           "restored": hub2.stats.gauges.get(
               "gw_sub_persist_restored_keys")}
    hub2.close()
    return out


def test_hub_persisted_ring_replays_deltas(tmp_path):
    got = asyncio.run(_ring(t_subs, Stats, str(tmp_path / "t.jsonl")))
    ref = asyncio.run(_ring(j_subs, JStats, str(tmp_path / "j.jsonl")))
    assert got == ref
    assert got["retained"] == 1 and got["restored"] == 1.0
    assert got["resume"][0]["t"] == "delta" \
        and got["resume"][0]["base"] == 2
    assert got["ctrs"]["gw_sub_resumes"] == 1
    assert got["applied"] == got["fresh"]
    assert got["resync"][0]["t"] == "full" \
        and got["resync"][0].get("resync") is True
    assert got["ctrs"]["gw_sub_resyncs"] == 1
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


def test_hub_persist_torn_tail_and_compaction(tmp_path):
    path = str(tmp_path / "subs.jsonl")

    async def scenario():
        state = {"t": 0}
        fetch = _mk_fetch(state)
        hub = t_subs.SubscriptionHub(fetch, Stats(), persist_path=path)

        async def send(ev):
            pass

        await hub.subscribe({"subsys": "svcstate"}, send)
        state["t"] = 1
        await hub.push_tick()
        hub.close()
        with open(path, "ab") as f:          # the torn tail
            f.write(b'{"k": "torn')
        hub2 = t_subs.SubscriptionHub(fetch, Stats(), persist_path=path,
                                      persist_max=1)
        assert hub2.stats.counters.get("gw_sub_persist_torn") == 1
        assert len(hub2._versions) == 1      # complete lines restored
        state["t"] = 2
        await hub2.subscribe({"subsys": "svcstate"}, send)
        assert hub2.stats.counters.get("gw_sub_persist_compactions",
                                       0) >= 1
        hub2.close()
        with open(path, "rb") as f:
            assert all(json.loads(ln) for ln in f.read().splitlines())

    asyncio.run(scenario())


def test_retained_ring_bounded():
    async def scenario():
        hub = t_subs.SubscriptionHub(_mk_fetch({"t": 0}), Stats(),
                                     retain=3)

        async def send(ev):
            pass

        for i in range(8):
            sid = await hub.subscribe(
                {"subsys": "svcstate", "maxrecs": 10 + i}, send)
            hub.unsubscribe(sid)
        assert len(hub._versions) == 3
        assert hub.stats.counters.get("gw_sub_retained_evicted") == 5

    asyncio.run(scenario())


def test_subscribe_client_stall_typed():
    async def scenario():
        reps = await Replicas(n=1, seed=31).start()
        sc = t_subs.SubscribeClient()
        try:
            await _w(sc.connect(*reps.addrs[0]))
            await _w(sc.subscribe({"subsys": "hoststate", "maxrecs": 16}))
            agen = sc.events(stall_timeout=0.4)
            ev = await _w(agen.__anext__())
            assert ev["t"] == "full"
            # the hub is FROZEN now (no ticks, no pushes): typed stall
            t0 = time.monotonic()
            with pytest.raises(t_subs.SubscriptionStalled):
                await _w(agen.__anext__())
            assert 0.3 < time.monotonic() - t0 < 5.0
        finally:
            await _w(sc.close())
            await reps.stop()

    asyncio.run(scenario())


def test_subscribe_stream_failover_byte_equal():
    """Kill the gateway a supervised stream is attached to: the stream
    hops to the next with ``last_snaptick`` and stays byte-identical
    to a fresh render, with no resync."""
    async def scenario():
        reps = await Replicas(n=1, seed=41).start()
        gw1 = _mk("port", reps.addrs)
        gw2 = _mk("port", reps.addrs)
        h1, p1 = await _w(gw1.start())
        h2, p2 = await _w(gw2.start())
        stream = t_subs.SubscribeStream([(h1, p1), (h2, p2)], Q,
                                        stall_timeout=2.0,
                                        backoff_base=0.05)
        seen = []

        async def consume():
            async for held in stream.responses():
                seen.append(held)

        task = asyncio.create_task(consume())
        try:
            await _until(lambda: gw1.fabric_tick >= reps.tick
                         and gw2.fabric_tick >= reps.tick,
                         "tick discovery")
            await _until(lambda: seen, "the initial full")
            reps.advance()
            n = len(seen)
            await _until(lambda: len(seen) > n, "a delta via gw1")
            await _w(gw1.stop())
            e0 = stream.counters["events"]
            await _until(lambda: stream.counters["events"] > e0,
                         "the re-subscribe ack from gw2", timeout=30.0)
            assert stream.counters["reconnects"] >= 1
            reps.advance()
            n = len(seen)
            await _until(lambda: len(seen) > n, "continuation via gw2",
                         timeout=30.0)
            fresh = await _w(gw2.query(dict(Q)))
            await _until(lambda: seen[-1]["snaptick"] == fresh["snaptick"],
                         "the converged tick")
            assert json.dumps(seen[-1]) == json.dumps(
                json.loads(json.dumps(fresh)))
            assert stream.counters.get("resyncs", 0) == 0
            assert stream.counters.get("forced_resyncs", 0) == 0
        finally:
            stream.stop()
            task.cancel()
            await _w(gw2.stop())
            await reps.stop()

    asyncio.run(scenario())
