"""The port's ``NetAgent`` against the reference's, byte for byte.

Both packages' agents are given the same machine id, seed, host id and
sweep count with no socket (the state ``_connect`` leaves: the one-host
sim at the host id, an ``EdgeFold`` on the same advert), and build:

- raw sim sweeps, sweeps pre-aggregated under one advert, and sweeps
  with tracing on for some services: the bytes equal, the sequence
  marks in them equal;
- the inventory ``send_names`` writes, and ``_stats_report_frame``
  after the same counter moves;
- the supervision ledger: drop-oldest in the byte-bounded spool,
  ``_respool_unconfirmed`` and ``_prune_acked`` give equal counters.

Against the port's ``GytServer(device="cpu")`` over loopback: a
supervised agent (``run_forever``) loses its conn, spools, reconnects
under its host id and resends the spool; the server's batched feeds
(``Runtime.feed_batch``) fold a fleet as one feed a conn read does, and
a failing piece fails its own conn alone; the live capture constructs,
and a refused AF_PACKET socket turns it off for good without an error;
the agent's import chain, the capture and its parsers included, loads no
``torch``. The fleet's
task groups at a madhava's task table (3,072 groups in 4,096 slots) meet
the same probe failures in both packages' table. Everything compared is
exact: no float is computed on a device.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gyeeta_tpu.net import agent as j_agent
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.sketch import edgefold as j_ef
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.net import agent as t_agent
from gyeeta_tpu_torch.sim.partha import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import edgefold as t_ef
from gyeeta_tpu_torch.utils.config import RuntimeOpts

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 20.0                  # every socket wait, seconds
# a small CPU server geometry (the fold runs through the plain versions)
CFG = EngineCfg(n_hosts=16, svc_capacity=128, task_capacity=256,
                api_capacity=64, conn_batch=256, resp_batch=512,
                listener_batch=64, fold_k=2, cms_width=1 << 10,
                hh_width=256, topk_capacity=16, hll_p_svc=4,
                hll_p_global=8)
OPTS = RuntimeOpts(dep_pair_capacity=256, dep_edge_capacity=256)
SWEEP = dict(n_conn=48, n_resp=96)


def _w(coro):
    return asyncio.wait_for(coro, TIMEOUT)


async def _until(pred, what):
    async def spin():
        while not pred():
            await asyncio.sleep(0.005)
    try:
        await _w(spin())
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


class _Sink:
    """A writer that keeps what is written (``send_names`` target)."""

    def __init__(self):
        self.buf = b""

    def write(self, b):
        self.buf += b

    async def drain(self):
        pass

    def is_closing(self):
        return False


def _pair(hid=3, seed=5, preagg=None, **kw):
    """(reference, port) agents in the state a registration leaves."""
    out = []
    for mod, Sim, ef in ((j_agent, JSim, j_ef), (t_agent, TSim, t_ef)):
        a = mod.NetAgent(seed=seed, **kw)
        a.host_id = hid
        a.sim = Sim(n_hosts=1, n_svcs=a.n_svcs, n_groups=a.n_groups,
                    seed=1000 + hid, host_base=hid)
        if preagg is not None:
            a._preagg_params = preagg
            a._edgefold = ef.EdgeFold(preagg, host_id=hid)
        out.append(a)
    return out


def _advert():
    from gyeeta_tpu_torch.sketch import loghist
    cfg = EngineCfg(svc_capacity=64, n_hosts=8, hll_p_svc=4, hll_p_global=8,
                    cms_width=1 << 10, topk_capacity=16, topk_budget=48,
                    td_capacity=16, hh_width=256, conn_batch=64,
                    resp_batch=128, listener_batch=32, fold_k=4,
                    resp_spec=loghist.LogHistSpec(1.0, 1e8, 32))
    return t_ef.params_of_cfg(cfg)


def _marks(buf):
    recs, _, _ = wire.drain2(buf)
    return [(int(r["host_id"]), int(r["seq"]))
            for r in recs[wire.NOTIFY_SWEEP_SEQ]]


SWEEP_MODES = {
    "raw": dict(),
    "preagg": dict(preagg=True),
    "trace": dict(trace=True),
    "raw_seed9_host0": dict(seed=9, hid=0),
}


@pytest.mark.parametrize("mode", sorted(SWEEP_MODES))
def test_sweeps_byte_equal_to_reference(mode):
    kw = dict(SWEEP_MODES[mode])
    trace = kw.pop("trace", False)
    if kw.pop("preagg", False):
        kw["preagg"] = _advert()
    j, t = _pair(**kw)
    assert j.machine_id == t.machine_id
    if trace:
        on = {int(g) for g in j.sim.glob_ids.reshape(-1)[:2]}
        j.trace_enabled, t.trace_enabled = set(on), set(on)
    for k in range(4):
        bj, bt = j.build_sweep(**SWEEP), t.build_sweep(**SWEEP)
        assert bt == bj, f"sweep {k}"
        # each sweep opens with its sequence mark, 1, 2, 3, ...
        assert _marks(bt) == _marks(bj) == [(j.host_id, k + 1)]
    assert dict(t.stats.counters) == dict(j.stats.counters)
    if trace:
        recs, _, _ = wire.drain2(bt)
        assert len(recs[wire.NOTIFY_REQ_TRACE]) > 0
    if "preagg" in kw:
        assert t.stats.counters["preagg_sweeps"] == 4


@pytest.mark.parametrize("collect", [False, True], ids=["sim", "collect"])
def test_send_names_byte_equal(collect):
    j, t = _pair(hid=2, collect=collect)
    if collect:
        # the host info is this host's, read twice: hold the cloud probe
        # off in both (the port reads an env mapping, None = none)
        t.env = {}
    sinks = []
    for a in (j, t):
        a._writer = _Sink()
        asyncio.run(a.send_names())
        sinks.append(a._writer.buf)
    if collect:
        # boot time, memory and the rest are this host's: compare the
        # record kinds and the names announced
        rj, _, _ = wire.drain2(sinks[0])
        rt, _, _ = wire.drain2(sinks[1])
        assert sorted(rj) == sorted(rt)
        assert (rt[wire.NOTIFY_NAME_INTERN].tobytes()
                == rj[wire.NOTIFY_NAME_INTERN].tobytes())
    else:
        assert sinks[1] == sinks[0]


def test_stats_report_frame_equal():
    j, t = _pair()
    assert j._stats_report_frame() == t._stats_report_frame() == b""
    for a in (j, t):
        a.stats.bump("spool_dropped", 3)
        a.stats.bump("spool_dropped_records", 90)
        a.stats.bump("spool_resent", 2)
    fj, ft = j._stats_report_frame(), t._stats_report_frame()
    assert ft == fj != b""
    # deltas: a second report with nothing new is empty
    assert j._stats_report_frame() == t._stats_report_frame() == b""
    for a in (j, t):
        a.stats.bump("connect_timeouts")
    assert j._stats_report_frame() == t._stats_report_frame() != b""


def _ledger(a):
    return (dict(a.stats.counters), a.spool_len(), a.spool_records(),
            a._spool_bytes, [e[2] for e in a._spool],
            [e[2] for e in a._unconfirmed])


def test_spool_ledger_equal():
    """Drop-oldest past the byte bound, respool of the unconfirmed
    tail, and the prune of sweeps the server's durable mark covers."""
    res = []
    for a in _pair(spool_max_bytes=60_000, resend_last=2):
        bufs = [a.build_sweep(**SWEEP) for _ in range(7)]
        for i, b in enumerate(bufs[:5]):
            a._spool_push(b, wire.count_events(b), seq=i + 1)
        steps = [_ledger(a)]
        for i, b in enumerate(bufs[5:]):
            a._unconfirmed.append((b, wire.count_events(b), 6 + i))
        a._respool_unconfirmed()
        steps.append(_ledger(a))
        a._prune_acked(7)
        steps.append(_ledger(a))
        res.append(steps)
    assert res[1] == res[0]
    c = res[1][-1][0]
    assert c["spool_dropped"] > 0 and c["spool_pruned_acked"] > 0
    # records built = sent + still buffered + dropped
    built = sum(wire.count_events(b) for b in bufs)
    assert built == (c.get("records_sent", 0) + res[1][-1][2]
                     + c["spool_dropped_records"])


def test_livecap_constructs():
    a = t_agent.NetAgent(seed=1, real=True, livecap=True, cap_ifname="lo")
    assert a.livecap and a.cap_ifname == "lo"
    assert a._cap is None and a._cap_ports == set() and not a._cap_denied


class _Tcp:
    """A stand-in for the socket sweep: one traced listener port."""

    def __init__(self, ports):
        self.ports = ports

    def listener_ports(self, gids):
        return set(self.ports) if gids else set()


def test_livecap_denied_is_final(monkeypatch):
    """No CAP_NET_RAW: the first sweep that wants a capture meets a
    PermissionError, sets ``_cap_denied`` and never asks again."""
    import socket as _socket
    tries = []

    def refuse(*a, **k):
        tries.append(a)
        raise PermissionError(1, "Operation not permitted")
    monkeypatch.setattr(_socket, "socket", refuse)
    a = t_agent.NetAgent(seed=1, real=True, livecap=True)
    a._tcpconn = _Tcp({8080})
    a.trace_enabled = {7}
    assert a._livecap_frames() == b"" and a._cap_denied
    assert a._cap is None and len(tries) == 1
    assert a._livecap_frames() == b"" and len(tries) == 1


def test_livecap_transient_error_retries(monkeypatch):
    """Another OSError is transient: no capture, not denied, and the
    next sweep tries again."""
    import socket as _socket
    tries = []

    def fail(*a, **k):
        tries.append(a)
        raise OSError(19, "No such device")
    monkeypatch.setattr(_socket, "socket", fail)
    a = t_agent.NetAgent(seed=1, real=True, livecap=True)
    a._tcpconn = _Tcp({8080})
    a.trace_enabled = {7}
    assert a._livecap_frames() == b"" and not a._cap_denied
    assert a._livecap_frames() == b"" and len(tries) == 2


def test_agent_import_chain_loads_no_torch():
    """An agent host has no GPU: the agent, its collectors, the chaos
    proxy, the NM client and the command line load no ``torch``."""
    code = (
        "import sys\n"
        "import gyeeta_tpu_torch.cli, gyeeta_tpu_torch.__main__\n"
        "from gyeeta_tpu_torch.net import agent, collect, tcpconn, taskproc\n"
        "from gyeeta_tpu_torch.net import procconn, taskdelays\n"
        "from gyeeta_tpu_torch.sim import chaos, nodeweb\n"
        "from gyeeta_tpu_torch.utils import cloudmeta, ids, replay\n"
        "from gyeeta_tpu_torch.obs import format_top\n"
        "from gyeeta_tpu_torch.trace import livecap, dnssnoop\n"
        "a = agent.NetAgent(seed=1)\n"
        "a.host_id = 0\n"
        "from gyeeta_tpu_torch.sim.partha import ParthaSim\n"
        "a.sim = ParthaSim(n_hosts=1, n_svcs=4, n_groups=6, seed=1000)\n"
        "assert len(a.build_sweep())\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'gyeeta_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------- over sockets
def _server(**kw):
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.runtime import Runtime
    rt = Runtime(CFG, OPTS, device="cpu")
    return rt, GytServer(rt, tick_interval=None, **kw)


def test_supervised_reconnect_resends_spool():
    """The server drops the agent's conn: the agent spools its sweeps,
    reconnects under its first host id, resends the spool and reports
    the resend, which the server folds into its counters."""
    async def go():
        rt, srv = _server()
        a = t_agent.NetAgent(seed=7, n_svcs=2, n_groups=3,
                             connect_timeout=2.0)
        stop = asyncio.Event()
        c = rt.stats.counters
        try:
            host, port = await _w(srv.start())
            task = asyncio.create_task(a.run_forever(
                host, port, interval=0.05, **SWEEP, backoff_base=0.05,
                backoff_cap=0.2, stop=stop))
            await _until(lambda: c.get("sweep_marks", 0) >= 3,
                         "three sweeps")
            hid = a.host_id
            a._writer.transport.abort()      # the conn dies under it
            await _until(lambda: a.stats.counters.get("agent_reconnects",
                                                      0) >= 1
                         and c.get("spool_resent", 0) >= 1,
                         "the reconnect and the resend report")
            stop.set()
            await _w(task)
            return hid, a, dict(c)
        finally:
            await a.close()
            await srv.stop()
    hid, a, c = asyncio.run(go())
    assert a.host_id == hid
    assert c["agent_reconnects"] == 1
    assert a.stats.counters["spool_resent"] >= 1
    assert c["spool_resent"] == a.stats.counters["spool_resent"]
    assert a.stats.counters.get("spool_dropped", 0) == 0


def _fleet_views(record_path):
    """Four agents sending two sweeps each at once into a recording
    server → its four state views, rows sorted by identity, and its
    counters."""
    async def go():
        rt, srv = _server(record_path=str(record_path))
        feed_batch = rt.feed_batch

        def counted(pieces):
            batches.append(len(pieces))
            return feed_batch(pieces)
        rt.feed_batch = counted
        agents = [t_agent.NetAgent(seed=20 + i, n_svcs=2, n_groups=3)
                  for i in range(4)]
        c = rt.stats.counters
        try:
            host, port = await _w(srv.start())
            for a in agents:        # one at a time: the same host ids
                n0 = c.get("names_interned", 0)
                await _w(a.connect(host, port))
                await _until(lambda: c.get("names_interned", 0) > n0,
                             "an inventory")
            for k in range(2):
                await _w(asyncio.gather(*(a.send_sweep(**SWEEP)
                                          for a in agents)))
                await _until(lambda: c.get("sweep_marks", 0)
                             >= 4 * (k + 1), "the sweeps")
            srv._feed_barrier()
            rt.flush()
            rt.run_tick()
            return _views(rt), dict(c)
        finally:
            for a in agents:
                await a.close()
            await srv.stop()
    batches: list = []
    views, c = asyncio.run(go())
    return views, c, batches


def _views(rt):
    key = lambda r: json.dumps(r, sort_keys=True)   # noqa: E731
    return {s: sorted(rt.query({"subsys": s, "maxrecs": 1000})["recs"],
                      key=key)
            for s in ("svcstate", "hoststate", "taskstate",
                      "clusterstate")}


def test_coalesced_feeds_fold_like_direct(tmp_path):
    """The server's batched feeds (the conns ready in one loop iteration
    share a fold boundary) against the direct path: a runtime fed the
    same bytes one ``feed`` a recorded read, a boundary each."""
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils import replay
    cap = tmp_path / "fleet.gytrec"
    batched, cb, batches = _fleet_views(cap)
    rt = Runtime(CFG, OPTS, device="cpu")
    n_reads = 0
    for _, chunk in replay.read_chunks(cap):
        rt.feed(chunk)
        n_reads += 1
    rt.flush()
    rt.run_tick()
    cd = dict(rt.stats.counters)
    assert _views(rt) == batched
    # every recorded read went through a batch, some shared one
    assert sum(batches) == n_reads and len(batches) >= 1
    for k in ("conn_events", "resp_events", "sweep_marks"):
        assert cb[k] == cd[k]


def test_feed_batch_attributes_a_poison_piece():
    from gyeeta_tpu_torch.runtime import Runtime
    sims = [TSim(n_hosts=1, n_svcs=2, n_groups=3, seed=40 + i, host_base=i)
            for i in range(3)]
    pieces = [s.conn_frames(32) + s.listener_frames() for s in sims]
    bad = bytearray(pieces[1])
    bad[:4] = b"\xde\xad\xbe\xef"            # poison magic
    seq = Runtime(CFG, OPTS, device="cpu")
    for p in (pieces[0], pieces[2]):
        seq.feed(p)
    bat = Runtime(CFG, OPTS, device="cpu")
    res = bat.feed_batch([(pieces[0], 0, 1), (bytes(bad), 1, 2),
                          (pieces[2], 2, 3)])
    assert isinstance(res[1], wire.FrameError)
    assert res[0] == res[2] == 32 + 2
    seq.flush()
    bat.flush()
    for s in ("svcstate", "hoststate"):
        a = seq.query({"subsys": s, "maxrecs": 100})
        b = bat.query({"subsys": s, "maxrecs": 100})
        key = lambda r: json.dumps(r, sort_keys=True)   # noqa: E731
        assert sorted(a["recs"], key=key) == sorted(b["recs"], key=key)
    assert bat.stats.counters["frames_bad"] == 1
    assert len(res) == 3
    assert np.all(bat.stats.counters["conn_events"]
                  == seq.stats.counters["conn_events"])


def _poison_pieces():
    sims = [TSim(n_hosts=1, n_svcs=2, n_groups=3, seed=40 + i, host_base=i)
            for i in range(3)]
    return [s.conn_frames(32) + s.listener_frames() for s in sims]


def _plant(rt, bad_hid):
    """Make the runtime's feed of host ``bad_hid``'s piece fail with an
    error that is not a ``FrameError`` (a failure past validation)."""
    feed = rt.feed

    def failing(buf, hid=0, conn_id=0):
        if hid == bad_hid:
            raise RuntimeError("planted")
        return feed(buf, hid=hid, conn_id=conn_id)
    rt.feed = failing


def test_feed_batch_stops_at_a_failing_piece():
    """A non-FrameError failure in the middle of a batch: the pieces
    before it stand (folded as a runtime fed only them), it and the
    pieces after it get the error; a failure of the closing fold
    boundary goes to the last piece taken."""
    from gyeeta_tpu_torch.runtime import Runtime
    pieces = _poison_pieces()
    seq = Runtime(CFG, OPTS, device="cpu")
    seq.feed(pieces[0])
    bat = Runtime(CFG, OPTS, device="cpu")
    _plant(bat, 1)
    res = bat.feed_batch([(p, i, i + 1) for i, p in enumerate(pieces)])
    assert res[0] == 32 + 2
    assert all(isinstance(r, RuntimeError) for r in res[1:])
    seq.flush()
    bat.flush()
    assert _views(bat) == _views(seq)
    assert bat.stats.counters["conn_events"] == 32

    end = Runtime(CFG, OPTS, device="cpu")
    dispatch = end._dispatch_fused_pending
    calls = [0]

    def closing_fails():
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("boundary")
        return dispatch()
    end._dispatch_fused_pending = closing_fails
    bad = bytearray(pieces[2])
    bad[:4] = b"\xde\xad\xbe\xef"
    res = end.feed_batch([(pieces[0], 0, 1), (pieces[1], 1, 2),
                          (bytes(bad), 2, 3)])
    assert res[0] == 32 + 2
    assert isinstance(res[1], RuntimeError) and str(res[1]) == "boundary"
    assert isinstance(res[2], wire.FrameError)


def test_server_batch_failure_fails_its_own_conns():
    """The serving edge hands each queued piece its own result: the
    conn whose piece folded gets its record count, the failing one and
    those queued after it get the error."""
    async def go():
        rt, srv = _server()
        _plant(rt, 1)
        pieces = _poison_pieces()
        futs = [srv._feed_later(p, i, i + 1) for i, p in enumerate(pieces)]
        done = await _w(asyncio.gather(*futs, return_exceptions=True))
        return done, dict(rt.stats.counters)
    done, c = asyncio.run(go())
    assert done[0] == 32 + 2
    assert all(isinstance(r, RuntimeError) for r in done[1:])
    assert c["conn_events"] == 32


# the fleet's task groups at phase 15's host count in a 4,096-slot task
# table (75 % load): both packages' tables drop the same groups after
# PROBES rounds, and which ones depends on the order the groups fold in
@pytest.mark.parametrize("order,hosts_a_batch,dropped", [
    ("host", 1, 1), ("host", 512, 2), ("shuffled", 1, 0)])
def test_task_table_drops_at_madhava_load(order, hosts_a_batch, dropped):
    import jax
    import jax.numpy as jnp
    import torch

    from gyeeta_tpu.engine import table as j_table
    from gyeeta_tpu_torch.engine import table as t_table
    from gyeeta_tpu_torch.ingest import decode
    hids = np.arange(512)
    if order == "shuffled":
        hids = np.random.default_rng(3).permutation(512)
    keys = {}
    for h in hids.tolist():       # the agent's one-host sim at its host id
        r = TSim(n_hosts=1, n_svcs=4, n_groups=6, seed=1000 + h,
                 host_base=h).aggr_task_records()
        keys[h] = decode.split_u64(r["aggr_task_id"])
    jt, tt = j_table.init(4096), t_table.init(4096, device="cpu")
    up = jax.jit(j_table.upsert)
    for i in range(0, len(hids), hosts_a_batch):
        hs = hids[i:i + hosts_a_batch].tolist()
        hi = np.concatenate([keys[h][0] for h in hs]).astype(np.int64)
        lo = np.concatenate([keys[h][1] for h in hs]).astype(np.int64)
        jt, jrows = up(jt, jnp.asarray(hi.astype(np.uint32)),
                       jnp.asarray(lo.astype(np.uint32)))
        tt, trows = t_table.upsert(tt, torch.from_numpy(hi),
                                   torch.from_numpy(lo))
        assert np.array_equal(np.asarray(jrows).astype(np.int64),
                              trows.numpy())
    assert int(jt.n_drop) == int(tt.n_drop) == dropped
    assert int(jt.n_live) == int(tt.n_live) == 6 * 512 - dropped
