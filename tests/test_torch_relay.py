"""The port's remote ingest relay (``gyeeta_tpu_torch/net/relay.py``):
the reference's tests of ``tests/test_relay.py`` on the port's classes,
with the port's ``GytServer`` over ``Runtime(device="cpu")`` and the
reference's ``NetAgent`` objects, plus the cross-package case: the
reference's ``RelayWorker`` (JAX-free) uplinking into the port's
``RelayHub``, with exact gap counts and the agents' rows folded.

Three layers: the publisher's drop-oldest spool keeps ``cum`` exact
(published records either sit in the spool or are counted dropped);
the hub's gap math recovers EXACT drop counts from the cumulative
chains across spool sheds and epoch boundaries; and a real
GytServer + RelayWorker + NetAgent fleet over sockets holds
``published == consumed + counted drops`` end to end, including a
relay process restart (new token => finalized epoch).
"""

from __future__ import annotations

import asyncio
import threading
import time
import types

import numpy as np
import pytest
import torch

from gyeeta_tpu.net import NetAgent
from gyeeta_tpu.net import relay as j_relay
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.net import relay as R
from gyeeta_tpu_torch.net.server import GytServer
from gyeeta_tpu_torch.runtime import Runtime as _Runtime
from gyeeta_tpu_torch.utils.selfstats import Stats

def Runtime(cfg):
    return _Runtime(cfg, device="cpu")


CFG = EngineCfg(n_hosts=8, svc_capacity=256, task_capacity=256,
                conn_batch=256, resp_batch=512, listener_batch=64,
                fold_k=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run the fold (PyTorch's CPU ops on the loop thread)
    beside a relay thread that need the CPU at the same time; PyTorch's pool of a
    thread a core spins between ops and, beside other test processes,
    starved them (about 50x slower in a four-process run). One thread
    keeps them near their time alone; the module restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ publisher

def test_publisher_cum_and_spool_shed():
    pub = R.RelayPublisher(slot_payload=1 << 20, spool_max=1 << 20)
    # publish 10 batches of ~300KB: the 1MB spool can hold ~3
    for i in range(10):
        pub.publish(0, b"x" * 300_000, 100)
    assert pub.counter("published_records") == 1000
    assert pub.counter("published_slots") == 10
    assert pub.cum() == {0: 1000}
    # drop-oldest kept the spool bounded and counted every shed record
    assert pub.spool_bytes <= 1 << 20
    shed = pub.counter("spool_dropped_records")
    kept = sum(R._BH.unpack_from(f, R._FH.size)[1] for f in pub.spool)
    assert shed + kept == 1000
    assert pub.counter("spool_dropped_batches") == 10 - len(pub.spool)
    # cum advanced at PUBLISH time: the newest retained frame still
    # anchors the full chain, so the consumer sees the shed as a gap
    _s, _n, _q, cum = R._BH.unpack_from(pub.spool[-1], R._FH.size)
    assert cum == 1000


def test_publisher_rejects_oversize():
    pub = R.RelayPublisher(slot_payload=1024, spool_max=1 << 20)
    with pytest.raises(ValueError):
        pub.publish(0, b"y" * 2048, 1)


# ------------------------------------------------------- hub gap math

class _RtStub:
    def __init__(self):
        self.stats = Stats()
        self.notifylog = types.SimpleNamespace(
            add=lambda *a, **k: None)
        self.n = 1
        self.ingested = []

    def ingest_records(self, recs, shard=None):
        self.ingested.append((shard, recs))


def _batch_frame(shard, nrec, seq, cum, payload=b""):
    return R._BH.pack(shard, nrec, seq, cum) + payload


def test_hub_counts_exact_gaps_and_epoch_finalize():
    rt = _RtStub()
    hub = R.RelayHub(rt, lambda *a: (0, 0, 0))
    st = R._RelayState("r1")
    # batches 1..3 on shard 0, 100 recs each; batch 2 lost in transit
    hub._on_batch(st, _batch_frame(0, 100, 1, 100))
    hub._on_batch(st, _batch_frame(0, 100, 3, 300))
    c = rt.stats.snapshot()
    assert c["relay_published_records|relay=r1"] == 300
    assert c["relay_consumed_records|relay=r1"] == 200
    assert c["relay_dropped_records|relay=r1,shard=0"] == 100
    # heartbeat advertises a higher cum (records still in a spool that
    # then dies with the process): epoch finalize closes the books
    hub._on_hb(st, {"cum": {"0": 450}, "counters": {}})
    assert rt.stats.snapshot()[
        "relay_published_records|relay=r1"] == 450
    hub._finalize_epoch(st)
    c = rt.stats.snapshot()
    assert c["relay_dropped_records|relay=r1,shard=0"] == 100 + 150
    # ledger: published == consumed + dropped, exactly
    assert c["relay_published_records|relay=r1"] == \
        c["relay_consumed_records|relay=r1"] \
        + c["relay_dropped_records|relay=r1,shard=0"]
    # a duplicate/stale cum never double-counts
    hub._on_hb(st, {"cum": {"0": 450}, "counters": {}})
    hub._finalize_epoch(st)
    assert rt.stats.snapshot() == c


def test_hub_folds_proc_counter_deltas():
    rt = _RtStub()
    hub = R.RelayHub(rt, lambda *a: (0, 0, 0))
    st = R._RelayState("r2")
    hub._on_hb(st, {"counters": {"accepted_records": 50,
                                 "spool_dropped_records": 5}})
    hub._on_hb(st, {"counters": {"accepted_records": 80,
                                 "spool_dropped_records": 5}})
    c = rt.stats.snapshot()
    assert c["relay_proc_accepted_records|relay=r2"] == 80
    assert c["relay_proc_spool_dropped_records|relay=r2"] == 5


# ------------------------------------------------------- end to end

def _ledger(stats, relay_id):
    c = stats.snapshot()
    pub = c.get(f"relay_published_records|relay={relay_id}", 0)
    con = c.get(f"relay_consumed_records|relay={relay_id}", 0)
    drop = sum(v for k, v in c.items()
               if k.startswith(f"relay_dropped_records|relay="
                               f"{relay_id},"))
    return pub, con, drop


def _run_worker(cfg, mod=R):
    w = mod.RelayWorker(cfg)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return w, t


async def _until(pred, timeout=10.0, dt=0.05):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        await asyncio.sleep(dt)
    return pred()


@pytest.mark.parametrize("mod", [R, j_relay], ids=["port", "reference"])
def test_relay_fleet_end_to_end(mod):
    """A relay of either package uplinks into the port's hub: exact
    ledgers through a relay restart (a finalized epoch), the agents'
    services folded."""
    async def scenario():
        rt = Runtime(CFG)
        srv = GytServer(rt, tick_interval=None, relay_port=0,
                        relay_host="127.0.0.1")
        host, port = await srv.start()
        hub = srv._relay
        cfg = {"supervisor": ("127.0.0.1", hub.port),
               "relay_id": "rx", "listen_host": "127.0.0.1"}
        w, t = _run_worker(cfg, mod)
        try:
            assert await _until(lambda: w._up_ready)
            rh, rp = w.listen_addr
            agents = [NetAgent(seed=i, n_svcs=2, n_groups=3)
                      for i in range(3)]
            hids = [await a.connect(rh, rp) for a in agents]
            assert sorted(hids) == [0, 1, 2]
            for _ in range(3):
                for a in agents:
                    await a.send_sweep(n_conn=64, n_resp=128)
                await asyncio.sleep(0.1)
            # every published record reaches the hub (no faults here)
            assert await _until(
                lambda: _ledger(rt.stats, "rx")[0] > 0
                and _ledger(rt.stats, "rx")[0]
                == sum(_ledger(rt.stats, "rx")[1:]))
            rt.flush()
            rt.run_tick()
            snap = rt.stats.snapshot()
            assert snap.get("relay_registrations|relay=rx", 0) == 3
            # the hub's rows, as /metrics renders them
            text = rt.query({"subsys": "metrics"})["text"]
            for row in ('gyt_relay_consumed_records_total{relay="rx"}',
                        'gyt_relay_registrations_total{relay="rx"} 3',
                        'gyt_relay_up{relay="rx"} 1'):
                assert row in text, row
            for a in agents:
                await a.close()
            # --- restart: same relay_id, NEW token = a new epoch ---
            w.running = False
            t.join(timeout=10.0)
            assert not t.is_alive()
            pub0, con0, drop0 = _ledger(rt.stats, "rx")
            assert pub0 == con0 + drop0
            w2, t2 = _run_worker(dict(cfg), mod)
            assert await _until(lambda: w2._up_ready)
            assert await _until(
                lambda: rt.stats.snapshot().get(
                    "relay_epochs|relay=rx", 0) == 1)
            a2 = NetAgent(seed=7, n_svcs=2, n_groups=3)
            await a2.connect(*w2.listen_addr)
            await a2.send_sweep(n_conn=64, n_resp=128)
            assert await _until(
                lambda: _ledger(rt.stats, "rx")[0] > pub0
                and _ledger(rt.stats, "rx")[0]
                == sum(_ledger(rt.stats, "rx")[1:]))
            rt.flush()
            rt.run_tick()
            await a2.close()
            w2.running = False
            t2.join(timeout=10.0)
        finally:
            w.running = False
            await srv.stop()
        return rt

    rt = asyncio.run(scenario())
    # the relay-fed records actually reached the fold: svcstate holds
    # the agents' listeners
    out = rt.query({"subsys": "svcstate"})
    assert out["nrecs"] > 0


def test_frames_and_knobs_match_reference():
    """The wire of the uplink is the reference's: frame and batch
    headers, frame types, and the knobs' defaults and env reads."""
    assert (R.RELAY_MAGIC, R._FH.format, R._BH.format, R.MAX_BODY) \
        == (j_relay.RELAY_MAGIC, j_relay._FH.format, j_relay._BH.format,
            j_relay.MAX_BODY)
    for t in ("T_HELLO", "T_HELLO_OK", "T_HB", "T_BATCH", "T_RPC",
              "T_RPC_RESP", "T_TICK"):
        assert getattr(R, t) == getattr(j_relay, t), t
    assert R.jframe(R.T_TICK, {"tick": 3}) \
        == j_relay.jframe(j_relay.T_TICK, {"tick": 3})
    env = {"GYT_RELAY_BATCH_KB": "64", "GYT_RELAY_SPOOL_MB": "2",
           "GYT_RELAY_HB_S": "0.5", "GYT_RELAY_HB_STALE_S": "9"}
    for fn in ("batch_payload_bytes", "batch_spool_max", "hb_interval_s",
               "hb_stale_s"):
        assert getattr(R, fn)(env) == getattr(j_relay, fn)(env), fn
    assert (R.batch_payload_bytes(), R.batch_spool_max(),
            R.hb_interval_s(), R.hb_stale_s()) \
        == (128 * 1024, 8 << 20, 0.2, 5.0)
