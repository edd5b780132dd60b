"""The port's multi-process ingest edge (``gyeeta_tpu_torch/net/
ingestproc.py`` + ``utils/shmring.py``), on the CPU: the reference's
tests of ``tests/test_ingestproc.py`` on the port's classes, the agents
being the reference's ``NetAgent`` (JAX-free), the runtime a two-shard
``ShardedRuntime(device="cpu")``.

- fold parity: the worker-process path (handoff → deframe/decode in a
  worker → shared-memory ring → pre-routed staging) renders the same
  totals and svcstate/hoststate JSON as the port's in-process edge fed
  the same stream (the in-process edge is held to the reference's mesh
  by ``tests/test_torch_shardedrt.py``), with the ring ledger exact;
- graceful SIGTERM with ``--ingest-procs 2``: workers drain + fsync,
  the final checkpoint supersedes the whole WAL window, and a respawn
  replays ZERO chunks;
- worker-crash chaos: SIGKILL one worker mid-feed — the supervisor
  respawns it onto the SAME shard group, the ring ledger stays exact
  (published == consumed + counted drops; accepted-but-unpublished
  chunks survive in the worker-owned WAL), and the reconnecting agent
  lands on the same sticky hid/shard;
- the per-shard WAL subdirs written BY WORKERS are byte-compatible
  with the in-process ShardedJournal layout (replay reads them);
- the worker's import chain imports no ``torch``, so N workers claim no
  device context.

The SIGKILL/respawn case is ``slow``, as the reference marks it.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import time

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.parallel.mesh import make_mesh as _make_mesh
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
from gyeeta_tpu_torch.utils.config import RuntimeOpts

ROOT = Path(__file__).resolve().parents[1]


def make_mesh(n):
    return _make_mesh(n, device="cpu")


CFG = EngineCfg(n_hosts=16, svc_capacity=256, task_capacity=256,
                conn_batch=64, resp_batch=64, listener_batch=32,
                fold_k=2)
OPTS = RuntimeOpts(dep_pair_capacity=2048, dep_edge_capacity=1024)


def _rows_json(out, drop=("evictedbytes",)):
    recs = [{k: v for k, v in r.items() if k not in drop}
            for r in out["recs"]]
    key = lambda r: json.dumps(r, sort_keys=True, default=str)  # noqa
    return json.dumps(sorted(recs, key=key), sort_keys=True,
                      default=str)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run the fold (PyTorch's CPU ops on the loop thread)
    beside ingest worker processes that need the CPU at the same time; PyTorch's pool of a
    thread a core spins between ops and, beside other test processes,
    starved them (about 50x slower in a four-process run). One thread
    keeps them near their time alone; the module restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _settle(srv, rt, want: int, timeout: float = 60.0) -> None:
    """Barrier until the fold has seen ``want`` conn+resp events (the
    worker → ring → staging path is asynchronous by design)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        srv._feed_barrier()
        rt.flush()
        c = rt.stats.counters
        if c.get("conn_events", 0) + c.get("resp_events", 0) >= want:
            return
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"fold never saw {want} events "
        f"(conn={rt.stats.counters.get('conn_events', 0)}, "
        f"resp={rt.stats.counters.get('resp_events', 0)})")


async def _named(srv, rt, hid: int, timeout: float = 60.0) -> None:
    """Barrier until agent ``hid``'s own host name is folded: every
    agent's one-host sim announces a placeholder for host 0 before the
    agent's name, so two agents' announcements must fold in one order
    for the last name of host 0 not to depend on which worker ran
    first."""
    from gyeeta_tpu_torch.ingest import wire
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        srv._feed_barrier()
        if rt.names.lookup(wire.NAME_KIND_HOST, hid) == f"agent-{hid}.sim":
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"host {hid}'s name never folded")


def _mk_server(rt, ingest_procs: int):
    from gyeeta_tpu_torch.net.server import GytServer
    return GytServer(rt, tick_interval=None, ingest_procs=ingest_procs)


def _ledger(srv, rt) -> tuple:
    """(published, consumed, dropped) of the worker rings."""
    sup = srv._ingest
    published = sum(h.shm.counter("published_records")
                    for h in sup.workers)
    c = rt.stats.counters
    return (published, c.get("ingest_ring_consumed_records", 0),
            sum(v for k, v in c.items()
                if k.startswith("ingest_ring_dropped_records")))


# --------------------------------------------------------------- parity
def test_mproc_fold_parity_vs_inprocess(tmp_path):
    """The same two-agent stream through ``ingest_procs=2`` (worker
    deframe/decode + rings) and through the in-process edge renders
    equal svcstate/hoststate rows and identical event totals; the ring
    ledger closes exactly (published == consumed + dropped, nothing
    dropped)."""
    from gyeeta_tpu.net.agent import NetAgent

    async def run(ingest_procs: int) -> tuple:
        rt = ShardedRuntime(CFG, make_mesh(2), OPTS)
        srv = _mk_server(rt, ingest_procs)
        host, port = await srv.start()
        agents = [NetAgent(machine_id=0x6100 + i, seed=7 + i, n_svcs=3)
                  for i in range(2)]
        for a in agents:
            await _named(srv, rt, await a.connect(host, port))
        # each sweep is folded before the next is sent: two agents on two
        # workers would otherwise race
        sent = 0
        for _ in range(3):
            for a in agents:
                await a.send_sweep(n_conn=64, n_resp=64)
                sent += 128
                await _settle(srv, rt, sent)
        rt.run_tick()
        svc = _rows_json(rt.query({"subsys": "svcstate",
                                   "maxrecs": 1000}))
        hostrows = _rows_json(rt.query({"subsys": "hoststate",
                                        "maxrecs": 64}))
        totals = (rt.stats.counters.get("conn_events", 0),
                  rt.stats.counters.get("resp_events", 0))
        if ingest_procs > 1:
            pub, con, drop = _ledger(srv, rt)
            assert pub == con > 0 and drop == 0
            assert rt.stats.counters["ingest_conns_handed_off"] == 2
            # the monitor's rows, as /metrics renders them
            srv._ingest.poll()
            text = rt.query({"subsys": "metrics"})["text"]
            for row in ('gyt_ingest_proc_accepted_records_total{proc="0"}',
                        'gyt_ingest_proc_up{proc="1"} 1',
                        "gyt_ingest_ring_consumed_records_total"):
                assert row in text, row
        for a in agents:
            await a.close()
        await srv.stop()
        return svc, hostrows, totals

    svc_m, host_m, tot_m = asyncio.run(run(2))
    svc_i, host_i, tot_i = asyncio.run(run(1))
    assert tot_m == tot_i
    assert svc_m == svc_i
    assert host_m == host_i


# ----------------------------------------------- graceful SIGTERM drain
def test_graceful_sigterm_drains_rings_zero_replay(tmp_path,
                                                   monkeypatch):
    """The PR-5 graceful-shutdown invariant extended across the
    process boundary: SIGTERM with ``--ingest-procs 2`` drains the
    worker rings + WALs BEFORE the final checkpoint, so a respawn
    replays ZERO chunks and reproduces the fold state."""
    from gyeeta_tpu.net.agent import NetAgent
    from gyeeta_tpu_torch import server_main as SM

    env = {f"GYT_{k}": str(v) for k, v in (
        ("SVC_CAPACITY", 256), ("N_HOSTS", 16), ("TASK_CAPACITY", 256),
        ("CONN_BATCH", 64), ("RESP_BATCH", 64), ("LISTENER_BATCH", 32),
        ("FOLD_K", 2))}
    ckdir = tmp_path / "ck"
    wal = tmp_path / "wal"
    args = SM.parse_args([
        "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--shards", "2", "--ingest-procs", "2",
        "--checkpoint-dir", str(ckdir), "--journal-dir", str(wal),
        "--restore-latest", "--tick-interval", "0",
        "--stats-interval", "3600", "--log-level", "WARNING"])
    args.tick_interval = None                      # manual ticks

    async def scenario():
        d = SM.Daemon(args, env=env)
        host, port = await d.srv.start()
        agents = [NetAgent(machine_id=0x6200 + i, seed=11 + i,
                           n_svcs=2, n_groups=3) for i in range(2)]
        for a in agents:
            await a.connect(host, port)
            for _ in range(2):
                await a.send_sweep(n_conn=32, n_resp=32)
        # the stream is in flight through workers/rings — do NOT
        # barrier here: the SIGTERM path itself must drain it
        await asyncio.sleep(0.3)
        for a in agents:
            await a.close()
        d.handle_signal(15)
        assert d.stop_event.is_set()
        await d.shutdown()
        return d.rt

    rt1 = asyncio.run(scenario())
    c = rt1.stats.counters
    assert c.get("conn_events", 0) == 2 * 2 * 32     # all drained
    assert c.get("resp_events", 0) == 2 * 2 * 32
    finals = list(ckdir.glob("gyt_final_*.npz"))
    assert len(finals) == 1
    # worker-owned WAL wrote the standard shard_NN layout
    from gyeeta_tpu_torch.utils import journal as J
    assert len(J.sharded_subdirs(str(wal))) == 2

    # respawn: restore + replay an EMPTY window (clean shutdown)
    rt2 = ShardedRuntime(CFG, make_mesh(2),
                         OPTS._replace(journal_dir=str(wal),
                                       checkpoint_dir=str(ckdir)))
    assert SM.restore_latest_checkpoint(rt2, str(ckdir)) \
        == str(finals[0])
    assert rt2.stats.counters.get("wal_replayed_chunks", 0) == 0
    assert sum(float(s.n_conn.sum()) for s in rt2.state) \
        == sum(float(s.n_conn.sum()) for s in rt1.state) > 0
    rt2.close()


# ------------------------------------------------- worker-crash chaos
@pytest.mark.slow
def test_worker_sigkill_respawn_ledger_exact(tmp_path):
    """SIGKILL one ingest worker mid-feed: the supervisor respawns it
    onto the SAME shard group, the reconnecting agent keeps its
    sticky hid (→ same shard), the ring ledger closes exactly
    (published == consumed + counted drops) and nothing vanishes
    silently — accepted-but-unpublished chunks are in the worker's
    WAL."""
    from gyeeta_tpu.net.agent import NetAgent

    async def scenario():
        rt = ShardedRuntime(
            CFG, make_mesh(2),
            OPTS._replace(journal_dir=str(tmp_path / "wal")))
        srv = _mk_server(rt, 2)
        host, port = await srv.start()
        sup = srv._ingest

        a0 = NetAgent(machine_id=0x6300, seed=21, n_svcs=2)
        a1 = NetAgent(machine_id=0x6301, seed=22, n_svcs=2)
        h0 = await a0.connect(host, port)
        h1 = await a1.connect(host, port)
        assert (h0 % 2, h1 % 2) == (0, 1)      # different shard groups
        for a in (a0, a1):
            await a.send_sweep(n_conn=32, n_resp=32)
        await _settle(srv, rt, 2 * 64)

        # ---- SIGKILL the worker owning hid 1's shard group
        w1 = sup.workers[sup.worker_of_hid(h1)]
        pid1 = w1.proc.pid
        epoch_before = w1.shm.epoch()
        os.kill(pid1, signal.SIGKILL)
        w1.proc.wait(timeout=10)
        # agent 0's worker is untouched: keep feeding through the kill
        await a0.send_sweep(n_conn=32, n_resp=32)
        # supervisor detects + respawns (the monitor task does this at
        # 1s cadence; drive it directly for determinism)
        for _ in range(100):
            if sup.poll():
                break
            await asyncio.sleep(0.05)
        assert w1.proc.pid != pid1              # respawned
        assert w1.shards == [1]                 # sticky shard group
        # agent 1's conn died with the worker (supervisor released it)
        with pytest.raises((ConnectionError, OSError,
                            asyncio.IncompleteReadError,
                            asyncio.TimeoutError)):
            for _ in range(50):
                await a1.send_sweep(n_conn=8, n_resp=8)
                await asyncio.sleep(0.1)
        await a1.close()

        # reconnect: same machine id → same sticky hid → same shard,
        # handled by the RESPAWNED worker
        a1b = NetAgent(machine_id=0x6301, seed=23, n_svcs=2)
        h1b = await a1b.connect(host, port)
        assert h1b == h1                        # same shard by hash
        for _ in range(90):
            if w1.shm.epoch() > epoch_before:
                break
            await asyncio.sleep(0.1)
        assert w1.shm.epoch() > epoch_before    # new epoch attached
        await a1b.send_sweep(n_conn=32, n_resp=32)
        # folded total: a0 2 sweeps + a1 1 sweep + a1b 1 sweep; the
        # mid-outage a1 sends died with the closed conn (never
        # accepted anywhere — the agent spool tier is what re-sends
        # in production, exercised by the PR-4 supervision tests)
        await _settle(srv, rt, 4 * 64)

        # ---- the cross-process ledger closes EXACTLY
        sup.poll()
        published = sum(h.shm.counter("published_records")
                        for h in sup.workers)
        accepted = sum(h.shm.counter("accepted_records")
                       for h in sup.workers)
        srv._feed_barrier()
        c = rt.stats.counters
        consumed = c.get("ingest_ring_consumed_records", 0)
        dropped = sum(v for k, v in c.items()
                      if k.startswith("ingest_ring_dropped_records"))
        assert published == consumed + dropped
        assert accepted >= published            # crash window only
        assert c.get(f"ingest_proc_respawns|proc={w1.w}", 0) == 1

        rt.run_tick()
        out = rt.query({"subsys": "hoststate", "maxrecs": 64})
        hosts = {int(r["hostid"]) for r in out["recs"]}
        assert {h0, h1} <= hosts                # both survived the kill
        await a0.close()
        await a1b.close()
        await srv.stop()

    asyncio.run(scenario())


# -------------------------------------------------------- guard rails
def test_handoff_blob_frame_error_contained():
    """Poison bytes buffered BEFORE the handoff (the initial blob in
    the 'conn' ctrl packet) must close only that conn — the FrameError
    used to escape _ctrl_recv and crash the whole worker, turning one
    garbage-sending agent into a respawn crash loop for its entire
    shard group."""
    import socket as socklib
    import uuid

    from gyeeta_tpu_torch.net import ingestproc
    from gyeeta_tpu_torch.utils import shmring

    name = f"gyt_t_test_ing_{uuid.uuid4().hex[:8]}"
    seg = shmring.WorkerShm(name, nshards=1, slots=8, slot_bytes=4096,
                            create=True)
    sup, child = socklib.socketpair(socklib.AF_UNIX,
                                    socklib.SOCK_SEQPACKET)
    w = conn_a = conn_b = None
    try:
        cfg = {"worker": 0, "nshards": 1, "shards": [0], "shm": name,
               "journal_dir": None, "idle_timeout": 0}
        w = ingestproc.IngestWorker(cfg, child.detach())
        conn_a, conn_b = socklib.socketpair()
        socklib.send_fds(
            sup, [ingestproc._pack_msg({"cmd": "conn", "hid": 1,
                                        "conn_id": 7},
                                       b"\x00" * 64)],   # bad magic
            [conn_a.fileno()])
        assert w._ctrl_recv() is True          # loop survives
        assert w.running
        assert not w.conns                     # only the conn died
        assert w.shm.counter("frames_bad") == 1
        msg, _blob = ingestproc._unpack_msg(sup.recv(1 << 16))
        assert msg == {"ev": "conn_closed", "hid": 1, "conn_id": 7,
                       "reason": "frame_error"}
    finally:
        for s in (conn_a, conn_b, sup):
            if s is not None:
                s.close()
        if w is not None:
            w.sel.close()
            w.ctrl.close()
            w.shm.close()
        seg.close()
        seg.unlink()


def test_ingest_procs_needs_enough_shards():
    rt = ShardedRuntime(CFG, make_mesh(2), OPTS)
    with pytest.raises(ValueError):
        _mk_server(rt, 4)
    rt.close()


def test_worker_import_chain_touches_no_device():
    """The worker process's import chain (``python -m
    gyeeta_tpu_torch.net.ingestproc``: the module, and what its worker
    loads at run time) imports no ``torch``: N workers claim no CUDA
    context."""
    code = (
        "import sys\n"
        "import gyeeta_tpu_torch.net.ingestproc as ip\n"
        "from gyeeta_tpu_torch.ingest import native, wire\n"
        "from gyeeta_tpu_torch.utils import journal, shmring\n"
        "import gyeeta_tpu_torch.net.relay\n"
        "assert callable(ip.worker_main) and native.lib() is not None\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
