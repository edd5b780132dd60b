"""The port's daemon, config layering, watchdog and CLI.

- ``parse_args`` gives the reference's defaults (and ``--device cuda``);
  each flag of the sharded tier's worker processes builds a daemon
  (``--compact-procs``, ``--ingest-procs``, ``--relay-port``), ``relay``
  starts and uplinks, ``compact --procs 1`` writes a parted store and
  ``compact list`` lists its root.
- ``compact run`` equals ``Compactor.compact_once``; ``gateway``,
  ``ship``, ``shiprecv`` and ``compact`` parse as the reference's do,
  and ``ship --once`` ships a WAL dir to a receiver.
- An in-process ``Daemon`` pair, one with ``--ship-to`` and one with
  ``--ship-staging --ship-port 0 --shard-dir``, ships, lands and
  compacts, and stops its shipper, receiver and staging loop.
- ``Daemon(--device cpu --restore-latest)`` over a checkpoint and the
  WAL written after it restores and replays to the state of the runtime
  that wrote them, leaf for leaf; its checkpoint discovery equals the
  reference's on the same directory.
- ``load_engine_cfg``, ``load_runtime_opts`` and ``HotReload`` equal the
  reference's, given an explicit ``env`` mapping; without one the
  port's loaders read no environment.
- ``TickWatchdog`` reports a stall once per episode.
- ``python -m gyeeta_tpu_torch serve --device cpu`` runs as a process:
  ``cli query`` answers against it, its tick loop runs, and SIGTERM
  stops it with a final checkpoint.
"""

import asyncio
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gyeeta_tpu import cli as j_cli
from gyeeta_tpu import server_main as j_main
from gyeeta_tpu.utils import config as j_conf
from gyeeta_tpu.utils import crashguard as j_guard
from gyeeta_tpu_torch import cli as t_cli
from gyeeta_tpu_torch import server_main as t_main
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils import config as t_conf
from gyeeta_tpu_torch.utils import crashguard as t_guard
from test_torch_runtime import OPTS, t_cfg, tick_buffers

ROOT = Path(__file__).resolve().parents[1]

# t_cfg() as a config file's engine section
ENGINE = dict(svc_capacity=64, n_hosts=8, resp_vmin=1.0, resp_vmax=1e8,
              resp_nbuckets=64, hll_p_svc=6, hll_p_global=8, cms_depth=2,
              cms_width=1 << 10, topk_capacity=32, td_capacity=16,
              task_capacity=128, api_capacity=256, conn_batch=64,
              resp_batch=64, listener_batch=64)


def _config(tmp, **runtime):
    p = tmp / "gyt.json"
    p.write_text(json.dumps({"engine": ENGINE,
                             "runtime": {**OPTS, **runtime}}))
    return str(p)


def test_config_file_builds_the_test_geometry(tmp_path):
    assert t_conf.load_engine_cfg(_config(tmp_path)) == t_cfg()


def test_parse_args_defaults_match_reference():
    j, t = vars(j_main.parse_args([])), vars(t_main.parse_args([]))
    assert t.pop("device") == "cuda"
    assert t.pop("preagg") is False
    # the fold profiler's flags (the reference arms it from the
    # environment instead)
    assert (t.pop("profile_dir"), t.pop("profile_folds")) == (None, 20)
    assert t == j


# the sharded tier's worker-process flags, each on a two-shard daemon
_WORKER_FLAGS = {
    "compact_procs": ["--compact-procs", "1"],
    "ingest_procs": ["--ingest-procs", "2"],
    "relay_port": ["--relay-port", "0"],
}


@pytest.mark.parametrize("name", sorted(_WORKER_FLAGS))
def test_worker_process_flag_builds_daemon(name, tmp_path):
    from gyeeta_tpu_torch.history.compactproc import ParallelCompactor
    from gyeeta_tpu_torch.net.ingestproc import ProcWalView
    from gyeeta_tpu_torch.net.relay import RelayHub
    args = t_main.parse_args(
        ["--device", "cpu", "--config", _config(tmp_path), "--shards", "2",
         "--journal-dir", str(tmp_path / "wal"), "--shard-dir",
         str(tmp_path / "shards")] + _WORKER_FLAGS[name])
    d = t_main.Daemon(args, env={})
    try:
        if name == "compact_procs":
            assert isinstance(d.compactor, ParallelCompactor)
            assert d.compactor.procs == 1 and d.compactor.device == "cpu"
        elif name == "ingest_procs":
            assert d.srv._ingest.nprocs == 2
            assert isinstance(d.rt.journal, ProcWalView)
        else:
            assert isinstance(d.srv._relay, RelayHub)
    finally:
        if d.srv._ingest is not None:
            d.srv._ingest.close()
        d.rt.close()


@pytest.mark.parametrize("cmd", ["relay"])
def test_subcommand_starts(cmd):
    """``python -m gyeeta_tpu_torch relay`` prints its listen address
    and uplinks to a hub (HELLO answered), then stops on SIGTERM."""
    import types

    from gyeeta_tpu_torch.net.relay import RelayHub
    from gyeeta_tpu_torch.utils.selfstats import Stats

    rt = types.SimpleNamespace(stats=Stats(), n=1,
                               notifylog=types.SimpleNamespace(
                                   add=lambda *a, **k: None))

    async def go():
        hub = RelayHub(rt, lambda *a: (0, 0, 0), host="127.0.0.1")
        host, port = await hub.start()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "gyeeta_tpu_torch", cmd, "--supervisor",
            f"{host}:{port}", "--relay-id", "cli", cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        try:
            line = (await asyncio.wait_for(proc.stdout.readline(), 60))
            assert line.decode().startswith("RELAY_LISTEN 127.0.0.1 ")
            for _ in range(600):
                if hub.relays_up():
                    break
                await asyncio.sleep(0.05)
            assert hub.relays_up() == 1
            proc.send_signal(signal.SIGTERM)
            assert await asyncio.wait_for(proc.wait(), 30) == 0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await hub.stop()

    asyncio.run(go())


@pytest.fixture(scope="module")
def cli_parted(tmp_path_factory):
    """``compact run --procs 1`` over a per-shard WAL → (its report, the
    parted store's dir)."""
    from test_torch_compactproc import GEOM, OPTS, make_sharded_wal
    tmp = tmp_path_factory.mktemp("cli_parted")
    make_sharded_wal(str(tmp / "wal"))
    cfgf = tmp / "cfg.json"
    cfgf.write_text(json.dumps({"engine": GEOM, "runtime": OPTS}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_cli.main(["compact", "--journal-dir", str(tmp / "wal"),
                    "--shard-dir", str(tmp / "sh"), "--config", str(cfgf),
                    "--device", "cpu", "--upto-tick", "4", "--procs", "1"])
    return json.loads(buf.getvalue()), tmp / "sh"


def test_compact_procs_runs(cli_parted):
    rep, _ = cli_parted
    assert rep["workers"] == 1 and rep["windows"] == 4
    assert rep["records"] > 0 and sorted(rep["per_shard"]) == ["0", "1"]


def test_compact_list_on_parted_store(cli_parted):
    _, sh = cli_parted
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_cli.main(["compact", "list", "--shard-dir", str(sh)])
    listing = json.loads(buf.getvalue())
    assert [(e["tick0"], e["tick1"]) for e in listing["shards"]] \
        == [(0, 2), (2, 4)]
    assert all(len(e["parts"]) == 2 for e in listing["shards"])
    assert listing["tick"] == 4 and len(listing["pos"]) == 2


def _no_gyt_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("GYT_"):
            monkeypatch.delenv(k)


def test_compact_run_equals_compactor(tmp_path, monkeypatch, capsys):
    """``compact run`` over a WAL dir reports and writes what
    ``Compactor.compact_once`` does over the same dir."""
    from gyeeta_tpu_torch.history.compactor import Compactor
    _no_gyt_env(monkeypatch)
    wal = tmp_path / "wal"
    opts = dict(OPTS, journal_dir=str(wal), hist_window_ticks=1)
    now = [1.7e9]
    rt = TRuntime(t_cfg(), t_conf.RuntimeOpts(**opts),
                  clock=lambda: now[0], device="cpu")
    try:
        for buf in tick_buffers(TSim, t_wire)[:3]:
            rt.feed(buf)
            now[0] += 5.0
            rt.run_tick()
        rt.flush()
    finally:
        rt.close()
    t_cli.main(["compact", "run", "--journal-dir", str(wal),
                "--shard-dir", str(tmp_path / "cli"), "--config",
                _config(tmp_path, **opts), "--device", "cpu",
                "--upto-tick", "3"])
    got = json.loads(capsys.readouterr().out)
    c = Compactor(t_cfg(), t_conf.RuntimeOpts(**opts),
                  journal_dir=str(wal), shard_dir=str(tmp_path / "lib"),
                  device="cpu")
    try:
        want = c.compact_once(upto_tick=3)
        ents = c.store.shards("raw")
        lib = [c.store.load(e)["state"] for e in ents]
    finally:
        c.close()
    for k in ("ev_per_sec", "secs"):
        got.pop(k), want.pop(k)
    assert got == want and want["windows"] == 3
    t_cli.main(["compact", "list", "--shard-dir", str(tmp_path / "cli")])
    listed = json.loads(capsys.readouterr().out)
    assert [e["tick1"] for e in listed["shards"]] == \
        [e["tick1"] for e in ents]
    assert "shipped_segments" not in listed
    from gyeeta_tpu_torch.history.shards import ShardStore
    store = ShardStore(tmp_path / "cli")
    for ent, leaves in zip(store.shards("raw"), lib):
        for a, b in zip(store.load(ent)["state"], leaves):
            assert a.tobytes() == b.tobytes()


def _help_flags(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    assert e.value.code == 0
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", out.getvalue()))


@pytest.mark.parametrize("cmd", ["gateway", "ship", "shiprecv",
                                 "compact"])
def test_subcommand_parses_as_reference(cmd, capsys):
    """The same flags as the reference's subcommand (``compact`` adds
    ``--device``), and the same exit on a missing required flag."""
    t, j = _help_flags(t_cli.main, [cmd]), _help_flags(j_cli.main, [cmd])
    assert t - ({"--device"} if cmd == "compact" else set()) == j
    with pytest.raises(SystemExit) as te:
        t_cli.main([cmd] if cmd != "compact" else [cmd, "list"])
    with pytest.raises(SystemExit) as je:
        j_cli.main([cmd] if cmd != "compact" else [cmd, "list"])
    assert te.value.code == je.value.code == 2
    capsys.readouterr()


def test_gateway_without_upstreams_exits_like_reference(capsys):
    with pytest.raises(SystemExit) as te:
        t_cli.main(["gateway", "--peer", "127.0.0.1:9"])
    t_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as je:
        j_cli.main(["gateway", "--peer", "127.0.0.1:9"])
    j_err = capsys.readouterr().err
    assert te.value.code == je.value.code == 2
    # the usage wraps at the program's name; the error line is the same
    assert t_err.splitlines()[-1].replace("gyeeta_tpu_torch",
                                          "gyeeta_tpu") \
        == j_err.splitlines()[-1]
    assert "need --upstream" in t_err


def test_ship_once_ships_a_wal_dir(tmp_path, capsys):
    """``ship --once`` ships every segment of a WAL dir to a receiver
    and reports it, as the reference's does."""
    from gyeeta_tpu_torch.net.segship import SegmentReceiver
    from gyeeta_tpu_torch.utils import journal as J
    from gyeeta_tpu_torch.utils.selfstats import Stats
    j = J.Journal(tmp_path / "wal", segment_max_bytes=1 << 12)
    for i in range(40):
        j.append(b"z" * 256, hid=1, conn_id=i, tick=i // 8)
    j.close()
    nsegs = len(J.dir_segments(tmp_path / "wal"))

    async def go():
        rcv = SegmentReceiver(tmp_path / "stage", stats=Stats(),
                              host="127.0.0.1")
        h, p = await asyncio.wait_for(rcv.start(), 30)
        try:
            await asyncio.wait_for(asyncio.to_thread(
                t_cli.main, ["ship", "--once", "--dir",
                             str(tmp_path / "wal"), "--to", f"{h}:{p}",
                             "--id", "src", "--scan-s", "0.05"]), 60)
        finally:
            await asyncio.wait_for(rcv.stop(), 30)
        return rcv

    rcv = asyncio.run(go())
    out = capsys.readouterr().out
    assert "SHIP_RUN id=src layout=flat shards=1" in out
    assert f"SHIP_DONE shipped={nsegs} dropped=0" in out
    assert len(rcv.ledger) == nsegs


def test_daemon_pair_ships_lands_and_compacts(tmp_path, monkeypatch):
    """A region daemon (``--ship-staging --ship-port 0 --shard-dir``)
    and a source daemon (``--journal-dir --ship-to``), in one process:
    the source's sealed segments land in the region's staging dir, the
    staging loop compacts them on the region's device, and both stop
    their shipper, receiver and loop."""
    from gyeeta_tpu_torch.utils import crashguard, journal as J
    monkeypatch.setattr(crashguard, "enable_crash_dumps", lambda p: None)
    cfgf = _config(tmp_path)
    common = ["--device", "cpu", "--config", cfgf, "--host", "127.0.0.1",
              "--port", "0", "--tick-interval", "0"]
    stage = tmp_path / "stage"

    async def until(pred, what):
        async def spin():
            while not pred():
                await asyncio.sleep(0.02)
        try:
            await asyncio.wait_for(spin(), 60)
        except asyncio.TimeoutError:
            raise AssertionError(f"timed out waiting for {what}") from None

    async def go():
        region = t_main.Daemon(t_main.parse_args(common + [
            "--ship-staging", str(stage), "--ship-port", "0",
            "--ship-listen-host", "127.0.0.1", "--shard-dir",
            str(tmp_path / "shards"), "--compact-interval", "0.2"]),
            env={})
        rtask = asyncio.create_task(region.run())
        stask = source = None
        try:
            await until(lambda: region.ship_recv is not None
                        and region.ship_recv._server is not None,
                        "the receiver")
            port = region.ship_recv.port
            source = t_main.Daemon(t_main.parse_args(common + [
                "--journal-dir", str(tmp_path / "wal"),
                "--ship-to", f"127.0.0.1:{port}", "--ship-id", "src"]),
                env={"GYT_SHIP_SCAN_S": "0.05"})
            stask = asyncio.create_task(source.run())
            await until(lambda: source.shipper is not None, "the shipper")
            assert source.shipper.scan_s == 0.05
            for buf in tick_buffers(TSim, t_wire)[:2]:
                source.rt.feed(buf)
                source.rt.run_tick()
            source.rt.flush()
            source.rt.journal.seal_active()
            sealed = source.rt.journal.sealed_upto()
            await until(lambda: len(J.dir_segments(stage)) >= sealed,
                        "the landed segments")
            await until(lambda: region.rt.stats.counters.get(
                "compact_passes", 0) >= 1, "a staging compaction pass")
            assert region._ship_loop.compactor.device.type == "cpu"
            assert region.rt.stats.counters["ship_shipped_segments"] \
                == sealed
        finally:
            for d, task in ((source, stask), (region, rtask)):
                if d is not None and task is not None:
                    d.stop_event.set()
                    await asyncio.wait_for(task, 60)
        assert not source._ship_thread.is_alive()
        assert region.ship_recv._server is None
        assert region._ship_loop._thread is None
        assert not region.rt.stats.counters.get("compact_errors")

    asyncio.run(go())


def _leaves(rt):
    return [np.asarray(a) for a in t_agg.state_to_numpy(rt.state)]


def test_daemon_restore_and_wal_replay(tmp_path):
    """Ticks 0-1 fold and checkpoint, tick 2 folds into the WAL only;
    the daemon restores the newest checkpoint and replays the WAL after
    it → the writer's state, leaf for leaf."""
    ck, wal = tmp_path / "ck", tmp_path / "wal"
    opts = dict(OPTS, checkpoint_dir=str(ck), journal_dir=str(wal),
                checkpoint_every_ticks=2)
    bufs = tick_buffers(TSim, t_wire)[:3]
    now = [1.7e9]
    rt = TRuntime(t_cfg(), t_conf.RuntimeOpts(**opts),
                  clock=lambda: now[0], device="cpu")
    try:
        for i, buf in enumerate(bufs):
            rt.feed(buf)
            if i < 2:
                now[0] += 5.0
                rt.run_tick()
        rt.flush()
        want = _leaves(rt)
    finally:
        rt.close()
    assert t_main.checkpoint_candidates(str(ck)) == \
        j_main.checkpoint_candidates(str(ck))
    assert t_main.latest_checkpoint(str(ck)) == \
        j_main.latest_checkpoint(str(ck)) is not None
    args = t_main.parse_args(["--device", "cpu", "--restore-latest",
                              "--config", _config(tmp_path, **opts),
                              "--tick-interval", "0"])
    d = t_main.Daemon(args, env={})
    try:
        d.rt.flush()
        got = _leaves(d.rt)
        assert d.rt.device.type == "cpu"
        # tick 2's bytes came back from the WAL, not the checkpoint
        assert d.rt.stats.counters["wal_replayed_chunks"] >= 1
        assert d.rt.stats.counters["wal_replayed_records"] > 0
    finally:
        d.rt.close()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i


_ENV = {"GYT_SVC_CAPACITY": "128", "GYT_RESP_VMAX": "1e6",
        "GYT_HH_HOT_FRAC": "0.25", "GYT_FOLD_K": "2",
        "GYT_CHECKPOINT_EVERY_TICKS": "9", "GYT_HISTORY_DB": "h.db",
        "GYT_TRACE_RESP_BRIDGE": "1", "GYT_COMPACT_TOMB_FRAC": "0.5"}


@pytest.mark.parametrize("with_file", [False, True])
def test_config_loaders_match_reference(with_file, tmp_path):
    f = _config(tmp_path) if with_file else None
    je = j_conf.load_engine_cfg(f, env=_ENV, n_hosts=16)
    te = t_conf.load_engine_cfg(f, env=_ENV, n_hosts=16)
    assert te._asdict().keys() == je._asdict().keys()
    for k in je._fields:
        assert tuple(getattr(te, k)) == tuple(getattr(je, k)) \
            if isinstance(getattr(je, k), tuple) \
            else getattr(te, k) == getattr(je, k), k
    jo = j_conf.load_runtime_opts(f, env=_ENV, task_max_age_ticks=7)
    to = t_conf.load_runtime_opts(f, env=_ENV, task_max_age_ticks=7)
    assert to._asdict() == {k: v for k, v in jo._asdict().items()
                            if k in to._fields}
    with pytest.raises(ValueError):
        t_conf.load_engine_cfg(None, env={}, no_such_field=1)


def test_port_loaders_read_no_environment(monkeypatch):
    monkeypatch.setenv("GYT_SVC_CAPACITY", "128")
    monkeypatch.setenv("GYT_CHECKPOINT_EVERY_TICKS", "9")
    assert t_conf.load_engine_cfg() == t_agg.EngineCfg()
    assert t_conf.load_runtime_opts() == t_conf.RuntimeOpts()


def test_hot_reload_matches_reference(tmp_path):
    p = tmp_path / "hot.json"
    jh = j_conf.HotReload(p, j_conf.RuntimeOpts())
    th = t_conf.HotReload(p, t_conf.RuntimeOpts())
    assert th.poll() is th.opts                    # no file yet
    for i, body in enumerate([{"runtime": {"debug_level": 2}},
                              {"resp_sample_pct": 50, "checkpoint_dir": "x"},
                              "not json"]):
        p.write_text(body if isinstance(body, str) else json.dumps(body))
        os.utime(p, (1000 + i, 1000 + i))
        j, t = jh.poll(), th.poll()
        assert (t.debug_level, t.resp_sample_pct, t.checkpoint_dir) == \
            (j.debug_level, j.resp_sample_pct, j.checkpoint_dir)
    assert th.poll() is th.opts                    # unchanged mtime


@pytest.mark.parametrize("guard", [t_guard, j_guard],
                         ids=["port", "reference"])
def test_tick_watchdog_reports_each_stall_once(guard):
    clock = [0.0]
    stalls = []
    wd = guard.TickWatchdog(stall_after_s=0.2, clock=lambda: clock[0],
                            on_stall=stalls.append)
    wd.beat()
    clock[0] = 1.0
    wd.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not stalls:
            time.sleep(0.01)
        time.sleep(0.2)                  # more checks: still one report
        assert len(stalls) == 1 and stalls[0] >= 0.2
        wd.beat()                        # a beat ends the episode
        clock[0] = 2.0
        while time.time() < deadline and len(stalls) < 2:
            time.sleep(0.01)
    finally:
        wd.stop()
    assert wd.n_stalls == 2


def test_serve_process_answers_cli_query_and_stops(tmp_path, capsys):
    """The daemon as its users start it, on the CPU: a query through
    ``cli query``, ticks from its own loop, SIGTERM → final
    checkpoint, exit 0."""
    ck = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GYT_")}
    p = subprocess.Popen(
        [sys.executable, "-m", "gyeeta_tpu_torch", "serve", "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--config",
         _config(tmp_path), "--checkpoint-dir", str(ck),
         "--tick-interval", "0.2", "--stats-interval", "0.5"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.time() + 120
        lines = []
        while port is None and time.time() < deadline:
            ln = p.stderr.readline()
            if not ln:
                break
            lines.append(ln)
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)", ln)
            if m:
                port = int(m.group(1))
        assert port is not None, "".join(lines)
        time.sleep(0.5)                  # a few ticks of its own loop
        t_cli.main(["query", '{"subsys": "serverstatus"}', "--port",
                    str(port), "--timeout", "30"])
        out = json.loads(capsys.readouterr().out)
        assert out["nrecs"] == 1
        p.send_signal(signal.SIGTERM)
        _, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err
    assert "final checkpoint" in err and "bye" in err
    assert list(ck.glob("gyt_final_*.npz"))
