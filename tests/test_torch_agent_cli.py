"""The port's agent-side commands: ``agent``, ``replay``, ``obs``, ``nm``
and ``chaos``.

Each parses the reference's flags (the same destinations, option
strings, defaults, choices and arities as ``gyeeta_tpu/cli.py``'s), and
runs in this process against the port's ``GytServer(device="cpu")``
(its loop on a thread):

- ``agent --n-agents 2``: the supervisors stream until SIGINT, then the
  command prints each agent's delivery ledger (records built = sent +
  still buffered + dropped) and the server holds their sweeps;
- ``replay`` of the first server's ``--record`` capture into a second
  server prints ``replayed N bytes`` with N the capture's bytes, and
  the second server's state views equal the first's;
- ``obs top --once`` renders a frame, ``obs metrics`` the exposition;
- ``nm probe --crud`` passes;
- ``chaos`` forwards a query through its proxy and prints its fault
  counts when SIGINT stops it;
- ``agent --collect --real --livecap`` parses and starts, and its exit
  report carries the capture's state.
"""

import argparse
import asyncio
import json
import os
import re
import signal
import socket
import threading
import time

import pytest

from gyeeta_tpu import cli as j_cli
from gyeeta_tpu_torch import cli as t_cli
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.utils.config import RuntimeOpts

CFG = EngineCfg(n_hosts=16, svc_capacity=128, task_capacity=256,
                api_capacity=64, conn_batch=256, resp_batch=512,
                listener_batch=64, fold_k=2, cms_width=1 << 10,
                hh_width=256, topk_capacity=16, hll_p_svc=4,
                hll_p_global=8)
OPTS = RuntimeOpts(dep_pair_capacity=256, dep_edge_capacity=256)
COMMANDS = {"agent": [], "replay": ["cap"], "obs": ["top"],
            "nm": ["probe"], "chaos": []}
TIMEOUT = 30.0


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _flags(cli, cmd, monkeypatch):
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        cli.main([cmd] + COMMANDS[cmd])
    monkeypatch.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                     a.choices, a.required, type(a).__name__)
            for a in e.value.parser._actions}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_flags_match_reference(cmd, monkeypatch):
    assert _flags(t_cli, cmd, monkeypatch) == _flags(j_cli, cmd,
                                                     monkeypatch)


def test_livecap_parses():
    args = {}

    def grab(self, argv=None, namespace=None):
        args.update(vars(argparse.ArgumentParser.parse_known_args(
            self, argv, namespace)[0]))
        raise _Parsed(self)
    import unittest.mock as um
    with um.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            t_cli.main(["agent", "--collect", "--real", "--livecap",
                        "--cap-ifname", "eth7", "--port", "1"])
    assert args["livecap"] and args["real"] and args["collect"]
    assert args["cap_ifname"] == "eth7"


class _ServerThread:
    """A port GytServer(device="cpu") with its loop on a thread."""

    def __init__(self, record=None):
        from gyeeta_tpu_torch.net.server import GytServer
        from gyeeta_tpu_torch.runtime import Runtime
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.rt = Runtime(CFG, OPTS, device="cpu")
        self.srv = GytServer(self.rt, tick_interval=None,
                             record_path=record)
        self.host, self.port = self.call(self.srv.start())

    def call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            TIMEOUT)

    def on_loop(self, fn):
        async def run():
            return fn()
        return self.call(run())

    def ctr(self, name):
        return self.rt.stats.counters.get(name, 0)

    def views(self):
        def read():
            self.srv._feed_barrier()
            self.rt.flush()
            self.rt.run_tick()
            return {s: sorted(self.rt.query({"subsys": s,
                                              "maxrecs": 1000})["recs"],
                              key=lambda r: json.dumps(r, sort_keys=True))
                    for s in ("svcstate", "hoststate", "taskstate")}
        return self.on_loop(read)

    def close(self):
        self.call(self.srv.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)
        self.loop.close()


def _interrupt_when(pred):
    """SIGINT this process once ``pred`` holds (the command under test
    runs on the main thread and stops on it)."""
    def watch():
        t0 = time.monotonic()
        while not pred() and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGINT)
    th = threading.Thread(target=watch, daemon=True)
    th.start()
    return th


def test_agent_replay_obs_nm_in_process(tmp_path, capsys):
    cap = tmp_path / "fleet.gytrec"
    s1 = _ServerThread(record=str(cap))
    s2 = None
    try:
        w = _interrupt_when(lambda: s1.ctr("sweep_marks") >= 6)
        t_cli.main(["agent", "--port", str(s1.port), "--n-agents", "2",
                    "--seed", "70", "--interval", "0.2", "--n-conn", "32",
                    "--n-resp", "64"])
        w.join(TIMEOUT)
        out = capsys.readouterr()
        rep = json.loads(out.out.strip().splitlines()[-1])["agent_report"]
        assert "supervising 2 agent(s)" in out.err
        assert sorted(r["host_id"] for r in rep) == [0, 1]
        for r in rep:
            c = r["counters"]
            assert c["sweeps_built"] == r["sweep_seq"] >= 3
            assert c["records_built"] == (c.get("records_sent", 0)
                                          + r["spool_records"]
                                          + c.get("spool_dropped_records",
                                                  0))
        # every sweep the agents wrote reaches the server
        want = sum(r["sweep_seq"] for r in rep)
        t0 = time.monotonic()
        while s1.ctr("sweep_marks") < want and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert s1.ctr("sweep_marks") == want
        assert s1.ctr("agents_registered") == 2

        t_cli.main(["obs", "top", "--once", "--port", str(s1.port)])
        top = capsys.readouterr().out
        assert top.startswith("gyt self-monitor")
        assert re.search(r"sweep_marks\s+\d+", top)
        t_cli.main(["obs", "metrics", "--port", str(s1.port)])
        assert "gyt_sweep_marks" in capsys.readouterr().out
        t_cli.main(["nm", "probe", "--crud", "--port", str(s1.port)])
        assert "nm probe: OK" in capsys.readouterr().err

        s2 = _ServerThread()
        t_cli.main(["replay", str(cap), "--port", str(s2.port)])
        from gyeeta_tpu_torch.utils import replay
        nbytes = sum(len(c) for _, c in replay.read_chunks(cap))
        assert f"replayed {nbytes} bytes" in capsys.readouterr().err
        t0 = time.monotonic()
        while (s2.ctr("sweep_marks") < want
               and time.monotonic() - t0 < 10):
            time.sleep(0.01)
        assert s2.views() == s1.views()
    finally:
        s1.close()
        if s2 is not None:
            s2.close()


def test_agent_livecap_starts_in_process(capsys):
    """``agent --collect --real --livecap`` starts and sweeps this host; a
    tracedef that matches every listener opens the capture on the next
    sweep, or, where AF_PACKET is refused, turns it off for good."""
    from gyeeta_tpu_torch.trace import livecap
    s1 = _ServerThread()
    base = {}

    def trace_all():
        s1.srv._feed_barrier()
        s1.rt.flush()
        out = s1.rt.query({"op": "add", "objtype": "tracedef",
                           "name": "cap-all"})
        s1.rt.run_tick()
        return out

    def watch():
        t0 = time.monotonic()
        while s1.ctr("sweep_marks") < 1 and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.01)
        base["add"] = s1.on_loop(trace_all)
        s1.call(s1.srv.push_trace_control())
        base["marks"] = s1.ctr("sweep_marks")
        while (s1.ctr("sweep_marks") < base["marks"] + 3
               and time.monotonic() - t0 < TIMEOUT):
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGINT)

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        t_cli.main(["agent", "--collect", "--real", "--livecap",
                    "--port", str(s1.port), "--seed", "9999",
                    "--interval", "0.2"])
        th.join(TIMEOUT)
    finally:
        s1.close()
    assert base["add"]["ok"]
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cap = rep["agent_report"][0]["livecap"]
    assert cap["enabled"] and cap["closes"] == 0
    if livecap.available("lo"):
        assert cap["opens"] == 1 and not cap["denied"]
        assert s1.port in cap["ports"]
    else:
        assert cap["opens"] == 0 and cap["denied"]


def test_chaos_in_process(capsys):
    s1 = _ServerThread()
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    lport = probe.getsockname()[1]
    probe.close()
    answer = {}

    def client():
        from gyeeta_tpu_torch.net.agent import QueryClient

        async def go():
            for _ in range(500):            # the proxy is listening
                try:
                    qc = QueryClient()
                    await qc.connect("127.0.0.1", lport, timeout=2.0)
                    break
                except OSError:
                    await asyncio.sleep(0.01)
            try:
                return await qc.query({"subsys": "serverstatus"})
            finally:
                await qc.close()
        answer["out"] = asyncio.run(go())
        os.kill(os.getpid(), signal.SIGINT)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        t_cli.main(["chaos", "--upstream-port", str(s1.port),
                    "--listen-port", str(lport), "--seed", "3",
                    "--resplit", "64", "--report-interval", "0.05"])
        th.join(TIMEOUT)
    finally:
        s1.close()
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"chaos proxy on 127.0.0.1:{lport} -> ")
    assert "chaos_stats" in json.loads(out[-1])
    assert answer["out"]["nrecs"] == 1
