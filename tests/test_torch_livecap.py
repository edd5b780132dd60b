"""The port's live AF_PACKET capture on ``lo``, held to the reference.

Every capture here is the port's ``trace/livecap.LiveCapture`` draining
with ``record_path=``: what it drains must equal what the reference's
``parse_pcap`` makes of the frames it recorded (transaction for
transaction; errors only for an ``err_only`` capture). The reference's
own live tests (``tests/test_livecap.py``: a transaction that spans two
drains, the port filter, ``err_only``; ``tests/test_dnssnoop.py``'s
snoop) run unchanged on the port's capture. Then the port alone, on
the CPU: real HTTP into ``Runtime(device="cpu")``, and the product loop
of ``tests/test_livecap_agent.py`` (tracedef → TRACE_SET → the port's
agent captures → ``tracereq`` and ``svcstate`` → the tracedef deleted →
the capture closed). Every socket wait has its own timeout. The tests
skip where this process may not open AF_PACKET (no CAP_NET_RAW).
"""

from __future__ import annotations

import asyncio
import importlib
import socket
import threading
import time

import pytest

from gyeeta_tpu.trace import livecap as j_livecap
from gyeeta_tpu.trace import pcapfile as j_pcap
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.trace import livecap as t_livecap

TIMEOUT = 20.0
CFG = EngineCfg(n_hosts=8, svc_capacity=256, task_capacity=256,
                conn_batch=256, resp_batch=512, listener_batch=64,
                fold_k=2)


@pytest.fixture(autouse=True)
def _needs_af_packet():
    if not t_livecap.available("lo"):
        pytest.skip("needs CAP_NET_RAW for AF_PACKET capture")


class RecordedCapture(t_livecap.LiveCapture):
    """The port's capture, every drain recorded to a pcap; ``close``
    parses the recording with the reference and holds the port's
    drained transactions to it."""

    made: list = []

    def __init__(self, *a, record_path, **kw):
        super().__init__(*a, **kw)
        self.record_path = record_path
        self.drained: list = []
        self.verdict = None
        RecordedCapture.made.append(self)

    def drain(self, record_path=None):
        flows = super().drain(record_path=self.record_path)
        self.drained += [t for f in flows for t in f.transactions]
        return flows

    def close(self):
        super().close()
        try:
            with open(self.record_path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            buf = b""
        ref = [t for f in (j_pcap.parse_pcap(buf) if buf else [])
               for t in f.transactions
               if t.is_error or not self.err_only]
        self.verdict = (sorted(map(tuple, self.drained))
                        == sorted(map(tuple, ref)), len(ref))


@pytest.fixture
def recorded(monkeypatch, tmp_path):
    n = [0]

    def make(*a, **kw):
        n[0] += 1
        return RecordedCapture(*a, record_path=str(tmp_path / f"{n[0]}.pcap"),
                               **kw)
    RecordedCapture.made = []
    monkeypatch.setattr(j_livecap, "LiveCapture", make)
    return RecordedCapture.made


REF_LIVE = [("test_livecap", "test_err_only_tier_keeps_only_errors"),
            ("test_livecap", "test_transaction_spanning_drains_completes"),
            ("test_livecap", "test_port_filter_excludes_other_traffic"),
            ("test_dnssnoop", "test_live_snoop_on_loopback")]


@pytest.mark.parametrize("modname,testname", REF_LIVE,
                         ids=[f"{m}.{t}" for m, t in REF_LIVE])
def test_reference_live_case_on_port_capture(modname, testname, recorded):
    getattr(importlib.import_module(modname), testname)()
    assert recorded and all(isinstance(c, RecordedCapture)
                            for c in recorded)
    for c in recorded:
        assert c.verdict is not None and c.verdict[0], c.verdict


def _serve(sock, replies):
    """Accept one conn; answer each request head with the next reply."""
    conn, _ = sock.accept()
    with conn:
        conn.settimeout(TIMEOUT)
        for body, status in replies:
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                data += chunk
            conn.sendall(b"HTTP/1.1 %d X\r\nContent-Length: %d\r\n\r\n%s"
                         % (status, len(body), body))


def test_real_http_into_the_port_runtime(tmp_path):
    """Two real requests on lo (a 200, a 500) → the port's capture →
    ``transactions_to_records`` → ``Runtime(device="cpu")``: tracereq
    rows and the 500 in svcstate's sererr."""
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.trace.proto import transactions_to_records

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    th = threading.Thread(target=_serve, args=(srv, [(b"ok", 200),
                                                    (b"boom", 500)]),
                          daemon=True)
    th.start()
    cap = RecordedCapture("lo", ports={port},
                          record_path=str(tmp_path / "cap.pcap"))
    try:
        cli = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        for path in (b"/api/items/7", b"/api/items/9"):
            cli.sendall(b"GET " + path + b" HTTP/1.1\r\nHost: t\r\n"
                        b"Content-Length: 0\r\n\r\n")
            resp = b""
            while b"\r\n\r\n" not in resp:
                resp += cli.recv(4096)
        cli.close()
        th.join(TIMEOUT)
        deadline = time.time() + 5
        while time.time() < deadline and cap.n_frames < 4:
            cap.poll()
            time.sleep(0.05)
        flows = cap.drain()
    finally:
        cap.close()
        srv.close()
    assert cap.verdict == (True, 2)
    (f,) = flows
    txns = f.transactions
    assert [t.api for t in txns] == ["GET /api/items/{}"] * 2
    assert [t.is_error for t in txns] == [False, True]
    recs, names = transactions_to_records(txns, svc_glob_id=0xE77,
                                          host_id=1)
    rt = Runtime(EngineCfg(n_hosts=4, svc_capacity=64, conn_batch=64,
                           resp_batch=64, fold_k=2), device="cpu")
    try:
        rt.feed(wire.encode_frames_chunked(wire.NOTIFY_NAME_INTERN, names)
                + wire.encode_frames_chunked(wire.NOTIFY_REQ_TRACE, recs))
        out = rt.query({"subsys": "svcstate", "filter":
                        "{ svcstate.svcid = '0000000000000e77' }"})
        assert out["nrecs"] == 1 and out["recs"][0]["sererr"] == 1
        tr = rt.query({"subsys": "tracereq"})
        assert [(r["api"], r["nreq"], r["nerr"]) for r in tr["recs"]] == \
            [("GET /api/items/{}", 2, 1)]
    finally:
        rt.close()


class _HttpSvc:
    """A localhost HTTP service; a request naming ``fail`` gets a 500."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(c,),
                             daemon=True).start()

    @staticmethod
    def _handle(c):
        try:
            with c:
                c.settimeout(TIMEOUT)
                while True:
                    data = b""
                    while b"\r\n\r\n" not in data:
                        chunk = c.recv(4096)
                        if not chunk:
                            return
                        data += chunk
                    status = 500 if b"fail" in data else 200
                    c.sendall(b"HTTP/1.1 %d X\r\n"
                              b"Content-Length: 2\r\n\r\nok" % status)
        except OSError:
            pass

    def close(self):
        self.srv.close()


def test_tracedef_drives_the_port_agent_capture_end_to_end():
    """tracedef CRUD → TRACE_SET push → the port's agent opens its
    capture on the traced listener's port → real HTTP transactions as
    REQ_TRACE → tracereq and svcstate on the port's CPU runtime → the
    tracedef deleted → the next sweep closes the capture."""
    from gyeeta_tpu_torch.net.agent import NetAgent, QueryClient
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.runtime import Runtime

    def w(coro):
        return asyncio.wait_for(coro, TIMEOUT)

    async def main():
        rt = Runtime(CFG, device="cpu")
        srv = GytServer(rt, tick_interval=None)
        host, port = await w(srv.start())
        svc = _HttpSvc()
        agent = NetAgent(collect=False, real=True, livecap=True)
        qc = QueryClient()
        try:
            await w(agent.connect(host, port))
            await w(agent.send_sweep())       # the listener inventory
            await asyncio.sleep(0.2)
            rt.flush()
            await w(qc.connect(host, port))
            out = await w(qc.query({"op": "add", "objtype": "tracedef",
                                    "name": "cap-all"}))
            assert out["ok"]
            rt.run_tick()
            await w(srv.push_trace_control())
            await asyncio.sleep(0.2)
            assert agent.trace_enabled        # TRACE_SET arrived
            await w(agent.send_sweep())       # the capture opens
            assert agent._cap is not None and svc.port in agent._cap_ports

            def client():
                cli = socket.create_connection(("127.0.0.1", svc.port),
                                               timeout=TIMEOUT)
                for path in (b"/v1/ok/1", b"/v1/ok/2", b"/v1/fail"):
                    cli.sendall(b"GET " + path + b" HTTP/1.1\r\n"
                                b"Host: s\r\nContent-Length: 0\r\n\r\n")
                    r = b""
                    while b"\r\n\r\n" not in r:
                        r += cli.recv(4096)
                cli.close()
            await w(asyncio.to_thread(client))
            await asyncio.sleep(0.3)
            await w(agent.send_sweep())       # drain → REQ_TRACE frames
            await asyncio.sleep(0.3)
            rt.flush()
            tr = await w(qc.query({"subsys": "tracereq", "maxrecs": 50,
                                   "consistency": "strong"}))
            rows = {r["api"]: r for r in tr["recs"]}
            assert rows["GET /v1/ok/{}"]["nreq"] == 2
            assert rows["GET /v1/fail"]["nerr"] == 1
            s = await w(qc.query({"subsys": "svcstate", "maxrecs": 100,
                                  "sortcol": "sererr", "sortdesc": True,
                                  "consistency": "strong"}))
            top = s["recs"][0]
            assert top["sererr"] >= 1 and top["nqry5s"] >= 3
            assert top["p95resp5s"] > 0
            assert (await w(qc.query({"op": "delete",
                                      "objtype": "tracedef",
                                      "name": "cap-all"})))["ok"]
            await w(srv.push_trace_control())
            await asyncio.sleep(0.2)
            await w(agent.send_sweep())
            assert agent._cap is None and agent._cap_closes == 1
            assert agent._cap_opens == 1 and not agent._cap_denied
        finally:
            svc.close()
            await qc.close()
            await agent.close()
            await w(srv.stop())
            rt.close()

    asyncio.run(main())
