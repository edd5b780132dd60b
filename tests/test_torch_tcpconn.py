"""The port's socket and task sweeps against the reference's.

On fixed bytes and text, equal results: ``_diag_request`` and
``_parse_diag_msg`` (the sock_diag request and one ``inet_diag_msg``
with its ``tcp_info`` byte counters, v4 and v6), the ``/proc/net/tcp*``
parser, the conntrack NAT map, ``listener_glob_id`` and
``aggr_task_id_of``, the proc connector's event decode and the
TASKSTATS netlink framing. Live on this host, in one test: both
packages' ``TcpConnCollector`` and ``ProcTaskCollector`` see the test's
own listener and connection with equal listener glob ids, conn tuples
and task group ids; the two socket sources agree on the established
tuples. Both packages' ``available()`` probes of the proc connector and
TASKSTATS agree (the kernel may refuse either: that is the reference's
degradation, not a failure). Everything compared is exact.
"""

import os
import socket
import struct
import threading
import time

import pytest

from gyeeta_tpu.net import procconn as j_pc, taskdelays as j_td
from gyeeta_tpu.net import taskproc as j_tp, tcpconn as j_tc
from gyeeta_tpu_torch.net import procconn as t_pc, taskdelays as t_td
from gyeeta_tpu_torch.net import taskproc as t_tp, tcpconn as t_tc

MID = 0x51DE


def _slots(e):
    return None if e is None else tuple(getattr(e, k) for k in e.__slots__)


@pytest.mark.parametrize("family", [socket.AF_INET, socket.AF_INET6])
@pytest.mark.parametrize("states", [(1 << 1) | (1 << 10), 1 << 10, 0xFFF])
def test_diag_request_equal(family, states):
    assert t_tc._diag_request(family, states) \
        == j_tc._diag_request(family, states)


def _diag_msg(family, info=True, short=False):
    """One inet_diag_msg (+ an INET_DIAG_INFO rtattr with tcp_info)."""
    src = bytes(range(1, 17)) if family == socket.AF_INET6 \
        else bytes([10, 1, 2, 3]) + b"\x00" * 12
    dst = bytes(range(101, 117)) if family == socket.AF_INET6 \
        else bytes([192, 168, 7, 9]) + b"\x00" * 12
    msg = (struct.pack("=BBBB", family, 1, 0, 0)
           + struct.pack(">HH", 8080, 51515) + src + dst
           + struct.pack("=II", 7, 0) + b"\x00" * 4
           + struct.pack("=IIIII", 0, 3, 5, 1000, 424242))
    assert len(msg) == 72
    if info:
        ti = bytearray(160)
        struct.pack_into("=Q", ti, 120, 123456789)
        struct.pack_into("=Q", ti, 128, 987654)
        msg += struct.pack("=HH", 4 + len(ti), 2) + bytes(ti)
    return msg[:60] if short else msg


@pytest.mark.parametrize("case", ["v4", "v6", "v4_noinfo", "short"])
def test_parse_diag_msg_equal(case):
    fam = socket.AF_INET6 if case == "v6" else socket.AF_INET
    payload = _diag_msg(fam, info=case != "v4_noinfo",
                        short=case == "short")
    j, t = j_tc._parse_diag_msg(payload, fam), \
        t_tc._parse_diag_msg(payload, fam)
    assert _slots(t) == _slots(j)
    if case in ("v4", "v6"):
        assert t.bytes_acked == 123456789 and t.bytes_received == 987654


PROC_TCP = """  sl  local_address rem_address   st tx_queue rx_queue tr tm->when retrnsmt   uid  timeout inode
   0: 0100007F:1F90 00000000:0000 0A 00000000:00000000 00:00000000 00000000  1000        0 11111 1 0 100 0 0 10 0
   1: 0100007F:C350 0100007F:1F90 01 00000010:00000020 00:00000000 00000000  1000        0 22222 1 0 20 4 30 10 -1
   2: garbage line
"""
PROC_TCP6 = """  sl  local_address                         remote_address                        st tx_queue rx_queue tr tm->when retrnsmt   uid  timeout inode
   0: 00000000000000000000000001000000:0050 00000000000000000000000000000000:0000 0A 00000000:00000000 00:00000000 00000000     0        0 33333 1 0 100 0 0 10 0
"""


@pytest.mark.parametrize("v6", [False, True], ids=["tcp", "tcp6"])
def test_proc_net_parser_equal(tmp_path, v6):
    p = tmp_path / "tcp"
    p.write_text(PROC_TCP6 if v6 else PROC_TCP)
    j = [_slots(e) for e in j_tc._parse_proc_net(str(p), v6)]
    t = [_slots(e) for e in t_tc._parse_proc_net(str(p), v6)]
    assert t == j and len(t) == (1 if v6 else 2)


CONNTRACK = """ipv4     2 tcp      6 431999 ESTABLISHED src=10.0.0.5 dst=10.96.0.10 sport=40000 dport=80 src=10.244.1.7 dst=10.0.0.5 sport=8080 dport=40000 [ASSURED] mark=0 use=1
ipv4     2 tcp      6 431999 ESTABLISHED src=10.0.0.6 dst=10.0.0.7 sport=40001 dport=22 src=10.0.0.7 dst=10.0.0.6 sport=22 dport=40001 [ASSURED] mark=0 use=1
ipv6     10 tcp      6 300 ESTABLISHED src=fd00::1 dst=fd00::2 sport=1234 dport=443 src=fd00::9 dst=fd00::1 sport=8443 dport=1234 mark=0 use=1
ipv4     2 udp      17 29 src=10.0.0.5 dst=8.8.8.8 sport=5353 dport=53 src=8.8.8.8 dst=10.0.0.5 sport=53 dport=5353 mark=0 use=1
"""


def test_conntrack_nat_map_equal(tmp_path):
    p = tmp_path / "nf_conntrack"
    p.write_text(CONNTRACK)
    j, t = j_tc.conntrack_nat_map(str(p)), t_tc.conntrack_nat_map(str(p))
    assert t == j and len(t) == 2


@pytest.mark.parametrize("mid,addr,port,comm", [
    (1, b"\x00" * 16, 80, "nginx"),
    (MID, b"\x00" * 10 + b"\xff\xff" + bytes([127, 0, 0, 1]), 10038,
     "python3"),
    (2 ** 63 + 5, bytes(range(16)), 65535, "a" * 15)])
def test_ids_equal(mid, addr, port, comm):
    assert t_tc.listener_glob_id(mid, addr, port) \
        == j_tc.listener_glob_id(mid, addr, port)
    assert t_tc.aggr_task_id_of(mid, comm) == j_tc.aggr_task_id_of(mid, comm)


@pytest.mark.parametrize("what,data", [
    (t_pc.PROC_EVENT_FORK, struct.pack("<iiii", 10, 10, 11, 11)),
    (t_pc.PROC_EVENT_EXEC, struct.pack("<ii", 12, 12)),
    (t_pc.PROC_EVENT_EXIT, struct.pack("<iiI", 13, 13, 256)),
    (t_pc.PROC_EVENT_COMM, b"\x00" * 24),
    (t_pc.PROC_EVENT_FORK, b"\x00" * 8)])
def test_proc_event_decode_equal(what, data):
    j = j_pc.ProcConnector._decode(what, data)
    t = t_pc.ProcConnector._decode(what, data)
    assert _slots(t) == _slots(j)


def test_taskstats_framing_equal():
    attr = t_td._nlattr(t_td.TASKSTATS_CMD_ATTR_PID, struct.pack("<I", 42))
    assert attr == j_td._nlattr(j_td.TASKSTATS_CMD_ATTR_PID,
                                struct.pack("<I", 42))
    assert t_td._nlmsg(0x17, attr, 9) == j_td._nlmsg(0x17, attr, 9)
    nested = t_td._nlattr(4, t_td._nlattr(3, b"x" * 9) + attr)
    assert list(t_td._walk_attrs(nested)) == list(j_td._walk_attrs(nested))


def test_kernel_probes_agree():
    """The proc connector and TASKSTATS: both packages' probes give the
    same answer on this host (a refusal degrades, as the reference's)."""
    assert t_pc.available() == j_pc.available()
    assert t_td.available() == j_td.available()


def test_read_pid_equal():
    pid = str(os.getpid())
    j, t = j_tp._read_pid(pid), t_tp._read_pid(pid)
    # comm and start time are fixed; cpu ticks and rss move
    assert (t[0], t[3]) == (j[0], j[3])
    assert j_tp._read_pid("0") is None and t_tp._read_pid("0") is None


class _Echo:
    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self.conns = []
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(c)
            try:
                c.sendall(c.recv(4096))
            except OSError:
                pass

    def close(self):
        for c in self.conns:
            c.close()
        self.srv.close()


def _has_socket_source():
    return t_tc.list_tcp_netlink() is not None or bool(t_tc.list_tcp_proc())


def test_sources_agree_on_tuples():
    """sock_diag and /proc/net enumerate the same established tuples."""
    if not _has_socket_source():
        pytest.skip("no sock_diag or /proc/net/tcp on this host")
    echo = _Echo()
    cli = socket.create_connection(("127.0.0.1", echo.port))
    try:
        time.sleep(0.05)
        nl, pr = t_tc.list_tcp_netlink(), t_tc.list_tcp_proc()
        pk = {s.key for s in pr if s.state == 1}
        if nl is not None:
            nk = {s.key for s in nl if s.state == 1}
            assert len(nk & pk) >= max(1, int(0.7 * min(len(nk),
                                                         len(pk) or 1)))
        mine = (b"\x00" * 10 + b"\xff\xff" + bytes([127, 0, 0, 1]),
                cli.getsockname()[1])
        assert any(k[:2] == mine for k in pk)
    finally:
        cli.close()
        echo.close()


def test_live_collectors_agree_on_own_sockets():
    """Both packages' collectors, run on this host: the test's listener,
    its accepted and its dialled conn, and this process's task group."""
    if not _has_socket_source():
        pytest.skip("no sock_diag or /proc/net/tcp on this host")
    cols = [(m.TcpConnCollector(host_id=2, machine_id=MID),
             p.ProcTaskCollector(host_id=2, machine_id=MID,
                                 netlink_delays=False))
            for m, p in ((j_tc, j_tp), (t_tc, t_tp))]
    for tc, tp in cols:
        tc.sweep()                  # the baseline: the listener is new after
        tp.sweep()
    echo = _Echo()
    cli = socket.create_connection(("127.0.0.1", echo.port))
    cli.sendall(b"x" * 300)
    cli.recv(4096)
    time.sleep(0.05)
    try:
        out = []
        for tc, tp in cols:
            d = tc.sweep()
            tasks, _ = tp.sweep(task_net=d["task_net"],
                                listener_of_comm=d["listener_of_comm"])
            li = d["listener_info"]
            li = li[li["addr"]["port"] == echo.port]
            c = d["conns"]
            acc = c[(c["ser"]["port"] == echo.port)
                    & (c["flags"] & 2 != 0)]
            dial = c[(c["cli"]["port"] == cli.getsockname()[1])
                     & (c["flags"] & 1 != 0)]
            comm = open(f"/proc/{os.getpid()}/comm").read().strip()[:16]
            grp = tasks[tasks["aggr_task_id"]
                        == t_tc.aggr_task_id_of(MID, comm)]
            out.append({
                "glob_id": li["glob_id"].tolist(),
                "accepted": [(bytes(r["cli"]["ip"]), int(r["cli"]["port"]),
                              bytes(r["ser"]["ip"]), int(r["ser"]["port"]),
                              int(r["ser_glob_id"])) for r in acc],
                "dialled": [(bytes(r["cli"]["ip"]), int(r["cli"]["port"]),
                             bytes(r["ser"]["ip"]), int(r["ser"]["port"]),
                             int(r["cli_task_aggr_id"])) for r in dial],
                "group": grp["comm_id"].tolist()})
        assert out[1] == out[0]
        gid = t_tc.listener_glob_id(
            MID, b"\x00" * 10 + b"\xff\xff" + bytes([127, 0, 0, 1]),
            echo.port)
        assert out[1]["glob_id"] == [gid]
        assert len(out[1]["accepted"]) == 1 \
            and out[1]["accepted"][0][4] == gid
        assert len(out[1]["dialled"]) == 1 and len(out[1]["group"]) == 1
    finally:
        cli.close()
        echo.close()
        for _, tp in cols:
            tp.close()
