"""Real TCP connection collector: netlink sock_diag → wire records.

The first REAL traffic source: the agent's own host's
TCP connections and listeners, observed from userspace — the analogue
of the reference's inet_diag full-connection sweep
(``common/gy_socket_stat.cc:8598`` inet_diag_thread, 15s cadence,
``gy_socket_stat.h:996``) and its listener inventory, without eBPF.

Three sources, best-effort and privilege-graceful:

- **netlink NETLINK_SOCK_DIAG** (primary): one dump request per family
  enumerates every TCP socket with its tuple, state, queues, uid and
  inode; the ``INET_DIAG_INFO`` attribute carries ``struct tcp_info``
  whose ``tcpi_bytes_acked``/``tcpi_bytes_received`` (kernel ≥4.1) give
  REAL per-connection byte counts — the userspace stand-in for the
  reference's eBPF ``tcp_sendmsg``/``tcp_cleanup_rbuf`` accounting.
- **/proc/net/tcp{,6}** (fallback): same tuples/states/inodes, no byte
  counters.
- **/proc/net/nf_conntrack** (optional): original↔reply tuple pairs
  fill ``nat_cli``/``nat_ser`` the way the reference's netlink
  conntrack listener does (``gy_socket_stat.cc:1292``).

Sweep semantics (delta-based, like every collector here):

- listeners → stable glob_ids hashed from (machine_id, ip, port);
  first sight emits LISTENER_INFO (+ name announcements from the
  owning process's comm via the /proc fd→inode walk), every sweep
  emits LISTENER_STATE with real conn counts + byte rates.
- established conns → TCP_CONN records. A socket whose local port is
  a listening port is accept-observed (``flags`` bit1, the service
  side, ``ser_glob_id`` = listener id); otherwise connect-observed
  (bit0, ``ser_glob_id`` 0 — the remote service is unknown exactly as
  in the reference, resolved server-side by pairing). Byte fields are
  per-sweep DELTAS (the engine folds them additively); close is
  detected by disappearance and emits a final record with
  ``tusec_close`` set.

Counterpart of ``gyeeta_tpu/net/tcpconn.py``: the same netlink and /proc
parsers, listener and task ids from the port's ``hash_bytes_np``, and
records in the port's ``wire`` dtypes. Numpy and the standard library,
no device.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.intern import InternTable

# ---------------------------------------------------------------- netlink
NETLINK_SOCK_DIAG = 4
SOCK_DIAG_BY_FAMILY = 20
NLM_F_REQUEST = 0x1
NLM_F_DUMP = 0x300            # NLM_F_ROOT | NLM_F_MATCH
NLMSG_ERROR = 2
NLMSG_DONE = 3
INET_DIAG_INFO = 2
TCP_ESTABLISHED = 1
TCP_LISTEN = 10
# struct tcp_info offsets (linux/tcp.h, append-only ABI): 8 lead bytes,
# 24 u32s, 2 u64 pacing rates → bytes_acked @120, bytes_received @128
_TCPI_BYTES_ACKED_OFF = 120
_TCPI_BYTES_RECEIVED_OFF = 128


class SockEntry:
    """One kernel TCP socket (family-normalized to 16-byte addresses)."""

    __slots__ = ("saddr", "sport", "daddr", "dport", "state", "inode",
                 "uid", "rqueue", "wqueue", "bytes_acked",
                 "bytes_received")

    def __init__(self, saddr: bytes, sport: int, daddr: bytes,
                 dport: int, state: int, inode: int, uid: int = 0,
                 rqueue: int = 0, wqueue: int = 0,
                 bytes_acked: int = 0, bytes_received: int = 0):
        self.saddr, self.sport = saddr, sport
        self.daddr, self.dport = daddr, dport
        self.state, self.inode, self.uid = state, inode, uid
        self.rqueue, self.wqueue = rqueue, wqueue
        self.bytes_acked = bytes_acked
        self.bytes_received = bytes_received

    @property
    def key(self):
        return (self.saddr, self.sport, self.daddr, self.dport)


def _map4(addr4: bytes) -> bytes:
    """IPv4 → IPv4-mapped IPv6 (the wire's 16-byte address form)."""
    return b"\x00" * 10 + b"\xff\xff" + addr4


def _diag_request(family: int, states: int) -> bytes:
    # nlmsghdr + inet_diag_req_v2 (+ sockid zeroed)
    req = struct.pack("=BBBBI", family, socket.IPPROTO_TCP,
                      1 << (INET_DIAG_INFO - 1), 0, states) + b"\x00" * 48
    hdr = struct.pack("=IHHII", 16 + len(req), SOCK_DIAG_BY_FAMILY,
                      NLM_F_REQUEST | NLM_F_DUMP, 1, 0)
    return hdr + req


def _parse_diag_msg(payload: bytes, family: int) -> Optional[SockEntry]:
    if len(payload) < 72:
        return None
    fam, state = payload[0], payload[1]
    sport, dport = struct.unpack_from(">HH", payload, 4)
    src = payload[8:24]
    dst = payload[24:40]
    expires, rqueue, wqueue, uid, inode = struct.unpack_from(
        "=IIIII", payload, 52)
    if fam == socket.AF_INET:
        src, dst = _map4(src[:4]), _map4(dst[:4])
    ent = SockEntry(src, sport, dst, dport, state, inode, uid,
                    rqueue, wqueue)
    # walk rtattrs for INET_DIAG_INFO (tcp_info byte counters)
    off = 72
    while off + 4 <= len(payload):
        alen, atype = struct.unpack_from("=HH", payload, off)
        if alen < 4 or off + alen > len(payload):
            break
        if atype == INET_DIAG_INFO:
            info = payload[off + 4: off + alen]
            if len(info) >= _TCPI_BYTES_RECEIVED_OFF + 8:
                (ent.bytes_acked,) = struct.unpack_from(
                    "=Q", info, _TCPI_BYTES_ACKED_OFF)
                (ent.bytes_received,) = struct.unpack_from(
                    "=Q", info, _TCPI_BYTES_RECEIVED_OFF)
        off += (alen + 3) & ~3
    return ent


def list_tcp_netlink(states: int = (1 << TCP_ESTABLISHED)
                     | (1 << TCP_LISTEN)) -> Optional[list]:
    """All TCP sockets via sock_diag, or None when netlink yields
    nothing. A per-family failure (e.g. NLMSG_ERROR on AF_INET6 when
    ipv6 is disabled) skips only that family — the v4 results, with
    their tcp_info byte counters, are still worth more than the /proc
    fallback."""
    out: list[SockEntry] = []
    any_ok = False
    for family in (socket.AF_INET, socket.AF_INET6):
        try:
            s = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW,
                              NETLINK_SOCK_DIAG)
        except (OSError, AttributeError):
            return None
        fam_ok = True
        fam_out: list[SockEntry] = []
        try:
            s.settimeout(2.0)
            s.sendto(_diag_request(family, states), (0, 0))
            done = False
            while not done:
                data = s.recv(1 << 20)
                off = 0
                while off + 16 <= len(data):
                    mlen, mtype = struct.unpack_from("=IH", data, off)
                    if mlen < 16 or off + mlen > len(data):
                        done = True
                        break
                    if mtype == NLMSG_DONE:
                        done = True
                        break
                    if mtype == NLMSG_ERROR:
                        fam_ok = False
                        done = True
                        break
                    if mtype == SOCK_DIAG_BY_FAMILY:
                        ent = _parse_diag_msg(
                            data[off + 16: off + mlen], family)
                        if ent is not None:
                            fam_out.append(ent)
                    off += (mlen + 3) & ~3
        except OSError:
            fam_ok = False
        finally:
            s.close()
        if fam_ok:
            any_ok = True
            out.extend(fam_out)
    return out if any_ok else None


# ------------------------------------------------------- /proc/net fallback
def _parse_proc_net(path: str, v6: bool) -> list:
    out = []
    try:
        with open(path) as f:
            lines = f.readlines()[1:]
    except OSError:
        return out
    for line in lines:
        p = line.split()
        if len(p) < 10:
            continue
        try:
            laddr, lport = p[1].rsplit(":", 1)
            raddr, rport = p[2].rsplit(":", 1)
            state = int(p[3], 16)
            uid = int(p[7])
            inode = int(p[9])
            rxq, txq = p[4].rsplit(":", 1)
            if v6:
                # 4 native-endian 32-bit groups
                src = b"".join(bytes.fromhex(laddr[i:i + 8])[::-1]
                               for i in range(0, 32, 8))
                dst = b"".join(bytes.fromhex(raddr[i:i + 8])[::-1]
                               for i in range(0, 32, 8))
            else:
                src = _map4(bytes.fromhex(laddr)[::-1])
                dst = _map4(bytes.fromhex(raddr)[::-1])
            out.append(SockEntry(src, int(lport, 16), dst,
                                 int(rport, 16), state, inode, uid,
                                 int(rxq, 16), int(txq, 16)))
        except (ValueError, IndexError):
            continue
    return out


def list_tcp_proc() -> list:
    return (_parse_proc_net("/proc/net/tcp", False)
            + _parse_proc_net("/proc/net/tcp6", True))


# ------------------------------------------------------------- /proc pids
def inode_owners(inodes: set) -> dict:
    """{socket inode: (pid, comm)} via one bounded /proc fd walk (the
    reference resolves socket→task the same way outside eBPF,
    ``common/gy_socket_stat.cc`` diag→task matching)."""
    out: dict[int, tuple] = {}
    if not inodes:
        return out
    try:
        pids = [d for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return out
    for pid in pids:
        fd_dir = f"/proc/{pid}/fd"
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue
        comm = None
        for fd in fds:
            try:
                tgt = os.readlink(f"{fd_dir}/{fd}")
            except OSError:
                continue
            if not tgt.startswith("socket:["):
                continue
            try:
                ino = int(tgt[8:-1])
            except ValueError:
                continue
            if ino in inodes and ino not in out:
                if comm is None:
                    try:
                        with open(f"/proc/{pid}/comm") as f:
                            comm = f.read().strip()[:16]
                    except OSError:
                        comm = "?"
                out[ino] = (int(pid), comm)
        if len(out) == len(inodes):
            break
    return out


# -------------------------------------------------------------- conntrack
def conntrack_nat_map(path: str = "/proc/net/nf_conntrack",
                      max_lines: int = 65536) -> dict:
    """{(cli_ip, cli_port, ser_ip, ser_port): (nat_cli.., nat_ser..)}
    for entries whose reply tuple shows address translation."""
    out: dict = {}
    try:
        with open(path) as f:
            lines = f.readlines()[:max_lines]
    except OSError:
        return out
    import ipaddress
    for line in lines:
        if " tcp " not in line:
            continue
        kv: dict[str, list] = {}
        for tok in line.split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                kv.setdefault(k, []).append(v)
        try:
            o_src, o_dst = kv["src"][0], kv["dst"][0]
            o_sp, o_dp = int(kv["sport"][0]), int(kv["dport"][0])
            r_src, r_dst = kv["src"][1], kv["dst"][1]
            r_sp, r_dp = int(kv["sport"][1]), int(kv["dport"][1])
        except (KeyError, IndexError, ValueError):
            continue
        if (r_src, r_sp, r_dst, r_dp) == (o_dst, o_dp, o_src, o_sp):
            continue                      # no translation

        def ip16(s):
            return ipaddress.ip_address(s).packed.rjust(16, b"\x00") \
                if ":" in s else _map4(ipaddress.ip_address(s).packed)

        key = (ip16(o_src), o_sp, ip16(o_dst), o_dp)
        # post-NAT server = reply source; post-NAT client = reply dest
        out[key] = (ip16(r_dst), r_dp, ip16(r_src), r_sp)
    return out


# ---------------------------------------------------------------- collector
def listener_glob_id(machine_id: int, addr: bytes, port: int) -> int:
    """Stable nonzero 64-bit listener id (survives agent restarts —
    the role of the reference's listener shm glob ids)."""
    gid = H.hash_bytes_np(
        b"L" + machine_id.to_bytes(8, "little") + addr
        + port.to_bytes(2, "little"))
    return gid or 1


_ANY6 = b"\x00" * 16
_ANY4 = _map4(b"\x00" * 4)
_V4PFX = b"\x00" * 10 + b"\xff\xff"
_LOOP6 = b"\x00" * 15 + b"\x01"


def _is_loopback_pair(cli_addr: bytes, ser_addr: bytes) -> bool:
    """Both ends on this host: same address, 127/8, or ::1."""
    def is_lo(a: bytes) -> bool:
        return (a == _LOOP6
                or (a[:12] == _V4PFX and a[12] == 127))
    return cli_addr == ser_addr or (is_lo(cli_addr) and is_lo(ser_addr))


class TcpConnCollector:
    """15s-cadence sweep of this host's real TCP world → wire records.

    ``sweep()`` → dict with keys ``conns`` (TCP_CONN_DT), ``listeners``
    (LISTENER_STATE_DT), ``listener_info`` (new listeners only),
    ``names`` (NAME_INTERN_DT), each a record array ready for
    ``wire.encode_frame``.
    """

    def __init__(self, host_id: int = 0, machine_id: int = 1,
                 use_netlink: bool = True, conntrack: bool = True):
        self.host_id = host_id
        self.machine_id = machine_id
        self.use_netlink = use_netlink
        self.conntrack = conntrack
        self._known_listeners: dict = {}   # (addr,port) -> (glob_id, comm)
        self._conn_prev: dict = {}         # key -> [acked, recvd, t0us, pre]
        self._first_sweep = True

    # -- live-capture targeting --------------------------------------
    def listener_ports(self, gids) -> set:
        """TCP ports of the given listener glob ids (the live-capture
        port filter; one registry owns the (addr, port) → gid shape)."""
        return {port for (_a, port), (gid, _c)
                in self._known_listeners.items() if gid in gids}

    def resolve_listener(self, addr16: bytes, port: int,
                         gids=None) -> Optional[int]:
        """(captured server addr, port) → listener glob id.

        Exact (addr, port) match wins; otherwise a wildcard-bound
        listener on the port (0.0.0.0/:: — the common case, and the
        reason port-only inversion would misattribute dual-stack
        listeners); otherwise any listener on the port. Restricted to
        ``gids`` when given so an untraced listener sharing the port
        can never claim traced records."""
        if len(addr16) == 4:          # pcap v4 → v4-mapped (registry
            addr16 = b"\x00" * 10 + b"\xff\xff" + addr16   # format)
        best = None
        for (a, p), (gid, _c) in self._known_listeners.items():
            if p != port or (gids is not None and gid not in gids):
                continue
            if a == addr16:
                return gid
            if a in (b"\x00" * 16,
                     b"\x00" * 10 + b"\xff\xff" + b"\x00" * 4):
                best = gid                         # wildcard bind
            elif best is None:
                best = gid
        return best

    # -- one sweep ---------------------------------------------------
    def _snapshot(self) -> tuple:
        """→ (sockets, have_bytes). have_bytes is False on the /proc
        fallback — byte baselines must NOT be clobbered then, or the
        next netlink sweep would bill a conn's whole lifetime as one
        delta."""
        if self.use_netlink:
            socks = list_tcp_netlink()
            if socks is not None:
                return socks, True
        return list_tcp_proc(), False

    def sweep(self) -> dict:
        now_us = int(time.time() * 1e6)
        socks, have_bytes = self._snapshot()
        listeners = [s for s in socks if s.state == TCP_LISTEN]
        estab = [s for s in socks if s.state == TCP_ESTABLISHED]
        nat = conntrack_nat_map() if self.conntrack else {}
        # evict listeners that stopped listening (their LISTENER_STATE
        # rows stop; a reappearance re-announces LISTENER_INFO)
        cur_lkeys = {(s.saddr, s.sport) for s in listeners}
        for k in [k for k in self._known_listeners
                  if k not in cur_lkeys]:
            del self._known_listeners[k]

        # listener identity + (pid, comm) for NEW listeners only (the
        # /proc fd walk is the expensive part; known ones are cached)
        lmap: dict = {}                    # port -> [(addr, glob_id)]
        new_listeners = []
        need_inodes = set()
        for s in listeners:
            k = (s.saddr, s.sport)
            known = self._known_listeners.get(k)
            if known is None:
                gid = listener_glob_id(self.machine_id, s.saddr, s.sport)
                new_listeners.append((s, gid))
                need_inodes.add(s.inode)
            else:
                gid = known[0]
            lmap.setdefault(s.sport, []).append((s.saddr, gid))
        owners = inode_owners(need_inodes) if need_inodes else {}

        names: list = []
        li_recs = np.zeros(len(new_listeners), wire.LISTENER_INFO_DT)
        for i, (s, gid) in enumerate(new_listeners):
            pid, comm = owners.get(s.inode, (0, "?"))
            self._known_listeners[(s.saddr, s.sport)] = (gid, comm)
            comm_id = InternTable.intern(comm, wire.NAME_KIND_COMM)
            # service display name: comm:port — unique per listener and
            # human-readable (the reference uses comm + resolved domain)
            svc_name = f"{comm}:{s.sport}"
            names += [(wire.NAME_KIND_COMM, comm_id, comm),
                      (wire.NAME_KIND_SVC, gid, svc_name)]
            r = li_recs[i]
            r["glob_id"] = gid
            r["addr"]["ip"] = np.frombuffer(s.saddr, np.uint8)
            r["addr"]["port"] = s.sport
            r["tusec_start"] = now_us
            r["comm_id"] = comm_id
            r["cmdline_id"] = comm_id
            r["related_listen_id"] = gid
            r["pid"] = pid
            r["is_any_ip"] = s.saddr in (_ANY6, _ANY4)
            r["host_id"] = self.host_id

        def match_listener(addr: bytes, port: int) -> int:
            for laddr, gid in lmap.get(port, ()):
                if laddr in (_ANY6, _ANY4) or laddr == addr:
                    return gid
            return 0

        # established conns: classify + byte deltas. The /proc fd walk
        # runs only for NEW outbound conns — known ones carry their
        # cached (pid, comm) in the prev entry.
        conn_rows = []
        per_listener: dict = {}      # gid -> [nconn, active, kin, kout]
        task_net: dict = {}          # aggr_task_id -> [kbytes, nconns]
        seen_keys = set()
        new_out_inodes = {
            s.inode for s in estab
            if s.inode and s.key not in self._conn_prev
            and not match_listener(s.saddr, s.sport)}
        out_owners = inode_owners(new_out_inodes) \
            if new_out_inodes else {}

        for s in estab:
            key = s.key
            seen_keys.add(key)
            prev = self._conn_prev.get(key)
            new = prev is None
            gid = match_listener(s.saddr, s.sport)
            if new:
                # [acked, recvd, t0us, pre-existing, pid, comm]
                prev = [0, 0, now_us, self._first_sweep, 0, ""]
                if not gid:
                    prev[4], prev[5] = out_owners.get(s.inode, (0, ""))
                self._conn_prev[key] = prev
            if have_bytes:
                d_acked = max(s.bytes_acked - prev[0], 0)
                d_recvd = max(s.bytes_received - prev[1], 0)
                prev[0], prev[1] = s.bytes_acked, s.bytes_received
            else:
                d_acked = d_recvd = 0
            st = per_listener.setdefault(gid, [0, 0, 0.0, 0.0]) \
                if gid else None
            if st is not None:
                st[0] += 1
                if d_acked or d_recvd or s.rqueue or s.wqueue:
                    st[1] += 1
                st[2] += d_recvd / 1024.0
                st[3] += d_acked / 1024.0
            elif prev[5]:
                # outbound with a known owner: per-process-group traffic
                # (feeds AGGR_TASK tcp_kbytes/tcp_conns via taskproc)
                tn = task_net.setdefault(
                    aggr_task_id_of(self.machine_id, prev[5]), [0.0, 0])
                tn[0] += (d_acked + d_recvd) / 1024.0
                tn[1] += 1
            if not (new or d_acked or d_recvd):
                continue                  # idle known conn: nothing new
            conn_rows.append(self._conn_record(
                s, gid, d_acked, d_recvd, prev, nat, now_us, names,
                close=False))

        # disappeared conns → close records
        gone = [k for k in self._conn_prev if k not in seen_keys]
        for key in gone:
            prev = self._conn_prev.pop(key)
            s = SockEntry(key[0], key[1], key[2], key[3],
                          TCP_ESTABLISHED, 0)
            gid = match_listener(s.saddr, s.sport)
            conn_rows.append(self._conn_record(
                s, gid, 0, 0, prev, nat, now_us, names, close=True))

        conns = (np.stack(conn_rows) if conn_rows
                 else np.empty(0, wire.TCP_CONN_DT))

        # per-listener 5s-equivalent state
        ls = np.zeros(len(self._known_listeners), wire.LISTENER_STATE_DT)
        for i, ((addr, port), (gid, _comm)) in enumerate(
                self._known_listeners.items()):
            r = ls[i]
            st = per_listener.get(gid, [0, 0, 0.0, 0.0])
            r["glob_id"] = gid
            r["nconns"], r["nconns_active"] = st[0], st[1]
            r["curr_kbytes_inbound"] = min(int(st[2]), 2**32 - 1)
            r["curr_kbytes_outbound"] = min(int(st[3]), 2**32 - 1)
            r["ntasks"] = 1
            r["curr_state"] = 2 if st[1] else 1    # OK / IDLE
            r["host_id"] = self.host_id

        self._first_sweep = False
        return {
            "conns": conns,
            "listeners": ls,
            "listener_info": li_recs,
            "names": InternTable.records(names) if names
            else np.empty(0, wire.NAME_INTERN_DT),
            # joins for the /proc task collector (same sweep cadence);
            # a comm owning several listeners joins to the SMALLEST gid
            # — deterministic across sweeps and agent restarts (gids
            # are stable hashes)
            "task_net": task_net,
            "listener_of_comm": self._listener_of_comm(),
        }

    def _listener_of_comm(self) -> dict:
        out: dict = {}
        for gid, comm in self._known_listeners.values():
            if comm and comm != "?":
                cur = out.get(comm)
                if cur is None or gid < cur:
                    out[comm] = gid
        return out

    def _conn_record(self, s: SockEntry, gid: int, d_acked: int,
                     d_recvd: int, prev: list, nat: dict,
                     now_us: int, names: list,
                     close: bool) -> np.ndarray:
        r = np.zeros((), wire.TCP_CONN_DT)
        inbound = gid != 0
        if inbound:
            cli_addr, cli_port = s.daddr, s.dport
            ser_addr, ser_port = s.saddr, s.sport
            # client-perspective bytes: what the client SENT is what we
            # (the server) received
            bsent, brcvd = d_recvd, d_acked
            r["ser_glob_id"] = gid
            r["ser_related_listen_id"] = gid
            r["flags"] = 2
        else:
            cli_addr, cli_port = s.saddr, s.sport
            ser_addr, ser_port = s.daddr, s.dport
            bsent, brcvd = d_acked, d_recvd
            r["flags"] = 1
            pid, comm = prev[4], prev[5]
            if comm:
                r["cli_pid"] = pid
                comm_id = InternTable.intern(comm, wire.NAME_KIND_COMM)
                r["cli_comm_id"] = comm_id
                names.append((wire.NAME_KIND_COMM, comm_id, comm))
                r["cli_task_aggr_id"] = aggr_task_id_of(
                    self.machine_id, comm)
        if _is_loopback_pair(cli_addr, ser_addr):
            r["flags"] |= 4
        r["cli"]["ip"] = np.frombuffer(cli_addr, np.uint8)
        r["cli"]["port"] = cli_port
        r["ser"]["ip"] = np.frombuffer(ser_addr, np.uint8)
        r["ser"]["port"] = ser_port
        natv = nat.get((cli_addr, cli_port, ser_addr, ser_port))
        if natv:
            r["nat_cli"]["ip"] = np.frombuffer(natv[0], np.uint8)
            r["nat_cli"]["port"] = natv[1]
            r["nat_ser"]["ip"] = np.frombuffer(natv[2], np.uint8)
            r["nat_ser"]["port"] = natv[3]
        r["tusec_start"] = prev[2]
        if close:
            r["tusec_close"] = now_us
        if prev[3]:
            r["flags"] |= 8               # pre-existing at first sweep
        r["bytes_sent"] = bsent
        r["bytes_rcvd"] = brcvd
        r["ser_sock_inode"] = s.inode & 0xFFFFFFFF
        r["host_id"] = self.host_id
        return r


def aggr_task_id_of(machine_id: int, comm: str) -> int:
    """Stable process-group id: (machine, comm) → nonzero u64. The
    reference aggregates tasks the same way — a hash over comm +
    cgroup identity (``common/gy_task_handler.h:180``); shared by this
    collector and the /proc task collector so conn→task joins line up."""
    tid = H.hash_bytes_np(
        b"T" + machine_id.to_bytes(8, "little") + comm.encode())
    return tid or 1
