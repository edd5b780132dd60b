"""Event-driven process lifecycle via the netlink proc connector.

The reference subscribes to cn_proc for fork/exec/exit events
(``common/gy_misc.h:1181`` carries the proc_event layout; the task
handler consumes the stream) instead of polling /proc. This is the
userspace-possible half of that design: a NETLINK_CONNECTOR socket in
PROC_CN_MCAST_LISTEN mode delivering per-event records the 5s /proc
sweep can fold in — fork counts become event-accurate instead of
inferred from starttime deltas, and exits are seen the moment they
happen rather than at the next sweep.

Privilege-gated (CAP_NET_ADMIN to subscribe); :func:`available`
probes once and everything degrades to the sweep-only inference path.

ABI: cn_msg (20 bytes: cb_id idx/val, seq, ack, len, flags) wraps
proc_event (40 bytes: what, cpu, timestamp_ns, event_data) — offsets
verified against <linux/cn_proc.h> with a compile probe.

Counterpart of ``gyeeta_tpu/net/procconn.py``. When the kernel refuses
the multicast join (no capability), :func:`available` is false and the
task collector keeps the reference's sweep-only fork inference.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Optional

NETLINK_CONNECTOR = 11
CN_IDX_PROC = 1
CN_VAL_PROC = 1
PROC_CN_MCAST_LISTEN = 1
PROC_CN_MCAST_IGNORE = 2

PROC_EVENT_NONE = 0
PROC_EVENT_FORK = 0x1
PROC_EVENT_EXEC = 0x2
PROC_EVENT_COMM = 0x200
PROC_EVENT_EXIT = 0x80000000

_NLHDR = 16
_CNHDR = 20


class ProcEvent:
    __slots__ = ("what", "pid", "tgid", "child_pid", "child_tgid",
                 "exit_code")

    def __init__(self, what, pid, tgid, child_pid=0, child_tgid=0,
                 exit_code=0):
        self.what = what
        self.pid = pid
        self.tgid = tgid
        self.child_pid = child_pid
        self.child_tgid = child_tgid
        self.exit_code = exit_code


class ProcConnector:
    """cn_proc multicast listener → drained :class:`ProcEvent` lists."""

    def __init__(self, rcvbuf: int = 4 << 20):
        self._sock = socket.socket(socket.AF_NETLINK, socket.SOCK_DGRAM,
                                   NETLINK_CONNECTOR)
        self._sock.bind((0, CN_IDX_PROC))
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  rcvbuf)
        except OSError:
            pass
        self._sock.setblocking(False)
        self._send_op(PROC_CN_MCAST_LISTEN)
        self.n_events = 0

    def _send_op(self, op: int) -> None:
        cn = struct.pack("<IIIIHH", CN_IDX_PROC, CN_VAL_PROC, 0, 0, 4,
                         0) + struct.pack("<I", op)
        nl = struct.pack("<IHHII", _NLHDR + len(cn), 3,  # NLMSG_DONE
                         0, 0, os.getpid()) + cn
        self._sock.send(nl)

    def poll(self, max_msgs: int = 4096) -> list:
        """Drain pending events (non-blocking)."""
        out: list[ProcEvent] = []
        for _ in range(max_msgs):
            try:
                msg = self._sock.recv(8192)
            except (BlockingIOError, OSError):
                break
            off = 0
            while off + _NLHDR <= len(msg):
                ln = struct.unpack_from("<I", msg, off)[0]
                if ln < _NLHDR or off + ln > len(msg):
                    break
                body = msg[off + _NLHDR: off + ln]
                off += (ln + 3) & ~3
                if len(body) < _CNHDR + 16:
                    continue
                # proc_event: what u32, cpu u32, timestamp u64, data
                what = struct.unpack_from("<I", body, _CNHDR)[0]
                data = body[_CNHDR + 16:]
                ev = self._decode(what, data)
                if ev is not None:
                    out.append(ev)
        self.n_events += len(out)
        return out

    @staticmethod
    def _decode(what: int, data: bytes) -> Optional[ProcEvent]:
        if what == PROC_EVENT_FORK and len(data) >= 16:
            ppid, ptgid, cpid, ctgid = struct.unpack_from("<iiii", data)
            return ProcEvent(PROC_EVENT_FORK, ppid, ptgid, cpid, ctgid)
        if what == PROC_EVENT_EXEC and len(data) >= 8:
            pid, tgid = struct.unpack_from("<ii", data)
            return ProcEvent(PROC_EVENT_EXEC, pid, tgid)
        if what == PROC_EVENT_EXIT and len(data) >= 12:
            pid, tgid, code = struct.unpack_from("<iiI", data)
            return ProcEvent(PROC_EVENT_EXIT, pid, tgid, exit_code=code)
        return None                    # COMM/UID/… not consumed

    def close(self) -> None:
        try:
            self._send_op(PROC_CN_MCAST_IGNORE)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


_probe_result: Optional[bool] = None


def available() -> bool:
    """True when cn_proc multicast can be joined (cached)."""
    global _probe_result
    if _probe_result is None:
        try:
            c = ProcConnector()
            c.close()
            _probe_result = True
        except OSError:
            _probe_result = False
    return _probe_result
