"""Netlink TASKSTATS delay accounting.

``/proc/[pid]/schedstat`` gives runqueue wait and stat field 42 gives
block-IO delay, but swap-in / memory-reclaim / thrashing delays exist
ONLY in the kernel's taskstats genetlink interface — the reference
reads them over netlink (``common/gy_acct_taskstat.h:209``). This is
a dependency-free generic-netlink client for TASKSTATS_CMD_GET:
resolve the family id once, then query per-pid delay totals.

Privilege-gated (needs CAP_NET_ADMIN for the genl query and the
kernel built with CONFIG_TASKSTATS + delayacct enabled):
:func:`available` probes once; callers degrade to the /proc-only
delays cleanly.

Struct offsets are the kernel UAPI ABI (verified against
<linux/taskstats.h> v13 with a compile probe): the delay fields have
been at fixed offsets since v1 (freepages since v4, thrashing v9);
``version`` is checked before reading version-gated fields.

Counterpart of ``gyeeta_tpu/net/taskdelays.py``. When the kernel refuses
the query (no capability, or no TASKSTATS genetlink family),
:func:`available` is false and ``vm_delay_msec`` stays 0, as in the
reference.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Optional

NETLINK_GENERIC = 16
GENL_ID_CTRL = 0x10
CTRL_CMD_GETFAMILY = 3
CTRL_ATTR_FAMILY_ID = 1
CTRL_ATTR_FAMILY_NAME = 2

TASKSTATS_CMD_GET = 1
TASKSTATS_CMD_ATTR_PID = 1
TASKSTATS_TYPE_AGGR_PID = 4
TASKSTATS_TYPE_STATS = 3

NLM_F_REQUEST = 1

# taskstats struct offsets (UAPI, stable; see module docstring)
_OFF_VERSION = 0
_OFF_CPU_COUNT = 16
_OFF_CPU_DELAY = 24
_OFF_BLKIO_DELAY = 40
_OFF_SWAPIN_DELAY = 56
_OFF_FREEPAGES_DELAY = 320
_OFF_THRASHING_DELAY = 336
_MIN_STATS_LEN = 328        # through freepages (v4+)


def _nlattr(atype: int, payload: bytes) -> bytes:
    ln = 4 + len(payload)
    pad = (-(ln)) % 4
    return struct.pack("<HH", ln, atype) + payload + b"\x00" * pad


def _nlmsg(mtype: int, payload: bytes, seq: int) -> bytes:
    ln = 16 + len(payload)
    return struct.pack("<IHHII", ln, mtype, NLM_F_REQUEST, seq,
                       os.getpid()) + payload


def _walk_attrs(buf: bytes):
    off = 0
    while off + 4 <= len(buf):
        ln, atype = struct.unpack_from("<HH", buf, off)
        if ln < 4 or off + ln > len(buf):
            return
        yield atype & 0x3FFF, buf[off + 4: off + ln]
        off += (ln + 3) & ~3


class TaskDelayReader:
    """One genetlink socket; per-pid delay queries.

    ``get(pid)`` → {"cpu_delay_ns", "blkio_delay_ns",
    "swapin_delay_ns", "freepages_delay_ns", "thrashing_delay_ns"}
    or None (racing exit / perm / kernel without taskstats)."""

    def __init__(self):
        self._sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW,
                                   NETLINK_GENERIC)
        self._sock.bind((0, 0))
        self._sock.settimeout(1.0)
        self._seq = 1
        self._family = self._resolve_family()
        if self._family is None:
            self._sock.close()
            raise OSError("TASKSTATS genl family unavailable")

    def _resolve_family(self) -> Optional[int]:
        payload = (struct.pack("<BBH", CTRL_CMD_GETFAMILY, 1, 0)
                   + _nlattr(CTRL_ATTR_FAMILY_NAME, b"TASKSTATS\x00"))
        self._sock.send(_nlmsg(GENL_ID_CTRL, payload, self._seq))
        self._seq += 1
        try:
            resp = self._sock.recv(65536)
        except (TimeoutError, OSError):
            return None
        ln, mtype = struct.unpack_from("<IH", resp, 0)
        if mtype == 2:                      # NLMSG_ERROR
            return None
        for atype, val in _walk_attrs(resp[16 + 4:]):
            if atype == CTRL_ATTR_FAMILY_ID and len(val) >= 2:
                return struct.unpack("<H", val[:2])[0]
        return None

    def get(self, pid: int) -> Optional[dict]:
        payload = (struct.pack("<BBH", TASKSTATS_CMD_GET, 1, 0)
                   + _nlattr(TASKSTATS_CMD_ATTR_PID,
                             struct.pack("<I", pid)))
        seq = self._seq
        self._seq += 1
        try:
            self._sock.send(_nlmsg(self._family, payload, seq))
            # match the reply's seq: a stale buffered reply (earlier
            # timeout) must not be attributed to THIS pid
            for _ in range(8):
                resp = self._sock.recv(65536)
                if len(resp) >= 12 and \
                        struct.unpack_from("<I", resp, 8)[0] == seq:
                    break
            else:
                return None
        except (TimeoutError, OSError):
            return None
        mtype = struct.unpack_from("<H", resp, 4)[0]
        if mtype == 2:                      # NLMSG_ERROR (pid gone…)
            return None
        stats = None
        for atype, val in _walk_attrs(resp[16 + 4:]):
            if atype == TASKSTATS_TYPE_AGGR_PID:
                for t2, v2 in _walk_attrs(val):
                    if t2 == TASKSTATS_TYPE_STATS:
                        stats = v2
        if stats is None or len(stats) < _OFF_SWAPIN_DELAY + 8:
            return None
        u64 = lambda off: struct.unpack_from("<Q", stats, off)[0]
        ver = struct.unpack_from("<H", stats, _OFF_VERSION)[0]
        out = {
            "cpu_delay_ns": u64(_OFF_CPU_DELAY),
            "blkio_delay_ns": u64(_OFF_BLKIO_DELAY),
            "swapin_delay_ns": u64(_OFF_SWAPIN_DELAY),
            "freepages_delay_ns": 0,
            "thrashing_delay_ns": 0,
        }
        if ver >= 4 and len(stats) >= _OFF_FREEPAGES_DELAY + 8:
            out["freepages_delay_ns"] = u64(_OFF_FREEPAGES_DELAY)
        if ver >= 9 and len(stats) >= _OFF_THRASHING_DELAY + 8:
            out["thrashing_delay_ns"] = u64(_OFF_THRASHING_DELAY)
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


_probe_result: Optional[bool] = None


def available() -> bool:
    """True when the kernel answers TASKSTATS queries (cached)."""
    global _probe_result
    if _probe_result is None:
        try:
            r = TaskDelayReader()
            _probe_result = r.get(os.getpid()) is not None
            r.close()
        except OSError:
            _probe_result = False
    return _probe_result
