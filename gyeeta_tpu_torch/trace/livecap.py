"""Live AF_PACKET capture behind a privilege gate (VERDICT r4 #9).

The reference captures each service's traffic live with per-netns
AF_PACKET sockets and dynamic BPF filters, plus a cheap error-only
HTTP tier feeding ``ser_errors``
(``common/gy_svc_net_capture.h:153,232,286``,
``gy_network_capture.h``). Userspace here CAN do the same when the
process holds CAP_NET_RAW — this module opens a raw packet socket on
one interface, batches captured frames, and replays them through the
SAME reassembly/parser machinery the pcap-file path uses
(``trace/pcapfile.py``) — one tested flow engine for files and live
traffic.

Design notes (redesign, not a translation):
- **Privilege-gated, never required**: :func:`available` probes
  CAP_NET_RAW by opening-and-closing a socket; everything degrades to
  "no live capture" cleanly (the reference also runs captureless when
  the cap is missing).
- **Batch-replay, not per-packet**: frames accumulate in a bounded
  ring and parse on :meth:`drain` cadence as a synthesized pcap
  stream. Parsing cost is paid per drain (5s cadence), not per
  packet — the same batching discipline as the engine's K-slab folds.
- **Port filter = the dynamic-BPF analogue**: a host-side port set
  bounds buffered frames; the error tier is a post-parse filter
  (headers only are parsed either way, so "cheap tier" = keep only
  ``is_error`` transactions).

Counterpart of ``gyeeta_tpu/trace/livecap.py`` (pure Python); the port's
agent opens it for ``livecap=True``.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional

from gyeeta_tpu_torch.trace import pcapfile as PF

ETH_P_ALL = 0x0003


def available(ifname: str = "lo") -> bool:
    """True when this process may open AF_PACKET sockets (CAP_NET_RAW)."""
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(ETH_P_ALL))
        try:
            s.bind((ifname, 0))
        finally:
            s.close()
        return True
    except (PermissionError, OSError):
        return False


class LiveCapture:
    """One interface's live TCP capture → parsed transactions.

    ``ports`` restricts buffering to frames whose TCP src or dst port
    is in the set (both directions of a service's conversations).
    ``err_only`` keeps only error transactions at drain (the cheap
    tier). Raises PermissionError without CAP_NET_RAW — callers gate
    on :func:`available`.
    """

    def __init__(self, ifname: str = "lo",
                 ports: Optional[set] = None,
                 err_only: bool = False,
                 max_frames: int = 65536,
                 snaplen: int = 1 << 17,
                 dns_snoop: bool = False):
        # snaplen default covers full loopback/GSO frames WITH their
        # link header (14B ethernet + up to 64KiB IP > 65535): recv()
        # TRUNCATES to the buffer and a cut frame poisons the flow's
        # TCP reassembly (sequence gap) — whole-frame capture is the
        # correctness default; shrink only for err-only tiers that
        # parse headers alone
        self.ifname = ifname
        self.ports = set(ports) if ports else None
        self.err_only = err_only
        self.max_frames = max_frames
        self.snaplen = snaplen
        self.dns_snoop = dns_snoop    # harvest port-53 responses too
        self.n_dropped = 0            # ring overflow (counted, not silent)
        self.n_frames = 0
        self._frames: list[tuple[int, bytes]] = []
        self._dns: list[tuple[str, str]] = []
        # cross-drain continuity for boundary-spanning transactions
        self._carry: list[tuple[int, bytes]] = []
        self._emitted: dict = {}      # flow key -> txns already emitted
        self._pending_age: dict = {}  # flow key -> drains w/o progress
        self._sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                                   socket.htons(ETH_P_ALL))
        self._sock.bind((ifname, 0))
        self._sock.setblocking(False)
        try:
            # polled on sweep cadence (seconds apart): a deep kernel
            # buffer absorbs the between-poll burst
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_RCVBUF, 8 << 20)
        except OSError:
            pass

    # ------------------------------------------------------------ intake
    def _want(self, frame: bytes) -> bool:
        if self.ports is None:
            return True
        l3 = PF._l3_offset(PF._LINK_ETH, frame)
        if l3 is None or len(frame) < l3 + 20:
            return False
        ver = frame[l3] >> 4
        if ver == 4:
            ihl = (frame[l3] & 0xF) * 4
            if frame[l3 + 9] != 6 or len(frame) < l3 + ihl + 4:
                return False
            tcp = l3 + ihl
        elif ver == 6:
            if frame[l3 + 6] != 6 or len(frame) < l3 + 44:
                return False
            tcp = l3 + 40
        else:
            return False
        sport, dport = struct.unpack_from("!HH", frame, tcp)
        return sport in self.ports or dport in self.ports

    def poll(self, max_pkts: int = 8192) -> int:
        """Drain the socket's pending frames into the ring. Returns
        frames buffered this call. Non-blocking; call on cadence."""
        got = 0
        for _ in range(max_pkts):
            try:
                frame = self._sock.recv(self.snaplen)
            except BlockingIOError:
                break
            except OSError:
                break
            if not frame:
                continue
            if self.dns_snoop:
                from gyeeta_tpu_torch.trace import dnssnoop
                l3 = PF._l3_offset(PF._LINK_ETH, frame)
                if l3 is not None:
                    payload = dnssnoop.udp_dns_payload(frame, l3)
                    if payload is not None:
                        self._dns.extend(dnssnoop.parse_response(payload))
                        continue
            if not self._want(frame):
                continue
            if len(self._frames) >= self.max_frames:
                self.n_dropped += 1      # bounded ring: count overflow
                continue
            self._frames.append((time.time_ns() // 1000, frame))
            got += 1
        self.n_frames += got
        return got

    # ------------------------------------------------------------- drain
    @staticmethod
    def _flow_key(frame: bytes):
        """Frame → normalized flow key (parse_pcap's key), or None."""
        l3 = PF._l3_offset(PF._LINK_ETH, frame)
        if l3 is None:
            return None
        parsed = PF._parse_ip_tcp(frame[l3:])
        if parsed is None:
            return None
        src, sport, dst, dport = parsed[:4]
        a, b = (src, sport), (dst, dport)
        return (a, b) if a <= b else (b, a)

    # retained pending flows age out after this many drains without a
    # completed transaction (half-open conns must not pin frames)
    _PENDING_MAX_DRAINS = 8
    _PENDING_MAX_FRAMES = 4096

    def drain(self, record_path: Optional[str] = None):
        """Parse buffered frames → [FlowConversation] with NEW
        transactions only. Flows whose parser still holds an
        unanswered request keep their frames across drains, so a
        transaction spanning a capture window (the slow ones — exactly
        the interesting tail) completes in a later drain instead of
        splitting. ``err_only`` filters transactions to errors;
        ``record_path`` appends the NEW frames as replayable pcap."""
        new_frames, self._frames = self._frames, []
        if record_path and new_frames:
            buf_new = PF.write_pcap(new_frames)
            with open(record_path, "ab") as f:
                # one global header per file: append records only when
                # the file already exists with content
                f.write(buf_new if f.tell() == 0 else buf_new[24:])
        frames = sorted(self._carry + new_frames)
        self._carry = []
        if not frames:
            return []
        flows = PF.parse_pcap(PF.write_pcap(frames),
                              include_pending=True)
        by_key: dict = {}
        for tus, fr in frames:
            k = self._flow_key(fr)
            if k is not None:
                by_key.setdefault(k, []).append((tus, fr))
        out = []
        seen_keys = set()
        for f in flows:
            a, b = f.cli, f.ser
            k = (a, b) if a <= b else (b, a)
            seen_keys.add(k)
            done_before = self._emitted.get(k, 0)
            new_txns = f.transactions[done_before:]
            if f.pending:
                age = self._pending_age.get(k, 0) + (0 if new_txns
                                                     else 1)
                kept = by_key.get(k, [])[-self._PENDING_MAX_FRAMES:]
                if age <= self._PENDING_MAX_DRAINS:
                    self._carry.extend(kept)
                    self._emitted[k] = len(f.transactions)
                    self._pending_age[k] = age
                else:                      # stale half-open flow
                    self._emitted.pop(k, None)
                    self._pending_age.pop(k, None)
            else:
                self._emitted.pop(k, None)
                self._pending_age.pop(k, None)
            if new_txns:
                f = f._replace(transactions=list(new_txns))
                out.append(f)
        # bookkeeping for keys that produced no flow this round
        for k in list(self._emitted):
            if k not in seen_keys:
                self._emitted.pop(k, None)
                self._pending_age.pop(k, None)
        flows = out
        if self.err_only:
            for f in flows:
                f.transactions[:] = [t for t in f.transactions
                                     if t.is_error]
            flows = [f for f in flows if f.transactions]
        return flows

    def drain_dns(self) -> list:
        """Snooped (domain, ip) pairs since the last drain — prime a
        :class:`~gyeeta_tpu_torch.utils.dnsmap.DnsCache` with them."""
        out, self._dns = self._dns, []
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
