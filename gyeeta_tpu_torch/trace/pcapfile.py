"""pcap-file ingestion: captured packets → protocol parsers → traces.

The reference carries a pcap engine (``common/gy_pcap_read.h`` /
``gy_pkt_pool``-fed parsers) so captured traffic can drive the same
protocol analysis as live capture. Userspace here can't sniff, but it
CAN ingest capture FILES: this module reads classic libpcap files
(the 24-byte global header, ``a1b2c3d4`` magics, Ethernet/Linux-SLL +
IPv4/IPv6 + TCP), reassembles each TCP flow's two directions in
sequence order, classifies the application protocol from the client's
first bytes, and replays the conversation through the SAME incremental
parsers live tracing uses (``PARSER_OF_PROTO``) — one
:class:`~gyeeta_tpu_torch.trace.proto.Transaction` list per service flow,
ready for ``transactions_to_records`` → ``Runtime.feed``.

Deliberately a TRACER, not a TCP stack: segments are ordered by
sequence number with duplicate-offset trimming (retransmits), no
window/SACK emulation — capture files of sane conversations are the
use case (the reference's parser-side reassembly makes the same
simplification, ``common/gy_proto_parser.h`` reassembly notes).

Counterpart of ``gyeeta_tpu/trace/pcapfile.py`` (pure Python): the
same files in and out, the same flows and transactions.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

from gyeeta_tpu_torch.trace import PARSER_OF_PROTO, detect_protocol

_MAGIC_USEC = 0xA1B2C3D4
_MAGIC_NSEC = 0xA1B23C4D

_LINK_ETH = 1
_LINK_SLL = 113
_LINK_RAW = 101


class PcapError(ValueError):
    pass


class _Seg(NamedTuple):
    seq: int
    tusec: int
    payload: bytes


def _read_global_header(buf: bytes):
    """→ (endian, nsec, linktype, offset)."""
    if len(buf) < 24:
        raise PcapError("truncated pcap global header")
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic in (_MAGIC_USEC, _MAGIC_NSEC):
        endian = "<"
    else:
        magic = struct.unpack_from(">I", buf, 0)[0]
        if magic not in (_MAGIC_USEC, _MAGIC_NSEC):
            raise PcapError("not a classic pcap file (bad magic)")
        endian = ">"
    nsec = magic == _MAGIC_NSEC
    linktype = struct.unpack_from(endian + "I", buf, 20)[0]
    return endian, nsec, linktype, 24


def _l3_offset(linktype: int, frame: bytes) -> Optional[int]:
    """Link header length (and VLAN skip) → IP header offset."""
    if linktype == _LINK_RAW:
        return 0
    if linktype == _LINK_ETH:
        if len(frame) < 14:
            return None
        etype = (frame[12] << 8) | frame[13]
        off = 14
        while etype in (0x8100, 0x88A8):       # VLAN tag(s)
            if len(frame) < off + 4:
                return None
            etype = (frame[off + 2] << 8) | frame[off + 3]
            off += 4
        return off if etype in (0x0800, 0x86DD) else None
    if linktype == _LINK_SLL:
        if len(frame) < 16:
            return None
        etype = (frame[14] << 8) | frame[15]
        return 16 if etype in (0x0800, 0x86DD) else None
    return None


def _parse_ip_tcp(pkt: bytes):
    """IP(v4/v6)+TCP headers → (src, sport, dst, dport, seq, flags,
    payload) or None for non-TCP/fragments."""
    if not pkt:
        return None
    ver = pkt[0] >> 4
    if ver == 4:
        if len(pkt) < 20:
            return None
        ihl = (pkt[0] & 0xF) * 4
        if ihl < 20 or len(pkt) < ihl:          # corrupt header length
            return None
        if pkt[9] != 6:                         # not TCP
            return None
        frag = struct.unpack_from(">H", pkt, 6)[0] & 0x1FFF
        if frag:
            return None                         # non-first fragment
        tot = struct.unpack_from(">H", pkt, 2)[0]
        src, dst = pkt[12:16], pkt[16:20]
        tcp = pkt[ihl:tot] if tot >= ihl else pkt[ihl:]
    elif ver == 6:
        if len(pkt) < 40 or pkt[6] != 6:        # next-header TCP only
            return None
        plen = struct.unpack_from(">H", pkt, 4)[0]
        src, dst = pkt[8:24], pkt[24:40]
        tcp = pkt[40:40 + plen]
    else:
        return None
    if len(tcp) < 20:
        return None
    sport, dport = struct.unpack_from(">HH", tcp, 0)
    seq = struct.unpack_from(">I", tcp, 4)[0]
    doff = (tcp[12] >> 4) * 4
    flags = tcp[13]
    return src, sport, dst, dport, seq, flags, tcp[doff:]


def _trimmed_segments(segs: list) -> list:
    """Sequence-ordered ``(tusec, chunk)`` stream with duplicate-range
    trimming (retransmits keep the first copy; capture gaps skip —
    the incremental parsers resync).

    WRAP-AWARE: the base is the first-CAPTURED segment's seq and every
    position is the 32-bit modular distance from it, so flows whose
    sequence space crosses 2^32 reassemble; anything farther than 2^30
    from base (pre-base retransmits, garbage) is dropped."""
    if not segs:
        return []
    # unwrap around the first-CAPTURED seq: signed 32-bit distance
    # handles both pre-reference reordering and a 2^32 wrap mid-flow
    ref = min(segs, key=lambda s: s.tusec).seq
    off = []
    for s in segs:
        d = (s.seq - ref) & 0xFFFFFFFF
        if d >= 1 << 31:
            d -= 1 << 32
        if abs(d) <= (1 << 30):
            off.append((d, s))
    if not off:
        return []
    base = min(d for d, _ in off)
    rel_segs = sorted(((d - base, s) for d, s in off),
                      key=lambda rs: rs[0])
    got = 0
    out = []
    for rel, s in rel_segs:
        chunk = s.payload[got - rel:] if rel < got else s.payload
        if chunk:
            out.append((s.tusec, chunk))
            got = max(got, rel + len(s.payload))
    return out


def _head(segs: list, want: int = 64) -> bytes:
    """First ``want`` stream bytes for protocol detection — accumulated
    across however many (possibly tiny) segments it takes."""
    out = b""
    for _, c in segs:
        out += c
        if len(out) >= want:
            break
    return out[:want]


def _monotonized(kind: str, segs: list) -> list:
    """[(eff_tusec, kind, chunk)] with per-direction non-decreasing
    timestamps (so a stable time-merge preserves sequence order)."""
    out = []
    t_eff = 0
    for t, c in segs:
        t_eff = max(t_eff, t)
        out.append((t_eff, kind, c))
    return out


class FlowConversation(NamedTuple):
    cli: tuple                # (addr_bytes, port)
    ser: tuple
    proto: int
    transactions: list
    pending: bool = False     # parser still holds an unanswered
    #                           request / partial buffers (the flow's
    #                           conversation spans past this capture)


def write_pcap(frames, nsec: bool = False, linktype: int = _LINK_ETH
               ) -> bytes:
    """(tusec, frame_bytes) iterable → classic little-endian pcap
    bytes (the capture round-trip, ref ``common/gy_pcap_write.cc:221``
    — here for recording live captures into replayable fixtures).
    ``parse_pcap(write_pcap(f))`` sees exactly the written frames."""
    magic = _MAGIC_NSEC if nsec else _MAGIC_USEC
    out = [struct.pack("<IHHiIII", magic, 2, 4, 0, 0, 262144, linktype)]
    mul = 1000 if nsec else 1
    for tusec, frame in frames:
        frac = (tusec % 1_000_000) * mul
        out.append(struct.pack("<IIII", tusec // 1_000_000, frac,
                               len(frame), len(frame)))
        out.append(frame)
    return b"".join(out)


def parse_pcap(buf: bytes, max_flows: int = 4096,
               include_pending: bool = False) -> list:
    """pcap bytes → [FlowConversation] (one per TCP flow with data).

    Direction: the SYN sender is the client; SYN-less flows (capture
    started mid-conversation) fall back to "lower endpoint dialed
    higher port" and protocol detection disambiguates.
    ``include_pending`` also returns transaction-less flows whose
    parser holds an unanswered request (live-capture windows retain
    their frames so boundary-spanning transactions complete later).
    """
    endian, nsec, linktype, off = _read_global_header(buf)
    div = 1000 if nsec else 1
    flows: dict = {}          # key(frozenset ends) -> {end: [segs]}
    syn_from: dict = {}
    n = len(buf)
    while off + 16 <= n:
        ts_s, ts_f, incl, _orig = struct.unpack_from(
            endian + "IIII", buf, off)
        off += 16
        if incl > n - off:
            break                               # truncated tail
        frame = buf[off: off + incl]
        off += incl
        l3 = _l3_offset(linktype, frame)
        if l3 is None:
            continue
        parsed = _parse_ip_tcp(frame[l3:])
        if parsed is None:
            continue
        src, sport, dst, dport, seq, flags, payload = parsed
        a, b = (src, sport), (dst, dport)
        key = (a, b) if a <= b else (b, a)
        st = flows.get(key)
        if st is None:
            if len(flows) >= max_flows:
                continue
            st = flows[key] = {a: [], b: []}
        if flags & 0x02 and not flags & 0x10:   # SYN (no ACK)
            syn_from[key] = a
        if payload:
            tusec = ts_s * 1_000_000 + ts_f // div
            st[a].append(_Seg(seq, tusec, payload))
    out = []
    for key, st in flows.items():
        ends = list(st)
        cli = syn_from.get(key)
        if cli is None:
            # mid-capture: guess by port (server = lower port), fixed
            # below by protocol detection if the guess is backwards
            cli = max(ends, key=lambda e: e[1])
        ser = ends[0] if ends[1] == cli else ends[1]
        req_segs = _trimmed_segments(st[cli])
        resp_segs = _trimmed_segments(st[ser])
        if not req_segs and not resp_segs:
            continue
        proto = detect_protocol(_head(req_segs))
        if proto == 0 and resp_segs:
            # the SYN-less direction guess may be backwards
            flipped = detect_protocol(_head(resp_segs))
            if flipped != 0:
                cli, ser = ser, cli
                req_segs, resp_segs = resp_segs, req_segs
                proto = flipped
        cls = PARSER_OF_PROTO.get(proto)
        if cls is None:
            continue
        parser = cls()
        # interleave the two directions by capture time, but NEVER let
        # the time merge undo per-direction sequence order: each
        # direction's timestamps are monotonized first (a reordered
        # network delivery keeps its seq position; sort is stable)
        events = sorted(_monotonized("req", req_segs)
                        + _monotonized("resp", resp_segs),
                        key=lambda e: e[0])
        for tusec, kind, chunk in events:
            if kind == "req":
                parser.feed_request(chunk, tusec)
            else:
                parser.feed_response(chunk, tusec)
        txns = parser.drain()
        pending = bool(getattr(parser, "_pending", ()))
        if txns or (include_pending and pending):
            out.append(FlowConversation(cli=cli, ser=ser, proto=proto,
                                        transactions=txns,
                                        pending=pending))
    return out
