"""Passive DNS snooping: port-53 responses → IP→domain mappings.

The reference's DNS mapper captures DNS traffic and learns the domain
each IP was RESOLVED AS (``common/gy_dns_mapping.h:46``) — names a
reverse resolver can never see (CDN/anycast IPs answer PTR with
infrastructure names, or not at all). This module parses DNS response
messages (the UDP payload; works on frames from live AF_PACKET capture
or pcap files) and yields (domain, ip_text) pairs for the
:class:`~gyeeta_tpu_torch.utils.dnsmap.DnsCache` to prime.

Wire format: RFC 1035 — 12-byte header, QD section skipped, answer
records walked with name-compression handling; only A/AAAA answers
yield mappings (CNAME chains resolve through the final address
records, which carry the QUERY name context via the answer owner).

Counterpart of ``gyeeta_tpu/trace/dnssnoop.py`` (pure Python).
"""

from __future__ import annotations

import ipaddress
import struct

_MAX_NAME_JUMPS = 32


def _read_name(msg: bytes, off: int) -> tuple[str, int]:
    """Decode a (possibly compressed) domain name. → (name, next_off).
    next_off is the offset after the name AT THE ORIGINAL position
    (compression pointers don't advance the caller's cursor)."""
    labels = []
    jumps = 0
    end = None
    while True:
        if off >= len(msg):
            raise ValueError("truncated name")
        ln = msg[off]
        if ln == 0:
            if end is None:
                end = off + 1
            break
        if ln & 0xC0 == 0xC0:
            if off + 2 > len(msg):
                raise ValueError("truncated pointer")
            if end is None:
                end = off + 2
            ptr = struct.unpack_from("!H", msg, off)[0] & 0x3FFF
            jumps += 1
            if jumps > _MAX_NAME_JUMPS:
                raise ValueError("compression loop")
            off = ptr
            continue
        if ln & 0xC0:
            raise ValueError("bad label type")
        off += 1
        if off + ln > len(msg):
            raise ValueError("truncated label")
        labels.append(msg[off: off + ln])
        off += ln
    return b".".join(labels).decode("ascii", "replace").lower(), end


def parse_response(msg: bytes):
    """One DNS message → [(domain, ip_text)] from its A/AAAA answers.
    Non-responses and malformed messages yield []."""
    if len(msg) < 12:
        return []
    (_tid, flags, qd, an, _ns, _ar) = struct.unpack_from("!HHHHHH", msg)
    if not flags & 0x8000 or an == 0:        # queries carry no answers
        return []
    try:
        off = 12
        qname = ""
        for _ in range(qd):                  # skip the question section
            qname, off = _read_name(msg, off)
            off += 4                         # qtype + qclass
        out = []
        for _ in range(an):
            owner, off = _read_name(msg, off)
            if off + 10 > len(msg):
                break
            rtype, _rclass, _ttl, rdlen = struct.unpack_from(
                "!HHIH", msg, off)
            off += 10
            rdata = msg[off: off + rdlen]
            off += rdlen
            # CNAME answers re-point the owner; address records under a
            # CNAME chain still describe the QUERY name (what the
            # client asked for is the service identity)
            name = qname or owner
            if rtype == 1 and rdlen == 4:        # A
                out.append((name, str(ipaddress.IPv4Address(rdata))))
            elif rtype == 28 and rdlen == 16:    # AAAA
                out.append((name, str(ipaddress.IPv6Address(rdata))))
        return out
    except ValueError:
        return []


def udp_dns_payload(frame: bytes, l3: int):
    """Ethernet frame + L3 offset → the DNS message bytes when this is
    a UDP src-port-53 datagram, else None (the livecap fast filter)."""
    if len(frame) < l3 + 28:
        return None
    ver = frame[l3] >> 4
    if ver == 4:
        ihl = (frame[l3] & 0xF) * 4
        if frame[l3 + 9] != 17 or len(frame) < l3 + ihl + 8:
            return None
        udp = l3 + ihl
    elif ver == 6:
        if frame[l3 + 6] != 17 or len(frame) < l3 + 48:
            return None              # full v6 header + UDP header
        udp = l3 + 40
    else:
        return None
    sport = struct.unpack_from("!H", frame, udp)[0]
    if sport != 53:
        return None
    return frame[udp + 8:]
