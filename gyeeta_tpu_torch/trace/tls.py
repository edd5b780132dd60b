"""TLS record / ClientHello parse — SNI + ALPN extraction.

The analogue of the reference's ``common/gy_tls_proto.h``: TLS traffic
can't be transaction-parsed without the SSL-capture path, but the
*handshake* is cleartext and carries two things the product uses:

- **SNI** (server_name extension): which domain the client thinks it is
  talking to — feeds the service-domain annotation the reference gets
  from ``LISTENER_DOMAIN_NOTIFY`` (``common/gy_comm_proto.h:2724``);
- **ALPN**: the application protocol (``h2``, ``http/1.1``) — feeds
  protocol detection for when decrypted payload becomes available.

``TlsParser`` fits the same feed/drain shape as the other parsers but
emits :class:`TlsInfo` (not transactions): encrypted conns surface as
connection metadata, not API calls.

Counterpart of ``gyeeta_tpu/trace/tls.py`` (pure Python).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

REC_HANDSHAKE = 0x16
HS_CLIENT_HELLO = 0x01
EXT_SNI = 0
EXT_ALPN = 16


class TlsInfo(NamedTuple):
    sni: str          # server_name, "" if absent
    alpn: str         # first ALPN protocol offered, "" if absent
    version: int      # legacy_version from the hello (0x0303 = TLS1.2+)


def parse_client_hello(data: bytes) -> Optional[TlsInfo]:
    """Parse a ClientHello from the start of a client byte stream.

    Tolerates the hello spanning multiple TLS records (reassembles
    handshake bytes across records) and truncated input (returns None —
    callers retry with more bytes).
    """
    # 1. concatenate handshake-record payloads
    hs = bytearray()
    i = 0
    while i + 5 <= len(data) and data[i] == REC_HANDSHAKE:
        rlen = struct.unpack_from(">H", data, i + 3)[0]
        hs += data[i + 5: i + 5 + rlen]
        i += 5 + rlen
        if len(hs) >= 4:
            need = 4 + int.from_bytes(hs[1:4], "big")
            if len(hs) >= need:
                break
    if len(hs) < 4 or hs[0] != HS_CLIENT_HELLO:
        return None
    body_len = int.from_bytes(hs[1:4], "big")
    if len(hs) < 4 + body_len:
        return None
    b = bytes(hs[4: 4 + body_len])
    # 2. fixed fields: version(2) random(32) session_id ciphers compression
    if len(b) < 35:
        return None
    version = struct.unpack_from(">H", b, 0)[0]
    p = 34
    sid_len = b[p]
    p += 1 + sid_len
    if p + 2 > len(b):
        return None
    cs_len = struct.unpack_from(">H", b, p)[0]
    p += 2 + cs_len
    if p + 1 > len(b):
        return None
    comp_len = b[p]
    p += 1 + comp_len
    sni = alpn = ""
    if p + 2 <= len(b):
        ext_total = struct.unpack_from(">H", b, p)[0]
        p += 2
        end = min(p + ext_total, len(b))
        while p + 4 <= end:
            etype, elen = struct.unpack_from(">HH", b, p)
            p += 4
            ebody = b[p: p + elen]
            p += elen
            if etype == EXT_SNI and len(ebody) >= 5:
                # list_len(2) type(1)=host_name name_len(2) name
                nlen = struct.unpack_from(">H", ebody, 3)[0]
                sni = ebody[5: 5 + nlen].decode("ascii", "replace")
            elif etype == EXT_ALPN and len(ebody) >= 3:
                # list_len(2) then (len(1) proto)*
                plen = ebody[2]
                alpn = ebody[3: 3 + plen].decode("ascii", "replace")
    return TlsInfo(sni=sni, alpn=alpn, version=version)


class TlsParser:
    """feed/drain-shaped wrapper: buffers client bytes until the
    ClientHello parses (or 16KB passes — then gives up)."""

    def __init__(self) -> None:
        self._buf = b""
        self._done = False
        self.info: Optional[TlsInfo] = None

    def feed_request(self, data: bytes, tusec: int) -> None:
        if self._done:
            return
        self._buf += data
        info = parse_client_hello(self._buf)
        if info is not None:
            self.info = info
            self._done = True
            self._buf = b""
        elif len(self._buf) > 16 * 1024:
            self._done = True
            self._buf = b""

    def feed_response(self, data: bytes, tusec: int) -> None:
        pass

    def drain(self) -> list:
        return []
