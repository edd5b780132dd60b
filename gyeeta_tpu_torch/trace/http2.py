"""HTTP/2 (+gRPC) transaction parser with HPACK header decoding.

The analogue of the reference's ``common/gy_http2_proto.{h,cc}`` /
``gy_http2_proto_detail.h`` (frame walk + HPACK for method/path/status)
— rebuilt as an incremental per-connection state machine:

- frame layer: 9-byte header walk with partial-frame resume; HEADERS +
  CONTINUATION fragments accumulate until END_HEADERS;
- HPACK (RFC 7541): full instruction set — indexed, literal with/without
  /never indexing, dynamic-table size update — with a real dynamic table
  and canonical Huffman decoding (Appendix B code table);
- transaction layer: ``:method``/``:path`` open a stream's request,
  ``:status`` (plus ``grpc-status`` in trailers for gRPC) closes it;
  streams are concurrent (odd client stream ids), so pairing is by
  stream id, not FIFO.

gRPC rides on this parser for free: a gRPC call is an HTTP/2 POST whose
path *is* the API signature (``/pkg.Service/Method`` — no templating
needed) and whose error comes from ``grpc-status != 0``.

Counterpart of ``gyeeta_tpu/trace/http2.py`` (pure Python).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from gyeeta_tpu_torch.trace.proto import (
    PROTO_HTTP2, Transaction, normalize_http,
)

_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_RST_STREAM = 0x3
FRAME_CONTINUATION = 0x9
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# ------------------------------------------------------------------ HPACK
# RFC 7541 Appendix A static table (index 1..61): (name, value)
STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin",
    ""), ("age", ""), ("allow", ""), ("authorization", ""),
    ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""),
    ("content-length", ""), ("content-location", ""), ("content-range", ""),
    ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""),
    ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
)

# RFC 7541 Appendix B Huffman code table: (code, bit_length) per symbol
# 0..255 (EOS omitted — padding uses its prefix). Data, not logic.
_HUFF = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
)

_HUFF_DECODE = {(code, bits): sym for sym, (code, bits) in enumerate(_HUFF)}


def huffman_decode(data: bytes) -> bytes:
    """Canonical HPACK Huffman decode (bit-accumulator walk)."""
    out = bytearray()
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= 5:
            matched = False
            # codes are 5..30 bits; try shortest first
            for blen in range(5, min(nbits, 30) + 1):
                code = (acc >> (nbits - blen)) & ((1 << blen) - 1)
                sym = _HUFF_DECODE.get((code, blen))
                if sym is not None:
                    out.append(sym)
                    nbits -= blen
                    acc &= (1 << nbits) - 1
                    matched = True
                    break
            if not matched:
                break
    # trailing bits must be a prefix of EOS (all ones) — tolerated silently
    return bytes(out)


class HpackDecoder:
    """RFC 7541 decoder with a bounded dynamic table."""

    def __init__(self, max_size: int = 4096):
        self._dyn: list[tuple[str, str]] = []
        self._max = max_size

    def _entry(self, idx: int) -> tuple[str, str]:
        if 1 <= idx <= len(STATIC_TABLE):
            return STATIC_TABLE[idx - 1]
        d = idx - len(STATIC_TABLE) - 1
        if 0 <= d < len(self._dyn):
            return self._dyn[d]
        return ("", "")

    @staticmethod
    def _int(data: bytes, i: int, prefix: int) -> tuple[int, int]:
        mask = (1 << prefix) - 1
        v = data[i] & mask
        i += 1
        if v < mask:
            return v, i
        shift = 0
        while i < len(data):
            b = data[i]
            i += 1
            v += (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        return v, i

    def _str(self, data: bytes, i: int) -> tuple[str, int]:
        if i >= len(data):
            return "", len(data)
        huff = bool(data[i] & 0x80)
        ln, i = self._int(data, i, 7)
        raw = data[i: i + ln]
        i += ln
        if huff:
            raw = huffman_decode(raw)
        return raw.decode("utf-8", "replace"), i

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        out = []
        i = 0
        while i < len(block):
            b = block[i]
            if b & 0x80:                        # indexed
                idx, i = self._int(block, i, 7)
                out.append(self._entry(idx))
            elif b & 0x40:                      # literal, incremental index
                idx, i = self._int(block, i, 6)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, i = self._str(block, i)
                val, i = self._str(block, i)
                self._dyn.insert(0, (name, val))
                # size accounting: 32-byte overhead per RFC
                while sum(len(n) + len(v) + 32
                          for n, v in self._dyn) > self._max:
                    self._dyn.pop()
                out.append((name, val))
            elif b & 0x20:                      # dynamic table size update
                # clamp: the update rides untrusted captured bytes — a
                # huge value would disable eviction (memory DoS)
                v, i = self._int(block, i, 5)
                self._max = min(v, 65536)
                while sum(len(n) + len(v) + 32
                          for n, v in self._dyn) > self._max:
                    self._dyn.pop()
            else:                               # literal, no/never index
                idx, i = self._int(block, i, 4)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, i = self._str(block, i)
                val, i = self._str(block, i)
                out.append((name, val))
        return out


# ------------------------------------------------------------ transaction
class _Stream(NamedTuple):
    api: str
    tusec: int
    nbytes: int
    is_grpc: bool


class Http2Parser:
    """Per-connection HTTP/2 transaction pairing by stream id.

    ``feed_request`` consumes the client preface then client frames;
    ``feed_response`` consumes server frames. HEADERS(+CONTINUATION)
    blocks decode through per-direction HPACK contexts. A request opens
    at ``:method``/``:path``; a response closes at ``:status`` — except
    for gRPC, where HEADERS without END_STREAM is only the initial
    metadata and the trailers frame (END_STREAM) carries
    ``grpc-status``.
    """

    def __init__(self, max_streams: int = 256):
        self._req = _DirState()
        self._resp = _DirState()
        self._hp_req = HpackDecoder()
        self._hp_resp = HpackDecoder()
        self._open: dict[int, _Stream] = {}
        self._resp_status: dict[int, int] = {}
        self._max_streams = max_streams
        self._preface_seen = False
        self.transactions: list[Transaction] = []

    def feed_request(self, data: bytes, tusec: int) -> None:
        st = self._req
        st.buf += data
        if not self._preface_seen:
            if len(st.buf) < len(_PREFACE):
                if _PREFACE.startswith(st.buf):
                    return
            if st.buf.startswith(_PREFACE):
                st.buf = st.buf[len(_PREFACE):]
            self._preface_seen = True
        for ftype, flags, sid, payload in st.frames():
            self._on_req_frame(ftype, flags, sid, payload, tusec)

    def feed_response(self, data: bytes, tusec: int) -> None:
        st = self._resp
        st.buf += data
        for ftype, flags, sid, payload in st.frames():
            self._on_resp_frame(ftype, flags, sid, payload, tusec)

    # ------------------------------------------------------------- frames
    def _rst(self, sid: int) -> None:
        """RST_STREAM from either side cancels the stream: drop its
        pending state or _open fills with cancelled calls and the
        parser wedges at max_streams."""
        self._open.pop(sid, None)
        self._resp_status.pop(sid, None)

    def _on_req_frame(self, ftype, flags, sid, payload, tusec) -> None:
        if ftype == FRAME_RST_STREAM:
            return self._rst(sid)
        block = self._req.header_block(ftype, flags, sid, payload)
        if block is None:
            return
        sid, fragment, _end_stream = block
        hdrs = dict(self._hp_req.decode(fragment))
        method = hdrs.get(":method", "")
        path = hdrs.get(":path", "")
        if not method or not path:
            return
        is_grpc = hdrs.get("content-type", "").startswith(
            "application/grpc")
        # gRPC paths are exact API names; HTTP paths get templated
        api = (f"{method} {path}"[:128] if is_grpc
               else normalize_http(method.encode(), path.encode()))
        if len(self._open) < self._max_streams:
            self._open[sid] = _Stream(api, tusec, len(fragment), is_grpc)

    def _on_resp_frame(self, ftype, flags, sid, payload, tusec) -> None:
        if ftype == FRAME_RST_STREAM:
            return self._rst(sid)
        block = self._resp.header_block(ftype, flags, sid, payload)
        if block is None:
            return
        sid, fragment, end_stream = block
        hdrs = dict(self._hp_resp.decode(fragment))
        req = self._open.get(sid)
        if req is None:
            return
        status_s = hdrs.get(":status", "")
        status = int(status_s) if status_s.isdigit() else 0
        if req.is_grpc and not end_stream:
            # initial metadata; remember status, wait for trailers
            self._resp_status[sid] = status
            return
        if req.is_grpc:
            status = self._resp_status.pop(sid, status)
            g = hdrs.get("grpc-status", "0")
            is_err = g.isdigit() and int(g) != 0
        else:
            is_err = status >= 500
        self._open.pop(sid, None)
        self.transactions.append(Transaction(
            proto=PROTO_HTTP2, api=req.api, t_req_usec=req.tusec,
            resp_usec=max(0, tusec - req.tusec), status=status,
            is_error=is_err, bytes_in=req.nbytes,
            bytes_out=len(fragment)))

    def drain(self) -> list[Transaction]:
        out, self.transactions = self.transactions, []
        return out


class _DirState:
    """One direction's frame walk + HEADERS/CONTINUATION accumulation."""

    def __init__(self) -> None:
        self.buf = b""
        self._frag_sid: Optional[int] = None
        self._frag = b""
        self._frag_end_stream = False

    def frames(self):
        while len(self.buf) >= 9:
            flen = int.from_bytes(self.buf[:3], "big")
            if flen > 1 << 24:
                self.buf = b""
                return
            if len(self.buf) < 9 + flen:
                return
            ftype = self.buf[3]
            flags = self.buf[4]
            sid = int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF
            payload = self.buf[9: 9 + flen]
            self.buf = self.buf[9 + flen:]
            yield ftype, flags, sid, payload

    def header_block(self, ftype, flags, sid, payload):
        """Accumulate HEADERS(+CONTINUATION); return
        (sid, full_fragment, end_stream) at END_HEADERS, else None."""
        if ftype == FRAME_HEADERS:
            if flags & FLAG_PADDED and payload:
                pad = payload[0]
                payload = payload[1: len(payload) - pad]
            if flags & FLAG_PRIORITY:
                payload = payload[5:]
            self._frag_sid = sid
            self._frag = payload
            self._frag_end_stream = bool(flags & 0x1)
        elif ftype == FRAME_CONTINUATION and sid == self._frag_sid:
            self._frag += payload
        else:
            return None
        if flags & FLAG_END_HEADERS:
            out = (self._frag_sid, self._frag, self._frag_end_stream)
            self._frag_sid = None
            self._frag = b""
            return out
        return None
