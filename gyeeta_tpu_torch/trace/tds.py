"""Sybase/TDS 5.0 wire parser: packets → tokens → transactions.

The reference's largest protocol parser (``common/gy_sybase_proto.cc``,
5299 LoC; token/type enums ``gy_sybase_proto.h:20-100``) covers Sybase
ASE's TDS 5.0 with full row-format tracking. This implementation keeps
the same OBSERVABLE behavior — request signatures (language SQL, RPC
names, dynamic statements), request/response pairing, latency, error
detection, byte counts — with a fraction of the machinery:

- **packet layer**: every TDS buffer is 8-byte-headed (type, status,
  length BE incl. header, spid, packet#, window); a logical message is
  packets up to EOM (status bit 0x01). Arbitrary chunk boundaries
  resume (same discipline as every parser here).
- **requests**: LANG batches (type 1) carry raw SQL; NORMAL buffers
  (type 15) carry LANGUAGE (0x21) / DBRPC (0xE6/0xE8) / DYNAMIC
  (0xE7/0x62) tokens; RPC buffers (type 3) carry the proc name.
  Signatures normalize through :func:`normalize_sql` like Postgres.
- **responses** (type 4): one logical message answers one request and
  ENDS with a final DONE/DONEPROC (9 bytes: token, status u16le,
  transtate u16le, count u32le) whose MORE bit (0x0001) is clear.
  Mid-stream row/format tokens need column-state to walk precisely;
  like the reference's resync scan (``gy_sybase_proto.cc:294,412``)
  errors are detected by validated EED (0xE5) / ERROR (0xAA) token
  scans plus the DONE error bit (0x0002) — the row payloads
  themselves are opaque to the tracer.

Counterpart of ``gyeeta_tpu/trace/tds.py`` (pure Python).
"""

from __future__ import annotations

from typing import NamedTuple

from gyeeta_tpu_torch.trace.proto import (PROTO_SYBASE, Transaction, _Req,
                                    normalize_sql)

# packet types (gy_sybase_proto.h:20)
TYPE_LANG = 1
TYPE_LOGIN = 2
TYPE_RPC = 3
TYPE_RESPONSE = 4
TYPE_ATTN = 6
TYPE_NORMAL = 15

# tokens (gy_sybase_proto.h:42)
TOK_LANGUAGE = 0x21
TOK_DBRPC = 0xE6
TOK_DBRPC2 = 0xE8
TOK_DYNAMIC = 0xE7
TOK_DYNAMIC2 = 0x62
TOK_EED = 0xE5
TOK_ERROR = 0xAA
TOK_DONE = 0xFD
TOK_DONEPROC = 0xFE
TOK_DONEINPROC = 0xFF

_EOM = 0x01                  # packet status: last packet of message
DONE_MORE = 0x0001
DONE_ERROR = 0x0002

_HDR = 8


class _Msg(NamedTuple):
    ptype: int
    body: bytes


def _le16(b: bytes, off: int) -> int:
    return b[off] | (b[off + 1] << 8)


def _le32(b: bytes, off: int) -> int:
    return (b[off] | (b[off + 1] << 8) | (b[off + 2] << 16)
            | (b[off + 3] << 24))


class _PacketAssembler:
    """8-byte-header packet stream → complete logical messages."""

    def __init__(self, max_msg: int = 1 << 20):
        self._buf = b""
        self._msg = b""
        self._msg_type = -1
        self._max_msg = max_msg

    def feed(self, data: bytes) -> list:
        out: list[_Msg] = []
        self._buf += data
        while len(self._buf) >= _HDR:
            ptype, status = self._buf[0], self._buf[1]
            ln = (self._buf[2] << 8) | self._buf[3]    # big-endian
            if not 1 <= ptype <= 17 or ln < _HDR:
                # implausible header: slide one byte and rescan (the
                # reference's parser resyncs the same way on framing
                # loss, gy_sybase_proto.cc:294)
                self._buf = self._buf[1:]
                self._msg = b""
                self._msg_type = -1
                continue
            if len(self._buf) < ln:
                break
            body = self._buf[_HDR:ln]
            self._buf = self._buf[ln:]
            if self._msg_type < 0:
                self._msg_type = ptype
            if len(self._msg) + len(body) <= self._max_msg:
                self._msg += body
            if status & _EOM:
                out.append(_Msg(self._msg_type, self._msg))
                self._msg = b""
                self._msg_type = -1
        return out


def _req_signature(ptype: int, body: bytes) -> str | None:
    """One request message → normalized API signature (None = not a
    client command: logins, attentions, cancels)."""
    if ptype == TYPE_LANG:
        return normalize_sql(body)
    if ptype == TYPE_RPC:
        if not body:
            return None
        nlen = body[0]
        name = body[1:1 + nlen].decode("latin1", "replace")
        return f"EXEC {name}" if name else None
    if ptype != TYPE_NORMAL:
        return None
    off = 0
    while off < len(body):
        tok = body[off]
        if tok == TOK_LANGUAGE:
            if off + 5 > len(body):
                return None
            ln = _le32(body, off + 1)
            # u32 length covers 1 status byte + text
            text = body[off + 6: off + 5 + ln]
            return normalize_sql(text)
        if tok in (TOK_DBRPC, TOK_DBRPC2):
            if off + 3 > len(body):
                return None
            ln = _le16(body, off + 1)
            seg = body[off + 3: off + 3 + ln]
            if not seg:
                return None
            nlen = seg[0]
            name = seg[1:1 + nlen].decode("latin1", "replace")
            return f"EXEC {name}" if name else None
        if tok in (TOK_DYNAMIC, TOK_DYNAMIC2):
            wide = tok == TOK_DYNAMIC2
            lsz = 4 if wide else 2
            if off + 1 + lsz > len(body):
                return None
            ln = _le32(body, off + 1) if wide else _le16(body, off + 1)
            seg = body[off + 1 + lsz: off + 1 + lsz + ln]
            if len(seg) < 3:
                return None
            idlen = seg[2]
            stmt = seg[3 + idlen:]
            if len(stmt) >= 2:            # prepare carries the text
                slen = _le16(stmt, 0)
                text = stmt[2:2 + slen]
                if text:
                    return normalize_sql(text)
            sid = seg[3:3 + idlen].decode("latin1", "replace")
            return f"DYNAMIC {sid}" if sid else None
        # non-command leading token (capabilities, options, params…):
        # skip the common length-prefixed shapes, else give up
        if tok in (0xE2, 0xE3, 0xA6, 0xEC, 0xEE):    # u16le length
            if off + 3 > len(body):
                return None
            off += 3 + _le16(body, off + 1)
            continue
        if tok in (0x63, 0x20, 0x61):                # u32le length
            if off + 5 > len(body):
                return None
            off += 5 + _le32(body, off + 1)
            continue
        return None
    return None


# response-stream tokens with a u16le length prefix the walk can skip
# (gy_sybase_proto.h token shapes): CAPABILITY, ENVCHANGE, INFO,
# PARAMFMT, ROWFMT, CONTROL, ORDERBY
_U16_TOKENS = frozenset((0xE2, 0xE3, 0xA6, 0xEC, 0xEE, 0xAE, 0xA9))
# u32le length: ROWFMT2/PARAMFMT2/ORDERBY2-class wide tokens
_U32_TOKENS = frozenset((0x63, 0x20, 0x61))
TOK_RETURNSTATUS = 0x79      # fixed: token + i32


def _scan_response(body: bytes) -> tuple:
    """→ (closed, is_error).

    STRUCTURED front walk: tokens are consumed by their declared
    shapes (DONE* 9 bytes, EED/ERROR/infra tokens length-prefixed)
    until the first unsized token (ROW/PARAMS data needs the column
    state of the 5299-LoC reference to size). Error evidence is
    accepted only from tokens reached structurally — ROW PAYLOAD
    BYTES ARE NEVER SCANNED, so 0xAA/0xE5 bytes inside result data
    cannot false-positive (the r4 heuristic scanned the whole body
    and could). Errors raised mid-rows still surface through the
    final DONE's error bit, which the server sets for errored
    commands (the tail anchor below)."""
    is_err = False
    off = 0
    n = len(body)
    while off < n:
        tok = body[off]
        if tok in (TOK_DONE, TOK_DONEPROC, TOK_DONEINPROC):
            if off + 9 > n:
                break
            if _le16(body, off + 1) & DONE_ERROR:
                is_err = True
            off += 9
            continue
        if tok in (TOK_EED, TOK_ERROR):
            if off + 3 > n:
                break
            ln = _le16(body, off + 1)
            if ln < 6:
                # a real EED/ERROR carries at least msgid+state+class;
                # shorter means the stream is not token-aligned here —
                # stop rather than fabricate a severity from the next
                # token's bytes
                break
            if tok == TOK_ERROR:
                is_err = True
            else:
                # EED: len, msgid u32, state u8, class(severity) u8
                sev = body[off + 8] if off + 9 <= n else 11
                if sev > 10:
                    is_err = True
            off += 3 + ln
            continue
        if tok == TOK_RETURNSTATUS:
            off += 5
            continue
        if tok in _U16_TOKENS:
            if off + 3 > n:
                break
            off += 3 + _le16(body, off + 1)
            continue
        if tok in _U32_TOKENS:
            if off + 5 > n:
                break
            off += 5 + _le32(body, off + 1)
            continue
        # unsized token (ROW 0xD1, PARAMS 0xD7, …): structure is lost
        # from here — stop; the tail DONE still closes the message
        break
    closed = False
    if n >= 9:
        tail_tok = body[n - 9]
        if tail_tok in (TOK_DONE, TOK_DONEPROC, TOK_DONEINPROC):
            status = _le16(body, n - 8)
            if not status & DONE_MORE:
                closed = True
            if status & DONE_ERROR:
                is_err = True
    return closed, is_err


class SybaseParser:
    """Incremental TDS 5.0 request/response pairing for one conn."""

    def __init__(self, max_queue: int = 64):
        self._req_asm = _PacketAssembler()
        self._resp_asm = _PacketAssembler()
        self._pending: list[_Req] = []
        self._max_queue = max_queue
        self._logged_in = False
        self._resp_bytes = 0
        self.transactions: list[Transaction] = []

    def feed_request(self, data: bytes, tusec: int) -> None:
        for msg in self._req_asm.feed(data):
            if msg.ptype == TYPE_LOGIN:
                self._logged_in = True
                continue
            api = _req_signature(msg.ptype, msg.body)
            if api and len(self._pending) < self._max_queue:
                self._pending.append(_Req(api, tusec,
                                          len(msg.body) + _HDR))

    def feed_response(self, data: bytes, tusec: int) -> None:
        self._resp_bytes += len(data)
        for msg in self._resp_asm.feed(data):
            if msg.ptype != TYPE_RESPONSE:
                continue
            closed, is_err = _scan_response(msg.body)
            if not closed:
                continue
            if not self._pending:
                self._resp_bytes = 0      # login ack / unsolicited
                continue
            req = self._pending.pop(0)
            self.transactions.append(Transaction(
                proto=PROTO_SYBASE, api=req.api,
                t_req_usec=req.tusec,
                resp_usec=max(0, tusec - req.tusec),
                status=1 if is_err else 0, is_error=is_err,
                bytes_in=req.nbytes, bytes_out=self._resp_bytes))
            self._resp_bytes = 0

    def drain(self) -> list[Transaction]:
        out, self.transactions = self.transactions, []
        return out
