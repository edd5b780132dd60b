"""Application-protocol transaction parsers (HTTP/1, Postgres) + detector.

The agent-side half of request tracing: raw captured byte streams in
both directions of a connection → :class:`Transaction` records (api
signature, latency, status, bytes). Mirrors what the reference's
``API_PARSE_HDLR`` does per connection (``common/gy_proto_parser.h``:
protocol detection from the first payload bytes, stream reassembly with
partial-buffer resume, request/response pairing; HTTP/1 parser
``common/gy_http_proto.cc``, Postgres parser ``common/gy_postgres_proto.h``)
— rewritten as small incremental state machines, not a port.

API signature normalization collapses per-call variability so traffic
aggregates by *shape*:

- HTTP: ``GET /users/1234/orders?x=1`` → ``GET /users/{}/orders``
  (numeric / UUID / hex / long segments templated, query string dropped);
- SQL: literals and numbers are replaced by placeholders, whitespace
  collapsed, identifier case preserved: ``SELECT * FROM t WHERE id=42``
  → ``SELECT * FROM t WHERE id=$``.

Signatures travel as interned 64-bit ids (``utils.hashing.hash_bytes_np``)
with a NAME_INTERN announcement, like every other string.

Counterpart of ``gyeeta_tpu/trace/proto.py``, both halves: the parsers
and the detector run in the port's agent (``net/agent.py`` through
``trace/livecap.py``) and in ``trace/pcapfile.py``; the normalizers also
serve the stock-partha adapter (``ingest/refproto.py``). Lengths and
timestamps stay Python ints: ``transactions_to_records`` clamps them
before they reach the uint32 record columns.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

PROTO_UNKNOWN = 0
PROTO_HTTP1 = 1
PROTO_POSTGRES = 2
PROTO_MONGO = 3
PROTO_HTTP2 = 4
PROTO_TLS = 5
PROTO_SYBASE = 6
PROTO_NAMES = ("unknown", "http1", "postgres", "mongo", "http2", "tls",
               "sybase")

_HTTP_METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ",
                 b"OPTIONS ", b"PATCH ", b"TRACE ", b"CONNECT ")
_H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
_MONGO_OPS = (2013, 2004, 2010, 2011, 1, 2001, 2002, 2005, 2006, 2007, 2012)


class Transaction(NamedTuple):
    """One parsed request/response exchange."""
    proto: int
    api: str              # normalized signature
    t_req_usec: int       # request first-byte time
    resp_usec: int        # response latency
    status: int           # HTTP status / 0 ok / 1 error for PG
    is_error: bool
    bytes_in: int         # request bytes
    bytes_out: int        # response bytes


def detect_protocol(first_bytes: bytes) -> int:
    """Classify a connection from its first client payload bytes (the
    reference sniffs the same way before attaching a parser,
    ``common/gy_proto_parser.h`` PROTO_DETECT; TLS record sniff
    ``common/gy_tls_proto.h``)."""
    if first_bytes.startswith(_H2_PREFACE[: max(4, len(first_bytes))]) and \
            len(first_bytes) >= 4:
        return PROTO_HTTP2
    if any(first_bytes.startswith(m) for m in _HTTP_METHODS):
        return PROTO_HTTP1
    if len(first_bytes) >= 5 and first_bytes[0] == 0x16 and \
            first_bytes[1] == 0x03 and first_bytes[2] <= 0x04:
        return PROTO_TLS
    if len(first_bytes) >= 8:
        # PG startup: int32 length, int32 protocol (196608 = 3.0) or
        # SSLRequest code 80877103
        ln = int.from_bytes(first_bytes[:4], "big")
        code = int.from_bytes(first_bytes[4:8], "big")
        if 8 <= ln <= 10000 and code in (196608, 80877103, 80877102):
            return PROTO_POSTGRES
    if len(first_bytes) >= 16:
        # Mongo header: msglen, requestID, responseTo, opcode — all LE
        ln = int.from_bytes(first_bytes[:4], "little")
        op = int.from_bytes(first_bytes[12:16], "little")
        if 16 <= ln <= 48_000_000 and op in _MONGO_OPS:
            return PROTO_MONGO
    if len(first_bytes) >= 8:
        # TDS: a conn opens with a LOGIN (0x02) buffer — 8-byte packet
        # header with a sane big-endian length (gy_sybase_proto.h:20)
        ptype, status = first_bytes[0], first_bytes[1]
        ln = (first_bytes[2] << 8) | first_bytes[3]
        if ptype == 0x02 and status in (0x00, 0x01) and 8 <= ln <= 4096:
            return PROTO_SYBASE
    return PROTO_UNKNOWN


# ----------------------------------------------------------- normalization
_NUMSEG = re.compile(
    rb"^(\d+|[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    rb"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}|[0-9a-fA-F]{16,})$")


def normalize_http(method: bytes, path: bytes, max_len: int = 128) -> str:
    """Route template: drop query string, template variable segments."""
    path = path.split(b"?", 1)[0].split(b"#", 1)[0]
    segs = path.split(b"/")
    out = []
    for s in segs:
        out.append(b"{}" if s and _NUMSEG.match(s) else s)
    norm = b"/".join(out) or b"/"
    sig = method.decode("latin1") + " " + norm.decode("latin1")
    return sig[:max_len]


_SQL_STR = re.compile(rb"'(?:[^']|'')*'")
_SQL_NUM = re.compile(rb"\b\d+(?:\.\d+)?\b")
_SQL_WS = re.compile(rb"\s+")


def normalize_sql(sql: bytes, max_len: int = 128) -> str:
    """SQL shape: literals → ``$``, numbers → ``$``, whitespace folded."""
    s = _SQL_STR.sub(b"$", sql)
    s = _SQL_NUM.sub(b"$", s)
    s = _SQL_WS.sub(b" ", s).strip()
    return s.decode("latin1", "replace")[:max_len]


# ------------------------------------------------------------------ HTTP/1
class _Req(NamedTuple):
    api: str
    tusec: int
    nbytes: int


class HttpParser:
    """Incremental HTTP/1.x request/response pairing for one connection.

    ``feed_request(data, tusec)`` / ``feed_response(data, tusec)`` accept
    arbitrary chunk boundaries (partial-buffer resume). Pipelined
    requests queue FIFO; each response head closes the oldest request
    (HTTP/1.1 ordering guarantee). Bodies are skipped by Content-Length;
    chunked bodies are scanned to the terminating 0-chunk.
    """

    def __init__(self, max_queue: int = 64):
        self._req_buf = b""
        self._resp_buf = b""
        self._pending: list[_Req] = []
        self._max_queue = max_queue
        self.transactions: list[Transaction] = []
        # body-skip state per direction: remaining bytes, or chunked flag
        self._req_skip = 0
        self._resp_skip = 0
        self._req_chunked = False
        self._resp_chunked = False

    # -------------------------------------------------------------- feed
    def feed_request(self, data: bytes, tusec: int) -> None:
        self._req_buf += data
        while True:
            if self._req_skip or self._req_chunked:
                if not self._skip_body("req"):
                    return
            head = self._take_head("req")
            if head is None:
                return
            line = head.split(b"\r\n", 1)[0]
            parts = line.split(b" ")
            if len(parts) >= 2 and (parts[0] + b" ") in _HTTP_METHODS:
                api = normalize_http(parts[0], parts[1])
                if len(self._pending) < self._max_queue:
                    self._pending.append(_Req(api, tusec, len(head)))
            self._arm_body_skip("req", head)

    def feed_response(self, data: bytes, tusec: int) -> None:
        self._resp_buf += data
        while True:
            if self._resp_skip or self._resp_chunked:
                if not self._skip_body("resp"):
                    return
            head = self._take_head("resp")
            if head is None:
                return
            line = head.split(b"\r\n", 1)[0]
            status = 0
            if line.startswith(b"HTTP/"):
                parts = line.split(b" ")
                if len(parts) >= 2 and parts[1].isdigit():
                    status = int(parts[1])
            if self._pending:
                req = self._pending.pop(0)
                self.transactions.append(Transaction(
                    proto=PROTO_HTTP1, api=req.api, t_req_usec=req.tusec,
                    resp_usec=max(0, tusec - req.tusec), status=status,
                    is_error=status >= 500, bytes_in=req.nbytes,
                    bytes_out=len(head)))
            self._arm_body_skip("resp", head)

    # ----------------------------------------------------------- plumbing
    def _buf(self, d):
        return self._req_buf if d == "req" else self._resp_buf

    def _setbuf(self, d, v):
        if d == "req":
            self._req_buf = v
        else:
            self._resp_buf = v

    def _take_head(self, d) -> Optional[bytes]:
        buf = self._buf(d)
        i = buf.find(b"\r\n\r\n")
        if i < 0:
            if len(buf) > 64 * 1024:      # runaway head: drop (resync)
                self._setbuf(d, b"")
            return None
        head, rest = buf[: i + 4], buf[i + 4:]
        self._setbuf(d, rest)
        return head

    def _arm_body_skip(self, d, head: bytes) -> None:
        h = head.lower()
        n = 0
        chunked = b"transfer-encoding: chunked" in h
        i = h.find(b"content-length:")
        if i >= 0:
            j = h.find(b"\r\n", i)
            try:
                n = int(h[i + 15: j].strip())
            except ValueError:
                n = 0
        if d == "req":
            self._req_skip, self._req_chunked = n, chunked
        else:
            self._resp_skip, self._resp_chunked = n, chunked

    def _skip_body(self, d) -> bool:
        """Consume body bytes; True once the body is fully skipped."""
        buf = self._buf(d)
        if d == "req":
            skip, chunked = self._req_skip, self._req_chunked
        else:
            skip, chunked = self._resp_skip, self._resp_chunked
        if not chunked:
            take = min(skip, len(buf))
            self._setbuf(d, buf[take:])
            skip -= take
            if d == "req":
                self._req_skip = skip
            else:
                self._resp_skip = skip
            return skip == 0
        # chunked: walk size lines until the 0 chunk
        while True:
            i = buf.find(b"\r\n")
            if i < 0:
                self._setbuf(d, buf)
                return False
            try:
                sz = int(buf[:i].split(b";")[0], 16)
            except ValueError:
                sz = 0
            need = i + 2 + sz + 2
            if len(buf) < need:
                self._setbuf(d, buf)
                return False
            buf = buf[need:]
            if sz == 0:
                self._setbuf(d, buf)
                if d == "req":
                    self._req_chunked = False
                else:
                    self._resp_chunked = False
                return True

    def drain(self) -> list[Transaction]:
        out, self.transactions = self.transactions, []
        return out


def transactions_to_records(txns, svc_glob_id: int, host_id: int):
    """Transactions → (REQ_TRACE record array, NAME_INTERN records).

    The agent-side encoding step: api signatures intern to 64-bit ids
    (announced once) and the fixed-width trace records carry only ids.
    """
    import numpy as np

    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.utils import hashing as H
    from gyeeta_tpu_torch.utils.intern import InternTable

    recs = np.zeros(len(txns), wire.REQ_TRACE_DT)
    names = {}
    for i, t in enumerate(txns):
        api_id = H.hash_bytes_np(t.api.encode())
        names[api_id] = t.api
        recs[i]["svc_glob_id"] = svc_glob_id
        recs[i]["api_id"] = api_id
        recs[i]["tusec"] = t.t_req_usec
        recs[i]["resp_usec"] = min(t.resp_usec, 0xFFFFFFFF)
        recs[i]["bytes_in"] = min(t.bytes_in, 0xFFFFFFFF)
        recs[i]["bytes_out"] = min(t.bytes_out, 0xFFFFFFFF)
        recs[i]["status"] = t.status
        recs[i]["proto"] = t.proto
        recs[i]["is_error"] = t.is_error
        recs[i]["host_id"] = host_id
    name_recs = InternTable.records(
        [(wire.NAME_KIND_API, nid, s) for nid, s in names.items()])
    return recs, name_recs


# ---------------------------------------------------------------- Postgres
class PostgresParser:
    """Postgres wire-protocol transaction pairing for one connection.

    Requests: simple queries (``Q``) and extended-protocol ``P``arse
    messages (the statement text rides in both). A transaction closes at
    ReadyForQuery (``Z``) on the server side; ``E`` marks it errored.
    The startup packet (no type byte) is consumed first.
    """

    def __init__(self, max_queue: int = 64):
        self._req_buf = b""
        self._resp_buf = b""
        self._started = False
        self._pending: list[_Req] = []
        self._max_queue = max_queue
        self._err = False
        self._resp_bytes = 0
        self.transactions: list[Transaction] = []

    def feed_request(self, data: bytes, tusec: int) -> None:
        self._req_buf += data
        if not self._started:
            if len(self._req_buf) < 4:
                return
            ln = int.from_bytes(self._req_buf[:4], "big")
            if len(self._req_buf) < ln:
                return
            self._req_buf = self._req_buf[ln:]
            self._started = True
        while len(self._req_buf) >= 5:
            typ = self._req_buf[0:1]
            ln = int.from_bytes(self._req_buf[1:5], "big")
            if len(self._req_buf) < 1 + ln:
                return
            body = self._req_buf[5: 1 + ln]
            self._req_buf = self._req_buf[1 + ln:]
            if typ == b"Q":
                sql = body.rstrip(b"\x00")
                self._queue(normalize_sql(sql), tusec, 1 + ln)
            elif typ == b"P":
                # Parse: statement name \0 query \0 ...
                parts = body.split(b"\x00", 2)
                if len(parts) >= 2:
                    self._queue(normalize_sql(parts[1]), tusec, 1 + ln)

    def _queue(self, api: str, tusec: int, nbytes: int) -> None:
        if len(self._pending) < self._max_queue:
            self._pending.append(_Req(api, tusec, nbytes))

    def feed_response(self, data: bytes, tusec: int) -> None:
        self._resp_buf += data
        while len(self._resp_buf) >= 5:
            typ = self._resp_buf[0:1]
            ln = int.from_bytes(self._resp_buf[1:5], "big")
            if len(self._resp_buf) < 1 + ln:
                return
            self._resp_buf = self._resp_buf[1 + ln:]
            self._resp_bytes += 1 + ln
            if typ == b"E":
                self._err = True
            elif typ == b"Z":
                if self._pending:
                    req = self._pending.pop(0)
                    self.transactions.append(Transaction(
                        proto=PROTO_POSTGRES, api=req.api,
                        t_req_usec=req.tusec,
                        resp_usec=max(0, tusec - req.tusec),
                        status=1 if self._err else 0,
                        is_error=self._err, bytes_in=req.nbytes,
                        bytes_out=self._resp_bytes))
                self._err = False
                self._resp_bytes = 0

    def drain(self) -> list[Transaction]:
        out, self.transactions = self.transactions, []
        return out
