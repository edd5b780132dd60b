"""MongoDB wire-protocol transaction parser.

The Mongo analogue of the reference's ``common/gy_mongo_proto.{h,cc}``
(OP_MSG and legacy OP_QUERY parse, request/response pairing, error
detection from the reply document) — rebuilt as an incremental state
machine over the two directed byte streams of one connection.

API signature is ``<command> <collection>`` (e.g. ``find orders``,
``insert users``) extracted from the first element of the command
document: Mongo commands put the command name first and the collection
name as its value, with ``$db`` later in the doc — a shape-stable
signature without any BSON deep-walk. Responses pair by ``responseTo``
matching the request's ``requestID`` (Mongo multiplexes on one conn);
``ok: 0.0`` in the reply document marks an error transaction.

Counterpart of ``gyeeta_tpu/trace/mongo.py`` (pure Python).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

from gyeeta_tpu_torch.trace.proto import PROTO_MONGO, Transaction

OP_REPLY = 1
OP_QUERY = 2004
OP_MSG = 2013
OP_COMPRESSED = 2012

# commands that should never appear as an API signature (conn chatter)
_ADMIN_CMDS = frozenset((
    "ismaster", "isMaster", "hello", "ping", "buildInfo", "buildinfo",
    "saslStart", "saslContinue", "getnonce", "authenticate",
))


class _Pending(NamedTuple):
    api: str
    tusec: int
    nbytes: int


def bson_first_element(doc: bytes) -> tuple[Optional[str], Optional[object]]:
    """(name, value) of the first element of a BSON document.

    value is decoded for string/double/int32/int64/bool, else None.
    Malformed docs return (None, None) — parsers must survive captures
    that start mid-stream.
    """
    els = bson_elements(doc, limit=1)
    return els[0] if els else (None, None)


def bson_elements(doc: bytes, limit: int = 32) -> list:
    """Shallow-walk up to ``limit`` top-level elements of a BSON doc."""
    out = []
    if len(doc) < 5:
        return out
    total = struct.unpack_from("<i", doc, 0)[0]
    if total < 5 or total > len(doc):
        total = len(doc)
    i = 4
    while i < total - 1 and len(out) < limit:
        typ = doc[i]
        i += 1
        if typ == 0:
            break
        j = doc.find(b"\x00", i)
        if j < 0:
            break
        name = doc[i:j].decode("utf-8", "replace")
        i = j + 1
        val: Optional[object] = None
        if typ == 0x01:                         # double
            if i + 8 > total:
                break
            val = struct.unpack_from("<d", doc, i)[0]
            i += 8
        elif typ == 0x02:                       # string
            if i + 4 > total:
                break
            slen = struct.unpack_from("<i", doc, i)[0]
            if slen < 1 or i + 4 + slen > total:
                break
            val = doc[i + 4: i + 4 + slen - 1].decode("utf-8", "replace")
            i += 4 + slen
        elif typ in (0x03, 0x04):               # embedded doc / array
            if i + 4 > total:
                break
            dlen = struct.unpack_from("<i", doc, i)[0]
            if dlen < 5 or i + dlen > total:
                break
            i += dlen
        elif typ == 0x05:                       # binary
            if i + 5 > total:
                break
            blen = struct.unpack_from("<i", doc, i)[0]
            i += 4 + 1 + max(blen, 0)
        elif typ == 0x07:                       # ObjectId
            i += 12
        elif typ == 0x08:                       # bool
            if i >= total:
                break
            val = bool(doc[i])
            i += 1
        elif typ in (0x09, 0x11, 0x12):         # datetime/timestamp/int64
            if i + 8 > total:
                break
            val = struct.unpack_from("<q", doc, i)[0]
            i += 8
        elif typ == 0x0A:                       # null
            pass
        elif typ == 0x10:                       # int32
            if i + 4 > total:
                break
            val = struct.unpack_from("<i", doc, i)[0]
            i += 4
        elif typ == 0x13:                       # decimal128
            i += 16
        else:                                   # unknown type: stop walking
            break
        out.append((name, val))
        if i > total:
            break
    return out


def _api_from_command(doc: bytes) -> Optional[str]:
    name, val = bson_first_element(doc)
    if not name or name.startswith("$") or name in _ADMIN_CMDS:
        return None
    if isinstance(val, str) and val and len(val) <= 120:
        return f"{name} {val}"
    return name


class MongoParser:
    """Request/response pairing for one Mongo connection.

    ``feed_request`` / ``feed_response`` accept arbitrary chunk
    boundaries. Responses match requests via the header's ``responseTo``
    field; unmatched responses (server push, exhausted cursors) are
    dropped. OP_COMPRESSED payloads can't be inspected — the transaction
    still pairs and times, with api ``compressed``.
    """

    # never buffer more than this awaiting a frame's completion; larger
    # messages (bulk inserts, cursor batches) are length-skipped without
    # buffering — their command doc is in the first bytes anyway
    MAX_BUFFER = 1 << 20

    def __init__(self, max_queue: int = 64):
        self._req_buf = b""
        self._resp_buf = b""
        self._req_skip = 0          # bytes of an oversized frame to discard
        self._resp_skip = 0
        self._pending: dict[int, _Pending] = {}
        self._max_queue = max_queue
        self.transactions: list[Transaction] = []

    # ------------------------------------------------------------- frames
    def _walk(self, buf: bytes, skip: int, cb) -> tuple[bytes, int]:
        """Invoke ``cb(header, body)`` per complete frame; return the
        (unconsumed tail, remaining skip) for partial-frame resume. A
        nonsense length field means we joined mid-stream: drop the
        buffer and resync at the next capture gap. Frames larger than
        MAX_BUFFER are parsed from their first MAX_BUFFER bytes and the
        remainder is skipped without buffering."""
        if skip:
            take = min(skip, len(buf))
            buf = buf[take:]
            skip -= take
            if skip:
                return b"", skip
        i = 0
        while len(buf) - i >= 16:
            mlen, reqid, respto, op = struct.unpack_from("<iiii", buf, i)
            if mlen < 16 or mlen > 48_000_000:
                return b"", 0
            if mlen > self.MAX_BUFFER:
                if len(buf) - i < 16 + 4096:    # want the command head
                    break
                cb((mlen, reqid, respto, op), buf[i + 16: i + 16 + 4096])
                if len(buf) - i >= mlen:        # whole frame already here
                    i += mlen
                    continue
                return b"", mlen - (len(buf) - i)
            if len(buf) - i < mlen:
                break
            cb((mlen, reqid, respto, op), buf[i + 16: i + mlen])
            i += mlen
        return buf[i:], 0

    # --------------------------------------------------------------- feed
    def feed_request(self, data: bytes, tusec: int) -> None:
        def on_frame(hdr, body):
            mlen, reqid, _respto, op = hdr
            api: Optional[str] = None
            if op == OP_MSG and len(body) >= 5:
                # flagBits(4) then sections; kind-0 section = command doc
                k = 4
                if body[k] == 0:
                    api = _api_from_command(body[k + 1:])
            elif op == OP_QUERY and len(body) >= 9:
                # flags(4), fullCollectionName cstring, skip(4), ret(4), doc
                j = body.find(b"\x00", 4)
                if j > 0:
                    coll = body[4:j].decode("utf-8", "replace")
                    doc = body[j + 9:]
                    name, _ = bson_first_element(doc)
                    if coll.endswith(".$cmd"):
                        api = _api_from_command(doc)
                    elif name:
                        api = f"query {coll}"
            elif op == OP_COMPRESSED:
                api = "compressed"
            if api is not None:
                # bounded with oldest-first eviction: orphaned requests
                # (responses lost to capture gaps) must not wedge the
                # queue — insertion order IS request order
                while len(self._pending) >= self._max_queue:
                    self._pending.pop(next(iter(self._pending)))
                self._pending[reqid] = _Pending(api, tusec, mlen)

        self._req_buf, self._req_skip = self._walk(
            self._req_buf + data, self._req_skip, on_frame)

    def feed_response(self, data: bytes, tusec: int) -> None:
        def on_frame(hdr, body):
            mlen, _reqid, respto, op = hdr
            req = self._pending.pop(respto, None)
            if req is None:
                return
            is_err = False
            if op == OP_MSG and len(body) >= 5 and body[4] == 0:
                for name, val in bson_elements(body[5:], limit=16):
                    if name == "ok":
                        is_err = not bool(val)
                        break
            elif op == OP_REPLY and len(body) >= 4:
                flags = struct.unpack_from("<i", body, 0)[0]
                is_err = bool(flags & 0x2)      # QueryFailure
            self.transactions.append(Transaction(
                proto=PROTO_MONGO, api=req.api, t_req_usec=req.tusec,
                resp_usec=max(0, tusec - req.tusec),
                status=1 if is_err else 0, is_error=is_err,
                bytes_in=req.nbytes, bytes_out=mlen))

        self._resp_buf, self._resp_skip = self._walk(
            self._resp_buf + data, self._resp_skip, on_frame)

    def drain(self) -> list[Transaction]:
        out, self.transactions = self.transactions, []
        return out
