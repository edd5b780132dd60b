"""Random and mutated bytes into both packages' parsers, side by side.

Hypothesis draws byte streams (the reference tests' conversations with
bytes flipped, inserted, deleted or cut, and plain random bytes) and
chunk boundaries, and feeds the same calls to the reference's and the
port's parsers: each call must give equal results, or both must raise
the same exception type with the same message. Covered: the six
protocol parsers (requests and responses interleaved in random chunks,
then ``drain``), ``detect_protocol``, ``HpackDecoder`` over a sequence
of header blocks (the dynamic table carried between them),
``huffman_decode``, ``bson_elements``, ``parse_client_hello``,
``dnssnoop.parse_response`` and ``udp_dns_payload``, and
``parse_pcap``. The draws are derandomized, so a run is reproducible.
"""

from __future__ import annotations

import struct

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gyeeta_tpu.trace as J
import gyeeta_tpu_torch.trace as T
from gyeeta_tpu.trace import dnssnoop as j_dns
from gyeeta_tpu.trace import http2 as j_h2
from gyeeta_tpu.trace import mongo as j_mongo
from gyeeta_tpu.trace import tls as j_tls
from gyeeta_tpu_torch.trace import dnssnoop as t_dns
from gyeeta_tpu_torch.trace import http2 as t_h2
from gyeeta_tpu_torch.trace import mongo as t_mongo
from gyeeta_tpu_torch.trace import tls as t_tls
from test_dnssnoop import _dns_response
from test_parsers2 import _bson_doc, _client_hello, _h2_frame, _lit, \
    _mongo_msg
from test_pcapfile import CLI, SER, _eth_ip_tcp, _pcap_header, _rec
from test_tds import done, eed, lang_token, pkt, resp
from test_torch_trace import same

FUZZ = settings(max_examples=60, deadline=None, database=None,
                derandomize=True,
                suppress_health_check=list(HealthCheck))


def _outcome(fn, *a):
    try:
        return fn(*a), None
    except Exception as e:              # noqa: BLE001 — compared below
        return None, e


def pair(jf, tf, *a):
    """Both calls, held equal → the reference's result (None if both
    raised)."""
    (r, re_), (p, pe) = _outcome(jf, *a), _outcome(tf, *a)
    if re_ is not None or pe is not None:
        assert (type(re_).__name__, str(re_)) == \
            (type(pe).__name__, str(pe)), (re_, pe)
        return None
    assert same(r, p), (r, p)
    return r


@st.composite
def mutated(draw, seed: bytes):
    b = bytearray(seed)
    for _ in range(draw(st.integers(0, 4))):
        op = draw(st.sampled_from(("flip", "insert", "delete", "cut")))
        if not b:
            op = "insert"
        i = draw(st.integers(0, max(len(b) - 1, 0)))
        if op == "flip":
            b[i] = draw(st.integers(0, 255))
        elif op == "insert":
            b[i:i] = draw(st.binary(min_size=1, max_size=8))
        elif op == "delete":
            del b[i:i + draw(st.integers(1, 8))]
        else:
            del b[i:]
    return bytes(b)


def streams(seed: bytes):
    return mutated(seed) | st.binary(max_size=256)


def _pg_msg(typ, body):
    return typ + struct.pack(">I", 4 + len(body)) + body


_H2_REQ = (j_h2._PREFACE
           + _h2_frame(j_h2.FRAME_HEADERS, j_h2.FLAG_END_HEADERS | 0x1, 1,
                       b"\x82" + _lit(b":path", b"/users/42/orders"))
           + _h2_frame(j_h2.FRAME_HEADERS, j_h2.FLAG_END_HEADERS, 3,
                       b"\x83" + _lit(b":path", b"/pkg.Svc/Do")
                       + _lit(b"content-type", b"application/grpc")))
_H2_RESP = (_h2_frame(j_h2.FRAME_HEADERS, j_h2.FLAG_END_HEADERS | 0x1, 1,
                      b"\x88")
            + _h2_frame(j_h2.FRAME_HEADERS, j_h2.FLAG_END_HEADERS, 3, b"\x88")
            + _h2_frame(j_h2.FRAME_HEADERS, j_h2.FLAG_END_HEADERS | 0x1, 3,
                        _lit(b"grpc-status", b"13")))
_MONGO_CMD = b"\x00\x00\x00\x00\x00"
# each parser's seed conversation: (request bytes, response bytes)
CONVERSATIONS = {
    "HttpParser": (
        b"GET /a/1 HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n"
        b"POST /b HTTP/1.1\r\nContent-Length: 3\r\n\r\nabc"
        b"PUT /c/9 HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"2\r\nab\r\n0\r\n\r\n",
        b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"
        b"HTTP/1.1 500 E\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"3\r\nerr\r\n0\r\n\r\n"
        b"HTTP/1.1 204 N\r\nContent-Length: 0\r\n\r\n"),
    "PostgresParser": (
        struct.pack(">II", 8, 196608)
        + _pg_msg(b"Q", b"select * from t where id = 42\x00")
        + _pg_msg(b"P", b"\x00select 1\x00\x00\x00")
        + _pg_msg(b"S", b""),
        _pg_msg(b"R", b"\x00" * 4) + _pg_msg(b"Z", b"I")
        + _pg_msg(b"C", b"SELECT 1\x00") + _pg_msg(b"Z", b"I")
        + _pg_msg(b"E", b"SERROR\x00\x00") + _pg_msg(b"Z", b"I")),
    "MongoParser": (
        _mongo_msg(11, 0, j_mongo.OP_MSG,
                   _MONGO_CMD + _bson_doc(("find", "orders"), ("limit", 5)))
        + _mongo_msg(12, 0, j_mongo.OP_MSG,
                     _MONGO_CMD + _bson_doc(("insert", "users"))),
        _mongo_msg(99, 11, j_mongo.OP_MSG, _MONGO_CMD + _bson_doc(("ok", 1.0)))
        + _mongo_msg(98, 12, j_mongo.OP_MSG,
                     _MONGO_CMD + _bson_doc(("ok", 0.0),
                                            ("errmsg", "dup")))),
    "Http2Parser": (_H2_REQ, _H2_RESP),
    "SybaseParser": (
        pkt(2, b"\x00" * 32) + pkt(1, b"select * from o where id = 42")
        + pkt(15, lang_token(b"update t set x = 'a' where k=7"))
        + pkt(3, bytes([7]) + b"sp_who2" + b"\x00\x00"),
        resp(done()) + resp(b"\xd1rowbytes" + done(0, 1))
        + resp(eed(14) + done(0x0002, 0)) + resp(done(0x0001, 5))
        + resp(done(0, 2))),
    "TlsParser": (_client_hello(b"api.example.com"), b""),
}


@st.composite
def conversations(draw, name):
    req, rsp = CONVERSATIONS[name]
    req, rsp = draw(streams(req)), draw(streams(rsp))
    sizes = draw(st.lists(st.integers(1, 48), min_size=1, max_size=12))
    events, i, j, k, t = [], 0, 0, 0, 1_000_000
    while i < len(req) or j < len(rsp):
        n = sizes[k % len(sizes)]
        k += 1
        t += draw(st.integers(0, 5000))
        take_req = j >= len(rsp) or (i < len(req) and draw(st.booleans()))
        if take_req:
            events.append(("feed_request", req[i:i + n], t))
            i += n
        else:
            events.append(("feed_response", rsp[j:j + n], t))
            j += n
    return events


def _parser_case(name, events):
    jp, tp = getattr(J, name)(), getattr(T, name)()
    for meth, chunk, t in events:
        pair(getattr(jp, meth), getattr(tp, meth), chunk, t)
        if name == "TlsParser":
            assert same(jp.info, tp.info)
        if len(events) % 3 == 0:
            pair(jp.drain, tp.drain)
    pair(jp.drain, tp.drain)


def _parser_test(name):
    @FUZZ
    @given(conversations(name))
    def test(events):
        _parser_case(name, events)
    test.__name__ = f"test_{name}_parity"
    return test


test_http1_parity = _parser_test("HttpParser")
test_postgres_parity = _parser_test("PostgresParser")
test_mongo_parity = _parser_test("MongoParser")
test_http2_parity = _parser_test("Http2Parser")
test_sybase_parity = _parser_test("SybaseParser")
test_tls_parity = _parser_test("TlsParser")


@FUZZ
@given(st.sampled_from([c[0] for c in CONVERSATIONS.values()]).flatmap(
    lambda s: streams(s[:64])))
def test_detect_protocol_parity(head):
    pair(J.detect_protocol, T.detect_protocol, head)


_HPACK_BLOCKS = (b"\x82" + b"\x40\x04path\x02/x", b"\xbe",
                 b"\x3f\xe1\x1f", b"\x88" + _lit(b"grpc-status", b"0"),
                 bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff"))


@FUZZ
@given(st.lists(st.sampled_from(_HPACK_BLOCKS).flatmap(streams),
                min_size=1, max_size=6),
       st.integers(0, 4096))
def test_hpack_decoder_parity(blocks, max_size):
    jd, td = j_h2.HpackDecoder(max_size), t_h2.HpackDecoder(max_size)
    for b in blocks:
        pair(jd.decode, td.decode, b)


@FUZZ
@given(streams(bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")))
def test_huffman_decode_parity(data):
    pair(j_h2.huffman_decode, t_h2.huffman_decode, data)


@FUZZ
@given(streams(_bson_doc(("find", "orders"), ("limit", 5), ("ok", 1.0),
                         ("x", "y"))),
       st.integers(0, 40))
def test_bson_elements_parity(doc, limit):
    pair(j_mongo.bson_elements, t_mongo.bson_elements, doc, limit)


@FUZZ
@given(streams(_client_hello(b"svc.internal", alpn=b"http/1.1")))
def test_parse_client_hello_parity(data):
    pair(j_tls.parse_client_hello, t_tls.parse_client_hello, data)


def _udp_frame(payload: bytes) -> bytes:
    udp = struct.pack(">HHHH", 53, 40000, 8 + len(payload), 0) + payload
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(udp), 1, 0, 64, 17,
                     0, SER, CLI)
    return b"\xaa" * 6 + b"\xbb" * 6 + b"\x08\x00" + ip + udp


_DNS = _dns_response("api.shop.example", ["203.0.113.9", "2001:db8::7"])


@FUZZ
@given(streams(_DNS))
def test_dns_parse_response_parity(msg):
    pair(j_dns.parse_response, t_dns.parse_response, msg)


@FUZZ
@given(streams(_udp_frame(_DNS)), st.integers(0, 20))
def test_udp_dns_payload_parity(frame, l3):
    pair(j_dns.udp_dns_payload, t_dns.udp_dns_payload, frame, l3)


def _pcap_seed() -> bytes:
    req, rsp = CONVERSATIONS["HttpParser"]
    preq, prsp = CONVERSATIONS["PostgresParser"]
    t = 1_700_000_000_000_000
    frames = [
        _rec(t, _eth_ip_tcp(CLI, 40000, SER, 80, 100, flags=0x02)),
        _rec(t + 10, _eth_ip_tcp(CLI, 40000, SER, 80, 101, req[:40])),
        _rec(t + 20, _eth_ip_tcp(CLI, 40000, SER, 80, 141, req[40:],
                                 vlan=True)),
        _rec(t + 90, _eth_ip_tcp(SER, 80, CLI, 40000, 500, rsp)),
        _rec(t + 95, _eth_ip_tcp(CLI, 40001, SER, 5432, 7, preq)),
        _rec(t + 99, _eth_ip_tcp(SER, 5432, CLI, 40001, 9, prsp)),
    ]
    return _pcap_header() + b"".join(frames)


@FUZZ
@given(streams(_pcap_seed()), st.booleans(), st.integers(1, 4096))
def test_parse_pcap_parity(buf, pending, max_flows):
    pair(J.parse_pcap, T.parse_pcap, buf, max_flows, pending)
