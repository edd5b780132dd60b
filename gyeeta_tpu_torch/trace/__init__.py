"""Request tracing: protocol parsers + per-API device aggregation.

The reference's request-trace pipeline (``API_PARSE_HDLR``,
``common/gy_proto_parser.h:674``) captures request/response byte streams
in the agent, detects the application protocol, reassembles transactions
(request → response pairing), normalizes the request into an *API
signature* (HTTP route template / SQL shape), and ships
``REQ_TRACE_TRAN`` records upstream (``common/gy_comm_proto.h:3288``)
where per-service API aggregates are maintained.

Here the same split: parsing is host/agent-side byte work
(HTTP/1 + Postgres in ``trace/proto.py``, MongoDB in ``trace/mongo.py``,
HTTP/2+gRPC with full HPACK in ``trace/http2.py``, TLS ClientHello
SNI/ALPN in ``trace/tls.py``, plus the protocol detector), API
signatures travel as interned 64-bit ids (NAME_INTERN announcements),
and the aggregation is a device slab keyed by (service, api) folding
whole trace batches: windowed counters + per-API response-time loghist
(north-star config #5: per-API latency sketches across the fleet).

Counterpart of ``gyeeta_tpu/trace/__init__.py``: the same re-exports and
``PARSER_OF_PROTO`` registry. Every module of this package is pure
Python and numpy at module level (the agent's import chain loads no
``torch``); the device half is ``engine/step.ingest_trace`` and
``engine/aggstate``'s API table.
"""

from gyeeta_tpu_torch.trace.proto import (  # noqa: F401
    PROTO_UNKNOWN, PROTO_HTTP1, PROTO_POSTGRES, PROTO_MONGO,
    PROTO_HTTP2, PROTO_TLS, PROTO_SYBASE, PROTO_NAMES,
    HttpParser, PostgresParser, detect_protocol, normalize_http,
    normalize_sql, Transaction, transactions_to_records,
)
from gyeeta_tpu_torch.trace.tds import SybaseParser  # noqa: F401
from gyeeta_tpu_torch.trace.http2 import (  # noqa: F401
    HpackDecoder, Http2Parser, huffman_decode,
)
from gyeeta_tpu_torch.trace.mongo import MongoParser, bson_elements  # noqa: F401
from gyeeta_tpu_torch.trace.tls import (  # noqa: F401
    TlsInfo, TlsParser, parse_client_hello,
)

PARSER_OF_PROTO = {
    PROTO_HTTP1: HttpParser,
    PROTO_POSTGRES: PostgresParser,
    PROTO_MONGO: MongoParser,
    PROTO_HTTP2: Http2Parser,
    PROTO_TLS: TlsParser,
    PROTO_SYBASE: SybaseParser,
}

# AFTER the registry: pcapfile consumes PARSER_OF_PROTO at import
from gyeeta_tpu_torch.trace.pcapfile import (  # noqa: E402,F401
    FlowConversation, PcapError, parse_pcap,
)
