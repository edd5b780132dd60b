"""The port's protocol parsers against the reference's, call by call.

Each of the reference's parser tests (``tests/test_trace.py``,
``test_parsers2.py``, ``test_tds.py``, ``test_pcapfile.py``,
``test_dnssnoop.py`` and the parser cases of ``test_fuzz.py``) runs here
unchanged, with every parser class and parsing function it reaches
shadowed: each call goes to the reference and to the port's counterpart
with the same arguments (the same bytes, in the same chunks, at the same
times), and the two results must be equal, ``Transaction`` lists,
``FlowConversation``s, record arrays (byte for byte) and header lists
alike, or both calls must raise the same exception type with the same
message. The reference's result is what the test goes on with, so its
own assertions still hold it. Tests of the reference's that fold into a
JAX runtime are not run here (``test_torch_pcap.py`` folds pcap traces
into both packages' runtimes).

``transactions_to_records`` is held separately: byte-equal record and
name arrays, the uint32 clamps included.
"""

from __future__ import annotations

import importlib
import inspect

import numpy as np
import pytest

import gyeeta_tpu.trace as j_trace
from gyeeta_tpu.trace import proto as j_proto
from gyeeta_tpu_torch.trace import proto as t_proto

TRACE_MODS = ("", ".proto", ".tds", ".http2", ".mongo", ".tls",
              ".pcapfile", ".dnssnoop")
# stateful parsers (every method call shadowed) and pure functions
CLASSES = ("HttpParser", "PostgresParser", "MongoParser", "Http2Parser",
           "SybaseParser", "TlsParser", "HpackDecoder", "_PacketAssembler")
FUNCS = ("detect_protocol", "normalize_http", "normalize_sql",
         "huffman_decode", "bson_elements", "bson_first_element",
         "parse_client_hello", "parse_pcap", "write_pcap",
         "parse_response", "udp_dns_payload", "transactions_to_records",
         "_req_signature", "_scan_response")


def same(r, p) -> bool:
    """Equal results across packages: NamedTuples by type name and
    fields, arrays by dtype and bytes, containers element by element."""
    if isinstance(r, np.ndarray) or isinstance(p, np.ndarray):
        return (isinstance(r, np.ndarray) and isinstance(p, np.ndarray)
                and r.dtype == p.dtype and r.shape == p.shape
                and r.tobytes() == p.tobytes())
    if isinstance(r, (tuple, list)):
        return (type(r).__name__ == type(p).__name__ and len(r) == len(p)
                and all(same(a, b) for a, b in zip(r, p)))
    if isinstance(r, dict):
        return (isinstance(p, dict) and list(r) == list(p)
                and all(same(r[k], p[k]) for k in r))
    return type(r) is type(p) and r == p


class Calls:
    """Counts the shadowed calls a test made (each compared)."""
    n = 0


def _outcome(fn, args, kw):
    try:
        return fn(*args, **kw), None
    except Exception as e:              # noqa: BLE001 — compared below
        return None, e


def both(ref, port, args, kw, what):
    """Call the reference and the port alike; hold them equal."""
    r, re_ = _outcome(ref, args, kw)
    p, pe = _outcome(port, args, kw)
    Calls.n += 1
    if re_ is not None or pe is not None:
        assert (type(re_).__name__, str(re_)) == \
            (type(pe).__name__, str(pe)), f"{what}: {re_!r} vs {pe!r}"
        raise re_
    assert same(r, p), f"{what}: {r!r} != {p!r}"
    return r


class _ShadowObj:
    def __init__(self, ref, port, name):
        object.__setattr__(self, "_sh", (ref, port, name))

    def __getattr__(self, attr):
        ref, port, name = self._sh
        r, p = getattr(ref, attr), getattr(port, attr)
        if callable(r):
            return lambda *a, **k: both(r, p, a, k, f"{name}.{attr}")
        Calls.n += 1
        assert same(r, p), f"{name}.{attr}: {r!r} != {p!r}"
        return r


class _ShadowCls:
    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def __call__(self, *a, **k):
        return _ShadowObj(self.ref(*a, **k), self.port(*a, **k),
                          self.ref.__name__)


def _port_of(obj):
    mod = importlib.import_module(
        obj.__module__.replace("gyeeta_tpu.", "gyeeta_tpu_torch.", 1))
    return getattr(mod, obj.__name__)


@pytest.fixture
def shadowed(monkeypatch):
    """Shadow every parser and parsing function of the reference's
    trace modules, where the modules hold them and where a test module
    imported them by name."""
    made = {}

    def shadow(obj):
        if obj not in made:
            port = _port_of(obj)
            if inspect.isclass(obj):
                made[obj] = _ShadowCls(obj, port)
            else:
                made[obj] = (lambda r, p: lambda *a, **k: both(
                    r, p, a, k, r.__name__))(obj, port)
        return made[obj]

    mods = [importlib.import_module("gyeeta_tpu.trace" + m)
            for m in TRACE_MODS]
    for mod in mods:
        for name in CLASSES + FUNCS:
            obj = getattr(mod, name, None)
            if obj is not None:
                monkeypatch.setattr(mod, name, shadow(obj))
    monkeypatch.setattr(j_trace, "PARSER_OF_PROTO", {
        k: shadow(v) for k, v in j_trace.PARSER_OF_PROTO.items()})

    def patch_module(tmod):
        for name, obj in list(vars(tmod).items()):
            if name in CLASSES + FUNCS and getattr(
                    obj, "__module__", "").startswith("gyeeta_tpu.trace."):
                monkeypatch.setattr(tmod, name, shadow(obj))
    Calls.n = 0
    return patch_module


# the reference's parser tests (those that fold into a runtime excluded)
REF_TESTS = {
    "test_trace": ("test_detect_protocol", "test_normalize_http",
                   "test_normalize_sql", "test_http_single_transaction",
                   "test_http_pipelined_and_errors",
                   "test_http_partial_feeds_and_bodies",
                   "test_http_chunked_response_body",
                   "test_postgres_simple_query",
                   "test_postgres_error_and_extended"),
    "test_parsers2": ("test_bson_walk", "test_mongo_op_msg_roundtrip",
                      "test_mongo_error_and_partial_frames",
                      "test_mongo_admin_commands_skipped",
                      "test_mongo_legacy_op_query",
                      "test_huffman_decode_rfc_vector",
                      "test_hpack_static_and_dynamic",
                      "test_http2_transaction", "test_http2_grpc_trailers",
                      "test_http2_continuation_and_padding",
                      "test_tls_sni_alpn",
                      "test_tls_split_records_and_partial",
                      "test_parser_registry"),
    "test_tds": ("test_detect_login_packet", "test_lang_batch_roundtrip",
                 "test_language_token_in_normal_buffer",
                 "test_rpc_by_name", "test_dbrpc_token",
                 "test_error_via_eed_and_done_bit",
                 "test_multi_packet_reassembly_and_chunked_feed",
                 "test_more_bit_keeps_transaction_open",
                 "test_row_bytes_matching_error_tokens_do_not_false_positive",
                 "test_attention_and_garbage_resilience"),
    "test_pcapfile": ("test_http_conversation_parsed",
                      "test_retransmit_and_vlan_and_synless",
                      "test_postgres_conversation_parsed",
                      "test_bad_magic_and_truncation",
                      "test_write_pcap_roundtrip",
                      "test_true_network_reorder_and_seq_wrap",
                      "test_tiny_segment_protocol_detection"),
    "test_dnssnoop": ("test_parse_response_a_and_aaaa",
                      "test_parse_rejects_queries_and_garbage"),
}
CASES = [(m, t, None) for m, ts in REF_TESTS.items() for t in ts] + [
    ("test_fuzz", "test_fuzz_protocol_parsers_never_crash", cls)
    for cls in ("HttpParser", "SybaseParser", "PostgresParser",
                "MongoParser", "Http2Parser")]


@pytest.mark.parametrize(
    "modname,testname,param", CASES,
    ids=[f"{m}.{t}" + (f"[{p}]" if p else "") for m, t, p in CASES])
def test_reference_case_on_both(modname, testname, param, shadowed,
                                tmp_path):
    tmod = importlib.import_module(modname)
    shadowed(tmod)
    fn = getattr(tmod, testname)
    kw = {}
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    if "proto_cls" in params:
        kw["proto_cls"] = param
    fn(**kw)
    # the registry test only checks class identity (the shadows')
    assert Calls.n > 0 or testname == "test_parser_registry"


# ------------------------------------------------------------ the records
def _txns(rng, n, proto_cls):
    out = []
    for i in range(n):
        out.append(proto_cls(
            proto=int(rng.integers(0, 7)),
            api=f"GET /v{int(rng.integers(0, 4))}/items/{{}}",
            t_req_usec=1_700_000_000_000_000 + int(rng.integers(0, 10**9)),
            resp_usec=int(rng.integers(0, 2**33)),
            status=int(rng.integers(0, 600)),
            is_error=bool(rng.integers(0, 2)),
            bytes_in=int(rng.integers(0, 2**33)),
            bytes_out=int(rng.integers(0, 2**33))))
    return out


@pytest.mark.parametrize("n", [0, 1, 64])
def test_transactions_to_records_byte_equal(n):
    """Latencies and byte counts past 2^32 clamp alike; api ids are the
    port's ``hash_bytes_np``; the name records announce each api once."""
    rng = np.random.default_rng(n)
    txns = _txns(rng, n, j_proto.Transaction)
    jr, jn = j_proto.transactions_to_records(txns, svc_glob_id=0xABCDEF,
                                             host_id=7)
    tr, tn = t_proto.transactions_to_records(
        [t_proto.Transaction(*t) for t in txns], svc_glob_id=0xABCDEF,
        host_id=7)
    assert same(jr, tr) and same(jn, tn)
    if n:
        assert int(tr["resp_usec"].max()) <= 0xFFFFFFFF


def test_parser_registry_and_names():
    import gyeeta_tpu_torch.trace as t_trace
    assert {k: v.__name__ for k, v in t_trace.PARSER_OF_PROTO.items()} == \
        {k: v.__name__ for k, v in j_trace.PARSER_OF_PROTO.items()}
    assert t_trace.PROTO_NAMES == j_trace.PROTO_NAMES
    assert all(v.__module__.startswith("gyeeta_tpu_torch.trace.")
               for v in t_trace.PARSER_OF_PROTO.values())
