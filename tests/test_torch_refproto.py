"""The port's stock-partha adapter and NM query codecs against the
reference's.

``gyeeta_tpu_torch/ingest/refproto.py`` and ``refquery.py`` are the
port's own copies. Each ``decode_*`` (called directly and through
``adapt``, with the adapter session's state) gives the reference's
records, names and session state on the payloads the reference's
``tests/test_refproto.py`` and ``tests/test_refhandshake.py`` build and
on seeded random records of every adapted struct; the handshake codecs
(PS_REGISTER, PM_CONNECT, NM_CONNECT) and the NM query codecs (query
commands, chunked responses, the web-JSON and CRUD envelopes) give equal
bytes and parse each other's output; the port's ABI probe agrees with
the port's dtypes, which equal the reference's.
"""

import numpy as np
import pytest

from gyeeta_tpu.ingest import refproto as JRP, refquery as JRQ
from gyeeta_tpu_torch.ingest import refproto as TRP, refquery as TRQ
from gyeeta_tpu_torch.ingest.native import abiprobe as t_abi
from test_refhandshake import (_active_conn_record, _aggr_task_record,
                               _api_tran, _new_listener_record,
                               _taskmap_record, _top_procs_payload)
from test_refproto import (_conn_record, _listener_record, _ref_frame,
                           _task_ping_frame, _task_record)

# adapted subtype → its record struct (fixed part)
_STRUCT_OF = {
    "TCP_CONN": "REF_TCP_CONN_DT",
    "LISTENER_STATE": "REF_LISTENER_STATE_DT",
    "AGGR_TASK_STATE": "REF_AGGR_TASK_DT",
    "NEW_LISTENER": "REF_NEW_LISTENER_DT",
    "ACTIVE_CONN_STATS": "REF_ACTIVE_CONN_DT",
    "CPU_MEM_STATE": "REF_CPU_MEM_DT",
    "HOST_STATE": "REF_HOST_STATE_DT",
    "HOST_INFO": "REF_HOST_INFO_DT",
    "REQ_TRACE_TRAN": "REF_API_TRAN_DT",
    "PING_TASK_AGGR": "REF_PING_TASK_AGGR_DT",
    "LISTEN_TASKMAP": "REF_LISTEN_TASKMAP_DT",
    "NOTIFICATION_MSG": "REF_NOTIFICATION_MSG_DT",
    "LISTENER_DOMAIN": "REF_LISTENER_DOMAIN_DT",
    "NAT_TCP": "REF_NAT_TCP_DT",
    "HOST_CPU_MEM_CHANGE": "REF_CPU_MEM_CHANGE_DT",
    "TASK_AGGR": "REF_TASK_AGGR_DT",
    "PARTHA_STATUS": "REF_PARTHA_STATUS_DT",
}


def _sub(name):
    return getattr(JRP, f"REF_NOTIFY_{name}")


def _rand_payload(name, n, seed):
    """``n`` seeded random records of one struct, every length field
    zero (no trailing strings), so each record is self-consistent."""
    dt = getattr(JRP, _STRUCT_OF[name])
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8)
    recs = np.frombuffer(raw.tobytes(), dt, count=n).copy()
    for f in dt.names:
        if "len" in f or f in ("nlisten", "naggr_taskid"):
            recs[f] = 0
    return recs.tobytes()


# realistic payloads of the reference's tests: subtype name → frames
def _realistic():
    return {
        "TCP_CONN": _ref_frame(_sub("TCP_CONN"), 2, _conn_record(
            0x51, 8080, 4096, cmdline=b"/usr/bin/client --x")
            + _conn_record(0x52, 443, 100, accept=False)),
        "LISTENER_STATE": _ref_frame(_sub("LISTENER_STATE"), 2,
                                     _listener_record(0x51, 9, b"slow q")
                                     + _listener_record(0x52, 0)),
        "AGGR_TASK_STATE": _ref_frame(_sub("AGGR_TASK_STATE"), 2,
                                      _task_record(0xA1, b"java", 33.5,
                                                   b"cpu delay")
                                      + _task_record(0xA2, b"nginx", 1)),
        "NEW_LISTENER": _ref_frame(_sub("NEW_LISTENER"), 1,
                                   _new_listener_record(
                                       0x51, 8080, b"svc", b"svc -p 80")),
        "ACTIVE_CONN_STATS": _ref_frame(_sub("ACTIVE_CONN_STATS"), 2,
                                        _active_conn_record(0x51, 0xC1,
                                                            9000)
                                        + _active_conn_record(0x52, 0xC2,
                                                              10, 1)),
        "TASK_TOP_PROCS": _ref_frame(_sub("TASK_TOP_PROCS"), 1,
                                     _top_procs_payload()),
        "LISTEN_TASKMAP": _ref_frame(_sub("LISTEN_TASKMAP"), 1,
                                     _taskmap_record(0x51, [0x51],
                                                     [0xA1, 0xA2])),
        "TASK_AGGR": _ref_frame(_sub("AGGR_TASK_STATE"), 1,
                                _aggr_task_record(0xA1, b"java")),
        "REQ_TRACE_TRAN": _ref_frame(_sub("REQ_TRACE_TRAN"), 3,
                                     _api_tran(0x51, b"GET /u/123?x=1",
                                               900)
                                     + _api_tran(0x52, b"SELECT * FROM t "
                                                 b"WHERE id=42", 50,
                                                 proto=2)
                                     + _api_tran(0x51, b"POST /a", 7,
                                                 err=500)),
        "PING_TASK_AGGR": _task_ping_frame([0xA1, 0xA2, 0xA3]),
    }


def _adapt_both(buf, host_id=3, region="r1", zone="z1"):
    out = []
    for RP in (JRP, TRP):
        sess = RP.RefSession(region=region, zone=zone)
        try:
            gyt, k = RP.adapt(buf, host_id, session=sess)
            res = ("ok", gyt, k)
        except Exception as e:          # noqa: BLE001 — compared below
            res = ("err", type(e).__name__, str(e))
        state = (sorted(sess.rel_of_task.items()), sess.ncpus,
                 sess.notifications, sess.domains,
                 [r.tobytes() for r in sess.nat_conns],
                 sorted(sess.n_events.items()), sess.n_skipped,
                 sess.last_status_ok, sess.last_status_sec)
        out.append((res, state))
    return out


@pytest.mark.parametrize("name", sorted(_realistic()))
def test_adapt_realistic_payloads_match_reference(name):
    (jres, jst), (tres, tst) = _adapt_both(_realistic()[name])
    assert jres[0] == "ok" and (jres[1] or jst[0]), name
    assert tres == jres and tst == jst


def test_adapt_whole_stream_with_partial_tail():
    buf = b"".join(_realistic().values())
    for cut in (len(buf), len(buf) - 5, len(buf) - 100):
        (jres, jst), (tres, tst) = _adapt_both(buf[:cut])
        assert tres == jres and tst == jst, cut


@pytest.mark.parametrize("name", sorted(_STRUCT_OF))
def test_adapt_random_records_match_reference(name):
    for seed in range(3):
        n = 1 + seed * 3
        buf = _ref_frame(_sub(name), n, _rand_payload(name, n, seed))
        (jres, jst), (tres, tst) = _adapt_both(buf, host_id=seed)
        assert tres == jres and tst == jst, seed


def _direct(RP, name, payload, nevents, host_id=2):
    """One decoder called directly → (records bytes, names) or the
    session's state (frameless decoders)."""
    sub = _sub(name)
    if sub in RP._SESSION_DECODERS:
        sess = RP.RefSession()
        RP._SESSION_DECODERS[sub](payload, nevents, sess)
        return (sorted(sess.rel_of_task.items()), sess.notifications,
                sess.domains, [r.tobytes() for r in sess.nat_conns],
                sess.ncpus, sess.last_status_ok, sess.last_status_sec)
    fn, _, wants = RP._DECODER_OF[sub]
    recs, names = (fn(payload, nevents, host_id, session=RP.RefSession())
                   if wants else fn(payload, nevents, host_id))
    return recs.dtype.descr, recs.tobytes(), names


@pytest.mark.parametrize("name", sorted(_STRUCT_OF))
def test_each_decoder_matches_reference(name):
    """Each decode_* (through the decoder tables, so a subtype the
    adapter routes is the function under test) on random records."""
    assert (_sub(name) in JRP._DECODER_OF) or \
        (_sub(name) in JRP._SESSION_DECODERS)
    payload = _rand_payload(name, 4, 99)
    assert _direct(TRP, name, payload, 4) == \
        _direct(JRP, name, payload, 4)


def test_decoder_tables_match_reference():
    assert sorted(TRP._DECODER_OF) == sorted(JRP._DECODER_OF)
    assert sorted(TRP._SESSION_DECODERS) == sorted(JRP._SESSION_DECODERS)
    for sub, (fn, gyt, wants) in JRP._DECODER_OF.items():
        tfn, tgyt, twants = TRP._DECODER_OF[sub]
        assert (tfn.__name__, tgyt, twants) == (fn.__name__, gyt, wants)


def test_dtypes_match_reference():
    names = [n for n in dir(JRP) if n.endswith("_DT")] + \
        [f"RQ.{n}" for n in dir(JRQ) if n.endswith("_DT")]
    assert len(names) > 25
    for n in names:
        j = getattr(JRQ, n[3:]) if n.startswith("RQ.") else getattr(JRP, n)
        t = getattr(TRQ, n[3:]) if n.startswith("RQ.") else getattr(TRP, n)
        assert t == j, n


def test_adapt_bad_magic_raises_like_reference():
    buf = bytearray(_realistic()["TCP_CONN"])
    buf[0] ^= 0xFF
    (jres, _), (tres, _) = _adapt_both(bytes(buf))
    assert jres[0] == "err" and tres == jres


_HANDSHAKE = {
    "ps_register_req": lambda RP: RP.encode_ps_register_req(
        0x1234, 0x5678, hostname="h1", curr_sec=1_700_000_000),
    "pm_connect_cmd": lambda RP: RP.encode_pm_connect_cmd(
        0x1234, 0x5678, 0x99, 0x77, hostname="h1", curr_sec=17,
        region="eu", zone="eu-1a"),
    "ps_register_resp": lambda RP: RP.encode_ps_register_resp(
        0, "", "madhava.local", 10038, 0xABCDEF, 0x42, 1_700_000_001),
    "ps_register_resp_err": lambda RP: RP.encode_ps_register_resp(
        116, "max partha registrations", "m", 1, 0, 0x42, 5),
    "pm_connect_resp": lambda RP: RP.encode_pm_connect_resp(
        0, "", 0x42, 1_700_000_002),
}


@pytest.mark.parametrize("name", sorted(_HANDSHAKE))
def test_handshake_codecs_byte_equal(name):
    jb, tb = _HANDSHAKE[name](JRP), _HANDSHAKE[name](TRP)
    assert tb == jb
    hsz = JRP.REF_HEADER_DT.itemsize
    if name == "ps_register_req":
        assert TRP.parse_ps_register_req(tb[hsz:]) == \
            JRP.parse_ps_register_req(jb[hsz:])
    elif name == "pm_connect_cmd":
        assert TRP.parse_pm_connect_cmd(tb[hsz:]) == \
            JRP.parse_pm_connect_cmd(jb[hsz:])
    elif name.startswith("ps_register_resp"):
        assert TRP.parse_ps_register_resp(tb) == \
            JRP.parse_ps_register_resp(jb)
    else:
        assert TRP.parse_pm_connect_resp(tb) == \
            JRP.parse_pm_connect_resp(jb)


_NM = {
    "nm_connect_cmd": lambda RQ: RQ.encode_nm_connect_cmd("web-1"),
    "nm_connect_resp": lambda RQ: RQ.encode_nm_connect_resp(
        0, "", 0x42, 1_700_000_003),
    "query_cmd": lambda RQ: RQ.encode_query_cmd(
        7, RQ.QTYPE_OF_SUBSYS["svcstate"],
        {"qtype": RQ.QTYPE_OF_SUBSYS["svcstate"],
         "options": {"maxrecords": 5}}),
    "response_small": lambda RQ: RQ.encode_response_frames(
        9, {"nrecs": 1, "recs": [{"a": 1.5}]}),
    "response_chunked": lambda RQ: b"".join(RQ.iter_response_frames(
        11, {"recs": ["x" * 300] * 40}, chunk_bytes=1000)),
}


@pytest.mark.parametrize("name", sorted(_NM))
def test_nm_codecs_byte_equal_and_round_trip(name):
    jb, tb = _NM[name](JRQ), _NM[name](TRQ)
    assert tb == jb
    hsz = JRP.REF_HEADER_DT.itemsize
    if name == "nm_connect_cmd":
        assert TRQ.parse_nm_connect_cmd(tb[hsz:]) == \
            JRQ.parse_nm_connect_cmd(jb[hsz:])
    elif name == "nm_connect_resp":
        assert TRQ.parse_nm_connect_resp(tb) == \
            JRQ.parse_nm_connect_resp(jb)
    elif name == "query_cmd":
        pad = int(np.frombuffer(tb, JRP.REF_HEADER_DT, 1)[0]["padding_sz"])
        body = tb[hsz: len(tb) - pad]
        got = TRQ.parse_query_cmd(body)
        assert got == JRQ.parse_query_cmd(body)
        assert got[0] == 7
    else:
        # walk the frames: chunk by chunk the port parses what the
        # reference parses, and the body reassembles
        off, bodies = 0, []
        while off < len(tb):
            total = int(np.frombuffer(tb, JRP.REF_HEADER_DT, 1,
                                      off)[0]["total_sz"])
            body = tb[off + hsz: off + total]
            got = TRQ.parse_response_chunk(body)
            assert got == JRQ.parse_response_chunk(body)
            bodies.append(got[3])
            off += total
        assert len(bodies) > (name == "response_chunked")


@pytest.mark.parametrize("obj,alert", [
    ({"qtype": 0, "options": {"maxrecords": 3}}, None),
    ({"subsys": "hoststate", "filter": "{ hoststate.state = 'Bad' }"},
     None),
    ({"qtype": 999}, None),
    ({"op": "add", "objtype": "alertdef", "alertname": "a"}, True),
    ({"op": "add", "objtype": "tracedef", "name": "t"}, False),
    ({"op": "add", "objtype": "tracedef", "name": "t"}, True),
])
def test_envelope_translation_matches_reference(obj, alert):
    def run(RQ):
        try:
            return ("ok", RQ.web_json_to_query(dict(obj)) if alert is None
                    else RQ.crud_to_request(dict(obj), alert))
        except Exception as e:          # noqa: BLE001 — compared
            return ("err", type(e).__name__, str(e))
    assert run(TRQ) == run(JRQ)


def test_port_abiprobe_agrees_with_port_dtypes():
    layout = t_abi.run_probe()
    assert layout is not None, "g++ is needed for the ABI probe"
    assert t_abi.compare(layout) == []
    assert set(t_abi.probed_structs()) == set(layout)
