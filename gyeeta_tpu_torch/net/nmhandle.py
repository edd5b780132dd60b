"""NM conn edge: the node-webserver query channel on the GYT server.

Counterpart of ``gyeeta_tpu/net/nmhandle.py``.

The role of madhava's NM conn handling (``server/gy_mnodehandle.cc``:
handshake at :61, ``web_query_route_qtype`` at :203) on this server:
``GytServer`` routes a stock ``NM_CONNECT_CMD_S`` opener here
(magic-peeked, same as the partha handshakes); the handshake is
version-gated and answers ``NM_CONNECT_RESP_S`` with a sticky conn
identity, then the conn loops on ``QUERY_CMD_S`` frames:

- ``QUERY_WEB_JSON``    → the reference qtype/options envelope,
  translated (``refquery.web_json_to_query``) and answered by the SAME
  ``Runtime.query`` path the GYT protocol and REST gateway share — so
  NM/REST JSON is identical by construction;
- ``CRUD_GENERIC_JSON`` → tracedef/tag CRUD (``query/crud.py`` →
  ``trace/defs.py``);
- ``CRUD_ALERT_JSON``   → alertdef/silence/inhibit/action CRUD
  (``alerts/manager.py``), objtype family enforced per verb.

Responses stream as chunked ``QUERY_RESPONSE_S`` frames (is_completed=0
partials + a final complete frame — the ≤16MB SOCK_JSON_WRITER
discipline) with a drain per chunk: bounded transport memory.

Observability: ``nm_conns`` gauge, per-verb ``nm_queries|verb=...``
labeled counters and ``nm_<verb>`` timing hists land in the Stats
registry and surface through the existing /metrics exporter.
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from gyeeta_tpu_torch.ingest import refproto as RP
from gyeeta_tpu_torch.ingest import refquery as RQ
from gyeeta_tpu_torch.ingest import wire

log = logging.getLogger("gyeeta_tpu_torch.net.nm")

# per-verb observability names (the {verb=...} label values)
_VERB_OF_QTYPE = {
    RQ.REF_QUERY_WEB_JSON: "web_json",
    RQ.REF_CRUD_GENERIC_JSON: "crud_generic_json",
    RQ.REF_CRUD_ALERT_JSON: "crud_alert_json",
}


class NMConnState:
    """Sticky per-conn identity issued at the NM handshake (the
    reference pins the node's host/port pair on its conn object and
    reuses it across queries; reconnects present the same identity)."""

    def __init__(self, hostname: str, port: int, conn_id: int):
        self.hostname = hostname
        self.port = port
        self.conn_id = conn_id          # sticky per (hostname, port)
        self.n_queries = 0
        self.t_connect = time.time()


def _gate_nm(req: dict) -> tuple[int, str]:
    """Version gates of the NM handshake (the same validate_fields
    discipline as the partha gates, ``gy_comm_proto.h:55-56``)."""
    if req["comm_version"] != RP.REF_COMM_VERSION:
        return 101, (f"comm version {req['comm_version']} unsupported "
                     f"(need {RP.REF_COMM_VERSION})")
    if req["node_version"] < RQ.REF_MIN_NODE_VERSION:
        return 103, "node version below minimum supported"
    if req["min_madhava_version"] > RP.REF_MADHAVA_VERSION:
        return 102, "server version below node's minimum"
    return 0, ""


async def serve_nm_conn(server, reader, writer, body: bytes) -> None:
    """Handle one NM conn end-to-end: ``body`` is the already-read
    NM_CONNECT_CMD_S payload (the server's pre-registration loop peeled
    the COMM_HEADER). Returns when the conn closes."""
    rt = server.rt
    req = RQ.parse_nm_connect_cmd(body)
    err, es = _gate_nm(req)
    now = int(time.time())
    writer.write(RQ.encode_nm_connect_resp(err, es, server._madhava_id,
                                           now))
    await writer.drain()
    if err:
        rt.stats.bump("nm_conns_rejected")
        return
    st = server._nm_register(req["node_hostname"], req["node_port"])
    rt.stats.bump("nm_conns_accepted")
    server._nm_conns_live += 1
    rt.stats.gauge("nm_conns", server._nm_conns_live)
    log.info("nm conn: node %s:%d (conn id %d)", st.hostname, st.port,
             st.conn_id)
    try:
        await _query_loop(server, reader, writer, st)
    finally:
        server._nm_conns_live -= 1
        rt.stats.gauge("nm_conns", server._nm_conns_live)


async def _read_nm_frame(reader) -> tuple[int, bytes]:
    """One reference COMM_HEADER frame → (data_type, payload). Raises
    IncompleteReadError at EOF, FrameError on poison headers."""
    hsz = RP.REF_HEADER_DT.itemsize
    hdr_b = await reader.readexactly(hsz)
    hdr = np.frombuffer(hdr_b, RP.REF_HEADER_DT, count=1)[0]
    if int(hdr["magic"]) not in RP.REF_MAGICS:
        raise wire.FrameError(
            f"bad NM magic 0x{int(hdr['magic']):08x}")
    total = int(hdr["total_sz"])
    if total < hsz or total >= wire.MAX_COMM_DATA_SZ:
        raise wire.FrameError(f"bad NM total_sz {total}")
    pad = int(hdr["padding_sz"])
    if pad > total - hsz:
        raise wire.FrameError(f"bad NM padding_sz {pad}")
    body = await reader.readexactly(total - hsz)
    return int(hdr["data_type"]), body[: len(body) - pad]


async def _route(server, qtype: int, obj: dict) -> dict:
    """One NM request → the shared engine path. Raises ValueError on
    envelope errors (caught into an error response by the loop).
    QUERY_WEB_JSON rides ``server.run_query`` — the same snapshot +
    off-loop executor routing as the GYT and REST edges, so NM/REST
    parity holds through the snapshot path by construction; CRUD
    mutates live structures and stays inline."""
    rt = server.rt
    if qtype == RQ.REF_QUERY_WEB_JSON:
        return await server.run_query(RQ.web_json_to_query(obj))
    server._feed_barrier()
    if qtype == RQ.REF_CRUD_GENERIC_JSON:
        return rt.crud(RQ.crud_to_request(obj, alert=False))
    if qtype == RQ.REF_CRUD_ALERT_JSON:
        return rt.crud(RQ.crud_to_request(obj, alert=True))
    raise ValueError(f"unsupported NM query type {qtype}")


async def serve_nm_gateway(gw, reader, writer, body: bytes) -> None:
    """The NM dialect on the FABRIC GATEWAY front (``net/gateway.py``):
    same handshake gates, but queries route through the gateway's
    (snaptick, request-hash) edge cache instead of a local runtime —
    a stock node webserver pointed at a gateway shares the fleet's
    renders without knowing the tier exists. Because this rides the
    SAME ``gw.query`` entry as the HTTP/GYT fronts, a stock NM also
    sees the gateway-local panels (``subsys=topology`` — the breaker /
    owner-map health model). CRUD verbs translate and pass through to
    a replica (mutations are never cached)."""
    req = RQ.parse_nm_connect_cmd(body)
    err, es = _gate_nm(req)
    now = int(time.time())
    writer.write(RQ.encode_nm_connect_resp(err, es, gw._madhava_id,
                                           now))
    await writer.drain()
    if err:
        gw.stats.bump("gw_nm_rejected")
        return
    gw.stats.bump("gw_nm_conns_accepted")
    while True:
        try:
            dtype, fbody = await _read_nm_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        if dtype != RQ.REF_COMM_QUERY_CMD:
            gw.stats.bump("gw_nm_frames_unknown_type")
            continue
        seqid, qtype, obj = RQ.parse_query_cmd(fbody)
        verb = _VERB_OF_QTYPE.get(qtype, f"qtype_{qtype}")
        gw.stats.bump(f"gw_queries|edge=nm,verb={verb}")
        try:
            if qtype == RQ.REF_QUERY_WEB_JSON:
                q = RQ.web_json_to_query(obj)
            elif qtype == RQ.REF_CRUD_GENERIC_JSON:
                q = RQ.crud_to_request(obj, alert=False)
            elif qtype == RQ.REF_CRUD_ALERT_JSON:
                q = RQ.crud_to_request(obj, alert=True)
            else:
                raise ValueError(f"unsupported NM query type {qtype}")
            with gw.stats.timeit("gw_query"):
                out = await gw.query(q)
        except Exception as e:          # noqa: BLE001 — envelope error
            writer.write(RQ.encode_response_frames(
                seqid, {"error": str(e), "errcode": 400},
                RQ.REF_RESP_ERROR))
            await writer.drain()
            continue
        for frame in RQ.iter_response_frames(seqid, out):
            writer.write(frame)
            await writer.drain()


async def _query_loop(server, reader, writer, st: NMConnState) -> None:
    rt = server.rt
    outstanding = 0
    bad_frames = 0
    while True:
        try:
            # idle deadline (server.idle_timeout): a silent NM conn is
            # reaped on the same labeled counter as every other conn
            if server.idle_timeout:
                dtype, body = await asyncio.wait_for(
                    _read_nm_frame(reader), server.idle_timeout)
            else:
                dtype, body = await _read_nm_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        except (asyncio.TimeoutError, TimeoutError):
            rt.stats.bump("conn_timeouts|kind=idle")
            log.info("nm conn: node %s:%d idle — reaped", st.hostname,
                     st.port)
            return
        if dtype != RQ.REF_COMM_QUERY_CMD:
            rt.stats.bump("nm_frames_unknown_type")
            bad_frames += 1
            if bad_frames > server.frame_error_budget:
                # per-conn error budget, same discipline as the GYT
                # query loop: junk frames must not spin forever
                rt.stats.bump("frames_rejected|reason=error_budget")
                return
            continue
        seqid, qtype, obj = RQ.parse_query_cmd(body)
        verb = _VERB_OF_QTYPE.get(qtype, f"qtype_{qtype}")
        rt.stats.bump(f"nm_queries|verb={verb}")
        st.n_queries += 1
        if outstanding >= wire.MAX_OUTSTANDING_QUERIES:
            writer.write(RQ.encode_response_frames(
                seqid, {"error": "busy", "errcode": 503},
                RQ.REF_RESP_ERROR))
            await writer.drain()
            continue
        outstanding += 1
        try:
            with rt.stats.timeit(f"nm_{verb}"):
                out = await _route(server, qtype, obj)
        except Exception as e:
            from gyeeta_tpu_torch.net.qexec import Overloaded
            outstanding -= 1
            rt.stats.bump("nm_query_errors")
            # shed → 503 (counted in gyt_queries_shed_total), envelope
            # errors → 400; either way the conn and loop stay live
            code = 503 if isinstance(e, Overloaded) else 400
            writer.write(RQ.encode_response_frames(
                seqid, {"error": str(e), "errcode": code},
                RQ.REF_RESP_ERROR))
            await writer.drain()
            continue
        try:
            # large results stream as is_completed=0 chunks with a
            # drain per chunk (bounded transport memory)
            sent = 0
            try:
                for frame in RQ.iter_response_frames(seqid, out):
                    writer.write(frame)
                    await writer.drain()
                    sent += 1
            except Exception as e:
                if sent == 0 and not isinstance(e, ConnectionError):
                    # e.g. unserializable result: the query still gets
                    # its error response and the conn survives
                    writer.write(RQ.encode_response_frames(
                        seqid, {"error": str(e), "errcode": 500},
                        RQ.REF_RESP_ERROR))
                    await writer.drain()
                else:
                    raise       # mid-stream failure: close (resync)
        finally:
            outstanding -= 1
