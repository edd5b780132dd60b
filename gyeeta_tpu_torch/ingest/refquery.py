"""gy_comm_proto query-edge ABI: the node-webserver (NM) conn contract.

Counterpart of ``gyeeta_tpu/ingest/refquery.py`` (the port's own copy).
``refproto.py`` closed the INGEST half of the serialization boundary
(stock partha handshake + NOTIFY subtypes). This module transcribes the
QUERY half — what a stock Gyeeta NodeJS webserver speaks at a madhava
(routing ``server/gy_mnodehandle.cc:203``):

- ``NM_CONNECT_CMD_S`` / ``NM_CONNECT_RESP_S`` — the node→madhava
  registration handshake (``gy_comm_proto.h:887-952``), version-gated
  like the partha handshakes;
- ``QUERY_CMD_S`` (``gy_comm_proto.h:502``) — seqid/timeout/qtype
  envelope followed by a JSON body; qtypes transcribed from
  ``QUERY_TYPE_E`` (``gy_comm_proto.h:246-258``): ``QUERY_WEB_JSON``,
  ``CRUD_GENERIC_JSON``, ``CRUD_ALERT_JSON``;
- ``QUERY_RESPONSE_S`` (``gy_comm_proto.h:536``) — seqid/resptype/
  format/len envelope; large results stream as is_completed=0 chunks
  closed by a final is_completed=1 frame (the reference's ≤16MB
  SOCK_JSON_WRITER chunk discipline).

Layout conventions follow refproto.py: explicit little-endian numpy
dtypes with the reference's alignas(8) + explicit padding discipline;
``ingest/native/abiprobe.py`` proves each transcription against a C++
compiler's layout of the extracted header subset.

Both sides are implemented (the server in ``net/nmhandle.py``, the
client encoders here), so the edge is byte-level testable without a
stock webserver in the loop.
"""

from __future__ import annotations

import json

import numpy as np

from gyeeta_tpu_torch.ingest import refproto as RP
from gyeeta_tpu_torch.ingest import wire

# ----------------------------------------------------------- conn magics
# gy_comm_proto.h:39-57 per-edge COMM_HEADER magics: PS/PM are owned by
# refproto; the node edges use the remaining two of the documented set
REF_MAGIC_NM = 0x05777705        # node webserver → madhava
REF_MAGIC_NS = 0x05888805        # node webserver → shyama

# COMM_TYPE_E continuation (gy_comm_proto.h:124; refproto transcribes
# PS_REGISTER_REQ=2, PM_CONNECT_CMD=3, PS_REGISTER_RESP=8,
# PM_CONNECT_RESP=9, EVENT_NOTIFY=14 — the six REQ slots 2..7 mirror
# into RESP slots 8..13, then NOTIFY/QUERY)
REF_COMM_NS_REGISTER_REQ = 6
REF_COMM_NM_CONNECT_CMD = 7
REF_COMM_NS_REGISTER_RESP = 12
REF_COMM_NM_CONNECT_RESP = 13
REF_COMM_QUERY_CMD = 15
REF_COMM_QUERY_RESP = 16

# QUERY_TYPE_E (gy_comm_proto.h:246-258)
REF_QUERY_IGNORE = 0
REF_QUERY_PARTHA_MADHAVA = 1
REF_QUERY_WEB_JSON = 2
REF_QUERY_NODE_MADHAVA = 3
REF_CRUD_GENERIC_JSON = 4
REF_CRUD_ALERT_JSON = 5

# RESP_TYPE_E / RESP_FORMAT_E (gy_comm_proto.h:262-276)
REF_RESP_NULL = 0
REF_RESP_ERROR = 1
REF_RESP_WEB_JSON = 2
REF_RESP_FMT_JSON = 0
REF_RESP_FMT_BINARY = 1

# node version floors (sversion.cc analogues; the node tier versions in
# lockstep with the servers)
REF_MIN_NODE_VERSION = 0x000400       # "0.4.0"

# NM_CONNECT_CMD_S (gy_comm_proto.h:887) — the node's opener to madhava
REF_NM_CONNECT_CMD_DT = np.dtype([
    ("comm_version", "<u4"), ("node_version", "<u4"),
    ("min_madhava_version", "<u4"), ("pad0", "u1", (4,)),
    ("node_hostname", "S256"),
    ("node_port", "<u4"), ("cli_type", "<u4"),
    ("curr_sec", "<i8"), ("clock_sec", "<i8"),
    ("flags", "<u8"),
    ("extra_bytes", "u1", (512,)),
])
assert REF_NM_CONNECT_CMD_DT.itemsize == 816

# NM_CONNECT_RESP_S (gy_comm_proto.h:923)
REF_NM_CONNECT_RESP_DT = np.dtype([
    ("error_code", "<i4"), ("error_string", "S256"),
    ("pad0", "u1", (4,)),
    ("madhava_id", "<u8"), ("comm_version", "<u4"),
    ("madhava_version", "<u4"),
    ("madhava_name", "S64"),
    ("curr_sec", "<i8"), ("clock_sec", "<u8"), ("flags", "<u8"),
    ("extra_bytes", "u1", (512,)),
])
assert REF_NM_CONNECT_RESP_DT.itemsize == 880

# QUERY_CMD_S (gy_comm_proto.h:502): fixed envelope, JSON body follows
REF_QUERY_CMD_DT = np.dtype([
    ("seqid", "<u8"), ("timeoutusec", "<u8"),
    ("subtype", "<u4"),          # QUERY_TYPE_E
    ("respformat", "<u4"),       # RESP_FORMAT_E
])
assert REF_QUERY_CMD_DT.itemsize == 24

# QUERY_RESPONSE_S (gy_comm_proto.h:536): fixed envelope, body follows
REF_QUERY_RESPONSE_DT = np.dtype([
    ("seqid", "<u8"),
    ("resptype", "<u4"),         # RESP_TYPE_E
    ("respformat", "<u4"),
    ("resp_len", "<u4"),         # THIS chunk's body bytes (before pad)
    ("is_completed", "<u4"),     # 0 = more chunks follow (QS_PARTIAL)
])
assert REF_QUERY_RESPONSE_DT.itemsize == 24

_HSZ = RP.REF_HEADER_DT.itemsize
_QSZ = REF_QUERY_CMD_DT.itemsize
_RSZ = REF_QUERY_RESPONSE_DT.itemsize

# streamed-response chunk size: same discipline as the GYT query conn
# (wire.QUERY_CHUNK_BYTES) — well under the 16MB frame cap
NM_CHUNK_BYTES = wire.QUERY_CHUNK_BYTES

# the web qtype table the Node tier sends inside QUERY_WEB_JSON bodies
# ({"qtype": N, "options": {...}} — NODE_QUERY_TYPE_E of the reference
# webserver's gy_nodequery routing, gy_mnodehandle.cc:203): transcribed
# code → GYT query subsystem. String subsys names are also accepted
# (forward compatibility: the reference envelope grows qtypes faster
# than this table; names always work).
SUBSYS_OF_QTYPE = {
    1: "hoststate", 2: "cpumem", 3: "svcstate", 4: "svcinfo",
    5: "svcsumm", 6: "activeconn", 7: "clientconn", 8: "taskstate",
    9: "topcpu", 10: "toprss", 11: "topfork", 12: "tcpconn",
    13: "hostinfo", 14: "notifymsg", 15: "alerts", 16: "alertdef",
    17: "silences", 18: "inhibits", 19: "tracereq", 20: "tracedef",
    21: "clusterstate", 22: "svcmesh", 23: "svcipclust",
    24: "tracestatus", 25: "hostlist", 26: "svcprocmap",
    27: "traceuniq", 28: "cgroupstate",
    # GYT extension beyond the stock table: the heavy-hitter union view
    # (string subsys names always work; the code is for symmetry)
    29: "topk",
}
QTYPE_OF_SUBSYS = {v: k for k, v in SUBSYS_OF_QTYPE.items()}

# "tcpconn" is the node name for the flow view
_SUBSYS_ALIASES = {"tcpconn": "flowstate", "task": "taskstate",
                   "host": "hoststate", "service": "svcstate"}

# CRUD objtype families per verb (gy_comm_proto.h:246-258 routing:
# CRUD_ALERT_JSON → ALERTMGR, CRUD_GENERIC_JSON → generic def CRUD)
ALERT_CRUD_OBJS = ("alertdef", "silence", "inhibit", "action")
GENERIC_CRUD_OBJS = ("tracedef", "tag")


class NMFrameError(wire.FrameError):
    pass


# -------------------------------------------------------------- framing
def _ref_frame(data_type: int, payload: bytes,
               magic: int = REF_MAGIC_NM) -> bytes:
    pad = (-len(payload)) % 8
    total = _HSZ + len(payload) + pad
    if total >= wire.MAX_COMM_DATA_SZ:
        raise NMFrameError(f"NM frame {total}B exceeds 16MB cap")
    hdr = np.zeros((), RP.REF_HEADER_DT)
    hdr["magic"] = magic
    hdr["total_sz"] = total
    hdr["data_type"] = data_type
    hdr["padding_sz"] = pad
    return hdr.tobytes() + payload + b"\x00" * pad


# ------------------------------------------------------------ handshake
def encode_nm_connect_cmd(hostname: str = "nodeweb",
                          node_port: int = 10039,
                          node_version: int = 0x000501,
                          comm_version: int = RP.REF_COMM_VERSION,
                          min_madhava_version: int = 0x000500,
                          cli_type: int = RP.REF_CLI_TYPE_REQ_RESP,
                          curr_sec: int = 0) -> bytes:
    """Synthesized stock-node NM_CONNECT_CMD_S frame (what the Node
    webserver's madhava handler sends on connect)."""
    r = np.zeros((), REF_NM_CONNECT_CMD_DT)
    r["comm_version"] = comm_version
    r["node_version"] = node_version
    r["min_madhava_version"] = min_madhava_version
    r["node_hostname"] = hostname.encode()[:255]
    r["node_port"] = node_port
    r["cli_type"] = cli_type
    r["curr_sec"] = curr_sec
    r["clock_sec"] = curr_sec
    return _ref_frame(REF_COMM_NM_CONNECT_CMD, r.tobytes())


def parse_nm_connect_cmd(body: bytes) -> dict:
    """NM_CONNECT_CMD_S payload → field dict (raises on short body)."""
    if len(body) < REF_NM_CONNECT_CMD_DT.itemsize:
        raise NMFrameError("short NM_CONNECT_CMD_S")
    r = np.frombuffer(body, REF_NM_CONNECT_CMD_DT, count=1)[0]
    return {
        "comm_version": int(r["comm_version"]),
        "node_version": int(r["node_version"]),
        "min_madhava_version": int(r["min_madhava_version"]),
        "node_hostname": RP._cstr(r["node_hostname"]),
        "node_port": int(r["node_port"]),
        "cli_type": int(r["cli_type"]),
        "curr_sec": int(r["curr_sec"]),
    }


def encode_nm_connect_resp(error_code: int, error_string: str,
                           madhava_id: int, curr_sec: int) -> bytes:
    """Byte-exact NM_CONNECT_RESP_S frame."""
    r = np.zeros((), REF_NM_CONNECT_RESP_DT)
    v = r
    v["error_code"] = error_code
    v["error_string"] = error_string.encode()[:255]
    v["madhava_id"] = madhava_id
    v["comm_version"] = RP.REF_COMM_VERSION
    v["madhava_version"] = RP.REF_MADHAVA_VERSION
    v["madhava_name"] = b"gyt-tpu"
    v["curr_sec"] = curr_sec
    v["clock_sec"] = curr_sec
    return _ref_frame(REF_COMM_NM_CONNECT_RESP, r.tobytes())


def parse_nm_connect_resp(buf: bytes) -> dict:
    """Client-side decode of a whole NM_CONNECT_RESP_S frame."""
    hdr = np.frombuffer(buf, RP.REF_HEADER_DT, count=1)[0]
    r = np.frombuffer(buf, REF_NM_CONNECT_RESP_DT, count=1,
                      offset=_HSZ)[0]
    return {"data_type": int(hdr["data_type"]),
            "error_code": int(r["error_code"]),
            "error_string": RP._cstr(r["error_string"]),
            "madhava_id": int(r["madhava_id"]),
            "madhava_version": int(r["madhava_version"]),
            "madhava_name": RP._cstr(r["madhava_name"])}


# --------------------------------------------------------------- queries
def encode_query_cmd(seqid: int, qtype: int, body_obj,
                     timeout_sec: float = 100.0) -> bytes:
    """One QUERY_CMD_S frame: envelope + JSON body."""
    h = np.zeros((), REF_QUERY_CMD_DT)
    h["seqid"] = np.uint64(seqid)
    h["timeoutusec"] = np.uint64(int(timeout_sec * 1e6))
    h["subtype"] = qtype
    h["respformat"] = REF_RESP_FMT_JSON
    body = json.dumps(body_obj).encode()
    return _ref_frame(REF_COMM_QUERY_CMD, h.tobytes() + body)


def parse_query_cmd(body: bytes) -> tuple[int, int, dict]:
    """QUERY_CMD frame payload → (seqid, qtype, json_obj)."""
    if len(body) < _QSZ:
        raise NMFrameError("short QUERY_CMD_S")
    h = np.frombuffer(body, REF_QUERY_CMD_DT, count=1)[0]
    raw = body[_QSZ:]
    try:
        obj = json.loads(raw) if raw.strip(b"\x00") else {}
    except json.JSONDecodeError as e:
        raise NMFrameError(f"bad QUERY_CMD JSON body: {e}") from None
    if not isinstance(obj, dict):
        raise NMFrameError("QUERY_CMD body must be a JSON object")
    return int(h["seqid"]), int(h["subtype"]), obj


def iter_response_frames(seqid: int, obj,
                         resptype: int = REF_RESP_WEB_JSON,
                         chunk_bytes: int = NM_CHUNK_BYTES):
    """Yield the streamed QUERY_RESPONSE_S frame sequence for a JSON
    result: N-1 is_completed=0 chunks + one final is_completed=1 frame
    (the reference's ≤16MB SOCK_JSON_WRITER chunk discipline; mirrors
    ``wire.iter_query_frames``). JSON renders with the same plain
    ``json.dumps`` as the GYT/REST surfaces — byte parity by
    construction."""
    payload = json.dumps(obj).encode()
    for off in range(0, max(len(payload), 1), chunk_bytes):
        body = payload[off: off + chunk_bytes]
        h = np.zeros((), REF_QUERY_RESPONSE_DT)
        h["seqid"] = np.uint64(seqid)
        h["resptype"] = resptype
        h["respformat"] = REF_RESP_FMT_JSON
        h["resp_len"] = len(body)
        h["is_completed"] = 1 if off + chunk_bytes >= len(payload) else 0
        yield _ref_frame(REF_COMM_QUERY_RESP, h.tobytes() + body)


def encode_response_frames(seqid: int, obj,
                           resptype: int = REF_RESP_WEB_JSON) -> bytes:
    """Joined form of :func:`iter_response_frames` (tests)."""
    return b"".join(iter_response_frames(seqid, obj, resptype))


def parse_response_chunk(body: bytes) -> tuple[int, int, int, bytes]:
    """QUERY_RESPONSE frame payload → (seqid, resptype, is_completed,
    body_bytes). Callers accumulate until is_completed."""
    if len(body) < _RSZ:
        raise NMFrameError("short QUERY_RESPONSE_S")
    h = np.frombuffer(body, REF_QUERY_RESPONSE_DT, count=1)[0]
    n = int(h["resp_len"])
    return (int(h["seqid"]), int(h["resptype"]),
            int(h["is_completed"]), body[_RSZ: _RSZ + n])


# ------------------------------------------------- envelope translation
def web_json_to_query(obj: dict) -> dict:
    """A QUERY_WEB_JSON body ({"qtype": N|name, "options": {...}} per
    the reference envelope, or a native {"subsys": ...} request) → the
    GYT query dict ``Runtime.query`` takes. Raises ValueError on
    unknown qtypes (surfaced to the client as an error response)."""
    if "subsys" in obj and "qtype" not in obj:
        return obj                       # native shape passes through
    qtype = obj.get("qtype")
    if isinstance(qtype, str):
        subsys = _SUBSYS_ALIASES.get(qtype, qtype)
    else:
        subsys = SUBSYS_OF_QTYPE.get(qtype)
        if subsys is None:
            raise ValueError(f"unknown web qtype {qtype!r}")
    req = {"subsys": subsys}
    options = obj.get("options") or {}
    if not isinstance(options, dict):
        raise ValueError("options must be a JSON object")
    for k, v in options.items():
        if k == "sortdir":               # reference asc/desc form
            req["sortdesc"] = str(v).lower() != "asc"
        else:
            req[k] = v
    # "multiquery" rides inside options untouched (the engine's crud
    # module validates it)
    return req


def crud_to_request(obj: dict, alert: bool) -> dict:
    """A CRUD_*_JSON body → the GYT crud dict, with the objtype family
    enforced per verb (the reference routes CRUD_ALERT_JSON to ALERTMGR
    only — a tracedef smuggled over the alert verb must not work)."""
    req = dict(obj)
    if "optype" in req and "op" not in req:     # reference field name
        req["op"] = req.pop("optype")
    allowed = ALERT_CRUD_OBJS if alert else GENERIC_CRUD_OBJS
    objtype = req.get("objtype")
    if objtype is None and alert:
        req["objtype"] = objtype = "alertdef"   # the verb's default
    if objtype not in allowed:
        verb = "CRUD_ALERT_JSON" if alert else "CRUD_GENERIC_JSON"
        raise ValueError(f"{verb} objtype must be one of {allowed}")
    return req
