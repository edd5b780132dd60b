"""Stock node-webserver simulator: a byte-level NM query client.

The mirror of ``sim/partha.py`` for the QUERY half of the reference
protocol: where ParthaSim synthesizes the partha→madhava NOTIFY
streams, NodeWebSim speaks the node-webserver→madhava conn contract
(``ingest/refquery.py`` — NM_CONNECT_CMD_S handshake, QUERY_CMD_S with
QUERY_WEB_JSON / CRUD_GENERIC_JSON / CRUD_ALERT_JSON bodies, chunked
QUERY_RESPONSE_S reads) with ZERO GYT-specific frames on the wire.
Drives the NM edge in tests and in ``ci.sh``'s smoke boot; the
``gyeeta_tpu_torch nm probe`` CLI wraps it for operators.

Counterpart of ``gyeeta_tpu/sim/nodeweb.py`` over the port's ``refproto``
and ``refquery`` encoders.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import Optional

import numpy as np

from gyeeta_tpu_torch.ingest import refproto as RP
from gyeeta_tpu_torch.ingest import refquery as RQ
from gyeeta_tpu_torch.ingest import wire


class NMError(RuntimeError):
    """Server answered with a REF_RESP_ERROR envelope."""

    def __init__(self, obj: dict):
        super().__init__(str(obj.get("error", obj)))
        self.errcode = obj.get("errcode")
        self.obj = obj


class NodeWebSim:
    """One stock node-webserver conn (handshake + query loop).

    Usage::

        nw = NodeWebSim()
        await nw.connect(host, port)
        out = await nw.query_web("svcstate", filter=..., maxrecs=10)
        await nw.crud_alert({"op": "add", "objtype": "alertdef", ...})
        await nw.close()
    """

    def __init__(self, hostname: str = "nodeweb-sim",
                 node_port: int = 10039,
                 node_version: int = 0x000501,
                 comm_version: int = RP.REF_COMM_VERSION,
                 min_madhava_version: int = 0x000500):
        self.hostname = hostname
        self.node_port = node_port
        self.node_version = node_version
        self.comm_version = comm_version
        self.min_madhava_version = min_madhava_version
        self._seq = itertools.count(1)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self.handshake: dict = {}

    # --------------------------------------------------------- lifecycle
    async def connect(self, host: str, port: int) -> dict:
        """Dial the server and run the NM_CONNECT handshake. Returns the
        parsed NM_CONNECT_RESP_S fields; raises NMError on a gate
        rejection (the conn is closed server-side after an error
        response, like the reference)."""
        self._reader, self._writer = await asyncio.open_connection(
            host, port)
        self._writer.write(RQ.encode_nm_connect_cmd(
            hostname=self.hostname, node_port=self.node_port,
            node_version=self.node_version,
            comm_version=self.comm_version,
            min_madhava_version=self.min_madhava_version))
        await self._writer.drain()
        buf = await self._reader.readexactly(
            RP.REF_HEADER_DT.itemsize + RQ.REF_NM_CONNECT_RESP_DT.itemsize)
        resp = RQ.parse_nm_connect_resp(buf)
        self.handshake = resp
        if resp["error_code"]:
            await self.close()
            raise NMError({"error": resp["error_string"],
                           "errcode": resp["error_code"]})
        return resp

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._reader = self._writer = None

    # ------------------------------------------------------------- frames
    async def _read_frame(self) -> tuple[int, bytes]:
        hsz = RP.REF_HEADER_DT.itemsize
        hdr_b = await self._reader.readexactly(hsz)
        hdr = np.frombuffer(hdr_b, RP.REF_HEADER_DT, count=1)[0]
        if int(hdr["magic"]) not in RP.REF_MAGICS:
            raise wire.FrameError(
                f"bad magic 0x{int(hdr['magic']):08x}")
        total = int(hdr["total_sz"])
        if total < hsz or total >= wire.MAX_COMM_DATA_SZ:
            raise wire.FrameError(f"bad total_sz {total}")
        body = await self._reader.readexactly(total - hsz)
        pad = int(hdr["padding_sz"])
        return int(hdr["data_type"]), body[: len(body) - pad]

    async def request(self, qtype: int, body_obj: dict,
                      timeout_sec: float = 100.0) -> dict:
        """One framed request → the accumulated JSON response (chunked
        is_completed=0 partials are joined before parsing). Raises
        NMError on an error-envelope response."""
        seqid = next(self._seq)
        self._writer.write(RQ.encode_query_cmd(seqid, qtype, body_obj,
                                               timeout_sec))
        await self._writer.drain()
        chunks: list[bytes] = []
        resptype = RQ.REF_RESP_NULL
        while True:
            dtype, body = await self._read_frame()
            if dtype != RQ.REF_COMM_QUERY_RESP:
                raise wire.FrameError(f"unexpected data_type {dtype}")
            sid, resptype, done, chunk = RQ.parse_response_chunk(body)
            if sid != seqid:
                raise wire.FrameError(
                    f"seqid mismatch: sent {seqid}, got {sid}")
            chunks.append(chunk)
            if done:
                break
        obj = json.loads(b"".join(chunks) or b"null")
        if resptype == RQ.REF_RESP_ERROR:
            raise NMError(obj if isinstance(obj, dict)
                          else {"error": obj})
        return obj

    # ------------------------------------------------------------- verbs
    async def query_web(self, subsys, options: Optional[dict] = None,
                        **opt_kw) -> dict:
        """QUERY_WEB_JSON: ``subsys`` is a qtype code (int) or a
        subsystem name; keyword options merge over ``options`` (filter,
        maxrecs, columns, sortcol, sortdir, aggr, groupby...)."""
        opts = dict(options or {})
        opts.update(opt_kw)
        body = {"qtype": subsys}
        if opts:
            body["options"] = opts
        return await self.request(RQ.REF_QUERY_WEB_JSON, body)

    async def crud_generic(self, req: dict) -> dict:
        """CRUD_GENERIC_JSON: tracedef/tag add/delete."""
        return await self.request(RQ.REF_CRUD_GENERIC_JSON, req)

    async def crud_alert(self, req: dict) -> dict:
        """CRUD_ALERT_JSON: alertdef/silence/inhibit/action add/delete."""
        return await self.request(RQ.REF_CRUD_ALERT_JSON, req)
