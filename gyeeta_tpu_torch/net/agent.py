"""The client half of the agent tier: registration and QueryClient.

Counterpart of the client half of ``gyeeta_tpu/net/agent.py``:
:func:`register_ex` / :func:`register` open a conn and send the
REGISTER_REQ that commits its role (an agent's event conn, or a query
conn); :class:`QueryClient` is the node-webserver peer, a query-role conn
multiplexing JSON queries by seqid, dialled and read under deadlines (a
wedged server yields a clear timeout error and a counter, never an
infinite hang). The agent itself (``NetAgent``) and its collectors are
agent-side and are not carried; the server takes the reference's agents
over the wire.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from gyeeta_tpu_torch import version
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils import hashing as H
from gyeeta_tpu_torch.utils.selfstats import Stats

# one validated reader on both ends of the wire (ingest/wire.py): magic
# gate + total_sz/padding bounds before any body read
_read_frame = wire.read_frame


async def register_ex(host: str, port: int, machine_id: int,
                      conn_type: int,
                      wire_version: int = version.CURR_WIRE_VERSION,
                      hostname_id: int = 0):
    """Open + register one conn → (reader, writer, status, host_id,
    last_seq, preagg). ``last_seq`` is the server's durable sweep-seq
    high-water mark for this host (0 from pre-v4 servers) — the WAL
    dedup handshake (see ``wire.NOTIFY_SWEEP_SEQ``); ``preagg`` is the
    server's edge pre-aggregation advert (the v5 tail — the sketch
    geometry delta sweeps must fold with), or None."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(wire.encode_register_req(
            machine_id, conn_type, wire_version, hostname_id))
        await writer.drain()
        dtype, payload = await _read_frame(reader)
    except BaseException:
        writer.close()
        raise
    if dtype != wire.COMM_REGISTER_RESP:
        writer.close()
        raise wire.FrameError(f"expected REGISTER_RESP, got {dtype}")
    status, host_id, _ver, last_seq, preagg = \
        wire.decode_register_resp(payload)
    return reader, writer, status, host_id, last_seq, preagg


async def register(host: str, port: int, machine_id: int, conn_type: int,
                   wire_version: int = version.CURR_WIRE_VERSION,
                   hostname_id: int = 0):
    """Open + register one conn → (reader, writer, status, host_id)."""
    reader, writer, status, host_id, _seq, _pre = await register_ex(
        host, port, machine_id, conn_type, wire_version, hostname_id)
    return reader, writer, status, host_id


class QueryClient:
    """Query-role conn: JSON queries multiplexed by seqid.

    Dial and per-request deadlines (``connect_timeout`` /
    ``request_timeout``) guard against a wedged server: a fired
    deadline raises a clear error, bumps a counter on ``stats``, and
    resets the conn (the response stream is desynced once a request
    is abandoned mid-flight)."""

    def __init__(self, machine_id: Optional[int] = None,
                 connect_timeout: float = 10.0,
                 request_timeout: Optional[float] = 60.0):
        self.machine_id = machine_id if machine_id is not None \
            else H.hash_bytes_np(b"query-client")
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.stats = Stats()
        self._reader = None
        self._writer = None
        self._seq = 0

    async def connect(self, host: str, port: int,
                      timeout: Optional[float] = None) -> None:
        t = self.connect_timeout if timeout is None else timeout
        try:
            reader, writer, status, _ = await asyncio.wait_for(
                register(host, port, self.machine_id, wire.CONN_QUERY),
                t)
        except (asyncio.TimeoutError, TimeoutError):
            self.stats.bump("connect_timeouts")
            raise ConnectionError(
                f"query connect to {host}:{port} timed out "
                f"after {t:.1f}s") from None
        if status != wire.REG_OK:
            writer.close()
            raise ConnectionRefusedError(f"registration status {status}")
        self._reader, self._writer = reader, writer

    async def query(self, req: dict,
                    timeout: Optional[float] = None) -> dict:
        t = self.request_timeout if timeout is None else timeout
        if t is None:
            return await self._query(req)
        try:
            return await asyncio.wait_for(self._query(req), t)
        except (asyncio.TimeoutError, TimeoutError):
            self.stats.bump("query_timeouts")
            # the conn is desynced (the response may still arrive):
            # reset it so a retry cannot read a stale tail
            await self.close()
            raise TimeoutError(
                f"query timed out after {t:.1f}s "
                f"(subsys {req.get('subsys')!r})") from None

    async def _query(self, req: dict) -> dict:
        import json

        self._seq += 1
        seq = self._seq
        self._writer.write(wire.encode_query(seq, req))
        await self._writer.drain()
        chunks = []       # joined once at the end: O(N) for GB responses
        while True:       # streamed responses: QS_PARTIAL chunks → final
            dtype, payload = await _read_frame(self._reader)
            if dtype != wire.COMM_QUERY_RESP:
                raise wire.FrameError(f"expected QUERY_RESP, got {dtype}")
            seqid, status, chunk = wire.decode_query_chunk(payload)
            if seqid != seq:
                raise wire.FrameError(f"seqid mismatch {seqid} != {seq}")
            chunks.append(chunk)
            if status != wire.QS_PARTIAL:
                break
        obj = json.loads(b"".join(chunks) or b"null")
        if status != wire.QS_OK:
            raise RuntimeError(obj.get("error", f"query status {status}"))
        return obj

    async def close(self) -> None:
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
