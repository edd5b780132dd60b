"""Web gateway: HTTP/JSON face over the query protocol (L7 tier).

Counterpart of ``gyeeta_tpu/net/webgw.py``.

The reference fronts madhava/shyama with a Node.js webserver speaking
its JSON envelope over NM conns (the repo's out-of-tree web tier; the
server side is the NM handshake in ``server/gy_mnodehandle.cc``).
Here the same tier is one asyncio process bridging REST to the GYT
query conn. A STOCK node webserver needs no gateway at all: the server
itself speaks the NM conn contract (``net/nmhandle.py``), and both
surfaces render the same ``Runtime.query`` dict with plain
``json.dumps`` — NM and REST responses are held equal for identical
queries (``tests/test_torch_server.py``):

- ``POST /query``            — raw JSON query/CRUD/multiquery envelope
- ``GET  /v1/<subsys>``      — convenience: query params ``filter``,
  ``maxrecs``, ``sortcol``, ``sortdesc``, ``tstart``, ``tend``, plus
  the time-travel params ``at`` (pin a snapshot instant) and
  ``window`` (trailing-duration aggregate) served from compaction
  shards (``history/timeview.py``), and ``consistency``
  (``snapshot`` — the server default: read the last published
  per-tick engine view off-loop; ``strong`` — flush-then-read on the
  serving loop, the pre-snapshot semantics)
- ``GET  /healthz``          — gateway + upstream liveness
- ``GET  /metrics``          — Prometheus text-format exposition of the
  upstream server's self-metrics (the ``metrics`` query subsystem,
  rendered by ``obs/prom.py``) — point a standard scraper here

One upstream :class:`~gyeeta_tpu_torch.net.agent.QueryClient` serialized by
a lock (the query conn multiplexes by seqid, but the client helper
reads responses inline); dropped upstream conns reconnect per request.
Stdlib-only HTTP/1.1 (Content-Length framing, keep-alive) — the
gateway carries operator queries, not ingest traffic.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
from typing import Optional

from gyeeta_tpu_torch.net.agent import QueryClient

_MAX_BODY = 8 << 20
_MAX_HDR = 64 << 10


class WebGateway:
    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 render_procs: int = 0, render_min_rows: int = 64):
        self.upstream = (upstream_host, upstream_port)
        self.host, self.port = host, port
        self._server = None
        self._qc: Optional[QueryClient] = None
        self._lock = asyncio.Lock()
        # GIL-relief JSON encode tier (net/qexec.py): with
        # render_procs > 0 large response bodies encode in a spawned
        # child process, so the gateway loop pays a cheap pickle
        # instead of the full dumps
        from gyeeta_tpu_torch.net.qexec import JsonRenderPool
        self._render = JsonRenderPool(render_procs, render_min_rows)

    async def start(self) -> tuple:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._qc is not None:
            await self._qc.close()
            self._qc = None
        self._render.close()

    # -------------------------------------------------------- upstream
    async def _query(self, req: dict) -> dict:
        from gyeeta_tpu_torch.ingest import wire

        async with self._lock:
            for attempt in (0, 1):      # one reconnect on a dead conn
                if self._qc is None:
                    qc = QueryClient()
                    await qc.connect(*self.upstream)
                    self._qc = qc
                try:
                    return await self._qc.query(req)
                except (ConnectionError, OSError,
                        asyncio.IncompleteReadError,
                        wire.FrameError):
                    # FrameError = DESYNCED stream (aborted QS_PARTIAL,
                    # seqid mismatch): the conn must not be reused or
                    # every later request reads the stale tail forever
                    await self._qc.close()
                    self._qc = None
                    if attempt:
                        raise
        raise ConnectionError("upstream unreachable")

    # ------------------------------------------------------------ http
    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                except asyncio.LimitOverrunError:
                    await self._respond(writer, 431, {"error":
                                                      "headers too large"})
                    return
                if len(head) > _MAX_HDR:
                    await self._respond(writer, 431, {"error":
                                                      "headers too large"})
                    return
                lines = head.decode("latin1").split("\r\n")
                parts = lines[0].split()
                if len(parts) != 3:
                    await self._respond(writer, 400,
                                        {"error": "bad request line"})
                    return
                method, target, _ = parts
                headers = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                try:
                    clen = int(headers.get("content-length", 0) or 0)
                except ValueError:
                    clen = -1
                if clen < 0:
                    await self._respond(writer, 400,
                                        {"error": "bad content-length"})
                    return
                if clen > _MAX_BODY:
                    await self._respond(writer, 413,
                                        {"error": "body too large"})
                    return
                body = await reader.readexactly(clen) if clen else b""
                keep = headers.get("connection", "keep-alive") \
                    .lower() != "close"
                streamed = await self._route(writer, method, target,
                                             body)
                if streamed or not keep:
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):  # pragma: no cover
                pass

    async def _route(self, writer, method: str, target: str,
                     body: bytes):
        path, _, qs = target.partition("?")
        try:
            if method == "GET" and path == "/v1/subscribe":
                await self._sse_subscribe(writer, qs)
                return True          # stream owned the conn: close it
            if method == "GET" and path == "/metrics":
                out = await self._query({"subsys": "metrics"})
                await self._respond_text(
                    writer, 200, out.get("text", ""),
                    out.get("content_type", "text/plain"))
                return
            if method == "GET" and path == "/healthz":
                out = await self._query({"subsys": "serverstatus"})
                up = out.get("nrecs", 0) == 1
                await self._respond(writer, 200 if up else 503,
                                    {"ok": up})
                return
            if method == "POST" and path == "/query":
                req = json.loads(body or b"{}")
                await self._respond(writer, 200, await self._query(req))
                return
            if method == "GET" and path.startswith("/v1/"):
                req = {"subsys": path[4:].strip("/")}
                q = urllib.parse.parse_qs(qs)
                for k in ("filter", "sortcol", "consistency"):
                    if k in q:
                        req[k] = q[k][0]
                for k in ("maxrecs",):
                    if k in q:
                        req[k] = int(q[k][0])
                for k in ("tstart", "tend"):
                    if k in q:
                        req[k] = float(q[k][0])
                # time-travel params (history/timeview.py): at= pins a
                # snapshot instant ("1712000000", "-15m", "tick:24");
                # window= aggregates a trailing duration ("15m", 900)
                for k in ("at", "window"):
                    if k in q:
                        req[k] = q[k][0]
                if "sortdesc" in q:
                    req["sortdesc"] = q["sortdesc"][0].lower() in (
                        "1", "true")
                await self._respond(writer, 200, await self._query(req))
                return
            await self._respond(writer, 404, {"error": "not found"})
        except (ValueError, KeyError, RuntimeError) as e:
            # RuntimeError carries the server's own error envelope
            # (unknown subsystem, bad filter, …) — a CLIENT error here
            await self._respond(writer, 400, {"error": str(e)})
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            await self._respond(writer, 502,
                                {"error": "upstream unreachable"})

    async def _sse_subscribe(self, writer, qs: str) -> None:
        """REST subscription relay: one DEDICATED upstream conn per
        SSE client carrying the server's ``COMM_SUBSCRIBE_CMD`` stream
        (``net/subs.py``) — the upstream hub still renders each
        distinct query once per tick; this edge only re-frames events
        as ``text/event-stream``. ``last_snaptick=`` resumes a
        reconnecting dashboard with a delta when the server still
        holds that version."""
        import json as _json

        from gyeeta_tpu_torch.net.subs import SubscribeClient
        q = urllib.parse.parse_qs(qs)
        if "subsys" not in q:
            await self._respond(writer, 400,
                                {"error": "subscribe needs subsys"})
            return
        req = {"subsys": q["subsys"][0]}
        for k in ("filter", "sortcol"):
            if k in q:
                req[k] = q[k][0]
        if "maxrecs" in q:
            req["maxrecs"] = int(q["maxrecs"][0])
        if "sortdesc" in q:
            req["sortdesc"] = q["sortdesc"][0].lower() in ("1", "true")
        if "cq" in q:
            # continuous query: relay a STANDING FILTER subscription
            # (enter/leave/change membership events) instead of a
            # panel-delta one — the upstream hub does the grouping
            req["cq"] = q["cq"][0].lower() in ("1", "true")
        last = None
        if "last_snaptick" in q:
            try:
                last = int(q["last_snaptick"][0])
            except ValueError:
                pass
        # stall_s= opts the relay into upstream heartbeat-loss
        # detection: a wedged hub surfaces as a typed
        # SubscriptionStalled, relayed below as an `event: error`
        # block instead of an indefinitely-silent stream (clients
        # pick ~3x the server tick interval)
        stall_s = None
        if "stall_s" in q:
            try:
                stall_s = float(q["stall_s"][0])
            except ValueError:
                pass
        sc = SubscribeClient()
        try:
            await sc.connect(*self.upstream)
            await sc.subscribe(req, last_snaptick=last)
        except (ConnectionError, OSError,
                asyncio.IncompleteReadError) as e:
            await self._respond(writer, 502, {"error": str(e)})
            await sc.close()
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            await writer.drain()
            async for ev in sc.events(stall_timeout=stall_s):
                writer.write(
                    f"event: {ev.get('t', 'message')}\n"
                    f"data: {_json.dumps(ev)}\n\n".encode())
                await writer.drain()
        except RuntimeError as e:
            # upstream rejected the subscription (bad filter,
            # capacity) or the stream STALLED past stall_s
            # (SubscriptionStalled is a RuntimeError): relay it as an
            # SSE error event — mirroring FabricGateway._sse_subscribe
            # — so the client can tell either from an empty stream
            try:
                writer.write(
                    f"event: error\n"
                    f"data: {_json.dumps({'error': str(e)})}\n\n"
                    .encode())
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        except (ConnectionError, OSError):
            pass                       # either side hung up
        finally:
            await sc.close()

    _REASON = {200: "OK", 400: "Bad Request", 404: "Not Found",
               413: "Payload Too Large", 431: "Headers Too Large",
               502: "Bad Gateway", 503: "Service Unavailable"}

    async def _respond(self, writer, status: int, obj) -> None:
        await self._respond_bytes(writer, status,
                                  await self._render.encode(obj),
                                  "application/json")

    @classmethod
    async def _respond_text(cls, writer, status: int, text: str,
                            ctype: str) -> None:
        await cls._respond_bytes(writer, status, text.encode(), ctype)

    @classmethod
    async def _respond_bytes(cls, writer, status: int, body: bytes,
                             ctype: str) -> None:
        reason = cls._REASON.get(status, "Error")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
