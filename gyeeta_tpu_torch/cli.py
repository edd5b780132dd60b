"""Command-line entry points of the port: serve / query / web.

``python -m gyeeta_tpu_torch serve …`` — the aggregation-server daemon
(``server_main``; ``--device cuda`` by default)
``python -m gyeeta_tpu_torch query …`` — one-shot JSON query/CRUD client
``python -m gyeeta_tpu_torch web …``   — the REST gateway over a server

Counterpart of the serving half of ``gyeeta_tpu/cli.py``; a bare
``python -m gyeeta_tpu_torch --port …`` runs ``serve`` as the reference
does. The subcommands of tiers the port does not have yet raise
:class:`~gyeeta_tpu_torch.unported.NotPortedError` naming ROADMAP.md's
item (``gateway``, ``ship``, ``shiprecv``: what remains of the serving
edges; ``relay`` and ``compact``: the sharded tier). The agent-side
subcommands (``agent``, ``replay``, ``obs``, ``nm``, ``chaos``) are not
carried.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from gyeeta_tpu_torch.unported import SERVING_REST, SHARDED, refuse

_UNPORTED = {"gateway": ("the fan-in fabric gateway", SERVING_REST),
             "ship": ("the segment shipper", SERVING_REST),
             "shiprecv": ("the remote compaction region's receiver",
                          SERVING_REST),
             "relay": ("the remote ingest relay", SHARDED),
             "compact": ("offline and distributed compaction", SHARDED)}
_AGENT_SIDE = ("agent", "replay", "obs", "nm", "chaos")


def _cmd_query(argv) -> None:
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch query")
    ap.add_argument("request", help="JSON query/CRUD body, or '-' for "
                    "stdin")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="per-request deadline (seconds)")
    args = ap.parse_args(argv)
    body = sys.stdin.read() if args.request == "-" else args.request
    req = json.loads(body)

    async def run():
        from gyeeta_tpu_torch.net.agent import QueryClient
        qc = QueryClient(request_timeout=args.timeout)
        await qc.connect(args.host, args.port)
        try:
            out = await qc.query(req)
        finally:
            await qc.close()
        json.dump(out, sys.stdout, default=str)
        sys.stdout.write("\n")

    asyncio.run(run())


def _cmd_web(argv) -> None:
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch web")
    ap.add_argument("--host", default="127.0.0.1",
                    help="upstream gyt-server address")
    ap.add_argument("--port", type=int, default=10038)
    # loopback by default: the gateway is unauthenticated query + CRUD
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=10080)
    ap.add_argument("--render-procs", type=int, default=0,
                    help="child processes encoding large JSON bodies "
                    "(0 = inline)")
    args = ap.parse_args(argv)

    async def run():
        from gyeeta_tpu_torch.net.webgw import WebGateway
        gw = WebGateway(args.host, args.port, host=args.listen_host,
                        port=args.listen_port,
                        render_procs=args.render_procs)
        h, p = await gw.start()
        print(f"web gateway on http://{h}:{p} -> gyt "
              f"{args.host}:{args.port}", file=sys.stderr)
        try:
            await asyncio.Event().wait()
        finally:
            await gw.stop()

    asyncio.run(run())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else None
    if cmd in ("query", "web"):
        return {"query": _cmd_query, "web": _cmd_web}[cmd](argv[1:])
    if cmd in _UNPORTED:
        what, item = _UNPORTED[cmd]
        raise refuse(f"the {cmd!r} subcommand ({what})", item)
    if cmd in _AGENT_SIDE:
        raise SystemExit(f"{cmd!r} is an agent-side subcommand of the "
                         "reference (python -m gyeeta_tpu); the port "
                         "serves only")
    if cmd == "serve":
        argv = argv[1:]
    from gyeeta_tpu_torch.server_main import main as serve_main
    serve_main(argv)


if __name__ == "__main__":
    main()
