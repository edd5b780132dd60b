"""Command-line entry points of the port.

``python -m gyeeta_tpu_torch serve …``    — the aggregation-server daemon
(``server_main``; ``--device cuda`` by default)
``python -m gyeeta_tpu_torch query …``    — one-shot JSON query/CRUD client
``python -m gyeeta_tpu_torch web …``      — the REST gateway over a server
``python -m gyeeta_tpu_torch gateway …``  — the fan-in fabric gateway in
front of N serve replicas (``net/gateway.py``)
``python -m gyeeta_tpu_torch ship …``     — the source-region segment
shipper over a WAL dir (``history/shipper.py``)
``python -m gyeeta_tpu_torch shiprecv …`` — the compaction region's
staging receiver (``net/segship.py``)
``python -m gyeeta_tpu_torch compact …``  — offline WAL compaction
(``run``, on ``--device``; ``--procs N`` replays a per-shard WAL with N
worker processes into a parted store) and the shard manifest with the
ship ledger's provenance (``list``, flat or parted)
``python -m gyeeta_tpu_torch relay …``    — the remote ingest relay
(``net/relay.py``): agents register and stream to it, and it ships
decoded batches to a serve process's ``--relay-port``

Counterpart of the serving half of ``gyeeta_tpu/cli.py``; a bare
``python -m gyeeta_tpu_torch --port …`` runs ``serve`` as the reference
does. This module and ``server_main`` are the ones that hand
``os.environ`` to the modules' knob readers. The agent-side subcommands
(``agent``, ``replay``, ``obs``, ``nm``, ``chaos``) are not carried.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

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


def _ship_provenance(journal_dir):
    """The ship ledger's landed/shed/dropped segments, one row each
    (a torn tail line ends the read): which region produced every
    segment of a shipped store. None when the dir has no ledger."""
    import pathlib

    from gyeeta_tpu_torch.net.segship import LEDGER_NAME
    lp = pathlib.Path(journal_dir) / LEDGER_NAME
    if not lp.exists():
        return None
    segs = []
    for raw in lp.read_bytes().splitlines(keepends=True):
        if not raw.endswith(b"\n"):
            break                          # torn tail: incomplete fact
        try:
            e = json.loads(raw)
        except ValueError:
            break
        if e.get("meta") or "k" not in e:
            continue
        src = e.get("src") or {}
        segs.append({
            "segment": e["k"], "status": e.get("status"),
            "hash": e.get("hash"), "records": e.get("nrec"),
            "bytes": e.get("size"), "src_shipper": src.get("shipper"),
            "src_epoch": src.get("epoch"), "src_token": src.get("token"),
            "src_host": src.get("host")})
    return segs


def _cmd_compact(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch compact",
        description="offline WAL compaction: re-fold a journal dir "
        "through the engine on --device and emit columnar snapshot "
        "shards (history/compactor.py) — the batch form of the serve "
        "daemon's in-process compactor. 'list' prints the shard "
        "manifest of a shard dir (flat or parted).")
    ap.add_argument("what", nargs="?", default="run",
                    choices=("run", "list"))
    ap.add_argument("--journal-dir", help="WAL source (run)")
    ap.add_argument("--shard-dir", required=True)
    ap.add_argument("--config", help="JSON config ({engine:…, "
                    "runtime:…}) — geometry MUST match the serving "
                    "process that wrote the WAL")
    ap.add_argument("--device", default="cuda",
                    help="device of the replay runtime: cuda (default; "
                    "raises without a GPU) or cpu")
    ap.add_argument("--window-ticks", type=int, default=None)
    ap.add_argument("--upto-tick", type=int, default=None,
                    help="also tick past the last chunk's stamp (only "
                    "sound when the producer is stopped)")
    ap.add_argument("--procs", type=int, default=0,
                    help="N>=1: parallel compaction — N replay worker "
                    "processes on --device over disjoint WAL shard "
                    "groups into a parted shard store (needs a sharded "
                    "WAL; N <= shard count). 0 = single replay runtime")
    args = ap.parse_args(argv)

    from gyeeta_tpu_torch.utils import config as C
    if args.what == "list":
        from gyeeta_tpu_torch.history.shards import open_shard_store
        store = open_shard_store(args.shard_dir)
        out = {"pos": store.position(), "tick": store.tick(),
               "shards": store.shards()}
        # shipped-store provenance: when the WAL source is a ship
        # staging dir, its content-hash ledger says which region
        # produced every segment (shipper id, instance token, epoch,
        # blake2b)
        segs = _ship_provenance(args.journal_dir) \
            if args.journal_dir else None
        if segs is not None:
            out["shipped_segments"] = segs
        json.dump(out, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return
    if not args.journal_dir:
        raise SystemExit("compact run needs --journal-dir")
    cfg = C.load_engine_cfg(args.config, env=os.environ)
    opts = C.load_runtime_opts(
        args.config, env=os.environ, hist_shard_dir=args.shard_dir,
        **({"hist_window_ticks": args.window_ticks}
           if args.window_ticks is not None else {}))
    from gyeeta_tpu_torch.utils.selfstats import Stats
    if args.procs >= 1:
        from gyeeta_tpu_torch.history.compactproc import ParallelCompactor
        c = ParallelCompactor(cfg, opts, args.procs,
                              journal_dir=args.journal_dir,
                              shard_dir=args.shard_dir, stats=Stats(),
                              device=args.device, env=os.environ)
    else:
        from gyeeta_tpu_torch.history.compactor import Compactor
        c = Compactor(cfg, opts, journal_dir=args.journal_dir,
                      shard_dir=args.shard_dir, stats=Stats(),
                      device=args.device)
    try:
        rep = c.compact_once(upto_tick=args.upto_tick)
    finally:
        c.close()
    json.dump(rep, sys.stdout)
    sys.stdout.write("\n")


def _cmd_relay(argv) -> None:
    """Remote ingest relay (net/relay.py): runs the full ingest edge
    on THIS host — agents register and stream here — and ships decoded
    batches to the serve process's --relay-port over one exact-ledger
    TCP uplink (published == consumed + counted drops, across
    machines, across relay restarts)."""
    from gyeeta_tpu_torch.net.relay import relay_main
    relay_main(argv, env=os.environ)


def _cmd_ship(argv) -> None:
    """Source-region segment shipper (history/shipper.py): sealed WAL
    segments stream to a remote compaction region's staging receiver,
    content-hashed and resumable."""
    from gyeeta_tpu_torch.history.shipper import ship_main
    ship_main(argv, env=os.environ)


def _cmd_shiprecv(argv) -> None:
    """Compaction-region staging receiver (net/segship.py): sealed
    segments land here hash-verified + crash-consistent; point
    ``compact`` (or ``serve --ship-staging --shard-dir``) at the
    staging dir to replay them exactly as if local."""
    from gyeeta_tpu_torch.net.segship import recv_main
    recv_main(argv, env=os.environ)


def _cmd_gateway(argv) -> None:
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch gateway")
    ap.add_argument("--upstream", action="append", default=[],
                    metavar="HOST:PORT",
                    help="serve replica to fan out to (repeatable; "
                    ">=2 makes the cache worth the hop)")
    ap.add_argument("--hub-from", action="append", default=[],
                    metavar="HOST:PORT", dest="hub_from",
                    help="run as a cross-region HUB: subscribe to a "
                    "PEER GATEWAY's delta stream instead of polling "
                    "serve replicas (repeatable for failover across "
                    "the home region's gateways)")
    ap.add_argument("--peer", action="append", default=[],
                    metavar="HOST:PORT",
                    help="another gateway instance to exchange cached "
                    "results with (repeatable)")
    # loopback by default: the fabric edge is unauthenticated query +
    # subscribe
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=10090)
    ap.add_argument("--poll-s", type=float, default=None,
                    help="snaptick watch cadence per upstream "
                    "(default GYT_GW_POLL_S or 0.5)")
    ap.add_argument("--gw-down-after", type=int, default=None,
                    help="consecutive failures before an upstream is "
                    "marked down (circuit breaker; default "
                    "GYT_GW_DOWN_AFTER or 3 — never one bad poll)")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="latency budget past which a render hedges "
                    "to the next-healthiest replica (default "
                    "GYT_GW_HEDGE_MS or 75; 0 disables)")
    ap.add_argument("--sub-persist", default=None,
                    help="append-only file persisting the "
                    "subscription version ring: a restarted gateway "
                    "resumes reconnecting subscribers with DELTAS "
                    "instead of full resyncs (default "
                    "GYT_GW_SUB_PERSIST or off)")
    ap.add_argument("--advertise", default=None,
                    help="the host:port PEERS dial this gateway on "
                    "(rendezvous key ownership; default the listen "
                    "address)")
    args = ap.parse_args(argv)

    def hp(s):
        h, _, p = s.rpartition(":")
        return (h or "127.0.0.1", int(p))

    if not args.upstream and not args.hub_from:
        ap.error("need --upstream (region-local) or --hub-from "
                 "(cross-region hub)")

    async def run():
        from gyeeta_tpu_torch.net.gateway import FabricGateway
        gw = FabricGateway([hp(u) for u in args.upstream]
                           or [hp(u) for u in args.hub_from],
                           host=args.listen_host,
                           port=args.listen_port,
                           peers=[hp(p) for p in args.peer],
                           poll_s=args.poll_s,
                           down_after=args.gw_down_after,
                           hedge_ms=args.hedge_ms,
                           sub_persist=args.sub_persist,
                           advertise=args.advertise,
                           hub=bool(args.hub_from), env=os.environ)
        h, p = await gw.start()
        mode = "HUB <-" if args.hub_from else "->"
        print(f"fabric gateway on {h}:{p} (REST + GYT + NM) {mode} "
              f"{len(gw.upstreams)} upstream(s), "
              f"{len(gw.peers)} peer(s)", file=sys.stderr)
        try:
            await asyncio.Event().wait()
        finally:
            await gw.stop()

    asyncio.run(run())


_COMMANDS = {"query": _cmd_query, "web": _cmd_web,
             "gateway": _cmd_gateway, "ship": _cmd_ship,
             "shiprecv": _cmd_shiprecv, "compact": _cmd_compact,
             "relay": _cmd_relay}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else None
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](argv[1:])
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
