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
``python -m gyeeta_tpu_torch agent …``    — N supervised host agents
(``net/agent.NetAgent``: simulated, ``--collect`` measuring this host's
/proc and /sys, ``--real`` sweeping its sockets and tasks); SIGTERM or
SIGINT stops them between writes, and the command then prints one JSON
line, ``{"agent_report": [...]}``, each agent's delivery ledger
``python -m gyeeta_tpu_torch replay …``   — play a GYTREC capture into a
server
``python -m gyeeta_tpu_torch obs top|metrics`` — the live self-monitor
frame (``obs.format_top``) or the Prometheus exposition
``python -m gyeeta_tpu_torch nm probe|query`` — the stock
node-webserver wire probe (``sim/nodeweb.NodeWebSim``)
``python -m gyeeta_tpu_torch chaos …``    — the seeded fault-injection
TCP proxy (``sim/chaos.py``)

Counterpart of ``gyeeta_tpu/cli.py``; a bare ``python -m
gyeeta_tpu_torch --port …`` runs ``serve`` as the reference does. This
module and ``server_main`` are the ones that hand ``os.environ`` to the
modules' knob readers. The agent-side commands import no ``torch``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys


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


def _cmd_agent(argv) -> None:
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch agent")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--collect", action="store_true",
                    help="measure THIS host's /proc //sys instead of "
                    "simulating host/cgroup telemetry")
    ap.add_argument("--real", action="store_true",
                    help="observe THIS host's real TCP connections and "
                    "listeners (sock_diag sweep) instead of simulated "
                    "flows; implies --collect semantics for flows only")
    ap.add_argument("--livecap", action="store_true",
                    help="with --real: when the server enables tracing "
                    "for a listener (REQ_TRACE_SET), capture its "
                    "port's live traffic via AF_PACKET and stream "
                    "parsed transactions (needs CAP_NET_RAW; degrades "
                    "cleanly without)")
    ap.add_argument("--cap-ifname", default="lo",
                    help="interface for --livecap captures")
    ap.add_argument("--n-agents", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--n-conn", type=int, default=256)
    ap.add_argument("--n-resp", type=int, default=512)
    # supervision knobs (NetAgent.run_forever): the agent process NEVER
    # exits on a dropped/refused conn — it backs off, keeps producing
    # sweeps into a bounded spool, and resends on reconnect
    ap.add_argument("--backoff-base", type=float, default=0.5,
                    help="first reconnect delay (doubles per failure)")
    ap.add_argument("--backoff-cap", type=float, default=30.0,
                    help="max reconnect delay")
    ap.add_argument("--connect-timeout", type=float, default=15.0,
                    help="dial deadline per connect attempt")
    ap.add_argument("--spool-mb", type=float, default=8.0,
                    help="outage sweep-spool bound (MB, drop-oldest)")
    args = ap.parse_args(argv)
    from gyeeta_tpu_torch.net.agent import NetAgent

    async def run():
        agents = [NetAgent(seed=args.seed + i, collect=args.collect,
                           real=args.real, livecap=args.livecap,
                           cap_ifname=args.cap_ifname,
                           connect_timeout=args.connect_timeout,
                           spool_max_bytes=int(args.spool_mb * 2**20),
                           env=os.environ)
                  for i in range(args.n_agents)]
        print(f"supervising {len(agents)} agent(s) -> "
              f"{args.host}:{args.port}", file=sys.stderr)
        # SIGTERM / SIGINT stop the supervisors between writes, so the
        # server never sees a half-written frame from a stopped agent
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (ValueError, RuntimeError):
                pass              # not the main thread: run until cancelled
        try:
            await asyncio.gather(*(
                a.run_forever(args.host, args.port,
                              interval=args.interval, n_conn=args.n_conn,
                              n_resp=args.n_resp,
                              backoff_base=args.backoff_base,
                              backoff_cap=args.backoff_cap, stop=stop)
                for a in agents))
        finally:
            for a in agents:
                await a.close()
        # the delivery ledger of each agent: records built = sent +
        # still buffered (spool and unconfirmed tail) + dropped
        json.dump({"agent_report": [agent_report(a) for a in agents]},
                  sys.stdout)
        sys.stdout.write("\n")
        sys.stdout.flush()

    asyncio.run(run())


def agent_report(a) -> dict:
    """One agent's identity and delivery ledger after its supervisor
    stopped (the ``agent`` command's exit report)."""
    return {"seed": a.seed, "machine_id": a.machine_id,
            "host_id": a.host_id, "sweep_seq": a._sweep_seq,
            "spool_len": a.spool_len(),
            "spool_records": a.spool_records(),
            "counters": {k: int(v) for k, v in a.stats.counters.items()},
            "livecap": {"enabled": a.livecap, "denied": a._cap_denied,
                        "ports": sorted(a._cap_ports),
                        "opens": a._cap_opens, "closes": a._cap_closes}}


def _cmd_chaos(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch chaos",
        description="deterministic fault-injection TCP proxy: point "
        "agents at --listen-port, upstream at the real server; faults "
        "are seeded + byte-offset keyed (reproducible)")
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=10039)
    ap.add_argument("--upstream-host", default="127.0.0.1")
    ap.add_argument("--upstream-port", type=int, default=10038)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default="",
                    help="comma list of corrupt,truncate,disconnect,"
                    "stall (empty = pass-through)")
    ap.add_argument("--mean-fault-kb", type=int, default=256,
                    help="mean bytes between injected faults (KB)")
    ap.add_argument("--stall-s", type=float, default=1.0)
    ap.add_argument("--latency-ms", type=float, default=0.0)
    ap.add_argument("--jitter-ms", type=float, default=0.0)
    ap.add_argument("--resplit", type=int, default=0,
                    help="re-split forwarded chunks to at most this "
                    "many bytes (0 = off)")
    ap.add_argument("--kill-at", type=float, default=0.0,
                    help="seconds after start to open a server-kill "
                    "window (drop + refuse all conns)")
    ap.add_argument("--kill-for", type=float, default=0.0,
                    help="kill-window duration (0 = no window)")
    ap.add_argument("--wedge-at", type=float, default=0.0,
                    help="seconds after start to open a WEDGE window "
                    "(stop forwarding both directions, conns stay "
                    "open — the stalled-not-dead upstream)")
    ap.add_argument("--wedge-for", type=float, default=0.0,
                    help="wedge-window duration (0 = no window)")
    ap.add_argument("--fault-both", action="store_true",
                    help="also fault the server->client direction "
                    "(responses / subscription pushes)")
    ap.add_argument("--latency-c2s-ms", type=float, default=None,
                    help="asymmetric latency, client->server "
                    "direction (overrides --latency-ms)")
    ap.add_argument("--latency-s2c-ms", type=float, default=None,
                    help="asymmetric latency, server->client "
                    "direction (overrides --latency-ms)")
    ap.add_argument("--partition-at", type=float, default=0.0,
                    help="seconds after start to open a PARTITION "
                    "window (both directions dropped, conns held)")
    ap.add_argument("--partition-for", type=float, default=0.0,
                    help="partition-window duration (0 = no window)")
    ap.add_argument("--report-interval", type=float, default=10.0)
    args = ap.parse_args(argv)

    from gyeeta_tpu_torch.sim.chaos import run_proxy

    async def run():
        # SIGTERM / SIGINT stop the proxy cleanly (its conns closed, its
        # fault counts printed)
        task = asyncio.create_task(run_proxy(args))
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, task.cancel)
            except (ValueError, RuntimeError):
                pass              # not the main thread: run until cancelled
        try:
            await task
        except asyncio.CancelledError:
            pass

    asyncio.run(run())


def _cmd_replay(argv) -> None:
    ap = argparse.ArgumentParser(prog="gyeeta_tpu_torch replay")
    ap.add_argument("capture", help="GYTREC capture file")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--speed", type=float, default=0.0,
                    help="0 = full speed; 1 = recorded pace")
    ap.add_argument("--host-offset", type=int, default=0)
    args = ap.parse_args(argv)

    async def run():
        from gyeeta_tpu_torch import version
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.net.agent import register
        from gyeeta_tpu_torch.utils import hashing as H
        from gyeeta_tpu_torch.utils import replay
        _, writer, status, _hid = await register(
            args.host, args.port,
            H.hash_bytes_np(b"gyt-replayer"), wire.CONN_EVENT,
            version.CURR_WIRE_VERSION)
        if status != wire.REG_OK:
            raise SystemExit(f"registration failed: {status}")
        # stream on the event loop with a drain per chunk: captures can
        # be many GB, so transport backpressure must gate the file read,
        # and a dropped conn must fail loudly, not buffer into the void.
        # A few MB in flight (not asyncio's 64 KB) let the server read
        # many recorded chunks at once: a fold boundary a read, not a
        # recorded chunk
        writer.transport.set_write_buffer_limits(high=4 << 20)
        from gyeeta_tpu_torch.utils.selfstats import Stats
        stats = Stats()
        n = 0
        try:
            for delay, chunk in replay.paced_chunks(
                    args.capture, args.speed, args.host_offset,
                    stats=stats):
                if delay > 0:
                    await asyncio.sleep(delay)
                writer.write(chunk)
                await writer.drain()
                n += len(chunk)
        except (ConnectionError, OSError) as e:
            raise SystemExit(f"server dropped the conn after {n} bytes: "
                             f"{e}")
        # the tail below drain's low-water mark must leave before exit
        writer.close()
        await writer.wait_closed()
        torn = int(stats.counters.get("replay_torn_tail", 0))
        print(f"replayed {n} bytes"
              + (" (capture tail torn — final partial chunk skipped)"
                 if torn else ""), file=sys.stderr)

    asyncio.run(run())


def _cmd_obs(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch obs",
        description="self-observability clients: 'top' renders the "
        "live selfstats/health/span surface; 'metrics' dumps the "
        "Prometheus exposition text")
    ap.add_argument("what", choices=("top", "metrics"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--interval", type=float, default=2.0,
                    help="top refresh cadence (seconds)")
    ap.add_argument("--once", action="store_true",
                    help="top: render one frame and exit")
    args = ap.parse_args(argv)

    async def run():
        from gyeeta_tpu_torch.net.agent import QueryClient
        from gyeeta_tpu_torch.obs import format_top
        qc = QueryClient()
        await qc.connect(args.host, args.port)
        try:
            if args.what == "metrics":
                out = await qc.query({"subsys": "metrics"})
                sys.stdout.write(out.get("text", ""))
                return
            prev, prev_t = None, 0.0
            while True:
                import time as _time
                ss = await qc.query({"subsys": "selfstats"})
                now = _time.time()
                frame = format_top(
                    ss, prev, (now - prev_t) if prev is not None else 0.0)
                if not args.once:
                    sys.stdout.write("\x1b[H\x1b[2J")   # clear screen
                sys.stdout.write(frame)
                sys.stdout.flush()
                if args.once:
                    return
                prev, prev_t = ss.get("counters", {}), now
                await asyncio.sleep(args.interval)
        finally:
            await qc.close()

    asyncio.run(run())


def _cmd_nm(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch nm",
        description="stock node-webserver (NM conn) clients: 'probe' "
        "runs the NM_CONNECT handshake plus one QUERY_WEB_JSON per "
        "subsystem and reports wire-level health; 'query' sends one "
        "raw QUERY_WEB_JSON/CRUD body over an NM conn")
    ap.add_argument("what", choices=("probe", "query"))
    ap.add_argument("request", nargs="?",
                    help="query: JSON body ({'qtype':..,'options':..} "
                    "or native {'subsys':..}), or '-' for stdin")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--subsys", default="serverstatus,hoststate,"
                    "svcstate,taskstate,alertdef",
                    help="probe: comma-separated subsystems to query")
    ap.add_argument("--crud", action="store_true",
                    help="probe: also run an alertdef create→list→"
                    "delete CRUD round trip")
    args = ap.parse_args(argv)

    async def run():
        from gyeeta_tpu_torch.sim.nodeweb import NMError, NodeWebSim
        nw = NodeWebSim(hostname="nm-probe")
        hs = await nw.connect(args.host, args.port)
        try:
            if args.what == "query":
                body = sys.stdin.read() if args.request == "-" \
                    else (args.request or "{}")
                req = json.loads(body)
                if req.get("op"):
                    out = await nw.crud_alert(req) \
                        if req.get("objtype") in ("alertdef", "silence",
                                                  "inhibit", "action") \
                        else await nw.crud_generic(req)
                else:
                    out = await nw.request(
                        2, req if "qtype" in req else
                        {"qtype": req.pop("subsys"), "options": req})
                json.dump(out, sys.stdout, default=str)
                sys.stdout.write("\n")
                return
            print(f"nm probe: connected — madhava "
                  f"{hs['madhava_name']!r} id {hs['madhava_id']:#x} "
                  f"version {hs['madhava_version']:#08x}",
                  file=sys.stderr)
            failed = 0
            for sub in args.subsys.split(","):
                sub = sub.strip()
                try:
                    # strong: the probe checks the LIVE wire+engine
                    # path end to end (the snapshot default would
                    # serve a possibly-empty boot-time view)
                    out = await nw.query_web(sub, maxrecs=1,
                                             consistency="strong")
                    print(f"  {sub:<14} ok  nrecs={out.get('nrecs')}",
                          file=sys.stderr)
                except NMError as e:
                    failed += 1
                    print(f"  {sub:<14} ERR {e}", file=sys.stderr)
            if args.crud:
                name = "nm-probe-def"
                await nw.crud_alert({
                    "op": "add", "objtype": "alertdef",
                    "alertname": name, "subsys": "svcstate",
                    "filter": "{ svcstate.state in 'Severe' }"})
                lst = await nw.query_web("alertdef")
                ok = any(r.get("alertname") == name
                         for r in lst.get("recs", []))
                await nw.crud_alert({"op": "delete",
                                     "objtype": "alertdef",
                                     "name": name})
                print(f"  alertdef CRUD round-trip "
                      f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
                failed += 0 if ok else 1
            if failed:
                raise SystemExit(f"nm probe: {failed} check(s) failed")
            print("nm probe: OK", file=sys.stderr)
        finally:
            await nw.close()

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


_COMMANDS = {"query": _cmd_query, "agent": _cmd_agent,
             "replay": _cmd_replay, "web": _cmd_web, "obs": _cmd_obs,
             "nm": _cmd_nm, "chaos": _cmd_chaos, "gateway": _cmd_gateway,
             "ship": _cmd_ship, "shiprecv": _cmd_shiprecv,
             "compact": _cmd_compact, "relay": _cmd_relay}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else None
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](argv[1:])
    if cmd == "serve":
        argv = argv[1:]
    from gyeeta_tpu_torch.server_main import main as serve_main
    serve_main(argv)


if __name__ == "__main__":
    main()
