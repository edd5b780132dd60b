"""Deterministic fault-injection tier: a chaos TCP proxy for the edge.

The reference proves its delivery continuity operationally (parmon
respawn loops, resend-inventory-on-reconnect — ``gypartha.cc:965``,
``gy_socket_stat.h:1235``); this tier proves ours in CI: a seeded
asyncio proxy sits between agents and the server and injects the
failure vocabulary of real networks —

- **corrupt**    flip one byte in flight (poison header / payload),
- **truncate**   drop the tail of the stream and close mid-frame,
- **disconnect** abrupt close at an arbitrary byte offset,
- **stall**      stop forwarding for a while (slow-loris; the conn
  stays open and silent — the idle/handshake reap's prey),
- chunk **re-splitting** (exercises partial-frame reassembly),
- added **latency/jitter** per forwarded chunk,
- coordinated **server-kill windows** (refuse + drop every conn —
  the proxy-side view of a dead server; test harnesses pair it with
  an actual server restart),
- **wedge windows**: stop forwarding in BOTH directions
  while keeping every conn open — the stalled-NOT-dead upstream, the
  hard fault-domain case: requests are accepted, responses never
  come, and no conn error ever fires (circuit breakers see nothing
  until a timeout; hedged reads are what bound the latency). Also a
  manual ``proxy.wedged`` toggle for harness-driven schedules,
- **asymmetric latency/jitter**: per-direction delays
  (``latency_c2s_s``/``latency_s2c_s``) — the WAN shape where the ask
  path and the answer path cost differently,
- **partition windows**: bytes in BOTH directions are
  silently DROPPED (counted) while every conn stays open — unlike a
  wedge the bytes never arrive, so a healed stream is torn mid-frame
  and the endpoints' resync machinery (frame-error close, counted
  relay gaps, subscription resyncs) must recover; also a manual
  ``proxy.partitioned`` toggle,
- **region-kill scheduling**: :class:`RegionKill` drives
  kill/restart callbacks on deterministic windows — the harness-side
  clock for region-wide SIGKILL campaigns.

A fault-domain campaign points these at the INTER-TIER hops
(gateway→replica, subscription client→gateway) as well as the
original agent↔server edge — ``fault_both=True`` faults the
server→client direction too (responses, pushes).

Determinism: every fault decision derives from a seeded
:class:`FaultPlan` keyed by (seed, conn index) and **byte offsets**,
not wall clock or chunk timing — the same plan against the same byte
stream injects the same faults at the same positions.

Operator CLI: ``python -m gyeeta_tpu_torch chaos --upstream-port 10038
--listen-port 10039 --faults corrupt,stall`` — point agents at the
proxy port and watch the hardening counters on /metrics.

Counterpart of ``gyeeta_tpu/sim/chaos.py``: the same seeded plans give the
same fault schedules, byte for byte.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import random
from typing import Iterable, Optional

log = logging.getLogger("gyeeta_tpu_torch.chaos")

_CHUNK = 1 << 16

FAULT_KINDS = ("corrupt", "truncate", "disconnect", "stall")


class FaultPlan:
    """Seeded, reproducible fault schedule.

    ``conn_faults(conn_idx)`` yields ``(byte_offset, kind)`` events for
    the agent→server direction of the ``conn_idx``-th accepted conn;
    offsets are spaced ~exponentially with mean ``mean_fault_bytes``.
    ``latency_s``/``jitter_s`` delay every forwarded chunk; ``resplit``
    re-splits forwarded chunks into smaller writes (max size drawn per
    chunk). ``kill_windows`` are (start_s, end_s) intervals relative to
    proxy start during which ALL conns are dropped and new ones
    refused.
    """

    def __init__(self, seed: int = 0,
                 fault_kinds: Iterable[str] = (),
                 mean_fault_bytes: int = 1 << 18,
                 first_fault_bytes: Optional[int] = None,
                 stall_s: float = 1.0,
                 latency_s: float = 0.0,
                 jitter_s: float = 0.0,
                 resplit: int = 0,
                 kill_windows: Iterable[tuple] = (),
                 wedge_windows: Iterable[tuple] = (),
                 fault_both: bool = False,
                 latency_c2s_s: Optional[float] = None,
                 latency_s2c_s: Optional[float] = None,
                 jitter_c2s_s: Optional[float] = None,
                 jitter_s2c_s: Optional[float] = None,
                 partition_windows: Iterable[tuple] = ()):
        self.seed = seed
        self.fault_kinds = tuple(fault_kinds)
        for k in self.fault_kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r} "
                                 f"(known: {FAULT_KINDS})")
        self.mean_fault_bytes = int(mean_fault_bytes)
        self.first_fault_bytes = first_fault_bytes
        self.stall_s = stall_s
        self.latency_s = latency_s
        self.jitter_s = jitter_s
        self.resplit = int(resplit)
        self.kill_windows = tuple((float(a), float(b))
                                  for a, b in kill_windows)
        # (start_s, end_s) intervals during which the proxy forwards
        # NOTHING in either direction but keeps every conn open — a
        # stalled (wedged) upstream, not a dead one
        self.wedge_windows = tuple((float(a), float(b))
                                   for a, b in wedge_windows)
        # fault the server→client direction too (responses/pushes):
        # the inter-tier hops fail on the answer path as often as the
        # ask path
        self.fault_both = bool(fault_both)
        # asymmetric WAN shape: per-direction latency/jitter override
        # the symmetric knobs when set (None = inherit)
        self.latency_c2s_s = latency_c2s_s
        self.latency_s2c_s = latency_s2c_s
        self.jitter_c2s_s = jitter_c2s_s
        self.jitter_s2c_s = jitter_s2c_s
        # (start_s, end_s) intervals during which BOTH directions are
        # silently dropped (counted) while every conn stays open — a
        # network partition, not a stall: the bytes never arrive
        self.partition_windows = tuple((float(a), float(b))
                                       for a, b in partition_windows)

    def _rng(self, conn_idx: int, salt: int = 0) -> random.Random:
        # int-mixed seed (tuple seeding is deprecated and hash-based)
        return random.Random(((self.seed * 1_000_003 + conn_idx)
                              * 8191 + salt) & 0x7FFFFFFFFFFF)

    def conn_faults(self, conn_idx: int, max_events: int = 4096):
        """Deterministic (byte_offset, kind) schedule for one conn."""
        if not self.fault_kinds:
            return
        rng = self._rng(conn_idx, salt=1)
        off = self.first_fault_bytes if self.first_fault_bytes \
            is not None else int(rng.expovariate(
                1.0 / self.mean_fault_bytes)) + 64
        for _ in range(max_events):
            yield int(off), rng.choice(self.fault_kinds)
            off += int(rng.expovariate(1.0 / self.mean_fault_bytes)) + 64

    def in_kill_window(self, t_rel: float) -> bool:
        return any(a <= t_rel < b for a, b in self.kill_windows)

    def in_wedge_window(self, t_rel: float) -> bool:
        return any(a <= t_rel < b for a, b in self.wedge_windows)

    def in_partition_window(self, t_rel: float) -> bool:
        return any(a <= t_rel < b for a, b in self.partition_windows)

    def latency_for(self, direction: str) -> float:
        v = self.latency_c2s_s if direction == "c2s" \
            else self.latency_s2c_s
        return self.latency_s if v is None else float(v)

    def jitter_for(self, direction: str) -> float:
        v = self.jitter_c2s_s if direction == "c2s" \
            else self.jitter_s2c_s
        return self.jitter_s if v is None else float(v)


class ChaosProxy:
    """Seeded fault-injecting TCP proxy (agent side → ``listen``,
    server side → ``upstream``). ``upstream`` is mutable — a restarted
    server on a new port just reassigns it. ``stats`` counts injected
    faults by kind (the harness's ground truth for accounting)."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: Optional[FaultPlan] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream_host, upstream_port)
        self.plan = plan or FaultPlan()
        self.host, self.port = host, port
        self.refusing = False         # manual server-kill coordination
        self.wedged = False           # manual stalled-upstream toggle
        self.partitioned = False      # manual partition toggle
        self.stats: collections.Counter = collections.Counter()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()      # live (cwriter, uwriter) pairs
        self._n_accepted = 0
        self._t0 = 0.0
        self._kill_task: Optional[asyncio.Task] = None
        self._was_partitioned = False

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> tuple[str, int]:
        loop = asyncio.get_running_loop()
        self._t0 = loop.time()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        if self.plan.kill_windows or self.plan.wedge_windows \
                or self.plan.partition_windows:
            self._kill_task = asyncio.create_task(self._kill_monitor())
        log.info("chaos proxy on %s:%d -> %s:%d (faults=%s seed=%d)",
                 self.host, self.port, *self.upstream,
                 ",".join(self.plan.fault_kinds) or "none",
                 self.plan.seed)
        return self.host, self.port

    async def stop(self) -> None:
        if self._kill_task:
            self._kill_task.cancel()
            self._kill_task = None
        if self._server:
            self._server.close()
            self.drop_all()
            await self._server.wait_closed()
            self._server = None

    def drop_all(self) -> None:
        """Abort every live conn (both halves) — the server-kill edge."""
        for cw, uw in list(self._conns):
            for w in (cw, uw):
                try:
                    w.close()
                except Exception:     # pragma: no cover
                    pass
        self.stats["dropped_conns"] += len(self._conns)

    async def _kill_monitor(self) -> None:
        loop = asyncio.get_running_loop()
        was = False
        was_wedged = False
        while True:
            await asyncio.sleep(0.05)
            now = loop.time() - self._t0
            inwin = self.plan.in_kill_window(now)
            if inwin and not was:
                log.info("chaos: kill window opens at t=%.2fs", now)
                self.refusing = True
                self.drop_all()
            elif was and not inwin:
                log.info("chaos: kill window closes at t=%.2fs", now)
                self.refusing = False
            was = inwin
            inwedge = self.plan.in_wedge_window(now)
            if inwedge and not was_wedged:
                log.info("chaos: wedge window opens at t=%.2fs", now)
                self.wedged = True
                self.stats["wedge_spans"] += 1
            elif was_wedged and not inwedge:
                log.info("chaos: wedge window closes at t=%.2fs", now)
                self.wedged = False
            was_wedged = inwedge
            inpart = self.plan.in_partition_window(now)
            if inpart and not self._was_partitioned:
                log.info("chaos: partition opens at t=%.2fs", now)
                self.partitioned = True
                self.stats["partition_spans"] += 1
            elif self._was_partitioned and not inpart:
                log.info("chaos: partition heals at t=%.2fs", now)
                self.partitioned = False
            self._was_partitioned = inpart

    # ------------------------------------------------------------- conn path
    async def _handle(self, creader, cwriter) -> None:
        idx = self._n_accepted
        self._n_accepted += 1
        if self.refusing:
            self.stats["refused_conns"] += 1
            cwriter.close()
            return
        try:
            ureader, uwriter = await asyncio.open_connection(
                *self.upstream)
        except OSError:
            self.stats["refused_conns"] += 1
            cwriter.close()
            return
        pair = (cwriter, uwriter)
        self._conns.add(pair)
        try:
            c2s = asyncio.create_task(self._pump(
                creader, uwriter, idx, faulted=True,
                direction="c2s"))
            s2c = asyncio.create_task(self._pump(
                ureader, cwriter, idx,
                faulted=self.plan.fault_both, direction="s2c"))
            done, pending = await asyncio.wait(
                {c2s, s2c}, return_when=asyncio.FIRST_COMPLETED)
            for t in pending:
                t.cancel()
            for t in pending:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        finally:
            self._conns.discard(pair)
            for w in (cwriter, uwriter):
                try:
                    w.close()
                except Exception:     # pragma: no cover
                    pass

    async def _pump(self, reader, writer, conn_idx: int,
                    faulted: bool, direction: str = "c2s") -> None:
        """Forward bytes one direction, applying the plan's faults
        (agent→server only) plus latency/jitter/re-splitting."""
        plan = self.plan
        rng = plan._rng(conn_idx, salt=2 if faulted else 3)
        faults = plan.conn_faults(conn_idx) if faulted else iter(())
        next_off, kind = next(faults, (None, None))
        offset = 0
        try:
            while True:
                data = await reader.read(_CHUNK)
                if not data:
                    return
                while data:
                    if next_off is not None and \
                            offset + len(data) > next_off:
                        cut = max(0, next_off - offset)
                        pre, at = data[:cut], data[cut:]
                        if pre:
                            await self._fwd(writer, pre, rng, direction)
                            offset += len(pre)
                        self.stats[kind] += 1
                        if kind == "corrupt":
                            # flip every bit of ONE byte in flight
                            bad = bytes([at[0] ^ 0xFF]) + at[1:]
                            await self._fwd(writer, bad, rng, direction)
                            offset += len(bad)
                            data = b""
                        elif kind == "stall":
                            # hold the stream: conn open, bytes parked
                            await asyncio.sleep(plan.stall_s)
                            data = at
                        elif kind == "truncate":
                            # tail vanishes, then the conn does
                            return
                        else:                     # disconnect
                            return
                        next_off, kind = next(faults, (None, None))
                    else:
                        await self._fwd(writer, data, rng, direction)
                        offset += len(data)
                        data = b""
        except (ConnectionError, OSError):
            return

    async def _fwd(self, writer, data: bytes, rng: random.Random,
                   direction: str = "c2s") -> None:
        plan = self.plan
        # partitioned: the bytes are GONE (counted), the conn is not —
        # a healed stream resumes torn mid-frame and the endpoints'
        # resync machinery must recover, counted, never silently
        if self.partitioned:
            self.stats["partition_dropped_chunks"] += 1
            self.stats["partition_dropped_bytes"] += len(data)
            return
        # wedged: park (conn open, bytes held) until the toggle/window
        # clears — the stalled-not-dead upstream both directions see
        if self.wedged:
            self.stats["wedged_chunks"] += 1
            t0 = asyncio.get_running_loop().time()
            while self.wedged:
                await asyncio.sleep(0.02)
            self.stats["wedged_s"] += round(
                asyncio.get_running_loop().time() - t0, 3)
        step = len(data)
        if plan.resplit:
            step = rng.randint(max(1, plan.resplit // 4), plan.resplit)
        lat = plan.latency_for(direction)
        jit = plan.jitter_for(direction)
        for i in range(0, len(data), step):
            if lat or jit:
                self.stats[f"delayed_chunks_{direction}"] += 1
                await asyncio.sleep(lat + jit * rng.random())
            writer.write(data[i: i + step])
            await writer.drain()


class RegionKill:
    """Deterministic region-wide kill scheduler: at each
    window's OPEN edge call ``kill_cb`` (the harness SIGKILLs the
    region's processes), at its CLOSE edge call ``restart_cb`` (the
    harness respawns them). Pure ``in_window(t_rel)`` carries the
    schedule so unit tests cover edge semantics without a clock;
    :meth:`run` polls a real clock and fires the callbacks exactly
    once per edge (``stats['region_kills']``/``['region_restarts']``
    are the ground truth for the campaign's accounting). Callbacks
    may be sync or async; the task finishes once every window has
    closed and fired."""

    def __init__(self, windows: Iterable[tuple], kill_cb=None,
                 restart_cb=None, poll_s: float = 0.05):
        self.windows = tuple(sorted((float(a), float(b))
                                    for a, b in windows))
        for a, b in self.windows:
            if b <= a:
                raise ValueError(f"empty region-kill window {a}..{b}")
        self.kill_cb = kill_cb
        self.restart_cb = restart_cb
        self.poll_s = float(poll_s)
        self.stats: collections.Counter = collections.Counter()

    def in_window(self, t_rel: float) -> bool:
        return any(a <= t_rel < b for a, b in self.windows)

    @property
    def end(self) -> float:
        return max((b for _a, b in self.windows), default=0.0)

    async def _fire(self, cb) -> None:
        if cb is None:
            return
        out = cb()
        if asyncio.iscoroutine(out):
            await out

    async def run(self, t0: Optional[float] = None) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time() if t0 is None else t0
        was = False
        while True:
            now = loop.time() - t0
            inwin = self.in_window(now)
            if inwin and not was:
                log.info("chaos: region kill at t=%.2fs", now)
                self.stats["region_kills"] += 1
                await self._fire(self.kill_cb)
            elif was and not inwin:
                log.info("chaos: region restart at t=%.2fs", now)
                self.stats["region_restarts"] += 1
                await self._fire(self.restart_cb)
            was = inwin
            if not inwin and now >= self.end:
                return
            await asyncio.sleep(self.poll_s)


async def run_proxy(args) -> None:
    """CLI driver: run the proxy until interrupted, reporting injected
    fault counts on a cadence, and as one JSON line on stdout at the
    stop."""
    plan = FaultPlan(
        seed=args.seed,
        fault_kinds=[f for f in args.faults.split(",") if f]
        if args.faults else (),
        mean_fault_bytes=args.mean_fault_kb << 10,
        stall_s=args.stall_s,
        latency_s=args.latency_ms / 1e3,
        jitter_s=args.jitter_ms / 1e3,
        resplit=args.resplit,
        kill_windows=[(args.kill_at, args.kill_at + args.kill_for)]
        if args.kill_for > 0 else (),
        wedge_windows=[(args.wedge_at,
                        args.wedge_at + args.wedge_for)]
        if getattr(args, "wedge_for", 0) > 0 else (),
        fault_both=getattr(args, "fault_both", False),
        latency_c2s_s=(args.latency_c2s_ms / 1e3
                       if getattr(args, "latency_c2s_ms", None)
                       is not None else None),
        latency_s2c_s=(args.latency_s2c_ms / 1e3
                       if getattr(args, "latency_s2c_ms", None)
                       is not None else None),
        partition_windows=[(args.partition_at,
                            args.partition_at + args.partition_for)]
        if getattr(args, "partition_for", 0) > 0 else ())
    proxy = ChaosProxy(args.upstream_host, args.upstream_port, plan,
                       host=args.listen_host, port=args.listen_port)
    host, port = await proxy.start()
    print(f"chaos proxy on {host}:{port} -> "
          f"{args.upstream_host}:{args.upstream_port}", flush=True)
    try:
        while True:
            await asyncio.sleep(args.report_interval)
            if proxy.stats:
                log.info("chaos stats %s", dict(proxy.stats))
    finally:
        await proxy.stop()
        # the injected faults by kind: the ground truth a harness holds
        # the endpoints' counters against
        print(json.dumps({"chaos_stats": dict(proxy.stats)}), flush=True)
