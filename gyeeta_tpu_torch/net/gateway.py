"""Query-fabric gateway: fan-in proxy + distributed edge cache + push.

Counterpart of ``gyeeta_tpu/net/gateway.py``. The serving edge is
snapshot-isolated and cached PER PROCESS, but dashboards still poll ONE
replica, and every replica renders the same snapshot independently.
This tier is the multiplier: a thin asyncio proxy that speaks the
EXISTING query edges on the front and fans out to N serve replicas
(the port's ``GytServer`` over a ``Runtime`` on the GPU) on the back,
with the render shared fleet-wide:

- **One port, three dialects** (magic-peeked like ``GytServer``):
  HTTP/REST (``POST /query``, ``GET /v1/<subsys>``, SSE
  ``GET /v1/subscribe``, ``/metrics``, ``/healthz``), the GYT binary
  query protocol (``COMM_QUERY_CMD`` + the ``COMM_SUBSCRIBE_CMD``
  stream), and the stock NM node-webserver dialect
  (``net/nmhandle.py`` — a stock Node tier can point at a gateway
  unchanged).

- **(snaptick, request-hash) edge cache**: every snapshot-tier
  response already carries ``snaptick`` — the designed distributed
  cache key. Requests key through the SAME normalizer as the
  replica-side result cache (``query/normalize.request_key``), entries
  live in an in-gateway LRU, and invalidation is BY TICK ADVANCE (a
  new tick is a new key; old entries age out of the LRU) — no
  invalidation protocol at all. SINGLE-FLIGHT collapse at the (tick,
  key) level means a dashboard stampede onto a fresh tick renders each
  distinct query exactly once per gateway; the peer exchange (below)
  makes that once per FLEET. Upstream error envelopes negative-cache
  for ``GYT_GW_NEG_TTL_S`` so a bad query in a dashboard loop cannot
  hammer the replicas.

- **Peer exchange**: gateways gossip results, not liveness — on a
  local miss the gateway asks the key's rendezvous owner for (tick,
  key) over a tiny HTTP POST (``/gw/peer``) before rendering upstream;
  the owner answers from its cache, WAITING on its own in-flight
  single-flight render if one is running, or renders itself. A result
  rendered once serves the whole tier.

- **Push subscriptions** (``net/subs.py``): the gateway polls each
  upstream's ``serverstatus`` once per tick (ONE cheap cached query
  per upstream per tick — not per client), and when ``snaptick``
  advances it re-renders each subscribed query once THROUGH the edge
  cache, diffs against the last delivered version
  (``query/delta.py``), and pushes the delta to every subscriber —
  REST SSE and GYT binary both.

- **Fault domains**: every upstream carries a circuit breaker — EWMA
  latency + a consecutive-failure count with a K-failure threshold
  (``down_after``; ONE bad poll never marks a replica down), half-open
  probing on a jittered exponential backoff, and per-upstream state on
  the labeled ``gyt_gw_upstream_state{upstream,state}`` gauge family
  (flaps counted in ``gyt_gw_upstream_flaps_total{upstream}``).
  Renders fail over health-ordered — live replicas first, marked-down
  ones tried LAST rather than never, so a fabric with >=1 live replica
  never surfaces an upstream error — and a render that exceeds the
  hedge latency budget (``hedge_ms``) fires the same request at the
  next-healthiest replica, first response wins. Subscription state
  survives gateway restarts via the hub's persisted version ring
  (``sub_persist``, ``net/subs.py``).

- **Hub mode**: the upstreams are a PEER REGION's gateways and this
  gateway FETCHES from their subscription streams instead of polling
  per tick — every local panel rides ONE inter-region delta stream per
  key (the ``gyt_gw_region_*`` families).

The gateway touches no device: it can run on any box between the
dashboards and the replicas, and N gateways scale the query edge
without touching the fold tier. Its own ``Stats`` registry renders at
``GET /metrics`` as the ``gyt_gw_*`` families. Every knob is a
constructor argument; one left ``None`` is read from the ``env``
mapping (``GYT_GW_*``, the reference's names), and without one it takes
the reference's default — the module reads no environment of its own.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import time
import urllib.parse
from collections import OrderedDict
from typing import Optional

from gyeeta_tpu_torch.net.agent import QueryClient
from gyeeta_tpu_torch.query.normalize import request_key
from gyeeta_tpu_torch.utils.selfstats import Stats

log = logging.getLogger("gyeeta_tpu_torch.net.gateway")

_MAX_BODY = 8 << 20
_MAX_HDR = 64 << 10

# the tick-watch poll request: answered from the replica's snapshot
# result cache after the first ask per tick (~a dict lookup upstream)
_POLL_REQ = {"subsys": "serverstatus", "maxrecs": 1}


def _envf(env, name: str, default: float) -> float:
    try:
        return float(env.get(name, default))
    except ValueError:
        return default


def _envi(env, name: str, default: int) -> int:
    try:
        return int(env.get(name, default))
    except ValueError:
        return default


class _Upstream:
    """One serve replica: a small checkout pool of query conns, the
    watcher's last-seen snaptick, and the circuit-breaker health
    state — EWMA latency, a consecutive-failure count (K failures
    before mark-down, never one bad poll), and half-open probing on
    a jittered exponential backoff."""

    def __init__(self, host: str, port: int, nconns: int,
                 stats: Optional[Stats] = None, down_after: int = 3,
                 probe_base_s: float = 1.0, probe_max_s: float = 15.0):
        self.host, self.port = host, int(port)
        self.label = f"{host}:{int(port)}"
        self.tick = -1
        self.tick_at = 0.0
        self.stats = stats
        self.state = "up"           # up | down | half_open
        self.fails = 0              # CONSECUTIVE failures
        self.ewma_ms: Optional[float] = None
        self.down_after = max(1, int(down_after))
        self.probe_base_s = float(probe_base_s)
        self.probe_max_s = float(probe_max_s)
        self.backoff_s = self.probe_base_s
        self.probe_at = 0.0
        self._pool: asyncio.Queue = asyncio.Queue()
        for _ in range(max(1, nconns)):
            self._pool.put_nowait(None)
        self._gauge_state()

    # ------------------------------------------------------- circuit
    @property
    def up(self) -> bool:
        return self.state == "up"

    def _gauge_state(self) -> None:
        if self.stats is None:
            return
        for st in ("up", "down", "half_open"):
            self.stats.gauge(
                f"gw_upstream_state|upstream={self.label},state={st}",
                1.0 if st == self.state else 0.0)
        if self.ewma_ms is not None:
            self.stats.gauge(
                f"gw_upstream_ewma_ms|upstream={self.label}",
                round(self.ewma_ms, 3))

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self._gauge_state()

    def record_ok(self, lat_ms: float) -> None:
        self.ewma_ms = lat_ms if self.ewma_ms is None \
            else 0.7 * self.ewma_ms + 0.3 * lat_ms
        self.fails = 0
        self.backoff_s = self.probe_base_s
        if self.state != "up":
            if self.stats is not None:
                self.stats.bump("gw_upstream_recoveries"
                                f"|upstream={self.label}")
            self._set_state("up")
        else:
            self._gauge_state()         # refresh the EWMA gauge

    def record_fail(self) -> None:
        self.fails += 1
        if self.state == "up":
            if self.fails < self.down_after:
                return                  # the one-bad-poll fix: wait K
            if self.stats is not None:
                self.stats.bump("gw_upstream_flaps"
                                f"|upstream={self.label}")
            self._set_state("down")
            self._arm_probe()
            return
        # a failed half-open probe (or a failed last-resort attempt):
        # stay down, back off further
        self._set_state("down")
        self.backoff_s = min(self.backoff_s * 2.0, self.probe_max_s)
        self._arm_probe()

    def _arm_probe(self) -> None:
        import random as _r
        self.probe_at = time.monotonic() \
            + self.backoff_s * (0.5 + _r.random())

    def probe_due(self) -> bool:
        return self.state != "down" or time.monotonic() >= self.probe_at

    # ---------------------------------------------------------- pool
    async def checkout(self, timeout: float) -> QueryClient:
        qc = await self._pool.get()
        if qc is None:
            qc = QueryClient(request_timeout=timeout)
            try:
                await qc.connect(self.host, self.port)
            except BaseException:
                self._pool.put_nowait(None)
                raise
        return qc

    def checkin(self, qc: Optional[QueryClient]) -> None:
        self._pool.put_nowait(qc)

    async def discard(self, qc: QueryClient) -> None:
        self._pool.put_nowait(None)
        try:
            await qc.close()
        except Exception:       # noqa: BLE001
            pass


#: SubscribeStream counter -> gateway stat, folded as deltas per relay
_HUB_FOLD = (("events", "gw_region_events"),
             ("event_bytes", "gw_region_event_bytes"),
             ("resyncs", "gw_region_resyncs"),
             ("forced_resyncs", "gw_region_forced_resyncs"),
             ("reconnects", "gw_region_reconnects"),
             ("stalls", "gw_region_stalls"),
             ("conn_errors", "gw_region_conn_errors"),
             ("conn_lost", "gw_region_conn_lost"))


class _HubRelay:
    """One inter-region subscription: a supervised
    :class:`~gyeeta_tpu_torch.net.subs.SubscribeStream` to the peer region's
    gateway front, holding the latest FULL response for its key. The
    local ``SubscriptionHub`` fetches from the held version, so every
    local dashboard subscriber and CQ group on this key rides ONE WAN
    delta stream; a WAN gap surfaces as the stream's counted, in-band
    ``resync`` full (``gyt_gw_region_resyncs_total``), never as silent
    divergence, and inter-region bytes follow delta churn
    (``gyt_gw_region_event_bytes_total``), not panel size."""

    __slots__ = ("gw", "key", "req", "held", "tick", "last_used",
                 "stream", "task", "_folded", "_advanced")

    def __init__(self, gw: "FabricGateway", req: dict, key: str):
        from gyeeta_tpu_torch.net.subs import SubscribeStream
        self.gw, self.key = gw, key
        self.req = {k: v for k, v in req.items()
                    if k not in ("last_snaptick", "subscribe")}
        self.held: Optional[dict] = None
        self.tick = -1
        self.last_used = time.monotonic()
        self._folded: collections.Counter = collections.Counter()
        self._advanced = asyncio.Event()
        self.stream = SubscribeStream(
            [(u.host, u.port) for u in gw.upstreams], self.req,
            stall_timeout=gw.hub_stall_s)
        self.task = asyncio.create_task(self._run())

    def done(self) -> bool:
        return self.task.done()

    def stop(self) -> None:
        self.stream.stop()
        self.task.cancel()

    def fold(self) -> None:
        """Publish the stream's counter DELTAS since the last fold
        onto the gateway's gyt_gw_region_* families."""
        c = self.stream.counters
        for src, dst in _HUB_FOLD:
            d = c[src] - self._folded[src]
            if d:
                self.gw.stats.bump(dst, d)
                self._folded[src] = c[src]

    async def _run(self) -> None:
        try:
            async for resp in self.stream.responses():
                self.held = resp
                st = resp.get("snaptick")
                if st is not None and int(st) > self.tick:
                    self.tick = int(st)
                ev, self._advanced = self._advanced, asyncio.Event()
                ev.set()
                self.fold()
                self.gw._hub_advance(self.tick)     # noqa: SLF001
        except asyncio.CancelledError:
            raise
        except Exception:       # noqa: BLE001 — relay dies visibly
            self.gw.stats.bump("gw_region_relay_errors")
            log.exception("hub relay %s failed", self.key)

    async def current(self, target: int, settle_s: float,
                      first_s: float) -> Optional[dict]:
        """The latest held full, waiting (bounded) for the relay to
        reach ``target``: ``first_s`` budget before the FIRST full
        (a fresh WAN subscribe), ``settle_s`` for a tick to land.
        Returns whatever is held when the budget runs out — a lagging
        view, or None when the WAN is down before the first full."""
        t0 = time.monotonic()
        while self.held is None or self.tick < target:
            budget = (first_s if self.held is None else settle_s) \
                - (time.monotonic() - t0)
            if budget <= 0 or self.done():
                break
            ev = self._advanced
            try:
                await asyncio.wait_for(ev.wait(), budget)
            except (asyncio.TimeoutError, TimeoutError):
                break
        return self.held


class FabricGateway:
    def __init__(self, upstreams, host: str = "127.0.0.1",
                 port: int = 0, peers=(), stats: Optional[Stats] = None,
                 poll_s: Optional[float] = None,
                 cache_max: Optional[int] = None,
                 neg_ttl_s: Optional[float] = None,
                 peer_timeout_s: Optional[float] = None,
                 upstream_conns: Optional[int] = None,
                 upstream_timeout_s: float = 30.0,
                 write_timeout: float = 10.0,
                 down_after: Optional[int] = None,
                 hedge_ms: Optional[float] = None,
                 sub_persist: Optional[str] = None,
                 advertise: Optional[str] = None,
                 hub: bool = False, env=None):
        """``env``: the ``GYT_GW_*`` mapping read for every knob left
        ``None`` (``None`` = no environment: the defaults)."""
        env = {} if env is None else env
        self.host, self.port = host, int(port)
        self.stats = stats if stats is not None else Stats()
        # hub mode: ``upstreams`` are a PEER REGION's
        # gateways and this gateway FETCHES from their subscription
        # stream instead of polling per tick — every local panel and
        # CQ group rides ONE inter-region delta stream per key
        # (gyt_gw_region_* families). One-shot / historical queries
        # still pass through the same pooled query conns.
        self.hub = bool(hub)
        self.hub_stall_s = _envf(env, "GYT_GW_HUB_STALL_S", 10.0)
        self.hub_settle_s = _envf(env, "GYT_GW_HUB_SETTLE_S", 0.5)
        self.hub_first_s = _envf(env, "GYT_GW_HUB_FIRST_S", 15.0)
        self.hub_idle_s = _envf(env, "GYT_GW_HUB_IDLE_S", 60.0)
        self._hub_relays: dict = {}             # key -> _HubRelay
        self._hub_tick = -1
        self._hub_kick = asyncio.Event()
        self._hub_hb_key = request_key(dict(_POLL_REQ))
        # peer-exchange tick floor (owner-tick poll-skew fix): when a
        # peer asks us — the rendezvous owner — for a tick our own
        # poller has not seen yet, ADOPT it. The fabric already
        # reached that tick (the asker saw it on its replica), so
        # rendering under our stale tick would alias the result where
        # the asker never looks (peer_hits=0).
        self._tick_floor = -1
        # circuit-breaker + hedge knobs: K consecutive failures before an
        # upstream is marked down; latency budget past which a render
        # hedges to the next-healthiest replica (0 disables hedging)
        self.down_after = _envi(env, "GYT_GW_DOWN_AFTER", 3) \
            if down_after is None else int(down_after)
        self.hedge_ms = _envf(env, "GYT_GW_HEDGE_MS", 75.0) \
            if hedge_ms is None else float(hedge_ms)
        self.probe_base_s = _envf(env, "GYT_GW_PROBE_BASE_S", 1.0)
        self.probe_max_s = _envf(env, "GYT_GW_PROBE_MAX_S", 15.0)
        # the identity PEERS route to this gateway under (rendezvous
        # owner hashing needs every fleet member to rank the same
        # ident for this process its peers dial)
        self.advertise = advertise or env.get("GYT_GW_ADVERTISE")
        self.poll_s = _envf(env, "GYT_GW_POLL_S", 0.5) \
            if poll_s is None else float(poll_s)
        self.cache_max = _envi(env, "GYT_GW_CACHE_MAX", 4096) \
            if cache_max is None else int(cache_max)
        self.neg_ttl_s = _envf(env, "GYT_GW_NEG_TTL_S", 2.0) \
            if neg_ttl_s is None else float(neg_ttl_s)
        self.peer_timeout_s = _envf(env, "GYT_GW_PEER_TIMEOUT_S", 0.5) \
            if peer_timeout_s is None else float(peer_timeout_s)
        nconns = _envi(env, "GYT_GW_UPSTREAM_CONNS", 2) \
            if upstream_conns is None else int(upstream_conns)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.write_timeout = float(write_timeout)
        self.upstreams = [
            _Upstream(h, p, nconns, stats=self.stats,
                      down_after=self.down_after,
                      probe_base_s=self.probe_base_s,
                      probe_max_s=self.probe_max_s)
            for h, p in upstreams]
        if not self.upstreams:
            raise ValueError("gateway needs at least one upstream")
        self.peers = [(h, int(p)) for h, p in peers]
        self._peer_conns: dict = {}       # (h,p) -> [reader,writer,lock]
        self._rr = 0
        self._server = None
        self._tasks: list = []
        # (tick, key) -> ["ok", resp, body|None] | ["neg", msg, expiry]
        self._cache: OrderedDict = OrderedDict()
        self._flight: dict = {}           # (tick, key) -> Future
        # historical edge cache: at=/window= responses whose anchor
        # lies INSIDE compaction coverage are immutable by
        # construction — no TTL, invalidation never (LRU bound only);
        # keyed by normalized request + aliased under the RESOLVED
        # tick (gyt_gw_hist_cache_* family)
        self._hist_cache: OrderedDict = OrderedDict()
        self.hist_cache_max = _envi(env, "GYT_GW_HIST_CACHE_MAX", 4096)
        self._pushed_tick = -1
        self._pushing = False
        import secrets as _sec
        self._madhava_id = _sec.randbits(63) | 1   # NM-front identity
        from gyeeta_tpu_torch.net import subs as SB
        from gyeeta_tpu_torch.net.qexec import JsonRenderPool
        self._render = JsonRenderPool(stats=self.stats)
        self.subs = SB.SubscriptionHub(
            self._hub_fetch if self.hub else self.query, self.stats,
            history=SB.sub_history(env),
            max_ratio=SB.delta_max_ratio(env),
            retain=SB.retain_keys(env),
            persist_max=SB.persist_max_bytes(env),
            persist_path=sub_persist
            or env.get("GYT_GW_SUB_PERSIST") or None)

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> tuple:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.host, self.port = addr[0], addr[1]
        if self.hub:
            # no per-tick WAN polls: the remote tick arrives on the
            # heartbeat relay inside _hub_drive
            self._tasks = [asyncio.create_task(self._hub_drive())]
        else:
            self._tasks = [asyncio.create_task(self._watch_upstream(u))
                           for u in self.upstreams]
        log.info("fabric gateway on %s:%d -> %d upstream(s), "
                 "%d peer(s)%s", self.host, self.port,
                 len(self.upstreams), len(self.peers),
                 " [hub]" if self.hub else "")
        return self.host, self.port

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        for rel in self._hub_relays.values():
            rel.stop()
        self._hub_relays.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for u in self.upstreams:
            while not u._pool.empty():        # noqa: SLF001
                qc = u._pool.get_nowait()     # noqa: SLF001
                if qc is not None:
                    await qc.close()
        for ent in self._peer_conns.values():
            if ent[1] is not None:
                ent[1].close()
        self._peer_conns.clear()
        self.subs.close()
        self._render.close()

    # ------------------------------------------------------------- upstream
    @property
    def fabric_tick(self) -> int:
        t = max((u.tick for u in self.upstreams), default=-1)
        if self._hub_tick > t:          # hub mode: the relay's view
            t = self._hub_tick
        if self._tick_floor > t:        # peer-adopted (poll skew)
            t = self._tick_floor
        return t

    # ------------------------------------------------------------- topology
    def topology(self) -> dict:
        """The health model as a queryable panel
        (``/v1/topology`` on every front): per-upstream circuit state
        (the breakers' live view — up / half_open / down, consecutive
        fails, latency EWMA, probe deadline), the peer fleet, and the
        rendezvous OWNER of every live subscription / continuous-query
        key — so SubscribeStream supervisors and agents route off the
        SAME view the breakers maintain instead of probing blind."""
        now = time.monotonic()
        ups = []
        for u in self.upstreams:
            ups.append({
                "upstream": u.label, "host": u.host, "port": u.port,
                "state": u.state, "tick": u.tick, "fails": u.fails,
                "ewma_ms": round(u.ewma_ms, 3)
                if u.ewma_ms is not None else None,
                "probe_in_s": round(max(0.0, u.probe_at - now), 3)
                if u.state == "down" else None,
            })
        me = self._ident()
        owners = {}
        sub_keys = list(self.subs._by_key) \
            + list(self.subs._cq_groups)            # noqa: SLF001
        for key in sub_keys[:256]:
            own = self._owner_peer(key)
            owners[key] = me if own is None else f"{own[0]}:{own[1]}"
        return {
            "t": "topology",
            "fabric_tick": self.fabric_tick,
            "self": me,
            "peers": [f"{h}:{p}" for h, p in self.peers],
            "upstreams": ups,
            "owners": owners,
            "subscribers": self.subs.nsubs,
            "sub_keys": len(self.subs._by_key),     # noqa: SLF001
            "cq_groups": len(self.subs._cq_groups),  # noqa: SLF001
            "cq_subscribers": sum(
                len(g.subs)
                for g in self.subs._cq_groups.values()),  # noqa: SLF001
        }

    async def _query_one(self, u: _Upstream, req: dict,
                         timeout: Optional[float] = None) -> dict:
        from gyeeta_tpu_torch.ingest import wire
        if u.state == "down" and time.monotonic() >= u.probe_at:
            # this attempt IS the half-open probe: one request tests
            # the circuit, success closes it, failure re-arms backoff
            u._set_state("half_open")       # noqa: SLF001
        try:
            qc = await u.checkout(self.upstream_timeout_s)
        except (ConnectionError, OSError, TimeoutError,
                asyncio.IncompleteReadError, wire.FrameError):
            # connect/handshake failure — the COMMON way a replica is
            # down; it must feed the breaker like a request failure
            u.record_fail()
            raise
        t0 = time.perf_counter()
        try:
            out = await qc.query(req, timeout=timeout)
        except RuntimeError:
            # server error ENVELOPE: the conn (and replica) is healthy
            # — reuse it, and the circuit records a SUCCESS
            u.checkin(qc)
            u.record_ok((time.perf_counter() - t0) * 1e3)
            raise
        except (ConnectionError, OSError, TimeoutError,
                asyncio.IncompleteReadError, wire.FrameError):
            await u.discard(qc)
            u.record_fail()
            raise
        except BaseException:
            # cancellation (a hedge loser) or unexpected: the conn is
            # mid-request and can never be reused; NOT a health
            # signal — a cancelled request says nothing about the
            # replica
            await u.discard(qc)
            raise
        u.checkin(qc)
        u.record_ok((time.perf_counter() - t0) * 1e3)
        return out

    def _ranked(self) -> list:
        """Failover order: live replicas first (rotated so load
        spreads; the rotation's successor is the hedge target),
        half-open probes next, and marked-DOWN replicas LAST rather
        than never — a fabric with >=1 live replica never surfaces an
        upstream error, and a fully-down fabric still tries everyone
        instead of failing by label alone."""
        ups = sorted((u for u in self.upstreams if u.state == "up"),
                     key=lambda u: u.ewma_ms or 0.0)
        half = [u for u in self.upstreams if u.state == "half_open"]
        down = sorted((u for u in self.upstreams
                       if u.state == "down"),
                      key=lambda u: u.probe_at)
        if len(ups) > 1:
            self._rr = (self._rr + 1) % len(ups)
            ups = ups[self._rr:] + ups[:self._rr]
        return ups + half + down

    def _hedge_budget_s(self, u: _Upstream) -> float:
        """Latency budget before the hedge fires: the knob floor, or
        4x the primary's EWMA when traffic has taught us its normal —
        a loaded-but-healthy replica must not double every render."""
        return max(self.hedge_ms, 4.0 * (u.ewma_ms or 0.0)) / 1e3

    async def _query_hedged(self, u1: _Upstream, u2: _Upstream,
                            req: dict) -> dict:
        """First-response-wins over (primary, next-healthiest): the
        hedge fires when the primary exceeds the latency budget
        (counted — the wedged-not-dead replica case, where the
        breaker sees no failure to open on), or immediately on a fast
        primary conn failure (plain failover). RuntimeError envelopes
        win outright — every replica answers them identically."""
        t1 = asyncio.ensure_future(self._query_one(u1, dict(req)))
        done, _ = await asyncio.wait({t1},
                                     timeout=self._hedge_budget_s(u1))
        if done:
            exc = t1.exception()
            if exc is None:
                return t1.result()
            if isinstance(exc, RuntimeError):
                raise exc
            # primary died fast: just fail over, no hedge needed
            return await self._query_one(u2, dict(req))
        self.stats.bump("gw_hedged_requests")
        t2 = asyncio.ensure_future(self._query_one(u2, dict(req)))
        pending: set = {t1, t2}
        winner = None
        err: Optional[BaseException] = None
        try:
            while pending and winner is None:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    exc = t.exception()
                    if exc is None:
                        winner = t
                        break
                    if isinstance(exc, RuntimeError):
                        raise exc
                    err = exc
            if winner is None:
                raise err if err is not None else \
                    ConnectionError("hedged render failed")
            if winner is t2:
                self.stats.bump("gw_hedged_wins")
            return winner.result()
        finally:
            for t in (t1, t2):
                if not t.done():
                    t.cancel()
                elif not t.cancelled():
                    t.exception()       # mark retrieved

    async def _upstream_query(self, req: dict) -> dict:
        """One render upstream: health-ordered failover with hedged
        reads. RuntimeError (the server's own error envelope)
        propagates without failover — it is the QUERY's error and
        every replica would answer it identically."""
        order = self._ranked()
        last: Optional[BaseException] = None
        idx, n = 0, len(order)
        while idx < n:
            u = order[idx]
            hedge = (self.hedge_ms > 0 and u.state == "up"
                     and idx + 1 < n and order[idx + 1].state == "up")
            try:
                if hedge:
                    out = await self._query_hedged(u, order[idx + 1],
                                                   req)
                else:
                    out = await self._query_one(u, req)
                self.stats.bump("gw_renders_upstream")
                return out
            except RuntimeError:
                raise
            except Exception as e:      # noqa: BLE001 — conn trouble
                self.stats.bump("gw_upstream_errors")
                last = e
            # a hedged attempt that raised already consumed BOTH
            idx += 2 if hedge else 1
        raise ConnectionError(f"no upstream reachable: {last}")

    async def _watch_upstream(self, u: _Upstream) -> None:
        """One cheap poll per tick per upstream: watch ``snaptick``
        advance and trigger the subscription push when the FABRIC tick
        (max across upstreams) moves. Health transitions live in the
        circuit breaker (``record_ok``/``record_fail`` inside
        ``_query_one``): a single failed poll only increments the
        consecutive-failure count — mark-down takes ``down_after`` of
        them — and a down upstream is polled on its jittered probe
        backoff instead of every tick."""
        while True:
            if not u.probe_due():
                await asyncio.sleep(
                    min(self.poll_s,
                        max(0.05, u.probe_at - time.monotonic())))
                continue
            try:
                out = await self._query_one(u, dict(_POLL_REQ),
                                            timeout=10.0)
                tick = int(out.get("snaptick", -1))
                if tick > u.tick:
                    u.tick = tick
                u.tick_at = time.monotonic()
                self.stats.gauge("gw_fabric_tick",
                                 float(self.fabric_tick))
                self.stats.gauge(
                    "gw_upstreams_up",
                    float(sum(1 for x in self.upstreams if x.up)))
                new = self.fabric_tick
                if new > self._pushed_tick and not self._pushing:
                    self._pushing = True
                    try:
                        await self.subs.push_tick()
                        # only a COMPLETED push advances the mark: a
                        # failed push retries on the next poll instead
                        # of silently waiting out the tick, and the
                        # error must not flag the polled upstream down
                        self._pushed_tick = new
                    except asyncio.CancelledError:
                        raise
                    except Exception:   # noqa: BLE001 — counted
                        self.stats.bump("gw_push_errors")
                        log.exception("subscription push failed at "
                                      "tick %d", new)
                    finally:
                        self._pushing = False
            except asyncio.CancelledError:
                raise
            except Exception:       # noqa: BLE001 — counted; the
                # circuit breaker (not this handler) decides when the
                # upstream is DOWN: K consecutive failures, not one
                self.stats.bump("gw_poll_errors")
                self.stats.gauge(
                    "gw_upstreams_up",
                    float(sum(1 for x in self.upstreams if x.up)))
            await asyncio.sleep(self.poll_s)

    # ------------------------------------------------------ hub mode
    def _hub_advance(self, tick: int) -> None:
        """A relay saw a newer remote tick: adopt it as the hub's
        fabric tick and kick the push loop."""
        if tick > self._hub_tick:
            self._hub_tick = tick
            self.stats.gauge("gw_region_tick", float(tick))
            self._hub_kick.set()

    def _hub_relay_for(self, req: dict) -> _HubRelay:
        key = request_key(req)
        rel = self._hub_relays.get(key)
        if rel is None or rel.done():
            if rel is not None:
                rel.stop()
            rel = self._hub_relays[key] = _HubRelay(self, req, key)
            self.stats.bump("gw_region_relays_opened")
            self.stats.gauge("gw_region_keys",
                             float(len(self._hub_relays)))
        rel.last_used = time.monotonic()
        return rel

    async def _hub_fetch(self, req: dict) -> dict:
        """The SubscriptionHub's fetch in hub mode: serve the key's
        relay-held full instead of rendering upstream — N local
        subscribers on one key cost ONE inter-region stream. Falls
        back to a one-shot passthrough (counted) only before the
        first full lands, so the first subscriber still gets a base
        while the WAN subscribe is in flight."""
        rel = self._hub_relay_for(req)
        resp = await rel.current(self._hub_tick, self.hub_settle_s,
                                 self.hub_first_s)
        if resp is None:
            self.stats.bump("gw_region_fetch_fallbacks")
            return await self.query(dict(req))
        return resp

    async def _hub_drive(self) -> None:
        """Hub-mode push loop: the remote region's tick arrives on
        the heartbeat relay (the same ``serverstatus`` request poll
        mode uses — but ONE standing subscription instead of a poll
        per upstream per tick). When it advances, give the active
        relays a short settle window to land the same tick, then run
        the local subscription push once — the exact analogue of
        ``_watch_upstream``'s guarded push, driven by events instead
        of polls."""
        self._hub_relay_for(dict(_POLL_REQ))
        while True:
            try:
                await asyncio.wait_for(self._hub_kick.wait(), 1.0)
            except (asyncio.TimeoutError, TimeoutError):
                pass
            self._hub_kick.clear()
            now = time.monotonic()
            for key, rel in list(self._hub_relays.items()):
                rel.fold()
                if key == self._hub_hb_key:
                    rel.last_used = now     # the heartbeat never idles
                elif now - rel.last_used > self.hub_idle_s:
                    # no local fetch touched this key for a while: the
                    # last subscriber left — stop paying WAN for it
                    rel.stop()
                    del self._hub_relays[key]
                    self.stats.bump("gw_region_relays_closed")
            self.stats.gauge("gw_region_keys",
                             float(len(self._hub_relays)))
            new = self.fabric_tick
            if new > self._pushed_tick and not self._pushing:
                deadline = time.monotonic() + self.hub_settle_s
                while time.monotonic() < deadline and any(
                        r.held is not None and r.tick < new
                        for r in self._hub_relays.values()):
                    await asyncio.sleep(0.02)
                self._pushing = True
                try:
                    await self.subs.push_tick()
                    self._pushed_tick = new
                except asyncio.CancelledError:
                    raise
                except Exception:   # noqa: BLE001 — counted, retried
                    self.stats.bump("gw_push_errors")
                    log.exception("hub push failed at tick %d", new)
                finally:
                    self._pushing = False

    # ------------------------------------------------------ cache + query
    @staticmethod
    def _cacheable(req: dict) -> bool:
        if any(k in req for k in ("op", "multiquery", "at", "window",
                                  "tstart", "tend")):
            return False
        return req.get("consistency") != "strong"

    def _cache_put(self, ck, entry) -> None:
        self._cache[ck] = entry
        self._cache.move_to_end(ck)
        while len(self._cache) > self.cache_max:
            self._cache.popitem(last=False)

    def _cache_body(self, ck) -> Optional[bytes]:
        ent = self._cache.get(ck)
        if ent is None or ent[0] != "ok":
            return None
        if ent[2] is None:
            ent[2] = json.dumps(ent[1]).encode()
        return ent[2]

    # --------------------------------------------------- historical cache
    @staticmethod
    def _hist_anchor(req: dict) -> Optional[str]:
        """Classify a historical request's anchor: ``"abs"`` — the
        instant/range is spelled absolutely, so the answer can be
        immutable; ``"rel"`` — anchored to "now"/the newest shard
        (``at=-15m``, ``window=`` without ``tend``), re-resolving
        every pass; None — not a historical request."""
        if any(k in req for k in ("op", "multiquery")):
            return None
        if "at" in req:
            v = req["at"]
            if isinstance(v, str) and v.strip().startswith("-"):
                return "rel"
            return "abs"
        if "tstart" in req:
            return "abs" if "tend" in req else "rel"
        if "window" in req:
            return "abs" if "tend" in req else "rel"
        if "tend" in req:
            return "rel"
        return None

    @staticmethod
    def _hist_immutable(req: dict, resp: dict) -> bool:
        """An absolute historical answer is immutable ONLY when its
        anchor resolved INSIDE compaction coverage at render time: a
        request past the frontier (or before the earliest shard)
        would re-resolve once compaction appends/retires windows.
        Coverage rides the response (``timeview._cover``)."""
        cover_t = resp.get("hist_cover_t")
        cover_tick = resp.get("hist_cover_tick")
        if cover_t is None:
            return False
        if "at" in req:
            v = req["at"]
            if isinstance(v, str) and v.strip().startswith("tick:"):
                try:
                    return int(v.strip()[5:]) <= int(cover_tick)
                except (TypeError, ValueError):
                    return False
            try:
                ts = float(v)
            except (TypeError, ValueError):
                return False
            # resolved-behind (resp.at <= ts): genuine "state at ts";
            # resolved-AHEAD means the before-everything fallback fired
            return resp.get("at", ts + 1) <= ts <= float(cover_t)
        end = req.get("tend")
        try:
            return end is not None and float(end) <= float(cover_t)
        except (TypeError, ValueError):
            return False

    def _hist_put(self, key: str, resp: dict) -> None:
        self._hist_cache[key] = resp
        self._hist_cache.move_to_end(key)
        while len(self._hist_cache) > self.hist_cache_max:
            self._hist_cache.popitem(last=False)

    async def _hist_query(self, req: dict, anchor: str) -> dict:
        key = request_key(req)
        if anchor == "abs":
            ent = self._hist_cache.get(key)
            if ent is not None:
                self.stats.bump("gw_hist_cache_hits")
                self._hist_cache.move_to_end(key)
                return ent
            self.stats.bump("gw_hist_cache_misses")
        else:
            self.stats.bump("gw_hist_cache_uncacheable")
        resp = await self._upstream_query(dict(req))
        cacheable = self._hist_immutable(req, resp)
        if anchor == "abs" and cacheable:
            self._hist_put(key, resp)
        # alias every interior at= answer under its RESOLVED tick so
        # any spelling of the same instant (epoch seconds, a relative
        # -15m that landed here, tick:N) shares one entry forever
        tick = resp.get("tick")
        if tick is not None and "at" in req and cacheable:
            alias = request_key({**{k: v for k, v in req.items()
                                    if k != "at"},
                                 "at": f"tick:{int(tick)}"})
            if alias != key:
                self._hist_put(alias, resp)
        return resp

    async def query(self, req: dict, _from_peer: bool = False) -> dict:
        """THE query entry every front shares. Cache-eligible requests
        collapse onto the (fabric-tick, normalized-key) edge cache with
        single-flight + owner-routed peer exchange; everything else
        passes through to a replica. ``_from_peer`` marks a render
        forwarded BY a peer (``_serve_peer``): it must not hop again —
        rendezvous ownership is consistent fleet-wide, but an
        asymmetric peer config would otherwise ping-pong forever.
        Raises RuntimeError with the server's error envelope,
        ConnectionError when no upstream answers."""
        if req.get("subsys") == "topology":
            # breaker-aware topology hints (/v1/topology on every
            # front): rendered from the gateway's OWN health model —
            # never forwarded upstream, never cached
            self.stats.bump("gw_queries|edge=topology")
            return self.topology()
        if not self._cacheable(req):
            anchor = self._hist_anchor(req)
            if anchor is not None \
                    and req.get("consistency") != "strong":
                return await self._hist_query(req, anchor)
            self.stats.bump("gw_queries_uncached")
            return await self._upstream_query(req)
        key = request_key(req)
        tick = self.fabric_tick
        ck = (tick, key)
        ent = self._cache.get(ck)
        if ent is not None:
            if ent[0] == "ok":
                self.stats.bump("gw_cache_hits|tier=local")
                self._cache.move_to_end(ck)
                return ent[1]
            if ent[2] > time.monotonic():       # negative entry alive
                self.stats.bump("gw_cache_hits|tier=neg")
                raise RuntimeError(ent[1])
            self._cache.pop(ck, None)
        fut = self._flight.get(ck)
        if fut is not None:
            self.stats.bump("gw_singleflight_waits")
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._flight[ck] = fut
        try:
            self.stats.bump("gw_cache_misses")
            resp = None
            if self.peers and not _from_peer:
                got = await self._peer_get(tick, key, req)
                if got is not None and got[0] == "neg":
                    # the owner's render errored: share the negative
                    # verdict so the fleet, not just the owner,
                    # collapses the broken-panel stampede
                    self._cache_put(
                        ck, ["neg", got[1],
                             time.monotonic() + self.neg_ttl_s])
                    raise RuntimeError(got[1])
                if got is not None:
                    resp = got[1]
            if resp is not None:
                self.stats.bump("gw_cache_hits|tier=peer")
            if resp is None and self.hub:
                # hub mode: an active inter-region relay already holds
                # this key's current full — a one-shot dashboard query
                # must not cost a WAN render
                rel = self._hub_relays.get(key)
                if rel is not None and rel.held is not None:
                    resp = rel.held
                    self.stats.bump("gw_cache_hits|tier=region")
            if resp is None:
                try:
                    resp = await self._upstream_query(dict(req))
                except RuntimeError as e:
                    # negative cache: the error is the result of THIS
                    # query at THIS tick — a stampede of a broken
                    # dashboard panel must not hammer the replicas
                    self._cache_put(
                        ck, ["neg", str(e),
                             time.monotonic() + self.neg_ttl_s])
                    raise
            ent = ["ok", resp, None]
            self._cache_put(ck, ent)
            st = resp.get("snaptick")
            if st is not None and (st, key) != ck:
                # the replica rendered a fresher (or lagging) tick:
                # alias under ITS tick too, so the next lookup at that
                # tick hits
                self._cache_put((st, key), ent)
                if st < tick:
                    # lagging replica: keep ONLY the (st, key) alias —
                    # parking the stale render under the current tick
                    # would serve last tick's data for the whole tick
                    # and single-flight would never re-render it from
                    # a caught-up replica
                    self._cache.pop(ck, None)
            elif st is None:
                # uncacheable response shape (no snaptick: local
                # subsystems, strong reads) — do not serve it across
                # ticks
                self._cache.pop(ck, None)
            fut.set_result(resp)
            return resp
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            self._flight.pop(ck, None)
            if not fut.done():          # pragma: no cover — safety
                fut.cancel()
            elif not fut.cancelled():
                fut.exception()     # mark retrieved (no loop warning)

    # ------------------------------------------------------ peer exchange
    async def _peer_post_one(self, peer, body: bytes):
        ent = self._peer_conns.get(peer)
        if ent is None:
            ent = self._peer_conns[peer] = [None, None,
                                            asyncio.Lock()]
        # one request in flight per peer conn: responses arrive in
        # write order, so an unserialized second reader would consume
        # the FIRST request's response (cross-query poisoning)
        async with ent[2]:
            try:
                if ent[1] is None or ent[1].is_closing():
                    ent[0], ent[1] = await asyncio.open_connection(
                        *peer)
                reader, writer = ent[0], ent[1]
                writer.write(
                    f"POST /gw/peer HTTP/1.1\r\nHost: gw\r\n"
                    f"Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body)
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                status = int(head.split()[1])
                clen = 0
                for ln in head.decode("latin1").split("\r\n"):
                    if ln.lower().startswith("content-length:"):
                        clen = int(ln.split(":", 1)[1])
                payload = await reader.readexactly(clen) if clen \
                    else b""
                return status, payload
            except BaseException:
                # request may be half-done (cancel on timeout, IO
                # error): the stream position is unknown, so the conn
                # cannot be reused
                if ent[1] is not None:
                    ent[1].close()
                    ent[0] = ent[1] = None
                raise

    def _ident(self) -> str:
        return self.advertise or f"{self.host}:{self.port}"

    @staticmethod
    def _rdv_score(ident: str, key: str) -> int:
        import hashlib
        return int.from_bytes(
            hashlib.blake2b(f"{ident}\x00{key}".encode(),
                            digest_size=8).digest(), "big")

    def _owner_peer(self, key: str) -> Optional[tuple]:
        """Rendezvous-hash owner of ``key`` across the fleet (self +
        peers): every gateway ranks the same idents, so the whole
        fleet agrees on ONE owner per key with no coordination —
        N-gateway fleets do one peer hop instead of an in-order scan,
        and membership changes only reshuffle 1/N of the keys.
        Returns None when THIS gateway owns the key."""
        best_peer = None
        best = self._rdv_score(self._ident(), key)
        for h, p in self.peers:
            s = self._rdv_score(f"{h}:{p}", key)
            if s > best:
                best, best_peer = s, (h, p)
        return best_peer

    async def _peer_get(self, tick: int, key: str,
                        req: dict) -> Optional[tuple]:
        """On a local miss route to the rendezvous OWNER of the key:
        the owner answers from its cache, waits on its own in-flight
        render, or renders upstream itself — one peer hop, one render
        per fleet. A clean miss is
        impossible from the owner (it renders), so the in-order scan
        of the remaining peers runs only when the owner is DOWN.
        Returns ("hit", resp) | ("neg", errmsg) | None (render
        locally). Bounded by ``peer_timeout_s`` per peer — a slow
        peer must cost less than the render it saves."""
        owner = self._owner_peer(key)
        if owner is None:
            # this gateway owns the key: peers route here; render
            self.stats.bump("gw_peer_owner_self")
            return None
        body = json.dumps({"tick": tick, "key": key,
                           "req": req}).encode()
        probe = json.dumps({"tick": tick, "key": key}).encode()
        peers = [owner] + [p for p in self.peers if p != owner]
        for i, peer in enumerate(peers):
            self.stats.bump("gw_peer_requests")
            try:
                status, payload = await asyncio.wait_for(
                    self._peer_post_one(peer,
                                        body if i == 0 else probe),
                    self.peer_timeout_s)
                if status == 200:
                    obj = json.loads(payload)
                    if obj.get("neg") is not None:
                        return ("neg", obj["neg"])
                    self.stats.bump("gw_peer_hits")
                    return ("hit", obj["resp"])
                if i == 0:
                    # the owner answered but could not render (its
                    # upstreams unreachable): render locally — our
                    # replica view may differ from the owner's
                    return None
            except asyncio.CancelledError:
                raise
            except Exception:       # noqa: BLE001 — peer down/slow
                # conn teardown happens inside _peer_post_one under
                # the per-peer lock; closing here could kill a fresh
                # conn another coroutine just opened
                self.stats.bump("gw_peer_errors")
                if i == 0:
                    # owner down: degrade to the in-order scan
                    # of the remaining peers' caches
                    self.stats.bump("gw_peer_owner_down")
        return None

    async def _serve_peer(self, obj: dict):
        """The answering half: local cache lookup, waiting on an
        in-flight render for the SAME (tick, key), and — when the
        caller forwarded the full request because WE own the key —
        rendering upstream ourselves. Ownership is what makes a
        fresh-tick stampede render once per FLEET, not once per
        gateway. A render error ships as ``neg`` so the whole fleet
        shares the negative verdict."""
        self.stats.bump("gw_peer_served_requests")
        ck = (int(obj.get("tick", -1)), str(obj.get("key", "")))
        if ck[0] > self.fabric_tick:
            # owner-tick poll skew: the asker's
            # replica already published this tick, our poller just
            # has not seen it yet. Adopt it as a floor so the render
            # below caches under the tick the asker (and everyone
            # else at that tick) will look up — NOT under our stale
            # one, which made owner-routed renders invisible
            # (peer_hits=0) until the next poll.
            self._tick_floor = ck[0]
            self.stats.bump("gw_peer_tick_adopted")
        ent = self._cache.get(ck)
        if ent is not None and ent[0] == "ok":
            self.stats.bump("gw_peer_served_hits")
            return {"resp": ent[1]}
        fut = self._flight.get(ck)
        if fut is not None:
            try:
                resp = await asyncio.wait_for(asyncio.shield(fut), 2.0)
                self.stats.bump("gw_peer_served_hits")
                return {"resp": resp}
            except Exception:       # noqa: BLE001
                pass
        req = obj.get("req")
        if isinstance(req, dict) and req:
            # owner-routed render: _from_peer pins the hop count at 1
            try:
                resp = await self.query(dict(req), _from_peer=True)
                self.stats.bump("gw_peer_served_renders")
                return {"resp": resp}
            except RuntimeError as e:
                return {"neg": str(e)}
            except asyncio.CancelledError:
                raise
            except Exception:       # noqa: BLE001 — upstreams down
                self.stats.bump("gw_peer_served_errors")
        return None

    # ---------------------------------------------------------- the fronts
    async def _handle(self, reader, writer) -> None:
        try:
            try:
                first = await asyncio.wait_for(reader.readexactly(4),
                                               10.0)
            except (asyncio.IncompleteReadError, ConnectionError,
                    asyncio.TimeoutError, TimeoutError):
                return
            from gyeeta_tpu_torch.ingest import refproto, wire
            magic = int.from_bytes(first, "little")
            if magic in (wire.MAGIC_PM, wire.MAGIC_MS, wire.MAGIC_NQ):
                await self._gyt_front(reader, writer, first)
            elif magic in refproto.REF_MAGICS:
                await self._nm_front(reader, writer, first)
            else:
                await self._http_front(reader, writer, first)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        except Exception:           # pragma: no cover — keep serving
            log.exception("gateway conn failed")
        finally:
            self.subs.unsubscribe_conn(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):  # pragma: no cover
                pass

    # ---- GYT binary front
    async def _gyt_front(self, reader, writer, first: bytes) -> None:
        from gyeeta_tpu_torch import version
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.net.subs import SubscribeError
        import numpy as np
        dtype, payload = await wire.read_frame(reader, first)
        if dtype != wire.COMM_REGISTER_REQ:
            return
        req = np.frombuffer(payload, wire.REGISTER_REQ_DT, count=1)[0]
        if int(req["conn_type"]) != wire.CONN_QUERY:
            # the gateway serves QUERIES; event conns belong on the
            # serve tier
            writer.write(wire.encode_register_resp(
                wire.REG_ERR_VERSION, 0, version.CURR_WIRE_VERSION, 0))
            await writer.drain()
            return
        writer.write(wire.encode_register_resp(
            wire.REG_OK, 0xFFFFFFFF, version.CURR_WIRE_VERSION, 0))
        await writer.drain()
        while True:
            try:
                dtype, payload = await wire.read_frame(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if dtype == wire.COMM_SUBSCRIBE_CMD:
                try:
                    seqid, _, req = wire.decode_query_payload(payload)
                except Exception:       # noqa: BLE001
                    continue

                async def send(ev, _seqid=seqid, _w=writer):
                    _w.write(wire.encode_query(_seqid, ev,
                                               wire.QS_PARTIAL,
                                               resp=True))
                    await asyncio.wait_for(_w.drain(),
                                           self.write_timeout)

                try:
                    await self.subs.subscribe(
                        req or {}, send,
                        last_snaptick=(req or {}).get("last_snaptick"),
                        conn_tag=writer)
                    self.stats.bump("gw_queries|edge=gyt_sub")
                except (SubscribeError, ValueError, RuntimeError,
                        ConnectionError) as e:
                    writer.write(wire.encode_query(
                        seqid, {"error": str(e)}, wire.QS_ERROR,
                        resp=True))
                    await writer.drain()
                continue
            if dtype != wire.COMM_QUERY_CMD:
                continue
            try:
                seqid, _, req = wire.decode_query_payload(payload)
            except Exception:           # noqa: BLE001
                continue
            self.stats.bump("gw_queries|edge=gyt")
            try:
                with self.stats.timeit("gw_query"):
                    out = await self.query(req or {})
            except Exception as e:      # noqa: BLE001
                status = wire.QS_ERROR
                writer.write(wire.encode_query(
                    seqid, {"error": str(e)}, status, resp=True))
                await writer.drain()
                continue
            for frame in wire.iter_query_frames(seqid, out, wire.QS_OK):
                writer.write(frame)
                await writer.drain()

    # ---- stock NM front
    async def _nm_front(self, reader, writer, first: bytes) -> None:
        from gyeeta_tpu_torch.ingest import refproto as RP
        from gyeeta_tpu_torch.ingest import refquery as RQ
        from gyeeta_tpu_torch.ingest import wire
        import numpy as np
        hdr_b = first + await reader.readexactly(
            RP.REF_HEADER_DT.itemsize - len(first))
        hdr = np.frombuffer(hdr_b, RP.REF_HEADER_DT, count=1)[0]
        total = int(hdr["total_sz"])
        if total < len(hdr_b) or total >= wire.MAX_COMM_DATA_SZ:
            return
        body = await reader.readexactly(total - len(hdr_b))
        if int(hdr["data_type"]) != RQ.REF_COMM_NM_CONNECT_CMD:
            # only the node-webserver dialect fronts here; partha
            # event conns belong on the serve tier
            self.stats.bump("gw_nm_rejected")
            return
        from gyeeta_tpu_torch.net import nmhandle
        await nmhandle.serve_nm_gateway(self, reader, writer, body)

    # ---- HTTP front
    async def _http_front(self, reader, writer, first: bytes) -> None:
        pending = first
        while True:
            try:
                head = pending + await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except asyncio.LimitOverrunError:
                await self._respond(writer, 431,
                                    {"error": "headers too large"})
                return
            pending = b""
            if len(head) > _MAX_HDR:
                await self._respond(writer, 431,
                                    {"error": "headers too large"})
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
            if clen < 0 or clen > _MAX_BODY:
                await self._respond(writer, 400,
                                    {"error": "bad content-length"})
                return
            body = await reader.readexactly(clen) if clen else b""
            keep = headers.get("connection",
                               "keep-alive").lower() != "close"
            streamed = await self._http_route(reader, writer, method,
                                              target,
                                              body)
            if streamed or not keep:
                return

    async def _http_route(self, reader, writer, method: str, target: str,
                          body: bytes) -> bool:
        """→ True when the response is a stream that owns the conn
        (SSE); the caller stops the keep-alive loop."""
        path, _, qs = target.partition("?")
        try:
            if method == "GET" and path == "/metrics":
                from gyeeta_tpu_torch.obs import prom
                await self._respond_text(writer, 200,
                                         prom.render(self.stats),
                                         prom.CONTENT_TYPE)
                return False
            if method == "GET" and path == "/healthz":
                fresh = [u for u in self.upstreams if u.up]
                ok = bool(fresh)
                await self._respond(writer, 200 if ok else 503, {
                    "ok": ok, "fabric_tick": self.fabric_tick,
                    "upstreams_up": len(fresh),
                    "upstreams": len(self.upstreams),
                    "subscribers": self.subs.nsubs})
                return False
            if method == "POST" and path == "/gw/peer":
                out = await self._serve_peer(json.loads(body or b"{}"))
                if out is None:
                    await self._respond(writer, 404, {"miss": True})
                else:
                    await self._respond(writer, 200, out)
                return False
            if method == "GET" and path == "/v1/subscribe":
                await self._sse_subscribe(reader, writer, qs)
                return True
            if method == "POST" and path == "/query":
                req = json.loads(body or b"{}")
                self.stats.bump("gw_queries|edge=http")
                with self.stats.timeit("gw_query"):
                    await self._respond(writer, 200,
                                        await self.query(req))
                return False
            if method == "GET" and path.startswith("/v1/"):
                req = self._req_of_qs(path[4:].strip("/"), qs)
                self.stats.bump("gw_queries|edge=http")
                with self.stats.timeit("gw_query"):
                    await self._respond(writer, 200,
                                        await self.query(req))
                return False
            await self._respond(writer, 404, {"error": "not found"})
        except (ValueError, KeyError, RuntimeError) as e:
            await self._respond(writer, 400, {"error": str(e)})
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            await self._respond(writer, 502,
                                {"error": "upstream unreachable"})
        return False

    @staticmethod
    def _req_of_qs(subsys: str, qs: str) -> dict:
        req = {"subsys": subsys}
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
        for k in ("at", "window"):
            if k in q:
                req[k] = q[k][0]
        if "sortdesc" in q:
            req["sortdesc"] = q["sortdesc"][0].lower() in ("1", "true")
        if "cq" in q:
            # continuous query: the subscription is a STANDING FILTER
            # (enter/leave/change membership events), not a panel view
            req["cq"] = q["cq"][0].lower() in ("1", "true")
        return req

    # ---- SSE subscription edge
    async def _sse_subscribe(self, reader, writer, qs: str) -> None:
        q = urllib.parse.parse_qs(qs)
        if "subsys" not in q:
            await self._respond(writer, 400,
                                {"error": "subscribe needs subsys"})
            return
        req = self._req_of_qs(q["subsys"][0], qs)
        last = None
        if "last_snaptick" in q:
            try:
                last = int(q["last_snaptick"][0])
            except ValueError:
                pass
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()

        async def send(ev, _w=writer):
            data = json.dumps(ev)
            _w.write(f"event: {ev.get('t', 'message')}\n"
                     f"data: {data}\n\n".encode())
            await asyncio.wait_for(_w.drain(), self.write_timeout)

        from gyeeta_tpu_torch.net.subs import SubscribeError
        try:
            await self.subs.subscribe(req, send, last_snaptick=last,
                                      conn_tag=writer)
            self.stats.bump("gw_queries|edge=sse")
        except (SubscribeError, ValueError, RuntimeError,
                ConnectionError) as e:
            writer.write(f"event: error\ndata: "
                         f"{json.dumps({'error': str(e)})}\n\n"
                         .encode())
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            return
        # park until the CLIENT hangs up; pushes arrive from the hub
        # (unsubscribe happens in _handle's finally)
        # (a client's EOF leaves the transport open: watch the reader
        # too, or a quiet stream would park until a push fails)
        transport = writer.transport
        while not transport.is_closing() and not reader.at_eof():
            await asyncio.sleep(0.5)

    # ------------------------------------------------------- http encode
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
