"""Streaming query subscriptions: register once, receive per-tick deltas.

Counterpart of ``gyeeta_tpu/net/subs.py``. The knob readers
(:func:`sub_history`, :func:`delta_max_ratio`, :func:`retain_keys`,
:func:`persist_max_bytes`) read the ``env`` mapping they are given and
default to the reference's values without one.

The reference's NodeJS webserver LONG-POLLS madhava: every dashboard
re-asks its query every few seconds and the server re-renders it even
when nothing changed. This module inverts the edge on the same wire
format: a client registers a query ONCE and the serving tier watches
``snaptick`` advance — when a new engine view publishes, each DISTINCT
subscribed query is rendered once, diffed once against the previously
delivered version (``query/delta.py``), and the delta is pushed to
every subscriber of that query. Thousands of dashboards cost one
render + one diff per tick, not thousands of polls.

:class:`SubscriptionHub` is the shared server half — the SAME hub runs
inside :class:`~gyeeta_tpu_torch.net.server.GytServer` (fetching from the
local snapshot tier) and inside the fan-in gateway
(``net/gateway.py``, fetching through the distributed edge cache), so
both edges push identical event streams. Subscriptions group by the
NORMALIZED request key (``query/normalize.py`` — the cache-key
function), which is what makes "thousands of dashboards, one render"
literal: every subscriber of a semantically-equal query lands in one
group.

Reconnect: a subscriber that held version T re-subscribes with
``last_snaptick=T``; if the hub still holds T in its short version
history it answers with a delta (or an ``ack`` when T is current),
otherwise a full resync — COUNTED (``gw_sub_resyncs``) and marked
in-band (``resync: true`` on the full event), never silent — and the
client never has to special-case it
(``query/delta.py:apply_event`` handles all three).

Fault-domain continuation: version rings are RETAINED
(bounded) when the last subscriber of a key disconnects, so a brief
client outage resumes with a delta instead of a resync; and with
``persist_path`` set the hub appends every pushed version to a small
append-only file and restores the rings on construction — a
RESTARTED gateway replays the missing deltas to clients that
reconnect with ``last_snaptick``, when its ring still covers them.

Client halves: :class:`SubscribeClient` speaks the GYT binary
``COMM_SUBSCRIBE_CMD`` stream (``events(stall_timeout=...)`` raises a
typed :class:`SubscriptionStalled` instead of hanging forever on a
frozen hub); :func:`read_sse_events` parses the REST
``/v1/subscribe`` SSE stream. Both yield the same event dicts.
:class:`SubscribeStream` supervises a subscription across gateway
failures: reconnect with ``last_snaptick`` on conn loss or stall,
rotating endpoints — at-least-once, no-gap: its reassembled
responses are byte-identical to an uninterrupted subscription's at
every common snaptick (property-tested).

Continuous queries: a subscription carrying ``cq: true``
plus a ``filter`` is a STANDING PREDICATE, not a panel view. The hub
canonicalizes the filter (``query/cq.py``), groups subscribers by
``(subsys, canonical-criteria)``, and per tick runs ONE predicate pass
per group over only the panel rows that CHANGED — computed from the
same row-keyed diff the panel subscriptions already pay for, never
from a second render. Subscribers receive first-class ``enter`` /
``change`` / ``leave`` membership events (``query/delta.py`` applies
them) and heartbeat acks on quiet ticks. Group membership is carried
incrementally across ticks, versioned through the SAME retained /
persisted rings as panel subscriptions — a reconnect (or a restarted
gateway) resumes with enter/leave deltas when the ring covers the
client's version, else a counted, ``resync``-marked full. N standing
filters over F distinct criteria cost F predicate passes and ≤1 panel
render per tick, shared with any plain full-panel subscriber.

Metrics (all through the hub's ``Stats`` registry — rendered as
``gyt_gw_*`` / ``gyt_cq_*`` by ``obs/prom.py``): ``gw_subscribers`` /
``gw_sub_keys`` gauges, ``gw_deltas_pushed`` / ``gw_resyncs`` /
``gw_sub_events`` / ``gw_sub_dropped`` counters, ``gw_delta_bytes`` /
``gw_full_bytes`` (the delta-vs-full wire ratio, QUERYLAT_r08), the
``gw_push`` stage hist (render+diff+deliver lag per key per tick);
and for the continuous-query tier ``cq_groups`` / ``cq_subscribers``
gauges plus ``cq_group_evals`` (THE amortization proof: one bump per
live group per tick, compare against ``cq_subscribers``),
``cq_panel_renders`` / ``cq_panel_render_shared``, ``cq_events|kind=``,
``cq_resyncs``, ``cq_fetch_errors`` / ``cq_eval_errors`` counters.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
from typing import Optional

from gyeeta_tpu_torch.query import cq as CQ, delta as D
from gyeeta_tpu_torch.query.normalize import normalize_request, request_key

log = logging.getLogger("gyeeta_tpu_torch.net.subs")

# subscription-channel control fields stripped from the query envelope
# before normalization (they select HOW to deliver, not WHAT to render)
_SUB_FIELDS = ("last_snaptick", "subscribe")


def sub_history(env=None) -> int:
    env = {} if env is None else env
    try:
        return max(2, int(env.get("GYT_GW_SUB_HISTORY", "4")))
    except ValueError:
        return 4


def delta_max_ratio(env=None) -> float:
    """Delta-vs-full tradeoff knob: a delta that serializes to ≥ this
    fraction of the full body is replaced by a full resync (1.0 = only
    beat the full body; lower = prefer fulls sooner)."""
    env = {} if env is None else env
    try:
        return float(env.get("GYT_GW_DELTA_MAX_RATIO", "1.0"))
    except ValueError:
        return 1.0


def retain_keys(env=None) -> int:
    """Version rings RETAINED after the last subscriber of a key
    disconnects (the reconnect-continuation window), bounding hub
    memory when many distinct queries come and go."""
    env = {} if env is None else env
    try:
        return max(0, int(env.get("GYT_GW_SUB_RETAIN_KEYS", "1024")))
    except ValueError:
        return 1024


def persist_max_bytes(env=None) -> int:
    env = {} if env is None else env
    try:
        mb = float(env.get("GYT_GW_SUB_PERSIST_MAX_MB", "16"))
    except ValueError:
        mb = 16.0
    return max(1 << 20, int(mb * (1 << 20)))


class SubscribeError(ValueError):
    """Subscription rejected at registration (bad envelope / at
    capacity) — the edge answers its error frame and keeps the conn."""


class SubscriptionStalled(RuntimeError):
    """No event or keepalive arrived within the stall deadline — the
    hub (or the path to it) is wedged, not merely quiet: every tick
    delivers at least one event per subscription, so silence past
    ~3x the tick interval means the stream is dead even though the
    TCP conn looks alive. Typed so supervisors reconnect instead of
    treating it as a server rejection."""


class _Sub:
    __slots__ = ("sid", "key", "send", "last_tick", "conn_tag")

    def __init__(self, sid, key, send, last_tick, conn_tag):
        self.sid = sid
        self.key = key
        self.send = send
        self.last_tick = last_tick
        self.conn_tag = conn_tag


class _CQGroup:
    """One normalized standing filter + every subscriber asking it.
    Lives only while it has subscribers — its membership version ring
    outlives it (retained/persisted), so a re-subscribe rebuilds the
    group from the ring and resumes with deltas."""

    __slots__ = ("key", "m", "subs")

    def __init__(self, key, m):
        self.key = key
        self.m = m                      # CQ.Membership
        self.subs: dict = {}


class _CQPanel:
    """Per-subsystem panel state shared by every criteria group
    standing on it: the previous tick's row map, diffed ONCE per tick
    (the changed-rows set every group's predicate pass runs over)."""

    __slots__ = ("prev", "tick")

    def __init__(self, prev=None, tick=None):
        self.prev = prev
        self.tick = tick


class SubscriptionHub:
    """One per serving process. ``fetch`` is the tier's full-render
    function ``async (req) -> resp`` — the snapshot query path on a
    serve replica, the edge-cached query path on a gateway."""

    def __init__(self, fetch, stats, history: Optional[int] = None,
                 max_ratio: Optional[float] = None,
                 max_subs: int = 4096,
                 persist_path: Optional[str] = None,
                 retain: Optional[int] = None,
                 persist_max: Optional[int] = None):
        self._fetch = fetch
        self.stats = stats
        self.history = sub_history() if history is None else int(history)
        self.max_ratio = delta_max_ratio() if max_ratio is None \
            else float(max_ratio)
        self.max_subs = int(max_subs)
        self.retain = retain_keys() if retain is None else int(retain)
        self._seq = 0
        self._subs: dict[int, _Sub] = {}
        self._by_key: dict[str, dict] = {}
        self._req_of_key: dict[str, dict] = {}
        # key -> deque[(snaptick, resp)] newest-last: the reconnect
        # window (how far back a delta can base) AND the diff source.
        # Rings OUTLIVE their subscribers (bounded by ``retain``) so a
        # reconnect resumes with a delta, and optionally persist to an
        # append-only file so a RESTART does too.
        self._versions: dict[str, collections.deque] = {}
        # continuous-query tier: criteria group per normalized
        # standing filter, panel diff state per subsystem
        self._cq_groups: dict[str, _CQGroup] = {}
        self._cq_panels: dict[str, _CQPanel] = {}
        self._persist_path = persist_path
        self._persist_f = None
        self._persist_max = persist_max_bytes() if persist_max is None \
            else int(persist_max)
        if persist_path:
            self._load_persist()

    # ------------------------------------------------- persistence
    def _load_persist(self) -> None:
        """Restore the version rings from the append-only file. A
        torn tail (SIGKILL mid-append) is truncated and counted —
        every complete line before it is usable."""
        import os as _os
        path = self._persist_path
        if _os.path.exists(path):
            with open(path, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        self.stats.bump("gw_sub_persist_torn")
                        break
                    try:
                        obj = json.loads(raw)
                        key = obj["k"]
                        st = obj["st"]
                        resp = obj["resp"]
                    except (ValueError, KeyError):
                        self.stats.bump("gw_sub_persist_torn")
                        continue
                    dq = self._versions.setdefault(
                        key, collections.deque(maxlen=self.history))
                    dq.append((st, resp))
                    if isinstance(obj.get("req"), dict):
                        self._req_of_key[key] = obj["req"]
        self._persist_f = open(path, "ab")
        keys = len(self._versions)
        if keys:
            self.stats.gauge("gw_sub_persist_restored_keys",
                             float(keys))
            log.info("subscription continuation: restored %d key "
                     "ring(s) from %s", keys, path)

    def _persist_append(self, key: str, resp: dict) -> None:
        f = self._persist_f
        if f is None:
            return
        line = json.dumps(
            {"k": key, "req": self._req_of_key.get(key),
             "st": resp.get("snaptick"), "resp": resp},
            default=str).encode() + b"\n"
        try:
            f.write(line)
            f.flush()
            self.stats.bump("gw_sub_persist_appends")
            if f.tell() > self._persist_max:
                self._persist_compact()
        except OSError:
            self.stats.bump("gw_sub_persist_errors")

    def _persist_compact(self) -> None:
        """Rewrite the file with only the LIVE rings (tmp + rename:
        a crash mid-compaction leaves the old complete file)."""
        import os as _os
        path = self._persist_path
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for key, dq in self._versions.items():
                req = self._req_of_key.get(key)
                for st, resp in dq:
                    f.write(json.dumps(
                        {"k": key, "req": req, "st": st,
                         "resp": resp}, default=str).encode() + b"\n")
            f.flush()
            _os.fsync(f.fileno())
        _os.replace(tmp, path)
        self._persist_f.close()
        self._persist_f = open(path, "ab")
        self.stats.bump("gw_sub_persist_compactions")

    def close(self) -> None:
        if self._persist_f is not None:
            try:
                self._persist_f.close()
            except OSError:         # pragma: no cover
                pass
            self._persist_f = None

    # ------------------------------------------------------------ gauges
    def _gauge(self) -> None:
        self.stats.gauge("gw_subscribers", float(len(self._subs)))
        self.stats.gauge("gw_sub_keys", float(len(self._by_key)))
        self.stats.gauge("cq_groups", float(len(self._cq_groups)))
        self.stats.gauge("cq_subscribers", float(
            sum(len(g.subs) for g in self._cq_groups.values())))

    @property
    def nsubs(self) -> int:
        return len(self._subs)

    # --------------------------------------------------------- lifecycle
    async def subscribe(self, req: dict, send, last_snaptick=None,
                        conn_tag=None) -> int:
        """Register one subscription; ``send`` is ``async (event) ->
        None``. The initial event (full / delta-from-last-seen / ack)
        is delivered before this returns. Raises
        :class:`SubscribeError` on a bad envelope or at capacity."""
        if len(self._subs) >= self.max_subs:
            self.stats.bump("gw_subs_rejected|reason=capacity")
            raise SubscribeError(
                f"subscription capacity {self.max_subs} reached")
        req = {k: v for k, v in req.items() if k not in _SUB_FIELDS}
        if any(k in req for k in ("op", "multiquery", "at", "window",
                                  "tstart", "tend")):
            self.stats.bump("gw_subs_rejected|reason=envelope")
            raise SubscribeError(
                "subscriptions carry live point-in-time queries only")
        if req.get("consistency") == "strong":
            self.stats.bump("gw_subs_rejected|reason=envelope")
            raise SubscribeError(
                "subscriptions serve the snapshot tier "
                "(consistency=strong cannot stream)")
        if req.get("cq"):
            return await self._subscribe_cq(req, send, last_snaptick,
                                            conn_tag)
        norm = normalize_request(req)
        key = request_key(norm)
        self._seq += 1
        sid = self._seq
        self._req_of_key[key] = dict(norm)
        # a ring with no LIVE subscribers (retained across
        # disconnects, or restored from the persist file after a
        # restart) is a delta BASE, not a current view: fetch fresh,
        # append it to the ring, and the reconnect below replays the
        # missing delta from the client's last-seen version
        cur = self._latest(key) if self._by_key.get(key) else None
        if cur is None:
            resp = await self._fetch(dict(norm))
            # another subscriber may have raced the fetch; keep the
            # newest version only once
            latest = self._latest(key)
            if latest is None or latest[0] != resp.get("snaptick"):
                self._push_version(key, resp)
            cur = self._latest(key)
        tick, resp = cur
        ev = None
        resync = False
        if last_snaptick is not None and last_snaptick == tick:
            ev = D.ack_event(tick)
        elif last_snaptick is not None:
            held = self._version_at(key, last_snaptick)
            if held is not None:
                ev, db, fb = D.compute_event(held, resp,
                                             self.max_ratio)
                self.stats.bump("gw_delta_bytes", db)
                self.stats.bump("gw_full_bytes", fb)
                self.stats.bump("gw_sub_resumes")
            else:
                # continuation gap: the ring no longer covers the
                # client's version — a full resync, COUNTED and
                # marked in-band, never silent
                self.stats.bump("gw_resyncs")
                self.stats.bump("gw_sub_resyncs")
                resync = True
        if ev is None and not (last_snaptick is not None
                               and last_snaptick == tick):
            ev = D.full_event(resp)
            if resync:
                ev = dict(ev)
                ev["resync"] = True
        sub = _Sub(sid, key, send, tick, conn_tag)
        self._subs[sid] = sub
        self._by_key.setdefault(key, {})[sid] = sub
        self._gauge()
        self.stats.bump("gw_subs_registered")
        try:
            await send(ev)
            self.stats.bump("gw_sub_events")
        except Exception:
            self.unsubscribe(sid)
            raise
        return sid

    # ------------------------------------------------ continuous queries
    async def _subscribe_cq(self, req: dict, send, last_snaptick,
                            conn_tag) -> int:
        """Register one STANDING FILTER (``cq: true``): validate +
        canonicalize the criteria, land the subscriber in its
        ``(subsys, canonical-filter)`` group, prime membership from
        the shared panel state (one render at most — none when the
        panel is already live), and deliver the initial event chain:
        full / enter+change+leave-from-last-seen / ack."""
        extra = set(req) - {"subsys", "filter", "cq"}
        if extra:
            self.stats.bump("gw_subs_rejected|reason=envelope")
            raise SubscribeError(
                f"a continuous query is subsys+filter only "
                f"(membership is a set): unexpected {sorted(extra)}")
        subsys = req.get("subsys")
        filt = req.get("filter")
        if not subsys or not filt:
            self.stats.bump("gw_subs_rejected|reason=envelope")
            raise SubscribeError(
                "a continuous query needs subsys and filter")
        try:
            canon, tree = CQ.parse_standing(subsys, filt)
        except ValueError as e:
            self.stats.bump("gw_subs_rejected|reason=filter")
            raise SubscribeError(str(e)) from e
        key = CQ.group_key(subsys, canon)
        self._req_of_key[key] = CQ.normalize_cq(subsys, canon)
        group = self._cq_groups.get(key)
        if group is None:
            m = CQ.Membership(subsys, canon, tree)
            # a retained / persist-restored membership version is the
            # resume BASE: restore it, then prime against the current
            # panel below so held clients get enter/leave deltas
            latest = self._latest(key)
            if latest is not None:
                m.members = CQ.members_of_response(latest[1])
                m.snaptick = latest[0]
            group = _CQGroup(key, m)
            await self._prime_cq(group)
            self._cq_groups[key] = group
        tick = group.m.snaptick
        evs = None
        if last_snaptick is not None and last_snaptick == tick:
            evs = [D.ack_event(tick)]
        elif last_snaptick is not None:
            held = self._version_at(key, last_snaptick)
            if held is not None:
                tmp = CQ.Membership(
                    subsys, canon, None, kf=group.m.kf,
                    members=CQ.members_of_response(held),
                    snaptick=last_snaptick)
                e, c, lv = CQ.rebuild(tmp, group.m.members, tick)
                evs = CQ.events_of(last_snaptick, tick, group.m.kf,
                                   e, c, lv)
                if not evs:
                    # same membership at a newer tick (changed, then
                    # changed back): an empty change advances the
                    # client's version without a resync
                    evs = [{"t": "change", "snaptick": tick,
                            "base": last_snaptick, "kf": group.m.kf,
                            "rows": {}}]
                self.stats.bump("gw_sub_resumes")
            else:
                self.stats.bump("gw_resyncs")
                self.stats.bump("gw_sub_resyncs")
                self.stats.bump("cq_resyncs")
                ev = dict(D.full_event(CQ.response_of(group.m)))
                ev["resync"] = True
                evs = [ev]
        if evs is None:
            evs = [D.full_event(CQ.response_of(group.m))]
        self._seq += 1
        sid = self._seq
        sub = _Sub(sid, key, send, tick, conn_tag)
        self._subs[sid] = sub
        group.subs[sid] = sub
        self._gauge()
        self.stats.bump("gw_subs_registered")
        try:
            for ev in evs:
                await send(ev)
                self.stats.bump("gw_sub_events")
        except Exception:
            self.unsubscribe(sid)
            raise
        return sid

    async def _prime_cq(self, group: _CQGroup) -> None:
        """Bring a new/retained/restored group's membership to the
        CURRENT panel tick. Reuses the live shared panel state when
        another group already keeps it hot (no render); otherwise one
        render, which then seeds the panel state every later group on
        this subsystem shares."""
        m = group.m
        panel = self._cq_panels.get(m.subsys)
        if panel is None or panel.prev is None:
            resp = await self._fetch(CQ.panel_request(m.subsys))
            rows = resp.get("recs") or []
            prev = {}
            for r in rows:
                prev[CQ.row_key(r, m.kf)] = r
            panel = _CQPanel(prev, resp.get("snaptick"))
            self._cq_panels[m.subsys] = panel
            self.stats.bump("cq_panel_renders")
        rows = list(panel.prev.values())
        mask = CQ.match_mask(m.tree, m.subsys, rows)
        new_members = {k: r for (k, r), hit
                       in zip(panel.prev.items(), mask) if hit}
        changed = CQ.rebuild(m, new_members, panel.tick)
        if m.snaptick is None:
            m.snaptick = panel.tick
        latest = self._latest(group.key)
        if latest is None or latest[0] != m.snaptick \
                or any(changed):
            self._push_version(group.key, CQ.response_of(m))

    def unsubscribe(self, sid: int) -> None:
        sub = self._subs.pop(sid, None)
        if sub is None:
            return
        grp = self._by_key.get(sub.key)
        if grp is not None:
            grp.pop(sid, None)
            if not grp:
                # last subscriber gone: the key stops costing a render
                # per tick, but its version ring is RETAINED (bounded
                # by ``retain``) so a reconnect with last_snaptick
                # resumes with a delta instead of a resync
                self._by_key.pop(sub.key, None)
                self._evict_retained()
        cg = self._cq_groups.get(sub.key)
        if cg is not None:
            cg.subs.pop(sid, None)
            if not cg.subs:
                # last standing subscriber gone: the group stops
                # costing a predicate pass; its membership version
                # ring is RETAINED like any subscription key, so a
                # re-subscribe rebuilds the group and resumes with
                # enter/leave deltas
                self._cq_groups.pop(sub.key, None)
                if not any(g.m.subsys == cg.m.subsys
                           for g in self._cq_groups.values()):
                    self._cq_panels.pop(cg.m.subsys, None)
                self._evict_retained()
        self._gauge()

    def _evict_retained(self) -> None:
        live = len(self._by_key) + len(self._cq_groups)
        over = len(self._versions) - live - self.retain
        if over <= 0:
            return
        for key in list(self._versions):
            if over <= 0:
                break
            if key in self._by_key or key in self._cq_groups:
                continue
            self._versions.pop(key, None)
            self._req_of_key.pop(key, None)
            self.stats.bump("gw_sub_retained_evicted")
            over -= 1

    def conn_subscribed(self, conn_tag) -> bool:
        return any(s.conn_tag == conn_tag
                   for s in self._subs.values())

    def unsubscribe_conn(self, conn_tag) -> int:
        sids = [s.sid for s in self._subs.values()
                if s.conn_tag == conn_tag]
        for sid in sids:
            self.unsubscribe(sid)
        return len(sids)

    # ---------------------------------------------------------- versions
    def _latest(self, key):
        dq = self._versions.get(key)
        return dq[-1] if dq else None

    def _version_at(self, key, tick):
        dq = self._versions.get(key) or ()
        for t, resp in dq:
            if t == tick:
                return resp
        return None

    def _push_version(self, key, resp) -> None:
        dq = self._versions.setdefault(
            key, collections.deque(maxlen=self.history))
        dq.append((resp.get("snaptick"), resp))
        self._persist_append(key, resp)

    # -------------------------------------------------------------- push
    async def push_tick(self) -> int:
        """``snaptick`` advanced: render each subscribed query once,
        diff once, deliver to every subscriber. Returns events sent.
        A failing subscriber (dead conn, send deadline) is dropped and
        counted — one wedged dashboard cannot stall the tier."""
        sent = 0
        fetched: dict = {}
        for key in list(self._by_key):
            grp = self._by_key.get(key)
            req = self._req_of_key.get(key)
            if not grp or req is None:
                continue
            with self.stats.timeit("gw_push"):
                try:
                    resp = await self._fetch(dict(req))
                except Exception as e:      # noqa: BLE001 — counted
                    # upstream shed/error: subscribers keep their last
                    # version; next tick retries
                    self.stats.bump("gw_sub_fetch_errors")
                    log.debug("subscription fetch failed for %s: %s",
                              req.get("subsys"), e)
                    continue
                fetched[key] = resp
                try:
                    sent += await self._push_key(key, grp, resp)
                except Exception as e:      # noqa: BLE001 — counted
                    # malformed response / diff failure: contain it to
                    # THIS key — the remaining subscriptions still get
                    # their tick, and the watcher must not mark the
                    # upstream down for it
                    self.stats.bump("gw_sub_push_errors")
                    log.debug("subscription push failed for %s: %s",
                              req.get("subsys"), e)
        if self._cq_groups:
            sent += await self._push_cq(fetched)
        return sent

    async def _push_cq(self, fetched: dict) -> int:
        """Advance every live criteria group: per subsystem, ONE panel
        render (reused from this tick's regular pushes when a plain
        subscriber already paid for it), ONE row-keyed diff, and per
        group ONE predicate pass over only the CHANGED rows — then
        enter/change/leave events (or heartbeat acks) to every
        subscriber."""
        sent = 0
        by_subsys: dict[str, list] = {}
        for g in self._cq_groups.values():
            if g.subs:
                by_subsys.setdefault(g.m.subsys, []).append(g)
        for subsys, groups in by_subsys.items():
            with self.stats.timeit("cq_push"):
                preq = CQ.panel_request(subsys)
                pkey = request_key(normalize_request(preq))
                resp = fetched.get(pkey)
                if resp is not None:
                    self.stats.bump("cq_panel_render_shared")
                else:
                    try:
                        resp = await self._fetch(preq)
                    except Exception as e:  # noqa: BLE001 — counted
                        # upstream shed/error: membership holds, next
                        # tick retries (subscribers see a quiet tick)
                        self.stats.bump("cq_fetch_errors")
                        log.debug("cq panel fetch failed for %s: %s",
                                  subsys, e)
                        continue
                    self.stats.bump("cq_panel_renders")
                try:
                    sent += await self._push_cq_panel(
                        subsys, groups, resp)
                except Exception as e:      # noqa: BLE001 — counted
                    self.stats.bump("gw_sub_push_errors")
                    log.debug("cq push failed for %s: %s", subsys, e)
        return sent

    async def _push_cq_panel(self, subsys, groups, resp) -> int:
        sent = 0
        tick = resp.get("snaptick")
        panel = self._cq_panels.get(subsys)
        if panel is not None and panel.tick == tick:
            return 0                    # no advance for this panel
        kf = groups[0].m.kf
        curr = {}
        for r in resp.get("recs") or []:
            curr[CQ.row_key(r, kf)] = r
        if panel is not None and panel.prev is not None:
            changed_keys, changed_rows, removed = \
                CQ.panel_diff(panel.prev, curr)
            full_pass = False
        else:                           # pragma: no cover — defensive
            changed_keys = list(curr.keys())
            changed_rows = list(curr.values())
            removed = []
            full_pass = True
        cols = CQ.columns_of_rows(subsys, changed_rows) \
            if changed_rows else {}
        for g in groups:
            # THE amortization contract: one bump per live group per
            # tick — gyt_cq_group_evals_total / ticks == n_groups, no
            # matter how many subscribers stand behind each group
            self.stats.bump("cq_group_evals")
            base = g.m.snaptick
            try:
                if changed_rows:
                    match = CQ.match_mask(g.m.tree, subsys,
                                          changed_rows, cols)
                else:
                    match = ()
                if full_pass:
                    new_members = {
                        k: r for k, r, hit
                        in zip(changed_keys, changed_rows, match)
                        if hit}
                    e, c, lv = CQ.rebuild(g.m, new_members, tick)
                else:
                    e, c, lv = CQ.advance(g.m, changed_keys,
                                          changed_rows, match,
                                          removed, tick)
            except Exception as ex:     # noqa: BLE001 — counted
                # a row the predicate cannot evaluate (projected
                # response, bad field): contain to THIS group
                self.stats.bump("cq_eval_errors")
                log.debug("cq eval failed for %s: %s", g.m.filt, ex)
                continue
            evs = CQ.events_of(base, g.m.snaptick, g.m.kf, e, c, lv)
            for ev in evs:
                self.stats.bump(f"cq_events|kind={ev['t']}")
            if evs:
                self._push_version(g.key, CQ.response_of(g.m))
            full_ev = None
            for sub in list(g.subs.values()):
                if evs and sub.last_tick == base:
                    out = evs
                elif not evs and sub.last_tick == g.m.snaptick:
                    # quiet tick: heartbeat so stall detection holds
                    # (every tick delivers ≥1 event per subscription)
                    out = [D.ack_event(g.m.snaptick)]
                else:
                    # late joiner / missed a tick: full resync
                    if full_ev is None:
                        full_ev = D.full_event(CQ.response_of(g.m))
                        self.stats.bump("gw_resyncs")
                        self.stats.bump("cq_resyncs")
                    out = [full_ev]
                try:
                    for ev in out:
                        await sub.send(ev)
                        self.stats.bump("gw_sub_events")
                    sub.last_tick = g.m.snaptick
                    sent += 1
                except Exception:       # noqa: BLE001 — dead conn
                    self.stats.bump("gw_sub_dropped")
                    self.unsubscribe(sub.sid)
        self._cq_panels[subsys] = _CQPanel(curr, tick)
        return sent

    async def _push_key(self, key, grp, resp) -> int:
        """Diff + deliver one subscribed query's new version. Raises
        on malformed responses — push_tick contains that per key."""
        sent = 0
        prev = self._latest(key)
        tick = resp.get("snaptick")
        if prev is not None and prev[0] == tick:
            return 0                     # no advance for this key
        ev = None
        if prev is not None:
            ev, db, fb = D.compute_event(prev[1], resp,
                                         self.max_ratio)
            self.stats.bump("gw_delta_bytes", db)
            self.stats.bump("gw_full_bytes", fb)
            if ev["t"] == "delta":
                self.stats.bump("gw_deltas_pushed")
            else:
                self.stats.bump("gw_resyncs")
        full_ev = None
        for sub in list(grp.values()):
            if prev is not None and sub.last_tick == prev[0] \
                    and ev is not None:
                out = ev
            elif sub.last_tick == tick:
                continue
            else:
                # late joiner / missed a tick: full resync
                if full_ev is None:
                    full_ev = D.full_event(resp)
                    self.stats.bump("gw_resyncs")
                out = full_ev
            try:
                await sub.send(out)
                sub.last_tick = tick
                sent += 1
                self.stats.bump("gw_sub_events")
            except Exception:           # noqa: BLE001 — dead conn
                self.stats.bump("gw_sub_dropped")
                self.unsubscribe(sub.sid)
        self._push_version(key, resp)
        return sent


# ===================================================================
# client halves
# ===================================================================

class SubscribeClient:
    """GYT binary subscription conn: registers as a query client, sends
    ONE ``COMM_SUBSCRIBE_CMD`` and then iterates the pushed event
    stream. One subscription per conn (the stream owns the read side;
    multiplexing poll queries over it would race the pushes)."""

    def __init__(self, machine_id: Optional[int] = None):
        from gyeeta_tpu_torch.utils import hashing as H
        self.machine_id = machine_id if machine_id is not None \
            else H.hash_bytes_np(b"subscribe-client")
        self._reader = None
        self._writer = None
        self._seq = 0

    async def connect(self, host: str, port: int,
                      timeout: float = 10.0) -> None:
        from gyeeta_tpu_torch.ingest import wire
        from gyeeta_tpu_torch.net.agent import register
        reader, writer, status, _ = await asyncio.wait_for(
            register(host, port, self.machine_id, wire.CONN_QUERY),
            timeout)
        if status != wire.REG_OK:
            writer.close()
            raise ConnectionRefusedError(f"registration status {status}")
        self._reader, self._writer = reader, writer

    async def subscribe(self, req: dict,
                        last_snaptick=None) -> None:
        from gyeeta_tpu_torch.ingest import wire
        self._seq += 1
        body = dict(req)
        if last_snaptick is not None:
            body["last_snaptick"] = last_snaptick
        payload = json.dumps(body).encode()
        import numpy as np
        h = np.zeros((), wire.QUERY_HDR_DT)
        h["seqid"] = np.uint64(self._seq)
        h["nbytes"] = len(payload)
        self._writer.write(wire._frame(          # noqa: SLF001
            wire.COMM_SUBSCRIBE_CMD, h.tobytes() + payload,
            wire.MAGIC_NQ))
        await self._writer.drain()

    async def events(self, stall_timeout: Optional[float] = None):
        """Async-iterate pushed event dicts until the conn closes.
        A QS_ERROR frame raises RuntimeError with the server's error.
        ``stall_timeout`` (seconds; callers use ~3x the tick
        interval) raises a typed :class:`SubscriptionStalled` when no
        event arrives in time — every tick delivers at least one
        event per subscription, so prolonged silence means the hub or
        the path to it is WEDGED even though the conn looks alive;
        without it a frozen hub would park the consumer forever."""
        from gyeeta_tpu_torch.ingest import wire
        while True:
            try:
                if stall_timeout is not None and stall_timeout > 0:
                    dtype, payload = await asyncio.wait_for(
                        wire.read_frame(self._reader), stall_timeout)
                else:
                    dtype, payload = await wire.read_frame(
                        self._reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except (asyncio.TimeoutError, TimeoutError):
                raise SubscriptionStalled(
                    f"no subscription event within "
                    f"{stall_timeout:.1f}s (hub frozen or path "
                    f"wedged)") from None
            if dtype != wire.COMM_QUERY_RESP:
                raise wire.FrameError(
                    f"expected QUERY_RESP on subscription, got {dtype}")
            _seqid, status, body = wire.decode_query_chunk(payload)
            obj = json.loads(body or b"null")
            if status == wire.QS_ERROR:
                raise RuntimeError(
                    (obj or {}).get("error", "subscription error"))
            yield obj

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None


class SubscribeStream:
    """Supervised subscription with the agent spool's at-least-once /
    no-gap contract across GATEWAY failures: connect to the first
    reachable endpoint, subscribe, apply events; on conn loss, stall
    (:class:`SubscriptionStalled`) or rejection, reconnect with
    ``last_snaptick`` — rotating endpoints with jittered backoff, so
    a killed gateway hands its subscribers to a peer (or its own
    restart). A continuation gap arrives as a counted full resync
    (``counters["resyncs"]``), never silently: the yielded responses
    are byte-identical to an uninterrupted subscription's at every
    common snaptick (property-tested in ``tests/test_failover.py``).
    """

    def __init__(self, endpoints, req: dict,
                 stall_timeout: Optional[float] = None,
                 backoff_base: float = 0.25, backoff_cap: float = 5.0,
                 machine_id: Optional[int] = None):
        if not endpoints:
            raise ValueError("SubscribeStream needs >=1 endpoint")
        self.endpoints = [tuple(e) for e in endpoints]
        self.req = dict(req)
        self.stall_timeout = stall_timeout
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.machine_id = machine_id
        self.held: Optional[dict] = None
        self.last_snaptick = None
        self.counters: collections.Counter = collections.Counter()
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    async def responses(self):
        """Async-iterate reassembled FULL responses, one per applied
        event, forever (until :meth:`stop`). Reconnects internally;
        consumers only ever see complete views."""
        import random as _r
        ep = 0
        backoff = self.backoff_base
        while not self._stop:
            sc = SubscribeClient(machine_id=self.machine_id)
            host, port = self.endpoints[ep % len(self.endpoints)]
            try:
                await sc.connect(host, port)
                await sc.subscribe(self.req,
                                   last_snaptick=self.last_snaptick)
                backoff = self.backoff_base
                async for ev in sc.events(
                        stall_timeout=self.stall_timeout):
                    self.counters["events"] += 1
                    # what actually crossed the wire: the EVENT (delta
                    # or full), not the reassembled view — consumers
                    # (the hub-mode gateway's inter-region relay) use
                    # this to prove bytes ∝ delta churn, not panel size
                    self.counters["event_bytes"] += len(
                        json.dumps(ev, separators=(",", ":")))
                    if ev.get("t") == "full" and ev.get("resync"):
                        self.counters["resyncs"] += 1
                    try:
                        held = D.apply_event(self.held, ev)
                    except D.ResyncRequired:
                        # base gap mid-stream (hub ring aged out):
                        # drop the held version and force a full on
                        # the re-subscribe — counted, never silent
                        self.counters["forced_resyncs"] += 1
                        self.held = None
                        self.last_snaptick = None
                        break
                    if ev.get("t") == "ack":
                        continue            # nothing new to yield
                    self.held = held
                    self.last_snaptick = held.get("snaptick")
                    yield held
                self.counters["conn_lost"] += 1
            except SubscriptionStalled:
                self.counters["stalls"] += 1
            except (ConnectionError, OSError, RuntimeError,
                    asyncio.IncompleteReadError):
                self.counters["conn_errors"] += 1
            finally:
                await sc.close()
            if self._stop:
                return
            ep += 1                         # rotate endpoints
            self.counters["reconnects"] += 1
            await asyncio.sleep(backoff * (0.5 + _r.random()))
            backoff = min(backoff * 2.0, self.backoff_cap)


async def read_sse_events(reader):
    """Parse an SSE byte stream → async iterator of event dicts (the
    ``data:`` JSON payloads; comments and event/id lines skipped —
    the event type rides inside the JSON as ``t``)."""
    buf = b""
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            return
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            data_lines = [ln[5:].strip() for ln in block.split(b"\n")
                          if ln.startswith(b"data:")]
            if data_lines:
                yield json.loads(b"\n".join(data_lines))
