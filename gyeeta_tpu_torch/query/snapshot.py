"""Snapshot-isolated query serving: per-tick immutable engine views.

Counterpart of ``gyeeta_tpu/query/snapshot.py``. Each tick the runtime
publishes an :class:`EngineSnapshot`: the state and the dependency graph
CLONED on the device (every fold of the port writes into the live
tensors in place, so a snapshot that aliased them would change under the
next ``feed``), a snapshot-scoped
:class:`~gyeeta_tpu_torch.utils.colcache.ColumnCache` and a result cache
keyed by the normalized request. The runtime swaps ``rt.snapshot`` — a
plain attribute store — so readers of snapshot N never see the folds
that build N+1, and a dashboard's repeated queries cost one render a
tick.

Snapshot state is never written after the publish, so device readbacks
from any number of query threads are safe. Per-request and
per-subsystem locks make concurrent identical misses on a fresh
snapshot render once (single flight). Host-side registries stay shared
with the live runtime: their renders run under the runtime's registry
lock and are memoized per snapshot; a CRUD mutation clears this
snapshot's caches (:meth:`EngineSnapshot.on_mutation`).

A snapshot of the sharded runtime (``parallel/shardedrt.py``) holds
every shard's cloned state and graph as lists; its columns come from
the runtime's merged-columns pipeline over them, its heavy hitters from
the rollup of the frozen shards, and it serves ``shardlist``.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from gyeeta_tpu_torch.engine import step
from gyeeta_tpu_torch.query import api
from gyeeta_tpu_torch.query.lazycols import rows_of
# the result cache's key: the normalized request (query/normalize.py)
from gyeeta_tpu_torch.query.normalize import request_key
from gyeeta_tpu_torch.sketch import invertible
from gyeeta_tpu_torch.utils.colcache import ColumnCache

# registry-backed renders race host-side mutators the registry lock does
# not cover (notification-log appends from the tick loop, alert
# bookkeeping during a check): a concurrent structural mutation raises
# RuntimeError("... changed size/mutated during iteration"), rare at
# per-snapshot memo frequency, so a short retry is the remedy
_AUX_RETRIES = 3

# aux views served straight from host-side registries (no device state
# in their providers): the runtime's live aux table, under its lock
_REGISTRY_AUX = frozenset((
    "hostinfo", "cgroupstate", "mountstate", "netif", "alerts",
    "alertdef", "silences", "inhibits", "actions", "notifymsg",
    "svcipclust", "tags", "tracedef", "tracestatus",
))

# ext views: the base subsystem ⋈ svcinfo, and the join's id column
_EXT_BASE = {"extactiveconn": ("activeconn", "svcid"),
             "extclientconn": ("clientconn", "cliid"),
             "exttracereq": ("tracereq", "svcid")}


def recover(cfg, state) -> dict:
    """Heavy-hitter key recovery from a state (live or frozen): one
    read-only device pass (``step.heavy_recover``) read back once, then
    the host merge of the exact top-K lanes and the verified candidates
    → {"flows", "recovered", "hot", "err_term", "total_mass",
    "evicted"}."""
    return _merge_recovered(cfg, {
        k: v.cpu().numpy()
        for k, v in step.heavy_recover(cfg, state).items()})


def recover_rollup(cfg, ru) -> dict:
    """Heavy-hitter recovery from a sharded runtime's
    ``rollup.GlobalRollup`` (candidates decoded on every shard and
    estimated against the merged CMS, the merged exact top-K lanes),
    read back once and merged on the host → the keys of
    :func:`recover`."""
    out = {
        "topk_hi": ru.flow_topk.key_hi, "topk_lo": ru.flow_topk.key_lo,
        "topk_counts": ru.flow_topk.counts, "topk_est": ru.hh_topk_est,
        "hh_hi": ru.hh_hi, "hh_lo": ru.hh_lo, "hh_ok": ru.hh_ok,
        "hh_est": ru.hh_est, "evicted": ru.flow_topk.evicted,
        "total_mass": ru.hh_total_mass}
    return _merge_recovered(cfg, {k: v.cpu().numpy()
                                  for k, v in out.items()})


def recover_state(rt, state) -> dict:
    """:func:`recover` of one state, or :func:`recover_rollup` of a
    sharded runtime's per-shard state list."""
    if isinstance(state, list):
        return recover_rollup(rt.cfg, rt._roll(state))
    return recover(rt.cfg, state)


def _merge_recovered(cfg, out: dict) -> dict:
    evicted = float(out["evicted"])
    total = float(out["total_mass"])
    err_term = invertible.cms_error_term(total, cfg.cms_width)
    hot_thresh = (cfg.hh_hot_frac * total if cfg.hh_hot_frac > 0 else 0.0)
    flows, recovered, hot = invertible.merge_recovered_np(
        out, err_term, hot_thresh)
    return {"flows": flows, "recovered": recovered, "hot": hot,
            "err_term": err_term, "total_mass": total, "evicted": evicted}


class EngineSnapshot:
    """One immutable published engine view: the ``columns_fn`` of
    :func:`gyeeta_tpu_torch.query.api.execute` plus a result cache.

    ``state``/``dep`` are device clones of the runtime's at publish
    time. ``version`` rises by one each publish; ``tick`` is the window
    tick the view was frozen at."""

    def __init__(self, rt, state, dep, tick: int, published_at: float,
                 version: int, result_cache_max: int = 1024):
        self.rt = rt
        self.state = state
        self.dep = dep
        self.tick = int(tick)
        self.published_at = float(published_at)
        self.version = int(version)
        self._cols = ColumnCache()
        self._results: collections.OrderedDict = collections.OrderedDict()
        self._results_max = int(result_cache_max)
        self._lock = threading.Lock()
        # single flight: per-request and per-subsystem compute locks
        # (keyed locks form a DAG — topk → svcstate/tracereq,
        # traceuniq → tracereq — so they cannot deadlock)
        self._flight: dict = {}

    def _flight_lock(self, key) -> threading.Lock:
        with self._lock:
            lk = self._flight.get(key)
            if lk is None:
                lk = self._flight[key] = threading.Lock()
            return lk

    # ------------------------------------------------------ result cache
    def query(self, req: dict) -> dict:
        """Serve one live query from this snapshot; repeated identical
        requests hit the result cache (``query_cache_hits`` /
        ``query_cache_misses``), concurrent ones render once."""
        stats = self.rt.stats
        key = request_key(req)
        if self._results_max <= 0:
            stats.bump("query_cache_misses")
            return self._render(req)
        with self._lock:
            hit = self._results.get(key)
        if hit is not None:
            stats.bump("query_cache_hits")
            return hit
        with self._flight_lock(("r", key)):
            with self._lock:              # the holder may have stored
                hit = self._results.get(key)
            if hit is not None:
                stats.bump("query_cache_hits")
                return hit
            stats.bump("query_cache_misses")
            out = self._render(req)
            with self._lock:
                self._results[key] = out
                while len(self._results) > self._results_max:
                    self._results.popitem(last=False)
            return out

    def _render(self, req: dict) -> dict:
        out = api.execute(self.rt.cfg, None,
                          api.QueryOptions.from_json(req),
                          names=self.rt.names, columns_fn=self.columns)
        out["snaptick"] = self.tick
        return out

    def on_mutation(self) -> None:
        """CRUD invalidation hook: a registry, alert or tracedef
        mutation changes aux views mid-snapshot, so both caches drop
        (device-backed columns recompute from the frozen state)."""
        with self._lock:
            self._results.clear()
        self._cols.bump()

    def result_cache_len(self) -> int:
        with self._lock:
            return len(self._results)

    # ---------------------------------------------------------- columns
    def columns(self, subsys: str):
        """(cols, mask) for ``subsys`` over the frozen view, memoized per
        snapshot: queries differing only in filter, sort or projection
        share one readback. A ``subsys@window`` source (a windowed
        alertdef) reads the time-travel tier's windowed aggregate (shard
        files, not live state: safe from any thread)."""
        if "@" in subsys:
            base, _, win = subsys.partition("@")
            tv = getattr(self.rt, "timeview", None)
            if tv is None:
                raise ValueError("windowed alertdef needs history "
                                 "shards (hist_shard_dir)")
            return tv.window_columns_for(base, win)
        got = self._cols.peek(subsys)
        if got is not None:
            return got
        with self._flight_lock(("c", subsys)):
            return self._cols.get(subsys, lambda: self._columns(subsys))

    def _columns(self, subsys: str):
        rt = self.rt
        if subsys in _REGISTRY_AUX:
            return self._retry_aux(rt._aux[subsys])
        if subsys == "topk":
            return self._topk_columns()
        if subsys == "hostlist":
            return self._hostlist_columns()
        if subsys == "serverstatus":
            return self._serverstatus_columns()
        if subsys == "traceuniq":
            tcols, tlive = self.columns("tracereq")
            return api.traceuniq_from_trace(tcols, tlive)
        if subsys == "traceconn":
            return self._retry_aux(lambda: rt.traceconns.columns(
                rt.names, svc_task_ids=self._svc_task_ids()))
        if subsys in _EXT_BASE:
            base, idcol = _EXT_BASE[subsys]
            cols, live = self.columns(base)
            info_cols, _ = self._retry_aux(
                lambda: rt.svcreg.columns(rt.names))
            return api.info_join(cols, live, info_cols, idcol=idcol)
        if isinstance(self.state, list):            # sharded runtime
            if subsys == "shardlist":
                return rt._shardlist_columns(self.state)
            return rt._merged_columns_state(subsys, self.state, self.dep,
                                            self._cols, reg=True)
        out = api.columns_for(rt.cfg, self.state, subsys, names=rt.names,
                              dep=self.dep, svcreg=rt.svcreg)
        if subsys == "procinfo":
            # tags mutate through CRUD, which clears this snapshot's
            # caches: the join inside the memo stays consistent
            out = rt.tags.with_tags(out)
        return out

    def _retry_aux(self, fn):
        """Run a host-side registry render under the registry lock,
        retrying the rare iteration-vs-mutation race."""
        for attempt in range(_AUX_RETRIES):
            try:
                with self.rt._reg_lock:
                    return fn()
            except RuntimeError as e:
                if attempt + 1 == _AUX_RETRIES or (
                        "changed size" not in str(e)
                        and "mutated" not in str(e)):
                    raise
        raise AssertionError("unreachable")

    # ------------------------------------------- state-backed aux views
    def _topk_columns(self):
        """Heavy-hitter recovery over the frozen state (read-only)."""
        rec = self._cols.get("__hh_recover",
                             lambda: recover_state(self.rt, self.state))
        return api.heavy_topk_columns(
            rec["flows"], svc=self.columns("svcstate"),
            trace=self.columns("tracereq"))

    def _hostlist_columns(self):
        if isinstance(self.state, list):
            return self.rt.hostlist_columns(self.state, self.tick)
        return api.hostlist_columns(
            self.state.host_last_tick.cpu().numpy(), self.tick,
            self.rt.names)

    def _serverstatus_columns(self):
        """serverstatus over this snapshot's tick and host reports."""
        rt = self.rt
        if isinstance(self.state, list):
            ru = self._cols.get("__rollup", lambda: rt._roll(self.state))
            return rt.serverstatus_columns(
                tick=self.tick, nhosts=rt.nhosts_reported(self.state),
                nsvc=float(ru.n_svc_live))
        return rt.serverstatus_columns(
            tick=self.tick,
            nhosts=int((self.state.host_last_tick >= 0).sum()),
            nsvc=float(self.state.tbl.n_live))

    def _svc_task_ids(self):
        """Hex process-group ids that serve a listener (taskstate rows
        with a nonzero relsvcid): the ``traceconn`` view's server-side
        source."""
        cols, live = self.columns("taskstate")
        zero = "0" * 16
        idx = np.nonzero(np.asarray(live, bool))[0]
        got = rows_of(cols, ["taskid", "relsvcid"], idx)
        return {t for t, r in zip(got["taskid"], got["relsvcid"])
                if r != zero}
