"""Time-travel queries: ``at=``/``window=`` served from snapshot shards.

The read half of the history tier (``history/compactor.py`` writes the
shards): an ``at=<ts>`` request materializes the shard covering that
instant into a TRANSIENT engine snapshot — the serialized state leaves
re-enter the live state's shape on the serving runtime's device
(``aggstate.state_from_numpy`` / ``depgraph.dep_from_numpy``), so every
state-backed subsystem (including ``topk`` heavy-hitter recovery with
its honest error bounds, ``flowstate``, and the dep-graph views) is
served by the UNCHANGED ``query/api.py`` pipeline; relational
subsystems read the shard's stored column panels directly. A
``window=<dur>`` request aggregates per-entity across every shard
sampling the range (mean for numeric fields, last observation
otherwise; quantile fields from the merged per-window delta
histograms), and ``topk`` becomes a windowed DIFF: value = est(end) −
est(baseline), errbound = eb(end) + eb(baseline) — both ends are CMS
upper bounds, so the window count lies within ±errbound of the
reported value.

Counterpart of ``gyeeta_tpu/history/timeview.py``. A sharded runtime
reads a shard of stacked leaves back into its shards and the flat leaves
of the compactor's replay as one plain state; a parted store's window
(``PartedSnapshot``) materializes each part's flat leaves that way and
merges the parts at column level.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np

from gyeeta_tpu_torch.engine import aggstate
from gyeeta_tpu_torch.history import winquant as WQ
from gyeeta_tpu_torch.parallel import depgraph as dg, sharded
from gyeeta_tpu_torch.query import api, fieldmaps
from gyeeta_tpu_torch.query.lazycols import LazyCols
from gyeeta_tpu_torch.query.snapshot import recover, recover_state
from gyeeta_tpu_torch.utils.checkpoint import _ref_dtype
from gyeeta_tpu_torch.utils.colcache import ColumnCache
from gyeeta_tpu_torch.utils.tensor import tree_leaves

# suffix durations accepted by at=/window= ("90" = seconds)
_DUR_UNIT = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_dur(v) -> float:
    """Duration → seconds: 900, "900", "15m", "2h", "1d"."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    if s and s[-1] in _DUR_UNIT:
        return float(s[:-1]) * _DUR_UNIT[s[-1]]
    return float(s)


def parse_when(v, now: float):
    """``at=`` value → epoch seconds, or ``("tick", N)``.

    Accepts epoch numbers, ``-15m`` (relative to now) and ``tick:N``
    (window-tick pinned — what tests and the smoke use for exact shard
    addressing)."""
    if isinstance(v, str):
        s = v.strip()
        if s.startswith("tick:"):
            return ("tick", int(s[5:]))
        if s.startswith("-"):
            return now - parse_dur(s[1:])
        return float(s)
    return float(v)


def plain_recover(cfg, state) -> dict:
    """Heavy-hitter recovery + bound-honest merge over one state (a
    shard-materialized snapshot): the decode and merge of
    ``Runtime.heavy_recover`` through ``query/snapshot.recover``,
    without the live runtime's side effects (no stats, no promotion
    edge)."""
    rec = recover(cfg, state)
    return {"flows": rec["flows"], "err_term": rec["err_term"],
            "total_mass": rec["total_mass"], "evicted": rec["evicted"],
            "recovered_keys": len(rec["recovered"])}


def hist_recover(rt, state) -> dict:
    """Heavy-hitter key recovery from an arbitrary state of ``rt``'s
    geometry: :func:`plain_recover` of one state, or the rollup of a
    sharded runtime's per-shard state list (candidates estimated
    against the merged CMS)."""
    rec = recover_state(rt, state)
    return {"flows": rec["flows"], "err_term": rec["err_term"],
            "total_mass": rec["total_mass"], "evicted": rec["evicted"],
            "recovered_keys": len(rec["recovered"])}


def _window_layout(subsys: str, parts: list):
    """Shared front half of the window aggregators: column names and
    numeric/string/other classification from the LAST part's columns."""
    fmap = fieldmaps.field_map(subsys)
    kind_of = {fd.col: fd.kind for fd in fmap.values()}
    cols_last = parts[-1][0]
    names = [c for c in cols_last]
    keycols = [c for c in names if kind_of.get(c) == "str"]
    numcols = [c for c in names
               if c not in keycols and kind_of.get(c) == "num"]
    othcols = [c for c in names
               if c not in keycols and kind_of.get(c) != "num"]
    return kind_of, cols_last, names, keycols, numcols, othcols


def _positional_window(parts, names, kind_of, cols_last):
    """Key-less subsystems (clusterstate): aggregate positionally."""
    L = min(len(np.asarray(p[1])) for p in parts)
    out = {}
    for c in names:
        if kind_of.get(c) == "num":
            out[c] = np.mean(
                [np.asarray(p[0][c][:L], np.float64)
                 for p in parts], axis=0)
        else:
            out[c] = np.asarray(cols_last[c][:L])
    mask = np.zeros(L, bool)
    for p in parts:
        mask |= np.asarray(p[1][:L], bool)
    return out, mask


def aggregate_window_columns(subsys: str, parts: list):
    """Per-entity aggregate of column snapshots (oldest→newest):
    numeric fields average across the samples an entity appears in;
    string/enum/bool fields keep the LAST observation; the mask is the
    union of liveness. Entities are keyed by the subsystem's string
    identity columns; subsystems without one (clusterstate) aggregate
    positionally.

    Vectorized: the keyed python loop cost
    O(rows × columns) dict operations — a 131k-row shard over a 24h
    window took seconds per subsystem. Here grouping is ONE np.unique
    over a composite key plus bincount segment sums; group order is
    first appearance (matching the loop), and per-group numeric sums
    add in the same flat oldest→newest sequence, so results are
    bit-identical to :func:`aggregate_window_columns_ref`."""
    kind_of, cols_last, names, keycols, numcols, othcols = \
        _window_layout(subsys, parts)
    if not keycols:
        return _positional_window(parts, names, kind_of, cols_last)

    key_flat = {c: [] for c in keycols}
    num_flat = {c: [] for c in numcols}
    oth_flat = {c: [] for c in othcols}
    for cols, mask in parts:
        idx = np.nonzero(np.asarray(mask, bool))[0]
        for c in keycols:
            key_flat[c].append(np.asarray(cols[c])[idx])
        for c in numcols:
            num_flat[c].append(np.asarray(cols[c], np.float64)[idx])
        for c in othcols:
            oth_flat[c].append(np.asarray(cols[c])[idx])
    key_flat = {c: np.concatenate(v) for c, v in key_flat.items()}
    num_flat = {c: np.concatenate(v) for c, v in num_flat.items()}
    oth_flat = {c: np.concatenate(v) for c, v in oth_flat.items()}
    N = len(key_flat[keycols[0]])

    # composite group key: the str identity columns joined with an
    # unlikely separator (identity values are hex ids / names — \x1f
    # cannot appear in them)
    if N == 0:
        keys = np.empty(0, "U1")
    elif len(keycols) == 1:
        keys = key_flat[keycols[0]].astype("U")
    else:
        keys = key_flat[keycols[0]].astype("U")
        for c in keycols[1:]:
            keys = np.char.add(np.char.add(keys, "\x1f"),
                               key_flat[c].astype("U"))
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    # np.unique sorts; remap group ids to FIRST-APPEARANCE order so
    # output row order matches the reference loop
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    g = rank[inv]
    n = len(uniq)
    counts = np.bincount(g, minlength=n).astype(np.float64)
    first_rows = first[order]
    # last observation per group = max flat index (flat order IS
    # oldest→newest)
    last_rows = np.zeros(n, np.int64)
    if N:
        np.maximum.at(last_rows, g, np.arange(N))

    out = {}
    for c in keycols:
        col = np.empty(n, object)
        col[:] = key_flat[c][first_rows]
        out[c] = col
    for c in numcols:
        out[c] = (np.bincount(g, weights=num_flat[c], minlength=n)
                  / np.maximum(counts, 1.0))
    for c in othcols:
        ref = np.asarray(cols_last[c])
        vals = oth_flat[c][last_rows] if N else np.empty(0, ref.dtype)
        if ref.dtype == object or ref.dtype.kind in "US":
            col = np.empty(n, object)
            col[:] = vals
            out[c] = col
        else:
            out[c] = np.asarray(vals, ref.dtype)
    out = {c: out[c] for c in names if c in out}
    return out, np.ones(n, bool)


def aggregate_window_columns_ref(subsys: str, parts: list):
    """Reference implementation (the pre-vectorization keyed python
    loop) — kept for the parity test and the old-vs-new bench row;
    NOT on the serving path."""
    kind_of, cols_last, names, keycols, numcols, othcols = \
        _window_layout(subsys, parts)
    if not keycols:
        return _positional_window(parts, names, kind_of, cols_last)
    order: list = []
    acc: dict = {}
    for cols, mask in parts:
        mask = np.asarray(mask, bool)
        idx = np.nonzero(mask)[0]
        keys = list(zip(*(np.asarray(cols[c])[idx] for c in keycols))) \
            if len(idx) else []
        nums = {c: np.asarray(cols[c], np.float64)[idx]
                for c in numcols}
        oth = {c: np.asarray(cols[c])[idx] for c in othcols}
        for j, k in enumerate(keys):
            a = acc.get(k)
            if a is None:
                a = acc[k] = {"n": 0,
                              "sum": dict.fromkeys(numcols, 0.0),
                              "last": {}}
                order.append(k)
            a["n"] += 1
            for c in numcols:
                a["sum"][c] += float(nums[c][j])
            for c in othcols:
                a["last"][c] = oth[c][j]
    n = len(order)
    out = {}
    for ki, c in enumerate(keycols):
        col = np.empty(n, object)
        col[:] = [k[ki] for k in order]
        out[c] = col
    for c in numcols:
        out[c] = np.array([acc[k]["sum"][c] / acc[k]["n"]
                           for k in order], np.float64)
    for c in othcols:
        ref = np.asarray(cols_last[c])
        vals = [acc[k]["last"][c] for k in order]
        if ref.dtype == object or ref.dtype.kind in "US":
            col = np.empty(n, object)
            col[:] = vals
            out[c] = col
        else:
            out[c] = np.array(vals, ref.dtype)
    # restore original column order
    out = {c: out[c] for c in names if c in out}
    return out, np.ones(n, bool)


class HistSnapshot:
    """One shard materialized as a transient, ColumnCache-compatible
    engine snapshot: stored column panels serve the relational
    subsystems directly; everything state-backed (``topk``,
    ``flowstate``, the dep views, …) re-enters the live state's shape on
    the serving runtime's device and is produced by the unchanged
    column providers."""

    def __init__(self, rt, store, ent: dict):
        self.rt = rt
        self.store = store
        self.ent = ent
        self._data = None
        self._state = None
        self._dep = None
        self._cols = ColumnCache()        # per-snapshot memo (immutable
        #                                   shard → version never bumps)

    def _load(self) -> dict:
        """The shard's panels and meta; the state and dep leaves load
        only when a state-backed view materializes them."""
        if self._data is None:
            self._data = self.store.load(self.ent, leaves=False)
        return self._data

    def _check(self, leaves, like) -> list:
        """The shard's leaves, checked against the live tree's leaf count
        and shapes (metadata only) and cast to the reference's dtypes."""
        ref_leaves = tree_leaves(like)
        if len(leaves) != len(ref_leaves):
            raise ValueError(
                f"shard {self.ent['file']} has {len(leaves)} leaves, "
                f"engine expects {len(ref_leaves)} — incompatible "
                "geometry/version")
        fixed = []
        for arr, ref in zip(leaves, ref_leaves):
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"shard {self.ent['file']}: leaf shape {arr.shape} "
                    f"!= engine {tuple(ref.shape)}")
            fixed.append(arr.astype(_ref_dtype(ref), copy=False))
        return fixed

    def _materialize(self) -> None:
        data = self.store.load(self.ent)
        rt = self.rt
        if not isinstance(rt.state, list):
            self._state = aggstate.state_from_numpy(
                self._check(data["state"], rt.state), rt.device)
            self._dep = dg.dep_from_numpy(
                self._check(data["dep"], rt.dep), rt.device)
            return
        # a sharded runtime reads stacked (n, ...) leaves back into its
        # shards, and the flat leaves of a single-runtime replay (the
        # compactor's) as one plain state of the shards' geometry
        like = tree_leaves(rt.state[0])
        first = np.asarray(data["state"][0])
        if first.shape == (rt.n,) + tuple(like[0].shape):
            self._state = sharded.state_from_numpy(data["state"], rt.mesh)
            self._dep = sharded.dep_from_numpy(data["dep"], rt.mesh)
            return
        self._state = aggstate.state_from_numpy(
            self._check(data["state"], rt.state[0]), rt.device)
        self._dep = dg.dep_from_numpy(
            self._check(data["dep"], rt.dep[0]), rt.device)

    @property
    def state(self):
        if self._state is None:
            self._materialize()
        return self._state

    @property
    def dep(self):
        if self._dep is None:
            self._materialize()
        return self._dep

    def delta_names(self) -> set:
        """Delta panel names this shard carries."""
        return set(self._load().get("deltas", {}))

    def deltas(self, names) -> Optional[dict]:
        """Per-window delta panels (winquant) for ``names``, or None
        when ANY is absent (a shard predating delta panels — windowed
        quantiles must reject, never approximate)."""
        stored = self._load().get("deltas", {})
        if any(n not in stored for n in names):
            return None
        return {n: (stored[n]["key"], stored[n]["hist"])
                for n in names}

    def recover(self) -> dict:
        """Heavy-hitter recovery over this snapshot's state."""
        return hist_recover(self.rt, self.state)

    def columns(self, subsys: str):
        """The ``columns_fn`` contract of ``api.execute``."""
        return self._cols.get(subsys, lambda: self._columns(subsys))

    def _columns(self, subsys: str):
        stored = self._load()["columns"]
        if subsys in stored:
            return stored[subsys]
        if subsys == "svcsumm":
            cols, live = self.columns("svcstate")
            return api.svcsumm_from_svc(cols, live, self.rt.names)
        if subsys == "topk":
            rec = self.recover()
            return api.heavy_topk_columns(
                rec["flows"], svc=self.columns("svcstate"),
                trace=self.columns("tracereq"))
        rt = self.rt
        if isinstance(self.state, list):
            return rt._merged_columns_state(subsys, self.state, self.dep,
                                            self._cols)
        if subsys in api._COLUMNS_OF or subsys in api._DEP_COLUMNS_OF:
            return api.columns_for(rt.cfg, self.state, subsys,
                                   names=rt.names, dep=self.dep)
        raise ValueError(
            f"subsystem {subsys!r} is not available historically "
            "(registry/CRUD-backed views are not shard-persisted)")


def _merge_group_rows(cols: dict, mask, keycols: list,
                      sumcols: list) -> tuple:
    """Group concatenated per-part rows by identity: ``sumcols`` sum,
    everything else keeps the first observation; first-appearance
    order. The cross-part merge for views whose entity can appear in
    more than one part (a dep edge reported by hosts on two shards)."""
    mask = np.asarray(mask, bool)
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return {c: np.asarray(cols[c])[:0] for c in cols}, \
            np.zeros(0, bool)
    keys = np.asarray(cols[keycols[0]])[idx].astype("U")
    for c in keycols[1:]:
        keys = np.char.add(np.char.add(keys, WQ.KEY_SEP),
                           np.asarray(cols[c])[idx].astype("U"))
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    g = rank[inv]
    n = len(uniq)
    first_rows = idx[first[order]]
    out = {}
    for c in cols:
        src = np.asarray(cols[c])
        if c in sumcols:
            acc = np.zeros(n, np.float64)
            np.add.at(acc, g, src[idx].astype(np.float64))
            out[c] = acc
        else:
            out[c] = src[first_rows]
    return out, np.ones(n, bool)


class PartedSnapshot:
    """One parted-store window materialized WITHOUT funneling through
    a single process-wide state: each ``part_NN`` sub-shard (the
    output of one parallel replay worker over one WAL shard) opens as
    its own plain :class:`HistSnapshot`, and queries merge at column
    level — concatenation for entity-disjoint panels (hosts hash to
    exactly one WAL shard, so their services/tasks/APIs are
    part-disjoint), bound-honest summation for the global sketch views
    (per-part flow values are upper bounds; the merged value sums them
    and sums their error bounds)."""

    def __init__(self, tv: "TimeView", store, ent: dict):
        self.tv = tv
        self.rt = tv.rt
        self.ent = ent
        # each part was replayed by a plain per-shard runtime: its flat
        # leaves materialize as one plain state of the serving runtime's
        # (per-shard) geometry, decoded by the plain column providers
        self.snaps = [HistSnapshot(tv.rt, store.parts[i], pe)
                      for i, pe in enumerate(ent["parts"])]
        self._memo: dict = {}
        self._rec = None

    # ----------------------------------------------------------- topk
    def recover(self) -> dict:
        if self._rec is not None:
            return self._rec
        agg: dict = {}
        err = ev = tot = 0.0
        nrec = 0
        for s in self.snaps:
            rec = s.recover()
            err += rec["err_term"]
            ev += rec["evicted"]
            tot += rec["total_mass"]
            nrec += rec["recovered_keys"]
            for rid, v, eb, src in rec["flows"]:
                cur = agg.get(rid)
                if cur is None:
                    agg[rid] = [v, eb, src]
                else:
                    cur[0] += v
                    cur[1] += eb
        rows = sorted(((rid, v, eb, src)
                       for rid, (v, eb, src) in agg.items()),
                      key=lambda r: (-r[1], r[0]))
        self._rec = {"flows": rows, "err_term": err,
                     "total_mass": tot, "evicted": ev,
                     "recovered_keys": nrec}
        return self._rec

    def delta_names(self) -> set:
        names = None
        for s in self.snaps:
            got = s.delta_names()
            names = got if names is None else names & got
        return names or set()

    def deltas(self, names) -> Optional[dict]:
        per = [s.deltas(names) for s in self.snaps]
        if any(p is None for p in per):
            return None
        out = {}
        for n in names:
            out[n] = WQ.merge_delta_rows([p[n] for p in per])
        return out

    # -------------------------------------------------------- columns
    def columns(self, subsys: str):
        got = self._memo.get(subsys)
        if got is None:
            got = self._memo[subsys] = self._columns(subsys)
        return got

    def _concat(self, parts: list) -> tuple:
        cols = {k: np.concatenate(
            [np.asarray(p[0][k]) for p in parts])
            for k in parts[0][0]}
        mask = np.concatenate([np.asarray(p[1], bool) for p in parts])
        return cols, mask

    def _columns(self, subsys: str):
        if subsys == fieldmaps.SUBSYS_CLUSTERSTATE:
            parts = [s.columns(subsys) for s in self.snaps]
            out = {}
            for c in parts[0][0]:
                vals = [float(np.asarray(p[0][c])[0]) if len(p[0][c])
                        else 0.0 for p in parts]
                out[c] = np.array([float(np.sum(vals))])
            nh = float(out.get("nhosts", np.zeros(1))[0])
            bad = float(out.get("nbad", np.zeros(1))[0]) \
                + float(out.get("nsevere", np.zeros(1))[0])
            out["issue_frac"] = np.array([bad / max(nh, 1.0)])
            return out, np.ones(1, bool)
        if subsys == "svcsumm":
            cols, live = self.columns("svcstate")
            return api.svcsumm_from_svc(cols, live, self.rt.names)
        if subsys == "topk":
            rec = self.recover()
            return api.heavy_topk_columns(
                rec["flows"], svc=self.columns("svcstate"),
                trace=self.columns("tracereq"))
        if subsys == fieldmaps.SUBSYS_FLOWSTATE:
            rec = self.recover()
            n = len(rec["flows"])
            ids = np.empty(n, object)
            ids[:] = [r[0] for r in rec["flows"]]
            cols = {"flowid": ids,
                    "bytes": np.array([r[1] for r in rec["flows"]],
                                      np.float64),
                    "evictedbytes": np.full(n, float(rec["evicted"]))}
            return cols, np.ones(n, bool)
        if subsys == fieldmaps.SUBSYS_SVCMESH:
            raise ValueError(
                "svcmesh is not available over parted history stores "
                "(mesh clusters cannot be labelled per part)")
        parts = [s.columns(subsys) for s in self.snaps]
        parts = [((p[0].full() if isinstance(p[0], LazyCols)
                   else p[0]), p[1]) for p in parts]
        cols, mask = self._concat(parts)
        # views whose entity may be reported from several parts merge
        # by identity with summed flow stats (everything panel-backed
        # is part-disjoint and stays concatenated)
        if subsys == fieldmaps.SUBSYS_SVCDEP:
            return _merge_group_rows(cols, mask, ["cliid", "serid"],
                                     ["nconn", "bytes"])
        if subsys == fieldmaps.SUBSYS_ACTIVECONN:
            return _merge_group_rows(
                cols, mask, ["svcid"],
                ["nclients", "nconn", "bytes", "nsvccli"])
        if subsys == fieldmaps.SUBSYS_CLIENTCONN:
            return _merge_group_rows(cols, mask, ["cliid"],
                                     ["nservers", "nconn", "bytes"])
        return cols, mask


class _WindowColumns:
    """``columns_fn`` over a shard RANGE: per-entity aggregation for
    relational subsystems, baseline-diffed recovery for ``topk``."""

    def __init__(self, tv: "TimeView", ents: list, start: float,
                 end: float):
        self.tv = tv
        self.ents = ents
        self.start, self.end = start, end
        self._memo: dict = {}
        self._deltas: dict = {}       # panel name → merged (keys, hist)

    def columns(self, subsys: str):
        got = self._memo.get(subsys)
        if got is None:
            got = self._memo[subsys] = self._columns(subsys)
        return got

    # -------------------------------------------------- quantile merge
    def delta_support(self) -> set:
        """Delta panels EVERY covering shard carries — the windowed
        quantile sources this window can honor."""
        avail = set(WQ.DELTA_SPECS)
        for e in self.ents:
            avail &= self.tv.snap(e).delta_names()
        return avail

    def _merged_deltas(self, panel: str):
        got = self._deltas.get(panel)
        if got is None:
            parts = []
            for e in self.ents:
                d = self.tv.snap(e).deltas([panel])
                if d is None:
                    return None
                parts.append(d[panel])
            got = self._deltas[panel] = WQ.merge_delta_rows(parts)
        return got

    def _apply_window_quantiles(self, subsys: str, cols, mask):
        """Override quantile fields with TRUE windowed quantiles: the
        covering windows' delta histograms sum per entity (the exact
        mergeable-summary merge) and each field reads its quantile off
        the merged histogram. Fields whose delta panel is missing
        (pre-delta shards) are REMOVED from the output — and counted —
        never served as the old silent mean-of-snapshots."""
        qf = WQ.quantile_fields(subsys)
        if not qf or not isinstance(cols, dict) or not len(mask):
            if qf and isinstance(cols, dict):
                # empty window: fields stay, values are vacuous
                pass
            return cols
        panels = {f.panel for f in qf.values()}
        merged = {p: self._merged_deltas(p) for p in panels}
        row_keys = None
        for field, f in qf.items():
            fd = fieldmaps.field_map(subsys).get(field)
            if fd is None or fd.col not in cols:
                continue
            if merged[f.panel] is None:
                cols.pop(fd.col, None)
                self.tv.rt.stats.bump("windowed_quant_fields_omitted")
                continue
            if row_keys is None:
                row_keys = WQ.composite_keys(
                    WQ.DELTA_SPECS[f.panel].subsys, cols,
                    np.arange(len(mask)))
            spec = WQ.spec_of(self.tv.rt.cfg, f.panel)
            hists = WQ.lookup_hists(row_keys, merged[f.panel],
                                    spec.nbuckets)
            if f.q is None:
                vals = WQ.np_hist_mean(hists, spec)
            else:
                vals = WQ.np_hist_quantiles(
                    hists, spec, [f.q])[:, 0]
            cols[fd.col] = np.asarray(
                vals, np.float64) / WQ.DELTA_SPECS[f.panel].scale
        return cols

    def _columns(self, subsys: str):
        if subsys == "topk":
            return self._topk_window()
        parts = [self.tv.snap(e).columns(subsys) for e in self.ents]
        cols, mask = aggregate_window_columns(subsys, parts)
        cols = self._apply_window_quantiles(subsys, cols, mask)
        return cols, mask

    def _topk_window(self):
        end_snap = self.tv.snap(self.ents[-1])
        rec_end = end_snap.recover()
        base_ent = self.tv.store.resolve_at(self.start)
        rows = [(rid, v, eb, "window")
                for rid, v, eb, _src in rec_end["flows"]]
        if base_ent is not None \
                and base_ent["t1"] <= self.start \
                and base_ent["tick1"] < self.ents[-1]["tick1"]:
            rec_base = self.tv.snap(base_ent).recover()
            base = {rid: (v, eb)
                    for rid, v, eb, _s in rec_base["flows"]}
            rows = []
            for rid, v, eb, _src in rec_end["flows"]:
                v0, eb0 = base.get(rid, (0.0, rec_base["err_term"]))
                dv = v - v0
                if dv <= 0:
                    continue
                rows.append((rid, dv, eb + eb0, "window"))
            rows.sort(key=lambda r: (-r[1], r[0]))
        # dense rankings (conns / errrate / p99resp) report the
        # window-END snapshot — they are point-in-time gauges, not
        # accumulating counts
        return api.heavy_topk_columns(
            rows, svc=end_snap.columns("svcstate"),
            trace=end_snap.columns("tracereq"))


class TimeView:
    """``at=``/``window=`` request router bound to one runtime + shard
    store. Materialized snapshots ride a small LRU so dashboard bursts
    against the same instant pay the load once."""

    MAX_SNAPS = 4

    def __init__(self, rt, store, clock=None):
        self.rt = rt
        self.store = store
        self._clock = clock or time.time
        self._snaps: collections.OrderedDict = collections.OrderedDict()
        # the snapshot LRU is shared by the tick loop (windowed
        # alertdefs) and query threads
        self._lock = threading.Lock()

    def snap(self, ent: dict):
        if "parts" in ent:
            key = ("parted", ent["level"], ent["tick0"], ent["tick1"],
                   tuple(pe["file"] for pe in ent["parts"]))
        else:
            key = ent["file"]
        with self._lock:
            s = self._snaps.get(key)
            if s is None:
                if "parts" in ent:
                    s = PartedSnapshot(self, self.store, ent)
                else:
                    s = HistSnapshot(self.rt, self.store, ent)
                self._snaps[key] = s
                while len(self._snaps) > self.MAX_SNAPS:
                    self._snaps.popitem(last=False)
            else:
                self._snaps.move_to_end(key)
            return s

    # ------------------------------------------------------------ query
    def query(self, req: dict) -> dict:
        req = dict(req)
        at = req.pop("at", None)
        window = req.pop("window", None)
        tstart = req.pop("tstart", None)
        tend = req.pop("tend", None)
        opts = api.QueryOptions.from_json(req)
        rt = self.rt
        if at is not None:
            ent = self.store.resolve_at(parse_when(at, self._clock()))
            if ent is None:
                raise ValueError("no history shards yet (compaction "
                                 "has not emitted a window)")
            snap = self.snap(ent)
            out = api.execute(rt.cfg, None, opts, names=rt.names,
                              columns_fn=snap.columns)
            out["at"] = ent["t1"]
            out["tick"] = ent["tick1"]
            self._cover(out)
            return out
        newest = self.store.newest("raw") or (
            self.store.shards()[-1] if self.store.shards() else None)
        if newest is None:
            raise ValueError("no history shards yet (compaction has "
                             "not emitted a window)")
        end = float(tend) if tend is not None else float(newest["t1"])
        if window is not None:
            start = end - parse_dur(window)
        elif tstart is not None:
            start = float(tstart)
        else:
            raise ValueError("historical query needs at=, window= or "
                             "tstart/tend")
        ents = self.store.resolve_window(start, end)
        if not ents:
            raise ValueError(
                f"no history shards sample [{start}, {end}]")
        win = _WindowColumns(self, ents, start, end)
        self._check_windowed_quantiles(opts, win)
        out = api.execute(rt.cfg, None, opts, names=rt.names,
                          columns_fn=win.columns)
        out["window"] = [start, end]
        out["shards"] = len(ents)
        self._cover(out)
        return out

    def _cover(self, out: dict) -> None:
        """Stamp the store's durable coverage onto a historical
        response: the gateway's no-TTL historical cache admits an
        entry only when the requested instant/range lies INSIDE
        coverage at render time — interior resolutions are immutable
        (compaction only appends windows; downsampling preserves the
        delta merges), while a request past the frontier would
        re-resolve once the next window lands."""
        newest = self.store.shards()
        if newest:
            out["hist_cover_tick"] = max(e["tick1"] for e in newest)
            out["hist_cover_t"] = max(e["t1"] for e in newest)

    def _check_windowed_quantiles(self, opts, win: "_WindowColumns"
                                  ) -> None:
        """Validation-time gate for windowed quantile fields: a
        request that REFERENCES one (filter/sort/projection/aggr) is
        REJECTED — counted — when any covering shard lacks its delta
        panel. Silently serving the old mean-of-snapshots would be a
        wrong number wearing a quantile's name; an implicit full
        projection instead omits the field (also counted)."""
        qf = WQ.quantile_fields(opts.subsys)
        if not qf:
            return
        refs = WQ.referenced_fields(opts) & set(qf)
        if not refs:
            return
        avail = win.delta_support()
        bad = sorted(f for f in refs if qf[f].panel not in avail)
        if bad:
            self.rt.stats.bump("windowed_quant_rejected")
            raise ValueError(
                f"windowed quantile field(s) {bad} need per-window "
                "sketch deltas, but the covering shards predate delta "
                "panels (recompact, or drop the field) — windowed "
                "quantiles are never approximated from snapshot means")

    def window_columns_for(self, subsys: str, window) -> tuple:
        """Windowed (cols, mask) for alertdef evaluation — the
        ``subsys@window`` column source realtime defs with a
        ``window`` field reference (windowed aggregates as alert
        criteria)."""
        newest = self.store.newest("raw") or (
            self.store.shards()[-1] if self.store.shards() else None)
        if newest is None:
            raise ValueError("no history shards yet")
        end = float(newest["t1"])
        start = end - parse_dur(window)
        ents = self.store.resolve_window(start, end)
        if not ents:
            raise ValueError(
                f"no history shards sample [{start}, {end}]")
        return _WindowColumns(self, ents, start, end).columns(subsys)


def route_historical(rt, req: dict) -> Optional[dict]:
    """Shared three-edge routing (GYT binary, REST, stock NM): a
    request carrying ``at``/``window`` goes to the shard tier; a
    ``tstart``/``tend`` range goes to the relational history store
    when one is configured (back-compat SQL semantics), else to the
    shard tier. Returns None for live queries."""
    historical = ("at" in req or "window" in req
                  or "tstart" in req or "tend" in req)
    if not historical:
        return None
    tv = getattr(rt, "timeview", None)
    sql = getattr(rt, "history", None)
    if "at" not in req and "window" not in req and sql is not None:
        return None                   # caller's relational path serves it
    if tv is None:
        raise ValueError(
            "time-travel query needs history shards (run with "
            "--shard-dir / hist_shard_dir)")
    with rt.stats.timeit("timeview_query"):
        return tv.query(req)
