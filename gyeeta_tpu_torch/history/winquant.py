"""Per-window sketch deltas → true windowed quantiles.

A ``window=24h p99`` is not the mean of per-shard snapshot quantiles
(not a quantile at all). The engine's per-entity response
loghists are MONOTONE accumulators (``resp_win.alltime``,
``api_resp_hist``, ``task_cpu_hist`` only ever grow), so the histogram
of exactly the samples folded inside a compaction window is
``state_at_window_end − state_at_window_start`` — an exact per-window
partial aggregate. Those deltas are mergeable summaries in the
Agarwal-et-al sense: the merge across windows is plain ``+``, so a
``window=<dur>`` quantile is the quantile of the SUMMED covering
deltas — the same monotone-merge proof the downsampler already uses
(newest-state = window merge), applied to the subtraction direction.

This module owns everything both sides share:

- which monotone leaves become delta panels (``DELTA_SPECS``), and
  which query fields are quantiles over them (``QUANTILE_FIELDS``);
- the compactor-side extraction (``extract_deltas``): end−start per
  slab row, keyed by the subsystem's string identity columns (the SAME
  composite key the window aggregator groups by), negative rows
  clamped and counted (a slab row recycled to a new entity mid-window
  subtracts a stranger's baseline);
- a derived per-entity t-digest delta for the service response panel
  (``td_from_hist``): the window histogram re-expressed as ≤C
  centroids at bucket-midpoint resolution — the compact mergeable form
  for consumers that cannot afford the full (S, B) panel. Quantile
  SERVING always uses the loghist deltas (exact merge); the digest is
  a documented derivation, never a second source of truth;
- the read-side merge + numpy quantile math (``merge_delta_rows``,
  ``np_hist_quantiles``) — numerically the mirror of
  ``sketch/loghist.quantiles`` so shard-served quantiles equal the
  offline exact merge bit-for-bit (modulo samples on a bucket edge,
  which a device's float math may put one bucket over from numpy's).

Counterpart of ``gyeeta_tpu/history/winquant.py``. ``leaf_of`` reads
the port's ``AggState`` tensors back to the host (three small slabs a
compaction window); every other function is the reference's numpy.

Error model (OPERATIONS.md "Distributed compaction & windowed
quantiles"): within a window the delta is exact; quantile error is the
loghist's γ-bound (<2% for the resp spec). Entities that aged OUT
mid-window drop their last partial window (undercount, counted via
``wd_dead_rows``); slab-row reuse inside one window clamps to zero
(counted via ``wd_clamped_rows``). Both are bounded by one window's
traffic for one entity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.query import fieldmaps

# separator for composite entity keys (identity values are hex ids /
# interned names — \x1f cannot appear in them; the same convention
# timeview.aggregate_window_columns uses)
KEY_SEP = "\x1f"


class DeltaSpec(NamedTuple):
    subsys: str                  # panel whose identity columns key rows
    spec_attr: str               # EngineCfg attr holding the LogHistSpec
    leaf: str                    # dotted path into AggState
    scale: float                 # raw bucket unit → JSON field unit
    td: bool = False             # also derive the t-digest delta panel


# name → how to pull the monotone loghist out of the engine state
# (extraction reshapes to (-1, B): slab-row order, the column panels')
DELTA_SPECS = {
    # per-service response-time loghist (usec buckets → msec fields)
    "svc_resp": DeltaSpec("svcstate", "resp_spec", "resp_win.alltime",
                          1e3, td=True),
    # per-(service, API) trace latency loghist (usec → msec)
    "api_resp": DeltaSpec("tracereq", "apiresp_spec", "api_resp_hist",
                          1e3),
    # per-process-group CPU%% baseline loghist
    "task_cpu": DeltaSpec("taskstate", "taskcpu_spec", "task_cpu_hist",
                          1.0),
}


class QuantField(NamedTuple):
    panel: str                   # DELTA_SPECS key
    q: Optional[float]           # quantile in (0,1); None = window mean


# JSON fields that are QUANTILES (or the histogram mean) of a delta
# panel. In ``window=`` mode the level suffix in the field name
# (5s/5m/5d) is vacuous — every resp field is the stated quantile of
# the ONE merged window histogram (documented in OPERATIONS.md).
# Snapshot (`at=`) serving is untouched: panels store the live values.
_SVC_QF = {
    "resp5s": QuantField("svc_resp", None),
    "p95resp5s": QuantField("svc_resp", 0.95),
    "p99resp5s": QuantField("svc_resp", 0.99),
    "p95resp5m": QuantField("svc_resp", 0.95),
    "p50resp5d": QuantField("svc_resp", 0.50),
    "p95resp5d": QuantField("svc_resp", 0.95),
}
_TASK_QF = {"cpup95": QuantField("task_cpu", 0.95)}
QUANTILE_FIELDS = {
    "svcstate": _SVC_QF,
    "extsvcstate": _SVC_QF,
    "tracereq": {
        "p50resp": QuantField("api_resp", 0.50),
        "p95resp": QuantField("api_resp", 0.95),
        "p99resp": QuantField("api_resp", 0.99),
    },
    "taskstate": _TASK_QF,
    # taskstate presets share the field map → same quantile sources
    "topcpu": _TASK_QF, "toppgcpu": _TASK_QF, "toprss": _TASK_QF,
    "topdelay": _TASK_QF, "topfork": _TASK_QF,
}


def quantile_fields(subsys: str) -> dict:
    """The subsystem's windowed-quantile fields ({} when none): the one
    accessor timeview's window serving and its windowed-criteria check
    both resolve through. (The reference's run-time registration,
    ``register_delta_spec`` / ``register_quantile_field``, has no caller
    in its package and is not carried.)"""
    return QUANTILE_FIELDS.get(subsys) or {}


def spec_of(cfg, name: str):
    return getattr(cfg, DELTA_SPECS[name].spec_attr)


def leaf_of(state, name: str) -> np.ndarray:
    """The monotone loghist leaf as a (rows, B) numpy array, read back
    from the state's device."""
    obj = state
    for part in DELTA_SPECS[name].leaf.split("."):
        obj = getattr(obj, part)
    arr = obj.detach().cpu().numpy() if hasattr(obj, "detach") \
        else np.asarray(obj)
    return arr.reshape(-1, arr.shape[-1])


# ------------------------------------------------------------ identity
def keycols_of(subsys: str, cols) -> list:
    """The subsystem's string identity columns, in column order — the
    SAME derivation ``timeview._window_layout`` groups by, so delta
    rows and aggregated window rows key identically."""
    fmap = fieldmaps.field_map(subsys)
    kind_of = {fd.col: fd.kind for fd in fmap.values()}
    return [c for c in cols if kind_of.get(c) == "str"]


def composite_keys(subsys: str, cols, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of the panel → composite identity keys (U array)."""
    keycols = keycols_of(subsys, cols)
    if not keycols:
        raise ValueError(f"{subsys!r} has no string identity columns")
    keys = np.asarray(cols[keycols[0]])[idx].astype("U")
    for c in keycols[1:]:
        keys = np.char.add(np.char.add(keys, KEY_SEP),
                           np.asarray(cols[c])[idx].astype("U"))
    return keys


# ----------------------------------------------------------- extraction
def extract_deltas(cfg, leaves: dict, columns: dict, base: Optional[dict]
                   ) -> tuple:
    """One window's delta panels.

    ``leaves``: {name: (rows, B) ndarray}, the monotone leaves at this
    emit (``Runtime.delta_leaves``; shard-major for a sharded runtime).
    ``columns``: the shard's column panels (subsys → (cols, mask)) —
    the identity source; rows align positionally with the loghist
    slabs (both are slab-row order, shard-major when stacked).
    ``base``: {name: (rows, B) ndarray} captured at the PREVIOUS emit
    (None = engine started from zero).

    Returns ``(deltas, new_base, diag)`` where ``deltas`` maps name →
    {"key": (n,) U array, "hist": (n, B) f32} and ``diag`` counts the
    clamped / dead-entity rows for the compactor's stats."""
    deltas: dict = {}
    new_base: dict = {}
    diag = {"wd_clamped_rows": 0, "wd_dead_rows": 0}
    for name, ds in DELTA_SPECS.items():
        cur = leaves[name].astype(np.float64)
        new_base[name] = cur
        if ds.subsys not in columns:
            continue
        cols, mask = columns[ds.subsys]
        mask = np.asarray(mask, bool)
        if len(mask) != cur.shape[0]:
            # geometry drift between panel and slab — never emit a
            # misaligned panel (queries would join wrong entities)
            continue
        prev = base.get(name) if base else None
        d = cur - prev if prev is not None else cur.copy()
        neg = d < 0
        if neg.any():
            diag["wd_clamped_rows"] += int((neg.any(axis=1)).sum())
            d = np.maximum(d, 0.0)
        nonzero = d.sum(axis=1) > 0
        diag["wd_dead_rows"] += int((nonzero & ~mask).sum())
        idx = np.nonzero(nonzero & mask)[0]
        keys = composite_keys(ds.subsys, cols, idx)
        deltas[name] = {"key": keys,
                        "hist": d[idx].astype(np.float32)}
        if ds.td:
            spec = spec_of(cfg, name)
            m, w, vmin, vmax = td_from_hist(
                d[idx], spec, int(getattr(cfg, "td_capacity", 64)))
            deltas[name]["td"] = {"means": m, "weights": w,
                                  "vmin": vmin, "vmax": vmax}
    return deltas, new_base, diag


# ------------------------------------------------------------ np mirror
def np_bucket_mid(spec, bucket: np.ndarray) -> np.ndarray:
    g = spec.gamma
    return spec.vmin * np.exp(
        (bucket.astype(np.float32) + 0.5) * np.float32(np.log(g)))


def np_hist_quantiles(hists: np.ndarray, spec, qs) -> np.ndarray:
    """(n, B) histograms → (n, Q) quantiles. The numpy mirror of
    ``sketch/loghist.quantiles`` (same −1e-6 target slack, same
    midpoint estimator) so merged-delta quantiles equal the offline
    exact merge's bit-for-bit."""
    hists = np.asarray(hists, np.float32)
    qs = np.asarray(qs, np.float32)
    cdf = np.cumsum(hists, axis=-1)                      # (n, B)
    tot = cdf[..., -1:]                                  # (n, 1)
    target = qs[None, :] * tot                           # (n, Q)
    ge = cdf[:, None, :] >= target[:, :, None] - 1e-6    # (n, Q, B)
    idx = np.argmax(ge, axis=-1).astype(np.int32)
    val = np_bucket_mid(spec, idx)
    return np.where(tot > 0, val, 0.0)


def np_hist_mean(hists: np.ndarray, spec) -> np.ndarray:
    hists = np.asarray(hists, np.float32)
    mids = np_bucket_mid(spec, np.arange(spec.nbuckets, dtype=np.int32))
    tot = hists.sum(axis=-1)
    s = (hists * mids).sum(axis=-1)
    return np.where(tot > 0, s / np.maximum(tot, 1.0), 0.0)


# ----------------------------------------------------------- td derive
def td_from_hist(hists: np.ndarray, spec, capacity: int) -> tuple:
    """Per-row window histograms → per-row t-digest deltas.

    The k-bin clustering of ``sketch/tdigest._compress`` in numpy:
    buckets are already ascending in mean, so cluster id is the
    arcsine-scaled midpoint quantile; weights segment-sum into ≤C
    centroids. Resolution is bounded by the loghist γ (the digest is a
    DERIVED summary — see module doc)."""
    hists = np.asarray(hists, np.float64)
    n, B = hists.shape
    mids = np_bucket_mid(spec, np.arange(B)).astype(np.float64)
    means = np.zeros((n, capacity), np.float32)
    weights = np.zeros((n, capacity), np.float32)
    lo_edge = spec.vmin * (spec.gamma ** np.arange(B))
    hi_edge = spec.vmin * (spec.gamma ** (np.arange(B) + 1))
    vmin = np.zeros(n, np.float32)
    vmax = np.zeros(n, np.float32)
    if n == 0:
        return means, weights, vmin, vmax
    delta = 2.0 * (capacity - 1)
    tot = hists.sum(axis=1, keepdims=True)
    cum = np.cumsum(hists, axis=1)
    q_mid = (cum - 0.5 * hists) / np.maximum(tot, 1e-30)

    def k1(q):
        return (delta / (2.0 * np.pi)) * np.arcsin(
            np.clip(2.0 * q - 1.0, -1.0, 1.0))

    k = k1(q_mid) - k1(0.0)
    cid = np.clip(np.floor(k).astype(np.int64), 0, capacity - 1)
    cid = np.where(hists > 0, cid, capacity - 1)
    rows = np.repeat(np.arange(n), B)
    flat = rows * capacity + cid.ravel()
    w_acc = np.zeros(n * capacity, np.float64)
    s_acc = np.zeros(n * capacity, np.float64)
    np.add.at(w_acc, flat, hists.ravel())
    np.add.at(s_acc, flat, (hists * mids[None, :]).ravel())
    w_acc = w_acc.reshape(n, capacity)
    s_acc = s_acc.reshape(n, capacity)
    weights = w_acc.astype(np.float32)
    means = np.where(w_acc > 0, s_acc / np.maximum(w_acc, 1e-30),
                     0.0).astype(np.float32)
    occ = hists > 0
    first = np.argmax(occ, axis=1)
    last = B - 1 - np.argmax(occ[:, ::-1], axis=1)
    has = occ.any(axis=1)
    vmin = np.where(has, lo_edge[first], 0.0).astype(np.float32)
    vmax = np.where(has, hi_edge[last], 0.0).astype(np.float32)
    return means, weights, vmin, vmax


# --------------------------------------------------------------- merge
def merge_delta_rows(parts: list) -> tuple:
    """Merge delta panels (``(keys, hist)`` pairs, any order) by
    entity: histograms SUM per composite key (the exact mergeable-
    summary merge). Returns ``(keys, hist)`` in first-appearance
    order."""
    ks = [np.asarray(k) for k, _h in parts if len(np.asarray(k))]
    hs = [np.asarray(h, np.float64) for k, h in parts
          if len(np.asarray(k))]
    if not ks:
        return np.empty(0, "U1"), np.zeros((0, 0), np.float64)
    keys = np.concatenate([k.astype("U") for k in ks])
    hist = np.concatenate(hs, axis=0)
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    g = rank[inv]
    out = np.zeros((len(uniq), hist.shape[1]), np.float64)
    np.add.at(out, g, hist)
    return uniq[order], out


def lookup_hists(keys: np.ndarray, merged: tuple, nbuckets: int
                 ) -> np.ndarray:
    """Row keys → (n, B) histograms from a merged delta panel (rows
    with no delta — no samples in the window — are zero)."""
    mkeys, mhist = merged
    out = np.zeros((len(keys), nbuckets), np.float64)
    if len(mkeys) == 0 or len(keys) == 0:
        return out
    pos = {k: i for i, k in enumerate(mkeys.tolist())}
    B = min(nbuckets, mhist.shape[1])
    for j, k in enumerate(np.asarray(keys).tolist()):
        i = pos.get(k)
        if i is not None:
            out[j, :B] = mhist[i, :B]
    return out


# ----------------------------------------------------- field references
def referenced_fields(opts) -> set:
    """Every field a QueryOptions references by name — filter criteria,
    sort column, explicit projection, aggregation specs — so windowed
    validation can reject quantile references the shards cannot honor
    instead of silently approximating them."""
    from gyeeta_tpu_torch.query import criteria

    refs: set = set()
    if opts.filter:
        try:
            tree = criteria.parse(opts.filter)
        except Exception:            # noqa: BLE001 — fails downstream
            tree = None

        def walk(node):
            if node is None:
                return
            if isinstance(node, criteria.Criterion):
                if node.subsys == opts.subsys:
                    refs.add(node.field)
                return
            for ch in node.children:
                walk(ch)
        walk(tree)
    if opts.sortcol:
        refs.add(opts.sortcol)
    if opts.columns:
        refs.update(opts.columns)
    if opts.aggr:
        from gyeeta_tpu_torch.query import aggr as A
        for s in opts.aggr:
            try:
                sp = A.parse_aggr(s, opts.subsys)
                if sp.field != "*":
                    refs.add(sp.field)
            except Exception:        # noqa: BLE001 — fails downstream
                pass
    if opts.groupby:
        refs.update(opts.groupby)
    return refs
