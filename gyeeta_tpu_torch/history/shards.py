"""Columnar snapshot shards: the on-disk format of the time-travel tier.

The relational ``history/store.py`` answers row-level SQL history; it
cannot answer "what was the ENGINE state at 09:14" for sketch-derived
subsystems (``topk`` is only meaningful as merged device state, the dep
graph is a slab, ``flowstate`` is a sketch readback). A shard closes
that gap: one npz per compaction window holding

- the full serialized engine state (every AggState leaf — the HLL
  registers, CMS counters, t-digest centroids and InvSketch candidate
  buckets travel as-is, so ANY state-backed subsystem materializes
  from a shard exactly as it does from live HBM), plus the dep-graph
  leaves;
- per-subsystem columnar snapshots (the same column panels the query
  tier serves, string columns stored as fixed-width unicode so loads
  never need pickle) for the relational subsystems — windowed
  aggregation across shards reads these without re-materializing
  state;
- a meta record: tick range, wall-time range, level, config
  fingerprint, and the WAL position the compactor had consumed when it
  emitted the shard (the restart-resume point).

Shards are atomic AND durable (tmp + fsync + rename + dir fsync, the
``checkpoint.save`` discipline); the manifest (``gyt_manifest.json``)
is rewritten the same way AFTER the shard lands, so a SIGKILL at any
byte leaves either the old manifest (shard invisible, recompacted) or
the new one (shard durable) — never a manifest pointing at a torn
file. Stranded ``*.tmp.npz`` are swept like ``checkpoint.
sweep_stale_tmp``.

Downsample levels (``raw`` → ``mid`` → ``hour``): the engine's sketches
are MONOTONE (HLL registers / CMS counters / exact top-K counts only
grow), so the sketch-merge of a run of consecutive shards is exactly
the newest shard's state — a downsampled shard keeps that state and
replaces the per-shard column panels with the windowed per-entity
aggregate (mean for numeric fields, last observation for
string/enum/bool), which is what a window query over the merged span
would have computed from the raws.

Counterpart of ``gyeeta_tpu/history/shards.py``, in the same file
format: leaves in the reference's flattened order and dtypes
(``aggstate.state_to_numpy`` / ``depgraph.dep_to_numpy``), so a shard
written by either package loads in the other, and the parallel
compactor's parted layout (``part_NN/`` sub-stores under a root manifest,
:class:`PartedShardStore`) is the reference's too.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
import zipfile
from typing import Optional

import numpy as np

MANIFEST = "gyt_manifest.json"
_SHARD_FMT = "gyt_shard_{level}_{tick0:08d}_{tick1:08d}.npz"
LEVELS = ("raw", "mid", "hour")

# subsystems whose column panels are persisted per shard (mirrors the
# relational history tables + svcsumm); everything else materializes
# from the serialized engine state on demand
SNAP_SUBSYS = ("svcstate", "hoststate", "clusterstate", "taskstate",
               "cpumem", "tracereq")


class _NullStats:
    def bump(self, name, n=1):
        pass

    def gauge(self, name, v):
        pass


def _fsync_dir(d: pathlib.Path) -> None:
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:               # pragma: no cover — exotic fs
        pass


def _atomic_npz(path: pathlib.Path, payload: dict) -> int:
    """tmp + fsync + rename + dir fsync. Returns bytes written.

    The file is the npz ``np.savez_compressed`` writes (a deflated zip of
    ``.npy`` members; ``np.load`` reads it, in either package), at
    deflate level 1 where ``savez_compressed`` uses zlib's default 6:
    the emit of a 6 GiB north-star shard is host time on the compaction
    path, and level 1 deflates its leaves several times faster for a
    somewhat larger file (``chip_smoke.py`` phase 10 measures both
    levels on a shard's leaves; PERF.md)."""
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED,
                             compresslevel=1) as zf:
            for name, arr in payload.items():
                with zf.open(name + ".npy", "w", force_zip64=True) as m:
                    np.lib.format.write_array(m, np.asanyarray(arr),
                                              allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    nbytes = tmp.stat().st_size
    tmp.rename(path)
    _fsync_dir(path.parent)
    return nbytes


def _col_key(subsys: str, name: str) -> str:
    return f"c|{subsys}|{name}"


def _atomic_json(path: pathlib.Path, obj: dict) -> None:
    """tmp + fsync + rename + dir fsync for manifests (shard store AND
    the parted store's root)."""
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(obj))
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    tmp.rename(path)
    _fsync_dir(path.parent)


class _ResolveMixin:
    """Time/tick resolution over a ``shards()`` listing (the reference
    shares it with its parted store)."""

    def shards(self, level: Optional[str] = None) -> list:
        raise NotImplementedError

    def newest(self, level: str = "raw") -> Optional[dict]:
        s = self.shards(level)
        return s[-1] if s else None

    def resolve_at(self, at) -> Optional[dict]:
        """The shard answering "state at ``at``": newest shard whose
        window END is <= ``at`` (state at a timestamp = state at the
        last closed window), preferring finer levels on ties; a
        timestamp before every shard resolves to the earliest one.
        ``at`` is epoch seconds, or ``("tick", N)`` for tick-pinned
        resolution."""
        shards = self.shards()
        if not shards:
            return None
        rank = {lv: i for i, lv in enumerate(LEVELS)}
        if isinstance(at, tuple) and at[0] == "tick":
            n = int(at[1])
            cands = [e for e in shards if e["tick1"] <= n]
            key = "tick1"
        else:
            ts = float(at)
            cands = [e for e in shards if e["t1"] <= ts]
            key = "t1"
        if not cands:
            cands = shards
            return min(cands, key=lambda e: (e[key],
                                             rank[e["level"]]))
        return max(cands, key=lambda e: (e[key], -rank[e["level"]]))

    def resolve_window(self, t0: float, t1: float) -> list:
        """Shards SAMPLING the window ``[t0, t1]`` (their window end
        falls inside it), finest level first per span — coarse shards
        cover only ranges no finer shard samples. Oldest→newest."""
        sel: list = []
        covered: list = []
        for level in LEVELS:
            for e in self.shards(level):
                if not (t0 <= e["t1"] <= t1):
                    continue
                if any(c0 <= e["tick1"] <= c1 for c0, c1 in covered):
                    continue
                sel.append(e)
                covered.append((e["tick0"], e["tick1"]))
        sel.sort(key=lambda e: (e["tick1"], e["tick0"]))
        return sel

    def lag_seconds(self, now: Optional[float] = None) -> float:
        """Wall-clock distance from now to the newest shard's window
        end — the ``gyt_compact_lag_seconds`` gauge."""
        s = self.shards()
        if not s:
            return 0.0
        now = time.time() if now is None else now
        return max(0.0, now - max(e["t1"] for e in s))


class ShardStore(_ResolveMixin):
    """Manifest-driven shard directory: writers (the compactor) add
    shards and advance the position; readers (``timeview``) resolve
    ``at=``/``window=`` requests against the manifest only — a shard
    file not named by the manifest does not exist as far as queries
    are concerned."""

    def __init__(self, path, stats=None):
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.stats = stats if stats is not None else _NullStats()
        self._manifest_cache = None       # (mtime, size, dict)

    # --------------------------------------------------------- manifest
    def _mpath(self) -> pathlib.Path:
        return self.dir / MANIFEST

    def manifest(self) -> dict:
        """Current manifest (mtime-cached — queries re-read only after
        the compactor rewrote it)."""
        p = self._mpath()
        try:
            st = p.stat()
        except FileNotFoundError:
            return {"version": 1, "pos": None, "tick": 0, "shards": []}
        key = (st.st_mtime_ns, st.st_size)
        if self._manifest_cache and self._manifest_cache[0] == key:
            return self._manifest_cache[1]
        m = json.loads(p.read_text())
        self._manifest_cache = (key, m)
        return m

    def _write_manifest(self, m: dict) -> None:
        _atomic_json(self._mpath(), m)
        self._manifest_cache = None

    def position(self) -> Optional[tuple]:
        """The compactor's durable WAL position (``(seg, off)``) — the
        resume point, advanced only when a shard lands."""
        pos = self.manifest().get("pos")
        return tuple(pos) if pos else None

    def tick(self) -> int:
        """Window tick of the newest durable shard."""
        return int(self.manifest().get("tick", 0))

    # ----------------------------------------------------------- hygiene
    def sweep_stale_tmp(self) -> int:
        """Remove staging orphans a SIGKILL mid-write left behind (the
        ``checkpoint.sweep_stale_tmp`` discipline) plus shard files the
        manifest does not name (a crash between shard rename and
        manifest rewrite — they will be re-emitted by recompaction)."""
        n = 0
        named = {e["file"] for e in self.manifest().get("shards", [])}
        for p in list(self.dir.glob("*.tmp.npz")) \
                + list(self.dir.glob("*.json.tmp")):
            try:
                p.unlink()
                n += 1
            except OSError:       # pragma: no cover — already gone
                pass
        for p in self.dir.glob("gyt_shard_*.npz"):
            if p.name not in named:
                try:
                    p.unlink()
                    n += 1
                except OSError:   # pragma: no cover
                    pass
        if n:
            self.stats.bump("compact_tmp_swept", n)
        return n

    # ------------------------------------------------------------- write
    def add_shard(self, *, level: str, tick0: int, tick1: int,
                  t0: float, t1: float, state_leaves, dep_leaves,
                  columns: dict, cfg_fp: str = "",
                  wal_pos: Optional[tuple] = None,
                  replaces: Optional[list] = None,
                  deltas: Optional[dict] = None) -> dict:
        """Write one shard + advance the manifest atomically.

        ``columns`` maps subsys → ``(cols_dict, mask)``;
        ``replaces`` names manifest entries this shard supersedes (the
        downsample path: sources drop from the manifest in the SAME
        rewrite that adds the merged shard, then their files unlink);
        ``deltas`` maps panel name → {"key": (n,) keys, "hist": (n, B)
        window-delta histograms, optional "td": {means/weights/vmin/
        vmax}} — the per-window mergeable summaries true windowed
        quantiles merge (``history/winquant.py``)."""
        assert level in LEVELS, level
        name = _SHARD_FMT.format(level=level, tick0=int(tick0),
                                 tick1=int(tick1))
        payload: dict = {}
        for i, leaf in enumerate(state_leaves):
            payload[f"s{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(dep_leaves):
            payload[f"d{i}"] = np.asarray(leaf)
        delta_meta: dict = {}
        for dname, d in (deltas or {}).items():
            keys = np.asarray(d["key"])
            payload[f"wd|{dname}|key"] = keys.astype("U") if len(keys) \
                else np.zeros(0, "U1")
            payload[f"wd|{dname}|hist"] = np.asarray(d["hist"],
                                                     np.float32)
            ent_meta = {"n": int(len(keys)),
                        "b": int(np.asarray(d["hist"]).shape[-1])}
            td = d.get("td")
            if td is not None:
                for k in ("means", "weights", "vmin", "vmax"):
                    payload[f"wt|{dname}|{k}"] = np.asarray(
                        td[k], np.float32)
                ent_meta["td"] = True
            delta_meta[dname] = ent_meta
        subsys_cols: dict = {}
        for subsys, (cols, mask) in columns.items():
            names = []
            for cname, arr in cols.items():
                arr = np.asarray(arr)
                if arr.dtype == object:
                    # fixed-width unicode: loads never need pickle
                    arr = arr.astype("U") if len(arr) else \
                        np.zeros(0, "U1")
                payload[_col_key(subsys, cname)] = arr
                names.append(cname)
            payload[f"m|{subsys}"] = np.asarray(mask, bool)
            subsys_cols[subsys] = names
        meta = {"level": level, "tick0": int(tick0), "tick1": int(tick1),
                "t0": float(t0), "t1": float(t1), "cfg": cfg_fp,
                "nstate": len(state_leaves), "ndep": len(dep_leaves),
                "cols": subsys_cols, "deltas": delta_meta,
                "wal": list(wal_pos) if wal_pos else None}
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        nbytes = _atomic_npz(self.dir / name, payload)
        ent = {"file": name, "level": level, "tick0": int(tick0),
               "tick1": int(tick1), "t0": float(t0), "t1": float(t1),
               "bytes": int(nbytes)}
        m = self.manifest()
        drop = {e["file"] for e in (replaces or [])}
        shards = [e for e in m.get("shards", [])
                  if e["file"] not in drop and e["file"] != name]
        shards.append(ent)
        shards.sort(key=lambda e: (e["tick0"], e["tick1"]))
        m2 = dict(m)
        m2["version"] = 1
        m2["shards"] = shards
        if wal_pos is not None:
            m2["pos"] = list(wal_pos)
            m2["tick"] = max(int(m.get("tick", 0)), int(tick1))
        self._write_manifest(m2)
        for e in (replaces or []):       # sources are now unreferenced
            try:
                (self.dir / e["file"]).unlink()
            except OSError:              # pragma: no cover
                pass
        self.stats.bump("compact_shards")
        return ent

    def drop(self, ents: list) -> int:
        """Retention drop: remove entries from the manifest first, then
        unlink the files."""
        if not ents:
            return 0
        gone = {e["file"] for e in ents}
        m = dict(self.manifest())
        m["shards"] = [e for e in m.get("shards", [])
                       if e["file"] not in gone]
        self._write_manifest(m)
        for f in gone:
            try:
                (self.dir / f).unlink()
            except OSError:              # pragma: no cover
                pass
        self.stats.bump("compact_shards_dropped", len(gone))
        return len(gone)

    # -------------------------------------------------------------- read
    def shards(self, level: Optional[str] = None) -> list:
        out = self.manifest().get("shards", [])
        if level is not None:
            out = [e for e in out if e["level"] == level]
        return sorted(out, key=lambda e: (e["tick0"], e["tick1"]))

    def load(self, ent: dict, leaves: bool = True) -> dict:
        """Load one shard → {"meta", "state" (leaf list), "dep" (leaf
        list), "columns" {subsys: (cols, mask)}, "deltas" {name:
        {"key", "hist", "td"?}}}. String columns come back as object
        arrays (the live column convention). ``leaves=False`` leaves
        out the state and dep leaves (None): most of a shard's bytes,
        which a query of the stored panels does not read."""
        with np.load(self.dir / ent["file"]) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            state = [z[f"s{i}"] for i in range(meta["nstate"])] \
                if leaves else None
            dep = [z[f"d{i}"] for i in range(meta["ndep"])] \
                if leaves else None
            columns = {}
            for subsys, names in meta.get("cols", {}).items():
                cols = {}
                for cname in names:
                    arr = z[_col_key(subsys, cname)]
                    if arr.dtype.kind == "U":
                        arr = arr.astype(object)
                    cols[cname] = arr
                columns[subsys] = (cols, z[f"m|{subsys}"])
            deltas = {}
            for dname, dm in meta.get("deltas", {}).items():
                d = {"key": z[f"wd|{dname}|key"],
                     "hist": z[f"wd|{dname}|hist"]}
                if dm.get("td"):
                    d["td"] = {k: z[f"wt|{dname}|{k}"]
                               for k in ("means", "weights",
                                         "vmin", "vmax")}
                deltas[dname] = d
        return {"meta": meta, "state": state, "dep": dep,
                "columns": columns, "deltas": deltas}


# ----------------------------------------------------------- parted store
PART_FMT = "part_{shard:02d}"


def part_dirs(root) -> list:
    """``part_NN`` sub-store directories of a parted shard root, shard
    order; empty for a flat (single-store) dir."""
    d = pathlib.Path(root)
    if not d.is_dir():
        return []
    out = []
    for p in sorted(d.glob("part_*")):
        if p.is_dir():
            try:
                out.append((int(p.name.split("_")[-1]), p))
            except ValueError:
                continue
    return [p for _i, p in sorted(out)]


class PartedShardStore(_ResolveMixin):
    """The parallel compactor's layout: ``part_NN/`` sub-stores (one
    per WAL shard, each a normal manifest-atomic :class:`ShardStore`
    written by its own replay worker) under a ROOT manifest that
    publishes only the windows EVERY part has durably emitted.

    The root manifest is the consistency boundary: the supervisor
    rewrites it (tmp+fsync+rename) only after a whole pass lands, so a
    SIGKILL at ANY worker boundary leaves either the old root (the new
    partial windows invisible — recompaction converges) or the new one
    — never a window naming a part that is missing it. Entries carry
    ``parts``: the per-part sub-entries, which ``timeview`` materializes
    WITHOUT funneling through one process-wide state."""

    def __init__(self, path, stats=None, nparts: Optional[int] = None):
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.stats = stats if stats is not None else _NullStats()
        self._manifest_cache = None
        if nparts is None:
            dirs = part_dirs(self.dir)
        else:
            dirs = [self.dir / PART_FMT.format(shard=s)
                    for s in range(int(nparts))]
        self.parts = [ShardStore(p, stats=self.stats) for p in dirs]

    # --------------------------------------------------------- manifest
    def _mpath(self) -> pathlib.Path:
        return self.dir / MANIFEST

    def manifest(self) -> dict:
        p = self._mpath()
        try:
            st = p.stat()
        except FileNotFoundError:
            return {"version": 2, "layout": "parted",
                    "nparts": len(self.parts), "pos": None, "tick": 0,
                    "shards": []}
        key = (st.st_mtime_ns, st.st_size)
        if self._manifest_cache and self._manifest_cache[0] == key:
            return self._manifest_cache[1]
        m = json.loads(p.read_text())
        self._manifest_cache = (key, m)
        return m

    def rebuild_root(self) -> dict:
        """Publish the intersection of the part manifests: a window is
        visible only at a (level, tick range) EVERY part carries (a
        killed pass leaves parts briefly divergent; the intersection
        shrinks, never lies — the next pass converges them). Also
        records the per-shard WAL resume positions (``[shard, seg,
        off]`` triples — ``journal.floors_of`` shape)."""
        per_part = [{(e["level"], e["tick0"], e["tick1"]): e
                     for e in p.shards()} for p in self.parts]
        ents = []
        if per_part:
            common = set(per_part[0])
            for d in per_part[1:]:
                common &= set(d)
            for key in sorted(common, key=lambda k: (k[1], k[2])):
                subs = [d[key] for d in per_part]
                ents.append({
                    "level": key[0], "tick0": key[1], "tick1": key[2],
                    "t0": min(e["t0"] for e in subs),
                    "t1": max(e["t1"] for e in subs),
                    "bytes": int(sum(e["bytes"] for e in subs)),
                    "parts": subs,
                })
        pos = []
        for s, p in enumerate(self.parts):
            pp = p.position()
            if pp is not None:
                pos.append([s, int(pp[0]), int(pp[1])])
        m = {"version": 2, "layout": "parted",
             "nparts": len(self.parts),
             "pos": pos or None,
             "tick": min((p.tick() for p in self.parts), default=0),
             "shards": ents}
        _atomic_json(self._mpath(), m)
        self._manifest_cache = None
        return m

    # ------------------------------------------------------------- read
    def shards(self, level: Optional[str] = None) -> list:
        out = self.manifest().get("shards", [])
        if level is not None:
            out = [e for e in out if e["level"] == level]
        return sorted(out, key=lambda e: (e["tick0"], e["tick1"]))

    def position(self) -> Optional[list]:
        pos = self.manifest().get("pos")
        return list(pos) if pos else None

    def tick(self) -> int:
        return int(self.manifest().get("tick", 0))

    def load_part(self, part: int, ent: dict, leaves: bool = True) -> dict:
        return self.parts[part].load(ent, leaves=leaves)

    def sweep_stale_tmp(self) -> int:
        n = 0
        for p in self.parts:
            n += p.sweep_stale_tmp()
        for p in list(self.dir.glob("*.json.tmp")):
            try:
                p.unlink()
                n += 1
            except OSError:          # pragma: no cover
                pass
        return n


def is_parted(path) -> bool:
    """Detect the parted layout without loading anything: the root
    manifest says so, or ``part_NN`` sub-stores exist (first pass not
    yet published)."""
    d = pathlib.Path(path)
    p = d / MANIFEST
    if p.exists():
        try:
            return json.loads(p.read_text()).get("layout") == "parted"
        except (OSError, ValueError):    # pragma: no cover — torn root
            return bool(part_dirs(d))
    return bool(part_dirs(d))


def open_shard_store(path, stats=None):
    """THE store-opening entry: a parted root opens as a
    :class:`PartedShardStore`, anything else as the flat
    :class:`ShardStore` — runtime, CLI and smoke all route here so a
    shard dir written by either compactor serves identically."""
    if is_parted(path):
        return PartedShardStore(path, stats=stats)
    return ShardStore(path, stats=stats)
