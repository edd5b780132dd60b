"""WAL compaction daemon: sealed journal segments → snapshot shards.

The write half of the time-travel tier. Every accepted wire chunk
already lands in the write-ahead journal in feed order, stamped
with the window tick it was folded under; checkpoints are positioned
against it. The compactor is a SECOND, full-rate consumer of that
journal: it re-folds sealed segments through the normal decode path
and ``fold_all`` (a dedicated replay Runtime of the serving one's
geometry), runs the 5s window tick exactly where the live engine ran
it (the chunk tick stamps are the evidence), and at every
``hist_window_ticks`` boundary emits one columnar snapshot shard
(``history/shards.py``).

Correctness contract: the WAL records the exact accepted-chunk
sequence and fold boundaries of the live engine, so the replayed state
at tick T is BIT-IDENTICAL to the live engine state at T on the CPU
(``tests/test_torch_history.py``); on CUDA the float sums that atomics
add in no fixed order agree within rtol 1e-6. A window [W0, W1] is
emitted only once a chunk stamped tick >= W1 has been read — appends
are ordered, so every chunk belonging to the window is provably behind
it; the live engine's open window is never guessed at.

Handoff: the compactor registers a truncate floor on the live journal
(``Journal.set_truncate_floor``) so checkpoint-driven truncation can
never delete segments it has not consumed; its own durable position
(the newest raw shard's recorded WAL position) advances the floor.
Restart resume re-seeds the replay runtime from the newest raw shard —
the shard doubles as the compactor's checkpoint.

Retention ages raw → downsampled → dropped: raw shards beyond
``hist_retain_raw`` merge into ``mid`` shards (``hist_mid_every`` raws
each — sketch state is monotone, so the newest member's state IS the
window merge; columns aggregate per entity), mids beyond
``hist_retain_mid`` merge into ``hour`` shards, hours beyond
``hist_retain_hour`` drop.

Counterpart of ``gyeeta_tpu/history/compactor.py``. The replay
``Runtime`` lives on the serving runtime's device (``device``), so on
CUDA every replayed conn/resp slab launches the fused sketch kernels,
and shards carry the reference's leaf order and dtypes
(``aggstate.state_to_numpy``). A journal dir with ``shard_NN/``
subdirectories (the sharded runtime's per-shard WAL) is read by a walk
that merges the shards' sealed segments by window tick into the same
flat replay runtime, and the resume position is then per shard
(``[shard, seg, off]`` triples), as the reference's in-process
compactor does. ``upto_seq`` is the sealed bound a journal-less reader
stops at: the parallel compactor's worker processes
(``history/compactproc.py``) each run one ``Compactor`` a WAL shard
under it. ``runtime_factory`` (``(cfg, opts) → runtime``) builds the
replay runtime instead of a ``Runtime`` on ``device``; the workers
build a ``Runtime`` that counts its conn/resp dispatches for their
reports.

The replay runtime owns its state's layout: the compactor writes a
shard from its ``leaves()`` / ``delta_leaves()`` / ``task_panel()`` and
resumes through ``load_leaves``. A ``ShardedRuntime`` factory's
runtime gives the reference's stacked ``(n_shards, ...)`` leaves
(``parallel/sharded.state_to_numpy``), its delta leaves and task panel
every slab row of every shard, shard-major, as the stacked leaves lie,
and its other panels from its merged columns; ``TimeView`` reads such
a shard back into the mesh for ``at=`` / ``window=`` queries.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from gyeeta_tpu_torch.history import shards as SH, winquant as WQ
from gyeeta_tpu_torch.history.timeview import aggregate_window_columns
from gyeeta_tpu_torch.query.lazycols import LazyCols
from gyeeta_tpu_torch.utils import journal as J
from gyeeta_tpu_torch.utils.checkpoint import _cfg_fingerprint

log = logging.getLogger("gyeeta_tpu_torch.history.compactor")


class _NullStats:
    def bump(self, name, n=1):
        pass

    def gauge(self, name, v):
        pass

    def timeit(self, name):
        import contextlib
        return contextlib.nullcontext()


def strip_opts(opts):
    """RuntimeOpts for the REPLAY runtime: identical fold/tick behavior
    (aging, td drain bounds, dep geometry — state evolution must match
    the live engine bit-for-bit), with every side-channel that would
    double-write disabled (journal, checkpoints, relational history,
    shard emission is the compactor's own job)."""
    return opts._replace(journal_dir=None, checkpoint_dir=None,
                         history_db=None, hist_shard_dir=None)


class Compactor:
    """One compaction pipeline: journal dir → replay runtime → shard
    store. Drive it synchronously (``compact_once``, tests/CLI/bench)
    or as a daemon thread (``start``/``stop``)."""

    def __init__(self, cfg, opts, *, journal=None,
                 journal_dir: Optional[str] = None,
                 shard_dir: Optional[str] = None,
                 runtime_factory=None, stats=None, clock=None,
                 upto_seq=None, device=None):
        self.cfg = cfg
        self.device = device              # the replay runtime's device
        self.opts = opts
        self.window_ticks = max(1, int(opts.hist_window_ticks))
        self.journal = journal            # live Journal (seal + floor);
        #                                   None = offline dir read
        # journal-less bound: a parallel-compaction worker reads files
        # another process's live journal owns — it must stop at the
        # sealed bound the supervisor snapshotted, exactly as a live
        # journal object's sealed_upto() would bound it
        self._upto_seq = upto_seq
        self.journal_dir = journal_dir or opts.journal_dir
        if not self.journal_dir:
            raise ValueError("compaction needs a journal dir (the WAL "
                             "is the history source)")
        self.stats = stats if stats is not None else _NullStats()
        self.store = SH.ShardStore(shard_dir or opts.hist_shard_dir,
                                   stats=self.stats)
        self.store.sweep_stale_tmp()
        self._factory = runtime_factory
        self._clock = clock or time.time
        self._rt = None
        self._pos: Optional[tuple] = None   # in-memory WAL resume point
        # monotone-leaf snapshots at the last emit: the per-window
        # delta base (winquant). None = engine state is all-zero.
        self._delta_base: Optional[dict] = None
        self._win_t0: Optional[float] = None
        self._win_t1: Optional[float] = None
        self._last_t: Optional[float] = None
        self._lock = threading.Lock()       # one compaction at a time
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------ replay engine
    def _make_rt(self):
        sopts = strip_opts(self.opts)
        if self._factory is not None:
            return self._factory(self.cfg, sopts)
        from gyeeta_tpu_torch.runtime import Runtime
        return Runtime(self.cfg, sopts, device=self.device)

    def _load_into(self, rt, ent: dict) -> None:
        """Re-seed the replay runtime from a shard (restart resume —
        the shard is the compactor's checkpoint)."""
        data = self.store.load(ent)
        try:
            rt.load_leaves(data["state"], data["dep"])
        except ValueError as e:
            raise ValueError(f"shard {ent['file']}: {e}") from None
        # the resumed shard's monotone leaves ARE the delta base: the
        # next window's delta is state-at-next-emit − this state
        self._delta_base = {name: leaf.astype(np.float64)
                            for name, leaf in rt.delta_leaves().items()}
        rt._tick_no = int(ent["tick1"])
        rt._td_dirty = True
        rt._cols.bump()
        self._last_t = float(ent["t1"])
        wal = data["meta"].get("wal")
        if wal and isinstance(wal[0], (list, tuple)):
            # sharded WAL: [shard, seg, off] triples → per-shard map
            self._pos = {int(e[0]): (int(e[1]), int(e[2])) for e in wal}
        else:
            self._pos = tuple(wal) if wal else None

    def _ensure_rt(self):
        if self._rt is not None:
            return self._rt
        rt = self._make_rt()
        newest = self.store.newest("raw")
        if newest is not None:
            self._load_into(rt, newest)
        else:
            self._pos = None
        self._rt = rt
        return rt

    # --------------------------------------------------------- compaction
    def compact_once(self, seal: bool = False,
                     upto_tick: Optional[int] = None) -> dict:
        """One pass: read sealed WAL from the resume position, re-fold,
        emit shards at window boundaries, run retention.

        ``seal=True`` rotates the live journal first so the current
        window's bytes become consumable. ``upto_tick`` additionally
        ticks the replay engine past the last chunk's stamp — ONLY
        sound when the journal is sealed and the producer is quiesced
        (tests / shutdown / bench), because in-flight windows have no
        completeness evidence otherwise."""
        with self._lock:
            return self._compact_once(seal, upto_tick)

    def _pos_serial(self):
        """JSON-stable resume position: the flat ``(seg, off)`` pair,
        or ``[shard, seg, off]`` triples for the sharded WAL."""
        if isinstance(self._pos, dict):
            return [[int(s), int(p[0]), int(p[1])]
                    for s, p in sorted(self._pos.items())]
        return self._pos

    def _chunk_stream(self, upto):
        """Sealed-WAL chunks from the resume position → ``(pos_update_fn,
        t, hid, tick, cid, chunk)``: the flat-dir walk, or the tick-
        merged walk over ``shard_NN/`` subdirs of a sharded WAL (the
        merge keeps windows in order; within a tick the shards' records
        are host-disjoint, so their interleave does not matter)."""
        subdirs = J.sharded_subdirs(self.journal_dir)
        if subdirs:
            for s, seq, off, t, hid, tick, cid, chunk in \
                    J.read_sealed_sharded(subdirs, self._pos_map(), upto,
                                          stats=self.stats):
                def upd(s=s, seq=seq, off=off):
                    cur = self._pos_map()
                    cur[s] = (seq, off)
                    self._pos = cur
                yield upd, t, hid, tick, cid, chunk
            return
        for seq, off, t, hid, tick, cid, chunk in J.read_sealed(
                self.journal_dir, self._pos, upto, stats=self.stats):
            def upd(seq=seq, off=off):
                self._pos = (seq, off)
            yield upd, t, hid, tick, cid, chunk

    def _pos_map(self) -> dict:
        return dict(self._pos) if isinstance(self._pos, dict) else {}

    def _compact_once(self, seal, upto_tick) -> dict:
        t_wall = time.perf_counter()
        rt = self._ensure_rt()
        if seal and self.journal is not None:
            self.journal.seal_active()
        # a live journal bounds the read at its sealed segments; an
        # offline dir (no writer) is read whole, or up to the bound a
        # parallel compactor's supervisor snapshotted
        upto = self.journal.sealed_upto() \
            if self.journal is not None else self._upto_seq
        if upto is not None and not isinstance(upto, (list, tuple)) \
                and J.sharded_subdirs(self.journal_dir):
            upto = None                    # layout mismatch: read all
        nrec = nch = windows = 0
        with self.stats.timeit("compact_replay"):
            for upd, t, hid, tick, cid, chunk in self._chunk_stream(
                    upto):
                if tick > rt._tick_no:
                    windows += self._tick_to(rt, tick)
                nrec += rt.feed(chunk, hid=hid, conn_id=cid)
                nch += 1
                upd()
                self._win_t0 = t if self._win_t0 is None \
                    else min(self._win_t0, t)
                self._win_t1 = t if self._win_t1 is None \
                    else max(self._win_t1, t)
            rt.flush()
            if upto_tick is not None and upto_tick > rt._tick_no:
                windows += self._tick_to(rt, int(upto_tick))
        secs = max(time.perf_counter() - t_wall, 1e-9)
        ev_s = nrec / secs
        if nrec:
            self.stats.gauge("compact_replay_ev_per_sec",
                             round(ev_s, 1))
        self.stats.gauge("compact_lag_seconds",
                         round(self.store.lag_seconds(self._clock()),
                               3))
        self.stats.bump("compact_passes")
        if self.journal is not None:
            pos = self.store.position()
            if pos is not None:
                # durable handoff: checkpoint truncation may now drop
                # segments the shard tier has absorbed
                self.journal.set_truncate_floor(J.floors_of(pos))
        dropped = self.retention()
        return {"chunks": nch, "records": nrec, "windows": windows,
                "ev_per_sec": round(ev_s, 1), "secs": round(secs, 4),
                "retention_dropped": dropped,
                "tick": rt._tick_no}

    def _tick_to(self, rt, target: int) -> int:
        """Advance the replay engine's window tick to ``target``
        (chunks stamped ``target`` are about to fold), emitting a raw
        shard at every window boundary crossed — the exact cadence the
        live engine ran."""
        emitted = 0
        while rt._tick_no < target:
            rt.run_tick()
            # nothing reads the replay runtime's published snapshot (no
            # alertdefs, no queries): drop its copy of the state
            rt.snapshot = None
            if rt._tick_no % self.window_ticks == 0:
                self._emit(rt)
                emitted += 1
        return emitted

    def _emit(self, rt) -> None:
        tick1 = rt._tick_no
        tick0 = tick1 - self.window_ticks
        columns = {}
        for subsys in SH.SNAP_SUBSYS:
            if subsys == "taskstate":
                cols, mask = rt.task_panel()
            else:
                cols, mask = rt._cached_columns(subsys)
            if isinstance(cols, LazyCols):
                cols = cols.full()
            columns[subsys] = (cols, np.asarray(mask, bool))
        t1 = self._win_t1 if self._win_t1 is not None \
            else (self._last_t if self._last_t is not None
                  else self._clock())
        t0 = self._win_t0 if self._win_t0 is not None else t1
        # per-window sketch deltas: end-state minus the last emit's
        # base for every monotone loghist leaf — the mergeable partial
        # aggregates true windowed quantiles sum (winquant module doc)
        deltas, self._delta_base, diag = WQ.extract_deltas(
            self.cfg, rt.delta_leaves(), columns, self._delta_base)
        for k, v in diag.items():
            if v:
                self.stats.bump(k, v)
        with self.stats.timeit("compact_emit"):
            state_leaves, dep_leaves = rt.leaves()
            ent = self.store.add_shard(
                level="raw", tick0=tick0, tick1=tick1, t0=t0, t1=t1,
                state_leaves=state_leaves, dep_leaves=dep_leaves,
                columns=columns,
                cfg_fp=_cfg_fingerprint(self.cfg),
                wal_pos=self._pos_serial(),
                deltas=deltas)
        self.stats.gauge("compact_shard_bytes", float(ent["bytes"]))
        self._last_t = t1
        self._win_t0 = self._win_t1 = None

    # ---------------------------------------------------------- retention
    def retention(self) -> int:
        """Age raw → mid → hour → dropped. Returns shards removed
        (merged sources + expired hours)."""
        removed = 0
        removed += self._downsample(
            "raw", "mid", self.window_ticks * self.opts.hist_mid_every,
            self.opts.hist_retain_raw)
        removed += self._downsample(
            "mid", "hour",
            self.window_ticks * self.opts.hist_mid_every
            * self.opts.hist_hour_every,
            self.opts.hist_retain_mid)
        hours = self.store.shards("hour")
        extra = len(hours) - int(self.opts.hist_retain_hour)
        if extra > 0:
            removed += self.store.drop(hours[:extra])
        return removed

    def _downsample(self, src: str, dst: str, dst_ticks: int,
                    retain: int) -> int:
        srcs = self.store.shards(src)
        old = srcs[: max(0, len(srcs) - int(retain))]
        if not old:
            return 0
        kept_groups = {e["tick0"] // dst_ticks
                       for e in srcs[len(old):]}
        groups: dict = {}
        for e in old:
            groups.setdefault(e["tick0"] // dst_ticks, []).append(e)
        removed = 0
        for g in sorted(groups):
            members = sorted(groups[g], key=lambda e: e["tick1"])
            if g in kept_groups:
                continue      # younger members still inside retention
            self._merge_group(members, dst)
            removed += len(members)
        return removed

    def _merge_group(self, members: list, dst: str) -> None:
        """Merge consecutive shards into one downsampled shard: newest
        member's sketch state (monotone sketches — the merge IS the
        newest state), per-entity aggregated columns, and SUMMED
        per-window delta panels (deltas are additive partial
        aggregates, so a downsampled shard answers windowed quantiles
        at full fidelity — only the window boundaries coarsen)."""
        data = [self.store.load(e) for e in members]
        columns = {}
        for subsys in SH.SNAP_SUBSYS:
            parts = [d["columns"][subsys] for d in data
                     if subsys in d["columns"]]
            if parts:
                columns[subsys] = aggregate_window_columns(subsys,
                                                           parts)
        deltas = {}
        names = {n for d in data for n in d.get("deltas", {})}
        for name in names:
            parts = [(d["deltas"][name]["key"],
                      d["deltas"][name]["hist"])
                     for d in data if name in d.get("deltas", {})]
            if len(parts) != len(data):
                continue     # a member predates delta panels: a merged
                #              panel would silently undercount — omit it
                #              (windowed quantiles reject, never lie)
            keys, hist = WQ.merge_delta_rows(parts)
            ent = {"key": keys, "hist": hist.astype(np.float32)}
            if WQ.DELTA_SPECS[name].td and len(keys):
                m, w, vmin, vmax = WQ.td_from_hist(
                    hist, WQ.spec_of(self.cfg, name),
                    int(getattr(self.cfg, "td_capacity", 64)))
                ent["td"] = {"means": m, "weights": w,
                             "vmin": vmin, "vmax": vmax}
            deltas[name] = ent
        newest = data[-1]
        self.store.add_shard(
            level=dst,
            tick0=members[0]["tick0"], tick1=members[-1]["tick1"],
            t0=min(e["t0"] for e in members),
            t1=max(e["t1"] for e in members),
            state_leaves=newest["state"], dep_leaves=newest["dep"],
            columns=columns, cfg_fp=newest["meta"].get("cfg", ""),
            wal_pos=None, replaces=members, deltas=deltas)
        self.stats.bump("compact_downsampled")

    # ------------------------------------------------------------- daemon
    def start(self, interval: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        interval = float(interval
                         if interval is not None
                         else self.opts.hist_compact_interval_s)
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    rep = self.compact_once(seal=True)
                    if rep["windows"]:
                        log.info("compacted %d window(s), %d chunk(s), "
                                 "%.0f ev/s", rep["windows"],
                                 rep["chunks"], rep["ev_per_sec"])
                except Exception:     # noqa: BLE001 — daemon survives
                    self.stats.bump("compact_errors")
                    log.exception("compaction pass failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="gyt-compactor")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._thread = None

    def close(self) -> None:
        self.stop()
        if self._rt is not None:
            self._rt.close()
            self._rt = None
