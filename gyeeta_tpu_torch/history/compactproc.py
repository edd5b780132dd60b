"""Parallel history compaction: per-shard WAL replay worker processes.

The compactor was the last single-process bottleneck of the history
tier: one replay Runtime consumed the WHOLE sharded WAL through a
k-way tick merge (``history/compactor.py``). But the sharded WAL is
host-partitioned — records in different ``shard_NN/`` subdirs are
host-DISJOINT (a host hashes to exactly one shard), so each
shard's sealed stream can replay through its OWN per-shard runtime
with no cross-shard interaction at all. That per-shard decomposition
is this module's canonical unit of work:

- ``--compact-procs N`` runs N spawned WORKER processes (fresh
  interpreters that never touch the serving process's state). WAL shard
  ``s`` goes to worker ``s % N`` (the sticky-group idiom of the ingest
  workers); each worker runs a stock
  :class:`~gyeeta_tpu_torch.history.compactor.Compactor` per shard over that
  shard's subdir (a flat journal dir) into its own ``part_NN/``
  sub-store, with per-shard resume positions in the part manifests.
  Replay of one shard is deterministic (append order × tick stamps),
  so the parts are BIT-IDENTICAL for any worker count — ``procs=1``
  and ``procs=8`` produce the same bytes, only the wall clock moves.

- The SUPERVISOR owns everything that needs the live journal: it
  seals, snapshots each shard's sealed bound (workers read at most
  that far — they must never chase a segment the live writer still
  owns), and after a pass rebuilds the parted store's ROOT manifest
  (``shards.PartedShardStore.rebuild_root``: the intersection of part
  windows, written tmp+fsync+rename). A SIGKILL at any worker
  boundary therefore leaves either the old root (new windows
  invisible; parts converge on the next pass) or the new one — never
  a window some part has not durably emitted. Truncate floors hand
  back per shard (``journal.floors_of`` triples), exactly like the
  single-process compactor.

- Queries serve the parted layout through
  ``timeview.PartedSnapshot`` — per-part materialization merged at
  column level, never funneled through one process-wide replay state.

Counterpart of ``gyeeta_tpu/history/compactproc.py``. The reference pins
its workers to CPU JAX; here each worker's replay runtime lives on the
device the supervisor was given (``device``, CUDA by default), as the
in-process ``Compactor``'s does: every worker is then a CUDA context of
its own on the card, and each replayed conn/resp slab launches the fused
sketch kernels there. The supervisor builds the kernel libraries before
it spawns a worker (no two ``nvcc`` runs race into ``build/kernels/``);
a worker that cannot reach CUDA or load a kernel reports the error and
the pass raises — nothing carries on on the CPU. Workers start with
``multiprocessing``'s spawn context, never fork, and share the host's
cores for PyTorch's CPU ops. Each report carries the worker's kernel
launch counts, its replay runtime's dispatches (conn/resp dispatches
counted by the runtime the worker builds through the ``Compactor``'s
``runtime_factory``) and its peak device
memory beside the reference's ``cpu_s``/``wall_s``. On the CPU the plain
versions are deterministic and ``procs=1`` and ``procs=N`` write the
same bytes; on CUDA the f32 sums the kernels add with atomics agree
within rounding.

Knobs are arguments, or reads of the ``env`` mapping a caller hands
over (``None`` means no environment): ``GYT_COMPACT_WARM_SEQ`` /
``GYT_COMPACT_WARM_TICK`` (replay a WAL prefix first, so a measured
pass is steady-state) and the crash hook ``GYT_COMPACT_DIE_SHARD``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import threading
import time
from typing import Optional

from gyeeta_tpu_torch.history import shards as SH
from gyeeta_tpu_torch.utils import journal as J

log = logging.getLogger("gyeeta_tpu_torch.history.compactproc")

# the knobs a worker reads, handed to it explicitly
_KNOBS = ("GYT_COMPACT_WARM_SEQ", "GYT_COMPACT_WARM_TICK",
          "GYT_COMPACT_DIE_SHARD")


class _NullStats:
    def bump(self, name, n=1):
        pass

    def gauge(self, name, v):
        pass

    def timeit(self, name):
        import contextlib
        return contextlib.nullcontext()


def _launches() -> dict:
    """The fused and generic kernels' launch counters of this process."""
    from gyeeta_tpu_torch.sketch import countmin, hyperloglog, invertible, \
        scatter
    return {"hll_update": hyperloglog.launches,
            "cms_update": countmin.launches,
            "inv_update": invertible.launches, **scatter.launch_counts()}


def _counting_runtime(device):
    """The workers' replay-runtime factory: a ``Runtime`` on ``device``
    that counts its conn/resp dispatches (the report's denominator of
    kernel launches a replayed dispatch)."""
    from gyeeta_tpu_torch.runtime import Runtime

    class _Replay(Runtime):
        connresp_dispatches = 0

        def _dispatch_fused(self, connresp=None):
            if connresp is not None:
                self.connresp_dispatches += 1
            return super()._dispatch_fused(connresp)

    return lambda cfg, sopts: _Replay(cfg, sopts, device=device)


def _part_group_worker(cfg, opts, jobs, upto_tick, q, device="cuda",
                       knobs=None, threads=0) -> None:
    """One worker process: replay each assigned WAL shard through a
    per-shard Compactor on ``device`` (sequentially — parallelism is
    ACROSS workers). Runs in a fresh interpreter; ``knobs`` is the
    ``GYT_COMPACT_*`` mapping the supervisor handed over, ``threads``
    this worker's share of the host's cores for PyTorch's CPU ops (N
    workers each using every core would oversubscribe the host)."""
    import resource
    import traceback

    knobs = knobs or {}
    try:
        import torch

        if threads:
            torch.set_num_threads(threads)
        from gyeeta_tpu_torch import device as D
        from gyeeta_tpu_torch.history.compactor import Compactor
        from gyeeta_tpu_torch.utils.selfstats import Stats
        # CUDA asked for and absent raises here: no CPU replay instead
        cuda = D.resolve(device).type == "cuda"
        # GYT_COMPACT_WARM_SEQ (the reference's bench knob): replay a
        # WAL prefix first, into the same part, so the measured pass
        # resumes from its shard and its rusage is steady-state
        warm = knobs.get("GYT_COMPACT_WARM_SEQ")
        for shard, jdir, pdir, upto in jobs:
            if warm:
                wt = knobs.get("GYT_COMPACT_WARM_TICK")
                cw = Compactor(cfg, opts, journal_dir=jdir,
                               shard_dir=pdir, stats=Stats(),
                               upto_seq=int(warm), device=device)
                try:
                    cw.compact_once(
                        upto_tick=int(wt) if wt else None)
                finally:
                    cw.close()
            st = Stats()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            l0 = _launches()
            r0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            c = Compactor(cfg, opts, journal_dir=jdir, shard_dir=pdir,
                          stats=st, upto_seq=upto,
                          runtime_factory=_counting_runtime(device))
            try:
                rep = c.compact_once(upto_tick=upto_tick)
                # the replay runtime's dispatches (launches a dispatch)
                rc = c._rt.stats.counters if c._rt is not None else {}
                rep["dispatches"] = {k: int(rc.get(k, 0)) for k in (
                    "fold_dispatches", "slab_dispatches")}
                rep["dispatches"]["connresp_dispatches"] = \
                    c._rt.connresp_dispatches if c._rt is not None else 0
            finally:
                c.close()
            if cuda:
                torch.cuda.synchronize(device)
            r1 = resource.getrusage(resource.RUSAGE_SELF)
            rep["cpu_s"] = round((r1.ru_utime - r0.ru_utime)
                                 + (r1.ru_stime - r0.ru_stime), 4)
            rep["wall_s"] = round(time.perf_counter() - t0, 4)
            rep["counters"] = dict(st.counters)
            rep["timings_ms"] = {k: v[1] for k, v
                                 in st.timing_totals().items()}
            rep["launches"] = {k: v - l0[k]
                               for k, v in _launches().items()}
            rep["peak_device_bytes"] = \
                int(torch.cuda.max_memory_allocated(device)) if cuda \
                else 0
            # crash injection for the SIGKILL-at-every-worker-boundary
            # consistency test: die HERE — this shard's part manifest
            # is durable, the supervisor's root manifest is not — with
            # no cleanup, exactly like a SIGKILL
            if knobs.get("GYT_COMPACT_DIE_SHARD") == str(shard):
                os._exit(9)
            q.put(("ok", shard, rep))
        q.put(("done", os.getpid(), None))
    except BaseException:           # noqa: BLE001 — surfaces upstream
        q.put(("err", os.getpid(), traceback.format_exc()))


class ParallelCompactor:
    """Drop-in sibling of :class:`Compactor` (same ``compact_once`` /
    ``start`` / ``stop`` / ``close`` surface) that writes the PARTED
    store layout via N replay worker processes, each replaying on
    ``device`` (CUDA by default; raises without a GPU unless
    ``device="cpu"``). ``env``: the ``GYT_COMPACT_*`` knob mapping handed
    to the workers (``None`` means no environment)."""

    def __init__(self, cfg, opts, procs: int, *, journal=None,
                 journal_dir: Optional[str] = None,
                 shard_dir: Optional[str] = None, stats=None,
                 clock=None, device=None, env=None):
        from gyeeta_tpu_torch import device as D
        self.device = str(D.resolve(device))
        env = {} if env is None else env
        self._knobs = {k: str(env[k]) for k in _KNOBS if env.get(k)}
        self.cfg = cfg
        self.opts = opts
        self.journal = journal
        self.journal_dir = journal_dir or opts.journal_dir
        if not self.journal_dir:
            raise ValueError("compaction needs a journal dir (the WAL "
                             "is the history source)")
        self.subdirs = J.sharded_subdirs(self.journal_dir)
        if not self.subdirs:
            raise ValueError(
                "--compact-procs needs a SHARDED WAL (shard_NN/ "
                "subdirs, serve --shards); a flat journal has no "
                "shard boundaries to parallelize across")
        self.procs = max(1, int(procs))
        if self.procs > len(self.subdirs):
            raise ValueError(
                f"--compact-procs {self.procs} > {len(self.subdirs)} "
                "WAL shards: workers beyond the shard count would "
                "idle (parallelism is at shard boundaries)")
        self.stats = stats if stats is not None else _NullStats()
        self.store = SH.PartedShardStore(
            shard_dir or opts.hist_shard_dir, stats=self.stats,
            nparts=len(self.subdirs))
        self.store.sweep_stale_tmp()
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._workers: list = []      # live worker Process objects
        #                               (tests SIGKILL them mid-pass)

    # --------------------------------------------------------- one pass
    def compact_once(self, seal: bool = False,
                     upto_tick: Optional[int] = None) -> dict:
        with self._lock:
            return self._compact_once(seal, upto_tick)

    def _compact_once(self, seal, upto_tick) -> dict:
        t0 = time.perf_counter()
        if seal and self.journal is not None:
            self.journal.seal_active()
        uptos = self.journal.sealed_upto() \
            if self.journal is not None else [None] * len(self.subdirs)
        if not isinstance(uptos, (list, tuple)):
            uptos = [uptos] * len(self.subdirs)
        jobs_of = {w: [] for w in range(self.procs)}
        for s, sub in enumerate(self.subdirs):
            pdir = self.store.dir / SH.PART_FMT.format(shard=s)
            jobs_of[s % self.procs].append(
                (s, str(sub), str(pdir),
                 uptos[s] if s < len(uptos) else None))
        reports = self._run_workers(jobs_of, upto_tick)
        # every part landed durably → publish the new root view; the
        # rebuild is the pass's ONLY root-manifest write (atomic)
        self.store.rebuild_root()
        if self.journal is not None:
            pos = self.store.position()
            if pos:
                self.journal.set_truncate_floor(J.floors_of(pos))
        secs = max(time.perf_counter() - t0, 1e-9)
        nrec = sum(r["records"] for r in reports.values())
        windows = sum(r["windows"] for r in reports.values())
        dropped = sum(r["retention_dropped"] for r in reports.values())
        if nrec:
            self.stats.gauge("compact_replay_ev_per_sec",
                             round(nrec / secs, 1))
        self.stats.gauge("compact_par_workers", float(self.procs))
        self.stats.gauge("compact_lag_seconds",
                         round(self.store.lag_seconds(self._clock()),
                               3))
        self.stats.bump("compact_passes")
        for r in reports.values():
            for k, v in r.get("counters", {}).items():
                if k.startswith(("compact_", "wd_", "wal_", "replay")):
                    self.stats.bump(k, v)
        return {"chunks": sum(r["chunks"] for r in reports.values()),
                "records": nrec, "windows": windows,
                "ev_per_sec": round(nrec / secs, 1),
                "secs": round(secs, 4), "retention_dropped": dropped,
                "tick": self.store.tick(), "workers": self.procs,
                "per_shard": {s: {"records": r["records"],
                                  "windows": r["windows"],
                                  "cpu_s": r["cpu_s"],
                                  "wall_s": r["wall_s"],
                                  "emit_ms": r["timings_ms"].get(
                                      "compact_emit", 0.0),
                                  "launches": r["launches"],
                                  "dispatches": r["dispatches"],
                                  "peak_device_bytes":
                                      r["peak_device_bytes"]}
                              for s, r in sorted(reports.items())},
                "launches": {k: sum(r["launches"][k]
                                    for r in reports.values())
                             for k in _launches()}}

    def _run_workers(self, jobs_of: dict, upto_tick) -> dict:
        if self.device.startswith("cuda"):
            # one build here: workers find the libraries and load them
            from gyeeta_tpu_torch.sketch import scatter
            scatter.build()
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = []
        threads = max(1, (os.cpu_count() or 1)
                      // max(1, sum(1 for j in jobs_of.values() if j)))
        for w, jobs in jobs_of.items():
            if not jobs:
                continue
            p = ctx.Process(target=_part_group_worker,
                            args=(self.cfg, self.opts, jobs,
                                  upto_tick, q, self.device,
                                  self._knobs, threads),
                            daemon=True,
                            name=f"gyt-compact-w{w}")
            p.start()
            procs.append(p)
        self._workers = procs
        reports: dict = {}
        failures: list = []
        pending = len(procs)
        import queue as _queue
        try:
            while pending:
                try:
                    kind, key, payload = q.get(timeout=0.5)
                except _queue.Empty:
                    # a SIGKILLed worker never sends "done" — notice
                    # its corpse instead of blocking the pass forever
                    if all(not p.is_alive() for p in procs):
                        break
                    continue
                if kind == "ok":
                    reports[key] = payload
                elif kind == "err":
                    failures.append(payload)
                    pending -= 1
                else:                      # "done"
                    pending -= 1
        except (EOFError, OSError):        # pragma: no cover
            pass
        while True:                        # late in-flight messages
            try:
                kind, key, payload = q.get_nowait()
            except (_queue.Empty, EOFError, OSError):
                break
            if kind == "ok":
                reports[key] = payload
            elif kind == "err":
                failures.append(payload)
        for p in procs:
            p.join(timeout=60.0)
            if p.exitcode not in (0, None) and not failures:
                failures.append(
                    f"worker {p.name} exited {p.exitcode} (killed "
                    "mid-pass?) — root manifest NOT advanced")
        self._workers = []
        missing = [s for s in range(len(self.subdirs))
                   if s not in reports]
        if failures or missing:
            self.stats.bump("compact_par_worker_failures")
            raise RuntimeError(
                "parallel compaction pass failed "
                f"(missing shards {missing}): "
                + ("; ".join(failures) or "worker died"))
        return reports

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
                        log.info("compacted %d window(s) across %d "
                                 "worker(s), %d chunk(s), %.0f ev/s",
                                 rep["windows"], rep["workers"],
                                 rep["chunks"], rep["ev_per_sec"])
                except Exception:     # noqa: BLE001 — daemon survives
                    self.stats.bump("compact_errors")
                    log.exception("parallel compaction pass failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="gyt-compactor-par")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=60.0)
        self._thread = None

    def close(self) -> None:
        self.stop()
        for p in self._workers:       # pragma: no cover — abnormal
            if p.is_alive():
                p.terminate()
        self._workers = []
