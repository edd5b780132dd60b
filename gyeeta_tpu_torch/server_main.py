"""gyt-server: the deployable aggregation-server daemon of the port.

Counterpart of ``gyeeta_tpu/server_main.py``: config layering (defaults
≺ file ≺ ``GYT_<FIELD>`` environment ≺ flags; this module is the one
place that hands ``os.environ`` to the loaders, the segment shipper and
the receiver), structured startup logging, checkpoint restore and WAL
replay, the history compactor, the remote compaction region (a segment
receiver landing shipped WAL segments in ``--ship-staging`` and the
staging compaction loop replaying them into ``--shard-dir``) and the
source side's segment shipper (``--ship-to``), SIGTERM/SIGINT graceful
shutdown (drain staged slabs, final checkpoint), SIGHUP hot-reload of
runtime knobs, and a periodic self-stats report. Run as
``python -m gyeeta_tpu_torch serve --device cuda --port 10038``.

The runtime, and every compactor's replay runtime, lives on ``--device``
(CUDA by default; without a GPU the daemon raises unless ``--device cpu``
is given). ``--shards N`` (N > 1) serves the sharded runtime
(``parallel/shardedrt.py``) over an N-shard mesh on that device — N
logical shards of one card, or one card a shard where there are N —
with per-shard ingest queues (``--shard-queue-mb``) and a per-shard WAL
under ``--journal-dir``. The sharded tier's worker processes:
``--ingest-procs N`` hands registered event conns to N ingest worker
processes that publish decoded records into shared-memory rings
(``net/ingestproc.py``; needs ``--shards`` ≥ N), ``--relay-port P``
accepts remote ingest relays (``net/relay.py``), and ``--compact-procs
N`` compacts the per-shard WAL with N replay worker processes on
``--device`` into a parted shard store (``history/compactproc.py``).
``--profile-dir D`` writes a ``torch.profiler`` Chrome trace of the
runtime's first ``--profile-folds`` fold dispatches into ``D``
(``obs/spans.FoldProfiler``).

Single-controller design: one asyncio loop owns the Runtime; the device
stream is the concurrency.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
from typing import Optional

from gyeeta_tpu_torch.net.server import GytServer
from gyeeta_tpu_torch.obs.spans import FoldProfiler
from gyeeta_tpu_torch.runtime import Runtime
from gyeeta_tpu_torch.utils import config as C

log = logging.getLogger("gyeeta_tpu_torch.daemon")


def _make_runtime(args, cfg, opts):
    """``--shards N`` (N > 1): the sharded runtime over an N-shard mesh
    on ``--device`` (per-shard folds, one fleet roll-up a tick,
    per-shard WAL subdirs); else the single-device runtime."""
    device = getattr(args, "device", None) or "cuda"
    shards = int(getattr(args, "shards", 0) or 0)
    profiler = FoldProfiler(getattr(args, "profile_dir", None),
                            getattr(args, "profile_folds", 20))
    if shards <= 1:
        return Runtime(cfg, opts, device=device, profiler=profiler)
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    mesh = make_mesh(shards, device=device)
    log.info("sharded runtime: %d-shard mesh on %s, per-shard WAL %s",
             shards, sorted({str(d) for d in mesh.devices}),
             "on" if opts.journal_dir else "off")
    return ShardedRuntime(cfg, mesh, opts, profiler=profiler)


class _StagingCompactLoop:
    """Compaction-region replay loop over a ship staging directory.

    Segments land in ``staging`` via net/segship.py and are replayed by
    the port's compactors (journal_dir mode) exactly as if local, their
    replay runtimes on ``device`` (the daemon's). The layout (flat vs
    shard_NN/) is discovered from what actually lands, so the daemon can
    boot on an empty staging dir before the first segment arrives —
    construction of the compactor is deferred to the first pass that
    finds segments (ParallelCompactor refuses an empty or flat dir at
    construction, and its proc count must be clamped to the shard count
    the shipper reveals). ``env``: the ``GYT_COMPACT_*`` knobs."""

    def __init__(self, cfg, opts, staging: str, shard_dir: str,
                 procs: int = 0, stats=None, device=None, env=None):
        self.cfg = cfg
        self.opts = opts
        self.staging = staging
        self.shard_dir = shard_dir
        self.procs = int(procs or 0)
        self.stats = stats
        self.device = device
        self.env = env
        self.compactor = None
        self._stop = None           # threading.Event, set in start()
        self._thread = None

    def _ensure(self):
        if self.compactor is not None:
            return self.compactor
        from gyeeta_tpu_torch.utils import journal as J
        subs = J.sharded_subdirs(self.staging)
        if subs and self.procs >= 1:
            from gyeeta_tpu_torch.history.compactproc import \
                ParallelCompactor
            self.compactor = ParallelCompactor(
                self.cfg, self.opts, min(self.procs, len(subs)),
                journal_dir=self.staging, shard_dir=self.shard_dir,
                stats=self.stats, device=self.device, env=self.env)
        elif subs or J.dir_segments(self.staging):
            from gyeeta_tpu_torch.history.compactor import Compactor
            self.compactor = Compactor(self.cfg, self.opts,
                                       journal_dir=self.staging,
                                       shard_dir=self.shard_dir,
                                       stats=self.stats,
                                       device=self.device)
        return self.compactor

    def pass_once(self) -> None:
        c = self._ensure()
        if c is None:
            return                  # nothing landed yet
        c.compact_once()

    def floors(self):
        """The (per-shard) compacted floors for
        SegmentReceiver.sweep_below: a staged segment below its floor is
        fully represented in the shard store and safe to delete locally
        (the ship ledger keeps answering "done" for it)."""
        c = self.compactor
        if c is None:
            return None
        try:
            pos = c.store.position()
        except Exception:           # noqa: BLE001 — sweep is best-effort
            return None
        if not pos:
            return None
        from gyeeta_tpu_torch.utils import journal as J
        return J.floors_of(pos)

    def start(self) -> None:
        import threading
        self._stop = threading.Event()
        interval = max(float(self.opts.hist_compact_interval_s), 0.2)

        def _loop():
            while not self._stop.wait(interval):
                try:
                    self.pass_once()
                except Exception:   # noqa: BLE001 — keep the loop alive
                    if self.stats is not None:
                        self.stats.bump("compact_errors")
                    log.exception("staging compaction pass failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="gyt-staging-compact")
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def final_pass(self) -> None:
        """Stop the loop and run one last replay so a clean stop leaves
        the shard store current with everything already landed."""
        self.stop()
        try:
            self.pass_once()
        except Exception:           # noqa: BLE001 — never block shutdown
            log.exception("final staging compaction pass failed")
        if self.compactor is not None:
            self.compactor.close()


class Daemon:
    def __init__(self, args: argparse.Namespace, env=None):
        """``env``: the environment layer of the config loaders and the
        ``GYT_SHIP_*`` knobs of the shipper and the receiver
        (``os.environ`` unless given)."""
        self.args = args
        env = os.environ if env is None else env
        self.env = env
        cfg = C.load_engine_cfg(args.config, env=env)
        opts = C.load_runtime_opts(
            args.config, env=env,
            **({"history_db": args.history_db} if args.history_db else {}),
            **({"checkpoint_dir": args.checkpoint_dir}
               if args.checkpoint_dir else {}),
            **({"journal_dir": args.journal_dir}
               if getattr(args, "journal_dir", None) else {}),
            **({"journal_fsync_ms": args.journal_fsync_ms}
               if getattr(args, "journal_fsync_ms", None) is not None
               else {}),
            **({"journal_fsync_kb": args.journal_fsync_kb}
               if getattr(args, "journal_fsync_kb", None) is not None
               else {}),
            **({"journal_segment_mb": args.journal_segment_mb}
               if getattr(args, "journal_segment_mb", None) is not None
               else {}),
            **({"hist_shard_dir": args.shard_dir}
               if getattr(args, "shard_dir", None) else {}),
            **({"hist_window_ticks": args.hist_window_ticks}
               if getattr(args, "hist_window_ticks", None) is not None
               else {}),
            **({"hist_compact_interval_s": args.compact_interval}
               if getattr(args, "compact_interval", None) is not None
               else {}))
        # a crash mid-`checkpoint.save` leaves .tmp.npz staging files
        # behind; without a start-time sweep they accumulate forever
        if opts.checkpoint_dir:
            from gyeeta_tpu_torch.utils import checkpoint as _ck
            n = _ck.sweep_stale_tmp(opts.checkpoint_dir)
            if n:
                log.info("swept %d stale .tmp.npz staging file(s)", n)
        self.rt = _make_runtime(args, cfg, opts)
        if args.restore:
            extra = self.rt.restore(args.restore)
            log.info("restored checkpoint %s (tick %s)", args.restore,
                     extra.get("tick"))
            _replay_wal(self.rt, extra)
        elif getattr(args, "restore_latest", False):
            if restore_latest_checkpoint(
                    self.rt, opts.checkpoint_dir) is None:
                log.info("no usable checkpoint (cold start)")
        self.srv = GytServer(self.rt, host=args.host, port=args.port,
                             tick_interval=args.tick_interval,
                             hostmap_path=args.hostmap,
                             record_path=args.record,
                             feed_pipeline=getattr(
                                 args, "feed_pipeline", False),
                             handshake_timeout=getattr(
                                 args, "handshake_timeout", 10.0),
                             idle_timeout=getattr(
                                 args, "idle_timeout", None),
                             write_timeout=getattr(
                                 args, "write_timeout", 10.0),
                             frame_error_budget=getattr(
                                 args, "frame_error_budget", 8),
                             throttle_hold_ms=getattr(
                                 args, "throttle_hold_ms", 1500),
                             throttle_lag_s=getattr(
                                 args, "throttle_lag_s", 0.75),
                             throttle_pending_mb=getattr(
                                 args, "throttle_pending_mb", 32.0),
                             throttle_ring_frac=getattr(
                                 args, "throttle_ring_frac", 0.75),
                             query_workers=getattr(
                                 args, "query_workers", None),
                             query_queue_max=getattr(
                                 args, "query_queue_max", None),
                             query_snapshot=not getattr(
                                 args, "query_strong", False),
                             shard_ingest=getattr(args, "shards", 0) > 1,
                             shard_queue_mb=getattr(
                                 args, "shard_queue_mb", 8.0),
                             ingest_procs=getattr(
                                 args, "ingest_procs", 1) or 1,
                             sub_persist=getattr(
                                 args, "sub_persist", None),
                             relay_port=getattr(
                                 args, "relay_port", None),
                             preagg=getattr(args, "preagg", False),
                             env=env)
        self._hot = C.HotReload(args.config, opts) if args.config else None
        # history compaction daemon: sealed WAL segments → columnar
        # snapshot shards (the time-travel tier's writer). Runs only
        # with BOTH a journal (the source) and a shard dir (the sink).
        self.compactor = None
        # remote compaction region pieces: receiver + staging replay
        # loop on the compaction side, shipper thread on the source side
        self._ship_loop = None
        self.ship_recv = None
        self.shipper = None
        self._ship_thread = None
        if opts.hist_shard_dir and getattr(args, "ship_staging", None):
            # compaction-region mode: the WAL source is the SHIP STAGING
            # dir (segments landed by net/segship.py), not this
            # process's own journal; replayed on the runtime's device
            self._ship_loop = _StagingCompactLoop(
                self.rt.cfg, opts, args.ship_staging,
                opts.hist_shard_dir,
                procs=getattr(args, "compact_procs", 0),
                stats=self.rt.stats, device=self.rt.device, env=env)
        elif opts.hist_shard_dir and self.rt.journal is not None:
            # replay runtimes run on the serving runtime's device
            if getattr(args, "compact_procs", 0) >= 1:
                # distributed compaction: N replay worker processes
                # over disjoint WAL shard groups (parted store layout)
                from gyeeta_tpu_torch.history.compactproc import \
                    ParallelCompactor
                self.compactor = ParallelCompactor(
                    self.rt.cfg, opts, args.compact_procs,
                    journal=self.rt.journal, stats=self.rt.stats,
                    device=self.rt.device, env=env)
            else:
                from gyeeta_tpu_torch.history.compactor import Compactor
                self.compactor = Compactor(self.rt.cfg, opts,
                                           journal=self.rt.journal,
                                           stats=self.rt.stats,
                                           device=self.rt.device)
        elif opts.hist_shard_dir:
            log.warning("--shard-dir set without --journal-dir: the "
                        "WAL is the history source — time-travel "
                        "queries will serve existing shards only")
        self.stop_event = asyncio.Event()

    async def run(self) -> None:
        host, port = await self.srv.start()
        log.info("gyt-server listening on %s:%d (svc_capacity=%d, "
                 "n_hosts=%d); protocol edges: GYT agent/query, "
                 "stock partha (PS/PM), stock node webserver (NM)",
                 host, port, self.rt.cfg.svc_capacity,
                 self.rt.cfg.n_hosts)
        # crash forensics + liveness watchdog (the reference's
        # fatal-signal backtraces + scheduler watchdogs)
        from gyeeta_tpu_torch.utils import crashguard
        if self.rt.opts.checkpoint_dir:
            os.makedirs(self.rt.opts.checkpoint_dir, exist_ok=True)
            crash_path = f"{self.rt.opts.checkpoint_dir}/gyt_crash.log"
        else:
            import tempfile
            crash_path = os.path.join(tempfile.gettempdir(),
                                      "gyt_crash.log")
        crashguard.enable_crash_dumps(crash_path)
        watchdog = None
        if self.args.tick_interval:
            watchdog = crashguard.TickWatchdog(
                stall_after_s=max(12 * self.args.tick_interval, 30.0),
                on_stall=lambda gap: self.rt.notifylog.add(
                    f"serving loop stalled for {gap:.0f}s "
                    f"(stacks in {crash_path})", ntype="error",
                    source="selfmon"))
            watchdog.beat()
            watchdog.start()
            self.srv.watchdog = watchdog
        if self.compactor is not None:
            self.compactor.start()
            log.info("history compactor: window=%d ticks, every %.0fs "
                     "-> %s", self.rt.opts.hist_window_ticks,
                     self.rt.opts.hist_compact_interval_s,
                     self.rt.opts.hist_shard_dir)
        await self._start_ship()
        stats_task = asyncio.create_task(self._stats_loop())
        try:
            await self.stop_event.wait()
        finally:
            if watchdog is not None:
                watchdog.stop()
            stats_task.cancel()
            await self.shutdown()

    async def _start_ship(self) -> None:
        """The remote compaction region's receiver and staging loop,
        and the source side's shipper thread, as the flags ask."""
        args = self.args
        if getattr(args, "ship_staging", None) \
                and getattr(args, "ship_port", None) is not None:
            from gyeeta_tpu_torch.net.segship import SegmentReceiver
            self.ship_recv = SegmentReceiver(
                args.ship_staging, stats=self.rt.stats,
                host=args.ship_listen_host, port=args.ship_port,
                floors_fn=(self._ship_loop.floors
                           if self._ship_loop is not None else None),
                notifylog=self.rt.notifylog, env=self.env)
            sh, sp = await self.ship_recv.start()
            # machine-parsable bind line for harnesses scripting
            # ephemeral ports
            print(f"SHIP_LISTEN {sh} {sp}", flush=True)
        if self._ship_loop is not None:
            self._ship_loop.start()
            log.info("staging compactor over %s every %.0fs -> %s",
                     args.ship_staging,
                     self.rt.opts.hist_compact_interval_s,
                     self.rt.opts.hist_shard_dir)
        if getattr(args, "ship_to", None) and self.rt.journal is not None:
            import threading

            from gyeeta_tpu_torch.history.shipper import SegmentShipper
            th, _, tp = args.ship_to.rpartition(":")
            self.shipper = SegmentShipper({
                "target": (th or "127.0.0.1", int(tp)),
                "shipper_id": getattr(args, "ship_id", None),
                "journal": self.rt.journal, "stats": self.rt.stats,
                "env": self.env})
            self._ship_thread = threading.Thread(
                target=self.shipper.run, daemon=True, name="gyt-shipper")
            self._ship_thread.start()
            log.info("segment shipper -> %s (id=%s)", args.ship_to,
                     self.shipper.shipper_id)
        elif getattr(args, "ship_to", None):
            log.warning("--ship-to without --journal-dir: nothing to "
                        "ship (the WAL is the shipped source)")

    async def _stats_loop(self) -> None:
        while True:
            await asyncio.sleep(self.args.stats_interval)
            d = self.rt.stats.delta()
            if d:
                log.info("stats %s", json.dumps(d, default=str))
            # the numpy decode path must be visible without a query
            # client: the per-interval numpy decode count rides the
            # cadence log at WARNING (the runtime decodes natively
            # unless it was built with deframe="python")
            if d.get("ref_fallback_decoded"):
                log.warning(
                    "numpy decode path active: %d events decoded in "
                    "Python this interval (counter ref_fallback_decoded;"
                    " the native library builds with `python -m "
                    "gyeeta_tpu_torch.ingest.native.build`)",
                    d["ref_fallback_decoded"])
            # engine device-health gauges (refreshed each tick by the
            # batched readback) — the print_stats() cadence analogue;
            # the durable-ingest gauges (journal fsync lag = the RPO
            # bound, unsynced WAL bytes, throttle state) ride the same
            # line: one glance covers device AND disk pressure
            eng = {k: v for k, v in self.rt.stats.gauges.items()
                   if k.startswith(("engine_", "journal_",
                                    "throttle_state"))}
            # fused fold-path cadence: device dispatches + staging-slab
            # buffer flips + digest flushes this interval (the fold
            # half of the overlap win; gyt_fold_dispatches_total etc
            # ride /metrics from the same counters)
            for k in ("fold_dispatches", "stage_slab_flips",
                      "td_partial_flushes"):
                if d.get(k):
                    eng[k + "_delta"] = d[k]
            if eng:
                log.info("health %s", json.dumps(eng, default=str,
                                                 sort_keys=True))
            # NM query-edge cadence line: live node conns + per-verb
            # rates this interval (only when the edge is in use)
            nm = {k: v for k, v in d.items() if k.startswith("nm_")}
            if self.srv._nm_conns_live or nm:
                nm["conns_live"] = self.srv._nm_conns_live
                log.info("nm %s", json.dumps(nm, default=str,
                                             sort_keys=True))
            if self._hot:
                new = self._hot.poll()
                if new is not self.rt.opts:
                    self.rt.opts = new
                    log.info("hot-reloaded runtime knobs")

    async def shutdown(self) -> None:
        """Graceful stop: stop accepting, drain staged folds, final
        checkpoint recording the fsynced journal position, then drop
        the WAL segments that checkpoint supersedes (the SIGTERM path
        of the reference's init proc). A clean shutdown therefore
        leaves an EMPTY WAL window: the respawn replays zero chunks."""
        log.info("shutting down: draining staged slabs")
        if self.shipper is not None:
            # stop BEFORE the journal closes; the ship floor it
            # registered stays in force for the final truncation, so
            # a not-yet-landed segment survives this shutdown
            self.shipper.stop()
            if self._ship_thread is not None:
                self._ship_thread.join(timeout=10.0)
        if self._ship_loop is not None:
            # final staging pass so a clean stop leaves the shard store
            # current with everything already landed
            self._ship_loop.final_pass()
        if self.ship_recv is not None:
            await self.ship_recv.stop()
        if self.compactor is not None:
            # final pass BEFORE the journal closes: seal + compact the
            # shutdown window so a clean stop leaves history current
            try:
                self.compactor.compact_once(seal=True)
            except Exception:     # noqa: BLE001 — never block shutdown
                log.exception("final compaction pass failed")
            self.compactor.close()
        await self.srv.stop()          # closes rt (journal fsync+close)
        self.rt.flush()
        if self.rt.opts.checkpoint_dir:
            from gyeeta_tpu_torch.utils import checkpoint as ckpt
            from gyeeta_tpu_torch.utils import journal as J
            tick = self.rt._tick_no
            extra = J.checkpoint_extra(self.rt, tick)
            path = ckpt.save(
                f"{self.rt.opts.checkpoint_dir}/gyt_final_{tick:08d}.npz",
                self.rt.cfg, self.rt.state, extra=extra)
            J.post_checkpoint_truncate(self.rt, extra)
            log.info("final checkpoint: %s", path)
        log.info("bye")

    def handle_signal(self, sig: int) -> None:
        if sig == signal.SIGHUP:
            # hot-reload when a config file backs the knobs; a stray
            # HUP (logrotate, tty hangup) must never stop the server
            if self._hot:
                new = self._hot.poll()
                if new is not self.rt.opts:
                    self.rt.opts = new
                    log.info("SIGHUP: hot-reloaded runtime knobs")
            else:
                log.info("SIGHUP ignored (no --config)")
            return
        log.info("signal %d: stopping", sig)
        self.stop_event.set()


def checkpoint_candidates(ckpt_dir: Optional[str]) -> list:
    """Complete checkpoint files, newest first. Excludes the .tmp.npz
    a crash mid-``ckpt.save`` leaves behind (atomic-rename staging) —
    restoring one would crash-loop a supervised restart forever."""
    import pathlib
    if not ckpt_dir:
        return []
    d = pathlib.Path(ckpt_dir)
    if not d.is_dir():
        return []
    cands = [p for p in d.glob("gyt_*.npz")
             if not p.name.endswith(".tmp.npz")]
    return [str(p) for p in sorted(
        cands, key=lambda p: p.stat().st_mtime, reverse=True)]


def latest_checkpoint(ckpt_dir: Optional[str]):
    """Newest complete checkpoint file in the dir, or None."""
    cands = checkpoint_candidates(ckpt_dir)
    return cands[0] if cands else None


def _replay_wal(rt, extra: Optional[dict]) -> dict:
    """Recovery phase 2: re-fold write-ahead-journal chunks from the
    checkpoint's recorded position (``extra["wal"]``; a cold start
    replays the whole journal) through the normal decode/fold path.
    No-op without a journal. Returns the replay report."""
    if getattr(rt, "journal", None) is None:
        return {"chunks": 0, "records": 0}
    pos = (extra or {}).get("wal")
    rep = rt.replay_journal(tuple(pos) if pos else None)
    if rep["chunks"]:
        log.info("WAL replay: %d chunk(s) / %d record(s) re-folded "
                 "(from %s)", rep["chunks"], rep["records"],
                 "checkpoint position" if pos else "journal start")
    else:
        log.info("WAL replay: empty window (clean shutdown or no "
                 "post-checkpoint traffic)")
    return rep


def restore_latest_checkpoint(rt, ckpt_dir: Optional[str]):
    """The ``--restore-latest`` respawn path: walk checkpoints newest→
    oldest and restore the first usable one into ``rt``, then replay
    the write-ahead journal from that checkpoint's recorded position
    (when ``rt`` has one — the crash-window recovery that bounds data
    loss to the last fsync). A truncated / corrupt / cfg-mismatched
    newest file (torn by a crash mid-write) must NEVER crash-loop a
    supervised restart — it logs and falls through to the next-older
    candidate. Returns the restored path, or None (cold start; a cold
    start with a non-empty journal still replays it)."""
    for cand in checkpoint_candidates(ckpt_dir):
        try:
            extra = rt.restore(cand)
            log.info("restored checkpoint %s (tick %s)", cand,
                     extra.get("tick"))
            _replay_wal(rt, extra)
            return cand
        except Exception as e:  # noqa: BLE001 — corrupt / mismatched
            log.warning("checkpoint %s unusable (%s) — trying older",
                        cand, e)
    _replay_wal(rt, None)
    return None


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="gyeeta_tpu_torch serve",
        description="fleet observability aggregation server (PyTorch/"
        "CUDA port)")
    ap.add_argument("--device", default="cuda",
                    help="device of the runtime's state: cuda (default;"
                    " raises without a GPU) or cpu")
    ap.add_argument("--config", help="JSON config ({engine:…, runtime:…})")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=10038)
    ap.add_argument("--history-db",
                    help="history store: a sqlite path, or a "
                    "postgresql:// DSN for the durable Postgres tier "
                    "(needs psycopg in the image)")
    ap.add_argument("--checkpoint-dir")
    ap.add_argument("--restore", help="checkpoint .npz to restore")
    ap.add_argument("--restore-latest", action="store_true",
                    help="restore the newest checkpoint in "
                    "--checkpoint-dir when one exists (the respawn "
                    "path: a supervised restart resumes state)")
    ap.add_argument("--hostmap", help="machine-id→host-id placement file")
    ap.add_argument("--record", help="tee ingested wire bytes to this "
                    "capture file (GYTREC01, utils/replay.py)")
    ap.add_argument("--tick-interval", type=float, default=5.0)
    # fleet-scale sharded serving (OPERATIONS.md "Fleet-scale
    # deployment"): per-shard ingest loops + fused per-shard folds +
    # one collective roll-up per tick on an N-device mesh
    ap.add_argument("--shards", type=int, default=0,
                    help="run the sharded runtime over N shards on "
                    "--device (hosts hash to shards by sticky hid; "
                    "per-shard WAL subdirs under --journal-dir; 0/1 = "
                    "the single-device runtime)")
    ap.add_argument("--shard-queue-mb", type=float, default=8.0,
                    help="per-shard ingest queue byte bound before "
                    "counted oldest-first drops (--shards mode)")
    # multi-process ingest edge (net/ingestproc.py; OPERATIONS.md
    # "Multi-process deployment"): N worker processes own wire
    # validation + deframe/decode + per-shard WAL append off the fold
    # GIL and publish decoded slabs over shared-memory rings
    ap.add_argument("--ingest-procs", type=int, default=1,
                    help="ingest worker processes (sticky shard "
                    "groups; needs --shards >= N; 1 = the in-process "
                    "edge, zero behavior change)")
    ap.add_argument("--feed-pipeline", action="store_true",
                    help="deframe/decode on a worker thread (the "
                    "reference's L1/L2 split; useful on multi-core "
                    "hosts — the native decoders release the GIL)")
    ap.add_argument("--relay-port", type=int, default=None,
                    help="accept REMOTE ingest relay uplinks on this "
                    "port (net/relay.py: the shm-ring ledger over "
                    "TCP — published == consumed + counted drops "
                    "across machines; 0 = ephemeral)")
    ap.add_argument("--preagg", action="store_true",
                    help="advertise edge pre-aggregation to registering"
                    " agents (wire v5): they fold sketch deltas with "
                    "this server's geometry")
    ap.add_argument("--stats-interval", type=float, default=60.0)
    # conn-hardening deadlines (net/server.py; every reap lands on a
    # labeled gyt_conn_timeouts_total counter in /metrics)
    ap.add_argument("--handshake-timeout", type=float, default=10.0,
                    help="seconds a conn may take to complete "
                    "registration (slow-loris reap)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="seconds of silence before an established "
                    "conn is reaped (default: 12x tick interval, "
                    "min 30s; 0 disables)")
    ap.add_argument("--write-timeout", type=float, default=10.0,
                    help="seconds a control push may block on a "
                    "non-draining agent conn")
    ap.add_argument("--frame-error-budget", type=int, default=8,
                    help="recoverable frame-level errors per query "
                    "conn before it is closed")
    # snapshot-isolated query serving (query/snapshot.py, net/qexec.py;
    # OPERATIONS.md "Query serving"): live queries read the last
    # published per-tick engine view on a bounded off-loop worker pool
    ap.add_argument("--query-workers", type=int, default=None,
                    help="query worker-pool width (default 4)")
    ap.add_argument("--query-queue-max", type=int, default=None,
                    help="max in-flight queries before shedding with "
                    "a counted overload error (default 128)")
    ap.add_argument("--sub-persist",
                    help="append-only file persisting the streaming-"
                    "subscription version ring (net/subs.py): a "
                    "restarted server resumes reconnecting "
                    "subscribers with deltas instead of full resyncs "
                    "(single-replica deployments; gateways have "
                    "their own --sub-persist)")
    ap.add_argument("--query-strong", action="store_true",
                    help="serve every query inline with strong "
                    "consistency (the pre-snapshot behavior)")
    # durable-ingest tier: write-ahead journal + admission control
    # (utils/journal.py; OPERATIONS.md "Durability & recovery")
    ap.add_argument("--journal-dir",
                    help="write-ahead event journal directory: every "
                    "accepted event chunk is appended pre-fold and "
                    "replayed on --restore-latest, bounding data loss "
                    "to the last group fsync (unset = journaling off)")
    ap.add_argument("--journal-fsync-ms", type=float, default=None,
                    help="group-fsync time cadence in ms (the RPO "
                    "bound; default 50)")
    ap.add_argument("--journal-fsync-kb", type=int, default=None,
                    help="group-fsync byte cadence in KiB (default "
                    "1024; whichever cadence trips first syncs)")
    ap.add_argument("--journal-segment-mb", type=int, default=None,
                    help="journal segment rotation size in MiB "
                    "(default 64)")
    ap.add_argument("--throttle-hold-ms", type=int, default=1500,
                    help="admission control: how long a COMM_THROTTLE "
                    "tells agents to hold feeds in their spool when "
                    "ingest pressure trips (0 disables the controller)")
    ap.add_argument("--throttle-lag-s", type=float, default=0.75,
                    help="journal fsync lag that trips the trace-feed "
                    "throttle")
    ap.add_argument("--throttle-pending-mb", type=float, default=32.0,
                    help="unsynced WAL bytes that trip the trace-feed "
                    "throttle")
    ap.add_argument("--throttle-ring-frac", type=float, default=0.75,
                    help="ingest worker-ring occupancy fraction that "
                    "trips the trace-feed throttle (multi-process "
                    "ingest; >=0.95 holds every sweep — throttle "
                    "before the drop-oldest rings shed)")
    # time-travel history tier: WAL compaction → columnar snapshot
    # shards + at=/window= queries (OPERATIONS.md "History & time
    # travel"; GYT_HIST_* env knobs cover the rest)
    ap.add_argument("--shard-dir",
                    help="snapshot-shard directory: enables the "
                    "time-travel query tier; with --journal-dir a "
                    "compaction daemon rolls sealed WAL segments into "
                    "per-window columnar shards")
    ap.add_argument("--hist-window-ticks", type=int, default=None,
                    help="raw shard window in 5s ticks (default 12 = "
                    "1m time-travel resolution)")
    ap.add_argument("--compact-interval", type=float, default=None,
                    help="compaction daemon cadence in seconds "
                    "(default 30)")
    ap.add_argument("--compact-procs", type=int, default=0,
                    help="N>=1: distributed compaction — N replay "
                    "worker PROCESSES on --device over disjoint WAL "
                    "shard groups into a parted shard store (needs "
                    "--shards; N <= shard count). 0 (default) = the "
                    "in-process single-runtime compactor")
    # remote compaction region (history/shipper.py + net/segship.py):
    # sealed WAL segments ship content-hashed to a peer region's
    # staging dir, where the port's compactor replays them on the
    # region's device exactly as if local
    ap.add_argument("--ship-to", metavar="HOST:PORT",
                    help="ship this server's sealed WAL segments to a "
                    "remote compaction region's segment receiver "
                    "(needs --journal-dir; the ship truncate floor "
                    "pins unshipped segments against checkpoint "
                    "truncation)")
    ap.add_argument("--ship-id", default=None,
                    help="stable shipper identity for --ship-to "
                    "(provenance key; default ship-<hostname>)")
    ap.add_argument("--ship-staging",
                    help="run the COMPACTION-REGION side: accept "
                    "shipped segments into this staging dir (with "
                    "--ship-port) and/or compact it into --shard-dir "
                    "(with --compact-procs)")
    ap.add_argument("--ship-port", type=int, default=None,
                    help="listen port for shipper uplinks into "
                    "--ship-staging (0 = ephemeral; prints "
                    "SHIP_LISTEN host port)")
    ap.add_argument("--ship-listen-host", default="0.0.0.0")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the first "
                         "--profile-folds fold dispatches (CPU and, on a "
                         "GPU, CUDA activity) into this directory")
    ap.add_argument("--profile-folds", type=int, default=20,
                    help="fold dispatches the --profile-dir trace covers")
    ap.add_argument("--log-level", default="INFO")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    async def amain():
        d = Daemon(args, env=os.environ)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            loop.add_signal_handler(sig, d.handle_signal, sig)
        await d.run()

    asyncio.run(amain())


if __name__ == "__main__":
    main()
