#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: folds, kernels, Runtime.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``), builds the port's kernels
from ``gyeeta_tpu_torch/csrc`` into ``build/kernels/``, and fails
(non-zero exit, no result line) on a machine without a GPU or outside a
checkout of the repository. Phases:

1. Sim records → wire frames → ``decode_frames`` → ``conn_batch`` /
   ``resp_batch`` → ``(K, B)`` stacks on the card, at the bench's
   north-star geometry: ``EngineCfg(svc_capacity=131072, n_hosts=50048,
   task_capacity=65536)`` and ``ParthaSim(n_hosts=512, n_svcs=128,
   n_clients=8192, cli_groups_per_svc=4)`` — 65,536 live services.
2. Warm-up conn folds until every sim service is resident, then the main
   path: ``fold_many`` dispatches under the bench's flush policy (stage
   pressure read two dispatches back, ``td_flush_partial`` above
   ``td_stage_cap // 2``), ``td_flush``, ``tick_5s``, ``svc_snapshot``
   + ``svc_rows_to_host`` and ``flow_snapshot``. The kernels' launch
   counters are zeroed just before and read just after: each dispatch
   launches the fused ``hll_update`` twice and ``cms_update`` and
   ``inv_update`` once, and the generic kernel once, as the int32
   scatter-add of the t-digest stage counts (``add_drop``; no int32
   ``index_put_(accumulate=True)`` is left in a dispatch).
3. Checks on the result: live rows, ``n_conn``, ``n_resp_unknown``, each
   service's p50 against the exact median of what it was fed, the CMS
   total against the bytes fed, the global HLL against the distinct
   flows fed. Then where a dispatch's time goes: each half of
   ``fold_many`` timed alone, and torch.profiler over a few dispatches —
   device ops, the device's busy share, device time by kernel.
4. The same slice at the tiny test geometry on the card and on the CPU
   (plain versions), compared leaf by leaf; then (4b) the fold_all
   stream of ``tests/test_torch_fold_all.py`` — every sweep section and
   a conn/resp slab with split halves a dispatch, then the tick's
   classify / age / compact — card vs CPU over all 85 AggState and 29
   DepGraph leaves.
5. Each fused kernel against its plain version at the inputs one main
   path dispatch gave it (5a), then each generic scatter kernel at the
   lanes the plain hash chains give for the same inputs, and the int32
   scatter-add at that dispatch's stage counts (5b), each timed
   beside its plain version (and, for the generic kernels, the one
   PyTorch call computing the same function; for the fused HLL and CMS
   calls, the route they replaced: hash chain + generic kernel): device
   time from torch.profiler's CUDA events, and the host's issue rate
   from CUDA events around back-to-back calls.
7. ``fold_all`` at north-star geometry on a fresh state (dep capacities
   65,536 pairs / 524,288 edges, the runtime's section lanes): two
   ticks (a warm one, then the measured one), each 64 dispatches of a
   K=16 conn/resp slab (one conn lane in
   eight a split half) carrying that tick's sweep (65,536 listeners,
   4,096 process groups, 512 hosts' state and cpu/mem, pings, traces of
   256 services), then the tick's upkeep, each step timed. The kernels'
   launch counters are zeroed before and read after. Checks: live
   services, edges = the distinct (client, service) pairs fed,
   ``n_paired`` = the split flows fed, no drops, ``api_tbl.n_live`` =
   the (svc, api) keys fed, ``classify_pass`` on the card = the port's
   CPU run on the same state, the pressure scalar. Then ms per dispatch
   (connresp only, with sections), the synchronised dependency-fold
   share, host syncs a dispatch (CUDA sync debug mode, with their
   lines) and device ops and busy share under torch.profiler.
8. The port's ``Runtime`` at ns geometry through its entry points:
   ``feed`` of pre-generated frames (names; each tick's listener, task,
   host, cpu/mem and trace sweep; feed buffers of K·conn_batch conn —
   one lane in eight a split half — and K·resp_batch resp records), a
   warm-up tick, then two ticks of 16 buffers with ``run_tick`` between:
   ms per buffer and events/s with the ``Stats.timeit`` split (deframe,
   decode, fold dispatch), fold dispatches a buffer, ms per ``run_tick``
   with its synchronised parts, ``heavy_recover`` ms, host syncs of one
   buffer, one query per served subsystem plus three svcstate
   variants, each timed first and cached, and 20 rounds of a feed
   buffer followed by a svcstate query (its p50/p99). The launch counters are zeroed
   before the measured ticks: each dispatch that carries a conn/resp
   slab launches the fused kernels 2/1/1 times and the int32
   scatter-add once.
   Each sweep also carries the announce-rate records at full width
   (LISTENER_INFO for all 65,536 listeners, HOST_INFO and CGROUP_STATE
   for the 512 hosts, 4 MOUNT_STATE and 2 NETIF_STATE records a host,
   service flows dialled through a VIP); before the measured ticks,
   "op" requests install 8 realtime alertdefs (two sharing one
   canonical filter), a silence, an inhibit, a tracedef and a webhook
   action to a receiver on 127.0.0.1 in this process. It prints the
   registry updates' ms, the alert and drop-pressure steps' ms, the
   alerts fired, the webhook posts and ``ncq_group_evals``; checks
   ``stage_slab_flips`` = slab dispatches, fewer than 28 syncs a feed
   buffer and pinned staging columns; and serves the 23 subsystems of
   the registries and the alert tier live and from the snapshot, each
   timed first and cached. Checks: the event counters, 65,536 live
   services, 512 hosts, svcdependency rows = live edges, topk rows and
   recovered keys, the registry views' row counts. Then the tiny stream
   of ``tests/test_torch_runtime.py`` with registry records and the
   same defs through ``Runtime`` on the card and on the CPU: 85 + 29
   leaves, the tick reports (``alerts_fired``), the counters, the alert
   manager's stats, and the JSON of every request, the 23 new
   subsystems from the snapshot too (quantiles moved by CUDA's ``logf``
   may sit one loghist bucket apart, counted).
9. Edge pre-aggregation through the ``Runtime`` at ns geometry: one
   agent-side ``EdgeFold`` turns each tick's records (8 feed buffers'
   worth of plain conn and resp records, 16 before phase 17 came; 1 for
   the warm-up tick) into
   SKETCH_DELTA records on the host before any timer starts; a warm-up
   tick and a measured tick, each the raw 5 s state sweep and the delta
   records in ~1 MB buffers, then ``run_tick`` (which publishes the
   snapshot). The launch counters are zeroed before the measured tick:
   each
   delta dispatch launches ``cms_update`` and ``inv_update`` once, the
   generic kernel once as ``delta_merge`` (the loghist add and the
   per-service and global HLL maxes in one launch) and once as the
   int32 scatter-add of the stage counts, and no ``hll_update``. A
   second Runtime folds the same records raw, and the reference's
   delta-vs-raw bounds (tests/test_preagg.py) are held between the two.
   Then host syncs a delta dispatch, four delta dispatches under
   torch.profiler (device ops, busy µs, the top kernels, the launches
   of each kernel entry), each kernel of the delta section against its
   plain version on one delta dispatch's inputs (timed beside it and
   the library call; the merge also beside its sites as one launch
   each), a snapshot query per served
   subsystem (first and cached), ``selfstats``, ``metrics``, a 16-wide
   ``multiquery``, the snapshot's isolation from a later feed, and the
   tiny delta stream of ``tests/test_torch_delta_fold.py`` card vs CPU
   (tick reports, 85 + 29 leaves, counters, snapshot JSON).
10. History and the journal through the ``Runtime`` at ns geometry:
   phase 8's frames into a runtime with a write-ahead journal, snapshot
   shards (a tick a window), a sqlite history store and the history
   sweep every tick: a warm-up tick and a measured tick of 2 feed buffers
   (ms a buffer beside phase 8's, the journal's gauges, ``run_tick``
   with the sweep's render synchronised, ``history_rows``); a db-mode
   and a windowed alertdef through ``"op"``; a ``Compactor`` whose
   replay runtime re-folds the whole WAL on the card, with the launch
   counters zeroed before it (each replayed conn/resp slab launches the
   fused kernels 2/1/1 and the int32 scatter-add once),
   ``compact_replay_ev_per_sec``, ``compact_emit`` ms and shard bytes,
   and deflate at levels 6 and 1 over a sample of a shard's leaves.
   Checks: the newest shard's 85 + 29 leaves against the live state at
   its tick, on the card (integer and max-merged leaves exact, float
   sums rtol 1e-6); ``at=tick:2`` JSON of svcstate,
   topk, flowstate and svcdependency against the live JSON then (values
   read off float sums counted); ``window=`` and ``at=`` queries timed
   from a cold snapshot cache and again; ``tstart`` against sqlite's
   own count; the two alertdefs firing; peak memory with the replay
   runtime and two materialised snapshots. Then the stream of
   ``tests/test_torch_history.py`` card vs CPU: tick reports with
   ``history_rows``, shard leaves, the JSON of every ``at=``,
   ``window=`` and ``tstart`` request, and a checkpoint → ``restore``
   → ``replay_journal`` recovery against the uninterrupted run.
11. The serving edge at ns geometry: native against Python deframe
   plus conn/resp slab decode on phase 8's buffers (ms a buffer, outputs
   bit-equal); a ``GytServer`` on 127.0.0.1 over ``Runtime(ns cfg,
   device="cuda")`` with manual ticks: 8 registered GYT event conns send
   names, a sweep and two buffers (warm-up tick), then one tick (two
   before phase 15 came) of a sweep and phase 8's 16 feed buffers (ms a
   buffer and events/s
   wire→fold, synchronised, beside phase 8's direct feed); the launch
   counters are zeroed before these ticks and read after the tick-loop
   stretch below (``launches_serving``: 2/1/1 and the int32 add 1 a
   conn/resp dispatch); a
   ``svcstate`` subscription pushed after each tick; a stock partha
   (PS_REGISTER → PM_CONNECT → NOTIFY frames built from the port's
   ``REF_*_DT``: ``ref_native_decoded`` > 0, ``ref_fallback_decoded``
   0); the 43 served subsystems over ``QueryClient`` and 8 each over NM
   and ``WebGateway`` HTTP, each answer equal to ``rt.query`` on the
   same snapshot and across edges (p50/p99 ms per edge, first call and
   cached); 3.5 s under the server's own tick loop at 1 s (``run_tick``
   ms); peak memory; a ``feed_pipeline=True`` server over 16 buffers;
   the tiny stream over TCP into a card server and a CPU server (equal
   reports, JSON under the third-decimal rule).
12. The rest of the serving edges at ns geometry. 12a, right after
   phase 10, on its WAL and shards: the remote compaction region — the
   WAL's segments (all sealed) ship with ``SegmentShipper`` over
   127.0.0.1 to a ``SegmentReceiver`` (hash-verified atomic landing, the
   JSONL ledger), and the daemon's ``_StagingCompactLoop`` on the card
   compacts the staging dir into a fresh shard dir, the receiver's
   staging sweep fed its floors; ship MB/s, landed → compacted s, the
   region's replay records/s and ``compact_emit`` ms; the launch
   counters zeroed before it (``launches_region``: 2/1/1 a replayed
   conn/resp dispatch, the int32 add 1, generic 0 else). Checks:
   sealed == shipped + dropped
   with no hash mismatch, the landed segments equal the source's, the
   region's two shards equal phase 10's (integer and max leaves exact,
   float sums rtol 1e-6), and ``at=tick:2`` svcstate and topk JSON from
   the region's store equal phase 10's from the local one. 12b, inside
   phase 11 before its server closes: a ``FabricGateway`` in front of
   phase 11's ``GytServer`` and a second
   one over the same ``Runtime`` (no tick loop of its own): the 43
   subsystems over its GYT front and 8 each over REST and NM, each equal
   to ``rt.query`` on the snapshot (first and ≥ 100 cached calls: p50,
   p99, max); 32 concurrent identical svcstate requests on a fresh tick
   → one upstream render; an SSE push after a tick, reassembled equal to
   the new snapshot's answer; the second replica's listener shut: every
   query answers, its breaker opens at the third failure.
13. The sharded runtime (``parallel/shardedrt.py``), four shards on the
   card. 13a: ``tests/test_shardedrt.py``'s stream (16 hosts × 3
   services, three ticks) with split halves, traces, registry records
   and two agents' SKETCH_DELTA sweeps, on the card and on the CPU:
   tick reports, the 4 × (85 + 29) leaves, the ``FleetView`` (rollup,
   merged edges, health) and the JSON of the 44 subsystems (shardlist
   included) strong and from the snapshot; a 2×2 mesh's rollup against
   the 1-D mesh's. 13b: phase 8's frames (names, a sweep and 16 feed
   buffers a tick, a warm-up and one measured tick; two before phase
   15 came) through a 4-shard
   ``ShardedRuntime`` whose shards hold ns ÷ 4 (``svc_capacity=32768``,
   ``task_capacity=16384``): ms a feed buffer beside phase 8's, the
   launch counters (8 / 4 / 4 a sharded dispatch), ms of
   ``fold_step_dep_sharded`` and of its pairing dispatch, halves routed
   and dropped, ``run_tick`` and its parts (the fleet rollup among
   them), host syncs over the buffers of one slab, one SKETCH_DELTA
   buffer (two before phase 17), queries first and cached, peak memory;
   then a single
   ``Runtime`` at ns fed the same frames: svcstate, hoststate,
   taskstate and clusterstate equal row for row, svcdependency the same
   edges with each edge short only by the pairs the single runtime made
   and it did not (halves of one flow that met in one sharded dispatch
   make one pair), flowstate's heaviest flow
   equal. 13c: ``serve --shards 4`` (the daemon in this process, on the
   card) over 127.0.0.1: two GYT conns feed 4,096 services, the tick
   loop runs 3.5 s at 1 s, ``shardlist`` and ``svcstate`` answer over
   GYT, ``--journal-dir`` holds ``shard_00/``–``shard_03/``, one
   compaction of that WAL on the card (a window of 2 ticks; a window a
   tick before phase 17) writes shards an ``at=`` query reads.
14. The sharded tier's worker processes, four on the card. 14a: 13b's
   frames to its tick 2 as a per-shard WAL (each buffer's records split
   by ``host_id % 4`` into ``shard_00/``–``shard_03/``, the names to
   every shard), compacted by ``ParallelCompactor`` with 4 and with 2
   spawned replay workers, each a CUDA context on the card: records/s,
   each part's wall and CPU s, ``compact_emit`` ms and peak device
   memory, the workers' launch counts (``launches_part_slab``: 2/1/1 and
   the int32 add 1 a replayed conn/resp dispatch); the two passes'
   parts held to each other (integer and max leaves exact, float sums
   rtol 1e-6, the root windows equal), ``at=tick:2`` svcstate over the
   parted store against
   13b's live runtime at tick 2 row for row, ``compact list`` on the
   parted root. 14b: ``serve --shards 4 --ingest-procs 4`` (the daemon
   in this process, manual ticks) over 127.0.0.1: one GYT conn a worker
   sends 13b's frames a buffer at a time, each drained through the
   shared-memory rings before the next (ms a buffer wire → fold beside
   13b's), ``run_tick`` and its parts, the launch counters
   (``launches_ring_slab``: 8/4/4 a ring-drained dispatch), ring
   backlog, drops and the ledger; svcstate, hoststate, taskstate and
   clusterstate equal 13b's runtime at its last tick (2) row for row,
   svcdependency on the same edges, apart in one direction by the pairs
   one run made and the other did not; a worker SIGKILLed mid-stream respawns onto its shard
   group, its agent reconnects to the same host id, and the ledger
   stays exact. 14c: a ``relay`` process on 127.0.0.1 uplinks into
   ``serve --shards 4 --relay-port``; two agents register through it
   and send 13c-width frames (4,096 services): the hub's ledger exact
   with no gap, the four state views equal an in-process sharded
   runtime fed the same frames; the relay is SIGKILLed and restarted
   twice, each restart's epoch finalised with its loss counted.
15. The port's agent tier into ``serve`` on the card (it bought its time
   back from 13b and 14b, one measured sharded tick each instead of
   two). 15a: ``serve`` in this process (manual ticks, ``--record`` a
   capture) at a madhava's geometry (``n_hosts=1024``,
   ``svc_capacity=4096``, ``task_capacity=8192``);
   four child processes
   of ``python -m gyeeta_tpu_torch agent --n-agents 128`` (512 sim
   agents at the agent's defaults: 4 services, 6 task groups, 256 conns
   and 512 response samples a sweep, 5 s apart) and one ``agent
   --collect --real`` measuring this host; three sweeps each, then
   SIGTERM, each child's exit report read: registrations, sweeps folded
   by sequence mark, ms of the tick, launches (2/1/1 a conn/resp
   dispatch, the int32 add 1, generic 0 else), peak memory; the fused
   calls of the fleet's
   first two conn/resp dispatches held against their plain versions on
   the CPU at this geometry; the server's conn and resp counts
   equal the agents' sweeps and the capture; 512 sim hosts in
   hoststate, 2,048 live services; the real host's hostinfo names this
   host, its listeners include serve's port, cpumem (and cgroupstate
   where the cgroup fs is there) carry it, a taskstate group holds the
   agents' processes; a collector the kernel refuses is named. 15b: a
   second ``serve`` fed the capture by ``replay``: it prints the
   capture's size; svcstate, hoststate, taskstate and clusterstate of
   the sim hosts equal the live server's row for row. 15c: ``chaos
   --faults corrupt,truncate,disconnect --seed 3`` between 32 agents
   (1 s sweeps, a spool smaller than two sweeps) and the first server:
   the server stays up and counts frame errors, every agent reconnects
   under its first host id, the reconnect, resend and drop counters
   reach the server, each agent's ledger adds up. 15d: ``nm probe
   --crud``, ``obs top --once``, ``obs metrics``. 15e: four of the
   port's agents with fixed seeds, two sweeps each, into a card and a
   CPU ``GytServer``: tick reports and JSON equal.
16. The request-trace capture into ``serve`` on the card at phase 15's
   geometry (``--record``, manual ticks; it bought its time back from
   phases 10, 12a and 14: one measured history tick with a window a
   tick, and shard leaves whose CRC-32 agree counted exact without
   inflating them). 16a: six loopback services in a child process
   (``chip_smoke.py --trace-services``: HTTP/1.1 with keep-alive,
   pipelining and a chunked body, Postgres simple and extended queries,
   MongoDB OP_MSG, h2c HTTP/2 with Huffman-coded HPACK and gRPC
   trailers, TDS language, RPC and DBRPC requests, a TLS ClientHello
   with SNI and ALPN; one transaction in 16 errs) and ``agent --collect
   --real --livecap``; a tracedef on their ports goes out through
   ``push_trace_control`` and the next sweep opens the capture; 16
   conns of 32 transactions a service, in 8 client rounds each right
   after a sweep; tracereq holds every signature, and nreq and nerr by
   protocol equal what the clients completed and the services erred;
   the listeners' svcstate rows carry the bridged nqry5s and sererr;
   deleting the tracedef closes the capture (the agent's exit report).
   A host that refuses AF_PACKET is reported, with the agent's
   ``_cap_denied``. 16b: a pcap written with ``write_pcap`` of 256
   services (64 of phase 15's sim host ids × 4, the five
   transaction-bearing protocols round-robin, one TLS conn a host), 256
   transactions a conn with lognormal latencies, one in 32 an error;
   ``parse_pcap`` recovers what was written, by protocol;
   ``transactions_to_records`` a service, sent over 64 registered GYT
   conns in two sweeps; api_tbl.n_live rises by 1,536; per (service,
   api) key nreq, nerr and bytes equal ``sketch/exact.key_totals`` and
   p95 lies within one loghist bucket of ``exact.quantiles``; the
   phase's conn/resp dispatches launch 2/1/1, the int32 add 1, generic
   0 else. Last the
   ``--record`` capture replayed into a CPU ``GytServer``: tracereq
   JSON equal to the card's.
17. The sharded tier's history and the mergeable sketches on the card
   (run after phase 14). 17a: a ``ShardedRuntime`` of 4 shards at ns ÷
   4 a shard with a per-shard journal, fed phase 8's names and 8 feed
   buffers a tick for 2 ticks, then a ``Compactor`` whose
   ``runtime_factory`` builds a 4-shard ``ShardedRuntime`` on the card
   replays that WAL into one window: the stacked ``(4, ...)`` shard
   against the live mesh at tick 2 (leaves whose CRC-32 agree with the
   live leaves' ``.npy`` bytes exact without inflating them; the rest
   integer and max exact, f32 sums rtol 1e-6), ``at=tick:2`` svcstate
   on the mesh equal to live row for row; replay records/s,
   ``compact_emit`` ms, the shard's bytes, peak memory and the launches
   a replayed sharded slab (8 / 4 / 4, the int32 add 4). 17b: every
   sketch update and merge of the port's mergeable API on the card
   against the CPU (HLL, CMS, invertible, top-K, windows exact; loghist
   exact but for samples CUDA's ``logf`` moves a bucket; t-digest
   counts exact, a centroid's weight moved only to its neighbour,
   quantiles within the reference's bounds of the exact ones). 17c:
   ``FoldProfiler`` over 4 fold dispatches of a ``Runtime`` at ns ÷ 4: the
   Chrome trace holds 4 ``gyt_fold`` ranges, each kernel entry's range
   (``gyt_hll_update`` 8, ``gyt_inv_update``, ``gyt_cms_update`` and
   ``gyt_scatter_sites`` 4) and its device kernel.
6. Fold rate and device ops a dispatch, memory, the card's name and
   power limit, the JSON lines (fold, fold_all, runtime, delta,
   history, serving, region, sharded, workers, agents, trace,
   sharded_history, kernels), each phase's seconds and the total, and
   last the result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import socket
import struct
import subprocess
import sys
import time
import zlib
from collections import deque
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

DEV = "cuda"
NS_CFG = dict(svc_capacity=131072, n_hosts=50048, task_capacity=65536)
NS_SIM = dict(n_hosts=512, n_svcs=128, n_clients=8192, cli_groups_per_svc=4)
K = 16                 # microbatches per fold_many dispatch
N_DISTINCT = 16        # distinct staged slabs cycled by the main path:
#                        about 16 resp samples per service in all
N_DISPATCH = 64        # main-path fold_many dispatches
MAX_WARMUP = 64        # conn-only warm-up folds before giving up
REPS = 100             # launches per kernel timing
# calls per timing of a fused kernel's plain version and of the route it
# replaced: hundreds of device ops a call, whose profiler trace takes
# seconds to read back at REPS
PLAIN_REPS = 20
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

INT32_OPS_PER_S = 16.7e12   # 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper
#                             white paper): the hash arithmetic's type

# the fused kernels of the main path and the Pallas kernel each replaces;
# each sketch module counts its launches in `launches`
FUSED_SOURCE = "gyeeta_tpu_torch/csrc/sketch_update.cu"
FUSED = {
    "hll_update": "gyeeta_tpu/sketch/pallas_scatter.py:81",
    "cms_update": "gyeeta_tpu/sketch/pallas_scatter.py:99",
    "inv_update": "gyeeta_tpu/sketch/pallas_scatter.py:81",
}
# the generic scatter kernel's entries, one a route into its one kernel,
# gyt_scatter_sites (scatter.launches counts each route): single-site max
# and f32 add, function for function the Pallas calls, launched on no
# path since the delta section merges its three sites in one launch
# (delta_merge, phase 9); the int32 add of the t-digest stage counts
# (add_drop), once a conn/resp or delta dispatch
GENERIC_SOURCE = "gyeeta_tpu_torch/csrc/scatter.cu"
GENERIC = {
    "scatter_max": "gyeeta_tpu/sketch/pallas_scatter.py:81",
    "scatter_add": "gyeeta_tpu/sketch/pallas_scatter.py:99",
    "add_drop": "gyeeta_tpu/sketch/pallas_scatter.py:99",
    "delta_merge": "gyeeta_tpu/sketch/pallas_scatter.py:81",
}
# (fused kernel, module, function, target shape at ns geometry, dtype,
# generic kernel its lanes feed) in the order ingest_conn calls them
NS_CALLS = (
    ("hll_update", "hyperloglog", "update_entities", (131072, 1024), "int32",
     "scatter_max"),
    ("hll_update", "hyperloglog", "update", (16384,), "int32", "scatter_max"),
    ("cms_update", "countmin", "update", (2, 131072), "float32",
     "scatter_add"),
    ("inv_update", "invertible", "write_candidates", (2, 4096), "float32",
     "scatter_max"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


class Fed:
    """Host-side record of everything folded, for the phase 3 checks."""

    def __init__(self):
        self.conn_lanes = 0
        self.conn_bytes = 0.0
        self.flows = []
        self.resp = []          # (glob id, value, times folded)

    def conn(self, cb, times=1):
        """A conn batch folded ``times`` times (its flows counted once)."""
        ok = cb.valid & cb.is_accept
        self.conn_lanes += int(cb.valid.sum()) * times
        self.conn_bytes += float(
            (cb.bytes_sent[ok].astype(np.float64)
             + cb.bytes_rcvd[ok].astype(np.float64)).sum()) * times
        v = cb.valid
        self.flows.append((cb.flow_hi[v].astype(np.uint64) << np.uint64(32))
                          | cb.flow_lo[v].astype(np.uint64))

    def resp_slab(self, rb, times):
        v = rb.valid
        gid = (rb.svc_hi[v].astype(np.uint64) << np.uint64(32)) \
            | rb.svc_lo[v].astype(np.uint64)
        self.resp.append((gid, rb.resp_us[v], times))


def concat(batches):
    return type(batches[0])(*(np.concatenate(c) for c in zip(*batches)))


def ns_phase(torch, scatter):
    from gyeeta_tpu_torch.engine import aggstate, step
    from gyeeta_tpu_torch.ingest import decode, wire
    from gyeeta_tpu_torch.query import readback
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import countmin, hyperloglog as hll, loghist

    cfg = aggstate.EngineCfg(**NS_CFG)
    sim = ParthaSim(**NS_SIM)
    n_svcs = sim.n_hosts * sim.n_svcs
    fed = Fed()

    def slab(kind):
        """K microbatches of one stream: sim → wire → decode."""
        if kind == "conn":
            buf = sim.conn_frames(K * cfg.conn_batch)
            sub, build, size = wire.NOTIFY_TCP_CONN, decode.conn_batch, \
                cfg.conn_batch
        else:
            buf = sim.resp_frames(K * cfg.resp_batch)
            sub, build, size = wire.NOTIFY_RESP_SAMPLE, decode.resp_batch, \
                cfg.resp_batch
        frames, used = wire.decode_frames(buf)
        recs = np.concatenate([r for s, r in frames if s == sub])
        if used != len(buf) or len(recs) != K * size:
            raise AssertionError(f"{kind} frames did not decode whole")
        return [build(recs[i * size:(i + 1) * size], size) for i in range(K)]

    log("phase 1+2: north-star geometry "
        f"(S={cfg.svc_capacity}, {n_svcs} sim services, K={K})")
    t0 = time.perf_counter()
    st = aggstate.init(cfg, DEV)
    torch.cuda.synchronize()
    state_bytes = sum(x.numel() * x.element_size()
                      for x in _leaves(st))
    log(f"  state: {state_bytes / 2**30:.3f} GiB in "
        f"{time.perf_counter() - t0:.2f}s")

    # warm-up: conn-only folds until every sim service is resident, so
    # the main path runs the all-hit upsert and no resp sample is unknown
    t0 = time.perf_counter()
    n_warm = 0
    while int(st.tbl.n_live) < n_svcs:
        if n_warm == MAX_WARMUP:
            raise AssertionError(f"{int(st.tbl.n_live)} of {n_svcs} services "
                                 f"resident after {n_warm} warm-up folds")
        cb = concat(slab("conn"))
        fed.conn(cb)
        st = step.ingest_conn(cfg, st, decode.to_device(cb, DEV))
        n_warm += 1
    torch.cuda.synchronize()
    log(f"  warm-up: {n_warm} conn folds of {K * cfg.conn_batch} lanes, "
        f"{int(st.tbl.n_live)} services resident, "
        f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    host_slabs = [(slab("conn"), slab("resp")) for _ in range(N_DISTINCT)]
    host_s = time.perf_counter() - t0
    slabs = [(decode.to_device(c, DEV), decode.to_device(r, DEV))
             for c, r in host_slabs]
    torch.cuda.synchronize()
    log(f"  staged {N_DISTINCT} slabs (sim+wire+decode {host_s:.2f}s, "
        f"{N_DISTINCT * K * (cfg.conn_batch + cfg.resp_batch)} events)")

    # one dispatch that records each fused call's inputs (phase 5 holds
    # each kernel against its plain version at exactly these shapes)
    captured = []
    mods = sketch_modules()
    originals = {(m, f): getattr(mods[m], f) for _, m, f, *_ in NS_CALLS}

    def recorder(mod, fn_name, fn):
        def rec(sk, *args, **kw):
            captured.append((mod, fn_name, _clone(sk), _clone(args),
                             _clone(kw)))
            return fn(sk, *args, **kw)
        return rec

    # ... and the int32 scatter-add of its t-digest stage counts
    stage = []
    add = scatter.scatter_add

    def rec_add(target, *args, **kw):
        stage.append((_clone(target), _clone(args),
                      _clone({k: v for k, v in kw.items() if k != "route"})))
        return add(target, *args, **kw)

    for (m, f), fn in originals.items():
        setattr(mods[m], f, recorder(m, f, fn))
    scatter.scatter_add = rec_add
    box = [st]
    try:
        puts = accumulate_puts(torch, lambda: box.__setitem__(
            0, step.fold_many(cfg, box[0], *slabs[0])))
        st = box[0]
    finally:
        for (m, f), fn in originals.items():
            setattr(mods[m], f, fn)
        scatter.scatter_add = add
    uses = [1] + [0] * (N_DISTINCT - 1)
    got = [(m, f, tuple(sk[0].shape), str(sk[0].dtype).split(".")[1])
           for m, f, sk, _, _ in captured]
    check(got == [(m, f, s_, d) for _, m, f, s_, d, _ in NS_CALLS],
          f"one dispatch calls {[f'{m}.{f}' for _, m, f, *_ in NS_CALLS]} "
          f"at {[c[3] for c in NS_CALLS]}")
    check(len(stage) == 1 and stage[0][0].dtype == torch.int32,
          "... and the int32 scatter-add once (add_drop of the t-digest "
          f"stage counts, {stage[0][1][0].numel()} lanes)")
    check("int32" not in puts, "no int32 index_put_(accumulate=True) in a "
          f"conn/resp dispatch (by dtype: {puts})")

    # ---- the main path, counted
    reset_launches(scatter, mods)
    pressures: deque = deque()
    n_flush = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_DISPATCH):
        if len(pressures) >= 2 and \
                int(pressures.popleft()) > cfg.td_stage_cap // 2:
            st = step.td_flush_partial(cfg, st)
            n_flush += 1
        st = step.fold_many(cfg, st, *slabs[i % N_DISTINCT])
        uses[i % N_DISTINCT] += 1
        pressures.append(step.stage_pressure(st))
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    st = step.td_flush(cfg, st)
    st = step.tick_5s(cfg, st)
    snap = readback.svc_snapshot(cfg, st, 0)
    rows = readback.svc_rows_to_host(cfg, snap)
    flow = {k: v.cpu().numpy()
            for k, v in readback.flow_snapshot(cfg, st, 64).items()}
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t1
    launches = read_launches(scatter, mods)
    ev = K * (cfg.conn_batch + cfg.resp_batch)
    perf = {"dispatches": N_DISPATCH, "events_per_dispatch": ev,
            "fold_s": fold_s, "ms_per_dispatch": fold_s / N_DISPATCH * 1e3,
            "events_per_s": N_DISPATCH * ev / fold_s,
            "n_partial_flushes": n_flush, "flush_tick_readback_s": tail_s,
            "warmup_folds": n_warm, "state_gib": state_bytes / 2**30}
    log(f"  main path: {N_DISPATCH} fold_many dispatches in {fold_s:.3f}s "
        f"({perf['ms_per_dispatch']:.3f} ms/dispatch, "
        f"{perf['events_per_s']:.0f} events/s, {n_flush} partial flushes); "
        f"td_flush+tick+readback {tail_s:.2f}s")
    log(f"  kernel launches on the main path: {launches}")
    check(launches == path_launches(N_DISPATCH),
          "every dispatch launched hll_update 2x, cms_update 1x, "
          "inv_update 1x and the int32 scatter-add of the stage counts "
          "1x, and no other generic scatter kernel")

    for (c, r), n in zip(host_slabs, uses):
        fed.conn(concat(c), times=n)
        fed.resp_slab(concat(r), n)

    log("phase 3: checks at north-star geometry")
    live = snap["live"].cpu().numpy()
    check(int(st.tbl.n_live) == n_svcs == int(live.sum()) == len(rows),
          f"live rows = {n_svcs}")
    check(int(st.n_conn) == fed.conn_lanes,
          f"n_conn = conn lanes fed ({fed.conn_lanes})")
    check(float(st.n_resp_unknown) == 0.0, "n_resp_unknown = 0")
    cols = [k for k in rows[0] if k != "glob_id"]
    check(all(math.isfinite(r[k]) and r[k] >= 0 for r in rows for k in cols),
          f"{len(cols)} snapshot columns finite and >= 0 on every live row")
    for k in ("bytes_sent", "distinct_clients"):
        check(all(r[k] > 0 for r in rows), f"{k} > 0 on every live row")
    p50_off, n_fed, n_moved = _p50_vs_fed(torch, loghist, cfg, fed, rows)
    check(p50_off <= 1, f"each of the {n_fed} services fed resp samples has "
          "its resp_p50_us within one loghist bucket of the exact median "
          f"of its samples (max offset {p50_off}); the other "
          f"{len(rows) - n_fed} read 0")
    log(f"  resp samples whose loghist bucket differs between CUDA and "
        f"CPU logf: {n_moved}")
    total = float(countmin.total(st.cms))
    check(math.isclose(total, fed.conn_bytes, rel_tol=1e-6),
          f"countmin.total {total:.6e} = accept-side bytes fed "
          f"{fed.conn_bytes:.6e} (rtol 1e-6)")
    distinct = len(np.unique(np.concatenate(fed.flows)))
    est = float(hll.estimate(st.glob_hll))
    sigma = 1.04 / math.sqrt(st.glob_hll.regs.numel()) * distinct
    check(abs(est - distinct) <= 3 * sigma,
          f"global HLL {est:.0f} within 3 std errors of {distinct} "
          "distinct flows fed")
    fb = flow["flow_bytes"]
    check(bool(np.isfinite(fb).all() and (fb[:-1] >= fb[1:]).all()
               and fb[0] > 0),
          "flow_snapshot: heaviest flows finite and count-descending")
    check(flow["total_bytes"] == np.float32(total),
          "flow_snapshot total_bytes = countmin.total")
    perf["distinct_flows_fed"] = distinct
    perf["max_memory_allocated_gib"] = \
        torch.cuda.max_memory_allocated() / 2**30
    perf["p50_moved_samples"] = n_moved
    # after the checks: these dispatches fold more data
    st, perf["profile"] = profile_dispatches(torch, cfg, st, step, slabs)
    return st, captured, stage[0], launches, perf


def _leaves(st):
    from gyeeta_tpu_torch.utils.tensor import tree_leaves
    return tree_leaves(st)


def sketch_modules():
    from gyeeta_tpu_torch.sketch import countmin, hyperloglog, invertible
    return {"hyperloglog": hyperloglog, "countmin": countmin,
            "invertible": invertible}


def reset_launches(scatter, mods) -> None:
    scatter.reset_counts()
    for mod in mods.values():
        mod.launches = 0


def read_launches(scatter, mods) -> dict:
    return {"hll_update": mods["hyperloglog"].launches,
            "cms_update": mods["countmin"].launches,
            "inv_update": mods["invertible"].launches,
            **scatter.launch_counts()}


def path_launches(connresp: int, delta: int = 0) -> dict:
    """The launches of ``connresp`` conn/resp dispatches and ``delta``
    delta-only dispatches: a conn/resp dispatch launches the fused
    hll_update 2x, cms_update and inv_update 1x, and the int32
    scatter-add of the t-digest stage counts (``add_drop``) 1x; a delta
    dispatch cms_update and inv_update 1x, the one-launch merge of its
    loghist add and two HLL maxes (``delta_merge``) 1x and the int32
    add 1x. The single-site generic wrappers launch on no path."""
    return {"hll_update": 2 * connresp, "cms_update": connresp + delta,
            "inv_update": connresp + delta, "scatter_max": 0,
            "scatter_add": 0, "add_drop": connresp + delta,
            "delta_merge": delta}


def _clone(x):
    """A copy of a tensor, or of a tuple / list / dict of them."""
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_clone(v) for v in x)
    return x.clone() if hasattr(x, "clone") else x


def _p50_vs_fed(torch, loghist, cfg, fed, rows):
    """→ (max |bucket offset| between each fed service's device p50 and
    the bucket of the exact weighted median of its samples — the sample
    at which the cumulative count first reaches half the total, the
    loghist's own rule — with buckets by the CPU formula; the number of
    services fed; the count of fed samples whose bucket CUDA's logf
    moves). A service fed nothing must read p50 = 0."""
    spec = cfg.resp_spec
    gid = np.concatenate([g for g, _, _ in fed.resp])
    val = np.concatenate([v for _, v, _ in fed.resp])
    w = np.concatenate([np.full(len(g), n, np.int64) for g, _, n in fed.resp])
    keep = w > 0
    gid, val, w = gid[keep], val[keep], w[keep]
    tv = torch.from_numpy(val)
    b_cpu = loghist.bucket_of(spec, tv).numpy()
    b_gpu = loghist.bucket_of(spec, tv.to(DEV)).cpu().numpy()
    n_moved = int((b_cpu != b_gpu).sum())
    order = np.lexsort((b_cpu, gid))
    g_s, b_s, w_s = gid[order], b_cpu[order], w[order]
    starts = np.flatnonzero(np.r_[True, g_s[1:] != g_s[:-1]])
    cum = np.cumsum(w_s)
    before = np.r_[0, cum[:-1]][starts]
    tot = np.add.reduceat(w_s, starts)
    pos = np.searchsorted(cum, before + 0.5 * tot - 1e-6, side="left")
    want = dict(zip(g_s[starts].tolist(), b_s[pos].tolist()))
    got = {r["glob_id"]: r["resp_p50_us"] for r in rows}
    if not set(want) <= set(got):
        raise AssertionError("resp samples fed for a service not live")
    if any(p != 0.0 for g, p in got.items() if g not in want):
        raise AssertionError("a service fed no resp sample reads p50 != 0")
    gids = list(want)
    got_b = loghist.bucket_of(
        spec, torch.tensor([got[g] for g in gids])).numpy()
    off = max(abs(int(b) - want[g]) for g, b in zip(gids, got_b))
    return int(off), len(gids), n_moved


def device_us(torch, prof):
    """Device time (µs) of a profile: the sum of its CUDA events (kernels,
    memcpys, memsets), each counted once."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda)


def accumulate_puts(torch, fn) -> dict:
    """→ the ``index_put_(accumulate=True)`` calls ``fn`` makes, by target
    dtype: on CUDA each is a sort and then ``indexing_backward_kernel``,
    which adds the duplicates of one index serially."""
    from torch.overrides import TorchFunctionMode

    seen: dict = {}

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.Tensor.index_put_ and (
                    kwargs.get("accumulate") or len(args) > 3 and args[3]):
                k = str(args[0].dtype).split(".")[1]
                seen[k] = seen.get(k, 0) + 1
            return func(*args, **kwargs)

    with Count():
        fn()
    return seen


def profile_dispatches(torch, cfg, st, step, slabs, n=4):
    """Where a dispatch's time goes → (state, summary): the wall time of
    each half of ``fold_many`` (synchronised), then torch.profiler over
    ``n`` plain dispatches — device busy share and device time by kernel.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    # spread of the plain dispatch time: three more windows of 16
    windows = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(16):
            st = step.fold_many(cfg, st, *slabs[i % len(slabs)])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 16 * 1e3)
    halves = {"ingest_conn": 0.0, "ingest_resp_bulk": 0.0}
    for i in range(n):
        cbs, rbs = slabs[i % len(slabs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = step.ingest_conn(cfg, st, step.flatten(cbs))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = step.ingest_resp_bulk(cfg, st, rbs)
        torch.cuda.synchronize()
        halves["ingest_conn"] += (t1 - t0) * 1e3 / n
        halves["ingest_resp_bulk"] += (time.perf_counter() - t1) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            st = step.fold_many(cfg, st, *slabs[i % len(slabs)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = device_us(torch, prof)
    n_dev = sum(1 for e in prof.events() if e.device_type == cuda)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cuda),
                  reverse=True)
    log(f"  profile: ms/dispatch in three more windows of 16: "
        f"{', '.join(f'{w:.3f}' for w in windows)}")
    log(f"  profile: halves (synchronised) ingest_conn "
        f"{halves['ingest_conn']:.3f} ms, ingest_resp_bulk "
        f"{halves['ingest_resp_bulk']:.3f} ms; {n} dispatches under the "
        f"profiler: wall {wall_us / n / 1e3:.3f} ms/dispatch, device busy "
        f"{busy_us / n / 1e3:.3f} ms/dispatch ({busy_us / wall_us:.1%}), "
        f"{n_dev / n:.0f} device ops/dispatch")
    for dev_us, count, key in rows[:20]:
        log(f"    {dev_us / n:9.1f} us/dispatch  {count / n:6.1f} calls  "
            f"{key[:100]}")
    return st, {"window_ms_per_dispatch": windows, "halves_ms": halves,
                "wall_ms_per_dispatch": wall_us / n / 1e3,
                "device_busy_ms_per_dispatch": busy_us / n / 1e3,
                "device_busy_share": busy_us / wall_us,
                "device_ops_per_dispatch": n_dev / n}


# ----------------------------------------------------------- phase 4
def tiny_cfg(aggstate, loghist):
    """``__graft_entry__._tiny_cfg()``, the tests' geometry."""
    return aggstate.EngineCfg(
        svc_capacity=64, n_hosts=16,
        resp_spec=loghist.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64),
        hll_p_svc=6, hll_p_global=8, cms_depth=2, cms_width=1 << 10,
        topk_capacity=32, td_capacity=16,
        conn_batch=64, resp_batch=64, listener_batch=64)


def tiny_run(device):
    """fold_step, 3 fold_many dispatches of K=4, td_flush_partial,
    td_flush, tick_5s → (leaves, resp values fed)."""
    from gyeeta_tpu_torch.engine import aggstate, step
    from gyeeta_tpu_torch.ingest import decode
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import loghist

    cfg = tiny_cfg(aggstate, loghist)
    sim = ParthaSim(n_hosts=cfg.n_hosts, n_svcs=4, n_clients=256)
    resp = []

    def pair():
        cb = decode.conn_batch(sim.conn_records(cfg.conn_batch),
                               cfg.conn_batch)
        rb = decode.resp_batch(sim.resp_records(cfg.resp_batch),
                               cfg.resp_batch)
        resp.append(rb.resp_us[rb.valid])
        return cb, rb

    st = aggstate.init(cfg, device)
    cb, rb = pair()
    st = step.fold_step(cfg, st, decode.to_device(cb, device),
                        decode.to_device(rb, device))
    for _ in range(3):
        bs = [pair() for _ in range(4)]
        st = step.fold_many(cfg, st,
                            decode.to_device([c for c, _ in bs], device),
                            decode.to_device([r for _, r in bs], device))
    st = step.td_flush_partial(cfg, st)
    st = step.td_flush(cfg, st)
    st = step.tick_5s(cfg, st)
    return aggstate.state_to_numpy(st), np.concatenate(resp), cfg


TINY_DEP = (64, 256)        # pair chunks of 16 lanes
TINY_K, TINY_B = 3, 40      # 120 conn lanes: 7 chunks + a remainder


def tiny_fold_all_run(device):
    """The fold_all stream of tests/test_torch_fold_all.py: four ticks,
    each one dispatch of every sweep section + a conn/resp slab with
    split halves (some partnered a tick later, some never), then
    td_flush → classify_pass → tick_5s → depgraph.age → age_tasks /
    age_apis → delete_services (tick 1) → compact_state / compact_tasks
    → (state leaves, dep leaves, {spec name: loghist inputs fed}, cfg)."""
    import torch
    from gyeeta_tpu_torch.engine import aggstate, compact, step
    from gyeeta_tpu_torch.ingest import decode, wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.semantic import derive
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import loghist

    cfg = tiny_cfg(aggstate, loghist)._replace(
        n_hosts=8, task_capacity=128, api_capacity=256)
    sim = ParthaSim(n_hosts=8, n_svcs=4, n_clients=256)
    st = aggstate.init(cfg, device)
    dep = depgraph.init(*TINY_DEP, device)
    fed = {k: [] for k in ("resp_spec", "apiresp_spec", "qps_spec",
                           "active_spec", "taskcpu_spec")}
    dev = lambda b: decode.to_device(b, device)  # noqa: E731
    late = None
    for tick in range(4):
        tasks = sim.aggr_task_records()
        tasks = tasks[:8] if tick == 2 else tasks
        pings = np.zeros(8, wire.TASK_PING_DT)
        pings["aggr_task_id"] = tasks["aggr_task_id"][-8:]
        pings["host_id"] = tasks["host_id"][-8:]
        lb = decode.listener_batch(sim.listener_state_records(), 48)
        tb = decode.task_batch(tasks, 80)
        secs = dict(
            listener=lb,
            host=decode.host_batch(sim.host_state_records(), 16),
            task=tb,
            cpumem=decode.cpumem_batch(sim.cpu_mem_records(
                hot_cpu=[tick % 8], hot_mem=[(tick + 3) % 8]), 16),
            trace=decode.trace_batch(sim.trace_records(80), 96),
            ping=decode.ping_batch(pings, 16))
        fed["qps_spec"].append(lb.stats[lb.valid, decode.STAT_NQRYS] / 5.0)
        fed["active_spec"].append(
            lb.stats[lb.valid, decode.STAT_NCONNS_ACTIVE])
        fed["taskcpu_spec"].append(tb.stats[tb.valid, decode.TASK_CPU_PCT])
        fed["apiresp_spec"].append(
            secs["trace"].resp_us[secs["trace"].valid])
        cbs, rbs = [], []
        for k in range(TINY_K):
            cli, ser = sim.svc_conn_records(8, split_halves=True)
            parts = [sim.conn_records(12), sim.svc_conn_records(4), cli]
            if k < TINY_K - 1:
                parts.append(ser)
            elif tick % 2 == 0:
                late = ser
            if k == 0 and late is not None and tick % 2 == 1:
                parts.append(late)
            cbs.append(decode.conn_batch(np.concatenate(parts), TINY_B))
            rbs.append(decode.resp_batch(sim.resp_records(TINY_B), TINY_B))
            fed["resp_spec"].append(rbs[-1].resp_us[rbs[-1].valid])
        st, dep, _ = step.fold_all(
            cfg, st, dep, tick, connresp=(dev(cbs), dev(rbs)),
            **{k: dev(v) for k, v in secs.items()})
        st = step.td_flush(cfg, st)
        st = derive.classify_pass(cfg, st)
        st = step.tick_5s(cfg, st)
        dep = depgraph.age(dep, tick, 1, 2)
        st = step.age_tasks(cfg, st, 1)
        st = step.age_apis(cfg, st, 2)
        if tick == 1:
            gid = sim.glob_ids[0, :2]
            st, _ = compact.delete_services(
                cfg, st,
                torch.from_numpy((gid >> np.uint64(32)).astype(np.int64))
                .to(device),
                torch.from_numpy((gid & np.uint64(0xFFFFFFFF))
                                 .astype(np.int64)).to(device))
        st = compact.compact_state(cfg, st)
        st = step.compact_tasks(cfg, st)
    return (aggstate.state_to_numpy(st), depgraph.dep_to_numpy(dep),
            {k: np.concatenate(v).astype(np.float32)
             for k, v in fed.items()}, cfg)


# loghist leaves of each spec: a sample whose bucket CUDA's logf moves is
# one count in a neighbouring bucket there
HIST_LEAVES = {"resp_spec": "resp_win.", "apiresp_spec": "api_resp_hist",
               "qps_spec": "qps_hist", "active_spec": "active_hist",
               "taskcpu_spec": "task_cpu_hist"}


def _moved(torch, loghist, spec, values) -> int:
    tv = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return int((loghist.bucket_of(spec, tv).numpy()
                != loghist.bucket_of(spec, tv.to(DEV)).cpu().numpy()).sum())


def _compare_leaves(names, cpu, gpu, moved: dict) -> tuple:
    """Card vs CPU, leaf by leaf → (n exact, n within tolerance)."""
    n_exact = n_close = 0
    for name, a, b in zip(names, cpu, gpu):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        n_moved = sum(n for spec, n in moved.items()
                      if name.startswith(HIST_LEAVES[spec]))
        if a.dtype.kind == "f" and n_moved:
            if np.abs(a - b).sum() > 2 * n_moved:
                raise AssertionError(f"{name}: differs beyond {n_moved} "
                                     "moved samples")
            n_close += 1
        elif a.dtype.kind != "f" or name in ("inv.prio", "svc_td.vmin",
                                             "svc_td.vmax", "h_bytes"):
            np.testing.assert_array_equal(b, a, err_msg=name)
            n_exact += 1
        else:
            # f32 sums: atomics add in no fixed order (rtol 1e-6, the
            # reference's own bar); digest centroids rtol 1e-5
            rtol = 1e-5 if name.startswith("svc_td.") else 1e-6
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=name)
            n_close += 1
    return n_exact, n_close


def tiny_phase(torch):
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    log("phase 4: tiny geometry, card vs CPU (plain versions)")
    gpu, resp, cfg = tiny_run(DEV)
    cpu, _, _ = tiny_run("cpu")
    moved = _moved(torch, loghist, cfg.resp_spec, resp)
    log(f"  resp samples whose bucket CUDA's logf moves: {moved}")
    names = tree_paths(aggstate.init(cfg, "meta"))
    n_exact, n_close = _compare_leaves(names, cpu, gpu,
                                       {"resp_spec": moved})
    check(len(names) == len(cpu) == 85,
          f"85 leaves agree ({n_exact} exactly, {n_close} within "
          "tolerance)")

    log("phase 4b: the fold_all stream and ticks at tiny geometry, card "
        "vs CPU")
    g_st, g_dep, fed, cfg = tiny_fold_all_run(DEV)
    c_st, c_dep, _, _ = tiny_fold_all_run("cpu")
    moved = {k: _moved(torch, loghist, getattr(cfg, k), v)
             for k, v in fed.items()}
    log(f"  loghist inputs whose bucket CUDA's logf moves: {moved}")
    n_exact, n_close = _compare_leaves(names, c_st, g_st, moved)
    check(len(c_st) == len(g_st) == 85,
          f"AggState: 85 leaves agree ({n_exact} exactly, {n_close} within "
          "tolerance)")
    dnames = tree_paths(depgraph.init(1, 1, "meta"))
    n_exact, n_close = _compare_leaves(dnames, c_dep, g_dep, {})
    check(len(c_dep) == len(g_dep) == 29,
          f"DepGraph: 29 leaves agree ({n_exact} exactly, {n_close} within "
          "tolerance)")
    at = dict(zip(names, g_st))
    check(len(np.unique(at["svc_state"])) >= 3
          and float(dict(zip(dnames, g_dep))["n_paired"]) > 0,
          "the stream classified services into 3+ states and paired halves")


# ----------------------------------------------------------- phase 5
def timed(torch, fn, reps=REPS):
    """→ (device ms, issue ms) per call of ``fn``: the device time of its
    CUDA work under torch.profiler, and CUDA events around ``reps``
    back-to-back calls (bound by the host's launch rate when the device
    work is short)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window whose CUDA events the profiler lost
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_ms = device_us(torch, prof) / reps / 1e3
        if dev_ms > 0:
            break
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    issue_ms = a.elapsed_time(b) / reps
    if dev_ms <= 0:
        # the profiler lost every window's CUDA events: the device time
        # is read from CUDA events around the calls instead (an upper
        # bound: launch gaps included)
        log("  torch.profiler recorded no device time in 3 windows; "
            "device time from CUDA events")
        dev_ms = issue_ms
    return dev_ms, issue_ms


def _bound(nbytes: float, ops: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_bytes": nbytes,
            "bound_ops": ops,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# integer operations a lane (a row, for inv) the fused kernels need: mix64
# is two fmix32 (5 ops each, two of them multiplies) and 4 more; the HLL
# adds index, shift, clz, min and the flat address (7); the CMS hashes two
# streams and per row adds a multiply-add, a high multiply and an address
# (3); inv hashes its bucket stream and range-maps (16), compares twice
# (2), and each winner hashes its fingerprint and two masks (24)
MIX64_OPS = 14


def generic_lanes(torch, mods, mod, fn, target, args, kw):
    """A fused call's plain hash chain → the ``(idx, val)`` lanes the
    generic scatter kernel took for it before the fusion, and the lane
    mask of those that change the target."""
    m = mods[mod]
    if mod == "hyperloglog":
        row = args[0] if fn == "update_entities" else None
        hi, lo = args[-2:] if fn == "update_entities" else args[:2]
        valid = kw.get("valid")
        idx, val = m.lanes(target, row, hi, lo, valid)
    elif mod == "countmin":
        valid = kw.get("valid")
        idx, val = m.lanes(target, *args, **kw)
    else:
        hi, lo, prio, valid = args
        _, idx, val = m.lanes(target, hi, lo, torch.where(valid, prio, 0.0))
    keep = torch.ones_like(idx, dtype=torch.bool) if valid is None \
        else valid.repeat(idx.numel() // valid.numel())
    return idx, val, keep


def fused_bound(torch, mods, mod, fn, sk, args, kw, after) -> dict:
    """The least time of a fused call from the bytes it must move (each
    lane column read once at its dtype, each register / bucket its valid
    lanes touch read and written once, each won bucket's key and
    fingerprint written) and its integer operations, at this call's
    data."""
    idx, _, keep = generic_lanes(torch, mods, mod, fn, sk[0], args, kw)
    touched = int(torch.unique(idx[keep]).numel())
    n = args[-1].numel()
    lane_bytes = sum(t.element_size() for t in (*args, *kw.values())
                     if t is not None)
    if mod == "hyperloglog":
        return _bound(n * lane_bytes + 8 * touched,
                      n * (MIX64_OPS + 7)) | {"touched": touched}
    if mod == "countmin":
        d = sk.counts.shape[0]
        return _bound(n * lane_bytes + 8 * touched,
                      n * (2 * MIX64_OPS + 1 + 3 * d)) | {"touched": touched}
    d = sk.prio.shape[0]
    won = int((after.prio > sk.prio).sum())
    return _bound(n * lane_bytes + 8 * touched + 24 * won,
                  d * n * (MIX64_OPS + 4) + won * (MIX64_OPS + 10)) \
        | {"touched": touched, "won": won}


def _same_sketch(torch, kind, got, want) -> float:
    """Hold a fused kernel's state against its plain version's → the
    largest absolute difference (HLL, inv: exact; CMS: rtol 1e-6)."""
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        rtol = 1e-6 if kind == "cms_update" else 0
        torch.testing.assert_close(a, b, rtol=rtol, atol=0,
                                   msg=lambda m: f"{kind} {name}: {m}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def fused_call(torch, scatter, kind, mod, fn, generic, sk, args, kw):
    """One fused call held against its plain version on the same inputs
    and timed beside it (and, for hll and cms, beside the route it
    replaced: the plain hash chain, then the generic scatter kernel) →
    its entry in the kernels line."""
    mods = sketch_modules()
    m = mods[mod]
    kernel, plain = getattr(m, fn), getattr(m, fn + "_plain")
    got, want = _clone(sk), _clone(sk)
    kernel(got, *args, **kw)
    plain(want, *args, **kw)
    torch.cuda.synchronize()
    err = _same_sketch(torch, kind, got, want)
    work = _clone(sk)
    ms, issue_ms = timed(torch, lambda: kernel(work, *args, **kw))
    plain_ms, plain_issue_ms = timed(
        torch, lambda: plain(work, *args, **kw), PLAIN_REPS)
    chain_ms = None
    if mod != "invertible":
        gen = getattr(scatter, generic)
        chain_ms, _ = timed(torch, lambda: gen(work[0], *generic_lanes(
            torch, mods, mod, fn, work[0], args, kw)[:2]), PLAIN_REPS)
    c = {"site": f"{mod}.{fn}", "target": list(sk[0].shape),
         "dtype": str(sk[0].dtype).split(".")[1],
         "lanes": args[-1].numel(),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "issue_ms": issue_ms, "plain_issue_ms": plain_issue_ms,
         "chain_ms": chain_ms}
    c |= fused_bound(torch, mods, mod, fn, sk, args, kw, want)
    log(f"  {kind} @ {c['site']} {c['target']} {c['dtype']}, "
        f"{c['lanes']} lanes: device kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, unfused route (hash chain + generic "
        f"kernel) {'-' if chain_ms is None else f'{chain_ms * 1e3:.2f}'}"
        f" us, bound {c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}, "
        f"{c['bound_bytes']} B); issue rate {issue_ms * 1e3:.1f} / "
        f"{plain_issue_ms * 1e3:.1f} us per call; max_abs_err {err}")
    return c


def fused_phase(torch, scatter, captured, launches):
    log("phase 5a: each fused kernel vs its plain version at the main "
        "path's inputs (hll, inv: exact; cms: rtol 1e-6)")
    calls = {k: [] for k in FUSED}
    for (kind, mod, fn, _, _, generic), (_, _, sk, args, kw) in zip(
            NS_CALLS, captured):
        calls[kind].append(fused_call(torch, scatter, kind, mod, fn,
                                      generic, sk, args, kw))
    return [_entry(kind, FUSED_SOURCE, FUSED[kind], launches[kind], cs,
                   library=False) for kind, cs in calls.items()]


def _entry(kind, source, replaces, launches, cs, library) -> dict:
    """A kernel's line of the kernels JSON: per-dispatch totals over its
    call sites."""
    return {
        "name": kind, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cs),
        "ms": sum(c["ms"] for c in cs),
        "plain_ms": sum(c["plain_ms"] for c in cs),
        "bound_ms": sum(c["bound_ms"] for c in cs),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in cs)
        else "operations",
        "library_ms": sum(c["library_ms"] for c in cs) if library else None,
        "calls": cs}


def _wrapper(scatter, kind):
    """A generic kernel's wrapper and plain version by its entry name."""
    op = "scatter_max" if kind == "scatter_max" else "scatter_add"
    return getattr(scatter, op), getattr(scatter, op + "_plain")


def _site_lanes(torch, scatter, site):
    """A site's lanes as the library call takes them, masked outside any
    timing: (flat int64 index, value; dropped lanes at 0 with the op's
    identity), the kept lanes' distinct targets, and the lane bytes the
    function must read at this data: every lane's mask (its keep, or its
    row where there is no keep), the row of each lane its keep lets
    through, and the value and column of each kept lane."""
    op, target, row, val, keep, col, stride = site
    ok = row >= 0 if keep is None else keep & (row >= 0)
    flat = row.to(torch.int64) * stride + (0 if col is None else col)
    ident = scatter.identity(op, val.dtype)
    v = torch.where(ok, val, torch.full((), ident, dtype=val.dtype,
                                        device=val.device))
    n_ok = int(ok.sum())
    read = row.numel() * row.element_size() if keep is None else \
        keep.numel() * keep.element_size() \
        + int(keep.sum()) * row.element_size()
    read += n_ok * (val.element_size()
                    + (0 if col is None else col.element_size()))
    return torch.where(ok, flat, 0), v, \
        int(torch.unique(flat[ok]).numel()), read


def _library(torch, site, idx64, v):
    """The one PyTorch call computing a site's function on pre-masked
    lanes (the yardstick; the port never calls it)."""
    flat = site.target.clone().view(-1)
    if site.op == "max":
        return lambda: flat.scatter_reduce_(0, idx64, v, "amax",
                                            include_self=True)
    return lambda: flat.index_add_(0, idx64, v)


def _rtol(site) -> float:
    """max and int32 add: exact in any order; f32 add: rtol 1e-6 (atomics
    and the warp's shuffle sum add in no fixed order)."""
    return 1e-6 if site.op == "add" and site.target.is_floating_point() \
        else 0


def generic_call(torch, scatter, kind, site, target, idx, val, keep=None,
                 col=None, stride=1):
    """One generic scatter call held against its plain version (max,
    int32 add: exact; f32 add: rtol 1e-6) and timed beside it and beside
    the one PyTorch call computing the same function → its entry."""
    wrapper, plain = _wrapper(scatter, kind)
    kw = dict(keep=keep, col=col, stride=stride)
    s_ = scatter.Site("max" if kind == "scatter_max" else "add", target,
                      idx, val, keep, col, stride)
    got = wrapper(target.clone(), idx, val, **kw)
    want = plain(target.clone(), idx, val, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=_rtol(s_), atol=0)
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    idx64, v, distinct, lane_bytes = _site_lanes(torch, scatter, s_)
    lib = _library(torch, s_, idx64, v)
    work = target.clone()
    ms, issue_ms = timed(torch, lambda: wrapper(work, idx, val, **kw))
    plain_ms, plain_issue_ms = timed(torch,
                                     lambda: plain(work, idx, val, **kw))
    library_ms, library_issue_ms = timed(torch, lib)
    n = idx.numel()
    c = {"site": site, "target": list(target.shape),
         "dtype": str(target.dtype).split(".")[1], "lanes": n,
         "kept": int(((idx >= 0) if keep is None
                      else keep & (idx >= 0)).sum()),
         "distinct_targets": distinct, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "library_ms": library_ms,
         "issue_ms": issue_ms, "plain_issue_ms": plain_issue_ms,
         "library_issue_ms": library_issue_ms}
    # the lanes' needed columns read once; each kept target read and
    # written once
    c |= _bound(lane_bytes + 2 * target.element_size() * distinct, n)
    log(f"  {kind} @ {site} {c['target']} {c['dtype']}, {n} lanes "
        f"({c['kept']} kept), {distinct} targets: device kernel "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, library "
        f"{library_ms * 1e3:.2f} us, bound {c['bound_ms'] * 1e3:.3f} us "
        f"({c['bound_by']}); issue rate {issue_ms * 1e3:.1f} / "
        f"{plain_issue_ms * 1e3:.1f} / {library_issue_ms * 1e3:.1f} us per "
        f"call; max_abs_err {err}")
    return c


def sites_call(torch, scatter, site, sites):
    """The one-launch merge of ``sites`` held against its plain version
    (each site: max, int32 add exact; f32 add rtol 1e-6), timed beside
    it, beside the same sites as one single-site launch each, and beside
    one library call a site (summed: no one PyTorch call merges them) →
    its entry."""
    got = [s._replace(target=s.target.clone()) for s in sites]
    want = [s._replace(target=s.target.clone()) for s in sites]
    scatter.scatter_sites(got, route="delta_merge")
    scatter.scatter_sites_plain(want)
    torch.cuda.synchronize()
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.target, w.target, rtol=_rtol(g),
                                   atol=0, msg=lambda m: f"site {k}: {m}")
        err = max(err, float((g.target.double()
                              - w.target.double()).abs().max()))
    work = [s._replace(target=s.target.clone()) for s in sites]
    lanes = [_site_lanes(torch, scatter, s) for s in work]
    libs = [_library(torch, s, i, v) for s, (i, v, _, _) in zip(work, lanes)]

    def singles():
        for s in work:
            _wrapper(scatter, "scatter_max" if s.op == "max"
                     else "scatter_add")[0](s.target, s.row, s.val,
                                            keep=s.keep, col=s.col,
                                            stride=s.stride)

    ms, issue_ms = timed(torch, lambda: scatter.scatter_sites(
        work, route="delta_merge"))
    plain_ms, plain_issue_ms = timed(
        torch, lambda: scatter.scatter_sites_plain(work))
    single_ms, single_issue_ms = timed(torch, singles)
    library_ms, library_issue_ms = timed(torch, lambda: [f() for f in libs])
    n = sum(s.row.numel() for s in sites)
    nbytes = sum(lb + 2 * s.target.element_size() * d
                 for s, (_, _, d, lb) in zip(sites, lanes))
    c = {"site": site, "sites": [
            {"op": s.op, "target": list(s.target.shape),
             "dtype": str(s.target.dtype).split(".")[1],
             "lanes": s.row.numel(),
             "kept": int(((s.row >= 0) if s.keep is None
                          else s.keep & (s.row >= 0)).sum()),
             "distinct_targets": d}
            for s, (_, _, d, _) in zip(sites, lanes)],
         "lanes": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "single_launches_ms": single_ms, "library_ms": library_ms,
         "issue_ms": issue_ms, "plain_issue_ms": plain_issue_ms,
         "single_launches_issue_ms": single_issue_ms,
         "library_issue_ms": library_issue_ms}
    c |= _bound(nbytes, n)
    log(f"  delta_merge @ {site}: {len(sites)} sites, {n} lanes, "
        f"{[x['kept'] for x in c['sites']]} kept, "
        f"{[x['distinct_targets'] for x in c['sites']]} targets: one "
        f"launch {ms * 1e3:.2f} us, the same sites as {len(sites)} "
        f"launches {single_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
        f"us, library ({len(sites)} calls) {library_ms * 1e3:.2f} us, "
        f"bound {c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}); issue "
        f"rate {issue_ms * 1e3:.1f} / {single_issue_ms * 1e3:.1f} / "
        f"{plain_issue_ms * 1e3:.1f} / {library_issue_ms * 1e3:.1f} us "
        f"per call; max_abs_err {err}")
    return c


def generic_phase(torch, scatter, captured, stage, launches):
    log("phase 5b: each generic scatter kernel vs its plain version at the "
        "lanes the fused calls' hash chains give and, for the int32 add, "
        "at one dispatch's t-digest stage counts (max, int32 add: exact; "
        "f32 add: rtol 1e-6)")
    mods = sketch_modules()
    calls = {k: [] for k in GENERIC}
    for (_, mod, fn, _, _, kind), (_, _, sk, args, kw) in zip(NS_CALLS,
                                                             captured):
        idx, val, _ = generic_lanes(torch, mods, mod, fn, sk[0], args, kw)
        calls[kind].append(generic_call(torch, scatter, kind, f"{mod}.{fn}",
                                        sk[0], idx, val))
    target, args, kw = stage
    calls["add_drop"].append(generic_call(
        torch, scatter, "add_drop", "tdigest.stage_samples:add_drop",
        target, *args, **kw))
    return [_entry(kind, GENERIC_SOURCE, GENERIC[kind], launches[kind], cs,
                   library=True) for kind, cs in calls.items() if cs]


# ----------------------------------------------------------- phase 7
NS_DEP = (65536, 524288)    # bench.py:_geometry("ns") pair/edge capacity
# section lanes of the runtime's fused slab (runtime.py:_slab_lanes)
NS_LANES = dict(listener=1024, host=4096, task=2400, cpumem=4096,
                trace=4096, ping=2048)
# a warm tick and a measured one, no more, to keep the script inside its
# time limit; each tick's 64 dispatches cycle every distinct slab
NS_TICKS = 2
TICK_DISPATCHES = 64        # 65,536 listeners at 1,024 lanes a dispatch
SPLIT_FLOWS = 128           # split flows a microbatch: 256 of its 2,048
#                             conn lanes are halves (one in eight)
TRACE_SVCS = 256            # services with tracing on: 1,280 (svc, api)
TRACE_DRAWS = 3800 * 256    # trace records drawn a tick (~3,800 kept)
# the runtime's defaults (gyeeta_tpu/utils/config.py)
PAIR_TTL, EDGE_TTL, TASK_AGE, API_AGE = 24, 720, 36, 360
SYNC_SITES = ("gyeeta_tpu_torch",)


def _u64(hi, lo):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _edges_of(cb):
    """The (client entity, service) edges a conn batch's two-sided lanes
    fold (halves_from_conn's rule), as a set of 128-bit int pairs."""
    rel = (cb.cli_rel_hi | cb.cli_rel_lo) != 0
    cli = np.where(rel, _u64(cb.cli_rel_hi, cb.cli_rel_lo),
                   _u64(cb.cli_task_hi, cb.cli_task_lo))
    svc = _u64(cb.svc_hi, cb.svc_lo)
    ok = cb.valid & (cli != 0) & (svc != 0)
    return set(zip(cli[ok].tolist(), svc[ok].tolist()))


def split_slab(sim, cfg, decode, wire):
    """K conn microbatches (7 in 8 lanes plain flows, 1 in 8 split
    halves) + K resp microbatches. Each split flow's client half lands
    in microbatch k and its server half in k+K/2 (mod K): the other
    pairing chunk, before or after it. Flow keys of the split flows are
    unique within the slab (a repeated key is dropped with both its
    halves), so every flow fed pairs exactly once a dispatch → (conns,
    resps, n split flows, their (caller, callee) edges)."""
    seen, edges = set(), set()
    cli_parts = [[] for _ in range(K)]
    ser_parts = [[] for _ in range(K)]
    for k in range(K):
        cli, ser = sim.svc_conn_records(SPLIT_FLOWS, split_halves=True)
        cb = decode.conn_batch(cli, len(cli))
        keep = []
        for key in _u64(cb.flow_hi, cb.flow_lo).tolist():
            keep.append(key not in seen)
            seen.add(key)
        keep = np.asarray(keep)
        cli_parts[k].append(cli[keep])
        ser_parts[(k + K // 2) % K].append(ser[keep])
        edges |= set(zip(cli["cli_related_listen_id"][keep].tolist(),
                         ser["ser_glob_id"][keep].tolist()))
    n_plain = cfg.conn_batch - 2 * SPLIT_FLOWS
    conns, resps = [], []
    for k in range(K):
        recs = np.concatenate([sim.conn_records(n_plain)] + cli_parts[k]
                              + ser_parts[k])
        buf = wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN, recs)
        frames, _ = wire.decode_frames(buf)
        conns.append(decode.conn_batch(
            np.concatenate([r for _, r in frames]), cfg.conn_batch))
        frames, _ = wire.decode_frames(sim.resp_frames(cfg.resp_batch))
        resps.append(decode.resp_batch(frames[0][1], cfg.resp_batch))
    return conns, resps, len(seen), edges


def sweep_batches(sim, decode, wire, trace_svcs):
    """One tick's sweep: every listener, process group, host (state and
    cpu/mem), keepalive pings for every group, and the traced services'
    transactions → {section: [batches]}."""
    def recs(buf, sub):
        frames, used = wire.decode_frames(buf)
        if used != len(buf):
            raise AssertionError("sweep frames did not decode whole")
        return np.concatenate([r for s_, r in frames if s_ == sub])

    def split(r, build, lanes):
        return [build(r[i:i + lanes], lanes) for i in range(0, len(r), lanes)]

    lst = recs(sim.listener_frames(), wire.NOTIFY_LISTENER_STATE)
    tasks = recs(sim.task_frames(), wire.NOTIFY_AGGR_TASK_STATE)
    pings = np.zeros(len(tasks), wire.TASK_PING_DT)
    pings["aggr_task_id"] = tasks["aggr_task_id"]
    pings["host_id"] = tasks["host_id"]
    return {
        "listener": split(lst, decode.listener_batch, NS_LANES["listener"]),
        "task": split(tasks, decode.task_batch, NS_LANES["task"]),
        "host": split(recs(wire.encode_frames_chunked(
            wire.NOTIFY_HOST_STATE, sim.host_state_records()),
            wire.NOTIFY_HOST_STATE), decode.host_batch, NS_LANES["host"]),
        "cpumem": split(recs(wire.encode_frames_chunked(
            wire.NOTIFY_CPU_MEM_STATE, sim.cpu_mem_records()),
            wire.NOTIFY_CPU_MEM_STATE), decode.cpumem_batch,
            NS_LANES["cpumem"]),
        "trace": split(recs(sim.trace_frames(TRACE_DRAWS,
                                             only_svcs=trace_svcs),
                            wire.NOTIFY_REQ_TRACE), decode.trace_batch,
                       NS_LANES["trace"]),
        "ping": split(recs(wire.encode_frames_chunked(
            wire.NOTIFY_TASK_PING, pings), wire.NOTIFY_TASK_PING),
            decode.ping_batch, NS_LANES["ping"]),
    }


def _spread(sweep) -> list:
    """A tick's sweep batches → TICK_DISPATCHES section dicts: listener
    batch i rides dispatch i, the other sections' batches the dispatches
    after the listeners' first (one each)."""
    out = [{"listener": b} for b in sweep["listener"]]
    if len(out) != TICK_DISPATCHES:
        raise AssertionError(f"{len(out)} listener batches a tick")
    i = 1
    for name in ("task", "host", "cpumem", "trace", "ping"):
        for b in sweep[name]:
            out[i][name] = b
            i += 1
    return out


def _edge_diff(torch, depgraph, dep, edges_fed) -> tuple:
    """Live edges against the pairs fed → (fed but not live, live but
    not fed, how many of the former have every probe slot held by a
    live key: a key the table cannot place, counted in its n_drop)."""
    tbl = depgraph.table
    live_t = tbl.live_mask(dep.edge_tbl).cpu()
    live = live_t.numpy()
    col = lambda x: x.cpu().numpy()[live]  # noqa: E731
    got = set(zip(_u64(col(dep.e_cli_hi), col(dep.e_cli_lo)).tolist(),
                  _u64(col(dep.e_ser_hi), col(dep.e_ser_lo)).tolist()))
    missing, extra = edges_fed - got, got - edges_fed
    exhausted = 0
    if missing:
        cs = np.array(sorted(missing), np.uint64)
        halves = [torch.from_numpy((x >> np.uint64(32)).astype(np.int64))
                  for x in (cs[:, 0], cs[:, 1])]
        halves += [torch.from_numpy((x & np.uint64(0xFFFFFFFF))
                                    .astype(np.int64))
                   for x in (cs[:, 0], cs[:, 1])]
        khi, klo = depgraph.edge_key(halves[0], halves[2], halves[1],
                                     halves[3])
        slots = tbl._probe_slots(khi, klo, live.shape[0])
        exhausted = int(live_t[slots].all(dim=1).sum())
        log(f"  edges fed but not live: {len(missing)} (e.g. "
            f"{sorted(missing)[:2]}), {exhausted} of them with all "
            f"{tbl.PROBES} probe slots held by live keys")
    return missing, extra, exhausted


def count_syncs(torch, fn) -> list:
    """Run ``fn`` under CUDA sync debugging → the (file:line) of each
    device→host synchronisation it made in the port's code (the deepest
    frame of the port on the stack; one with none is listed by the
    warning's own location)."""
    import traceback
    import warnings

    sites = []
    orig = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack()
                 if any(k in f.filename for k in SYNC_SITES)]
        f = stack[-1] if stack else None
        sites.append(f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
                     if f else f"{filename}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = show
        try:
            fn()
        finally:
            warnings.showwarning = orig
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def fold_all_phase(torch, scatter):
    """fold_all at north-star geometry on a fresh state: NS_TICKS ticks
    of TICK_DISPATCHES dispatches, each a conn/resp K-slab with split
    halves plus that dispatch's share of the tick's sweep, then the
    tick's upkeep; checks, then where the time goes."""
    from gyeeta_tpu_torch.engine import aggstate, compact, step
    from gyeeta_tpu_torch.ingest import decode, wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.semantic import derive
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.utils.tensor import tree_map

    cfg = aggstate.EngineCfg(**NS_CFG)
    sim = ParthaSim(**NS_SIM, seed=7)
    n_svcs = sim.n_hosts * sim.n_svcs
    log(f"phase 7: fold_all at north-star geometry, dep {NS_DEP}, "
        f"{NS_TICKS} ticks of {TICK_DISPATCHES} dispatches (K={K}, one "
        f"conn lane in {cfg.conn_batch // (2 * SPLIT_FLOWS)} a split half)")
    t0 = time.perf_counter()
    staged, n_split, edges_fed = [], [], set()
    for _ in range(N_DISTINCT):
        conns, resps, n, edges = split_slab(sim, cfg, decode, wire)
        for cb in conns:
            edges |= _edges_of(cb)
        edges_fed |= edges
        n_split.append(n)
        staged.append((decode.to_device(conns, DEV),
                       decode.to_device(resps, DEV)))
    trace_svcs = list(sim.glob_ids.reshape(-1)[::n_svcs // TRACE_SVCS])
    sweeps, api_keys = [], set()
    for _ in range(NS_TICKS):
        sw = sweep_batches(sim, decode, wire, trace_svcs)
        for tb in sw["trace"]:
            api_keys |= set(_u64(tb.key_hi, tb.key_lo)[tb.valid].tolist())
        sweeps.append([{k: decode.to_device(b, DEV) for k, b in d.items()}
                       for d in _spread(sw)])
    torch.cuda.synchronize()
    log(f"  staged {N_DISTINCT} conn/resp slabs and {NS_TICKS} sweeps in "
        f"{time.perf_counter() - t0:.2f}s: {sum(n_split)} split flows, "
        f"{len(edges_fed)} distinct (client, service) edges, "
        f"{len(api_keys)} (svc, api) keys of {len(trace_svcs)} services")

    st = aggstate.init(cfg, DEV)
    dep = depgraph.init(*NS_DEP, device=DEV)
    mods = sketch_modules()
    reset_launches(scatter, mods)
    pressures: deque = deque()
    tick_ms, upkeep_ms = [], {}
    n_paired = n_flush = n_dispatch = 0
    for tick in range(NS_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for secs in sweeps[tick]:
            if len(pressures) >= 2 and \
                    int(pressures.popleft()) > cfg.td_stage_cap // 2:
                st = step.td_flush_partial(cfg, st)
                n_flush += 1
            i = n_dispatch % N_DISTINCT
            st, dep, pressure = step.fold_all(cfg, st, dep, tick,
                                              connresp=staged[i], **secs)
            n_paired += n_split[i]
            n_dispatch += 1
            pressures.append(pressure)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) / TICK_DISPATCHES * 1e3)
        last = tick == NS_TICKS - 1
        if last:
            check(int(pressure) == int(step.stage_pressure(st)),
                  f"fold_all's pressure scalar ({int(pressure)}) = "
                  "stage_pressure")
        upkeep = (
            ("td_flush", lambda s, d: (step.td_flush(cfg, s), d)),
            ("classify_pass", lambda s, d: (derive.classify_pass(cfg, s),
                                            d)),
            ("tick_5s", lambda s, d: (step.tick_5s(cfg, s), d)),
            ("dep_age", lambda s, d: (s, depgraph.age(d, tick, PAIR_TTL,
                                                      EDGE_TTL))),
            ("age_tasks", lambda s, d: (step.age_tasks(cfg, s, TASK_AGE),
                                        d)),
            ("age_apis", lambda s, d: (step.age_apis(cfg, s, API_AGE), d)),
            ("compact_state", lambda s, d: (compact.compact_state(cfg, s),
                                            d)),
            ("compact_tasks", lambda s, d: (step.compact_tasks(cfg, s), d)),
        )
        for name, fn in upkeep:
            if last and name == "classify_pass":
                # the port's CPU run on the same state, copied over
                on_cpu = derive.classify_pass(
                    cfg, tree_map(lambda x: x.cpu(), st))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, dep = fn(st, dep)
            torch.cuda.synchronize()
            upkeep_ms.setdefault(name, []).append(
                (time.perf_counter() - t1) * 1e3)
            if last and name == "classify_pass":
                diff = {leaf: int((getattr(st, leaf).cpu()
                                   != getattr(on_cpu, leaf)).sum())
                        for leaf in ("svc_state", "svc_issue",
                                     "resp_hi_bits")}
                states = np.bincount(st.svc_state.cpu().numpy(),
                                     minlength=6).tolist()
                check(not any(diff.values()),
                      "classify_pass on the card = the port's CPU run on "
                      f"the same state (rows differing: {diff}; states "
                      f"{states})")
                del on_cpu
    launches = read_launches(scatter, mods)
    log(f"  ms per fold_all dispatch with sweep sections, by tick: "
        f"{', '.join(f'{m:.3f}' for m in tick_ms)} ({n_flush} partial "
        "flushes)")
    log("  tick upkeep ms (synchronised), by tick: " + "; ".join(
        f"{k} {', '.join(f'{v:.2f}' for v in vs)}"
        for k, vs in upkeep_ms.items()))
    log(f"  kernel launches on the fold_all path: {launches}")
    check(launches == path_launches(n_dispatch),
          f"each of the {n_dispatch} fold_all dispatches launched "
          "hll_update 2x, cms_update 1x, inv_update 1x and the int32 "
          "scatter-add 1x, and no other generic scatter kernel")

    # ---- checks
    check(int(st.tbl.n_live) == n_svcs, f"live services = {n_svcs}")
    drops = (int(dep.half_tbl.n_drop), int(dep.edge_tbl.n_drop),
             float(dep.n_dropped))
    check(drops[0] == 0 and drops[2] == drops[0] + drops[1],
          f"half table n_drop 0; n_dropped = the half and edge tables' "
          f"n_drop (half, edge, n_dropped: {drops})")
    missing, extra, exhausted = _edge_diff(torch, depgraph, dep, edges_fed)
    check(not extra and len(missing) == exhausted
          and int(dep.edge_tbl.n_live) + len(missing) == len(edges_fed),
          f"live edges {int(dep.edge_tbl.n_live)} + {len(missing)} whose "
          f"{depgraph.table.PROBES} probe slots are all held by live keys "
          f"(the table's counted drop) = distinct (client id, service) "
          f"pairs fed ({len(edges_fed)}); none live but not fed "
          f"({len(extra)})")
    check(float(dep.n_paired) == n_paired,
          f"n_paired {float(dep.n_paired):.0f} = split flows whose two "
          f"halves were fed ({n_paired})")
    check(int(dep.half_tbl.n_live) == 0, "no half left unpaired")
    check(int(st.api_tbl.n_live) == len(api_keys),
          f"api_tbl.n_live = distinct (svc, api) keys fed ({len(api_keys)})")
    check(int(st.task_tbl.n_live) == sim.n_hosts * sim.n_groups,
          f"task groups live = {sim.n_hosts * sim.n_groups}")
    check(bool((st.host_last_tick[:sim.n_hosts] == NS_TICKS - 1).all()
               & (st.cm_last_tick[:sim.n_hosts] == NS_TICKS - 1).all()),
          "every sim host's state and cpu/mem landed in the last tick")

    # ---- where the time goes (after the checks: these fold more data)
    perf = {"tick_ms_per_dispatch": tick_ms, "upkeep_ms": upkeep_ms,
            "dispatches": n_dispatch, "launches": launches,
            "partial_flushes": n_flush}
    sections = sweeps[-1][1]            # listener + task
    every = {}                          # every section, one batch each
    for d in sweeps[-1][1:]:
        every.update(d)
        if len(every) == len(NS_LANES):
            break
    if sorted(every) != sorted(NS_LANES):
        raise AssertionError(f"sections {sorted(every)}")

    def window(n, secs):
        nonlocal st, dep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(n):
            st, dep, _ = step.fold_all(cfg, st, dep, NS_TICKS,
                                       connresp=staged[j % N_DISTINCT],
                                       **secs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    perf["connresp_only_ms"] = [window(16, {}) for _ in range(3)]
    perf["with_sections_ms"] = [window(16, sections) for _ in range(3)]
    perf["every_section_ms"] = window(4, every)
    log(f"  ms per fold_all dispatch, three windows of 16: connresp only "
        f"{', '.join(f'{m:.3f}' for m in perf['connresp_only_ms'])}; with "
        "listener+task sections "
        f"{', '.join(f'{m:.3f}' for m in perf['with_sections_ms'])}; with "
        f"every section (4 dispatches) {perf['every_section_ms']:.3f}")
    # the synchronised split of a dispatch with listener + task sections:
    # the sections, fold_many, and dep_fold_many's two halves (the
    # direct-edge fold, the chunked pairing)
    parts = dict.fromkeys(("sections", "fold_many", "dep_direct",
                           "dep_pairing"), 0.0)
    n_rep = 8

    def timed_part(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] += (time.perf_counter() - t0) * 1e3 / n_rep
        return out

    for j in range(n_rep):
        cbs, rbs = staged[j % N_DISTINCT]
        st = timed_part("sections", lambda: step.ingest_task(
            cfg, step.ingest_listener(cfg, st, sections["listener"]),
            sections["task"]))
        st = timed_part("fold_many", lambda: step.fold_many(cfg, st, cbs,
                                                            rbs))
        flat = step.flatten(cbs)
        direct, hv = depgraph.halves_from_conn(flat)
        dep = timed_part("dep_direct", lambda: depgraph.fold_edges(
            dep, *direct, NS_TICKS))

        def pairing():
            d = dep
            chunk = d.h_last_tick.shape[0] // 4
            for lo in range(0, hv.valid.shape[0], chunk):
                d = depgraph.pair_halves(d, tree_map(
                    lambda x: x[lo:lo + chunk], hv), NS_TICKS)
            return d
        dep = timed_part("dep_pairing", pairing)
    perf["split_ms"] = parts
    dep_ms = parts["dep_direct"] + parts["dep_pairing"]
    perf["dep_share_of_connresp"] = dep_ms / (parts["fold_many"] + dep_ms)
    log("  synchronised split of a listener+task dispatch (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; dependency-fold share of the connresp work "
        f"{perf['dep_share_of_connresp']:.1%}")
    # host syncs of one dispatch
    syncs = {}
    for name, secs in (("connresp_only", {}), ("every_section", every)):
        def one(secs=secs):
            nonlocal st, dep
            st, dep, _ = step.fold_all(cfg, st, dep, NS_TICKS,
                                       connresp=staged[0], **secs)
        syncs[name] = count_syncs(torch, one)
        log(f"  host syncs in one {name} fold_all dispatch: "
            f"{len(syncs[name])} at {syncs[name]}")
    syncs["tick"] = count_syncs(torch, lambda: derive.classify_pass(cfg, st))
    log(f"  host syncs in classify_pass: {len(syncs['tick'])} at "
        f"{syncs['tick']}")
    perf["syncs"] = syncs
    # device ops and busy share under the profiler
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    perf["profile"] = {}
    for name, secs in (("connresp_only", {}), ("with_sections", sections)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = window(4, secs)
        busy_us = device_us(torch, prof)
        n_dev = sum(1 for e in prof.events() if e.device_type == cuda)
        perf["profile"][name] = {
            "wall_ms_per_dispatch": wall,
            "device_busy_ms_per_dispatch": busy_us / 4 / 1e3,
            "device_busy_share": busy_us / 4 / 1e3 / wall,
            "device_ops_per_dispatch": n_dev / 4}
        log(f"  profile, {name}: wall {wall:.3f} ms/dispatch, device busy "
            f"{busy_us / 4 / 1e3:.3f} ms ({busy_us / 4 / 1e3 / wall:.1%}), "
            f"{n_dev / 4:.0f} device ops/dispatch")
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == cuda), reverse=True)
        for dev_us, count, key in rows[:8]:
            log(f"    {dev_us / 4:9.1f} us/dispatch  {count / 4:6.1f} calls"
                f"  {key[:90]}")
        rows = sorted(((e.self_cpu_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type != cuda), reverse=True)
        log("    host ops by self CPU time: " + "; ".join(
            f"{key} {cpu_us / 4 / 1e3:.2f} ms x{count / 4:.0f}"
            for cpu_us, count, key in rows[:8]))
    return perf


# ----------------------------------------------------------- phase 8
RT_OPTS = dict(dep_pair_capacity=65536, dep_edge_capacity=524288)
RT_TICKS = 2                # measured ticks
RT_BUFFERS = 16             # feed buffers a measured tick
RT_DISTINCT = 4             # distinct feed buffers, cycled
RT_WARM_BUFFERS = 2         # feed buffers of the warm-up tick
RT_FRESH_ROUNDS = 20        # feed buffer → svcstate query rounds
# the 20 subsystems the port serves
RT_SERVED = ("svcstate", "hoststate", "clusterstate", "flowstate",
             "taskstate", "topcpu", "toppgcpu", "toprss", "topdelay",
             "topfork", "cpumem", "tracereq", "traceuniq", "svcsumm",
             "hostlist", "topk", "svcdependency", "svcmesh", "activeconn",
             "clientconn")
# the 23 subsystems of the host-side registries, the alert manager, the
# notification log and the server's own status (43 with RT_SERVED)
RT_NEW = ("svcinfo", "procinfo", "hostinfo", "extsvcstate", "svcprocmap",
          "tracedef", "tracestatus", "traceconn", "tags", "mountstate",
          "netif", "extactiveconn", "extclientconn", "exttracereq",
          "cgroupstate", "svcipclust", "serverstatus", "notifymsg",
          "alerts", "alertdef", "silences", "inhibits", "actions")
RT_MOUNTS = 4               # MOUNT_STATE records a host a sweep
RT_NETIFS = 2               # NETIF_STATE records a host a sweep
RT_NAT_FLOWS = 4096         # service flows a sweep dialled through a VIP
# alertdefs installed through "op" requests (the first two share one
# canonical filter: one predicate pass for both), a silence, an inhibit
RT_ALERT_OPS = (
    {"alertname": "svc_bad", "subsys": "svcstate",
     "filter": "{ svcstate.state in 'Bad','Severe' }"},
    {"alertname": "svc_bad_2", "subsys": "svcstate", "numcheckfor": 2,
     "severity": "critical",
     "filter": "{svcstate.state in 'Bad', 'Severe'}"},
    {"alertname": "svc_busy", "subsys": "svcstate",
     "filter": "{ svcstate.qps5s > 45 }"},
    {"alertname": "host_issue", "subsys": "hoststate",
     "filter": "{ hoststate.nprocissue > 2 }", "actions": ["hook", "log"]},
    {"alertname": "host_down", "subsys": "hoststate",
     "filter": "{ hoststate.state = 'Down' }"},
    {"alertname": "cpu_hot", "subsys": "cpumem",
     "filter": "{ cpumem.cpu > 60 }", "actions": ["hook", "log"]},
    {"alertname": "mem_hot", "subsys": "cpumem",
     "filter": "{ cpumem.rsspct > 70 }"},
    {"alertname": "task_busy", "subsys": "taskstate",
     "filter": "{ taskstate.cpu > 50 }", "groupwaitsec": 4},
)
RT_OTHER_OPS = (
    {"op": "add", "objtype": "silence", "name": "quiet_busy",
     "alertnames": ["svc_busy"]},
    {"op": "add", "objtype": "inhibit", "name": "host_over_cpu",
     "src_alertnames": ["host_issue"], "target_alertnames": ["mem_hot"]},
    {"op": "add", "objtype": "tracedef", "name": "http_svcs",
     "filter": "{ svcinfo.ishttp = true }"},
)
# one request per served subsystem, and three svcstate variants
RT_QUERIES = {s: {"subsys": s} for s in RT_SERVED}
RT_QUERIES |= {
    "svcstate filter+sort": {
        "subsys": "svcstate", "maxrecs": 100, "sortcol": "p95resp5s",
        "filter": "{ svcstate.state in 'OK','Bad','Severe' } and "
                  "{ svcstate.nconns > 0 }"},
    "svcstate aggr+groupby": {
        "subsys": "svcstate", "groupby": ["state"],
        "aggr": ["count(*)", "avg(qps5s)", "max(p95resp5s)"]},
    "svcstate lazy columns": {
        "subsys": "svcstate", "maxrecs": 100, "sortcol": "nconns",
        "columns": ["svcid", "svcname", "p95resp5s", "p95resp5m",
                    "p50resp5d", "p95resp5d", "nclients", "qps5s"]},
}
# the tiny stream of tests/test_torch_runtime.py (card vs CPU)
TINY_RT_OPTS = dict(dep_pair_capacity=64, dep_edge_capacity=256,
                    dep_pair_ttl_ticks=1, dep_edge_ttl_ticks=2,
                    task_age_every_ticks=2, task_max_age_ticks=1,
                    api_max_age_ticks=2)
TINY_CUTS = (9001, 5000, 333)
# loghist-derived JSON fields: (spec, unit scale of the JSON value)
QUANTILE_FIELDS = {
    **dict.fromkeys(("resp5s", "p95resp5s", "p99resp5s", "p95resp5m",
                     "p50resp5d", "p95resp5d"), ("resp_spec", 1e3)),
    **dict.fromkeys(("p50resp", "p95resp", "p99resp"),
                    ("apiresp_spec", 1e3)),
    "cpup95": ("taskcpu_spec", 1.0),
}


def feed_buffer(sim, cfg, wire):
    """One feed buffer: K·conn_batch TCP_CONN records (one lane in eight
    a split half) and K·resp_batch RESP_SAMPLE records, framed →
    (bytes, conn records, resp records)."""
    n = cfg.fold_k * cfg.conn_batch
    cli, ser = sim.svc_conn_records(n // 16, split_halves=True)
    conns = np.concatenate([sim.conn_records(n - 2 * len(cli)), cli, ser])
    nr = cfg.fold_k * cfg.resp_batch
    return (wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN, conns)
            + sim.resp_frames(nr), len(conns), nr)


def sweep_frames(sim, wire, trace_svcs) -> bytes:
    """One tick's sweep as the agents send it: listeners, process
    groups, hosts' state and cpu/mem, the traced services' requests."""
    return (sim.listener_frames() + sim.task_frames()
            + wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                         sim.host_state_records())
            + wire.encode_frames_chunked(wire.NOTIFY_CPU_MEM_STATE,
                                         sim.cpu_mem_records())
            + sim.trace_frames(TRACE_DRAWS, only_svcs=trace_svcs))


class SyncTimer:
    """Wraps (module, attribute) callables with synchronised wall
    timers for a with-block: where a run_tick's time goes."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.ms = torch, targets, {}

    def __enter__(self):
        self.saved = []
        for mod, attr, name in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name))
        return self

    def _wrap(self, fn, name):
        def timed_fn(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3
            return out
        return timed_fn

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def mount_records(wire, n_hosts: int, tick: int) -> np.ndarray:
    """RT_MOUNTS MOUNT_STATE records a host (free space drifting by
    tick)."""
    n = n_hosts * RT_MOUNTS
    out = np.zeros(n, wire.MOUNT_DT)
    out["host_id"] = np.repeat(np.arange(n_hosts), RT_MOUNTS)
    out["mnt_id"] = np.arange(n) * 7919 + 11
    out["dir_id"] = np.arange(n) % RT_MOUNTS + 101
    out["fstype_id"] = 7
    out["size_mb"] = 102400.0
    out["free_mb"] = 1000.0 + (np.arange(n) * 37 + tick * 11) % 90000
    out["used_pct"] = 100.0 * (1.0 - out["free_mb"] / out["size_mb"])
    out["inodes_used_pct"] = np.arange(n) % 50
    out["is_network_fs"] = np.arange(n) % RT_MOUNTS == 3
    return out


def netif_records(wire, n_hosts: int, tick: int) -> np.ndarray:
    """RT_NETIFS NETIF_STATE records a host (rates drifting by tick)."""
    n = n_hosts * RT_NETIFS
    out = np.zeros(n, wire.NETIF_DT)
    out["host_id"] = np.repeat(np.arange(n_hosts), RT_NETIFS)
    out["if_id"] = np.arange(n) * 104729 + 3
    out["name_id"] = np.arange(n) % RT_NETIFS + 201
    out["speed_mbps"] = 10000.0
    out["rx_mb_sec"] = (np.arange(n) * 13 + tick) % 500
    out["tx_mb_sec"] = (np.arange(n) * 17 + tick) % 400
    out["rx_errs_sec"] = np.arange(n) % 3
    out["is_up"] = np.arange(n) % 16 != 5
    return out


def registry_frames(sim, wire, tick: int, nat_flows: int) -> bytes:
    """A tick's announce-rate records at the sim's full width:
    LISTENER_INFO for every listener, HOST_INFO and CGROUP_STATE for
    every host, the MOUNT_STATE and NETIF_STATE records, and service
    flows dialled through a VIP (the svcipclust source)."""
    return (wire.encode_frames_chunked(wire.NOTIFY_LISTENER_INFO,
                                       sim.listener_info_records())
            + sim.host_info_frames() + sim.cgroup_frames()
            + wire.encode_frames_chunked(
                wire.NOTIFY_MOUNT_STATE, mount_records(wire, sim.n_hosts,
                                                       tick))
            + wire.encode_frames_chunked(
                wire.NOTIFY_NETIF_STATE, netif_records(wire, sim.n_hosts,
                                                       tick))
            + wire.encode_frames_chunked(
                wire.NOTIFY_TCP_CONN, sim.svc_conn_records(nat_flows,
                                                           nat=True)))


def install_alert_ops(rt, hook_url=None) -> list:
    """The alertdefs, silence, inhibit and tracedef through ``"op"``
    requests, and a webhook action to ``hook_url`` (defs routed to an
    absent action notify the log only) → the replies."""
    ops = []
    if hook_url:
        ops.append({"op": "add", "objtype": "action", "name": "hook",
                    "type": "webhook", "url": hook_url, "timeout_s": 5.0})
    ops += [dict(d, op="add", objtype="alertdef") for d in RT_ALERT_OPS]
    ops += list(RT_OTHER_OPS)
    return [rt.query(dict(o)) for o in ops]


def prime_vips(rt) -> int:
    """Prime the runtime's DNS cache with a name for every VIP of
    svcipclust: its answer never waits on a resolver."""
    cols, _ = rt.natclusters.columns(rt.names)
    ips = {str(v).rsplit(":", 1)[0] for v in cols["vip"]}
    for ip in ips:
        rt.dns.prime(ip, f"vip-{ip.replace('.', '-')}.svc.local")
    return len(ips)


class HookServer:
    """A webhook receiver on 127.0.0.1 in this process: counts the POSTs
    and the alerts they carry."""

    def __init__(self):
        import http.server
        import threading

        posts = self.posts = []

        class Hook(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                posts.append(json.loads(body))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Hook)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/alerts"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def wait(self, n: int, timeout: float = 20.0) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if len(self.posts) >= n:
                return True
            time.sleep(0.05)
        return False

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=5.0)


def tiny_runtime_buffers(sim, wire):
    """The four ticks of the tiny runtime stream (names, sweep marks,
    every sweep section, conn with split halves, resp)."""
    out, late = [], None
    for tick in range(4):
        seq = np.zeros(sim.n_hosts, wire.SWEEP_SEQ_DT)
        seq["host_id"] = np.arange(sim.n_hosts)
        seq["seq"] = 10 * tick + seq["host_id"]
        tasks = sim.aggr_task_records()
        if tick == 3:
            tasks = tasks[:8]
        cli, ser = sim.svc_conn_records(8, split_halves=True)
        conns = np.concatenate(
            [sim.conn_records(40), sim.svc_conn_records(8), cli]
            + ([late] if late is not None and tick != 1 else []))
        late = ser
        out.append(
            (sim.name_frames() if tick == 0 else b"")
            + wire.encode_frames_chunked(wire.NOTIFY_SWEEP_SEQ, seq)
            + sim.listener_frames()
            + wire.encode_frames_chunked(wire.NOTIFY_AGGR_TASK_STATE, tasks)
            + wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                         sim.host_state_records())
            + wire.encode_frames_chunked(
                wire.NOTIFY_CPU_MEM_STATE, sim.cpu_mem_records(
                    hot_cpu=[tick % 8], hot_mem=[(tick + 3) % 8]))
            + sim.trace_frames(80)
            + wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN, conns)
            + sim.resp_frames(100))
    return out


def tiny_runtime_stream():
    """The tiny stream's four tick buffers, each with its registry
    records → (buffers, the loghist inputs they feed, by spec)."""
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.sim import ParthaSim

    sim = ParthaSim(n_hosts=8, n_svcs=4, n_clients=256)
    reg_sim = ParthaSim(n_hosts=8, n_svcs=4, n_clients=256, seed=9)
    bufs = [registry_frames(reg_sim, wire, tick, 6) + buf
            for tick, buf in enumerate(tiny_runtime_buffers(sim, wire))]
    return bufs, hist_inputs(bufs)


def hist_inputs(bufs) -> dict:
    """The values a stream's frames feed each loghist spec on the
    device (response samples and traces, task cpu, listener qps and
    active conns), by spec name."""
    from gyeeta_tpu_torch.ingest import decode, wire

    fed = {"resp_spec": [], "apiresp_spec": [], "taskcpu_spec": [],
           "qps_spec": [], "active_spec": []}
    empty = {k: np.zeros(0, dt) for k, dt in wire.DTYPE_OF_SUBTYPE.items()}
    for buf in bufs:
        recs, _, _ = wire.drain2(buf)
        recs = empty | recs
        tr = recs[wire.NOTIFY_REQ_TRACE]
        fed["resp_spec"] += [recs[wire.NOTIFY_RESP_SAMPLE]["resp_usec"],
                             tr["resp_usec"]]
        fed["apiresp_spec"].append(tr["resp_usec"])
        tasks = recs[wire.NOTIFY_AGGR_TASK_STATE]
        tb = decode.task_batch(tasks, max(len(tasks), 1))
        fed["taskcpu_spec"].append(tb.stats[tb.valid, decode.TASK_CPU_PCT])
        lsn = recs[wire.NOTIFY_LISTENER_STATE]
        lb = decode.listener_batch(lsn, max(len(lsn), 1))
        fed["qps_spec"].append(lb.stats[lb.valid, decode.STAT_NQRYS] / 5.0)
        fed["active_spec"].append(
            lb.stats[lb.valid, decode.STAT_NCONNS_ACTIVE])
    return {k: np.concatenate(v).astype(np.float32)
            for k, v in fed.items()}


def tiny_rt_cfg():
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.sketch import loghist
    return tiny_cfg(aggstate, loghist)._replace(
        n_hosts=8, task_capacity=128, api_capacity=256)


def tiny_runtime_run(device):
    """The tiny stream, each tick with its registry records, through
    ``Runtime(device=...)`` in uneven byte cuts, a run_tick after each
    tick, with RT_ALERT_OPS installed through "op" requests first and a
    clock of 5 s a tick → (runtime, tick reports, loghist inputs
    fed)."""
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    now = [1.7e9]
    rt = Runtime(tiny_rt_cfg(), RuntimeOpts(**TINY_RT_OPTS),
                 clock=lambda: now[0], device=device)
    install_alert_ops(rt)
    bufs, fed = tiny_runtime_stream()
    reports = []
    for buf in bufs:
        cuts = [0] + [len(buf) - c for c in TINY_CUTS] + [len(buf)]
        for a, b in zip(cuts, cuts[1:]):
            rt.feed(buf[a:b])
        now[0] += 5.0
        reports.append(rt.run_tick())
    prime_vips(rt)
    return rt, reports, fed


def _json_diff(torch, loghist, cfg, ref, got, moved, path, n_moved):
    """Card JSON against CPU JSON: strings, ints and bools exact; floats
    rtol 1e-6, or else counted in ``n_moved``: 0.001 apart where both
    are rounded to the JSON's three decimals (``fieldmaps.row_to_json``:
    device values one float32 ulp apart, as CUDA's ``expf`` in a loghist
    bucket midpoint gives, straddling a rounding boundary), or within
    one loghist bucket for a quantile field when CUDA's ``logf`` moved
    a sample of its spec."""
    if isinstance(ref, dict):
        if set(ref) != set(got):
            raise AssertionError(f"{path}: keys {set(ref) ^ set(got)}")
        for k in ref:
            _json_diff(torch, loghist, cfg, ref[k], got[k], moved,
                       f"{path}.{k}", n_moved)
    elif isinstance(ref, list):
        if len(ref) != len(got):
            raise AssertionError(f"{path}: {len(ref)} vs {len(got)} rows")
        for i, (a, b) in enumerate(zip(ref, got)):
            _json_diff(torch, loghist, cfg, a, b, moved, f"{path}[{i}]",
                       n_moved)
    elif isinstance(ref, float) or isinstance(got, float):
        if math.isclose(ref, got, rel_tol=1e-6, abs_tol=0.0):
            return
        if (round(ref, 3) == ref and round(got, 3) == got
                and abs(ref - got) <= 0.0010001):
            n_moved[1] += 1
            return
        field = path.rsplit(".", 1)[-1]
        spec_name, scale = QUANTILE_FIELDS.get(field, (None, 1.0))
        if spec_name is None or not moved.get(spec_name):
            raise AssertionError(f"{path}: {ref} vs {got}")
        spec = getattr(cfg, spec_name)
        b = loghist.bucket_of(spec, torch.tensor([ref * scale, got * scale],
                                                 dtype=torch.float32))
        if abs(int(b[0]) - int(b[1])) > 1:
            raise AssertionError(f"{path}: {ref} vs {got}, more than one "
                                 "loghist bucket apart")
        n_moved[0] += 1
    elif type(ref) is not type(got) or ref != got:
        raise AssertionError(f"{path}: {ref!r} vs {got!r}")


def runtime_phase(torch, scatter):
    """The port's Runtime at ns geometry, through its own entry points:
    feed (bytes) → fold_all → run_tick → query; then the tiny stream
    card vs CPU (leaves and query JSON)."""
    from gyeeta_tpu_torch.engine import aggstate, compact, step
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.semantic import derive
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    cfg = aggstate.EngineCfg(**NS_CFG)
    sim = ParthaSim(**NS_SIM, seed=11)
    n_svcs = sim.n_hosts * sim.n_svcs
    log(f"phase 8: Runtime at north-star geometry (dep {RT_OPTS}), "
        f"feed buffers of {cfg.fold_k * cfg.conn_batch} conn + "
        f"{cfg.fold_k * cfg.resp_batch} resp records")
    t0 = time.perf_counter()
    trace_svcs = list(sim.glob_ids.reshape(-1)[::n_svcs // TRACE_SVCS])
    names = sim.name_frames()
    # the registry records come from a sim of their own: the main
    # stream stays the one earlier runs fed
    reg_sim = ParthaSim(**NS_SIM, seed=13)
    sweeps = [sweep_frames(sim, wire, trace_svcs)
              + registry_frames(reg_sim, wire, t, RT_NAT_FLOWS)
              for t in range(RT_TICKS + 1)]
    bufs = [feed_buffer(sim, cfg, wire) for _ in range(RT_DISTINCT)]
    log(f"  generated names ({len(names)} B), {len(sweeps)} sweeps "
        f"({len(sweeps[0])} B each) and {RT_DISTINCT} feed buffers "
        f"({len(bufs[0][0])} B each) in {time.perf_counter() - t0:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(cfg, RuntimeOpts(**RT_OPTS), device=DEV)
    fed = {"conn": 0, "resp": 0}

    def feed(buf, nc=0, nr=0):
        rt.feed(buf)
        fed["conn"] += nc
        fed["resp"] += nr

    # warm-up tick: names, a sweep, a few buffers, the tick
    t0 = time.perf_counter()
    feed(names)
    feed(sweeps[0], RT_NAT_FLOWS)
    for i in range(RT_WARM_BUFFERS):
        feed(*bufs[i % RT_DISTINCT])
    rt.run_tick()
    torch.cuda.synchronize()
    log(f"  warm-up tick (names, sweep, {RT_WARM_BUFFERS} buffers, "
        f"run_tick): {time.perf_counter() - t0:.2f}s, "
        f"{int(rt.state.tbl.n_live)} services live")
    hook = HookServer()
    replies = install_alert_ops(rt, hook.url)
    check(all(r.get("ok") for r in replies),
          f"{len(replies)} CRUD requests (a webhook action to {hook.url}, "
          f"{len(RT_ALERT_OPS)} alertdefs, a silence, an inhibit, a "
          "tracedef) accepted")
    alerts0 = dict(rt.alerts.stats)

    # ---- the main path, counted
    mods = sketch_modules()
    connresp = [0]
    fold_all = step.fold_all

    def counting_fold_all(*a, **kw):
        connresp[0] += kw.get("connresp") is not None
        return fold_all(*a, **kw)

    tick_parts = SyncTimer(torch, (
        (rt, "flush", "flush"), (rt, "td_drain", "td_drain"),
        (derive, "classify_pass", "classify_pass"),
        (rt, "publish_snapshot", "publish_snapshot"),
        (rt, "heavy_recover", "heavy_recover"),
        (depgraph, "age", "dep_age"), (rt, "engine_health", "health"),
        (step, "tick_5s", "tick_5s"), (step, "age_tasks", "age_tasks"),
        (step, "age_apis", "age_apis"),
        (compact, "compact_state", "compact_state"),
        (step, "compact_tasks", "compact_tasks"),
        (rt, "_alert_step", "alert_step"),
        (rt, "_drop_pressure_step", "drop_pressure_step")))
    reg_parts = SyncTimer(torch, tuple(
        (getattr(rt, reg), fn, reg) for reg, fn in (
            ("svcreg", "update"), ("hostinfo", "update"),
            ("cgroups", "update"), ("mounts", "update"),
            ("netifs", "update"), ("natclusters", "observe_conns"),
            ("traceconns", "observe"))))
    perf = {"sweep_s": [], "buffer_ms": [], "tick_ms": [],
            "tick_parts_ms": [], "registry_ms": []}
    timings0 = rt.stats.timing_totals()
    disp0 = rt.stats.counters["fold_dispatches"]
    buf_disp = 0
    reset_launches(scatter, mods)
    step.fold_all = counting_fold_all
    try:
        j = RT_WARM_BUFFERS
        for tick in range(RT_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with reg_parts:
                feed(sweeps[tick + 1], RT_NAT_FLOWS)
            torch.cuda.synchronize()
            perf["sweep_s"].append(time.perf_counter() - t0)
            perf["registry_ms"].append(dict(reg_parts.ms))
            reg_parts.ms = {}
            d0 = rt.stats.counters["fold_dispatches"]
            t0 = time.perf_counter()
            for _ in range(RT_BUFFERS):
                feed(*bufs[j % RT_DISTINCT])
                j += 1
            torch.cuda.synchronize()
            perf["buffer_ms"].append((time.perf_counter() - t0)
                                     / RT_BUFFERS * 1e3)
            buf_disp += rt.stats.counters["fold_dispatches"] - d0
            t0 = time.perf_counter()
            with tick_parts:
                rep = rt.run_tick()
            torch.cuda.synchronize()
            perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            perf.setdefault("alerts_fired", []).append(rep["alerts_fired"])
            perf["tick_parts_ms"].append(dict(tick_parts.ms))
            tick_parts.ms = {}
    finally:
        step.fold_all = fold_all
    launches = read_launches(scatter, mods)
    timings = {k: (n - timings0.get(k, (0, 0.0))[0],
                   ms - timings0.get(k, (0, 0.0))[1])
               for k, (n, ms) in rt.stats.timing_totals().items()}
    ev = cfg.fold_k * (cfg.conn_batch + cfg.resp_batch)
    n_buf = RT_TICKS * RT_BUFFERS
    perf["events_per_buffer"] = ev
    perf["events_per_s"] = [ev / (m / 1e3) for m in perf["buffer_ms"]]
    perf["dispatches_per_buffer"] = buf_disp / n_buf
    perf["dispatches"] = rt.stats.counters["fold_dispatches"] - disp0
    perf["connresp_dispatches"] = connresp[0]
    perf["timeit_ms"] = {k: {"n": n, "total_ms": ms}
                         for k, (n, ms) in timings.items()}
    log(f"  sweep feed (s, by tick): "
        f"{', '.join(f'{s:.3f}' for s in perf['sweep_s'])}")
    log(f"  ms per feed buffer, by tick: "
        f"{', '.join(f'{m:.3f}' for m in perf['buffer_ms'])} "
        f"({', '.join(f'{e:.0f}' for e in perf['events_per_s'])} "
        f"events/s); {perf['dispatches_per_buffer']:.3f} fold dispatches "
        "a buffer")
    log("  Stats.timeit over the measured ticks (sweeps included): " + "; "
        .join(f"{k} {v['total_ms']:.1f} ms / {v['n']}"
              for k, v in sorted(perf["timeit_ms"].items())))
    log(f"  ms per run_tick: {', '.join(f'{m:.2f}' for m in perf['tick_ms'])}"
        "; parts (synchronised): " + " | ".join(
            ", ".join(f"{k} {v:.2f}" for k, v in p.items())
            for p in perf["tick_parts_ms"]))
    log("  a sweep's registry updates (ms, synchronised), by tick: "
        + " | ".join(f"{sum(p.values()):.2f} (" + ", ".join(
            f"{k} {v:.2f}" for k, v in p.items()) + ")"
            for p in perf["registry_ms"]))
    perf["alert_step_ms"] = [p["alert_step"] for p in perf["tick_parts_ms"]]
    perf["drop_pressure_step_ms"] = [p["drop_pressure_step"]
                                     for p in perf["tick_parts_ms"]]
    log(f"  the tick's alert step (ms): "
        f"{', '.join(f'{m:.2f}' for m in perf['alert_step_ms'])}; its "
        f"drop-pressure step: "
        f"{', '.join(f'{m:.2f}' for m in perf['drop_pressure_step_ms'])}")
    log(f"  kernel launches on the Runtime path: {launches}")
    check(launches == path_launches(connresp[0]) and connresp[0] > 0,
          f"each of the {connresp[0]} fold_all dispatches with a conn/resp "
          "slab launched hll_update 2x, cms_update 1x, inv_update 1x and "
          "the int32 scatter-add 1x, and no other generic scatter kernel")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = rt.heavy_recover()
    perf["heavy_recover_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  heavy_recover: {perf['heavy_recover_ms']:.2f} ms, "
        f"{rec['recovered_keys']} recovered keys, {len(rec['flows'])} rows")
    syncs = count_syncs(torch, lambda: rt.feed(bufs[0][0]))
    fed["conn"] += bufs[0][1]
    fed["resp"] += bufs[0][2]
    perf["syncs_per_buffer"] = syncs
    log(f"  host syncs in one feed buffer: {len(syncs)} at {syncs}")
    check(len(syncs) < 28, f"{len(syncs)} host syncs a feed buffer, "
          "fewer than the 28 of fresh columns copied with blocking copies")
    c = rt.stats.counters
    perf["stage_slab_flips"] = c["stage_slab_flips"]
    check(c["stage_slab_flips"] == c["slab_dispatches"] > 0,
          f"stage_slab_flips {c['stage_slab_flips']} = the "
          f"{c['slab_dispatches']} slab dispatches")
    pinned = [torch.from_numpy(a).is_pinned() for b in rt._slab_bufs
              for half in ("conn", "resp") for a in b[half].values()]
    check(all(pinned), f"the {len(pinned)} staging-slab columns of both "
          "buffers are pinned host memory")

    # ---- alerts
    a = {k: v - alerts0.get(k, 0) for k, v in rt.alerts.stats.items()}
    perf["alerts"] = a
    n_defs = len(RT_ALERT_OPS)
    log(f"  alert manager over the measured ticks: {a}; tick reports' "
        f"alerts_fired {perf['alerts_fired']}")
    check(a["nchecks"] == RT_TICKS and a["nfired"] > 0,
          f"{a['nfired']} alerts fired over {a['nchecks']} checks")
    check(a["ncq_group_evals"] == a["nchecks"] * (n_defs - 1),
          f"ncq_group_evals {a['ncq_group_evals']} = {a['nchecks']} checks "
          f"x {n_defs - 1} criteria groups for {n_defs} defs (two share "
          "one canonical filter)")
    hooked = sum(1 for d in RT_ALERT_OPS if "hook" in d.get("actions", ())
                 for x in rt.alerts.alert_log if x.alertname == d[
                     "alertname"])
    check(hooked > 0, f"{hooked} alerts routed to the webhook")
    check(hook.wait(1), f"webhook posts received: {len(hook.posts)}")
    perf["webhook_posts"] = len(hook.posts)
    perf["webhook_alerts"] = sum(len(p["alerts"]) for p in hook.posts)
    log(f"  webhook: {perf['webhook_posts']} posts carrying "
        f"{perf['webhook_alerts']} alerts")
    perf["vips_primed"] = prime_vips(rt)

    # ---- queries
    perf["query_ms"] = {}
    outs = {}
    queries = RT_QUERIES | {s_: {"subsys": s_} for s_ in RT_NEW}
    for name, req in queries.items():
        t0 = time.perf_counter()
        outs[name] = rt.query(dict(req))
        first = (time.perf_counter() - t0) * 1e3
        rt.flush()
        t0 = time.perf_counter()
        again = rt.query(dict(req))
        cached = (time.perf_counter() - t0) * 1e3
        # serverstatus carries the uptime and the query count
        if again != outs[name] and name != "serverstatus":
            raise AssertionError(f"{name}: the cached answer differs")
        perf["query_ms"][name] = {"first": first, "cached": cached,
                                  "nrecs": outs[name]["nrecs"]}
        log(f"  query {name}: {first:.1f} ms, cached {cached:.1f} ms, "
            f"nrecs {outs[name]['nrecs']}")
    perf["snapshot_query_ms"] = {}
    for name in RT_NEW:
        req = {"subsys": name, "consistency": "snapshot"}
        t0 = time.perf_counter()
        first_out = rt.query(dict(req))
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again = rt.query(dict(req))
        cached = (time.perf_counter() - t0) * 1e3
        check(again is first_out, f"snapshot {name}: first {first:.1f} ms, "
              f"cached {cached:.2f} ms, nrecs {first_out['nrecs']}")
        perf["snapshot_query_ms"][name] = {"first": first, "cached": cached,
                                           "nrecs": first_out["nrecs"]}
    # query freshness: the first svcstate query after each fold
    fresh = []
    for i in range(RT_FRESH_ROUNDS):
        feed(*bufs[i % RT_DISTINCT])
        t0 = time.perf_counter()
        out = rt.query({"subsys": "svcstate"})
        fresh.append((time.perf_counter() - t0) * 1e3)
        if out["ntotal"] != n_svcs:
            raise AssertionError(f"svcstate ntotal {out['ntotal']}")
    q = np.percentile(fresh, [50, 99])
    perf["svcstate_after_fold_ms"] = {"samples": fresh, "p50": q[0],
                                      "p99": q[1], "max": max(fresh)}
    log(f"  svcstate query right after a feed buffer ({RT_FRESH_ROUNDS} "
        f"rounds): p50 {q[0]:.1f} ms, p99 {q[1]:.1f} ms, max "
        f"{max(fresh):.1f} ms")
    perf["max_memory_allocated_gib"] = \
        torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory: {perf['max_memory_allocated_gib']:.3f} GiB")

    # ---- checks at ns
    c = rt.stats.counters
    check(c["conn_events"] == fed["conn"] and c["resp_events"] == fed["resp"],
          f"conn_events {c['conn_events']} / resp_events "
          f"{c['resp_events']} = the records fed")
    check(outs["svcstate"]["ntotal"] == n_svcs,
          f"svcstate ntotal = {n_svcs} live services")
    check(outs["hoststate"]["ntotal"] == sim.n_hosts,
          f"hoststate: {sim.n_hosts} hosts")
    live_edges = int(rt.dep.edge_tbl.n_live)
    check(outs["svcdependency"]["ntotal"] == live_edges > 0,
          f"svcdependency's live rows = the {live_edges} edges the "
          "dependency graph holds live")
    check(outs["topk"]["nrecs"] > 0 and rec["recovered_keys"] > 0,
          f"topk returns rows ({outs['topk']['nrecs']}) and heavy_recover "
          f"recovered keys ({rec['recovered_keys']})")
    perf["recovered_keys"] = rec["recovered_keys"]
    want = {"svcinfo": n_svcs, "hostinfo": sim.n_hosts,
            "cgroupstate": sim.n_hosts * len(sim.CGPATHS),
            "mountstate": sim.n_hosts * RT_MOUNTS,
            "netif": sim.n_hosts * RT_NETIFS, "extsvcstate": n_svcs,
            "alertdef": len(RT_ALERT_OPS), "silences": 1, "inhibits": 1,
            "tracedef": 1}
    got = {k: outs[k]["ntotal"] for k in want}
    check(got == want, f"registry and alert views hold what was fed and "
          f"installed: {got}")
    check(outs["svcipclust"]["ntotal"] > 0
          and outs["alerts"]["ntotal"] > 0
          and outs["notifymsg"]["ntotal"] > 0,
          f"svcipclust {outs['svcipclust']['ntotal']}, alerts "
          f"{outs['alerts']['ntotal']}, notifymsg "
          f"{outs['notifymsg']['ntotal']} rows")
    rt.close()
    hook.close()
    del rt
    gc.collect()              # a published snapshot refers to its runtime
    torch.cuda.empty_cache()

    # ---- card vs CPU, tiny stream
    log("  tiny runtime stream, card vs CPU")
    g_rt, g_rep, fed_vals = tiny_runtime_run(DEV)
    c_rt, c_rep, _ = tiny_runtime_run("cpu")
    check(g_rep == c_rep and sum(r["alerts_fired"] for r in c_rep) > 0,
          f"tick reports equal, alerts_fired included: {c_rep}")
    tcfg = c_rt.cfg
    moved = {k: _moved(torch, loghist, getattr(tcfg, k), v)
             for k, v in fed_vals.items()}
    log(f"  loghist inputs whose bucket CUDA's logf moves: {moved}")
    names_ = tree_paths(aggstate.init(tcfg, "meta"))
    n_exact, n_close = _compare_leaves(
        names_, aggstate.state_to_numpy(c_rt.state),
        aggstate.state_to_numpy(g_rt.state), moved)
    check(n_exact + n_close == 85, f"AggState: 85 leaves agree ({n_exact} "
          f"exactly, {n_close} within tolerance)")
    dnames = tree_paths(depgraph.init(1, 1, "meta"))
    n_exact, n_close = _compare_leaves(
        dnames, depgraph.dep_to_numpy(c_rt.dep),
        depgraph.dep_to_numpy(g_rt.dep), {})
    check(n_exact + n_close == 29, f"DepGraph: 29 leaves agree ({n_exact} "
          f"exactly, {n_close} within tolerance)")
    n_q = [0, 0]
    for name in queries:
        req = dict(queries[name], maxrecs=10000) \
            if "aggr" not in queries[name] else queries[name]
        _json_diff(torch, loghist, tcfg, c_rt.query(dict(req)),
                   g_rt.query(dict(req)), moved, name, n_q)
    for name in RT_NEW:
        req = {"subsys": name, "maxrecs": 10000, "consistency": "snapshot"}
        _json_diff(torch, loghist, tcfg, c_rt.query(dict(req)),
                   g_rt.query(dict(req)), moved, f"{name}@snapshot", n_q)
    check(True, f"query JSON of {len(queries)} requests, and of the "
          f"{len(RT_NEW)} new subsystems from the snapshot, agrees card vs "
          f"CPU ({n_q[0]} quantiles one loghist bucket apart, {n_q[1]} "
          "values one unit apart in the JSON's third decimal)")
    perf["tiny_json_bucket_apart"], perf["tiny_json_rounding_apart"] = n_q
    cc, gc_ = dict(c_rt.stats.counters), dict(g_rt.stats.counters)
    check(cc == gc_ and cc["stage_slab_flips"] > 0,
          f"counters equal card vs CPU ({len(cc)}, stage_slab_flips "
          f"{cc['stage_slab_flips']})")
    check(g_rt.alerts.stats == c_rt.alerts.stats,
          f"alert manager stats equal: {c_rt.alerts.stats}")
    g_rt.close()
    c_rt.close()
    return perf, launches, (names, sweeps, bufs, n_svcs)


# ----------------------------------------------------------- phase 9
# one measured tick of 8 buffers' worth (16 before phase 17), to keep
# the script inside its time limit
DELTA_TICKS = 1             # measured ticks
DELTA_BUFFERS = 8           # phase-8 feed buffers' worth of records a tick
DELTA_WARM_BUFFERS = 1      # ... of the warm-up tick
DELTA_FEED_BYTES = 1 << 20  # SKETCH_DELTA frames fed in ~1 MB buffers
DELTA_PROFILED = 4          # delta dispatches under torch.profiler
# launches of each kernel in a delta-only dispatch (hh_width > 0)
DELTA_LAUNCHES = path_launches(0, 1)
# the delta section's kernel call sites: (kernel, module, function); the
# generic kernel's two are told apart by their route: the one-launch
# merge and t-digest stage_samples' add_drop of the counts
DELTA_SITES = (("cms_update", "countmin", "update"),
               ("inv_update", "invertible", "write_candidates"),
               ("delta_merge", "scatter", "scatter_sites"),
               ("add_drop", "scatter", "scatter_sites"))
# the tiny delta stream of tests/test_torch_delta_fold.py (card vs CPU)
TINY_DELTA_CFG = dict(
    svc_capacity=64, n_hosts=8, hll_p_svc=4, hll_p_global=8, cms_depth=2,
    cms_width=1 << 10, topk_capacity=16, topk_budget=48, td_capacity=16,
    hh_depth=2, hh_width=256, conn_batch=64, resp_batch=128,
    listener_batch=32, fold_k=4, task_capacity=128, api_capacity=256)
TINY_DELTA_OPTS = dict(dep_pair_capacity=256, dep_edge_capacity=1024)


def state_sweep_frames(sim, wire) -> bytes:
    """One tick's 5 s state sweep, raw in delta mode too: listeners,
    process groups, hosts' state and cpu/mem (no traces: the trace→resp
    bridge suppresses a host only when it sends raw resp records, so it
    would feed a delta-fed engine samples a raw-fed one does not get)."""
    return (sim.listener_frames() + sim.task_frames()
            + wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                         sim.host_state_records())
            + wire.encode_frames_chunked(wire.NOTIFY_CPU_MEM_STATE,
                                         sim.cpu_mem_records()))


def delta_feed_buffers(wire, recs) -> list:
    """SKETCH_DELTA records framed into feed buffers of ~1 MB."""
    n = max(1, DELTA_FEED_BYTES // wire.DELTA_DT.itemsize)
    return [wire.encode_frames_chunked(wire.NOTIFY_SKETCH_DELTA,
                                       recs[i:i + n])
            for i in range(0, len(recs), n)]


def mixed_dispatch(wire, recs, part: int) -> bytes:
    """One delta dispatch's worth of records (256), ``256 // 8`` of each
    kind (the ``part``-th such slice of each), framed."""
    n = 256 // 8
    pick = np.concatenate([np.flatnonzero(recs["kind"] == k)
                           [part * n:(part + 1) * n] for k in range(1, 9)])
    rest = np.setdiff1d(np.arange(len(recs)), pick)
    pick = np.concatenate([pick, rest[part * 256:][:256 - len(pick)]])
    return wire.encode_frames_chunked(wire.NOTIFY_SKETCH_DELTA,
                                      recs[np.sort(pick)])


def _sorted_edges(torch, table, dep):
    """Live dependency edges → (keys (E, 4) int64 sorted, e_ctr (E, 2))."""
    live = table.live_mask(dep.edge_tbl)
    keys = torch.stack([dep.e_cli_hi[live], dep.e_cli_lo[live],
                        dep.e_ser_hi[live], dep.e_ser_lo[live]],
                       1).to(torch.int64).cpu().numpy()
    ctr = dep.e_ctr[live].double().cpu().numpy()
    order = np.lexsort(keys.T[::-1])
    return keys[order], ctr[order]


def delta_vs_raw(torch, table, windows, raw, dlt, keys64, resid) -> dict:
    """tests/test_preagg.py's bounds between the raw-fed and the
    delta-fed runtime over the same records (the folded totals: each
    window's lifetime slab + its current one) → the measured margins."""
    def rows(rt):
        hi = torch.from_numpy((keys64 >> np.uint64(32)).astype(np.int64))
        lo = torch.from_numpy((keys64 & np.uint64(0xFFFFFFFF))
                              .astype(np.int64))
        r = table.lookup(rt.state.tbl, hi.to(rt.device), lo.to(rt.device))
        check(bool((r >= 0).all()), "every sim service is live in "
              "both runtimes")
        return r

    def folded(win):
        return windows.read(win, len(win.totals))

    sA, sB = raw.state, dlt.state
    ra, rb = rows(raw), rows(dlt)
    out = {}
    check(torch.equal(sA.glob_hll.regs, sB.glob_hll.regs)
          and torch.equal(sA.svc_hll.regs[ra], sB.svc_hll.regs[rb]),
          "global and per-service HLL registers bit-identical")
    ha, hb = folded(sA.resp_win)[ra], folded(sB.resp_win)[rb]
    check(torch.equal(ha.sum(1), hb.sum(1)),
          "loghist totals per service equal")
    out["bucket_flips"] = float((ha - hb).abs().double().sum()) / 2
    out["loghist_total"] = float(ha.double().sum())
    check(out["bucket_flips"] <= max(2.0, 1e-4 * out["loghist_total"]),
          f"loghist bucket flips {out['bucket_flips']} <= max(2, 1e-4 of "
          f"{out['loghist_total']:.0f})")
    ca, cb = folded(sA.ctr_win)[ra].double(), folded(sB.ctr_win)[rb].double()
    out["ctr_max_rel"] = float(((ca - cb).abs() / ca.abs().clamp(min=1e-3))
                               .max())
    torch.testing.assert_close(cb, ca, rtol=1e-4, atol=1e-3)
    check(True, f"per-service counters within rtol 1e-4 (largest relative "
          f"difference {out['ctr_max_rel']:.3g})")
    out["n_conn"], out["n_resp"] = float(sA.n_conn), float(sA.n_resp)
    check(float(sB.n_conn) == out["n_conn"]
          and float(sB.n_resp) == out["n_resp"],
          f"n_conn {out['n_conn']:.0f} and n_resp {out['n_resp']:.0f} "
          "exact")
    mA = float(sA.cms.counts[0].double().sum())
    mB = float(sB.cms.counts[0].double().sum())
    out["cms_mass_raw"], out["cms_mass_delta"] = mA, mB
    out["resid"] = resid
    out["cms_rel"] = abs(mA - (mB + resid)) / mA
    check(mB <= mA * (1 + 1e-6) and out["cms_rel"] <= 1e-5,
          f"CMS mass: delta {mB:.6g} + residual {resid:.6g} = raw "
          f"{mA:.6g} (relative difference {out['cms_rel']:.3g})")
    ka, va = _sorted_edges(torch, table, raw.dep)
    kb, vb = _sorted_edges(torch, table, dlt.dep)
    out["edges"] = len(ka)
    out["edge_drops"] = (float(raw.dep.edge_tbl.n_drop),
                         float(dlt.dep.edge_tbl.n_drop))
    check(len(ka) > 0 and np.array_equal(ka, kb),
          f"dependency edges equal as a key set ({len(ka)} edges; probe "
          f"drops raw/delta {out['edge_drops']})")
    np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-3)
    check(True, "dependency edge counts and bytes within rtol 1e-5")
    return out


def _delta_stream(sim, ef, wire, tick):
    """One tick of the tiny delta stream (as tests/test_torch_delta_fold.py
    feeds it) → (buffer, cut, raw resp values)."""
    delta = ef.fold_sweep(sim.conn_records(300), sim.resp_records(500))
    if tick == 2:
        odd = np.zeros(2, wire.DELTA_DT)
        odd["kind"] = [99, wire.DK_SVC_HIST]
        odd["nitem"] = [0, 2]
        pv = odd["payload"][1][:12].view(wire.DELTA_PAIR_DT)
        pv["idx"], pv["wt"] = [3, 4000], [1.0, 1.0]
        delta = np.concatenate([delta, odd])
    dbytes = wire.encode_frames_chunked(wire.NOTIFY_SKETCH_DELTA, delta)
    agent = np.zeros(2, wire.AGENT_STATS_DT)
    agent["host_id"] = [1, 2]
    agent["spool_dropped"] = [tick, 1]
    agent["spool_dropped_records"] = [10 * tick, 3]
    agent["spool_resent"] = [2, 0]
    agent["connect_timeouts"] = [0, tick]
    lst = sim.listener_state_records()
    head = ((sim.name_frames() if tick == 0 else b"")
            + wire.encode_frames_chunked(wire.NOTIFY_LISTENER_STATE, lst)
            + wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                         sim.host_state_records()))
    resp = sim.resp_records(60)
    buf = (head + dbytes
           + wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN,
                                        sim.conn_records(40))
           + wire.encode_frames_chunked(wire.NOTIFY_RESP_SAMPLE, resp)
           + wire.encode_frames_chunked(wire.NOTIFY_AGENT_STATS, agent))
    return buf, len(head) + len(dbytes) // 2 + 5, resp["resp_usec"], lst


def tiny_delta_run(device):
    """The tiny delta stream through ``Runtime(device=...)`` → (runtime,
    tick reports, snapshot JSON of every served subsystem after each
    tick, {spec name: loghist inputs the device buckets})."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import decode, wire
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import edgefold, loghist
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    cfg = aggstate.EngineCfg(resp_spec=loghist.LogHistSpec(1.0, 1e8, 32),
                             **TINY_DELTA_CFG)
    rt = Runtime(cfg, RuntimeOpts(**TINY_DELTA_OPTS), device=device)
    sim = ParthaSim(n_hosts=8, n_svcs=4, n_clients=256, seed=7)
    ef = edgefold.EdgeFold(edgefold.params_of_cfg(cfg, flow_max=24),
                           host_id=0, hll_refresh_every=3)
    reports, snaps = [], []
    fed = {"resp_spec": [], "qps_spec": [], "active_spec": []}
    for tick in range(4):
        buf, cut, resp, lst = _delta_stream(sim, ef, wire, tick)
        lb = decode.listener_batch(lst, 4096)
        fed["resp_spec"].append(resp)
        fed["qps_spec"].append(lb.stats[lb.valid, decode.STAT_NQRYS] / 5.0)
        fed["active_spec"].append(
            lb.stats[lb.valid, decode.STAT_NCONNS_ACTIVE])
        rt.feed(buf[:cut])
        rt.feed(buf[cut:])
        reports.append(rt.run_tick())
        snaps.append({s: rt.query({"subsys": s, "maxrecs": 10000,
                                   "consistency": "snapshot"})
                      for s in RT_SERVED})
    return rt, reports, snaps, {k: np.concatenate(v).astype(np.float32)
                                for k, v in fed.items()}


def delta_phase(torch, scatter):
    """Edge pre-aggregation through the Runtime at ns geometry: agents'
    EdgeFolds turn each tick's records into SKETCH_DELTA records, fed
    beside the raw state sweep; then the same records raw into a second
    Runtime and the reference's delta-vs-raw bounds; each kernel of the
    delta section against its plain version on one delta dispatch's
    inputs; the snapshot tier; the tiny delta stream card vs CPU."""
    from gyeeta_tpu_torch.engine import aggstate, compact, step, table
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.semantic import derive
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import edgefold, loghist, windows
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    t_phase = time.perf_counter()
    cfg = aggstate.EngineCfg(**NS_CFG)
    sim = ParthaSim(**NS_SIM, seed=13)
    nb_c = cfg.fold_k * cfg.conn_batch
    nb_r = cfg.fold_k * cfg.resp_batch
    log(f"phase 9: delta-fed Runtime at north-star geometry (dep "
        f"{RT_OPTS}): a tick's sweep is {DELTA_BUFFERS} feed buffers' worth "
        f"of records ({nb_c} conn + {nb_r} resp each) folded by the agent, "
        f"the warm-up tick {DELTA_WARM_BUFFERS}")
    t0 = time.perf_counter()
    names = sim.name_frames()
    conns = [sim.conn_records(nb_c) for _ in range(RT_DISTINCT)]
    resps = [sim.resp_records(nb_r) for _ in range(RT_DISTINCT)]
    raw_bufs = [wire.encode_frames_chunked(wire.NOTIFY_TCP_CONN, c)
                + wire.encode_frames_chunked(wire.NOTIFY_RESP_SAMPLE, r)
                for c, r in zip(conns, resps)]
    sweeps = [state_sweep_frames(sim, wire)
              for _ in range(DELTA_TICKS + 1)]
    log(f"  generated {RT_DISTINCT} distinct buffers' records, names and "
        f"{len(sweeps)} state sweeps in {time.perf_counter() - t0:.2f}s")
    params = edgefold.params_of_cfg(cfg)
    ef = edgefold.EdgeFold(params, host_id=0)
    ticks, j = [], 0
    perf = {"params": params, "edgefold_s": [], "delta_records": [],
            "delta_bytes": [], "raw_records": [], "raw_bytes": []}
    for n_buf in [DELTA_WARM_BUFFERS] + [DELTA_BUFFERS] * DELTA_TICKS:
        idx = [(j + i) % RT_DISTINCT for i in range(n_buf)]
        j += n_buf
        t0 = time.perf_counter()
        recs = ef.fold_sweep(np.concatenate([conns[i] for i in idx]),
                             np.concatenate([resps[i] for i in idx]))
        perf["edgefold_s"].append(time.perf_counter() - t0)
        dbufs = delta_feed_buffers(wire, recs)
        ticks.append({"idx": idx, "recs": recs, "bufs": dbufs})
        perf["delta_records"].append(len(recs))
        perf["delta_bytes"].append(sum(len(b) for b in dbufs))
        perf["raw_records"].append(n_buf * (nb_c + nb_r))
        perf["raw_bytes"].append(sum(len(raw_bufs[i]) for i in idx))
    kinds = np.bincount(ticks[-1]["recs"]["kind"], minlength=9)
    perf["delta_kinds_last_tick"] = {
        k: int(kinds[getattr(wire, f"DK_{k.upper()}")]) for k in (
            "svc_ctr", "svc_hist", "svc_hll", "glob_hll", "svc_td", "flow",
            "dep", "resid")}
    log(f"  agent fold (EdgeFold.fold_sweep, host): "
        f"{', '.join(f'{s:.2f}' for s in perf['edgefold_s'])} s by tick; "
        f"delta records {perf['delta_records']} ({perf['delta_bytes']} B) "
        f"for raw records {perf['raw_records']} ({perf['raw_bytes']} B); "
        f"last tick's records by kind {perf['delta_kinds_last_tick']}")

    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(cfg, RuntimeOpts(**RT_OPTS), device=DEV)
    t0 = time.perf_counter()
    rt.feed(names)
    rt.feed(sweeps[0])
    for b in ticks[0]["bufs"]:
        rt.feed(b)
    rt.run_tick()
    torch.cuda.synchronize()
    log(f"  warm-up tick (names, sweep, {len(ticks[0]['bufs'])} delta "
        f"buffers, run_tick): {time.perf_counter() - t0:.2f}s, "
        f"{int(rt.state.tbl.n_live)} services live")

    # ---- the delta path, counted
    mods = sketch_modules()
    n_delta, n_connresp = [0], [0]
    fold_all = step.fold_all

    def counting_fold_all(*a, **kw):
        n_delta[0] += kw.get("delta") is not None
        n_connresp[0] += kw.get("connresp") is not None
        return fold_all(*a, **kw)

    dispatch = rt._dispatch_fused
    disp_ms = []

    def timed_dispatch(*a, **kw):
        d0 = n_delta[0]
        t = time.perf_counter()
        dispatch(*a, **kw)
        torch.cuda.synchronize()
        if n_delta[0] > d0:
            disp_ms.append((time.perf_counter() - t) * 1e3)

    tick_parts = SyncTimer(torch, (
        (rt, "flush", "flush"), (rt, "td_drain", "td_drain"),
        (derive, "classify_pass", "classify_pass"),
        (rt, "publish_snapshot", "publish_snapshot"),
        (rt, "heavy_recover", "heavy_recover"),
        (depgraph, "age", "dep_age"), (rt, "engine_health", "health"),
        (step, "tick_5s", "tick_5s"), (step, "age_tasks", "age_tasks"),
        (step, "age_apis", "age_apis"),
        (compact, "compact_state", "compact_state"),
        (step, "compact_tasks", "compact_tasks")))
    perf |= {"sweep_s": [], "delta_feed_s": [], "dispatches": [],
             "delta_dispatches": [], "tick_ms": [], "tick_parts_ms": []}
    reset_launches(scatter, mods)
    step.fold_all = counting_fold_all
    rt._dispatch_fused = timed_dispatch
    try:
        for tick in ticks[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.feed(sweeps[len(perf["sweep_s"]) + 1])
            torch.cuda.synchronize()
            perf["sweep_s"].append(time.perf_counter() - t0)
            d0, n0 = rt.stats.counters["fold_dispatches"], n_delta[0]
            t0 = time.perf_counter()
            for b in tick["bufs"]:
                rt.feed(b)
            torch.cuda.synchronize()
            perf["delta_feed_s"].append(time.perf_counter() - t0)
            perf["dispatches"].append(rt.stats.counters["fold_dispatches"]
                                      - d0)
            perf["delta_dispatches"].append(n_delta[0] - n0)
            t0 = time.perf_counter()
            with tick_parts:
                rep = rt.run_tick()
            torch.cuda.synchronize()
            perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            perf.setdefault("alerts_fired", []).append(rep["alerts_fired"])
            perf["tick_parts_ms"].append(dict(tick_parts.ms))
            tick_parts.ms = {}
    finally:
        step.fold_all = fold_all
        del rt._dispatch_fused
    launches = read_launches(scatter, mods)
    n_d = sum(perf["delta_dispatches"])
    q = np.percentile(disp_ms, [50])
    perf["delta_dispatch_ms"] = {"p50": q[0], "max": max(disp_ms),
                                 "n": len(disp_ms)}
    perf["raw_events_per_s"] = [
        r / s for r, s in zip(perf["raw_records"][1:],
                              perf["delta_feed_s"])]
    sweep_ms = ", ".join(f"{s * 1e3:.1f}" for s in perf["delta_feed_s"])
    log(f"  fold dispatches a tick's delta sweep: {perf['dispatches']} "
        f"({perf['delta_dispatches']} with a delta section); ms per tick's "
        f"delta sweep: {sweep_ms}; ms per delta dispatch (each synchronised): p50 {q[0]:.3f}, max "
        f"{max(disp_ms):.3f}; raw events represented per second: "
        f"{', '.join(f'{e:.0f}' for e in perf['raw_events_per_s'])}")
    log(f"  state sweep feed (s, by tick): "
        f"{', '.join(f'{s:.3f}' for s in perf['sweep_s'])}")
    log(f"  ms per run_tick: {', '.join(f'{m:.2f}' for m in perf['tick_ms'])}"
        "; parts (synchronised): " + " | ".join(
            ", ".join(f"{k} {v:.2f}" for k, v in p.items())
            for p in perf["tick_parts_ms"]))
    log(f"  kernel launches on the delta path: {launches}")
    want = {k: v * n_d for k, v in DELTA_LAUNCHES.items()}
    check(n_connresp[0] == 0 and n_d > 0 and launches == want,
          f"each of the {n_d} delta dispatches launched cms_update 1x, "
          "inv_update 1x, the one-launch generic merge (loghist add, "
          "per-service and global HLL max) 1x and the int32 scatter-add "
          "of the stage counts 1x, and hll_update never")

    # ---- the same records raw, and the reference's bounds
    raw = Runtime(cfg, RuntimeOpts(**RT_OPTS), device=DEV)
    raw_s = []
    raw.feed(names)
    for t, tick in enumerate(ticks):
        raw.feed(sweeps[t])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in tick["idx"]:
            raw.feed(raw_bufs[i])
        torch.cuda.synchronize()
        raw_s.append(time.perf_counter() - t0)
        raw.run_tick()
    perf["raw_feed_s"] = raw_s
    perf["raw_dispatches"] = raw.stats.counters["fold_dispatches"]
    log(f"  the same records raw: feed s by tick "
        f"{', '.join(f'{s:.3f}' for s in raw_s)}, "
        f"{raw.stats.counters['slab_dispatches']} slab dispatches")
    perf["vs_raw"] = delta_vs_raw(torch, table, windows, raw, rt,
                                  sim.glob_ids.reshape(-1),
                                  ef.stats["resid_bytes"])
    del raw
    gc.collect()
    torch.cuda.empty_cache()

    # ---- syncs, profile and kernel inputs of delta dispatches
    last = ticks[-1]["recs"]
    d0 = rt.stats.counters["fold_dispatches"]
    syncs = count_syncs(torch, lambda: rt.feed(ticks[-1]["bufs"][0]))
    nd = rt.stats.counters["fold_dispatches"] - d0
    perf["syncs_per_delta_dispatch"] = len(syncs) / nd
    perf["sync_sites"] = sorted(set(syncs))
    log(f"  host syncs in one ~1 MB delta buffer: {len(syncs)} in {nd} "
        f"dispatches ({len(syncs) / nd:.2f} a dispatch) at "
        f"{perf['sync_sites']}")
    from torch.profiler import ProfilerActivity, profile
    frame = wire.encode_frames_chunked(
        wire.NOTIFY_SKETCH_DELTA, last[:DELTA_PROFILED * 256])
    cuda = torch.autograd.DeviceType.CUDA
    d0 = rt.stats.counters["fold_dispatches"]
    reset_launches(scatter, mods)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.feed(frame)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    nd = rt.stats.counters["fold_dispatches"] - d0
    prof_launches = read_launches(scatter, mods)
    check(nd == DELTA_PROFILED, f"{DELTA_PROFILED * 256} delta records "
          f"fold in {DELTA_PROFILED} dispatches")
    busy_us = device_us(torch, prof)
    n_dev = sum(1 for e in prof.events() if e.device_type == cuda)
    perf["profile"] = {"wall_ms_per_dispatch": wall_us / nd / 1e3,
                       "device_busy_ms_per_dispatch": busy_us / nd / 1e3,
                       "device_busy_share": busy_us / wall_us,
                       "device_ops_per_dispatch": n_dev / nd}
    log(f"  profile of {nd} delta dispatches: wall "
        f"{wall_us / nd / 1e3:.3f} ms/dispatch, device busy "
        f"{busy_us / nd / 1e3:.3f} ms/dispatch ({busy_us / wall_us:.1%}), "
        f"{n_dev / nd:.0f} device ops/dispatch")
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cuda),
                  reverse=True)
    for dev_us, count, key in rows[:12]:
        log(f"    {dev_us / nd:9.1f} us/dispatch  {count / nd:6.1f} calls  "
            f"{key[:100]}")
    back = [(us, c) for us, c, k in rows if "indexing_backward" in k]
    perf["profile"] |= {
        "launches": prof_launches,
        "indexing_backward_us_per_dispatch": sum(u for u, _ in back) / nd,
        "indexing_backward_calls_per_dispatch": sum(c for _, c in back) / nd,
        "top_kernels": [{"key": k, "us_per_dispatch": us / nd,
                         "calls_per_dispatch": c / nd}
                        for us, c, k in rows[:12]]}
    log(f"  launches of each kernel entry in the profiled dispatches: "
        f"{prof_launches}; indexing_backward kernels (index_put_'s "
        f"sorted accumulate): "
        f"{perf['profile']['indexing_backward_calls_per_dispatch']:.1f} "
        f"calls, {perf['profile']['indexing_backward_us_per_dispatch']:.1f}"
        f" us a dispatch")
    check(prof_launches == {k: v * nd for k, v in DELTA_LAUNCHES.items()},
          f"the {nd} profiled delta dispatches launched each entry as "
          "every delta dispatch does")

    # one delta dispatch with each kernel's inputs recorded: records of
    # every kind the ticks shipped (the later sweeps ship few HLL
    # registers)
    allrecs = np.concatenate([t["recs"] for t in ticks])
    site_mods = dict(sketch_modules(), scatter=scatter)
    captured = []
    kinds = {(m, f): kind for kind, m, f in DELTA_SITES}
    saved = [(site_mods[m], f, getattr(site_mods[m], f)) for m, f in kinds]

    def recorder(mod, fn, orig):
        def rec(target, *args, **kw):
            kind = kw["route"] if mod == "scatter" else kinds[(mod, fn)]
            captured.append((kind, mod, fn, _clone(target), _clone(args),
                             _clone(kw)))
            return orig(target, *args, **kw)
        return rec

    for (m, f), (mod, _, orig) in zip(kinds, saved):
        setattr(mod, f, recorder(m, f, orig))
    try:
        puts = accumulate_puts(torch, lambda: rt.feed(
            mixed_dispatch(wire, allrecs, 0)))
    finally:
        for mod, f, orig in saved:
            setattr(mod, f, orig)
    got = [(k, m, f) for k, m, f, *_ in captured]
    check(sorted(got) == sorted(DELTA_SITES),
          f"one delta dispatch calls {got}")
    check("int32" not in puts, "no int32 index_put_(accumulate=True) in a "
          f"delta dispatch (by dtype: {puts})")
    perf["accumulate_puts"] = puts
    log("  each kernel of the delta section vs its plain version at one "
        "delta dispatch's inputs (inv, max, int32 add: exact; cms, f32 "
        "add: rtol 1e-6)")
    sites = {}
    for kind, mod, fn, target, args, kw in captured:
        if kind == "delta_merge":
            c = sites_call(torch, scatter, "step.ingest_delta", target)
        elif kind == "add_drop":
            (st_,) = target
            c = generic_call(torch, scatter, kind, "tdigest.stage_samples:"
                             "add_drop (delta)", st_.target, st_.row,
                             st_.val, keep=st_.keep, col=st_.col,
                             stride=st_.stride)
        else:
            generic = "scatter_add" if mod == "countmin" else "scatter_max"
            c = fused_call(torch, scatter, kind, mod, fn, generic, target,
                           args, kw)
        sites.setdefault(kind, []).append(c)

    # ---- the snapshot tier
    perf["snapshot_query_ms"] = {}
    snap = rt.publish_snapshot()
    outs = {}
    for name, req in RT_QUERIES.items():
        req = dict(req, consistency="snapshot")
        t0 = time.perf_counter()
        outs[name] = rt.query(dict(req))
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again = rt.query(dict(req))
        cached = (time.perf_counter() - t0) * 1e3
        check(again is outs[name] or again == outs[name],
              f"snapshot {name}: first {first:.1f} ms, cached {cached:.2f} "
              f"ms, nrecs {outs[name]['nrecs']}")
        perf["snapshot_query_ms"][name] = {"first": first, "cached": cached}
    for sub in ("selfstats", "metrics"):
        t0 = time.perf_counter()
        out = rt.query({"subsys": sub, "consistency": "snapshot"})
        ms = (time.perf_counter() - t0) * 1e3
        perf["snapshot_query_ms"][sub] = {"first": ms}
        check(("counters" in out and out["counters"]["snapshots_published"]
               >= 1) if sub == "selfstats" else
              "gyt_snapshot_tick" in out["text"], f"{sub}: {ms:.1f} ms")
    multi = [dict(r, consistency="snapshot")
             for r in list(RT_QUERIES.values())[:16]]
    t0 = time.perf_counter()
    mq = rt.query({"multiquery": multi})
    perf["snapshot_query_ms"]["multiquery16"] = {
        "first": (time.perf_counter() - t0) * 1e3}
    check(mq["nqueries"] == 16 and all("error" not in r
                                       for r in mq["multiquery"]),
          f"a 16-wide multiquery: "
          f"{perf['snapshot_query_ms']['multiquery16']['first']:.1f} ms")
    check(outs["svcstate"]["ntotal"] == sim.n_hosts * sim.n_svcs,
          f"snapshot svcstate: {outs['svcstate']['ntotal']} services")
    # isolation: a feed after the publish moves the strong answer only
    req = {"subsys": "svcstate", "maxrecs": 100000}
    before = rt.query(dict(req, consistency="snapshot"))
    strong = rt.query(req)
    rt.feed(mixed_dispatch(wire, allrecs, 1))
    snap.on_mutation()
    after = rt.query(dict(req, consistency="snapshot"))
    moved = rt.query(req)
    check(rt.snapshot is snap and after == before,
          "snapshot isolation: the snapshot's svcstate JSON, re-rendered "
          "after one more delta dispatch, is unchanged")
    check(moved != strong, "... while the strong svcstate JSON moved")
    perf["max_memory_allocated_gib"] = \
        torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory: {perf['max_memory_allocated_gib']:.3f} GiB")
    del rt, snap
    gc.collect()
    torch.cuda.empty_cache()

    # ---- card vs CPU, tiny delta stream
    log("  tiny delta stream, card vs CPU")
    g_rt, g_rep, g_snaps, fed_vals = tiny_delta_run(DEV)
    c_rt, c_rep, c_snaps, _ = tiny_delta_run("cpu")
    tcfg = c_rt.cfg
    moved = {k: _moved(torch, loghist, getattr(tcfg, k), v)
             for k, v in fed_vals.items()}
    log(f"  loghist inputs whose bucket CUDA's logf moves: {moved}")
    check(g_rep == c_rep, f"tick reports equal: {g_rep}")
    n_exact, n_close = _compare_leaves(
        tree_paths(aggstate.init(tcfg, "meta")),
        aggstate.state_to_numpy(c_rt.state),
        aggstate.state_to_numpy(g_rt.state), moved)
    check(n_exact + n_close == 85, f"AggState: 85 leaves agree ({n_exact} "
          f"exactly, {n_close} within tolerance)")
    n_exact, n_close = _compare_leaves(
        tree_paths(depgraph.init(1, 1, "meta")),
        depgraph.dep_to_numpy(c_rt.dep), depgraph.dep_to_numpy(g_rt.dep),
        {})
    check(n_exact + n_close == 29, f"DepGraph: 29 leaves agree ({n_exact} "
          f"exactly, {n_close} within tolerance)")
    n_q = [0, 0]
    for t, (cs, gs) in enumerate(zip(c_snaps, g_snaps)):
        for name in cs:
            _json_diff(torch, loghist, tcfg, cs[name], gs[name], moved,
                       f"{name}@{t}", n_q)
    cc = {k: v for k, v in c_rt.stats.counters.items()
          if k.startswith(("preagg_", "spool_", "agent_"))}
    check(cc and cc == {k: g_rt.stats.counters[k] for k in cc},
          f"delta and agent counters equal: {cc}")
    check(True, f"snapshot JSON of {len(c_snaps[0])} subsystems after each "
          f"of 4 ticks agrees card vs CPU ({n_q[0]} quantiles one loghist "
          f"bucket apart, {n_q[1]} values one unit apart in the third "
          "decimal)")
    perf["tiny_json_bucket_apart"], perf["tiny_json_rounding_apart"] = n_q
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 9: {perf['phase_s']:.1f}s")
    return perf, launches, sites


# ----------------------------------------------------------- phase 10
# measured ticks: 1 since phase 16 came (4 before), with a window of a
# tick (2 before): the same two shards, at the warm-up tick and the
# measured one, over a WAL of 2 ticks instead of 5, which cuts what
# phases 10 and 12a replay
HIST_TICKS = 1
# feed buffers a measured tick: 2 since phase 15 came (4 since phase 14
# came, 8 before), which cuts the WAL that phases 10 and 12a replay
HIST_BUFFERS = 2
# the deflate sample: every 1,024th MB block of each shard leaf (1/256
# before phase 16 came, 1/64 before phase 15)
HIST_DEFLATE_STRIDE = 1024
HIST_WINDOW = 1             # hist_window_ticks: shards at ticks 1 and 2
HIST_ALERT_OPS = (
    {"op": "add", "objtype": "alertdef", "alertname": "host_issue_db",
     "subsys": "hoststate", "mode": "db", "querysec": 60.0,
     "filter": "{ hoststate.nprocissue > 0 }"},
    {"op": "add", "objtype": "alertdef", "alertname": "svc_busy_1h",
     "subsys": "svcstate", "window": "1h",
     "filter": "{ svcstate.qps5s > 45 }"},
)
# at= the newest window's end against the live JSON then, rows matched
# by these keys
HIST_AT_REQS = {
    "svcstate": ({"subsys": "svcstate", "maxrecs": 5000}, ("svcid",)),
    "topk": ({"subsys": "topk", "maxrecs": 200}, ("metric", "id")),
    "flowstate": ({"subsys": "flowstate", "maxrecs": 500}, ("flowid",)),
    "svcdependency": ({"subsys": "svcdependency", "maxrecs": 5000},
                      ("cliid", "serid")),
}
HIST_WINDOW_REQS = {
    "svcstate": {"subsys": "svcstate", "window": "1h", "maxrecs": 1000},
    "topk": {"subsys": "topk", "window": "1h", "maxrecs": 100},
    "svcstate p99resp5s": {"subsys": "svcstate", "window": "1h",
                           "maxrecs": 100, "sortcol": "p99resp5s",
                           "columns": ["svcid", "svcname", "p99resp5s"]},
}
# the stream of tests/test_torch_history.py (card vs CPU)
TINY_HIST_CFG = dict(n_hosts=8, svc_capacity=64, task_capacity=64,
                     conn_batch=128, resp_batch=256, fold_k=2)
TINY_HIST_OPTS = dict(hist_window_ticks=2, history_every_ticks=1,
                      dep_pair_capacity=1024, dep_edge_capacity=512)
TINY_HIST_AT = ("svcstate", "topk", "flowstate", "svcdependency",
                "taskstate", "tracereq", "hoststate", "cpumem",
                "clusterstate", "svcsumm", "activeconn", "clientconn")
TINY_HIST_WINDOW = ("svcstate", "tracereq", "taskstate", "topk",
                    "hoststate", "clusterstate", "cpumem")


def _keyed(recs, keys):
    """Rows sorted by their key fields: card and replay may order rows
    whose float values are one ulp apart differently."""
    return sorted(recs, key=lambda r: tuple(str(r.get(k)) for k in keys))


def _device_leaf_check(torch, name, live, shard, mass) -> str:
    """A shard leaf against the live leaf on the card → "exact", "close"
    or what differs. Integer, bool and the max-merged sample leaves must
    be exact; float sums (atomics in no fixed order) within rtol 1e-6,
    digest centroids rtol 1e-5. ``inv.prio`` is a max of CMS estimates,
    float sums themselves: rtol 1e-6 too. The top-K's evicted mass goes
    by the reference's mass rule (rtol 1e-5 of the top-K mass: it is a
    difference of two float sums)."""
    if live.shape != shard.shape or live.dtype != shard.dtype:
        return (f"{tuple(live.shape)}/{live.dtype} vs "
                f"{tuple(shard.shape)}/{shard.dtype}")
    if torch.equal(live, shard):
        return "exact"
    n = int((live != shard).sum())
    if not live.is_floating_point() or name in (
            "svc_td.vmin", "svc_td.vmax", "h_bytes"):
        return f"{n} of {live.numel()} elements differ"
    if name == "flow_topk.evicted":
        # a stacked (n_shards,) leaf goes shard by shard, ``mass`` then
        # each shard's top-K mass
        apart = (live.double() - shard.double()).abs()
        ok = bool((apart <= 1e-5 * torch.as_tensor(
            mass, dtype=torch.float64, device=live.device)).all())
    else:
        rtol = 1e-5 if name.startswith("svc_td.") else 1e-6
        ok = torch.allclose(shard, live, rtol=rtol, atol=0.0)
    return "close" if ok else f"{n} elements beyond the tolerance"


def _leaf_crcs(path) -> dict:
    """{member: (CRC-32, size)} of a shard file's state (``s<i>``) and
    dependency (``d<i>``) leaves, from the zip's central directory: the
    CRC-32 of each leaf's uncompressed ``.npy`` bytes, header (dtype and
    shape) and data, read without inflating anything."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {i.filename[:-4]: (i.CRC, i.file_size) for i in z.infolist()
                if i.filename[:1] in "sd" and i.filename[1:-4].isdigit()}


def shard_leaf_verdicts(torch, names, nstate, path_a, path_b, dev) -> dict:
    """The state and dependency leaves of two shard files, leaf by leaf
    → {name: verdict of ``_device_leaf_check``}. A leaf whose
    uncompressed bytes have the same CRC-32 and length in both files is
    "exact" without inflating it; every other leaf is inflated from both
    files and held to the rule on ``dev`` (the top-K mass from ``a``).
    Most of a north-star shard's 6 GiB are integer leaves that agree, so
    the comparison inflates megabytes instead of gigabytes."""
    ca, cb = _leaf_crcs(path_a), _leaf_crcs(path_b)
    members = [f"s{i}" for i in range(nstate)] + \
        [f"d{i}" for i in range(len(names) - nstate)]
    out, diff = {}, []
    for name, m in zip(names, members):
        if m in ca and ca[m] == cb.get(m):
            out[name] = "exact"
        else:
            diff.append((name, m))
    if not diff:
        return out
    with np.load(path_a) as za, np.load(path_b) as zb:
        ev = f"s{names.index('flow_topk.evicted')}"
        cnt = f"s{names.index('flow_topk.counts')}"
        mass = float(za[ev]) + float(za[cnt].sum())
        for name, m in diff:
            if m not in za.files or m not in zb.files:
                out[name] = f"member {m} missing"
                continue
            out[name] = _device_leaf_check(
                torch, name, torch.from_numpy(za[m]).to(dev),
                torch.from_numpy(zb[m]).to(dev), mass)
    return out


def _sum_field_apart(k, ref_row, got_row, mass) -> bool:
    """``errbound`` (a row's ``value`` − its exact count) and
    ``evictedbytes`` (the top-K's evicted mass) are differences of float
    sums, so their rounding scales with the operands: True when
    ``got_row[k]`` is within 1e-6 of the row's ``value``, or for
    ``evictedbytes`` within 1e-5 of the top-K mass ``mass`` (the
    reference's mass rule), of ``ref_row[k]``; raises otherwise."""
    a, b = ref_row[k], got_row[k]
    tol = 1e-5 * mass if k == "evictedbytes" else \
        1e-6 * max(abs(ref_row["value"]), abs(got_row["value"]))
    if abs(a - b) > tol:
        raise AssertionError(f"{k}: {a} vs {b}")
    return True


def _sum_json_diff(ref, got, path, n_apart, mass) -> None:
    """Shard JSON against live JSON on the card: strings and bools
    exact; a number equal, or else counted in ``n_apart``: within rtol
    1e-6 (``[0]``: a value read off CMS counts or other float sums that
    atomics added in another order, integers such as topk's ``value``
    included; ``errbound`` and ``evictedbytes`` by
    :func:`_sum_field_apart`), or 0.001 apart where both are rounded to
    the JSON's three decimals (``[1]``)."""
    if isinstance(ref, dict):
        if set(ref) != set(got):
            raise AssertionError(f"{path}: keys {set(ref) ^ set(got)}")
        for k in ref:
            if k in ("errbound", "evictedbytes") and ref[k] != got[k]:
                n_apart[0] += _sum_field_apart(k, ref, got, mass)
            else:
                _sum_json_diff(ref[k], got[k], f"{path}.{k}", n_apart, mass)
    elif isinstance(ref, list):
        if len(ref) != len(got):
            raise AssertionError(f"{path}: {len(ref)} vs {len(got)} rows")
        for i, (a, b) in enumerate(zip(ref, got)):
            _sum_json_diff(a, b, f"{path}[{i}]", n_apart, mass)
    elif ref == got and type(ref) is type(got):
        return
    elif (isinstance(ref, (int, float)) and isinstance(got, (int, float))
          and not isinstance(ref, bool) and not isinstance(got, bool)):
        if math.isclose(ref, got, rel_tol=1e-6, abs_tol=0.0):
            n_apart[0] += 1
        elif (round(ref, 3) == ref and round(got, 3) == got
              and abs(ref - got) <= 0.0010001):
            n_apart[1] += 1
        else:
            raise AssertionError(f"{path}: {ref} vs {got}")
    else:
        raise AssertionError(f"{path}: {ref!r} vs {got!r}")


def _settle_sum_fields(ref, got, mass, n_apart):
    """A copy of ``got`` whose ``errbound`` / ``evictedbytes`` values
    that differ from ``ref``'s within :func:`_sum_field_apart`'s rules
    are ``ref``'s (counted in ``n_apart``), for :func:`_json_diff` to
    compare the rest."""
    if isinstance(ref, dict) and isinstance(got, dict):
        out = {}
        for k, v in got.items():
            if (k in ("errbound", "evictedbytes") and k in ref
                    and ref[k] != v):
                n_apart[0] += _sum_field_apart(k, ref, got, mass)
                out[k] = ref[k]
            else:
                out[k] = _settle_sum_fields(ref.get(k), v, mass, n_apart)
        return out
    if isinstance(ref, list) and isinstance(got, list):
        return [_settle_sum_fields(a, b, mass, n_apart)
                for a, b in zip(ref, got)] + got[len(ref):]
    return got


def deflate_rates(leaves, stride: int = 64, block: int = 1 << 20) -> dict:
    """zlib's deflate at level 6 (``np.savez_compressed``'s, the
    reference's shard writer) and level 1 (the port's) over a sample of
    a shard's leaves: every ``stride``-th ``block`` bytes of each leaf →
    {level: {"mb_per_s", "ratio"}} and the sample's MB."""
    import zlib

    blocks = []
    for leaf in leaves:
        raw = memoryview(np.ascontiguousarray(leaf)).cast("B")
        blocks += [raw[i:i + block] for i in range(0, len(raw),
                                                   stride * block)]
    n = sum(len(b) for b in blocks)
    out = {"sample_mb": n / 1e6}
    for level in (6, 1):
        t0 = time.perf_counter()
        z = sum(len(zlib.compress(b, level)) for b in blocks)
        dt = time.perf_counter() - t0
        out[level] = {"mb_per_s": n / 1e6 / dt, "ratio": n / max(z, 1)}
    return out


def tiny_hist_stream(sim, wire):
    """Names, then the four ticks of tests/test_torch_history.py."""
    return sim.name_frames(), [
        sim.conn_frames(256) + sim.resp_frames(512)
        + sim.listener_frames() + sim.task_frames()
        + wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                     sim.host_state_records())
        + wire.encode_frames_chunked(wire.NOTIFY_CPU_MEM_STATE,
                                     sim.cpu_mem_records(hot_cpu=[t % 8]))
        + sim.trace_frames(128) for t in range(4)]


def tiny_hist_run(device, tmp):
    """The history tests' stream through ``Runtime(device=...)`` with the
    journal, shards, sqlite history and a checkpoint every second tick,
    on a clock of 5 s a tick; a compaction; every at=, window= and
    tstart request; then a checkpoint → restore → replay_journal
    recovery beside a runtime that restored and was fed directly →
    dict of what card and CPU must agree on."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.history.compactor import Compactor
    from gyeeta_tpu_torch.ingest import decode, wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    cfg = aggstate.EngineCfg(**TINY_HIST_CFG)
    now = [1.7e9]
    tmp.mkdir(parents=True)
    opts = RuntimeOpts(**TINY_HIST_OPTS, journal_dir=str(tmp / "wal"),
                       hist_shard_dir=str(tmp / "shards"),
                       history_db=str(tmp / "h.db"),
                       checkpoint_dir=str(tmp / "ck"),
                       checkpoint_every_ticks=2)
    rt = Runtime(cfg, opts, clock=lambda: now[0], device=device)
    out = {"reports": []}
    try:
        names, bufs = tiny_hist_stream(ParthaSim(n_hosts=8, n_svcs=4,
                                                 seed=7), wire)
        # the loghist inputs, whose buckets CUDA's logf may move
        fed = {"resp_spec": [], "apiresp_spec": [], "taskcpu_spec": [],
               "qps_spec": [], "active_spec": []}
        for buf in bufs:
            recs, _, _ = wire.drain2(buf)
            tr = recs[wire.NOTIFY_REQ_TRACE]
            fed["resp_spec"] += [recs[wire.NOTIFY_RESP_SAMPLE]["resp_usec"],
                                 tr["resp_usec"]]
            fed["apiresp_spec"].append(tr["resp_usec"])
            tb = decode.task_batch(recs[wire.NOTIFY_AGGR_TASK_STATE], 4096)
            fed["taskcpu_spec"].append(
                tb.stats[tb.valid, decode.TASK_CPU_PCT])
            lb = decode.listener_batch(recs[wire.NOTIFY_LISTENER_STATE],
                                       4096)
            fed["qps_spec"].append(
                lb.stats[lb.valid, decode.STAT_NQRYS] / 5.0)
            fed["active_spec"].append(
                lb.stats[lb.valid, decode.STAT_NCONNS_ACTIVE])
        out["fed"] = {k: np.concatenate(v).astype(np.float32)
                      for k, v in fed.items()}
        rt.feed(names)
        for buf in bufs:
            rt.feed(buf, hid=3, conn_id=11)
            now[0] += 5.0
            rep = rt.run_tick()
            if "checkpoint" in rep:       # the file's name, not its dir
                rep["checkpoint"] = Path(rep["checkpoint"]).name
            out["reports"].append(rep)
        post = bufs[0]                    # after the last checkpoint
        rt.feed(post, hid=4)
        rt.flush()
        out["live"] = (aggstate.state_to_numpy(rt.state),
                       depgraph.dep_to_numpy(rt.dep))
        rt.journal.fsync()
        c = Compactor(cfg, opts, journal=rt.journal, stats=rt.stats,
                      clock=lambda: now[0], device=device)
        try:
            out["compact"] = c.compact_once(seal=True, upto_tick=4)
            ent = [e for e in c.store.shards("raw") if e["tick1"] == 4][0]
            data = c.store.load(ent)
            out["shard"] = (data["state"], data["dep"])
            out["shards"] = c.store.shards()
        finally:
            c.close()
        reqs = {f"at {s}": {"subsys": s, "at": "tick:4", "maxrecs": 10000}
                for s in TINY_HIST_AT}
        reqs |= {f"window {s}": {"subsys": s, "window": "1h",
                                 "maxrecs": 10000}
                 for s in TINY_HIST_WINDOW}
        reqs |= {"tstart svcstate": {"subsys": "svcstate", "tstart": 0},
                 "tstart hoststate aggr": {
                     "subsys": "hoststate", "tstart": 0, "tend": 4e9,
                     "aggr": ["count(*) as n", "max(nprocissue)"],
                     "groupby": ["hostid"]}}
        out["json"] = {k: rt.query(dict(r)) for k, r in reqs.items()}
    finally:
        rt.close()
    ck = tmp / "ck" / "gyt_ckpt_00000004.npz"
    rt2 = Runtime(cfg, opts._replace(checkpoint_dir=None,
                                     hist_shard_dir=None, history_db=None),
                  clock=lambda: now[0], device=device)
    rt3 = Runtime(cfg, RuntimeOpts(**TINY_HIST_OPTS), clock=lambda: now[0],
                  device=device)
    try:
        ext = rt2.restore(ck)
        out["replay"] = rt2.replay_journal(ext["wal"])
        rt3.restore(ck)
        rt3.feed(post, hid=4)
        rt3.flush()
        out["recovered"] = (aggstate.state_to_numpy(rt2.state),
                            depgraph.dep_to_numpy(rt2.dep))
        out["direct"] = depgraph.dep_to_numpy(rt3.dep)
    finally:
        rt2.close()
        rt3.close()
    return out


def history_phase(torch, scatter, frames, rt_perf, tmp):
    """History and the journal at ns geometry through the Runtime's entry
    points: feed with the WAL on, ticks with the history sweep into
    sqlite, a compaction whose replay runtime re-folds the WAL on the
    card, the shard against the live state, at=/window=/tstart queries,
    db-mode and windowed alertdefs; then the history tests' stream card
    vs CPU, recovery included. The WAL and the shards are written under
    ``tmp`` (the caller's, which phase 12 ships and the caller removes).
    → (perf, launches, the runtime's options)."""
    import shutil
    import sqlite3
    import tempfile

    from gyeeta_tpu_torch.engine import aggstate, step
    from gyeeta_tpu_torch.history.compactor import Compactor
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    from gyeeta_tpu_torch.utils.tensor import tree_leaves, tree_map, \
        tree_paths

    t_phase = time.perf_counter()
    cfg = aggstate.EngineCfg(**NS_CFG)
    names, sweeps, bufs, n_svcs = frames
    perf = {}
    log(f"phase 10: history and the journal at north-star geometry: "
        f"journal, shards (hist_window_ticks={HIST_WINDOW}) and sqlite "
        f"history (history_every_ticks=1) under {tmp}")
    torch.cuda.reset_peak_memory_stats()
    opts = RuntimeOpts(**RT_OPTS, journal_dir=str(tmp / "wal"),
                       hist_shard_dir=str(tmp / "shards"),
                       history_db=str(tmp / "history.db"),
                       hist_window_ticks=HIST_WINDOW,
                       history_every_ticks=1)
    rt = Runtime(cfg, opts, device=DEV)
    t0 = time.perf_counter()
    rt.feed(names)
    rt.feed(sweeps[0])
    for i in range(RT_WARM_BUFFERS):
        rt.feed(bufs[i % RT_DISTINCT][0])
    rt.run_tick()
    torch.cuda.synchronize()
    log(f"  warm-up tick: {time.perf_counter() - t0:.2f}s")
    tick_parts = SyncTimer(torch, (
        (rt, "_history_sweep", "history_sweep"),
        (rt, "publish_snapshot", "publish_snapshot"),
        (rt, "_alert_step", "alert_step"),
        (rt, "heavy_recover", "heavy_recover")))
    perf.update(buffer_ms=[], sweep_s=[], tick_ms=[], tick_parts_ms=[],
                history_rows=[])
    live4 = live4_json = None
    j = RT_WARM_BUFFERS
    for tick in range(HIST_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.feed(sweeps[1 + tick % (len(sweeps) - 1)])
        torch.cuda.synchronize()
        perf["sweep_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(HIST_BUFFERS):
            rt.feed(bufs[j % RT_DISTINCT][0])
            j += 1
        torch.cuda.synchronize()
        perf["buffer_ms"].append((time.perf_counter() - t0)
                                 / HIST_BUFFERS * 1e3)
        t0 = time.perf_counter()
        with tick_parts:
            rep = rt.run_tick()
        torch.cuda.synchronize()
        perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        perf["tick_parts_ms"].append(dict(tick_parts.ms))
        tick_parts.ms = {}
        perf["history_rows"].append(rep["history_rows"])
        if rep["tick"] == 2 * HIST_WINDOW:
            # the live state and JSON at the newest window's end
            live4 = (tree_map(torch.clone, rt.state),
                     tree_map(torch.clone, rt.dep))
            live4_json = {k: rt.query(dict(r))
                          for k, (r, _) in HIST_AT_REQS.items()}
    check(live4 is not None, f"ticks ran to {rt._tick_no}, past the "
          f"window end at tick {2 * HIST_WINDOW}")
    log(f"  ms per feed buffer with the journal on, by tick: "
        f"{', '.join(f'{m:.3f}' for m in perf['buffer_ms'])} (phase 8, "
        f"no journal: {', '.join(f'{m:.3f}' for m in rt_perf)})")
    log(f"  sweep feed (s): "
        f"{', '.join(f'{s:.3f}' for s in perf['sweep_s'])}")
    log(f"  ms per run_tick: "
        f"{', '.join(f'{m:.2f}' for m in perf['tick_ms'])}; parts "
        "(synchronised): " + " | ".join(
            ", ".join(f"{k} {v:.2f}" for k, v in p.items())
            for p in perf["tick_parts_ms"])
        + f"; history_rows {perf['history_rows']}")
    check(all(r > n_svcs for r in perf["history_rows"]),
          f"each tick's history sweep wrote svcstate, taskstate and "
          f"the rest: {perf['history_rows']} rows")
    rt.journal.fsync()
    g = rt.journal.gauges()
    c = rt.stats.counters
    perf["journal"] = g | {k: c.get(k, 0) for k in (
        "wal_appended_chunks", "wal_appended_bytes", "wal_fsyncs",
        "wal_rotations", "wal_backlog_dropped")}
    log(f"  journal: {perf['journal']}")
    check(perf["journal"]["wal_backlog_dropped"] == 0
          and g["journal_segments"] >= 1,
          "no WAL chunk dropped from the writer's backlog")
    replies = [rt.query(dict(o)) for o in HIST_ALERT_OPS]
    check(all(r.get("ok") for r in replies),
          "a db-mode and a windowed alertdef installed through \"op\"")

    # ---- compaction: the replay runtime re-folds the WAL, counted
    mods = sketch_modules()
    connresp = [0]
    fold_all = step.fold_all

    def counting_fold_all(*a, **kw):
        connresp[0] += kw.get("connresp") is not None
        return fold_all(*a, **kw)

    comp = Compactor(cfg, opts, journal=rt.journal, stats=rt.stats,
                     device=DEV)
    emit0 = rt.stats.timing_totals().get("compact_emit", (0, 0.0))
    reset_launches(scatter, mods)
    step.fold_all = counting_fold_all
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crep = comp.compact_once(seal=True, upto_tick=rt._tick_no)
        torch.cuda.synchronize()
        perf["compact_s"] = time.perf_counter() - t0
    finally:
        step.fold_all = fold_all
    launches = read_launches(scatter, mods)
    n_emit, emit_ms = rt.stats.timing_totals()["compact_emit"]
    shards = comp.store.shards("raw")
    perf["compact"] = crep
    perf["compact_replay_ev_per_sec"] = \
        rt.stats.gauges["compact_replay_ev_per_sec"]
    perf["compact_emit_ms"] = (emit_ms - emit0[1]) / max(
        n_emit - emit0[0], 1)
    perf["shard_bytes"] = [e["bytes"] for e in shards]
    perf["launches"] = launches
    perf["replay_connresp_dispatches"] = connresp[0]
    log(f"  compaction: {crep}; {perf['compact_s']:.2f}s, "
        f"compact_replay_ev_per_sec "
        f"{perf['compact_replay_ev_per_sec']}, compact_emit "
        f"{perf['compact_emit_ms']:.1f} ms a window, shard bytes "
        f"{perf['shard_bytes']}")
    log(f"  kernel launches during the compaction: {launches}")
    check(crep["windows"] == 2 and len(shards) == 2,
          f"two raw shards emitted (ticks {[e['tick1'] for e in shards]})")
    check(launches == path_launches(connresp[0]) and connresp[0] > 0,
          f"each of the replay's {connresp[0]} conn/resp dispatches "
          "launched hll_update 2x, cms_update 1x, inv_update 1x and the "
          "int32 scatter-add 1x")

    # ---- the newest raw shard against the live state, on the card
    ent = [e for e in shards if e["tick1"] == 2 * HIST_WINDOW][0]
    data = comp.store.load(ent)
    perf["deflate"] = deflate_rates(data["state"] + data["dep"],
                                    stride=HIST_DEFLATE_STRIDE)
    log(f"  deflate over a 1/{HIST_DEFLATE_STRIDE} block sample of the "
        f"shard's leaves "
        f"({perf['deflate']['sample_mb']:.0f} MB): level 6 (the "
        f"reference's savez_compressed) "
        f"{perf['deflate'][6]['mb_per_s']:.0f} MB/s, ratio "
        f"{perf['deflate'][6]['ratio']:.0f}; level 1 (the port's "
        f"shards) {perf['deflate'][1]['mb_per_s']:.0f} MB/s, ratio "
        f"{perf['deflate'][1]['ratio']:.0f}")
    s_state = aggstate.state_from_numpy(data["state"], DEV)
    s_dep = depgraph.dep_from_numpy(data["dep"], DEV)
    snames = tree_paths(aggstate.init(cfg, "meta"))
    dnames = tree_paths(depgraph.init(1, 1, "meta"))
    mass = float(live4[0].flow_topk.counts.sum()
                 + live4[0].flow_topk.evicted)
    kinds = {n: _device_leaf_check(torch, n, a, b, mass) for n, a, b in
             zip(snames + dnames,
                 tree_leaves(live4[0]) + tree_leaves(live4[1]),
                 tree_leaves(s_state) + tree_leaves(s_dep))}
    close = sorted(n for n, k in kinds.items() if k == "close")
    bad = {n: k for n, k in kinds.items() if k not in ("exact",
                                                       "close")}
    perf["shard_leaves_exact"] = len(kinds) - len(close) - len(bad)
    perf["shard_leaves_close"] = close
    log(f"  shard vs live, leaves within the float-sum rule: {close}")
    check(len(kinds) == 85 + 29 and not bad,
          f"shard at tick {ent['tick1']} = the live state then: "
          f"{perf['shard_leaves_exact']} of 114 leaves exact, "
          f"{len(close)} within the float-sum rule; differing: {bad}")
    del s_state, s_dep, data, live4

    # ---- historical queries, each group from a cold snapshot LRU
    # (its first request loads the shards from disk)
    rt.timeview._snaps.clear()
    perf["window_ms"] = {}
    for name, req in HIST_WINDOW_REQS.items():
        t0 = time.perf_counter()
        first = rt.query(dict(req))
        t1 = time.perf_counter()
        again = rt.query(dict(req))
        t2 = time.perf_counter()
        check(again == first and first["nrecs"] > 0
              and first["shards"] == 2,
              f"window= {name}: {first['nrecs']} rows over 2 shards, "
              f"first {(t1 - t0) * 1e3:.1f} ms, cached "
              f"{(t2 - t1) * 1e3:.1f} ms")
        perf["window_ms"][name] = {"first": (t1 - t0) * 1e3,
                                   "cached": (t2 - t1) * 1e3}
    rt.timeview._snaps.clear()
    n_q = [0, 0]
    perf["at_ms"] = {}
    at_json = {}              # the local store's answers, for phase 12a
    for name, (req, keys) in HIST_AT_REQS.items():
        req = dict(req, at=f"tick:{2 * HIST_WINDOW}")
        t0 = time.perf_counter()
        got = at_json[name] = rt.query(dict(req))
        t1 = time.perf_counter()
        again = rt.query(dict(req))
        perf["at_ms"][name] = {
            "first": (t1 - t0) * 1e3,
            "cached": (time.perf_counter() - t1) * 1e3}
        check(again == got, f"at= {name}: the cached answer equal")
        ref = live4_json[name]
        check(got["nrecs"] == ref["nrecs"] > 0,
              f"at=tick:{2 * HIST_WINDOW} {name}: {got['nrecs']} rows, "
              "as live")
        _sum_json_diff(_keyed(ref["recs"], keys),
                       _keyed(got["recs"], keys), f"at {name}", n_q,
                       mass)
    perf["at_json_sum_apart"], perf["at_json_rounding_apart"] = n_q
    # a second materialised snapshot: the state at the first window
    t0 = time.perf_counter()
    got = rt.query({"subsys": "topk", "at": f"tick:{HIST_WINDOW}"})
    perf["at_ms"][f"topk tick {HIST_WINDOW}"] = {
        "first": (time.perf_counter() - t0) * 1e3}
    check(got["nrecs"] > 0 and got["tick"] == HIST_WINDOW,
          f"at=tick:{HIST_WINDOW} topk: {got['nrecs']} rows")
    log(f"  at= ms: {perf['at_ms']}; JSON equal to the live JSON at "
        f"tick {2 * HIST_WINDOW} but {n_q[0]} values within rtol 1e-6 "
        f"(float sums) "
        f"and {n_q[1]} one unit apart in the third decimal")
    perf["peak_gib_two_snapshots"] = \
        torch.cuda.max_memory_allocated() / 2**30
    perf["allocated_gib_two_snapshots"] = \
        torch.cuda.memory_allocated() / 2**30
    log(f"  device memory with the compactor's replay runtime and two "
        f"materialised snapshots alive: "
        f"{perf['allocated_gib_two_snapshots']:.3f} GiB allocated, "
        f"peak {perf['peak_gib_two_snapshots']:.3f} GiB")
    perf["tstart_ms"] = {}
    for name, req in {
            "hoststate": {"subsys": "hoststate", "tstart": 0,
                          "maxrecs": 100000},
            "svcstate filter": {"subsys": "svcstate", "tstart": 0,
                                "filter": "{ svcstate.qps5s > 40 }",
                                "maxrecs": 1000000}}.items():
        t0 = time.perf_counter()
        got = rt.query(dict(req))
        perf["tstart_ms"][name] = (time.perf_counter() - t0) * 1e3
        subsys = req["subsys"]
        where = "WHERE qps5s > 40" if "filter" in req else ""
        with sqlite3.connect(tmp / "history.db") as db:
            tabs = [r[0] for r in db.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name LIKE ?", (f"{subsys}tbl_%",))]
            want = sum(db.execute(f"SELECT COUNT(*) FROM {t} {where}")
                       .fetchone()[0] for t in tabs)
        check(len(got["recs"]) == want > 0,
              f"tstart {name}: {len(got['recs'])} rows = sqlite's "
              f"count, {perf['tstart_ms'][name]:.1f} ms")

    # ---- the db-mode and windowed alertdefs fire at the next tick
    rt.feed(sweeps[1])
    t0 = time.perf_counter()
    rep = rt.run_tick()
    perf["alert_tick_ms"] = (time.perf_counter() - t0) * 1e3
    fired = {a.alertname for a in rt.alerts.alert_log}
    perf["alerts"] = dict(rt.alerts.stats)
    check({"host_issue_db", "svc_busy_1h"} <= fired
          and rt.alerts.stats["ndbchecks"] >= 1
          and rt.alerts.stats["nwindow_skipped"] == 0,
          f"the db-mode and the windowed alertdef fired "
          f"({rep['alerts_fired']} alerts at tick {rep['tick']}, "
          f"{perf['alert_tick_ms']:.1f} ms)")
    comp.close()
    rt.close()
    del rt, comp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- card vs CPU, the history tests' stream
    log("  tiny history stream, card vs CPU")
    tiny = Path(tempfile.mkdtemp(prefix="gyt_smoke_tiny_hist_"))
    try:
        g = tiny_hist_run(DEV, tiny / "card")
        c = tiny_hist_run("cpu", tiny / "cpu")
    finally:
        shutil.rmtree(tiny, ignore_errors=True)
    tcfg = aggstate.EngineCfg(**TINY_HIST_CFG)
    check(g["reports"] == c["reports"]
          and all(r["history_rows"] > 0 for r in c["reports"]),
          f"tick reports equal, history_rows included: {c['reports']}")
    check(g["compact"]["records"] == c["compact"]["records"]
          and [e["tick1"] for e in g["shards"]]
          == [e["tick1"] for e in c["shards"]] == [2, 4],
          f"compactions equal: {c['compact']['records']} records, shards "
          "at ticks 2 and 4")
    snames = tree_paths(aggstate.init(tcfg, "meta"))
    dnames = tree_paths(depgraph.init(1, 1, "meta"))
    moved = {k: _moved(torch, loghist, getattr(tcfg, k), v)
             for k, v in c["fed"].items()}
    log(f"  loghist inputs whose bucket CUDA's logf moves: {moved}")
    ev = snames.index("flow_topk.evicted")
    counts = snames.index("flow_topk.counts")
    for what, (cs, cd), (gs, gd) in (
            ("shard", c["shard"], g["shard"]),
            ("recovered", c["recovered"], g["recovered"])):
        # the top-K's evicted mass by the reference's mass rule (a
        # difference of two float sums, whose order CUDA and the CPU
        # choose differently); every other leaf by _compare_leaves
        mass = float(cs[ev]) + float(cs[counts].sum())
        check(abs(float(gs[ev]) - float(cs[ev])) <= 1e-5 * mass,
              f"{what} flow_topk.evicted card {float(gs[ev])} vs CPU "
              f"{float(cs[ev])}: within 1e-5 of the top-K mass {mass}")
        keep = [i for i in range(len(snames)) if i != ev]
        n_exact, n_close = _compare_leaves(
            [snames[i] for i in keep] + dnames,
            [cs[i] for i in keep] + cd, [gs[i] for i in keep] + gd, moved)
        n_close += 1
        check(n_exact + n_close == 114, f"{what} leaves card vs CPU: 114 "
              f"agree ({n_exact} exactly, {n_close} within tolerance)")
    for side, out in (("card", g), ("CPU", c)):
        for name, a, b in zip(snames, out["live"][0], out["recovered"][0]):
            np.testing.assert_array_equal(b, a, err_msg=f"{side} {name}")
        for name, a, b in zip(dnames, out["direct"], out["recovered"][1]):
            np.testing.assert_array_equal(b, a, err_msg=f"{side} {name}")
    check(g["replay"] == c["replay"] and c["replay"]["chunks"] > 0,
          f"checkpoint → restore → replay_journal ({c['replay']}) lands on "
          "the uninterrupted run's 85 state leaves, and on the 29 dependency "
          "leaves of a restore fed the same bytes directly, card and CPU")
    n_q, n_sum = [0, 0], [0]
    mass = float(c["shard"][0][ev]) + float(c["shard"][0][counts].sum())
    for name in c["json"]:
        got = _settle_sum_fields(c["json"][name], g["json"][name], mass,
                                 n_sum)
        _json_diff(torch, loghist, tcfg, c["json"][name], got, moved, name,
                   n_q)
    check(True, f"JSON of {len(c['json'])} at=, window= and tstart requests "
          f"agrees card vs CPU ({n_q[0]} quantiles one loghist bucket "
          f"apart, {n_q[1]} values one unit apart in the third decimal, "
          f"{n_sum[0]} errbound/evictedbytes values within their rules)")
    perf["tiny_json_bucket_apart"], perf["tiny_json_rounding_apart"] = n_q
    perf["tiny_json_sum_fields_apart"] = n_sum[0]
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 10: {perf['phase_s']:.1f}s")
    return perf, launches, opts, at_json


# ----------------------------------------------------------- phase 11
SRV_AGENTS = 8              # registered GYT event conns
SRV_TICKS = 1               # measured manual ticks (2 before phase 15)
SRV_BUFFERS = 16            # phase 8's feed buffers a measured tick
SRV_LOOP_S = 6.0            # the stretch under the server's own tick loop
SRV_LOOP_TICK_S = 1.0       # ... at this tick_interval
SRV_IDLE_S = 3.0            # ... with this idle deadline on every conn
SRV_CACHED_MIN = 100        # cached query samples an edge (for its p99)
SRV_NM = ("svcstate", "hoststate", "taskstate", "flowstate", "svcinfo",
          "alertdef", "serverstatus", "topk")
SRV_REST = ("svcstate", "hoststate", "clusterstate", "flowstate",
            "hostinfo", "svcsumm", "cpumem", "topk")
SRV_REF_CONNS = 4096        # the stock partha's TCP_CONN records
SRV_DECODE_REPS = 3         # native vs Python decode timing passes
SRV_TIMEOUT = 120.0         # every socket wait, seconds


def _w(coro, timeout=SRV_TIMEOUT):
    import asyncio
    return asyncio.wait_for(coro, timeout)


async def _until(pred, what, timeout=SRV_TIMEOUT):
    """Poll ``pred`` (the server folds on this thread's loop) until it
    holds; fails the phase on the deadline."""
    import asyncio
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.002)


def _pcts(ms) -> dict:
    """p50 and max of ``ms`` with their count; p99 only from at least
    ``SRV_CACHED_MIN`` samples (below that it is the max)."""
    out = {"p50": float(np.percentile(ms, 50)), "max": float(max(ms)),
           "n": len(ms)}
    if len(ms) >= SRV_CACHED_MIN:
        out["p99"] = float(np.percentile(ms, 99))
    return out


def _fmt_pcts(d) -> str:
    return (f"p50 {d['p50']:.1f}" + (f" p99 {d['p99']:.1f}" if "p99" in d
                                     else "")
            + f" max {d['max']:.1f} (n={d['n']})")


class _TickFailures(logging.Handler):
    """Collects the records the server's tick loop logs when a tick
    raises (it logs and carries on)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record):
        self.records.append(self.format(record))


class NMClient:
    """A stock node-webserver conn built from the port's own codecs
    (``ingest/refquery.py``): NM_CONNECT handshake, QUERY_WEB_JSON
    requests, chunked responses joined."""

    def __init__(self, RP, RQ):
        self.RP, self.RQ, self.seq = RP, RQ, 0

    async def connect(self, host, port) -> dict:
        import asyncio
        self.r, self.w = await _w(asyncio.open_connection(host, port))
        self.w.write(self.RQ.encode_nm_connect_cmd("chip-smoke-nm"))
        await _w(self.w.drain())
        resp = self.RQ.parse_nm_connect_resp(await _w(self.r.readexactly(
            self.RP.REF_HEADER_DT.itemsize
            + self.RQ.REF_NM_CONNECT_RESP_DT.itemsize)))
        check(resp["error_code"] == 0, "NM_CONNECT handshake accepted "
              f"(madhava {resp['madhava_name']})")
        return resp

    async def query(self, subsys: str) -> dict:
        RP, RQ = self.RP, self.RQ
        self.seq += 1
        # the qtype is the node's code or the subsystem's name
        self.w.write(RQ.encode_query_cmd(self.seq, RQ.REF_QUERY_WEB_JSON,
                                         {"qtype": subsys}))
        await _w(self.w.drain())
        chunks, hsz = [], RP.REF_HEADER_DT.itemsize
        while True:
            hdr = np.frombuffer(await _w(self.r.readexactly(hsz)),
                                RP.REF_HEADER_DT, count=1)[0]
            body = await _w(self.r.readexactly(int(hdr["total_sz"]) - hsz))
            body = body[: len(body) - int(hdr["padding_sz"])]
            sid, rtype, done, chunk = RQ.parse_response_chunk(body)
            if sid != self.seq or rtype == RQ.REF_RESP_ERROR:
                raise AssertionError(f"NM {subsys}: seqid {sid} of "
                                     f"{self.seq}, resptype {rtype}")
            chunks.append(chunk)
            if done:
                return json.loads(b"".join(chunks))

    def close(self) -> None:
        self.w.close()


async def _http_query(host, port, req) -> dict:
    import asyncio
    r, w = await _w(asyncio.open_connection(host, port))
    try:
        body = json.dumps(req).encode()
        w.write(b"POST /query HTTP/1.1\r\nHost: gyt\r\nConnection: close"
                b"\r\n" + f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body)
        await _w(w.drain())
        raw = await _w(r.read(-1))
    finally:
        w.close()
    head, _, rbody = raw.partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n")[0]:
        raise AssertionError(f"REST {req}: {head[:80]}")
    return json.loads(rbody)


def ref_partha_frames(RP, glob_ids, n_conn: int) -> bytes:
    """A stock partha's NOTIFY stream built from the port's ``REF_*_DT``
    dtypes: NEW_LISTENER and LISTENER_STATE for a few services,
    ``n_conn`` TCP_CONN records to them (accepted, closed)."""
    def frame(subtype, recs):
        body = recs.tobytes()
        hsz, esz = RP.REF_HEADER_DT.itemsize, RP.REF_EVENT_NOTIFY_DT.itemsize
        total = (hsz + esz + len(body) + 7) & ~7
        hdr = np.zeros((), RP.REF_HEADER_DT)
        hdr["magic"], hdr["total_sz"] = RP.REF_MAGIC_PM, total
        hdr["data_type"] = RP.REF_COMM_EVENT_NOTIFY
        hdr["padding_sz"] = total - hsz - esz - len(body)
        ev = np.zeros((), RP.REF_EVENT_NOTIFY_DT)
        ev["subtype"], ev["nevents"] = subtype, len(recs)
        return hdr.tobytes() + ev.tobytes() + body \
            + b"\x00" * int(hdr["padding_sz"])

    for dt in (RP.REF_TCP_CONN_DT, RP.REF_NEW_LISTENER_DT,
               RP.REF_LISTENER_STATE_DT):
        if dt.itemsize % 8:           # records carry no padding here
            raise AssertionError(f"a REF record of {dt.itemsize} bytes")
    gids = np.asarray(glob_ids, np.uint64)
    nl = np.zeros(len(gids), RP.REF_NEW_LISTENER_DT)
    nl["ns_ip_port"]["aftype"] = RP.AF_INET
    nl["ns_ip_port"]["ip32_be"] = np.arange(len(gids)) + 0x0A0000C8
    nl["ns_ip_port"]["port"] = 8080
    nl["glob_id"] = nl["related_listen_id"] = gids
    nl["comm"] = b"stock-svc"
    ls = np.zeros(len(gids), RP.REF_LISTENER_STATE_DT)
    ls["glob_id"], ls["nqrys_5s"], ls["nconns"] = gids, 50, 4
    ls["curr_state"] = 2
    rng = np.random.default_rng(17)
    cn = np.zeros(n_conn, RP.REF_TCP_CONN_DT)
    for side, base in (("cli", 0x0A010000), ("ser", 0x0A0000C8)):
        cn[side]["aftype"] = RP.AF_INET
        cn[side]["ip32_be"] = base + rng.integers(0, 200, n_conn)
    cn["cli"]["port"] = rng.integers(20000, 60000, n_conn)
    cn["ser"]["port"] = 8080
    cn["tusec_start"] = 1_700_000_000_000_000
    cn["tusec_close"] = cn["tusec_start"] + rng.integers(100, 10 ** 6,
                                                         n_conn)
    cn["ser_glob_id"] = gids[rng.integers(0, len(gids), n_conn)]
    cn["ser_related_listen_id"] = cn["ser_glob_id"]
    cn["bytes_sent"] = rng.integers(100, 10 ** 6, n_conn)
    cn["bytes_rcvd"] = rng.integers(100, 10 ** 5, n_conn)
    cn["is_accept"] = True
    out = frame(RP.REF_NOTIFY_NEW_LISTENER, nl) \
        + frame(RP.REF_NOTIFY_LISTENER_STATE, ls)
    step_ = 2048
    for i in range(0, n_conn, step_):
        out += frame(RP.REF_NOTIFY_TCP_CONN, cn[i:i + step_])
    return out


def decode_paths(torch, bufs, cfg) -> dict:
    """ms per feed buffer of the native and the Python deframe plus the
    conn/resp slab decode into pinned staging columns, on phase 8's
    buffers; the two outputs held bit-equal."""
    from gyeeta_tpu_torch.ingest import decode, native, wire
    K = cfg.fold_k
    pin = DEV == "cuda"
    cols = {p: (decode.alloc_conn_cols(K * cfg.conn_batch, pin),
                decode.alloc_resp_cols(K * cfg.resp_batch, pin))
            for p in ("native", "python")}
    ms = {"native": [], "python": []}
    for rep in range(SRV_DECODE_REPS):
        for buf, _, _ in bufs:
            outs = {}
            for path, drain in (("native", native.drain2),
                                ("python", wire.drain2)):
                cc, rc = cols[path]
                t0 = time.perf_counter()
                recs, consumed, _ = drain(buf)
                cb = decode.conn_slab(recs[wire.NOTIFY_TCP_CONN], K,
                                      cfg.conn_batch, out=cc,
                                      clear_to=len(cc["valid"]),
                                      native=path == "native")
                rb = decode.resp_slab(recs[wire.NOTIFY_RESP_SAMPLE], K,
                                      cfg.resp_batch, out=rc,
                                      clear_to=len(rc["valid"]),
                                      native=path == "native")
                ms[path].append((time.perf_counter() - t0) * 1e3)
                outs[path] = ({k: v.tobytes() for k, v in recs.items()},
                              consumed, [c.tobytes() for c in cb + rb])
            if outs["native"] != outs["python"]:
                raise AssertionError("native and Python deframe+decode "
                                     "disagree on a feed buffer")
    check(True, f"native and Python deframe + slab decode bit-equal on "
          f"{len(bufs)} feed buffers x {SRV_DECODE_REPS}")
    return {p: float(np.median(v)) for p, v in ms.items()}


async def _register_agents(register, wire, host, port, n):
    conns = []
    for i in range(n):
        r, w, status, hid = await _w(register(
            host, port, 0x5E0000 + i, wire.CONN_EVENT))
        if status != wire.REG_OK:
            raise AssertionError(f"agent {i} registration status {status}")
        conns.append((r, w, hid))
    return conns


async def _send(w, buf) -> None:
    w.write(buf)
    await _w(w.drain())


async def serving_run(torch, scatter, frames, rt_perf) -> tuple:
    """The port's GytServer over an ns-geometry Runtime on the card, fed
    over loopback TCP (see serving_phase)."""
    import asyncio

    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import refproto as RP
    from gyeeta_tpu_torch.ingest import refquery as RQ
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import QueryClient, register
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.net.subs import SubscribeClient
    from gyeeta_tpu_torch.net.webgw import WebGateway
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    names, sweeps, bufs, n_svcs = frames
    cfg = aggstate.EngineCfg(**NS_CFG)
    perf = {"decode_ms_per_buffer": decode_paths(torch, bufs, cfg)}
    log("  deframe + slab decode ms per feed buffer: native "
        f"{perf['decode_ms_per_buffer']['native']:.2f}, Python "
        f"{perf['decode_ms_per_buffer']['python']:.2f}")
    ev_buf = cfg.fold_k * (cfg.conn_batch + cfg.resp_batch)
    mods = sketch_modules()
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(cfg, RuntimeOpts(**RT_OPTS), device=DEV)
    # idle_timeout 0 until the tick-loop stretch: the agents wait
    # through the manual ticks' measurements and the queries
    srv = GytServer(rt, host="127.0.0.1", port=0, tick_interval=None,
                    idle_timeout=0)
    ctr = rt.stats.counters
    conns, qc, nm, sc, gw = [], None, None, None, None
    tick_log = _TickFailures()
    logging.getLogger("gyeeta_tpu_torch.net").addHandler(tick_log)
    try:
        host, port = await _w(srv.start())
        conns = await _register_agents(register, wire, host, port,
                                       SRV_AGENTS)
        check(sorted(h for _, _, h in conns) == list(range(SRV_AGENTS)),
              f"{SRV_AGENTS} agents registered with host ids 0..7")
        fed = {"conn": 0, "resp": 0}

        async def feed_buffers(n, j0):
            """n feed buffers, round robin over the agents' conns, each
            conn's writes in order; → once all are folded."""
            tgt_c, tgt_r = fed["conn"], fed["resp"]
            sends = [[] for _ in conns]
            for i in range(n):
                buf, nc, nr = bufs[(j0 + i) % len(bufs)]
                sends[i % len(conns)].append(buf)
                tgt_c += nc
                tgt_r += nr

            async def one(w, bl):
                for b in bl:
                    await _send(w, b)
            await asyncio.gather(*(one(w, bl) for (_, w, _), bl
                                   in zip(conns, sends)))
            await _until(lambda: ctr.get("conn_events", 0) >= tgt_c
                         and ctr.get("resp_events", 0) >= tgt_r,
                         f"{n} feed buffers folded")
            fed["conn"], fed["resp"] = tgt_c, tgt_r

        # warm-up tick: names, a sweep, two buffers (counted events
        # include the sweep's VIP flows)
        t0 = time.perf_counter()
        w0 = conns[0][1]
        await _send(w0, names)
        c0 = ctr.get("conn_events", 0)
        await _send(w0, sweeps[0])
        await _until(lambda: ctr.get("conn_events", 0) >= c0 + RT_NAT_FLOWS,
                     "the warm-up sweep")
        fed["conn"], fed["resp"] = ctr["conn_events"], ctr.get(
            "resp_events", 0)
        await feed_buffers(RT_WARM_BUFFERS, 0)
        srv._feed_barrier()
        rt.run_tick()
        torch.cuda.synchronize()
        log(f"  warm-up tick over TCP: {time.perf_counter() - t0:.2f}s, "
            f"{int(rt.state.tbl.n_live)} services live")
        install_alert_ops(rt)
        sc = SubscribeClient()
        await _w(sc.connect(host, port))
        await _w(sc.subscribe({"subsys": "svcstate", "maxrecs": 100}))
        events = sc.events(stall_timeout=SRV_TIMEOUT)
        first = await _w(events.__anext__())
        perf["sub_events"] = [first.get("t")]

        # ---- the measured ticks, counted
        reset_launches(scatter, mods)
        slabs0 = ctr.get("slab_dispatches", 0)
        perf["buffer_ms"], perf["events_per_s"] = [], []
        perf["tick_ms"], perf["sweep_s"] = [], []
        j = RT_WARM_BUFFERS
        for tick in range(SRV_TICKS):
            c0 = ctr["conn_events"]
            t0 = time.perf_counter()
            await _send(w0, sweeps[tick + 1])
            await _until(lambda: ctr["conn_events"] >= c0 + RT_NAT_FLOWS,
                         "a sweep")
            torch.cuda.synchronize()
            perf["sweep_s"].append(time.perf_counter() - t0)
            fed["conn"] = ctr["conn_events"]
            t0 = time.perf_counter()
            await feed_buffers(SRV_BUFFERS, j)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            j += SRV_BUFFERS
            perf["buffer_ms"].append(dt / SRV_BUFFERS * 1e3)
            perf["events_per_s"].append(SRV_BUFFERS * ev_buf / dt)
            t0 = time.perf_counter()
            srv._feed_barrier()
            rt.run_tick()
            torch.cuda.synchronize()
            perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            await srv.push_subscriptions()
            ev = await _w(events.__anext__())
            perf["sub_events"].append(ev.get("t"))
        check(perf["sub_events"][0] == "full"
              and all(t in ("delta", "full", "ack")
                      for t in perf["sub_events"][1:])
              and len(perf["sub_events"]) == SRV_TICKS + 1,
              f"svcstate subscription pushed after each tick: "
              f"{perf['sub_events']}")
        log(f"  wire→fold over {SRV_AGENTS} conns: ms per buffer "
            f"{', '.join(f'{m:.2f}' for m in perf['buffer_ms'])} "
            f"({', '.join(f'{e:.0f}' for e in perf['events_per_s'])} "
            "events/s; phase 8's direct feed in this run: "
            f"{', '.join(f'{e:.0f}' for e in rt_perf['events_per_s'])})")
        log(f"  sweep over TCP (s): "
            f"{', '.join(f'{s:.3f}' for s in perf['sweep_s'])}; manual "
            f"run_tick ms: {', '.join(f'{m:.1f}' for m in perf['tick_ms'])}")

        # ---- a stock partha: PS_REGISTER → PM_CONNECT → NOTIFY frames
        mid = (0x57AC, 0x0CC1)
        r1, w1 = await _w(asyncio.open_connection(host, port))
        w1.write(RP.encode_ps_register_req(*mid, hostname="stock-partha"))
        await _w(w1.drain())
        ps = RP.parse_ps_register_resp(await _w(r1.readexactly(
            RP.REF_HEADER_DT.itemsize + RP.REF_PS_REGISTER_RESP_DT.itemsize)))
        w1.close()
        r2, w2 = await _w(asyncio.open_connection(host, port))
        w2.write(RP.encode_pm_connect_cmd(*mid, ps["partha_ident_key"],
                                          ps["madhava_id"]))
        await _w(w2.drain())
        pm = RP.parse_pm_connect_resp(await _w(r2.readexactly(
            RP.REF_HEADER_DT.itemsize + RP.REF_PM_CONNECT_RESP_DT.itemsize)))
        check(ps["error_code"] == pm["error_code"] == 0,
              "stock partha registered: PS_REGISTER and PM_CONNECT "
              f"accepted {ps['error_string']!r} {pm['error_string']!r}")
        gids = [int(r["svcid"], 16) for r in rt.query(
            {"subsys": "svcstate", "maxrecs": 16})["recs"]]
        c0 = ctr["conn_events"]
        t0 = time.perf_counter()
        await _send(w2, ref_partha_frames(RP, gids, SRV_REF_CONNS))
        await _until(lambda: ctr["conn_events"] >= c0 + SRV_REF_CONNS,
                     "the stock partha's conns")
        perf["ref_session_s"] = time.perf_counter() - t0
        w2.close()
        nat_, fb = ctr.get("ref_native_decoded", 0), \
            ctr.get("ref_fallback_decoded", 0)
        check(ctr.get("ref_pm_connected") == 1
              and ctr.get("conns_ref_adapted", 0) >= 1
              and ctr.get(f"ref_evt_0x{RP.REF_NOTIFY_TCP_CONN:x}")
              == SRV_REF_CONNS and nat_ > 0 and fb == 0,
              f"stock partha session adapted ({SRV_REF_CONNS} conns in "
              f"{perf['ref_session_s']:.3f}s); ref_native_decoded {nat_}, "
              f"ref_fallback_decoded {fb}")
        srv._feed_barrier()
        rt.run_tick()
        await srv.push_subscriptions()
        prime_vips(rt)

        # ---- queries over the three edges, each against rt.query on
        # the same snapshot
        qc = QueryClient(request_timeout=SRV_TIMEOUT)
        await _w(qc.connect(host, port))
        served = RT_SERVED + RT_NEW
        lat = {"gyt": {"first": [], "cached": []},
               "nm": {"first": [], "cached": []},
               "rest": {"first": [], "cached": []}}
        gyt = {}

        async def timed(edge, names, ask, want):
            """Each name's first call, then cached calls in rounds over
            the names until the edge has ``SRV_CACHED_MIN`` of them;
            every answer is held against ``want(name)``."""
            rounds = -(-SRV_CACHED_MIN // len(names))
            for rnd in range(1 + rounds):
                kind = "first" if rnd == 0 else "cached"
                for name in names:
                    t0 = time.perf_counter()
                    out = await ask(name)
                    lat[edge][kind].append(
                        (time.perf_counter() - t0) * 1e3)
                    if out != want(name, out):
                        raise AssertionError(
                            f"{edge} {name}: the JSON differs from "
                            + ("rt.query on the same snapshot"
                               if edge == "gyt" else "GYT's"))

        def direct(name, out):
            if name not in gyt:
                gyt[name] = json.loads(json.dumps(rt.query(
                    {"subsys": name, "consistency": "snapshot"})))
            return gyt[name]
        await timed("gyt", served,
                    lambda name: _w(qc.query({"subsys": name})), direct)
        nm = NMClient(RP, RQ)
        await nm.connect(host, port)
        await timed("nm", SRV_NM, nm.query, lambda name, out: gyt[name])
        gw = WebGateway(host, port)
        gh, gp = await _w(gw.start())
        await timed("rest", SRV_REST,
                    lambda name: _http_query(gh, gp, {"subsys": name}),
                    lambda name, out: gyt[name])
        perf["query_ms"] = {e: {k: _pcts(v) for k, v in d.items()}
                            for e, d in lat.items()}
        check(gyt["svcstate"]["nrecs"] > 0
              and int(rt.state.tbl.n_live) >= n_svcs,
              f"{len(served)} subsystems over GYT, {len(SRV_NM)} over NM, "
              f"{len(SRV_REST)} over REST: JSON equal to rt.query on the "
              f"same snapshot and across edges; "
              f"{int(rt.state.tbl.n_live)} services live")
        for e, d in perf["query_ms"].items():
            log(f"  {e} query ms: first {_fmt_pcts(d['first'])}; cached "
                f"{_fmt_pcts(d['cached'])}")
        # the query conns are done: closed before the stretch, whose
        # idle deadline would reap them (they are silent, not live)
        await gw.stop()
        gw = None
        nm.close()
        nm = None
        await qc.close()
        qc = None

        # ---- a stretch under the server's own tick loop, with an idle
        # deadline on every conn: run_tick holds the loop thread while
        # the agents go on sending
        loop_ticks, tick_calls = [], [0]
        run_tick = rt.run_tick

        def timed_tick():
            tick_calls[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_tick()
            torch.cuda.synchronize()
            loop_ticks.append((time.perf_counter() - t0) * 1e3)
            return out
        rt.run_tick = timed_tick
        srv.idle_timeout = SRV_IDLE_S
        srv.tick_interval = SRV_LOOP_TICK_S
        srv._tick_task = asyncio.create_task(srv._tick_loop())
        t_end = time.monotonic() + SRV_LOOP_S
        while time.monotonic() < t_end or len(loop_ticks) < 2:
            if time.monotonic() > t_end + SRV_TIMEOUT:
                raise AssertionError("the server's tick loop stalled")
            await feed_buffers(len(conns), j)
            j += len(conns)
        srv._tick_task.cancel()
        srv._tick_task = None
        rt.run_tick = run_tick
        reaped = {k: v for k, v in ctr.items()
                  if k.startswith("conn_timeouts")}
        perf["loop_tick_ms"] = loop_ticks
        perf["conn_timeouts"] = reaped
        check(len(loop_ticks) >= 2 and tick_calls[0] == len(loop_ticks)
              and not tick_log.records and not reaped,
              f"the server's tick loop ran {len(loop_ticks)} ticks of "
              f"{tick_calls[0]} in {SRV_LOOP_S}s "
              f"({', '.join(f'{m:.1f}' for m in loop_ticks)} ms), no tick "
              f"failed {tick_log.records}, no conn reaped under a "
              f"{SRV_IDLE_S}s idle deadline {reaped}")
        launches = read_launches(scatter, mods)
        perf["fed"] = dict(fed)
        perf["counters"] = {k: ctr.get(k, 0) for k in (
            "conn_events", "resp_events", "slab_dispatches",
            "fold_dispatches", "ref_native_decoded", "net_queries",
            "conns_ref_adapted", "net_subscribes")}
        slabs = ctr["slab_dispatches"] - slabs0
        # each conn/resp dispatch: hll_update twice, inv, cms and the
        # int32 scatter-add once
        check(launches["hll_update"] == 2 * launches["inv_update"]
              == 2 * launches["cms_update"]
              == 2 * launches["add_drop"]
              and launches["inv_update"] >= slabs > 0,
              f"kernels launched during the serving run: {launches} "
              f"({slabs} slab dispatches)")
        perf["max_memory_allocated_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  max_memory_allocated: "
            f"{perf['max_memory_allocated_gib']:.3f} GiB")
        # ---- phase 12b: the fabric gateway in front of this server and
        # a second one over the same runtime (the agents stay silent
        # from here: no idle deadline)
        srv.idle_timeout = None
        perf["fabric"] = await fabric_run(torch, rt, srv, host, port)
    finally:
        if qc is not None:
            await qc.close()
        if nm is not None:
            nm.close()
        if sc is not None:
            await sc.close()
        if gw is not None:
            await gw.stop()
        for _, w, _ in conns:
            w.close()
        await srv.stop()              # closes the runtime
        logging.getLogger("gyeeta_tpu_torch.net").removeHandler(tick_log)
    del rt, srv
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the decode pipeline over the same buffers
    rt = Runtime(cfg, RuntimeOpts(**RT_OPTS), device=DEV)
    srv = GytServer(rt, host="127.0.0.1", port=0, tick_interval=None,
                    idle_timeout=0, feed_pipeline=True)
    ctr = rt.stats.counters
    conns = []
    try:
        host, port = await _w(srv.start())
        conns = await _register_agents(register, wire, host, port,
                                       SRV_AGENTS)
        want = sum(bufs[i % len(bufs)][1] for i in range(SRV_BUFFERS))
        for rnd in range(2):                 # a warm pass, then timed
            sends = [[] for _ in conns]
            for i in range(SRV_BUFFERS):
                sends[i % len(conns)].append(bufs[i % len(bufs)][0])
            c0 = ctr.get("conn_events", 0)
            t0 = time.perf_counter()

            async def one(w, bl):
                for b in bl:
                    await _send(w, b)
            await asyncio.gather(*(one(w, bl) for (_, w, _), bl
                                   in zip(conns, sends)))

            def done():
                srv._feed_barrier()
                return ctr.get("conn_events", 0) >= c0 + want
            await _until(done, "the pipeline's buffers")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        perf["pipeline_events_per_s"] = SRV_BUFFERS * ev_buf / dt
        rt.run_tick()
        check(ctr.get("pipeline_frame_errors", 0) == 0
              and ctr["conn_events"] == 2 * want,
              f"feed_pipeline=True: {perf['pipeline_events_per_s']:.0f} "
              f"events/s wire→fold, {ctr['conn_events']} conn events, no "
              "frame errors")
    finally:
        for _, w, _ in conns:
            w.close()
        await srv.stop()
    del rt, srv
    gc.collect()
    torch.cuda.empty_cache()
    return perf, launches


FAB_CONCURRENT = 32         # identical svcstate requests on a fresh tick
FAB_DOWN_AFTER = 3          # the breaker's consecutive-failure threshold
FAB_DOWN_ROUNDS = 8         # query rounds with one replica's listener shut
FAB_Q = {"subsys": "svcstate", "maxrecs": 100}


async def fabric_run(torch, rt, srv, host, port) -> dict:
    """Phase 12b: a port ``FabricGateway`` in front of two replicas: the
    phase's ``GytServer`` and a second ``GytServer`` over the same ns
    ``Runtime`` with no tick loop of its own (one runtime ticks once a
    tick; every tick here is a manual ``run_tick``). The 43 served
    subsystems through the gateway's GYT front and 8 each through its
    REST and NM fronts, each body equal to ``rt.query`` on the same
    snapshot, first and cached latency; 32 concurrent identical
    svcstate requests on a fresh tick → one upstream render; an SSE
    subscription's push after a tick, reassembled equal to a fresh
    render; then the second replica's listener shut: every query still
    answers, and its breaker opens after ``FAB_DOWN_AFTER`` failures,
    not one."""
    import asyncio

    from gyeeta_tpu_torch.ingest import refproto as RP
    from gyeeta_tpu_torch.ingest import refquery as RQ
    from gyeeta_tpu_torch.net.agent import QueryClient
    from gyeeta_tpu_torch.net.gateway import FabricGateway
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.net.subs import read_sse_events
    from gyeeta_tpu_torch.query import delta as D

    log("phase 12b: the fabric gateway in front of two GytServers over "
        "the card's Runtime")
    t_phase = time.perf_counter()
    perf = {}
    srv2 = GytServer(rt, host="127.0.0.1", port=0, tick_interval=None,
                     idle_timeout=0)
    gw = qc = nm = sse_w = sse_task = None
    gctr = {}
    try:
        h2, p2 = await _w(srv2.start())
        gw = FabricGateway([(host, port), (h2, p2)], host="127.0.0.1",
                           port=0, poll_s=0.05, down_after=FAB_DOWN_AFTER)
        gctr = gw.stats.counters
        gh, gp = await _w(gw.start())
        await _until(lambda: gw.fabric_tick >= rt.snapshot.tick,
                     "the gateway's tick discovery")
        served = RT_SERVED + RT_NEW
        direct = {n: json.loads(json.dumps(rt.query(
            {"subsys": n, "consistency": "snapshot"}))) for n in served}
        lat = {e: {"first": [], "cached": []} for e in ("gyt", "nm",
                                                        "rest")}

        async def timed(edge, names, ask):
            rounds = -(-SRV_CACHED_MIN // len(names))
            for rnd in range(1 + rounds):
                kind = "first" if rnd == 0 else "cached"
                for name in names:
                    t0 = time.perf_counter()
                    out = await ask(name)
                    lat[edge][kind].append(
                        (time.perf_counter() - t0) * 1e3)
                    if json.loads(json.dumps(out)) != direct[name]:
                        raise AssertionError(
                            f"gateway {edge} {name}: the body differs "
                            "from rt.query on the same snapshot")
        qc = QueryClient(request_timeout=SRV_TIMEOUT)
        await _w(qc.connect(gh, gp))
        await timed("gyt", served,
                    lambda name: _w(qc.query({"subsys": name})))
        nm = NMClient(RP, RQ)
        await nm.connect(gh, gp)
        await timed("nm", SRV_NM, nm.query)
        await timed("rest", SRV_REST,
                    lambda name: _http_query(gh, gp, {"subsys": name}))
        perf["query_ms"] = {e: {k: _pcts(v) for k, v in d.items()}
                            for e, d in lat.items()}
        check(True, f"through the gateway: {len(served)} subsystems over "
              f"GYT, {len(SRV_NM)} over NM, {len(SRV_REST)} over REST, "
              "each body equal to rt.query on the same snapshot")
        for e, d in perf["query_ms"].items():
            log(f"  gateway {e} ms: first {_fmt_pcts(d['first'])}; cached "
                f"{_fmt_pcts(d['cached'])}")

        # ---- single-flight on a fresh tick
        srv._feed_barrier()
        rt.run_tick()
        await _until(lambda: gw.fabric_tick >= rt.snapshot.tick,
                     "the fresh tick at the gateway")
        r0 = gctr.get("gw_renders_upstream", 0)
        w0 = gctr.get("gw_singleflight_waits", 0)
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(_http_query(gh, gp, dict(FAB_Q))
                                      for _ in range(FAB_CONCURRENT)))
        perf["stampede_ms"] = (time.perf_counter() - t0) * 1e3
        perf["stampede_renders"] = gctr.get("gw_renders_upstream", 0) - r0
        perf["stampede_waits"] = gctr.get("gw_singleflight_waits", 0) - w0
        check(perf["stampede_renders"] == 1
              and len({o["snaptick"] for o in outs}) == 1
              and all(o == outs[0] for o in outs),
              f"{FAB_CONCURRENT} concurrent identical svcstate requests on "
              f"a fresh tick: {perf['stampede_renders']} upstream render, "
              f"{perf['stampede_waits']} single-flight waits, "
              f"{perf['stampede_ms']:.1f} ms")

        # ---- an SSE subscription's push after a tick
        sse_r, sse_w = await _w(asyncio.open_connection(gh, gp))
        sse_w.write(b"GET /v1/subscribe?subsys=svcstate&maxrecs=100 "
                    b"HTTP/1.1\r\nHost: gyt\r\n\r\n")
        await _w(sse_w.drain())
        head = await _w(sse_r.readuntil(b"\r\n\r\n"))
        check(b" 200 " in head.split(b"\r\n")[0], "SSE subscribe accepted")
        events = []

        async def sse_loop():
            async for ev in read_sse_events(sse_r):
                events.append(ev)
        sse_task = asyncio.create_task(sse_loop())
        await _until(lambda: events, "the SSE subscription's full")
        srv._feed_barrier()
        t0 = time.perf_counter()
        rt.run_tick()
        await _until(lambda: len(events) > 1, "the SSE push after a tick")
        perf["sse_push_ms"] = (time.perf_counter() - t0) * 1e3
        held = D.apply_event(D.apply_event(None, events[0]), events[-1])
        fresh = json.loads(json.dumps(rt.query(
            dict(FAB_Q, consistency="snapshot"))))
        check(events[0]["t"] == "full" and held == fresh,
              f"SSE: {[e['t'] for e in events]} after a tick, "
              f"{perf['sse_push_ms']:.1f} ms from run_tick to the push; "
              "the reassembled view equals rt.query on the new snapshot")

        # ---- one replica's listener shut: every query answers, the
        # breaker opens after FAB_DOWN_AFTER failures
        u2 = [u for u in gw.upstreams if u.port == p2][0]
        trail = []
        record_fail = u2.record_fail

        def traced_fail():
            record_fail()
            trail.append((u2.fails, u2.state))
        u2.record_fail = traced_fail
        srv2._server.close()
        for w in list(srv2._open_conns):
            w.close()
        await _w(srv2._server.wait_closed())
        srv2._server = None
        n_ok = 0
        for rnd in range(FAB_DOWN_ROUNDS):
            for name in ("svcstate", "hoststate", "serverstatus"):
                req = {"subsys": name, "maxrecs": 100}
                if rnd % 2:
                    req["consistency"] = "strong"   # past the edge cache
                out = await _w(qc.query(req))
                n_ok += out.get("nrecs", 0) > 0
        await _until(lambda: u2.state == "down", "the breaker opening")
        first_down = [f for f, st in trail if st == "down"][0]
        perf["breaker"] = {"trail": trail[:8], "answered": n_ok,
                           "errors": gctr.get("gw_upstream_errors", 0),
                           "flaps": gctr.get(
                               f"gw_upstream_flaps|upstream={u2.label}")}
        check(n_ok == 3 * FAB_DOWN_ROUNDS and trail[0] == (1, "up")
              and first_down == FAB_DOWN_AFTER
              and perf["breaker"]["flaps"] == 1
              and gw.upstreams[0].state == "up",
              f"one replica's listener shut: {n_ok} of "
              f"{3 * FAB_DOWN_ROUNDS} queries answered, no error "
              f"surfaced; its breaker opened at failure {first_down} "
              f"(trail {trail[:4]}), the other replica up")
    finally:
        if sse_task is not None:
            sse_task.cancel()
        if sse_w is not None:
            sse_w.close()
        if qc is not None:
            await qc.close()
        if nm is not None:
            nm.close()
        if gw is not None:
            await _w(gw.stop())
        # srv2.stop closes the shared runtime: the phase's server is
        # done with it (its own stop closes it again, a no-op)
        await _w(srv2.stop())
    perf["counters"] = {k: v for k, v in gctr.items()
                        if k.startswith("gw_")}
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"  gateway counters: {perf['counters']}")
    log(f"  phase 12b: {perf['phase_s']:.1f}s")
    return perf


async def tiny_server_run(device) -> dict:
    """The tiny stream (phase 8's, with registry records) over one
    registered TCP conn into a port server over
    ``Runtime(device=...)``; a manual tick after each tick's bytes →
    tick reports, every served subsystem's JSON over QueryClient."""
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import QueryClient, register
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    now = [1.7e9]
    rt = Runtime(tiny_rt_cfg(), RuntimeOpts(**TINY_RT_OPTS),
                 clock=lambda: now[0], device=device)
    install_alert_ops(rt)
    srv = GytServer(rt, host="127.0.0.1", port=0, tick_interval=None,
                    idle_timeout=0)
    bufs, _ = tiny_runtime_stream()
    out = {"reports": []}
    w = qc = None
    ctr = rt.stats.counters
    try:
        host, port = await _w(srv.start())
        _, w, status, _ = await _w(register(host, port, 0x71, wire.CONN_EVENT))
        if status != wire.REG_OK:
            raise AssertionError(f"tiny agent registration status {status}")
        for buf in bufs:
            recs, _, _ = wire.drain2(buf)
            want = ctr.get("resp_events", 0) + len(
                recs[wire.NOTIFY_RESP_SAMPLE])
            await _send(w, buf)
            await _until(lambda: ctr.get("resp_events", 0) >= want,
                         "a tiny tick's bytes")
            now[0] += 5.0
            out["reports"].append(rt.run_tick())
        prime_vips(rt)
        qc = QueryClient(request_timeout=SRV_TIMEOUT)
        await _w(qc.connect(host, port))
        out["json"] = {name: await _w(qc.query({"subsys": name,
                                                "maxrecs": 10000}))
                       for name in RT_SERVED + RT_NEW}
    finally:
        if qc is not None:
            await qc.close()
        if w is not None:
            w.close()
        await srv.stop()
    return out


def serving_phase(torch, scatter, frames, rt_perf):
    """Phase 11: the serving edge at ns geometry on the card."""
    import asyncio

    from gyeeta_tpu_torch.sketch import loghist

    t_phase = time.perf_counter()
    log(f"phase 11: the serving edge at north-star geometry: a GytServer "
        f"over the card's Runtime on 127.0.0.1, {SRV_AGENTS} agents' "
        f"conns, {SRV_TICKS} ticks of {SRV_BUFFERS} feed buffers")
    perf, launches = asyncio.run(serving_run(torch, scatter, frames,
                                             rt_perf))
    log("  tiny stream over TCP, card server vs CPU server")
    g = asyncio.run(tiny_server_run(DEV))
    c = asyncio.run(tiny_server_run("cpu"))
    check(g["reports"] == c["reports"], f"tick reports equal card vs CPU: "
          f"{c['reports']}")
    _, fed = tiny_runtime_stream()
    tcfg = tiny_rt_cfg()
    moved = {k: _moved(torch, loghist, getattr(tcfg, k), v)
             for k, v in fed.items()}
    n_q = [0, 0]
    for name in c["json"]:
        _json_diff(torch, loghist, tcfg, c["json"][name], g["json"][name],
                   moved, name, n_q)
    check(True, f"JSON of {len(c['json'])} subsystems over the GYT edge "
          f"agrees card vs CPU ({n_q[0]} quantiles one loghist bucket "
          f"apart, {n_q[1]} values one unit apart in the third decimal)")
    perf["tiny_json_bucket_apart"], perf["tiny_json_rounding_apart"] = n_q
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11: {perf['phase_s']:.1f}s")
    return perf, launches


# ----------------------------------------------------------- phase 12
REGION_SHIPPER = "chip-smoke-source"
REGION_INTERVAL_S = 0.5     # the staging loop's cadence
REGION_TIMEOUT = 600.0      # the ship pass, and the region's compaction
REGION_AT = {"svcstate": HIST_AT_REQS["svcstate"],
             "topk": HIST_AT_REQS["topk"]}


def _shards_equal(torch, local, remote, cfg) -> tuple:
    """The region's raw shards against the local ones on the card →
    (per-shard leaf counts, the top-K mass of the newest local shard)."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    ticks = [e["tick1"] for e in local.shards("raw")]
    check(ticks == [e["tick1"] for e in remote.shards("raw")]
          == [HIST_WINDOW, 2 * HIST_WINDOW],
          f"the region emitted the local windows: raw shards at {ticks}")
    snames = tree_paths(aggstate.init(cfg, "meta"))
    names = snames + tree_paths(depgraph.init(1, 1, "meta"))
    out = {}
    for el, er in zip(local.shards("raw"), remote.shards("raw")):
        kinds = shard_leaf_verdicts(torch, names, len(snames),
                                    local.dir / el["file"],
                                    remote.dir / er["file"], DEV)
        close = sorted(n for n, k in kinds.items() if k == "close")
        bad = {n: k for n, k in kinds.items() if k not in ("exact",
                                                           "close")}
        n_exact = len(kinds) - len(close) - len(bad)
        out[el["tick1"]] = {"exact": n_exact, "close": close}
        check(len(kinds) == 85 + 29 and not bad,
              f"region shard at tick {el['tick1']} = the local one: "
              f"{n_exact} of 114 leaves exact, {len(close)} within the "
              f"float-sum rule {close}; differing: {bad}")
    with np.load(local.dir / local.shards("raw")[-1]["file"]) as z:
        mass = float(z[f"s{snames.index('flow_topk.evicted')}"]) + float(
            z[f"s{snames.index('flow_topk.counts')}"].sum())
    return out, mass


async def region_run(torch, scatter, hist_dir, opts, local_at) -> tuple:
    """Phase 10's WAL through the remote compaction region (see
    region_phase) → (perf, launches)."""
    import threading

    from gyeeta_tpu_torch.engine import aggstate, step
    from gyeeta_tpu_torch.history.shards import ShardStore
    from gyeeta_tpu_torch.history.shipper import SegmentShipper, seg_info
    from gyeeta_tpu_torch.history.timeview import TimeView
    from gyeeta_tpu_torch.net.segship import SegmentReceiver, key_of
    from gyeeta_tpu_torch.server_main import _StagingCompactLoop
    from gyeeta_tpu_torch.utils import journal as J
    from gyeeta_tpu_torch.utils.selfstats import Stats

    wal, stage, region = hist_dir / "wal", hist_dir / "stage", \
        hist_dir / "region"
    segs = J.dir_segments(wal)
    src = {q: seg_info(wal / J._SEG_FMT.format(q)) for q in segs}
    total = sum(size for size, _, _ in src.values())
    log(f"  source WAL: {len(segs)} segments, {total / 2**20:.1f} MiB, "
        "all sealed")
    cfg = aggstate.EngineCfg(**NS_CFG)
    ropts = opts._replace(journal_dir=None, hist_shard_dir=None,
                          history_db=None,
                          hist_compact_interval_s=REGION_INTERVAL_S)
    rstats = Stats()
    loop = _StagingCompactLoop(cfg, ropts, str(stage), str(region),
                               stats=rstats, device=DEV)
    rcv = SegmentReceiver(stage, stats=rstats, host="127.0.0.1", port=0,
                          floors_fn=loop.floors)
    mods = sketch_modules()
    connresp = [0]
    fold_all = step.fold_all

    def counting_fold_all(*a, **kw):
        connresp[0] += kw.get("connresp") is not None
        return fold_all(*a, **kw)

    perf = {"segments": len(segs), "wal_mib": total / 2**20}
    shipper = th = None
    reset_launches(scatter, mods)
    step.fold_all = counting_fold_all
    try:
        h, p = await _w(rcv.start())
        shipper = SegmentShipper({"target": (h, p), "dir": str(wal),
                                  "shipper_id": REGION_SHIPPER,
                                  "stats": Stats(), "once": True,
                                  "scan_s": 0.05, "hb_s": 0.05})
        th = threading.Thread(target=shipper.run, daemon=True,
                              name="smoke-shipper")
        t0 = time.perf_counter()
        th.start()
        await _until(lambda: not th.is_alive(), "the shipper's pass",
                     timeout=REGION_TIMEOUT)
        t_landed = time.perf_counter()
        # the loop starts on the landed WAL: each pass ends in a flush
        # (the reference's compactor too), so a pass that stops inside
        # a window folds its last slab at another boundary than the
        # local compaction, and order-dependent state (the budgeted
        # top-K, the invertible buckets, split-half pairing) differs
        loop.start()

        def compacted():
            c = loop.compactor
            return c is not None and len(c.store.shards("raw")) >= 2
        await _until(compacted, "the region's two windows",
                     timeout=REGION_TIMEOUT)
        t_done = time.perf_counter()
        loop.stop()
        loop.pass_once()              # what the last pass left, if any
        torch.cuda.synchronize()
        launches = read_launches(scatter, mods)
        step.fold_all = fold_all
        perf["ship_s"] = t_landed - t0
        perf["ship_mb_per_s"] = total / 2**20 / perf["ship_s"]
        perf["landed_to_compacted_s"] = t_done - t_landed
        perf["replay_connresp_dispatches"] = connresp[0]
        perf["compact_replay_ev_per_sec"] = \
            rstats.gauges["compact_replay_ev_per_sec"]
        n_emit, emit_ms = rstats.timing_totals()["compact_emit"]
        perf["compact_emit_ms"] = emit_ms / max(n_emit, 1)
        c = rstats.counters
        sealed = rstats.gauges.get(
            f"ship_sealed_segments|shipper={REGION_SHIPPER}")
        perf["ledger"] = {k: c.get(k, 0) for k in (
            "ship_shipped_segments", "ship_dropped_segments",
            "ship_shipped_bytes", "ship_hash_mismatches",
            "ship_staged_swept", "compact_passes", "compact_errors")}
        perf["ledger"]["sealed"] = sealed
        log(f"  shipped {len(segs)} segments in {perf['ship_s']:.2f}s "
            f"({perf['ship_mb_per_s']:.1f} MB/s over 127.0.0.1; every "
            "segment was sealed before the shipper started, so seal → "
            f"landed is the ship pass); landed → compacted "
            f"{perf['landed_to_compacted_s']:.2f}s; region replay "
            f"{perf['compact_replay_ev_per_sec']} records/s, compact_emit "
            f"{perf['compact_emit_ms']:.1f} ms a window; {perf['ledger']}")
        check(sealed == c.get("ship_shipped_segments", 0)
              + c.get("ship_dropped_segments", 0) == len(segs)
              and c.get("ship_hash_mismatches", 0) == 0
              and c.get("ship_dropped_segments", 0) == 0
              and not c.get("compact_errors"),
              f"ledger: sealed {sealed} == shipped "
              f"{c.get('ship_shipped_segments', 0)} + dropped "
              f"{c.get('ship_dropped_segments', 0)}, no hash mismatch, "
              "no failed compaction pass")
        # landed == source, byte for byte: the receiver verified each
        # landed file's blake2b before publishing it; the files the
        # staging sweep has not reclaimed yet are compared whole too
        n_whole = 0
        for q, (size, digest, nrec) in src.items():
            ent = rcv.ledger.get(key_of(0, q)) or {}
            if (ent.get("status"), ent.get("hash"), ent.get("size"),
                    ent.get("nrec")) != ("landed", digest, size, nrec):
                raise AssertionError(f"segment {q}: ledger {ent}")
            landed = stage / J._SEG_FMT.format(q)
            if landed.exists():
                if landed.read_bytes() != \
                        (wal / J._SEG_FMT.format(q)).read_bytes():
                    raise AssertionError(f"segment {q}: landed bytes "
                                         "differ")
                n_whole += 1
        check(True, f"{len(segs)} landed segments equal the source's "
              f"(blake2b over the whole file; {n_whole} still staged "
              f"compared byte for byte, {c.get('ship_staged_swept', 0)} "
              "reclaimed by the staging sweep)")
        check(launches == path_launches(connresp[0]) and connresp[0] > 0,
              f"each of the region replay's {connresp[0]} conn/resp "
              "dispatches launched hll_update 2x, cms_update 1x, "
              "inv_update 1x and the int32 scatter-add 1x, the other "
              f"generic kernels never: {launches}")
        perf["launches"] = launches
        local, remote = ShardStore(hist_dir / "shards"), ShardStore(region)
        perf["shards"], mass = _shards_equal(torch, local, remote, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        # at= JSON of the region's store, through the region's replay
        # runtime, against phase 10's answers from the local store
        tv = TimeView(loop.compactor._rt, remote)
        n_q = [0, 0]
        perf["at_ms"] = {}
        for name, (req, keys) in REGION_AT.items():
            req = dict(req, at=f"tick:{2 * HIST_WINDOW}")
            t1 = time.perf_counter()
            got, ref = tv.query(dict(req)), local_at[name]
            perf["at_ms"][f"{name} region"] = \
                (time.perf_counter() - t1) * 1e3
            check(got["nrecs"] == ref["nrecs"] > 0
                  and got["tick"] == 2 * HIST_WINDOW,
                  f"at=tick:{2 * HIST_WINDOW} {name}: {got['nrecs']} rows "
                  "from the region's store, as from the local one")
            _sum_json_diff(_keyed(ref["recs"], keys),
                           _keyed(got["recs"], keys),
                           f"region at {name}", n_q, mass)
        perf["at_json_sum_apart"], perf["at_json_rounding_apart"] = n_q
        log(f"  at= JSON, region store vs local store: equal but "
            f"{n_q[0]} values within rtol 1e-6 and {n_q[1]} one unit "
            f"apart in the third decimal; ms {perf['at_ms']}")
        del tv
    finally:
        step.fold_all = fold_all
        if shipper is not None:
            shipper.stop()
        if th is not None:
            th.join(timeout=SRV_TIMEOUT)
        loop.final_pass()
        await _w(rcv.stop())
    return perf, launches


def region_phase(torch, scatter, hist_dir, opts, local_at):
    """Phase 12a: the remote compaction region at ns geometry. Phase
    10's WAL (every segment sealed) ships with the port's
    ``SegmentShipper`` over 127.0.0.1 to a ``SegmentReceiver``; a
    ``_StagingCompactLoop`` on the card compacts the staging dir into a
    fresh shard dir, the receiver's staging sweep fed its floors, as the
    daemon wires them. Checks: the ledger closes (sealed == shipped +
    dropped, no hash mismatch), the landed segments equal the source's,
    2/1/1 launches and one int32 scatter-add a replayed conn/resp
    dispatch, no other generic launch,
    the region's two shards equal phase 10's local ones (integer and max
    leaves exact, float sums rtol 1e-6), and at= the newest window's end
    svcstate and topk JSON from the region's store equal phase 10's
    answers from the local one (``local_at``)."""
    import asyncio

    t_phase = time.perf_counter()
    log("phase 12a: the remote compaction region at north-star geometry: "
        "phase 10's WAL → SegmentShipper → 127.0.0.1 → SegmentReceiver → "
        "staging → the staging loop's compaction on the card → shards")
    perf, launches = asyncio.run(region_run(torch, scatter, hist_dir,
                                            opts, local_at))
    gc.collect()
    torch.cuda.empty_cache()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12a: {perf['phase_s']:.1f}s")
    return perf, launches


# ----------------------------------------------------------- phase 13
SH_N = 4                    # shards of the mesh, all on this card
SH_CFG = dict(NS_CFG, svc_capacity=NS_CFG["svc_capacity"] // SH_N,
              task_capacity=NS_CFG["task_capacity"] // SH_N)
# measured ticks: one since phase 15 came (two before), which buys back
# phase 15's time: a sweep, 16 buffers and a tick in 13b, in its single
# runtime oracle and in 14b (~35 s)
SH_TICKS = 1
SH_BUFFERS = 16             # phase 8's feed buffers a measured tick
SH_DELTA_BUFFERS = 1        # ~1 MB SKETCH_DELTA buffers after the ticks
#                             (2 before phase 17)
SH_QUERIES = ("svcstate", "hoststate", "svcdependency", "flowstate",
              "taskstate", "topk", "shardlist", "serverstatus")
# the fleet-view oracle (the reference's tests/test_shardedrt.py and
# tests/test_shardfeed.py): rows equal to a single runtime's fold of the
# same frames. flowstate's top-K keeps per-shard survivors, so only its
# heaviest flow is held (as the reference's test holds it); the feed
# buffers repeat flow keys, and the halves of one flow that meet on its
# pair-table row in one dispatch make one pair, so runs whose slab
# boundaries differ pair a flow a different number of times:
# svcdependency is held to the same edges, each edge's nconn short by
# the pairs the other run made (see sharded_ns_run)
SH_EXACT = ("svcstate", "hoststate", "taskstate", "clusterstate")
TINY_SH_CFG = dict(n_hosts=16, svc_capacity=256, task_capacity=256,
                   conn_batch=256, resp_batch=512, listener_batch=64,
                   fold_k=2)
TINY_SH_OPTS = dict(dep_pair_capacity=1024, dep_edge_capacity=512)
# 13c: 4,096 services, so a flat compaction replay of the whole WAL
# holds them at the per-shard service capacity
SRV_SH_SIM = dict(n_hosts=64, n_svcs=64, n_clients=2048,
                  cli_groups_per_svc=4)
SRV_SH_CONNS = 2            # registered GYT event conns
SRV_SH_LOOP_S = 3.5         # the stretch under the server's tick loop
SRV_SH_TICK_S = 1.0         # ... at this tick_interval
SRV_SH_WINDOW = 2           # hist_window_ticks of its WAL's compaction
#                             (1 before phase 17: a window a tick)


def tiny_sharded_stream():
    """``tests/test_shardedrt.py``'s stream (16 hosts × 3 services, seed
    41, three ticks) with split conn halves (the server halves a tick
    later), traces, registry records and two agents' SKETCH_DELTA
    sweeps added → (buffers: names then one a tick, the slab-filling
    buffer fed after the last tick)."""
    from gyeeta_tpu_torch.engine.aggstate import EngineCfg
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import edgefold

    sim = ParthaSim(n_hosts=16, n_svcs=3, seed=41)
    bufs = [sim.name_frames()]
    for _ in range(3):
        bufs.append(sim.conn_frames(512) + sim.resp_frames(1024)
                    + sim.listener_frames() + sim.task_frames()
                    + wire.encode_frame(wire.NOTIFY_HOST_STATE,
                                        sim.host_state_records()))
    ext = ParthaSim(n_hosts=16, n_svcs=3, seed=5)
    reg = ParthaSim(n_hosts=16, n_svcs=3, seed=9)
    params = edgefold.params_of_cfg(EngineCfg(**TINY_SH_CFG))
    folds = [edgefold.EdgeFold(params, host_id=h) for h in (1, 2)]
    cli, ser = ext.svc_conn_records(200, split_halves=True)
    late = None
    for i in range(1, len(bufs)):
        delta = folds[i % 2].fold_sweep(ext.conn_records(150),
                                        ext.resp_records(200))
        bufs[i] += (registry_frames(reg, wire, i - 1, 6)
                    + wire.encode_frame(wire.NOTIFY_TCP_CONN, cli)
                    + ext.trace_frames(60)
                    + wire.encode_frames_chunked(wire.NOTIFY_SKETCH_DELTA,
                                                 delta)
                    + (wire.encode_frame(wire.NOTIFY_TCP_CONN, late)
                       if late is not None else b""))
        late = ser
        cli, ser = ext.svc_conn_records(200, split_halves=True)
    return bufs, ext.conn_frames(2400) + ext.resp_frames(600)


def tiny_sharded_run(device, mesh2d=False):
    """The tiny sharded stream through a 4-shard ``ShardedRuntime`` (a
    2×2 mesh with ``mesh2d``) on ``device``, after RT_ALERT_OPS, on a
    clock of 5 s a tick → (runtime, tick reports)."""
    from gyeeta_tpu_torch.engine.aggstate import EngineCfg
    from gyeeta_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    now = [1.7e9]
    mesh = make_mesh2d(2, 2, device=device) if mesh2d \
        else make_mesh(SH_N, device=device)
    rt = ShardedRuntime(EngineCfg(**TINY_SH_CFG), mesh,
                        RuntimeOpts(**TINY_SH_OPTS), clock=lambda: now[0])
    install_alert_ops(rt)
    bufs, post = tiny_sharded_stream()
    reports = []
    for i, buf in enumerate(bufs):
        rt.feed(buf, hid=i)
        if i:
            now[0] += 5.0
            reports.append(rt.run_tick())
    rt.feed(post)
    rt.flush()
    prime_vips(rt)
    return rt, reports


def _mass_close(got, ref, counts) -> bool:
    """``flow_topk.evicted`` (a difference of two f32 sums): the top-K
    mass plus evicted conserved within rtol 1e-5, shard by shard
    (ROADMAP.md §3)."""
    got, ref = np.ravel(got), np.ravel(ref)
    counts = np.asarray(counts).reshape(len(ref), -1)
    return all(abs(float(g) - float(r)) <= 1e-5 * (float(r) + c.sum())
               for g, r, c in zip(got, ref, counts))


def _tensor_leaves_close(torch, what, cpu, gpu) -> None:
    """Two trees of tensors: integers and bools exact, floats rtol
    1e-6."""
    from gyeeta_tpu_torch.utils.tensor import tree_leaves, tree_paths
    for name, a, b in zip(tree_paths(cpu), tree_leaves(cpu),
                          tree_leaves(gpu)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}.{name}")


def tiny_sharded_phase(torch):
    """13a: the tiny sharded stream on the card and on the CPU."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.parallel import depgraph, sharded
    from gyeeta_tpu_torch.query import api
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    t0 = time.perf_counter()
    g_rt, g_rep = tiny_sharded_run(DEV)
    c_rt, c_rep = tiny_sharded_run("cpu")
    check(g_rep == c_rep and sum(r["alerts_fired"] for r in c_rep) > 0,
          f"13a: tick reports equal card vs CPU: {c_rep}")
    cfg = c_rt.cfg
    bufs, post = tiny_sharded_stream()
    moved = {k: _moved(torch, loghist, getattr(cfg, k), v)
             for k, v in hist_inputs(bufs + [post]).items()}
    names = tree_paths(aggstate.init(cfg, "meta"))
    ev, cnt = names.index("flow_topk.evicted"), \
        names.index("flow_topk.counts")
    cl = sharded.state_to_numpy(c_rt.state)
    gl = sharded.state_to_numpy(g_rt.state)
    check(_mass_close(gl[ev], cl[ev], cl[cnt]),
          "13a: flow_topk.evicted by the mass rule, shard by shard")
    keep = [i for i in range(len(names)) if i != ev]
    n_exact, n_close = _compare_leaves(
        [names[i] for i in keep], [cl[i] for i in keep],
        [gl[i] for i in keep], moved)
    check(n_exact + n_close == 84, f"13a: the 4 shards' AggState leaves "
          f"agree card vs CPU ({n_exact} exactly, {n_close} within "
          "tolerance, flow_topk.evicted by its rule)")
    n_exact, n_close = _compare_leaves(
        tree_paths(depgraph.init(1, 1, "meta")),
        sharded.dep_to_numpy(c_rt.dep), sharded.dep_to_numpy(g_rt.dep), {})
    check(n_exact + n_close == 29, f"13a: the 4 shards' DepGraph leaves "
          f"agree ({n_exact} exactly, {n_close} within tolerance)")
    check(sum(float(d.n_paired) for d in c_rt.dep) > 0
          and c_rt.stats.counters.get("preagg_delta_records", 0) > 0
          and c_rt.stats.counters.get("slab_dispatches", 0) > 0,
          "13a: halves paired across shards, delta records and a slab "
          "dispatch folded")
    fg = g_rt._fleet_roll(g_rt.state, g_rt.dep)
    fc = c_rt._fleet_roll(c_rt.state, c_rt.dep)
    check(_mass_close(fg.rollup.flow_topk.evicted.cpu().numpy(),
                      fc.rollup.flow_topk.evicted.cpu().numpy(),
                      fc.rollup.flow_topk.counts.cpu().numpy()),
          "13a: the rollup's evicted by the mass rule")
    for part in ("edges", "health"):
        _tensor_leaves_close(torch, part, getattr(fc, part),
                             getattr(fg, part))
    ru_c = fc.rollup._replace(flow_topk=fc.rollup.flow_topk._replace(
        evicted=fc.rollup.flow_topk.counts[:0]))
    ru_g = fg.rollup._replace(flow_topk=fg.rollup.flow_topk._replace(
        evicted=fg.rollup.flow_topk.counts[:0]))
    _tensor_leaves_close(torch, "rollup", ru_c, ru_g)
    check(True, "13a: FleetView (rollup, merged edges, health) equal card "
          "vs CPU")
    n_q = [0, 0]
    served = tuple(api.SERVED) + ("shardlist",)
    for name in served:
        for cons in ("strong", "snapshot"):
            req = {"subsys": name, "maxrecs": 10000, "consistency": cons}
            ref, got = c_rt.query(dict(req)), g_rt.query(dict(req))
            if name == "flowstate":
                mass = [sum(r["bytes"] for r in ref["recs"])]
                for a, b in zip(ref["recs"], got["recs"]):
                    if not _mass_close([b.pop("evictedbytes")],
                                       [a.pop("evictedbytes")], mass):
                        raise AssertionError(f"{name}@{cons}: "
                                             "evictedbytes")
            _json_diff(torch, loghist, cfg, ref, got, moved,
                       f"{name}@{cons}", n_q)
    check(True, f"13a: query JSON of the {len(served)} subsystems "
          f"(shardlist included), strong and snapshot, agrees card vs CPU "
          f"({n_q[0]} quantiles one loghist bucket apart, {n_q[1]} values "
          "one unit apart in the third decimal)")
    m_rt, _ = tiny_sharded_run(DEV, mesh2d=True)
    fm = m_rt._fleet_roll(m_rt.state, m_rt.dep)
    check(m_rt.rollup_stats() == g_rt.rollup_stats()
          and _mass_close(fm.rollup.flow_topk.evicted.cpu().numpy(),
                          fg.rollup.flow_topk.evicted.cpu().numpy(),
                          fg.rollup.flow_topk.counts.cpu().numpy()),
          f"13a: the 2x2 mesh's rollup equals the 1-D mesh's: "
          f"{m_rt.rollup_stats()}")
    _tensor_leaves_close(torch, "2x2 edges", fg.edges, fm.edges)
    for rt in (g_rt, c_rt, m_rt):
        rt.close()
    out = {"s": time.perf_counter() - t0, "json_bucket_apart": n_q[0],
           "json_rounding_apart": n_q[1]}
    log(f"  13a: {out['s']:.1f} s")
    return out


def _rows_by_identity(out) -> list:
    """A query's rows sorted by their non-float fields (ids, names,
    states): float sums the card adds in another order cannot reorder
    them."""
    return sorted(out["recs"], key=lambda r: json.dumps(
        {k: v for k, v in r.items() if not isinstance(v, float)},
        sort_keys=True, default=str))


def sharded_ns_run(torch, scatter, frames, rt_perf, oracle):
    """13b: phase 8's frames through a 4-shard ``ShardedRuntime`` on the
    card at ns ÷ 4 a shard, then the same frames through a single
    ``Runtime`` at ns geometry, held row for row (see sharded_phase).
    ``oracle`` gets phase 14's live answers: svcstate at tick 2, the
    exact views and svcdependency at the last tick (before any other
    frame),
    the pairs made and ms a feed buffer."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.parallel import depgraph, sharded
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import edgefold
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    names, sweeps, bufs, n_svcs = frames
    scfg = aggstate.EngineCfg(**SH_CFG)
    perf = {"shard_cfg": {k: SH_CFG[k] for k in ("svc_capacity",
                                                  "task_capacity",
                                                  "n_hosts")}}
    torch.cuda.reset_peak_memory_stats()
    rt = ShardedRuntime(scfg, make_mesh(SH_N, device=DEV),
                        RuntimeOpts(**RT_OPTS))
    check(len({str(d) for d in rt.mesh.devices}) == 1,
          f"13b: {SH_N} shards on {rt.mesh.devices[0]}")
    t0 = time.perf_counter()
    rt.feed(names)
    rt.feed(sweeps[0])
    for i in range(RT_WARM_BUFFERS):
        rt.feed(bufs[i % RT_DISTINCT][0])
    rt.run_tick()
    torch.cuda.synchronize()
    perf["warm_s"] = time.perf_counter() - t0
    mods = sketch_modules()
    routed = {"lanes": 0, "calls": 0}
    dispatch = depgraph._dispatch_halves

    def counting_dispatch(mesh, hvs, cap):
        out = dispatch(mesh, hvs, cap)
        routed["lanes"] += sum(int(h.valid.sum()) for h in out[0])
        routed["calls"] += 1
        return out

    in_buffers = [0]
    slab_parts = SyncTimer(torch, (
        (sharded, "fold_step_dep_sharded", "fold_step_dep_sharded"),
        (depgraph, "_dispatch_halves", "pairing_dispatch")))
    tick_parts = SyncTimer(torch, (
        (rt, "flush", "flush"), (rt, "td_drain", "td_drain"),
        (sharded, "classify_sharded", "classify"),
        (rt, "publish_snapshot", "publish_snapshot"),
        (rt, "_fleet_roll", "fleet_rollup"),
        (rt, "heavy_recover", "heavy_recover"),
        (rt, "engine_health", "health"),
        (sharded, "tick_5s_sharded", "tick_5s"),
        (depgraph, "age", "dep_age")))
    perf.update({"buffer_ms": [], "tick_ms": [], "tick_parts_ms": [],
                 "sweep_s": []})
    d0 = rt.stats.counters["fold_dispatches"]
    s0 = rt.stats.counters.get("slab_dispatches", 0)
    reset_launches(scatter, mods)
    depgraph._dispatch_halves = counting_dispatch
    try:
        j = RT_WARM_BUFFERS
        for tick in range(SH_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.feed(sweeps[tick + 1])
            torch.cuda.synchronize()
            perf["sweep_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            c0 = routed["calls"]
            with slab_parts:
                for _ in range(SH_BUFFERS):
                    rt.feed(bufs[j % RT_DISTINCT][0])
                    j += 1
            torch.cuda.synchronize()
            in_buffers[0] += routed["calls"] - c0
            perf["buffer_ms"].append((time.perf_counter() - t0)
                                     / SH_BUFFERS * 1e3)
            t0 = time.perf_counter()
            with tick_parts:
                rt.run_tick()
            torch.cuda.synchronize()
            perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            perf["tick_parts_ms"].append(dict(tick_parts.ms))
            tick_parts.ms = {}
            if rt._tick_no == WK_WINDOW:      # phase 14a's window
                oracle["svcstate_t2"] = rt.query(
                    {"subsys": "svcstate", "maxrecs": 200000})
    finally:
        depgraph._dispatch_halves = dispatch
    # phase 14b's oracle: the same frames over its worker rings
    oracle["t_end"] = {name: rt.query({"subsys": name, "maxrecs": 200000})
                    for name in SH_EXACT + ("svcdependency",)}
    oracle["n_paired"] = sum(float(d.n_paired) for d in rt.dep)
    oracle["buffer_ms"] = list(perf["buffer_ms"])
    launches = read_launches(scatter, mods)
    disp = rt.stats.counters["fold_dispatches"] - d0
    slabs = rt.stats.counters.get("slab_dispatches", 0) - s0
    perf["dispatches"], perf["slab_dispatches"] = disp, slabs
    perf["launches"] = launches
    perf["launches_per_slab"] = {k: v / max(disp, 1)
                                 for k, v in launches.items()}
    perf["fold_step_dep_sharded_ms"] = \
        slab_parts.ms.get("fold_step_dep_sharded", 0.0) / max(in_buffers[0], 1)
    perf["pairing_dispatch_ms"] = \
        slab_parts.ms.get("pairing_dispatch", 0.0) / max(in_buffers[0], 1)
    perf["halves_routed"] = routed["lanes"]
    perf["n_dropped"] = sum(float(d.n_dropped) for d in rt.dep)
    perf["n_paired_ticks"] = sum(float(d.n_paired) for d in rt.dep)
    perf["rollup_ms"] = [p.get("fleet_rollup") for p in
                         perf["tick_parts_ms"]]
    ev = scfg.fold_k * (scfg.conn_batch + scfg.resp_batch)
    perf["events_per_s"] = [ev / (m / 1e3) for m in perf["buffer_ms"]]
    perf["phase8_buffer_ms"] = rt_perf["buffer_ms"]
    log(f"  13b: ms a feed buffer by tick "
        f"{', '.join(f'{m:.3f}' for m in perf['buffer_ms'])} "
        f"({', '.join(f'{e:.0f}' for e in perf['events_per_s'])} "
        f"events/s; phase 8's single runtime "
        f"{', '.join(f'{m:.3f}' for m in rt_perf['buffer_ms'])}); "
        f"sweeps {', '.join(f'{s:.2f}' for s in perf['sweep_s'])} s")
    log(f"  13b: {disp} sharded dispatches ({slabs} slabs); launches "
        f"{launches}; fold_step_dep_sharded "
        f"{perf['fold_step_dep_sharded_ms']:.2f} ms a dispatch, its "
        f"pairing dispatch {perf['pairing_dispatch_ms']:.2f} ms; "
        f"{routed['lanes']} halves routed, n_dropped "
        f"{perf['n_dropped']:.0f}, n_paired {perf['n_paired_ticks']:.0f}")
    check(launches == path_launches(SH_N * disp) and slabs > 0,
          f"13b: each of the {disp} sharded dispatches launched "
          f"hll_update {2 * SH_N}x, cms_update, inv_update and the int32 "
          f"scatter-add {SH_N}x (once a shard), no other generic kernel")
    log("  13b: ms a run_tick " + ", ".join(
        f"{m:.1f}" for m in perf["tick_ms"]) + "; parts (synchronised): "
        + " | ".join(", ".join(f"{k} {v:.1f}" for k, v in p.items())
                     for p in perf["tick_parts_ms"]))
    # a buffer stages a quarter of a shard's slab: count over the
    # buffers that fill one slab dispatch
    d0 = rt.stats.counters["fold_dispatches"]
    syncs = count_syncs(torch, lambda: [rt.feed(bufs[i % RT_DISTINCT][0])
                                        for i in range(SH_N)])
    perf["syncs_per_buffer"] = len(syncs) / SH_N
    perf["sync_sites"] = syncs
    log(f"  13b: host syncs over {SH_N} feed buffers "
        f"({rt.stats.counters['fold_dispatches'] - d0} slab dispatch): "
        f"{len(syncs)} at {syncs}")

    # a few SKETCH_DELTA buffers, folded a shard each
    sim = ParthaSim(**NS_SIM, seed=17)
    ef = edgefold.EdgeFold(edgefold.params_of_cfg(scfg), host_id=3)
    recs = ef.fold_sweep(sim.conn_records(scfg.fold_k * scfg.conn_batch),
                         sim.resp_records(scfg.fold_k * scfg.resp_batch))
    dbufs = delta_feed_buffers(wire, recs)[:SH_DELTA_BUFFERS]
    reset_launches(scatter, mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in dbufs:
        rt.feed(b)
    torch.cuda.synchronize()
    perf["delta_ms_per_buffer"] = (time.perf_counter() - t0) \
        / len(dbufs) * 1e3
    perf["launches_delta"] = read_launches(scatter, mods)
    log(f"  13b: {len(dbufs)} delta buffers ({len(recs)} records) "
        f"{perf['delta_ms_per_buffer']:.2f} ms a buffer; launches "
        f"{perf['launches_delta']}")
    ld = perf["launches_delta"]
    check(ld["cms_update"] > 0 and ld["delta_merge"] > 0
          and ld["add_drop"] > 0 and ld["hll_update"]
          == ld["scatter_max"] == ld["scatter_add"] == 0,
          "13b: the delta section launched cms/inv, the one-launch "
          "generic merge and the int32 scatter-add on its shard, and no "
          "single-site generic kernel")

    perf["query_ms"] = {}
    outs = {}
    for name in SH_QUERIES + SH_EXACT:
        if name in outs:
            continue
        req = {"subsys": name, "maxrecs": 200000}
        t0 = time.perf_counter()
        outs[name] = rt.query(dict(req))
        first = (time.perf_counter() - t0) * 1e3
        req["consistency"] = "snapshot"
        rt.query(dict(req))
        t0 = time.perf_counter()
        rt.query(dict(req))
        cached = (time.perf_counter() - t0) * 1e3
        perf["query_ms"][name] = {"first": first, "cached_snapshot": cached,
                                  "nrecs": outs[name]["nrecs"]}
    log("  13b: queries, first / cached ms: " + ", ".join(
        f"{k} {v['first']:.1f} / {v['cached_snapshot']:.2f}"
        for k, v in perf["query_ms"].items()))
    perf["max_memory_allocated_gib"] = \
        torch.cuda.max_memory_allocated() / 2**30
    log(f"  13b: peak device memory {perf['max_memory_allocated_gib']:.3f}"
        " GiB")
    check(outs["svcstate"]["ntotal"] == n_svcs
          and outs["shardlist"]["nrecs"] == SH_N
          and sum(r["nsvc"] for r in outs["shardlist"]["recs"]) == n_svcs,
          f"13b: {n_svcs} services live over the {SH_N} shards "
          f"({[r['nsvc'] for r in outs['shardlist']['recs']]})")
    perf["n_paired"] = sum(float(d.n_paired) for d in rt.dep)
    rt.close()
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # the oracle: one runtime at ns geometry fed the same frames
    one = Runtime(aggstate.EngineCfg(**NS_CFG), RuntimeOpts(**RT_OPTS),
                  device=DEV)
    one.feed(names)
    one.feed(sweeps[0])
    for i in range(RT_WARM_BUFFERS):
        one.feed(bufs[i % RT_DISTINCT][0])
    one.run_tick()
    j = RT_WARM_BUFFERS
    for tick in range(SH_TICKS):
        one.feed(sweeps[tick + 1])
        for _ in range(SH_BUFFERS):
            one.feed(bufs[j % RT_DISTINCT][0])
            j += 1
        one.run_tick()
    for i in range(SH_N):
        one.feed(bufs[i % RT_DISTINCT][0])
    for b in dbufs:
        one.feed(b)
    from gyeeta_tpu_torch.sketch import loghist
    n_q = [0, 0]
    for name in SH_EXACT:
        ref = one.query({"subsys": name, "maxrecs": 200000})
        _json_diff(torch, loghist, scfg, _rows_by_identity(ref),
                   _rows_by_identity(outs[name]), {}, f"13b {name}", n_q)
        check(ref["nrecs"] == outs[name]["nrecs"] > 0,
              f"13b: {name} ({ref['nrecs']} rows) equals the single "
              "runtime's fold of the same frames, row for row (floats "
              "rtol 1e-6)")
    perf["oracle_rounding_apart"] = n_q[1]
    ref = one.query({"subsys": "svcdependency", "maxrecs": 200000})
    mine = {(r["cliid"], r["serid"]): r
            for r in outs["svcdependency"]["recs"]}
    theirs = {(r["cliid"], r["serid"]): r for r in ref["recs"]}
    short = {k: theirs[k]["nconn"] - mine[k]["nconn"] for k in theirs
             if k in mine}
    unpaired = float(one.dep.n_paired) - perf["n_paired"]
    same = [k for k, v in short.items() if v == 0]
    check(set(mine) == set(theirs) and min(short.values()) >= 0
          and sum(short.values()) == unpaired
          and all(math.isclose(mine[k]["bytes"], theirs[k]["bytes"],
                               rel_tol=1e-6) for k in same),
          f"13b: svcdependency holds the single runtime's {len(theirs)} "
          f"edges; {len(same)} equal, {len(short) - len(same)} short by "
          f"{sum(short.values()):.0f} conns = the {unpaired:.0f} pairs "
          "the single runtime made and this one did not (halves of one "
          "flow that met in one sharded dispatch make one pair)")
    perf["dep_edges_short"] = len(short) - len(same)
    perf["pairs_apart"] = unpaired
    ref = one.query({"subsys": "flowstate", "maxrecs": 200000})
    top = (ref["recs"][0]["flowid"], ref["recs"][0]["bytes"])
    got = (outs["flowstate"]["recs"][0]["flowid"],
           outs["flowstate"]["recs"][0]["bytes"])
    check(top == got, f"13b: flowstate's heaviest flow equals the single "
          f"runtime's: {got}")
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return perf


async def sharded_serve_run(torch, scatter, tmp) -> dict:
    """13c: ``serve --shards 4`` (the daemon, in this process) on the
    card over 127.0.0.1 (see sharded_phase)."""
    import asyncio

    from gyeeta_tpu_torch import server_main
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import QueryClient, register
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.utils import crashguard, journal as J

    sim = ParthaSim(**SRV_SH_SIM, seed=23)
    n_svcs = sim.n_hosts * sim.n_svcs
    scfg = aggstate.EngineCfg(**SH_CFG)
    trace_svcs = list(sim.glob_ids.reshape(-1)[::n_svcs // 64])
    frames = [sim.name_frames(), sweep_frames(sim, wire, trace_svcs)] + [
        feed_buffer(sim, scfg, wire)[0] for _ in range(4)]
    cfgf = tmp / "gyt.json"
    cfgf.write_text(json.dumps({"engine": SH_CFG, "runtime": dict(
        RT_OPTS, hist_window_ticks=SRV_SH_WINDOW)}))
    argv = ["--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
            "--tick-interval", str(SRV_SH_TICK_S), "--shards", str(SH_N),
            "--device", DEV, "--journal-dir", str(tmp / "wal"),
            "--shard-dir", str(tmp / "shards"),
            "--compact-interval", "3600", "--log-level", "WARNING"]
    perf = {}
    t0 = time.perf_counter()
    # the daemon's crash forensics would leave a dump file open in the
    # temp dir for the rest of the process
    enable_dumps = crashguard.enable_crash_dumps
    crashguard.enable_crash_dumps = lambda path: None
    d = server_main.Daemon(server_main.parse_args(argv), env={})
    check(isinstance(d.rt, ShardedRuntime) and d.rt.n == SH_N
          and d.srv._feeder is not None and d.compactor is not None,
          f"13c: serve --shards {SH_N} --device {DEV}: a {SH_N}-shard "
          "runtime behind per-shard ingest queues, with a compactor")
    tick_log = _TickFailures()
    logging.getLogger("gyeeta_tpu_torch.net").addHandler(tick_log)
    mods = sketch_modules()
    reset_launches(scatter, mods)
    task = asyncio.create_task(d.run())
    qc, conns = QueryClient(), []
    try:
        await _until(lambda: d.srv._server is not None, "the listener")
        host, port = d.srv.host, d.srv.port
        conns = await _register_agents(register, wire, host, port,
                                       SRV_SH_CONNS)
        ctr = d.rt.stats.counters
        want = 0
        for i, buf in enumerate(frames):
            await _send(conns[i % len(conns)][1], buf)
        recs = [wire.drain2(b)[0] for b in frames]
        want = sum(len(r.get(wire.NOTIFY_TCP_CONN, ())) for r in recs)
        await _until(lambda: ctr.get("conn_events", 0) >= want,
                     "the frames folded")
        perf["feed_s"] = time.perf_counter() - t0
        ticks0, t1 = d.rt._tick_no, time.perf_counter()
        await asyncio.sleep(SRV_SH_LOOP_S)
        # a slower host's ticks take longer: the stretch lasts until the
        # loop has ticked twice, as phase 11's does
        await _until(lambda: d.rt._tick_no - ticks0 >= 2,
                     "two ticks of the server's loop")
        perf["loop_ticks"] = d.rt._tick_no - ticks0
        perf["loop_s"] = time.perf_counter() - t1
        check(perf["loop_ticks"] >= 2 and not tick_log.records,
              f"13c: the server's tick loop ran {perf['loop_ticks']} ticks "
              f"in {perf['loop_s']:.1f} s, none failed")
        await _w(qc.connect(host, port))
        t1 = time.perf_counter()
        sl = await _w(qc.query({"subsys": "shardlist"}))
        perf["shardlist_ms"] = (time.perf_counter() - t1) * 1e3
        sv = await _w(qc.query({"subsys": "svcstate", "maxrecs": 100000}))
        check(sl["nrecs"] == SH_N
              and sum(r["nsvc"] for r in sl["recs"]) == n_svcs
              and sv["ntotal"] == n_svcs,
              f"13c: shardlist {[r['nsvc'] for r in sl['recs']]} and "
              f"svcstate ({sv['ntotal']} services) answered over GYT")
        d.srv._feed_barrier()
        d.rt.journal.fsync()
        subs = [p.name for p in J.sharded_subdirs(tmp / "wal")]
        check(subs == [f"shard_{s:02d}" for s in range(SH_N)],
              f"13c: --journal-dir holds {subs}")
        t1 = time.perf_counter()
        rep = d.compactor.compact_once(seal=True, upto_tick=d.rt._tick_no)
        torch.cuda.synchronize()
        perf["compact_s"] = time.perf_counter() - t1
        perf["compact"] = {k: rep[k] for k in ("chunks", "records",
                                                "windows", "ev_per_sec")}
        ent = d.compactor.store.newest("raw")
        check(rep["windows"] >= 1 and ent is not None
              and d.compactor._rt.device.type == torch.device(DEV).type,
              f"13c: one compaction of the sharded WAL on the card: "
              f"{perf['compact']}, {perf['compact_s']:.2f} s")
        t1 = time.perf_counter()
        at = await _w(qc.query({"subsys": "svcstate", "maxrecs": 100000,
                                "at": f"tick:{ent['tick1']}"}))
        perf["at_ms"] = (time.perf_counter() - t1) * 1e3
        check(at["nrecs"] == n_svcs,
              f"13c: at=tick:{ent['tick1']} svcstate from the compacted "
              f"shard: {at['nrecs']} rows, {perf['at_ms']:.1f} ms")
        perf["launches"] = read_launches(scatter, mods)
        check(perf["launches"]["hll_update"] > 0,
              f"13c: launches while serving and compacting: "
              f"{perf['launches']}")
    finally:
        await qc.close()
        for _, w, _ in conns:
            w.close()
        d.stop_event.set()
        await _w(task)
        logging.getLogger("gyeeta_tpu_torch.net").removeHandler(tick_log)
        crashguard.enable_crash_dumps = enable_dumps
    perf["s"] = time.perf_counter() - t0
    log(f"  13c: {perf}")
    return perf


def sharded_phase(torch, scatter, frames, rt_perf):
    """Phase 13: the sharded runtime (13a tiny card vs CPU, 13b ns ÷ 4 a
    shard against the single runtime, 13c ``serve --shards 4``)."""
    import asyncio
    import shutil
    import tempfile

    log(f"phase 13: the sharded runtime, {SH_N} shards on the card")
    t0 = time.perf_counter()
    out = {"tiny": tiny_sharded_phase(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    oracle = {}
    out["ns"] = sharded_ns_run(torch, scatter, frames, rt_perf, oracle)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="gyt_smoke_shard_"))
    try:
        out["serve"] = asyncio.run(sharded_serve_run(torch, scatter, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    log(f"  phase 13: {out['s']:.1f} s")
    return out, out["ns"]["launches_per_slab"], oracle


# ----------------------------------------------------------- phase 14
WK_PROCS = 4                # compaction and ingest worker processes
WK_WINDOW = 2               # 14a: hist_window_ticks, 13b's tick 2
WK_PROCS_2 = 2              # the second compaction pass, held to the first
WK_TIMEOUT = 300.0          # a barrier of the worker phases, seconds
WK_KILL_BUFFERS = 4         # buffers sent to a worker as it is SIGKILLed
RELAY_CONNS = 2             # agents behind the relay
RELAY_BUFFERS = 4           # 13c-width feed buffers through the relay
RELAY_RESTARTS = 2          # relay process kills and restarts


def shard_split(wire, buf: bytes, n: int) -> list:
    """A multi-host frame buffer → one buffer a shard: records routed by
    ``host_id % n`` as the ingest workers route them, records with no
    host column (the names) to every shard."""
    recs, _, _ = wire.drain2(buf)
    parts = [[] for _ in range(n)]
    for sub, arr in recs.items():
        if "host_id" not in (arr.dtype.names or ()):
            for p in parts:
                p.append(wire.encode_frames_chunked(sub, arr))
            continue
        dest = arr["host_id"].astype(np.int64) % n
        for s in range(n):
            sel = arr[dest == s]
            if len(sel):
                parts[s].append(wire.encode_frames_chunked(sub, sel))
    return [b"".join(p) for p in parts]


def _n_records(wire, buf: bytes) -> int:
    return sum(len(a) for a in wire.drain2(buf)[0].values())


def parted_run(torch, scatter, frames, oracle, tmp) -> tuple:
    """14a: phase 13b's frames up to its tick 2 as a per-shard WAL, one
    shard's records a subdir, compacted by ``ParallelCompactor`` with 4
    and with 2 replay workers on the card (see worker_phase)."""
    import contextlib
    import io

    from gyeeta_tpu_torch import cli
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.history import shards as SH
    from gyeeta_tpu_torch.history.compactproc import ParallelCompactor
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils import journal as J
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    from gyeeta_tpu_torch.utils.selfstats import Stats
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    names, sweeps, bufs, n_svcs = frames
    scfg = aggstate.EngineCfg(**SH_CFG)
    opts = RuntimeOpts(**RT_OPTS, hist_window_ticks=WK_WINDOW)
    perf = {}
    wal = tmp / "wal"
    feeds = [[names, sweeps[0]] + [bufs[i % RT_DISTINCT][0]
                                   for i in range(RT_WARM_BUFFERS)],
             [sweeps[1]] + [bufs[(RT_WARM_BUFFERS + i) % RT_DISTINCT][0]
                            for i in range(SH_BUFFERS)]]
    t0 = time.perf_counter()
    js = [J.Journal(wal / f"shard_{s:02d}") for s in range(SH_N)]
    try:
        for tick, chunks in enumerate(feeds):
            for buf in chunks:
                for s, part in enumerate(shard_split(wire, buf, SH_N)):
                    if part:
                        js[s].append(part, hid=s, tick=tick)
    finally:
        for j in js:
            j.close()
    perf["wal_s"] = time.perf_counter() - t0
    perf["wal_bytes"] = sum(p.stat().st_size for p in wal.rglob("*.gytwal"))
    log(f"  14a: per-shard WAL of 13b's frames to its tick {WK_WINDOW}: "
        f"{perf['wal_bytes'] / 2**20:.1f} MiB in {SH_N} subdirs, "
        f"{perf['wal_s']:.1f} s")

    reps = {}
    for procs in (WK_PROCS, WK_PROCS_2):
        pc = ParallelCompactor(scfg, opts, procs, journal_dir=str(wal),
                               shard_dir=str(tmp / f"parts_{procs}"),
                               stats=Stats(), device=DEV)
        t0 = time.perf_counter()
        try:
            reps[procs] = pc.compact_once(upto_tick=WK_WINDOW)
        finally:
            pc.close()
        reps[procs]["pass_s"] = time.perf_counter() - t0
    rep = reps[WK_PROCS]
    per = rep["per_shard"]
    perf["records"] = rep["records"]
    perf["records_per_s"] = {p: r["records"] / r["pass_s"]
                             for p, r in reps.items()}
    perf["pass_s"] = {p: r["pass_s"] for p, r in reps.items()}
    perf["per_shard"] = {p: {s: {k: v for k, v in ps.items()
                                 if k != "launches"}
                             for s, ps in r["per_shard"].items()}
                         for p, r in reps.items()}
    log(f"  14a: {rep['records']} records compacted by {WK_PROCS} workers "
        f"in {rep['pass_s']:.1f} s ({perf['records_per_s'][WK_PROCS]:.0f}"
        f" records/s, worker start included), by {WK_PROCS_2} in "
        f"{reps[WK_PROCS_2]['pass_s']:.1f} s; per shard (4 workers): "
        + "; ".join(f"{s}: wall {ps['wall_s']:.2f} s, cpu "
                    f"{ps['cpu_s']:.2f} s, compact_emit "
                    f"{ps['emit_ms']:.0f} ms, peak "
                    f"{ps['peak_device_bytes'] / 2**30:.2f} GiB"
                    for s, ps in per.items()))
    check(rep["workers"] == WK_PROCS and rep["windows"] == SH_N
          and reps[WK_PROCS_2]["workers"] == WK_PROCS_2
          and reps[WK_PROCS_2]["records"] == rep["records"] > 0,
          f"14a: {WK_PROCS} and {WK_PROCS_2} workers each emitted one "
          f"window a part over {rep['records']} records")
    tot = {k: sum(ps["launches"][k] for ps in per.values())
           for k in rep["launches"]}
    # each worker's replay runtime counts its conn/resp dispatches (the
    # K-slabs and the (1, B) flushes): the launches' denominator
    n_cr = sum(ps["dispatches"]["connresp_dispatches"]
               for ps in per.values())
    perf["launches"] = tot
    perf["connresp_dispatches"] = n_cr
    perf["launches_per_slab"] = {k: v / max(n_cr, 1)
                                 for k, v in tot.items()}

    def fused_only(ps):
        n = ps["dispatches"]["connresp_dispatches"]
        return n > 0 and ps["launches"] == path_launches(n)

    check(all(fused_only(ps) for ps in per.values()),
          f"14a: each of the workers' {n_cr} replayed conn/resp "
          f"dispatches launched hll_update 2x, cms_update, inv_update and "
          f"the int32 scatter-add once, no other generic kernel: {tot}")

    # the parts of the two passes against each other
    a, b = (SH.open_shard_store(tmp / f"parts_{p}")
            for p in (WK_PROCS, WK_PROCS_2))
    keys = ("level", "tick0", "tick1", "t0", "t1")
    check([{k: e[k] for k in keys} for e in a.shards()]
          == [{k: e[k] for k in keys} for e in b.shards()]
          and a.position() == b.position() and a.tick() == b.tick(),
          f"14a: the root manifests of {WK_PROCS} and {WK_PROCS_2} workers "
          f"publish the same windows {[e['tick1'] for e in a.shards()]} "
          "and positions")
    paths = tree_paths(aggstate.init(scfg, "meta"))
    names = paths + [f"dep{i}" for i in range(
        len(tree_paths(depgraph.init(1, 1, "meta"))))]
    verdicts = {"exact": 0, "close": 0}
    bad, close = [], set()
    for ea, eb in zip(a.shards(), b.shards()):
        for p in range(SH_N):
            kinds = shard_leaf_verdicts(
                torch, names, len(paths),
                a.parts[p].dir / ea["parts"][p]["file"],
                b.parts[p].dir / eb["parts"][p]["file"], "cpu")
            for name, v in kinds.items():
                if v in verdicts:
                    verdicts[v] += 1
                    if v == "close":
                        close.add(name)
                else:
                    bad.append(f"part {p} {name}: {v}")
    perf["parts_leaves"] = dict(verdicts, close_leaves=sorted(close))
    check(not bad, f"14a: the parts of {WK_PROCS} and {WK_PROCS_2} "
          f"workers: {verdicts['exact']} leaves bit-identical, "
          f"{verdicts['close']} float sums within rtol 1e-6 "
          f"({sorted(close)})"
          + (f"; {bad[:4]}" if bad else ""))

    # at= over the parted store against the live oracle at that tick
    qrt = Runtime(scfg, RuntimeOpts(**RT_OPTS, hist_shard_dir=str(
        tmp / f"parts_{WK_PROCS}")), device=DEV)
    try:
        t0 = time.perf_counter()
        at = qrt.query({"subsys": "svcstate", "maxrecs": 200000,
                        "at": f"tick:{WK_WINDOW}"})
        perf["at_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        qrt.close()
    ref = oracle["svcstate_t2"]
    n_q = [0, 0]
    _json_diff(torch, loghist, scfg, _rows_by_identity(ref),
               _rows_by_identity(at), {}, "14a at= svcstate", n_q)
    check(at["nrecs"] == ref["nrecs"] == n_svcs and at["tick"] == WK_WINDOW,
          f"14a: at=tick:{WK_WINDOW} svcstate over the parted store "
          f"({at['nrecs']} rows, {perf['at_ms']:.0f} ms) equals the live "
          f"sharded runtime's at that tick, row for row (floats rtol "
          f"1e-6; {n_q[1]} third-decimal roundings apart)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["compact", "list", "--shard-dir",
                  str(tmp / f"parts_{WK_PROCS}")])
    listing = json.loads(buf.getvalue())
    check([len(e["parts"]) for e in listing["shards"]] == [SH_N]
          and listing["tick"] == WK_WINDOW,
          f"14a: compact list reads the parted root: "
          f"{[(e['tick0'], e['tick1']) for e in listing['shards']]}")
    return perf, perf["launches_per_slab"]


def _ring_ledger(sup, stats) -> dict:
    c = stats.counters
    return {"accepted": sum(h.shm.counter("accepted_records")
                            for h in sup.workers),
            "published": sum(h.shm.counter("published_records")
                             for h in sup.workers),
            "consumed": c.get("ingest_ring_consumed_records", 0),
            "dropped": sum(v for k, v in c.items()
                           if k.startswith("ingest_ring_dropped_records")),
            "accepted_bytes": sum(h.shm.counter("accepted_bytes")
                                  for h in sup.workers)}


async def ingest_procs_run(torch, scatter, frames, oracle, rt_perf,
                           tmp) -> tuple:
    """14b: ``serve --shards 4 --ingest-procs 4`` on the card over
    127.0.0.1 (see worker_phase)."""
    import asyncio
    import signal

    from gyeeta_tpu_torch import server_main
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import register
    from gyeeta_tpu_torch.sketch import loghist

    names, sweeps, bufs, n_svcs = frames
    scfg = aggstate.EngineCfg(**SH_CFG)
    cfgf = tmp / "gyt_ingest.json"
    cfgf.write_text(json.dumps({"engine": SH_CFG, "runtime": RT_OPTS}))
    args = server_main.parse_args([
        "--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
        "--shards", str(SH_N), "--ingest-procs", str(WK_PROCS),
        "--device", DEV, "--log-level", "WARNING"])
    args.tick_interval = None                   # manual ticks
    perf = {}
    d = server_main.Daemon(args, env={})
    rt, sup = d.rt, d.srv._ingest
    check(sup is not None and sup.nprocs == WK_PROCS and rt.n == SH_N,
          f"14b: serve --shards {SH_N} --ingest-procs {WK_PROCS} "
          f"--device {DEV}: a supervisor of {WK_PROCS} ingest workers")
    conns = []
    sent = [0]
    try:
        host, port = await d.srv.start()
        for i in range(WK_PROCS):
            r, w, status, hid = await _w(register(
                host, port, 0x5E1000 + i, wire.CONN_EVENT))
            check(status == wire.REG_OK, f"14b: agent {i} registered")
            conns.append([r, w, hid, 0x5E1000 + i])
        check(sorted(sup.worker_of_hid(c[2]) for c in conns)
              == list(range(WK_PROCS)),
              f"14b: the {WK_PROCS} conns land on the {WK_PROCS} workers "
              f"(hids {[c[2] for c in conns]})")

        def settled():
            lg = _ring_ledger(sup, rt.stats)
            return (lg["accepted_bytes"] >= sent[0]
                    and lg["published"] == lg["accepted"]
                    and lg["consumed"] + lg["dropped"] == lg["published"])

        async def send(i, buf):
            conns[i % len(conns)][1].write(buf)
            await _w(conns[i % len(conns)][1].drain())
            sent[0] += len(buf)
            await _until(settled, "the rings drained", timeout=WK_TIMEOUT)

        def tick():
            d.srv._feed_barrier()
            rt.run_tick()
            sup.broadcast_tick(rt._tick_no)

        t0 = time.perf_counter()
        await send(0, names)
        await send(1, sweeps[0])
        for i in range(RT_WARM_BUFFERS):
            await send(i, bufs[i % RT_DISTINCT][0])
        tick()
        torch.cuda.synchronize()
        perf["warm_s"] = time.perf_counter() - t0
        mods = sketch_modules()
        reset_launches(scatter, mods)
        d0 = rt.stats.counters.get("fold_dispatches", 0)
        perf["buffer_ms"], perf["tick_ms"] = [], []
        perf["tick_parts_ms"] = []
        from gyeeta_tpu_torch.parallel import sharded
        tick_parts = SyncTimer(torch, (
            (d.srv, "_feed_barrier", "feed_barrier"), (rt, "flush", "flush"),
            (rt, "td_drain", "td_drain"),
            (sharded, "classify_sharded", "classify"),
            (rt, "publish_snapshot", "publish_snapshot"),
            (rt, "_fleet_roll", "fleet_rollup"),
            (rt, "heavy_recover", "heavy_recover"),
            (rt.alerts, "check", "alert_check"),
            (rt, "engine_health", "health"),
            (sharded, "tick_5s_sharded", "tick_5s")))
        j = RT_WARM_BUFFERS
        for t in range(SH_TICKS):
            await send(t, sweeps[t + 1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SH_BUFFERS):
                await send(j, bufs[j % RT_DISTINCT][0])
                j += 1
            d.srv._feed_barrier()
            torch.cuda.synchronize()
            perf["buffer_ms"].append((time.perf_counter() - t0)
                                     / SH_BUFFERS * 1e3)
            t0 = time.perf_counter()
            with tick_parts:
                tick()
            torch.cuda.synchronize()
            perf["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            perf["tick_parts_ms"].append(dict(tick_parts.ms))
            tick_parts.ms = {}
        launches = read_launches(scatter, mods)
        disp = rt.stats.counters.get("fold_dispatches", 0) - d0
        perf["launches"] = launches
        perf["dispatches"] = disp
        perf["launches_per_dispatch"] = {k: v / max(disp, 1)
                                         for k, v in launches.items()}
        perf["sharded_13b_buffer_ms"] = oracle["buffer_ms"]
        lg = _ring_ledger(sup, rt.stats)
        perf["ledger"] = lg
        perf["ring_backlog_slots"] = sum(h.shm.backlog()
                                         for h in sup.workers)
        perf["ring_backlog_frac"] = sup.ring_backlog_frac()
        log(f"  14b: ms a buffer wire → ring → fold by tick "
            f"{', '.join(f'{m:.2f}' for m in perf['buffer_ms'])} (13b's "
            f"in-process sharded feed "
            f"{', '.join(f'{m:.2f}' for m in oracle['buffer_ms'])}); "
            f"run_tick {', '.join(f'{m:.0f}' for m in perf['tick_ms'])} "
            f"ms (parts: {perf['tick_parts_ms']}); ring backlog {perf['ring_backlog_slots']} slots; ledger "
            f"{lg}")
        check(launches == path_launches(SH_N * disp) and disp > 0,
              f"14b: each of the {disp} ring-drained sharded dispatches "
              f"launched hll_update {2 * SH_N}x, cms_update, inv_update and "
              f"the int32 scatter-add {SH_N}x, no other generic kernel")
        check(lg["dropped"] == 0 and lg["accepted"] == lg["published"]
              == lg["consumed"] > 0,
              f"14b: the ledger: accepted {lg['accepted']} == published == "
              f"consumed, dropped {lg['dropped']}")

        n_q = [0, 0]
        for name in SH_EXACT:
            ref = oracle["t_end"][name]
            got = rt.query({"subsys": name, "maxrecs": 200000})
            _json_diff(torch, loghist, scfg, _rows_by_identity(ref),
                       _rows_by_identity(got), {}, f"14b {name}", n_q)
            check(ref["nrecs"] == got["nrecs"] > 0,
                  f"14b: {name} ({got['nrecs']} rows) equals 13b's "
                  "in-process sharded runtime fed the same frames, row "
                  "for row")
        perf["oracle_rounding_apart"] = n_q[1]
        ref = oracle["t_end"]["svcdependency"]
        got = rt.query({"subsys": "svcdependency", "maxrecs": 200000})
        mine = {(r["cliid"], r["serid"]): r for r in got["recs"]}
        theirs = {(r["cliid"], r["serid"]): r for r in ref["recs"]}
        # the pairs 13b made and these did not (< 0: these made more).
        # The feed buffers repeat flow keys, and the halves of one flow
        # that land on its pair-table row in one dispatch complete one
        # pair, the extra halves absorbed; the ring drain stages a
        # shard's records at other slab boundaries than 13b, so each
        # flow may pair a different number of times. Every flow whose
        # two halves were fed pairs at least once in either run, so
        # the edge sets are equal, and with equal pair totals so are
        # the edges
        short = {k: (theirs[k]["nconn"] if k in theirs else 0)
                 - (mine[k]["nconn"] if k in mine else 0)
                 for k in set(mine) | set(theirs)}
        apart = oracle["n_paired"] - sum(float(x.n_paired)
                                         for x in rt.dep)
        same = [k for k, v in short.items() if v == 0]
        one_way = (all(v >= 0 for v in short.values()) if apart > 0
                   else all(v <= 0 for v in short.values()))
        check(set(mine) == set(theirs) and one_way
              and sum(short.values()) == apart
              and (apart != 0 or len(same) == len(short))
              and all(math.isclose(mine[k]["bytes"], theirs[k]["bytes"],
                                   rel_tol=1e-6) for k in same),
              f"14b: svcdependency: the {len(theirs)} edges of 13b "
              f"({len(set(mine) - set(theirs))} only here, "
              f"{len(set(theirs) - set(mine))} only there); {len(same)} "
              f"equal, the rest apart in one direction by "
              f"{sum(short.values()):.0f} conns = the {apart:.0f} pairs "
              "one run made and the other did not (halves of one flow "
              "that met in one dispatch make one pair)")
        perf["pairs_apart"] = apart
        perf["dep_edges"] = {"here": len(mine), "13b": len(theirs),
                             "apart": len(short) - len(same)}

        # SIGKILL one worker mid-stream: respawn onto its shard group
        victim = sup.workers[1]
        pid, epoch = victim.proc.pid, victim.shm.epoch()
        i_c = next(i for i, c in enumerate(conns)
                   if sup.worker_of_hid(c[2]) == victim.w)
        lg0 = _ring_ledger(sup, rt.stats)
        for k in range(WK_KILL_BUFFERS):
            conns[i_c][1].write(bufs[k % RT_DISTINCT][0])
            if k == 0:
                os.kill(pid, signal.SIGKILL)
        t0 = time.perf_counter()
        await _until(lambda: sup.poll() > 0 or victim.proc.pid != pid,
                     "the respawn", timeout=WK_TIMEOUT)
        perf["respawn_s"] = time.perf_counter() - t0
        check(victim.proc.pid != pid and victim.shards == [1]
              and rt.stats.counters.get(
                  f"ingest_proc_respawns|proc={victim.w}") == 1,
              f"14b: worker {victim.w} SIGKILLed mid-stream (pid {pid}) and "
              f"respawned onto shards {victim.shards} in "
              f"{perf['respawn_s']:.2f} s")
        conns[i_c][1].close()
        await _until(lambda: victim.shm.epoch() > epoch,
                     "the respawned worker's epoch", timeout=WK_TIMEOUT)
        r, w, status, hid = await _w(register(
            host, port, conns[i_c][3], wire.CONN_EVENT))
        check(status == wire.REG_OK and hid == conns[i_c][2],
              f"14b: the agent reconnected to host id {hid}, the same "
              "shard group")
        conns[i_c][:2] = [r, w]
        lg_r = _ring_ledger(sup, rt.stats)
        buf = bufs[0][0]
        perf["kill_buffer_records"] = _n_records(wire, buf)
        w.write(buf)
        await _w(w.drain())

        def after_kill():
            lg = _ring_ledger(sup, rt.stats)
            return (lg["published"] - lg_r["published"]
                    >= perf["kill_buffer_records"]
                    and lg["consumed"] + lg["dropped"] == lg["published"])
        await _until(after_kill, "the respawned worker's buffer",
                     timeout=WK_TIMEOUT)
        d.srv._feed_barrier()
        lg = _ring_ledger(sup, rt.stats)
        perf["ledger_after_kill"] = lg
        perf["lost_in_killed_worker"] = lg["accepted"] - lg["published"]
        check(lg["published"] == lg["consumed"] + lg["dropped"]
              and lg["accepted"] >= lg["published"]
              and lg["published"] - lg0["published"]
              >= perf["kill_buffer_records"],
              f"14b: the ledger after the kill: published "
              f"{lg['published']} == consumed {lg['consumed']} + dropped "
              f"{lg['dropped']}; accepted {lg['accepted']} (the killed "
              f"worker's unpublished records counted: "
              f"{perf['lost_in_killed_worker']})")
    finally:
        for c in conns:
            c[1].close()
        await d.shutdown()
    return perf, perf["launches_per_dispatch"]


async def relay_run(torch, scatter, tmp) -> dict:
    """14c: a ``relay`` process uplinking into ``serve --shards 4
    --relay-port`` (see worker_phase)."""
    import asyncio

    from gyeeta_tpu_torch import server_main
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import register
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    sim = ParthaSim(**SRV_SH_SIM, seed=29)
    scfg = aggstate.EngineCfg(**SH_CFG)
    n_svcs = sim.n_hosts * sim.n_svcs
    trace_svcs = list(sim.glob_ids.reshape(-1)[::n_svcs // 64])
    frames = [sim.name_frames(), sweep_frames(sim, wire, trace_svcs)] + [
        feed_buffer(sim, scfg, wire)[0] for _ in range(RELAY_BUFFERS)]
    late = [feed_buffer(sim, scfg, wire)[0] for _ in range(RELAY_RESTARTS)]
    cfgf = tmp / "gyt_relay.json"
    cfgf.write_text(json.dumps({"engine": SH_CFG, "runtime": RT_OPTS}))
    args = server_main.parse_args([
        "--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
        "--shards", str(SH_N), "--relay-port", "0", "--device", DEV,
        "--log-level", "WARNING"])
    args.tick_interval = None
    d = server_main.Daemon(args, env={})
    d.srv._relay.host = "127.0.0.1"
    rt, hub = d.rt, d.srv._relay
    perf = {"services": n_svcs}
    relay = None
    conns = []

    def ledger():
        c = rt.stats.counters
        return {k: sum(v for n, v in c.items()
                       if n.startswith(f"relay_{k}_records|relay=smoke"))
                for k in ("published", "consumed", "dropped")}

    async def start_relay(port):
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "gyeeta_tpu_torch", "relay",
            "--supervisor", f"127.0.0.1:{hub.port}", "--relay-id", "smoke",
            "--listen-port", str(port), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        line = (await _w(proc.stdout.readline())).decode().split()
        check(line[:1] == ["RELAY_LISTEN"], f"14c: relay process {line}")
        await _until(lambda: hub.relays_up() == 1, "the relay's uplink")
        return proc, int(line[2])

    async def agents(rport):
        """Register the agents through the relay; a relay refuses them
        until its uplink's HELLO is answered, so a refusal retries."""
        out = []
        for i in range(RELAY_CONNS):
            for _ in range(100):
                try:
                    r, w, status, hid = await _w(register(
                        "127.0.0.1", rport, 0x5E2000 + i,
                        wire.CONN_EVENT))
                    break
                except (ConnectionError, OSError, wire.FrameError,
                        asyncio.IncompleteReadError):
                    await asyncio.sleep(0.05)
            else:
                raise AssertionError(f"14c: agent {i} not registered")
            check(status == wire.REG_OK, f"14c: agent {i} registered "
                  f"through the relay (host id {hid})")
            out.append((r, w))
        return out

    try:
        await d.srv.start()
        t0 = time.perf_counter()
        relay, rport = await start_relay(0)
        perf["relay_start_s"] = time.perf_counter() - t0
        conns = await agents(rport)
        want = 0
        t0 = time.perf_counter()
        for i, buf in enumerate(frames):
            conns[i % len(conns)][1].write(buf)
            await _w(conns[i % len(conns)][1].drain())
            want += _n_records(wire, buf)
            await _until(lambda: ledger()["consumed"] >= want,
                         "the relay's batches", timeout=WK_TIMEOUT)
        perf["feed_s"] = time.perf_counter() - t0
        d.srv._feed_barrier()
        rt.run_tick()
        lg = ledger()
        perf["ledger"] = dict(lg)
        check(lg["published"] == lg["consumed"] == want
              and lg["dropped"] == 0,
              f"14c: the hub's ledger without loss: published "
              f"{lg['published']} == consumed == the {want} records sent, "
              f"0 dropped")
        one = ShardedRuntime(scfg, make_mesh(SH_N, device=DEV),
                             RuntimeOpts(**RT_OPTS))
        try:
            for buf in frames:
                one.feed(buf)
            one.run_tick()
            n_q = [0, 0]
            for name in SH_EXACT:
                ref = one.query({"subsys": name, "maxrecs": 200000})
                got = rt.query({"subsys": name, "maxrecs": 200000})
                _json_diff(torch, loghist, scfg, _rows_by_identity(ref),
                           _rows_by_identity(got), {}, f"14c {name}", n_q)
                check(ref["nrecs"] == got["nrecs"] > 0,
                      f"14c: {name} ({got['nrecs']} rows) through the relay "
                      "equals the in-process edge's, row for row")
        finally:
            one.close()
            del one
        perf["restarts"] = []
        for k in range(RELAY_RESTARTS):
            conns[0][1].write(late[k])
            relay.kill()
            await relay.wait()
            for _, w in conns:
                w.close()
            relay, _ = await start_relay(rport)
            await _until(lambda: rt.stats.counters.get(
                "relay_epochs|relay=smoke", 0) == k + 1,
                "the finalised epoch")
            conns = await agents(rport)
            lg0 = ledger()
            conns[0][1].write(frames[2])
            await _w(conns[0][1].drain())
            add = _n_records(wire, frames[2])
            await _until(lambda: ledger()["consumed"]
                         >= lg0["consumed"] + add,
                         "the restarted relay's batches",
                         timeout=WK_TIMEOUT)
            lg = ledger()
            perf["restarts"].append(dict(lg))
            check(lg["published"] == lg["consumed"] + lg["dropped"],
                  f"14c: relay restart {k + 1}: epoch {k + 1} finalised, "
                  f"published {lg['published']} == consumed "
                  f"{lg['consumed']} + dropped {lg['dropped']} (the loss "
                  "of the killed process counted)")
    finally:
        for _, w in conns:
            w.close()
        if relay is not None and relay.returncode is None:
            relay.kill()
            await relay.wait()
        await d.shutdown()
    log(f"  14c: {perf}")
    return perf


def worker_phase(torch, scatter, frames, oracle, rt_perf):
    """Phase 14: the sharded tier's worker processes (14a parted
    compaction, 14b multi-process ingest, 14c the relay)."""
    import asyncio
    import shutil
    import tempfile

    log(f"phase 14: the sharded tier's worker processes, {WK_PROCS} "
        "workers on the card")
    t0 = time.perf_counter()
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="gyt_smoke_workers_"))
    try:
        out["parted"], part_launches = parted_run(torch, scatter, frames,
                                                  oracle, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["ingest"], ring_launches = asyncio.run(ingest_procs_run(
            torch, scatter, frames, oracle, rt_perf, tmp))
        gc.collect()
        torch.cuda.empty_cache()
        out["relay"] = asyncio.run(relay_run(torch, scatter, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    log(f"  phase 14: {out['s']:.1f} s")
    return out, part_launches, ring_launches


# ----------------------------------------------------------- phase 15
# Its time is bought back from earlier depth: 13b and 14b measure one
# sharded tick (SH_TICKS 1, was 2), phase 10 feeds 2 buffers a tick
# (HIST_BUFFERS, was 4) and samples 1/256 of a shard for deflate (was
# 1/64), phase 11 measures one manual tick (SRV_TICKS, was 2).
# A madhava's geometry: 512 sim hosts × 4 services = 2,048 services at
# the 50 % load of the other phases; 1,024 host slots hold them, the
# chip host's own agent and the chaos agents (512 slots would refuse
# the 513th registration). 8,192 task slots, not 4,096: the 3,072 task
# groups (6 a host) fill 4,096 to 75 %, where the table drops 0-2 of
# them after its 16 probe rounds, in both packages alike, and which
# ones depends on the order they fold in (tests/test_torch_agent.py
# test_task_table_drops_at_madhava_load), so the live server and its
# replay would hold different rows; at 38 % none drop
AG_CFG = dict(n_hosts=1024, svc_capacity=4096, task_capacity=8192)
AG_PROCS = 4                # agent processes of the sim fleet
AG_PER_PROC = 128           # agents a process: 512 sim hosts
AG_SWEEPS = 3               # sweeps every agent sends before the stop
AG_CONN, AG_RESP = 256, 512  # the agent's defaults: records a sweep
AG_REAL_SEED = 9999         # the chip host's agent: a machine id apart
AG_CHAOS = 32               # agents behind the chaos proxy
AG_CHAOS_SEED = 2000
AG_CHAOS_SWEEPS = 4         # sweeps each, at AG_CHAOS_INTERVAL
AG_CHAOS_INTERVAL = 1.0
# a fault every ~32 KB a conn: each agent's first fault lands inside its
# first few 71 KB sweeps (at 64 KB one agent in 32 could go unfaulted)
AG_CHAOS_PROXY = ("--faults", "corrupt,truncate,disconnect", "--seed",
                  "3", "--mean-fault-kb", "32")
# a spool smaller than two sweeps: every reconnect drops (counted)
AG_CHAOS_AGENT = ("--spool-mb", "0.05", "--backoff-base", "0.1",
                  "--backoff-cap", "1.0")
AG_TINY_SEEDS = (31, 32, 33, 34)  # the tiny stream's agents
AG_TINY_SWEEPS = 2
AG_TINY_SWEEP = dict(n_conn=64, n_resp=128)
AG_TIMEOUT = 120.0          # a barrier of the phase, seconds
AG_VIEWS = ("svcstate", "hoststate", "taskstate", "clusterstate")
AG_COST_REPS = 20           # timed sweeps of one agent (host cost)
AG_FEED_SWEEPS = 64         # agents' sweeps in one feed_batch (feed cost)
AG_FEED_ONE = 16            # ... and fed one a feed
AG_HOLD = 2                 # conn/resp dispatches whose fused calls are
#                             held against their plain versions


def feed_cost(torch) -> dict:
    """ms a sweep into a ``Runtime`` on the card at phase 15's geometry:
    one agent's sweep a ``feed`` (a fold boundary a sweep) against
    AG_FEED_SWEEPS agents' sweeps in one ``feed_batch`` (what ``serve``
    does with the conns ready in one loop iteration), fresh hosts in
    each, after a warm-up batch of AG_FEED_SWEEPS."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.net.agent import NetAgent
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sim.partha import ParthaSim
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    bufs = []
    for h in range(2 * AG_FEED_SWEEPS + AG_FEED_ONE):
        a = NetAgent(seed=h)
        a.host_id = h
        a.sim = ParthaSim(n_hosts=1, n_svcs=a.n_svcs, n_groups=a.n_groups,
                          seed=1000 + h, host_base=h)
        bufs.append(a.build_sweep(AG_CONN, AG_RESP))
    n = AG_FEED_SWEEPS
    warm, many, one = bufs[:n], bufs[n:2 * n], bufs[2 * n:]
    rt = Runtime(aggstate.EngineCfg(**AG_CFG), RuntimeOpts(), device=DEV)
    try:
        rt.feed_batch([(b, i, i) for i, b in enumerate(warm)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in one:
            rt.feed(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rt.feed_batch([(b, i, i) for i, b in enumerate(many)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        rt.close()
    return {"sweep_a_feed_ms": (t1 - t0) / AG_FEED_ONE * 1e3,
            "sweeps_a_batch_ms": (t2 - t1) / AG_FEED_SWEEPS * 1e3}


def agent_cost() -> dict:
    """An agent's host cost on this machine's CPU: ms to build one sweep
    at the defaults (simulated), and ms of each real collector's sweep
    of this host (median of AG_COST_REPS, after one to warm up)."""
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net import collect as CL
    from gyeeta_tpu_torch.net.agent import NetAgent
    from gyeeta_tpu_torch.net.taskproc import ProcTaskCollector
    from gyeeta_tpu_torch.net.tcpconn import TcpConnCollector
    from gyeeta_tpu_torch.sim.partha import ParthaSim

    def med_ms(fn):
        fn()
        ts = []
        for _ in range(AG_COST_REPS):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    a = NetAgent(seed=0)
    a.host_id = 0
    a.sim = ParthaSim(n_hosts=1, n_svcs=a.n_svcs, n_groups=a.n_groups,
                      seed=1000, host_base=0)
    buf = a.build_sweep(AG_CONN, AG_RESP)
    out = {"sweep_bytes": len(buf), "sweep_records": wire.count_events(buf),
           "sim_sweep_ms": med_ms(lambda: a.build_sweep(AG_CONN, AG_RESP))}
    tc = TcpConnCollector(host_id=0, machine_id=1)
    tp = ProcTaskCollector(host_id=0, machine_id=1)
    try:
        out["tcpconn_ms"] = med_ms(tc.sweep)
        out["taskproc_ms"] = med_ms(tp.sweep)
    finally:
        tp.close()
    for name, c in (("cpumem_ms", CL.CpuMemCollector()),
                    ("cgroup_ms", CL.CgroupCollector()),
                    ("mount_ms", CL.MountCollector()),
                    ("netif_ms", CL.NetIfCollector())):
        out[name] = med_ms(c.sample)
    out["hostinfo_ms"] = med_ms(CL.collect_host_info)
    return out


def _agent_mid(seed: int) -> int:
    from gyeeta_tpu_torch.utils import hashing as H
    return H.hash_bytes_np(f"sim-agent-{seed}".encode())


async def _spawn(procs, *argv):
    """One ``python -m gyeeta_tpu_torch`` child of this checkout."""
    import asyncio
    p = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "gyeeta_tpu_torch", *argv, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs.append(p)
    return p


async def _finish(p, what, timeout=AG_TIMEOUT) -> tuple:
    """Wait for a child; it must exit 0 → (stdout, stderr) text."""
    out, err = await _w(p.communicate(), timeout)
    out, err = out.decode(), err.decode()
    if p.returncode != 0:
        raise AssertionError(f"{what} exited {p.returncode}: "
                             f"{err[-2000:]}")
    return out, err


async def _until_children(pred, what, procs, detail=lambda: ""):
    """``_until`` that fails at once, with its stderr, when a child of
    the phase exits first, and says what is missing on the deadline."""
    import asyncio
    t0 = time.monotonic()
    while not pred():
        for p in procs:
            if p.returncode is not None:
                err = (await p.stderr.read()).decode()
                raise AssertionError(
                    f"while waiting for {what}: child {p.pid} exited "
                    f"{p.returncode}: {err[-2000:]}")
        if time.monotonic() - t0 > AG_TIMEOUT:
            raise AssertionError(f"timed out waiting for {what}: "
                                 f"{detail()}")
        await asyncio.sleep(0.01)


async def _stop_agents(p, what) -> list:
    """SIGTERM an ``agent`` child (its supervisors stop between
    writes) → its exit report, one entry an agent."""
    import signal
    p.send_signal(signal.SIGTERM)
    out, _ = await _finish(p, what)
    return json.loads(out.strip().splitlines()[-1])["agent_report"]


def _ledger_ok(r) -> bool:
    """An agent's delivery ledger: records built = sent + still buffered
    (spool and unconfirmed tail) + dropped."""
    c = r["counters"]
    return c.get("records_built", 0) == (c.get("records_sent", 0)
                                         + r["spool_records"]
                                         + c.get("spool_dropped_records", 0))


def _capture_records(wire, replay, path) -> dict:
    """Records of each subtype in a GYTREC capture, by host for
    TCP_CONN."""
    buf = b"".join(c for _, c in replay.read_chunks(path))
    recs, used, _ = wire.drain2(buf)
    check(used == len(buf), f"the capture ({len(buf)} bytes) is whole "
          "frames")
    return {"bytes": len(buf), "recs": recs}


def _rows_of(out, key, keep) -> list:
    """The rows of hosts ``keep`` admits, in the order of their
    identity (the fields that name the row, not its numbers)."""
    ident = ("hostid", "svcid", "taskid", "comm", "hostname", "svcname")
    return sorted((r for r in out["recs"] if keep(r.get(key))),
                  key=lambda r: tuple(str(r.get(k)) for k in ident))


def _on(x, dev):
    """A tensor, or a tuple / dict of them, on ``dev``."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_on(v, dev) for v in x)) if hasattr(x, "_fields") \
            else tuple(_on(v, dev) for v in x)
    return x.to(dev) if hasattr(x, "to") else x


class FusedRecorder:
    """Records the fused kernel calls (NS_CALLS' sites) that a path
    makes while ``armed()`` holds, as clones of their inputs, for a
    with-block; :meth:`hold` then holds each against its plain version
    on the CPU on the same inputs."""

    def __init__(self, armed):
        self.armed, self.calls = armed, []
        self.mods = sketch_modules()
        self.kinds = {(m, f): k for k, m, f, *_ in NS_CALLS}

    def __enter__(self):
        self.saved = {mf: getattr(self.mods[mf[0]], mf[1])
                      for mf in self.kinds}
        for (m, f), fn in self.saved.items():
            setattr(self.mods[m], f, self._wrap(m, f, fn))
        return self

    def _wrap(self, m, f, fn):
        def rec(sk, *args, **kw):
            if self.armed():
                self.calls.append((m, f, _clone(sk), _clone(args),
                                   _clone(kw)))
            return fn(sk, *args, **kw)
        return rec

    def __exit__(self, *exc):
        for (m, f), fn in self.saved.items():
            setattr(self.mods[m], f, fn)

    def hold(self, torch) -> dict:
        """Each recorded call: the kernel on the card against the plain
        version on the CPU → the largest error by kernel (hll, inv
        exact; cms rtol 1e-6). Launches here count nothing of a path."""
        err: dict = {}
        for m, f, sk, args, kw in self.calls:
            kind = self.kinds[(m, f)]
            got = _clone(sk)
            getattr(self.mods[m], f)(got, *args, **kw)
            want = _on(sk, "cpu")
            getattr(self.mods[m], f + "_plain")(want, *_on(args, "cpu"),
                                                **_on(kw, "cpu"))
            e = _same_sketch(torch, kind, _on(got, "cpu"), want)
            err[kind] = max(err.get(kind, 0.0), e)
        return err


async def fleet_run(torch, scatter, tmp) -> tuple:
    """15a–15d: the agent fleet into ``serve`` on the card (see
    agent_phase) → (perf, launches a conn/resp dispatch)."""
    import asyncio
    import re

    from gyeeta_tpu_torch import server_main
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net import procconn, taskdelays
    from gyeeta_tpu_torch.net.agent import QueryClient
    from gyeeta_tpu_torch.net.collect import CgroupCollector
    from gyeeta_tpu_torch.utils import replay

    cfgf = tmp / "gyt_agents.json"
    cfgf.write_text(json.dumps({"engine": AG_CFG}))
    cap = tmp / "fleet.gytrec"

    def daemon(record=None):
        args = server_main.parse_args(
            ["--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
             "--device", DEV, "--log-level", "WARNING"]
            + (["--record", str(record)] if record else []))
        # manual ticks: the replay of 15b meets the same tick boundaries
        args.tick_interval = None
        return server_main.Daemon(args, env={})

    perf, procs, daemons = {}, [], []
    stack = contextlib.ExitStack()
    qc = QueryClient(request_timeout=SRV_TIMEOUT)
    sim_mids = [_agent_mid(s) for s in range(AG_PROCS * AG_PER_PROC)]
    real_mid = _agent_mid(AG_REAL_SEED)
    chaos_mids = [_agent_mid(AG_CHAOS_SEED + i) for i in range(AG_CHAOS)]
    # a collector the kernel refuses degrades as the reference does:
    # reported here, by name, not failed
    refused = [name for name, ok in (
        ("procconn (cn_proc multicast join)", procconn.available()),
        ("taskdelays (TASKSTATS genetlink query)", taskdelays.available()),
        ("cgroupstate (cgroup fs)",
         CgroupCollector()._base.exists())) if not ok]
    for name in refused:
        log(f"  15a: collector refused by this host's kernel: {name}")
    perf["collectors_refused"] = refused
    try:
        # ---- 15a: the fleet at full width
        d1 = daemon(cap)
        daemons.append(d1)
        rt, srv = d1.rt, d1.srv
        ctr = rt.stats.counters
        n_cr = [0]
        dispatch = rt._dispatch_fused

        def counting(connresp=None):
            if connresp is not None:
                n_cr[0] += 1
            return dispatch(connresp)
        rt._dispatch_fused = counting
        # the fused calls of the first AG_HOLD conn/resp dispatches,
        # held against their plain versions once the fleet is folded
        held = FusedRecorder(lambda: 1 <= n_cr[0] <= AG_HOLD)
        stack.enter_context(held)
        host, port = await _w(srv.start())
        mods = sketch_modules()
        reset_launches(scatter, mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fleet = [await _spawn(procs, "agent", "--port", str(port),
                              "--n-agents", str(AG_PER_PROC),
                              "--seed", str(i * AG_PER_PROC))
                 for i in range(AG_PROCS)]
        # the chip host's agent registers after the fleet: a one-host
        # sim announces host 0's name as "host-0.sim" on every connect
        # (the reference's bytes, kept), which would rename it were it
        # host 0
        await _until_children(lambda: all(m in srv.hostmap
                                          for m in sim_mids),
                              "the fleet's registrations", fleet)
        real = await _spawn(procs, "agent", "--port", str(port),
                            "--collect", "--real",
                            "--seed", str(AG_REAL_SEED))

        def swept(mids, n):
            last, hm = rt._sweep_last_seq, srv.hostmap
            return all(m in hm and last.get(hm[m], 0) >= n for m in mids)

        def behind(mids, n):
            last, hm = rt._sweep_last_seq, srv.hostmap
            miss = [m for m in mids if m not in hm]
            slow = {hm[m]: last.get(hm[m], 0) for m in mids
                    if m in hm and last.get(hm[m], 0) < n}
            return (f"{len(miss)} not registered "
                    f"(the chip host's: {real_mid in miss}), "
                    f"{len(slow)} behind {dict(list(slow.items())[:8])}, "
                    f"counters { {k: v for k, v in ctr.items() if 'conn' in k or 'frame' in k or 'agent' in k} }")
        await _until_children(
            lambda: swept(sim_mids + [real_mid], AG_SWEEPS),
            f"{AG_SWEEPS} sweeps from each of {len(sim_mids) + 1} agents",
            fleet + [real], lambda: behind(sim_mids + [real_mid], AG_SWEEPS))
        perf["fleet_s"] = time.perf_counter() - t0
        real_comm = Path(f"/proc/{real.pid}/comm").read_text().strip()
        reports = []
        for i, p in enumerate(fleet + [real]):
            reports += await _stop_agents(p, f"agent process {i}")
        by_mid = {r["machine_id"]: r for r in reports}
        hm = srv.hostmap
        # every byte an agent wrote is folded once its conn closes
        await _until(lambda: all(
            rt._sweep_last_seq.get(hm[r["machine_id"]], 0)
            == r["sweep_seq"] for r in reports), "the fleet's last sweeps",
            timeout=AG_TIMEOUT)
        srv._feed_barrier()
        rt.flush()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rt.run_tick()
        torch.cuda.synchronize()
        perf["tick_ms"] = (time.perf_counter() - t1) * 1e3
        health = rt.engine_health()
        check(health["engine_svc_probe_failures"] == 0
              and health["engine_task_probe_failures"] == 0,
              "15a: every service and task group found a table slot "
              "(probe failures: svc "
              f"{health['engine_svc_probe_failures']}, task "
              f"{health['engine_task_probe_failures']})")
        launches = read_launches(scatter, mods)
        perf["launches"], perf["connresp_dispatches"] = launches, n_cr[0]
        perf["max_memory_allocated_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        sim_reps = [by_mid[m] for m in sim_mids]
        sweeps = sum(r["counters"]["sweeps_built"] for r in sim_reps)
        real_hid = hm[real_mid]
        perf["registrations"] = ctr.get("agents_registered", 0)
        perf["sweep_marks"] = ctr.get("sweep_marks", 0)
        perf["sim_sweeps"] = sweeps
        log(f"  15a: {perf['registrations']} agents registered in "
            f"{perf['fleet_s']:.1f} s to {AG_SWEEPS} sweeps each; "
            f"{perf['sweep_marks']} sweeps folded by sequence mark "
            f"({sweeps} of the {len(sim_reps)} sim agents); run_tick "
            f"{perf['tick_ms']:.1f} ms; launches {launches} over "
            f"{n_cr[0]} conn/resp dispatches; peak device memory "
            f"{perf['max_memory_allocated_gib']:.3f} GiB")
        check(perf["registrations"] == len(sim_mids) + 1
              and len(set(hm[m] for m in sim_mids + [real_mid]))
              == len(sim_mids) + 1,
              f"15a: {len(sim_mids)} sim agents and the chip host's "
              "agent registered, each under a host id of its own")
        check(n_cr[0] > 0 and launches == path_launches(n_cr[0]),
              f"15a: each of the {n_cr[0]} conn/resp dispatches of the "
              "fleet's sweeps launched hll_update 2x, cms_update, "
              "inv_update and the int32 scatter-add 1x, no other generic "
              "kernel")
        stack.close()
        n_held = min(n_cr[0], AG_HOLD)
        check(len(held.calls) == len(NS_CALLS) * n_held,
              f"15a: {len(held.calls)} fused calls recorded in the first "
              f"{n_held} conn/resp dispatches")
        perf["held_max_abs_err"] = held.hold(torch)
        held.calls.clear()
        check(True, f"15a: the fused calls of the fleet's first {n_held} "
              "conn/resp dispatches, at this geometry, agree with their "
              "plain versions on the CPU on the same inputs (hll, inv "
              f"exact; cms rtol 1e-6): max_abs_err "
              f"{perf['held_max_abs_err']}")
        check(all(r["spool_len"] == 0 and _ledger_ok(r)
                  and r["counters"]["sweeps_built"] == r["sweep_seq"]
                  >= AG_SWEEPS for r in reports),
              f"15a: every agent's ledger adds up, nothing spooled: "
              f"{sum(r['counters']['records_built'] for r in reports)} "
              "records built = sent")
        capd = _capture_records(wire, replay, cap)
        crecs = capd["recs"]
        real_conns = int((crecs[wire.NOTIFY_TCP_CONN]["host_id"]
                          == real_hid).sum())
        perf["counters"] = {k: ctr.get(k, 0) for k in (
            "conn_events", "resp_events", "sweep_marks",
            "agents_registered", "listener_infos", "host_infos")}
        check(ctr["conn_events"] == AG_CONN * sweeps + real_conns
              == len(crecs[wire.NOTIFY_TCP_CONN])
              and ctr["resp_events"] == AG_RESP * sweeps
              == len(crecs[wire.NOTIFY_RESP_SAMPLE])
              and ctr["sweep_marks"] == sum(
                  r["counters"]["sweeps_built"] for r in reports),
              f"15a: the server folded what the agents report sending: "
              f"{ctr['conn_events']} conns = {AG_CONN} x {sweeps} sim "
              f"sweeps + {real_conns} of the chip host, "
              f"{ctr['resp_events']} resp samples = {AG_RESP} x {sweeps}, "
              f"{ctr['sweep_marks']} sweep marks; the capture holds the "
              "same")
        sim_hids = {hm[m] for m in sim_mids}
        await _w(qc.connect(host, port))

        async def q(name, **kw):
            return await _w(qc.query({"subsys": name, "maxrecs": 100000,
                                      **kw}))
        hs = await q("hoststate")
        sv = await q("svcstate")
        hosts = {r["hostid"] for r in hs["recs"]}
        n_sim_svc = sum(r["hostid"] in sim_hids for r in sv["recs"])
        check(sim_hids <= hosts and n_sim_svc == len(sim_mids) * 4,
              f"15a: hoststate holds the {len(sim_hids)} sim hosts, "
              f"svcstate their {n_sim_svc} live services "
              f"({hs['nrecs']} hosts, {sv['nrecs']} services in all)")
        rid = real_hid
        hi = [r for r in (await q("hostinfo"))["recs"]
              if r.get("hostid") == rid]
        node = os.uname().nodename
        check(len(hi) == 1 and hi[0].get("host") == node,
              f"15a: the chip host's hostinfo row names {node!r}: "
              f"{[{k: r.get(k) for k in ('hostid', 'host', 'dist')} for r in hi]}")
        si = [r for r in (await q("svcinfo"))["recs"]
              if r.get("hostid") == rid]
        check(any(r.get("port") == port for r in si),
              f"15a: the chip host's {len(si)} listeners include serve's "
              f"own port {port}")
        cm = [r for r in (await q("cpumem"))["recs"]
              if r.get("hostid") == rid]
        check(len(cm) >= 1, f"15a: cpumem carries the chip host's agent "
              f"({len(cm)} rows)")
        if "cgroupstate (cgroup fs)" not in refused:
            cg = [r for r in (await q("cgroupstate"))["recs"]
                  if r.get("hostid") == rid]
            check(len(cg) >= 1, f"15a: cgroupstate carries the chip "
                  f"host's agent ({len(cg)} cgroups)")
        ts = [r for r in (await q("taskstate"))["recs"]
              if r.get("hostid") == rid]
        check(any(r.get("comm") == real_comm for r in ts),
              f"15a: a taskstate group {real_comm!r} for the agents' "
              f"processes, among the chip host's {len(ts)} groups")
        live = {n: await q(n) for n in AG_VIEWS}
        await qc.close()

        # ---- 15b: replay of the capture into a second server
        t1 = time.perf_counter()
        d2 = daemon()
        daemons.append(d2)
        rt2, srv2 = d2.rt, d2.srv
        h2, p2 = await _w(srv2.start())
        rp = await _spawn(procs, "replay", str(cap), "--port", str(p2))
        _, err = await _finish(rp, "replay")
        m = re.search(r"replayed (\d+) bytes", err)
        perf["replayed_bytes"] = int(m.group(1)) if m else None
        check(perf["replayed_bytes"] == capd["bytes"],
              f"15b: replay printed 'replayed {perf['replayed_bytes']} "
              f"bytes', the capture's {capd['bytes']}")
        c2 = rt2.stats.counters
        await _until(lambda: all(c2.get(k, 0) == ctr.get(k, 0) for k in (
            "conn_events", "resp_events", "sweep_marks")),
            "the replayed stream folded", timeout=AG_TIMEOUT)
        srv2._feed_barrier()
        rt2.flush()
        rt2.run_tick()
        torch.cuda.synchronize()
        # start, the replay process, the fold and a tick; then the views
        perf["replay_fold_s"] = time.perf_counter() - t1
        qc2 = QueryClient(request_timeout=SRV_TIMEOUT)
        await _w(qc2.connect(h2, p2))
        try:
            for name in AG_VIEWS:
                got = await _w(qc2.query({"subsys": name,
                                          "maxrecs": 100000}))
                key = "hostid" if any("hostid" in r for r in
                                      live[name]["recs"]) else None
                keep = ((lambda h: h in sim_hids) if key
                        else (lambda _h: True))
                a = _rows_of(live[name], key, keep)
                b = _rows_of(got, key, keep)
                # float sums the card's atomics added in another order:
                # rtol 1e-6, or one unit in the JSON's third decimal
                n_apart = [0, 0]
                _sum_json_diff(a, b, f"15b {name}", n_apart, 0.0)
                check(len(a) > 0,
                      f"15b: {name}: the replayed server's {len(b)} rows of "
                      "the sim hosts equal the live server's, row for row "
                      f"({n_apart[0]} values within rtol 1e-6, "
                      f"{n_apart[1]} one unit apart in the third decimal)")
                perf[f"replay_apart_{name}"] = n_apart
        finally:
            await qc2.close()
        await d2.shutdown()
        daemons.remove(d2)
        perf["replay_s"] = time.perf_counter() - t1

        # ---- 15c: the chaos proxy between 32 agents and the server
        t1 = time.perf_counter()
        n_hosts0 = len(hm)
        reconn0 = ctr.get("agent_reconnects", 0)
        chaos = await _spawn(procs, "chaos", "--upstream-port", str(port),
                             "--listen-port", "0", *AG_CHAOS_PROXY)
        line = (await _w(chaos.stdout.readline())).decode().split()
        check(line[:3] == ["chaos", "proxy", "on"],
              f"15c: the chaos proxy listens: {' '.join(line)}")
        cport = int(line[3].rsplit(":", 1)[1])
        ca = await _spawn(procs, "agent", "--port", str(cport),
                          "--n-agents", str(AG_CHAOS), "--seed",
                          str(AG_CHAOS_SEED), "--interval",
                          str(AG_CHAOS_INTERVAL), *AG_CHAOS_AGENT)
        await _until_children(
            lambda: swept(chaos_mids, AG_CHAOS_SWEEPS)
            and ctr.get("agent_reconnects", 0) - reconn0 >= 3 * AG_CHAOS,
            f"{AG_CHAOS_SWEEPS} sweeps from each chaos agent and "
            f"{3 * AG_CHAOS} reconnects", [chaos, ca],
            lambda: behind(chaos_mids, AG_CHAOS_SWEEPS))
        creps = await _stop_agents(ca, "the chaos agents")
        import signal
        chaos.send_signal(signal.SIGTERM)
        cout, _ = await _finish(chaos, "the chaos proxy")
        pstats = json.loads(cout.strip().splitlines()[-1])["chaos_stats"]
        perf["chaos_s"] = time.perf_counter() - t1
        perf["chaos_proxy"] = pstats
        tot = {k: sum(r["counters"].get(k, 0) for r in creps) for k in (
            "agent_reconnects", "spool_resent", "spool_dropped",
            "spool_dropped_records", "sweeps_built", "records_built")}
        perf["chaos_agents"] = tot
        bad = {k: ctr.get(k, 0) for k in ctr if k.startswith(
            ("frames_bad", "frame_err", "conn_errors"))}
        perf["chaos_server"] = {"agent_reconnects": ctr.get(
            "agent_reconnects", 0) - reconn0, **{k: ctr.get(k, 0) for k in (
                "spool_resent", "spool_dropped", "spool_dropped_records")},
            **bad}
        log(f"  15c: proxy {pstats}; agents {tot}; server "
            f"{perf['chaos_server']}")
        check(sum(pstats.get(k, 0) for k in ("corrupt", "truncate",
                                             "disconnect")) > 0
              and sum(bad.values()) > 0,
              f"15c: the proxy injected faults and the server counted its "
              f"frame errors {bad}, and stayed up")
        check(len(hm) - n_hosts0 == AG_CHAOS and all(
            r["host_id"] == hm[r["machine_id"]]
            and r["counters"].get("agent_reconnects", 0) >= 1
            for r in creps),
              f"15c: every chaos agent reconnected under its first host "
              f"id ({tot['agent_reconnects']} reconnects, "
              f"{len(hm) - n_hosts0} host ids for {AG_CHAOS} agents)")
        check(0 < ctr.get("spool_resent", 0) <= tot["spool_resent"]
              and 0 < ctr.get("spool_dropped", 0) <= tot["spool_dropped"]
              and perf["chaos_server"]["agent_reconnects"]
              >= tot["agent_reconnects"],
              f"15c: the agents' reconnect, spool-resend and spool-drop "
              f"counters reached the server: {perf['chaos_server']}")
        check(all(_ledger_ok(r) and r["counters"]["sweeps_built"]
                  == r["sweep_seq"] for r in creps),
              f"15c: each chaos agent's ledger adds up: {tot['records_built']}"
              f" records built = sent + spooled + "
              f"{tot['spool_dropped_records']} dropped")

        # ---- 15d: the clients
        t1 = time.perf_counter()
        nm = await _spawn(procs, "nm", "probe", "--crud", "--port", str(port))
        top = await _spawn(procs, "obs", "top", "--once", "--port", str(port))
        met = await _spawn(procs, "obs", "metrics", "--port", str(port))
        (_, nm_err), (top_out, _), (met_out, _) = await asyncio.gather(
            _finish(nm, "nm probe --crud"), _finish(top, "obs top --once"),
            _finish(met, "obs metrics"))
        check("nm probe: OK" in nm_err, "15d: nm probe --crud exits 0")
        check(top_out.startswith("gyt self-monitor"),
              f"15d: obs top --once renders a frame "
              f"({len(top_out.splitlines())} lines)")
        check(all(f"gyt_{k}" in met_out for k in (
            "agent_reconnects", "spool_resent", "spool_dropped")),
              "15d: obs metrics holds the agents' counters")
        perf["clients_s"] = time.perf_counter() - t1
    finally:
        stack.close()
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for d in daemons:
            await d.shutdown()
    return perf, launches


async def tiny_agent_run(device) -> dict:
    """The tiny stream: four of the port's agents with fixed seeds, two
    sweeps each, into a ``GytServer`` over ``Runtime(device=...)`` with
    a clock of 5 s a tick → tick reports, the served JSON, the bytes."""
    from gyeeta_tpu_torch.net.agent import NetAgent, QueryClient
    from gyeeta_tpu_torch.net.server import GytServer
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    now = [1.7e9]
    rt = Runtime(tiny_rt_cfg(), RuntimeOpts(**TINY_RT_OPTS),
                 clock=lambda: now[0], device=device)
    srv = GytServer(rt, host="127.0.0.1", port=0, tick_interval=None,
                    idle_timeout=0)
    ctr = rt.stats.counters
    agents = [NetAgent(seed=s) for s in AG_TINY_SEEDS]
    out = {"reports": [], "bufs": []}
    qc = None
    try:
        host, port = await _w(srv.start())
        for a in agents:      # one at a time: the same host ids each run
            n0 = ctr.get("names_interned", 0)
            await _w(a.connect(host, port))
            await _until(lambda: ctr.get("names_interned", 0) > n0,
                         "a tiny agent's inventory")
        for _ in range(AG_TINY_SWEEPS):
            for a in agents:
                marks = ctr.get("sweep_marks", 0)
                buf = a.build_sweep(**AG_TINY_SWEEP)
                a._writer.write(buf)
                await _w(a._writer.drain())
                out["bufs"].append(buf)
                await _until(lambda: ctr.get("sweep_marks", 0) > marks,
                             "a tiny sweep")
            srv._feed_barrier()
            rt.flush()
            now[0] += 5.0
            out["reports"].append(rt.run_tick())
        prime_vips(rt)
        qc = QueryClient(request_timeout=SRV_TIMEOUT)
        await _w(qc.connect(host, port))
        out["json"] = {name: await _w(qc.query({"subsys": name,
                                                "maxrecs": 10000}))
                       for name in RT_SERVED + RT_NEW}
        st = rt.state.flow_topk
        out["mass"] = float(st.evicted) + float(st.counts.sum())
    finally:
        if qc is not None:
            await qc.close()
        for a in agents:
            await a.close()
        await srv.stop()
    return out


def agent_phase(torch, scatter):
    """Phase 15: the port's agent tier into ``serve`` on the card."""
    import asyncio
    import shutil
    import tempfile

    from gyeeta_tpu_torch.sketch import loghist

    t0 = time.perf_counter()
    log(f"phase 15: the agent fleet into serve on the card: "
        f"{AG_PROCS} x {AG_PER_PROC} sim agents and the chip host's own "
        f"agent, a replay, {AG_CHAOS} agents behind the chaos proxy, the "
        "clients")
    cost = agent_cost()
    log(f"  15: an agent's host cost (this machine's CPU, median ms): "
        f"{cost}")
    cost["server_feed"] = feed_cost(torch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  15: the server's ms a sweep on the card, one agent's sweep a "
        f"feed vs {AG_FEED_SWEEPS} in one batch: {cost['server_feed']}")
    tmp = Path(tempfile.mkdtemp(prefix="gyt_smoke_agents_"))
    try:
        perf, launches = asyncio.run(fleet_run(torch, scatter, tmp))
        perf["host_cost"] = cost
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("  15e: the tiny agent stream, card server vs CPU server")
    g = asyncio.run(tiny_agent_run(DEV))
    c = asyncio.run(tiny_agent_run("cpu"))
    check(g["bufs"] == c["bufs"], "15e: the agents sent the same bytes "
          "to both servers")
    check(g["reports"] == c["reports"], f"15e: tick reports equal card vs "
          f"CPU: {c['reports']}")
    tcfg = tiny_rt_cfg()
    moved = {k: _moved(torch, loghist, getattr(tcfg, k), v)
             for k, v in hist_inputs(c["bufs"]).items()}
    n_q, n_sum = [0, 0], [0, 0]
    for name in c["json"]:
        # evictedbytes / errbound: differences of float sums, held to
        # the top-K mass rule
        got = _settle_sum_fields(c["json"][name], g["json"][name],
                                 c["mass"], n_sum)
        _json_diff(torch, loghist, tcfg, c["json"][name], got, moved, name,
                   n_q)
    check(True, f"15e: JSON of {len(c['json'])} subsystems over the GYT "
          f"edge agrees card vs CPU ({n_q[0]} quantiles one loghist bucket "
          f"apart, {n_q[1]} values one unit apart in the third decimal, "
          f"{n_sum[0]} evictedbytes/errbound values within their rules)")
    perf["tiny_json_bucket_apart"], perf["tiny_json_rounding_apart"] = n_q
    perf["tiny_json_sum_apart"] = n_sum[0]
    perf["phase_s"] = time.perf_counter() - t0
    log(f"  phase 15: {perf['phase_s']:.1f} s")
    n = max(perf["connresp_dispatches"], 1)
    return perf, {k: v / n for k, v in launches.items()}


# ------------------------------------------------------------------ phase 16
TR_REAL_SEED = 9998         # 16a: the capturing agent, a machine id apart
TR_INTERVAL = 1.0           # ... its sweep interval, s
TR_CONNS = 16               # ... conns a live service
TR_TXNS = 32                # ... transactions a live conn
TR_ROUNDS = 8               # ... client rounds, each right after a sweep
TR_ERR_LIVE = 16            # ... one live transaction in 16 an error
TR_HOSTS = 64               # 16b: phase 15's first 64 sim host ids
TR_HOST_SVCS = 4            # ... four traced services each
TR_CONN_TXNS = 256          # ... one conn a service, 256 transactions
TR_ERR_PCAP = 32            # ... one in 32 an error
TR_SWEEPS = 2               # ... the records sent over two sweeps
TR_SEED = 16                # ... the lognormal latencies' draws
TR_LAT_MU, TR_LAT_SIGMA = math.log(800.0), 1.1     # usec
TR_T0 = 1_700_000_000_000_000                      # the pcap's clock, usec
TR_TIMEOUT = 120.0


def _be32(n: int) -> bytes:
    return n.to_bytes(4, "big")


class _TrProto:
    """One traced protocol, as a conn's server answers it: ``feed``
    frames the client's bytes and returns the replies to the complete
    messages. A reply is a function of the request and of the conn's
    transaction count (one transaction in ``err_every`` errs), so the
    client runs the same model beside its socket and knows every reply
    before it reads it; the pcap of 16b is written from the same
    exchanges. ``request(t, k)`` is the client's t-th API template for
    its k-th transaction; ``APIS[t]`` the signature it normalises to;
    ``bytes_in`` / ``bytes_out`` what the parser counts of a request
    and its reply. Bytes are built as the reference's trace tests build
    them (tests/test_trace.py, test_parsers2.py, test_tds.py)."""

    name = ""
    APIS: tuple = ()

    def __init__(self, err_every: int):
        self.err_every = err_every
        self.n = self.nerr = 0
        self.buf = b""

    def _txn(self) -> bool:
        err = self.n % self.err_every == self.err_every - 1
        self.n += 1
        self.nerr += err
        return err

    def opening(self) -> bytes:
        return b""

    def feed(self, data: bytes) -> bytes:
        self.buf += data
        out = b""
        while (msg := self._next()) is not None:
            out += self.reply(msg)
        return out

    def bytes_in(self, req: bytes) -> int:
        return len(req)

    def bytes_out(self, resp: bytes) -> int:
        return len(resp)


class _TrHttp1(_TrProto):
    name = "http1"
    REQS = (("GET", "/api/v1/users/{k}"),
            ("GET", "/api/v1/orders/{k}/items?page=2"),
            ("POST", "/api/v1/orders"), ("PUT", "/api/v1/carts/{k}"),
            ("DELETE", "/api/v1/sessions/{k}"), ("GET", "/healthz"))
    APIS = ("GET /api/v1/users/{}", "GET /api/v1/orders/{}/items",
            "POST /api/v1/orders", "PUT /api/v1/carts/{}",
            "DELETE /api/v1/sessions/{}", "GET /healthz")

    def request(self, t, k):
        m, p = self.REQS[t]
        return (f"{m} {p.format(k=k)} HTTP/1.1\r\nHost: svc\r\n"
                "Content-Length: 0\r\n\r\n").encode()

    def _next(self):
        i = self.buf.find(b"\r\n\r\n")
        if i < 0:
            return None
        head, self.buf = self.buf[:i + 4], self.buf[i + 4:]
        return head

    def reply(self, head):
        if self._txn():
            return (b"HTTP/1.1 500 Internal Server Error\r\n"
                    b"Content-Length: 3\r\n\r\nerr")
        if self.n % TR_TXNS == 7:             # one chunked body in 32
            return (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                    b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
        return b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"

    def bytes_out(self, resp):
        return resp.index(b"\r\n\r\n") + 4


class _TrPg(_TrProto):
    name = "postgres"
    SQL = (("Q", "SELECT * FROM accounts WHERE id = {k}"),
           ("P", "SELECT name FROM users WHERE id = $1"),
           ("Q", "UPDATE accounts SET balance = {k}.50 WHERE id = {k}"),
           ("Q", "INSERT INTO ledger VALUES ({k}, 'note {k}')"),
           ("P", "DELETE FROM carts WHERE id = $1"),
           ("Q", "SELECT count(*) FROM orders WHERE ts > {k}"))
    APIS = ("SELECT * FROM accounts WHERE id = $",
            "SELECT name FROM users WHERE id = $$",
            "UPDATE accounts SET balance = $ WHERE id = $",
            "INSERT INTO ledger VALUES ($, $)",
            "DELETE FROM carts WHERE id = $$",
            "SELECT count(*) FROM orders WHERE ts > $")

    def __init__(self, err_every):
        super().__init__(err_every)
        self.started = False

    @staticmethod
    def msg(typ: bytes, body: bytes) -> bytes:
        return typ + _be32(4 + len(body)) + body

    def opening(self):
        body = _be32(196608) + b"user\x00app\x00database\x00app\x00\x00"
        return _be32(4 + len(body)) + body        # startup, protocol 3.0

    def request(self, t, k):
        typ, sql = self.SQL[t]
        sql = sql.format(k=k).encode()
        if typ == "Q":
            return self.msg(b"Q", sql + b"\x00")
        # extended query: Parse, Bind, Execute, Sync in one write
        return (self.msg(b"P", b"\x00" + sql + b"\x00\x00\x00")
                + self.msg(b"B", b"\x00\x00" + b"\x00" * 6)
                + self.msg(b"E", b"\x00" + _be32(0))
                + self.msg(b"S", b""))

    def _next(self):
        if not self.started:
            if len(self.buf) < 4 or len(self.buf) < int.from_bytes(
                    self.buf[:4], "big"):
                return None
            ln = int.from_bytes(self.buf[:4], "big")
            self.buf = self.buf[ln:]
            self.started = True
            return b""                            # the startup packet
        if len(self.buf) < 5:
            return None
        ln = int.from_bytes(self.buf[1:5], "big")
        if len(self.buf) < 1 + ln:
            return None
        m, self.buf = self.buf[:1 + ln], self.buf[1 + ln:]
        return m

    def reply(self, m):
        if not m:                                 # AuthenticationOk
            return self.msg(b"R", _be32(0)) + self.msg(b"Z", b"I")
        typ = m[:1]
        if typ not in (b"Q", b"S"):
            return b""
        if self._txn():
            body = self.msg(b"E", b"SERROR\x00C42P01\x00Mrelation does not "
                            b"exist\x00\x00")
        elif typ == b"Q":
            body = (self.msg(b"T", b"\x00\x01id\x00" + b"\x00" * 18)
                    + self.msg(b"D", b"\x00\x01" + _be32(1) + b"1")
                    + self.msg(b"C", b"SELECT 1\x00"))
        else:
            body = (self.msg(b"1", b"") + self.msg(b"2", b"")
                    + self.msg(b"C", b"SELECT 1\x00"))
        return body + self.msg(b"Z", b"I")

    def bytes_in(self, req):
        return 1 + int.from_bytes(req[1:5], "big")    # the Q or P message


class _TrMongo(_TrProto):
    name = "mongo"
    CMDS = (("find", "orders"), ("insert", "users"), ("update", "carts"),
            ("delete", "sessions"), ("aggregate", "events"),
            ("count", "ledger"))
    APIS = tuple(f"{c} {v}" for c, v in CMDS)
    OP_MSG = 2013

    @staticmethod
    def doc(*items) -> bytes:
        body = b""
        for name, val in items:
            nm = name.encode() + b"\x00"
            if isinstance(val, float):
                body += b"\x01" + nm + struct.pack("<d", val)
            elif isinstance(val, int):
                body += b"\x10" + nm + struct.pack("<i", val)
            else:
                s = val.encode() + b"\x00"
                body += b"\x02" + nm + struct.pack("<i", len(s)) + s
        return struct.pack("<i", 4 + len(body) + 1) + body + b"\x00"

    def msg(self, reqid, respto, doc) -> bytes:
        body = b"\x00\x00\x00\x00" + b"\x00" + doc    # flags, kind-0 section
        return struct.pack("<iiii", 16 + len(body), reqid, respto,
                           self.OP_MSG) + body

    def opening(self):
        return self.msg(1, 0, self.doc(("hello", 1), ("$db", "admin")))

    def request(self, t, k):
        c, v = self.CMDS[t]
        return self.msg(k + 2, 0, self.doc((c, v), ("limit", k % 97),
                                           ("$db", "app")))

    def _next(self):
        if len(self.buf) < 4:
            return None
        ln = int.from_bytes(self.buf[:4], "little")
        if len(self.buf) < ln:
            return None
        m, self.buf = self.buf[:ln], self.buf[ln:]
        return m

    def reply(self, m):
        reqid = struct.unpack_from("<i", m, 4)[0]
        # the hello is conn chatter the parser skips: no transaction
        err = reqid != 1 and self._txn()
        d = (self.doc(("ok", 0.0), ("errmsg", "E11000 duplicate key"),
                      ("code", 11000)) if err
             else self.doc(("ok", 1.0), ("n", 1)))
        return self.msg(reqid + 1_000_000, reqid, d)


def _huffman(s: bytes) -> bytes:
    """HPACK Huffman encoding (RFC 7541 Appendix B) of ``s``."""
    from gyeeta_tpu_torch.trace.http2 import _HUFF
    acc = nbits = 0
    out = bytearray()
    for ch in s:
        code, bits = _HUFF[ch]
        acc, nbits = (acc << bits) | code, nbits + bits
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:                                     # pad with EOS's ones
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


class _TrH2(_TrProto):
    name = "http2"
    REQS = (("GET", "/v2/items/{k}", False), ("POST", "/pkg.Cart/Add", True),
            ("GET", "/v2/users/{k}", False),
            ("POST", "/pkg.Cart/Remove", True),
            ("PUT", "/v2/profiles/{k}", False),
            ("DELETE", "/v2/tokens/{k}", False))
    APIS = ("GET /v2/items/{}", "POST /pkg.Cart/Add", "GET /v2/users/{}",
            "POST /pkg.Cart/Remove", "PUT /v2/profiles/{}",
            "DELETE /v2/tokens/{}")
    PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
    HEADERS, DATA = 0x1, 0x0
    END_STREAM, END_HEADERS = 0x1, 0x4

    def __init__(self, err_every):
        super().__init__(err_every)
        self.preface = False

    @staticmethod
    def frame(ftype, flags, sid, payload) -> bytes:
        return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                + sid.to_bytes(4, "big") + payload)

    @staticmethod
    def hstr(s: bytes) -> bytes:
        enc = _huffman(s)
        return bytes([0x80 | len(enc)]) + enc

    def opening(self):
        return self.PREFACE

    def request(self, t, k):
        method, path, grpc = self.REQS[t]
        sid = 2 * k + 1
        block = {"GET": b"\x82", "POST": b"\x83"}.get(method) or (
            b"\x02" + bytes([len(method)]) + method.encode())
        block += b"\x04" + self.hstr(path.format(k=k).encode())
        if not grpc:
            return self.frame(self.HEADERS, self.END_HEADERS
                              | self.END_STREAM, sid, block)
        block += b"\x0f\x10" + self.hstr(b"application/grpc")
        return (self.frame(self.HEADERS, self.END_HEADERS, sid, block)
                + self.frame(self.DATA, self.END_STREAM, sid,
                             b"\x00" + _be32(3) + b"abc"))

    def _next(self):
        if not self.preface:
            if len(self.buf) < len(self.PREFACE):
                return None
            self.buf = self.buf[len(self.PREFACE):]
            self.preface = True
        if len(self.buf) < 9:
            return None
        n = int.from_bytes(self.buf[:3], "big")
        if len(self.buf) < 9 + n:
            return None
        f, self.buf = self.buf[:9 + n], self.buf[9 + n:]
        return f

    def reply(self, f):
        ftype, flags = f[3], f[4]
        sid = int.from_bytes(f[5:9], "big") & 0x7FFFFFFF
        if not flags & self.END_STREAM:
            return b""
        err = self._txn()
        if ftype == self.HEADERS:                 # a plain request
            return (self.frame(self.HEADERS, self.END_HEADERS, sid,
                               b"\x8e" if err else b"\x88")
                    + self.frame(self.DATA, self.END_STREAM, sid, b"ok"))
        trailers = b"\x00" + self.hstr(b"grpc-status") + self.hstr(
            b"13" if err else b"0")
        if err:
            trailers += (b"\x00" + self.hstr(b"grpc-message")
                         + self.hstr(b"internal"))
        return (self.frame(self.HEADERS, self.END_HEADERS, sid,
                           b"\x88\x0f\x10" + self.hstr(b"application/grpc"))
                + self.frame(self.DATA, 0, sid, b"\x00" + _be32(2) + b"ok")
                + self.frame(self.HEADERS, self.END_HEADERS
                             | self.END_STREAM, sid, trailers))

    def bytes_in(self, req):
        return int.from_bytes(req[:3], "big")     # the header block

    def bytes_out(self, resp):
        off = last = 0
        while off < len(resp):                    # the last header block
            n = int.from_bytes(resp[off:off + 3], "big")
            if resp[off + 3] == self.HEADERS:
                last = n
            off += 9 + n
        return last


class _TrTds(_TrProto):
    name = "sybase"
    LANG, LOGIN, RPC, RESPONSE, NORMAL = 1, 2, 3, 4, 15
    REQS = (("lang", "select * from orders where id = {k}"),
            ("rpc", "sp_who2"),
            ("token", "update t set x = 'abc' where k={k}"),
            ("dbrpc", "sp_helpdb"),
            ("lang", "insert into audit values ({k}, 'x')"),
            ("lang", "delete from carts where id = {k}"))
    APIS = ("select * from orders where id = $", "EXEC sp_who2",
            "update t set x = $ where k=$", "EXEC sp_helpdb",
            "insert into audit values ($, $)",
            "delete from carts where id = $")

    @staticmethod
    def pkt(ptype, body) -> bytes:
        return struct.pack(">BBH", ptype, 0x01, 8 + len(body)) + \
            b"\x00\x00\x00\x00"

    def packet(self, ptype, body):
        return self.pkt(ptype, body) + body

    @staticmethod
    def done(status=0, count=1) -> bytes:
        return b"\xfd" + struct.pack("<HHI", status, 0, count)

    def opening(self):
        return self.packet(self.LOGIN, b"\x00" * 64)

    def request(self, t, k):
        kind, s = self.REQS[t]
        s = s.format(k=k).encode()
        if kind == "lang":
            return self.packet(self.LANG, s)
        if kind == "rpc":
            return self.packet(self.RPC, bytes([len(s)]) + s + b"\x00\x00")
        if kind == "token":                       # a LANGUAGE token
            return self.packet(self.NORMAL, b"\x21" + struct.pack(
                "<I", 1 + len(s)) + b"\x00" + s)
        seg = bytes([len(s)]) + s + b"\x00\x00"   # a DBRPC token
        return self.packet(self.NORMAL, b"\xe6" + struct.pack(
            "<H", len(seg)) + seg)

    def _next(self):
        if len(self.buf) < 8:
            return None
        ln = (self.buf[2] << 8) | self.buf[3]
        if len(self.buf) < ln:
            return None
        p, self.buf = self.buf[:ln], self.buf[ln:]
        return p

    def reply(self, p):
        if p[0] == self.LOGIN:                    # the login ack
            return self.packet(self.RESPONSE, self.done())
        if self._txn():
            body = struct.pack("<IBB", 2601, 1, 14) + b"deadlock" + \
                b"\x00" * 8
            toks = b"\xe5" + struct.pack("<H", len(body)) + body + \
                self.done(0x0002, 0)
        else:
            toks = b"\xd1rowbytes" + self.done(0, 1)
        return self.packet(self.RESPONSE, toks)


class _TrTls(_TrProto):
    """A ClientHello with SNI and ALPN: the TLS parser records the
    handshake's names and yields no transaction (as the reference's)."""

    name = "tls"

    def request(self, t, k):
        sni, alpn = f"svc{k}.internal".encode(), b"h2"
        ext = struct.pack(">HBH", len(sni) + 3, 0, len(sni)) + sni
        exts = struct.pack(">HH", 0, len(ext)) + ext
        al = bytes([len(alpn)]) + alpn
        al = struct.pack(">H", len(al)) + al
        exts += struct.pack(">HH", 16, len(al)) + al
        body = (struct.pack(">H", 0x0303) + b"\x00" * 32 + b"\x00"
                + struct.pack(">H", 2) + b"\x13\x01" + b"\x01\x00"
                + struct.pack(">H", len(exts)) + exts)
        hs = b"\x01" + len(body).to_bytes(3, "big") + body
        return b"\x16\x03\x01" + struct.pack(">H", len(hs)) + hs

    def _next(self):
        if len(self.buf) < 5:
            return None
        ln = 5 + int.from_bytes(self.buf[3:5], "big")
        if len(self.buf) < ln:
            return None
        r, self.buf = self.buf[:ln], self.buf[ln:]
        return r

    def reply(self, rec):                         # a ServerHello's head
        return b"\x16\x03\x03\x00\x04\x02\x00\x00\x00"


TR_PROTOS = (_TrHttp1, _TrPg, _TrMongo, _TrH2, _TrTds, _TrTls)
TR_TXN_PROTOS = TR_PROTOS[:5]   # the TLS parser yields no transaction
TR_PORTS = {"http1": 8080, "postgres": 5432, "mongo": 27017,
            "http2": 50051, "sybase": 5000, "tls": 443}


def _tr_client_conn(cls, port: int, conn: int) -> tuple:
    """One client conn against the live service of ``cls`` → (its
    transactions, errors). HTTP/1.1 pipelines its first two requests."""
    model = cls(TR_ERR_LIVE)
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def exchange(req):
            want = model.feed(req)
            s.sendall(req)
            got = b""
            while len(got) < len(want):
                chunk = s.recv(1 << 16)
                if not chunk:
                    raise ConnectionError(f"{cls.name}: closed early")
                got += chunk
            if got != want:
                raise AssertionError(f"{cls.name}: unexpected reply")

        if model.opening():
            exchange(model.opening())
        if cls is _TrTls:
            exchange(model.request(0, conn))
            return 0, 0
        k = 0
        while k < TR_TXNS:
            if cls is _TrHttp1 and k == 0:        # two pipelined requests
                exchange(model.request(0, 0) + model.request(1, 1))
                k = 2
                continue
            exchange(model.request(k % 6, conn * TR_TXNS + k))
            k += 1
    return model.n, model.nerr


def _tr_serve_conn(cls, c) -> None:
    model = cls(TR_ERR_LIVE)
    try:
        with c:
            while True:
                data = c.recv(1 << 16)
                if not data:
                    return
                out = model.feed(data)
                if out:
                    c.sendall(out)
                    if cls is _TrTls:
                        return
    except OSError:
        pass


def trace_services_main() -> int:
    """``chip_smoke.py --trace-services``: the six loopback services of
    phase 16a and their clients, in one child process. It prints the
    services' ports as one JSON line, then runs client round r for each
    ``round r`` line on its standard input (conns r·C..r·C+C-1 of each
    service, C = TR_CONNS / TR_ROUNDS, the six services at once) and
    prints each round's transactions and errors by protocol."""
    import threading

    lsn = {}
    for cls in TR_PROTOS:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(64)
        lsn[cls] = s

        def accept(s=s, cls=cls):
            while True:
                try:
                    c, _ = s.accept()
                except OSError:
                    return
                threading.Thread(target=_tr_serve_conn, args=(cls, c),
                                 daemon=True).start()
        threading.Thread(target=accept, daemon=True).start()
    print(json.dumps({"ports": {cls.name: s.getsockname()[1]
                                for cls, s in lsn.items()}}), flush=True)
    per = TR_CONNS // TR_ROUNDS
    for line in sys.stdin:
        if not line.startswith("round"):
            break
        r = int(line.split()[1])
        out, errs, t0 = {}, [], time.perf_counter()

        def run(cls):
            n = e = 0
            try:
                for c in range(r * per, (r + 1) * per):
                    a, b = _tr_client_conn(cls, lsn[cls].getsockname()[1], c)
                    n, e = n + a, e + b
            except Exception as ex:              # reported to the parent
                errs.append(f"{cls.name}: {ex!r}")
            out[cls.name] = [n, e]
        ths = [threading.Thread(target=run, args=(cls,)) for cls in TR_PROTOS]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        print(json.dumps({"round": r, "txns": out, "errors": errs,
                          "s": time.perf_counter() - t0}), flush=True)
    for s in lsn.values():
        s.close()
    return 0


def _tr_frame(src, dst, seq, payload=b"", flags=0x18) -> bytes:
    """Ethernet + IPv4 + TCP around ``payload`` (tests/test_pcapfile.py's
    builder, copied)."""
    (sa, sport), (da, dport) = src, dst
    tcp = struct.pack(">HHIIBBHHH", sport, dport, seq & 0xFFFFFFFF, 0,
                      5 << 4, flags, 65535, 0, 0) + payload
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(tcp), 1, 0, 64, 6,
                     0, sa, da)
    return b"\xaa" * 6 + b"\xbb" * 6 + b"\x08\x00" + ip + tcp


def trace_pcap(n_svcs: int, seed: int = TR_SEED) -> tuple:
    """16b's capture: one conn a traced service (the five
    transaction-bearing protocols round-robin), ``TR_CONN_TXNS``
    transactions each with lognormal latencies, and one TLS ClientHello
    conn a host → (frames, the server endpoint of each service, the
    written transactions as columns)."""
    rng = np.random.default_rng(seed)
    frames, ends = [], []
    cols = {k: [] for k in ("svc", "api", "err", "bin", "bout", "lat",
                            "proto")}
    for i in range(n_svcs + n_svcs // TR_HOST_SVCS):
        tls = i >= n_svcs
        cls = _TrTls if tls else TR_TXN_PROTOS[i % len(TR_TXN_PROTOS)]
        srv = (bytes([10, 1 + tls, i >> 8, i & 255]), TR_PORTS[cls.name])
        cli = (bytes([10, 9, i >> 8, i & 255]), 40000 + i)
        if not tls:
            ends.append(srv)
        model = cls(TR_ERR_PCAP)
        seq = {cli: 1000 + 7 * i, srv: 900_000 + 13 * i}
        t = TR_T0 + i * 50_000_000
        frames.append((t, _tr_frame(cli, srv, seq[cli] - 1, flags=0x02)))

        def seg(src, dst, payload, tus):
            frames.append((tus, _tr_frame(src, dst, seq[src], payload)))
            seq[src] += len(payload)

        if model.opening():
            rep = model.feed(model.opening())
            seg(cli, srv, model.opening(), t + 10)
            if rep:
                seg(srv, cli, rep, t + 40)
            t += 100
        if tls:
            seg(cli, srv, model.request(0, i), t)
            seg(srv, cli, model.feed(model.request(0, i)), t + 50)
            continue
        lat = np.maximum(rng.lognormal(TR_LAT_MU, TR_LAT_SIGMA,
                                       TR_CONN_TXNS), 1.0).astype(np.int64)
        for k in range(TR_CONN_TXNS):
            req = model.request(k % 6, k)
            e0 = model.nerr
            rep = model.feed(req)
            dt = int(lat[k])
            seg(cli, srv, req, t)
            seg(srv, cli, rep, t + dt)
            for key, v in (("svc", i), ("api", k % 6),
                           ("err", model.nerr > e0),
                           ("bin", model.bytes_in(req)),
                           ("bout", model.bytes_out(rep)), ("lat", dt),
                           ("proto", i % len(TR_TXN_PROTOS))):
                cols[key].append(v)
            t += dt + 25
    return frames, ends, {k: np.asarray(v) for k, v in cols.items()}


def _af_packet_refusal():
    """None where this process may open AF_PACKET on ``lo``, else the
    error (the agent's capture then turns itself off, ``_cap_denied``)."""
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(0x0003))
        try:
            s.bind(("lo", 0))
        finally:
            s.close()
    except OSError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _tr_rows(out) -> list:
    return sorted(out["recs"], key=lambda r: (r["svcid"], r["api"]))


async def trace_run(torch, scatter, tmp) -> tuple:
    """16a and 16b (see trace_phase) → (perf, launches a conn/resp
    dispatch)."""
    import asyncio

    from gyeeta_tpu_torch import server_main
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.net.agent import QueryClient, register
    from gyeeta_tpu_torch.sketch import exact, loghist
    from gyeeta_tpu_torch.trace import PROTO_NAMES
    from gyeeta_tpu_torch.trace import pcapfile as PF
    from gyeeta_tpu_torch.trace.proto import transactions_to_records
    from gyeeta_tpu_torch.utils import hashing as H
    from gyeeta_tpu_torch.utils import replay

    cfgf = tmp / "gyt_trace.json"
    cfgf.write_text(json.dumps({"engine": AG_CFG}))
    cap = tmp / "trace.gytrec"

    def daemon(device, record=None):
        args = server_main.parse_args(
            ["--config", str(cfgf), "--host", "127.0.0.1", "--port", "0",
             "--device", device, "--log-level", "WARNING"]
            + (["--record", str(record)] if record else []))
        args.tick_interval = None         # manual ticks
        return server_main.Daemon(args, env={})

    perf, procs, daemons, conns = {}, [], [], []
    qc = QueryClient(request_timeout=TR_TIMEOUT)
    try:
        d1 = daemon(DEV, cap)
        daemons.append(d1)
        rt, srv = d1.rt, d1.srv
        ctr = rt.stats.counters
        n_cr, disp_ms, timing = [0], [], [False]
        dispatch = rt._dispatch_fused

        def counting(connresp=None):
            if connresp is not None:
                n_cr[0] += 1
            if not timing[0]:
                return dispatch(connresp)
            t = time.perf_counter()
            out = dispatch(connresp)
            torch.cuda.synchronize()
            disp_ms.append((time.perf_counter() - t) * 1e3)
            return out
        rt._dispatch_fused = counting
        host, port = await _w(srv.start())
        mods = sketch_modules()
        reset_launches(scatter, mods)
        await _w(qc.connect(host, port))

        async def q(name, **kw):
            return await _w(qc.query({"subsys": name, "maxrecs": 100000,
                                      "consistency": "strong", **kw}))

        # ---- 16a: live traffic through the agent's capture
        t0 = time.perf_counter()
        refusal = _af_packet_refusal()
        perf["af_packet_refused"] = refusal
        if refusal:
            log(f"  16a: this host refuses AF_PACKET on lo ({refusal}): "
                "the agent's capture turns itself off; the live capture "
                "is checked on the CPU only (tests/test_torch_livecap.py)")
        svc = await asyncio.create_subprocess_exec(
            sys.executable, str(ROOT / "chip_smoke.py"), "--trace-services",
            cwd=str(ROOT), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        procs.append(svc)
        ports = json.loads(await _w(svc.stdout.readline()))["ports"]
        agent = await _spawn(procs, "agent", "--port", str(port),
                             "--collect", "--real", "--livecap",
                             "--seed", str(TR_REAL_SEED),
                             "--interval", str(TR_INTERVAL))
        mid = _agent_mid(TR_REAL_SEED)

        def marks():
            hid = srv.hostmap.get(mid)
            return 0 if hid is None else rt._sweep_last_seq.get(hid, 0)

        async def sweeps(n, what):
            m0 = marks()
            await _until_children(lambda: marks() >= m0 + n, what,
                                  [svc, agent])

        await sweeps(1, "the capturing agent's first sweep")
        hid = srv.hostmap[mid]
        listeners = {}
        for _ in range(int(10 / TR_INTERVAL)):
            srv._feed_barrier()
            rt.flush()
            listeners = {r["port"]: r["svcid"]
                         for r in (await q("svcinfo"))["recs"]
                         if r.get("hostid") == hid
                         and r.get("port") in ports.values()}
            if len(listeners) == len(ports):
                break
            await sweeps(1, "the services' listeners")
        check(len(listeners) == len(ports),
              f"16a: svcinfo holds the {len(ports)} loopback services' "
              f"listeners of the capturing agent's host: "
              f"{sorted(listeners)}")
        svcid = {name: listeners[p] for name, p in ports.items()}
        filt = ("{ svcinfo.port in "
                + ",".join(str(p) for p in sorted(ports.values())) + " }")
        add = await _w(qc.query({"op": "add", "objtype": "tracedef",
                                 "name": "phase16", "filter": filt}))
        srv._feed_barrier()
        rt.flush()
        rt.run_tick()
        pushed = await _w(srv.push_trace_control())
        check(add.get("ok") and pushed == len(ports),
              f"16a: the tracedef {filt} went out through "
              f"push_trace_control: {pushed} enables")
        await sweeps(2, "the sweep that opens the capture")
        live = {cls.name: [0, 0] for cls in TR_PROTOS}
        round_s = []
        if not refusal:
            for r in range(TR_ROUNDS):
                await sweeps(1, "a sweep before a client round")
                svc.stdin.write(f"round {r}\n".encode())
                await _w(svc.stdin.drain())
                res = json.loads(await _w(svc.stdout.readline()))
                check(not res["errors"], f"16a: client round {r}: every "
                      f"exchange got its reply {res['errors']}")
                round_s.append(res["s"])
                last = res["txns"]
                for k, (n, e) in last.items():
                    live[k][0] += n
                    live[k][1] += e
            # the round began right after a poll and ends well before
            # the next: the next sweep carries all of it
            await sweeps(1, "the drain after the last round")
        perf["live_txns"], perf["round_s"] = live, round_s
        srv._feed_barrier()
        rt.flush()
        if not refusal:
            # the live engine's current window (no tick ran since the
            # tracedef went out) and the last sweep's gauges: the bridge
            # adds a sweep's parsed errors to its listener's sererr
            ss = {r["svcid"]: r for r in (await q("svcstate"))["recs"]}
            bridged = {c.name: [ss.get(svcid[c.name], {}).get(f, -1)
                                for f in ("nqry5s", "sererr")]
                       for c in TR_PROTOS}
            perf["live_svcstate"] = bridged
            check(all(bridged[c.name] == [live[c.name][0], last[c.name][1]]
                      for c in TR_TXN_PROTOS),
                  f"16a: the traced listeners' svcstate rows carry the "
                  f"bridged transactions of the window (nqry5s) and the "
                  f"last sweep's parsed errors (sererr): {bridged}")
        rows = [r for r in (await q("tracereq"))["recs"]
                if r["svcid"] in svcid.values()]
        got = {cls.name: [sum(r["nreq"] for r in rows
                              if r["proto"] == cls.name),
                          sum(r["nerr"] for r in rows
                              if r["proto"] == cls.name)]
               for cls in TR_PROTOS}
        perf["live_tracereq"] = got
        if not refusal:
            want = {(c.name, a) for c in TR_TXN_PROTOS for a in c.APIS}
            seen = {(r["proto"], r["api"]) for r in rows}
            check(seen == want, f"16a: tracereq holds every expected "
                  f"signature, {len(want)} of {len(TR_TXN_PROTOS)} "
                  f"protocols, and no other {sorted(seen ^ want)[:6]}")
            check(got == live and sum(n for n, _ in live.values())
                  == len(TR_TXN_PROTOS) * TR_CONNS * TR_TXNS,
                  f"16a: tracereq's nreq and nerr by protocol equal the "
                  f"transactions the clients completed and the errors "
                  f"the services sent, over {TR_ROUNDS} sweeps: {got}")
            srv._feed_barrier()
            rt.flush()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rt.run_tick()
            torch.cuda.synchronize()
            perf["live_tick_ms"] = (time.perf_counter() - t1) * 1e3
        else:
            check(got == {c.name: [0, 0] for c in TR_PROTOS},
                  "16a: no trace reached the server with the capture "
                  "refused")
        dele = await _w(qc.query({"op": "delete", "objtype": "tracedef",
                                  "name": "phase16"}))
        pushed = await _w(srv.push_trace_control())
        check(dele.get("ok") and pushed == len(ports),
              f"16a: the tracedef deleted: {pushed} disables pushed")
        await sweeps(2, "the sweep that closes the capture")
        (rep,) = await _stop_agents(agent, "the capturing agent")
        lc = rep["livecap"]
        perf["agent_livecap"] = lc
        if refusal:
            check(lc["denied"] and lc["opens"] == 0,
                  f"16a: the agent's capture was refused and turned "
                  f"itself off (_cap_denied): {lc}")
        else:
            check(not lc["denied"] and lc["opens"] == 1
                  and lc["closes"] == 1 and lc["ports"] == [],
                  f"16a: the agent opened its capture once and the sweep "
                  f"after the tracedef's deletion closed it: {lc}")
        check(_ledger_ok(rep), "16a: the capturing agent's ledger adds "
              f"up: {rep['counters'].get('records_built')} records built")
        svc.stdin.write(b"exit\n")
        await _w(svc.stdin.drain())
        await _finish(svc, "the trace services")
        perf["live_s"] = time.perf_counter() - t0

        # ---- 16b: a pcap at volume through the parsers into serve
        t0 = time.perf_counter()
        n_svcs = TR_HOSTS * TR_HOST_SVCS
        frames, ends, cols = trace_pcap(n_svcs)
        buf = PF.write_pcap(frames)
        perf["pcap_bytes"], perf["pcap_frames"] = len(buf), len(frames)
        t1 = time.perf_counter()
        flows = PF.parse_pcap(buf)
        parse_s = time.perf_counter() - t1
        n_txn = sum(len(f.transactions) for f in flows)
        perf["parse_s"] = parse_s
        perf["parse_txns_per_s_host_cpu"] = n_txn / parse_s
        idx = {e: i for i, e in enumerate(ends)}
        parsed = {PROTO_NAMES[p]: sum(len(f.transactions) for f in flows
                                      if f.proto == p) for p in range(7)}
        written = {c.name: int((cols["proto"] == j).sum()) if
                   c in TR_TXN_PROTOS else 0
                   for j, c in enumerate(TR_PROTOS)}
        perf["parsed"] = {k: parsed[k] for k in written}
        check(perf["parsed"] == written and len(flows) == n_svcs
              and all(f.ser in idx for f in flows),
              f"16b: {len(frames)} frames ({len(buf)} bytes) parsed into "
              f"{n_txn} transactions of {len(flows)} conns, by protocol "
              f"the transactions written: {written}")
        log(f"  16b: parse_pcap {n_txn / parse_s:.0f} transactions/s on "
            f"this host's CPU (not the card), {parse_s:.2f} s")
        status = []
        for s in range(TR_HOSTS):
            r, w, st, h = await _w(register(host, port, _agent_mid(s),
                                            wire.CONN_EVENT))
            status.append(st)
            conns.append((r, w, h))
        check(status == [wire.REG_OK] * TR_HOSTS
              and len({h for _, _, h in conns}) == TR_HOSTS,
              f"16b: {TR_HOSTS} of phase 15's sim host ids registered, a "
              "host id each")
        gids = [H.hash_bytes_np(f"phase16-svc-{i}".encode())
                for i in range(n_svcs)]
        recs = [None] * n_svcs
        t1 = time.perf_counter()
        for f in flows:
            i = idx[f.ser]
            recs[i] = transactions_to_records(
                f.transactions, svc_glob_id=gids[i],
                host_id=conns[i // TR_HOST_SVCS][2])
        perf["records_s"] = time.perf_counter() - t1
        srv._feed_barrier()
        rt.flush()
        n_live0 = int(rt.state.api_tbl.n_live)
        n_tr0 = ctr.get("trace_records", 0)
        timing[0], n_cr0 = True, n_cr[0]
        disp_ms.clear()
        half = TR_CONN_TXNS // TR_SWEEPS
        perf["volume_tick_ms"] = []
        for s in range(TR_SWEEPS):
            for h, (_, w, hid_) in enumerate(conns):
                out = b""
                for i in range(h * TR_HOST_SVCS, (h + 1) * TR_HOST_SVCS):
                    tr, names = recs[i]
                    if s == 0:
                        out += wire.encode_frames_chunked(
                            wire.NOTIFY_NAME_INTERN, names)
                    out += wire.encode_frames_chunked(
                        wire.NOTIFY_REQ_TRACE, tr[s * half:(s + 1) * half])
                w.write(out)
            for _, w, _ in conns:
                await _w(w.drain())
            want = n_tr0 + (s + 1) * half * n_svcs
            await _until(lambda: ctr.get("trace_records", 0) >= want,
                         f"16b: sweep {s} folded", timeout=TR_TIMEOUT)
            srv._feed_barrier()
            rt.flush()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rt.run_tick()
            torch.cuda.synchronize()
            perf["volume_tick_ms"].append((time.perf_counter() - t1) * 1e3)
        timing[0] = False
        perf["volume_dispatches"] = len(disp_ms)
        perf["volume_connresp_dispatches"] = n_cr[0] - n_cr0
        perf["volume_dispatch_ms"] = {"sum": sum(disp_ms), **_pcts(disp_ms)}
        n_live = int(rt.state.api_tbl.n_live)
        perf["api_live"] = [n_live0, n_live]
        check(n_live - n_live0 == n_svcs * 6 and n_live <= AG_CFG.get(
            "api_capacity", 4096) // 2,
              f"16b: api_tbl.n_live rose by {n_live - n_live0} (service, "
              f"api) keys to {n_live} ({100 * n_live / 4096:.1f} % of the "
              "4,096 slots)")
        gidx = {format(g, "016x"): i for i, g in enumerate(gids)}
        trq = _tr_rows(await q("tracereq"))
        rows = [r for r in trq if r["svcid"] in gidx]
        keys = (cols["svc"].astype(np.uint64), cols["api"].astype(np.uint64))
        tot = {f: exact.key_totals(*keys, v) for f, v in (
            ("nreq", np.ones(len(cols["svc"]))), ("nerr", cols["err"]),
            ("bytesin", cols["bin"]), ("bytesout", cols["bout"]))}
        spec = rt.cfg.apiresp_spec
        apis = {(c.name, a): j for c in TR_TXN_PROTOS
                for j, a in enumerate(c.APIS)}
        bad, n_apart = [], 0
        for r in rows:
            i = gidx[r["svcid"]]
            j = apis.get((r["proto"], r["api"]))
            k = (i << 32) | (j if j is not None else 1 << 31)
            for f, t in tot.items():
                if t.get(k) != r[f]:
                    bad.append((r["svcid"], r["api"], f, t.get(k), r[f]))
            m = (cols["svc"] == i) & (cols["api"] == (j or 0))
            p95 = float(exact.quantiles(cols["lat"][m], [0.95])[0])
            b = loghist.bucket_of(spec, torch.tensor(
                [r["p95resp"] * 1e3, p95], dtype=torch.float32))
            d = abs(int(b[0]) - int(b[1]))
            n_apart += d == 1
            if d > 1:
                bad.append((r["svcid"], r["api"], "p95resp", p95,
                            r["p95resp"]))
        perf["p95_bucket_apart"] = n_apart
        check(len(rows) == n_svcs * 6 and not bad,
              f"16b: tracereq's {len(rows)} (service, api) rows: nreq, "
              f"nerr, bytesin and bytesout equal exact.key_totals of what "
              f"was written, each p95 within one loghist bucket of "
              f"exact.quantiles ({n_apart} one bucket apart) {bad[:4]}")
        launches = read_launches(scatter, mods)
        n = n_cr[0]
        perf["launches"], perf["connresp_dispatches"] = launches, n
        check(n > 0 and launches == path_launches(n),
              f"16: each of the phase's {n} conn/resp dispatches (the "
              f"capturing agent's conns, the bridged transactions) "
              f"launched hll_update 2x, cms_update, inv_update and the "
              f"int32 scatter-add 1x, no other generic kernel: {launches}")
        vd = perf["volume_dispatch_ms"]
        log(f"  16b: {len(disp_ms)} dispatches folded the "
            f"{n_svcs * TR_CONN_TXNS} records ({vd['sum']:.1f} ms, p50 "
            f"{vd['p50']:.2f} ms, {perf['volume_connresp_dispatches']} of "
            f"them conn/resp for the bridge); run_tick ms "
            f"{[round(x, 2) for x in perf['volume_tick_ms']]}")
        for _, w, _ in conns:
            w.close()
        conns.clear()
        perf["volume_s"] = time.perf_counter() - t0

        # ---- the capture, replayed into a CPU server
        t0 = time.perf_counter()
        srv._feed_barrier()
        rt.flush()
        card = _tr_rows(await q("tracereq"))
        d2 = daemon("cpu")
        daemons.append(d2)
        rt2, srv2 = d2.rt, d2.srv
        h2, p2 = await _w(srv2.start())
        rp = await _spawn(procs, "replay", str(cap), "--port", str(p2))
        await _finish(rp, "replay")
        c2 = rt2.stats.counters
        await _until(lambda: all(c2.get(k, 0) == ctr.get(k, 0) for k in (
            "trace_records", "conn_events")), "the replayed capture folded",
            timeout=TR_TIMEOUT)
        srv2._feed_barrier()
        rt2.flush()
        cpu = _tr_rows(rt2.query({"subsys": "tracereq", "maxrecs": 100000}))
        bufs = [c for _, c in replay.read_chunks(cap)]
        moved = {k: _moved(torch, loghist, getattr(rt.cfg, k), v)
                 for k, v in hist_inputs(bufs).items()}
        n_q = [0, 0]
        _json_diff(torch, loghist, rt.cfg, cpu, card, moved, "16 tracereq",
                   n_q)
        perf["cpu_bucket_apart"], perf["cpu_rounding_apart"] = n_q
        check(len(card) == len(cpu) > n_svcs * 6,
              f"16: the --record capture replayed into a CPU GytServer: "
              f"tracereq's {len(cpu)} rows equal the card's ({n_q[0]} "
              f"quantiles one loghist bucket apart, {n_q[1]} values one "
              "unit apart in the third decimal)")
        perf["replay_s"] = time.perf_counter() - t0
    finally:
        for _, w, _ in conns:
            w.close()
        await qc.close()
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for d in daemons:
            await d.shutdown()
    return perf, {k: v / max(perf["connresp_dispatches"], 1)
                  for k, v in perf["launches"].items()}


def trace_phase(torch, scatter):
    """Phase 16: the request-trace capture into ``serve`` on the card."""
    import asyncio
    import shutil
    import tempfile

    t0 = time.perf_counter()
    log(f"phase 16: the request-trace capture into serve on the card at "
        f"the madhava geometry: 16a six loopback services captured live by "
        f"agent --livecap; 16b a pcap of {TR_HOSTS * TR_HOST_SVCS} services "
        f"x {TR_CONN_TXNS} transactions through parse_pcap")
    tmp = Path(tempfile.mkdtemp(prefix="gyt_smoke_trace_"))
    try:
        perf, launches = asyncio.run(trace_run(torch, scatter, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    perf["phase_s"] = time.perf_counter() - t0
    log(f"  phase 16: {perf['phase_s']:.1f} s")
    return perf, launches


# ----------------------------------------------------------- phase 17
SR_TICKS = 2                # 17a: live ticks, one compaction window
SR_BUFFERS = 4              # phase 8's feed buffers a live tick (a slab)
SR_SAMPLES = 1 << 20        # 17b: samples (lanes) of an update case
SR_CHUNKS = 16              # ... folded in this many calls
# 17b: rtol of the t-digest means whose weights agree, card vs CPU, in
# the updates after a sample moved to a neighbouring centroid (PERF.md)
SR_CARRY_RTOL = 5e-5
SR_FOLDS = 4                # 17c: fold dispatches the trace brackets
SR_TRACE_BUFFERS = 6        # ... of this many feed buffers' dispatches
# each kernel entry → its launches a conn/resp dispatch (the trace names
# the entry's device kernel ``<entry>_kernel``)
SR_KERNELS = {"gyt_hll_update": 2, "gyt_inv_update": 1, "gyt_cms_update": 1,
              "gyt_scatter_sites": 1}


class _CrcFile:
    """A write-only file that keeps the CRC-32 and length of its bytes."""

    def __init__(self):
        self.crc = 0
        self.n = 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        self.n += len(b)
        return len(b)


def _stacked_npy_crc(parts) -> tuple:
    """(CRC-32, length) of the ``.npy`` bytes of ``np.stack(parts)`` as a
    shard file's member holds them (``history/shards.py`` writes every
    leaf with ``np.lib.format.write_array``, whose header is format 1.0
    where it fits): what ``_leaf_crcs`` reads from the zip directory,
    without stacking the parts. The stacked array's C-order bytes are
    the parts' bytes one after another."""
    f = _CrcFile()
    parts = [np.asarray(p) for p in parts]
    hdr = np.lib.format.header_data_from_array_1_0(parts[0])
    hdr["shape"] = (len(parts),) + parts[0].shape
    hdr["fortran_order"] = False
    np.lib.format.write_array_header_1_0(f, hdr)
    for p in parts:
        f.write(memoryview(np.ascontiguousarray(p.reshape(-1))).cast("B"))
    return f.crc, f.n


def sharded_history_run(torch, scatter, names, bufs, tmp) -> tuple:
    """17a: a sharded runtime's WAL replayed through a ``ShardedRuntime``
    factory into stacked shards, held to the live mesh (see
    sharded_history_phase) → (perf, launches a replayed slab)."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.history.compactor import Compactor
    from gyeeta_tpu_torch.parallel import depgraph, sharded
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    from gyeeta_tpu_torch.sketch import loghist
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    from gyeeta_tpu_torch.utils.selfstats import Stats
    from gyeeta_tpu_torch.utils.tensor import tree_paths

    scfg = aggstate.EngineCfg(**SH_CFG)
    opts = RuntimeOpts(**RT_OPTS, journal_dir=str(tmp / "wal"),
                       hist_shard_dir=str(tmp / "shards"),
                       hist_window_ticks=SR_TICKS)
    perf = {}

    def factory(cfg, o):
        return ShardedRuntime(cfg, make_mesh(SH_N, device=DEV), o)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = factory(scfg, opts)
    try:
        rt.feed(names)
        j = 0
        for _ in range(SR_TICKS):
            for _ in range(SR_BUFFERS):
                rt.feed(bufs[j % len(bufs)][0])
                j += 1
            rt.run_tick()
        torch.cuda.synchronize()
        perf["live_s"] = time.perf_counter() - t0
        live_json = rt.query({"subsys": "svcstate", "maxrecs": 200000})
        t0 = time.perf_counter()
        # each shard's leaves; a leaf's stacked form is built only where
        # its CRC-32 disagrees with the shard's
        live = list(zip(*(aggstate.state_to_numpy(st)
                          + depgraph.dep_to_numpy(d)
                          for st, d in zip(rt.state, rt.dep))))
        perf["live_leaves_s"] = time.perf_counter() - t0
        log(f"  17a: live mesh of {SH_N} shards, names and "
            f"{SR_BUFFERS} buffers a tick for {SR_TICKS} ticks "
            f"({live_json['nrecs']} services): {perf['live_s']:.1f} s; "
            f"its stacked leaves to the host {perf['live_leaves_s']:.1f} s")

        mods = sketch_modules()
        stats = Stats()
        comp = Compactor(scfg, opts, journal=rt.journal, stats=stats,
                         runtime_factory=factory)
        try:
            reset_launches(scatter, mods)
            t0 = time.perf_counter()
            rep = comp.compact_once(seal=True, upto_tick=rt._tick_no)
            torch.cuda.synchronize()
            perf["compact_s"] = time.perf_counter() - t0
            launches = read_launches(scatter, mods)
            disp = comp._rt.stats.counters["fold_dispatches"]
            perf["peak_device_gib"] = \
                torch.cuda.max_memory_allocated() / 2**30
            n_emit, emit_ms = stats.timing_totals()["compact_emit"]
            shards = comp.store.shards("raw")
            perf.update(compact=rep, replay_dispatches=disp,
                        launches=launches,
                        compact_replay_ev_per_sec=stats.gauges[
                            "compact_replay_ev_per_sec"],
                        compact_emit_ms=emit_ms / max(n_emit, 1),
                        shard_bytes=[e["bytes"] for e in shards])
            log(f"  17a: compaction through a {SH_N}-shard ShardedRuntime "
                f"factory: {rep}; {perf['compact_s']:.1f} s, "
                f"compact_replay_ev_per_sec "
                f"{perf['compact_replay_ev_per_sec']}, compact_emit "
                f"{perf['compact_emit_ms']:.1f} ms, shard bytes "
                f"{perf['shard_bytes']}, peak device memory "
                f"{perf['peak_device_gib']:.3f} GiB")
            check(rep["windows"] == 1
                  and [e["tick1"] for e in shards] == [SR_TICKS],
                  f"17a: one window emitted, a stacked shard at tick "
                  f"{SR_TICKS}")
            check(disp > 0 and launches == path_launches(SH_N * disp),
                  f"17a: each of the replay's {disp} sharded dispatches "
                  f"launched hll_update {2 * SH_N}x, cms_update, "
                  f"inv_update and the int32 scatter-add {SH_N}x, no other "
                  f"generic kernel: {launches}")

            # the stacked shard against the live mesh, CRC-32 first
            path = comp.store.dir / shards[-1]["file"]
            snames = tree_paths(aggstate.init(scfg, "meta"))
            names_ = snames + tree_paths(depgraph.init(1, 1, "meta"))
            members = [f"s{i}" for i in range(len(snames))] + \
                [f"d{i}" for i in range(len(names_) - len(snames))]
            t0 = time.perf_counter()
            crcs = _leaf_crcs(path)
            kinds, diff = {}, []
            for name, m, parts in zip(names_, members, live):
                if len(parts) != SH_N:
                    kinds[name] = f"{len(parts)} live shards"
                elif crcs.get(m) == _stacked_npy_crc(parts):
                    kinds[name] = "exact"
                else:
                    diff.append((name, m, np.stack(parts)))
            ev = np.stack(live[snames.index("flow_topk.evicted")])
            mass = ev.astype(np.float64) + np.stack(live[snames.index(
                "flow_topk.counts")]).astype(np.float64).sum(axis=-1)
            with np.load(path) as z:
                for name, m, arr in diff:
                    kinds[name] = _device_leaf_check(
                        torch, name, torch.from_numpy(arr).to(DEV),
                        torch.from_numpy(z[m]).to(DEV), mass)
            perf["compare_s"] = time.perf_counter() - t0
        finally:
            comp.close()
        close = sorted(n for n, k in kinds.items() if k == "close")
        bad = {n: k for n, k in kinds.items() if k not in ("exact",
                                                           "close")}
        perf["leaves_exact"] = len(kinds) - len(close) - len(bad)
        perf["leaves_close"] = close
        perf["leaves_crc_exact"] = len(kinds) - len(diff)
        check(len(kinds) == 85 + 29 and not bad,
              f"17a: the stacked shard at tick {SR_TICKS} = the live mesh "
              f"then: {perf['leaves_exact']} of 114 stacked leaves exact "
              f"({perf['leaves_crc_exact']} by CRC-32 without inflating), "
              f"{len(close)} within the float-sum rule {close}, "
              f"{perf['compare_s']:.1f} s; differing: {bad}")

        t0 = time.perf_counter()
        at = rt.query({"subsys": "svcstate", "maxrecs": 200000,
                       "at": f"tick:{SR_TICKS}"})
        perf["at_ms"] = (time.perf_counter() - t0) * 1e3
        n_q = [0, 0]
        _json_diff(torch, loghist, scfg, _rows_by_identity(live_json),
                   _rows_by_identity(at), {}, "17a at= svcstate", n_q)
        check(at["nrecs"] == live_json["nrecs"] > 0
              and at["tick"] == SR_TICKS,
              f"17a: at=tick:{SR_TICKS} svcstate on the mesh "
              f"({at['nrecs']} rows, {perf['at_ms']:.0f} ms) equals the "
              f"live mesh's, row for row (floats rtol 1e-6; {n_q[1]} "
              f"third-decimal roundings apart)")
    finally:
        rt.close()
    return perf, {k: v / disp for k, v in launches.items()}


def _digest_apart(torch, got, ref, unmoved_rtol: float = 1e-5) -> dict:
    """A t-digest computed on the card against the CPU's, by the rule
    ``tests/test_torch_sketches.py``'s ``_same_digest`` holds the port to
    against JAX. The arcsine scale's last ulp differs between CUDA's and
    the CPU's ``asin``, so a sample on a cluster boundary may land in
    the neighbouring centroid, and the card's segment sums add in no
    fixed order: vmin, vmax and the total weight exact; every centroid
    whose weight is equal has its mean within ``unmoved_rtol`` (1e-5,
    the test's); where weights differ, they differ in adjacent pairs by
    whole samples moved from one to the other (at most 1e-4 of the
    total), the pair's means within rtol 1e-4. Returns the verdict ("ok"
    or what broke it) and the drift: samples moved, the largest relative
    mean difference of the unmoved and of the moved centroids, and the
    unmoved centroids beyond ``unmoved_rtol`` (row, column, rtol,
    columns to the nearest moved one)."""
    gm, gw, gmin, gmax = (x.cpu().double() for x in got)
    rm, rw, rmin, rmax = (x.double() for x in ref)
    out = {"verdict": "ok"}
    if not (torch.equal(gmin, rmin) and torch.equal(gmax, rmax)
            and torch.equal(gw.sum(-1), rw.sum(-1))):
        out["verdict"] = "vmin, vmax or the total weight differ"
        return out
    dw = (gw - rw).reshape(-1, gw.shape[-1])
    left = torch.zeros_like(dw)
    left[:, 1:] = dw[:, :-1]
    right = torch.zeros_like(dw)
    right[:, :-1] = dw[:, 1:]
    moved = dw != 0
    out["moved"] = int(dw.abs().sum()) // 2
    rel = ((gm - rm).abs() / rm.abs().clamp(min=1e-30)).reshape(dw.shape)
    out["rel_unmoved"] = float(rel[~moved].max()) if (~moved).any() else 0.
    out["rel_moved"] = float(rel[moved].max()) if moved.any() else 0.
    over = torch.nonzero(~moved & (rel > unmoved_rtol)).tolist()
    cols = [torch.nonzero(m).flatten().tolist() for m in moved]
    out["over"] = [(r, c, float(rel[r, c]),
                    min((abs(c - j) for j in cols[r]), default=None))
                   for r, c in over[:16]]
    if not torch.equal(dw, dw.round()):
        out["verdict"] = "a fraction of a sample moved"
    elif bool((moved & (left != -dw) & (right != -dw)).any()):
        out["verdict"] = "a weight moved other than to a neighbour"
    elif float(dw.abs().sum()) > 2e-4 * float(rw.sum()):
        out["verdict"] = f"{out['moved']} samples moved"
    elif over:
        out["verdict"] = (f"{len(over)} unmoved centroids' means beyond "
                          f"{unmoved_rtol:g}")
    elif out["rel_moved"] > 1e-4:
        out["verdict"] = "a moved pair's means beyond 1e-4"
    return out


def merges_on_card(torch) -> dict:
    """17b: the mergeable sketch API (``update`` and ``merge`` of every
    sketch, ``dense_topk``, ``windows.add``) on the card against the
    CPU, on the same inputs (see sharded_history_phase)."""
    from gyeeta_tpu_torch.sketch import countmin, exact, hyperloglog, \
        invertible, loghist, tdigest, topk, windows
    from gyeeta_tpu_torch.utils.tensor import tree_leaves

    rng = np.random.default_rng(1717)
    n, chunks = SR_SAMPLES, SR_CHUNKS
    out = {}

    def on(dev, *arrs):
        return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                 else a).to(dev) for a in arrs]

    def exact_tree(name, cpu, card):
        ok = all(torch.equal(a, b.cpu()) for a, b in
                 zip(tree_leaves(cpu), tree_leaves(card)))
        out[name] = "exact" if ok else "differs"
        check(ok, f"17b: {name} on the card equals the CPU's, exactly")

    # loghist: global update and merge (RESP_TIME_SPEC, RATE_SPEC)
    spec = loghist.RESP_TIME_SPEC
    v = np.clip(rng.lognormal(-4.0, 1.5, n).astype(np.float32), spec.vmin,
                spec.vmax * 0.99)
    hists, moved = {}, 0
    for dev in ("cpu", DEV):
        (x,) = on(dev, v)
        h = loghist.init(spec, device=dev)
        for part in torch.chunk(x, chunks):
            h = loghist.update(h, spec, part)
        hists[dev] = h
    moved = int((loghist.bucket_of(spec, torch.from_numpy(v))
                 != loghist.bucket_of(spec, on(DEV, v)[0]).cpu()).sum())
    apart = float((hists[DEV].cpu() - hists["cpu"]).abs().sum())
    qs = np.array([0.25, 0.5, 0.95, 0.99], np.float32)
    q = loghist.quantiles(hists[DEV], spec, tuple(qs)).cpu().numpy()
    rel = float((np.abs(q - exact.quantiles(v, qs))
                 / exact.quantiles(v, qs)).max())
    out["loghist.update"] = {"moved": moved, "rel_err": rel}
    check(apart <= 2 * moved and float(hists[DEV].sum()) == n
          and rel < 2 * spec.rel_error + 0.01,
          f"17b: loghist.update of {n} samples in {chunks} calls equal card "
          f"vs CPU but for the {moved} samples CUDA's logf moves a bucket "
          f"({apart:.0f} counts apart); quantile error {rel:.4f} < "
          f"{2 * spec.rel_error + 0.01:.4f}")
    rspec = loghist.RATE_SPEC
    v1 = rng.exponential(100.0, n // 2).astype(np.float32)
    v2 = rng.exponential(1000.0, n // 2).astype(np.float32)
    merged = {}
    for dev in ("cpu", DEV):
        a, b = on(dev, v1, v2)
        h1 = loghist.update(loghist.init(rspec, device=dev), rspec, a)
        h2 = loghist.update(loghist.init(rspec, device=dev), rspec, b)
        merged[dev] = loghist.merge(h1, h2)
        check(torch.equal(merged[dev],
                          loghist.update(h1.clone(), rspec, b)),
              f"17b: loghist.merge equals the update of both on {dev}")
    rmoved = sum(int((loghist.bucket_of(rspec, torch.from_numpy(x))
                      != loghist.bucket_of(rspec, on(DEV, x)[0]).cpu())
                     .sum()) for x in (v1, v2))
    apart = float((merged[DEV].cpu() - merged["cpu"]).abs().sum())
    out["loghist.merge"] = {"moved": rmoved}
    check(apart <= 2 * rmoved,
          f"17b: loghist.merge equal card vs CPU but for the {rmoved} "
          f"samples CUDA's logf moves ({apart:.0f} counts apart)")

    # t-digest: the reference's two cases (tests/test_sketches.py): 200,000
    # lognormal samples in 20 updates, and two normals merged
    t1 = rng.lognormal(0.0, 2.0, 200_000).astype(np.float32)
    m1 = rng.normal(10.0, 2.0, 50_000).astype(np.float32)
    m2 = rng.normal(20.0, 2.0, 50_000).astype(np.float32)
    # the update case is held after every one of its 20 updates, and
    # against a second run on the card: the card's own float atomics
    # move no sample (the weights are whole counts) and keep the means
    # within 1e-5 of each other; against the CPU the means are held at
    # 1e-5 until a sample has moved, and at SR_CARRY_RTOL after (a
    # moved sample's centroid merges on with other neighbours in the
    # later compressions, so its difference spreads into centroids
    # whose weights agree again)
    dig, steps = {}, {}
    for dev in ("cpu", DEV, "card2"):
        a, b, c = on(DEV if dev == "card2" else dev, t1, m1, m2)
        da = tdigest.init(128, device=a.device)
        steps[dev] = []
        for part in torch.chunk(a, 20):
            da = tdigest.update(da, part)
            steps[dev].append(da)
        dig[dev] = (da, tdigest.merge(
            tdigest.update(tdigest.init(128, device=a.device), b),
            tdigest.update(tdigest.init(128, device=a.device), c)))
    drift, first_move = [], None
    for i, (card, card2, cpu) in enumerate(zip(steps[DEV], steps["card2"],
                                               steps["cpu"])):
        rtol = 1e-5 if first_move is None else SR_CARRY_RTOL
        apart = _digest_apart(torch, card, cpu, rtol)
        self_apart = _digest_apart(torch, card2, tuple(t.cpu() for t in card))
        if apart.get("moved") and first_move is None:
            first_move = i + 1
        drift.append({"update": i + 1, "unmoved_rtol": rtol,
                      **{k: apart.get(k) for k in (
                          "verdict", "moved", "rel_unmoved", "rel_moved",
                          "over")},
                      "card_vs_card": self_apart.get("rel_unmoved"),
                      "card_vs_card_verdict": self_apart["verdict"]
                      if self_apart.get("moved") == 0 else "a sample moved"})
    out["tdigest.update"] = {
        "first_move": first_move,
        "rel_unmoved_before_move": max(
            (d["rel_unmoved"] for d in drift[:(first_move or 21) - 1]),
            default=0.0),
        "rel_unmoved_after_move": max(
            (d["rel_unmoved"] for d in drift[(first_move or 21) - 1:]),
            default=0.0),
        "rel_moved": max(d["rel_moved"] for d in drift),
        "card_vs_card": max(d["card_vs_card"] for d in drift),
        "steps": drift}
    log(f"  17b: tdigest.update drift after each update [update, samples "
        f"moved, unmoved means' rtol, moved pairs' rtol, card vs card]: "
        + json.dumps([[d["update"], d["moved"], f"{d['rel_unmoved']:.2e}",
                       f"{d['rel_moved']:.2e}",
                       f"{d['card_vs_card']:.2e}"] for d in drift]))
    bad = [d for d in drift if d["verdict"] != "ok"
           or d["card_vs_card_verdict"] != "ok"]
    u = out["tdigest.update"]
    check(not bad,
          f"17b: tdigest.update after each of its 20 updates card vs CPU "
          f"(unmoved means rtol 1e-5 until a sample moved, at update "
          f"{first_move}, then {SR_CARRY_RTOL:g}: "
          f"{u['rel_unmoved_before_move']:.2e} / "
          f"{u['rel_unmoved_after_move']:.2e}; moved pairs 1e-4: "
          f"{u['rel_moved']:.2e}) and card vs card (no sample moved, means "
          f"1e-5: {u['card_vs_card']:.2e}); failing: {bad}")
    apart = _digest_apart(torch, dig[DEV][1], dig["cpu"][1])
    out["tdigest.merge"] = apart
    check(apart["verdict"] == "ok",
          f"17b: tdigest.merge card vs CPU: {apart}")
    qs = [0.01, 0.25, 0.5, 0.75, 0.95, 0.99]
    est = tdigest.quantiles(dig[DEV][0], qs).cpu().numpy()
    cest = tdigest.quantiles(dig["cpu"][0], qs).numpy()
    out["tdigest.quantiles_apart"] = float(
        (np.abs(est - cest) / np.abs(cest)).max())
    check(out["tdigest.quantiles_apart"] < 1e-5,
          f"17b: the updated digest's quantiles card vs CPU within "
          f"{out['tdigest.quantiles_apart']:.2e} (rtol 1e-5)")
    rel = [float((np.abs(est - exact.quantiles(t1, qs))
                  / exact.quantiles(t1, qs)).max())]
    both = exact.quantiles(np.concatenate([m1, m2]), [0.1, 0.5, 0.9])
    est = tdigest.quantiles(dig[DEV][1], [0.1, 0.5, 0.9]).cpu().numpy()
    rel.append(float((np.abs(est - both) / np.abs(both)).max()))
    out["tdigest.rel_err"] = rel
    check(float(tdigest.count(dig[DEV][0])) == len(t1)
          and rel[0] < 0.02 and rel[1] < 0.03,
          f"17b: tdigest count {len(t1)}; quantile error of the updates "
          f"{rel[0]:.4f} < 0.02, of the merge {rel[1]:.4f} < 0.03 (the "
          "reference's bounds)")
    S, cap = 4096, 32
    rows = rng.integers(0, S, n // 4).astype(np.int32)
    vals = rng.lognormal(6.0, 1.0, n // 4).astype(np.float32)
    ent = {}
    for dev in ("cpu", DEV):
        r, x = on(dev, rows, vals)
        parts = []
        for half in (slice(0, n // 8), slice(n // 8, None)):
            sv = torch.zeros((S, cap), device=dev)
            sn = torch.zeros(S, dtype=torch.int32, device=dev)
            sv, sn, _ = tdigest.stage_samples(sv, sn, r[half], x[half])
            parts.append(tdigest.flush_staged(
                tdigest.init(64, (S,), device=dev), sv, sn)[0])
        ent[dev] = tdigest.merge(*parts)
    apart = _digest_apart(torch, ent[DEV], ent["cpu"])
    out["tdigest.merge entities"] = apart
    check(apart["verdict"] == "ok"
          and torch.equal(tdigest.count(ent[DEV]).cpu(),
                          tdigest.count(ent["cpu"])),
          f"17b: tdigest.merge over {S} entities card vs CPU: {apart}; "
          "count exact")

    # HLL, CMS, invertible: the fused kernels' updates, then merge
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # integer weights whose sums stay below 2^24: f32 sums exact in any
    # order, so the card's atomics must agree with the CPU exactly
    w = rng.integers(1, 4, n).astype(np.float32)
    pr = rng.integers(0, 8, n).astype(np.float32)
    sk = {}
    for dev in ("cpu", DEV):
        h, l, ww, pp = on(dev, hi, lo, w, pr)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        halves = (slice(0, n // 2), slice(n // 2, None))
        hl = [hyperloglog.update(hyperloglog.init(14, device=dev), h[s],
                                 l[s]) for s in halves]
        cm = [countmin.update(countmin.init(4, 1 << 16, device=dev), h[s],
                              l[s], ww[s]) for s in halves]
        iv = [invertible.update(invertible.init(2, 4096, device=dev), h[s],
                                l[s], pp[s], ok[s]) for s in halves]
        sk[dev] = (hyperloglog.merge(*hl), countmin.merge(*cm),
                   invertible.merge(*iv))
    for i, name in enumerate(("hyperloglog.merge", "countmin.merge",
                              "invertible.merge")):
        exact_tree(name, sk["cpu"][i], sk[DEV][i])

    # top-K: update over a zipf stream, merge, dense_topk
    p = 1.0 / np.arange(1, 20001)
    draws = rng.choice(20000, size=n, p=p / p.sum())
    khi, klo = hi[:20000][draws], lo[:20000][draws]
    # a tie-heavy dense stat: lax.top_k's lower-index-first order
    stat = rng.integers(0, 50, (64, 4096)).astype(np.float32)
    step = n // chunks
    tk = {}
    for dev in ("cpu", DEV):
        h, l, ww, st = on(dev, khi, klo, w, stat)
        tabs = []
        for lo_, hi_ in ((0, n // 2), (n // 2, n)):
            t = topk.init(256, device=dev)
            for s in range(lo_, hi_, step):
                t = topk.update(t, h[s:s + step], l[s:s + step],
                                ww[s:s + step])
            tabs.append(t)
        tk[dev] = (topk.merge(*tabs), topk.dense_topk(st, 100))
    exact_tree("topk.merge", tk["cpu"][0], tk[DEV][0])
    exact_tree("topk.dense_topk", tk["cpu"][1], tk[DEV][1])

    # windows.add then tick
    deltas = rng.integers(0, 1000, (7, 512, 64)).astype(np.float32)
    wins = {}
    for dev in ("cpu", DEV):
        win = windows.init((512, 64), device=dev)
        for d in on(dev, deltas)[0]:
            win = windows.tick(windows.add(win, d))
        wins[dev] = win
    exact_tree("windows.add", wins["cpu"], wins[DEV])
    return out


def fold_trace_run(torch, names, bufs, tmp) -> dict:
    """17c: ``FoldProfiler`` over the first fold dispatches of a
    ``Runtime`` at a shard's geometry (ns ÷ 4; phase 8's buffers, so the
    kernels see the main path's lanes) on the card (see
    sharded_history_phase)."""
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.obs.spans import FoldProfiler
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    check(not torch.autograd._profiler_enabled(),
          "17c: no other torch.profiler session is running")
    prof = FoldProfiler(tmp / "trace", n_folds=SR_FOLDS)
    rt = Runtime(aggstate.EngineCfg(**SH_CFG), RuntimeOpts(**RT_OPTS),
                 device=DEV, profiler=prof)
    t0 = time.perf_counter()
    try:
        rt.feed(names)
        for i in range(SR_TRACE_BUFFERS):
            rt.feed(bufs[i % len(bufs)][0])
        rt.flush()
        torch.cuda.synchronize()
        disp = rt.stats.counters["fold_dispatches"]
    finally:
        rt.close()
    perf = {"s": time.perf_counter() - t0, "dispatches": disp}
    check(prof.path is not None and Path(prof.path).is_file()
          and not prof.active and not torch.autograd._profiler_enabled(),
          f"17c: the bracket ended after fold {SR_FOLDS} of {disp} and "
          f"wrote {prof.path}")
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    perf["trace_bytes"] = Path(prof.path).stat().st_size
    perf["events"] = len(events)

    def count(pred):
        return sum(1 for e in events if pred(e))

    perf["folds"] = count(lambda e: e.get("cat") == "user_annotation"
                          and e.get("name") == "gyt_fold")
    perf["device_kernels"] = {
        k: count(lambda e, d=f"{k}_kernel": e.get("cat") == "kernel"
                 and d in e.get("name", ""))
        for k in SR_KERNELS}
    log(f"  17c: trace of {perf['events']} events "
        f"({perf['trace_bytes'] / 2**20:.1f} MiB), {perf['folds']} "
        f"gyt_fold ranges; device kernels {perf['device_kernels']}")
    check(perf["folds"] == SR_FOLDS and disp > SR_FOLDS,
          f"17c: exactly {SR_FOLDS} of the {disp} fold dispatches traced")
    want = {k: n * SR_FOLDS for k, n in SR_KERNELS.items()}
    check(perf["device_kernels"] == want,
          f"17c: the trace names each entry's device kernel as often as "
          f"{SR_FOLDS} conn/resp dispatches launch it: {want}")
    return perf


def sharded_history_phase(torch, scatter, frames) -> tuple:
    """Phase 17: the sharded runtime's history replay at ns ÷ 4 a shard
    (17a), the mergeable sketch API on the card (17b) and the fold
    dispatches' device trace (17c)."""
    import shutil
    import tempfile

    names, _, bufs, _ = frames
    log(f"phase 17: the sharded runtime's history replay, {SH_N} shards on "
        f"the card; the mergeable sketches card vs CPU; the fold trace")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="gyt_smoke_shist_"))
    try:
        perf, launches = sharded_history_run(torch, scatter, names, bufs,
                                             tmp)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        perf["merges"] = merges_on_card(torch)
        perf["merges_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        perf["trace"] = fold_trace_run(torch, names, bufs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    perf["phase_s"] = time.perf_counter() - t0
    log(f"  phase 17: {perf['phase_s']:.1f} s")
    return perf, launches


def _no_lookup(*a, **kw):
    raise OSError("chip_smoke resolves no names")


def main(argv) -> int:
    import shutil
    import tempfile

    if argv[:1] == ["--trace-services"]:      # phase 16a's child
        return trace_services_main()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "gyeeta_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gyeeta_tpu_torch package beside {ROOT}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gyeeta_tpu_torch.sketch import scatter

    # no name lookups and no proxy: the only socket phase 8 opens is
    # its webhook receiver on 127.0.0.1
    socket.getnameinfo = _no_lookup
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    # each phase's seconds, printed on one line before the result line
    phase_s, clock = {}, [t_all]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

    libs = scatter.build()
    log(f"phase 0: built {', '.join(str(p.relative_to(ROOT)) for p in libs)}"
        f" in {time.perf_counter() - t_all:.1f}s")
    lap("0")

    torch.cuda.reset_peak_memory_stats()
    st, captured, stage, launches, perf = ns_phase(torch, scatter)
    del st
    torch.cuda.empty_cache()
    lap("1-3")
    tiny_phase(torch)
    lap("4")
    kernels = fused_phase(torch, scatter, captured, launches) + \
        generic_phase(torch, scatter, captured, stage, launches)
    torch.cuda.empty_cache()
    lap("5")
    fa = fold_all_phase(torch, scatter)
    torch.cuda.empty_cache()
    lap("7")
    rtp, rt_launches, frames = runtime_phase(torch, scatter)
    gc.collect()              # a published snapshot refers to its runtime
    torch.cuda.empty_cache()
    lap("8")
    dp, d_launches, d_sites = delta_phase(torch, scatter)
    gc.collect()
    torch.cuda.empty_cache()
    lap("9")
    # phase 10 writes its WAL and shards here; phase 12a ships them
    hist_dir = Path(tempfile.mkdtemp(prefix="gyt_smoke_hist_"))
    try:
        hp, h_launches, h_opts, h_at = history_phase(
            torch, scatter, frames, rtp["buffer_ms"], hist_dir)
        gc.collect()
        torch.cuda.empty_cache()
        lap("10")
        rp, r_launches = region_phase(torch, scatter, hist_dir, h_opts,
                                      h_at)
    finally:
        shutil.rmtree(hist_dir, ignore_errors=True)
    lap("12a")
    sp, s_launches = serving_phase(torch, scatter, frames, rtp)
    lap("11+12b")
    shp, sh_launches, oracle = sharded_phase(torch, scatter, frames, rtp)
    lap("13")
    wp, part_launches, ring_launches = worker_phase(torch, scatter, frames,
                                                    oracle, rtp)
    del oracle
    gc.collect()
    torch.cuda.empty_cache()
    lap("14")
    hsp, sr_launches = sharded_history_phase(torch, scatter, frames)
    del frames
    lap("17")
    ap, ag_launches = agent_phase(torch, scatter)
    lap("15")
    tp, tr_launches = trace_phase(torch, scatter)
    lap("16")
    # the one-launch merge runs only in the delta section: its entry is
    # phase 9's call at one delta dispatch's inputs
    kernels.append(_entry("delta_merge", GENERIC_SOURCE,
                          GENERIC["delta_merge"], d_launches["delta_merge"],
                          d_sites["delta_merge"], library=True))
    for k in kernels:
        k["launches_fold_all"] = fa["launches"][k["name"]]
        k["launches_runtime"] = rt_launches[k["name"]]
        k["launches_delta"] = d_launches[k["name"]]
        k["launches_history"] = h_launches[k["name"]]
        k["launches_serving"] = s_launches[k["name"]]
        k["launches_region"] = r_launches[k["name"]]
        k["launches_sharded_slab"] = sh_launches[k["name"]]
        k["launches_part_slab"] = part_launches[k["name"]]
        k["launches_ring_slab"] = ring_launches[k["name"]]
        k["launches_agents"] = ag_launches[k["name"]]
        k["launches_trace"] = tr_launches[k["name"]]
        k["launches_sharded_replay"] = sr_launches[k["name"]]
        cs = d_sites.get(k["name"])
        if cs:
            k["delta"] = {f: sum(c[f] for c in cs) for f in (
                "ms", "plain_ms", "bound_ms")} | {
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "library_ms": sum(c["library_ms"] for c in cs)
                if "library_ms" in cs[0] else None,
                "calls": cs}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("phase 6:")
    prof = perf["profile"]
    log(f"fold rate: {perf['events_per_s']:.1f} events/s, "
        f"{perf['ms_per_dispatch']:.4f} ms/dispatch; under the profiler "
        f"{prof['device_ops_per_dispatch']:.1f} device ops/dispatch, device "
        f"busy {prof['device_busy_ms_per_dispatch']:.4f} of "
        f"{prof['wall_ms_per_dispatch']:.4f} ms/dispatch")
    log(f"max_memory_allocated: {perf['max_memory_allocated_gib']:.3f} GiB")
    log(json.dumps({"fold": perf}))
    log(json.dumps({"fold_all": fa}))
    log(json.dumps({"runtime": rtp}))
    log(json.dumps({"delta": dp}, default=float))
    log(json.dumps({"history": hp}, default=float))
    log(json.dumps({"serving": sp}, default=float))
    log(json.dumps({"region": rp}, default=float))
    log(json.dumps({"sharded": shp}, default=float))
    log(json.dumps({"workers": wp}, default=float))
    log(json.dumps({"agents": ap}, default=float))
    log(json.dumps({"trace": tp}, default=float))
    log(json.dumps({"sharded_history": hsp}, default=float))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    phase_s["total"] = round(time.perf_counter() - t_all, 1)
    log(json.dumps({"phase_s": phase_s}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
