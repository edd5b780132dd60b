#!/usr/bin/env python3
"""Time the port's ``Runtime.feed`` of conn/resp buffers on one GPU, for
the checkout at ``--root``: to hold two commits against each other on
one card, run it once per checkout in one session, alternating (A, B, B,
A), and compare the lines.

    python3 feed_ab.py --root PATH [--rounds 3] [--buffers 16]

Geometry and stream are ``chip_smoke.py``'s phase 8 (north-star
``EngineCfg``, ``ParthaSim(n_hosts=512, n_svcs=128)``, feed buffers of
32,768 conn records — one in eight a split half — and 65,536 resp
records), without its registry records, so any commit of the port since
its ``Runtime`` feeds the same bytes. It builds that checkout's kernels,
feeds names, one state sweep and two buffers, runs a tick, then times
``--rounds`` rounds of ``--buffers`` buffers (synchronised) and counts
the host syncs of one more buffer (CUDA sync debug mode). Prints one
JSON line: the checkout, ms a buffer by round, syncs, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--buffers", type=int, default=16)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("feed_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import importlib.util
    here = Path(__file__).resolve().parent
    # the stream builders are this script's checkout's; the package is
    # --root's
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(a.root).resolve()))
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.ingest import wire
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.sim import ParthaSim
    from gyeeta_tpu_torch.sketch import scatter
    from gyeeta_tpu_torch.utils.config import RuntimeOpts

    scatter.build()
    cfg = aggstate.EngineCfg(**cs.NS_CFG)
    sim = ParthaSim(**cs.NS_SIM, seed=11)
    n_svcs = sim.n_hosts * sim.n_svcs
    trace_svcs = list(sim.glob_ids.reshape(-1)[::n_svcs // cs.TRACE_SVCS])
    names = sim.name_frames()
    sweep = cs.sweep_frames(sim, wire, trace_svcs)
    bufs = [cs.feed_buffer(sim, cfg, wire)[0] for _ in range(cs.RT_DISTINCT)]
    rt = Runtime(cfg, RuntimeOpts(**cs.RT_OPTS), device="cuda")
    rt.feed(names)
    rt.feed(sweep)
    for i in range(2):
        rt.feed(bufs[i])
    rt.run_tick()
    torch.cuda.synchronize()
    ms, j = [], 0
    for _ in range(a.rounds):
        t0 = time.perf_counter()
        for _ in range(a.buffers):
            rt.feed(bufs[j % len(bufs)])
            j += 1
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / a.buffers * 1e3)
    syncs = cs.count_syncs(torch, lambda: rt.feed(bufs[0]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(a.root), "ms_per_buffer": ms,
                      "syncs_per_buffer": len(syncs),
                      "events_per_buffer": cfg.fold_k * (cfg.conn_batch
                                                         + cfg.resp_batch),
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
