#!/usr/bin/env python3
"""Profile the delta-fed dispatches of ``chip_smoke.py``'s phase 9 for
the checkout at ``--root``: to hold two commits against each other on
one card, run it once per checkout in one command, alternating (A, B,
B, A), and compare the lines.

    python3 delta_ab.py --root PATH

It imports that checkout's ``chip_smoke`` and ``gyeeta_tpu_torch``,
builds its kernels and runs its ``delta_phase`` whole (about 100 s on
an H100: the warm-up and measured ticks, the raw runtime and its
bounds, four delta dispatches under torch.profiler, the kernels against
their plain versions, the snapshot queries, the tiny stream card vs
CPU), every check of that checkout included. Prints one JSON line: the
checkout, the profile of the four dispatches (wall and device-busy ms
and device ops a dispatch), the printed rows of its top device kernels,
the p50 and max ms of a synchronised delta dispatch, the kernels'
launches, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    a = ap.parse_args(argv)
    root = Path(a.root).resolve()
    import torch
    if not torch.cuda.is_available():
        print("delta_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from gyeeta_tpu_torch.sketch import scatter
    if not Path(C.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"chip_smoke came from {C.__file__}, not {root}")
    lines = []
    log = C.log

    def keep_log(msg):
        lines.append(msg)
        log(msg)

    C.log = keep_log
    scatter.build()
    dp, launches, _ = C.delta_phase(torch, scatter)
    at = next(i for i, m in enumerate(lines)
              if m.lstrip().startswith("profile of"))
    rows = []
    for m in lines[at + 1:]:
        if "us/dispatch" not in m:
            break
        rows.append(m.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    prof = {k: v for k, v in dp["profile"].items() if k != "top_kernels"}
    print(json.dumps({"delta_ab": {
        "root": str(root), "profile": prof, "top_kernels": rows,
        "delta_dispatch_ms": dp["delta_dispatch_ms"],
        "launches": launches}, "device": smi}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
