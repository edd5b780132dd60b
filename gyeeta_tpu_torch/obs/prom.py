"""Prometheus text-format exposition of the runtime's self-metrics.

Counterpart of ``gyeeta_tpu/obs/prom.py``: renders the ``Stats``
registry (``utils/selfstats.py``) as exposition format 0.0.4 text:

- counters → ``gyt_<name>_total``; a counter bumped as ``name|k=v``
  renders as the labelled sample ``gyt_name_total{k="v"}``;
- gauges → ``gyt_<name>`` (the ``engine_*`` device-health gauges of
  ``obs/health.py``, the snapshot freshness gauges, ``uptime_seconds``);
- timing histograms → ``gyt_stage_duration_seconds{stage=...}``: the
  geometric buckets as cumulative ``le`` buckets in seconds with
  ``_sum``/``_count``, trailing all-zero buckets elided (+Inf always
  emitted);
- an alert manager's counters → ``gyt_alerts_<name>_total`` (including
  ``gyt_alerts_ncq_group_evals_total``: criteria-group predicate passes,
  one per group of defs sharing a canonical filter).

The ``metrics`` query subsystem serves this text
(``query/api.py:local_response``).
"""

from __future__ import annotations

import re
import time

import numpy as np

from gyeeta_tpu_torch.utils import selfstats as SS

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    n = _SANITIZE.sub("_", str(raw))
    if not _NAME_OK.match(n):
        n = "_" + n
    return n


def _num(v) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(stats, alerts=None) -> str:
    """``Stats`` registry → exposition text. Engine-health gauges are
    expected to already sit in ``stats.gauges`` (the runtimes fold the
    batched readback in before rendering)."""
    out: list[str] = []

    # consistent copies: the exposition renders on query worker threads
    # in snapshot mode while the serving loop keeps bumping
    counters, gauges = stats.export()

    # group counters into families: plain names stand alone; "name|k=v"
    # label-encoded names collapse into one family with labeled samples
    families: dict[str, list] = {}
    for k in counters:
        base, _, labels = k.partition("|")
        families.setdefault(base, []).append((labels, counters[k]))
    for base in sorted(families):
        n = f"gyt_{_name(base)}_total"
        out.append(f"# TYPE {n} counter")
        for labels, v in sorted(families[base]):
            lab = ""
            if labels:
                parts = [f'{_name(kk)}="{vv}"' for kk, _, vv in
                         (p.partition("=") for p in labels.split(","))]
                lab = "{" + ",".join(parts) + "}"
            out.append(f"{n}{lab} {_num(v)}")

    if alerts is not None:
        for k in sorted(alerts.stats):
            n = f"gyt_alerts_{_name(k)}_total"
            out.append(f"# TYPE {n} counter")
            out.append(f"{n} {_num(alerts.stats[k])}")

    gauges["uptime_seconds"] = time.time() - stats.t_start
    # gauges share the counters' "name|k=v" label convention (the
    # per-shard fold-rate / occupancy gauges of the mesh tier)
    gfam: dict[str, list] = {}
    for k in gauges:
        base, _, labels = k.partition("|")
        gfam.setdefault(base, []).append((labels, gauges[k]))
    for base in sorted(gfam):
        n = f"gyt_{_name(base)}"
        out.append(f"# TYPE {n} gauge")
        for labels, v in sorted(gfam[base]):
            lab = ""
            if labels:
                parts = [f'{_name(kk)}="{vv}"' for kk, _, vv in
                         (p.partition("=") for p in labels.split(","))]
                lab = "{" + ",".join(parts) + "}"
            out.append(f"{n}{lab} {_num(v)}")

    hists = stats.timing_hists()
    if hists:
        h_name = "gyt_stage_duration_seconds"
        out.append(f"# TYPE {h_name} histogram")
        for stage, counts, total_ms in hists:
            lab = _name(stage)
            cum = np.cumsum(counts)
            n = int(cum[-1])
            if n == 0:
                continue
            last = int(np.nonzero(counts)[0][-1])
            for b in range(last + 1):
                le = SS.bucket_upper_ms(b) / 1e3
                out.append(f'{h_name}_bucket{{stage="{lab}",'
                           f'le="{_num(le)}"}} {int(cum[b])}')
            out.append(f'{h_name}_bucket{{stage="{lab}",le="+Inf"}} {n}')
            out.append(f'{h_name}_sum{{stage="{lab}"}} '
                       f'{repr(total_ms / 1e3)}')
            out.append(f'{h_name}_count{{stage="{lab}"}} {n}')

    return "\n".join(out) + "\n"


def metrics_response(stats, alerts=None) -> dict:
    """The ``metrics`` query-subsystem payload: exposition text plus
    the content type the HTTP gateway must serve it under."""
    return {"text": render(stats, alerts), "content_type": CONTENT_TYPE}
