"""Pipeline span tracer: a fixed-size ring of per-stage spans.

Counterpart of ``SpanTracer`` in ``gyeeta_tpu/obs/spans.py``. The ring
keeps the most recent N spans of the feed pipeline — one span a stage a
batch (``deframe`` in ``feed``, ``decode_fold`` a fold dispatch,
``tick`` in ``run_tick``), each with its record count, the decode path
and the host wall time — surfaced as ``spans`` in the ``selfstats``
payload. Recording a span is two clock reads and one list-slot write.
Wall times are the host's: a fold dispatch's span ends when its kernels
are queued, not when they finish.

:class:`FoldProfiler` is the device-timeline complement, the
counterpart of the reference's ``jax.profiler`` bracket: a
``torch.profiler`` session over the first N fold dispatches of a
runtime, exported as a Chrome trace. It takes its directory and fold
count as arguments (``serve --profile-dir/--profile-folds``), not from
the environment.
"""

from __future__ import annotations

import contextlib
import os
import time

_FIELDS = ("name", "t", "wallms", "nrec", "path")


class SpanTracer:
    """Lock-free single-writer ring buffer of (name, t, wallms, nrec,
    path) spans. ``capacity`` bounds memory forever; old spans are
    overwritten (the notifymsg-ring discipline)."""

    __slots__ = ("_buf", "_cap", "_i", "total")

    def __init__(self, capacity: int = 1024):
        self._buf: list = [None] * max(capacity, 1)
        self._cap = max(capacity, 1)
        self._i = 0
        self.total = 0          # spans ever recorded (overwrites included)

    def record(self, name: str, t: float, wallms: float,
               nrec: int = 0, path: str = "") -> None:
        self._buf[self._i] = (name, t, wallms, nrec, path)
        self._i = (self._i + 1) % self._cap
        self.total += 1

    @contextlib.contextmanager
    def span(self, name: str, nrec: int = 0, path: str = ""):
        """Record one span around a code block (host wall time)."""
        t = time.time()
        p0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t, (time.perf_counter() - p0) * 1e3,
                        nrec, path)

    def __len__(self) -> int:
        return min(self.total, self._cap)

    def rows(self, last: int = 128) -> list[dict]:
        """Newest-first span dicts (bounded by ``last``)."""
        n = min(len(self), last)
        out = []
        for k in range(1, n + 1):
            rec = self._buf[(self._i - k) % self._cap]
            if rec is None:          # pragma: no cover — len() guards
                break
            out.append({f: (round(v, 4) if f == "wallms" else v)
                        for f, v in zip(_FIELDS, rec)})
        return out

    def clear(self) -> None:
        self._buf = [None] * self._cap
        self._i = 0
        self.total = 0


class FoldProfiler:
    """Opt-in ``torch.profiler`` bracket over fold dispatches 1..N.

    Inert unless ``trace_dir`` is given. Armed, the first
    :meth:`fold` starts a session (CPU activity always, CUDA activity
    when the runtime's device is a CUDA device), each fold runs inside
    a ``gyt_fold`` range (its kernels appear under their device names,
    ``gyt_hll_update_kernel``, ``gyt_scatter_sites_kernel``, …), and the
    N-th fold's end stops the session and writes
    ``gyt_folds_<pid>.pt.trace.json`` into ``trace_dir``
    (``path``). :meth:`close` stops a bracket that did not reach N folds
    and writes its file. A session that cannot start raises: nothing
    runs untraced while a trace is claimed."""

    def __init__(self, trace_dir=None, n_folds: int = 20):
        self.dir = str(trace_dir) if trace_dir else None
        self.n_folds = int(n_folds)
        if self.dir is not None and self.n_folds < 1:
            raise ValueError(f"n_folds must be >= 1, got {n_folds}")
        self.path = None            # the trace file, once written
        self._seen = 0
        self._prof = None
        self._cuda = None           # the traced CUDA device, if any

    @property
    def armed(self) -> bool:
        return self.dir is not None and self._seen < self.n_folds

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _start(self, device) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if torch.autograd._profiler_enabled():
            # a second session in one thread neither raises nor traces
            raise RuntimeError("fold profiler: another torch.profiler "
                               "session is active")
        os.makedirs(self.dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            self._cuda = device
        prof = profile(activities=acts)
        prof.start()
        if not torch.autograd._profiler_enabled():
            raise RuntimeError("fold profiler: torch.profiler did not "
                               "start")
        self._prof = prof

    def _stop(self) -> None:
        import torch
        prof, self._prof = self._prof, None
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)    # the last fold's kernels
        prof.stop()
        path = os.path.join(self.dir,
                            f"gyt_folds_{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.path = path

    @contextlib.contextmanager
    def fold(self, device):
        """Bracket one fold dispatch on ``device`` (hot path: two
        attribute reads when unarmed or done)."""
        if self.dir is None or self._seen >= self.n_folds:
            yield
            return
        from torch.profiler import record_function
        if self._prof is None:
            self._start(device)
        self._seen += 1
        with record_function("gyt_fold"):
            yield
        if self._seen >= self.n_folds:
            self._stop()

    def close(self) -> None:
        """Stop a bracket short of N folds and write its trace."""
        if self._prof is not None:
            self._stop()
