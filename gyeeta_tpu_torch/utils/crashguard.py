"""In-process crash forensics and the liveness watchdog.

Counterpart of ``gyeeta_tpu/utils/crashguard.py``. The reference's init
tier installs fatal-signal handlers that dump a
backtrace before dying and runs scheduler watchdogs that detect stuck
threads (``common/gy_init_proc.cc`` signal setup; scheduler liveness
checks). The Python-runtime equivalents:

- :func:`enable_crash_dumps` — ``faulthandler`` on SIGSEGV/FPE/ABRT/
  BUS writes every thread's stack to a crash file before the process
  dies (the post-mortem the reference's handler prints), plus
  SIGQUIT-on-demand dumps for live debugging.
- :class:`TickWatchdog` — a daemon thread watching a heartbeat the
  serving loop beats each tick; a silent gap beyond the threshold
  dumps all-thread tracebacks to the crash file and logs loudly
  (a wedged asyncio loop or a blocked device call — a CUDA sync that
  never returns — is otherwise invisible until an operator notices
  stale data).
"""

from __future__ import annotations

import faulthandler
import logging
import threading
import time
from typing import Optional

log = logging.getLogger("gyeeta_tpu_torch.crashguard")

_crash_file = None


def enable_crash_dumps(path: str) -> None:
    """Fatal-signal + on-demand (SIGQUIT) stack dumps into ``path``."""
    global _crash_file
    f = open(path, "a")                    # noqa: SIM115 — lives until
    _crash_file = f                        # process death by design
    faulthandler.enable(file=f, all_threads=True)
    try:
        import signal
        faulthandler.register(signal.SIGQUIT, file=f, all_threads=True,
                              chain=False)
    except (ImportError, AttributeError, ValueError):
        pass                               # non-main thread / platform


class TickWatchdog:
    """Detects a stalled serving loop; dumps stacks once per stall."""

    def __init__(self, stall_after_s: float = 60.0, clock=None,
                 on_stall=None):
        self.stall_after_s = stall_after_s
        self._clock = clock or time.monotonic
        self._last_beat = self._clock()
        self._on_stall = on_stall          # test seam / notify hook
        self._stalled = False
        self.n_stalls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """Called by the serving loop each tick."""
        self._last_beat = self._clock()
        self._stalled = False

    def start(self) -> None:
        self._stop.clear()                 # restartable after stop()
        self._thread = threading.Thread(target=self._run,
                                        name="gyt-watchdog", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(min(self.stall_after_s / 4, 5.0)):
            gap = self._clock() - self._last_beat
            if gap > self.stall_after_s and not self._stalled:
                self._stalled = True       # one dump per stall episode
                self.n_stalls += 1
                log.error("serving loop stalled: no tick for %.0fs — "
                          "dumping all thread stacks", gap)
                try:
                    faulthandler.dump_traceback(
                        file=_crash_file or None, all_threads=True)
                except Exception:          # noqa: BLE001 — best effort
                    pass
                if self._on_stall is not None:
                    try:
                        self._on_stall(gap)
                    except Exception:      # noqa: BLE001
                        pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
