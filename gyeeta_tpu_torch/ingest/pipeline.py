"""Feed pipeline: deframe/decode on a worker thread (L1/L2 split).

Counterpart of ``gyeeta_tpu/ingest/pipeline.py``: the worker deframes
through the runtime's own path (``Runtime.drain2``: native unless the
runtime was built with ``deframe="python"``).

The reference splits ingest across L1 threads (recv + validate) and
L2 handlers (process) connected by MPMC queues
(``server/gy_mconnhdlr.h:53-75``, the L1→DB_WRITE_ARR→L2 pipeline).
The single-thread runtime already overlaps HOST decode with DEVICE
folds via async dispatch; this optional pipeline adds the L1/L2
thread split for MULTI-CORE hosts: the native deframer and columnar
decoders release the GIL, so a dedicated worker deframes buffer N+1
while the serving thread dispatches buffer N's folds.

Ordering and framing semantics match direct ``feed`` — ONE worker
owns the partial-frame resume buffer, the bounded queue preserves
byte-stream order, and the serving thread folds results in submission
order. ``flush()`` barriers the pipeline then the runtime, so
cadence/query boundaries see every submitted byte.

Divergences from the direct path, by design:
- **Poison frames do not close connections.** Decode completes after
  ``feed`` returns, and the pipeline is shared across conns, so a
  deep-validation failure cannot be attributed back to its sender.
  The worker resyncs its framing and the failure is COUNTED
  (``frames_bad`` + ``pipeline_frame_errors``) instead of raised.
- **Capture recording moves into the pipeline** (pass ``recorder``):
  only buffers that DECODED cleanly are recorded, preserving the
  "recorded bytes are replayable" invariant that a caller-side write
  could not (it would record bytes whose validation hadn't happened
  yet).
- Deframe latency is observed on the worker and recorded into the
  stats histogram from the serving thread (selfstats stays accurate
  in pipeline mode).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from gyeeta_tpu_torch.ingest import wire


class FeedPipeline:
    """Bounded 2-stage pipeline in front of a Runtime.

    ``feed(buf)`` submits bytes to the decode worker and folds any
    COMPLETED deframe results; at most ``depth`` buffers ride the
    queue before submission blocks on the oldest result (natural
    backpressure toward the socket, like the reference's bounded
    pools). Returns records folded BY THIS CALL (drained results),
    not necessarily from ``buf`` itself.
    """

    def __init__(self, rt, depth: int = 4, recorder=None):
        self._rt = rt
        self._ex = ThreadPoolExecutor(1, "gyt-decode")
        self._fifo: deque = deque()
        self.depth = depth
        self._recorder = recorder
        self._pending = b""              # worker-owned framing state
        self.n_frame_errors = 0

    def _deframe(self, buf: bytes):
        """Runs ON THE WORKER: native deframe with resume framing."""
        t0 = time.perf_counter()
        data = (self._pending + buf) if self._pending else buf
        try:
            recs, consumed, unknown = self._rt.drain2(data)
        except wire.FrameError:
            self._pending = b""          # poison frame: resync
            raise
        self._pending = data[consumed:]
        if unknown:
            self._rt.stats.bump("records_unknown_subtype", unknown)
        return buf, recs, (time.perf_counter() - t0) * 1e3

    def _fold_one(self) -> int:
        fut, hid, conn_id = self._fifo.popleft()
        try:
            buf, recs, dt_ms = fut.result()
        except wire.FrameError:
            # see module docstring: counted, not raised — the sender
            # cannot be identified once decode is asynchronous
            self.n_frame_errors += 1
            self._rt.stats.bump("frames_bad")
            self._rt.stats.bump("pipeline_frame_errors")
            return 0
        self._rt.stats.observe_ms("deframe", dt_ms)
        if self._recorder is not None:
            self._recorder.write(buf)    # validated ⇒ replayable
        # WAL append mirrors the recorder's invariant (validated ⇒
        # replayable); the direct path appends inside Runtime.feed,
        # this path feeds records, so the journal hook lives here
        j = getattr(self._rt, "journal", None)
        if j is not None and not getattr(self._rt, "_journal_replaying",
                                         False):
            j.append(buf, hid=hid, conn_id=conn_id,
                     tick=getattr(self._rt, "_tick_no", 0))
        # fold-side visibility (the deframe span above only covers the
        # worker): the serving thread's decode+dispatch wall per buffer
        # rides its own span + timing hist, so the decode/fold overlap
        # win is observable in `obs top` and /metrics (stage
        # `pipeline_fold_dispatch`; the runtime's own `fold_dispatch`
        # hist times just the device dispatch inside this window)
        nrec = sum(len(a) for a in recs.values())
        t1 = time.perf_counter()
        spans = getattr(self._rt, "spans", None)
        if spans is not None:
            with spans.span("fold_dispatch", nrec=nrec,
                            path=self._rt.deframe):
                n = self._rt.ingest_records(recs)
        else:
            n = self._rt.ingest_records(recs)
        self._rt.stats.observe_ms("pipeline_fold_dispatch",
                                  (time.perf_counter() - t1) * 1e3)
        return n

    def feed(self, buf: bytes, hid: int = 0, conn_id: int = 0) -> int:
        self._fifo.append((self._ex.submit(self._deframe, buf),
                           hid, conn_id))
        n = 0
        # fold everything already decoded; block only at depth
        while self._fifo and (self._fifo[0][0].done()
                              or len(self._fifo) > self.depth):
            n += self._fold_one()
        return n

    def flush(self) -> int:
        """Barrier: fold every submitted buffer, then runtime flush."""
        n = 0
        while self._fifo:
            n += self._fold_one()
        self._rt.flush()
        return n

    def close(self) -> None:
        self.flush()
        self._ex.shutdown(wait=True)
