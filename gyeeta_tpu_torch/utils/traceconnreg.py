"""TRACECONN registry: traced connections per service, host-side.

The reference keeps per-connection grouping for traced requests next
to the per-API aggregation (SUBSYS_TRACECONN,
``gy_json_field_maps.h:2670``: svcid, service comm, connid, client
process group, client comm, client-is-service). Connection identity is
announce-rate metadata — it belongs in a bounded host-side registry
(like svcinfo/hostinfo), not a device slab; the per-API latency slab
stays the device half.

Fed from RAW REQ_TRACE records before columnar decode (the same
pattern as ``natreg``/``svcreg``): conn_id → identity + request
tallies, bounded with oldest-idle eviction.

A copy of ``gyeeta_tpu/utils/traceconnreg.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire


class TraceConnRegistry:
    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        # conn_id -> [svc_glob_id, cli_task, cli_comm_id, host_id,
        #             nreq, last_tick]
        self._conns: dict[int, list] = {}
        self._tick = 0

    def observe(self, recs: np.ndarray) -> int:
        """Fold one raw REQ_TRACE chunk; returns records folded.

        Vectorized tally: one ``np.unique`` collapses the chunk to its
        distinct conn_ids (usually ≪ records — conns are persistent),
        so the Python dict work is per-CONN, not per-record (the hot
        ingest path stays vectorized)."""
        if not len(recs):
            return 0
        cids = recs["conn_id"].astype(np.uint64)
        uniq, first, counts = np.unique(cids, return_index=True,
                                        return_counts=True)
        for cid, fi, cnt in zip(uniq.tolist(), first.tolist(),
                                counts.tolist()):
            if not cid:
                continue
            ent = self._conns.get(cid)
            if ent is None:
                if len(self._conns) >= self.capacity:
                    self._evict()
                r = recs[fi]
                self._conns[cid] = [int(r["svc_glob_id"]),
                                    int(r["cli_task_aggr_id"]),
                                    int(r["cli_comm_id"]),
                                    int(r["host_id"]), cnt, self._tick]
            else:
                ent[4] += cnt
                ent[5] = self._tick
        return len(recs)

    def _evict(self) -> None:
        """Drop the oldest-idle eighth (amortized, bounded walk)."""
        items = sorted(self._conns.items(), key=lambda kv: kv[1][5])
        for cid, _ in items[: max(1, len(items) // 8)]:
            del self._conns[cid]

    def age(self, max_idle_ticks: int = 720) -> int:
        self._tick += 1
        stale = [cid for cid, e in self._conns.items()
                 if self._tick - e[5] > max_idle_ticks]
        for cid in stale:
            del self._conns[cid]
        return len(stale)

    def __len__(self) -> int:
        return len(self._conns)

    def columns(self, names=None, svc_task_ids=None):
        """(cols, mask) for SUBSYS_TRACECONN. ``svc_task_ids`` is the
        set of process-group ids (hex) that serve a listener — rows
        whose client group is in it get ``csvc`` (client is itself a
        service, the mesh-edge flag of the reference's traceconn)."""
        n = len(self._conns)
        hx = lambda v: format(v & (2**64 - 1), "016x")  # noqa: E731
        svcid = np.empty(n, object)
        connid = np.empty(n, object)
        cprocid = np.empty(n, object)
        cname = np.empty(n, object)
        svcname = np.empty(n, object)
        csvc = np.zeros(n, bool)
        nreq = np.zeros(n, np.float64)
        hostid = np.zeros(n, np.float64)
        idle = np.zeros(n, np.float64)
        task_ids = svc_task_ids or set()
        for i, (cid, e) in enumerate(sorted(self._conns.items())):
            svcid[i] = hx(e[0])
            connid[i] = hx(cid)
            cprocid[i] = hx(e[1])
            comm = ""
            if names is not None:
                comm = names.lookup(wire.NAME_KIND_COMM, e[2]) or ""
                svcname[i] = names.lookup(wire.NAME_KIND_SVC, e[0]) \
                    or ""
            else:
                svcname[i] = ""
            cname[i] = comm
            csvc[i] = cprocid[i] in task_ids
            nreq[i] = e[4]
            hostid[i] = e[3]
            idle[i] = self._tick - e[5]
        cols = {"svcid": svcid, "name": svcname, "connid": connid,
                "cprocid": cprocid, "cname": cname, "csvc": csvc,
                "nreq": nreq, "hostid": hostid, "idleticks": idle}
        return cols, np.ones(n, bool)
