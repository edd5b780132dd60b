"""Agent-side edge fold: raw conn/resp sweeps → mergeable delta records.

Counterpart of ``gyeeta_tpu/sketch/edgefold.py`` (pure numpy, as there:
it runs on the agent's host). Per sweep an agent folds its own TCP_CONN
and RESP_SAMPLE records into the per-service counter columns the server
fold would have produced, plus small sketch partials (loghist bucket
counts, HLL register maxes, capped flow aggregates, dependency-edge
sums), and ships one ``NOTIFY_SKETCH_DELTA`` record stream
(``wire.DELTA_DT``) instead of the raw tuples.

Merge contract (the server half is ``engine/step.py:ingest_delta``):

- counters, loghist buckets, CMS mass and dependency edges are
  per-sweep sums, scatter-added by the server, so splitting a sweep
  across records or frames never changes totals;
- HLL registers are monotone maxes: the agent keeps a cumulative
  register file and ships only the registers that rose this sweep, and
  every ``hll_refresh_every`` sweeps the whole file;
- flows are capped at ``flow_max`` aggregates a sweep, heaviest first;
  the truncated mass ships as a ``DK_RESID`` bound that the server
  charges to the top-K ``evicted`` undercount.

The geometry (loghist spec, HLL precisions, digest stride) is the
server's, from its advert (``wire.PREAGG_DT``), so bucket counts and HLL
registers are the ones the raw fold would give.

The reference's serving-edge opt-in (``preagg_enabled``, an environment
knob) is not here: the port has no serving edge yet.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import decode, wire
from gyeeta_tpu_torch.sketch import hyperloglog as hll, loghist


def params_of_cfg(cfg, td_stride: int | None = None,
                  flow_max: int | None = None) -> dict:
    """The pre-aggregation advert for one engine geometry (the dict
    ``wire.encode_preagg`` serializes). ``flow_max`` defaults to half
    the top-K capacity (at least 64); ``td_stride`` to four times the
    engine's own digest stride — the reference's defaults."""
    if flow_max is None:
        flow_max = max(64, cfg.topk_capacity // 2)
    if td_stride is None:
        td_stride = 4 * cfg.td_sample_stride
    return {
        "hll_p_svc": cfg.hll_p_svc,
        "hll_p_global": cfg.hll_p_global,
        "td_stride": max(1, int(td_stride)),
        "resp_nbuckets": cfg.resp_spec.nbuckets,
        "flow_max": int(flow_max),
        "resp_vmin": float(cfg.resp_spec.vmin),
        "resp_vmax": float(cfg.resp_spec.vmax),
    }


def default_params() -> dict:
    """Advert matching the default ``EngineCfg``."""
    from gyeeta_tpu_torch.engine.aggstate import EngineCfg
    return params_of_cfg(EngineCfg())


def _key64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((hi.astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint64))


class EdgeFold:
    """One agent's local fold state (per host in multi-host sims).

    ``fold_sweep(conn_recs, resp_recs)`` → a ``wire.DELTA_DT`` record
    array carrying the whole sweep. Cumulative state is ONLY the HLL
    register files (monotone; everything else is per-sweep)."""

    def __init__(self, params: dict, host_id: int = 0,
                 hll_refresh_every: int = 120):
        self.params = dict(params)
        self.host_id = int(host_id)
        self.resp_spec = loghist.LogHistSpec(
            vmin=float(params["resp_vmin"]),
            vmax=float(params["resp_vmax"]),
            nbuckets=int(params["resp_nbuckets"]))
        self.p_svc = int(params["hll_p_svc"])
        self.p_glob = int(params["hll_p_global"])
        self.td_stride = max(1, int(params["td_stride"]))
        self.flow_max = max(1, int(params["flow_max"]))
        # cumulative register files: {(host, svc64): uint8[m_svc]} and
        # {host: uint8[m_glob]} — a few KB per tracked entity
        self._svc_regs: dict = {}
        self._glob_regs: dict = {}
        self.hll_refresh_every = max(0, int(hll_refresh_every))
        self._sweeps = 0
        self.stats = {"records_in": 0, "delta_records": 0,
                      "resid_bytes": 0.0, "onesided_skipped": 0}
        # exact per-svc running totals: what the server's ctr_win
        # columns must show, within float addition
        self.totals: dict = {}

    # ------------------------------------------------------------ helpers
    def _rows(self, n: int) -> np.ndarray:
        r = np.zeros(n, wire.DELTA_DT)
        r["host_id"] = self.host_id
        return r

    @staticmethod
    def _pack_pairs(rows_out: list, kind: int, key64, host, idx, wt):
        """Chunk sparse (idx, weight) pairs for ONE key into ≤16-pair
        records (splitting is free: the merges are monotone)."""
        P = wire.DELTA_PAIRS
        for off in range(0, len(idx), P):
            n = min(P, len(idx) - off)
            r = np.zeros(1, wire.DELTA_DT)
            r["kind"] = kind
            r["key_hi"] = np.uint32(key64 >> np.uint64(32))
            r["key_lo"] = np.uint32(key64 & np.uint64(0xFFFFFFFF))
            r["nitem"] = n
            r["host_id"] = host
            pv = r["payload"].reshape(-1)[: n * 6].view(wire.DELTA_PAIR_DT)
            pv["idx"] = idx[off: off + n].astype(np.uint16)
            pv["wt"] = wt[off: off + n].astype(np.float32)
            rows_out.append(r)

    def _hll_delta(self, regs: np.ndarray, idx, rank, refresh: bool):
        """Fold (idx, rank) observations into the cumulative register
        file; return the (idx, rank) pairs to ship (risen this sweep,
        or ALL occupied on a refresh sweep)."""
        if len(idx):
            np.maximum.at(regs, idx, rank.astype(regs.dtype))
            if not refresh:
                # registers whose cumulative value ROSE this sweep:
                # ship the new max (dedup per register via unique)
                u = np.unique(idx)
                prev = self._prev_regs
                rose = u[regs[u] > prev[u]]
                return rose, regs[rose]
        if refresh:
            occ = np.nonzero(regs)[0]
            return occ, regs[occ]
        return np.empty(0, np.int64), np.empty(0, np.uint8)

    # --------------------------------------------------------------- fold
    def fold_sweep(self, conn_recs: np.ndarray,
                   resp_recs: np.ndarray) -> np.ndarray:
        """One sweep's raw records → DELTA_DT records (possibly empty).

        Multi-host record arrays are supported (the fleet-harness sim):
        every family groups by the record's own host_id, so sharded
        servers route each row to the shard that owns its host."""
        self._sweeps += 1
        refresh = bool(self.hll_refresh_every
                       and self._sweeps % self.hll_refresh_every == 1
                       and self._sweeps > 1)
        nc = 0 if conn_recs is None else len(conn_recs)
        nr = 0 if resp_recs is None else len(resp_recs)
        self.stats["records_in"] += nc + nr
        rows: list = []
        if nc:
            cb = decode.conn_batch(conn_recs, size=nc)
            self._fold_conn(cb, conn_recs["host_id"], rows, refresh)
        if nr:
            self._fold_resp(resp_recs, rows)
        if not rows:
            return np.empty(0, wire.DELTA_DT)
        out = np.concatenate(rows)
        self.stats["delta_records"] += len(out)
        return out

    def _fold_conn(self, cb, rec_host, rows, refresh: bool):
        valid = cb.valid
        acc = valid & cb.is_accept
        svc64 = _key64(cb.svc_hi, cb.svc_lo)
        flow64 = _key64(cb.flow_hi, cb.flow_lo)
        hosts = rec_host.astype(np.uint32)
        tot_bytes = cb.bytes_sent + cb.bytes_rcvd
        for h in np.unique(hosts):
            hm = hosts == h
            a = acc & hm
            v = valid & hm
            # ---- per-svc exact counters (the raw ctr_win fold)
            if a.any():
                uk, inv = np.unique(svc64[a], return_inverse=True)
                ctr = np.zeros((len(uk), 6), np.float64)
                np.add.at(ctr[:, 0], inv, cb.bytes_sent[a])
                np.add.at(ctr[:, 1], inv, cb.bytes_rcvd[a])
                np.add.at(ctr[:, 2], inv, cb.is_close[a].astype(float))
                np.add.at(ctr[:, 3], inv, cb.duration_us[a])
                np.add.at(ctr[:, 4], inv, 1.0)
                r = self._rows(len(uk))
                r["kind"] = wire.DK_SVC_CTR
                r["key_hi"] = (uk >> np.uint64(32)).astype(np.uint32)
                r["key_lo"] = uk.astype(np.uint32)
                r["nitem"] = 6
                r["host_id"] = h
                pv = r["payload"][:, :24].view("<f4")
                pv[:, :6] = ctr.astype(np.float32)
                rows.append(r)
                for k, c in zip(uk.tolist(), ctr):
                    t = self.totals.setdefault(
                        int(k), np.zeros(6, np.float64))
                    t += c
                # ---- per-svc distinct-client HLL (incremental maxes)
                ci, cr = hll._idx_rank(cb.cli_hi[a], cb.cli_lo[a],
                                       self.p_svc)
                for j, k in enumerate(uk.tolist()):
                    m = inv == j
                    regs = self._svc_regs.get((int(h), k))
                    if regs is None:
                        regs = np.zeros(1 << self.p_svc, np.uint8)
                        self._svc_regs[(int(h), k)] = regs
                    self._prev_regs = regs.copy()
                    idx, rank = self._hll_delta(regs, ci[m], cr[m],
                                                refresh)
                    if len(idx):
                        self._pack_pairs(rows, wire.DK_SVC_HLL,
                                         np.uint64(k), h, idx,
                                         rank.astype(np.float32))
            # ---- global flow HLL over every valid lane
            if v.any():
                gi, gr = hll._idx_rank(cb.flow_hi[v], cb.flow_lo[v],
                                       self.p_glob)
                regs = self._glob_regs.get(int(h))
                if regs is None:
                    regs = np.zeros(1 << self.p_glob, np.uint8)
                    self._glob_regs[int(h)] = regs
                self._prev_regs = regs.copy()
                idx, rank = self._hll_delta(regs, gi, gr, refresh)
                if len(idx):
                    self._pack_pairs(rows, wire.DK_GLOB_HLL,
                                     np.uint64(0), h, idx,
                                     rank.astype(np.float32))
            # ---- flow aggregates: heaviest flow_max ship, rest is a
            # counted residual bound (accept side only — the additive
            # CMS/top-K fold accept-observed lanes only, like the raw
            # fold; see engine/step.py:ingest_conn)
            if a.any():
                fu, finv = np.unique(flow64[a], return_inverse=True)
                fsum = np.zeros(len(fu), np.float64)
                np.add.at(fsum, finv, tot_bytes[a])
                order = np.argsort(-fsum, kind="stable")
                keep = order[: self.flow_max]
                resid = float(fsum[order[self.flow_max:]].sum()) \
                    if len(order) > self.flow_max else 0.0
                F = wire.DELTA_FLOWS
                kf, vf = fu[keep], fsum[keep]
                nrows = -(-len(kf) // F)
                r = self._rows(nrows)
                r["kind"] = wire.DK_FLOW
                r["host_id"] = h
                for i in range(nrows):
                    sl = slice(i * F, min((i + 1) * F, len(kf)))
                    n = sl.stop - sl.start
                    r[i]["nitem"] = n
                    pv = r[i]["payload"][: n * 12].view(
                        wire.DELTA_FLOW_DT)
                    pv["hi"] = (kf[sl] >> np.uint64(32)).astype(
                        np.uint32)
                    pv["lo"] = kf[sl].astype(np.uint32)
                    pv["val"] = vf[sl].astype(np.float32)
                rows.append(r)
                if resid > 0:
                    rr = self._rows(1)
                    rr["kind"] = wire.DK_RESID
                    rr["errb"] = np.float32(resid)
                    rr["host_id"] = h
                    rows.append(rr)
                    self.stats["resid_bytes"] += resid
            # ---- dependency edges (both-sides-known lanes, the
            # direct-edge path of depgraph.halves_from_conn; one-sided
            # halves cannot be locally resolved and are counted)
            cli_hi = np.where(cb.cli_rel_hi[hm] | cb.cli_rel_lo[hm],
                              cb.cli_rel_hi[hm], cb.cli_task_hi[hm])
            cli_lo = np.where(cb.cli_rel_hi[hm] | cb.cli_rel_lo[hm],
                              cb.cli_rel_lo[hm], cb.cli_task_lo[hm])
            cli_svc = (cb.cli_rel_hi[hm] | cb.cli_rel_lo[hm]) != 0
            know_cli = (cli_hi | cli_lo) != 0
            know_ser = (cb.svc_hi[hm] | cb.svc_lo[hm]) != 0
            vm = valid[hm]
            both = vm & know_cli & know_ser
            self.stats["onesided_skipped"] += int(
                (vm & (know_cli ^ know_ser)).sum())
            if both.any():
                c64 = _key64(cli_hi, cli_lo)[both]
                s64 = svc64[hm][both]
                csvc = cli_svc[both]
                eb = tot_bytes[hm][both]
                comp = np.stack([c64, s64,
                                 csvc.astype(np.uint64)], axis=1)
                ue, einv = np.unique(comp, axis=0,
                                     return_inverse=True)
                nconn = np.zeros(len(ue), np.float64)
                bsum = np.zeros(len(ue), np.float64)
                np.add.at(nconn, einv, 1.0)
                np.add.at(bsum, einv, eb)
                r = self._rows(len(ue))
                r["kind"] = wire.DK_DEP
                r["key_hi"] = (ue[:, 1] >> np.uint64(32)).astype(
                    np.uint32)
                r["key_lo"] = ue[:, 1].astype(np.uint32)
                r["aux_hi"] = (ue[:, 0] >> np.uint64(32)).astype(
                    np.uint32)
                r["aux_lo"] = ue[:, 0].astype(np.uint32)
                r["flags"] = ue[:, 2].astype(np.uint8)
                r["nitem"] = 2
                r["host_id"] = h
                pv = r["payload"][:, :8].view("<f4")
                pv[:, 0] = nconn.astype(np.float32)
                pv[:, 1] = bsum.astype(np.float32)
                rows.append(r)

    def _fold_resp(self, resp, rows):
        hosts = resp["host_id"].astype(np.uint32)
        gid = resp["glob_id"]
        vals = resp["resp_usec"].astype(np.float32)
        bucket = loghist.bucket_of(self.resp_spec, vals)
        for h in np.unique(hosts):
            hm = hosts == h
            uk, inv = np.unique(gid[hm], return_inverse=True)
            # ---- resp-count column of the per-svc counters
            cnt = np.zeros(len(uk), np.float64)
            np.add.at(cnt, inv, 1.0)
            r = self._rows(len(uk))
            r["kind"] = wire.DK_SVC_CTR
            r["key_hi"] = (uk >> np.uint64(32)).astype(np.uint32)
            r["key_lo"] = uk.astype(np.uint32)
            r["nitem"] = 6
            r["host_id"] = h
            pv = r["payload"][:, :24].view("<f4")
            pv[:, 5] = cnt.astype(np.float32)
            rows.append(r)
            for k, c in zip(uk.tolist(), cnt):
                t = self.totals.setdefault(int(k),
                                           np.zeros(6, np.float64))
                t[5] += c
            # ---- per-svc loghist bucket counts (exact)
            comp = inv.astype(np.int64) * self.resp_spec.nbuckets \
                + bucket[hm]
            uc, cinv = np.unique(comp, return_inverse=True)
            w = np.zeros(len(uc), np.float64)
            np.add.at(w, cinv, 1.0)
            for j in range(len(uk)):
                m = (uc // self.resp_spec.nbuckets) == j
                if m.any():
                    self._pack_pairs(
                        rows, wire.DK_SVC_HIST, np.uint64(uk[j]), h,
                        (uc[m] % self.resp_spec.nbuckets),
                        w[m].astype(np.float32))
            # ---- digest duty-cycle: the strided subsample the raw
            # fold would have staged (1-in-N of arrival order)
            sub = np.nonzero(hm)[0][:: self.td_stride]
            if len(sub):
                sgid = gid[sub]
                svals = vals[sub]
                su = np.unique(sgid)
                S = wire.DELTA_SAMPLES
                for k in su.tolist():
                    sv = svals[sgid == k]
                    for off in range(0, len(sv), S):
                        n = min(S, len(sv) - off)
                        rr = self._rows(1)
                        rr["kind"] = wire.DK_SVC_TD
                        rr["key_hi"] = np.uint32(k >> 32)
                        rr["key_lo"] = np.uint32(k & 0xFFFFFFFF)
                        rr["nitem"] = n
                        rr["host_id"] = h
                        pv = rr["payload"].reshape(-1)[: n * 4].view(
                            "<f4")
                        pv[:] = sv[off: off + n]
                        rows.append(rr)
