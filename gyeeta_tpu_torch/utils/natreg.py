"""VIP / NAT-IP cluster registry — the ``svcipclust`` backing store.

The reference's shyama groups listeners that are reached through a
shared NAT/virtual IP into load-balancer clusters
(``check_svc_nat_ip_clusters``, ``server/gy_shconnhdlr.h:1301``;
``SvcNatIPOne`` entities, ``server/gy_shsocket.h:98``): two services
observed behind the same DNAT tuple are replicas behind one VIP.

Here the signal is extracted host-side from the raw TCP_CONN records as
they stream through ``feed`` (the nat_ser tuple is pre-device data the
engine's flow key folds away): each (vip, service) observation bumps a
bounded map with sweep-based ageing, and ``columns()`` renders one row
per pairing with the VIP's member count — the queryable cluster view.

A copy of ``gyeeta_tpu/utils/natreg.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils.svcreg import format_ip


class NatClusterRegistry:
    """(vip_key → {svc_glob_id: last_sweep}); vip_key packs the folded
    DNAT address and port."""

    def __init__(self, max_vips: int = 4096, max_age: int = 720):
        self._vips: dict[tuple, dict[int, int]] = {}
        self._vip_disp: dict[tuple, str] = {}
        # split-half resolution: backend tuple → (vip_key, last_sweep),
        # learned from client halves whose callee id is still unknown
        self._pending: dict[tuple, tuple] = {}
        self._version = 0           # bumped ONLY on membership change
        self._sweep = 0
        self.max_vips = max_vips
        self.max_age = max_age      # sweeps (ticks) without observation
        self._cache = None

    def observe_conns(self, recs: np.ndarray) -> int:
        """Fold raw TCP_CONN records. A DNAT-translated row
        (nat_ser set) dialed a VIP — the ORIGINAL ``ser`` address:

        - locally-resolved rows (ser_glob_id known) register
          (vip → backend) directly;
        - cross-host client halves (ser_glob_id == 0) remember
          (backend tuple → vip); the backend's own accept half, whose
          ``ser`` IS that tuple, later resolves the backend id — the
          host-side miniature of the pairing join.

        Work is bounded by DISTINCT (tuple, svc) pairs per chunk, not
        traffic volume (np.unique pre-dedup): VIP-heavy fleets translate
        nearly every connection."""
        nat = recs["nat_ser"]["ip"].any(axis=1)
        known = recs["ser_glob_id"] != 0
        n = 0

        def uniq(rows, with_nat):
            cols = [recs["ser"]["ip"][rows].reshape(len(rows), -1),
                    recs["ser"]["port"][rows, None].astype(np.uint32),
                    recs["ser_glob_id"][rows, None].astype(np.uint64)]
            if with_nat:
                cols.append(
                    recs["nat_ser"]["ip"][rows].reshape(len(rows), -1))
                cols.append(recs["nat_ser"]["port"][rows, None]
                            .astype(np.uint32))
            packed = np.concatenate(
                [np.ascontiguousarray(c).view(np.uint8).reshape(
                    len(rows), -1) for c in cols], axis=1)
            return rows[np.unique(packed, axis=0, return_index=True)[1]]

        # direct registrations (merged records)
        rows = np.nonzero(nat & known)[0]
        for i in uniq(rows, False) if len(rows) else ():
            n += self._register(
                (recs["ser"]["ip"][i].tobytes(),
                 int(recs["ser"]["port"][i])),
                recs["ser"]["ip"][i], int(recs["ser"]["port"][i]),
                int(recs["ser_glob_id"][i]))
        # client halves: learn backend-tuple → vip
        rows = np.nonzero(nat & ~known)[0]
        for i in uniq(rows, True) if len(rows) else ():
            bkey = (recs["nat_ser"]["ip"][i].tobytes(),
                    int(recs["nat_ser"]["port"][i]))
            vkey = (recs["ser"]["ip"][i].tobytes(),
                    int(recs["ser"]["port"][i]))
            if len(self._pending) < 4 * self.max_vips:
                self._pending[bkey] = (
                    vkey, recs["ser"]["ip"][i].copy(),
                    int(recs["ser"]["port"][i]), self._sweep)
        # accept halves resolve pending vips by their own ser tuple
        if self._pending:
            rows = np.nonzero(known)[0]
            for i in uniq(rows, False) if len(rows) else ():
                bkey = (recs["ser"]["ip"][i].tobytes(),
                        int(recs["ser"]["port"][i]))
                hit = self._pending.get(bkey)
                if hit is not None:
                    vkey, vip_ip, vip_port, _ = hit
                    n += self._register(vkey, vip_ip, vip_port,
                                        int(recs["ser_glob_id"][i]))
        return n

    def _register(self, key, ip16, port: int, svc: int) -> int:
        ent = self._vips.get(key)
        if ent is None:
            if len(self._vips) >= self.max_vips:
                return 0
            ent = self._vips[key] = {}
            self._vip_disp[key] = f"{format_ip(ip16)}:{port}"
        if svc not in ent:
            self._version += 1      # refreshes don't invalidate caches
        ent[svc] = self._sweep
        return 1

    def age(self) -> int:
        """Advance the sweep clock; drop members (and empty VIPs) not
        observed within ``max_age`` sweeps; expire unresolved pending
        halves fast (they resolve within a sweep or never)."""
        self._sweep += 1
        dropped = 0
        for key in list(self._vips):
            ent = self._vips[key]
            for svc in [s for s, t in ent.items()
                        if self._sweep - t > self.max_age]:
                del ent[svc]
                dropped += 1
            if not ent:
                del self._vips[key]
                self._vip_disp.pop(key, None)
        for key in [k for k, v in self._pending.items()
                    if self._sweep - v[3] > 2]:
            del self._pending[key]
        if dropped:
            self._version += 1
        return dropped

    def __len__(self) -> int:
        return len(self._vips)

    def columns(self, names=None):
        """One row per (vip, service) pairing; nsvc = replicas behind
        the VIP (rows with nsvc > 1 are the actual clusters)."""
        ver = (getattr(names, "version", None), self._version)
        if self._cache is not None and self._cache[0] == ver:
            return self._cache[1]
        vips, svcids, svcnames, nsvc = [], [], [], []
        for key in sorted(self._vips):
            ent = self._vips[key]
            disp = self._vip_disp[key]
            for svc in sorted(ent):
                vips.append(disp)
                svcids.append(format(svc, "016x"))
                if names is not None:
                    nm = names.lookup(wire.NAME_KIND_SVC, svc)
                    svcnames.append(nm if nm is not None
                                    else format(svc, "016x"))
                else:
                    svcnames.append(format(svc, "016x"))
                nsvc.append(float(len(ent)))
        n = len(vips)

        def obj(vals):
            out = np.empty(n, object)
            out[:] = vals
            return out

        cols = {"vip": obj(vips), "svcid": obj(svcids),
                "svcname": obj(svcnames),
                "nsvc": np.array(nsvc, np.float64)}
        out = (cols, np.ones(n, bool))
        self._cache = (ver, out)
        return out
