"""Edge pre-aggregation on the host: the port's wire advert, agent-side
fold and delta decode against the reference, byte for byte.

- ``encode_preagg`` / ``decode_preagg`` bytes and dicts equal;
- ``params_of_cfg`` equal to the reference's with ``env={}``;
- ``EdgeFold.fold_sweep``: the record arrays of six sweeps byte-equal,
  with the fold's ``stats`` and ``totals``, over a multi-host sweep, an
  empty sweep, refresh sweeps (``hll_refresh_every=3``) and a truncating
  ``flow_max``; ``ParthaSim.delta_frames`` bytes equal;
- ``loghist.bucket_of`` on numpy equal (the agent's bucket);
- every ``DeltaBatch`` field equal, with the ``preagg_*`` counters,
  including out-of-range payload items and unknown record kinds.

All pure numpy on both sides: nothing here compiles.
"""

import numpy as np
import pytest

import __graft_entry__ as graft
from gyeeta_tpu.engine.aggstate import EngineCfg as JCfg
from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu.sketch import edgefold as j_ef, loghist as j_lh
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.sketch import edgefold as t_ef, loghist as t_lh
from gyeeta_tpu_torch.utils.selfstats import Stats as TStats

N_SWEEPS = 6
# geometry of tests/test_preagg.py:_cfg()
PREAGG_CFG = dict(
    svc_capacity=64, n_hosts=8, hll_p_svc=4, hll_p_global=8, cms_depth=2,
    cms_width=1 << 10, topk_capacity=16, topk_budget=48, td_capacity=16,
    hh_depth=2, hh_width=256, conn_batch=64, resp_batch=128,
    listener_batch=32, fold_k=4)


def cfgs(**over):
    """(reference cfg, port cfg) at the test_preagg geometry."""
    kw = dict(PREAGG_CFG, **over)
    return (JCfg(resp_spec=j_lh.LogHistSpec(1.0, 1e8, 32), **kw),
            TCfg(resp_spec=t_lh.LogHistSpec(1.0, 1e8, 32), **kw))


def _tiny_pair():
    j = graft._tiny_cfg()
    return j, TCfg(**{f: getattr(j, f) for f in j._fields
                      if f not in ("resp_spec", "qps_spec", "active_spec",
                                   "apiresp_spec", "taskcpu_spec",
                                   "levels")},
                   resp_spec=t_lh.LogHistSpec(*j.resp_spec))


# ------------------------------------------------------------ the advert
PARAM_CASES = {
    "preagg": lambda: (cfgs(), {}),
    "tiny": lambda: (_tiny_pair(), {}),
    "default": lambda: ((JCfg(), TCfg()), {}),
    "stride_and_cap": lambda: (cfgs(), dict(td_stride=3, flow_max=5)),
    "zero_stride": lambda: (cfgs(), dict(td_stride=0)),
    "small_topk": lambda: (cfgs(topk_capacity=300), {}),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_params_of_cfg_match_reference(case):
    (jc, tc), kw = PARAM_CASES[case]()
    ref = j_ef.params_of_cfg(jc, env={}, **kw)
    got = t_ef.params_of_cfg(tc, **kw)
    assert got == ref
    assert [type(v) for v in got.values()] == [type(v) for v in ref.values()]


def test_default_params_match_reference():
    assert t_ef.default_params() == j_ef.default_params()


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_preagg_advert_bytes_match_reference(case):
    (jc, tc), kw = PARAM_CASES[case]()
    params = t_ef.params_of_cfg(tc, **kw)
    got, ref = t_wire.encode_preagg(params), j_wire.encode_preagg(params)
    assert got == ref and len(got) == t_wire.PREAGG_DT.itemsize
    assert t_wire.decode_preagg(got) == j_wire.decode_preagg(ref) == params


@pytest.mark.parametrize("buf", [b"", b"\x00" * 8, b"\x00" * 40,
                                 b"\x01" * 40])
def test_foreign_advert_decodes_to_none(buf):
    assert t_wire.decode_preagg(buf) is None
    assert j_wire.decode_preagg(buf) is None


def test_delta_wire_constants_match_reference():
    for name in ("DELTA_PAYLOAD_BYTES", "DELTA_PAIRS", "DELTA_FLOWS",
                 "DELTA_SAMPLES", "DK_SVC_CTR", "DK_SVC_HIST", "DK_SVC_HLL",
                 "DK_GLOB_HLL", "DK_SVC_TD", "DK_FLOW", "DK_DEP", "DK_RESID",
                 "PREAGG_MAGIC"):
        assert getattr(t_wire, name) == getattr(j_wire, name), name
    for name in ("DELTA_DT", "DELTA_PAIR_DT", "DELTA_FLOW_DT", "PREAGG_DT"):
        assert getattr(t_wire, name) == getattr(j_wire, name), name
    assert t_dec.DELTA_LANES_DEFAULT == j_dec.DELTA_LANES_DEFAULT


# --------------------------------------------------------- the agent fold
SWEEP_CASES = {
    # name: (sim kwargs, params overrides, EdgeFold kwargs, per-sweep
    # (n_conn, n_resp))
    "multi_host": (dict(n_hosts=8, n_svcs=4, seed=7), dict(flow_max=64),
                   dict(host_id=0), [(200, 400)] * N_SWEEPS),
    "with_empty": (dict(n_hosts=4, n_svcs=2, seed=3), {}, dict(host_id=2),
                   [(50, 90), (0, 0), (1, 1), (0, 30), (40, 0), (0, 0)]),
    "refresh": (dict(n_hosts=8, n_svcs=4, seed=11), {},
                dict(host_id=0, hll_refresh_every=3),
                [(120, 200)] * N_SWEEPS),
    "truncating": (dict(n_hosts=4, n_svcs=2, seed=19), dict(flow_max=4),
                   dict(host_id=0), [(300, 50)] * N_SWEEPS),
    "td_stride": (dict(n_hosts=5, n_svcs=3, n_clients=64, seed=5,
                       host_base=40), dict(td_stride=3),
                  dict(host_id=40), [(64, 700)] * N_SWEEPS),
}


def _sweeps(case):
    skw, pover, ekw, sizes = SWEEP_CASES[case]
    jc, tc = cfgs()
    jf = j_ef.EdgeFold(j_ef.params_of_cfg(jc, env={}, **pover), **ekw)
    tf = t_ef.EdgeFold(t_ef.params_of_cfg(tc, **pover), **ekw)
    jsim, tsim = JSim(**skw), TSim(**skw)
    for nc, nr in sizes:
        conn, resp = tsim.conn_records(nc), tsim.resp_records(nr)
        jconn, jresp = jsim.conn_records(nc), jsim.resp_records(nr)
        assert conn.tobytes() == jconn.tobytes()
        yield tf.fold_sweep(conn, resp), jf.fold_sweep(jconn, jresp), tf, jf


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_fold_sweep_records_byte_equal(case):
    n_rec = 0
    for got, ref, tf, jf in _sweeps(case):
        assert got.dtype == ref.dtype == t_wire.DELTA_DT
        assert got.tobytes() == ref.tobytes()
        assert tf.stats == jf.stats
        n_rec += len(got)
    assert set(tf.totals) == set(jf.totals)
    for k, v in jf.totals.items():
        np.testing.assert_array_equal(tf.totals[k], v)
    assert n_rec > 0


def test_fold_sweep_cases_reach_every_path():
    """The cases above cover what they are named for."""
    kinds = {}
    for case in SWEEP_CASES:
        kinds[case] = [np.bincount(got["kind"], minlength=9)
                       for got, *_ in _sweeps(case)]
    assert (kinds["multi_host"][0][1:8] > 0).all()
    assert sum(c.sum() for c in kinds["with_empty"][1:2]) == 0
    assert sum(c[t_wire.DK_RESID] for c in kinds["truncating"]) > 0
    # refresh sweeps (4th here) re-ship every occupied register
    hll = [c[t_wire.DK_SVC_HLL] + c[t_wire.DK_GLOB_HLL]
           for c in kinds["refresh"]]
    assert hll[3] > hll[2]
    hosts = np.unique(next(_sweeps("multi_host"))[0]["host_id"])
    assert len(hosts) > 1


@pytest.mark.parametrize("kw", [dict(n_hosts=4, n_svcs=2, seed=3),
                                dict(n_hosts=5, n_svcs=3, seed=9,
                                     host_base=40)])
def test_sim_delta_frames_byte_equal(kw):
    jc, tc = cfgs()
    jsim, tsim = JSim(**kw), TSim(**kw)
    for nc, nr in ((100, 200), (30, 0), (64, 64)):
        assert tsim.delta_frames(nc, nr, t_ef.params_of_cfg(tc)) == \
            jsim.delta_frames(nc, nr, j_ef.params_of_cfg(jc, env={}))


@pytest.mark.parametrize("spec", [(1.0, 1e8, 32), (1.0, 1e8, 64),
                                  (1e-5, 100.0, 512)])
def test_bucket_of_numpy_matches_reference(spec):
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.lognormal(6.0, 3.0, 4000),
                        [0.0, 1.0, spec[0], spec[1], 2 * spec[1], -1.0]])
    for dt in (np.float32, np.float64, np.uint32):
        vals = np.abs(v).astype(dt)
        got = t_lh.bucket_of(t_lh.LogHistSpec(*spec), vals)
        ref = j_lh.bucket_of(j_lh.LogHistSpec(*spec), vals)
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ delta decode
def _delta_recs(kinds, items=((3, 1.0), (4000, 1.0))):
    """Hand-made records of the given kinds, each carrying ``items``
    pairs (or f32 payload) — tests/test_preagg.py's decode inputs."""
    r = np.zeros(len(kinds), t_wire.DELTA_DT)
    r["kind"] = kinds
    r["key_hi"], r["key_lo"] = 1, np.arange(len(kinds)) + 2
    r["aux_hi"], r["aux_lo"] = 7, 8
    r["flags"] = np.arange(len(kinds)) % 2
    r["host_id"] = np.arange(len(kinds)) % 3
    r["errb"] = 0.5
    for i, k in enumerate(kinds):
        if k in (t_wire.DK_SVC_HIST, t_wire.DK_SVC_HLL, t_wire.DK_GLOB_HLL):
            r["nitem"][i] = len(items)
            pv = r["payload"][i][: 6 * len(items)].view(t_wire.DELTA_PAIR_DT)
            pv["idx"] = [a for a, _ in items]
            pv["wt"] = [b for _, b in items]
        elif k == t_wire.DK_FLOW:
            r["nitem"][i] = 3
            pv = r["payload"][i][:36].view(t_wire.DELTA_FLOW_DT)
            pv["hi"], pv["lo"], pv["val"] = [1, 2, 3], [4, 5, 6], [1.5, 2, 3]
        else:
            r["nitem"][i] = {t_wire.DK_SVC_TD: 24,
                             t_wire.DK_DEP: 2}.get(int(k), 6)
            r["payload"][i] = np.arange(96, dtype=np.uint8) % 64
    return r


def _fold_recs():
    _, tc = cfgs()
    sim = TSim(n_hosts=8, n_svcs=4, seed=7)
    ef = t_ef.EdgeFold(t_ef.params_of_cfg(tc, flow_max=4), host_id=0)
    return ef.fold_sweep(sim.conn_records(300), sim.resp_records(500))


DECODE_CASES = {
    "oob_hist": (lambda: _delta_recs([t_wire.DK_SVC_HIST]), 8),
    "oob_hll": (lambda: _delta_recs([t_wire.DK_SVC_HLL, t_wire.DK_GLOB_HLL],
                                    items=((15, 3.0), (16, 2.0),
                                           (255, 1.0), (300, 4.0))), 8),
    "unknown_kind": (lambda: _delta_recs([t_wire.DK_SVC_CTR, 99, 0]), 8),
    "every_kind": (lambda: _delta_recs(list(range(10))), 16),
    "empty": (lambda: np.zeros(0, t_wire.DELTA_DT), 8),
    "sweep": (lambda: _fold_recs()[:256], 256),
    "sweep_tail": (lambda: _fold_recs()[256:], 256),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_delta_batch_fields_and_counters_equal(case):
    make, size = DECODE_CASES[case]
    recs = make()
    assert len(recs) <= size
    dims = dict(resp_nbuckets=32, hll_m_svc=16, hll_m_glob=256)
    ts, js = TStats(), JStats()
    got = t_dec.delta_batch(recs, size, stats=ts, **dims)
    ref = j_dec.delta_batch(recs, size, stats=js, **dims)
    assert got._fields == ref._fields
    for f, a, b in zip(got._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dict(ts.counters) == dict(js.counters)


def test_delta_batch_counts_what_it_drops():
    dims = dict(resp_nbuckets=32, hll_m_svc=16, hll_m_glob=256)
    ts = TStats()
    db = t_dec.delta_batch(_delta_recs([t_wire.DK_SVC_HIST, 99]), 8,
                           stats=ts, **dims)
    assert int(db.hist_valid.sum()) == 1
    assert ts.counters["preagg_oob_items"] == 1
    assert ts.counters["preagg_unknown_kinds"] == 1
    with pytest.raises(ValueError, match="split upstream"):
        t_dec.delta_batch(np.zeros(9, t_wire.DELTA_DT), 8, **dims)
