"""The port's query path against the reference's, over the same run.

Both runtimes come from ``tests/test_torch_runtime.py``'s stream
(:func:`test_torch_runtime.run_both`, run once per process). Held
against the reference, JSON for JSON (strings, ints and bools exact,
floats rtol 1e-6): every subsystem the port serves, and request
variants — filters, sorts, ``maxrecs``, aggregation with group-by, and
projections that load the lazy svcstate groups over just the result
rows. The 43 served subsystems take in those of the host-side
registries and the alert tier. ``shardlist`` raises as the
reference's single runtime raises it (the sharded runtime serves it).
The host
modules the port copies (``criteria``, ``aggr``, ``fieldmaps``) are
held against the reference on filter and aggregation strings over the
same columns, and each device readback returns the reference's dtypes.
"""

import numpy as np
import pytest

from gyeeta_tpu.query import aggr as j_aggr, api as j_api, \
    criteria as j_crit, fieldmaps as j_fm, readback as j_rb
from gyeeta_tpu_torch.query import aggr as t_aggr, api as t_api, \
    criteria as t_crit, fieldmaps as t_fm, readback as t_rb
from test_torch_runtime import SERVED, assert_json_equal, j_cfg, run_both, \
    t_cfg


@pytest.fixture(scope="module")
def runs():
    return run_both()


@pytest.mark.parametrize("subsys", SERVED)
def test_query_json_matches_reference(runs, subsys):
    req = {"subsys": subsys, "maxrecs": 10000}
    ref, got = runs["jr"].query(req), runs["tr"].query(req)
    assert got["nrecs"] > 0
    assert_json_equal(ref, got, subsys)


VARIANTS = {
    "svcstate_filter_sort": {
        "subsys": "svcstate", "maxrecs": 100, "sortcol": "p95resp5s",
        "filter": "( { svcstate.state in 'Good','OK','Bad','Severe' } "
                  "and { svcstate.nconns > 0 } ) or "
                  "{ svcstate.qps5s >= 1 }"},
    "svcstate_aggr_groupby": {
        "subsys": "svcstate", "groupby": ["hostid"],
        "aggr": ["count(*)", "avg(nconns)", "max(p95resp5s) as worst",
                 "sum(qps5s)", "p90(p99resp5s)"], "sortcol": "worst"},
    "svcstate_columns_lazy": {
        "subsys": "svcstate", "maxrecs": 7, "sortcol": "nconns",
        "columns": ["svcid", "svcname", "resp5s", "p95resp5s", "p99resp5s",
                    "p95resp5m", "p50resp5d", "p95resp5d", "nclients",
                    "qps5s", "nqry5s"]},
    "svcstate_filter_lazy_asc": {
        "subsys": "svcstate", "sortcol": "p95resp5d", "sortdesc": False,
        "filter": "{ svcstate.p95resp5d > 0 } and "
                  "{ svcstate.nclients > 1 }", "maxrecs": 9},
    "svcstate_svcname_like": {
        "subsys": "svcstate",
        "filter": "{ svcstate.svcname like 'svc-[12]\\..*' }"},
    "hoststate_columns": {"subsys": "hoststate",
                          "columns": ["hostid", "hostname", "state"]},
    "taskstate_aggr": {"subsys": "taskstate", "groupby": ["hostid"],
                       "aggr": ["count(*)", "sum(cpu)", "max(rssmb)"]},
    "topcpu_filter": {"subsys": "topcpu", "filter": "{ topcpu.cpu > 1 }"},
    "tracereq_filter_sort": {
        "subsys": "tracereq", "filter": "{ tracereq.nreq > 1 }",
        "sortcol": "p99resp", "maxrecs": 20},
    "svcdependency_filter": {
        "subsys": "svcdependency", "filter": "{ svcdependency.nconn > 1 }",
        "sortcol": "bytes"},
    "clientconn_aggr": {"subsys": "clientconn", "groupby": ["clisvc"],
                        "aggr": ["count(*)", "sum(nconn)"]},
    "topk_bytes": {"subsys": "topk", "filter": "{ topk.metric = 'bytes' }",
                   "maxrecs": 12},
    "cpumem_filter": {"subsys": "cpumem",
                      "filter": "{ cpumem.cpustate != 'Good' }"},
    "strong": {"subsys": "svcsumm", "consistency": "strong"},
    "extsvcstate_sort_lazy": {
        "subsys": "extsvcstate", "sortcol": "p95resp5s", "maxrecs": 9,
        "filter": "{ extsvcstate.port > 8001 } and "
                  "{ extsvcstate.qps5s > 0 }"},
    "svcinfo_aggr": {"subsys": "svcinfo", "groupby": ["hostid"],
                     "aggr": ["count(*)", "max(port)"]},
    "procinfo_tagged": {"subsys": "procinfo",
                        "filter": "{ procinfo.tag = 'frontend' }"},
    "cgroupstate_filter": {"subsys": "cgroupstate",
                           "filter": "{ cgroupstate.cpupct > 10 }",
                           "sortcol": "rssmb"},
    "alerts_by_name": {"subsys": "alerts", "groupby": ["alertname"],
                       "aggr": ["count(*)"]},
    "notifymsg_config": {"subsys": "notifymsg",
                         "filter": "{ notifymsg.source = 'config' }"},
    "svcipclust_clusters": {"subsys": "svcipclust",
                            "filter": "{ svcipclust.nsvc > 1 }"},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_query_variant_matches_reference(runs, name):
    req = VARIANTS[name]
    ref, got = runs["jr"].query(dict(req)), runs["tr"].query(dict(req))
    assert got["nrecs"] > 0
    assert_json_equal(ref, got, name)


_UNPORTED = sorted(set(j_fm.FIELDS_OF_SUBSYS) - set(SERVED))


def test_subsystem_split_covers_fieldmaps():
    # a single runtime serves 43; shardlist is the sharded runtime's
    # (tests/test_torch_shardedrt.py), and nothing is left unported
    assert len(j_fm.FIELDS_OF_SUBSYS) == 44 and len(SERVED) == 43
    assert sorted(t_api.SERVED) == sorted(SERVED)
    assert _UNPORTED == ["shardlist"]


@pytest.mark.parametrize("subsys", _UNPORTED)
def test_unported_subsystem_raises(runs, subsys):
    """A single runtime has no shards: it refuses ``shardlist`` as the
    reference's does, on both consistency paths."""
    for req in ({"subsys": subsys},
                {"subsys": subsys, "consistency": "snapshot"}):
        msgs = []
        for rt in (runs["jr"], runs["tr"]):
            with pytest.raises(ValueError) as e:
                rt.query(dict(req))
            assert type(e.value) is ValueError
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0] == f"unknown subsystem {subsys!r}"


def test_unknown_request_errors_match_reference(runs):
    for req in ({"subsys": "nosuch"}, {"subsys": "svcstate", "bogus": 1},
                {"filter": "x"}, {"subsys": "svcstate", "sortcol": "zz"},
                {"subsys": "svcstate", "columns": ["zz"]}):
        with pytest.raises(ValueError):
            runs["jr"].query(dict(req))
        with pytest.raises(ValueError):
            runs["tr"].query(dict(req))


# ------------------------------------------------- copied host modules
FILTERS = (
    "{ svcstate.nconns > 2 }",
    "{ svcstate.state in 'Bad','Severe' }",
    "{ svcstate.state notin 'Idle' } and { svcstate.hostid < 4 }",
    "( { svcstate.p95resp5s > 1 } or { svcstate.qps5s = 0 } )",
    "not { svcstate.svcname substr 'host-1' }",
    "{ svcstate.svcid like '^[0-7]' }",
    "{ svcstate.issue = 'none' } and { svcstate.nclients >= 2 }",
    "{ svcstate.p50resp5d != 0 } or { svcstate.sererr > 10 }",
    "{ svcstate.svcname notsubstr 'svc-0' } and { svcstate.nactive < 50 }",
    "{ svcstate.nqry5s > 0 } and { svcstate.p99resp5s <= 100 }",
)


def _svc_cols(runs):
    ref = j_api.svc_columns(j_cfg(), runs["jr"].state,
                            names=runs["jr"].names)
    got = t_api.svc_columns(t_cfg(), runs["tr"].state,
                            names=runs["tr"].names)
    return ref, got


@pytest.mark.parametrize("flt", FILTERS)
def test_criteria_mask_matches_reference(runs, flt):
    (jc, jl), (tc, tl) = _svc_cols(runs)
    np.testing.assert_array_equal(tl, jl)
    assert repr(t_crit.parse(flt)) == repr(j_crit.parse(flt))
    ref = j_crit.evaluate(j_crit.parse(flt), jc, "svcstate") & jl
    got = t_crit.evaluate(t_crit.parse(flt), tc, "svcstate") & tl
    np.testing.assert_array_equal(got, ref)


AGGRS = (
    (("count(*)", "sum(nconns)"), ("hostid",)),
    (("avg(p95resp5s) as a", "min(qps5s)", "max(nclients)"), ("state",)),
    (("p50(resp5s)", "p99(p95resp5m)"), ()),
    (("count(*)",), ("state", "issue")),
)


@pytest.mark.parametrize("specs,groupby", AGGRS)
def test_aggregation_matches_reference(runs, specs, groupby):
    (jc, jl), (tc, tl) = _svc_cols(runs)
    fm_j, fm_t = j_fm.field_map("svcstate"), t_fm.field_map("svcstate")
    js = [j_aggr.parse_aggr(s, "svcstate") for s in specs]
    ts = [t_aggr.parse_aggr(s, "svcstate") for s in specs]
    assert [tuple(s) for s in ts] == [tuple(s) for s in js]
    idx = np.nonzero(jl)[0]
    ref = j_aggr.aggregate_columns(jc, idx, js, j_aggr.parse_groupby(
        groupby, "svcstate"), fm_j)
    got = t_aggr.aggregate_columns(tc, idx, ts, t_aggr.parse_groupby(
        groupby, "svcstate"), fm_t)
    assert_json_equal(ref, got)


@pytest.mark.parametrize("subsys", sorted(j_fm.FIELDS_OF_SUBSYS))
def test_fieldmap_matches_reference(subsys):
    ref, got = j_fm.FIELDS_OF_SUBSYS[subsys], t_fm.FIELDS_OF_SUBSYS[subsys]
    assert [(f.json, f.col, f.kind, f.desc) for f in got] == \
        [(f.json, f.col, f.kind, f.desc) for f in ref]
    row = {}
    for i, f in enumerate(ref):
        row[f.col] = {"num": 2.5 + i, "bool": i % 2 == 0,
                      "enum": i % 3}.get(f.kind, f"s{i}")
    assert t_fm.row_to_json(subsys, row) == j_fm.row_to_json(subsys, row)
    for f in (f for f in ref if f.kind == "enum"):
        g = t_fm.field_map(subsys)[f.json]
        for v in range(-1, 9):
            assert g.to_json(v) == f.to_json(v)


# ----------------------------------------------------------- readbacks
_READBACKS = {
    "svcstate_base": lambda rb, cfg, rt: rb.svcstate_base(cfg, rt.state),
    "svcstate_vol": lambda rb, cfg, rt: rb.svcstate_vol(cfg, rt.state),
    "svcstate_cli": lambda rb, cfg, rt: rb.svcstate_cli(cfg, rt.state),
    "svcstate_qlevel_-1": lambda rb, cfg, rt: rb.svcstate_qlevel(
        cfg, rt.state, -1),
    "svcstate_qlevel_0": lambda rb, cfg, rt: rb.svcstate_qlevel(
        cfg, rt.state, 0),
    "svcstate_qlevel_1": lambda rb, cfg, rt: rb.svcstate_qlevel(
        cfg, rt.state, 1),
    "svcstate_snapshot": lambda rb, cfg, rt: rb.svcstate_snapshot(
        cfg, rt.state),
    "host_snapshot": lambda rb, cfg, rt: rb.host_snapshot(cfg, rt.state),
    "task_snapshot": lambda rb, cfg, rt: rb.task_snapshot(cfg, rt.state),
    "trace_snapshot": lambda rb, cfg, rt: rb.trace_snapshot(cfg, rt.state),
    "dep_edges_snapshot": lambda rb, cfg, rt: rb.dep_edges_snapshot(rt.dep),
    "dep_mesh_snapshot": lambda rb, cfg, rt: rb.dep_mesh_snapshot(rt.dep),
}


@pytest.mark.parametrize("name", sorted(_READBACKS))
def test_readback_matches_reference(runs, name):
    """Each readback returns numpy in the reference's dtypes and
    values (u32 back from the int64 carrier)."""
    fn = _READBACKS[name]
    ref = {k: np.asarray(v) for k, v in
           fn(j_rb, j_cfg(), runs["jr"]).items()}
    got = fn(t_rb, t_cfg(), runs["tr"])
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        b = got[k]
        assert isinstance(b, np.ndarray), k
        assert (b.dtype, b.shape) == (a.dtype, a.shape), (k, b.dtype, a.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("level", [-1, 0, 1, 2])
def test_row_sliced_readbacks_match_full(runs, level):
    """The row loaders (a device index tensor, padded) give the rows of
    the full-width readbacks."""
    rt, cfg = runs["tr"], t_cfg()
    idx = np.array([5, 0, 17, 3, 40])
    pidx, n = t_api._pad_idx(idx, cfg.svc_capacity, rt.state.tbl.key_hi
                             .device)
    assert n == 5 and tuple(pidx.shape) == (8,)
    rows = t_rb.svcstate_qlevel_rows(cfg, rt.state, pidx, level)
    full = t_rb.svcstate_qlevel(cfg, rt.state, level)
    for k in full:
        np.testing.assert_array_equal(rows[k][:n], full[k][idx], err_msg=k)
    for f_rows, f_full in ((t_rb.svcstate_vol_rows, t_rb.svcstate_vol),
                           (t_rb.svcstate_cli_rows, t_rb.svcstate_cli)):
        rows, full = f_rows(cfg, rt.state, pidx), f_full(cfg, rt.state)
        for k in full:
            np.testing.assert_array_equal(rows[k][:n], full[k][idx])
