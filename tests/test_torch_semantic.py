"""The port's classifiers against the reference's on the same inputs:
``cpumem.classify_cpu`` / ``classify_mem``, ``svcstate.classify``,
``hoststate.classify_hosts`` / ``cluster_state`` and ``loghist.mean``.

Inputs are drawn around every rule's threshold, so most rules of each
cascade decide some rows. States and issue sources are integers and must
be equal; ``issue_frac`` and the loghist mean are f32 (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyeeta_tpu.ingest import decode as j_dec
from gyeeta_tpu.semantic import cpumem as j_cm, hoststate as j_hs, \
    svcstate as j_ss
from gyeeta_tpu.sketch import loghist as j_lh
from gyeeta_tpu_torch.semantic import cpumem as t_cm, hoststate as t_hs, \
    svcstate as t_ss
from gyeeta_tpu_torch.sketch import loghist as t_lh

torch.set_num_threads(1)
N = 4096


def _cm_vals(seed):
    """(N, NCM) gauges spread across every cpu/mem threshold."""
    rng = np.random.default_rng(seed)
    v = np.zeros((N, j_dec.NCM), np.float32)
    pick = lambda *xs: rng.choice(np.asarray(xs, np.float32), N)  # noqa: E731
    v[:, j_dec.CM_CPU_PCT] = pick(5, 9.99, 10, 50, 70, 89.9, 90, 97.9, 98, 99)
    v[:, j_dec.CM_MAX_CORE_CPU_PCT] = pick(10, 94.9, 95, 100)
    v[:, j_dec.CM_IOWAIT_PCT] = pick(0, 24.9, 25, 49, 50, 70)
    v[:, j_dec.CM_NCPUS] = pick(0, 1, 4, 16)
    v[:, j_dec.CM_CS_SEC] = pick(0, 1e5, 4e5, 2e6)
    v[:, j_dec.CM_FORKS_SEC] = pick(0, 299, 300)
    v[:, j_dec.CM_PROCS_RUNNING] = pick(0, 4, 16, 64)
    v[:, j_dec.CM_RSS_PCT] = pick(10, 74.9, 75, 89.9, 90, 99)
    v[:, j_dec.CM_COMMIT_PCT] = pick(10, 94.9, 95)
    v[:, j_dec.CM_SWAP_FREE_PCT] = pick(1, 5, 5.1, 90)
    v[:, j_dec.CM_SWAP_INOUT_SEC] = pick(0, 1, 99, 100)
    v[:, j_dec.CM_PG_INOUT_SEC] = pick(0, 9999, 10000)
    v[:, j_dec.CM_ALLOCSTALL_SEC] = pick(0, 49, 50)
    v[:, j_dec.CM_OOM_KILLS] = rng.choice(np.float32([0, 0, 0, 1]), N)
    return v


@pytest.mark.parametrize("dim", ["cpu", "mem"])
def test_classify_cpu_mem_match_reference(dim):
    v = _cm_vals(1)
    j_fn = getattr(j_cm, f"classify_{dim}")
    t_fn = getattr(t_cm, f"classify_{dim}")
    js, ji = (np.asarray(x) for x in j_fn(jnp.asarray(v)))
    ts, ti = (x.numpy() for x in t_fn(torch.from_numpy(v)))
    assert ts.dtype == js.dtype == np.int32
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    assert len(np.unique(ji)) >= 5 and len(np.unique(js)) >= 4


def _svc_signals(mod, xp, seed):
    """Random SvcSignals whose comparisons land on both sides (and on
    the boundary) of each rule."""
    rng = np.random.default_rng(seed)
    f = lambda *xs: rng.choice(np.asarray(xs, np.float32), N)  # noqa: E731
    b = lambda: rng.integers(0, 12, N).astype(np.int32)       # noqa: E731
    flag = lambda p=0.5: rng.random(N) < p                     # noqa: E731
    cols = dict(
        b5=b(), b300=b(), b5day=b(),
        r5p95=f(100, 500, 1000, 5000), r5p99=f(200, 1000, 9000),
        r5dayp95=f(100, 500, 1000, 5000), r5dayp99=f(200, 1000, 9000),
        mean5=f(0, 80, 100, 120, 121, 300), mean5day=f(0, 100, 150),
        nqrys_5s=f(0, 5, 10, 40, 100), curr_qps=f(0, 1, 10, 20, 40),
        qps_p95=f(0, 5, 10, 30), qps_p25=f(0, 1, 10, 20),
        curr_active=f(0, 2, 5, 11, 30), active_p95=f(0, 3, 9, 20),
        active_p25=f(0, 2, 5), nconn=f(0, 3, 10),
        ser_errors=f(0, 0, 1, 3, 20, 60),
        task_issue=flag(0.3), task_severe=flag(0.3), task_delay=flag(0.3),
        ntasks_issue=f(0, 0, 1, 3), ntasks_noissue=f(0, 1, 4),
        tasks_delay_msec=f(0, 10, 1000, 3000), total_resp_msec=f(0, 100,
                                                                 8000),
        cpu_issue=flag(0.2), mem_issue=flag(0.2),
        high_resp_ticks=rng.integers(0, 9, N).astype(np.int32))
    return mod.SvcSignals(**{k: xp(v) for k, v in cols.items()}, b_1ms=3)


def test_svcstate_classify_matches_reference():
    js, ji = j_ss.classify(_svc_signals(j_ss, jnp.asarray, 7))
    ts, ti = t_ss.classify(_svc_signals(t_ss, torch.from_numpy, 7))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert len(np.unique(np.asarray(js))) == 5
    assert len(np.unique(np.asarray(ji))) == 5


def _host_counts(seed):
    rng = np.random.default_rng(seed)
    c = lambda: rng.choice(np.int32([0, 0, 1, 2, 3, 6]), N)   # noqa: E731
    flag = lambda: rng.random(N) < 0.3                        # noqa: E731
    return (c(), c(), c(), c(), flag(), flag(), flag(), flag(), flag())


@pytest.mark.parametrize("with_idle", [False, True], ids=["no_idle", "idle"])
def test_classify_hosts_and_cluster_state_match(with_idle):
    args = _host_counts(3)
    if not with_idle:
        args = args[:-1]
    js = j_hs.classify_hosts(*(jnp.asarray(a) for a in args))
    ts = t_hs.classify_hosts(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert len(np.unique(np.asarray(js))) >= 4
    valid = np.random.default_rng(4).random(N) < 0.9
    for v in (None, valid):
        jc = j_hs.cluster_state(js, None if v is None else jnp.asarray(v))
        tc = t_hs.cluster_state(ts, None if v is None else
                                torch.from_numpy(v))
        assert jc.keys() == tc.keys()
        for k in jc:
            if k == "issue_frac":
                np.testing.assert_allclose(float(tc[k]), float(jc[k]),
                                           rtol=1e-6)
            else:
                assert int(tc[k]) == int(jc[k]), k


def test_loghist_mean_matches_reference():
    spec_j = j_lh.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64)
    spec_t = t_lh.LogHistSpec(vmin=1.0, vmax=1e8, nbuckets=64)
    rng = np.random.default_rng(5)
    h = rng.poisson(0.5, (256, 64)).astype(np.float32)
    h[:8] = 0.0                                  # empty rows read 0
    want = np.asarray(j_lh.mean(jnp.asarray(h), spec_j))
    got = t_lh.mean(torch.from_numpy(h), spec_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:8] == 0).all()
