"""The port's exact (numpy) oracles against the reference's.

``sketch/exact.py`` is the ground truth the sketch tests and
``chip_smoke.py``'s request-trace phase hold the device against: the
same keys and values give the same distinct count, quantiles, key
totals and top-K in both packages, and ``StreamTopK.add_conn_batch``
folds the port's numpy conn columns as the reference's folds its own.
"""

import numpy as np
import pytest

from gyeeta_tpu.ingest import decode as j_dec
from gyeeta_tpu.sketch import exact as j_ex
from gyeeta_tpu_torch.ingest import decode as t_dec
from gyeeta_tpu_torch.sim import ParthaSim
from gyeeta_tpu_torch.sketch import exact as t_ex


def _draw(seed, n=4000, nkeys=300):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, nkeys, n).astype(np.uint32)
    v = rng.lognormal(3.0, 1.5, n)
    return hi, lo, v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distinct_quantiles_totals_topk(seed):
    hi, lo, v = _draw(seed)
    assert t_ex.distinct(hi, lo) == j_ex.distinct(hi, lo)
    qs = [0.5, 0.95, 0.99]
    np.testing.assert_array_equal(t_ex.quantiles(v, qs),
                                  j_ex.quantiles(v, qs))
    assert t_ex.key_totals(hi, lo, v) == j_ex.key_totals(hi, lo, v)
    assert t_ex.topk(hi, lo, v, 17) == j_ex.topk(hi, lo, v, 17)


def test_stream_topk_batches_and_masks():
    j, t = j_ex.StreamTopK(), t_ex.StreamTopK()
    for seed in range(4):
        hi, lo, v = _draw(seed, n=1000)
        mask = np.random.default_rng(seed + 10).random(len(v)) < 0.7
        for s in (j, t):
            s.add(hi, lo, v, mask=mask if seed % 2 else None)
    assert dict(t.acc) == dict(j.acc)
    assert t.total() == j.total() and len(t) == len(j)
    assert t.topk(25) == j.topk(25) and t.topk_hex(25) == j.topk_hex(25)


def test_add_conn_batch_over_numpy_conn_columns():
    """The port's ``decode.conn_batch`` numpy columns, folded as the
    engine folds them (accept-observed lanes, bytes both ways), equal
    the reference's fold of its own columns of the same records."""
    sim = ParthaSim(n_hosts=8, n_svcs=4, n_clients=256, seed=5)
    j, t = j_ex.StreamTopK(), t_ex.StreamTopK()
    for _ in range(3):
        recs = sim.conn_records(300)
        t.add_conn_batch(t_dec.conn_batch(recs, 512))
        j.add_conn_batch(j_dec.conn_batch(recs, 512))
    assert len(t) > 0 and dict(t.acc) == dict(j.acc)
    assert t.topk(10) == j.topk(10)
