"""The port's query executor against the reference's: admission and shedding.

Both executors get the same saturating burst: a pool of one worker, one
query holding it (its render waits on an event), then the rest submitted
in order. Admission sheds the oldest waiters past ``queue_max`` at submit
time, and the freed worker takes the newest waiter first, so which
queries are served, in what order, and which are shed is fixed by the
burst alone. The port must serve and shed exactly what the reference
does under its default ``lifo`` policy, with the same ``queries_shed``
counters and queue-depth gauge.
"""

import asyncio
import threading

import pytest

from gyeeta_tpu.net import qexec as j_qexec
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch.net import qexec as t_qexec
from gyeeta_tpu_torch.utils.selfstats import Stats as TStats

WAIT_S = 20.0


class _HeldRT:
    """Just enough runtime for an executor: a stats registry and a query
    that blocks until ``release`` is set, recording what it served."""

    def __init__(self, stats):
        self.stats = stats
        self.release = threading.Event()
        self.served: list = []

    def query(self, req):
        assert req["consistency"] == "snapshot"
        assert self.release.wait(WAIT_S)
        self.served.append(req["i"])
        return {"i": req["i"], "snaptick": 0}


async def _burst(mod, stats, n, queue_max, workers=1):
    rt = _HeldRT(stats)
    ex = mod.QueryExecutor(rt, workers=workers, queue_max=queue_max)
    depth = []

    async def one(i):
        try:
            out = await ex.run({"i": i})
            return ("ok", out["i"])
        except mod.Overloaded:
            return ("shed", i)

    try:
        tasks = []
        for i in range(n):
            tasks.append(asyncio.ensure_future(one(i)))
            # each submission reaches the executor before the next
            for _ in range(3):
                await asyncio.sleep(0)
            depth.append(rt.stats.gauges.get("query_queue_depth"))
        rt.release.set()
        outs = await asyncio.wait_for(asyncio.gather(*tasks), WAIT_S)
    finally:
        rt.release.set()
        ex.close()
    return rt, outs, depth


def _both(n, queue_max, workers=1):
    j = asyncio.run(_burst(j_qexec, JStats(), n, queue_max, workers))
    t = asyncio.run(_burst(t_qexec, TStats(), n, queue_max, workers))
    return j, t


@pytest.mark.parametrize("n,queue_max,workers",
                         [(10, 3, 1), (12, 5, 2), (4, 8, 2)])
def test_burst_serves_and_sheds_like_reference(n, queue_max, workers):
    (j_rt, j_outs, j_depth), (t_rt, t_outs, t_depth) = _both(
        n, queue_max, workers)
    assert t_outs == j_outs
    # one worker serves in a fixed order; two render side by side
    if workers == 1:
        assert t_rt.served == j_rt.served
    assert sorted(t_rt.served) == sorted(j_rt.served)
    assert t_depth == j_depth
    shed = [i for kind, i in t_outs if kind == "shed"]
    ok = [i for kind, i in t_outs if kind == "ok"]
    tc = t_rt.stats.counters
    assert tc.get("queries_shed", 0) == len(shed)
    assert tc.get("queries_shed|policy=lifo", 0) == len(shed)
    for k in ("queries_shed", "queries_shed|policy=lifo"):
        assert tc.get(k, 0) == j_rt.stats.counters.get(k, 0)
    if n > queue_max:
        # the newest query is always served; the shed are the oldest
        # waiters
        assert shed and n - 1 in ok and max(shed) < max(ok)
    else:
        assert not shed


def test_close_cancels_waiters_without_hanging():
    async def run():
        rt = _HeldRT(TStats())
        ex = t_qexec.QueryExecutor(rt, workers=1, queue_max=8)
        first = asyncio.ensure_future(ex.run({"i": 0}))
        waiter = asyncio.ensure_future(ex.run({"i": 1}))
        for _ in range(3):
            await asyncio.sleep(0)
        ex.close()
        rt.release.set()
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(waiter, WAIT_S)
        assert (await asyncio.wait_for(first, WAIT_S))["i"] == 0

    asyncio.run(run())
