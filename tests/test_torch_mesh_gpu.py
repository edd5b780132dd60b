"""The sharded runtime on the card against its CPU run (``gpu`` tests).

No JAX here: this module runs on the GPU machine
(``python -m pytest --noconftest -m gpu tests/test_torch_mesh_gpu.py``)
and skips elsewhere. A 4-shard ``ShardedRuntime`` on ``cuda`` and one
on the CPU are fed the same bytes — the parity stream of
``tests/test_shardfeed.py`` with split conn halves (so they pair across
shards) and request traces, two ticks and a slab-filling buffer. Held:
every shard's 85 state and 29 dependency leaves (integer, bool, u32 and
max-merged leaves exact; f32 sums rtol 1e-6, as the card's atomics add
in no fixed order; digests rtol 1e-5; ``flow_topk.evicted`` by the mass
rule of ROADMAP.md §3), the fleet rollup, and the launches: each slab
dispatch launches every fused sketch kernel once a shard.
"""

import numpy as np
import pytest
import torch

from gyeeta_tpu_torch.engine import aggstate
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.parallel import depgraph, sharded
from gyeeta_tpu_torch.parallel.mesh import make_mesh
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
from gyeeta_tpu_torch.sim import ParthaSim
from gyeeta_tpu_torch.sketch import countmin, hyperloglog, invertible
from gyeeta_tpu_torch.utils.config import RuntimeOpts
from gyeeta_tpu_torch.utils.tensor import tree_paths

GEOM = dict(n_hosts=16, svc_capacity=256, task_capacity=256,
            conn_batch=256, resp_batch=512, listener_batch=64, fold_k=2)
OPTS = dict(dep_pair_capacity=4096, dep_edge_capacity=4096)
PATHS = (tree_paths(aggstate.init(EngineCfg(**GEOM), "meta"))
         + tree_paths(depgraph.init(1, 1, "meta")))
_EVICTED = PATHS.index("flow_topk.evicted")
_COUNTS = PATHS.index("flow_topk.counts")


def _stream():
    sim = ParthaSim(n_hosts=16, n_svcs=2, n_clients=24, seed=77)
    bufs = [sim.name_frames()]
    for _ in range(2):
        cli, ser = sim.svc_conn_records(200, split_halves=True)
        bufs.append(sim.conn_frames(256) + sim.resp_frames(512)
                    + sim.listener_frames() + sim.task_frames()
                    + wire.encode_frame(wire.NOTIFY_HOST_STATE,
                                        sim.host_state_records())
                    + wire.encode_frame(wire.NOTIFY_TCP_CONN, cli)
                    + sim.trace_frames(60)
                    + wire.encode_frame(wire.NOTIFY_TCP_CONN, ser))
    return bufs, sim.conn_frames(2400) + sim.resp_frames(600)


def _run(device):
    rt = ShardedRuntime(EngineCfg(**GEOM), make_mesh(4, device=device),
                        RuntimeOpts(**OPTS), clock=lambda: 1.7e9)
    bufs, post = _stream()
    for i, buf in enumerate(bufs):
        rt.feed(buf)
        if i:
            rt.run_tick()
    for mod in (countmin, hyperloglog, invertible):
        mod.launches = 0
    before = rt.stats.counters.get("slab_dispatches", 0)
    rt.feed(post)
    slabs = rt.stats.counters.get("slab_dispatches", 0) - before
    launches = (hyperloglog.launches, invertible.launches,
                countmin.launches)
    rt.flush()
    leaves = sharded.state_to_numpy(rt.state) \
        + sharded.dep_to_numpy(rt.dep)
    ru = rt.rollup_stats()
    rt.close()
    return leaves, ru, slabs, launches


@pytest.mark.gpu
def test_mesh_on_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    got, ru_g, slabs, launches = _run("cuda")
    want, ru_w, _, _ = _run("cpu")
    assert slabs >= 1
    # a slab dispatch: HLL ×2, inv ×1, CMS ×1 on each of the 4 shards
    assert launches == (8 * slabs, 4 * slabs, 4 * slabs)
    for i, (p, a, b) in enumerate(zip(PATHS, want, got)):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        if i == _EVICTED:
            mass = a + want[_COUNTS].sum(axis=1)
            assert (np.abs(b - a) <= 1e-5 * mass).all(), p
        elif a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=p)
        else:
            rtol = 1e-5 if p.startswith("svc_td") else 1e-6
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=p)
    assert ru_g.keys() == ru_w.keys()
    for k in ru_w:
        assert ru_g[k] == pytest.approx(ru_w[k], rel=1e-6), k
