"""The port's fold-dispatch device trace (``obs/spans.FoldProfiler``).

The counterpart of the reference's ``FoldProfiler`` (a ``jax.profiler``
bracket armed by ``GYT_JAX_PROFILE``): a ``torch.profiler`` session over
the first N fold dispatches of a ``Runtime`` or ``ShardedRuntime``,
armed by explicit arguments (``serve --profile-dir/--profile-folds``).
On the CPU, at a small geometry: inert without a directory; with one,
the Chrome trace holds exactly N ``gyt_fold`` ranges and the session
ends after the N-th fold; ``close()`` writes a bracket short of N; a
session that cannot start raises.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gyeeta_tpu_torch import server_main
from gyeeta_tpu_torch.engine.aggstate import EngineCfg
from gyeeta_tpu_torch.obs.spans import FoldProfiler
from gyeeta_tpu_torch.parallel.mesh import make_mesh
from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
from gyeeta_tpu_torch.runtime import Runtime
from gyeeta_tpu_torch.sim import ParthaSim
from gyeeta_tpu_torch.utils.config import RuntimeOpts

torch.set_num_threads(1)

CFG = EngineCfg(n_hosts=8, svc_capacity=64, task_capacity=64,
                conn_batch=128, resp_batch=256, fold_k=2)
OPTS = RuntimeOpts(dep_pair_capacity=1024, dep_edge_capacity=512)


def _runtime(kind, profiler=None):
    if kind == "sharded":
        return ShardedRuntime(CFG, make_mesh(2, device="cpu"), OPTS,
                              profiler=profiler)
    return Runtime(CFG, OPTS, device="cpu", profiler=profiler)


def _fold(rt, times, seed=1):
    """``times`` rounds of one conn/resp feed and a flush (each round at
    least one fold dispatch)."""
    sim = ParthaSim(n_hosts=8, n_svcs=4, seed=seed)
    rt.feed(sim.name_frames())
    for _ in range(times):
        rt.feed(sim.conn_frames(256) + sim.resp_frames(512))
        rt.flush()


def _fold_ranges(path) -> int:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("name") == "gyt_fold")


@pytest.mark.parametrize("kind", ["runtime", "sharded"])
def test_unarmed_profiler_is_inert(kind, tmp_path):
    rt = _runtime(kind)
    seen = []
    real = rt._profiler.fold

    def spy(device):
        seen.append(torch.autograd._profiler_enabled())
        return real(device)
    rt._profiler.fold = spy
    try:
        _fold(rt, 2)
        assert not rt._profiler.armed and rt._profiler.path is None
        assert len(seen) >= 2 and not any(seen)
        assert rt.stats.counters["fold_dispatches"] >= 2
    finally:
        rt.close()
    assert not torch.autograd._profiler_enabled()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("kind,n", [("runtime", 1), ("runtime", 3),
                                    ("sharded", 2)])
def test_armed_profiler_brackets_exactly_n_folds(kind, n, tmp_path):
    prof = FoldProfiler(tmp_path / "trace", n_folds=n)
    rt = _runtime(kind, prof)
    try:
        assert prof.armed
        _fold(rt, n + 2)
        assert rt.stats.counters["fold_dispatches"] > n
        # the N-th fold ended the session and wrote the trace
        assert not prof.active and not prof.armed
        assert not torch.autograd._profiler_enabled()
        files = list((tmp_path / "trace").iterdir())
        assert [p.name for p in files] == [prof.path.rsplit("/", 1)[1]]
        assert _fold_ranges(prof.path) == n
    finally:
        rt.close()
    assert _fold_ranges(prof.path) == n


def test_close_writes_a_short_bracket(tmp_path):
    prof = FoldProfiler(tmp_path, n_folds=50)
    rt = _runtime("runtime", prof)
    _fold(rt, 2)
    n = rt.stats.counters["fold_dispatches"]
    assert prof.active and prof.path is None and 2 <= n < 50
    rt.close()
    assert not prof.active and not torch.autograd._profiler_enabled()
    assert _fold_ranges(prof.path) == n
    rt.close()                                # idempotent


def test_profiler_that_cannot_start_raises(tmp_path):
    """A second ``torch.profiler`` session in one thread would neither
    raise nor trace: the bracket refuses to start instead."""
    prof = FoldProfiler(tmp_path, n_folds=2)
    other = profile(activities=[ProfilerActivity.CPU])
    other.start()
    try:
        with pytest.raises(RuntimeError, match="another torch.profiler"):
            with prof.fold("cpu"):
                pass
        assert not prof.active and prof.path is None
    finally:
        other.stop()
    with pytest.raises(ValueError, match="n_folds"):
        FoldProfiler(tmp_path, n_folds=0)


@pytest.mark.parametrize("shards", [0, 2])
def test_serve_flags_arm_the_runtime_profiler(shards, tmp_path):
    args = server_main.parse_args(
        ["--device", "cpu", "--shards", str(shards),
         "--profile-dir", str(tmp_path), "--profile-folds", "3"])
    rt = server_main._make_runtime(args, CFG, OPTS)
    try:
        assert isinstance(rt, ShardedRuntime) == (shards > 1)
        assert (rt._profiler.dir, rt._profiler.n_folds) \
            == (str(tmp_path), 3)
    finally:
        rt.close()
    rt = server_main._make_runtime(server_main.parse_args(
        ["--device", "cpu", "--shards", str(shards)]), CFG, OPTS)
    assert rt._profiler.dir is None and not rt._profiler.armed
    rt.close()
