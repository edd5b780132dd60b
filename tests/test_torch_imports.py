"""The port stands alone: no module of ``gyeeta_tpu_torch``, not
``chip_smoke.py`` and not the card's A/B scripts import JAX or anything
of the JAX package, and its entry points refuse to run without a GPU
unless the CPU is asked for."""

import ast
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from gyeeta_tpu_torch.ingest import wire

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gyeeta_tpu_torch").rglob("*.py")) + \
    [ROOT / f for f in ("chip_smoke.py", "feed_ab.py", "scatter_ab.py",
                        "delta_ab.py")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gyeeta_tpu") or top.startswith("jax")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# modules of the edge pre-aggregation and snapshot slice, of the
# registries and alert slice, of the history and journal slice, of the
# serving edge, of the fabric gateway and the remote compaction region,
# of the sharded tier, of its worker processes, of the agent tier and of
# the request-trace capture, each of which the AST check above must cover
SLICE_MODULES = ("sketch/edgefold.py", "query/snapshot.py",
                 "query/normalize.py", "query/crud.py", "obs/prom.py",
                 "obs/spans.py", "utils/selfstats.py", "ingest/decode.py",
                 "engine/step.py", "runtime.py", "utils/svcreg.py",
                 "utils/tagreg.py", "utils/hostreg.py", "utils/natreg.py",
                 "utils/traceconnreg.py", "utils/dnsmap.py",
                 "trace/defs.py", "version.py", "utils/notifylog.py",
                 "utils/droppressure.py", "query/delta.py", "query/cq.py",
                 "alerts/__init__.py", "alerts/defs.py",
                 "alerts/columns.py", "alerts/manager.py",
                 "alerts/deliver.py", "utils/journal.py",
                 "utils/replay.py", "history/__init__.py",
                 "history/store.py", "history/pgstore.py",
                 "history/histwriter.py", "history/shards.py",
                 "history/winquant.py", "history/timeview.py",
                 "history/compactor.py",
                 # the serving edge
                 "ingest/native/__init__.py", "ingest/native/build.py",
                 "ingest/native/abiprobe.py", "ingest/refproto.py",
                 "ingest/refquery.py", "ingest/pipeline.py",
                 "trace/proto.py", "utils/crashguard.py",
                 "utils/config.py", "net/__init__.py", "net/agent.py",
                 "net/qexec.py", "net/subs.py", "net/nmhandle.py",
                 "net/server.py", "net/webgw.py", "server_main.py",
                 "cli.py", "__main__.py",
                 # the fabric gateway and the remote compaction region
                 "net/gateway.py", "net/segship.py",
                 "history/shipper.py",
                 # the sharded tier's single-process mesh
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/partition.py", "parallel/pairing.py",
                 "parallel/sharded.py", "parallel/rollup.py",
                 "parallel/shardedrt.py", "net/shardfeed.py",
                 # the sharded tier's worker processes
                 "utils/shmring.py", "net/ingestproc.py", "net/relay.py",
                 "history/compactproc.py",
                 # the agent tier
                 "utils/ids.py", "utils/cloudmeta.py", "net/collect.py",
                 "net/tcpconn.py", "net/procconn.py", "net/taskdelays.py",
                 "net/taskproc.py", "sim/nodeweb.py", "sim/chaos.py",
                 "obs/__init__.py",
                 # the request-trace capture
                 "trace/__init__.py", "trace/tds.py", "trace/http2.py",
                 "trace/mongo.py", "trace/tls.py", "trace/dnssnoop.py",
                 "trace/pcapfile.py", "trace/livecap.py",
                 "sketch/exact.py")


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_slice_module_is_checked(mod):
    assert ROOT / "gyeeta_tpu_torch" / mod in SOURCES


# the agent tier runs on hosts with no GPU: importing any of its modules,
# or the port's modules it uses, loads no torch (a module-level import;
# the hashing module's tensor paths import torch where they run)
AGENT_MODULES = ("net/agent.py", "utils/ids.py", "utils/cloudmeta.py",
                 "net/collect.py", "net/tcpconn.py", "net/procconn.py",
                 "net/taskdelays.py", "net/taskproc.py", "sim/nodeweb.py",
                 "sim/chaos.py", "obs/__init__.py", "sim/partha.py",
                 "utils/hashing.py", "utils/intern.py", "cli.py",
                 "trace/__init__.py", "trace/proto.py", "trace/tds.py",
                 "trace/http2.py", "trace/mongo.py", "trace/tls.py",
                 "trace/dnssnoop.py", "trace/pcapfile.py",
                 "trace/livecap.py")


@pytest.mark.parametrize("mod", AGENT_MODULES)
def test_agent_module_imports_no_torch(mod):
    body = ast.parse((ROOT / "gyeeta_tpu_torch" / mod).read_text()).body
    names = [a.name for n in body if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in body
                                  if isinstance(n, ast.ImportFrom)
                                  and n.level == 0]
    bad = [n for n in names if n.split(".")[0] == "torch"]
    assert not bad, f"{mod} imports {bad}"


def test_checker_catches_the_prefix():
    assert _forbidden("gyeeta_tpu.engine.step") and _forbidden("jax.numpy")
    assert not _forbidden("gyeeta_tpu_torch.engine.step")


def test_entry_points_raise_without_gpu(monkeypatch):
    from gyeeta_tpu_torch.engine import aggstate, step
    from gyeeta_tpu_torch.ingest import decode
    from gyeeta_tpu_torch.parallel import depgraph
    from gyeeta_tpu_torch.sim import ParthaSim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = aggstate.EngineCfg(svc_capacity=8, n_hosts=2, task_capacity=8,
                             api_capacity=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aggstate.init(cfg)
    cb = decode.conn_batch(ParthaSim(n_hosts=2, n_svcs=2).conn_records(4), 8)
    with pytest.raises(RuntimeError):
        decode.to_device(cb)
    with pytest.raises(RuntimeError):
        aggstate.state_from_numpy(
            aggstate.state_to_numpy(aggstate.init(cfg, "cpu")))
    assert aggstate.init(cfg, "cpu").n_conn.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        depgraph.init(8, 8)
    with pytest.raises(RuntimeError):
        depgraph.dep_from_numpy(depgraph.dep_to_numpy(
            depgraph.init(8, 8, "cpu")))
    # fold_all runs where its state lies: on the CPU only when asked for
    st, dep, pressure = step.fold_all(cfg, aggstate.init(cfg, "cpu"),
                                      depgraph.init(8, 8, "cpu"), 0)
    assert pressure.device.type == dep.n_paired.device.type == "cpu"
    # the Runtime: CUDA by default, the CPU only when asked for
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    opts = RuntimeOpts(dep_pair_capacity=8, dep_edge_capacity=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime(cfg, opts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime(cfg, opts, device="cuda")
    rt = Runtime(cfg, opts, device="cpu")
    assert rt.state.n_conn.device.type == rt.dep.n_paired.device.type \
        == "cpu"
    # the compactor's replay runtime: the serving runtime's device, which
    # is CUDA unless the caller asks for the CPU
    from gyeeta_tpu_torch.history.compactor import Compactor
    with tempfile.TemporaryDirectory() as d:
        hopts = opts._replace(journal_dir=f"{d}/wal",
                              hist_shard_dir=f"{d}/shards")
        for dev, raises in ((None, True), ("cuda", True), ("cpu", False)):
            c = Compactor(cfg, hopts, device=dev)
            try:
                if raises:
                    with pytest.raises(RuntimeError, match="device='cpu'"):
                        c.compact_once()
                else:
                    assert c.compact_once()["windows"] == 0
                    assert c._rt.state.n_conn.device.type == "cpu"
            finally:
                c.close()
    # the daemon and its command line: CUDA by default, the CPU only
    # with --device cpu
    from gyeeta_tpu_torch import server_main
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            server_main.Daemon(server_main.parse_args(argv), env={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server_main.main(["--port", "0", "--log-level", "WARNING"])
    d = server_main.Daemon(server_main.parse_args(["--device", "cpu"]),
                           env={"GYT_SVC_CAPACITY": "64",
                                "GYT_N_HOSTS": "4"})
    try:
        assert d.rt.state.n_conn.device.type == "cpu"
    finally:
        d.rt.close()


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def _served_runtime():
    from gyeeta_tpu_torch.engine import aggstate
    from gyeeta_tpu_torch.runtime import Runtime
    from gyeeta_tpu_torch.utils.config import RuntimeOpts
    cfg = aggstate.EngineCfg(svc_capacity=64, n_hosts=8, task_capacity=64,
                             api_capacity=64, conn_batch=64, resp_batch=64,
                             listener_batch=64, cms_width=1 << 10,
                             hh_width=256, topk_capacity=16,
                             hll_p_svc=4, hll_p_global=8)
    return Runtime(cfg, RuntimeOpts(dep_pair_capacity=64,
                                    dep_edge_capacity=64), device="cpu")


def _frame(subtype):
    r = np.zeros(2, wire.DTYPE_OF_SUBTYPE[subtype])
    if subtype == wire.NOTIFY_AGENT_STATS:
        r["spool_resent"] = [3, 4]
    elif subtype == wire.NOTIFY_SKETCH_DELTA:
        r["kind"] = wire.DK_SVC_CTR
        r["key_hi"] = [1, 2]
    else:                             # inventory records of hosts 1, 2
        r["host_id"] = [1, 2]
    return wire.encode_frame(subtype, r)


# announce-rate record kinds → (registry attribute, selfstats counter)
_REGISTRY_KINDS = {
    "listener_info_records": (wire.NOTIFY_LISTENER_INFO, "svcreg",
                              "listener_infos"),
    "host_info_records": (wire.NOTIFY_HOST_INFO, "hostinfo", "host_infos"),
    "cgroup_state_records": (wire.NOTIFY_CGROUP_STATE, "cgroups",
                             "cgroup_records"),
    "mount_state_records": (wire.NOTIFY_MOUNT_STATE, "mounts",
                            "mount_records"),
    "netif_state_records": (wire.NOTIFY_NETIF_STATE, "netifs",
                            "netif_records"),
}


# paths of the edge pre-aggregation, snapshot, registry and alert tiers
# that used to be refused and are served now: each runs on the CPU when
# asked for
NOW_SERVED = {
    **{k: (lambda rt, sub=sub: rt.feed(_frame(sub)))
       for k, (sub, _, _) in _REGISTRY_KINDS.items()},
    "op": lambda rt: rt.query({"op": "add", "objtype": "tag",
                               "taskid": "00000000000000ab", "tag": "t"}),
    "sketch_delta_records": lambda rt: rt.feed(
        _frame(wire.NOTIFY_SKETCH_DELTA)),
    "agent_stats_records": lambda rt: rt.feed(
        _frame(wire.NOTIFY_AGENT_STATS)),
    "multiquery": lambda rt: rt.query(
        {"multiquery": [{"subsys": "svcstate"}]}),
    "consistency_snapshot": lambda rt: rt.query(
        {"subsys": "svcstate", "consistency": "snapshot"}),
    "selfstats": lambda rt: rt.query({"subsys": "selfstats"}),
    "metrics": lambda rt: rt.query({"subsys": "metrics"}),
}


@pytest.mark.parametrize("path", sorted(NOW_SERVED))
def test_slice_path_no_longer_refused(path):
    rt = _served_runtime()
    out = NOW_SERVED[path](rt)
    assert out is not None
    if path == "sketch_delta_records":
        assert rt.stats.counters["preagg_delta_records"] == 2
        assert int(rt.state.tbl.n_live) == 2
    if path == "agent_stats_records":
        assert rt.stats.counters["spool_resent"] == 7
    if path in _REGISTRY_KINDS:
        _, reg, ctr = _REGISTRY_KINDS[path]
        assert rt.stats.counters[ctr] == 2
        assert len(getattr(rt, reg)) >= 1
    if path == "op":
        assert out["ok"] and len(rt.tags) == 1
