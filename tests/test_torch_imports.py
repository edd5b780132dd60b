"""The port stands alone: no module of ``gyeeta_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and its
entry points refuse to run without a GPU unless the CPU is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gyeeta_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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
