"""Scatter-max / scatter-add register updates, the function-for-function
port of the two Pallas kernels (``gyeeta_tpu/sketch/pallas_scatter.py``),
and the build of every kernel in ``gyeeta_tpu_torch/csrc``.

- :func:`scatter_max` — ``regs.flat[idx] = max(regs.flat[idx], val)``,
  int32 or f32. Replaces ``_scatter_max_call``.
- :func:`scatter_add` — ``counts.flat[idx] += val``, f32. Replaces
  ``_scatter_add_call``.

Both update their first argument in place (the Pallas kernels alias it
to their output) and return it. ``val`` must be pre-masked by the
caller: padding lanes carry 0. The sketch updates of the fold path do
not call them on the card: there each launches one fused hash → bucket →
atomic kernel of ``csrc/sketch_update.cu`` (``hyperloglog``,
``countmin``, ``invertible``), and their plain versions are the hash
chain followed by :func:`scatter_max_plain` / :func:`scatter_add_plain`.

On a CUDA tensor each wrapper launches its kernel from
``csrc/scatter.cu`` and counts the launch in ``scatter_max_launches`` /
``scatter_add_launches``. On a CPU tensor it runs the plain PyTorch
version (:func:`scatter_max_plain`, :func:`scatter_add_plain`), the
reference the kernels are held against. Nothing falls back from a
kernel to a plain version.

:func:`build` compiles each source of ``csrc`` with ``nvcc`` for
``sm_90a`` into its own shared library under ``build/kernels/``, keyed
on a hash of the source, the headers and the flags, all sources at once;
:func:`kernel` loads them with ``ctypes`` at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per source, all built at once
_SOURCES = (_CSRC / "scatter.cu", _CSRC / "sketch_update.cu")
_HEADERS = (_CSRC / "hash32.cuh",)
BUILD_DIR = _CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_SCATTER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int]

scatter_max_launches = 0
scatter_add_launches = 0

_libs = None
_fns: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in gyeeta_tpu_torch/csrc")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in _HEADERS:
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgyt_{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> list:
    """Compile each source that has no library for its hash yet (every
    ``nvcc`` started at once) → the shared libraries, in source order."""
    outs = [_lib_path(s) for s in _SOURCES]
    todo = [(s, o) for s, o in zip(_SOURCES, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def kernel(name: str, argtypes: list):
    """The C entry ``name`` of the built libraries, declared as taking
    ``argtypes`` and then the stream, and returning an int."""
    global _libs
    fn = _fns.get(name)
    if fn is None:
        if _libs is None:
            _libs = [ctypes.CDLL(str(p)) for p in build()]
        lib = next((lb for lb in _libs if hasattr(lb, name)), None)
        if lib is None:
            raise RuntimeError(f"no kernel library exports {name}")
        fn = getattr(lib, name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch(name: str, argtypes: list, device: torch.device, *args,
           refused: str = "") -> None:
    """Launch the C entry ``name`` on ``device``'s current stream. Raises
    on a CUDA error, and with ``refused`` when the entry returns -1 (the
    shapes it was given do not fit the kernel)."""
    fn = kernel(name, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{name}: {refused}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def lane_column(t: torch.Tensor, dtype: torch.dtype, n: int,
                device: torch.device, what: str) -> torch.Tensor:
    """A kernel's ``(n,)`` lane column as a contiguous ``dtype`` tensor
    on ``device`` (no copy when it already is one), or raise."""
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, want ({n},)")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, the state on {device}")
    return t.to(dtype).contiguous()


def _check(target: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
           dtypes: tuple) -> None:
    if target.dtype not in dtypes:
        raise TypeError(f"target dtype {target.dtype} not in {dtypes}")
    if val.dtype != target.dtype:
        raise TypeError(f"val dtype {val.dtype} != target {target.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype} must be int32")
    if idx.dim() != 1 or val.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must be equal 1-D shapes")
    if not (target.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous()):
        raise ValueError("target, idx and val must be contiguous")
    if not (target.device == idx.device == val.device):
        raise ValueError(f"tensors on different devices: {target.device}, "
                         f"{idx.device}, {val.device}")
    if target.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {target.device}")
    if target.numel() >= 2**31:
        raise ValueError(f"{target.numel()} registers exceed int32 indexing")


def _launch(name: str, target, idx, val) -> bool:
    """Launch one kernel on the current stream; False when there is no
    lane to launch for."""
    n = idx.numel()
    if n == 0:
        return False
    launch(name, _SCATTER_ARGS, target.device, target.data_ptr(),
           idx.data_ptr(), val.data_ptr(), n, target.numel())
    return True


def scatter_max_plain(regs: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_max` (in place)."""
    regs.view(-1).index_reduce_(0, idx.to(torch.int64), val, "amax",
                                include_self=True)
    return regs


def scatter_add_plain(counts: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add` (in place; on the CPU
    the sum runs in lane order, as the Pallas kernel's loop does)."""
    counts.view(-1).index_put_((idx.to(torch.int64),), val, accumulate=True)
    return counts


def scatter_max(regs: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """``regs.flat[idx[i]] = max(regs.flat[idx[i]], val[i])``, in place.

    ``regs``: int32 or f32, any shape (indexed flat); ``idx``: int32
    flat indices in ``[0, regs.numel())``; ``val``: pre-masked values of
    ``regs``' dtype."""
    global scatter_max_launches
    _check(regs, idx, val, (torch.int32, torch.float32))
    if regs.device.type == "cpu":
        return scatter_max_plain(regs, idx, val)
    name = "gyt_scatter_max_i32" if regs.dtype == torch.int32 \
        else "gyt_scatter_max_f32"
    if _launch(name, regs, idx, val):
        scatter_max_launches += 1
    return regs


def scatter_add(counts: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """``counts.flat[idx[i]] += val[i]``, in place (f32)."""
    global scatter_add_launches
    _check(counts, idx, val, (torch.float32,))
    if counts.device.type == "cpu":
        return scatter_add_plain(counts, idx, val)
    if _launch("gyt_scatter_add_f32", counts, idx, val):
        scatter_add_launches += 1
    return counts


def reset_counts() -> None:
    global scatter_max_launches, scatter_add_launches
    scatter_max_launches = 0
    scatter_add_launches = 0
