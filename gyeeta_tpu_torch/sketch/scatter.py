"""Scatter-max / scatter-add register updates: the port of the two Pallas
kernels (``gyeeta_tpu/sketch/pallas_scatter.py``).

- :func:`scatter_max` — ``regs.flat[idx] = max(regs.flat[idx], val)``:
  the HLL register writes (int32, ``hyperloglog.update`` and
  ``update_entities``) and the invertible-sketch priorities (f32,
  ``invertible.update``). Replaces ``_scatter_max_call``.
- :func:`scatter_add` — ``counts.flat[idx] += val``: the Count-Min rows
  (f32, ``countmin.update``). Replaces ``_scatter_add_call``.

Both update their first argument in place (the Pallas kernels alias it
to their output) and return it. ``val`` must be pre-masked by the
caller: padding lanes carry 0.

On a CUDA tensor each wrapper launches its kernel from
``csrc/scatter.cu`` (built with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/``, keyed on a hash of the source, and loaded with
``ctypes``) and counts the launch in ``scatter_max_launches`` /
``scatter_add_launches``. On a CPU tensor it runs the plain PyTorch
version (:func:`scatter_max_plain`, :func:`scatter_add_plain`), the
reference the kernels are held against. Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG / "csrc" / "scatter.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

scatter_max_launches = 0
scatter_add_launches = 0

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/scatter.cu")
    return found


def build() -> Path:
    """Compile the kernels (once per source hash) → the shared library."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libgyt_scatter_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("gyt_scatter_max_i32", "gyt_scatter_max_f32",
                     "gyt_scatter_add_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    with torch.cuda.device(target.device):
        stream = torch.cuda.current_stream(target.device).cuda_stream
        err = getattr(_load(), name)(
            target.data_ptr(), idx.data_ptr(), val.data_ptr(), n,
            target.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
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
