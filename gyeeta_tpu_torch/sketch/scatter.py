"""Masked scatter-max / scatter-add register updates, the port of the
two Pallas kernels (``gyeeta_tpu/sketch/pallas_scatter.py``), and the
build of every kernel in ``gyeeta_tpu_torch/csrc``.

A *site* is one scatter: lane ``i`` updates
``target.flat[row[i] * stride + col[i]]`` (``col`` None: ``+ 0``) with
``val[i]`` by max or add, and writes nothing when ``keep[i]`` is False
or ``row[i] < 0`` (JAX's ``mode="drop"``; no lane is aimed at element 0).
``row`` is int32 or int64, as ``table.lookup`` returns it.

- :func:`scatter_max` — max, int32 or f32. Replaces
  ``_scatter_max_call``.
- :func:`scatter_add` — add, f32 (replaces ``_scatter_add_call``) or
  int32 (``utils.tensor.add_drop``'s integer counts).
- :func:`scatter_sites` — up to :data:`MAX_SITES` sites in ONE launch
  (``engine.step.ingest_delta``'s loghist add and two HLL maxes).

Each updates its targets in place (the Pallas kernels alias them to
their output). On a CUDA tensor every one launches the same kernel of
``csrc/scatter.cu``, ``gyt_scatter_sites`` (masking, index arithmetic
and the atomics in one pass), and counts the launch in
:data:`launches` under its caller's route: ``delta_merge``
(``ingest_delta``'s three merges), ``add_drop`` (the int32 stage
counts), and ``scatter_max`` / ``scatter_add`` for a direct call of the
single-site wrappers. On a CPU tensor it runs the plain PyTorch version
(:func:`scatter_max_plain`, :func:`scatter_add_plain`,
:func:`scatter_sites_plain`): ``where`` on the index and the values,
then ``index_reduce_`` / ``index_put_``, the reference the kernel is
held against. Nothing falls back from the kernel to a plain version.
The sketch updates of the fold path do not call these: there each
launches one fused hash → bucket → atomic kernel of
``csrc/sketch_update.cu`` (``hyperloglog``, ``countmin``,
``invertible``), and their plain versions are the hash chain followed
by :func:`scatter_max_plain` / :func:`scatter_add_plain`.

:func:`build` compiles each source of ``csrc`` with ``nvcc`` for
``sm_90a`` into its own shared library under ``build/kernels/``, keyed
on a hash of the source, the headers and the flags, all sources at once;
:func:`kernel` loads them with ``ctypes`` at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per source, all built at once
_SOURCES = (_CSRC / "scatter.cu", _CSRC / "sketch_update.cu")
_HEADERS = (_CSRC / "hash32.cuh",)
BUILD_DIR = _CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_SITES = 8               # csrc/scatter.cu kMaxSites

ROUTES = ("delta_merge", "add_drop", "scatter_max", "scatter_add")
#: launches of ``gyt_scatter_sites`` by route since :func:`reset_counts`
launches = dict.fromkeys(ROUTES, 0)

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


class Site(NamedTuple):
    """One scatter site: ``target.flat[row * stride + col] (op)= val``
    where ``keep`` and ``row >= 0``. ``op`` is ``"max"`` or ``"add"``."""
    op: str
    target: torch.Tensor
    row: torch.Tensor
    val: torch.Tensor
    keep: Optional[torch.Tensor] = None
    col: Optional[torch.Tensor] = None
    stride: int = 1


class _CSite(ctypes.Structure):
    """csrc/scatter.cu's GytScatterSite."""
    _fields_ = [("out", ctypes.c_void_p), ("row", ctypes.c_void_p),
                ("col", ctypes.c_void_p), ("keep", ctypes.c_void_p),
                ("val", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("n_out", ctypes.c_longlong), ("n", ctypes.c_int),
                ("op", ctypes.c_int), ("row64", ctypes.c_int)]


# (op, target dtype) → csrc/scatter.cu's Op
_OPS = {("max", torch.int32): 0, ("max", torch.float32): 1,
        ("add", torch.float32): 2, ("add", torch.int32): 3}


def _check(site: Site) -> None:
    """Raise on a site the kernel does not take."""
    op, target, row, val, keep, col, stride = site
    if (op, target.dtype) not in _OPS:
        raise TypeError(f"scatter-{op} of a {target.dtype} target is not "
                        "supported")
    if val.dtype != target.dtype:
        raise TypeError(f"val dtype {val.dtype} != target {target.dtype}")
    if row.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"row/idx dtype {row.dtype} must be int32 or int64")
    if row.dim() != 1 or val.shape != row.shape:
        raise ValueError(f"row {tuple(row.shape)} and val "
                         f"{tuple(val.shape)} must be equal 1-D shapes")
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != row.shape):
        raise TypeError(f"keep must be a bool {tuple(row.shape)} mask")
    if col is not None and (col.dtype != torch.int32
                            or col.shape != row.shape):
        raise TypeError(f"col must be an int32 {tuple(row.shape)} column")
    if not isinstance(stride, int) or stride < 0:
        raise ValueError(f"stride {stride!r} must be an int >= 0")
    lanes = [t for t in (row, val, keep, col) if t is not None]
    if not all(t.is_contiguous() for t in (target, *lanes)):
        raise ValueError("target, row, val, keep and col must be "
                         "contiguous")
    if any(t.device != target.device for t in lanes):
        raise ValueError(f"lanes on {[str(t.device) for t in lanes]}, the "
                         f"target on {target.device}")
    if target.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {target.device}")
    if target.numel() >= 2**31:
        raise ValueError(f"{target.numel()} registers exceed int32 indexing")


def identity(op: str, dtype: torch.dtype):
    """The value a dropped lane carries in the plain version: it leaves
    element 0, where the lane is aimed, exactly as it was (-0.0 is the
    f32 sum's identity: x + -0.0 == x for every x, -0.0 included)."""
    if op == "add":
        return -0.0 if dtype.is_floating_point else 0
    return -math.inf if dtype.is_floating_point else torch.iinfo(dtype).min


def site_plain(site: Site) -> torch.Tensor:
    """Plain PyTorch version of one site (in place; on the CPU an add
    runs in lane order, as the Pallas kernel's loop does) → its target."""
    op, target, row, val, keep, col, stride = site
    ok = row >= 0 if keep is None else keep & (row >= 0)
    idx = row.to(torch.int64) * stride
    if col is not None:
        idx = idx + col
    idx = torch.where(ok, idx, 0)
    val = torch.where(ok, val, torch.full((), identity(op, val.dtype),
                                          dtype=val.dtype,
                                          device=val.device))
    flat = target.view(-1)
    if op == "max":
        flat.index_reduce_(0, idx, val, "amax", include_self=True)
    else:
        flat.index_put_((idx,), val, accumulate=True)
    return target


def scatter_sites_plain(sites) -> None:
    """Plain PyTorch version of :func:`scatter_sites`: each site in turn."""
    for s in sites:
        site_plain(s)


def csites(sites):
    """``sites`` as the ctypes array of ``GytScatterSite`` the entry
    takes."""
    arr = (_CSite * len(sites))()
    for c, (op, target, row, val, keep, col, stride) in zip(arr, sites):
        c.out, c.row, c.val = target.data_ptr(), row.data_ptr(), \
            val.data_ptr()
        c.keep = None if keep is None else keep.data_ptr()
        c.col = None if col is None else col.data_ptr()
        c.stride, c.n_out, c.n = stride, target.numel(), row.numel()
        c.op, c.row64 = _OPS[(op, target.dtype)], row.dtype == torch.int64
    return arr


def _launch(sites) -> bool:
    """Launch ``gyt_scatter_sites`` over ``sites`` on the current stream;
    False when no site has a lane to launch for."""
    if not any(s.row.numel() for s in sites):
        return False
    launch("gyt_scatter_sites", [ctypes.POINTER(_CSite), ctypes.c_int],
           sites[0].target.device, csites(sites), len(sites),
           refused=f"{len(sites)} sites (1..{MAX_SITES} of max/add "
           "int32/f32 taken)")
    return True


def scatter_sites(sites, route: str) -> None:
    """Every :class:`Site` of ``sites`` (1..:data:`MAX_SITES`, all on one
    device) in place, in ONE kernel launch on a CUDA device, counted in
    ``launches[route]``. Sites must not share a target element with
    another site's different op."""
    sites = [Site(*s) for s in sites]
    if not 1 <= len(sites) <= MAX_SITES:
        raise ValueError(f"{len(sites)} sites, want 1..{MAX_SITES}")
    if route not in launches:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    for s in sites:
        _check(s)
    if len({s.target.device for s in sites}) != 1:
        raise ValueError("sites on different devices")
    if sites[0].target.device.type == "cpu":
        scatter_sites_plain(sites)
    elif _launch(sites):
        launches[route] += 1


def scatter_max_plain(regs: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, keep=None, col=None,
                      stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_max` (in place)."""
    return site_plain(Site("max", regs, idx, val, keep, col, stride))


def scatter_add_plain(counts: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, keep=None, col=None,
                      stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add` (in place; on the CPU
    the sum runs in lane order, as the Pallas kernel's loop does)."""
    return site_plain(Site("add", counts, idx, val, keep, col, stride))


def scatter_max(regs: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                keep=None, col=None, stride: int = 1,
                route: str = "scatter_max") -> torch.Tensor:
    """``regs.flat[idx[i] * stride + col[i]] = max(…, val[i])`` where
    ``keep[i]`` and ``idx[i] >= 0``, in place → ``regs``.

    ``regs``: int32 or f32, any shape (indexed flat); ``idx``: int32 or
    int64 rows (flat indices when ``col`` is None); ``val``: ``regs``'
    dtype; ``keep``: an optional bool lane mask; ``col``: optional int32
    columns of a row of ``stride`` elements."""
    scatter_sites([Site("max", regs, idx, val, keep, col, stride)],
                  route=route)
    return regs


def scatter_add(counts: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                keep=None, col=None, stride: int = 1,
                route: str = "scatter_add") -> torch.Tensor:
    """``counts.flat[idx[i] * stride + col[i]] += val[i]`` where
    ``keep[i]`` and ``idx[i] >= 0``, in place (f32 or int32) → ``counts``.
    Arguments as :func:`scatter_max`'s."""
    scatter_sites([Site("add", counts, idx, val, keep, col, stride)],
                  route=route)
    return counts


def launch_counts() -> dict:
    """The launches of each route since :func:`reset_counts`."""
    return dict(launches)


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
