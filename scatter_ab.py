#!/usr/bin/env python3
"""What do warp aggregation and a block-level shared-memory stage buy
in the generic scatter kernel?

    python3 scatter_ab.py [--rounds 4] [--reps 500] [--captured]

Times the port's kernel (``gyt_scatter_sites`` of
``gyeeta_tpu_torch/csrc/scatter.cu``) against variants built here from
the source below:

- ``direct``: masked row × stride + column lanes, every column of a lane
  read at once, and one global atomic a kept lane (no aggregation);
- ``warp``: the same lanes, then warp aggregation: the kept lanes of a
  warp that share a target find each other with ``__match_any_sync``,
  combine their values by a pointer-jumping shuffle reduction, and the
  group's lowest lane issues one atomic;
- ``redux`` (int32 only): ``warp`` with ``__reduce_max_sync`` /
  ``__reduce_add_sync`` over each group in place of its shuffle
  reduction;
- ``stage`` (f32 add only): ``warp``, then a 512-slot
  open-addressing table in shared memory a block (``atomicCAS`` on the
  key, ``atomicAdd`` on the partial) flushed with one global atomic a
  distinct target of the block; a group that finds no slot in 8 probes
  adds to global memory directly.

``direct`` and ``warp`` take the port's site array (several sites a
launch); ``redux`` and ``stage`` one site with int32 rows and columns.

Synthetic cells (lanes from a seeded numpy generator): the delta
section's loghist site (an f32 ``(131072, 256)`` target, 4,096 and
65,536 lanes over 75 targets, all kept and one in ten kept), an HLL
register site (int32 max, 32,768 lanes over a ``(131072, 1024)``
target, nearly all distinct), the t-digest stage counts (int32 add,
4,096 lanes, rows sorted, a few repeats) and a CMS site (f32 add,
65,536 lanes over ``(2, 131072)``).

``--captured`` adds the main path's own inputs: it runs
``chip_smoke.py``'s phase 9 whole (about two minutes: the delta-fed and
raw runtimes and every check of the phase) and keeps the generic
kernel's sites as the program passed them: the one-launch delta merge
and the delta stage counts of phase 9's recorded dispatch, and the last
call of each other route and lane count (the raw runtime's conn/resp
stage counts). Each is then timed as the port, ``direct`` and ``warp``
launch it, all sites of a call in one launch.

Each variant's time is its kernel's own device time under
torch.profiler (the host's issue time left out); the variants run in
turns (A, B, …, B, A), ``--reps`` launches each a round, for
``--rounds`` rounds; every result is held against the plain version
first (exact for max and int32 add and for the synthetic cells'
integer values; rtol 1e-6 for captured f32 sums). Prints one JSON line
with the card's name and power limit. Needs one NVIDIA GPU and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

STAGED_SRC = r"""
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 256, kSlots = 512, kProbes = 8;
__device__ __forceinline__ float group_sum(float v, unsigned peers, int lane) {
    const unsigned above = peers & ~((2u << lane) - 1u);
    int nxt = above ? __ffs(above) - 1 : lane;
    int has = above != 0;
    const int cnt = __popc(peers);
    for (int w = 1; w < cnt; w <<= 1) {
        const float o = __shfl_sync(peers, v, nxt);
        const int nn = __shfl_sync(peers, nxt, nxt);
        const int nh = __shfl_sync(peers, has, nxt);
        if (has) { v += o; nxt = nn; has = nh; }
    }
    return v;
}
__global__ void __launch_bounds__(kThreads) staged_add(
        float* out, const int* row, const int* col, const unsigned char* keep,
        const float* val, long long stride, long long n_out, int n) {
    __shared__ int keys[kSlots];
    __shared__ float sums[kSlots];
    for (int k = threadIdx.x; k < kSlots; k += kThreads) { keys[k] = -1; sums[k] = 0.f; }
    __syncthreads();
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool on = i < n && keep[i] != 0 && row[i] >= 0;
    const unsigned act = __ballot_sync(0xffffffffu, on);
    if (on) {
        const long long flat = static_cast<long long>(row[i]) * stride + col[i];
        if (static_cast<unsigned long long>(flat) >= static_cast<unsigned long long>(n_out)) __trap();
        const int tgt = static_cast<int>(flat);
        const unsigned peers = __match_any_sync(act, tgt);
        const int lane = threadIdx.x & 31;
        const float v = group_sum(val[i], peers, lane);
        if (lane == __ffs(peers) - 1) {
            const unsigned h = (static_cast<unsigned>(tgt) * 2654435761u) % kSlots;
            bool done = false;
            for (int p = 0; p < kProbes && !done; ++p) {
                const int slot = (h + p) % kSlots;
                const int prev = atomicCAS(&keys[slot], -1, tgt);
                if (prev == -1 || prev == tgt) { atomicAdd(&sums[slot], v); done = true; }
            }
            if (!done) atomicAdd(out + tgt, v);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kSlots; k += kThreads)
        if (keys[k] >= 0) atomicAdd(out + keys[k], sums[k]);
}
// one atomic a kept lane; op: 0 max int32, 1 max f32, 2 add f32, 3 add int32
__global__ void __launch_bounds__(kThreads) ab_direct(
        void* out, const int* row, const int* col, const unsigned char* keep,
        const unsigned* val, long long stride, long long n_out, int n, int op) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool k = keep[i] != 0;
    const int r = row[i];
    const int c = col[i];
    const unsigned b = val[i];
    if (!k || r < 0) return;
    const long long flat = static_cast<long long>(r) * stride + c;
    if (static_cast<unsigned long long>(flat) >= static_cast<unsigned long long>(n_out)) __trap();
    if (op == 0) {
        atomicMax(static_cast<int*>(out) + flat, static_cast<int>(b));
    } else if (op == 1) {
        if (!(b >> 31)) atomicMax(static_cast<int*>(out) + flat, static_cast<int>(b));
        else atomicMin(static_cast<unsigned*>(out) + flat, b);
    } else if (op == 2) {
        atomicAdd(static_cast<float*>(out) + flat, __uint_as_float(b));
    } else {
        atomicAdd(static_cast<int*>(out) + flat, static_cast<int>(b));
    }
}
// int32 only: the port's aggregation with __reduce_*_sync over each group
// in place of its shuffle reduction; op: 0 max, 3 add
__global__ void __launch_bounds__(kThreads) ab_redux(
        int* out, const int* row, const int* col, const unsigned char* keep,
        const int* val, long long stride, long long n_out, int n, int op) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    bool on = false;
    int r = 0, c = 0, v = 0;
    if (i < n) {
        const bool k = keep[i] != 0;
        r = row[i];
        c = col[i];
        v = val[i];
        on = k && r >= 0;
    }
    const unsigned act = __ballot_sync(0xffffffffu, on);
    if (!on) return;
    const long long flat = static_cast<long long>(r) * stride + c;
    if (static_cast<unsigned long long>(flat) >= static_cast<unsigned long long>(n_out)) __trap();
    const unsigned peers = __match_any_sync(act, static_cast<int>(flat));
    const bool leader = (threadIdx.x & 31) == __ffs(peers) - 1;
    if (op == 0) {
        const int m = __reduce_max_sync(peers, v);
        if (leader) atomicMax(out + flat, m);
    } else {
        const int a = __reduce_add_sync(peers, v);
        if (leader) atomicAdd(out + flat, a);
    }
}
}  // namespace
extern "C" int gyt_redux(int* out, const int* row, const int* col, const unsigned char* keep,
                         const int* val, long long stride, long long n_out, int n, int op,
                         void* stream) {
    if (n == 0) return 0;
    ab_redux<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, row, col, keep, val, stride, n_out, n, op);
    return static_cast<int>(cudaGetLastError());
}
extern "C" int gyt_direct(void* out, const int* row, const int* col, const unsigned char* keep,
                          const unsigned* val, long long stride, long long n_out, int n, int op,
                          void* stream) {
    if (n == 0) return 0;
    ab_direct<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, row, col, keep, val, stride, n_out, n, op);
    return static_cast<int>(cudaGetLastError());
}
// the port's site layout (csrc/scatter.cu GytScatterSite), several
// sites a launch: grid y picks the site
struct AbSite {
    void* out; const void* row; const int* col; const unsigned char* keep;
    const void* val; long long stride; long long n_out; int n; int op; int row64;
};
struct AbSites { AbSite s[8]; };
namespace {
__device__ __forceinline__ void max_f32(float* p, unsigned bits) {
    if (!(bits & 0x80000000u)) atomicMax(reinterpret_cast<int*>(p), static_cast<int>(bits));
    else atomicMin(reinterpret_cast<unsigned*>(p), bits);
}
// read every column of lane i at once -> whether it is kept, and its target
__device__ __forceinline__ bool ab_lane(const AbSite& s, int i, long long* flat, unsigned* bits) {
    const bool k = s.keep == nullptr || s.keep[i] != 0;
    const long long r = s.row64 ? static_cast<const long long*>(s.row)[i]
                                : static_cast<long long>(static_cast<const int*>(s.row)[i]);
    const int c = s.col != nullptr ? s.col[i] : 0;
    *bits = static_cast<const unsigned*>(s.val)[i];
    *flat = r * s.stride + c;
    if (!(k && r >= 0)) return false;
    if (static_cast<unsigned long long>(*flat) >= static_cast<unsigned long long>(s.n_out)) __trap();
    return true;
}
__global__ void __launch_bounds__(kThreads) ab_sites_direct(const __grid_constant__ AbSites sites) {
    const AbSite& s = sites.s[blockIdx.y];
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= s.n) return;
    long long flat;
    unsigned b;
    if (!ab_lane(s, i, &flat, &b)) return;
    if (s.op == 0) atomicMax(static_cast<int*>(s.out) + flat, static_cast<int>(b));
    else if (s.op == 1) max_f32(static_cast<float*>(s.out) + flat, b);
    else if (s.op == 2) atomicAdd(static_cast<float*>(s.out) + flat, __uint_as_float(b));
    else atomicAdd(static_cast<int*>(s.out) + flat, static_cast<int>(b));
}
template <class F>
__device__ __forceinline__ unsigned group_reduce(unsigned v, unsigned peers, int lane, F f) {
    const unsigned above = peers & ~((2u << lane) - 1u);
    int nxt = above ? __ffs(above) - 1 : lane;
    int has = above != 0;
    const int cnt = __popc(peers);
    for (int w = 1; w < cnt; w <<= 1) {
        const unsigned o = __shfl_sync(peers, v, nxt);
        const int nn = __shfl_sync(peers, nxt, nxt);
        const int nh = __shfl_sync(peers, has, nxt);
        if (has) { v = f(v, o); nxt = nn; has = nh; }
    }
    return v;
}
struct MaxU { __device__ unsigned operator()(unsigned a, unsigned b) const { return a > b ? a : b; } };
struct AddU { __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; } };
struct AddF {
    __device__ unsigned operator()(unsigned a, unsigned b) const {
        return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
    }
};
__global__ void __launch_bounds__(kThreads) ab_sites_warp(const __grid_constant__ AbSites sites) {
    const AbSite& s = sites.s[blockIdx.y];
    if (static_cast<int>(blockIdx.x) * kThreads >= s.n) return;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    long long flat = 0;
    unsigned b = 0;
    const bool on = i < s.n && ab_lane(s, i, &flat, &b);
    const unsigned act = __ballot_sync(0xffffffffu, on);
    if (!on) return;
    const int tgt = static_cast<int>(flat);
    const unsigned peers = __match_any_sync(act, tgt);
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    if (s.op == 0) {                                 // max on keys: bits ^ sign
        const unsigned m = group_reduce(b ^ 0x80000000u, peers, lane, MaxU());
        if (leader) atomicMax(static_cast<int*>(s.out) + tgt, static_cast<int>(m ^ 0x80000000u));
    } else if (s.op == 1) {
        const unsigned key = (b & 0x80000000u) ? ~b : b | 0x80000000u;
        const unsigned m = group_reduce(key, peers, lane, MaxU());
        if (leader) max_f32(static_cast<float*>(s.out) + tgt, (m & 0x80000000u) ? m & 0x7fffffffu : ~m);
    } else if (s.op == 2) {
        const unsigned a = group_reduce(b, peers, lane, AddF());
        if (leader) atomicAdd(static_cast<float*>(s.out) + tgt, __uint_as_float(a));
    } else {
        const unsigned a = group_reduce(b, peers, lane, AddU());
        if (leader) atomicAdd(static_cast<int*>(s.out) + tgt, static_cast<int>(a));
    }
}
}  // namespace
extern "C" int gyt_ab_sites(const AbSite* sites, int n_sites, int warp, void* stream) {
    if (n_sites < 1 || n_sites > 8) return -1;
    AbSites p{};
    int max_n = 0;
    for (int k = 0; k < n_sites; ++k) {
        p.s[k] = sites[k];
        max_n = sites[k].n > max_n ? sites[k].n : max_n;
    }
    if (max_n == 0) return 0;
    const dim3 grid((max_n + kThreads - 1) / kThreads, n_sites);
    if (warp) ab_sites_warp<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    else ab_sites_direct<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
extern "C" int gyt_staged_add(float* out, const int* row, const int* col, const unsigned char* keep,
                              const float* val, long long stride, long long n_out, int n, void* stream) {
    if (n == 0) return 0;
    staged_add<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, row, col, keep, val, stride, n_out, n);
    return static_cast<int>(cudaGetLastError());
}
"""

# each variant's kernel, by the name the profiler shows
KERNELS = {"port": "gyt_scatter_sites_kernel", "direct": "ab_direct",
           "redux": "ab_redux", "stage": "staged_add",
           "direct_sites": "ab_sites_direct", "warp": "ab_sites_warp"}
# (cell, op, dtype, target shape, lanes, distinct targets or None for
# uniform over the target, kept fraction, rows sorted)
CELLS = (
    ("loghist", "add", "float32", (131072, 256), 4096, 75, 1.0, False),
    ("loghist", "add", "float32", (131072, 256), 4096, 75, 0.1, False),
    ("loghist", "add", "float32", (131072, 256), 65536, 75, 1.0, False),
    ("loghist", "add", "float32", (131072, 256), 65536, 75, 0.1, False),
    ("hll", "max", "int32", (131072, 1024), 32768, None, 1.0, False),
    ("stage", "add", "int32", (131072, 1), 4096, None, 1.0, True),
    ("cms", "add", "float32", (2, 131072), 65536, None, 1.0, False),
)
_OP = {("max", "int32"): 0, ("max", "float32"): 1, ("add", "float32"): 2,
       ("add", "int32"): 3}


def build(scatter):
    """nvcc the variants into build/kernels/ → (direct, redux, staged,
    sites) entries."""
    h = hashlib.sha256((STAGED_SRC + " ".join(scatter.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    out = scatter.BUILD_DIR / f"libgyt_scatter_ab_{h}.so"
    if not out.exists():
        scatter.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cu")
        src.write_text(STAGED_SRC)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([scatter._nvcc(), *scatter.NVCC_FLAGS, "-o",
                            str(tmp), str(src)], check=True)
        finally:
            src.unlink()
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptrs = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_int]
    for fn in (lib.gyt_direct, lib.gyt_redux):
        fn.argtypes = [*ptrs, ctypes.c_int, ctypes.c_void_p]
    lib.gyt_staged_add.argtypes = [*ptrs, ctypes.c_void_p]
    lib.gyt_ab_sites.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    for fn in (lib.gyt_direct, lib.gyt_redux, lib.gyt_staged_add,
               lib.gyt_ab_sites):
        fn.restype = ctypes.c_int
    return lib.gyt_direct, lib.gyt_redux, lib.gyt_staged_add, \
        lib.gyt_ab_sites


def lanes(torch, np, shape, n, distinct, kept_frac, sort, dtype, seed):
    """n lanes over ``distinct`` (row, col) targets of ``shape`` (None:
    uniform over it), on the card: (row, col, keep, val)."""
    rng = np.random.default_rng(seed)
    size = shape[0] * shape[1]
    flat = rng.integers(0, size, n) if distinct is None \
        else rng.choice(size, distinct, replace=False)[
            rng.integers(0, distinct, n)]
    if sort:
        flat = np.sort(flat)
    row = (flat // shape[1]).astype(np.int32)
    col = (flat % shape[1]).astype(np.int32)
    keep = rng.random(n) < kept_frac
    val = rng.integers(1, 50, n).astype(dtype)
    return [torch.from_numpy(a).cuda() for a in (row, col, keep, val)]


def device_us(torch, fns, reps):
    """Mean device time (us) of each kernel of ``fns`` (name → fn), run
    in turns (A, B, B, A) ``reps`` times each under torch.profiler: the
    kernels' own durations, without the host's issue time."""
    from torch.profiler import ProfilerActivity, profile
    names = list(fns)
    order = names + names[::-1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in order:
            for _ in range(reps // 2):
                fns[name]()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    got = {}
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        for name in names:
            if KERNELS[name] in e.key:
                got[name] = e.self_device_time_total / e.count
    return got


def capture_sites(torch, scatter) -> dict:
    """Run chip_smoke.py's phase 9 with the generic kernel's calls
    recorded → {(what, route, lanes a site): sites}: phase 9's recorded
    delta dispatch (its recorder is installed over this one while it
    records) and the last call of each other (route, lanes)."""
    import chip_smoke as C
    inner = scatter.scatter_sites
    got = {}

    def rec(sites, route):
        sites = [scatter.Site(*x) for x in sites]
        what = "phase9_recorded" if scatter.scatter_sites is not rec \
            else "last"
        key = (what, route, tuple(x.row.numel() for x in sites))
        if sites[0].target.is_cuda and (what == "last" or key not in got):
            # the lanes as they are now; the target is cloned when timed
            got[key] = [x._replace(**{f: getattr(x, f).clone() for f in (
                "row", "val", "keep", "col") if getattr(x, f) is not None})
                for x in sites]
        return inner(sites, route=route)

    scatter.scatter_sites = rec
    try:
        C.delta_phase(torch, scatter)
    finally:
        scatter.scatter_sites = inner
    # the recorded dispatch's own calls, and the raw runtime's: a "last"
    # call of the same route and shape as a recorded one is dropped
    rec_shapes = {k[1:] for k in got if k[0] == "phase9_recorded"}
    return {k: v for k, v in sorted(got.items())
            if k[0] == "phase9_recorded" or k[1:] not in rec_shapes}


def captured_cell(torch, np, scatter, ab_sites, stream, key, sites, a):
    """One captured call timed as the port, ``direct`` and ``warp``
    launch it (targets cloned once; each variant first held against the
    plain version) → its JSON cell."""
    work = [x._replace(target=x.target.clone()) for x in sites]
    arr = scatter.csites(work)

    def variant(warp):
        def go():
            err = ab_sites(ctypes.addressof(arr), len(work), warp, stream)
            if err:
                raise RuntimeError(f"gyt_ab_sites: CUDA error {err}")
        return go

    fns = {"port": lambda: scatter.scatter_sites(work, route=key[1]),
           "direct_sites": variant(0), "warp": variant(1)}
    want = [x._replace(target=x.target.clone()) for x in sites]
    scatter.scatter_sites_plain(want)
    base = [x.target.clone() for x in work]
    for name, f in fns.items():
        for x, b in zip(work, base):
            x.target.copy_(b)
        f()
        torch.cuda.synchronize()
        for x, w in zip(work, want):
            rtol = 1e-6 if x.op == "add" and x.target.is_floating_point() \
                else 0
            torch.testing.assert_close(x.target, w.target, rtol=rtol, atol=0,
                                       msg=lambda m: f"{name} at {key}: {m}")
    t = {name: [] for name in fns}
    for _ in range(a.rounds):
        got = device_us(torch, fns, a.reps)
        for name in t:
            t[name].append(got[name])
    per_site = []
    for x in sites:
        ok = (x.row >= 0) if x.keep is None else x.keep & (x.row >= 0)
        flat = x.row.long() * x.stride + (0 if x.col is None else x.col)
        per_site.append({"op": x.op, "dtype": str(x.target.dtype)[6:],
                         "target": list(x.target.shape),
                         "lanes": x.row.numel(), "kept": int(ok.sum()),
                         "distinct_kept": int(torch.unique(flat[ok])
                                              .numel())})
    return {"cell": f"{key[0]}:{key[1]}", "sites": per_site, "us": t,
            "us_median": {name: float(np.median(v)) for name, v in t.items()}}


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=500)
    ap.add_argument("--captured", action="store_true")
    a = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("scatter_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gyeeta_tpu_torch.sketch import scatter
    direct, redux, staged, ab_sites = build(scatter)
    got_sites = capture_sites(torch, scatter) if a.captured else {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    cells = []
    for k, (cell, op, dt, shape, n, distinct, kept, sort) in enumerate(CELLS):
        out = torch.zeros(shape, dtype=getattr(torch, dt), device="cuda")
        row, col, keep, val = lanes(torch, np, shape, n, distinct, kept,
                                    sort, dt, 14 + k)
        wrapper = scatter.scatter_max if op == "max" else scatter.scatter_add
        args = (out.data_ptr(), row.data_ptr(), col.data_ptr(),
                keep.data_ptr(), val.data_ptr(), shape[1], out.numel(), n)

        def run(fn, *a):
            err = fn(*a, stream)
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

        site = scatter.Site(op, out, row, val, keep, col, shape[1])
        arr = scatter.csites([site])
        fns = {"port": lambda: wrapper(out, row, val, keep=keep, col=col,
                                       stride=shape[1]),
               "direct": lambda: run(direct, *args, _OP[(op, dt)]),
               "warp": lambda: run(ab_sites, ctypes.addressof(arr), 1, 1)}
        if (op, dt) == ("add", "float32"):
            fns["stage"] = lambda: run(staged, *args)
        if dt == "int32":
            fns["redux"] = lambda: run(redux, *args, _OP[(op, dt)])
        plain = scatter.scatter_max_plain if op == "max" \
            else scatter.scatter_add_plain
        want = plain(torch.zeros_like(out), row, val, keep=keep, col=col,
                     stride=shape[1])
        for name, f in fns.items():
            out.zero_()
            f()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} at {cell} differs from the "
                                     "plain version")
        t = {name: [] for name in fns}
        for _ in range(a.rounds):
            got = device_us(torch, fns, a.reps)
            for name in t:
                t[name].append(got[name])
        flat = row.long() * shape[1] + col
        cells.append({"cell": cell, "op": op, "dtype": dt,
                      "target": list(shape), "lanes": n,
                      "kept": int(keep.sum()),
                      "distinct_kept": int(torch.unique(flat[keep]).numel()),
                      "us": t, "us_median": {
                          name: float(np.median(v)) for name, v in t.items()}})
    for key, sites in got_sites.items():
        cells.append(captured_cell(torch, np, scatter, ab_sites, stream, key,
                                   sites, a))
    print(json.dumps({"scatter_ab": cells, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
