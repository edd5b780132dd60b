// Scatter-max and scatter-add over a flat register file, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of gyeeta_tpu/sketch/pallas_scatter.py:
//   _scatter_max_call (lines 71-86): out.flat[idx[i]] = max(out.flat[idx[i]], val[i])
//       int32 HLL registers (hyperloglog.update / update_entities) and the
//       f32 invertible-sketch priorities (invertible.update);
//   _scatter_add_call (lines 89-105): out.flat[idx[i]] += val[i]
//       f32 Count-Min rows (countmin.update).
// Both update `out` in place, as the Pallas kernels do through
// input_output_aliases={2: 0}. Padding lanes carry val 0 (a no-op for max
// over non-negative registers, +0 for the sums).
//
// What bounds them on the card: bytes. Each lane reads 8 B (idx + val) and
// read-modify-writes one 4 B element; at the fold path's 32,768 lanes that is
// about 0.5 MB, a fraction of a microsecond at 3.35 TB/s, so launch latency
// dominates. The Pallas kernels walk the lanes in order on one core; here one
// thread takes one lane and settles its update with a global atomic, which
// is order-free for max. Float atomic adds land in no fixed order, so f32
// sums above 2^24 may differ from a sequential sum in the low bits;
// integer-valued sums below 2^24 are exact. Privatising the small register
// files in shared memory and fusing the hash into the kernel is later work.
//
// Plain C interface, loaded with ctypes. Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError(). A lane whose index
// lies outside the register file traps (the launch fails) instead of writing
// out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lane_target(const int* __restrict__ idx, int i, int n_out) {
    int j = idx[i];
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(n_out)) __trap();
    return j;
}

__global__ void scatter_max_i32_kernel(int* __restrict__ out, const int* __restrict__ idx,
                                       const int* __restrict__ val, int n, int n_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    atomicMax(out + lane_target(idx, i, n_out), val[i]);
}

// Float max through integer atomics, exact for every non-NaN float: for a
// value with the sign bit clear, int order of the bits is float order and
// every stored negative float compares below it; for a value with the sign
// bit set, unsigned order of the bits is reverse float order.
__global__ void scatter_max_f32_kernel(float* __restrict__ out, const int* __restrict__ idx,
                                       const float* __restrict__ val, int n, int n_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float* p = out + lane_target(idx, i, n_out);
    float v = val[i];
    if (!signbit(v)) {
        atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
    } else {
        atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
    }
}

__global__ void scatter_add_f32_kernel(float* __restrict__ out, const int* __restrict__ idx,
                                       const float* __restrict__ val, int n, int n_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    atomicAdd(out + lane_target(idx, i, n_out), val[i]);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int gyt_scatter_max_i32(int* out, const int* idx, const int* val, int n, int n_out,
                        void* stream) {
    scatter_max_i32_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, idx, val, n, n_out);
    return static_cast<int>(cudaGetLastError());
}

int gyt_scatter_max_f32(float* out, const int* idx, const float* val, int n, int n_out,
                        void* stream) {
    scatter_max_f32_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, idx, val, n, n_out);
    return static_cast<int>(cudaGetLastError());
}

int gyt_scatter_add_f32(float* out, const int* idx, const float* val, int n, int n_out,
                        void* stream) {
    scatter_add_f32_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, idx, val, n, n_out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
