// Fused sketch updates for Hopper (sm_90a): hash → bucket → atomic in one pass.
//
// Each kernel reads the batch's 64-bit keys as they arrive (int64 tensors
// holding uint32 halves, the port's u32 carrier; the truncation to uint32_t is
// hashing.u32's `& 0xFFFFFFFF`), hashes them with hash32.cuh and settles the
// update with atomics, in one launch:
//
//   gyt_hll_update — hyperloglog.update / update_entities: register index and
//       rank of mix64(key, _HLL_SALT), atomicMax at row*m + index. Replaces the
//       int32 launches of _scatter_max_call (gyeeta_tpu/sketch/pallas_scatter.py:81)
//       and the hash chain that fed them.
//   gyt_cms_update — countmin.update: the depth Kirsch-Mitzenmacher rows of
//       each key, one f32 atomicAdd a row. Replaces _scatter_add_call
//       (pallas_scatter.py:99) and its hash chain.
//   gyt_inv_update — invertible.update's candidate writes: the priority
//       scatter-max and the (prio, key_hi, key_lo) winner election of each
//       bucket, one block a row with the row staged in shared memory. Replaces
//       the f32 launch of _scatter_max_call and the election around it.
//
// What bounds them: launch latency. A call moves 0.5-1.2 MB (keys, masks,
// values, the registers it touches), a fraction of a microsecond at 3.35 TB/s,
// and does ~30 integer operations a lane. The design's aim is fewer launches:
// before, each update was ~70-275 small PyTorch ops (the int64 hash chain,
// masks, concatenations) ahead of one scatter launch; now it is one launch.
// The register files are not privatised in shared memory: the per-service HLL
// (512 MB) and the CMS (1 MB) do not fit, and privatising the 64 KB global HLL
// in each block would flush more merges than the 32,768 lanes it takes.
//
// Invalid lanes write nothing (hll, cms) or compete with priority 0 (inv), as
// the plain versions' pre-masked values do. f32 atomic adds land in no fixed
// order: CMS sums above 2^24 may differ from a sequential sum in the low bits.
//
// Plain C interface, loaded with ctypes. Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError(); gyt_inv_update
// returns -1, launching nothing, when a row does not fit in shared memory. A
// lane aimed outside its register file traps (the launch fails).

#include <cuda_runtime.h>

#include "hash32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInvThreads = 1024;

constexpr uint32_t kHllSalt = 0x1F123BB5u;     // hyperloglog._HLL_SALT
constexpr uint32_t kInvSaltBucket = 0x1B5E12A7u;  // invertible._SALT_BUCKET
constexpr uint32_t kInvSaltFp = 0x7F4A7C15u;   // invertible._SALT_FP
constexpr uint32_t kInvMaskHi = 0xA5A5A5A5u;   // invertible._MASK_HI
constexpr uint32_t kInvMaskLo = 0x5A5A5A5Au;   // invertible._MASK_LO

__device__ __forceinline__ uint32_t u32(long long x) {
    return static_cast<uint32_t>(x);
}

__device__ __forceinline__ bool lane_on(const unsigned char* __restrict__ valid, int i) {
    return valid == nullptr || valid[i] != 0;
}

// regs is (n_rows, 2^p) int32; row == nullptr means one register file (n_rows 1).
__global__ void gyt_hll_update_kernel(int* __restrict__ regs, const long long* __restrict__ key_hi,
                                  const long long* __restrict__ key_lo,
                                  const long long* __restrict__ row,
                                  const unsigned char* __restrict__ valid, int n, int p,
                                  long long n_rows) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !lane_on(valid, i)) return;
    const uint32_t h = gyt::mix64(u32(key_hi[i]), u32(key_lo[i]), kHllSalt);
    long long r = 0;
    if (row != nullptr) {
        r = row[i];
        if (r < 0 || r >= n_rows) __trap();
    }
    atomicMax(regs + (r << p) + gyt::hll_index(h, p), gyt::hll_rank(h, p));
}

// counts is (depth, width) f32.
__global__ void gyt_cms_update_kernel(float* __restrict__ counts, const long long* __restrict__ key_hi,
                                  const long long* __restrict__ key_lo,
                                  const float* __restrict__ vals,
                                  const unsigned char* __restrict__ valid, int n, int depth,
                                  uint32_t width) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !lane_on(valid, i)) return;
    const uint32_t hi = u32(key_hi[i]), lo = u32(key_lo[i]);
    const uint32_t h1 = gyt::mix64(hi, lo, gyt::kKmSalt1);
    const uint32_t h2 = gyt::mix64(hi, lo, gyt::kKmSalt2) | 1u;
    const float v = vals[i];
    for (int r = 0; r < depth; ++r) {
        atomicAdd(counts + static_cast<size_t>(r) * width + gyt::km_bucket(h1, h2, r, width), v);
    }
}

// Float max through integer atomics, exact for every non-NaN float (the trick
// of scatter.cu's scatter_max_f32_kernel, here on shared memory).
__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
    if (!signbit(v)) {
        atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
    } else {
        atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
    }
}

// One block a row r of the (depth, width) sketch; every block walks all lanes.
// Shared memory: the row's new priorities (f32) and the winning key of each
// bucket as (key_hi << 32 | key_lo), 12 B a bucket. The pre-batch priorities
// are the global row itself, which no lane writes before the last barrier.
//
//   1. stage the row; zero the keys                              | barrier
//   2. new[b] = max(new[b], pr) for every lane (pr 0 if invalid) | barrier
//   3. win = valid & pr == new[b] & pr > old[b];
//      key[b] = max(key[b], (hi, lo)) over winners               | barrier
//   4. winners whose (hi, lo) == key[b] write enc_hi/enc_lo/fp   | barrier
//   5. write the row's new priorities back
//
// Step 3's one 64-bit max is the reference's two rounds (max key_hi among
// winners, then max key_lo among those left): both keep exactly the winners
// whose (hi, lo) is the lexicographic maximum. Winners left in a bucket carry
// one key, so their writes are equal.
__global__ void __launch_bounds__(kInvThreads)
gyt_inv_update_kernel(float* __restrict__ prio, long long* __restrict__ enc_hi,
                  long long* __restrict__ enc_lo, long long* __restrict__ fp,
                  const long long* __restrict__ key_hi, const long long* __restrict__ key_lo,
                  const float* __restrict__ lane_prio, const unsigned char* __restrict__ valid,
                  int n, uint32_t width) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* best = smem;                          // width × 8 B
    float* nprio = reinterpret_cast<float*>(smem + width);    // width × 4 B
    const uint32_t r = blockIdx.x;
    const size_t row = static_cast<size_t>(r) * width;
    const float* old = prio + row;
    const uint32_t salt = kInvSaltBucket + r;

    for (uint32_t b = threadIdx.x; b < width; b += blockDim.x) {
        nprio[b] = old[b];
        best[b] = 0ull;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t b = gyt::range_map(gyt::mix64(u32(key_hi[i]), u32(key_lo[i]), salt), width);
        atomic_max_f32(nprio + b, valid[i] ? lane_prio[i] : 0.0f);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (!valid[i]) continue;
        const uint32_t hi = u32(key_hi[i]), lo = u32(key_lo[i]);
        const uint32_t b = gyt::range_map(gyt::mix64(hi, lo, salt), width);
        const float pr = lane_prio[i];
        if (pr == nprio[b] && pr > old[b]) {
            atomicMax(best + b, (static_cast<unsigned long long>(hi) << 32) | lo);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (!valid[i]) continue;
        const uint32_t hi = u32(key_hi[i]), lo = u32(key_lo[i]);
        const uint32_t b = gyt::range_map(gyt::mix64(hi, lo, salt), width);
        const float pr = lane_prio[i];
        if (pr == nprio[b] && pr > old[b] &&
            best[b] == ((static_cast<unsigned long long>(hi) << 32) | lo)) {
            const uint32_t f = gyt::mix64(hi, lo, kInvSaltFp);
            enc_hi[row + b] = hi ^ gyt::fmix32(f ^ kInvMaskHi);
            enc_lo[row + b] = lo ^ gyt::fmix32(f ^ kInvMaskLo);
            fp[row + b] = f;
        }
    }
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < width; b += blockDim.x) {
        prio[row + b] = nprio[b];
    }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int gyt_hll_update(int* regs, const long long* key_hi, const long long* key_lo,
                   const long long* row, const unsigned char* valid, int n, int p,
                   long long n_rows, void* stream) {
    gyt_hll_update_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        regs, key_hi, key_lo, row, valid, n, p, n_rows);
    return static_cast<int>(cudaGetLastError());
}

int gyt_cms_update(float* counts, const long long* key_hi, const long long* key_lo,
                   const float* vals, const unsigned char* valid, int n, int depth, int width,
                   void* stream) {
    gyt_cms_update_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        counts, key_hi, key_lo, vals, valid, n, depth, static_cast<uint32_t>(width));
    return static_cast<int>(cudaGetLastError());
}

int gyt_inv_update(float* prio, long long* enc_hi, long long* enc_lo, long long* fp,
                   const long long* key_hi, const long long* key_lo, const float* lane_prio,
                   const unsigned char* valid, int n, int depth, int width, void* stream) {
    const size_t smem = static_cast<size_t>(width) * (sizeof(unsigned long long) + sizeof(float));
    if (smem > 48 * 1024) {  // above the default, dynamic shared memory needs an opt-in
        int dev = 0, optin = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (smem > static_cast<size_t>(optin)) return -1;
        cudaFuncSetAttribute(gyt_inv_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    gyt_inv_update_kernel<<<depth, kInvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        prio, enc_hi, enc_lo, fp, key_hi, key_lo, lane_prio, valid, n,
        static_cast<uint32_t>(width));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
