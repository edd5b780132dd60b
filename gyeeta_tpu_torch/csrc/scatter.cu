// Masked, warp-aggregated scatter-max and scatter-add over flat register
// files, several call sites in one launch, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of gyeeta_tpu/sketch/pallas_scatter.py:
//   _scatter_max_call (lines 71-86): out.flat[idx[i]] = max(out.flat[idx[i]], val[i])
//       int32 HLL registers and f32 priorities;
//   _scatter_add_call (lines 89-105): out.flat[idx[i]] += val[i]
//       f32 counts;
// and adds an int32 add for integer counters (the t-digest stage counts,
// which went through index_put_(accumulate=True): a sort, then a serial
// add over each run of duplicates). Every site updates its target in
// place, as the Pallas kernels do through input_output_aliases={2: 0}.
//
// A site is (target, row, col, stride, keep, val, n, op). Lane i writes
//   target.flat[row[i] * stride + col[i]]      (col null: + 0)
// only when keep[i] (keep null: always) and row[i] >= 0: a dropped lane
// writes nothing, JAX's mode="drop". A kept lane whose index lies outside
// the target traps (the launch fails) instead of writing out of bounds.
// The callers pass the lookup rows, columns and masks as they are: the
// index arithmetic and masking that used to be 5-7 elementwise launches a
// site happen here, in registers.
//
// What bounds it on the card: bytes, and at the fold path's sizes launch
// latency. A lane reads 12-21 B (row, col, keep, val) and each distinct
// target is read and written once: 4,096 lanes are ~60 KB, a few tens of
// nanoseconds at 3.35 TB/s, against ~2-3 us to launch anything. So the
// design spends nothing per lane that it can spend per target or per
// launch:
//   - one launch for up to kMaxSites sites: the grid's y picks the site,
//     its x the block of lanes (blocks past a site's lanes exit at once);
//   - every column of a lane read at once, so a lane waits for one memory
//     latency and not a chain of four (keep, row, col, val);
//   - warp aggregation: the kept lanes of a warp that share a target find
//     each other with __match_any_sync, combine their values in registers
//     by a pointer-jumping shuffle reduction over the group (max on
//     orderable keys, int32 or f32 sums), and the group's lowest lane
//     issues one global atomic (a red, its result unused). Where a warp's
//     lanes share targets (the delta loghist site: 4,096 lanes onto ~75
//     targets) that turns same-address atomics into one a group; where
//     they do not, a lone lane's group costs the match and no shuffle.
//     On an H100 (700 W, scatter_ab.py --captured) the match costs
//     0.18-0.32 us a launch against one atomic a lane at the fold path's
//     own sites, whose kept lanes rarely share a target; at a delta
//     dispatch's 4,096 CMS lanes onto 513 counters one atomic a lane takes
//     4.06 us and the aggregated kernel 1.72.
// Float atomics and the shuffle sum land in no fixed order, so f32 sums of
// non-integers may differ from a sequential sum in the low bits;
// integer-valued f32 sums below 2^24, every int32 sum (mod 2^32) and
// every max are exact in any order.
//
// Plain C interface, loaded with ctypes. The entry launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (-1 for a site list it does not take).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSites = 8;
constexpr unsigned kFullWarp = 0xffffffffu;

enum Op : int { kMaxI32 = 0, kMaxF32 = 1, kAddF32 = 2, kAddI32 = 3 };

}  // namespace

// One call site; the layout is sketch/scatter.py's _CSite.
struct GytScatterSite {
    void* out;                    // the target, indexed flat
    const void* row;              // (n,) int32 or int64: row, or flat index when col is null
    const int* col;               // (n,) int32 column, or null
    const unsigned char* keep;    // (n,) bool lane mask, or null
    const void* val;              // (n,) values of the target's dtype
    long long stride;             // elements a row
    long long n_out;              // elements of the target
    int n;                        // lanes
    int op;                       // Op
    int row64;                    // row is int64
};

namespace {

struct Sites {
    GytScatterSite s[kMaxSites];
};

// Combine v over the lanes of `peers` into the group's lowest lane: each
// member combines its successor's partial into its own and then points
// past it, so after ceil(log2(group size)) rounds the head holds the whole
// group's value. Every member runs the same number of rounds with the same
// mask; a lone lane (the common case at distinct targets) runs none.
// (__reduce_*_sync over many small groups of one warp costs ~1.8 us more a
// launch at an HLL site's 32,768 distinct lanes, scatter_ab.py.)
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
        if (has) {
            v = f(v, o);
            nxt = nn;
            has = nh;
        }
    }
    return v;
}

struct MaxU {
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a > b ? a : b; }
};
struct AddU {                                        // int32 sums wrap, as sequential ones do
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};
struct AddF {
    __device__ unsigned operator()(unsigned a, unsigned b) const {
        return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
    }
};

// Orderable keys: unsigned order of the key is the value's order. For f32
// it is the order the sign-split atomics below settle on (every negative,
// -0.0 included, below every non-negative; NaNs at the ends by their sign).
__device__ __forceinline__ unsigned i32_key(unsigned bits) { return bits ^ 0x80000000u; }
__device__ __forceinline__ unsigned f32_key(unsigned bits) {
    return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}
__device__ __forceinline__ unsigned f32_unkey(unsigned key) {
    return (key & 0x80000000u) ? key & 0x7fffffffu : ~key;
}

// f32 max through integer atomics, exact for every float: for a value with
// the sign bit clear, int order of the bits is float order and every
// stored negative float compares below it; for a value with the sign bit
// set, unsigned order of the bits is reverse float order.
__device__ __forceinline__ void atomic_max_f32(float* p, unsigned bits) {
    if (!(bits & 0x80000000u)) {
        atomicMax(reinterpret_cast<int*>(p), static_cast<int>(bits));
    } else {
        atomicMin(reinterpret_cast<unsigned*>(p), bits);
    }
}

__global__ void __launch_bounds__(kThreads) gyt_scatter_sites_kernel(const __grid_constant__ Sites sites) {
    const GytScatterSite& s = sites.s[blockIdx.y];
    if (static_cast<int>(blockIdx.x) * kThreads >= s.n) return;   // whole block past this site
    const int i = blockIdx.x * kThreads + threadIdx.x;
    // Every column of the lane is read at once, dropped or not: one memory
    // latency a lane instead of a chain of four (keep, then row, then col,
    // then val), which at these sizes is most of the kernel's time.
    bool on = false;
    long long r = 0;
    int c = 0;
    unsigned bits = 0;                               // the value, int32 or f32
    if (i < s.n) {
        const bool k = s.keep == nullptr || s.keep[i] != 0;
        r = s.row64 ? static_cast<const long long*>(s.row)[i]
                    : static_cast<long long>(static_cast<const int*>(s.row)[i]);
        c = s.col != nullptr ? s.col[i] : 0;
        bits = static_cast<const unsigned*>(s.val)[i];
        on = k && r >= 0;
    }
    const unsigned act = __ballot_sync(kFullWarp, on);
    if (!on) return;
    const long long flat = r * s.stride + c;
    if (static_cast<unsigned long long>(flat) >= static_cast<unsigned long long>(s.n_out)) __trap();
    const int tgt = static_cast<int>(flat);        // the wrapper keeps targets below 2^31
    const unsigned peers = __match_any_sync(act, tgt);
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    switch (s.op) {                                  // uniform over the block
        case kMaxI32: {
            const unsigned m = group_reduce(i32_key(bits), peers, lane, MaxU());
            if (leader) atomicMax(static_cast<int*>(s.out) + tgt, static_cast<int>(i32_key(m)));
            break;
        }
        case kAddI32: {
            const unsigned a = group_reduce(bits, peers, lane, AddU());
            if (leader) atomicAdd(static_cast<int*>(s.out) + tgt, static_cast<int>(a));
            break;
        }
        case kMaxF32: {
            const unsigned m = group_reduce(f32_key(bits), peers, lane, MaxU());
            if (leader) atomic_max_f32(static_cast<float*>(s.out) + tgt, f32_unkey(m));
            break;
        }
        default: {                                   // kAddF32
            const unsigned a = group_reduce(bits, peers, lane, AddF());
            if (leader) atomicAdd(static_cast<float*>(s.out) + tgt, __uint_as_float(a));
            break;
        }
    }
}

}  // namespace

extern "C" {

// Launch every site of `sites` (1..kMaxSites of them) in one kernel.
int gyt_scatter_sites(const GytScatterSite* sites, int n_sites, void* stream) {
    if (n_sites < 1 || n_sites > kMaxSites) return -1;
    Sites p{};
    int max_n = 0;
    for (int k = 0; k < n_sites; ++k) {
        const GytScatterSite& s = sites[k];
        if (s.op < kMaxI32 || s.op > kAddI32 || s.n < 0 || s.stride < 0 || s.n_out > INT_MAX) return -1;
        p.s[k] = s;
        max_n = s.n > max_n ? s.n : max_n;
    }
    if (max_n == 0) return 0;
    const dim3 grid((max_n + kThreads - 1) / kThreads, n_sites);
    gyt_scatter_sites_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
