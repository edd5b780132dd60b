// 32-bit hashing shared by the fused sketch-update kernels (sketch_update.cu).
//
// Bit-exact counterparts of gyeeta_tpu_torch/utils/hashing.py (and of the
// reference's gyeeta_tpu/utils/hashing.py): every multiply and add is on
// uint32_t, so it wraps mod 2^32 as the Python versions' `& 0xFFFFFFFF` does.
// Written __host__ __device__ so that a host C++ compiler builds the same
// code (the CPU tests hold it against hashing.py without a GPU).

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define GYT_HD __host__ __device__ __forceinline__
#else
#define GYT_HD inline
#endif

namespace gyt {

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;  // 2^32 / phi: per-salt stream separator

// Murmur3 32-bit finalizer (hashing.fmix32).
GYT_HD uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= kC1;
    h ^= h >> 13;
    h *= kC2;
    h ^= h >> 16;
    return h;
}

// A 64-bit key as (hi, lo) halves → one uint32 on hash stream `salt`
// (hashing.mix64).
GYT_HD uint32_t mix64(uint32_t hi, uint32_t lo, uint32_t salt) {
    const uint32_t s = (salt + 1u) * kGolden;
    return fmix32(hi ^ fmix32(lo ^ s) ^ salt);
}

// Uniform uint32 → [0, n): the high half of the 64-bit product (Lemire;
// hashing._range_map).
GYT_HD uint32_t range_map(uint32_t h, uint32_t n) {
    return static_cast<uint32_t>((static_cast<uint64_t>(h) * n) >> 32);
}

// Count-Min row r's bucket by Kirsch-Mitzenmacher double hashing
// (hashing.bucket_indices_km): range_map(h1 + r*h2) with the sum wrapping
// mod 2^32; h1 = mix64(.., 0xC035), h2 = mix64(.., 0x51ED) | 1.
GYT_HD uint32_t km_bucket(uint32_t h1, uint32_t h2, uint32_t r, uint32_t n) {
    return range_map(h1 + r * h2, n);
}

constexpr uint32_t kKmSalt1 = 0xC035u;
constexpr uint32_t kKmSalt2 = 0x51EDu;

// Leading zeros of a uint32, 32 for 0 (hashing.leading_zeros32).
GYT_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __clz(static_cast<int>(x));
#else
    return x == 0 ? 32 : __builtin_clz(x);
#endif
}

// HyperLogLog register index and rank of hash h at precision p, 1 <= p <= 31
// (hyperloglog._idx_rank): the top p bits pick the register; the rank is the
// leading zeros of the remaining 32-p bits plus one, clamped to 32-p+1 when
// they are all zero.
GYT_HD uint32_t hll_index(uint32_t h, int p) { return h >> (32 - p); }

GYT_HD int hll_rank(uint32_t h, int p) {
    const int lz = clz32(h << p);
    return (lz < 32 - p ? lz : 32 - p) + 1;
}

}  // namespace gyt
