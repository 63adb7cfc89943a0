// Shared device helpers of the FlashSketch CUDA kernels.
//
// The hash is the uint32 murmur3/splitmix mix of repro_torch/core/hashing.py
// (and of the JAX package's repro/core/hashing.py), on native wrapping
// uint32 arithmetic.  The CPU tests hold the Python versions bit-equal to the
// JAX reference; the kernels are held to the plain PyTorch versions on the
// card by chip_smoke.py, where the exact S·I == S check fails on any
// differing hash bit.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace fs {

constexpr uint32_t kGamma = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t v) {
  const uint32_t vm = mix32(v + kGamma);
  return mix32(h ^ (vm + kGamma + (h << 6) + (h >> 2)));
}

// hash_mod of core/hashing.py: a mask for a power-of-two modulus, a true
// modulo otherwise.
__device__ __forceinline__ uint32_t hash_mod(uint32_t x, uint32_t m) {
  return (m & (m - 1)) == 0 ? (x & (m - 1)) : (x % m);
}

// hash_words(seed, g, h): the prefix shared by every nonzero of block (g, h).
__device__ __forceinline__ uint32_t block_prefix(uint32_t seed, uint32_t g,
                                                 uint32_t h) {
  return combine(combine(mix32(seed + kGamma), g), h);
}

// Nonzero i of column u of block (g, h), packed as (row << 1) | sign_bit
// with row = i·chunk + hash mod chunk in [0, Br) and sign bit 31 of the hash
// (1 means -1), as repro/core/blockperm.py:block_rows_signs defines them.
__device__ __forceinline__ uint32_t entry(uint32_t prefix, uint32_t u,
                                          uint32_t i, uint32_t chunk) {
  const uint32_t hs = combine(combine(prefix, u), i);
  return ((i * chunk + hash_mod(hs, chunk)) << 1) | (hs >> 31);
}

// FLASHBLOCKROW: hash_words(seed, 0x5EED, g, h), the prefix shared by every
// nonzero of block (g, h) (repro/kernels/ref.py:_phi_rows_all_blocks).
constexpr uint32_t kBlockRowTag = 0x5EEDu;

__device__ __forceinline__ uint32_t blockrow_prefix(uint32_t seed, uint32_t g,
                                                    uint32_t h) {
  return combine(combine(combine(mix32(seed + kGamma), kBlockRowTag), g), h);
}

// Nonzero t of row r of FLASHBLOCKROW block (g, h), packed as
// (col << 1) | sign_bit with col = hash mod Bc and sign bit 31 of the hash.
__device__ __forceinline__ uint32_t blockrow_entry(uint32_t prefix,
                                                   uint32_t r, uint32_t t,
                                                   uint32_t Bc) {
  const uint32_t hs = combine(combine(prefix, r), t);
  return (hash_mod(hs, Bc) << 1) | (hs >> 31);
}

// Global families (CountSketch, sparse graph): hash_words(seed, 0x610B,
// gcol, i), as repro/core/blockperm.py:global_rows_signs defines it.
constexpr uint32_t kGlobalTag = 0x610Bu;

__device__ __forceinline__ uint32_t global_prefix(uint32_t seed) {
  return combine(mix32(seed + kGamma), kGlobalTag);
}

// Nonzero i of global column gcol, packed as (row << 1) | sign_bit with the
// global row i·chunk + hash mod chunk in [0, k_pad), chunk = k_pad/s.
__device__ __forceinline__ uint32_t global_entry(uint32_t prefix,
                                                 uint32_t gcol, uint32_t i,
                                                 uint32_t chunk) {
  const uint32_t hs = combine(combine(prefix, gcol), i);
  return ((i * chunk + hash_mod(hs, chunk)) << 1) | (hs >> 31);
}

// The streamed element upcast to fp32 (exact for every streamed type).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// Streamed-type codes shared with kernels/flashsketch.py (_DTYPE_CODES).
enum StreamType : int { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

}  // namespace fs

#define FS_DISPATCH(code, LAUNCH)                              \
  switch (code) {                                              \
    case fs::kF32: return LAUNCH(float);                       \
    case fs::kBF16: return LAUNCH(__nv_bfloat16);              \
    case fs::kE4M3: return LAUNCH(__nv_fp8_e4m3);              \
    case fs::kE5M2: return LAUNCH(__nv_fp8_e5m2);              \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }
