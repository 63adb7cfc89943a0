// The row-split bodies, for Hopper (sm_90a): every forward, FLASHBLOCKROW
// and the v1 transpose read their sparse S (Sᵀ) from a CSR and sum each
// output element in registers.  The TPU launchers they replace are in
// src/repro/kernels/flashsketch.py.
//
//   * split_fwd_kernel: the gather-fused forward Y = S·A[row_map]
//     (flashsketch_fwd.cu, fs_fwd_gather; replaces flashsketch_pallas_gather
//     :642 with its global branch, Φ from _phi_global_tile :165, and
//     blockrow_pallas_gather :682, all with body _fused_gather_kernel :280)
//     and the v1 forward Y = Σ_ℓ scale·Φ_{g,h_ℓ}A_{h_ℓ} (flashsketch_v1.cu,
//     fs_fwd_v1), global plans included: one column per thread, scalar
//     loads through explicit strides (the gather's (D, c) view).
//   * split_vec_kernel: the fused forward Y = S·A (flashsketch_fwd.cu,
//     fs_fwd; replaces _fused_fwd_kernel :231 under the launchers
//     flashsketch_pallas :594, its global branch from _phi_global_tile
//     :165 included, and blockrow_pallas :711, Φ from _phi_rows_tile :190)
//     and the compact row-sharded partial (fs_fwd_partial; replaces
//     _partial_fwd_kernel :378, launcher flashsketch_pallas_partial :736)
//     and, in its masked mode, the masked FLASHBLOCKROW partial
//     (fs_blockrow_partial; replaces _partial_masked_kernel :422); the
//     fused transpose X = Sᵀ·Y of a plan whose staged tile does not fit
//     shared memory (its L2 route: fs_fwd on the CSR of Sᵀ, output blocks
//     of Bc rows; replaces flashsketch_transpose_pallas :619 there); in its
//     v1 mode the v1 transpose X = Σ_ℓ scale·Φᵀ Y of a blockperm
//     plan on a CSR of Sᵀ and the v1 FLASHBLOCKROW (flashsketch_v1.cu,
//     fs_transpose_v1 and fs_blockrow_v1; replace :905 and :927): 16-byte
//     loads of a contiguous A, 4 fp32 (8 bf16, 16 fp8) columns per thread.
//
// Why.  One block per (output block g, column tile j) left the card nearly
// empty where M·⌈n/tn⌉ is small: the GraSS chunk (M = 4, n = 64) launched 4
// blocks, each walking κ·Bc gathered rows one after another.  The fused
// forward of that grid also hashed Φ again in every block and every column
// tile, and added each nonzero into a (Br, tn) accumulator in shared memory
// (a read-modify-write per nonzero, and the shared memory that sent Br =
// 2 048 plans to v1 and a sharded Br = 2 048 plan to no kernel at all).  And
// the v1 forward added every nonzero straight into Y in device memory, each
// add waiting on the previous read-add-write of the same word.  Splitting
// each output block's rows over R blocks fixes the first, but a block that
// still hashes every column of its κ input blocks to find the nonzeros that
// land in its rows repeats each hash R/s times (and ⌈n/tn⌉ times over the
// column tiles), and must sort what it finds by row; measured on the H100,
// that bookkeeping, not the data, set the time.  The FLASHBLOCKROW kernel
// had the same grid (4 blocks at that chunk), hashed its block's κ·Br·s
// words into shared memory in every block and column tile (the shared
// memory that sent tall FLASHBLOCKROW plans to v1), and gave each thread
// one column of Br/groups rows in series; the global forward (CountSketch,
// sparse graph) hashed every column of A again in every column tile,
// compacted the nonzeros of its block with a block-wide ballot scan and
// added them into a (Br, tn) shared-memory accumulator.
//
// So the nonzeros come from a CSR, built once per plan on the device from
// the same hashes (kernels/flashsketch.py:_device_csr, 4 bytes per
// nonzero) and kept beside the neighbour tables: for each output row, its
// nonzeros as (column << 1) | sign words.  A blockperm plan's are sorted by
// (ℓ, u) and `ptr` holds κ offsets per row, one segment per level (and a
// final end); a global plan's are sorted by column (the level of a global
// column is column / Bc) and `ptr` holds one offset per row, so the kernels
// take 1 for κ (v1: kGlobal); FLASHBLOCKROW's S_row holds κ·s per row in
// (ℓ, t) order, κ offsets per row, not sorted by column, its collisions
// (two ℓ that draw one h, two t that hash to one column) kept as entries
// of their own; the v1 transpose's Sᵀ (_device_csr_t) holds, for row
// h·Bc + u of X, κ·s rows of Y in (ℓ, i) order, κ offsets per row (output
// blocks of Bc rows: the kernels take Bc for Br; the fused transpose's L2
// route sums a row's κ·s words in that order from +0, then × scale).
//
// Grid (M·R, ⌈n/tn⌉): block (g, ρ) owns the rows [ρ·Br/R, (ρ+1)·Br/R) of
// output block g.  The gather's threads first copy the sub-range's nonzero
// words into shared memory, each column read through row_map there, once
// per block (the others read the words where they lie: all the threads of
// a row read the same word, one request, and staging them measured no
// faster on the H100); then thread (c, q) sums the nonzeros of its rows q,
// q + G, … of its column(s) in registers, the loads of several nonzeros in
// flight at once.  Neighbouring threads read neighbouring columns of A's
// row.  No atomics, nothing written but Y.
//
// Order of the sums.  Element (r, c) gets its adds in its CSR order, from
// +0, then × scale: (ℓ, u) is the order of the port's first fused forward
// (a (Br, tn) shared-memory accumulator per (g, column tile), which this
// body replaced bit for bit); a global row's ascending columns are the
// (u, i) list order of the global kernel it replaced; FLASHBLOCKROW's
// (ℓ, t), × its own scale, that of its hashing kernel.  So the gather
// equals the forward on the zero-padded materialized gather bit for bit
// (a padding row adds an exact zero there; here it adds 0).  The partial
// sums level ℓ's segment alone, in u order from +0, unscaled: the same bits
// for every P, M_loc, tn and R, folded in ℓ order by
// distributed/sharded_apply.py; the masked partial sums level ℓ's segment
// of S_row in t order from +0, unscaled, the order of the hashing kernel it
// replaced.  v1 sums each level
// in its own register, in u order, kLevels levels side by side
// (independent chains, so their loads overlap), then adds them into the
// running output in ℓ order, run = run + L_ℓ·scale, as the reference's
// _fwd_kernel_v1 does; a global plan's levels come one after another in the
// row's column order, each folded when the next begins (a level with no
// nonzero in the row would add an exact zero, which changes no bit).
// split_vec_kernel's v1 mode folds the same way, run = fma(L_ℓ, scale,
// run), every level in turn: the (ℓ, i) and (ℓ, t) orders and the
// contracted fold of the hashing kernels it replaced.
//
// Bound: each row of A read once (the gather: the d mapped rows; the
// partial: the slab; FLASHBLOCKROW: the rows some nonzero names) and Y
// written once.  The kernels read A once per
// nonzero, κ·s times per row in all, from L2: the column tiles run one
// after another (blockIdx.y is the slow grid axis), so a tile's slice of A,
// d_pad·tn·itemsize bytes, stays in L2 while every block that needs it
// runs; the forward's tile is sized so that slice fits L2 beside the CSR
// (kernels/flashsketch.py:fwd_tn).  What is left is L2's rate for κ·s reads
// of every element of A; split_vec_kernel pays each CSR word and its
// address arithmetic once per 16 bytes of A instead of once per element,
// and a warp's request covers 256-512 contiguous bytes.
#pragma once

#include "hash.cuh"

namespace fs {

constexpr int kUnrollNz = 16;  // nonzeros whose loads are in flight at once
constexpr int kLevels = 4;     // v1 levels summed side by side
constexpr int kPerLevel = 2;   // and nonzeros of each in flight at once

// ptr: blockperm, κ offsets per row (level segments) and a final end, so row
// r's nonzeros are [ptr[r·κ], ptr[(r+1)·κ]); global, one offset per row.
// Shared memory (the gather): the block's nonzeros, `cap` ints (the most
// any block of this plan and split has), their columns read through
// row_map.
template <typename T, bool kGather, bool kV1, bool kGlobal>
__global__ void __launch_bounds__(512)
split_fwd_kernel(const T* __restrict__ A, float* __restrict__ Y,
                 const int* __restrict__ ptr, const int* __restrict__ ent,
                 const int* __restrict__ row_map, int Br, int Bc, int kappa,
                 long long n, long long rs, long long cs, int d, int d_src,
                 float scale, int R) {
  extern __shared__ int nz[];
  const int tn = blockDim.x;
  const int G = blockDim.y;
  const int cl = threadIdx.x;
  const int q = threadIdx.y;
  const int tid = q * tn + cl;
  const int br = Br / R;                       // rows of the sub-range
  const int g = blockIdx.x / R;
  const int rho = blockIdx.x - g * R;
  const long long c = static_cast<long long>(blockIdx.y) * tn + cl;
  const long long row0 =
      static_cast<long long>(g) * Br + static_cast<long long>(rho) * br;
  const int stride = kGlobal ? 1 : kappa;      // ptr entries per row

  // the gather: the block's nonzeros, in CSR order, staged by every thread
  // with their columns read through row_map, (source row << 1) | sign, -1
  // for a padding row; v1 reads the plan's words where they lie
  const int base = kGather ? ptr[row0 * stride] : 0;
  const int* nzw = ent;
  if constexpr (kGather) {
    const int count = ptr[(row0 + br) * stride] - base;
    for (int i = tid; i < count; i += tn * G) {
      const int w = ent[base + i];
      const int col = w >> 1;
      int sw = -1;                             // padding: an exact zero
      if (col < d) {
        const int sr = row_map[col];
        if (sr < 0 || sr >= d_src) __trap();   // a row outside A
        sw = (sr << 1) | (w & 1);
      }
      nz[i] = sw;
    }
    __syncthreads();
    nzw = nz;
  }
  if (c >= n) return;                          // no barriers below
  const T* col = A + c * cs;                   // this thread's column

  for (int r = q; r < br; r += G) {
    const long long row = row0 + r;
    float out;
    if constexpr (kV1 && !kGlobal) {
      // the κ level segments of the row, kLevels side by side
      float run = 0.f;
      for (int l0 = 0; l0 < kappa; l0 += kLevels) {
        int e[kLevels], end[kLevels];
        float L[kLevels];
#pragma unroll
        for (int j = 0; j < kLevels; ++j) {
          e[j] = end[j] = 0;
          L[j] = 0.f;
          if (l0 + j < kappa) {
            e[j] = ptr[row * stride + l0 + j] - base;
            end[j] = ptr[row * stride + l0 + j + 1] - base;
          }
        }
        bool more = true;
        while (more) {
          more = false;
          int w[kLevels][kPerLevel];
          float v[kLevels][kPerLevel];
#pragma unroll
          for (int j = 0; j < kLevels; ++j)
#pragma unroll
            for (int k = 0; k < kPerLevel; ++k) {
              w[j][k] = e[j] + k < end[j] ? nzw[e[j] + k] : -1;
              v[j][k] = w[j][k] < 0 ? 0.f
                                    : to_f32(col[static_cast<long long>(
                                                     w[j][k] >> 1) * rs]);
            }
#pragma unroll
          for (int j = 0; j < kLevels; ++j)
#pragma unroll
            for (int k = 0; k < kPerLevel; ++k)
              if (e[j] < end[j]) {
                L[j] += (w[j][k] & 1) ? -v[j][k] : v[j][k];
                ++e[j];
                more = true;
              }
        }
#pragma unroll
        for (int j = 0; j < kLevels; ++j)
          if (l0 + j < kappa) run += L[j] * scale;
      }
      out = run;
    } else {
      const int beg = ptr[row * stride] - base;
      const int end = ptr[(row + 1) * stride] - base;
      float a = 0.f;
      float run = 0.f;
      int cur = -1;                            // kV1 && kGlobal: the level
      for (int e0 = beg; e0 < end; e0 += kUnrollNz) {
        int w[kUnrollNz];
        float v[kUnrollNz];
#pragma unroll
        for (int k = 0; k < kUnrollNz; ++k) {
          w[k] = e0 + k < end ? nzw[e0 + k] : -1;
          v[k] = w[k] < 0 ? 0.f
                          : to_f32(col[static_cast<long long>(w[k] >> 1) * rs]);
        }
#pragma unroll
        for (int k = 0; k < kUnrollNz; ++k) {
          if (e0 + k >= end) break;
          if constexpr (kV1) {                  // a global plan's levels
            const int lv = (w[k] >> 1) / Bc;
            if (lv != cur) {
              run += a * scale;
              a = 0.f;
              cur = lv;
            }
          }
          a += (w[k] & 1) ? -v[k] : v[k];
        }
      }
      out = kV1 ? run + a * scale : a * scale;
    }
    Y[row * n + c] = out;
  }
}

template <typename T, bool kGather, bool kV1, bool kGlobal>
int launch_split(const void* A, void* Y, const void* ptr, const void* ent,
                 const void* row_map, int M, int Br, int Bc, int kappa,
                 long long n, long long rs, long long cs, int d, int d_src,
                 float scale, int tn, int groups, int R, int cap,
                 void* stream) {
  auto kern = split_fwd_kernel<T, kGather, kV1, kGlobal>;
  const int smem = kGather ? 4 * cap : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)   // the rest of the SM's 256 KB to L1, for A
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(M * R),
                  static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(ptr), static_cast<const int*>(ent),
      static_cast<const int*>(row_map), Br, Bc, kappa, n, rs, cs, d, d_src,
      scale, R);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The fused forward and the compact partial: 16-byte loads.
// ---------------------------------------------------------------------------

constexpr int kUnrollVec = 8;  // nonzeros whose 16-byte loads are in flight

// Element j of a 16-byte vector of T (j a constant once unrolled), upcast
// to fp32 exactly.
__device__ __forceinline__ uint32_t word_of(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
template <typename T>
__device__ __forceinline__ float unpack(const uint4& r, int j);
template <>
__device__ __forceinline__ float unpack<float>(const uint4& r, int j) {
  return __uint_as_float(word_of(r, j));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint4& r,
                                                       int j) {
  const uint32_t w = word_of(r, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}
template <typename F8>
__device__ __forceinline__ float unpack_fp8(const uint4& r, int j) {
  F8 x;
  x.__x = static_cast<__nv_fp8_storage_t>(
      (word_of(r, j >> 2) >> (8 * (j & 3))) & 0xFFu);
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float unpack<__nv_fp8_e4m3>(const uint4& r,
                                                       int j) {
  return unpack_fp8<__nv_fp8_e4m3>(r, j);
}
template <>
__device__ __forceinline__ float unpack<__nv_fp8_e5m2>(const uint4& r,
                                                       int j) {
  return unpack_fp8<__nv_fp8_e5m2>(r, j);
}

// split_vec_kernel's v1 mode: fold the finished level's sum acc into the
// running output, run = fma(L, scale, run), and start the next from +0.
template <int kV>
__device__ __forceinline__ void v1_fold(float (&acc)[kV], float (&run)[kV],
                                        float scale) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    run[j] = fmaf(acc[j], scale, run[j]);
    acc[j] = 0.f;
  }
}

// Before entry e of a row is added: fold, in ℓ order, every level that
// ends at or before e (level lvl ends at entry bnd; lptr is the row's κ
// offsets and the next row's first).  e < the row's end, so lvl stays below
// the row's last level.
template <int kV>
__device__ __forceinline__ void v1_enter(int e, int& lvl, int& bnd,
                                         float (&acc)[kV], float (&run)[kV],
                                         const int* __restrict__ lptr,
                                         float scale) {
  while (e >= bnd) {
    v1_fold(acc, run, scale);
    ++lvl;
    bnd = lptr[lvl + 1];
  }
}

// A contiguous (rows, n) A; thread (x, q) of block (p, ρ), column tile j
// owns the kV = 16/sizeof(T) columns c0 = (j·blockDim.x + x)·kV … and the
// rows q, q + G, … of the sub-range.  Forward (kPartial false): p = g, the
// row's κ level segments, ×scale, into row block g of Y (M·Br, n).
// Partial: p = ℓ·M + m indexes the (2, κ, M) table [g, h] of the owned
// pairs (M is M_loc), the row of g sums level ℓ's segment only, each column
// word read as slab row col + (m − h)·Bc, into row block p of the compact
// (κ, M·Br, n) output, scale 1.  kMasked (with kPartial: the masked
// FLASHBLOCKROW partial): p = ℓ·M + g runs over the full (3, κ, M) table
// [local block, global h, owned] (M is the plan's), the row of g sums level
// ℓ's segment of S_row's CSR, each word read as slab row
// col + (local − h)·Bc, into row block p of the (κ, k_pad, n) output; a pair
// another rank owns sums nothing and writes exact zeros.  kV1 (the v1
// transpose and FLASHBLOCKROW,
// fp32): each level's segment summed in its own registers from +0, folded
// into the running output in ℓ order, run = fma(L, scale, run), empty
// levels included, and run written as it is; the loads of a chunk of
// kUnrollVec nonzeros stay in flight across the levels' boundaries (a
// row's segments are contiguous).  `vec` says 16-byte loads are aligned
// (n % kV == 0 and A 16-byte aligned); a thread past the ragged edge or
// with vec false loads its columns one by one.
template <typename T, bool kPartial, bool kV1, bool kMasked = false>
__global__ void __launch_bounds__(512)
split_vec_kernel(const T* __restrict__ A, float* __restrict__ Y,
                 const int* __restrict__ ptr, const int* __restrict__ ent,
                 const int* __restrict__ tab, int M, int Br, int Bc,
                 int kappa, long long n, float scale, int R, int vec) {
  static_assert(!(kPartial && kV1), "v1 has no partial");
  static_assert(kPartial || !kMasked, "the masked mode is a partial");
  constexpr int kV = 16 / sizeof(T);
  const int G = blockDim.y;
  const int q = threadIdx.y;
  const int br = Br / R;
  const int p = blockIdx.x / R;
  const int rho = blockIdx.x - p * R;
  int g = p, lo = 0, hi = kappa;
  long long off = 0;                      // column word -> row of A
  [[maybe_unused]] bool owned = true;
  if constexpr (kPartial) {
    const int ell = p / M;
    if constexpr (kMasked) {
      g = p - ell * M;
      owned = tab[2 * kappa * M + p] != 0;
      off = static_cast<long long>(tab[p] - tab[kappa * M + p]) * Bc;
    } else {
      g = tab[p];
      off = static_cast<long long>(p - ell * M - tab[kappa * M + p]) * Bc;
    }
    lo = ell;
    hi = ell + 1;
  }
  const long long row0 =
      static_cast<long long>(g) * Br + static_cast<long long>(rho) * br;
  const long long out0 =
      static_cast<long long>(p) * Br + static_cast<long long>(rho) * br;
  const long long c0 =
      (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * kV;
  if (c0 >= n) return;
  const bool full = vec && c0 + kV <= n;

  for (int r = q; r < br; r += G) {
    const long long row = row0 + r;
    int beg = 0, end = 0;                 // an unowned pair: exact zeros
    if (!kMasked || owned) {
      beg = ptr[row * kappa + lo];
      end = ptr[row * kappa + hi];
    }
    float acc[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[j] = 0.f;
    // kV1: the levels folded so far, acc's level and the entry it ends at
    [[maybe_unused]] float run[kV];
    [[maybe_unused]] int lvl = 0, bnd = 0;
    if constexpr (kV1) {
#pragma unroll
      for (int j = 0; j < kV; ++j) run[j] = 0.f;
      lvl = lo;
      bnd = ptr[row * kappa + lo + 1];
    }
    for (int e0 = beg; e0 < end; e0 += kUnrollVec) {
      int w[kUnrollVec];
#pragma unroll
      for (int k = 0; k < kUnrollVec; ++k)
        w[k] = e0 + k < end ? __ldg(ent + e0 + k) : 0;
      if (full) {
        uint4 v[kUnrollVec];
#pragma unroll
        for (int k = 0; k < kUnrollVec; ++k)
          v[k] = e0 + k < end
                     ? __ldg(reinterpret_cast<const uint4*>(
                           A + ((w[k] >> 1) + off) * n + c0))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < kUnrollVec; ++k) {
          if (e0 + k >= end) break;
          if constexpr (kV1)
            v1_enter(e0 + k, lvl, bnd, acc, run, ptr + row * kappa, scale);
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            const float a = unpack<T>(v[k], j);
            acc[j] += (w[k] & 1) ? -a : a;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kUnrollVec; ++k) {
          if (e0 + k >= end) break;
          if constexpr (kV1)
            v1_enter(e0 + k, lvl, bnd, acc, run, ptr + row * kappa, scale);
          const T* src = A + ((w[k] >> 1) + off) * n;
#pragma unroll
          for (int j = 0; j < kV; ++j)
            if (c0 + j < n) {
              const float a = to_f32(src[c0 + j]);
              acc[j] += (w[k] & 1) ? -a : a;
            }
        }
      }
    }
    if constexpr (kV1) {
      // the last level and any empty ones after it; run is written × 1,
      // which is exact
      for (; lvl < hi; ++lvl) v1_fold(acc, run, scale);
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[j] = run[j];
    }
    const float mul = kV1 ? 1.f : scale;
    float* dst = Y + (out0 + r) * n + c0;
    if (full && kV % 4 == 0) {
#pragma unroll
      for (int j = 0; j < kV; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(acc[j] * mul, acc[j + 1] * mul, acc[j + 2] * mul,
                        acc[j + 3] * mul);
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j)
        if (c0 + j < n) dst[j] = acc[j] * mul;
    }
  }
}

// The forward (kPartial false), the partial (kMasked: the masked one), or
// v1's (kV1): grid (blocks·R, ⌈n/tn⌉), blocks M, or κ·M for a partial,
// block (tn·sizeof(T)/16, groups), no shared memory.
template <typename T, bool kPartial, bool kV1 = false, bool kMasked = false>
int launch_vec(const void* A, void* Y, const void* ptr, const void* ent,
               const void* tab, int M, int Br, int Bc, int kappa, long long n,
               float scale, int tn, int groups, int R, int vec,
               void* stream) {
  auto kern = split_vec_kernel<T, kPartial, kV1, kMasked>;
  const int tx = tn * static_cast<int>(sizeof(T)) / 16;
  const int blocks = kPartial ? kappa * M : M;
  const dim3 grid(static_cast<unsigned int>(blocks * R),
                  static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tx, groups);
  kern<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(ptr), static_cast<const int*>(ent),
      static_cast<const int*>(tab), M, Br, Bc, kappa, n, scale, R, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fs
