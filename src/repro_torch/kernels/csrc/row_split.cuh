// The row-split forward body, for Hopper (sm_90a): the gather-fused
// forward Y = S·A[row_map] (flashsketch_fwd.cu, fs_fwd_gather) and the v1
// forward Y = Σ_ℓ scale·Φ_{g,h_ℓ}A_{h_ℓ} (flashsketch_v1.cu, fs_fwd_v1),
// global plans included for v1.
//
// Why.  One block per (output block g, column tile j) left the card nearly
// empty where M·⌈n/tn⌉ is small: the GraSS chunk (M = 4, n = 64) launched 4
// blocks, each walking κ·Bc gathered rows one after another.  And the v1
// forward added every nonzero straight into Y in device memory, each add
// waiting on the previous read-add-write of the same word.  Splitting each
// output block's rows over R blocks fixes the first, but a block that still
// hashes every column of its κ input blocks to find the nonzeros that land
// in its rows repeats each hash R/s times (and ⌈n/tn⌉ times over the column
// tiles), and must sort what it finds by row; measured on the H100, that
// bookkeeping, not the data, set the time.
//
// So the nonzeros come from a CSR of S, built once per plan on the device
// from the same hashes (kernels/flashsketch.py:_device_csr, 4 bytes per
// nonzero) and kept beside the neighbour tables: for each output row, its
// nonzeros as (column << 1) | sign words, sorted by (ℓ, u); for a
// blockperm plan `ptr` holds κ offsets per row, one segment per level (and
// a final end), for a global plan one per row (the level of a global
// column is column / Bc).
//
// Grid (M·R, ⌈n/tn⌉): block (g, ρ) owns the rows [ρ·Br/R, (ρ+1)·Br/R) of
// output block g.  The gather's threads first copy the sub-range's nonzero
// words into shared memory, each column read through row_map there, once
// per block; then thread (c, q) sums the nonzeros of its rows q,
// q + G, … of column c, ±A[src, c], in a register, the loads of
// kUnrollNz of them in flight at once.  Neighbouring threads read
// neighbouring columns of A's row.  No atomics, nothing written but Y.
//
// Order of the sums.  Element (r, c) gets its adds in (ℓ, u) order, from
// +0, then × scale: the order of the fused forward (flashsketch_fwd_kernel),
// so the gather equals the forward on the zero-padded materialized gather
// bit for bit (a padding row adds an exact zero there; here it adds 0).
// v1 sums each level in its own register, in u order, kLevels levels side
// by side (independent chains, so their loads overlap), then adds them into
// the running output in ℓ order, run = run + L_ℓ·scale, as the reference's
// _fwd_kernel_v1 does; a global plan's levels come one after another in the
// row's column order, each folded when the next begins (a level with no
// nonzero in the row would add an exact zero, which changes no bit).
//
// Bound: each row of A read once (the gather: the d mapped rows) and Y
// written once.  The kernel reads A once per nonzero, κ·s times per row in
// all, from L2: the column tiles run one after another (blockIdx.y is the
// slow grid axis), so a tile's slice of A, d_pad·tn·4 bytes, stays in L2
// while every block that needs it runs.
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

}  // namespace fs
