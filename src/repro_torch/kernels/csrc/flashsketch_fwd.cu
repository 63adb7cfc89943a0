// FlashSketch forward, Y = S·A, and its gather-fused twin, Y = S·A[row_map],
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flashsketch.py:594 flashsketch_pallas, whose
// body is _fused_fwd_kernel (:231) with Φ from _phi_tile (:145), and
// flashsketch.py:642 flashsketch_pallas_gather, whose body is
// _fused_gather_kernel (:280).  Plain versions:
// repro_torch/kernels/ref.py:flashsketch_ref on the streamed operand, and on
// its materialized gather (ref.gather_rows).
//
// What it computes: for output block g, Y[g·Br + r, c] = scale ·
// Σ_ℓ Σ_u Σ_i [row(g, h_ℓ, u, i) = r] · sign(g, h_ℓ, u, i) · A[h_ℓ·Bc + u, c]
// with h_ℓ = π_ℓ(g) from the (κ, M) table, scale = 1/√(κs).  A streams in
// float, bf16, fp8 e4m3 or fp8 e5m2 (already quantized by the wrapper), is
// upcast to fp32 and summed in fp32.  Φ entries are ±1, so every product is
// exact and only the order of the sums differs from the TPU kernel.
//
// Bound on the H100: the kernel must read A once and write Y once,
// (d_pad·n·itemsize + k_pad·n·4) bytes at 3.35 TB/s; at the main plan
// (d_pad = 65 536, k_pad = 4 096, n = 1 024, fp32) that is about 85 µs.  The
// sums are κs adds per element of A, far below the fp32 rate: the kernel is
// bound by bytes.
//
// Design.  The TPU kernel holds the dense stacked Φ* (Br, κ·Bc) in VMEM; at
// the main plan that is 4 MiB, and a block here has at most 227 KB of shared
// memory.  So Φ* is never materialised: one block per (g, column tile j)
// hashes the compact form, one packed (row, sign) word per nonzero, for a
// chunk of `uc` columns u at a time, into shared memory.  Its threads then
// stream the rows h_ℓ·Bc + u of A, neighbouring threads on neighbouring
// columns (coalesced), and add ±a into an fp32 (Br, tn) accumulator in
// shared memory, with the next rows' loads in flight while the current ones
// are added.  threadIdx.x owns one column; threadIdx.y picks a subset of
// the s nonzero indices i, whose rows lie in disjoint chunks [i·Br/s,
// (i+1)·Br/s), so no two threads ever touch one accumulator word: no
// atomics, and the order of the sums is fixed.  Each output tile is written
// once, scaled.  The ragged n edge is masked.  Every block reads its κ input
// blocks itself, so A is read κ times in all (from L2 where it hits); the
// bound above counts it once, and the gap is the first target of later work
// (TMA loads, Φ shared across column tiles, wgmma on dense Φ tiles).
//
// Gather (the GraSS sparsify→sketch step, template flag kGather).  Row u of
// input block h is read from source row row_map[h·Bc + u] of A (d_src, n)
// instead of row h·Bc + u, so A[row_map] is never written.  The source rows
// of a chunk are staged in shared memory beside its hashed entries; rows
// h·Bc + u ≥ d (the padding of the masked dim) skip their load and add an
// exact zero, as a zero-padded materialized gather would.  Everything else,
// the order of the sums included, is the forward's, so on the card the
// gather equals the forward on the zero-padded A[row_map] bit for bit.  A
// is read through an explicit row and column stride: the per-example
// gradients come as (c, D) row-major and are sketched as the (D, c) view
// (row stride 1, column stride D) without a copy.  Bound: the d gathered
// rows read once plus Y written once.

#include "hash.cuh"

namespace {

constexpr int kUnroll = 16;

// Rows [uu, uu + kUnroll) of the current chunk in this thread's column
// `col`, zero past nu, past the ragged edge and, in the gather, for the
// padding rows (source row -1).  `row0` is the chunk's first row of A
// (forward); `src` holds the chunk's source rows (gather).
template <typename T, bool kGather>
__device__ __forceinline__ void load_rows(float (&a)[kUnroll], const T* col,
                                          long long rs, long long row0,
                                          const int* src, int uu, int nu,
                                          bool valid) {
#pragma unroll
  for (int t = 0; t < kUnroll; ++t) {
    const int v = uu + t;
    float x = 0.f;
    if (valid && v < nu) {
      if constexpr (kGather) {
        const int r = src[v];
        if (r >= 0) x = fs::to_f32(col[static_cast<long long>(r) * rs]);
      } else {
        x = fs::to_f32(col[(row0 + v) * rs]);
      }
    }
    a[t] = x;
  }
}

template <typename T, bool kGather>
__global__ void flashsketch_fwd_kernel(
    const T* __restrict__ A, float* __restrict__ Y, const int* __restrict__ tab,
    const int* __restrict__ row_map, int M, int Br, int Bc, int kappa, int s,
    long long n, long long rs, long long cs, int d, int d_src, uint32_t seed,
    float scale, int uc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  float* acc = reinterpret_cast<float*>(smem);               // (Br, tn)
  uint32_t* ent = reinterpret_cast<uint32_t*>(acc + Br * tn);  // (uc, s)
  int* src = reinterpret_cast<int*>(ent + uc * s);           // (uc) gather

  const int g = blockIdx.x;
  const int cl = threadIdx.x;
  const int q = threadIdx.y;
  const long long c = static_cast<long long>(blockIdx.y) * tn + cl;
  const bool valid = c < n;
  const int tid = q * tn + cl;
  const int nthreads = tn * groups;
  const uint32_t chunk = static_cast<uint32_t>(Br / s);
  const T* col = A + (valid ? c * cs : 0);

  for (int idx = tid; idx < Br * tn; idx += nthreads) acc[idx] = 0.f;

  for (int ell = 0; ell < kappa; ++ell) {
    const int h = tab[ell * M + g];
    const uint32_t prefix = fs::block_prefix(seed, g, h);
    for (int u0 = 0; u0 < Bc; u0 += uc) {
      const int nu = min(uc, Bc - u0);
      const long long row0 = static_cast<long long>(h) * Bc + u0;
      __syncthreads();  // the previous chunk's entries are consumed
      for (int e = tid; e < nu * s; e += nthreads) {
        const int uu = e / s;
        ent[e] = fs::entry(prefix, u0 + uu, e - uu * s, chunk);
      }
      if constexpr (kGather) {
        for (int e = tid; e < nu; e += nthreads) {
          int r = -1;               // padding: skip the load, add a zero
          if (row0 + e < d) {
            r = row_map[row0 + e];
            if (r < 0 || r >= d_src) __trap();   // a row outside A
          }
          src[e] = r;
        }
      }
      __syncthreads();
      // software pipeline: the next kUnroll rows are in flight while the
      // current ones are added into the accumulator
      float a[kUnroll], next[kUnroll];
      load_rows<T, kGather>(a, col, rs, row0, src, 0, nu, valid);
      for (int uu = 0; uu < nu; uu += kUnroll) {
        load_rows<T, kGather>(next, col, rs, row0, src, uu + kUnroll, nu,
                              valid);
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          if (uu + t >= nu) break;
          const uint32_t* row = ent + (uu + t) * s;
          for (int i = q; i < s; i += groups) {
            const uint32_t en = row[i];
            acc[(en >> 1) * tn + cl] += (en & 1u) ? -a[t] : a[t];
          }
        }
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) a[t] = next[t];
      }
    }
  }
  __syncthreads();
  if (!valid) return;
  float* dst = Y + static_cast<long long>(g) * Br * n + c;
  for (int r = q; r < Br; r += groups)
    dst[static_cast<long long>(r) * n] = acc[r * tn + cl] * scale;
}

template <typename T, bool kGather>
int launch(const void* A, void* Y, const void* tab, const void* row_map,
           int M, int Br, int Bc, int kappa, int s, long long n, long long rs,
           long long cs, int d, int d_src, unsigned int seed, float scale,
           int tn, int groups, int uc, int smem, void* stream) {
  auto kern = flashsketch_fwd_kernel<T, kGather>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M, static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(tab), static_cast<const int*>(row_map), M, Br,
      Bc, kappa, s, n, rs, cs, d, d_src, seed, scale, uc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Y (k_pad, n) fp32 = S · A (d_pad, n), both row-major and contiguous; tab
// is the (κ, M) int32 neighbour table on the device.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int fs_fwd(const void* A, void* Y, const void* tab, int dtype, int M, int Br,
           int Bc, int kappa, int s, long long n, unsigned int seed,
           float scale, int tn, int groups, int uc, int smem, void* stream) {
#define FS_LAUNCH(T)                                                        \
  launch<T, false>(A, Y, tab, nullptr, M, Br, Bc, kappa, s, n, n, 1, 0, 0,  \
                   seed, scale, tn, groups, uc, smem, stream)
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

// Y (k_pad, n) fp32 = S · A[row_map]: A (d_src, n) with row stride `rs` and
// column stride `cs` (in elements), row_map (d_pad,) int32 source rows of
// which the first d are read (a row outside [0, d_src) traps).  Otherwise
// as fs_fwd.
int fs_fwd_gather(const void* A, void* Y, const void* tab, const void* row_map,
                  int dtype, int M, int Br, int Bc, int kappa, int s,
                  long long n, long long rs, long long cs, int d, int d_src,
                  unsigned int seed, float scale, int tn, int groups, int uc,
                  int smem, void* stream) {
#define FS_LAUNCH(T)                                                         \
  launch<T, true>(A, Y, tab, row_map, M, Br, Bc, kappa, s, n, rs, cs, d,     \
                  d_src, seed, scale, tn, groups, uc, smem, stream)
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
