// FlashSketch transpose, X = Sᵀ·Y, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flashsketch.py:619 flashsketch_transpose_pallas,
// whose body is _fused_transpose_kernel (:256) with the inverse wiring table
// _inv_neighbor_table (:100); for the global families (CountSketch, sparse
// graph) with Φ from _phi_global_tile (:165), here global_transpose_kernel
// (see its note).  Plain version:
// repro_torch/kernels/ref.py:flashsketch_transpose_ref on the streamed operand.
//
// What it computes: for input block h, X[h·Bc + u, c] = scale ·
// Σ_ℓ Σ_i sign(g_ℓ, h, u, i) · Y[g_ℓ·Br + row(g_ℓ, h, u, i), c] with
// g_ℓ = π_ℓ⁻¹(h) from the (κ, M) inverse table, scale = 1/√(κs).  Y streams
// in float, bf16, fp8 e4m3 or fp8 e5m2 (already quantized by the wrapper), is
// upcast to fp32 and summed in fp32; the products with ±1 are exact.
//
// Bound on the H100: the kernel must read Y once and write X once,
// (k_pad·n·itemsize + d_pad·n·4) bytes at 3.35 TB/s; at the main plan that is
// about 85 µs, almost all of it the write of X.  κs adds per element of X are
// far below the fp32 rate: the kernel is bound by bytes.
//
// Design.  A pure gather, with no race: one block per (h, column tile j)
// hashes the (row, sign) words of its κ·s nonzeros per column u once, for a
// chunk of `uc` columns at a time, into shared memory, and shares them with
// all its threads.  threadIdx.x owns one column c (neighbouring threads on
// neighbouring columns, so the write of each X row is coalesced);
// threadIdx.y strides over the rows u, each written exactly once.  The block
// gathers only from the κ row blocks g_ℓ of Y, so it first copies them,
// (κ·Br, tn), into shared memory (`staged`, whenever they fit) and gathers
// from there: left to the caches, the gathers ran at L2 latency, since the
// shared memory of the resident blocks leaves little L1.  Y itself (k_pad·n)
// stays in L2, so the copies cost little.  The ragged n edge is masked.

#include "hash.cuh"

namespace {

template <typename T, bool kStaged>
__global__ void flashsketch_transpose_kernel(
    const T* __restrict__ Yin, float* __restrict__ X,
    const int* __restrict__ itab, int M, int Br, int Bc, int kappa, int s,
    long long n, uint32_t seed, float scale, int uc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int ks = kappa * s;
  uint32_t* ent = reinterpret_cast<uint32_t*>(smem);  // (uc, κ, s)
  int* gs = reinterpret_cast<int*>(ent + uc * ks);    // (κ,)
  uint32_t* pre = reinterpret_cast<uint32_t*>(gs + kappa);  // (κ,)
  // (κ·Br, tn) tile of Y, 16-byte aligned after the tables
  T* tile = reinterpret_cast<T*>(smem +
                                 ((4 * (uc * ks + 2 * kappa) + 15) & ~15));

  const int hb = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * tn;
  const long long c = c0 + threadIdx.x;
  const bool valid = c < n;
  const int tid = threadIdx.y * tn + threadIdx.x;
  const int nthreads = tn * groups;
  const uint32_t chunk = static_cast<uint32_t>(Br / s);

  for (int ell = tid; ell < kappa; ell += nthreads) {
    gs[ell] = itab[ell * M + hb];
    pre[ell] = fs::block_prefix(seed, gs[ell], hb);
  }
  __syncthreads();
  if (kStaged) {
    // the block's κ row blocks of Y, (κ·Br, tn), in shared memory
    for (int idx = tid; idx < kappa * Br * tn; idx += nthreads) {
      const int row = idx / tn;
      const int col = idx - row * tn;
      const int ell = row / Br;
      if (c0 + col < n)
        tile[idx] = Yin[(static_cast<long long>(gs[ell]) * Br + row -
                         ell * Br) * n + c0 + col];
    }
  }
  // where the gathers read: the staged tile, or Y itself
  const T* ysrc = kStaged ? tile + threadIdx.x : Yin + c;
  const long long ystride = kStaged ? tn : n;

  for (int u0 = 0; u0 < Bc; u0 += uc) {
    const int nu = min(uc, Bc - u0);
    __syncthreads();  // the previous chunk's entries are consumed
    for (int e = tid; e < nu * ks; e += nthreads) {
      const int uu = e / ks;
      const int rem = e - uu * ks;
      const int ell = rem / s;
      const uint32_t en = fs::entry(pre[ell], u0 + uu, rem - ell * s, chunk);
      // packed with the row of the tile (ℓ·Br + row) or of Y (g·Br + row)
      const uint32_t base = static_cast<uint32_t>(kStaged ? ell : gs[ell]) * Br;
      ent[e] = en + (base << 1);
    }
    __syncthreads();
    if (!valid) continue;
    for (int uu = threadIdx.y; uu < nu; uu += groups) {
      const uint32_t* row = ent + uu * ks;
      float acc = 0.f;
#pragma unroll 8
      for (int e = 0; e < ks; ++e) {
        const uint32_t en = row[e];
        const float y = fs::to_f32(ysrc[static_cast<long long>(en >> 1) *
                                        ystride]);
        acc += (en & 1u) ? -y : y;
      }
      X[(static_cast<long long>(hb) * Bc + u0 + uu) * n + c] = acc * scale;
    }
  }
}

template <typename T>
int launch(const void* Yin, void* X, const void* itab, int M, int Br, int Bc,
           int kappa, int s, long long n, unsigned int seed, float scale,
           int tn, int groups, int uc, int staged, int smem, void* stream) {
  auto kern = staged ? flashsketch_transpose_kernel<T, true>
                     : flashsketch_transpose_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M, static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Yin), static_cast<float*>(X),
      static_cast<const int*>(itab), M, Br, Bc, kappa, s, n, seed, scale, uc);
  return static_cast<int>(cudaGetLastError());
}

// Global families (CountSketch, sparse graph): no loop over the M output
// blocks.  Column u of S has s nonzeros, at the global rows
// i·chunk + hash mod chunk (chunk = k_pad/s), so X[u, c] = scale ·
// Σ_i sign_i(u) · Y[row_i(u), c], summed over i in order, as
// ref._global_transpose_ref sums it.  One block per (chunk of `uc` rows u,
// column tile j) hashes the s words of each of its rows once into shared
// memory; threadIdx.x owns one column, threadIdx.y strides over the rows
// u, each written exactly once.  Y (k_pad·n) stays in L2.
//
// kPerLevel is the v1 transpose of a global plan
// (ref.flashsketch_transpose_v1_ref): the rows of column u lie in
// increasing output blocks ℓ = row / B_r; the rows of one block are summed,
// and the scaled sum is added, level by level.
template <typename T, bool kPerLevel>
__global__ void __launch_bounds__(1024)
global_transpose_kernel(
    const T* __restrict__ Yin, float* __restrict__ X, int Br, int s,
    long long n, int d_pad, int k_pad, uint32_t seed, float scale, int uc) {
  extern __shared__ __align__(16) uint32_t ents[];   // (uc, s)
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int u0 = blockIdx.x * uc;
  const int nu = min(uc, d_pad - u0);
  const long long c = static_cast<long long>(blockIdx.y) * tn + threadIdx.x;
  const int tid = threadIdx.y * tn + threadIdx.x;
  const int nthreads = tn * groups;
  const uint32_t chunk = static_cast<uint32_t>(k_pad / s);
  const uint32_t prefix = fs::global_prefix(seed);

  for (int e = tid; e < nu * s; e += nthreads) {
    const int uu = e / s;
    ents[e] = fs::global_entry(prefix, static_cast<uint32_t>(u0 + uu),
                               static_cast<uint32_t>(e - uu * s), chunk);
  }
  __syncthreads();
  if (c >= n) return;
  for (int uu = threadIdx.y; uu < nu; uu += groups) {
    const uint32_t* row = ents + uu * s;
    float acc = 0.f, part = 0.f;
    int cur = static_cast<int>((row[0] >> 1) / Br);
    for (int i = 0; i < s; ++i) {
      const uint32_t en = row[i];
      if constexpr (kPerLevel) {
        const int blk = static_cast<int>((en >> 1) / Br);
        if (blk != cur) {
          acc += scale * part;
          part = 0.f;
          cur = blk;
        }
      }
      const float y = fs::to_f32(Yin[static_cast<long long>(en >> 1) * n + c]);
      part += (en & 1u) ? -y : y;
    }
    X[static_cast<long long>(u0 + uu) * n + c] =
        kPerLevel ? acc + scale * part : part * scale;
  }
}

template <typename T>
int launch_global(const void* Yin, void* X, int Br, int s, long long n,
                  int d_pad, int k_pad, unsigned int seed, float scale,
                  int per_level, int tn, int groups, int uc, int smem,
                  void* stream) {
  auto kern = per_level ? global_transpose_kernel<T, true>
                        : global_transpose_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((d_pad + uc - 1) / uc),
                  static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Yin), static_cast<float*>(X), Br, s, n, d_pad,
      k_pad, seed, scale, uc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X (d_pad, n) fp32 = Sᵀ · Y (k_pad, n), both row-major and contiguous; itab
// is the (κ, M) int32 inverse neighbour table on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fs_transpose(const void* Yin, void* X, const void* itab, int dtype, int M,
                 int Br, int Bc, int kappa, int s, long long n,
                 unsigned int seed, float scale, int tn, int groups, int uc,
                 int staged, int smem, void* stream) {
#define FS_LAUNCH(T)                                                       \
  launch<T>(Yin, X, itab, M, Br, Bc, kappa, s, n, seed, scale, tn, groups, \
            uc, staged, smem, stream)
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

// Global families: X (d_pad, n) fp32 = Sᵀ · Y (k_pad, n), both row-major
// and contiguous, `uc` rows u per block; per_level != 0 sums as the v1
// transpose does (the fp32 stream only).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int fs_transpose_global(const void* Yin, void* X, int dtype, int Br, int s,
                        long long n, int d_pad, int k_pad, unsigned int seed,
                        float scale, int per_level, int tn, int groups, int uc,
                        int smem, void* stream) {
#define FS_LAUNCH(T)                                                        \
  launch_global<T>(Yin, X, Br, s, n, d_pad, k_pad, seed, scale, per_level,  \
                   tn, groups, uc, smem, stream)
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
