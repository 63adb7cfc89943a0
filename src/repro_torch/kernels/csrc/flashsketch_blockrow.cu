// FLASHBLOCKROW forward, Y = S_row·A, and its gather-fused twin,
// Y = S_row·A[row_map], for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flashsketch.py:711 blockrow_pallas (body
// _fused_fwd_kernel :231 with Φ from _phi_rows_tile :190) and
// flashsketch.py:682 blockrow_pallas_gather (body _fused_gather_kernel
// :280); and the masked body of flashsketch.py:736
// flashsketch_pallas_partial, _partial_masked_kernel (:422), here
// blockrow_partial_kernel (see its note).  Plain versions:
// repro_torch/kernels/ref.py:blockrow_ref on the streamed operand, on its
// materialized gather (ref.gather_rows), and ref.partial_ref.
//
// What it computes (paper App. C): for output block g and ℓ < κ the input
// block is h_ℓ = tab[ℓ, g], an iid draw (ref.blockrow_wiring, tag 0xB10C),
// so two ℓ may pick the same h; their terms then add coherently, as in the
// reference.  Row r of block g holds s nonzeros per ℓ, t < s:
//   Y[g·Br + r, c] = scale · Σ_ℓ Σ_t sign(g, h_ℓ, r, t) ·
//                    A[h_ℓ·Bc + col(g, h_ℓ, r, t), c]
// with the hash hash_words(seed, 0x5EED, g, h, r, t), col = hash mod Bc (a
// mask for a power-of-two Bc, a true modulo otherwise), sign bit 31, and
// scale = 1/√(κs) · √(d_pad/k_pad).  A streams in float, bf16 or fp8,
// quantized by the wrapper, and is summed in fp32.
//
// Bound on the H100: the rows of A that some nonzero names, read once, plus
// Y written once, at 3.35 TB/s; κs adds per element of Y are far below the
// fp32 rate, so the kernel is bound by bytes.
//
// Design.  The pattern is per output row, so each output element is owned
// by one thread and no two threads write one word: no atomics, no shared
// accumulator.  One block per (g, column tile): its threads first hash the
// block's κ·Br·s nonzeros into shared memory, one word each holding the
// source row, a skip flag and the sign; threadIdx.x then owns one column
// (neighbouring threads on neighbouring columns, so loads and the store of
// each row are coalesced for a row-major A) and threadIdx.y strides over the
// rows r, summing over ℓ, then t, in fp32 in registers.  With kGather the
// source row is row_map[h·Bc + col]; rows h·Bc + col ≥ d (the padding of
// the masked dim) skip their load and add a signed zero, exactly what the
// zero row of a padded materialized gather adds, so gather and forward on
// the zero-padded A[row_map] agree bit for bit.  A is read through explicit
// row and column strides (the (D, c) view of the GraSS gradients needs no
// copy).  The ragged n edge is masked.

#include "hash.cuh"

namespace {

// Entry word: (source row << 2) | (skip << 1) | sign.
constexpr uint32_t kSkip = 2u;

template <typename T, bool kGather>
__global__ void blockrow_kernel(
    const T* __restrict__ A, float* __restrict__ Y, const int* __restrict__ tab,
    const int* __restrict__ row_map, int M, int Br, int Bc, int kappa, int s,
    long long n, long long rs, long long cs, int d, int d_src, uint32_t seed,
    float scale) {
  extern __shared__ __align__(16) uint32_t ent[];   // (κ, Br, s)
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int g = blockIdx.x;
  const int cl = threadIdx.x;
  const int q = threadIdx.y;
  const int tid = q * tn + cl;
  const int nthreads = tn * groups;
  const int per_ell = Br * s;

  for (int e = tid; e < kappa * per_ell; e += nthreads) {
    const int ell = e / per_ell;
    const int rem = e - ell * per_ell;
    const int r = rem / s;
    const int t = rem - r * s;
    const int h = tab[ell * M + g];
    const uint32_t w = fs::blockrow_entry(fs::blockrow_prefix(seed, g, h), r,
                                          t, Bc);
    const long long p = static_cast<long long>(h) * Bc + (w >> 1);
    uint32_t row = static_cast<uint32_t>(p), skip = 0u;
    if constexpr (kGather) {
      if (p < d) {
        const int src = row_map[p];
        if (src < 0 || src >= d_src) __trap();   // a row outside A
        row = static_cast<uint32_t>(src);
      } else {
        row = 0u;
        skip = kSkip;
      }
    }
    ent[e] = (row << 2) | skip | (w & 1u);
  }
  __syncthreads();

  const long long c = static_cast<long long>(blockIdx.y) * tn + cl;
  if (c >= n) return;
  const T* col = A + c * cs;
  float* dst = Y + static_cast<long long>(g) * Br * n + c;
  for (int r = q; r < Br; r += groups) {
    float sum = 0.f;
    for (int ell = 0; ell < kappa; ++ell) {
      const uint32_t* wr = ent + ell * per_ell + r * s;
      for (int t = 0; t < s; ++t) {
        const uint32_t w = wr[t];
        const float a =
            (w & kSkip) ? 0.f
                        : fs::to_f32(col[static_cast<long long>(w >> 2) * rs]);
        sum += (w & 1u) ? -a : a;
      }
    }
    dst[static_cast<long long>(r) * n] = sum * scale;
  }
}

template <typename T, bool kGather>
int launch(const void* A, void* Y, const void* tab, const void* row_map,
           int M, int Br, int Bc, int kappa, int s, long long n, long long rs,
           long long cs, int d, int d_src, unsigned int seed, float scale,
           int tn, int groups, int smem, void* stream) {
  auto kern = blockrow_kernel<T, kGather>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M, static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(tab), static_cast<const int*>(row_map), M, Br,
      Bc, kappa, s, n, rs, cs, d, d_src, seed, scale);
  return static_cast<int>(cudaGetLastError());
}

// Row-sharded FLASHBLOCKROW partials.  A rank owns the contiguous input
// blocks [lo, lo + M_loc) of the padded A, its slab.  The iid wiring is not a
// permutation, so there is no compact grid of owned pairs: block
// (p = ℓ·M + g, column tile) covers the full (κ, M) grid of the (3, κ, M)
// table [local block, global h, owned].  A pair another rank owns writes
// exact zeros; an owned pair sums, for each row r, Σ_t sign(g, h, r, t) ·
// A[local·Bc + col(g, h, r, t), c] in t order, unscaled, into row block p
// of the (κ, k_pad, n) output.  One thread per output element, as in
// blockrow_kernel, with ℓ a grid axis instead of a register loop: a pair's
// sum depends on neither the shard count nor the tile, so the partials
// summed over the ranks (one nonzero contributor per element) and folded in
// ℓ order are the same bits for every shard count (not the fused kernel's,
// which sums over ℓ in one register).  The block hashes its Br·s words into
// shared memory `chunk` rows at a time (chunk·s words, all Br rows where
// they fit), so every plan runs: a row's words never straddle two chunks,
// and its sum is the same in every chunking.  Bound: the slab rows some
// nonzero names, read once, plus the (κ, k_pad, n) output written once.
template <typename T>
__global__ void blockrow_partial_kernel(
    const T* __restrict__ A, float* __restrict__ Y, const int* __restrict__ tab,
    int M, int Br, int Bc, int kappa, int s, long long n, uint32_t seed,
    int chunk) {
  extern __shared__ __align__(16) uint32_t ent[];   // (chunk, s)
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int p = blockIdx.x;
  const int g = p % M;
  const int cl = threadIdx.x;
  const int q = threadIdx.y;
  const long long c = static_cast<long long>(blockIdx.y) * tn + cl;
  float* dst = Y + static_cast<long long>(p) * Br * n + c;
  if (tab[2 * kappa * M + p] == 0) {      // not owned: the whole block
    if (c < n)
      for (int r = q; r < Br; r += groups)
        dst[static_cast<long long>(r) * n] = 0.f;
    return;
  }
  const int local = tab[p];
  const int h = tab[kappa * M + p];
  const uint32_t prefix = fs::blockrow_prefix(seed, g, h);
  const T* col = A + c;
  for (int r0 = 0; r0 < Br; r0 += chunk) {
    const int rows = min(chunk, Br - r0);
    if (r0) __syncthreads();              // the last chunk's reads are done
    // entry word: (slab row << 1) | sign
    for (int e = q * tn + cl; e < rows * s; e += tn * groups) {
      const int r = e / s;
      const uint32_t w = fs::blockrow_entry(prefix, r0 + r, e - r * s, Bc);
      ent[e] = (static_cast<uint32_t>(local * Bc + (w >> 1)) << 1) | (w & 1u);
    }
    __syncthreads();
    if (c >= n) continue;
    for (int r = q; r < rows; r += groups) {
      float sum = 0.f;
      const uint32_t* wr = ent + r * s;
      for (int t = 0; t < s; ++t) {
        const uint32_t w = wr[t];
        const float a = fs::to_f32(col[static_cast<long long>(w >> 1) * n]);
        sum += (w & 1u) ? -a : a;
      }
      dst[static_cast<long long>(r0 + r) * n] = sum;
    }
  }
}

template <typename T>
int launch_partial(const void* A, void* Y, const void* tab, int M, int Br,
                   int Bc, int kappa, int s, long long n, unsigned int seed,
                   int tn, int groups, int smem, void* stream) {
  auto kern = blockrow_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = smem / (4 * s);
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kappa * M, static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(tab), M, Br, Bc, kappa, s, n, seed, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Y (k_pad, n) fp32 = S_row · A.  A is (d_pad, n) with row stride `rs` and
// column stride `cs` (elements); with gather != 0 it is (d_src, n) and row
// u < d of the masked input is source row row_map[u] (row_map (d_pad,)
// int32 on the device; a row outside [0, d_src) traps).  tab is the (κ, M)
// int32 iid wiring.  Launches on `stream` and returns cudaGetLastError() (0
// on success).
int fs_blockrow(const void* A, void* Y, const void* tab, const void* row_map,
                int gather, int dtype, int M, int Br, int Bc, int kappa, int s,
                long long n, long long rs, long long cs, int d, int d_src,
                unsigned int seed, float scale, int tn, int groups, int smem,
                void* stream) {
#define FS_LAUNCH(T)                                                         \
  (gather ? launch<T, true>(A, Y, tab, row_map, M, Br, Bc, kappa, s, n, rs,  \
                            cs, d, d_src, seed, scale, tn, groups, smem,     \
                            stream)                                          \
          : launch<T, false>(A, Y, tab, row_map, M, Br, Bc, kappa, s, n, rs, \
                             cs, d, d_src, seed, scale, tn, groups, smem,    \
                             stream))
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

// Row-sharded FLASHBLOCKROW partials: Y (κ, k_pad, n) fp32, unscaled, for
// a slab A (M_loc·Bc, n) of the padded input, both row-major and
// contiguous; tab is the (3, κ, M) int32 table [local block, global h,
// owned] on the device; smem = 4·chunk·s bytes holds the hashed words of
// `chunk` rows (1 ≤ chunk ≤ Br).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int fs_blockrow_partial(const void* A, void* Y, const void* tab, int dtype,
                        int M, int Br, int Bc, int kappa, int s, long long n,
                        unsigned int seed, int tn, int groups, int smem,
                        void* stream) {
#define FS_LAUNCH(T)                                                        \
  launch_partial<T>(A, Y, tab, M, Br, Bc, kappa, s, n, seed, tn, groups,   \
                    smem, stream)
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
