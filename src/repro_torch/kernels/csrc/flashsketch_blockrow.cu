// The masked row-sharded FLASHBLOCKROW partial, for Hopper (sm_90a).
//
// Replaces: the masked body of src/repro/kernels/flashsketch.py:736
// flashsketch_pallas_partial, _partial_masked_kernel (:422), here
// blockrow_partial_kernel (see its note).  Plain version:
// repro_torch/kernels/ref.py:partial_ref.  (FLASHBLOCKROW's forward and
// gather, blockrow_pallas :711 and blockrow_pallas_gather :682, run the
// row-split bodies of row_split.cuh on S_row's CSR: flashsketch_fwd.cu.)
//
// What it computes (paper App. C): for output block g and ℓ < κ the input
// block is h_ℓ = tab[ℓ, g], an iid draw (ref.blockrow_wiring, tag 0xB10C),
// so two ℓ may pick the same h.  Row r of block g holds s nonzeros per ℓ,
// t < s: sign(g, h_ℓ, r, t) at column h_ℓ·Bc + col(g, h_ℓ, r, t), with the
// hash hash_words(seed, 0x5EED, g, h, r, t), col = hash mod Bc (a mask for
// a power-of-two Bc, a true modulo otherwise), sign bit 31.  A streams in
// float, bf16 or fp8, quantized by the wrapper, and is summed in fp32.

#include "hash.cuh"

namespace {

// Row-sharded FLASHBLOCKROW partials.  A rank owns the contiguous input
// blocks [lo, lo + M_loc) of the padded A, its slab.  The iid wiring is not a
// permutation, so there is no compact grid of owned pairs: block
// (p = ℓ·M + g, column tile) covers the full (κ, M) grid of the (3, κ, M)
// table [local block, global h, owned].  A pair another rank owns writes
// exact zeros; an owned pair sums, for each row r, Σ_t sign(g, h, r, t) ·
// A[local·Bc + col(g, h, r, t), c] in t order, unscaled, into row block p
// of the (κ, k_pad, n) output.  One thread per output element, with ℓ a
// grid axis: a pair's sum depends on neither the shard count nor the
// tile, so the partials
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
