// FlashSketch v1 kernels, the output-revisiting formulation, for Hopper
// (sm_90a): the forward Y = S·A, the transpose X = Sᵀ·Y and FLASHBLOCKROW
// Y = S_row·A, fp32 only.
//
// Replaces: src/repro/kernels/flashsketch.py:883 flashsketch_pallas_v1,
// :905 flashsketch_transpose_pallas_v1 and :927 blockrow_pallas_v1, whose
// bodies are _fwd_kernel_v1 (:824), _transpose_kernel_v1 (:844) and
// _blockrow_kernel_v1 (:864), all launched by _run_v1 (:473, pallas_call at
// :490); the forward and transpose with Φ from _phi_tile (:145) or, for the
// global families, _phi_global_tile (:165).  Plain versions:
// repro_torch/kernels/ref.py:flashsketch_v1_ref, flashsketch_transpose_v1_ref
// and blockrow_v1_ref.
//
// What they compute: the same S as the fused kernels, summed as v1 sums it.
// The TPU grid (⌈n/tn⌉, M, κ) visits output block g once per level ℓ, in
// order, and adds that level's contribution, already scaled, into the
// fp32 output: Y_g = Σ_ℓ scale · Φ_{g,h_ℓ} A_{h_ℓ}.  The wrapper has already
// rounded the operand through the plan's streaming precision and upcast it
// to fp32 (the reference's stream contract for v1).
//
// Bound on the H100: each input read once and each output written once at
// 3.35 TB/s (about 85 µs at d_pad = 65 536, k_pad = 4 096, n = 1 024); the
// κs adds per element are far below the fp32 rate, so all three are bound
// by bytes.  v1 is the baseline, not the fast path: what it buys is a
// working set that does not grow with B_r.
//
// Design.  A CUDA grid has no order, so the κ revisits are not grid steps:
// one block owns (column tile j, output block g) and walks ℓ = 0..κ-1
// itself.
//
//  * Forward.  The row-split body of row_split.cuh (redesigned: it added
//    every nonzero's scale·(±a) straight into Y in device memory, each add
//    waiting on the read-add-write before it).  Block (g, ρ, j) owns the
//    rows [ρ·B_r/R, (ρ+1)·B_r/R) of output block g in column tile j and
//    holds two fp32 tiles of them in shared memory: the current level's
//    sum, in (u, i) order, and the running output, to which each finished
//    level is added scaled, as the reference adds it; Y is written once.
//    R splits the block so that the tiles fit shared memory for any B_r
//    (B_r = 2 048 is what the lowering sends here) and the grid fills the
//    card.  Global plans (h_ℓ = ℓ) keep only the nonzeros whose global row
//    lands in the sub-range, compacted in (u, i) order.
//  * Transpose.  A pure gather: per column u of input block hb the block
//    hashes the κ·s words once into shared memory; thread (c, q) walks ℓ
//    (g = π_ℓ⁻¹(hb)), sums the s rows of Y of that level and adds the
//    scaled sum.  Global plans run the global transpose of
//    flashsketch_transpose.cu with its per-level flag, which groups the s
//    rows of each u by the output block they fall in (ℓ = row / B_r,
//    increasing in i).
//  * FLASHBLOCKROW.  One thread per output element, as the fused kernel:
//    it walks ℓ and the s per-row nonzeros (hash tag 0x5EED, iid wiring
//    0xB10C), and adds each level's scaled sum.

#include "row_split.cuh"

namespace {

// Transpose, blockperm plans: grid (⌈n/tn⌉, M).
__global__ void __launch_bounds__(1024)
transpose_v1_kernel(
    const float* __restrict__ Yin, float* __restrict__ X,
    const int* __restrict__ itab, int M, int Br, int Bc, int kappa, int s,
    long long n, uint32_t seed, float scale, int uc) {
  extern __shared__ __align__(16) uint32_t ent[];   // (uc, κ, s)
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int ks = kappa * s;
  int* gs = reinterpret_cast<int*>(ent + uc * ks);   // (κ,)
  uint32_t* pre = reinterpret_cast<uint32_t*>(gs + kappa);   // (κ,)

  const int hb = blockIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * tn + threadIdx.x;
  const bool valid = c < n;
  const int tid = threadIdx.y * tn + threadIdx.x;
  const int nthreads = tn * groups;
  const uint32_t chunk = static_cast<uint32_t>(Br / s);

  for (int ell = tid; ell < kappa; ell += nthreads) {
    gs[ell] = itab[ell * M + hb];
    pre[ell] = fs::block_prefix(seed, gs[ell], hb);
  }
  __syncthreads();
  for (int u0 = 0; u0 < Bc; u0 += uc) {
    const int nu = min(uc, Bc - u0);
    __syncthreads();  // the previous chunk's words are consumed
    for (int e = tid; e < nu * ks; e += nthreads) {
      const int uu = e / ks;
      const int rem = e - uu * ks;
      const int ell = rem / s;
      const uint32_t en = fs::entry(pre[ell], u0 + uu, rem - ell * s, chunk);
      // packed with the row of Y, g·Br + row
      ent[e] = en + ((static_cast<uint32_t>(gs[ell]) * Br) << 1);
    }
    __syncthreads();
    if (!valid) continue;
    for (int uu = threadIdx.y; uu < nu; uu += groups) {
      const uint32_t* row = ent + uu * ks;
      float acc = 0.f;
      for (int ell = 0; ell < kappa; ++ell) {
        float part = 0.f;
        for (int i = 0; i < s; ++i) {
          const uint32_t en = row[ell * s + i];
          const float y = Yin[static_cast<long long>(en >> 1) * n + c];
          part += (en & 1u) ? -y : y;
        }
        acc += scale * part;
      }
      X[(static_cast<long long>(hb) * Bc + u0 + uu) * n + c] = acc;
    }
  }
}

// FLASHBLOCKROW: grid (⌈n/tn⌉, M), one thread per output element.
__global__ void __launch_bounds__(1024)
blockrow_v1_kernel(
    const float* __restrict__ A, float* __restrict__ Y,
    const int* __restrict__ tab, int M, int Br, int Bc, int kappa, int s,
    long long n, uint32_t seed, float scale) {
  extern __shared__ __align__(16) int hs[];          // (κ,)
  uint32_t* pre = reinterpret_cast<uint32_t*>(hs + kappa);   // (κ,)
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  const int g = blockIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * tn + threadIdx.x;
  const int tid = threadIdx.y * tn + threadIdx.x;

  for (int ell = tid; ell < kappa; ell += tn * groups) {
    hs[ell] = tab[ell * M + g];
    pre[ell] = fs::blockrow_prefix(seed, g, hs[ell]);
  }
  __syncthreads();
  if (c >= n) return;
  for (int r = threadIdx.y; r < Br; r += groups) {
    float acc = 0.f;
    for (int ell = 0; ell < kappa; ++ell) {
      const float* blk = A + static_cast<long long>(hs[ell]) * Bc * n + c;
      float part = 0.f;
      for (int t = 0; t < s; ++t) {
        const uint32_t w = fs::blockrow_entry(pre[ell], r, t, Bc);
        const float a = blk[static_cast<long long>(w >> 1) * n];
        part += (w & 1u) ? -a : a;
      }
      acc += scale * part;
    }
    Y[(static_cast<long long>(g) * Br + r) * n + c] = acc;
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kern, dim3 grid, dim3 block, int smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

unsigned int tiles(long long n, int tn) {
  return static_cast<unsigned int>((n + tn - 1) / tn);
}

}  // namespace

extern "C" {

// Y (k_pad, n) fp32 = S · A (d_pad, n) fp32, both row-major and contiguous;
// S comes as the plan's CSR (ptr, ent: see row_split.cuh), level segments
// per row for a blockperm plan, the κ = M levels of a global plan told apart
// by column.  The row-split body: grid (M·R, ⌈n/tn⌉), block (tn, groups).
// The integers come in one array, p = {global, M, Br, Bc, κ, n, tn, groups,
// R}, built once per launch shape by the caller.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int fs_fwd_v1(const void* A, void* Y, const void* ptr, const void* ent,
              const long long* p, float scale, void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const long long n = p[5];
  const int tn = static_cast<int>(p[6]), groups = static_cast<int>(p[7]);
  const int R = static_cast<int>(p[8]);
  const int d_pad = M * Bc;
  if (p[0])
    return fs::launch_split<float, false, true, true>(
        A, Y, ptr, ent, nullptr, M, Br, Bc, kappa, n, n, 1, d_pad, d_pad,
        scale, tn, groups, R, 0, stream);
  return fs::launch_split<float, false, true, false>(
      A, Y, ptr, ent, nullptr, M, Br, Bc, kappa, n, n, 1, d_pad, d_pad, scale,
      tn, groups, R, 0, stream);
}

// X (d_pad, n) fp32 = Sᵀ · Y (k_pad, n) fp32, both row-major and
// contiguous, for a blockperm plan; itab is the (κ, M) int32 inverse
// neighbour table, `uc` columns of a block are hashed per chunk.  (Global
// plans run fs_transpose_global of flashsketch_transpose.cu with
// per_level != 0.)  Launches on `stream` and returns cudaGetLastError() (0
// on success).
int fs_transpose_v1(const void* Yin, void* X, const void* itab, int M,
                    int Br, int Bc, int kappa, int s, long long n,
                    unsigned int seed, float scale, int tn, int groups, int uc,
                    int smem, void* stream) {
  return launch(transpose_v1_kernel, dim3(tiles(n, tn), M), dim3(tn, groups),
                smem, stream, static_cast<const float*>(Yin),
                static_cast<float*>(X), static_cast<const int*>(itab), M, Br,
                Bc, kappa, s, n, seed, scale, uc);
}

// Y (k_pad, n) fp32 = S_row · A (d_pad, n) fp32, both row-major and
// contiguous; tab is the (κ, M) int32 iid wiring.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int fs_blockrow_v1(const void* A, void* Y, const void* tab, int M, int Br,
                   int Bc, int kappa, int s, long long n, unsigned int seed,
                   float scale, int tn, int groups, int smem, void* stream) {
  return launch(blockrow_v1_kernel, dim3(tiles(n, tn), M), dim3(tn, groups),
                smem, stream, static_cast<const float*>(A),
                static_cast<float*>(Y), static_cast<const int*>(tab), M, Br,
                Bc, kappa, s, n, seed, scale);
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
