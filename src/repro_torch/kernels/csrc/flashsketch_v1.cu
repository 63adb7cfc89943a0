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
// every kernel runs a row-split body of row_split.cuh on a CSR built once
// per plan on the card (kernels/flashsketch.py), keeps each level's sum in
// registers and folds the finished levels into a running sum in ℓ order,
// run = fma(L_ℓ, scale, run) from +0, which it writes once: the order and
// the roundings of the reference's revisits.
//
//  * Forward.  split_fwd_kernel<float, false, true, *> on the plan's CSR
//    (_device_csr), one column a thread, the levels of a row summed side by
//    side; global plans (h_ℓ = ℓ) too, each level folded when the row's
//    column order leaves it.
//  * Transpose, blockperm plans.  split_vec_kernel's v1 mode on a CSR of Sᵀ
//    (_device_csr_t): row h·B_c + u of X holds its κ·s words in (ℓ, i)
//    order, level ℓ's s rows of Y in block g = π_ℓ⁻¹(h); output blocks of
//    B_c rows, 16-byte loads of Y.  It replaced a kernel that hashed the
//    κ·s words of every column of its input block into shared memory again
//    in every column tile (32 times at n = 1 024) and loaded Y 4 bytes at a
//    time.  Global plans run the global transpose of
//    flashsketch_transpose.cu with its per-level flag, which groups the s
//    rows of each u by the output block they fall in (ℓ = row / B_r,
//    increasing in i).
//  * FLASHBLOCKROW.  split_vec_kernel's v1 mode on S_row's CSR
//    (_blockrow_csr: κ·s words a row in (ℓ, t) order, collisions kept), with
//    FLASHBLOCKROW's scale.  It replaced a kernel that gave each thread one
//    column of B_r/groups rows and hashed every (r, ℓ, t) word itself, again
//    in every column tile.

#include "row_split.cuh"

namespace {

// split_vec_kernel's v1 mode, fp32, on a CSR of κ level segments a row;
// p as for fs_fwd (p[0] = 0, fp32).
int launch_v1_vec(const void* A, void* Y, const void* ptr, const void* ent,
                  const long long* p, float scale, void* stream) {
  if (p[0] != fs::kF32) return static_cast<int>(cudaErrorInvalidValue);
  return fs::launch_vec<float, false, true>(
      A, Y, ptr, ent, nullptr, static_cast<int>(p[1]),
      static_cast<int>(p[2]), static_cast<int>(p[3]), static_cast<int>(p[4]),
      p[5], scale, static_cast<int>(p[6]), static_cast<int>(p[7]),
      static_cast<int>(p[8]), static_cast<int>(p[9]), stream);
}

}  // namespace

extern "C" {

// Y (k_pad, n) fp32 = S · A (d_pad, n) fp32, both row-major and contiguous;
// S comes as the plan's CSR (ptr int64, ent int32: see row_split.cuh), level
// segments per row for a blockperm plan, the κ = M levels of a global plan
// told apart by column.  The row-split body: grid (M·R, ⌈n/tn⌉), block (tn,
// groups).  The integers come in one array, p = {global, M, Br, Bc, κ, n, tn,
// groups, R}, built once per launch shape by the caller.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
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
// contiguous, for a blockperm plan; Sᵀ comes as its CSR (ptr, ent: κ·s
// words a row, ((g·Br + row) << 1) | sign, κ offsets a row).  The v1 mode of
// split_vec_kernel: grid (M·R, ⌈n/tn⌉), block (tn/4, groups), output blocks
// of Bc rows.  p = {0, M, Bc, Bc, κ, n, tn, groups, R, vec}, the layout of
// fs_fwd's with the output block's rows in place of Br.  (Global plans run
// fs_transpose_global of flashsketch_transpose.cu with per_level != 0.)
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int fs_transpose_v1(const void* Yin, void* X, const void* ptr,
                    const void* ent, const long long* p, float scale,
                    void* stream) {
  return launch_v1_vec(Yin, X, ptr, ent, p, scale, stream);
}

// Y (k_pad, n) fp32 = S_row · A (d_pad, n) fp32, both row-major and
// contiguous; S_row comes as its CSR (ptr, ent: see row_split.cuh).  The v1
// mode of split_vec_kernel: grid (M·R, ⌈n/tn⌉), block (tn/4, groups);
// p = {0, M, Br, Bc, κ, n, tn, groups, R, vec} as for fs_fwd.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fs_blockrow_v1(const void* A, void* Y, const void* ptr, const void* ent,
                   const long long* p, float scale, void* stream) {
  return launch_v1_vec(A, Y, ptr, ent, p, scale, stream);
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
