// FlashSketch forward, Y = S·A, and its gather-fused twin, Y = S·A[row_map],
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flashsketch.py:594 flashsketch_pallas, whose
// body is _fused_fwd_kernel (:231) with Φ from _phi_tile (:145), and
// flashsketch.py:642 flashsketch_pallas_gather, whose body is
// _fused_gather_kernel (:280); for the global families (CountSketch, sparse
// graph) both with Φ from _phi_global_tile (:165) and the all-blocks table
// _global_table (:118), here global_fwd_kernel (see its note); and the
// compact body of flashsketch.py:736 flashsketch_pallas_partial,
// _partial_fwd_kernel (:378).  Plain versions:
// repro_torch/kernels/ref.py:flashsketch_ref on the streamed operand, on its
// materialized gather (ref.gather_rows), and ref.partial_ref.
//
// What it computes: for output block g, Y[g·Br + r, c] = scale ·
// Σ_ℓ Σ_u Σ_i [row(g, h_ℓ, u, i) = r] · sign(g, h_ℓ, u, i) · A[h_ℓ·Bc + u, c]
// with h_ℓ = π_ℓ(g) from the (κ, M) table, scale = 1/√(κs).  A streams in
// float, bf16, fp8 e4m3 or fp8 e5m2 (already quantized by the wrapper), is
// upcast to fp32 and summed in fp32.  Φ entries are ±1, so every product is
// exact and only the order of the sums differs from the TPU kernel.
//
// Global families: nonzero i of global column u lands at the global row
// i·(k_pad/s) + hash(seed, 0x610B, u, i) mod (k_pad/s), scale = 1/√s.
//
// Bound on the H100: the kernel must read A once and write Y once,
// (d_pad·n·itemsize + k_pad·n·4) bytes at 3.35 TB/s; at the main plan
// (d_pad = 65 536, k_pad = 4 096, n = 1 024, fp32) that is about 85 µs.  The
// sums are κs adds per element of A, far below the fp32 rate: the kernel is
// bound by bytes.
//
// Design (blockperm plans: fs_fwd, fs_fwd_partial, fs_fwd_gather).  The TPU
// kernel holds the dense stacked Φ* (Br, κ·Bc) in VMEM; at the main plan
// that is 4 MiB, and a block here has at most 227 KB of shared memory.  All
// three run the row-split bodies of row_split.cuh, which read S from the
// plan's CSR (built once per plan on the card) and keep every sum in a
// register: the forward and the partial split_vec_kernel, 16-byte loads of
// A, 4 fp32 (8 bf16, 16 fp8) columns a thread, so a CSR word and its address
// arithmetic are paid once per 16 bytes and a warp's request covers 256-512
// contiguous bytes; the gather split_fwd_kernel, one column a thread through
// explicit strides.  Each output element gets its adds in (ℓ, u) order
// from +0, then × scale, the order of the kernel this body replaced (one
// block per (g, column tile) with Φ hashed in every block and a (Br, tn)
// shared-memory accumulator), so the forward kept its bits; see
// row_split.cuh for the grid, the sum order and what bounds it.
//
// Gather (the GraSS sparsify→sketch step, fs_fwd_gather).  Row u of input
// block h is read from source row row_map[h·Bc + u] of A (d_src, n)
// instead of row h·Bc + u, so A[row_map] is never written.  Rows h·Bc + u
// ≥ d (the padding of the masked dim) skip their load and add an exact
// zero, as a zero-padded materialized gather would, and every output
// element gets its adds in the forward's (ℓ, u) order, so on the card the
// gather equals the forward on the zero-padded A[row_map] bit for bit.  A is
// read through an explicit row and column stride: the per-example
// gradients come as (c, D) row-major and are sketched as the (D, c) view
// (row stride 1, column stride D) without a copy.  Bound: the d gathered
// rows read once plus Y written once.
//
// Partial (the row-sharded apply, fs_fwd_partial).  A rank owns the
// contiguous input blocks [lo, lo + M_loc) of the padded A, its slab.  The
// wiring π_ℓ is a permutation, so each owned block h feeds one output block
// g = π_ℓ⁻¹(h) per level: the rank's work is the κ·M_loc owned pairs of the
// (2, κ, M_loc) table [g, h] (global ids).  Row block p = ℓ·M_loc + m of the
// compact (κ, M_loc·Br, n) output is pair p: each row of g sums level ℓ's
// CSR segment alone (its columns all in block h, read as rows of slab block
// m), unscaled, in u order from +0, the per-level order of the partial's
// first kernel, which depends on neither M_loc, tn nor R: the partials, summed over the
// ranks (one nonzero contributor per element) and folded in ℓ order, are
// the same bits for every shard count.  They are not the fused forward's
// bits, which adds level ℓ+1 onto level ℓ's running sum.  The CSR is the
// whole plan's (4 bytes per nonzero on every rank).  No (Br, tn)
// accumulator, so every plan the reference runs has a kernel here.  Bound:
// the slab read once plus the compact output written once.

#include "row_split.cuh"

namespace {

constexpr int kUnroll = 16;

// Global families (CountSketch, sparse graph; template flag kGather: the
// gather, rows read through row_map as fs_fwd_gather reads them).  Output
// block g holds the rows [g·Br, (g+1)·Br) of one or more
// row chunks i (chunk = k_pad/s, n_i = max(1, Br/chunk) of them, from
// i_lo = g·Br/chunk); nonzero i of every column u lands in block g with
// probability Br/chunk.  So the block does not walk its κ = M input blocks
// as the blockperm kernel does: it hashes the (u, i) of every column, `uc`
// columns at a time, and compacts the nonzeros that land in block g into
// a list in shared memory, in (u, i) order (a deterministic block-wide
// scan), holding the row of A to read (-1 for a padding row of the
// gather) and the packed (local row, sign).  Thread group q (groups is a
// power of two) then adds the entries of the rows r ≡ q (mod groups) into
// the fp32 (Br, tn)
// accumulator, each word owned by one thread, in list order: no atomics,
// a fixed order.  Each row of A is read s times in all (once per nonzero),
// not M times; the hashing, d_pad·n_i per block, is what the blocks
// repeat, so the lowering gives this kernel a wide column tile.
template <typename T, bool kGather>
__global__ void __launch_bounds__(1024)
global_fwd_kernel(
    const T* __restrict__ A, float* __restrict__ Y,
    const int* __restrict__ row_map, int Br, int s, long long n,
    long long rs, long long cs, int d, int d_pad, int d_src, int k_pad,
    uint32_t seed, float scale, int uc, int n_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = blockDim.x;
  const int groups = blockDim.y;
  float* acc = reinterpret_cast<float*>(smem);                 // (Br, tn)
  int2* list = reinterpret_cast<int2*>(acc + Br * tn);         // (uc·n_i)
  int* scratch = reinterpret_cast<int*>(list + uc * n_i);      // nwarps + 1

  const int g = blockIdx.x;
  const int cl = threadIdx.x;
  const int q = threadIdx.y;
  const long long c = static_cast<long long>(blockIdx.y) * tn + cl;
  const bool valid = c < n;
  const int tid = q * tn + cl;
  const int nthreads = tn * groups;
  const uint32_t chunk = static_cast<uint32_t>(k_pad / s);
  const int i_lo = static_cast<int>((static_cast<long long>(g) * Br) / chunk);
  const long long row0 = static_cast<long long>(g) * Br;
  const uint32_t prefix = fs::global_prefix(seed);
  const T* col = A + (valid ? c * cs : 0);

  for (int idx = tid; idx < Br * tn; idx += nthreads) acc[idx] = 0.f;

  for (int u0 = 0; u0 < d_pad; u0 += uc) {
    const int nu = min(uc, d_pad - u0);
    __syncthreads();  // the previous chunk's list is consumed
    const int cnt = fs::global_block_entries(
        prefix, u0, nu, i_lo, n_i, chunk, row0, Br, scratch, tid, nthreads,
        [&](int slot, int uu, uint32_t w) {
          int src = u0 + uu;
          if constexpr (kGather) {
            src = -1;                   // padding: skip the load, add a zero
            if (u0 + uu < d) {
              src = row_map[u0 + uu];
              if (src < 0 || src >= d_src) __trap();   // a row outside A
            }
          }
          list[slot] = make_int2(src, static_cast<int>(w));
        });
    if (!valid) continue;
    for (int e0 = 0; e0 < cnt; e0 += kUnroll) {
      float a[kUnroll];
      int r[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        a[t] = 0.f;
        r[t] = -1;
        if (e0 + t < cnt) {
          const int2 en = list[e0 + t];
          if (((en.y >> 1) & (groups - 1)) == q) {
            r[t] = en.y;
            if (en.x >= 0)
              a[t] = fs::to_f32(col[static_cast<long long>(en.x) * rs]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        if (r[t] < 0) continue;
        acc[(r[t] >> 1) * tn + cl] += (r[t] & 1) ? -a[t] : a[t];
      }
    }
  }
  __syncthreads();
  if (!valid) return;
  float* dst = Y + row0 * n + c;
  for (int rr = q; rr < Br; rr += groups)
    dst[static_cast<long long>(rr) * n] = acc[rr * tn + cl] * scale;
}

template <typename T, bool kGather>
int launch_global(const void* A, void* Y, const void* row_map, int M, int Br,
                  int s, long long n, long long rs, long long cs, int d,
                  int d_pad, int d_src, int k_pad, unsigned int seed,
                  float scale, int tn, int groups, int uc, int n_i, int smem,
                  void* stream) {
  auto kern = global_fwd_kernel<T, kGather>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M, static_cast<unsigned int>((n + tn - 1) / tn));
  const dim3 block(tn, groups);
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<float*>(Y),
      static_cast<const int*>(row_map), Br, s, n, rs, cs, d, d_pad, d_src,
      k_pad, seed, scale, uc, n_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Y (k_pad, n) fp32 = S · A (d_pad, n), both row-major and contiguous, for
// a blockperm plan; S comes as the plan's CSR (ptr, ent: see row_split.cuh).
// The row-split body split_vec_kernel: grid (M·R, ⌈n/tn⌉), block
// (tn·itemsize/16, groups).  The integers come in one array, p = {dtype, M,
// Br, Bc, κ, n, tn, groups, R, vec}, built once per launch shape by the
// caller; vec != 0: A is 16-byte aligned and n a multiple of 16/itemsize.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int fs_fwd(const void* A, void* Y, const void* ptr, const void* ent,
           const long long* p, float scale, void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int tn = static_cast<int>(p[6]), groups = static_cast<int>(p[7]);
  const int R = static_cast<int>(p[8]), vec = static_cast<int>(p[9]);
#define FS_LAUNCH(T)                                                      \
  fs::launch_vec<T, false>(A, Y, ptr, ent, nullptr, M, Br, Bc, kappa, p[5], \
                           scale, tn, groups, R, vec, stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

// Y (k_pad, n) fp32 = S · A[row_map]: A (d_src, n) with row stride `rs` and
// column stride `cs` (in elements), row_map (d_pad,) int32 source rows of
// which the first d are read (a row outside [0, d_src) traps).  S comes as
// the plan's CSR (ptr, ent: see row_split.cuh).  The row-split body: grid
// (M·R, ⌈n/tn⌉), block (tn, groups), `cap` ints of shared memory (the most
// nonzeros a block has).  The integers come in one array, p = {dtype, M,
// Br, Bc, κ, n, rs, cs, d, d_src, tn, groups, R, cap}, built once per
// launch shape by the caller.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int fs_fwd_gather(const void* A, void* Y, const void* ptr, const void* ent,
                  const void* row_map, const long long* p, float scale,
                  void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int d = static_cast<int>(p[8]), d_src = static_cast<int>(p[9]);
  const int tn = static_cast<int>(p[10]), groups = static_cast<int>(p[11]);
  const int R = static_cast<int>(p[12]), cap = static_cast<int>(p[13]);
#define FS_LAUNCH(T)                                                        \
  fs::launch_split<T, true, false, false>(A, Y, ptr, ent, row_map, M, Br,    \
                                          Bc, kappa, p[5], p[6], p[7], d,    \
                                          d_src, scale, tn, groups, R, cap,  \
                                          stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

// Row-sharded partials: Y (κ, M_loc·Br, n) fp32, unscaled, for a slab A
// (M_loc·Bc, n) of the padded input, both row-major and contiguous; tab is
// the (2, κ, M_loc) int32 table [g, h] of the owned pairs, global block ids,
// on the device; S comes as the whole plan's CSR.  Row block p = ℓ·M_loc + m
// is Φ_{g,h} · A_m.  The row-split body split_vec_kernel: grid
// (κ·M_loc·R, ⌈n/tn⌉); p = {dtype, M_loc, Br, Bc, κ, n, tn, groups, R, vec}
// as for fs_fwd.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int fs_fwd_partial(const void* A, void* Y, const void* ptr, const void* ent,
                   const void* tab, const long long* p, void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int tn = static_cast<int>(p[6]), groups = static_cast<int>(p[7]);
  const int R = static_cast<int>(p[8]), vec = static_cast<int>(p[9]);
#define FS_LAUNCH(T)                                                        \
  fs::launch_vec<T, true>(A, Y, ptr, ent, tab, M, Br, Bc, kappa, p[5], 1.f, \
                          tn, groups, R, vec, stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

// Global families: Y (k_pad, n) fp32 = S · A, or S · A[row_map] with
// gather != 0.  A is (d_pad, n), or (d_src, n) for the gather, with row
// stride `rs` and column stride `cs` (elements); row_map (d_pad,) int32 on
// the device, of which the first d are read (a row outside [0, d_src)
// traps).  `uc` columns are hashed per chunk, n_i = max(1, Br·s/k_pad) row
// chunks meet each output block.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int fs_fwd_global(const void* A, void* Y, const void* row_map, int gather,
                  int dtype, int M, int Br, int s, long long n, long long rs,
                  long long cs, int d, int d_pad, int d_src, int k_pad,
                  unsigned int seed, float scale, int tn, int groups, int uc,
                  int n_i, int smem, void* stream) {
#define FS_LAUNCH(T)                                                        \
  (gather ? launch_global<T, true>(A, Y, row_map, M, Br, s, n, rs, cs, d,   \
                                   d_pad, d_src, k_pad, seed, scale, tn,    \
                                   groups, uc, n_i, smem, stream)           \
          : launch_global<T, false>(A, Y, row_map, M, Br, s, n, rs, cs, d,  \
                                    d_pad, d_src, k_pad, seed, scale, tn,   \
                                    groups, uc, n_i, smem, stream))
  FS_DISPATCH(dtype, FS_LAUNCH)
#undef FS_LAUNCH
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
