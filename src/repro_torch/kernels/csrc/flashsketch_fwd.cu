// FlashSketch forward, Y = S·A, its gather-fused twin, Y = S·A[row_map],
// and the compact row-sharded partial, for Hopper (sm_90a); with
// FLASHBLOCKROW's S_row and the global families' S behind the same two
// forward symbols.
//
// Replaces: src/repro/kernels/flashsketch.py:594 flashsketch_pallas, whose
// body is _fused_fwd_kernel (:231) with Φ from _phi_tile (:145), and
// flashsketch.py:642 flashsketch_pallas_gather, whose body is
// _fused_gather_kernel (:280); for the global families (CountSketch, sparse
// graph) both with Φ from _phi_global_tile (:165) and the all-blocks table
// _global_table (:118); flashsketch.py:711 blockrow_pallas (body
// _fused_fwd_kernel with Φ from _phi_rows_tile :190) and flashsketch.py:682
// blockrow_pallas_gather (body _fused_gather_kernel); both bodies of
// flashsketch.py:736 flashsketch_pallas_partial, the compact
// _partial_fwd_kernel (:378) and the masked FLASHBLOCKROW
// _partial_masked_kernel (:422); and, where the staged transpose's tile
// does not fit shared memory, flashsketch.py:619
// flashsketch_transpose_pallas (fs_fwd on the CSR of Sᵀ: the transpose's L2
// route, see flashsketch_transpose.cu); at n = 1, flashsketch_pallas again
// through fs_fwd_narrow (split_narrow_kernel of row_split.cuh: the narrow
// route of the training path's gradient leaves, see its note).  Plain
// versions:
// repro_torch/kernels/ref.py:flashsketch_ref, ref.blockrow_ref and
// ref.flashsketch_transpose_ref on the streamed operand, on its
// materialized gather (ref.gather_rows), and ref.partial_ref.
//
// What it computes: for output block g, Y[g·Br + r, c] = scale ·
// Σ_ℓ Σ_u Σ_i [row(g, h_ℓ, u, i) = r] · sign(g, h_ℓ, u, i) · A[h_ℓ·Bc + u, c]
// with h_ℓ = π_ℓ(g) from the (κ, M) table, scale = 1/√(κs).  Global
// families: nonzero i of global column u lands at the global row
// i·(k_pad/s) + hash(seed, 0x610B, u, i) mod (k_pad/s), scale = 1/√s.
// FLASHBLOCKROW (paper App. C): h_ℓ is an iid draw (ref.blockrow_wiring,
// tag 0xB10C), so two ℓ may pick one h and their terms add; row r of block
// g holds s nonzeros per ℓ, at column h_ℓ·Bc + hash mod Bc with the hash
// hash_words(seed, 0x5EED, g, h_ℓ, r, t) (a true modulo for a Bc that is
// not a power of two), sign bit 31, scale = 1/√(κs) · √(d_pad/k_pad).  A
// streams in float, bf16, fp8 e4m3 or fp8 e5m2 (already quantized by the
// wrapper), is upcast to fp32 and summed in fp32.  Every nonzero is ±1, so
// every product is exact and only the order of the sums differs from the
// TPU kernel.
//
// Bound on the H100: the kernel must read A once and write Y once,
// (d_pad·n·itemsize + k_pad·n·4) bytes at 3.35 TB/s; at the main plan
// (d_pad = 65 536, k_pad = 4 096, n = 1 024, fp32) that is about 85 µs
// (FLASHBLOCKROW: only the rows some nonzero names).  The sums are κs adds
// per element of A, far below the fp32 rate: the kernel is bound by bytes.
//
// Design.  The TPU kernel holds the dense stacked Φ* (Br, κ·Bc) in VMEM; at
// the main plan that is 4 MiB, and a block here has at most 227 KB of shared
// memory.  Every entry point runs a row-split body of row_split.cuh, which
// reads S from a CSR (64-bit row offsets, 32-bit words) built once per plan
// on the card (kernels/flashsketch.py:_device_csr: the blockperm, global or
// FLASHBLOCKROW one) and keeps every sum in a register: the forward and the
// partial split_vec_kernel, 16-byte loads of A, 4 fp32 (8 bf16, 16 fp8)
// columns a thread, so a CSR word and its address arithmetic are paid once
// per 16 bytes and a warp's request covers 256-512 contiguous bytes; the
// gather split_fwd_kernel, one column a thread through explicit strides.  The
// integer `kappa` the C interface takes is the CSR's `ptr` entries per row:
// κ for a blockperm or FLASHBLOCKROW plan (one segment per level), 1 for a
// global plan (one segment per row).  Each output element gets its adds in
// its CSR order from +0, then × scale: (ℓ, u) for blockperm and global plans
// (a global row's columns ascending, the (u, i) order of the global kernel
// this body replaced), (ℓ, t) for FLASHBLOCKROW (the order of the hashing
// kernel it replaced, collisions kept); see row_split.cuh for the grid, the
// sum order and what bounds it.
//
// Gather (the GraSS sparsify→sketch step, fs_fwd_gather).  Row u of input
// block h is read from source row row_map[h·Bc + u] of A (d_src, n)
// instead of row h·Bc + u, so A[row_map] is never written.  Rows h·Bc + u
// ≥ d (the padding of the masked dim) skip their load and add an exact
// zero, as a zero-padded materialized gather would, and every output
// element gets its adds in the forward's order, so on the card the gather
// equals the forward on the zero-padded A[row_map] bit for bit.  A is read
// through an explicit row and column stride: the per-example gradients
// come as (c, D) row-major and are sketched as the (D, c) view (row stride
// 1, column stride D) without a copy.  Bound: the d gathered rows read once
// plus Y written once.
//
// Partial (the row-sharded apply, fs_fwd_partial).  A rank owns the
// contiguous input blocks [lo, lo + M_loc) of the padded A, its slab.  The
// wiring π_ℓ is a permutation, so each owned block h feeds one output block
// g = π_ℓ⁻¹(h) per level: the rank's work is the κ·M_loc owned pairs of the
// (2, κ, M_loc) table [g, h] (global ids).  Row block p = ℓ·M_loc + m of the
// compact (κ, M_loc·Br, n) output is pair p: each row of g sums level ℓ's
// CSR segment alone (its columns all in block h, read as rows of slab block
// m), unscaled, in u order from +0, the per-level order of the partial's
// first kernel, which depends on neither M_loc, tn nor R: the partials,
// summed over the ranks (one nonzero contributor per element) and folded
// in ℓ order, are the same bits for every shard count.  They are not the
// fused forward's bits, which adds level ℓ+1 onto level ℓ's running sum.
// The CSR is the whole plan's (4 bytes per nonzero on every rank).  Bound:
// the slab read once plus the compact output written once.
//
// Masked partial (the row-sharded FLASHBLOCKROW, fs_blockrow_partial).  The
// iid wiring is not a permutation, so there is no compact grid of owned
// pairs: row block p = ℓ·M + g of the (κ, k_pad, n) output covers the full
// (3, κ, M) table [local block, global h, owned].  An owned pair sums, for
// each row of g, level ℓ's segment of S_row's CSR (κ·s words a row in
// (ℓ, t) order, collisions kept), each column read as slab row
// col + (local − h)·Bc, in t order from +0, unscaled; a pair another rank
// owns writes exact zeros with the same 16-byte stores.  That is the order
// of the hashing kernel it replaced (one thread per output element, Br·s
// words hashed into shared memory in every block and column tile), so the
// partials are its bits for every P, R and tile, and summed over the ranks
// and folded in ℓ order the same bits for every P.  Bound: the slab rows
// some owned nonzero names, read once, plus the whole output written once
// (most of it: 64 MiB at the main plan, n = 1 024).

#include "row_split.cuh"

extern "C" {

// Y (k_pad, n) fp32 = S · A (d_pad, n), both row-major and contiguous; S
// comes as a CSR (ptr int64, ent int32: see row_split.cuh), the plan's or
// FLASHBLOCKROW's, with its scale.  The row-split body split_vec_kernel:
// grid (M·R, ⌈n/tn⌉), block (tn·itemsize/16, groups).  The integers come
// in one array, p = {dtype, M, Br, Bc, κ, n, tn, groups, R, vec}, built
// once per launch shape by the caller, κ the CSR's ptr entries per row (1
// for a global plan); vec != 0: A is 16-byte aligned and n a multiple of
// 16/itemsize.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
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

// The narrow forward at n = 1 (row_split.cuh, split_narrow_kernel): Y
// (k_pad,) fp32 = S · a (d_pad,), both contiguous, for a blockperm plan; S
// comes as the plan's CSR (ptr int64 of ptr_len = k_pad·κ + 1 entries, ent
// int32) and tab is the (κ, M) int32 neighbour table, on the device.  The
// integers come in one array, p = {dtype, M, Br, Bc, κ, s, threads, stages,
// blocks, smem, mode, ptr_len}: blocks 0 for the SMs times the blocks
// resident on each, mode a NarrowCopy (0 bulk copies: a 16-byte aligned,
// 4·κ·Bc·s and Bc·itemsize multiples of 16; 1 4-byte cp.async: Bc·itemsize
// a multiple of 4, a 4-byte aligned; 2 loads).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int fs_fwd_narrow(const void* A, void* Y, const void* ptr, const void* ent,
                  const void* tab, const long long* p, float scale,
                  void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int s = static_cast<int>(p[5]), threads = static_cast<int>(p[6]);
  const int stages = static_cast<int>(p[7]), blocks = static_cast<int>(p[8]);
  const int smem = static_cast<int>(p[9]), mode = static_cast<int>(p[10]);
#define FS_LAUNCH(T)                                                       \
  fs::launch_narrow<T>(A, Y, ptr, ent, tab, M, Br, Bc, kappa, s, scale,    \
                       threads, stages, blocks, smem, mode, p[11], stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

// Y (k_pad, n) fp32 = S · A[row_map]: A (d_src, n) with row stride `rs` and
// column stride `cs` (in elements), row_map (d_pad,) int32 source rows of
// which the first d are read (a row outside [0, d_src) traps).  S comes as
// a CSR (ptr, ent: see row_split.cuh), the plan's or FLASHBLOCKROW's, with
// its scale.  The row-split body: grid (M·R, ⌈n/tn⌉), block (tn, groups),
// `cap` ints of shared memory (the most nonzeros a block has).  The
// integers come in one array, p = {dtype, M, Br, Bc, κ, n, rs, cs, d,
// d_src, tn, groups, R, cap}, built once per launch shape by the caller, κ
// the CSR's ptr entries per row (1 for a global plan).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
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

// Masked FLASHBLOCKROW partials: Y (κ, k_pad, n) fp32, unscaled, for a
// slab A (M_loc·Bc, n) of the padded input, both row-major and contiguous;
// tab is the (3, κ, M) int32 table [local block, global h, owned] on the
// device; S_row comes as its CSR (ptr, ent: κ level segments a row).  The
// masked mode of split_vec_kernel: grid (κ·M·R, ⌈n/tn⌉); p = {dtype, M,
// Br, Bc, κ, n, tn, groups, R, vec} as for fs_fwd, M the plan's.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int fs_blockrow_partial(const void* A, void* Y, const void* ptr,
                        const void* ent, const void* tab, const long long* p,
                        void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int tn = static_cast<int>(p[6]), groups = static_cast<int>(p[7]);
  const int R = static_cast<int>(p[8]), vec = static_cast<int>(p[9]);
#define FS_LAUNCH(T)                                                        \
  fs::launch_vec<T, true, false, true>(A, Y, ptr, ent, tab, M, Br, Bc,      \
                                       kappa, p[5], 1.f, tn, groups, R, vec, \
                                       stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
