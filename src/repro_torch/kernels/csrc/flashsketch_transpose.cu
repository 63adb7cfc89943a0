// FlashSketch transpose, X = Sᵀ·Y, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flashsketch.py:619 flashsketch_transpose_pallas,
// whose body is _fused_transpose_kernel (:256) with the inverse wiring table
// _inv_neighbor_table (:100), run by _run_fused (:534), here
// staged_transpose_kernel; for the global families (CountSketch, sparse
// graph) with Φ from _phi_global_tile (:165), here global_transpose_kernel
// (see its note); at n = 1, narrow_transpose_kernel (fs_transpose_narrow,
// see its note).  Plain version:
// repro_torch/kernels/ref.py:flashsketch_transpose_ref on the streamed operand.
//
// What it computes: for input block h, X[h·Bc + u, c] = scale ·
// Σ_ℓ Σ_i sign(g_ℓ, h, u, i) · Y[g_ℓ·Br + row(g_ℓ, h, u, i), c] with
// g_ℓ = π_ℓ⁻¹(h) from the (κ, M) inverse table, scale = 1/√(κs).  Y streams
// in float, bf16, fp8 e4m3 or fp8 e5m2 (already quantized by the wrapper), is
// upcast to fp32 and summed in fp32; the products with ±1 are exact.  Each
// element gets its κ·s adds in (ℓ, i) order from +0, then × scale.
//
// Bound on the H100: the kernel must read Y once and write X once,
// (k_pad·n·itemsize + d_pad·n·4) bytes at 3.35 TB/s; at the main plan that is
// about 85 µs, almost all of it the write of X.  κs adds per element of X are
// far below the fp32 rate: the kernel is bound by bytes.  What stands in the
// way is the κ·s reads of Y per element of X (2 GiB at the main plan,
// n = 1 024): from L2 they set the time (split_vec_kernel on the CSR of Sᵀ
// runs at L2's rate, 0.32-0.37 ms on the card), so they come from shared
// memory here, whose rate (about 128 B a clock on each SM) puts them near
// 0.07 ms, under the stores.
//
// Design (staged_transpose_kernel).  Output block h of X needs only the κ
// row blocks g_ℓ of Y.  A block owns a run of (h, column tile) items, h
// major, and for each copies the κ boxes (Br, 128 bytes) of Y into one stage
// of a ring in shared memory, (κ·Br, 128 B) a stage, while it sums the
// item before: the copy of item t + S is started as soon as every thread is
// done with item t, so S - 1 copies run under each item's sums.  The copies
// are TMA boxes (cp.async.bulk.tensor, one or more of at most 256 rows a
// level) where Y's rows are 16-byte aligned, completing on the stage's
// mbarrier; cp.async of 4-byte words where they are 4-byte aligned; plain
// loads elsewhere.  The grid is sized to the SMs and the blocks that fit on
// each, not to M·⌈n/tn⌉.  A tile is 128 bytes of a row of Y (32 fp32, 64
// bf16 or 128 fp8 columns): 8 threads cover it, 16 bytes each, so a
// quarter-warp reads one whole staged row, all 32 banks, with no conflict,
// and one 16-byte shared load per nonzero feeds 4-16 columns.  Thread group
// y owns the rows u = y, y + G, … of X's block; for each it reads the row's
// κ·s words (one word per 16 bytes of Y) and adds, in registers, then
// writes its columns with 16-byte stores (the ragged n edge masked).
//
// The words come from a CSR of Sᵀ built once per plan on the card
// (kernels/flashsketch.py:_device_csr_t with tile_local): row h·Bc + u
// holds its κ·s nonzeros in (ℓ, i) order as ((ℓ·Br + row) << 1) | sign,
// the row of the staged tile, in 16 bits (a stage that fits has fewer
// than 2 048 rows).  No hashing in the kernel.  Tile-local words, not the
// global g_ℓ·Br + row of the v1 transpose's CSR, because a global word
// needs g_ℓ per level in the loop (a table read per level and row and an
// add per nonzero) and 32 bits: the 8 threads of a row all load its words,
// and at 2 bytes the κ·s = 8 words of a row are one 16-byte load, sent
// for the next row while the current one is summed.  The second CSR costs
// 2 bytes a nonzero (1 MiB at the main plan) and only plans that run this
// kernel build it.  The sums are bound by instruction throughput as much
// as by the shared reads, so each term is one fma with ±1 and a whole chunk
// of words is summed without per-term checks
// (benchmarks/torch_route_sweep.py and chip_smoke.py time both routes).
//
// Plans whose stage does not fit 227 KB (κ·Br·128 bytes; the Br = 2 048
// plan needs 1 MiB) run the L2 route instead: split_vec_kernel of
// row_split.cuh on the CSR of Sᵀ with global words (fs_fwd of
// flashsketch_fwd.cu, output blocks of Bc rows), the same sums in the same
// order, so both routes give the same bits.

#include <cuda.h>
#include <dlfcn.h>

#include "row_split.cuh"

namespace {

constexpr int kStageRow = 128;              // bytes of a staged row of Y
constexpr int kLanes = kStageRow / 16;       // threads over a staged row
constexpr int kUnrollT = 8;                  // nonzeros whose loads overlap

// How a stage is filled: TMA boxes, cp.async of 4-byte words, or loads.
enum CopyMode : int { kTma = 0, kAsync4 = 1, kPlain = 2 };

using fs::mbar_arrive;
using fs::mbar_expect_tx;
using fs::mbar_init;
using fs::mbar_wait;
using fs::smem_u32;

// Fill stage `dst` with item (h, j): level ℓ's Br rows of Y block g_ℓ,
// columns [j·kTn, (j+1)·kTn), at rows ℓ·Br of the stage.  kTma: thread 0
// alone, boxes of box_rows rows; otherwise every thread copies its share and
// arrives on `bar` once (cp.async arrives when its copies land).
template <typename T, int kCopy>
__device__ __forceinline__ void fill_stage(
    const CUtensorMap& tmap, const T* __restrict__ Y,
    const int* __restrict__ itab, unsigned char* dst, uint64_t* bar, int h,
    long long j, int M, int Br, int kappa, long long n, int box_rows) {
  constexpr int kTn = kStageRow / sizeof(T);
  const long long col0 = j * kTn;
  if constexpr (kCopy == kTma) {
    if (threadIdx.x != 0) return;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(bar, static_cast<uint32_t>(kappa * Br * kStageRow));
    for (int ell = 0; ell < kappa; ++ell) {
      const int g = __ldg(itab + ell * M + h);
      for (int r0 = 0; r0 < Br; r0 += box_rows)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
                smem_u32(dst + static_cast<long long>(ell * Br + r0) *
                                   kStageRow)),
            "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(smem_u32(bar)),
            "r"(static_cast<int>(col0)), "r"(g * Br + r0)
            : "memory");
    }
  } else {
    // kAsync4: 4-byte words (4/itemsize columns, inside n: the row pitch is a
    // multiple of 4 bytes); kPlain: one element at a time
    constexpr int kPer = kCopy == kAsync4 ? 4 / sizeof(T) : 1;
    constexpr int kWords = kTn / kPer;        // copies per staged row
    const int total = kappa * Br * kWords;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int rr = e / kWords;              // row of the stage
      const int q = e - rr * kWords;
      const long long c = col0 + static_cast<long long>(q) * kPer;
      if (c >= n) continue;                   // past the ragged edge
      const int ell = rr / Br;
      const long long grow =
          static_cast<long long>(__ldg(itab + ell * M + h)) * Br + rr -
          ell * Br;
      const T* src = Y + grow * n + c;
      unsigned char* to = dst + static_cast<long long>(rr) * kStageRow +
                          q * kPer * static_cast<int>(sizeof(T));
      if constexpr (kCopy == kAsync4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_u32(to)),
                     "l"(src)
                     : "memory");
      else
        *reinterpret_cast<T*>(to) = *src;
    }
    if constexpr (kCopy == kAsync4)
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                       smem_u32(bar))
                   : "memory");
    else
      mbar_arrive(bar);
  }
}

// The next kUnrollT 16-bit words of a row, as loaded: one 16-byte load
// where the row's words come in whole 16-byte chunks (vec), else one at a
// time (0 past the row's end, `left` words remaining).  take() unpacks them
// where they are used, so a load sent a row ahead stays in flight.
struct Words {
  uint4 q;
  int one[kUnrollT];
  __device__ __forceinline__ void load(const unsigned short* __restrict__ wr,
                                       int left, bool vec) {
    if (vec) {
      q = __ldg(reinterpret_cast<const uint4*>(wr));
    } else {
#pragma unroll
      for (int k = 0; k < kUnrollT; ++k)
        one[k] = k < left ? static_cast<int>(__ldg(wr + k)) : 0;
    }
  }
  __device__ __forceinline__ void take(int (&w)[kUnrollT], bool vec) const {
    if (vec) {
#pragma unroll
      for (int k = 0; k < kUnrollT; ++k)
        w[k] = static_cast<int>(
            (fs::word_of(q, k >> 1) >> (16 * (k & 1))) & 0xFFFFu);
    } else {
#pragma unroll
      for (int k = 0; k < kUnrollT; ++k) w[k] = one[k];
    }
  }
};

// Add the terms of `count` words (all kN where count is not given) to a
// row's sums in word order, acc = fma(a, ±1, acc): the product with ±1 is
// exact and the fma rounds once, so each step is acc + (sign ? -a : a)
// bit for bit, one instruction per element.  The shared loads of the chunk
// are all sent before its adds.
template <typename T, int kN>
__device__ __forceinline__ void sum_chunk(float (&acc)[16 / sizeof(T)],
                                          const int (&w)[kN],
                                          const unsigned char* tile,
                                          int count = kN) {
  constexpr int kV = 16 / sizeof(T);
  uint4 v[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k)
    v[k] = k < count ? *reinterpret_cast<const uint4*>(
                           tile + (w[k] >> 1) * kStageRow)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k >= count) break;
    const float pm = __uint_as_float(0x3F800000u |
                                     (static_cast<uint32_t>(w[k]) << 31));
#pragma unroll
    for (int j = 0; j < kV; ++j)
      acc[j] = fmaf(fs::unpack<T>(v[k], j), pm, acc[j]);
  }
}

// Threads of a staged block: 1 024 for a 4-byte stream (its sums need the
// warps to keep the shared reads busy), 512 for bf16 and fp8 (their
// upcasts need the registers), as they ran fastest on the H100.
template <typename T>
constexpr int kStagedThreads = sizeof(T) == 4 ? 1024 : 512;

// One block walks the items [first, last) of the M·⌈n/kTn⌉ (h, column tile)
// items, h major, through a ring of `stages` stages of (κ·Br, 128 B).  ent:
// the CSR of Sᵀ with tile-local 16-bit words, κ·s a row (so row h·Bc + u
// starts at (h·Bc + u)·κ·s).  xvec: n % 4 == 0, so X's rows take 16-byte
// stores.  A thread loads the next row's first words while it sums the
// current one.
template <typename T, int kCopy>
__global__ void __launch_bounds__(kStagedThreads<T>, 1)
staged_transpose_kernel(const __grid_constant__ CUtensorMap tmap,
                        const T* __restrict__ Y, float* __restrict__ X,
                        const int* __restrict__ itab,
                        const unsigned short* __restrict__ ent, int M,
                        int Br, int Bc, int kappa, int s, long long n,
                        float scale, int stages, int box_rows, int xvec) {
  constexpr int kTn = kStageRow / sizeof(T);
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stages 128-byte aligned (TMA's destination), then their mbarriers
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int stage_bytes = kappa * Br * kStageRow;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + static_cast<long long>(stages) * stage_bytes);
  const int x = threadIdx.x % kLanes;         // 16 bytes of the tile's row
  const int G = blockDim.x / kLanes;
  const int u0 = threadIdx.x / kLanes;
  const int ks = kappa * s;
  const bool wvec = ks % kUnrollT == 0;       // rows of whole 16-byte chunks
  const long long tiles = (n + kTn - 1) / kTn;
  const long long items = static_cast<long long>(M) * tiles;
  const long long first = items * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x -
                                     first);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st)
      mbar_init(full + st, kCopy == kTma ? 1u : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int t) {
    const long long item = first + t;
    const int st = t % stages;
    fill_stage<T, kCopy>(tmap, Y, itab,
                         ring + static_cast<long long>(st) * stage_bytes,
                         full + st, static_cast<int>(item / tiles),
                         item % tiles, M, Br, kappa, n, box_rows);
  };
  for (int t = 0; t < min(stages, count); ++t) fill(t);

  for (int t = 0; t < count; ++t) {
    const int st = t % stages;
    const long long item = first + t;
    const long long h = item / tiles;
    const long long c0 = (item - h * tiles) * kTn + x * kV;
    // 64-bit offsets: κ·s·d_pad words may pass 2^31 (h is a long long)
    const unsigned short* rows =
        ent + h * static_cast<long long>(Bc) * ks;
    Words next;                               // the next row's first words
    if (c0 < n && u0 < Bc)
      next.load(rows + static_cast<long long>(u0) * ks, ks, wvec);
    mbar_wait(full + st, static_cast<uint32_t>((t / stages) & 1));
    const unsigned char* tile =
        ring + static_cast<long long>(st) * stage_bytes + x * 16;
    if (c0 < n) {
      const bool full16 = xvec && c0 + kV <= n;
      for (int u = u0; u < Bc; u += G) {
        const unsigned short* wr = rows + static_cast<long long>(u) * ks;
        int w[kUnrollT];
        next.take(w, wvec);
        if (u + G < Bc) next.load(wr + G * ks, ks, wvec);
        float acc[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) acc[j] = 0.f;
        for (int e0 = 0; e0 < ks; e0 += kUnrollT) {
          if (e0) {
            Words more;
            more.load(wr + e0, ks - e0, wvec);
            more.take(w, wvec);
          }
          if (e0 + kUnrollT <= ks)            // a whole chunk: no checks
            sum_chunk<T, kUnrollT>(acc, w, tile);
          else
            sum_chunk<T, kUnrollT>(acc, w, tile, ks - e0);
        }
        float* dst = X + (h * Bc + u) * n + c0;
        if (full16) {                         // X is not read again here
#pragma unroll
          for (int j = 0; j < kV; j += 4)
            __stcs(reinterpret_cast<float4*>(dst + j),
                   make_float4(acc[j] * scale, acc[j + 1] * scale,
                               acc[j + 2] * scale, acc[j + 3] * scale));
        } else {
#pragma unroll
          for (int j = 0; j < kV; ++j)
            if (c0 + j < n) dst[j] = acc[j] * scale;
        }
      }
    }
    __syncthreads();                          // every read of the stage done
    if (t + stages < count) fill(t + stages);
  }
}

// cuTensorMapEncodeTiled (the TMA descriptor of Y) and cuGetErrorString,
// looked up in libcuda at run time, so the build links nothing beyond the
// CUDA runtime.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
using GetErrorString = CUresult (*)(CUresult, const char**);

void* libcuda_symbol(const char* name) {
  static void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  return lib != nullptr ? dlsym(lib, name) : nullptr;
}

// Codes at or above this one are kCuResultBase + the CUresult of a refused
// TMA descriptor (fs_error_string tells them apart).
constexpr int kCuResultBase = 100000;

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

template <typename T, int kCopy>
int launch_staged_mode(const CUtensorMap& tmap, const void* Y, void* X,
                       const void* itab, const void* ent, int M, int Br,
                       int Bc, int kappa, int s, long long n, float scale,
                       int threads, int stages, int box_rows, int blocks,
                       int smem, void* stream) {
  auto kern = staged_transpose_kernel<T, kCopy>;
  if (threads != kStagedThreads<T>)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kTn = kStageRow / sizeof(T);
  const long long items = static_cast<long long>(M) * ((n + kTn - 1) / kTn);
  cudaError_t err;
  const long long grid =
      fs::persistent_grid(kern, threads, smem, blocks, items, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned int>(grid), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      tmap, static_cast<const T*>(Y), static_cast<float*>(X),
      static_cast<const int*>(itab), static_cast<const unsigned short*>(ent),
      M, Br, Bc,
      kappa, s, n, scale, stages, box_rows, static_cast<int>(n % 4 == 0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const void* Y, void* X, const void* itab, const void* ent,
                  const long long* p, float scale, void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int s = static_cast<int>(p[5]);
  const long long n = p[6], k_pad = static_cast<long long>(M) * Br;
  const int threads = static_cast<int>(p[7]), stages = static_cast<int>(p[8]);
  const int box_rows = static_cast<int>(p[9]), blocks = static_cast<int>(p[10]);
  const int smem = static_cast<int>(p[11]), mode = static_cast<int>(p[12]);
  CUtensorMap tmap{};
  if (mode == kTma) {
    auto encode = reinterpret_cast<EncodeTiled>(
        libcuda_symbol("cuTensorMapEncodeTiled"));
    if (encode == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k_pad)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * sizeof(T)};
    const cuuint32_t box[2] = {kStageRow / sizeof(T),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(
        &tmap, tma_type<T>(), 2, const_cast<void*>(Y), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kCuResultBase + static_cast<int>(r);
  }
#define FS_MODE(K)                                                           \
  launch_staged_mode<T, K>(tmap, Y, X, itab, ent, M, Br, Bc, kappa, s, n,     \
                           scale, threads, stages, box_rows, blocks, smem,    \
                           stream)
  switch (mode) {
    case kTma: return FS_MODE(kTma);
    case kAsync4: return FS_MODE(kAsync4);
    case kPlain: return FS_MODE(kPlain);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FS_MODE
}


// ---------------------------------------------------------------------------
// The narrow transpose: n = 1, a blockperm plan.
// ---------------------------------------------------------------------------
//
// Replaces, at n = 1, flashsketch_transpose_pallas (:619), body
// _fused_transpose_kernel (:256), as staged_transpose_kernel did
// (kernels/flashsketch.py:transpose_route picks the route): X = Sᵀ·y for
// one column y, the decompression of the training path's gradient leaves.
//
// Why.  The staged kernel's stage is κ·Br rows of 128 bytes whatever n is:
// at n = 1 each staged row carries 4 bytes of y, a stage is 128 KiB at the
// training plans (Br = 256, κ = 4), so one stage fits and no copy overlaps
// a sum; fill_stage walks κ·Br·32 copy slots of which 31 in 32 are past n;
// and of the 8 threads over a staged row only the first sums (qwen3-0.6b's
// embedding plan: 23.7 ms, 98× its bound, 3.8-4.7× a torch.sparse.mm of Sᵀ
// on the H100).
//
// Bound.  cost_of's floor reads y and writes X once, 0.2404 ms at that plan;
// a kernel that reads Sᵀ's tile-local 16-bit words once adds 2 bytes a
// nonzero: 3.49 GB there, a floor of 1.04 ms.
//
// Design.  An item is an input block h.  Its stage is the κ·s·Bc tile-local
// words of its rows (contiguous in ent, 2·κ·s·Bc bytes: 20 KiB at that plan)
// and the κ blocks g_ℓ = itab[ℓ, h] of y (Br elements each, one after
// another: a word's row ℓ·Br + row indexes them as they lie), 24 KiB there,
// so several stages fit and the fills of the next items run under the sums
// of one.  Persistent blocks walk runs of items through the ring, filled by
// 1-D bulk copies on the stage's mbarrier (4-byte cp.async or loads where a
// span is not 16-byte aligned).  Thread u owns row u of X's block (u,
// u + blockDim, …): its κ·s words are one 16-byte shared load where κ·s = 8,
// and it adds acc = fma(y[w >> 1], ±1, acc) in word order from +0, then ×
// scale: the staged kernel's sums, so the same bits.  X's Bc outputs go out
// as one coalesced store.
__host__ __device__ inline long long narrow_t_spans(int Br, int Bc, int kappa,
                                                    int s, int item,
                                                    long long* y_at) {
  const long long words = fs::align16(2LL * kappa * s * Bc);
  *y_at = words;
  return words + fs::align16(static_cast<long long>(kappa) * Br * item);
}

template <typename T, int kCopy>
__global__ void __launch_bounds__(512)
narrow_transpose_kernel(const T* __restrict__ Y, float* __restrict__ X,
                        const int* __restrict__ itab,
                        const unsigned short* __restrict__ ent, int M, int Br,
                        int Bc, int kappa, int s, float scale, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  long long y_at;
  const long long stage_bytes = narrow_t_spans(
      Br, Bc, kappa, s, static_cast<int>(sizeof(T)), &y_at);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  const int ks = kappa * s;
  const bool wvec = ks % kUnrollT == 0;        // a row's words: 16-byte loads
  const long long per_block = static_cast<long long>(Bc) * ks;
  const long long y_bytes = static_cast<long long>(Br) * sizeof(T);
  const long long first = static_cast<long long>(M) * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(
      static_cast<long long>(M) * (blockIdx.x + 1) / gridDim.x - first);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st)
      mbar_init(full + st, kCopy == fs::kCopyBulk ? 1u : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // stage t % stages <- input block h = first + t: its rows' words and the
  // κ blocks of y they name
  auto fill = [&](int t) {
    const long long h = first + t;
    unsigned char* stg = ring + (t % stages) * stage_bytes;
    uint64_t* bar = full + t % stages;
    if constexpr (kCopy == fs::kCopyBulk) {
      if (threadIdx.x != 0) return;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(bar, static_cast<uint32_t>(2 * per_block +
                                                kappa * y_bytes));
      fs::bulk_copy(stg, ent + h * per_block,
                    static_cast<uint32_t>(2 * per_block), bar);
      for (int ell = 0; ell < kappa; ++ell)
        fs::bulk_copy(stg + y_at + ell * y_bytes,
                      Y + static_cast<long long>(__ldg(itab + ell * M + h)) *
                              Br,
                      static_cast<uint32_t>(y_bytes), bar);
    } else {
      fs::share_copy<kCopy>(stg, ent + h * per_block, 2 * per_block);
      for (int ell = 0; ell < kappa; ++ell)
        fs::share_copy<kCopy>(
            stg + y_at + ell * y_bytes,
            Y + static_cast<long long>(__ldg(itab + ell * M + h)) * Br,
            y_bytes);
      fs::share_arrive<kCopy>(bar);
    }
  };
  for (int t = 0; t < min(stages, count); ++t) fill(t);

  for (int t = 0; t < count; ++t) {
    const long long h = first + t;
    const unsigned char* stg = ring + (t % stages) * stage_bytes;
    const unsigned short* ws = reinterpret_cast<const unsigned short*>(stg);
    const T* ys = reinterpret_cast<const T*>(stg + y_at);
    mbar_wait(full + t % stages, static_cast<uint32_t>((t / stages) & 1));
    for (int u = threadIdx.x; u < Bc; u += blockDim.x) {
      const unsigned short* wr = ws + static_cast<long long>(u) * ks;
      float acc = 0.f;
      for (int e0 = 0; e0 < ks; e0 += kUnrollT) {
        int w[kUnrollT];
        if (wvec) {
          const uint4 q = *reinterpret_cast<const uint4*>(wr + e0);
#pragma unroll
          for (int k = 0; k < kUnrollT; ++k)
            w[k] = static_cast<int>(
                (fs::word_of(q, k >> 1) >> (16 * (k & 1))) & 0xFFFFu);
        } else {
#pragma unroll
          for (int k = 0; k < kUnrollT; ++k)
            w[k] = e0 + k < ks ? static_cast<int>(wr[e0 + k]) : 0;
        }
        float v[kUnrollT];
#pragma unroll
        for (int k = 0; k < kUnrollT; ++k)
          v[k] = e0 + k < ks ? fs::to_f32(ys[w[k] >> 1]) : 0.f;
#pragma unroll
        for (int k = 0; k < kUnrollT; ++k) {
          if (e0 + k >= ks) break;
          const float pm = __uint_as_float(
              0x3F800000u | (static_cast<uint32_t>(w[k]) << 31));
          acc = fmaf(v[k], pm, acc);
        }
      }
      X[h * Bc + u] = acc * scale;
    }
    __syncthreads();                          // every read of the stage done
    if (t + stages < count) fill(t + stages);
  }
}

template <typename T, int kCopy>
int launch_narrow_t_mode(const void* Y, void* X, const void* itab,
                         const void* ent, int M, int Br, int Bc, int kappa,
                         int s, float scale, int threads, int stages,
                         int blocks, int smem, void* stream) {
  auto kern = narrow_transpose_kernel<T, kCopy>;
  cudaError_t err;
  const long long grid =
      fs::persistent_grid(kern, threads, smem, blocks, M, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned int>(grid), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), static_cast<float*>(X),
      static_cast<const int*>(itab), static_cast<const unsigned short*>(ent),
      M, Br, Bc, kappa, s, scale, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_narrow_t(const void* Y, void* X, const void* itab, const void* ent,
                    const long long* p, float scale, void* stream) {
  const int M = static_cast<int>(p[1]), Br = static_cast<int>(p[2]);
  const int Bc = static_cast<int>(p[3]), kappa = static_cast<int>(p[4]);
  const int s = static_cast<int>(p[5]), threads = static_cast<int>(p[6]);
  const int stages = static_cast<int>(p[7]), blocks = static_cast<int>(p[8]);
  const int smem = static_cast<int>(p[9]), mode = static_cast<int>(p[10]);
#define FS_MODE(K)                                                          \
  launch_narrow_t_mode<T, K>(Y, X, itab, ent, M, Br, Bc, kappa, s, scale,    \
                             threads, stages, blocks, smem, stream)
  switch (mode) {
    case fs::kCopyBulk: return FS_MODE(fs::kCopyBulk);
    case fs::kCopyAsync4: return FS_MODE(fs::kCopyAsync4);
    case fs::kCopyPlain: return FS_MODE(fs::kCopyPlain);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FS_MODE
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

// X (d_pad, n) fp32 = Sᵀ · Y (k_pad, n), both row-major and contiguous, for
// a blockperm plan, through the staged kernel; itab is the (κ, M) int32
// inverse neighbour table and ent the 16-bit CSR words of Sᵀ with
// tile-local rows (κ·s a row), both on the device.  The integers come in one array,
// p = {dtype, M, Br, Bc, κ, s, n, threads, stages, box_rows, blocks, smem,
// mode}: threads the block's (kStagedThreads), `stages` stages of
// κ·Br·128 bytes in `smem` bytes (with 128 bytes of alignment slack and an
// 8-byte mbarrier a stage), box_rows a divisor of Br of at most 256 (mode
// 0), blocks 0 for the SMs times the blocks resident on each (else that
// many), mode 0 TMA (Y 16-byte aligned, n·itemsize a multiple of 16), 1
// cp.async of 4-byte words (both 4-byte aligned), 2 plain loads.  Launches
// on `stream` and returns cudaGetLastError() (0 on success), or 100000 + the
// CUresult of a refused TMA descriptor.
int fs_transpose(const void* Yin, void* X, const void* itab, const void* ent,
                 const long long* p, float scale, void* stream) {
#define FS_LAUNCH(T) launch_staged<T>(Yin, X, itab, ent, p, scale, stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
#undef FS_LAUNCH
}

// The narrow transpose at n = 1 (narrow_transpose_kernel): X (d_pad,) fp32
// = Sᵀ · y (k_pad,), both contiguous, for a blockperm plan; itab is the
// (κ, M) int32 inverse neighbour table and ent the 16-bit CSR words of Sᵀ
// with tile-local rows (κ·s a row), both on the device.  The integers come
// in one array, p = {dtype, M, Br, Bc, κ, s, threads, stages, blocks, smem,
// mode}: blocks 0 for the SMs times the blocks resident on each, mode a
// NarrowCopy (0 bulk copies: y 16-byte aligned, 2·κ·s·Bc and Br·itemsize
// multiples of 16; 1 4-byte cp.async: κ·s·Bc even, Br·itemsize a multiple
// of 4, y 4-byte aligned; 2 loads).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int fs_transpose_narrow(const void* Yin, void* X, const void* itab,
                        const void* ent, const long long* p, float scale,
                        void* stream) {
#define FS_LAUNCH(T) launch_narrow_t<T>(Yin, X, itab, ent, p, scale, stream)
  FS_DISPATCH(static_cast<int>(p[0]), FS_LAUNCH)
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
  if (err < kCuResultBase)
    return cudaGetErrorString(static_cast<cudaError_t>(err));
  const char* msg = "cuTensorMapEncodeTiled failed";
  auto describe = reinterpret_cast<GetErrorString>(
      libcuda_symbol("cuGetErrorString"));
  if (describe != nullptr)
    describe(static_cast<CUresult>(err - kCuResultBase), &msg);
  return msg;
}

}  // extern "C"
