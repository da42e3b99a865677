// Hopper (sm_90a) building blocks shared by the TMA + wgmma flash kernels
// (flash_fwd_sm90.cu, flash_bwd_dkv_sm90.cu, flash_bwd_dq_sm90.cu, their
// wide instances included):
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and
// instructions, the tile products of the kernels whose block owns query
// rows, and the host-side TMA descriptor encoder.
//
// Tile layout. A [rows, D] bf16 tile sits in shared memory as D / COLS
// column blocks of [rows, COLS] (COLS = min(D, 64), so a row of a block is
// 32, 64 or 128 bytes), each written by one TMA box with the swizzle of its
// row width (32B, 64B, 128B) and read by wgmma through a descriptor of the
// same swizzle. Every block starts on a 1024-byte boundary, so the swizzle
// pattern (a function of the shared address) is the same for both. The
// wide instances' D (their compile-time width, 192 or 256) may exceed the
// tensor's head dim: the tensor map holds the real one, so the columns
// past it, and whole boxes past it, arrive as zeros.
// - K-major operand (the reduction runs along a row: Q and K in Q K^T, K
//   and Q in K Q^T): the descriptor points at the first row; a 16-element
//   k step advances the start address by 32 bytes inside the swizzled row;
//   8-row groups are 8 * row bytes apart (SBO).
// - MN-major operand (the reduction runs down the rows: V in P V, dO and Q
//   in P^T dO and dS^T Q): the instruction's N is one column block, so only
//   the 8-row group stride is used; a 16-row k step advances the start by
//   16 rows. LBO and SBO both hold the 8-row stride, which is right whichever
//   of the two the hardware reads for the K direction of this layout.
//
// Accumulators. wgmma m64nNk16 leaves warp w of the warpgroup rows 16w..16w+15
// in the fragment layout of mma.sync m16n8 (register 4j + e: row g + 8 (e >> 1),
// column 8j + 2t + (e & 1), g = lane / 4, t = lane % 4), and takes a register
// A operand in the m16n8k16 A layout, so two adjacent 8-column accumulator
// tiles, rounded to bf16, are one 16-deep A fragment.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_entries.h"

namespace sm90 {

// a TMA descriptor cuTensorMapEncodeTiled refused: the entry returns this + the CUresult
constexpr int TMAP_ERROR = DFLY_TMAP_ERROR;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// a wait this long (~10 s of SM clock) means a pipeline that can never
// complete: the kernel traps, so the launch fails instead of hanging the card
constexpr long long WAIT_LIMIT_CYCLES = 20000000000LL;

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > WAIT_LIMIT_CYCLES) __trap();
  }
}

// --------------------------------------------------------------------- TMA

// box (c0, c1, c2) of a 3-D tensor map into shared memory; completes
// (bytes) on bar. Rows outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// shared-memory matrix descriptor of a tile block with ROW_BYTES-byte
// swizzled rows (32, 64, 128)
template <int ROW_BYTES, bool MN_MAJOR>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  static_assert(ROW_BYTES == 32 || ROW_BYTES == 64 || ROW_BYTES == 128, "swizzle width");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : (ROW_BYTES == 64 ? 2 : 3);
  constexpr uint64_t group = (8 * ROW_BYTES) >> 4;  // 8-row stride, 16-byte units
  constexpr uint64_t lead = MN_MAJOR ? group : 1;
  const uint64_t addr = (smem_addr(p) & 0x3FFFFu) >> 4;
  return addr | (lead << 16) | (group << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a wgmma's accumulator
// registers, or reusing its register A operand, across the asynchronous
// product: before the issue and after the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// d[32] += A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[16] += A (64 x 16, shared, K-major) * B (16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[8] += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t a[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16] += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t a[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t desc_b) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs width");
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, desc_b);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

// lower 16 bits hold the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// two adjacent output elements, one store
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// 2^x on the multi-function unit (ex2.approx, flushing denormals); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- query-row blocks, key tiles
//
// The forward and dQ own BM query rows a block, 64 a consumer warpgroup,
// and sweep [BN, D] key tiles (K, V). C is the kernel's tile configuration:
// D, BM, BN, STAGES, KV_BYTES (one K or V tile) and COLS, ROW_BYTES,
// CBLOCKS of the layout above. A thread's [64, BN] score accumulators hold
// its rows lo (g) and hi (g + 8) against keys 8 nt + 2 t + (e & 1) in
// register 4 nt + e.

// The producer warp's K/V ring over key tiles 0 .. n_tiles - 1: tile j
// waits for stage j % STAGES to be empty, its lanes ballot the tile's key
// validity (key < L and the batch row's mask byte, mb null for none) into
// valid[stage], and lane 0 loads the K and V tiles by TMA onto full[stage]
template <typename C>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           uint8_t* sK, uint8_t* sV, uint64_t* valid,
                                           uint64_t* full, uint64_t* empty, const uint8_t* mb,
                                           int n_tiles, int L, int bh, int lane) {
  static_assert(C::BN == 64, "one bit of a 64-bit word per key of a tile");
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int n0 = j * C::BN;
    mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
    const int key0 = n0 + lane;
    const int key1 = key0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, key0 < L && (mb == nullptr || mb[key0] != 0));
    const uint32_t hi = __ballot_sync(0xffffffffu, key1 < L && (mb == nullptr || mb[key1] != 0));
    if (lane == 0) {
      valid[s] = lo | (static_cast<uint64_t>(hi) << 32);
      mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < C::CBLOCKS; ++c) {
        const int at = s * C::KV_BYTES + c * C::BN * C::ROW_BYTES;
        tma_load_3d(sK + at, tm_k, &full[s], c * C::COLS, n0, bh);
        tma_load_3d(sV + at, tm_v, &full[s], c * C::COLS, n0, bh);
      }
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// S += A_w B^T over D: 64 rows of a warpgroup's slice of a [BM, D] tile
// (Q, or dO) x the BN rows of a key tile (K, or V), both K-major
template <typename C>
__device__ __forceinline__ void scores(float (&sc)[C::BN / 2], const uint8_t* aw,
                                       const uint8_t* kt) {
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    const int blk = kk * 16 / C::COLS;       // column block
    const int at = (kk * 16 % C::COLS) * 2;  // bytes into its swizzled rows
    wgmma_ss_n64(sc, smem_desc<C::ROW_BYTES, false>(aw + blk * C::BM * C::ROW_BYTES + at),
                 smem_desc<C::ROW_BYTES, false>(kt + blk * C::BN * C::ROW_BYTES + at));
  }
}

// O += P V over a key tile, P the register A operand (16 keys a k step),
// the tile MN-major, one wgmma per column block of O; dQ's dS K is the same
// product with K in V's place
template <typename C>
__device__ __forceinline__ void p_times_v(float (&acc)[C::D / 2], const uint32_t (&pa)[C::BN / 16][4],
                                          const uint8_t* vt) {
#pragma unroll
  for (int c = 0; c < C::CBLOCKS; ++c) {
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      wgmma_rs<C::COLS>(acc + c * (C::COLS / 2), pa[ks],
                        smem_desc<C::ROW_BYTES, true>(vt + c * C::BN * C::ROW_BYTES +
                                                      ks * 16 * C::ROW_BYTES));
    }
  }
}

// masked (query, key) pairs of the tile to -inf: keys whose bit of ``bits``
// (shifted so bit 8 nt + (e & 1) is this thread's key 8 nt + 2 t + (e & 1))
// is 0, if MASKED; keys past the row, if DIAG (a causal tile that reaches
// past the warp's first row)
template <typename C, bool MASKED, bool DIAG>
__device__ __forceinline__ void mask_tile(float (&sc)[C::BN / 2], uint64_t bits, int n0,
                                          int row_lo, int row_hi, int t) {
#pragma unroll
  for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool ok = true;
      if (MASKED) ok = (bits >> (nt * 8 + (e & 1))) & 1u;
      if (DIAG) ok = ok && n0 + nt * 8 + 2 * t + (e & 1) <= ((e < 2) ? row_lo : row_hi);
      sc[4 * nt + e] = ok ? sc[4 * nt + e] : -INFINITY;
    }
  }
}

// mask_tile where needed: ``valid`` is the tile's key-validity ballot (bit
// n: key n0 + n), all ones on a tile with no invalid key; ``diag``, the
// tile reaches past the warp's first row of a causal block
template <typename C>
__device__ __forceinline__ void mask_scores(float (&sc)[C::BN / 2], uint64_t valid, int n0,
                                            int row_lo, int row_hi, int t, bool diag) {
  const uint64_t bits = valid >> (2 * t);
  if (valid != ~0ull) {
    if (diag) {
      mask_tile<C, true, true>(sc, bits, n0, row_lo, row_hi, t);
    } else {
      mask_tile<C, true, false>(sc, bits, n0, row_lo, row_hi, t);
    }
  } else if (diag) {
    mask_tile<C, false, true>(sc, bits, n0, row_lo, row_hi, t);
  }
}

// two adjacent 8-key accumulator tiles, rounded to bf16, are one 16-key A
// fragment
template <typename C>
__device__ __forceinline__ void to_a_operand(const float (&sc)[C::BN / 2],
                                             uint32_t (&pa)[C::BN / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < C::BN / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------- the host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library
// does not link: it is looked up once through the runtime
inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// TMA descriptor of a contiguous bf16 [planes, rows, D] tensor, read in
// boxes of [box_rows, cols] (cols = min(D, 64)) with the swizzle smem_desc
// expects (D % 8 == 0: a row's stride is a multiple of 16 bytes); 0, or
// TMAP_ERROR + the CUresult
inline int encode_rows(CUtensorMap* map, const void* base, int D, int rows, long long planes,
                       int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return TMAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const int cols = D < 64 ? D : 64;
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TMAP_ERROR + static_cast<int>(res);
}

inline const char* error_string(int err) {
  if (err >= TMAP_ERROR) {
    return "cuTensorMapEncodeTiled refused a TMA descriptor (the code less 10000 is its CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace sm90
