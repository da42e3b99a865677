// Flash-attention forward for Hopper (sm_90a) at long sequences: TMA loads
// into a ring of shared-memory stages, wgmma products, a producer warp and
// two consumer warpgroups.
//
// Replaces, at long L, the TPU kernel dragonfly2_tpu/ops/flash.py::_flash_kernel
// (:71, launched by _flash_forward's pallas_call, :340) in its three modes,
// as csrc/flash_fwd.cu does at every L; ops/flash.py picks this source for
// bf16 inputs above SM90_MIN_L (_sm90_path) and flash_fwd.cu's mma.sync
// instances for shorter sets and float32. It computes what flash_fwd.cu
// computes: o = softmax(q k^T / sqrt(D)) v over [B, H, L, D], a [B, L]
// key-validity mask (or none), optional causal masking, online softmax in
// base 2 with float32 statistics and accumulators, P rounded to bf16 before
// P V.
// - dfly_flash_fwd_sm90: finished output.
// - dfly_flash_fwd_lse_sm90: and lse [B, H, L] f32 = m ln2 + log(max(l,
//   1e-30)); a row with no valid key keeps m = -1e30, l = 0: a finite filler.
// - dfly_flash_fwd_partial_sm90: unnormalised acc [B, H, L, D] f32, row_max
//   = m ln2 and row_sum = l [B, H, L] f32; a row with no valid key leaves
//   with row_max = -1e30 ln2, row_sum = 0, acc = 0. Never causal.
// Rows with no valid key come out exactly 0. Head dims 16, 32, 64, 128;
// and the wide instances (dfly_flash_fwd_wide_sm90,
// dfly_flash_fwd_lse_wide_sm90, dfly_flash_fwd_partial_wide_sm90) take any
// head dim in (128, 256] with D % 8 == 0 as it is, at a compile-time width
// of 192 (D up to 192) or 256: the tensor maps hold the real D, so the
// columns past it arrive as zeros and add nothing to Q K^T, and the stores
// stop at D. No caller pads.
//
// What bounds it on an H100: 4 B H L^2 D operations (Q K^T and P V) against
// 4 B H L D bf16 elements moved (q, k, v, o; the partial mode's float32 acc
// adds 2 B H L D bytes). At [4, 8, 2048, 128] that is 68.7 GFLOP, 69 us at
// the 989 TFLOP/s bf16 tensor-core peak, against 67 MB, 20 us of bytes: bound by
// operations, as is every L above a few hundred. Beside the products every
// (query, key) pair costs an exp2 and a few float32 operations, so at head
// dim 32 the multi-function unit and the FMA pipes come close to the tensor
// cores' time.
//
// Design:
// - One block per (128 query rows, head, batch): two consumer warpgroups of
//   64 rows each and one producer warp, 288 threads, so the register file
//   goes mostly to the consumers without setmaxnreg: up to 168 registers a
//   thread at head dims 64 and 128 (one block an SM; ptxas's cap for 288
//   threads), 96 at 16 and 32 (two blocks an SM, four consumer warpgroups
//   to hide each other's latency).
// - The producer warp issues TMA loads: the block's Q tile once, then K/V
//   tiles of 64 keys into a three-stage ring in dynamic shared memory, each
//   stage completing on a full barrier and released by an empty barrier that
//   the eight consumer warps arrive on. The producer's lanes ballot the
//   stage's key validity (mask and key < L) into a word beside it before
//   they arrive. TMA reads the tensors as [B H, L, D], so rows past L arrive
//   as zeros.
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major). P is formed in the accumulator registers (mask to -inf,
//   running max across the quad, exp2 on the multi-function unit, a row with
//   no valid key exponentiating against 0 so it never gets exp2(x - m) = 1;
//   tiles with every key valid and off the causal diagonal skip the masking,
//   the producer's ballot of the tile's keys being one 64-bit word) and fed
//   back, rounded to bf16, as the register A operand of O += P V, with V the
//   MN-major B operand. The producer's ring, the tile products, the masking
//   and the A-operand packing are sm90.cuh's, shared with dQ.
//   The [L, L] scores never leave registers.
// - Within a warpgroup, tile j's S = Q K^T and tile j-1's O += P V are
//   issued together; tile j's softmax runs while P V is on the tensor cores,
//   and O takes tile j's correction once P V is done.
// - Causal blocks stop at the last key tile that reaches their last row.
// - One thread of each quad writes the per-row statistics; the outputs are
//   stored from the accumulators, stopping at L.
// - The wide instances (width W = 192 or 256) replace the TPU kernel's
//   wide calls as csrc/flash_fwd.cu's wide mma.sync instance does at every
//   L, for bf16 above WIDE_SM90_MIN_L (ops/flash.py). O for 64 rows at
//   W = 256 is 128 float32 registers a thread, with S (32) and P's A
//   fragments (16) beside it: past the 168 that ptxas gives a 288-thread
//   block. So a wide block has one consumer warpgroup of 64 rows and the
//   producer warp, 160 threads with up to 255 registers each, and the
//   same code path. Shared memory at W = 256: Q 32 KB and three stages of
//   K and V at 32 KB each, 224 KB of the 227 KB a block may have. Bound on
//   an H100: at the ring's block, [2, 4, 1024, 192] bf16, 4 B H L^2 D =
//   6.4 GFLOP (6.5 us at 989 TFLOP/s) against 6.3 MB of q, k, v and a
//   float32 acc (1.9 us): bound by operations.

#include <math.h>

#include <type_traits>

#include "flash_entries.h"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int MODE_OUT = 0;      // finished output
constexpr int MODE_LSE = 1;      // finished output and lse
constexpr int MODE_PARTIAL = 2;  // unnormalised acc (float32), row max, row sum

template <int MODE>
using out_t = std::conditional_t<MODE == MODE_PARTIAL, float, __nv_bfloat16>;

template <int HEAD_DIM>
struct Fwd {
  static constexpr int D = HEAD_DIM;  // the wide instances' compile-time width
  static constexpr bool WIDE = D > 128;
  static constexpr int WGS = WIDE ? 1 : 2;  // consumer warpgroups, 64 rows each
  static constexpr int BM = 64 * WGS;       // query rows per block
  static constexpr int BN = 64;   // keys per K/V tile
  static constexpr int STAGES = 3;
  // blocks an SM: two at head dims 16 and 32 (up to 96 registers a
  // thread), where one block's two warpgroups leave the SM waiting on
  // latency; one from 64, whose accumulators need more
  static constexpr int MIN_BLOCKS = D <= 32 ? 2 : 1;
  static constexpr int COLS = D < 64 ? D : 64;  // columns per swizzled block
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int CBLOCKS = D / COLS;
  static constexpr int CONSUMER_WARPS = 4 * WGS;
  static constexpr int THREADS = CONSUMER_WARPS * 32 + 32;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  // shared memory from a 1024-byte aligned base; tiles are multiples of 1 KB
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_VALID = OFF_V + STAGES * KV_BYTES;  // a 64-bit key mask a stage
  static constexpr int OFF_BAR = OFF_VALID + STAGES * 8;
  static constexpr int BARS = 1 + 2 * STAGES;  // Q, full[], empty[]
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + room to align the base
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// the tile's scores become probabilities in place: mask, update the running
// max m (log2 domain) and sum l of the thread's rows lo and hi (the max
// reduced across the quad), and leave in corr the factor the output so far
// takes. Masked scores are -inf, so their exp2 is exactly 0; a row with no
// valid key so far keeps m = NEG_BIG and exponentiates against 0 instead,
// never getting a bogus exp2(x - m) = 1.
template <typename C>
__device__ __forceinline__ void softmax_tile(float (&sc)[C::BN / 2], float (&m_row)[2],
                                             float (&l_row)[2], float (&corr)[2],
                                             uint64_t valid, int n0, int row_lo, int row_hi,
                                             int t, bool diag, float scale_log2) {
  mask_scores<C>(sc, valid, n0, row_lo, row_hi, t, diag);
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sc[4 * nt + e]);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m_row[r], tile_max[r] * scale_log2);
    corr[r] = ex2(m_row[r] - m_new);
    m_row[r] = m_new;
    m_use[r] = m_new == NEG_BIG ? 0.f : m_new;
  }
  float tile_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < C::BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * nt + e], scale_log2, -m_use[e >> 1]));
      sc[4 * nt + e] = p;
      tile_sum[e >> 1] += p;
    }
  }
  l_row[0] = l_row[0] * corr[0] + tile_sum[0];
  l_row[1] = l_row[1] * corr[1] + tile_sum[1];
}

// stat0: lse (MODE_LSE) or row max (MODE_PARTIAL); stat1: row sum
// (MODE_PARTIAL); both unused otherwise
template <int D, int MODE>
__global__ void __launch_bounds__(Fwd<D>::THREADS, Fwd<D>::MIN_BLOCKS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                      out_t<MODE>* __restrict__ o, float* __restrict__ stat0,
                      float* __restrict__ stat1, int H, int L, int d, int num_qblocks,
                      int causal, float scale_log2) {
  using C = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + C::OFF_K;
  uint8_t* sV = smem + C::OFF_V;
  uint64_t* sValid = reinterpret_cast<uint64_t*>(smem + C::OFF_VALID);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::STAGES;

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const int q0 = qb * C::BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // causal: keys past the block's last query row are masked for every row
  const int kv_end = causal ? min(L, q0 + C::BM) : L;
  const int n_tiles = (kv_end + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);                     // the producer's lanes
      mbar_init(&empty[s], C::CONSUMER_WARPS);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::CONSUMER_WARPS) {
    // ---- producer warp: Q once, then the K/V ring
    const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CBLOCKS; ++c) {
        tma_load_3d(sQ + c * C::BM * C::ROW_BYTES, &tm_q, bar_q, c * C::COLS, q0, bh);
      }
    }
    produce_kv<C>(&tm_k, &tm_v, sK, sV, sValid, full, empty, mb, n_tiles, L, bh, lane);
    return;
  }

  // ---- consumer warpgroups: wg owns query rows q0 + 64 wg ..
  const int wg = warp >> 2;
  const int t = lane & 3;  // thread within the quad
  const int warp_row0 = q0 + 64 * wg + 16 * (warp & 3);  // the warp's first query row
  const int row_lo = warp_row0 + (lane >> 2);
  const int row_hi = row_lo + 8;
  const uint8_t* sQw = sQ + 64 * wg * C::ROW_BYTES;

  float acc[D / 2];  // O: register 4 dn + e is row lo/hi (e >> 1), column 8 dn + 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_row[2] = {NEG_BIG, NEG_BIG};  // running max (log2 domain) of rows lo, hi
  float l_row[2] = {0.f, 0.f};          // this thread's share of the running sums
  float sc[C::BN / 2];                  // S, then P, of the current tile
  uint32_t pa[C::BN / 16][4];           // P of the previous tile, the A operand of P V
  float corr[2];

  // tile 0: its scores, then its probabilities
  mbar_wait(bar_q, 0);
  mbar_wait(&full[0], 0);
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  scores<C>(sc, sQw, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<C>(sc, m_row, l_row, corr, sValid[0], 0, row_lo, row_hi, t,
                  causal && C::BN - 1 > warp_row0, scale_log2);
  to_a_operand<C>(sc, pa);

  // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} go to the tensor cores
  // together; the softmax of S_j runs while P V does, and O takes tile j's
  // correction once P V is done
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int prev = (j - 1) % C::STAGES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    scores<C>(sc, sQw, sK + s * C::KV_BYTES);
    wgmma_commit();
    p_times_v<C>(acc, pa, sV + prev * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();  // S_j; P V may still run
    fence_regs(sc);
    softmax_tile<C>(sc, m_row, l_row, corr, sValid[s], j * C::BN, row_lo, row_hi, t,
                    causal && j * C::BN + C::BN - 1 > warp_row0, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);  // K_{j-1}, V_{j-1} and their flags are read
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[4 * dn + 0] *= corr[0];
      acc[4 * dn + 1] *= corr[0];
      acc[4 * dn + 2] *= corr[1];
      acc[4 * dn + 3] *= corr[1];
    }
    to_a_operand<C>(sc, pa);
  }
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
  p_times_v<C>(acc, pa, sV + ((n_tiles - 1) % C::STAGES) * C::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);

  // finish: full row sums across the quad, then the mode's outputs for the
  // rows inside L
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // the partial mode leaves acc unnormalised
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
  // rows of d elements: d == D but at the wide instances, whose stores
  // stop at d (d % 8 == 0: an 8-column tile is all below it or all past it)
  out_t<MODE>* oh = o + static_cast<size_t>(bh) * L * d;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (C::WIDE && dn * 8 >= d) continue;
    if (row_lo < L) {
      store2(oh + static_cast<size_t>(row_lo) * d + col, acc[4 * dn] * inv_lo,
             acc[4 * dn + 1] * inv_lo);
    }
    if (row_hi < L) {
      store2(oh + static_cast<size_t>(row_hi) * d + col, acc[4 * dn + 2] * inv_hi,
             acc[4 * dn + 3] * inv_hi);
    }
  }
  // m and l are equal across the quad after the reductions: one writer
  if constexpr (MODE == MODE_LSE) {
    if (t == 0) {
      float* lh = stat0 + static_cast<size_t>(bh) * L;
      if (row_lo < L) lh[row_lo] = m_row[0] * LN2 + logf(fmaxf(l_row[0], 1e-30f));
      if (row_hi < L) lh[row_hi] = m_row[1] * LN2 + logf(fmaxf(l_row[1], 1e-30f));
    }
  }
  if constexpr (MODE == MODE_PARTIAL) {
    if (t == 0) {
      float* mh = stat0 + static_cast<size_t>(bh) * L;
      float* sh = stat1 + static_cast<size_t>(bh) * L;
      if (row_lo < L) {
        mh[row_lo] = m_row[0] * LN2;
        sh[row_lo] = l_row[0];
      }
      if (row_hi < L) {
        mh[row_hi] = m_row[1] * LN2;
        sh[row_hi] = l_row[1];
      }
    }
  }
}

// d: the tensors' head dim, D itself but at the wide widths (d <= D)
template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, float* stat0,
           float* stat1, int B, int H, int L, int d, int causal, float scale,
           cudaStream_t stream) {
  using C = Fwd<D>;
  const long long planes = static_cast<long long>(B) * H;
  const int num_qblocks = (L + C::BM - 1) / C::BM;
  const long long blocks = planes * num_qblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode_rows(&tq, q, d, L, planes, C::BM);
  if (err == 0) err = encode_rows(&tk, k, d, L, planes, C::BN);
  if (err == 0) err = encode_rows(&tv, v, d, L, planes, C::BN);
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<D, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = LOG2E * scale;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const uint8_t*>(mask), static_cast<out_t<MODE>*>(o), stat0, stat1, H,
      L, d, num_qblocks, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int by_dim(const void* q, const void* k, const void* v, const void* mask, void* o, void* stat0,
           void* stat1, int B, int H, int L, int D, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s0 = static_cast<float*>(stat0);
  float* s1 = static_cast<float*>(stat1);
  switch (D) {
    case 16: return launch<16, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    case 32: return launch<32, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    case 64: return launch<64, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    case 128: return launch<128, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the wide instances: a head dim in (128, 256] with D % 8 == 0, at the
// width 192 up to D = 192, else 256
template <int MODE>
int wide_by_dim(const void* q, const void* k, const void* v, const void* mask, void* o,
                void* stat0, void* stat1, int B, int H, int L, int D, int causal, float scale,
                void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 128 || D > 256 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s0 = static_cast<float*>(stat0);
  float* s1 = static_cast<float*>(stat1);
  if (D <= 192) return launch<192, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  return launch<256, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
}

}  // namespace

// The entries, declared with their layouts in flash_entries.h, each in
// the part of the build that compiles it (DFLY_IN_PART there).
#if DFLY_IN_PART(0)
extern "C" int dfly_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int L, int D, int causal, float scale,
                                   void* stream) {
  return by_dim<MODE_OUT>(q, k, v, mask, o, nullptr, nullptr, B, H, L, D, causal, scale, stream);
}
#endif

#if DFLY_IN_PART(0)
extern "C" int dfly_flash_fwd_lse_sm90(const void* q, const void* k, const void* v,
                                       const void* mask, void* o, void* lse, int B, int H, int L,
                                       int D, int causal, float scale, void* stream) {
  return by_dim<MODE_LSE>(q, k, v, mask, o, lse, nullptr, B, H, L, D, causal, scale, stream);
}
#endif

#if DFLY_IN_PART(0)
extern "C" int dfly_flash_fwd_partial_sm90(const void* q, const void* k, const void* v,
                                           const void* mask, void* acc, void* row_max,
                                           void* row_sum, int B, int H, int L, int D, float scale,
                                           void* stream) {
  return by_dim<MODE_PARTIAL>(q, k, v, mask, acc, row_max, row_sum, B, H, L, D, 0, scale,
                              stream);
}
#endif

#if DFLY_IN_PART(1)
extern "C" int dfly_flash_fwd_wide_sm90(const void* q, const void* k, const void* v,
                                        const void* mask, void* o, int B, int H, int L, int D,
                                        int causal, float scale, void* stream) {
  return wide_by_dim<MODE_OUT>(q, k, v, mask, o, nullptr, nullptr, B, H, L, D, causal, scale,
                               stream);
}
#endif

#if DFLY_IN_PART(1)
extern "C" int dfly_flash_fwd_lse_wide_sm90(const void* q, const void* k, const void* v,
                                            const void* mask, void* o, void* lse, int B, int H,
                                            int L, int D, int causal, float scale, void* stream) {
  return wide_by_dim<MODE_LSE>(q, k, v, mask, o, lse, nullptr, B, H, L, D, causal, scale, stream);
}
#endif

#if DFLY_IN_PART(1)
extern "C" int dfly_flash_fwd_partial_wide_sm90(const void* q, const void* k, const void* v,
                                                const void* mask, void* acc, void* row_max,
                                                void* row_sum, int B, int H, int L, int D,
                                                float scale, void* stream) {
  return wide_by_dim<MODE_PARTIAL>(q, k, v, mask, acc, row_max, row_sum, B, H, L, D, 0, scale,
                                   stream);
}
#endif

#if DFLY_IN_PART(0)
extern "C" const char* dfly_cuda_error_string(int err) { return sm90::error_string(err); }
#endif
