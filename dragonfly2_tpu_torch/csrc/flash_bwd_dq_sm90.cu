// Flash-attention dQ backward for Hopper (sm_90a) at long sequences: TMA
// loads into a ring of shared-memory stages, wgmma products, a producer
// warp and one or two consumer warpgroups.
//
// Replaces, at long L, the TPU kernel
// dragonfly2_tpu/ops/flash.py::_flash_bwd_dq_kernel (:474, launched by the
// pallas_call at :667), as csrc/flash_bwd.cu's dfly_flash_bwd_dq does at
// every L; ops/flash.py picks this source for bf16 inputs above SM90_MIN_L
// (_sm90_path). Given q, k, v, dO [B, H, L, D] bf16, the forward's lse and
// delta = rowsum(dO * o) [B, H, L] float32, a [B, L] key-validity mask (or
// none) and the causal flag, per (query, key) pair:
//   P  = exp2(S log2(e)/sqrt(D) - lse log2(e)) on valid pairs, exactly 0 elsewhere
//   dS = P (dO V^T - delta);  dQ = sum over keys of dS K / sqrt(D)
// with dS rounded to bf16 before dS K, dQ summed in float32 and stored in
// bf16. Head dims 16, 32, 64, 128. A batch row with no valid key gives dQ
// exactly 0.
//
// What bounds it on an H100: 6 B H L^2 D operations (S, dP, dS K) against
// 5 B H L D bf16 elements (q, k, v, dO, dQ) and 2 B H L float32 rows (lse,
// delta) moved. At [4, 8, 2048, 128] that is 103 GFLOP, 104 us at the 989
// TFLOP/s bf16 tensor-core peak (~87 us over the valid pairs of an 85%
// mask), against 84 MB, 25 us: bound by operations. Each pair also costs an
// exp2 and a few float32 operations, which at head dim 32 come close to the
// tensor cores' time.
//
// Design: the forward's (flash_fwd_sm90.cu), with dS in P's place.
// - One block per (64 NWG query rows, head, batch): NWG consumer
//   warpgroups of 64 rows and one producer warp, one block an SM. A thread
//   keeps dQ's D / 2 float32 accumulators, S's and dP's 32 each and the
//   previous tile's dS as 16 bf16 pairs, all in flight at once. ptxas gives
//   a 288-thread block 168 registers a thread (96 at two blocks an SM), so
//   head dim 128 takes one consumer warpgroup (160 threads; 206 registers),
//   the others two (126-158). Beyond the cap, ptxas serialises the wgmmas:
//   two warpgroups at head dim 128, or two blocks an SM at 16 and 32,
//   measured no faster at 128 and 3x slower at 32.
// - The producer warp loads the block's Q and dO tiles once by TMA, on one
//   barrier, then streams K and V tiles of 64 keys through a three-stage
//   ring in dynamic shared memory (full and empty mbarriers; sm90.cuh's
//   produce_kv, the forward's ring). Its lanes ballot the tile's key
//   validity (mask and key < L) into a 64-bit word beside the stage before
//   they arrive. TMA reads the tensors as [B H, L, D], so rows past L
//   arrive as zeros.
// - lse * log2(e) and delta are per query row: each thread loads its two
//   rows' once, before the key loop.
// - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with all four operands
//   K-major in shared memory, committed as one group. dS forms in S's
//   registers and, rounded to bf16, is the register A operand of dQ += dS K,
//   with K read again from the same stage as the MN-major B operand
//   (sm90.cuh's p_times_v with K in V's place).
// - Tile j's S and dP are issued together with tile j-1's dS K; tile j's
//   elementwise work runs while dS K is on the tensor cores. Without this
//   overlap head dim 32 measured 18% slower at one block an SM, and still
//   spilled at two.
// - Validity gates P through the score: a masked pair's score is -inf, so
//   its P and dS are exactly 0 (a fully masked row's filler lse is never
//   used). Only tiles with an invalid key or on the causal diagonal mask;
//   exp2 runs on the multi-function unit, the scale and the row's lse in
//   one fma.
// - Causal blocks stop after the last key tile that reaches their last row.
// - No atomics: each dQ element is summed by one thread in key order and
//   written once, scaled by 1/sqrt(D), for rows inside L. dQ is not fused
//   into dK/dV, which would need float32 atomics on dQ.
//
// The wide instance (dfly_flash_bwd_dq_wide_sm90): any head dim in (128,
// 256] with D % 8 == 0, as it is, at a compile-time width W of 192 (D up to
// 192) or 256; the tensor maps hold the real D, so columns and whole boxes
// past it arrive as zeros, and the stores stop at D. It replaces
// csrc/flash_bwd.cu's wide mma.sync dQ (flash_bwd_dq_wide_kernel) for bf16
// above WIDE_DQ_SM90_MIN_L (ops/flash.py). Bound on an H100: at the wide
// Ulysses shard, [2, 4, 4096, 192] bf16, 6 B H L^2 D = 155 GFLOP over every
// pair, 126 us at 989 TFLOP/s over the valid pairs of its random key mask
// (chip_smoke.py's bound), against 5 B H L D bf16 elements (63 MB, 19 us):
// bound by operations. The mma.sync instance takes 32 query rows against
// 32-key tiles staged synchronously, three barriers a tile: 1.86 ms there,
// 6.8% of that bound (NVIDIA H100 80GB HBM3, 700 W). Design, as the
// wide dK/dV's (flash_bwd_dkv_sm90.cu) with the roles of queries and keys
// swapped:
// - One block per (64 query rows, head, batch): two consumer warpgroups and
//   no producer warp, 256 threads with up to 255 registers each. Thread 0
//   issues the TMA loads: the block's Q and dO once, and K and V tiles of 64
//   keys through two stages. The next tile's loads go out as soon as the
//   block barrier that opens a tile shows its stage free, so they have the
//   whole of a tile's products to arrive.
// - Per key tile, warpgroup w computes S and dP for all 64 rows against its
//   32 keys 32 w .. 32 w + 31 over the whole width (wgmma m64n32k16, all
//   four operands K-major in shared memory), forms dS in registers and
//   writes it, rounded to bf16, into a shared [64 rows, 64 keys] tile. After
//   a barrier each warpgroup reads the whole tile back as register A
//   operands (16 keys a k step) and accumulates its share of dQ's column
//   blocks, dQ += dS K with K the MN-major B operand from the same stage:
//   two of four at W = 256, two and one at W = 192. 64 float32 accumulators
//   a thread; S and dP are computed once.
// - Validity (the key mask, key < L, causal) gates P, never the exponential
//   of a masked score: a fully masked row carries a filler lse, and its dQ
//   is exactly 0. lse and delta are per query row, loaded once.
// - Shared memory at W = 256: Q and dO 64 KB, two stages of K and V 128 KB,
//   the dS tile 9 KB: 202 KB of the 227 KB a block may take. At W = 192, 153
//   KB; no product is spent on a zero column block at D = 192.

#include "flash_entries.h"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

template <int HEAD_DIM>
struct Dq {
  static constexpr int D = HEAD_DIM;
  // consumer warpgroups of 64 query rows: one at head dim 128, whose dQ,
  // S, dP and dS would pass the 168 registers ptxas gives 288 threads
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int BM = 64 * NWG;  // query rows per block
  static constexpr int BN = 64;        // keys per K/V tile
  static constexpr int STAGES = 3;
  static constexpr int COLS = D < 64 ? D : 64;  // columns per swizzled block
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int CBLOCKS = D / COLS;
  static constexpr int CONSUMER_WARPS = 4 * NWG;
  static constexpr int THREADS = CONSUMER_WARPS * 32 + 32;
  static constexpr int Q_BYTES = BM * D * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  // shared memory from a 1024-byte aligned base; tiles are multiples of 1 KB
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_VALID = OFF_V + STAGES * KV_BYTES;  // a 64-bit key mask a stage
  static constexpr int OFF_BAR = OFF_VALID + STAGES * 8;
  static constexpr int BARS = 1 + 2 * STAGES;  // Q and dO, full[], empty[]
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + room to align the base
};

// dS = P (dP - delta) in place of S, P = exp2(S log2(e)/sqrt(D) - lse
// log2(e)) on valid pairs: masked scores go to -inf first, so their P and
// dS are exactly 0. lse2 (lse * log2(e)) and dlt (delta) are the thread's
// rows lo and hi.
template <typename C>
__device__ __forceinline__ void ds_tile(float (&sc)[C::BN / 2], const float (&dp)[C::BN / 2],
                                        uint64_t valid, int n0, int row_lo, int row_hi, int t,
                                        bool diag, float scale_log2, const float (&lse2)[2],
                                        const float (&dlt)[2]) {
  mask_scores<C>(sc, valid, n0, row_lo, row_hi, t, diag);
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) {
    const int r = (i >> 1) & 1;  // register 4 nt + e is row lo or hi by e >> 1
    const float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
    sc[i] = p * (dp[i] - dlt[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq, int H,
                         int L, int num_qblocks, int causal, float scale_log2, float scale) {
  using C = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sdO = smem + C::OFF_DO;
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
      mbar_init(&full[s], 32);                  // the producer's lanes
      mbar_init(&empty[s], C::CONSUMER_WARPS);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::CONSUMER_WARPS) {
    // ---- producer warp: Q and dO once, then the K/V ring
    const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CBLOCKS; ++c) {
        const int at = c * C::BM * C::ROW_BYTES;
        tma_load_3d(sQ + at, &tm_q, bar_q, c * C::COLS, q0, bh);
        tma_load_3d(sdO + at, &tm_do, bar_q, c * C::COLS, q0, bh);
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
  const uint8_t* sdOw = sdO + 64 * wg * C::ROW_BYTES;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const float lse2[2] = {row_lo < L ? lh[row_lo] * LOG2E : 0.f,
                         row_hi < L ? lh[row_hi] * LOG2E : 0.f};
  const float dlt[2] = {row_lo < L ? dh[row_lo] : 0.f, row_hi < L ? dh[row_hi] : 0.f};

  float acc[D / 2];  // dQ: register 4 dn + e is row lo/hi (e >> 1), column 8 dn + 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[C::BN / 2];          // S, then dS, of the current tile
  float dp[C::BN / 2];          // dP of the current tile
  uint32_t dsa[C::BN / 16][4];  // dS of the previous tile, the A operand of dS K

  // tile 0: its S and dP, then its dS
  mbar_wait(bar_q, 0);
  mbar_wait(&full[0], 0);
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) sc[i] = dp[i] = 0.f;
  fence_regs(sc);
  fence_regs(dp);
  wgmma_fence();
  scores<C>(sc, sQw, sK);
  scores<C>(dp, sdOw, sV);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  ds_tile<C>(sc, dp, sValid[0], 0, row_lo, row_hi, t, causal && C::BN - 1 > warp_row0,
             scale_log2, lse2, dlt);
  to_a_operand<C>(sc, dsa);

  // tile j: S_j, dP_j and dQ += dS_{j-1} K_{j-1} go to the tensor cores
  // together; dS_j forms while dS K runs
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int prev = (j - 1) % C::STAGES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(dsa);
    wgmma_fence();
    scores<C>(sc, sQw, sK + s * C::KV_BYTES);
    scores<C>(dp, sdOw, sV + s * C::KV_BYTES);
    wgmma_commit();
    p_times_v<C>(acc, dsa, sK + prev * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();  // S_j and dP_j; dS K may still run
    fence_regs(sc);
    fence_regs(dp);
    ds_tile<C>(sc, dp, sValid[s], j * C::BN, row_lo, row_hi, t,
               causal && j * C::BN + C::BN - 1 > warp_row0, scale_log2, lse2, dlt);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);  // K_{j-1}, V_{j-1} and their flags are read
    to_a_operand<C>(sc, dsa);
  }
  fence_regs(acc);
  fence_regs(dsa);
  wgmma_fence();
  p_times_v<C>(acc, dsa, sK + ((n_tiles - 1) % C::STAGES) * C::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(dsa);

  __nv_bfloat16* dqh = dq + static_cast<size_t>(bh) * L * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L) {
      store2(dqh + static_cast<size_t>(row_lo) * D + col, acc[4 * dn] * scale,
             acc[4 * dn + 1] * scale);
    }
    if (row_hi < L) {
      store2(dqh + static_cast<size_t>(row_hi) * D + col, acc[4 * dn + 2] * scale,
             acc[4 * dn + 3] * scale);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const uint8_t* mask;
  void* dq;
  int B, H, L, causal;
  float scale;  // the softmax scale, 1/sqrt(D) of the head dim the caller means
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  using C = Dq<D>;
  const long long planes = static_cast<long long>(a.B) * a.H;
  const int num_qblocks = (a.L + C::BM - 1) / C::BM;
  const long long blocks = planes * num_qblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_rows(&tq, a.q, D, a.L, planes, C::BM);
  if (err == 0) err = encode_rows(&tdo, a.dout, D, a.L, planes, C::BM);
  if (err == 0) err = encode_rows(&tk, a.k, D, a.L, planes, C::BN);
  if (err == 0) err = encode_rows(&tv, a.v, D, a.L, planes, C::BN);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = a.scale;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.mask, static_cast<__nv_bfloat16*>(a.dq), a.H, a.L,
      num_qblocks, a.causal, LOG2E * scale, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- wide instance

template <int WIDTH>
struct DqWide {
  static constexpr int D = WIDTH;  // the compile-time width: 192 or 256
  static constexpr int BM = 64;    // query rows per block
  static constexpr int BN = 64;    // keys per K/V tile
  static constexpr int KW = 32;    // keys a warpgroup scores
  static constexpr int STAGES = 2;
  static constexpr int COLS = 64;
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int CBLOCKS = D / COLS;
  // column blocks of dQ warpgroup 0 accumulates; warpgroup 1 takes the rest
  static constexpr int HALF = (CBLOCKS + 1) / 2;
  static constexpr int THREADS = 256;  // two consumer warpgroups
  static constexpr int Q_BYTES = BM * D * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int LDS = BN + 8;           // bf16 row stride of the dS tile
  // shared memory from a 1024-byte aligned base; tiles are multiples of 1 KB
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_DS = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_DS + BM * LDS * 2;
  static constexpr int BARS = 1 + STAGES;  // Q and dO, full[]
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + room to align the base
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// thread 0: K and V of key tile j into its stage
template <typename C>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             uint8_t* sK, uint8_t* sV, uint64_t* full, int j,
                                             int bh) {
  const int s = j % C::STAGES;
  mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::CBLOCKS; ++c) {
    const int at = s * C::KV_BYTES + c * C::BN * C::ROW_BYTES;
    tma_load_3d(sK + at, tm_k, &full[s], c * C::COLS, j * C::BN, bh);
    tma_load_3d(sV + at, tm_v, &full[s], c * C::COLS, j * C::BN, bh);
  }
}

// dQ += dS K over NB column blocks of dQ from block cb0 on: dS the register
// A operand (16 keys a k step), K the MN-major B operand of the stage
template <typename C, int NB>
__device__ __forceinline__ void ds_times_k(float (&acc)[C::HALF * C::COLS / 2],
                                           uint32_t (&dsa)[C::BN / 16][4], const uint8_t* kt,
                                           int cb0) {
  fence_regs(acc);
  fence_regs(dsa);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c) {
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      wgmma_rs<C::COLS>(acc + c * (C::COLS / 2), dsa[ks],
                        smem_desc<C::ROW_BYTES, true>(kt + (cb0 + c) * C::BN * C::ROW_BYTES +
                                                      ks * 16 * C::ROW_BYTES));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(dsa);
}

template <int WIDTH>
__global__ void __launch_bounds__(DqWide<WIDTH>::THREADS, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                              int H, int L, int d, int num_qblocks, int causal, float scale_log2,
                              float scale) {
  using C = DqWide<WIDTH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sdO = smem + C::OFF_DO;
  uint8_t* sK = smem + C::OFF_K;
  uint8_t* sV = smem + C::OFF_V;
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_DS);  // dS [queries][keys]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_q + 1;

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
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::CBLOCKS; ++c) {
      const int at = c * C::BM * C::ROW_BYTES;
      tma_load_3d(sQ + at, &tm_q, bar_q, c * C::COLS, q0, bh);
      tma_load_3d(sdO + at, &tm_do, bar_q, c * C::COLS, q0, bh);
    }
    for (int j = 0; j < C::STAGES && j < n_tiles; ++j) {
      load_kv_tile<C>(&tm_k, &tm_v, sK, sV, full, j, bh);
    }
  }
  __syncthreads();

  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad
  const int row0 = 16 * (warp & 3);  // the warp's first query row in the block
  const int row_lo = q0 + row0 + g;
  const int row_hi = row_lo + 8;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const float lse2[2] = {row_lo < L ? lh[row_lo] * LOG2E : 0.f,
                         row_hi < L ? lh[row_hi] * LOG2E : 0.f};
  const float dlt[2] = {row_lo < L ? dh[row_lo] : 0.f, row_hi < L ? dh[row_hi] : 0.f};
  // warpgroup 0 accumulates column blocks 0 .. HALF - 1, warpgroup 1 the rest
  const bool even = 2 * C::HALF == C::CBLOCKS;

  // register 32 c + 4 dn + e: row lo/hi (e >> 1), column 64 (HALF wg + c)
  // + 8 dn + 2 t + (e & 1)
  float acc[C::HALF * C::COLS / 2];
#pragma unroll
  for (int i = 0; i < C::HALF * C::COLS / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int n0 = j * C::BN;
    if (j >= 1) {
      __syncthreads();  // both warpgroups are done with tile j-1: its stage and the dS tile
      if (threadIdx.x == 0 && j + 1 < n_tiles) {
        load_kv_tile<C>(&tm_k, &tm_v, sK, sV, full, j + 1, bh);  // into tile j-1's stage
      }
    }
    const uint8_t* kt = sK + s * C::KV_BYTES;
    const uint8_t* vt = sV + s * C::KV_BYTES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // S = Q K^T and dP = dO V^T: the 64 rows x the warpgroup's 32 keys
    float sc[C::KW / 2];
    float dp[C::KW / 2];
#pragma unroll
    for (int i = 0; i < C::KW / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::D / 16; ++kk) {
      const int blk = kk * 16 / C::COLS;
      const int at = (kk * 16 % C::COLS) * 2;
      const int q_at = blk * C::BM * C::ROW_BYTES + at;
      const int kv_at = blk * C::BN * C::ROW_BYTES + C::KW * wg * C::ROW_BYTES + at;
      wgmma_ss_n32(sc, smem_desc<C::ROW_BYTES, false>(sQ + q_at),
                   smem_desc<C::ROW_BYTES, false>(kt + kv_at));
      wgmma_ss_n32(dp, smem_desc<C::ROW_BYTES, false>(sdO + q_at),
                   smem_desc<C::ROW_BYTES, false>(vt + kv_at));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta), P = exp2(S log2(e)/sqrt(D) - lse log2(e)) on
    // valid pairs and exactly 0 elsewhere; rows are queries, columns the
    // warpgroup's keys
#pragma unroll
    for (int nt = 0; nt < C::KW / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // the thread's two keys of the 8-key tile
        const int key = n0 + C::KW * wg + nt * 8 + 2 * t + c;
        const bool valid = key < L && (mb == nullptr || mb[key] != 0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows lo, hi
          const bool ok = valid && (!causal || key <= (r ? row_hi : row_lo));
          const int i = 4 * nt + 2 * r + c;
          const float p = ok ? ex2(fmaf(sc[i], scale_log2, -lse2[r])) : 0.f;
          sc[i] = p * (dp[i] - dlt[r]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < C::KW / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (row0 + g + 8 * r) * C::LDS + C::KW * wg + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sdS + at) = pack_bf16(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]);
      }
    }
    __syncthreads();  // the whole tile's dS is written

    // dQ += dS K over the warpgroup's column blocks, the keys as the k dimension
    uint32_t dsa[C::BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      const int at = (row0 + g) * C::LDS + ks * 16 + 2 * t;
      dsa[ks][0] = *reinterpret_cast<const uint32_t*>(sdS + at);
      dsa[ks][1] = *reinterpret_cast<const uint32_t*>(sdS + at + 8 * C::LDS);
      dsa[ks][2] = *reinterpret_cast<const uint32_t*>(sdS + at + 8);
      dsa[ks][3] = *reinterpret_cast<const uint32_t*>(sdS + at + 8 * C::LDS + 8);
    }
    if (even || wg == 0) {
      ds_times_k<C, C::HALF>(acc, dsa, kt, C::HALF * wg);
    } else {
      ds_times_k<C, C::CBLOCKS - C::HALF>(acc, dsa, kt, C::HALF);
    }
  }

  // rows inside L, columns below d (d % 8 == 0: an 8-column tile is all
  // below d or all past it), scaled by 1/sqrt(D)
  __nv_bfloat16* dqh = dq + static_cast<size_t>(bh) * L * d;
  const int blocks = (even || wg == 0) ? C::HALF : C::CBLOCKS - C::HALF;
#pragma unroll
  for (int c = 0; c < C::HALF; ++c) {
    if (c >= blocks) break;
#pragma unroll
    for (int dn = 0; dn < C::COLS / 8; ++dn) {
      const int tile = (C::HALF * wg + c) * C::COLS + dn * 8;
      if (tile >= d) continue;
      const int col = tile + 2 * t;
      const int i = c * (C::COLS / 2) + 4 * dn;
      if (row_lo < L) {
        store2(dqh + static_cast<size_t>(row_lo) * d + col, acc[i] * scale, acc[i + 1] * scale);
      }
      if (row_hi < L) {
        store2(dqh + static_cast<size_t>(row_hi) * d + col, acc[i + 2] * scale,
               acc[i + 3] * scale);
      }
    }
  }
}

template <int WIDTH>
int launch_wide(const Args& a, int d, cudaStream_t stream) {
  using C = DqWide<WIDTH>;
  const long long planes = static_cast<long long>(a.B) * a.H;
  const int num_qblocks = (a.L + C::BM - 1) / C::BM;
  const long long blocks = planes * num_qblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_rows(&tq, a.q, d, a.L, planes, C::BM);
  if (err == 0) err = encode_rows(&tdo, a.dout, d, a.L, planes, C::BM);
  if (err == 0) err = encode_rows(&tk, a.k, d, a.L, planes, C::BN);
  if (err == 0) err = encode_rows(&tv, a.v, d, a.L, planes, C::BN);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_wide_sm90_kernel<WIDTH>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = a.scale;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.mask, static_cast<__nv_bfloat16*>(a.dq), a.H, a.L, d,
      num_qblocks, a.causal, LOG2E * scale, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entries, declared with their layouts in flash_entries.h.
extern "C" int dfly_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* mask, void* dq, int B, int H, int L, int D,
                                      int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dq, B, H, L, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dfly_flash_bwd_dq_wide_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* mask, void* dq, int B, int H, int L, int D,
                                           int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 128 || D > 256 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dq, B, H, L, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 192 ? launch_wide<192>(a, D, s) : launch_wide<256>(a, D, s);
}

extern "C" const char* dfly_cuda_error_string(int err) { return sm90::error_string(err); }
