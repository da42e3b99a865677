// Flash-attention dK/dV backward for Hopper (sm_90a) at long sequences:
// TMA loads into a ring of shared-memory stages, wgmma products, a producer
// warp and one or two consumer warpgroups.
//
// Replaces, at long L, the TPU kernel
// dragonfly2_tpu/ops/flash.py::_flash_bwd_dkv_kernel (:418, launched by the
// pallas_call at :615), as csrc/flash_bwd.cu's dfly_flash_bwd_dkv does at
// every L; ops/flash.py picks this source for bf16 inputs above SM90_MIN_L
// (_sm90_path), as it picks flash_bwd_dq_sm90.cu for dQ. Given q, k, v, dO
// [B, H, L, D] bf16, the forward's lse and delta = rowsum(dO * o) [B, H, L]
// float32, a [B, L] key-validity mask (or none) and the causal flag, per
// (key, query) pair:
//   P  = exp2(S log2(e)/sqrt(D) - lse log2(e)) on valid pairs, 0 elsewhere
//   dV = P^T dO;  dS = P (dO V^T - delta);  dK = dS^T Q / sqrt(D)
// with P and dS rounded to bf16 before their products. Head dims 16, 32,
// 64, 128; dK and dV in bf16.
//
// What bounds it on an H100: 8 B H L^2 D operations (S^T, dP^T, dV, dK)
// against 6 B H L D bf16 elements and 2 B H L float32 rows moved. At
// [4, 8, 2048, 128] that is 137 GFLOP, 139 us at the 989 TFLOP/s bf16 peak
// (117 us over the valid pairs of an 85% mask), against 101 MB, 30 us:
// bound by operations. Each pair also costs an exp2 and a few float32
// operations.
//
// Design:
// - One block per (64 * NWG keys, head, batch): NWG consumer warpgroups of
//   64 keys (two; one at head dim 128, where dK and dV alone take 128
//   float32 registers a thread) and one producer warp. Each warpgroup keeps
//   its keys' dK and dV in float32 registers through the loop over query
//   tiles, the loop that replaces the TPU's innermost "arbitrary" grid
//   dimension; each output element is summed by one thread in a fixed
//   order, with no atomics, and written once. With one producer warp the
//   block's 160 or 288 threads get up to 255 or 224 registers at one block
//   an SM, so setmaxnreg is not needed.
// - The producer warp loads the block's K and V once by TMA, then streams
//   Q and dO tiles of 64 queries through a three-stage ring in dynamic shared
//   memory (full and empty mbarriers); its lanes put the tile's lse * log2(e)
//   and delta rows beside them (plain loads: a [B H, L] float32 row is not
//   16-byte aligned for every L). Rows past L arrive as zeros.
// - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with the keys as M and
//   both operands K-major in shared memory, so P^T and dS^T land in
//   accumulator registers; rounded to bf16 they are the register A operands
//   of dV += P^T dO and dK += dS^T Q, with dO and Q read again from the same
//   tiles as MN-major B operands.
// - Validity (key mask, causal, rows past L) gates P, never the exponential
//   of a masked score: a fully masked row carries a filler lse. Only tiles
//   with queries past L or on the causal diagonal test more than the key's
//   validity; lse and delta are read as pairs, exp2 runs on the
//   multi-function unit.
// - Causal blocks start at the first query tile that reaches their keys.
//
// The wide instance (dfly_flash_bwd_dkv_wide_sm90): any head dim in (128,
// 256] with D % 8 == 0, as it is, at a compile-time width of 256 (the
// tensor maps hold the real D: columns and whole boxes past it arrive as
// zeros, and the stores stop at D). It replaces csrc/flash_bwd.cu's wide
// mma.sync dK/dV for bf16 above WIDE_DKV_SM90_MIN_L (ops/flash.py). dK and dV
// for 64 keys at D = 256 are 256 float32 registers a thread in one
// warpgroup, past the cap of 255, so the block splits the work:
// - One block per (64 keys, head, batch): two consumer warpgroups and no
//   producer warp, 256 threads with up to 255 registers each (ptxas gives
//   a 288-thread block 168). Thread 0 issues the TMA loads: the block's K
//   and V once, and Q and dO tiles of 64 queries through two stages; the
//   next tile's loads go out as soon as a block barrier shows the stage
//   free, one tile ahead of the products.
// - Per query tile, warpgroup w computes S^T and dP^T for all 64 keys
//   against its 32 queries 32 w .. 32 w + 31 over the whole width (wgmma
//   m64n32k16, both operands K-major in shared memory), forms P^T and dS^T
//   in registers and writes them, rounded to bf16, into shared [64 keys,
//   64 queries] tiles. After a barrier each warpgroup reads the whole
//   tiles back as register A operands (16 queries a k step) and
//   accumulates its half of the columns, 128 of 256: dV += P^T dO and
//   dK += dS^T Q, dO and Q the MN-major B operands from the same stage.
//   128 float32 accumulators a thread; no product is computed twice.
// - Shared memory: K and V 64 KB, two stages of Q and dO 128 KB, P^T and
//   dS^T 18 KB. lse and delta are read from global memory by the threads
//   that use them (a [B H, L] float32 row is not 16-byte aligned for
//   every L).
// Bound on an H100: at [2, 4, 4096, 192] bf16 (a Ulysses shard) 8 B H L^2
// D = 206 GFLOP, 208 us at 989 TFLOP/s, against 6 B H L D bf16 elements
// (75 MB, 22 us): bound by operations. At D = 192 the fourth column block
// is zeros: a quarter of the products is spent on them.

#include "flash_entries.h"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Dkv {
  static constexpr int NWG = D == 128 ? 1 : 2;  // consumer warpgroups, 64 keys each
  static constexpr int BK = 64 * NWG;          // keys per block
  static constexpr int BQ = 64;                // queries per streamed tile
  static_assert(BQ == 64, "S^T and dP^T of a warpgroup are one m64n64 wgmma tile");
  static constexpr int STAGES = 3;
  static constexpr int COLS = D < 64 ? D : 64;  // columns per swizzled block
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int CBLOCKS = D / COLS;
  static constexpr int CONSUMER_WARPS = 4 * NWG;
  static constexpr int THREADS = CONSUMER_WARPS * 32 + 32;
  static constexpr int KV_BYTES = BK * D * 2;  // the block's K or V
  static constexpr int QT_BYTES = BQ * D * 2;  // one Q or dO tile
  // shared memory from a 1024-byte aligned base; tiles are multiples of 1 KB
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_ROWS = OFF_DO + STAGES * QT_BYTES;  // STAGES x (lse, delta) x BQ f32
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BARS = 1 + 2 * STAGES;  // K/V, full[], empty[]
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + room to align the base
};

// P^T = exp2(S^T log2(e)/sqrt(D) - lse log2(e)) on valid pairs, 0 elsewhere,
// and dS^T = P^T (dP^T - delta), in place. Rows are the thread's keys lo
// and hi (ok_lo, ok_hi: valid), columns queries q0 + 8 nt + 2 t + (e & 1);
// EDGE: the tile has queries past L or reaches the causal diagonal.
template <typename C, bool EDGE>
__device__ __forceinline__ void elementwise(float (&st)[C::BQ / 2], float (&dpt)[C::BQ / 2],
                                            const float* lse2, const float* dlt, int q0,
                                            int key_lo, bool ok_lo, bool ok_hi, int t, int L,
                                            float scale_log2, int causal = 0) {
#pragma unroll
  for (int nt = 0; nt < C::BQ / 8; ++nt) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + nt * 8 + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(dlt + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool ok = (e < 2) ? ok_lo : ok_hi;
      if (EDGE) {
        const int query = q0 + nt * 8 + 2 * t + (e & 1);
        const int key = key_lo + ((e < 2) ? 0 : 8);
        ok = ok && query < L && (!causal || key <= query);
      }
      const int i = 4 * nt + e;
      const float p = ok ? ex2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x))) : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int L, int num_kblocks,
                          int causal, float scale_log2, float scale) {
  using C = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + C::OFF_V;
  uint8_t* sQ = smem + C::OFF_Q;
  uint8_t* sdO = smem + C::OFF_DO;
  float* sRows = reinterpret_cast<float*>(smem + C::OFF_ROWS);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + C::STAGES;

  const int kb = blockIdx.x % num_kblocks;
  const int bh = blockIdx.x / num_kblocks;
  const int b = bh / H;
  const int k0 = kb * C::BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / C::BQ) * C::BQ : 0;
  const int n_tiles = (L - q_begin + C::BQ - 1) / C::BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);                  // the producer's lanes
      mbar_init(&empty[s], C::CONSUMER_WARPS);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::CONSUMER_WARPS) {
    // ---- producer warp: the block's K and V once, then the Q/dO ring
    const float* lh = lse + static_cast<size_t>(bh) * L;
    const float* dh = delta + static_cast<size_t>(bh) * L;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < C::CBLOCKS; ++c) {
        const int at = c * C::BK * C::ROW_BYTES;
        tma_load_3d(sK + at, &tm_k, bar_kv, c * C::COLS, k0, bh);
        tma_load_3d(sV + at, &tm_v, bar_kv, c * C::COLS, k0, bh);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % C::STAGES;
      const int q0 = q_begin + j * C::BQ;
      mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
      float* rows = sRows + s * 2 * C::BQ;
      for (int i = lane; i < C::BQ; i += 32) {
        const int row = q0 + i;
        rows[i] = row < L ? lh[row] * LOG2E : 0.f;
        rows[C::BQ + i] = row < L ? dh[row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * C::QT_BYTES);
#pragma unroll
        for (int c = 0; c < C::CBLOCKS; ++c) {
          const int at = s * C::QT_BYTES + c * C::BQ * C::ROW_BYTES;
          tma_load_3d(sQ + at, &tm_q, &full[s], c * C::COLS, q0, bh);
          tma_load_3d(sdO + at, &tm_do, &full[s], c * C::COLS, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns keys k0 + 64 wg ..
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad
  const int warp_key0 = k0 + 64 * wg + 16 * (warp & 3);  // the warp's first key
  const int key_lo = warp_key0 + g;
  const int key_hi = key_lo + 8;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;
  const bool ok_lo = key_lo < L && (mb == nullptr || mb[key_lo] != 0);
  const bool ok_hi = key_hi < L && (mb == nullptr || mb[key_hi] != 0);
  const uint8_t* sKw = sK + 64 * wg * C::ROW_BYTES;
  const uint8_t* sVw = sV + 64 * wg * C::ROW_BYTES;

  // register 4 dn + e: key lo/hi (e >> 1), column 8 dn + 2 t + (e & 1)
  float acc_dk[D / 2];
  float acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int q0 = q_begin + j * C::BQ;
    const uint8_t* qt = sQ + s * C::QT_BYTES;
    const uint8_t* dot = sdO + s * C::QT_BYTES;
    const float* lse2 = sRows + s * 2 * C::BQ;
    const float* dlt = lse2 + C::BQ;
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries per warpgroup
    float st[C::BQ / 2];
    float dpt[C::BQ / 2];
#pragma unroll
    for (int i = 0; i < C::BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / C::COLS;       // column block
      const int at = (kk * 16 % C::COLS) * 2;  // bytes into its swizzled rows
      const int kv_at = blk * C::BK * C::ROW_BYTES + at;
      const int q_at = blk * C::BQ * C::ROW_BYTES + at;
      wgmma_ss_n64(st, smem_desc<C::ROW_BYTES, false>(sKw + kv_at),
                   smem_desc<C::ROW_BYTES, false>(qt + q_at));
      wgmma_ss_n64(dpt, smem_desc<C::ROW_BYTES, false>(sVw + kv_at),
                   smem_desc<C::ROW_BYTES, false>(dot + q_at));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in place; rows are keys, columns queries. A tile with
    // every query inside L and off the causal diagonal needs only the
    // keys' validity.
    if (q0 + C::BQ <= L && !(causal && warp_key0 + 15 > q0)) {
      elementwise<C, false>(st, dpt, lse2, dlt, q0, key_lo, ok_lo, ok_hi, t, L, scale_log2);
    } else {
      elementwise<C, true>(st, dpt, lse2, dlt, q0, key_lo, ok_lo, ok_hi, t, L, scale_log2,
                           causal);
    }

    // dV += P^T dO and dK += dS^T Q, the queries as the k dimension
    uint32_t pa[C::BQ / 16][4];
    uint32_t dsa[C::BQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < C::BQ / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[ks][r] = pack_bf16(st[8 * ks + 2 * r], st[8 * ks + 2 * r + 1]);
        dsa[ks][r] = pack_bf16(dpt[8 * ks + 2 * r], dpt[8 * ks + 2 * r + 1]);
      }
    }
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::CBLOCKS; ++c) {
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks) {
        const int at = c * C::BQ * C::ROW_BYTES + ks * 16 * C::ROW_BYTES;
        wgmma_rs<C::COLS>(acc_dv + c * (C::COLS / 2), pa[ks],
                          smem_desc<C::ROW_BYTES, true>(dot + at));
        wgmma_rs<C::COLS>(acc_dk + c * (C::COLS / 2), dsa[ks],
                          smem_desc<C::ROW_BYTES, true>(qt + at));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dkh = dk + static_cast<size_t>(bh) * L * D;
  __nv_bfloat16* dvh = dv + static_cast<size_t>(bh) * L * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (key_lo < L) {
      const size_t at = static_cast<size_t>(key_lo) * D + col;
      store2(dkh + at, acc_dk[4 * dn] * scale, acc_dk[4 * dn + 1] * scale);
      store2(dvh + at, acc_dv[4 * dn], acc_dv[4 * dn + 1]);
    }
    if (key_hi < L) {
      const size_t at = static_cast<size_t>(key_hi) * D + col;
      store2(dkh + at, acc_dk[4 * dn + 2] * scale, acc_dk[4 * dn + 3] * scale);
      store2(dvh + at, acc_dv[4 * dn + 2], acc_dv[4 * dn + 3]);
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
  void* dk;
  void* dv;
  int B, H, L, causal;
  float scale;  // the softmax scale, 1/sqrt(D) of the head dim the caller means
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  using C = Dkv<D>;
  const long long planes = static_cast<long long>(a.B) * a.H;
  const int num_kblocks = (a.L + C::BK - 1) / C::BK;
  const long long blocks = planes * num_kblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_rows(&tq, a.q, D, a.L, planes, C::BQ);
  if (err == 0) err = encode_rows(&tdo, a.dout, D, a.L, planes, C::BQ);
  if (err == 0) err = encode_rows(&tk, a.k, D, a.L, planes, C::BK);
  if (err == 0) err = encode_rows(&tv, a.v, D, a.L, planes, C::BK);
  if (err != 0) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = a.scale;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.mask, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.H, a.L, num_kblocks, a.causal, LOG2E * scale, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------- wide instance

struct DkvWide {
  static constexpr int D = 256;  // the compile-time width
  static constexpr int BK = 64;  // keys per block
  static constexpr int BQ = 64;  // queries per streamed tile
  static constexpr int QW = 32;  // queries a warpgroup scores
  static constexpr int STAGES = 2;
  static constexpr int COLS = 64;
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int CBLOCKS = D / COLS;
  static constexpr int HALF = CBLOCKS / 2;  // column blocks a warpgroup accumulates
  static constexpr int THREADS = 256;       // two consumer warpgroups
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int LDP = BQ + 8;  // bf16 row stride of the P^T and dS^T tiles
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_P = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_DS = OFF_P + BK * LDP * 2;
  static constexpr int OFF_BAR = OFF_DS + BK * LDP * 2;
  static constexpr int BARS = 1 + STAGES;  // K/V, full[]
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + room to align the base
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// thread 0: Q and dO of query tile j into its stage
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            uint8_t* sQ, uint8_t* sdO, uint64_t* full, int j,
                                            int q_begin, int bh) {
  using C = DkvWide;
  const int s = j % C::STAGES;
  const int q0 = q_begin + j * C::BQ;
  mbar_arrive_expect_tx(&full[s], 2 * C::QT_BYTES);
#pragma unroll
  for (int c = 0; c < C::CBLOCKS; ++c) {
    const int at = s * C::QT_BYTES + c * C::BQ * C::ROW_BYTES;
    tma_load_3d(sQ + at, tm_q, &full[s], c * C::COLS, q0, bh);
    tma_load_3d(sdO + at, tm_do, &full[s], c * C::COLS, q0, bh);
  }
}

__global__ void __launch_bounds__(DkvWide::THREADS, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int L, int d,
                               int num_kblocks, int causal, float scale_log2, float scale) {
  using C = DkvWide;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + C::OFF_V;
  uint8_t* sQ = smem + C::OFF_Q;
  uint8_t* sdO = smem + C::OFF_DO;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_P);    // P^T [keys][queries]
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_DS);  // dS^T
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;

  const int kb = blockIdx.x % num_kblocks;
  const int bh = blockIdx.x / num_kblocks;
  const int b = bh / H;
  const int k0 = kb * C::BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (L - q_begin + C::BQ - 1) / C::BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::CBLOCKS; ++c) {
      const int at = c * C::BK * C::ROW_BYTES;
      tma_load_3d(sK + at, &tm_k, bar_kv, c * C::COLS, k0, bh);
      tma_load_3d(sV + at, &tm_v, bar_kv, c * C::COLS, k0, bh);
    }
    for (int j = 0; j < C::STAGES && j < n_tiles; ++j) {
      load_q_tile(&tm_q, &tm_do, sQ, sdO, full, j, q_begin, bh);
    }
  }
  __syncthreads();

  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad
  const int row0 = 16 * (warp & 3);  // the warp's first key row in the block
  const int key_lo = k0 + row0 + g;
  const int key_hi = key_lo + 8;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;
  const bool ok_lo = key_lo < L && (mb == nullptr || mb[key_lo] != 0);
  const bool ok_hi = key_hi < L && (mb == nullptr || mb[key_hi] != 0);
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;

  // register 32 c + 4 dn + e: key lo/hi (e >> 1), column 64 (HALF wg + c)
  // + 8 dn + 2 t + (e & 1)
  float acc_dk[C::HALF * C::COLS / 2];
  float acc_dv[C::HALF * C::COLS / 2];
#pragma unroll
  for (int i = 0; i < C::HALF * C::COLS / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int q0 = q_begin + j * C::BQ;
    const uint8_t* qt = sQ + s * C::QT_BYTES;
    const uint8_t* dot = sdO + s * C::QT_BYTES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x the warpgroup's 32 queries
    float st[C::QW / 2];
    float dpt[C::QW / 2];
#pragma unroll
    for (int i = 0; i < C::QW / 2; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::D / 16; ++kk) {
      const int blk = kk * 16 / C::COLS;
      const int at = (kk * 16 % C::COLS) * 2;
      const int kv_at = blk * C::BK * C::ROW_BYTES + at;
      const int q_at = blk * C::BQ * C::ROW_BYTES + C::QW * wg * C::ROW_BYTES + at;
      wgmma_ss_n32(st, smem_desc<C::ROW_BYTES, false>(sK + kv_at),
                   smem_desc<C::ROW_BYTES, false>(qt + q_at));
      wgmma_ss_n32(dpt, smem_desc<C::ROW_BYTES, false>(sV + kv_at),
                   smem_desc<C::ROW_BYTES, false>(dot + q_at));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T; rows are keys, columns the warpgroup's queries
    const bool edge = q0 + C::BQ > L || (causal && k0 + C::BK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < C::QW / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // the thread's two queries of the 8-query tile
        const int query = q0 + C::QW * wg + nt * 8 + 2 * t + c;
        const bool in = query < L;
        const float lse2 = in ? lh[query] * LOG2E : 0.f;
        const float dlt = in ? dh[query] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // keys lo, hi
          bool ok = r ? ok_hi : ok_lo;
          if (edge) ok = ok && in && (!causal || (r ? key_hi : key_lo) <= query);
          const int i = 4 * nt + 2 * r + c;
          const float p = ok ? ex2(fmaf(st[i], scale_log2, -lse2)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dlt);
        }
      }
    }

    __syncthreads();  // both warpgroups are done reading the previous tile's P^T, dS^T and stage
    if (threadIdx.x == 0 && j >= 1 && j + 1 < n_tiles) {
      load_q_tile(&tm_q, &tm_do, sQ, sdO, full, j + 1, q_begin, bh);  // into tile j-1's stage
    }
#pragma unroll
    for (int nt = 0; nt < C::QW / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (row0 + g + 8 * r) * C::LDP + C::QW * wg + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sP + at) = pack_bf16(st[4 * nt + 2 * r], st[4 * nt + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(sdS + at) =
            pack_bf16(dpt[4 * nt + 2 * r], dpt[4 * nt + 2 * r + 1]);
      }
    }
    __syncthreads();  // the whole tile's P^T and dS^T are written

    // dV += P^T dO and dK += dS^T Q over the warpgroup's columns, the
    // queries as the k dimension
    uint32_t pa[C::BQ / 16][4];
    uint32_t dsa[C::BQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < C::BQ / 16; ++ks) {
      const int at = (row0 + g) * C::LDP + ks * 16 + 2 * t;
      pa[ks][0] = *reinterpret_cast<const uint32_t*>(sP + at);
      pa[ks][1] = *reinterpret_cast<const uint32_t*>(sP + at + 8 * C::LDP);
      pa[ks][2] = *reinterpret_cast<const uint32_t*>(sP + at + 8);
      pa[ks][3] = *reinterpret_cast<const uint32_t*>(sP + at + 8 * C::LDP + 8);
      dsa[ks][0] = *reinterpret_cast<const uint32_t*>(sdS + at);
      dsa[ks][1] = *reinterpret_cast<const uint32_t*>(sdS + at + 8 * C::LDP);
      dsa[ks][2] = *reinterpret_cast<const uint32_t*>(sdS + at + 8);
      dsa[ks][3] = *reinterpret_cast<const uint32_t*>(sdS + at + 8 * C::LDP + 8);
    }
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::HALF; ++c) {
      const int cb = C::HALF * wg + c;  // the column block
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks) {
        const int at = cb * C::BQ * C::ROW_BYTES + ks * 16 * C::ROW_BYTES;
        wgmma_rs<C::COLS>(acc_dv + c * (C::COLS / 2), pa[ks],
                          smem_desc<C::ROW_BYTES, true>(dot + at));
        wgmma_rs<C::COLS>(acc_dk + c * (C::COLS / 2), dsa[ks],
                          smem_desc<C::ROW_BYTES, true>(qt + at));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(pa);
    fence_regs(dsa);
  }

  __nv_bfloat16* dkh = dk + static_cast<size_t>(bh) * L * d;
  __nv_bfloat16* dvh = dv + static_cast<size_t>(bh) * L * d;
#pragma unroll
  for (int c = 0; c < C::HALF; ++c) {
#pragma unroll
    for (int dn = 0; dn < C::COLS / 8; ++dn) {
      const int tile = (C::HALF * wg + c) * C::COLS + dn * 8;
      if (tile >= d) continue;  // d % 8 == 0: a tile is all below d or all past it
      const int col = tile + 2 * t;
      const int i = c * (C::COLS / 2) + 4 * dn;
      if (key_lo < L) {
        const size_t at = static_cast<size_t>(key_lo) * d + col;
        store2(dkh + at, acc_dk[i] * scale, acc_dk[i + 1] * scale);
        store2(dvh + at, acc_dv[i], acc_dv[i + 1]);
      }
      if (key_hi < L) {
        const size_t at = static_cast<size_t>(key_hi) * d + col;
        store2(dkh + at, acc_dk[i + 2] * scale, acc_dk[i + 3] * scale);
        store2(dvh + at, acc_dv[i + 2], acc_dv[i + 3]);
      }
    }
  }
}

int launch_wide(const Args& a, int d, cudaStream_t stream) {
  using C = DkvWide;
  const long long planes = static_cast<long long>(a.B) * a.H;
  const int num_kblocks = (a.L + C::BK - 1) / C::BK;
  const long long blocks = planes * num_kblocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_rows(&tq, a.q, d, a.L, planes, C::BQ);
  if (err == 0) err = encode_rows(&tdo, a.dout, d, a.L, planes, C::BQ);
  if (err == 0) err = encode_rows(&tk, a.k, d, a.L, planes, C::BK);
  if (err == 0) err = encode_rows(&tv, a.v, d, a.L, planes, C::BK);
  if (err != 0) return err;
  auto kernel = flash_bwd_dkv_wide_sm90_kernel;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = a.scale;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.mask, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.H, a.L, d, num_kblocks, a.causal, LOG2E * scale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entries, declared with their layouts in flash_entries.h.
extern "C" int dfly_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* mask, void* dk, void* dv, int B, int H, int L,
                                       int D, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dk, dv, B, H, L, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dfly_flash_bwd_dkv_wide_sm90(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* mask, void* dk, void* dv, int B, int H,
                                            int L, int D, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 128 || D > 256 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dk, dv, B, H, L, causal, scale};
  return launch_wide(a, D, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dfly_cuda_error_string(int err) { return sm90::error_string(err); }
