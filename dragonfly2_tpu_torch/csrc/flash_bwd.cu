// Flash-attention backward for Hopper (sm_90a): the dK/dV and dQ kernels
// of short sets and float32.
//
// Replaces the TPU kernels dragonfly2_tpu/ops/flash.py::_flash_bwd_dkv_kernel
// (:418, launched by the pallas_call at :615) and ::_flash_bwd_dq_kernel
// (:474, pallas_call at :667), the backward of the reference's custom_vjp.
// ops/flash.py launches these instances for float32 and for L up to
// SM90_MIN_L (the ranker's sets); bf16 above it takes the TMA + wgmma
// redesigns, csrc/flash_bwd_dkv_sm90.cu and csrc/flash_bwd_dq_sm90.cu.
// Both C sides send L up to SETS_MAX_L = 32 (the ranker's trained sets)
// to the packed-sets kernels (end of file), whose blocks hold the rows of
// whole consecutive sets of the flattened [B H L, D] matrices in one memory
// round trip: flash_bwd_dkv_sets_kernel (a block's keys sweep the same
// sets' queries) and flash_bwd_dq_sets_kernel (its queries sweep the same
// sets' keys), which replaces flash_bwd_dq_kernel there. The tile loops
// below, flash_bwd_dkv_kernel and flash_bwd_dq_kernel, take L in
// (SETS_MAX_L, SM90_MIN_L] in bf16 and every longer L in float32.
// Given q, k, v, dO [B, H, L, D], the forward's lse and delta = rowsum(dO*o)
// [B, H, L] float32, and a [B, L] key-validity mask (or none), per tile:
//   P  = exp2(S log2(e)/sqrt(D) - lse log2(e)) on valid pairs, 0 elsewhere
//   dV = P^T dO;  dS = P (dO V^T - delta);  dK = dS^T Q / sqrt(D);  dQ = dS K / sqrt(D)
// Head dims 16, 32, 64, 128, and in the wide instances (end of file) any D
// with D % 8 == 0, taken above 128 (dQ and dK/dV in one pass for D in (128,
// 512]); bf16 or float32 in, gradients in the input dtype.
//
// What bounds it on an H100: at the trained shape, [256, 4, 20, 32] bf16,
// dK/dV reads q, dO, k, v, lse and delta and writes dK, dV: 8.0 MB, ~2.4 us
// at 3.35 TB/s, against at most 0.1 GFLOP (8 D operations per valid pair
// per head: S, dP, dV, dK), ~0.1 us at the 989 TFLOP/s bf16 peak. dQ reads
// q, dO, k, v, lse and delta and writes dQ: 6.7 MB, ~2.0 us at 3.35 TB/s,
// against ~0.08 GFLOP (6 D operations per pair: S, dP, dQ). Both are bound
// by bytes (and, at 20 keys a set, by launch and latency); at long L the
// products dominate.
//
// Design of the tile loops (not the TPU's grid; its _pick_blocks_bwd
// tiling does not carry over):
// - dK/dV: one block per (16*WARPS keys, head, batch). Each warp owns 16
//   keys and keeps their dK and dV in float32 registers through a loop over
//   query tiles, the loop that replaces the TPU's innermost "arbitrary" grid
//   dimension; each is written once. The block's K and V rows, and per
//   query tile Q, dO, lse and delta, are staged in shared memory as bf16 (a
//   float32 input is rounded there, as the forward does). S^T = K Q^T and
//   dP^T = V dO^T take the keys as the M dimension, so P^T and dS^T come out
//   in accumulator layout and feed dV += P^T dO and dK += dS^T Q as A
//   fragments without leaving registers.
// - dQ: one block per (16*WARPS query rows, head, batch); each warp keeps 16
//   rows of dQ in float32 registers through a loop over key tiles.
// - Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//   float32 accumulate), as in the forward. WARPS (1, 2 or 4) comes from L,
//   so a 20-key set does not launch idle warps. The swept tile is 32 rows
//   (16 at D = 128, which keeps the static shared memory under 48 KB).
// - Validity (key mask, causal, rows past L) gates P explicitly, never the
//   exponential of a masked score: a fully masked row carries a filler lse.
// - Causal: the dK/dV loop starts at the first query tile that reaches the
//   block's keys; the dQ loop stops after the block's last query row.
// - Deterministic: every output element is summed by one thread in a fixed
//   order, with no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_entries.h"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void load8(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

// lower 16 bits hold the element with the smaller k index
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void load8(const float* src, __nv_bfloat16* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack(a.x, a.y), pack(a.z, a.w), pack(b.x, b.y), pack(b.z, b.w));
}

__device__ __forceinline__ void zero8(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = pack(x, y);
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// two consecutive bf16 in shared memory as one 32-bit fragment register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + ROWS) of a contiguous [L, D] matrix into shared memory as
// bf16 with row stride D + 8 (conflict-free fragment loads); rows past L are 0
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0, int L,
                                           __nv_bfloat16* dst, int tid) {
  constexpr int LDS = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per bf16 row
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = r0 + r;
    if (row < L) {
      load8(src + static_cast<size_t>(row) * D + c, dst + r * LDS + c);
    } else {
      zero8(dst + r * LDS + c);
    }
  }
}

// A fragment (16x16, row-major) of rows row0.. and columns kk*16.. of a
// shared matrix
template <int LDS>
__device__ __forceinline__ void frag_a(const __nv_bfloat16* s, int row0, int kk, int g, int t,
                                       uint32_t a[4]) {
  const __nv_bfloat16* base = s + (row0 + g) * LDS + kk * 16 + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LDS);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LDS + 8);
}

// B fragment (16x8) with B[k][n] = M[n0 + n][kk*16 + k]: the product runs
// along M's rows (as Q K^T runs along K's)
template <int LDS>
__device__ __forceinline__ void frag_b_rows(const __nv_bfloat16* m, int n0, int kk, int g, int t,
                                            uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* base = m + (n0 + g) * LDS + kk * 16 + 2 * t;
  b0 = ld32(base);
  b1 = ld32(base + 8);
}

// B fragment (16x8) with B[k][n] = M[k0 + k][n0 + n]: the product runs down
// M's columns (as P V runs down V's)
template <int LDS>
__device__ __forceinline__ void frag_b_cols(const __nv_bfloat16* m, int k0, int n0, int g, int t,
                                            uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* base = m + (k0 + 2 * t) * LDS + n0 + g;
  b0 = pack(base[0], base[LDS]);
  b1 = pack(base[8 * LDS], base[9 * LDS]);
}

// the accumulators of two adjacent 16x8 tiles as the A fragment of one
// 16-wide k step
__device__ __forceinline__ void c_to_a(const float lo[4], const float hi[4], uint32_t a[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

template <typename T, int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int L, int num_kblocks,
                     int causal, float scale_log2, float scale) {
  constexpr int BN = 16 * WARPS;          // keys per block
  constexpr int BQ = D == 128 ? 16 : 32;  // queries per staged tile
  constexpr int THREADS = WARPS * 32;
  constexpr int LDS = D + 8;
  constexpr int NT = BQ / 8;  // 8-query column tiles of S^T

  __shared__ __align__(16) __nv_bfloat16 sK[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sdO[BQ * LDS];
  __shared__ float sLse[BQ];  // lse * log2(e)
  __shared__ float sDelta[BQ];

  const int kb = blockIdx.x % num_kblocks;
  const int bh = blockIdx.x / num_kblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad
  const int k0 = kb * BN;
  const int key_lo = k0 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const bool ok_lo = key_lo < L && (mb == nullptr || mb[key_lo] != 0);
  const bool ok_hi = key_hi < L && (mb == nullptr || mb[key_hi] != 0);

  stage_rows<T, D, BN, THREADS>(k + head, k0, L, sK, tid);
  stage_rows<T, D, BN, THREADS>(v + head, k0, L, sV, tid);

  float acc_dk[D / 8][4];
  float acc_dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dn][e] = acc_dv[dn][e] = 0.f;
  }

  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < L; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<T, D, BQ, THREADS>(q + head, q0, L, sQ, tid);
    stage_rows<T, D, BQ, THREADS>(dout + head, q0, L, sdO, tid);
    for (int i = tid; i < BQ; i += THREADS) {
      const int row = q0 + i;
      sLse[i] = row < L ? lh[row] * LOG2E : 0.f;
      sDelta[i] = row < L ? dh[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float s[NT][4];
    float dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LDS>(sK, warp * 16, kk, g, t, ka);
      frag_a<LDS>(sV, warp * 16, kk, g, t, va);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_rows<LDS>(sQ, nt * 8, kk, g, t, b0, b1);
        mma_bf16(s[nt], ka, b0, b1);
        frag_b_rows<LDS>(sdO, nt * 8, kk, g, t, b0, b1);
        mma_bf16(dp[nt], va, b0, b1);
      }
    }

    // P^T and dS^T in place; rows are keys, columns queries
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int query = q0 + ql;
        const int key = (e < 2) ? key_lo : key_hi;
        const bool ok = ((e < 2) ? ok_lo : ok_hi) && query < L && (!causal || key <= query);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - sLse[ql]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDelta[ql]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the queries as the k dimension
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t pa[4], dsa[4];
      c_to_a(s[2 * ks], s[2 * ks + 1], pa);
      c_to_a(dp[2 * ks], dp[2 * ks + 1], dsa);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b0, b1;
        frag_b_cols<LDS>(sdO, ks * 16, dn * 8, g, t, b0, b1);
        mma_bf16(acc_dv[dn], pa, b0, b1);
        frag_b_cols<LDS>(sQ, ks * 16, dn * 8, g, t, b0, b1);
        mma_bf16(acc_dk[dn], dsa, b0, b1);
      }
    }
  }

  T* dkh = dk + head;
  T* dvh = dv + head;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (key_lo < L) {
      const size_t at = static_cast<size_t>(key_lo) * D + col;
      store2(dkh + at, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
      store2(dvh + at, acc_dv[dn][0], acc_dv[dn][1]);
    }
    if (key_hi < L) {
      const size_t at = static_cast<size_t>(key_hi) * D + col;
      store2(dkh + at, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
      store2(dvh + at, acc_dv[dn][2], acc_dv[dn][3]);
    }
  }
}

template <typename T, int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    T* __restrict__ dq, int H, int L, int num_qblocks, int causal,
                    float scale_log2, float scale) {
  constexpr int BM = 16 * WARPS;          // query rows per block
  constexpr int BK = D == 128 ? 16 : 32;  // keys per staged tile
  constexpr int THREADS = WARPS * 32;
  constexpr int LDS = D + 8;
  constexpr int NT = BK / 8;  // 8-key column tiles of S

  __shared__ __align__(16) __nv_bfloat16 sQ[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sdO[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LDS];
  __shared__ float sValid[BK];

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qb * BM;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float lse2[2] = {row_lo < L ? lh[row_lo] * LOG2E : 0.f,
                         row_hi < L ? lh[row_hi] * LOG2E : 0.f};
  const float dlt[2] = {row_lo < L ? dh[row_lo] : 0.f, row_hi < L ? dh[row_hi] : 0.f};

  stage_rows<T, D, BM, THREADS>(q + head, q0, L, sQ, tid);
  stage_rows<T, D, BM, THREADS>(dout + head, q0, L, sdO, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  // causal: keys past the block's last query row are masked for every row
  const int kv_end = causal ? min(L, q0 + BM) : L;
  for (int n0 = 0; n0 < kv_end; n0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<T, D, BK, THREADS>(k + head, n0, L, sK, tid);
    stage_rows<T, D, BK, THREADS>(v + head, n0, L, sV, tid);
    for (int i = tid; i < BK; i += THREADS) {
      const int key = n0 + i;
      sValid[i] = (key < L && (mb == nullptr || mb[key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys per warp
    float s[NT][4];
    float dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a<LDS>(sQ, warp * 16, kk, g, t, qa);
      frag_a<LDS>(sdO, warp * 16, kk, g, t, da);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_rows<LDS>(sK, nt * 8, kk, g, t, b0, b1);
        mma_bf16(s[nt], qa, b0, b1);
        frag_b_rows<LDS>(sV, nt * 8, kk, g, t, b0, b1);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }

    // dS in place of S
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int key = n0 + kl;
        const int r = e >> 1;
        const int row = r ? row_hi : row_lo;
        const bool ok = sValid[kl] > 0.f && row < L && (!causal || key <= row);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[r]);
      }
    }

    // dQ += dS K, the keys as the k dimension
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t dsa[4];
      c_to_a(s[2 * ks], s[2 * ks + 1], dsa);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b0, b1;
        frag_b_cols<LDS>(sK, ks * 16, dn * 8, g, t, b0, b1);
        mma_bf16(acc[dn], dsa, b0, b1);
      }
    }
  }

  T* dqh = dq + head;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L) {
      store2(dqh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * scale, acc[dn][1] * scale);
    }
    if (row_hi < L) {
      store2(dqh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * scale, acc[dn][3] * scale);
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
  void* d0;  // dK (dK/dV kernel) or dQ (dQ kernel)
  void* d1;  // dV (dK/dV kernel)
  int B, H, L, causal;
  float scale;  // the softmax scale, 1/sqrt(D) of the head dim the caller means
};

template <typename T, int D, int WARPS, bool DKV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int ROWS = 16 * WARPS;  // keys (dK/dV) or queries (dQ) per block
  const int tiles = (a.L + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(tiles) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale = a.scale;
  const float scale_log2 = LOG2E * scale;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if constexpr (DKV) {
    flash_bwd_dkv_kernel<T, D, WARPS><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), static_cast<T*>(a.d1),
        a.H, a.L, tiles, a.causal, scale_log2, scale);
  } else {
    flash_bwd_dq_kernel<T, D, WARPS><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), a.H, a.L, tiles, a.causal,
        scale_log2, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool DKV>
cudaError_t by_warps(int warps, const Args& a, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch<T, D, 1, DKV>(a, stream);
    case 2: return launch<T, D, 2, DKV>(a, stream);
    case 4: return launch<T, D, 4, DKV>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the packed-sets kernels of dK/dV and of dQ (below), taken at L up to
// SETS_MAX_L
constexpr int SETS_MAX_L = 32;

template <typename T, int D, bool DKV>
cudaError_t launch_sets(const Args& a, cudaStream_t stream);

template <typename T, bool DKV>
cudaError_t by_dim(int D, int warps, const Args& a, cudaStream_t stream) {
  if (a.L <= SETS_MAX_L) {
    switch (D) {
      case 16: return launch_sets<T, 16, DKV>(a, stream);
      case 32: return launch_sets<T, 32, DKV>(a, stream);
      case 64: return launch_sets<T, 64, DKV>(a, stream);
      case 128: return launch_sets<T, 128, DKV>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return by_warps<T, 16, DKV>(warps, a, stream);
    case 32: return by_warps<T, 32, DKV>(warps, a, stream);
    case 64: return by_warps<T, 64, DKV>(warps, a, stream);
    case 128: return by_warps<T, 128, DKV>(warps, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int by_dtype(const Args& a, int D, int dtype, int warps, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = by_dim<__nv_bfloat16, DKV>(D, warps, a, s);
  } else if (dtype == 1) {
    err = by_dim<float, DKV>(D, warps, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}


// ---- the wide instances: head dims above 128, any D with D % 8 == 0
//
// The head dim is a run-time argument. Rows are staged in chunks of
// WIDE_DW = 256 columns, each 16-byte vector below D loaded and the
// shared-memory columns from D up to the chunk's width zeroed, so no caller
// pads D and no column past D is read or written. blockIdx.y picks the
// block's chunk of output columns, c0 = 256 blockIdx.y. The products that
// run along D (S and dP, or S^T and dP^T) sum over every depth chunk; the
// chunks are taken in an order that ends on c0, so the tiles the
// accumulation reads (Q and dO for dK/dV, K for dQ) hold the block's own
// columns when it starts. Every depth chunk is staged in turn, and each
// output chunk's block recomputes S and dP (the repair of head dims above
// 256: right, not fast). Every D in (128, 512] takes the one-pass instances below
// (flash_bwd_dq_onepass_kernel, flash_bwd_dkv_onepass_kernel) instead: these
// chunked kernels remain only above 512, where no main path reaches them.
//
// At D = 256 a warp's 16 keys of dK and dV in float32 registers are 256 a
// thread, and the staged K, V, Q and dO tiles overflow 48 KB of static
// shared memory. So each block's 8 warps split the work two ways, WIDE_RG
// groups of 16 rows (keys for dK/dV, queries for dQ) times WIDE_CQ column
// quarters of the chunk, with every tile in dynamic shared memory (~71
// KB). Per 32-row swept tile:
// 1. warp (rg, cq) computes S and dP (S^T and dP^T for dK/dV) for its 16
//    rows against the tile's rows cq*8 .. cq*8 + 7 over the whole depth D,
//    fragments read from shared memory as it goes, forms P and dS as the
//    instances above do and writes them, rounded to bf16 as those instances
//    round them for their products, into shared tiles;
// 2. after a barrier each warp reads its row group's 16 x 32 P and dS back
//    as A fragments and accumulates its own 64 columns of the chunk: dV +=
//    P^T dO and dK += dS^T Q (64 float32 registers a thread for both), or
//    dQ += dS K, skipping 8-column tiles at or past D.
// No product is computed twice at D <= 256; every output element is summed
// by one thread in a fixed order. Bound on an H100: at [4, 4, 1024, 256]
// bf16, dK/dV does 8 D operations per pair (34.4 GFLOP, ~34.7 us at 989
// TFLOP/s) and dQ 6 D (25.8 GFLOP, ~26.1 us), against 8 and 6 [B, H, L,
// D] bf16 tensors read or written (67 MB, ~20 us; 50 MB, ~15 us): bound by
// operations. Simple before fast: mma.sync, no pipelining.

constexpr int WIDE_DW = 256;             // columns of a staged chunk of D
constexpr int WIDE_LDS = WIDE_DW + 8;    // shared row stride (bf16)
constexpr int WIDE_RG = 2;             // groups of 16 rows a block
constexpr int WIDE_CQ = 4;             // column quarters of a chunk
constexpr int WIDE_WARPS = WIDE_RG * WIDE_CQ;
constexpr int WIDE_THREADS = WIDE_WARPS * 32;
constexpr int WIDE_ROWS = 16 * WIDE_RG;  // keys (dK/dV) or queries (dQ) per block
constexpr int WIDE_SWEEP = 8 * WIDE_CQ;  // swept queries (dK/dV) or keys (dQ) per tile
constexpr int WIDE_LDP = WIDE_SWEEP + 8; // bf16 row stride of the P and dS tiles

constexpr size_t wide_bwd_smem() {
  return static_cast<size_t>(2 * WIDE_ROWS + 2 * WIDE_SWEEP) * WIDE_LDS * sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * WIDE_ROWS * WIDE_LDP) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * WIDE_SWEEP) * sizeof(float);
}

// rows [r0, r0 + ROWS), columns [c0, c0 + WIDE_DW) of a contiguous [L, D]
// matrix into shared memory as bf16; rows past L and columns past D are 0
template <typename T, int ROWS>
__device__ __forceinline__ void stage_wide(const T* __restrict__ src, int r0, int L, int D, int c0,
                                           __nv_bfloat16* dst, int tid) {
  constexpr int CHUNKS = WIDE_DW / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += WIDE_THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = r0 + r;
    if (row < L && c0 + c < D) {
      load8(src + static_cast<size_t>(row) * D + c0 + c, dst + r * WIDE_LDS + c);
    } else {
      zero8(dst + r * WIDE_LDS + c);
    }
  }
}

// the first column of the i-th depth chunk a block of output chunk
// blockIdx.y takes: the order ends on its own chunk
__device__ __forceinline__ int depth_chunk(int i, int chunks) {
  return ((static_cast<int>(blockIdx.y) + 1 + i) % chunks) * WIDE_DW;
}

__device__ __forceinline__ void put_bf16(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// two blocks an SM (at most 128 registers a thread) for both wide
// kernels: one leaves the SM waiting on the barriers and the loads of its
// single tile
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int L, int D, int num_kblocks, int causal,
                          float scale_log2, float scale) {
  constexpr int LDS = WIDE_LDS;
  constexpr int DC = WIDE_DW / WIDE_CQ;
  static_assert(DC % 8 == 0, "whole 8-column tiles a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + WIDE_ROWS * LDS;
  __nv_bfloat16* sQ = sV + WIDE_ROWS * LDS;
  __nv_bfloat16* sdO = sQ + WIDE_SWEEP * LDS;
  __nv_bfloat16* sP = sdO + WIDE_SWEEP * LDS;  // P^T [keys][queries]
  __nv_bfloat16* sdS = sP + WIDE_ROWS * WIDE_LDP;
  float* sLse = reinterpret_cast<float*>(sdS + WIDE_ROWS * WIDE_LDP);  // lse * log2(e)
  float* sDelta = sLse + WIDE_SWEEP;

  const int kb = blockIdx.x % num_kblocks;
  const int bh = blockIdx.x / num_kblocks;
  const int b = bh / H;
  const int chunks = gridDim.y;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / WIDE_CQ;
  const int cq = warp % WIDE_CQ;
  const int k0 = kb * WIDE_ROWS;
  const int key_lo = k0 + rg * 16 + g;
  const int key_hi = key_lo + 8;
  const bool ok_lo = key_lo < L && (mb == nullptr || mb[key_lo] != 0);
  const bool ok_hi = key_hi < L && (mb == nullptr || mb[key_hi] != 0);
  const int col0 = blockIdx.y * WIDE_DW + cq * DC;  // the warp's first output column

  float acc_dk[DC / 8][4];
  float acc_dv[DC / 8][4];
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dn][e] = acc_dv[dn][e] = 0.f;
  }

  const int q_begin = causal ? (k0 / WIDE_SWEEP) * WIDE_SWEEP : 0;
  for (int q0 = q_begin; q0 < L; q0 += WIDE_SWEEP) {
    __syncthreads();  // every warp is done with the previous tile's Q, dO, P and dS
    for (int i = tid; i < WIDE_SWEEP; i += WIDE_THREADS) {
      const int row = q0 + i;
      sLse[i] = row < L ? lh[row] * LOG2E : 0.f;
      sDelta[i] = row < L ? dh[row] : 0.f;
    }

    // 1. S^T and dP^T of keys rg*16.. against queries cq*8.., over every
    // depth chunk, ending on the block's own
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < chunks; ++i) {
      const int d0 = depth_chunk(i, chunks);
      if (i > 0) __syncthreads();  // every warp is done with the previous chunk
      stage_wide<T, WIDE_ROWS>(k + head, k0, L, D, d0, sK, tid);
      stage_wide<T, WIDE_ROWS>(v + head, k0, L, D, d0, sV, tid);
      stage_wide<T, WIDE_SWEEP>(q + head, q0, L, D, d0, sQ, tid);
      stage_wide<T, WIDE_SWEEP>(dout + head, q0, L, D, d0, sdO, tid);
      __syncthreads();
      const int kk_end = (min(D - d0, WIDE_DW) + 15) / 16;  // zero columns past D
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        uint32_t ka[4], va[4], b0, b1;
        frag_a<LDS>(sK, rg * 16, kk, g, t, ka);
        frag_a<LDS>(sV, rg * 16, kk, g, t, va);
        frag_b_rows<LDS>(sQ, cq * 8, kk, g, t, b0, b1);
        mma_bf16(s, ka, b0, b1);
        frag_b_rows<LDS>(sdO, cq * 8, kk, g, t, b0, b1);
        mma_bf16(dp, va, b0, b1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = cq * 8 + 2 * t + (e & 1);
      const int query = q0 + ql;
      const int key = (e < 2) ? key_lo : key_hi;
      const bool ok = ((e < 2) ? ok_lo : ok_hi) && query < L && (!causal || key <= query);
      const float p = ok ? exp2f(s[e] * scale_log2 - sLse[ql]) : 0.f;
      const int at = (rg * 16 + g + 8 * (e >> 1)) * WIDE_LDP + ql;
      put_bf16(sP + at, p);
      put_bf16(sdS + at, p * (dp[e] - sDelta[ql]));
    }
    __syncthreads();

    // 2. dV += P^T dO and dK += dS^T Q over the warp's columns
#pragma unroll
    for (int ks = 0; ks < WIDE_SWEEP / 16; ++ks) {
      uint32_t pa[4], dsa[4];
      frag_a<WIDE_LDP>(sP, rg * 16, ks, g, t, pa);
      frag_a<WIDE_LDP>(sdS, rg * 16, ks, g, t, dsa);
#pragma unroll
      for (int dn = 0; dn < DC / 8; ++dn) {
        if (col0 + dn * 8 >= D) continue;  // the tile's columns are all past D
        uint32_t b0, b1;
        frag_b_cols<LDS>(sdO, ks * 16, cq * DC + dn * 8, g, t, b0, b1);
        mma_bf16(acc_dv[dn], pa, b0, b1);
        frag_b_cols<LDS>(sQ, ks * 16, cq * DC + dn * 8, g, t, b0, b1);
        mma_bf16(acc_dk[dn], dsa, b0, b1);
      }
    }
  }

  T* dkh = dk + head;
  T* dvh = dv + head;
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
    if (key_lo < L) {
      const size_t at = static_cast<size_t>(key_lo) * D + col;
      store2(dkh + at, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
      store2(dvh + at, acc_dv[dn][0], acc_dv[dn][1]);
    }
    if (key_hi < L) {
      const size_t at = static_cast<size_t>(key_hi) * D + col;
      store2(dkh + at, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
      store2(dvh + at, acc_dv[dn][2], acc_dv[dn][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, T* __restrict__ dq, int H, int L,
                         int D, int num_qblocks, int causal, float scale_log2, float scale) {
  constexpr int LDS = WIDE_LDS;
  constexpr int DC = WIDE_DW / WIDE_CQ;
  static_assert(DC % 8 == 0, "whole 8-column tiles a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + WIDE_ROWS * LDS;
  __nv_bfloat16* sK = sdO + WIDE_ROWS * LDS;
  __nv_bfloat16* sV = sK + WIDE_SWEEP * LDS;
  __nv_bfloat16* sdS = sV + WIDE_SWEEP * LDS;  // dS [queries][keys]
  float* sValid = reinterpret_cast<float*>(sdS + 2 * WIDE_ROWS * WIDE_LDP);

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const int chunks = gridDim.y;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / WIDE_CQ;
  const int cq = warp % WIDE_CQ;
  const int q0 = qb * WIDE_ROWS;
  const int row_lo = q0 + rg * 16 + g;
  const int row_hi = row_lo + 8;
  const float lse2[2] = {row_lo < L ? lh[row_lo] * LOG2E : 0.f,
                         row_hi < L ? lh[row_hi] * LOG2E : 0.f};
  const float dlt[2] = {row_lo < L ? dh[row_lo] : 0.f, row_hi < L ? dh[row_hi] : 0.f};
  const int col0 = blockIdx.y * WIDE_DW + cq * DC;  // the warp's first output column

  float acc[DC / 8][4];
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  const int kv_end = causal ? min(L, q0 + WIDE_ROWS) : L;
  for (int n0 = 0; n0 < kv_end; n0 += WIDE_SWEEP) {
    __syncthreads();  // every warp is done with the previous tile's K, V and dS
    for (int i = tid; i < WIDE_SWEEP; i += WIDE_THREADS) {
      const int key = n0 + i;
      sValid[i] = (key < L && (mb == nullptr || mb[key] != 0)) ? 1.f : 0.f;
    }

    // 1. S and dP of rows rg*16.. against keys cq*8.., over every depth
    // chunk, ending on the block's own
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < chunks; ++i) {
      const int d0 = depth_chunk(i, chunks);
      if (i > 0) __syncthreads();  // every warp is done with the previous chunk
      stage_wide<T, WIDE_ROWS>(q + head, q0, L, D, d0, sQ, tid);
      stage_wide<T, WIDE_ROWS>(dout + head, q0, L, D, d0, sdO, tid);
      stage_wide<T, WIDE_SWEEP>(k + head, n0, L, D, d0, sK, tid);
      stage_wide<T, WIDE_SWEEP>(v + head, n0, L, D, d0, sV, tid);
      __syncthreads();
      const int kk_end = (min(D - d0, WIDE_DW) + 15) / 16;  // zero columns past D
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        uint32_t qa[4], da[4], b0, b1;
        frag_a<LDS>(sQ, rg * 16, kk, g, t, qa);
        frag_a<LDS>(sdO, rg * 16, kk, g, t, da);
        frag_b_rows<LDS>(sK, cq * 8, kk, g, t, b0, b1);
        mma_bf16(s, qa, b0, b1);
        frag_b_rows<LDS>(sV, cq * 8, kk, g, t, b0, b1);
        mma_bf16(dp, da, b0, b1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = cq * 8 + 2 * t + (e & 1);
      const int key = n0 + kl;
      const int r = e >> 1;
      const int row = r ? row_hi : row_lo;
      const bool ok = sValid[kl] > 0.f && row < L && (!causal || key <= row);
      const float p = ok ? exp2f(s[e] * scale_log2 - lse2[r]) : 0.f;
      put_bf16(sdS + (rg * 16 + g + 8 * r) * WIDE_LDP + kl, p * (dp[e] - dlt[r]));
    }
    __syncthreads();

    // 2. dQ += dS K over the warp's columns
#pragma unroll
    for (int ks = 0; ks < WIDE_SWEEP / 16; ++ks) {
      uint32_t dsa[4];
      frag_a<WIDE_LDP>(sdS, rg * 16, ks, g, t, dsa);
#pragma unroll
      for (int dn = 0; dn < DC / 8; ++dn) {
        if (col0 + dn * 8 >= D) continue;  // the tile's columns are all past D
        uint32_t b0, b1;
        frag_b_cols<LDS>(sK, ks * 16, cq * DC + dn * 8, g, t, b0, b1);
        mma_bf16(acc[dn], dsa, b0, b1);
      }
    }
  }

  T* dqh = dq + head;
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
    if (row_lo < L) {
      store2(dqh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * scale, acc[dn][1] * scale);
    }
    if (row_hi < L) {
      store2(dqh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * scale, acc[dn][3] * scale);
    }
  }
}

// ---- dQ and dK/dV in one pass: D in (128, ONEPASS_MAX_DIM]
//
// flash_bwd_dq_onepass_kernel replaces the TPU kernel
// dragonfly2_tpu/ops/flash.py::_flash_bwd_dq_kernel (:474) and
// flash_bwd_dkv_onepass_kernel ::_flash_bwd_dkv_kernel (:418) at these head
// dims, where the wide mma.sync instances are routed (float32, and bf16 at
// L up to ops/flash.py's WIDE_DQ_SM90_MIN_L / WIDE_DKV_SM90_MIN_L or D
// above 256). The chunked kernels above split D above 256 into 256-column output
// chunks along blockIdx.y: at D = 320 each block of 32 rows runs as two
// blocks, each restaging its operands per depth chunk and recomputing S and
// dP over all 320 columns, with three of the second block's four column
// warps idle past D. At D up to 256 they stage with plain loads through
// registers (about one 16-byte load in flight a thread), the swept tile
// behind the block's own rows and a barrier, fix the block at four column
// quarters of 64 columns (two of eight warps idle in step 2 at D = 192) and
// read fragments as single 32-bit shared loads. The one-pass instances
// replace them for every D in (128, ONEPASS_MAX_DIM]: one block gives every
// output column of its 32 rows (keys for dK/dV, queries for dQ), WIDE_RG
// row groups of 16 rows times CW column warps of CWID columns (template
// parameters: 4 x 48 at D up to 192, 4 x 64 up to 256, then ceil(D / 64) x
// 64, so that both row groups' warps number at least the eight score tiles
// of step 1 and no more than one warp a row group idles past D). The
// block's rows of two operands (K and V, or Q and dO) stay in shared memory;
// per swept tile of 32 rows (queries for dK/dV, keys for dQ):
// 1. the first eight warps compute the tile's 8 (16 x 8) tiles of S^T and
//    dP^T (dK/dV) or S and dP (dQ) over the whole depth, once, fragments
//    read from shared memory, form P^T and dS^T or dS as the chunked kernels
//    do (the same key mask, causal rule and bf16 rounding) and write them
//    into shared tiles;
// 2. after a barrier every warp reads its row group's 16 x 32 scores back
//    as A fragments and accumulates over its own columns, dV += P^T dO and
//    dK += dS^T Q, or dQ += dS K, skipping 8-column tiles past D.
// Every operand is staged by cp.async for bf16 (float32 is rounded to bf16
// on the way in, synchronously), the block's rows and its first swept tile
// in one group before the first wait, the next tile in flight in a second
// stage where L holds more than one tile and shared memory allows; dK/dV's
// lse and delta ride with each query tile, dQ's lse and delta of its rows
// stay in registers and each key tile's validity is read from the mask.
// Fragments come from shared memory by ldmatrix (.trans for the B operands
// of step 2, two 8-column tiles a load). A bf16 output goes back through the
// shared rows step 1 no longer reads (K and V for dK/dV, Q for dQ) and
// leaves in 16-byte stores, 5-17% faster on the card than the fragments'
// own 4-byte stores; float32 keeps those. Footprint with one stage: dK/dV
// 57 KB at D = 192 and 89 KB at 320, dQ 54 KB and 87 KB; a second stage
// adds 25 KB / 42 KB. Blocks an SM: as many as shared memory allows and
// that keep 32 registers a thread beyond dK/dV's two accumulators (three at
// 48 columns a warp, 80 registers with ~80 bytes spilled, 4% faster than
// two; two at 64 columns up to D = 320, where two with ~90 bytes spilled
// beat one clean block) and 80 for dQ's one accumulator (three at D up to
// 256, 9% faster than two, and four, at 64 registers, 5% slower; two up to
// 384). The ranker's sets (L = 20) sweep one tile, so a block makes one
// round trip to memory. Sets are not packed across blocks as the forward's
// short-set instance packs them: a 32-row block holds one set of 20 rows
// and 12 rows of padding.
// Bound on an H100: the wide rankers' training, bf16, reads q, k, v, dO,
// lse and delta and writes dK and dV (dQ): at [256, 4, 20, 192] 47.3 MB
// (39.5 MB), 0.0141 ms (0.0118 ms) at 3.35 TB/s, at [256, 4, 20, 320] 78.9
// MB (65.8 MB), 0.0235 ms (0.0196 ms), against at most 0.6 and 1.0 GFLOP:
// bound by bytes, so every load of a block is in flight at once and another
// block an SM computes while one loads. Every output element is summed by
// one thread in a fixed order. Above ONEPASS_MAX_DIM the chunked kernels
// stay (no main path reaches them).

constexpr int ONEPASS_MAX_DIM = 512;
constexpr int ONEPASS_SCORE_WARPS = WIDE_RG * WIDE_SWEEP / 8;  // 16 x 8 score tiles
constexpr size_t SM_SMEM = 233472;     // shared memory of an SM on sm_90, bytes
constexpr size_t BLOCK_SMEM = 232448;  // of one block

// blocks an SM, up to four, whose shared memory (and 1 KB each the
// runtime keeps) fits and that keep at least min_regs registers a thread
constexpr int blocks_an_sm(size_t smem, int threads, int min_regs) {
  int n = 1;
  while (n < 4 && (n + 1) * (smem + 1024) <= SM_SMEM && 65536 / ((n + 1) * threads) >= min_regs) {
    ++n;
  }
  return n;
}

template <bool DKV, int CW, int CWID>
struct Onepass {
  static constexpr int WARPS = WIDE_RG * CW;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int DN = CWID / 8;            // 8-column tiles a warp accumulates
  static constexpr int LDS = CW * CWID + 8;      // shared row stride (bf16)
  static constexpr int TILE = WIDE_SWEEP * LDS;  // one operand of a swept tile
  // the block's rows of two operands and the bf16 score tiles (P^T and
  // dS^T, or dS); a stage: the swept tile's two operands, and dK/dV's lse
  // and delta
  static constexpr size_t FIXED =
      static_cast<size_t>(2 * WIDE_ROWS * LDS + (DKV ? 2 : 1) * WIDE_ROWS * WIDE_LDP) *
      sizeof(__nv_bfloat16);
  static constexpr size_t STAGE = static_cast<size_t>(2 * TILE) * sizeof(__nv_bfloat16) +
                                  (DKV ? static_cast<size_t>(2 * WIDE_SWEEP) * sizeof(float) : 0);
  static constexpr int MIN_BLOCKS = blocks_an_sm(FIXED + STAGE, THREADS, DKV ? 8 * DN + 32 : 80);
  static constexpr bool TWO_STAGES = FIXED + 2 * STAGE <= BLOCK_SMEM;
  static_assert(CWID % 16 == 0, "ldmatrix.trans B operands: pairs of 8-column tiles");
  static_assert(WARPS >= ONEPASS_SCORE_WARPS, "a warp for every score tile");
  static_assert(FIXED + STAGE <= BLOCK_SMEM, "a block's shared memory on sm_90");
};

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: 8x8 tiles of b16 from shared memory, lanes 8i .. 8i + 7 giving
// the rows of tile i; lane l receives row l / 4, elements 2 (l % 4) and
// 2 (l % 4) + 1 of each tile (the mma.sync fragment layout), or with .trans
// column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two tiles: lanes 0 .. 15 give the addresses
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// rows r0 .. r0 + rows - 1 of a contiguous [L, D] matrix into shared rows
// of LDS bf16, columns 0 .. LDS - 9: rows past L and the columns from D on
// are 0. bf16 by cp.async (the caller commits and waits), float32 rounded
// to bf16 on the way in. The chunks a row are a compile-time count, so the
// index split is a multiply, not a division.
template <typename T, int THREADS, int LDS>
__device__ __forceinline__ void stage_rows_async(const T* __restrict__ src, int r0, int rows,
                                                 int L, int D, __nv_bfloat16* dst, int tid) {
  constexpr int CHUNKS = (LDS - 8) / 8;  // 16-byte chunks of a staged row
  for (int i = tid; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * 8;
    const int row = r0 + r;
    const bool in = row < L && c < D;
    const T* from = src + (in ? static_cast<size_t>(row) * D + c : 0);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      cp_async16(dst + r * LDS + c, from, in);
    } else if (in) {
      load8(from, dst + r * LDS + c);
    } else {
      zero8(dst + r * LDS + c);
    }
  }
}

// swept tile r0 of two operands (Q and dO, or K and V) into a stage,
// committed with every copy issued before it
template <typename T, int THREADS, int LDS>
__device__ __forceinline__ void stage_swept_tile(const T* __restrict__ x, const T* __restrict__ y,
                                                 int r0, int L, int D, __nv_bfloat16* sx,
                                                 __nv_bfloat16* sy, int tid) {
  stage_rows_async<T, THREADS, LDS>(x, r0, WIDE_SWEEP, L, D, sx, tid);
  stage_rows_async<T, THREADS, LDS>(y, r0, WIDE_SWEEP, L, D, sy, tid);
  cp_async_commit();
}

// dK/dV's query tile q0: Q and dO in flight first, then its lse * log2(e)
// and delta
template <typename T, int THREADS, int LDS>
__device__ __forceinline__ void stage_query_tile(const T* __restrict__ q,
                                                 const T* __restrict__ dout,
                                                 const float* __restrict__ lh,
                                                 const float* __restrict__ dh, int q0, int L,
                                                 int D, __nv_bfloat16* sQ, __nv_bfloat16* sdO,
                                                 float* sLse, float* sDelta, int tid) {
  stage_swept_tile<T, THREADS, LDS>(q, dout, q0, L, D, sQ, sdO, tid);
  for (int i = tid; i < WIDE_SWEEP; i += THREADS) {
    const int row = q0 + i;
    sLse[i] = row < L ? lh[row] * LOG2E : 0.f;
    sDelta[i] = row < L ? dh[row] : 0.f;
  }
}

// step 2's product for one warp: acc[dn] += A (16 x 32 scores of rows
// a_row.. in a [32][WIDE_LDP] tile) times B = rows 0 .. 31, columns col0
// .. col0 + 8 DN - 1 of a swept tile, read transposed two 8-column tiles at
// a time, each 16-row step's B tiles rows 16 ks + 8 (tile & 1) .., columns
// 8 (tile >> 1) ..
template <int DN, int LDS>
__device__ __forceinline__ void accumulate_swept(float (&acc)[DN][4], const __nv_bfloat16* scores,
                                                 int a_row, const __nv_bfloat16* tile, int col0,
                                                 int D, int lrow, int ltile) {
#pragma unroll
  for (int ks = 0; ks < WIDE_SWEEP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, scores + (a_row + lrow + (ltile & 1) * 8) * WIDE_LDP + ks * 16 + (ltile >> 1) * 8);
    const int b_at = (ks * 16 + lrow + (ltile & 1) * 8) * LDS + col0 + (ltile >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      if (col0 + dn * 8 >= D) break;  // the tiles' columns are all past D
      uint32_t b[4];
      ldsm_x4_trans(b, tile + b_at + dn * 8);
      mma_bf16(acc[dn], a, b[0], b[1]);
      if (col0 + dn * 8 + 8 < D) mma_bf16(acc[dn + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 .. r0 + 31 below L, columns below D, of a bf16 output from shared
// rows of LDS bf16 to device memory, a 16-byte store each
template <int THREADS, int LDS>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* src, int r0, int L, int D,
                                           __nv_bfloat16* __restrict__ dst, int tid) {
  constexpr int CHUNKS = (LDS - 8) / 8;
  for (int i = tid; i < WIDE_ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * 8;
    if (r0 + r < L && c < D) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(src + r * LDS + c);
    }
  }
}

template <typename T, int CW, int CWID>
__global__ void __launch_bounds__((Onepass<true, CW, CWID>::THREADS),
                                  (Onepass<true, CW, CWID>::MIN_BLOCKS))
flash_bwd_dkv_onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const uint8_t* __restrict__ mask, T* __restrict__ dk,
                             T* __restrict__ dv, int H, int L, int D, int num_kblocks,
                             int causal, int stages, float scale_log2, float scale) {
  using C = Onepass<true, CW, CWID>;
  constexpr int LDS = C::LDS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + WIDE_ROWS * LDS;
  __nv_bfloat16* sP = sV + WIDE_ROWS * LDS;  // P^T [keys][queries]
  __nv_bfloat16* sdS = sP + WIDE_ROWS * WIDE_LDP;
  __nv_bfloat16* sQ = sdS + WIDE_ROWS * WIDE_LDP;  // stage s at sQ + s * TILE
  __nv_bfloat16* sdO = sQ + stages * C::TILE;
  float* sLse = reinterpret_cast<float*>(sdO + stages * C::TILE);  // stage s at + s * WIDE_SWEEP
  float* sDelta = sLse + stages * WIDE_SWEEP;

  const int kb = blockIdx.x % num_kblocks;
  const int bh = blockIdx.x / num_kblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / CW;  // step 2: the warp's row group of keys and its columns
  const int cw = warp % CW;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  const int k0 = kb * WIDE_ROWS;
  const int col0 = cw * CWID;
  const int kk_end = (D + 15) / 16;  // depth steps; the columns from D on are 0
  // step 1: warp w < 8 takes keys 16 (w / 4).. against queries 8 (w % 4)..
  const int skey = (warp >> 2) * 16;
  const int sq = (warp & 3) * 8;
  const int key_lo = k0 + skey + g;
  const int key_hi = key_lo + 8;
  const bool ok_lo = key_lo < L && (mb == nullptr || mb[key_lo] != 0);
  const bool ok_hi = key_hi < L && (mb == nullptr || mb[key_hi] != 0);
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (L - q_begin + WIDE_SWEEP - 1) / WIDE_SWEEP;

  stage_rows_async<T, C::THREADS, LDS>(k + head, k0, WIDE_ROWS, L, D, sK, tid);
  stage_rows_async<T, C::THREADS, LDS>(v + head, k0, WIDE_ROWS, L, D, sV, tid);
  stage_query_tile<T, C::THREADS, LDS>(q + head, dout + head, lh, dh, q_begin, L, D, sQ, sdO,
                                       sLse, sDelta, tid);  // commits K and V with it

  float acc_dk[C::DN][4];
  float acc_dv[C::DN][4];
#pragma unroll
  for (int dn = 0; dn < C::DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dn][e] = acc_dv[dn][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * WIDE_SWEEP;
    const int st = stages == 2 ? (j & 1) : 0;
    if (stages == 1 && j > 0) {
      __syncthreads();  // every warp is done with tile j-1's Q and dO
      stage_query_tile<T, C::THREADS, LDS>(q + head, dout + head, lh, dh, q0, L, D, sQ, sdO,
                                           sLse, sDelta, tid);
    }
    cp_async_wait_all();
    __syncthreads();  // tile j arrived; every warp is done with tile j-1's P^T and dS^T
    if (stages == 2 && j + 1 < n_tiles) {  // the next tile into the other stage, in flight
      stage_query_tile<T, C::THREADS, LDS>(
          q + head, dout + head, lh, dh, q0 + WIDE_SWEEP, L, D, sQ + (st ^ 1) * C::TILE,
          sdO + (st ^ 1) * C::TILE, sLse + (st ^ 1) * WIDE_SWEEP, sDelta + (st ^ 1) * WIDE_SWEEP,
          tid);
    }
    const __nv_bfloat16* tq = sQ + st * C::TILE;
    const __nv_bfloat16* tdo = sdO + st * C::TILE;
    const float* tl = sLse + st * WIDE_SWEEP;
    const float* td = sDelta + st * WIDE_SWEEP;

    // 1. S^T and dP^T, once, over the whole depth
    if (warp < ONEPASS_SCORE_WARPS) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      // A: K and V rows skey + 8 (tile & 1).., columns 8 (tile >> 1).. of
      // the step; B: Q and dO rows sq.., columns 8 (tile & 1).. of the step
      const int a_at = (skey + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
      const int b_at = (sq + lrow) * LDS + (ltile & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        uint32_t ka[4], va[4], qb[2], db[2];
        ldsm_x4(ka, sK + a_at + kk * 16);
        ldsm_x4(va, sV + a_at + kk * 16);
        ldsm_x2(qb, tq + b_at + kk * 16);
        ldsm_x2(db, tdo + b_at + kk * 16);
        mma_bf16(s, ka, qb[0], qb[1]);
        mma_bf16(dp, va, db[0], db[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = sq + 2 * t + (e & 1);
        const int query = q0 + ql;
        const int key = (e < 2) ? key_lo : key_hi;
        const bool ok = ((e < 2) ? ok_lo : ok_hi) && query < L && (!causal || key <= query);
        const float p = ok ? exp2f(s[e] * scale_log2 - tl[ql]) : 0.f;
        const int at = (skey + g + 8 * (e >> 1)) * WIDE_LDP + ql;
        put_bf16(sP + at, p);
        put_bf16(sdS + at, p * (dp[e] - td[ql]));
      }
    }
    __syncthreads();

    // 2. dV += P^T dO and dK += dS^T Q over the warp's columns
    accumulate_swept<C::DN, LDS>(acc_dv, sP, rg * 16, tdo, col0, D, lrow, ltile);
    accumulate_swept<C::DN, LDS>(acc_dk, sdS, rg * 16, tq, col0, D, lrow, ltile);
  }

  T* dkh = dk + head;
  T* dvh = dv + head;
  const int rl = rg * 16 + g;  // the warp's keys in step 2, from k0
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // K and V are free since the last tile's step 1: dK and dV go through
    // them to 16-byte stores
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn) {
      const int col = col0 + dn * 8 + 2 * t;
      store2(sK + rl * LDS + col, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
      store2(sK + (rl + 8) * LDS + col, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
      store2(sV + rl * LDS + col, acc_dv[dn][0], acc_dv[dn][1]);
      store2(sV + (rl + 8) * LDS + col, acc_dv[dn][2], acc_dv[dn][3]);
    }
    __syncthreads();
    store_rows<C::THREADS, LDS>(sK, k0, L, D, dkh, tid);
    store_rows<C::THREADS, LDS>(sV, k0, L, D, dvh, tid);
  } else {
    const int row_lo = k0 + rl;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn) {
      const int col = col0 + dn * 8 + 2 * t;
      if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
      if (row_lo < L) {
        const size_t at = static_cast<size_t>(row_lo) * D + col;
        store2(dkh + at, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
        store2(dvh + at, acc_dv[dn][0], acc_dv[dn][1]);
      }
      if (row_hi < L) {
        const size_t at = static_cast<size_t>(row_hi) * D + col;
        store2(dkh + at, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
        store2(dvh + at, acc_dv[dn][2], acc_dv[dn][3]);
      }
    }
  }
}

template <typename T, int CW, int CWID>
__global__ void __launch_bounds__((Onepass<false, CW, CWID>::THREADS),
                                  (Onepass<false, CW, CWID>::MIN_BLOCKS))
flash_bwd_dq_onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const uint8_t* __restrict__ mask, T* __restrict__ dq, int H, int L,
                            int D, int num_qblocks, int causal, int stages, float scale_log2,
                            float scale) {
  using C = Onepass<false, CW, CWID>;
  constexpr int LDS = C::LDS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + WIDE_ROWS * LDS;
  __nv_bfloat16* sdS = sdO + WIDE_ROWS * LDS;       // dS [queries][keys]
  __nv_bfloat16* sK = sdS + WIDE_ROWS * WIDE_LDP;  // stage s at sK + s * TILE
  __nv_bfloat16* sV = sK + stages * C::TILE;

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const float* lh = lse + static_cast<size_t>(bh) * L;
  const float* dh = delta + static_cast<size_t>(bh) * L;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / CW;  // step 2: the warp's row group of queries and its columns
  const int cw = warp % CW;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  const int q0 = qb * WIDE_ROWS;
  const int col0 = cw * CWID;
  const int kk_end = (D + 15) / 16;  // depth steps; the columns from D on are 0
  // step 1: warp w < 8 takes queries 16 (w / 4).. against keys 8 (w % 4)..
  const int sq = (warp >> 2) * 16;
  const int sk = (warp & 3) * 8;
  const int srow_lo = q0 + sq + g;
  const int srow_hi = srow_lo + 8;
  const float lse2[2] = {srow_lo < L ? lh[srow_lo] * LOG2E : 0.f,
                         srow_hi < L ? lh[srow_hi] * LOG2E : 0.f};
  const float dlt[2] = {srow_lo < L ? dh[srow_lo] : 0.f, srow_hi < L ? dh[srow_hi] : 0.f};
  // causal: keys past the block's last query row are masked for every row
  const int kv_end = causal ? min(L, q0 + WIDE_ROWS) : L;
  const int n_tiles = (kv_end + WIDE_SWEEP - 1) / WIDE_SWEEP;

  stage_rows_async<T, C::THREADS, LDS>(q + head, q0, WIDE_ROWS, L, D, sQ, tid);
  stage_rows_async<T, C::THREADS, LDS>(dout + head, q0, WIDE_ROWS, L, D, sdO, tid);
  stage_swept_tile<T, C::THREADS, LDS>(k + head, v + head, 0, L, D, sK, sV,
                                       tid);  // commits Q and dO with it

  float acc[C::DN][4];
#pragma unroll
  for (int dn = 0; dn < C::DN; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * WIDE_SWEEP;
    const int st = stages == 2 ? (j & 1) : 0;
    if (stages == 1 && j > 0) {
      __syncthreads();  // every warp is done with tile j-1's K and V
      stage_swept_tile<T, C::THREADS, LDS>(k + head, v + head, n0, L, D, sK, sV, tid);
    }
    cp_async_wait_all();
    __syncthreads();  // tile j arrived; every warp is done with tile j-1's dS
    if (stages == 2 && j + 1 < n_tiles) {  // the next tile into the other stage, in flight
      stage_swept_tile<T, C::THREADS, LDS>(k + head, v + head, n0 + WIDE_SWEEP, L, D,
                                           sK + (st ^ 1) * C::TILE, sV + (st ^ 1) * C::TILE, tid);
    }
    const __nv_bfloat16* tk = sK + st * C::TILE;
    const __nv_bfloat16* tv = sV + st * C::TILE;

    // 1. S and dP, once, over the whole depth
    if (warp < ONEPASS_SCORE_WARPS) {
      const int key0 = n0 + sk + 2 * t;  // the thread's two keys
      const bool kv0 = key0 < L && (mb == nullptr || mb[key0] != 0);
      const bool kv1 = key0 + 1 < L && (mb == nullptr || mb[key0 + 1] != 0);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      // A: Q and dO rows sq + 8 (tile & 1).., columns 8 (tile >> 1).. of
      // the step; B: K and V rows sk.., columns 8 (tile & 1).. of the step
      const int a_at = (sq + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
      const int b_at = (sk + lrow) * LDS + (ltile & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        uint32_t qa[4], da[4], kb2[2], vb[2];
        ldsm_x4(qa, sQ + a_at + kk * 16);
        ldsm_x4(da, sdO + a_at + kk * 16);
        ldsm_x2(kb2, tk + b_at + kk * 16);
        ldsm_x2(vb, tv + b_at + kk * 16);
        mma_bf16(s, qa, kb2[0], kb2[1]);
        mma_bf16(dp, da, vb[0], vb[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = r ? srow_hi : srow_lo;
        const int key = key0 + (e & 1);
        const bool ok = ((e & 1) ? kv1 : kv0) && row < L && (!causal || key <= row);
        const float p = ok ? exp2f(s[e] * scale_log2 - lse2[r]) : 0.f;
        put_bf16(sdS + (sq + g + 8 * r) * WIDE_LDP + sk + 2 * t + (e & 1), p * (dp[e] - dlt[r]));
      }
    }
    __syncthreads();

    // 2. dQ += dS K over the warp's columns
    accumulate_swept<C::DN, LDS>(acc, sdS, rg * 16, tk, col0, D, lrow, ltile);
  }

  T* dqh = dq + head;
  const int rl = rg * 16 + g;  // the warp's queries in step 2, from q0
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // Q is free since the last tile's step 1: dQ goes through it to 16-byte
    // stores
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn) {
      const int col = col0 + dn * 8 + 2 * t;
      store2(sQ + rl * LDS + col, acc[dn][0] * scale, acc[dn][1] * scale);
      store2(sQ + (rl + 8) * LDS + col, acc[dn][2] * scale, acc[dn][3] * scale);
    }
    __syncthreads();
    store_rows<C::THREADS, LDS>(sQ, q0, L, D, dqh, tid);
  } else {
    const int row_lo = q0 + rl;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn) {
      const int col = col0 + dn * 8 + 2 * t;
      if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
      if (row_lo < L) {
        store2(dqh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * scale,
               acc[dn][1] * scale);
      }
      if (row_hi < L) {
        store2(dqh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * scale,
               acc[dn][3] * scale);
      }
    }
  }
}

template <typename T, bool DKV, int CW, int CWID>
cudaError_t launch_onepass(const Args& a, int D, cudaStream_t stream) {
  using C = Onepass<DKV, CW, CWID>;
  const int tiles = (a.L + WIDE_ROWS - 1) / WIDE_ROWS;
  const long long blocks = static_cast<long long>(tiles) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a second stage of the swept tile only where a block sweeps more than one
  const int stages = a.L > WIDE_SWEEP && C::TWO_STAGES ? 2 : 1;
  const size_t smem = C::FIXED + stages * C::STAGE;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if constexpr (DKV) {
    auto kernel = flash_bwd_dkv_onepass_kernel<T, CW, CWID>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), C::THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), static_cast<T*>(a.d1),
        a.H, a.L, D, tiles, a.causal, stages, LOG2E * a.scale, a.scale);
  } else {
    auto kernel = flash_bwd_dq_onepass_kernel<T, CW, CWID>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), C::THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), a.H, a.L, D, tiles,
        a.causal, stages, LOG2E * a.scale, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, bool DKV>
cudaError_t launch_wide(const Args& a, int D, cudaStream_t stream) {
  const int tiles = (a.L + WIDE_ROWS - 1) / WIDE_ROWS;
  const long long blocks = static_cast<long long>(tiles) * a.B * a.H;
  const int chunks = (D + WIDE_DW - 1) / WIDE_DW;
  if (blocks > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = wide_bwd_smem();
  const dim3 grid(static_cast<unsigned>(blocks), chunks);
  const float scale = a.scale;
  const float scale_log2 = LOG2E * scale;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if constexpr (DKV) {
    auto kernel = flash_bwd_dkv_wide_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, WIDE_THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), static_cast<T*>(a.d1),
        a.H, a.L, D, tiles, a.causal, scale_log2, scale);
  } else {
    auto kernel = flash_bwd_dq_wide_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, WIDE_THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), a.H, a.L, D, tiles,
        a.causal, scale_log2, scale);
  }
  return cudaGetLastError();
}

// the wide instance for one dtype: dQ and dK/dV in one pass for D in
// (128, ONEPASS_MAX_DIM], the column warps sized to D; else the chunked
// kernel
template <typename T, bool DKV>
cudaError_t wide_by_dim(const Args& a, int D, cudaStream_t s) {
  if (D > 128 && D <= ONEPASS_MAX_DIM) {
    if (D <= 192) return launch_onepass<T, DKV, 4, 48>(a, D, s);
    switch ((D + 63) / 64) {  // column warps of 64 columns
      case 4: return launch_onepass<T, DKV, 4, 64>(a, D, s);
      case 5: return launch_onepass<T, DKV, 5, 64>(a, D, s);
      case 6: return launch_onepass<T, DKV, 6, 64>(a, D, s);
      case 7: return launch_onepass<T, DKV, 7, 64>(a, D, s);
      default: return launch_onepass<T, DKV, 8, 64>(a, D, s);
    }
  }
  return launch_wide<T, DKV>(a, D, s);
}

template <bool DKV>
int wide_by_dtype(const Args& a, int D, int dtype, void* stream) {
  // rows are read as 16-byte vectors: D % 8 == 0 (ops/flash.py pads others)
  if (a.B <= 0 || a.H <= 0 || a.L <= 0 || D <= 0 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = wide_by_dim<__nv_bfloat16, DKV>(a, D, s);
  } else if (dtype == 1) {
    err = wide_by_dim<float, DKV>(a, D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ---- dK/dV's packed-sets kernel: D in 16, 32, 64, 128, L up to SETS_MAX_L
//
// flash_bwd_dkv_kernel gives a block 16 WARPS keys of one (b, h) set: at the
// ranker's trained shape, [256, 4, 20, 32], a 2-warp block holds 20 live
// keys of 32 and sweeps a 32-query tile, stages K and V synchronously, then
// after a barrier Q, dO, lse and delta (two memory round trips in series),
// and writes dK and dV in 4-byte fragment stores: its 1,024 blocks of 64
// threads sit at 36% of the bytes' bound. This kernel packs the sets as the
// forward's flash_fwd_sets_kernel does: the keys of consecutive (b, h) sets
// form one [B H L, D] matrix, and a block owns the keys of BWD_SETS_ROWS /
// L whole consecutive sets (one at the ranker's L = 20) and sweeps the
// queries of the same sets, so one 32-query tile holds every query its keys
// see and no query is staged by two blocks. On the card (PERF.md), blocks
// of 32 consecutive keys whatever their sets staged 1.9 times the queries
// at L = 20 and gained nothing, and blocks of 64 keys of whole sets were
// slower than these 32. A pair (query, key) counts only where the
// query's set is the key's, mask[set / H, key % L] holds and, under
// causal, key <= query (the same set: key % L <= query % L); a fully masked
// key gets dK = dV = 0. Per block:
// - K, V, Q and dO of its rows as bf16 by cp.async (float32 rounded to bf16
//   on the way in, synchronously), lse and delta by 4-byte cp.async, and
//   each query's set, with one commit and one wait: one memory round trip.
// - Each warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T for
//   them; P^T and dS^T stay in registers as the A fragments of dV += P^T dO
//   and dK += dS^T Q, as flash_bwd_dkv_kernel's do; fragments come from
//   shared memory by ldmatrix (.trans for the B operands of the second
//   products). An 8-query tile, or a 16-query step, whose queries lie
//   outside the sets of the warp's keys is skipped.
// - bf16 dK scale and dV go through the warp's own K and V rows to 16-byte
//   row stores; float32 keeps the fragments' 8-byte stores.
// The function is _flash_bwd_dkv_kernel's: delta = rowsum(dO o) comes from
// the caller (ops/flash.py), P and dS are rounded to bf16 for their
// products, every output element is summed by one thread in query order,
// no atomics. Bound on an H100: at [256, 4, 20, 32] bf16 it reads q, k, v,
// dO, lse and delta and writes dK and dV, 8.0 MB (2.4 us at 3.35 TB/s),
// against at most 0.1 GFLOP: bound by bytes, so every load of a block is in
// flight at once and each byte is staged once. flash_bwd_dkv_kernel keeps
// L in (SETS_MAX_L, SM90_MIN_L] and float32 above it.

// rows a block of either packed-sets kernel holds at most: keys and swept
// queries (dK/dV), or queries and swept keys (dQ)
constexpr int BWD_SETS_ROWS = 32;

template <int D>
struct BwdSets {
  static constexpr int ROWS = BWD_SETS_ROWS;
  static constexpr int THREADS = ROWS / 16 * 32;  // a warp per 16 rows
  static constexpr int LDS = D + 8;               // shared row stride (bf16)
  // K, V, Q and dO of the block's rows, their lse, delta and the sets of
  // one side (dK/dV: the queries', dQ: the keys')
  static constexpr size_t SMEM =
      static_cast<size_t>(4 * ROWS) * LDS * sizeof(__nv_bfloat16) +
      static_cast<size_t>(ROWS) * (2 * sizeof(float) + sizeof(int));
  static_assert(ROWS >= SETS_MAX_L, "a block holds a whole set");
  static_assert(SMEM <= 48 * 1024, "within the default dynamic shared memory");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(BwdSets<D>::THREADS)
flash_bwd_dkv_sets_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int L, int N, int block_rows, int causal,
                          float scale_log2, float scale) {
  using C = BwdSets<D>;
  constexpr int LDS = C::LDS;
  constexpr int ROWS = C::ROWS;
  constexpr int KK = D / 16;               // depth steps
  constexpr int NT = ROWS / 8;             // 8-query tiles of S^T
  constexpr int OCH = D * sizeof(T) / 16;  // 16-byte chunks of an output row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + ROWS * LDS;
  __nv_bfloat16* sQ = sV + ROWS * LDS;
  __nv_bfloat16* sdO = sQ + ROWS * LDS;
  float* sLse = reinterpret_cast<float*>(sdO + ROWS * LDS);
  float* sDelta = sLse + ROWS;
  int* sQSet = reinterpret_cast<int*>(sDelta + ROWS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  // the block's keys, and queries: whole sets r0 .. r_end - 1
  const int r0 = blockIdx.x * block_rows;
  const int r_end = min(N, r0 + block_rows);
  // the warp's keys, and the queries of their sets (none before its first
  // key under causal)
  const int w0 = r0 + warp * 16;
  const int w_last = min(w0 + 15, r_end - 1);
  const int wq_begin = w0 >= r_end ? 0 : causal ? w0 : (w0 / L) * L;
  const int wq_end = w0 >= r_end ? 0 : min(r_end, (w_last / L + 1) * L);
  const int key_lo = w0 + g;
  const int key_hi = key_lo + 8;

  stage_rows_async<T, C::THREADS, LDS>(k, r0, ROWS, r_end, D, sK, tid);
  stage_rows_async<T, C::THREADS, LDS>(v, r0, ROWS, r_end, D, sV, tid);
  stage_rows_async<T, C::THREADS, LDS>(q, r0, ROWS, r_end, D, sQ, tid);
  stage_rows_async<T, C::THREADS, LDS>(dout, r0, ROWS, r_end, D, sdO, tid);
  for (int i = tid; i < ROWS; i += C::THREADS) {
    const int row = r0 + i;
    const bool in = row < r_end;
    cp_async4(sLse + i, lse + (in ? row : 0), in);
    cp_async4(sDelta + i, delta + (in ? row : 0), in);
    sQSet[i] = in ? row / L : -2;  // a query past the block matches no key
  }
  cp_async_commit();
  // a key's set, -1 for a masked key or one past the block
  auto key_set = [&](int key) {
    if (key >= r_end) return -1;
    const int set = key / L;
    return mask == nullptr || mask[static_cast<size_t>(set / H) * L + key - set * L] != 0 ? set
                                                                                          : -1;
  };
  const int set_lo = key_set(key_lo);
  const int set_hi = key_set(key_hi);
  cp_async_wait_all();
  __syncthreads();  // K, V, Q, dO, lse, delta and the query sets arrived

  // S^T = K Q^T and dP^T = V dO^T over the 8-query tiles that hold a query
  // of the warp's sets; the others stay 0
  bool meet[NT];
  float s[NT][4];
  float dp[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int first_q = r0 + nt * 8;
    meet[nt] = first_q < wq_end && first_q + 8 > wq_begin;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  }
  // A: the warp's K and V rows 8 (tile & 1).., columns 8 (tile >> 1).. of a
  // depth step
  const int a_at = (warp * 16 + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ka[4], va[4];
    ldsm_x4(ka, sK + a_at + kk * 16);
    ldsm_x4(va, sV + a_at + kk * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (!meet[nt]) continue;
      // B: Q and dO rows nt * 8.., columns 8 (tile & 1).. of the step
      const int b_at = (nt * 8 + lrow) * LDS + kk * 16 + (ltile & 1) * 8;
      uint32_t qb[2], db[2];
      ldsm_x2(qb, sQ + b_at);
      ldsm_x2(db, sdO + b_at);
      mma_bf16(s[nt], ka, qb[0], qb[1]);
      mma_bf16(dp[nt], va, db[0], db[1]);
    }
  }

  // P^T and dS^T in place; rows are keys, columns queries
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!meet[nt]) continue;
    const int2 qset = *reinterpret_cast<const int2*>(sQSet + nt * 8 + 2 * t);
    const float2 ql = *reinterpret_cast<const float2*>(sLse + nt * 8 + 2 * t);
    const float2 qd = *reinterpret_cast<const float2*>(sDelta + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = r0 + nt * 8 + 2 * t + (e & 1);
      const int key = (e < 2) ? key_lo : key_hi;
      const bool ok = ((e & 1) ? qset.y : qset.x) == (e < 2 ? set_lo : set_hi) &&
                      (!causal || key <= query);
      const float p = ok ? exp2f(s[nt][e] * scale_log2 - ((e & 1) ? ql.y : ql.x) * LOG2E) : 0.f;
      s[nt][e] = p;
      dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? qd.y : qd.x));
    }
  }

  // dV = P^T dO and dK = dS^T Q over the 16-query steps that meet the
  // warp's sets, the queries as the k dimension
  float acc_dk[D / 8][4];
  float acc_dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dn][e] = acc_dv[dn][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    if (!meet[2 * ks] && !meet[2 * ks + 1]) continue;
    uint32_t pa[4], dsa[4];
    c_to_a(s[2 * ks], s[2 * ks + 1], pa);
    c_to_a(dp[2 * ks], dp[2 * ks + 1], dsa);
    // B of two 8-column tiles at once: rows ks * 16 + 8 (tile & 1)..,
    // columns 8 (tile >> 1).., transposed
    const int b_at = (ks * 16 + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, sdO + b_at + dn * 8);
      mma_bf16(acc_dv[dn], pa, b[0], b[1]);
      mma_bf16(acc_dv[dn + 1], pa, b[2], b[3]);
      ldsm_x4_trans(b, sQ + b_at + dn * 8);
      mma_bf16(acc_dk[dn], dsa, b[0], b[1]);
      mma_bf16(acc_dk[dn + 1], dsa, b[2], b[3]);
    }
  }

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // the warp's own K and V rows (only this warp read them) take its dK
    // and dV, which leave in 16-byte row stores
    __nv_bfloat16* dk_rows = sK + warp * 16 * LDS;
    __nv_bfloat16* dv_rows = sV + warp * 16 * LDS;
    __syncwarp();
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      store2(dk_rows + g * LDS + col, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
      store2(dk_rows + (g + 8) * LDS + col, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
      store2(dv_rows + g * LDS + col, acc_dv[dn][0], acc_dv[dn][1]);
      store2(dv_rows + (g + 8) * LDS + col, acc_dv[dn][2], acc_dv[dn][3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * OCH; i += 32) {
      const int r = i / OCH;
      const int c = i - r * OCH;
      if (w0 + r < r_end) {
        const size_t at = static_cast<size_t>(w0 + r) * D;
        reinterpret_cast<uint4*>(dk + at)[c] = reinterpret_cast<const uint4*>(dk_rows + r * LDS)[c];
        reinterpret_cast<uint4*>(dv + at)[c] = reinterpret_cast<const uint4*>(dv_rows + r * LDS)[c];
      }
    }
  } else {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (key_lo < r_end) {
        const size_t at = static_cast<size_t>(key_lo) * D + col;
        store2(dk + at, acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
        store2(dv + at, acc_dv[dn][0], acc_dv[dn][1]);
      }
      if (key_hi < r_end) {
        const size_t at = static_cast<size_t>(key_hi) * D + col;
        store2(dk + at, acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
        store2(dv + at, acc_dv[dn][2], acc_dv[dn][3]);
      }
    }
  }
}

// ---- dQ's packed-sets kernel: D in 16, 32, 64, 128, L up to SETS_MAX_L
//
// flash_bwd_dq_kernel gives a block 16 WARPS query rows of one (b, h) set:
// at the ranker's trained shape, [256, 4, 20, 32], a 2-warp block holds 20
// live rows of 32 and sweeps a 32-key tile, stages Q and dO synchronously,
// then after a barrier K, V and the keys' validity (two memory round trips
// in series), and writes dQ in 4-byte fragment stores: its 1,024 blocks of
// 64 threads sit at 36% of the bytes' bound. This kernel packs the sets as
// flash_bwd_dkv_sets_kernel does, with queries and keys swapped: the
// queries of consecutive (b, h) sets form one [B H L, D] matrix, and a
// block owns the queries of BWD_SETS_ROWS / L whole consecutive sets (one
// at the ranker's L = 20) and sweeps the keys of the same sets, so one
// 32-key tile holds every key its queries see, with no second tile and no
// rescaling, and no key is staged by two blocks. On the card (PERF.md),
// blocks of 64 rows of whole sets (4 warps, three sets at L = 20) were
// slower than these 32, as they were for dK/dV. A pair (query, key)
// counts only where the key's set is the query's, mask[set / H, key % L]
// holds and, under causal, key <= query (the same set: key % L <= query %
// L); a query with no valid key carries the lse filler and gets dQ = 0, P
// being zeroed explicitly, never the exponential of a masked score. Per
// block:
// - Q, dO, K and V of its rows as bf16 by cp.async (float32 rounded to bf16
//   on the way in, synchronously), lse and delta by 4-byte cp.async, and
//   each key's set (-1 for a masked key or one past the block), with one
//   commit and one wait: one memory round trip.
// - Each warp owns 16 queries and computes S = Q K^T and dP = dO V^T on
//   the 8-key tiles that hold keys of its queries' sets; P and dS stay in
//   registers as the A fragments of dQ += dS K, K the B operand by
//   ldmatrix.trans. A 16-key step outside the warp's sets is skipped.
// - bf16 dQ scale goes through the warp's own Q rows (only this warp read
//   them, so no block barrier) to 16-byte row stores; float32 keeps the
//   fragments' 8-byte stores.
// The function is _flash_bwd_dq_kernel's: delta = rowsum(dO o) comes from
// the caller (ops/flash.py), dS is rounded to bf16 for its product, every
// output element is summed by one thread in key order, no atomics. Bound
// on an H100: at [256, 4, 20, 32] bf16 it reads q, k, v, dO, lse and delta
// and writes dQ, 6.7 MB (2.0 us at 3.35 TB/s), against ~0.08 GFLOP: bound
// by bytes, so every load of a block is in flight at once and each byte is
// staged once. flash_bwd_dq_kernel keeps L in (SETS_MAX_L, SM90_MIN_L] and
// float32 above it.

template <typename T, int D>
__global__ void __launch_bounds__(BwdSets<D>::THREADS)
flash_bwd_dq_sets_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, T* __restrict__ dq, int H, int L,
                         int N, int block_rows, int causal, float scale_log2, float scale) {
  using C = BwdSets<D>;
  constexpr int LDS = C::LDS;
  constexpr int ROWS = C::ROWS;
  constexpr int KK = D / 16;               // depth steps
  constexpr int NT = ROWS / 8;             // 8-key tiles of S
  constexpr int OCH = D * sizeof(T) / 16;  // 16-byte chunks of an output row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + ROWS * LDS;
  __nv_bfloat16* sK = sdO + ROWS * LDS;
  __nv_bfloat16* sV = sK + ROWS * LDS;
  float* sLse = reinterpret_cast<float*>(sV + ROWS * LDS);
  float* sDelta = sLse + ROWS;
  int* sKeySet = reinterpret_cast<int*>(sDelta + ROWS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  // the block's queries, and keys: whole sets r0 .. r_end - 1
  const int r0 = blockIdx.x * block_rows;
  const int r_end = min(N, r0 + block_rows);
  // the warp's queries, and the keys of their sets (none past its last
  // query under causal)
  const int w0 = r0 + warp * 16;
  const int w_last = min(w0 + 15, r_end - 1);
  const int wk_begin = w0 < r_end ? (w0 / L) * L : 0;
  const int wk_end = w0 >= r_end ? 0 : causal ? w_last + 1 : min(r_end, (w_last / L + 1) * L);
  const int row_lo = w0 + g;
  const int row_hi = row_lo + 8;
  const int set_lo = row_lo < r_end ? row_lo / L : -2;  // a query past the block matches no key
  const int set_hi = row_hi < r_end ? row_hi / L : -2;

  stage_rows_async<T, C::THREADS, LDS>(q, r0, ROWS, r_end, D, sQ, tid);
  stage_rows_async<T, C::THREADS, LDS>(dout, r0, ROWS, r_end, D, sdO, tid);
  stage_rows_async<T, C::THREADS, LDS>(k, r0, ROWS, r_end, D, sK, tid);
  stage_rows_async<T, C::THREADS, LDS>(v, r0, ROWS, r_end, D, sV, tid);
  for (int i = tid; i < ROWS; i += C::THREADS) {
    const int row = r0 + i;
    const bool in = row < r_end;
    cp_async4(sLse + i, lse + (in ? row : 0), in);
    cp_async4(sDelta + i, delta + (in ? row : 0), in);
    const int set = row / L;
    sKeySet[i] = in && (mask == nullptr || mask[static_cast<size_t>(set / H) * L + row - set * L] != 0)
                     ? set
                     : -1;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // Q, dO, K, V, lse, delta and the key sets arrived

  // S = Q K^T and dP = dO V^T over the 8-key tiles that hold a key of the
  // warp's sets; the others stay 0
  bool meet[NT];
  float s[NT][4];
  float dp[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int first_key = r0 + nt * 8;
    meet[nt] = first_key < wk_end && first_key + 8 > wk_begin;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  }
  // A: the warp's Q and dO rows 8 (tile & 1).., columns 8 (tile >> 1).. of
  // a depth step
  const int a_at = (warp * 16 + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t qa[4], da[4];
    ldsm_x4(qa, sQ + a_at + kk * 16);
    ldsm_x4(da, sdO + a_at + kk * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (!meet[nt]) continue;
      // B: K and V rows nt * 8.., columns 8 (tile & 1).. of the step
      const int b_at = (nt * 8 + lrow) * LDS + kk * 16 + (ltile & 1) * 8;
      uint32_t kb[2], vb[2];
      ldsm_x2(kb, sK + b_at);
      ldsm_x2(vb, sV + b_at);
      mma_bf16(s[nt], qa, kb[0], kb[1]);
      mma_bf16(dp[nt], da, vb[0], vb[1]);
    }
  }

  // dS in place of S; rows are queries, columns keys
  const int lo = warp * 16 + g;  // the rows lo and lo + 8 of the block
  const float lse2[2] = {sLse[lo] * LOG2E, sLse[lo + 8] * LOG2E};
  const float dlt[2] = {sDelta[lo], sDelta[lo + 8]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!meet[nt]) continue;
    const int2 kset = *reinterpret_cast<const int2*>(sKeySet + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = r0 + nt * 8 + 2 * t + (e & 1);
      const int r = e >> 1;
      const bool ok = ((e & 1) ? kset.y : kset.x) == (r ? set_hi : set_lo) &&
                      (!causal || key <= (r ? row_hi : row_lo));
      const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
      s[nt][e] = p * (dp[nt][e] - dlt[r]);
    }
  }

  // dQ = dS K over the 16-key steps that meet the warp's sets, the keys as
  // the k dimension
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    if (!meet[2 * ks] && !meet[2 * ks + 1]) continue;
    uint32_t dsa[4];
    c_to_a(s[2 * ks], s[2 * ks + 1], dsa);
    // B of two 8-column tiles at once: K rows ks * 16 + 8 (tile & 1)..,
    // columns 8 (tile >> 1).., transposed
    const int b_at = (ks * 16 + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, sK + b_at + dn * 8);
      mma_bf16(acc[dn], dsa, b[0], b[1]);
      mma_bf16(acc[dn + 1], dsa, b[2], b[3]);
    }
  }

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // the warp's own Q rows (only this warp read them) take its dQ, which
    // leaves in 16-byte row stores
    __nv_bfloat16* dq_rows = sQ + warp * 16 * LDS;
    __syncwarp();
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      store2(dq_rows + g * LDS + col, acc[dn][0] * scale, acc[dn][1] * scale);
      store2(dq_rows + (g + 8) * LDS + col, acc[dn][2] * scale, acc[dn][3] * scale);
    }
    __syncwarp();
    for (int i = lane; i < 16 * OCH; i += 32) {
      const int r = i / OCH;
      const int c = i - r * OCH;
      if (w0 + r < r_end) {
        reinterpret_cast<uint4*>(dq + static_cast<size_t>(w0 + r) * D)[c] =
            reinterpret_cast<const uint4*>(dq_rows + r * LDS)[c];
      }
    }
  } else {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (row_lo < r_end) {
        store2(dq + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * scale, acc[dn][1] * scale);
      }
      if (row_hi < r_end) {
        store2(dq + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * scale, acc[dn][3] * scale);
      }
    }
  }
}

// the packed-sets kernel of dK/dV or of dQ: a block of 32 / L whole sets
template <typename T, int D, bool DKV>
cudaError_t launch_sets(const Args& a, cudaStream_t stream) {
  using C = BwdSets<D>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.L;
  // flattened key and query indices, and a block past the last, stay in int
  if (rows > 0x7fffffffLL - 2 * C::ROWS) return cudaErrorInvalidValue;
  const int n = static_cast<int>(rows);
  const int block_rows = C::ROWS / a.L * a.L;  // whole sets
  const unsigned blocks = static_cast<unsigned>((n + block_rows - 1) / block_rows);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if constexpr (DKV) {
    flash_bwd_dkv_sets_kernel<T, D><<<blocks, C::THREADS, C::SMEM, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), static_cast<T*>(a.d1), a.H,
        a.L, n, block_rows, a.causal, LOG2E * a.scale, a.scale);
  } else {
    flash_bwd_dq_sets_kernel<T, D><<<blocks, C::THREADS, C::SMEM, stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.d0), a.H, a.L, n, block_rows,
        a.causal, LOG2E * a.scale, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

// The entries, declared with their layouts in flash_entries.h, each in
// the part of the build that compiles it (DFLY_IN_PART there).
#if DFLY_IN_PART(0)
extern "C" int dfly_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* mask, void* dk,
                                  void* dv, int B, int H, int L, int D, int causal, int dtype,
                                  int warps, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dk, dv, B, H, L, causal, scale};
  return by_dtype<true>(a, D, dtype, warps, stream);
}
#endif

#if DFLY_IN_PART(1)
extern "C" int dfly_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* mask, void* dq,
                                 int B, int H, int L, int D, int causal, int dtype, int warps,
                                 float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dq, nullptr, B, H, L, causal, scale};
  return by_dtype<false>(a, D, dtype, warps, stream);
}
#endif

#if DFLY_IN_PART(2)
extern "C" int dfly_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* mask, void* dk, void* dv, int B, int H, int L,
                                       int D, int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dk, dv, B, H, L, causal, scale};
  return wide_by_dtype<true>(a, D, dtype, stream);
}
#endif

#if DFLY_IN_PART(3)
extern "C" int dfly_flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* mask, void* dq, int B, int H, int L, int D,
                                      int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const uint8_t*>(mask), dq, nullptr, B, H, L, causal, scale};
  return wide_by_dtype<false>(a, D, dtype, stream);
}
#endif

#if DFLY_IN_PART(0)
extern "C" const char* dfly_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
