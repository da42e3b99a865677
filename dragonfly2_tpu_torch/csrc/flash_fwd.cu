// Flash-attention forward for Hopper (sm_90a) in three output modes.
//
// Replaces the TPU kernel dragonfly2_tpu/ops/flash.py::_flash_kernel
// (launched by _flash_forward's pallas_call, flash.py:340) in all three of
// its modes: o = softmax(q k^T / sqrt(D)) v over [B, H, L, D], a [B, L]
// key-validity mask, optional causal masking, online softmax in base 2 with
// float32 statistics and accumulators. Masked keys contribute nothing and
// rows with no valid key come out 0.
// - dfly_flash_fwd: finished output (serving, eval).
// - dfly_flash_fwd_lse: its save_lse mode (flash.py:186-197, training):
//   also lse [B, H, L] f32 = m ln2 + log(max(l, 1e-30)) in natural units,
//   from the base-2 running max m and the row sum l; a row with no valid
//   key keeps m = -1e30, l = 0 and gets that finite filler.
// - dfly_flash_fwd_partial: its partial mode (flash.py:93-94,177-184, ring
//   attention's per-block attend): no normalisation; acc [B, H, L, D] f32 =
//   the running unnormalised P V, row_max [B, H, L] f32 = m ln2 (natural
//   units, so the ring merges with exp), row_sum [B, H, L] f32 = l. A row
//   with no valid key leaves with row_max = -1e30 ln2, row_sum = 0 and
//   acc = 0: finite, so the ring's exp(row_max - new_max) never meets
//   -inf - -inf. No causal variant, as in the reference.
// The mode is a template parameter, so the finished-output instances carry
// no branch. Head dims: 16, 32, 64, 128, and in the wide instance (end of
// file) any D with D % 8 == 0, taken above 128: its packed-sets kernel for
// D up to 256 at L up to 32, its one-pass kernel for D in (256, 512], its
// chunked kernel at the others. At the head dims 16-128 the C side sends L
// up to SETS_MAX_L = 32 (the ranker's sets: served, trained and the ring's
// eval shard) to flash_fwd_sets_kernel (end of file), whose blocks hold
// whole consecutive sets of the flattened [B H L, D] rows and stage each
// byte once in one memory round trip; flash_fwd_kernel below takes longer
// L, and float32 above SM90_MIN_L.
//
// What bounds it on an H100: at the served shape, [1024, 4, 15, 32] bf16,
// q, k, v and o are 3.9 MB each, 15.7 MB together, which the card moves in
// ~4.7 us at 3.35 TB/s, while the products are 0.12 GFLOP, ~0.12 us at the
// 989 TFLOP/s bf16 tensor-core peak: memory- and launch-bound. At long L
// the products dominate (4 * B * H * L^2 * D operations). The lse mode
// adds 4 bytes a row: at the trained shape, [256, 4, 20, 32] bf16, it
// moves 5.3 MB (~1.6 us) for at most 0.05 GFLOP, bound by bytes. The
// partial mode writes acc in float32, twice o's bytes in bf16, plus 8
// bytes a row: at the ring's eval shard, [2000, 4, 10, 32] bf16, 26.3 MB
// (~7.8 us), bound by bytes; at a ring block of [2, 4, 4096, 32] the
// products (~17.2 GFLOP, ~17.4 us) bound it.
//
// Design (not the TPU's block-by-block schedule; its _pick_blocks tiling
// does not carry over):
// - One block per (16*WARPS query rows, head, batch). Each warp owns 16
//   query rows; WARPS (1, 2 or 4) is picked by the wrapper from L so a short
//   set (L = 15) does not launch idle warps.
// - K/V tiles of 64 keys are staged in shared memory as bf16 (a float32
//   input is rounded there, as a TPU matmul of default precision does) and
//   shared by the block's warps. Rows past L are zero-filled, so L needs no
//   padding in the wrapper; the key-validity flags of the tile sit beside
//   them in shared memory.
// - Q K^T and P V run on the tensor cores through mma.sync m16n8k16 (bf16
//   in, float32 accumulate). The S fragment is rescaled, masked and
//   exponentiated in registers and fed back as the A operand of P V, so the
//   [L, L] score matrix never leaves registers.
// - Row max/sum live per thread (two rows each); max is reduced across the
//   four threads of a row with shuffles, the sum only once at the end.
// - The output type follows the mode: q's type for the finished and lse
//   modes, float32 for the partial mode's acc (8-byte float2 stores where
//   the bf16 output stores 4 bytes).
// wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_entries.h"

namespace {

constexpr int BLOCK_N = 64;  // keys per staged K/V tile
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// output modes of the kernel
constexpr int MODE_OUT = 0;      // finished output
constexpr int MODE_LSE = 1;      // finished output and lse
constexpr int MODE_PARTIAL = 2;  // unnormalised acc (float32), row max, row sum

template <typename T, int MODE>
using out_t = std::conditional_t<MODE == MODE_PARTIAL, float, T>;

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

// stat0: lse (MODE_LSE) or row max (MODE_PARTIAL); stat1: row sum
// (MODE_PARTIAL); both unused otherwise
template <typename T, int D, int WARPS, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, out_t<T, MODE>* __restrict__ o,
                 float* __restrict__ stat0, float* __restrict__ stat1,
                 int H, int L, int num_qblocks, int causal, float scale_log2) {
  constexpr int BM = 16 * WARPS;      // query rows per block
  constexpr int THREADS = WARPS * 32;
  constexpr int LDS = D + 8;          // shared row stride (bf16): conflict-free fragment loads
  constexpr int CHUNKS = D / 8;       // 16-byte chunks per bf16 row
  constexpr int NT = BLOCK_N / 8;     // 8-key score tiles per K/V tile
  static_assert(BM <= BLOCK_N, "Q is staged through the K tile buffer");
  static_assert(NT * 4 == 32, "one validity bit per score element");

  __shared__ __align__(16) __nv_bfloat16 sK[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BLOCK_N * LDS];
  __shared__ float sValid[BLOCK_N];

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  out_t<T, MODE>* oh = o + head;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad
  const int q0 = qb * BM;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;

  // ---- Q: stage the block's rows through sK, keep them as A fragments
  for (int i = tid; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = q0 + r;
    if (row < L) {
      load8(qh + static_cast<size_t>(row) * D + c, sK + r * LDS + c);
    } else {
      zero8(sK + r * LDS + c);
    }
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sK + (warp * 16 + g) * LDS + kk * 16 + 2 * t;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * LDS);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * LDS + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m_row[2] = {NEG_BIG, NEG_BIG};  // running max (log2 domain) of rows lo, hi
  float l_row[2] = {0.f, 0.f};          // this thread's share of the running sums

  // causal: keys past the block's last query row are masked for every row
  const int kv_end = causal ? min(L, q0 + BM) : L;
  for (int n0 = 0; n0 < kv_end; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous tile (and with Q)
    for (int i = tid; i < BLOCK_N * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS;
      const int c = (i % CHUNKS) * 8;
      const int key = n0 + r;
      if (key < L) {
        load8(kh + static_cast<size_t>(key) * D + c, sK + r * LDS + c);
        load8(vh + static_cast<size_t>(key) * D + c, sV + r * LDS + c);
      } else {
        zero8(sK + r * LDS + c);
        zero8(sV + r * LDS + c);
      }
    }
    for (int i = tid; i < BLOCK_N; i += THREADS) {
      const int key = n0 + i;
      sValid[i] = (key < L && (mb == nullptr || mb[key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, fragment layout of m16n8 C
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kb = sK + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }

    // scale into the log2 domain, mask, and take the tile's row maxima
    uint32_t valid_bits = 0u;
    float tile_max[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_lo : row_hi;
        const bool ok = sValid[kl] > 0.f && (!causal || n0 + kl <= row);
        const float x = ok ? s[nt][e] * scale_log2 : NEG_BIG;
        s[nt][e] = x;
        valid_bits |= static_cast<uint32_t>(ok) << (nt * 4 + e);
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_row[r], tile_max[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }

    // probabilities; a row with no valid key so far has m = NEG_BIG, where
    // exp2(x - m) would be a bogus 1, so validity gates the exponential
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = ((valid_bits >> (nt * 4 + e)) & 1u) ? exp2f(s[nt][e] - m_row[r]) : 0.f;
        s[nt][e] = p;
        tile_sum[r] += p;
      }
    }
    l_row[0] = l_row[0] * corr[0] + tile_sum[0];
    l_row[1] = l_row[1] * corr[1] + tile_sum[1];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: the S accumulators of two adjacent 8-key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int ks = 0; ks < BLOCK_N / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vb = sV + (ks * 16 + 2 * t) * LDS + dn * 8 + g;
        const uint32_t b0 = pack(vb[0], vb[LDS]);
        const uint32_t b1 = pack(vb[8 * LDS], vb[9 * LDS]);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

  // finish: full row sums across the quad, then the mode's outputs for the
  // valid rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // the partial mode leaves acc unnormalised
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < L) {
      store2(oh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    }
    if (row_hi < L) {
      store2(oh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
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

template <typename T, int D, int WARPS, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   float* stat0, float* stat1, int B, int H, int L, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  const int num_qblocks = (L + BM - 1) / BM;
  const long long blocks = static_cast<long long>(num_qblocks) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale_log2 = LOG2E * scale;
  flash_fwd_kernel<T, D, WARPS, MODE><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<out_t<T, MODE>*>(o), stat0, stat1, H, L,
      num_qblocks, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t by_warps(int warps, const void* q, const void* k, const void* v, const void* mask,
                     void* o, float* stat0, float* stat1, int B, int H, int L, int causal,
                     float scale, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch<T, D, 1, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    case 2: return launch<T, D, 2, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    case 4: return launch<T, D, 4, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the packed-sets kernel of the head-dim instances (below), taken at L up to
// SETS_MAX_L
constexpr int SETS_MAX_L = 32;

template <typename T, int D, int MODE>
cudaError_t launch_narrow_sets(const void* q, const void* k, const void* v, const void* mask,
                               void* o, float* stat0, float* stat1, int B, int H, int L,
                               int causal, float scale, cudaStream_t stream);

template <typename T, int MODE>
cudaError_t by_dim(int D, int warps, const void* q, const void* k, const void* v,
                   const void* mask, void* o, float* stat0, float* stat1, int B, int H, int L,
                   int causal, float scale, cudaStream_t stream) {
  if (L <= SETS_MAX_L) {
    switch (D) {
      case 16: return launch_narrow_sets<T, 16, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
      case 32: return launch_narrow_sets<T, 32, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
      case 64: return launch_narrow_sets<T, 64, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
      case 128: return launch_narrow_sets<T, 128, MODE>(q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return by_warps<T, 16, MODE>(warps, q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    case 32: return by_warps<T, 32, MODE>(warps, q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    case 64: return by_warps<T, 64, MODE>(warps, q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    case 128: return by_warps<T, 128, MODE>(warps, q, k, v, mask, o, stat0, stat1, B, H, L, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
int by_dtype(const void* q, const void* k, const void* v, const void* mask, void* o, void* stat0,
             void* stat1, int B, int H, int L, int D, int causal, int dtype, int warps,
             float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s0 = static_cast<float*>(stat0);
  float* s1 = static_cast<float*>(stat1);
  cudaError_t err;
  if (dtype == 0) {
    err = by_dim<__nv_bfloat16, MODE>(D, warps, q, k, v, mask, o, s0, s1, B, H, L, causal, scale, s);
  } else if (dtype == 1) {
    err = by_dim<float, MODE>(D, warps, q, k, v, mask, o, s0, s1, B, H, L, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}


// ---- the wide instance: head dims above 128, any D with D % 8 == 0
//
// The head dim is a run-time argument. A block stages rows in chunks of
// WIDE_DW = 256 columns, each 16-byte vector of a row that lies below D
// loaded and the shared-memory columns from D up to the chunk's width
// zeroed, so no caller pads D and no column past D is read or written.
// blockIdx.y picks the block's chunk of output columns, c0 = 256
// blockIdx.y; the scores of a key tile sum over every depth chunk of D. For
// D <= 256 there is one chunk and Q stays in shared memory for the block's
// life; at L up to 32 the packed-sets instance below
// (flash_fwd_wide_sets_kernel) takes those D instead. D in (256, 512]
// takes the one-pass instance below
// (flash_fwd_wide_onepass_kernel), which scores each key tile once; above
// 512 this kernel's chunked route stays: each depth chunk of Q and K is
// staged in turn, and each output chunk's block recomputes the scores
// (right, not fast; no main path reaches it).
//
// At D = 256 a warp cannot keep 16 rows of O in float32 registers (128 a
// thread) beside its Q fragments and a score tile, and Q with 32-key K/V
// tiles overflows 48 KB of static shared memory. So the block's 8 warps
// split the work two ways, WIDE_RG row groups of 16 query rows times
// WIDE_CQ column quarters of the chunk, and every tile lives in dynamic
// shared memory (Q 32 rows, K and V 32 keys, each 256 + 8 bf16 a row, and a
// 32 x 32 float score tile: 55 KB). Per 32-key tile:
// 1. warp (rg, cq) computes the scores of its 16 rows against the tile's
//    keys cq*8 .. cq*8 + 7 over the whole depth D, with Q and K fragments
//    read from shared memory as it goes (nothing of Q is held), and writes
//    them, scaled into the log2 domain and masked to -inf, into the score
//    tile;
// 2. after a barrier every warp of row group rg reads the group's 16 x 32
//    scores back in the mma accumulator layout and takes the same online
//    softmax step (the same arithmetic in the same order, so the four
//    copies of a row's max and sum agree bit for bit), then accumulates
//    P V into its own 64 columns of the chunk, 64 float32 registers a
//    thread, skipping 8-column tiles at or past D.
// Numerics as the instances above: bf16 operands, float32 statistics and
// accumulators, P rounded to bf16 for P V. Bound on an H100: at
// [4, 4, 1024, 256] bf16 the products are 17.2 GFLOP (~17.4 us at 989
// TFLOP/s) against 33.6 MB for q, k, v and o (~10.0 us at 3.35 TB/s): bound
// by operations from L ~ 600 up, by bytes below. Simple before fast:
// mma.sync, no pipelining; bf16 at D <= 256 above WIDE_SM90_MIN_L
// (ops/flash.py) takes the Hopper instance (flash_fwd_sm90.cu) instead.

constexpr int WIDE_DW = 256;              // columns of a staged chunk of D
constexpr int WIDE_LDS = WIDE_DW + 8;     // shared row stride (bf16)
constexpr int WIDE_RG = 2;                // row groups of 16 query rows
constexpr int WIDE_CQ = 4;                // column quarters of a chunk
constexpr int WIDE_WARPS = WIDE_RG * WIDE_CQ;
constexpr int WIDE_BM = 16 * WIDE_RG;     // query rows per block
constexpr int WIDE_BN = 8 * WIDE_CQ;      // keys per tile: 8 a warp in step 1
constexpr int WIDE_LDSS = WIDE_BN + 4;    // score tile row stride (floats)

// -inf, a masked score of the wide instance
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr size_t wide_fwd_smem() {
  return static_cast<size_t>(WIDE_BM + 2 * WIDE_BN) * WIDE_LDS * sizeof(__nv_bfloat16) +
         static_cast<size_t>(WIDE_BM * WIDE_LDSS + WIDE_BN) * sizeof(float);
}

// rows r0 .. r0 + rows - 1, columns c0 .. c0 + WIDE_DW - 1 of a contiguous
// [L, D] matrix into shared memory as bf16; rows past L and columns past D
// are 0
template <typename T>
__device__ __forceinline__ void stage_wide(const T* __restrict__ src, int r0, int rows, int L,
                                           int D, int c0, __nv_bfloat16* dst, int tid) {
  constexpr int CHUNKS = WIDE_DW / 8;
  for (int i = tid; i < rows * CHUNKS; i += WIDE_WARPS * 32) {
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

// two blocks an SM (at most 128 registers a thread): one leaves the SM
// waiting on the barriers and the loads of its single tile
template <typename T, int MODE>
__global__ void __launch_bounds__(WIDE_WARPS * 32, 2)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, out_t<T, MODE>* __restrict__ o,
                      float* __restrict__ stat0, float* __restrict__ stat1,
                      int H, int L, int D, int num_qblocks, int causal, float scale_log2) {
  constexpr int LDS = WIDE_LDS;
  constexpr int DC = WIDE_DW / WIDE_CQ;  // columns of O a warp accumulates
  constexpr int NT = WIDE_BN / 8;        // 8-key tiles of the score tile
  static_assert(DC % 8 == 0, "whole 8-column tiles a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + WIDE_BM * LDS;
  __nv_bfloat16* sV = sK + WIDE_BN * LDS;
  float* sS = reinterpret_cast<float*>(sV + WIDE_BN * LDS);
  float* sValid = sS + WIDE_BM * WIDE_LDSS;

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const int c0 = blockIdx.y * WIDE_DW;  // the block's output columns c0 ..
  const size_t head = static_cast<size_t>(bh) * L * D;
  out_t<T, MODE>* oh = o + head;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / WIDE_CQ;
  const int cq = warp % WIDE_CQ;
  const int q0 = qb * WIDE_BM;
  const int row_lo = q0 + rg * 16 + g;
  const int row_hi = row_lo + 8;
  const int col0 = c0 + cq * DC;        // the warp's first output column
  const bool resident = D <= WIDE_DW;  // one depth chunk: Q staged once

  if (resident) stage_wide<T>(q + head, q0, WIDE_BM, L, D, 0, sQ, tid);

  float acc[DC / 8][4];
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m_row[2] = {NEG_BIG, NEG_BIG};
  float l_row[2] = {0.f, 0.f};

  const int kv_end = causal ? min(L, q0 + WIDE_BM) : L;
  for (int n0 = 0; n0 < kv_end; n0 += WIDE_BN) {
    __syncthreads();  // every warp is done with the previous tile and its scores
    stage_wide<T>(v + head, n0, WIDE_BN, L, D, c0, sV, tid);
    for (int i = tid; i < WIDE_BN; i += WIDE_WARPS * 32) {
      const int key = n0 + i;
      sValid[i] = (key < L && (mb == nullptr || mb[key] != 0)) ? 1.f : 0.f;
    }

    // 1. scores of rows rg*16.. against keys cq*8.., the whole depth, one
    // chunk of D at a time
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += WIDE_DW) {
      if (d0 > 0) __syncthreads();  // every warp is done with the previous chunk
      if (!resident) stage_wide<T>(q + head, q0, WIDE_BM, L, D, d0, sQ, tid);
      stage_wide<T>(k + head, n0, WIDE_BN, L, D, d0, sK, tid);
      __syncthreads();
      const int kk_end = (min(D - d0, WIDE_DW) + 15) / 16;  // zero columns past D
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        const __nv_bfloat16* qa = sQ + (rg * 16 + g) * LDS + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LDS), ld32(qa + 8), ld32(qa + 8 * LDS + 8)};
        const __nv_bfloat16* kb = sK + (cq * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(s, a, ld32(kb), ld32(kb + 8));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = cq * 8 + 2 * t + (e & 1);
      const int row = (e < 2) ? row_lo : row_hi;
      const bool ok = sValid[kl] > 0.f && (!causal || n0 + kl <= row);
      // -inf: exp2 of a masked score is 0 even while the row's max is NEG_BIG
      sS[(rg * 16 + g + 8 * (e >> 1)) * WIDE_LDSS + kl] = ok ? s[e] * scale_log2 : neg_inf();
    }
    __syncthreads();

    // 2. the row group's scores in accumulator layout, the online softmax step
    float p[NT][4];
    float tile_max[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sS[(rg * 16 + g + 8 * (e >> 1)) * WIDE_LDSS + nt * 8 + 2 * t + (e & 1)];
        p[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_row[r], tile_max[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2f(p[nt][e] - m_row[e >> 1]);
        p[nt][e] = x;
        tile_sum[e >> 1] += x;
      }
    }
    l_row[0] = l_row[0] * corr[0] + tile_sum[0];
    l_row[1] = l_row[1] * corr[1] + tile_sum[1];
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
#pragma unroll
    for (int ks = 0; ks < WIDE_BN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack(p[2 * ks][0], p[2 * ks][1]);
      pa[1] = pack(p[2 * ks][2], p[2 * ks][3]);
      pa[2] = pack(p[2 * ks + 1][0], p[2 * ks + 1][1]);
      pa[3] = pack(p[2 * ks + 1][2], p[2 * ks + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DC / 8; ++dn) {
        if (col0 + dn * 8 >= D) continue;  // the tile's columns are all past D
        const __nv_bfloat16* vb = sV + (ks * 16 + 2 * t) * LDS + cq * DC + dn * 8 + g;
        const uint32_t b0 = pack(vb[0], vb[LDS]);
        const uint32_t b1 = pack(vb[8 * LDS], vb[9 * LDS]);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
    if (row_lo < L) {
      store2(oh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    }
    if (row_hi < L) {
      store2(oh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
    }
  }
  // every block of a row block and the four column warps hold the same
  // statistics: the first column warp of the first chunk writes
  if constexpr (MODE == MODE_LSE) {
    if (blockIdx.y == 0 && cq == 0 && t == 0) {
      float* lh = stat0 + static_cast<size_t>(bh) * L;
      if (row_lo < L) lh[row_lo] = m_row[0] * LN2 + logf(fmaxf(l_row[0], 1e-30f));
      if (row_hi < L) lh[row_hi] = m_row[1] * LN2 + logf(fmaxf(l_row[1], 1e-30f));
    }
  }
  if constexpr (MODE == MODE_PARTIAL) {
    if (blockIdx.y == 0 && cq == 0 && t == 0) {
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

template <typename T, int MODE>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* mask, void* o,
                        float* stat0, float* stat1, int B, int H, int L, int D, int causal,
                        float scale, cudaStream_t stream) {
  const int num_qblocks = (L + WIDE_BM - 1) / WIDE_BM;
  const long long blocks = static_cast<long long>(num_qblocks) * B * H;
  const int chunks = (D + WIDE_DW - 1) / WIDE_DW;
  if (blocks > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = wide_fwd_smem();
  auto kernel = flash_fwd_wide_kernel<T, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = LOG2E * scale;
  kernel<<<dim3(static_cast<unsigned>(blocks), chunks), WIDE_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<out_t<T, MODE>*>(o), stat0, stat1, H, L, D,
      num_qblocks, causal, scale_log2);
  return cudaGetLastError();
}

// ---- the one-pass wide instance: head dims in (256, ONEPASS_MAX_DIM]
//
// flash_fwd_wide_kernel above 256 split D into 256-column output chunks
// along blockIdx.y, each chunk's block recomputing every score over the
// whole depth and restaging Q per depth chunk, with three of the second
// chunk's four column warps idle at D = 320. This instance gives one block
// every output column of its 32 query rows: its warps are WIDE_RG row
// groups of 16 rows times CW = ceil(D / 64) column warps of 64 columns (CW =
// 5 at D = 320, 8 at 512; a template parameter, so a warp's O is 32 float32
// registers at every D), and per 32-key tile
// 1. the first eight warps compute the tile's 8 (16-row x 8-key) score
//    tiles over the whole depth, once, Q and K fragments read from shared
//    memory, and write them, scaled into the log2 domain and masked to
//    -inf, into a shared score tile;
// 2. after a barrier every warp of row group rg takes the same online
//    softmax step from the group's scores (the same arithmetic in the same
//    order: the CW copies of a row's max and sum agree bit for bit) and
//    accumulates P V into its own 64 columns, skipping 8-column tiles past
//    D (only at a D that is not a multiple of 64).
// Q is staged once. bf16 rows are staged by cp.async (16 bytes a copy, rows
// past L and the columns from D to the next multiple of 16 zero-filled), and
// the next key tile's K, V and key flags are in flight while the current
// tile computes: two stages of K and V. float32 rows are rounded to bf16 on
// the way in, synchronously. Shared memory: Q, two stages of K and V (32
// rows of CW * 64 + 8 bf16 each) and the score tile: 107 KB at D = 320, two
// blocks an SM (at most 102 registers a thread); 167 KB at D = 512, one.
// Bound on an H100: the hidden-1280 ranker's eval, [4000, 4, 20, 320] bf16,
// moves q, k, v and o, 819 MB (245 us at 3.35 TB/s), for 4.2 GFLOP: bound by
// bytes, so the cp.async staging keeps a block's whole Q, K and V in flight
// at once, and a second block an SM computes while the first loads. At a
// ring block, [2, 4, 1024, 320], the products (10.7 GFLOP, 11 us) bound it.
// Numerics as the chunked instance's: bf16 operands, float32 statistics
// and accumulators, P rounded to bf16 for P V, exp2 in the log2 domain, a
// row with no valid key giving 0 and the same lse filler, every output
// element summed by one thread in key order. Above ONEPASS_MAX_DIM, where O
// would need more column warps than a block holds next to its tiles,
// flash_fwd_wide_kernel's chunked route stays (no main path reaches it).

constexpr int ONEPASS_MAX_DIM = 512;
constexpr int ONEPASS_BN = 32;                          // keys per tile
constexpr int ONEPASS_SCORE_WARPS = WIDE_RG * ONEPASS_BN / 8;  // 16 x 8 score tiles of a key tile
constexpr int ONEPASS_LDSS = ONEPASS_BN + 4;           // score tile row stride (floats)

template <int CW>
struct Onepass {
  static constexpr int WARPS = WIDE_RG * CW;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDS = CW * 64 + 8;      // shared row stride (bf16)
  static constexpr int TILE = ONEPASS_BN * LDS;  // one K or V stage
  static constexpr size_t SMEM =
      static_cast<size_t>(WIDE_BM * LDS + 4 * TILE) * sizeof(__nv_bfloat16) +
      static_cast<size_t>(WIDE_BM * ONEPASS_LDSS + 2 * ONEPASS_BN) * sizeof(float);
  // two blocks an SM where their shared memory fits (D up to 320)
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(WARPS >= ONEPASS_SCORE_WARPS, "a warp for every score tile");
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
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
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0, int rows, int L,
                                           int D, __nv_bfloat16* dst, int tid) {
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

// key tile n0's K, V and key flags (key < L and its mask byte) into a stage
template <typename T, int CW>
__device__ __forceinline__ void stage_key_tile(const T* __restrict__ kh, const T* __restrict__ vh,
                                               const uint8_t* __restrict__ mb, int n0, int L,
                                               int D, __nv_bfloat16* sK, __nv_bfloat16* sV,
                                               float* valid, int tid) {
  using C = Onepass<CW>;
  stage_rows<T, C::THREADS, C::LDS>(kh, n0, ONEPASS_BN, L, D, sK, tid);
  stage_rows<T, C::THREADS, C::LDS>(vh, n0, ONEPASS_BN, L, D, sV, tid);
  for (int i = tid; i < ONEPASS_BN; i += C::THREADS) {
    const int key = n0 + i;
    valid[i] = (key < L && (mb == nullptr || mb[key] != 0)) ? 1.f : 0.f;
  }
  cp_async_commit();
}

template <typename T, int MODE, int CW>
__global__ void __launch_bounds__(Onepass<CW>::THREADS, Onepass<CW>::MIN_BLOCKS)
flash_fwd_wide_onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const uint8_t* __restrict__ mask,
                              out_t<T, MODE>* __restrict__ o, float* __restrict__ stat0,
                              float* __restrict__ stat1, int H, int L, int D, int num_qblocks,
                              int causal, float scale_log2) {
  using C = Onepass<CW>;
  constexpr int LDS = C::LDS;
  constexpr int NT = ONEPASS_BN / 8;  // 8-key tiles of the score tile

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + WIDE_BM * LDS;  // stage s at sK + s * TILE
  __nv_bfloat16* sV = sK + 2 * C::TILE;
  float* sS = reinterpret_cast<float*>(sV + 2 * C::TILE);
  float* sValid = sS + WIDE_BM * ONEPASS_LDSS;  // stage s at sValid + s * ONEPASS_BN

  const int qb = blockIdx.x % num_qblocks;
  const int bh = blockIdx.x / num_qblocks;
  const int b = bh / H;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const T* kh = k + head;
  const T* vh = v + head;
  out_t<T, MODE>* oh = o + head;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * L : nullptr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / CW;  // step 2: the warp's row group and its 64 columns
  const int cw = warp % CW;
  const int q0 = qb * WIDE_BM;
  const int row_lo = q0 + rg * 16 + g;
  const int row_hi = row_lo + 8;
  const int col0 = cw * 64;
  const int kk_end = (D + 15) / 16;  // depth steps; the columns from D on are 0
  const int kv_end = causal ? min(L, q0 + WIDE_BM) : L;
  const int n_tiles = (kv_end + ONEPASS_BN - 1) / ONEPASS_BN;

  stage_rows<T, C::THREADS, LDS>(q + head, q0, WIDE_BM, L, D, sQ, tid);
  stage_key_tile<T, CW>(kh, vh, mb, 0, L, D, sK, sV, sValid, tid);  // commits Q with it

  float acc[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m_row[2] = {NEG_BIG, NEG_BIG};
  float l_row[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int n0 = j * ONEPASS_BN;
    cp_async_wait_all();
    __syncthreads();  // tile j (and Q) arrived; every warp is done with tile j-1
    if (j + 1 < n_tiles) {  // the next tile into the other stage, in flight meanwhile
      stage_key_tile<T, CW>(kh, vh, mb, n0 + ONEPASS_BN, L, D, sK + (st ^ 1) * C::TILE,
                            sV + (st ^ 1) * C::TILE, sValid + (st ^ 1) * ONEPASS_BN, tid);
    }
    const __nv_bfloat16* kt = sK + st * C::TILE;
    const __nv_bfloat16* vt = sV + st * C::TILE;
    const float* valid = sValid + st * ONEPASS_BN;

    // 1. the tile's scores, once: warp w < 8 takes rows 16 (w / 4).. against
    // keys 8 (w % 4).. over the whole depth
    if (warp < ONEPASS_SCORE_WARPS) {
      const int srow = (warp >> 2) * 16;
      const int skey = (warp & 3) * 8;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < kk_end; ++kk) {
        const __nv_bfloat16* qa = sQ + (srow + g) * LDS + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LDS), ld32(qa + 8), ld32(qa + 8 * LDS + 8)};
        const __nv_bfloat16* kb = kt + (skey + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(s, a, ld32(kb), ld32(kb + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = skey + 2 * t + (e & 1);
        const int r = srow + g + 8 * (e >> 1);
        const bool ok = valid[kl] > 0.f && (!causal || n0 + kl <= q0 + r);
        // -inf: exp2 of a masked score is 0 even while the row's max is NEG_BIG
        sS[r * ONEPASS_LDSS + kl] = ok ? s[e] * scale_log2 : neg_inf();
      }
    }
    __syncthreads();

    // 2. the row group's scores in accumulator layout, the online softmax step
    float p[NT][4];
    float tile_max[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sS[(rg * 16 + g + 8 * (e >> 1)) * ONEPASS_LDSS + nt * 8 + 2 * t + (e & 1)];
        p[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_row[r], tile_max[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2f(p[nt][e] - m_row[e >> 1]);
        p[nt][e] = x;
        tile_sum[e >> 1] += x;
      }
    }
    l_row[0] = l_row[0] * corr[0] + tile_sum[0];
    l_row[1] = l_row[1] * corr[1] + tile_sum[1];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
#pragma unroll
    for (int ks = 0; ks < ONEPASS_BN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack(p[2 * ks][0], p[2 * ks][1]);
      pa[1] = pack(p[2 * ks][2], p[2 * ks][3]);
      pa[2] = pack(p[2 * ks + 1][0], p[2 * ks + 1][1]);
      pa[3] = pack(p[2 * ks + 1][2], p[2 * ks + 1][3]);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        if (col0 + dn * 8 >= D) continue;  // the tile's columns are all past D
        const __nv_bfloat16* vb = vt + (ks * 16 + 2 * t) * LDS + col0 + dn * 8 + g;
        const uint32_t b0 = pack(vb[0], vb[LDS]);
        const uint32_t b1 = pack(vb[8 * LDS], vb[9 * LDS]);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
    if (row_lo < L) {
      store2(oh + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    }
    if (row_hi < L) {
      store2(oh + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
    }
  }
  // the CW column warps of a row group hold the same statistics: the first writes
  if constexpr (MODE == MODE_LSE) {
    if (cw == 0 && t == 0) {
      float* lh = stat0 + static_cast<size_t>(bh) * L;
      if (row_lo < L) lh[row_lo] = m_row[0] * LN2 + logf(fmaxf(l_row[0], 1e-30f));
      if (row_hi < L) lh[row_hi] = m_row[1] * LN2 + logf(fmaxf(l_row[1], 1e-30f));
    }
  }
  if constexpr (MODE == MODE_PARTIAL) {
    if (cw == 0 && t == 0) {
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

template <typename T, int MODE, int CW>
cudaError_t launch_onepass(const void* q, const void* k, const void* v, const void* mask, void* o,
                           float* stat0, float* stat1, int B, int H, int L, int D, int causal,
                           float scale, cudaStream_t stream) {
  using C = Onepass<CW>;
  const int num_qblocks = (L + WIDE_BM - 1) / WIDE_BM;
  const long long blocks = static_cast<long long>(num_qblocks) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wide_onepass_kernel<T, MODE, CW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<out_t<T, MODE>*>(o), stat0, stat1, H, L, D,
      num_qblocks, causal, LOG2E * scale);
  return cudaGetLastError();
}

// ---- the wide instance for short sets: D in (128, 256], L up to WIDE_SETS_MAX_L
//
// flash_fwd_wide_kernel gives a block 32 query rows of one (b, h) set: at
// the ranker's L = 10 (the ring's eval shard) 22 of them are padding, at
// L = 20 12, and each of the 16,000 blocks at [4000, 4, 10, 192] makes one
// round of synchronous loads, a barrier, the products and a barrier on its
// single key tile: latency, not bandwidth, bounds it. This instance packs
// the sets. q, k and v are contiguous [B, H, L, D], so the rows of
// consecutive (b, h) sets are one contiguous [B H L, D] matrix; a block
// takes 32 consecutive rows of it, whatever sets they belong to (parts of
// up to 5 sets at L = 10), and sweeps the key rows from its first row's
// set's start to its last row's set's end (under causal, to its last row)
// in 64-key tiles. A row's set is row / L and its batch row set / H; a
// score stays finite only where the key's set is the row's, mask[set / H,
// key % L] holds and, under causal, key % L <= row % L. Padding is only the
// rows past B H L in the last block (under 1 / 32 of the grid), and the
// grid at [4000, 4, 10, 192] is 5,000 blocks. Per block:
// - Q and the first key tile's K, V and each key's set (-1 for a masked key
//   or one past the sweep) and position are staged together, by cp.async
//   for bf16 (float32 is rounded to bf16 on the way in, synchronously), with
//   the one-pass instance's staging helpers. A 64-key tile holds every key
//   of a block's sets at L up to 21 (at most 63 of them), so at the
//   ranker's L = 10 and 20 a block makes one round: all its loads in
//   flight at once, one score step, one softmax step, one P V step. Above
//   L = 21 a block may sweep a second tile, staged after the first.
//   Measured on an H100: one 64-key round beat two 32-key tiles in two
//   stages with both in flight from the start by 8-15% at the main path's
//   three shapes (chip_smoke.py --rows); the second stage's shared memory
//   would cost a block an SM.
// - SETS_RG row groups of 16 rows times CW = 3 (D up to 192) or 4 column
//   warps of 64 columns: the 8 SETS_RG (16-row x 8-key) score tiles of a key
//   tile are spread over the warps and computed once over the whole depth,
//   and a score tile whose rows' sets and keys' sets do not meet skips its
//   products (at L = 10 most of them); then every warp of row group rg
//   takes the online softmax step from the group's scores and accumulates
//   P V into its own 64 columns, as the one-pass instance does, skipping a
//   16-key step whose sets the row group's do not meet. Fragments come
//   from shared memory by ldmatrix (.trans for V, two 8-column tiles a
//   load).
// Shared memory: Q (32 rows), K and V (64 rows), CW * 64 + 8 bf16 a row,
// and the score tile: 74 KB at CW = 3 (three blocks an SM), 94 KB at 4
// (two). 64-row blocks (four row groups) measured slower at every main-path
// shape. Bound on an H100: the ring's eval shard, [4000, 4, 10, 192] bf16
// in the partial mode, moves q, k and v (184 MB) and a float32 acc (123
// MB), 0.092 ms at 3.35 TB/s, for 1.0 GFLOP: bound by bytes, so a block
// keeps all of its loads in flight at once, and two or three blocks an SM
// hide each other's barriers. Numerics as the other wide instances': bf16
// operands, float32 statistics and accumulators, P rounded to bf16 for
// P V, exp2 in the log2 domain, a row with no valid key giving 0 and the
// same lse filler, every output element summed by one thread in key order.
// Longer sets keep flash_fwd_wide_kernel (bf16 above WIDE_SM90_MIN_L =
// WIDE_SETS_MAX_L takes the Hopper instance in ops/flash.py; float32 and
// a forced mma.sync route reach the chunked kernel there).

constexpr int WIDE_SETS_MAX_L = 32;
constexpr int SETS_RG = 2;   // row groups of 16 flattened query rows a block
constexpr int SETS_BN = 64;  // keys a tile: every key of a block's sets at L up to 21
constexpr int SETS_LDSS = SETS_BN + 4;  // score tile row stride (floats)

template <int CW>
struct Sets {
  static constexpr int BM = 16 * SETS_RG;  // flattened query rows a block
  static constexpr int WARPS = SETS_RG * CW;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDS = CW * 64 + 8;        // shared row stride (bf16)
  static constexpr int TILE = SETS_BN * LDS;  // K or V of a tile
  static constexpr int SCORE_TILES = SETS_RG * SETS_BN / 8;
  static constexpr size_t SMEM =
      static_cast<size_t>(BM * LDS + 2 * TILE) * sizeof(__nv_bfloat16) +
      static_cast<size_t>(BM * SETS_LDSS) * sizeof(float) +
      static_cast<size_t>(2 * BM + 2 * SETS_BN) * sizeof(int);
  // as many blocks an SM as their shared memory allows, at no fewer than
  // 96 registers a thread
  static constexpr int FIT = static_cast<int>(233472 / (SMEM + 1024));
  static constexpr int BY_REGS = 65536 / (THREADS * 96);
  static constexpr int MIN_BLOCKS = FIT < BY_REGS ? FIT : (BY_REGS > 0 ? BY_REGS : 1);
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// key tile n0's K, V and each key's set and position into shared memory,
// committed; keys at or past key_end, and masked keys, get set -1
template <typename T, int CW>
__device__ __forceinline__ void stage_set_tile(const T* __restrict__ k, const T* __restrict__ v,
                                               const uint8_t* __restrict__ mask, int n0,
                                               int key_end, int H, int L, int D,
                                               __nv_bfloat16* sK, __nv_bfloat16* sV,
                                               int* key_set, int* key_pos, int tid) {
  using C = Sets<CW>;
  stage_rows<T, C::THREADS, C::LDS>(k, n0, SETS_BN, key_end, D, sK, tid);
  stage_rows<T, C::THREADS, C::LDS>(v, n0, SETS_BN, key_end, D, sV, tid);
  for (int i = tid; i < SETS_BN; i += C::THREADS) {
    const int key = n0 + i;
    const int set = key / L;
    const int pos = key - set * L;
    const bool ok = key < key_end &&
                    (mask == nullptr || mask[static_cast<size_t>(set / H) * L + pos] != 0);
    key_set[i] = ok ? set : -1;
    key_pos[i] = pos;
  }
  cp_async_commit();
}

template <typename T, int MODE, int CW>
__global__ void __launch_bounds__(Sets<CW>::THREADS, Sets<CW>::MIN_BLOCKS)
flash_fwd_wide_sets_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const uint8_t* __restrict__ mask,
                           out_t<T, MODE>* __restrict__ o, float* __restrict__ stat0,
                           float* __restrict__ stat1, int H, int L, int D, int N, int causal,
                           float scale_log2) {
  using C = Sets<CW>;
  constexpr int LDS = C::LDS;
  constexpr int NT = SETS_BN / 8;  // 8-key tiles of the score tile

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + C::BM * LDS;
  __nv_bfloat16* sV = sK + C::TILE;
  float* sS = reinterpret_cast<float*>(sV + C::TILE);
  int* sRowSet = reinterpret_cast<int*>(sS + C::BM * SETS_LDSS);
  int* sRowPos = sRowSet + C::BM;
  int* sKeySet = sRowPos + C::BM;
  int* sKeyPos = sKeySet + SETS_BN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp / CW;  // step 2: the warp's row group and its 64 columns
  const int cw = warp % CW;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  const int r0 = blockIdx.x * C::BM;  // the block's first flattened row
  const int r_last = min(r0 + C::BM, N) - 1;
  const int key_begin = (r0 / L) * L;
  const int key_end = causal ? r_last + 1 : min(N, (r_last / L + 1) * L);
  const int n_tiles = (key_end - key_begin + SETS_BN - 1) / SETS_BN;
  const int row_lo = r0 + rg * 16 + g;
  const int row_hi = row_lo + 8;
  const int col0 = cw * 64;
  const int kk_end = (D + 15) / 16;  // depth steps; the columns from D on are 0

  for (int i = tid; i < C::BM; i += C::THREADS) {
    const int row = r0 + i;
    const int set = row / L;
    sRowSet[i] = row < N ? set : -2;  // a row past the last matches no key
    sRowPos[i] = row - set * L;
  }
  stage_rows<T, C::THREADS, LDS>(q, r0, C::BM, N, D, sQ, tid);
  stage_set_tile<T, CW>(k, v, mask, key_begin, key_end, H, L, D, sK, sV, sKeySet, sKeyPos,
                        tid);  // commits Q with it
  // the row group's sets, first and last: a 16-key step of P V that meets
  // neither holds only zeros
  const int rg_row = r0 + rg * 16;
  const int rg_first_set = rg_row / L;
  const int rg_last_set = min(rg_row + 15, N - 1) / L;

  float acc[8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m_row[2] = {NEG_BIG, NEG_BIG};
  float l_row[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = key_begin + j * SETS_BN;
    if (j > 0) {  // a second tile (L above 21 only), once every warp is done with the first
      __syncthreads();
      stage_set_tile<T, CW>(k, v, mask, n0, key_end, H, L, D, sK, sV, sKeySet, sKeyPos, tid);
    }
    cp_async_wait_all();
    __syncthreads();  // tile j (and Q, the row sets) arrived

    // 1. the tile's scores, once: score tile sc is rows 16 (sc / NT).. against
    // keys 8 (sc % NT)..; its products are skipped where no row's set meets
    // a key's set
    for (int sc = warp; sc < C::SCORE_TILES; sc += C::WARPS) {
      const int srow = (sc / NT) * 16;
      const int skey = (sc % NT) * 8;
      const int first_key = n0 + skey;
      const int last_key = min(first_key + 7, key_end - 1);
      const int first_row = r0 + srow;
      const int last_row = min(first_row + 15, N - 1);
      const bool meet = first_key <= last_key && first_key / L <= last_row / L &&
                        last_key / L >= first_row / L;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (meet) {
        // A: Q rows srow + 8 (tile & 1).., columns 8 (tile >> 1).. of the
        // step; B: K rows skey.., columns 8 (tile & 1).. of the step
        const __nv_bfloat16* qa = sQ + (srow + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
        const __nv_bfloat16* kb = sK + (skey + lrow) * LDS + (ltile & 1) * 8;
#pragma unroll 4
        for (int kk = 0; kk < kk_end; ++kk) {
          uint32_t a[4], b[2];
          ldsm_x4(a, qa + kk * 16);
          ldsm_x2(b, kb + kk * 16);
          mma_bf16(s, a, b[0], b[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = skey + 2 * t + (e & 1);
        const int r = srow + g + 8 * (e >> 1);
        const bool ok = sKeySet[kl] == sRowSet[r] && (!causal || sKeyPos[kl] <= sRowPos[r]);
        // -inf: exp2 of a masked score is 0 even while the row's max is NEG_BIG
        sS[r * SETS_LDSS + kl] = ok ? s[e] * scale_log2 : neg_inf();
      }
    }
    __syncthreads();

    // 2. the row group's scores in accumulator layout, the online softmax step
    float p[NT][4];
    float tile_max[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sS[(rg * 16 + g + 8 * (e >> 1)) * SETS_LDSS + nt * 8 + 2 * t + (e & 1)];
        p[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_row[r], tile_max[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2f(p[nt][e] - m_row[e >> 1]);
        p[nt][e] = x;
        tile_sum[e >> 1] += x;
      }
    }
    l_row[0] = l_row[0] * corr[0] + tile_sum[0];
    l_row[1] = l_row[1] * corr[1] + tile_sum[1];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
#pragma unroll
    for (int ks = 0; ks < SETS_BN / 16; ++ks) {
      const int first_key = n0 + ks * 16;
      const int last_key = min(first_key + 15, key_end - 1);
      if (first_key > last_key || first_key / L > rg_last_set || last_key / L < rg_first_set) {
        continue;  // no key of the step is in a set of the row group's
      }
      uint32_t pa[4];
      pa[0] = pack(p[2 * ks][0], p[2 * ks][1]);
      pa[1] = pack(p[2 * ks][2], p[2 * ks][3]);
      pa[2] = pack(p[2 * ks + 1][0], p[2 * ks + 1][1]);
      pa[3] = pack(p[2 * ks + 1][2], p[2 * ks + 1][3]);
      // B of two 8-column tiles at once: V rows ks * 16 + 8 (tile & 1)..,
      // columns 8 (tile >> 1).., transposed
      const __nv_bfloat16* vb = sV + (ks * 16 + lrow + (ltile & 1) * 8) * LDS + col0 +
                                (ltile >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        if (col0 + dn * 8 >= D) break;  // the tiles' columns are all past D
        uint32_t b[4];
        ldsm_x4_trans(b, vb + dn * 8);
        mma_bf16(acc[dn], pa, b[0], b[1]);
        if (col0 + dn * 8 + 8 < D) mma_bf16(acc[dn + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (col0 + dn * 8 >= D) continue;  // D % 8 == 0: a tile is all below D or all past it
    if (row_lo < N) {
      store2(o + static_cast<size_t>(row_lo) * D + col, acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    }
    if (row_hi < N) {
      store2(o + static_cast<size_t>(row_hi) * D + col, acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
    }
  }
  // the CW column warps of a row group hold the same statistics: the first
  // writes, at the flattened row ([B, H, L] is [B H L])
  if constexpr (MODE == MODE_LSE) {
    if (cw == 0 && t == 0) {
      if (row_lo < N) stat0[row_lo] = m_row[0] * LN2 + logf(fmaxf(l_row[0], 1e-30f));
      if (row_hi < N) stat0[row_hi] = m_row[1] * LN2 + logf(fmaxf(l_row[1], 1e-30f));
    }
  }
  if constexpr (MODE == MODE_PARTIAL) {
    if (cw == 0 && t == 0) {
      if (row_lo < N) {
        stat0[row_lo] = m_row[0] * LN2;
        stat1[row_lo] = l_row[0];
      }
      if (row_hi < N) {
        stat0[row_hi] = m_row[1] * LN2;
        stat1[row_hi] = l_row[1];
      }
    }
  }
}

template <typename T, int MODE, int CW>
cudaError_t launch_sets(const void* q, const void* k, const void* v, const void* mask, void* o,
                        float* stat0, float* stat1, int B, int H, int L, int D, int causal,
                        float scale, cudaStream_t stream) {
  using C = Sets<CW>;
  const long long rows = static_cast<long long>(B) * H * L;
  // flattened row and key indices, and a tile past the last, stay in int
  if (rows > 0x7fffffffLL - 2 * SETS_BN) return cudaErrorInvalidValue;
  const int n = static_cast<int>(rows);
  auto kernel = flash_fwd_wide_sets_kernel<T, MODE, CW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((n + C::BM - 1) / C::BM), C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<out_t<T, MODE>*>(o), stat0, stat1, H, L, D,
      n, causal, LOG2E * scale);
  return cudaGetLastError();
}

// the wide instance for one dtype: the packed sets for D up to 256 at L up
// to WIDE_SETS_MAX_L, one pass for D in (256, ONEPASS_MAX_DIM], else the
// chunked kernel (one chunk up to 256)
template <typename T, int MODE>
cudaError_t wide_by_dim(const void* q, const void* k, const void* v, const void* mask, void* o,
                        float* s0, float* s1, int B, int H, int L, int D, int causal, float scale,
                        cudaStream_t s) {
  if (D <= WIDE_DW && L <= WIDE_SETS_MAX_L) {  // column warps of 64 columns: 3 or 4
    return D <= 192 ? launch_sets<T, MODE, 3>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s)
                    : launch_sets<T, MODE, 4>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  }
  if (D <= WIDE_DW || D > ONEPASS_MAX_DIM) {
    return launch_wide<T, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  }
  switch ((D + 63) / 64) {  // column warps of 64 columns
    case 5: return launch_onepass<T, MODE, 5>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    case 6: return launch_onepass<T, MODE, 6>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    case 7: return launch_onepass<T, MODE, 7>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
    default: return launch_onepass<T, MODE, 8>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  }
}

template <int MODE>
int wide_by_dtype(const void* q, const void* k, const void* v, const void* mask, void* o,
                  void* stat0, void* stat1, int B, int H, int L, int D, int causal, int dtype,
                  float scale, void* stream) {
  // rows are read as 16-byte vectors: D % 8 == 0 (ops/flash.py pads others)
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s0 = static_cast<float*>(stat0);
  float* s1 = static_cast<float*>(stat1);
  cudaError_t err;
  if (dtype == 0) {
    err = wide_by_dim<__nv_bfloat16, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  } else if (dtype == 1) {
    err = wide_by_dim<float, MODE>(q, k, v, mask, o, s0, s1, B, H, L, D, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ---- the packed-sets kernel of the head-dim instances: D in 16, 32, 64,
// 128, L up to SETS_MAX_L
//
// flash_fwd_kernel gives a block 16 WARPS query rows of one (b, h) set:
// at the ranker's sets (L = 10, 15, 20) a 2-warp block holds 20 live rows
// of 32, stages a 64-key K/V tile of which 20 rows are live (the rest
// zero-filled, 5/8 of its products on zeros), and makes two memory round
// trips in series (Q, a barrier, K and V, a barrier) before 4-byte stores:
// at [256, 4, 20, 32] its 1,024 blocks of 64 threads sit at 25% of the
// bytes' bound. This kernel packs the sets: q, k and v are contiguous [B,
// H, L, D], so the rows of consecutive (b, h) sets form one [B H L, D]
// matrix, and a block takes the rows of NARROW_ROWS / L whole consecutive
// sets (30 of its 32 rows at L = 10 and 15, 20 at L = 20, 32 at 16 and
// 32): its keys are its own rows, so one 32-key tile holds every key its
// rows see and no key is staged by two blocks. On the card (PERF.md),
// blocks of 32 or 64 consecutive rows whatever their sets staged the keys
// of the sets they cut twice and were slower, and blocks of 64 or 128
// rows of whole sets were slower than these 32: at the ranker's shapes a
// block is bound by its warps' latency, not by its padding rows, and a
// short score tile keeps a warp's chain short. A row's set is row / L and
// its batch row set / H; a score
// stays finite only where the key's set is the row's, mask[set / H, key %
// L] holds and, under causal, key <= row (the same set: key % L <= row %
// L). Per block:
// - Q, K and V of its rows, and each key's set (-1 for a masked key or one
//   past the block), are staged together, bf16 by cp.async (float32
//   rounded to bf16 on the way in, synchronously), with one commit and one
//   wait: one memory round trip.
// - Each warp owns 16 rows and keeps S, P and the softmax statistics in
//   registers, as flash_fwd_kernel does; fragments come from shared memory
//   by ldmatrix (.trans for V). An 8-key score tile, or a 16-key P V step,
//   whose keys lie outside the sets of the warp's rows is skipped (at
//   L = 10 a warp's 16 rows meet at most two of a block's three sets).
// - Outputs go through shared memory (bf16 through the warp's own Q rows,
//   float32 through the K tile after a barrier) and leave as 16-byte row
//   stores; lse, row max and row sum are written once a row.
// Numerics as flash_fwd_kernel's: bf16 operands, float32 statistics and
// accumulators, P rounded to bf16 for P V, exp2 in the log2 domain (a
// masked score is -inf, so its exp2 is 0 while the row's max is still
// NEG_BIG), a row with no valid key giving 0 and the same lse filler, every
// output element summed by one thread in key order, no atomics.
// Bound on an H100: the trained shape, [256, 4, 20, 32] bf16 with lse,
// moves 5.3 MB (1.6 us at 3.35 TB/s) for at most 0.05 GFLOP; the served
// [1024, 4, 15, 32] 15.7 MB (4.7 us); the ring's eval shard in the partial
// mode, [2000, 4, 10, 32], 26.3 MB (7.8 us): bound by bytes, so a block
// keeps every load in flight at once and stages each byte once.
// flash_fwd_kernel keeps L in (SETS_MAX_L, SM90_MIN_L] and float32 above
// it.

constexpr int NARROW_WARPS = 2;                  // 16-row warps a block
constexpr int NARROW_ROWS = 16 * NARROW_WARPS;  // rows, and keys, a block holds at most
static_assert(NARROW_ROWS >= SETS_MAX_L, "a block holds a whole set");

template <int D>
struct NarrowSets {
  static constexpr int THREADS = NARROW_WARPS * 32;
  static constexpr int LDS = D + 8;  // shared row stride (bf16): conflict-free ldmatrix
  static constexpr size_t SMEM =
      static_cast<size_t>(3 * NARROW_ROWS) * LDS * sizeof(__nv_bfloat16) +
      static_cast<size_t>(NARROW_ROWS) * sizeof(int);
  static_assert(SMEM <= 48 * 1024, "within the default dynamic shared memory");
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(NarrowSets<D>::THREADS)
flash_fwd_sets_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, out_t<T, MODE>* __restrict__ o,
                      float* __restrict__ stat0, float* __restrict__ stat1, int H, int L, int N,
                      int block_rows, int causal, float scale_log2) {
  using C = NarrowSets<D>;
  using O = out_t<T, MODE>;
  constexpr int LDS = C::LDS;
  constexpr int KK = D / 16;               // depth steps
  constexpr int NT = NARROW_ROWS / 8;      // 8-key score tiles of the key tile
  constexpr int OS = D + 8;                // row stride of the staged output (elements)
  constexpr int OCH = D * sizeof(O) / 16;  // 16-byte chunks of an output row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + NARROW_ROWS * LDS;
  __nv_bfloat16* sV = sK + NARROW_ROWS * LDS;
  int* sKeySet = reinterpret_cast<int*>(sV + NARROW_ROWS * LDS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;  // ldmatrix: the row this lane addresses in tile lane / 8
  const int ltile = lane >> 3;
  // the block's rows, and keys: whole sets r0 .. r_end - 1
  const int r0 = blockIdx.x * block_rows;
  const int r_end = min(N, r0 + block_rows);
  // the warp's rows, and the keys of their sets (none past the last row
  // under causal)
  const int w0 = r0 + warp * 16;
  const int w_last = min(w0 + 15, r_end - 1);
  const int wk_begin = w0 < r_end ? (w0 / L) * L : 0;
  const int wk_end = w0 >= r_end ? 0 : causal ? w_last + 1 : min(r_end, (w_last / L + 1) * L);
  const int row_lo = w0 + g;
  const int row_hi = row_lo + 8;
  const int set_lo = row_lo < r_end ? row_lo / L : -2;  // a row past the block matches no key
  const int set_hi = row_hi < r_end ? row_hi / L : -2;

  stage_rows<T, C::THREADS, LDS>(q, r0, NARROW_ROWS, r_end, D, sQ, tid);
  stage_rows<T, C::THREADS, LDS>(k, r0, NARROW_ROWS, r_end, D, sK, tid);
  stage_rows<T, C::THREADS, LDS>(v, r0, NARROW_ROWS, r_end, D, sV, tid);
  for (int i = tid; i < NARROW_ROWS; i += C::THREADS) {
    const int key = r0 + i;
    const int set = key / L;
    const bool ok = key < r_end &&
                    (mask == nullptr || mask[static_cast<size_t>(set / H) * L + key - set * L] != 0);
    sKeySet[i] = ok ? set : -1;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // Q, K, V and the key sets arrived

  uint32_t qa[KK][4];  // the warp's Q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    ldsm_x4(qa[kk], sQ + (warp * 16 + lrow + (ltile & 1) * 8) * LDS + kk * 16 + (ltile >> 1) * 8);
  }

  // S = Q K^T over the 8-key tiles that hold a key of the warp's sets; the
  // others stay -inf
  bool meet[NT];
  float s[NT][4];
  float m_row[2] = {NEG_BIG, NEG_BIG};  // the row maxima (log2 domain) of rows lo, hi
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int first_key = r0 + nt * 8;
    meet[nt] = first_key < wk_end && first_key + 8 > wk_begin;
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = neg_inf();
    if (!meet[nt]) continue;
    float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
    // B: K rows nt * 8.., columns 8 (tile).. of two depth steps
    const __nv_bfloat16* kb = sK + (nt * 8 + lrow) * LDS + ltile * 8;
    if constexpr (KK == 1) {
      uint32_t b[2];
      ldsm_x2(b, kb);
      mma_bf16(acc_s, qa[0], b[0], b[1]);
    } else {
#pragma unroll
      for (int kk = 0; kk < KK; kk += 2) {
        uint32_t b[4];
        ldsm_x4(b, kb + kk * 16);
        mma_bf16(acc_s, qa[kk], b[0], b[1]);
        mma_bf16(acc_s, qa[kk + 1], b[2], b[3]);
      }
    }
    const int2 kset = *reinterpret_cast<const int2*>(sKeySet + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = first_key + 2 * t + (e & 1);
      const bool ok = ((e & 1) ? kset.y : kset.x) == (e < 2 ? set_lo : set_hi) &&
                      (!causal || key <= (e < 2 ? row_lo : row_hi));
      if (ok) {
        s[nt][e] = acc_s[e] * scale_log2;
        m_row[e >> 1] = fmaxf(m_row[e >> 1], s[nt][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!meet[nt]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - m_row[e >> 1]);
      s[nt][e] = p;
      l_row[e >> 1] += p;
    }
  }

  // O = P V over the 16-key steps that meet the warp's sets
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < NARROW_ROWS / 16; ++ks) {
    if (!meet[2 * ks] && !meet[2 * ks + 1]) continue;
    uint32_t pa[4];  // a skipped 8-key tile's -inf scores are 0 here
    pa[0] = meet[2 * ks] ? pack(s[2 * ks][0], s[2 * ks][1]) : 0u;
    pa[1] = meet[2 * ks] ? pack(s[2 * ks][2], s[2 * ks][3]) : 0u;
    pa[2] = meet[2 * ks + 1] ? pack(s[2 * ks + 1][0], s[2 * ks + 1][1]) : 0u;
    pa[3] = meet[2 * ks + 1] ? pack(s[2 * ks + 1][2], s[2 * ks + 1][3]) : 0u;
    // B of two 8-column tiles at once: V rows ks * 16 + 8 (tile & 1)..,
    // columns 8 (tile >> 1).., transposed
    const __nv_bfloat16* vb = sV + (ks * 16 + lrow + (ltile & 1) * 8) * LDS + (ltile >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vb + dn * 8);
      mma_bf16(acc[dn], pa, b[0], b[1]);
      mma_bf16(acc[dn + 1], pa, b[2], b[3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float inv_lo = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[0], 1e-9f);
  const float inv_hi = MODE == MODE_PARTIAL ? 1.f : 1.f / fmaxf(l_row[1], 1e-9f);
  // the warp's 16 output rows through shared memory: bf16 through its own Q
  // rows (only this warp read them), float32 through the K tile once every
  // warp is done with it
  O* so;
  if constexpr (sizeof(O) == 2) {
    __syncwarp();
    so = reinterpret_cast<O*>(sQ) + warp * 16 * OS;
  } else {
    __syncthreads();
    so = reinterpret_cast<O*>(sK) + warp * 16 * OS;
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    store2(so + g * OS + col, acc[dn][0] * inv_lo, acc[dn][1] * inv_lo);
    store2(so + (g + 8) * OS + col, acc[dn][2] * inv_hi, acc[dn][3] * inv_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * OCH; i += 32) {
    const int r = i / OCH;
    const int c = i - r * OCH;
    if (w0 + r < r_end) {
      reinterpret_cast<uint4*>(o + static_cast<size_t>(w0 + r) * D)[c] =
          reinterpret_cast<const uint4*>(so + r * OS)[c];
    }
  }
  // m and l are equal across the quad after the reductions: one writer, at
  // the flattened row ([B, H, L] is [B H L])
  if constexpr (MODE == MODE_LSE) {
    if (t == 0) {
      if (row_lo < r_end) stat0[row_lo] = m_row[0] * LN2 + logf(fmaxf(l_row[0], 1e-30f));
      if (row_hi < r_end) stat0[row_hi] = m_row[1] * LN2 + logf(fmaxf(l_row[1], 1e-30f));
    }
  }
  if constexpr (MODE == MODE_PARTIAL) {
    if (t == 0) {
      if (row_lo < r_end) {
        stat0[row_lo] = m_row[0] * LN2;
        stat1[row_lo] = l_row[0];
      }
      if (row_hi < r_end) {
        stat0[row_hi] = m_row[1] * LN2;
        stat1[row_hi] = l_row[1];
      }
    }
  }
}

template <typename T, int D, int MODE>
cudaError_t launch_narrow_sets(const void* q, const void* k, const void* v, const void* mask,
                               void* o, float* stat0, float* stat1, int B, int H, int L,
                               int causal, float scale, cudaStream_t stream) {
  using C = NarrowSets<D>;
  const long long rows = static_cast<long long>(B) * H * L;
  // flattened row and key indices, and a block past the last, stay in int
  if (rows > 0x7fffffffLL - 2 * NARROW_ROWS) return cudaErrorInvalidValue;
  const int n = static_cast<int>(rows);
  const int block_rows = NARROW_ROWS / L * L;  // whole sets
  flash_fwd_sets_kernel<T, D, MODE>
      <<<static_cast<unsigned>((n + block_rows - 1) / block_rows), C::THREADS, C::SMEM, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const uint8_t*>(mask), static_cast<out_t<T, MODE>*>(o), stat0, stat1, H, L,
          n, block_rows, causal, LOG2E * scale);
  return cudaGetLastError();
}

}  // namespace

// The entries, declared with their layouts in flash_entries.h, each in
// the part of the build that compiles it (DFLY_IN_PART there).
#if DFLY_IN_PART(0)
extern "C" int dfly_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* o, int B, int H, int L, int D, int causal, int dtype,
                              int warps, float scale, void* stream) {
  return by_dtype<MODE_OUT>(q, k, v, mask, o, nullptr, nullptr, B, H, L, D, causal, dtype, warps,
                            scale, stream);
}
#endif

#if DFLY_IN_PART(1)
extern "C" int dfly_flash_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                  void* o, void* lse, int B, int H, int L, int D, int causal,
                                  int dtype, int warps, float scale, void* stream) {
  return by_dtype<MODE_LSE>(q, k, v, mask, o, lse, nullptr, B, H, L, D, causal, dtype, warps,
                            scale, stream);
}
#endif

#if DFLY_IN_PART(2)
extern "C" int dfly_flash_fwd_partial(const void* q, const void* k, const void* v,
                                      const void* mask, void* acc, void* row_max, void* row_sum,
                                      int B, int H, int L, int D, int dtype, int warps,
                                      float scale, void* stream) {
  return by_dtype<MODE_PARTIAL>(q, k, v, mask, acc, row_max, row_sum, B, H, L, D, 0, dtype, warps,
                                scale, stream);
}
#endif

#if DFLY_IN_PART(3)
extern "C" int dfly_flash_fwd_wide(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int L, int D, int causal, int dtype,
                                   float scale, void* stream) {
  return wide_by_dtype<MODE_OUT>(q, k, v, mask, o, nullptr, nullptr, B, H, L, D, causal, dtype,
                                 scale, stream);
}
#endif

#if DFLY_IN_PART(4)
extern "C" int dfly_flash_fwd_lse_wide(const void* q, const void* k, const void* v,
                                       const void* mask, void* o, void* lse, int B, int H, int L,
                                       int D, int causal, int dtype, float scale, void* stream) {
  return wide_by_dtype<MODE_LSE>(q, k, v, mask, o, lse, nullptr, B, H, L, D, causal, dtype,
                                 scale, stream);
}
#endif

#if DFLY_IN_PART(5)
extern "C" int dfly_flash_fwd_partial_wide(const void* q, const void* k, const void* v,
                                           const void* mask, void* acc, void* row_max,
                                           void* row_sum, int B, int H, int L, int D, int dtype,
                                           float scale, void* stream) {
  return wide_by_dtype<MODE_PARTIAL>(q, k, v, mask, acc, row_max, row_sum, B, H, L, D, 0, dtype,
                                     scale, stream);
}
#endif

#if DFLY_IN_PART(0)
extern "C" const char* dfly_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
