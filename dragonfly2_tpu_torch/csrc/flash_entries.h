// The flash kernels' C entries: one declaration of each, included by the
// five sources that define them (so a definition that drifts from its
// declaration fails that source's compile) and by flash_launch.cpp, the
// host launcher that calls them.
//
// Layouts, for every entry: q, k, v, dout and the [B, H, L, D] outputs are
// contiguous; lse, delta, row_max and row_sum contiguous [B, H, L] float32;
// acc contiguous [B, H, L, D] float32 (q of either dtype); mask contiguous
// [B, L] bytes (0 = invalid key) or null. `dtype`: 0 = bf16, 1 = float32.
// `warps`: 1, 2 or 4 (16 query rows, or in dK/dV 16 keys, each). `scale`:
// the softmax scale, 1/sqrt(D) of the head dim the caller means
// (ops/flash.py zero-pads a head dim outside the instances and passes its
// own). Every entry launches on `stream` (a cudaStream_t) without
// synchronising and returns 0, the cudaError_t of the launch, or, for the
// Hopper entries (*_sm90), DFLY_TMAP_ERROR + the CUresult of a TMA
// descriptor that cuTensorMapEncodeTiled refused.
#pragma once

// A source whose entries sit under DFLY_IN_PART(i) is compiled in parts,
// all at once (ops/build.py): part i with -DDFLY_PART=i holds those entries
// and the kernels they instantiate, and the parts' objects link into the
// source's one library. Compiled whole (no DFLY_PART), it holds them all.
#ifdef DFLY_PART
#define DFLY_IN_PART(i) (DFLY_PART == (i))
#else
#define DFLY_IN_PART(i) 1
#endif

// the Hopper entries' code for a refused TMA descriptor, less its CUresult
#define DFLY_TMAP_ERROR 10000

extern "C" {

// csrc/flash_fwd.cu: the mma.sync instances at D = 16, 32, 64, 128.
// Finished output o (serving, eval).
int dfly_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
                   int H, int L, int D, int causal, int dtype, int warps, float scale,
                   void* stream);
// As dfly_flash_fwd, and lse, written for every row (training forward).
int dfly_flash_fwd_lse(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int B, int H, int L, int D, int causal, int dtype, int warps,
                       float scale, void* stream);
// The partial mode, never causal: acc, row_max and row_sum written for
// every row (ring attention's blocks).
int dfly_flash_fwd_partial(const void* q, const void* k, const void* v, const void* mask,
                           void* acc, void* row_max, void* row_sum, int B, int H, int L, int D,
                           int dtype, int warps, float scale, void* stream);
// The wide instances, any D % 8 == 0, taken above 128 (one pass over the
// key tiles for D in (256, 512], chunks of 256 columns above): arguments
// as above without `warps`.
int dfly_flash_fwd_wide(const void* q, const void* k, const void* v, const void* mask, void* o,
                        int B, int H, int L, int D, int causal, int dtype, float scale,
                        void* stream);
int dfly_flash_fwd_lse_wide(const void* q, const void* k, const void* v, const void* mask,
                            void* o, void* lse, int B, int H, int L, int D, int causal, int dtype,
                            float scale, void* stream);
int dfly_flash_fwd_partial_wide(const void* q, const void* k, const void* v, const void* mask,
                                void* acc, void* row_max, void* row_sum, int B, int H, int L,
                                int D, int dtype, float scale, void* stream);

// csrc/flash_bwd.cu: dK/dV and dQ from lse and delta = rowsum(dO * o);
// the mma.sync instances at D = 16, 32, 64, 128, then the wide ones.
int dfly_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* mask, void* dk, void* dv,
                       int B, int H, int L, int D, int causal, int dtype, int warps, float scale,
                       void* stream);
int dfly_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq, int B, int H,
                      int L, int D, int causal, int dtype, int warps, float scale, void* stream);
int dfly_flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* mask, void* dk,
                            void* dv, int B, int H, int L, int D, int causal, int dtype,
                            float scale, void* stream);
int dfly_flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* mask, void* dq, int B,
                           int H, int L, int D, int causal, int dtype, float scale, void* stream);

// csrc/flash_fwd_sm90.cu: the Hopper (TMA + wgmma) forward, bf16 only,
// 16-byte aligned rows, at D = 16, 32, 64, 128 and, *_wide_sm90, D in
// (128, 256] with D % 8 == 0.
int dfly_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* mask, void* o,
                        int B, int H, int L, int D, int causal, float scale, void* stream);
int dfly_flash_fwd_lse_sm90(const void* q, const void* k, const void* v, const void* mask,
                            void* o, void* lse, int B, int H, int L, int D, int causal,
                            float scale, void* stream);
int dfly_flash_fwd_partial_sm90(const void* q, const void* k, const void* v, const void* mask,
                                void* acc, void* row_max, void* row_sum, int B, int H, int L,
                                int D, float scale, void* stream);
int dfly_flash_fwd_wide_sm90(const void* q, const void* k, const void* v, const void* mask,
                             void* o, int B, int H, int L, int D, int causal, float scale,
                             void* stream);
int dfly_flash_fwd_lse_wide_sm90(const void* q, const void* k, const void* v, const void* mask,
                                 void* o, void* lse, int B, int H, int L, int D, int causal,
                                 float scale, void* stream);
int dfly_flash_fwd_partial_wide_sm90(const void* q, const void* k, const void* v,
                                     const void* mask, void* acc, void* row_max, void* row_sum,
                                     int B, int H, int L, int D, float scale, void* stream);

// csrc/flash_bwd_dkv_sm90.cu and csrc/flash_bwd_dq_sm90.cu: the Hopper
// backward, bf16 only, 16-byte aligned rows, at the same head dims (the
// wide dQ at a compile-time width of 192 for D up to 192, else 256).
int dfly_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* mask, void* dk,
                            void* dv, int B, int H, int L, int D, int causal, float scale,
                            void* stream);
int dfly_flash_bwd_dkv_wide_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* mask, void* dk,
                                 void* dv, int B, int H, int L, int D, int causal, float scale,
                                 void* stream);
int dfly_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* mask, void* dq, int B,
                           int H, int L, int D, int causal, float scale, void* stream);
int dfly_flash_bwd_dq_wide_sm90(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* mask, void* dq,
                                int B, int H, int L, int D, int causal, float scale, void* stream);

// The message of an entry's non-zero return; every source defines it.
const char* dfly_cuda_error_string(int err);

}  // extern "C"
