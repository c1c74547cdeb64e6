// Tile loads and score tiles shared by flash_attention.cu and
// attn_colmax.cu, so that both kernels compute each score the same way:
//
//   s[i, j] = (q_i . k_j) * scale      (product summed in f32, then scaled
//                                        in f32; q is never rounded scaled)
//
// bf16: S = Q K^T on the tensor cores (WMMA 16x16x16, f32 accumulate), one
// warp per 16 query rows, written to shared memory as f32.  f32: FMA, each
// of 256 threads owning rows ty + 16 i and columns tx + 16 j (i, j < 4) of
// the 64 x 64 tile, held in registers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace attn {

using namespace nvcuda;

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int SLD = BK + 4;      // f32 score tile leading dim
constexpr float NEG_INF = -1e30f;

// Padded leading dims: bf16 rows stay 32-byte aligned for WMMA (DH + 8 is
// a multiple of 8 elements), f32 rows are odd to spread banks.
template <int DH> struct Dims {
  static constexpr int LD = DH + 8;    // bf16 Q/K/V tiles
  static constexpr int FLD = DH + 1;   // f32 Q/K tiles
};

// rows x DH bf16 from src (row stride DH) into dst (row stride LD); rows
// at or past `valid` are zero.  Needs 16-byte aligned src rows.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int rows, int valid) {
  constexpr int V = DH / 8;
  for (int v = threadIdx.x; v < rows * V; v += blockDim.x) {
    const int row = v / V, c8 = (v % V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * DH + c8);
    *reinterpret_cast<uint4*>(dst + row * Dims<DH>::LD + c8) = val;
  }
}

template <int DH>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int rows, int valid, int ld) {
  for (int v = threadIdx.x; v < rows * DH; v += blockDim.x) {
    const int row = v / DH, c = v % DH;
    dst[row * ld + c] = row < valid ? src[(long long)row * DH + c] : 0.0f;
  }
}

// Unscaled S = Q K^T for this warp's 16 query rows against the 64 keys of
// the tile, stored f32 at ss[(warp*16 + i) * SLD + j].
template <int DH>
__device__ __forceinline__ void scores_bf16_warp(const __nv_bfloat16* qs,
                                                 const __nv_bfloat16* ks,
                                                 float* ss, int warp) {
  constexpr int LD = Dims<DH>::LD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + warp * 16 * LD + kk, LD);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // K^T as a column-major B operand: element (dim, key) at ks[key*LD+dim]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + j * 16 * LD + kk, LD);
      wmma::mma_sync(sf[j], a, b, sf[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(ss + warp * 16 * SLD + j * 16, sf[j], SLD,
                            wmma::mem_row_major);
}

// Unscaled s[i][j] = Q[ty + 16 i] . K[tx + 16 j] in f32 (FMA over DH).
template <int DH>
__device__ __forceinline__ void scores_f32(const float* qs, const float* ks,
                                           int ty, int tx, float s[4][4]) {
  constexpr int LD = Dims<DH>::FLD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int kk = 0; kk < DH; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Query row `qrow` sees key `kcol` (offset diagonal: key j <= i + skv - sq).
__device__ __forceinline__ bool visible(int qrow, int kcol, int skv, int off,
                                        int causal) {
  return kcol < skv && (!causal || kcol <= qrow + off);
}

}  // namespace attn
