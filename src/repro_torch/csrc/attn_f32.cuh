// The f32 FMA path of flash_attention.cu and attn_colmax.cu: 64 x 64 tiles,
// 256 threads, each owning rows ty + 16 i and columns tx + 16 j (i, j < 4)
// of the score tile in registers.  Both kernels compute
//
//   s[i, j] = (q_i . k_j) * scale     (f32 FMA over DH, then one f32
//                                       multiply; q is never rounded scaled)
//
// through scores_f32 and __fmul_rn, so colmax's exp(s - lse) is taken on the
// score whose logsumexp flash wrote.
#pragma once

#include "attn_tile.cuh"

namespace attn_f32 {

using attn::NEG_INF;

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile

// Query row `qrow` sees key `kcol` (offset diagonal: key j <= i + skv - sq).
__device__ __forceinline__ bool visible(int qrow, int kcol, int skv, int off,
                                        int causal) {
  return kcol < skv && (!causal || kcol <= qrow + off);
}

// f32 rows are odd to spread banks.
template <int DH> struct Dims {
  static constexpr int FLD = DH + 1;
};

template <int DH>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int rows, int valid, int ld) {
  for (int v = threadIdx.x; v < rows * DH; v += blockDim.x) {
    const int row = v / DH, c = v % DH;
    dst[row * ld + c] = row < valid ? src[(long long)row * DH + c] : 0.0f;
  }
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

}  // namespace attn_f32
