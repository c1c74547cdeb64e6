// What flash_attention.cu and attn_colmax.cu share beyond the generic
// Hopper machinery of hopper.cuh: the one score function both kernels
// use, and their panelled tiles, wgmma descriptors and tensor maps.
//
// The score contract.  Both kernels take the f32 product acc = q . k from
// wgmma and exponentiate
//
//   exp_score(acc, shift) = exp_shifted(score_log2(acc), shift)
//                         = exp2f(acc * (scale * log2 e) - shift)
//
// (one f32 multiply by the constant log2_scale(scale), one subtraction,
// exp2f): flash with shift = the row's running max m2 (log2 units), in two
// steps since its row max needs the scaled score first; colmax with shift
// = lse * log2 e, lse = (m2 + log2 l) * ln 2 being what flash wrote.
// So colmax's exp(s - lse) is taken on the score whose logsumexp flash
// wrote, scaled by the same f32 constant.  __fmul_rn keeps the compiler
// from fusing the multiply into a neighbouring add in one kernel and not
// the other.  wgmma does not specify its summation order, so flash's S and
// colmax's S^T may differ in the last bits of acc: within the 1e-3
// tolerance of a value in [0, 1].
//
// Tiles in shared memory.  A [rows, DH] bf16 tile arrives by TMA as DH/PC
// panels of PC = min(DH, 64) columns, each panel `rows` rows of 2 PC bytes,
// swizzled 128 bytes (DH 64, 128) or 64 bytes (DH 32) as the wgmma
// descriptors name it.  A 3-D tensor map over [B*H, S, DH] zero-fills rows
// past S inside one head.
#pragma once

#include "hopper.cuh"

namespace attn {

using namespace hopper;

constexpr float NEG_INF = -1e30f;          // lse of a row that sees no key
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float score_log2(float acc, float scale_log2) {
  return __fmul_rn(acc, scale_log2);
}

__device__ __forceinline__ float exp_shifted(float score, float shift) {
  return exp2f(score - shift);
}

__device__ __forceinline__ float exp_score(float acc, float scale_log2,
                                           float shift) {
  return exp_shifted(score_log2(acc, scale_log2), shift);
}

// ---------------------------------------------------------------- tiles
template <int DH> struct Tile {
  static constexpr int PC = DH < 64 ? DH : 64;      // columns per panel
  static constexpr int ROW = PC * 2;                // bytes per panel row
  static constexpr int NP = DH / PC;                // panels
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;   // B128 / B64
  static constexpr int KSTEPS = DH / 16;            // k16 steps over DH
  static constexpr int rows_bytes(int rows) { return rows * DH * 2; }
};

// K-major operand (DH contiguous: Q, K) of a tile starting at `base` with
// `rows` rows, at k16 step `kk`: panel kk / (PC/16), then 32 bytes per step
// inside the swizzled row; 8-row groups 8 ROW bytes apart.
template <int DH>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, int rows,
                                                int kk) {
  using T = Tile<DH>;
  constexpr int per = T::PC / 16;
  const uint32_t addr = base + (kk / per) * rows * T::ROW + (kk % per) * 32;
  return make_desc(addr, 16, 8 * T::ROW, T::LAYOUT);
}

// N-major B operand (V: [keys, DH], DH contiguous) for keys 16 kk..16 kk+15
// of a tile of `rows` keys: 8-key groups 8 ROW bytes apart (SBO), DH
// panels `rows` ROW bytes apart (LBO).
template <int DH>
__device__ __forceinline__ uint64_t desc_nmajor(uint32_t base, int rows,
                                                int kk) {
  using T = Tile<DH>;
  return make_desc(base + kk * 16 * T::ROW, rows * T::ROW, 8 * T::ROW,
                   T::LAYOUT);
}

// All DH/PC panels of `rows` rows starting at row `row` of head `head`.
template <int DH>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int rows, int row, int head) {
  using T = Tile<DH>;
#pragma unroll
  for (int p = 0; p < T::NP; ++p)
    tma_load_3d(dst + p * rows * T::ROW, map, bar, p * T::PC, row, head);
}

// ----------------------------------------------------------------- host
// The f32 constant both kernels scale the product by (score_log2).
inline float log2_scale(float scale) { return scale * LOG2E; }

// Tensor map over a contiguous bf16 [heads, rows, DH] array, boxes of PC
// columns x `box_rows` rows x 1 head, swizzled as Tile<DH> says; rows past
// `rows` read as zeros.  Returns a cudaError_t.
template <int DH>
int make_map(CUtensorMap* map, const void* ptr, long long heads,
             long long rows, int box_rows) {
  return make_map_bf16(map, ptr, heads, rows, DH, Tile<DH>::PC, box_rows);
}

}  // namespace attn
