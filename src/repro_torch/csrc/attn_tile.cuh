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
// steps since its row max needs the scaled score first (the lse pass
// likewise); colmax and the A V pass with shift = lse * log2 e, lse =
// (m2 + log2 l) * ln 2 being what flash or the lse pass wrote.  So their
// exp(s - lse) is taken on the score whose logsumexp was written, scaled by
// the same f32 constant.  __fmul_rn keeps the compiler
// from fusing the multiply into a neighbouring add in one kernel and not
// the other.  wgmma does not specify its summation order, so flash's S and
// colmax's S^T may differ in the last bits of acc: within the 1e-3
// tolerance of a value in [0, 1].
//
// Tiles in shared memory.  A [rows, DH] bf16 tile arrives by TMA as DH/PC
// panels of PC = min(DH, 64) columns, each panel `rows` rows of 2 PC bytes,
// swizzled 128 bytes (DH 64, 128) or 64 bytes (DH 32) as the wgmma
// descriptors name it.  A 4-D tensor map over an operand [B, H, S, DH],
// addressed with its own element strides (Layout: DH contiguous, the rest
// in any order, as a head-major or a sequence-major tensor lies),
// zero-fills rows past S inside one head.
//
// Masks.  A key (or query) row may be marked invalid by a [B, S] byte
// array (left padding); valid_bits gives a warp the bits of a 64-row tile,
// so every warp of a block skips the same tiles without talking.
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

// All DH/PC panels of `rows` rows starting at row `row` of head `head` of
// batch `b`.
template <int DH>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int rows, int row, int head, int b) {
  using T = Tile<DH>;
#pragma unroll
  for (int p = 0; p < T::NP; ++p)
    tma_load_4d(dst + p * rows * T::ROW, map, bar, p * T::PC, row, head, b);
}

// Bit i: row r0 + i of a 64-row tile lies below n and is valid (`valid`, a
// row of a [B, S] byte mask, or null: every row is).  Warp-collective: every
// lane of the warp calls it, and every lane gets the same bits.
__device__ __forceinline__ uint64_t valid_bits(const unsigned char* valid,
                                               int r0, int n) {
  const int lo = r0 + threadIdx.x % 32, hi = lo + 32;
  const bool a = lo < n && (valid == nullptr || valid[lo]);
  const bool b = hi < n && (valid == nullptr || valid[hi]);
  return (uint64_t)__ballot_sync(0xffffffffu, a) |
         (uint64_t)__ballot_sync(0xffffffffu, b) << 32;
}

// ----------------------------------------------------------------- host
// The f32 constant both kernels scale the product by (score_log2).
inline float log2_scale(float scale) { return scale * LOG2E; }

// Where an operand [B, H, S, DH] lies: the element strides of a row, a head
// and a batch (DH contiguous).
struct Layout {
  long long row, head, batch;
};

// The layout of a contiguous [B, H, S, DH] array.
template <int DH>
inline Layout head_major(int heads, int rows) {
  return {DH, (long long)rows * DH, (long long)heads * rows * DH};
}

// Tensor map over a bf16 operand [batch, heads, rows, DH] laid out as `st`
// says, boxes of PC columns x `box_rows` rows x 1 head x 1 batch, swizzled
// as Tile<DH> says; rows past `rows` read as zeros.  Returns a cudaError_t.
template <int DH>
int make_map(CUtensorMap* map, const void* ptr, long long batch,
             long long heads, long long rows, Layout st, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.row * 2,
                                 (cuuint64_t)st.head * 2,
                                 (cuuint64_t)st.batch * 2};
  return encode_bf16(map, ptr, 4, dims, strides, Tile<DH>::PC, box_rows);
}

}  // namespace attn
