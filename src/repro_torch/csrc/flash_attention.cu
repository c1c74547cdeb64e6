// Flash attention forward (online softmax), causal or full, with the
// per-row logsumexp:
//
//   out[b,h,i] = sum_j softmax_j(s[i,j]) v[b,h//G,j],   s = q.k * scale
//   lse[b,h,i] = log sum_j exp(s[i,j])                 (f32)
//
// and, from the same row-owner kernel in two more modes, the first and last
// of MCA prefill's three scoring passes (models/attention.py gqa_attention;
// the middle one is attn_colmax.cu):
//
//   LSE: m[b,h,i] = max_j s[i,j], lse[b,h,i]    (the online max and sum, no V)
//   AV:  out[b,h,i] = sum_j bf16(exp(s[i,j] - lse[b,h,i])) v[b,h//G,j]
//        (lse given, no rescale, no normalisation; f32 sums)
//
// GQA maps query head h to KV head h // (Hq/Hkv) and never repeats KV.  The
// causal diagonal is offset by `off`: query i sees keys j <= i + off (flash:
// off = skv - sq; the passes: the rows' q_offset).  A key may also be masked
// by a [B, Skv] byte array (left padding); a row that sees no key writes
// out = 0 and m = lse = -1e30.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// TPU kernel; grid (b, h, q tile, kv tile) with the kv axis sequential,
// (m, l, acc) in VMEM scratch, tiles above the offset diagonal skipped).
//
// What bounds it on an H100: bytes, with operations close behind.  At the
// starcoder2-3b prefill shape [4, 24, 512, 128] causal in bf16 it must read
// q, k, v and write out and lse, about 26 MB (7.9 us at 3.35 TB/s), and do
// about 6.4 GFLOP for the causal half of QK^T and PV (6.5 us at 989
// TFLOP/s dense bf16).
//
// What the bf16 design does about it (Hopper, sm_90a; attn_tile.cuh):
//   * One block per (64-row q tile, query head, batch), heaviest q tiles
//     launched first (the q tile is the slowest grid axis, reversed), so
//     the causal tail does not set the time: one consumer warpgroup and
//     one producer warp, two blocks per SM (80 KB of shared memory each at
//     dh 128).  128-row blocks of two consumer warpgroups were timed too
//     and were slower (PERF.md).
//   * The producer warp loads the Q tile once and streams K and V tiles of
//     64 keys by TMA (attn_tile.cuh's tensor maps, rows past S zero inside
//     one head) into two rings of two stages, K and V apart, one
//     mbarrier pair per stage (full: bytes landed; empty: one arrival per
//     consumer warp).  K is released as soon as S is done, so the next K
//     loads during the softmax and P V.  The loop stops at the last tile
//     the offset causal diagonal reaches.
//   * S = Q K^T runs as wgmma m64n64k16, Q and K from the swizzled shared
//     tiles, the f32 accumulator in registers.  The softmax runs on those
//     registers with no branch per element: each thread holds 2 rows x 16
//     keys, scales them to log2 units (score_log2, the contract
//     attn_colmax.cu shares), sets masked keys to -inf, takes each row's
//     max from its own elements plus two quad shuffles and exp2 of the
//     shifted score; m in log2 units and the thread's partial l in f32, l
//     summed over the quad once at the end.  P is converted to bf16 in
//     place into the A-operand layout of O += P V, a wgmma with A in
//     registers and V the shared B operand read with the transpose bit (V
//     is [keys, dh], dh contiguous).  O stays in registers for the whole
//     loop; no S, P or O tile touches shared memory.
//     lse = (m + log2 l) * ln 2.
//   * P is rounded to bf16 for the PV product, where the Pallas kernel keeps
//     it in f32 (the port's onepass_attention rounds it to V's dtype too);
//     the row sum l is taken over the unrounded f32 P.  This is the one
//     rounding that the bf16 tolerance must cover.
//   * Ragged edges and the causal mask are applied to the register tile,
//     only on tiles that cross an edge.  A masked key gets p = exp2(-inf)
//     = 0 exactly, so a row that sees no key at all (causal with sq > skv)
//     writes out = 0 and lse = -1e30; the Pallas kernel differs there.
//   * No atomics: every output element is written once by one thread, so
//     repeated runs are bitwise equal.
//   * f32 inputs take the FMA path (attn_f32.cuh; 256 threads, each owning
//     4 rows x 4 keys of S and 4 rows x dh/16 columns of O in registers).
//   * dh in {32, 64, 128}; 128-byte swizzle in 64-column panels (dh 64,
//     128), 64-byte swizzle for dh 32's 64-byte rows.
//   * Operands are read through 4-D tensor maps with their own strides, so
//     the passes read q, k and v where the model keeps them ([B, S, H, dh])
//     and write A V's out in the layout the output projection reads.
//   * The passes replace chunked f32 PyTorch (models/attention.py
//     chunked_lse, chunked_av; no TPU kernel: the reference runs them as
//     jnp).  What bounds them on an H100 at starcoder2-3b's 4,096-token
//     prefill (1 x 24/2 x 4,096 x 128, causal): operations, about 52 GFLOP
//     of QK^T a pass (53 us at 989 TFLOP/s) against about 29 MB of q, k
//     and v (8.8 us at 3.35 TB/s).  So they run S and P V on wgmma from bf16
//     operands with f32 sums, as the chunked passes compute them in f32
//     from the same bf16 values, and skip what needs no work: every warp
//     computes a key tile's mask bits (attn_tile.cuh valid_bits) and all of
//     them pass over a tile of padding alone, as over tiles past the
//     diagonal.  The AV mode exponentiates against the final lse, so it
//     has no running max; P is rounded to bf16 before P V, as the chunked
//     pass rounds A to V's dtype.
// Tried and not kept, as neither ran faster at the phase-7 shape (PERF.md):
// issuing the next tile's S before this tile's softmax, so that it
// overlaps P V (FlashAttention-3's intra-warpgroup pipelining), and a
// persistent grid of two blocks per SM that loads the next work item's Q
// during the current one.
//
// Telemetry (telemetry.cuh; null buffer: off) counts score tiles in the
// caller's (block_q x block_k) units, as the reference's kernel computes
// them: one thread of each block (the bf16 kernel's producer lane, once
// its loads are issued) adds the tiles of its query head whose first row
// it holds (tel::attn_tiles_of_rows; tel_bq = 0 where the reference falls
// back and counts none).  skv == 0 marks the call from the helper kernel
// that writes lse.
#include "attn_f32.cuh"
#include "telemetry.cuh"

namespace {

using namespace attn;

template <int DH> struct FlashCfg {
  static constexpr int BQ = 64;             // query rows per block
  static constexpr int BKV = 64;            // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 + 32;  // consumer warpgroup + producer
  static constexpr int Q_BYTES = Tile<DH>::rows_bytes(BQ);
  static constexpr int KV_BYTES = Tile<DH>::rows_bytes(BKV);   // K or V
  static constexpr size_t smem() {
    return 1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES +
           (1 + 4 * STAGES) * 8;
  }
};

// What a row-owner launch computes.
enum Mode {
  FLASH = 0,   // out = softmax(S) V and lse (online max and sum)
  LSE = 1,     // m and lse alone: the online max and sum, no V
  AV = 2,      // out = A V, A = exp(S - lse) from a given lse, unnormalised
};

struct RowArgs {
  __nv_bfloat16* out;    // FLASH, AV: [B, Hq, Sq, DH] laid out as out_st
  Layout out_st;
  float* m;              // LSE: [B, Hq, Sq] f32, the row max (natural units)
  float* lse;            // [B, Hq, Sq] f32: written by FLASH and LSE, read by AV
  const unsigned char* kv_valid;   // [B, Skv] key mask, or null: all valid
  int hq, hkv, sq, skv;
  int off;               // query i sees keys j <= i + off (causal)
  int causal;
  float scale_log2;
  int* tel_buf;          // FLASH only (null: off)
  int tel_bq, tel_bk;
};

// Whether element i of this thread's 64 x 64 score tile (row (i >> 1) & 1,
// key k0 + 8 (i >> 2) + c0 + (i & 1)) is hidden: its key's bit is clear in
// `bits` (padding, or past skv) or lies past its row's last visible key lim.
__device__ __forceinline__ bool hidden(int i, uint64_t bits,
                                       const int (&lim)[2], int k0, int c0) {
  const int col = (i >> 2) * 8 + c0 + (i & 1);
  return !((bits >> col) & 1) || k0 + col > lim[(i >> 1) & 1];
}

// One online-softmax step on a 64 x 64 score tile in registers (this
// thread: rows r and r + 8 of its accumulator): scales it to log2 units,
// sets hidden elements to -inf on a tile that crosses an edge (so exp2 gives
// p = 0 exactly), updates m and the thread's partial l, returns each row's
// correction for O in corr and leaves P (f32) in s.  No branch depends on
// an element.
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool edge, uint64_t bits,
                                             const int (&lim)[2], int k0,
                                             int c0, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY}, m_use[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = score_log2(s[i], scale_log2);
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (hidden(i, bits, lim, k0, c0)) s[i] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.0f : m_new;     // nothing seen yet
    corr[r] = exp2f(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp_shifted(s[i], m_use[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// P (f32, the S accumulator's layout) as the bf16 A operand of P V: k16
// step kk holds keys 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(FlashCfg<DH>::THREADS, 2)
rows_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const RowArgs a) {
  using C = FlashCfg<DH>;
  constexpr int ST = C::STAGES, NO = MODE == LSE ? 1 : DH / 2;
  constexpr bool HAS_V = MODE != LSE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* ks = qs + C::Q_BYTES;      // K ring, then V ring
  unsigned char* vs = ks + ST * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;            // [ST] each
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (a.hq / a.hkv);
  const int q_valid = min(C::BQ, a.sq - q0);
  // the block's last real row, q0 + q_valid - 1, sees keys up to it + off
  const int kv_end = a.causal ? min(a.skv, q0 + q_valid + a.off) : a.skv;
  const int n_kt = kv_end > 0 ? (kv_end + C::BKV - 1) / C::BKV : 0;
  const unsigned char* kvv =
      a.kv_valid == nullptr ? nullptr : a.kv_valid + (long long)b * a.skv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4);            // one arrival per consumer warp
      mbar_init(&v_empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Every warp walks the same key tiles: those up to the causal end that
  // hold a valid key (a tile of padding alone is skipped by all of them);
  // n counts the tiles taken, which the rings follow.
  if (warp == 4) {                          // producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_tile<DH>(qs, &tm_q, q_full, C::BQ, q0, h, b);
    }
    for (int jt = 0, n = 0; jt < n_kt; ++jt) {
      const int k0 = jt * C::BKV;
      if (valid_bits(kvv, k0, a.skv) == 0) continue;
      if (lane == 0) {
        const int s = n % ST;
        if (n >= ST) mbar_wait(&k_empty[s], ((n / ST) - 1) & 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_tile<DH>(ks + s * C::KV_BYTES, &tm_k, &k_full[s], C::BKV, k0, kh,
                     b);
        if constexpr (HAS_V) {
          if (n >= ST) mbar_wait(&v_empty[s], ((n / ST) - 1) & 1);
          mbar_expect_tx(&v_full[s], C::KV_BYTES);
          tma_tile<DH>(vs + s * C::KV_BYTES, &tm_v, &v_full[s], C::BKV, k0,
                       kh, b);
        }
      }
      ++n;
    }
    // telemetry once every load is issued: off the consumers' path
    if (lane == 0)
      tel::record(a.tel_buf, blockIdx.x == 0 && blockIdx.y == 0 &&
                                 blockIdx.z == 0, 1,
                  tel::attn_tiles_of_rows(q0, q0 + C::BQ, a.tel_bq, a.tel_bk,
                                          a.sq, a.skv, a.causal));
    return;
  }

  // consumer warpgroup: query rows q0 + r0 and q0 + r0 + 8 in this
  // thread's accumulator rows, key columns 8 j + c0 (+1)
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t q_base = smem_u32(qs);
  float o[NO], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float corr[2], shift[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  // the last key each of this thread's two rows sees (keys past skv are
  // cleared from the tile's bits), and for AV its lse in log2 units
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lim[r] = a.causal ? row + a.off : a.skv;
    shift[r] = MODE == AV && row < a.sq
                   ? a.lse[((long long)b * a.hq + h) * a.sq + row] * LOG2E
                   : 0.0f;
  }

  mbar_wait(q_full, 0);
  for (int jt = 0, n = 0; jt < n_kt; ++jt) {
    const int k0 = jt * C::BKV;
    const uint64_t bits = valid_bits(kvv, k0, a.skv);
    if (bits == 0) continue;
    const int st = n % ST;
    const uint32_t phase = (n / ST) & 1;
    ++n;
    mbar_wait(&k_full[st], phase);
    const uint32_t kb = smem_u32(ks + st * C::KV_BYTES);
    wgmma_fence();                          // S = Q K^T
#pragma unroll
    for (int kk = 0; kk < Tile<DH>::KSTEPS; ++kk)
      wgmma_ss_n64(s, desc_kmajor<DH>(q_base, C::BQ, kk),
                   desc_kmajor<DH>(kb, C::BKV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    warp_arrive(&k_empty[st]);              // the next K loads meanwhile
    const bool edge = bits != ~0ull ||
                      (a.causal && k0 + C::BKV - 1 > q0 + a.off);
    if constexpr (MODE == AV) {
      // A = exp(s - lse) from the final lse: no running max, no rescale;
      // a hidden element is 0 by a select (exp may be inf there)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp_score(s[i], a.scale_log2, shift[(i >> 1) & 1]);
        s[i] = edge && hidden(i, bits, lim, k0, c0) ? 0.0f : p;
      }
    } else {
      softmax_step(s, m, l, corr, edge, bits, lim, k0, c0, a.scale_log2);
    }
    if constexpr (HAS_V) {
      if constexpr (MODE == FLASH) {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      pack_p(s, pa);
      mbar_wait(&v_full[st], phase);
      const uint32_t vb = smem_u32(vs + st * C::KV_BYTES);
      wgmma_fence();                        // O += P V
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        RsN<DH>::run(o, pa[kk], desc_nmajor<DH>(vb, C::BKV, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      warp_arrive(&v_empty[st]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row >= a.sq) continue;
    const long long at = ((long long)b * a.hq + h) * a.sq + row;
    if constexpr (HAS_V) {
      const float inv = MODE == AV ? 1.0f : l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
      __nv_bfloat16* dst = a.out + b * a.out_st.batch + h * a.out_st.head +
                           row * a.out_st.row + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (MODE == AV || lane % 4) continue;
    // a row that saw no key: m = lse = -1e30, as the chunked passes give
    if constexpr (MODE == LSE) a.m[at] = l[r] > 0.0f ? m[r] * LN2 : NEG_INF;
    a.lse[at] = l[r] > 0.0f ? (m[r] + log2f(l[r])) * LN2 : NEG_INF;
  }
}

using namespace attn_f32;

template <int DH> struct FlashF32 {
  static constexpr int FLD = Dims<DH>::FLD;
  static constexpr int PLD = BK + 1;
  static constexpr size_t smem() {
    return ((size_t)BQ * FLD + (size_t)BK * FLD + (size_t)BK * DH +
            (size_t)BQ * PLD) * 4;
  }
};

template <int DH>
__global__ void __launch_bounds__(256)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int hq, int hkv, int sq,
                     int skv, float scale, int causal,
                     int* __restrict__ tel_buf, int tel_bq, int tel_bk) {
  using T = FlashF32<DH>;
  constexpr int FLD = T::FLD, PLD = T::PLD, NJ = DH / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * FLD;
  float* vs = ks + BK * FLD;       // [BK][DH]
  float* ps = vs + BK * DH;        // [BQ][PLD]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const long long qbase = ((long long)b * hq + h) * sq;
  const long long kbase = ((long long)b * hkv + hk) * skv;
  const int q_valid = min(BQ, sq - q0);
  if (threadIdx.x == 0)
    tel::record(tel_buf, blockIdx.x == 0 && h == 0 && b == 0, 1,
                tel::attn_tiles_of_rows(q0, q0 + BQ, tel_bq, tel_bk, sq, skv,
                                        causal));

  load_tile_f32<DH>(qs, q + (qbase + q0) * DH, BQ, q_valid, FLD);
  float o[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  }
  const int kv_end = causal ? min(skv, q0 + q_valid + off) : skv;
  const int n_kt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  for (int jt = 0; jt < n_kt; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    load_tile_f32<DH>(ks, k + (kbase + k0) * DH, BK, skv - k0, FLD);
    load_tile_f32<DH>(vs, v + (kbase + k0) * DH, BK, skv - k0, DH);
    __syncthreads();
    float s[4][4];
    scores_f32<DH>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qrow, k0 + tx + 16 * j, skv, off, causal)
                      ? __fmul_rn(s[i][j], scale) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a half-warp share the row
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.0f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= sq) continue;
    const float safe = l[i] == 0.0f ? 1.0f : l[i];
    float* dst = out + (qbase + qrow) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = o[i][j] / safe;
    if (tx == 0) lse[qbase + qrow] = m[i] + logf(safe);
  }
}

__global__ void fill_no_key_lse_kernel(float* lse, long long n,
                                       int* tel_buf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) tel::record(tel_buf, true, 1, 0);
  if (i < n) lse[i] = NEG_INF;
}

// skv == 0: every row sees no key, so out 0 and lse -1e30, as the kernel
// writes such rows.  No K or V tensor map can be encoded over a dimension
// of 0, so these are written without the kernel.
int flash_no_keys(void* out, void* lse, long long rows, int dh,
                  int* tel_buf, cudaStream_t stream) {
  const cudaError_t e = cudaMemsetAsync(
      out, 0, (size_t)rows * dh * sizeof(__nv_bfloat16), stream);
  if (e != cudaSuccess) return (int)e;
  fill_no_key_lse_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      (float*)lse, rows, tel_buf);
  return (int)cudaGetLastError();
}

// st: the layouts of q, k, v and out (Layout each, in that order).
template <int DH, int MODE>
int rows_bf16(const void* q, const void* k, const void* v, const Layout* st,
              RowArgs a, int b, cudaStream_t stream) {
  using C = FlashCfg<DH>;
  if (a.skv == 0)
    return MODE == FLASH ? flash_no_keys(a.out, a.lse,
                                         (long long)b * a.hq * a.sq, DH,
                                         a.tel_buf, stream)
                         : (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e = make_map<DH>(&tq, q, b, a.hq, a.sq, st[0], C::BQ);
  if (!e) e = make_map<DH>(&tk, k, b, a.hkv, a.skv, st[1], C::BKV);
  if (!e) e = make_map<DH>(&tv, v, b, a.hkv, a.skv, st[2], C::BKV);
  if (!e)
    e = (int)cudaFuncSetAttribute(rows_bf16_kernel<DH, MODE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)C::smem());
  if (e) return e;
  const dim3 grid(a.hq, b, (a.sq + C::BQ - 1) / C::BQ);
  rows_bf16_kernel<DH, MODE><<<grid, C::THREADS, C::smem(), stream>>>(
      tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH>
int rows_mode(int mode, const void* q, const void* k, const void* v,
              const Layout* st, const RowArgs& a, int b,
              cudaStream_t stream) {
  switch (mode) {
    case FLASH: return rows_bf16<DH, FLASH>(q, k, v, st, a, b, stream);
    case LSE: return rows_bf16<DH, LSE>(q, k, v, st, a, b, stream);
    case AV: return rows_bf16<DH, AV>(q, k, v, st, a, b, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DH>
int flash_f32(const void* q, const void* k, const void* v, void* out,
              void* lse, dim3 grid, int hq, int hkv, int sq, int skv,
              float scale, int causal, int* tel_buf, int tel_bq, int tel_bk,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FlashF32<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_kernel<DH><<<grid, 256, FlashF32<DH>::smem(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, hq, hkv, sq, skv, scale, causal, tel_buf, tel_bq, tel_bk);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 row-owner kernel in `mode`: 0 flash attention (writes out and
// lse), 1 the lse pass (writes m and lse), 2 A V from a given lse (reads
// lse, writes out).  q: [B, Hq, Sq, dh], k, v: [B, Hkv, Skv, dh] and out:
// [B, Hq, Sq, dh] bf16, laid out as `strides` says (a row's, a head's and a
// batch's element strides of q, k, v and out, 12 in all; dh contiguous,
// every stride a multiple of 8, pointers 16-byte aligned); m, lse: [B, Hq,
// Sq] f32 contiguous; kv_valid: [B, Skv] bytes (nonzero: a valid key) or
// NULL.  Causal: query i sees keys j <= i + off.  Hq % Hkv == 0, dh in
// {32, 64, 128}, Sq >= 1; Skv may be 0 for flash only (every row then sees
// no key).  Pointers a mode does not read or write may be NULL (v for the
// lse pass: pass k).  tel: a zeroed [1, 8] int32 telemetry buffer or NULL;
// (tel_bq, tel_bk): the caller's tile, (0, 0) where the reference falls
// back.  Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int attn_rows_bf16(const void* q, const void* k, const void* v,
                              void* out, void* m, void* lse,
                              const void* kv_valid, const long long* strides,
                              int b, int hq, int hkv, int sq, int skv, int dh,
                              int off, float scale, int causal, int mode,
                              void* tel, int tel_bq, int tel_bk,
                              void* stream) {
  const Layout st[4] = {{strides[0], strides[1], strides[2]},
                        {strides[3], strides[4], strides[5]},
                        {strides[6], strides[7], strides[8]},
                        {strides[9], strides[10], strides[11]}};
  const RowArgs a = {(__nv_bfloat16*)out, st[3], (float*)m, (float*)lse,
                     (const unsigned char*)kv_valid, hq, hkv, sq, skv, off,
                     causal, log2_scale(scale), (int*)tel, tel_bq, tel_bk};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return rows_mode<32>(mode, q, k, v, st, a, b, s);
    case 64: return rows_mode<64>(mode, q, k, v, st, a, b, s);
    case 128: return rows_mode<128>(mode, q, k, v, st, a, b, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The f32 flash kernel: q: [B, Hq, Sq, dh], k/v: [B, Hkv, Skv, dh], out:
// [B, Hq, Sq, dh], lse: [B, Hq, Sq]; all contiguous f32 on the device,
// Hq % Hkv == 0, dh in {32, 64, 128}, Sq >= 1, causal with the diagonal
// offset skv - sq; tel as above.  Launches on `stream`, returns a
// cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int hq, int hkv, int sq, int skv,
                                   int dh, float scale, int causal,
                                   void* tel, int tel_bq, int tel_bk,
                                   void* stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  int* tb = (int*)tel;
  switch (dh) {
    case 32: return flash_f32<32>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
    case 64: return flash_f32<64>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
    case 128: return flash_f32<128>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
  }
  return (int)cudaErrorInvalidValue;
}
