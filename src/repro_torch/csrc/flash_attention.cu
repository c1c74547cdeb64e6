// Flash attention forward (online softmax), causal or full, with the
// per-row logsumexp:
//
//   out[b,h,i] = sum_j softmax_j(s[i,j]) v[b,h//G,j],   s = q.k * scale
//   lse[b,h,i] = log sum_j exp(s[i,j])                 (f32)
//
// GQA maps query head h to KV head h // (Hq/Hkv) and never repeats KV.  The
// causal diagonal is offset by skv - sq: query i sees keys j <= i + skv - sq.
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
// What the design does about it:
//   * One block per (64-row q tile, query head, batch).  The TPU grid's
//     sequential kv axis becomes a loop inside the block over 64-key tiles;
//     with causal masking the loop stops at the last tile the offset
//     diagonal reaches.  The Q tile is loaded once, each K/V tile once per
//     block (GQA heads of one group read the same K/V, mostly from L2).
//   * bf16: QK^T and PV on the tensor cores (WMMA 16x16x16, f32
//     accumulate), one warp per 16 query rows.  The online-softmax state
//     (m, l) and the output accumulator stay in f32 (O in shared memory,
//     rescaled by each row's correction before PV is added to it).  Scores
//     are scaled in f32 after the f32 product; q is never rounded scaled,
//     so attn_colmax.cu (same score code, attn_tile.cuh) sees the same s.
//   * P is rounded to bf16 for the PV product, where the Pallas kernel keeps
//     it in f32 (the port's onepass_attention rounds it to V's dtype too);
//     the row sum l is taken over the unrounded f32 P.  This is the one
//     rounding that the bf16 tolerance must cover.
//   * f32 inputs take an FMA path (256 threads, each owning 4 rows x 4
//     keys of S and 4 rows x dh/16 columns of O in registers).
//   * Ragged edges are masked: q rows past sq load zeros and are not
//     stored; keys past skv get p = 0.  A masked key always gets p = 0
//     exactly, so a row that sees no key at all (causal with sq > skv)
//     writes out = 0 and lse = -1e30; the Pallas kernel differs there.
//   * dh in {32, 64, 128}; shared memory is dynamic (113 KB per block at
//     dh 128, bf16), set with cudaFuncSetAttribute before each launch.
// Not yet done (later work): mma.sync/wgmma fragments with the softmax in
// registers, cp.async/TMA double buffering of K/V, larger q tiles.
#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DH> struct FlashBf16 {
  static constexpr int LD = Dims<DH>::LD;
  static constexpr int OLD = DH + 4;   // f32 O accumulator
  static constexpr int PLD = BK + 8;   // bf16 P tile
  static constexpr size_t smem() {
    return (size_t)BQ * LD * 2 + 2 * (size_t)BK * LD * 2 +
           (size_t)BQ * SLD * 4 + (size_t)BQ * PLD * 2 +
           (size_t)BQ * OLD * 4 + 2 * (size_t)BQ * 4;
  }
};

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int hq, int hkv, int sq,
                      int skv, float scale, int causal) {
  using T = FlashBf16<DH>;
  constexpr int LD = T::LD, OLD = T::OLD, PLD = T::PLD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  float* ss = reinterpret_cast<float*>(vs + BK * LD);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + BQ * SLD);
  float* os = reinterpret_cast<float*>(ps + BQ * PLD);
  float* m_s = os + BQ * OLD;
  float* l_s = m_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const long long qbase = ((long long)b * hq + h) * sq;
  const long long kbase = ((long long)b * hkv + hk) * skv;
  const int q_valid = min(BQ, sq - q0);

  load_tile_bf16<DH>(qs, q + (qbase + q0) * DH, BQ, q_valid);
  for (int i = threadIdx.x; i < BQ * OLD; i += blockDim.x) os[i] = 0.0f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.0f;
  }
  // the tile's last real row, q0 + q_valid - 1, sees keys up to it + off
  const int kv_end = causal ? min(skv, q0 + q_valid + off) : skv;
  const int n_kt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  // this lane's row (two lanes per row) and its half of the columns
  const int r = warp * 16 + lane / 2, half = lane % 2;
  const int qrow = q0 + r;

  for (int jt = 0; jt < n_kt; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();               // the last tile's readers are done
    load_tile_bf16<DH>(ks, k + (kbase + k0) * DH, BK, skv - k0);
    load_tile_bf16<DH>(vs, v + (kbase + k0) * DH, BK, skv - k0);
    __syncthreads();
    scores_bf16_warp<DH>(qs, ks, ss, warp);
    __syncwarp();

    float* srow = ss + r * SLD;
    const float m_prev = m_s[r];
    float mx = NEG_INF;
    for (int c = half; c < BK; c += 2) {
      const float sv = visible(qrow, k0 + c, skv, off, causal)
                           ? __fmul_rn(srow[c], scale) : NEG_INF;
      srow[c] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
    __nv_bfloat16* prow = ps + r * PLD;
    for (int c = half; c < BK; c += 2) {
      const float sv = srow[c];
      const float p = sv == NEG_INF ? 0.0f : expf(sv - m_new);
      prow[c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_prev - m_new);
    if (half == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
    }
    float* orow = os + r * OLD;
    for (int c = half; c < DH; c += 2) orow[c] *= corr;
    __syncwarp();

    // O[warp's rows] += P V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      wmma::load_matrix_sync(pa[kk / 16], ps + warp * 16 * PLD + kk, PLD);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      float* ot = os + warp * 16 * OLD + j * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, ot, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * LD + j * 16, LD);
        wmma::mma_sync(of, pa[kk / 16], vb, of);
      }
      wmma::store_matrix_sync(ot, of, OLD, wmma::mem_row_major);
    }
  }
  __syncthreads();

  if (qrow < sq) {
    const float l = l_s[r];
    const float safe = l == 0.0f ? 1.0f : l;
    const float* orow = os + r * OLD;
    __nv_bfloat16* dst = out + (qbase + qrow) * DH;
    for (int c = half; c < DH; c += 2) dst[c] = __float2bfloat16(orow[c] / safe);
    if (half == 0) lse[qbase + qrow] = m_s[r] + logf(safe);
  }
}

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
                     int skv, float scale, int causal) {
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

template <int DH>
int flash_bf16(const void* q, const void* k, const void* v, void* out,
               void* lse, dim3 grid, int hq, int hkv, int sq, int skv,
               float scale, int causal, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FlashBf16<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  flash_fwd_bf16_kernel<DH><<<grid, 128, FlashBf16<DH>::smem(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, hq, hkv, sq,
      skv, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int flash_f32(const void* q, const void* k, const void* v, void* out,
              void* lse, dim3 grid, int hq, int hkv, int sq, int skv,
              float scale, int causal, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FlashF32<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_kernel<DH><<<grid, 256, FlashF32<DH>::smem(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, hq, hkv, sq, skv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Hq, Sq, dh], k/v: [B, Hkv, Skv, dh], out: [B, Hq, Sq, dh] (q's
// dtype), lse: [B, Hq, Sq] f32; all contiguous on the device, Hq % Hkv == 0,
// dh in {32, 64, 128}, Sq >= 1, bf16 pointers 16-byte aligned (the wrapper
// checks).  Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int b, int hq, int hkv, int sq, int skv,
                                    int dh, float scale, int causal,
                                    void* stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return flash_bf16<32>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
    case 64: return flash_bf16<64>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
    case 128: return flash_bf16<128>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int hq, int hkv, int sq, int skv,
                                   int dh, float scale, int causal,
                                   void* stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return flash_f32<32>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
    case 64: return flash_f32<64>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
    case 128: return flash_f32<128>(q, k, v, out, lse, grid, hq, hkv, sq, skv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
