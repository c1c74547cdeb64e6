// Attention column max from (q, k, lse), without materialising A:
//
//   colmax[b,h,j] = max_i exp(s[i,j] - lse[b,h,i]),   s = q.k * scale,
//
// masked to 0 where query i does not see key j (causal diagonal offset by
// skv - sq), per query head, f32.  The wrapper reduces over heads.
//
// Replaces: src/repro/kernels/attn_colmax.py::attn_colmax (Pallas TPU
// kernel; grid (b, h, kv tile, q tile) with the q axis sequential, score
// tiles recomputed like a flash backward pass, q tiles above the offset
// diagonal skipped, a (1, bk) max held in VMEM scratch).
//
// What bounds it on an H100: bytes.  At [4, 24, 512, 128] causal in bf16 it
// must read q, k and lse and write colmax, about 13.5 MB (4.0 us at 3.35
// TB/s), against about 3.2 GFLOP for the causal half of QK^T (3.3 us at 989
// TFLOP/s).
//
// What the design does about it:
//   * One block per (64-key tile, query head, batch).  The K tile is loaded
//     once; the TPU grid's sequential q axis becomes a loop inside the block
//     over 64-row q tiles, starting at the first tile that the offset
//     diagonal lets see any key of this tile.  The column max is folded in
//     registers, in f32, and written once.
//   * Scores come from attn_tile.cuh, the code flash_attention.cu uses: the
//     same bf16 WMMA product (or f32 FMA), scaled in f32 afterwards, so
//     exp(s - lse) is taken on the score whose logsumexp flash wrote.
//   * bf16: the score tile goes through shared memory (WMMA fragments are
//     opaque); 128 threads each own one key column and half the q rows of
//     the tile.  f32: 256 threads keep the tile in registers and reduce
//     their column maxima through shared memory at the end.
//   * Ragged edges: q rows past sq and keys past skv are masked.
//   * dh in {32, 64, 128}; dynamic shared memory (53 KB at dh 128, bf16).
// Not yet done (later work): mma.sync fragments with the max in registers,
// cp.async double buffering of the q tiles, fusing into flash's pass.
#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DH> struct ColmaxBf16 {
  static constexpr int LD = Dims<DH>::LD;
  static constexpr size_t smem() {
    return 2 * (size_t)BQ * LD * 2 + (size_t)BQ * SLD * 4 +
           (size_t)BQ * 4 + 2 * (size_t)BK * 4;
  }
};

template <int DH>
__global__ void __launch_bounds__(128)
colmax_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const float* __restrict__ lse, float* __restrict__ out,
                   int hq, int hkv, int sq, int skv, float scale,
                   int causal) {
  constexpr int LD = ColmaxBf16<DH>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ks + BK * LD;
  float* ss = reinterpret_cast<float*>(qs + BQ * LD);
  float* lse_s = ss + BQ * SLD;
  float* red = lse_s + BQ;         // [2][BK]

  const int tid = threadIdx.x, warp = tid / 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const long long qbase = ((long long)b * hq + h) * sq;
  const long long kbase = ((long long)b * hkv + hk) * skv;

  load_tile_bf16<DH>(ks, k + (kbase + k0) * DH, BK, skv - k0);
  const int col = tid % BK, half = tid / BK;   // 2 halves of the q rows
  const int kcol = k0 + col;
  float cm = 0.0f;
  // rows i >= k0 - off are the first to see any key of this tile
  const int first = causal ? max(0, k0 - off) / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int it = first; it < n_qt; ++it) {
    const int q0 = it * BQ;
    __syncthreads();               // the last tile's readers are done
    load_tile_bf16<DH>(qs, q + (qbase + q0) * DH, BQ, sq - q0);
    if (tid < BQ) lse_s[tid] = q0 + tid < sq ? lse[qbase + q0 + tid] : 0.0f;
    __syncthreads();
    scores_bf16_warp<DH>(qs, ks, ss, warp);
    __syncthreads();
    for (int rr = 0; rr < BQ / 2; ++rr) {
      const int r = half * (BQ / 2) + rr, qrow = q0 + r;
      if (qrow < sq && visible(qrow, kcol, skv, off, causal))
        cm = fmaxf(cm, expf(__fmul_rn(ss[r * SLD + col], scale) - lse_s[r]));
    }
  }
  red[half * BK + col] = cm;
  __syncthreads();
  if (tid < BK && k0 + tid < skv)
    out[((long long)b * hq + h) * skv + k0 + tid] =
        fmaxf(red[tid], red[BK + tid]);
}

template <int DH> struct ColmaxF32 {
  static constexpr int FLD = Dims<DH>::FLD;
  static constexpr size_t smem() {
    return ((size_t)BK * FLD + (size_t)BQ * FLD + BQ + 16 * (size_t)BK) * 4;
  }
};

template <int DH>
__global__ void __launch_bounds__(256)
colmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ lse, float* __restrict__ out,
                  int hq, int hkv, int sq, int skv, float scale, int causal) {
  constexpr int FLD = ColmaxF32<DH>::FLD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* qs = ks + BK * FLD;
  float* lse_s = qs + BQ * FLD;
  float* red = lse_s + BQ;         // [16][BK]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const long long qbase = ((long long)b * hq + h) * sq;
  const long long kbase = ((long long)b * hkv + hk) * skv;

  load_tile_f32<DH>(ks, k + (kbase + k0) * DH, BK, skv - k0, FLD);
  float cm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int first = causal ? max(0, k0 - off) / BQ : 0;
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int it = first; it < n_qt; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_tile_f32<DH>(qs, q + (qbase + q0) * DH, BQ, sq - q0, FLD);
    if (tid < BQ) lse_s[tid] = q0 + tid < sq ? lse[qbase + q0 + tid] : 0.0f;
    __syncthreads();
    float s[4][4];
    scores_f32<DH>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qrow = q0 + r;
      if (qrow >= sq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(qrow, k0 + tx + 16 * j, skv, off, causal))
          cm[j] = fmaxf(cm[j], expf(__fmul_rn(s[i][j], scale) - lse_s[r]));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * BK + tx + 16 * j] = cm[j];
  __syncthreads();
  if (tid < BK && k0 + tid < skv) {
    float mx = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) mx = fmaxf(mx, red[t * BK + tid]);
    out[((long long)b * hq + h) * skv + k0 + tid] = mx;
  }
}

template <int DH>
int colmax_bf16(const void* q, const void* k, const void* lse, void* out,
                dim3 grid, int hq, int hkv, int sq, int skv, float scale,
                int causal, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      colmax_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ColmaxBf16<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  colmax_bf16_kernel<DH><<<grid, 128, ColmaxBf16<DH>::smem(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)lse,
      (float*)out, hq, hkv, sq, skv, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int colmax_f32(const void* q, const void* k, const void* lse, void* out,
               dim3 grid, int hq, int hkv, int sq, int skv, float scale,
               int causal, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      colmax_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ColmaxF32<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  colmax_f32_kernel<DH><<<grid, 256, ColmaxF32<DH>::smem(), stream>>>(
      (const float*)q, (const float*)k, (const float*)lse, (float*)out, hq,
      hkv, sq, skv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Hq, Sq, dh], k: [B, Hkv, Skv, dh] (both bf16 or both f32), lse:
// [B, Hq, Sq] f32, out: [B, Hq, Skv] f32; all contiguous on the device,
// Hq % Hkv == 0, dh in {32, 64, 128}, Skv >= 1, bf16 pointers 16-byte
// aligned (the wrapper checks).  Launches on `stream`, allocates nothing,
// returns a cudaError_t.
extern "C" int attn_colmax_bf16(const void* q, const void* k, const void* lse,
                                void* out, int b, int hq, int hkv, int sq,
                                int skv, int dh, float scale, int causal,
                                void* stream) {
  const dim3 grid((skv + BK - 1) / BK, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return colmax_bf16<32>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
    case 64: return colmax_bf16<64>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
    case 128: return colmax_bf16<128>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int attn_colmax_f32(const void* q, const void* k, const void* lse,
                               void* out, int b, int hq, int hkv, int sq,
                               int skv, int dh, float scale, int causal,
                               void* stream) {
  const dim3 grid((skv + BK - 1) / BK, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return colmax_f32<32>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
    case 64: return colmax_f32<64>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
    case 128: return colmax_f32<128>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
