// Attention column max from (q, k, lse), without materialising A:
//
//   colmax[b,h,j] = max_i exp(s[i,j] - lse[b,h,i]),   s = q.k * scale,
//
// masked to 0 where query i does not see key j (causal diagonal offset by
// `off`: query i sees keys j <= i + off; skv - sq for the entry path, the
// rows' q_offset for MCA prefill's middle scoring pass), per query head,
// f32, or reduced over query heads into [B, Skv] (`reduce`).  For that pass
// (models/attention.py chunked_colmax, plain f32 PyTorch before) a [B, Skv]
// byte mask zeroes padding key columns and a [B, Sq] one leaves padding
// query rows out.
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
// What the bf16 design does about it (Hopper, sm_90a; attn_tile.cuh): the
// flash kernel's machinery with the roles of Q and K swapped.
//   * One block per (64-key tile, query head, batch): one consumer
//     warpgroup owns the 64 keys, one producer warp feeds it.  The key
//     tiles that see the most q tiles (the first ones, under a causal
//     mask) are launched first.
//   * The producer loads the K tile once by TMA, then streams the q tiles,
//     from the first one that the offset diagonal lets see the key tile
//     down to the last, through a ring of two stages: each Q tile by TMA,
//     its 64 lse values (times log2 e) stored by the producer's lanes
//     beside it, one mbarrier pair per stage (empty: one arrival per
//     consumer warp).
//   * S^T = K Q^T runs as wgmma m64n64k16, K the shared A operand and the Q
//     tile the shared B operand, the f32 accumulator in registers: each
//     thread holds 2 keys x 16 queries.  The column max over queries is a
//     row max of that accumulator: exp_score (exp2 of the score scaled by
//     scale * log2 e, minus lse * log2 e; the contract flash shares) on
//     every element, zeroed by a select where the query does not see the
//     key or lies past sq, folded into a running f32 max in registers,
//     one quad shuffle at the end, written once.
//   * wgmma does not specify its summation order, so this S^T and flash's
//     S may differ in the last bits of a product: within the 1e-3
//     tolerance of a value in [0, 1].
//   * Masks (attn_tile.cuh valid_bits): a key tile of padding alone
//     streams no q tile, a q tile of padding rows alone is skipped by every
//     warp alike, and the rest is a select per element.  With `reduce`
//     each key's column max over the block's head is folded into the
//     zeroed [B, Skv] output by one atomicMax on its bits (every value is
//     >= 0, so the int order is the float order): no [B, Hq, Skv] buffer
//     and no amax after it.
//   * q and k are read through 4-D tensor maps with their own strides (the
//     pass reads them where the model keeps them, [B, S, H, dh]).
//   * f32 inputs take the FMA path (attn_f32.cuh; 256 threads keep the
//     tile in registers and reduce their column maxima through shared
//     memory at the end).
//   * dh in {32, 64, 128}; swizzles as in flash_attention.cu.
//
// Telemetry (telemetry.cuh; null buffer: off) counts the score tiles the
// reference's kernel recomputes, in the caller's (block_q x block_k) units,
// the same tiles flash counts: one thread of each block (the bf16
// kernel's producer lane, once its loads are issued) adds those of its
// query head whose first key it holds (tel::attn_tiles_of_keys; tel_bq = 0
// where the reference falls back and counts none).
#include "attn_f32.cuh"
#include "telemetry.cuh"

namespace {

using namespace attn;

template <int DH> struct ColmaxCfg {
  static constexpr int BKEY = 64;           // keys per block
  static constexpr int BQ = 64;             // query rows per streamed tile
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 + 32;
  static constexpr int K_BYTES = Tile<DH>::rows_bytes(BKEY);
  static constexpr int Q_BYTES = Tile<DH>::rows_bytes(BQ);
  static constexpr size_t smem() {
    return 1024 + K_BYTES + (size_t)STAGES * Q_BYTES + STAGES * BQ * 4 +
           (1 + 2 * STAGES) * 8;
  }
};

struct ColArgs {
  const float* lse;      // [B, Hq, Sq] f32
  float* out;            // [B, Hq, Skv] f32, or [B, Skv] zeroed (reduce)
  const unsigned char* kv_valid;   // [B, Skv] key mask, or null: all valid
  const unsigned char* q_valid;    // [B, Sq] query mask, or null
  int hq, hkv, sq, skv;
  int off;               // query i sees keys j <= i + off (causal)
  int causal;
  int reduce;            // max over query heads into out [B, Skv]
  float scale_log2;
  int* tel_buf;
  int tel_bq, tel_bk;
};

template <int DH>
__global__ void __launch_bounds__(ColmaxCfg<DH>::THREADS)
colmax_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k, const ColArgs a) {
  using C = ColmaxCfg<DH>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* qs = ks + C::K_BYTES;      // stage s at qs + s Q_BYTES
  float* lse_s = reinterpret_cast<float*>(qs + ST * C::Q_BYTES);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(lse_s + ST * C::BQ);
  uint64_t* full = k_full + 1;
  uint64_t* empty = full + ST;

  const int k0 = blockIdx.z * C::BKEY, h = blockIdx.x, b = blockIdx.y;
  const int qh = b * a.hq + h, kh = h / (a.hq / a.hkv);
  const unsigned char* kvv =
      a.kv_valid == nullptr ? nullptr : a.kv_valid + (long long)b * a.skv;
  const unsigned char* qv =
      a.q_valid == nullptr ? nullptr : a.q_valid + (long long)b * a.sq;
  // rows i >= k0 - off are the first to see any key of this tile; a tile
  // of padding keys alone streams no q tile and writes 0
  const uint64_t kbits = valid_bits(kvv, k0, a.skv);
  const int first = a.causal ? max(0, k0 - a.off) / C::BQ : 0;
  const int n_qt = kbits ? (a.sq + C::BQ - 1) / C::BQ : first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 2);               // Q bytes + the lse stores
      mbar_init(&empty[s], 4);              // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Every warp walks the same q tiles: those from `first` that hold a
  // valid query row; n counts the tiles taken, which the ring follows.
  if (warp == 4) {                          // producer warp
    if (lane == 0) {
      mbar_expect_tx(k_full, C::K_BYTES);
      tma_tile<DH>(ks, &tm_k, k_full, C::BKEY, k0, kh, b);
    }
    for (int it = first, n = 0; it < n_qt; ++it) {
      const int q0 = it * C::BQ;
      if (valid_bits(qv, q0, a.sq) == 0) continue;
      const int s = n % ST;
      if (n >= ST) mbar_wait(&empty[s], ((n / ST) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], C::Q_BYTES);
        tma_tile<DH>(qs + s * C::Q_BYTES, &tm_q, &full[s], C::BQ, q0, h, b);
      }
      for (int i = lane; i < C::BQ; i += 32)
        lse_s[s * C::BQ + i] =
            q0 + i < a.sq ? a.lse[(long long)qh * a.sq + q0 + i] * LOG2E
                          : 0.0f;
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
      ++n;
    }
    // telemetry once every load is issued: off the consumers' path
    if (lane == 0)
      tel::record(a.tel_buf, k0 == 0 && h == 0 && b == 0, 1,
                  tel::attn_tiles_of_keys(k0, k0 + C::BKEY, a.tel_bq,
                                          a.tel_bk, a.sq, a.skv, a.causal));
    return;
  }

  // this thread's accumulator rows are keys k0 + r0 and k0 + r0 + 8, its
  // columns queries q0 + 8 j + c0 (+1)
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t kb = smem_u32(ks);
  // the first query each of this thread's two keys is seen by
  int lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lo[r] = a.causal ? k0 + r0 + 8 * r - a.off : 0;
  float acc[32], cm[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  mbar_wait(k_full, 0);
  for (int it = first, n = 0; it < n_qt; ++it) {
    const int q0 = it * C::BQ;
    const uint64_t qbits = valid_bits(qv, q0, a.sq);
    if (qbits == 0) continue;
    const int st = n % ST;
    mbar_wait(&full[st], (n / ST) & 1);
    ++n;
    const uint32_t qb = smem_u32(qs + st * C::Q_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tile<DH>::KSTEPS; ++kk)
      wgmma_ss_n64(acc, desc_kmajor<DH>(kb, C::BKEY, kk),
                   desc_kmajor<DH>(qb, C::BQ, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    const float* ls = lse_s + st * C::BQ;
    // no branch per element: query q0 + col counts for key row r when
    // lo[r] <= q0 + col and its bit is set in qbits (valid, below sq)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, col = (i >> 2) * 8 + c0 + (i & 1);
      const float e = exp_score(acc[i], a.scale_log2, ls[col]);
      cm[r] = fmaxf(cm[r], q0 + col >= lo[r] && ((qbits >> col) & 1) ? e
                                                                    : 0.0f);
    }
    warp_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
    const int key = k0 + r0 + 8 * r;
    if (lane % 4 || key >= a.skv) continue;
    // a padding key's column is 0
    const float v = (kbits >> (r0 + 8 * r)) & 1 ? cm[r] : 0.0f;
    if (!a.reduce)
      a.out[(long long)qh * a.skv + key] = v;
    else if (v > 0.0f)    // every value is >= 0: ordered as its int bits
      atomicMax(reinterpret_cast<int*>(a.out) + (long long)b * a.skv + key,
                __float_as_int(v));
  }
}

using namespace attn_f32;

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
                  int hq, int hkv, int sq, int skv, float scale, int causal,
                  int* __restrict__ tel_buf, int tel_bq, int tel_bk) {
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
  if (tid == 0)
    tel::record(tel_buf, k0 == 0 && h == 0 && b == 0, 1,
                tel::attn_tiles_of_keys(k0, k0 + BK, tel_bq, tel_bk, sq, skv,
                                        causal));

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

// qst, kst: the layouts of q and k.
template <int DH>
int colmax_bf16(const void* q, const void* k, Layout qst, Layout kst,
                const ColArgs& a, int b, cudaStream_t stream) {
  using C = ColmaxCfg<DH>;
  // sq == 0: no query sees any key, so colmax is 0; no Q tensor map can be
  // encoded over a dimension of 0
  if (a.sq == 0) {
    const cudaError_t e = cudaMemsetAsync(
        a.out, 0, (size_t)b * (a.reduce ? 1 : a.hq) * a.skv * sizeof(float),
        stream);
    return e != cudaSuccess ? (int)e : tel::mark(a.tel_buf, 1, stream);
  }
  CUtensorMap tq, tk;
  int e = make_map<DH>(&tq, q, b, a.hq, a.sq, qst, C::BQ);
  if (!e) e = make_map<DH>(&tk, k, b, a.hkv, a.skv, kst, C::BKEY);
  if (!e)
    e = (int)cudaFuncSetAttribute(colmax_bf16_kernel<DH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)C::smem());
  if (e) return e;
  const dim3 grid(a.hq, b, (a.skv + C::BKEY - 1) / C::BKEY);
  colmax_bf16_kernel<DH><<<grid, C::THREADS, C::smem(), stream>>>(tq, tk, a);
  return (int)cudaGetLastError();
}

template <int DH>
int colmax_f32(const void* q, const void* k, const void* lse, void* out,
               dim3 grid, int hq, int hkv, int sq, int skv, float scale,
               int causal, int* tel_buf, int tel_bq, int tel_bk,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      colmax_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ColmaxF32<DH>::smem());
  if (e != cudaSuccess) return (int)e;
  colmax_f32_kernel<DH><<<grid, 256, ColmaxF32<DH>::smem(), stream>>>(
      (const float*)q, (const float*)k, (const float*)lse, (float*)out, hq,
      hkv, sq, skv, scale, causal, tel_buf, tel_bq, tel_bk);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 kernel.  q: [B, Hq, Sq, dh] and k: [B, Hkv, Skv, dh] bf16, laid
// out as `strides` says (a row's, a head's and a batch's element strides of
// q, then of k; dh contiguous, every stride a multiple of 8, pointers
// 16-byte aligned); lse: [B, Hq, Sq] f32; out: [B, Hq, Skv] f32, or with
// `reduce` [B, Skv] f32 zeroed by the caller (the max over query heads,
// by atomics); all contiguous on the device.  kv_valid ([B, Skv]) and
// q_valid ([B, Sq]): bytes, nonzero where valid, or NULL; a padding key's
// column is 0 and a padding query row counts for no column.  Causal: query
// i sees keys j <= i + off.  Hq % Hkv == 0, dh in {32, 64, 128}, Skv >= 1
// (Sq may be 0: colmax 0).  tel, tel_bq, tel_bk as for attn_rows_bf16.
// Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int attn_colmax_bf16(const void* q, const void* k, const void* lse,
                                void* out, const void* kv_valid,
                                const void* q_valid, const long long* strides,
                                int b, int hq, int hkv, int sq, int skv,
                                int dh, int off, float scale, int causal,
                                int reduce, void* tel, int tel_bq, int tel_bk,
                                void* stream) {
  const Layout qst = {strides[0], strides[1], strides[2]};
  const Layout kst = {strides[3], strides[4], strides[5]};
  const ColArgs a = {(const float*)lse, (float*)out,
                     (const unsigned char*)kv_valid,
                     (const unsigned char*)q_valid, hq, hkv, sq, skv, off,
                     causal, reduce, log2_scale(scale), (int*)tel, tel_bq,
                     tel_bk};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return colmax_bf16<32>(q, k, qst, kst, a, b, st);
    case 64: return colmax_bf16<64>(q, k, qst, kst, a, b, st);
    case 128: return colmax_bf16<128>(q, k, qst, kst, a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The f32 kernel: q: [B, Hq, Sq, dh], k: [B, Hkv, Skv, dh], lse: [B, Hq,
// Sq], out: [B, Hq, Skv]; all contiguous f32 on the device, causal with the
// diagonal offset skv - sq, no masks, per head; otherwise as above.
extern "C" int attn_colmax_f32(const void* q, const void* k, const void* lse,
                               void* out, int b, int hq, int hkv, int sq,
                               int skv, int dh, float scale, int causal,
                               void* tel, int tel_bq, int tel_bk,
                               void* stream) {
  const dim3 grid((skv + BK - 1) / BK, hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  int* tb = (int*)tel;
  switch (dh) {
    case 32: return colmax_f32<32>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
    case 64: return colmax_f32<64>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
    case 128: return colmax_f32<128>(q, k, lse, out, grid, hq, hkv, sq, skv, scale, causal, tb, tel_bq, tel_bk, st);
  }
  return (int)cudaErrorInvalidValue;
}
