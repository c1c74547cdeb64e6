// Monte-Carlo block-sampled matmul, in two variants.
//
// Fixed (one sample list for all rows, one tier):
//   out = sum_k inv_rp[k] * x[:, s_k*B:(s_k+1)*B] @ w[s_k*B:(s_k+1)*B, :]
// Ragged (row tile t of bm = m / m_tiles rows has its own list and count):
//   out[t] = sum_{k < r_tile[t]} inv_rp[t,k] * x[t, s_tk block] @ w[s_tk block]
//
// Replaces: src/repro/kernels/mca_matmul.py::mca_matmul_fixed and
// ::mca_matmul_ragged (Pallas TPU kernels; scalar-prefetched sample ids
// drive the x/w BlockSpec index maps so only sampled blocks leave HBM, f32
// accumulator tile in VMEM; the ragged kernel skips the MXU work of samples
// k >= r_tile[t] with pl.when).
//
// What bounds it on an H100: bytes.  At the serve path's largest fixed
// shape (o_proj, m=128 rows, d=f=3072, B=128, R=4) it must read R*B*f*2 =
// 3.1 MB of sampled weight rows plus 0.9 MB of x and output for 0.4 GFLOP:
// about 100 FLOP per byte, a third of the ~295 FLOP/byte where bf16 tensor
// cores become the limit.  The floor is about 1.2 us at 3.35 TB/s.  The
// ragged kernel reads each row tile's own sampled w blocks, so its bytes
// grow with sum(r_tile) and it stays bound by bytes.  The serve path's
// calls are small (m 6..256, 2..24 output tiles of 128 columns), so the
// work has to be spread over many SMs to keep enough bytes in flight.
//
// What the bf16 design does about it (Hopper, sm_90a; hopper.cuh):
//   * One kernel serves both variants; the fixed one is a single row tile
//     whose samples are all live.  A block owns 64 rows and 128 output
//     columns (one consumer warpgroup, one producer warp) and never spans
//     two row tiles: their sample lists differ.  Blocks of 128 rows (two
//     consumer warpgroups, each sampled w block read once per 128 rows)
//     were timed slower at every shape above 64 rows (PERF.md): the
//     blocks of a call run together, so the second read of a w block
//     comes from L2.
//   * The gather is a TMA coordinate, as the Pallas index map reads s[k]:
//     a 3-D tensor map over x [m_tiles, bm, d] gives the sampled column
//     block as boxes at column s_k*B (64 columns with the 128-byte
//     swizzle; 32 and the 64-byte swizzle where B is not a multiple of
//     64), a map over w [d, f] the sampled row block as boxes of two
//     64-column panels at row s_k*B.  Rows past the row tile and columns
//     past f arrive as zeros and are never stored.  Blocks read idx,
//     inv_rp and r_tile[t] from device memory themselves (no host sync).
//   * One producer warp walks the block's (sample, 64-deep chunk) stages,
//     skipping ids outside [0, d/B) (a duplicate id counts each time),
//     and keeps them in flight through a ring of 4 mbarrier-guarded
//     stages; each consumer warp frees a stage with one arrival.  Each
//     warp reads the ids (and weights) of 32 stages in one load, a lane
//     each, so the walk does not wait on device memory per stage.
//   * Products on wgmma m64n128k16: x the K-major A operand, w the B
//     operand with N contiguous (transpose bit), as flash reads V.  Each
//     stage's product goes to a partial accumulator in registers (scale-d
//     0 on its first k16 step), then acc += inv_rp[k] * part in f32, as
//     the Pallas kernel adds scale * contrib.  The output is rounded to
//     bf16 once.
//   * The grid fills the card by splitting the stages over the blocks of
//     a thread block cluster (up to 8, the grid's z axis): the host picks
//     the fewest blocks per cluster that give each block the fewest
//     stages the card's SMs allow.  Block q of a cluster sums a 1/cs
//     share of the tile's rows: every block sends those rows of its f32
//     partial tile to block q's shared memory (distributed shared memory,
//     stores that do not wait), and after one cluster barrier block q
//     adds what it received in rank order (no atomics: a fixed order, so
//     every run gives the same bits) and stores bf16 in 16-byte writes.
//     A block with no stage (ragged r_tile[t] small) loads and sends
//     nothing.  Without a split the accumulator goes from registers to
//     bf16 and out in 16-byte writes (a 4 x 4 transpose inside each quad
//     of lanes), with no staging.  Distributed shared memory moves bytes
//     far more slowly than TMA brings them in, so the split pays only
//     where the stages it spreads cost more than the partial rows it
//     sends.
//   * r_tile[t] is clamped to [0, R_max]; a tile with no sample gives zero
//     rows.
// Not done: TMA multicast of a w block across the row chunks of a cluster,
// so a call of more than 64 rows reads each sampled w block once per 64
// rows (the repeats mostly from L2).
//
// f32 inputs take a plain FMA path (256 threads, 64 x 64 output tiles,
// each thread 4 x 4 outputs); it is on no timed path.
//
// Telemetry (telemetry.cuh; null buffer: off) counts sampled blocks in the
// reference's units, one per (reference row tile, sample) it accumulates:
// the first block of each row tile (column tile 0, first 64-row chunk,
// cluster rank 0) adds tel_mul x its tile's clamped count r, or, with
// tel_raw, tel_mul x r_tile[t] as given.  The wrapper passes tel_mul = the
// reference's row tiles for the fixed kernel where its Pallas kernel takes
// the shape (1 where it falls back: its dense path counts R), and tel_raw
// for a ragged call the reference sends to its fallback, which sums r_tile
// unclamped.  The split over a cluster and the column tiles therefore
// count nothing twice.
#include "hopper.cuh"
#include "telemetry.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------------ bf16
struct Mma {
  static constexpr int BM = 64;           // output rows per block
  static constexpr int BN = 128;          // output columns per block
  static constexpr int PANEL = 64;        // columns per w box (128-byte rows)
  static constexpr int STAGES = 4;
  static constexpr int THREADS = 128 + 32;   // consumer warpgroup + producer
  static constexpr int MAX_CLUSTER = 8;   // the portable cluster size
  static constexpr int RED_LD = BN + 8;   // floats per partial-tile row
  // One ring stage: the x tile, then both w panels.
  __host__ __device__ static constexpr int stage_bytes(int kc) {
    return BM * kc * 2 + kc * BN * 2;
  }
  // The partial rows a block receives in a cluster of cs: from each block
  // of the cluster, the ceil(BM / cs) rows that this block sums.
  __host__ __device__ static constexpr int red_bytes(int cs) {
    return cs > 1 ? cs * ((BM + cs - 1) / cs) * RED_LD * 4 : 0;
  }
  static constexpr size_t smem(int kc, int cs) {
    return 1024 + (size_t)STAGES * stage_bytes(kc) + red_bytes(cs) +
           2 * STAGES * 8;
  }
};

// K-major A operand (x tile: rows of KC bf16, swizzled 128 bytes for KC 64
// and 64 bytes for KC 32) at k16 step kk: 32 bytes per step inside the
// row, 8-row groups 8 rows apart.
template <int KC>
__device__ __forceinline__ uint64_t x_desc(uint32_t base, int kk) {
  return make_desc(base + kk * 32, 16, 8 * KC * 2, KC == 64 ? 1 : 2);
}

// N-major B operand (w tile: KC rows of two 64-column panels with 128-byte
// rows and the 128-byte swizzle) for rows 16 kk..16 kk+15: 8-row groups 8
// rows apart (SBO), the panels KC rows apart (LBO).
template <int KC>
__device__ __forceinline__ uint64_t w_desc(uint32_t base, int kk) {
  return make_desc(base + kk * 16 * 128, KC * 128, 8 * 128, 1);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Grid: x = 128-column tiles, y = (row tile t, 64-row chunk of it), z =
// the cluster's split of the stages.
template <int KC>
__global__ void __launch_bounds__(Mma::THREADS)
mca_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w,
                const int* __restrict__ r_tile,   // null: fixed, r = r_max
                const int* __restrict__ idx,
                const float* __restrict__ inv_rp,
                __nv_bfloat16* __restrict__ out, int bm, int f, int r_max,
                int block, int nblocks, int* __restrict__ tel_buf,
                int tel_mul, int tel_raw) {
  constexpr int ST = Mma::STAGES, BM = Mma::BM, BN = Mma::BN;
  constexpr int LD = Mma::RED_LD, X_BYTES = BM * KC * 2;
  constexpr int STAGE = Mma::stage_bytes(KC);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const int cs = gridDim.z;
  float* red = reinterpret_cast<float*>(base + ST * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * STAGE +
                                               Mma::red_bytes(cs));
  uint64_t* empty = full + ST;

  const int chunks = (bm + BM - 1) / BM;
  const int t = blockIdx.y / chunks;
  const int row0 = (blockIdx.y % chunks) * BM;       // inside tile t
  const int rows = min(BM, bm - row0);               // rows to store
  const int n0 = blockIdx.x * BN;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int r = r_tile ? max(0, min(r_tile[t], r_max)) : r_max;
  if (threadIdx.x == 0 && blockIdx.x == 0 && row0 == 0 && blockIdx.z == 0)
    tel::record(tel_buf, blockIdx.y == 0, 1,
                tel_mul * (tel_raw ? r_tile[t] : r));
  const int cps = block / KC;                  // chunks per sample
  const int n_st = r * cps;                    // stages of this row tile
  const int live = min(cs, n_st);              // blocks with a stage
  const int* sid = idx + (long long)t * r_max;
  const float* sw = inv_rp + (long long)t * r_max;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The block's stages are j = rank, rank + cs, ... < n_st: (sample j /
  // cps, chunk j % cps).  Each warp reads the ids and weights of 32 stages
  // in one load, lane i those of the i-th, and walks them in order; the
  // first 32 are read before the barriers are set up, to overlap it.
  int jl = rank + lane * cs;
  int s_l = jl < n_st ? sid[jl / cps] : -1;
  float w_l = jl < n_st ? sw[jl / cps] : 0.0f;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                 // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (cs > 1) cluster_arrive_relaxed();        // this block has started

  if (warp == 4) {                             // producer warp
    const int panels = f - n0 > Mma::PANEL ? 2 : 1;
    const uint32_t bytes = X_BYTES + panels * KC * Mma::PANEL * 2;
    int it = 0;
    for (int j0 = rank; j0 < n_st; j0 += 32 * cs) {
      if (j0 != rank) {
        jl = j0 + lane * cs;
        s_l = jl < n_st ? sid[jl / cps] : -1;
      }
      const int n = min(32, (n_st - j0 + cs - 1) / cs);
      for (int i = 0; i < n; ++i) {
        const int s = __shfl_sync(0xffffffffu, s_l, i);
        if (s < 0 || s >= nblocks) continue;
        if (lane == 0) {
          const int slot = it % ST;
          if (it >= ST) mbar_wait(&empty[slot], ((it / ST) - 1) & 1);
          mbar_expect_tx(&full[slot], bytes);
          unsigned char* st = base + slot * STAGE;
          const int col = s * block + ((j0 + i * cs) % cps) * KC;
          tma_load_3d(st, &tm_x, &full[slot], col, row0, t);
          for (int p = 0; p < panels; ++p)
            tma_load_3d(st + X_BYTES + p * KC * Mma::PANEL * 2, &tm_w,
                        &full[slot], n0 + p * Mma::PANEL, col, 0);
        }
        ++it;
      }
    }
    __syncwarp();
    if (cs > 1) {                              // the consumers' two barriers
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // consumer warpgroup: rows 16 warp + lane / 4 (+ 8) of the block,
  // columns n0 + 8 j + 2 (lane % 4) (+ 1) in its accumulators
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    part[i] = 0.0f;
  }
  int it = 0;
  for (int j0 = rank; j0 < n_st; j0 += 32 * cs) {
    if (j0 != rank) {
      jl = j0 + lane * cs;
      s_l = jl < n_st ? sid[jl / cps] : -1;
      w_l = jl < n_st ? sw[jl / cps] : 0.0f;
    }
    const int n = min(32, (n_st - j0 + cs - 1) / cs);
    for (int i = 0; i < n; ++i) {
      const int s = __shfl_sync(0xffffffffu, s_l, i);
      const float sc = __shfl_sync(0xffffffffu, w_l, i);
      if (s < 0 || s >= nblocks) continue;
      const int slot = it % ST;
      mbar_wait(&full[slot], (it / ST) & 1);
      const uint32_t xa = smem_u32(base + slot * STAGE);
      const uint32_t wb = xa + X_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_ss_n128_tb(part, x_desc<KC>(xa, kk), w_desc<KC>(wb, kk),
                         kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(part);
      warp_arrive(&empty[slot]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = fmaf(sc, part[e], acc[e]);
      ++it;
    }
  }

  const int q = lane % 4;
  const int r_base = 16 * warp + lane / 4;
  __nv_bfloat16* out_t = out + ((long long)t * bm + row0) * f;
  if (cs == 1) {
    // bf16 pairs -> 16-byte rows of 8 columns: lane q of each quad takes
    // column group 4 g + q from the four lanes of the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = r_base + 8 * h;
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        uint32_t p[4], v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = pack_bf16(acc[4 * (4 * g + e) + 2 * h],
                           acc[4 * (4 * g + e) + 2 * h + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t got = __shfl_sync(0xffffffffu, pick4(p, (q - i) & 3),
                                           (lane & ~3) | ((q + i) & 3));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e == ((q + i) & 3)) v[e] = got;
        }
        const int col = n0 + 8 * (4 * g + q);
        if (lr < rows && col < f)
          *reinterpret_cast<uint4*>(out_t + (long long)lr * f + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    return;
  }

  // Split: block q of the cluster sums rows [R0(q), R0(q + 1)) of the
  // tile, R0(q) = ceil(q rows / cs).  Every block with a stage sends each
  // of its f32 partial rows to the block that sums it (slot `rank` of that
  // block's buffer); after the cluster barrier each block adds its slots
  // in rank order (a fixed order: the same bits on every run) and stores
  // bf16 in 16-byte writes.
  const int rows_per = (BM + cs - 1) / cs;
  cluster_wait();                              // every block has started
  if (rank < live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = r_base + 8 * h;
      if (lr < rows) {
        const int owner = lr * cs / rows;
        const int local = lr - (owner * rows + cs - 1) / cs;
        const uint32_t dst = map_rank(
            smem_u32(red + (rank * rows_per + local) * LD + 2 * q), owner);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          st_cluster_f2(dst + 32 * jj, acc[4 * jj + 2 * h],
                        acc[4 * jj + 2 * h + 1]);
      }
    }
  }
  cluster_arrive();
  cluster_wait();
  const int r_lo = (rank * rows + cs - 1) / cs;
  const int units = ((rank + 1) * rows + cs - 1) / cs * (BN / 8) -
                    r_lo * (BN / 8);
  for (int u = threadIdx.x; u < units; u += 128) {
    const int local = u / (BN / 8), cg = u % (BN / 8);
    const int col = n0 + 8 * cg;
    if (col >= f) continue;
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = 0.0f;
    for (int b = 0; b < live; ++b) {
      const float4* src = reinterpret_cast<const float4*>(
          red + (b * rows_per + local) * LD + 8 * cg);
      const float4 v0 = src[0], v1 = src[1];
      sum[0] += v0.x; sum[1] += v0.y; sum[2] += v0.z; sum[3] += v0.w;
      sum[4] += v1.x; sum[5] += v1.y; sum[6] += v1.z; sum[7] += v1.w;
    }
    *reinterpret_cast<uint4*>(out_t + (long long)(r_lo + local) * f + col) =
        make_uint4(pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]),
                   pack_bf16(sum[4], sum[5]), pack_bf16(sum[6], sum[7]));
  }
}

// Blocks per cluster: the fewest that give each block the fewest stages
// that the card's SMs allow (one block per SM) for `tiles` output tiles.
int cluster_size(int tiles, int n_st) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;                                 // an H100 SXM
    return n;
  }();
  if (n_st <= 1) return 1;
  int cap = sms / tiles;
  cap = cap < 1 ? 1 : cap > Mma::MAX_CLUSTER ? Mma::MAX_CLUSTER : cap;
  if (cap > n_st) cap = n_st;
  const int per = (n_st + cap - 1) / cap;
  return (n_st + per - 1) / per;
}

template <int KC>
int mca_bf16(const void* x, const void* w, const void* r_tile,
             const void* idx, const void* inv_rp, void* out, int m_tiles,
             int bm, int d, int f, int r_max, int block, int* tel_buf,
             int tel_mul, int tel_raw, cudaStream_t stream) {
  const int chunks = (bm + Mma::BM - 1) / Mma::BM;
  const int col_tiles = (f + Mma::BN - 1) / Mma::BN;
  const int cs = cluster_size(col_tiles * m_tiles * chunks,
                              r_max * (block / KC));
  const size_t smem = Mma::smem(KC, cs);
  CUtensorMap tx, tw;
  int e = make_map_bf16(&tx, x, m_tiles, bm, d, KC, Mma::BM);
  if (!e) e = make_map_bf16(&tw, w, 1, d, f, Mma::PANEL, KC);
  if (!e)
    e = (int)cudaFuncSetAttribute(mca_bf16_kernel<KC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, m_tiles * chunks, cs);
  cfg.blockDim = dim3(Mma::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, mca_bf16_kernel<KC>, tx, tw, (const int*)r_tile, (const int*)idx,
      (const float*)inv_rp, (__nv_bfloat16*)out, bm, f, r_max, block,
      d / block, tel_buf, tel_mul, tel_raw);
}

int mca_bf16_any(const void* x, const void* w, const void* r_tile,
                 const void* idx, const void* inv_rp, void* out, int m_tiles,
                 int bm, int d, int f, int r_max, int block, void* tel,
                 int tel_mul, int tel_raw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (block % 64 == 0)
    return mca_bf16<64>(x, w, r_tile, idx, inv_rp, out, m_tiles, bm, d, f,
                        r_max, block, (int*)tel, tel_mul, tel_raw, st);
  return mca_bf16<32>(x, w, r_tile, idx, inv_rp, out, m_tiles, bm, d, f,
                      r_max, block, (int*)tel, tel_mul, tel_raw, st);
}

// ------------------------------------------------------------------- f32
constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output cols per block
constexpr int FKC = 16;       // block columns staged per step (f32)

// f32 variant of the tile: 256 threads, each owns 4x4 outputs.
__device__ __forceinline__ void mca_tile_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ idx, const float* __restrict__ inv_rp,
    float* __restrict__ out, int r, int row0, int row_end, int n0, int d,
    int f, int block, float (*xs)[BM + 1], float (*ws)[BN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nblocks = d / block;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < r; ++k) {
    const int s = idx[k];
    if (s < 0 || s >= nblocks) continue;
    const float sc = inv_rp[k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    for (int kc = 0; kc < block; kc += FKC) {
      const long long col0 = (long long)s * block + kc;
      for (int v = tid; v < BM * FKC; v += blockDim.x) {
        const int row = v / FKC, c = v % FKC;
        xs[c][row] = (row0 + row < row_end)
                         ? x[(long long)(row0 + row) * d + col0 + c]
                         : 0.0f;
      }
      for (int v = tid; v < FKC * BN; v += blockDim.x) {
        const int row = v / BN, c = v % BN;
        ws[row][c] = (n0 + c < f) ? w[(col0 + row) * (long long)f + n0 + c]
                                  : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FKC; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += sc * part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f) out[(long long)row * f + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(256)
mca_fixed_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ idx,
                     const float* __restrict__ inv_rp, float* __restrict__ out,
                     int m, int d, int f, int r, int block,
                     int* __restrict__ tel_buf, int tel_mul) {
  __shared__ float xs[FKC][BM + 1];   // transposed x tile
  __shared__ float ws[FKC][BN];
  const int m0 = blockIdx.y * BM;
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    tel::record(tel_buf, true, 1, tel_mul * r);
  mca_tile_f32(x, w, idx, inv_rp, out, r, m0, min(m0 + BM, m),
               blockIdx.x * BN, d, f, block, xs, ws);
}

// Ragged grid row y -> (row tile t, its rows [row0, row_end), its sample
// count r clamped to [0, r_max]).
__device__ __forceinline__ void ragged_rows(const int* __restrict__ r_tile,
                                            int bm, int r_max, int* t,
                                            int* row0, int* row_end, int* r) {
  const int chunks = (bm + BM - 1) / BM;
  *t = blockIdx.y / chunks;
  *row0 = *t * bm + (blockIdx.y % chunks) * BM;
  *row_end = min(*row0 + BM, (*t + 1) * bm);
  *r = max(0, min(r_tile[*t], r_max));
}

__global__ void __launch_bounds__(256)
mca_ragged_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const int* __restrict__ r_tile,
                      const int* __restrict__ idx,
                      const float* __restrict__ inv_rp,
                      float* __restrict__ out,
                      int d, int f, int bm, int r_max, int block,
                      int* __restrict__ tel_buf, int tel_raw) {
  __shared__ float xs[FKC][BM + 1];
  __shared__ float ws[FKC][BN];
  int t, row0, row_end, r;
  ragged_rows(r_tile, bm, r_max, &t, &row0, &row_end, &r);
  if (threadIdx.x == 0 && blockIdx.x == 0 && row0 == t * bm)
    tel::record(tel_buf, blockIdx.y == 0, 1, tel_raw ? r_tile[t] : r);
  const long long s0 = (long long)t * r_max;
  mca_tile_f32(x, w, idx + s0, inv_rp + s0, out, r, row0, row_end,
               blockIdx.x * BN, d, f, block, xs, ws);
}

dim3 ragged_grid(int m_tiles, int bm, int f) {
  return dim3((f + BN - 1) / BN, m_tiles * ((bm + BM - 1) / BM));
}

}  // namespace

// x: [m, d], w: [d, f], out: [m, f], all contiguous, same dtype (bf16);
// idx: [r] int32, inv_rp: [r] f32, on the device.  Needs d % block == 0,
// block % 32 == 0, f % 8 == 0 and 16-byte aligned x/w/out (the wrapper
// checks).  tel: a zeroed [1, 8] int32 telemetry buffer or NULL; tel_mul:
// the sampled blocks each sample counts (see the top of this file).
// Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int mca_matmul_fixed_bf16(const void* x, const void* w,
                                     const void* idx, const void* inv_rp,
                                     void* out, int m, int d, int f, int r,
                                     int block, void* tel, int tel_mul,
                                     void* stream) {
  return mca_bf16_any(x, w, nullptr, idx, inv_rp, out, 1, m, d, f, r, block,
                      tel, tel_mul, 0, stream);
}

// f32 variant: needs d % block == 0 and block % 16 == 0.
extern "C" int mca_matmul_fixed_f32(const void* x, const void* w,
                                    const void* idx, const void* inv_rp,
                                    void* out, int m, int d, int f, int r,
                                    int block, void* tel, int tel_mul,
                                    void* stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  mca_fixed_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)idx, (const float*)inv_rp,
      (float*)out, m, d, f, r, block, (int*)tel, tel_mul);
  return (int)cudaGetLastError();
}

// Ragged, bf16.  x: [m, d], w: [d, f], out: [m, f] with m = m_tiles * bm;
// r_tile: [m_tiles] int32; idx: [m_tiles, r_max] int32; inv_rp:
// [m_tiles, r_max] f32; all contiguous on the device.  The same needs as
// the fixed bf16 kernel.  tel as above; tel_raw counts r_tile unclamped.
extern "C" int mca_matmul_ragged_bf16(const void* x, const void* w,
                                      const void* r_tile, const void* idx,
                                      const void* inv_rp, void* out,
                                      int m_tiles, int bm, int d, int f,
                                      int r_max, int block, void* tel,
                                      int tel_raw, void* stream) {
  return mca_bf16_any(x, w, r_tile, idx, inv_rp, out, m_tiles, bm, d, f,
                      r_max, block, tel, 1, tel_raw, stream);
}

// Ragged, f32: needs d % block == 0 and block % 16 == 0.
extern "C" int mca_matmul_ragged_f32(const void* x, const void* w,
                                     const void* r_tile, const void* idx,
                                     const void* inv_rp, void* out,
                                     int m_tiles, int bm, int d, int f,
                                     int r_max, int block, void* tel,
                                     int tel_raw, void* stream) {
  mca_ragged_f32_kernel<<<ragged_grid(m_tiles, bm, f), 256, 0,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)r_tile, (const int*)idx,
      (const float*)inv_rp, (float*)out, d, f, bm, r_max, block, (int*)tel,
      tel_raw);
  return (int)cudaGetLastError();
}
