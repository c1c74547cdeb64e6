// MCA's tiered routing of one projection, in one launch:
//
//   r_cols[i]  = clamp((seq_len * imp[i] / alpha)^2, 1, d)       (Eq. 9)
//   r_blocks[i] = max(ceil(r_cols[i] / block), 1)
//   tier[i]    = min(#{rungs of the ladder below r_blocks[i]}, T - 1)
//   order      = tokens by descending importance, ties in token order
//   for t = T-1 .. 1: the tier-t tokens at rank >= caps[t] in that order
//                     drop to tier t-1                (capacity demotion)
//   rank[i]    = i's rank among its final tier's tokens in that order
//   hist[t]    = tokens in tier t;  flops = sum_t hist[t] * tier_flops[t]
//   mean       = mean of r_blocks
//
// the integers core/dispatch.py's plain version (schedule.*,
// apply_capacity, _rank_within_tier, tier_histogram) computes with seven
// argsorts and about 200 launches.
//
// Replaces no TPU kernel: the reference routes in jnp, which XLA fuses.
// Eager PyTorch runs each of those ops as a launch of its own; on the card
// the routing of a starcoder2-3b insertion took 12,360 launches and its
// one-hot scans over [n, 4] ran in int64, the longest device item of the
// insertion.
//
// What bounds it on an H100: latency.  A projection routes at most a few
// thousand tokens (4,160 in the benchmark's cells): 16 KB of importances
// in, 33 KB of tiers and ranks out, nanoseconds of bytes.  Its work is one
// sort and a few scans, each step waiting on the one before, so the time
// is the sort's dependent steps: 66 to 91 bitonic steps of a block barrier
// each, 0.5 to 1 us a step on the card (33, 59 and 94 us a call at 2,048,
// 4,040 and 4,160 tokens), against about 0.9 ms for the plain version.
// Not done: the sort's steps narrower than a warp in registers and
// shuffles, which would leave barriers only to the wider ones.
//
// What the design does about it: one block of 1,024 threads holds the
// whole routing; several blocks would have to meet in device memory
// between every step of the sort and the cascade, and the routing is too
// small to fill the card anyway.
//   * The sort key is the token's 32-bit order key in the high half and
//     its index in the low half: keys are unique, so a bitonic sort (not
//     stable by itself) gives the stable order.  The keys sit in shared
//     memory, padded to a power of two (64 KB for the cells' 4,160
//     tokens, up to 16,384 tokens); past that the same code sorts in a
//     scratch buffer the wrapper allocates, at device-memory speed.
//   * The order key gives torch.argsort(-imp, stable=True)'s order on the
//     card, which is a float compare at every size: -0.0 ties +0.0, and
//     every NaN sorts after +inf, in token order (its radix sort takes
//     -0.0 as +0.0, and its negation makes every NaN the positive
//     canonical one).
//   * After the sort each key's high half is the token's tier.  Each
//     thread owns a contiguous run of sorted positions; a tier's ranks are
//     one block-wide exclusive scan of the runs' counts (warp shuffles and
//     one shared array), so the cascade and the final ranks take T scans:
//     a tier's ranks at its own step are final, since the tokens it keeps
//     come before those it demotes and lower steps never touch it.
//   * Eq. 9 mirrors PyTorch's float32 rounding on the card step by step:
//     products with __fmul_rn, a division by a host scalar as PyTorch's
//     CUDA division does it (a product with the reciprocal, rounded on the
//     host), NaN kept by the clamps, float -> int32 by cvt.rzi (NaN -> 0).
//     The mean is PyTorch's on the card: the (exact) sum times 1/n.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TIERS = 8;
constexpr int SMEM_KEYS = 16384;        // keys sorted in shared memory

struct Params {
  int n;                                // tokens
  int n_tiers;
  unsigned pad;                         // power of two >= n
  float seq_len;                        // Eq. 9's n
  float inv_alpha;                      // fl(1 / fl(alpha))
  float d;                              // r_cols's upper clamp
  float inv_block;                      // fl(1 / block)
  float inv_count;                      // fl(1 / n), torch.mean's factor
  int ladder[MAX_TIERS];
  int caps[MAX_TIERS];
  long long tier_flops[MAX_TIERS];      // 2 * r_t * block * f
};

// Ascending order of these keys is argsort(-imp, stable=True)'s order.
__device__ __forceinline__ uint32_t order_key(float imp) {
  const float k = -imp;
  uint32_t b = __float_as_uint(k);
  if (isnan(k)) b = 0x7fffffffu;                   // after +inf, all equal
  if (b == 0x80000000u) b = 0u;                    // -0.0 ties +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ int key_tier(unsigned long long key) {
  return (int)(key >> 32);
}

__device__ __forceinline__ int key_token(unsigned long long key) {
  return (int)(key & 0xffffffffu);
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[WARPS - 1];
  __syncthreads();                      // warp_sums is reused next call
  return before;
}

__global__ void __launch_bounds__(THREADS, 1)
mca_route_kernel(const float* __restrict__ imp, Params p,
                 unsigned long long* __restrict__ spill,
                 int* __restrict__ tier, int* __restrict__ rank,
                 long long* __restrict__ stats, float* __restrict__ mean) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ int warp_sums[WARPS];
  __shared__ long long warp_r[WARPS];
  unsigned long long* keys = spill != nullptr ? spill : smem_keys;
  const int tid = threadIdx.x, n = p.n, T = p.n_tiers;

  // Eq. 9 and the unrouted tier; tier[] holds it until the sort is done
  long long r_sum = 0;
  for (int i = tid; i < (int)p.pad; i += THREADS) {
    if (i >= n) {
      keys[i] = ~0ull;                  // padding sorts last
      continue;
    }
    const float v = imp[i];
    const float s = __fmul_rn(__fmul_rn(v, p.seq_len), p.inv_alpha);
    float r = __fmul_rn(s, s);
    r = isnan(r) ? r : fminf(fmaxf(r, 1.0f), p.d);
    float rb = ceilf(__fmul_rn(r, p.inv_block));
    rb = isnan(rb) ? rb : fmaxf(rb, 1.0f);
    const int r_blocks = (int)rb;       // cvt.rzi.s32.f32: NaN -> 0
    int t = 0;
    for (int k = 0; k < T; ++k) t += r_blocks > p.ladder[k];
    tier[i] = t < T - 1 ? t : T - 1;
    r_sum += r_blocks;
    keys[i] = ((unsigned long long)order_key(v) << 32) |
              (unsigned)i;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r_sum += __shfl_down_sync(0xffffffffu, r_sum, o);
  if ((tid & 31) == 0) warp_r[tid >> 5] = r_sum;
  __syncthreads();

  // bitonic sort of the padded keys, ascending
  for (unsigned k = 2; k <= p.pad; k <<= 1) {
    for (unsigned j = k >> 1; j > 0; j >>= 1) {
      for (unsigned i = tid; i < p.pad / 2; i += THREADS) {
        const unsigned lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const unsigned hi = lo + j;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // each thread's run of sorted positions; the key's high half becomes
  // the token's tier
  const int per = (n + THREADS - 1) / THREADS;
  const int p0 = min(n, tid * per), p1 = min(n, p0 + per);
  for (int q = p0; q < p1; ++q) {
    const int i = key_token(keys[q]);
    keys[q] = ((unsigned long long)tier[i] << 32) | (unsigned)i;
  }

  // the cascade, tier T-1 down to 0: ranks in order, overflow demoted
  long long hist[MAX_TIERS];
  for (int t = T - 1; t >= 0; --t) {
    int count = 0;
    for (int q = p0; q < p1; ++q) count += key_tier(keys[q]) == t;
    int total;
    int r = block_exclusive_scan(count, &total, warp_sums);
    const int cap = t > 0 ? p.caps[t] : 0x7fffffff;
    for (int q = p0; q < p1; ++q) {
      const unsigned long long key = keys[q];
      if (key_tier(key) != t) continue;
      if (r >= cap)
        keys[q] = key - (1ull << 32);               // to tier t - 1
      else
        rank[key_token(key)] = r;
      ++r;
    }
    hist[t] = total < cap ? total : (cap > 0 ? cap : 0);
  }
  for (int q = p0; q < p1; ++q)
    tier[key_token(keys[q])] = key_tier(keys[q]);

  if (tid == 0) {
    long long flops = 0, total_r = 0;
    for (int t = 0; t < T; ++t) {
      stats[t] = hist[t];
      flops += hist[t] * p.tier_flops[t];
    }
    stats[T] = flops;
    for (int w = 0; w < WARPS; ++w) total_r += warp_r[w];
    *mean = __fmul_rn((float)total_r, p.inv_count);
  }
}

}  // namespace

// imp: [n] f32 importances on the device; tier, rank: [n] int32 outputs;
// stats: [n_tiers + 1] int64 output (the tier histogram, then the FLOPs);
// mean: one f32 output (mean r_blocks).  ladder, caps, tier_flops: host
// arrays of n_tiers (<= 8) entries.  spill: a device buffer of `pad` u64
// when pad > 16,384, else NULL (the keys stay in shared memory).
// seq_len, inv_alpha, d, inv_block, inv_count: float32 values rounded on
// the host as PyTorch rounds them (see the note above).  Launches one
// block on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mca_route(const void* imp, int n, int n_tiers,
                         unsigned pad, float seq_len, float inv_alpha,
                         float d, float inv_block, float inv_count,
                         const int* ladder, const int* caps,
                         const long long* tier_flops, void* spill, void* tier,
                         void* rank, void* stats, void* mean, void* stream) {
  if (n_tiers < 1 || n_tiers > MAX_TIERS) return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.n_tiers = n_tiers;
  p.pad = pad;
  p.seq_len = seq_len;
  p.inv_alpha = inv_alpha;
  p.d = d;
  p.inv_block = inv_block;
  p.inv_count = inv_count;
  for (int t = 0; t < MAX_TIERS; ++t) {
    p.ladder[t] = t < n_tiers ? ladder[t] : 0;
    p.caps[t] = t < n_tiers ? caps[t] : 0;
    p.tier_flops[t] = t < n_tiers ? tier_flops[t] : 0;
  }
  size_t smem = 0;
  if (spill == nullptr) {
    // set on every launch: the opt-in belongs to the current device
    const cudaError_t e = cudaFuncSetAttribute(
        mca_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_KEYS * (int)sizeof(unsigned long long));
    if (e != cudaSuccess) return (int)e;
    smem = (size_t)pad * sizeof(unsigned long long);
  }
  mca_route_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)imp, p, (unsigned long long*)spill, (int*)tier,
      (int*)rank, (long long*)stats, (float*)mean);
  return (int)cudaGetLastError();
}
