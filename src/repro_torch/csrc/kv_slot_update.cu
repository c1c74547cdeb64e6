// Per-row KV-cache writes of one decode step, one launch per layer:
//
//   slot[b] = window > 0 ? t[b] mod S : t[b]
//   k_cache[b, slot[b]] = k_new[b, 0];  v_cache[b, slot[b]] = v_new[b, 0]
//   slot_pos[b, slot[b]] = t[b]                      (when slot_pos is given)
//
// and, with no second cache and no slot_pos, the reference's entry point
// cache[b, pos[b]] = new[b, 0].
//
// Replaces: src/repro/kernels/cache_update.py::kv_slot_update (Pallas TPU
// kernel; scalar-prefetched pos folded into the output BlockSpec, cache
// buffer aliased to the output) together with the three writes the
// reference's gqa_decode makes around it (src/repro/models/attention.py,
// the K and V kernel calls and the slot_pos scatter), which cost nothing
// extra under jit but a launch and a host call each in eager PyTorch.
//
// What bounds it on an H100: launch latency and the host's time to issue
// the call, not bytes.  At the serve shape (B = 4, K and V rows of
// 2 x 128 bf16, slot_pos [4, 512] int32) one call reads 4 KB of new K
// and V rows and 16 B of t, and writes 4 KB of cache rows and 16 B of
// slot_pos: about 2.5 ns at the card's 3.35 TB/s, against microseconds
// for any launch.  So TMA,
// wgmma and shared-memory staging buy nothing here: there is no tile to
// stage and no product, and a TMA descriptor would cost more to encode on
// the host than the copy takes.  The design cuts launches and host work:
// one block per batch row writes K, V and slot_pos in one launch (the
// layer's three writes took two kernel launches plus an index tensor,
// a cast and an index_put_ before); the slot is computed on the device
// from t (a [B] or broadcast int32 device tensor, or a host int passed as
// an argument), so the host makes no index tensor; nothing is allocated;
// the copy is in place.  The block's threads copy the K row and then the
// V row with 16-byte vector loads and stores (at the serve shape 32 + 32
// lanes, one warp each), falling back to a byte loop for a cache whose row
// or pointers are not 16-byte aligned; thread 0 writes slot_pos.
//
// Rows whose slot falls outside [0, S) skip all three writes.  The
// reference differs there: its Pallas kernel clamps the position, and its
// slot_pos .at[].set drops the write.  Callers pass in-range positions.
//
// Telemetry (telemetry.cuh; null buffer: off): the reference's meaning, one
// launch per cache written, so the layer write marks 2 launches and each
// row's block adds 2 rows written (1 and 1 for the entry point's single
// cache); a row whose slot is out of range still counts, as the reference
// counts B rows per call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "telemetry.cuh"

// One cache [B, S, row_bytes] and its new rows [B, 1, row_bytes], both
// contiguous; `units` is the row's length in copy units (16 B or 1 B).
struct CacheRows {
  char* cache;
  const char* src;
  long long row_bytes;
  long long units;
  int vec16;
};

static CacheRows make_rows(void* cache, const void* src, long long row_bytes) {
  CacheRows r;
  r.cache = (char*)cache;
  r.src = (const char*)src;
  r.row_bytes = row_bytes;
  r.vec16 = (row_bytes % 16 == 0) && ((uintptr_t)cache % 16 == 0) &&
            ((uintptr_t)src % 16 == 0);
  r.units = r.vec16 ? row_bytes / 16 : row_bytes;
  return r;
}

__device__ __forceinline__ void copy_unit(const CacheRows& c, long long row,
                                          int b, long long i) {
  char* dst = c.cache + row * c.row_bytes;
  const char* src = c.src + (long long)b * c.row_bytes;
  if (c.vec16)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  else
    dst[i] = src[i];
}

__global__ void kv_slot_update_kernel(CacheRows k, CacheRows v,
                                      int* __restrict__ slot_pos,
                                      const int* __restrict__ t_ptr,
                                      long long t_stride, int t_val, int S,
                                      int wrap, int* __restrict__ tel_buf) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    const int caches = v.cache != nullptr ? 2 : 1;
    tel::record(tel_buf, b == 0, caches, caches);
  }
  const int t = t_ptr ? t_ptr[b * t_stride] : t_val;
  int slot = t;
  if (wrap) {                       // Python's mod: the result has S's sign
    slot = t % S;
    if (slot < 0) slot += S;
  }
  if (slot < 0 || slot >= S) return;
  const long long row = (long long)b * S + slot;
  const long long n = k.units + v.units;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < k.units)
      copy_unit(k, row, b, i);
    else
      copy_unit(v, row, b, i - k.units);
  }
  if (slot_pos != nullptr && threadIdx.x == 0) slot_pos[row] = t;
}

static int launch(const CacheRows& k, const CacheRows& v, void* slot_pos,
                  const void* t, long long t_stride, int t_val, int B, int S,
                  int wrap, int* tel_buf, void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const long long units = k.units + v.units;
  int threads = units < 256 ? (int)units : 256;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  kv_slot_update_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      k, v, (int*)slot_pos, (const int*)t, t_stride, t_val, S, wrap,
      tel_buf);
  return (int)cudaGetLastError();
}

// The layer write.  k_cache/v_cache: [B, S, *] contiguous (a layer's view
// of a stacked cache qualifies); k_new/v_new: [B, 1, *] contiguous, the
// rows' widths may differ; slot_pos: [B, S] int32 or NULL; t: int32 device
// pointer read at t[b * t_stride] (t_stride 0 broadcasts one position), or
// NULL to use t_val for every row; wrap != 0 takes slot = t mod S; tel:
// a zeroed [1, 8] int32 telemetry buffer or NULL.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int kv_slot_update_layer(void* k_cache, const void* k_new,
                                    long long k_row_bytes, void* v_cache,
                                    const void* v_new, long long v_row_bytes,
                                    void* slot_pos, const void* t,
                                    long long t_stride, int t_val, int B,
                                    int S, int wrap, void* tel,
                                    void* stream) {
  return launch(make_rows(k_cache, k_new, k_row_bytes),
                make_rows(v_cache, v_new, v_row_bytes), slot_pos, t,
                t_stride, t_val, B, S, wrap, (int*)tel, stream);
}

// The reference's entry point: cache [B, S, row_bytes] contiguous; src
// [B, 1, row_bytes] contiguous; pos [B] int32 on the device; tel as above.
extern "C" int kv_slot_update(void* cache, const void* src, const void* pos,
                              int B, int S, long long row_bytes, void* tel,
                              void* stream) {
  return launch(make_rows(cache, src, row_bytes), make_rows(NULL, NULL, 0),
                NULL, pos, 1, 0, B, S, 0, (int*)tel, stream);
}
