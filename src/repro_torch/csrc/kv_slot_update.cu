// Per-row KV-cache write for per-slot decoding:  cache[b, pos[b], :] = new[b, 0, :]
//
// Replaces: src/repro/kernels/cache_update.py::kv_slot_update (Pallas TPU
// kernel; scalar-prefetched pos folded into the output BlockSpec, cache
// buffer aliased to the output so only the B touched rows are written).
//
// What bounds it on an H100: nothing the card computes.  One call moves
// B rows of F elements (at the serve path's shape B=4, F=2*128 bf16: 2 KB
// read + 2 KB written), far below what one launch costs, so it is bound
// by launch latency (a few microseconds), not by bytes or FLOPs.
//
// What the design does about it: one block per batch row, no host sync
// (pos[b] is read from device memory by the block itself), the copy is
// 16-byte vector loads/stores when the row and both pointers are 16-byte
// aligned (byte loop otherwise), and the write is in place into the
// caller's cache (nothing is allocated, no other row is read or copied).
// Fusing the K and V writes of a layer, or capturing the decode step in a
// CUDA graph, is what would cut the launch cost further.
//
// Rows whose pos[b] lies outside [0, S) are skipped (the TPU kernel clamps
// them); callers pass in-range positions.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void kv_slot_update_kernel(char* __restrict__ cache,
                                      const char* __restrict__ src,
                                      const int* __restrict__ pos,
                                      int S, long long row_bytes,
                                      int vec16) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  char* dst = cache + ((long long)b * S + p) * row_bytes;
  const char* s = src + (long long)b * row_bytes;
  if (vec16) {
    const long long n = row_bytes / 16;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x)
      dst[i] = s[i];
  }
}

// cache: [B, S, row_bytes] contiguous; src: [B, 1, row_bytes] contiguous;
// pos: [B] int32 on the device.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int kv_slot_update(void* cache, const void* src, const void* pos,
                              int B, int S, long long row_bytes,
                              void* stream) {
  const int vec16 = (row_bytes % 16 == 0) &&
                    ((uintptr_t)cache % 16 == 0) && ((uintptr_t)src % 16 == 0);
  const long long units = vec16 ? row_bytes / 16 : row_bytes;
  int threads = units < 256 ? (int)units : 256;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  kv_slot_update_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (char*)cache, (const char*)src, (const int*)pos, S, row_bytes, vec16);
  return (int)cudaGetLastError();
}
