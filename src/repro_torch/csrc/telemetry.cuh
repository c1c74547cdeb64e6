// In-kernel telemetry shared by the port's kernels: the counterpart of the
// reference's (1, TEL_WIDTH) int32 telemetry output
// (src/repro/kernels/telemetry.py), written into a [1, 8] int32 buffer the
// launcher zeroes (repro_torch/kernels/telemetry.py):
//
//   lane LAUNCH: set once per call by one thread of one block, to 1 (or,
//                for the KV layer write, to the number of caches written);
//   lane COUNT:  the op's work count in the reference's units, added once
//                per block by one thread with one atomicAdd of that
//                block's own share;
//   lanes 2..7:  reserved (zero).
//
// A null buffer pointer turns telemetry off: the kernels then run exactly
// as without it.  Nothing here changes an output: only the buffer is
// written.
#pragma once

#include <cuda_runtime.h>

namespace tel {

constexpr int LAUNCH = 0;
constexpr int COUNT = 1;

// Called by one thread of each block: the first block marks the call,
// every block adds its own count.
__device__ __forceinline__ void record(int* buf, bool first, int launches,
                                       int count) {
  if (buf == nullptr) return;
  if (first) buf[LAUNCH] = launches;
  if (count != 0) atomicAdd(buf + COUNT, count);
}

// Marks a call whose work needed no kernel of its own (an empty side).
__global__ void mark_kernel(int* buf, int launches) {
  buf[LAUNCH] = launches;
}

inline int mark(int* buf, int launches, cudaStream_t stream) {
  if (buf == nullptr) return (int)cudaSuccess;
  mark_kernel<<<1, 1, 0, stream>>>(buf, launches);
  return (int)cudaGetLastError();
}

// The reference's attention tiles of (bq x bk) (bq == 0: its wrapper falls
// back and counts none) whose first query row lies in [lo, hi): q tile i
// keeps the key tiles j with j bk <= i bq + bq - 1 + skv - sq under a
// causal mask, all skv / bk of them without one.  Flash blocks own query
// rows, so each reference tile is counted by the block holding its first
// row.
__device__ __forceinline__ int attn_tiles_of_rows(int lo, int hi, int bq,
                                                  int bk, int sq, int skv,
                                                  int causal) {
  if (bq <= 0 || bk <= 0) return 0;
  const int nq = sq / bq, nk = skv / bk, off = skv - sq;
  int n = 0;
  for (int i = (lo + bq - 1) / bq; i < nq && i * bq < hi; ++i) {
    if (!causal) {
      n += nk;
      continue;
    }
    const int last = i * bq + bq - 1 + off;   // the tile's last visible key
    if (last >= 0) n += min(last / bk + 1, nk);
  }
  return n;
}

// The same tiles counted by key: key tile j (first key in [lo, hi)) is
// kept by the q tiles i with i bq + bq - 1 + skv - sq >= j bk.  Colmax
// blocks own keys, so each reference tile is counted by the block holding
// its first key.
__device__ __forceinline__ int attn_tiles_of_keys(int lo, int hi, int bq,
                                                  int bk, int sq, int skv,
                                                  int causal) {
  if (bq <= 0 || bk <= 0) return 0;
  const int nq = sq / bq, nk = skv / bk, off = skv - sq;
  int n = 0;
  for (int j = (lo + bk - 1) / bk; j < nk && j * bk < hi; ++j) {
    if (!causal) {
      n += nq;
      continue;
    }
    const int need = j * bk - off - bq + 1;   // i bq >= need
    const int i_min = need <= 0 ? 0 : (need + bq - 1) / bq;
    if (i_min < nq) n += nq - i_min;
  }
  return n;
}

}  // namespace tel
