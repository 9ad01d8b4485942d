// A single-pass scan across blocks by decoupled look-back, shared by H11
// (`compact_samples`, march_fine.cu) and K8's occupied list
// (`occ_compact`, occupancy.cu).
//
// work: [the epoch (high half) and the ticket (low half), then a 64-bit
// status word a block]. Each block takes a ticket, which orders the blocks
// by their start, so that a block waits only on blocks already running;
// the block that takes a call's last ticket starts the next epoch at
// ticket 0. A status word holds the call's epoch (30 bits), a flag (2
// bits) and the value (32 bits): a word of another epoch, a former call's,
// reads as not yet published, so the words need no zeroing between calls
// (the buffer is zeroed once, when it is made). Calls that share a buffer
// must follow each other on one stream.
#pragma once
#include "common.cuh"

namespace scan {

constexpr unsigned long long HAS_AGGREGATE = 1ull << 32;
constexpr unsigned long long HAS_PREFIX = 2ull << 32;
constexpr int EPOCH_SHIFT = 34;

// the flag of word w if it is of epoch tag `tag`, else 0
__device__ __forceinline__ unsigned flag_of(unsigned long long w,
                                            unsigned long long tag) {
  return (w >> EPOCH_SHIFT) == (tag >> EPOCH_SHIFT)
             ? static_cast<unsigned>(w >> 32) & 3u : 0u;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

struct Ticket {
  int index;               // the block's place in the order of starts
  unsigned long long tag;  // its call's epoch, in a status word's bits
};

// The block's ticket, the same in every thread (a barrier inside).
__device__ __forceinline__ Ticket take_ticket(unsigned long long* work) {
  __shared__ unsigned long long s_ticket;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(work, 1ull);
    if (static_cast<unsigned>(t) == gridDim.x - 1)
      atomicExch(work, ((t >> 32) + 1) << 32);
    s_ticket = t;
  }
  __syncthreads();
  const unsigned long long t = s_ticket;
  return {static_cast<int>(static_cast<unsigned>(t)),
          ((t >> 32) & ((1ull << (64 - EPOCH_SHIFT)) - 1)) << EPOCH_SHIFT};
}

// The block's prefix (the values of the blocks before it) by decoupled
// look-back, on one warp: publish the aggregate, sum the predecessors'
// aggregates back to the nearest inclusive prefix, 32 at a time, and
// publish the inclusive prefix. status: the words of this scan's blocks,
// block `tile` at status[tile].
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         unsigned long long tag, int tile,
                                         int agg, int lane) {
  if (tile == 0) {
    if (lane == 0)
      store_status(status, tag | HAS_PREFIX | static_cast<unsigned>(agg));
    return 0;
  }
  if (lane == 0)
    store_status(status + tile,
                 tag | HAS_AGGREGATE | static_cast<unsigned>(agg));
  int prefix = 0;
  for (int look = tile - 1;; look -= 32) {
    const int idx = look - lane;
    unsigned long long w =
        idx >= 0 ? load_status(status + idx) : tag | HAS_PREFIX;
    while (__any_sync(FULL, flag_of(w, tag) == 0))
      if (flag_of(w, tag) == 0) w = load_status(status + idx);
    const unsigned pre = __ballot_sync(FULL, flag_of(w, tag) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;   // nearest prefix's lane
    int v = lane <= stop ? static_cast<int>(w & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    prefix += v;
    if (pre) break;
  }
  if (lane == 0)
    store_status(status + tile,
                 tag | HAS_PREFIX | static_cast<unsigned>(prefix + agg));
  return prefix;
}

// The inclusive prefix of block `tile` once published (a spin of thread
// 0's; the caller shares it).
__device__ __forceinline__ int wait_prefix(const unsigned long long* status,
                                           unsigned long long tag, int tile) {
  unsigned long long w;
  do w = load_status(status + tile); while (flag_of(w, tag) != 2);
  return static_cast<int>(w & 0xffffffffu);
}

}  // namespace scan
