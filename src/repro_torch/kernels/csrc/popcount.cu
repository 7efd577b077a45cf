// Per-row popcount kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel popcount_rows of src/repro/kernels/popcount.py.
// That kernel carries a running sum across a sequential grid of word
// tiles into one output block; Hopper's blocks run in no order, so that
// carry cannot be kept.
//
// Bound on this card: bytes, 4 * rows * words read once at 3.35 TB/s (the
// output is 4 bytes a row). On the serving path the input is one very
// long row (a 2^24-bit bitmap is (1, 524288) words, 2 MiB), read once per
// query: the time is the launch's fixed cost plus the time to get 2 MiB
// in flight, so the design puts all of it in flight at once and lands
// each row's count with ONE plain store, in ONE launch (no fill kernel
// before it, no atomics into the output):
//
// - Long rows (popcount_long_kernel): `splits` blocks a row, enough to
//   fill the 132 SMs. Each row is cut into the head words before its
//   first 16-byte boundary, a body of 16-byte vectors and the tail words
//   after the last vector, so a row of any length at any 4-byte offset
//   takes the 16-byte path. A thread issues its UNROLL 16-byte
//   ld.global.nc loads before it counts any of them; the block reduces
//   with __reduce_add_sync and one shared-memory step.
// - The blocks of a row meet by ticket: one 64-bit atomicAdd a block on
//   the row's ticket word adds the block's partial to the running sum
//   (low 40 bits) and takes a ticket (high 24 bits); the block that draws
//   the last ticket holds the row's count in the value the atomic
//   returned plus its own partial, stores it and resets the word to 0.
//   The partial rides in the ticket, so no partials are written, fenced
//   or read again (on an H100 a workspace of partials, a __threadfence()
//   and a second read by the last block took 0.9 us more on the served
//   row). The ticket words are zeroed once when the wrapper allocates
//   them and are left at 0 by every launch, so no launch zeroes anything.
//   Thread block clusters summing their blocks' partials through
//   distributed shared memory were slower on the served row, as one
//   cluster of 16 blocks a row (16 SMs) and as clusters across the card
//   meeting by ticket, and are not kept.
// - Short rows (popcount_short_kernel, words <= SHORT_WORDS): `group`
//   threads a row (1 to 32, a power of two), each with all of its at most
//   SHORT_LOADS words in flight, reduced by shuffles inside the group;
//   the group's first thread stores the count.
//
// Integer addition is associative, so every route gives the exact count.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int UNROLL = 4;       // 16-byte loads a thread in flight
constexpr int SHORT_LOADS = 8;  // words a thread of the short-row route
constexpr int THREADS = 256;
// A ticket word: the tickets drawn above bit TICKET_SHIFT, the partials'
// running sum below it (a row holds fewer than 2^36 bits).
constexpr int TICKET_SHIFT = 40;
constexpr unsigned long long TICKET = 1ull << TICKET_SHIFT;

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Sum of `acc` over the block, valid in thread 0. `sums` holds one word a
// warp.
__device__ __forceinline__ unsigned block_sum(unsigned acc, unsigned* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < THREADS / 32 ? sums[lane] : 0u;
    acc = __reduce_add_sync(0xffffffffu, acc);
  }
  return acc;
}

// Grid x = rows * splits, block b counts part (b % splits) of row
// (b / splits). Part s walks body vectors [s * per, (s + 1) * per) in
// passes of THREADS * UNROLL; part 0 adds the head words, the last part
// the tail words. The parts of a row meet by ticket on tickets[row] when
// there are more than one.
__global__ void __launch_bounds__(THREADS)
popcount_long_kernel(const uint32_t* __restrict__ x, int* __restrict__ out,
                     long long words, int splits, long long per,
                     unsigned long long* __restrict__ tickets) {
  __shared__ unsigned sums[THREADS / 32];
  const long long row = blockIdx.x / splits;
  const int s = (int)(blockIdx.x - row * splits);
  const uint32_t* p = x + row * words;
  long long head = (long long)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
  if (head > words) head = words;
  const long long nv = (words - head) >> 2;
  const long long tail = words - head - 4 * nv;
  const uint4* body = reinterpret_cast<const uint4*>(p + head);
  const long long lo = s * per;
  const long long hi = lo + per < nv ? lo + per : nv;
  unsigned acc = 0;
  for (long long base = lo + threadIdx.x; base < hi;
       base += (long long)THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {   // every load before any count
      const long long i = base + (long long)u * THREADS;
      v[u] = i < hi ? __ldg(body + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += popc4(v[u]);
  }
  if (s == 0 && threadIdx.x < head) acc += __popc(__ldg(p + threadIdx.x));
  if (s == splits - 1 && threadIdx.x < tail)
    acc += __popc(__ldg(p + head + 4 * nv + threadIdx.x));
  acc = block_sum(acc, sums);
  if (threadIdx.x != 0) return;
  if (splits == 1) {
    out[row] = (int)acc;
    return;
  }
  const unsigned long long old =
      atomicAdd(tickets + row, TICKET | (unsigned long long)acc);
  if ((old >> TICKET_SHIFT) == (unsigned long long)(splits - 1)) {
    out[row] = (int)((old & (TICKET - 1)) + acc);
    tickets[row] = 0ull;            // ready for the next launch
  }
}

// Thread t counts words (t % group) + j * group, j < SHORT_LOADS, of row
// t / group; the group's shuffles sum them and its first thread stores.
__global__ void __launch_bounds__(THREADS)
popcount_short_kernel(const uint32_t* __restrict__ x, int* __restrict__ out,
                      long long rows, int words, int group) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / group;
  const int j = (int)(t - row * group);
  unsigned acc = 0;
  if (row < rows) {
    const uint32_t* p = x + row * words;
    uint32_t v[SHORT_LOADS];
#pragma unroll
    for (int u = 0; u < SHORT_LOADS; ++u) {
      const int i = j + u * group;
      v[u] = i < words ? __ldg(p + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < SHORT_LOADS; ++u) acc += __popc(v[u]);
  }
  for (int off = group >> 1; off > 0; off >>= 1)   // every lane takes part
    acc += __shfl_xor_sync(0xffffffffu, acc, off, group);
  if (row < rows && j == 0) out[row] = (int)acc;
}

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Long rows. x: (rows, words) uint32 on the device, out: (rows,) int32
// (any contents; every row is stored once). blocks = rows * splits,
// splits below 2^24. tickets: a zeroed uint64 a row, left zeroed; unused
// when a row is one block. Returns cudaGetLastError() after the launch.
int popcount_long_launch(const void* x, void* out, long long rows,
                         long long words, int splits, long long per,
                         void* tickets, void* stream) {
  if (rows <= 0 || words <= 0 || splits <= 0 || splits >= (1 << 24) ||
      per <= 0 || rows * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  popcount_long_kernel<<<static_cast<unsigned>(rows * splits), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int*>(out), words, splits,
      per, static_cast<unsigned long long*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// Short rows: `group` threads a row (a power of two, at most 32, with
// words <= group * SHORT_LOADS), `blocks` blocks of THREADS threads.
int popcount_short_launch(const void* x, void* out, long long rows,
                          int words, int group, long long blocks,
                          void* stream) {
  if (rows <= 0 || words <= 0 || group < 1 || group > 32 ||
      (group & (group - 1)) || words > group * SHORT_LOADS ||
      blocks * THREADS < rows * group || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  popcount_short_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int*>(out), rows, words,
      group);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
