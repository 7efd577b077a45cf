// Per-row popcount kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel popcount_rows of src/repro/kernels/popcount.py.
// That kernel carries a running sum across a sequential grid of word
// tiles into one output block; Hopper's blocks run in no order, so that
// carry cannot be kept.
//
// Bound on this card: bytes, 4 * rows * words read once at 3.35 TB/s (the
// output is 4 bytes a row). On the main path the input is one very long
// row (a 2^24-bit bitmap is (1, 524288) words), so one block per row
// would use 1 SM of 132. The design therefore splits every row over many
// blocks (grid x walks word chunks of a row, grid y walks rows): each
// thread streams its words with 16-byte loads where the row length and
// alignment allow (scalar otherwise) and counts with __popc; a warp
// shuffle and a shared-memory step reduce the block, and one atomicAdd a
// block lands its partial sum in the zeroed int32 output. Integer
// addition is associative, so the order of the atomics does not matter
// and the count stays exact.

#include <cuda_runtime.h>
#include <stdint.h>

template <bool VEC>
__global__ void popcount_rows_kernel(const uint32_t* __restrict__ x,
                                     int* __restrict__ out, long long rows,
                                     long long words) {
  __shared__ unsigned int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* row = x + r * words;
    unsigned int acc = 0;
    long long done = 0;
    if (VEC) {
      const long long n4 = words >> 2;
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      for (long long i = tid; i < n4; i += stride) {
        const uint4 v = row4[i];
        acc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
      done = 4 * n4;
    }
    for (long long i = done + tid; i < words; i += stride) acc += __popc(row[i]);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < n_warps ? warp_sums[lane] : 0u;
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0 && acc) atomicAdd(out + r, static_cast<int>(acc));
    }
    __syncthreads();  // warp_sums is reused by the next row
  }
}

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (rows, words) uint32 on the device; out: (rows,) int32, zeroed by
// the caller. vec selects the 16-byte path (words % 4 == 0 and x 16-byte
// aligned). Returns cudaGetLastError() after the launch.
int popcount_rows_launch(const void* x, void* out, long long rows,
                         long long words, int vec, void* stream) {
  if (rows <= 0 || words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long bx = (words + threads * 16 - 1) / (threads * 16);
  if (bx > 1024) bx = 1024;
  if (bx < 1) bx = 1;
  const long long by = rows < 65535 ? rows : 65535;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  int* op = static_cast<int*>(out);
  if (vec)
    popcount_rows_kernel<true><<<grid, threads, 0, s>>>(xp, op, rows, words);
  else
    popcount_rows_kernel<false><<<grid, threads, 0, s>>>(xp, op, rows, words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
