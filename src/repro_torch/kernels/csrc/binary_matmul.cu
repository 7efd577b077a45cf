// XNOR-popcount binary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel binary_matmul of
// src/repro/kernels/binary_matmul.py: for {-1,+1} vectors packed as bits
// (1 = +1), C[m,n] = k_bits - 2 * popcount(a[m] XOR b[n]) over the Kw
// packed words of each row. That kernel walks K as a sequential grid
// axis and carries the partial sum in its output block from one grid
// step to the next; Hopper's blocks run in no order, so here each block
// owns one 64x64 output tile outright and loops over K itself.
//
// Bound on this card: operations. Each output needs Kw XORs and Kw
// popcounts; the bytes (a and b read once, the int32 output written once)
// are small beside them at any useful N. The CUDA cores count 16
// popcounts a clock per SM (NVIDIA's arithmetic-instruction throughput
// table for compute capability 9.0), a quarter of the XOR and add rate,
// so __popc is what this design spends its time on. The design: 256
// threads a block, each holding a 4x4 tile of counters in registers; a
// K chunk of 32 words of a's 64 rows and of b's 64 rows is staged in
// shared memory (rows padded to 33 words so that neither the coalesced
// global-to-shared copy nor the reads of the inner loop conflict on a
// bank), so every word a thread reads from shared memory feeds four
// XOR-popcounts. The ragged edges are masked in the loads (rows past M
// or N and words past Kw load as 0, and 0 XOR 0 adds nothing) and in the
// store (rows past M or N are never written). The result is written once:
// no atomics, no second pass. Tensor-core designs (b1 or int8 products)
// are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // output rows and columns of a block
constexpr int KC = 32;          // packed words of K staged per step
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int PITCH = KC + 1;   // shared-memory row pitch in words

__global__ void __launch_bounds__(THREADS)
binary_matmul_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int* __restrict__ out,
                     long long m, long long n, long long kw, int k_bits) {
  __shared__ uint32_t as[TILE * PITCH];
  __shared__ uint32_t bs[TILE * PITCH];
  const int tx = threadIdx.x & 15;          // output columns tx + 16 j
  const int ty = threadIdx.x >> 4;          // output rows    ty + 16 i
  const long long m0 = (long long)blockIdx.x * TILE;
  const long long n0 = (long long)blockIdx.y * TILE;
  // the copy: a warp reads 32 consecutive words of one row
  const int lc = threadIdx.x & (KC - 1);
  const int lr = threadIdx.x / KC;          // 0..7, rows lr + 8 p

  unsigned int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;

  for (long long k0 = 0; k0 < kw; k0 += KC) {
    const long long col = k0 + lc;
    const bool in_k = col < kw;
#pragma unroll
    for (int p = 0; p < TILE / 8; ++p) {
      const int r = lr + 8 * p;
      const long long ra = m0 + r, rb = n0 + r;
      as[r * PITCH + lc] = (in_k && ra < m) ? a[ra * kw + col] : 0u;
      bs[r * PITCH + lc] = (in_k && rb < n) ? b[rb * kw + col] : 0u;
    }
    __syncthreads();
    const int kn = kw - k0 < KC ? static_cast<int>(kw - k0) : KC;
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * PITCH + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * PITCH + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();                        // as/bs are refilled next step
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = n0 + tx + 16 * j;
      if (c < n) out[r * n + c] = k_bits - 2 * static_cast<int>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a: (m, kw) and b: (n, kw) packed uint32 words on the device, row-major;
// out: (m, n) int32 (kw = 0 gives k_bits everywhere). Pad bits beyond
// k_bits must be zero in both operands.
// M tiles go on grid x (up to 2^31 - 1), N tiles on grid y (at most
// 65,535, so n <= 4,194,240). Returns cudaGetLastError() after the launch.
int binary_matmul_launch(const void* a, const void* b, void* out,
                         long long m, long long n, long long kw, int k_bits,
                         void* stream) {
  if (m <= 0 || n <= 0 || kw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (m + TILE - 1) / TILE;
  const long long gy = (n + TILE - 1) / TILE;
  if (gx > 2147483647LL || gy > 65535LL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  binary_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int*>(out), m, n, kw, k_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
