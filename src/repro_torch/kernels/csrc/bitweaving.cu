// BitWeaving-V range-scan kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel bitweaving_scan of src/repro/kernels/bitweaving.py:
// the predicate c1 <= v <= c2 over a bit-sliced column (plane i holds bit
// b-1-i of every value, 32 values a word), computed MSB first with the
// gt/lt/eq recurrence for both constants.
//
// Bound on this card: bytes, 4 * (b + 1) * words (every plane word read
// once, the result word written once) at 3.35 TB/s; the recurrence is a
// few integer ops a plane word. At the serving path's sizes (8 planes of
// 187,538 words, 6.75 MB) the time is the launch's fixed cost plus the
// time to get the planes in flight, so the design puts every plane load
// of the grid in flight before any of the recurrence:
//
// - One thread a vector position, one position a thread (no grid-stride
//   loop). The kernel is a template on b (1..32), so the plane loop
//   unrolls and the source issues the loads of all b planes at its
//   position into registers (no array indexed at run time) before the
//   first compare. ptxas keeps that order only for small b: in the served
//   8-plane instantiations it starts the recurrence after the first 4 of
//   the 8 loads (chip_smoke.py reports the order from the SASS), and
//   volatile asm loads or fences do not change it. Staging the planes in
//   shared memory with cp.async, which issues every load first, was
//   slower on an H100, so the loads stay in registers.
// - Every plane starts 4 * words bytes after the one before, so the
//   vector width that divides both the base pointer and 4 * words is the
//   one all b planes share at each position: 16 bytes for the 2^24-row
//   planes (524,288 words), 8 for the TPC-H SF1 planes (187,538 words),
//   4 for a view 4 bytes off a 16-byte boundary. bitweaving.plan picks it
//   on the host; the kernel is a template on it too.
// - c1 and c2 stay run-time ints: each constant bit becomes an all-ones
//   or all-zero mask, the same for every thread, so there is no branch
//   and no compile per constant (the reference specialises on them).
// - The caller's tail mask rides in the store: words from n_bits / 32 on
//   store 0, the partial word keeps its low n_bits % 32 bits (pass
//   n_bits = 32 * words for no mask), as _mask_tail does.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;

template <int N> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t* r) {
    r[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* r) {
    p[0] = r[0];
  }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t* r) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x, r[1] = v.y;
  }
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* r) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t* r) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  }
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t* r) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  }
};

// Thread i computes words [N * i, N * i + N) of the result from the b
// planes' words at the same place.
template <int B, int N>
__global__ void __launch_bounds__(THREADS)
bitweaving_scan_kernel(const uint32_t* __restrict__ planes,
                       uint32_t* __restrict__ out, long long words,
                       uint32_t c1, uint32_t c2, long long full,
                       uint32_t partial) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long w0 = i * N;
  if (w0 >= words) return;
  uint32_t p[B][N];
#pragma unroll
  for (int k = 0; k < B; ++k)       // every plane's load before any compare
    Vec<N>::load(planes + k * words + w0, p[k]);
  uint32_t r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t gt1 = 0u, eq1 = ~0u, lt2 = 0u, eq2 = ~0u;
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int sh = B - 1 - k;
      const uint32_t m1 = 0u - ((c1 >> sh) & 1u);   // c1's bit, all lanes
      const uint32_t m2 = 0u - ((c2 >> sh) & 1u);
      const uint32_t v = p[k][j];
      gt1 |= eq1 & v & ~m1;         // v's bit above c1's: v > c1 from here
      eq1 &= ~(v ^ m1);
      lt2 |= eq2 & ~v & m2;         // v's bit below c2's: v < c2 from here
      eq2 &= ~(v ^ m2);
    }
    const long long w = w0 + j;
    const uint32_t keep = w < full ? ~0u : (w == full ? partial : 0u);
    r[j] = (gt1 | eq1) & (lt2 | eq2) & keep;
  }
  Vec<N>::store(out + w0, r);
}

typedef void (*ScanKernel)(const uint32_t*, uint32_t*, long long, uint32_t,
                           uint32_t, long long, uint32_t);

template <int B>
ScanKernel pick(int width) {
  if (width == 16) return bitweaving_scan_kernel<B, 4>;
  if (width == 8) return bitweaving_scan_kernel<B, 2>;
  return bitweaving_scan_kernel<B, 1>;
}

template <int... Bs> struct Table;
template <int... Bs> struct Table<0, Bs...> {
  static ScanKernel at(int b, int width) {
    ScanKernel k = nullptr;
    ((b == Bs ? (k = pick<Bs>(width), 0) : 0), ...);
    return k;
  }
};
template <int B, int... Bs> struct Table<B, Bs...> : Table<B - 1, B, Bs...> {};

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes: (b, words) uint32 on the device, MSB plane first; out: (words,)
// uint32. width (16, 8 or 4 bytes) must divide the planes' address and
// 4 * words; blocks * THREADS * width / 4 >= words. c1/c2 are taken
// modulo 2^32 (only their low b bits matter). Words at and past `full`
// store 0 except word `full`, which keeps the bits of `partial`. Returns
// cudaGetLastError() after the launch.
int bitweaving_scan_launch(const void* planes, void* out, int b,
                           long long words, unsigned int c1, unsigned int c2,
                           int width, long long blocks, long long full,
                           unsigned int partial, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(planes);
  if (b < 1 || b > 32 || words <= 0 ||
      (width != 4 && width != 8 && width != 16) || addr % width ||
      (4 * words) % width || blocks > 0x7fffffffLL ||
      blocks * THREADS * (width / 4) < words)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanKernel k = Table<32>::at(b, width);
  k<<<static_cast<unsigned>(blocks), THREADS, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out),
      words, c1, c2, full, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
