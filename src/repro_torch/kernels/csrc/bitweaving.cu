// BitWeaving-V range-scan kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel bitweaving_scan of src/repro/kernels/bitweaving.py:
// the predicate c1 <= v <= c2 over a bit-sliced column (plane i holds bit
// b-1-i of every value, 32 values a word), computed MSB first with the
// gt/lt/eq recurrence for both constants.
//
// Bound on this card: bytes, 4 * (b + 1) * words (every plane word read
// once, the result word written once) at 3.35 TB/s; the recurrence is a
// few integer ops a plane word. The design: one thread per output word
// (per four words on the 16-byte path, taken when the plane length is a
// multiple of 4 and the planes are 16-byte aligned; the TPC-H planes at
// scale factor 1 are 187538 words, so they take the scalar path), which
// reads the b plane words of its position strided by `words`, so
// neighbouring threads read neighbouring addresses. The reference
// specialises the kernel on (b, c1, c2) at trace time; here they are
// runtime ints - the branch on each constant bit is uniform across the
// grid, so it costs no divergence and needs no compile per constant.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V> struct Lanes;
template <> struct Lanes<uint32_t> {
  static __device__ __forceinline__ uint32_t ones() { return 0xFFFFFFFFu; }
  static __device__ __forceinline__ uint32_t zero() { return 0u; }
};
template <> struct Lanes<uint4> {
  static __device__ __forceinline__ uint4 ones() {
    return make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  }
  static __device__ __forceinline__ uint4 zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

__device__ __forceinline__ uint32_t andn(uint32_t a, uint32_t b) { return a & ~b; }
__device__ __forceinline__ uint4 andn(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ uint32_t band(uint32_t a, uint32_t b) { return a & b; }
__device__ __forceinline__ uint4 band(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint32_t bor(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 bor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// Predicate for element i (in units of V) of each plane.
template <typename V>
__device__ __forceinline__ V scan_one(const uint32_t* planes, long long i,
                                      int b, long long words, uint32_t c1,
                                      uint32_t c2) {
  V gt1 = Lanes<V>::zero(), eq1 = Lanes<V>::ones();
  V lt2 = Lanes<V>::zero(), eq2 = Lanes<V>::ones();
  for (int k = 0; k < b; ++k) {
    const V p = reinterpret_cast<const V*>(planes + k * words)[i];
    const int sh = b - 1 - k;
    if ((c1 >> sh) & 1u) {          // v's bit below c1's: v < c1 from here
      eq1 = band(eq1, p);
    } else {                        // v's bit above c1's: v > c1 from here
      gt1 = bor(gt1, band(eq1, p));
      eq1 = andn(eq1, p);
    }
    if ((c2 >> sh) & 1u) {
      lt2 = bor(lt2, andn(eq2, p));
      eq2 = band(eq2, p);
    } else {
      eq2 = andn(eq2, p);
    }
  }
  return band(bor(gt1, eq1), bor(lt2, eq2));
}

template <bool VEC>
__global__ void bitweaving_scan_kernel(const uint32_t* __restrict__ planes,
                                       uint32_t* __restrict__ out, int b,
                                       long long words, uint32_t c1,
                                       uint32_t c2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = words >> 2;
    for (long long i = tid; i < n4; i += stride)
      reinterpret_cast<uint4*>(out)[i] =
          scan_one<uint4>(planes, i, b, words, c1, c2);
    done = 4 * n4;
  }
  for (long long i = done + tid; i < words; i += stride)
    out[i] = scan_one<uint32_t>(planes, i, b, words, c1, c2);
}

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// planes: (b, words) uint32 on the device, MSB plane first; out: (words,)
// uint32. c1/c2 are taken modulo 2^32 (only their low b bits matter).
// vec selects the 16-byte path. Returns cudaGetLastError() after launch.
int bitweaving_scan_launch(const void* planes, void* out, int b,
                           long long words, unsigned int c1, unsigned int c2,
                           int vec, void* stream) {
  if (b < 1 || b > 32 || words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long units = vec ? (words >> 2) + (words & 3) : words;
  long long blocks = (units + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vec)
    bitweaving_scan_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        p, o, b, words, c1, c2);
  else
    bitweaving_scan_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        p, o, b, words, c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
