// XNOR-popcount binary matmul for Hopper (sm_90a), on the int8 tensor
// cores.
//
// Replaces the TPU kernel binary_matmul of
// src/repro/kernels/binary_matmul.py: for {-1,+1} vectors packed as bits
// (1 = +1), C[m,n] = k_bits - 2 * popcount(a[m] XOR b[n]) over the Kw
// packed words of each row, which is the dot product of the +-1 rows.
// That kernel walks K as a sequential grid axis and carries the partial
// sum in its output block; Hopper's blocks run in no order, so here each
// block owns an output tile and loops over its share of K itself.
//
// Bound on this card: operations (2*M*N*K at the dense int8 tensor-core
// rate, 1,979 T/s), then the int32 output. A __popc loop on the CUDA cores
// issues 16 popcounts a clock per SM, about 8x that bound, so this kernel
// expands each packed bit to an int8 of +-1 and takes s8 x s8 -> s32
// products on the tensor cores. The design:
//
// - One packed word is exactly the k = 32 of one int8 product step. The
//   product sums over k in any order, so the k slots of lane t of a quad
//   (k = 4t..4t+3 and 16+4t..16+4t+3 of the mma.m16n8k32 fragment layout)
//   take bits 8j + t and 8j + t + 4 (j = 0..3) of the word, in A and in B
//   alike: (x >> t) & 0x01010101 puts four bits at the bottom of the
//   bytes, and 0xFFFFFFFF - 0xFE * m turns each byte into +1 (bit set) or
//   -1. Three integer ops a 32-bit register of four int8.
// - Zero bits past k_bits and zero-filled words past Kw expand to -1 in
//   both operands and add +1 a position; the epilogue subtracts 32 for
//   every word it walked and adds k_bits once, so the result is exact.
// - Large grids (the wrapper's `plan`): 128x256 tiles on wgmma
//   m64n256k32 (the only way to the full int8 rate), two warpgroups of
//   64 rows. A is expanded straight into registers in the fragment layout;
//   B, which wgmma reads from shared memory, is expanded once a block into
//   int8 core matrices, one buffer while the tensor cores read the other,
//   so the expansion of chunk i + 1 overlaps the products of chunk i.
// - Small grids and N <= 8: 64x64 and 128x8 tiles on mma.sync m16n8k32
//   (IMMA), both operands expanded in registers; a small grid splits K
//   across grid z and lands partial sums with int32 atomics into a zeroed
//   output, exact in any order.
// - Packed words are tiny (a 256-row tile of 8 words is 8 KB): a ring of
//   three stages in shared memory filled by 4-byte cp.async (any Kw, any
//   alignment; rows past M or N and words past Kw fill with zeros), rows
//   padded to an odd or 12-word pitch so a warp's reads fall on distinct
//   banks.
// - Output stores are 8 bytes a thread (a quad writes 32 contiguous bytes
//   of a row) where N is even.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 8;          // packed words of K a stage
constexpr int PITCH = KC + 4;  // shared-memory row pitch in words
constexpr int STAGES = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy, or 4 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of m in {0, 1} -> int8 -1 (0xFF) or +1 (0x01)
__device__ __forceinline__ uint32_t pm1(uint32_t m) {
  return 0xFFFFFFFFu - 0xFEu * m;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// mma.sync kernel for small grids and thin N: WM x WN warps, each owning
// (16 MT) x (8 NT) outputs, A and B expanded in registers.
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
binary_matmul_mma(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int* __restrict__ out,
                     long long m, long long n, long long kw, int k_bits,
                     long long tiles_n, int chunks_per_split, int atomic) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT, NTH = WM * WN * 32;
  __shared__ __align__(16) uint32_t as[STAGES][BM * PITCH];
  __shared__ __align__(16) uint32_t bs[STAGES][BN * PITCH];

  const long long m0 = (blockIdx.x / tiles_n) * BM;
  const long long n0 = (blockIdx.x % tiles_n) * BN;
  const long long chunks = (kw + KC - 1) / KC;
  const long long c0 = (long long)blockIdx.z * chunks_per_split;
  long long c1 = c0 + chunks_per_split;
  if (c1 > chunks) c1 = chunks;
  const int n_chunks = c1 > c0 ? static_cast<int>(c1 - c0) : 0;

  auto load = [&](int stage, long long chunk) {
    const long long k0 = chunk * KC;
#pragma unroll
    for (int it = 0; it < (BM * KC + NTH - 1) / NTH; ++it) {
      const int idx = threadIdx.x + it * NTH;
      if (BM * KC % NTH == 0 || idx < BM * KC) {
        const int r = idx / KC, c = idx % KC;
        const long long row = m0 + r, col = k0 + c;
        const bool ok = row < m && col < kw;
        cp_async4(smem_u32(&as[stage][r * PITCH + c]),
                  ok ? a + row * kw + col : a, ok);
      }
    }
#pragma unroll
    for (int it = 0; it < (BN * KC + NTH - 1) / NTH; ++it) {
      const int idx = threadIdx.x + it * NTH;
      if (BN * KC % NTH == 0 || idx < BN * KC) {
        const int r = idx / KC, c = idx % KC;
        const long long row = n0 + r, col = k0 + c;
        const bool ok = row < n && col < kw;
        cp_async4(smem_u32(&bs[stage][r * PITCH + c]),
                  ok ? b + row * kw + col : b, ok);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = (warp / WN) * 16 * MT, wc = (warp % WN) * 8 * NT;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load(s, c0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // chunk i landed; stage (i - 1) % STAGES is free
    if (i + STAGES - 1 < n_chunks)
      load((i + STAGES - 1) % STAGES, c0 + i + STAGES - 1);
    cp_async_commit();
    const uint32_t* A = as[i % STAGES] + (wr + g) * PITCH;
    const uint32_t* B = bs[i % STAGES] + (wc + g) * PITCH;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t x = B[8 * j * PITCH + k] >> tig;
        bf[j][0] = pm1(x & 0x01010101u);
        bf[j][1] = pm1((x >> 4) & 0x01010101u);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint32_t x0 = A[16 * mi * PITCH + k] >> tig;        // row g
        const uint32_t x1 = A[(16 * mi + 8) * PITCH + k] >> tig;  // row g + 8
        const uint32_t a0 = pm1(x0 & 0x01010101u);
        const uint32_t a1 = pm1(x1 & 0x01010101u);
        const uint32_t a2 = pm1((x0 >> 4) & 0x01010101u);
        const uint32_t a3 = pm1((x1 >> 4) & 0x01010101u);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[mi][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // every walked word added 32 for its pad and zero positions
  const int corr = (blockIdx.z == 0 ? k_bits : 0) - 32 * KC * n_chunks;
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + wr + 16 * mi + 8 * h + g;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const long long c = n0 + wc + 8 * j + 2 * tig;
        const int v0 = acc[mi][j][2 * h] + corr;
        const int v1 = acc[mi][j][2 * h + 1] + corr;
        int* o = out + r * n + c;
        if (atomic) {
          if (c < n) atomicAdd(o, v0);
          if (c + 1 < n) atomicAdd(o + 1, v1);
        } else if (pairs && c + 1 < n) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          if (c < n) o[0] = v0;
          if (c + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

template <int WM, int WN, int MT, int NT>
int launch_mma(const void* a, const void* b, void* out, long long m,
               long long n, long long kw, int k_bits, long long tiles,
               long long tiles_n, int splits, int chunks_per_split,
               cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(tiles), 1, static_cast<unsigned>(splits));
  binary_matmul_mma<WM, WN, MT, NT><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int*>(out), m, n, kw, k_bits, tiles_n, chunks_per_split,
      splits > 1);
  return static_cast<int>(cudaGetLastError());
}

// -- 128x256 tiles on wgmma ---------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 256, WG_THREADS = 256;  // two warpgroups
constexpr int WPITCH = KC + 1;      // packed rows: 9 words, odd, no conflicts
constexpr int PACKED_STAGE = (WG_BM + WG_BN) * WPITCH;    // words a stage
constexpr int BEXP_K = WG_BN * 32;                 // expanded B bytes a k32
constexpr int BEXP_CHUNK = BEXP_K * KC;            // and a chunk of KC words
constexpr int WG_SMEM = 2 * BEXP_CHUNK + STAGES * PACKED_STAGE * 4;
// expanded B: the two core matrices of an 8-row group along K 128 bytes
// apart, the groups along N 256 bytes apart
constexpr uint32_t K_STEP = 128, N_STEP = 256;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the generic proxy's shared-memory stores, seen by wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving a register across an in-flight wgmma
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void pin(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64x256 int32 of the warpgroup) += A (64x32 int8, registers, the
// mma.m16n8k32 layout in each warp) x B (256x32 int8 in shared memory,
// K-major, no swizzle).
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}


// Shared-memory matrix descriptor of one k32 step of expanded B, K-major
// without swizzle: core matrices of 8 rows x 16 bytes, the leading byte
// offset (bits 16-29) between the two along K, the stride byte offset
// (bits 32-45) between 8-row groups along N.
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(K_STEP >> 4) << 16 |
         static_cast<uint64_t>(N_STEP >> 4) << 32;
}

// 128x256 output tiles: warpgroup w takes rows 64w..64w+63 against all
// 256 columns. Per chunk of KC words every thread expands one B row's KC
// words into int8 core matrices in shared memory (one buffer while wgmma
// reads the other) and its own A rows into registers; one wgmma
// m64n256k32 a word. Expansion of chunk i + 1 overlaps the products of
// chunk i.
__global__ void __launch_bounds__(WG_THREADS, 1)
binary_matmul_wgmma(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int* __restrict__ out,
                    long long m, long long n, long long kw, int k_bits,
                    long long tiles_n, int chunks_per_split, int atomic) {
  constexpr int BN = WG_BN, NACC = BN / 2;
  constexpr int LOADS = (WG_BM + BN) / 32;   // copies a thread a chunk
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* bexp = smem;                                     // [2][KC][BEXP_K]
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem + 2 * BEXP_CHUNK);

  const long long m0 = (blockIdx.x / tiles_n) * WG_BM;
  const long long n0 = (blockIdx.x % tiles_n) * BN;
  const long long chunks = (kw + KC - 1) / KC;
  const long long c0 = (long long)blockIdx.z * chunks_per_split;
  long long c1 = c0 + chunks_per_split;
  if (c1 > chunks) c1 = chunks;
  const int n_chunks = c1 > c0 ? static_cast<int>(c1 - c0) : 0;
  const int t = threadIdx.x;
  const int lane = t & 31, g = lane >> 2, tig = lane & 3;
  const int arow = (t >> 5) * 16 + g;        // warp w: rows 16w.. of the tile

  // the copies of this thread: word t % 8 of rows t / 8 + 32 it (A rows
  // for it < 4, B rows after), their row pointers fixed for the tile
  const int lc = t & 7;
  const uint32_t* rowp[LOADS];
  bool rowok[LOADS];
  uint32_t dst0[LOADS];
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    const int r = (t >> 3) + 32 * it;
    const bool is_a = it < 4;
    const long long row = is_a ? m0 + r : n0 + (r - WG_BM);
    rowok[it] = row < (is_a ? m : n);
    rowp[it] = (is_a ? a : b) + (rowok[it] ? row : 0) * kw + lc;
    dst0[it] = smem_u32(packed + r * WPITCH + lc);
  }
  auto load = [&](int chunk) {               // packed words, zero-filled
    const uint32_t st = (chunk % STAGES) * PACKED_STAGE * 4;
    const long long k0 = (c0 + chunk) * KC;
    const bool colok = k0 + lc < kw;
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const bool ok = rowok[it] && colok;
      cp_async4(dst0[it] + st, ok ? rowp[it] + k0 : a, ok);
    }
  };
  auto expand_b = [&](int chunk) {           // B rows -> int8 core matrices
    const uint32_t* st = packed + (chunk % STAGES) * PACKED_STAGE;
    uint8_t* dst = bexp + (chunk & 1) * BEXP_CHUNK;
    const int r = t;                         // 256 threads, 256 rows
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const uint32_t x = st[(WG_BM + r) * WPITCH + k];
      uint4 lo, hi;
      lo.x = pm1(x & 0x01010101u);
      lo.y = pm1((x >> 1) & 0x01010101u);
      lo.z = pm1((x >> 2) & 0x01010101u);
      lo.w = pm1((x >> 3) & 0x01010101u);
      hi.x = pm1((x >> 4) & 0x01010101u);
      hi.y = pm1((x >> 5) & 0x01010101u);
      hi.z = pm1((x >> 6) & 0x01010101u);
      hi.w = pm1((x >> 7) & 0x01010101u);
      uint8_t* core = dst + k * BEXP_K + (r & 7) * 16;
      *reinterpret_cast<uint4*>(core + (r >> 3) * N_STEP) = lo;
      *reinterpret_cast<uint4*>(core + (r >> 3) * N_STEP + K_STEP) = hi;
    }
  };
  auto expand_a = [&](int chunk, uint32_t (&ar)[KC][4]) {
    const uint32_t* st = packed + (chunk % STAGES) * PACKED_STAGE;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const uint32_t x0 = st[arow * WPITCH + k] >> tig;
      const uint32_t x1 = st[(arow + 8) * WPITCH + k] >> tig;
      ar[k][0] = pm1(x0 & 0x01010101u);
      ar[k][1] = pm1(x1 & 0x01010101u);
      ar[k][2] = pm1((x0 >> 4) & 0x01010101u);
      ar[k][3] = pm1((x1 >> 4) & 0x01010101u);
    }
  };

  int acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0;
  uint32_t ar[2][KC][4];

  // chunk j: packed into stage j % STAGES, expanded during step j - 1
  load(0);
  cp_async_commit();
  if (1 < n_chunks) load(1);
  cp_async_commit();
  if (n_chunks > 0) {
    cp_async_wait<1>();
    __syncthreads();
    expand_b(0);
    expand_a(0, ar[0]);
  }
  if (2 < n_chunks) load(2);
  cp_async_commit();
  fence_proxy_async();
  __syncthreads();

  // Step i: the products of chunk i go to the tensor cores; while they
  // run, chunk i + 1 is expanded into the buffers chunk i - 1 used.
  auto step = [&](int i, uint32_t (&cur)[KC][4], uint32_t (&nxt)[KC][4]) {
    const uint8_t* bk = bexp + (i & 1) * BEXP_CHUNK;
#pragma unroll
    for (int e = 0; e < NACC; ++e) pin(acc[e]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      wgmma_m64n256k32(acc, cur[k][0], cur[k][1], cur[k][2], cur[k][3],
                       b_desc(bk + k * BEXP_K));
    }
    wgmma_commit();
    if (i + 1 < n_chunks) {
      wgmma_wait<1>();                       // chunk i - 1's products done
#pragma unroll
      for (int k = 0; k < KC; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(nxt[k][e]);
      cp_async_wait<1>();                    // chunk i + 1 landed
      __syncthreads();                       // for every thread, and both
      expand_b(i + 1);                       // warpgroups are past i - 1
      expand_a(i + 1, nxt);
      fence_proxy_async();
      if (i + 3 < n_chunks) load(i + 3);     // into chunk i's stage
      cp_async_commit();
      __syncthreads();                       // chunk i + 1 expanded by all
    }
  };
  for (int i = 0; i < n_chunks; i += 2) {
    step(i, ar[0], ar[1]);
    if (i + 1 < n_chunks) step(i + 1, ar[1], ar[0]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < NACC; ++e) pin(acc[e]);
  cp_async_wait<0>();

  const int corr = (blockIdx.z == 0 ? k_bits : 0) - 32 * KC * n_chunks;
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = m0 + arow + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long c = n0 + 8 * j + 2 * tig;
      const int v0 = acc[4 * j + 2 * h] + corr;
      const int v1 = acc[4 * j + 2 * h + 1] + corr;
      int* o = out + r * n + c;
      if (atomic) {
        if (c < n) atomicAdd(o, v0);
        if (c + 1 < n) atomicAdd(o + 1, v1);
      } else if (pairs && c + 1 < n) {
        *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
      } else {
        if (c < n) o[0] = v0;
        if (c + 1 < n) o[1] = v1;
      }
    }
  }
}

int launch_wgmma(const void* a, const void* b, void* out, long long m,
                 long long n, long long kw, int k_bits, long long tiles,
                 long long tiles_n, int splits, int chunks_per_split,
                 cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        binary_matmul_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid(static_cast<unsigned>(tiles), 1, static_cast<unsigned>(splits));
  binary_matmul_wgmma<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int*>(out), m, n, kw, k_bits, tiles_n, chunks_per_split,
      splits > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a: (m, kw) and b: (n, kw) packed uint32 words on the device, row-major;
// out: (m, n) int32, zeroed by the caller when splits > 1 (kw = 0 gives
// k_bits everywhere). Pad bits beyond k_bits must be zero in both
// operands. config 0, 1, 2: 128x256 tiles on wgmma, 64x64 and 128x8 tiles
// on mma.sync (tiles_m x tiles_n of them on grid x, M-major); K in chunks
// of 8 words, chunks_per_split of them for each of the splits on grid z.
// Returns cudaGetLastError() after the launch.
int binary_matmul_launch(const void* a, const void* b, void* out,
                         long long m, long long n, long long kw, int k_bits,
                         int config, long long tiles_m, long long tiles_n,
                         int splits, int chunks_per_split, void* stream) {
  static const int tile_m[3] = {WG_BM, 64, 128}, tile_n[3] = {WG_BN, 64, 8};
  if (m <= 0 || n <= 0 || kw < 0 || config < 0 || config > 2 ||
      splits < 1 || splits > 65535 || chunks_per_split < 1 ||
      tiles_m != (m + tile_m[config] - 1) / tile_m[config] ||
      tiles_n != (n + tile_n[config] - 1) / tile_n[config] ||
      tiles_m * tiles_n > 2147483647LL ||
      (long long)splits * chunks_per_split * KC < kw)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = tiles_m * tiles_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      return launch_wgmma(a, b, out, m, n, kw, k_bits, tiles, tiles_n, splits,
                          chunks_per_split, s);
    case 1:
      return launch_mma<2, 2, 2, 4>(a, b, out, m, n, kw, k_bits, tiles,
                                    tiles_n, splits, chunks_per_split, s);
    default:
      return launch_mma<4, 1, 2, 1>(a, b, out, m, n, kw, k_bits, tiles,
                                    tiles_n, splits, chunks_per_split, s);
  }
}

}  // extern "C"
