// Fused bulk-bitwise expression kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels fused_bitwise and fused_bitwise_stacked of
// src/repro/kernels/bitwise.py. Those trace one Pallas body per
// expression (E.eval_expr over VMEM tiles). Compiling CUDA per
// expression would run nvcc in the middle of serving, so here the
// expression DAG is lowered once in Python (repro_torch/kernels/bitwise.py
// `lower`) into a small register program, and ONE kernel interprets it.
// Every thread runs the same instruction stream, so the interpreter never
// diverges.
//
// Bound on this card: bytes. Each output word needs one 4-byte read of
// every operand the program loads and one 4-byte write, and a handful of
// integer ops: 4 * rows * words * (N + 1) bytes at 3.35 TB/s. What the
// design does about it:
//
// - Bytes in flight. `lower` puts every load first. A block takes a tile
//   of W * 256 words; each thread issues the 4-byte cp.async copies of
//   all its W words of every operand before any compute, and waits once.
//   So a thread has (loads * W) copies in flight, not one, and no
//   register holds them: they land in the register file in shared memory.
//   A warp's copies of one operand are 128 consecutive bytes, so any
//   4-byte-aligned view (the odd rows of a TPC-H plane) is coalesced: one
//   path, no 16-byte special case.
// - The register file lives in shared memory, laid out [reg][w][thread]:
//   each thread reads and writes only its own column, which is
//   conflict-free, and no array is indexed at run time in registers (no
//   local-memory stack frame). Its size follows the program: the wrapper
//   picks W from the register count (`launch_shape`), so small programs
//   get more words per decode.
// - No per-block start-up: the program (one packed 32-bit word an
//   instruction) and the pointer table travel in the launch's parameter
//   space (up to 32,764 bytes since CUDA 12.1), read through the constant
//   cache; no copy into shared memory and no __syncthreads. A decode is
//   shared by the thread's W words. The parameter block is 896 bytes for
//   a launch of at most SMALL_PTRS pointers and SMALL_INSTR instructions
//   (every bitmap epoch and TPC-H query), 5,120 bytes otherwise: the
//   smaller block takes a few percent off a launch (chip_smoke.py).
// - The tail mask works per row: the column of a word comes from a
//   multiply-high division by the row length (magic from the wrapper), not
//   from a 64-bit `%`.
//
// The stacked form (one launch for an epoch of queries) uses grid
// dimension y for the query and reads a table of per-query operand and
// output pointers: no operand is copied into a stack. The table travels
// by value when it fits (PARAM_PTRS pointers), else in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "bitwise.cu passes 5 KB of kernel parameters: it needs CUDA 12.1 or later"
#endif

#define MAX_OPERANDS 32
#define MAX_INSTR 512
#define MAX_REGS 64
#define PARAM_PTRS 384   // pointers passed by value in the launch
#define THREADS 256

#define SMALL_PTRS 48     // a launch of at most this many pointers and
#define SMALL_INSTR 128   // instructions passes 896 bytes, not 5,120

template <int P, int I>
struct Params {
  unsigned long long p[P];
  uint32_t prog[I];   // op | dst << 3 | s0 << 9 | s1 << 15 | s2 << 21
};

enum {
  OP_LOAD = 0, OP_ZERO = 1, OP_ONE = 2, OP_NOT = 3,
  OP_AND = 4, OP_OR = 5, OP_XOR = 6, OP_MAJ = 7
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Tail mask of the word in column `col` of a row of n_bits bits.
__device__ __forceinline__ uint32_t col_mask(long long col, long long full,
                                             uint32_t rem_mask) {
  return col < full ? 0xFFFFFFFFu : (col == full ? rem_mask : 0u);
}

// One instruction over the thread's W words: sources from its column of
// the register file, the result into v.
template <int W>
__device__ __forceinline__ void eval_ins(uint32_t ins, const uint32_t* mine,
                                         uint32_t (&v)[W]) {
  constexpr int REG = W * THREADS;
  const uint32_t* a = mine + REG * ((ins >> 9) & 63);
  const uint32_t* b = mine + REG * ((ins >> 15) & 63);
  switch (ins & 7) {
    case OP_ZERO:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = 0u;
      break;
    case OP_ONE:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = 0xFFFFFFFFu;
      break;
    case OP_NOT:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = ~a[w * THREADS];
      break;
    case OP_AND:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = a[w * THREADS] & b[w * THREADS];
      break;
    case OP_OR:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = a[w * THREADS] | b[w * THREADS];
      break;
    case OP_XOR:
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = a[w * THREADS] ^ b[w * THREADS];
      break;
    default: {  // OP_MAJ (lower never emits a load past the loads)
      const uint32_t* c = mine + REG * ((ins >> 21) & 63);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t x = a[w * THREADS], y = b[w * THREADS],
                       z = c[w * THREADS];
        v[w] = (x & y) | (y & z) | (z & x);
      }
      break;
    }
  }
}

template <int W, class PR>
__global__ void __launch_bounds__(THREADS)
fused_bitwise_kernel(const PR params,
                     const unsigned long long* __restrict__ table,
                     int n_in, int n_loads, int n_instr, int result_reg,
                     long long n, int masked,
                     long long words, uint32_t div_mul, int div_shift,
                     long long full_words, uint32_t rem_mask) {
  extern __shared__ uint32_t file[];   // [reg][W][THREADS]
  const int t = threadIdx.x;
  const long long q = blockIdx.y;
  // never a pointer into the parameters: that would copy them to the stack
  const long long row = q * (n_in + 1);
#define PTR_AT(k) (table ? table[row + (k)] : params.p[row + (k)])
  uint32_t* out = reinterpret_cast<uint32_t*>(PTR_AT(n_in));
  uint32_t* mine = file + t;
  const uint32_t mine_s = static_cast<uint32_t>(__cvta_generic_to_shared(mine));
  constexpr int REG = W * THREADS;     // words between two registers
  const long long base = (long long)blockIdx.x * REG + t;
  // every operand word of the tile in flight before any compute
  for (int k = 0; k < n_loads; ++k) {
    const uint32_t ins = params.prog[k];
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(PTR_AT((ins >> 9) & 63));
    const uint32_t dst = mine_s + 4u * REG * ((ins >> 3) & 63);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const long long i = base + (long long)w * THREADS;
      if (i < n) cp_async4(dst + 4u * THREADS * w, src + i);
    }
  }
  cp_async_wait_all();
  // every instruction but the last writes its register back; the last
  // one's words stay in registers for the store
  uint32_t v[W];
  for (int k = n_loads; k < n_instr; ++k) {
    eval_ins<W>(params.prog[k], mine, v);
    if (k + 1 < n_instr) {
      uint32_t* d = mine + REG * ((params.prog[k] >> 3) & 63);
#pragma unroll
      for (int w = 0; w < W; ++w) d[w * THREADS] = v[w];
    }
  }
  if (n_loads == n_instr) {          // the result is a loaded operand
    const uint32_t* r = mine + REG * result_reg;
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = r[w * THREADS];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const long long i = base + (long long)w * THREADS;
    if (i < n) {
      uint32_t x = v[w];
      if (masked) {
        long long col;
        if (i < 0x80000000LL && words < 0x80000000LL) {  // multiply-high
          const uint32_t u = static_cast<uint32_t>(i);
          const uint32_t quo = (__umulhi(u, div_mul) + u) >> div_shift;
          col = static_cast<long long>(u - quo * static_cast<uint32_t>(words));
        } else {
          col = i % words;
        }
        x &= col_mask(col, full_words, rem_mask);
      }
      out[i] = x;
    }
  }
#undef PTR_AT
}

template <int W, class PR>
int launch_w(const PR& params, const unsigned long long* table,
             int n_in, int n_loads, int n_instr, int result_reg,
             int n_regs, long long n, long long words, long long n_bits,
             unsigned div_mul, int div_shift, int queries,
             cudaStream_t stream) {
  constexpr long long per_tile = (long long)W * THREADS;
  const size_t smem = static_cast<size_t>(n_regs) * per_tile * 4;
  static bool opted_in = false;       // the largest file the bucket needs
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_bitwise_kernel<W, PR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_REGS * static_cast<int>(per_tile) * 4 > 232448
            ? 232448 : MAX_REGS * static_cast<int>(per_tile) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int masked = n_bits >= 0 && n_bits < words * 32;
  const long long full = masked ? n_bits / 32 : 0;
  const uint32_t rem_mask =
      masked && (n_bits % 32) ? ((1u << (n_bits % 32)) - 1u) : 0u;
  const long long tiles = (n + per_tile - 1) / per_tile;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(queries));
  fused_bitwise_kernel<W, PR><<<grid, THREADS, smem, stream>>>(
      params, table, n_in, n_loads, n_instr, result_reg, n, masked,
      words, div_mul, div_shift, full, rem_mask);
  return static_cast<int>(cudaGetLastError());
}

// Fill a parameter block of type PR and launch the W bucket's kernel.
template <class PR>
int launch_params(const unsigned long long* ptrs, const void* dev_table,
                  const unsigned* prog, int n_in, int n_loads, int n_instr,
                  int result_reg, int n_regs, int w, long long n,
                  long long words, long long n_bits, unsigned div_mul,
                  int div_shift, int queries, long long n_ptrs,
                  void* stream) {
  PR params;
  for (int k = 0; k < n_instr; ++k) params.prog[k] = prog[k];
  if (dev_table == nullptr)
    for (long long k = 0; k < n_ptrs; ++k) params.p[k] = ptrs[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* t =
      static_cast<const unsigned long long*>(dev_table);
  switch (w) {
    case 8:
      return launch_w<8>(params, t, n_in, n_loads, n_instr, result_reg,
                         n_regs, n, words, n_bits, div_mul, div_shift,
                         queries, s);
    case 4:
      return launch_w<4>(params, t, n_in, n_loads, n_instr, result_reg,
                         n_regs, n, words, n_bits, div_mul, div_shift,
                         queries, s);
    case 2:
      return launch_w<2>(params, t, n_in, n_loads, n_instr, result_reg,
                         n_regs, n, words, n_bits, div_mul, div_shift,
                         queries, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptrs:  queries * (n_in + 1) pointers (operands, then the output) to
//        (rows, words) uint32 buffers of n = rows * words, in host memory
//        (at most PARAM_PTRS of them), or NULL when dev_table holds them
//        in device memory.
// prog:  n_instr packed instructions in host memory, its n_loads loads
//        first; the register file takes n_regs * w * 256 * 4 bytes of
//        shared memory, w in {2, 4, 8}.
// One block a tile of w * 256 words (grid x), one row of blocks a query
// (grid y). small_ok lets a launch of at most SMALL_PTRS pointers and
// SMALL_INSTR instructions pass the smaller parameter block.
// n_bits < 0 leaves the result unmasked; otherwise bits past n_bits of
// every row are cleared. The column of flat index i is
// i - words * ((umulhi(i, div_mul) + i) >> div_shift) while i and words
// are below 2^31, i % words past that. Returns cudaGetLastError() after
// the launch.
int fused_bitwise_launch(const unsigned long long* ptrs,
                         const void* dev_table, const unsigned* prog,
                         int n_in, int n_loads, int n_instr, int result_reg,
                         int n_regs, int w, long long n, long long words,
                         long long n_bits, unsigned div_mul, int div_shift,
                         int queries, int small_ok, void* stream) {
  if (n_in < 1 || n_in > MAX_OPERANDS || n_instr < 1 ||
      n_instr > MAX_INSTR || n_loads < 0 || n_loads > n_instr ||
      n_regs < 1 || n_regs > MAX_REGS || result_reg < 0 ||
      result_reg >= n_regs || queries < 1 || queries > 65535 || n <= 0 ||
      words <= 0 || words > 0xFFFFFFFFLL || prog == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ptrs = (long long)queries * (n_in + 1);
  if (dev_table == nullptr && (ptrs == nullptr || n_ptrs > PARAM_PTRS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (small_ok && n_ptrs <= SMALL_PTRS && n_instr <= SMALL_INSTR)
    return launch_params<Params<SMALL_PTRS, SMALL_INSTR>>(
        ptrs, dev_table, prog, n_in, n_loads, n_instr, result_reg, n_regs, w,
        n, words, n_bits, div_mul, div_shift, queries, n_ptrs, stream);
  return launch_params<Params<PARAM_PTRS, MAX_INSTR>>(
      ptrs, dev_table, prog, n_in, n_loads, n_instr, result_reg, n_regs, w, n,
      words, n_bits, div_mul, div_shift, queries, n_ptrs, stream);
}

}  // extern "C"
