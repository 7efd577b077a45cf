// Fused bulk-bitwise expression kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels fused_bitwise and fused_bitwise_stacked of
// src/repro/kernels/bitwise.py. Those trace one Pallas body per
// expression (E.eval_expr over VMEM tiles). Compiling CUDA per
// expression would run nvcc in the middle of serving, so here the
// expression DAG is lowered once in Python (repro_torch/kernels/bitwise.py
// `lower`) into a small register program, and ONE kernel interprets it
// for every word. Every thread runs the same instruction stream, so the
// interpreter never diverges.
//
// Bound on this card: bytes. Each output word needs one 4-byte read of
// every operand the program loads and one 4-byte write, and a handful of
// integer ops: 4 * rows * words * (N + 1) bytes at 3.35 TB/s. The design
// answers that: a grid-stride loop streams each operand once, 16-byte
// loads and stores (uint4) where every pointer is 16-byte aligned, a
// scalar path for the ragged tail or unaligned operands, the whole
// program in shared memory, intermediates in per-thread registers/local
// memory (never in device memory), and the caller's tail mask folded into
// the store so one launch is the whole step.
//
// The stacked form (one launch for an epoch of queries) uses grid
// dimension y for the query and reads a table of per-query operand and
// output pointers: no operand is copied into a stack. The table travels
// by value in the launch's parameters when it fits (PARAM_PTRS pointers,
// which covers an epoch of 16 queries of up to 23 operands), so a launch
// costs no host-to-device copy; a larger epoch passes a device table.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_OPERANDS 32
#define MAX_INSTR 512
#define MAX_REGS 64
#define PARAM_PTRS 384   // 3 KB: the table stays under the 4 KB parameter limit

struct PtrTable {
  unsigned long long p[PARAM_PTRS];
};

enum {
  OP_LOAD = 0, OP_ZERO = 1, OP_ONE = 2, OP_NOT = 3,
  OP_AND = 4, OP_OR = 5, OP_XOR = 6, OP_MAJ = 7
};

__device__ __forceinline__ uint32_t v_zero(uint32_t) { return 0u; }
__device__ __forceinline__ uint4 v_zero(uint4) { return make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ uint32_t v_not(uint32_t a) { return ~a; }
__device__ __forceinline__ uint4 v_not(uint4 a) {
  return make_uint4(~a.x, ~a.y, ~a.z, ~a.w);
}
__device__ __forceinline__ uint32_t v_and(uint32_t a, uint32_t b) { return a & b; }
__device__ __forceinline__ uint4 v_and(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint32_t v_or(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 v_or(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t v_xor(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint4 v_xor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
template <typename V>
__device__ __forceinline__ V v_maj(V a, V b, V c) {
  return v_or(v_or(v_and(a, b), v_and(b, c)), v_and(c, a));
}

// Tail mask of the word in column `col` of a row of n_bits bits.
__device__ __forceinline__ uint32_t col_mask(long long col, long long full,
                                             uint32_t rem_mask) {
  return col < full ? 0xFFFFFFFFu : (col == full ? rem_mask : 0u);
}

// Run the program for element i (in units of V) and return the result.
template <typename V>
__device__ __forceinline__ V run_program(const int4* prog, int n_instr,
                                         int result_reg,
                                         const uint32_t* const* ptr,
                                         long long i, V* reg) {
  for (int k = 0; k < n_instr; ++k) {
    const int4 ins = prog[k];
    const int op = ins.x & 0xFFFF;
    switch (op) {
      case OP_LOAD:
        reg[ins.y] = reinterpret_cast<const V*>(ptr[ins.z])[i];
        break;
      case OP_ZERO: reg[ins.y] = v_zero(V()); break;
      case OP_ONE: reg[ins.y] = v_not(v_zero(V())); break;
      case OP_NOT: reg[ins.y] = v_not(reg[ins.z]); break;
      case OP_AND: reg[ins.y] = v_and(reg[ins.z], reg[ins.w]); break;
      case OP_OR: reg[ins.y] = v_or(reg[ins.z], reg[ins.w]); break;
      case OP_XOR: reg[ins.y] = v_xor(reg[ins.z], reg[ins.w]); break;
      default:  // OP_MAJ: third source in the high half of ins.x
        reg[ins.y] = v_maj(reg[ins.z], reg[ins.w], reg[ins.x >> 16]);
        break;
    }
  }
  return reg[result_reg];
}

template <bool VEC>
__global__ void fused_bitwise_kernel(const PtrTable params,
                                     const unsigned long long* __restrict__ table,
                                     const int4* __restrict__ prog,
                                     int n_in, int n_instr, int result_reg,
                                     long long n, long long words,
                                     int masked, long long full_words,
                                     uint32_t rem_mask) {
  __shared__ int4 sprog[MAX_INSTR];
  __shared__ const uint32_t* sptr[MAX_OPERANDS + 1];
  const long long q = blockIdx.y;
  for (int k = threadIdx.x; k < n_instr; k += blockDim.x) sprog[k] = prog[k];
  for (int k = threadIdx.x; k <= n_in; k += blockDim.x) {
    const long long at = q * (n_in + 1) + k;
    sptr[k] = reinterpret_cast<const uint32_t*>(table ? table[at]
                                                      : params.p[at]);
  }
  __syncthreads();
  uint32_t* out = const_cast<uint32_t*>(sptr[n_in]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    uint4 reg[MAX_REGS];
    const long long n4 = n >> 2;
    for (long long i = tid; i < n4; i += stride) {
      uint4 r = run_program<uint4>(sprog, n_instr, result_reg, sptr, i, reg);
      if (masked) {
        const long long c = (4 * i) % words;
        r.x &= col_mask(c, full_words, rem_mask);
        r.y &= col_mask((c + 1) % words, full_words, rem_mask);
        r.z &= col_mask((c + 2) % words, full_words, rem_mask);
        r.w &= col_mask((c + 3) % words, full_words, rem_mask);
      }
      reinterpret_cast<uint4*>(out)[i] = r;
    }
    done = 4 * n4;
  }
  uint32_t sreg[MAX_REGS];
  for (long long i = done + tid; i < n; i += stride) {
    uint32_t r = run_program<uint32_t>(sprog, n_instr, result_reg, sptr, i, sreg);
    if (masked) r &= col_mask(i % words, full_words, rem_mask);
    out[i] = r;
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
// prog:  device array of n_instr int4 instructions.
// n_bits < 0 leaves the result unmasked; otherwise bits past n_bits of
// every row are cleared. vec selects the 16-byte path (all pointers
// 16-byte aligned). Returns cudaGetLastError() after the launch.
int fused_bitwise_launch(const unsigned long long* ptrs,
                         const void* dev_table, const void* prog, int n_in,
                         int n_instr, int result_reg, long long n,
                         long long words, long long n_bits, int vec,
                         int queries, void* stream) {
  if (n_in < 1 || n_in > MAX_OPERANDS || n_instr < 1 ||
      n_instr > MAX_INSTR || queries < 1 || queries > 65535 || n <= 0 ||
      words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PtrTable params;
  const long long n_ptrs = (long long)queries * (n_in + 1);
  if (dev_table == nullptr) {
    if (ptrs == nullptr || n_ptrs > PARAM_PTRS)
      return static_cast<int>(cudaErrorInvalidValue);
    for (long long k = 0; k < n_ptrs; ++k) params.p[k] = ptrs[k];
  }
  const int masked = n_bits >= 0 && n_bits < words * 32;
  const long long full = masked ? n_bits / 32 : 0;
  const uint32_t rem_mask =
      masked && (n_bits % 32) ? ((1u << (n_bits % 32)) - 1u) : 0u;
  const int threads = 256;
  const long long units = vec ? (n >> 2) + (n & 3) : n;
  long long blocks = (units + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(queries));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* t =
      static_cast<const unsigned long long*>(dev_table);
  const int4* p = static_cast<const int4*>(prog);
  if (vec)
    fused_bitwise_kernel<true><<<grid, threads, 0, s>>>(
        params, t, p, n_in, n_instr, result_reg, n, words, masked, full, rem_mask);
  else
    fused_bitwise_kernel<false><<<grid, threads, 0, s>>>(
        params, t, p, n_in, n_instr, result_reg, n, words, masked, full, rem_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
