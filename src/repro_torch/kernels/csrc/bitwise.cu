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
// Bound on this card: HBM bytes and the interpreter. Each output word
// needs one 4-byte read of every operand the program loads and one 4-byte
// write (4 * rows * words * (loads + 1) bytes at 3.35 TB/s). But a served
// TPC-H program runs 45-116 instructions a word, each a dispatch, a
// shared-memory read or two and often a write back, so the interpreter's
// instructions and shared-memory bytes, not HBM's, set the pace unless it
// keeps them few and keeps enough tiles in evaluation to hide its
// latency. What the design does about it:
//
// - Values forwarded in registers. `lower` marks in the five spare bits of
//   each packed instruction which sources are the previous instruction's
//   result (read from the thread's registers, not shared memory), whether
//   the result has a later, non-adjacent reader (only then is it written
//   back), and whether source 1 is read negated (a NOT of a load folded
//   into its readers). The thread's W words of the running result stay in
//   v[W]; loads and kept results live in shared memory, [reg][word of the
//   tile], each thread in its own columns (conflict-free), and only they
//   hold registers, so the file is small.
// - Decode from shared memory. A persistent block resolves the program
//   once (per ring stage, again only when the operands' alignment
//   changes) into 16-byte entries: each source's shared address and the
//   op with its forwarding folded into one form, the three forms the
//   served programs run most tested first. An instruction costs one
//   broadcast load and one dispatch, whatever size of parameter block
//   carried it.
// - Operand tiles streamed by TMA. A producer warp issues one 1-D
//   cp.async.bulk per loaded operand and tile into a ring stage (an
//   mbarrier counts its bytes) while the consumer warps evaluate an
//   earlier stage; a loaded register IS its slot in the stage, with no
//   copy into the file. A bulk copy needs 16-byte-aligned addresses and
//   sizes, and a row of a TPC-H plane starts 4, 8 or 12 bytes off one, so
//   the copy takes the aligned span that encloses the tile (the span stays
//   within the 16-byte granules that hold the operand's own words, so it
//   never leaves its allocation's pages) and the program indexes each
//   operand at its own shift. A warp still reads consecutive words.
// - Persistent blocks walk (query, tile) pairs, query-major: the grid is
//   min(pairs, resident blocks), so a launch that fits the card at once
//   runs one tile a block, and a long row or a stacked epoch walks its
//   tiles. The ring is as deep as it can be without costing a resident
//   block (`plan`): the served programs' many slots leave it one stage
//   deep, and co-resident blocks overlap each other's copies; small
//   programs get up to MAX_STAGES.
// - The result is stored from registers, masked per row: the column of a
//   word comes from a multiply-high division by the row length (magic from
//   the wrapper), not from a 64-bit `%`.
//
// In place (`out` aliasing an operand) stays legal: tiles are disjoint,
// a tile's operand words land in shared memory before its result is
// stored, and the few words a copy's alignment slack takes from a
// neighbouring tile are never read.
//
// The stacked form (one launch for an epoch of queries) reads a table of
// per-query operand and output pointers: no operand is copied into a
// stack. The table travels by value when it fits (PARAM_PTRS pointers),
// else in device memory.
//
// A program of more loads than the producer warp has lanes (WARP_LOADS;
// the four-column Star Schema conjunctions load 38 planes) takes a
// parameter block of its own type, WideParams: each producer lane then
// issues the copies of loads lane and lane + 32, and the shifts of loads
// 32 and up get a third signature word. Every program of at most
// WARP_LOADS loads runs the instances it ran before, unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "bitwise.cu passes 5 KB of kernel parameters: it needs CUDA 12.1 or later"
#endif

#define MAX_OPERANDS 48
#define WARP_LOADS 32    // loads a producer warp issues, one a lane
#define MAX_INSTR 512
#define MAX_REGS 64
#define PARAM_PTRS 384   // pointers passed by value in the launch
#define SMALL_PTRS 48     // a launch of at most this many pointers and
#define SMALL_INSTR 128   // instructions passes 896 bytes, not 5,120
#define MAX_STAGES 4     // ring stages a block holds at most
#define MAX_SMEM 232448  // shared memory a block may opt in to on an H100
#define BARRIER_BYTES 64 // full[MAX_STAGES], empty[MAX_STAGES]

// marks in the packed instruction's spare bits (bitwise.py `_kernel_form`):
// bits 27-29 s0, s1, s2 forwarded; 30 result kept; 31 s1 read negated
#define MARK_SHIFT 27

template <int P, int I>
struct Params {
  static constexpr int LANE_LOADS = 1;    // loads a producer lane issues
  unsigned long long p[P];
  uint32_t prog[I];   // op | dst << 3 | s0 << 9 | s1 << 15 | s2 << 21 | marks
};

// The block of a program of more than WARP_LOADS loads: a producer lane
// issues loads lane and lane + 32.
template <int P, int I>
struct WideParams : Params<P, I> {
  static constexpr int LANE_LOADS = 2;
};

// Launch constants; offsets are bytes of dynamic shared memory.
struct Shape {
  int n_in, n_loads, n_comp, result_reg, stages;
  int masked, div_shift, slot_writes;
  uint32_t div_mul, rem_mask, tiles;
  uint32_t prog_stride, stage_off, stage_bytes, file_off;
  long long n, queries, words, full_words;
};

enum {
  OP_LOAD = 0, OP_ZERO = 1, OP_ONE = 2, OP_NOT = 3,
  OP_AND = 4, OP_OR = 5, OP_XOR = 6, OP_MAJ = 7
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Tail mask of the word in column `col` of a row of n_bits bits.
__device__ __forceinline__ uint32_t col_mask(long long col, long long full,
                                             uint32_t rem_mask) {
  return col < full ? 0xFFFFFFFFu : (col == full ? rem_mask : 0u);
}

// A resolved entry (one uint4 an instruction): .y, .z and .w the shared
// addresses of word 0 of sources a and b and of the destination; .x the
// form, as bits for the three forms the served programs run most (a & b,
// a | b with a the running result; a & b read) and as a number for the
// rest; whether b is read negated (NEG) and the result kept (KEEP); MAJ's
// forwarded sources and its c's word offset. A binary op with one
// forwarded source takes it as a (the ops are commutative); a negated
// source is a load, so never forwarded.
enum {
  FM_ZERO = 0, FM_ONE = 1, FM_NOT_N = 2, FM_NOT_F = 3, FM_AND_N = 4,
  FM_AND_F = 5, FM_OR_N = 6, FM_OR_F = 7, FM_XOR_N = 8, FM_XOR_F = 9,
  FM_SAME = 10, FM_MAJ = 11
};
#define E_KEEP (1u << 4)
#define E_FA (1u << 5)
#define E_FB (1u << 6)
#define E_FC (1u << 7)
#define E_AND_F (1u << 8)
#define E_OR_F (1u << 9)
#define E_AND_N (1u << 10)
#define E_NEG (1u << 11)

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// One resolved entry over the thread's W words (word w at byte
// tb + 4 w CT of a register; shared memory from sm_s) into the running
// result v.
template <int W, int CT>
__device__ __forceinline__ void eval_entry(const uint4 e, uint32_t tb,
                                           uint32_t sm_s, uint32_t (&v)[W]) {
  const uint32_t a = e.y + tb, b = e.z + tb;
  const uint32_t m = 0u - ((e.x >> 11) & 1u);      // b's negation mask
  uint32_t x[W];
  if (e.x & E_AND_F) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] &= lds(b + 4u * w * CT) ^ m;
  } else if (e.x & E_OR_F) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] |= lds(b + 4u * w * CT) ^ m;
  } else if (e.x & E_AND_N) {
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = lds(a + 4u * w * CT);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = x[w] & (lds(b + 4u * w * CT) ^ m);
  } else {
    switch (e.x & 15) {
      case FM_ZERO:
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = 0u;
        break;
      case FM_ONE:
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = 0xFFFFFFFFu;
        break;
      case FM_NOT_N:
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = ~lds(a + 4u * w * CT);
        break;
      case FM_NOT_F:
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = ~v[w];
        break;
      case FM_OR_N:
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = lds(a + 4u * w * CT);
#pragma unroll
        for (int w = 0; w < W; ++w)
          v[w] = x[w] | (lds(b + 4u * w * CT) ^ m);
        break;
      case FM_XOR_N:
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = lds(a + 4u * w * CT);
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = x[w] ^ lds(b + 4u * w * CT) ^ m;
        break;
      case FM_XOR_F:
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] ^= lds(b + 4u * w * CT) ^ m;
        break;
      case FM_SAME:
        break;
      default: {  // FM_MAJ, each source forwarded or read
        const uint32_t c = sm_s + 4u * (e.x >> 16) + tb;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t p = e.x & E_FA ? v[w] : lds(a + 4u * w * CT);
          const uint32_t q = e.x & E_FB ? v[w] : lds(b + 4u * w * CT);
          const uint32_t r = e.x & E_FC ? v[w] : lds(c + 4u * w * CT);
          v[w] = (p & q) | (q & r) | (r & p);
        }
        break;
      }
    }
  }
  if (e.x & E_KEEP) {
#pragma unroll
    for (int w = 0; w < W; ++w) sts(e.w + tb + 4u * w * CT, v[w]);
  }
}

// The resolved .x of packed instruction `ins` (op and marks; c's word
// offset for MAJ).
__device__ __forceinline__ uint32_t entry_x(uint32_t ins, uint32_t c_word) {
  const uint32_t op = ins & 7, marks = ins >> MARK_SHIFT;
  const uint32_t f0 = marks & 1, f1 = (marks >> 1) & 1;
  const uint32_t flags = (marks & 8 ? E_KEEP : 0u) | (marks & 16 ? E_NEG : 0u);
  switch (op) {
    case OP_ZERO: return FM_ZERO | flags;
    case OP_ONE: return FM_ONE | flags;
    case OP_NOT: return (f0 ? FM_NOT_F : FM_NOT_N) | flags;
    case OP_MAJ: return FM_MAJ | flags | (marks & 7) << 5 | c_word << 16;
    default: {  // and, or, xor
      if (f0 && f1) return (op == OP_XOR ? FM_ZERO : FM_SAME) | flags;
      const uint32_t fwd = f0 | f1;
      const uint32_t form = (op == OP_AND ? FM_AND_N : op == OP_OR
                             ? FM_OR_N : FM_XOR_N) + fwd;
      const uint32_t hot = form == FM_AND_F ? E_AND_F
                         : form == FM_OR_F ? E_OR_F
                         : form == FM_AND_N ? E_AND_N : 0u;
      return form | hot | flags;
    }
  }
}

// A block's walk over (query, tile) pairs, query-major: pair b, then
// b + gridDim.x, ...; a division only where the walk crosses a query.
struct Walk {
  uint32_t q, tile, tiles, stride;
  long long queries;
  __device__ __forceinline__ Walk(uint32_t tiles_, long long queries_)
      : q(queries_ == 1 ? 0u : blockIdx.x / tiles_),
        tile(queries_ == 1 ? blockIdx.x : blockIdx.x % tiles_),
        tiles(tiles_), stride(gridDim.x), queries(queries_) {}
  __device__ __forceinline__ bool more() const { return q < queries; }
  __device__ __forceinline__ void next() {
    tile += stride;                 // tiles, stride < 2^31: no overflow
    if (tile >= tiles) {
      q += tile / tiles;
      tile %= tiles;
    }
  }
};

// never a pointer into the parameters: that would copy them to the stack
#define PTR_AT(k) (table ? table[(k)] : params.p[(k)])

// The 16-byte-aligned span that encloses words [i0, i1) of `src`: its
// start and bytes; returns the words' shift past its start.
__device__ __forceinline__ uint32_t aligned_span(const uint32_t* src,
                                                 long long i0, long long i1,
                                                 const char** from,
                                                 uint32_t* bytes) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src + i0);
  const uintptr_t a1 = reinterpret_cast<uintptr_t>(src + i1);
  *from = reinterpret_cast<const char*>(a0 & ~uintptr_t(15));
  *bytes = static_cast<uint32_t>(((a1 + 15) & ~uintptr_t(15)) -
                                 (a0 & ~uintptr_t(15)));
  return static_cast<uint32_t>(a0 & 15);
}

// Warps 0..NC-1 evaluate (CT = 32 NC threads, W words each: a tile of
// T = W CT words); warp NC is the producer.
template <int W, int NC, class PR>
__global__ void __launch_bounds__((NC + 1) * 32)
fused_bitwise_kernel(const PR params,
                     const unsigned long long* __restrict__ table,
                     const Shape sh) {
  constexpr int CT = NC * 32;
  constexpr long long T = (long long)W * CT;
  constexpr uint32_t SLOT = 4u * T + 16u;     // a tile and its slack
  constexpr bool WIDE = PR::LANE_LOADS == 2;  // loads lane + 32 too
  extern __shared__ __align__(128) uint32_t sm[];
  const uint32_t sm_s = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int S = sh.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(sm_s + 8 * s, sh.n_loads + 1);           // full[s]
      mbar_init(sm_s + 8 * (MAX_STAGES + s), NC);        // empty[s]
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int L = sh.n_loads;
  const int n_comp = sh.n_comp;
  if (tid >= CT) {
    // ---- producer: issue each stage's copies, resolve its program ------
    // The program of a stage depends on the query only through the
    // operands' shifts; it is resolved again when they change (lane s
    // holds stage s's: 2 bits an operand, valid bit 0 of `held`; loads
    // 32-47 of a wide program in `held_x`).
    const int lane = tid - CT;
    uint32_t held = 0, held_lo = 0, held_hi = 0, held_x = 0;
    int s = 0;
    uint32_t phase = 0;
    for (Walk it(sh.tiles, sh.queries); it.more(); it.next()) {
      const long long q = it.q;
      const long long i0 = it.tile * T;
      const long long i1 = i0 + T < sh.n ? i0 + T : sh.n;
      const long long row = q * (sh.n_in + 1);
      uint32_t shift = 0;                 // bytes past a 16-byte boundary
      uint32_t bytes = 0;
      const char* from = nullptr;
      if (lane < L)
        shift = aligned_span(reinterpret_cast<const uint32_t*>(
                                 PTR_AT(row + ((params.prog[lane] >> 9) & 63))),
                             i0, i1, &from, &bytes);
      uint32_t shift2 = 0, bytes2 = 0;    // load lane + 32 (wide programs)
      const char* from2 = nullptr;
      if constexpr (WIDE) {
        if (lane + WARP_LOADS < L)
          shift2 = aligned_span(
              reinterpret_cast<const uint32_t*>(PTR_AT(
                  row + ((params.prog[lane + WARP_LOADS] >> 9) & 63))),
              i0, i1, &from2, &bytes2);
      }
      mbar_wait(sm_s + 8 * (MAX_STAGES + s), phase ^ 1);
      const uint32_t stage = sh.stage_off + s * sh.stage_bytes;
      // each copy arrives with its bytes to expect, then is in flight while
      // the program is resolved; the last arrival releases the program
      if (lane < L) {
        mbar_arrive_expect_tx(sm_s + 8 * s, bytes);
        bulk_load(sm_s + stage + lane * SLOT, from, bytes, sm_s + 8 * s);
      }
      if constexpr (WIDE) {
        if (lane + WARP_LOADS < L) {
          mbar_arrive_expect_tx(sm_s + 8 * s, bytes2);
          bulk_load(sm_s + stage + (lane + WARP_LOADS) * SLOT, from2, bytes2,
                    sm_s + 8 * s);
        }
      }
      const uint32_t sig_lo = __reduce_or_sync(
          0xFFFFFFFFu, lane < 16 ? (shift >> 2) << (2 * lane) : 0u);
      const uint32_t sig_hi = __reduce_or_sync(
          0xFFFFFFFFu, lane >= 16 ? (shift >> 2) << (2 * (lane - 16)) : 0u);
      uint32_t sig_x = 0;                 // loads 32-47, on lanes 0-15
      bool stale = !__shfl_sync(0xFFFFFFFFu, held, s) ||
                   __shfl_sync(0xFFFFFFFFu, held_lo, s) != sig_lo ||
                   __shfl_sync(0xFFFFFFFFu, held_hi, s) != sig_hi;
      if constexpr (WIDE) {
        sig_x = __reduce_or_sync(
            0xFFFFFFFFu, lane < 16 ? (shift2 >> 2) << (2 * lane) : 0u);
        stale = __shfl_sync(0xFFFFFFFFu, held_x, s) != sig_x || stale;
      }
      if (stale) {
        // entry k: instruction L + k; entry n_comp: the result's address
        uint4* prog = reinterpret_cast<uint4*>(
            reinterpret_cast<char*>(sm) + BARRIER_BYTES +
            s * sh.prog_stride);
        for (int base = 0; base <= n_comp; base += 32) {
          const int k = base + lane;
          const uint32_t ins = k < n_comp ? params.prog[L + k]
                             : static_cast<uint32_t>(sh.result_reg) << 9;
          const int r[4] = {static_cast<int>((ins >> 9) & 63),
                            static_cast<int>((ins >> 15) & 63),
                            static_cast<int>((ins >> 21) & 63),
                            static_cast<int>((ins >> 3) & 63)};
          uint32_t addr[4];                 // shared address of word 0
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t sh_j = __shfl_sync(0xFFFFFFFFu, shift, r[j] & 31);
            if constexpr (WIDE) {
              const uint32_t sh2 = __shfl_sync(0xFFFFFFFFu, shift2, r[j] & 31);
              if (r[j] >= WARP_LOADS) sh_j = sh2;
            }
            addr[j] = sm_s + (r[j] < L
                ? stage + r[j] * SLOT + sh_j
                : sh.file_off + static_cast<uint32_t>(r[j] - L) *
                      static_cast<uint32_t>(4 * T));
          }
          // a binary op reading s0 and forwarding s1 takes s1 as a
          const uint32_t op = ins & 7;
          const bool swap = op >= OP_AND && op <= OP_XOR &&
                            ((ins >> MARK_SHIFT) & 3) == 2;
          if (k <= n_comp)
            prog[k] = make_uint4(
                k < n_comp ? entry_x(ins, (addr[2] - sm_s) >> 2) : 0u,
                swap ? addr[1] : addr[0], swap ? addr[0] : addr[1], addr[3]);
        }
        if (lane == s) {
          held = 1;
          held_lo = sig_lo;
          held_hi = sig_hi;
          held_x = sig_x;
        }
        __threadfence_block();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm_s + 8 * s);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }
  // ---- consumers: evaluate a stage, release it, store from registers ----
  const uint32_t tb = 4u * tid;       // the thread's byte in a row of words
  int s = 0;
  uint32_t phase = 0;
  for (Walk it(sh.tiles, sh.queries); it.more(); it.next()) {
    const long long q = it.q;
    const long long i0 = it.tile * T;
    uint32_t* out = reinterpret_cast<uint32_t*>(
        PTR_AT(q * (sh.n_in + 1) + sh.n_in));
    mbar_wait(sm_s + 8 * s, phase);
    const uint4* prog = reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(sm) + BARRIER_BYTES +
        s * sh.prog_stride);
    uint32_t v[W];
    if (n_comp == 0) {               // the result is a loaded operand
      const uint32_t r = prog[0].y + tb;
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = lds(r + 4u * w * CT);
    } else {
      // two entries in flight: each is read while the other is evaluated
      uint4 e0 = prog[0];
      int k = 0;
      for (; k + 1 < n_comp; k += 2) {
        const uint4 e1 = prog[k + 1];
        eval_entry<W, CT>(e0, tb, sm_s, v);
        e0 = prog[k + 2];                   // entry n_comp exists
        eval_entry<W, CT>(e1, tb, sm_s, v);
      }
      if (k < n_comp) eval_entry<W, CT>(e0, tb, sm_s, v);
    }
    // results kept in a slot are generic writes the next copy overwrites
    if (sh.slot_writes)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(sm_s + 8 * (MAX_STAGES + s));
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const long long i = i0 + w * CT + tid;
      if (i < sh.n) {
        uint32_t x = v[w];
        if (sh.masked) {
          long long col;
          if (i < 0x80000000LL && sh.words < 0x80000000LL) {  // mulhi
            const uint32_t u = static_cast<uint32_t>(i);
            const uint32_t quo = (__umulhi(u, sh.div_mul) + u) >> sh.div_shift;
            col = static_cast<long long>(
                u - quo * static_cast<uint32_t>(sh.words));
          } else {
            col = i % sh.words;
          }
          x &= col_mask(col, sh.full_words, sh.rem_mask);
        }
        out[i] = x;
      }
    }
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
}
#undef PTR_AT

// Shared memory of a block with `stages` ring stages (bitwise.py
// `shared_bytes` computes the same): barriers, the resolved program per
// stage, the stages' operand slots, the file of registers past the loads.
static long long layout(Shape& sh, int n_regs, long long T, int stages) {
  sh.stages = stages;
  sh.prog_stride = static_cast<uint32_t>((sh.n_comp + 1) * 16);
  const long long progs = BARRIER_BYTES + (long long)stages * sh.prog_stride;
  sh.stage_off = static_cast<uint32_t>((progs + 127) & ~127LL);
  sh.stage_bytes = static_cast<uint32_t>(sh.n_loads * (4 * T + 16));
  sh.file_off = sh.stage_off + stages * sh.stage_bytes;
  const int file_regs = n_regs > sh.n_loads ? n_regs - sh.n_loads : 0;
  return (long long)sh.file_off + (long long)file_regs * 4 * T;
}

static int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Stages and blocks an SM for a program of this shape: the deepest ring
// (1 to MAX_STAGES stages) that keeps as many blocks resident as one stage
// does. The interpreter needs many tiles in evaluation at once to hide its
// latency, so a stage that would cost a resident block is not taken:
// the co-resident blocks then overlap each other's copies instead.
template <int W, int NC, class PR>
static int plan(Shape& sh, int n_regs, int* blocks_per_sm, size_t* smem) {
  constexpr long long T = (long long)W * NC * 32;
  static std::mutex mu;
  static bool opted_in = false;
  static std::unordered_map<long long, int> cache;   // key -> stages | nb
  const long long key = ((long long)sh.n_loads << 20) |
                        ((long long)sh.n_comp << 8) | n_regs;
  std::lock_guard<std::mutex> lock(mu);
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_bitwise_kernel<W, NC, PR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  auto hit = cache.find(key);
  if (hit == cache.end()) {
    int best = 0, best_nb = 0;
    for (int stages = 1; stages <= MAX_STAGES; ++stages) {
      const long long bytes = layout(sh, n_regs, T, stages);
      if (bytes > MAX_SMEM) break;
      int nb = 0;
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, fused_bitwise_kernel<W, NC, PR>, (NC + 1) * 32,
          static_cast<size_t>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (nb == 0 || (best && nb < best_nb)) break;
      best = stages;
      best_nb = nb;
    }
    if (best == 0) return static_cast<int>(cudaErrorInvalidValue);
    hit = cache.emplace(key, best | best_nb << 8).first;
  }
  *smem = static_cast<size_t>(layout(sh, n_regs, T, hit->second & 255));
  *blocks_per_sm = hit->second >> 8;
  return 0;
}

template <int W, int NC, class PR>
static int launch_cfg(const PR& params, const unsigned long long* table,
                      Shape sh, int n_regs, int queries, cudaStream_t stream,
                      int* grid_out) {
  constexpr long long T = (long long)W * NC * 32;
  int nb = 0;
  size_t smem = 0;
  const int rc = plan<W, NC, PR>(sh, n_regs, &nb, &smem);
  if (rc) return rc;
  const long long tiles = (sh.n + T - 1) / T;
  if (tiles >= 0x80000000LL) return static_cast<int>(cudaErrorInvalidValue);
  sh.tiles = static_cast<uint32_t>(tiles);
  sh.queries = queries;
  const long long items = tiles * queries;
  const long long resident = (long long)nb * sm_count();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = items < resident ? items : resident;
  const long long walk = (items + grid - 1) / grid;     // tiles a block
  if (walk < sh.stages)        // no deeper ring than a block's tiles
    smem = static_cast<size_t>(layout(sh, n_regs, T, static_cast<int>(walk)));
  *grid_out = static_cast<int>(grid);
  fused_bitwise_kernel<W, NC, PR>
      <<<static_cast<unsigned>(grid), (NC + 1) * 32, smem, stream>>>(
          params, table, sh);
  return static_cast<int>(cudaGetLastError());
}

// Fill a parameter block of type PR and launch the tile `cfg`.
template <class PR>
static int launch_params(const unsigned long long* ptrs,
                         const void* dev_table, const unsigned* prog,
                         int n_instr, long long n_ptrs, const Shape& sh,
                         int n_regs, int cfg, int queries, void* stream,
                         int* grid_out) {
  PR params;
  for (int k = 0; k < n_instr; ++k) params.prog[k] = prog[k];
  if (dev_table == nullptr)
    for (long long k = 0; k < n_ptrs; ++k) params.p[k] = ptrs[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* t =
      static_cast<const unsigned long long*>(dev_table);
  switch (cfg) {
    case 0:
      return launch_cfg<4, 4>(params, t, sh, n_regs, queries, s, grid_out);
    case 1:
      return launch_cfg<8, 2>(params, t, sh, n_regs, queries, s, grid_out);
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
// prog:  n_instr packed instructions in host memory, load k into register
//        k first (n_loads of them), marks in bits 27-31 (`_kernel_form`);
//        n_regs registers (the loads and the kept results) in shared
//        memory; result_reg is read only when the program is its loads.
// cfg:   the tile: 0 = 4 words a thread on 4 evaluating warps, 1 = 8 words
//        on 2 (512 words either way).
// small_ok lets a launch of at most SMALL_PTRS pointers and SMALL_INSTR
// instructions pass the smaller parameter block; a program of more than
// WARP_LOADS loads always passes WideParams<PARAM_PTRS, MAX_INSTR>.
// Persistent blocks walk the queries' tiles (query-major); *grid_out gets
// the blocks launched. n_bits < 0 leaves the result unmasked; otherwise
// bits past n_bits of every row are cleared. The column of flat index i
// is i - words * ((umulhi(i, div_mul) + i) >> div_shift) while i and
// words are below 2^31, i % words past that. Returns cudaGetLastError()
// after the launch.
int fused_bitwise_launch(const unsigned long long* ptrs,
                         const void* dev_table, const unsigned* prog,
                         int n_in, int n_loads, int n_instr, int result_reg,
                         int n_regs, int cfg, long long n, long long words,
                         long long n_bits, unsigned div_mul, int div_shift,
                         int queries, int small_ok, void* stream,
                         int* grid_out) {
  if (n_in < 1 || n_in > MAX_OPERANDS || n_instr < 1 ||
      n_instr > MAX_INSTR || n_loads < 0 || n_loads > n_instr ||
      n_loads > MAX_OPERANDS || n_regs < n_loads || n_regs > MAX_REGS ||
      (n_loads == n_instr && (result_reg < 0 || result_reg >= n_loads)) ||
      queries < 1 ||
      queries > 65535 || n <= 0 || words <= 0 || words > 0xFFFFFFFFLL ||
      prog == nullptr || grid_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < n_loads; ++k)      // load k fills register k
    if ((prog[k] & 7) != OP_LOAD || ((prog[k] >> 3) & 63) != unsigned(k) ||
        ((prog[k] >> 9) & 63) >= unsigned(n_in))
      return static_cast<int>(cudaErrorInvalidValue);
  int slot_writes = 0;                  // a kept result in a load's slot
  for (int k = n_loads; k < n_instr; ++k)
    slot_writes |= (prog[k] >> 30 & 1) && ((prog[k] >> 3) & 63) < unsigned(n_loads);
  const long long n_ptrs = (long long)queries * (n_in + 1);
  if (dev_table == nullptr && (ptrs == nullptr || n_ptrs > PARAM_PTRS))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh = {};
  sh.n_in = n_in;
  sh.n_loads = n_loads;
  sh.n_comp = n_instr - n_loads;
  sh.result_reg = result_reg;
  sh.n = n;
  sh.words = words;
  sh.masked = n_bits >= 0 && n_bits < words * 32;
  sh.full_words = sh.masked ? n_bits / 32 : 0;
  sh.rem_mask =
      sh.masked && (n_bits % 32) ? ((1u << (n_bits % 32)) - 1u) : 0u;
  sh.div_mul = div_mul;
  sh.div_shift = div_shift;
  sh.slot_writes = slot_writes;
  if (n_loads > WARP_LOADS)
    return launch_params<WideParams<PARAM_PTRS, MAX_INSTR>>(
        ptrs, dev_table, prog, n_instr, n_ptrs, sh, n_regs, cfg, queries,
        stream, grid_out);
  if (small_ok && n_ptrs <= SMALL_PTRS && n_instr <= SMALL_INSTR)
    return launch_params<Params<SMALL_PTRS, SMALL_INSTR>>(
        ptrs, dev_table, prog, n_instr, n_ptrs, sh, n_regs, cfg, queries,
        stream, grid_out);
  return launch_params<Params<PARAM_PTRS, MAX_INSTR>>(
      ptrs, dev_table, prog, n_instr, n_ptrs, sh, n_regs, cfg, queries,
      stream, grid_out);
}

}  // extern "C"
