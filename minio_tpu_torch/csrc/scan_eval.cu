// S3 Select's WHERE clause on Hopper (sm_90a): a predicate-program
// interpreter over page tiles staged in shared memory.
//
// Replaces the TPU device program minio_tpu/scan/kernels.py:244-346
// (_eval_prog, _kernel_for, _pad_batch and run_batch, with _str_cmp,
// _num_cmp, _eval_side, _eval_cmp and _eval_like at :110-241), which traces
// each query's predicate tree into its own XLA program of element-wise ops
// over the pager's pages and pads the page axis to a power of two so that
// its trace cache stays small. Here one kernel runs every query, with one
// launch per call: the host flattens the tree once per plan signature into
// a postfix program with a float64 literal pool and a byte pool
// (ops/scan_program.py), and the kernel interprets it. There is no
// per-query compile and no padding of the page axis. The plain PyTorch
// version is minio_tpu_torch/ops/scan_plain.py (the reference's tree walk).
//
// Inputs, as the pager lays them out, each page at its own byte stride
// (pages of several requests sit one after another in one packed buffer,
// ops/scan_cuda.pack_pages): num f64 [R, C], slen i32 [R, C], ok and null
// u8 [R, C], sb u8 [R, C, W] (each cell's str() bytes, zero-padded;
// W a multiple of 8), rowvalid u8 [R]. Outputs: mask u8 [B, R] (the
// predicate AND rowvalid) and counts i32 [B, ncnt], per page the number of
// passing rows (COUNT(*)) or of passing rows whose cell of a slot is not
// null (COUNT(col)).
//
// What bounds it on this card. The floor is bytes: a row needs a few dozen
// bytes of its page and a few dozen operations. At TPC-H Q6's launch (254
// pages of 2,048 rows, 3 slots of width 16) the program needs 39 B a row,
// ~20.3 MB, ~6.1 us at 3.35 TB/s (scripts/scan_cases.must_move_bytes). The
// row-major layout sets a floor above that: the 32-byte sectors that hold
// those bytes (all of num, since two of its three slots are read, and 32
// of every 48 B of sb, since slot 0's 16 B sit at a 48-B row stride) come
// to ~64 B a row (scan_cases.sector_floor_bytes). This design reaches
// neither: staging alone runs at about two thirds of the card's rate, and
// the interpretation of a tile is not hidden behind the next tile's copy,
// so the two are what a faster version must cut (scripts/scan_ab.py times
// builds with the interpreter or the string compares left out beside
// this one; PERF.md, section 6, has the numbers).
//
// Design:
// - A read set per program. Every thread of a block walks the program's
//   code once before its first tile (a few dozen words) and derives which
//   slots of which page arrays the program can read: ok of every slot a
//   comparison or arithmetic reads; num where a comparison can be numeric
//   (the other side may parse) or the slot feeds arithmetic; null and the
//   slot's string bytes where a comparison can fall to the string order;
//   slen and the string bytes for LIKE (needle no longer than W); null for
//   LIKE, IS NULL, NOT NULL and COUNT(col). It is the set
//   scan_cases.must_move_bytes counts, slot by slot. Of the string bytes,
//   those a comparison reads for every non-null cell (against a literal
//   that does not parse) and LIKE's are staged; those it reads only for a
//   cell that does not parse (a number column against a number: Q6's
//   l_discount and l_quantity) are read from global memory for the rows
//   that need them, so that a numeric column's strings cost nothing when
//   every cell parses.
// - Staged tiles, double-buffered. The grid is persistent (the resident
//   blocks of the card, two a multiprocessor); a block walks work items of
//   (page, tile of T rows). For each item only the staged part of the read
//   set goes into dynamic shared memory: thread 0 copies each array's run
//   of the tile's rows (from the 16-byte granule holding its first byte to
//   the one holding its last: no granule without a byte of the tile is
//   read) with one bulk copy of the Tensor Memory Accelerator, and where
//   only some of sb's slots are staged and its cells are 16-byte aligned,
//   every thread copies its share of those cells with 16-byte cp.async
//   (else sb is one more run). Both complete on the stage's mbarrier:
//   thread 0 arrives expecting the bulk bytes, and each thread arrives once
//   its cp.async copies have landed. Tile i + 1 is in flight while tile i
//   is interpreted (kStages stages; more, with smaller tiles, measured
//   slower, and more beside the widest tile changed nothing). T is the
//   largest of kRows x kThreads, ..., kThreads, kThreads / 2, ..., 1 rows
//   whose stages fit beside the blob and the arithmetic temporaries; the
//   launcher gives the block the dynamic shared memory of two blocks a
//   multiprocessor (one when a single row's worst case needs more).
// - One decode for many rows, nothing in local memory. A thread takes rows j x
//   kThreads + tid, j < T / kThreads, of the tile; each instruction is decoded
//   once and applied to all of them. A thread row past the tile's last (a
//   ragged tile, or T < kThreads) reads the tile's first row's staged cells
//   instead and its result is discarded, so no load leaves the rows staged for
//   the tile. The program has no control flow that depends on data, so the
//   value stack holds only descriptors that are the same for every row (a
//   column slot, a literal, or an arithmetic temporary), kept in registers as
//   a shift register; a comparison loads its sides from the staged tile when
//   it pops them: every row's ok and numbers at once, then nulls and string
//   words only for the rows whose sides do not both parse. A column against a
//   literal, the common form, has its own path, and so do strings of at most
//   two words (without them Q6's launch took 16% longer and SF1's 28%;
//   scripts/scan_ab.py). Work that is rare or long (arithmetic, string orders
//   past two words, LIKE matching) is a loop over the rows that need it rather
//   than unrolled per row, which keeps the code small. Arithmetic results live
//   in shared memory, [temporary][row], and their validity in a register, a
//   bit per (row, temporary); the bool stack is a register per row indexed by
//   a shift. ptxas reports no stack frame and no spills (chip_smoke.py phase
//   1).
// - Strings and LIKE from shared memory: comparisons in 8-byte words (the
//   first differing word's lowest differing byte); contains-LIKE filters
//   the cell's words on the needle's first byte (an exact zero-byte test
//   on the word xor the byte broadcast) and at each candidate compares the
//   8 bytes from it (two words funnel-shifted) with the needle's first 8
//   under a mask, the rest byte by byte.
// - The mask is written coalesced (row j x kThreads + tid). Each warp sums
//   the ballots of its rows per COUNT and writes the sum to its own word
//   in shared memory (no shared atomics: eight warps' atomics on one word
//   made a COUNT(*) over SF1's pages, whose tiles are short, 13% slower;
//   scripts/scan_ab.py); after the tile's barrier one atomic add per count
//   per tile goes to the page's counters. The program blob and those sums live
//   in shared memory when the blob, the sums and the stages of kThreads
//   rows of every array fit the budget. Else the blob is read from global
//   memory and each warp adds its sums to the page's counters. No program
//   is too large to run.
// - The value stack's depth and the bool stack's are ops/scan_program.py's
//   MAX_VALS and MAX_BOOLS, passed in as SCAN_MAX_VALS and SCAN_MAX_BOOLS
//   by the build (ops/kernels.py). The host refuses a deeper program before
//   the launch (Decline "program-depth"), and the launcher refuses one
//   whose stated depths exceed the stacks.
// - Semantics are the reference's tree walk, bit for bit: numeric compare
//   when both sides parse, else False when either side is null, else the
//   unsigned byte at the first difference of the zero-padded strings (a
//   literal longer than W compares against the cell's zero bytes past W);
//   an arithmetic side compares numerically only; `/` and `%` by 0 or -0
//   make the side invalid; `%` is jnp.mod (fmod, plus the divisor when the
//   remainder is nonzero and its sign differs from the divisor's); NOT is a
//   plain negation (NOT over a null cell is True); LIKE needs slen == L
//   (exact) or slen >= L (prefix, suffix), tries every offset with slen >=
//   off + L (contains), is True for any non-null cell (any), and is False
//   for a needle longer than W before any negation.
// - Arithmetic rounds once per operation, as the evaluator's Python floats
//   do: the source is built with -fmad=false, and the operations are the
//   _rn intrinsics, so `(a * 2) + 1` never contracts into one FMA.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#if !defined(SCAN_MAX_VALS) || !defined(SCAN_MAX_BOOLS)
#error "build with -DSCAN_MAX_VALS and -DSCAN_MAX_BOOLS (ops/kernels.py)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a thread interprets per tile, at most
constexpr int kRows = 4;
// tiles a block has staged or in flight: kStages - 1 ahead of the one it
// interprets
constexpr int kStages = 2;
static_assert(kStages >= 2, "a stage in flight while one is read");
// the stages' mbarriers, at the start of dynamic shared memory
constexpr int kBarBytes = (8 * kStages + 15) / 16 * 16;
constexpr int kMaxVals = SCAN_MAX_VALS;
constexpr int kMaxBools = SCAN_MAX_BOOLS;
static_assert(kMaxVals >= 1 && kMaxBools >= 1 && kMaxBools <= 32,
              "the bool stack is one 32-bit word a row");
// dynamic shared memory of a block: two blocks a multiprocessor, or one
constexpr int kBudgetTwo = 112 * 1024;
constexpr int kBudgetOne = 227 * 1024;
// slots a read-set mask tells apart: bit 31 stands for slot 31 and every
// slot past it
constexpr int kMaskSlots = 32;

enum Op : int {
  kTrue = 1, kFalse = 2, kAnd = 3, kOr = 4, kNot = 5, kCol = 6, kLit = 7,
  kArith = 8, kCmp = 9, kNotNull = 10, kIsNull = 11, kLike = 12,
};

// a value-stack descriptor: kind in the low two bits, its slot, literal
// index or temporary above them
enum Kind : int { kTemp = 0, kSlot = 1, kLitK = 2 };

// the page arrays in stage order, and their bits in a stage's `on` mask
enum Arr : int { kNum = 0, kSlen = 1, kOk = 2, kNull = 3, kRv = 4, kSb = 5 };

// where a program's parts sit in its blob (byte offsets), and their counts
struct Parts {
  int code, ncode;      // int32 instructions
  int cspec, ncnt;      // int32 COUNT specs
  int lnum;             // f64 literal numbers
  int lmeta;            // int32 (ok, byte offset, length) per literal
  int lbytes;           // literal bytes, each padded to 8
};

// the page arrays: first page's address and page stride, in Arr order
struct Pages {
  const uint8_t* base[6];
  long long ps[6];
};

// the slots of each page array a program can read (see the header); of
// sb, the slots it reads for every non-null cell, which are staged (the
// slots it reads only for cells that do not parse are read from global
// memory, when such cells occur)
struct ReadSet {
  uint32_t ok, num, null, slen, sb_stage;
  int max_temps;
};

__host__ __device__ __forceinline__ long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// bytes of a stage region for a run of n bytes at any address: its 16-byte
// granules, from the one holding its first byte to the one holding its last
__host__ __device__ __forceinline__ long long run_bytes(long long n) {
  return align16(n) + 16;
}

// bytes of one stage for tiles of T rows: the arrays of `on` (Arr bits),
// sb as a run of its C slots, or as nS cells a row when nS > 0
__host__ __device__ __forceinline__ long long stage_bytes(long long T, int C,
                                                          int W, unsigned on,
                                                          int nS) {
  long long n = 0;
  if (on & (1u << kNum)) n += run_bytes(T * C * 8);
  if (on & (1u << kSlen)) n += run_bytes(T * C * 4);
  if (on & (1u << kOk)) n += run_bytes(T * C);
  if (on & (1u << kNull)) n += run_bytes(T * C);
  if (on & (1u << kRv)) n += run_bytes(T);
  if (on & (1u << kSb))
    n += nS > 0 ? align16(T * nS * W) : run_bytes(T * C * W);
  return n;
}

// shared memory a block needs beside its stages: the arithmetic
// temporaries, [temporary][j][thread] f64, for rpt rows a thread
__host__ __device__ __forceinline__ long long temps_bytes(int temps,
                                                          long long rpt) {
  return align16(8LL * temps * rpt * kThreads);
}

__device__ __forceinline__ uint32_t slot_bit(int s) {
  return 1u << (s < kMaskSlots - 1 ? s : kMaskSlots - 1);
}

// the bool word w with bit i set to v
__device__ __forceinline__ uint32_t set_bit(uint32_t w, int i, bool v) {
  return (w & ~(1u << i)) | (static_cast<uint32_t>(v) << i);
}

// a comparison side's string: its 8-byte words and their count
struct Words {
  const uint64_t* w;
  int n;
};

// the value stack: descriptors, the same for every row, as a shift
// register (constant indices only, so it stays in registers)
struct DStack {
  int d[kMaxVals];
  __device__ __forceinline__ void push(int v) {
#pragma unroll
    for (int i = kMaxVals - 1; i > 0; --i) d[i] = d[i - 1];
    d[0] = v;
  }
  __device__ __forceinline__ int pop() {
    const int v = d[0];
#pragma unroll
    for (int i = 0; i < kMaxVals - 1; ++i) d[i] = d[i + 1];
    d[kMaxVals - 1] = 0;
    return v;
  }
};

// A comparison's outcome by the order class of its sides (bit 0: the
// first is greater, 1: equal, 2: less, 3: unordered, a nan), four bits per
// operator (=, !=, <, <=, >, >=) from bit 0: != is true for a nan, the
// others false, as C's operators on doubles
constexpr uint32_t kCmpMasks = 0x3164D2u;

__device__ __forceinline__ int num_class(double a, double b) {
  return a > b ? 0 : a == b ? 1 : a < b ? 2 : 3;
}

// -1 or 1: the order of two different 8-byte words of strings at their
// lowest differing byte (little endian: the first in the string)
__device__ __forceinline__ int word_order(uint64_t x, uint64_t y) {
  const int sh = (__ffsll(static_cast<long long>(x ^ y)) - 1) & ~7;
  return ((x >> sh) & 0xff) < ((y >> sh) & 0xff) ? -1 : 1;
}

// -1, 0 or 1: the strings a (na words) and b (nb words), each read as
// zeros past its words, compared at their first differing byte (little
// endian: the lowest differing byte of the first differing word)
__device__ __forceinline__ int str_order(const uint64_t* a, int na,
                                         const uint64_t* b, int nb) {
  const int n = na > nb ? na : nb;
  for (int i = 0; i < n; ++i) {
    const uint64_t x = i < na ? a[i] : 0ull;
    const uint64_t y = i < nb ? b[i] : 0ull;
    if (x != y) return word_order(x, y);
  }
  return 0;
}

__device__ __forceinline__ bool bytes_eq(const uint8_t* cell,
                                         const uint8_t* needle, int n) {
  for (int k = 0; k < n; ++k)
    if (cell[k] != needle[k]) return false;
  return true;
}

// 0x80 in each byte of x that is zero, 0 in every other byte (no carry
// crosses a byte, so the test is exact)
__device__ __forceinline__ uint64_t zero_bytes(uint64_t x) {
  const uint64_t lo7 = 0x7f7f7f7f7f7f7f7full;
  return ~(((x & lo7) + lo7) | x | lo7);
}

// contains-LIKE: the needle (L bytes, 1 <= L <= W) at some offset off <=
// min(s, W) - L of the cell (W bytes, 8-byte aligned): the cell's words
// filtered on the needle's first byte, and at each candidate the 8 bytes
// from it (two words funnel-shifted) compared with the needle's first 8
// under a mask, its bytes past 8 one by one
__device__ __forceinline__ bool contains(const uint8_t* cell, int s, int W,
                                         const uint8_t* needle, int L) {
  const int last = (s < W ? s : W) - L;
  const uint64_t pat = 0x0101010101010101ull * needle[0];
  const int n8 = L < 8 ? L : 8;
  uint64_t head = 0;
  for (int k = 0; k < n8; ++k)
    head |= static_cast<uint64_t>(needle[k]) << (8 * k);
  const uint64_t hmask = n8 == 8 ? ~0ull : (1ull << (8 * n8)) - 1;
  const uint64_t* words = reinterpret_cast<const uint64_t*>(cell);
  for (int k = 0; 8 * k <= last; ++k) {
    const uint64_t w = words[k];
    uint64_t m = zero_bytes(w ^ pat);
    if (m == 0) continue;
    const uint64_t next = 8 * k + 8 < W ? words[k + 1] : 0ull;
    while (m != 0) {
      const int b = (__ffsll(static_cast<long long>(m)) - 1) >> 3;
      const int off = 8 * k + b;
      if (off > last) return false;
      const uint64_t at = b == 0 ? w : (w >> (8 * b)) | (next << (64 - 8 * b));
      if (((at ^ head) & hmask) == 0 &&
          bytes_eq(cell + off + 8, needle + 8, L - n8))
        return true;
      m &= m - 1;
    }
  }
  return false;
}

__device__ __forceinline__ double floor_mod(double a, double b) {
  const double r = fmod(a, b);
  return (r != 0.0 && ((r < 0.0) != (b < 0.0))) ? __dadd_rn(r, b) : r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier of `count` arrivals: a stage's copies land on it
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the arrival of a stage's phase, which then waits for `bytes` to land
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// a bulk copy by the Tensor Memory Accelerator (addresses and size
// multiples of 16) whose bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a 16-byte copy by the thread (cp.async)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// the thread's arrival on `bar` once its cp.async copies so far have
// landed (counted in the barrier's arrivals)
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// wait for the phase of `bar` whose parity is `parity`; a copy that never
// lands (not a state any launch reaches) traps after ~10 s instead of
// hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// the program's read set and the temporaries it keeps at once: the
// interpreter's walk over descriptors alone
__device__ __forceinline__ ReadSet read_set(const int* code, int ncode,
                                            const int* cspec, int ncnt,
                                            const int* lmeta, int W) {
  ReadSet rs{0u, 0u, 0u, 0u, 0u, 0};
  DStack st;
#pragma unroll
  for (int i = 0; i < kMaxVals; ++i) st.d[i] = 0;
  int temps = 0;
  // a side can parse as a number: a slot or a temporary may; a literal
  // as the flattener found
  auto can_parse = [&](int v) {
    return (v & 3) != kLitK || lmeta[3 * (v >> 2)] != 0;
  };
  for (int pc = 0; pc < ncode;) {
    const int op = code[pc++];
    if (op == kCol) {
      st.push(kSlot | code[pc++] << 2);
    } else if (op == kLit) {
      st.push(kLitK | code[pc++] << 2);
    } else if (op == kArith || op == kCmp) {
      ++pc;
      const int y = st.pop(), x = st.pop();
      const bool arith = op == kArith || (x & 3) == kTemp ||
                         (y & 3) == kTemp;
      temps -= ((x & 3) == kTemp) + ((y & 3) == kTemp);
      const int sides[2] = {x, y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = sides[i];
        if ((v & 3) != kSlot) continue;
        const uint32_t bit = slot_bit(v >> 2);
        rs.ok |= bit;
        if (op == kArith || can_parse(sides[1 - i])) rs.num |= bit;
        if (!arith) {
          rs.null |= bit;
          if (!can_parse(sides[1 - i])) rs.sb_stage |= bit;
        }
      }
      if (op == kArith) {
        st.push(kTemp | temps << 2);
        ++temps;
        rs.max_temps = temps > rs.max_temps ? temps : rs.max_temps;
      }
    } else if (op == kNotNull) {
      const int x = st.pop();
      if ((x & 3) == kSlot) rs.null |= slot_bit(x >> 2);
      temps -= (x & 3) == kTemp;
    } else if (op == kIsNull) {
      rs.null |= slot_bit(code[pc++]);
    } else if (op == kLike) {
      const uint32_t bit = slot_bit(code[pc]);
      const int kind = code[pc + 1];
      const int L = lmeta[3 * code[pc + 2] + 2];
      pc += 3;
      rs.null |= bit;
      if (kind != 4 && L <= W) {
        rs.slen |= bit;
        if (L > 0) rs.sb_stage |= bit;
      }
    }
  }
  for (int k = 0; k < ncnt; ++k)
    if (cspec[k] >= 0) rs.null |= slot_bit(cspec[k]);
  return rs;
}

// kShared: the blob is copied into shared memory and the COUNT sums meet
// there; else the blob is read where it lies and each warp adds its sums
// to the page's counters itself.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
scan_eval_kernel(const uint8_t* __restrict__ prog, int prog_bytes,
                 const Parts pp, const Pages pg, int B, int R, int C, int W,
                 uint8_t* __restrict__ mask, int* __restrict__ counts,
                 int smem_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const uint8_t* base = prog;
  // each warp's COUNT sums of a tile, [warp][count]
  int* s_part = nullptr;
  if constexpr (kShared) {
    for (int i = tid; i < prog_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem + kBarBytes)[i] =
          reinterpret_cast<const uint4*>(prog)[i];
    s_part = reinterpret_cast<int*>(smem + kBarBytes + prog_bytes);
    base = smem + kBarBytes;
  }
  __syncthreads();
  const int ncode = pp.ncode;
  const int ncnt = pp.ncnt;
  const int* code = reinterpret_cast<const int*>(base + pp.code);
  const int* cspec = reinterpret_cast<const int*>(base + pp.cspec);
  const double* lnum = reinterpret_cast<const double*>(base + pp.lnum);
  const int* lmeta = reinterpret_cast<const int*>(base + pp.lmeta);
  const uint8_t* lbytes = base + pp.lbytes;

  // -- the read set, the staged arrays and the tile -----------------------
  const ReadSet rs = read_set(code, ncode, cspec, ncnt, lmeta, W);
  const unsigned on = (rs.num ? 1u << kNum : 0u) |
                      (rs.slen ? 1u << kSlen : 0u) |
                      (rs.ok ? 1u << kOk : 0u) |
                      (rs.null ? 1u << kNull : 0u) | (1u << kRv) |
                      (rs.sb_stage ? 1u << kSb : 0u);
  // sb cell by cell when only some of its slots are staged and its cells
  // are 16-byte aligned; else as one run
  const bool cells = rs.sb_stage != 0 && C < kMaskSlots &&
                     rs.sb_stage != (1u << C) - 1u && W % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(pg.base[kSb]) % 16 == 0 &&
                     pg.ps[kSb] % 16 == 0;
  const int nS = cells ? __popc(rs.sb_stage) : 0;
  if (tid == 0) {
    // a stage's phase: thread 0's arrival with the runs' bytes, and each
    // thread's once its cell copies have landed
    for (int i = 0; i < kStages; ++i)
      bar_init(bars + i, cells ? 1 + kThreads : 1);
    // the barriers' initialisation visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long prog_region =
      kBarBytes + (kShared ? prog_bytes + align16(4LL * kWarps * ncnt) : 0);
  int T = 0, rpt = 1;
  for (int t = kRows * kThreads; t >= 1;
       t = t > kThreads ? t - kThreads : t >> 1) {
    const int r = t > kThreads ? t / kThreads : 1;
    if (prog_region + temps_bytes(rs.max_temps, r) +
            kStages * stage_bytes(t, C, W, on, nS) <=
        smem_bytes) {
      T = t;
      rpt = r;
      break;
    }
  }
  if (T == 0) return;        // the launcher's worst case always fits
  double* tnum = reinterpret_cast<double*>(smem + prog_region);
  const int stage0 =
      static_cast<int>(prog_region + temps_bytes(rs.max_temps, rpt));
  const int sbytes = static_cast<int>(stage_bytes(T, C, W, on, nS));
  // region offsets within a stage, in Arr order
  const int o_num = 0;
  const int o_slen =
      o_num + ((on >> kNum) & 1 ? static_cast<int>(run_bytes(T * C * 8))
                                : 0);
  const int o_ok =
      o_slen + ((on >> kSlen) & 1 ? static_cast<int>(run_bytes(T * C * 4))
                                  : 0);
  const int o_null =
      o_ok + ((on >> kOk) & 1 ? static_cast<int>(run_bytes(T * C)) : 0);
  const int o_rv =
      o_null + ((on >> kNull) & 1 ? static_cast<int>(run_bytes(T * C)) : 0);
  const int o_sb = o_rv + static_cast<int>(run_bytes(T));
  const int tpp = (R + T - 1) / T;                  // tiles a page
  const long long items = static_cast<long long>(B) * tpp;

  // the first byte of the run of array a for rows r0.. of page b
  auto run_at = [&](int a, long long b, int r0, int row_bytes) {
    return reinterpret_cast<uintptr_t>(pg.base[a] + b * pg.ps[a]) +
           static_cast<uintptr_t>(r0) * row_bytes;
  };
  // issue the copies of work item `item` into stage p: thread 0 copies
  // each array's run and arms the stage's barrier with every byte the
  // stage takes; every thread copies its share of the cells
  auto stage = [&](long long item, int p) {
    const long long b = item / tpp;
    const int r0 = static_cast<int>(item - b * tpp) * T;
    const int n = R - r0 < T ? R - r0 : T;
    uint8_t* dst = smem + stage0 + p * sbytes;
    uint64_t* bar = bars + p;
    if (tid == 0) {
      uint32_t total = 0;
      // the granules from the one holding the run's first byte to the
      // one holding its last
      auto span = [&](int a, int row_bytes, uintptr_t& a0) {
        const uintptr_t g0 = run_at(a, b, r0, row_bytes);
        const uintptr_t g1 = g0 + static_cast<uintptr_t>(n) * row_bytes;
        a0 = g0 & ~uintptr_t{15};
        return static_cast<uint32_t>(((g1 + 15) & ~uintptr_t{15}) - a0);
      };
      uintptr_t a0[6];
      uint32_t bytes[6];
      const int row_bytes[6] = {8 * C, 4 * C, C, C, 1, C * W};
      const int off[6] = {o_num, o_slen, o_ok, o_null, o_rv, o_sb};
      const bool whole[6] = {(on >> kNum & 1) != 0, (on >> kSlen & 1) != 0,
                             (on >> kOk & 1) != 0, (on >> kNull & 1) != 0,
                             true, (on >> kSb & 1) != 0 && !cells};
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        bytes[a] = whole[a] ? span(a, row_bytes[a], a0[a]) : 0u;
        total += bytes[a];
      }
      bar_expect(bar, total);
#pragma unroll
      for (int a = 0; a < 6; ++a)
        if (whole[a])
          bulk_load(dst + off[a], reinterpret_cast<const void*>(a0[a]),
                    bytes[a], bar);
    }
    if (cells) {
      const uint8_t* page = pg.base[kSb] + b * pg.ps[kSb];
      for (int q = tid; q < n * nS; q += kThreads) {
        const int row = q / nS;
        const int si = q - row * nS;
        uint32_t m = rs.sb_stage;
        for (int k = 0; k < si; ++k) m &= m - 1;   // the si-th staged slot
        const int slot = __ffs(m) - 1;
        const uint8_t* src =
            page + (static_cast<long long>(r0 + row) * C + slot) * W;
        uint8_t* d = dst + o_sb + (row * nS + si) * W;
        for (int k = 0; k < W; k += 16) copy16(d + k, src + k);
      }
      bar_arrive_copies(bar);
    }
  };

  long long item = blockIdx.x;
  if (item >= items) return;
  for (int k = 0, issued = 0; item < items; ++k, item += gridDim.x) {
    const int p = k % kStages;
    // stage the items up to kStages - 1 past this one (kStages on the first
    // pass), each into the stage the last pass has read
    for (; issued < k + kStages; ++issued) {
      const long long it =
          blockIdx.x + static_cast<long long>(issued) * gridDim.x;
      if (it < items) stage(it, issued % kStages);
    }
    bar_wait(bars + p, (k / kStages) & 1);
    // (and the last tile's sums are flushed before this one's meet)
    __syncthreads();

    // -- the tile's rows --------------------------------------------------
    const long long b = item / tpp;
    const int r0 = static_cast<int>(item - b * tpp) * T;
    const int n = R - r0 < T ? R - r0 : T;
    const uint8_t* sp = smem + stage0 + p * sbytes;
    auto at = [&](int a, int off, int row_bytes) {
      return sp + off + (run_at(a, b, r0, row_bytes) & 15);
    };
    const double* s_num =
        reinterpret_cast<const double*>(at(kNum, o_num, 8 * C));
    const int* s_slen =
        reinterpret_cast<const int*>(at(kSlen, o_slen, 4 * C));
    const uint8_t* s_ok = at(kOk, o_ok, C);
    const uint8_t* s_null = at(kNull, o_null, C);
    const uint8_t* s_rv = at(kRv, o_rv, 1);
    const uint8_t* s_sb = cells ? sp + o_sb : at(kSb, o_sb, C * W);
    const uint8_t* g_sb = pg.base[kSb] + b * pg.ps[kSb];
    const bool sb_run = ((on >> kSb) & 1) && !cells;
    // whether slot s's cells are staged
    auto staged = [&](int s) {
      return sb_run || (cells && ((rs.sb_stage >> s) & 1u));
    };
    // the staged cell of slot s (a staged slot) of tile row rt
    auto staged_cell = [&](int rt, int s) -> const uint8_t* {
      if (sb_run) return s_sb + (rt * C + s) * W;
      return s_sb + (rt * nS + __popc(rs.sb_stage & ((1u << s) - 1u))) * W;
    };
    // the cell of slot s of tile row rt: staged, or where it lies
    auto cell = [&](int rt, int s) -> const uint8_t* {
      if (staged(s)) return staged_cell(rt, s);
      return g_sb + (static_cast<long long>(r0 + rt) * C + s) * W;
    };

    // the tile row whose staged cells row j of the thread reads: its own,
    // or the tile's first where it has none (its result is discarded), so
    // that no thread reads past the rows staged for this tile
    auto row = [&](int j) {
      const int rt = j * kThreads + tid;
      return rt < n ? rt : 0;
    };
    uint32_t live = 0;                 // bit j: row j of the thread is real
    uint32_t bits[kRows];              // the bool stack of each row
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int rt = j * kThreads + tid;
      if (j < rpt && rt < n && s_rv[rt] != 0) live |= 1u << j;
      bits[j] = 0;
    }
    // the temporaries' validity: bit j kMaxVals + t for row j, temporary t
    uint32_t tv = 0;
    static_assert(kRows * kMaxVals <= 32, "one word of validity bits");
    DStack st;
#pragma unroll
    for (int i = 0; i < kMaxVals; ++i) st.d[i] = 0;
    int nb = 0, temps = 0;
    const bool num_on = (on >> kNum) & 1;

    // a side's values for row j, from a descriptor v: its ok, its number
    // (0 where num is not staged: then no comparison with it is numeric)
    // and its null; a literal's are the same for every row
    auto side_ok = [&](int v, int j) -> bool {
      const int ref = v >> 2;
      if ((v & 3) == kSlot) return s_ok[row(j) * C + ref] != 0;
      if ((v & 3) == kLitK) return lmeta[3 * ref] != 0;
      return (tv >> (j * kMaxVals + ref)) & 1u;
    };
    auto side_num = [&](int v, int j) -> double {
      const int ref = v >> 2;
      if ((v & 3) == kSlot)
        return num_on ? s_num[row(j) * C + ref] : 0.0;
      if ((v & 3) == kLitK) return lnum[ref];
      return tnum[(ref * rpt + j) * kThreads + tid];
    };
    auto side_null = [&](int v, int j) -> bool {
      const int ref = v >> 2;
      if ((v & 3) == kSlot) return s_null[row(j) * C + ref] != 0;
      if ((v & 3) == kLitK) return false;
      return !((tv >> (j * kMaxVals + ref)) & 1u);
    };
    auto side_words = [&](int v, int j) -> Words {
      const int ref = v >> 2;
      if ((v & 3) == kSlot)
        return {reinterpret_cast<const uint64_t*>(cell(j * kThreads + tid,
                                                       ref)),
                W >> 3};
      return {reinterpret_cast<const uint64_t*>(lbytes + lmeta[3 * ref + 1]),
              (lmeta[3 * ref + 2] + 7) >> 3};
    };
    // push one bool a row, bit j of res for row j
    auto push = [&](uint32_t res) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        bits[j] = set_bit(bits[j], nb, (res >> j) & 1u);
      ++nb;
    };

    // Each instruction is decoded once for the thread's rows. The common
    // work (loads, numeric compares, bool ops) is unrolled over the rows;
    // the rare or long work (arithmetic, string orders, LIKE matching) is
    // one loop over the rows that need it, which keeps the code small
    // (unrolled, it measured slower).
    for (int pc = 0; pc < ncode;) {
      const int op = code[pc++];
      if (op == kCol || op == kLit) {      // a push of a descriptor alone
        st.push((op == kCol ? kSlot : kLitK) | code[pc++] << 2);
        continue;
      }
      switch (op) {
        case kTrue: push(~0u); break;
        case kFalse: push(0u); break;
        case kAnd:
        case kOr: {
          const int top = nb - 1;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const uint32_t y = (bits[j] >> top) & 1u;
            const uint32_t x = (bits[j] >> (top - 1)) & 1u;
            bits[j] = set_bit(bits[j], top - 1,
                              op == kAnd ? (x & y) != 0 : (x | y) != 0);
          }
          nb = top;
          break;
        }
        case kNot: {
#pragma unroll
          for (int j = 0; j < kRows; ++j) bits[j] ^= 1u << (nb - 1);
          break;
        }
        case kArith: {
          const int aop = code[pc++];
          const int y = st.pop(), x = st.pop();
          temps -= ((x & 3) == kTemp) + ((y & 3) == kTemp);
          const int dst = temps++;
#pragma unroll 1
          for (int j = 0; j < rpt; ++j) {
            bool valid = side_ok(x, j) && side_ok(y, j);
            const double a = side_num(x, j);
            const double c = side_num(y, j);
            double v;
            if (aop == 0) {
              v = __dadd_rn(a, c);
            } else if (aop == 1) {
              v = __dsub_rn(a, c);
            } else if (aop == 2) {
              v = __dmul_rn(a, c);
            } else {
              valid = valid && c != 0.0;
              const double d = c == 0.0 ? 1.0 : c;
              v = aop == 3 ? __ddiv_rn(a, d) : floor_mod(a, d);
            }
            tnum[(dst * rpt + j) * kThreads + tid] = v;
            tv = set_bit(tv, j * kMaxVals + dst, valid);
          }
          st.push(kTemp | dst << 2);
          break;
        }
        case kCmp: {
          // the comparison's outcome for each order class of its sides
          uint32_t cm = (kCmpMasks >> (4 * code[pc++])) & 15u;
          int y = st.pop(), x = st.pop();
          uint32_t res = 0, strs = 0;
          if (((x & 3) == kLitK && (y & 3) == kSlot) ||
              ((x & 3) == kSlot && (y & 3) == kLitK)) {
            // a column against a literal, the common form: the literal
            // second (swapping the sides mirrors greater and less)
            if ((x & 3) == kLitK) {
              const int t = x;
              x = y;
              y = t;
              cm = (cm & 0xAu) | ((cm & 1u) << 2) | ((cm >> 2) & 1u);
            }
            const int slot = x >> 2, li = y >> 2;
            const bool lok = lmeta[3 * li] != 0;
            const double ln = lnum[li];
            uint32_t nul = 0;
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              if (j >= rpt) break;
              const int at = row(j) * C + slot;
              // num is staged where the literal parses, null always
              const bool both = lok && s_ok[at] != 0;
              const double a = lok ? s_num[at] : 0.0;
              res |= static_cast<uint32_t>(
                         both && ((cm >> num_class(a, ln)) & 1u)) << j;
              strs |= static_cast<uint32_t>(!both) << j;
              nul |= static_cast<uint32_t>(s_null[at] != 0) << j;
            }
            strs &= live & ~nul;
            const uint64_t* lw = reinterpret_cast<const uint64_t*>(
                lbytes + lmeta[3 * li + 1]);
            const int lnw = (lmeta[3 * li + 2] + 7) >> 3;
            if (W <= 16 && lnw <= 2 && staged(slot)) {
              // both strings within two words (a date, a flag) and the
              // cells staged: every row's words at once
              const uint64_t l0 = lnw > 0 ? lw[0] : 0ull;
              const uint64_t l1 = lnw > 1 ? lw[1] : 0ull;
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                if (!((strs >> j) & 1u)) continue;
                const uint64_t* cw = reinterpret_cast<const uint64_t*>(
                    staged_cell(j * kThreads + tid, slot));
                const uint64_t x0 = cw[0], x1 = W > 8 ? cw[1] : 0ull;
                const int c = x0 != l0 ? word_order(x0, l0)
                              : x1 != l1 ? word_order(x1, l1) : 0;
                res |= ((cm >> (1 - c)) & 1u) << j;
              }
              strs = 0;
            }
#pragma unroll 1
            for (; strs != 0; strs &= strs - 1) {
              const int j = __ffs(strs) - 1;
              const int rt = j * kThreads + tid;
              const uint64_t* cw =
                  reinterpret_cast<const uint64_t*>(cell(rt, slot));
              res |= ((cm >> (1 - str_order(cw, W >> 3, lw, lnw))) & 1u)
                     << j;
            }
            push(res);
            break;
          }
          const bool arith = (x & 3) == kTemp || (y & 3) == kTemp;
          // every row's numbers (independent loads); the live rows whose
          // sides do not both parse and are not null fall to strings
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (j >= rpt) break;
            const bool both = side_ok(x, j) && side_ok(y, j);
            const double a = side_num(x, j), c = side_num(y, j);
            res |= static_cast<uint32_t>(
                       both && ((cm >> num_class(a, c)) & 1u)) << j;
            strs |= static_cast<uint32_t>(!both) << j;
          }
          temps -= ((x & 3) == kTemp) + ((y & 3) == kTemp);
          strs &= arith ? 0u : live;
#pragma unroll 1
          for (; strs != 0; strs &= strs - 1) {
            const int j = __ffs(strs) - 1;
            if (side_null(x, j) || side_null(y, j)) continue;
            const Words a = side_words(x, j), c = side_words(y, j);
            res |= ((cm >> (1 - str_order(a.w, a.n, c.w, c.n))) & 1u) << j;
          }
          push(res);
          break;
        }
        case kNotNull: {
          const int x = st.pop();
          uint32_t res = 0;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (j < rpt) res |= static_cast<uint32_t>(!side_null(x, j)) << j;
          temps -= (x & 3) == kTemp;
          push(res);
          break;
        }
        case kIsNull: {
          const int slot = code[pc++];
          uint32_t res = 0;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (j < rpt)
              res |= static_cast<uint32_t>(s_null[row(j) * C + slot] != 0)
                     << j;
          push(res);
          break;
        }
        case kLike: {
          const int slot = code[pc];
          const int kind = code[pc + 1];
          const int li = code[pc + 2];
          pc += 3;
          const int L = lmeta[3 * li + 2];
          const uint8_t* needle = lbytes + lmeta[3 * li + 1];
          uint32_t nonnull = 0;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (j < rpt)
              nonnull |= static_cast<uint32_t>(s_null[row(j) * C + slot] == 0)
                         << j;
          // any: every non-null cell; a needle longer than W: none
          uint32_t res = kind == 4 ? nonnull : 0u;
          uint32_t match = kind != 4 && L <= W ? nonnull & live : 0u;
#pragma unroll 1
          for (; match != 0; match &= match - 1) {
            const int j = __ffs(match) - 1;
            const int rt = j * kThreads + tid;
            const int s = s_slen[rt * C + slot];
            const uint8_t* c = staged_cell(rt, slot);
            bool hit;
            if (kind == 0) {                           // exact
              hit = s == L && bytes_eq(c, needle, L);
            } else if (kind == 1) {                    // prefix
              hit = s >= L && bytes_eq(c, needle, L);
            } else if (kind == 2) {                    // suffix
              hit = s >= L && bytes_eq(c + (s - L), needle, L);
            } else {                                   // contains
              hit = s >= L && (L == 0 || contains(c, s, W, needle, L));
            }
            res |= static_cast<uint32_t>(hit) << j;
          }
          push(res);
          break;
        }
        default: break;
      }
    }

    // -- the mask and the COUNT sums --------------------------------------
    const long long row0 = b * R + r0;
    uint32_t pass = 0;                 // bit j: row j passes
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j >= rpt) continue;
      const int rt = j * kThreads + tid;
      pass |= ((live >> j) & bits[j] & 1u) << j;
      if (rt < n) mask[row0 + rt] = (pass >> j) & 1u;
    }
    // each warp sums its rows' ballots and puts the sum in shared memory
    // (no atomics there); else adds it to the page's counter itself
    for (int c = 0; c < ncnt; ++c) {
      const int slot = cspec[c];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j >= rpt) break;
        const bool v = ((pass >> j) & 1u) &&
                       (slot < 0 || s_null[row(j) * C + slot] == 0);
        sum += __popc(__ballot_sync(0xffffffffu, v));
      }
      if ((tid & 31) == 0) {
        if constexpr (kShared)
          s_part[(tid >> 5) * ncnt + c] = sum;
        else if (sum != 0)
          atomicAdd(&counts[b * ncnt + c], sum);
      }
    }
    __syncthreads();        // stage p is read, and the tile's sums are in
    if constexpr (kShared) {
      for (int c = tid; c < ncnt; c += kThreads) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_part[w * ncnt + c];
        if (sum != 0) atomicAdd(&counts[b * ncnt + c], sum);
      }
    }
  }
}

constexpr int kMaxDevices = 64;
// resident blocks of the card per (device, kShared, budget), 0 unknown
std::atomic<int> g_resident[kMaxDevices][2][2];

}  // namespace

extern "C" {

// Evaluate the program blob `prog` (device memory, prog_bytes a multiple
// of 16, 16-byte aligned) over B pages of R rows, C slots and string width
// W. The blob's parts are at the given byte offsets: ncode int32
// instructions at code, ncnt int32 COUNT specs at cspec, the literals'
// f64 numbers at lnum, their int32 (ok, byte offset, length) triples at
// lmeta and their bytes at lbytes; max_vals and max_bools are the depths
// the program needs of the value and bool stacks. Each input's page p
// starts at its pointer plus p times its byte stride (*_ps); within a page
// its elements are contiguous. Writes mask (B, R) u8 and, when ncnt > 0,
// zeroes then fills counts (B, ncnt) i32, on the given stream. Returns the
// CUDA error of the launch (cudaGetLastError()), or cudaErrorInvalidValue
// for arguments the kernel does not take.
int scan_eval_launch(const void* prog, int prog_bytes, int code, int ncode,
                     int cspec, int ncnt, int lnum, int lmeta, int lbytes,
                     int max_vals, int max_bools, const void* num,
                     long long num_ps, const void* slen, long long slen_ps,
                     const void* ok, long long ok_ps, const void* null,
                     long long null_ps, const void* sb, long long sb_ps,
                     const void* rowvalid, long long rv_ps, int B, int R,
                     int C, int W, void* mask, void* counts, void* stream) {
  const auto misaligned = [](const void* p, long long stride, int a) {
    return (reinterpret_cast<uintptr_t>(p) % a) != 0 || stride % a != 0;
  };
  const auto part_bad = [prog_bytes](int at, long long n, int a) {
    return at < 0 || at % a != 0 || n < 0 || at + n > prog_bytes;
  };
  if (B < 1 || R < 1 || C < 1 || W < 8 || W % 8 != 0 ||
      prog_bytes < 16 || prog_bytes % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(prog) & 15) != 0 ||
      ncode < 1 || part_bad(code, 4LL * ncode, 4) ||
      part_bad(cspec, 4LL * ncnt, 4) || part_bad(lnum, 0, 8) ||
      part_bad(lmeta, 0, 4) || part_bad(lbytes, 0, 8) || max_vals < 0 ||
      max_vals > kMaxVals || max_bools < 1 || max_bools > kMaxBools ||
      misaligned(num, num_ps, 8) || misaligned(sb, sb_ps, 8) ||
      misaligned(slen, slen_ps, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  // the worst case of a program: every array staged, sb whole, max_vals
  // temporaries; the blob and the sums in shared memory when the stages of
  // kThreads rows fit beside them
  const auto need = [&](long long T, bool prog_in) {
    return kBarBytes +
           (prog_in ? prog_bytes + align16(4LL * kWarps * ncnt) : 0) +
           temps_bytes(max_vals, 1) +
           kStages * stage_bytes(T, C, W, 0x3fu, 0);
  };
  const bool shared = need(kThreads, true) <= kBudgetTwo;
  const int budget = need(1, shared) <= kBudgetTwo ? 0 : 1;
  if (need(1, shared) > kBudgetOne)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = budget == 0 ? kBudgetTwo : kBudgetOne;
  const auto kernel =
      shared ? scan_eval_kernel<true> : scan_eval_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = dev < kMaxDevices
                     ? g_resident[dev][shared][budget].load(
                           std::memory_order_relaxed)
                     : 0;
  if (resident == 0) {
    int n_sm = 0, per_sm = 0;
    // the opt-in belongs to the function: always the largest budget
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBudgetOne);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = (per_sm < 1 ? 1 : per_sm) * n_sm;
    if (dev < kMaxDevices)
      g_resident[dev][shared][budget].store(resident,
                                            std::memory_order_relaxed);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncnt > 0) {
    err = cudaMemsetAsync(
        counts, 0, sizeof(int) * static_cast<size_t>(B) * ncnt, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // no more blocks than the widest tiles give work items
  const long long widest = static_cast<long long>(B) *
                           ((R + kRows * kThreads - 1) / (kRows * kThreads));
  const long long grid = widest < resident ? widest : resident;
  const Parts pp{code, ncode, cspec, ncnt, lnum, lmeta, lbytes};
  const Pages pg{{static_cast<const uint8_t*>(num),
                  static_cast<const uint8_t*>(slen),
                  static_cast<const uint8_t*>(ok),
                  static_cast<const uint8_t*>(null),
                  static_cast<const uint8_t*>(rowvalid),
                  static_cast<const uint8_t*>(sb)},
                 {num_ps, slen_ps, ok_ps, null_ps, rv_ps, sb_ps}};
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      static_cast<const uint8_t*>(prog), prog_bytes, pp, pg, B, R, C, W,
      static_cast<uint8_t*>(mask), static_cast<int*>(counts), smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
