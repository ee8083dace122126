// S3 Select's WHERE clause on Hopper (sm_90a): a predicate-program
// interpreter, one thread per row.
//
// Replaces the TPU device program minio_tpu/scan/kernels.py:244-314
// (_eval_prog and _kernel_for, with _str_cmp, _num_cmp, _eval_side,
// _eval_cmp and _eval_like at :110-241), which traces each query's
// predicate tree into its own XLA program of element-wise ops over the
// pager's pages and pads the page axis to a power of two so that its trace
// cache stays small. Here one kernel runs every query: the host flattens
// the tree once per plan signature into a postfix program with a float64
// literal pool and a byte pool (ops/scan_program.py), and each thread
// interprets it for its row. There is no per-query compile and no padding
// of the page axis. The plain PyTorch version is
// minio_tpu_torch/ops/scan_plain.py (the reference's tree walk).
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
// What bounds it on this card: it reads the page arrays its program
// needs once and does a few dozen operations per row, so it is bound by
// bytes. At TPC-H Q6's launch (3 slots of width 16) a row needs its
// rowvalid, the three slots' ok, the nulls of l_shipdate and l_discount,
// the numbers of l_discount and l_quantity, and the 16 string bytes of
// l_shipdate (its literal is a date, so that compare is a string one):
// 38 bytes in and 1 out, ~20.3 MB for 520,000 rows, ~6.1 us at 3.35 TB/s
// (scripts/scan_cases.must_move_bytes counts them from the program and
// the pages). A row's string cells are read as 8-byte words (a compare
// stops at the first differing word), its numbers and flags as single
// loads.
//
// Design, right first:
// - Grid (ceil(R / 256), min(B, 65535)): a block holds 256 rows of one
//   page and strides over the pages past grid.y, so its COUNT sums go to
//   shared memory by warp ballots and then to the page's counters with one
//   atomic add per count per block.
// - The program blob and its parts (byte offsets and counts, launch
//   arguments: the host owns the layout, ops/scan_program.py) live in
//   shared memory when the blob and the counters fit a block's default
//   48 KB; every thread then walks the same code, so the instruction fetch
//   is a broadcast. A larger program (a long IN list, long literals) is
//   read from global memory, and its counters go straight to the page's
//   with one atomic add per warp. No program is too large to run.
// - A thread keeps a value stack of kMaxVals sides (number, ok, null, and
//   where its string lives: a column slot or a literal) and a bit stack of
//   kMaxBools booleans. The depths are ops/scan_program.py's MAX_VALS and
//   MAX_BOOLS, passed in as SCAN_MAX_VALS and SCAN_MAX_BOOLS by the build
//   (ops/kernels.py). The host refuses a deeper program before the launch
//   (Decline "program-depth"), and the launcher refuses one whose stated
//   depths exceed the stacks.
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

#include <cstdint>

#if !defined(SCAN_MAX_VALS) || !defined(SCAN_MAX_BOOLS)
#error "build with -DSCAN_MAX_VALS and -DSCAN_MAX_BOOLS (ops/kernels.py)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVals = SCAN_MAX_VALS;
constexpr int kMaxBools = SCAN_MAX_BOOLS;
static_assert(kMaxVals >= 1 && kMaxBools >= 1 && kMaxBools <= 32,
              "the bool stack is one 32-bit word");
// the dynamic shared memory a block has without opting in to more
constexpr int kSharedBytes = 48 * 1024;
constexpr int kMaxGridY = 65535;

enum Op : int {
  kTrue = 1, kFalse = 2, kAnd = 3, kOr = 4, kNot = 5, kCol = 6, kLit = 7,
  kArith = 8, kCmp = 9, kNotNull = 10, kIsNull = 11, kLike = 12,
};

// where a program's parts sit in its blob (byte offsets), and their counts
struct Parts {
  int code, ncode;      // int32 instructions
  int cspec, ncnt;      // int32 COUNT specs
  int lnum;             // f64 literal numbers
  int lmeta;            // int32 (ok, byte offset, length) per literal
  int lbytes;           // literal bytes, each padded to 8
};

// one comparison side of one row
struct Side {
  double num;
  bool ok;
  bool null;
  int8_t skind;     // 0: no string (arithmetic), 1: column slot, 2: literal
  int ref;          // the slot, or the literal's index
};

__device__ __forceinline__ bool num_cmp(int op, double a, double b) {
  switch (op) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ bool order_cmp(int op, int c) {
  switch (op) {
    case 0: return c == 0;
    case 1: return c != 0;
    case 2: return c < 0;
    case 3: return c <= 0;
    case 4: return c > 0;
    default: return c >= 0;
  }
}

// -1, 0 or 1: the strings a (na words) and b (nb words), each read as
// zeros past its words, compared at their first differing byte (little
// endian: the lowest differing byte of the first differing word)
__device__ int str_order(const uint64_t* a, int na, const uint64_t* b,
                         int nb) {
  const int n = na > nb ? na : nb;
  for (int i = 0; i < n; ++i) {
    const uint64_t x = i < na ? a[i] : 0ull;
    const uint64_t y = i < nb ? b[i] : 0ull;
    if (x != y) {
      const int sh = (__ffsll(static_cast<long long>(x ^ y)) - 1) & ~7;
      return ((x >> sh) & 0xff) < ((y >> sh) & 0xff) ? -1 : 1;
    }
  }
  return 0;
}

__device__ __forceinline__ bool bytes_eq(const uint8_t* cell,
                                         const uint8_t* needle, int n) {
  for (int k = 0; k < n; ++k)
    if (cell[k] != needle[k]) return false;
  return true;
}

__device__ __forceinline__ double floor_mod(double a, double b) {
  const double r = fmod(a, b);
  return (r != 0.0 && ((r < 0.0) != (b < 0.0))) ? __dadd_rn(r, b) : r;
}

// kShared: the blob is copied into shared memory and the COUNT sums meet
// there; else the blob is read where it lies and each warp adds its sums
// to the page's counters itself.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
scan_eval_kernel(const uint8_t* __restrict__ prog, int prog_bytes,
                 const Parts pp,
                 const uint8_t* __restrict__ num, long long num_ps,
                 const uint8_t* __restrict__ slen, long long slen_ps,
                 const uint8_t* __restrict__ okp, long long ok_ps,
                 const uint8_t* __restrict__ nullp, long long null_ps,
                 const uint8_t* __restrict__ sb, long long sb_ps,
                 const uint8_t* __restrict__ rowvalid, long long rv_ps,
                 int B, int R, int C, int W, uint8_t* __restrict__ mask,
                 int* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* base = prog;
  int* s_counts = nullptr;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < prog_bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] =
          reinterpret_cast<const uint4*>(prog)[i];
    base = smem;
    s_counts = reinterpret_cast<int*>(smem + prog_bytes);
  }
  const int ncode = pp.ncode;
  const int ncnt = pp.ncnt;
  const int* code = reinterpret_cast<const int*>(base + pp.code);
  const int* cspec = reinterpret_cast<const int*>(base + pp.cspec);
  const double* lnum = reinterpret_cast<const double*>(base + pp.lnum);
  const int* lmeta = reinterpret_cast<const int*>(base + pp.lmeta);
  const uint8_t* lbytes = base + pp.lbytes;

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < R;
  const long long row_cell = static_cast<long long>(r) * C;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    if constexpr (kShared) {
      // each thread zeroes the counters it flushed for the page before
      for (int i = threadIdx.x; i < ncnt; i += blockDim.x) s_counts[i] = 0;
      __syncthreads();    // (the first page: orders the blob's copy too)
    }
    const double* pnum = reinterpret_cast<const double*>(num + b * num_ps);
    const int* pslen = reinterpret_cast<const int*>(slen + b * slen_ps);
    const uint8_t* pok = okp + b * ok_ps;
    const uint8_t* pnull = nullp + b * null_ps;
    const uint8_t* psb = sb + b * sb_ps;

    bool pass = false;
    if (active && rowvalid[b * rv_ps + r]) {
      Side vals[kMaxVals];
      int nv = 0;
      uint32_t bits = 0;
      int nb = 0;
      auto push = [&](bool v) {
        bits = (bits & ~(1u << nb)) | (static_cast<uint32_t>(v) << nb);
        ++nb;
      };
      auto pop = [&]() -> bool {
        --nb;
        return (bits >> nb) & 1u;
      };
      // a side's string: its words and their count
      auto words = [&](const Side& s, const uint64_t*& p, int& n) {
        if (s.skind == 1) {
          p = reinterpret_cast<const uint64_t*>(
              psb + (row_cell + s.ref) * W);
          n = W >> 3;
        } else {
          p = reinterpret_cast<const uint64_t*>(lbytes +
                                                lmeta[3 * s.ref + 1]);
          n = (lmeta[3 * s.ref + 2] + 7) >> 3;
        }
      };
      for (int pc = 0; pc < ncode;) {
        switch (code[pc++]) {
          case kTrue: push(true); break;
          case kFalse: push(false); break;
          case kAnd: { const bool y = pop(), x = pop(); push(x && y); break; }
          case kOr: { const bool y = pop(), x = pop(); push(x || y); break; }
          case kNot: push(!pop()); break;
          case kCol: {
            const int slot = code[pc++];
            const long long ci = row_cell + slot;
            vals[nv++] = Side{pnum[ci], pok[ci] != 0, pnull[ci] != 0, 1,
                              slot};
            break;
          }
          case kLit: {
            const int li = code[pc++];
            vals[nv++] = Side{lnum[li], lmeta[3 * li] != 0, false, 2, li};
            break;
          }
          case kArith: {
            const int op = code[pc++];
            const Side y = vals[--nv];
            const Side x = vals[nv - 1];
            bool valid = x.ok && y.ok;
            double v;
            if (op == 0) {
              v = __dadd_rn(x.num, y.num);
            } else if (op == 1) {
              v = __dsub_rn(x.num, y.num);
            } else if (op == 2) {
              v = __dmul_rn(x.num, y.num);
            } else {
              valid = valid && y.num != 0.0;
              const double d = y.num == 0.0 ? 1.0 : y.num;
              v = op == 3 ? __ddiv_rn(x.num, d) : floor_mod(x.num, d);
            }
            vals[nv - 1] = Side{v, valid, !valid, 0, 0};
            break;
          }
          case kCmp: {
            const int op = code[pc++];
            const Side y = vals[--nv];
            const Side x = vals[--nv];
            const bool both_num = x.ok && y.ok;
            bool res;
            if (x.skind == 0 || y.skind == 0) {
              res = both_num && num_cmp(op, x.num, y.num);
            } else if (both_num) {
              res = num_cmp(op, x.num, y.num);
            } else if (x.null || y.null) {
              res = false;
            } else {
              const uint64_t *px, *py;
              int nx, ny;
              words(x, px, nx);
              words(y, py, ny);
              res = order_cmp(op, str_order(px, nx, py, ny));
            }
            push(res);
            break;
          }
          case kNotNull: push(!vals[--nv].null); break;
          case kIsNull: push(pnull[row_cell + code[pc++]] != 0); break;
          case kLike: {
            const int slot = code[pc];
            const int kind = code[pc + 1];
            const int li = code[pc + 2];
            pc += 3;
            const long long ci = row_cell + slot;
            const int L = lmeta[3 * li + 2];
            const uint8_t* needle = lbytes + lmeta[3 * li + 1];
            const uint8_t* cell = psb + ci * W;
            bool ok;
            if (kind == 4) {                           // any
              ok = true;
            } else if (L > W) {
              ok = false;
            } else {
              const int s = pslen[ci];
              if (kind == 0) {                         // exact
                ok = s == L && bytes_eq(cell, needle, L);
              } else if (kind == 1) {                  // prefix
                ok = s >= L && bytes_eq(cell, needle, L);
              } else if (kind == 2) {                  // suffix
                ok = s >= L && bytes_eq(cell + (s - L), needle, L);
              } else {                                 // contains
                ok = false;
                for (int off = 0; off + L <= s && off <= W - L; ++off)
                  if (bytes_eq(cell + off, needle, L)) {
                    ok = true;
                    break;
                  }
              }
            }
            push(ok && pnull[ci] == 0);
            break;
          }
          default: break;
        }
      }
      pass = pop();
    }
    if (active) mask[b * R + r] = pass;

    for (int k = 0; k < ncnt; ++k) {
      const int c = cspec[k];
      const bool v = pass && (c < 0 || pnull[row_cell + c] == 0);
      const unsigned bal = __ballot_sync(0xffffffffu, v);
      if ((threadIdx.x & 31) == 0 && bal != 0) {
        if constexpr (kShared)
          atomicAdd(&s_counts[k], __popc(bal));
        else
          atomicAdd(&counts[b * ncnt + k], __popc(bal));
      }
    }
    if constexpr (kShared) {
      if (ncnt > 0) {
        __syncthreads();
        for (int k = threadIdx.x; k < ncnt; k += blockDim.x)
          if (s_counts[k] != 0)
            atomicAdd(&counts[b * ncnt + k], s_counts[k]);
      }
    }
  }
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncnt > 0) {
    cudaError_t err = cudaMemsetAsync(
        counts, 0, sizeof(int) * static_cast<size_t>(B) * ncnt, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Parts pp{code, ncode, cspec, ncnt, lnum, lmeta, lbytes};
  const dim3 grid((R + kThreads - 1) / kThreads,
                  B < kMaxGridY ? B : kMaxGridY);
  // the blob and the counters in shared memory when they fit
  const long long smem = prog_bytes + 4LL * ncnt;
  const bool shared = smem <= kSharedBytes;
  const auto kernel =
      shared ? scan_eval_kernel<true> : scan_eval_kernel<false>;
  kernel<<<grid, kThreads, shared ? static_cast<size_t>(smem) : 0, st>>>(
      static_cast<const uint8_t*>(prog), prog_bytes, pp,
      static_cast<const uint8_t*>(num), num_ps,
      static_cast<const uint8_t*>(slen), slen_ps,
      static_cast<const uint8_t*>(ok), ok_ps,
      static_cast<const uint8_t*>(null), null_ps,
      static_cast<const uint8_t*>(sb), sb_ps,
      static_cast<const uint8_t*>(rowvalid), rv_ps, B, R, C, W,
      static_cast<uint8_t*>(mask), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
