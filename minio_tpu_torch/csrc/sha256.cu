// Batched SHA-256 for Hopper (sm_90a): one digest per row.
//
// Replaces the TPU device program minio_tpu/ops/sha256_jax.py:85-155
// (_compress and _sha256_impl), which advances all N rows in lockstep as
// u32 vectors: standard padding (0x80, zeros, the 64-bit big-endian bit
// length), 64 rounds per 64-byte block, the message schedule extended in
// place. The plain PyTorch version is minio_tpu_torch/ops/sha256_ref.py.
//
// What bounds it on this card: each row is one dependent chain of
// compressions (a block's rounds start from the state the last block
// left), and within a compression each round's new `e` and `a` depend on
// the previous round's. At the main path's shapes (160 to 640 rows of
// 65,536 bytes, 1,025 compressions a row) that chain is far above the
// byte and operation bounds, and no split of the rows shortens it: a warp
// issues a round once for all its lanes, so a row costs its compressions
// times one warp's time per compression, however few rows the warp holds.
// That time is the issue of one warp on one scheduler, which on this card
// runs at about two cycles per instruction of this code (measured: the
// round loop's ~924 instructions take ~1,900 cycles): the integer ALU pipe
// takes two cycles per warp instruction, and a round needs six
// funnel-shift rotates, four LOP3 and two three-input adds on it.
// Everything else a warp does per compression adds to every row:
// extending the message schedule (48 words of two small sigmas and a
// four-term sum), byte-swapping the loaded words, adding K, and waiting
// for the block's bytes.
//
// Design:
// - Warp specialisation. A block is four warps on four schedulers: warp 0
//   is the round warp, one row per lane (32 rows a block); warps 1-3 are
//   producers. The round warp keeps the eight state words in registers and
//   runs only the 64 rounds, fourteen instructions each, reading W[t] +
//   K[t] from shared memory with one 16-byte load per four rounds, issued
//   four rounds ahead.
// - The W + K ring. Producer p (0-2) owns stages p, p + 3, p + 6, ... of
//   kGroup blocks each and has kSlots ring slots for them. A slot holds,
//   per block, 16 lines of 32 lanes x 4 words: lane r's four consecutive
//   W + K words are 16 bytes, and the 32 lanes of a line are 512
//   consecutive bytes, so both the producer's 16-byte stores and the round
//   warp's 16-byte loads are free of bank conflicts.
// - Producers bring the bytes in with 16-byte cp.async copies, kRawDepth -
//   1 stages ahead, coalesced (neighbouring lanes take neighbouring pieces
//   of one row). A row is staged as the stream of aligned 16-byte pieces
//   from its start rounded down to 16: a stage holds stream bytes [64 *
//   kGroup * s, + 64 * kGroup + 16), the 16 extra bytes being the next
//   stage's first piece, so every block's 80-byte window lies in one stage
//   whatever the row's offset. A piece is copied whole only when each of
//   its 32-bit words holds a row byte; a row's first and last pieces go
//   word by word, so no byte at or past `length` is read and no word
//   without a row byte (the last row may end the allocation). Each
//   producer lane then takes its row's block from the window: five 16-byte
//   loads, a shift by whole words for rows that start mid-piece, and one
//   byte permute per word that realigns and byte-swaps at once. The
//   padding tail (0x80, zeros, the bit length: one block, or two when
//   length % 64 >= 56) is built by masking the last window. Then the 48
//   schedule words, + K, and four 16-byte stores per block line group.
// - Synchronisation per ring slot with named barriers of 64 threads (the
//   producer warp and the round warp): the producer arrives on the slot's
//   "full" barrier after its stores, the round warp waits on it; the round
//   warp arrives on the slot's "empty" barrier after its last read, and the
//   producer waits on it before it writes the slot again. Each barrier is
//   used only when its partner will use it too, so none is left half
//   done. No block-wide barrier.
// - Geometry: 32 rows a block, one block per SM up to 32 x SM count rows
//   (config 5's 160 to 640 rows are 5 to 20 blocks), so no two round warps
//   share a scheduler. Larger launches queue further blocks behind those.
//   The rings take 139,776 bytes of shared memory (W + K 98,304, raw
//   41,472), above the 48 KB default: the opt-in is set once per device.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

__constant__ uint32_t kH0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                0xa54ff53a, 0x510e527f, 0x9b05688c,
                                0x1f83d9ab, 0x5be0cd19};

constexpr int kRows = 32;          // rows per block, one per round-warp lane
constexpr int kProducers = 3;      // warps 1..3
constexpr int kThreads = 32 * (1 + kProducers);
constexpr int kGroup = 2;          // 64-byte blocks per ring stage
constexpr int kSlots = 2;          // W + K slots per producer
constexpr int kRawDepth = 3;       // raw stages per producer, 2 loads ahead
constexpr int kStageBytes = 64 * kGroup;            // row bytes per stage
constexpr int kRawPieces = kStageBytes / 16 + 1;    // + the next piece
constexpr int kRawRow = 16 * kRawPieces;   // 144 = 9 x 16: rows 9 pieces
                                           // apart, odd, so 16-byte loads
                                           // of 8 lanes hit 8 bank groups
constexpr int kRawStage = kRows * kRawRow;
constexpr int kBlockLines = 16;            // lines of 4 words per block
constexpr int kWkBlock = kBlockLines * kRows * 16;  // bytes of one block
constexpr int kWkSlot = kGroup * kWkBlock;
constexpr int kWkBytes = kProducers * kSlots * kWkSlot;
constexpr int kSmem = kWkBytes + kProducers * kRawDepth * kRawStage;
static_assert(kSmem <= 227 * 1024, "ring too large for one block");
static_assert(1 + 2 * kProducers * kSlots <= 16, "too many named barriers");
static_assert((kRawRow / 16) % 2 == 1, "raw rows must be an odd piece apart");

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(64) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(64) : "memory");
}

// named barrier ids (0 is __syncthreads'): slot `slot` of producer `p`
__device__ __forceinline__ int full_id(int p, int slot) {
  return 1 + 2 * (p * kSlots + slot);
}
__device__ __forceinline__ int empty_id(int p, int slot) {
  return 2 + 2 * (p * kSlots + slot);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy the 16-byte piece at stream byte x (x % 16 == 0) of a row whose
// bytes are stream bytes off .. end - 1: whole when each of its words
// holds a row byte, else only the words that do.
__device__ __forceinline__ void stage_piece(uint32_t dst, const uint8_t* src,
                                            long long x, int off,
                                            long long end) {
  if (x >= (off & ~3) && x + 16 <= ((end + 3) & ~3LL)) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int w = 0; w < 16; w += 4)
    if (x + w + 4 > off && x + w < end) cp_async4(dst + w, src + w);
}

// Stage `s` of the block's rows (stream bytes [kStageBytes * s,
// + kRawRow)) into the raw stage at shared address `raw`; nothing past
// the last stage.
__device__ __forceinline__ void stage_raw(long long s, long long n_stages,
                                          const uint8_t* rows_ptr,
                                          long long row_stride, int rows,
                                          long long length, uint32_t raw,
                                          int lane) {
  if (s >= n_stages) return;
  const long long x0 = s * kStageBytes;
  for (int q = lane; q < rows * kRawPieces; q += 32) {
    const int r = q / kRawPieces;
    const int j = q - r * kRawPieces;
    const uint8_t* p = rows_ptr + r * row_stride;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    const long long end = off + length;    // stream bytes that are the row
    const long long x = x0 + 16 * j;
    if (x >= end) continue;
    stage_piece(raw + r * kRawRow + 16 * j, p - off + x, x, off, end);
  }
}

// One block's W[t] + K[t] for this lane's row, from its 80-byte window
// `win` (16-byte aligned; stream bytes 64b .. 64b + 79 of the row). `k0`
// and `sel` realign a row that starts at stream byte 4 * k0 + o: word j is
// the big-endian word of row bytes 4j .. 4j + 3. `n_b` = length - 64b:
// below 64 this is a padding block (negative: the second one).
__device__ __forceinline__ void schedule_block(const uint8_t* win, int k0,
                                               uint32_t sel, long long n_b,
                                               bool last,
                                               unsigned long long bits,
                                               uint4* dst) {
  uint32_t v[20];
  const uint4* w4 = reinterpret_cast<const uint4*>(win);
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint4 t = w4[j];
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
  if (k0 & 2) {
#pragma unroll
    for (int j = 0; j < 18; ++j) v[j] = v[j + 2];
  }
  if (k0 & 1) {
#pragma unroll
    for (int j = 0; j < 19; ++j) v[j] = v[j + 1];
  }
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __byte_perm(v[j], v[j + 1], sel);
  if (n_b < 64) {
    // keep the row's bytes, 0x80 after them, zeros; the bit length last
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = static_cast<int>(n_b) - 4 * j;   // row bytes in word j
      const uint32_t keep = n >= 4 ? ~0u : n <= 0 ? 0u : ~0u << (32 - 8 * n);
      const uint32_t pad = (n >= 0 && n < 4) ? 0x80u << (24 - 8 * n) : 0u;
      w[j] = (w[j] & keep) | pad;
    }
    if (last) {
      w[14] = static_cast<uint32_t>(bits >> 32);
      w[15] = static_cast<uint32_t>(bits);
    }
  }
#pragma unroll
  for (int t = 0; t < 64; t += 4) {
    uint32_t o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = t + u;
      if (i >= 16) {
        const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[i & 15] += s0 + w[(i - 7) & 15] + s1;
      }
      o[u] = w[i & 15] + kK[i];
    }
    dst[(t / 4) * kRows] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// A 16-byte shared-memory load at a 32-bit shared-window address (a
// generic pointer made the compiler rebuild the window's base in every
// trip of the block loop): volatile, so that it stays after the barrier
// that hands the slot over.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The 64 rounds of one block on the round warp: lane's W + K words come
// four at a time from line q of the block, at shared address wk + q * 512
// (wk is the lane's entry of line 0); each line is loaded while the rounds
// of the one before it run. `one` is 1, a kernel argument: see the new e.
__device__ __forceinline__ void rounds(uint32_t (&st)[8], uint32_t wk,
                                       uint32_t one) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  uint4 next = lds128(wk);
#pragma unroll
  for (int q = 0; q < kBlockLines; ++q) {
    const uint4 l = next;
    if (q + 1 < kBlockLines) next = lds128(wk + (q + 1) * kRows * 16);
    const uint32_t line[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // h is e of three rounds back: h + WK is off the chain, which runs
      // e -> S1, Ch -> t1 -> new e. Fourteen instructions: 6 rotates and 4
      // LOP3 on the ALU pipe, the three-input adds t1 and new a there too,
      // h + WK and new e on the FMA pipe. Written as t1 * one + d, new e is
      // an IMAD with its multiplier from the constant bank, which ptxas
      // schedules tighter than the plain add it also puts there (0.984
      // against 1.003 ms at 640 rows on an H100 80GB HBM3 at 700 W,
      // scripts/sha256_ab.py); summing d + h + WK ahead, or every add as
      // an IMAD, costs more instructions than it saves (1.064 and 1.168
      // ms on the same card).
      const uint32_t hk = h + line[u];
      const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t t1 = hk + s1 + ch;
      h = g;
      g = f;
      f = e;
      e = t1 * one + d;
      d = c;
      c = b;
      b = a;
      a = t1 + s0 + maj;
    }
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__global__ void __launch_bounds__(kThreads, 1)
    sha256_kernel(const uint8_t* __restrict__ data, long long n_rows,
                  long long row_stride, long long length,
                  uint8_t* __restrict__ out, uint32_t one) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(n_rows - row0 < kRows ? n_rows - row0 : kRows);
  const uint8_t* rows_ptr = data + row0 * row_stride;

  const long long n_full = length / 64;
  const int rem = static_cast<int>(length - n_full * 64);
  const long long n_blocks = n_full + (rem >= 56 ? 2 : 1);
  const long long n_stages = (n_blocks + kGroup - 1) / kGroup;
  const uint32_t ring0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  if (warp == 0) {
    // the round warp: stage s is producer s % 3's, in its slot
    // (s / 3) % kSlots
    uint32_t st[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = kH0[j];
    for (long long s = 0; s < n_stages; ++s) {
      const int p = static_cast<int>(s % kProducers);
      const int slot = static_cast<int>((s / kProducers) % kSlots);
      bar_sync(full_id(p, slot));
      const uint32_t wk = ring0 + (p * kSlots + slot) * kWkSlot + 16 * lane;
      const long long left = n_blocks - s * kGroup;
      const int nb = static_cast<int>(left < kGroup ? left : kGroup);
#pragma unroll 1
      for (int i = 0; i < nb; ++i) rounds(st, wk + i * kWkBlock, one);
      if (s + kProducers * kSlots < n_stages) bar_arrive(empty_id(p, slot));
    }
    if (lane < rows) {
      // (N, 32) output rows are 16-byte aligned: the entry point checks
      uint4* o = reinterpret_cast<uint4*>(out + (row0 + lane) * 32);
      o[0] = make_uint4(__byte_perm(st[0], 0, 0x0123),
                        __byte_perm(st[1], 0, 0x0123),
                        __byte_perm(st[2], 0, 0x0123),
                        __byte_perm(st[3], 0, 0x0123));
      o[1] = make_uint4(__byte_perm(st[4], 0, 0x0123),
                        __byte_perm(st[5], 0, 0x0123),
                        __byte_perm(st[6], 0, 0x0123),
                        __byte_perm(st[7], 0, 0x0123));
    }
    return;
  }

  // a producer: stages p, p + 3, ...; lanes past the block's rows shadow
  // its last row (their W + K words are read by round-warp lanes that
  // store nothing)
  const int p = warp - 1;
  const int my = lane < rows ? lane : rows - 1;
  const int off = static_cast<int>(
      reinterpret_cast<uintptr_t>(rows_ptr + my * row_stride) & 15);
  const int k0 = off >> 2, o = off & 3;
  const uint32_t sel = (o + 3) | (o + 2) << 4 | (o + 1) << 8 | o << 12;
  const unsigned long long bits = static_cast<unsigned long long>(length) * 8;
  uint4* wk_p = reinterpret_cast<uint4*>(smem) + p * kSlots * (kWkSlot / 16);
  const int raw_at = kWkBytes + p * kRawDepth * kRawStage;
  const uint32_t raw0 = ring0 + raw_at;

#pragma unroll
  for (int k = 0; k < kRawDepth - 1; ++k) {
    stage_raw(p + k * kProducers, n_stages, rows_ptr, row_stride, rows,
              length, raw0 + k * kRawStage, lane);
    cp_async_commit();
  }
  long long k = 0;
  for (long long s = p; s < n_stages; s += kProducers, ++k) {
    // the raw stage read at k - 1 is free (__syncwarp below)
    stage_raw(s + (kRawDepth - 1) * kProducers, n_stages, rows_ptr,
              row_stride, rows, length,
              raw0 + static_cast<int>((k + kRawDepth - 1) % kRawDepth) *
                         kRawStage,
              lane);
    cp_async_commit();
    cp_async_wait<kRawDepth - 1>();   // stage s has landed
    __syncwarp();
    const int slot = static_cast<int>(k % kSlots);
    if (k >= kSlots) bar_sync(empty_id(p, slot));
    const uint8_t* win = smem + raw_at +
                         static_cast<int>(k % kRawDepth) * kRawStage +
                         my * kRawRow;
    uint4* dst = wk_p + slot * (kWkSlot / 16) + lane;
    const long long left = n_blocks - s * kGroup;
    const int nb = static_cast<int>(left < kGroup ? left : kGroup);
#pragma unroll 1
    for (int i = 0; i < nb; ++i) {
      const long long b = s * kGroup + i;
      schedule_block(win + 64 * i, k0, sel, length - 64 * b,
                     b == n_blocks - 1, bits, dst + i * (kWkBlock / 16));
    }
    bar_arrive(full_id(p, slot));
    __syncwarp();
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// data: n_rows rows of row_stride bytes (device memory); hashes the first
// `length` bytes of each row into out (n_rows, 32), which must be 16-byte
// aligned, on the given stream. Returns the CUDA error of the launch
// (cudaGetLastError()).
int sha256_launch(const void* data, long long n_rows, long long row_stride,
                  long long length, void* out, void* stream) {
  if (n_rows < 1 || length < 0 || length > row_stride ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory opt-in belongs to the function on each device; the
  // ring's size never changes, so it is set once per device
  static std::atomic<bool> opted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev].load()) {
    err = cudaFuncSetAttribute(sha256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev].store(true);
  }
  const long long blocks = (n_rows + kRows - 1) / kRows;
  sha256_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_rows, row_stride, length,
      static_cast<uint8_t*>(out), 1u);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
