// GF(2^8) coding matmul for Hopper (sm_90a): out = M (x) shards.
//
// Replaces the TPU kernel minio_tpu/ops/rs_pallas.py:52-80 (_kernel/_run):
// one kernel serves RS encode (parity matrix), degraded-GET decode
// (missing-data matrix) and heal (recover matrix). It computes what the TPU
// kernel computes, not the way it does: the TPU multiplies the 0/1 bit
// planes on its matrix unit in bf16, which has no reason to exist here.
//
// Input is the canonical byte-major bit expansion of the (r, k) GF(2^8)
// matrix: an (8r, 8k) 0/1 uint8 matrix m2 whose row 8j+q is output bit q of
// output byte j and whose column 8i+p is input bit p of input byte i
// (minio_tpu_torch/ops/gf256.expand_to_gf2). Any 0/1 matrix is taken, not
// only GF expansions.
//
// The math: bit-plane products on packed words. With
//   c(j, i, p) = sum_q m2[8j+q, 8i+p] << q,
// the byte that input bit p of input row i adds into output row j, output
// byte j is the XOR over (i, p) of [bit p of x_i] * c(j, i, p). On a 32-bit
// word X holding four bytes of row i, t_p = (X >> p) & 0x01010101 has 0 or
// 1 in each byte, so t_p * c(j, i, p) puts c or 0 in each byte with no
// carries (c < 256), and acc_j ^= t_p * c(j, i, p). Per four bytes of one
// input row: 15 shift-and-mask operations for the eight planes, 8r
// multiplies (IMAD) and 4r three-input XORs (LOP3).
//
// What bounds it on this card: integer issue, not bytes. Each input byte is
// read once and each output byte written once, (k + r)·S·B bytes, 0.0134
// ms at 3.35 TB/s for the main path's PUT batch. The arithmetic is about
// 16 + 12r integer instructions per four bytes of an input row: at r = 4
// and 64 integer lanes a clock per SM (1,980 MHz, 132 SMs) that alone is
// about 0.03 ms for the same batch. The design keeps every other
// instruction (address arithmetic, byte loads and stores) out of the inner
// loop.
//
// Design: each block takes tiles of `tile` byte columns of one batch entry,
// grid-stride, and handles a tile in three phases.
// (a) Load. The k input row tiles are copied into shared memory with
//     16-byte cp.async copies of the aligned pieces that cover them. Rows
//     start at any byte offset (S = 349,526 = 6 mod 16 puts neighbouring
//     rows at different offsets), so each row is staged from its tile start
//     rounded down to 16 and its offset is kept. A piece is copied whole
//     only when each of its words holds a byte of the input tensor, else
//     word by word: no word without a tensor byte is read (the first and
//     last rows border unallocated memory). The next tile's copies are
//     issued before this tile's stores, so they overlap.
// (b) Code. Thread t takes words t, t + 256, t + 512, t + 768 of the tile:
//     each is realigned from two shared words with one funnel shift
//     (neighbouring lanes, neighbouring words: no bank conflicts), and the
//     output rows are done four at a time in registers. c(j, i, p) for four
//     output rows sits in one 16-byte shared entry, read by every lane at
//     one address (a broadcast), and serves the four words a thread holds.
//     The r output row tiles go to shared memory, column x at byte 16 + x.
// (c) Store. Each output row is written as the aligned 16-byte pieces that
//     cover its tile: a piece that lies inside the tile is realigned from
//     five shared words and stored whole; the one or two pieces at the
//     tile's ends also hold bytes of a neighbouring tile or row, which
//     another block owns, so only this tile's bytes are stored, one by one.
// Geometry: 256 threads, tiles up to 4,096 columns (shared memory 67,392
// bytes at 12+4, three blocks per SM). The tile is narrowed, in steps of
// 128 columns, so that the tiles fill whole waves of the blocks the card
// holds at once: B=8, S=349,526 runs as 784 tiles of 3,584 columns on 396
// blocks.
//
// Why not tensor cores: an int8 MMA takes 0/1 operands, so each byte would
// first be expanded into eight; in registers that expansion costs about as
// many integer operations as the bit-plane form needs to finish the answer.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;                       // words per thread per row
constexpr int kTile = 4 * kWords * kThreads;    // widest tile: 4,096 columns
constexpr int kMinTile = 1024;
constexpr int kRawStride = kTile + 16;          // staged input row, bytes
constexpr int kOutStride = kTile + 32;          // staged output row, bytes
constexpr int kMaxShards = 16;
constexpr int kEntryBytes = 16;                 // c(j..j+3, i, p)
constexpr uint32_t kLsb = 0x01010101u;
constexpr int smem_bytes(int r, int k) {
  return (r + 3) / 4 * k * 8 * kEntryBytes + k * kRawStride + r * kOutStride;
}
// r = k = 16 fits Hopper's 227 KB opt-in shared memory per block
static_assert(smem_bytes(kMaxShards, kMaxShards) <= 232448,
              "tiles too wide for one block");
static_assert(kMinTile <= kTile && kTile % 128 == 0, "tile widths");
static_assert(kRawStride % 16 == 0 && kOutStride % 16 == 0, "alignment");

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy the aligned 16-byte piece at `a` to shared `dst`: whole when each of
// its words holds a byte of the tensor [lo, hi), else only those words.
__device__ __forceinline__ void stage_piece(uint32_t dst, uintptr_t a,
                                            uintptr_t lo, uintptr_t hi) {
  if (a + 4 > lo && a + 12 < hi) {
    cp_async16(dst, reinterpret_cast<const void*>(a));
    return;
  }
#pragma unroll
  for (int w = 0; w < 16; w += 4)
    if (a + w + 4 > lo && a + w < hi)
      cp_async4(dst + w, reinterpret_cast<const void*>(a + w));
}

// Phase (a) for the tile at columns c0 .. c0 + n - 1 of batch entry b:
// input row i's aligned pieces go to raw + i * kRawStride, its offset to
// s_off[i]; column c0 + x lands at raw byte s_off[i] + x.
__device__ __forceinline__ void stage_tile(const uint8_t* in, long long b,
                                           int k, long long S, long long c0,
                                           int n, uintptr_t lo, uintptr_t hi,
                                           uint8_t* raw, int* s_off) {
  for (int i = 0; i < k; ++i) {
    const uintptr_t row =
        reinterpret_cast<uintptr_t>(in + (b * k + i) * S + c0);
    const int off = static_cast<int>(row & 15);
    const uintptr_t a0 = row - off;
    const int pieces = (off + n + 15) >> 4;
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(raw + i * kRawStride));
    for (int q = threadIdx.x; q < pieces; q += kThreads)
      stage_piece(dst + 16 * q, a0 + 16 * q, lo, hi);
    if (threadIdx.x == 0) s_off[i] = off;
  }
  cp_async_commit();
}

__device__ __forceinline__ uint32_t part(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Phase (b) for R output rows (one group of up to four) and the first W of
// the thread's words: word u of thread t is tile word t + u * kThreads.
template <int R, int W>
__device__ __forceinline__ void code_group(const uint8_t* raw,
                                           const int* s_off,
                                           const uint4* tab, int k,
                                           uint8_t* outs) {
  uint32_t acc[W][R] = {};
  for (int i = 0; i < k; ++i) {
    const int off = s_off[i];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
                              raw + i * kRawStride) +
                          (off >> 2) + threadIdx.x;
    const int sh = 8 * (off & 3);
    uint32_t x[W];
#pragma unroll
    for (int u = 0; u < W; ++u)
      x[u] = __funnelshift_r(src[u * kThreads], src[u * kThreads + 1], sh);
    const uint4* c = tab + i * 8;
#pragma unroll
    for (int p = 0; p < 8; p += 2) {
      const uint4 ca = c[p], cb = c[p + 1];
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const uint32_t ta = (x[u] >> p) & kLsb;
        const uint32_t tb = (x[u] >> (p + 1)) & kLsb;
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[u][j] ^= (ta * part(ca, j)) ^ (tb * part(cb, j));
      }
    }
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(outs + 16) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int u = 0; u < W; ++u)
      dst[j * (kOutStride / 4) + u * kThreads] = acc[u][j];
}

// code_group<R, w> for this warp's w = 0 .. kWords word slices
template <int R, int W = kWords>
__device__ __forceinline__ void code_group_words(int w, const uint8_t* raw,
                                                 const int* s_off,
                                                 const uint4* tab, int k,
                                                 uint8_t* outs) {
  if (w == W)
    code_group<R, W>(raw, s_off, tab, k, outs);
  else if constexpr (W > 1)
    code_group_words<R, W - 1>(w, raw, s_off, tab, k, outs);
}

// Phase (c): output row j of the tile from outs + j * kOutStride (column x
// at byte 16 + x) to out, whole aligned pieces inside the tile, single
// bytes in the pieces it shares with a neighbouring tile or row.
__device__ __forceinline__ void store_tile(uint8_t* out, long long b, int r,
                                           long long S, long long c0, int n,
                                           const uint8_t* outs) {
  for (int j = 0; j < r; ++j) {
    uint8_t* row = out + (b * r + j) * S + c0;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    const int pieces = (off + n + 15) >> 4;
    const uint8_t* src = outs + j * kOutStride;
    for (int q = threadIdx.x; q < pieces; q += kThreads) {
      const int x0 = 16 * q - off;              // tile column of piece byte 0
      if (x0 >= 0 && x0 + 16 <= n) {
        const int s = 16 + x0;
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(src) + (s >> 2);
        const int sh = 8 * (s & 3);
        uint4 v;
        v.x = __funnelshift_r(w[0], w[1], sh);
        v.y = __funnelshift_r(w[1], w[2], sh);
        v.z = __funnelshift_r(w[2], w[3], sh);
        v.w = __funnelshift_r(w[3], w[4], sh);
        *reinterpret_cast<uint4*>(row + x0) = v;
      } else {
        const int e0 = x0 < 0 ? 0 : x0;
        const int e1 = x0 + 16 < n ? x0 + 16 : n;
        for (int e = e0; e < e1; ++e) row[e] = src[16 + e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
gf_matmul_kernel(const uint8_t* __restrict__ m2,
                 const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int batch, int r, int k, long long S, int tile,
                 long long tiles_per_row) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_off[kMaxShards];
  const int groups = (r + 3) / 4;
  const uint4* tab = reinterpret_cast<const uint4*>(smem);
  uint8_t* raw = smem + groups * k * 8 * kEntryBytes;
  uint8_t* outs = raw + k * kRawStride;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(in);
  const uintptr_t hi = lo + static_cast<uintptr_t>(batch) * k * S;
  const long long n_tiles = batch * tiles_per_row;

  // tile t is columns c0 .. c0 + n - 1 of batch entry t / tiles_per_row
  auto columns = [&](long long t, long long& c0) {
    c0 = (t % tiles_per_row) * tile;
    return static_cast<int>(S - c0 < tile ? S - c0 : tile);
  };
  auto stage = [&](long long t) {
    long long c0;
    const int n = columns(t, c0);
    stage_tile(in, t / tiles_per_row, k, S, c0, n, lo, hi, raw, s_off);
  };
  if (blockIdx.x < n_tiles) stage(blockIdx.x);

  // while the first tile loads: c(j, i, p) at word ((g * k + i) * 8 + p) *
  // 4 + (j - 4g); rows j >= r are zero
  {
    uint32_t* tw = reinterpret_cast<uint32_t*>(smem);
    const int k8 = 8 * k;
    for (int e = threadIdx.x; e < groups * k * 32; e += kThreads) {
      const int j = 4 * (e / (32 * k)) + (e & 3);
      const int i = (e >> 5) % k;
      const int p = (e >> 2) & 7;
      uint32_t c = 0;
      if (j < r)
        for (int q = 0; q < 8; ++q)
          c |= static_cast<uint32_t>(m2[(8 * j + q) * k8 + 8 * i + p] & 1)
               << q;
      tw[e] = c;
    }
  }

  const int warp = threadIdx.x >> 5;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    long long c0;
    const int n = columns(t, c0);
    cp_async_wait_all();
    __syncthreads();              // tile staged; the last tile's stores done
    // this warp's words are 32 * warp + kThreads * u + lane; slice u holds
    // tile columns when its first word does
    const int ahead = (n + 3) / 4 - 32 * warp;
    const int w =
        ahead <= 0 ? 0 : min(kWords, (ahead + kThreads - 1) / kThreads);
    for (int g = 0; g < groups; ++g) {
      const uint4* tg = tab + g * k * 8;
      uint8_t* og = outs + 4 * g * kOutStride;
      switch (r - 4 * g) {
        case 1: code_group_words<1>(w, raw, s_off, tg, k, og); break;
        case 2: code_group_words<2>(w, raw, s_off, tg, k, og); break;
        case 3: code_group_words<3>(w, raw, s_off, tg, k, og); break;
        default: code_group_words<4>(w, raw, s_off, tg, k, og); break;
      }
    }
    __syncthreads();              // raw is free, outs complete
    if (t + gridDim.x < n_tiles) stage(t + gridDim.x);
    store_tile(out, t / tiles_per_row, r, S, c0, n, outs);
  }
}

// Resident blocks per SM times SMs, per device and (r, k): fixed once the
// shared-memory opt-in is set, so each is worked out at its first launch.
constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices][kMaxShards][kMaxShards];

}  // namespace

extern "C" {

// m2: (8r, 8k) uint8 0/1; in: (batch, k, S) uint8; out: (batch, r, S)
// uint8 — all contiguous device memory, at any byte address. Returns
// cudaGetLastError() after the launch.
int gf_matmul_launch(const void* m2, const void* in, void* out, int batch,
                     int r, int k, long long S, void* stream) {
  if (r < 1 || r > 16 || k < 1 || k > 16 || batch < 1 || batch > 65535 ||
      S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const int smem = smem_bytes(r, k);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long resident = dev < kMaxDevices ? g_resident[dev][r - 1][k - 1]
                                               .load(std::memory_order_relaxed)
                                         : 0;
  if (resident == 0) {
    int n_sm = 0, per_sm = 0;
    // the opt-in belongs to the function, not to one launch: set it to the
    // largest block's, so that no (r, k) shrinks it below another's
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gf_matmul_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes(kMaxShards, kMaxShards));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gf_matmul_kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * n_sm;
    if (dev < kMaxDevices)
      g_resident[dev][r - 1][k - 1].store(static_cast<int>(resident),
                                          std::memory_order_relaxed);
  }
  // the widest tiles take `waves` rounds of the resident blocks; narrow
  // them (to a multiple of 128 columns) so that they fill those rounds
  const long long widest = batch * ((S + kTile - 1) / kTile);
  const long long waves = (widest + resident - 1) / resident;
  const long long per_row = waves * resident / batch;
  long long tile = (S + per_row - 1) / per_row;
  tile = (tile + 127) / 128 * 128;
  if (tile < kMinTile) tile = kMinTile;
  if (tile > kTile) tile = kTile;
  const long long tiles_per_row = (S + tile - 1) / tile;
  const long long n_tiles = batch * tiles_per_row;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  gf_matmul_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(m2), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), batch, r, k, S, static_cast<int>(tile),
      tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
