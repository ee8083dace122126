// Batched ChaCha20 keystream XOR for Hopper (sm_90a): the SSE cipher.
//
// Replaces the TPU device program minio_tpu/ops/chacha20_jax.py:50-122
// (_keystream_words, keystream_u8, keystream_xor, xor_packages), which
// runs the 16 state words of every (row, 64-byte block) as u32 planes
// through 10 double rounds. Row i, package p is ciphered under key words
// keys[i] and nonce words nonces[i, p]; inside a package the RFC 8439
// block counter restarts at 1 (counter 0 is the package's Poly1305
// one-time key, which the host derives: tags never come from the card).
// The plain PyTorch version is minio_tpu_torch/ops/chacha20_plain.py.
//
// What bounds it on this card: a 64-byte block is 992 32-bit operations
// (10 double rounds x 8 quarter rounds x 4 adds, 4 xors and 4 rotates,
// the 16 feed-forward adds and the 16 xors with the data) against 128
// bytes moved, so the integer pipes, not memory, set the floor. XORs and
// rotates (LOP3, PRMT, SHF) issue only on the integer ALU pipe; ptxas
// issues the adds on the FMA pipe by itself (IMAD.IADD), so the rounds of
// a block are ~650 ALU and ~340 FMA instructions. Measured on an H100
// 80GB HBM3 at 700 W (scripts/chacha20_ab.py), the time follows neither
// pipe alone: moving rotates to the FMA pipe (IMAD.HI + IMAD), adds as
// explicit IMADs, two blocks a thread side by side, five resident blocks
// an SM, or tiles of 256 or 512 threads were all slower or within 2%.
//
// Design:
// - Tiles of one row. The grid is (rows, tiles per row): one launch takes
//   up to 2^31 - 1 rows on grid.x and 65,535 tiles a row on grid.y (the
//   entry point refuses longer spans). A block of kThreads threads takes
//   kTile contiguous span bytes of one row, one 64-byte block a thread.
//   The row's base pointers are formed once in 64 bits; everything inside
//   a row is 32-bit. The package and counter of a block take one 32-bit
//   divide per thread; no 64-bit divide is left.
// - Key and nonce words once per block: eight key words and one 16-byte
//   entry per package the tile touches go to shared memory, and every
//   thread reads them from there (broadcast).
// - Coalesced staging at any byte offset. The block copies the 16-byte
//   granules that hold at least one byte of its tile's span into a
//   shared buffer with warp-contiguous 16-byte cp.async copies, issued
//   before the rounds so that they land while the keystream is computed.
//   No granule without a span byte is read: a granule never crosses a
//   page, so the copy reads nothing outside the tensor. Each thread then
//   reads its block's 64 bytes from 5 granules at the row's offset mod
//   16: a whole-word shift (chosen once per block: the offset is the
//   tile's) and a funnel shift per word realign them. The XORed block is
//   written span-aligned to a second buffer, and the block stores the
//   tile with warp-contiguous 16-byte stores of every output granule that
//   lies wholly inside the tile's span, each assembled from two buffer
//   granules the same way. The head and tail granules, which a
//   neighbouring tile or row shares or which reach past the span, take
//   byte stores of this tile's bytes only. One path serves every offset,
//   and `in` and `out` may sit at different offsets mod 16.
// - Both buffers are padded: granule g lives at slot g + g / 4, so a
//   thread's granules 4i .. 4i + 4 sit at slots 5i + {0, 1, 2, 3, 5},
//   80 bytes from its neighbour's: its 16-byte shared loads and stores
//   are free of bank conflicts and need no address arithmetic beyond the
//   base 5i. The warp-contiguous copies and stores meet at most one
//   two-way conflict per eight lanes.
// - In place (in == out) is legal: a block reads all of its granules
//   before it writes, reads a neighbour's head or tail bytes only to
//   discard them, and writes only its own bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;        // resident blocks the registers fit
constexpr int kTileBlocks = kThreads;  // one 64-byte block a thread
constexpr int kTile = 64 * kTileBlocks;             // span bytes of a block
constexpr int kGranules = kTile / 16 + 1;           // a tile at any offset
constexpr int kBufSlots = kGranules + (kGranules - 1) / 4;  // padded
// shared memory: the input and output buffers, then two granules of key
// words and one granule of nonce words per package the tile may touch
constexpr int kSmem = 16 * (2 * kBufSlots + 2 + kTileBlocks);
// within the 48 KB a block gets without the opt-in
static_assert(kSmem <= 48 * 1024, "tile too large for one block");
constexpr int kMaxTiles = 65535;                    // grid.y

// the buffer slot of granule g
__device__ __forceinline__ int pad(int g) { return g + (g >> 2); }

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b,
                                        uint32_t& c, uint32_t& d) {
  a += b;
  d = __byte_perm(d ^ a, 0, 0x1032);  // rotl 16
  c += d;
  b = __funnelshift_l(b ^ c, b ^ c, 12);
  a += b;
  d = __byte_perm(d ^ a, 0, 0x2103);  // rotl 8
  c += d;
  b = __funnelshift_l(b ^ c, b ^ c, 7);
}

// the 16 keystream words of block `ctr` under key words k and nonce n
__device__ __forceinline__ void block(const uint32_t (&k)[8], uint4 n,
                                      uint32_t ctr, uint32_t (&ks)[16]) {
  uint32_t x0 = 0x61707865u, x1 = 0x3320646eu, x2 = 0x79622d32u,
           x3 = 0x6b206574u;
  uint32_t x4 = k[0], x5 = k[1], x6 = k[2], x7 = k[3];
  uint32_t x8 = k[4], x9 = k[5], x10 = k[6], x11 = k[7];
  uint32_t x12 = ctr, x13 = n.x, x14 = n.y, x15 = n.z;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x0, x4, x8, x12);
    quarter(x1, x5, x9, x13);
    quarter(x2, x6, x10, x14);
    quarter(x3, x7, x11, x15);
    quarter(x0, x5, x10, x15);
    quarter(x1, x6, x11, x12);
    quarter(x2, x7, x8, x13);
    quarter(x3, x4, x9, x14);
  }
  ks[0] = x0 + 0x61707865u;
  ks[1] = x1 + 0x3320646eu;
  ks[2] = x2 + 0x79622d32u;
  ks[3] = x3 + 0x6b206574u;
  ks[4] = x4 + k[0];
  ks[5] = x5 + k[1];
  ks[6] = x6 + k[2];
  ks[7] = x7 + k[3];
  ks[8] = x8 + k[4];
  ks[9] = x9 + k[5];
  ks[10] = x10 + k[6];
  ks[11] = x11 + k[7];
  ks[12] = x12 + ctr;
  ks[13] = x13 + n.x;
  ks[14] = x14 + n.y;
  ks[15] = x15 + n.z;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
                   "memory");
}

// Word j of the little-endian words v read from byte 4K + sh / 8: a
// whole-word shift by K and, when kShift, a funnel shift by sh bits.
template <int K, bool kShift, int N>
__device__ __forceinline__ uint32_t realign(const uint32_t (&v)[N], int j,
                                            int sh) {
  return kShift ? __funnelshift_r(v[j + K], v[j + K + 1], sh) : v[j + K];
}

// Thread block i of the tile: its 64 input bytes (at byte o = 4K + sh / 8
// of buffer granule 4i, slot 5i) XORed with ks, written span-aligned to
// granules 4i .. 4i + 3 of the output buffer (slots 5i .. 5i + 3).
template <int K, bool kShift>
__device__ __forceinline__ void xor_block(const uint4* ibuf, uint4* obuf,
                                          int i, int sh,
                                          const uint32_t (&ks)[16]) {
  constexpr int kPieces = (K == 0 && !kShift) ? 4 : 5;
  uint32_t v[20];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const uint4 t = ibuf[5 * i + j + (j >> 2)];
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    obuf[5 * i + q] =
        make_uint4(realign<K, kShift>(v, 4 * q, sh) ^ ks[4 * q],
                   realign<K, kShift>(v, 4 * q + 1, sh) ^ ks[4 * q + 1],
                   realign<K, kShift>(v, 4 * q + 2, sh) ^ ks[4 * q + 2],
                   realign<K, kShift>(v, 4 * q + 3, sh) ^ ks[4 * q + 3]);
}

template <int K>
__device__ __forceinline__ void xor_block_k(const uint4* ibuf, uint4* obuf,
                                            int i, int o,
                                            const uint32_t (&ks)[16]) {
  if (o & 3)
    xor_block<K, true>(ibuf, obuf, i, 8 * (o & 3), ks);
  else
    xor_block<K, false>(ibuf, obuf, i, 0, ks);
}

__device__ __forceinline__ void xor_block_at(const uint4* ibuf, uint4* obuf,
                                             int i, int o,
                                             const uint32_t (&ks)[16]) {
  switch (o >> 2) {
    case 0: xor_block_k<0>(ibuf, obuf, i, o, ks); break;
    case 1: xor_block_k<1>(ibuf, obuf, i, o, ks); break;
    case 2: xor_block_k<2>(ibuf, obuf, i, o, ks); break;
    default: xor_block_k<3>(ibuf, obuf, i, o, ks); break;
  }
}

// Store the tile's n output bytes to dst (at offset o_out mod 16) from the
// span-aligned output buffer: output granule q holds tile bytes
// x0 = 16q - o_out .. x0 + 15. Whole granules inside the span are
// assembled from buffer granules x0 >> 4 and the next, at byte
// x0 & 15 = 4K + sh / 8 (the same for every granule of the tile).
template <int K, bool kShift>
__device__ __forceinline__ void store_tile(const uint4* obuf, uint8_t* dst,
                                           int o_out, int n, int sh) {
  uint8_t* const dst0 = dst - o_out;
  const uint8_t* const ob = reinterpret_cast<const uint8_t*>(obuf);
  const int pieces = (o_out + n + 15) >> 4;
  for (int q = threadIdx.x; q < pieces; q += kThreads) {
    const int x0 = 16 * q - o_out;
    if (x0 >= 0 && x0 + 16 <= n) {
      const int a = x0 >> 4;
      const uint4 p = obuf[pad(a)];
      uint4 w = p;
      if constexpr (K != 0 || kShift) {
        const uint4 r = obuf[pad(a + 1)];
        const uint32_t v[8] = {p.x, p.y, p.z, p.w, r.x, r.y, r.z, r.w};
        w = make_uint4(realign<K, kShift>(v, 0, sh),
                       realign<K, kShift>(v, 1, sh),
                       realign<K, kShift>(v, 2, sh),
                       realign<K, kShift>(v, 3, sh));
      }
      *reinterpret_cast<uint4*>(dst0 + 16 * q) = w;
    } else {
      // a head or tail granule: this tile's bytes only
      const int e0 = x0 < 0 ? 0 : x0;
      const int e1 = x0 + 16 < n ? x0 + 16 : n;
      for (int e = e0; e < e1; ++e)
        dst[e] = ob[16 * pad(e >> 4) + (e & 15)];
    }
  }
}

template <int K>
__device__ __forceinline__ void store_tile_k(const uint4* obuf, uint8_t* dst,
                                             int o_out, int n, int x) {
  if (x & 3)
    store_tile<K, true>(obuf, dst, o_out, n, 8 * (x & 3));
  else
    store_tile<K, false>(obuf, dst, o_out, n, 0);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    chacha20_kernel(const uint8_t* in, long long in_stride, uint8_t* out,
                    long long out_stride, int span,
                    const uint32_t* __restrict__ keys,
                    const uint32_t* __restrict__ nonces, long long n_pkg,
                    uint32_t pkg_blocks) {
  extern __shared__ __align__(16) uint4 smem[];
  uint4* const ibuf = smem;
  uint4* const obuf = smem + kBufSlots;
  uint4* const kn = smem + 2 * kBufSlots;      // key, key, nonces...
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int t0 = blockIdx.y * kTile;
  const int n = span - t0 < kTile ? span - t0 : kTile;   // tile bytes
  // in and out may be the same tensor (in place): neither is __restrict__
  const uint8_t* const src = in + row * in_stride + t0;
  uint8_t* const dst = out + row * out_stride + t0;
  const int o_in = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int o_out = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);

  // the granules holding the tile's input bytes, landing during the rounds
  {
    const uint8_t* const src0 = src - o_in;
    const uint32_t ib = static_cast<uint32_t>(__cvta_generic_to_shared(ibuf));
    const int pieces = (o_in + n + 15) >> 4;
    for (int g = tid; g < pieces; g += kThreads)
      cp_async16(ib + 16 * pad(g), src0 + 16 * g);
  }

  // key words and the nonce words of packages p0 .. p1
  const uint32_t b0 = blockIdx.y * static_cast<uint32_t>(kTileBlocks);
  const int nb = (n + 63) >> 6;
  const uint32_t p0 = b0 / pkg_blocks;
  const int np = static_cast<int>((b0 + nb - 1) / pkg_blocks - p0) + 1;
  uint32_t* const knw = reinterpret_cast<uint32_t*>(kn);
  if (tid < 8) knw[tid] = __ldg(keys + row * 8 + tid);
  const uint32_t* const nr = nonces + (row * n_pkg + p0) * 3;
  for (int w = tid; w < 4 * np; w += kThreads)
    if ((w & 3) != 3) knw[8 + w] = __ldg(nr + (w >> 2) * 3 + (w & 3));
  __syncthreads();
  uint32_t k[8];
  {
    const uint4 ka = kn[0], kb = kn[1];
    k[0] = ka.x; k[1] = ka.y; k[2] = ka.z; k[3] = ka.w;
    k[4] = kb.x; k[5] = kb.y; k[6] = kb.z; k[7] = kb.w;
  }

  // a thread past the span (a tile cut by it) computes a block too: its
  // package stays inside the table's room, and nothing of it is stored
  const int i = tid;                            // block of the tile
  const uint32_t blk = b0 + i;                  // block of the row
  const uint32_t pkg = blk / pkg_blocks;
  uint32_t ks[16];
  block(k, kn[2 + (pkg - p0)], 1 + blk - pkg * pkg_blocks, ks);
  cp_async_wait_all();
  __syncthreads();
  if (i < nb) xor_block_at(ibuf, obuf, i, o_in, ks);
  __syncthreads();

  const int x = (16 - o_out) & 15;   // buffer byte of an output granule
  switch (x >> 2) {
    case 0: store_tile_k<0>(obuf, dst, o_out, n, x); break;
    case 1: store_tile_k<1>(obuf, dst, o_out, n, x); break;
    case 2: store_tile_k<2>(obuf, dst, o_out, n, x); break;
    default: store_tile_k<3>(obuf, dst, o_out, n, x); break;
  }
}

}  // namespace

extern "C" {

// in, out: n_rows rows of in_stride / out_stride bytes (device memory;
// out may equal in). XORs the first `span` bytes of each row of `in` with
// its keystream into `out`; keys (n_rows, 8) and nonces (n_rows, n_pkg, 3)
// are u32 words, packages of pkg_bytes (a multiple of 64) cover the span,
// which is at most kMaxTiles tiles of kTile bytes (512 MiB less 8 KiB).
// Launches once on the given stream and returns the CUDA error of the
// launch.
int chacha20_launch(const void* in, long long in_stride, void* out,
                    long long out_stride, long long n_rows, long long span,
                    const void* keys, const void* nonces, long long n_pkg,
                    long long pkg_bytes, void* stream) {
  if (n_rows < 1 || span < 1 || pkg_bytes < 64 || pkg_bytes % 64 ||
      n_pkg < 1 || span > n_pkg * pkg_bytes || span > in_stride ||
      span > out_stride || span > static_cast<long long>(kMaxTiles) * kTile ||
      n_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // a package at least as long as the span is one package
  const long long pb = pkg_bytes / 64;
  const uint32_t pkg_blocks =
      static_cast<uint32_t>(pb < 0x7fffffffLL ? pb : 0x7fffffffLL);
  const unsigned tiles = static_cast<unsigned>((span + kTile - 1) / kTile);
  chacha20_kernel<<<dim3(static_cast<unsigned>(n_rows), tiles), kThreads,
                    kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), in_stride, static_cast<uint8_t*>(out),
      out_stride, static_cast<int>(span), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(nonces), n_pkg, pkg_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
